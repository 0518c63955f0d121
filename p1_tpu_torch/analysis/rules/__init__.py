"""The rule set.  Importing this package registers every rule; the
canonical list is what lives here — docs/LINT.md (the JAX package's
catalog of the same rules) gives each rule's definition, the
historical bug that motivates it, and how to grant an exception."""

from p1_tpu_torch.analysis.rules import (  # noqa: F401  (registration side effect)
    awaitstate,
    blocking,
    escstate,
    losttask,
    rng,
    setiter,
    transblock,
    wallclock,
    wirecontract,
)
