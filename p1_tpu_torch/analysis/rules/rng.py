"""unseeded-rng: randomness in product code must carry a derived seed.

The simulator's reproducibility contract — same seed, byte-identical
trace, cross-process (tests/test_torch_scenarios.py pins it) — holds only
while every random draw in the simulated world descends from the
scenario seed.  One ``random.Random()`` (seeded from OS entropy behind
your back) or one module-level ``random.random()`` (the interpreter's
shared ambient generator, reseeded by anyone) in a node/sim path and
same-seed runs silently diverge; the chaos plane's shrinker then
cannot reproduce the failure it just found.

Flagged:

- ``random.Random()`` with no arguments — if OS entropy is genuinely
  intended (production identity draws), write the intent down:
  ``random.Random(secrets.randbits(64))`` seeds explicitly and passes;
- any call on the ``random`` MODULE itself (``random.random()``,
  ``random.choice(...)``, ...) — ambient global state is never
  derivable from a scenario seed; draw from an injected
  ``random.Random`` instance instead.

``secrets`` is deliberately not matched: it is the explicit "I want OS
entropy" spelling, used for production identity (instance nonces, key
material) where determinism would be a bug — and sim paths already
inject seeded rngs past every one of those call sites.
"""

from __future__ import annotations

import ast
from typing import Iterator

from p1_tpu_torch.analysis.base import Rule, dotted_name, register
from p1_tpu_torch.analysis.findings import Finding

#: The ambient-global draw functions on the random module.
_MODULE_FNS = frozenset(
    {
        "betavariate", "choice", "choices", "expovariate", "gauss",
        "getrandbits", "lognormvariate", "normalvariate", "paretovariate",
        "randbytes", "randint", "random", "randrange", "sample", "seed",
        "shuffle", "triangular", "uniform", "vonmisesvariate",
        "weibullvariate",
    }
)


@register
class UnseededRngRule(Rule):
    name = "unseeded-rng"
    title = "randomness with no derived seed (sim-trace divergence)"
    scope = ()  # the whole package — tooling traces deserve replay too

    def check(self, tree: ast.Module, rel: str) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_name(node.func)
            if dotted == "random.Random" and not node.args and not node.keywords:
                yield self.finding(
                    rel,
                    node,
                    "random.Random() with no seed — derive one from the "
                    "scenario/node seed, or spell OS entropy explicitly "
                    "(random.Random(secrets.randbits(64)))",
                    "random.Random",
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "random"
                and node.func.attr in _MODULE_FNS
            ):
                yield self.finding(
                    rel,
                    node,
                    f"module-level random.{node.func.attr}() draws from "
                    "the interpreter's shared generator — use an "
                    "injected random.Random instance",
                    f"random.{node.func.attr}",
                )
