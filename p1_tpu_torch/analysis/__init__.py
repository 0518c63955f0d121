"""Determinism & async-safety static analysis (tier-1 enforced).

The port's copy of ``p1_tpu/analysis``, aimed at ``p1_tpu_torch/``: the
same rules, scopes and grant keys, run over the port's own sources.
Pure standard library (``ast``): it never imports the code it reads,
so it loads no torch and touches no card.

The node's history holds protocol/recovery bugs found *dynamically*
— a dead store-recovery loop whose task died silently,
set→dict ordering fixes required for byte-identical sim traces, a
host-clock read inside frame bytes that made simulated flood traces
nondeterministic — and a tokenizer wall-clock lint had already caught
one of those classes at commit time.  This package promotes that from
one grep into a multi-pass AST analyzer in the
sanitizer/race-detector lineage: find the bug CLASS, not the bug
instance, and pin it so refactors can't silently reintroduce it.

Two properties are load-bearing and generalized from the original lint:

- **anything not granted fails** — a new file acquiring a flagged
  construct is a deliberate allowlist edit with a written reason, not a
  silent pass;
- **any grant nothing uses fails** — stale grants rot into blanket
  permissions, so the engine reports them as violations too.

Entry points: ``run_analysis()`` (the whole package, every rule),
``python -m p1_tpu_torch lint`` (CLI wrapper, exit 0 clean / 1 findings
/ 2 usage), and the tier-1 test ``tests/test_torch_analysis.py`` that
keeps the tree clean.
"""

from __future__ import annotations

from p1_tpu_torch.analysis.base import RULES, Rule, register
from p1_tpu_torch.analysis.engine import PKG_ROOT, Report, package_files, run_analysis
from p1_tpu_torch.analysis.findings import Finding

# Importing the rules package populates the registry as a side effect —
# the canonical rule set IS "whatever p1_tpu_torch.analysis.rules defines".
from p1_tpu_torch.analysis import rules as _rules  # noqa: F401  (registry load)

__all__ = [
    "Finding",
    "Report",
    "Rule",
    "RULES",
    "PKG_ROOT",
    "package_files",
    "register",
    "run_analysis",
]
