"""wall-clock: no host-clock reads or sleeps off the transport seam.

The transport seam (node/transport.py) exists so every clock read in
the node goes through an injectable ``Clock`` and every sleep/deadline
through the event loop — which is what lets node/netsim.py virtualize a
thousand nodes deterministically.  One ``time.time()`` in a consensus
or session path silently re-couples the node to the host clock: the
sim still RUNS, but deadlines stop scaling with virtual time and
same-seed traces drift.  The worst version seen — a codec-side
``time.time()`` default INSIDE frame bytes made simulated flood traces
nondeterministic — was caught by the tokenizer lint this rule replaces.

``asyncio.sleep`` / ``asyncio.wait_for`` are loop-relative — the
simulator virtualizes the loop itself, so they are sim-compatible BY
CONSTRUCTION and allowed wherever async code runs under the node's
loop.  They are still matched and granted per file: a *new* module
acquiring sleeps is worth a deliberate allowlist edit (is this file
really always run under the virtual loop?), not a silent pass.

Structural, not textual: only ``ast.Call`` nodes count, so an
injectable-clock DEFAULT argument (``clock=time.monotonic``) or a
callable passed through (``clock=self.clock.monotonic``) is clean
without a grant — the old scanner got this by re-joining tokens and
substring-matching, which also mis-hit names merely *ending* in a
pattern.  Grant keys are the dotted callable without parentheses.
"""

from __future__ import annotations

import ast
from typing import Iterator

from p1_tpu_torch.analysis.base import Rule, call_matches, dotted_name, register
from p1_tpu_torch.analysis.findings import Finding

#: Dotted callables that read the HOST clock (or sleep).
#: ``datetime.now`` matches both ``datetime.now(...)`` and
#: ``datetime.datetime.now(...)`` via dot-boundary suffix matching.
PATTERNS = (
    "time.time",
    "time.monotonic",
    "time.perf_counter",
    "datetime.now",
    "asyncio.sleep",
)


@register
class WallClockRule(Rule):
    name = "wall-clock"
    title = "host clock reads/sleeps outside the transport seam"
    #: The simulator-covered product tree — same coverage the tokenizer
    #: lint enforced (mempool/ included: pool stamps and TTL
    #: ages ride the node's injected clock so chaos schedules see
    #: deterministic checkpoint ages).
    scope = ("node/", "chain/", "mempool/")

    def check(self, tree: ast.Module, rel: str) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_name(node.func)
            for pat in PATTERNS:
                if call_matches(dotted, pat):
                    yield self.finding(
                        rel,
                        node,
                        f"{dotted}() reads the host clock off the seam — "
                        "route it through the injected Clock (or grant "
                        "with a reason)",
                        pat,
                    )
                    break
