"""transitive-blocking: the loop is stalled through helpers too.

``blocking-in-async`` pins the DIRECT class: a ``time.sleep`` written
lexically inside an ``async def``.  But the incidents that motivated
it were never that polite — the fsync lives three sync helpers down
(``self.store.append`` → ``_write_record`` → ``os.fsync``), the
native crypto call hides behind ``keys.verify_batch``, and the
``async def`` at the top looks spotless.  The lexical rule cannot
close this residue, and the multi-core stage split (node/pipeline.py)
rests on an audited inventory of what actually blocks the consensus
loop.

This rule rides the whole-package call graph (analysis/callgraph.py):
blocking-ness — direct primitives: ``time.sleep``, builtin ``open``,
``os.fsync``/``fdatasync``/``sync``, ``subprocess.*``, ctypes natives
— propagates up resolved call edges to a fixed point, and every
``async def`` whose own control flow reaches a primitive through ONE
OR MORE *sync* helpers is flagged with the full witness chain in the
detail (``_handle_block → _store_append → ChainStore.append →
os.fsync``).  Direct calls (zero hops) stay blocking-in-async's
findings; chains that pass through another ``async def`` are not
re-flagged here — the finding lands at the DEEPEST async frame, which
is where the offload fix goes.

The grant table for this rule IS the stage split's work list: each
grant names one blocking chain still running on the loop, with the
stage (validate/store/...) it must move to written in the reason.
A callable merely passed to ``asyncio.to_thread``/an executor is not
an edge — the house off-load pattern stays clean without a grant.

Grant key: ``"{async fn}->{primitive}"`` — stable across line churn
and across refactors of the middle of the chain, but a new primitive
reached from the same coroutine is a NEW finding.
"""

from __future__ import annotations

from typing import Iterator

from p1_tpu_torch.analysis.base import Rule, register
from p1_tpu_torch.analysis.findings import Finding


@register
class TransitiveBlockingRule(Rule):
    name = "transitive-blocking"
    title = "async def reaches a blocking call through sync helpers"
    scope = ()  # every async def in the package runs on SOME loop
    package_rule = True

    def check_package(self, pkg) -> Iterator[Finding]:
        graph = pkg.graph
        witness = graph.blocking_paths()
        for qual in sorted(graph.nodes):
            node = graph.nodes[qual]
            if not node.is_async:
                continue
            seen_prims: set[str] = set()
            for call in node.calls:
                w = witness.get(call.target) if call.target else None
                if w is None:
                    continue
                callee = graph.nodes[call.target]
                if callee.is_async:
                    continue  # flagged at the deepest async frame
                chain = [node.name] + graph.witness_chain(
                    call.target, witness
                )
                prim = chain[-1]
                if prim in seen_prims:
                    continue  # one finding per (coroutine, primitive)
                seen_prims.add(prim)
                yield Finding(
                    file=node.rel,
                    line=call.line,
                    rule=self.name,
                    detail=(
                        f"async {node.name}() blocks the loop through "
                        + " -> ".join(chain)
                        + " — move the chain to a worker "
                        "(asyncio.to_thread / executor) or grant it as "
                        "acknowledged offload debt"
                    ),
                    key=f"{node.name}->{prim}",
                )
