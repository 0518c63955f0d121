"""escaped-state: await-state with one level of call transparency.

``await-state`` flags read → await → write on consensus attributes
(``self.chain``/``ledger``/``store``/``mempool``) when all three sit
lexically in one ``async def``.  The documented residue: route either
endpoint through a method call — ``tip = self._read_tip()`` before
the await, ``self._install(tip)`` after it — and the race is
invisible, though the interleaving hazard is byte-for-byte the same
(the world still moves at the scheduling point; the helper just holds
the stale value one frame lower).

This rule folds ONE call level in, using the call graph's effect
summaries: for every call a coroutine makes to a resolvable helper
(``self.helper()``, a local function, an imported package function, a
``self.attr.meth()`` with a known attribute type), the helper's own
direct watched-state reads and writes are treated as happening at the
call site.  Then the same read → await → write scan runs over the
folded event sequence.  To stay disjoint from ``await-state`` (and
keep its grant table stable), a finding is emitted ONLY when at least
one endpoint — the pre-await read or the post-await write — came from
a folded helper; races fully visible in the caller's own body remain
await-state findings.

One level is deliberate: each fold is a concrete, auditable claim
("_install writes self.chain") a reviewer can check by opening one
function.  Deeper transitive folding multiplies false positives
without adding a bug class — the chaos sweeps hunt the rest
dynamically.

Grant key: the attribute name, same keying discipline as await-state;
the detail names the helper(s) that carry the escaped endpoints.
"""

from __future__ import annotations

from typing import Iterator

from p1_tpu_torch.analysis.base import Rule, register
from p1_tpu_torch.analysis.findings import Finding

#: (kind, attr, pos, via) events; via = helper name or None (direct).
_READ, _WRITE, _AWAIT = 0, 1, 2


@register
class EscapedStateRule(Rule):
    name = "escaped-state"
    title = "consensus read/write escaping into a helper across an await"
    scope = ("node/",)  # where the consensus loop and its state live
    package_rule = True

    def check_package(self, pkg) -> Iterator[Finding]:
        graph = pkg.graph
        for qual in sorted(graph.nodes):
            node = graph.nodes[qual]
            if not node.is_async or not self.applies_to(node.rel):
                continue
            events: list[tuple[tuple[int, int], int, str, str | None]] = []
            for attr, pos in node.state_reads:
                events.append((pos, _READ, attr, None))
            for attr, pos in node.state_writes:
                events.append((pos, _WRITE, attr, None))
            for pos in node.awaits:
                events.append((pos, _AWAIT, "", None))
            for call in node.calls:
                if call.target is None:
                    continue
                callee = graph.nodes[call.target]
                pos = (call.line, 0)
                for attr, _ in callee.state_reads:
                    events.append((pos, _READ, attr, callee.name))
                for attr, _ in callee.state_writes:
                    events.append((pos, _WRITE, attr, callee.name))
            events.sort(key=lambda e: (e[0], e[1]))
            yield from self._scan(node, events)

    def _scan(self, node, events) -> Iterator[Finding]:
        # first unconsumed read per attr: (pos, via)
        reads: dict[str, tuple[tuple[int, int], str | None]] = {}
        awaits: list[tuple[int, int]] = []
        flagged: set[str] = set()
        for pos, kind, attr, via in events:
            if kind == _AWAIT:
                awaits.append(pos)
            elif kind == _READ:
                reads.setdefault(attr, (pos, via))
            elif kind == _WRITE:
                first = reads.get(attr)
                if (
                    attr not in flagged
                    and first is not None
                    and any(first[0] < a < pos for a in awaits)
                    and (first[1] is not None or via is not None)
                ):
                    flagged.add(attr)
                    read_src = (
                        f"{first[1]}()" if first[1] else "this coroutine"
                    )
                    write_src = f"{via}()" if via else "this coroutine"
                    yield Finding(
                        file=node.rel,
                        line=pos[0],
                        rule=self.name,
                        detail=(
                            f"self.{attr} read via {read_src} before an "
                            f"await and written via {write_src} after it "
                            f"in {node.name}() — the helper carries the "
                            "stale value across the scheduling point; "
                            "re-validate before writing or grant with "
                            "the safety argument"
                        ),
                        key=attr,
                    )
                reads.pop(attr, None)
