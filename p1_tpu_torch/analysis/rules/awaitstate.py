"""await-state: read → await → write on consensus state is a race.

Single-threaded asyncio removes data races but not INTERLEAVING races:
every ``await`` is a scheduling point where any other coroutine — a
frame handler accepting a block, the miner sealing one, a chaos crash
callback — may run and move the very state this coroutine read before
the await.  A method that reads a consensus attribute, awaits, and
then writes that attribute commits a decision computed against a
world that may no longer exist: the classic shape is the store-resume
path deciding ``self.chain`` from disk, awaiting IO, then installing
it over a tip that advanced meanwhile.  The chaos plane hunts this
class dynamically (crash/recover sweeps over the simulated mesh);
this rule pins it structurally.

Flagged: inside ONE ``async def``'s own control flow (nested defs
excluded — closures run on a different schedule), a Load of
``self.X``, then an ``await``, then a Store to ``self.X``, for X in
the consensus-state watchlist: ``chain`` (tip/fork-choice), ``ledger``,
``store``, ``mempool``.  The finding anchors at the write — the line
where the stale decision lands.

A grant asserts one of the safe shapes, with the reason written down:
the method re-validates after the await before writing; it runs only
before the node serves (start-up) or after it stops; or it is the
SOLE writer and readers tolerate the swap.
"""

from __future__ import annotations

import ast
from typing import Iterator

from p1_tpu_torch.analysis.base import Rule, register, sort_key, walk_no_nested_defs
from p1_tpu_torch.analysis.findings import Finding

#: Consensus-state attributes (on self) whose cross-await read/write
#: interleavings the chaos sweeps hunt dynamically.
WATCHED = frozenset({"chain", "ledger", "store", "mempool"})


@register
class AwaitStateRule(Rule):
    name = "await-state"
    title = "consensus attribute read, awaited past, then written"
    scope = ("node/",)  # where the consensus loop and its state live

    def check(self, tree: ast.Module, rel: str) -> Iterator[Finding]:
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            loads: dict[str, tuple[int, int]] = {}  # attr -> first load pos
            awaits: list[tuple[int, int]] = []
            flagged: set[str] = set()
            for node in sorted(walk_no_nested_defs(fn), key=sort_key):
                if isinstance(node, ast.Await):
                    awaits.append(sort_key(node))
                elif (
                    isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr in WATCHED
                ):
                    pos = sort_key(node)
                    if isinstance(node.ctx, ast.Load):
                        loads.setdefault(node.attr, pos)
                    elif isinstance(node.ctx, ast.Store):
                        first = loads.get(node.attr)
                        if (
                            node.attr not in flagged
                            and first is not None
                            and any(first < a < pos for a in awaits)
                        ):
                            flagged.add(node.attr)
                            yield self.finding(
                                rel,
                                node,
                                f"self.{node.attr} read before an await "
                                f"and written after it in {fn.name}() — "
                                "the world may have moved at the "
                                "scheduling point; re-validate before "
                                "writing or grant with the safety "
                                "argument",
                                node.attr,
                            )
                        loads.pop(node.attr, None)
