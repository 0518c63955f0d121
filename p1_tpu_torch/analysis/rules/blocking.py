"""blocking-in-async: no synchronous stalls on the consensus loop.

Everything consensus-critical runs on ONE asyncio thread (the staged
pipeline, node/pipeline.py, moves the heavy stages off it).  A ``time.sleep``, a synchronous
``open``/read, an ``os.fsync``, or a ``subprocess`` call inside an
``async def`` stalls frame reads, ping deadlines, the governor tick,
and mining for its full duration — the sim can't see it (the virtual
clock doesn't advance during host-side blocking), so soaks meet it
only as unexplained tail latency.

This rule is also deliberately a MAP: the grants it forces are the
audited inventory of host-blocking work still running on the loop —
exactly the work list the stage split (wire framing →
admission → validation → store → relay, with worker processes for the
CPU/IO-heavy stages) has to move off-thread.  A grant here is a known
debt with a written reason, not a blessing.

Flagged — direct calls lexically inside an ``async def`` body (a
nested ``def``/``lambda`` resets the context: its body runs whenever
it is CALLED, which ``asyncio.to_thread``/executors do off-loop):

- ``time.sleep`` (the loop-stalling sleep; ``asyncio.sleep`` is the
  loop-relative spelling and belongs to the wall-clock rule's domain);
- builtin ``open`` (sync file IO on the loop);
- ``os.fsync`` / ``os.fdatasync`` / ``os.sync`` (durability barriers —
  milliseconds to SECONDS on a busy disk);
- anything on the ``subprocess`` module (blocking process plumbing;
  ``asyncio.create_subprocess_*`` is the async spelling).

Indirect blocking (a sync helper that fsyncs inside, called from async
code) is beyond one-pass AST: the rule pins the direct class, the
grants document the known indirect sites.
"""

from __future__ import annotations

import ast
from typing import Iterator

from p1_tpu_torch.analysis.base import Rule, dotted_name, register
from p1_tpu_torch.analysis.findings import Finding

_BLOCKING_DOTTED = frozenset({"time.sleep", "os.fsync", "os.fdatasync", "os.sync"})


@register
class BlockingInAsyncRule(Rule):
    name = "blocking-in-async"
    title = "synchronous blocking call inside async def"
    scope = ()  # every async def in the package runs on SOME loop

    def check(self, tree: ast.Module, rel: str) -> Iterator[Finding]:
        yield from self._visit(tree, rel, in_async=False, fn="<module>")

    def _visit(
        self, node: ast.AST, rel: str, in_async: bool, fn: str
    ) -> Iterator[Finding]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.AsyncFunctionDef):
                yield from self._visit(child, rel, True, child.name)
                continue
            if isinstance(child, (ast.FunctionDef, ast.Lambda)):
                yield from self._visit(
                    child, rel, False, getattr(child, "name", "<lambda>")
                )
                continue
            if in_async and isinstance(child, ast.Call):
                hit = self._classify(child)
                if hit is not None:
                    yield self.finding(
                        rel,
                        child,
                        f"{hit} blocks the event loop inside async "
                        f"{fn}() — move it to a worker "
                        "(asyncio.to_thread / executor) or grant it as "
                        "acknowledged offload debt",
                        hit,
                    )
            yield from self._visit(child, rel, in_async, fn)

    @staticmethod
    def _classify(call: ast.Call) -> str | None:
        dotted = dotted_name(call.func)
        if dotted is None:
            return None
        if dotted == "open":
            return "open"
        if dotted in _BLOCKING_DOTTED:
            return dotted
        if dotted.startswith("subprocess."):
            return "subprocess"
        return None
