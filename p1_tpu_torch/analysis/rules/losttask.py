"""lost-task: every spawned task handle must be held by SOMETHING.

``asyncio.create_task`` detaches a coroutine from the spawning control
flow; if the handle is neither stored, awaited, nor given a done
callback, an exception inside it is observed by NOBODY until the
garbage collector happens to log "Task exception was never retrieved"
— or never, if the loop dies first.  A review once found exactly
this shape killing the store-recovery loop: the task died silently and
the node sat degraded forever, because ``_store_fail`` early-returns
once degraded and nothing else respawns the loop.  The fix
(``_spawn_store_recovery`` + ``_store_recovery_done``: log, then
respawn while still degraded) is the house pattern this rule points
grants and fixes at.

Flagged:

- a ``create_task``/``ensure_future`` call whose value is discarded
  (a bare expression statement);
- a handle assigned to a local name that the enclosing function never
  mentions again — morally identical to discarding it, one rename away
  from looking supervised.

Not flagged (the handle IS held): awaited; stored into an attribute,
subscript, or container; passed as an argument; assigned to a name the
function later uses (cancel/await/add_done_callback/bookkeeping).
Whether the holder then OBSERVES a failure is beyond the AST — the
audit that accompanies each grant, and the regression tests in
tests/test_torch_node.py / tests/test_torch_queryplane.py, carry that
half.
"""

from __future__ import annotations

import ast
from typing import Iterator

from p1_tpu_torch.analysis.base import (
    Rule,
    dotted_name,
    enclosing_scope,
    parent_map,
    register,
    scope_name,
)
from p1_tpu_torch.analysis.findings import Finding

_SPAWNERS = ("create_task", "ensure_future")


@register
class LostTaskRule(Rule):
    name = "lost-task"
    title = "spawned task handle neither stored, awaited, nor callback'd"
    scope = ()  # the whole package: a lost task is a bug anywhere

    def check(self, tree: ast.Module, rel: str) -> Iterator[Finding]:
        parents = parent_map(tree)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_name(node.func)
            if dotted is None or dotted.rsplit(".", 1)[-1] not in _SPAWNERS:
                continue
            parent = parents.get(node)
            scope = enclosing_scope(node, parents)
            key = scope_name(scope)
            if isinstance(parent, ast.Expr):
                yield self.finding(
                    rel,
                    node,
                    f"{dotted}(...) handle discarded in {key}() — store "
                    "it, await it, or attach a done callback that logs "
                    "and recovers",
                    key,
                )
            elif (
                isinstance(parent, ast.Assign)
                and len(parent.targets) == 1
                and isinstance(parent.targets[0], ast.Name)
                and not _name_used_elsewhere(
                    scope, parent.targets[0].id, parent.targets[0]
                )
            ):
                yield self.finding(
                    rel,
                    node,
                    f"{dotted}(...) handle bound to "
                    f"{parent.targets[0].id!r} in {key}() but never used "
                    "— the task can die unobserved",
                    key,
                )


def _name_used_elsewhere(scope: ast.AST, name: str, binding: ast.Name) -> bool:
    for node in ast.walk(scope):
        if isinstance(node, ast.Name) and node.id == name and node is not binding:
            return True
    return False
