"""set-iteration: consensus and sim paths must not iterate unordered.

Python sets iterate in hash-table order, which varies with insertion
history and (for str keys under hash randomization) across processes.
The node once fixed this class BY HAND twice to get byte-identical sim
traces: peer/address bookkeeping moved from ``set`` to insertion-
ordered ``dict[key, None]`` so relay fan-out and dial order stopped
depending on hash order.  Any *new* ``for x in some_set_expression``
in a covered path reintroduces trace divergence — and in consensus
code, ordering-dependent tie-breaks.

Flagged — direct iteration (for / async for / comprehension clauses)
over an expression that is structurally a set:

- a set literal or a ``set(...)``/``frozenset(...)`` call;
- a binary set operation (``-``/``|``/``&``/``^``) with such an
  operand, or with a ``.keys()`` view operand (the "dict-keys
  difference" shape: ``d.keys() - seen``);
- a ``.difference/.union/.intersection/.symmetric_difference`` call;
- ONE dataflow hop: a bare local name every binding
  of which in the enclosing function is structurally a set
  (``pending = set(); ... for p in pending``) — the "through a
  variable" residue of a purely lexical rule, closed with the call
  graph's local-binding summary (analysis/callgraph.py
  ``local_set_bindings``).  A single non-set rebinding (``pending =
  sorted(pending)``) takes the name out of the set class, so the
  normalize-then-iterate idiom stays clean.

Not flagged: ``sorted(set(...))`` (the sort normalizes the order —
and structurally the loop iterates the ``sorted`` call, not the set);
membership tests; iteration over a plain ``dict``/``.keys()`` view
(insertion-ordered by language guarantee); sets reaching the loop
through parameters, attributes, or across function boundaries (type
inference beyond one local hop stays out of scope — the fixture
corpus and review carry that residue).
"""

from __future__ import annotations

import ast
from typing import Iterator

from p1_tpu_torch.analysis.base import (
    Rule,
    is_set_expr,
    register,
    walk_no_nested_defs,
)
from p1_tpu_torch.analysis.callgraph import local_set_bindings
from p1_tpu_torch.analysis.findings import Finding


@register
class SetIterationRule(Rule):
    name = "set-iteration"
    title = "iteration over an unordered set expression"
    #: The deterministic-trace product tree, same coverage as wall-clock.
    scope = ("node/", "chain/", "mempool/")

    def check(self, tree: ast.Module, rel: str) -> Iterator[Finding]:
        # module scope + every function scope, each with its own
        # local-binding summary (names are function-local facts).
        scopes: list[ast.AST] = [tree]
        scopes.extend(
            n
            for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        )
        for scope in scopes:
            set_locals = local_set_bindings(scope)
            for node in walk_no_nested_defs(scope):
                iters: list[ast.AST] = []
                if isinstance(node, (ast.For, ast.AsyncFor)):
                    iters.append(node.iter)
                elif isinstance(
                    node,
                    (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp),
                ):
                    iters.extend(gen.iter for gen in node.generators)
                for it in iters:
                    if is_set_expr(it):
                        yield self.finding(
                            rel,
                            it,
                            "iterating an unordered set expression — sort "
                            "it, or keep insertion order with "
                            "dict[key, None] (the "
                            "trace-determinism fix)",
                            "set-expr",
                        )
                    elif (
                        isinstance(it, ast.Name) and it.id in set_locals
                    ):
                        yield self.finding(
                            rel,
                            it,
                            f"iterating {it.id!r}, a local bound only to "
                            "set expressions in this scope — sort it "
                            "(or normalize with sorted() before the "
                            "loop); unordered iteration is the "
                            "trace-divergence class one variable away",
                            "set-local",
                        )
