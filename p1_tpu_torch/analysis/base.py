"""Rule protocol, registry, and the shared AST helpers every rule uses.

A rule is one *bug class* with one structural definition: it walks a
parsed module and yields ``Finding`` objects.  Rules declare a
``scope`` — path prefixes (relative to the package root) they apply to
— because the invariants are domain invariants, not universal style:
wall-clock reads are fine in ``hashx/`` benchmark code and fatal in
``node/`` consensus code.  The scope is part of the rule's definition
and documented per rule in docs/LINT.md (the JAX package's catalog;
the port's rules are the same).
"""

from __future__ import annotations

import ast
from typing import Iterator

from p1_tpu_torch.analysis.findings import Finding

#: name -> rule instance.  Populated by @register at import time
#: (p1_tpu_torch/analysis/rules/__init__.py imports every rule module).
RULES: dict[str, "Rule"] = {}


def register(cls: type["Rule"]) -> type["Rule"]:
    rule = cls()
    if rule.name in RULES:  # duplicate registration = a packaging bug
        raise ValueError(f"duplicate rule name {rule.name!r}")
    RULES[rule.name] = rule
    return cls


class Rule:
    """One structural invariant.  Subclasses set the class attributes
    and implement ``check``; the engine handles scoping, allowlists,
    and stale-grant accounting uniformly.

    Two kinds of rule share this protocol: a *per-file*
    rule implements ``check`` and sees one parsed module at a time; a
    *package* rule sets ``package_rule = True``, implements
    ``check_package``, and sees the whole-package index (every tree
    plus the call graph) ONCE per run — the interprocedural rules
    (transitive-blocking, escaped-state, wire-contract) live there.
    Findings from both settle against the allowlist identically."""

    #: Registry/allowlist/CLI name, kebab-case ("wall-clock").
    name: str = ""
    #: One-line summary for `lint --json` and docs.
    title: str = ""
    #: Path prefixes (POSIX, relative to p1_tpu_torch/) the rule covers.
    #: Empty tuple = the whole package.
    scope: tuple[str, ...] = ()
    #: True = the rule runs once over the PackageIndex, not per file.
    package_rule: bool = False

    def applies_to(self, rel: str) -> bool:
        return not self.scope or rel.startswith(self.scope)

    def check(self, tree: ast.Module, rel: str) -> Iterator[Finding]:
        raise NotImplementedError

    def check_package(self, pkg) -> Iterator[Finding]:
        """Package rules override this; ``pkg`` is the engine's
        PackageIndex (``.trees``, ``.graph``)."""
        raise NotImplementedError

    def finding(self, rel: str, node: ast.AST, detail: str, key: str) -> Finding:
        return Finding(
            file=rel,
            line=getattr(node, "lineno", 0),
            rule=self.name,
            detail=detail,
            key=key,
        )


# -- AST helpers ---------------------------------------------------------


def dotted_name(node: ast.AST) -> str | None:
    """The dotted spelling of a call target, or None when any link is
    not a plain name/attribute chain.  A call in the chain contributes
    ``()``: ``asyncio.get_running_loop().create_task`` — so suffix
    matching still sees the module and the method."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return None if base is None else f"{base}.{node.attr}"
    if isinstance(node, ast.Call):
        base = dotted_name(node.func)
        return None if base is None else f"{base}()"
    return None


def call_matches(dotted: str | None, pattern: str) -> bool:
    """True when ``dotted`` IS ``pattern`` or ends with ``.pattern`` on
    a dot boundary — so ``datetime.datetime.now`` matches the pattern
    ``datetime.now`` while ``self.clock.time`` does not match
    ``time.time`` (the token-join scanner this replaces got that right
    only by accident of spelling)."""
    return dotted is not None and (
        dotted == pattern or dotted.endswith("." + pattern)
    )


def parent_map(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    return {
        child: parent
        for parent in ast.walk(tree)
        for child in ast.iter_child_nodes(parent)
    }


def enclosing_scope(
    node: ast.AST, parents: dict[ast.AST, ast.AST]
) -> ast.AST:
    """Nearest enclosing function (or the module): the region in which
    a local name binding is visible."""
    cur: ast.AST | None = parents.get(node)
    while cur is not None:
        if isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.Module)
        ):
            return cur
        cur = parents.get(cur)
    return node


def scope_name(node: ast.AST) -> str:
    return getattr(node, "name", "<module>")


def walk_no_nested_defs(node: ast.AST) -> Iterator[ast.AST]:
    """Yield descendants of ``node`` WITHOUT descending into nested
    function/class bodies: the statements that execute as part of this
    function's own control flow.  (A task spawned here but awaited in a
    nested closure runs on a different schedule entirely — rules about
    sequential read/await/write hazards must not conflate the two.)"""
    for child in ast.iter_child_nodes(node):
        yield child
        if isinstance(
            child,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef),
        ):
            continue
        yield from walk_no_nested_defs(child)


def sort_key(node: ast.AST) -> tuple[int, int]:
    return (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))


_SET_METHODS = frozenset(
    {"difference", "union", "intersection", "symmetric_difference"}
)
_SET_OPS = (ast.Sub, ast.BitOr, ast.BitAnd, ast.BitXor)


def is_set_expr(node: ast.AST) -> bool:
    """True when ``node`` is structurally a set: a literal/comprehension,
    a ``set()``/``frozenset()`` call, a set-method call, or a set
    operator over such operands (or ``.keys()`` views — the "dict-keys
    difference" shape).  Shared by the set-iteration rule and the call
    graph's local-binding summaries so the direct and one-hop layers
    agree on what a set is."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        dotted = dotted_name(node.func)
        if dotted in ("set", "frozenset"):
            return True
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _SET_METHODS
        ):
            return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, _SET_OPS):
        return (
            is_set_expr(node.left)
            or is_set_expr(node.right)
            or is_keys_view(node.left)
            or is_keys_view(node.right)
        )
    return False


def is_keys_view(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "keys"
        and not node.args
    )
