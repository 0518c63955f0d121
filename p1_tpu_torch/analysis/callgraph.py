"""Whole-package call graph with per-node effect summaries.

The per-file rules are lexical: each looks at one function body in one
file.  That leaves two residues (docs/LINT.md): a blocking
call ONE helper deep escapes ``blocking-in-async`` entirely, and
``await-state`` cannot see a consensus-state read or write routed
through a method call.  Both matter because the node's staged pipeline
(node/pipeline.py) names those rules as its guardrails — it moves code
off the loop, and the analyzer must see through calls to know what is
actually running on it.

This module builds the interprocedural layer from the engine's
existing one-parse-per-file trees — no new parses, no imports of the
analyzed code (a lint must not execute its subject):

- **Nodes** are module-level functions and class methods, identified
  as ``"rel::Qual.name"`` (``"node/node.py::Node._dispatch"``).
- **Edges** come from structural call resolution: bare names bind to
  module functions or ``from``-imports; dotted names through imported
  ``p1_tpu_torch`` modules (``PKG_NAME``); ``self.helper()`` /
  ``cls.helper()`` to methods of the enclosing class
  (single-inheritance bases resolvable in the package are searched
  too); ``ClassName(...)`` to ``__init__``; and
  ``self.attr.meth()`` when the class assigns ``self.attr =
  SomeClass(...)`` unambiguously (the one-level attribute-type
  binding that lets the graph follow ``self.store.append``).
  Anything else — higher-order values, externals, attribute chains
  with no binding — stays an unresolved dotted name: the graph is
  deliberately an UNDER-approximation, precise where it claims edges.
  A callable merely *passed* (``asyncio.to_thread(self._sync_io)``)
  is NOT an edge: that is exactly the house pattern for moving work
  off-loop, and charging it to the caller would flag the fix.
- **Effect summaries** per node: direct blocking-primitive calls
  (``time.sleep``, builtin ``open``, ``os.fsync``/``fdatasync``/
  ``sync``, ``subprocess.*``, and ctypes natives — ``ctypes.CDLL``
  loads plus calls through a module-level CDLL handle), watched
  consensus-state reads/writes (``self.chain``/``ledger``/``store``/
  ``mempool``), await positions, and local set-typed name bindings
  (the ``set-iteration`` rule's one-dataflow-hop upgrade).

``blocking_paths()`` is the fixed point the ``transitive-blocking``
rule rides: blocking-ness propagates up call edges until stable, and
every blocking node remembers one concrete witness chain down to the
primitive so a finding can print the full call path.

Nested ``def``/``lambda`` bodies are excluded from a node's own
effects and calls (they run whenever something CALLS them — usually
off-loop via executors), matching the lexical rules' semantics.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterator

from p1_tpu_torch.analysis.base import (
    dotted_name,
    is_set_expr,
    sort_key,
    walk_no_nested_defs,
)

#: Consensus-state attributes on ``self`` whose cross-await
#: interleavings the await-state/escaped-state rules pin (the same
#: watchlist as rules/awaitstate.py — imported from here so the two
#: layers cannot drift).
WATCHED_STATE = frozenset({"chain", "ledger", "store", "mempool"})

#: The analyzed package's import name: absolute imports under it
#: resolve to package files, every other import is external.
PKG_NAME = "p1_tpu_torch"

#: Dotted spellings that block the host thread outright.
BLOCKING_DOTTED = frozenset(
    {"time.sleep", "os.fsync", "os.fdatasync", "os.sync"}
)


@dataclass(frozen=True)
class CallSite:
    """One call made by a function's own control flow."""

    dotted: str  #: structural spelling ("self.helper", "store.append")
    target: str | None  #: resolved node qual, or None (unresolved)
    line: int


@dataclass
class FuncNode:
    """One function or method: the call-graph node plus its summary."""

    qual: str  #: "rel::name" or "rel::Class.name"
    rel: str
    name: str  #: qualname within the module ("Node._dispatch")
    line: int
    is_async: bool
    tree: ast.AST  #: the (Async)FunctionDef
    calls: list[CallSite] = field(default_factory=list)
    #: direct blocking primitives: (primitive label, line)
    blocking: list[tuple[str, int]] = field(default_factory=list)
    #: watched self.X reads/writes in own control flow: (attr, pos)
    state_reads: list[tuple[str, tuple[int, int]]] = field(
        default_factory=list
    )
    state_writes: list[tuple[str, tuple[int, int]]] = field(
        default_factory=list
    )
    awaits: list[tuple[int, int]] = field(default_factory=list)
    #: local names every binding of which is structurally a set
    set_locals: frozenset[str] = frozenset()


@dataclass(frozen=True)
class BlockingWitness:
    """Why a node is (transitively) blocking: either a direct
    primitive, or one resolved callee that is."""

    primitive: str  #: the blocking primitive at the chain's end
    line: int  #: line IN THIS NODE (the call that starts the chain)
    via: str | None  #: callee qual for indirect, None for direct


class CallGraph:
    """The package-wide graph.  Build once per analysis run from the
    engine's parsed trees; every interprocedural rule reads it."""

    def __init__(self, trees: dict[str, ast.Module]):
        self.nodes: dict[str, FuncNode] = {}
        #: rel -> local qualname -> node qual (module's own defs)
        self._locals: dict[str, dict[str, str]] = {}
        #: rel -> imported name -> ("module", rel') | ("obj", rel', attr)
        self._imports: dict[str, dict[str, tuple]] = {}
        #: rel -> class name -> {method name -> qual}
        self._classes: dict[str, dict[str, dict[str, str]]] = {}
        #: rel -> class name -> base spellings (Name/Attribute dotted)
        self._bases: dict[str, dict[str, list[str]]] = {}
        #: rel -> class name -> self-attr name -> (rel', class') type
        self._attr_types: dict[str, dict[str, dict[str, tuple[str, str]]]] = {}
        #: rel -> module-level names bound to ctypes.CDLL(...) handles
        self._cdll_handles: dict[str, set[str]] = {}
        #: dotted module path ("node.supervision") -> rel, for resolving
        #: absolute PKG_NAME imports without touching the filesystem.
        self._modpaths: dict[str, str] = {}
        for rel in trees:
            mod = rel[:-3].replace("/", ".")
            if mod.endswith(".__init__"):
                mod = mod[: -len(".__init__")]
            self._modpaths[mod] = rel
        for rel, tree in sorted(trees.items()):
            self._index_module(rel, tree)
        for rel, tree in sorted(trees.items()):
            self._collect_effects(rel, tree)
        self.edges = sum(
            1 for n in self.nodes.values() for c in n.calls if c.target
        )

    # -- module indexing -------------------------------------------------

    def _index_module(self, rel: str, tree: ast.Module) -> None:
        local: dict[str, str] = {}
        classes: dict[str, dict[str, str]] = {}
        bases: dict[str, list[str]] = {}
        imports: dict[str, tuple] = {}
        cdll: set[str] = set()
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{rel}::{stmt.name}"
                local[stmt.name] = qual
                self._add_node(qual, rel, stmt.name, stmt)
            elif isinstance(stmt, ast.ClassDef):
                methods: dict[str, str] = {}
                for sub in stmt.body:
                    if isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        name = f"{stmt.name}.{sub.name}"
                        qual = f"{rel}::{name}"
                        methods[sub.name] = qual
                        self._add_node(qual, rel, name, sub)
                classes[stmt.name] = methods
                bases[stmt.name] = [
                    d for d in map(dotted_name, stmt.bases) if d
                ]
            elif isinstance(stmt, ast.Import):
                for alias in stmt.names:
                    target = self._resolve_module(stmt, alias.name, rel)
                    if target is None:
                        continue
                    bound = alias.asname or alias.name.split(".")[0]
                    if alias.asname:
                        imports[bound] = ("module", target)
                    else:
                        # ``import p1_tpu_torch.node.x`` binds
                        # "p1_tpu_torch"; calls
                        # spell the full dotted path — record it whole.
                        imports[alias.name] = ("module", target)
            elif isinstance(stmt, ast.ImportFrom):
                base = self._from_base(stmt, rel)
                if base is None:
                    continue
                for alias in stmt.names:
                    bound = alias.asname or alias.name
                    sub = f"{base}.{alias.name}" if base else alias.name
                    if sub in self._modpaths:
                        imports[bound] = ("module", self._modpaths[sub])
                    elif base in self._modpaths:
                        imports[bound] = (
                            "obj",
                            self._modpaths[base],
                            alias.name,
                        )
            elif isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name) and _contains_cdll(
                        stmt.value
                    ):
                        cdll.add(tgt.id)
        self._locals[rel] = local
        self._classes[rel] = classes
        self._bases[rel] = bases
        self._imports[rel] = imports
        self._cdll_handles[rel] = cdll
        self._attr_types[rel] = {
            cname: self._infer_attr_types(rel, tree, cname)
            for cname in classes
        }

    def _add_node(self, qual: str, rel: str, name: str, fn: ast.AST) -> None:
        self.nodes[qual] = FuncNode(
            qual=qual,
            rel=rel,
            name=name,
            line=fn.lineno,
            is_async=isinstance(fn, ast.AsyncFunctionDef),
            tree=fn,
        )

    def _resolve_module(self, stmt, modname: str, rel: str) -> str | None:
        if modname.startswith(PKG_NAME + ".") or modname == PKG_NAME:
            inner = modname[len(PKG_NAME) + 1 :] if "." in modname else ""
            return self._modpaths.get(inner)
        return None

    def _from_base(self, stmt: ast.ImportFrom, rel: str) -> str | None:
        """The dotted package-relative base of a ``from X import Y``,
        or None when it points outside the package."""
        if stmt.level == 0:
            mod = stmt.module or ""
            if mod == PKG_NAME:
                return ""
            if mod.startswith(PKG_NAME + "."):
                return mod[len(PKG_NAME) + 1 :]
            return None
        # relative: level 1 = this module's package, each extra level up
        parts = rel.split("/")[:-1]  # containing package dirs
        up = stmt.level - 1
        if up > len(parts):
            return None
        parts = parts[: len(parts) - up]
        base = ".".join(parts)
        if stmt.module:
            base = f"{base}.{stmt.module}" if base else stmt.module
        return base

    def _infer_attr_types(
        self, rel: str, tree: ast.Module, cname: str
    ) -> dict[str, tuple[str, str]]:
        """``self.X = SomeClass(...)`` anywhere in the class body gives
        X the type SomeClass — kept only when every assignment that
        NAMES a package class agrees (two different classes drop the
        binding).  Assignments with no class information — a parameter
        passthrough (``self.store = store``), ``None``, an expression
        the classifier can't read — are neutral: the injectable-
        dependency idiom (``self.store = store`` in one branch,
        ``ChainStore(...)`` default in the other) keeps the default's
        type, which is the structural truth tests substitute AROUND,
        not away from.  ``a or SomeClass(...)`` / conditional
        expressions count their class operands."""
        cls_node = next(
            (
                s
                for s in tree.body
                if isinstance(s, ast.ClassDef) and s.name == cname
            ),
            None,
        )
        if cls_node is None:
            return {}
        out: dict[str, tuple[str, str] | None] = {}
        for node in ast.walk(cls_node):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if not (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    continue
                typ = self._value_class(rel, node.value)
                if typ is None:
                    continue  # neutral: no class information
                prev = out.get(tgt.attr, typ)
                out[tgt.attr] = self._unify_classes(typ, prev)
        return {k: v for k, v in out.items() if v is not None}

    def _ancestors(self, key: tuple[str, str]) -> list[tuple[str, str]]:
        """``key`` plus every package-resolvable base, MRO order."""
        seen: list[tuple[str, str]] = []
        stack = [key]
        while stack:
            cur = stack.pop(0)
            if cur in seen:
                continue
            seen.append(cur)
            crel, cname = cur
            for base in self._bases.get(crel, {}).get(cname, ()):
                bhit = self._class_by_dotted(crel, base)
                if bhit is not None:
                    stack.append(bhit)
        return seen

    def _unify_classes(
        self,
        a: tuple[str, str] | None,
        b: tuple[str, str] | None,
    ) -> tuple[str, str] | None:
        """The nearest common ANCESTOR of two bindings, or None when
        they are unrelated.  Subclass/base pairs unify to the base —
        the segmented-store shape: ``self.store`` is a ``SegmentedStore`` in
        one branch and a ``ChainStore`` in the other, and every chain
        the graph can prove goes through the shared base surface."""
        if a is None or b is None:
            return None
        if a == b:
            return a
        b_anc = self._ancestors(b)
        for cand in self._ancestors(a):
            if cand in b_anc:
                return cand
        return None

    def _value_class(self, rel: str, value: ast.AST) -> tuple[str, str] | None:
        """(rel, class) when ``value`` is structurally a constructor
        call of a package class (possibly behind ``or`` / a
        conditional expression)."""
        if isinstance(value, (ast.BoolOp, ast.IfExp)):
            operands = (
                value.values
                if isinstance(value, ast.BoolOp)
                else [value.body, value.orelse]
            )
            hits = {
                h
                for h in (self._value_class(rel, v) for v in operands)
                if h is not None
            }
            if not hits:
                return None
            merged = hits.pop()
            for h in hits:
                merged = self._unify_classes(merged, h)
                if merged is None:
                    return None
            return merged
        if not isinstance(value, ast.Call):
            return None
        dotted = dotted_name(value.func)
        if dotted is None:
            return None
        return self._class_by_dotted(rel, dotted)

    def _class_by_dotted(self, rel: str, dotted: str) -> tuple[str, str] | None:
        parts = dotted.split(".")
        if len(parts) == 1:
            # follow re-export chains (package __init__.py fronts most
            # of the class surface: ``from p1_tpu_torch.chain import
            # Chain``)
            name, seen = parts[0], set()
            while (rel, name) not in seen:
                seen.add((rel, name))
                if name in self._classes.get(rel, {}):
                    return (rel, name)
                imp = self._imports.get(rel, {}).get(name)
                if imp and imp[0] == "obj":
                    rel, name = imp[1], imp[2]
                    continue
                return None
            return None
        # mod.Class (module alias, or a full PKG_NAME.x.y.Class path)
        for split in range(len(parts) - 1, 0, -1):
            head, tail = ".".join(parts[:split]), parts[split:]
            imp = self._imports.get(rel, {}).get(head)
            if imp and imp[0] == "module" and len(tail) == 1:
                if tail[0] in self._classes.get(imp[1], {}):
                    return (imp[1], tail[0])
        return None

    # -- effect collection ----------------------------------------------

    def _collect_effects(self, rel: str, tree: ast.Module) -> None:
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._summarize(rel, None, stmt)
            elif isinstance(stmt, ast.ClassDef):
                for sub in stmt.body:
                    if isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        self._summarize(rel, stmt.name, sub)

    def _summarize(self, rel: str, cls: str | None, fn: ast.AST) -> None:
        name = f"{cls}.{fn.name}" if cls else fn.name
        node = self.nodes[f"{rel}::{name}"]
        for sub in sorted(walk_no_nested_defs(fn), key=sort_key):
            if isinstance(sub, ast.Await):
                node.awaits.append(sort_key(sub))
            elif isinstance(sub, ast.Call):
                dotted = dotted_name(sub.func)
                if dotted is None:
                    continue
                prim = self._blocking_primitive(rel, dotted)
                if prim is not None:
                    node.blocking.append((prim, sub.lineno))
                target = self._resolve_call(rel, cls, dotted)
                node.calls.append(
                    CallSite(dotted=dotted, target=target, line=sub.lineno)
                )
            elif (
                isinstance(sub, ast.Attribute)
                and isinstance(sub.value, ast.Name)
                and sub.value.id == "self"
                and sub.attr in WATCHED_STATE
            ):
                if isinstance(sub.ctx, ast.Load):
                    node.state_reads.append((sub.attr, sort_key(sub)))
                elif isinstance(sub.ctx, ast.Store):
                    node.state_writes.append((sub.attr, sort_key(sub)))
        node.set_locals = local_set_bindings(fn)

    def _blocking_primitive(self, rel: str, dotted: str) -> str | None:
        if dotted == "open":
            return "open"
        if dotted in BLOCKING_DOTTED:
            return dotted
        if dotted.startswith("subprocess."):
            return dotted
        if dotted == "ctypes.CDLL" or dotted.startswith("ctypes.CDLL."):
            return "ctypes.CDLL"
        head = dotted.split(".", 1)[0]
        if "." in dotted and head in self._cdll_handles.get(rel, ()):
            return f"ctypes:{dotted}"
        return None

    def _resolve_call(
        self, rel: str, cls: str | None, dotted: str
    ) -> str | None:
        parts = dotted.split(".")
        # strip a call link ("factory().run") — not resolvable here
        if any("()" in p for p in parts):
            return None
        if len(parts) == 1:
            name = parts[0]
            hit = self._locals.get(rel, {}).get(name)
            if hit:
                return hit
            if name in self._classes.get(rel, {}):
                return self._classes[rel][name].get("__init__")
            imp = self._imports.get(rel, {}).get(name)
            if imp and imp[0] == "obj":
                return self._resolve_obj(imp[1], imp[2])
            return None
        if parts[0] in ("self", "cls") and cls is not None:
            if len(parts) == 2:
                return self._resolve_method(rel, cls, parts[1])
            if len(parts) == 3:
                typ = self._attr_types.get(rel, {}).get(cls, {}).get(
                    parts[1]
                )
                if typ is not None:
                    return self._resolve_method(typ[0], typ[1], parts[2])
            return None
        # ClassName.method in this module or an imported class
        hit = self._class_by_dotted(rel, ".".join(parts[:-1]))
        if hit is not None:
            return self._resolve_method(hit[0], hit[1], parts[-1])
        # mod.func through an imported module (any alias depth)
        for split in range(len(parts) - 1, 0, -1):
            head, tail = ".".join(parts[:split]), parts[split:]
            imp = self._imports.get(rel, {}).get(head)
            if imp and imp[0] == "module" and len(tail) == 1:
                return self._resolve_obj(imp[1], tail[0])
        return None

    def _resolve_obj(self, rel: str, name: str) -> str | None:
        hit = self._locals.get(rel, {}).get(name)
        if hit:
            return hit
        if name in self._classes.get(rel, {}):
            return self._classes[rel][name].get("__init__")
        imp = self._imports.get(rel, {}).get(name)  # re-export
        if imp and imp[0] == "obj":
            return self._resolve_obj(imp[1], imp[2])
        return None

    def _resolve_method(self, rel: str, cls: str, meth: str) -> str | None:
        """Method lookup through the class and its package-resolvable
        bases (declaration order — Python's MRO for the single-
        inheritance shapes this package uses)."""
        seen: set[tuple[str, str]] = set()
        stack = [(rel, cls)]
        while stack:
            cur = stack.pop(0)
            if cur in seen:
                continue
            seen.add(cur)
            crel, cname = cur
            hit = self._classes.get(crel, {}).get(cname, {}).get(meth)
            if hit:
                return hit
            for base in self._bases.get(crel, {}).get(cname, ()):
                bhit = self._class_by_dotted(crel, base)
                if bhit is not None:
                    stack.append(bhit)
        return None

    # -- blocking fixed point -------------------------------------------

    def blocking_paths(self) -> dict[str, BlockingWitness]:
        """qual -> witness for every node that reaches a blocking
        primitive through its own control flow or any resolved callee
        chain.  Monotone fixed point over call edges; each node keeps
        the first witness it acquired (stable across runs — nodes and
        calls are iterated in sorted/source order).

        Propagation crosses an edge only when the callee is SYNC: a
        sync callee's body executes inline at the call, while merely
        calling an ``async def`` builds a coroutine without running it
        — the await that eventually runs it belongs to (and is flagged
        at) the async frame that does the awaiting."""
        witness: dict[str, BlockingWitness] = {}
        for qual in sorted(self.nodes):
            node = self.nodes[qual]
            if node.blocking:
                prim, line = node.blocking[0]
                witness[qual] = BlockingWitness(prim, line, None)
        changed = True
        while changed:
            changed = False
            for qual in sorted(self.nodes):
                if qual in witness:
                    continue
                for call in self.nodes[qual].calls:
                    if (
                        call.target in witness
                        and not self.nodes[call.target].is_async
                    ):
                        tail = witness[call.target]
                        witness[qual] = BlockingWitness(
                            tail.primitive, call.line, call.target
                        )
                        changed = True
                        break
        return witness

    def witness_chain(
        self, qual: str, witness: dict[str, BlockingWitness]
    ) -> list[str]:
        """Human call path: ["Node._handle_block", "check_block",
        ..., "os.fsync"] for the finding detail."""
        chain = [self.nodes[qual].name]
        seen = {qual}
        cur = witness.get(qual)
        while cur is not None and cur.via is not None:
            if cur.via in seen:  # defensive: recursion in the witness
                break
            seen.add(cur.via)
            chain.append(self.nodes[cur.via].name)
            cur = witness.get(cur.via)
        chain.append(cur.primitive if cur is not None else "?")
        return chain


def local_set_bindings(scope: ast.AST) -> frozenset[str]:
    """Local names in ``scope`` (a function def or module) EVERY
    binding of which is structurally a set expression — the one-
    dataflow-hop summary the upgraded ``set-iteration`` rule and the
    call-graph node summaries share.

    Deliberately an under-approximation: any binding the classifier
    cannot prove a set (a parameter, a for/with target, tuple
    unpacking, a reassignment to ``sorted(...)``) disqualifies the
    name, so ``s = set(...); s = sorted(s)`` stays clean."""
    set_bound: dict[str, bool] = {}
    for sub in walk_no_nested_defs(scope):
        if isinstance(sub, (ast.Assign, ast.AnnAssign)):
            targets = (
                sub.targets if isinstance(sub, ast.Assign) else [sub.target]
            )
            value = sub.value
            for tgt in targets:
                if isinstance(tgt, ast.Name) and value is not None:
                    isset = is_set_expr(value)
                    set_bound[tgt.id] = isset and set_bound.get(tgt.id, True)
                elif isinstance(tgt, (ast.Tuple, ast.List)):
                    for el in ast.walk(tgt):
                        if isinstance(el, ast.Name):
                            set_bound[el.id] = False
        elif isinstance(sub, ast.NamedExpr) and isinstance(
            sub.target, ast.Name
        ):
            isset = is_set_expr(sub.value)
            set_bound[sub.target.id] = isset and set_bound.get(
                sub.target.id, True
            )
        elif isinstance(sub, (ast.For, ast.AsyncFor)):
            for el in ast.walk(sub.target):
                if isinstance(el, ast.Name):
                    set_bound[el.id] = False
        elif isinstance(sub, ast.withitem) and sub.optional_vars:
            for el in ast.walk(sub.optional_vars):
                if isinstance(el, ast.Name):
                    set_bound[el.id] = False
        elif isinstance(sub, ast.ExceptHandler) and sub.name:
            set_bound[sub.name] = False
        elif isinstance(sub, (ast.Import, ast.ImportFrom)):
            for alias in sub.names:
                set_bound[alias.asname or alias.name.split(".")[0]] = False
    args = getattr(scope, "args", None)
    if args is not None:
        for a in (
            *args.posonlyargs,
            *args.args,
            *args.kwonlyargs,
            *([args.vararg] if args.vararg else []),
            *([args.kwarg] if args.kwarg else []),
        ):
            set_bound[a.arg] = False
    return frozenset(n for n, isset in set_bound.items() if isset)


def _contains_cdll(value: ast.AST) -> bool:
    for node in ast.walk(value):
        if isinstance(node, ast.Call) and dotted_name(node.func) in (
            "ctypes.CDLL",
            "CDLL",
        ):
            return True
    return False


def iter_functions(tree: ast.Module) -> Iterator[tuple[str | None, ast.AST]]:
    """(class name | None, def) for every top-level function and
    method in a module — the shared walk order the graph uses."""
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield None, stmt
        elif isinstance(stmt, ast.ClassDef):
            for sub in stmt.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield stmt.name, sub
