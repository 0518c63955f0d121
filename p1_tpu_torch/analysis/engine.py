"""Drive the rules over the package and settle findings against grants.

One parse per file, every in-scope rule over the shared tree (the
"multi-pass" is rule passes, not re-parses — the whole-package run
stays well under the ~5 s tier-1 budget on a 1-vCPU host).  The
parsed trees are kept for the run as a ``PackageIndex``
and a whole-package ``CallGraph`` is built over them once: *package
rules* (``Rule.package_rule``) see that index and check
interprocedural invariants no single tree can express.

Settlement semantics (both directions enforced, both inherited from the
original wall-clock lint):

- a finding whose ``(rule, file, key)`` appears in the allowlist is
  *granted* — suppressed from ``violations`` but recorded as having
  consumed its grant;
- a grant no finding consumed is *stale* and reported as a violation in
  its own right: an allowlist entry that outlives its construct is a
  blanket permission waiting for the next regression to hide under.

Scoped runs (``lint --path``): ``paths`` narrows which files'
findings are REPORTED, but the analysis itself always covers the
whole package — the call graph is interprocedural, so a partial parse
would silently weaken every package rule — and settlement stays
global: grant consumption is computed from ALL findings and stale
grants anywhere still fail, so a scoped run can narrow what you look
at without hiding a rotting grant.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from functools import cached_property
from pathlib import Path
from typing import Iterable, Iterator

from p1_tpu_torch.analysis.base import RULES, Rule
from p1_tpu_torch.analysis.callgraph import CallGraph
from p1_tpu_torch.analysis.findings import Finding

#: The analyzed package root (p1_tpu_torch/).
PKG_ROOT = Path(__file__).resolve().parent.parent


def package_files(root: Path = PKG_ROOT) -> Iterator[tuple[str, Path]]:
    """Every Python source in the package as (rel, path), sorted so
    reports and grant settlement are order-stable."""
    for path in sorted(root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        yield path.relative_to(root).as_posix(), path


@dataclass
class PackageIndex:
    """The parsed package a run shares across rules: rel -> tree, plus
    the call graph built lazily on first package-rule access (a
    per-file-only run never pays for it)."""

    trees: dict[str, ast.Module]

    @cached_property
    def graph(self) -> CallGraph:
        return CallGraph(self.trees)


@dataclass
class Report:
    """One analysis run.  ``clean`` is the tier-1 gate: no unallowlisted
    findings AND no stale grants."""

    findings: list[Finding] = field(default_factory=list)  # everything emitted
    violations: list[Finding] = field(default_factory=list)  # not granted
    granted: list[Finding] = field(default_factory=list)  # grant-suppressed
    stale: list[str] = field(default_factory=list)  # grants nothing used
    parse_errors: list[str] = field(default_factory=list)
    files: int = 0
    rules: list[str] = field(default_factory=list)
    #: call-graph size when a package rule ran (so analysis-cost creep
    #: is visible over time); 0 = not built.
    callgraph_nodes: int = 0
    callgraph_edges: int = 0
    #: the --path scope of this run, empty = whole package.
    scoped_to: list[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.violations and not self.stale and not self.parse_errors

    def to_json(self) -> dict:
        return {
            "files": self.files,
            "rules": self.rules,
            "clean": self.clean,
            "violations": [vars(f) for f in self.violations],
            "granted": [vars(f) for f in self.granted],
            "stale": self.stale,
            "parse_errors": self.parse_errors,
            "callgraph_nodes": self.callgraph_nodes,
            "callgraph_edges": self.callgraph_edges,
            "scoped_to": self.scoped_to,
        }


def _in_scope(rel: str, paths: list[str] | None) -> bool:
    if not paths:
        return True
    return any(
        rel == p or (p.endswith("/") and rel.startswith(p)) for p in paths
    )


def run_analysis(
    root: Path = PKG_ROOT,
    rules: Iterable[Rule] | None = None,
    grants: dict[str, dict[str, dict[str, str]]] | None = None,
    paths: list[str] | None = None,
) -> Report:
    """Run ``rules`` (default: the full registry) over every module
    under ``root`` and settle against ``grants`` (default: the audited
    allowlist in p1_tpu_torch/analysis/allowlist.py).  ``paths`` (package-
    relative files like "node/node.py" or dir prefixes like "node/")
    scopes which files' findings are reported — see the module
    docstring for what stays global."""
    if grants is None:
        from p1_tpu_torch.analysis.allowlist import GRANTS

        grants = GRANTS
    active = list(RULES.values()) if rules is None else list(rules)
    report = Report(
        rules=[r.name for r in active], scoped_to=sorted(paths or [])
    )
    used: set[tuple[str, str, str]] = set()

    trees: dict[str, ast.Module] = {}
    for rel, path in package_files(root):
        report.files += 1
        try:
            trees[rel] = ast.parse(path.read_bytes(), filename=rel)
        except SyntaxError as e:  # a file ast can't read is a finding, not a skip
            report.parse_errors.append(f"{rel}: {e.msg} (line {e.lineno})")
    pkg = PackageIndex(trees=trees)

    def settle(f: Finding) -> None:
        # Grant consumption is GLOBAL: every finding — in scope or not —
        # marks its grant used, so a scoped run settles the stale-grant
        # direction exactly like a full run.  Only the REPORTED lists
        # (findings/violations/granted) honor the scope.
        granted = f.key in grants.get(f.rule, {}).get(f.file, {})
        if granted:
            used.add((f.rule, f.file, f.key))
        if not _in_scope(f.file, paths):
            return
        report.findings.append(f)
        (report.granted if granted else report.violations).append(f)

    for rule in active:
        if rule.package_rule:
            for f in rule.check_package(pkg):
                settle(f)
            continue
        for rel, tree in trees.items():
            if not rule.applies_to(rel):
                continue
            for f in rule.check(tree, rel):
                settle(f)

    if any(r.package_rule for r in active):
        report.callgraph_nodes = len(pkg.graph.nodes)
        report.callgraph_edges = pkg.graph.edges

    active_names = {r.name for r in active}
    known = {rel for rel, _ in package_files(root)}
    for rule_name, by_file in sorted(grants.items()):
        if rule_name not in RULES:
            # A grant under a name the registry doesn't know is stale by
            # definition — reported even on partial runs, or a renamed
            # rule would orphan its whole grant table silently.
            if by_file:
                report.stale.append(f"{rule_name}: no such rule")
            continue
        if rule_name not in active_names:
            continue  # a partial run must not misreport other rules' grants
        for rel, keys in sorted(by_file.items()):
            if rel not in known:
                report.stale.append(f"{rule_name}: {rel}: file no longer exists")
                continue
            for key in sorted(keys):
                if (rule_name, rel, key) not in used:
                    report.stale.append(
                        f"{rule_name}: {rel}: grant {key!r} never used"
                    )

    report.findings.sort()
    report.violations.sort()
    report.granted.sort()
    return report
