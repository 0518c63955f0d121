"""The port's determinism/async-safety analyzer (p1_tpu_torch/analysis).

Mirrors tests/test_analysis.py case for case, run against
``p1_tpu_torch.analysis`` and its ``PKG_ROOT`` (the port's package):

1. **The tier-1 gate**: every registered rule over the whole port —
   zero unallowlisted findings, zero stale grants, zero parse errors.
   This is the test that makes the analyzer ENFORCED over the port.
2. **The fixture corpus**: per rule, a known-bad module (every line
   marked ``# LINT`` flagged at exactly that line, nothing else) and a
   known-good module (zero findings).  The fixtures are the reference's,
   read where they are (tests/fixtures/analysis/), and embed the
   historical bugs each rule was written to catch.
3. **The settlement machinery**: grants suppress exactly their
   (rule, file, key); unused grants and grants on vanished files or
   unknown rules surface as stale.

``TestCrossPackage`` runs both engines, the reference's over ``p1_tpu``
and the port's over ``p1_tpu_torch``: every file both packages have gives
the same ``(rule, key)`` findings, and the files only the port has (its
CUDA wrappers, kernel build, SASS counting, benchmarks) give none.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from p1_tpu_torch.analysis import RULES, run_analysis
from p1_tpu_torch.analysis.engine import PKG_ROOT, PackageIndex

#: The reference's corpus, read in place (shared, never copied).
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "analysis"

#: rule name -> fixture file prefix.
_RULE_FIXTURES = {
    "wall-clock": "wallclock",
    "lost-task": "losttask",
    "unseeded-rng": "rng",
    "set-iteration": "setiter",
    "blocking-in-async": "blocking",
    "await-state": "awaitstate",
    "transitive-blocking": "transblock",
    "escaped-state": "escstate",
    "wire-contract": "wirecontract",
}


def _rule_findings(rule_name: str, path: Path):
    """Run ONE rule over a fixture, under a rel path inside every
    rule's scope (the fixture corpus tests rule logic, not scoping).
    Package rules see the fixture as a one-file package index — the
    same interface the engine hands them, so corpus assertions cover
    the real entry point."""
    tree = ast.parse(path.read_bytes(), filename=path.name)
    rule = RULES[rule_name]
    if rule.package_rule:
        return list(rule.check_package(PackageIndex({f"node/{path.name}": tree})))
    return list(rule.check(tree, f"node/{path.name}"))


def _marked_lines(path: Path) -> set[int]:
    return {
        i
        for i, line in enumerate(path.read_text().splitlines(), start=1)
        if line.rstrip().endswith("# LINT")
    }


class TestTier1Gate:
    def test_whole_package_settles_clean(self):
        """THE gate: ≥9 rules over every module in p1_tpu_torch, everything
        either fixed or granted with a reason, no grant unused."""
        report = run_analysis()
        assert len(report.rules) >= 9, report.rules
        assert report.files >= 60, report.files  # the walk found the tree
        assert not report.parse_errors, report.parse_errors
        assert not report.violations, "unallowlisted findings:\n  " + "\n  ".join(
            str(f) for f in report.violations
        )
        assert not report.stale, "stale grants:\n  " + "\n  ".join(report.stale)
        assert report.clean

    def test_registry_matches_fixture_corpus(self):
        """Every registered rule carries a bad/good fixture pair — a
        new rule cannot land untested, and a renamed rule cannot orphan
        its fixtures silently."""
        assert set(RULES) == set(_RULE_FIXTURES)
        for prefix in _RULE_FIXTURES.values():
            assert (FIXTURES / f"{prefix}_bad.py").exists(), prefix
            assert (FIXTURES / f"{prefix}_good.py").exists(), prefix

    def test_analyzer_is_fast_enough_for_tier1(self):
        """The whole-package pass must stay interactive (the acceptance
        budget is ~5 s on a 1-vCPU host; the generous bound here exists
        to catch an accidental O(n^2) pass, not to time the machine)."""
        import time

        t0 = time.perf_counter()
        run_analysis()
        assert time.perf_counter() - t0 < 15.0


class TestFixtureCorpus:
    @pytest.mark.parametrize("rule_name,prefix", sorted(_RULE_FIXTURES.items()))
    def test_bad_fixture_flagged_at_exact_lines(self, rule_name, prefix):
        path = FIXTURES / f"{prefix}_bad.py"
        expected = _marked_lines(path)
        assert expected, f"{path.name} carries no # LINT markers"
        got = {f.line for f in _rule_findings(rule_name, path)}
        assert got == expected, (
            f"{rule_name} over {path.name}: flagged {sorted(got)}, "
            f"marked {sorted(expected)}"
        )

    @pytest.mark.parametrize("rule_name,prefix", sorted(_RULE_FIXTURES.items()))
    def test_good_fixture_is_clean(self, rule_name, prefix):
        path = FIXTURES / f"{prefix}_good.py"
        findings = _rule_findings(rule_name, path)
        assert not findings, [str(f) for f in findings]

    def test_findings_carry_file_line_rule_detail(self):
        f = _rule_findings("lost-task", FIXTURES / "losttask_bad.py")[0]
        assert f.file == "node/losttask_bad.py"
        assert f.rule == "lost-task"
        assert f.line > 0 and f.detail
        assert str(f).startswith(f"node/losttask_bad.py:{f.line}: [lost-task]")


class TestHistoricalReproductions:
    """Each rule's bad fixture embeds the incident that motivated it;
    these tests name the incidents so the corpus cannot quietly drop
    one in a refactor."""

    def test_round11_codec_host_stamp_is_caught(self):
        # node/protocol.py's encode_block default put time.time() INSIDE
        # frame bytes — the wall-clock rule flags the reproduction.
        path = FIXTURES / "wallclock_bad.py"
        assert any(
            f.key == "time.time" and "encode_block" in path.read_text()
            for f in _rule_findings("wall-clock", path)
        )

    def test_round3_dead_recovery_loop_is_caught(self):
        # The fire-and-forget store-recovery spawn whose silent death
        # stranded the node degraded forever.
        findings = _rule_findings("lost-task", FIXTURES / "losttask_bad.py")
        assert any(f.key == "_store_fail" for f in findings)

    def test_round7_and_round13_set_iteration_is_caught(self):
        # Relay fan-out over a set difference (r7) and the chaos plane's
        # set-literal probe heights (r13, fixed in this round).
        findings = _rule_findings("set-iteration", FIXTURES / "setiter_bad.py")
        assert len(findings) >= 2

    def test_set_through_a_variable_is_caught(self):
        # The round-13 docs conceded the "through a variable" residue;
        # round 16's one-dataflow-hop upgrade closes it.
        findings = _rule_findings("set-iteration", FIXTURES / "setiter_bad.py")
        assert any(f.key == "set-local" for f in findings)

    def test_helper_hidden_fsync_is_caught(self):
        # The transitive-blocking incident shape: the fsync lives in a
        # sync helper chain below a clean-looking async def — invisible
        # to the lexical blocking-in-async rule by construction.
        findings = _rule_findings(
            "transitive-blocking", FIXTURES / "transblock_bad.py"
        )
        keys = {f.key for f in findings}
        assert "Node.handle_block->open" in keys, keys
        # the full call path is in the detail — the ROADMAP-2 audit trail
        f = next(f for f in findings if f.key == "Node.handle_block->open")
        assert "Store.append" in f.detail and "_persist" in f.detail

    def test_helper_routed_state_write_across_await_is_caught(self):
        # The escaped-state incident shape: the chain write rides a
        # helper call on the far side of a scheduling point.
        findings = _rule_findings("escaped-state", FIXTURES / "escstate_bad.py")
        assert {f.key for f in findings} == {"chain", "mempool"}

    def test_frame_missing_shed_classification_fails_at_exact_key(self):
        # THE negative control the acceptance criteria name: one frame
        # type (BLOCK) in neither _SHED_DROPS nor _SHED_KEEPS must fail
        # at exactly "BLOCK:shed".
        findings = _rule_findings(
            "wire-contract", FIXTURES / "wirecontract_bad.py"
        )
        keys = {f.key for f in findings}
        assert "BLOCK:shed" in keys, keys
        assert keys == {
            "BLOCK:shed",
            "TX:dispatch",
            "STATUS:version",
            "HELLO:relay",
        }


class TestSettlement:
    """The allowlist machinery itself, on a tiny synthetic tree."""

    def _tiny_pkg(self, tmp_path: Path) -> Path:
        root = tmp_path / "pkg"
        root.mkdir()
        (root / "mod.py").write_text(
            "import random\n\n\ndef f():\n    return random.random()\n"
        )
        return root

    def test_ungranted_finding_is_a_violation(self, tmp_path):
        report = run_analysis(
            root=self._tiny_pkg(tmp_path),
            rules=[RULES["unseeded-rng"]],
            grants={},
        )
        assert [f.key for f in report.violations] == ["random.random"]
        assert not report.stale

    def test_grant_suppresses_and_is_consumed(self, tmp_path):
        report = run_analysis(
            root=self._tiny_pkg(tmp_path),
            rules=[RULES["unseeded-rng"]],
            grants={"unseeded-rng": {"mod.py": {"random.random": "test"}}},
        )
        assert not report.violations and not report.stale
        assert [f.key for f in report.granted] == ["random.random"]
        assert report.clean

    def test_unused_grant_goes_stale(self, tmp_path):
        report = run_analysis(
            root=self._tiny_pkg(tmp_path),
            rules=[RULES["unseeded-rng"]],
            grants={
                "unseeded-rng": {
                    "mod.py": {
                        "random.random": "used",
                        "random.shuffle": "nothing emits this",
                    },
                    "gone.py": {"random.random": "file vanished"},
                }
            },
        )
        assert sorted(report.stale) == [
            "unseeded-rng: gone.py: file no longer exists",
            "unseeded-rng: mod.py: grant 'random.shuffle' never used",
        ]
        assert not report.clean

    def test_partial_run_leaves_other_rules_grants_alone(self, tmp_path):
        """`lint --rule X` must not report rule Y's grants stale."""
        report = run_analysis(
            root=self._tiny_pkg(tmp_path),
            rules=[RULES["lost-task"]],
            grants={"unseeded-rng": {"mod.py": {"random.random": "r"}}},
        )
        assert not report.stale and not report.violations

    def test_parse_error_is_reported_not_skipped(self, tmp_path):
        root = tmp_path / "pkg"
        root.mkdir()
        (root / "broken.py").write_text("def f(:\n")
        report = run_analysis(root=root, rules=[RULES["lost-task"]], grants={})
        assert report.parse_errors and not report.clean

    def test_real_package_files_walk(self):
        rels = [rel for rel, _ in __import__(
            "p1_tpu_torch.analysis.engine", fromlist=["package_files"]
        ).package_files(PKG_ROOT)]
        assert "node/node.py" in rels
        assert "analysis/engine.py" in rels  # the analyzer analyzes itself
        assert not any("__pycache__" in r for r in rels)


class TestInterprocedural:
    """The round-16 call-graph plane: graph construction facts the
    three package rules depend on, and the wire-contract rule proven
    load-bearing against the REAL registries (not just fixtures)."""

    def _package_index(self):
        from p1_tpu_torch.analysis.engine import package_files

        trees = {
            rel: ast.parse(p.read_bytes(), filename=rel)
            for rel, p in package_files(PKG_ROOT)
        }
        return PackageIndex(trees)

    def test_graph_resolves_the_node_consensus_attributes(self):
        """The one-level attribute-type binding that makes the graph
        worth having: self.store/chain/mempool resolve to their real
        classes, so the fsync/validate chains are followable."""
        g = self._package_index().graph
        types = g._attr_types["node/node.py"]["Node"]
        assert types["store"] == ("chain/store.py", "ChainStore")
        assert types["chain"] == ("chain/chain.py", "Chain")
        assert types["mempool"] == ("mempool/mempool.py", "Mempool")

    def test_graph_sees_the_store_append_fsync_chain(self):
        """The headline residue closed: an async def reaching os.fsync
        through ChainStore is in the blocking fixed point."""
        g = self._package_index().graph
        witness = g.blocking_paths()
        assert "chain/store.py::ChainStore.append" in witness
        # and the chain walks down to a real primitive
        chain = g.witness_chain("chain/store.py::ChainStore.append", witness)
        assert chain[-1] in ("open", "os.fsync"), chain

    def test_to_thread_offload_is_not_an_edge(self):
        """The house pattern must stay clean: _checkpoint_mempool
        passes its blocking helper to asyncio.to_thread — no call
        edge, so no transitive-blocking finding against it."""
        g = self._package_index().graph
        witness = g.blocking_paths()
        node = g.nodes.get("node/node.py::Node._checkpoint_mempool")
        assert node is not None and node.is_async
        assert not any(
            c.target in witness
            and not g.nodes[c.target].is_async
            for c in node.calls
            if c.target
        ), [c.dotted for c in node.calls]

    def test_report_carries_callgraph_stats(self):
        report = run_analysis(rules=[RULES["transitive-blocking"]])
        assert report.callgraph_nodes > 500
        assert report.callgraph_edges > 500
        assert report.to_json()["callgraph_nodes"] == report.callgraph_nodes

    def test_wire_contract_is_load_bearing_on_the_real_tree(self):
        """Registry-mutation negative control: drop GETMETRICS from
        node.py's _SHED_DROPS in the PARSED tree and the gate must
        fail at exactly GETMETRICS:shed — proving the rule reads the
        real registries, not a fixture-shaped convention."""
        idx = self._package_index()
        src = (PKG_ROOT / "node" / "node.py").read_text()
        mutated = src.replace("MsgType.GETMETRICS,", "", 1)
        assert mutated != src  # _SHED_DROPS names it exactly once first
        idx.trees["node/node.py"] = ast.parse(mutated, filename="node/node.py")
        findings = list(RULES["wire-contract"].check_package(idx))
        assert [f.key for f in findings] == ["GETMETRICS:shed"], findings

    def test_wire_contract_guards_the_subscription_plane(self):
        """Round-21 mutation controls: the push-plane messages are held
        in the admission and shed registries by the gate, not by
        convention.  Each mutation drops one membership from the PARSED
        node.py and must fail at exactly that member:aspect."""
        src = (PKG_ROOT / "node" / "node.py").read_text()
        cases = [
            # _MSG_CLASS charge entry -> unclassified traffic
            ("MsgType.SUBSCRIBE: CLASS_QUERIES,", "SUBSCRIBE:admission"),
            # _ADMISSION_EXEMPT is the first set-style EVENT mention
            ("MsgType.EVENT,", "EVENT:admission"),
            # _SHED_DROPS is the first set-style SUBSCRIBE mention
            ("MsgType.SUBSCRIBE,", "SUBSCRIBE:shed"),
            # _SHED_KEEPS is the first set-style UNSUBSCRIBE mention
            ("MsgType.UNSUBSCRIBE,", "UNSUBSCRIBE:shed"),
        ]
        for needle, expect in cases:
            idx = self._package_index()
            mutated = src.replace(needle, "", 1)
            assert mutated != src, needle
            idx.trees["node/node.py"] = ast.parse(
                mutated, filename="node/node.py"
            )
            findings = list(RULES["wire-contract"].check_package(idx))
            assert [f.key for f in findings] == [expect], (needle, findings)

    def test_wire_contract_guards_the_relay_accounting_table(self):
        """Round-23 mutation control: every frame type's egress must
        land in a relay.bytes.* family — drop GETTX's row from the
        PARSED node.py and the gate must fail at exactly GETTX:relay
        (the runtime assert beside the table enforces it too; the rule
        fails BEFORE the code ever runs)."""
        src = (PKG_ROOT / "node" / "node.py").read_text()
        idx = self._package_index()
        mutated = src.replace('MsgType.GETTX: "recon",', "", 1)
        assert mutated != src
        idx.trees["node/node.py"] = ast.parse(
            mutated, filename="node/node.py"
        )
        findings = list(RULES["wire-contract"].check_package(idx))
        assert [f.key for f in findings] == ["GETTX:relay"], findings

    def test_transitive_blocking_grants_read_as_the_roadmap2_work_list(self):
        """Acceptance: every transitive-blocking grant names a concrete
        offload decision (a stage or an explicit on/off-loop verdict) —
        the table IS the multi-core split's audited inventory."""
        from p1_tpu_torch.analysis.allowlist import GRANTS

        grants = GRANTS["transitive-blocking"]
        assert grants, "the work list exists"
        for rel, keys in grants.items():
            for key, reason in keys.items():
                assert "->" in key, key  # coroutine->primitive keying
                assert any(
                    tag in reason
                    for tag in ("stage", "startup-only", "shutdown-only",
                                "worker", "offload")
                ), f"{key}: reason names no offload decision: {reason}"

    def test_round19_staging_strictly_shrank_the_node_grant_inventory(self):
        """Round-19 acceptance: the staged pipeline RETIRED grants, it
        did not relabel them.  node/node.py's transitive-blocking table
        held twelve chains at round 16; the two survivors are exactly
        the start/stop boundary cases (no session to stall / pipeline
        drained first), and every validate (ctypes) and store-append
        (open/os.fsync) chain runs on a pipeline lane with NO grant —
        so the count can only have strictly decreased."""
        from p1_tpu_torch.analysis.allowlist import GRANTS

        node_grants = GRANTS["transitive-blocking"]["node/node.py"]
        assert len(node_grants) < 12, "round-16 inventory must shrink"
        assert set(node_grants) == {"Node.start->open", "Node.stop->open"}
        assert not any(
            key.endswith(("ctypes.CDLL", "os.fsync")) for key in node_grants
        ), "validate/store chains must be offloaded, not granted"
        # And the retirement is real, not a lint blind spot: the engine
        # still settles with zero node.py findings against this table.
        report = run_analysis(rules=[RULES["transitive-blocking"]])
        assert not [
            f for f in report.violations if f.file == "node/node.py"
        ], [str(f) for f in report.violations]


class TestScopedRuns:
    """run_analysis(paths=...) — the `lint --path` engine contract:
    findings narrow to the scope, settlement stays global."""

    def _two_file_pkg(self, tmp_path: Path) -> Path:
        root = tmp_path / "pkg"
        root.mkdir()
        (root / "a.py").write_text(
            "import random\n\n\ndef f():\n    return random.random()\n"
        )
        (root / "b.py").write_text(
            "import random\n\n\ndef g():\n    return random.choice([1])\n"
        )
        return root

    def test_scope_filters_reported_violations(self, tmp_path):
        report = run_analysis(
            root=self._two_file_pkg(tmp_path),
            rules=[RULES["unseeded-rng"]],
            grants={},
            paths=["a.py"],
        )
        assert [f.file for f in report.violations] == ["a.py"]
        assert report.scoped_to == ["a.py"]

    def test_directory_scope_matches_prefix(self, tmp_path):
        root = tmp_path / "pkg"
        (root / "sub").mkdir(parents=True)
        (root / "sub" / "mod.py").write_text(
            "import random\nx = random.random()\n"
        )
        (root / "top.py").write_text("import random\ny = random.random()\n")
        report = run_analysis(
            root=root, rules=[RULES["unseeded-rng"]], grants={}, paths=["sub/"]
        )
        assert [f.file for f in report.violations] == ["sub/mod.py"]

    def test_out_of_scope_grant_is_consumed_not_stale(self, tmp_path):
        """Settlement is global: the finding in the out-of-scope file
        still consumes its grant, so the scoped run reports neither a
        violation nor a stale grant for it."""
        report = run_analysis(
            root=self._two_file_pkg(tmp_path),
            rules=[RULES["unseeded-rng"]],
            grants={
                "unseeded-rng": {
                    "a.py": {"random.random": "granted in scope"},
                    "b.py": {"random.choice": "granted out of scope"},
                }
            },
            paths=["a.py"],
        )
        assert not report.violations and not report.stale
        assert [f.file for f in report.granted] == ["a.py"]  # reported in scope

    def test_scoped_run_cannot_hide_a_stale_grant(self, tmp_path):
        """The satellite's headline: a grant NOTHING uses — wherever
        its file lives — still fails a run scoped elsewhere."""
        report = run_analysis(
            root=self._two_file_pkg(tmp_path),
            rules=[RULES["unseeded-rng"]],
            grants={
                "unseeded-rng": {
                    "b.py": {"random.shuffle": "nothing emits this"},
                }
            },
            paths=["a.py"],
        )
        assert "unseeded-rng: b.py: grant 'random.shuffle' never used" in (
            report.stale
        )
        assert not report.clean


class TestGrantHygiene:
    def test_grant_under_unknown_rule_is_stale_even_on_partial_runs(
        self, tmp_path
    ):
        """A renamed rule must not orphan its grant table silently."""
        root = tmp_path / "pkg"
        root.mkdir()
        (root / "mod.py").write_text("x = 1\n")
        report = run_analysis(
            root=root,
            rules=[RULES["lost-task"]],
            grants={"no-such-rule": {"mod.py": {"k": "r"}}},
        )
        assert report.stale == ["no-such-rule: no such rule"]

    def test_every_registered_rule_has_an_allowlist_section(self):
        """The allowlist names every rule (even if empty) so a reviewer
        sees the full settlement surface in one file."""
        from p1_tpu_torch.analysis.allowlist import GRANTS

        assert set(GRANTS) == set(RULES)

    def test_every_grant_carries_a_nonempty_reason(self):
        from p1_tpu_torch.analysis.allowlist import GRANTS

        for rule, by_file in GRANTS.items():
            for rel, keys in by_file.items():
                for key, reason in keys.items():
                    assert (
                        isinstance(reason, str) and len(reason) >= 10
                    ), f"{rule}/{rel}/{key}: grant reason too thin"


class TestCrossPackage:
    """The port's analyzer over the port against the reference's over
    the reference: the port's modules are copies, so the same constructs
    sit in the same files and must draw the same findings, each settled
    by the same grant key."""

    #: Files only the port has: they must stay finding-free.
    PORT_ONLY = (
        "benchmarks/",
        "graft_entry.py",
        "hashx/cuda_backend.py",
        "hashx/cuda_ed25519.py",
        "hashx/cuda_verify.py",
        "hashx/kernel_build.py",
        "hashx/sass.py",
        "hashx/torch_backend.py",
        "hashx/torch_sha256.py",
    )

    @staticmethod
    def _keys(report, files):
        out: dict[str, set[tuple[str, str]]] = {rel: set() for rel in files}
        for f in report.findings:
            if f.file in out:
                out[f.file].add((f.rule, f.key))
        return out

    @pytest.fixture(scope="class")
    def runs(self):
        from p1_tpu.analysis import run_analysis as ref_run
        from p1_tpu.analysis.engine import PKG_ROOT as REF_ROOT
        from p1_tpu.analysis.engine import package_files as ref_files
        from p1_tpu_torch.analysis.engine import package_files

        ref_rels = {rel for rel, _ in ref_files(REF_ROOT)}
        port_rels = {rel for rel, _ in package_files(PKG_ROOT)}
        return ref_run(), run_analysis(), ref_rels, port_rels

    def test_each_shared_file_draws_the_same_findings(self, runs):
        ref, port, ref_rels, port_rels = runs
        shared = ref_rels & port_rels
        assert "node/node.py" in shared and "analysis/engine.py" in shared
        ref_keys, port_keys = self._keys(ref, shared), self._keys(port, shared)
        diff = {
            rel: (sorted(ref_keys[rel]), sorted(port_keys[rel]))
            for rel in sorted(shared)
            if ref_keys[rel] != port_keys[rel]
        }
        assert not diff, diff
        assert sum(map(len, port_keys.values())) > 0  # the runs saw something

    def test_port_only_files_draw_no_finding(self, runs):
        ref, port, ref_rels, port_rels = runs
        only = port_rels - ref_rels
        for want in self.PORT_ONLY:
            assert any(rel.startswith(want) for rel in only), want
        hits = [str(f) for f in port.findings if f.file in only]
        assert not hits, hits

    def test_both_settle_clean_under_the_same_grant_keys(self, runs):
        from p1_tpu.analysis.allowlist import GRANTS as REF_GRANTS
        from p1_tpu_torch.analysis.allowlist import GRANTS

        ref, port = runs[0], runs[1]
        assert ref.clean and port.clean
        assert ref.rules == port.rules

        def keyset(grants):
            return {
                (rule, rel, key)
                for rule, by_file in grants.items()
                for rel, keys in by_file.items()
                for key in keys
            }

        assert keyset(GRANTS) == keyset(REF_GRANTS)
