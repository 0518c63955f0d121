"""Wall-clock lint headline tests over the port (p1_tpu_torch/analysis).

Mirrors tests/test_simlint.py's ``TestWallClockLint`` against the port's
analyzer and allowlist: the wall-clock rule (rules/wallclock.py: the
same patterns and the same coverage, node/, chain/, mempool/) over the
port's own copies of the node, chain and mempool modules.

- every wall-clock construct outside the allowlist fails (the generic
  sweep also runs in tests/test_torch_analysis.py with every other rule);
- the allowlist carries no stale grants;
- chain/snapshot.py is clock-free with ZERO grants;
- node/node.py's consensus core reads no host clock at all.
"""

from p1_tpu_torch.analysis import RULES, run_analysis
from p1_tpu_torch.analysis.allowlist import GRANTS
from p1_tpu_torch.analysis.engine import PKG_ROOT


def _wallclock_report():
    return run_analysis(rules=[RULES["wall-clock"]])


class TestWallClockLint:
    def test_no_direct_wall_clock_outside_the_allowlist(self):
        report = _wallclock_report()
        assert not report.violations, (
            "direct wall-clock/sleep constructs outside the blessed "
            "seams (route them through the node's Clock, or extend "
            "p1_tpu_torch/analysis/allowlist.py with a reason):\n  "
            + "\n  ".join(str(f) for f in report.violations)
        )
        assert not report.parse_errors, report.parse_errors

    def test_allowlist_carries_no_stale_grants(self):
        report = _wallclock_report()
        assert not report.stale, (
            "allowlist grants nothing uses (tighten the list):\n  "
            + "\n  ".join(report.stale)
        )

    def test_snapshot_plane_is_clock_free_from_day_one(self):
        """Round 12's module stays lint-covered and CLEAN: no direct
        wall-clock constructs, no allowlist grant — snapshot integrity
        checking and (de)serialization are pure functions of bytes, and
        granting the module a clock seam it does not need would only
        invite one.  The node-side fetch/revalidation machinery lives
        in node/node.py under ITS existing grant and reads time only
        through ``Node.clock``."""
        report = _wallclock_report()
        assert not any(
            f.file == "chain/snapshot.py" for f in report.findings
        ), [str(f) for f in report.findings if f.file == "chain/snapshot.py"]
        assert "chain/snapshot.py" not in GRANTS["wall-clock"]

    def test_recon_codec_is_clock_free_with_zero_grants(self):
        """Round 23's module ships lint-covered and CLEAN: the sketch
        codec is pure GF(2^32) arithmetic over bytes — no clock, no
        rng, no loop — and every consumer-side timing decision (round
        cadence, stall aging, demotion windows) lives in node/node.py
        under ITS existing grant, reading time through ``Node.clock``."""
        report = _wallclock_report()
        assert not any(
            f.file == "node/reconcile.py" for f in report.findings
        ), [str(f) for f in report.findings if f.file == "node/reconcile.py"]
        assert "node/reconcile.py" not in GRANTS["wall-clock"]

    def test_node_core_is_fully_seam_routed(self):
        """The headline: the node's consensus/session core reads NO
        host clock at all — every deadline, ban window, telemetry stamp
        and mining timestamp goes through ``self.clock``.  Its only
        grant is loop-relative ``asyncio.sleep``."""
        keys = {
            f.key for f in _wallclock_report().findings
            if f.file == "node/node.py"
        }
        assert "time.time" not in keys
        assert "time.monotonic" not in keys
        assert "time.perf_counter" not in keys
        assert set(GRANTS["wall-clock"]["node/node.py"]) == {"asyncio.sleep"}

    def test_telemetry_plane_is_clock_free_with_zero_grants(self):
        """Round 14's module ships lint-covered and CLEAN: the
        telemetry plane's whole contract is that it reads time only
        through its injected clock (the node passes the transport
        clock), so a direct wall-clock call here would break virtual-
        time measurement AND the sim determinism pair at once.  The
        ``time.monotonic`` spellings in the file are injectable default
        arguments — references the AST rule correctly ignores."""
        report = _wallclock_report()
        assert not any(
            f.file == "node/telemetry.py" for f in report.findings
        ), [str(f) for f in report.findings if f.file == "node/telemetry.py"]
        assert "node/telemetry.py" not in GRANTS["wall-clock"]

    def test_default_arg_references_are_structurally_clean(self):
        """What the AST migration BUYS over the tokenizer: the seam
        itself (node/transport.py) holds bare ``time.monotonic``
        references as injectable defaults without calling them, and
        needs no grant — the rule counts calls, not spellings."""
        assert (PKG_ROOT / "node" / "transport.py").exists()
        assert not any(
            f.file == "node/transport.py"
            for f in _wallclock_report().findings
        )
        assert "node/transport.py" not in GRANTS["wall-clock"]
