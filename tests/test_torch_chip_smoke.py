"""``chip_smoke.py``'s process hygiene and phase 15, on the CPU.

The smoke must stop every process it starts.  It adopts its children's
orphans, stops the resource tracker that ``multiprocessing``'s spawn
pools start, and kills and reaps whatever child is left.  Each case runs
in a fresh interpreter, because becoming a subreaper lasts for the life
of the process.  Without a card the smoke itself exits 2 and starts
nothing.  Phase 15's pinned trace digests are what the JAX package
computes now (the 1,000-node pin is ``slow``, as the reference's own
1,000-node run is), and the phase runs end to end on the host
(``device="cpu"``) at its 200-node size.  Phase 16, ``lint``, runs on
the host as it does beside the card, and its verdict passes a clean
report and fails one with a violation or a stale grant.
"""

import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(script: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(script)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )  # fmt: skip
    assert proc.returncode == 0, f"stdout={proc.stdout}\nstderr={proc.stderr}"
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_an_orphaned_grandchild_is_adopted_and_stopped():
    out = run("""
        import json, os, subprocess
        import chip_smoke as cs

        cs.adopt_orphans()
        # A shell that leaves a sleeper behind: its orphan comes to us.
        shell = subprocess.run(["sh", "-c", "sleep 60 >/dev/null 2>&1 & echo $!"],
                               capture_output=True, text=True, check=True)
        sleeper = int(shell.stdout)
        adopted = sleeper in cs.child_pids()
        left = cs.stop_children()
        print(json.dumps({"adopted": adopted, "left": left, "gone": not os.path.exists(f"/proc/{sleeper}"),
                          "after": cs.child_pids()}))
    """)
    assert out["adopted"] and out["gone"], out
    assert len(out["left"]) == 1 and "sleep 60" in out["left"][0], out
    assert out["after"] == [], out


def test_the_resource_tracker_is_stopped_and_reaped():
    out = run("""
        import concurrent.futures, json, multiprocessing, os
        from multiprocessing import resource_tracker
        import chip_smoke as cs

        cs.adopt_orphans()
        with concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as ex:
            assert ex.submit(abs, -3).result() == 3
        tracker = resource_tracker._resource_tracker._pid
        running = tracker in cs.child_pids()
        cs.stop_resource_tracker()
        print(json.dumps({"running": running, "gone": not os.path.exists(f"/proc/{tracker}"),
                          "left": cs.stop_children()}))
    """)
    assert out == {"running": True, "gone": True, "left": []}


def test_without_a_card_it_exits_2_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )  # fmt: skip
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


# -- phase 15's pins and a rehearsal of the phase -----------------------------

import importlib.util  # noqa: E402

import pytest  # noqa: E402


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", module)  # its dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def test_pinned_digests_are_the_reference_200_node_and_fee_spam():
    """The digests phase 15 holds the card's meshes to are what the JAX
    package computes now."""
    from p1_tpu.node.scenarios import fee_spam, partition_heal

    cs = _smoke()
    assert partition_heal(nodes=200, seed=0)["trace_digest"] == cs.SIM_DIGEST_200
    assert fee_spam(seed=0)["trace_digest"] == cs.SIM_DIGEST_FEE_SPAM


def test_pinned_digests_are_the_reference_chaos():
    from p1_tpu.node.chaos import generate_schedule, run_chaos

    cs = _smoke()
    got = tuple(run_chaos(seed, events=generate_schedule(seed, 6, 12))["trace_digest"] for seed in (0, 1))
    assert got == cs.CHAOS_DIGESTS


@pytest.mark.slow
def test_pinned_digest_is_the_reference_1000_node():
    from p1_tpu.node.scenarios import partition_heal

    assert partition_heal(seed=0)["trace_digest"] == _smoke().SIM_DIGEST_1000


def test_phase_planes_rehearsed_on_the_host():
    """Phase 15 on the CPU (``device="cpu"``): the 200-node pair, fee-spam
    and chaos through ``cli.main`` held to the pins, every sealed header
    to the plain version, and ``serve --workers 2`` over a small chain
    answering headers and a proof, nothing launched and no process left."""
    out = run("""
        import json
        import chip_smoke as cs
        from p1_tpu_torch.benchmarks.host_ingest import build_blocks
        from p1_tpu_torch.hashx import cuda_backend, cuda_ed25519

        cs.adopt_orphans()
        cs.SIM_RUNS = tuple(r for r in cs.SIM_RUNS if "1000" not in r[0])
        cs.TAMPER_HEIGHT = 5
        chain, _ = build_blocks(8, 2, difficulty=1)
        line, launches = cs.phase_planes(cuda_backend.sha256d_search, cuda_ed25519.ed25519_msm, chain, device="cpu")
        cs.stop_resource_tracker()
        print(json.dumps({"runs": sorted(line["runs"]), "checked": line["sealed_checked"],
                          "serve": line["serve"], "launches": launches, "left": cs.stop_children()}))
    """)
    assert out["runs"] == ["chaos_2", "fee_spam", "partition_heal_200", "partition_heal_200_cpu"]
    assert out["checked"] > 0 and out["left"] == []
    assert out["launches"] == {"sha256d_search": 0, "ed25519_msm": 0}
    assert out["serve"]["headers"] == 9 and out["serve"]["exit"] == 0


def test_phase_lint_rehearsed_on_the_host():
    """Phase 16 as the smoke runs it: ``lint --json`` over this checkout
    in a child process, clean, all 9 rules, nothing left running."""
    out = run("""
        import json
        import chip_smoke as cs

        cs.adopt_orphans()
        line = cs.phase_lint()
        print(json.dumps({**line, "left": cs.stop_children()}))
    """)
    assert out["phase"] == "lint" and out["rules"] == 9
    assert out["files"] >= 90 and out["granted"] > 0 and out["seconds"] > 0
    assert out["left"] == []


_CLEAN_LINT = {"files": 97, "rules": ["r"] * 9, "clean": True, "violations": [],
               "granted": [{"file": "node/node.py", "line": 1, "rule": "wall-clock", "detail": "d",
                            "key": "asyncio.sleep"}],
               "stale": [], "parse_errors": []}  # fmt: skip


@pytest.mark.parametrize(
    "returncode,change",
    [
        (1, {"violations": [{"file": "node/x.py", "line": 3, "rule": "wall-clock", "detail": "d", "key": "time.time"}]}),
        (1, {"stale": ["wall-clock: node/node.py: grant 'time.time' never used"]}),
        (1, {"parse_errors": ["node/x.py: invalid syntax (line 1)"]}),
        (0, {"rules": ["r"] * 8}),
        (2, {}),
    ],
    ids=["violation", "stale", "parse-error", "rules-missing", "exit-2"],
)
def test_phase_lint_fails_on_a_dirty_report(returncode, change):
    cs = _smoke()
    assert cs.lint_line(0, _CLEAN_LINT, 1.5) == {"phase": "lint", "files": 97, "rules": 9, "granted": 1,
                                                  "seconds": 1.5}  # fmt: skip
    with pytest.raises(AssertionError):
        cs.lint_line(returncode, {**_CLEAN_LINT, **change}, 1.5)


def _trace(*kernels, cpu=((0, 1000),)):
    """A Chrome trace of CPU ops ``cpu`` and device kernels ``kernels``
    ((name, start µs, duration µs))."""
    events = [{"ph": "X", "cat": "cpu_op", "name": "op", "ts": t, "dur": d} for t, d in cpu]
    events += [{"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": d} for n, t, d in kernels]
    return {"traceEvents": [*events, {"ph": "i", "name": "marker"}]}


def test_trace_kernels_busy_share_is_the_union_over_the_window():
    cs = _smoke()
    trace = _trace(("sha256d_search_kernel", 100, 200), ("fill", 250, 100), ("sha256d_search_kernel", 600, 100))
    got = cs.trace_kernels(trace, "sha256d_search")
    assert got["kernels"] == 2 and got["kernel_us"] == 300 and got["all_kernels"] == 3
    assert got["all_kernel_us"] == 350 and got["window_us"] == 1000 and got["busy_share"] == 0.35


@pytest.mark.parametrize(
    "kernels,launches,out_dir",
    [
        ((("sha256d_search_kernel", 10, 5),), {"sha256d_search": 2}, "d"),  # a launch the trace lacks
        ((("sha256d_search_kernel", 10, 0), ("sha256d_search_kernel", 20, 0)), {"sha256d_search": 2}, "d"),
        ((), {"sha256d_search": 0}, "d"),  # the card's run launched nothing
        ((("sha256d_search_kernel", 10, 5),), {"sha256d_search": 1}, "elsewhere"),
    ],
    ids=["count", "no-device-time", "no-launch", "profile-dir"],
)
def test_phase_profile_fails_on_a_wrong_trace(kernels, launches, out_dir):
    cs = _smoke()
    report = {"profile_dir": "d", "blocks": 10, "time_to_block_s": 0.001}
    good = cs.profile_line(report, _trace(("sha256d_search_kernel", 10, 5)), {"sha256d_search": 1}, "d")
    assert good["phase"] == "profile" and good["kernels"] == 1 and good["launches"] == {"sha256d_search": 1}
    with pytest.raises(AssertionError):
        cs.profile_line(report, _trace(*kernels), launches, out_dir)


def test_phase_profile_rehearsed_on_the_host():
    """Phase 17 on the CPU: ``mine --profile`` of the plain version in a
    child process, a trace with no kernel and no launch, nothing left."""
    out = run("""
        import json
        import chip_smoke as cs

        cs.adopt_orphans()
        cs.PROFILE_ARGS = ("--difficulty", "8", "--blocks", "2")
        line = cs.phase_profile(device="cpu")
        print(json.dumps({**line, "left": cs.stop_children()}))
    """)
    assert out["phase"] == "profile" and out["blocks"] == 2 and out["kernels"] == 0
    assert out["launches"] == {"sha256d_search": 0} and out["window_us"] > 0 and out["left"] == []


_CARD_BENCH = {"platform": "cuda", "backend": "cuda", "value": 6.6e9, "unit": "H/s", "vs_baseline": 9000.0,
               "time_to_block_d20_s": 0.001, "native_hps": 6.6e6, "sig_device_ms": 0.01, "lint_findings": 0,
               "fleet_missed": 0, "sim_ok": True, "sim_sharded_ok": True, "relay_ok": True,
               "sim_vs_recorded": 1.02, "notify_degraded": True}  # fmt: skip
_LAUNCHED = {"sha256d_search": 40, "ed25519_msm": 9}


@pytest.mark.parametrize(
    "change,launches",
    [
        ({"platform": "cpu"}, _LAUNCHED),
        ({"backend": "torch"}, _LAUNCHED),
        ({"native_hps": None}, _LAUNCHED),
        ({"sig_device_ms": None}, _LAUNCHED),
        ({"lint_findings": 2}, _LAUNCHED),
        ({"fleet_missed": 1}, _LAUNCHED),
        ({"sim_ok": False}, _LAUNCHED),
        ({"sim_sharded_ok": False}, _LAUNCHED),
        ({"relay_ok": False}, _LAUNCHED),
        ({}, {"sha256d_search": 40, "ed25519_msm": 0}),
        ({}, {"ed25519_msm": 9}),
    ],
    ids=["platform", "backend", "native", "sig-device", "lint", "fleet", "sim", "far-field", "relay",
         "no-msm-launch", "no-search-launch"],  # fmt: skip
)
def test_phase_bench_fails_on_a_bad_line(change, launches):
    cs = _smoke()
    good = cs.bench_verdict(_CARD_BENCH, _LAUNCHED)
    assert good["vs_recorded"] == {"sim_vs_recorded": 1.02} and good["degraded"] == ["notify_degraded"]
    assert good["launches"] == _LAUNCHED
    line = {k: v for k, v in {**_CARD_BENCH, **change}.items() if v is not None}
    with pytest.raises(AssertionError):
        cs.bench_verdict(line, launches)


def test_phase_bench_verdict_on_the_host():
    """On the CPU the line names ``cpu`` and the ``torch`` backend, has no
    card rung, and launches nothing."""
    cs = _smoke()
    line = {**_CARD_BENCH, "platform": "cpu", "backend": "torch"}
    del line["sig_device_ms"]
    assert cs.bench_verdict(line, {"sha256d_search": 0}, device="cpu")["phase"] == "bench"
