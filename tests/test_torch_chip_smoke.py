"""``chip_smoke.py``'s process hygiene, on the CPU.

The smoke must stop every process it starts.  It adopts its children's
orphans, stops the resource tracker that ``multiprocessing``'s spawn
pools start, and kills and reaps whatever child is left.  Each case runs
in a fresh interpreter, because becoming a subreaper lasts for the life
of the process.  Without a card the smoke itself exits 2 and starts
nothing.
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
