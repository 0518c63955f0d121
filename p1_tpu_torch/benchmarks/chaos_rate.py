"""Chaos sweep throughput of the port: schedules/second, wall-vs-virtual ratio.

    python -m p1_tpu_torch.benchmarks.chaos_rate [--schedules 10] [--nodes 5]
        [--events 10] [--seed 0] [--device cpu]

The port of ``benchmarks/chaos_rate.py``: how fast the chaos plane
searches the combined-fault space.  Every schedule is a full mesh life
cycle — formation, warmup mining, the fault events (crashes with torn
appends, disk errors, partitions, adversaries), the heal epilogue,
settle, and the invariant suite — so the schedules/s figure is the
search budget ``chaos`` spends from.  The companion ratio (virtual
seconds simulated per wall second) says what the discrete-event
substrate buys.  Each mesh seals through the ``cuda`` backend on
``device`` (the search kernel on the card, its plain PyTorch version
under ``--device cpu``); ``trace_digests`` lists each schedule's digest,
which the device does not move.  ``bench`` reads it against
``RECORDED_CHAOS_RATE`` (``p1_tpu_torch/hashx/perf_record.py``).
"""

from __future__ import annotations

import argparse
import json
import time

def bench_chaos(
    schedules: int = 10, nodes: int = 5, events: int = 10, seed: int = 0, device: str = "cuda"
) -> dict:
    """Run ``schedules`` consecutive seeds; all must hold their
    invariants (a violation voids the measurement — a failing sweep is
    a bug report, not a benchmark)."""
    from p1_tpu_torch.node.chaos import run_chaos

    wall = virtual = 0.0
    ok = True
    digests = []
    t0 = time.perf_counter()
    for s in range(seed, seed + schedules):
        report = run_chaos(s, nodes=nodes, n_events=events, device=device)
        ok &= report["ok"]
        virtual += report["virtual_s"]
        digests.append(report["trace_digest"])
    wall = time.perf_counter() - t0
    return {
        "schedules": schedules,
        "nodes": nodes,
        "events": events,
        "ok": ok,
        "wall_s": round(wall, 3),
        "virtual_s": round(virtual, 1),
        "chaos_schedules_per_sec": round(schedules / max(wall, 1e-9), 2),
        "virtual_per_wall": round(virtual / max(wall, 1e-9), 1),
        "trace_digests": digests,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--schedules", type=int, default=10)
    parser.add_argument("--nodes", type=int, default=5)
    parser.add_argument("--events", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args()
    print(json.dumps(bench_chaos(args.schedules, args.nodes, args.events, args.seed, args.device)))


if __name__ == "__main__":
    main()
