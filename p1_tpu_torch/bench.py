"""Benchmark of the port: SHA-256d hashes/s per card, time to a block at
difficulty 20, and every plane's rate against its pin.

    python -m p1_tpu_torch bench [--device cpu]
    python -m p1_tpu_torch.bench [--device cpu]

The port's counterpart of the root ``bench.py``: it prints ONE JSON line
on stdout with the reference's required keys ``metric``, ``value``,
``unit`` and ``vs_baseline``, and its other keys wherever their meaning
carries to the card, each ``*_vs_recorded`` ratio against a pin of
``p1_tpu_torch/hashx/perf_record.py``.  It runs on the card unless
``--device cpu`` is given, and raises without one.

- The headline is the ``cuda`` backend (``hashx/csrc/sha256d_search.cu``)
  over 2**29 nonces on the card; under ``--device cpu`` the ``torch``
  backend (the kernel's plain PyTorch version) over 2**21.
  ``vs_baseline`` divides it by the hashlib ``cpu`` backend measured in
  the same run, ``vs_recorded`` by the pinned healthy hashlib rate.
- ``torch_hps`` (the reference's ``xla_hps``): the ``torch`` backend on
  the card, the plain version beside the kernel.
- ``time_to_block_d20_s``: the median of 5 blocks mined through
  ``Miner`` on the headline's backend.
- ``sig_native_ms`` / ``sig_device_ms``: ms per signature of a 1,024
  batch on the native C++ engine, and through ``verify_batch_device``
  (``hashx/csrc/ed25519_msm.cu``) on the card.
- The planes (``p1_tpu_torch/benchmarks/``): host ingest, staged ingest,
  telemetry overhead, store revalidation, the query and wallet planes,
  fleet provisioning, the simulator (full, far field, relay budget), the
  chaos plane, snapshot boot, the archive and the maintenance cadence;
  then the static analyzer's figures.  A simulated mesh and the wallet
  plane's mining node seal through the ``cuda`` backend on the card.

A missing plane module is a fault of the package, not an install
variant: nothing here swallows an ``ImportError``.  Each kernel
wrapper's launch count goes to stderr at the end (``kernel launches:``),
stdout keeps its one line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

# Difficulty no hash can meet: keeps throughput runs scanning the whole range.
IMPOSSIBLE = 255
#: Nonces of the headline scan, by device (the reference's TPU and CPU counts).
HEADLINE_COUNT = {"cuda": 1 << 29, "cpu": 1 << 21}
CPU_BASELINE_COUNT = 1 << 21
#: Nonces of ``torch_hps``: the plain version runs ~17 MH/s on the card,
#: so 2**26 (a few seconds a pass) rather than the reference's 2**28.
TORCH_COUNT = 1 << 26
NATIVE_COUNT = 1 << 22
TTB_DIFFICULTY = 20
TTB_BLOCKS = 5
SIG_BATCH = 1024
#: Keys a CPU run cannot carry: the relay guard's retries and the card's rungs.
CARD_ONLY_KEYS = ("degraded_retries", "torch_hps", "sig_device_ms", "sig_device_vs_recorded", "sig_device_degraded")


def _throughput(backend, prefix: bytes, count: int, repeats: int = 3) -> float:
    """Best-of-N hashes/sec scanning ``count`` nonces with no hits."""
    backend.search(prefix, 0, min(count, 1 << 16), IMPOSSIBLE)  # warm: build and load
    best = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = backend.search(prefix, 0, count, IMPOSSIBLE)
        best = max(best, res.hashes_done / (time.perf_counter() - t0))
    return best


def _time_to_block(miner, difficulty: int, blocks: int) -> float:
    """Median wall-clock seconds to seal a block at ``difficulty``."""
    from p1_tpu_torch.core.genesis import make_genesis
    from p1_tpu_torch.core.header import BlockHeader

    tip = make_genesis(difficulty)
    times = []
    prev = tip.block_hash()
    for height in range(1, blocks + 1):
        header = BlockHeader(1, prev, bytes(32), tip.header.timestamp + 60 * height, difficulty, 0)
        t0 = time.perf_counter()
        sealed = miner.search_nonce(header)
        times.append(time.perf_counter() - t0)
        if sealed is None:
            raise RuntimeError(f"no seal found at height {height}")
        prev = sealed.block_hash()
    return statistics.median(times)


def _peak_rss_bytes() -> int:
    """This process's peak resident set: VmHWM (reset by execve), else
    ``ru_maxrss``, which survives fork+exec (a child reports a larger
    parent's) and, where ``/proc`` keeps no VmHWM, is the figure."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def measure(device: str) -> dict:
    """Every figure of the bench line on ``device`` ("cuda" or "cpu")."""
    import torch

    from p1_tpu_torch.benchmarks import (
        archive_scale,
        chaos_rate,
        host_ingest,
        maintenance_cadence,
        netsim_scale,
        query_plane,
        sig_verify,
        snapshot_boot,
        telemetry_overhead,
        wallet_plane,
    )
    from p1_tpu_torch.core import _ed25519_native, keys
    from p1_tpu_torch.core.genesis import make_genesis
    from p1_tpu_torch.hashx import ed25519_msm, get_backend
    from p1_tpu_torch.hashx import perf_record as pr
    from p1_tpu_torch.hashx.native_build import NativeBuildError
    from p1_tpu_torch.miner import Miner

    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    on_card = device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("bench measures the card and there is none; pass --device cpu")
    if not on_card:
        keys.set_sig_backend("device", device="cpu")  # batches on the plain version
    prefix = make_genesis(20).header.mining_prefix()

    cpu_hps = _throughput(get_backend("cpu"), prefix, CPU_BASELINE_COUNT)
    backend = get_backend("cuda") if on_card else get_backend("torch", device="cpu")
    count = HEADLINE_COUNT[device]
    device_hps = _throughput(backend, prefix, count)

    # A card far below its recorded rate is re-measured after a wait, up
    # to three times; the last measurement is reported either way, with
    # the retry count.  P1_BENCH_HEALTHY_HPS overrides the pin (0 disables).
    healthy_hps = float(os.environ.get("P1_BENCH_HEALTHY_HPS", pr.RECORDED_H100_CUDA_HPS))
    extra: dict = {}
    retries = 0
    while on_card and device_hps < pr.DEGRADED_FRACTION * healthy_hps and retries < 3:
        retries += 1
        time.sleep(60)
        device_hps = _throughput(backend, prefix, count)
    if retries:
        extra["degraded_retries"] = retries
    if on_card:
        extra["torch_hps"] = round(_throughput(get_backend("torch"), prefix, TORCH_COUNT))
    try:
        native = get_backend("native")
    except (NativeBuildError, OSError):  # no C++ toolchain on this host
        native = None
    if native is not None:
        extra["native_hps"] = round(_throughput(native, prefix, NATIVE_COUNT, repeats=1))
        extra["native_shani"] = native.has_shani

    try:
        load_1m, load_5m, _ = os.getloadavg()
    except OSError:
        load_1m = load_5m = None
    peak_rss_bytes = _peak_rss_bytes()
    ttb = _time_to_block(Miner(backend=backend), TTB_DIFFICULTY, TTB_BLOCKS)

    # -- host ingest, staged ingest, telemetry -----------------------------
    chain, raws = host_ingest.build_blocks(300, 2, difficulty=1)
    for blk in chain.main_chain():
        for tx in blk.txs:
            tx.verify_signature()  # warm the memo, as ingest meets it
    ingest_bps = host_ingest.bench_ingest(raws, 1, repeats=3)
    extra["host_ingest_bps"] = round(ingest_bps)
    extra["host_ingest_vs_recorded"] = round(ingest_bps / pr.RECORDED_HOST_INGEST_BPS, 2)
    if ingest_bps < pr.HOST_INGEST_DEGRADED_FRACTION * pr.RECORDED_HOST_INGEST_BPS:
        extra["host_ingest_degraded"] = True
    with tempfile.TemporaryDirectory() as staged_tmp:
        rungs = host_ingest.bench_staged_ingest(raws, 1, [1], repeats=2, tmpdir=staged_tmp)
    staged_bps = rungs[1]
    extra["staged_ingest_bps"] = round(staged_bps)
    extra["staged_ingest_vs_recorded"] = round(staged_bps / pr.RECORDED_STAGED_INGEST_BPS, 2)
    if rungs[0] > 0:
        extra["staged_overhead_pct"] = round((rungs[0] - staged_bps) / rungs[0] * 100.0, 1)
    if staged_bps < pr.STAGED_INGEST_DEGRADED_FRACTION * pr.RECORDED_STAGED_INGEST_BPS:
        extra["staged_ingest_degraded"] = True
    to = telemetry_overhead.bench_quick(blocks=300, repeats=3, device=device)
    extra["ingest_with_telemetry_bps"] = to["ingest_telemetry_bps"]
    extra["ingest_with_telemetry_vs_recorded"] = round(to["ingest_telemetry_bps"] / pr.RECORDED_HOST_INGEST_BPS, 2)
    extra["telemetry_overhead_pct"] = to["overhead_pct"]

    # -- untrusted-store revalidation on the default batch rung -------------
    reval = sig_verify.bench_revalidate(400, repeats=3)
    extra["revalidate_bps"] = reval["revalidate_bps"]
    extra["revalidate_speedup"] = reval["revalidate_speedup"]
    extra["revalidate_vs_recorded"] = round(reval["revalidate_bps"] / pr.RECORDED_REVALIDATE_BPS, 2)
    if reval["revalidate_bps"] < pr.REVALIDATE_DEGRADED_FRACTION * pr.RECORDED_REVALIDATE_BPS:
        extra["revalidate_degraded"] = True
    extra["sig_backend"] = keys.backend()

    # -- ms per signature: the native engine, the card (lower is better) ----
    triples = sig_verify.make_triples(SIG_BATCH)
    if _ed25519_native.available():
        native_ms = 1e3 / sig_verify._rate(lambda: _ed25519_native.verify_batch(triples), SIG_BATCH)
        extra["sig_native_ms"] = round(native_ms, 4)
        extra["sig_native_vs_recorded"] = round(native_ms / pr.RECORDED_SIG_NATIVE_MS, 2)
        if native_ms > pr.SIG_DEGRADED_FACTOR * pr.RECORDED_SIG_NATIVE_MS:
            extra["sig_native_degraded"] = True
    if on_card:
        if not ed25519_msm.verify_batch_device(triples, device="cuda"):  # warm: build and load
            raise AssertionError("a valid 1,024 batch failed on the card")
        device_ms = 1e3 / sig_verify._rate(lambda: ed25519_msm.verify_batch_device(triples, device="cuda"), SIG_BATCH)
        extra["sig_device_ms"] = round(device_ms, 4)
        extra["sig_device_vs_recorded"] = round(device_ms / pr.RECORDED_SIG_DEVICE_MS, 2)
        if device_ms > pr.SIG_DEGRADED_FACTOR * pr.RECORDED_SIG_DEVICE_MS:
            extra["sig_device_degraded"] = True

    # -- query serving plane -------------------------------------------------
    qp = query_plane.bench_quick(repeats=3)
    extra["query_qps"] = qp["proof_cached_qps"]
    extra["query_serial_qps"] = qp["proof_serial_qps"]
    extra["query_batched_qps"] = qp["proof_batched_qps"]
    extra["query_vs_recorded"] = round(qp["proof_cached_qps"] / pr.RECORDED_QUERY_QPS, 2)
    if qp["proof_cached_qps"] < pr.QUERY_DEGRADED_FRACTION * pr.RECORDED_QUERY_QPS:
        extra["query_degraded"] = True

    # -- wallet push plane (lower p95 is better) -------------------------------
    wp = wallet_plane.bench_quick()
    extra["wallet_subs"] = wp["wallet_subs"]
    extra["notify_p95_ms"] = wp["notify_p95_ms"]
    extra["notify_events_per_sec"] = wp["notify_events_per_sec"]
    extra["notify_vs_recorded"] = round(wp["notify_p95_ms"] / pr.RECORDED_NOTIFY_P95_MS, 2)
    if wp["wallet_subs"] < pr.RECORDED_WALLET_SUBS or wp["notify_p95_ms"] > pr.NOTIFY_DEGRADED_FACTOR * pr.RECORDED_NOTIFY_P95_MS:
        extra["notify_degraded"] = True

    # -- fleet provisioning: fleet_missed must be 0 whatever the load -----------
    fp = wallet_plane.bench_fleet_quick(device=device)
    for key in ("fleet_cold_start_s", "fleet_notify_p95_ms", "fleet_failovers", "fleet_missed"):
        extra[key] = fp[key]
    extra["fleet_cold_start_vs_recorded"] = round(fp["fleet_cold_start_s"] / pr.RECORDED_FLEET_COLD_START_S, 2)
    extra["fleet_notify_vs_recorded"] = round(fp["fleet_notify_p95_ms"] / pr.RECORDED_FLEET_NOTIFY_P95_MS, 2)
    if (
        fp["fleet_missed"] > 0
        or fp["fleet_cold_start_s"] > pr.FLEET_DEGRADED_FACTOR * pr.RECORDED_FLEET_COLD_START_S
        or fp["fleet_notify_p95_ms"] > pr.FLEET_DEGRADED_FACTOR * pr.RECORDED_FLEET_NOTIFY_P95_MS
    ):
        extra["fleet_degraded"] = True

    # -- the simulator: full nodes, far field, relay budget ---------------------
    sim = netsim_scale.bench_sim(nodes=100, seed=0, device=device)
    extra["sim_nodes_per_sec"] = sim["sim_nodes_per_sec"]
    extra["sim_events_per_sec"] = sim["events_per_wall_s"]
    extra["sim_ok"] = sim["ok"]
    extra["sim_vs_recorded"] = round(sim["sim_nodes_per_sec"] / pr.RECORDED_SIM_RATE, 2)
    if sim["sim_nodes_per_sec"] < pr.SIM_DEGRADED_FRACTION * pr.RECORDED_SIM_RATE:
        extra["sim_degraded"] = True
    far = netsim_scale.bench_far_field(nodes=2000, shards=2, seed=0, device=device)
    extra["sim_sharded_nodes_per_sec"] = far["sim_sharded_nodes_per_sec"]
    extra["sim_sharded_ok"] = far["ok"]
    extra["sim_sharded_vs_recorded"] = round(far["sim_sharded_nodes_per_sec"] / pr.RECORDED_SIM_SHARDED_RATE, 2)
    if far["sim_sharded_nodes_per_sec"] < pr.SIM_SHARDED_DEGRADED_FRACTION * pr.RECORDED_SIM_SHARDED_RATE:
        extra["sim_sharded_degraded"] = True
    rl = netsim_scale.bench_relay(
        nodes=10, senders=4, txs_per_sender=24, storm_vs=10.0, min_reduction=3.0, device=device
    )
    extra["relay_bytes_per_tx"] = rl["relay_bytes_per_tx"]
    extra["tx_prop_p95_ms"] = rl["tx_prop_p95_ms"]
    extra["relay_reduction"] = rl["reduction"]
    extra["relay_ok"] = rl["ok"]
    extra["relay_bytes_vs_recorded"] = round(rl["relay_bytes_per_tx"] / pr.RECORDED_RELAY_BYTES_PER_TX, 2)
    extra["tx_prop_vs_recorded"] = round(rl["tx_prop_p95_ms"] / pr.RECORDED_TX_PROP_P95_MS, 2)
    if (
        rl["relay_bytes_per_tx"] > pr.RELAY_DEGRADED_FACTOR * pr.RECORDED_RELAY_BYTES_PER_TX
        or rl["tx_prop_p95_ms"] > pr.RELAY_DEGRADED_FACTOR * pr.RECORDED_TX_PROP_P95_MS
    ):
        extra["relay_degraded"] = True

    # -- chaos plane -------------------------------------------------------------
    ch = chaos_rate.bench_chaos(schedules=5, device=device)
    extra["chaos_schedules_per_sec"] = ch["chaos_schedules_per_sec"]
    extra["chaos_virtual_per_wall"] = ch["virtual_per_wall"]
    extra["chaos_ok"] = ch["ok"]
    extra["chaos_vs_recorded"] = round(ch["chaos_schedules_per_sec"] / pr.RECORDED_CHAOS_RATE, 2)
    if ch["chaos_schedules_per_sec"] < pr.CHAOS_DEGRADED_FRACTION * pr.RECORDED_CHAOS_RATE:
        extra["chaos_degraded"] = True

    # -- snapshot boot (lower is better) -------------------------------------------
    sb = snapshot_boot.bench_quick(blocks=800, repeats=3)
    extra["snapshot_boot_s"] = sb["snapshot_boot_s"]
    extra["snapshot_revalidate_s"] = sb["revalidate_boot_s"]
    extra["snapshot_vs_recorded"] = round(sb["snapshot_boot_s"] / pr.RECORDED_SNAPSHOT_BOOT_S, 2)
    if sb["snapshot_boot_s"] > pr.SNAPSHOT_DEGRADED_FACTOR * pr.RECORDED_SNAPSHOT_BOOT_S:
        extra["snapshot_degraded"] = True

    # -- the segmented archive; P1_BENCH_ARCHIVE=1 runs the 10M shape ---------------
    ar = archive_scale.bench_quick(blocks=10_000_000 if os.environ.get("P1_BENCH_ARCHIVE") else 100_000)
    extra["archive_blocks"] = ar["blocks"]
    for key in ("archive_resume_bps", "archive_boot_s", "archive_boot_rss_mb", "archive_query_qps"):
        extra[key] = ar[key]
    extra["archive_resume_vs_recorded"] = round(ar["archive_resume_bps"] / pr.RECORDED_ARCHIVE_RESUME_BPS, 2)
    extra["archive_rss_vs_recorded"] = round(ar["archive_boot_rss_mb"] / pr.RECORDED_ARCHIVE_BOOT_RSS_MB, 2)
    if (
        ar["archive_resume_bps"] < pr.ARCHIVE_RESUME_DEGRADED_FRACTION * pr.RECORDED_ARCHIVE_RESUME_BPS
        or ar["archive_boot_rss_mb"] > pr.ARCHIVE_BOOT_RSS_DEGRADED_FACTOR * pr.RECORDED_ARCHIVE_BOOT_RSS_MB
    ):
        extra["archive_degraded"] = True

    # -- maintenance cadence (the rebase figure: lower is better) ----------------------
    mc = maintenance_cadence.bench_quick()
    extra["snapshot_incr_builds_per_sec"] = mc["snapshot_incr_builds_per_sec"]
    extra["snapshot_cadence_speedup"] = mc["snapshot_cadence_speedup"]
    extra["rebase_ms"] = mc["rebase_ms"]
    extra["snapshot_cadence_vs_recorded"] = round(mc["snapshot_incr_builds_per_sec"] / pr.RECORDED_SNAPSHOT_CADENCE_BPS, 2)
    extra["rebase_vs_recorded"] = round(mc["rebase_ms"] / pr.RECORDED_REBASE_MS, 2)
    if (
        mc["snapshot_incr_builds_per_sec"] < pr.SNAPSHOT_CADENCE_DEGRADED_FRACTION * pr.RECORDED_SNAPSHOT_CADENCE_BPS
        or mc["rebase_ms"] > pr.REBASE_DEGRADED_FACTOR * pr.RECORDED_REBASE_MS
    ):
        extra["maintenance_degraded"] = True

    # -- the static analyzer: unsettled findings must be 0 --------------------------------
    from p1_tpu_torch.analysis import run_analysis

    t0 = time.perf_counter()
    lint = run_analysis()
    extra["lint_wall_s"] = round(time.perf_counter() - t0, 3)
    extra["lint_findings"] = len(lint.violations) + len(lint.stale) + len(lint.parse_errors)
    extra["lint_granted"] = len(lint.granted)
    extra["lint_rules"] = len(lint.rules)
    extra["lint_callgraph_nodes"] = lint.callgraph_nodes
    extra["lint_callgraph_edges"] = lint.callgraph_edges

    return {
        "metric": "sha256d_hashes_per_sec_per_chip",
        "value": round(device_hps),
        "unit": "H/s",
        # vs_baseline: the same-run hashlib rate, which moves with host
        # load; vs_recorded: the pinned healthy hashlib rate.
        "vs_baseline": round(device_hps / cpu_hps, 1),
        "vs_recorded": round(device_hps / pr.RECORDED_CPU_BASELINE_HPS, 1),
        "recorded_cpu_baseline_hps": round(pr.RECORDED_CPU_BASELINE_HPS),
        "platform": device,
        "backend": backend.name,
        "cpu_baseline_hps": round(cpu_hps),
        "load_avg_1m": load_1m,
        "load_avg_5m": load_5m,
        "cpu_count": os.cpu_count(),
        "peak_rss_bytes": peak_rss_bytes,
        "time_to_block_d20_s": round(ttb, 3),
        "batch": backend.batch,
        **extra,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="p1_tpu_torch bench", description=__doc__.splitlines()[0])
    ap.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="cuda (default): the kernels on the card; cpu: their plain PyTorch versions",
    )
    args = ap.parse_args(argv)
    line = measure(args.device)
    from p1_tpu_torch.node.runner import kernel_launches

    print(json.dumps(line), flush=True)
    print(f"kernel launches: {json.dumps(kernel_launches())}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
