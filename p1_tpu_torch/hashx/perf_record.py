"""Recorded healthy performance figures of the port — ONE home for the pins.

The port's counterpart of ``p1_tpu/hashx/perf_record.py``, constant for
constant but one rename: ``RECORDED_V5E_PALLAS_HPS`` is
``RECORDED_H100_CUDA_HPS``.  ``bench``'s degradation guard and every
``*_vs_recorded`` ratio it prints read these; update HERE when a kernel,
a plane or the machine moves the measurement.

Every ``RECORDED_*`` figure was measured by ``python -m p1_tpu_torch
bench`` (or, where named, ``python -m p1_tpu_torch.benchmarks.sig_verify
--fallback``) at ``bench``'s own shapes, on one NVIDIA H100 80GB HBM3 at a
700.00 W power limit, or on the card's host (8 cores, the machine that
card sits in): the comment of each says which.  None is a TPU's or
another host's.  The tolerance constants (``*_DEGRADED_FRACTION`` < 1 for
rates, ``*_DEGRADED_FACTOR`` > 1 for latencies) are the JAX package's
policy, kept at its values.

These are records of past measurements, not targets: ``bench`` always
reports what it measured.
"""

#: ``cuda`` backend (``hashx/csrc/sha256d_search.cu``, batch 2**26) over
#: ``bench``'s 2**29 nonces, best of 3: NVIDIA H100 80GB HBM3, 700.00 W.
RECORDED_H100_CUDA_HPS = 6_616_128_961.0

#: hashlib ``cpu`` backend, best of 3 over 2**21 nonces at difficulty 20:
#: the card's host (NVIDIA H100 80GB HBM3, 700.00 W).  ``bench``'s
#: ``vs_recorded`` divides the headline by it; the live
#: ``cpu_baseline_hps`` moves with the host's load.
RECORDED_CPU_BASELINE_HPS = 718_498.0

#: Fraction of the recorded rate below which a card measurement is
#: re-measured after a wait (``bench``'s guard).
DEGRADED_FRACTION = 0.3

#: Host ingest (``benchmarks/host_ingest.py`` ``bench_ingest``, 300
#: blocks x 2 signed transfers, difficulty 1, signature memo warm),
#: blocks/s: the card's host (NVIDIA H100 80GB HBM3, 700.00 W).
RECORDED_HOST_INGEST_BPS = 11_775.0

#: Same-session fraction below which ``bench`` flags host ingest.
HOST_INGEST_DEGRADED_FRACTION = 0.5

#: Staged ingest (``bench_staged_ingest``, the 1-worker rung, the same 300
#: blocks, cold signature cache, fsynced appends), blocks/s: the card's
#: host (NVIDIA H100 80GB HBM3, 700.00 W).
RECORDED_STAGED_INGEST_BPS = 886.0

#: Same-session fraction below which staged ingest is flagged.
STAGED_INGEST_DEGRADED_FRACTION = 0.4

#: Untrusted revalidation (``sig_verify.bench_revalidate(400)``: 400
#: blocks x 2 transfers, difficulty 1) on the default ``device`` rung,
#: blocks/s: ``ed25519_msm.cu`` on an NVIDIA H100 80GB HBM3, 700.00 W, and
#: the chain work on the card's host.
RECORDED_REVALIDATE_BPS = 5_020.6
#: The same load with batches forced onto the pure-Python rung
#: (``sig_verify --fallback``), blocks/s: the card's host (NVIDIA H100
#: 80GB HBM3, 700.00 W); for a host whose card rung is pinned off.
RECORDED_REVALIDATE_FALLBACK_BPS = 232.1

#: Same-session fraction below which revalidation is flagged.
REVALIDATE_DEGRADED_FRACTION = 0.5

#: Native C++ Ed25519 engine (``native/ed25519.cpp``): ms per signature
#: of one 1,024 ``verify_batch``, best of 3: the card's host (NVIDIA H100
#: 80GB HBM3, 700.00 W).  ``core/keys.py``'s forced-fallback warning names it.
RECORDED_SIG_NATIVE_MS = 0.1088

#: ``verify_batch_device`` at 1,024 signatures (``ed25519_msm.cu``, host
#: prep and close included), ms per signature, best of 3: NVIDIA H100
#: 80GB HBM3, 700.00 W.
RECORDED_SIG_DEVICE_MS = 0.0101

#: Factor over the per-signature pins above which a figure is flagged
#: (lower is better for both).
SIG_DEGRADED_FACTOR = 2.0

#: Cached proofs/s (``query_plane.bench_quick``: 60 blocks x 24 signed
#: transfers): the card's host (NVIDIA H100 80GB HBM3, 700.00 W).
RECORDED_QUERY_QPS = 1_118_155.0

#: Same-session fraction below which the query plane is flagged.
QUERY_DEGRADED_FRACTION = 0.5

#: Simulator node-seconds per wall second (``netsim_scale.bench_sim``,
#: 100-node partition-heal, blocks sealed by ``sha256d_search.cu``): the
#: card's host, sealing on the NVIDIA H100 80GB HBM3, 700.00 W.
RECORDED_SIM_RATE = 1_315.8

#: Same-session fraction below which the simulator is flagged.
SIM_DEGRADED_FRACTION = 0.4

#: Far-field node-seconds per wall second (``bench_far_field``, 2,000
#: nodes at 2 process shards; header-only node-seconds): the card's host,
#: sealing on the NVIDIA H100 80GB HBM3, 700.00 W.
RECORDED_SIM_SHARDED_RATE = 25_116.8

#: Same-session fraction below which the far field is flagged.
SIM_SHARDED_DEGRADED_FRACTION = 0.4

#: Chaos schedules per wall second (``chaos_rate.bench_chaos``, 5
#: schedules of 5 nodes and 10 events): the card's host, sealing on the
#: NVIDIA H100 80GB HBM3, 700.00 W.
RECORDED_CHAOS_RATE = 4.03

#: Same-session fraction below which the chaos plane is flagged.
CHAOS_DEGRADED_FRACTION = 0.4

#: Seconds from a cold snapshot file to serving queries
#: (``snapshot_boot.bench_quick``, 800 blocks): the card's host (NVIDIA
#: H100 80GB HBM3, 700.00 W).  Lower is better.
RECORDED_SNAPSHOT_BOOT_S = 0.004199

#: Factor over the boot pin above which the figure is flagged.
SNAPSHOT_DEGRADED_FACTOR = 5.0

#: The 100k-block synthetic segmented archive (``archive_scale.bench_quick``):
#: whole-archive packed-header records/s, and the boot process's peak
#: resident set in MB (sampled by ``benchmarks/rss.py``: that host's
#: ``/proc`` keeps no VmHWM), both the card's host's (NVIDIA H100 80GB
#: HBM3, 700.00 W).
RECORDED_ARCHIVE_RESUME_BPS = 524_672
RECORDED_ARCHIVE_BOOT_RSS_MB = 232.8

#: Degraded thresholds: resume is CPU-bound; RSS is an allocator property.
ARCHIVE_RESUME_DEGRADED_FRACTION = 0.4
ARCHIVE_BOOT_RSS_DEGRADED_FACTOR = 2.0

#: Incremental snapshot rebuilds/s and the in-RAM rebase in ms
#: (``maintenance_cadence.bench_quick``: 20k accounts, 64 dirty a build,
#: a 96-block chain): the card's host (NVIDIA H100 80GB HBM3, 700.00 W).
RECORDED_SNAPSHOT_CADENCE_BPS = 460.6
RECORDED_REBASE_MS = 0.086

#: Degraded thresholds: the cadence is hash-bound; the rebase is
#: sub-100 µs, so only a 10x move says its cost model changed.
SNAPSHOT_CADENCE_DEGRADED_FRACTION = 0.4
REBASE_DEGRADED_FACTOR = 10.0

#: Wallet push plane (``wallet_plane.bench_quick``): the live
#: subscriptions held (20k) and the p95 per-block notify in ms: the
#: card's host (NVIDIA H100 80GB HBM3, 700.00 W).  Lower p95 is better.
RECORDED_WALLET_SUBS = 20_000
RECORDED_NOTIFY_P95_MS = 179.48

#: Factor over the notify pin above which the figure is flagged.
NOTIFY_DEGRADED_FACTOR = 3.0

#: Fleet provisioning (``wallet_plane.bench_fleet_quick``: 3 replicas x 24
#: sessions, the most-loaded replica killed mid-push, one snapshot cold
#: start): cold-start seconds and the per-event notify p95 in ms: the
#: card's host (NVIDIA H100 80GB HBM3, 700.00 W).  Lower is better;
#: ``fleet_missed`` must be 0 whatever the figures.
RECORDED_FLEET_COLD_START_S = 0.015
RECORDED_FLEET_NOTIFY_P95_MS = 24.13

#: Factor over the fleet pins above which the figures are flagged.
FLEET_DEGRADED_FACTOR = 5.0

#: Relay budget (``netsim_scale.bench_relay``: 10 nodes, 64 kbps uplinks,
#: 4 senders x 24 transfers over 10 virtual s, reconciliation arm): tx-plane
#: bytes per delivered transfer and the submit-to-everywhere p95 in virtual
#: ms, deterministic functions of the seed: the card's host, sealing on the
#: NVIDIA H100 80GB HBM3, 700.00 W.  Lower is better.
RECORDED_RELAY_BYTES_PER_TX = 2_608.8
RECORDED_TX_PROP_P95_MS = 1_907.8

#: Factor over the relay pins above which the figures are flagged: the
#: probe is deterministic, so past 1.5x the protocol changed.
RELAY_DEGRADED_FACTOR = 1.5
