"""``p1_tpu_torch/benchmarks/wallet_plane.py`` against the reference's.

The push plane's notify probe, the fleet's kill-one-replica run and the
snapshot cold start at toy shapes: the reference's keys, and its values
for what the shape decides (sessions held, events delivered, missed
confirmations, failovers, the cold start's base and tip).  The real-socket
push runs a port node mining through the ``cuda`` backend's plain version.
"""

from benchmarks import wallet_plane as ref
from p1_tpu_torch.benchmarks import wallet_plane as port
from p1_tpu_torch.core import keys

SUBS = {"subs": 300, "warm_blocks": 1, "measure_blocks": 2, "txs": 2}


def test_notify_probe_is_the_references():
    got, want = port.bench_subs(**SUBS), ref.bench_subs(**SUBS)
    assert set(got) == set(want)
    for key in ("wallet_subs", "events_delivered", "measure_blocks"):
        assert got[key] == want[key]
    assert got["notify_p95_ms"] > 0 and got["notify_events_per_sec"] > 0


def test_fleet_misses_nothing_and_fails_over_as_the_reference():
    try:
        got = port.bench_fleet_quick(sessions=6, device="cpu")
    finally:
        keys.set_sig_backend(None)
    want = ref.bench_fleet_quick(sessions=6)
    assert set(got) == set(want)
    for key in ("fleet_missed", "fleet_failovers", "fleet_replicas", "fleet_sessions",
                "fleet_cold_start_base", "fleet_cold_start_tip", "fleet_cold_start_blocks_fetched"):  # fmt: skip
        assert got[key] == want[key], key
    assert got["fleet_missed"] == 0 and got["fleet_cold_start_s"] > 0


def test_push_end_to_end_on_the_plain_version():
    try:
        out = port.bench_push_e2e(difficulty=8, device="cpu", timeout=60)
    finally:
        keys.set_sig_backend(None)
    assert out["push_e2e_ms"] > 0
