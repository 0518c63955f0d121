"""``p1_tpu_torch/benchmarks/netsim_scale.py`` against the reference's.

Each simulated mesh seals through the ``cuda`` backend's plain version
here; the virtual-time figures are the JAX package's on the same seed:
a partition-heal's events, virtual seconds and digest, the far field's
deliveries and digest across process shards, and the relay budget's
bytes per transfer, p95, reduction and verdict (at a toy shape; at
``bench``'s shape the port alone, against its pins).
"""

from benchmarks import netsim_scale as ref
from p1_tpu.node.scenarios import partition_heal
from p1_tpu_torch.benchmarks import netsim_scale as port
from p1_tpu_torch.hashx import perf_record

RELAY = {"nodes": 6, "senders": 2, "txs_per_sender": 6, "storm_vs": 4.0, "min_reduction": 3.0}


def test_partition_heal_is_the_references():
    got, want = port.bench_sim(nodes=20, device="cpu"), ref.bench_sim(nodes=20)
    assert set(got) == set(want) | {"trace_digest"}
    for key in ("nodes", "ok", "virtual_s", "events"):
        assert got[key] == want[key], key
    assert got["ok"] and got["trace_digest"] == partition_heal(nodes=20, seed=0)["trace_digest"]
    assert got["sim_nodes_per_sec"] > 0


def test_far_field_across_shards_is_the_references():
    got = port.bench_far_field(nodes=200, shards=2, device="cpu")
    want = ref.bench_far_field(nodes=200, shards=2)
    assert set(got) == set(want)
    for key in ("ok", "shard_processes", "virtual_s", "far_deliveries", "far_barrier_rounds", "trace_digest"):
        assert got[key] == want[key], key
    assert got["ok"] and got["sim_sharded_nodes_per_sec"] > 0


def test_relay_budget_is_the_references():
    got, want = port.bench_relay(device="cpu", **RELAY), ref.bench_relay(**RELAY)
    assert set(got) == set(want)
    for key in ("ok", "total_txs", "flood_bytes_per_tx", "flood_p95_ms", "relay_bytes_per_tx", "tx_prop_p95_ms",
                "reduction"):  # fmt: skip
        assert got[key] == want[key], key


def test_bench_relay_shape_holds_its_budget():
    """``bench``'s quick shape (the reference's tier-1 shape): the budget
    holds, and the virtual-time figures are the pinned ones, which no
    host or card moves."""
    got = port.bench_relay(nodes=10, senders=4, txs_per_sender=24, storm_vs=10.0, min_reduction=3.0, device="cpu")
    assert got["ok"] and got["reduction"] >= 3.0
    assert got["relay_bytes_per_tx"] == perf_record.RECORDED_RELAY_BYTES_PER_TX
    assert got["tx_prop_p95_ms"] == perf_record.RECORDED_TX_PROP_P95_MS
