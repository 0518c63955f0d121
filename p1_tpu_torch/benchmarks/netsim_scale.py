"""Simulator scale benchmark of the port: nodes x virtual-seconds per wall-second.

    python -m p1_tpu_torch.benchmarks.netsim_scale [--nodes 200] [--seed 0]
        [--table | --far | --relay] [--device cpu]

The port of ``benchmarks/netsim_scale.py``: how much mesh one host can
simulate, and how fast.  The metric is ``sim_nodes_per_sec`` = nodes x
virtual_seconds / wall_seconds — node-seconds of simulated network per
second of real time — on the partition-heal scenario (mesh formation,
gossip, a 60/40 cut, divergent mining, mass reorg on heal); the
far-field run (``--far``) and the relay-budget A/B (``--relay``) beside
it.  Each simulated mesh seals its blocks through the port's ``cuda``
backend on ``device``: ``hashx/csrc/sha256d_search.cu`` on the card, its
plain PyTorch version under ``--device cpu``; the digests are the same.
``bench`` reads ``bench_sim``, ``bench_far_field`` and ``bench_relay``
against the pins of ``p1_tpu_torch/hashx/perf_record.py``.
"""

from __future__ import annotations

import argparse
import json

def bench_sim(nodes: int = 200, seed: int = 0, device: str = "cuda") -> dict:
    """One partition-heal run; returns the rate figures + the report."""
    from p1_tpu_torch.node.scenarios import partition_heal

    report = partition_heal(nodes=nodes, seed=seed, device=device)
    rate = nodes * report["virtual_s"] / max(report["wall_s"], 1e-9)
    return {
        "nodes": nodes,
        "ok": report["ok"],
        "virtual_s": report["virtual_s"],
        "wall_s": report["wall_s"],
        "events": report["events"],
        "events_per_wall_s": round(report["events"] / max(report["wall_s"], 1e-9)),
        "trace_digest": report["trace_digest"],
        "sim_nodes_per_sec": round(rate, 1),
    }


def bench_far_field(
    nodes: int = 10_000, shards: int = 1, seed: int = 0, device: str = "cuda"
) -> dict:
    """One far-field scenario run (full-node core + header-only far
    field, node/farfield.py) at ``shards`` — the per-shard
    scaling row.  Rate metric: node-seconds of simulated mesh per wall
    second over the whole composed run, same definition as
    ``bench_sim`` so the two tables read against each other.  Honesty:
    far-field node-seconds are HEADER-ONLY node-seconds (no mempool,
    ledger, stores, supervision), and on a one-core host process shards
    ADD overhead; the sharding is for multi-core hosts."""
    from p1_tpu_torch.node.scenarios import far_field

    report = far_field(nodes=nodes, seed=seed, shards=shards, device=device)
    rate = nodes * report["virtual_s"] / max(report["wall_s"], 1e-9)
    return {
        "nodes": nodes,
        "shards": shards,
        "shard_processes": report["shard_processes"],
        "ok": report["ok"],
        "virtual_s": report["virtual_s"],
        "wall_s": report["wall_s"],
        "far_deliveries": report["far_deliveries"],
        "far_barrier_rounds": report["far_barrier_rounds"],
        "trace_digest": report["trace_digest"],
        "sim_sharded_nodes_per_sec": round(rate, 1),
    }


def bench_relay(nodes: int = 16, seed: int = 0, device: str = "cuda", **kw) -> dict:
    """One relay-budget A/B run (flood arm vs reconciliation arm over
    the same shaped mesh — node/scenarios.py ``relay_budget``).  The
    two figures ``bench`` pins: ``relay_bytes_per_tx`` (recon arm,
    tx-plane bytes per delivered tx-node pair) and ``tx_prop_p95_ms``
    (recon arm, submit-to-everywhere p95).  ``reduction`` is the
    flood/recon byte ratio (the ≥5x budget), judged by the
    scenario's own ``ok`` so the benchmark can't pass a run the
    acceptance gate would fail.  Extra kwargs pass through to the
    scenario: ``bench``'s quick probe shrinks the mesh and storm (and
    relaxes ``min_reduction`` to a 3x guard band — reduction grows
    with mesh size, and the quick mesh is smaller than the 16-node
    acceptance run this function defaults to)."""
    from p1_tpu_torch.node.scenarios import relay_budget

    report = relay_budget(nodes=nodes, seed=seed, device=device, **kw)
    return {
        "nodes": nodes,
        "ok": report["ok"],
        "wall_s": report["wall_s"],
        "total_txs": report["total_txs"],
        "flood_bytes_per_tx": report["flood"]["bytes_per_tx"],
        "flood_p95_ms": report["flood"]["propagation"]["p95_ms"],
        "relay_bytes_per_tx": report["recon"]["bytes_per_tx"],
        "tx_prop_p95_ms": report["recon"]["propagation"]["p95_ms"],
        "reduction": report["reduction"],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--nodes", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--table",
        action="store_true",
        help="run the scale ladder (50/200/1000) instead of one size",
    )
    parser.add_argument(
        "--far",
        action="store_true",
        help="run the 10k-node far-field per-shard ladder (1/2/4 "
        "shards; >1 = one OS process per shard); digests must agree "
        "across the ladder",
    )
    parser.add_argument(
        "--relay",
        action="store_true",
        help="run the 16-node relay-budget A/B (flood vs "
        "reconciliation over shaped uplinks), the source of bench's "
        "relay_bytes_per_tx / tx_prop_p95_ms",
    )
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args()
    if args.relay:
        print(json.dumps(bench_relay(seed=args.seed, device=args.device)))
    elif args.far:
        digests = set()
        for shards in (1, 2, 4):
            row = bench_far_field(shards=shards, seed=args.seed, device=args.device)
            digests.add(row["trace_digest"])
            print(json.dumps(row))
        assert len(digests) == 1, "shard split moved the merged digest!"
    elif args.table:
        for n in (50, 200, 1000):
            print(json.dumps(bench_sim(n, args.seed, args.device)))
    else:
        print(json.dumps(bench_sim(args.nodes, args.seed, args.device)))


if __name__ == "__main__":
    main()
