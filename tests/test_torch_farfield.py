"""The port's far field (``node/farfield.py``) against the JAX package's.

Mirrors tests/test_farfield.py: the reference's cases, run against
``p1_tpu_torch``; the core mesh runs with ``device="cpu"``.

The sharded far-field plane (p1_tpu/node/farfield.py).

Pins the acceptance contract at the substrate level: the
world is a pure function of the seed (topology, latencies), event time
is integer microseconds, and the merged trace digest is byte-identical
at 1 shard and at N shards — with the shards in one process or spread
across OS processes over the pipe seam.  The scenario-level half (the
composed core+far-field run, its convergence SLO, and the 10k-node
acceptance run) lives in tests/test_scenarios.py; the cross-process
CLI pair lives in tests/test_cli.py.
"""

import pytest

from p1_tpu_torch.node.farfield import (
    LAT_MAX_US,
    LAT_MIN_US,
    FarShard,
    link_latency_us,
    run_far_field,
    shard_bounds,
    topology,
)

pytestmark = pytest.mark.sim


def linear_feed(blocks: int, spacing_s: float = 2.0, tag: str = "b"):
    feed = []
    parent = ""
    for h in range(1, blocks + 1):
        bid = f"{tag}{h:03d}"
        feed.append((spacing_s * h, h, bid, parent))
        parent = bid
    return feed


class TestPureWorld:
    def test_latency_is_deterministic_and_banded(self):
        for src, dst in ((0, 1), (7, 3), (-1, 500), (9999, 0)):
            a = link_latency_us(5, src, dst)
            assert a == link_latency_us(5, src, dst)
            assert LAT_MIN_US <= a < LAT_MAX_US
        # Directional and seed-sensitive: the draw really keys on all
        # of (seed, src, dst).
        assert link_latency_us(5, 0, 1) != link_latency_us(5, 1, 0)
        assert link_latency_us(5, 0, 1) != link_latency_us(6, 0, 1)

    def test_topology_is_symmetric_connected_and_pure(self):
        adj = topology(3, 200, degree=4)
        assert adj == topology(3, 200, degree=4)
        for i, nbrs in enumerate(adj):
            for j in nbrs:
                assert i in adj[j]
        # The i-1 backbone guarantees connectivity.
        for i in range(1, 200):
            assert (i - 1) in adj[i]

    def test_shard_bounds_partition_exactly(self):
        for n, shards in ((10, 1), (10, 3), (10_000, 7), (5, 5)):
            bounds = shard_bounds(n, shards)
            assert bounds[0][0] == 0 and bounds[-1][1] == n
            for (alo, ahi), (blo, _bhi) in zip(bounds, bounds[1:]):
                assert ahi == blo and ahi > alo


class TestShardSemantics:
    def test_orphan_headers_park_until_their_parent_connects(self):
        # One node, headers delivered child-first: the orphan buffer
        # must hold the child and accept it when the parent lands.
        shard = FarShard(seed=0, n=2, lo=0, hi=2, degree=1)
        feed = {"a": (1, ""), "b": (2, "a")}
        shard.push((10_000, 0, -1, 2, "b"))
        shard.push((20_000, 0, -1, 1, "a"))
        shard.process(1_000_000, feed)
        assert shard.tips[0] == (2, "b")
        assert not shard.orphans

    def test_first_seen_wins_height_ties(self):
        shard = FarShard(seed=0, n=2, lo=0, hi=2, degree=1)
        feed = {"a": (1, ""), "a2": (1, "")}
        shard.push((10_000, 0, -1, 1, "a"))
        shard.push((20_000, 0, -1, 1, "a2"))
        shard.process(1_000_000, feed)
        assert shard.tips[0] == (1, "a")


class TestDigestInvariance:
    """THE acceptance pair: same seed ⇒ byte-identical merged digest,
    run to run AND across the 1→N shard split."""

    def test_same_seed_same_run(self):
        import dataclasses

        feed = linear_feed(5)
        a = run_far_field(300, seed=7, feed=feed)
        b = run_far_field(300, seed=7, feed=feed)
        # wall_s is the one legitimately nondeterministic field.
        assert dataclasses.replace(a, wall_s=0) == dataclasses.replace(
            b, wall_s=0
        )
        assert a.converged and a.trace_digest == b.trace_digest

    def test_shard_split_does_not_move_the_digest(self):
        feed = linear_feed(5)
        one = run_far_field(300, seed=7, feed=feed, shards=1)
        three = run_far_field(
            300, seed=7, feed=feed, shards=3, processes=False
        )
        assert one.trace_digest == three.trace_digest
        assert one.deliveries == three.deliveries
        assert one.converged and three.converged

    def test_cross_process_shards_match_in_process(self):
        feed = linear_feed(4)
        one = run_far_field(300, seed=9, feed=feed, shards=1)
        procs = run_far_field(
            300, seed=9, feed=feed, shards=2, processes=True
        )
        assert procs.processes  # really ran one OS process per shard
        assert one.trace_digest == procs.trace_digest

    def test_different_seed_different_digest(self):
        feed = linear_feed(4)
        a = run_far_field(300, seed=1, feed=feed)
        b = run_far_field(300, seed=2, feed=feed)
        assert a.trace_digest != b.trace_digest


class TestConvergence:
    def test_all_nodes_reach_the_final_tip(self):
        feed = linear_feed(6)
        r = run_far_field(800, seed=3, feed=feed, shards=2, processes=False)
        assert r.converged and r.converged_nodes == 800
        assert r.final_tip == (6, "b006")
        # Propagation figures are real: bounded below by one hop,
        # above by the settle time.
        assert r.propagation_p50_ms >= LAT_MIN_US / 1e3
        assert r.propagation_p95_ms <= r.settle_ms
