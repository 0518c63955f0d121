"""The port's telemetry plane (``node/telemetry.py``) against the JAX package's.

Mirrors the non-simulator cases of tests/test_telemetry.py (``TestHistogram``,
``TestRegistry``, ``TestNodeMetricsCompat``, ``TestLogAttribution``,
``TestMetricsWire``), run against ``p1_tpu_torch``: nodes with ``backend="cpu", device="cpu"``
(``tests/torch_testutil.py``: hashlib mining, the ``device`` signature
rung's plain version), transfers signed by the JAX package's keys and
carried into the port by their bytes.
A port node's ``status()`` has exactly the reference's pinned key set
(``STATUS_KEYS``, imported from tests/test_telemetry.py).

Telemetry plane.

Four contracts under test:

- **Histogram math**: the fixed-bucket percentile estimate is pinned
  against a sorted-list oracle by property — for every sample set and
  every requested percentile, oracle <= estimate <= oracle * √2 (one
  geometric bucket), with the absolute floor of the first bound.
- **NodeMetrics compatibility**: the registry migration preserves the
  attribute API (``metrics.blocks_mined += 1``) and every ``status()``
  key BYTE-FOR-BYTE (the pinned list is the dashboard contract —
  extending it is fine, renaming or dropping is a breaking change this
  test exists to catch).
- **Observers, not participants**: the 200-node partition-heal scenario
  produces the SAME trace digest with telemetry enabled and disabled —
  twice in-process, and across processes under PYTHONHASHSEED (the
  `p1 sim --no-telemetry` flag is exactly this experiment).
- **Export surfaces**: GETMETRICS/METRICS codec, the node serving its
  registry over a simulated wire with the stage spans populated, the
  replica answering GETMETRICS, and the Prometheus/table renderers.

``TestMetricsWire.test_node_serves_metrics_over_the_sim_wire``,
``TestDeterminismPair`` and ``TestScenarioTelemetrySections`` run the
port's ``SimNet``, scenarios and chaos plane with ``device="cpu"``;
``TestMetricsWire.test_replica_answers_getmetrics`` the port's query
plane.
"""

from __future__ import annotations

import json
import logging
import math
import os
import pathlib
import random
import subprocess
import sys

import pytest

from test_telemetry import STATUS_KEYS

from p1_tpu_torch.node import protocol, telemetry
from p1_tpu_torch.node.protocol import MsgType
from p1_tpu_torch.node.telemetry import (
    LATENCY_BUCKETS,
    Histogram,
    MetricsRegistry,
    format_prometheus,
    format_table,
    merge_histograms,
)

_BUCKET_FACTOR = math.sqrt(2.0)

REPO = pathlib.Path(__file__).resolve().parent.parent


class TestHistogram:
    def test_empty(self):
        h = Histogram("t")
        assert h.percentile(50) is None
        s = h.summary()
        assert s["count"] == 0 and s["p95"] is None

    def test_percentile_property_vs_sorted_oracle(self):
        """For every distribution tried: the bucket estimate is an
        UPPER bound on the true percentile sample, and never more than
        one geometric bucket (√2) above it — with the absolute floor of
        the first bound for sub-microsecond samples."""
        rng = random.Random(0x7E1E)
        for _trial in range(60):
            n = rng.randrange(1, 300)
            kind = rng.randrange(3)
            if kind == 0:
                samples = [rng.uniform(0.0, 2.0) for _ in range(n)]
            elif kind == 1:
                samples = [rng.lognormvariate(-7, 3) for _ in range(n)]
            else:  # spiky mixture incl. exact zeros
                samples = [
                    rng.choice([0.0, 1e-7, 1e-3, 0.25, 30.0])
                    * rng.uniform(0.5, 1.5)
                    for _ in range(n)
                ]
            h = Histogram("t")
            for s in samples:
                h.observe(s)
            ordered = sorted(max(0.0, s) for s in samples)
            for p in (50, 95, 99):
                oracle = ordered[max(0, math.ceil(p / 100 * n) - 1)]
                est = h.percentile(p)
                assert est >= oracle - 1e-12, (p, oracle, est)
                bound = max(oracle * _BUCKET_FACTOR, LATENCY_BUCKETS[0])
                assert est <= bound + 1e-12, (p, oracle, est)

    def test_negative_observations_clamp_to_zero(self):
        h = Histogram("t")
        h.observe(-5.0)
        assert h.vmin == 0.0 and h.count == 1 and h.percentile(99) == 0.0

    def test_merge_matches_single_stream(self):
        rng = random.Random(99)
        a, b, one = Histogram("t"), Histogram("t"), Histogram("t")
        for i in range(500):
            v = rng.lognormvariate(-6, 2)
            (a if i % 2 else b).observe(v)
            one.observe(v)
        merged = merge_histograms([a, b])
        assert merged.counts == one.counts
        assert merged.count == one.count
        assert merged.vmin == one.vmin and merged.vmax == one.vmax
        for p in (50, 95, 99):
            assert merged.percentile(p) == one.percentile(p)
        assert merge_histograms([]) is None

    def test_recent_window_is_bounded(self):
        h = Histogram("t")
        for i in range(10_000):
            h.observe(i * 1e-6)
        assert len(h.recent) == telemetry.RECENT_WINDOW
        assert h.count == 10_000  # the buckets never forget

    def test_snapshot_buckets_are_sparse_and_cumulative(self):
        h = Histogram("t")
        for v in (1e-5, 1e-5, 0.5, 1e9):  # 1e9 = overflow bucket
            h.observe(v)
        snap = h.snapshot()
        assert snap["buckets"][-1] == ["+Inf", 4]
        cums = [c for _le, c in snap["buckets"]]
        assert cums == sorted(cums)  # cumulative, ascending
        assert len(snap["buckets"]) <= 4  # sparse: only touched les


class TestRegistry:
    def test_get_or_create_is_idempotent(self):
        reg = MetricsRegistry()
        assert reg.counter("a") is reg.counter("a")
        assert reg.histogram("h") is reg.histogram("h")
        assert reg.gauge("g") is reg.gauge("g")

    def test_span_records_clock_delta(self):
        t = [100.0]
        reg = MetricsRegistry(clock=lambda: t[0])
        with reg.span("x_s"):
            t[0] += 2.5
        h = reg.histograms["x_s"]
        assert h.count == 1 and h.vmax == 2.5

    def test_disabled_registry_reads_no_clock_and_records_nothing(self):
        """The determinism pair's mechanism: disabling removes every
        telemetry clock read, and counters stay live regardless."""
        reads = [0]

        def clock():
            reads[0] += 1
            return 0.0

        reg = MetricsRegistry(clock=clock, enabled=False)
        with reg.span("x_s"):
            pass
        reg.observe("y_s", 1.0)
        assert reads[0] == 0
        assert not reg.histograms
        reg.counter("c").inc()
        assert reg.counters["c"].value == 1

    def test_renderers_run_on_the_snapshot(self):
        reg = MetricsRegistry(clock=lambda: 0.0)
        reg.counter("blocks_accepted").inc(3)
        reg.gauge("mine_elapsed_s").set(1.5)
        reg.observe("stage.validate_s", 0.004)
        snap = reg.snapshot()
        table = format_table(snap)
        assert "blocks_accepted" in table and "stage.validate_s" in table
        prom = format_prometheus(snap)
        assert "p1_blocks_accepted 3" in prom
        assert "# TYPE p1_stage_validate_seconds histogram" in prom
        assert "p1_stage_validate_seconds_count 1" in prom
        assert 'le="+Inf"' in prom
        # The whole snapshot (the METRICS wire payload) is JSON-safe.
        json.dumps(snap)




def _fresh_node(**cfg):
    from torch_testutil import NodeConfig
    from p1_tpu_torch.node.node import Node

    cfg.setdefault("difficulty", 8)
    cfg.setdefault("mine", False)
    cfg.setdefault("mempool_ttl_s", 0.0)
    return Node(NodeConfig(**cfg))


class TestNodeMetricsCompat:
    """Satellite 1: the registry migration behind the attribute API."""

    def test_status_keys_pinned_byte_for_byte(self):
        node = _fresh_node()
        status = node.status()

        def keyset(d, prefix=""):
            out = []
            for k, v in d.items():
                out.append(prefix + k)
                if isinstance(v, dict):
                    out.extend(keyset(v, prefix + k + "."))
            return sorted(out)

        assert keyset(status) == STATUS_KEYS
        json.dumps(status)  # the wire STATUS contract: JSON-clean

    def test_attribute_api_survives_the_migration(self):
        from p1_tpu_torch.node.node import NodeMetrics

        m = NodeMetrics()
        m.blocks_mined += 2
        m.bytes_sent += 100
        m.mine_elapsed_s += 0.5
        assert m.blocks_mined == 2 and m.bytes_sent == 100
        assert m.hashes_per_sec == 0.0
        m.hashes_done += 50
        assert m.hashes_per_sec == 100.0
        with pytest.raises(AttributeError):
            m.blocks_minedd += 1  # a typo must not mint a counter
        with pytest.raises(AttributeError):
            _ = m.no_such_counter

    def test_counters_flow_into_the_registry_snapshot(self):
        node = _fresh_node()
        node.metrics.blocks_accepted += 7
        snap = node.telemetry_snapshot()
        assert snap["counters"]["blocks_accepted"] == 7
        assert snap["role"] == "node"
        assert node.status()["blocks_accepted"] == 7  # same storage

    def test_validation_backend_gauges_exported(self):
        # keys.STATS mirrors into registry gauges on
        # the export path, one per backend rung, fixed name set — the
        # GETMETRICS/`p1 metrics`/Prometheus view of the ladder.
        from p1_tpu_torch.core import keys

        node = _fresh_node()
        keys.STATS.reset()
        keys.verify_batch([])  # no work — gauges still materialize
        snap = node.telemetry_snapshot()
        for name in (
            "validation.sigs_serial",
            "validation.sigs_batched",
            "validation.sigs_cached",
            "validation.backend.cryptography",
            "validation.backend.native",
            "validation.backend.pure-python",
            "validation.backend.device",
        ):
            assert name in snap["gauges"], name
        # and the mirror tracks the source of truth
        keys.STATS.backends["native"] += 3
        keys.STATS.batched += 3
        snap = node.telemetry_snapshot()
        assert snap["gauges"]["validation.backend.native"] == 3
        assert snap["gauges"]["validation.sigs_batched"] == 3
        keys.STATS.reset()

    def test_serial_verify_lands_on_the_native_gauge(self):
        # Under auto a serial verify runs on the native rung, and the
        # export shows it there (the pure-Python gauge stays 0).
        from p1_tpu_torch.core import keys
        from txutil import key_for

        node = _fresh_node()
        kp = key_for("telemetry-native")
        keys.set_sig_backend(None)
        keys.STATS.reset()
        try:
            assert keys.verify(kp.pubkey, kp.sign(b"m"), b"m")
            gauges = node.telemetry_snapshot()["gauges"]
            assert gauges["validation.backend.native"] == 1 == gauges["validation.sigs_serial"]
            assert gauges["validation.backend.pure-python"] == 0
        finally:
            keys.STATS.reset()
            keys.set_sig_backend(None)


class TestLogAttribution:
    """Satellite 2: LoggerAdapter carrying node identity."""

    def test_records_carry_host_and_port(self, caplog):
        node = _fresh_node(host="10.7.7.7", port=9555)
        with caplog.at_level(logging.INFO, logger="p1_tpu_torch.node"):
            node.log.info("hello %d", 1)
        assert caplog.records[-1].getMessage() == "[10.7.7.7:9555] hello 1"

    def test_two_nodes_disambiguate(self, caplog):
        a = _fresh_node(host="10.0.0.1", port=1111)
        b = _fresh_node(host="10.0.0.2", port=2222)
        with caplog.at_level(logging.INFO, logger="p1_tpu_torch.node"):
            a.log.info("x")
            b.log.info("x")
        msgs = [r.getMessage() for r in caplog.records[-2:]]
        assert msgs == ["[10.0.0.1:1111] x", "[10.0.0.2:2222] x"]


class TestMetricsWire:
    """GETMETRICS/METRICS (v12): codec, admission class, shed policy,
    and a node serving its registry over a simulated link."""

    def test_codec_round_trip(self):
        mtype, body = protocol.decode(protocol.encode_getmetrics())
        assert mtype is MsgType.GETMETRICS and body is None
        snap = {"role": "node", "counters": {"a": 1}, "histograms": {}}
        mtype, decoded = protocol.decode(protocol.encode_metrics(snap))
        assert mtype is MsgType.METRICS and decoded == snap
        with pytest.raises(protocol.ProtocolError):
            protocol.decode(bytes([MsgType.GETMETRICS]) + b"x")
        with pytest.raises(protocol.ProtocolError):
            protocol.decode(bytes([MsgType.METRICS]) + b"[1]")

    def test_admission_class_and_shed_policy(self):
        from p1_tpu_torch.node.governor import CLASS_QUERIES
        from p1_tpu_torch.node.node import _MSG_CLASS, _SHED_DROPS

        assert _MSG_CLASS[MsgType.GETMETRICS] == CLASS_QUERIES
        assert MsgType.GETMETRICS in _SHED_DROPS
        # GETSTATUS deliberately is NOT shed: the health probe must
        # survive overload even while the latency export does not.
        assert MsgType.GETSTATUS not in _SHED_DROPS

    def test_node_serves_metrics_over_the_sim_wire(self):
        """Two simulated nodes gossip two mined blocks, then a raw sim
        client scrapes GETMETRICS: the stage spans are populated (in
        virtual time), the reply decodes, and the receiver measured
        propagation."""
        from p1_tpu_torch.node.netsim import SimNet

        net = SimNet(seed=5, difficulty=8, device="cpu")

        async def main():
            a = await net.add_node()
            b = await net.add_node(peers=[net.host_name(0)])
            assert await net.run_until(
                lambda: a.peer_count() == 1, 30, wall_limit_s=60
            )
            for _ in range(2):
                await net.mine_on(a, spacing_s=1.0)
            assert await net.run_until(
                lambda: b.chain.height == 2, 60, wall_limit_s=60
            )
            reader, writer = await net.net.host("10.99.0.1").connect(
                net.host_name(0), a.port
            )
            await protocol.write_frame(
                writer,
                protocol.encode_hello(
                    protocol.Hello(a.chain.genesis.block_hash(), 0, 0, 0)
                ),
            )
            await protocol.read_frame(reader)  # node's HELLO
            await protocol.write_frame(writer, protocol.encode_getmetrics())
            while True:
                mtype, body = protocol.decode(
                    await protocol.read_frame(reader)
                )
                if mtype is MsgType.METRICS:
                    break
            writer.close()
            snap_b = b.telemetry.snapshot()
            await net.stop_all()
            return body, snap_b

        snap, snap_b = net.run(main())
        assert snap["role"] == "node" and snap["height"] == 2
        assert snap["counters"]["blocks_mined"] == 2
        hists = snap["histograms"]
        assert hists["stage.validate_s"]["count"] >= 2
        assert hists["stage.relay_s"]["count"] >= 2
        # The receiver's propagation histogram carries VIRTUAL-time
        # delays consistent with the sim's ~ms link latency.
        prop = snap_b["histograms"]["block.propagation_s"]
        assert prop["count"] >= 1
        assert 0.0 < prop["p95"] < 1.0

    def test_replica_answers_getmetrics(self, tmp_path):
        from p1_tpu_torch.benchmarks.host_ingest import build_blocks

        from p1_tpu_torch.chain.store import ChainStore
        from p1_tpu_torch.core.block import Block
        from p1_tpu_torch.node.queryplane import QueryPlaneServer, ReplicaView

        _chain, raws = build_blocks(4, 0, 1)
        store = ChainStore(tmp_path / "r.chain", fsync=False)
        try:
            for raw in raws:
                store.append(Block.deserialize(raw))
        finally:
            store.close()
        view = ReplicaView(tmp_path / "r.chain", 1)
        try:
            server = QueryPlaneServer(view)
            reply = server._answer(MsgType.GETMETRICS, None)
            mtype, snap = protocol.decode(reply)
            assert mtype is MsgType.METRICS
            assert snap["role"] == "replica" and snap["height"] == 4
        finally:
            view.close()


class TestDeterminismPair:
    """Observers, not participants: the 200-node sim trace digest is
    byte-identical with telemetry enabled and disabled."""

    @staticmethod
    def _run(telemetry_on: bool):
        from p1_tpu_torch.node.scenarios import partition_heal

        return partition_heal(
            nodes=200, seed=7, telemetry=telemetry_on, device="cpu"
        )

    def test_enabled_twice_and_disabled_share_one_digest(self):
        a = self._run(True)
        b = self._run(True)
        c = self._run(False)
        assert a["ok"] and b["ok"] and c["ok"]
        assert a["trace_digest"] == b["trace_digest"] == c["trace_digest"]
        # The enabled runs DID record (the pair is not vacuous) and the
        # disabled run did not.
        assert a["telemetry"]["propagation"]["samples"] > 0
        assert c["telemetry"]["propagation"] is None

    def test_cross_process_under_pythonhashseed(self):
        """`p1 sim partition-heal` with and without --no-telemetry in
        separate interpreters: same digest — nothing hash-seed- or
        process-dependent hides in the recording path."""

        def one_run(extra):
            proc = subprocess.run(
                [
                    sys.executable, "-m", "p1_tpu_torch", "sim",
                    "partition-heal", "--nodes", "200", "--seed", "7",
                    "--device", "cpu", *extra,
                ],
                capture_output=True,
                text=True,
                timeout=240,
                cwd=REPO,
                env={**os.environ, "PYTHONHASHSEED": "0"},
            )
            assert proc.returncode == 0, proc.stderr[-2000:]
            return json.loads(proc.stdout.strip().splitlines()[-1])

        on = one_run([])
        off = one_run(["--no-telemetry"])
        assert on["ok"] and off["ok"]
        assert on["trace_digest"] == off["trace_digest"]
        assert on["telemetry"]["propagation"]["samples"] > 0
        assert off["telemetry"]["propagation"] is None


class TestScenarioTelemetrySections:
    """The sim/chaos reports' timeline sections (virtual-time
    propagation histograms) — and the wan scenario's p95 SLO."""

    def test_wan_asserts_a_p95_propagation_bound(self):
        from p1_tpu_torch.node.scenarios import wan

        r = wan(region_nodes=3, blocks=4, seed=1, device="cpu")
        assert r["ok"] and r["propagation_bounded"]
        prop = r["telemetry"]["propagation"]
        assert prop["samples"] > 0
        assert prop["p95_ms"] <= r["propagation_p95_bound_ms"]
        # The bound is load-bearing: an impossible bound fails the run.
        tight = wan(
            region_nodes=3, blocks=4, seed=1,
            propagation_p95_bound_ms=0.001,
            device="cpu",
        )
        assert not tight["ok"] and not tight["propagation_bounded"]

    def test_chaos_report_carries_the_section(self):
        from p1_tpu_torch.node.chaos import run_chaos

        r = run_chaos(seed=3, nodes=4, n_events=4, device="cpu")
        assert r["ok"], r["violations"]
        assert "propagation" in r["telemetry"]
