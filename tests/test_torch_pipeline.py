"""The port's staged pipeline (``node/pipeline.py``) against the JAX package's.

Mirrors tests/test_pipeline.py: the reference's cases, run against
``p1_tpu_torch``.

Staged pipeline: lanes, ordering, crashes.

Four planes of proof:

- **Lane mechanics** — inline (workers=0) calls have no awaits and the
  same results as staged calls; depth/byte accounting zeroes out;
  ``offload=True`` keeps a job off-loop even unstaged (the mempool
  checkpoint's historical ``to_thread`` contract).
- **Supervision** — an injected or real worker death respawns the lane,
  counts it, and retries the job once; a second death propagates.
- **Ordering property** — for randomized multi-peer mining
  interleavings (seeded, sim-clock), the victim's block CONNECT order
  is identical with staging on (1 worker) and off.  Under the virtual
  loop lane jobs complete synchronously (``SimLoop.run_in_executor``),
  so this holds by construction — the test pins the construction.
- **Digest contract** — the 200-node partition/heal scenario's trace
  digest is byte-identical with staging on and off, the same observer
  contract the telemetry determinism pair pins.

``TestStagedNodeInSim`` and ``TestStagingDigestContract`` run the
port's ``SimNet`` and ``partition_heal`` with ``device="cpu"``.
"""

from __future__ import annotations

import asyncio
import random
import threading

import pytest

from p1_tpu_torch.node.netsim import SimNet
from p1_tpu_torch.node.pipeline import (
    LANE_STAGES,
    STAGES,
    NodePipeline,
    WorkerCrash,
)

pytestmark = pytest.mark.staged


class TestLaneMechanics:
    def test_stage_inventory(self):
        assert STAGES == ("frame", "admission", "validate", "store", "relay")
        assert set(LANE_STAGES) <= set(STAGES)

    def test_inline_mode_runs_synchronously_with_no_awaits(self):
        """workers=0: the coroutine must complete without yielding —
        scheduling-identical to the historical inline node."""
        pipe = NodePipeline(workers=0)
        threads = []
        coro = pipe.run_validate(lambda x: threads.append(
            threading.current_thread().name) or x * 2, 21)
        # Drive the coroutine by hand: inline mode must finish on the
        # FIRST send, proving there is no await on the path.
        try:
            coro.send(None)
        except StopIteration as done:
            result = done.value
        else:  # pragma: no cover - the failure shape
            coro.close()
            pytest.fail("inline run_validate yielded (hidden await)")
        assert result == 42
        assert threads == [threading.current_thread().name]
        assert not pipe.staged and pipe.queued_bytes == 0

    def test_staged_mode_runs_on_the_lane_thread(self):
        pipe = NodePipeline(workers=1)
        try:
            names = {
                lane: asyncio.run(
                    getattr(pipe, f"run_{lane}")(
                        lambda: threading.current_thread().name
                    )
                )
                for lane in LANE_STAGES
            }
            assert names["validate"].startswith("p1-validate")
            assert names["store"].startswith("p1-store")
        finally:
            pipe.drain_and_close()
        assert not pipe.status()["validate_alive"]

    def test_offload_leaves_the_loop_even_unstaged(self):
        """The mempool-checkpoint contract: historically threaded via
        asyncio.to_thread, it must not regress ONTO the loop when
        staging is off."""
        pipe = NodePipeline(workers=0)
        name = asyncio.run(
            pipe.run_store(
                lambda: threading.current_thread().name, offload=True
            )
        )
        assert name != threading.current_thread().name

    def test_depth_and_bytes_account_in_flight_only(self):
        pipe = NodePipeline(workers=1)
        seen = {}

        def probe():
            # Sampled from the worker while the job is in flight.
            seen["depth"] = pipe.depths()["store"]
            seen["bytes"] = pipe.queued_bytes

        try:
            asyncio.run(pipe.run_store(probe, nbytes=4096))
        finally:
            pipe.drain_and_close()
        assert seen == {"depth": 1, "bytes": 4096}
        assert pipe.depths() == {"validate": 0, "store": 0}
        assert pipe.queued_bytes == 0

    def test_status_block_shape(self):
        pipe = NodePipeline(workers=2)
        try:
            status = pipe.status()
        finally:
            pipe.drain_and_close()
        assert status == {
            "workers": 2,
            "validate_depth": 0,
            "store_depth": 0,
            "queued_bytes": 0,
            "validate_alive": True,
            "store_alive": True,
        }


class TestSupervision:
    @pytest.mark.parametrize("workers", [0, 1])
    @pytest.mark.parametrize("stage", LANE_STAGES)
    def test_injected_death_respawns_counts_and_retries(
        self, stage, workers
    ):
        """fail_next fires in BOTH modes (the chaos injector relies on
        it under the inline sim) and the job itself must not be lost."""
        respawned = []
        pipe = NodePipeline(workers=workers, on_respawn=respawned.append)
        pipe.fail_next(stage)
        try:
            result = asyncio.run(
                getattr(pipe, f"run_{stage}")(lambda: "survived")
            )
        finally:
            pipe.drain_and_close()
        assert result == "survived"
        assert respawned == [stage]
        assert pipe._lanes[stage].respawns == 1

    def test_real_pool_death_is_a_worker_crash(self):
        """A lane whose executor died under it (the real-world shape:
        shutdown races, interpreter teardown) respawns and retries."""
        respawned = []
        pipe = NodePipeline(workers=1, on_respawn=respawned.append)
        pipe._lanes["store"].pool.shutdown(wait=True)
        try:
            result = asyncio.run(pipe.run_store(lambda: "persisted"))
        finally:
            pipe.drain_and_close()
        assert result == "persisted"
        assert respawned == ["store"]

    def test_second_consecutive_death_propagates(self):
        """Retry-once, not retry-forever: a job that kills its worker
        every time surfaces to the caller's error path."""
        pipe = NodePipeline(workers=0)

        def poison():
            raise WorkerCrash("again")

        with pytest.raises(WorkerCrash):
            asyncio.run(pipe.run_validate(poison))
        # One respawn happened (first crash), then the retry's crash
        # propagated without a second respawn cycle.
        assert pipe._lanes["validate"].respawns == 1


@pytest.mark.sim
class TestStagedNodeInSim:
    def test_lane_worker_death_mid_mesh_respawns_and_keeps_the_block(
        self, tmp_path
    ):
        """The node-level crash contract: a validate and a store worker
        death during block handling are respawned and counted
        (NodeMetrics.worker_respawns, the task_crashes lineage), and
        the block still connects AND persists."""
        net = SimNet(
            seed=3, difficulty=8, store_dir=tmp_path, pipeline_workers=1, device="cpu"
        )

        async def main():
            node = await net.add_node("10.0.0.1")
            pipe = node.pipeline
            pipe.fail_next("validate")
            await net.mine_on(node, spacing_s=1.0)
            pipe.fail_next("store")
            await net.mine_on(node, spacing_s=1.0)
            assert node.chain.height == 2
            status = node.status()["pipeline"]
            assert status["worker_respawns"] == 2
            assert status["validate_alive"] and status["store_alive"]
            assert node.metrics.worker_respawns == 2
            await net.stop_all()

        net.run(main())
        # Both blocks survived the worker deaths onto disk: a fresh
        # resume sees the full chain.
        from p1_tpu_torch.chain.segstore import open_store

        store = open_store(tmp_path / "10.0.0.1.dat", fsync=False)
        try:
            assert store.load_chain(8, trusted=True).height == 2
        finally:
            store.close()

    @staticmethod
    def _connect_order(seed: int, workers: int) -> tuple:
        """One randomized 3-miner interleaving against a victim node;
        returns the victim's exact block CONNECT order."""
        rng = random.Random(seed * 1000 + 17)
        plan = [
            (rng.randrange(3), rng.choice((0.0, 0.05, 0.2, 1.0)))
            for _ in range(12)
        ]
        net = SimNet(seed=seed, difficulty=8, pipeline_workers=workers, device="cpu")
        order: list[bytes] = []

        async def main():
            victim = await net.add_node("10.0.1.0")
            miners = [
                await net.add_node(f"10.0.1.{i + 1}", peers=["10.0.1.0"])
                for i in range(3)
            ]
            assert await net.run_until(net.links_up, 30, wall_limit_s=60)
            inner = victim.chain.add_block

            def spy(block):
                res = inner(block)
                order.extend(b.block_hash() for b in res.connected)
                return res

            victim.chain.add_block = spy
            for miner_idx, spacing in plan:
                await net.mine_on(miners[miner_idx], spacing_s=spacing)
            await net.run_until(lambda: False, 30, wall_limit_s=60)
            await net.stop_all()

        net.run(main())
        assert order, "the interleaving never reached the victim"
        return tuple(order)

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_staged_connect_order_equals_serial_connect_order(self, seed):
        """The ordering property the refactor must preserve: blocks
        from one mesh connect on the victim in IDENTICAL order with
        staging on (1 worker) and off — across randomized multi-peer
        mining interleavings (concurrent forks, reorgs, relay echo)."""
        assert self._connect_order(seed, 1) == self._connect_order(seed, 0)


@pytest.mark.sim
class TestStagingDigestContract:
    """The acceptance pin: the 200-node partition/heal trace digest is
    byte-identical with staging on (1 worker) and off — determinism by
    construction (SimLoop.run_in_executor), proven at mesh scale."""

    def test_200_node_digest_identical_staging_on_off(self):
        from p1_tpu_torch.node.scenarios import partition_heal

        staged = partition_heal(nodes=200, seed=7, pipeline_workers=1, device="cpu")
        inline = partition_heal(nodes=200, seed=7, pipeline_workers=0, device="cpu")
        assert staged["ok"] and inline["ok"]
        assert staged["trace_digest"] == inline["trace_digest"]
