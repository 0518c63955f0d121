"""The port's ledger-state snapshots (``p1_tpu_torch.chain.snapshot``)
against the JAX package's.

Mirrors tests/test_snapshot.py (``TestCanonicalState``,
``TestHostileInput``, ``TestChainCheckpoints``, ``TestAssumedChain``): the
reference's cases, run against the port's codec and ``Chain``.
``TestCrossPackage`` then holds the two packages to each other: on the
same chain, snapshot files and ``state_root`` are byte-identical, a file
written by either loads in the other, and damaged files get the same
verdicts.

``TestNodePlane`` is test_snapshot.py's: port nodes on the port's
``SimNet`` with ``device="cpu"``.
"""

import os
import pathlib
import random
import subprocess
import sys

import pytest

from p1_tpu.chain import snapshot as ref_snapmod
from p1_tpu.chain.chain import Chain as RefChain
from p1_tpu.node.testing import make_blocks as ref_make_blocks
from p1_tpu_torch.chain import snapshot as snapmod
from p1_tpu_torch.chain.chain import Chain
from p1_tpu_torch.chain.snapshot import SnapshotError
from p1_tpu_torch.core.tx import BLOCK_REWARD
from p1_tpu_torch.node.netsim import SimNet
from p1_tpu_torch.node.testing import FaultPlan, HostilePeer, make_blocks

DIFF = 8
REPO = pathlib.Path(__file__).resolve().parent.parent


def _mk_chain(n=10, interval=4, miner_id="m1"):
    chain = Chain(DIFF)
    chain.checkpoint_interval = interval
    for b in make_blocks(n, DIFF, miner_id=miner_id)[1:]:
        res = chain.add_block(b)
        assert res.status.name == "ACCEPTED", res
    return chain


def _records(chain):
    h, block, balances, nonces, root = chain.snapshot_state()
    return h, root, snapmod.build_records(h, block, balances, nonces)


class TestCanonicalState:
    """Serialization determinism — the property the digests stand on."""

    BAL = {"alice": 7, "bob": 3, "carol": 11}
    NON = {"alice": 2, "dave": 1}

    def test_root_stable_across_insertion_orders(self):
        rng = random.Random(0)
        want = snapmod.state_root(self.BAL, self.NON)
        for _ in range(10):
            b = list(self.BAL.items())
            n = list(self.NON.items())
            rng.shuffle(b)
            rng.shuffle(n)
            assert snapmod.state_root(dict(b), dict(n)) == want

    def test_chunks_byte_identical_across_insertion_orders(self):
        rng = random.Random(1)
        want = snapmod.encode_chunks(self.BAL, self.NON)
        for _ in range(10):
            b = list(self.BAL.items())
            rng.shuffle(b)
            assert snapmod.encode_chunks(dict(b), self.NON) == want

    def test_zero_entries_never_encode(self):
        # A zero balance/nonce is the same as absence — the invariant
        # the ledger's _shift maintains, mirrored by the codec.
        assert snapmod.state_root({"a": 5, "z": 0}, {}) == snapmod.state_root(
            {"a": 5}, {}
        )

    def test_round_trip_file_and_state(self, tmp_path):
        chain = _mk_chain()
        h, root, (manifest_payload, chunks) = _records(chain)
        path = tmp_path / "snap.p1s"
        snapmod.write_snapshot(path, manifest_payload, chunks)
        snap = snapmod.load_snapshot(path)
        assert snap.height == h and snap.state_root == root
        assert snap.balances == {"m1": h * BLOCK_REWARD}
        # Writing the LOADED state back reproduces the exact file.
        again = tmp_path / "again.p1s"
        m2, c2 = snapmod.build_records(
            snap.height, snap.manifest.block, snap.balances, snap.nonces
        )
        snapmod.write_snapshot(again, m2, c2)
        assert again.read_bytes() == path.read_bytes()

    def test_root_and_file_stable_under_pythonhashseed(self, tmp_path):
        """Two fresh interpreters with different hash seeds must emit
        byte-identical snapshot files and the same state root —
        canonical means canonical."""
        script = r"""
import sys, hashlib
sys.path.insert(0, sys.argv[2])
from p1_tpu_torch.chain import snapshot as snapmod
from p1_tpu_torch.chain.chain import Chain
from p1_tpu_torch.node.testing import make_blocks
chain = Chain(8)
chain.checkpoint_interval = 4
for b in make_blocks(9, 8, miner_id="seed-test")[1:]:
    chain.add_block(b)
h, block, balances, nonces, root = chain.snapshot_state()
m, c = snapmod.build_records(h, block, balances, nonces)
snapmod.write_snapshot(sys.argv[1], m, c)
print(root.hex(), hashlib.sha256(open(sys.argv[1], "rb").read()).hexdigest())
"""
        outs = []
        for seed in ("0", "12345"):
            out = tmp_path / f"snap-{seed}.p1s"
            env = {
                **os.environ,
                "PYTHONHASHSEED": seed,
            }
            proc = subprocess.run(
                [sys.executable, "-c", script, str(out), str(REPO)],
                capture_output=True,
                text=True,
                timeout=110,
                env=env,
            )
            assert proc.returncode == 0, proc.stderr[-2000:]
            outs.append(proc.stdout.strip().splitlines()[-1])
        assert outs[0] == outs[1]


class TestHostileInput:
    """Every integrity gate refuses, loudly, with SnapshotError."""

    def test_chunk_digest_mismatch(self):
        chain = _mk_chain()
        _h, _root, (manifest_payload, chunks) = _records(chain)
        manifest = snapmod.parse_manifest(manifest_payload)
        bad = [chunks[0][:-1] + bytes([chunks[0][-1] ^ 1])]
        with pytest.raises(SnapshotError, match="digest"):
            snapmod.assemble(manifest, bad)

    def test_wrong_chunk_count(self):
        chain = _mk_chain()
        _h, _root, (manifest_payload, chunks) = _records(chain)
        manifest = snapmod.parse_manifest(manifest_payload)
        with pytest.raises(SnapshotError, match="chunks"):
            snapmod.assemble(manifest, [])

    def test_out_of_order_entries_rejected(self):
        chunks = snapmod.encode_chunks({"b": 1, "a": 2}, {})
        rows = snapmod.parse_chunk(chunks[0])
        assert [r[0] for r in rows] == ["a", "b"]  # canonical order
        # Hand-build a reversed chunk: parse accepts the layout, but
        # assemble's order gate must refuse it.
        import struct

        def entry(acct, bal, nonce):
            raw = acct.encode()
            return bytes([len(raw)]) + raw + struct.pack(">QQ", bal, nonce)

        evil = struct.pack(">I", 2) + entry("b", 1, 0) + entry("a", 2, 0)
        manifest = snapmod.Manifest(
            height=1,
            block_hash=make_blocks(1, DIFF)[1].block_hash(),
            state_root=snapmod.state_root({"b": 1, "a": 2}, {}),
            accounts=2,
            chunk_digests=(snapmod.chunk_digest(evil),),
            block=make_blocks(1, DIFF)[1],
        )
        with pytest.raises(SnapshotError, match="order"):
            snapmod.assemble(manifest, [evil])

    def test_root_mismatch_rejected(self):
        chain = _mk_chain()
        _h, _root, (manifest_payload, chunks) = _records(chain)
        manifest = snapmod.parse_manifest(manifest_payload)
        lied = snapmod.Manifest(
            manifest.height,
            manifest.block_hash,
            bytes(32),
            manifest.accounts,
            manifest.chunk_digests,
            manifest.block,
        )
        with pytest.raises(SnapshotError, match="root"):
            snapmod.assemble(lied, list(chunks))

    def test_manifest_anchor_hash_must_match(self):
        chain = _mk_chain()
        _h, _root, (manifest_payload, _chunks) = _records(chain)
        bad = bytearray(manifest_payload)
        bad[5] ^= 0x01  # a block-hash byte
        with pytest.raises(SnapshotError, match="anchor"):
            snapmod.parse_manifest(bytes(bad))

    def test_verify_file_verdicts(self, tmp_path):
        chain = _mk_chain()
        _h, _root, (manifest_payload, chunks) = _records(chain)
        path = tmp_path / "v.p1s"
        snapmod.write_snapshot(path, manifest_payload, chunks)
        assert snapmod.verify_file(path)["verdict"] == 0
        # Trailing garbage past a complete verified snapshot: verdict 1.
        with open(path, "ab") as fh:
            fh.write(b"rotten tail bytes")
        assert snapmod.verify_file(path)["verdict"] == 1
        # A flipped byte INSIDE a needed record: verdict 2 (the CRC
        # stops the scan before the chunk set completes).
        data = bytearray(path.read_bytes())
        data[len(snapmod.MAGIC) + 10] ^= 0x04
        path.write_bytes(bytes(data))
        assert snapmod.verify_file(path)["verdict"] == 2
        assert snapmod.verify_file(tmp_path / "missing.p1s")["verdict"] == 2


class TestChainCheckpoints:
    def test_roots_recorded_at_interval_heights(self):
        chain = _mk_chain(n=10, interval=4)
        assert sorted(chain.state_checkpoints) == [4, 8]

    def test_reorg_rerecords_checkpoint_roots(self):
        # Two branches diverging below a checkpoint height: the reorg
        # must replace the recorded root with the new branch's.
        base = make_blocks(3, DIFF, miner_id="base")
        a = make_blocks(5, DIFF, miner_id="side-a")  # independent chain
        chain = Chain(DIFF)
        chain.checkpoint_interval = 2
        for b in base[1:]:
            chain.add_block(b)
        root_before = chain.state_checkpoints[2]
        for b in a[1:]:
            chain.add_block(b)
        assert chain.tip_hash == a[-1].block_hash()  # reorged to longer
        assert chain.state_checkpoints[2] != root_before
        assert sorted(chain.state_checkpoints) == [2, 4]
        # The recorded root matches a from-scratch replay of the branch.
        fresh = Chain(DIFF)
        fresh.checkpoint_interval = 2
        for b in a[1:]:
            fresh.add_block(b)
        assert fresh.state_checkpoints == chain.state_checkpoints

    def test_snapshot_state_rollback_matches_incremental_root(self):
        chain = _mk_chain(n=11, interval=4)
        h, _block, balances, nonces, root = chain.snapshot_state()
        assert h == 8
        assert root == chain.state_checkpoints[8]
        assert snapmod.state_root(balances, nonces) == root
        # The live tip ledger is untouched by the materialization.
        assert chain.balance("m1") == 11 * BLOCK_REWARD

    def test_too_short_chain_serves_no_snapshot(self):
        chain = _mk_chain(n=3, interval=4)
        assert chain.snapshot_state() is None


class TestAssumedChain:
    def test_from_snapshot_serves_and_extends_identically(self):
        blocks = make_blocks(10, DIFF, miner_id="m1")
        full = Chain(DIFF)
        full.checkpoint_interval = 4
        for b in blocks[1:]:
            full.add_block(b)
        _h, _root, (manifest_payload, chunks) = _records(full)
        snap = snapmod.assemble(
            snapmod.parse_manifest(manifest_payload), list(chunks)
        )
        assumed = Chain.from_snapshot(DIFF, snap)
        assert assumed.assumed and assumed.base_height == 8
        assert assumed.balance("m1") == 8 * BLOCK_REWARD
        assert assumed.main_hash_at(8) == blocks[8].block_hash()
        assert assumed.main_hash_at(3) is None  # below the base: not held
        # Extends with the real next blocks, byte-for-byte agreeing
        # with the fully-validated chain.
        for b in blocks[9:]:
            res = assumed.add_block(b)
            assert res.status.name == "ACCEPTED", res.reason
        assert assumed.tip_hash == full.tip_hash
        assert assumed.balance("m1") == full.balance("m1")
        assert assumed.nonce("m1") == full.nonce("m1")
        # Serving surfaces: locator, blocks_after, proofs, fee stats.
        assert assumed.locator()[0] == assumed.tip_hash
        served = assumed.blocks_after([blocks[8].block_hash()])
        assert [b.block_hash() for b in served] == [
            b.block_hash() for b in blocks[9:]
        ]
        tip_tx = blocks[-1].txs[0]
        assert assumed.tx_proof(tip_tx.txid()) is not None
        assumed.fee_stats()  # anchors at the base, never walks below it

    def test_history_below_base_parks_as_orphans(self):
        blocks = make_blocks(10, DIFF, miner_id="m1")
        full = Chain(DIFF)
        full.checkpoint_interval = 4
        for b in blocks[1:]:
            full.add_block(b)
        _h, _root, (manifest_payload, chunks) = _records(full)
        snap = snapmod.assemble(
            snapmod.parse_manifest(manifest_payload), list(chunks)
        )
        assumed = Chain.from_snapshot(DIFF, snap)
        res = assumed.add_block(blocks[3])
        assert res.status.name == "ORPHAN"
        assert assumed.tip_hash == blocks[8].block_hash()  # unmoved




def _both_chains(n: int, interval: int):
    """The same n-block chain in both packages (several miners, so the
    snapshot holds several accounts and chunks)."""
    port, ref = Chain(DIFF), RefChain(DIFF)
    port.checkpoint_interval = ref.checkpoint_interval = interval
    blocks = make_blocks(n, DIFF, miner_id="x")
    ref_blocks = ref_make_blocks(n, DIFF, miner_id="x")
    for b, rb in zip(blocks[1:], ref_blocks[1:]):
        assert b.serialize() == rb.serialize()
        assert port.add_block(b).status.name == ref.add_block(rb).status.name == "ACCEPTED"
    return port, ref


class TestCrossPackage:
    @pytest.mark.parametrize("n,interval", [(4, 2), (9, 4), (12, 3)])
    def test_snapshot_files_byte_identical(self, tmp_path, n, interval):
        port, ref = _both_chains(n, interval)
        assert port.state_root() == ref.state_root()
        assert port.state_checkpoints == ref.state_checkpoints
        h, block, balances, nonces, root = port.snapshot_state()
        rh, rblock, rbalances, rnonces, rroot = ref.snapshot_state()
        assert (h, block.serialize(), balances, nonces, root) == (rh, rblock.serialize(), rbalances, rnonces, rroot)
        snapmod.write_snapshot(tmp_path / "port.p1s", *snapmod.build_records(h, block, balances, nonces))
        ref_snapmod.write_snapshot(tmp_path / "ref.p1s", *ref_snapmod.build_records(rh, rblock, rbalances, rnonces))
        assert (tmp_path / "port.p1s").read_bytes() == (tmp_path / "ref.p1s").read_bytes()
        got, want = snapmod.load_snapshot(tmp_path / "ref.p1s"), ref_snapmod.load_snapshot(tmp_path / "port.p1s")
        assert (got.height, got.state_root, got.balances, got.nonces) == (
            want.height, want.state_root, want.balances, want.nonces,
        )  # fmt: skip

    @pytest.mark.parametrize(
        "balances,nonces",
        [({}, {}), ({"a": 1}, {}), ({"b": 2, "a": 1}, {"c": 3}), ({f"acct{i}": i + 1 for i in range(300)}, {"acct7": 9})],
    )  # fmt: skip
    def test_state_root_and_chunks_equal(self, balances, nonces):
        assert snapmod.state_root(balances, nonces) == ref_snapmod.state_root(balances, nonces)
        assert snapmod.encode_chunks(balances, nonces) == ref_snapmod.encode_chunks(balances, nonces)

    @pytest.mark.parametrize("damage", ["clean", "tail", "flip_manifest", "flip_chunk", "truncate"])
    def test_verify_file_verdicts_equal(self, tmp_path, damage):
        port, _ = _both_chains(9, 4)
        path = tmp_path / "v.p1s"
        snapmod.write_snapshot(path, *_records(port)[2])
        data = bytearray(path.read_bytes())
        if damage == "tail":
            data += b"rotten tail bytes"
        elif damage == "flip_manifest":
            data[len(snapmod.MAGIC) + 10] ^= 0x04
        elif damage == "flip_chunk":
            data[-9] ^= 0x20
        elif damage == "truncate":
            del data[-20:]
        path.write_bytes(bytes(data))
        assert snapmod.verify_file(path) == ref_snapmod.verify_file(path)


@pytest.mark.sim
class TestNodePlane:
    """End-to-end over the deterministic simulator: full nodes, real
    protocol, virtual time."""

    def test_honest_boot_assumed_serves_then_flips(self):
        net = SimNet(seed=11, difficulty=DIFF, device="cpu")

        async def main():
            a = await net.add_node(snapshot_interval=4)
            b = await net.add_node(
                peers=[net.host_name(0)], snapshot_interval=4
            )
            assert await net.run_until(net.links_up, 30, wall_limit_s=30)
            for _ in range(10):
                await net.mine_on(a, spacing_s=0.5)
            assert await net.run_until(
                lambda: b.chain.height == 10, 30, wall_limit_s=30
            )
            j = await net.add_node(
                peers=[net.host_name(0)],
                snapshot_sync=True,
                snapshot_interval=4,
            )
            assert await net.run_until(
                lambda: j.validation_state == "assumed", 30, wall_limit_s=30
            )
            # Serving IMMEDIATELY from the assumed state: balances,
            # headers, proofs — before any history was replayed.
            assert j.chain.base_height == 8
            assert j.chain.balance(a.miner_id) > 0
            assert j.chain.header_of(j.chain.tip_hash) is not None
            assert (
                j.chain.tx_proof(j.chain.tip.txs[0].txid()) is not None
            )
            assert j.status()["snapshot"]["state"] == "assumed"
            assert j.status()["overload"]["mining_paused"] is True
            assert await net.run_until(
                lambda: j.validation_state == "validated"
                and j.metrics.snapshot_flips == 1,
                120,
                wall_limit_s=60,
            ), j.status()["snapshot"]
            assert j.chain.tip_hash == a.chain.tip_hash
            assert j.chain.base_height == 0  # full history now
            assert net.ledger_conserved()
            # Still follows gossip after the flip.
            await net.mine_on(a, spacing_s=0.5)
            assert await net.run_until(
                lambda: j.chain.height == 11, 30, wall_limit_s=30
            )
            await net.stop_all()

        net.run(main())

    def test_lying_snapshot_quarantined_demoted_falls_back(self):
        """THE acceptance case: one wrong balance, internally consistent
        (the root commits to the lie) — adopted, served, then CAUGHT by
        background revalidation; the node quarantines the snapshot,
        demotes the serving peer, falls back to genesis IBD, and
        converges to the honest tip."""
        net = SimNet(seed=12, difficulty=DIFF, device="cpu")

        async def main():
            a = await net.add_node(snapshot_interval=4)
            b = await net.add_node(
                peers=[net.host_name(0)], snapshot_interval=4
            )
            assert await net.run_until(net.links_up, 30, wall_limit_s=30)
            for _ in range(3):
                await net.mine_on(a, spacing_s=0.5)
            assert await net.run_until(
                lambda: b.chain.height == 3, 30, wall_limit_s=30
            )
            liar_host = "66.6.0.1"
            liar = HostilePeer(
                make_blocks(12, DIFF, miner_id="liar"),
                plan=FaultPlan(snapshot_lie="balance"),
                transport=net.net.host(liar_host),
                host=liar_host,
                rng=random.Random(99),
            )
            await liar.start()
            j = await net.add_node(
                name="10.0.0.9",
                peers=[f"{liar_host}:{liar.port}", net.host_name(0)],
                snapshot_sync=True,
                snapshot_interval=4,
            )
            assert await net.run_until(
                lambda: j.validation_state == "assumed", 60, wall_limit_s=60
            ), j.status()["snapshot"]
            # The lie is being served (that is what ASSUMED risks)...
            assert j.chain.balance("liar") == 12 * BLOCK_REWARD + 1000
            # ...until the replayed history contradicts the root.
            assert await net.run_until(
                lambda: j.metrics.snapshot_divergences == 1
                and j.validation_state == "validated",
                240,
                wall_limit_s=120,
            ), j.status()["snapshot"]
            assert j.metrics.snapshot_flips == 0
            # Quarantined + serving peer demoted + violation scored.
            assert any(
                p.sync_demerits > 0
                for p in j._peers.values()
                if p.host == liar_host
            )
            assert liar_host in j._violations
            # Honest mesh out-mines the liar's fork; the fallen-back
            # node converges to the honest tip through ordinary IBD.
            for _ in range(12):
                await net.mine_on(a, spacing_s=0.5)
            assert await net.run_until(
                lambda: j.chain.tip_hash == a.chain.tip_hash,
                240,
                wall_limit_s=120,
            )
            assert net.ledger_conserved()
            await liar.stop()
            await net.stop_all()

        net.run(main())

    def test_root_lie_refused_before_adoption(self):
        """A corrupted state root is caught at assembly — the node never
        enters ASSUMED, scores the forger, and falls over to the honest
        peer."""
        net = SimNet(seed=13, difficulty=DIFF, device="cpu")

        async def main():
            a = await net.add_node(snapshot_interval=4)
            assert await net.run_until(
                lambda: True, 1, wall_limit_s=30
            )
            for _ in range(6):
                await net.mine_on(a, spacing_s=0.5)
            liar_host = "66.6.0.2"
            liar = HostilePeer(
                make_blocks(12, DIFF, miner_id="liar"),
                plan=FaultPlan(snapshot_lie="root"),
                transport=net.net.host(liar_host),
                host=liar_host,
                rng=random.Random(98),
            )
            await liar.start()
            j = await net.add_node(
                name="10.0.0.9",
                peers=[f"{liar_host}:{liar.port}", net.host_name(0)],
                snapshot_sync=True,
                snapshot_interval=4,
            )
            assert await net.run_until(
                lambda: j.validation_state == "validated"
                and j.chain.height >= 6
                and j.chain.base_height == 0
                or j.validation_state == "assumed",
                120,
                wall_limit_s=60,
            )
            # Never adopted the forged snapshot; the forger was scored.
            assert j.metrics.snapshot_divergences == 0
            assert liar_host in j._violations
            # It may have assumed the HONEST peer's snapshot instead —
            # either way it must end fully validated on the honest tip.
            assert await net.run_until(
                lambda: j.validation_state == "validated"
                and j.chain.tip_hash == a.chain.tip_hash,
                240,
                wall_limit_s=120,
            ), j.status()["snapshot"]
            await liar.stop()
            await net.stop_all()

        net.run(main())

    def test_truncated_transfer_fails_over_to_honest_peer(self):
        """A server that stalls mid-transfer (crash/truncation profile)
        costs one supervised deadline, then the fetch fails over."""
        net = SimNet(seed=14, difficulty=DIFF, device="cpu")

        async def main():
            a = await net.add_node(snapshot_interval=4)
            for _ in range(8):
                await net.mine_on(a, spacing_s=0.5)
            liar_host = "66.6.0.3"
            liar = HostilePeer(
                make_blocks(12, DIFF, miner_id="liar"),
                plan=FaultPlan(snapshot_chunks=0),  # manifest, no chunks
                transport=net.net.host(liar_host),
                host=liar_host,
                rng=random.Random(97),
            )
            await liar.start()
            j = await net.add_node(
                name="10.0.0.9",
                peers=[f"{liar_host}:{liar.port}", net.host_name(0)],
                snapshot_sync=True,
                snapshot_interval=4,
            )
            assert await net.run_until(
                lambda: j.validation_state == "validated"
                and j.chain.tip_hash == a.chain.tip_hash
                and j.chain.base_height == 0,
                240,
                wall_limit_s=120,
            ), j.status()["snapshot"]
            assert j.metrics.snapshot_stalls >= 1
            await liar.stop()
            await net.stop_all()

        net.run(main())

    def test_crash_during_revalidation_resumes_assumed(self, tmp_path):
        """Crash mid-ASSUMED: the sidecar + store resume the assumed
        chain through the NORMAL boot path, the background revalidation
        restarts from genesis, and the flip still lands."""
        net = SimNet(seed=15, difficulty=DIFF, store_dir=tmp_path, device="cpu")

        async def main():
            a = await net.add_node(snapshot_interval=4)
            b = await net.add_node(
                peers=[net.host_name(0)], snapshot_interval=4
            )
            assert await net.run_until(net.links_up, 30, wall_limit_s=30)
            for _ in range(10):
                await net.mine_on(a, spacing_s=0.5)
            assert await net.run_until(
                lambda: b.chain.height == 10, 30, wall_limit_s=30
            )
            jhost = "10.0.0.9"
            j = await net.add_node(
                name=jhost,
                peers=[net.host_name(0)],
                snapshot_sync=True,
                snapshot_interval=4,
            )
            assert await net.run_until(
                lambda: j.validation_state == "assumed", 60, wall_limit_s=60
            )
            snap_sidecar = tmp_path / f"{jhost}.dat.snapshot"
            assert snap_sidecar.exists()
            await net.crash_node(jhost)
            await net.mine_on(a, spacing_s=0.5)
            j2 = await net.recover_node(jhost)
            # Resumed ASSUMED from the sidecar, at (at least) the base.
            assert j2.validation_state == "assumed"
            assert j2.chain.base_height == 8
            assert j2.chain.balance(a.miner_id) > 0
            assert await net.run_until(
                lambda: j2.validation_state == "validated"
                and j2.metrics.snapshot_flips == 1,
                240,
                wall_limit_s=120,
            ), j2.status()["snapshot"]
            assert not snap_sidecar.exists()  # flip retired the sidecar
            assert await net.run_until(
                lambda: j2.chain.tip_hash == a.chain.tip_hash,
                60,
                wall_limit_s=60,
            )
            assert net.ledger_conserved()
            await net.stop_all()

        net.run(main())

    def test_crash_during_download_restarts_clean(self, tmp_path):
        """Crash while the snapshot download is in flight: nothing was
        adopted, nothing persisted — the reboot is an ordinary fresh
        boot that simply snapshots again."""
        net = SimNet(seed=16, difficulty=DIFF, store_dir=tmp_path, device="cpu")

        async def main():
            a = await net.add_node(snapshot_interval=4)
            for _ in range(10):
                await net.mine_on(a, spacing_s=0.5)
            jhost = "10.0.0.9"
            j = await net.add_node(
                name=jhost,
                peers=[net.host_name(0)],
                snapshot_sync=True,
                snapshot_interval=4,
            )
            # Crash at the first possible instant: mid-handshake or
            # mid-download, before any verdict.
            await net.crash_node(jhost)
            assert jhost not in net.nodes
            j2 = await net.recover_node(jhost)
            assert await net.run_until(
                lambda: j2.validation_state == "validated"
                and j2.chain.tip_hash == a.chain.tip_hash
                and j2.chain.base_height == 0,
                240,
                wall_limit_s=120,
            ), j2.status()["snapshot"]
            assert net.ledger_conserved()
            await net.stop_all()

        net.run(main())

    def test_snapshot_join_scenario_honest_and_lying(self):
        """The corpus entry (`p1 sim snapshot-join`) holds in both
        modes at a small, tier-1-priced scale."""
        from p1_tpu_torch.node.scenarios import run_scenario

        r = run_scenario(
            "snapshot-join", seed=0, difficulty=DIFF, nodes=6, device="cpu"
        )
        assert r["ok"], r
        assert r["flips"] == 1 and r["samples_contradicted"] == 0
        r = run_scenario(
            "snapshot-join",
            seed=1,
            difficulty=DIFF,
            nodes=6,
            chain_blocks=4,
            lie="balance",
            device="cpu",
        )
        assert r["ok"], r
        assert r["divergences"] >= 1
