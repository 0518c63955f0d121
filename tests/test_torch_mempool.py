"""The port's mempool persistence against the JAX package's.

Mirrors tests/test_mempool_persist.py: the reference's cases, run against ``p1_tpu_torch``: nodes with ``backend="cpu", device="cpu"``
(``tests/torch_testutil.py``: hashlib mining, the ``device`` signature
rung's plain version), transfers signed by the JAX package's keys and
carried into the port by their bytes.
The persistence functions are byte for byte the reference's.

Mempool persistence (Bitcoin's mempool.dat analog):
pending transactions survive a node restart, reload passes FULL
re-validation so downtime-invalidated entries drop, and restored ages
keep the TTL clock honest across the restart.
"""

import asyncio

from torch_testutil import account, stx

from test_torch_node import CHUNK, DIFF, _config, fund, run, wait_until

from p1_tpu_torch.chain import AddStatus, Chain
from p1_tpu_torch.core import Transaction
from p1_tpu_torch.core.genesis import genesis_hash, make_genesis
from p1_tpu_torch.mempool import Mempool, load_mempool, save_mempool
from p1_tpu_torch.node import Node

TAG = genesis_hash(8)


def _pool(chain: Chain | None = None) -> Mempool:
    if chain is None:
        return Mempool(chain_tag=TAG)
    return Mempool(
        balance_of=chain.balance,
        nonce_of=chain.nonce,
        chain_tag=chain.genesis.block_hash(),
    )


class TestSaveLoad:
    def test_round_trip_preserves_txs_and_ages(self, tmp_path):
        pool = _pool()
        txs = [stx("alice", account("bob"), i + 1, 2, i) for i in range(5)]
        for tx in txs:
            assert pool.add(tx)
        # Backdate one admission so the saved age is meaningfully large.
        import time

        old = txs[0].txid()
        pool._admitted_at[old] = time.monotonic() - 500.0
        path = tmp_path / "pool.mempool"
        assert save_mempool(pool, path) == 5

        fresh = _pool()
        restored, dropped = load_mempool(fresh, path)
        assert (restored, dropped) == (5, 0)
        assert {t.txid() for t, _ in fresh.snapshot()} == {
            t.txid() for t in txs
        }
        ages = dict((t.txid(), age) for t, age in fresh.snapshot())
        assert ages[old] >= 499.0  # age carried over, not reset

    def test_ttl_clock_honest_across_restart(self, tmp_path):
        pool = _pool()
        tx = stx("alice", account("bob"), 1, 1, 0)
        assert pool.restore(tx, age_s=3600.0)
        # An hour-old transfer against a 30-minute TTL expires on the
        # first housekeeping pass after the restart — no fresh lease.
        assert pool.expire(1800.0) == 1
        assert len(pool) == 0

    def test_invalid_on_reload_dropped(self, tmp_path):
        from test_torch_chain import _funded_chain, _mine_child

        chain, b1 = _funded_chain("alice")
        pool = Mempool(
            balance_of=chain.balance,
            nonce_of=chain.nonce,
            chain_tag=chain.genesis.block_hash(),
        )
        keep = stx("alice", account("bob"), 5, 1, 0)
        assert pool.add(keep)
        path = tmp_path / "pool.mempool"
        assert save_mempool(pool, path) == 1
        # While "down", the same slot confirms on-chain: seq 0 is now a
        # definite replay and must not re-enter.
        spend = stx("alice", account("carol"), 3, 1, 0)
        b2 = _mine_child(b1, txs=(Transaction.coinbase("m", 2), spend))
        assert chain.add_block(b2).status is AddStatus.ACCEPTED
        fresh = Mempool(
            balance_of=chain.balance,
            nonce_of=chain.nonce,
            chain_tag=chain.genesis.block_hash(),
        )
        restored, dropped = load_mempool(fresh, path)
        assert (restored, dropped) == (0, 1)
        assert len(fresh) == 0

    def test_corrupt_file_restores_prefix(self, tmp_path):
        pool = _pool()
        txs = [stx("alice", account("bob"), i + 1, 2, i) for i in range(3)]
        for tx in txs:
            assert pool.add(tx)
        path = tmp_path / "pool.mempool"
        save_mempool(pool, path)
        raw = path.read_bytes()
        path.write_bytes(raw[: len(raw) - 7])  # torn tail
        fresh = _pool()
        restored, dropped = load_mempool(fresh, path)
        assert restored == 2 and dropped == 0  # prefix kept, tail gone
        # Garbage files restore nothing and raise nothing.
        path.write_bytes(b"not a mempool at all")
        assert load_mempool(_pool(), path) == (0, 0)


class TestAtomicWrite:
    def test_fsync_data_before_replace_and_dir_after(
        self, tmp_path, monkeypatch
    ):
        """Power-loss ordering: the tmp file's DATA
        must be fsynced before the rename publishes it (or the journal
        can commit a completed rename pointing at an empty/torn file),
        and the DIRECTORY after (or the rename itself can vanish)."""
        import os
        import stat

        from p1_tpu_torch.mempool import write_mempool_file

        events = []
        real_fsync, real_replace = os.fsync, os.replace

        def spy_fsync(fd):
            kind = "dir" if stat.S_ISDIR(os.fstat(fd).st_mode) else "file"
            events.append(("fsync", kind))
            return real_fsync(fd)

        def spy_replace(src, dst):
            events.append(("replace", None))
            return real_replace(src, dst)

        monkeypatch.setattr(os, "fsync", spy_fsync)
        monkeypatch.setattr(os, "replace", spy_replace)
        path = tmp_path / "pool.mempool"
        write_mempool_file(b"payload-bytes", path)
        assert events == [
            ("fsync", "file"),
            ("replace", None),
            ("fsync", "dir"),
        ]
        assert path.read_bytes() == b"payload-bytes"
        assert not path.with_suffix(".mempool.tmp").exists()


class TestNodeRestart:
    def test_pending_txs_survive_restart(self, tmp_path):
        async def scenario():
            store = str(tmp_path / "chain.log")
            node = Node(_config(store_path=store))
            await node.start()
            await fund(node, "alice", blocks=2)
            height = node.chain.height
            spends = [
                stx("alice", account("bob"), 5, 2, 0, difficulty=DIFF),
                stx("alice", account("bob"), 5, 2, 1, difficulty=DIFF),
            ]
            for tx in spends:
                await node.submit_tx(tx)
            assert len(node.mempool) == 2
            await node.stop()

            revived = Node(_config(store_path=store))
            await revived.start()
            try:
                assert revived.chain.height == height
                assert len(revived.mempool) == 2
                assert {t.txid() for t, _ in revived.mempool.snapshot()} == {
                    t.txid() for t in spends
                }
                # And they are still mineable: one block confirms both.
                revived.miner_id = account("miner2")
                revived.start_mining()
                assert await wait_until(
                    lambda: revived.chain.height > height
                )
                await revived.stop_mining()
                assert revived.chain.nonce(account("alice")) == 2
            finally:
                await revived.stop()

        run(scenario())


class TestCrossPackage:
    """One pool, two packages: the persisted file is byte-identical, each
    package's file reloads in the other with the same verdicts, and the
    sync-page order is the same."""

    def _pools(self, clock):
        from p1_tpu.mempool import Mempool as RefMempool

        return RefMempool(clock=clock), Mempool(clock=clock)

    def test_dump_is_byte_identical_and_loads_in_the_other(self, tmp_path):
        from p1_tpu.mempool import load_mempool as ref_load
        from p1_tpu.mempool import save_mempool as ref_save
        from txutil import stx as ref_stx

        now = [100.0]
        ref_pool, pool = self._pools(lambda: now[0])
        spends = [ref_stx("alice", account("bob"), 5, fee, seq) for seq, fee in enumerate((3, 1, 2))]
        spends.append(ref_stx("carol", account("dave"), 7, 4, 0))
        for i, tx in enumerate(spends):
            now[0] = 100.0 + i
            assert ref_pool.add(tx)
            assert pool.add(Transaction.deserialize(tx.serialize()))
        now[0] = 110.0
        ref_path, path = tmp_path / "ref.mempool", tmp_path / "port.mempool"
        assert ref_save(ref_pool, ref_path) == save_mempool(pool, path) == len(spends)
        assert path.read_bytes() == ref_path.read_bytes()
        # Each package's file restores in the other's pool.
        ref_back, back = self._pools(lambda: now[0])
        assert load_mempool(back, ref_path) == ref_load(ref_back, path) == (len(spends), 0)
        assert list(back.txids()) == list(ref_back.txids()) == list(pool.txids())

    def test_sync_page_order_is_the_same(self):
        from p1_tpu.mempool import sync_key as ref_sync_key

        from p1_tpu_torch.mempool import sync_key

        keys = [(fee, bytes([b]) * 32) for fee in (0, 1, 5) for b in (9, 3, 200)]
        assert sorted(keys, key=lambda k: sync_key(*k)) == sorted(keys, key=lambda k: ref_sync_key(*k))
