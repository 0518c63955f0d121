"""The port's chain state (``p1_tpu_torch.chain``) against the JAX package's.

Mirrors tests/test_chain.py (``TestValidate``, ``TestOrphanPool``,
``TestForkChoice``, ``TestPersistence``, ``TestLedger``,
``TestCrashRecovery``, ``TestCompact``, ``TestForkChoiceProperty``,
``TestTrustedResume``) and tests/test_consensus.py (``TestLedgerUnit``,
``TestOverspendRejection``, ``TestForkChoicePropertyWithLedger``): the
reference's cases, run against the port's ``Chain``, ledger and store,
their CLI cases through ``python -m p1_tpu_torch``.  ``TestChainParity``
and the other ``*Parity`` classes then feed one block sequence (forks,
reorgs, orphans, rejected blocks), built from a seed with the JAX package
and carried into the port by its bytes, to ``p1_tpu.chain.Chain`` and to
``p1_tpu_torch.chain.Chain``: both must give the same ``AddStatus`` and
reason text on every block, and the same tip, balances, nonces, state
root, filter headers and ``tx_proof``s after it.

Signature batches run on the port's default ``device`` rung pinned to its
plain PyTorch version (``set_sig_backend("device", device="cpu")``).
Transfers are signed with the JAX package's keys (``tests/txutil.py``'s
``key_for``) and carried into the port by their bytes (``stx``).

test_consensus.py's ``TestMempoolBalance`` runs on the port's ``Mempool``
and ``TestCrashRecovery.test_sigkill_mid_mining_then_restart`` on a port
node process (``--backend cpu --device cpu``).  Not mirrored here:
test_chain.py's ``TestReplay``, whose device cases the port's
tests/test_torch_replay.py holds.
"""

import dataclasses
import os
import pathlib
import random

import pytest

from txutil import account
from txutil import key_for
from txutil import stx as ref_stx

from p1_tpu.chain import AddStatus as RefStatus
from p1_tpu.chain import Chain as RefChain
from p1_tpu.chain import ChainStore as RefStore
from p1_tpu.chain.ledger import Ledger as RefLedger
from p1_tpu.chain.ledger import LedgerError as RefLedgerError
from p1_tpu.core import Block as RefBlock
from p1_tpu.core import BlockHeader as RefHeader
from p1_tpu.core import Transaction as RefTx
from p1_tpu.core import make_genesis as ref_make_genesis
from p1_tpu.core import merkle_root as ref_merkle_root
from p1_tpu.core.retarget import RetargetRule as RefRule
from p1_tpu.core.sigcache import SignatureCache as RefCache
from p1_tpu.hashx import get_backend as ref_get_backend
from p1_tpu.miner import Miner as RefMiner
from p1_tpu_torch.chain import (
    AddStatus,
    Chain,
    ChainStore,
    ValidationError,
    check_block,
    save_chain,
    verify_tx_proof,
)
from p1_tpu_torch.chain.chain import MAX_ORPHANS
from p1_tpu_torch.chain.ledger import Ledger, LedgerError, balances
from p1_tpu_torch.core import Block, BlockHeader, Transaction, keys, make_genesis, merkle_root
from p1_tpu_torch.core.retarget import RetargetRule
from p1_tpu_torch.core.sigcache import SignatureCache
from p1_tpu_torch.core.tx import BLOCK_REWARD
from p1_tpu_torch.hashx import get_backend
from p1_tpu_torch.miner import Miner

REPO = pathlib.Path(__file__).resolve().parent.parent

DIFF = 8
_REF_MINER = RefMiner(backend=ref_get_backend("cpu"))


@pytest.fixture(autouse=True)
def _plain_device_rung():
    keys.set_sig_backend("device", device="cpu")
    yield
    keys.set_sig_backend(None)


_MINER = Miner(backend=get_backend("cpu"))


def stx(*args, **kwargs) -> Transaction:
    """tests/txutil.py's signed transfer, as the port's transaction."""
    return Transaction.deserialize(ref_stx(*args, **kwargs).serialize())


def _mine_child(parent: Block, txs=(), ts_offset: int = 1, version: int = 1) -> Block:
    """Seal a valid child block of ``parent`` (the port's)."""
    header = BlockHeader(
        version=version,
        prev_hash=parent.block_hash(),
        merkle_root=merkle_root([tx.txid() for tx in txs]),
        timestamp=parent.header.timestamp + ts_offset,
        difficulty=parent.header.difficulty,
        nonce=0,
    )
    sealed = _MINER.search_nonce(header)
    assert sealed is not None
    return Block(sealed, tuple(txs))


@pytest.fixture(scope="module")
def chain_blocks():
    """Genesis + 3 mined main-chain blocks + a 5-block competing fork off
    genesis (mined once per module; chain state is rebuilt per test)."""
    genesis = make_genesis(DIFF)
    main = [genesis]
    for _ in range(3):
        main.append(_mine_child(main[-1]))
    fork = [genesis]
    for _ in range(5):
        # version=2 differentiates fork headers from main ones at h+1
        fork.append(_mine_child(fork[-1], version=2))
    return main, fork


def _funded_chain(label: str = "alice"):
    """Genesis + one block crediting ``label``'s account with the subsidy."""
    genesis = make_genesis(DIFF)
    chain = Chain(DIFF, genesis=genesis)
    b1 = _mine_child(genesis, txs=(Transaction.coinbase(account(label), 1),))
    assert chain.add_block(b1).status is AddStatus.ACCEPTED
    return chain, b1


def to_port(block: RefBlock) -> Block:
    """The port's block with the reference block's bytes."""
    return Block.deserialize(block.serialize())


def mine_child(parent, txs=(), ts_offset: int = 1, version: int = 1, difficulty=None):
    """A sealed child of ``parent`` (a JAX-package block)."""
    header = RefHeader(
        version=version,
        prev_hash=parent.block_hash(),
        merkle_root=ref_merkle_root([tx.txid() for tx in txs]),
        timestamp=parent.header.timestamp + ts_offset,
        difficulty=parent.header.difficulty if difficulty is None else difficulty,
        nonce=0,
    )
    sealed = _REF_MINER.search_nonce(header)
    assert sealed is not None
    return RefBlock(sealed, tuple(txs))


def cb(miner: str, height: int) -> RefTx:
    return RefTx.coinbase(miner, height)


def _hashes(blocks) -> list[bytes]:
    return [b.block_hash() for b in blocks]


class Pair:
    """One reference chain and one port chain fed the same blocks."""

    def __init__(self, difficulty: int = DIFF, genesis=None, retarget=None):
        self.ref = RefChain(difficulty, genesis=genesis, retarget=retarget)
        self.port = Chain(
            difficulty,
            genesis=None if genesis is None else to_port(genesis),
            retarget=None if retarget is None else RetargetRule(*dataclasses.astuple(retarget)),
        )
        assert self.port.genesis.serialize() == self.ref.genesis.serialize()
        # Each pair verifies its own signatures, whatever ran before it.
        self.port.sig_cache = SignatureCache()
        self.ref.sig_cache = RefCache()
        self.statuses: list[tuple[str, str]] = []
        self.blocks: list[RefBlock] = []

    @property
    def genesis(self):
        return self.ref.genesis

    def add(self, block: RefBlock, trusted: bool = False):
        want = self.ref.add_block(block, trusted=trusted)
        got = self.port.add_block(to_port(block), trusted=trusted)
        assert (got.status.value, got.reason) == (want.status.value, want.reason)
        for field in ("removed", "added", "connected"):
            assert _hashes(getattr(got, field)) == _hashes(getattr(want, field)), field
        self.statuses.append((want.status.value, want.reason))
        self.blocks.append(block)
        return want

    def assert_same_state(self) -> None:
        ref, port = self.ref, self.port
        assert port.tip_hash == ref.tip_hash
        assert port.height == ref.height
        assert len(port) == len(ref)
        assert _hashes(port.main_chain()) == _hashes(ref.main_chain())
        assert port.balances_snapshot() == ref.balances_snapshot()
        accounts = set(ref.balances_snapshot()) | {
            tx.sender for b in self.blocks for tx in b.txs
        }
        assert {a: port.nonce(a) for a in accounts} == {a: ref.nonce(a) for a in accounts}
        assert port.state_root() == ref.state_root()
        assert port.locator() == ref.locator()
        assert port.next_difficulty() == ref.next_difficulty()
        assert port.fee_stats() == ref.fee_stats()
        assert len(port.filter_headers) == len(ref.filter_headers)
        for h in range(len(ref.filter_headers)):
            assert port.filter_headers.header_at(h) == ref.filter_headers.header_at(h)
        for b in self.blocks:
            assert port.block_filter(b.block_hash()) == ref.block_filter(b.block_hash())
            for tx in b.txs:
                want = ref.tx_proof(tx.txid())
                got = port.tx_proof(tx.txid())
                if want is None:
                    assert got is None
                    continue
                assert got.tx.serialize() == want.tx.serialize()
                assert got.header.serialize() == want.header.serialize()
                assert (got.branch, got.index, got.height, got.tip_height) == (
                    want.branch,
                    want.index,
                    want.height,
                    want.tip_height,
                )
                verify_tx_proof(
                    got, port.difficulty, port.genesis.block_hash(), tx.txid(), retarget=port.retarget
                )


# -- block sequences, built with the JAX package -----------------------------


def seq_linear(rng):
    g = ref_make_genesis(DIFF)
    out, tip = [], g
    for h in range(1, 5):
        tip = mine_child(tip, (cb("m", h),))
        out.append(tip)
    return None, out


def seq_duplicate(rng):
    g = ref_make_genesis(DIFF)
    b1 = mine_child(g, (cb("m", 1),))
    return None, [b1, b1, mine_child(b1, (cb("m", 2),)), b1]


def seq_invalid(rng):
    """Bad PoW, wrong difficulty, merkle mismatch, each at the tip."""
    g = ref_make_genesis(DIFF)
    b1 = mine_child(g, (cb("m", 1),))
    good = mine_child(b1, (cb("m", 2),))
    bad_pow = RefBlock(
        RefHeader(1, b1.block_hash(), good.header.merkle_root, good.header.timestamp, DIFF, 0),
        good.txs,
    )
    while bad_pow.header.nonce < 1 << 20 and _meets(bad_pow):
        h = bad_pow.header
        bad_pow = RefBlock(RefHeader(1, h.prev_hash, h.merkle_root, h.timestamp, DIFF, h.nonce + 1), good.txs)
    wrong_diff = mine_child(b1, (cb("m", 2),), difficulty=DIFF + 1)
    merkle = RefBlock(good.header, (cb("m", 3),))
    return None, [b1, bad_pow, wrong_diff, merkle, good]


def _meets(block) -> bool:
    from p1_tpu.core import meets_target

    return meets_target(block.block_hash(), block.header.difficulty)


def seq_shorter_fork(rng):
    g = ref_make_genesis(DIFF)
    main = [g]
    for h in range(1, 4):
        main.append(mine_child(main[-1], (cb("m", h),)))
    fork = mine_child(g, (cb("f", 1),), version=2)
    return None, [*main[1:], fork]


def seq_reorg(rng):
    """A 3-block main chain, then a 5-block fork off genesis."""
    g = ref_make_genesis(DIFF)
    main, fork = [g], [g]
    for h in range(1, 4):
        main.append(mine_child(main[-1], (cb("m", h),)))
    for h in range(1, 6):
        fork.append(mine_child(fork[-1], (cb("f", h),), version=2))
    return None, [*main[1:], *fork[1:]]


def seq_tiebreak(rng):
    g = ref_make_genesis(DIFF)
    a = mine_child(g, (cb("a", 1),))
    b = mine_child(g, (cb("b", 1),))
    return None, [a, b, mine_child(a, (cb("a", 2),)), mine_child(b, (cb("b", 2),))]


def seq_orphans(rng):
    """Children delivered before their parents: parked, then cascaded."""
    g = ref_make_genesis(DIFF)
    chain = [g]
    for h in range(1, 6):
        chain.append(mine_child(chain[-1], (cb("m", h),)))
    return None, [chain[3], chain[5], chain[4], chain[3], chain[1], chain[2]]


def _funded(label: str, blocks_after: int = 0):
    """Genesis and a block paying ``label``'s account its coinbase."""
    g = ref_make_genesis(DIFF)
    b1 = mine_child(g, (cb(account(label), 1),))
    return g, b1


def seq_spends(rng):
    """Signed spends: exact balance, overspend, replay, seq gap, unowned."""
    g, b1 = _funded("alice")
    ok = mine_child(b1, (cb("m", 2), ref_stx("alice", account("bob"), 40, 1, 0)))
    overspend = mine_child(ok, (cb("m", 3), ref_stx("alice", account("bob"), 10_000, 1, 1)))
    replay = mine_child(ok, (cb("m", 3), ref_stx("alice", account("bob"), 40, 1, 0)))
    gap = mine_child(ok, (cb("m", 3), ref_stx("alice", account("bob"), 1, 1, 5)))
    unowned = mine_child(ok, (cb("m", 3), ref_stx("carol", account("bob"), 1, 0, 0)))
    exact_amount = 50 - 41 - 1  # what alice holds after the first spend, less the fee
    exact = mine_child(ok, (cb("m", 3), ref_stx("alice", account("bob"), exact_amount, 1, 1)))
    bob_spends = mine_child(exact, (cb("m", 4), ref_stx("bob", account("carol"), 48, 2, 0)))
    return None, [b1, ok, overspend, replay, gap, unowned, exact, bob_spends]


def seq_invalid_descendants(rng):
    """An overspending block, its child, and a heavier branch through it."""
    g, b1 = _funded("alice")
    bad = mine_child(b1, (cb("m", 2), ref_stx("alice", account("bob"), 10_000, 1, 0)))
    child = mine_child(bad, (cb("m", 3),))
    grandchild = mine_child(child, (cb("m", 4),))
    honest = mine_child(b1, (cb("h", 2),), version=2)
    return None, [b1, honest, bad, child, grandchild]


def seq_reorg_ledger(rng):
    """A reorg that moves balances and rolls a nonce back, then a branch
    that overdraws midway."""
    g, b1 = _funded("alice")
    spend = mine_child(b1, (cb("m", 2), ref_stx("alice", account("bob"), 30, 1, 0)))
    fork1 = mine_child(b1, (cb("f", 2),), version=2)
    fork2 = mine_child(fork1, (cb("f", 3), ref_stx("alice", account("carol"), 20, 2, 0)))
    fork3 = mine_child(fork2, (cb("f", 4),))
    over1 = mine_child(b1, (cb("o", 2),), version=3)
    over2 = mine_child(over1, (cb("o", 3), ref_stx("alice", account("bob"), 45, 1, 0)))
    over3 = mine_child(over2, (cb("o", 4), ref_stx("alice", account("bob"), 45, 1, 1)))
    over4 = mine_child(over3, (cb("o", 5),))
    over5 = mine_child(over4, (cb("o", 6),))
    return None, [b1, spend, fork1, fork2, fork3, over1, over2, over3, over4, over5]


def seq_rejected_structure(rng):
    """check_block's structural rejections, each reached through add_block."""
    from p1_tpu.core.genesis import genesis_hash as ref_genesis_hash

    g, b1 = _funded("alice")
    t = ref_stx("alice", account("bob"), 5, 1, 0)
    unsigned = RefTx(account("alice"), account("bob"), 5, 1, 0, chain=ref_genesis_hash(DIFF))
    untagged = RefTx.transfer(key_for("alice"), account("bob"), 5, 1, 0)
    cross = RefTx.transfer(key_for("alice"), account("bob"), 5, 1, 0, chain=ref_genesis_hash(DIFF + 1))
    forged = RefTx(account("bob"), account("alice"), 5, 1, 0, t.pubkey, t.sig, t.chain)
    tampered = RefTx(t.sender, t.recipient, 6, t.fee, t.seq, t.pubkey, t.sig, t.chain)
    signed_cb = RefTx("coinbase", "m", 50, 0, 2, t.pubkey, t.sig, t.chain)
    blocks = [
        mine_child(b1, (cb("m", 2), t, t)),  # duplicate txid
        mine_child(b1, (t, cb("m", 2))),  # coinbase not first
        mine_child(b1, (RefTx.coinbase("m", 2, reward=51),)),  # wrong subsidy
        mine_child(b1, (cb("m", 2), unsigned)),
        mine_child(b1, (cb("m", 2), untagged)),
        mine_child(b1, (cb("m", 2), cross)),
        mine_child(b1, (cb("m", 2), forged)),
        mine_child(b1, (cb("m", 2), tampered)),
        mine_child(b1, (signed_cb,)),
        mine_child(b1, (cb("m", 2), cb("n", 2))),
        mine_child(b1, (cb("m", 2), t)),
    ]
    return None, [b1, *blocks]


def seq_batch_signatures(rng):
    """A block of ten signed transfers (one batch on the device rung) and
    a block with one bad signature among ten."""
    g, b1 = _funded("alice")
    good = [ref_stx("alice", account(f"r{i}"), 1, 1, i) for i in range(10)]
    bad = list(good)
    t = bad[6]
    bad[6] = RefTx(t.sender, t.recipient, t.amount, t.fee, t.seq, t.pubkey,
                   t.sig[:20] + bytes([t.sig[20] ^ 1]) + t.sig[21:], t.chain)  # fmt: skip
    return None, [b1, mine_child(b1, (cb("m", 2), *bad)), mine_child(b1, (cb("m", 2), *good))]


def seq_random_dag(rng):
    """60 blocks on random parents, delivered in a shuffled order."""
    g = ref_make_genesis(2)
    blocks = [g]
    for i in range(60):
        parent = rng.choice(blocks)
        tx = RefTx("coinbase", f"m{i % 3}", 50, 0, i)
        blocks.append(mine_child(parent, (tx,), ts_offset=rng.randint(1, 9)))
    order = blocks[1:]
    rng.shuffle(order)
    return g, order


def seq_random_dag_ledger(rng):
    """A random DAG whose blocks pay and spend one funded account, so some
    branches overdraw: the ledger decides which blocks connect."""
    g, b1 = _funded("alice")
    blocks = [b1]
    for i in range(24):
        parent = rng.choice(blocks)
        txs = [cb(f"m{i}", 0)]
        if rng.random() < 0.5:
            txs.append(ref_stx("alice", account("bob"), rng.randint(1, 30), 1, rng.randint(0, 2)))
        blocks.append(mine_child(parent, tuple(txs), ts_offset=rng.randint(1, 9)))
    order = blocks[1:]
    rng.shuffle(order)
    return None, [b1, *order]


SEQUENCES = {
    "linear": seq_linear,
    "duplicate": seq_duplicate,
    "invalid": seq_invalid,
    "shorter_fork": seq_shorter_fork,
    "reorg": seq_reorg,
    "tiebreak": seq_tiebreak,
    "orphans": seq_orphans,
    "spends": seq_spends,
    "invalid_descendants": seq_invalid_descendants,
    "reorg_ledger": seq_reorg_ledger,
    "rejected_structure": seq_rejected_structure,
    "batch_signatures": seq_batch_signatures,
    "random_dag_1": seq_random_dag,
    "random_dag_2": seq_random_dag,
    "random_dag_ledger_1": seq_random_dag_ledger,
    "random_dag_ledger_2": seq_random_dag_ledger,
}


def _run(name: str) -> Pair:
    rng = random.Random(name)
    genesis, blocks = SEQUENCES[name](rng)
    pair = Pair(genesis.header.difficulty if genesis is not None else DIFF, genesis=genesis)
    for block in blocks:
        pair.add(block)
    return pair


class TestChainParity:
    @pytest.mark.parametrize("name", sorted(SEQUENCES))
    def test_same_outcomes_and_state(self, name):
        pair = _run(name)
        pair.assert_same_state()

    def test_rejections_name_the_reference_reason(self):
        pair = _run("rejected_structure")
        reasons = [r for s, r in pair.statuses if s != "accepted"]
        assert reasons == [
            "duplicate txid in block",
            "coinbase transaction must be first and unique",
            "coinbase mints 51, subsidy is 50",
            "bad transaction signature",
            "transaction signed for a different chain",
            "transaction signed for a different chain",
            "bad transaction signature",
            "bad transaction signature",
            "coinbase must be unsigned",
            "coinbase transaction must be first and unique",
        ]
        assert pair.statuses[-1] == ("accepted", "")

    def test_batch_block_reaches_the_device_rung(self):
        keys.STATS.reset()
        pair = _run("batch_signatures")
        assert keys.STATS.backends["device"] >= 10
        assert [s for s, _ in pair.statuses] == ["accepted", "rejected", "accepted"]
        assert pair.statuses[1][1] == "bad transaction signature"

    def test_reorg_moves_tip_to_heavier_fork(self):
        pair = _run("reorg")
        assert pair.port.height == 5
        assert pair.statuses[-1][0] == "accepted"
        assert {b.header.version for b in pair.port.main_chain() if b.txs} == {2}

    def test_orphans_cascade_into_the_main_chain(self):
        pair = _run("orphans")
        assert [s for s, _ in pair.statuses[:4]] == ["orphan"] * 4
        assert pair.port.height == 5

    def test_tiebreak_is_order_independent(self):
        rng = random.Random(7)
        _, blocks = seq_tiebreak(rng)
        tips = set()
        for order in (blocks, blocks[::-1], blocks[1:] + blocks[:1]):
            port = Chain(DIFF)
            for b in order:
                port.add_block(to_port(b))
            tips.add(port.tip_hash)
        assert len(tips) == 1


class TestOrphanPoolParity:
    def test_flood_is_bounded_and_chain_still_extends(self):
        diff = 2
        pair = Pair(diff)
        rng = random.Random(3)
        for i in range(MAX_ORPHANS + 40):
            header = RefHeader(1, rng.randbytes(32), bytes(32), i + 1, diff, 0)
            res = pair.add(RefBlock(_REF_MINER.search_nonce(header), ()))
            assert res.status is RefStatus.ORPHAN
        port = pair.port
        assert len(port._orphan_hashes) == len(pair.ref._orphan_hashes) <= MAX_ORPHANS
        assert sum(len(v) for v in port._orphans.values()) <= MAX_ORPHANS
        assert pair.add(mine_child(pair.genesis)).status is RefStatus.ACCEPTED
        assert port.height == 1

    def test_orphan_without_pow_rejected_not_parked(self):
        pair = Pair(20)
        header = RefHeader(1, os.urandom(32), bytes(32), 1, 20, 0)
        assert pair.add(RefBlock(header, ())).status is RefStatus.REJECTED
        assert not pair.port._orphan_hashes

    def test_reparked_orphan_not_duplicated(self):
        pair = Pair(2)
        sealed = _REF_MINER.search_nonce(RefHeader(1, bytes(range(32)), bytes(32), 1, 2, 0))
        orphan = RefBlock(sealed, ())
        pair.add(orphan)
        res = pair.add(orphan)
        assert res.status is RefStatus.ORPHAN and res.reason == "already parked"
        assert len(pair.port._orphan_hashes) == 1


class TestLedgerUnitParity:
    def _blocks(self):
        g, b1 = _funded("alice")
        b2 = mine_child(b1, (cb("m", 2), ref_stx("alice", account("bob"), 20, 2, 0)))
        return b1, b2

    def test_apply_undo_round_trip(self):
        b1, b2 = self._blocks()
        ref, port = RefLedger(), Ledger()
        for blk in (b1, b2):
            ref.apply_block(blk)
            port.apply_block(to_port(blk))
            assert port.snapshot() == ref.snapshot()
            assert port.nonces_snapshot() == ref.nonces_snapshot()
        ref.undo_block(b2)
        port.undo_block(to_port(b2))
        assert port.snapshot() == ref.snapshot() == {account("alice"): 50}

    def test_apply_is_transactional(self):
        b1, _ = self._blocks()
        over = mine_child(b1, (cb("m", 2), ref_stx("alice", account("bob"), 500, 1, 0)))
        ref, port = RefLedger(), Ledger()
        ref.apply_block(b1)
        port.apply_block(to_port(b1))
        with pytest.raises(RefLedgerError) as want:
            ref.apply_block(over)
        with pytest.raises(LedgerError) as got:
            port.apply_block(to_port(over))
        assert str(got.value) == str(want.value)
        assert port.snapshot() == ref.snapshot()

    def test_intra_block_credit_is_spendable(self):
        g = ref_make_genesis(DIFF)
        blk = mine_child(g, (cb(account("alice"), 1), ref_stx("alice", account("bob"), 10, 1, 0)))
        ref, port = RefLedger(), Ledger()
        ref.apply_block(blk)
        port.apply_block(to_port(blk))
        assert port.snapshot() == ref.snapshot()


class TestTrustedResumeParity:
    def _store(self, tmp_path):
        pair = Pair()
        alice = account("alice")
        tip = pair.genesis
        for h in range(1, 9):
            txs = [RefTx.coinbase(alice, h)]
            if h > 2:
                txs.append(ref_stx("alice", account("bob"), 2, 1, h - 3))
            tip = mine_child(tip, txs)
            assert pair.add(tip).status is RefStatus.ACCEPTED
        side = mine_child(pair.ref.get(tip.header.prev_hash), (cb("m2", 8),), ts_offset=2)
        pair.add(side)
        path = tmp_path / "chain.dat"
        store = ChainStore(path)
        for blk in pair.blocks:
            store.append(to_port(blk))
        store.close()
        return pair, path

    def test_trusted_equals_full_validation(self, tmp_path):
        pair, path = self._store(tmp_path)
        full = ChainStore(path).load_chain(DIFF)
        fast = ChainStore(path).load_chain(DIFF, trusted=True)
        ref_full = RefStore(path).load_chain(DIFF)
        assert fast.tip_hash == full.tip_hash == ref_full.tip_hash == pair.ref.tip_hash
        assert len(fast) == len(full) == len(pair.ref)
        assert fast.balances_snapshot() == full.balances_snapshot() == ref_full.balances_snapshot()
        alice = account("alice")
        assert fast.nonce(alice) == full.nonce(alice) == pair.ref.nonce(alice)

    def test_trusted_still_enforces_contextual_rules(self, tmp_path):
        other = RefChain(DIFF + 1)
        b = mine_child(other.genesis, (cb("m", 1),))
        path = tmp_path / "foreign.dat"
        store = ChainStore(path)
        store.append(to_port(b))
        store.close()
        with pytest.raises(ValueError, match="do not connect") as got:
            ChainStore(path).load_chain(DIFF, trusted=True)
        with pytest.raises(ValueError) as want:
            RefStore(path).load_chain(DIFF, trusted=True)
        assert str(got.value) == str(want.value)


class TestRetarget:
    def test_retargeting_chain_matches(self):
        rule = RefRule.from_params(4, 30)
        g = ref_make_genesis(DIFF, rule)
        pair = Pair(DIFF, genesis=g, retarget=rule)
        tip = g
        for h in range(1, 10):
            want = pair.ref.next_difficulty()
            tip = mine_child(tip, (cb("m", h),), ts_offset=5 if h < 6 else 90, difficulty=want)
            assert pair.add(tip).status is RefStatus.ACCEPTED
        late = mine_child(tip, (cb("m", 10),), difficulty=pair.ref.next_difficulty() + 1)
        pair.add(late)
        assert pair.port.next_difficulty() == pair.ref.next_difficulty()
        assert pair.port.tip_hash == pair.ref.tip_hash
        assert pair.port.balances_snapshot() == pair.ref.balances_snapshot()


class TestSyncSurfaces:
    def test_headers_and_blocks_after_locators(self):
        pair = _run("reorg")
        for loc in ([pair.genesis.block_hash()], pair.ref.locator()[-2:], []):
            assert _hashes(pair.port.blocks_after(loc, limit=3)) == _hashes(pair.ref.blocks_after(loc, limit=3))
            assert pair.port.sync_start_height(loc) == pair.ref.sync_start_height(loc)
            got = pair.port.headers_after(loc)
            want = pair.ref.headers_after(loc)
            assert [h.serialize() for h in got] == [h.serialize() for h in want]

    def test_snapshot_state_and_tx_proofs(self):
        pair = _run("spends")
        for interval in (1, 2, 3):
            pair.port.checkpoint_interval = pair.ref.checkpoint_interval = interval
            got, want = pair.port.snapshot_state(), pair.ref.snapshot_state()
            assert (got[0], got[1].serialize(), *got[2:]) == (want[0], want[1].serialize(), *want[2:])
        txids = [tx.txid() for b in pair.blocks for tx in b.txs]
        got, want = pair.port.tx_proofs(txids), pair.ref.tx_proofs(txids)
        assert {k: v is None for k, v in got.items()} == {k: v is None for k, v in want.items()}


class TestReplayPacked:
    """``replay_packed`` / ``replay_fast``: the native engine where it
    builds (``replay_host`` otherwise), with the JAX package's
    ``replay_host`` verdicts."""

    @pytest.fixture(scope="class")
    def packed(self):
        from p1_tpu.chain import generate_headers as ref_generate

        headers = ref_generate(12, DIFF, backend=ref_get_backend("cpu"))
        return b"".join(h.serialize() for h in headers)

    @pytest.mark.parametrize("flip", [None, 0, 5 * 80 + 3, 11 * 80 + 79, 7 * 80 + 75])
    def test_first_invalid_matches_reference(self, packed, flip):
        from p1_tpu.chain import parse_headers as ref_parse
        from p1_tpu.chain import replay_host as ref_replay_host
        from p1_tpu_torch.chain import parse_headers, replay_fast, replay_packed
        from p1_tpu_torch.hashx import native_backend

        raw = bytearray(packed)
        if flip is not None:
            raw[flip] ^= 0x01
        want = ref_replay_host(ref_parse(bytes(raw)))
        native_backend._lib()  # g++ is on the test hosts: the native tier runs
        for got in (replay_packed(bytes(raw)), replay_fast(parse_headers(bytes(raw)))):
            assert (got.valid, got.first_invalid, got.n_headers, got.method) == (
                want.valid, want.first_invalid, want.n_headers, "native",
            )  # fmt: skip

    @pytest.mark.parametrize("raw", [b"", b"\x00" * 79, b"\x00" * 161])
    def test_malformed_buffer_refused(self, raw):
        from p1_tpu_torch.chain import replay_packed

        with pytest.raises(ValueError, match="non-empty multiple"):
            replay_packed(raw)


# -- tests/test_chain.py's cases --------------------------------------------


class TestValidate:
    def test_valid_block_passes(self, chain_blocks):
        main, _ = chain_blocks
        check_block(main[1], DIFF)

    def test_wrong_difficulty(self, chain_blocks):
        main, _ = chain_blocks
        with pytest.raises(ValidationError, match="difficulty"):
            check_block(main[1], DIFF + 1)

    def test_bad_pow(self):
        genesis = make_genesis(DIFF)
        header = BlockHeader(
            1, genesis.block_hash(), bytes(32), genesis.header.timestamp + 1, DIFF, 0
        )
        # nonce 0 is (with overwhelming odds for this fixed header) not a hit
        from p1_tpu_torch.core import meets_target

        assert not meets_target(header.block_hash(), DIFF)
        with pytest.raises(ValidationError, match="proof of work"):
            check_block(Block(header, ()), DIFF)

    def test_merkle_mismatch(self, chain_blocks):
        main, _ = chain_blocks
        tx = Transaction("a", "b", 1, 0, 0)
        forged = Block(main[1].header, (tx,))
        with pytest.raises(ValidationError, match="merkle"):
            check_block(forged, DIFF)

    def test_duplicate_txid_rejected(self):
        # CVE-2012-2459: [t1, t2, t3, t3] shares a merkle root with
        # [t1, t2, t3] (odd tail duplicated) -- the duplicate form must be
        # rejected even though the root matches.
        genesis = make_genesis(DIFF)
        t1 = Transaction("a", "b", 1, 0, 0)
        t2 = Transaction("c", "d", 2, 0, 0)
        t3 = Transaction("e", "f", 3, 0, 0)
        dup = (t1, t2, t3, t3)
        assert merkle_root([t.txid() for t in dup]) == merkle_root(
            [t.txid() for t in (t1, t2, t3)]
        )
        block = _mine_child(genesis, txs=dup)
        with pytest.raises(ValidationError, match="duplicate txid"):
            check_block(block, DIFF)

    def test_genesis_pow_waived(self):
        check_block(make_genesis(DIFF), DIFF, is_genesis=True)

    def test_coinbase_first_ok(self):
        genesis = make_genesis(DIFF)
        cb = Transaction.coinbase("miner-a", 1)
        tx = stx("a", "b", 1, 0, 0)
        check_block(_mine_child(genesis, txs=(cb, tx)), DIFF)

    def test_coinbase_not_first_rejected(self):
        genesis = make_genesis(DIFF)
        cb = Transaction.coinbase("miner-a", 1)
        tx = stx("a", "b", 1, 0, 0)
        block = _mine_child(genesis, txs=(tx, cb))
        with pytest.raises(ValidationError, match="coinbase"):
            check_block(block, DIFF)

    def test_coinbase_wrong_subsidy_rejected(self):
        # A hostile miner must not mint an arbitrary
        # reward — the coinbase amount is consensus-fixed.
        genesis = make_genesis(DIFF)
        cb = Transaction.coinbase("miner-a", 1, reward=10_000)
        block = _mine_child(genesis, txs=(cb,))
        with pytest.raises(ValidationError, match="subsidy"):
            check_block(block, DIFF)

    def test_unsigned_transfer_rejected(self):
        import dataclasses

        from p1_tpu_torch.core.genesis import genesis_hash

        genesis = make_genesis(DIFF)
        # Right chain tag, no proof at all: the signature check must fire.
        naked = dataclasses.replace(
            Transaction("a", "b", 1, 0, 0), chain=genesis_hash(DIFF)
        )
        block = _mine_child(genesis, txs=(naked,))
        with pytest.raises(ValidationError, match="signature"):
            check_block(block, DIFF)

    def test_untagged_transfer_rejected(self):
        # A tx with no chain binding (or any foreign tag) is refused even
        # if its signature is internally valid — cross-chain replays die
        # here.
        from txutil import key_for

        genesis = make_genesis(DIFF)
        untagged = Transaction.transfer(key_for("a"), "b", 1, 0, 0)  # chain=b""
        block = _mine_child(genesis, txs=(untagged,))
        with pytest.raises(ValidationError, match="different chain"):
            check_block(block, DIFF)

    def test_cross_chain_replay_rejected(self):
        # A spend validly signed for the difficulty-12 chain, replayed
        # byte-identically on the difficulty-8 chain: rejected by tag.
        genesis = make_genesis(DIFF)
        foreign = stx("a", "b", 1, 0, 0, difficulty=12)
        assert foreign.verify_signature()  # internally valid...
        block = _mine_child(genesis, txs=(foreign,))
        with pytest.raises(ValidationError, match="different chain"):
            check_block(block, DIFF)  # ...but not for THIS chain

    def test_forged_sender_rejected(self):
        # mallory signs with HER key but claims alice's account as sender:
        # the fingerprint check must catch the mismatch.
        import dataclasses

        from txutil import account, key_for
        from p1_tpu_torch.core.genesis import genesis_hash

        genesis = make_genesis(DIFF)
        mallory = key_for("mallory")
        theft = Transaction(
            account("alice"), mallory.account, 1, 0, 0, chain=genesis_hash(DIFF)
        )
        theft = dataclasses.replace(
            theft, pubkey=mallory.pubkey, sig=mallory.sign(theft.signing_bytes())
        )
        block = _mine_child(genesis, txs=(theft,))
        with pytest.raises(ValidationError, match="signature"):
            check_block(block, DIFF)

    def test_tampered_amount_rejected(self):
        # A validly signed tx whose amount is bumped after signing.
        import dataclasses

        genesis = make_genesis(DIFF)
        tampered = dataclasses.replace(stx("a", "b", 1, 0, 0), amount=40)
        block = _mine_child(genesis, txs=(tampered,))
        with pytest.raises(ValidationError, match="signature"):
            check_block(block, DIFF)

    def test_signed_coinbase_rejected(self):
        # Coinbases are minted by consensus, not spent by an owner — one
        # carrying key material is malformed.
        import dataclasses

        from txutil import key_for

        genesis = make_genesis(DIFF)
        key = key_for("miner")
        cb = Transaction.coinbase("miner-a", 1)
        cb = dataclasses.replace(
            cb, pubkey=key.pubkey, sig=key.sign(cb.signing_bytes())
        )
        block = _mine_child(genesis, txs=(cb,))
        with pytest.raises(ValidationError, match="unsigned"):
            check_block(block, DIFF)

    def test_two_coinbases_rejected(self):
        genesis = make_genesis(DIFF)
        cb1 = Transaction.coinbase("miner-a", 1)
        cb2 = Transaction.coinbase("miner-b", 1)
        block = _mine_child(genesis, txs=(cb1, cb2))
        with pytest.raises(ValidationError, match="coinbase"):
            check_block(block, DIFF)


class TestOrphanPool:
    """A hostile peer flooding unconnectable blocks must not grow memory:
    orphans need their own valid PoW to park, the pool is FIFO-capped, and
    re-received orphans are not double-parked."""

    def test_flood_is_bounded_and_chain_still_extends(self):
        import os

        from p1_tpu_torch.chain.chain import MAX_ORPHANS

        diff = 2  # ~4 hashes per orphan: 10k mined orphans stay cheap
        chain = Chain(diff)
        miner = Miner(backend=get_backend("cpu"))
        for i in range(10_000):
            header = BlockHeader(1, os.urandom(32), bytes(32), i + 1, diff, 0)
            sealed = miner.search_nonce(header)
            assert sealed is not None
            res = chain.add_block(Block(sealed, ()))
            assert res.status is AddStatus.ORPHAN
        assert len(chain._orphan_hashes) <= MAX_ORPHANS
        assert len(chain._orphan_fifo) <= MAX_ORPHANS
        assert sum(len(v) for v in chain._orphans.values()) <= MAX_ORPHANS
        # the chain is unharmed: a legitimate child still connects
        child = _mine_child(chain.genesis)
        assert chain.add_block(child).status is AddStatus.ACCEPTED
        assert chain.height == 1

    def test_orphan_without_pow_rejected_not_parked(self):
        import os

        chain = Chain(20)
        header = BlockHeader(1, os.urandom(32), bytes(32), 1, 20, 0)
        res = chain.add_block(Block(header, ()))  # nonce 0: no PoW at d20
        assert res.status is AddStatus.REJECTED
        assert not chain._orphan_hashes

    def test_reparked_orphan_not_duplicated(self):
        import os

        diff = 2
        chain = Chain(diff)
        miner = Miner(backend=get_backend("cpu"))
        header = BlockHeader(1, os.urandom(32), bytes(32), 1, diff, 0)
        sealed = miner.search_nonce(header)
        orphan = Block(sealed, ())
        assert chain.add_block(orphan).status is AddStatus.ORPHAN
        res = chain.add_block(orphan)
        assert res.status is AddStatus.ORPHAN and res.reason == "already parked"
        assert len(chain._orphan_hashes) == 1
        assert sum(len(v) for v in chain._orphans.values()) == 1


class TestForkChoice:
    def test_linear_growth(self, chain_blocks):
        main, _ = chain_blocks
        chain = Chain(DIFF, genesis=main[0])
        for block in main[1:]:
            res = chain.add_block(block)
            assert res.status is AddStatus.ACCEPTED
            assert res.added == (block,)
            assert res.removed == ()
        assert chain.height == 3
        assert chain.tip == main[3]
        assert list(chain.main_chain()) == main

    def test_duplicate(self, chain_blocks):
        main, _ = chain_blocks
        chain = Chain(DIFF, genesis=main[0])
        chain.add_block(main[1])
        assert chain.add_block(main[1]).status is AddStatus.DUPLICATE

    def test_invalid_rejected(self, chain_blocks):
        main, _ = chain_blocks
        chain = Chain(DIFF, genesis=main[0])
        bad = Block(main[1].header, (Transaction("a", "b", 1, 0, 0),))
        res = chain.add_block(bad)
        assert res.status is AddStatus.REJECTED
        assert "merkle" in res.reason

    def test_shorter_fork_does_not_move_tip(self, chain_blocks):
        main, fork = chain_blocks
        chain = Chain(DIFF, genesis=main[0])
        for block in main[1:]:
            chain.add_block(block)
        res = chain.add_block(fork[1])  # height 1 vs tip height 3
        assert res.status is AddStatus.ACCEPTED
        assert not res.tip_changed
        assert chain.tip == main[3]

    def test_reorg_to_heavier_fork(self, chain_blocks):
        main, fork = chain_blocks
        chain = Chain(DIFF, genesis=main[0])
        for block in main[1:]:
            chain.add_block(block)
        # Strictly lighter fork blocks never move the tip.
        for block in fork[1:3]:
            assert not chain.add_block(block).tip_changed
        # Equal work at height 3: deterministic tie-break by smaller hash.
        chain.add_block(fork[3])
        expected_at_tie = min(main[3], fork[3], key=lambda b: b.block_hash())
        assert chain.tip == expected_at_tie
        # fork[4] is strictly heavier: tip must be fork[4] on every node.
        res = chain.add_block(fork[4])
        assert chain.tip == fork[4]
        assert chain.height == 4
        if expected_at_tie is main[3]:  # the reorg happened just now
            assert res.removed == tuple(reversed(main[1:]))
            assert res.added == tuple(fork[1:5])

    def test_equal_work_tiebreak_is_order_independent(self, chain_blocks):
        # Two nodes seeing the same blocks in different orders must agree.
        main, fork = chain_blocks
        a = Chain(DIFF, genesis=main[0])
        b = Chain(DIFF, genesis=main[0])
        blocks = main[1:4] + fork[1:4]
        for block in blocks:
            a.add_block(block)
        for block in reversed(blocks):
            b.add_block(block)
        assert a.tip_hash == b.tip_hash

    def test_connected_reports_cascaded_orphans(self, chain_blocks):
        # Persistence appends res.connected; it must include orphans the
        # triggering block unblocked, or restarts lose the chain suffix.
        main, _ = chain_blocks
        chain = Chain(DIFF, genesis=main[0])
        chain.add_block(main[2])  # orphan
        chain.add_block(main[3])  # orphan
        res = chain.add_block(main[1])
        assert res.connected == (main[1], main[2], main[3])
        plain = chain.add_block(_mine_child(main[3], ts_offset=99))
        assert len(plain.connected) == 1

    def test_orphan_then_connect(self, chain_blocks):
        main, _ = chain_blocks
        chain = Chain(DIFF, genesis=main[0])
        assert chain.add_block(main[2]).status is AddStatus.ORPHAN
        assert chain.add_block(main[3]).status is AddStatus.ORPHAN
        assert chain.height == 0
        res = chain.add_block(main[1])  # parent arrives: cascade connects
        assert res.status is AddStatus.ACCEPTED
        assert chain.height == 3
        assert res.added == tuple(main[1:])
        assert chain.tip == main[3]

    def test_locator_and_blocks_after(self, chain_blocks):
        main, _ = chain_blocks
        chain = Chain(DIFF, genesis=main[0])
        for block in main[1:]:
            chain.add_block(block)
        loc = chain.locator()
        assert loc[0] == chain.tip_hash
        assert loc[-1] == main[0].block_hash()
        peer = Chain(DIFF, genesis=main[0])
        missing = chain.blocks_after(peer.locator())
        assert missing == main[1:]


class TestPersistence:
    def test_roundtrip(self, chain_blocks, tmp_path):
        main, fork = chain_blocks
        store = ChainStore(tmp_path / "chain.dat")
        chain = Chain(DIFF, genesis=main[0])
        for block in main[1:] + fork[1:]:
            res = chain.add_block(block)
            if res.status is AddStatus.ACCEPTED:
                store.append(block)
        store.close()

        resumed = ChainStore(tmp_path / "chain.dat").load_chain(DIFF)
        assert resumed.tip_hash == chain.tip_hash
        assert resumed.height == chain.height
        assert len(resumed) == len(chain)  # side branches survive too

    def test_truncated_tail_recovers(self, chain_blocks, tmp_path):
        main, _ = chain_blocks
        path = tmp_path / "chain.dat"
        store = ChainStore(path)
        for block in main[1:]:
            store.append(block)
        store.close()
        raw = path.read_bytes()
        path.write_bytes(raw[:-7])  # crash mid-append
        resumed = ChainStore(path).load_chain(DIFF)
        assert resumed.height == 2  # last whole record survives

    def test_append_after_truncated_tail(self, chain_blocks, tmp_path):
        # Appending to a store with a garbage partial tail must first drop
        # the tail, or its stale length prefix poisons every later load.
        main, _ = chain_blocks
        path = tmp_path / "chain.dat"
        store = ChainStore(path)
        store.append(main[1])
        store.append(main[2])
        store.close()
        path.write_bytes(path.read_bytes()[:-7])  # crash mid-append of [2]
        store = ChainStore(path)
        store.append(main[2])
        store.append(main[3])
        store.close()
        resumed = ChainStore(path).load_chain(DIFF)
        assert resumed.height == 3
        assert resumed.tip_hash == main[3].block_hash()

    def test_save_chain_snapshot(self, chain_blocks, tmp_path):
        main, _ = chain_blocks
        chain = Chain(DIFF, genesis=main[0])
        for block in main[1:]:
            chain.add_block(block)
        save_chain(chain, tmp_path / "snap.dat")
        resumed = ChainStore(tmp_path / "snap.dat").load_chain(DIFF)
        assert list(resumed.main_chain()) == main

    def test_wrong_magic(self, tmp_path):
        path = tmp_path / "junk.dat"
        path.write_bytes(b"not a chain store")
        with pytest.raises(ValueError, match="not a chain store"):
            ChainStore(path).load_blocks()

    def test_append_fsyncs_every_block(self, chain_blocks, tmp_path, monkeypatch):
        # Durability contract: an acknowledged append
        # must survive OS crash, so fsync runs once per append — and the
        # fsync=False escape hatch really skips it.
        import os as os_mod

        main, _ = chain_blocks
        calls = []
        real_fsync = os_mod.fsync
        monkeypatch.setattr(
            "p1_tpu_torch.chain.store.os.fsync",
            lambda fd: (calls.append(fd), real_fsync(fd))[1],
        )
        store = ChainStore(tmp_path / "sync.dat")
        store.append(main[1])
        store.append(main[2])
        store.close()
        assert len(calls) == 2
        store = ChainStore(tmp_path / "nosync.dat", fsync=False)
        store.append(main[1])
        store.close()
        assert len(calls) == 2  # unchanged


class TestLedger:
    def test_balances_over_mined_chain(self):
        from p1_tpu_torch.chain import balances

        genesis = make_genesis(DIFF)
        alice, bob = account("alice"), account("bob")
        cb1 = Transaction.coinbase(alice, 1)
        b1 = _mine_child(genesis, txs=(cb1,))
        # alice pays bob 20 (fee 2) in a block mined by carol.
        cb2 = Transaction.coinbase("carol", 2)
        pay = stx("alice", bob, 20, 2, 0)
        b2 = _mine_child(b1, txs=(cb2, pay))
        ledger = balances([genesis, b1, b2])
        assert ledger[alice] == 50 - 20 - 2
        assert ledger[bob] == 20
        assert ledger["carol"] == 50 + 2  # reward + fees
        assert sum(ledger.values()) == 100  # rewards minted, fees conserved
        # The audit view agrees with the consensus ledger on a real chain.
        chain = Chain(DIFF, genesis=genesis)
        assert chain.add_block(b1).status is AddStatus.ACCEPTED
        assert chain.add_block(b2).status is AddStatus.ACCEPTED
        assert chain.balances_snapshot() == {
            a: v for a, v in ledger.items() if v
        }

    def test_coinbase_less_block_burns_fees(self):
        # Pure-view property on a hypothetical block sequence: the view
        # never rejects (consensus would - alice is unfunded), and a
        # coinbase-less block's fees are credited to nobody.
        from p1_tpu_torch.chain import balances

        genesis = make_genesis(DIFF)
        alice, bob = account("alice"), account("bob")
        pay = stx("alice", bob, 5, 3, 0)
        b1 = _mine_child(genesis, txs=(pay,))
        ledger = balances([genesis, b1])
        assert ledger[alice] == -8 and ledger[bob] == 5
        assert sum(ledger.values()) == -3  # the fee is burned

    def test_cli_balances_from_store(self, tmp_path):
        import json as json_mod
        import subprocess
        import sys

        from p1_tpu_torch.chain import Chain, save_chain

        genesis = make_genesis(DIFF)
        chain = Chain(DIFF, genesis=genesis)
        alice = account("alice")
        cb = Transaction.coinbase(alice, 1)
        chain.add_block(_mine_child(genesis, txs=(cb,)))
        store = tmp_path / "chain.dat"
        save_chain(chain, store)
        proc = subprocess.run(
            [
                sys.executable, "-m", "p1_tpu_torch", "balances",
                "--store", str(store), "--difficulty", str(DIFF),
                "--account", alice,
            ],
            capture_output=True,
            text=True,
            timeout=110,
            cwd=REPO,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        out = json_mod.loads(proc.stdout.strip())
        assert out["balance"] == 50 and out["height"] == 1


class TestCrashRecovery:
    def test_sigkill_mid_mining_then_restart(self, tmp_path):
        """Real fault injection: SIGKILL a mining node process
        and restart on the same store — the log must replay to a valid
        chain (possibly minus a torn tail record) and keep growing."""
        import json
        import os
        import signal
        import subprocess
        import sys
        import time

        store = tmp_path / "crash.dat"
        env = dict(os.environ)
        repo_root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
        cmd = [
            sys.executable, "-m", "p1_tpu_torch", "node",
            "--port", "0", "--difficulty", "10", "--backend", "cpu", "--device", "cpu",
            "--store", str(store), "--duration", "60",
        ]
        err_path = tmp_path / "node.err"
        with open(err_path, "w") as err_fh:
            proc = subprocess.Popen(
                cmd, env=env, cwd=repo_root,
                stdout=subprocess.DEVNULL, stderr=err_fh,
            )
            try:
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    if proc.poll() is not None:  # died at startup: fail fast
                        raise AssertionError(
                            f"node exited rc={proc.returncode}: "
                            f"{err_path.read_text()[-2000:]}"
                        )
                    if store.exists() and store.stat().st_size > 2000:
                        break
                    time.sleep(0.1)
                else:
                    raise AssertionError(
                        "node never persisted blocks: "
                        f"{err_path.read_text()[-2000:]}"
                    )
            finally:
                proc.send_signal(signal.SIGKILL)
                proc.wait(timeout=30)

        # Restart on the possibly-torn store: it must resume and extend.
        out = subprocess.run(
            [
                sys.executable, "-m", "p1_tpu_torch", "node",
                "--port", "0", "--difficulty", "10", "--backend", "cpu", "--device", "cpu",
                "--store", str(store), "--duration", "2",
            ],
            env=env, cwd=repo_root,
            capture_output=True, text=True, timeout=110,
        )
        assert out.returncode == 0, out.stderr[-2000:]
        status = json.loads(out.stdout.strip().splitlines()[-1])
        assert status["height"] > 0
        # And the final store must audit clean.
        resumed = ChainStore(store).load_chain(10)
        assert resumed.height >= status["height"] - 1

    def test_store_mutation_fuzz_fails_closed(self, chain_blocks, tmp_path):
        """Arbitrary corruption of a store must degrade, not explode, on
        BOTH paths the node restart uses: ``acquire()`` (which converts
        corruption to RuntimeError or truncates the torn tail under the
        lock) and ``load_chain`` (which re-validates every surviving
        record).  Whatever loads must be a prefix-consistent valid chain."""
        import random as rnd

        main, fork = chain_blocks
        path = tmp_path / "fuzz.dat"
        store = ChainStore(path)
        for block in main[1:] + fork[1:]:
            store.append(block)
        store.close()
        seed_bytes = path.read_bytes()
        seed_height = ChainStore(path).load_chain(DIFF).height

        rng = rnd.Random(11)
        for _ in range(300):
            buf = bytearray(seed_bytes)
            op = rng.randrange(3)
            if op == 0:
                buf = buf[: rng.randrange(len(buf))]
            elif op == 1:
                buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
            else:
                buf += bytes(rng.randrange(1, 16))
            path.write_bytes(bytes(buf))
            # Path 1: the node's restart sequence (lock + tail-truncate).
            writer = ChainStore(path)
            try:
                writer.acquire()
            except RuntimeError:
                writer.close()
                path.write_bytes(bytes(buf))  # undo any partial truncation
            else:
                writer.close()
            # Path 2: plain read-side load of whatever is on disk now.
            try:
                chain = ChainStore(path).load_chain(DIFF)
            except ValueError:
                continue  # fails closed
            # Whatever loaded must be internally consistent and no taller
            # than the uncorrupted original.
            assert chain.height <= seed_height
            assert len(list(chain.main_chain())) == chain.height + 1


class TestCompact:
    def test_cli_compact_drops_side_branches(self, tmp_path):
        import json as json_mod
        import subprocess
        import sys

        genesis = make_genesis(DIFF)
        main = [genesis]
        for _ in range(4):
            main.append(_mine_child(main[-1]))
        fork = _mine_child(genesis, version=2)  # loses fork choice
        store_path = tmp_path / "chain.dat"
        store = ChainStore(store_path)
        for block in [*main[1:3], fork, *main[3:]]:
            store.append(block)
        store.close()

        proc = subprocess.run(
            [
                sys.executable, "-m", "p1_tpu_torch", "compact",
                "--store", str(store_path),
            ],
            capture_output=True,
            text=True,
            timeout=110,
            cwd=REPO,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        out = json_mod.loads(proc.stdout.strip())
        assert out["height"] == 4
        assert out["records_before"] == 5  # 4 main + 1 fork (no genesis rec)
        assert out["records_after"] == 5  # genesis + 4 main
        # The compacted store reloads to the same tip, fork gone.
        reloaded = ChainStore(store_path).load_chain(DIFF)
        assert reloaded.tip_hash == main[-1].block_hash()
        assert len(reloaded) == 5


    def test_compact_refuses_locked_store(self, tmp_path):
        import subprocess
        import sys

        genesis = make_genesis(DIFF)
        store_path = tmp_path / "live.dat"
        writer = ChainStore(store_path)
        writer.append(_mine_child(genesis))  # holds the writer flock
        try:
            proc = subprocess.run(
                [
                    sys.executable, "-m", "p1_tpu_torch", "compact",
                    "--store", str(store_path),
                ],
                capture_output=True,
                text=True,
                timeout=110,
                cwd=REPO,
            )
            assert proc.returncode == 2
            assert "locked by another process" in proc.stderr
        finally:
            writer.close()

    def test_second_writer_refused(self, tmp_path):
        genesis = make_genesis(DIFF)
        store_path = tmp_path / "one_writer.dat"
        a = ChainStore(store_path)
        a.append(_mine_child(genesis))
        b = ChainStore(store_path)
        try:
            with pytest.raises(RuntimeError, match="locked"):
                b.append(_mine_child(genesis, ts_offset=2))
        finally:
            a.close()


class TestForkChoiceProperty:
    """Randomized property test (SURVEY §5): for ANY block DAG delivered in
    ANY order, every node converges to the same tip, and that tip is the
    brute-force best (max cumulative work, lexicographically smallest hash
    on ties).  Exercises orphan parking, cascaded connects, and reorgs far
    beyond the hand-written cases."""

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_random_dag_converges_to_brute_force_best(self, seed):
        import random as rnd

        rng = rnd.Random(seed)
        diff = 2
        genesis = make_genesis(diff)
        blocks = [genesis]
        heights = {genesis.block_hash(): 0}
        for i in range(60):
            parent = rng.choice(blocks)
            # Distinct sibling blocks via a unique coinbase-style tx.
            tx = Transaction("coinbase", f"m{seed}", 50, 0, i)
            child = _mine_child(parent, txs=(tx,), ts_offset=rng.randint(1, 9))
            blocks.append(child)
            heights[child.block_hash()] = heights[parent.block_hash()] + 1

        # Brute-force best: max height (fixed difficulty => work ~ height),
        # tie-break smallest hash.
        best_h = max(heights.values())
        expect_tip = min(
            b.block_hash() for b in blocks if heights[b.block_hash()] == best_h
        )

        non_genesis = blocks[1:]
        tips = set()
        for trial in range(3):
            order = non_genesis[:]
            rng.shuffle(order)
            chain = Chain(diff, genesis=genesis)
            for block in order:
                chain.add_block(block)
            assert chain.height == best_h
            # Every block must have connected despite arbitrary order.
            assert len(chain) == len(blocks)
            # The height index must agree with the tip walk.
            main = list(chain.main_chain())
            assert len(main) == best_h + 1
            assert main[-1].block_hash() == chain.tip_hash
            tips.add(chain.tip_hash)
        assert tips == {expect_tip}


class TestTrustedResume:
    """The fast-resume path: a node reloading its
    OWN flocked store skips the stateless checks it already ran before
    appending; the rebuilt state must be IDENTICAL to a full
    revalidation — tip, every balance, every nonce, side branches."""

    def test_trusted_equals_full_validation(self, tmp_path):
        store_path = tmp_path / "chain.dat"
        chain = Chain(DIFF)
        store = ChainStore(store_path)
        alice = account("alice")
        # A dozen blocks: coinbases to alice, signed spends, one fork.
        for h in range(1, 9):
            tip = chain.tip
            txs = [Transaction.coinbase(alice, h)]
            if h > 2:
                txs.append(
                    stx("alice", account("bob"), 2, 1, h - 3, difficulty=DIFF)
                )
            header = BlockHeader(
                1,
                tip.block_hash(),
                merkle_root([t.txid() for t in txs]),
                tip.header.timestamp + 1,
                DIFF,
                0,
            )
            sealed = _MINER.search_nonce(header)
            res = chain.add_block(Block(sealed, tuple(txs)))
            assert res.status is AddStatus.ACCEPTED
            store.append(chain.tip)
        # A surviving side branch too.
        fork_parent = chain.get(chain.tip.header.prev_hash)
        side = Block(
            _MINER.search_nonce(
                BlockHeader(
                    1,
                    fork_parent.block_hash(),
                    merkle_root([Transaction.coinbase("m2", 8).txid()]),
                    fork_parent.header.timestamp + 2,
                    DIFF,
                    0,
                )
            ),
            (Transaction.coinbase("m2", 8),),
        )
        assert chain.add_block(side).status is AddStatus.ACCEPTED
        store.append(side)
        store.close()

        full = ChainStore(store_path).load_chain(DIFF)
        fast = ChainStore(store_path).load_chain(DIFF, trusted=True)
        assert fast.tip_hash == full.tip_hash == chain.tip_hash
        assert fast.height == full.height
        assert len(fast) == len(full) == len(chain)  # side branch kept
        assert fast.balances_snapshot() == full.balances_snapshot()
        assert fast.nonce(alice) == full.nonce(alice) == chain.nonce(alice)

    def test_trusted_still_enforces_contextual_rules(self, tmp_path):
        """Trust covers only what this node already checked; contextual
        linking still runs, so a record stream from a DIFFERENT chain
        cannot silently graft on (the none-connected guard fires)."""
        other = Chain(DIFF + 1)
        b = Block(
            _MINER.search_nonce(
                BlockHeader(
                    1,
                    other.genesis.block_hash(),
                    merkle_root([Transaction.coinbase("m", 1).txid()]),
                    other.genesis.header.timestamp + 1,
                    DIFF + 1,
                    0,
                )
            ),
            (Transaction.coinbase("m", 1),),
        )
        assert other.add_block(b).status is AddStatus.ACCEPTED
        path = tmp_path / "foreign.dat"
        store = ChainStore(path)
        store.append(b)
        store.close()
        with pytest.raises(ValueError, match="do not connect"):
            ChainStore(path).load_chain(DIFF, trusted=True)


# -- tests/test_consensus.py's cases ----------------------------------------


class TestLedgerUnit:
    def test_apply_undo_round_trip(self):
        genesis = make_genesis(DIFF)
        alice = account("alice")
        b1 = _mine_child(genesis, txs=(Transaction.coinbase(alice, 1),))
        b2 = _mine_child(
            b1,
            txs=(
                Transaction.coinbase("miner", 2),
                stx("alice", "bob", 20, 2, 0),
            ),
        )
        ledger = Ledger()
        for b in (genesis, b1, b2):
            ledger.apply_block(b)
        assert ledger.balance(alice) == 28
        assert ledger.balance("miner") == 52
        ledger.undo_block(b2)
        ledger.undo_block(b1)
        assert ledger.snapshot() == {}

    def test_apply_is_transactional(self):
        # A block whose SECOND transfer overdraws must leave no trace of
        # its first.
        genesis = make_genesis(DIFF)
        alice = account("alice")
        b1 = _mine_child(genesis, txs=(Transaction.coinbase(alice, 1),))
        bad = _mine_child(
            b1,
            txs=(
                stx("alice", "bob", 10, 0, 0),
                stx("alice", "bob", 1000, 0, 1),  # overdraws
            ),
        )
        ledger = Ledger()
        ledger.apply_block(b1)
        before = ledger.snapshot()
        with pytest.raises(LedgerError, match="overdraws"):
            ledger.apply_block(bad)
        assert ledger.snapshot() == before

    def test_intra_block_credit_is_spendable(self):
        # bob spends, IN THE SAME BLOCK, coins alice sent him two txs ago
        # (in-order application, documented in ledger.py).
        genesis = make_genesis(DIFF)
        alice, bob = account("alice"), account("bob")
        b1 = _mine_child(genesis, txs=(Transaction.coinbase(alice, 1),))
        b2 = _mine_child(
            b1,
            txs=(
                stx("alice", bob, 30, 0, 0),
                stx("bob", "carol", 25, 0, 0),
            ),
        )
        ledger = Ledger()
        ledger.apply_block(b1)
        ledger.apply_block(b2)
        assert ledger.balance(bob) == 5
        assert ledger.balance("carol") == 25


class TestOverspendRejection:
    def test_overspending_block_rejected_at_tip(self):
        chain, _ = _funded_chain("alice")
        tip_before = chain.tip_hash
        bad = _mine_child(
            chain.tip, txs=(stx("alice", "bob", BLOCK_REWARD + 1, 0, 0),)
        )
        res = chain.add_block(bad)
        assert res.status is AddStatus.REJECTED
        assert "overdraws" in res.reason
        assert chain.tip_hash == tip_before
        assert chain.balance(account("alice")) == BLOCK_REWARD
        # The rejected block is not offered to persistence.
        assert res.connected == ()

    def test_spend_of_unowned_account_never_connects(self):
        # mallory cannot move alice's coins: the forged tx already fails
        # stateless validation, so it is REJECTED before ledger checks.
        from p1_tpu_torch.core.genesis import genesis_hash

        chain, _ = _funded_chain("alice")
        mallory = key_for("mallory")
        theft = Transaction(
            account("alice"), mallory.account, 10, 0, 0, chain=genesis_hash(DIFF)
        )
        theft = dataclasses.replace(
            theft, pubkey=mallory.pubkey, sig=mallory.sign(theft.signing_bytes())
        )
        res = chain.add_block(_mine_child(chain.tip, txs=(theft,)))
        assert res.status is AddStatus.REJECTED
        assert "signature" in res.reason

    def test_exact_balance_spend_connects(self):
        chain, _ = _funded_chain("alice")
        ok = _mine_child(
            chain.tip, txs=(stx("alice", "bob", BLOCK_REWARD - 3, 3, 0),)
        )
        res = chain.add_block(ok)
        assert res.status is AddStatus.ACCEPTED
        assert chain.balance(account("alice")) == 0
        assert chain.balance("bob") == BLOCK_REWARD - 3

    def test_descendants_of_invalid_block_rejected(self):
        chain, _ = _funded_chain("alice")
        bad = _mine_child(
            chain.tip, txs=(stx("alice", "bob", 9_999, 0, 0),)
        )
        assert chain.add_block(bad).status is AddStatus.REJECTED
        child = _mine_child(bad)  # internally valid, invalid ancestry
        res = chain.add_block(child)
        assert res.status is AddStatus.REJECTED
        assert "invalid" in res.reason
        assert chain.tip_hash != child.block_hash()

    def test_heavier_invalid_branch_does_not_win(self):
        # A longer branch whose FIRST block overdraws: fork choice must
        # stay on the shorter valid chain, whole branch marked invalid.
        chain, b1 = _funded_chain("alice")
        good2 = _mine_child(chain.tip)
        assert chain.add_block(good2).status is AddStatus.ACCEPTED
        bad2 = _mine_child(b1, txs=(stx("alice", "bob", 999, 0, 0),), ts_offset=3)
        bad3 = _mine_child(bad2)
        bad4 = _mine_child(bad3)
        # Deliver the heavy invalid branch out of order (orphans first).
        assert chain.add_block(bad4).status is AddStatus.ORPHAN
        assert chain.add_block(bad3).status is AddStatus.ORPHAN
        res = chain.add_block(bad2)
        assert res.status is AddStatus.REJECTED
        assert chain.tip_hash == good2.block_hash()
        assert chain.balance(account("alice")) == BLOCK_REWARD

    def test_reorg_onto_branch_that_overdraws_midway(self):
        # Branch B beats branch A on work, but B's SECOND block overdraws.
        # The settle loop must roll the ledger back cleanly and keep A.
        chain, b1 = _funded_chain("alice")
        a2 = _mine_child(b1, txs=(Transaction.coinbase("ma", 2),))
        assert chain.add_block(a2).status is AddStatus.ACCEPTED
        # Branch B off b1: valid block, then an overdraw of alice's 50.
        b2 = _mine_child(b1, txs=(Transaction.coinbase("mb", 2),), ts_offset=5)
        b3 = _mine_child(b2, txs=(stx("alice", "bob", 51, 0, 0),))
        b4 = _mine_child(b3)
        chain.add_block(b2)  # side branch, ties resolved by hash — either tip ok
        chain.add_block(b3)
        chain.add_block(b4)
        # Whatever arrival order did, the settled tip must be a VALID chain
        # of height 2 (a2 or b2 by hash tie-break), never b3/b4's branch.
        assert chain.height == 2
        assert chain.tip_hash in (a2.block_hash(), b2.block_hash())
        # Ledger matches a from-scratch replay of the surviving main chain.
        assert chain.balances_snapshot() == {
            k: v for k, v in balances(chain.main_chain()).items() if v
        }

    def test_miner_replay_of_confirmed_tx_rejected(self):
        # THE same-chain replay: a hostile miner re-includes alice's
        # already-confirmed transfer in the next block.  The signature and
        # chain tag both verify — the strict account nonce is what kills
        # it (seq 0 is consumed; alice is at nonce 1).
        chain, _ = _funded_chain("alice")
        pay = stx("alice", "bob", 10, 1, 0)
        b2 = _mine_child(chain.tip, txs=(pay,))
        assert chain.add_block(b2).status is AddStatus.ACCEPTED
        assert chain.nonce(account("alice")) == 1
        replay = _mine_child(chain.tip, txs=(pay,))  # identical bytes
        res = chain.add_block(replay)
        assert res.status is AddStatus.REJECTED
        assert "replay or gap" in res.reason
        assert chain.balance("bob") == 10  # debited exactly once

    def test_seq_gap_rejected_at_consensus(self):
        chain, _ = _funded_chain("alice")
        gap = _mine_child(chain.tip, txs=(stx("alice", "bob", 5, 0, 7),))
        res = chain.add_block(gap)
        assert res.status is AddStatus.REJECTED
        assert "replay or gap" in res.reason

    def test_reorg_rolls_nonce_back(self):
        # alice's spend confirms on branch A; a heavier branch B (without
        # it) wins — her nonce must roll back to 0 so the SAME signed tx
        # can legitimately confirm on B.
        chain, b1 = _funded_chain("alice")
        pay = stx("alice", "bob", 10, 1, 0)
        a2 = _mine_child(b1, txs=(pay,))
        assert chain.add_block(a2).status is AddStatus.ACCEPTED
        assert chain.nonce(account("alice")) == 1
        c2 = _mine_child(b1, txs=(Transaction.coinbase("c", 2),), ts_offset=4)
        c3 = _mine_child(c2)
        chain.add_block(c2)
        assert chain.add_block(c3).status is AddStatus.ACCEPTED
        assert chain.tip_hash == c3.block_hash()
        assert chain.nonce(account("alice")) == 0  # rolled back
        c4 = _mine_child(c3, txs=(pay,))  # same authorization, new branch
        assert chain.add_block(c4).status is AddStatus.ACCEPTED
        assert chain.balance("bob") == 10

    def test_valid_reorg_moves_balances(self):
        # A clean reorg where both branches are valid: ledger must track
        # undo+apply exactly.
        chain, b1 = _funded_chain("alice")
        a2 = _mine_child(b1, txs=(stx("alice", "bob", 10, 1, 0),))
        assert chain.add_block(a2).status is AddStatus.ACCEPTED
        assert chain.balance("bob") == 10
        carol = account("carol")
        c2 = _mine_child(b1, txs=(Transaction.coinbase(carol, 2),), ts_offset=4)
        c3 = _mine_child(c2, txs=(stx("carol", "dave", 5, 0, 0),))
        chain.add_block(c2)
        res = chain.add_block(c3)
        assert res.status is AddStatus.ACCEPTED
        assert chain.tip_hash == c3.block_hash()
        # alice's spend was rolled back with branch A; carol's landed.
        assert chain.balance(account("alice")) == BLOCK_REWARD
        assert chain.balance("bob") == 0
        assert chain.balance("dave") == 5
        assert chain.balances_snapshot() == {
            k: v for k, v in balances(chain.main_chain()).items() if v
        }


class TestForkChoicePropertyWithLedger:
    """TestForkChoiceProperty extended: random DAGs
    whose blocks carry random transfers (some overdrawing), delivered in
    random order to multiple nodes.  Invariants: all nodes converge to the
    same tip; the main chain replays cleanly through a fresh ledger (no
    negative balance ever); the incremental ledger equals the from-scratch
    view; no block of the main chain overdraws."""

    @pytest.mark.parametrize("seed", [11, 12, 13])
    def test_random_dag_with_ledger_converges(self, seed):
        import random as rnd

        rng = rnd.Random(seed)
        diff = 2
        genesis = make_genesis(diff)
        labels = ["u1", "u2", "u3"]
        blocks = [genesis]
        # Track per-branch balances so tx generation can aim near the
        # boundary: ~60% affordable, ~40% overdraw attempts.
        for i in range(50):
            parent = rng.choice(blocks)
            # Rebuild the parent branch's balances (test-side oracle).
            branch = []
            b = parent
            by_hash = {blk.block_hash(): blk for blk in blocks}
            while b is not genesis:
                branch.append(b)
                b = by_hash[b.header.prev_hash]
            branch_blocks = [genesis, *reversed(branch)]
            bal = balances(branch_blocks)
            miner = account(rng.choice(labels))
            txs = [Transaction.coinbase(miner, i)]
            sender = rng.choice(labels)
            have = bal.get(account(sender), 0)
            # Strict account nonces: the valid seq is the count of the
            # sender's transfers already on this branch.
            nonce = sum(
                1
                for blk in branch_blocks
                for t in blk.txs
                if t.sender == account(sender)
            )
            if rng.random() < 0.4:
                amount = have + rng.randint(1, 25)  # overdraw attempt
            else:
                amount = rng.randint(0, max(0, have - 1))
            seq = nonce if rng.random() < 0.8 else nonce + rng.randint(1, 3)
            if amount > 0:
                txs.append(
                    stx(
                        sender,
                        account(rng.choice(labels)),
                        amount,
                        1,
                        seq,
                        difficulty=diff,
                    )
                )
            child = _mine_child(parent, txs=tuple(txs), ts_offset=rng.randint(1, 9))
            blocks.append(child)

        non_genesis = blocks[1:]
        tips = set()
        for trial in range(3):
            order = non_genesis[:]
            rng.shuffle(order)
            chain = Chain(diff, genesis=genesis)
            for block in order:
                chain.add_block(block)
            main = list(chain.main_chain())
            # 1. Main chain is ledger-valid from scratch.
            fresh = Ledger()
            for b in main:
                fresh.apply_block(b)  # raises on any overdraw
            # 2. Incremental state == from-scratch state, nothing negative.
            snap = chain.balances_snapshot()
            assert snap == {k: v for k, v in balances(main).items() if v}
            assert all(v > 0 for v in snap.values())
            assert main[-1].block_hash() == chain.tip_hash
            tips.add(chain.tip_hash)
        # 3. Convergence: delivery order never changes the winner.
        assert len(tips) == 1


class TestMempoolBalance:
    def test_admission_requires_funds(self):
        from p1_tpu_torch.mempool import Mempool

        chain, _ = _funded_chain("alice")
        pool = Mempool(balance_of=chain.balance)
        assert not pool.add(stx("bob", "alice", 1, 0, 0))  # bob has nothing
        assert pool.add(stx("alice", "bob", 30, 1, 0))
        # Second spend must fit the REMAINING 19 net of the pending 31.
        assert not pool.add(stx("alice", "bob", 20, 0, 1))
        assert pool.add(stx("alice", "bob", 19, 0, 1))

    def test_rbf_replacement_releases_incumbent_debit(self):
        from p1_tpu_torch.mempool import Mempool

        chain, _ = _funded_chain("alice")
        pool = Mempool(balance_of=chain.balance)
        assert pool.add(stx("alice", "bob", 45, 1, 0))  # debit 46
        # Same slot, higher fee, SAME size spend: affordable only if the
        # incumbent's 46 is released before the check.
        assert pool.add(stx("alice", "bob", 45, 2, 0))
        # ... and the tally reflects exactly one pending spend (47).
        assert not pool.add(stx("alice", "bob", 4, 0, 1))
        assert pool.add(stx("alice", "bob", 3, 0, 1))

    def test_select_skips_unaffordable_without_dropping(self):
        from p1_tpu_torch.mempool import Mempool

        chain, _ = _funded_chain("alice")
        # Build the pool balance-blind (as if funded earlier), then select
        # against a ledger where alice can only afford part of it.
        pool = Mempool()
        rich = stx("alice", "bob", 40, 5, 0)
        poor = stx("alice", "bob", 40, 1, 1)  # together they exceed 50
        assert pool.add(rich) and pool.add(poor)
        pool.balance_of = chain.balance
        picked = pool.select(10)
        assert picked == [rich]  # higher fee wins the budget
        assert poor.txid() in pool  # skipped, not dropped

    def test_admission_requires_this_chains_tag(self):
        # Pool-level mirror of the cross-chain replay rule: a spend signed
        # for another chain (internally valid!) is refused at admission.
        from p1_tpu_torch.core.genesis import genesis_hash
        from p1_tpu_torch.mempool import Mempool

        chain, _ = _funded_chain("alice")
        pool = Mempool(
            balance_of=chain.balance, chain_tag=genesis_hash(DIFF)
        )
        foreign = stx("alice", "bob", 5, 1, 0, difficulty=12)
        assert foreign.verify_signature()
        assert not pool.add(foreign)
        assert pool.add(stx("alice", "bob", 5, 1, 0, difficulty=DIFF))

    def test_select_emits_gap_free_seq_runs(self):
        from p1_tpu_torch.mempool import Mempool

        chain, _ = _funded_chain("alice")
        pool = Mempool(balance_of=chain.balance, nonce_of=chain.nonce)
        # Ascending fees over a seq run: rank order is the REVERSE of the
        # required confirmation order — the eligibility heap must still
        # emit seq 0,1,2 (and the gapped seq 9 never).
        t0 = stx("alice", "bob", 2, 1, 0)
        t1 = stx("alice", "bob", 2, 5, 1)
        t2 = stx("alice", "bob", 2, 9, 2)
        gap = stx("alice", "bob", 1, 20, 9)
        for t in (gap, t2, t1, t0):
            assert pool.add(t)
        assert [t.seq for t in pool.select(10)] == [0, 1, 2]
        # An unaffordable tx ends its sender's run (later seqs would gap).
        # Build the overweight pair balance-blind (as if funded when
        # admitted, then a reorg shrank the balance).
        pool.balance_of = None
        big = stx("alice", "bob", 40, 1, 3)  # 41 > the 29 left after 0-2
        after = stx("alice", "bob", 1, 50, 4)
        assert pool.add(big) and pool.add(after)
        pool.balance_of = chain.balance
        assert [t.seq for t in pool.select(10)] == [0, 1, 2]  # run ends at 3

    def test_custom_genesis_chain_tag(self):
        # A chain built on a custom genesis must accept transfers bound to
        # ITS genesis hash (not the default-for-difficulty one) — the tag
        # the node's HELLO and mempool advertise.
        import dataclasses as dc

        from p1_tpu_torch.core.genesis import make_genesis

        custom = dc.replace(
            make_genesis(DIFF).header, timestamp=1_700_000_000
        )
        custom_genesis = Block(custom, ())
        chain = Chain(DIFF, genesis=custom_genesis)
        alice = key_for("alice")
        b1 = _mine_child(
            custom_genesis, txs=(Transaction.coinbase(alice.account, 1),)
        )
        assert chain.add_block(b1).status is AddStatus.ACCEPTED
        pay = Transaction.transfer(
            alice, "bob", 5, 1, 0, chain=custom_genesis.block_hash()
        )
        ok = _mine_child(b1, txs=(pay,))
        assert chain.add_block(ok).status is AddStatus.ACCEPTED
        # ... and the default-genesis tag is a DIFFERENT chain here.
        foreign = stx("alice", "carol", 5, 1, 1, difficulty=DIFF)
        bad = _mine_child(ok, txs=(foreign,))
        res = chain.add_block(bad)
        assert res.status is AddStatus.REJECTED
        assert "different chain" in res.reason

    def test_eviction_releases_debit(self):
        from p1_tpu_torch.mempool import Mempool

        chain, b1 = _funded_chain("alice")
        pool = Mempool(balance_of=chain.balance)
        spend = stx("alice", "bob", 45, 1, 0)
        assert pool.add(spend)
        blk = _mine_child(b1, txs=(spend,))
        pool.apply_block_delta((), (blk,))
        assert pool._pending_debit == {}
