"""Mempool: pending transactions feeding block assembly.

Capability parity: the reference's mempool (BASELINE.json:5).  Fee-priority
selection with insertion-order tie-breaks (deterministic for tests), txid
dedup for gossip, **per-(sender, seq) replay suppression with
replace-by-fee** (the ``seq`` field's documented purpose — see
``Transaction.seq`` in core/tx.py: two competing spends of one sequence
slot never sit in the pool together, the higher fee wins, and slots
confirmed within a bounded recent window are refused re-entry), eviction
of mined transactions, and resurrection of transactions from blocks a
reorg abandoned — wired to the removed/added paths ``Chain.add_block``
reports.

Admission also requires an Ed25519 ownership proof
(``Transaction.verify_signature``), the pool's chain tag (cross-chain
replays), a not-yet-consumed seq (``nonce_of``), and — when ``balance_of``
is wired to the chain's consensus ledger — that the sender can afford the
transfer net of its other pending spends; ``select`` additionally emits
only gap-free per-sender seq runs, so assembled blocks never violate the
chain's connect-time overdraw/nonce rules.  Same-chain replay protection
is CONSENSUS now (strict account nonces, ledger.py); the (sender, seq)
slot window on top is plain pool hygiene — one pending spend per slot,
highest fee wins.

The port's copy of ``p1_tpu/mempool/mempool.py``: the same admission
verdicts, and the persistence files (``save_mempool``, ``dump_mempool``,
``write_mempool_file``) byte for byte the reference's.  Admission checks
each signature alone, on the port's serial rung: the native C++ engine
(``native/ed25519.cpp`` through ``core/_ed25519_native.py``, what the
default ladder gives serial verifies wherever ``g++`` builds it), pure
Python only where the native library does not build.
"""

from __future__ import annotations

import bisect
import collections
import time

from p1_tpu_torch.core.block import Block
from p1_tpu_torch.core.tx import Transaction

def sync_key(fee: int, txid: bytes) -> tuple[int, bytes]:
    """The mempool-sync page ordering: fee-descending, txid-ascending.
    One definition shared by the pager and both requester-side cursor
    computations (continuation pick + strictly-advancing check) so the
    ordering cannot drift between sites."""
    return (-fee, txid)


#: How many recently-confirmed (sender, seq) slots to remember (FIFO).
#: A replayed spend of a confirmed slot is refused while the slot is in
#: the window — sized to cover any realistic gossip-reordering horizon.
CONFIRMED_SLOT_WINDOW = 16_384


#: Mempool persistence file magic + layout version (bump on change).
MEMPOOL_MAGIC = b"P1MP0001"


def dump_mempool(rows: list[tuple[Transaction, float]]) -> bytes:
    """Serialize a ``Mempool.snapshot()`` for persistence.  Layout:
    MAGIC + u32 count + per tx (f64 age_s + u32 len + wire bytes).
    Split from the file write so the node can take the snapshot on the
    event loop (where the pool is mutated) and do the encoding + disk
    I/O in a worker thread.  ``tx.serialize()`` is memoized (core/tx.py),
    so the periodic checkpoint re-emits each pending transaction's
    gossip bytes rather than re-packing the pool every interval."""
    import struct as _struct

    parts = [MEMPOOL_MAGIC, _struct.pack(">I", len(rows))]
    for tx, age in rows:
        raw = tx.serialize()
        parts.append(_struct.pack(">dI", age, len(raw)))
        parts.append(raw)
    return b"".join(parts)


def write_mempool_file(data: bytes, path) -> None:
    """Atomic tmp+replace write (like the address book — never torn),
    DURABLE both sides of the rename: the tmp's data is fsynced before
    ``replace`` publishes it (or a power cut could commit the rename's
    metadata while the data pages were still dirty — a complete rename
    pointing at an empty/torn file), and the directory is fsynced after,
    so the rename itself survives a metadata-journal loss."""
    import os
    import pathlib

    path = pathlib.Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    dfd = os.open(path.parent, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def save_mempool(pool: "Mempool", path) -> int:
    """Persist the pending pool to ``path``; returns the tx count.

    Bitcoin's ``mempool.dat`` analog: without
    it, a restarting single-node miner loses every pending transaction
    outright, and a networked node only re-learns them if some peer
    still holds them.  Ages rather than timestamps: admission stamps
    are monotonic-clock values, meaningless across processes.
    """
    rows = pool.snapshot()
    write_mempool_file(dump_mempool(rows), path)
    return len(rows)


def load_mempool(pool: "Mempool", path) -> tuple[int, int]:
    """Reload a persisted pool through FULL re-validation — every entry
    passes ordinary admission (signature, chain tag, consumed nonces,
    affordability against the CURRENT ledger), so stale or invalid
    records are dropped, not trusted.  Returns (restored, dropped).
    A corrupt or truncated file restores its readable prefix and stops —
    the pool is a cache, never worth failing startup over."""
    import pathlib
    import struct as _struct

    path = pathlib.Path(path)
    try:
        raw = path.read_bytes()
    except OSError:
        return (0, 0)
    if len(raw) < len(MEMPOOL_MAGIC) + 4 or not raw.startswith(MEMPOOL_MAGIC):
        return (0, 0)
    (count,) = _struct.unpack_from(">I", raw, len(MEMPOOL_MAGIC))
    off = len(MEMPOOL_MAGIC) + 4
    restored = dropped = 0
    now = pool._clock()
    for _ in range(count):
        if len(raw) < off + 12:
            break  # truncated tail: keep what we have
        age, tlen = _struct.unpack_from(">dI", raw, off)
        off += 12
        if len(raw) < off + tlen:
            break
        try:
            tx = Transaction.deserialize(raw[off : off + tlen])
        except ValueError:
            dropped += 1
            off += tlen
            continue
        off += tlen
        if pool.restore(tx, age, now=now):
            restored += 1
        else:
            dropped += 1
    return (restored, dropped)


class Mempool:
    """Txid-keyed pending-transaction pool with per-(sender, seq) slots."""

    def __init__(
        self,
        max_txs: int = 100_000,
        balance_of=None,
        chain_tag=None,
        nonce_of=None,
        sig_cache=None,
        clock=time.monotonic,
    ):
        self.max_txs = max_txs
        #: Monotonic time source for admission stamps / TTL expiry.  A
        #: bare reference, never called at import: the node injects its
        #: transport clock (node/transport.py) so pool ages ride VIRTUAL
        #: time under the simulator — chaos schedules that crash and
        #: recover nodes must see deterministic checkpoint ages, and the
        #: wall-clock lint (tests/test_simlint.py) holds mempool/ to the
        #: same seam discipline as node/ and chain/.
        self._clock = clock
        #: Verify-once signature cache (core/sigcache.py) admission
        #: populates: a transfer verified here is NOT re-verified when
        #: the block carrying it connects (or when mining re-assembles
        #: it) — the sigcache double-verify fix.  None = the process
        #: default; a Node wires its own instance, shared with its Chain.
        self.sig_cache = sig_cache
        #: Optional ``account -> confirmed nonce`` callable (wire it to
        #: ``Chain.nonce``).  When set, admission refuses transfers whose
        #: seq is already consumed on the chain (definite replays), and
        #: ``select`` only emits per-sender runs that start at the
        #: confirmed nonce with no gaps — consensus requires strictly
        #: sequential seqs, so anything else could not connect.
        self.nonce_of = nonce_of
        #: Genesis hash of the chain this pool feeds.  When set, admission
        #: refuses transfers whose chain-bound signature names any other
        #: chain (mirror of the consensus check, so assembled blocks can't
        #: be rejected for a foreign tag).  None (unit tests, codec tools)
        #: skips the check.
        self.chain_tag = chain_tag
        #: Optional ``account -> confirmed balance`` callable (wire it to
        #: ``Chain.balance``).  When set, admission requires the sender to
        #: afford the transfer *net of its other pending spends* — the
        #: pool-level mirror of the consensus overdraw rule, so an
        #: assembled block is never rejected at connect time for
        #: overdrawing.  When None (unit tests, codec tools) the pool is
        #: balance-blind, exactly as before.
        self.balance_of = balance_of
        self._txs: dict[bytes, Transaction] = {}  # insertion-ordered
        #: txid -> monotonic admission time, for age-based expiry
        #: (``expire``): a transfer that cannot mine — gapped seq, drained
        #: balance, owner walked away — must not occupy pool capacity
        #: forever.  Kept in lockstep with ``_txs``.
        self._admitted_at: dict[bytes, float] = {}
        self._by_slot: dict[tuple[str, int], bytes] = {}  # (sender, seq) -> txid
        #: sender -> sum(amount + fee) over its pending transactions;
        #: maintained on every add/replace/evict so the affordability
        #: check is O(1).
        self._pending_debit: dict[str, int] = {}
        #: All pending ``sync_key``s in sorted order — the pager's index.
        #: Serving one sync page is O(log n + page) against it (a
        #: filter-everything pager would make a full paged sync
        #: O(n²/page)); maintenance is one ``insort``/``del`` per
        #: add/remove (O(n) memmove worst case, but C-speed and amortized
        #: far below the per-tx signature verify).
        self._sorted: list[tuple[int, bytes]] = []
        #: FIFO window of recently confirmed slots -> confirmation count.
        #: Counted, not a set: nothing validates per-chain slot uniqueness,
        #: so one slot can be confirmed by several connected blocks and a
        #: partial reorg must not reopen it while another confirmation
        #: still stands.
        self._confirmed_slots: collections.OrderedDict[
            tuple[str, int], int
        ] = collections.OrderedDict()
        #: Monotonic mutation counter (bumped on every add/drop): lets
        #: the node's periodic checkpoint skip the disk write when the
        #: pool hasn't changed since the last save.
        self.mutations = 0
        #: Serialized bytes of every pending transaction, maintained on
        #: add/drop — the pool's term in the node's overload memory
        #: gauge (node/governor.py).  ``serialize`` is memoized, so the
        #: tally is a cached-bytes len, never a re-pack.
        self.bytes_pending = 0

    def __len__(self) -> int:
        return len(self._txs)

    def __contains__(self, txid: bytes) -> bool:
        return txid in self._txs

    def get(self, txid: bytes) -> Transaction | None:
        """The pending transaction with this txid, if any — compact-block
        reconstruction's lookup (txid = SHA-256d of the exact wire bytes,
        so a hit IS the block's transaction)."""
        return self._txs.get(txid)

    def txids(self) -> tuple:
        """Every pending txid, insertion-ordered — the reconciliation
        plane's full-pool enumeration (node/reconcile.py short IDs are
        computed per peer over exactly this set)."""
        return tuple(self._txs)

    def add(self, tx: Transaction) -> bool:
        """Admit ``tx``; False if coinbase, already known, outbid, or full.

        Coinbases never belong in a mempool: they are minted per block by
        the assembling miner, so a gossiped one is invalid and a reorg's
        resurrection path (``apply_block_delta``) must drop the abandoned
        branch's rewards rather than re-mine them into the new branch.

        A transaction occupying an already-pending (sender, seq) slot must
        strictly outbid the incumbent's fee to replace it (replace-by-fee;
        fees are integers, so "strictly more" is an absolute bump of >= 1 —
        an N-replacement gossip flood costs the attacker an N-unit fee,
        keeping amplification linear-cost).  Replacement frees the
        incumbent's capacity, so it works even when the pool is otherwise
        full.  A slot confirmed within the recent window is refused
        outright — a reordered or replayed spend of it can't re-enter.
        """
        if tx.is_coinbase:
            return False
        if self.chain_tag is not None and tx.chain != self.chain_tag:
            return False  # signed for a different chain (replay)
        if self.nonce_of is not None and tx.seq < self.nonce_of(tx.sender):
            return False  # seq already consumed on-chain (replay)
        if not tx.verify_signature(cache=self.sig_cache):
            # Unowned spends never enter the pool; re-admissions from
            # reorg resurrection re-check for free (verify-once cache),
            # and the block that later carries this transfer connects
            # without re-paying the backend at all.
            return False
        txid = tx.txid()
        if txid in self._txs:
            return False
        slot = (tx.sender, tx.seq)
        if slot in self._confirmed_slots:
            return False
        incumbent = self._by_slot.get(slot)
        if incumbent is not None:
            if tx.fee <= self._txs[incumbent].fee:
                return False
        elif len(self._txs) >= self.max_txs:
            return False
        if self.balance_of is not None:
            # Spendable = confirmed balance minus what this sender's OTHER
            # pending transactions already commit (the incumbent it would
            # replace doesn't count — both can never be in the pool).
            committed = self._pending_debit.get(tx.sender, 0)
            if incumbent is not None:
                inc = self._txs[incumbent]
                committed -= inc.amount + inc.fee
            if self.balance_of(tx.sender) - committed < tx.amount + tx.fee:
                return False
        if incumbent is not None:
            self._drop(self._txs[incumbent])
        self._txs[txid] = tx
        self._admitted_at[txid] = self._clock()
        self.bytes_pending += len(tx.serialize())
        self._by_slot[slot] = txid
        self._pending_debit[tx.sender] = (
            self._pending_debit.get(tx.sender, 0) + tx.amount + tx.fee
        )
        bisect.insort(self._sorted, sync_key(tx.fee, txid))
        self.mutations += 1
        return True

    def _drop(self, tx: Transaction) -> None:
        """Remove a pending ``tx`` from the pool + its debit tally + the
        sync index."""
        txid = tx.txid()
        if self._txs.pop(txid, None) is not None:
            self.bytes_pending -= len(tx.serialize())
        self._admitted_at.pop(txid, None)
        d = self._pending_debit.get(tx.sender, 0) - (tx.amount + tx.fee)
        if d > 0:
            self._pending_debit[tx.sender] = d
        else:
            self._pending_debit.pop(tx.sender, None)
        key = sync_key(tx.fee, txid)
        i = bisect.bisect_left(self._sorted, key)
        if i < len(self._sorted) and self._sorted[i] == key:
            del self._sorted[i]
        self.mutations += 1

    def _evict(self, tx: Transaction) -> None:
        """Mark ``tx``'s (sender, seq) slot confirmed: its pending occupant
        (``tx`` itself or a rival spend) leaves the pool, and the slot
        enters the bounded confirmed window so late replays are refused.

        (Any tx present in ``_txs`` is its slot's occupant — the maintained
        invariant — so the slot pop alone removes it.)
        """
        occupant = self._by_slot.pop((tx.sender, tx.seq), None)
        if occupant is not None and occupant in self._txs:
            self._drop(self._txs[occupant])
        if not tx.is_coinbase:  # coinbase slots can never re-enter anyway
            slot = (tx.sender, tx.seq)
            self._confirmed_slots[slot] = self._confirmed_slots.get(slot, 0) + 1
            self._confirmed_slots.move_to_end(slot)
            while len(self._confirmed_slots) > CONFIRMED_SLOT_WINDOW:
                self._confirmed_slots.popitem(last=False)

    def expire(self, max_age_s: float, now: float | None = None) -> int:
        """Drop transactions admitted more than ``max_age_s`` ago; return
        how many.  Pool hygiene, not consensus: an expired transfer's
        signature stays valid and its owner can rebroadcast — but a spend
        that has sat unmineable (gapped seq, drained balance) past any
        realistic confirmation horizon should stop occupying capacity and
        sync bandwidth.  ``now`` is injectable for deterministic tests.
        """
        now = self._clock() if now is None else now
        stale = [
            txid
            for txid, t in self._admitted_at.items()
            if now - t > max_age_s
        ]
        dropped = 0
        for txid in stale:
            tx = self._txs.get(txid)
            if tx is None:
                # Lockstep with _txs is a maintained invariant; if a future
                # edit breaks it, clear the orphaned stamp here rather than
                # re-reporting the same ghost on every pass.
                self._admitted_at.pop(txid, None)
                continue
            self._by_slot.pop((tx.sender, tx.seq), None)
            self._drop(tx)
            dropped += 1
        return dropped

    def pending_next_seq(self, sender: str, floor: int) -> int:
        """The seq a NEW transfer from ``sender`` should carry: ``floor``
        (the chain's confirmed nonce) advanced through the CONTIGUOUS run
        of pending slots.  Contiguous, not max+1: a stray gapped pending
        tx (someone pinned --seq far ahead) can never mine, and jumping
        past it would poison every auto-seq wallet tx after it — the
        contiguous walk hands out the seq that actually fills the gap."""
        seq = floor
        while (sender, seq) in self._by_slot:
            seq += 1
        return seq

    def sync_page(
        self, cursor: tuple[int, bytes] | None, max_txs: int
    ) -> tuple[list[Transaction], bool]:
        """One page of the pool for peer sync: fee-descending (txid-ascending
        on ties), strictly after ``cursor`` = (fee, txid) of the last
        transaction the requester already has.  Returns (page, more).

        The cursor is a *stable key*, not a position: evictions and
        replacements between pages can't shift unseen transactions behind
        it (a positional offset would silently skip them under churn), and
        transactions added mid-sync reach the requester through normal TX
        gossip since it is a connected peer by then.  Served from the
        maintained sorted index: O(log n + page) per call.
        """
        start = (
            bisect.bisect_right(self._sorted, sync_key(*cursor))
            if cursor is not None
            else 0
        )
        page = self._sorted[start : start + max_txs]
        return (
            [self._txs[txid] for _, txid in page],
            start + len(page) < len(self._sorted),
        )

    def select(self, max_txs: int = 1000) -> list[Transaction]:
        """Highest-fee-first block candidates, txid-ascending on fee ties —
        served straight off the maintained ``_sorted`` index, so assembly
        is O(selection), not O(n log n) per mined block.  (The tie-break is
        the same ``sync_key`` order the pager uses: deterministic and
        node-independent, which insertion order was not.)

        With ``balance_of``/``nonce_of`` wired, the selection is guaranteed
        connectable: each sender's summed debits within the selection stay
        within its confirmed balance (conservative — intra-block credits
        only help, so the sequential consensus check can only be looser
        than this one), and each sender's seqs form a gap-free run from
        its confirmed nonce (the consensus replay rule).  Ineligible
        transactions are skipped, not dropped: a reorg, a deposit, or a
        gap-filling arrival may qualify them later.

        Shape: a heap of each sender's *currently eligible* transaction
        (the one at its next nonce), popped best-fee-first; picking one
        unlocks the sender's next seq.  O(n log n) per assembly — a naive
        rescan-until-fixpoint is O(picked·n) and a single sender fee-
        bumping a long seq run (ascending fees = descending rank) makes
        that quadratic on the mining hot path.
        """
        if self.balance_of is None and self.nonce_of is None:
            return [self._txs[txid] for _, txid in self._sorted[:max_txs]]
        if self.nonce_of is None:
            # Affordability only: one fee-ordered pass, no seq coupling.
            picked = []
            spent: dict[str, int] = {}
            for _, txid in self._sorted:
                if len(picked) >= max_txs:
                    break
                tx = self._txs[txid]
                cost = tx.amount + tx.fee
                already = spent.get(tx.sender, 0)
                if self.balance_of(tx.sender) - already < cost:
                    continue
                spent[tx.sender] = already + cost
                picked.append(tx)
            return picked

        import heapq

        by_sender: dict[str, dict[int, Transaction]] = {}
        for tx in self._txs.values():
            by_sender.setdefault(tx.sender, {})[tx.seq] = tx
        heap: list[tuple[int, bytes]] = []  # sync_key of eligible txs
        for sender, seqs in by_sender.items():
            tx = seqs.get(self.nonce_of(sender))
            if tx is not None:
                heap.append(sync_key(tx.fee, tx.txid()))
        heapq.heapify(heap)
        picked = []
        spent = {}
        while heap and len(picked) < max_txs:
            _, txid = heapq.heappop(heap)
            tx = self._txs[txid]
            if self.balance_of is not None:
                cost = tx.amount + tx.fee
                already = spent.get(tx.sender, 0)
                if self.balance_of(tx.sender) - already < cost:
                    # Later seqs of this sender would gap behind the
                    # unaffordable one — the sender's run ends here.
                    continue
                spent[tx.sender] = already + cost
            picked.append(tx)
            nxt = by_sender[tx.sender].get(tx.seq + 1)
            if nxt is not None:
                heapq.heappush(heap, sync_key(nxt.fee, nxt.txid()))
        return picked

    def restore(self, tx: Transaction, age_s: float, now: float | None = None) -> bool:
        """Re-admit a persisted transaction with its pre-restart age,
        through FULL admission validation (signature, chain tag, nonce,
        affordability — the chain may have moved while the node was
        down).  Backdating the admission stamp keeps the TTL clock honest
        across restarts: a transfer that sat unmineable for an hour
        before the restart does not get a fresh hour after it."""
        if not self.add(tx):
            return False
        now = self._clock() if now is None else now
        self._admitted_at[tx.txid()] = now - max(0.0, age_s)
        return True

    def snapshot(self, now: float | None = None) -> list[tuple[Transaction, float]]:
        """(transaction, age_seconds) for every pending transaction —
        what persistence saves.  Ages, not absolute stamps: admission
        times are monotonic-clock values, meaningless across processes."""
        now = self._clock() if now is None else now
        return [
            (tx, max(0.0, now - self._admitted_at[txid]))
            for txid, tx in self._txs.items()
        ]

    def apply_block_delta(
        self, removed: tuple[Block, ...], added: tuple[Block, ...]
    ) -> None:
        """Sync the pool with a tip movement reported by ``Chain.add_block``.

        Transactions in newly-connected blocks leave the pool; transactions
        from abandoned blocks come back (unless the new branch also
        confirmed them — eviction runs last to win that race).

        Known, accepted loss: when a block confirms a slot, a
        *pending higher-fee rival* of that slot is evicted and NOT
        remembered — if the block is later reorged away, only the mined
        transaction is resurrected here, so the outbid rival is gone even
        though it would have won RBF.  Re-admitting it would require an
        unbounded evicted-rival archive; the rival's owner simply
        rebroadcasts (its signature is still valid and its slot reopened).
        """
        for block in removed:
            for tx in block.txs:
                # ONE confirmation of this slot is being rolled back; the
                # slot reopens only when no other connected block still
                # confirms it (hence the count, not a set-discard).
                slot = (tx.sender, tx.seq)
                count = self._confirmed_slots.get(slot)
                if count is not None:
                    if count <= 1:
                        del self._confirmed_slots[slot]
                    else:
                        self._confirmed_slots[slot] = count - 1
                self.add(tx)
        for block in added:
            for tx in block.txs:
                self._evict(tx)
