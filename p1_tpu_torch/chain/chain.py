"""The block index: longest-chain fork choice with reorg support.

Capability parity: the reference's chain layer — "chain-validation code
paths" and "longest-chain" resolution on the gossip network
(BASELINE.json:5,10).  Design:

The port's copy of ``p1_tpu/chain/chain.py``: the same ``AddStatus``
and reason text, tip, ledger state and filter headers on the same blocks.
Its ``check_block`` runs signature batches on the card (``chain/validate.py``).

- Every valid block is indexed by hash with its height and **cumulative
  work** (2**difficulty per block — equal to chain length at the fixed
  difficulty the benchmark configs use, but correct if difficulty ever
  varies).  Fork choice = most cumulative work; ties resolve to the
  lexicographically smaller tip hash.  The tie-break makes fork choice a
  **pure function of the block set** — gossip floods every block, so any
  two nodes that have seen the same blocks pick the same tip, and a
  quiesced network converges deterministically instead of deadlocking on
  equal-work first-seen tips.
- Blocks whose parent is unknown wait in an **orphan pool** keyed by
  prev-hash (gossip delivers out of order); connecting a parent drains its
  orphans recursively.  The pool is hostile-input-safe: a block must pass
  full stateless validation (including its own PoW) *before* parking, the
  pool is capped at ``MAX_ORPHANS`` with FIFO eviction, and re-received
  orphans are not double-parked — so a buggy or malicious peer cannot grow
  node memory without bound by flooding unconnectable blocks.
- ``add_block`` reports what happened — including the reorg's removed/added
  block lists so the mempool can resurrect transactions from abandoned
  blocks and the miner knows to abort a stale search.
- **Difficulty is contextual when a ``RetargetRule`` is active** (opt-in,
  core/retarget.py): the required difficulty of a block is a pure function
  of its ancestor chain (parent's difficulty, adjusted at window
  boundaries from observed timestamps), checked at connect time; fixed
  difficulty — every benchmark config — is the ``retarget=None`` default
  and behaves exactly as before.  Cumulative work already weighs each
  block by ``2**difficulty``, so fork choice across mixed-difficulty
  branches needs no change.
- **Contextual (ledger) validity is enforced at connect time**, Bitcoin
  style: stateless checks (PoW, merkle, signatures, subsidy) gate indexing,
  but whether a transfer overdraws its sender depends on the block's whole
  ancestor chain — so the incremental ``Ledger`` held at the tip validates
  blocks exactly when the tip tries to move onto them.  A branch containing
  an overdraw is marked **invalid** (the block and every descendant,
  permanently — contextual validity is a pure function of a block's
  ancestor chain, so all nodes agree) and fork choice falls back to the
  best valid tip.  Side branches are indexed without ledger checks (their
  state isn't materialized) and get validated if work ever favors them.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Iterator

from p1_tpu_torch.core import sigcache
from p1_tpu_torch.core.block import Block
from p1_tpu_torch.core.genesis import make_genesis
from p1_tpu_torch.core.header import BlockHeader
from p1_tpu_torch.core.retarget import RetargetRule
from p1_tpu_torch.chain.filters import FilterHeaderChain, FilterIndex
from p1_tpu_torch.chain.ledger import Ledger, LedgerError
from p1_tpu_torch.chain.proof import ProofCache, TxProof, build_block_proofs
from p1_tpu_torch.chain.snapshot import (
    DEFAULT_CHECKPOINT_INTERVAL,
    LedgerSnapshot,
    state_root,
)
from p1_tpu_torch.chain.statedelta import block_accounts
from p1_tpu_torch.chain.validate import ValidationError, check_block


#: Orphan-pool capacity.  Orphans exist only to absorb out-of-order gossip,
#: which a locator sync backfills within one round trip — a few hundred is
#: plenty, and the cap is what bounds memory against a flooding peer.
MAX_ORPHANS = 256


def locator_hashes(hashes: list[bytes], dense: int = 10) -> list[bytes]:
    """Tip-first sync locator over a genesis-first hash list: the last
    ``dense`` entries one by one, then exponentially spaced back to
    genesis.  ONE definition — ``Chain.locator`` (server side) and the
    light client's header fetch share it, so the shape both sides use to
    find the fork point cannot drift."""
    out = []
    height = len(hashes) - 1
    step = 1
    while True:
        out.append(hashes[height])
        if height == 0:
            return out
        if len(out) >= dense:
            step *= 2
        height = max(0, height - step)


class AddStatus(enum.Enum):
    ACCEPTED = "accepted"  # extends a known block (tip may or may not move)
    DUPLICATE = "duplicate"  # already indexed
    ORPHAN = "orphan"  # parent unknown; parked in the orphan pool
    REJECTED = "rejected"  # failed validation


@dataclasses.dataclass(frozen=True)
class AddResult:
    status: AddStatus
    reason: str = ""
    #: Set when the tip moved.  ``removed`` is the abandoned branch
    #: (old-tip-first), ``added`` the new one (fork-point-first); a plain
    #: extension has removed=() and added=(block,).
    removed: tuple[Block, ...] = ()
    added: tuple[Block, ...] = ()
    #: Every block newly indexed by this call, insertion order: the
    #: triggering block plus any orphans it unblocked.  This is what
    #: persistence must append — ``added`` alone misses side branches and
    #: cascaded orphans.
    connected: tuple[Block, ...] = ()

    @property
    def tip_changed(self) -> bool:
        return bool(self.added)


@dataclasses.dataclass(slots=True)
class _Entry:
    """One indexed block.  ``header`` is ALWAYS resident (fork choice,
    difficulty schedules, and locators need it); ``block`` may be evicted
    to ``None`` once the body is safely refetchable from the chain's
    ``body_source`` (memory-bounded operation — ``evict_bodies``).
    Slots: there is one of these per block FOREVER — the per-instance
    dict would be a ~200-byte O(chain) RAM term all by itself."""

    block: Block | None
    header: "BlockHeader"
    height: int
    work: int  # cumulative, including this block


class Chain:
    """Block index + fork choice for one chain configuration."""

    def __init__(
        self,
        difficulty: int,
        genesis: Block | None = None,
        retarget: RetargetRule | None = None,
    ):
        #: Base (genesis) difficulty.  With ``retarget`` set, per-block
        #: required difficulty is contextual (``_expected_difficulty``) and
        #: this stays the anchor the rule evolves from.
        self.difficulty = difficulty
        self.retarget = retarget
        self.genesis = (
            genesis if genesis is not None else make_genesis(difficulty, retarget)
        )
        ghash = self.genesis.block_hash()
        self._index: dict[bytes, _Entry] = {
            ghash: _Entry(self.genesis, self.genesis.header, 0, 1 << difficulty)
        }
        self._tip_hash = ghash
        #: Height of the chain's BASE block — genesis (0) normally, the
        #: snapshot anchor block's height for an assumed chain built by
        #: ``from_snapshot``.  Every height-indexed structure
        #: (``_main_hashes``) is offset by it; nothing below the base is
        #: indexed, so reorgs can never cross it.
        self.base_height = 0
        #: True for a chain whose base state came from an (untrusted)
        #: snapshot rather than replayed history — the serving node's
        #: ASSUMED validation state mirrors this until the flip.
        self.assumed = False
        #: State-root commitment cadence (chain/snapshot.py): a root of
        #: the ledger state is recorded in ``state_checkpoints`` at every
        #: multiple of this height interval as blocks apply — the
        #: retarget window when one is active (the consensus-natural
        #: cadence), DEFAULT_CHECKPOINT_INTERVAL on fixed-difficulty
        #: chains.  ``checkpoint_extra`` adds ad-hoc watch heights (the
        #: background revalidation pins the snapshot height there so the
        #: divergence check reads an exact-height root regardless of
        #: interval agreement between nodes).
        self.checkpoint_interval = (
            retarget.window if retarget is not None else DEFAULT_CHECKPOINT_INTERVAL
        )
        self.checkpoint_extra: set[int] = set()
        #: height -> ledger state root at that height, maintained in
        #: lockstep with the ledger (recorded on apply, popped on undo —
        #: a reorg re-records the new branch's roots).  O(height /
        #: interval) * 32 B; the snapshot plane's commitment surface.
        self.state_checkpoints: dict[int, bytes] = {}
        #: Accounts touched by ledger moves since the last
        #: ``collect_dirty_accounts`` — recorded on BOTH apply and undo,
        #: so the set is always a superset of the state diff between any
        #: two collection points (reorgs included).  Feeds the
        #: incremental snapshot build (chain/snapshot.py); a too-big
        #: set only costs chunk reuse, never correctness.
        self._dirty_accounts: set[str] = set()
        #: Verify-once signature cache consulted by every ``check_block``
        #: this index runs (core/sigcache.py).  The process default by
        #: default; a Node wires its own instance in so admission-time
        #: verifies are what block connect hits, and its telemetry is
        #: per-node.
        self.sig_cache = sigcache.DEFAULT
        #: Memory-bounded operation (node/governor.py): an object with
        #: ``has_body(bhash)`` / ``read_body(bhash)`` — the ChainStore —
        #: that can re-serve an evicted block body on demand.  None (the
        #: default) keeps every body resident and ``evict_bodies`` a
        #: no-op, exactly the pre-governor behavior.
        self.body_source = None
        #: Serialized bytes of the bodies currently resident (genesis
        #: excluded — never evicted), the big term in the node's memory
        #: gauge; plus eviction/refetch telemetry.
        self.resident_body_bytes = 0
        self.bodies_evicted = 0
        self.body_refetches = 0
        #: The one indexed block whose body was never charged to
        #: ``resident_body_bytes``: the construction-time base (genesis
        #: here, the anchor in ``from_snapshot``) predates the gauge.
        #: ``rebase`` consults this so dropping it does not over-credit;
        #: every later base went through ``_insert`` and IS charged.
        self._base_body_unaccounted: bytes | None = ghash
        #: Insertion-ordered candidates for body eviction (≈ height
        #: order).  Entries already evicted or de-indexed are skipped on
        #: the sweep, so the deque stays O(resident bodies).
        self._resident_fifo: collections.deque[bytes] = collections.deque()
        #: Main-chain hashes by height (``_main_hashes[h]`` is the height-h
        #: block).  Kept in sync on every tip move so sync serving
        #: (``blocks_after``) and ``_on_main_chain`` are O(1) per block
        #: instead of re-walking the whole chain per request.
        self._main_hashes: list[bytes] = [ghash]
        self._orphans: dict[bytes, list[Block]] = {}  # prev_hash -> waiting blocks
        self._orphan_hashes: set[bytes] = set()  # parked block hashes (dedup)
        self._orphan_fifo: collections.deque[tuple[bytes, bytes]] = (
            collections.deque()
        )  # (prev_hash, block_hash) in arrival order, for FIFO eviction
        #: Account state at the current tip — advanced/rewound with every
        #: tip move, so contextual validation is O(blocks moved).
        self._ledger = Ledger()
        self._ledger.apply_block(self.genesis)
        #: Contextually invalid blocks (overdraw somewhere in their history)
        #: + why.  Membership is permanent; descendants inherit it.
        self._invalid: dict[bytes, str] = {}
        #: parent hash -> child hash(es), for invalidating indexed
        #: subtrees.  Value is the bare child hash (shared with the index
        #: key — zero extra allocation) in the universal one-child case,
        #: widening to a list only at a real fork: one list shell per
        #: block would be a ~9 MB O(chain) RAM term at 100k blocks.
        self._children: dict[bytes, bytes | list[bytes]] = {}
        #: txid -> containing main-chain block hash, maintained with every
        #: tip move (like the ledger) so SPV proof serving is O(block), not
        #: O(chain).  Main chain only: side-branch confirmations are not
        #: facts a node should attest to.
        self._tx_index: dict[bytes, bytes] = {
            tx.txid(): ghash for tx in self.genesis.txs
        }
        #: Pruned operation (round 18, chain/segstore.py): main-chain
        #: heights BELOW this have had their on-disk bodies discarded.
        #: Headers and every index structure stay; body-dependent
        #: serving (deep proofs, filter rebuilds, block sync into the
        #: pruned range) gates on ``body_available`` instead of
        #: assuming a refetch can always succeed.  0 = archive node.
        self.prune_floor = 0
        #: Serving plane (round 9).  ``proof_cache`` memoizes the
        #: reorg-stable part of inclusion proofs, filled a whole block at
        #: a time (one merkle tree amortized over every tx in the block)
        #: and invalidated per abandoned block on reorg; ``filter_index``
        #: caches per-block compact filters (chain/filters.py), built at
        #: connect and rebuilt on demand for deep history.  Both are
        #: bytes-bounded LRUs the node charges to its memory gauge.
        self.proof_cache = ProofCache()
        self.filter_index = FilterIndex()
        #: BIP157-analog filter-header commitment chain, kept in
        #: lockstep with the main chain at every connect (add_block) so
        #: the push/serving planes can hand wallets a commitment to
        #: cross-check untrusted filter streams against.  Stays
        #: honestly empty on re-based / from_snapshot chains (no height
        #: 0 to anchor at) and honestly short past a pruned body — a
        #: refusal wallets treat as "ask an archive replica", never as
        #: a partial answer.
        self.filter_headers = FilterHeaderChain()
        #: Stateless-validation entry point used by ``_insert`` and
        #: ``_park_orphan`` — an instance attribute so the staged node
        #: (node/pipeline.py) can interpose and so tests can instrument
        #: connect order.  With the staged pipeline on, every wire
        #: block's signatures are pre-verified OFF-loop before
        #: ``add_block`` runs, so this call is a sig-cache hit on the
        #: valid path — only hostile (invalid-signature) blocks pay an
        #: on-loop verify here, bounded by the ban that follows.
        self.check_block = check_block

    @classmethod
    def from_snapshot(
        cls,
        difficulty: int,
        snap: LedgerSnapshot,
        retarget: RetargetRule | None = None,
    ) -> "Chain":
        """An ASSUMED chain anchored on a verified snapshot: the index
        holds exactly the anchor block, the ledger holds the snapshot
        state, and everything below the base simply does not exist here
        — new blocks extend the anchor, queries serve immediately, and
        the real history is somebody else's (the background
        revalidation's) problem until the flip.

        Trust: ``snap`` passed chain/snapshot.py's integrity gates
        (digests, root, anchor hash) — but the STATE is still only the
        serving peer's claim; the caller owns tracking that (ASSUMED
        vs VALIDATED, node/node.py).

        Cumulative work below the base is unknowable without the
        history, so the anchor's work is assumed at ``height + 1``
        blocks of its own difficulty.  This only weighs fork choice
        against branches attached below the base — which an assumed
        chain cannot index anyway (their parents are unknown, they park
        as orphans) — so the approximation is unobservable until the
        flip replaces this chain wholesale.
        """
        chain = cls(difficulty, retarget=retarget)
        block = snap.manifest.block
        bhash = block.block_hash()
        if snap.height < 1:
            raise ValueError("snapshot base must be above genesis")
        work = (snap.height + 1) * (1 << block.header.difficulty)
        chain._index = {bhash: _Entry(block, block.header, snap.height, work)}
        chain._tip_hash = bhash
        chain.base_height = snap.height
        chain.assumed = True
        chain._main_hashes = [bhash]
        chain._ledger = Ledger.restore(snap.balances, snap.nonces)
        chain._tx_index = {tx.txid(): bhash for tx in block.txs}
        chain._children = {}
        chain._base_body_unaccounted = bhash
        # The snapshot's own claim IS the base checkpoint: background
        # revalidation compares its replayed root against this height.
        chain.state_checkpoints = {snap.height: snap.state_root}
        return chain

    # -- queries ---------------------------------------------------------

    @property
    def tip(self) -> Block:
        return self._block_at(self._tip_hash)

    @property
    def tip_hash(self) -> bytes:
        return self._tip_hash

    @property
    def height(self) -> int:
        return self._index[self._tip_hash].height

    def __contains__(self, block_hash: bytes) -> bool:
        return block_hash in self._index

    def __len__(self) -> int:
        return len(self._index)

    def get(self, block_hash: bytes) -> Block | None:
        if block_hash not in self._index:
            return None
        return self._block_at(block_hash)

    def header_of(self, block_hash: bytes) -> BlockHeader | None:
        """The indexed block's header — always resident, so queries that
        only need header fields never cost a body refetch."""
        entry = self._index.get(block_hash)
        return entry.header if entry else None

    def _block_at(self, block_hash: bytes) -> Block:
        """The full block for an INDEXED hash, refetching an evicted body
        from ``body_source`` on demand.  Refetches are transient — the
        body is NOT re-cached into the index, so serving deep history to
        a syncing peer cannot silently re-grow the working set the
        eviction sweep just bounded."""
        entry = self._index[block_hash]
        if entry.block is not None:
            return entry.block
        block = self.body_source.read_body(block_hash)
        self.body_refetches += 1
        return block

    def height_of(self, block_hash: bytes) -> int:
        return self._index[block_hash].height

    def body_available(self, block_hash: bytes) -> bool:
        """True when ``_block_at`` can actually produce this block's
        body — resident in RAM, or durably refetchable from the body
        source.  The gate body-dependent serving consults on a pruned
        node: an evicted body whose segment was discarded is headers-
        only forever, and asking for it must be a clean refusal, not a
        KeyError out of the span map."""
        entry = self._index.get(block_hash)
        if entry is None:
            return False
        if entry.block is not None:
            return True
        return self.body_source is not None and self.body_source.has_body(
            block_hash
        )

    def best_block_within(self, ts_bound: int) -> Block:
        """The most-work block (main chain or branch) whose timestamp is
        <= ``ts_bound``.  Serves the miner's hostile-anchor policy
        (node.py _mining_parent): when the tip's stamp is absurdly far
        past wall time, honest mining continues from the heaviest sane
        block — which includes the policy fork's own earlier blocks, so
        the honest branch makes progress instead of re-mining one
        candidate forever.  O(index); only called in that rare mode.
        Genesis always qualifies (its stamp is a fixed past constant)."""
        best_hash = self.genesis.block_hash()
        best = self._index.get(best_hash)
        if best is None:
            # Genesis is not indexed on a from_snapshot or re-based
            # chain — anchor the scan on the base block instead (the
            # oldest block this index can even offer; nothing below it
            # exists here, so it is the degenerate fallback by
            # construction even when its stamp exceeds the bound).
            best_hash = self._main_hashes[0]
            best = self._index[best_hash]
        for bhash, entry in self._index.items():
            if (
                entry.header.timestamp > ts_bound
                or bhash in self._invalid
            ):
                # Invalid branches keep their index entries (permanent
                # rejection memory) but nothing may mine on them — the
                # same exclusion _best_valid_tip applies.
                continue
            # Work tie-break on the hash — compared via the index KEYS,
            # which already are the hashes: re-deriving block_hash() per
            # entry would put a redundant sha256d inside this O(index)
            # scan.
            if entry.work > best.work or (
                entry.work == best.work and bhash < best_hash
            ):
                best, best_hash = entry, bhash
        return self._block_at(best_hash)

    def balance(self, account: str) -> int:
        """``account``'s balance at the current tip (consensus ledger) —
        never negative, because an overdrawing block cannot connect."""
        return self._ledger.balance(account)

    def balances_snapshot(self) -> dict[str, int]:
        """All non-zero balances at the current tip."""
        return self._ledger.snapshot()

    def nonce(self, account: str) -> int:
        """The seq ``account``'s next transfer must carry (strict account
        nonce — see ledger.py's replay rule)."""
        return self._ledger.nonce(account)

    def next_difficulty(self) -> int:
        """The difficulty consensus requires of the next block on the tip
        — what a miner must put in the header it assembles.  Equal to the
        chain difficulty unless a ``RetargetRule`` is active."""
        return self._expected_difficulty(self._index[self._tip_hash])

    def required_difficulty(self, prev_hash: bytes) -> int | None:
        """The difficulty consensus requires of a child of ``prev_hash``,
        or None when the parent is unknown.  Lets gossip handlers price a
        pushed header at its EXACT contextual work bar before spending any
        state or round trips on it (node.py's compact-block gate)."""
        entry = self._index.get(prev_hash)
        return None if entry is None else self._expected_difficulty(entry)

    def _expected_difficulty(self, prev: _Entry) -> int:
        """Required difficulty for a child of ``prev`` — a pure function
        of the ancestor chain, so every node computes the same value for
        the same parent (side branches included)."""
        rule = self.retarget
        if rule is None:
            return self.difficulty
        height = prev.height + 1
        if height % rule.window != 0:
            return prev.header.difficulty
        # Window boundary: observe the span of the closing window (its
        # first block is `window-1` parents above `prev`; the walk is
        # O(window) once per window, amortized O(1)/block — and headers
        # are always resident, so it never refetches).
        anchor = prev
        for _ in range(rule.window - 1):
            anchor = self._index[anchor.header.prev_hash]
        span = prev.header.timestamp - anchor.header.timestamp
        return rule.adjusted(prev.header.difficulty, span)

    def fee_stats(self, window: int = 32) -> dict:
        """Fee percentiles over the transfers confirmed in the last
        ``window`` main-chain blocks — what a wallet consults to price a
        spend (`p1 tx --fee auto`).  With no recent transfers every
        percentile is 0 and callers fall back to the minimum fee; the
        sample is confirmed-fees-only by design (pending-pool fees are a
        bid book, confirmed fees are what actually cleared)."""
        fees: list[int] = []
        blocks = 0
        for h in reversed(self._main_hashes[-window:] if window else []):
            entry = self._index[h]
            if entry.height <= self.base_height:
                break  # the base block anchors, it does not sample
            blocks += 1
            fees.extend(
                tx.fee for tx in self._block_at(h).txs if not tx.is_coinbase
            )
        fees.sort()

        def pct(p: float) -> int:
            if not fees:
                return 0
            return fees[min(len(fees) - 1, int(p * len(fees)))]

        return {
            "window_blocks": blocks,
            "samples": len(fees),
            "p25": pct(0.25),
            "p50": pct(0.50),
            "p75": pct(0.75),
        }

    def tx_proof(self, txid: bytes) -> TxProof | None:
        """SPV inclusion proof for a main-chain-confirmed transaction, or
        ``None`` if ``txid`` is not confirmed at the current tip.  Served
        from the txid index (O(containing block) worst case) through the
        proof cache: a miss builds proof templates for the WHOLE
        containing block with one merkle tree (amortizing the tree over
        every tx in it — the batch economics of chain/proof.py), a hit
        is a dict lookup plus a tip-height stamp."""
        entry = self.tx_proof_entry(txid)
        return None if entry is None else entry.at_tip(self.height)

    def tx_proof_entry(self, txid: bytes):
        """The cached (tip-height-free) proof entry for ``txid``, or None
        when it is not confirmed on the current main chain.  The wire
        layer uses this to memoize serialized payloads on the entry
        (node/node.py, node/queryplane.py)."""
        bhash = self._tx_index.get(txid)
        if bhash is None:
            return None
        cached = self.proof_cache.get(bhash, txid)
        if cached is not None:
            return cached
        if not self.body_available(bhash):
            # Pruned range (or a read-failed segment): the body this
            # proof's merkle tree needs is gone — refuse cleanly, the
            # same answer an unconfirmed txid gets.
            return None
        # Miss: build every proof for the containing block at once —
        # requests cluster by block (a wallet checking a payment batch,
        # a reorg re-audit), so the amortized fill is the common win.
        block = self._block_at(bhash)
        height = self._index[bhash].height
        txids = [tx.txid() for tx in block.txs]
        for tid, proof in build_block_proofs(block, height, txids).items():
            entry = self.proof_cache.add(bhash, tid, proof)
            if tid == txid:
                cached = entry
        return cached

    def tx_proofs(self, txids) -> dict[bytes, TxProof | None]:
        """Batch proof lookup: one ``TxProof`` (or None) per requested
        txid, sharing a single merkle-tree construction per distinct
        containing block via the proof cache.  The serving plane's
        amortized API (benchmarks/query_plane.py measures it against
        the serial per-proof baseline)."""
        tip = self.height
        out: dict[bytes, TxProof | None] = {}
        for txid in txids:
            entry = self.tx_proof_entry(txid)
            out[txid] = None if entry is None else entry.at_tip(tip)
        return out

    def block_filter(self, block_hash: bytes) -> bytes | None:
        """The compact filter for an indexed block (chain/filters.py),
        from the filter index — rebuilt on demand from the (possibly
        evicted, store-refetchable) body for deep history."""
        if block_hash not in self._index:
            return None
        cached = self.filter_index.get(block_hash)
        if cached is not None:
            return cached
        if not self.body_available(block_hash):
            return None  # pruned body and no cached filter: refuse
        return self.filter_index.get_or_build(block_hash, self._block_at)

    def _sync_filter_headers(self) -> None:
        """Advance ``filter_headers`` to the current main chain.  O(1)
        per plain extension (one filter build, cached in the filter
        index); reorgs walk back by hash comparison.  Pruned bodies
        with no cached filter stop the walk — the commitment stays
        honestly short rather than guessing."""

        def filter_at(height: int) -> bytes | None:
            bh = self.main_hash_at(height)
            return None if bh is None else self.block_filter(bh)

        self.filter_headers.sync(self.height, self.main_hash_at, filter_at)

    def main_hash_at(self, height: int) -> bytes | None:
        """The main-chain block hash at ``height`` (None above the tip,
        and None below an assumed chain's base — heights this index
        simply does not hold) — the filter-serving path's height → hash
        step."""
        i = height - self.base_height
        if 0 <= i < len(self._main_hashes):
            return self._main_hashes[i]
        return None

    # -- snapshot-state plane (chain/snapshot.py) -------------------------

    def state_root(self) -> bytes:
        """Merkle root of the ledger state at the current tip — the
        canonical commitment chain/snapshot.py defines."""
        return state_root(self._ledger._balances, self._ledger._nonces)

    def _is_checkpoint(self, height: int) -> bool:
        if height <= self.base_height:
            return False
        return (
            height % self.checkpoint_interval == 0
            or height in self.checkpoint_extra
        )

    def _ledger_apply(self, block: Block) -> None:
        """Apply one block to the tip ledger, recording the state root
        when the block lands on a checkpoint height — the ONE place
        application happens, so the commitment can never miss a move."""
        self._ledger.apply_block(block)
        self._dirty_accounts.update(block_accounts(block))
        height = self._index[block.block_hash()].height
        if self._is_checkpoint(height):
            self.state_checkpoints[height] = state_root(
                self._ledger._balances, self._ledger._nonces
            )

    def _ledger_undo(self, block: Block) -> None:
        """Reverse one block, dropping any root recorded at its height
        (a reorg onto another branch re-records through
        ``_ledger_apply``)."""
        self._ledger.undo_block(block)
        self._dirty_accounts.update(block_accounts(block))
        self.state_checkpoints.pop(
            self._index[block.block_hash()].height, None
        )

    def collect_dirty_accounts(self) -> set[str]:
        """Consume-and-clear the dirty-account set: every account the
        ledger touched since the previous collection.  The incremental
        snapshot build calls this once per build; between two calls
        the set is a guaranteed superset of the state diff, so entries
        NOT in it are safe to reuse byte-for-byte."""
        dirty = self._dirty_accounts
        self._dirty_accounts = set()
        return dirty

    def snapshot_state(
        self,
    ) -> tuple[int, Block, dict[str, int], dict[str, int], bytes] | None:
        """Materialize the ledger state at the LATEST checkpoint height
        — (height, anchor block, balances, nonces, state root) — by
        rolling a ledger copy back from the tip (O(interval) undos; the
        live ledger is untouched).  None when no checkpoint above the
        base exists yet (too-short chains serve no snapshot).  This is
        what GETSNAPSHOT serving and ``p1 snapshot create`` package."""
        interval = self.checkpoint_interval
        height = (self.height // interval) * interval
        if height <= self.base_height:
            return None
        ledger = self._ledger.copy()
        for h in range(self.height, height, -1):
            ledger.undo_block(
                self._block_at(self._main_hashes[h - self.base_height])
            )
        balances = ledger.snapshot()
        nonces = ledger.nonces_snapshot()
        root = state_root(balances, nonces)
        recorded = self.state_checkpoints.get(height)
        if recorded is not None and recorded != root:
            # The incremental commitment and the rollback disagree —
            # an internal invariant break, never peer input.
            raise RuntimeError(
                f"state root at checkpoint {height} diverged from the "
                "recorded commitment"
            )
        block = self._block_at(self._main_hashes[height - self.base_height])
        return height, block, balances, nonces, root

    def main_chain(self) -> Iterator[Block]:
        """Genesis-first iteration of the current best chain."""
        for h in self._main_hashes:
            yield self._block_at(h)

    def locator(self, dense: int = 10) -> list[bytes]:
        """Hashes from tip back to genesis: the last ``dense`` blocks one by
        one, then exponentially spaced — the classic sync locator shape."""
        return locator_hashes(self._main_hashes, dense)

    def sync_start_height(self, locator: list[bytes]) -> int:
        """The height a GETBLOCKS reply would start at for ``locator``
        — the first hash we recognize on the main chain, plus one.
        Split out so the node can price a request against its prune
        floor BEFORE touching any block body."""
        for h in locator:
            entry = self._index.get(h)
            if entry and self._on_main_chain(h):
                return entry.height + 1
        return self.base_height

    def headers_after(
        self, locator: list[bytes], limit: int = 500
    ) -> list[BlockHeader]:
        """Main-chain HEADERS after the first recognized locator hash —
        the body-free sibling of ``blocks_after`` (headers are always
        resident, so serving a headers-first sync never costs a body
        refetch and keeps working over pruned ranges)."""
        start = self.sync_start_height(locator) - self.base_height
        end = min(start + limit, len(self._main_hashes))
        return [
            self._index[self._main_hashes[i]].header
            for i in range(start, end)
        ]

    def blocks_after(self, locator: list[bytes], limit: int = 500) -> list[Block]:
        """Main-chain blocks after the first locator hash we recognize.

        O(limit) per call: served straight from the height index instead of
        materializing the whole main chain (which made a full peer sync
        O(height²/batch))."""
        start = self.sync_start_height(locator) - self.base_height
        end = min(start + limit, len(self._main_hashes))
        return [
            self._block_at(self._main_hashes[i]) for i in range(start, end)
        ]

    # -- mutation --------------------------------------------------------

    def add_block(self, block: Block, trusted: bool = False) -> AddResult:
        """Index ``block`` (and any orphans it unblocks); report the outcome.

        The reorg paths in the result describe the net tip movement of the
        whole call — computed once against the tip as it was on entry, so
        an orphan cascade that moves the tip twice still reports one
        coherent removed/added pair.

        ``trusted=True`` skips the stateless per-block checks (PoW,
        merkle, signatures, coinbase rules) — strictly for records this
        node itself validated before persisting (ChainStore's fast
        resume: the store is exclusively flocked and append-only, so its
        contents are this node's own past accepts).  Contextual rules
        (difficulty schedule, timestamp bounds) and the connect-time
        ledger/nonce validation still run, so the rebuilt state is
        byte-identical to a full revalidation — tested both ways.

        Hashing discipline: this method (and everything it calls —
        validation, the tx index, reorg paths) asks for ``block_hash()``
        and ``txid()`` freely; both are memoized on the frozen core types
        (core/header.py's cache notes), so the whole add costs ONE header
        digest and ONE digest per transaction regardless of how many
        sites re-ask — for wire/disk-ingested blocks, computed directly
        over the arrival bytes.
        """
        old_tip = self._tip_hash
        bhash = block.block_hash()
        status, reason = self._insert(block, prevalidated=trusted)
        if status is not AddStatus.ACCEPTED:
            return AddResult(status, reason=reason)

        # A newly indexed block may be the missing parent of parked orphans.
        connected = [block]
        pending = [bhash]
        while pending:
            for orphan in self._orphans.pop(pending.pop(), []):
                self._orphan_hashes.discard(orphan.block_hash())
                # Orphans were fully validated when parked; only linkage
                # (now satisfied) was missing — don't re-hash the block.
                st, _ = self._insert(orphan, prevalidated=True)
                if st is AddStatus.ACCEPTED:
                    connected.append(orphan)
                    pending.append(orphan.block_hash())
        # Connected orphans leave _orphans/_orphan_hashes but their FIFO
        # entries linger; compact once the stale fraction dominates so the
        # deque stays O(MAX_ORPHANS) over the node's lifetime.
        if len(self._orphan_fifo) > 2 * MAX_ORPHANS:
            self._orphan_fifo = collections.deque(
                e for e in self._orphan_fifo if e[1] in self._orphan_hashes
            )

        removed, added = self._settle_tip(old_tip)
        if removed:
            del self._main_hashes[len(self._main_hashes) - len(removed) :]
        self._main_hashes.extend(b.block_hash() for b in added)
        # Keep the txid index in lockstep with the main chain (pop the
        # abandoned branch first: a tx confirmed on both branches must end
        # up pointing at its new block).
        for b in removed:
            for tx in b.txs:
                self._tx_index.pop(tx.txid(), None)
            # Reorg event path: proofs cut for an abandoned block must
            # not linger (chain/proof.py's invalidation layer — the tx
            # index above already makes them unreachable; this makes
            # them also stop existing, the property the reorg test pins).
            self.proof_cache.invalidate_block(b.block_hash())
        for b in added:
            bh = b.block_hash()
            for tx in b.txs:
                self._tx_index[tx.txid()] = bh
        # Extend (or reorg-repair) the filter-header commitment chain in
        # the same call that moved the tip — every connect site (mining,
        # gossip, sync, store replay) funnels through here, so the
        # commitment can never lag the chain it commits to.
        self._sync_filter_headers()
        if bhash in self._invalid:
            # Indexed but contextually invalid (its transfers overdraw
            # somewhere on its branch) — callers see a rejection, and the
            # block is excluded from ``connected`` so persistence skips it.
            return AddResult(AddStatus.REJECTED, reason=self._invalid[bhash])
        return AddResult(
            AddStatus.ACCEPTED,
            removed=removed,
            added=added,
            connected=tuple(
                b for b in connected if b.block_hash() not in self._invalid
            ),
        )

    def _settle_tip(
        self, old_tip: bytes
    ) -> tuple[tuple[Block, ...], tuple[Block, ...]]:
        """Advance the ledger to the work-chosen tip, demoting invalid
        branches until a contextually valid tip wins.

        Returns the net (removed, added) paths from ``old_tip`` to the
        settled tip.  Terminates: each failed candidate marks at least one
        block permanently invalid, and ``old_tip`` itself (whose state the
        ledger currently holds) is always a valid fallback.
        """
        # Fast path — the overwhelmingly common case on the ingest hot
        # loop: the new tip is old tip's direct child (plain extension,
        # no reorg walk needed).  Same semantics as the general loop
        # below for this shape, including the invalid-branch fallback.
        if self._tip_hash != old_tip:
            candidate = self._block_at(self._tip_hash)
            if candidate.header.prev_hash == old_tip:
                try:
                    self._ledger_apply(candidate)
                    return (), (candidate,)
                except LedgerError as e:
                    self._mark_invalid_subtree(self._tip_hash, str(e))
                    self._tip_hash = self._best_valid_tip()
        while self._tip_hash != old_tip:
            removed, added = self._reorg_paths(old_tip, self._tip_hash)
            for b in removed:
                self._ledger_undo(b)
            applied: list[Block] = []
            failed: LedgerError | None = None
            for b in added:
                try:
                    self._ledger_apply(b)
                except LedgerError as e:
                    self._mark_invalid_subtree(b.block_hash(), str(e))
                    failed = e
                    break
                applied.append(b)
            if failed is None:
                return removed, added
            # Roll the ledger back to old_tip and re-run fork choice over
            # the remaining valid blocks.
            for b in reversed(applied):
                self._ledger_undo(b)
            for b in reversed(removed):
                self._ledger_apply(b)
            self._tip_hash = self._best_valid_tip()
        return (), ()

    def _mark_invalid_subtree(self, bhash: bytes, reason: str) -> None:
        """Permanently invalidate ``bhash`` and every indexed descendant."""
        pending = [(bhash, reason)]
        while pending:
            h, why = pending.pop()
            if h in self._invalid:
                continue
            self._invalid[h] = why
            pending.extend(
                (c, "descends from invalid block")
                for c in self._children_of(h)
            )

    def _best_valid_tip(self) -> bytes:
        """Most-work non-invalid block (smaller hash on ties) — the same
        ordering ``_insert`` applies incrementally, re-derived over the
        whole index.  Only runs when a branch was just invalidated."""
        best_hash, best = None, None
        for h, entry in self._index.items():
            if h in self._invalid:
                continue
            if (
                best is None
                or entry.work > best.work
                or (entry.work == best.work and h < best_hash)
            ):
                best_hash, best = h, entry
        assert best_hash is not None  # genesis is always valid
        return best_hash

    def _insert(
        self, block: Block, prevalidated: bool = False
    ) -> tuple[AddStatus, str]:
        """Validate + index one block and advance the tip by work."""
        bhash = block.block_hash()
        if bhash in self._index:
            return AddStatus.DUPLICATE, ""
        prev = self._index.get(block.header.prev_hash)
        if prev is None:
            return self._park_orphan(block, bhash)
        # Contextual header rules — they need the parent, so they run here
        # even for prevalidated orphans (parking could only check the
        # block's internal consistency).
        expected = self._expected_difficulty(prev)
        if block.header.difficulty != expected:
            return AddStatus.REJECTED, (
                f"difficulty {block.header.difficulty} != required {expected}"
            )
        if self.retarget is not None:
            # Strict increase (positive retarget spans; time-freezing
            # unprofitable) + the forward-dating cap with its height-1
            # bootstrap-anchor exemption — the rule lives in ONE place,
            # RetargetRule.timestamp_violation, shared with the replay
            # verifier and the miner's clamp.
            reason = self.retarget.timestamp_violation(
                prev.height,
                prev.header.timestamp,
                block.header.timestamp,
            )
            if reason is not None:
                return AddStatus.REJECTED, reason
        if not prevalidated:
            try:
                self.check_block(
                    block,
                    expected,
                    chain_tag=self.genesis.block_hash(),
                    sig_cache=self.sig_cache,
                )
            except ValidationError as e:
                return AddStatus.REJECTED, str(e)
        entry = _Entry(
            block,
            block.header,
            prev.height + 1,
            prev.work + (1 << block.header.difficulty),
        )
        self._index[bhash] = entry
        # Body residency accounting (memory-bounded operation): the
        # serialized length is a cached-bytes len for wire/disk-ingested
        # blocks (encoding cache) and needed for store/gossip anyway for
        # local ones — the gauge costs the hot path nothing.
        self.resident_body_bytes += len(block.serialize())
        self._resident_fifo.append(bhash)
        kids = self._children.get(block.header.prev_hash)
        if kids is None:
            self._children[block.header.prev_hash] = bhash
        elif isinstance(kids, bytes):
            self._children[block.header.prev_hash] = [kids, bhash]
        else:
            kids.append(bhash)
        if block.header.prev_hash in self._invalid:
            # An extension of an invalid branch is invalid by inheritance —
            # index it (dedup/duplicate detection) but never offer it as tip.
            self._invalid[bhash] = "descends from invalid block"
            return AddStatus.ACCEPTED, ""
        tip = self._index[self._tip_hash]
        if entry.work > tip.work or (
            entry.work == tip.work and bhash < self._tip_hash
        ):
            self._tip_hash = bhash
        return AddStatus.ACCEPTED, ""

    # -- memory-bounded operation (body eviction) -------------------------

    def evict_bodies(self, keep_recent: int) -> int:
        """Evict block bodies below the keep window, keeping headers and
        every index structure intact; returns bytes freed.

        Eviction policy, not correctness: only bodies the ``body_source``
        can re-serve (``has_body`` — i.e. durably in the append-only
        store) are dropped, and the last ``keep_recent`` heights stay hot
        (the tip region serves gossip, reorgs, and mining; deep history
        serves only the occasional IBD peer, which can afford the
        refetch).  Side branches below the window evict on the same
        terms.  The sweep walks the insertion-ordered candidate deque,
        so repeated calls cost O(resident), not O(index)."""
        if self.body_source is None or keep_recent < 1:
            return 0
        floor = self.height - keep_recent
        freed = 0
        keep: collections.deque[bytes] = collections.deque()
        while self._resident_fifo:
            bhash = self._resident_fifo.popleft()
            entry = self._index.get(bhash)
            if entry is None or entry.block is None:
                continue  # stale candidate (already evicted)
            if entry.height > floor or not self.body_source.has_body(bhash):
                keep.append(bhash)  # hot window, or not yet durable
                continue
            blen = len(entry.block.serialize())
            entry.block = None
            try:
                # The header's memoized 80-byte encoding goes with the
                # body: repacking is byte-identical (canonical fixed
                # width, tested) and deep-history header serves are rare
                # — another ~113 B/block the evicted region doesn't pin.
                object.__delattr__(entry.header, "_raw")
            except AttributeError:
                pass
            self.resident_body_bytes -= blen
            self.bodies_evicted += 1
            freed += blen
        self._resident_fifo = keep
        return freed

    # -- live re-basing (round 20: the always-on node) --------------------

    def rebase(self, new_base: int) -> dict:
        """Advance the chain's base to ``new_base`` IN PLACE — the
        long-running-node move ``from_snapshot`` performs only at boot:
        everything strictly below the new base (and every side branch
        not descending from it) leaves the in-RAM index, and the chain
        behaves from here on exactly like one booted from a snapshot
        anchored at ``new_base``.  The ledger, tip, and mining are
        untouched — this runs on a live node between awaits.

        Caller's contract (Node.rebase owns it): the history being
        dropped must already be durable and servable from disk — sealed
        segments with their ``.hdrx`` sidecars written
        (``SegmentedStore.ensure_sidecars``) — because after this call
        the only copy of those headers this process can serve is the
        disk plane.

        ``new_base`` must be a checkpoint-interval multiple with a
        recorded state root: the interval equals the retarget window on
        retargeting chains, so ``_expected_difficulty``'s window walk
        can never cross the new base (the same alignment
        ``from_snapshot`` chains rely on), and the recorded root is
        what continuous snapshot publication anchors to.

        Returns ``{"old_base", "new_base", "dropped_blocks",
        "freed_bytes"}``.
        """
        if not self.base_height < new_base <= self.height:
            raise ValueError(
                f"rebase target {new_base} outside "
                f"({self.base_height}, {self.height}]"
            )
        if new_base % self.checkpoint_interval != 0:
            raise ValueError(
                f"rebase target {new_base} not on the "
                f"{self.checkpoint_interval}-block checkpoint cadence"
            )
        if new_base not in self.state_checkpoints:
            raise ValueError(
                f"no recorded state root at rebase target {new_base}"
            )
        base_hash = self._main_hashes[new_base - self.base_height]
        keep = {base_hash}
        pending = [base_hash]
        while pending:
            for c in self._children_of(pending.pop()):
                if c not in keep:
                    keep.add(c)
                    pending.append(c)
        dropped = [h for h in self._index if h not in keep]
        freed = 0
        for h in dropped:
            entry = self._index.pop(h)
            if entry.block is not None and h != self._base_body_unaccounted:
                freed += len(entry.block.serialize())
            self.proof_cache.invalidate_block(h)
            # Orphans parked on a dropped block can never connect —
            # nothing below the base can ever re-index (its parent is
            # gone too, recursively).  Their FIFO entries go stale and
            # the existing sweep skips them.
            for orphan in self._orphans.pop(h, []):
                self._orphan_hashes.discard(orphan.block_hash())
        self.resident_body_bytes -= freed
        self._base_body_unaccounted = None
        self._tx_index = {
            t: h for t, h in self._tx_index.items() if h in keep
        }
        self._children = {
            h: kids for h, kids in self._children.items() if h in keep
        }
        self._invalid = {
            h: why for h, why in self._invalid.items() if h in keep
        }
        self.state_checkpoints = {
            h: r for h, r in self.state_checkpoints.items() if h >= new_base
        }
        self.checkpoint_extra = {
            h for h in self.checkpoint_extra if h > new_base
        }
        old_base = self.base_height
        self._main_hashes = self._main_hashes[new_base - self.base_height :]
        self.base_height = new_base
        return {
            "old_base": old_base,
            "new_base": new_base,
            "dropped_blocks": len(dropped),
            "freed_bytes": freed,
        }

    # -- internals -------------------------------------------------------

    def _children_of(self, bhash: bytes) -> tuple[bytes, ...]:
        """``bhash``'s indexed children, normalized over the compact
        one-child representation."""
        kids = self._children.get(bhash)
        if kids is None:
            return ()
        if isinstance(kids, bytes):
            return (kids,)
        return tuple(kids)

    def _park_orphan(self, block: Block, bhash: bytes) -> tuple[AddStatus, str]:
        """Hold a parentless block until its parent arrives — safely.

        The block must carry its own valid PoW (full stateless validation)
        before it costs us memory, and the pool is FIFO-capped: unconnectable
        junk from a hostile peer evicts, it does not accumulate.

        On a retargeting chain the parent-dependent required difficulty is
        unknowable here, so parking checks PoW at the block's *claimed*
        difficulty and ``_insert`` re-checks the claim against the parent
        when the orphan connects.  A flood of cheap low-difficulty orphans
        is still bounded by the FIFO cap — it can churn the pool, never
        grow it — and a genuine gap is backfilled by locator sync anyway.
        """
        if bhash in self._orphan_hashes:
            return AddStatus.ORPHAN, "already parked"
        claimed = (
            block.header.difficulty
            if self.retarget is not None
            else self.difficulty
        )
        if claimed < 1:
            # Difficulty 0 passes every PoW check vacuously — a literally
            # free frame must not be able to evict orphans that cost real
            # work (same floor as proof.py's SPV check).
            return AddStatus.REJECTED, "difficulty-0 block carries no work"
        try:
            self.check_block(
                block,
                claimed,
                chain_tag=self.genesis.block_hash(),
                sig_cache=self.sig_cache,
            )
        except ValidationError as e:
            return AddStatus.REJECTED, str(e)
        self._orphans.setdefault(block.header.prev_hash, []).append(block)
        self._orphan_hashes.add(bhash)
        self._orphan_fifo.append((block.header.prev_hash, bhash))
        while len(self._orphan_hashes) > MAX_ORPHANS:
            self._evict_oldest_orphan()
        return AddStatus.ORPHAN, ""

    def _evict_oldest_orphan(self) -> None:
        while self._orphan_fifo:
            prev_hash, bhash = self._orphan_fifo.popleft()
            if bhash not in self._orphan_hashes:
                continue  # stale entry: orphan was connected meanwhile
            waiting = self._orphans.get(prev_hash, [])
            for i, blk in enumerate(waiting):
                if blk.block_hash() == bhash:
                    waiting.pop(i)
                    break
            if not waiting:
                self._orphans.pop(prev_hash, None)
            self._orphan_hashes.discard(bhash)
            return

    def _on_main_chain(self, block_hash: bytes) -> bool:
        entry = self._index[block_hash]
        i = entry.height - self.base_height
        return 0 <= i < len(self._main_hashes) and self._main_hashes[i] == block_hash

    def _reorg_paths(
        self, old_tip: bytes, new_tip: bytes
    ) -> tuple[tuple[Block, ...], tuple[Block, ...]]:
        """(removed old-tip-first, added fork-point-first) between two tips."""
        a, b = old_tip, new_tip
        removed: list[Block] = []
        added: list[Block] = []
        while self._index[a].height > self._index[b].height:
            removed.append(self._block_at(a))
            a = self._index[a].header.prev_hash
        while self._index[b].height > self._index[a].height:
            added.append(self._block_at(b))
            b = self._index[b].header.prev_hash
        while a != b:
            removed.append(self._block_at(a))
            added.append(self._block_at(b))
            a = self._index[a].header.prev_hash
            b = self._index[b].header.prev_hash
        return tuple(removed), tuple(reversed(added))
