"""SPV transaction-inclusion proofs (light-client verification).

Capability parity: a "Bitcoin-like toy cryptocurrency" (BASELINE.json:5)
whose wallets already query balance/nonce over the wire (GETACCOUNT) also
owes them the other classic light-client primitive: *prove that my
transaction is confirmed* without downloading blocks.  A ``TxProof`` is the
standard SPV bundle — the transaction, its block header, and the merkle
sibling path — verified client-side with three checks that need no chain
state at all:

The port's copy of ``p1_tpu/chain/proof.py``: the same proof bundles
and verdicts.

1. the header carries real proof-of-work at the chain's difficulty,
2. the merkle branch links the txid to that header's commitment, and
3. the transaction itself is well-formed for this chain (Ed25519 ownership
   proof, chain-bound signature, coinbase subsidy rules).

Honesty about the trust model (documented, not hidden): this is
*one-header* SPV.  The proof pins the transaction to **a** valid
proof-of-work block, but whether that block is on the current best chain is
attested only by the serving peer (``tip_height`` → ``confirmations`` is
the peer's claim).  Lying costs the attacker a real block's worth of work —
the same bar Bitcoin SPV sets per header — and a client that wants more can
cross-check several peers or replay the full header chain with
``p1_tpu_torch.chain.replay`` (the header-chain verifier a full light client
would run; ``replay_host`` takes the chain's ``RetargetRule`` and
recomputes the contextual difficulty schedule, so it works on retargeting
chains too — ``p1 replay --method host``).  The serving side computes proofs from a txid index maintained
at the tip (``Chain.tx_proof``), so queries are O(block size), not
O(chain).
"""

from __future__ import annotations

import collections
import dataclasses

from p1_tpu_torch.core.block import verify_merkle_branch
from p1_tpu_torch.core.header import BlockHeader, meets_target
from p1_tpu_torch.core.tx import BLOCK_REWARD, Transaction


class SPVError(Exception):
    """A transaction-inclusion proof failed verification."""


@dataclasses.dataclass(frozen=True)
class TxProof:
    """Everything a light client needs to check one confirmed transaction."""

    tx: Transaction
    header: BlockHeader  # the block that confirmed it
    height: int  # that block's main-chain height (server's view)
    tip_height: int  # server's tip height when the proof was cut
    index: int  # tx position in the block
    branch: tuple[bytes, ...]  # merkle sibling path, leaf-to-root

    @property
    def confirmations(self) -> int:
        return self.tip_height - self.height + 1


def verify_tx_proof(
    proof: TxProof,
    difficulty: int,
    chain_tag: bytes,
    txid: bytes | None = None,
    retarget=None,
) -> None:
    """Raise ``SPVError`` unless ``proof`` checks out for the chain whose
    base difficulty, genesis hash (``chain_tag``) and optional
    ``RetargetRule`` are given.

    Pure function of its arguments — this is the *client* side, run by
    wallets that hold no chain.  ``txid`` pins the proof to the transaction
    the caller asked about (a peer answering with a different, valid proof
    must not pass).

    Work-bar honesty on retargeting chains: the difficulty consensus
    required at the proof's height is contextual (a function of the whole
    ancestor chain — chain/chain.py), which a stateless verifier cannot
    recompute.  So with ``retarget`` set, the check is proof-of-work at
    the header's claimed difficulty, **floored by what the rule could
    legitimately have reached by the claimed height**: difficulty moves
    at most ``max_adjust`` bits per completed window, so a proof at
    height h may claim no less than ``base - max_adjust * (h // window)``
    bits.  Be clear about what that buys: ``height`` and ``tip_height``
    are themselves peer claims, so a forger willing to claim a height of
    ``~window * (base-1) / max_adjust`` blocks (where the floor decays to
    1) still gets ~2-hash evidence past this check, with a plausible
    confirmation count — the floor only forces the lie into the height
    field, it cannot price it.  Stateless one-header SPV fundamentally
    cannot do better on a retargeting chain; clients that need the real
    bar MUST anchor against a locally verified header chain (``p1 proof
    --headers``), which checks the claimed height against real blocks and
    recomputes confirmations locally.  Fixed-difficulty chains (every
    benchmark config) keep the strict equality check.
    """
    header = proof.header
    have_txid = proof.tx.txid()
    if txid is not None and have_txid != txid:
        raise SPVError("proof is for a different transaction")
    if proof.tip_height < proof.height:
        # Both are peer-claimed u32s; a tip below the confirming height is
        # internally inconsistent evidence (and would print negative
        # confirmations to wallet scripts).
        raise SPVError(
            f"tip height {proof.tip_height} below confirming height "
            f"{proof.height}"
        )
    if retarget is None:
        if header.difficulty != difficulty:
            raise SPVError(
                f"header difficulty {header.difficulty} != chain "
                f"difficulty {difficulty}"
            )
    else:
        # The schedule floor: per-window drift is clamped to max_adjust
        # bits, so 2-hash evidence (difficulty 1) requires claiming
        # enough elapsed windows to have legitimately drifted that far.
        floor = max(
            1,
            difficulty
            - retarget.max_adjust * (proof.height // retarget.window),
        )
        if header.difficulty < floor:
            raise SPVError(
                f"claimed difficulty {header.difficulty} below the "
                f"schedule floor {floor} for height {proof.height} "
                f"(base {difficulty}, ≤{retarget.max_adjust} bits per "
                f"{retarget.window}-block window)"
            )
    if proof.height == 0:
        # Genesis anchors by identity, not work (core/genesis.py) — the
        # only height-0 header a client accepts is the chain tag itself.
        if header.block_hash() != chain_tag:
            raise SPVError("height-0 header is not this chain's genesis")
    elif not meets_target(header.block_hash(), header.difficulty):
        raise SPVError("header does not meet proof-of-work target")
    if not verify_merkle_branch(
        have_txid, proof.index, proof.branch, header.merkle_root
    ):
        raise SPVError("merkle branch does not link txid to header")
    tx = proof.tx
    if tx.is_coinbase:
        # Mirror consensus' stateless coinbase rules (chain/validate.py):
        # first position, exact subsidy, unsigned.
        if proof.index != 0:
            raise SPVError("coinbase proven at index > 0")
        if tx.amount != BLOCK_REWARD:
            raise SPVError(f"coinbase mints {tx.amount}, subsidy is {BLOCK_REWARD}")
        if not tx.verify_signature():
            raise SPVError("coinbase must be unsigned")
    else:
        if tx.chain != chain_tag:
            raise SPVError("transaction signed for a different chain")
        if not tx.verify_signature():
            raise SPVError("bad transaction signature")


# -- the serving plane's proof cache (round 9) ---------------------------


class CachedProof:
    """One cached inclusion proof: the reorg-STABLE part of a ``TxProof``.

    Everything here — the transaction, its block's header, the block's
    height (a pure function of its ancestor chain, immutable however
    fork choice moves), the tx index, the merkle branch — is fixed the
    moment the block exists.  The one field that moves with every new
    block, ``tip_height``, is deliberately NOT cached: the serving path
    stamps the current tip into a ``dataclasses.replace`` (object path)
    or patches four bytes of the memoized wire payload (hot path), so a
    cache entry stays byte-correct across any number of tip advances.

    ``payload`` is a slot the WIRE layer fills lazily (the serialized
    PROOF frame with tip_height zeroed — node/protocol.py owns the
    encoding; this module stays protocol-free).  ``ProofCache`` charges
    it to the entry's size when notified.
    """

    __slots__ = ("proof", "payload")

    def __init__(self, proof: TxProof):
        self.proof = proof  # tip_height == 0 template
        self.payload: bytes | None = None

    def at_tip(self, tip_height: int) -> TxProof:
        return dataclasses.replace(self.proof, tip_height=tip_height)

    def approx_bytes(self) -> int:
        p = self.proof
        return (
            len(p.tx.serialize())
            + 80  # header
            + 32 * len(p.branch)
            + 96  # object/key overhead estimate
            + (len(self.payload) if self.payload is not None else 0)
        )


class ProofCache:
    """Bounded LRU of ``CachedProof`` entries keyed ``(block hash, txid)``.

    Reorg safety has two independent layers:

    - the LOOKUP layer: ``Chain.tx_proof`` resolves txid → containing
      main-chain block through ``_tx_index``, which every tip move
      rewrites — so a cached proof for an orphaned block is unreachable
      the instant the reorg lands, whatever this cache holds;
    - the INVALIDATION layer: the chain's reorg event path
      (``add_block``'s removed list) explicitly drops every entry for
      each abandoned block (``invalidate_block``), so stale entries
      also stop costing memory — and the "never served stale" property
      does not depend on a single index staying coherent (tested:
      tests/test_queryplane.py's reorg case asserts both layers).

    Bounded by bytes, LRU evicted; ``bytes_used`` is charged to the
    node's accounted memory gauge (node/node.py ``_memory_gauge``) like
    every other cache the governor watches.
    """

    def __init__(self, max_bytes: int = 8 << 20):
        self.max_bytes = int(max_bytes)
        self._lru: "collections.OrderedDict[tuple[bytes, bytes], CachedProof]" = (
            collections.OrderedDict()
        )
        #: block hash -> set of txids cached under it (O(block) reorg
        #: invalidation without scanning the whole LRU).
        self._by_block: dict[bytes, set[bytes]] = {}
        self.bytes_used = 0
        self.hits = 0
        self.misses = 0
        self.invalidated = 0

    def __len__(self) -> int:
        return len(self._lru)

    def get(self, block_hash: bytes, txid: bytes) -> CachedProof | None:
        entry = self._lru.get((block_hash, txid))
        if entry is None:
            self.misses += 1
            return None
        self._lru.move_to_end((block_hash, txid))
        self.hits += 1
        return entry

    def add(self, block_hash: bytes, txid: bytes, proof: TxProof) -> CachedProof:
        """Cache ``proof`` (tip_height is zeroed here — templates never
        embed a tip) and return the entry."""
        key = (block_hash, txid)
        entry = self._lru.get(key)
        if entry is not None:
            self._lru.move_to_end(key)
            return entry
        if proof.tip_height:
            proof = dataclasses.replace(proof, tip_height=0)
        entry = CachedProof(proof)
        self._lru[key] = entry
        self._by_block.setdefault(block_hash, set()).add(txid)
        self.bytes_used += entry.approx_bytes()
        self._evict()
        return entry

    def note_payload(self, entry: CachedProof, payload: bytes) -> None:
        """The wire layer memoized ``entry``'s serialized form — account
        for the extra bytes (and re-run eviction against the budget)."""
        if entry.payload is None:
            entry.payload = payload
            self.bytes_used += len(payload)
            self._evict()

    def _evict(self) -> None:
        while self.bytes_used > self.max_bytes and len(self._lru) > 1:
            (bhash, txid), entry = self._lru.popitem(last=False)
            self.bytes_used -= entry.approx_bytes()
            txids = self._by_block.get(bhash)
            if txids is not None:
                txids.discard(txid)
                if not txids:
                    del self._by_block[bhash]

    def invalidate_block(self, block_hash: bytes) -> int:
        """Drop every entry for ``block_hash`` (the reorg event path);
        returns how many were dropped."""
        txids = self._by_block.pop(block_hash, None)
        if not txids:
            return 0
        n = 0
        for txid in txids:
            entry = self._lru.pop((block_hash, txid), None)
            if entry is not None:
                self.bytes_used -= entry.approx_bytes()
                n += 1
        self.invalidated += n
        return n

    def snapshot(self) -> dict:
        return {
            "entries": len(self._lru),
            "bytes": self.bytes_used,
            "hits": self.hits,
            "misses": self.misses,
            "invalidated": self.invalidated,
        }


def build_block_proofs(
    block, height: int, txids: list[bytes] | None = None
) -> dict[bytes, TxProof]:
    """Tip-height-0 proof templates for EVERY transaction in ``block`` —
    the batch primitive: one ``merkle_levels`` tree construction
    amortized across all of the block's proofs (vs one O(ntx) hashing
    pass per proof on the serial path).  ``txids`` may carry the
    precomputed txid list when the caller already has it."""
    from p1_tpu_torch.core.block import branch_from_levels, merkle_levels

    if txids is None:
        txids = [tx.txid() for tx in block.txs]
    levels = merkle_levels(txids)
    return {
        txid: TxProof(
            tx=block.txs[i],
            header=block.header,
            height=height,
            tip_height=0,
            index=i,
            branch=branch_from_levels(levels, i),
        )
        for i, txid in enumerate(txids)
    }
