"""Stateless block validation rules.

The port's copy of ``p1_tpu/chain/validate.py``: ``check_block`` and
``preverify_signatures`` give the same verdicts and the same error text.
Their signature batches run on the card (``hashx/ed25519_msm.py``, the
``device`` rung ``core/keys.py`` resolves to) unless the caller pins the
plain version (``keys.set_sig_backend("device", device="cpu")``), the
native C++ rung or the pure-Python one.

Capability parity: the reference's "chain-validation code paths"
(BASELINE.json:5).  Rules enforced here need no chain context beyond the
expected difficulty; linkage/height rules live in ``chain.py`` where the
block index is.

Validation fast lane (round 8): signature checking is **batch-first**.
Cheap hash/structure checks still gate exactly as before, then every
signature the verify-once cache (core/sigcache.py) cannot vouch for is
verified as ONE batch (``keys.verify_batch`` — one subgroup-gated
multi-scalar multiplication per chunk, on the card under the ``device``
rung, in Python on the ``pure-python`` rung).  Equivalence with the
serial path is a hard contract, held two ways:

- **Outcome**: batch acceptance implies serial acceptance of every
  member, and a batch failure is settled by ``keys.first_invalid``'s
  serial confirmation — which may conclude NO signature is serially
  invalid (the fallback gate rejects torsion-crafted inputs the serial
  equation tolerates), in which case the block is accepted exactly as
  the serial path would.  Rejected transaction and raised error text
  are byte-identical to what the old per-tx loop produced —
  property-tested with corrupted signatures at every position and with
  torsion-crafted fixtures (tests/test_sigbatch.py, and against the
  JAX package by tests/test_torch_sigbatch.py).
- **Ordering**: serial validation interleaves per-tx structural checks
  with per-tx signature checks, and every signature failure raises the
  same text regardless of index — so running the structural walk first
  and the signature batch second can only ever change WHICH failing
  transaction gets named between two failures that share one message.
  The walk records the first structural error and raises it only after
  the signatures of every EARLIER transaction proved valid, preserving
  the serial precedence.
"""

from __future__ import annotations

from p1_tpu_torch.core import keys as _keys
from p1_tpu_torch.core import sigcache as _sigcache
from p1_tpu_torch.core.block import Block, merkle_root
from p1_tpu_torch.core.genesis import genesis_hash
from p1_tpu_torch.core.header import meets_target
from p1_tpu_torch.core.tx import BLOCK_REWARD


class ValidationError(Exception):
    """A block or header failed consensus validation."""


def check_block(
    block: Block,
    expected_difficulty: int,
    *,
    is_genesis: bool = False,
    chain_tag: bytes | None = None,
    sig_cache=None,
) -> None:
    """Raise ``ValidationError`` unless ``block`` is internally valid.

    Checks: declared difficulty matches the chain's, proof-of-work meets the
    target (waived for genesis, which anchors by identity), the merkle root
    commits to exactly these transactions, no txid appears twice —
    the duplicate-txid rejection promised at core/block.py:25
    (CVE-2012-2459: duplicating the odd tail leaf forges a same-root block) —
    the coinbase mints exactly ``BLOCK_REWARD`` (a hostile miner cannot set
    an arbitrary subsidy; fees are credited separately by the ledger), and
    every transfer carries a valid Ed25519 ownership proof (only the key
    holder can spend) — consulted against ``sig_cache`` first (None = the
    process default), then batch-verified (module docstring).
    """
    # Digest costs here are one-time per object: block_hash/txid/merkle
    # are memoized on the frozen types, and for a wire-ingested block
    # they digest the arrival bytes — validation adds no packing.
    header = block.header
    if header.difficulty != expected_difficulty:
        raise ValidationError(
            f"difficulty {header.difficulty} != chain difficulty {expected_difficulty}"
        )
    if not is_genesis and not meets_target(block.block_hash(), header.difficulty):
        raise ValidationError("proof of work does not meet target")
    txids = [tx.txid() for tx in block.txs]
    if len(set(txids)) != len(txids):
        raise ValidationError("duplicate txid in block")
    # Structure before signatures (cheap hash checks gate the Ed25519
    # verifies): the root must commit to these exact transactions
    # before their ownership proofs are worth checking.  The root is
    # recombined from the txid list already in hand (one digest pass per
    # transaction for the whole check).
    if merkle_root(txids) != header.merkle_root:
        raise ValidationError("merkle root mismatch")
    # The chain id transfers must be signed for: the ACTUAL genesis when
    # the caller has one (Chain passes its own — which may be a custom
    # genesis — so we never diverge from what HELLO/mempool advertise);
    # derived from the difficulty for standalone stateless checks.
    if chain_tag is None:
        chain_tag = genesis_hash(expected_difficulty)
    if sig_cache is None:
        sig_cache = _sigcache.DEFAULT
    # Structural walk: everything per-tx that is cheap — coinbase
    # placement/subsidy/bareness, the chain tag, the sender-fingerprint
    # binding, and the cache consult.  Stops at the first structural
    # failure; the expensive Ed25519 math for the transactions BEFORE it
    # still runs below, because serially an earlier bad signature would
    # have been reported first.
    structural: str | None = None
    pending = []  # transactions whose Ed25519 proof still needs checking
    for i, tx in enumerate(block.txs):
        if tx.is_coinbase:
            # A coinbase (block-reward tx) is optional, but if present it
            # must be the first transaction and unique — any coinbase at
            # index > 0 covers both the misplaced and the duplicate case.
            if i > 0:
                structural = "coinbase transaction must be first and unique"
                break
            if tx.amount != BLOCK_REWARD:
                structural = (
                    f"coinbase mints {tx.amount}, subsidy is {BLOCK_REWARD}"
                )
                break
            if tx.pubkey or tx.sig or tx.chain:
                structural = "coinbase must be unsigned"
                break
            continue
        if tx.chain != chain_tag:
            # The signature is chain-bound: a spend signed for another
            # chain (or with no tag at all) cannot be replayed here.
            structural = "transaction signed for a different chain"
            break
        if tx.sender != _keys.account_id_or_none(tx.pubkey):
            structural = "bad transaction signature"
            break
        if not sig_cache.hit(tx.txid(), tx.pubkey, tx.sig):
            pending.append(tx)
    if pending:
        triples = [
            (tx.pubkey, tx.sig, tx.signing_bytes()) for tx in pending
        ]
        if len(pending) >= _keys.BATCH_MIN:
            ok = _keys.verify_batch(triples)
            if not ok:
                # A failed batch is not yet a verdict: the fallback's
                # subgroup gate also rejects torsion-crafted inputs the
                # serial equation tolerates, so the serial confirmation
                # decides — identical outcome AND identical error text
                # to the per-tx loop, whichever way it lands.
                ok = _keys.first_invalid(triples) is None
        else:
            ok = all(
                _keys.verify(*t) for t in triples
            )  # tiny blocks: batch setup costs more than it saves
        if not ok:
            raise ValidationError("bad transaction signature")
        for tx in pending:
            sig_cache.add(tx.txid(), tx.pubkey, tx.sig)
    if structural is not None:
        raise ValidationError(structural)


#: Signatures per pre-verification window: what the deep-sync and
#: revalidation paths accumulate before one ``verify_batch`` call.
#: ``keys.verify_batch`` splits it into chunks of ``keys.BATCH_CHUNK``
#: (four device launches under the ``device`` rung), and the buffered
#: window keeps streaming resume memory O(window).
PREVERIFY_WINDOW = 4096


def preverify_signatures(txs, chain_tag: bytes, sig_cache=None) -> int:
    """Optimistically batch-verify transfer signatures into the cache.

    A pure cache-warmer for the untrusted bulk paths (store revalidation,
    deep-sync block batches, mempool sync pages): transactions whose
    Ed25519 proof checks out are recorded in ``sig_cache`` so the
    per-block ``check_block`` that follows hits instead of paying the
    backend; everything that does NOT check out here (bad signature,
    foreign tag, fingerprint mismatch) is simply left uncached, and the
    consensus path re-derives its exact serial verdict.  Cannot change
    any outcome — only where the verify cost is paid.  Returns the
    number of signatures proven (cache hits don't count).
    """
    if sig_cache is None:
        sig_cache = _sigcache.DEFAULT
    candidates = []
    for tx in txs:
        if (
            tx.is_coinbase
            or tx.chain != chain_tag
            or tx.sender != _keys.account_id_or_none(tx.pubkey)
        ):
            continue  # structurally doomed or unsigned: not our problem
        if not sig_cache.hit(tx.txid(), tx.pubkey, tx.sig):
            candidates.append(tx)
    proven = 0
    stack = [candidates] if candidates else []
    while stack:
        group = stack.pop()
        triples = [(tx.pubkey, tx.sig, tx.signing_bytes()) for tx in group]
        if _keys.verify_batch(triples):
            for tx in group:
                sig_cache.add(tx.txid(), tx.pubkey, tx.sig)
            proven += len(group)
        elif len(group) == 1:
            # Settled serially (a singleton batch IS the serial path —
            # size < BATCH_MIN), so an uncached leftover here really is
            # a serial reject, never a torsion false-negative.
            continue  # genuinely bad: leave uncached for the serial path
        else:
            # Bisect: cache the valid side(s), isolate the bad ones.
            mid = len(group) // 2
            stack.append(group[mid:])
            stack.append(group[:mid])
    return proven
