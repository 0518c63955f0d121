"""Block = header + transactions, with a SHA-256d merkle root.

The port's copy of ``p1_tpu/core/block.py`` (same names, same bytes).

Capability parity: block assembly from the mempool and header-chain
validation (BASELINE.json:5).  The merkle tree is the classic construction:
leaves are txids, pairs are combined with SHA-256d, an odd node is paired
with itself, and an empty transaction list has an all-zeros root.
"""

from __future__ import annotations

import dataclasses
import struct

from p1_tpu_torch.core.header import HEADER_SIZE, BlockHeader
from p1_tpu_torch.core.tx import Transaction

EMPTY_MERKLE_ROOT = bytes(32)
_U32 = struct.Struct(">I")


def merkle_root(txids: list[bytes]) -> bytes:
    """Classic duplicate-last-odd-leaf merkle tree.

    The duplication means ``[t1,t2,t3]`` and ``[t1,t2,t3,t3]`` share a root
    (the CVE-2012-2459 malleability); chain validation therefore rejects
    blocks containing duplicate txids — see chain/validate.py.
    """
    if not txids:
        return EMPTY_MERKLE_ROOT
    from p1_tpu_torch.core.hashutil import sha256d

    level = list(txids)
    while len(level) > 1:
        if len(level) % 2:
            level.append(level[-1])
        level = [
            sha256d(level[i] + level[i + 1]) for i in range(0, len(level), 2)
        ]
    return level[0]


def merkle_levels(txids: list[bytes]) -> list[list[bytes]]:
    """Every level of the merkle tree, leaves (level 0, with the odd-tail
    duplication applied per level) up to the root level.

    The batched-proof primitive (chain/proof.py): building the tree once
    costs the same ~2N hashes as one ``merkle_branch`` call, but with
    the levels held, EVERY transaction's branch is then O(log N) slice
    picks — amortizing the tree across all proofs for one block is what
    turns per-proof merkle reconstruction from the serving plane's
    dominant cost into noise (benchmarks/query_plane.py).
    """
    if not txids:
        raise ValueError("no txids")
    from p1_tpu_torch.core.hashutil import sha256d

    level = list(txids)
    levels = []
    while len(level) > 1:
        if len(level) % 2:
            level.append(level[-1])
        levels.append(level)
        level = [
            sha256d(level[i] + level[i + 1]) for i in range(0, len(level), 2)
        ]
    levels.append(level)
    return levels


def branch_from_levels(levels: list[list[bytes]], index: int) -> tuple[bytes, ...]:
    """The sibling path for leaf ``index`` out of a prebuilt
    ``merkle_levels`` tree — one slice pick per level, no hashing."""
    branch: list[bytes] = []
    i = index
    for level in levels[:-1]:
        branch.append(level[i ^ 1])
        i //= 2
    return tuple(branch)


def merkle_branch(txids: list[bytes], index: int) -> tuple[bytes, ...]:
    """The sibling path proving ``txids[index]`` is under ``merkle_root(txids)``.

    One 32-byte sibling per tree level, leaf-to-root order — the compact
    inclusion proof an SPV client checks with ``verify_merkle_branch``
    without seeing the other transactions.  Built via ``merkle_levels``
    (ONE tree construction shared with the batched-proof path), so the
    root and branch functions agree for every (txids, index) by
    construction.
    """
    if not 0 <= index < len(txids):
        raise ValueError(f"index {index} out of range for {len(txids)} txids")
    return branch_from_levels(merkle_levels(txids), index)


def verify_merkle_branch(
    txid: bytes, index: int, branch: tuple[bytes, ...], root: bytes
) -> bool:
    """Does ``branch`` prove that leaf ``txid`` sits at ``index`` under
    ``root``?  Pure recombination — the verifier needs nothing but these
    arguments.  Soundness note: with the duplicate-odd-leaf construction a
    root does not uniquely determine the leaf *list* (CVE-2012-2459), but
    consensus rejects duplicate txids per block, so for valid blocks a
    verified (txid, index, root) triple pins a real on-chain transaction.
    """
    if index < 0:
        return False
    from p1_tpu_torch.core.hashutil import sha256d

    cur = txid
    i = index
    for sib in branch:
        cur = sha256d(cur + sib) if i % 2 == 0 else sha256d(sib + cur)
        i //= 2
    # i must be exhausted: an index >= 2**depth cannot name a leaf of this
    # tree, and accepting one would let a prover relocate the transaction.
    return i == 0 and cur == root


@dataclasses.dataclass(frozen=True)
class Block:
    """Header + transactions.

    Canonical-encoding cache: ``serialize()`` memoizes its wire form and
    ``compute_merkle_root()`` its root (non-field slots via
    ``object.__setattr__`` — see BlockHeader's cache notes for why
    equality and ``dataclasses.replace`` stay unaffected).
    ``deserialize`` seeds the block's, header's, and every transaction's
    caches with the exact wire slices: one gossip frame is parsed once
    and its bytes then flow unchanged through validation digests, the
    store append, and relay re-encode — the zero-repack pipeline.
    """

    header: BlockHeader
    txs: tuple[Transaction, ...] = ()

    def block_hash(self) -> bytes:
        return self.header.block_hash()

    def compute_merkle_root(self) -> bytes:
        root = self.__dict__.get("_merkle")
        if root is None:
            root = merkle_root([tx.txid() for tx in self.txs])
            object.__setattr__(self, "_merkle", root)
        return root

    def merkle_ok(self) -> bool:
        return self.header.merkle_root == self.compute_merkle_root()

    def serialize(self) -> bytes:
        raw = self.__dict__.get("_raw")
        if raw is None:
            parts = [self.header.serialize(), _U32.pack(len(self.txs))]
            for tx in self.txs:
                tx_raw = tx.serialize()
                parts.append(_U32.pack(len(tx_raw)))
                parts.append(tx_raw)
            raw = b"".join(parts)
            object.__setattr__(self, "_raw", raw)
        return raw

    @classmethod
    def deserialize(cls, data: bytes) -> "Block":
        if len(data) < HEADER_SIZE + 4:
            raise ValueError("truncated block")
        header = BlockHeader.deserialize(data[:HEADER_SIZE])
        (ntx,) = _U32.unpack_from(data, HEADER_SIZE)
        off = HEADER_SIZE + 4
        total = len(data)
        txs = []
        for _ in range(ntx):
            if total < off + 4:
                raise ValueError("truncated block tx table")
            (txlen,) = _U32.unpack_from(data, off)
            off += 4
            if total < off + txlen:
                raise ValueError("truncated block tx")
            txs.append(Transaction.deserialize(data[off : off + txlen]))
            off += txlen
        if off != total:
            raise ValueError(f"{total - off} trailing bytes after block")
        # Direct construction (Block has no __post_init__ to honor); the
        # parse consumed data exactly (strict framing, per-field
        # round-trip identity), so these bytes are the canonical encoding.
        block = object.__new__(cls)
        block.__dict__.update(header=header, txs=tuple(txs), _raw=bytes(data))
        return block
