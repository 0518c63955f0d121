"""Deterministic genesis header of a fixed-difficulty chain.

The port's copy of the fixed-difficulty half of ``p1_tpu/core/genesis.py``:
zero prev-hash, the empty merkle root, a fixed timestamp, nonce 0.  Mining
starts from this header's hash.  The retarget commitment and the ``Block``
wrapper arrive with the slice that ports ``core/block.py`` and ``tx.py``.
"""

from __future__ import annotations

from p1_tpu_torch.core.header import BlockHeader

GENESIS_VERSION = 1
GENESIS_TIMESTAMP = 1735689600  # 2025-01-01T00:00:00Z, fixed forever
#: The merkle root of a block with no transactions (``core/block.py``).
EMPTY_MERKLE_ROOT = bytes(32)


def genesis_header(difficulty: int) -> BlockHeader:
    """``make_genesis(difficulty).header`` of the JAX package, byte for byte."""
    return BlockHeader(
        version=GENESIS_VERSION,
        prev_hash=bytes(32),
        merkle_root=EMPTY_MERKLE_ROOT,
        timestamp=GENESIS_TIMESTAMP,
        difficulty=difficulty,
        nonce=0,
    )
