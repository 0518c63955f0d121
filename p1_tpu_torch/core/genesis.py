"""Deterministic genesis header of a chain configuration.

The port's copy of the header half of ``p1_tpu/core/genesis.py``: zero
prev-hash, a fixed timestamp, nonce 0, and in the merkle field either the
empty root (fixed difficulty) or the commitment to the retarget rule's
parameters, so two chains with different rules have different ids.
Mining and replay start from this header's hash; ``make_genesis`` wraps
it in a ``Block`` with no transactions, as ``p1_tpu``'s does.
"""

from __future__ import annotations

import functools
import struct

from p1_tpu_torch.core.block import EMPTY_MERKLE_ROOT, Block
from p1_tpu_torch.core.hashutil import sha256d
from p1_tpu_torch.core.header import BlockHeader
from p1_tpu_torch.core.retarget import RetargetRule

GENESIS_VERSION = 1
GENESIS_TIMESTAMP = 1735689600  # 2025-01-01T00:00:00Z, fixed forever
#: v2: the commitment gained max_step (the forward-dating bound) — a
#: chain with a different cap is a different chain.
_RETARGET_TAG = b"p1-retarget-v2"


@functools.lru_cache(maxsize=256)
def genesis_header(difficulty: int, retarget: RetargetRule | None = None) -> BlockHeader:
    """``make_genesis(difficulty, retarget).header`` of the JAX package,
    byte for byte."""
    if retarget is None:
        merkle = EMPTY_MERKLE_ROOT
    else:
        merkle = sha256d(
            _RETARGET_TAG
            + struct.pack(
                ">IIII",
                retarget.window,
                retarget.spacing,
                retarget.max_adjust,
                retarget.max_step,
            )
        )
    return BlockHeader(
        version=GENESIS_VERSION,
        prev_hash=bytes(32),
        merkle_root=merkle,
        timestamp=GENESIS_TIMESTAMP,
        difficulty=difficulty,
        nonce=0,
    )


@functools.lru_cache(maxsize=256)
def make_genesis(difficulty: int, retarget: RetargetRule | None = None) -> Block:
    """The genesis block: ``genesis_header`` and no transactions."""
    return Block(genesis_header(difficulty, retarget), ())


def genesis_hash(difficulty: int, retarget: RetargetRule | None = None) -> bytes:
    """The chain id: the genesis header's hash for a chain configuration."""
    return genesis_header(difficulty, retarget).block_hash()
