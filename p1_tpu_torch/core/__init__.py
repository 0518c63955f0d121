from p1_tpu_torch.core.header import (
    HEADER_SIZE,
    NONCE_OFFSET,
    BlockHeader,
    meets_target,
    target_from_difficulty,
    target_to_words,
)
from p1_tpu_torch.core.tx import Transaction
from p1_tpu_torch.core.block import (
    Block,
    merkle_branch,
    merkle_root,
    verify_merkle_branch,
)
from p1_tpu_torch.core.genesis import (
    GENESIS_TIMESTAMP,
    genesis_hash,
    genesis_header,
    make_genesis,
)
from p1_tpu_torch.core.retarget import RetargetRule

__all__ = [
    "HEADER_SIZE",
    "NONCE_OFFSET",
    "BlockHeader",
    "target_from_difficulty",
    "target_to_words",
    "meets_target",
    "Transaction",
    "Block",
    "merkle_branch",
    "merkle_root",
    "verify_merkle_branch",
    "GENESIS_TIMESTAMP",
    "genesis_header",
    "genesis_hash",
    "make_genesis",
    "RetargetRule",
]
