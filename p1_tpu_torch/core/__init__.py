from p1_tpu_torch.core.genesis import GENESIS_TIMESTAMP, genesis_header
from p1_tpu_torch.core.header import (
    HEADER_SIZE,
    NONCE_OFFSET,
    BlockHeader,
    meets_target,
    target_from_difficulty,
    target_to_words,
)

__all__ = [
    "HEADER_SIZE",
    "NONCE_OFFSET",
    "BlockHeader",
    "target_from_difficulty",
    "target_to_words",
    "meets_target",
    "GENESIS_TIMESTAMP",
    "genesis_header",
]
