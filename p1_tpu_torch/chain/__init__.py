from p1_tpu_torch.chain.replay import (
    ReplayReport,
    generate_headers,
    headers_to_words,
    pack_headers,
    pad_to_segments,
    parse_headers,
    replay_device,
    replay_host,
)
from p1_tpu_torch.chain.validate import (
    PREVERIFY_WINDOW,
    ValidationError,
    check_block,
    preverify_signatures,
)

__all__ = [
    "PREVERIFY_WINDOW",
    "ValidationError",
    "check_block",
    "preverify_signatures",
    "ReplayReport",
    "generate_headers",
    "headers_to_words",
    "pack_headers",
    "pad_to_segments",
    "parse_headers",
    "replay_device",
    "replay_host",
]
