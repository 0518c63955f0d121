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

__all__ = [
    "ReplayReport",
    "generate_headers",
    "headers_to_words",
    "pack_headers",
    "pad_to_segments",
    "parse_headers",
    "replay_device",
    "replay_host",
]
