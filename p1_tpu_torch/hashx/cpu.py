"""CPU hash backend: ``hashlib`` SHA-256d, the port's host oracle.

The port's copy of ``p1_tpu/hashx/cpu.py``.  The search loop reuses a
pre-absorbed ``hashlib`` context for the 76-byte prefix (``copy()`` per
nonce), the fastest pure-stdlib formulation.  It runs on the host only:
``device`` exists so callers that pass one get a clear refusal instead of
a silent host run.
"""

from __future__ import annotations

import hashlib
import struct

from p1_tpu_torch.core.header import target_from_difficulty
from p1_tpu_torch.hashx.backend import HashBackend, SearchResult, register


@register("cpu")
class CpuBackend(HashBackend):
    def __init__(self, device: str = "cpu"):
        if device != "cpu":
            raise ValueError(
                f"the hashlib backend runs on the host only, not on {device!r}"
            )

    def sha256d(self, data: bytes) -> bytes:
        return hashlib.sha256(hashlib.sha256(data).digest()).digest()

    def search(
        self, header_prefix: bytes, nonce_start: int, count: int, difficulty: int
    ) -> SearchResult:
        self._check_search_args(header_prefix, nonce_start, count, difficulty)
        target = target_from_difficulty(difficulty)
        base = hashlib.sha256(header_prefix)
        pack = struct.Struct(">I").pack
        outer = hashlib.sha256
        for nonce in range(nonce_start, nonce_start + count):
            h = base.copy()
            h.update(pack(nonce))
            digest = outer(h.digest()).digest()
            if int.from_bytes(digest, "big") < target:
                return SearchResult(nonce, nonce - nonce_start + 1)
        return SearchResult(None, count)
