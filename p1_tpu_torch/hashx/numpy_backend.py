"""NumPy hash backend: batch-vectorized SHA-256d over the nonce lane.

The port's copy of ``p1_tpu/hashx/numpy_backend.py``: the host-side
*vectorized oracle*.  It shares the midstate formulation with the card's
search kernel (one uint32 lane per candidate nonce, chunk-2 + second-pass
compression only), so kernel tests can diff the two lane by lane.  It is
an oracle, not a fast miner: NumPy's per-op dispatch makes it slower than
the hashlib loop — use ``cpu`` or ``native`` for host hash rate.

Every SHA-256 word is a vector of ``count`` uint32 lanes; rotations are
shift/or pairs; the 64 rounds are an unrolled Python loop over vector ops
(no per-nonce Python).  It runs on the host only: ``device`` exists so
callers that pass one get a clear refusal instead of a silent host run.
"""

from __future__ import annotations

import numpy as np

from p1_tpu_torch.core.header import target_from_difficulty, target_to_words
from p1_tpu_torch.hashx.backend import HashBackend, SearchResult, register
from p1_tpu_torch.hashx.sha256_ref import IV, K, header_midstate, header_tail_words, sha256d

_K = np.array(K, dtype=np.uint32)
_IV = np.array(IV, dtype=np.uint32)


def _rotr(x: np.ndarray, n: int) -> np.ndarray:
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _schedule_extend(w: list[np.ndarray]) -> list[np.ndarray]:
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> np.uint32(3))
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> np.uint32(10))
        w.append(w[i - 16] + s0 + w[i - 7] + s1)
    return w


def _compress(state: list[np.ndarray], w: list[np.ndarray]) -> list[np.ndarray]:
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + _K[i] + w[i]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = s0 + maj
        a, b, c, d, e, f, g, h = t1 + t2, a, b, c, d + t1, e, f, g
    return [x + y for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def sha256d_lanes(midstate: np.ndarray, tail: np.ndarray, nonces: np.ndarray) -> list[np.ndarray]:
    """SHA-256d digests (8 uint32 word-vectors) for a vector of nonces.

    ``midstate``: (8,) uint32 — chunk-1 state of the 80-byte header.
    ``tail``: (3,) uint32 — chunk-2 words 0..2 (header bytes 64..76).
    ``nonces``: (n,) uint32 — chunk-2 word 3 per lane.
    """
    n = nonces.shape[0]
    zeros = np.zeros(n, dtype=np.uint32)

    def bc(v: np.uint32) -> np.ndarray:
        return np.full(n, v, dtype=np.uint32)

    # Chunk 2 of pass 1: 16 header-tail bytes, 0x80 pad, bit length 640.
    w = [bc(tail[0]), bc(tail[1]), bc(tail[2]), nonces.astype(np.uint32)]
    w += [bc(np.uint32(0x80000000))] + [zeros] * 10 + [bc(np.uint32(640))]
    state1 = _compress([bc(v) for v in midstate], _schedule_extend(w))

    # Pass 2: the 32-byte digest as its own single padded block (length 256).
    w2 = list(state1) + [bc(np.uint32(0x80000000))] + [zeros] * 6 + [bc(np.uint32(256))]
    return _compress([bc(v) for v in _IV], _schedule_extend(w2))


def lanes_below_target(digest_words: list[np.ndarray], difficulty: int) -> np.ndarray:
    """Boolean mask of lanes whose big-endian digest is < the target."""
    t_words = target_to_words(target_from_difficulty(difficulty))
    n = digest_words[0].shape[0]
    lt = np.zeros(n, dtype=bool)
    eq = np.ones(n, dtype=bool)
    for dw, tw in zip(digest_words, t_words):
        tw = np.uint32(tw)
        lt |= eq & (dw < tw)
        eq &= dw == tw
    return lt


@register("numpy")
class NumpyBackend(HashBackend):
    """Vectorized host backend; also a lane-by-lane oracle for the kernels."""

    def __init__(self, batch: int = 1 << 16, device: str = "cpu"):
        if device != "cpu":
            raise ValueError(f"the numpy backend runs on the host only, not on {device!r}")
        self.batch = batch

    def sha256d(self, data: bytes) -> bytes:
        return sha256d(data)  # single digests don't benefit from lanes

    def search(self, header_prefix: bytes, nonce_start: int, count: int, difficulty: int) -> SearchResult:
        self._check_search_args(header_prefix, nonce_start, count, difficulty)
        midstate = np.array(header_midstate(header_prefix), dtype=np.uint32)
        tail = np.array(header_tail_words(header_prefix), dtype=np.uint32)
        done = 0
        while done < count:
            n = min(self.batch, count - done)
            nonces = (nonce_start + done + np.arange(n, dtype=np.uint64)).astype(np.uint32)
            hits = lanes_below_target(sha256d_lanes(midstate, tail, nonces), difficulty)
            idx = np.flatnonzero(hits)
            if idx.size:
                return SearchResult(int(nonces[idx[0]]), done + int(idx[0]) + 1)
            done += n
        return SearchResult(None, count)
