"""SHA-256d nonce search as plain PyTorch integer math.

The port of the search half of ``p1_tpu/hashx/jax_sha256.py`` and the
plain version of the CUDA kernel in ``csrc/sha256d_search.cu``: the CPU
tests run it, the ``cuda`` backend takes it for tensors that lie on the
CPU, and ``chip_smoke.py`` holds the kernel against it on the card.

PyTorch's ``uint32`` has no ``>>``, ``<<``, ``+``, ``~``, ``<`` or ``min``,
so every 32-bit word rides in an ``int64`` lane holding a value in
``[0, 2**32)``: sums are masked back with ``MASK32``, ``~x`` is
``x ^ MASK32``, and a left shift of at most 31 bits cannot overflow the
lane.  Because every word is non-negative, the signed ``int64`` compare in
``below_target`` IS the unsigned compare of the reference.

Same layout as the reference: one lane per candidate nonce, the host
compresses the nonce-independent first chunk once (the midstate), and the
device runs chunk 2 plus the second pass.  Constant words stay Python ints
and broadcast, so a zero word costs no lane array.
"""

from __future__ import annotations

import torch

from p1_tpu_torch.hashx.sha256_ref import IV, K

MASK32 = 0xFFFFFFFF


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & MASK32


def _compress(state, w16):
    """One SHA-256 compression over a 16-word chunk, rounds+extension fused.

    As ``jax_sha256._compress``: the window holds ``w[i..i+15]``; round
    ``i`` consumes ``w[i]`` and appends
    ``w[i+16] = w[i] + σ0(w[i+1]) + w[i+9] + σ1(w[i+14])``.  The reference
    also computes the 16 extension words of rounds 48..63 that feed
    nothing; this version skips them, which changes no output.
    """
    w = list(w16)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ MASK32) & g)
        t1 = (h + s1 + ch + K[i] + w[0]) & MASK32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        if i < 48:
            sig0 = _rotr(w[1], 7) ^ _rotr(w[1], 18) ^ (w[1] >> 3)
            sig1 = _rotr(w[14], 17) ^ _rotr(w[14], 19) ^ (w[14] >> 10)
            w.append((w[0] + sig0 + w[9] + sig1) & MASK32)
        w.pop(0)
        a, b, c, d, e, f, g, h = (t1 + s0 + maj) & MASK32, a, b, c, (d + t1) & MASK32, e, f, g
    return tuple((x + y) & MASK32 for x, y in zip(state, (a, b, c, d, e, f, g, h)))


def sha256d_words(
    midstate: torch.Tensor, tail: torch.Tensor, nonces: torch.Tensor
) -> list[torch.Tensor]:
    """SHA-256d digest words for a lane-vector of nonces.

    midstate: (8,) int64 chunk-1 state; tail: (3,) int64 chunk-2 words 0..2;
    nonces: (n,) int64 in [0, 2**32).  Returns 8 (n,) int64 word lanes.
    """
    # Pass 1, chunk 2: 16 tail bytes + nonce word + pad(0x80) + bitlen 640.
    w = (tail[0], tail[1], tail[2], nonces, 0x80000000) + (0,) * 10 + (640,)
    state1 = _compress(tuple(midstate[k] for k in range(8)), w)
    # Pass 2: the 32-byte digest as one padded block (bitlen 256).
    w2 = state1 + (0x80000000,) + (0,) * 6 + (256,)
    return list(_compress(IV, w2))


def below_target(
    digest_words: list[torch.Tensor], target_words: torch.Tensor
) -> torch.Tensor:
    """Lanes whose 256-bit big-endian digest is < the 8-word target.

    Word-wise big-endian compare, unsigned: both sides hold values in
    ``[0, 2**32)``, so the int64 compare orders them as uint32 would.
    """
    lt = torch.zeros(digest_words[0].shape, dtype=torch.bool, device=digest_words[0].device)
    eq = torch.ones_like(lt)
    for i in range(8):
        tw = target_words[i]
        lt = lt | (eq & (digest_words[i] < tw))
        eq = eq & (digest_words[i] == tw)
    return lt


def first_hit_index(hits: torch.Tensor, batch: int) -> torch.Tensor:
    """min(flat lane index where hit) or ``batch`` if no lane hit (int64)."""
    lanes = torch.arange(batch, dtype=torch.int64, device=hits.device)
    return torch.where(hits.reshape(-1), lanes, batch).min()


def search_step(
    midstate: torch.Tensor,
    tail: torch.Tensor,
    target_words: torch.Tensor,
    nonce_base: int,
    batch: int,
) -> torch.Tensor:
    """One step: scan [nonce_base, nonce_base+batch) lanes (uint32 wrap),
    return the first hit's offset from nonce_base, or ``batch`` if none."""
    lanes = torch.arange(batch, dtype=torch.int64, device=midstate.device)
    nonces = (lanes + nonce_base) & MASK32
    hits = below_target(sha256d_words(midstate, tail, nonces), target_words)
    return first_hit_index(hits, batch)
