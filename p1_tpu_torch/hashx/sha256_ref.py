"""Pure-Python SHA-256: the port's ground-truth implementation.

The port's copy of ``p1_tpu/hashx/sha256_ref.py``.  Three jobs:

1. ``sha256``/``sha256d`` — convenience digests (cross-checked against
   ``hashlib`` in tests).
2. ``compress`` — the raw compression function, exposed so the miner can
   compute the **midstate**: with an 80-byte header only the second 64-byte
   chunk depends on the nonce, so the first chunk is compressed once on the
   host and the resulting 8-word state shipped to the device
   (the classic miner optimization; see ``torch_backend.search_arrays``).
3. The round constants / IV shared by every backend and the CUDA kernel.

Implements FIPS 180-4.  All word arithmetic is mod 2**32.
"""

from __future__ import annotations

import struct

MASK32 = 0xFFFFFFFF

# fmt: off
K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
# fmt: on

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)  # fmt: skip


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & MASK32


def compress(state: tuple[int, ...], chunk: bytes) -> tuple[int, ...]:
    """One SHA-256 compression: 64-byte chunk folded into an 8-word state."""
    if len(chunk) != 64:
        raise ValueError("chunk must be 64 bytes")
    w = list(struct.unpack(">16I", chunk))
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & MASK32)

    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + s1 + ch + K[i] + w[i]) & MASK32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & MASK32
        a, b, c, d, e, f, g, h = (t1 + t2) & MASK32, a, b, c, (d + t1) & MASK32, e, f, g
    return tuple((x + y) & MASK32 for x, y in zip(state, (a, b, c, d, e, f, g, h)))


def padding(message_len: int) -> bytes:
    """FIPS 180-4 padding for a message of ``message_len`` bytes."""
    pad = b"\x80" + b"\x00" * ((55 - message_len) % 64)
    return pad + struct.pack(">Q", message_len * 8)


def sha256(data: bytes) -> bytes:
    padded = data + padding(len(data))
    state = IV
    for off in range(0, len(padded), 64):
        state = compress(state, padded[off : off + 64])
    return struct.pack(">8I", *state)


def sha256d(data: bytes) -> bytes:
    return sha256(sha256(data))


def header_midstate(header_prefix: bytes) -> tuple[int, ...]:
    """Compress the nonce-independent first chunk of an 80-byte header.

    ``header_prefix`` is the first 76 bytes (everything but the nonce); only
    its first 64 bytes enter the midstate.  Returns the 8-word state from
    which the device continues with chunk 2 (bytes 64..80 + padding).
    """
    if len(header_prefix) < 64:
        raise ValueError("header prefix must be at least 64 bytes")
    return compress(IV, header_prefix[:64])


def header_tail_words(header_prefix: bytes) -> tuple[int, int, int]:
    """Words 0..2 of the second chunk (bytes 64..76); word 3 is the nonce."""
    if len(header_prefix) != 76:
        raise ValueError("header prefix must be exactly 76 bytes")
    return struct.unpack(">3I", header_prefix[64:76])
