"""Set-reconciliation codec for bandwidth-scale tx relay (Erlay analog).

Flooding announces every transaction on every link — O(links) bytes
for the mesh.  Erlay (Naumenko et al., the Bitcoin lineage this
codebase already credits for compact blocks/BIP157) cuts that to
O(nodes): each peer pair periodically exchanges a fixed-size *sketch*
of the short IDs it would have flooded, and the symmetric difference
decodes from the XOR of the two sketches — bytes proportional to the
DIFFERENCE, not to the sets.

The sketch is minisketch-style (PinSketch over GF(2^32)): for a set
``S`` of nonzero 32-bit elements and capacity ``c``, the sketch is the
odd power sums ``s_k = sum(m^k for m in S)`` for ``k = 1, 3, ...,
2c-1`` — ``4c`` bytes regardless of ``|S|``.  Addition in GF(2^m) is
XOR, so the sketch of a symmetric difference is the XOR of the
sketches, and any difference of up to ``c`` elements decodes exactly:

- even syndromes come free from Frobenius (``s_{2k} = s_k^2``), so the
  syndromes Berlekamp–Massey needs cost only the odd wire words;
- BM yields the connection polynomial whose reversal has the
  difference elements as roots;
- roots are recovered WITHOUT a Chien sweep (2^32 candidates is not a
  pure-Python option): the polynomial must split into distinct linear
  factors over the field (checked via ``x^(2^32) == x`` mod the
  polynomial), then Berlekamp's trace construction splits it
  recursively along the 32 trace coordinates;
- over-capacity failure is DETECTED, not mis-decoded: raw PinSketch
  will happily hallucinate a small set whose first syndromes match an
  over-full sketch (the derived even syndromes verify nothing — they
  are Frobenius images for ANY set), so every sketch carries one extra
  RESERVED syndrome beyond its claimed capacity.  A genuine ≤capacity
  difference satisfies it automatically; a spurious solution must also
  match an independent 32-bit word it was never fitted to, so a
  difference beyond capacity returns None except with probability
  2^-32 per round — the same odds Erlay accepts for a short-ID
  collision.  The recovered set is additionally re-sketched and must
  reproduce the input byte-for-byte.  Callers fall back to flood on
  None.

Short IDs are salted per peer pair (both HELLO instance nonces, order-
independent), so an adversary cannot precompute colliding txids for
links it is not on; a collision on one link costs one tx one round on
that link only.

Everything here is a pure function of bytes — no clock, no RNG, no IO
— and carries ZERO analysis-allowlist grants (the chain/snapshot.py
discipline).  Pure Python first, by design: sets are per-link pending
windows (tens of elements) and capacity is clamped at
``MAX_CAPACITY``, so the field work is thousands of 32-bit carryless
multiplies per round.  If profiling ever says this is hot, the seam
for a native build is this module's public surface (``sketch`` /
``combine`` / ``decode`` are byte-in/byte-out, the same boundary
minisketch's C library exposes) — do not inline field ops
elsewhere.

The port's copy of ``p1_tpu/node/reconcile.py``: byte-identical sketches
for the same sets.
"""

from __future__ import annotations

import hashlib

__all__ = [
    "MAX_CAPACITY",
    "pair_salt",
    "short_id",
    "sketch",
    "combine",
    "decode",
    "estimate_capacity",
]

#: Hard ceiling on sketch capacity: bounds both the wire frame (4c
#: bytes) and the decode work an adversarial SKETCH can demand.
MAX_CAPACITY = 64

#: GF(2^32) reduction polynomial x^32 + x^7 + x^3 + x^2 + 1 (the same
#: modulus minisketch uses for 32-bit fields).
_MOD = (1 << 32) | 0x8D
_MASK = (1 << 32) - 1
_ORDER = (1 << 32) - 1  # multiplicative group order


def _gmul(a: int, b: int) -> int:
    """Carryless multiply in GF(2^32), reduced."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> 32:
            a ^= _MOD
    return r


def _gsqr(a: int) -> int:
    return _gmul(a, a)


def _gpow(a: int, e: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = _gmul(r, a)
        a = _gmul(a, a)
        e >>= 1
    return r


def _ginv(a: int) -> int:
    assert a, "zero has no inverse"
    return _gpow(a, _ORDER - 1)


# -- salted short IDs ------------------------------------------------------


def pair_salt(nonce_a: int, nonce_b: int) -> bytes:
    """The per-link salt: order-independent over the two HELLO instance
    nonces, so both endpoints derive the same value and no third party
    shares it with any other link."""
    lo, hi = sorted((nonce_a, nonce_b))
    return hashlib.sha256(
        b"p1-recon-salt" + lo.to_bytes(8, "big") + hi.to_bytes(8, "big")
    ).digest()[:16]


def short_id(salt: bytes, txid: bytes) -> int:
    """32-bit salted short ID for a txid, never zero (zero is the
    sketch's additive identity and cannot be an element)."""
    sid = int.from_bytes(hashlib.sha256(salt + txid).digest()[:4], "big")
    return sid if sid else 0x811C9DC5


# -- sketch construction ---------------------------------------------------


def sketch(ids, capacity: int) -> bytes:
    """Serialize the odd power-sum syndromes of ``ids`` at ``capacity``.

    ``4 * (capacity + 1)`` bytes, independent of ``len(ids)`` — the +1
    is the reserved verification syndrome (module docstring).  Byte-
    identical for identical sets (order-free: XOR accumulation
    commutes).
    """
    if not 1 <= capacity <= MAX_CAPACITY:
        raise ValueError(f"capacity {capacity} outside 1..{MAX_CAPACITY}")
    syn = [0] * (capacity + 1)
    for m in ids:
        if not 0 < m <= _MASK:
            raise ValueError(f"element {m} outside GF(2^32)*")
        p = m
        m2 = _gmul(m, m)
        for i in range(capacity + 1):
            syn[i] ^= p
            p = _gmul(p, m2)
    return b"".join(s.to_bytes(4, "big") for s in syn)


def combine(a: bytes, b: bytes) -> bytes:
    """XOR two equal-capacity sketches: the sketch of the symmetric
    difference of the underlying sets."""
    if len(a) != len(b) or len(a) % 4:
        raise ValueError("sketch length mismatch")
    return bytes(x ^ y for x, y in zip(a, b))


def estimate_capacity(local_size: int, remote_size: int) -> int:
    """Capacity guess for a round over two PENDING QUEUES, clamped to
    the frame bound.

    Erlay's estimator is ``|ls - rs| + q*min + c`` because it
    reconciles whole announcement sets that mostly OVERLAP.  This
    protocol reconciles per-link pending queues, and two ends' queues
    are mostly DISJOINT — each side queued precisely what it believes
    the other lacks — so the expected difference is ``ls + rs``, and
    the subtraction heuristic under-sizes the sketch catastrophically
    (measured: a mesh-wide storm failed ~20% of rounds before this was
    a sum).  Overlap only ever makes the true difference SMALLER than
    the estimate, which decoding handles for free; underestimates fail
    detectably and fall back to flood."""
    d = local_size + remote_size + 2
    return max(1, min(d, MAX_CAPACITY))


def capacity_of(data: bytes) -> int:
    """The claimed capacity of a serialized sketch (word count minus
    the reserved verification syndrome)."""
    return len(data) // 4 - 1


# -- decoding --------------------------------------------------------------
#
# Polynomials over GF(2^32) are lists of coefficients, index = degree.


def _ptrim(p: list) -> list:
    while p and p[-1] == 0:
        p.pop()
    return p


def _pmod(a: list, b: list) -> list:
    """a mod b, b monic-normalized inside."""
    a = a[:]
    inv = _ginv(b[-1])
    while len(a) >= len(b):
        c = _gmul(a[-1], inv)
        if c:
            off = len(a) - len(b)
            for i, bv in enumerate(b):
                a[off + i] ^= _gmul(c, bv)
        a.pop()
    return _ptrim(a)


def _pdiv(a: list, b: list) -> list:
    """a // b (exact or not; remainder discarded)."""
    a = a[:]
    q = [0] * max(1, len(a) - len(b) + 1)
    inv = _ginv(b[-1])
    while len(a) >= len(b):
        c = _gmul(a[-1], inv)
        off = len(a) - len(b)
        q[off] = c
        if c:
            for i, bv in enumerate(b):
                a[off + i] ^= _gmul(c, bv)
        a.pop()
    return _ptrim(q)


def _pgcd(a: list, b: list) -> list:
    while b:
        a, b = b, _pmod(a, b)
    return a


def _psqr_mod(p: list, m: list) -> list:
    """p^2 mod m via Frobenius: squaring is coefficient-wise square
    spread to even degrees (char 2)."""
    sq = [0] * (2 * len(p) - 1) if p else []
    for i, c in enumerate(p):
        if c:
            sq[2 * i] = _gsqr(c)
    return _pmod(sq, m)


def _monic(p: list) -> list:
    inv = _ginv(p[-1])
    return [_gmul(c, inv) for c in p]


def _berlekamp_massey(s: list) -> list:
    """Connection polynomial C (C[0] == 1) of the syndrome sequence."""
    C, B = [1], [1]
    L, m, b = 0, 1, 1
    for n, sn in enumerate(s):
        d = sn
        for i in range(1, L + 1):
            if i < len(C) and C[i]:
                d ^= _gmul(C[i], s[n - i])
        if d == 0:
            m += 1
            continue
        coef = _gmul(d, _ginv(b))
        if 2 * L <= n:
            T = C[:]
            if len(C) < len(B) + m:
                C = C + [0] * (len(B) + m - len(C))
            for i, bv in enumerate(B):
                if bv:
                    C[i + m] ^= _gmul(coef, bv)
            L, B, b, m = n + 1 - L, T, d, 1
        else:
            if len(C) < len(B) + m:
                C = C + [0] * (len(B) + m - len(C))
            for i, bv in enumerate(B):
                if bv:
                    C[i + m] ^= _gmul(coef, bv)
            m += 1
    return _ptrim(C)


def _roots(p: list) -> list | None:
    """All roots of monic ``p``, or None unless ``p`` is a product of
    DISTINCT linear factors over GF(2^32) (anything else means the
    sketch was over capacity or garbage).  Berlekamp trace splitting:
    ``Tr(beta*x)`` takes values 0/1 on the field, so its gcd with ``p``
    separates the roots along each of the 32 trace coordinates; distinct
    roots differ in at least one coordinate, so recursion terminates.

    The basis cursor is PER FACTOR, resumed from the split that made
    it, not shared across the stack: a beta that fails to split ``q``
    has constant trace on ``q``'s roots, hence on every DESCENDANT of
    ``q`` — but says nothing about ``q``'s siblings, whose roots it may
    be the only coordinate separating.  (A shared monotonic cursor
    looked equivalent and decoded every small sketch; it starts losing
    real ≥20-element differences once the recursion tree is deep
    enough for a sibling to need an already-consumed coordinate.)
    """
    # Distinct-linear check: x^(2^32) == x mod p.
    t = [0, 1] if len(p) > 2 else _pmod([0, 1], p)
    frob = t[:]
    for _ in range(32):
        frob = _psqr_mod(frob, p)
    if _ptrim([a ^ b for a, b in zip(frob + [0] * len(t), t + [0] * len(frob))]):
        return None
    out: list = []
    stack = [(p, 0)]
    while stack:
        q, basis = stack.pop()
        if len(q) == 2:  # monic x + a -> root a
            out.append(q[0])
            continue
        split = None
        while split is None:
            if basis >= 32:
                return None  # cannot happen for distinct roots
            beta = 1 << basis
            basis += 1
            term = _pmod([0, beta], q)
            acc = term[:]
            for _ in range(31):
                term = _psqr_mod(term, q)
                acc = _ptrim(
                    [
                        a ^ b
                        for a, b in zip(
                            acc + [0] * len(term), term + [0] * len(acc)
                        )
                    ]
                )
            g = _pgcd(q[:], acc)
            if g and 1 < len(g) < len(q):
                split = (_monic(g), _monic(_pdiv(q, g)))
        stack.append((split[0], basis))
        stack.append((split[1], basis))
    return out


def decode(data: bytes) -> tuple | None:
    """Decode a (combined) sketch into its element set.

    Returns a sorted tuple of the symmetric-difference elements, or
    None when the difference exceeded the sketch's capacity or the
    bytes are not a valid sketch — the caller's signal to fall back to
    flood.  Success is PROVEN, not assumed: the connection polynomial
    must also generate the reserved syndrome it was never fitted to,
    and the recovered set is re-sketched and must reproduce the input
    byte-for-byte.
    """
    if len(data) < 8 or len(data) % 4 or len(data) > 4 * (MAX_CAPACITY + 1):
        return None
    words = len(data) // 4
    cap = words - 1  # last odd syndrome is the verification reserve
    odd = [int.from_bytes(data[i : i + 4], "big") for i in range(0, len(data), 4)]
    if not any(odd):
        return ()
    # Full syndrome run s_1..s_{2*words}: odd given, even from Frobenius.
    syn = [0] * (2 * words + 1)
    for k in range(words):
        syn[2 * k + 1] = odd[k]
    for k in range(1, words + 1):
        syn[2 * k] = _gsqr(syn[k])
    C = _berlekamp_massey(syn[1:])
    deg = len(C) - 1
    if deg < 1 or deg > cap or C[-1] == 0 or C[0] != 1:
        return None
    # Roots of the reversal x^deg * C(1/x) are the elements themselves.
    rev = _monic(C[::-1])
    roots = _roots(rev)
    if roots is None or len(roots) != deg or 0 in roots:
        return None
    elems = tuple(sorted(roots))
    if len(set(elems)) != deg:
        return None
    # The proof: re-sketching must reproduce the input exactly.
    if sketch(elems, cap) != data:
        return None
    return elems
