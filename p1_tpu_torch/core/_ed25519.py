"""Pure-Python RFC 8032 Ed25519: the big-integer oracle and the host rung.

The port's copy of ``p1_tpu/core/_ed25519.py``, as it is but for the
recorded host timings, which are the port's own (``RECORDED_*`` below).  A direct transcription
of RFC 8032 §5.1 (edwards25519, SHA-512, cofactored equation checked in
the cofactorless form ``[S]B = R + [k]A`` that both OpenSSL and the RFC
test vectors accept), producing byte-identical keys and signatures to
any other RFC 8032 implementation — Ed25519 signing is fully
deterministic.  It is the ``pure-python`` rung of ``core/keys.py``, the
serial settlement under the ``device`` rung, and the oracle that the
device path (``hashx/ed25519_msm.py``) and its tests are held against.

Cost model: every sign or verify is a double-and-add ladder over Python
integers.  Two things keep that affordable on the hot paths: the
tx-level verify-once cache (core/sigcache.py) pays the cost once per
transaction per process, and ``verify_batch`` below amortizes what DOES
have to be verified — whole windows of signatures in one multi-scalar
multiplication instead of one ladder each (benchmarks/sig_verify.py).

Batch semantics, stated precisely: the batch accepts iff (a) every
``R_i`` and ``A_i`` point lies in the prime-order subgroup — checked
EXACTLY via ``[q]·point == identity`` (``_in_prime_subgroup``), cached
per pubkey, per signature for the unique ``R_i`` — and (b) the random
linear combination ``Σ z_i·([s_i]B − R_i − [k_i]A_i)`` with 128-bit
per-batch-random coefficients ``z_i`` is the identity.  With every
point torsion-free, each term of (b) is exactly the serial
(cofactorless) equation ``[S]B = R + [k]A``, so **batch acceptance
implies serial acceptance** of every triple up to the 2⁻¹²⁸ soundness
bound of the coefficients.  The converse does NOT hold: a signer who
plants a small-order torsion component in their own public key or
nonce point can build a signature the serial equation tolerates (the
torsion terms cancel) which the subgroup gate here rejects — callers
recover the exact serial verdict through ``keys.first_invalid``'s
serial confirmation, so the OUTCOME of every validation path is
byte-identical to serial verification for every input, honest or
crafted (property-tested, tests/test_sigbatch.py and
tests/test_torch_sigbatch.py).

The subgroup gate is what keeps ONE validity rule on every node: the
cofactored-only batch (the "Taming the many EdDSAs" superset this
module previously shipped) accepts torsion-crafted signatures the
serial path — and every node running the ``cryptography`` wheel —
rejects, which a hostile signer could use to split wheel-less nodes
from wheel nodes deterministically.  The gate costs one scalar
multiplication by q per signature (the dominant per-signature batch
cost; windowed, ``_in_prime_subgroup``).
Honest signatures are torsion-free by construction, so the gate never
rejects honest input.
"""

from __future__ import annotations

import functools
import hashlib
import secrets

#: Pure-Python verify costs, ms per signature: serial (best of 3 over 16),
#: and in one 1,024 ``verify_batch`` (``python -m
#: p1_tpu_torch.benchmarks.sig_verify --fallback``), measured on the
#: card's host (NVIDIA H100 80GB HBM3, 700.00 W) — what keys.py's one-time
#: forced-fallback warning names, so numbers taken on this rung are never
#: read as regressions.
RECORDED_SERIAL_MS = 3.81
RECORDED_BATCH_MS = 2.05

_P = 2**255 - 19  # field prime
_Q = 2**252 + 27742317777372353535851937790883648493  # group order
_D = (-121665 * pow(121666, _P - 2, _P)) % _P  # curve constant

# Base point B (RFC 8032 §5.1), extended homogeneous (X, Y, Z, T).
_BY = (4 * pow(5, _P - 2, _P)) % _P
_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
_B = (_BX, _BY, 1, (_BX * _BY) % _P)
_IDENT = (0, 1, 1, 0)

# sqrt(-1) mod p, for point decompression (p ≡ 5 mod 8).
_SQRT_M1 = pow(2, (_P - 1) // 4, _P)


def _sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


def _pt_add(a, b):
    x1, y1, z1, t1 = a
    x2, y2, z2, t2 = b
    aa = (y1 - x1) * (y2 - x2) % _P
    bb = (y1 + x1) * (y2 + x2) % _P
    cc = 2 * t1 * t2 * _D % _P
    dd = 2 * z1 * z2 % _P
    e, f, g, h = bb - aa, dd - cc, dd + cc, bb + aa
    return (e * f % _P, g * h % _P, f * g % _P, e * h % _P)


def _pt_double(a):
    x1, y1, z1, _ = a
    aa = x1 * x1 % _P
    bb = y1 * y1 % _P
    cc = 2 * z1 * z1 % _P
    h = aa + bb
    e = (h - (x1 + y1) * (x1 + y1)) % _P
    g = aa - bb
    f = cc + g
    return (e * f % _P, g * h % _P, f * g % _P, e * h % _P)


def _pt_mul(s: int, pt):
    out = _IDENT
    while s > 0:
        if s & 1:
            out = _pt_add(out, pt)
        pt = _pt_double(pt)
        s >>= 1
    return out


def _pt_equal(a, b) -> bool:
    # Cross-multiply to compare projective points without inversions.
    x1, y1, z1, _ = a
    x2, y2, z2, _ = b
    return (x1 * z2 - x2 * z1) % _P == 0 and (y1 * z2 - y2 * z1) % _P == 0


def _pt_compress(pt) -> bytes:
    x, y, z, _ = pt
    zinv = pow(z, _P - 2, _P)
    x, y = x * zinv % _P, y * zinv % _P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _recover_x(y: int, sign: int) -> int | None:
    if y >= _P:
        return None
    # RFC 8032 §5.1.3's combined inversion+square-root: x² = u/v with
    # u = y²−1, v = d·y²+1, and x = u·v³·(u·v⁷)^((p−5)/8) — ONE modular
    # exponentiation where the naive u·v⁻¹ then sqrt pays two.  Point
    # decompression is the per-signature fixed cost of batch
    # verification (R is unique per signature), so this halves its floor.
    y2 = y * y % _P
    u = (y2 - 1) % _P
    v = (_D * y2 + 1) % _P
    if u == 0:
        return None if sign else 0
    v3 = v * v % _P * v % _P
    x = u * v3 % _P * pow(u * v3 % _P * v3 % _P * v % _P, (_P - 5) // 8, _P) % _P
    vx2 = v * x % _P * x % _P
    if vx2 != u:
        if vx2 != _P - u:
            return None
        x = x * _SQRT_M1 % _P
    if x == 0 and sign:
        return None
    if (x & 1) != sign:
        x = _P - x
    return x


def _pt_decompress(raw: bytes):
    if len(raw) != 32:
        return None
    y = int.from_bytes(raw, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % _P)


def _secret_expand(seed: bytes) -> tuple[int, bytes]:
    h = _sha512(seed)
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key(seed: bytes) -> bytes:
    """The 32-byte public key for a 32-byte private seed."""
    a, _ = _secret_expand(seed)
    return _pt_compress(_pt_mul(a, _B))


def sign(seed: bytes, message: bytes) -> bytes:
    """Deterministic RFC 8032 signature (64 bytes) over ``message``."""
    a, prefix = _secret_expand(seed)
    pub = _pt_compress(_pt_mul(a, _B))
    r = int.from_bytes(_sha512(prefix + message), "little") % _Q
    big_r = _pt_compress(_pt_mul(r, _B))
    k = int.from_bytes(_sha512(big_r + pub + message), "little") % _Q
    s = (r + k * a) % _Q
    return big_r + s.to_bytes(32, "little")


def verify(pubkey: bytes, sig: bytes, message: bytes) -> bool:
    """True iff ``sig`` is ``pubkey``'s valid signature over ``message``."""
    if len(pubkey) != 32 or len(sig) != 64:
        return False
    a_pt = _pt_decompress(pubkey)
    if a_pt is None:
        return False
    r_pt = _pt_decompress(sig[:32])
    if r_pt is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= _Q:
        return False
    k = int.from_bytes(_sha512(sig[:32] + pubkey + message), "little") % _Q
    return _pt_equal(_pt_mul(s, _B), _pt_add(r_pt, _pt_mul(k, a_pt)))


# -- batch verification (untrusted-path fast lane) -----------------------
#
# One multi-scalar multiplication over all (R_i, A_i, B) replaces 2n
# double-and-add ladders: Pippenger's bucket method costs roughly
# (bits/c)·(n + 2^c) point additions for the whole batch vs ~770
# additions per signature serially.  The per-signature floor is the
# exact prime-subgroup check on R (one windowed scalar multiplication
# by q) plus one R-point decompression — see the module docstring for
# why the subgroup gate is not optional.

#: q in 4-bit windows, most-significant first, for ``_in_prime_subgroup``.
_Q_WINDOWS = tuple(
    (_Q >> (4 * i)) & 15 for i in reversed(range((_Q.bit_length() + 3) // 4))
)


def _in_prime_subgroup(pt) -> bool:
    """True iff ``pt`` lies in the prime-order subgroup, i.e. carries no
    small-order torsion component: ``[q]·pt == identity``, computed
    exactly (no probabilistic shortcut exists — the torsion group is
    Z/8, far too small for random-linear-combination soundness).  Fixed
    4-bit windows: 14 setup additions buy ~¼ the adds of plain
    double-and-add over the 253-bit q."""
    mults = [_IDENT, pt]
    for _ in range(14):
        mults.append(_pt_add(mults[-1], pt))
    acc = _IDENT
    for w in _Q_WINDOWS:
        for _ in range(4):
            acc = _pt_double(acc)
        if w:
            acc = _pt_add(acc, mults[w])
    return _pt_equal(acc, _IDENT)


@functools.lru_cache(maxsize=4096)
def _pubkey_point(pubkey: bytes):
    """``(point, in_prime_subgroup)`` for a compressed public key —
    ``(None, False)`` when undecodable.  Cached: senders repeat across
    the transactions of a window (one account signs many spends), and
    the subgroup check costs a scalar multiplication by q on top of the
    two ~250-bit exponentiations of decompression.  R points are unique
    per signature, so their checks are paid per signature, uncached."""
    pt = _pt_decompress(pubkey)
    if pt is None:
        return None, False
    return pt, _in_prime_subgroup(pt)


def _msm(pairs) -> tuple:
    """Σ scalar·point over ``pairs`` (Pippenger bucket method).

    Scalars are plain non-negative integers of any width; the caller
    may reduce them mod the group order q only where the paired point
    is proven to lie in the prime-order subgroup (``verify_batch``
    checks exactly that before building its pairs — for a point with a
    torsion component, mod-q scalar arithmetic would be invalid).
    """
    pairs = [(s, p) for s, p in pairs if s > 0]
    if not pairs:
        return _IDENT
    maxbits = max(s.bit_length() for s, _ in pairs)
    n = len(pairs)
    # Window width: minimize (maxbits/c)·(n + 2^(c+1)) — the point pass
    # is n adds per window, the running-sum bucket aggregation 2·2^c.
    c = min(
        range(2, 16),
        key=lambda w: -(-maxbits // w) * (n + (2 << w)),
    )
    nbuckets = 1 << c
    mask = nbuckets - 1
    result = _IDENT
    for shift in range(((maxbits + c - 1) // c) - 1, -1, -1):
        if result is not _IDENT:
            for _ in range(c):
                result = _pt_double(result)
        buckets = [None] * nbuckets
        base = shift * c
        for s, p in pairs:
            idx = (s >> base) & mask
            if idx:
                b = buckets[idx]
                buckets[idx] = p if b is None else _pt_add(b, p)
        # Running-sum aggregation: Σ idx·bucket[idx] with 2·(2^c) adds.
        running = None
        acc = None
        for idx in range(nbuckets - 1, 0, -1):
            b = buckets[idx]
            if b is not None:
                running = b if running is None else _pt_add(running, b)
            if running is not None:
                acc = running if acc is None else _pt_add(acc, running)
        if acc is not None:
            result = acc if result is _IDENT else _pt_add(result, acc)
    return result


def verify_batch(triples) -> bool:
    """True only if every ``(pubkey, sig, message)`` triple passes the
    SERIAL check (up to the 2⁻¹²⁸ soundness bound): subgroup-gated
    points plus one random-linear-combination equation (module
    docstring).  False does NOT imply a serial reject — the gate also
    rejects torsion-crafted inputs the serial equation tolerates — so
    callers settle a failed batch with ``keys.first_invalid``'s serial
    confirmation, keeping per-signature verdicts and error reporting
    exactly the serial path's.
    """
    pairs = []  # (scalar, point) terms of the combination
    s_total = 0  # coefficient of the base point, mod Q (B has order Q)
    for pubkey, sig, message in triples:
        if len(pubkey) != 32 or len(sig) != 64:
            return False
        a_pt, a_in_subgroup = _pubkey_point(bytes(pubkey))
        if not a_in_subgroup:
            return False
        r_pt = _pt_decompress(sig[:32])
        if r_pt is None or not _in_prime_subgroup(r_pt):
            return False
        s = int.from_bytes(sig[32:], "little")
        if s >= _Q:
            return False
        k = int.from_bytes(_sha512(sig[:32] + pubkey + message), "little") % _Q
        # Unpredictable per-batch coefficients: an adversary must not be
        # able to craft signatures whose errors cancel in the sum.
        z = secrets.randbits(128) | 1
        s_total = (s_total + z * s) % _Q
        pairs.append((z, r_pt))
        # z·k reduced mod Q is exact here: A is proven to have order q,
        # so the reduction shifts the term by a multiple of [q]A = O.
        # Keeps every MSM scalar ≤ 253 bits instead of ~381.
        pairs.append((z * k % _Q, a_pt))
    if not pairs:
        return True
    # Check  Σ z_i·R_i + Σ z_i·k_i·A_i − (Σ z_i·s_i)·B == identity.
    # Every point in the sum is proven torsion-free, so this cofactorless
    # comparison is exactly the serial equation's linear combination —
    # no cofactor clearing, nothing for torsion to hide in.
    if s_total:
        pairs.append((_Q - s_total, _B))
    return _pt_equal(_msm(pairs), _IDENT)
