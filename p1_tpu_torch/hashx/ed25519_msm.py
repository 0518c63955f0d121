"""Ed25519 batch verification on the card: the host's half and the plain version.

The port of ``p1_tpu/hashx/ed25519_msm.py``.  It evaluates the same
subgroup-gated batch equation as ``core/_ed25519.py::verify_batch`` —
an exact prime-subgroup gate (``[q]·P == identity``) on every point plus
one random-linear-combination multi-scalar multiplication — but moves
onto the card the two host stages that dwarf the device work in the JAX
package's division of labour (one ~255-bit exponentiation per point in
decompression, and the base-point term of the close):

- **Host** (``prepare``): parse and range-check (a bad length, ``s ≥ q``
  or an A or R whose ``y ≥ p`` returns False before anything reaches the
  card), SHA-512 challenges, the 128-bit coefficients ``z``, and pubkey
  dedup — one point and ONE merged scalar ``Σ z·k`` per unique key.  The
  points travel as their 32-byte encodings (eight uint32 words, the sign
  of x in bit 255), and the base point joins the batch as one more point
  with the scalar ``(q − Σ z·s) mod q``.
- **Card** (``cuda_ed25519.decode_gate_msm``, the kernels
  ``csrc/ed25519_msm.cu``): RFC 8032 §5.1.3 decompression of every point,
  the gate on every point and ``Σ sᵢ·Pᵢ``, read back as one all-ok flag
  and one point.  An encoding that does not decode clears the flag.
- **Host close** (``close``): the flag and the identity test of the sum.

Radix.  A field element is ten signed limbs of 26, 25, 26, ... bits
(ref10's 25.5-bit radix), carried in int64 lanes: torch ``uint32`` has
no ``>>``, ``+`` or ``<``.  ``fe_add``/``fe_sub`` do not carry; ``fe_mul``
sums each of the ten output columns exactly (odd×odd limb products
doubled, wrapped columns folded by 19) and carries twice in parallel,
leaving |limb| ≤ 2^25 (even) / 2^24 (odd) plus a few parts in 10^3.
The point formulas feed ``fe_mul`` at most four such values summed, so a
column stays under 2^61.  ``fe_canon`` reduces to the canonical value
before every equality or identity test.  The kernel uses the same radix
(its products carry in ref10's order, to other representatives of the
same values).  Decoded points are canonical in both (X, Y and T = XY
reduced, Z = 1), so they agree limb for limb; the sums agree in value.

The plain PyTorch version (``plain_decode_gate_msm``) is fe25519 and
point arithmetic on tensors, batched over a leading axis: the CPU tests
and ``device="cpu"`` use it, and nothing on the card's path does.  It
runs the reference's program: batched decompression (``decompress``), one
16-entry table ``[0..15]·P`` per point (``point_table``), the gate by 64
windows of q (``scalar_mul_windows``), and the MSM as Horner over
windows with a tree sum of the batch's table rows per window
(``msm_horner``, the JAX package's ``_msm_tree``).

The mesh split (``run_mesh``, the JAX package's ``shard_map`` over
``_jit_gate_msm``): the batch is cut into one contiguous slice per mesh
slot (``hashx/sharded.make_mesh``), each slice runs the kernels on its
slot's stream, and the host ANDs the slots' flags and adds their partial
sums in ``close``.  The JAX package pads the points to a power of two per
device for its tree; the port's sums take any count, so it pads only the
last slices to one length, with the identity at scalar 0, and launches no
slice without a real point.  The default mesh is every card: one launch
on one card.

Semantics are the pure-Python batch's exactly — ``verify_batch_device``
accepts iff ``_ed25519.verify_batch`` would (2⁻¹²⁸ coefficients aside),
pinned by the torsion/corruption fixtures of tests/test_torch_ed25519.py
— so ``core/keys.py`` routes batches here (the ``device`` rung, its
default) with ``first_invalid``'s serial settlement unchanged.
"""

from __future__ import annotations

import dataclasses
import functools
import secrets

import numpy as np
import torch

from p1_tpu_torch.core import _ed25519 as _py

#: Field-element shape: ten limbs of 26, 25, 26, ... bits (255 in all).
FE_LIMBS = 10
LIMB_BITS = (26, 25) * 5
LIMB_OFFSETS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)
_SCALAR_WINDOWS = 64  # 256-bit scalars in 4-bit windows
#: Scalars travel as eight little-endian uint32 words each.
SCALAR_WORDS = 8

#: The JAX package's radix: 20 limbs of 13 bits in uint32.
_REF_LIMBS = 20
_REF_BITS = 13


def fe_from_int(x: int) -> np.ndarray:
    """The canonical limbs of ``x mod p`` (int64)."""
    x %= _py._P
    return np.array(
        [(x >> o) & ((1 << b) - 1) for o, b in zip(LIMB_OFFSETS, LIMB_BITS)],
        dtype=np.int64,
    )


def fe_to_int(limbs) -> int:
    """The value mod p of ten (signed) limbs."""
    return sum(int(v) << o for v, o in zip(np.asarray(limbs).tolist(), LIMB_OFFSETS)) % _py._P


@dataclasses.dataclass(frozen=True)
class _Consts:
    """Per-device constant tensors of the radix."""

    bits: torch.Tensor  # (10,) limb widths
    half: torch.Tensor  # (10,) 2**(bits-1), the rounding of a carry
    factor: torch.Tensor  # (10, 10) 2 for odd×odd, ×19 where i+j wraps
    column: torch.Tensor  # (10, 10) index j = (k - i) mod 10 of column k's term i
    d: torch.Tensor  # (10,) d mod p
    d2: torch.Tensor  # (10,) 2·d mod p
    sqrt_m1: torch.Tensor  # (10,) √−1 mod p


@functools.lru_cache(maxsize=8)
def _consts(device: torch.device) -> _Consts:
    i = np.arange(FE_LIMBS)
    odd = i % 2 == 1
    factor = np.where(odd[:, None] & odd[None, :], 2, 1) * np.where(i[:, None] + i[None, :] >= 10, 19, 1)
    column = (i[None, :] - i[:, None]) % FE_LIMBS  # [i, k] -> j
    bits = np.array(LIMB_BITS)
    return _Consts(
        bits=torch.tensor(bits, dtype=torch.int64, device=device),
        half=torch.tensor(1 << (bits - 1), dtype=torch.int64, device=device),
        factor=torch.tensor(factor, dtype=torch.int64, device=device),
        column=torch.tensor(column, dtype=torch.int64, device=device),
        d=torch.tensor(fe_from_int(_py._D), dtype=torch.int64, device=device),
        d2=torch.tensor(fe_from_int(2 * _py._D), dtype=torch.int64, device=device),
        sqrt_m1=torch.tensor(fe_from_int(_py._SQRT_M1), dtype=torch.int64, device=device),
    )


def _carry_pass(h: torch.Tensor) -> torch.Tensor:
    """One parallel carry: every limb keeps its rounded low bits
    (|r| ≤ 2^(bits-1)) and hands the rest to the next limb; limb 9's
    carry folds into limb 0 times 19 (2^255 ≡ 19)."""
    k = _consts(h.device)
    c = (h + k.half) >> k.bits
    h = h - (c << k.bits)
    return h + torch.cat([c[..., 9:] * 19, c[..., :9]], dim=-1)


def fe_carry(h: torch.Tensor) -> torch.Tensor:
    """Two parallel carries: any column vector of ``fe_mul`` (|h| < 2^62)
    comes out with |limb| ≤ 2^25 (even) / 2^24 (odd) plus 2^16."""
    return _carry_pass(_carry_pass(h))


def fe_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def fe_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - b


def fe_mul(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The exact ten column sums of f·g, carried.  Column k gathers
    f_i·g_j for i + j ≡ k (mod 10), doubled when i and j are both odd
    (the half bits of the 25.5-bit radix) and times 19 when i + j ≥ 10."""
    k = _consts(f.device)
    prod = f.unsqueeze(-1) * g.unsqueeze(-2) * k.factor  # (..., i, j)
    cols = torch.gather(prod, -1, k.column.expand(prod.shape)).sum(dim=-2)
    return fe_carry(cols)


def fe_sq(f: torch.Tensor) -> torch.Tensor:
    """f·f: the kernel squares with half the products, whose column sums
    are these, so the limbs agree."""
    return fe_mul(f, f)


def fe_canon(h: torch.Tensor) -> torch.Tensor:
    """The canonical limbs (0 ≤ value < p, each limb in [0, 2^bits)) of
    a carried or summed field element (|limb| < 2^40).  Two carries, then
    ref10's ``fe_tobytes``: q = ⌊h / p⌋ ∈ {-1, 0, 1} read off a carry
    chain of h + 19·2^-255·h, h − q·p by floor carries."""
    h = fe_carry(h)
    limbs = [h[..., i] for i in range(FE_LIMBS)]
    q = (19 * limbs[9] + (1 << 24)) >> 25
    for i in range(FE_LIMBS):
        q = (limbs[i] + q) >> LIMB_BITS[i]
    limbs[0] = limbs[0] + 19 * q
    for i in range(FE_LIMBS - 1):
        c = limbs[i] >> LIMB_BITS[i]
        limbs[i + 1] = limbs[i + 1] + c
        limbs[i] = limbs[i] - (c << LIMB_BITS[i])
    limbs[9] = limbs[9] - ((limbs[9] >> 25) << 25)
    return torch.stack(limbs, dim=-1)


def fe_is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(fe_canon(a) == 0, dim=-1)


def fe_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fe_is_zero(fe_sub(a, b))


# ---------------------------------------------------------------- points --
# A batch of points is a (..., 4, FE_LIMBS) int64 tensor — extended
# homogeneous (X, Y, Z, T), the exact formulas of core/_ed25519.py.  Each
# group of independent products goes through one ``fe_mul`` call.


def ge_identity(shape: tuple = (), device="cpu") -> torch.Tensor:
    out = torch.zeros(shape + (4, FE_LIMBS), dtype=torch.int64, device=device)
    out[..., 1, 0] = 1  # y = 1
    out[..., 2, 0] = 1  # z = 1
    return out


def ge_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    px, py_, pz, pt = p.unbind(-2)
    qx, qy, qz, qt = q.unbind(-2)
    aa, bb, tt, zz = fe_mul(
        torch.stack([fe_sub(py_, px), fe_add(py_, px), pt, pz], dim=-2),
        torch.stack([fe_sub(qy, qx), fe_add(qy, qx), qt, qz], dim=-2),
    ).unbind(-2)
    cc = fe_mul(tt, _consts(p.device).d2)
    dd = fe_add(zz, zz)
    e = fe_sub(bb, aa)
    f = fe_sub(dd, cc)
    g = fe_add(dd, cc)
    h = fe_add(bb, aa)
    return fe_mul(torch.stack([e, g, f, e], dim=-2), torch.stack([f, h, g, h], dim=-2))


def ge_double(p: torch.Tensor) -> torch.Tensor:
    px, py_, pz, _ = p.unbind(-2)
    sq = torch.stack([px, py_, pz, fe_add(px, py_)], dim=-2)
    aa, bb, cc_, ss = fe_sq(sq).unbind(-2)
    cc = fe_add(cc_, cc_)
    h = fe_add(aa, bb)
    e = fe_sub(h, ss)
    g = fe_sub(aa, bb)
    f = fe_add(cc, g)
    return fe_mul(torch.stack([e, g, f, e], dim=-2), torch.stack([f, h, g, h], dim=-2))


def ge_is_identity(p: torch.Tensor) -> torch.Tensor:
    return fe_is_zero(p[..., 0, :]) & fe_eq(p[..., 1, :], p[..., 2, :])


def point_table(points: torch.Tensor) -> torch.Tensor:
    """Each point's window table [0]P..[15]P: (N, 16, 4, FE_LIMBS), built
    by repeated ``ge_add`` (the JAX package's ``_point_table``)."""
    rows = [ge_identity(points.shape[:-2], points.device), points]
    for _ in range(14):
        rows.append(ge_add(rows[-1], points))
    return torch.stack(rows, dim=1)


def _rows(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """``table[i, digits[i]]`` for every point i: (N, 4, FE_LIMBS)."""
    n = table.shape[0]
    idx = digits.view(n, 1, 1, 1).expand(n, 1, 4, FE_LIMBS)
    return torch.gather(table, 1, idx).squeeze(1)


def scalar_mul_windows(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """``digits[i]``'s scalar times point i for every row of its window
    ``table``: 64 windows, most significant first, of four doublings and
    one table add (the identity for a zero digit)."""
    acc = ge_identity((table.shape[0],), table.device)
    for w in range(digits.shape[1]):
        for _ in range(4):
            acc = ge_double(acc)
        acc = ge_add(acc, _rows(table, digits[:, w]))
    return acc


def msm_horner(table: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Σ sᵢ·Pᵢ as the JAX package's ``_msm_tree``: per window (most
    significant first) four doublings of one accumulator, then the tree
    sum of every point's table row for its digit.  ``digits``: (N, W)."""
    acc = ge_identity((), table.device)
    for w in range(digits.shape[1]):
        for _ in range(4):
            acc = ge_double(acc)
        acc = ge_add(acc, tree_sum(_rows(table, digits[:, w])))
    return acc


def digits_of_words(words: torch.Tensor) -> torch.Tensor:
    """(N, 8) little-endian uint32 words (int64 lanes) -> (N, 64) 4-bit
    digits, most significant first."""
    nib = torch.arange(_SCALAR_WINDOWS - 1, -1, -1, device=words.device)
    return (words[:, nib // 8] >> (4 * (nib % 8))) & 15


#: q in eight little-endian uint32 words: the gate's shared scalar.
Q_WORDS = tuple((_py._Q >> (32 * k)) & 0xFFFFFFFF for k in range(SCALAR_WORDS))


def tree_sum(points: torch.Tensor) -> torch.Tensor:
    """Σ of the (N, 4, L) points: pairwise halves, an odd tail carried."""
    while points.shape[0] > 1:
        half = points.shape[0] // 2
        head = ge_add(points[:half], points[half : 2 * half])
        points = torch.cat([head, points[2 * half :]]) if points.shape[0] % 2 else head
    return points[0]


# --------------------------------------------------------- decompression --


def limbs_of_words(words: torch.Tensor) -> torch.Tensor:
    """(N, 8) little-endian uint32 words (int64 lanes) -> (N, 10) limbs of
    the value's bits 0..254 (bit 255, the sign of x, left out)."""
    cols = []
    for o, b in zip(LIMB_OFFSETS, LIMB_BITS):
        word, shift = divmod(o, 32)
        v = words[:, word] >> shift
        if shift + b > 32:
            v = v | (words[:, word + 1] << (32 - shift))
        cols.append(v & ((1 << b) - 1))
    return torch.stack(cols, dim=-1)


def _sq_times(f: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        f = fe_sq(f)
    return f


def fe_pow22523(z: torch.Tensor) -> torch.Tensor:
    """z^((p−5)/8) = z^(2^252 − 3) by ref10's chain: 251 squarings and 11
    products, each power of the form z^(2^k − 1) built from smaller ones."""
    t0 = fe_sq(z)  # 2
    t1 = fe_mul(z, _sq_times(t0, 2))  # 9
    t0 = fe_mul(t0, t1)  # 11
    t0 = fe_mul(t1, fe_sq(t0))  # 31 = 2^5 - 1
    t0 = fe_mul(_sq_times(t0, 5), t0)  # 2^10 - 1
    t1 = fe_mul(_sq_times(t0, 10), t0)  # 2^20 - 1
    t1 = fe_mul(_sq_times(t1, 20), t1)  # 2^40 - 1
    t0 = fe_mul(_sq_times(t1, 10), t0)  # 2^50 - 1
    t1 = fe_mul(_sq_times(t0, 50), t0)  # 2^100 - 1
    t1 = fe_mul(_sq_times(t1, 100), t1)  # 2^200 - 1
    t0 = fe_mul(_sq_times(t1, 50), t0)  # 2^250 - 1
    return fe_mul(_sq_times(t0, 2), z)  # 2^252 - 3


def decompress(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """RFC 8032 §5.1.3 on (N, 8) encoding words (int64 lanes), as
    ``core/_ed25519.py::_pt_decompress``: x = u·v³·(u·v⁷)^((p−5)/8) for
    u = y² − 1, v = d·y² + 1; v·x² = u keeps x, v·x² = −u takes x·√−1,
    anything else (or y ≥ p, or x = 0 with the sign set) does not decode;
    x flips to p − x where its canonical parity is not the sign.  Returns
    the (N, 4, 10) points, canonical (X, Y, 1, X·Y), the identity where
    an encoding does not decode, and the (N,) bool ``decodes``."""
    k = _consts(words.device)
    y = limbs_of_words(words)
    sign = words[:, 7] >> 31
    one = torch.zeros_like(y)
    one[:, 0] = 1
    ok = torch.all(fe_canon(y) == y, dim=-1)  # y < p
    y2 = fe_sq(y)
    u = fe_sub(y2, one)
    v = fe_add(fe_mul(y2, k.d), one)
    v3 = fe_mul(fe_sq(v), v)
    uv3 = fe_mul(u, v3)
    x = fe_mul(uv3, fe_pow22523(fe_mul(fe_mul(uv3, v3), v)))
    vx2 = fe_mul(v, fe_sq(x))
    root = fe_is_zero(fe_sub(vx2, u))
    ok &= root | fe_is_zero(fe_add(vx2, u))
    x = fe_canon(torch.where(root[:, None], x, fe_mul(x, k.sqrt_m1)))
    ok &= ~(torch.all(x == 0, dim=-1) & (sign == 1))
    x = torch.where(((x[:, 0] & 1) != sign)[:, None], fe_canon(-x), x)
    points = torch.stack([x, y, one, fe_canon(fe_mul(x, y))], dim=-2)
    ident = ge_identity((words.shape[0],), words.device)
    return torch.where(ok[:, None, None], points, ident), ok


@dataclasses.dataclass(frozen=True)
class DecodeGateMsm:
    """What the device stage returns, on the inputs' device.

    ``result`` is the kernel's one read-back: int32 [all-ok, X, Y, Z, T]
    (1 + 4·10), all-ok 1 iff every point decodes and passes the gate.
    ``decoded`` (N, 4, 10) holds every decoded point (canonical; the
    identity where it does not decode) and ``flags`` (N,) every point's
    bits: 1 it decodes, 2 [q]·Pᵢ is the identity.  They stay on the
    device unless a check reads them."""

    result: torch.Tensor
    decoded: torch.Tensor
    flags: torch.Tensor


#: A point's flags when it decodes and passes the gate.
FLAGS_OK = 3


def plain_decode_gate_msm(encodings: torch.Tensor, scalars: torch.Tensor) -> DecodeGateMsm:
    """The plain PyTorch version of the kernels on ``encodings`` ((N, 8)
    int32 words of the 32-byte point encodings) and ``scalars`` ((N, 8)
    int32 words), on their device: decompression, one table per point,
    the gate by q's windows, Horner over windows."""
    n = encodings.shape[0]
    points, decodes = decompress(encodings.to(torch.int64) & 0xFFFFFFFF)
    table = point_table(points)
    q_words = torch.tensor(Q_WORDS, dtype=torch.int64, device=encodings.device).expand(n, -1)
    gate = ge_is_identity(scalar_mul_windows(table, digits_of_words(q_words)))
    total = msm_horner(table, digits_of_words(scalars.to(torch.int64) & 0xFFFFFFFF))
    flags = decodes.to(torch.int32) | (gate.to(torch.int32) << 1)
    ok = torch.all(flags == FLAGS_OK).to(torch.int64).reshape(1)
    result = torch.cat([ok, total.reshape(-1)]).to(torch.int32)
    return DecodeGateMsm(result, points.to(torch.int32), flags)


# ------------------------------------------------------ host encodings --


def encode_points(points) -> np.ndarray:
    """(x, y, z, t) integer tuples, each coordinate in [0, p) -> (N, 4, 10)
    int32 canonical limbs."""
    raw = b"".join(c.to_bytes(32, "little") for pt in points for c in pt)
    w = np.frombuffer(raw, dtype="<u8").reshape(len(points), 4, 4)
    out = np.empty((len(points), 4, FE_LIMBS), dtype=np.int32)
    for i, (o, b) in enumerate(zip(LIMB_OFFSETS, LIMB_BITS)):
        v = w[..., o // 64] >> np.uint64(o % 64)
        if o % 64 + b > 64:
            v = v | (w[..., o // 64 + 1] << np.uint64(64 - o % 64))
        out[..., i] = (v & np.uint64((1 << b) - 1)).astype(np.int32)
    return out


def encode_scalars(scalars) -> np.ndarray:
    """Integers in [0, 2^256) -> (N, 8) little-endian uint32 words."""
    raw = b"".join(s.to_bytes(32, "little") for s in scalars)
    return np.frombuffer(raw, dtype="<u4").reshape(len(scalars), SCALAR_WORDS).copy()


def encode_encodings(raws) -> np.ndarray:
    """32-byte point encodings -> (N, 8) little-endian uint32 words."""
    raw = b"".join(raws)
    return np.frombuffer(raw, dtype="<u4").reshape(len(raw) // 32, SCALAR_WORDS).copy()


def decode_point(limbs) -> tuple:
    """(4, 10) limbs -> an (x, y, z, t) tuple of integers mod p."""
    arr = np.asarray(limbs).reshape(4, FE_LIMBS)
    return tuple(fe_to_int(arr[i]) for i in range(4))


def from_reference_point(limbs_u32_20x13) -> np.ndarray:
    """The JAX package's (..., 4, 20) uint32 13-bit limbs -> the port's
    (..., 4, 10) int64 limbs of the same coordinates (canonical)."""
    arr = np.asarray(limbs_u32_20x13, dtype=np.uint64)
    flat = arr.reshape(-1, _REF_LIMBS)
    out = [
        fe_from_int(sum(int(v) << (_REF_BITS * i) for i, v in enumerate(row.tolist())))
        for row in flat
    ]
    return np.stack(out).reshape(arr.shape[:-1] + (FE_LIMBS,))


def to_reference_point(limbs) -> np.ndarray:
    """The port's (..., 4, 10) limbs -> the JAX package's (..., 4, 20)
    uint32 13-bit limbs of the same coordinates (canonical)."""
    arr = np.asarray(limbs)
    flat = arr.reshape(-1, FE_LIMBS)
    mask = (1 << _REF_BITS) - 1
    out = []
    for row in flat:
        x = fe_to_int(row)
        out.append([(x >> (_REF_BITS * i)) & mask for i in range(_REF_LIMBS)])
    return np.array(out, dtype=np.uint32).reshape(arr.shape[:-1] + (_REF_LIMBS,))


# ------------------------------------------------- the batch verifier --


#: The base point's encoding: it joins every batch as its last point.
B_ENC = _py._pt_compress(_py._B)


@dataclasses.dataclass
class Prepared:
    """The host's half of one batch, ready for the card: the encodings of
    every unique A, every R and last the base point B (``encodings``,
    (N, 8) uint32 words), and their MSM scalars (``scalars``, (N, 8)
    uint32 words; B's is (q − Σ zᵢ·sᵢ) mod q)."""

    encodings: np.ndarray
    scalars: np.ndarray


def _y_in_range(encoding: bytes) -> bool:
    """The cheap first check of RFC 8032 §5.1.3: y < p."""
    return int.from_bytes(encoding, "little") & ((1 << 255) - 1) < _py._P


def prepare(triples, rng=None) -> Prepared | None:
    """Parse, range-check, hash and combine on the host; None where the
    batch fails before any device work (bad length, s ≥ q, an A or R
    with y ≥ p).  Decompression is the card's.  Coefficients are
    ``secrets.randbits(128) | 1`` — unpredictable, which the batch's
    soundness needs — unless ``rng`` (a ``random.Random``) is given,
    which tests pass so that the kernel and the plain version see the
    same scalars."""
    draw = secrets.randbits if rng is None else rng.getrandbits
    encodings = []  # 32-byte point encodings
    scalars = []  # matching MSM coefficients
    a_slots: dict[bytes, int] = {}  # pubkey -> index into encodings
    s_total = 0
    for pubkey, sig, message in triples:
        if len(pubkey) != 32 or len(sig) != 64:
            return None
        s = int.from_bytes(sig[32:], "little")
        if s >= _py._Q:
            return None
        pubkey = bytes(pubkey)
        r_enc = bytes(sig[:32])
        slot = a_slots.get(pubkey)
        if slot is None:
            if not _y_in_range(pubkey):
                return None
            slot = len(encodings)
            a_slots[pubkey] = slot
            encodings.append(pubkey)
            scalars.append(0)
        if not _y_in_range(r_enc):
            return None
        k = int.from_bytes(_py._sha512(r_enc + pubkey + message), "little") % _py._Q
        z = draw(128) | 1
        s_total = (s_total + z * s) % _py._Q
        # The mod-q merges are exact only because the device gate PROVES
        # every point has order q before the sum is trusted (the same
        # gate-first contract as every other backend).
        scalars[slot] = (scalars[slot] + z * k) % _py._Q
        encodings.append(r_enc)
        scalars.append(z)
    encodings.append(B_ENC)
    scalars.append((_py._Q - s_total) % _py._Q)
    return Prepared(encode_encodings(encodings), encode_scalars(scalars))


def resolve_device(device) -> torch.device:
    """The device a batch runs on: the card unless the caller asks for
    the CPU.  Raises where the card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "verify_batch_device runs on the card and no CUDA device is "
                "available (device='cpu' runs the plain PyTorch version)"
            )
    elif dev.type != "cpu":
        raise ValueError(f"verify_batch_device runs on cuda or cpu, not {dev}")
    return dev


def to_device(prep: Prepared, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The batch's encoding and scalar words as int32 tensors on ``device``."""
    encodings = torch.from_numpy(prep.encodings.view(np.int32)).to(device)
    scalars = torch.from_numpy(prep.scalars.view(np.int32)).to(device)
    return encodings, scalars


def close(*results) -> bool:
    """The host's close on the read-back ``results``, one per mesh slot
    (int32 [all-ok, X, Y, Z, T] each): every point decoded and gated in
    every slot, and the sum of the slots' partial sums, the base-point
    term among them, is the identity.  Point addition is the cross-slot
    reduction, as in the JAX package's host close."""
    acc = _py._IDENT
    for result in results:
        result = np.asarray(result)
        if result[0] != 1:
            return False
        x, y, z, _ = decode_point(result[1:])
        if z == 0:
            return False
        # T from X, Y, Z: the sum needs extended coordinates (T = XY/Z).
        acc = _py._pt_add(acc, (x, y, z, x * y * pow(z, -1, _py._P) % _py._P))
    return _py._pt_equal(acc, _py._IDENT)


#: The identity's encoding (y = 1, x = 0): a padding point that decodes,
#: passes the gate and, with scalar 0, adds nothing.
IDENTITY_ENC = (1).to_bytes(32, "little")


def split(prep: Prepared, slots: int) -> list[Prepared]:
    """The batch cut into ``slots`` contiguous slices of one length,
    the last ones padded with the identity at scalar 0; a slice that
    would hold no real point is left out (so B, the last real point, is
    in exactly one slice)."""
    n = len(prep.encodings)
    per = -(-n // slots)
    pad = per * slots - n
    encodings = np.concatenate([prep.encodings, encode_encodings([IDENTITY_ENC] * pad)])
    scalars = np.concatenate([prep.scalars, np.zeros((pad, SCALAR_WORDS), dtype=np.uint32)])
    return [Prepared(encodings[lo : lo + per], scalars[lo : lo + per]) for lo in range(0, n, per)]


def run_mesh(prep: Prepared, mesh) -> list[np.ndarray]:
    """Decompression, the gate and the MSM of each slice of ``prep`` on
    its slot of ``mesh`` (``hashx/sharded.make_mesh``, local slots only):
    every slot's launch is queued on its own stream before any result is
    read back.  Returns the slots' results, int32 [all-ok, X, Y, Z, T]."""
    from p1_tpu_torch.hashx import cuda_ed25519  # imports this module

    if mesh.group is not None:
        raise ValueError("the signature MSM runs on one process's slots")
    outs = []
    for i, part in enumerate(split(prep, len(mesh.devices))):
        with mesh.stream(i):  # the copies, the launch and the outputs on this stream
            outs.append(cuda_ed25519.decode_gate_msm(*to_device(part, mesh.devices[i])))
    results = []
    for i, out in enumerate(outs):
        with mesh.stream(i):
            results.append(out.result.cpu().numpy())
    return results


@functools.lru_cache(maxsize=8)
def default_mesh(device: torch.device, n_devices: int | None = None):
    """The mesh a batch runs on when the caller names none: every card
    (one slot each), or the CPU; ``n_devices`` takes the first ones."""
    from p1_tpu_torch.hashx.sharded import make_mesh

    return make_mesh(n_devices, device, across_processes=False)


def verify_batch_device(triples, device=None, rng=None, mesh=None, n_devices: int | None = None) -> bool:
    """``_ed25519.verify_batch`` with decompression, the gate and the MSM
    on the card, split over the slots of a mesh.

    ``device`` is where the device stage runs: the card (None or "cuda",
    the default; raises without one) or "cpu" (the plain PyTorch
    version).  ``mesh`` (``hashx/sharded.make_mesh(...,
    across_processes=False)``) splits the batch over its slots, one launch
    each; by default every card (``n_devices``: the first ones), which is
    one launch on one card.  ``rng``: see ``prepare``.  Accepts iff the
    pure-Python batch would (same gate, same combination, independent
    randomness) — False is NOT a serial verdict, exactly the
    ``verify_batch`` contract everywhere else."""
    triples = list(triples)
    if not triples:
        return True
    if mesh is None:
        mesh = default_mesh(resolve_device(device), n_devices)
    prep = prepare(triples, rng)
    if prep is None:
        return False
    return close(*run_mesh(prep, mesh))
