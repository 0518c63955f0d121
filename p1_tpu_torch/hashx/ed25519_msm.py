"""Ed25519 batch verification on the card: the host's half and the plain version.

The port of ``p1_tpu/hashx/ed25519_msm.py``.  It evaluates the same
subgroup-gated batch equation as ``core/_ed25519.py::verify_batch`` —
an exact prime-subgroup gate (``[q]·P == identity``) on every point plus
one random-linear-combination multi-scalar multiplication — with the
JAX package's division of labour, kept exactly:

- **Host** (``prepare``): parse and range-check (a bad length, ``s ≥ q``
  or an undecodable A or R returns False before anything reaches the
  card), decompress, SHA-512 challenges, the 128-bit coefficients
  ``z``, and pubkey dedup — one point and ONE merged scalar ``Σ z·k``
  per unique key.
- **Card** (``cuda_ed25519.gate_msm``, the kernels ``csrc/ed25519_msm.cu``):
  the gate on every point and ``Σ sᵢ·Pᵢ``, read back as one all-ok flag
  and one point.
- **Host close** (``close``): the base-point term ``[q − s_total]·B`` and
  the identity check.

Radix.  A field element is ten signed limbs of 26, 25, 26, ... bits
(ref10's 25.5-bit radix), carried in int64 lanes: torch ``uint32`` has
no ``>>``, ``+`` or ``<``.  ``fe_add``/``fe_sub`` do not carry; ``fe_mul``
sums each of the ten output columns exactly (odd×odd limb products
doubled, wrapped columns folded by 19) and carries twice in parallel,
leaving |limb| ≤ 2^25 (even) / 2^24 (odd) plus a few parts in 10^3.
The point formulas feed ``fe_mul`` at most four such values summed, so a
column stays under 2^61.  ``fe_canon`` reduces to the canonical value
before every equality or identity test.  The kernel uses the same radix,
the same carries and the same operation order, so the two agree limb for
limb and a failing comparison points at one operation.

The plain PyTorch version (``plain_gate_msm``) is fe25519 and point
arithmetic on tensors, batched over a leading axis: the CPU tests and
``device="cpu"`` use it, and nothing on the card's path does.  Both
compute every point's windowed scalar multiplication the same way: a
16-entry table ``[0..15]·P`` built by repeated ``ge_add``, then 64
windows of four doublings and one table add, most significant first.
The gate runs q's windows, the MSM each point's own scalar's.

Padding: the JAX package pads the points to a power of two per device
for its tree.  The port does not pad: the kernel's sum takes any count.

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
    d2: torch.Tensor  # (10,) 2·d mod p


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
        d2=torch.tensor(fe_from_int(2 * _py._D), dtype=torch.int64, device=device),
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
    by repeated ``ge_add`` as the kernel builds it."""
    rows = [ge_identity(points.shape[:-2], points.device), points]
    for _ in range(14):
        rows.append(ge_add(rows[-1], points))
    return torch.stack(rows, dim=1)


def scalar_mul_windows(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """``digits[i]``'s scalar times ``points[i]`` for every row: 64
    windows, most significant first, of four doublings and one table add
    (the identity for a zero digit)."""
    n = points.shape[0]
    table = point_table(points)
    acc = ge_identity((n,), points.device)
    for w in range(digits.shape[1]):
        for _ in range(4):
            acc = ge_double(acc)
        idx = digits[:, w].view(n, 1, 1, 1).expand(n, 1, 4, FE_LIMBS)
        acc = ge_add(acc, torch.gather(table, 1, idx).squeeze(1))
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


@dataclasses.dataclass(frozen=True)
class GateMsm:
    """What the device stage returns, on the inputs' device.

    ``result`` is the kernel's one read-back: int32 [all-ok, X, Y, Z, T]
    (1 + 4·10).  ``products`` (N, 4, 10) holds every sᵢ·Pᵢ and ``flags``
    (N,) every gate verdict (1: [q]·Pᵢ is the identity); they stay on
    the device unless a check reads them."""

    result: torch.Tensor
    products: torch.Tensor
    flags: torch.Tensor


def plain_gate_msm(points: torch.Tensor, scalars: torch.Tensor) -> GateMsm:
    """The plain PyTorch version of the kernel on ``points`` ((N, 4, 10)
    int32 limbs) and ``scalars`` ((N, 8) int32 words), on their device."""
    n = points.shape[0]
    pts = points.to(torch.int64)
    words = scalars.to(torch.int64) & 0xFFFFFFFF
    q_words = torch.tensor(Q_WORDS, dtype=torch.int64, device=points.device).expand(n, -1)
    both = scalar_mul_windows(torch.cat([pts, pts]), digits_of_words(torch.cat([q_words, words])))
    flags = ge_is_identity(both[:n])
    products = both[n:]
    total = tree_sum(products)
    ok = torch.all(flags).to(torch.int64).reshape(1)
    result = torch.cat([ok, total.reshape(-1)]).to(torch.int32)
    return GateMsm(result, products.to(torch.int32), flags.to(torch.int32))


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


@dataclasses.dataclass
class Prepared:
    """The host's half of one batch, ready for the card: every unique A
    and every R (``points``, (N, 4, 10) int32), their MSM scalars
    (``scalars``, (N, 8) uint32 words), and the base point's coefficient
    Σ zᵢ·sᵢ mod q (``s_total``)."""

    points: np.ndarray
    scalars: np.ndarray
    s_total: int


def prepare(triples, rng=None) -> Prepared | None:
    """Parse, range-check, decompress, hash and combine on the host; None
    where the batch fails before any device work (bad length, s ≥ q,
    undecodable A or R).  Coefficients are ``secrets.randbits(128) | 1``
    — unpredictable, which the batch's soundness needs — unless ``rng``
    (a ``random.Random``) is given, which tests pass so that the kernel
    and the plain version see the same scalars."""
    draw = secrets.randbits if rng is None else rng.getrandbits
    points = []  # decompressed (x, y, z, t) int tuples
    scalars = []  # matching MSM coefficients
    a_slots: dict[bytes, int] = {}  # pubkey -> index into points
    s_total = 0
    for pubkey, sig, message in triples:
        if len(pubkey) != 32 or len(sig) != 64:
            return None
        s = int.from_bytes(sig[32:], "little")
        if s >= _py._Q:
            return None
        pubkey = bytes(pubkey)
        slot = a_slots.get(pubkey)
        if slot is None:
            a_pt = _py._pt_decompress(pubkey)
            if a_pt is None:
                return None
            slot = len(points)
            a_slots[pubkey] = slot
            points.append(a_pt)
            scalars.append(0)
        r_pt = _py._pt_decompress(sig[:32])
        if r_pt is None:
            return None
        k = int.from_bytes(_py._sha512(sig[:32] + pubkey + message), "little") % _py._Q
        z = draw(128) | 1
        s_total = (s_total + z * s) % _py._Q
        # The mod-q merges are exact only because the device gate PROVES
        # every point has order q before the sum is trusted (the same
        # gate-first contract as every other backend).
        scalars[slot] = (scalars[slot] + z * k) % _py._Q
        points.append(r_pt)
        scalars.append(z)
    return Prepared(encode_points(points), encode_scalars(scalars), s_total)


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
    """The batch's points and scalar words as int32 tensors on ``device``."""
    points = torch.from_numpy(prep.points).to(device)
    scalars = torch.from_numpy(prep.scalars.view(np.int32)).to(device)
    return points, scalars


def close(result, s_total: int) -> bool:
    """The host's close on the read-back ``result`` (int32 [all-ok, X, Y,
    Z, T]): every point gated, then Σ sᵢ·Pᵢ + [q − s_total]·B must be
    the identity."""
    result = np.asarray(result)
    if not result[0]:
        return False
    acc = decode_point(result[1:])
    if s_total:
        acc = _py._pt_add(acc, _py._pt_mul(_py._Q - s_total, _py._B))
    return _py._pt_equal(acc, _py._IDENT)


def verify_batch_device(triples, device=None, rng=None) -> bool:
    """``_ed25519.verify_batch`` with the gate and the MSM on the card.

    ``device`` is where the device stage runs: the card (None or "cuda",
    the default; raises without one) or "cpu" (the plain PyTorch
    version).  ``rng``: see ``prepare``.  Accepts iff the pure-Python
    batch would (same gate, same combination, independent randomness) —
    False is NOT a serial verdict, exactly the ``verify_batch`` contract
    everywhere else."""
    from p1_tpu_torch.hashx import cuda_ed25519  # imports this module

    triples = list(triples)
    if not triples:
        return True
    dev = resolve_device(device)
    prep = prepare(triples, rng)
    if prep is None:
        return False
    out = cuda_ed25519.gate_msm(*to_device(prep, dev))
    return close(out.result.cpu().numpy(), prep.s_total)
