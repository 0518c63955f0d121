// Ed25519 batch verification for Hopper (sm_90a): point decompression, the
// subgroup gate on every point and the multi-scalar multiplication
// sum_i s_i * P_i, in two kernels.
//
// Replaces the XLA device program (not a Pallas kernel) of
// `p1_tpu/hashx/ed25519_msm.py:_jit_gate_msm` (`:361`, body `program`
// `:383`): `_gate_all` (`:318`, [q]P == identity for every point) and
// `_msm_tree` (`:336`, Horner over 4-bit windows with a tree sum of the
// batch's table rows per window), on the tables of `_point_table` (`:295`),
// preceded by the decompression the JAX package leaves on the host
// (`core/_ed25519.py:_pt_decompress`, RFC 8032 section 5.1.3).  Contract: for N
// 32-byte point encodings and N scalars, `result` = [every point decodes and
// passes the gate, X, Y, Z, T of sum_i s_i * P_i]; per point, `decoded[i]`
// is the decoded point (canonical X, Y, T = XY, Z = 1; the identity where
// the encoding does not decode) and `flags[i]` its bits (1: decodes, 2:
// [q]P_i is the identity).  The host (hashx/ed25519_msm.py) parses, hashes
// and closes; the base point rides in the batch as one more point.
//
// Field elements: ten signed limbs of 26, 25, 26, ... bits (ref10's radix),
// int32 at rest, products and column sums in int64.  fe_add and fe_sub do
// not carry; the point formulas feed fe_mul at most four carried values
// summed (|limb| <= 2^27), so a column sum stays under 2^61 and every
// operand of a product fits int32.  The plain PyTorch version
// (`ed25519_msm.plain_decode_gate_msm`) uses the same radix, with parallel
// carries where fe_mul here carries in ref10's order; the decoded points are
// canonical in both and agree limb for limb, the sums agree in value (the
// kernel adds per block).
//
// What bounds it on this card: integer instructions, and before that the
// latency of long dependent chains.  A point costs one decompression (254
// squarings and 20 products, most of them ref10's pow22523 chain), a
// 16-entry table (14 additions), the gate (252 doublings and 33 additions:
// q's top digit is 1 and 31 of its 64 are 0) and 64 additions of the MSM:
// ~780,000 instructions for 192 input bytes.  The
// kernel it replaces ran one thread per (point, role), 2,064 threads at a
// 1,024-signature batch, each a chain of ~790,000 dependent instructions,
// and did every point's full scalar multiplication twice (3.5% of its
// bound, PERF.md).  Here a block's time is the longest chain of dependent
// field operations in one of its warps (decompression, the tables, then
// the window sums and Horner's high half), each operation a few hundred
// instructions on the integer pipes of one SM sub-partition: the kernel
// stays latency-bound, far from the card's issue rate.
//
// What the design does about it:
// - Kernel (a), `decode_gate_msm_kernel`: one block of 128 threads per 8
//   points (130 blocks at 1,033 points: about one per SM).  Warp 0 holds the
//   8 points, four lanes each; lane k of a point holds its coordinate k
//   (X, Y, Z, T).  It decompresses them (all four lanes alike), builds each
//   point's window table [0..15]P in shared memory, in ref10's cached form
//   (Y - X, Y + X, 2Z, 2dT), so that a table add is 8 products: 4
//   independent ones (one a lane), a shuffle of 10 limbs, 4 more.  A
//   doubling is 4 squares, then 4 products.  Then warp 0 runs the gate,
//   64 windows of q (whose digits are the same for every point: no
//   divergence; the 31 zero digits add nothing), most significant first,
//   with no doublings before the first addition (they would double the
//   identity).
// - Field products are IMAD.WIDE, one a limb product (`mad_wide`), and
//   carry in ref10's order, which needs fewer instructions than two
//   parallel passes.
// - Beside it, warps 1-3 (24 groups of four lanes) run the block's share of
//   the MSM as the reference does: each group takes windows w, w - 24, ...
//   and sums the block's 8 table rows for their digits as a tree into
//   `window_sums[w]`; after a barrier of the three warps, warps 1 and 2 run
//   Horner over the windows, acc = 16 acc + window_sums[w], warp 2 on the
//   low 32 windows, warp 1 on the high 32 and then 128 doublings (x 16^32),
//   so the chain after the window sums is 284 point operations, not 316;
//   warp 1 adds the low half and writes the block's accumulator.  Horner is
//   linear, so the blocks' accumulators sum to sum_i s_i * P_i with no
//   grid-wide synchronisation.
// - Kernel (b), `point_sum_kernel`: one block of 64 groups of four lanes
//   sums the blocks' accumulators with the same four-lane additions (a
//   tree in shared memory, 10 KB) and ANDs the points' flags.  One read-back of 41 int32; the host tests the identity.
// - Points past N in the last block are the identity (the encoding y = 1)
//   with scalar 0: every lane stays in every loop, so every shuffle has all
//   32 lanes of its warp.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLimbs = 10;
constexpr int kLanes = 4;  // lanes per point: lane k holds coordinate k
constexpr int kPointsPerBlock = 8;
constexpr int kMsmWarps = 3;
constexpr int kThreads = 32 * (1 + kMsmWarps);  // threads per block of kernel (a)
constexpr int kWindows = 64;
constexpr int kMsmGroups = kMsmWarps * 32 / kLanes;                 // 24
constexpr int kSumRounds = (kWindows + kMsmGroups - 1) / kMsmGroups;  // 3
constexpr int kSumThreads = 256;  // the one block of kernel (b)
constexpr int kSumGroups = kSumThreads / kLanes;  // 64
constexpr int kFlagsOk = 3;
constexpr unsigned kFull = 0xffffffffu;

// d, 2d and sqrt(-1) mod p in the radix, and q in little-endian 32-bit words.
__constant__ int32_t kD[kLimbs] = {56195235, 13857412, 51736253, 6949390, 114729,
                                   24766616, 60832955, 30306712, 48412415, 21499315};
__constant__ int32_t kD2[kLimbs] = {45281625, 27714825, 36363642, 13898781, 229458,
                                    15978800, 54557047, 27058993, 29715967, 9444199};
__constant__ int32_t kSqrtM1[kLimbs] = {34513072, 25610706, 9377949, 3500415, 12389472,
                                        33281959, 41962654, 31548777, 326685, 11406482};
__constant__ uint32_t kQWords[8] = {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,
                                    0u,          0u,          0u,          0x10000000u};

struct Fe {
  int32_t v[kLimbs];
};

__device__ __forceinline__ constexpr int limb_bits(int i) { return (i & 1) ? 25 : 26; }

__device__ __forceinline__ Fe fe_small(int32_t c) {
  Fe r = {};
  r.v[0] = c;
  return r;
}

__device__ __forceinline__ Fe fe_const(const int32_t* c) {
  Fe r;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) r.v[i] = c[i];
  return r;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) r.v[i] = a.v[i] + b.v[i];
  return r;
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) r.v[i] = a.v[i] - b.v[i];
  return r;
}

// a * b + c with a 64-bit c: one IMAD.WIDE.  (Written as `int64_t(a) * b`,
// the compiler multiplies unsigned and corrects the high word with two
// more IMADs a product.)
__device__ __forceinline__ int64_t mad_wide(int32_t a, int32_t b, int64_t c) {
#ifdef __CUDA_ARCH__
  int64_t d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
#else
  return c + static_cast<int64_t>(a) * b;
#endif
}

// One parallel carry: limb i keeps its rounded low bits and hands the rest
// to limb i+1; limb 9's carry folds into limb 0 times 19 (2^255 = 19).
__device__ __forceinline__ void carry_pass(int64_t h[kLimbs]) {
  int64_t c[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const int b = limb_bits(i);
    c[i] = (h[i] + (int64_t{1} << (b - 1))) >> b;
    h[i] -= c[i] * (int64_t{1} << b);
  }
  h[0] += 19 * c[kLimbs - 1];
#pragma unroll
  for (int i = 1; i < kLimbs; ++i) h[i] += c[i - 1];
}

// Limb i hands its rounded carry to limb i + 1 (limb 9's folds into limb 0
// times 19, 2^255 = 19).
__device__ __forceinline__ void carry_one(int64_t h[kLimbs], int i) {
  const int b = limb_bits(i);
  const int64_t c = (h[i] + (int64_t{1} << (b - 1))) >> b;
  h[i] -= c * (int64_t{1} << b);
  if (i == kLimbs - 1) {
    h[0] += 19 * c;
  } else {
    h[i + 1] += c;
  }
}

// Columns 0..18 -> ten limbs (column k + 10 folds into k times 19), carried
// in ref10's order: two interleaved chains from limbs 0 and 4, then 9 -> 0
// -> 1.  Every limb ends within 2^(bits - 1) plus 2^16 (a column < 2^63).
__device__ __forceinline__ Fe fe_reduce(const int64_t col[2 * kLimbs - 1]) {
  int64_t h[kLimbs];
#pragma unroll
  for (int k = 0; k < kLimbs - 1; ++k) h[k] = col[k] + 19 * col[k + kLimbs];
  h[kLimbs - 1] = col[kLimbs - 1];
  carry_one(h, 0);
  carry_one(h, 4);
  carry_one(h, 1);
  carry_one(h, 5);
  carry_one(h, 2);
  carry_one(h, 6);
  carry_one(h, 3);
  carry_one(h, 7);
  carry_one(h, 4);
  carry_one(h, 8);
  carry_one(h, 9);
  carry_one(h, 0);
  Fe r;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) r.v[i] = static_cast<int32_t>(h[i]);
  return r;
}

// f * g: f_i * g_j goes to column i + j, doubled when i and j are both odd
// (2^ceil(25.5 i) * 2^ceil(25.5 j) = 2 * 2^(25.5 (i + j))).
__device__ __forceinline__ Fe fe_mul(const Fe& f, const Fe& g) {
  int32_t f2[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
  int64_t col[2 * kLimbs - 1] = {};
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) col[i + j] = mad_wide((j & 1) ? f2[i] : f.v[i], g.v[j], col[i + j]);
  }
  return fe_reduce(col);
}

// f * f with half the products: the same column sums as fe_mul(f, f).
__device__ __forceinline__ Fe fe_sq(const Fe& f) {
  int32_t f2[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) f2[i] = 2 * f.v[i];
  int64_t col[2 * kLimbs - 1] = {};
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    col[2 * i] = mad_wide((i & 1) ? f2[i] : f.v[i], f.v[i], col[2 * i]);
#pragma unroll
    for (int j = i + 1; j < kLimbs; ++j) col[i + j] = mad_wide(f2[i], ((i & j) & 1) ? f2[j] : f.v[j], col[i + j]);
  }
  return fe_reduce(col);
}

__device__ __forceinline__ Fe fe_mul_d2(const Fe& f) { return fe_mul(f, fe_const(kD2)); }

// The canonical limbs (0 <= value < p, limb i in [0, 2^bits)): two carries,
// then ref10's fe_tobytes reduction (q = floor(h / p) from a carry chain).
__device__ __forceinline__ Fe fe_canon(const Fe& a) {
  int64_t h[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) h[i] = a.v[i];
  carry_pass(h);
  carry_pass(h);
  int64_t q = (19 * h[kLimbs - 1] + (int64_t{1} << 24)) >> 25;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) q = (h[i] + q) >> limb_bits(i);
  h[0] += 19 * q;
#pragma unroll
  for (int i = 0; i < kLimbs - 1; ++i) {
    const int64_t c = h[i] >> limb_bits(i);
    h[i + 1] += c;
    h[i] -= c * (int64_t{1} << limb_bits(i));
  }
  h[kLimbs - 1] &= (int64_t{1} << 25) - 1;
  Fe r;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) r.v[i] = static_cast<int32_t>(h[i]);
  return r;
}

__device__ __forceinline__ bool fe_is_canonical_zero(const Fe& c) {
  int32_t any = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) any |= c.v[i];
  return any == 0;
}

// True iff the element is 0 mod p.
__device__ __forceinline__ bool fe_is_zero(const Fe& a) { return fe_is_canonical_zero(fe_canon(a)); }

__device__ __forceinline__ bool fe_limbs_equal(const Fe& a, const Fe& b) {
  int32_t diff = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) diff |= a.v[i] ^ b.v[i];
  return diff == 0;
}

// ------------------------------------------------------------ decompression

// Bits 0..254 of eight little-endian words (bit 255, the sign of x, left
// out): limb i starts at bit ceil(25.5 i) = (51 i + 1) / 2.
__device__ __forceinline__ Fe fe_from_words(const uint32_t w[8]) {
  Fe r;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const int offset = (51 * i + 1) / 2, word = offset / 32, shift = offset % 32;
    uint32_t v = w[word] >> shift;
    if (shift + limb_bits(i) > 32) v |= w[word + 1] << (32 - shift);
    r.v[i] = static_cast<int32_t>(v & ((1u << limb_bits(i)) - 1));
  }
  return r;
}

__device__ __forceinline__ Fe fe_sq_times(Fe f, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) f = fe_sq(f);
  return f;
}

// z^((p - 5) / 8) = z^(2^252 - 3): ref10's fe_pow22523, 251 squarings and
// 11 products, each power z^(2^k - 1) built from smaller ones.
__device__ __forceinline__ Fe fe_pow22523(const Fe& z) {
  Fe t0 = fe_sq(z);                           // 2
  Fe t1 = fe_mul(z, fe_sq_times(t0, 2));      // 9
  t0 = fe_mul(t0, t1);                        // 11
  t0 = fe_mul(t1, fe_sq(t0));                 // 31 = 2^5 - 1
  t0 = fe_mul(fe_sq_times(t0, 5), t0);        // 2^10 - 1
  t1 = fe_mul(fe_sq_times(t0, 10), t0);       // 2^20 - 1
  t1 = fe_mul(fe_sq_times(t1, 20), t1);       // 2^40 - 1
  t0 = fe_mul(fe_sq_times(t1, 10), t0);       // 2^50 - 1
  t1 = fe_mul(fe_sq_times(t0, 50), t0);       // 2^100 - 1
  t1 = fe_mul(fe_sq_times(t1, 100), t1);      // 2^200 - 1
  t0 = fe_mul(fe_sq_times(t1, 50), t0);       // 2^250 - 1
  return fe_mul(fe_sq_times(t0, 2), z);       // 2^252 - 3
}

struct Decoded {
  Fe x, y, t;  // canonical; the identity's (0, 1, 0) where !ok
  bool ok;
};

// RFC 8032 section 5.1.3 as core/_ed25519.py::_pt_decompress: u = y^2 - 1,
// v = d y^2 + 1, x = u v^3 (u v^7)^((p - 5) / 8); v x^2 = u keeps x,
// v x^2 = -u takes x sqrt(-1), anything else does not decode, nor does
// y >= p or x = 0 with the sign set; x flips to p - x where the parity of
// its canonical value is not the sign.  (u = 0 needs no case of its own:
// it gives x = 0 through the same steps, as the reference's early return.)
__device__ __forceinline__ Decoded decompress(const uint32_t w[8]) {
  const Fe y = fe_from_words(w);
  const int32_t sign = static_cast<int32_t>(w[7] >> 31);
  const Fe one = fe_small(1);
  bool ok = fe_limbs_equal(fe_canon(y), y);  // y < p
  const Fe y2 = fe_sq(y);
  const Fe u = fe_sub(y2, one);
  const Fe v = fe_add(fe_mul(y2, fe_const(kD)), one);
  const Fe v3 = fe_mul(fe_sq(v), v);
  const Fe uv3 = fe_mul(u, v3);
  Fe x = fe_mul(uv3, fe_pow22523(fe_mul(fe_mul(uv3, v3), v)));
  const Fe vx2 = fe_mul(v, fe_sq(x));
  const bool root = fe_is_zero(fe_sub(vx2, u));
  ok = ok && (root || fe_is_zero(fe_add(vx2, u)));
  x = fe_canon(root ? x : fe_mul(x, fe_const(kSqrtM1)));
  ok = ok && !(fe_is_canonical_zero(x) && sign);
  if ((x.v[0] & 1) != sign) x = fe_canon(fe_sub(fe_small(0), x));
  Decoded d;
  d.ok = ok;
  d.x = ok ? x : fe_small(0);
  d.y = ok ? y : one;
  d.t = ok ? fe_canon(fe_mul(x, y)) : fe_small(0);
  return d;
}

// ------------------------------------------ points on four lanes a point
//
// Lane k of a group of four (first lane `base`) holds coordinate k of a
// point: X, Y, Z, T (extended) or Y - X, Y + X, 2Z, 2dT (cached).  Each step
// forms every lane's operand as a[s1] + sg * a[s2] from the group's lanes,
// with s1, s2 and sg + 1 per lane read from a packed table (the nibble of
// lane k at bits 4k).

struct Lane {
  int k;     // the coordinate this lane holds
  int base;  // the group's first lane
};

__device__ __forceinline__ int nibble(uint32_t packed, int k) { return (packed >> (4 * k)) & 15; }

__device__ __forceinline__ Fe lin2(const Fe& a, const Lane& l, uint32_t s1, uint32_t s2, uint32_t sg) {
  const int l1 = l.base + nibble(s1, l.k), l2 = l.base + nibble(s2, l.k);
  const int32_t g = nibble(sg, l.k) - 1;
  Fe r;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    r.v[i] = __shfl_sync(kFull, a.v[i], l1) + g * __shfl_sync(kFull, a.v[i], l2);
  }
  return r;
}

__device__ __forceinline__ Fe ge4_identity(const Lane& l) { return fe_small(l.k == 1 || l.k == 2); }

__device__ __forceinline__ Fe ge4_cached_identity(const Lane& l) {
  return fe_small(l.k < 2 ? 1 : (l.k == 2 ? 2 : 0));
}

// Extended p plus cached q (core/_ed25519.py::_pt_add): lanes multiply
// (Y1 - X1, Y1 + X1, Z1, T1) by q's coordinate, giving A, B, D, C; then
// E = B - A, F = D - C, G = D + C, H = B + A and lanes multiply (E, G, F,
// E) by (F, H, G, H).
__device__ __forceinline__ Fe ge4_add(const Fe& p, const Fe& qc, const Lane& l) {
  const Fe m = fe_mul(lin2(p, l, 0x3211, 0x0000, 0x1120), qc);
  return fe_mul(lin2(m, l, 0x1221, 0x0330, 0x0020), lin2(m, l, 0x1212, 0x0303, 0x2220));
}

// core/_ed25519.py::_pt_double: lanes square (X, Y, Z, X + Y), giving aa,
// bb, zz, ss; form (aa + bb, aa - bb, 2zz, ss) = (h, g, cc, ss); then
// e = h - ss, f = cc + g, and lanes multiply (e, g, f, e) by (f, h, g, h).
__device__ __forceinline__ Fe ge4_double(const Fe& p, const Lane& l) {
  const Fe m = fe_sq(lin2(p, l, 0x0210, 0x1000, 0x2111));
  const Fe n = lin2(m, l, 0x3200, 0x3211, 0x1202);
  return fe_mul(lin2(n, l, 0x0210, 0x3113, 0x0210), lin2(n, l, 0x0102, 0x0101, 0x1112));
}

// Extended -> cached: (Y - X, Y + X, 2Z, 2dT).
__device__ __forceinline__ Fe ge4_cached(const Fe& p, const Lane& l) {
  Fe c = lin2(p, l, 0x3211, 0x3200, 0x1220);
  if (l.k == 3) c = fe_mul_d2(c);
  return c;
}

// X = 0 and Y = Z (lane 0 tests X, lane 1 Y - Z).
__device__ __forceinline__ bool ge4_is_identity(const Fe& p, const Lane& l) {
  const bool zero = fe_is_zero(lin2(p, l, 0x0010, 0x0020, 0x1101));
  return ((__ballot_sync(kFull, zero) >> l.base) & 3u) == 3u;
}

__device__ __forceinline__ int scalar_digit(const uint32_t* words, int w) {
  return (words[w >> 3] >> (4 * (w & 7))) & 15;
}

__device__ __forceinline__ void store_fe(int32_t* dst, const Fe& a) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) dst[i] = a.v[i];
}

// Where block 0's phases end, by clock64(), when the caller asks
// (`phase_clocks` not null): its start, and the ends of decompression, the
// tables and the gate (warp 0), of the window sums, of Horner's high half
// and of the block's accumulator (warp 1).
enum Phase { kStart, kDecoded, kTables, kGate, kWindowSums, kHornerHigh, kAccumulator, kPhases };

// Block b: points 8b .. 8b + 7.  Warp 0: decompression, tables, the gate;
// warps 1-3: window sums, then (warps 1 and 2) Horner over the windows.
__global__ void __launch_bounds__(kThreads, 1)
    decode_gate_msm_kernel(const uint32_t* __restrict__ encodings, const uint32_t* __restrict__ scalars,
                           int n, int32_t* __restrict__ decoded, int32_t* __restrict__ flags,
                           int32_t* __restrict__ partials, long long* __restrict__ phase_clocks) {
  __shared__ Fe table[kPointsPerBlock][16][kLanes];           // [0..15] P_g, cached
  __shared__ Fe leaves[kPointsPerBlock / 2][16][kLanes];      // the same of P_2h, extended
  __shared__ Fe window_sums[kWindows][kLanes];                // cached
  __shared__ uint32_t words[kPointsPerBlock][8];              // the block's scalars
  __shared__ Fe low_sum[kLanes];                              // Horner's low half, cached

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const Lane l{lane & 3, lane & ~3};
  const int g = lane >> 2;  // the group's point (warp 0) or window stride (warps 1-3)
  const int first = blockIdx.x * kPointsPerBlock;
  const int i = first + g;
  const bool timed = phase_clocks != nullptr && blockIdx.x == 0 && lane == 0;
  if (timed && warp == 0) phase_clocks[kStart] = clock64();
  if (threadIdx.x < kPointsPerBlock * 8) {
    const int pt = first + threadIdx.x / 8;
    words[threadIdx.x / 8][threadIdx.x % 8] = pt < n ? scalars[8 * pt + threadIdx.x % 8] : 0u;
  }
  bool decodes = false;
  if (warp == 0) {
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = i < n ? encodings[8 * i + j] : static_cast<uint32_t>(j == 0);
    const Decoded d = decompress(w);
    decodes = d.ok;
    if (timed) phase_clocks[kDecoded] = clock64();
    const Fe p = l.k == 0 ? d.x : (l.k == 1 ? d.y : (l.k == 2 ? fe_small(1) : d.t));
    if (i < n) store_fe(decoded + (kLanes * i + l.k) * kLimbs, p);
    const Fe pc = ge4_cached(p, l);
    const bool leaf = (g & 1) == 0;
    table[g][0][l.k] = ge4_cached_identity(l);
    table[g][1][l.k] = pc;
    if (leaf) {
      leaves[g >> 1][0][l.k] = ge4_identity(l);
      leaves[g >> 1][1][l.k] = p;
    }
    Fe acc = p;
#pragma unroll 1
    for (int j = 2; j < 16; ++j) {
      acc = ge4_add(acc, pc, l);
      table[g][j][l.k] = ge4_cached(acc, l);
      if (leaf) leaves[g >> 1][j][l.k] = acc;
    }
  }
  if (timed && warp == 0) phase_clocks[kTables] = clock64();
  __syncthreads();

  if (warp == 0) {  // the gate: [q] P_g
    Fe acc = ge4_identity(l);
#pragma unroll 1
    for (int w = kWindows - 1; w >= 0; --w) {
      if (w != kWindows - 1) {  // 16 times the identity is the identity
#pragma unroll 1
        for (int d = 0; d < 4; ++d) acc = ge4_double(acc, l);
      }
      const int digit = scalar_digit(kQWords, w);  // the same in every lane
      if (digit != 0) acc = ge4_add(acc, table[g][digit][l.k], l);  // 31 of q's 64 are 0
    }
    const bool gate = ge4_is_identity(acc, l);
    if (timed) phase_clocks[kGate] = clock64();
    if (l.k == 0 && i < n) flags[i] = (decodes ? 1 : 0) | (gate ? 2 : 0);
    return;
  }

  // Window sums: group m of warps 1-3 takes windows 63 - m, 63 - m - 24, ...
  // A tree over the block's points: ((P0 + P1) + (P2 + P3)) + ((P4 + P5) +
  // (P6 + P7)), each point's table row for its digit in window w.
  const int m = (warp - 1) * (32 / kLanes) + g;
#pragma unroll 1
  for (int r = 0; r < kSumRounds; ++r) {
    const int w = kWindows - 1 - m - kMsmGroups * r;
    const int wc = w < 0 ? 0 : w;  // a group with no window left computes one and drops it
    Fe s = ge4_add(leaves[0][scalar_digit(words[0], wc)][l.k], table[1][scalar_digit(words[1], wc)][l.k], l);
    Fe t = ge4_add(leaves[1][scalar_digit(words[2], wc)][l.k], table[3][scalar_digit(words[3], wc)][l.k], l);
    s = ge4_add(s, ge4_cached(t, l), l);
    t = ge4_add(leaves[2][scalar_digit(words[4], wc)][l.k], table[5][scalar_digit(words[5], wc)][l.k], l);
    const Fe u =
        ge4_add(leaves[3][scalar_digit(words[6], wc)][l.k], table[7][scalar_digit(words[7], wc)][l.k], l);
    t = ge4_add(t, ge4_cached(u, l), l);
    s = ge4_add(s, ge4_cached(t, l), l);
    const Fe sc = ge4_cached(s, l);
    if (w >= 0) window_sums[w][l.k] = sc;
  }
  asm volatile("bar.sync 1, %0;" ::"r"(32 * kMsmWarps) : "memory");  // warps 1-3 only
  if (warp == 3) return;
  if (timed && warp == 1) phase_clocks[kWindowSums] = clock64();

  // Horner over the windows in two halves, side by side: warp 2 the low
  // windows 31..0, warp 1 the high ones 63..32 and then 128 doublings
  // (x 16^32) and the low half's sum.  Every group of a warp alike; group 0
  // of warp 1 stores.
  const int top = warp == 1 ? kWindows - 1 : kWindows / 2 - 1;
  Fe acc = ge4_identity(l);
#pragma unroll 1
  for (int w = top; w > top - kWindows / 2; --w) {
    if (w != top) {
#pragma unroll 1
      for (int d = 0; d < 4; ++d) acc = ge4_double(acc, l);
    }
    acc = ge4_add(acc, window_sums[w][l.k], l);
  }
  if (warp == 2) {
    const Fe low = ge4_cached(acc, l);
    if (g == 0) low_sum[l.k] = low;
    __threadfence_block();
    asm volatile("bar.arrive 2, 64;" ::: "memory");  // low_sum is written
    return;
  }
#pragma unroll 1
  for (int d = 0; d < 2 * kWindows; ++d) acc = ge4_double(acc, l);
  if (timed) phase_clocks[kHornerHigh] = clock64();
  asm volatile("bar.sync 2, 64;" ::: "memory");  // warp 2's low_sum
  acc = ge4_add(acc, low_sum[l.k], l);
  if (g == 0) store_fe(partials + (kLanes * blockIdx.x + l.k) * kLimbs, acc);
  if (timed) phase_clocks[kAccumulator] = clock64();
}

// Sum of the blocks' accumulators and AND of the points' flags, in one
// block of 64 groups of four lanes: group g adds accumulators g, g + 64,
// ... (the identity past the last, so every lane of a warp runs every
// step), then a tree over the groups' sums in shared memory, cached.  A
// round's groups below `stride` read rows at or past it and write rows
// below it; a warp with no such group sits the round out.
__global__ void __launch_bounds__(kSumThreads)
    point_sum_kernel(const int32_t* __restrict__ partials, int blocks, const int32_t* __restrict__ flags,
                     int n, int32_t* __restrict__ result) {
  __shared__ Fe rows[kSumGroups][kLanes];
  const int lane = threadIdx.x & 31;
  const Lane l{lane & 3, lane & ~3};
  const int g = threadIdx.x / kLanes;
  const int warp_first = (threadIdx.x >> 5) * (32 / kLanes);  // the warp's first group
  Fe acc = ge4_identity(l);
#pragma unroll 1
  for (int b0 = 0; b0 < blocks; b0 += kSumGroups) {
    const int b = b0 + g;
    const Fe p = b < blocks ? fe_const(partials + (kLanes * b + l.k) * kLimbs) : ge4_identity(l);
    acc = ge4_add(acc, ge4_cached(p, l), l);
  }
  int ok = 1;
  for (int i = threadIdx.x; i < n; i += kSumThreads) ok &= flags[i] == kFlagsOk;
  rows[g][l.k] = ge4_cached(acc, l);
  ok = __syncthreads_and(ok);
#pragma unroll 1
  for (int stride = kSumGroups / 2; stride > 0; stride >>= 1) {
    if (warp_first < stride) {  // the same in every lane of the warp
      acc = ge4_add(acc, rows[g + stride][l.k], l);
      const Fe c = ge4_cached(acc, l);
      if (g < stride) rows[g][l.k] = c;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) result[0] = ok;
  if (g == 0) store_fe(result + 1 + l.k * kLimbs, acc);
}

}  // namespace

// Decode, gate and sum `n` points on `stream`.  `encodings`: device, n * 8
// uint32 (the 32-byte encodings); `scalars`: device, n * 8 uint32
// (little-endian words); outputs `decoded` (n * 40), `flags` (n), `partials`
// (blocks * 40) and `result` (41), all device int32.  Kernel (a) runs on
// `blocks` blocks of `threads` (= 128) threads, 8 points a block, which must
// cover the n points once; kernel (b) on one block.  Returns
// cudaErrorInvalidValue for a grid that does not, else the first
// cudaGetLastError() after a launch that is not 0.  `phase_clocks` is null,
// or a device array of 7 int64 that gets block 0's phase ends (`Phase`).
extern "C" int p1_ed25519_decode_gate_msm(const uint32_t* encodings, const uint32_t* scalars, int n,
                                          int blocks, int threads, int32_t* decoded, int32_t* flags,
                                          int32_t* partials, int32_t* result, long long* phase_clocks,
                                          void* stream) {
  const long long points = n;
  const bool covers = n > 0 && blocks > 0 && threads == kThreads &&
                      static_cast<long long>(blocks) * kPointsPerBlock >= points &&
                      static_cast<long long>(blocks - 1) * kPointsPerBlock < points;
  if (!covers) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  decode_gate_msm_kernel<<<blocks, threads, 0, s>>>(encodings, scalars, n, decoded, flags, partials,
                                                    phase_clocks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  point_sum_kernel<<<1, kSumThreads, 0, s>>>(partials, blocks, flags, n, result);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, local bytes per thread and static shared bytes per
// block of kernel (a) (which = 0) or kernel (b) (which = 1).
extern "C" int p1_ed25519_attrs(int which, int* num_regs, int* local_bytes, int* shared_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = which == 0 ? cudaFuncGetAttributes(&attr, decode_gate_msm_kernel)
                                     : cudaFuncGetAttributes(&attr, point_sum_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}
