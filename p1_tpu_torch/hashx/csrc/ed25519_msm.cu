// Ed25519 batch verification for Hopper (sm_90a): the subgroup gate on every
// point and the multi-scalar multiplication sum_i s_i * P_i, in two kernels.
//
// Replaces the XLA device program (not a Pallas kernel) of
// `p1_tpu/hashx/ed25519_msm.py:_jit_gate_msm` (`:361`, body `program`
// `:383`): `_gate_all` (`:318`, [q]P == identity for every point) and
// `_msm_tree` (`:336`, a windowed MSM), on the point formulas `ge_add`
// (`:258`) and `ge_double` (`:276`).  Contract: for N points (extended
// coordinates X, Y, Z, T) and N scalars, `result` = [all points pass the
// gate, X, Y, Z, T of sum_i s_i * P_i]; per point, `flags[i]` is the gate
// verdict and `products[i]` is s_i * P_i.  The host (hashx/ed25519_msm.py)
// prepares the points and scalars and closes the equation.
//
// Field elements: ten signed limbs of 26, 25, 26, ... bits (ref10's radix),
// int32 at rest, products and column sums in int64.  The plain PyTorch
// version (`ed25519_msm.plain_gate_msm`) uses the same radix, the same
// two parallel carries and the same operation order, so the two agree limb
// for limb.  fe_add and fe_sub do not carry; the point formulas feed
// fe_mul at most four carried values summed (|limb| <= 2^27), so a column
// sum stays under 2^61 and every operand of a product fits int32.
//
// What bounds it on this card: integer instructions.  A point costs two
// windowed scalar multiplications (the gate by q and its own scalar), each
// 14 + 64 point additions and 256 doublings, ~2,750 field multiplications
// of 55 (a square) to 100 IMAD.WIDE products plus their 64-bit carries;
// its 192 input bytes are nothing beside that.  The SASS counts ~790,000
// instructions a thread, a little more of them on the integer-ALU pipe
// (carries, 64-bit adds) than on the FMA pipe (the products), so the ALU
// pipe sets the bound.  At a batch of 1,024 signatures (1,032 points) the
// launch has 2,064 threads, 65 warps for the card's 528 schedulers: far
// from enough to hide the latency of the dependent chains, so the kernel
// is latency-bound (PERF.md).
//
// What the design does about it (the simple, correct first design):
// - Kernel (a), `gate_smul_kernel`: one thread per (point, role), two
//   threads per point in neighbouring lanes.  Each builds its point's
//   16-entry window table [0..15]P in local memory (2,560 bytes; the
//   JAX package's `_point_table`), then runs 64 windows of four doublings
//   and one table add, most significant first: role 0 over q's digits
//   (the gate: writes whether [q]P is the identity), role 1 over its own
//   scalar's (writes s_i * P_i).  Blocks of one warp, so the warps
//   spread over as many SMs as there are warps (up to 132).
// - Kernel (b), `point_sum_kernel`: one block of 256 threads; each sums a
//   stride of the products, then a tree in shared memory (40 KB) leaves
//   one point, and `__syncthreads_and` reduces the gate flags to one.
// - One read-back of 41 int32 (the flag and the point); the host adds
//   [q - sum z_i s_i] B and tests for the identity.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLimbs = 10;
constexpr int kGateThreads = 32;  // threads per block of kernel (a)
constexpr int kSumThreads = 256;  // the one block of kernel (b)

// 2d mod p in the radix, and q in little-endian 32-bit words.
__constant__ int32_t kD2[kLimbs] = {45281625, 27714825, 36363642, 13898781, 229458,
                                    15978800, 54557047, 27058993, 29715967, 9444199};
__device__ const uint32_t kQWords[8] = {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,
                                        0u,          0u,          0u,          0x10000000u};

struct Fe {
  int32_t v[kLimbs];
};

struct Ge {
  Fe x, y, z, t;
};

__device__ __forceinline__ constexpr int limb_bits(int i) { return (i & 1) ? 25 : 26; }

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

// Columns 0..18 -> ten limbs (column k + 10 folds into k times 19), carried
// twice.
__device__ __forceinline__ Fe fe_reduce(const int64_t col[2 * kLimbs - 1]) {
  int64_t h[kLimbs];
#pragma unroll
  for (int k = 0; k < kLimbs - 1; ++k) h[k] = col[k] + 19 * col[k + kLimbs];
  h[kLimbs - 1] = col[kLimbs - 1];
  carry_pass(h);
  carry_pass(h);
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
    for (int j = 0; j < kLimbs; ++j) {
      col[i + j] += static_cast<int64_t>((j & 1) ? f2[i] : f.v[i]) * g.v[j];
    }
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
    col[2 * i] += static_cast<int64_t>((i & 1) ? f2[i] : f.v[i]) * f.v[i];
#pragma unroll
    for (int j = i + 1; j < kLimbs; ++j) {
      col[i + j] += static_cast<int64_t>(f2[i]) * (((i & j) & 1) ? f2[j] : f.v[j]);
    }
  }
  return fe_reduce(col);
}

__device__ __forceinline__ Fe fe_mul_d2(const Fe& f) {
  Fe d2;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) d2.v[i] = kD2[i];
  return fe_mul(f, d2);
}

// True iff the element is 0 mod p: two carries, then ref10's fe_tobytes
// reduction to the canonical value (q = floor(h / p) from a carry chain).
__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
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
  int64_t any = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) any |= h[i];
  return any == 0;
}

__device__ __forceinline__ Ge ge_identity() {
  Ge r = {};
  r.y.v[0] = 1;
  r.z.v[0] = 1;
  return r;
}

// The extended-coordinate formulas of core/_ed25519.py (_pt_add, _pt_double).
__device__ __forceinline__ Ge ge_add(const Ge& p, const Ge& q) {
  const Fe aa = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  const Fe bb = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  const Fe cc = fe_mul_d2(fe_mul(p.t, q.t));
  const Fe zz = fe_mul(p.z, q.z);
  const Fe dd = fe_add(zz, zz);
  const Fe e = fe_sub(bb, aa);
  const Fe f = fe_sub(dd, cc);
  const Fe g = fe_add(dd, cc);
  const Fe h = fe_add(bb, aa);
  return Ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

__device__ __forceinline__ Ge ge_double(const Ge& p) {
  const Fe aa = fe_sq(p.x);
  const Fe bb = fe_sq(p.y);
  const Fe zz = fe_sq(p.z);
  const Fe ss = fe_sq(fe_add(p.x, p.y));
  const Fe cc = fe_add(zz, zz);
  const Fe h = fe_add(aa, bb);
  const Fe e = fe_sub(h, ss);
  const Fe g = fe_sub(aa, bb);
  const Fe f = fe_add(cc, g);
  return Ge{fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

__device__ __forceinline__ Ge load_ge(const int32_t* src) {
  Ge r;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    r.x.v[i] = src[i];
    r.y.v[i] = src[kLimbs + i];
    r.z.v[i] = src[2 * kLimbs + i];
    r.t.v[i] = src[3 * kLimbs + i];
  }
  return r;
}

__device__ __forceinline__ void store_ge(int32_t* dst, const Ge& p) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    dst[i] = p.x.v[i];
    dst[kLimbs + i] = p.y.v[i];
    dst[2 * kLimbs + i] = p.z.v[i];
    dst[3 * kLimbs + i] = p.t.v[i];
  }
}

// Thread t: point t / 2; role t % 2 (0: the gate, [q]P; 1: s_i * P_i).
__global__ void __launch_bounds__(kGateThreads)
    gate_smul_kernel(const int32_t* __restrict__ points, const uint32_t* __restrict__ scalars,
                     int n, int32_t* __restrict__ products, int32_t* __restrict__ flags) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * n) return;
  const int i = t >> 1;
  const bool gate = (t & 1) == 0;
  const Ge p = load_ge(points + 4 * kLimbs * i);
  const uint32_t* words = gate ? kQWords : scalars + 8 * i;

  Ge table[16];  // [0..15] P: local memory, indexed by the digits
  table[0] = ge_identity();
  table[1] = p;
  Ge prev = p;
#pragma unroll 1
  for (int k = 2; k < 16; ++k) {
    prev = ge_add(prev, p);
    table[k] = prev;
  }

  Ge acc = ge_identity();
#pragma unroll 1
  for (int w = 63; w >= 0; --w) {  // 4-bit windows, most significant first
#pragma unroll 1
    for (int d = 0; d < 4; ++d) acc = ge_double(acc);
    const int digit = (words[w >> 3] >> (4 * (w & 7))) & 15;
    acc = ge_add(acc, table[digit]);
  }

  if (gate) {
    flags[i] = fe_is_zero(acc.x) && fe_is_zero(fe_sub(acc.y, acc.z));
  } else {
    store_ge(products + 4 * kLimbs * i, acc);
  }
}

// Sum of the n products and AND of the n gate flags, in one block.
__global__ void __launch_bounds__(kSumThreads)
    point_sum_kernel(const int32_t* __restrict__ products, const int32_t* __restrict__ flags,
                     int n, int32_t* __restrict__ result) {
  __shared__ Ge partial[kSumThreads];
  const int k = threadIdx.x;
  Ge acc = ge_identity();
  int ok = 1;
  for (int i = k; i < n; i += kSumThreads) {
    acc = ge_add(acc, load_ge(products + 4 * kLimbs * i));
    ok &= flags[i];
  }
  partial[k] = acc;
  ok = __syncthreads_and(ok);
#pragma unroll 1
  for (int stride = kSumThreads / 2; stride > 0; stride >>= 1) {
    if (k < stride) partial[k] = ge_add(partial[k], partial[k + stride]);
    __syncthreads();
  }
  if (k == 0) {
    result[0] = ok;
    store_ge(result + 1, partial[0]);
  }
}

}  // namespace

// Gate and sum `n` points on `stream`.  `points`: device, n * 40 int32
// (X, Y, Z, T limbs); `scalars`: device, n * 8 uint32 (little-endian
// words); outputs `products` (n * 40), `flags` (n) and `result` (41), all
// device int32.  Kernel (a) runs on `blocks` blocks of `threads` (<= 32)
// threads, which must cover the 2n (point, role) threads once; kernel (b)
// on one block.  Returns cudaErrorInvalidValue for a grid that does not,
// else the first cudaGetLastError() after a launch that is not 0.
extern "C" int p1_ed25519_gate_msm(const int32_t* points, const uint32_t* scalars, int n,
                                   int blocks, int threads, int32_t* products, int32_t* flags,
                                   int32_t* result, void* stream) {
  const long long work = 2LL * n;
  const bool covers = n > 0 && blocks > 0 && threads > 0 && threads <= kGateThreads &&
                      static_cast<long long>(blocks) * threads >= work &&
                      static_cast<long long>(blocks - 1) * threads < work;
  if (!covers) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  gate_smul_kernel<<<blocks, threads, 0, s>>>(points, scalars, n, products, flags);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  point_sum_kernel<<<1, kSumThreads, 0, s>>>(products, flags, n, result);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and local bytes per thread of kernel (a) (which = 0)
// or kernel (b) (which = 1).
extern "C" int p1_ed25519_attrs(int which, int* num_regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = which == 0 ? cudaFuncGetAttributes(&attr, gate_smul_kernel)
                                     : cudaFuncGetAttributes(&attr, point_sum_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}
