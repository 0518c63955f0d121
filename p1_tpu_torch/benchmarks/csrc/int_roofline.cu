// Integer-ALU roofline microbenchmark for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bench_kernel`
// (benchmarks/vpu_roofline.py:102, launched by `_make_bench`).  Contract,
// identical to the Pallas kernel: grid step g covers 2,048 lanes
// (lane = row * 128 + col of a (16, 128) tile).  Every lane runs `chains`
// independent uint32 (x, y) chains of op mix `mix` for `iters / 16 * 16`
// iterations, seeded from the seeds, the lane and g; the chains' x and y
// words are XOR-folded per lane, the fold is read as int32, the minimum
// over the step's lanes is taken, and the minima of all steps are XORed
// into one int32 cell.
//
// What bounds it on this card: integer issue, by construction.  It reads
// its seeds by value and writes 4 bytes per block, so the least time is the
// loop body's SASS instructions times the passes over it, divided by the
// rate of the pipes they issue to: 64 integer-ALU lanes per clock per SM
// for IADD3, LOP3 and SHF, 128 dispatch lanes per clock per SM for all of
// them (Hopper white paper).  Measuring that rate is the kernel's purpose.
//
// What the design does about it:
// - One block per grid step.  Blocks run in any order, and the result is a
//   block-level min followed by atomicXor into a cell the wrapper zeroes:
//   XOR is order-free, so the result is the same for every launch order.
// - Each thread carries 16 chain-lanes (`16 / CHAINS` lanes of `CHAINS`
//   chains, 128 * CHAINS threads): 32 words of state in registers whatever
//   the chain count, 16 independent dependency chains for latency hiding,
//   and `__launch_bounds__` so that even 1,024 threads fit without spills.
// - `mix` and `chains` are template parameters, so each instance is
//   straight-line code; the loop over `iters / 16` stays rolled
//   (`#pragma unroll 1`) around a body of 16 unrolled iterations, so its
//   SASS is the one loop that chip_smoke.py counts.
// - The reference notes ~500x inflation when chains folded or hoisted: here
//   every chain is recursive in (x, y), seeded per lane and per block, and
//   its result feeds the output, so none can fold, hoist or be dropped.
//   The loop's SASS count per iteration checks it.
// - Thread 0 of each block may record its block's SM cycles (clock64) and
//   nanoseconds (%globaltimer) in a probe buffer: the SM clock under load.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanesPerBlock = 16 * 128;
constexpr int kInner = 16;
constexpr int kChainLanes = 16;  // per thread

struct Seeds {
  uint32_t s[8];
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, uint32_t n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One iteration of mix MIX (0 add, 1 rot, 2 sha, 3 round), as the
// reference's `one`.
template <int MIX>
__device__ __forceinline__ void one(uint32_t& x, uint32_t& y) {
  if constexpr (MIX == 0) {
    x = x + y;
    y = y ^ x;
  } else if constexpr (MIX == 1) {
    x = rotr(x, 7) ^ rotr(y, 18);
    y = y + x;
  } else if constexpr (MIX == 2) {
    const uint32_t s = rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
    x = s ^ y;
    y = y + x;
  } else {
    const uint32_t s1 = rotr(x, 6) ^ rotr(x, 11) ^ rotr(x, 25);
    const uint32_t ch = (x & y) ^ (~x & (y + 1u));
    const uint32_t t1 = y + s1 + ch + 0x428A2F98u;
    const uint32_t s0 = rotr(t1, 2) ^ rotr(t1, 13) ^ rotr(t1, 22);
    x = t1 + s0;
    y = y ^ x;
  }
}

template <int MIX, int CHAINS>
__global__ void __launch_bounds__(128 * CHAINS)
    int_roofline_kernel(const Seeds seeds, const int outer, int* __restrict__ out,
                        unsigned long long* __restrict__ probe) {
  constexpr int kThreads = 128 * CHAINS;
  constexpr int kLanes = kChainLanes / CHAINS;  // lanes per thread
  static_assert(kThreads * kLanes == kLanesPerBlock, "a block covers one grid step");

  unsigned long long c0 = 0, t0 = 0;
  if (probe != nullptr && threadIdx.x == 0) {
    c0 = clock64();
    t0 = globaltimer();
  }
  const uint32_t gi = blockIdx.x;
  uint32_t x[kLanes][CHAINS], y[kLanes][CHAINS];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const uint32_t lane = threadIdx.x + l * kThreads;
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      x[l][j] = seeds.s[j] + lane + gi * 0x85EBCA6Bu;
      y[l][j] = (seeds.s[j] ^ 0x9E3779B9u) + (lane ^ gi) * 2654435761u;
    }
  }
#pragma unroll 1
  for (int k = 0; k < outer; ++k) {
#pragma unroll
    for (int u = 0; u < kInner; ++u) {
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
#pragma unroll
        for (int j = 0; j < CHAINS; ++j) one<MIX>(x[l][j], y[l][j]);
      }
    }
  }

  int m = INT_MAX;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) acc ^= x[l][j] ^ y[l][j];
    m = min(m, static_cast<int>(acc));
  }
  __shared__ int warp_min[kThreads / 32];
  m = __reduce_min_sync(0xFFFFFFFFu, m);
  const int warp = threadIdx.x / 32, lane_id = threadIdx.x % 32;
  if (lane_id == 0) warp_min[warp] = m;
  __syncthreads();
  if (warp == 0) {
    int v = lane_id < kThreads / 32 ? warp_min[lane_id] : INT_MAX;
    v = __reduce_min_sync(0xFFFFFFFFu, v);
    if (lane_id == 0) {
      atomicXor(out, v);
      if (probe != nullptr) {
        probe[2 * blockIdx.x] = clock64() - c0;
        probe[2 * blockIdx.x + 1] = globaltimer() - t0;
      }
    }
  }
}

using Kernel = void (*)(Seeds, int, int*, unsigned long long*);

template <int MIX>
Kernel pick_chains(int chains) {
  switch (chains) {
    case 1: return int_roofline_kernel<MIX, 1>;
    case 4: return int_roofline_kernel<MIX, 4>;
    case 8: return int_roofline_kernel<MIX, 8>;
    default: return nullptr;
  }
}

Kernel pick(int mix, int chains) {
  switch (mix) {
    case 0: return pick_chains<0>(chains);
    case 1: return pick_chains<1>(chains);
    case 2: return pick_chains<2>(chains);
    case 3: return pick_chains<3>(chains);
    default: return nullptr;
  }
}

}  // namespace

// Launch one run on `stream`: `grid` blocks, `outer` passes of the
// 16-iteration loop body.  `out` is a device int32 cell the caller has set
// to 0; `probe` is NULL or a device (grid, 2) u64 buffer.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// (mix, chains) with no instance.
extern "C" int p1_int_roofline(int mix, int chains, const uint32_t* seeds, int grid, int outer,
                               int* out, unsigned long long* probe, void* stream) {
  const Kernel kernel = pick(mix, chains);
  if (kernel == nullptr || grid < 1 || outer < 0) return static_cast<int>(cudaErrorInvalidValue);
  Seeds s = {};
  for (int j = 0; j < chains; ++j) s.s[j] = seeds[j];
  void* args[] = {&s, &outer, &out, &probe};
  cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(128 * chains), args, 0,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Registers and local (spill) bytes per thread, threads per block and
// resident blocks per SM of one instance.
extern "C" int p1_int_roofline_attrs(int mix, int chains, int* num_regs, int* local_bytes,
                                     int* threads, int* blocks_per_sm) {
  const Kernel kernel = pick(mix, chains);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *threads = 128 * chains;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reinterpret_cast<const void*>(kernel), 128 * chains, 0);
  return static_cast<int>(err);
}
