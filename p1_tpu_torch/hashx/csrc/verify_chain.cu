// Header-chain verification for Hopper (sm_90a): PoW, declared difficulty
// and prev-hash linkage of N consecutive 80-byte headers in one launch.
//
// Replaces the XLA device program (not a Pallas kernel) that
// `p1_tpu/chain/replay.py:replay_device` runs:
// `p1_tpu/hashx/jax_sha256.py:verify_header_chain_segments`, a `lax.scan`
// over segments of `_verify_segment` and `sha256d_headers`.  Contract:
// header i (20 big-endian uint32 words) is invalid when its SHA-256d,
// read as a big-endian 256-bit integer, is not below the target (waived
// for header 0, the genesis), when its difficulty word (word 18) is not
// the chain's, or when its prev-hash words (1..8) are not the SHA-256d of
// header i-1 (zero for header 0).  The result is the smallest invalid i,
// or N, in one int32 device cell.  The segments of the reference exist to
// bound its per-dispatch work; they change no index, so there are none.
//
// What bounds it on this card.  A header costs three compressions (192
// rounds, ~3,700 integer-ALU instructions) against 80 bytes read, so over
// the whole card the bound is integer issue (64 ALU lanes per clock per
// SM), and at 2**20 headers, many waves of warps, the kernel runs close to
// it.  At the `replay` launch (10,000 headers: 313 warps for 528
// schedulers) it cannot: every warp carries a serial chain of 192 rounds
// on one scheduler, which issues an ALU instruction at most every second
// clock, so one warp takes >= 2 x 3,700 clocks (~3.8 us) against a
// card-wide bound of ~2.2 us.  The launch's start and end, the first
// loads' latency and the fetch of the kernel's code by every SM with a
// warp come on top.
//
// What the design does about it:
// - One thread per header, in blocks of 64 (cuda_verify.THREADS): 157
//   blocks at 10,000 headers, so every SM of an H100 gets a warp.
// - The compressions are `compress_rolled` (sha256_device.cuh): rounds
//   16..63 in a loop, half the code of the fully unrolled `compress`, so
//   each SM fetches less before its warp runs; as fast at 2**20.
// - No digest goes to device memory: thread i holds header i's digest and
//   itself checks header i+1's prev-hash words, loaded with its own words
//   (thread 0 also checks header 0's against zero).  Each header is read
//   as 16-byte loads.  A failure lowers the cell with atomicMin, so the
//   result is the same for every launch order.
// - Not kept (PERF.md): a warp-specialised form, a schedule warp feeding
//   K[t] + W[t] to a round warp through shared memory, was faster only
//   while the chain had at most two groups of 32 headers per SM, and
//   slower at 10,000; sums forced onto the FMA pipe were faster at 2**20
//   and slower at 10,000.

#include <cstdint>

#include <cuda_runtime.h>

#include "sha256_device.cuh"

namespace {

using p1::compress_rolled;
using p1::set_iv;

struct VerifyArgs {
  uint32_t target[8];
  uint32_t difficulty;
};

__global__ void verify_chain_kernel(const uint4* __restrict__ headers, const int n,
                                    const VerifyArgs args, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4* own = headers + 5 * static_cast<size_t>(i);
  uint32_t hw[20];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const uint4 v = own[q];
    hw[4 * q] = v.x; hw[4 * q + 1] = v.y; hw[4 * q + 2] = v.z; hw[4 * q + 3] = v.w;
  }
  const bool has_next = i + 1 < n;
  const uint4* next = has_next ? own + 5 : own;  // header i+1's prev-hash words
  const uint4 nx0 = next[0], nx1 = next[1], nx2 = next[2];

  uint32_t s[8], w[16];
  set_iv(s);
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = hw[k];
  compress_rolled(s, w);  // chunk 1: words 0..15
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = hw[16 + k];
  w[4] = 0x80000000u;
#pragma unroll
  for (int k = 5; k < 15; ++k) w[k] = 0;
  w[15] = 640;
  compress_rolled(s, w);  // chunk 2: words 16..19 + padding, bitlen 640
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = s[k];
  w[8] = 0x80000000u;
#pragma unroll
  for (int k = 9; k < 15; ++k) w[k] = 0;
  w[15] = 256;
  set_iv(s);
  compress_rolled(s, w);  // the second pass over the 32-byte digest

  // Unsigned big-endian compare of the digest words with the target.
  bool lt = false, eq = true;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    lt = lt || (eq && s[k] < args.target[k]);
    eq = eq && s[k] == args.target[k];
  }
  bool ok = (lt || i == 0) && hw[18] == args.difficulty;
  if (i == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) ok = ok && hw[1 + k] == 0;
  }
  if (!ok) atomicMin(out, i);

  if (has_next) {  // header i+1 must name this digest as its parent
    const bool linked = nx0.y == s[0] && nx0.z == s[1] && nx0.w == s[2] && nx1.x == s[3] &&
                        nx1.y == s[4] && nx1.z == s[5] && nx1.w == s[6] && nx2.x == s[7];
    if (!linked) atomicMin(out, i + 1);
  }
}

}  // namespace

// Verify `n` headers (`words`: device, n * 20 uint32, 16-byte aligned) on
// `stream`, one thread each, on `blocks` blocks of `threads`.  `words9`
// holds the target (8) and the difficulty word; `out` is a device int32
// cell the caller has set to `n`.  The caller guarantees 0 < n < 2**31.
// Returns cudaErrorInvalidValue for a grid that does not cover the n
// headers once, else cudaGetLastError() after the launch.
extern "C" int p1_verify_chain(const uint32_t* words, int n, const uint32_t* words9, int blocks,
                               int threads, int* out, void* stream) {
  const bool covers = blocks > 0 && threads > 0 &&
                      static_cast<long long>(blocks) * threads >= n &&
                      static_cast<long long>(blocks - 1) * threads < n;
  if (!covers) return static_cast<int>(cudaErrorInvalidValue);
  VerifyArgs args;
  for (int k = 0; k < 8; ++k) args.target[k] = words9[k];
  args.difficulty = words9[8];
  verify_chain_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(words), n, args, out);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and local (spill) bytes per thread of the kernel.
extern "C" int p1_verify_chain_attrs(int* num_regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, verify_chain_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}
