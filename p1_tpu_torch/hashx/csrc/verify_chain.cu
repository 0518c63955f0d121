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
// What bounds it on this card: integer issue.  A header costs three
// compressions (chunk 1, chunk 2, the second pass: 192 rounds) against 80
// bytes read, so at the card's 3.35 TB/s the bytes take a few percent of
// the time the instructions take at 64 integer-ALU lanes per clock per SM.
// chip_smoke.py computes the bound from the SASS of this kernel.
//
// What the design does about it:
// - One thread per header; the compressions are those of
//   sha256d_search.cu (sha256_device.cuh): rounds fully unrolled, K in
//   constant memory, window and state in registers, straight-line ALU work.
// - No digest goes to device memory and there is no second pass: thread i
//   holds header i's digest and itself checks header i+1's prev-hash words
//   against it (thread 0 also checks header 0's against zero).  A failure
//   lowers the cell with atomicMin, so the result is the same for every
//   launch order.
// - The header words arrive as the host packed them (big-endian words, as
//   `headers_to_words` reads the serialized bytes), read once as five
//   16-byte loads per thread.

#include <cstdint>

#include <cuda_runtime.h>

#include "sha256_device.cuh"

namespace {

using p1::compress;
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

  uint32_t s[8], w[16];
  set_iv(s);
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = hw[k];
  compress(s, w);  // chunk 1: words 0..15
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = hw[16 + k];
  w[4] = 0x80000000u;
#pragma unroll
  for (int k = 5; k < 15; ++k) w[k] = 0;
  w[15] = 640;
  compress(s, w);  // chunk 2: words 16..19 + padding, bitlen 640
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = s[k];
  w[8] = 0x80000000u;
#pragma unroll
  for (int k = 9; k < 15; ++k) w[k] = 0;
  w[15] = 256;
  set_iv(s);
  compress(s, w);  // the second pass over the 32-byte digest

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

  if (i + 1 < n) {  // header i+1 must name this digest as its parent
    const uint4* next = own + 5;
    const uint4 p0 = next[0], p1 = next[1], p2 = next[2];
    const bool linked = p0.y == s[0] && p0.z == s[1] && p0.w == s[2] && p1.x == s[3] &&
                        p1.y == s[4] && p1.z == s[5] && p1.w == s[6] && p2.x == s[7];
    if (!linked) atomicMin(out, i + 1);
  }
}

}  // namespace

// Verify `n` headers (`words`: device, n * 20 uint32, 16-byte aligned) on
// `stream`.  `words9` holds the target (8) and the difficulty word; `out`
// is a device int32 cell the caller has set to `n`.  The caller
// guarantees 0 < n < 2**31.  Returns cudaGetLastError() after the launch.
extern "C" int p1_verify_chain(const uint32_t* words, int n, const uint32_t* words9,
                               int threads, int* out, void* stream) {
  VerifyArgs args;
  for (int k = 0; k < 8; ++k) args.target[k] = words9[k];
  args.difficulty = words9[8];
  const int blocks = static_cast<int>((static_cast<long long>(n) + threads - 1) / threads);
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
