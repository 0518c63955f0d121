// SHA-256d nonce search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_search_kernel`
// (p1_tpu/hashx/pallas_backend.py:67, launched by `pallas_search_fn`).
// Contract, identical to the Pallas step: for every flat offset f in
// [0, batch) the nonce is `nonce_base + f` (uint32 wrap); the header's
// SHA-256d is chunk 2 compressed from the 8-word midstate, then the second
// pass over the 32-byte digest; the result is the smallest f whose digest,
// read as a big-endian 256-bit integer, is below the target, or `batch` on
// a miss, as an int32 in one device cell.
//
// What bounds it on this card: integer issue.  A nonce costs two
// compressions (128 rounds, 96 schedule words) and moves no bytes: the
// inputs arrive as kernel arguments by value and the output is 4 bytes per
// step.  So the least time is the instructions per nonce (read from
// `cuobjdump -sass` of this kernel) divided by the card's integer issue
// rate, which for these ops (IADD3, LOP3, SHF) is 64 lanes per clock per
// SM on Hopper; chip_smoke.py computes that bound from the SASS it built.
//
// What the design does about it:
// - The 64 rounds of each compression (sha256_device.cuh) are fully
//   unrolled with K in constant memory, and the 16-word window and 8-word
//   state live in registers, so the body is straight-line ALU work with no
//   loads (build with -Xptxas -v to see 0 bytes of local memory).
// - Rotations are `__funnelshift_r` (one SHF each), the three-input XORs
//   and Ch/Maj fold into LOP3, sums into IADD3; the 16 schedule words of
//   rounds 48..63, which feed nothing, are never computed, and the
//   compiler folds the constant padding words of both chunks.
// - Rounds 0..2 of chunk 2 depend only on the arguments, so they are
//   invariant in each thread's loop over its rows, free for the compiler
//   to hoist.  A hand-written precomputation of them is later work.
//
// The grid is not sequential here.  On the TPU grid steps run in order, so
// a step may skip its tile once any hit is recorded.  Blocks on the card
// run in any order, so a thread skips a row of nonces only when the
// recorded minimum is already below that row's first flat offset: no nonce
// it skips could lower the minimum, and the result is the same for every
// launch order.  The cell is read with a volatile load, never a cached one.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "sha256_device.cuh"

namespace {

using p1::compress;
using p1::set_iv;

struct SearchArgs {
  uint32_t mid[8];
  uint32_t tail[3];
  uint32_t target[8];
};

// Each block covers `sub` rows of `blockDim.x` consecutive flat offsets;
// thread t of row r hashes offset block_first + r * blockDim.x + t.
__global__ void sha256d_search_kernel(const SearchArgs args, const uint32_t nonce_base,
                                      const int sub, int* __restrict__ out) {
  const volatile int* cell = out;
  const uint32_t block_first = blockIdx.x * blockDim.x * static_cast<uint32_t>(sub);
#pragma unroll 1
  for (int r = 0; r < sub; ++r) {
    const uint32_t row_first = block_first + static_cast<uint32_t>(r) * blockDim.x;
    // Skip only when the recorded minimum precedes this row: every offset
    // left to this thread is >= row_first, so none of them could win.
    if (*cell < static_cast<int>(row_first)) return;
    const uint32_t flat = row_first + threadIdx.x;

    uint32_t s[8];
    uint32_t w[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = args.mid[k];
    // Pass 1, chunk 2: tail words + nonce + pad(0x80) + bitlen 640.
    w[0] = args.tail[0];
    w[1] = args.tail[1];
    w[2] = args.tail[2];
    w[3] = nonce_base + flat;  // uint32 wrap, as the reference's lanes
    w[4] = 0x80000000u;
#pragma unroll
    for (int k = 5; k < 15; ++k) w[k] = 0;
    w[15] = 640;
    compress(s, w);

    // Pass 2 over the 32-byte digest (bitlen 256).
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = s[k];
    w[8] = 0x80000000u;
#pragma unroll
    for (int k = 9; k < 15; ++k) w[k] = 0;
    w[15] = 256;
    set_iv(s);
    compress(s, w);

    // Unsigned big-endian compare of the digest words with the target.
    bool lt = false, eq = true;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      lt = lt || (eq && s[k] < args.target[k]);
      eq = eq && s[k] == args.target[k];
    }
    if (lt) {
      atomicMin(out, static_cast<int>(flat));
      return;  // this thread's later offsets are all larger
    }
  }
}

}  // namespace

// Launch one search step on `stream`.  `words` holds midstate (8), tail (3)
// and target (8); `out` is a device int32 cell the caller has set to
// `batch`.  The caller guarantees batch % (sub * threads) == 0 and
// batch < 2**31.  Returns cudaGetLastError() after the launch.
extern "C" int p1_sha256d_search(const uint32_t* words, uint32_t nonce_base, int batch,
                                 int sub, int threads, int* out, void* stream) {
  SearchArgs args;
  std::memcpy(args.mid, words, sizeof(args.mid));
  std::memcpy(args.tail, words + 8, sizeof(args.tail));
  std::memcpy(args.target, words + 11, sizeof(args.target));
  const int blocks = batch / (sub * threads);
  sha256d_search_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      args, nonce_base, sub, out);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and local (spill) bytes per thread of the kernel.
extern "C" int p1_sha256d_search_attrs(int* num_regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, sha256d_search_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *num_regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}
