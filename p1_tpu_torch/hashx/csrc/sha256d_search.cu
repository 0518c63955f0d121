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
// - The 64 rounds of each compression are fully unrolled with K in
//   constant memory, and the 16-word window and 8-word state live in
//   registers, so the body is straight-line ALU work with no loads (build
//   with -Xptxas -v to see 0 bytes of local memory).
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

namespace {

struct SearchArgs {
  uint32_t mid[8];
  uint32_t tail[3];
  uint32_t target[8];
};

__constant__ uint32_t kK[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, uint32_t n) {
  return __funnelshift_r(x, x, n);
}

// One SHA-256 compression of the 16-word chunk `w` into `s`, with the
// message schedule extended in place in the 16-word window.
__device__ __forceinline__ void compress(uint32_t s[8], uint32_t w[16]) {
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      const uint32_t w1 = w[(i - 15) & 15], w14 = w[(i - 2) & 15];
      const uint32_t sig0 = rotr(w1, 7) ^ rotr(w1, 18) ^ (w1 >> 3);
      const uint32_t sig1 = rotr(w14, 17) ^ rotr(w14, 19) ^ (w14 >> 10);
      w[i & 15] += sig0 + w[(i - 7) & 15] + sig1;
    }
    const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + s1 + ch + kK[i] + w[i & 15];
    const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + s0 + maj;
  }
  s[0] += a; s[1] += b; s[2] += c; s[3] += d;
  s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}

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
    s[0] = 0x6A09E667u; s[1] = 0xBB67AE85u; s[2] = 0x3C6EF372u; s[3] = 0xA54FF53Au;
    s[4] = 0x510E527Fu; s[5] = 0x9B05688Cu; s[6] = 0x1F83D9ABu; s[7] = 0x5BE0CD19u;
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
