// SHA-256 compression on the card, shared by the port's hash kernels
// (sha256d_search.cu: `compress`; verify_chain.cu: `compress_rolled`).
// FIPS 180-4; all word arithmetic is mod 2**32.  In `compress` the 64
// rounds unroll fully with K in constant memory and
// the 16-word window and 8-word state in registers: straight-line
// integer-ALU work (SHF for each rotation, LOP3 for the three-input XORs
// and Ch/Maj, IADD3 for the sums).  kernel_build hashes this header with
// each source, so an edit rebuilds both; a function that a source does not
// call emits no code into it.

#pragma once

#include <cstdint>

namespace p1 {

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

__device__ __forceinline__ void set_iv(uint32_t s[8]) {
  s[0] = 0x6A09E667u; s[1] = 0xBB67AE85u; s[2] = 0x3C6EF372u; s[3] = 0xA54FF53Au;
  s[4] = 0x510E527Fu; s[5] = 0x9B05688Cu; s[6] = 0x1F83D9ABu; s[7] = 0x5BE0CD19u;
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

// `compress` with rounds 16..63 in a loop of three 16-round passes: about
// half the code.  Where a launch puts one warp on each of many SMs, every
// SM fetches the kernel's code anew, and the fully unrolled form's fetch
// shows in the time (verify_chain.cu; PERF.md).
__device__ __forceinline__ void compress_rolled(uint32_t s[8], uint32_t w[16]) {
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
  auto round = [&](const uint32_t k, const uint32_t wi) {
    const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + s1 + ch + k + wi;
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
  };
#pragma unroll
  for (int i = 0; i < 16; ++i) round(kK[i], w[i]);
#pragma unroll 1
  for (int r = 16; r < 64; r += 16) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t w1 = w[(j + 1) & 15], w14 = w[(j + 14) & 15];
      const uint32_t sig0 = rotr(w1, 7) ^ rotr(w1, 18) ^ (w1 >> 3);
      const uint32_t sig1 = rotr(w14, 17) ^ rotr(w14, 19) ^ (w14 >> 10);
      w[j] += sig0 + w[(j + 9) & 15] + sig1;
      round(kK[r + j], w[j]);
    }
  }
  s[0] += a; s[1] += b; s[2] += c; s[3] += d;
  s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}

}  // namespace p1
