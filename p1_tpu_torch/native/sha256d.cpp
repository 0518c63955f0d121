// Native SHA-256d core for the port's "native" hash backend.
//
// The port's copy of p1_tpu/native/sha256d.cpp, code unchanged: the JAX
// package's engine is the reference this one is held against.  It is the
// host-side tier between the hashlib loop (Python-call-bound) and the
// card's kernels: a single C call scans a whole nonce range with the
// midstate trick, using the x86 SHA-NI extension when the CPU has it and
// a portable scalar compression otherwise.
//
// Exposed C ABI (ctypes-friendly; see p1_tpu_torch/hashx/native_backend.py):
//   p1_sha256d(data, len, out32)           - one double-SHA-256
//   p1_search(prefix76, start, count, d)   - earliest nonce with >= d
//                                            leading zero bits, or -1
//   p1_has_shani()                         - which compression runs
//   p1_verify_chain / _retarget            - first invalid header of a
//                                            packed chain, or -1
//
// The header layout contract matches p1_tpu_torch/core/header.py: 80-byte
// big-endian header, nonce in bytes 76..80; the search holds bytes 0..76
// fixed (one compression of bytes 0..64 is hoisted out of the loop).

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#include <cpuid.h>
#define P1_X86 1
#else
#define P1_X86 0
#endif

namespace {

constexpr uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

constexpr uint32_t IV[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                            0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }
inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}
inline void put_be32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v >> 24);
  p[1] = uint8_t(v >> 16);
  p[2] = uint8_t(v >> 8);
  p[3] = uint8_t(v);
}

// ---------------------------------------------------------------- scalar --

void compress_scalar(uint32_t state[8], const uint8_t block[64]) {
  uint32_t w[64];
  for (int i = 0; i < 16; ++i) w[i] = be32(block + 4 * i);
  for (int i = 16; i < 64; ++i) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
  for (int i = 0; i < 64; ++i) {
    uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + s1 + ch + K[i] + w[i];
    uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = s0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  state[0] += a; state[1] += b; state[2] += c; state[3] += d;
  state[4] += e; state[5] += f; state[6] += g; state[7] += h;
}

// ---------------------------------------------------------------- SHA-NI --

#if P1_X86
// Standard two-lane SHA-NI schedule (state held as ABEF/CDGH vectors);
// compiled with a target attribute so the .so builds and loads on any
// x86-64 and the choice happens at runtime via __builtin_cpu_supports.
__attribute__((target("sha,sse4.1")))
void compress_shani(uint32_t state[8], const uint8_t block[64]) {
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);

  __m128i TMP = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&state[0]));
  __m128i STATE1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&state[4]));
  TMP = _mm_shuffle_epi32(TMP, 0xB1);        // CDAB
  STATE1 = _mm_shuffle_epi32(STATE1, 0x1B);  // EFGH
  __m128i STATE0 = _mm_alignr_epi8(TMP, STATE1, 8);  // ABEF
  STATE1 = _mm_blend_epi16(STATE1, TMP, 0xF0);       // CDGH

  const __m128i ABEF_SAVE = STATE0;
  const __m128i CDGH_SAVE = STATE1;
  __m128i MSG, MSG0, MSG1, MSG2, MSG3;

#define P1_QROUND(Ki_lo, Ki_hi, M)                                   \
  do {                                                               \
    MSG = _mm_add_epi32(                                             \
        M, _mm_set_epi64x((long long)(Ki_hi), (long long)(Ki_lo)));  \
    STATE1 = _mm_sha256rnds2_epu32(STATE1, STATE0, MSG);             \
    MSG = _mm_shuffle_epi32(MSG, 0x0E);                              \
    STATE0 = _mm_sha256rnds2_epu32(STATE0, STATE1, MSG);             \
  } while (0)

  // Rounds 0-15: raw message words; start msg1 pre-passes as groups land.
  MSG0 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(block + 0)), MASK);
  P1_QROUND(0x71374491428a2f98ULL, 0xe9b5dba5b5c0fbcfULL, MSG0);
  MSG1 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(block + 16)), MASK);
  P1_QROUND(0x59f111f13956c25bULL, 0xab1c5ed5923f82a4ULL, MSG1);
  MSG0 = _mm_sha256msg1_epu32(MSG0, MSG1);
  MSG2 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(block + 32)), MASK);
  P1_QROUND(0x12835b01d807aa98ULL, 0x550c7dc3243185beULL, MSG2);
  MSG1 = _mm_sha256msg1_epu32(MSG1, MSG2);
  MSG3 = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(block + 48)), MASK);
  P1_QROUND(0x80deb1fe72be5d74ULL, 0xc19bf1749bdc06a7ULL, MSG3);

  // Schedule step: Mnext (already msg1-combined with its successor two
  // steps ago) gains w[i-7..i-4] = alignr(newest, second_newest) and the
  // msg2 sigma-1 chain; second_newest then takes ITS msg1 pre-pass.  The
  // alignr must read second_newest RAW, so msg1 comes last.
#define P1_SCHED(Mnext, Mprev2, Mprev1)                              \
  do {                                                               \
    TMP = _mm_alignr_epi8(Mprev1, Mprev2, 4);                        \
    Mnext = _mm_add_epi32(Mnext, TMP);                               \
    Mnext = _mm_sha256msg2_epu32(Mnext, Mprev1);                     \
    Mprev2 = _mm_sha256msg1_epu32(Mprev2, Mprev1);                   \
  } while (0)

  // Rounds 16-63: 12 schedule+round pairs with cyclically rotating roles.
  P1_SCHED(MSG0, MSG2, MSG3);
  P1_QROUND(0xefbe4786e49b69c1ULL, 0x240ca1cc0fc19dc6ULL, MSG0);
  P1_SCHED(MSG1, MSG3, MSG0);
  P1_QROUND(0x4a7484aa2de92c6fULL, 0x76f988da5cb0a9dcULL, MSG1);
  P1_SCHED(MSG2, MSG0, MSG1);
  P1_QROUND(0xa831c66d983e5152ULL, 0xbf597fc7b00327c8ULL, MSG2);
  P1_SCHED(MSG3, MSG1, MSG2);
  P1_QROUND(0xd5a79147c6e00bf3ULL, 0x1429296706ca6351ULL, MSG3);
  P1_SCHED(MSG0, MSG2, MSG3);
  P1_QROUND(0x2e1b213827b70a85ULL, 0x53380d134d2c6dfcULL, MSG0);
  P1_SCHED(MSG1, MSG3, MSG0);
  P1_QROUND(0x766a0abb650a7354ULL, 0x92722c8581c2c92eULL, MSG1);
  P1_SCHED(MSG2, MSG0, MSG1);
  P1_QROUND(0xa81a664ba2bfe8a1ULL, 0xc76c51a3c24b8b70ULL, MSG2);
  P1_SCHED(MSG3, MSG1, MSG2);
  P1_QROUND(0xd6990624d192e819ULL, 0x106aa070f40e3585ULL, MSG3);
  P1_SCHED(MSG0, MSG2, MSG3);
  P1_QROUND(0x1e376c0819a4c116ULL, 0x34b0bcb52748774cULL, MSG0);
  P1_SCHED(MSG1, MSG3, MSG0);
  P1_QROUND(0x4ed8aa4a391c0cb3ULL, 0x682e6ff35b9cca4fULL, MSG1);
  P1_SCHED(MSG2, MSG0, MSG1);
  P1_QROUND(0x78a5636f748f82eeULL, 0x8cc7020884c87814ULL, MSG2);
  P1_SCHED(MSG3, MSG1, MSG2);
  P1_QROUND(0xa4506ceb90befffaULL, 0xc67178f2bef9a3f7ULL, MSG3);

#undef P1_SCHED
#undef P1_QROUND

  STATE0 = _mm_add_epi32(STATE0, ABEF_SAVE);
  STATE1 = _mm_add_epi32(STATE1, CDGH_SAVE);

  TMP = _mm_shuffle_epi32(STATE0, 0x1B);        // FEBA
  STATE1 = _mm_shuffle_epi32(STATE1, 0xB1);     // DCHG
  STATE0 = _mm_blend_epi16(TMP, STATE1, 0xF0);  // DCBA
  STATE1 = _mm_alignr_epi8(STATE1, TMP, 8);     // HGFE... -> EFGH order below

  _mm_storeu_si128(reinterpret_cast<__m128i*>(&state[0]), STATE0);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&state[4]), STATE1);
}
// Two-lane interleaved SHA-NI compression: two independent (state, block)
// pairs advanced in lockstep.  The single-lane routine is LATENCY-bound —
// each sha256rnds2 depends on the previous one, so the ~4-6 cycle
// instruction latency gates throughput while issue slots idle.  Header
// digests in a chain verify are mutually independent, so interleaving two
// of them fills those slots and nearly doubles verified headers/s
// (measured in benchmarks/host_ingest.py; parity-fuzzed against the
// hashlib oracle like every other engine path).  The K constants load
// once per quad-round and feed both lanes.
__attribute__((target("sha,sse4.1")))
void compress_shani2(uint32_t sa[8], const uint8_t* ba, uint32_t sb[8],
                     const uint8_t* bb) {
  const __m128i MASK =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);

  __m128i TMPa = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&sa[0]));
  __m128i S1a = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&sa[4]));
  TMPa = _mm_shuffle_epi32(TMPa, 0xB1);
  S1a = _mm_shuffle_epi32(S1a, 0x1B);
  __m128i S0a = _mm_alignr_epi8(TMPa, S1a, 8);
  S1a = _mm_blend_epi16(S1a, TMPa, 0xF0);
  __m128i TMPb = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&sb[0]));
  __m128i S1b = _mm_loadu_si128(reinterpret_cast<const __m128i*>(&sb[4]));
  TMPb = _mm_shuffle_epi32(TMPb, 0xB1);
  S1b = _mm_shuffle_epi32(S1b, 0x1B);
  __m128i S0b = _mm_alignr_epi8(TMPb, S1b, 8);
  S1b = _mm_blend_epi16(S1b, TMPb, 0xF0);

  const __m128i ABEF_SAVEa = S0a, CDGH_SAVEa = S1a;
  const __m128i ABEF_SAVEb = S0b, CDGH_SAVEb = S1b;
  __m128i MSGa, MSGb;
  __m128i M0a, M1a, M2a, M3a, M0b, M1b, M2b, M3b;

#define P1_QROUND2(Ki_lo, Ki_hi, Ma, Mb)                             \
  do {                                                               \
    const __m128i KV =                                               \
        _mm_set_epi64x((long long)(Ki_hi), (long long)(Ki_lo));      \
    MSGa = _mm_add_epi32(Ma, KV);                                    \
    MSGb = _mm_add_epi32(Mb, KV);                                    \
    S1a = _mm_sha256rnds2_epu32(S1a, S0a, MSGa);                     \
    S1b = _mm_sha256rnds2_epu32(S1b, S0b, MSGb);                     \
    MSGa = _mm_shuffle_epi32(MSGa, 0x0E);                            \
    MSGb = _mm_shuffle_epi32(MSGb, 0x0E);                            \
    S0a = _mm_sha256rnds2_epu32(S0a, S1a, MSGa);                     \
    S0b = _mm_sha256rnds2_epu32(S0b, S1b, MSGb);                     \
  } while (0)

  M0a = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(ba + 0)), MASK);
  M0b = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(bb + 0)), MASK);
  P1_QROUND2(0x71374491428a2f98ULL, 0xe9b5dba5b5c0fbcfULL, M0a, M0b);
  M1a = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(ba + 16)), MASK);
  M1b = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(bb + 16)), MASK);
  P1_QROUND2(0x59f111f13956c25bULL, 0xab1c5ed5923f82a4ULL, M1a, M1b);
  M0a = _mm_sha256msg1_epu32(M0a, M1a);
  M0b = _mm_sha256msg1_epu32(M0b, M1b);
  M2a = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(ba + 32)), MASK);
  M2b = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(bb + 32)), MASK);
  P1_QROUND2(0x12835b01d807aa98ULL, 0x550c7dc3243185beULL, M2a, M2b);
  M1a = _mm_sha256msg1_epu32(M1a, M2a);
  M1b = _mm_sha256msg1_epu32(M1b, M2b);
  M3a = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(ba + 48)), MASK);
  M3b = _mm_shuffle_epi8(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(bb + 48)), MASK);
  P1_QROUND2(0x80deb1fe72be5d74ULL, 0xc19bf1749bdc06a7ULL, M3a, M3b);

#define P1_SCHED2(Mnext_a, Mprev2_a, Mprev1_a, Mnext_b, Mprev2_b, Mprev1_b) \
  do {                                                               \
    TMPa = _mm_alignr_epi8(Mprev1_a, Mprev2_a, 4);                   \
    Mnext_a = _mm_add_epi32(Mnext_a, TMPa);                          \
    Mnext_a = _mm_sha256msg2_epu32(Mnext_a, Mprev1_a);               \
    Mprev2_a = _mm_sha256msg1_epu32(Mprev2_a, Mprev1_a);             \
    TMPb = _mm_alignr_epi8(Mprev1_b, Mprev2_b, 4);                   \
    Mnext_b = _mm_add_epi32(Mnext_b, TMPb);                          \
    Mnext_b = _mm_sha256msg2_epu32(Mnext_b, Mprev1_b);               \
    Mprev2_b = _mm_sha256msg1_epu32(Mprev2_b, Mprev1_b);             \
  } while (0)

  P1_SCHED2(M0a, M2a, M3a, M0b, M2b, M3b);
  P1_QROUND2(0xefbe4786e49b69c1ULL, 0x240ca1cc0fc19dc6ULL, M0a, M0b);
  P1_SCHED2(M1a, M3a, M0a, M1b, M3b, M0b);
  P1_QROUND2(0x4a7484aa2de92c6fULL, 0x76f988da5cb0a9dcULL, M1a, M1b);
  P1_SCHED2(M2a, M0a, M1a, M2b, M0b, M1b);
  P1_QROUND2(0xa831c66d983e5152ULL, 0xbf597fc7b00327c8ULL, M2a, M2b);
  P1_SCHED2(M3a, M1a, M2a, M3b, M1b, M2b);
  P1_QROUND2(0xd5a79147c6e00bf3ULL, 0x1429296706ca6351ULL, M3a, M3b);
  P1_SCHED2(M0a, M2a, M3a, M0b, M2b, M3b);
  P1_QROUND2(0x2e1b213827b70a85ULL, 0x53380d134d2c6dfcULL, M0a, M0b);
  P1_SCHED2(M1a, M3a, M0a, M1b, M3b, M0b);
  P1_QROUND2(0x766a0abb650a7354ULL, 0x92722c8581c2c92eULL, M1a, M1b);
  P1_SCHED2(M2a, M0a, M1a, M2b, M0b, M1b);
  P1_QROUND2(0xa81a664ba2bfe8a1ULL, 0xc76c51a3c24b8b70ULL, M2a, M2b);
  P1_SCHED2(M3a, M1a, M2a, M3b, M1b, M2b);
  P1_QROUND2(0xd6990624d192e819ULL, 0x106aa070f40e3585ULL, M3a, M3b);
  P1_SCHED2(M0a, M2a, M3a, M0b, M2b, M3b);
  P1_QROUND2(0x1e376c0819a4c116ULL, 0x34b0bcb52748774cULL, M0a, M0b);
  P1_SCHED2(M1a, M3a, M0a, M1b, M3b, M0b);
  P1_QROUND2(0x4ed8aa4a391c0cb3ULL, 0x682e6ff35b9cca4fULL, M1a, M1b);
  P1_SCHED2(M2a, M0a, M1a, M2b, M0b, M1b);
  P1_QROUND2(0x78a5636f748f82eeULL, 0x8cc7020884c87814ULL, M2a, M2b);
  P1_SCHED2(M3a, M1a, M2a, M3b, M1b, M2b);
  P1_QROUND2(0xa4506ceb90befffaULL, 0xc67178f2bef9a3f7ULL, M3a, M3b);

#undef P1_SCHED2
#undef P1_QROUND2

  S0a = _mm_add_epi32(S0a, ABEF_SAVEa);
  S1a = _mm_add_epi32(S1a, CDGH_SAVEa);
  TMPa = _mm_shuffle_epi32(S0a, 0x1B);
  S1a = _mm_shuffle_epi32(S1a, 0xB1);
  S0a = _mm_blend_epi16(TMPa, S1a, 0xF0);
  S1a = _mm_alignr_epi8(S1a, TMPa, 8);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&sa[0]), S0a);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&sa[4]), S1a);

  S0b = _mm_add_epi32(S0b, ABEF_SAVEb);
  S1b = _mm_add_epi32(S1b, CDGH_SAVEb);
  TMPb = _mm_shuffle_epi32(S0b, 0x1B);
  S1b = _mm_shuffle_epi32(S1b, 0xB1);
  S0b = _mm_blend_epi16(TMPb, S1b, 0xF0);
  S1b = _mm_alignr_epi8(S1b, TMPb, 8);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&sb[0]), S0b);
  _mm_storeu_si128(reinterpret_cast<__m128i*>(&sb[4]), S1b);
}
#endif  // P1_X86

using CompressFn = void (*)(uint32_t[8], const uint8_t[64]);
using Compress2Fn = void (*)(uint32_t[8], const uint8_t*, uint32_t[8],
                             const uint8_t*);

CompressFn pick_compress() {
#if P1_X86
  // Raw CPUID rather than __builtin_cpu_supports("sha"): GCC (through at
  // least 13) rejects "sha" as a feature name — it is a clang extension —
  // and the builtin is not worth losing buildability on half the
  // toolchains.  SHA extensions: CPUID.(EAX=7,ECX=0):EBX bit 29;
  // SSE4.1: CPUID.1:ECX bit 19.
  unsigned eax, ebx, ecx, edx;
  bool sse41 = __get_cpuid(1, &eax, &ebx, &ecx, &edx) && (ecx & (1u << 19));
  bool sha = __get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx) &&
             (ebx & (1u << 29));
  if (sha && sse41) return compress_shani;
#endif
  return compress_scalar;
}

CompressFn g_compress = pick_compress();

// Fallback two-lane form: two sequential single-lane compressions.  Used
// when SHA-NI is absent (the scalar routine's plain C already gives the
// compiler freedom to overlap iterations) or forced off for tests.
void compress2_seq(uint32_t sa[8], const uint8_t* ba, uint32_t sb[8],
                   const uint8_t* bb) {
  g_compress(sa, ba);
  g_compress(sb, bb);
}

Compress2Fn pick_compress2() {
#if P1_X86
  if (g_compress == compress_shani) return compress_shani2;
#endif
  return compress2_seq;
}

Compress2Fn g_compress2 = pick_compress2();

// --------------------------------------------------------------- helpers --

// One-shot SHA-256 of an arbitrary message.
void sha256(const uint8_t* data, uint64_t len, uint8_t out[32]) {
  uint32_t st[8];
  std::memcpy(st, IV, sizeof(st));
  uint64_t full = len / 64;
  for (uint64_t i = 0; i < full; ++i) g_compress(st, data + 64 * i);
  uint8_t block[64];
  uint64_t rem = len - 64 * full;
  std::memcpy(block, data + 64 * full, rem);
  block[rem] = 0x80;
  std::memset(block + rem + 1, 0, 64 - rem - 1);
  if (rem + 1 > 56) {  // length field doesn't fit: one more block
    g_compress(st, block);
    std::memset(block, 0, 64);
  }
  uint64_t bits = len * 8;
  for (int i = 0; i < 8; ++i) block[56 + i] = uint8_t(bits >> (8 * (7 - i)));
  g_compress(st, block);
  for (int i = 0; i < 8; ++i) put_be32(out + 4 * i, st[i]);
}

// >= difficulty leading zero bits?  (digest < 2^(256-d), header.py:97-120)
inline bool leading_zero_bits_ge(const uint32_t digest_words[8], uint32_t d) {
  uint32_t full = d / 32, rem = d % 32;
  for (uint32_t i = 0; i < full; ++i)
    if (digest_words[i] != 0) return false;
  if (rem == 0) return true;
  return full < 8 && (digest_words[full] >> (32 - rem)) == 0;
}

// Same check over a big-endian 32-byte digest (the tiled verifiers keep
// digests in wire order so linkage is a flat memcmp).
inline bool leading_zero_bits_ge_bytes(const uint8_t digest[32], uint32_t d) {
  uint32_t full = d / 32, rem = d % 32;
  for (uint32_t i = 0; i < full; ++i)
    if (be32(digest + 4 * i) != 0) return false;
  if (rem == 0) return true;
  return full < 8 && (be32(digest + 4 * full) >> (32 - rem)) == 0;
}

}  // namespace

// ------------------------------------------------------------------- ABI --

extern "C" {

int p1_has_shani() {
#if P1_X86
  return g_compress != compress_scalar;
#else
  return 0;
#endif
}

// Test hook: force the portable scalar compression (enable=1) or restore
// the runtime-dispatched best path (enable=0), so the fallback is testable
// on SHA-NI hardware.
void p1_force_scalar(int enable) {
  g_compress = enable ? compress_scalar : pick_compress();
  g_compress2 = pick_compress2();  // keep the two-lane dispatch in step
}

void p1_sha256d(const uint8_t* data, uint64_t len, uint8_t out[32]) {
  uint8_t first[32];
  sha256(data, len, first);
  sha256(first, 32, out);
}

// The three-compression SHA-256d of one 80-byte header, with the
// padding templates owned by a small reusable state so the two chain
// verifiers below cannot drift apart on the byte layout.
struct HeaderHasher {
  // 80-byte message templates: chunk 2 = bytes 64..80 + pad + bitlen
  // 640; second pass = 32-byte digest + pad + bitlen 256.
  uint8_t block2[64];
  uint8_t block3[64];
  HeaderHasher() {
    std::memset(block2, 0, sizeof(block2));
    block2[16] = 0x80;
    block2[62] = 0x02;
    block2[63] = 0x80;
    std::memset(block3, 0, sizeof(block3));
    block3[32] = 0x80;
    block3[62] = 0x01;
    block3[63] = 0x00;
  }
  void digest(const uint8_t* h, uint32_t st2[8]) {
    uint32_t st[8];
    std::memcpy(st, IV, sizeof(st));
    g_compress(st, h);
    std::memcpy(block2, h + 64, 16);
    g_compress(st, block2);
    for (int j = 0; j < 8; ++j) put_be32(block3 + 4 * j, st[j]);
    std::memcpy(st2, IV, 8 * sizeof(uint32_t));
    g_compress(st2, block3);
  }
};

// Two-lane form of HeaderHasher: digests two independent headers in
// lockstep through g_compress2 (interleaved SHA-NI when available), with
// per-lane padding templates.  Big-endian byte output so the verifiers
// can memcmp digests against prev_hash fields directly.
struct HeaderHasher2 {
  uint8_t block2a[64], block2b[64], block3a[64], block3b[64];
  HeaderHasher2() {
    for (uint8_t* b2 : {block2a, block2b}) {
      std::memset(b2, 0, 64);
      b2[16] = 0x80;
      b2[62] = 0x02;
      b2[63] = 0x80;
    }
    for (uint8_t* b3 : {block3a, block3b}) {
      std::memset(b3, 0, 64);
      b3[32] = 0x80;
      b3[62] = 0x01;
      b3[63] = 0x00;
    }
  }
  void digest2(const uint8_t* ha, const uint8_t* hb, uint8_t outa[32],
               uint8_t outb[32]) {
    uint32_t sa[8], sb[8];
    std::memcpy(sa, IV, sizeof(sa));
    std::memcpy(sb, IV, sizeof(sb));
    g_compress2(sa, ha, sb, hb);
    std::memcpy(block2a, ha + 64, 16);
    std::memcpy(block2b, hb + 64, 16);
    g_compress2(sa, block2a, sb, block2b);
    for (int j = 0; j < 8; ++j) {
      put_be32(block3a + 4 * j, sa[j]);
      put_be32(block3b + 4 * j, sb[j]);
    }
    std::memcpy(sa, IV, sizeof(sa));
    std::memcpy(sb, IV, sizeof(sb));
    g_compress2(sa, block3a, sb, block3b);
    for (int j = 0; j < 8; ++j) {
      put_be32(outa + 4 * j, sa[j]);
      put_be32(outb + 4 * j, sb[j]);
    }
  }
};

// Digest one tile of headers into `out` (32 B/header, big-endian),
// pairwise through the two-lane hasher.  The tile shape keeps the
// verifiers' early-exit granularity (a hostile prefix costs at most one
// tile of extra hashing), bounds scratch to a constant, and keeps the
// just-computed digests L1-warm for the check pass that follows.
constexpr uint64_t VERIFY_TILE = 512;

void digest_tile(const uint8_t* headers, uint64_t count, uint8_t* out) {
  HeaderHasher2 h2;
  uint64_t i = 0;
  for (; i + 2 <= count; i += 2)
    h2.digest2(headers + 80 * i, headers + 80 * (i + 1), out + 32 * i,
               out + 32 * (i + 1));
  if (i < count) {
    HeaderHasher h1;
    uint32_t st2[8];
    h1.digest(headers + 80 * i, st2);
    for (int j = 0; j < 8; ++j) put_be32(out + 32 * i + 4 * j, st2[j]);
  }
}

// Verify a header chain laid out as n contiguous 80-byte headers
// (layout: version[0..4) prev_hash[4..36) merkle[36..68) timestamp[68..72)
// difficulty[72..76) nonce[76..80), all big-endian — core/header.py's
// _PACK).  Per header: SHA-256d meets >= `difficulty` leading zero bits
// (header 0 exempt when genesis_exempt — it anchors by identity), the
// difficulty field equals `difficulty`, and prev_hash equals the previous
// header's digest (header 0 links to 32 zero bytes).  Exactly
// chain/replay.py::replay_host's rules — this is its native engine
// (benchmark config 3).  Structured as digest-tile-then-check so the
// independent per-header hashes run two-lane (compress_shani2) while the
// serial linkage walk stays a flat memcmp over the tile's digests.
// Returns the first invalid index, or -1.
long long p1_verify_chain(const uint8_t* headers, uint64_t n,
                          uint32_t difficulty, int genesis_exempt) {
  uint8_t dig[VERIFY_TILE * 32];
  uint8_t prev[32];
  std::memset(prev, 0, sizeof(prev));
  for (uint64_t base = 0; base < n; base += VERIFY_TILE) {
    const uint64_t count = (n - base < VERIFY_TILE) ? (n - base) : VERIFY_TILE;
    digest_tile(headers + 80 * base, count, dig);
    for (uint64_t k = 0; k < count; ++k) {
      const uint64_t i = base + k;
      const uint8_t* h = headers + 80 * i;
      const uint8_t* d = dig + 32 * k;
      bool pow_ok = (genesis_exempt && i == 0) ||
                    leading_zero_bits_ge_bytes(d, difficulty);
      bool diff_ok = be32(h + 72) == difficulty;
      bool link_ok = std::memcmp(h + 4, prev, 32) == 0;
      if (!(pow_ok && diff_ok && link_ok)) return (long long)i;
      std::memcpy(prev, d, 32);
    }
  }
  return -1;
}

// RetargetRule.adjusted (core/retarget.py), bit-for-bit: one bit harder
// per halving of the expected span, one easier per doubling, clamped to
// max_adjust and 1..255.  Integer-only, exactly the Python rule.
static uint32_t rt_adjusted(uint32_t parent_d, long long span,
                            uint32_t window, uint32_t spacing,
                            uint32_t max_adjust) {
  const long long expected = (long long)spacing * (long long)(window - 1);
  if (span < 1) span = 1;
  int adj = 0;
  while (adj < (int)max_adjust && span * (2LL << adj) <= expected) adj++;
  if (adj == 0) {
    while (adj > -(int)max_adjust && span >= (2LL << (-adj)) * expected)
      adj--;
  }
  long long nd = (long long)parent_d + adj;
  if (nd < 1) nd = 1;
  if (nd > 255) nd = 255;
  return (uint32_t)nd;
}

// Retargeting variant of p1_verify_chain: same layout, but the required
// difficulty is the CONTEXTUAL schedule (a pure function of the ancestor
// headers — chain/chain.py), and the timestamp rules apply: strictly
// increasing, with the forward-dating cap of max_step*spacing seconds per
// block from height 2 on (height 1 is the bootstrap clock anchor —
// core/retarget.py).  Header 0 is the genesis record: validated by
// identity upstream (the Python caller checks the genesis hash), so PoW
// is waived and its difficulty field seeds the schedule.  Mirrors
// chain/replay.py::replay_host(retarget=...) rule-for-rule — the parity
// tests corrupt chains at boundaries and compare first-invalid indices.
// Returns the first invalid index, or -1.
long long p1_verify_chain_retarget(const uint8_t* headers, uint64_t n,
                                   uint32_t window, uint32_t spacing,
                                   uint32_t max_adjust, uint32_t max_step) {
  if (window < 2 || spacing < 1) return 0;
  // Ring of the last `window` timestamps: at a boundary i the span is
  // ts[i-1] - ts[i-window], and slot i % window still holds ts[i-window].
  std::vector<uint32_t> ring((size_t)window, 0);
  uint8_t dig[VERIFY_TILE * 32];
  uint8_t prev[32];
  std::memset(prev, 0, sizeof(prev));
  uint32_t prev_ts = 0, prev_d = 0;
  for (uint64_t i = 0; i < n; ++i) {
    const uint64_t k = i % VERIFY_TILE;
    if (k == 0) {
      const uint64_t count =
          (n - i < VERIFY_TILE) ? (n - i) : VERIFY_TILE;
      digest_tile(headers + 80 * i, count, dig);  // two-lane, see above
    }
    const uint8_t* h = headers + 80 * i;
    const uint8_t* d32 = dig + 32 * k;

    const uint32_t ts = be32(h + 68);
    const uint32_t d = be32(h + 72);
    uint32_t expected;
    if (i == 0) {
      expected = d;  // genesis seeds the schedule (identity-checked)
    } else if (i % window != 0) {
      expected = prev_d;
    } else {
      const long long span =
          (long long)prev_ts - (long long)ring[i % window];
      expected = rt_adjusted(prev_d, span, window, spacing, max_adjust);
    }
    const bool pow_ok =
        (i == 0) || leading_zero_bits_ge_bytes(d32, expected);
    const bool diff_ok = d == expected;
    const bool link_ok = std::memcmp(h + 4, prev, 32) == 0;
    const bool ts_ok =
        (i == 0) ||
        ((long long)ts > (long long)prev_ts &&
         (i == 1 || (long long)ts - (long long)prev_ts <=
                        (long long)max_step * (long long)spacing));
    if (!(pow_ok && diff_ok && link_ok && ts_ok)) return (long long)i;
    ring[i % window] = ts;
    prev_ts = ts;
    prev_d = d;
    std::memcpy(prev, d32, 32);
  }
  return -1;
}

// Earliest nonce in [nonce_start, nonce_start+count) whose header SHA-256d
// has >= difficulty leading zero bits, or -1.  prefix is the fixed 76-byte
// header head; the first 64 bytes compress once (midstate).
long long p1_search(const uint8_t prefix[76], uint32_t nonce_start,
                    uint64_t count, uint32_t difficulty) {
  uint32_t midstate[8];
  std::memcpy(midstate, IV, sizeof(midstate));
  g_compress(midstate, prefix);

  // Chunk 2 template: prefix bytes 64..76, nonce at 12..16, pad, bitlen 640.
  uint8_t block2[64];
  std::memset(block2, 0, sizeof(block2));
  std::memcpy(block2, prefix + 64, 12);
  block2[16] = 0x80;
  block2[62] = 0x02;  // 640 = 0x0280 big-endian in bytes 56..64
  block2[63] = 0x80;

  // Second-pass template: 32-byte digest, pad, bitlen 256.
  uint8_t block3[64];
  std::memset(block3, 0, sizeof(block3));
  block3[32] = 0x80;
  block3[62] = 0x01;  // 256 = 0x0100
  block3[63] = 0x00;

  const uint64_t end = uint64_t(nonce_start) + count;
  for (uint64_t nonce = nonce_start; nonce < end; ++nonce) {
    put_be32(block2 + 12, uint32_t(nonce));
    uint32_t st[8];
    std::memcpy(st, midstate, sizeof(st));
    g_compress(st, block2);
    for (int i = 0; i < 8; ++i) put_be32(block3 + 4 * i, st[i]);
    uint32_t st2[8];
    std::memcpy(st2, IV, sizeof(st2));
    g_compress(st2, block3);
    if (leading_zero_bits_ge(st2, difficulty)) return (long long)nonce;
  }
  return -1;
}

}  // extern "C"
