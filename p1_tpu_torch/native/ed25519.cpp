// Native Ed25519 verifier — the crypto-engine half of the port's native
// core; the port's copy of p1_tpu/native/ed25519.cpp, code unchanged.
//
// Scope and division of labor: this file is the FIELD/GROUP engine only.
// Everything that is already C-speed in CPython stays in the Python seam
// (p1_tpu_torch/core/_ed25519_native.py): SHA-512 (hashlib), the mod-q scalar
// bignum work (CPython long arithmetic), length/canonicality checks, and
// the per-batch random coefficients (secrets).  What crosses the ctypes
// boundary is pure curve arithmetic, the part pure Python is slowest at:
//
//   p1_ed25519_verify(pub, R, s, k)  - ONE cofactorless serial check
//                                      [s]B == R + [k]A, decompress rules
//                                      bit-identical to core/_ed25519.py
//   p1_ed25519_batch(...)            - subgroup-gate every A (deduped by
//                                      the caller) and every R exactly
//                                      ([q]·P == identity), then evaluate
//                                      the random-linear-combination MSM
//                                      by Pippenger's bucket method
//   p1_ed25519_in_subgroup(enc)      - the exact gate alone (test hook)
//   p1_ed25519_impl()                - which arithmetic runs (telemetry)
//
// The SEMANTICS contract is core/_ed25519.py's, restated: batch
// acceptance must imply serial (cofactorless) acceptance of every
// triple, which requires the EXACT prime-subgroup gate [q]·P == identity
// on every point — no probabilistic shortcut exists (the torsion group
// is Z/8, far too small for random-linear-combination soundness).  The
// serial entry point is deliberately UNGATED and reduces k mod q before
// multiplying, exactly like the Python serial path, so torsion-crafted
// signatures the serial equation tolerates get the same ACCEPT here —
// one validity rule on every node, whichever backend it runs
// (tests/test_torch_native_ed25519.py pins parity input-for-input).
//
// Arithmetic: radix-2^51 field elements (5 × uint64 limbs) with
// unsigned __int128 products — portable to any 64-bit target, no
// CPUID dispatch needed (unlike the SHA-NI half of this library the
// hot loop is multiply-bound, which every target's compiler already
// schedules well).  Formulas are the extended-coordinate add/double of
// core/_ed25519.py translated limb-wise, so parity testing against the
// Python oracle covers every path.

#include <cstdint>
#include <cstring>
#include <vector>

#if !defined(__SIZEOF_INT128__)
#error "p1 native ed25519 requires a 64-bit target with __int128"
#endif

namespace {

typedef unsigned __int128 u128;

// ------------------------------------------------------------ fe25519 --
// Limbs < 2^52 when "reduced"; add/sub outputs may grow to < 2^55 and
// feed straight into mul/sq (products stay far below 2^127) — the point
// formulas below never chain more than two additive ops into a product.

struct fe {
  uint64_t v[5];
};

constexpr uint64_t MASK51 = (uint64_t(1) << 51) - 1;

inline fe fe_zero() { return {{0, 0, 0, 0, 0}}; }
inline fe fe_one() { return {{1, 0, 0, 0, 0}}; }

inline uint64_t load64(const uint8_t* p) {
  uint64_t r;
  std::memcpy(&r, p, 8);
  return r;  // little-endian hosts only (x86-64/aarch64)
}

inline void store64(uint8_t* p, uint64_t v) { std::memcpy(p, &v, 8); }

// 32 LE bytes (top bit ignored by the caller's masking) -> 5 limbs.
inline fe fe_frombytes(const uint8_t s[32]) {
  fe r;
  r.v[0] = load64(s) & MASK51;
  r.v[1] = (load64(s + 6) >> 3) & MASK51;
  r.v[2] = (load64(s + 12) >> 6) & MASK51;
  r.v[3] = (load64(s + 19) >> 1) & MASK51;
  r.v[4] = (load64(s + 24) >> 12) & MASK51;
  return r;
}

inline void fe_carry(fe& a) {
  for (int pass = 0; pass < 2; ++pass) {
    uint64_t c;
    for (int i = 0; i < 4; ++i) {
      c = a.v[i] >> 51;
      a.v[i] &= MASK51;
      a.v[i + 1] += c;
    }
    c = a.v[4] >> 51;
    a.v[4] &= MASK51;
    a.v[0] += 19 * c;
  }
}

// Every fe in the system keeps limbs < 2^52 (fe_mul's carry chain
// guarantees it for products; add/sub re-carry below) — two dozen
// shift/mask ops per op buys freedom from magnitude bookkeeping across
// the point formulas, and the cost is noise next to the 25-product
// multiplications that dominate.

inline fe fe_add(const fe& a, const fe& b) {
  fe r;
  for (int i = 0; i < 5; ++i) r.v[i] = a.v[i] + b.v[i];
  fe_carry(r);
  return r;
}

// a - b without underflow: add 4p (limb-shaped, > any reduced limb)
// first.  Inputs < 2^52 by the invariant above; output re-carried.
inline fe fe_sub(const fe& a, const fe& b) {
  static const uint64_t P4[5] = {
      (MASK51 + 1 - 19) << 2, MASK51 << 2, MASK51 << 2, MASK51 << 2,
      MASK51 << 2};
  fe r;
  for (int i = 0; i < 5; ++i) r.v[i] = a.v[i] + P4[i] - b.v[i];
  fe_carry(r);
  return r;
}

inline fe fe_mul(const fe& a, const fe& b) {
  const uint64_t a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3],
                 a4 = a.v[4];
  const uint64_t b0 = b.v[0], b1 = b.v[1], b2 = b.v[2], b3 = b.v[3],
                 b4 = b.v[4];
  const uint64_t b1_19 = b1 * 19, b2_19 = b2 * 19, b3_19 = b3 * 19,
                 b4_19 = b4 * 19;
  u128 t0 = (u128)a0 * b0 + (u128)a1 * b4_19 + (u128)a2 * b3_19 +
            (u128)a3 * b2_19 + (u128)a4 * b1_19;
  u128 t1 = (u128)a0 * b1 + (u128)a1 * b0 + (u128)a2 * b4_19 +
            (u128)a3 * b3_19 + (u128)a4 * b2_19;
  u128 t2 = (u128)a0 * b2 + (u128)a1 * b1 + (u128)a2 * b0 +
            (u128)a3 * b4_19 + (u128)a4 * b3_19;
  u128 t3 = (u128)a0 * b3 + (u128)a1 * b2 + (u128)a2 * b1 +
            (u128)a3 * b0 + (u128)a4 * b4_19;
  u128 t4 = (u128)a0 * b4 + (u128)a1 * b3 + (u128)a2 * b2 +
            (u128)a3 * b1 + (u128)a4 * b0;
  fe r;
  uint64_t c;
  r.v[0] = (uint64_t)t0 & MASK51;
  t1 += (uint64_t)(t0 >> 51);
  r.v[1] = (uint64_t)t1 & MASK51;
  t2 += (uint64_t)(t1 >> 51);
  r.v[2] = (uint64_t)t2 & MASK51;
  t3 += (uint64_t)(t2 >> 51);
  r.v[3] = (uint64_t)t3 & MASK51;
  t4 += (uint64_t)(t3 >> 51);
  r.v[4] = (uint64_t)t4 & MASK51;
  c = (uint64_t)(t4 >> 51);
  r.v[0] += 19 * c;
  c = r.v[0] >> 51;
  r.v[0] &= MASK51;
  r.v[1] += c;
  return r;
}

inline fe fe_sq(const fe& a) { return fe_mul(a, a); }

// Fully reduce to the canonical 32-byte little-endian representative.
inline void fe_tobytes(uint8_t out[32], const fe& a) {
  fe t = a;
  fe_carry(t);
  fe_carry(t);
  // t < 2^255 + small now; one more conditional wrap for t4 overflow
  uint64_t c = t.v[4] >> 51;
  t.v[4] &= MASK51;
  t.v[0] += 19 * c;
  for (int i = 0; i < 4; ++i) {
    c = t.v[i] >> 51;
    t.v[i] &= MASK51;
    t.v[i + 1] += c;
  }
  // conditional subtract p: q = 1 iff t >= p  (t + 19 carries past 2^255)
  uint64_t q = (t.v[0] + 19) >> 51;
  q = (t.v[1] + q) >> 51;
  q = (t.v[2] + q) >> 51;
  q = (t.v[3] + q) >> 51;
  q = (t.v[4] + q) >> 51;
  t.v[0] += 19 * q;
  for (int i = 0; i < 4; ++i) {
    c = t.v[i] >> 51;
    t.v[i] &= MASK51;
    t.v[i + 1] += c;
  }
  t.v[4] &= MASK51;
  uint8_t buf[40] = {0};
  store64(buf + 0, t.v[0] | (t.v[1] << 51));
  store64(buf + 8, (t.v[1] >> 13) | (t.v[2] << 38));
  store64(buf + 16, (t.v[2] >> 26) | (t.v[3] << 25));
  store64(buf + 24, (t.v[3] >> 39) | (t.v[4] << 12));
  std::memcpy(out, buf, 32);
}

inline bool fe_eq(const fe& a, const fe& b) {
  uint8_t ba[32], bb[32];
  fe_tobytes(ba, a);
  fe_tobytes(bb, b);
  return std::memcmp(ba, bb, 32) == 0;
}

inline bool fe_is_zero(const fe& a) {
  uint8_t b[32];
  fe_tobytes(b, a);
  for (int i = 0; i < 32; ++i)
    if (b[i]) return false;
  return true;
}

// Generic square-and-multiply over a 255-bit little-endian exponent —
// used a handful of times per signature (decompression) and at init,
// where a hand-tuned addition chain would buy microseconds.
fe fe_pow(const fe& base, const uint8_t exp[32]) {
  fe r = fe_one();
  bool started = false;
  for (int byte = 31; byte >= 0; --byte) {
    for (int bit = 7; bit >= 0; --bit) {
      if (started) r = fe_sq(r);
      if ((exp[byte] >> bit) & 1) {
        if (started)
          r = fe_mul(r, base);
        else {
          r = base;
          started = true;
        }
      }
    }
  }
  return started ? r : fe_one();
}

// ---------------------------------------------------------- ge25519 ----
// Extended homogeneous coordinates (X, Y, Z, T), XY = ZT — the exact
// formulas of core/_ed25519.py::_pt_add/_pt_double, limb-wise.

struct ge {
  fe x, y, z, t;
};

struct Consts {
  fe d;        // edwards d = -121665/121666
  fe d2;       // 2d (hoisted out of every addition)
  fe sqrt_m1;  // sqrt(-1), for decompression
  ge B;        // base point
  uint8_t exp_pm5d8[32];  // (p-5)/8
};

inline ge ge_identity() { return {fe_zero(), fe_one(), fe_one(), fe_zero()}; }

const Consts& consts();  // fwd

inline ge ge_add(const ge& p, const ge& q) {
  fe aa = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  fe bb = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  fe cc = fe_mul(fe_mul(p.t, q.t), consts().d2);
  fe zz = fe_mul(p.z, q.z);
  fe dd = fe_add(zz, zz);
  fe e = fe_sub(bb, aa);
  fe f = fe_sub(dd, cc);
  fe g = fe_add(dd, cc);
  fe h = fe_add(bb, aa);
  return {fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

inline ge ge_double(const ge& p) {
  fe aa = fe_sq(p.x);
  fe bb = fe_sq(p.y);
  fe zz = fe_sq(p.z);
  fe cc = fe_add(zz, zz);
  fe h = fe_add(aa, bb);
  fe xy = fe_add(p.x, p.y);
  fe e = fe_sub(h, fe_sq(xy));
  fe g = fe_sub(aa, bb);
  fe f = fe_add(cc, g);
  return {fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)};
}

// Projective equality by cross-multiplication (no inversions) —
// core/_ed25519.py::_pt_equal.
inline bool ge_eq(const ge& a, const ge& b) {
  return fe_eq(fe_mul(a.x, b.z), fe_mul(b.x, a.z)) &&
         fe_eq(fe_mul(a.y, b.z), fe_mul(b.y, a.z));
}

inline bool ge_is_identity(const ge& a) {
  return fe_is_zero(a.x) && fe_eq(a.y, a.z);
}

// 4-bit fixed-window scalar multiplication, most-significant window
// first, over a 256-bit little-endian scalar.  Variable-time: every
// input here is public (verification, not signing).
ge ge_scalarmult(const uint8_t scalar[32], const ge& p) {
  ge table[16];
  table[0] = ge_identity();
  table[1] = p;
  for (int i = 2; i < 16; ++i) table[i] = ge_add(table[i - 1], p);
  ge acc = ge_identity();
  bool started = false;
  for (int i = 63; i >= 0; --i) {
    unsigned w = (scalar[i >> 1] >> ((i & 1) * 4)) & 15;
    if (started) {
      acc = ge_double(ge_double(ge_double(ge_double(acc))));
    }
    if (w) {
      acc = started ? ge_add(acc, table[w]) : table[w];
      started = true;
    } else if (!started) {
      continue;  // skip leading zero windows entirely
    }
  }
  return acc;
}

// Point decompression, rule-for-rule core/_ed25519.py::_pt_decompress /
// _recover_x (the serial-parity contract lives or dies here):
// reject y >= p; u = y^2-1, v = d*y^2+1; u == 0 -> reject iff sign else
// x = 0; candidate x = u*v^3*(u*v^7)^((p-5)/8); accept x or x*sqrt(-1)
// by checking v*x^2 against ±u; reject x == 0 with sign set; negate to
// match the sign bit.
bool ge_decompress(ge& out, const uint8_t enc[32]) {
  uint8_t ybytes[32];
  std::memcpy(ybytes, enc, 32);
  const unsigned sign = ybytes[31] >> 7;
  ybytes[31] &= 0x7f;
  // y must be canonical (< p): compare little-endian against p's bytes.
  static const uint8_t PB[32] = {
      0xed, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
      0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
      0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0x7f};
  for (int i = 31; i >= 0; --i) {
    if (ybytes[i] < PB[i]) break;
    if (ybytes[i] > PB[i] || i == 0) return false;  // y >= p
  }
  const fe y = fe_frombytes(ybytes);
  const fe y2 = fe_sq(y);
  const fe u = fe_sub(y2, fe_one());
  const fe v = fe_add(fe_mul(consts().d, y2), fe_one());
  fe x;
  if (fe_is_zero(u)) {
    if (sign) return false;
    x = fe_zero();
  } else {
    const fe v3 = fe_mul(fe_sq(v), v);
    const fe uv3 = fe_mul(u, v3);
    const fe uv7 = fe_mul(uv3, fe_mul(v3, v));
    x = fe_mul(uv3, fe_pow(uv7, consts().exp_pm5d8));
    const fe vx2 = fe_mul(v, fe_sq(x));
    if (!fe_eq(vx2, u)) {
      if (!fe_eq(vx2, fe_sub(fe_zero(), u))) return false;
      x = fe_mul(x, consts().sqrt_m1);
    }
    uint8_t xb[32];
    fe_tobytes(xb, x);
    const bool x_zero = fe_is_zero(x);
    if (x_zero && sign) return false;
    if ((xb[0] & 1) != sign) x = fe_sub(fe_zero(), x);
  }
  out.x = x;
  out.y = y;
  out.z = fe_one();
  out.t = fe_mul(x, y);
  return true;
}

const Consts& consts() {
  static const Consts C = [] {
    Consts c;
    // d = -121665/121666: one generic inversion at first use beats
    // transcribing a 255-bit constant that could silently rot.
    uint8_t exp_pm2[32];
    std::memset(exp_pm2, 0xff, 32);
    exp_pm2[0] = 0xeb;
    exp_pm2[31] = 0x7f;
    std::memset(c.exp_pm5d8, 0xff, 32);
    c.exp_pm5d8[0] = 0xfd;
    c.exp_pm5d8[31] = 0x0f;
    fe n121665 = {{121665, 0, 0, 0, 0}};
    fe n121666 = {{121666, 0, 0, 0, 0}};
    c.d = fe_mul(fe_sub(fe_zero(), n121665), fe_pow(n121666, exp_pm2));
    c.d2 = fe_add(c.d, c.d);
    // sqrt(-1) = 2^((p-1)/4)
    uint8_t exp_pm1d4[32];
    std::memset(exp_pm1d4, 0xff, 32);
    exp_pm1d4[0] = 0xfb;
    exp_pm1d4[31] = 0x1f;
    fe two = {{2, 0, 0, 0, 0}};
    c.sqrt_m1 = fe_pow(two, exp_pm1d4);
    // base point from its standard compressed encoding (y = 4/5).
    uint8_t b_enc[32];
    std::memset(b_enc, 0x66, 32);
    b_enc[0] = 0x58;
    ge b;
    // consts() is re-entered by ge_decompress via c.d — but d and
    // sqrt_m1 are already set above and B is only READ after init, so
    // decompress directly with the locals instead of recursing.
    // (Simplest correct form: inline the same math through ge_decompress
    // once C is published would recurse; so build B by scalar-free
    // decompression using the fields already in `c`.)
    const unsigned sign = b_enc[31] >> 7;
    uint8_t yb[32];
    std::memcpy(yb, b_enc, 32);
    yb[31] &= 0x7f;
    const fe y = fe_frombytes(yb);
    const fe y2 = fe_sq(y);
    const fe u = fe_sub(y2, fe_one());
    const fe v = fe_add(fe_mul(c.d, y2), fe_one());
    const fe v3 = fe_mul(fe_sq(v), v);
    const fe uv7 = fe_mul(fe_mul(u, v3), fe_mul(v3, v));
    fe x = fe_mul(fe_mul(u, v3), fe_pow(uv7, c.exp_pm5d8));
    const fe vx2 = fe_mul(v, fe_sq(x));
    if (!fe_eq(vx2, u)) x = fe_mul(x, c.sqrt_m1);
    uint8_t xb[32];
    fe_tobytes(xb, x);
    if ((xb[0] & 1) != sign) x = fe_sub(fe_zero(), x);
    b.x = x;
    b.y = y;
    b.z = fe_one();
    b.t = fe_mul(x, y);
    c.B = b;
    return c;
  }();
  return C;
}

//: q (the prime group order), little-endian — pinned against
//: core/_ed25519.py::_Q by tests/test_torch_native_ed25519.py.
const uint8_t Q_BYTES[32] = {
    0xed, 0xd3, 0xf5, 0x5c, 0x1a, 0x63, 0x12, 0x58, 0xd6, 0x9c, 0xf7,
    0xa2, 0xde, 0xf9, 0xde, 0x14, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x10};

// Exact prime-subgroup membership: [q]·P == identity.  The torsion
// group is Z/8 — far too small for any probabilistic shortcut, so the
// gate is a full scalar multiplication by q per point (the dominant
// per-signature batch cost, same trade core/_ed25519.py documents).
inline bool in_prime_subgroup(const ge& p) {
  return ge_is_identity(ge_scalarmult(Q_BYTES, p));
}

// --------------------------------------------------------- Pippenger ---

struct Pair {
  uint64_t s[4];  // 256-bit scalar, little-endian words
  ge p;
};

inline unsigned scalar_bits(const uint64_t s[4]) {
  for (int w = 3; w >= 0; --w)
    if (s[w]) return 64 * w + (64 - __builtin_clzll(s[w]));
  return 0;
}

inline unsigned digit_at(const uint64_t s[4], unsigned base, unsigned c) {
  const unsigned word = base >> 6, off = base & 63;
  uint64_t d = s[word] >> off;
  if (off + c > 64 && word + 1 < 4) d |= s[word + 1] << (64 - off);
  return (unsigned)(d & ((uint64_t(1) << c) - 1));
}

// Σ scalar·point by Pippenger's bucket method — the same window-size
// model and running-sum aggregation as core/_ed25519.py::_msm.
ge msm(const std::vector<Pair>& pairs) {
  unsigned maxbits = 0;
  for (const Pair& pr : pairs) {
    unsigned b = scalar_bits(pr.s);
    if (b > maxbits) maxbits = b;
  }
  if (maxbits == 0) return ge_identity();
  const uint64_t n = pairs.size();
  unsigned c = 2;
  u128 best = ~(u128)0;
  for (unsigned w = 2; w < 16; ++w) {
    const u128 cost =
        (u128)((maxbits + w - 1) / w) * (n + ((uint64_t)2 << w));
    if (cost < best) {
      best = cost;
      c = w;
    }
  }
  const unsigned nbuckets = 1u << c;
  std::vector<ge> buckets(nbuckets);
  std::vector<uint8_t> present(nbuckets);
  ge result = ge_identity();
  bool result_set = false;
  for (int shift = (int)((maxbits + c - 1) / c) - 1; shift >= 0; --shift) {
    if (result_set)
      for (unsigned i = 0; i < c; ++i) result = ge_double(result);
    std::memset(present.data(), 0, nbuckets);
    const unsigned base = (unsigned)shift * c;
    for (const Pair& pr : pairs) {
      const unsigned idx = digit_at(pr.s, base, c);
      if (!idx) continue;
      buckets[idx] = present[idx] ? ge_add(buckets[idx], pr.p) : pr.p;
      present[idx] = 1;
    }
    ge running, acc;
    bool have_running = false, have_acc = false;
    for (unsigned idx = nbuckets - 1; idx >= 1; --idx) {
      if (present[idx]) {
        running = have_running ? ge_add(running, buckets[idx]) : buckets[idx];
        have_running = true;
      }
      if (have_running) {
        acc = have_acc ? ge_add(acc, running) : running;
        have_acc = true;
      }
    }
    if (have_acc) {
      result = result_set ? ge_add(result, acc) : acc;
      result_set = true;
    }
  }
  return result;
}

inline void scalar_words(uint64_t out[4], const uint8_t s[32]) {
  for (int w = 0; w < 4; ++w) out[w] = load64(s + 8 * w);
}

}  // namespace

// ------------------------------------------------------------------ ABI --

extern "C" {

// Which arithmetic this build runs (backend telemetry; the SHA half of
// the library reports its own SHA-NI dispatch separately).
const char* p1_ed25519_impl() { return "u128-radix51"; }

// Exact subgroup gate on one compressed point: 1 in the prime-order
// subgroup, 0 torsioned, -1 undecodable.
int p1_ed25519_in_subgroup(const uint8_t enc[32]) {
  ge p;
  if (!ge_decompress(p, enc)) return -1;
  return in_prime_subgroup(p) ? 1 : 0;
}

// ONE serial cofactorless verification: [s]B == R + [k]A.  `s` and `k`
// are 32-byte little-endian scalars the caller already range-checked
// (s < q) / reduced (k mod q) — exactly what core/_ed25519.py::verify
// computes before its point math, so verdicts are bit-identical,
// torsion crafts included.  Deliberately NO subgroup gate here: the
// serial rule tolerates torsion that cancels, and this entry point IS
// the serial rule.
int p1_ed25519_verify(const uint8_t pub[32], const uint8_t r_enc[32],
                      const uint8_t s[32], const uint8_t k[32]) {
  ge a, r;
  if (!ge_decompress(a, pub)) return 0;
  if (!ge_decompress(r, r_enc)) return 0;
  const ge sb = ge_scalarmult(s, consts().B);
  const ge ka = ge_scalarmult(k, a);
  return ge_eq(sb, ge_add(r, ka)) ? 1 : 0;
}

// Batched verification core: gate + random-linear-combination MSM.
//
//   pubs     m unique compressed public keys (32 B each; caller dedups)
//   pub_idx  n uint32 indices into pubs, one per signature
//   r_encs   n compressed R points (32 B each)
//   zr       n 32-byte LE scalars for the R terms   (z_i)
//   za       n 32-byte LE scalars for the A terms   (z_i·k_i mod q)
//   sb       one 32-byte LE scalar for the B term   (q − Σ z_i·s_i mod q)
//
// Accepts (returns 1) iff every pubkey and every R decompresses into
// the PRIME-ORDER subgroup (exact [q]·P == identity — checked once per
// unique pubkey, per signature for R) and
//   Σ zr_i·R_i + Σ za_i·A_i + sb·B == identity.
// With every point proven torsion-free the mod-q scalar reductions the
// caller performed are exact and each term of the sum is the serial
// equation itself — batch acceptance implies serial acceptance up to
// the 2^-128 soundness of the caller's random coefficients.  0 is NOT
// a serial verdict (the gate also rejects serial-tolerated torsion
// crafts); the Python seam settles failures via keys.first_invalid.
int p1_ed25519_batch(const uint8_t* pubs, uint64_t m,
                     const uint32_t* pub_idx, const uint8_t* r_encs,
                     const uint8_t* zr, const uint8_t* za,
                     const uint8_t* sb, uint64_t n) {
  std::vector<ge> apts(m);
  for (uint64_t i = 0; i < m; ++i) {
    if (!ge_decompress(apts[i], pubs + 32 * i)) return 0;
    if (!in_prime_subgroup(apts[i])) return 0;
  }
  std::vector<Pair> pairs;
  pairs.reserve(2 * n + 1);
  for (uint64_t i = 0; i < n; ++i) {
    ge r;
    if (!ge_decompress(r, r_encs + 32 * i)) return 0;
    if (!in_prime_subgroup(r)) return 0;
    Pair pr;
    scalar_words(pr.s, zr + 32 * i);
    pr.p = r;
    if (scalar_bits(pr.s)) pairs.push_back(pr);
    Pair pa;
    scalar_words(pa.s, za + 32 * i);
    if (pub_idx[i] >= m) return 0;
    pa.p = apts[pub_idx[i]];
    if (scalar_bits(pa.s)) pairs.push_back(pa);
  }
  Pair pb;
  scalar_words(pb.s, sb);
  pb.p = consts().B;
  if (scalar_bits(pb.s)) pairs.push_back(pb);
  if (pairs.empty()) return 1;
  return ge_is_identity(msm(pairs)) ? 1 : 0;
}

}  // extern "C"
