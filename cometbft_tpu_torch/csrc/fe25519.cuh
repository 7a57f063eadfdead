// GF(2^255 - 19) arithmetic for the port's CUDA kernels, one field element
// per thread: 10 signed limbs in radix 2^25.5 (ref10's layout) with int64
// column sums.  Hopper multiplies 32x32->64 in one IMAD.WIDE, so a field
// product is 100 wide products (55 for a square).  Measured on the H100
// (ops/profile.py), such a product issues at about a third of the data
// sheet's 64 INT32 lanes per SM per clock.
//
// Carry bounds follow ref10: a multiplier input may be the sum or
// difference of at most three carried values (|limb| < 1.65 * 2^26).
//
// Included by ed25519_verify.cu and fe_chain.cu.  Without __CUDACC__ the
// same code builds for the host, so its arithmetic can be checked on a
// machine with no card; with ED25519_TALLY the host build also counts the
// field multiplies and squares it runs.

#pragma once

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#else
#define DEV static inline
#endif

#if defined(ED25519_TALLY) && !defined(__CUDACC__)
static long long g_tally_mul = 0, g_tally_sq = 0;
static bool g_tally_on = true;  // false while work that is not counted runs
#define TALLY(counter) ((counter) += g_tally_on)
#else
#define TALLY(counter) ((void)0)
#endif

namespace {

struct fe {
  int32_t v[10];
};

// Limb i holds bits [25*i + ceil(i/2), ...): 26 bits for even i, 25 for odd.
#define LIMB_OFF(i) (25 * (i) + (((i) + 1) >> 1))
#define LIMB_BITS(i) (((i) & 1) ? 25 : 26)

DEV fe fe_zero() {
  fe h = {{0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
  return h;
}
DEV fe fe_one() {
  fe h = {{1, 0, 0, 0, 0, 0, 0, 0, 0, 0}};
  return h;
}
DEV fe fe_d() {
  fe h = {{56195235, 13857412, 51736253, 6949390, 114729, 24766616, 60832955,
           30306712, 48412415, 21499315}};
  return h;
}
DEV fe fe_d2() {
  fe h = {{45281625, 27714825, 36363642, 13898781, 229458, 15978800, 54557047,
           27058993, 29715967, 9444199}};
  return h;
}
DEV fe fe_sqrtm1() {
  fe h = {{34513072, 25610706, 9377949, 3500415, 12389472, 33281959, 41962654,
           31548777, 326685, 11406482}};
  return h;
}

DEV void fe_add(fe& h, const fe& f, const fe& g) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = f.v[i] + g.v[i];
}
DEV void fe_sub(fe& h, const fe& f, const fe& g) {
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = f.v[i] - g.v[i];
}

// ref10's carry chain over int64 column sums: even limbs keep 26 bits, odd
// 25, centred remainders; the carry out of limb 9 re-enters limb 0 times 19
// (2^255 = 19 mod p).  Output |limb| <= 2^25 (even), 2^24 (odd), plus a
// small incoming carry.
DEV void fe_carry_wide(fe& h, int64_t t[10]) {
  int64_t c;
  c = (t[0] + (1LL << 25)) >> 26; t[1] += c; t[0] -= c * (1LL << 26);
  c = (t[4] + (1LL << 25)) >> 26; t[5] += c; t[4] -= c * (1LL << 26);
  c = (t[1] + (1LL << 24)) >> 25; t[2] += c; t[1] -= c * (1LL << 25);
  c = (t[5] + (1LL << 24)) >> 25; t[6] += c; t[5] -= c * (1LL << 25);
  c = (t[2] + (1LL << 25)) >> 26; t[3] += c; t[2] -= c * (1LL << 26);
  c = (t[6] + (1LL << 25)) >> 26; t[7] += c; t[6] -= c * (1LL << 26);
  c = (t[3] + (1LL << 24)) >> 25; t[4] += c; t[3] -= c * (1LL << 25);
  c = (t[7] + (1LL << 24)) >> 25; t[8] += c; t[7] -= c * (1LL << 25);
  c = (t[4] + (1LL << 25)) >> 26; t[5] += c; t[4] -= c * (1LL << 26);
  c = (t[8] + (1LL << 25)) >> 26; t[9] += c; t[8] -= c * (1LL << 26);
  c = (t[9] + (1LL << 24)) >> 25; t[0] += c * 19; t[9] -= c * (1LL << 25);
  c = (t[0] + (1LL << 25)) >> 26; t[1] += c; t[0] -= c * (1LL << 26);
#pragma unroll
  for (int i = 0; i < 10; i++) h.v[i] = (int32_t)t[i];
}

// Carry any int32 limb vector down to the carried range (value unchanged).
DEV void fe_reduce(fe& h, const fe& f) {
  int64_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = f.v[i];
  fe_carry_wide(h, t);
}

// acc + a * b, 32x32->64 signed.  On the card it is written as PTX
// mad.wide.s32, so that it compiles to one signed IMAD.WIDE: left to
// itself the compiler may lower a signed product to an unsigned IMAD.WIDE.U32
// plus two IMADs that correct the sign, which made a field multiply about
// 1.8x slower (the multiply chain of chip_smoke.py's profile phase on an
// H100 80GB HBM3 at 700 W: 12.1 products per SM per clock with that
// lowering, 21.6-22.1 with this one).
DEV int64_t mac(int64_t acc, int32_t a, int32_t b) {
#if defined(__CUDA_ARCH__)
  int64_t r;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(acc));
  return r;
#else
  return acc + (int64_t)a * b;
#endif
}

// h = f * g.  Inputs: |limb| < 1.65 * 2^26 (three carried values summed).
// Product f_i g_j lands in column i+j; it is doubled when i and j are both
// odd (the half bits of the 2^25.5 radix) and folded times 19 when i+j >= 10.
DEV void fe_mul(fe& h, const fe& f, const fe& g) {
  TALLY(g_tally_mul);
  int32_t f2[10], g19[10];
  int64_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    f2[i] = 2 * f.v[i];
    g19[i] = 19 * g.v[i];
    t[i] = 0;
  }
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) {
      const int32_t a = ((i & 1) && (j & 1)) ? f2[i] : f.v[i];
      const int32_t b = (i + j >= 10) ? g19[j] : g.v[j];
      t[(i + j) % 10] = mac(t[(i + j) % 10], a, b);
    }
  }
  fe_carry_wide(h, t);
}

// h = f^2 times 2^dbl (dbl is 0 or 1; ref10's fe_sq2 doubles the column
// sums before the carry, as here): the 55 products of the upper triangle.
// Product f_i f_j (j >= i) counts twice when i != j, twice more when both
// are odd and 19 times when i+j >= 10; as in ref10 the factors go on the
// 32-bit operands (2 f_i, and f_j times 1, 2, 19 or 38, which stays below
// 2^31 for odd j), so each product is one 32x32->64-bit multiply-add.
DEV void fe_sq_shl(fe& h, const fe& f, int dbl) {
  TALLY(g_tally_sq);
  int32_t f2[10], f19[10], f38[10];
  int64_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    f2[i] = 2 * f.v[i];
    f19[i] = 19 * f.v[i];
    f38[i] = 38 * f.v[i];
    t[i] = 0;
  }
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = i; j < 10; j++) {
      const bool odd = (i & 1) && (j & 1), wrap = i + j >= 10;
      const int32_t a = i == j ? f.v[i] : f2[i];
      const int32_t b = wrap ? (odd ? f38[j] : f19[j]) : (odd ? f2[j] : f.v[j]);
      t[(i + j) % 10] = mac(t[(i + j) % 10], a, b);
    }
  }
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] += t[i] & -(int64_t)dbl;
  fe_carry_wide(h, t);
}
DEV void fe_sq(fe& h, const fe& f) { fe_sq_shl(h, f, 0); }

// Canonical limbs of f mod p (ref10 fe_tobytes without the byte packing):
// q = floor(f / p) by a carry sweep, then f - q*p with floor carries.
DEV void fe_freeze(fe& h, const fe& f) {
  fe_reduce(h, f);
  int32_t q = (19 * h.v[9] + (1 << 24)) >> 25;
#pragma unroll
  for (int i = 0; i < 10; i++) q = (h.v[i] + q) >> LIMB_BITS(i);
  h.v[0] += 19 * q;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int32_t c = h.v[i] >> LIMB_BITS(i);
    h.v[i + 1] += c;
    h.v[i] -= c * (1 << LIMB_BITS(i));
  }
  const int32_t c9 = h.v[9] >> 25;
  h.v[9] -= c9 * (1 << 25);
}

DEV bool fe_iszero(const fe& f) {
  fe h;
  fe_freeze(h, f);
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) acc |= h.v[i];
  return acc == 0;
}

// The low 255 bits of a 32-byte little-endian string (bit 255, the sign, is
// dropped).  The value may be >= p: ZIP-215 accepts non-canonical y.
DEV void fe_frombytes(fe& h, const uint8_t* s) {
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int off = LIMB_OFF(i);
    uint64_t w = 0;
#pragma unroll
    for (int k = 0; k < 5; k++) {
      const int idx = (off >> 3) + k;
      if (idx < 32) w |= (uint64_t)s[idx] << (8 * k);
    }
    h.v[i] = (int32_t)((w >> (off & 7)) & ((1u << LIMB_BITS(i)) - 1));
  }
}

// z^((p-5)/8) = z^(2^252 - 3), ref10's chain (11 multiplies, 251 squares).
DEV void fe_pow22523(fe& out, const fe& z) {
  fe t0, t1, t2;
  fe_sq(t0, z);
  fe_sq(t1, t0);
  fe_sq(t1, t1);
  fe_mul(t1, z, t1);
  fe_mul(t0, t0, t1);
  fe_sq(t0, t0);
  fe_mul(t0, t1, t0);  // 2^5 - 1
  fe_sq(t1, t0);
  for (int i = 1; i < 5; i++) fe_sq(t1, t1);
  fe_mul(t0, t1, t0);  // 2^10 - 1
  fe_sq(t1, t0);
  for (int i = 1; i < 10; i++) fe_sq(t1, t1);
  fe_mul(t1, t1, t0);  // 2^20 - 1
  fe_sq(t2, t1);
  for (int i = 1; i < 20; i++) fe_sq(t2, t2);
  fe_mul(t1, t2, t1);  // 2^40 - 1
  fe_sq(t1, t1);
  for (int i = 1; i < 10; i++) fe_sq(t1, t1);
  fe_mul(t0, t1, t0);  // 2^50 - 1
  fe_sq(t1, t0);
  for (int i = 1; i < 50; i++) fe_sq(t1, t1);
  fe_mul(t1, t1, t0);  // 2^100 - 1
  fe_sq(t2, t1);
  for (int i = 1; i < 100; i++) fe_sq(t2, t2);
  fe_mul(t1, t2, t1);  // 2^200 - 1
  fe_sq(t1, t1);
  for (int i = 1; i < 50; i++) fe_sq(t1, t1);
  fe_mul(t0, t1, t0);  // 2^250 - 1
  fe_sq(t0, t0);
  fe_sq(t0, t0);       // 2^252 - 4
  fe_mul(out, t0, z);  // 2^252 - 3
}

}  // namespace
