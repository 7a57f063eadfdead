// BLS12-381 host library of the port: the blst analog (reference:
// crypto/bls12381/key_bls12381.go:31-188 gets C + assembly pairing from
// supranational/blst, go.mod:45).  The port's own copy of the JAX
// package's cometbft_tpu/native/csrc/bls12381.cpp, with the same exports
// and the same results byte for byte.
//
// Implemented from the public specifications (RFC 9380 hash-to-curve,
// the BLS signature draft, the ZCash serialization flags) with the SAME
// conventions as the pure-Python oracle in cometbft_tpu_torch/crypto/
// bls12381.py:
//   * min-pubkey-size: pubkeys sk*G1 (96-byte uncompressed), signatures
//     sk*H(msg) in G2 (96-byte compressed)
//   * DST "BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_"
//   * KeyValidate on pubkeys (subgroup + non-infinity), SigValidate(false)
//     on signatures (subgroup, infinity allowed)
// tests/test_torch_bls.py holds this library to the Python oracle and to
// the JAX package's library.
//
// Arithmetic: 6x64-limb Montgomery Fp, the usual Fp2/Fp6/Fp12 tower
// (xi = 1+u), Jacobian curve arithmetic, optimal-ate Miller loop, easy
// final exponentiation + fixed-exponent hard part.
//
// Build: g++ -O3 -shared -fPIC -std=c++17, at first use
// (cometbft_tpu_torch/ops/_build.py), bound in cometbft_tpu_torch/native.py.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <mutex>
#include <string>
#include <vector>

namespace {

// ===========================================================================
// Fp: 6x64-bit little-endian limbs, Montgomery form (R = 2^384)
// ===========================================================================

struct Fp { uint64_t l[6]; };

static uint64_t P_LIMBS[6];
static uint64_t P_INV64;   // -p^-1 mod 2^64
static Fp MONT_R;          // R mod p   (= to_mont(1))
static Fp MONT_R2;         // R^2 mod p
static Fp FP_ZERO_C;

typedef unsigned __int128 u128;

static inline bool fp_is_zero(const Fp& a) {
    uint64_t o = 0;
    for (int i = 0; i < 6; i++) o |= a.l[i];
    return o == 0;
}

static inline bool fp_eq(const Fp& a, const Fp& b) {
    uint64_t o = 0;
    for (int i = 0; i < 6; i++) o |= a.l[i] ^ b.l[i];
    return o == 0;
}

// a >= p ?
static inline bool fp_geq_p(const uint64_t a[6]) {
    for (int i = 5; i >= 0; i--) {
        if (a[i] > P_LIMBS[i]) return true;
        if (a[i] < P_LIMBS[i]) return false;
    }
    return true;  // equal
}

static inline void fp_sub_p(uint64_t a[6]) {
    u128 borrow = 0;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)a[i] - P_LIMBS[i] - (uint64_t)borrow;
        a[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static inline void fp_add(Fp& out, const Fp& a, const Fp& b) {
    u128 carry = 0;
    for (int i = 0; i < 6; i++) {
        u128 s = (u128)a.l[i] + b.l[i] + (uint64_t)carry;
        out.l[i] = (uint64_t)s;
        carry = s >> 64;
    }
    if (carry || fp_geq_p(out.l)) fp_sub_p(out.l);
}

static inline void fp_sub(Fp& out, const Fp& a, const Fp& b) {
    u128 borrow = 0;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)a.l[i] - b.l[i] - (uint64_t)borrow;
        out.l[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) {  // add p back
        u128 carry = 0;
        for (int i = 0; i < 6; i++) {
            u128 s = (u128)out.l[i] + P_LIMBS[i] + (uint64_t)carry;
            out.l[i] = (uint64_t)s;
            carry = s >> 64;
        }
    }
}

static inline void fp_neg(Fp& out, const Fp& a) {
    if (fp_is_zero(a)) { out = a; return; }
    u128 borrow = 0;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)P_LIMBS[i] - a.l[i] - (uint64_t)borrow;
        out.l[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

// CIOS Montgomery multiplication: out = a*b*R^-1 mod p
static void fp_mul(Fp& out, const Fp& a, const Fp& b) {
    uint64_t t[8] = {0};
    for (int i = 0; i < 6; i++) {
        u128 carry = 0;
        uint64_t ai = a.l[i];
        for (int j = 0; j < 6; j++) {
            u128 s = (u128)t[j] + (u128)ai * b.l[j] + (uint64_t)carry;
            t[j] = (uint64_t)s;
            carry = s >> 64;
        }
        u128 s = (u128)t[6] + (uint64_t)carry;
        t[6] = (uint64_t)s;
        t[7] = (uint64_t)(s >> 64);

        uint64_t m = t[0] * P_INV64;
        u128 c2 = (u128)t[0] + (u128)m * P_LIMBS[0];
        carry = c2 >> 64;
        for (int j = 1; j < 6; j++) {
            u128 s2 = (u128)t[j] + (u128)m * P_LIMBS[j] + (uint64_t)carry;
            t[j - 1] = (uint64_t)s2;
            carry = s2 >> 64;
        }
        u128 s3 = (u128)t[6] + (uint64_t)carry;
        t[5] = (uint64_t)s3;
        t[6] = t[7] + (uint64_t)(s3 >> 64);
        t[7] = 0;
    }
    if (t[6] || fp_geq_p(t)) fp_sub_p(t);
    memcpy(out.l, t, 48);
}

static inline void fp_sq(Fp& out, const Fp& a) { fp_mul(out, a, a); }

// MSB-first square-and-multiply; exponent is big-endian bytes.
static void fp_pow(Fp& out, const Fp& base, const uint8_t* e, size_t elen) {
    Fp acc = MONT_R;  // one
    bool started = false;
    for (size_t i = 0; i < elen; i++) {
        for (int b = 7; b >= 0; b--) {
            if (started) fp_sq(acc, acc);
            if ((e[i] >> b) & 1) {
                if (started) fp_mul(acc, acc, base);
                else { acc = base; started = true; }
            }
        }
    }
    out = started ? acc : MONT_R;
}

static std::vector<uint8_t> PM2_BYTES, PM1D2_BYTES, PP1D4_BYTES;

static void fp_inv_pow(Fp& out, const Fp& a) {
    fp_pow(out, a, PM2_BYTES.data(), PM2_BYTES.size());
}

// ---- binary extended GCD inversion (~100x cheaper than Fermat pow) --------

static inline bool limbs_is_zero(const uint64_t a[6]) {
    uint64_t o = 0;
    for (int i = 0; i < 6; i++) o |= a[i];
    return o == 0;
}

static inline bool limbs_is_one(const uint64_t a[6]) {
    uint64_t o = 0;
    for (int i = 1; i < 6; i++) o |= a[i];
    return o == 0 && a[0] == 1;
}

static inline int limbs_cmp(const uint64_t a[6], const uint64_t b[6]) {
    for (int i = 5; i >= 0; i--) {
        if (a[i] > b[i]) return 1;
        if (a[i] < b[i]) return -1;
    }
    return 0;
}

static inline void limbs_sub(uint64_t a[6], const uint64_t b[6]) {  // a -= b
    u128 borrow = 0;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)a[i] - b[i] - (uint64_t)borrow;
        a[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

// a = (a + carry_in*2^384) >> 1
static inline void limbs_shr1(uint64_t a[6], uint64_t carry_in) {
    for (int i = 0; i < 5; i++) a[i] = (a[i] >> 1) | (a[i + 1] << 63);
    a[5] = (a[5] >> 1) | (carry_in << 63);
}

// halve x mod p (x may be any residue < p)
static inline void limbs_half_mod(uint64_t x[6]) {
    if (x[0] & 1) {
        u128 carry = 0;
        for (int i = 0; i < 6; i++) {
            u128 s = (u128)x[i] + P_LIMBS[i] + (uint64_t)carry;
            x[i] = (uint64_t)s;
            carry = s >> 64;
        }
        limbs_shr1(x, (uint64_t)carry);
    } else {
        limbs_shr1(x, 0);
    }
}

static inline void limbs_sub_mod(uint64_t a[6], const uint64_t b[6]) {
    // a = (a - b) mod p
    u128 borrow = 0;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)a[i] - b[i] - (uint64_t)borrow;
        a[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 6; i++) {
            u128 s = (u128)a[i] + P_LIMBS[i] + (uint64_t)carry;
            a[i] = (uint64_t)s;
            carry = s >> 64;
        }
    }
}

// out = a^-1 in Montgomery form.  The stored limbs of a are the integer
// aR mod p; binary xgcd yields (aR)^-1 = a^-1 R^-1, and two Montgomery
// multiplications by R^2 restore the Montgomery form:
//   ((a^-1 R^-1) * R^2) * R^-1 = a^-1;  (a^-1 * R^2) * R^-1 = a^-1 R.
static void fp_inv(Fp& out, const Fp& a) {
    if (fp_is_zero(a)) { out = a; return; }
    uint64_t u[6], v[6], x1[6] = {1, 0, 0, 0, 0, 0}, x2[6] = {0};
    memcpy(u, a.l, 48);
    memcpy(v, P_LIMBS, 48);
    while (!limbs_is_one(u) && !limbs_is_one(v)) {
        while (!(u[0] & 1)) {
            limbs_shr1(u, 0);
            limbs_half_mod(x1);
        }
        while (!(v[0] & 1)) {
            limbs_shr1(v, 0);
            limbs_half_mod(x2);
        }
        if (limbs_cmp(u, v) >= 0) {
            limbs_sub(u, v);
            limbs_sub_mod(x1, x2);
        } else {
            limbs_sub(v, u);
            limbs_sub_mod(x2, x1);
        }
    }
    Fp z;
    memcpy(z.l, limbs_is_one(u) ? x1 : x2, 48);
    fp_mul(z, z, MONT_R2);
    fp_mul(out, z, MONT_R2);
}

// Legendre symbol: 1 (QR), -1 (non-QR), 0
static int fp_legendre(const Fp& a) {
    if (fp_is_zero(a)) return 0;
    Fp r;
    fp_pow(r, a, PM1D2_BYTES.data(), PM1D2_BYTES.size());
    if (fp_eq(r, MONT_R)) return 1;
    return -1;
}

// sqrt for p = 3 mod 4: a^((p+1)/4); caller must confirm square
static void fp_sqrt_candidate(Fp& out, const Fp& a) {
    fp_pow(out, a, PP1D4_BYTES.data(), PP1D4_BYTES.size());
}

// ---- canonical (non-Montgomery) conversions -------------------------------

static void fp_from_bytes_be(Fp& out, const uint8_t b[48]) {
    for (int i = 0; i < 6; i++) {
        uint64_t w = 0;
        for (int j = 0; j < 8; j++) w = (w << 8) | b[(5 - i) * 8 + j];
        out.l[i] = w;
    }
    fp_mul(out, out, MONT_R2);  // to Montgomery
}

static void fp_canon(uint64_t out[6], const Fp& a) {
    Fp one_inv = a;
    // multiply by 1 (non-Montgomery) == Montgomery-reduce once
    Fp raw_one;
    memset(raw_one.l, 0, 48);
    raw_one.l[0] = 1;
    fp_mul(one_inv, a, raw_one);
    memcpy(out, one_inv.l, 48);
}

static void fp_to_bytes_be(uint8_t out[48], const Fp& a) {
    uint64_t c[6];
    fp_canon(c, a);
    for (int i = 0; i < 6; i++)
        for (int j = 0; j < 8; j++)
            out[(5 - i) * 8 + j] = (uint8_t)(c[i] >> (56 - 8 * j));
}

// canonical compare: a > b ?
static int fp_cmp_canon(const Fp& a, const Fp& b) {
    uint64_t ca[6], cb[6];
    fp_canon(ca, a);
    fp_canon(cb, b);
    for (int i = 5; i >= 0; i--) {
        if (ca[i] > cb[i]) return 1;
        if (ca[i] < cb[i]) return -1;
    }
    return 0;
}

static int fp_parity(const Fp& a) {
    uint64_t c[6];
    fp_canon(c, a);
    return (int)(c[0] & 1);
}

// parse big-endian bytes, REJECTING values >= p; returns false on overflow
static bool fp_from_bytes_checked(Fp& out, const uint8_t b[48]) {
    uint64_t raw[6];
    for (int i = 0; i < 6; i++) {
        uint64_t w = 0;
        for (int j = 0; j < 8; j++) w = (w << 8) | b[(5 - i) * 8 + j];
        raw[i] = w;
    }
    if (fp_geq_p(raw)) return false;
    memcpy(out.l, raw, 48);
    fp_mul(out, out, MONT_R2);
    return true;
}

// 64 uniform bytes big-endian mod p (hash_to_field)
static void fp_from_bytes64_mod(Fp& out, const uint8_t b[64]) {
    Fp c256;  // to_mont(256)
    memset(c256.l, 0, 48);
    c256.l[0] = 256;
    fp_mul(c256, c256, MONT_R2);
    Fp acc = FP_ZERO_C;
    for (int i = 0; i < 64; i++) {
        fp_mul(acc, acc, c256);
        Fp byte_m;
        memset(byte_m.l, 0, 48);
        byte_m.l[0] = b[i];
        fp_mul(byte_m, byte_m, MONT_R2);
        fp_add(acc, acc, byte_m);
    }
    out = acc;
}

static void fp_set_small(Fp& out, uint64_t v) {
    memset(out.l, 0, 48);
    out.l[0] = v;
    fp_mul(out, out, MONT_R2);
}

// ===========================================================================
// Fp2 = Fp[u]/(u^2+1)
// ===========================================================================

struct Fp2 { Fp a, b; };  // a + b*u

static Fp2 F2_ZERO_C, F2_ONE_C, XI_C;  // xi = 1 + u

static inline bool f2_is_zero(const Fp2& x) { return fp_is_zero(x.a) && fp_is_zero(x.b); }
static inline bool f2_eq(const Fp2& x, const Fp2& y) { return fp_eq(x.a, y.a) && fp_eq(x.b, y.b); }

static inline void f2_add(Fp2& o, const Fp2& x, const Fp2& y) {
    fp_add(o.a, x.a, y.a);
    fp_add(o.b, x.b, y.b);
}

static inline void f2_sub(Fp2& o, const Fp2& x, const Fp2& y) {
    fp_sub(o.a, x.a, y.a);
    fp_sub(o.b, x.b, y.b);
}

static inline void f2_neg(Fp2& o, const Fp2& x) {
    fp_neg(o.a, x.a);
    fp_neg(o.b, x.b);
}

static void f2_mul(Fp2& o, const Fp2& x, const Fp2& y) {
    Fp ac, bd, ab, cd, t;
    fp_mul(ac, x.a, y.a);
    fp_mul(bd, x.b, y.b);
    fp_add(ab, x.a, x.b);
    fp_add(cd, y.a, y.b);
    fp_mul(t, ab, cd);
    Fp2 r;
    fp_sub(r.a, ac, bd);
    fp_sub(t, t, ac);
    fp_sub(r.b, t, bd);
    o = r;
}

static void f2_sq(Fp2& o, const Fp2& x) {
    Fp apb, amb, t;
    fp_add(apb, x.a, x.b);
    fp_sub(amb, x.a, x.b);
    fp_mul(t, x.a, x.b);
    Fp2 r;
    fp_mul(r.a, apb, amb);
    fp_add(r.b, t, t);
    o = r;
}

static void f2_mul_fp(Fp2& o, const Fp2& x, const Fp& k) {
    fp_mul(o.a, x.a, k);
    fp_mul(o.b, x.b, k);
}

static void f2_conj(Fp2& o, const Fp2& x) {
    o.a = x.a;
    fp_neg(o.b, x.b);
}

static void f2_inv(Fp2& o, const Fp2& x) {
    Fp n, t, t2;
    fp_sq(n, x.a);
    fp_sq(t, x.b);
    fp_add(n, n, t);
    fp_inv(t2, n);
    Fp2 r;
    fp_mul(r.a, x.a, t2);
    fp_mul(r.b, x.b, t2);
    fp_neg(r.b, r.b);
    o = r;
}

static void f2_pow(Fp2& o, const Fp2& x, const uint8_t* e, size_t elen) {
    Fp2 acc = F2_ONE_C;
    for (size_t i = 0; i < elen; i++)
        for (int b = 7; b >= 0; b--) {
            f2_sq(acc, acc);
            if ((e[i] >> b) & 1) f2_mul(acc, acc, x);
        }
    o = acc;
}

// RFC 9380 sgn0 for m=2
static int f2_sgn0(const Fp2& x) {
    int s0 = fp_parity(x.a);
    int z0 = fp_is_zero(x.a) ? 1 : 0;
    int s1 = fp_parity(x.b);
    return s0 | (z0 & s1);
}

static bool f2_is_square(const Fp2& x) {
    Fp n, t;
    fp_sq(n, x.a);
    fp_sq(t, x.b);
    fp_add(n, n, t);
    return fp_legendre(n) >= 0;  // norm QR (or zero) <=> square in Fp2
}

// mirrors the Python _f2_sqrt (norm method); returns false when no root
static bool f2_sqrt(Fp2& o, const Fp2& x) {
    if (fp_is_zero(x.b)) {
        int leg = fp_legendre(x.a);
        if (leg >= 0) {
            fp_sqrt_candidate(o.a, x.a);
            o.b = FP_ZERO_C;
            return true;
        }
        Fp na;
        fp_neg(na, x.a);
        o.a = FP_ZERO_C;
        fp_sqrt_candidate(o.b, na);
        return true;
    }
    Fp n, t;
    fp_sq(n, x.a);
    fp_sq(t, x.b);
    fp_add(n, n, t);
    if (fp_legendre(n) != 1) return false;
    Fp alpha;
    fp_sqrt_candidate(alpha, n);
    Fp half, two;
    fp_set_small(two, 2);
    fp_inv(half, two);
    for (int sgn = 0; sgn < 2; sgn++) {
        Fp delta;
        if (sgn == 0) fp_add(delta, x.a, alpha);
        else fp_sub(delta, x.a, alpha);
        fp_mul(delta, delta, half);
        if (fp_legendre(delta) < 0) continue;
        Fp x0;
        fp_sqrt_candidate(x0, delta);
        if (fp_is_zero(x0)) continue;
        Fp x0_2, x0_2inv, x1;
        fp_add(x0_2, x0, x0);
        fp_inv(x0_2inv, x0_2);
        fp_mul(x1, x.b, x0_2inv);
        Fp2 cand;
        cand.a = x0;
        cand.b = x1;
        Fp2 chk;
        f2_sq(chk, cand);
        if (f2_eq(chk, x)) { o = cand; return true; }
    }
    return false;
}

// ===========================================================================
// Fp6 = Fp2[w]/(w^3 - xi),  Fp12 = Fp6[v]/(v^2 - w)
// ===========================================================================

struct Fp6 { Fp2 c0, c1, c2; };
struct Fp12 { Fp6 c0, c1; };

static Fp6 F6_ZERO_C, F6_ONE_C;
static Fp12 F12_ONE_C;

static inline void f6_add(Fp6& o, const Fp6& x, const Fp6& y) {
    f2_add(o.c0, x.c0, y.c0);
    f2_add(o.c1, x.c1, y.c1);
    f2_add(o.c2, x.c2, y.c2);
}

static inline void f6_sub(Fp6& o, const Fp6& x, const Fp6& y) {
    f2_sub(o.c0, x.c0, y.c0);
    f2_sub(o.c1, x.c1, y.c1);
    f2_sub(o.c2, x.c2, y.c2);
}

static inline void f6_neg(Fp6& o, const Fp6& x) {
    f2_neg(o.c0, x.c0);
    f2_neg(o.c1, x.c1);
    f2_neg(o.c2, x.c2);
}

static void f6_mul(Fp6& o, const Fp6& x, const Fp6& y) {
    Fp2 t0, t1, t2, s1, s2, u1, u2, m;
    f2_mul(t0, x.c0, y.c0);
    f2_mul(t1, x.c1, y.c1);
    f2_mul(t2, x.c2, y.c2);
    Fp6 r;
    // c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
    f2_add(s1, x.c1, x.c2);
    f2_add(s2, y.c1, y.c2);
    f2_mul(m, s1, s2);
    f2_sub(m, m, t1);
    f2_sub(m, m, t2);
    f2_mul(m, m, XI_C);
    f2_add(r.c0, t0, m);
    // c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
    f2_add(u1, x.c0, x.c1);
    f2_add(u2, y.c0, y.c1);
    f2_mul(m, u1, u2);
    f2_sub(m, m, t0);
    f2_sub(m, m, t1);
    f2_mul(s1, XI_C, t2);
    f2_add(r.c1, m, s1);
    // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
    f2_add(u1, x.c0, x.c2);
    f2_add(u2, y.c0, y.c2);
    f2_mul(m, u1, u2);
    f2_sub(m, m, t0);
    f2_sub(m, m, t2);
    f2_add(r.c2, m, t1);
    o = r;
}

// multiply by the cubic generator w: (c0,c1,c2)*w = (xi*c2, c0, c1)
static void f6_mul_by_w(Fp6& o, const Fp6& x) {
    Fp2 t;
    f2_mul(t, XI_C, x.c2);
    Fp6 r;
    r.c0 = t;
    r.c1 = x.c0;
    r.c2 = x.c1;
    o = r;
}

static void f6_inv(Fp6& o, const Fp6& x) {
    Fp2 t0, t1, t2, t3, t4, t5, c0, c1, c2, t6, m;
    f2_sq(t0, x.c0);
    f2_sq(t1, x.c1);
    f2_sq(t2, x.c2);
    f2_mul(t3, x.c0, x.c1);
    f2_mul(t4, x.c0, x.c2);
    f2_mul(t5, x.c1, x.c2);
    f2_mul(m, XI_C, t5);
    f2_sub(c0, t0, m);
    f2_mul(m, XI_C, t2);
    f2_sub(c1, m, t3);
    f2_sub(c2, t1, t4);
    Fp2 acc, acc2;
    f2_mul(acc, x.c0, c0);
    f2_mul(acc2, x.c2, c1);
    Fp2 tmp;
    f2_mul(tmp, x.c1, c2);
    f2_add(acc2, acc2, tmp);
    f2_mul(acc2, XI_C, acc2);
    f2_add(t6, acc, acc2);
    Fp2 t6i;
    f2_inv(t6i, t6);
    f2_mul(o.c0, c0, t6i);
    f2_mul(o.c1, c1, t6i);
    f2_mul(o.c2, c2, t6i);
}

static void f12_mul(Fp12& o, const Fp12& x, const Fp12& y) {
    Fp6 t0, t1, s, u, m;
    f6_mul(t0, x.c0, y.c0);
    f6_mul(t1, x.c1, y.c1);
    Fp12 r;
    f6_mul_by_w(m, t1);
    f6_add(r.c0, t0, m);
    f6_add(s, x.c0, x.c1);
    f6_add(u, y.c0, y.c1);
    f6_mul(m, s, u);
    f6_sub(m, m, t0);
    f6_sub(r.c1, m, t1);
    o = r;
}

// (a0 + a1 v)^2 with v^2 = w: c0 = a0^2 + w a1^2, c1 = 2 a0 a1 — via
// (a0+a1)(a0+w a1) = c0 + (1+w) a0 a1, so 2 Fp6 muls instead of 3
static void f12_sq(Fp12& o, const Fp12& x) {
    Fp6 t0, wa1, s1, s2, s, t0w;
    f6_mul(t0, x.c0, x.c1);
    f6_mul_by_w(wa1, x.c1);
    f6_add(s1, x.c0, x.c1);
    f6_add(s2, x.c0, wa1);
    f6_mul(s, s1, s2);
    f6_mul_by_w(t0w, t0);
    f6_sub(s, s, t0);
    f6_sub(o.c0, s, t0w);
    f6_add(o.c1, t0, t0);
}

static void f12_inv(Fp12& o, const Fp12& x) {
    Fp6 t, t2;
    f6_mul(t, x.c0, x.c0);
    f6_mul(t2, x.c1, x.c1);
    f6_mul_by_w(t2, t2);
    f6_sub(t, t, t2);
    f6_inv(t, t);
    f6_mul(o.c0, x.c0, t);
    f6_mul(o.c1, x.c1, t);
    f6_neg(o.c1, o.c1);
}

static void f12_conj(Fp12& o, const Fp12& x) {
    o.c0 = x.c0;
    f6_neg(o.c1, x.c1);
}

static bool f12_eq(const Fp12& x, const Fp12& y) {
    return f2_eq(x.c0.c0, y.c0.c0) && f2_eq(x.c0.c1, y.c0.c1) &&
           f2_eq(x.c0.c2, y.c0.c2) && f2_eq(x.c1.c0, y.c1.c0) &&
           f2_eq(x.c1.c1, y.c1.c1) && f2_eq(x.c1.c2, y.c1.c2);
}

static void f12_pow(Fp12& o, const Fp12& x, const uint8_t* e, size_t elen) {
    Fp12 acc = F12_ONE_C;
    bool started = false;
    for (size_t i = 0; i < elen; i++)
        for (int b = 7; b >= 0; b--) {
            if (started) f12_sq(acc, acc);
            if ((e[i] >> b) & 1) {
                if (started) f12_mul(acc, acc, x);
                else { acc = x; started = true; }
            }
        }
    o = started ? acc : F12_ONE_C;
}

// Frobenius x^p, mirroring the Python gamma table (xi^((p-1)k/6))
static Fp2 FROB_GAMMA1[6];

static void f12_frobenius(Fp12& o, const Fp12& x) {
    Fp2 a0, a1, a2, b0, b1, b2;
    f2_conj(a0, x.c0.c0);
    f2_conj(a1, x.c0.c1);
    f2_mul(a1, a1, FROB_GAMMA1[2]);
    f2_conj(a2, x.c0.c2);
    f2_mul(a2, a2, FROB_GAMMA1[4]);
    f2_conj(b0, x.c1.c0);
    f2_mul(b0, b0, FROB_GAMMA1[1]);
    f2_conj(b1, x.c1.c1);
    f2_mul(b1, b1, FROB_GAMMA1[3]);
    f2_conj(b2, x.c1.c2);
    f2_mul(b2, b2, FROB_GAMMA1[5]);
    o.c0.c0 = a0; o.c0.c1 = a1; o.c0.c2 = a2;
    o.c1.c0 = b0; o.c1.c1 = b1; o.c1.c2 = b2;
}

// ===========================================================================
// Curves: G1 over Fp (b=4), G2 over Fp2 (b=4(1+u)); Jacobian coordinates
// ===========================================================================

struct G1 { Fp X, Y, Z; };
struct G2 { Fp2 X, Y, Z; };

static Fp B1_C;       // 4
static Fp2 B2_C;      // 4(1+u)
static G1 G1_GEN_C;
static G2 G2_GEN_C;

static inline bool g1_is_inf(const G1& p) { return fp_is_zero(p.Z); }
static inline bool g2_is_inf(const G2& p) { return f2_is_zero(p.Z); }

static void g1_set_inf(G1& p) { p.X = MONT_R; p.Y = MONT_R; p.Z = FP_ZERO_C; }
static void g2_set_inf(G2& p) { p.X = F2_ONE_C; p.Y = F2_ONE_C; p.Z = F2_ZERO_C; }

// dbl-2007-bl (same formula as the Python _Curve.double)
static void g1_double(G1& o, const G1& p) {
    if (g1_is_inf(p)) { o = p; return; }
    Fp A, B, C, t, D, E, F, X3, Y3, Z3, c8;
    fp_sq(A, p.X);
    fp_sq(B, p.Y);
    fp_sq(C, B);
    fp_add(t, p.X, B);
    fp_sq(t, t);
    fp_sub(t, t, A);
    fp_sub(t, t, C);
    fp_add(D, t, t);
    fp_add(E, A, A);
    fp_add(E, E, A);
    fp_sq(F, E);
    fp_add(t, D, D);
    fp_sub(X3, F, t);
    fp_add(c8, C, C);
    fp_add(c8, c8, c8);
    fp_add(c8, c8, c8);
    fp_sub(t, D, X3);
    fp_mul(Y3, E, t);
    fp_sub(Y3, Y3, c8);
    fp_add(t, p.Y, p.Y);
    fp_mul(Z3, t, p.Z);
    o.X = X3; o.Y = Y3; o.Z = Z3;
}

static void g2_double(G2& o, const G2& p) {
    if (g2_is_inf(p)) { o = p; return; }
    Fp2 A, B, C, t, D, E, F, X3, Y3, Z3, c8;
    f2_sq(A, p.X);
    f2_sq(B, p.Y);
    f2_sq(C, B);
    f2_add(t, p.X, B);
    f2_sq(t, t);
    f2_sub(t, t, A);
    f2_sub(t, t, C);
    f2_add(D, t, t);
    f2_add(E, A, A);
    f2_add(E, E, A);
    f2_sq(F, E);
    f2_add(t, D, D);
    f2_sub(X3, F, t);
    f2_add(c8, C, C);
    f2_add(c8, c8, c8);
    f2_add(c8, c8, c8);
    f2_sub(t, D, X3);
    f2_mul(Y3, E, t);
    f2_sub(Y3, Y3, c8);
    f2_add(t, p.Y, p.Y);
    f2_mul(Z3, t, p.Z);
    o.X = X3; o.Y = Y3; o.Z = Z3;
}

static void g1_add(G1& o, const G1& p1, const G1& p2) {
    if (g1_is_inf(p1)) { o = p2; return; }
    if (g1_is_inf(p2)) { o = p1; return; }
    Fp Z1Z1, Z2Z2, U1, U2, S1, S2, t;
    fp_sq(Z1Z1, p1.Z);
    fp_sq(Z2Z2, p2.Z);
    fp_mul(U1, p1.X, Z2Z2);
    fp_mul(U2, p2.X, Z1Z1);
    fp_mul(t, p1.Y, p2.Z);
    fp_mul(S1, t, Z2Z2);
    fp_mul(t, p2.Y, p1.Z);
    fp_mul(S2, t, Z1Z1);
    if (fp_eq(U1, U2)) {
        if (fp_eq(S1, S2)) { g1_double(o, p1); return; }
        g1_set_inf(o);
        return;
    }
    Fp H, I, J, rr, V, X3, Y3, Z3, S1J;
    fp_sub(H, U2, U1);
    fp_add(t, H, H);
    fp_sq(I, t);
    fp_mul(J, H, I);
    fp_sub(t, S2, S1);
    fp_add(rr, t, t);
    fp_mul(V, U1, I);
    fp_sq(X3, rr);
    fp_sub(X3, X3, J);
    fp_add(t, V, V);
    fp_sub(X3, X3, t);
    fp_sub(t, V, X3);
    fp_mul(Y3, rr, t);
    fp_mul(S1J, S1, J);
    fp_add(S1J, S1J, S1J);
    fp_sub(Y3, Y3, S1J);
    fp_add(t, p1.Z, p2.Z);
    fp_sq(t, t);
    fp_sub(t, t, Z1Z1);
    fp_sub(t, t, Z2Z2);
    fp_mul(Z3, t, H);
    o.X = X3; o.Y = Y3; o.Z = Z3;
}

static void g2_add(G2& o, const G2& p1, const G2& p2) {
    if (g2_is_inf(p1)) { o = p2; return; }
    if (g2_is_inf(p2)) { o = p1; return; }
    Fp2 Z1Z1, Z2Z2, U1, U2, S1, S2, t;
    f2_sq(Z1Z1, p1.Z);
    f2_sq(Z2Z2, p2.Z);
    f2_mul(U1, p1.X, Z2Z2);
    f2_mul(U2, p2.X, Z1Z1);
    f2_mul(t, p1.Y, p2.Z);
    f2_mul(S1, t, Z2Z2);
    f2_mul(t, p2.Y, p1.Z);
    f2_mul(S2, t, Z1Z1);
    if (f2_eq(U1, U2)) {
        if (f2_eq(S1, S2)) { g2_double(o, p1); return; }
        g2_set_inf(o);
        return;
    }
    Fp2 H, I, J, rr, V, X3, Y3, Z3, S1J;
    f2_sub(H, U2, U1);
    f2_add(t, H, H);
    f2_sq(I, t);
    f2_mul(J, H, I);
    f2_sub(t, S2, S1);
    f2_add(rr, t, t);
    f2_mul(V, U1, I);
    f2_sq(X3, rr);
    f2_sub(X3, X3, J);
    f2_add(t, V, V);
    f2_sub(X3, X3, t);
    f2_sub(t, V, X3);
    f2_mul(Y3, rr, t);
    f2_mul(S1J, S1, J);
    f2_add(S1J, S1J, S1J);
    f2_sub(Y3, Y3, S1J);
    f2_add(t, p1.Z, p2.Z);
    f2_sq(t, t);
    f2_sub(t, t, Z1Z1);
    f2_sub(t, t, Z2Z2);
    f2_mul(Z3, t, H);
    o.X = X3; o.Y = Y3; o.Z = Z3;
}

static void g1_neg(G1& o, const G1& p) {
    o.X = p.X;
    fp_neg(o.Y, p.Y);
    o.Z = p.Z;
}

// scalar is big-endian bytes, MSB-first double-and-add
static void g1_scalar_mul(G1& o, const G1& p, const uint8_t* k, size_t klen) {
    G1 acc;
    g1_set_inf(acc);
    for (size_t i = 0; i < klen; i++)
        for (int b = 7; b >= 0; b--) {
            g1_double(acc, acc);
            if ((k[i] >> b) & 1) g1_add(acc, acc, p);
        }
    o = acc;
}

static void g2_scalar_mul(G2& o, const G2& p, const uint8_t* k, size_t klen) {
    G2 acc;
    g2_set_inf(acc);
    for (size_t i = 0; i < klen; i++)
        for (int b = 7; b >= 0; b--) {
            g2_double(acc, acc);
            if ((k[i] >> b) & 1) g2_add(acc, acc, p);
        }
    o = acc;
}

static bool g1_affine(Fp& x, Fp& y, const G1& p) {
    if (g1_is_inf(p)) return false;
    Fp zi, zi2, zi3;
    fp_inv(zi, p.Z);
    fp_sq(zi2, zi);
    fp_mul(zi3, zi2, zi);
    fp_mul(x, p.X, zi2);
    fp_mul(y, p.Y, zi3);
    return true;
}

static bool g2_affine(Fp2& x, Fp2& y, const G2& p) {
    if (g2_is_inf(p)) return false;
    Fp2 zi, zi2, zi3;
    f2_inv(zi, p.Z);
    f2_sq(zi2, zi);
    f2_mul(zi3, zi2, zi);
    f2_mul(x, p.X, zi2);
    f2_mul(y, p.Y, zi3);
    return true;
}

static bool g1_on_curve(const G1& p) {
    if (g1_is_inf(p)) return true;
    Fp x, y, lhs, rhs;
    if (!g1_affine(x, y, p)) return false;
    fp_sq(lhs, y);
    fp_sq(rhs, x);
    fp_mul(rhs, rhs, x);
    fp_add(rhs, rhs, B1_C);
    return fp_eq(lhs, rhs);
}

static bool g2_on_curve(const G2& p) {
    if (g2_is_inf(p)) return true;
    Fp2 x, y, lhs, rhs;
    if (!g2_affine(x, y, p)) return false;
    f2_sq(lhs, y);
    f2_sq(rhs, x);
    f2_mul(rhs, rhs, x);
    f2_add(rhs, rhs, B2_C);
    return f2_eq(lhs, rhs);
}

static std::vector<uint8_t> R_ORDER_BYTES, HARD_EXP_BYTES, H_EFF_BYTES;

static bool g1_in_subgroup(const G1& p) {
    G1 r;
    g1_scalar_mul(r, p, R_ORDER_BYTES.data(), R_ORDER_BYTES.size());
    return g1_is_inf(r);
}

static bool g2_in_subgroup(const G2& p) {
    G2 r;
    g2_scalar_mul(r, p, R_ORDER_BYTES.data(), R_ORDER_BYTES.size());
    return g2_is_inf(r);
}

// ===========================================================================
// Pairing: optimal ate, mirroring the Python module's line construction
// ===========================================================================

static const uint64_t X_ABS_PARAM = 0xD201000000010000ULL;

// Fp12 element c0 + c2*w^2 + c3*w^3 (even part (c0, c2, 0), odd (0, c3, 0))
static void f12_from_line(Fp12& o, const Fp2& c0, const Fp2& c2, const Fp2& c3) {
    o.c0.c0 = c0;
    o.c0.c1 = c2;
    o.c0.c2 = F2_ZERO_C;
    o.c1.c0 = F2_ZERO_C;
    o.c1.c1 = c3;
    o.c1.c2 = F2_ZERO_C;
}

// line through r (tangent) or r,q (chord) evaluated at affine G1 point
static void line_eval(Fp12& o, const G2& r, const Fp2* q_x, const Fp2* q_y,
                      const Fp& px, const Fp& py, bool tangent) {
    Fp2 x1, y1;
    g2_affine(x1, y1, r);
    Fp2 num, den;
    if (tangent) {
        Fp2 x1sq;
        f2_sq(x1sq, x1);
        f2_add(num, x1sq, x1sq);
        f2_add(num, num, x1sq);  // 3*x1^2
        f2_add(den, y1, y1);     // 2*y1
    } else {
        if (f2_eq(x1, *q_x) && f2_eq(y1, *q_y)) {
            line_eval(o, r, nullptr, nullptr, px, py, true);
            return;
        }
        f2_sub(num, *q_y, y1);
        f2_sub(den, *q_x, x1);
        if (f2_is_zero(den)) {
            // vertical line: l(P) = px - x1
            Fp2 c0, c2;
            f2_neg(c0, x1);
            c2.a = px;
            c2.b = FP_ZERO_C;
            f12_from_line(o, c0, c2, F2_ZERO_C);
            return;
        }
    }
    Fp2 m, deni;
    f2_inv(deni, den);
    f2_mul(m, num, deni);
    Fp2 c0, c2, c3;
    f2_mul(c0, m, x1);
    f2_sub(c0, c0, y1);
    Fp2 mpx;
    f2_mul_fp(mpx, m, px);
    f2_neg(c2, mpx);
    c3.a = py;
    c3.b = FP_ZERO_C;
    f12_from_line(o, c0, c2, c3);
}

// f_{-x,Q}(P); negative x handled by final conjugation
static void miller_loop(Fp12& f, const Fp& px, const Fp& py, const G2& q) {
    f = F12_ONE_C;
    G2 r = q;
    Fp2 qx, qy;
    g2_affine(qx, qy, q);
    // iterate bits of X_ABS below the MSB (bit 63)
    for (int bit = 62; bit >= 0; bit--) {
        Fp12 line;
        line_eval(line, r, nullptr, nullptr, px, py, true);
        g2_double(r, r);
        f12_sq(f, f);
        f12_mul(f, f, line);
        if ((X_ABS_PARAM >> bit) & 1) {
            line_eval(line, r, &qx, &qy, px, py, false);
            G2 qjac;
            qjac.X = qx;
            qjac.Y = qy;
            qjac.Z = F2_ONE_C;
            g2_add(r, r, qjac);
            f12_mul(f, f, line);
        }
    }
    f12_conj(f, f);
}

static void final_exponentiation(Fp12& o, const Fp12& f_in) {
    // easy: f^(p^6-1) = conj(f)*f^-1, then ^(p^2+1)
    Fp12 f, fi, c;
    f12_inv(fi, f_in);
    f12_conj(c, f_in);
    f12_mul(f, c, fi);
    Fp12 fr;
    f12_frobenius(fr, f);
    f12_frobenius(fr, fr);
    f12_mul(f, fr, f);
    // hard: fixed exponent (p^4 - p^2 + 1)/r
    f12_pow(o, f, HARD_EXP_BYTES.data(), HARD_EXP_BYTES.size());
}

// prod e(Pi, Qi) == 1 with one shared final exponentiation
static bool pairing_product_is_one(const std::vector<G1>& ps,
                                   const std::vector<G2>& qs) {
    Fp12 acc = F12_ONE_C;
    bool any = false;
    for (size_t i = 0; i < ps.size(); i++) {
        if (g1_is_inf(ps[i]) || g2_is_inf(qs[i])) continue;
        any = true;
        Fp px, py;
        g1_affine(px, py, ps[i]);
        Fp12 f;
        miller_loop(f, px, py, qs[i]);
        f12_mul(acc, acc, f);
    }
    if (!any) return true;
    Fp12 out;
    final_exponentiation(out, acc);
    return f12_eq(out, F12_ONE_C);
}

// ===========================================================================
// SHA-256 (for expand_message_xmd)
// ===========================================================================

static const uint32_t K256[64] = {
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

struct Sha256Ctx {
    uint32_t h[8];
    uint8_t buf[64];
    size_t buf_len;
    uint64_t total;
};

static inline uint32_t rotr32(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
}

static void sha256_init(Sha256Ctx* c) {
    static const uint32_t iv[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                   0xa54ff53a, 0x510e527f, 0x9b05688c,
                                   0x1f83d9ab, 0x5be0cd19};
    memcpy(c->h, iv, sizeof(iv));
    c->buf_len = 0;
    c->total = 0;
}

static void sha256_block(Sha256Ctx* c, const uint8_t* p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
        w[i] = ((uint32_t)p[i * 4] << 24) | ((uint32_t)p[i * 4 + 1] << 16) |
               ((uint32_t)p[i * 4 + 2] << 8) | p[i * 4 + 3];
    for (int i = 16; i < 64; i++) {
        uint32_t s0 = rotr32(w[i - 15], 7) ^ rotr32(w[i - 15], 18) ^ (w[i - 15] >> 3);
        uint32_t s1 = rotr32(w[i - 2], 17) ^ rotr32(w[i - 2], 19) ^ (w[i - 2] >> 10);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = c->h[0], b = c->h[1], cc = c->h[2], d = c->h[3];
    uint32_t e = c->h[4], f = c->h[5], g = c->h[6], hh = c->h[7];
    for (int i = 0; i < 64; i++) {
        uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
        uint32_t ch = (e & f) ^ (~e & g);
        uint32_t t1 = hh + S1 + ch + K256[i] + w[i];
        uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
        uint32_t maj = (a & b) ^ (a & cc) ^ (b & cc);
        uint32_t t2 = S0 + maj;
        hh = g; g = f; f = e; e = d + t1;
        d = cc; cc = b; b = a; a = t1 + t2;
    }
    c->h[0] += a; c->h[1] += b; c->h[2] += cc; c->h[3] += d;
    c->h[4] += e; c->h[5] += f; c->h[6] += g; c->h[7] += hh;
}

static void sha256_update(Sha256Ctx* c, const uint8_t* data, size_t len) {
    c->total += len;
    while (len > 0) {
        size_t take = 64 - c->buf_len;
        if (take > len) take = len;
        memcpy(c->buf + c->buf_len, data, take);
        c->buf_len += take;
        data += take;
        len -= take;
        if (c->buf_len == 64) {
            sha256_block(c, c->buf);
            c->buf_len = 0;
        }
    }
}

static void sha256_final(Sha256Ctx* c, uint8_t out[32]) {
    uint64_t bits = c->total * 8;
    uint8_t pad = 0x80;
    sha256_update(c, &pad, 1);
    uint8_t zero = 0;
    while (c->buf_len != 56) sha256_update(c, &zero, 1);
    uint8_t lenbuf[8];
    for (int i = 0; i < 8; i++) lenbuf[7 - i] = (uint8_t)(bits >> (8 * i));
    sha256_update(c, lenbuf, 8);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 4; j++)
            out[i * 4 + j] = (uint8_t)(c->h[i] >> (24 - 8 * j));
}

// ===========================================================================
// hash-to-curve G2 (RFC 9380, SSWU + 3-isogeny), same DST as the reference
// ===========================================================================

static const char DST_STR[] = "BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_";

static void expand_message_xmd(uint8_t* out, size_t out_len,
                               const uint8_t* msg, size_t msg_len) {
    size_t ell = (out_len + 31) / 32;
    size_t dst_len = sizeof(DST_STR) - 1;
    uint8_t dst_prime[64];
    memcpy(dst_prime, DST_STR, dst_len);
    dst_prime[dst_len] = (uint8_t)dst_len;
    size_t dpl = dst_len + 1;

    uint8_t b0[32];
    {
        Sha256Ctx c;
        sha256_init(&c);
        uint8_t z_pad[64] = {0};
        sha256_update(&c, z_pad, 64);
        sha256_update(&c, msg, msg_len);
        uint8_t lib[2] = {(uint8_t)(out_len >> 8), (uint8_t)out_len};
        sha256_update(&c, lib, 2);
        uint8_t zero = 0;
        sha256_update(&c, &zero, 1);
        sha256_update(&c, dst_prime, dpl);
        sha256_final(&c, b0);
    }
    uint8_t bi[32];
    {
        Sha256Ctx c;
        sha256_init(&c);
        sha256_update(&c, b0, 32);
        uint8_t one = 1;
        sha256_update(&c, &one, 1);
        sha256_update(&c, dst_prime, dpl);
        sha256_final(&c, bi);
    }
    size_t off = 0;
    for (size_t i = 1; i <= ell; i++) {
        size_t take = out_len - off < 32 ? out_len - off : 32;
        memcpy(out + off, bi, take);
        off += take;
        if (i == ell) break;
        uint8_t x[32];
        for (int j = 0; j < 32; j++) x[j] = b0[j] ^ bi[j];
        Sha256Ctx c;
        sha256_init(&c);
        sha256_update(&c, x, 32);
        uint8_t idx = (uint8_t)(i + 1);
        sha256_update(&c, &idx, 1);
        sha256_update(&c, dst_prime, dpl);
        sha256_final(&c, bi);
    }
}

// SSWU constants and isogeny coefficients (parsed at init)
static Fp2 SSWU_A, SSWU_B, SSWU_Z;
static Fp2 ISO_XNUM[4], ISO_XDEN[3], ISO_YNUM[4], ISO_YDEN[4];

static void sswu_map(Fp2& x_out, Fp2& y_out, const Fp2& u) {
    Fp2 u2, tv1, tv2, x1num, x1den, x1, gx1, t;
    f2_sq(u2, u);
    f2_mul(tv1, SSWU_Z, u2);
    f2_sq(tv2, tv1);
    f2_add(tv2, tv2, tv1);
    f2_add(t, tv2, F2_ONE_C);
    f2_mul(x1num, SSWU_B, t);
    Fp2 negA;
    f2_neg(negA, SSWU_A);
    f2_mul(x1den, negA, tv2);
    if (f2_is_zero(x1den)) f2_mul(x1den, SSWU_Z, SSWU_A);
    Fp2 di;
    f2_inv(di, x1den);
    f2_mul(x1, x1num, di);
    Fp2 x1sq, x1cu, ax1;
    f2_sq(x1sq, x1);
    f2_mul(x1cu, x1sq, x1);
    f2_mul(ax1, SSWU_A, x1);
    f2_add(gx1, x1cu, ax1);
    f2_add(gx1, gx1, SSWU_B);
    Fp2 x, y;
    if (f2_is_square(gx1)) {
        x = x1;
        f2_sqrt(y, gx1);
    } else {
        f2_mul(x, tv1, x1);
        Fp2 tv1sq, tv1cu, g2v;
        f2_sq(tv1sq, tv1);
        f2_mul(tv1cu, tv1sq, tv1);
        f2_mul(g2v, tv1cu, gx1);
        f2_sqrt(y, g2v);
    }
    if (f2_sgn0(u) != f2_sgn0(y)) f2_neg(y, y);
    x_out = x;
    y_out = y;
}

static void iso_map(Fp2& xo, Fp2& yo, const Fp2& x, const Fp2& y) {
    auto horner = [&](const Fp2* coeffs, int n, const Fp2& xv, Fp2& out) {
        out = coeffs[n - 1];
        for (int i = n - 2; i >= 0; i--) {
            f2_mul(out, out, xv);
            f2_add(out, out, coeffs[i]);
        }
    };
    Fp2 xnum, xden, ynum, yden, di;
    horner(ISO_XNUM, 4, x, xnum);
    horner(ISO_XDEN, 3, x, xden);
    horner(ISO_YNUM, 4, x, ynum);
    horner(ISO_YDEN, 4, x, yden);
    f2_inv(di, xden);
    f2_mul(xo, xnum, di);
    f2_inv(di, yden);
    f2_mul(yo, ynum, di);
    f2_mul(yo, yo, y);
}

static void hash_to_g2(G2& out, const uint8_t* msg, size_t msg_len) {
    uint8_t uniform[256];
    expand_message_xmd(uniform, 256, msg, msg_len);  // 2 elements x 2 coords x 64B
    Fp2 u0, u1;
    fp_from_bytes64_mod(u0.a, uniform);
    fp_from_bytes64_mod(u0.b, uniform + 64);
    fp_from_bytes64_mod(u1.a, uniform + 128);
    fp_from_bytes64_mod(u1.b, uniform + 192);
    Fp2 x0, y0, x1, y1, q0x, q0y, q1x, q1y;
    sswu_map(x0, y0, u0);
    sswu_map(x1, y1, u1);
    iso_map(q0x, q0y, x0, y0);
    iso_map(q1x, q1y, x1, y1);
    G2 a, b, s;
    a.X = q0x; a.Y = q0y; a.Z = F2_ONE_C;
    b.X = q1x; b.Y = q1y; b.Z = F2_ONE_C;
    g2_add(s, a, b);
    g2_scalar_mul(out, s, H_EFF_BYTES.data(), H_EFF_BYTES.size());
}

// ===========================================================================
// Serialization (ZCash flag convention, mirrors the Python module)
// ===========================================================================

static void g1_serialize_uncompressed(uint8_t out[96], const G1& p) {
    if (g1_is_inf(p)) {
        memset(out, 0, 96);
        out[0] = 0x40;
        return;
    }
    Fp x, y;
    g1_affine(x, y, p);
    fp_to_bytes_be(out, x);
    fp_to_bytes_be(out + 48, y);
}

static bool g1_deserialize(G1& out, const uint8_t* b, size_t len) {
    if (len == 96 && !(b[0] & 0x80)) {
        if (b[0] & 0x40) {
            if (b[0] != 0x40) return false;
            for (int i = 1; i < 96; i++)
                if (b[i]) return false;
            g1_set_inf(out);
            return true;
        }
        Fp x, y;
        if (!fp_from_bytes_checked(x, b)) return false;
        if (!fp_from_bytes_checked(y, b + 48)) return false;
        out.X = x;
        out.Y = y;
        out.Z = MONT_R;
        return g1_on_curve(out);
    }
    if (len == 48 && (b[0] & 0x80)) {
        uint8_t flags = b[0];
        if (flags & 0x40) {
            if (flags & 0x3F) return false;
            for (int i = 1; i < 48; i++)
                if (b[i]) return false;
            g1_set_inf(out);
            return true;
        }
        uint8_t xb[48];
        memcpy(xb, b, 48);
        xb[0] &= 0x1F;
        Fp x;
        if (!fp_from_bytes_checked(x, xb)) return false;
        Fp y2, y;
        fp_sq(y2, x);
        fp_mul(y2, y2, x);
        fp_add(y2, y2, B1_C);
        fp_sqrt_candidate(y, y2);
        Fp chk;
        fp_sq(chk, y);
        if (!fp_eq(chk, y2)) return false;
        Fp ny;
        fp_neg(ny, y);
        bool y_larger = fp_cmp_canon(y, ny) > 0;
        bool want_larger = (flags & 0x20) != 0;
        if (y_larger != want_larger) y = ny;
        out.X = x;
        out.Y = y;
        out.Z = MONT_R;
        return true;
    }
    return false;
}

static void g2_compress(uint8_t out[96], const G2& p) {
    if (g2_is_inf(p)) {
        memset(out, 0, 96);
        out[0] = 0xC0;
        return;
    }
    Fp2 x, y;
    g2_affine(x, y, p);
    fp_to_bytes_be(out, x.b);       // x1 first (big-endian lexicographic)
    fp_to_bytes_be(out + 48, x.a);  // then x0
    out[0] |= 0x80;
    // sign flag: (y1, y0) lexicographically larger than its negation
    Fp ny1, ny0;
    fp_neg(ny1, y.b);
    fp_neg(ny0, y.a);
    int c = fp_cmp_canon(y.b, ny1);
    bool larger = c > 0 || (c == 0 && fp_cmp_canon(y.a, ny0) > 0);
    if (larger) out[0] |= 0x20;
}

static bool g2_uncompress(G2& out, const uint8_t b[96]) {
    if (!(b[0] & 0x80)) return false;
    uint8_t flags = b[0];
    if (flags & 0x40) {
        if (flags & 0x3F) return false;
        for (int i = 1; i < 96; i++)
            if (b[i]) return false;
        g2_set_inf(out);
        return true;
    }
    uint8_t x1b[48];
    memcpy(x1b, b, 48);
    x1b[0] &= 0x1F;
    Fp2 x;
    if (!fp_from_bytes_checked(x.b, x1b)) return false;
    if (!fp_from_bytes_checked(x.a, b + 48)) return false;
    Fp2 y2, xsq, y;
    f2_sq(xsq, x);
    f2_mul(y2, xsq, x);
    f2_add(y2, y2, B2_C);
    if (!f2_sqrt(y, y2)) return false;
    Fp2 ny;
    f2_neg(ny, y);
    int c = fp_cmp_canon(y.b, ny.b);
    bool y_larger = c > 0 || (c == 0 && fp_cmp_canon(y.a, ny.a) > 0);
    bool want_larger = (flags & 0x20) != 0;
    if (y_larger != want_larger) y = ny;
    out.X = x;
    out.Y = y;
    out.Z = F2_ONE_C;
    return true;
}

// ===========================================================================
// Init: parse hex constants, build Montgomery context, self-check
// ===========================================================================

static std::vector<uint8_t> hex_bytes(const char* h) {
    std::string s(h);
    if (s.size() % 2) s = "0" + s;
    std::vector<uint8_t> out(s.size() / 2);
    auto nib = [](char c) -> int {
        if (c >= '0' && c <= '9') return c - '0';
        if (c >= 'a' && c <= 'f') return c - 'a' + 10;
        if (c >= 'A' && c <= 'F') return c - 'A' + 10;
        return 0;
    };
    for (size_t i = 0; i < out.size(); i++)
        out[i] = (uint8_t)((nib(s[2 * i]) << 4) | nib(s[2 * i + 1]));
    return out;
}

static void fp_from_hex(Fp& out, const char* h) {
    std::vector<uint8_t> b = hex_bytes(h);
    uint8_t full[48] = {0};
    memcpy(full + 48 - b.size(), b.data(), b.size());
    fp_from_bytes_be(out, full);
}

static void f2_from_hex(Fp2& out, const char* a_hex, const char* b_hex) {
    fp_from_hex(out.a, a_hex);
    fp_from_hex(out.b, b_hex);
}

#define P_HEX "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaaab"

static bool init_ok = false;
static std::once_flag init_flag;

static void bls_do_init() {
    // p limbs
    std::vector<uint8_t> pb = hex_bytes(P_HEX);
    uint8_t pfull[48] = {0};
    memcpy(pfull + 48 - pb.size(), pb.data(), pb.size());
    for (int i = 0; i < 6; i++) {
        uint64_t w = 0;
        for (int j = 0; j < 8; j++) w = (w << 8) | pfull[(5 - i) * 8 + j];
        P_LIMBS[i] = w;
    }
    // -p^-1 mod 2^64 by Newton iteration
    uint64_t p0 = P_LIMBS[0];
    uint64_t inv = 1;
    for (int i = 0; i < 6; i++) inv *= 2 - p0 * inv;
    P_INV64 = (uint64_t)(0 - inv);
    // R mod p: start at 1, double 384 times with reduction
    uint64_t r[6] = {1, 0, 0, 0, 0, 0};
    auto dbl_mod = [&](uint64_t a[6]) {
        uint64_t carry = 0;
        for (int i = 0; i < 6; i++) {
            uint64_t hi = a[i] >> 63;
            a[i] = (a[i] << 1) | carry;
            carry = hi;
        }
        if (carry || fp_geq_p(a)) fp_sub_p(a);
    };
    for (int i = 0; i < 384; i++) dbl_mod(r);
    memcpy(MONT_R.l, r, 48);
    for (int i = 0; i < 384; i++) dbl_mod(r);
    memcpy(MONT_R2.l, r, 48);
    memset(FP_ZERO_C.l, 0, 48);

    // exponent byte strings
    PM2_BYTES = hex_bytes(
        "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaaa9");
    PM1D2_BYTES = hex_bytes(
        "d0088f51cbff34d258dd3db21a5d66bb23ba5c279c2895fb39869507b587b120f55ffff58a9ffffdcff7fffffffd555");
    PP1D4_BYTES = hex_bytes(
        "680447a8e5ff9a692c6e9ed90d2eb35d91dd2e13ce144afd9cc34a83dac3d8907aaffffac54ffffee7fbfffffffeaab");
    R_ORDER_BYTES = hex_bytes(
        "73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001");
    HARD_EXP_BYTES = hex_bytes(
        "f686b3d807d01c0bd38c3195c899ed3cde88eeb996ca394506632528d6a9a2f230063cf081517f68f7764c28b6f8ae5a72bce8d63cb9f827eca0ba621315b2076995003fc77a17988f8761bdc51dc2378b9039096d1b767f17fcbde783765915c97f36c6f18212ed0b283ed237db421d160aeb6a1e79983774940996754c8c71a2629b0dea236905ce937335d5b68fa9912aae208ccf1e516c3f438e3ba79");
    H_EFF_BYTES = hex_bytes(
        "bc69f08f2ee75b3584c6a0ea91b352888e2a8e9145ad7689986ff031508ffe1329c2f178731db956d82bf015d1212b02ec0ec69d7477c1ae954cbc06689f6a359894c0adebbf6b4e8020005aaa95551");

    // field/tower constants
    F2_ZERO_C.a = FP_ZERO_C;
    F2_ZERO_C.b = FP_ZERO_C;
    F2_ONE_C.a = MONT_R;
    F2_ONE_C.b = FP_ZERO_C;
    XI_C.a = MONT_R;
    XI_C.b = MONT_R;
    F6_ZERO_C.c0 = F2_ZERO_C; F6_ZERO_C.c1 = F2_ZERO_C; F6_ZERO_C.c2 = F2_ZERO_C;
    F6_ONE_C.c0 = F2_ONE_C; F6_ONE_C.c1 = F2_ZERO_C; F6_ONE_C.c2 = F2_ZERO_C;
    F12_ONE_C.c0 = F6_ONE_C;
    F12_ONE_C.c1 = F6_ZERO_C;

    fp_set_small(B1_C, 4);
    Fp four;
    fp_set_small(four, 4);
    f2_mul_fp(B2_C, XI_C, four);

    // generators
    fp_from_hex(G1_GEN_C.X,
        "17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac586c55e83ff97a1aeffb3af00adb22c6bb");
    fp_from_hex(G1_GEN_C.Y,
        "08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3edd03cc744a2888ae40caa232946c5e7e1");
    G1_GEN_C.Z = MONT_R;
    f2_from_hex(G2_GEN_C.X,
        "024aa2b2f08f0a91260805272dc51051c6e47ad4fa403b02b4510b647ae3d1770bac0326a805bbefd48056c8c121bdb8",
        "13e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049334cf11213945d57e5ac7d055d042b7e");
    f2_from_hex(G2_GEN_C.Y,
        "0ce5d527727d6e118cc9cdc6da2e351aadfd9baa8cbdd3a76d429a695160d12c923ac9cc3baca289e193548608b82801",
        "0606c4a02ea734cc32acd2b02bc28b99cb3e287e85a763af267492ab572e99ab3f370d275cec1da1aaa9075ff05f79be");
    G2_GEN_C.Z = F2_ONE_C;

    // Frobenius gammas: xi^((p-1)/6) then powers
    std::vector<uint8_t> pm1d6 = hex_bytes(
        "45582fc5eeaa66f0c849bf3b5e1f223e613e1eb7deb831fe688231ad3c82906051caaaa72e3555549aa7ffffffff1c7");
    Fp2 g1e;
    f2_pow(g1e, XI_C, pm1d6.data(), pm1d6.size());
    FROB_GAMMA1[0] = F2_ONE_C;
    for (int k = 1; k < 6; k++)
        f2_mul(FROB_GAMMA1[k], FROB_GAMMA1[k - 1], g1e);

    // SSWU constants: A = 240u, B = 1012(1+u), Z = -(2+u)
    Fp c240, c1012, c2, c1;
    fp_set_small(c240, 240);
    fp_set_small(c1012, 1012);
    fp_set_small(c2, 2);
    fp_set_small(c1, 1);
    SSWU_A.a = FP_ZERO_C;
    SSWU_A.b = c240;
    SSWU_B.a = c1012;
    SSWU_B.b = c1012;
    fp_neg(SSWU_Z.a, c2);
    fp_neg(SSWU_Z.b, c1);

    // 3-isogeny coefficients (RFC 9380 appendix E.3)
    f2_from_hex(ISO_XNUM[0],
        "5c759507e8e333ebb5b7a9a47d7ed8532c52d39fd3a042a88b58423c50ae15d5c2638e343d9c71c6238aaaaaaaa97d6",
        "5c759507e8e333ebb5b7a9a47d7ed8532c52d39fd3a042a88b58423c50ae15d5c2638e343d9c71c6238aaaaaaaa97d6");
    f2_from_hex(ISO_XNUM[1], "0",
        "11560bf17baa99bc32126fced787c88f984f87adf7ae0c7f9a208c6b4f20a4181472aaa9cb8d555526a9ffffffffc71a");
    f2_from_hex(ISO_XNUM[2],
        "11560bf17baa99bc32126fced787c88f984f87adf7ae0c7f9a208c6b4f20a4181472aaa9cb8d555526a9ffffffffc71e",
        "8ab05f8bdd54cde190937e76bc3e447cc27c3d6fbd7063fcd104635a790520c0a395554e5c6aaaa9354ffffffffe38d");
    f2_from_hex(ISO_XNUM[3],
        "171d6541fa38ccfaed6dea691f5fb614cb14b4e7f4e810aa22d6108f142b85757098e38d0f671c7188e2aaaaaaaa5ed1",
        "0");
    f2_from_hex(ISO_XDEN[0], "0",
        "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaa63");
    f2_from_hex(ISO_XDEN[1], "c",
        "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaa9f");
    f2_from_hex(ISO_XDEN[2], "1", "0");
    f2_from_hex(ISO_YNUM[0],
        "1530477c7ab4113b59a4c18b076d11930f7da5d4a07f649bf54439d87d27e500fc8c25ebf8c92f6812cfc71c71c6d706",
        "1530477c7ab4113b59a4c18b076d11930f7da5d4a07f649bf54439d87d27e500fc8c25ebf8c92f6812cfc71c71c6d706");
    f2_from_hex(ISO_YNUM[1], "0",
        "5c759507e8e333ebb5b7a9a47d7ed8532c52d39fd3a042a88b58423c50ae15d5c2638e343d9c71c6238aaaaaaaa97be");
    f2_from_hex(ISO_YNUM[2],
        "11560bf17baa99bc32126fced787c88f984f87adf7ae0c7f9a208c6b4f20a4181472aaa9cb8d555526a9ffffffffc71c",
        "8ab05f8bdd54cde190937e76bc3e447cc27c3d6fbd7063fcd104635a790520c0a395554e5c6aaaa9354ffffffffe38f");
    f2_from_hex(ISO_YNUM[3],
        "124c9ad43b6cf79bfbf7043de3811ad0761b0f37a1e26286b0e977c69aa274524e79097a56dc4bd9e1b371c71c718b10",
        "0");
    // YDEN[0] = (p - 0x1b0)(1 + u)
    {
        Fp c1b0, t;
        fp_set_small(c1b0, 0x1b0);
        fp_neg(t, c1b0);
        ISO_YDEN[0].a = t;
        ISO_YDEN[0].b = t;
    }
    f2_from_hex(ISO_YDEN[1], "0",
        "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffa9d3");
    f2_from_hex(ISO_YDEN[2], "12",
        "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eabfffeb153ffffb9feffffffffaa99");
    f2_from_hex(ISO_YDEN[3], "1", "0");

    // self-check: xgcd inversion vs Fermat pow on a few values
    for (uint64_t v = 2; v < 6; v++) {
        Fp a, i1, i2;
        fp_set_small(a, v * 1234567891ULL + 7);
        fp_inv(i1, a);
        fp_inv_pow(i2, a);
        if (!fp_eq(i1, i2)) return;
    }
    {
        Fp i1, i2;
        fp_inv(i1, G1_GEN_C.X);
        fp_inv_pow(i2, G1_GEN_C.X);
        if (!fp_eq(i1, i2)) return;
    }
    // generators on curve and in subgroup; bilinearity smoke
    if (!g1_on_curve(G1_GEN_C) || !g2_on_curve(G2_GEN_C)) return;
    if (!g1_in_subgroup(G1_GEN_C) || !g2_in_subgroup(G2_GEN_C)) return;
    // e(2P, Q) == e(P, 2Q) (shared final exp form):
    // e(2P,Q) * e(P,2Q)^-1 == 1  <=>  e(2P,Q) * e(-P,2Q) == 1
    G1 p2;
    g1_double(p2, G1_GEN_C);
    G2 q2;
    g2_double(q2, G2_GEN_C);
    G1 pn;
    g1_neg(pn, G1_GEN_C);
    std::vector<G1> ps = {p2, pn};
    std::vector<G2> qs = {G2_GEN_C, q2};
    if (!pairing_product_is_one(ps, qs)) return;
    // non-degeneracy: e(P, Q) != 1
    std::vector<G1> ps2 = {G1_GEN_C};
    std::vector<G2> qs2 = {G2_GEN_C};
    if (pairing_product_is_one(ps2, qs2)) return;
    init_ok = true;
}

static bool ensure_init() {
    std::call_once(init_flag, bls_do_init);
    return init_ok;
}

}  // namespace

// ===========================================================================
// C API (bound with ctypes by cometbft_tpu_torch/native.py, bls())
// ===========================================================================

extern "C" {

// 0 = ok (library built, constants valid, pairing self-check passed)
int bls_init() { return ensure_init() ? 0 : -1; }

// sk (32B big-endian) -> 96B uncompressed G1 pubkey; 0 = ok
int bls_pubkey_from_sk(const uint8_t* sk, uint8_t* out96) {
    if (!ensure_init()) return -1;
    G1 p;
    g1_scalar_mul(p, G1_GEN_C, sk, 32);
    g1_serialize_uncompressed(out96, p);
    return 0;
}

// KeyValidate: parse (uncompressed or compressed), subgroup, not infinity
int bls_pubkey_validate(const uint8_t* pub, int64_t publen) {
    if (!ensure_init()) return 0;
    G1 p;
    if (!g1_deserialize(p, pub, (size_t)publen)) return 0;
    if (g1_is_inf(p)) return 0;
    return g1_in_subgroup(p) ? 1 : 0;
}

// sk (32B BE) + msg -> 96B compressed G2 signature; 0 = ok
int bls_sign(const uint8_t* sk, const uint8_t* msg, int64_t msg_len,
             uint8_t* out96) {
    if (!ensure_init()) return -1;
    G2 h, s;
    hash_to_g2(h, msg, (size_t)msg_len);
    g2_scalar_mul(s, h, sk, 32);
    g2_compress(out96, s);
    return 0;
}

// reference VerifySignature semantics; 1 = valid
int bls_verify(const uint8_t* pub, int64_t publen, const uint8_t* msg,
               int64_t msg_len, const uint8_t* sig96) {
    if (!ensure_init()) return 0;
    G1 pk;
    if (!g1_deserialize(pk, pub, (size_t)publen)) return 0;
    if (g1_is_inf(pk) || !g1_in_subgroup(pk)) return 0;
    G2 s;
    if (!g2_uncompress(s, sig96)) return 0;
    if (!g2_in_subgroup(s)) return 0;  // SigValidate(false): inf allowed
    G2 h;
    hash_to_g2(h, msg, (size_t)msg_len);
    G1 npk;
    g1_neg(npk, pk);
    std::vector<G1> ps = {npk, G1_GEN_C};
    std::vector<G2> qs = {h, s};
    return pairing_product_is_one(ps, qs) ? 1 : 0;
}

// n compressed 96B G2 signatures -> aggregate (compressed); 0 = ok
int bls_aggregate_sigs(const uint8_t* sigs, int64_t n, uint8_t* out96) {
    if (!ensure_init()) return -1;
    G2 acc;
    g2_set_inf(acc);
    for (int64_t i = 0; i < n; i++) {
        G2 s;
        if (!g2_uncompress(s, sigs + i * 96)) return -1;
        g2_add(acc, acc, s);
    }
    g2_compress(out96, acc);
    return 0;
}

// Basic-scheme AggregateVerify over distinct messages (distinctness is
// enforced by the Python caller); pubs: n*96 uncompressed, msgs
// concatenated with (n+1) offsets; 1 = valid
int bls_aggregate_verify(const uint8_t* pubs, const uint8_t* msgs,
                         const int64_t* msg_off, int64_t n,
                         const uint8_t* sig96) {
    if (!ensure_init()) return 0;
    if (n <= 0) return 0;
    G2 s;
    if (!g2_uncompress(s, sig96)) return 0;
    if (!g2_in_subgroup(s)) return 0;
    std::vector<G1> ps;
    std::vector<G2> qs;
    ps.reserve((size_t)n + 1);
    qs.reserve((size_t)n + 1);
    for (int64_t i = 0; i < n; i++) {
        G1 pk;
        if (!g1_deserialize(pk, pubs + i * 96, 96)) return 0;
        if (g1_is_inf(pk) || !g1_in_subgroup(pk)) return 0;
        G2 h;
        hash_to_g2(h, msgs + msg_off[i], (size_t)(msg_off[i + 1] - msg_off[i]));
        G1 npk;
        g1_neg(npk, pk);
        ps.push_back(npk);
        qs.push_back(h);
    }
    ps.push_back(G1_GEN_C);
    qs.push_back(s);
    return pairing_product_is_one(ps, qs) ? 1 : 0;
}

// hash_to_g2 exposed for differential tests vs the Python oracle; 0 = ok
int bls_hash_to_g2(const uint8_t* msg, int64_t msg_len, uint8_t* out96) {
    if (!ensure_init()) return -1;
    G2 h;
    hash_to_g2(h, msg, (size_t)msg_len);
    g2_compress(out96, h);
    return 0;
}

// SigValidate(false): parse + subgroup check, infinity allowed; 1 = ok
int bls_sig_validate(const uint8_t* sig96) {
    if (!ensure_init()) return 0;
    G2 s;
    if (!g2_uncompress(s, sig96)) return 0;
    return g2_in_subgroup(s) ? 1 : 0;
}

// k * point over serialized G1 (96B uncompressed in/out, infinity
// allowed), scalar big-endian arbitrary length; 0 = ok
int bls_g1_scalar_mul(const uint8_t* pt96, const uint8_t* k, int64_t klen,
                      uint8_t* out96) {
    if (!ensure_init()) return -1;
    G1 p;
    if (!g1_deserialize(p, pt96, 96)) return -1;
    G1 r;
    g1_scalar_mul(r, p, k, (size_t)klen);
    g1_serialize_uncompressed(out96, r);
    return 0;
}

// k * point, scalar big-endian arbitrary length; compressed in/out; 0 = ok
int bls_g2_scalar_mul_compressed(const uint8_t* pt96, const uint8_t* k,
                                 int64_t klen, uint8_t* out96) {
    if (!ensure_init()) return -1;
    G2 p;
    if (!g2_uncompress(p, pt96)) return -1;
    G2 r;
    g2_scalar_mul(r, p, k, (size_t)klen);
    g2_compress(out96, r);
    return 0;
}

// prod e(Pi, Qi) == 1 over serialized points (g1s: n*96 uncompressed,
// infinity allowed; g2s: n*96 compressed).  1 = product is one, 0 = not,
// -1 = parse failure.  Used by crypto/batch.BlsBatchVerifier for the RLC
// check with ONE shared final exponentiation.
int bls_pairing_product_is_one_serialized(const uint8_t* g1s,
                                          const uint8_t* g2s, int64_t n) {
    if (!ensure_init()) return -1;
    std::vector<G1> ps;
    std::vector<G2> qs;
    ps.reserve((size_t)n);
    qs.reserve((size_t)n);
    for (int64_t i = 0; i < n; i++) {
        G1 p;
        if (!g1_deserialize(p, g1s + i * 96, 96)) return -1;
        G2 q;
        if (!g2_uncompress(q, g2s + i * 96)) return -1;
        ps.push_back(p);
        qs.push_back(q);
    }
    return pairing_product_is_one(ps, qs) ? 1 : 0;
}

}  // extern "C"
