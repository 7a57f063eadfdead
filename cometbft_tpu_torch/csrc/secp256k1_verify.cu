// Batched secp256k1 ECDSA verification for Hopper (sm_90a).
//
// Replaces: the XLA device program of cometbft_tpu/ops/secp_verify.py
// (`_ladder_kernel`, jax.jit at :116-121: u1*G + u2*Q over fpgen's 21 x
// 13-bit Montgomery limbs and wcurve's complete formulas), together with
// the host work around it there: decompressing Q, packing limbs and bit
// rows, and the per-lane inversion and compare of the result.  Raw bytes
// in, one accept word per signature out:
//
//   accept = ok && Q decompresses && R' != O && x(R') = r (mod n),
//   R' = u1*G + u2*Q
//
// with u1 = e/s, u2 = r/s (mod n) computed on the host
// (ops/secp_verify.prepare_batch), which also applies the structural rules
// (lengths, 0 < r < n, 0 < s <= n/2, prefix, x < p) and sets `ok`.
//
// What bounds it on this card: integer multiplies.  A signature costs the
// square root of decompression (253 squares + 13 multiplies) and a scalar
// walk of doublings (6 squares + 6 multiplies) and additions (12
// multiplies), field products of 72 and 44 32x32->64-bit products, against
// 164 bytes of input and output: the bound is the SMs' integer multiply
// rate (chip_smoke.py prints it from the work the function needs, and this
// kernel's own tally from a host build).
//
// What the design does about it: four threads per signature over short
// scalars.
// * The GLV split, on the card.  u1 = a0 + a1*2^128 in two unsigned 128-bit
//   halves, and u2 = k1 + k2*lambda (mod n) with |k1|, |k2| < 2^129 by Babai
//   rounding against libsecp256k1's reduced basis: c1, c2 = round(u2*g /
//   2^384) from two 256x256-bit products, then k1 = u2 - c1*a1 - c2*a2 and
//   k2 = -c1*b1 - c2*a1, exact in 160-bit two's complement because they are
//   small.  R' = a0*G + a1*(2^128*G) + |k1|*(+-Q) + |k2|*(+-lambda*Q),
//   with lambda*(x, y) = (beta*x, y); the sign of a negative k negates
//   every digit of |k|.
// * A quad of four adjacent threads per signature: thread j of the quad
//   computes s_j*P_j, its scalar and base point of the four above.  The
//   four run the same instruction stream on independent walks: each
//   decompresses Q (whose verdict the lane needs) and computes the split,
//   then picks its scalar and point by j with selects.  They exchange
//   nothing until the end, where two complete additions through
//   __shfl_xor_sync under the quad's own mask give R' in every thread.
// * Signed radix-8 digits in [-4, 4], Booth's recoding d_i = b(3i-1) +
//   b(3i) + 2*b(3i+1) - 4*b(3i+2): 44 positions over 129 bits, the same for
//   every thread, so each runs 129 doublings and 43 additions in step with
//   its warp.  Each thread's table {1..4}*P_j sits in shared memory,
//   limb-major with the thread index innermost, so a warp's reads of one
//   limb fall in 32 distinct banks whatever the digits.  Digit 0 reads the
//   identity (0 : 1 : 0), which the complete addition takes as it is; a
//   negative digit negates Y.
// * Registers: the launch bounds ask for MIN_BLOCKS blocks of two warps per
//   SM, three warps on some of its four partitions, so ptxas caps a thread
//   at 168 registers (16,384 / 3 / 32), and a complete addition or doubling
//   needs nearly all of them.  So nothing lives in registers across the
//   long stretches of field arithmetic: the thread's column of the shared
//   block holds, after its table, the digit recoding's state, the sign and
//   the key's verdict; an addition fetches its second operand's
//   coordinates (from the table, or from the partner thread by shuffle)
//   where the formula reads them; and the lane's index is read afresh
//   after the walk.  No register spills to local memory.
// * Field elements are 8 x 32-bit limbs, little-endian, any value below
//   2^256 (not necessarily below p); products are 64-bit, schoolbook, and
//   reduced by 2^256 = 2^32 + 977 (mod p): two folds, no Montgomery form.
//   Values are fully reduced only where a decision needs them: the parity
//   of y, y^2 = y2, Z = 0 and the final compare.  Points use RCB15's
//   complete formulas for a = 0, b3 = 21, the JAX module's sequence of field
//   operations.
// * The compare needs no inversion: Z != 0 and X = r*Z, or r + n < p and
//   X = (r + n)*Z.
// * 64-thread blocks (16 signatures) with 26,368 bytes of columns, at
//   least MIN_BLOCKS resident per SM: a 10,240-signature commit is 640
//   blocks, one wave on 132 SMs.  A quad past the batch's end works on the last
//   signature's bytes and skips the store, so no thread named in a mask has
//   exited; a lane with `ok` clear writes 0 (its quad returns at once,
//   together).
//
// Without __CUDACC__ the same source builds for the host: each lane runs
// the quad's four threads in turn, then the combine as each of the four
// does it, so the split, the recoding, the partial points, the formulas
// and the verify are checked against Python integers on a machine with no
// card; with SECP_TALLY the host build counts the field multiplies,
// squares and small multiplies of all four threads.

#include <stdint.h>

#if defined(__CUDACC__)
#define DEV __device__ __forceinline__
#define MEMBER __device__ __forceinline__
#define CONST_MEM __constant__
#else
#define DEV static inline
#define MEMBER inline
#define CONST_MEM static const
#endif

#define THREADS 64          // threads per block
#define SIGS (THREADS / 4)  // signatures per block
// Blocks per SM the compiler must fit (__launch_bounds__): a
// 10,240-signature commit needs ceil(40,960 / 132 / 64) = 5 for one wave.
#define MIN_BLOCKS 5
#define POSITIONS 44  // signed radix-8 digits of a scalar below 2^129
#define ENTRIES 4     // table {1..4}*P
#define ENTRY_WORDS 24
// A thread's column of the shared block: its table, then the digit
// recoding's state (five words and the sign), then the key's verdict.
#define SCALAR_AT (ENTRIES * ENTRY_WORDS)
#define SIGN_AT (SCALAR_AT + 5)
#define KEY_AT (SIGN_AT + 1)
#define COL_WORDS (KEY_AT + 1)

#if defined(SECP_TALLY) && !defined(__CUDACC__)
static long long g_tally_mul = 0, g_tally_sq = 0, g_tally_small = 0;
#define TALLY(counter) ((counter)++)
#else
#define TALLY(counter) ((void)0)
#endif

namespace {

struct fe {
  uint32_t v[8];  // little-endian limbs; value below 2^256
};

struct pt {
  fe x, y, z;  // projective (X : Y : Z)
};

// 2^256 - p = 2^32 + 977: the fold constant's low word
#define FOLD_LO 977u

CONST_MEM uint32_t P_LIMBS[8] = {0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu,
                                 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                 0xFFFFFFFFu, 0xFFFFFFFFu};
// 2p, nine limbs (for subtraction without a borrow)
CONST_MEM uint32_t P2_LIMBS[9] = {0xFFFFF85Eu, 0xFFFFFFFDu, 0xFFFFFFFFu,
                                  0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                  0xFFFFFFFFu, 0xFFFFFFFFu, 1u};
CONST_MEM uint32_t N_LIMBS[8] = {0xD0364141u, 0xBFD25E8Cu, 0xAF48A03Bu,
                                 0xBAAEDCE6u, 0xFFFFFFFEu, 0xFFFFFFFFu,
                                 0xFFFFFFFFu, 0xFFFFFFFFu};
// p - n
CONST_MEM uint32_t PMN_LIMBS[8] = {0x2FC9BAEEu, 0x402DA172u, 0x50B75FC4u,
                                   0x45512319u, 0x00000001u, 0u, 0u, 0u};
CONST_MEM uint32_t GX_LIMBS[8] = {0x16F81798u, 0x59F2815Bu, 0x2DCE28D9u,
                                  0x029BFCDBu, 0xCE870B07u, 0x55A06295u,
                                  0xF9DCBBACu, 0x79BE667Eu};
CONST_MEM uint32_t GY_LIMBS[8] = {0xFB10D4B8u, 0x9C47D08Fu, 0xA6855419u,
                                  0xFD17B448u, 0x0E1108A8u, 0x5DA4FBFCu,
                                  0x26A3C465u, 0x483ADA77u};

// 2^128 * G
CONST_MEM uint32_t G128X_LIMBS[8] = {0x9EC4C0DAu, 0x1B7B444Cu, 0x723EA335u,
                                     0xE88C5678u, 0x981F162Eu, 0x9239C1ADu,
                                     0xF63B5F33u, 0x8F68B9D2u};
CONST_MEM uint32_t G128Y_LIMBS[8] = {0x501FFF82u, 0xF23CBF79u, 0x95510BFDu,
                                     0xBBEA2CFEu, 0xB6BE215Du, 0xDE1D90C2u,
                                     0xBA063986u, 0x662A9F2Du};
// beta: lambda*(x, y) = (beta*x, y)
CONST_MEM uint32_t BETA_LIMBS[8] = {0x719501EEu, 0xC1396C28u, 0x12F58995u,
                                    0x9CF04975u, 0xAC3434E9u, 0x6E64479Eu,
                                    0x657C0710u, 0x7AE96A2Bu};
// The GLV split (libsecp256k1's basis of {(a, b): a + b*lambda = 0 mod n}:
// (a1, b1), (a2, a1)): g1 = round(2^384 * a1 / n), g2 = round(2^384 * -b1 /
// n), and a1, -b1, a2 in five words.
CONST_MEM uint32_t G1_LIMBS[8] = {0x45DBB031u, 0xE893209Au, 0x71E8CA7Fu,
                                  0x3DAA8A14u, 0x9284EB15u, 0xE86C90E4u,
                                  0xA7D46BCDu, 0x3086D221u};
CONST_MEM uint32_t G2_LIMBS[8] = {0x8AC47F71u, 0x1571B4AEu, 0x9DF506C6u,
                                  0x221208ACu, 0x0ABFE4C4u, 0x6F547FA9u,
                                  0x010E8828u, 0xE4437ED6u};
CONST_MEM uint32_t A1_LIMBS[5] = {0x9284EB15u, 0xE86C90E4u, 0xA7D46BCDu,
                                  0x3086D221u, 0u};
CONST_MEM uint32_t MB1_LIMBS[5] = {0x0ABFE4C3u, 0x6F547FA9u, 0x010E8828u,
                                   0xE4437ED6u, 0u};
CONST_MEM uint32_t A2_LIMBS[5] = {0x9D44CFD8u, 0x57C1108Du, 0xA8E2F3F6u,
                                  0x14CA50F7u, 1u};

// --- field --------------------------------------------------------------

DEV void fe_set_const(fe& r, const uint32_t* c) {
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = c[i];
}

DEV void fe_set_small(fe& r, uint32_t k) {
  r.v[0] = k;
#pragma unroll
  for (int i = 1; i < 8; i++) r.v[i] = 0;
}

// r + top * 2^256 reduced below 2^256 (top < 2^34): top * (2^32 + 977)
// added in, then the carry out of that (0 or 1), which leaves a small
// value, folded once more.
DEV void fe_fold(fe& r, uint64_t top) {
  uint64_t c = (uint64_t)r.v[0] + top * FOLD_LO;
  r.v[0] = (uint32_t)c;
  c = (c >> 32) + (uint64_t)r.v[1] + top;
  r.v[1] = (uint32_t)c;
  c >>= 32;
#pragma unroll
  for (int i = 2; i < 8; i++) {
    c += r.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  uint64_t d = (uint64_t)r.v[0] + c * FOLD_LO;
  r.v[0] = (uint32_t)d;
  d = (d >> 32) + (uint64_t)r.v[1] + c;
  r.v[1] = (uint32_t)d;
  d >>= 32;
#pragma unroll
  for (int i = 2; i < 8; i++) {
    d += r.v[i];
    r.v[i] = (uint32_t)d;
    d >>= 32;
  }
}

DEV void fe_add(fe& r, const fe& a, const fe& b) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.v[i] + b.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_fold(r, c);
}

// a - b as a + 2p - b (nine limbs, never negative since b < 2^256 < 2p),
// folded.
DEV void fe_sub(fe& r, const fe& a, const fe& b) {
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (int64_t)a.v[i] + P2_LIMBS[i] - b.v[i];
    r.v[i] = (uint32_t)c;
    c >>= 32;  // arithmetic: a borrow is -1
  }
  fe_fold(r, (uint64_t)(c + P2_LIMBS[8]));
}

DEV void fe_neg(fe& r, const fe& a) {
  fe z;
  fe_set_small(z, 0);
  fe_sub(r, z, a);
}

DEV void fe_mul_small(fe& r, const fe& a, uint32_t k) {
  TALLY(g_tally_small);
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a.v[i] * k;
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_fold(r, c);
}

// t (16 limbs, below 2^512) reduced: L + H * 2^256 = L + H * 977 + H * 2^32.
DEV void fe_reduce512(fe& r, const uint32_t* t) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)t[i] + (uint64_t)t[8 + i] * FOLD_LO;
    if (i > 0) c += t[7 + i];
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_fold(r, c + t[15]);
}

DEV void fe_mul(fe& r, const fe& a, const fe& b) {
  TALLY(g_tally_mul);
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)a.v[i] * b.v[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  fe_reduce512(r, t);
}

DEV void fe_sqr(fe& r, const fe& a) {
  TALLY(g_tally_sq);
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
  // cross products a_i a_j, i < j
#pragma unroll
  for (int i = 0; i < 7; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < 8; j++) {
      c += (uint64_t)a.v[i] * a.v[j] + t[i + j];
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  // doubled
#pragma unroll
  for (int k = 15; k > 0; k--) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
  t[0] <<= 1;
  // plus the squares a_i^2 on the diagonal
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint64_t sq = (uint64_t)a.v[i] * a.v[i];
    c += (uint64_t)t[2 * i] + (uint32_t)sq;
    t[2 * i] = (uint32_t)c;
    c = (c >> 32) + (uint64_t)t[2 * i + 1] + (sq >> 32);
    t[2 * i + 1] = (uint32_t)c;
    c >>= 32;
  }
  fe_reduce512(r, t);
}

DEV void fe_sqr_n(fe& r, const fe& a, int n) {
  fe_sqr(r, a);
  for (int i = 1; i < n; i++) fe_sqr(r, r);
}

// The fully reduced value (below p): p = 2^256 - (2^32 + 977), so r >= p
// iff r + 2^32 + 977 carries out of 2^256, and then that sum is r - p.
DEV void fe_normalize(fe& r) {
  fe s;
  uint64_t c = (uint64_t)r.v[0] + FOLD_LO;
  s.v[0] = (uint32_t)c;
  c = (c >> 32) + (uint64_t)r.v[1] + 1;
  s.v[1] = (uint32_t)c;
  c >>= 32;
#pragma unroll
  for (int i = 2; i < 8; i++) {
    c += r.v[i];
    s.v[i] = (uint32_t)c;
    c >>= 32;
  }
  const bool ge = c != 0;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = ge ? s.v[i] : r.v[i];
}

DEV bool fe_is_zero(fe a) {
  fe_normalize(a);
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a.v[i];
  return acc == 0;
}

DEV bool fe_equal(const fe& a, const fe& b) {
  fe d;
  fe_sub(d, a, b);
  return fe_is_zero(d);
}

// a < c for 256-bit integers (c a constant), from the borrow of a - c.
DEV bool lt_const(const fe& a, const uint32_t* c) {
  int64_t b = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    b += (int64_t)a.v[i] - c[i];
    b >>= 32;
  }
  return b < 0;
}

// a^((p+1)/4): libsecp256k1's addition chain (blocks of 1s of lengths 2,
// 22 and 223 in the exponent), 253 squares and 13 multiplies; the same
// chain as ops/secp_verify.sqrt_candidate.
DEV void fe_sqrt(fe& r, const fe& a) {
  fe x2, x3, x6, x11, x22, t;
  fe_sqr(x2, a);
  fe_mul(x2, x2, a);
  fe_sqr(x3, x2);
  fe_mul(x3, x3, a);
  fe_sqr_n(x6, x3, 3);
  fe_mul(x6, x6, x3);
  fe_sqr_n(t, x6, 3);  // x9
  fe_mul(t, t, x3);
  fe_sqr_n(x11, t, 2);
  fe_mul(x11, x11, x2);
  fe_sqr_n(x22, x11, 11);
  fe_mul(x22, x22, x11);
  fe_sqr_n(x6, x22, 22);  // x44 (x6 is free)
  fe_mul(x6, x6, x22);
  fe_sqr_n(t, x6, 44);  // x88
  fe_mul(t, t, x6);
  fe_sqr_n(x11, t, 88);  // x176 (x11 is free)
  fe_mul(x11, x11, t);
  fe_sqr_n(t, x11, 44);  // x220
  fe_mul(t, t, x6);
  fe_sqr_n(t, t, 3);  // x223
  fe_mul(t, t, x3);
  fe_sqr_n(t, t, 23);
  fe_mul(t, t, x22);
  fe_sqr_n(t, t, 6);
  fe_mul(t, t, x2);
  fe_sqr_n(r, t, 2);
}

DEV void fe_from_be(fe& r, const uint8_t* b) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint8_t* w = b + 28 - 4 * i;
    r.v[i] = ((uint32_t)w[0] << 24) | ((uint32_t)w[1] << 16) |
             ((uint32_t)w[2] << 8) | (uint32_t)w[3];
  }
}

DEV void fe_select(fe& r, bool c, const fe& a, const fe& b) {
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = c ? a.v[i] : b.v[i];
}

// --- curve: RCB15 complete formulas, a = 0, b3 = 21 -------------------------

#define B3 21u

// the shared tail of addition and doubling (wcurve.Curve._tail)
DEV void pt_tail(pt& r, const fe& t0, fe& t1, fe& t2, const fe& t3,
                 const fe& t4, const fe& xz) {
  fe s0, z3, y3, u, w;
  fe_add(s0, t0, t0);
  fe_add(s0, s0, t0);  // 3 * X1X2
  fe_mul_small(t2, t2, B3);
  fe_add(z3, t1, t2);
  fe_sub(t1, t1, t2);
  fe_mul_small(y3, xz, B3);
  fe_mul(u, t3, t1);
  fe_mul(w, t4, y3);
  fe_sub(r.x, u, w);
  fe_mul(u, t1, z3);
  fe_mul(w, y3, s0);
  fe_add(r.y, u, w);
  fe_mul(u, z3, t4);
  fe_mul(w, s0, t3);
  fe_add(r.z, u, w);
}

// r = p + q, with q's coordinates fetched where the formula reads them
// (each three times), so that q holds no registers across the addition: q
// is a source with x(f), y(f), z(f) that write a coordinate into f.
template <class Src>
DEV void pt_add_from(pt& r, const pt& p, const Src& q) {
  fe t0, t1, t2, t3, t4, xz, a, b, c;
  q.x(b);
  fe_mul(t0, p.x, b);
  q.y(b);
  fe_mul(t1, p.y, b);
  q.z(b);
  fe_mul(t2, p.z, b);
  fe_add(a, p.x, p.y);
  q.x(b);
  q.y(c);
  fe_add(b, b, c);
  fe_mul(t3, a, b);
  fe_add(a, t0, t1);
  fe_sub(t3, t3, a);  // X1Y2 + X2Y1
  fe_add(a, p.y, p.z);
  q.y(b);
  q.z(c);
  fe_add(b, b, c);
  fe_mul(t4, a, b);
  fe_add(a, t1, t2);
  fe_sub(t4, t4, a);  // Y1Z2 + Y2Z1
  fe_add(a, p.x, p.z);
  q.x(b);
  q.z(c);
  fe_add(b, b, c);
  fe_mul(xz, a, b);
  fe_add(a, t0, t2);
  fe_sub(xz, xz, a);  // X1Z2 + X2Z1
  pt_tail(r, t0, t1, t2, t3, t4, xz);
}

// a point held in registers
struct src_regs {
  const pt& p;
  MEMBER void x(fe& r) const { r = p.x; }
  MEMBER void y(fe& r) const { r = p.y; }
  MEMBER void z(fe& r) const { r = p.z; }
};

DEV void pt_add(pt& r, const pt& p, const pt& q) {
  pt_add_from(r, p, src_regs{q});
}

DEV void pt_double(pt& r, const pt& p) {
  fe t0, t1, t2, t3, t4, xz, a;
  fe_sqr(t0, p.x);
  fe_sqr(t1, p.y);
  fe_sqr(t2, p.z);
  fe_add(a, p.x, p.y);
  fe_sqr(t3, a);
  fe_add(a, t0, t1);
  fe_sub(t3, t3, a);  // 2XY
  fe_add(a, p.y, p.z);
  fe_sqr(t4, a);
  fe_add(a, t1, t2);
  fe_sub(t4, t4, a);  // 2YZ
  fe_add(a, p.x, p.z);
  fe_sqr(xz, a);
  fe_add(a, t0, t2);
  fe_sub(xz, xz, a);  // 2XZ
  pt_tail(r, t0, t1, t2, t3, t4, xz);
}

// --- the GLV split -------------------------------------------------------

// c = round(k * g / 2^384) for 256-bit k and g: words 12-15 of the product
// plus its bit 383 (c < 2^128 for the split's g and any k < 2^256).
DEV void round_shift384(uint32_t* c, const fe& k, const uint32_t* g) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t s = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      s += (uint64_t)k.v[i] * g[j] + t[i + j];
      t[i + j] = (uint32_t)s;
      s >>= 32;
    }
    t[i + 8] = (uint32_t)s;
  }
  uint64_t s = t[11] >> 31;
#pragma unroll
  for (int i = 0; i < 4; i++) {
    s += t[12 + i];
    c[i] = (uint32_t)s;
    s >>= 32;
  }
}

// r = a * b mod 2^160 (a four words, b five).
DEV void mul_lo5(uint32_t* r, const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int i = 0; i < 5; i++) r[i] = 0;
#pragma unroll
  for (int i = 0; i < 4; i++) {
    uint64_t s = 0;
#pragma unroll
    for (int j = 0; i + j < 5; j++) {
      s += (uint64_t)a[i] * b[j] + r[i + j];
      r[i + j] = (uint32_t)s;
      s >>= 32;
    }
  }
}

// r = a - b mod 2^160.
DEV void sub5(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  int64_t s = 0;
#pragma unroll
  for (int i = 0; i < 5; i++) {
    s += (int64_t)a[i] - b[i];
    r[i] = (uint32_t)s;
    s >>= 32;  // arithmetic: a borrow is -1
  }
}

// A 160-bit two's complement value as its sign and magnitude.
DEV bool abs5(uint32_t* r) {
  const bool neg = (r[4] >> 31) != 0;
  uint32_t z[5] = {0, 0, 0, 0, 0}, m[5];
  sub5(m, z, r);
#pragma unroll
  for (int i = 0; i < 5; i++) r[i] = neg ? m[i] : r[i];
  return neg;
}

// k = k1 + k2*lambda (mod n) with |k1|, |k2| < 2^128 (Babai rounding: c1
// and c2 are off their real quotients by at most 1/2 + 2^-128, so |k1| <=
// (|a1| + |a2|)/2 + 1 and |k2| <= (|b1| + |a1|)/2 + 1).  m1, m2: the
// magnitudes; returns the signs in neg1, neg2.
DEV void glv_split(uint32_t* m1, bool& neg1, uint32_t* m2, bool& neg2,
                   const fe& k) {
  uint32_t c1[4], c2[4], x[5], y[5];
  round_shift384(c1, k, G1_LIMBS);
  round_shift384(c2, k, G2_LIMBS);
  mul_lo5(x, c1, A1_LIMBS);
  mul_lo5(y, c2, A2_LIMBS);
  sub5(m1, k.v, x);
  sub5(m1, m1, y);  // k - c1*a1 - c2*a2
  mul_lo5(x, c1, MB1_LIMBS);
  mul_lo5(y, c2, A1_LIMBS);
  sub5(m2, x, y);  // -c1*b1 - c2*a1
  neg1 = abs5(m1);
  neg2 = abs5(m2);
}

// --- Booth's signed radix-8 recoding ---------------------------------------

// The digits of a scalar s below 2^129, most significant first: d_i =
// b(3i-1) + b(3i) + 2*b(3i+1) - 4*b(3i+2) with b(-1) = 0, so d_i is in
// [-4, 4] and s = sum d_i 8^i over i = 0..43.  The state w (five words,
// w[i * stride]; on the card in the thread's shared column, so that the walk
// holds no register for it) is 2s shifted left by 3 for each digit taken;
// the next digit's window is its bits 129..132.
DEV void digits_init(uint32_t* w, int stride, const uint32_t* s) {
#pragma unroll
  for (int i = 4; i > 0; i--) w[i * stride] = (s[i] << 1) | (s[i - 1] >> 31);
  w[0] = s[0] << 1;
}

DEV int digits_next(uint32_t* w, int stride) {
  uint32_t v[5];
#pragma unroll
  for (int i = 0; i < 5; i++) v[i] = w[i * stride];
  const uint32_t win = (v[4] >> 1) & 15u;
#pragma unroll
  for (int i = 4; i > 0; i--) w[i * stride] = (v[i] << 3) | (v[i - 1] >> 29);
  w[0] = v[0] << 3;
  return (int)(win & 1u) + (int)((win >> 1) & 3u) - 4 * (int)(win >> 3);
}

// A word of the thread's column, read from memory at each call: the
// compiler may not carry a stored value in a register across the walk.
DEV uint32_t col_read(const uint32_t* col, int stride, int at) {
  return ((const volatile uint32_t*)col)[at * stride];
}

// --- a thread's table {1..4}*P --------------------------------------------

// Entry e (0..3 for 1..4 * P), coordinate c, limb l of a thread's table is
// col[((e * 3 + c) * 8 + l) * stride]: on the card `col` is the thread's
// column of the block's shared table and stride THREADS.
DEV void fe_store(uint32_t* at, int stride, const fe& a) {
#pragma unroll
  for (int l = 0; l < 8; l++) at[l * stride] = a.v[l];
}

DEV void fe_load(fe& a, const uint32_t* at, int stride) {
#pragma unroll
  for (int l = 0; l < 8; l++) a.v[l] = at[l * stride];
}

DEV void table_put(uint32_t* col, int stride, int e, const pt& p) {
  fe_store(col + (e * 3 + 0) * 8 * stride, stride, p.x);
  fe_store(col + (e * 3 + 1) * 8 * stride, stride, p.y);
  fe_store(col + (e * 3 + 2) * 8 * stride, stride, p.z);
}

// d*P for a digit d in [-4, 4], read from the table as pt_add_from reads
// it: the identity (0 : 1 : 0) for 0, Y negated below 0.
struct src_table {
  const uint32_t* at;  // the entry of |d|
  int stride;
  bool zero, neg;
  MEMBER src_table(const uint32_t* col, int stride_, int d)
      : stride(stride_), zero(d == 0), neg(d < 0) {
    const int e = d < 0 ? -d : d;
    at = col + (e > 0 ? e - 1 : 0) * ENTRY_WORDS * stride;
  }
  MEMBER void x(fe& r) const {
    fe_load(r, at, stride);
    fe_select(r, zero, fe{}, r);
  }
  MEMBER void y(fe& r) const {
    fe_load(r, at + 8 * stride, stride);
    fe n;
    fe_neg(n, r);
    fe_select(r, neg, n, r);
    fe_set_small(n, 1);
    fe_select(r, zero, n, r);
  }
  MEMBER void z(fe& r) const {
    fe_load(r, at + 16 * stride, stride);
    fe_select(r, zero, fe{}, r);
  }
};

// --- one thread of a quad ----------------------------------------------------

// The base point of thread j (0..3) of a lane's quad: G, 2^128*G, Q,
// lambda*Q = (beta*x, y).
DEV void quad_point(pt& p, int j, const fe& qx, const fe& qy) {
  fe bx, t;
  fe_set_const(t, BETA_LIMBS);
  fe_mul(bx, qx, t);
  fe_set_const(p.x, GX_LIMBS);
  fe_set_const(t, G128X_LIMBS);
  fe_select(p.x, j == 1, t, p.x);
  fe_select(p.x, j == 2, qx, p.x);
  fe_select(p.x, j == 3, bx, p.x);
  fe_set_const(p.y, GY_LIMBS);
  fe_set_const(t, G128Y_LIMBS);
  fe_select(p.y, j == 1, t, p.y);
  fe_select(p.y, j >= 2, qy, p.y);
  fe_set_small(p.z, 1);
}

// The scalar of thread j: u1's low half, u1's high half, |k1|, |k2|;
// returns whether it stands for the negative k1 or k2 (its base point's
// sign, folded into the digits).
DEV bool quad_scalar(uint32_t* s, int j, const uint8_t* u1,
                     const uint8_t* u2) {
  fe k, a;
  fe_from_be(k, u2);
  uint32_t m1[5], m2[5];
  bool neg1, neg2;
  glv_split(m1, neg1, m2, neg2, k);
  fe_from_be(a, u1);
#pragma unroll
  for (int i = 0; i < 5; i++) {
    const uint32_t lo = i < 4 ? a.v[i] : 0u, hi = i < 4 ? a.v[4 + i] : 0u;
    s[i] = j == 0 ? lo : j == 1 ? hi : j == 2 ? m1[i] : m2[i];
  }
  return (j == 2 && neg1) || (j == 3 && neg2);
}

// Thread j of a lane's quad: take its scalar into the digit state of its
// column, decompress Q, take its base point, build {1..4}*P in its column
// and walk the digits.  `part` = s_j*P_j, the sign of k1 or k2 included
// (a negative k negates every digit); the key's verdict (prefix, x < p, on
// the curve) is left at KEY_AT in the column.  What lives across the long
// stretches of field arithmetic sits in the column, not in registers.
DEV void quad_thread(pt& part, int j, const uint8_t* q33, const uint8_t* u1,
                     const uint8_t* u2, uint32_t* col, int stride) {
  uint32_t sc[5];
  col[SIGN_AT * stride] = quad_scalar(sc, j, u1, u2) ? 1u : 0u;
  digits_init(col + SCALAR_AT * stride, stride, sc);

  // decompress Q
  fe qx, qy, y2, s;
  fe_from_be(qx, q33 + 1);
  const bool x_ok = lt_const(qx, P_LIMBS);
  fe_sqr(y2, qx);
  fe_mul(y2, y2, qx);
  fe_set_small(s, 7);
  fe_add(y2, y2, s);
  fe_sqrt(qy, y2);
  fe_sqr(s, qy);
  const bool on_curve = fe_equal(s, y2);
  fe_normalize(qy);
  fe_neg(s, qy);
  fe_select(qy, (qy.v[0] & 1u) != (uint32_t)(q33[0] & 1), s, qy);
  const bool prefix_ok = q33[0] == 2 || q33[0] == 3;
  col[KEY_AT * stride] = x_ok && prefix_ok && on_curve;

  // the table {1..4}*P
  pt p, p2, e;
  quad_point(p, j, qx, qy);
  table_put(col, stride, 0, p);
  pt_double(p2, p);
  table_put(col, stride, 1, p2);
  pt_add_from(e, p2, src_table(col, stride, 1));
  table_put(col, stride, 2, e);
  pt_double(e, p2);
  table_put(col, stride, 3, e);

  // the walk, most significant digit first: 8*acc + d*P
  uint32_t* w = col + SCALAR_AT * stride;
  const int sign = col_read(col, stride, SIGN_AT) ? -1 : 1;
  const src_table top(col, stride, sign * digits_next(w, stride));
  top.x(part.x);
  top.y(part.y);
  top.z(part.z);
#pragma unroll 1
  for (int pos = POSITIONS - 2; pos >= 0; pos--) {
#pragma unroll 1
    for (int k = 0; k < 3; k++) {
      pt_double(e, part);
      part = e;
    }
    pt_add_from(part, e, src_table(col, stride, sign * digits_next(w, stride)));
  }
}

// x(R') = r (mod n) without an inversion, for R' = acc.
DEV int compare(const pt& acc, const uint8_t* rb, bool key_ok) {
  fe r, rn, t;
  fe_from_be(r, rb);
  fe_mul(t, r, acc.z);
  bool hit = fe_equal(acc.x, t);
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)r.v[i] + N_LIMBS[i];
    rn.v[i] = (uint32_t)c;
    c >>= 32;
  }
  // (r + n)*Z on every lane, so that every lane does the same work; it
  // counts only where r + n < p (no carry out above)
  fe_mul(t, rn, acc.z);
  hit = hit || (lt_const(r, PMN_LIMBS) && fe_equal(acc.x, t));
  return (key_ok && !fe_is_zero(acc.z) && hit) ? 1 : 0;
}

}  // namespace

#if defined(__CUDACC__)

#define QUAD_MASK (0xFu << (threadIdx.x & 28))  // this thread's quad

// threadIdx.x, read from its special register at each call (the compiler
// may not keep one reading alive in a register across the walk)
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// The point p as held by the thread (this one ^ m) of the same quad, read
// as pt_add_from reads it.
struct src_quad {
  const pt& p;
  int m;
  MEMBER void take(fe& r, const fe& a) const {
    const unsigned mask = QUAD_MASK;
#pragma unroll
    for (int l = 0; l < 8; l++) r.v[l] = __shfl_xor_sync(mask, a.v[l], m, 4);
  }
  MEMBER void x(fe& r) const { take(r, p.x); }
  MEMBER void y(fe& r) const { take(r, p.y); }
  MEMBER void z(fe& r) const { take(r, p.z); }
};

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    secp256k1_verify_kernel(const uint8_t* __restrict__ q33,
                            const uint8_t* __restrict__ u1,
                            const uint8_t* __restrict__ u2,
                            const uint8_t* __restrict__ r,
                            const uint8_t* __restrict__ ok,
                            int32_t* __restrict__ out, int n) {
  __shared__ uint32_t table[COL_WORDS][THREADS];
  int t = thread_index();
  int lane = blockIdx.x * SIGS + (t >> 2);
  int i = lane < n ? lane : n - 1;  // a padding quad: the last lane
  if (!ok[i]) {  // the whole quad returns
    if ((t & 3) == 0 && lane < n) out[lane] = 0;
    return;
  }
  pt part, sum;
  quad_thread(part, t & 3, q33 + 33 * i, u1 + 32 * i, u2 + 32 * i,
              &table[0][t], THREADS);
  pt_add_from(sum, part, src_quad{part, 1});
  pt_add_from(part, sum, src_quad{sum, 2});
  t = thread_index();  // afresh: nothing of the lane lives across the walk
  lane = blockIdx.x * SIGS + (t >> 2);
  i = lane < n ? lane : n - 1;
  const int v =
      compare(part, r + 32 * i, col_read(&table[0][t], THREADS, KEY_AT));
  if ((t & 3) == 0 && lane < n) out[lane] = v;
}

// q33: (n, 33) uint8; u1, u2, r: (n, 32) uint8 big-endian; ok: (n,) uint8;
// out: (n,) int32.  Launches on `stream`, does not synchronise, allocates
// nothing; returns cudaGetLastError().
extern "C" int secp256k1_verify_launch(const void* q33, const void* u1,
                                       const void* u2, const void* r,
                                       const void* ok, void* out, int n,
                                       void* stream) {
  if (n > 0) {
    const int blocks = (n + SIGS - 1) / SIGS;
    secp256k1_verify_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)q33, (const uint8_t*)u1, (const uint8_t*)u2,
        (const uint8_t*)r, (const uint8_t*)ok, (int32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// The launch configuration's resources: blocks resident per SM, threads per
// block, and the compiled kernel's registers, local memory bytes per thread
// and static shared memory bytes per block.  Returns a CUDA error code.
extern "C" int secp256k1_verify_occupancy(int* blocks_per_sm, int* threads,
                                          int* regs, int* local_bytes,
                                          int* shared_bytes) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, secp256k1_verify_kernel);
  if (e != cudaSuccess) return (int)e;
  *threads = THREADS;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  *shared_bytes = (int)fa.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, secp256k1_verify_kernel, THREADS, 0);
}

#else  // host build: each lane's quad, one thread after another

// One lane: the quad's four threads in turn, then the combine and the
// compare as each of the four runs them on the card; thread 0's verdict.
static int verify_lane(const uint8_t* q33, const uint8_t* u1,
                       const uint8_t* u2, const uint8_t* rb, uint8_t ok) {
  if (!ok) return 0;
  uint32_t col[COL_WORDS];
  pt part[4], sum[4], tot[4];
  bool key_ok[4];
  int v[4];
  for (int j = 0; j < 4; j++) {
    quad_thread(part[j], j, q33, u1, u2, col, 1);
    key_ok[j] = col[KEY_AT];
  }
  for (int j = 0; j < 4; j++) pt_add(sum[j], part[j], part[j ^ 1]);
  for (int j = 0; j < 4; j++) pt_add(tot[j], sum[j], sum[j ^ 2]);
  for (int j = 0; j < 4; j++) v[j] = compare(tot[j], rb, key_ok[j]);
  return v[0];
}

extern "C" int secp256k1_verify_host(const uint8_t* q33, const uint8_t* u1,
                                     const uint8_t* u2, const uint8_t* r,
                                     const uint8_t* ok, int32_t* out, int n) {
  for (int i = 0; i < n; i++)
    out[i] = verify_lane(q33 + 33 * i, u1 + 32 * i, u2 + 32 * i, r + 32 * i,
                         ok[i]);
  return 0;
}

// The GLV split of n big-endian 32-byte scalars, for the tests: the
// magnitudes of k1 and k2 (five words each) and their signs (1 negative).
extern "C" void secp256k1_glv_split_host(const uint8_t* k32, uint32_t* m1,
                                         uint32_t* m2, int32_t* negs, int n) {
  for (int i = 0; i < n; i++) {
    fe k;
    bool n1, n2;
    fe_from_be(k, k32 + 32 * i);
    glv_split(m1 + 5 * i, n1, m2 + 5 * i, n2, k);
    negs[2 * i] = n1;
    negs[2 * i + 1] = n2;
  }
}

// The 44 signed radix-8 digits of n scalars below 2^129 (five words each),
// for the tests: digits[44 * i + pos] is the digit of 8^pos.
extern "C" void secp256k1_recode_host(const uint32_t* s, int32_t* digits_out,
                                      int n) {
  for (int i = 0; i < n; i++) {
    uint32_t w[5];
    digits_init(w, 1, s + 5 * i);
    for (int pos = POSITIONS - 1; pos >= 0; pos--)
      digits_out[POSITIONS * i + pos] = digits_next(w, 1);
  }
}

// The four partial points s_j*P_j of n lanes, for the tests: out[96 * i +
// 24 * j + 8 * c + l] is limb l of coordinate c (X, Y, Z) of thread j's.
extern "C" void secp256k1_partials_host(const uint8_t* q33, const uint8_t* u1,
                                        const uint8_t* u2, uint32_t* out,
                                        int n) {
  uint32_t col[COL_WORDS];
  for (int i = 0; i < n; i++)
    for (int j = 0; j < 4; j++) {
      pt part;
      quad_thread(part, j, q33 + 33 * i, u1 + 32 * i, u2 + 32 * i, col, 1);
      uint32_t* o = out + 96 * i + 24 * j;
      for (int l = 0; l < 8; l++) {
        o[l] = part.x.v[l];
        o[8 + l] = part.y.v[l];
        o[16 + l] = part.z.v[l];
      }
    }
}

// Field ops on n pairs of 8-limb values, for the tests: 0 add, 1 sub,
// 2 mul, 3 square, 4 times b3, 5 neg, 6 square root candidate,
// 7 normalize.  Outputs are not normalized unless op is 7.
extern "C" void secp256k1_fe_op_host(int op, const uint32_t* a,
                                     const uint32_t* b, uint32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    fe x, y, z;
    for (int k = 0; k < 8; k++) {
      x.v[k] = a[8 * i + k];
      y.v[k] = b[8 * i + k];
    }
    switch (op) {
      case 0: fe_add(z, x, y); break;
      case 1: fe_sub(z, x, y); break;
      case 2: fe_mul(z, x, y); break;
      case 3: fe_sqr(z, x); break;
      case 4: fe_mul_small(z, x, B3); break;
      case 5: fe_neg(z, x); break;
      case 6: fe_sqrt(z, x); break;
      default: z = x; fe_normalize(z); break;
    }
    for (int k = 0; k < 8; k++) out[8 * i + k] = z.v[k];
  }
}

// Point ops on n pairs of projective points (24 limbs each: X, Y, Z), for
// the tests: 0 add, 1 double (of the first).
extern "C" void secp256k1_pt_op_host(int op, const uint32_t* a,
                                     const uint32_t* b, uint32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    pt p, q, r;
    fe* pf[3] = {&p.x, &p.y, &p.z};
    fe* qf[3] = {&q.x, &q.y, &q.z};
    for (int c = 0; c < 3; c++)
      for (int k = 0; k < 8; k++) {
        pf[c]->v[k] = a[24 * i + 8 * c + k];
        qf[c]->v[k] = b[24 * i + 8 * c + k];
      }
    if (op == 0)
      pt_add(r, p, q);
    else
      pt_double(r, p);
    const fe* rf[3] = {&r.x, &r.y, &r.z};
    for (int c = 0; c < 3; c++)
      for (int k = 0; k < 8; k++) out[24 * i + 8 * c + k] = rf[c]->v[k];
  }
}

#if defined(SECP_TALLY)
// Field multiplies, squares and small multiplies run since the last call
// (then reset).
extern "C" void secp256k1_tally(long long* muls, long long* squares,
                                long long* smalls) {
  *muls = g_tally_mul;
  *squares = g_tally_sq;
  *smalls = g_tally_small;
  g_tally_mul = g_tally_sq = g_tally_small = 0;
}
#endif

#endif
