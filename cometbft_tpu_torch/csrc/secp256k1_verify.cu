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
// (ops/secp_verify.pack_batch), which also applies the structural rules
// (lengths, 0 < r < n, 0 < s <= n/2, prefix, x < p) and sets `ok`.
//
// What bounds it on this card: integer multiplies.  A signature costs a
// 256-step Straus/Shamir ladder (a doubling: 6 squares + 6 multiplies; an
// addition: 12 multiplies) plus the square root of decompression (253
// squares + 13 multiplies), i.e. ~4,650 field multiplies and ~1,790 squares
// of 73 and 45 32x32->64-bit products, against 164 bytes of input and
// output: the bound is the SMs' integer multiply rate (chip_smoke.py
// prints it from the exact tally of a host build).
//
// What the design does about it, for now: one thread per signature, the
// simplest correct mapping.
// * Field elements are 8 x 32-bit limbs, little-endian, any value below
//   2^256 (not necessarily below p); products are 64-bit, schoolbook, and
//   reduced by 2^256 = 2^32 + 977 (mod p): two folds, no Montgomery form.
//   Values are fully reduced only where a decision needs them: the parity
//   of y, y^2 = y2, Z = 0 and the final compare.
// * The ladder is wcurve.double_scalar_mul: at each bit, MSB first,
//   acc = 2*acc, then acc + {O, G, Q, G+Q}[bits], picked by selects (no
//   branch); RCB15's complete formulas for a = 0, b3 = 21, the JAX module's
//   sequence of field operations, so (X : Y : Z) are the same field
//   elements as the JAX ladder's.  G lives in constant memory; Q and G+Q
//   in registers.  Scalar bits are read from the byte rows as they are
//   needed (a register array indexed by the bit would go to local memory).
// * The compare needs no inversion: Z != 0 and X = r*Z, or r + n < p and
//   X = (r + n)*Z.
// * 64-thread blocks: a 10,240-signature commit is 160 blocks, so every
//   SM has work.  A lane past the batch's end returns at once; a lane with
//   `ok` clear writes 0 without running the ladder.
//
// Without __CUDACC__ the same source builds for the host, one lane after
// another, so its field and curve arithmetic is checked against Python
// integers on a machine with no card; with SECP_TALLY the host build
// counts field multiplies, squares and small multiplies.

#include <stdint.h>

#if defined(__CUDACC__)
#define DEV __device__ __forceinline__
#define CONST_MEM __constant__
#else
#define DEV static inline
#define CONST_MEM static const
#endif

#define THREADS 64  // threads per block, one signature each

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

DEV void pt_add(pt& r, const pt& p, const pt& q) {
  fe t0, t1, t2, t3, t4, xz, a, b;
  fe_mul(t0, p.x, q.x);
  fe_mul(t1, p.y, q.y);
  fe_mul(t2, p.z, q.z);
  fe_add(a, p.x, p.y);
  fe_add(b, q.x, q.y);
  fe_mul(t3, a, b);
  fe_add(a, t0, t1);
  fe_sub(t3, t3, a);  // X1Y2 + X2Y1
  fe_add(a, p.y, p.z);
  fe_add(b, q.y, q.z);
  fe_mul(t4, a, b);
  fe_add(a, t1, t2);
  fe_sub(t4, t4, a);  // Y1Z2 + Y2Z1
  fe_add(a, p.x, p.z);
  fe_add(b, q.x, q.z);
  fe_mul(xz, a, b);
  fe_add(a, t0, t2);
  fe_sub(xz, xz, a);  // X1Z2 + X2Z1
  pt_tail(r, t0, t1, t2, t3, t4, xz);
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

DEV void pt_select(pt& r, bool c, const pt& a, const pt& b) {
  fe_select(r.x, c, a.x, b.x);
  fe_select(r.y, c, a.y, b.y);
  fe_select(r.z, c, a.z, b.z);
}

DEV int bit_at(const uint8_t* be32, int i) {  // bit i, MSB first
  return (be32[i >> 3] >> (7 - (i & 7))) & 1;
}

// --- one signature -----------------------------------------------------------

DEV int verify_lane(const uint8_t* q33, const uint8_t* u1, const uint8_t* u2,
                    const uint8_t* rb, uint8_t ok) {
  if (!ok) return 0;
  // decompress Q
  pt q;
  fe_from_be(q.x, q33 + 1);
  const bool x_ok = lt_const(q.x, P_LIMBS);
  fe y2, s;
  fe_sqr(y2, q.x);
  fe_mul(y2, y2, q.x);
  fe_set_small(s, 7);
  fe_add(y2, y2, s);
  fe_sqrt(q.y, y2);
  fe_sqr(s, q.y);
  const bool on_curve = fe_equal(s, y2);
  fe_normalize(q.y);
  fe_neg(s, q.y);
  fe_select(q.y, (q.y.v[0] & 1u) != (uint32_t)(q33[0] & 1), s, q.y);
  fe_set_small(q.z, 1);
  const bool prefix_ok = q33[0] == 2 || q33[0] == 3;

  // the Straus/Shamir ladder u1*G + u2*Q
  pt g, gq, o, acc, addend, tmp;
  fe_set_const(g.x, GX_LIMBS);
  fe_set_const(g.y, GY_LIMBS);
  fe_set_small(g.z, 1);
  pt_add(gq, g, q);
  fe_set_small(o.x, 0);
  fe_set_small(o.y, 1);
  fe_set_small(o.z, 0);
  acc = o;
  for (int i = 0; i < 256; i++) {
    pt_double(tmp, acc);
    const int b1 = bit_at(u1, i), b2 = bit_at(u2, i);
    pt_select(addend, b1 & b2, gq, o);
    pt_select(addend, b1 & (1 - b2), g, addend);
    pt_select(addend, (1 - b1) & b2, q, addend);
    pt_add(acc, tmp, addend);
  }

  // x(R') = r (mod n) without an inversion
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
  if (lt_const(r, PMN_LIMBS)) {  // r + n < p: no carry out above
    fe_mul(t, rn, acc.z);
    hit = hit || fe_equal(acc.x, t);
  }
  return (x_ok && prefix_ok && on_curve && !fe_is_zero(acc.z) && hit) ? 1 : 0;
}

}  // namespace

#if defined(__CUDACC__)

__global__ void __launch_bounds__(THREADS)
    secp256k1_verify_kernel(const uint8_t* __restrict__ q33,
                            const uint8_t* __restrict__ u1,
                            const uint8_t* __restrict__ u2,
                            const uint8_t* __restrict__ r,
                            const uint8_t* __restrict__ ok,
                            int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  out[i] = verify_lane(q33 + 33 * i, u1 + 32 * i, u2 + 32 * i, r + 32 * i,
                       ok[i]);
}

// q33: (n, 33) uint8; u1, u2, r: (n, 32) uint8 big-endian; ok: (n,) uint8;
// out: (n,) int32.  Launches on `stream`, does not synchronise, allocates
// nothing; returns cudaGetLastError().
extern "C" int secp256k1_verify_launch(const void* q33, const void* u1,
                                       const void* u2, const void* r,
                                       const void* ok, void* out, int n,
                                       void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
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

#else  // host build: one lane after another

extern "C" int secp256k1_verify_host(const uint8_t* q33, const uint8_t* u1,
                                     const uint8_t* u2, const uint8_t* r,
                                     const uint8_t* ok, int32_t* out, int n) {
  for (int i = 0; i < n; i++)
    out[i] = verify_lane(q33 + 33 * i, u1 + 32 * i, u2 + 32 * i, r + 32 * i,
                         ok[i]);
  return 0;
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
