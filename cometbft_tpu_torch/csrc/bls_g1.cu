// Batched BLS12-381 G1 scalar multiplication for Hopper (sm_90a): per lane,
// s_i * P_i on y^2 = x^3 + 4 over GF(p), p the 381-bit BLS12-381 prime.
//
// Replaces: the XLA device program `_batch_mul_kernel` of
// cometbft_tpu/ops/bls_g1.py (jax.jit at :91-93: wcurve's per-lane
// double-and-add over fp381's 30 x 13-bit Montgomery limbs), behind
// `batch_scalar_mul` (:119-134), together with the host packing around it
// there (Montgomery limbs, (128, B) bit rows).  In the random-linear-
// combination check of crypto/batch.BlsBatchVerifier it computes r_i * pk_i
// for 128-bit random r_i.  Raw bytes in, canonical projective coordinates
// out:
//
//   in:  96-byte uncompressed G1 points (x || y big-endian, the ZCash flag
//        bits of byte 0 masked; byte 0 & 0x40 is the point at infinity,
//        which enters as (0 : 1 : 0)) and 16-byte big-endian scalars, of
//        which the low `nbits` bits are used;
//   out: 144 bytes per lane, X || Y || Z big-endian, each fully reduced
//        (below p) and out of the Montgomery domain.  The wrapper makes
//        them affine (ops/bls_g1.py).
//
// What bounds it on this card: integer multiplies.  A lane runs 128 steps
// of a complete doubling (6 squares, 6 multiplies, 2 small multiplies) and
// a complete addition (12 multiplies, 2 small multiplies), each multiply a
// 12-word Montgomery product of ~300 32x32->64-bit products, against 256
// bytes of input and output: far past the HBM rate's share, so the bound
// is the SMs' INT32 multiply rate (132 SMs x 64 INT32 lanes x 1,980 MHz,
// the convention of PERF.md section 6).  chip_smoke.py prints the bound
// from the work a 128-bit scalar multiplication needs
// (ops/cuda_bls.needed_work: a width-w NAF ladder in Jacobian coordinates
// over a one-Z table, ~2.9x fewer products than this kernel's complete
// formulas) and this kernel's own tally beside it.
//
// What the design does about it: nothing yet; this is the simple design
// that is right, and a redesign is later work.
// * One thread per lane, 64-thread blocks (a 10,240-lane batch is 160
//   blocks).  A lane past the batch's end returns at once.
// * Field elements are 12 x 32-bit limbs, little-endian, in the Montgomery
//   domain (R = 2^384), FULLY REDUCED after every operation (below p):
//   R/p is only ~9.85, so there is no headroom for lazy reduction.  An add
//   subtracts p when the sum reaches it, a subtract adds p on a borrow, a
//   multiply is CIOS with the final conditional subtraction (inputs below
//   p < R/4 keep its result below 2p), and the multiply by b3 = 12 is four
//   such additions.  So every value is canonical in the Montgomery domain,
//   and leaves it by one multiply by 1.
// * The ladder is the JAX module's `scalar_mul` (ops/wcurve.py there,
//   Curve.scalar_mul in the port's plain version): MSB first,
//   acc = 2*acc, then acc = bit ? acc + P : acc (the addition always runs,
//   the bit selects), with RCB15's complete formulas for a = 0 (algorithm
//   7, and the same formula with squarings for the doubling), b3 = 12, in
//   the same sequence of field operations.  So (X : Y : Z) are the same
//   field elements as the plain version's, bit for bit once canonical.
// * Scalar bits are read from the byte row as they are needed.
//
// Without __CUDACC__ the same source builds for the host, one lane after
// another, so its field and curve arithmetic is checked against Python
// integers on a machine with no card; with BLS_TALLY the host build counts
// field multiplies, squares and small multiplies.

#include <stdint.h>

#if defined(__CUDACC__)
#define DEV __device__ __forceinline__
#define CONST_MEM __constant__
#else
#define DEV static inline
#define CONST_MEM static const
#endif

#define THREADS 64  // threads per block, one lane each
#define NW 12       // 32-bit words per field element
#define B3 12u      // 3 * b for y^2 = x^3 + 4

#if defined(BLS_TALLY) && !defined(__CUDACC__)
static long long g_tally_mul = 0, g_tally_sq = 0, g_tally_small = 0;
#define TALLY(counter) ((counter)++)
#else
#define TALLY(counter) ((void)0)
#endif

namespace {

struct fe {
  uint32_t v[NW];  // little-endian limbs, Montgomery domain, below p
};

struct pt {
  fe x, y, z;  // projective (X : Y : Z)
};

CONST_MEM uint32_t P_LIMBS[NW] = {
    0xFFFFAAABu, 0xB9FEFFFFu, 0xB153FFFFu, 0x1EABFFFEu, 0xF6B0F624u, 0x6730D2A0u,
    0xF38512BFu, 0x64774B84u, 0x434BACD7u, 0x4B1BA7B6u, 0x397FE69Au, 0x1A0111EAu};
// -p^-1 mod 2^32
#define P_INV 0xFFFCFFFDu
// R^2 mod p: into the Montgomery domain by one multiply
CONST_MEM uint32_t R2_LIMBS[NW] = {
    0x1C341746u, 0xF4DF1F34u, 0x09D104F1u, 0x0A76E6A6u, 0x4C95B6D5u, 0x8DE5476Cu,
    0x939D83C0u, 0x67EB88A9u, 0xB519952Du, 0x9A793E85u, 0x92CAE3AAu, 0x11988FE5u};
// R mod p: 1 in the Montgomery domain
CONST_MEM uint32_t ONE_LIMBS[NW] = {
    0x0002FFFDu, 0x76090000u, 0xC40C0002u, 0xEBF4000Bu, 0x53C758BAu, 0x5F489857u,
    0x70525745u, 0x77CE5853u, 0xA256EC6Du, 0x5C071A97u, 0xFA80E493u, 0x15F65EC3u};

// --- field --------------------------------------------------------------

DEV void fe_set_const(fe& r, const uint32_t* c) {
#pragma unroll
  for (int i = 0; i < NW; i++) r.v[i] = c[i];
}

DEV void fe_set_zero(fe& r) {
#pragma unroll
  for (int i = 0; i < NW; i++) r.v[i] = 0;
}

// r = t - p if t >= p (or if `carry`, a 2^384 above t), else t.
DEV void fe_reduce_once(fe& r, const uint32_t* t, uint32_t carry) {
  uint32_t s[NW];
  int64_t b = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    b += (int64_t)t[i] - P_LIMBS[i];
    s[i] = (uint32_t)b;
    b >>= 32;  // arithmetic: a borrow is -1
  }
  const bool ge = carry != 0 || b == 0;
#pragma unroll
  for (int i = 0; i < NW; i++) r.v[i] = ge ? s[i] : t[i];
}

// a + b (both below p): the sum is below 2p < 2^384, one subtraction.
DEV void fe_add(fe& r, const fe& a, const fe& b) {
  uint32_t t[NW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    c += (uint64_t)a.v[i] + b.v[i];
    t[i] = (uint32_t)c;
    c >>= 32;
  }
  fe_reduce_once(r, t, (uint32_t)c);
}

// a - b (both below p), plus p on a borrow.
DEV void fe_sub(fe& r, const fe& a, const fe& b) {
  uint32_t t[NW];
  int64_t d = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    d += (int64_t)a.v[i] - b.v[i];
    t[i] = (uint32_t)d;
    d >>= 32;
  }
  const uint32_t mask = d < 0 ? 0xFFFFFFFFu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    c += (uint64_t)t[i] + (P_LIMBS[i] & mask);
    r.v[i] = (uint32_t)c;
    c >>= 32;
  }
}

// k * a for a small constant k >= 1, by double-and-add over k's bits: every
// step is an add, so the result stays below p (12 * a would not fit 2^384).
DEV void fe_mul_small(fe& r, const fe& a, uint32_t k) {
  TALLY(g_tally_small);
  fe acc = a;
  int top = 31;
  while (!((k >> top) & 1u)) top--;
  for (int i = top - 1; i >= 0; i--) {
    fe_add(acc, acc, acc);
    if ((k >> i) & 1u) fe_add(acc, acc, a);
  }
  r = acc;
}

// Montgomery product a * b / R (CIOS), for a, b below p: below 2p before
// the final subtraction, below p after it.
DEV void fe_mont_mul(fe& r, const fe& a, const fe& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; j++) {
      c += (uint64_t)a.v[j] * b.v[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW] = (uint32_t)c;
    t[NW + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * P_INV;
    c = ((uint64_t)m * P_LIMBS[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NW; j++) {
      c += (uint64_t)m * P_LIMBS[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW - 1] = (uint32_t)c;
    t[NW] = t[NW + 1] + (uint32_t)(c >> 32);
  }
  fe_reduce_once(r, t, t[NW]);
}

DEV void fe_mul(fe& r, const fe& a, const fe& b) {
  TALLY(g_tally_mul);
  fe_mont_mul(r, a, b);
}

DEV void fe_sqr(fe& r, const fe& a) {
  TALLY(g_tally_sq);
  fe_mont_mul(r, a, a);
}

// 48 big-endian bytes -> 12 words; `mask` clears flag bits of byte 0.
DEV void fe_from_be48(fe& r, const uint8_t* b, uint8_t mask) {
#pragma unroll
  for (int i = 0; i < NW; i++) {
    const uint8_t* w = b + 44 - 4 * i;
    const uint32_t b0 = i == NW - 1 ? (uint32_t)(w[0] & mask) : w[0];
    r.v[i] = (b0 << 24) | ((uint32_t)w[1] << 16) | ((uint32_t)w[2] << 8) |
             (uint32_t)w[3];
  }
}

DEV void fe_to_be48(uint8_t* b, const fe& a) {
#pragma unroll
  for (int i = 0; i < NW; i++) {
    uint8_t* w = b + 44 - 4 * i;
    w[0] = (uint8_t)(a.v[i] >> 24);
    w[1] = (uint8_t)(a.v[i] >> 16);
    w[2] = (uint8_t)(a.v[i] >> 8);
    w[3] = (uint8_t)a.v[i];
  }
}

// Any value below 2^384 into the Montgomery domain (x * R^2 / R: below p
// since R^2 mod p is).
DEV void fe_to_mont(fe& r, const fe& a) {
  fe r2;
  fe_set_const(r2, R2_LIMBS);
  fe_mul(r, a, r2);
}

// Out of the Montgomery domain: a * 1 / R, the canonical value.
DEV void fe_from_mont(fe& r, const fe& a) {
  fe one;
  fe_set_zero(one);
  one.v[0] = 1;
  fe_mul(r, a, one);
}

DEV void fe_select(fe& r, bool c, const fe& a, const fe& b) {
#pragma unroll
  for (int i = 0; i < NW; i++) r.v[i] = c ? a.v[i] : b.v[i];
}

// --- curve: RCB15 complete formulas, a = 0, b3 = 12 -------------------------

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

// --- one lane ----------------------------------------------------------------

// pt96: the point's 96 bytes; k16: the scalar, 16 bytes big-endian, of
// which the low nbits (1..128) bits are used; out144: X || Y || Z.
DEV void mul_lane(const uint8_t* pt96, const uint8_t* k16, int nbits,
                  uint8_t* out144) {
  const bool inf = (pt96[0] & 0x40) != 0;
  fe x, y, zero, one;
  fe_from_be48(x, pt96, 0x1F);
  fe_from_be48(y, pt96 + 48, 0xFF);
  fe_to_mont(x, x);
  fe_to_mont(y, y);
  fe_set_zero(zero);
  fe_set_const(one, ONE_LIMBS);
  pt base, acc, sum;
  fe_select(base.x, inf, zero, x);
  fe_select(base.y, inf, one, y);
  fe_select(base.z, inf, zero, one);
  acc.x = zero;
  acc.y = one;
  acc.z = zero;
  for (int i = 128 - nbits; i < 128; i++) {  // MSB first
    pt_double(acc, acc);
    pt_add(sum, acc, base);
    pt_select(acc, (k16[i >> 3] >> (7 - (i & 7))) & 1, sum, acc);
  }
  fe_from_mont(x, acc.x);
  fe_to_be48(out144, x);
  fe_from_mont(x, acc.y);
  fe_to_be48(out144 + 48, x);
  fe_from_mont(x, acc.z);
  fe_to_be48(out144 + 96, x);
}

}  // namespace

#if defined(__CUDACC__)

__global__ void __launch_bounds__(THREADS)
    bls_g1_kernel(const uint8_t* __restrict__ pts,
                  const uint8_t* __restrict__ scalars,
                  uint8_t* __restrict__ out, int n, int nbits) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  mul_lane(pts + 96 * i, scalars + 16 * i, nbits, out + 144 * i);
}

// pts: (n, 96) uint8; scalars: (n, 16) uint8 big-endian; out: (n, 144)
// uint8; 1 <= nbits <= 128.  Launches on `stream`, does not synchronise,
// allocates nothing; returns cudaGetLastError().
extern "C" int bls_g1_launch(const void* pts, const void* scalars, void* out,
                             int n, int nbits, void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    bls_g1_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)pts, (const uint8_t*)scalars, (uint8_t*)out, n, nbits);
  }
  return (int)cudaGetLastError();
}

// The launch configuration's resources: blocks resident per SM, threads per
// block, and the compiled kernel's registers, local memory bytes per thread
// and static shared memory bytes per block.  Returns a CUDA error code.
extern "C" int bls_g1_occupancy(int* blocks_per_sm, int* threads, int* regs,
                                int* local_bytes, int* shared_bytes) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, bls_g1_kernel);
  if (e != cudaSuccess) return (int)e;
  *threads = THREADS;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  *shared_bytes = (int)fa.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bls_g1_kernel, THREADS, 0);
}

#else  // host build: one lane after another

extern "C" int bls_g1_host(const uint8_t* pts, const uint8_t* scalars,
                           uint8_t* out, int n, int nbits) {
  for (int i = 0; i < n; i++)
    mul_lane(pts + 96 * i, scalars + 16 * i, nbits, out + 144 * i);
  return 0;
}

// Field ops on n pairs of 12-word values, for the tests: 0 add, 1 sub,
// 2 Montgomery multiply, 3 Montgomery square, 4 times b3, 5 into the
// Montgomery domain, 6 out of it.  Ops 0-4 take values below p.
extern "C" void bls_g1_fe_op_host(int op, const uint32_t* a, const uint32_t* b,
                                  uint32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    fe x, y, z;
    for (int k = 0; k < NW; k++) {
      x.v[k] = a[NW * i + k];
      y.v[k] = b[NW * i + k];
    }
    switch (op) {
      case 0: fe_add(z, x, y); break;
      case 1: fe_sub(z, x, y); break;
      case 2: fe_mul(z, x, y); break;
      case 3: fe_sqr(z, x); break;
      case 4: fe_mul_small(z, x, B3); break;
      case 5: fe_to_mont(z, x); break;
      default: fe_from_mont(z, x); break;
    }
    for (int k = 0; k < NW; k++) out[NW * i + k] = z.v[k];
  }
}

#if defined(BLS_TALLY)
// Field multiplies, squares and small multiplies run since the last call
// (then reset).
extern "C" void bls_g1_tally(long long* muls, long long* squares,
                             long long* smalls) {
  *muls = g_tally_mul;
  *squares = g_tally_sq;
  *smalls = g_tally_small;
  g_tally_mul = g_tally_sq = g_tally_small = 0;
}
#endif

#endif
