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
//        bits of byte 0 masked; byte 0 & 0x40 is the point at infinity)
//        and 16-byte big-endian scalars, of which the low `nbits` (1..128)
//        bits are used;
//   out: 144 bytes per lane, X || Y || Z big-endian, each below p and out
//        of the Montgomery domain: a projective representative of s * P
//        ((0 : 1 : 0) for the identity).  The kernel works in Jacobian
//        coordinates and hands out (X Z : Y : Z^3); its bytes equal the
//        plain version's (RCB15's projective ladder) as points, not as
//        bytes.  The wrapper makes them affine (ops/bls_g1.py).
//
// Domain: every point on the curve, in the subgroup or not, the identity,
// every scalar and every nbits.  Points off the curve are outside the
// contract (the verifier validates keys before they get here): their
// result is some value, not an error.
//
// What bounds it on this card.  The work is integer multiplies: a 128-bit
// scalar multiplication needs ~314,000 32x32->64-bit products (the cheapest
// wNAF ladder, ops/cuda_bls.needed_work) against 256 bytes of input and
// output, so the throughput bound is the SMs' INT32 multiply rate.  But on
// the main path (one launch of 256 lanes, 171 for a light commit) a few
// warps hold the whole card, and the time is one lane's chain of dependent
// instructions: the parent kernel (one thread per lane, complete RCB15
// formulas, field ops fully reduced in C++ 64-bit arithmetic) took the
// same ~12 ms at 256 lanes as at 10,240.
//
// What the design does about it: less work per lane, cheaper field
// operations, and a group of G threads per lane to shorten the chain.
// * Jacobian coordinates: a = 0 doubling dbl-2009-l (2M + 5S) and the full
//   addition add-2007-bl (12M + 4S, with Z3 = 2 (Z1 H) Z2 in place of
//   ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H, so that no level holds more than four
//   products), against 12 products and two multiplies by b3 in each of
//   RCB15's complete formulas.
// * Signed fixed windows of W = 4 bits (Booth's recoding, as the secp256k1
//   kernel's radix 8): digit i = b(Wi-1) + b(Wi) + 2 b(Wi+1) + 4 b(Wi+2)
//   - 8 b(Wi+3) in [-8, 8], ceil((nbits + 1) / W) of them, so a 128-bit
//   scalar is 128 doublings and 32 additions, at the same positions in
//   every lane (a warp never diverges on the digits).  Each lane's table
//   {1..8} P is built per lane (4 doublings, 3 additions) and kept in
//   shared memory.  A negative digit negates the entry's Y (2p - Y).  W = 5
//   counts 2.7% fewer products (a host build's tally at W = 5: 128
//   doublings, 26 additions and a table of 16 entries), but its table
//   doubles the shared memory and 10,240 lanes no longer fit one wave, so
//   W is 4; a one-Z table with mixed additions (7M + 4S) would save ~8%
//   more, but its z-ratio chain breaks on an entry at infinity, which
//   points outside the subgroup reach (see below).
// * The field: 12 x 32-bit limbs in the Montgomery domain (R = 2^384),
//   kept LAZY in [0, 2p).  p < 2^381, so for a, b < 2p, a b < 4p^2 < p R
//   and the CIOS product (a b + m p) / R < 2p needs no final subtraction.
//   A sum is below 4p < 2^383 and subtracts 2p once if it reaches it; a
//   difference adds 2p on a borrow (a - b = a + (2p - b), below 4p); the
//   multiplies by 2, 3 and 8 are such additions.  Values are made
//   canonical only for a zero test (v = 0 or v = p) and for the output.
//   The product is PTX carry chains (mad.lo.cc / madc.hi.cc), split into
//   the products of even and of odd limbs so that each chain adds whole
//   64-bit products, which ptxas issues as one IMAD.WIDE.U32.X each (two
//   separate chains of low and of high halves compiled to ~4 instructions
//   a product); sums and differences are add.cc / sub.cc chains.  A row
//   keeps the accumulator below 2^32 (a + p) < 2^416.
// * A group of G = BLS_GROUP threads per lane (1, 2 or 4), adjacent in a
//   warp.  Each formula is written as levels of independent field
//   operations (the tables STEPS and TASKS below): dbl-2009-l's three
//   multiply levels {X^2, Y^2, Y Z}, {B^2, (X + B)^2, (3A)^2}, {3A (D -
//   X3)}, add-2007-bl's five {Z1^2, Z2^2, Y1 Z2, Y2 Z1}, {U1, U2, S1, S2},
//   {(2H)^2, r^2, Z1 H}, {J, V, Z3}, {r (V - X3), S1 J}.  An
//   operation reads forms, 2^ku s[u] +- 2^kv s[v], so most additions run
//   inside the operation that needs them; the chains of additions left
//   (D and X3; r^2 - J and X3) run in one thread (SEQ) and the rest as
//   levels of their own.  Thread j of the group takes operations j, j +
//   G, ... of a level; operands and results live in the lane's slots in
//   shared memory; one __syncwarp(group mask) ends a level (and one
//   follows the check of H and r, which every thread reads).  Every
//   operation runs the same code (slots and forms are data, a packed
//   64-bit word a task), so the threads of a warp stay converged but for an
//   addition task beside products.  G = 1 is the same schedule with one
//   thread doing all of a level (and no barrier).  The levels cut a lane's
//   chain of dependent multiplies from 1,492 (G = 1) to 575 (G = 4);
//   lanes per block do not matter, since each warp's own latency sets the
//   time.
// * The lane's slots: the accumulator, the table, ten temporaries and a
//   zero, limb-major with the lane innermost (stride 33 words, so the 32
//   lanes of a block fall in distinct banks): 60,192 bytes for a block of
//   32 lanes (dynamic shared memory).  A 10,240-lane batch is 320 blocks,
//   three per SM: one wave on 132 SMs.
// * Exceptional cases, by explicit branches on per-lane flags (the same in
//   every thread of a group): an operand at infinity (the accumulator
//   while the leading digits are 0; a table entry at infinity; the input
//   0x40, whose lane writes (0 : 1 : 0) at once) skips or copies; a digit 0
//   skips the addition; H = 0 in an addition (equal x) runs the doubling
//   when r = 0 and gives infinity otherwise.  For a subgroup point and a
//   scalar below 2^129 H = 0 cannot occur after the first nonzero digit;
//   points outside the subgroup reach it.  The order-3 point (0, 2) takes
//   every branch while its table is built: 2P = -P, 3P = O, 4P = P, 5P =
//   P + P, 6P = 2 O, 7P = O + P.
//
// Without __CUDACC__ the same source builds for the host: each lane runs
// its group's G threads in turn between the barriers (EACH_THREAD /
// BARRIER), so the schedule itself, the formulas and the field are checked
// against Python integers on a machine with no card (the PTX chains are
// checked on the card by bls_g1_fe_op).  With BLS_TALLY the host build
// counts field multiplies, squares (a multiply of a slot by itself, run by
// the same product code), additions, and the multiply and addition levels
// one thread of the group runs.

#include <stdint.h>

#if defined(__CUDACC__)
#define DEV __device__ __forceinline__
#define CONST_MEM __constant__
#else
#define DEV static inline
#define CONST_MEM static const
#endif

#ifndef BLS_GROUP
#define BLS_GROUP 4  // threads per lane
#endif
#if BLS_GROUP != 1 && BLS_GROUP != 2 && BLS_GROUP != 4
#error "BLS_GROUP must be 1, 2 or 4"
#endif

#define GRP BLS_GROUP
#define WIN 4                     // bits per signed digit
#define ENTRIES (1 << (WIN - 1))  // table {1..2^(W-1)} P
#define LANES 32                  // lanes per block
#define THREADS (LANES * GRP)     // threads per block
#define STRIDE (LANES + 1)        // words between two limbs of a slot
#define MIN_BLOCKS 3              // 10,240 lanes in one wave on 132 SMs
#define NW 12                     // 32-bit words per field element

// physical slots of a lane: accumulator, table, temporaries, zero
#define S_ACC 0
#define S_TAB 3
#define S_TMP (S_TAB + 3 * ENTRIES)
#define NTMP 10
#define S_ZERO (S_TMP + NTMP)
#define NSLOTS (S_ZERO + 1)
#define SMEM_BYTES (NSLOTS * NW * STRIDE * 4)

#if defined(BLS_TALLY) && !defined(__CUDACC__)
static long long g_tally_mul = 0, g_tally_sq = 0, g_tally_small = 0;
static long long g_rounds_mul = 0, g_rounds_lin = 0;
// the exceptional branches taken: a doubling of the identity, a digit 0 or
// an entry at infinity skipped, an addition to the identity (a copy), H = 0
// with r = 0 (a doubling), H = 0 with r != 0 (the identity)
static long long g_branch[5] = {0, 0, 0, 0, 0};
#define TALLY(counter, k) ((counter) += (k))
#else
#define TALLY(counter, k) ((void)0)
#endif

namespace {

struct fe {
  uint32_t v[NW];  // little-endian limbs, Montgomery domain, below 2p
};

CONST_MEM uint32_t P_LIMBS[NW] = {
    0xFFFFAAABu, 0xB9FEFFFFu, 0xB153FFFFu, 0x1EABFFFEu, 0xF6B0F624u, 0x6730D2A0u,
    0xF38512BFu, 0x64774B84u, 0x434BACD7u, 0x4B1BA7B6u, 0x397FE69Au, 0x1A0111EAu};
CONST_MEM uint32_t P2_LIMBS[NW] = {  // 2p
    0xFFFF5556u, 0x73FDFFFFu, 0x62A7FFFFu, 0x3D57FFFDu, 0xED61EC48u, 0xCE61A541u,
    0xE70A257Eu, 0xC8EE9709u, 0x869759AEu, 0x96374F6Cu, 0x72FFCD34u, 0x340223D4u};
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

// --- field: values in [0, 2p) ----------------------------------------------

DEV void fe_set_const(fe& r, const uint32_t* c) {
#pragma unroll
  for (int i = 0; i < NW; i++) r.v[i] = c[i];
}

// a + b for a, b < 2p: the sum is below 4p < 2^383, minus 2p if it reaches
// 2p, so below 2p.  Also for b <= 2p (a difference's 2p - b): below 4p.
DEV void fe_add(fe& r, const fe& a, const fe& b) {
  uint32_t s[NW], t[NW], borrow;
#pragma unroll
  for (int i = 0; i < NW; i++) s[i] = a.v[i];
#if defined(__CUDACC__)
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, %23;"
      : "+r"(s[0]), "+r"(s[1]), "+r"(s[2]), "+r"(s[3]), "+r"(s[4]), "+r"(s[5]),
      "+r"(s[6]), "+r"(s[7]), "+r"(s[8]), "+r"(s[9]), "+r"(s[10]), "+r"(s[11])
      : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]),
      "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]), "r"(b.v[8]), "r"(b.v[9]),
      "r"(b.v[10]), "r"(b.v[11]));
#pragma unroll
  for (int i = 0; i < NW; i++) t[i] = s[i];
  asm("sub.cc.u32 %0, %0, %13;\n\t"
      "subc.cc.u32 %1, %1, %14;\n\t"
      "subc.cc.u32 %2, %2, %15;\n\t"
      "subc.cc.u32 %3, %3, %16;\n\t"
      "subc.cc.u32 %4, %4, %17;\n\t"
      "subc.cc.u32 %5, %5, %18;\n\t"
      "subc.cc.u32 %6, %6, %19;\n\t"
      "subc.cc.u32 %7, %7, %20;\n\t"
      "subc.cc.u32 %8, %8, %21;\n\t"
      "subc.cc.u32 %9, %9, %22;\n\t"
      "subc.cc.u32 %10, %10, %23;\n\t"
      "subc.cc.u32 %11, %11, %24;\n\t"
      "subc.u32 %12, 0, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]),
      "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9]), "+r"(t[10]), "+r"(t[11]),
      "=r"(borrow)
      : "r"(P2_LIMBS[0]), "r"(P2_LIMBS[1]), "r"(P2_LIMBS[2]), "r"(P2_LIMBS[3]),
      "r"(P2_LIMBS[4]), "r"(P2_LIMBS[5]), "r"(P2_LIMBS[6]), "r"(P2_LIMBS[7]),
      "r"(P2_LIMBS[8]), "r"(P2_LIMBS[9]), "r"(P2_LIMBS[10]), "r"(P2_LIMBS[11]));
#else
  uint64_t c = 0;
  for (int i = 0; i < NW; i++) {
    c += (uint64_t)s[i] + b.v[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  int64_t d = 0;
  for (int i = 0; i < NW; i++) {
    d += (int64_t)s[i] - P2_LIMBS[i];
    t[i] = (uint32_t)d;
    d >>= 32;  // arithmetic: a borrow is -1
  }
  borrow = d < 0 ? 0xFFFFFFFFu : 0u;
#endif
#pragma unroll
  for (int i = 0; i < NW; i++) r.v[i] = borrow ? s[i] : t[i];
}

// 2p - b for b < 2p: in (0, 2p], an addend that makes fe_add subtract.
DEV void fe_neg2p(fe& r, const fe& b) {
#pragma unroll
  for (int i = 0; i < NW; i++) r.v[i] = b.v[i];
#if defined(__CUDACC__)
  asm("sub.cc.u32 %0, %12, %0;\n\t"
      "subc.cc.u32 %1, %13, %1;\n\t"
      "subc.cc.u32 %2, %14, %2;\n\t"
      "subc.cc.u32 %3, %15, %3;\n\t"
      "subc.cc.u32 %4, %16, %4;\n\t"
      "subc.cc.u32 %5, %17, %5;\n\t"
      "subc.cc.u32 %6, %18, %6;\n\t"
      "subc.cc.u32 %7, %19, %7;\n\t"
      "subc.cc.u32 %8, %20, %8;\n\t"
      "subc.cc.u32 %9, %21, %9;\n\t"
      "subc.cc.u32 %10, %22, %10;\n\t"
      "subc.u32 %11, %23, %11;"
      : "+r"(r.v[0]), "+r"(r.v[1]), "+r"(r.v[2]), "+r"(r.v[3]), "+r"(r.v[4]),
      "+r"(r.v[5]), "+r"(r.v[6]), "+r"(r.v[7]), "+r"(r.v[8]), "+r"(r.v[9]),
      "+r"(r.v[10]), "+r"(r.v[11])
      : "r"(P2_LIMBS[0]), "r"(P2_LIMBS[1]), "r"(P2_LIMBS[2]), "r"(P2_LIMBS[3]),
      "r"(P2_LIMBS[4]), "r"(P2_LIMBS[5]), "r"(P2_LIMBS[6]), "r"(P2_LIMBS[7]),
      "r"(P2_LIMBS[8]), "r"(P2_LIMBS[9]), "r"(P2_LIMBS[10]), "r"(P2_LIMBS[11]));
#else
  int64_t d = 0;
  for (int i = 0; i < NW; i++) {
    d += (int64_t)P2_LIMBS[i] - b.v[i];
    r.v[i] = (uint32_t)d;
    d >>= 32;
  }
#endif
}

// a - b for a, b < 2p: a + (2p - b), below 2p.
DEV void fe_sub(fe& r, const fe& a, const fe& b) {
  fe nb;
  fe_neg2p(nb, b);
  fe_add(r, a, nb);
}

// Montgomery product a * b / R (CIOS) without the final subtraction, for
// a < 2^384 - p and a * b < p * R (so for a, b < 2p, and for a below p with
// any b < 2^384): each row keeps t below a + p, the result below 2p.  `a`
// is the row multiplicand, `b` gives a word per row.
#if defined(__CUDACC__)
// On the card the accumulator is two arrays: t = X + 2^32 Y, X taking the
// products a_j b_i of even j (its words j, j + 1) and Y those of odd j, so
// that each carry chain adds a whole 64-bit product (low half, then high
// half into the next word) and ptxas can issue it as one wide multiply-add
// with carry.  The reduction adds m p the same way; then t / 2^32 is Y +
// X / 2^32, so the arrays swap roles and X's words, shifted by two, enter
// the next row's odd chain (its first word goes into the new X's first,
// with the carry).  X's carry out of word 11 is Y's word 11, and the bound
// leaves nothing above Y's.  Each asm block is one carry chain from its
// first instruction, so no flag is carried between blocks.
DEV void mul_row(uint32_t (&x)[NW], uint32_t (&y)[NW], const fe& a,
                 uint32_t bi) {
  // y0 += x1; x <- x shifted by two words + the odd products
  asm("add.cc.u32 %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %13, %19, %3;\n\t"
      "madc.hi.cc.u32 %2, %13, %19, %4;\n\t"
      "madc.lo.cc.u32 %3, %14, %19, %5;\n\t"
      "madc.hi.cc.u32 %4, %14, %19, %6;\n\t"
      "madc.lo.cc.u32 %5, %15, %19, %7;\n\t"
      "madc.hi.cc.u32 %6, %15, %19, %8;\n\t"
      "madc.lo.cc.u32 %7, %16, %19, %9;\n\t"
      "madc.hi.cc.u32 %8, %16, %19, %10;\n\t"
      "madc.lo.cc.u32 %9, %17, %19, %11;\n\t"
      "madc.hi.cc.u32 %10, %17, %19, %12;\n\t"
      "madc.lo.cc.u32 %11, %18, %19, 0;\n\t"
      "madc.hi.u32 %12, %18, %19, 0;"
      : "+r"(y[0]), "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
      "+r"(x[5]), "+r"(x[6]), "+r"(x[7]), "+r"(x[8]), "+r"(x[9]),
      "+r"(x[10]), "+r"(x[11])
      : "r"(a.v[1]), "r"(a.v[3]), "r"(a.v[5]), "r"(a.v[7]), "r"(a.v[9]),
      "r"(a.v[11]), "r"(bi));
  // y += the even products, the carry into x11
  asm("mad.lo.cc.u32 %0, %13, %19, %0;\n\t"
      "madc.hi.cc.u32 %1, %13, %19, %1;\n\t"
      "madc.lo.cc.u32 %2, %14, %19, %2;\n\t"
      "madc.hi.cc.u32 %3, %14, %19, %3;\n\t"
      "madc.lo.cc.u32 %4, %15, %19, %4;\n\t"
      "madc.hi.cc.u32 %5, %15, %19, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %17, %19, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, %19, %9;\n\t"
      "madc.lo.cc.u32 %10, %18, %19, %10;\n\t"
      "madc.hi.cc.u32 %11, %18, %19, %11;\n\t"
      "addc.u32 %12, %12, 0;"
      : "+r"(y[0]), "+r"(y[1]), "+r"(y[2]), "+r"(y[3]), "+r"(y[4]),
      "+r"(y[5]), "+r"(y[6]), "+r"(y[7]), "+r"(y[8]), "+r"(y[9]),
      "+r"(y[10]), "+r"(y[11]),
      "+r"(x[11])
      : "r"(a.v[0]), "r"(a.v[2]), "r"(a.v[4]), "r"(a.v[6]), "r"(a.v[8]),
      "r"(a.v[10]), "r"(bi));
  // m = y0 * -p^-1; y += m * (the even limbs of p), which clears y0
  uint32_t m;
  asm("{\n\t"
      ".reg .u32 m;\n\t"
      "mul.lo.u32 m, %1, %20;\n\t"
      "mad.lo.cc.u32 %1, m, %14, %1;\n\t"
      "madc.hi.cc.u32 %2, m, %14, %2;\n\t"
      "madc.lo.cc.u32 %3, m, %15, %3;\n\t"
      "madc.hi.cc.u32 %4, m, %15, %4;\n\t"
      "madc.lo.cc.u32 %5, m, %16, %5;\n\t"
      "madc.hi.cc.u32 %6, m, %16, %6;\n\t"
      "madc.lo.cc.u32 %7, m, %17, %7;\n\t"
      "madc.hi.cc.u32 %8, m, %17, %8;\n\t"
      "madc.lo.cc.u32 %9, m, %18, %9;\n\t"
      "madc.hi.cc.u32 %10, m, %18, %10;\n\t"
      "madc.lo.cc.u32 %11, m, %19, %11;\n\t"
      "madc.hi.cc.u32 %12, m, %19, %12;\n\t"
      "addc.u32 %13, %13, 0;\n\t"
      "mov.u32 %0, m;\n\t"
      "}"
      : "=r"(m), "+r"(y[0]), "+r"(y[1]), "+r"(y[2]), "+r"(y[3]), "+r"(y[4]),
      "+r"(y[5]), "+r"(y[6]), "+r"(y[7]), "+r"(y[8]), "+r"(y[9]),
      "+r"(y[10]), "+r"(y[11]),
      "+r"(x[11])
      : "r"(P_LIMBS[0]), "r"(P_LIMBS[2]), "r"(P_LIMBS[4]), "r"(P_LIMBS[6]),
      "r"(P_LIMBS[8]), "r"(P_LIMBS[10]), "r"(P_INV));
  // x += m * (the odd limbs of p)
  asm("mad.lo.cc.u32 %0, %12, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %12, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %14, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %14, %3;\n\t"
      "madc.lo.cc.u32 %4, %12, %15, %4;\n\t"
      "madc.hi.cc.u32 %5, %12, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %16, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %16, %7;\n\t"
      "madc.lo.cc.u32 %8, %12, %17, %8;\n\t"
      "madc.hi.cc.u32 %9, %12, %17, %9;\n\t"
      "madc.lo.cc.u32 %10, %12, %18, %10;\n\t"
      "madc.hi.u32 %11, %12, %18, %11;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]),
      "+r"(x[5]), "+r"(x[6]), "+r"(x[7]), "+r"(x[8]), "+r"(x[9]),
      "+r"(x[10]), "+r"(x[11])
      : "r"(m), "r"(P_LIMBS[1]), "r"(P_LIMBS[3]), "r"(P_LIMBS[5]),
      "r"(P_LIMBS[7]), "r"(P_LIMBS[9]), "r"(P_LIMBS[11]));
}
#endif

DEV void fe_mul(fe& r, const fe& a, const fe& b) {
#if defined(__CUDACC__)
  uint32_t u[NW], w[NW];
#pragma unroll
  for (int i = 0; i < NW; i++) u[i] = w[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; i += 2) {
    mul_row(u, w, a, b.v[i]);
    mul_row(w, u, a, b.v[i + 1]);
  }
  // the result: w + u / 2^32
  asm("add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, 0;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]),
      "+r"(w[5]), "+r"(w[6]), "+r"(w[7]), "+r"(w[8]), "+r"(w[9]),
      "+r"(w[10]), "+r"(w[11])
      : "r"(u[1]), "r"(u[2]), "r"(u[3]), "r"(u[4]), "r"(u[5]), "r"(u[6]),
      "r"(u[7]), "r"(u[8]), "r"(u[9]), "r"(u[10]), "r"(u[11]));
#pragma unroll
  for (int i = 0; i < NW; i++) r.v[i] = w[i];
#else
  uint32_t t[NW + 1];
  for (int i = 0; i <= NW; i++) t[i] = 0;
  for (int i = 0; i < NW; i++) {
    uint64_t c = 0;
    for (int j = 0; j < NW; j++) {
      c += (uint64_t)a.v[j] * b.v[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    t[NW] = (uint32_t)c;
    const uint32_t m = t[0] * P_INV;
    c = ((uint64_t)m * P_LIMBS[0] + t[0]) >> 32;
    for (int j = 1; j < NW; j++) {
      c += (uint64_t)m * P_LIMBS[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW - 1] = (uint32_t)c;  // the bound leaves nothing above
  }
  for (int i = 0; i < NW; i++) r.v[i] = t[i];
#endif
}

// v >= p, for v < 2^384
DEV bool fe_ge_p(const fe& v) {
  int64_t d = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    d += (int64_t)v.v[i] - P_LIMBS[i];
    d >>= 32;
  }
  return d == 0;
}

// The canonical value of v <= p + (p - 1): v - p if v >= p.
DEV void fe_canonical(fe& r, const fe& v) {
  const bool ge = fe_ge_p(v);
  int64_t d = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    d += (int64_t)v.v[i] - (ge ? P_LIMBS[i] : 0u);
    r.v[i] = (uint32_t)d;
    d >>= 32;
  }
}

// v = 0 (mod p) for v < 2p: v is 0 or p.
DEV bool fe_is_zero(const fe& v) {
  uint32_t z = 0, q = 0;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    z |= v.v[i];
    q |= v.v[i] ^ P_LIMBS[i];
  }
  return z == 0 || q == 0;
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

// The field operations the tests hold to Python integers (host and card):
// 0 add, 1 sub, 2 multiply, 3 square, 4 times 8, 5 into the Montgomery
// domain (any x < 2^384), 6 out of it to the canonical value (any x <
// 2^384), 7 the zero test (word 0 is 1 for a zero).  Ops 0-4 and 7 take
// values below 2p and give values below 2p.
DEV void fe_op(int op, fe& z, const fe& x, const fe& y) {
  fe k;
  switch (op) {
    case 0: fe_add(z, x, y); break;
    case 1: fe_sub(z, x, y); break;
    case 2: fe_mul(z, x, y); break;
    case 3: fe_mul(z, x, x); break;
    case 4:
      fe_add(z, x, x);
      fe_add(z, z, z);
      fe_add(z, z, z);
      break;
    case 5:
      fe_set_const(k, R2_LIMBS);
      fe_mul(z, k, x);
      break;
    case 6:
      for (int i = 0; i < NW; i++) k.v[i] = i == 0;
      fe_mul(z, k, x);  // 1 * x / R <= p
      fe_canonical(z, z);
      break;
    default:
      for (int i = 0; i < NW; i++) z.v[i] = 0;
      z.v[0] = fe_is_zero(x);
      break;
  }
}

// --- the schedule: formulas as levels of independent field operations -----

// Logical slots of a task: the first operand IN1, the second IN2 (a table
// entry), the result OUT (IN1 itself in the main loop), the temporaries
// and zero.  A run maps IN1, IN2 and OUT to physical slots.
enum {
  IX, IY, IZ, QX, QY, QZ, OX, OY, OZ,
  T0, T1, T2, T3, T4, T5, T6, T7, T8, T9, ZR, NLOGICAL
};

// A level's tasks run one per thread of the group (PAR: thread j takes
// tasks j, j + G, ...) or all in order in the group's first thread (SEQ:
// a chain of additions, each reading the one before).  CHECK tests H and
// r of an addition; END ends a program.
enum { K_PAR, K_SEQ, K_CHECK, K_END };
enum { ADD, SUB, NEG_SUB };  // a form's sign; NEG_SUB: SUB if negated

// A form is a value an operation reads: 2^ku s[u] +- 2^kv s[v], or the
// slot s[u] alone (v = ZR, ADD, ku = 0), for the additions that used to
// be levels of their own to run inside the operation that needs them.
// 16 bits: u | v << 5 | ku << 10 | kv << 12 | sign << 14.
#define F_(u, ku, sign, v, kv) \
  ((uint64_t)(u) | (uint64_t)(v) << 5 | (uint64_t)(ku) << 10 | \
   (uint64_t)(kv) << 12 | (uint64_t)(sign) << 14)
#define P_(u) F_(u, 0, ADD, ZR, 0)

// A task, 64 bits: form A | form B << 16 | d << 32 | op << 37, op MUL
// (d = A * B, A the row multiplicand), SQR (d = A * A) or LIN (d = A).
enum { OP_LIN, OP_MUL, OP_SQR };
typedef uint64_t Task;
#define M_(a, b, d) ((a) | (b) << 16 | (uint64_t)(d) << 32 | (uint64_t)OP_MUL << 37)
#define Q_(a, d) ((a) | (uint64_t)(d) << 32 | (uint64_t)OP_SQR << 37)
#define L_(a, d) ((a) | (uint64_t)(d) << 32 | (uint64_t)OP_LIN << 37)

// A step, 32 bits: kind | n << 2 | first << 5 (n tasks from TASKS[first]).
typedef uint32_t Step;
#define S_(kind, n, first) ((kind) | (n) << 2 | (first) << 5)

DEV int s_kind(Step s) { return s & 3; }
DEV int s_n(Step s) { return (s >> 2) & 7; }
DEV int s_first(Step s) { return s >> 5; }
DEV int t_op(Task t) { return (int)(t >> 37) & 3; }
DEV int t_d(Task t) { return (int)(t >> 32) & 31; }
DEV uint32_t t_form(Task t, int k) { return (uint32_t)(t >> (16 * k)) & 0xFFFF; }
DEV int f_u(uint32_t f) { return f & 31; }
DEV int f_v(uint32_t f) { return (f >> 5) & 31; }
DEV int f_ku(uint32_t f) { return (f >> 10) & 3; }
DEV int f_kv(uint32_t f) { return (f >> 12) & 3; }
DEV int f_sign(uint32_t f) { return (f >> 14) & 3; }
DEV bool f_plain(uint32_t f) { return (f >> 5) == ZR; }  // v = ZR, ADD, ku = kv = 0

CONST_MEM Task TASKS[] = {
    // 0: dbl-2009-l, IN1 -> OUT (may be IN1)
    Q_(P_(IX), T0), Q_(P_(IY), T1), M_(P_(IY), P_(IZ), T2),   // A, B, Y Z
    Q_(P_(T1), T5),                                           // C = B^2
    Q_(F_(IX, 0, ADD, T1, 0), T6),                            // (X + B)^2
    Q_(F_(T0, 0, ADD, T0, 1), T7),                            // F = (3A)^2
    L_(F_(T2, 1, ADD, ZR, 0), OZ),                            // Z3 = 2 Y Z
    L_(F_(T6, 0, SUB, T0, 0), T8),                            // (X + B)^2 - A
    L_(F_(T8, 1, SUB, T5, 1), T9),                            // D
    L_(F_(T7, 0, SUB, T9, 1), OX),                            // X3 = F - 2D
    M_(F_(T0, 0, ADD, T0, 1), F_(T9, 0, SUB, OX, 0), T2),     // 3A (D - X3)
    L_(F_(T2, 0, SUB, T5, 3), OY),                            // Y3 = . - 8C
    // 12: add-2007-bl, IN1 + (+-IN2) -> OUT, Z3 = 2 (Z1 H) Z2
    Q_(P_(IZ), T2), Q_(P_(QZ), T3), M_(P_(IY), P_(QZ), T4),   // Z1Z1, Z2Z2, Y1 Z2
    M_(F_(ZR, 0, NEG_SUB, QY, 0), P_(IZ), T5),                // +-Y2 Z1
    M_(P_(IX), P_(T3), T7), M_(P_(QX), P_(T2), T8),           // U1, U2
    M_(P_(T4), P_(T3), T9), M_(P_(T5), P_(T2), T0),           // S1, S2
    L_(F_(T8, 0, SUB, T7, 0), T1),                            // H
    L_(F_(T0, 0, SUB, T9, 0), T4),                            // S2 - S1
    Q_(F_(T1, 1, ADD, ZR, 0), T2),                            // I = (2H)^2
    Q_(F_(T4, 1, ADD, ZR, 0), T6),                            // r^2
    M_(P_(IZ), P_(T1), T5),                                   // Z1 H
    M_(P_(T1), P_(T2), T3), M_(P_(T7), P_(T2), T8),           // J, V
    M_(F_(T5, 1, ADD, ZR, 0), P_(QZ), OZ),                    // Z3
    L_(F_(T6, 0, SUB, T3, 0), T0),                            // r^2 - J
    L_(F_(T0, 0, SUB, T8, 1), OX),                            // X3
    M_(F_(T4, 1, ADD, ZR, 0), F_(T8, 0, SUB, OX, 0), T1),     // r (V - X3)
    M_(P_(T9), P_(T3), T7),                                   // S1 J
    L_(F_(T1, 0, SUB, T7, 1), OY),                            // Y3
    // 33: +-IN2 -> OUT
    L_(P_(QX), OX), L_(F_(ZR, 0, NEG_SUB, QY, 0), OY), L_(P_(QZ), OZ),
    // 36: IN1 into the Montgomery domain in place (T0 holds R^2)
    M_(P_(T0), P_(IX), IX), M_(P_(T0), P_(IY), IY),
    // 38: Jacobian IN1 out to projective (X Z : Y : Z^3), out of the domain
    // (T0 holds 1): T4, T5, T6
    M_(P_(IX), P_(IZ), T1), Q_(P_(IZ), T2),
    M_(P_(T2), P_(IZ), T3),
    M_(P_(T1), P_(T0), T4), M_(P_(IY), P_(T0), T5), M_(P_(T3), P_(T0), T6),
};

enum { PC_DBL = 0, PC_ADD = 6, PC_COPY = 16, PC_TOMONT = 18, PC_OUT = 20 };

CONST_MEM Step STEPS[] = {
    // PC_DBL: {A, B, Y Z}, {C, (X + B)^2, F, Z3}, the chain to X3, {3A (D -
    // X3)}, {Y3}
    S_(K_PAR, 3, 0), S_(K_PAR, 4, 3), S_(K_SEQ, 3, 7), S_(K_PAR, 1, 10),
    S_(K_PAR, 1, 11), S_(K_END, 0, 0),
    // PC_ADD: {Z1Z1, Z2Z2, Y1 Z2, Y2 Z1}, {U1, U2, S1, S2}, {H, S2 - S1},
    // the check, {I, r^2, Z1 H}, {J, V, Z3}, the chain to X3, {r (V - X3),
    // S1 J}, {Y3}
    S_(K_PAR, 4, 12), S_(K_PAR, 4, 16), S_(K_PAR, 2, 20),
    S_(K_CHECK, 0, 0),  // H in T1, S2 - S1 in T4
    S_(K_PAR, 3, 22), S_(K_PAR, 3, 25), S_(K_SEQ, 2, 28), S_(K_PAR, 2, 30),
    S_(K_PAR, 1, 32), S_(K_END, 0, 0),
    // PC_COPY
    S_(K_PAR, 3, 33), S_(K_END, 0, 0),
    // PC_TOMONT
    S_(K_PAR, 2, 36), S_(K_END, 0, 0),
    // PC_OUT
    S_(K_PAR, 2, 38), S_(K_PAR, 1, 40), S_(K_PAR, 3, 41), S_(K_END, 0, 0),
};

#define NSTEPS ((int)(sizeof(STEPS) / sizeof(STEPS[0])))
#define NTASKS ((int)(sizeof(TASKS) / sizeof(TASKS[0])))

// --- one lane ----------------------------------------------------------------

// A lane's view of its slots: slot q, limb l at s[(q * NW + l) * stride].
// On the card `j` is this thread's index in the lane's group and `mask`
// the group's threads in the warp.
struct Ctx {
  uint32_t* s;
  int stride;
  int j;
  unsigned mask;
};

// The group schedule.  EACH_THREAD(j) runs its body as thread j of the
// lane's group: on the card as the thread itself, in the host build for
// every j in turn.  BARRIER() ends a level.  Everything outside
// EACH_THREAD runs in every thread of the group alike (it reads slots and
// decides on flags, the same in all of them) and writes no slot; a read
// of slots there is followed by a BARRIER() before the next level writes
// one, so that no thread reads a slot another has already overwritten.
#if defined(__CUDACC__) && GRP > 1
#define EACH_THREAD(j) for (int j = c.j, once_ = 1; once_; once_ = 0)
#define BARRIER() __syncwarp(c.mask)
#elif defined(__CUDACC__)  // one thread per lane: its own writes, no barrier
#define EACH_THREAD(j) for (int j = 0, once_ = 1; once_; once_ = 0)
#define BARRIER() ((void)0)
#else
#define EACH_THREAD(j) for (int j = 0; j < GRP; j++)
#define BARRIER() ((void)0)
#endif

DEV void ld(fe& a, const Ctx& c, int q) {
#pragma unroll
  for (int l = 0; l < NW; l++) a.v[l] = c.s[(q * NW + l) * c.stride];
}

DEV void st(const Ctx& c, int q, const fe& a) {
#pragma unroll
  for (int l = 0; l < NW; l++) c.s[(q * NW + l) * c.stride] = a.v[l];
}

// the physical slot of logical slot `id`
DEV int phys(int id, int in1, int in2, int out) {
  return id < QX ? in1 + id : id < OX ? in2 + id - QX
       : id < T0 ? out + id - OX : S_TMP + id - T0;
}

// The value of form f: s[u] alone, or 2^ku s[u] +- 2^kv s[v] (each term
// below 2p, doubled by additions that stay below 2p; a difference is the
// sum with 2p - y, so the result is below 2p).
DEV void form(fe& r, const Ctx& c, uint32_t f, int in1, int in2, int out,
              bool neg) {
  ld(r, c, phys(f_u(f), in1, in2, out));
  if (f_plain(f)) return;
  TALLY(g_tally_small, 1);
#if defined(__CUDACC__)
#pragma unroll 1
#endif
  for (int i = 0; i < f_ku(f); i++) fe_add(r, r, r);
  if (f_v(f) == ZR && f_sign(f) == ADD) return;
  fe y;
  ld(y, c, phys(f_v(f), in1, in2, out));
#if defined(__CUDACC__)
#pragma unroll 1
#endif
  for (int i = 0; i < f_kv(f); i++) fe_add(y, y, y);
  if (f_sign(f) == SUB || (f_sign(f) == NEG_SUB && neg)) fe_neg2p(y, y);
  fe_add(r, r, y);
}

#if defined(BLS_TALLY) && !defined(__CUDACC__)
// The tally of one level: multiplies and squares, and the rounds one
// thread of the group runs: the most multiplies any thread takes (a
// lane's chain of dependent multiplies), or, in a level of additions
// only, the most additions (all of a SEQ level's).
static void tally_level(int kind, int n, int first) {
  int most_mul = 0, most_lin = 0;
  for (int j = 0; j < (kind == K_SEQ ? 1 : GRP); j++) {
    int muls = 0, lins = 0;
    for (int t = j; t < n; t += kind == K_SEQ ? 1 : GRP) {
      const int op = t_op(TASKS[first + t]);
      if (op == OP_LIN) lins++;
      else muls++;
      if (op == OP_MUL) g_tally_mul++;
      if (op == OP_SQR) g_tally_sq++;
    }
    most_mul = muls > most_mul ? muls : most_mul;
    most_lin = lins > most_lin ? lins : most_lin;
  }
  if (most_mul) g_rounds_mul += most_mul;
  else g_rounds_lin += most_lin;
}
#endif

// The i-th signed digit (i = 0 least significant) of the scalar whose
// doubled value is s2 (five words): its window is bits Wi..Wi+W of s2.
DEV int digit(const uint32_t* s2, int i) {
  const int off = WIN * i, w = off >> 5, sh = off & 31;
  uint32_t lo = s2[0], hi = s2[1];
#pragma unroll
  for (int k = 1; k < 5; k++) {
    if (w == k) {
      lo = s2[k];
      hi = k < 4 ? s2[k + 1] : 0u;
    }
  }
  const uint64_t v = ((uint64_t)hi << 32 | lo) >> sh;
  const int win = (int)(v & ((1u << (WIN + 1)) - 1));
  return ((win + 1) >> 1) - ((win >> WIN) << WIN);
}

// 2 * (the low nbits of the 16 big-endian bytes k16), as five words.
DEV void scalar_doubled(uint32_t* s2, const uint8_t* k16, int nbits) {
  uint32_t s[4];
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const uint8_t* w = k16 + 12 - 4 * i;
    s[i] = ((uint32_t)w[0] << 24) | ((uint32_t)w[1] << 16) |
           ((uint32_t)w[2] << 8) | (uint32_t)w[3];
    const int keep = nbits - 32 * i;  // bits of word i below nbits
    s[i] &= keep >= 32 ? 0xFFFFFFFFu : keep <= 0 ? 0u : (1u << keep) - 1;
  }
  s2[0] = s[0] << 1;
#pragma unroll
  for (int i = 1; i < 4; i++) s2[i] = (s[i] << 1) | (s[i - 1] >> 31);
  s2[4] = s[3] >> 31;
}

DEV int windows(int nbits) { return (nbits + WIN) / WIN; }  // ceil((nbits+1)/W)

// pt96: the point's 96 bytes; k16: the scalar, 16 bytes big-endian, of
// which the low nbits (1..128) bits are used; out144: X || Y || Z.
DEV void mul_lane(const Ctx& c, const uint8_t* pt96, const uint8_t* k16,
                  int nbits, uint8_t* out144) {
  if (pt96[0] & 0x40) {  // the identity: (0 : 1 : 0)
    EACH_THREAD(j) {
      for (int q = j; q < 3; q += GRP) {
        fe v;
        for (int i = 0; i < NW; i++) v.v[i] = q == 1 && i == 0;
        fe_to_be48(out144 + 48 * q, v);
      }
    }
    return;
  }
  uint32_t s2[5];
  scalar_doubled(s2, k16, nbits);
  const int top = windows(nbits) - 1;
  // entry 0 <- (x, y, 1) (x, y raw; 1 in the domain), zero, T0 <- R^2
  EACH_THREAD(j) {
    for (int q = j; q < 5; q += GRP) {
      fe v;
      if (q == 0) fe_from_be48(v, pt96, 0x1F);
      if (q == 1) fe_from_be48(v, pt96 + 48, 0xFF);
      if (q == 2) fe_set_const(v, ONE_LIMBS);
      if (q == 3)
        for (int i = 0; i < NW; i++) v.v[i] = 0;
      if (q == 4) fe_set_const(v, R2_LIMBS);
      st(c, q < 3 ? S_TAB + q : q == 3 ? S_ZERO : S_TMP, v);
    }
  }
  BARRIER();
  // Steps: into the domain; the table's entries 1..E-1 ((e + 1) P: even
  // multiples doubled, odd ones added to P); the top digit; W doublings and
  // an addition per lower digit; out of the domain.  Each step runs one
  // program of STEPS (or nothing), from the one interpreter below.
  uint32_t tinf = 0;  // entries at infinity
  bool ainf = true;   // the accumulator at infinity
  const int nsteps = ENTRIES + 1 + top * (WIN + 1) + 1;
  for (int s = 0; s < nsteps; s++) {
    int pc = -1, in1 = S_ACC, in2 = S_TAB, out = S_ACC;
    bool neg = false, inf_if_skip = false;
    int flag_of = -1;  // the table entry whose flag the result sets, or -1
    if (s == 0) {
      pc = PC_TOMONT;
      in1 = out = S_TAB;
    } else if (s < ENTRIES) {
      flag_of = s;
      out = S_TAB + 3 * s;
      if (s & 1) {  // (s + 1) P = 2 ((s + 1) / 2) P
        const int h = (s - 1) >> 1;
        in1 = S_TAB + 3 * h;
        inf_if_skip = true;
        if (!((tinf >> h) & 1)) pc = PC_DBL;
        else TALLY(g_branch[0], 1);
      } else {  // (s + 1) P = s P + P
        in1 = S_TAB + 3 * (s - 1);
        pc = (tinf >> (s - 1)) & 1 ? PC_COPY : PC_ADD;
        if (pc == PC_COPY) TALLY(g_branch[2], 1);
      }
    } else if (s < nsteps - 1) {
      const int u = s - ENTRIES;  // 0: the top digit; then W + 1 per digit
      const int r = u == 0 ? WIN : (u - 1) % (WIN + 1);
      if (r < WIN) {
        if (!ainf) pc = PC_DBL;
        else TALLY(g_branch[0], 1);
      } else {
        const int d = digit(s2, u == 0 ? top : top - 1 - (u - 1) / (WIN + 1));
        const int e = (d < 0 ? -d : d) - 1;
        neg = d < 0;
        in2 = S_TAB + 3 * e;
        if (d != 0 && !((tinf >> e) & 1)) pc = ainf ? PC_COPY : PC_ADD;
        if (pc < 0) TALLY(g_branch[1], 1);
        if (pc == PC_COPY) TALLY(g_branch[2], 1);
      }
    } else if (!ainf) {
      EACH_THREAD(j) {
        if (j == 0) {
          fe one;
          for (int i = 0; i < NW; i++) one.v[i] = i == 0;
          st(c, S_TMP, one);
        }
      }
      BARRIER();
      pc = PC_OUT;
    }
    // the interpreter: one program, level by level
    bool res_inf = inf_if_skip;
    if (pc >= 0) {
      res_inf = false;
      for (Step stp = STEPS[pc]; s_kind(stp) != K_END; stp = STEPS[pc]) {
        if (s_kind(stp) == K_CHECK) {
          fe h, r;
          ld(h, c, S_TMP + T1 - T0);
          ld(r, c, S_TMP + T4 - T0);
          // every thread has read H and r before any thread writes the
          // next level (the doubling's first writes T1)
          BARRIER();
          if (fe_is_zero(h)) {
            if (fe_is_zero(r)) {  // P1 = P2: double P1
              TALLY(g_branch[3], 1);
              pc = PC_DBL;
              continue;
            }
            TALLY(g_branch[4], 1);
            res_inf = true;  // P1 = -P2
            break;
          }
          pc++;
          continue;
        }
        const int kind = s_kind(stp), n = s_n(stp), first = s_first(stp);
#if defined(BLS_TALLY) && !defined(__CUDACC__)
        tally_level(kind, n, first);
#endif
        EACH_THREAD(j) {
          // PAR: thread j takes tasks j, j + G, ...; SEQ: the first thread
          // takes them all, in order
          const int step = kind == K_SEQ ? 1 : GRP;
#if defined(__CUDACC__)
#pragma unroll 1
#endif
          for (int t = kind == K_SEQ ? (j == 0 ? 0 : n) : j; t < n; t += step) {
            const Task tk = TASKS[first + t];
            const int op = t_op(tk);
            fe x, y, z;
            form(x, c, t_form(tk, 0), in1, in2, out, neg);
            if (op == OP_LIN) {
              z = x;
            } else {
              if (op == OP_SQR) {
                y = x;
              } else {
                form(y, c, t_form(tk, 1), in1, in2, out, neg);
              }
              fe_mul(z, x, y);
            }
            st(c, phys(t_d(tk), in1, in2, out), z);
          }
        }
        BARRIER();
        pc++;
      }
    }
    if (flag_of >= 0) {
      tinf |= (uint32_t)res_inf << flag_of;
    } else if (s > 0 && s < nsteps - 1 && pc >= 0) {
      ainf = res_inf;
    }
  }
  // X Z, Y, Z^3 in T4..T6, canonical, or the identity
  EACH_THREAD(j) {
    for (int q = j; q < 3; q += GRP) {
      fe v;
      if (ainf) {
        for (int i = 0; i < NW; i++) v.v[i] = q == 1 && i == 0;
      } else {
        ld(v, c, S_TMP + 4 + q);
        fe_canonical(v, v);
      }
      fe_to_be48(out144 + 48 * q, v);
    }
  }
}

}  // namespace

// Threads per lane, bits per digit, lanes per block and shared memory bytes
// per block of this build.
extern "C" void bls_g1_config(int* group, int* window, int* lanes,
                              int* shared_bytes) {
  *group = GRP;
  *window = WIN;
  *lanes = LANES;
  *shared_bytes = SMEM_BYTES;
}

#if defined(__CUDACC__)

extern __shared__ uint32_t g_slots[];

// A block: LANES lanes, GRP adjacent threads each.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    bls_g1_kernel(const uint8_t* __restrict__ pts,
                  const uint8_t* __restrict__ scalars,
                  uint8_t* __restrict__ out, int n, int nbits) {
  const int k = threadIdx.x / GRP;
  const int lane = blockIdx.x * LANES + k;
  if (lane >= n) return;  // the whole group together
  const int in_warp = threadIdx.x & 31;
  Ctx c;
  c.s = g_slots + k;
  c.stride = STRIDE;
  c.j = threadIdx.x % GRP;
  c.mask = ((1u << GRP) - 1u) << (in_warp & ~(GRP - 1));
  mul_lane(c, pts + 96 * (int64_t)lane, scalars + 16 * (int64_t)lane, nbits,
           out + 144 * (int64_t)lane);
}

static cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      bls_g1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  done = e == cudaSuccess;
  return e;
}

// pts: (n, 96) uint8; scalars: (n, 16) uint8 big-endian; out: (n, 144)
// uint8; 1 <= nbits <= 128.  Launches on `stream`, does not synchronise,
// allocates nothing; returns cudaGetLastError().
extern "C" int bls_g1_launch(const void* pts, const void* scalars, void* out,
                             int n, int nbits, void* stream) {
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    const int blocks = (n + LANES - 1) / LANES;
    bls_g1_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        (const uint8_t*)pts, (const uint8_t*)scalars, (uint8_t*)out, n, nbits);
  }
  return (int)cudaGetLastError();
}

// The launch configuration's resources: blocks resident per SM, threads per
// block, and the compiled kernel's registers, local memory bytes per thread
// and shared memory bytes per block (static and dynamic).  Returns a CUDA
// error code.
extern "C" int bls_g1_occupancy(int* blocks_per_sm, int* threads, int* regs,
                                int* local_bytes, int* shared_bytes) {
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, bls_g1_kernel);
  if (e != cudaSuccess) return (int)e;
  *threads = THREADS;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  *shared_bytes = (int)fa.sharedSizeBytes + SMEM_BYTES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, bls_g1_kernel, THREADS, SMEM_BYTES);
}

__global__ void bls_g1_fe_kernel(int op, const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe x, y, z;
  for (int k = 0; k < NW; k++) {
    x.v[k] = a[NW * i + k];
    y.v[k] = b[NW * i + k];
  }
  fe_op(op, z, x, y);
  for (int k = 0; k < NW; k++) out[NW * i + k] = z.v[k];
}

// The field operations of fe_op on the card (the PTX chains), one thread
// per pair of 12-word values: a, b, out (n, 12) uint32.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int bls_g1_fe_op(int op, const void* a, const void* b, void* out,
                            int n, void* stream) {
  if (n > 0)
    bls_g1_fe_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        op, (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

#else  // host build: a lane's group of threads in turn

extern "C" int bls_g1_host(const uint8_t* pts, const uint8_t* scalars,
                           uint8_t* out, int n, int nbits) {
  static uint32_t slots[NSLOTS * NW];
  Ctx c = {slots, 1, 0, 0};
  for (int i = 0; i < n; i++)
    mul_lane(c, pts + 96 * (int64_t)i, scalars + 16 * (int64_t)i, nbits,
             out + 144 * (int64_t)i);
  return 0;
}

// fe_op on n pairs of 12-word values, for the tests.
extern "C" void bls_g1_fe_op_host(int op, const uint32_t* a, const uint32_t* b,
                                  uint32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    fe x, y, z;
    for (int k = 0; k < NW; k++) {
      x.v[k] = a[NW * i + k];
      y.v[k] = b[NW * i + k];
    }
    fe_op(op, z, x, y);
    for (int k = 0; k < NW; k++) out[NW * i + k] = z.v[k];
  }
}

// The signed digits of n scalars (16 bytes big-endian, low nbits used),
// least significant first, windows(nbits) per scalar into `digits`.
// Returns the digits per scalar.
extern "C" int bls_g1_recode_host(const uint8_t* scalars, int n, int nbits,
                                  int32_t* digits) {
  const int k = windows(nbits);
  for (int i = 0; i < n; i++) {
    uint32_t s2[5];
    scalar_doubled(s2, scalars + 16 * (int64_t)i, nbits);
    for (int d = 0; d < k; d++) digits[(int64_t)i * k + d] = digit(s2, d);
  }
  return k;
}

// Hazards in the schedule: a task of a level writing a slot that another
// task of the same level reads or writes (OUT counted as IN1, which it is
// in the main loop), a task writing an input of the program (IN2, zero),
// or a step out of the tables.  0 for a schedule the group may run in any
// order.
extern "C" int bls_g1_schedule_check_host() {
  int bad = 0;
  const auto alias = [](int id) { return id >= OX && id < T0 ? id - OX + IX : id; };
  const auto reads = [&](Task t, int id) {
    for (int k = 0; k < 2; k++) {
      if (k == 1 && t_op(t) != OP_MUL) break;
      const uint32_t f = t_form(t, k);
      if (alias(f_u(f)) == id || (!f_plain(f) && alias(f_v(f)) == id)) return true;
    }
    return false;
  };
  for (int pc = 0; pc < NSTEPS; pc++) {
    const Step stp = STEPS[pc];
    const int kind = s_kind(stp), n = s_n(stp), first = s_first(stp);
    if (kind != K_PAR && kind != K_SEQ) continue;
    if (n == 0 || first + n > NTASKS) bad++;
    for (int t = 0; t < n && first + t < NTASKS; t++) {
      const Task a = TASKS[first + t];
      const int d = t_d(a);
      if (d == ZR || (d >= QX && d < OX) || d >= NLOGICAL || t_op(a) > OP_SQR)
        bad++;
      for (int k = 0; k < 2; k++) {
        const uint32_t f = t_form(a, k);
        if (f_u(f) >= NLOGICAL || f_v(f) >= NLOGICAL || f_sign(f) > NEG_SUB)
          bad++;
      }
      // a SEQ level's tasks run in order in one thread: only PAR levels
      // must not read or write what another of their tasks writes
      if (kind == K_SEQ) continue;
      for (int u = 0; u < n && first + u < NTASKS; u++) {
        if (u == t) continue;
        const Task b = TASKS[first + u];
        if (reads(b, alias(d)) || alias(t_d(b)) == alias(d)) bad++;
      }
    }
  }
  return bad;
}

#if defined(BLS_TALLY)
// Field multiplies, squares and additions run since the last call (then
// reset).
extern "C" void bls_g1_tally(long long* muls, long long* squares,
                             long long* smalls) {
  *muls = g_tally_mul;
  *squares = g_tally_sq;
  *smalls = g_tally_small;
  g_tally_mul = g_tally_sq = g_tally_small = 0;
}

// The exceptional branches taken since the last call (then reset): a
// doubling of the identity skipped, a digit 0 or an entry at infinity
// skipped, an addition to the identity copied, H = 0 doubled, H = 0 gone to
// the identity.
extern "C" void bls_g1_branches(long long* out5) {
  for (int i = 0; i < 5; i++) {
    out5[i] = g_branch[i];
    g_branch[i] = 0;
  }
}

// Multiply levels and addition levels one thread of a group ran since the
// last call (a level of n operations is ceil(n / G) rounds), then reset:
// the multiply rounds are the lane's chain of dependent multiplies.
extern "C" void bls_g1_rounds(long long* mul_rounds, long long* lin_rounds) {
  *mul_rounds = g_rounds_mul;
  *lin_rounds = g_rounds_lin;
  g_rounds_mul = g_rounds_lin = 0;
}
#endif

#endif
