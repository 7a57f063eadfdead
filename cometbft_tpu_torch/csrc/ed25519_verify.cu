// Batched Ed25519 ZIP-215 signature verification for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel of cometbft_tpu/ops/pallas_verify.py
// (`_kernel` / `_kernel_body`, launched by `pl.pallas_call` at :94 through
// `verify_core_pallas`), together with the XLA byte unpacking and digit
// recoding that runs ahead of it there.  Raw bytes in, one accept word per
// signature out:
//
//   accept = ok_A && ok_R && s_ok && [8](s*B + m*A - R) == identity
//
// with A and R decompressed under ZIP-215 rules (non-canonical y >= p and a
// "-0" sign accepted, small-order points accepted) and m = (L - h) mod L
// computed on the host.
//
// What bounds it on this card: integer multiplies.  A signature costs 1,914
// field multiplies and 1,546 squares (two ~255-square decompression chains
// and a 64-position Straus walk), 100 or 55 32x32->64-bit products each,
// against 133 bytes of input and output, so the bound is the SMs' integer
// multiply rate.  The field code is fe25519.cuh (ref10's radix 2^25.5).
//
// What the design does about it: four threads per signature.
// * A quad of four adjacent threads of a warp holds one signature's point,
//   thread k of the quad coordinate k: X, Y, Z, T of an extended or
//   completed point, or the four fields of a table entry.  ref10's formulas
//   are four independent products at each step (the doubling's four
//   squares, the additions' four products against the cached point, the
//   four products back to extended form), so each step is one field product
//   per thread, and operands move between the threads of the quad with
//   __shfl_sync under the quad's own mask.  A 10,240-signature commit is
//   1,280 warps, so every one of the card's 132 SMs has work, and a thread
//   holds one coordinate and its temporaries instead of four points.
// * The per-signature table {0..8}*A (cached form) and R live in shared
//   memory, limb-major with the thread index innermost, so the 32 reads of
//   one limb by a warp fall in 32 distinct banks whatever the digits.  The
//   constant table {0..8}*B (niels form, Z = 1) arrives as a device tensor
//   and is copied into shared memory once per block.
// * Decompression is a serial square-root chain per point: thread 0 of the
//   quad decompresses A and thread 1 R, at the same time (threads 2 and 3
//   repeat them and their results are dropped).  The signed radix-16
//   recoding runs in threads 0 and 1 (s and m) into shared memory.
// * Blocks of 64 threads (16 signatures).  Every thread of a launched warp
//   runs every step: a quad past the batch's end works on the last
//   signature's bytes and skips the store, so no thread named in a shuffle
//   mask has exited.
//
// Without __CUDACC__ the same source builds for the host.  There a "quad
// register" holds the values of all 64 threads of a block, every step is a
// loop over them, and an exchange reads the array: the block runs in
// lockstep as it does on the card, padding quads included, so the
// formulas, the exchanges and the ragged edge are checked on a machine with
// no card.  With ED25519_TALLY the host build counts the field multiplies
// and squares whose results are used.

#include "fe25519.cuh"

// ED25519_STAGE stops the kernel early, for the stage profile: 1 after
// decompressing A and R, 2 after the {0..8}*A table, 3 after the Straus
// walk, 4 (the default) runs the whole verify.  A truncated build returns
// ok_A | ok_R << 1, plus bit 2 from the last value computed so that no
// stage is optimised away.
#ifndef ED25519_STAGE
#define ED25519_STAGE 4
#endif

// Blocks per SM the compiler must fit (__launch_bounds__), which caps the
// registers per thread at 65536 / (THREADS * MIN_BLOCKS): 6 gives 168, and
// the decompression's square-root chain then fits with no spills (8, at 128
// registers, spilled and was no faster).  Shared memory allows 7 blocks per
// SM; a 10,240-signature commit needs 5.
#define MIN_BLOCKS 6

#define THREADS 64          // threads per block
#define SIGS (THREADS / 4)  // signatures per block
#define ENTRIES 10          // table slots: {0..8}*A, then R

#if defined(__CUDACC__)
#define MEMBER __device__ __forceinline__
#define SYNC_BLOCK() __syncthreads()
#else
#define MEMBER inline
#define SYNC_BLOCK() ((void)0)
#endif

namespace {

// --- the quad -------------------------------------------------------------

#if defined(__CUDACC__)
// On the card a quad register is this thread's value.
#define LANES 1
template <class T>
struct Q {
  T v;
  MEMBER T& operator[](int) { return v; }
  MEMBER const T& operator[](int) const { return v; }
};
DEV int thread_of(int) { return threadIdx.x; }
#else
// On the host it holds every thread of the block.
#define LANES THREADS
template <class T>
struct Q {
  T v[THREADS];
  MEMBER T& operator[](int i) { return v[i]; }
  MEMBER const T& operator[](int i) const { return v[i]; }
};
DEV int thread_of(int i) { return i; }
#endif
#define FOR_LANES(i) for (int i = 0; i < LANES; i++)

// The tally counts the work of threads that hold a signature: a padding
// quad runs every step too, but its products are not used.
#if defined(ED25519_TALLY) && !defined(__CUDACC__)
static int g_live_threads = THREADS;
#define TALLY_LANE(i) (g_tally_on = (i) < g_live_threads)
#else
#define TALLY_LANE(i) ((void)0)
#endif

// Source lane, per quad lane k = 0..3, of an exchange.
#define SRC(a, b, c, d) ((a) | (b) << 4 | (c) << 8 | (d) << 12)
#define QUAD_MASK (0xFu << (threadIdx.x & 28))  // this thread's quad
DEV int src_lane(int src, int k) { return (src >> (4 * k)) & 3; }
DEV bool lane_in(int lanes, int k) { return (lanes >> k) & 1; }

// out = in as held by lane src(k) of the same quad.  `out` and `in` must be
// different registers.
DEV void q_take(Q<fe>& out, const Q<fe>& in, int src) {
#if defined(__CUDACC__)
  const unsigned mask = QUAD_MASK;
  const int from = src_lane(src, threadIdx.x & 3);
#pragma unroll
  for (int l = 0; l < 10; l++) out.v.v[l] = __shfl_sync(mask, in.v.v[l], from, 4);
#else
  for (int i = 0; i < THREADS; i++) out[i] = in[(i & ~3) | src_lane(src, i & 3)];
#endif
}

DEV void q_take(Q<int>& out, const Q<int>& in, int src) {
#if defined(__CUDACC__)
  const unsigned mask = QUAD_MASK;
  out.v = __shfl_sync(mask, in.v, src_lane(src, threadIdx.x & 3), 4);
#else
  for (int i = 0; i < THREADS; i++) out[i] = in[(i & ~3) | src_lane(src, i & 3)];
#endif
}

DEV void sync_quad() {
#if defined(__CUDACC__)
  __syncwarp(QUAD_MASK);
#endif
}

// h = f * g on the quad lanes in `useful`; the other lanes pass f through.
// On the card an idle lane computes its product in lockstep with its quad
// and drops it (skipping would save no time); the host build skips it, so
// the tally counts only products that are used.
DEV void q_mul(Q<fe>& h, const Q<fe>& f, const Q<fe>& g, int useful) {
  FOR_LANES(i) {
    const bool use = lane_in(useful, thread_of(i) & 3);
    TALLY_LANE(i);
#if defined(__CUDACC__)
    fe r;
    fe_mul(r, f[i], g[i]);
#pragma unroll
    for (int l = 0; l < 10; l++) h[i].v[l] = use ? r.v[l] : f[i].v[l];
#else
    if (use) fe_mul(h[i], f[i], g[i]);
    else h[i] = f[i];
#endif
  }
}

// h = f^2 on every lane, doubled on the lanes in `doubled`.
DEV void q_sq(Q<fe>& h, const Q<fe>& f, int doubled) {
  FOR_LANES(i) {
    TALLY_LANE(i);
    fe_sq_shl(h[i], f[i], lane_in(doubled, thread_of(i) & 3));
  }
}

// out = cf * f + cg * g per limb, with small per-lane coefficients.
// (Multiplies: masks and adds instead measured slower, the ALU being the
// busier pipe.)
DEV void lin(fe& out, int cf, const fe& f, int cg, const fe& g) {
#pragma unroll
  for (int l = 0; l < 10; l++) out.v[l] = cf * f.v[l] + cg * g.v[l];
}

// out = ca * a + cb * b + cc * c per limb.
DEV void lin3(fe& out, int ca, const fe& a, int cb, const fe& b, int cc,
              const fe& c) {
#pragma unroll
  for (int l = 0; l < 10; l++) out.v[l] = ca * a.v[l] + cb * b.v[l] + cc * c.v[l];
}

// --- point formulas (ref10; complete for a = -1 and non-square d) ----------
//
// Lane k of a quad holds coordinate k: (X, Y, Z, T) of an extended (P3) or
// completed (P1P1) point, (Y+X, Y-X, Z, 2dT) of a cached one, and
// (y+x, y-x, 1, 2dxy) of a niels base point.  Carry annotations count the
// carried values a multiplier input sums (at most three).

// Completed -> extended: (X*T, Y*Z, Z*T, X*Y).  useful = 0x7 leaves out T,
// which a doubling does not read (ref10's P2 form); then lanes 0-2 each
// have their first operand already and one exchange brings the second.
DEV void q_to_p3(Q<fe>& r, const Q<fe>& p, int useful) {
  Q<fe> f, g;
  q_take(g, p, SRC(3, 2, 3, 1));
  if (useful == 0x7) {
    q_mul(r, p, g, useful);
  } else {
    q_take(f, p, SRC(0, 1, 2, 0));
    q_mul(r, f, g, useful);
  }
}

// r = 2p in completed form, from p's X, Y, Z (dbl-2008-hwcd).  Lanes
// square C = (X+Y)^2, B = Y^2, D = 2Z^2 and A = X^2 (one exchange brings
// lane 0 its Y and lane 3 its X), then X' = C - A - B, Y' = B + A,
// Z' = B - A, T' = D - Z' (two exchanges).
DEV void q_dbl(Q<fe>& r, const Q<fe>& p) {
  Q<fe> s, u;
  q_take(u, p, SRC(1, 1, 2, 0));
  FOR_LANES(i) {
    const int k = thread_of(i) & 3;
    // lane 0: X+Y (2 carried values), lane 3: X, lanes 1, 2: Y, Z
    lin(s[i], k == 3 ? 0 : 1, p[i], (k == 0 || k == 3) ? 1 : 0, u[i]);
  }
  q_sq(s, s, 1 << 2);
  Q<fe> ta, tb;
  q_take(ta, s, SRC(3, 3, 3, 2));  // A, and D to lane 3
  q_take(tb, s, SRC(1, 1, 1, 1));  // B
  FOR_LANES(i) {
    const int k = thread_of(i) & 3;
    // X' = C - A - B: 3, Y' = B + A: 2, Z' = B - A: 2, T' = D - B + A: 3
    const int co = k == 2 ? 0 : 1;
    const int ca = (k == 0 || k == 2) ? -1 : 1;
    const int cb = k == 1 ? 0 : (k == 2 ? 1 : -1);
    lin3(r[i], co, s[i], ca, ta[i], cb, tb[i]);
  }
}

// Lane 0: Y+X, lane 1: Y-X (2 carried values each), lanes 2, 3: Z, T.
DEV void q_sum_diff(Q<fe>& f, const Q<fe>& p) {
  Q<fe> o;
  q_take(o, p, SRC(1, 0, 2, 3));  // lane 0 gets Y, lane 1 gets X
  FOR_LANES(i) {
    const int k = thread_of(i) & 3;
    lin(f[i], 1, p[i], k == 0 ? 1 : (k == 1 ? -1 : 0), o[i]);
  }
}

// r = p + q in completed form for q cached (Y+X, Y-X, Z, 2dT), or with
// useful = 0xB for q niels (y+x, y-x, 1, 2dxy), whose Z product is not
// needed: P = ((Y+X) q0, (Y-X) q1, Z q2, T q3), then X' = P0 - P1,
// Y' = P0 + P1, Z' = 2 P2 + P3, T' = 2 P2 - P3, each lane from its own P
// and its partner's (k ^ 1).
DEV void q_add(Q<fe>& r, const Q<fe>& p, const Q<fe>& q, int useful) {
  Q<fe> f, o;
  q_sum_diff(f, p);
  q_mul(f, f, q, useful);
  q_take(o, f, SRC(1, 0, 3, 2));
  FOR_LANES(i) {
    const int k = thread_of(i) & 3;
    // X' = P0 - P1: 2, Y' = P1 + P0: 2, Z' = 2 P2 + P3: 3, T' = 2 P2 - P3: 3
    lin(r[i], k == 3 ? -1 : (k == 2 ? 2 : 1), f[i],
        k == 0 ? -1 : (k == 3 ? 2 : 1), o[i]);
  }
}

// Extended -> cached: (Y+X, Y-X, Z, 2d*T), lane 3's product.
DEV void q_to_cached(Q<fe>& c, const Q<fe>& p) {
  Q<fe> d2;
  q_sum_diff(c, p);
  FOR_LANES(i) d2[i] = fe_d2();
  q_mul(c, c, d2, 1 << 3);
}

// The identity (0, 1, 1, 0).
DEV void q_identity(Q<fe>& p) {
  FOR_LANES(i) {
    const int k = thread_of(i) & 3;
    p[i] = (k == 1 || k == 2) ? fe_one() : fe_zero();
  }
}

// --- shared memory ----------------------------------------------------------

struct Shared {
  // per-signature cached table, [entry][limb][thread]: thread t stores
  // coordinate t & 3 of its quad's entry; entry 9 is R
  int32_t ta[ENTRIES][10][THREADS];
  // the base table {0..8}*B, [limb][4 * entry + coordinate], niels with Z=1
  int32_t bt[10][9 * 4];
  // signed radix-16 digits of s (0) and m (1), [scalar][position][quad]
  int8_t dig[2][64][SIGS];
};

DEV void store_entry(Shared& sh, int e, const Q<fe>& c) {
  FOR_LANES(i) {
#pragma unroll
    for (int l = 0; l < 10; l++) sh.ta[e][l][thread_of(i)] = c[i].v[l];
  }
}

// Lane k's coordinate of sign * entry e: a negative sign swaps Y+X and Y-X
// (coordinates 0 and 1) and negates 2dT (coordinate 3).
DEV void q_select_cached(Q<fe>& c, const Shared& sh, const Q<int>& e,
                         const Q<int>& neg) {
  FOR_LANES(i) {
    const int t = thread_of(i), k = t & 3;
    const int from = (t & ~3) | (neg[i] && k < 2 ? k ^ 1 : k);
    const int32_t sg = -(int32_t)(neg[i] && k == 3);
#pragma unroll
    for (int l = 0; l < 10; l++) c[i].v[l] = (sh.ta[e[i]][l][from] ^ sg) - sg;
  }
}

DEV void q_select_base(Q<fe>& c, const Shared& sh, const Q<int>& e,
                       const Q<int>& neg) {
  FOR_LANES(i) {
    const int k = thread_of(i) & 3;
    const int col = 4 * e[i] + (neg[i] && k < 2 ? k ^ 1 : k);
    const int32_t sg = -(int32_t)(neg[i] && k == 3);
#pragma unroll
    for (int l = 0; l < 10; l++) c[i].v[l] = (sh.bt[l][col] ^ sg) - sg;
  }
}

// --- per-thread pieces --------------------------------------------------------

// (ok, x) with x = sqrt(u/v) when u/v is a square; ok is false iff it is
// not.  Same steps as the JAX package's fe25519.sqrt_ratio.
DEV bool fe_sqrt_ratio(fe& x, const fe& u, const fe& v) {
  fe v3, t, r, vx2, chk, xm;
  fe_sq(v3, v);
  fe_mul(v3, v3, v);  // v^3
  fe_sq(t, v3);
  fe_mul(t, t, v);    // v^7
  fe_mul(t, u, t);    // u v^7
  fe_mul(x, u, v3);   // u v^3, before the chain so that v3 dies
  fe_pow22523(r, t);
  fe_mul(x, x, r);
  fe_sq(vx2, x);
  fe_mul(vx2, vx2, v);
  fe_sub(chk, vx2, u);
  const bool ok1 = fe_iszero(chk);
  fe_add(chk, vx2, u);
  const bool ok2 = fe_iszero(chk);
  fe_mul(xm, x, fe_sqrtm1());
#pragma unroll
  for (int l = 0; l < 10; l++) x.v[l] = ok2 ? xm.v[l] : x.v[l];
  return ok1 || ok2;
}

// ZIP-215 decompression (the JAX package's ed25519_point.decompress): y
// unreduced, x the even root, then negated when the sign bit is set (so a
// "-0" encoding decodes to x = 0).  x and y come out carried.
DEV int decompress(fe& x, fe& y, const uint8_t* s) {
  fe u, v;
  fe_frombytes(y, s);
  fe_reduce(y, y);
  fe_sq(u, y);
  fe_mul(v, u, fe_d());
  fe_add(v, v, fe_one());  // d y^2 + 1
  fe_sub(u, u, fe_one());  // y^2 - 1
  const bool ok = fe_sqrt_ratio(x, u, v);
  // y again from its bytes rather than kept through the square root
  fe_frombytes(y, s);
  fe_reduce(y, y);
  fe_freeze(x, x);
  const int32_t neg = -(int32_t)((x.v[0] & 1) ^ (s[31] >> 7));
#pragma unroll
  for (int l = 0; l < 10; l++) x.v[l] = (x.v[l] ^ neg) - neg;
  fe_reduce(x, x);
  return ok ? 1 : 0;
}

// (x, y, 1, x*y) from the affine x, y held by quad lane `from`.
DEV void q_point(Q<fe>& p, const Q<fe>& x, const Q<fe>& y, int from) {
  Q<fe> xs, ys;
  const int src = from * SRC(1, 1, 1, 1);
  q_take(xs, x, src);
  q_take(ys, y, src);
  FOR_LANES(i) {
    const int k = thread_of(i) & 3;
    if (k == 1) xs[i] = ys[i];
    if (k == 2) xs[i] = fe_one();
  }
  q_mul(p, xs, ys, 1 << 3);
}

// 32-byte little-endian scalar < 2^253 -> 64 signed radix-16 digits in
// [-8, 7], least significant first (the top carry is absorbed because the
// scalar is below L), stored at dig[position * SIGS].
DEV void recode(int8_t* dig, const uint8_t* s) {
  int carry = 0;
  for (int k = 0; k < 64; k++) {
    const int d = ((s[k >> 1] >> (4 * (k & 1))) & 15) + carry;
    carry = d >= 8;
    dig[k * SIGS] = (int8_t)(d - (carry << 4));
  }
}

// --- one block: SIGS signatures, four threads each ----------------------------

DEV void verify_block(Shared& sh, const uint8_t* a, const uint8_t* r,
                      const uint8_t* s, const uint8_t* m,
                      const uint8_t* s_ok, const int32_t* base_tbl,
                      int32_t* out, int n, int block) {
  // the base table, with Z = 1 as coordinate 2 of every entry
  FOR_LANES(i) {
    for (int j = thread_of(i); j < 10 * 9 * 4; j += THREADS) {
      const int l = j / 36, e = (j % 36) / 4, c = j % 4;
      sh.bt[l][4 * e + c] =
          c == 2 ? (l == 0) : base_tbl[(e * 3 + (c == 3 ? 2 : c)) * 10 + l];
    }
  }
  SYNC_BLOCK();

  // signature of each thread; a quad past the end repeats the last one
  Q<int> sig;
  FOR_LANES(i) {
    const int g = block * SIGS + (thread_of(i) >> 2);
    sig[i] = g < n ? g : n - 1;
  }

  // lane 0 decompresses A, lane 1 R (lanes 2, 3 repeat them on the card)
  Q<fe> x, y;
  Q<int> ok;
  FOR_LANES(i) {
    const int k = thread_of(i) & 3;
#if !defined(__CUDACC__)
    if (k >= 2) {
      x[i] = y[i] = fe_zero();
      ok[i] = 0;
      continue;
    }
#endif
    TALLY_LANE(i);
    ok[i] = decompress(x[i], y[i], ((k & 1) ? r : a) + (size_t)sig[i] * 32);
  }
  Q<int> ok_a, ok_r;
  q_take(ok_a, ok, SRC(0, 0, 0, 0));
  q_take(ok_r, ok, SRC(1, 1, 1, 1));

  // A and R as quad points; R goes to the table as entry 9
  Q<fe> pa, t, c;
  q_point(pa, x, y, 0);
  q_point(t, x, y, 1);
  q_to_cached(c, t);
  store_entry(sh, 9, c);
#if ED25519_STAGE == 1
  Q<int> chk;
  FOR_LANES(i) chk[i] = pa[i].v[0] ^ c[i].v[0];
#else
  // digits: lane 0 recodes s, lane 1 m
  FOR_LANES(i) {
    const int k = thread_of(i) & 3;
    if (k < 2) {
      recode(&sh.dig[k][0][thread_of(i) >> 2], (k ? m : s) + (size_t)sig[i] * 32);
    }
  }

  // the table {0..8}*A in cached form
  Q<fe> p, ca;
  q_identity(p);
  q_to_cached(c, p);
  store_entry(sh, 0, c);
  q_to_cached(ca, pa);
  store_entry(sh, 1, ca);
  p = pa;
  for (int e = 2; e < 9; e++) {
    q_add(t, p, ca, 0xF);
    q_to_p3(p, t, 0xF);
    q_to_cached(c, p);
    store_entry(sh, e, c);
  }
  sync_quad();
#if ED25519_STAGE == 2
  Q<int> chk;
  FOR_LANES(i) chk[i] = sh.ta[8][0][thread_of(i)];
#else
  // s*B + m*A, signed radix-16 Straus, most significant digit first
  Q<int> e, neg;
  q_identity(p);
  for (int pos = 63; pos >= 0; pos--) {
    for (int d = 0; d < 4; d++) {
      q_dbl(t, p);
      q_to_p3(p, t, d < 3 ? 0x7 : 0xF);
    }
    FOR_LANES(i) {
      const int dm = sh.dig[1][pos][thread_of(i) >> 2];
      e[i] = dm < 0 ? -dm : dm;
      neg[i] = dm < 0;
    }
    q_select_cached(c, sh, e, neg);
    q_add(t, p, c, 0xF);
    q_to_p3(p, t, 0xF);
    FOR_LANES(i) {
      const int ds = sh.dig[0][pos][thread_of(i) >> 2];
      e[i] = ds < 0 ? -ds : ds;
      neg[i] = ds < 0;
    }
    q_select_base(c, sh, e, neg);
    q_add(t, p, c, 0xB);
    q_to_p3(p, t, 0xF);
  }
#if ED25519_STAGE == 3
  Q<int> chk;
  FOR_LANES(i) chk[i] = p[i].v[0];
#else
  // [8](p - R) == identity
  FOR_LANES(i) {
    e[i] = 9;
    neg[i] = 1;
  }
  q_select_cached(c, sh, e, neg);
  q_add(t, p, c, 0xF);
  q_to_p3(p, t, 0x7);
  for (int d = 0; d < 3; d++) {
    q_dbl(t, p);
    q_to_p3(p, t, 0x7);
  }
  // lane 0 tests X, lane 1 Y - Z
  Q<fe> z;
  Q<int> zero, zx, zyz;
  q_take(z, p, SRC(0, 2, 2, 2));
  FOR_LANES(i) {
    fe d;
    lin(d, 1, p[i], (thread_of(i) & 3) == 1 ? -1 : 0, z[i]);
    zero[i] = fe_iszero(d);
  }
  q_take(zx, zero, SRC(0, 0, 0, 0));
  q_take(zyz, zero, SRC(1, 1, 1, 1));
#endif
#endif
#endif

  FOR_LANES(i) {
    const int t_ = thread_of(i);
    const int g = block * SIGS + (t_ >> 2);
    if ((t_ & 3) != 0 || g >= n) continue;
#if ED25519_STAGE == 4
    out[g] = (ok_a[i] && ok_r[i] && s_ok[g] && zx[i] && zyz[i]) ? 1 : 0;
#else
    out[g] = ok_a[i] | (ok_r[i] << 1) | ((chk[i] != INT32_MIN) << 2);
#endif
  }
}

}  // namespace

#if defined(__CUDACC__)

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    ed25519_verify_kernel(const uint8_t* __restrict__ a,
                          const uint8_t* __restrict__ r,
                          const uint8_t* __restrict__ s,
                          const uint8_t* __restrict__ m,
                          const uint8_t* __restrict__ s_ok,
                          const int32_t* __restrict__ base_tbl,
                          int32_t* __restrict__ out, int n) {
  __shared__ Shared sh;
  verify_block(sh, a, r, s, m, s_ok, base_tbl, out, n, blockIdx.x);
}

// a, r, s, m: (n, 32) uint8; s_ok: (n,) uint8; base_tbl: (9, 3, 10) int32
// niels limbs of {0..8}*B; out: (n,) int32.  Launches on `stream`, does
// not synchronise, allocates nothing; returns cudaGetLastError().
extern "C" int ed25519_verify_launch(const void* a, const void* r,
                                     const void* s, const void* m,
                                     const void* s_ok, const void* base_tbl,
                                     void* out, int n, void* stream) {
  if (n > 0) {
    const int blocks = (n + SIGS - 1) / SIGS;
    ed25519_verify_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)a, (const uint8_t*)r, (const uint8_t*)s,
        (const uint8_t*)m, (const uint8_t*)s_ok, (const int32_t*)base_tbl,
        (int32_t*)out, n);
  }
  return (int)cudaGetLastError();
}

// The launch configuration's resources: blocks resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), threads per block, and
// the compiled kernel's registers, local memory and static shared memory
// bytes per thread or block.  Returns a CUDA error code.
extern "C" int ed25519_verify_occupancy(int* blocks_per_sm, int* threads,
                                        int* regs, int* local_bytes,
                                        int* shared_bytes) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, ed25519_verify_kernel);
  if (e != cudaSuccess) return (int)e;
  *threads = THREADS;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  *shared_bytes = (int)fa.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ed25519_verify_kernel, THREADS, 0);
}

#else  // host build: each block's 64 threads in lockstep

extern "C" int ed25519_verify_host(const uint8_t* a, const uint8_t* r,
                                   const uint8_t* s, const uint8_t* m,
                                   const uint8_t* s_ok,
                                   const int32_t* base_tbl, int32_t* out,
                                   int n) {
  static Shared sh;
  for (int b = 0; b * SIGS < n; b++) {
#if defined(ED25519_TALLY)
    const int live = 4 * (n - b * SIGS);
    g_live_threads = live < THREADS ? live : THREADS;
#endif
    verify_block(sh, a, r, s, m, s_ok, base_tbl, out, n, b);
  }
#if defined(ED25519_TALLY)
  g_tally_on = true;
#endif
  return 0;
}

#if defined(ED25519_TALLY)
// Field multiplies and squares run since the last call (then reset).
extern "C" void ed25519_tally(long long* muls, long long* squares) {
  *muls = g_tally_mul;
  *squares = g_tally_sq;
  g_tally_mul = 0;
  g_tally_sq = 0;
}
#endif

#endif
