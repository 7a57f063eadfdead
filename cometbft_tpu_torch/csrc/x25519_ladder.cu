// RFC 7748 X25519, many exchanges per launch, for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA program _ladder_fn of cometbft_tpu/ops/x25519_ladder.py:135
// with its inversion _inv (:113).  The JAX program takes the clamped
// scalars as a (255, lanes) bit tensor and hands back 13-bit limbs; this
// kernel takes them as they are on the wire:
//
//   in:  scalars (lanes, 32) bytes, clamped by the caller (RFC 7748 5: bits
//        0-2 and 255 clear, bit 254 set), and u (lanes, 32) bytes, decoded
//        as RFC 7748 says (bit 255 dropped, u >= p accepted: fe_frombytes);
//   out: (lanes, 32) bytes, the canonical little-endian u of scalar * u.
//
// What bounds it: 255 x (5 x 100 + 4 x 55 + 10) + 254 x 55 + 12 x 100 =
// 201,320 32x32->64-bit products a lane (the RFC's ladder and the 2^255 - 21
// inversion), ~3 us of the card's INT32 lanes at 256 lanes.  But a lane is
// a chain: the RFC's step is 10 field operations one after another, 2,816
// for the whole exchange, and at 256 lanes a few hundred chains cannot
// fill the card: the time is a chain's latency.
//
// Design: a quad of four adjacent threads per exchange, thread k of the
// quad holding one of x2, z2, x3, z3 (k = 0..3), on csrc/fe25519.cuh's
// field (10 signed limbs in radix 2^25.5, int64 column sums, ref10's carry
// bounds: every multiplier input below is a sum or difference of at most
// two carried values).  A step of the ladder runs in levels, every thread
// doing the same operation on its own operands, which come from the quad by
// __shfl_sync under the quad's own mask:
//   0. the conditional swap of (x2, z2) with (x3, z3): each thread takes
//      its value from thread k ^ 2 and keeps it under a mask of the swap
//      bit (no branch and no shuffle source depends on a secret bit);
//   1. A = x2 + z2, B = x2 - z2, C = x3 + z3, D = x3 - z3 (partner k ^ 1);
//   2. AA = A A, BB = B B, CB = C B, DA = D A (one multiply each);
//   3. from the partner k ^ 1: x2 = AA BB, z2 = E (AA + a24 E) with E =
//      AA - BB (a small multiply first), x3 = (DA + CB)^2, (DA - CB)^2;
//   4. z3 = x1 (DA - CB)^2 on thread 3 (the others keep their value).
// So a step is 3 multiplies and a small multiply deep, not 10 operations.
// (z2's multiply moved to level 4, beside z3's, takes the small multiply
// off the path, but measured no faster: PERF.md.)
// The inversion z2^(p - 2) by the 2^255 - 21 chain (254 squares, 11
// multiplies) stays one chain: the quad runs it in lockstep on z2 and x2
// taken from threads 1 and 0, and thread k writes bytes 8k..8k+7 of the
// frozen x2 / z2.  A low-order u gives 0, as the RFC's ladder does; the
// caller decides what that means.  Blocks of X25519_THREADS threads.  A
// quad past the batch's end repeats the last exchange and stores nothing.
//
// Without __CUDACC__ the same source builds for the host.  There a "quad
// register" holds the values of all threads of a block, every step is a
// loop over them, and an exchange reads the array: the block runs in
// lockstep as it does on the card, padding quads included.  With
// -DX25519_TALLY it counts the field multiplies, squares and small
// multiplies whose results are used (a thread that keeps its value at a
// level, a padding quad and the inversion's three repeats are not
// counted).

#if defined(X25519_TALLY) && !defined(__CUDACC__)
#define ED25519_TALLY  // fe25519.cuh's counters of multiplies and squares
static long long g_tally_small = 0;
#define TALLY_SMALL() (g_tally_small += g_tally_on)
#define TALLY_WHEN(cond) (g_tally_on = (cond))
#else
#define TALLY_SMALL() ((void)0)
#define TALLY_WHEN(cond) ((void)0)
#endif

#include "fe25519.cuh"

// Threads per block (32 exchanges, a warp per 8).  32, 64 and 128 took
// the same time within 0.2% at 256 lanes, a warp's chain each (PERF.md);
// 128 puts 256 exchanges on 8 SMs instead of 32, leaving the rest free.
#ifndef X25519_THREADS
#define X25519_THREADS 128
#endif
#define X25519_PER_BLOCK (X25519_THREADS / 4)
#define X25519_A24 121665

#if defined(__CUDACC__)
#define MEMBER __device__ __forceinline__
#else
#define MEMBER inline
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
#define LANES X25519_THREADS
template <class T>
struct Q {
  T v[X25519_THREADS];
  MEMBER T& operator[](int i) { return v[i]; }
  MEMBER const T& operator[](int i) const { return v[i]; }
};
DEV int thread_of(int i) { return i; }
#endif
#define FOR_LANES(i) for (int i = 0; i < LANES; i++)

#define QUAD_MASK (0xFu << (threadIdx.x & 28))  // this thread's quad

// out = in as held by thread k ^ x of the same quad.  `out` and `in` must
// be different registers.
DEV void q_xor(Q<fe>& out, const Q<fe>& in, int x) {
#if defined(__CUDACC__)
  const unsigned mask = QUAD_MASK;
#pragma unroll
  for (int l = 0; l < 10; l++) out.v.v[l] = __shfl_xor_sync(mask, in.v.v[l], x, 4);
#else
  for (int i = 0; i < X25519_THREADS; i++) out[i] = in[i ^ x];
#endif
}

// out = in as held by thread `src` of the same quad (the same for all).
DEV void q_from(Q<fe>& out, const Q<fe>& in, int src) {
#if defined(__CUDACC__)
  const unsigned mask = QUAD_MASK;
#pragma unroll
  for (int l = 0; l < 10; l++) out.v.v[l] = __shfl_sync(mask, in.v.v[l], src, 4);
#else
  for (int i = 0; i < X25519_THREADS; i++) out[i] = in[(i & ~3) | src];
#endif
}

// Level 2's exchange: threads 0 and 1 keep their value, thread 2 takes
// thread 1's (B), thread 3 thread 0's (A).
DEV void q_take_ab(Q<fe>& out, const Q<fe>& in) {
#if defined(__CUDACC__)
  const unsigned mask = QUAD_MASK;
  const int k = threadIdx.x & 3, src = k < 2 ? k : 3 - k;
#pragma unroll
  for (int l = 0; l < 10; l++) out.v.v[l] = __shfl_sync(mask, in.v.v[l], src, 4);
#else
  for (int i = 0; i < X25519_THREADS; i++) {
    const int k = i & 3;
    out[i] = in[(i & ~3) | (k < 2 ? k : 3 - k)];
  }
#endif
}

// h = f * k for a small constant k (< 2^17): 10 products, one carry.
DEV void fe_mul_small(fe& h, const fe& f, int32_t k) {
  TALLY_SMALL();
  int64_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = (int64_t)f.v[i] * k;
  fe_carry_wide(h, t);
}

// out = cf * f + cg * g per limb, with small per-thread coefficients.
DEV void lin(fe& out, int cf, const fe& f, int cg, const fe& g) {
#pragma unroll
  for (int l = 0; l < 10; l++) out.v[l] = cf * f.v[l] + cg * g.v[l];
}

// out = z^(p - 2) = z^(2^255 - 21), ref10's chain (254 squares, 11
// multiplies): the JAX _inv's addition chain.
DEV void fe_invert(fe& out, const fe& z) {
  fe t0, t1, t2, t3;
  fe_sq(t0, z);         // 2
  fe_sq(t1, t0);
  fe_sq(t1, t1);        // 8
  fe_mul(t1, z, t1);    // 9
  fe_mul(t0, t0, t1);   // 11
  fe_sq(t2, t0);        // 22
  fe_mul(t1, t1, t2);   // 2^5 - 1
  fe_sq(t2, t1);
  for (int i = 1; i < 5; i++) fe_sq(t2, t2);
  fe_mul(t1, t2, t1);   // 2^10 - 1
  fe_sq(t2, t1);
  for (int i = 1; i < 10; i++) fe_sq(t2, t2);
  fe_mul(t2, t2, t1);   // 2^20 - 1
  fe_sq(t3, t2);
  for (int i = 1; i < 20; i++) fe_sq(t3, t3);
  fe_mul(t2, t3, t2);   // 2^40 - 1
  fe_sq(t2, t2);
  for (int i = 1; i < 10; i++) fe_sq(t2, t2);
  fe_mul(t1, t2, t1);   // 2^50 - 1
  fe_sq(t2, t1);
  for (int i = 1; i < 50; i++) fe_sq(t2, t2);
  fe_mul(t2, t2, t1);   // 2^100 - 1
  fe_sq(t3, t2);
  for (int i = 1; i < 100; i++) fe_sq(t3, t3);
  fe_mul(t2, t3, t2);   // 2^200 - 1
  fe_sq(t2, t2);
  for (int i = 1; i < 50; i++) fe_sq(t2, t2);
  fe_mul(t1, t2, t1);   // 2^250 - 1
  fe_sq(t1, t1);
  for (int i = 1; i < 5; i++) fe_sq(t1, t1);
  fe_mul(out, t1, t0);  // 2^255 - 32 + 11 = 2^255 - 21
}

// Little-endian 64-bit word j (0..3) of a frozen (canonical) element.
DEV uint64_t fe_word_frozen(const fe& h, int j) {
  uint64_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int off = LIMB_OFF(i), sh = off & 63;
    const uint64_t v = (uint64_t)(uint32_t)h.v[i];
    w[off >> 6] |= v << sh;
    if (sh + LIMB_BITS(i) > 64) w[(off >> 6) + 1] |= v >> (64 - sh);
  }
  uint64_t r = w[0];
#pragma unroll
  for (int k = 1; k < 4; k++) r = j == k ? w[k] : r;  // no dynamic index
  return r;
}

// Word `j` (0..7) of a scalar held as 8 words, by selects.
DEV uint32_t word_at(const uint32_t s[8], int j) {
  uint32_t r = s[0];
#pragma unroll
  for (int k = 1; k < 8; k++) r = j == k ? s[k] : r;
  return r;
}

struct Scalar {
  uint32_t w[8];
};

// The exchanges of block `block`: on the card this thread's part, on the
// host every thread of the block in lockstep.
DEV void ladder_block(const uint8_t* scalars, const uint8_t* us, int lanes,
                      uint8_t* out, int block) {
  Q<fe> x1, v, o, a, e, m;
  Q<Scalar> sc;
  Q<int32_t> swap;
  FOR_LANES(i) {
    const int t = thread_of(i), k = t & 3;
    const int ex = block * X25519_PER_BLOCK + (t >> 2);
    const int lane = ex < lanes ? ex : lanes - 1;
    const uint8_t* s = scalars + (size_t)lane * 32;
#pragma unroll
    for (int j = 0; j < 8; j++)
      sc[i].w[j] = (uint32_t)s[4 * j] | (uint32_t)s[4 * j + 1] << 8 |
                   (uint32_t)s[4 * j + 2] << 16 | (uint32_t)s[4 * j + 3] << 24;
    fe_frombytes(x1[i], us + (size_t)lane * 32);
    v[i] = k == 2 ? x1[i] : k == 1 ? fe_zero() : fe_one();
    swap[i] = 0;
  }
#pragma unroll 1
  for (int pos = 254; pos >= 0; pos--) {
    // 0. the conditional swap: (x2, z2) <-> (x3, z3), by a mask
    q_xor(o, v, 2);
    FOR_LANES(i) {
      const int32_t bit = (word_at(sc[i].w, pos >> 5) >> (pos & 31)) & 1;
      const int32_t mask = -(swap[i] ^ bit);
      swap[i] = bit;
#pragma unroll
      for (int l = 0; l < 10; l++) v[i].v[l] ^= mask & (v[i].v[l] ^ o[i].v[l]);
    }
    // 1. A, B, C, D
    q_xor(o, v, 1);
    FOR_LANES(i) lin(a[i], (thread_of(i) & 1) ? -1 : 1, v[i], 1, o[i]);
    // 2. AA, BB, CB, DA
    q_take_ab(o, a);
    FOR_LANES(i) {
      TALLY_WHEN(block * X25519_PER_BLOCK + (thread_of(i) >> 2) < lanes);
      fe_mul(v[i], a[i], o[i]);
    }
    // 3. x2 = AA BB, z2 = E (AA + a24 E), x3 = (DA + CB)^2, (DA - CB)^2
    q_xor(o, v, 1);
    FOR_LANES(i) {
      const int k = thread_of(i) & 3;
      const bool live = block * X25519_PER_BLOCK + (thread_of(i) >> 2) < lanes;
      fe_sub(e[i], o[i], v[i]);  // thread 1: E = AA - BB
      TALLY_WHEN(live && k == 1);
      fe_mul_small(m[i], e[i], X25519_A24);
      fe f, g;
      // f: AA, E, DA + CB, DA - CB; g: BB, AA + a24 E, DA + CB, DA - CB
      lin(f, k == 1 ? -1 : 1, v[i], k == 0 ? 0 : k == 3 ? -1 : 1, o[i]);
      lin(g, k >= 2 ? 1 : 0, v[i], k == 3 ? -1 : 1, o[i]);
      const int cm = k == 1;
#pragma unroll
      for (int l = 0; l < 10; l++) g.v[l] += cm * m[i].v[l];
      TALLY_WHEN(live);
      fe_mul(v[i], f, g);
    }
    // 4. z3 = x1 (DA - CB)^2 on thread 3
    FOR_LANES(i) {
      const bool use = (thread_of(i) & 3) == 3;
      TALLY_WHEN(use && block * X25519_PER_BLOCK + (thread_of(i) >> 2) < lanes);
      fe r;
      fe_mul(r, v[i], x1[i]);
#pragma unroll
      for (int l = 0; l < 10; l++) v[i].v[l] = use ? r.v[l] : v[i].v[l];
    }
  }
  q_xor(o, v, 2);
  FOR_LANES(i) {
    const int32_t mask = -swap[i];
#pragma unroll
    for (int l = 0; l < 10; l++) v[i].v[l] ^= mask & (v[i].v[l] ^ o[i].v[l]);
  }
  // x2 / z2, the inversion in lockstep; thread k writes bytes 8k..8k+7
  q_from(e, v, 1);  // z2
  q_from(a, v, 0);  // x2
  FOR_LANES(i) {
    const int t = thread_of(i), k = t & 3;
    const int ex = block * X25519_PER_BLOCK + (t >> 2);
    TALLY_WHEN(ex < lanes && k == 0);
    fe_invert(m[i], e[i]);
    fe_mul(m[i], a[i], m[i]);
    fe_freeze(m[i], m[i]);
    const uint64_t w = fe_word_frozen(m[i], k);
    if (ex < lanes) {
      uint8_t* dst = out + (size_t)ex * 32 + 8 * k;
#if defined(__CUDACC__)
      *reinterpret_cast<uint64_t*>(dst) = w;
#else
      for (int b = 0; b < 8; b++) dst[b] = (uint8_t)(w >> (8 * b));
#endif
    }
  }
  TALLY_WHEN(true);
}

}  // namespace

#if defined(__CUDACC__)

__global__ void __launch_bounds__(X25519_THREADS)
x25519_ladder_kernel(const uint8_t* __restrict__ scalars,
                     const uint8_t* __restrict__ us, int lanes,
                     uint8_t* __restrict__ out) {
  ladder_block(scalars, us, lanes, out, blockIdx.x);
}

// One launch over `lanes` lanes on `stream`; `out` must be 8-byte aligned.
// Returns a CUDA error code (0: launched).
extern "C" int x25519_ladder_launch(const void* scalars, const void* us,
                                    int lanes, void* out, void* stream) {
  if (lanes < 1) return (int)cudaErrorInvalidValue;
  x25519_ladder_kernel<<<(lanes + X25519_PER_BLOCK - 1) / X25519_PER_BLOCK,
                         X25519_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)scalars, (const uint8_t*)us, lanes, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// The kernel's launch resources: blocks resident per SM, threads per block,
// and the compiled kernel's registers, local memory bytes per thread and
// static shared memory bytes per block.  Returns a CUDA error code.
extern "C" int x25519_ladder_occupancy(int* blocks_per_sm, int* threads,
                                       int* regs, int* local_bytes,
                                       int* shared_bytes) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, x25519_ladder_kernel);
  if (e != cudaSuccess) return (int)e;
  *threads = X25519_THREADS;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  *shared_bytes = (int)fa.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, x25519_ladder_kernel, X25519_THREADS, 0);
}

#else  // host build: each block's threads in lockstep, the blocks in turn

extern "C" int x25519_ladder_host(const uint8_t* scalars, const uint8_t* us,
                                  int lanes, uint8_t* out) {
  if (lanes < 1) return 1;
  for (int b = 0; b < (lanes + X25519_PER_BLOCK - 1) / X25519_PER_BLOCK; b++)
    ladder_block(scalars, us, lanes, out, b);
  return 0;
}

#if defined(X25519_TALLY)
// Field multiplies, squares and small multiplies since the last call;
// resets.
extern "C" void x25519_tally(long long* muls, long long* squares,
                             long long* smalls) {
  *muls = g_tally_mul;
  *squares = g_tally_sq;
  *smalls = g_tally_small;
  g_tally_mul = g_tally_sq = g_tally_small = 0;
}
#endif

#endif
