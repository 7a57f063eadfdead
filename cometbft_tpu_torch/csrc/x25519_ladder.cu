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
// Design: one thread per lane runs the Montgomery ladder over bits 254..0:
// per bit an arithmetic conditional swap (a mask, never a branch on a
// secret bit) and the RFC's x2/z2/x3/z3 update, 5 multiplies, 4 squares
// and one multiply by a24 = 121665, on csrc/fe25519.cuh's field (10 signed
// limbs in radix 2^25.5, int64 column sums, ref10's carry bounds); then
// z2^(p - 2) by the 2^255 - 21 chain (254 squares, 11 multiplies), x2 times
// it, fe_freeze and 32 bytes out.  A low-order u gives 0, as the RFC's
// ladder does; the caller decides what that means.
//
// What bounds it: 255 x (5 x 100 + 4 x 55 + 10) + 254 x 55 + 12 x 100 =
// 201,320 32x32->64-bit products a lane (counted by the host build below),
// ~3 us of the card's INT32 lanes at 256 lanes.  One thread per lane makes
// the time that of one thread's chain of ~2,800 dependent field operations:
// at 256 lanes only a few SMs have work, so the kernel is latency-bound.
// This first kernel leaves that as it is; splitting a lane's field
// operations over a group of threads is the lever.
//
// Without __CUDACC__ the same source builds for the host and runs the
// lanes in turn; with -DX25519_TALLY it counts the field multiplies,
// squares and small multiplies.

#if defined(X25519_TALLY) && !defined(__CUDACC__)
#define ED25519_TALLY  // fe25519.cuh's counters of multiplies and squares
static long long g_tally_small = 0;
#define TALLY_SMALL() (g_tally_small += 1)
#else
#define TALLY_SMALL() ((void)0)
#endif

#include "fe25519.cuh"

#define X25519_THREADS 64
#define X25519_A24 121665

namespace {

// h = f * k for a small constant k (< 2^17): 10 products, one carry.
DEV void fe_mul_small(fe& h, const fe& f, int32_t k) {
  TALLY_SMALL();
  int64_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = (int64_t)f.v[i] * k;
  fe_carry_wide(h, t);
}

// Swap f and g when b is 1, leave them when b is 0, by a mask.
DEV void fe_cswap(fe& f, fe& g, int32_t b) {
  const int32_t mask = -b;
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int32_t x = mask & (f.v[i] ^ g.v[i]);
    f.v[i] ^= x;
    g.v[i] ^= x;
  }
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

// The 32 little-endian bytes of a frozen (canonical) element.
DEV void fe_tobytes_frozen(uint8_t* s, const fe& h) {
  uint64_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int off = LIMB_OFF(i), sh = off & 63;
    const uint64_t v = (uint64_t)(uint32_t)h.v[i];
    w[off >> 6] |= v << sh;
    if (sh + LIMB_BITS(i) > 64) w[(off >> 6) + 1] |= v >> (64 - sh);
  }
#pragma unroll
  for (int k = 0; k < 32; k++) s[k] = (uint8_t)(w[k >> 3] >> (8 * (k & 7)));
}

// One lane: out = X25519(scalar, u) for a clamped scalar.
DEV void x25519_lane(const uint8_t* scalar, const uint8_t* u, uint8_t* out) {
  fe x1, x2, z2, x3, z3, a, b, aa, bb, e, c, d, da, cb, t;
  fe_frombytes(x1, u);
  x2 = fe_one();
  z2 = fe_zero();
  x3 = x1;
  z3 = fe_one();
  int32_t swap = 0;
#pragma unroll 1
  for (int pos = 254; pos >= 0; pos--) {
    const int32_t bit = (scalar[pos >> 3] >> (pos & 7)) & 1;
    swap ^= bit;
    fe_cswap(x2, x3, swap);
    fe_cswap(z2, z3, swap);
    swap = bit;
    fe_add(a, x2, z2);        // A = x2 + z2
    fe_sub(b, x2, z2);        // B = x2 - z2
    fe_add(c, x3, z3);        // C = x3 + z3
    fe_sub(d, x3, z3);        // D = x3 - z3
    fe_sq(aa, a);             // AA
    fe_sq(bb, b);             // BB
    fe_mul(da, d, a);         // DA
    fe_mul(cb, c, b);         // CB
    fe_sub(e, aa, bb);        // E = AA - BB
    fe_add(t, da, cb);
    fe_sq(x3, t);             // x3 = (DA + CB)^2
    fe_sub(t, da, cb);
    fe_sq(t, t);
    fe_mul(z3, x1, t);        // z3 = x1 (DA - CB)^2
    fe_mul(x2, aa, bb);       // x2 = AA BB
    fe_mul_small(t, e, X25519_A24);
    fe_add(t, aa, t);
    fe_mul(z2, e, t);         // z2 = E (AA + a24 E)
  }
  fe_cswap(x2, x3, swap);
  fe_cswap(z2, z3, swap);
  fe_invert(t, z2);
  fe_mul(t, x2, t);
  fe_freeze(t, t);
  fe_tobytes_frozen(out, t);
}

}  // namespace

#if defined(__CUDACC__)

__global__ void __launch_bounds__(X25519_THREADS)
x25519_ladder_kernel(const uint8_t* __restrict__ scalars,
                     const uint8_t* __restrict__ us, int lanes,
                     uint8_t* __restrict__ out) {
  const int i = blockIdx.x * X25519_THREADS + threadIdx.x;
  if (i >= lanes) return;
  uint8_t s[32], u[32], o[32];
#pragma unroll
  for (int k = 0; k < 32; k++) {
    s[k] = scalars[(size_t)i * 32 + k];
    u[k] = us[(size_t)i * 32 + k];
  }
  x25519_lane(s, u, o);
#pragma unroll
  for (int k = 0; k < 32; k++) out[(size_t)i * 32 + k] = o[k];
}

// One launch over `lanes` lanes on `stream`.  Returns a CUDA error code
// (0: launched).
extern "C" int x25519_ladder_launch(const void* scalars, const void* us,
                                    int lanes, void* out, void* stream) {
  if (lanes < 1) return (int)cudaErrorInvalidValue;
  x25519_ladder_kernel<<<(lanes + X25519_THREADS - 1) / X25519_THREADS,
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

#else  // host build: the lanes one after another

extern "C" int x25519_ladder_host(const uint8_t* scalars, const uint8_t* us,
                                  int lanes, uint8_t* out) {
  if (lanes < 1) return 1;
  for (int i = 0; i < lanes; i++)
    x25519_lane(scalars + (size_t)i * 32, us + (size_t)i * 32,
                out + (size_t)i * 32);
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
