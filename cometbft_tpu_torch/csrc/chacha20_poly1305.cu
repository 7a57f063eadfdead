// RFC 8439 ChaCha20-Poly1305 with empty AAD, many frames per launch, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the XLA program _aead_fn of cometbft_tpu/ops/chacha_aead.py:289
// (jitted as _seal_fn / _open_fn, :401 / :405; its block function
// _chacha_blocks :180 and its 13-bit-limb Poly1305, _poly_mulmod :234 and
// _poly_ripple :271).  It computes the same function on the same layout:
//
//   in:  key (lanes, 8) and nonce (lanes, 3) little-endian words, data
//        (blocks, lanes, 16) words zero-padded past each lane's length,
//        nbytes (lanes,) the lengths (<= blocks * 64);
//   out: out (blocks, lanes, 16), the payload XOR the keystream of counter
//        blocks 1.., masked to the lane's length, and tag (lanes, 4), the
//        Poly1305 tag of the ciphertext (seal: the output; open: the input)
//        with the one-time key of counter block 0.
//
// Design: one CUDA block of 32 threads (one warp) per lane.  Thread t makes
// the lane's ChaCha blocks t, t + 32, ... up to the last block that holds a
// byte of the frame: block 0 is the Poly1305 one-time key (r, s), the others
// keystream, written masked to `out` and, as the MAC's input, into a copy of
// the lane's ciphertext in shared memory (at most 32 x 64 bytes).  After a
// barrier one thread runs Poly1305 over the lane's ceil(n / 16) MAC blocks
// and the length block, in five 26-bit limbs (25 32x32->64-bit products a
// block), then adds s mod 2^128.  Counter blocks past the frame's last byte
// are not computed: their output words are 0.
//
// What bounds it: a ChaCha block is 976 32-bit operations (80 quarter
// rounds of 4 additions, 4 XORs and 4 rotates, each one instruction on
// sm_90, the rotate a funnel shift; 16 final additions) and 16 XORs with the
// data; a Poly1305 block 25 products.  At 1,024 lanes of 1,024 bytes that is
// ~1.1 us of the card's INT32 lanes and ~0.65 us of memory traffic
// (PERF.md), while the MAC is one dependent chain per lane: ~65 blocks of
// multiply and carry, one thread each.  This first kernel leaves the chain
// as it is; splitting it over the warp by powers of r is the lever.  Why
// CUDA and not Triton: the keystream alone is an elementwise pass, but the
// MAC reads the ciphertext it produces, and one kernel keeps that on chip.
//
// Without __CUDACC__ the same source builds for the host and runs each
// lane's threads in turn, then the MAC thread; with -DAEAD_TALLY the host
// build counts the 32-bit operations of the ChaCha blocks and the
// Poly1305 products, for the bound.

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#else
#define DEV static inline
#endif

#define AEAD_THREADS 32     // one warp per lane
#define AEAD_MAX_BLOCKS 32  // the JAX package's bucket ceiling: 2 KiB frames

#if defined(AEAD_TALLY) && !defined(__CUDACC__)
static long long g_ops = 0, g_products = 0;
#define TALLY(counter, k) ((counter) += (k))
#else
#define TALLY(counter, k) ((void)0)
#endif

namespace {

constexpr uint32_t MASK26 = 0x3ffffff;

DEV uint32_t rotl(uint32_t x, int n) {
#if defined(__CUDA_ARCH__)
  return __funnelshift_l(x, x, n);
#else
  return (x << n) | (x >> (32 - n));
#endif
}

#define QR(a, b, c, d)                       \
  w[a] += w[b]; w[d] = rotl(w[d] ^ w[a], 16); \
  w[c] += w[d]; w[b] = rotl(w[b] ^ w[c], 12); \
  w[a] += w[b]; w[d] = rotl(w[d] ^ w[a], 8);  \
  w[c] += w[d]; w[b] = rotl(w[b] ^ w[c], 7);

// The ChaCha20 block function (RFC 8439 2.3) of key, counter and nonce.
DEV void chacha_block(const uint32_t key[8], uint32_t counter,
                      const uint32_t nonce[3], uint32_t out[16]) {
  uint32_t st[16] = {0x61707865, 0x3320646e, 0x79622d32, 0x6b206574,
                     key[0], key[1], key[2], key[3],
                     key[4], key[5], key[6], key[7],
                     counter, nonce[0], nonce[1], nonce[2]};
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; i++) w[i] = st[i];
#pragma unroll 1
  for (int r = 0; r < 10; r++) {
    QR(0, 4, 8, 12) QR(1, 5, 9, 13) QR(2, 6, 10, 14) QR(3, 7, 11, 15)
    QR(0, 5, 10, 15) QR(1, 6, 11, 12) QR(2, 7, 8, 13) QR(3, 4, 9, 14)
  }
#pragma unroll
  for (int i = 0; i < 16; i++) out[i] = w[i] + st[i];
  TALLY(g_ops, 80 * 12 + 16);
}

// Bytes of a word at byte offset `off` of a frame of n bytes, as a mask of
// the word's little-endian bytes that lie inside the frame.
DEV uint32_t live_mask(int off, int n) {
  const int k = n - off;
  return k >= 4 ? 0xffffffffu : k <= 0 ? 0u : (1u << (8 * k)) - 1u;
}

// Thread work: counter block b (0..blocks) of lane `lane`.  Block 0 leaves
// the one-time key in otk; block b >= 1 writes its 16 output words and
// their MAC copy, or zeros when no byte of the frame lies in it.
DEV void lane_block(int lane, int b, const uint32_t* key, const uint32_t* nonce,
                    const uint32_t* data, int n, int lanes, int seal,
                    uint32_t* out, uint32_t* mac, uint32_t* otk) {
  uint32_t k[8], nc[3], ks[16];
#pragma unroll
  for (int i = 0; i < 8; i++) k[i] = key[(size_t)lane * 8 + i];
#pragma unroll
  for (int i = 0; i < 3; i++) nc[i] = nonce[(size_t)lane * 3 + i];
  if (b == 0) {
    chacha_block(k, 0, nc, ks);
#pragma unroll
    for (int i = 0; i < 8; i++) otk[i] = ks[i];
    return;
  }
  const int base = (b - 1) * 64;
  uint32_t* o = out + ((size_t)(b - 1) * lanes + lane) * 16;
  if (base >= n) {
#pragma unroll
    for (int j = 0; j < 16; j++) o[j] = 0;
    return;
  }
  const uint32_t* d = data + ((size_t)(b - 1) * lanes + lane) * 16;
  chacha_block(k, (uint32_t)b, nc, ks);
#pragma unroll
  for (int j = 0; j < 16; j++) {
    const uint32_t m = live_mask(base + 4 * j, n);
    const uint32_t dw = d[j] & m;
    const uint32_t x = (dw ^ ks[j]) & m;
    o[j] = x;
    mac[(b - 1) * 16 + j] = seal ? x : dw;
  }
  TALLY(g_ops, 16);
}

// One Poly1305 block (RFC 8439 2.5): h = (h + m + hibit 2^128) * r mod
// 2^130 - 5, in five 26-bit limbs; s5[i] = 5 r[i] folds 2^130 = 5.  The
// limbs of h stay below 2^27, so every product fits 58 bits.
DEV void poly_block(uint32_t h[5], const uint32_t r[5], const uint32_t s5[5],
                    uint32_t m0, uint32_t m1, uint32_t m2, uint32_t m3) {
  const uint32_t h0 = h[0] + (m0 & MASK26);
  const uint32_t h1 = h[1] + (((m0 >> 26) | (m1 << 6)) & MASK26);
  const uint32_t h2 = h[2] + (((m1 >> 20) | (m2 << 12)) & MASK26);
  const uint32_t h3 = h[3] + (((m2 >> 14) | (m3 << 18)) & MASK26);
  const uint32_t h4 = h[4] + ((m3 >> 8) | (1u << 24));
#define W(a, b) ((uint64_t)(a) * (b))  // one 32x32->64-bit product
  uint64_t d0 = W(h0, r[0]) + W(h1, s5[4]) + W(h2, s5[3]) + W(h3, s5[2]) + W(h4, s5[1]);
  uint64_t d1 = W(h0, r[1]) + W(h1, r[0]) + W(h2, s5[4]) + W(h3, s5[3]) + W(h4, s5[2]);
  uint64_t d2 = W(h0, r[2]) + W(h1, r[1]) + W(h2, r[0]) + W(h3, s5[4]) + W(h4, s5[3]);
  uint64_t d3 = W(h0, r[3]) + W(h1, r[2]) + W(h2, r[1]) + W(h3, r[0]) + W(h4, s5[4]);
  uint64_t d4 = W(h0, r[4]) + W(h1, r[3]) + W(h2, r[2]) + W(h3, r[1]) + W(h4, r[0]);
#undef W
  TALLY(g_products, 25);
  uint64_t c = d0 >> 26; h[0] = (uint32_t)d0 & MASK26;
  d1 += c; c = d1 >> 26; h[1] = (uint32_t)d1 & MASK26;
  d2 += c; c = d2 >> 26; h[2] = (uint32_t)d2 & MASK26;
  d3 += c; c = d3 >> 26; h[3] = (uint32_t)d3 & MASK26;
  d4 += c; c = d4 >> 26; h[4] = (uint32_t)d4 & MASK26;
  uint64_t t = h[0] + c * 5;
  h[0] = (uint32_t)t & MASK26;
  h[1] += (uint32_t)(t >> 26);
}

// The MAC thread's work: Poly1305 over the lane's ceil(n / 16) MAC blocks
// (the zero-padded ciphertext words in mac) and the length block
// le64(0) || le64(n), keyed by otk; the tag (h mod p + s) mod 2^128.
DEV void lane_mac(const uint32_t* otk, const uint32_t* mac, int n,
                  uint32_t tag[4]) {
  const uint32_t w0 = otk[0] & 0x0fffffff, w1 = otk[1] & 0x0ffffffc,
                 w2 = otk[2] & 0x0ffffffc, w3 = otk[3] & 0x0ffffffc;
  const uint32_t r[5] = {w0 & MASK26, ((w0 >> 26) | (w1 << 6)) & MASK26,
                         ((w1 >> 20) | (w2 << 12)) & MASK26,
                         ((w2 >> 14) | (w3 << 18)) & MASK26, w3 >> 8};
  const uint32_t s5[5] = {r[0] * 5, r[1] * 5, r[2] * 5, r[3] * 5, r[4] * 5};
  uint32_t h[5] = {0, 0, 0, 0, 0};
  const int nmac = (n + 15) / 16;
#pragma unroll 1
  for (int i = 0; i < nmac; i++)
    poly_block(h, r, s5, mac[4 * i], mac[4 * i + 1], mac[4 * i + 2],
               mac[4 * i + 3]);
  poly_block(h, r, s5, 0, 0, (uint32_t)n, 0);
  // carry fully, then h mod p by the g = h + 5 - 2^130 select
  uint32_t c;
  c = h[1] >> 26; h[1] &= MASK26; h[2] += c;
  c = h[2] >> 26; h[2] &= MASK26; h[3] += c;
  c = h[3] >> 26; h[3] &= MASK26; h[4] += c;
  c = h[4] >> 26; h[4] &= MASK26; h[0] += c * 5;
  c = h[0] >> 26; h[0] &= MASK26; h[1] += c;
  uint32_t g[5];
  g[0] = h[0] + 5; c = g[0] >> 26; g[0] &= MASK26;
  g[1] = h[1] + c; c = g[1] >> 26; g[1] &= MASK26;
  g[2] = h[2] + c; c = g[2] >> 26; g[2] &= MASK26;
  g[3] = h[3] + c; c = g[3] >> 26; g[3] &= MASK26;
  g[4] = h[4] + c - (1u << 26);
  const uint32_t keep_g = (g[4] >> 31) - 1u;  // all ones when h >= p
#pragma unroll
  for (int i = 0; i < 5; i++) h[i] = (h[i] & ~keep_g) | (g[i] & keep_g);
  const uint32_t a0 = h[0] | (h[1] << 26), a1 = (h[1] >> 6) | (h[2] << 20),
                 a2 = (h[2] >> 12) | (h[3] << 14), a3 = (h[3] >> 18) | (h[4] << 8);
  uint64_t f = (uint64_t)a0 + otk[4];
  tag[0] = (uint32_t)f;
  f = (uint64_t)a1 + otk[5] + (f >> 32);
  tag[1] = (uint32_t)f;
  f = (uint64_t)a2 + otk[6] + (f >> 32);
  tag[2] = (uint32_t)f;
  f = (uint64_t)a3 + otk[7] + (f >> 32);
  tag[3] = (uint32_t)f;
}

// The last counter block that holds a byte of a frame of n bytes (0: none).
DEV int last_block(int n) { return (n + 63) / 64; }

}  // namespace

#if defined(__CUDACC__)

__global__ void __launch_bounds__(AEAD_THREADS)
chacha20_poly1305_kernel(const uint32_t* __restrict__ key,
                         const uint32_t* __restrict__ nonce,
                         const uint32_t* __restrict__ data,
                         const int32_t* __restrict__ nbytes, int blocks,
                         int lanes, int seal, uint32_t* __restrict__ out,
                         uint32_t* __restrict__ tag) {
  __shared__ uint32_t mac[AEAD_MAX_BLOCKS * 16];
  __shared__ uint32_t otk[8];
  const int lane = blockIdx.x;
  // a length outside [0, 64 blocks] is the caller's error (the wrapper's
  // contract); clamped, so that no access leaves the lane's buffers
  const int n = min(max(nbytes[lane], 0), 64 * blocks);
  const int last = last_block(n);
  for (int b = threadIdx.x; b <= blocks; b += AEAD_THREADS) {
    if (b <= last) {
      lane_block(lane, b, key, nonce, data, n, lanes, seal, out, mac, otk);
    } else {
      uint32_t* o = out + ((size_t)(b - 1) * lanes + lane) * 16;
#pragma unroll
      for (int j = 0; j < 16; j++) o[j] = 0;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t[4];
    lane_mac(otk, mac, n, t);
#pragma unroll
    for (int i = 0; i < 4; i++) tag[(size_t)lane * 4 + i] = t[i];
  }
}

// One launch over `lanes` lanes of `blocks` counter blocks (1..32) on
// `stream`; seal != 0 MACs the output, else the input.  Returns a CUDA
// error code (0: launched).
extern "C" int chacha20_poly1305_launch(const void* key, const void* nonce,
                                        const void* data, const void* nbytes,
                                        int blocks, int lanes, int seal,
                                        void* out, void* tag, void* stream) {
  if (lanes < 1 || blocks < 1 || blocks > AEAD_MAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  chacha20_poly1305_kernel<<<lanes, AEAD_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)key, (const uint32_t*)nonce, (const uint32_t*)data,
      (const int32_t*)nbytes, blocks, lanes, seal, (uint32_t*)out,
      (uint32_t*)tag);
  return (int)cudaGetLastError();
}

// The kernel's launch resources: blocks resident per SM, threads per block,
// and the compiled kernel's registers, local memory bytes per thread and
// static shared memory bytes per block.  Returns a CUDA error code.
extern "C" int chacha20_poly1305_occupancy(int* blocks_per_sm, int* threads,
                                           int* regs, int* local_bytes,
                                           int* shared_bytes) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, chacha20_poly1305_kernel);
  if (e != cudaSuccess) return (int)e;
  *threads = AEAD_THREADS;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  *shared_bytes = (int)fa.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, chacha20_poly1305_kernel, AEAD_THREADS, 0);
}

#else  // host build: each lane's threads in turn, then its MAC thread

extern "C" int chacha20_poly1305_host(const uint32_t* key, const uint32_t* nonce,
                                      const uint32_t* data,
                                      const int32_t* nbytes, int blocks,
                                      int lanes, int seal, uint32_t* out,
                                      uint32_t* tag) {
  if (lanes < 1 || blocks < 1 || blocks > AEAD_MAX_BLOCKS) return 1;
  for (int lane = 0; lane < lanes; lane++) {
    uint32_t mac[AEAD_MAX_BLOCKS * 16], otk[8];
    const int n = nbytes[lane];
    if (n < 0 || n > 64 * blocks) return 1;
    for (int b = 0; b <= blocks; b++) {
      if (b <= last_block(n)) {
        lane_block(lane, b, key, nonce, data, n, lanes, seal, out, mac, otk);
      } else {
        for (int j = 0; j < 16; j++) out[((size_t)(b - 1) * lanes + lane) * 16 + j] = 0;
      }
    }
    lane_mac(otk, mac, n, tag + (size_t)lane * 4);
  }
  return 0;
}

#if defined(AEAD_TALLY)
// 32-bit operations of the ChaCha blocks and Poly1305 products since the
// last call; resets.
extern "C" void chacha20_poly1305_tally(long long* ops, long long* products) {
  *ops = g_ops;
  *products = g_products;
  g_ops = 0;
  g_products = 0;
}
#endif

#endif
