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
// What bounds it: a ChaCha block is 976 32-bit operations (80 quarter
// rounds of 4 additions, 4 XORs and 4 rotates, each one instruction on
// sm_90, the rotate a funnel shift; 16 final additions) and 16 XORs with the
// data; a Poly1305 block 25 products.  At 1,024 lanes of 1,024 bytes that is
// ~1.1 us of the card's INT32 lanes and ~0.65 us of memory traffic
// (PERF.md).  But Poly1305 is a chain: h = (h + c_i) r, one dependent
// multiply and carry per 16 bytes, 65 for a 1 KiB frame, and one thread
// running it leaves its warp's other 31 threads idle for the whole chain.
//
// Design: a CUDA block of AEAD_FRAMES warps takes AEAD_FRAMES frames.
// * Keystream.  The key and nonce of each frame are read once, into shared
//   memory.  The block's counter blocks (block 0 of each frame, the
//   one-time key, and the blocks that hold a byte of it) are dealt to all
//   its threads in turn, whatever frame they belong to; each thread reads
//   its 64 bytes of payload and writes its output as 16-byte vectors, and
//   keeps the MAC's input (the masked ciphertext) in shared memory.  Rows
//   past a frame's last byte are written as zeros, also as vectors.
// * Poly1305 over the warp, by powers of r.  With k MAC blocks (the
//   ciphertext's ceil(n / 16) and the length block), the tag polynomial is
//   h = sum c_i r^(k - i + 1).  Let T be the least power of two >= k, at
//   most 32, and pad the blocks at the front with zero blocks (no 2^128
//   bit) to m T.  Lane t of the frame's warp computes r^(t + 1) by a scan
//   of log2 T shuffled multiplies, takes r^T and r^(T - t) by shuffle, and
//   runs Horner in r^T over the blocks at positions = t (mod T), its last
//   step multiplied by r^(T - t) instead; log2 T shuffled rounds add the T
//   partial sums, and lane 0 carries, reduces mod 2^130 - 5 and adds s.  A
//   1 KiB frame takes 5 + 3 dependent multiplies and 5 rounds of additions,
//   not 65 multiplies.
// * Limb bounds (five 26-bit limbs, 32x32->64-bit products): a power of r
//   and every product's result have limbs below 2^26 + 2^10 (limb 1 takes
//   the folded carry, < 2^9); a Horner operand is such a result plus a
//   block (< 2^26 a limb), below 2^27 + 2^10; 5 times a multiplier limb is
//   below 2^28.33, so a product is below 2^55.34 and a column of five
//   below 2^57.66 < 2^64.  A sum of up to 32 partials has limbs below
//   32 (2^26 + 2^10) < 2^32.  The host build checks each of these bounds
//   at every step and fails the call if one is broken.
// Why CUDA and not Triton: the MAC reads the ciphertext the keystream
// makes and needs warp shuffles; one kernel keeps both on chip.
//
// Without __CUDACC__ the same source builds for the host.  There each
// block's threads run in turn between the barriers, and a warp register
// holds the values of all 32 lanes of a warp: every MAC step is a loop over
// them and a shuffle reads the array, so the warp's schedule, padding and
// shuffles are checked on a machine with no card.  With -DAEAD_TALLY the
// host build counts the 32-bit operations of the ChaCha blocks, the
// Poly1305 products of the lanes whose results are used, and the MAC's
// dependent multiply levels.

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define DEV __device__ __forceinline__
#define MEMBER __device__ __forceinline__
#else
#include <string.h>
#define DEV static inline
#define MEMBER inline
#endif

// Frames per CUDA block, a warp each.  Among 1, 2, 4 and 8, 2 took the
// least device time at 1,024 frames x 16 blocks in each of three runs and
// was within ~1% of the least at a flush's 64 x 16 (PERF.md).
#ifndef AEAD_FRAMES
#define AEAD_FRAMES 2
#endif
#define AEAD_THREADS (32 * AEAD_FRAMES)
#define AEAD_MAX_BLOCKS 32  // the JAX package's bucket ceiling: 2 KiB frames

// AEAD_STAGE stops the kernel early, for the stage profile: 0 at once (the
// launch alone), 1 after loading the frames' keys (a word of each goes to
// its tag, so that the loads stay), 2 after the keystream, 3 (the default)
// runs the whole AEAD.
#ifndef AEAD_STAGE
#define AEAD_STAGE 3
#endif

#if defined(AEAD_TALLY) && !defined(__CUDACC__)
static long long g_ops = 0, g_products = 0, g_levels = 0;
#define TALLY(counter, k) ((counter) += (k))
#else
#define TALLY(counter, k) ((void)0)
#endif

// A broken limb bound fails the host build's call (returns 2); the card
// build checks nothing.
#if defined(__CUDACC__)
#define BOUND(cond) ((void)0)
#else
static int g_bound_broken = 0;
#define BOUND(cond) ((void)((cond) || (g_bound_broken = 1)))
#endif

namespace {

constexpr uint32_t MASK26 = 0x3ffffff;
constexpr uint32_t LIMB_MAX = (1u << 26) + (1u << 10);     // a product's limbs
constexpr uint32_t OPERAND_MAX = (1u << 27) + (1u << 10);  // a Horner operand's

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

// The last counter block that holds a byte of a frame of n bytes (0: none).
DEV int last_block(int n) { return (n + 63) / 64; }

// 16 bytes at p (16-byte aligned): one vector load or store on the card.
DEV void load16(uint32_t w[4], const uint32_t* p) {
#if defined(__CUDACC__)
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
#else
  memcpy(w, p, 16);
#endif
}
DEV void store16(uint32_t* p, const uint32_t w[4]) {
#if defined(__CUDACC__)
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
#else
  memcpy(p, w, 16);
#endif
}

// The block's shared memory: per frame its key and nonce, its length (-1:
// no frame), its one-time key and the MAC's input.
struct Shared {
  alignas(16) uint32_t mac[AEAD_FRAMES][AEAD_MAX_BLOCKS * 16];
  alignas(16) uint32_t key[AEAD_FRAMES][8];
  uint32_t nonce[AEAD_FRAMES][3];
  uint32_t otk[AEAD_FRAMES][8];
  int32_t n[AEAD_FRAMES];
};

struct Args {
  const uint32_t* key;
  const uint32_t* nonce;
  const uint32_t* data;
  const int32_t* nbytes;
  int blocks, lanes, seal;
  uint32_t* out;
  uint32_t* tag;
};

// Thread `tid` of CUDA block `cb`, before the first barrier: the frames'
// keys (two vectors each), nonces and clamped lengths into shared memory.
DEV void load_frames(const Args& a, int cb, int tid, Shared& sh) {
  const int f = tid % AEAD_FRAMES, part = tid / AEAD_FRAMES;
  const int lane = cb * AEAD_FRAMES + f;
  if (part >= 6) return;
  if (lane >= a.lanes) {
    if (part == 5) sh.n[f] = -1;
    return;
  }
  if (part < 2) {
    load16(&sh.key[f][4 * part], a.key + (size_t)lane * 8 + 4 * part);
  } else if (part < 5) {
    sh.nonce[f][part - 2] = a.nonce[(size_t)lane * 3 + part - 2];
  } else {
    // a length outside [0, 64 blocks] is the caller's error (the wrapper's
    // contract); clamped, so that no access leaves the lane's buffers
    const int n = a.nbytes[lane];
    sh.n[f] = n < 0 ? 0 : n > 64 * a.blocks ? 64 * a.blocks : n;
  }
}

// Counter block b (0..last) of frame f: block 0 leaves the one-time key in
// shared memory, block b >= 1 writes its output row and its MAC copy.  The
// payload is loaded before the rounds, which hide the loads' latency.
DEV void frame_block(const Args& a, int cb, int f, int b, Shared& sh) {
  const int lane = cb * AEAD_FRAMES + f, n = sh.n[f];
  const int base = (b - 1) * 64;
  const size_t row = ((size_t)(b > 0 ? b - 1 : 0) * a.lanes + lane) * 16;
  uint32_t k[8], nc[3], ks[16], d[16];
  if (b > 0) {
#pragma unroll
    for (int v = 0; v < 4; v++) load16(d + 4 * v, a.data + row + 4 * v);
  }
#pragma unroll
  for (int i = 0; i < 8; i++) k[i] = sh.key[f][i];
#pragma unroll
  for (int i = 0; i < 3; i++) nc[i] = sh.nonce[f][i];
  chacha_block(k, (uint32_t)b, nc, ks);
  if (b == 0) {
#pragma unroll
    for (int i = 0; i < 8; i++) sh.otk[f][i] = ks[i];
    return;
  }
#pragma unroll
  for (int v = 0; v < 4; v++) {
    uint32_t x[4], m[4];
#pragma unroll
    for (int j = 0; j < 4; j++) {
      const uint32_t live = live_mask(base + 16 * v + 4 * j, n);
      const uint32_t dw = d[4 * v + j] & live;
      x[j] = (dw ^ ks[4 * v + j]) & live;
      m[j] = a.seal ? x[j] : dw;
    }
    store16(a.out + row + 4 * v, x);
    store16(&sh.mac[f][(b - 1) * 16 + 4 * v], m);
  }
  TALLY(g_ops, 16);
}

// Thread `tid` between the barriers: its share of the block's counter
// blocks, dealt over the frames in order, then of the zero rows past each
// frame's last block (a 16-byte vector each).
DEV void keystream(const Args& a, int cb, int tid, Shared& sh) {
  int items[AEAD_FRAMES], dead[AEAD_FRAMES], total = 0, total_dead = 0;
#pragma unroll
  for (int f = 0; f < AEAD_FRAMES; f++) {
    const int n = sh.n[f];
    items[f] = n < 0 ? 0 : last_block(n) + 1;
    dead[f] = n < 0 ? 0 : 4 * (a.blocks - last_block(n));
    total += items[f];
    total_dead += dead[f];
  }
  for (int j = tid; j < total; j += AEAD_THREADS) {
    int f = 0, start = 0, acc = items[0];
#pragma unroll
    for (int g = 1; g < AEAD_FRAMES; g++) {
      if (j >= acc) { f = g; start = acc; }
      acc += items[g];
    }
    frame_block(a, cb, f, j - start, sh);
  }
  const uint32_t zero[4] = {0, 0, 0, 0};
  for (int j = tid; j < total_dead; j += AEAD_THREADS) {
    int f = 0, start = 0, acc = dead[0];
#pragma unroll
    for (int g = 1; g < AEAD_FRAMES; g++) {
      if (j >= acc) { f = g; start = acc; }
      acc += dead[g];
    }
    const int q = j - start, b = last_block(sh.n[f]) + 1 + q / 4;
    const int lane = cb * AEAD_FRAMES + f;
    store16(a.out + ((size_t)(b - 1) * a.lanes + lane) * 16 + 4 * (q % 4), zero);
  }
}

// --- Poly1305 over a warp ---------------------------------------------------

struct P5 {
  uint32_t v[5];  // 26-bit limbs, least significant first
};

// 4 little-endian words as 26-bit limbs, plus hibit at bit 128.
DEV P5 limbs26(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
               uint32_t hibit) {
  P5 x = {{w0 & MASK26, ((w0 >> 26) | (w1 << 6)) & MASK26,
           ((w1 >> 20) | (w2 << 12)) & MASK26, ((w2 >> 14) | (w3 << 18)) & MASK26,
           (w3 >> 8) | (hibit << 24)}};
  return x;
}

// h = a b mod 2^130 - 5, partly reduced (limbs < 2^26, limb 1 < 2^26 +
// 2^9): 25 32x32->64-bit products; s5 = 5 b folds 2^130 = 5.
DEV void pmul(P5& h, const P5& a, const P5& b) {
  uint32_t s5[5];
#pragma unroll
  for (int i = 0; i < 5; i++) {
    BOUND(a.v[i] < OPERAND_MAX && b.v[i] < LIMB_MAX);
    s5[i] = 5 * b.v[i];
  }
  const uint32_t *x = a.v, *r = b.v;
#define W(p, q) ((uint64_t)(p) * (q))  // one 32x32->64-bit product
  uint64_t d0 = W(x[0], r[0]) + W(x[1], s5[4]) + W(x[2], s5[3]) + W(x[3], s5[2]) + W(x[4], s5[1]);
  uint64_t d1 = W(x[0], r[1]) + W(x[1], r[0]) + W(x[2], s5[4]) + W(x[3], s5[3]) + W(x[4], s5[2]);
  uint64_t d2 = W(x[0], r[2]) + W(x[1], r[1]) + W(x[2], r[0]) + W(x[3], s5[4]) + W(x[4], s5[3]);
  uint64_t d3 = W(x[0], r[3]) + W(x[1], r[2]) + W(x[2], r[1]) + W(x[3], r[0]) + W(x[4], s5[4]);
  uint64_t d4 = W(x[0], r[4]) + W(x[1], r[3]) + W(x[2], r[2]) + W(x[3], r[1]) + W(x[4], r[0]);
#undef W
  TALLY(g_products, 25);
  uint64_t c = d0 >> 26; h.v[0] = (uint32_t)d0 & MASK26;
  d1 += c; c = d1 >> 26; h.v[1] = (uint32_t)d1 & MASK26;
  d2 += c; c = d2 >> 26; h.v[2] = (uint32_t)d2 & MASK26;
  d3 += c; c = d3 >> 26; h.v[3] = (uint32_t)d3 & MASK26;
  d4 += c; c = d4 >> 26; h.v[4] = (uint32_t)d4 & MASK26;
  const uint64_t t = h.v[0] + c * 5;
  h.v[0] = (uint32_t)t & MASK26;
  h.v[1] += (uint32_t)(t >> 26);
  BOUND(h.v[1] < LIMB_MAX);
}

// A warp register: on the card this lane's value, on the host every
// lane's, so that each step is a loop over the warp and a shuffle reads
// the array.
#if defined(__CUDACC__)
#define WARP_LANES 1
template <class T>
struct WR {
  T v;
  MEMBER T& operator[](int) { return v; }
  MEMBER const T& operator[](int) const { return v; }
};
DEV int lane_of(int) { return threadIdx.x & 31; }
#else
#define WARP_LANES 32
template <class T>
struct WR {
  T v[32];
  MEMBER T& operator[](int i) { return v[i]; }
  MEMBER const T& operator[](int i) const { return v[i]; }
};
DEV int lane_of(int i) { return i; }
#endif
#define FOR_LANES(i) for (int i = 0; i < WARP_LANES; i++)

// The source lane of a shuffle, for lane t: t - d (t itself below d), t ^
// d, d - t, or d.
enum { FROM_BELOW, FROM_XOR, FROM_MIRROR, FROM_LANE };
DEV int source(int kind, int d, int t) {
  return kind == FROM_BELOW ? (t >= d ? t - d : t)
       : kind == FROM_XOR   ? (t ^ d)
       : kind == FROM_MIRROR ? ((d - t) & 31)
       : d;
}

// out = in as held by lane source(kind, d, t).  `out` and `in` must be
// different registers.
DEV void take(WR<P5>& out, const WR<P5>& in, int kind, int d) {
#if defined(__CUDACC__)
  const int src = source(kind, d, threadIdx.x & 31);
#pragma unroll
  for (int l = 0; l < 5; l++) out.v.v[l] = __shfl_sync(0xffffffffu, in.v.v[l], src);
#else
  for (int t = 0; t < 32; t++) out[t] = in[source(kind, d, t)];
#endif
}

// h with limbs below 2^32 carried to limbs below 2^26 (h < 2^130, the
// same mod 2^130 - 5), by two passes.  After the first every limb but 0 is
// below 2^26 and limb 0 below 2^26 + 5 * 2^6.  In the second a carry out
// of limb 4 needs one out of limb 0, which leaves limb 0 below 5 * 2^6, so
// adding 5 keeps it below 2^26.
DEV void carry(uint32_t h[5], const P5& acc) {
  uint32_t c;
#pragma unroll
  for (int i = 0; i < 5; i++) h[i] = acc.v[i];
#pragma unroll
  for (int pass = 0; pass < 2; pass++) {
#pragma unroll
    for (int i = 0; i < 4; i++) {
      c = h[i] >> 26; h[i] &= MASK26; h[i + 1] += c;
    }
    c = h[4] >> 26; h[4] &= MASK26; h[0] += c * 5;
  }
  BOUND(h[0] < (1u << 26));
}

// (h mod 2^130 - 5 + s) mod 2^128 as 4 words, for limbs below 2^32.
DEV void finish(const P5& acc, const uint32_t s[4], uint32_t tag[4]) {
  uint32_t h[5], c;
  carry(h, acc);
  // h mod p by the g = h + 5 - 2^130 select
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
  uint64_t f = (uint64_t)a0 + s[0];
  tag[0] = (uint32_t)f;
  f = (uint64_t)a1 + s[1] + (f >> 32);
  tag[1] = (uint32_t)f;
  f = (uint64_t)a2 + s[2] + (f >> 32);
  tag[2] = (uint32_t)f;
  f = (uint64_t)a3 + s[3] + (f >> 32);
  tag[3] = (uint32_t)f;
}

// The warp of a frame of n bytes: Poly1305 of the zero-padded ciphertext
// words `ct` (ceil(n / 16) blocks) and the length block le64(0) ||
// le64(n), keyed by otk.  Lane 0 ends with the tag; `pre`, if given, gets
// its h reduced below 2^130 (before the mod-p select) for the host's
// tests.
DEV void warp_mac(const uint32_t* otk, const uint32_t* ct, int n,
                  uint32_t tag[4], uint32_t* pre) {
  const uint32_t r0 = otk[0] & 0x0fffffff, r1 = otk[1] & 0x0ffffffc,
                 r2 = otk[2] & 0x0ffffffc, r3 = otk[3] & 0x0ffffffc;
  const P5 r = limbs26(r0, r1, r2, r3, 0);
  const int nmac = (n + 15) / 16, k = nmac + 1;
  int T = 1, logT = 0;
  while (T < k && T < 32) {
    T <<= 1;
    logT++;
  }
  const int m = (k + T - 1) / T, pad = m * T - k;
  TALLY(g_levels, logT + m);

  // lane t: r^(t + 1), by a scan of log2 T multiplies
  WR<P5> p, q;
  FOR_LANES(i) p[i] = r;
  for (int d = 1; d < T; d <<= 1) {
    take(q, p, FROM_BELOW, d);
    FOR_LANES(i) {
      const int t = lane_of(i);
      if (t >= d && t < T) pmul(p[i], p[i], q[i]);
    }
  }
  WR<P5> rT, rTt;
  take(rT, p, FROM_LANE, T - 1);     // r^T
  take(rTt, p, FROM_MIRROR, T - 1);  // r^(T - t)

  // lane t: Horner in r^T over the blocks at positions = t (mod T) of the
  // padded list, the last step times r^(T - t)
  WR<P5> acc;
  FOR_LANES(i) acc[i] = P5{{0, 0, 0, 0, 0}};
  for (int s = 0; s < m; s++) {
    FOR_LANES(i) {
      const int t = lane_of(i), blk = s * T + t - pad;
      if (t >= T) continue;
      P5 c = {{0, 0, 0, 0, 0}};
      if (blk >= 0) {
        uint32_t w[4] = {0, 0, (uint32_t)n, 0};  // the length block
        if (blk < nmac) load16(w, ct + 4 * blk);
        c = limbs26(w[0], w[1], w[2], w[3], 1);
      }
      // the multiplier chosen limb by limb (a select of references would
      // put both registers in local memory)
      P5 x, y;
#pragma unroll
      for (int l = 0; l < 5; l++) {
        x.v[l] = acc[i].v[l] + c.v[l];
        y.v[l] = s == m - 1 ? rTt[i].v[l] : rT[i].v[l];
      }
      pmul(acc[i], x, y);
    }
  }
  FOR_LANES(i) if (lane_of(i) >= T) acc[i] = P5{{0, 0, 0, 0, 0}};

  // the T partial sums, by log2 T shuffled rounds
  for (int d = T >> 1; d >= 1; d >>= 1) {
    take(q, acc, FROM_XOR, d);
    FOR_LANES(i) {
#pragma unroll
      for (int l = 0; l < 5; l++) {
        BOUND((uint64_t)acc[i].v[l] + q[i].v[l] < (1ull << 32));
        acc[i].v[l] += q[i].v[l];
      }
    }
  }
  FOR_LANES(i) {
    if (lane_of(i) != 0) continue;
    finish(acc[i], otk + 4, tag);
    if (pre) carry(pre, acc[i]);
  }
}

}  // namespace

#if defined(__CUDACC__)

__global__ void __launch_bounds__(AEAD_THREADS)
chacha20_poly1305_kernel(Args a) {
  __shared__ Shared sh;
  const int cb = blockIdx.x, tid = threadIdx.x, f = tid >> 5;
  if (AEAD_STAGE == 0) return;
  load_frames(a, cb, tid, sh);
  __syncthreads();
  const int lane = cb * AEAD_FRAMES + f;
#if AEAD_STAGE < 2
  if ((tid & 31) == 0 && lane < a.lanes) a.tag[(size_t)lane * 4] = sh.key[f][0] ^ sh.n[f];
  return;
#endif
  keystream(a, cb, tid, sh);
  __syncthreads();
  if (AEAD_STAGE < 3 || lane >= a.lanes) return;  // a whole warp: no shuffle names it
  uint32_t t[4];
  warp_mac(sh.otk[f], sh.mac[f], sh.n[f], t, nullptr);
  if ((tid & 31) == 0) store16(a.tag + (size_t)lane * 4, t);
}

// One launch over `lanes` lanes of `blocks` counter blocks (1..32) on
// `stream`; seal != 0 MACs the output, else the input.  Every pointer must
// be 16-byte aligned.  Returns a CUDA error code (0: launched).
extern "C" int chacha20_poly1305_launch(const void* key, const void* nonce,
                                        const void* data, const void* nbytes,
                                        int blocks, int lanes, int seal,
                                        void* out, void* tag, void* stream) {
  if (lanes < 1 || blocks < 1 || blocks > AEAD_MAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  const Args a = {(const uint32_t*)key, (const uint32_t*)nonce,
                  (const uint32_t*)data, (const int32_t*)nbytes,
                  blocks, lanes, seal, (uint32_t*)out, (uint32_t*)tag};
  chacha20_poly1305_kernel<<<(lanes + AEAD_FRAMES - 1) / AEAD_FRAMES,
                             AEAD_THREADS, 0, (cudaStream_t)stream>>>(a);
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

#else  // host build: each block's threads in turn between the barriers

// Returns 0, 1 for arguments the kernel does not take, 2 if a limb bound
// was broken.
extern "C" int chacha20_poly1305_host(const uint32_t* key, const uint32_t* nonce,
                                      const uint32_t* data,
                                      const int32_t* nbytes, int blocks,
                                      int lanes, int seal, uint32_t* out,
                                      uint32_t* tag) {
  if (lanes < 1 || blocks < 1 || blocks > AEAD_MAX_BLOCKS) return 1;
  for (int lane = 0; lane < lanes; lane++)
    if (nbytes[lane] < 0 || nbytes[lane] > 64 * blocks) return 1;
  const Args a = {key, nonce, data, nbytes, blocks, lanes, seal, out, tag};
  static Shared sh;
  g_bound_broken = 0;
  for (int cb = 0; cb < (lanes + AEAD_FRAMES - 1) / AEAD_FRAMES; cb++) {
    memset(&sh, 0xa5, sizeof sh);  // what the kernel does not write is not read
    for (int tid = 0; tid < AEAD_THREADS; tid++) load_frames(a, cb, tid, sh);
    for (int tid = 0; tid < AEAD_THREADS; tid++) keystream(a, cb, tid, sh);
    for (int f = 0; f < AEAD_FRAMES; f++) {
      const int lane = cb * AEAD_FRAMES + f;
      if (lane < lanes) warp_mac(sh.otk[f], sh.mac[f], sh.n[f], tag + (size_t)lane * 4, nullptr);
    }
  }
  return g_bound_broken ? 2 : 0;
}

// The warp's Poly1305 alone, for a one-time key `otk` (r, s) and the
// zero-padded words of a message of n bytes (n <= 2,048): the tag, and in
// `pre` h below 2^130 before the mod-p select.  Returns 2 if a limb bound
// was broken, else 0.
extern "C" int poly1305_warp_host(const uint32_t* otk, const uint32_t* words,
                                  int n, uint32_t* tag, uint32_t* pre) {
  if (n < 0 || n > 64 * AEAD_MAX_BLOCKS) return 1;
  g_bound_broken = 0;
  warp_mac(otk, words, n, tag, pre);
  return g_bound_broken ? 2 : 0;
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

// Dependent multiply levels of the MACs since the last call (per frame:
// the scan's log2 T and Horner's m); resets.
extern "C" long long chacha20_poly1305_levels() {
  const long long v = g_levels;
  g_levels = 0;
  return v;
}
#endif

#endif
