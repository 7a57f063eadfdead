// RFC 6962 SHA-256 Merkle tree levels for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA programs of cometbft_tpu/ops/sha256_tree.py: _leaf_fn
// (:227) and _layer_fn (:252) over _compress (:204).  Two kernels:
//
//   * sha256_leaf_kernel: one thread per leaf, SHA-256(0x00 || leaf) over
//     the leaf's raw bytes (one byte buffer and per-leaf offsets); the
//     thread pads the message itself, so the host packs nothing;
//   * sha256_layer_kernel: one thread per parent, SHA-256(0x01 || L || R)
//     of two adjacent digests of the level below; an odd tail is promoted
//     unchanged.
//
// Digests are 8 uint32 words, big-endian values as SHA-256 defines them
// (the JAX kernel's (B, 8) uint32 rows).  A tree is one leaf launch and one
// layer launch per level, all queued on one stream by the wrapper
// (ops/cuda_sha256.py); the tree plane copies the root back.
//
// What bounds it: a compression is 1,384 instructions of sm_90's integer
// ISA (48 schedule words of 10, 64 rounds of 14, 8 final additions; a
// rotate or a shift is one SHF, any three-input logic function one LOP3,
// three addends one IADD3; counted by the host build below), so a
// 1,000-leaf tree (~3,000 compressions) is ~0.25 us of the card's INT32
// lanes and a few hundred kilobytes of memory traffic.
// At that width the tree is bound by launch latency: 11 dependent
// launches.  The design keeps each lane's 64 rounds in registers (the
// message schedule as a rolling window of 16 words, rotates as
// __funnelshift_r, K in constant memory) and does nothing about the
// launches yet.
//
// Without __CUDACC__ the same source builds for the host (one leaf after
// another); with -DSHA256_TALLY the host build counts every instruction
// of the compressions (one per helper below), for the bound's tally.

#include <stdint.h>

#if defined(__CUDACC__)
#define DEV __device__ __forceinline__
#define CONST_MEM __constant__
#else
#define DEV static inline
#define CONST_MEM static const
#endif

#define THREADS 128  // threads per block

namespace {

CONST_MEM uint32_t K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu,
    0x59F111F1u, 0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u,
    0x243185BEu, 0x550C7DC3u, 0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u,
    0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u, 0x0FC19DC6u, 0x240CA1CCu,
    0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu, 0x983E5152u,
    0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu,
    0x53380D13u, 0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u,
    0xA2BFE8A1u, 0xA81A664Bu, 0xC24B8B70u, 0xC76C51A3u, 0xD192E819u,
    0xD6990624u, 0xF40E3585u, 0x106AA070u, 0x19A4C116u, 0x1E376C08u,
    0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au, 0x5B9CCA4Fu,
    0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
};

CONST_MEM uint32_t H0[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

// The instructions SHA-256 needs on sm_90, one helper each: a rotate or a
// shift is one SHF, any three-input logic function (the XOR of the three
// terms of a sigma, Ch, Maj) one LOP3, a sum of three addends one IADD3
// and of two one IADD.  The host build's tally counts one per call.
#if defined(SHA256_TALLY) && !defined(__CUDACC__)
long long g_ops = 0;
long long g_compressions = 0;

struct Word {
  uint32_t v;
  Word() : v(0) {}
  Word(uint32_t x) : v(x) {}
};
#define OP(expr) (g_ops++, Word(expr))
#define COUNT_COMPRESSION() (g_compressions++)
#else
typedef uint32_t Word;
#define OP(expr) (expr)
#define COUNT_COMPRESSION() ((void)0)
#endif

DEV uint32_t value(Word x) {
#if defined(SHA256_TALLY) && !defined(__CUDACC__)
  return x.v;
#else
  return x;
#endif
}
DEV Word rotr(Word x, int n) {
  const uint32_t v = value(x);
#if defined(__CUDACC__)
  return OP(__funnelshift_r(v, v, n));
#else
  return OP((v >> n) | (v << (32 - n)));
#endif
}
DEV Word shr(Word x, int n) { return OP(value(x) >> n); }
DEV Word xor3(Word a, Word b, Word c) {
  return OP(value(a) ^ value(b) ^ value(c));
}
DEV Word ch(Word e, Word f, Word g) {
  return OP((value(e) & value(f)) ^ (~value(e) & value(g)));
}
DEV Word maj(Word a, Word b, Word c) {
  return OP((value(a) & value(b)) ^ (value(a) & value(c)) ^
            (value(b) & value(c)));
}
DEV Word add3(Word a, Word b, Word c) {
  return OP(value(a) + value(b) + value(c));
}
DEV Word add(Word a, Word b) { return OP(value(a) + value(b)); }

// One SHA-256 compression of the 16 message words `w` (overwritten: the
// schedule rolls through them) into the state `s`.
DEV void compress(Word s[8], Word w[16]) {
  COUNT_COMPRESSION();
  Word a = s[0], b = s[1], c = s[2], d = s[3];
  Word e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 64; t++) {
    Word wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const Word x15 = w[(t - 15) & 15], x2 = w[(t - 2) & 15];
      const Word s0 = xor3(rotr(x15, 7), rotr(x15, 18), shr(x15, 3));
      const Word s1 = xor3(rotr(x2, 17), rotr(x2, 19), shr(x2, 10));
      // w[t & 15] is w[t - 16]
      wt = add(add3(w[t & 15], s0, w[(t - 7) & 15]), s1);
      w[t & 15] = wt;
    }
    const Word S1 = xor3(rotr(e, 6), rotr(e, 11), rotr(e, 25));
    const Word t1 = add3(add3(h, S1, ch(e, f, g)), Word(K[t]), wt);
    const Word S0 = xor3(rotr(a, 2), rotr(a, 13), rotr(a, 22));
    const Word m = maj(a, b, c);
    h = g;
    g = f;
    f = e;
    e = add(d, t1);
    d = c;
    c = b;
    b = a;
    a = add3(t1, S0, m);
  }
  s[0] = add(s[0], a);
  s[1] = add(s[1], b);
  s[2] = add(s[2], c);
  s[3] = add(s[3], d);
  s[4] = add(s[4], e);
  s[5] = add(s[5], f);
  s[6] = add(s[6], g);
  s[7] = add(s[7], h);
}

// Byte p of the padded message 0x00 || leaf (len bytes at `leaf`), whose
// padded length is `total` bytes.
DEV uint32_t leaf_message_byte(const uint8_t* leaf, int64_t len, int64_t total,
                               int64_t p) {
  if (p == 0) return 0u;  // the RFC 6962 leaf prefix
  if (p <= len) return leaf[p - 1];
  if (p == len + 1) return 0x80u;
  if (p >= total - 8) {
    const uint64_t bits = (uint64_t)(len + 1) * 8u;
    return (uint32_t)(bits >> (8 * (total - 1 - p))) & 0xFFu;
  }
  return 0u;
}

// SHA-256(0x00 || leaf) into out[0..7].
DEV void leaf_digest(const uint8_t* leaf, int64_t len, uint32_t* out) {
  const int64_t total = ((len + 1 + 8) / 64 + 1) * 64;
  Word s[8];
  for (int j = 0; j < 8; j++) s[j] = Word(H0[j]);
  for (int64_t base = 0; base < total; base += 64) {
    Word w[16];
#pragma unroll
    for (int j = 0; j < 16; j++) {
      uint32_t x = 0;
#pragma unroll
      for (int k = 0; k < 4; k++)
        x = (x << 8) | leaf_message_byte(leaf, len, total, base + 4 * j + k);
      w[j] = Word(x);
    }
    compress(s, w);
  }
  for (int j = 0; j < 8; j++) out[j] = value(s[j]);
}

// SHA-256(0x01 || L || R) of two digests into out[0..7]: a 65-byte message,
// two blocks, its words shifted by the one-byte prefix.
DEV void inner_digest(const uint32_t* l, const uint32_t* r, uint32_t* out) {
  Word s[8];
  for (int j = 0; j < 8; j++) s[j] = Word(H0[j]);
  Word w[16];
  w[0] = Word(0x01000000u | (l[0] >> 8));
  for (int j = 1; j < 8; j++) w[j] = Word((l[j - 1] << 24) | (l[j] >> 8));
  w[8] = Word((l[7] << 24) | (r[0] >> 8));
  for (int j = 1; j < 8; j++) w[8 + j] = Word((r[j - 1] << 24) | (r[j] >> 8));
  compress(s, w);
  w[0] = Word((r[7] << 24) | 0x00800000u);  // the last byte of R, then 0x80
  for (int j = 1; j < 15; j++) w[j] = Word(0u);
  w[15] = Word(65u * 8u);  // bit length
  compress(s, w);
  for (int j = 0; j < 8; j++) out[j] = value(s[j]);
}

// Parent j of a level of k digests: the pair (2j, 2j + 1), or the promoted
// odd tail.
DEV void parent(const uint32_t* in, int k, int j, uint32_t* out) {
  if (2 * j + 1 < k) {
    inner_digest(in + 16 * j, in + 16 * j + 8, out);
  } else {
    for (int c = 0; c < 8; c++) out[c] = in[16 * j + c];
  }
}

}  // namespace

#if defined(__CUDACC__)

__global__ void __launch_bounds__(THREADS)
    sha256_leaf_kernel(const uint8_t* __restrict__ data,
                       const int64_t* __restrict__ offs, int n,
                       uint32_t* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int64_t off = offs[i];
  leaf_digest(data + off, offs[i + 1] - off, out + 8 * i);
}

__global__ void __launch_bounds__(THREADS)
    sha256_layer_kernel(const uint32_t* __restrict__ in, int k,
                        uint32_t* __restrict__ out) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= (k + 1) / 2) return;
  parent(in, k, j, out + 8 * j);
}

// data: the leaves' bytes back to back; offs: (n + 1,) int64, leaf i is
// data[offs[i]:offs[i + 1]]; out: (n, 8) uint32 leaf digests.  Launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError().
extern "C" int sha256_leaf_launch(const void* data, const void* offs, int n,
                                  void* out, void* stream) {
  if (n > 0) {
    const int blocks = (n + THREADS - 1) / THREADS;
    sha256_leaf_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int64_t*)offs, n, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

// in: (k, 8) uint32 digests of one level; out: (ceil(k / 2), 8) uint32, the
// level above.  Launches on `stream`; returns cudaGetLastError().
extern "C" int sha256_layer_launch(const void* in, int k, void* out,
                                   void* stream) {
  if (k > 1) {
    const int parents = (k + 1) / 2;
    const int blocks = (parents + THREADS - 1) / THREADS;
    sha256_layer_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, k, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

// The leaf kernel's launch resources: blocks resident per SM, threads per
// block, and the compiled kernel's registers, local memory bytes per thread
// and static shared memory bytes per block.  Returns a CUDA error code.
extern "C" int sha256_tree_occupancy(int* blocks_per_sm, int* threads,
                                     int* regs, int* local_bytes,
                                     int* shared_bytes) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, sha256_leaf_kernel);
  if (e != cudaSuccess) return (int)e;
  *threads = THREADS;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  *shared_bytes = (int)fa.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, sha256_leaf_kernel, THREADS, 0);
}

#else  // host build: one leaf, then one parent, after another

extern "C" void sha256_leaf_host(const uint8_t* data, const int64_t* offs,
                                 int n, uint32_t* out) {
  for (int i = 0; i < n; i++)
    leaf_digest(data + offs[i], offs[i + 1] - offs[i], out + 8 * i);
}

extern "C" void sha256_layer_host(const uint32_t* in, int k, uint32_t* out) {
  if (k < 2) return;
  for (int j = 0; j < (k + 1) / 2; j++) parent(in, k, j, out + 8 * j);
}

#if defined(SHA256_TALLY)
// Compressions and counted 32-bit operations since the last call; resets.
extern "C" void sha256_tally(long long* compressions, long long* ops) {
  *compressions = g_compressions;
  *ops = g_ops;
  g_compressions = 0;
  g_ops = 0;
}
#endif

#endif
