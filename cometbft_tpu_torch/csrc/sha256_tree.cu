// RFC 6962 SHA-256 Merkle tree, every level, for NVIDIA Hopper (sm_90a).
//
// Replaces the XLA programs of cometbft_tpu/ops/sha256_tree.py: _leaf_fn
// (:227) and _layer_fn (:252) over _compress (:204).  One kernel, one
// launch per tree:
//
//   * the grid is ceil(n / C) blocks of C threads, one thread per leaf.
//     Block b owns the aligned chunk of leaves [b * C, b * C + C): under
//     bottom-up pairing with the odd tail promoted that chunk is a complete
//     subtree (the last, partial chunk sits at the right edge, so its odd
//     tails are the tree's own), and it reduces to one digest without
//     seeing any other block;
//   * each thread hashes its leaf, SHA-256(0x00 || leaf), from the leaf's
//     raw bytes (one byte buffer and per-leaf offsets), padding it itself;
//   * the block pairs its level in shared memory, SHA-256(0x01 || L || R),
//     one __syncthreads() per level, ping-ponging between two buffers of
//     C digests; log2(C) levels bring the chunk to its root;
//   * every digest of every level is also written to its row of `out`
//     (leaves first, the rows of ops/sha256_tree.level_sizes);
//   * the last block to finish, by a ticket taken with atomicAdd after a
//     __threadfence(), reads the ceil(n / C) chunk roots past L1 and
//     reduces them in shared memory the same way (C at a time, should there
//     be more than C), and sets the ticket back to 0.  A tree of n <= C is
//     one block and takes no ticket.
//
// Digests are 8 uint32 words, big-endian values as SHA-256 defines them
// (the JAX kernel's (B, 8) uint32 rows).
//
// What bounds it: a compression is 1,384 instructions of sm_90's integer
// ISA (48 schedule words of 10, 64 rounds of 14, 8 final additions; a
// rotate or a shift is one SHF, any three-input logic function one LOP3,
// three addends one IADD3; counted by the host build below), so a
// 1,000-leaf tree (~3,000 compressions) is ~0.25 us of the card's INT32
// lanes and a few hundred kilobytes of memory traffic.  At that width the
// tree is bound by its depth: a leaf's blocks, then two dependent
// compressions per level (21 at 1,000 leaves), each a chain of 64 rounds
// that one warp issues alone near the top of the tree (~25 instructions a
// round with the schedule's; ~3.4 us of device time per level on the
// card, PERF.md).  The design keeps each lane's rounds in registers (the
// message schedule as a rolling window of 16 words, rotates as
// __funnelshift_r, K in constant memory) and the levels on the card, in
// one launch: with a launch per level (11 at 1,000 leaves) each level
// would wait for the whole level below to drain.
//
// C = 128 by default (-DSHA256_CHUNK=k builds another power of two up to
// 1,024), chosen by measurement: chip_smoke.py's light phase times C =
// 128, 256, 512 and 1,024 in turns at 1,000 and 16,384 leaves, and 128
// had the least device time at both, 3-5% below 256 (its warps share an
// SM's four schedulers with fewer others; 512 spills, 1,024 is held to 64
// registers; PERF.md).  Shared memory is 2 x C x 32 bytes (8 KiB at 128),
// dynamic above 48 KiB.
//
// Without __CUDACC__ the same source builds for the host, running the
// kernel's block schedule in turn: each chunk's leaves, its levels, then
// the last block's pass over the chunk roots, each step for every thread
// of the block between two barriers.  With -DSHA256_TALLY the host build
// counts every instruction of the compressions (one per helper below), for
// the bound's tally.

#include <stdint.h>

#if !defined(__CUDACC__)
#include <vector>
#endif

#if defined(__CUDACC__)
#define DEV __device__ __forceinline__
#define CONST_MEM __constant__
#else
#define DEV static inline
#define CONST_MEM static const
#endif

#ifndef SHA256_CHUNK
#define SHA256_CHUNK 128  // C: leaves (threads) per block
#endif
static_assert(SHA256_CHUNK >= 2 && SHA256_CHUNK <= 1024 &&
                  (SHA256_CHUNK & (SHA256_CHUNK - 1)) == 0,
              "SHA256_CHUNK: a power of two from 2 to 1,024");

namespace {

constexpr int CHUNK = SHA256_CHUNK;  // C
constexpr int SHARED_BYTES = 2 * 8 * CHUNK * 4;  // two buffers of C digests

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

// The block schedule.  EACH_THREAD(t) runs its body as thread t of the
// block: on the card as the thread itself, in the host build for every t
// in turn.  BARRIER() separates two steps of the block.  No thread returns
// before a barrier: threads past a level's count skip its work and fall
// through.
#if defined(__CUDACC__)
#define EACH_THREAD(t) for (int t = threadIdx.x; t < (int)threadIdx.x + 1; t++)
#define BARRIER() __syncthreads()
#else
#define EACH_THREAD(t) for (int t = 0; t < CHUNK; t++)
#define BARRIER() ((void)0)
#endif

DEV int imin(int a, int b) { return a < b ? a : b; }

// A word of a digest another block wrote: read past L1 (which is not kept
// coherent across SMs), from L2.
DEV uint32_t load_cg(const uint32_t* p) {
#if defined(__CUDACC__)
  return __ldcg(p);
#else
  return *p;
#endif
}

// A level of the tree: its first row in `out` and its digests.
struct Level {
  int64_t base;
  int size;
};

DEV Level up(Level lv) { return Level{lv.base + lv.size, (lv.size + 1) / 2}; }

// Digest slot j of a shared buffer: 8 words, word c at [c * CHUNK + j]
// (so that a warp's reads of adjacent children hit two banks at most),
// and the same digest into its row of `out`.
DEV void put(uint32_t* buf, int j, const uint32_t* d, uint32_t* row) {
  for (int c = 0; c < 8; c++) {
    buf[c * CHUNK + j] = d[c];
    row[c] = d[c];
  }
}

// Thread t's parent of the k digests in `a`: the pair (2t, 2t + 1), or the
// promoted odd tail, into slot t of `b` and `row`.
DEV void parent_step(const uint32_t* a, int k, int t, uint32_t* b,
                     uint32_t* row) {
  uint32_t l[8], r[8], d[8];
  for (int c = 0; c < 8; c++) l[c] = a[c * CHUNK + 2 * t];
  if (2 * t + 1 < k) {
    for (int c = 0; c < 8; c++) r[c] = a[c * CHUNK + 2 * t + 1];
    inner_digest(l, r, d);
    put(b, t, d, row);
  } else {
    put(b, t, l, row);
  }
}

// The levels above k digests in `a` that begin at index `start` of level
// `lv`: up to log2(C) levels, fewer where the tree's root comes first.
// Leaves the top digests in `a` and `lv` at the last level written.
DEV void chunk_levels(uint32_t*& a, uint32_t*& b, int k, int start, Level& lv,
                      uint32_t* out) {
  for (int span = 1; span < CHUNK && lv.size > 1; span *= 2) {
    const int64_t row = lv.base + lv.size + start / 2;
    EACH_THREAD(t) {
      if (t < (k + 1) / 2) parent_step(a, k, t, b, out + 8 * (row + t));
    }
    BARRIER();
    uint32_t* s = a;
    a = b;
    b = s;
    lv = up(lv);
    start /= 2;
    k = (k + 1) / 2;
  }
}

// Whether the calling block is the last of `blocks` to finish its chunk.
// The last one sets the ticket back to 0, so a launch leaves it as it
// found it.
DEV bool last_ticket(int* ticket, int blocks) {
#if defined(__CUDACC__)
  const bool last = atomicAdd(ticket, 1) == blocks - 1;
  if (last) {
    *ticket = 0;
    __threadfence();  // the chunk roots are read after the ticket
  }
  return last;
#else
  const bool last = (*ticket)++ == blocks - 1;
  if (last) *ticket = 0;
  return last;
#endif
}

// Block `blk` of `blocks`: the chunk's leaves and levels; then, in the last
// block to finish, the levels above the chunk roots.  `smem`: two buffers
// of 8 x CHUNK words; `last`: one int the block shares.
DEV void tree_block(int blk, int blocks, const uint8_t* data,
                    const int64_t* offs, int n, uint32_t* out, int* ticket,
                    uint32_t* smem, int* last) {
  uint32_t* a = smem;
  uint32_t* b = smem + 8 * CHUNK;
  const int first = blk * CHUNK;
  const int m = imin(CHUNK, n - first);
  EACH_THREAD(t) {
    if (t < m) {
      const int64_t off = offs[first + t];
      uint32_t d[8];
      leaf_digest(data + off, offs[first + t + 1] - off, d);
      put(a, t, d, out + 8 * (int64_t)(first + t));
    }
  }
  BARRIER();
  Level lv = {0, n};
  chunk_levels(a, b, m, first, lv, out);  // lv: the chunk roots' level
  if (blocks == 1) return;
#if defined(__CUDACC__)
  __threadfence();  // this chunk's rows, the root among them, before the ticket
#endif
  BARRIER();
  EACH_THREAD(t) {
    if (t == 0) *last = last_ticket(ticket, blocks);
  }
  BARRIER();
  if (!*last) return;
  while (lv.size > 1) {
    const Level top = lv;
    for (int g = 0; g < top.size; g += CHUNK) {
      const int k = imin(CHUNK, top.size - g);
      EACH_THREAD(t) {
        if (t < k) {
          for (int c = 0; c < 8; c++)
            a[c * CHUNK + t] = load_cg(out + 8 * (top.base + g + t) + c);
        }
      }
      BARRIER();
      lv = top;
      chunk_levels(a, b, k, g, lv, out);
    }
  }
}

}  // namespace

#if defined(__CUDACC__)

__global__ void __launch_bounds__(CHUNK)
    sha256_tree_kernel(const uint8_t* __restrict__ data,
                       const int64_t* __restrict__ offs, int n, uint32_t* out,
                       int* ticket) {
  extern __shared__ uint32_t smem[];
  __shared__ int last;
  tree_block(blockIdx.x, gridDim.x, data, offs, n, out, ticket, smem, &last);
}

// Above 48 KiB a block's dynamic shared memory has to be allowed first.
static cudaError_t allow_shared() {
  if (SHARED_BYTES <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(sha256_tree_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SHARED_BYTES);
}

// data: the leaves' bytes back to back; offs: (n + 1,) int64, leaf i is
// data[offs[i]:offs[i + 1]]; out: (sum of level_sizes(n), 8) uint32, every
// level's digests, leaves first; ticket: one int32, 0, that no other
// stream's launch uses (the last block sets it back to 0).  n >= 1.
// Launches on `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError().
extern "C" int sha256_tree_launch(const void* data, const void* offs, int n,
                                  void* out, void* ticket, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_shared();
  if (e != cudaSuccess) return (int)e;
  sha256_tree_kernel<<<(n + CHUNK - 1) / CHUNK, CHUNK, SHARED_BYTES,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const int64_t*)offs, n, (uint32_t*)out,
      (int*)ticket);
  return (int)cudaGetLastError();
}

// The kernel's launch resources: blocks resident per SM, threads per block
// (C), and the compiled kernel's registers, local memory bytes per thread
// and shared memory bytes per block (static and dynamic).  Returns a CUDA
// error code.
extern "C" int sha256_tree_occupancy(int* blocks_per_sm, int* threads,
                                     int* regs, int* local_bytes,
                                     int* shared_bytes) {
  cudaFuncAttributes fa;
  cudaError_t e = allow_shared();
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, sha256_tree_kernel);
  if (e != cudaSuccess) return (int)e;
  *threads = CHUNK;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  *shared_bytes = (int)fa.sharedSizeBytes + SHARED_BYTES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, sha256_tree_kernel, CHUNK, SHARED_BYTES);
}

#else  // host build: the blocks one after another, in the kernel's schedule

// The kernel's output for the n leaves of data/offs into out (every level,
// leaves first), computed block by block as the launch schedules it, the
// last block last.  Returns the ticket after the run: 0, as before it.
extern "C" int sha256_tree_host(const uint8_t* data, const int64_t* offs,
                                int n, uint32_t* out) {
  std::vector<uint32_t> smem(2 * 8 * CHUNK);
  const int blocks = (n + CHUNK - 1) / CHUNK;
  int ticket = 0, last = 0;
  for (int blk = 0; blk < blocks; blk++)
    tree_block(blk, blocks, data, offs, n, out, &ticket, smem.data(), &last);
  return ticket;
}

// C: leaves per block of this build.
extern "C" int sha256_tree_chunk(void) { return CHUNK; }

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
