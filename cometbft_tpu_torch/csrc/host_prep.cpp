// Host half of the port's commit verification: the C++ the commit path
// runs before and around the verify kernel, single-threaded.
//
//  * SHA-512 (FIPS 180-4) and the 5-limb mod-L arithmetic;
//  * ed25519_pack: per signature h = SHA-512(R || A || m) mod L, the
//    kernel's scalar m = (L - h) mod L, and the s < L check (s is zeroed
//    when s >= L);
//  * commit_sign_bytes: the protoio length-delimited CanonicalVote of every
//    signature of one commit (reference: types/canonical.go:57,
//    types/vote.go:151);
//  * the consensus WAL's writer (wal_open, wal_append, wal_sync, wal_size,
//    wal_close): CRC32 + length framed appends with the fsync discipline of
//    internal/consensus/wal.go, whose frames consensus/wal.py reads back.
//
// The port's own copy of those parts of cometbft_tpu/native/csrc/
// cometbft_native.cpp (the port builds nothing of the JAX package); one
// change: commit_sign_bytes takes the block-id flags as int64, as it takes
// the timestamps.  The Python encoders (ops/verify.py _pack_plain,
// types/block.py vote_sign_bytes) are the references the tests hold it to.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (cometbft_tpu_torch/ops/_build.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <fcntl.h>
#include <unistd.h>

// ---------------------------------------------------------------------------
// SHA-512 (FIPS 180-4)
// ---------------------------------------------------------------------------

static const uint64_t K512[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

static inline uint64_t rotr64(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

struct Sha512Ctx {
    uint64_t h[8];
    uint8_t buf[128];
    size_t buf_len;
    uint64_t total;
};

static void sha512_init(Sha512Ctx* c) {
    static const uint64_t iv[8] = {
        0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
        0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
        0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
    memcpy(c->h, iv, sizeof(iv));
    c->buf_len = 0;
    c->total = 0;
}

static void sha512_block(Sha512Ctx* c, const uint8_t* p) {
    uint64_t w[80];
    for (int i = 0; i < 16; i++) {
        w[i] = 0;
        for (int j = 0; j < 8; j++) w[i] = (w[i] << 8) | p[i * 8 + j];
    }
    for (int i = 16; i < 80; i++) {
        uint64_t s0 = rotr64(w[i - 15], 1) ^ rotr64(w[i - 15], 8) ^ (w[i - 15] >> 7);
        uint64_t s1 = rotr64(w[i - 2], 19) ^ rotr64(w[i - 2], 61) ^ (w[i - 2] >> 6);
        w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint64_t a = c->h[0], b = c->h[1], cc = c->h[2], d = c->h[3];
    uint64_t e = c->h[4], f = c->h[5], g = c->h[6], hh = c->h[7];
    for (int i = 0; i < 80; i++) {
        uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
        uint64_t ch = (e & f) ^ (~e & g);
        uint64_t t1 = hh + S1 + ch + K512[i] + w[i];
        uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
        uint64_t maj = (a & b) ^ (a & cc) ^ (b & cc);
        uint64_t t2 = S0 + maj;
        hh = g; g = f; f = e; e = d + t1;
        d = cc; cc = b; b = a; a = t1 + t2;
    }
    c->h[0] += a; c->h[1] += b; c->h[2] += cc; c->h[3] += d;
    c->h[4] += e; c->h[5] += f; c->h[6] += g; c->h[7] += hh;
}

static void sha512_update(Sha512Ctx* c, const uint8_t* data, size_t len) {
    c->total += len;
    while (len > 0) {
        size_t take = 128 - c->buf_len;
        if (take > len) take = len;
        memcpy(c->buf + c->buf_len, data, take);
        c->buf_len += take;
        data += take;
        len -= take;
        if (c->buf_len == 128) {
            sha512_block(c, c->buf);
            c->buf_len = 0;
        }
    }
}

static void sha512_final(Sha512Ctx* c, uint8_t out[64]) {
    uint64_t bits = c->total * 8;
    uint8_t pad = 0x80;
    sha512_update(c, &pad, 1);
    uint8_t zero = 0;
    while (c->buf_len != 112) sha512_update(c, &zero, 1);
    uint8_t lenbuf[16] = {0};
    for (int i = 0; i < 8; i++) lenbuf[15 - i] = (bits >> (8 * i)) & 0xFF;
    sha512_update(c, lenbuf, 16);
    for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
            out[i * 8 + j] = (c->h[i] >> (56 - 8 * j)) & 0xFF;
}

// ---------------------------------------------------------------------------
// mod-L arithmetic (L = 2^252 + 27742317777372353535851937790883648493)
// ---------------------------------------------------------------------------

// 5-limb little-endian u64 bignum (320 bits of headroom)
typedef uint64_t bn5[5];

static const bn5 L_BN = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                         0x0000000000000000ULL, 0x1000000000000000ULL, 0};

static int bn_cmp(const bn5 a, const bn5 b) {
    for (int i = 4; i >= 0; i--) {
        if (a[i] < b[i]) return -1;
        if (a[i] > b[i]) return 1;
    }
    return 0;
}

static void bn_sub(bn5 a, const bn5 b) {  // a -= b (a >= b)
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 5; i++) {
        unsigned __int128 d =
            (unsigned __int128)a[i] - b[i] - borrow;
        a[i] = (uint64_t)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static void bn_mul_small(bn5 out, const bn5 a, uint64_t k) {  // out = a*k
    unsigned __int128 carry = 0;
    for (int i = 0; i < 5; i++) {
        unsigned __int128 p = (unsigned __int128)a[i] * k + carry;
        out[i] = (uint64_t)p;
        carry = p >> 64;
    }
}

// r = r*256 + byte, then reduce mod L (r stays < L)
static void bn_horner_step(bn5 r, uint8_t byte) {
    // shift left 8 bits
    uint64_t carry = byte;
    for (int i = 0; i < 5; i++) {
        unsigned __int128 v = ((unsigned __int128)r[i] << 8) | carry;
        r[i] = (uint64_t)v;
        carry = (uint64_t)(v >> 64);
    }
    // r < 256*L < 2^261; estimate q = r >> 252 and subtract q*L.  Since
    // L > 2^252 the estimate can overshoot by one — detect and back off.
    uint64_t q = (r[3] >> 60) | (r[4] << 4);
    if (q) {
        bn5 qL;
        bn_mul_small(qL, L_BN, q);
        if (bn_cmp(r, qL) < 0) bn_mul_small(qL, L_BN, q - 1);
        bn_sub(r, qL);
    }
    while (bn_cmp(r, L_BN) >= 0) bn_sub(r, L_BN);
}

static void bn_from_le64(bn5 r, const uint8_t h[64]) {  // h mod L
    memset(r, 0, sizeof(bn5));
    for (int i = 63; i >= 0; i--) bn_horner_step(r, h[i]);
}

static void bn_to_le32(const bn5 r, uint8_t out[32]) {
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 8; j++)
            out[i * 8 + j] = (r[i] >> (8 * j)) & 0xFF;
}

// ---------------------------------------------------------------------------
// Ed25519 batch packer
// ---------------------------------------------------------------------------

extern "C" {

// pubs: n*32, sigs: n*64, msgs concatenated with (n+1) offsets.
// Outputs (all caller-allocated):
//   s_out n*32 (zeroed when s >= L), m_out n*32 ((L - h) mod L, LE),
//   s_ok_out n bytes.
int ed25519_pack(const uint8_t* pubs, const uint8_t* sigs,
                 const uint8_t* msgs, const int64_t* msg_off, int64_t n,
                 uint8_t* s_out, uint8_t* m_out, uint8_t* s_ok_out) {
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* pub = pubs + i * 32;
        const uint8_t* r_enc = sigs + i * 64;
        const uint8_t* s_enc = sigs + i * 64 + 32;

        // s < L check (little-endian compare)
        bn5 s_bn = {0, 0, 0, 0, 0};
        for (int w = 0; w < 4; w++)
            for (int b = 7; b >= 0; b--)
                s_bn[w] = (s_bn[w] << 8) | s_enc[w * 8 + (b)];
        int s_ok = bn_cmp(s_bn, L_BN) < 0;
        s_ok_out[i] = (uint8_t)s_ok;
        if (s_ok)
            memcpy(s_out + i * 32, s_enc, 32);
        else
            memset(s_out + i * 32, 0, 32);

        // h = SHA512(R || A || m) mod L;  m_scalar = (L - h) mod L
        Sha512Ctx ctx;
        sha512_init(&ctx);
        sha512_update(&ctx, r_enc, 32);
        sha512_update(&ctx, pub, 32);
        sha512_update(&ctx, msgs + msg_off[i],
                      (size_t)(msg_off[i + 1] - msg_off[i]));
        uint8_t digest[64];
        sha512_final(&ctx, digest);
        bn5 h_bn;
        bn_from_le64(h_bn, digest);
        bn5 m_bn;
        memcpy(m_bn, L_BN, sizeof(bn5));
        if (h_bn[0] | h_bn[1] | h_bn[2] | h_bn[3] | h_bn[4]) {
            bn_sub(m_bn, h_bn);
        } else {
            memset(m_bn, 0, sizeof(bn5));
        }
        bn_to_le32(m_bn, m_out + i * 32);
    }
    return 0;
}

// standalone SHA-512 (tests and chip_smoke.py hold it to hashlib)
void sha512(const uint8_t* data, int64_t len, uint8_t* out64) {
    Sha512Ctx c;
    sha512_init(&c);
    sha512_update(&c, data, (size_t)len);
    sha512_final(&c, out64);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Canonical precommit sign bytes (reference: types/canonical.go:57 +
// types/vote.go:151; byte-exact mirror of types/canonical.py +
// libs/protoenc.py — differential-tested in tests/test_torch_host_prep.py)
// ---------------------------------------------------------------------------

namespace {

struct Buf {
    uint8_t* p;
    int64_t cap;
    int64_t len;
    bool overflow;
    void put(uint8_t b) {
        if (len >= cap) { overflow = true; return; }
        p[len++] = b;
    }
    void put_bytes(const uint8_t* d, int64_t n) {
        if (len + n > cap) { overflow = true; return; }
        memcpy(p + len, d, n);
        len += n;
    }
};

static void put_uvarint(Buf& b, uint64_t n) {
    while (true) {
        uint8_t byte = n & 0x7F;
        n >>= 7;
        if (n) b.put(byte | 0x80);
        else { b.put(byte); return; }
    }
}

static void put_tag(Buf& b, int field, int wire) {
    put_uvarint(b, (uint64_t)((field << 3) | wire));
}

// t_varint semantics: omitted when zero; negatives as 64-bit two's
// complement (proto3 int64)
static void put_t_varint(Buf& b, int field, int64_t v) {
    if (v == 0) return;
    put_tag(b, field, 0);
    put_uvarint(b, (uint64_t)v);
}

static void put_t_sfixed64(Buf& b, int field, int64_t v) {
    if (v == 0) return;
    put_tag(b, field, 1);
    uint64_t u = (uint64_t)v;
    for (int i = 0; i < 8; i++) b.put((uint8_t)(u >> (8 * i)));
}

static void put_t_bytes(Buf& b, int field, const uint8_t* d, int64_t n) {
    if (n <= 0) return;
    put_tag(b, field, 2);
    put_uvarint(b, (uint64_t)n);
    b.put_bytes(d, n);
}

}  // namespace

extern "C" {

// Sign bytes for every signature of one commit: the protoio
// length-delimited CanonicalVote per validator.  All votes share
// (chain_id, height, round, block_id); only the timestamp and the
// block-id flag (2 = COMMIT -> block_id present; else nil -> omitted)
// vary per lane.  ``out_off`` receives n+1 offsets into ``out``.
// Returns total bytes written, or -1 when ``cap`` is too small.
int64_t commit_sign_bytes(
    const uint8_t* chain_id, int64_t chain_id_len,
    int64_t height, int64_t round_,
    const uint8_t* bid_hash, int64_t bid_hash_len,
    int64_t psh_total, const uint8_t* psh_hash, int64_t psh_hash_len,
    const int64_t* flags, const int64_t* ts_s, const int64_t* ts_ns,
    int64_t n, uint8_t* out, int64_t cap, int64_t* out_off) {
    // canonical block id submessage (shared by every COMMIT-flag vote):
    //   1: bytes hash, 2: message{1: varint total, 2: bytes hash}
    uint8_t bid_buf[128];
    Buf bid{bid_buf, (int64_t)sizeof(bid_buf), 0, false};
    put_t_bytes(bid, 1, bid_hash, bid_hash_len);
    {
        uint8_t psh_buf[64];
        Buf psh{psh_buf, (int64_t)sizeof(psh_buf), 0, false};
        put_t_varint(psh, 1, psh_total);
        put_t_bytes(psh, 2, psh_hash, psh_hash_len);
        if (psh.overflow) return -1;
        if (psh.len > 0) {  // t_message: omitted when empty
            put_tag(bid, 2, 2);
            put_uvarint(bid, (uint64_t)psh.len);
            bid.put_bytes(psh_buf, psh.len);
        }
    }
    if (bid.overflow) return -1;

    Buf o{out, cap, 0, false};
    for (int64_t i = 0; i < n; i++) {
        out_off[i] = o.len;
        // body assembled in a scratch buffer (max ~200B)
        uint8_t body_buf[256];
        Buf body{body_buf, (int64_t)sizeof(body_buf), 0, false};
        put_t_varint(body, 1, 2);  // type = PRECOMMIT
        put_t_sfixed64(body, 2, height);
        put_t_sfixed64(body, 3, round_);
        if (flags[i] == 2 && bid.len > 0) {  // BLOCK_ID_FLAG_COMMIT
            put_tag(body, 4, 2);
            put_uvarint(body, (uint64_t)bid.len);
            body.put_bytes(bid_buf, bid.len);
        }
        {
            uint8_t ts_buf[24];
            Buf ts{ts_buf, (int64_t)sizeof(ts_buf), 0, false};
            put_t_varint(ts, 1, ts_s[i]);
            put_t_varint(ts, 2, ts_ns[i]);
            if (ts.len > 0) {  // t_message: zero timestamp -> omitted
                put_tag(body, 5, 2);
                put_uvarint(body, (uint64_t)ts.len);
                body.put_bytes(ts_buf, ts.len);
            }
        }
        put_t_bytes(body, 6, chain_id, chain_id_len);
        if (body.overflow) return -1;
        // protoio delimited framing
        put_uvarint(o, (uint64_t)body.len);
        o.put_bytes(body_buf, body.len);
        if (o.overflow) return -1;
    }
    out_off[n] = o.len;
    return o.len;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CRC32 (zlib polynomial, matches Python's zlib.crc32)
// ---------------------------------------------------------------------------

static uint32_t crc_table[256];

static int crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[i] = c;
    }
    return 0;
}

static uint32_t crc32_of(const uint8_t* buf, size_t len) {
    // magic static: guaranteed one-time, thread-safe initialization
    static const int crc_ready = crc_init();
    (void)crc_ready;
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < len; i++)
        c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// WAL engine (reference: internal/consensus/wal.go WALEncoder + autofile)
// ---------------------------------------------------------------------------

struct Wal {
    int fd;
    int64_t size;
    std::mutex mtx;  // appends must be whole-frame atomic across threads
};

extern "C" {

void* wal_open(const char* path) {
    int fd = ::open(path, O_WRONLY | O_CREAT | O_APPEND, 0644);
    if (fd < 0) return nullptr;
    Wal* w = new Wal();
    w->fd = fd;
    w->size = ::lseek(fd, 0, SEEK_END);
    return w;
}

// frame: u32be crc | u32be len | kind byte | payload
int wal_append(void* h, int kind, const uint8_t* data, int64_t len, int sync) {
    Wal* w = static_cast<Wal*>(h);
    if (!w || len < 0) return -1;
    size_t body_len = static_cast<size_t>(len) + 1;
    uint8_t* frame = static_cast<uint8_t*>(malloc(8 + body_len));
    if (!frame) return -1;
    frame[8] = static_cast<uint8_t>(kind);
    memcpy(frame + 9, data, len);
    uint32_t crc = crc32_of(frame + 8, body_len);
    uint32_t blen = static_cast<uint32_t>(body_len);
    for (int i = 0; i < 4; i++) {
        frame[i] = (crc >> (24 - 8 * i)) & 0xFF;
        frame[4 + i] = (blen >> (24 - 8 * i)) & 0xFF;
    }
    size_t total = 8 + body_len;
    {
        // hold the lock across the partial-write loop: a frame must hit
        // the file contiguously even if write() returns short
        std::lock_guard<std::mutex> g(w->mtx);
        size_t off = 0;
        while (off < total) {
            ssize_t nw = ::write(w->fd, frame + off, total - off);
            if (nw < 0) { free(frame); return -1; }
            off += static_cast<size_t>(nw);
        }
        w->size += static_cast<int64_t>(total);
    }
    free(frame);
    if (sync && ::fsync(w->fd) != 0) return -1;
    return 0;
}

int wal_sync(void* h) {
    Wal* w = static_cast<Wal*>(h);
    return w ? ::fsync(w->fd) : -1;
}

int64_t wal_size(void* h) {
    Wal* w = static_cast<Wal*>(h);
    if (!w) return -1;
    std::lock_guard<std::mutex> g(w->mtx);
    return w->size;
}

void wal_close(void* h) {
    Wal* w = static_cast<Wal*>(h);
    if (!w) return;
    ::fsync(w->fd);
    ::close(w->fd);
    delete w;
}

}  // extern "C"
