// qzbatch: whole-request native funnel for the qatzip-tpu software engine.
//
// The reference keeps its entire hot request loop in C — chunk split, DMA
// submit, ordered reassembly, header/footer generation and CRC stitching
// (src/qatzip.c:1483-1764, src/qatzip_utils.c:888-995).  This file is the
// equivalent for the TPU build's host path: ONE C call per request that
//   - splits the input into hw_buff_sz chunks,
//   - compresses every chunk on a worker pool (the analog of the 32
//     in-flight HW requests, src/qatzip_internal.h:65-70),
//   - frames each chunk as a standalone member (gzip/gzipext/4B/raw/zlib,
//     layouts per src/qatzip_gzip.c:86-160,263-344),
//   - computes per-chunk CRC32/Adler32 and combines them in block order
//     (crc32_combine use, src/qatzip.c:1707-1714),
//   - reassembles members contiguously in submission order (the seq_in
//     ordering invariant, src/qatzip.c:1641-1649).
// and the mirror batch-inflate for decompression.
//
// Build: python -m qatzip_tpu_torch.native.build
#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

extern "C" {
int64_t qz_deflate_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t cap, int level);
int64_t qz_inflate(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                   int64_t* in_used, int32_t* eof);
uint32_t qz_crc32_combine(uint32_t crc1, uint32_t crc2, int64_t len2);
}

namespace {

// ---------------------------------------------------------------------------
// checksums: slice-by-8 CRC32 (poly 0xEDB88320) and Adler32
// ---------------------------------------------------------------------------
struct CrcTables {
    uint32_t t[8][256];
    CrcTables() {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++)
                c = (c >> 1) ^ (0xEDB88320u & (~(c & 1) + 1));
            t[0][i] = c;
        }
        for (int s = 1; s < 8; s++)
            for (uint32_t i = 0; i < 256; i++)
                t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
    }
};
const CrcTables g_crc;

uint32_t crc32_sb8(uint32_t crc, const uint8_t* p, int64_t n) {
    crc = ~crc;
    while (n >= 8) {
        uint32_t lo;
        std::memcpy(&lo, p, 4);
        lo ^= crc;
        uint32_t hi;
        std::memcpy(&hi, p + 4, 4);
        crc = g_crc.t[7][lo & 0xFF] ^ g_crc.t[6][(lo >> 8) & 0xFF]
            ^ g_crc.t[5][(lo >> 16) & 0xFF] ^ g_crc.t[4][lo >> 24]
            ^ g_crc.t[3][hi & 0xFF] ^ g_crc.t[2][(hi >> 8) & 0xFF]
            ^ g_crc.t[1][(hi >> 16) & 0xFF] ^ g_crc.t[0][hi >> 24];
        p += 8;
        n -= 8;
    }
    while (n-- > 0) crc = (crc >> 8) ^ g_crc.t[0][(crc ^ *p++) & 0xFF];
    return ~crc;
}

const uint32_t ADLER_MOD = 65521;

uint32_t adler32_fast(uint32_t adler, const uint8_t* p, int64_t n) {
    uint32_t a = adler & 0xFFFF, b = adler >> 16;
    while (n > 0) {
        int64_t blk = n > 5552 ? 5552 : n;  // max before b overflows u32
        n -= blk;
        while (blk >= 8) {
            a += p[0]; b += a; a += p[1]; b += a;
            a += p[2]; b += a; a += p[3]; b += a;
            a += p[4]; b += a; a += p[5]; b += a;
            a += p[6]; b += a; a += p[7]; b += a;
            p += 8;
            blk -= 8;
        }
        while (blk-- > 0) { a += *p++; b += a; }
        a %= ADLER_MOD;
        b %= ADLER_MOD;
    }
    return (b << 16) | a;
}

uint32_t adler32_comb(uint32_t a1, uint32_t a2, int64_t len2) {
    // zlib adler32_combine: shift a1's B term by len2 bytes of a2's data
    uint32_t rem = (uint32_t)(len2 % ADLER_MOD);
    uint32_t s1 = a1 & 0xFFFF;
    uint32_t s2 = rem * s1 % ADLER_MOD;
    s1 += (a2 & 0xFFFF) + ADLER_MOD - 1;
    s2 += ((a1 >> 16) & 0xFFFF) + ((a2 >> 16) & 0xFFFF) + ADLER_MOD - rem;
    if (s1 >= ADLER_MOD) s1 -= ADLER_MOD;
    if (s1 >= ADLER_MOD) s1 -= ADLER_MOD;
    if (s2 >= ADLER_MOD << 1) s2 -= ADLER_MOD << 1;
    if (s2 >= ADLER_MOD) s2 -= ADLER_MOD;
    return (s2 << 16) | s1;
}

// ---------------------------------------------------------------------------
// framing (layouts: reference src/qatzip_gzip.c:86-160, 263-344)
// ---------------------------------------------------------------------------
enum Fmt { FMT_4B = 0, FMT_GZIP = 1, FMT_GZIPEXT = 2, FMT_RAW = 3,
           FMT_ZLIB = 4 };

int header_sz(int fmt) {
    switch (fmt) {
    case FMT_4B: return 4;
    case FMT_GZIP: return 10;
    case FMT_GZIPEXT: return 24;
    case FMT_RAW: return 0;
    default: return 2;  // zlib
    }
}

int footer_sz(int fmt) {
    switch (fmt) {
    case FMT_4B: case FMT_RAW: return 0;
    case FMT_ZLIB: return 4;
    default: return 8;  // gzip crc32+isize
    }
}

inline void w32le(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }
inline void w16le(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }

void write_header(uint8_t* p, int fmt, uint32_t src_sz, uint32_t dest_sz) {
    switch (fmt) {
    case FMT_4B:
        w32le(p, dest_sz);
        break;
    case FMT_GZIP:  // 1f 8b 08 00 mtime=0 xfl=0 os=255
        p[0] = 0x1F; p[1] = 0x8B; p[2] = 8; p[3] = 0;
        w32le(p + 4, 0); p[8] = 0; p[9] = 255;
        break;
    case FMT_GZIPEXT:  // FEXTRA, x_len=12, 'QZ', x2_len=8, src_sz, dest_sz
        p[0] = 0x1F; p[1] = 0x8B; p[2] = 8; p[3] = 0x04;
        w32le(p + 4, 0); p[8] = 0; p[9] = 255;
        w16le(p + 10, 12); p[12] = 'Q'; p[13] = 'Z'; w16le(p + 14, 8);
        w32le(p + 16, src_sz); w32le(p + 20, dest_sz);
        break;
    case FMT_ZLIB:
        p[0] = 0x78; p[1] = 0x9C;
        break;
    default:
        break;  // raw: none
    }
}

void write_footer(uint8_t* p, int fmt, uint32_t checksum, uint32_t isize) {
    switch (fmt) {
    case FMT_GZIP: case FMT_GZIPEXT:
        w32le(p, checksum);
        w32le(p + 4, isize);
        break;
    case FMT_ZLIB:  // big-endian adler32
        p[0] = (uint8_t)(checksum >> 24); p[1] = (uint8_t)(checksum >> 16);
        p[2] = (uint8_t)(checksum >> 8); p[3] = (uint8_t)checksum;
        break;
    default:
        break;
    }
}

int pick_threads(int64_t nitems) {
    // QATZIP_TPU_SW_THREADS pins the per-process pool (the reference's
    // NumProcesses x threads tuning, test/performance_tests/run_perf_test.sh)
    if (const char* env = std::getenv("QATZIP_TPU_SW_THREADS")) {
        int v = std::atoi(env);
        if (v >= 1) return v > (int)nitems ? (int)(nitems > 0 ? nitems : 1)
                                           : v;
    }
    unsigned hc = std::thread::hardware_concurrency();
    int t = hc ? (int)hc : 2;
    if ((int64_t)t > nitems) t = (int)nitems;
    return t < 1 ? 1 : t;
}

template <typename Fn>
void run_pool(int nthreads, int64_t nitems, Fn&& body) {
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1, std::memory_order_relaxed);
            if (i >= nitems) return;
            body(i);
        }
    };
    if (nthreads <= 1) { worker(); return; }
    std::vector<std::thread> th;
    th.reserve(nthreads - 1);
    for (int t = 1; t < nthreads; t++) th.emplace_back(worker);
    worker();
    for (auto& t : th) t.join();
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// PCLMULQDQ-folded CRC-32 (IEEE reflected), the Intel folding method with
// the constants of the public derivation (x^544/x^480/x^160/x^96/x^64 mod P
// and the Barrett pair).  Guarded by a startup self-check against the
// table path — on any mismatch or missing ISA the table path is used, so a
// wrong constant can never corrupt a checksum.
// ---------------------------------------------------------------------------
#if defined(__PCLMUL__) && defined(__SSE4_1__)
#include <immintrin.h>
static uint32_t crc32_pclmul(uint32_t crc, const uint8_t* p, int64_t n) {
    if (n < 64) return crc32_sb8(crc, p, n);
    crc = ~crc;
    const __m128i k1k2 = _mm_set_epi64x(0x00000001c6e41596ll,
                                        0x0000000154442bd4ll);
    const __m128i k3k4 = _mm_set_epi64x(0x00000000ccaa009ell,
                                        0x00000001751997d0ll);
    const __m128i k5 = _mm_set_epi64x(0, 0x0000000163cd6124ll);
    const __m128i bpoly = _mm_set_epi64x(0x00000001f7011641ll,   // u'
                                         0x00000001db710641ll);  // P'
    __m128i x1 = _mm_loadu_si128((const __m128i*)(p));
    __m128i x2 = _mm_loadu_si128((const __m128i*)(p + 16));
    __m128i x3 = _mm_loadu_si128((const __m128i*)(p + 32));
    __m128i x4 = _mm_loadu_si128((const __m128i*)(p + 48));
    x1 = _mm_xor_si128(x1, _mm_cvtsi32_si128((int)crc));
    p += 64; n -= 64;
    while (n >= 64) {
        __m128i t;
        t = _mm_clmulepi64_si128(x1, k1k2, 0x00);
        x1 = _mm_clmulepi64_si128(x1, k1k2, 0x11);
        x1 = _mm_xor_si128(x1, t);
        x1 = _mm_xor_si128(x1, _mm_loadu_si128((const __m128i*)p));
        t = _mm_clmulepi64_si128(x2, k1k2, 0x00);
        x2 = _mm_clmulepi64_si128(x2, k1k2, 0x11);
        x2 = _mm_xor_si128(x2, t);
        x2 = _mm_xor_si128(x2, _mm_loadu_si128((const __m128i*)(p + 16)));
        t = _mm_clmulepi64_si128(x3, k1k2, 0x00);
        x3 = _mm_clmulepi64_si128(x3, k1k2, 0x11);
        x3 = _mm_xor_si128(x3, t);
        x3 = _mm_xor_si128(x3, _mm_loadu_si128((const __m128i*)(p + 32)));
        t = _mm_clmulepi64_si128(x4, k1k2, 0x00);
        x4 = _mm_clmulepi64_si128(x4, k1k2, 0x11);
        x4 = _mm_xor_si128(x4, t);
        x4 = _mm_xor_si128(x4, _mm_loadu_si128((const __m128i*)(p + 48)));
        p += 64; n -= 64;
    }
    // fold 4 lanes -> 1
    __m128i t;
    t = _mm_clmulepi64_si128(x1, k3k4, 0x00);
    x1 = _mm_clmulepi64_si128(x1, k3k4, 0x11);
    x1 = _mm_xor_si128(_mm_xor_si128(x1, t), x2);
    t = _mm_clmulepi64_si128(x1, k3k4, 0x00);
    x1 = _mm_clmulepi64_si128(x1, k3k4, 0x11);
    x1 = _mm_xor_si128(_mm_xor_si128(x1, t), x3);
    t = _mm_clmulepi64_si128(x1, k3k4, 0x00);
    x1 = _mm_clmulepi64_si128(x1, k3k4, 0x11);
    x1 = _mm_xor_si128(_mm_xor_si128(x1, t), x4);
    // remaining 16B blocks
    while (n >= 16) {
        t = _mm_clmulepi64_si128(x1, k3k4, 0x00);
        x1 = _mm_clmulepi64_si128(x1, k3k4, 0x11);
        x1 = _mm_xor_si128(x1, t);
        x1 = _mm_xor_si128(x1, _mm_loadu_si128((const __m128i*)p));
        p += 16; n -= 16;
    }
    // fold 128 -> 64
    const __m128i mask32 = _mm_setr_epi32(-1, 0, -1, 0);
    t = _mm_clmulepi64_si128(x1, k3k4, 0x10);
    x1 = _mm_srli_si128(x1, 8);
    x1 = _mm_xor_si128(x1, t);
    t = _mm_srli_si128(x1, 4);
    x1 = _mm_and_si128(x1, mask32);
    x1 = _mm_clmulepi64_si128(x1, k5, 0x00);
    x1 = _mm_xor_si128(x1, t);
    // Barrett reduction to 32 bits
    t = _mm_and_si128(x1, mask32);
    t = _mm_clmulepi64_si128(t, bpoly, 0x10);
    t = _mm_and_si128(t, mask32);
    t = _mm_clmulepi64_si128(t, bpoly, 0x00);
    x1 = _mm_xor_si128(x1, t);
    crc = (uint32_t)_mm_extract_epi32(x1, 1);
    uint32_t out = ~crc;
    if (n > 0) out = crc32_sb8(out, p, n);
    return out;
}

static bool pclmul_selfcheck() {
    uint8_t buf[1024];
    for (int i = 0; i < 1024; i++) buf[i] = (uint8_t)(i * 151 + 13);
    for (int64_t len : {64, 65, 100, 333, 1024}) {
        for (uint32_t seed : {0u, 0xDEADBEEFu}) {
            if (crc32_pclmul(seed, buf, len) != crc32_sb8(seed, buf, len))
                return false;
        }
    }
    return true;
}
static const bool g_pclmul_ok = pclmul_selfcheck();

uint32_t qz_crc32(uint32_t crc, const uint8_t* p, int64_t n) {
    if (g_pclmul_ok) return crc32_pclmul(crc, p, n);
    return crc32_sb8(crc, p, n);
}
#else
uint32_t qz_crc32(uint32_t crc, const uint8_t* p, int64_t n) {
    return crc32_sb8(crc, p, n);
}
#endif

uint32_t qz_adler32(uint32_t adler, const uint8_t* p, int64_t n) {
    return adler32_fast(adler, p, n);
}

uint32_t qz_adler32_combine(uint32_t a1, uint32_t a2, int64_t len2) {
    return adler32_comb(a1, a2, len2);
}

// Generic table-driven CRC (Rocksoft model, width 8..64): serves the
// session-configurable CRC32/CRC64 surface (reference QzCrc32Config_T /
// QzCrc64Config_T, include/qatzip.h:753-787; default CRC64 is ECMA-182
// normal 0x42F0E1EBA9EA3693).
uint64_t qz_crc_generic(const uint8_t* p, int64_t n, uint64_t poly,
                        uint64_t init, int width, int reflect_in,
                        int reflect_out, uint64_t xor_out) {
    const uint64_t mask = width >= 64 ? ~0ull : ((1ull << width) - 1);
    auto reflect = [](uint64_t v, int bits) {
        uint64_t r = 0;
        for (int i = 0; i < bits; i++) { r = (r << 1) | (v & 1); v >>= 1; }
        return r;
    };
    // per-thread table cache keyed by (poly, width, reflect_in)
    struct Cache { uint64_t poly = 0; int width = 0; int refin = -1;
                   uint64_t tab[256]; };
    thread_local Cache c;
    if (c.poly != poly || c.width != width || c.refin != reflect_in) {
        if (reflect_in) {
            uint64_t rp = reflect(poly & mask, width);
            for (uint32_t b = 0; b < 256; b++) {
                uint64_t crc = b;
                for (int k = 0; k < 8; k++)
                    crc = (crc >> 1) ^ (rp & (~(crc & 1) + 1));
                c.tab[b] = crc;
            }
        } else {
            const uint64_t top = 1ull << (width - 1);
            for (uint32_t b = 0; b < 256; b++) {
                uint64_t crc = (uint64_t)b << (width - 8);
                for (int k = 0; k < 8; k++)
                    crc = (crc & top) ? ((crc << 1) ^ poly) & mask
                                      : (crc << 1) & mask;
                c.tab[b] = crc;
            }
        }
        c.poly = poly; c.width = width; c.refin = reflect_in;
    }
    uint64_t crc;
    if (reflect_in) {
        crc = reflect(init & mask, width);
        for (int64_t i = 0; i < n; i++)
            crc = (crc >> 8) ^ c.tab[(crc ^ p[i]) & 0xFF];
        if (!reflect_out) crc = reflect(crc, width);
    } else {
        crc = init & mask;
        for (int64_t i = 0; i < n; i++)
            crc = ((crc << 8) & mask) ^ c.tab[((crc >> (width - 8)) ^ p[i]) & 0xFF];
        if (reflect_out) crc = reflect(crc, width);
    }
    return (crc ^ xor_out) & mask;
}

// Compress src[0..n) as independent chunk_sz members of format `fmt` into
// dst, contiguous and in order.  ck_kind: 0=crc32, 1=adler32.
// slot_sz must be >= header + deflate_bound(chunk_sz) + footer; cap must be
// >= nchunks*slot_sz.  Returns total bytes written, -1 on error.
// *crc_out = block-order combined checksum of the uncompressed input.
int64_t qz_batch_deflate_compress(const uint8_t* src, int64_t n,
                                  int64_t chunk_sz, int level, int fmt,
                                  int ck_kind, uint8_t* dst, int64_t cap,
                                  int64_t slot_sz, uint32_t* crc_out) {
    if (n <= 0 || chunk_sz <= 0) return -1;
    const int64_t nchunks = (n + chunk_sz - 1) / chunk_sz;
    if (nchunks * slot_sz > cap) return -1;
    const int hdr = header_sz(fmt);
    const int ftr = footer_sz(fmt);

    std::vector<int64_t> member_len(nchunks);
    std::vector<uint32_t> crcs(nchunks);
    std::atomic<bool> failed{false};

    run_pool(pick_threads(nchunks), nchunks, [&](int64_t i) {
        if (failed.load(std::memory_order_relaxed)) return;
        const int64_t off = i * chunk_sz;
        const int64_t len = (off + chunk_sz <= n) ? chunk_sz : (n - off);
        uint8_t* slot = dst + i * slot_sz;
        int64_t plen = qz_deflate_compress(src + off, len, slot + hdr,
                                           slot_sz - hdr - ftr, level);
        if (plen < 0) { failed.store(true); return; }
        uint32_t ck = ck_kind == 0 ? qz_crc32(0, src + off, len)
                                   : adler32_fast(1, src + off, len);
        write_header(slot, fmt, (uint32_t)len, (uint32_t)plen);
        write_footer(slot + hdr + plen, fmt, ck, (uint32_t)len);
        member_len[i] = hdr + plen + ftr;
        crcs[i] = ck;
    });
    if (failed.load()) return -1;

    // ordered reassembly: compact members to be contiguous (forward memmove
    // is safe — the write cursor never passes the slot being moved)
    int64_t pos = member_len[0];
    uint32_t comb = crcs[0];
    for (int64_t i = 1; i < nchunks; i++) {
        std::memmove(dst + pos, dst + i * slot_sz, member_len[i]);
        pos += member_len[i];
        const int64_t off = i * chunk_sz;
        const int64_t len = (off + chunk_sz <= n) ? chunk_sz : (n - off);
        comb = ck_kind == 0 ? qz_crc32_combine(comb, crcs[i], len)
                            : adler32_comb(comb, crcs[i], len);
    }
    *crc_out = comb;
    return pos;
}

// Inflate nmemb independent deflate members (framing already parsed by the
// caller) into dst at precomputed output offsets.  hints[i] is the exact
// expected output size (from gzipext/gzip framing); expected[i] is the
// member's framed checksum or -1 to skip verification.
// Returns total output bytes; -1 corrupt; -2 output-size mismatch;
// -3 checksum mismatch.  *crc_out = combined checksum, *last_eof = BFINAL
// flag of the last member (end-of-last-block, reference src/qatzip.c:2352).
int64_t qz_batch_inflate(const uint8_t* comp, const int64_t* offs,
                         const int64_t* plens, const int64_t* out_offs,
                         const int64_t* hints, const int64_t* expected,
                         int64_t nmemb, int ck_kind, uint8_t* dst,
                         uint32_t* crc_out, int32_t* last_eof) {
    if (nmemb <= 0) return -1;
    std::vector<uint32_t> crcs(nmemb);
    std::vector<int32_t> eofs(nmemb);
    std::atomic<int> err{0};

    run_pool(pick_threads(nmemb), nmemb, [&](int64_t i) {
        if (err.load(std::memory_order_relaxed)) return;
        int64_t used = 0;
        int32_t eof = 0;
        int64_t out = qz_inflate(comp + offs[i], plens[i], dst + out_offs[i],
                                 hints[i], &used, &eof);
        if (out < 0) { err.store(1); return; }
        if (out != hints[i]) { err.store(2); return; }
        uint32_t ck = ck_kind == 0 ? qz_crc32(0, dst + out_offs[i], out)
                                   : adler32_fast(1, dst + out_offs[i], out);
        if (expected[i] >= 0 && (uint32_t)expected[i] != ck) {
            err.store(3);
            return;
        }
        crcs[i] = ck;
        eofs[i] = eof;
    });
    int e = err.load();
    if (e) return -e;

    uint32_t comb = crcs[0];
    for (int64_t i = 1; i < nmemb; i++)
        comb = ck_kind == 0 ? qz_crc32_combine(comb, crcs[i], hints[i])
                            : adler32_comb(comb, crcs[i], hints[i]);
    *crc_out = comb;
    *last_eof = eofs[nmemb - 1];
    return out_offs[nmemb - 1] + hints[nmemb - 1];
}

}  // extern "C"
