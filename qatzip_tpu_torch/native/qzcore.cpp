// qzcore: native host-side runtime for qatzip-tpu.
//
// The reference implements its entire host runtime in C; here the
// performance-critical host loops live in C++ behind a C ABI loaded via
// ctypes (qatzip_tpu/native/qzcore.py):
//   - LZ4 block compress/decompress (greedy hash-table match, LZ4 spec)
//   - LZ4s sequence compress/decompress (QAT variant: min-match 3/4, token
//     ML stores matchlen-(mini_match-1); see reference utils/qzstd.c:118-181)
//   - deflate bitstream packer: turns device-produced (symbol,len,dist)
//     token streams into a deflate block (host finisher fallback)
//
// Build: python -m qatzip_tpu_torch.native.build
#include <cstdint>
#include <cstring>
#include <cstdlib>

extern "C" {

// ---------------------------------------------------------------------------
// LZ4 block codec
// ---------------------------------------------------------------------------
static const int MINMATCH = 4;
static const int MFLIMIT = 12;
static const int LASTLITERALS = 5;
static const uint32_t MAX_DISTANCE = 65535;
static const int HASH_LOG = 16;

static inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

static inline uint32_t hash4(uint32_t v) {
    return (v * 2654435761u) >> (32 - HASH_LOG);
}

static inline uint8_t* write_length(uint8_t* op, size_t len) {
    while (len >= 255) { *op++ = 255; len -= 255; }
    *op++ = (uint8_t)len;
    return op;
}

// Generic greedy LZ4-style block compressor.
// mode 0: standard LZ4 (min match 4, token ML = len-4)
// mode 1: LZ4s (min match = mini_match, token ML = len-(mini_match-1),
//          terminal literal-only sequence without offset)
static int64_t lz4_compress_generic(const uint8_t* src, int64_t n,
                                    uint8_t* dst, int64_t cap,
                                    int mode, int mini_match) {
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    if (n == 0) return 0;
    const int token_base = (mode == 0) ? MINMATCH : (mini_match - 1);
    const int min_match = (mode == 0) ? MINMATCH : mini_match;

    auto emit = [&](const uint8_t* lit, size_t lit_len, uint32_t offset,
                    size_t match_len) -> bool {
        size_t ml_code = match_len == 0 ? 0 : match_len - token_base;
        uint8_t tok_lit = lit_len >= 15 ? 15 : (uint8_t)lit_len;
        uint8_t tok_ml = ml_code >= 15 ? 15 : (uint8_t)ml_code;
        size_t need = 1 + lit_len + 16 + (match_len ? 2 : 0);
        if (op + need > oend) return false;
        if (match_len == 0) {
            *op++ = (uint8_t)(tok_lit << 4);
            if (lit_len >= 15) op = write_length(op, lit_len - 15);
            std::memcpy(op, lit, lit_len);
            op += lit_len;
            return true;
        }
        *op++ = (uint8_t)((tok_lit << 4) | tok_ml);
        if (lit_len >= 15) op = write_length(op, lit_len - 15);
        std::memcpy(op, lit, lit_len);
        op += lit_len;
        *op++ = (uint8_t)(offset & 0xFF);
        *op++ = (uint8_t)(offset >> 8);
        if (ml_code >= 15) op = write_length(op, ml_code - 15);
        return true;
    };

    if (n < MFLIMIT + 1) {
        if (!emit(src, n, 0, 0)) return -1;
        return op - dst;
    }

    const int64_t table_size = 1 << HASH_LOG;
    int32_t* table = (int32_t*)std::malloc(table_size * sizeof(int32_t));
    if (!table) return -1;
    std::memset(table, 0xFF, table_size * sizeof(int32_t));

    int64_t anchor = 0, pos = 0;
    const int64_t match_limit = n - LASTLITERALS;
    const int64_t mf_limit = n - MFLIMIT;

    while (pos <= mf_limit) {
        uint32_t seq = read32(src + pos);
        uint32_t h = hash4(seq);
        int32_t cand = table[h];
        table[h] = (int32_t)pos;
        if (cand >= 0 && pos - cand <= MAX_DISTANCE &&
            read32(src + cand) == seq) {
            int64_t mlen = 4;
            while (pos + mlen < match_limit &&
                   src[cand + mlen] == src[pos + mlen])
                mlen++;
            if (mlen >= min_match) {
                if (!emit(src + anchor, pos - anchor,
                          (uint32_t)(pos - cand), (size_t)mlen)) {
                    std::free(table);
                    return -1;
                }
                pos += mlen;
                anchor = pos;
                continue;
            }
        }
        pos++;
    }
    if (!emit(src + anchor, n - anchor, 0, 0)) {
        std::free(table);
        return -1;
    }
    std::free(table);
    return op - dst;
}

int64_t qz_lz4_compress_block(const uint8_t* src, int64_t n, uint8_t* dst,
                              int64_t cap) {
    return lz4_compress_generic(src, n, dst, cap, 0, 4);
}

int64_t qz_lz4s_compress_block(const uint8_t* src, int64_t n, uint8_t* dst,
                               int64_t cap, int mini_match) {
    return lz4_compress_generic(src, n, dst, cap, 1, mini_match);
}

int64_t qz_lz4_decompress_block(const uint8_t* src, int64_t n, uint8_t* dst,
                                int64_t cap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    while (ip < iend) {
        uint32_t token = *ip++;
        size_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > iend || op + lit > oend) return -1;
        std::memcpy(op, ip, lit);
        ip += lit;
        op += lit;
        if (ip >= iend) break;
        if (ip + 2 > iend) return -1;
        uint32_t offset = ip[0] | ((uint32_t)ip[1] << 8);
        ip += 2;
        if (offset == 0 || offset > (uint64_t)(op - dst)) return -1;
        size_t ml = token & 0x0F;
        if (ml == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                ml += b;
            } while (b == 255);
        }
        ml += MINMATCH;
        if (op + ml > oend) return -1;
        const uint8_t* mp = op - offset;
        for (size_t k = 0; k < ml; k++) op[k] = mp[k];  // overlap-safe
        op += ml;
    }
    return op - dst;
}

int64_t qz_lz4s_decompress_block(const uint8_t* src, int64_t n, uint8_t* dst,
                                 int64_t cap, int mini_match) {
    const int base = mini_match - 1;
    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    while (ip < iend) {
        uint32_t token = *ip++;
        size_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > iend || op + lit > oend) return -1;
        std::memcpy(op, ip, lit);
        ip += lit;
        op += lit;
        if (ip >= iend) break;  // terminal literal-only sequence
        if (ip + 2 > iend) return -1;
        uint32_t offset = ip[0] | ((uint32_t)ip[1] << 8);
        ip += 2;
        size_t ml = token & 0x0F;
        if (ml == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                ml += b;
            } while (b == 255);
        }
        if (ml != 0) {
            ml += base;
            if (offset == 0 || offset > (uint64_t)(op - dst)) return -1;
            if (op + ml > oend) return -1;
            const uint8_t* mp = op - offset;
            for (size_t k = 0; k < ml; k++) op[k] = mp[k];
            op += ml;
        }
    }
    return op - dst;
}

// ---------------------------------------------------------------------------
// Deflate host bitstream packer
// ---------------------------------------------------------------------------
// Packs a token stream into deflate bits.  tokens[i]: packed u32
//   literal:  bit31=0, bits 0-7 literal byte
//   match:    bit31=1, bits 0-8 length (3..258), bits 9-23 distance-1
// codes/lens arrays: litlen_code/len[286] (bit-reversed canonical),
// dist_code/len[30].  Returns number of BYTES written, or -1.
int64_t qz_deflate_pack(const uint32_t* tokens, int64_t ntok,
                        const uint16_t* ll_code, const uint8_t* ll_len,
                        const uint16_t* d_code, const uint8_t* d_len,
                        int bfinal, int btype_dynamic_header_bits,
                        const uint8_t* header_bytes, int64_t header_bits,
                        uint8_t* dst, int64_t cap) {
    uint64_t acc = 0;
    int nbits = 0;
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;

    auto put = [&](uint32_t value, int bits) -> bool {
        acc |= ((uint64_t)value) << nbits;
        nbits += bits;
        while (nbits >= 8) {
            if (op >= oend) return false;
            *op++ = (uint8_t)(acc & 0xFF);
            acc >>= 8;
            nbits -= 8;
        }
        return true;
    };

    // 3-bit block header then optional pre-encoded dynamic header bits
    if (!put(bfinal | ((btype_dynamic_header_bits > 0 ? 2u : 1u) << 1), 3))
        return -1;
    for (int64_t i = 0; i < header_bits; i++) {
        uint32_t bit = (header_bytes[i >> 3] >> (i & 7)) & 1;
        if (!put(bit, 1)) return -1;
    }

    static const int LEN_EB[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,
                                   3,3,3,3,4,4,4,4,5,5,5,5,0};
    static const int LEN_BASE[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,
                                     35,43,51,59,67,83,99,115,131,163,195,227,258};
    static const int DIST_EB[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,
                                    9,9,10,10,11,11,12,12,13,13};
    static const int DIST_BASE[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,
                                      193,257,385,513,769,1025,1537,2049,3073,
                                      4097,6145,8193,12289,16385,24577};

    for (int64_t i = 0; i < ntok; i++) {
        uint32_t t = tokens[i];
        if (!(t & 0x80000000u)) {
            uint32_t lit = t & 0xFF;
            if (!put(ll_code[lit], ll_len[lit])) return -1;
        } else {
            uint32_t len = t & 0x1FF;
            uint32_t dist = ((t >> 9) & 0x7FFF) + 1;
            int lc = 28;
            while (lc > 0 && (uint32_t)LEN_BASE[lc] > len) lc--;
            if (len == 258) lc = 28;
            uint32_t sym = 257 + lc;
            if (!put(ll_code[sym], ll_len[sym])) return -1;
            if (LEN_EB[lc] && !put(len - LEN_BASE[lc], LEN_EB[lc])) return -1;
            int dc = 29;
            while (dc > 0 && (uint32_t)DIST_BASE[dc] > dist) dc--;
            if (!put(d_code[dc], d_len[dc])) return -1;
            if (DIST_EB[dc] && !put(dist - DIST_BASE[dc], DIST_EB[dc]))
                return -1;
        }
    }
    if (!put(ll_code[256], ll_len[256])) return -1;  // EOB
    if (nbits > 0) {
        if (op >= oend) return -1;
        *op++ = (uint8_t)(acc & 0xFF);
    }
    return op - dst;
}

// crc32 combine (GF(2) matrix technique, zlib-compatible)
static uint32_t gf2_times(const uint32_t* mat, uint32_t vec) {
    uint32_t s = 0;
    for (int i = 0; vec; i++, vec >>= 1)
        if (vec & 1) s ^= mat[i];
    return s;
}

static void gf2_square(uint32_t* dst, const uint32_t* mat) {
    for (int n = 0; n < 32; n++) dst[n] = gf2_times(mat, mat[n]);
}

// Builds the combined zero-byte-advance operator for len2; chunk lengths
// repeat (hw_buff_sz), so a thread-local single-entry cache makes each
// combine one 32-row matrix-vector product.
static void crc_len_operator(uint32_t* op, int64_t len2) {
    uint32_t even[32], odd[32];
    odd[0] = 0xEDB88320u;
    uint32_t row = 1;
    for (int n = 1; n < 32; n++) { odd[n] = row; row <<= 1; }
    gf2_square(even, odd);
    gf2_square(odd, even);
    for (int n = 0; n < 32; n++) op[n] = 1u << n;  // identity
    uint32_t tmp[32];
    do {
        gf2_square(even, odd);
        if (len2 & 1) {
            for (int n = 0; n < 32; n++) tmp[n] = gf2_times(even, op[n]);
            std::memcpy(op, tmp, sizeof(tmp));
        }
        len2 >>= 1;
        if (!len2) break;
        gf2_square(odd, even);
        if (len2 & 1) {
            for (int n = 0; n < 32; n++) tmp[n] = gf2_times(odd, op[n]);
            std::memcpy(op, tmp, sizeof(tmp));
        }
        len2 >>= 1;
    } while (len2);
}

uint32_t qz_crc32_combine(uint32_t crc1, uint32_t crc2, int64_t len2) {
    if (len2 <= 0) return crc1;
    static thread_local int64_t cached_len = -1;
    static thread_local uint32_t cached_op[32];
    if (len2 != cached_len) {
        crc_len_operator(cached_op, len2);
        cached_len = len2;
    }
    return gf2_times(cached_op, crc1) ^ crc2;
}

// XXH32 (xxHash, public-domain algorithm re-implemented from the spec) —
// the vendored-hash role of the reference's src/xxhash.c (used for LZ4
// frame header/content checksums, src/qatzip_lz4.c:130).
static inline uint32_t xxh_rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

uint32_t qz_xxh32(const uint8_t* p, int64_t len, uint32_t seed) {
    static const uint32_t P1 = 2654435761U, P2 = 2246822519U,
                          P3 = 3266489917U, P4 = 668265263U, P5 = 374761393U;
    const uint8_t* end = p + len;
    uint32_t h;
    if (len >= 16) {
        uint32_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed,
                 v4 = seed - P1;
        const uint8_t* limit = end - 16;
        do {
            v1 = xxh_rotl32(v1 + read32(p) * P2, 13) * P1; p += 4;
            v2 = xxh_rotl32(v2 + read32(p) * P2, 13) * P1; p += 4;
            v3 = xxh_rotl32(v3 + read32(p) * P2, 13) * P1; p += 4;
            v4 = xxh_rotl32(v4 + read32(p) * P2, 13) * P1; p += 4;
        } while (p <= limit);
        h = xxh_rotl32(v1, 1) + xxh_rotl32(v2, 7) + xxh_rotl32(v3, 12)
            + xxh_rotl32(v4, 18);
    } else {
        h = seed + P5;
    }
    h += (uint32_t)len;
    while (p + 4 <= end) {
        h = xxh_rotl32(h + read32(p) * P3, 17) * P4;
        p += 4;
    }
    while (p < end) {
        h = xxh_rotl32(h + (*p++) * P5, 11) * P1;
    }
    h ^= h >> 15; h *= P2; h ^= h >> 13; h *= P3; h ^= h >> 16;
    return h;
}

uint64_t qz_xxh64(const uint8_t* p, int64_t len, uint64_t seed) {
    static const uint64_t P1 = 11400714785074694791ULL,
                          P2 = 14029467366897019727ULL,
                          P3 = 1609587929392839161ULL,
                          P4 = 9650029242287828579ULL,
                          P5 = 2870177450012600261ULL;
    auto rotl64 = [](uint64_t x, int r) {
        return (x << r) | (x >> (64 - r));
    };
    auto read64 = [](const uint8_t* q) {
        uint64_t v;
        std::memcpy(&v, q, 8);
        return v;
    };
    auto round64 = [&](uint64_t acc, uint64_t input) {
        return rotl64(acc + input * P2, 31) * P1;
    };
    const uint8_t* end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed,
                 v4 = seed - P1;
        const uint8_t* limit = end - 32;
        do {
            v1 = round64(v1, read64(p)); p += 8;
            v2 = round64(v2, read64(p)); p += 8;
            v3 = round64(v3, read64(p)); p += 8;
            v4 = round64(v4, read64(p)); p += 8;
        } while (p <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        h = (h ^ round64(0, v1)) * P1 + P4;
        h = (h ^ round64(0, v2)) * P1 + P4;
        h = (h ^ round64(0, v3)) * P1 + P4;
        h = (h ^ round64(0, v4)) * P1 + P4;
    } else {
        h = seed + P5;
    }
    h += (uint64_t)len;
    while (p + 8 <= end) {
        h = rotl64(h ^ round64(0, read64(p)), 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        h = rotl64(h ^ ((uint64_t)read32(p) * P1), 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h = rotl64(h ^ ((*p++) * P5), 11) * P1;
    }
    h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
    return h;
}

// Assemble an LZ4/LZ4s block from the device match-finder's per-position
// records: rec[p] = (match_len << 15) | dist, nonzero only where the
// device's greedy parse selected a match start.  The host walk replays the
// parse chain (pos += match_len or 1) and emits the byte stream — the
// device does the expensive search, the host only shuffles bytes (the
// split mirrors the deflate pipeline's host Huffman-build stage).
// mode 0 = LZ4, 1 = LZ4s (terminal literal-only sequence).
// Hybrid path: device candidate distances (ops/match_finder.py) ->
// host verify/extend/parse -> LZ4 (mode 0) / LZ4s (mode 1) block bytes.
// Mirrors the greedy single-probe host compressors (engine/lz4_block.py):
// matches start only while pos <= n-12 (MFLIMIT), never extend into the
// final 5 bytes (LASTLITERALS), min match 4.
int64_t qz_lz4_candidates(const uint8_t* src, int64_t n, const uint16_t* cand,
                          uint8_t* dst, int64_t cap, int mode,
                          int mini_match) {
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    const int token_base = (mode == 0) ? MINMATCH : (mini_match - 1);
    if (n == 0) return 0;

    auto emit = [&](const uint8_t* lit, size_t lit_len, uint32_t offset,
                    size_t match_len) -> bool {
        size_t ml_code = match_len == 0 ? 0 : match_len - token_base;
        uint8_t tok_lit = lit_len >= 15 ? 15 : (uint8_t)lit_len;
        uint8_t tok_ml = ml_code >= 15 ? 15 : (uint8_t)ml_code;
        size_t need = 1 + lit_len + 16 + (match_len ? 2 : 0)
                      + ml_code / 255 + lit_len / 255;
        if (op + need > oend) return false;
        if (match_len == 0) {
            *op++ = (uint8_t)(tok_lit << 4);
            if (lit_len >= 15) op = write_length(op, lit_len - 15);
            std::memcpy(op, lit, lit_len);
            op += lit_len;
            return true;
        }
        *op++ = (uint8_t)((tok_lit << 4) | tok_ml);
        if (lit_len >= 15) op = write_length(op, lit_len - 15);
        std::memcpy(op, lit, lit_len);
        op += lit_len;
        *op++ = (uint8_t)(offset & 0xFF);
        *op++ = (uint8_t)(offset >> 8);
        if (ml_code >= 15) op = write_length(op, ml_code - 15);
        return true;
    };

    const int64_t mf_limit = n - 12;      // no match may start past this
    const int64_t match_limit = n - 5;    // matches never reach the tail
    int64_t anchor = 0, pos = 0;
    auto probe = [&](int64_t p, uint32_t d) -> int64_t {
        if (d == 0 || (int64_t)d > p) return 0;
        const uint8_t* a = src + p;
        const uint8_t* b = src + p - d;
        int64_t maxl = match_limit - p;
        int64_t l = 0;
        while (l < maxl && a[l] == b[l]) l++;
        return l;
    };
    while (pos <= mf_limit) {
        // two-sided neighbour probes (like qz_deflate_candidates):
        // candidates at pos-1/pos+1 often stay aligned one byte off,
        // recovering coverage when the device indexes sparsely
        uint32_t d = cand[pos];
        int64_t l = probe(pos, d);
        uint32_t d2 = pos > 0 ? cand[pos - 1] : 0;
        if (d2 && d2 != d) {
            int64_t l2 = probe(pos, d2);
            if (l2 > l) { l = l2; d = d2; }
        }
        uint32_t d3 = pos + 1 <= mf_limit ? cand[pos + 1] : 0;
        if (d3 && d3 != d && d3 != d2) {
            int64_t l3 = probe(pos, d3);
            if (l3 > l) { l = l3; d = d3; }
        }
        if (l >= MINMATCH) {
            if (!emit(src + anchor, (size_t)(pos - anchor), d, (size_t)l))
                return -1;
            pos += l;
            anchor = pos;
            continue;
        }
        pos++;
    }
    if (!emit(src + anchor, (size_t)(n - anchor), 0, 0)) return -1;
    return op - dst;
}

int64_t qz_lz4_assemble(const uint8_t* src, int64_t n, const int32_t* rec,
                        uint8_t* dst, int64_t cap, int mode,
                        int mini_match) {
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    const int token_base = (mode == 0) ? MINMATCH : (mini_match - 1);
    const int min_match = (mode == 0) ? MINMATCH : mini_match;
    if (n == 0) return 0;

    auto emit = [&](const uint8_t* lit, size_t lit_len, uint32_t offset,
                    size_t match_len) -> bool {
        size_t ml_code = match_len == 0 ? 0 : match_len - token_base;
        uint8_t tok_lit = lit_len >= 15 ? 15 : (uint8_t)lit_len;
        uint8_t tok_ml = ml_code >= 15 ? 15 : (uint8_t)ml_code;
        size_t need = 1 + lit_len + 16 + (match_len ? 2 : 0);
        if (op + need > oend) return false;
        if (match_len == 0) {
            *op++ = (uint8_t)(tok_lit << 4);
            if (lit_len >= 15) op = write_length(op, lit_len - 15);
            std::memcpy(op, lit, lit_len);
            op += lit_len;
            return true;
        }
        *op++ = (uint8_t)((tok_lit << 4) | tok_ml);
        if (lit_len >= 15) op = write_length(op, lit_len - 15);
        std::memcpy(op, lit, lit_len);
        op += lit_len;
        *op++ = (uint8_t)(offset & 0xFF);
        *op++ = (uint8_t)(offset >> 8);
        if (ml_code >= 15) op = write_length(op, ml_code - 15);
        return true;
    };

    int64_t anchor = 0, pos = 0;
    while (pos < n) {
        int32_t r = rec[pos];
        int32_t ml = r >> 15;
        if (ml >= min_match && pos + ml <= n) {
            if (!emit(src + anchor, (size_t)(pos - anchor),
                      (uint32_t)(r & 0x7FFF), (size_t)ml))
                return -1;
            pos += ml;
            anchor = pos;
        } else {
            pos++;
        }
    }
    if (!emit(src + anchor, (size_t)(n - anchor), 0, 0)) return -1;
    return op - dst;
}

// ---------------------------------------------------------------------------
// Token applier for the Pallas lockstep inflate (ops/pallas_inflate.py).
//
// The device decodes the Huffman/entropy half of DEFLATE in lockstep across
// blocks and emits one fixed-width token per (step, lane):
//   0                      : inactive (lane finished / padding)
//   bit0=1                 : literal, byte in bits 1..8
//   bit0=0, bit1=1         : match, len(3..258) in bits 2..10,
//                            dist-1 (0..32767) in bits 11..25
// This routine is the host half (the LZ77 window-copy engine the QAT ASIC
// has dedicated silicon for, reference src/qatzip.c:2103-2355): applies one
// lane's token column (stride = lane count) into dst with the 32KB history
// window for cross-round back-references.  Returns produced length, or
// -1 dist underrun / -2 overflow / -3 bad token.
// ---------------------------------------------------------------------------
static inline int64_t apply_one_token(uint32_t t, uint8_t* dst, int64_t pos,
                                      int64_t cap, const uint8_t* window,
                                      int64_t wlen) {
    // returns new pos, or negative error
    if (t & 1u) {
        if (pos >= cap) return -2;
        dst[pos++] = (uint8_t)((t >> 1) & 0xFF);
        if (t & 0x200u) {  // paired second literal (decoder bit 9 + 10..17)
            if (pos >= cap) return -2;
            dst[pos++] = (uint8_t)((t >> 10) & 0xFF);
        }
        return pos;
    }
    if (!(t & 2u)) return -3;
    int64_t len = (int64_t)((t >> 2) & 0x1FF);
    int64_t dist = (int64_t)((t >> 11) & 0x7FFF) + 1;
    if (len < 3 || len > 258) return -3;
    if (pos + len > cap) return -2;
    if (dist <= pos) {
        const uint8_t* srcp = dst + pos - dist;
        uint8_t* dp = dst + pos;
        if (dist >= 8) {
            int64_t k = 0;
            for (; k + 8 <= len; k += 8) std::memcpy(dp + k, srcp + k, 8);
            for (; k < len; k++) dp[k] = srcp[k];
        } else {
            for (int64_t k = 0; k < len; k++) dp[k] = srcp[k];
        }
        return pos + len;
    }
    // reaches into the history window from previous rounds
    int64_t from_win = dist - pos;
    if (from_win > wlen) return -1;
    const uint8_t* wp = window + wlen - from_win;
    int64_t take = from_win < len ? from_win : len;
    std::memcpy(dst + pos, wp, (size_t)take);
    pos += take;
    int64_t rem = len - take;
    if (rem > 0) {
        // remainder wraps into the produced output (dist == pos now)
        const uint8_t* srcp = dst + pos - dist;
        uint8_t* dp = dst + pos;
        for (int64_t k = 0; k < rem; k++) dp[k] = srcp[k];
        pos += rem;
    }
    return pos;
}

int64_t qz_apply_tokens(const uint32_t* toks, int64_t nsteps, int64_t stride,
                        const uint8_t* window, int64_t wlen,
                        uint8_t* dst, int64_t cap) {
    int64_t pos = 0;
    for (int64_t s = 0; s < nsteps; s++) {
        uint32_t t = toks[s * stride];
        if (t == 0) continue;
        pos = apply_one_token(t, dst, pos, cap, window, wlen);
        if (pos < 0) return pos;
    }
    return pos;
}

// Tiled layout from the Pallas driver: tokens u32[NT, B, TILE]; one lane's
// tokens are contiguous within each tile row.  toks points at tile 0 of the
// lane (base + lane*TILE); tile_stride = B*TILE.

}  // extern "C"
