// Block headers of the lockstep inflate, a round's lanes in one call.
//
// The same parse as the reference's _parse_one_header and
// parse_dynamic_header (qatzip_tpu/ops/deflate_decode.py; RFC1951
// 3.2.3-3.2.7), which the tests hold it against header for header: the
// same kind, BFINAL, code lengths and end bit, and a reject wherever the
// reference raises, each reject the status of the exception it raises.
// As there, HLIT (257-288) and HDIST (1-32) pass unchecked: the region
// builder judges symbols 286/287 and 30/31.  The code-length code is
// decoded a bit at a time by (length, code) from its canonical codes, the
// shortest match first; a code past its length's space matches nothing.
//
// A lane's code lengths go to its row of `rows` in the layout
// qz_inflate_regions takes.  All state is on the stack: client threads
// call this at once, outside the interpreter lock.
#include <cstdint>
#include <cstring>

namespace {

constexpr int kRow = 320;      // 288 litlen + 32 distance lengths at most
constexpr int kClLen = 7;      // a code-length code's longest code
constexpr int kMaxCode = 15;   // the reference's longest read for one

// lane kinds, and the rejects: each the exception the reference raises
enum : int32_t {
    kStored = 0,
    kStatic = 1,
    kDynamic = 2,
    kTruncated = -1,        // EOFError: a read past the payload
    kBadCode = -2,          // ValueError: no code-length code in 15 bits
    kNoPrevious = -3,       // ValueError: repeat with no previous length
    kOverrun = -4,          // ValueError: code-length overrun
    kStoredShort = -5,      // EOFError: truncated stored block
    kStoredMismatch = -6,   // ValueError: stored block LEN/NLEN mismatch
    kStoredData = -7,       // EOFError: truncated stored block data
    kReserved = -8,         // ValueError: reserved BTYPE
};

constexpr int kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                              11, 4, 12, 3, 13, 2, 14, 1, 15};

// LSB-first bit reader (RFC1951 3.1.1); a read of n (0..7) bits past the
// payload fails, as the reference's, and moves nothing
struct Bits {
    const uint8_t* p;
    int64_t nbits;
    int64_t pos;

    bool read(int n, uint32_t& v) {
        if (pos + n > nbits) return false;
        int64_t b = pos >> 3;
        int sh = int(pos & 7);
        uint32_t w = p[b];
        if (sh + n > 8) w |= uint32_t(p[b + 1]) << 8;
        v = (w >> sh) & ((1u << n) - 1);
        pos += n;
        return true;
    }
};

// The code-length section of a BTYPE=10 header into row[0..hlit+hdist)
int32_t parse_dynamic(Bits& br, int32_t* row, int32_t& nll, int32_t& nd) {
    uint32_t hlit, hdist, hclen, v;
    if (!br.read(5, hlit) || !br.read(5, hdist) || !br.read(4, hclen))
        return kTruncated;
    hlit += 257;
    hdist += 1;
    hclen += 4;
    int cl[19] = {0};
    for (uint32_t i = 0; i < hclen; i++) {
        if (!br.read(3, v)) return kTruncated;
        cl[kClOrder[i]] = int(v);
    }

    // canonical codes (RFC1951 3.2.2); dec[len][code] the symbol, the
    // higher one where two share a key, as the reference's dict keeps it
    int count[kClLen + 1] = {0};
    for (int s = 0; s < 19; s++) count[cl[s]]++;
    count[0] = 0;
    uint32_t next[kClLen + 1] = {0};
    for (int l = 1, code = 0; l <= kClLen; l++) {
        code = (code + count[l - 1]) << 1;
        next[l] = uint32_t(code);
    }
    int8_t dec[kClLen + 1][1 << kClLen];
    std::memset(dec, -1, sizeof dec);
    for (int s = 0; s < 19; s++) {
        int l = cl[s];
        if (l == 0) continue;
        uint32_t code = next[l]++;
        if (code < (1u << l)) dec[l][code] = int8_t(s);
    }

    const int n = int(hlit + hdist);
    std::memset(row, 0, kRow * sizeof(int32_t));
    int i = 0;
    while (i < n) {
        uint32_t code = 0;
        int sym = -1;
        for (int len = 1; sym < 0; len++) {
            if (!br.read(1, v)) return kTruncated;
            code = (code << 1) | v;
            if (len > kMaxCode) return kBadCode;
            if (len <= kClLen) sym = dec[len][code];
        }
        if (sym < 16) {
            row[i++] = sym;
        } else if (sym == 16) {
            if (i == 0) return kNoPrevious;
            if (!br.read(2, v)) return kTruncated;
            int end = i + 3 + int(v);
            for (int32_t prev = row[i - 1]; i < end && i < n; i++)
                row[i] = prev;
            i = end;
        } else if (sym == 17) {
            if (!br.read(3, v)) return kTruncated;
            i += 3 + int(v);
        } else {
            if (!br.read(7, v)) return kTruncated;
            i += 11 + int(v);
        }
    }
    if (i != n) return kOverrun;
    nll = int32_t(hlit);
    nd = int32_t(hdist);
    return kDynamic;
}

// A BTYPE=00 block: its data's place in the payload, the reader past it
int32_t parse_stored(Bits& br, int64_t& off, int64_t& len) {
    int64_t b = ((br.pos + 7) & ~int64_t(7)) >> 3;
    int64_t nbytes = br.nbits >> 3;
    if (b + 4 > nbytes) return kStoredShort;
    uint32_t ln = br.p[b] | (uint32_t(br.p[b + 1]) << 8);
    uint32_t nlen = br.p[b + 2] | (uint32_t(br.p[b + 3]) << 8);
    if (ln != (~nlen & 0xFFFFu)) return kStoredMismatch;
    if (b + 4 + ln > nbytes) return kStoredData;
    off = b + 4;
    len = ln;
    br.pos = (b + 4 + ln) << 3;
    return kStored;
}

}  // namespace

extern "C" {

// Parse the block header at lane i's bit position pos[i] in its payload
// (addrs[i], nbytes[i] bytes).  kind[i] is set to 0 (stored), 1 (static),
// 2 (dynamic) or a negative reject; final[i] to its BFINAL.  A dynamic
// block writes row i of `rows` (int32[lanes][320]): nll[i] litlen lengths,
// then nd[i] distance lengths; every other lane gets nll[i] = -1 (the
// lane qz_inflate_regions skips), nd[i] = 0.  A stored block gives its
// data's byte offset off[i] and length len[i].  A lane that parses has
// pos[i] moved past its header, and past a stored block's data; a
// rejected one keeps it.  Returns the number of rejected lanes.
int64_t qz_inflate_headers(const uint64_t* addrs, const int64_t* nbytes,
                           int64_t* pos, int64_t lanes, int32_t* rows,
                           int32_t* nll, int32_t* nd, int32_t* kind,
                           int32_t* final, int64_t* off, int64_t* len) {
    int64_t bad = 0;
    for (int64_t i = 0; i < lanes; i++) {
        Bits br{reinterpret_cast<const uint8_t*>(addrs[i]), nbytes[i] * 8,
                pos[i]};
        nll[i] = -1;
        nd[i] = 0;
        off[i] = len[i] = 0;
        final[i] = 0;
        uint32_t bfinal, btype;
        int32_t k;
        if (!br.read(1, bfinal) || !br.read(2, btype)) {
            k = kTruncated;
        } else {
            final[i] = int32_t(bfinal);
            if (btype == 0)
                k = parse_stored(br, off[i], len[i]);
            else if (btype == 1)
                k = kStatic;
            else if (btype == 2)
                k = parse_dynamic(br, rows + i * kRow, nll[i], nd[i]);
            else
                k = kReserved;
        }
        kind[i] = k;
        if (k >= 0)
            pos[i] = br.pos;
        else
            bad++;
    }
    return bad;
}

}  // extern "C"
