// The host half of a lockstep inflate round: every lane's tokens applied,
// and its running checksum carried, in one call.
//
// The device leaves tokens u32[nsteps, lanes] (ops/inflate.py's format,
// qz_apply_tokens' rules in qzcore.cpp).  Each lane writes into its own
// stream's output buffer at the stream's cursor; the up to 32 KB before
// the cursor are the lane's history window, so a match that reaches back
// past this round's output reads the stream's earlier bytes in place.  A
// match is refused where it reaches before the stream's first byte, which
// is qz_apply_tokens' window underrun for a window that is the last 32 KB
// of the stream's output.
//
// Order: the lanes go by groups of 16, one 64-byte line of a token row,
// and a group's steps in turn.  Every line of the matrix is read once and
// whole, where a lane's column walk reads 4 bytes of a line; the group's
// 16 output buffers stay in cache.  A lane is read to the last step,
// padding included, so that a token past the lane's count fails it as
// qz_apply_tokens fails it; a line of zeros costs one test.
//
// One thread, no static state: client threads call this at once, outside
// the interpreter lock.
#include <cstdint>
#include <cstring>

extern "C" {
uint32_t qz_crc32(uint32_t crc, const uint8_t* p, int64_t n);
uint32_t qz_adler32(uint32_t adler, const uint8_t* p, int64_t n);
}

namespace {

constexpr int64_t kGroup = 16;   // lanes a 64-byte line of a token row

// qz_apply_tokens' statuses, and one of this call
enum : int32_t {
    kOk = 0,
    kUnderrun = -1,   // a match reaches before the stream's first byte
    kOverflow = -2,   // past the lane's count, or its buffer
    kBadToken = -3,   // neither a literal nor a match of 3..258
    kShort = -4,      // the tokens put out fewer bytes than the count
};

enum : int32_t { kNone = 0, kCrc32 = 1, kAdler32 = 2 };

// One token at pos of buf, up to end: the new pos, or a negative status.
// The same rules, in the same order, as qzcore.cpp's apply_one_token.  A
// copy goes by whole 8- or 16-byte words where the buffer, `cap` bytes
// long, has room for the last word's overrun: the bytes past the copy are
// the lane's future output, each written again before it is read.
inline int64_t apply_token(uint32_t t, uint8_t* buf, int64_t pos,
                           int64_t end, int64_t cap) {
    if (t & 1u) {
        if (pos >= end) return kOverflow;
        buf[pos++] = static_cast<uint8_t>((t >> 1) & 0xFF);
        if (t & 0x200u) {   // paired second literal
            if (pos >= end) return kOverflow;
            buf[pos++] = static_cast<uint8_t>((t >> 10) & 0xFF);
        }
        return pos;
    }
    if (!(t & 2u)) return kBadToken;
    const int64_t len = (t >> 2) & 0x1FF;
    const int64_t dist = static_cast<int64_t>((t >> 11) & 0x7FFF) + 1;
    if (len < 3 || len > 258) return kBadToken;
    if (pos + len > end) return kOverflow;
    if (dist > pos) return kUnderrun;
    const uint8_t* src = buf + pos - dist;
    uint8_t* dp = buf + pos;
    const bool room = pos + len + 16 <= cap;
    if (dist == 1) {
        std::memset(dp, *src, static_cast<size_t>(len));
    } else if (dist >= 16 && room) {
        for (int64_t k = 0; k < len; k += 16)
            std::memcpy(dp + k, src + k, 16);
    } else if (dist >= 8 && room) {
        for (int64_t k = 0; k < len; k += 8) std::memcpy(dp + k, src + k, 8);
    } else if (dist >= 8) {
        int64_t k = 0;
        for (; k + 8 <= len; k += 8) std::memcpy(dp + k, src + k, 8);
        for (; k < len; k++) dp[k] = src[k];
    } else {
        for (int64_t k = 0; k < len; k++) dp[k] = src[k];
    }
    return pos + len;
}

inline bool zero_line(const uint32_t* row, int64_t n) {
    if (n == kGroup) {
        uint64_t w[kGroup / 2];
        std::memcpy(w, row, sizeof(w));
        uint64_t any = 0;
        for (uint64_t v : w) any |= v;
        return any == 0;
    }
    for (int64_t k = 0; k < n; k++)
        if (row[k]) return false;
    return true;
}

}  // namespace

extern "C" {

// Apply a round's tokens to its lanes.  Per lane l:
//   bufs[l]    the stream's output buffer, cap[l] bytes long;
//   pos[l]     its cursor (the bytes already out), advanced by outcnt[l]
//              where the lane succeeds;
//   outcnt[l]  the bytes the device counted for the lane this round;
//   ck[l]      the running checksum of the stream's bytes before the
//              cursor, advanced over the new bytes by `kind` (0 none,
//              1 CRC-32, 2 Adler-32) where the lane succeeds;
//   status[l]  in: nonzero to leave the lane alone (the caller failed it);
//              out: 0, or kUnderrun, kOverflow, kBadToken or kShort.
// A failed lane's buffer past its cursor holds nothing of use.
void qz_apply_round(const uint32_t* toks, int64_t nsteps, int64_t lanes,
                    uint8_t* const* bufs, int64_t* pos, const int64_t* cap,
                    const int64_t* outcnt, uint32_t* ck, int32_t kind,
                    int32_t* status) {
    for (int64_t g = 0; g < lanes; g += kGroup) {
        const int64_t n = lanes - g < kGroup ? lanes - g : kGroup;
        uint8_t* buf[kGroup];
        int64_t cur[kGroup], end[kGroup], room[kGroup];
        int32_t st[kGroup];
        for (int64_t k = 0; k < n; k++) {
            const int64_t l = g + k;
            buf[k] = bufs[l];
            cur[k] = pos[l];
            end[k] = pos[l] + outcnt[l];
            room[k] = cap[l];
            st[k] = status[l];
            if (st[k] == kOk && (outcnt[l] < 0 || end[k] > cap[l]))
                st[k] = kOverflow;
        }
        for (int64_t s = 0; s < nsteps; s++) {
            const uint32_t* row = toks + s * lanes + g;
            if (zero_line(row, n)) continue;
            for (int64_t k = 0; k < n; k++) {
                const uint32_t t = row[k];
                if (t == 0 || st[k] != kOk) continue;
                const int64_t p = apply_token(t, buf[k], cur[k], end[k],
                                              room[k]);
                if (p < 0) st[k] = static_cast<int32_t>(p);
                else cur[k] = p;
            }
        }
        for (int64_t k = 0; k < n; k++) {
            const int64_t l = g + k;
            if (status[l] != kOk) continue;   // the caller's
            if (st[k] == kOk && cur[k] != end[k]) st[k] = kShort;
            status[l] = st[k];
            if (st[k] != kOk) continue;
            const uint8_t* fresh = buf[k] + pos[l];
            if (kind == kCrc32) ck[l] = qz_crc32(ck[l], fresh, outcnt[l]);
            else if (kind == kAdler32)
                ck[l] = qz_adler32(ck[l], fresh, outcnt[l]);
            pos[l] = cur[k];
        }
    }
}

}  // extern "C"
