// Packed two-level table regions of the lockstep inflate, a round's lanes
// in one call.
//
// The same function as the reference's numpy region builders
// (qatzip_tpu/ops/pallas_inflate.py, at its 9-bit roots), which the tests
// hold it against byte for byte.  Per lane a litlen and a distance region
// of 512 u32 cells, seen here as 1024 little-endian u16 entries: 0..511
// the 9-bit root, 512..1023 the subtable area.
//
//   litlen u16:  clen[0:4] kind[4:6] payload[6:14]
//      kind 0 literal (payload = byte), 1 length (payload = symbol - 257),
//      2 EOB, 3 subptr (clen field = subbits, payload = sub offset / 2)
//   dist u16:    clen[0:4] kind 0 payload[6:11] = symbol
//   0 = invalid: symbols 286/287 and distance 30/31 take code space but
//       decode to 0, so the lane errors as RFC1951 asks.
//
// A long code's clen field holds its full length.  Subtables are given out
// from root slots in ascending order (numpy.unique's), each sized by the
// longest code under its slot.  All state is on the stack: client threads
// call this at once, outside the interpreter lock.
#include <cstdint>
#include <cstring>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "u16 entries are packed two a u32 cell, low half first");

namespace {

constexpr int kRootBits = 9;
constexpr int kRoot = 1 << kRootBits;   // root entries
constexpr int kSub = 512;               // subtable-area entries
constexpr int kMaxLen = 15;

// statuses; each nonzero one is a ValueError of the numpy builder
enum : int32_t {
    kOk = 0,
    kOversubscribed = 1,   // a canonical code does not fit its length
    kSubOverflow = 2,      // the subtables need more than kSub entries
    kCollision = 3,        // a long code's root slot is taken
    kBadLength = 4,        // a length outside 0..15 (no DEFLATE stream has one)
};

struct Rev8 {
    uint8_t t[256];
    constexpr Rev8() : t() {
        for (int v = 0; v < 256; v++)
            for (int i = 0; i < 8; i++)
                t[v] |= uint8_t(((v >> i) & 1) << (7 - i));
    }
};
constexpr Rev8 kRev8;

// the low `len` (1..15) bits of v, reversed
inline uint32_t bitrev(uint32_t v, int len) {
    uint32_t r = (uint32_t(kRev8.t[v & 0xFF]) << 8) | kRev8.t[(v >> 8) & 0xFF];
    return r >> (16 - len);
}

inline uint16_t ll_entry(int64_t sym, int len) {
    if (len == 0 || sym >= 286) return 0;
    if (sym < 256) return uint16_t((sym << 6) | len);
    if (sym == 256) return uint16_t((2 << 4) | len);
    return uint16_t((1 << 4) | ((sym - 257) << 6) | len);
}

inline uint16_t d_entry(int64_t sym, int len) {
    if (len == 0 || sym >= 30) return 0;
    return uint16_t((sym << 6) | len);
}

// next_code[l]: the first canonical code of length l (RFC1951 3.2.2)
void first_codes(const int32_t* lens, int64_t n, uint64_t next_code[16]) {
    uint64_t count[16] = {0};
    for (int64_t s = 0; s < n; s++) count[lens[s]]++;
    count[0] = 0;
    uint64_t code = 0;
    next_code[0] = 0;
    for (int l = 1; l <= kMaxLen; l++) {
        code = (code + count[l - 1]) << 1;
        next_code[l] = code;
    }
}

// One region into out[1024] (zeroed here).  Returns a status.
int32_t build_region(const int32_t* lens, int64_t n, bool litlen,
                     uint16_t* out) {
    for (int64_t s = 0; s < n; s++)
        if (lens[s] < 0 || lens[s] > kMaxLen) return kBadLength;
    uint16_t* root = out;
    uint16_t* sub = out + kRoot;
    std::memset(out, 0, (kRoot + kSub) * sizeof(uint16_t));

    // the short codes fill the root; the long ones set their slot's size
    uint64_t next_code[16];
    first_codes(lens, n, next_code);
    uint8_t slot_len[kRoot] = {0};
    for (int64_t s = 0; s < n; s++) {
        int len = lens[s];
        if (len == 0) continue;
        uint64_t code = next_code[len]++;
        if (code >> len) return kOversubscribed;
        uint32_t rc = bitrev(uint32_t(code), len);
        if (len <= kRootBits) {
            uint16_t e = litlen ? ll_entry(s, len) : d_entry(s, len);
            for (uint32_t f = 0; f < (1u << (kRootBits - len)); f++)
                root[rc | (f << len)] = e;
        } else {
            uint32_t slot = rc & (kRoot - 1);
            if (slot_len[slot] < len) slot_len[slot] = uint8_t(len);
        }
    }

    // subtables from the slots in ascending order
    uint16_t slot_base[kRoot];
    int next_free = 0;
    for (int slot = 0; slot < kRoot; slot++) {
        if (slot_len[slot] == 0) continue;
        int subbits = slot_len[slot] - kRootBits;
        if (next_free + (1 << subbits) > kSub) return kSubOverflow;
        if (root[slot] != 0) return kCollision;
        root[slot] = uint16_t(subbits | (3 << 4) | ((next_free >> 1) << 6));
        slot_base[slot] = uint16_t(next_free);
        next_free += 1 << subbits;
    }
    if (next_free == 0) return kOk;

    // the long codes fill their subtables
    first_codes(lens, n, next_code);
    for (int64_t s = 0; s < n; s++) {
        int len = lens[s];
        if (len == 0) continue;
        uint64_t code = next_code[len]++;
        if (len <= kRootBits) continue;
        uint32_t rc = bitrev(uint32_t(code), len);
        uint32_t slot = rc & (kRoot - 1);
        int subbits = slot_len[slot] - kRootBits;
        int step = len - kRootBits;
        uint16_t e = litlen ? ll_entry(s, len) : d_entry(s, len);
        uint16_t* t = sub + slot_base[slot];
        for (uint32_t f = 0; f < (1u << (subbits - step)); f++)
            t[(rc >> kRootBits) | (f << step)] = e;
    }
    return kOk;
}

}  // namespace

extern "C" {

// Build the litlen and distance regions of `lanes` lanes.  Lane i's code
// lengths are row i of `lens` (row width `stride`): nll[i] litlen lengths,
// then nd[i] distance lengths.  A lane with nll[i] < 0 is skipped, its
// rows and status left as they are (the caller fills static blocks' rows).
// tll / td: u32[lanes][512] cells, seen as u16 pairs.  status[i] is set to
// 0 or to the reason the lane cannot be decoded on the device; its rows
// then hold nothing of use.  Returns the number of such lanes.
int64_t qz_inflate_regions(const int32_t* lens, int64_t stride,
                           const int32_t* nll, const int32_t* nd,
                           int64_t lanes, uint16_t* tll, uint16_t* td,
                           int32_t* status) {
    int64_t bad = 0;
    for (int64_t i = 0; i < lanes; i++) {
        if (nll[i] < 0) continue;
        const int32_t* row = lens + i * stride;
        int32_t st = build_region(row, nll[i], true,
                                  tll + i * (kRoot + kSub));
        if (st == kOk)
            st = build_region(row + nll[i], nd[i], false,
                              td + i * (kRoot + kSub));
        status[i] = st;
        bad += st != kOk;
    }
    return bad;
}

}  // extern "C"
