// Many short host buffers in one call: the LZ4 decompress's staging of a
// request's compressed blocks into the block decoder's padded rows, and
// the XXH32 of each of its decoded chunks.
//
// One call a request, made outside the interpreter lock, in place of one
// call a block: under four client threads each such call hands the lock to
// another thread and waits to take it back, which cost more than the copy
// or the hash it made.
#include <cstdint>
#include <cstring>

extern "C" {

uint32_t qz_xxh32(const uint8_t* p, int64_t len, uint32_t seed);

// Copy buffer i (ptrs[i], lens[i] bytes) to the start of row i of dst, a
// row every stride bytes.  The caller checked that lens[i] <= stride.
void qz_pack_rows(const uint8_t* const* ptrs, const int64_t* lens, int64_t n,
                  uint8_t* dst, int64_t stride) {
    for (int64_t i = 0; i < n; ++i) {
        if (lens[i] > 0) {
            std::memcpy(dst + i * stride, ptrs[i],
                        static_cast<size_t>(lens[i]));
        }
    }
}

// out[i] = XXH32 of buffer i with seed.
void qz_xxh32_rows(const uint8_t* const* ptrs, const int64_t* lens,
                   int64_t n, uint32_t seed, uint32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = qz_xxh32(ptrs[i], lens[i], seed);
    }
}

}  // extern "C"
