// LZ4 block-format codec for the page wire serde.
//
// Native equivalent of the reference's aircompressor Lz4Compressor /
// Lz4Decompressor used by PagesSerde
// (presto-main/.../execution/buffer/PagesSerde.java:18-34) — the one
// perf-critical byte-bashing loop in the exchange path that the JVM
// reference also keeps out of "interpreted" code. Emits/consumes the
// standard LZ4 *block* format (token | literals | 16-bit LE offset |
// match continuation), so output is interoperable with any LZ4 block
// decoder.
//
// Compressor: greedy single-pass with an 8k-entry position hash of the
// last 4-byte occurrence (the classic LZ4 fast level). Safety rules per
// the spec: the final 5 bytes are always literals and no match may start
// within the last 12 bytes.

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint32_t hash4(uint32_t v) { return (v * 2654435761u) >> 19; }

constexpr int HASH_BITS = 13;
constexpr int HASH_SIZE = 1 << HASH_BITS;
constexpr int MFLIMIT = 12;   // no match starts in the last 12 bytes
constexpr int LASTLITERALS = 5;  // final 5 bytes are literal-only

inline bool emit_length(uint8_t* dst, int cap, int& op, int len) {
    while (len >= 255) {
        if (op >= cap) return false;
        dst[op++] = 255;
        len -= 255;
    }
    if (op >= cap) return false;
    dst[op++] = static_cast<uint8_t>(len);
    return true;
}

}  // namespace

extern "C" {

// Returns compressed size, or -1 if dst (cap bytes) is too small.
int ptpu_lz4_compress(const uint8_t* src, int n, uint8_t* dst, int cap) {
    int32_t table[HASH_SIZE];
    for (int i = 0; i < HASH_SIZE; i++) table[i] = -1;

    int ip = 0, anchor = 0, op = 0;
    const int mflimit = n - MFLIMIT;

    while (ip < mflimit) {
        uint32_t h = hash4(read32(src + ip));
        int32_t ref = table[h];
        table[h] = ip;
        if (ref < 0 || ip - ref > 65535 || read32(src + ref) != read32(src + ip)) {
            ip++;
            continue;
        }
        // extend the match, leaving the last 5 bytes as literals
        int mlen = 4;
        const int limit = n - LASTLITERALS;
        while (ip + mlen < limit && src[ref + mlen] == src[ip + mlen]) mlen++;

        int lit = ip - anchor;
        if (op >= cap) return -1;
        uint8_t* token = dst + op++;
        if (lit >= 15) {
            *token = 15u << 4;
            if (!emit_length(dst, cap, op, lit - 15)) return -1;
        } else {
            *token = static_cast<uint8_t>(lit << 4);
        }
        if (op + lit > cap) return -1;
        std::memcpy(dst + op, src + anchor, lit);
        op += lit;

        int off = ip - ref;
        if (op + 2 > cap) return -1;
        dst[op++] = static_cast<uint8_t>(off & 0xff);
        dst[op++] = static_cast<uint8_t>((off >> 8) & 0xff);

        int m = mlen - 4;
        if (m >= 15) {
            *token |= 15;
            if (!emit_length(dst, cap, op, m - 15)) return -1;
        } else {
            *token |= static_cast<uint8_t>(m);
        }
        ip += mlen;
        anchor = ip;
    }

    // trailing literals
    int lit = n - anchor;
    if (op >= cap) return -1;
    uint8_t* token = dst + op++;
    if (lit >= 15) {
        *token = 15u << 4;
        if (!emit_length(dst, cap, op, lit - 15)) return -1;
    } else {
        *token = static_cast<uint8_t>(lit << 4);
    }
    if (op + lit > cap) return -1;
    std::memcpy(dst + op, src + anchor, lit);
    op += lit;
    return op;
}

// Returns decompressed size, or -1 on malformed input / overflow.
// Length accumulators are 64-bit: a hostile stream of 0xFF extension
// bytes must saturate the bounds checks, not wrap a 32-bit int into a
// negative that bypasses them.
int ptpu_lz4_decompress(const uint8_t* src, int n, uint8_t* dst, int cap) {
    int64_t ip = 0, op = 0;
    while (ip < n) {
        uint8_t token = src[ip++];
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= n) return -1;
                b = src[ip++];
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > n || op + lit > cap) return -1;
        std::memcpy(dst + op, src + ip, static_cast<size_t>(lit));
        ip += lit;
        op += lit;
        if (ip >= n) break;  // last sequence carries literals only

        if (ip + 2 > n) return -1;
        int64_t off = src[ip] | (src[ip + 1] << 8);
        ip += 2;
        if (off == 0 || off > op) return -1;
        int64_t m = token & 15;
        if (m == 15) {
            uint8_t b;
            do {
                if (ip >= n) return -1;
                b = src[ip++];
                m += b;
            } while (b == 255);
        }
        m += 4;
        if (op + m > cap) return -1;
        const uint8_t* ref = dst + op - off;  // may overlap: copy forward
        for (int64_t i = 0; i < m; i++) dst[op + i] = ref[i];
        op += m;
    }
    return static_cast<int>(op);
}

}  // extern "C"
