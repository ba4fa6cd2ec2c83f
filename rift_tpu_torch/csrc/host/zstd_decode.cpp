// A Zstandard decoder (RFC 8878), host C++ with a plain C interface.
//
// It reads the frames that orbax's zarr arrays and tensorstore's OCDBT nodes
// are stored in, on a machine without the zstd library: raw, RLE and
// compressed blocks; Huffman literals (one and four streams, treeless, weights
// coded directly or by FSE); FSE sequence tables (predefined, RLE, compressed,
// repeat) and the repeat offsets; history across the blocks of a frame and any
// number of frames in one buffer; skippable frames, which it skips; and the
// xxhash64 content checksum, checked where the frame's flag is set.
//
// Dictionaries are not supported: a frame that names a dictionary raises, as
// does a reserved bit or any malformed input. Every error carries the byte
// offset in the input where it was found. Nothing is silently truncated.
//
// C interface (see `rift_zstd_decompress`): the output grows as it is decoded
// (a frame need not state its content size), so the library returns a buffer
// from malloc that the caller hands back to `rift_zstd_free`.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct DecodeError {
    std::string what;
    size_t offset;
};

[[noreturn]] void fail(const std::string& what, size_t offset) {
    throw DecodeError{what, offset};
}

inline uint32_t read_le32(const uint8_t* p) {
    return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

inline uint64_t read_le64(const uint8_t* p) {
    return uint64_t(read_le32(p)) | uint64_t(read_le32(p + 4)) << 32;
}

inline int highbit(uint32_t v) {  // index of the highest set bit; v > 0
    return 31 - __builtin_clz(v);
}

// ---------------------------------------------------------------- xxhash64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
    acc += input * P2;
    acc = rotl(acc, 31);
    return acc * P1;
}

inline uint64_t xxh_merge(uint64_t acc, uint64_t val) {
    acc ^= xxh_round(0, val);
    return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed) {
    const uint8_t* end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        const uint8_t* limit = end - 32;
        do {
            v1 = xxh_round(v1, read_le64(p));
            v2 = xxh_round(v2, read_le64(p + 8));
            v3 = xxh_round(v3, read_le64(p + 16));
            v4 = xxh_round(v4, read_le64(p + 24));
            p += 32;
        } while (p <= limit);
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xxh_merge(h, v1);
        h = xxh_merge(h, v2);
        h = xxh_merge(h, v3);
        h = xxh_merge(h, v4);
    } else {
        h = seed + P5;
    }
    h += uint64_t(len);
    while (p + 8 <= end) {
        h ^= xxh_round(0, read_le64(p));
        h = rotl(h, 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= uint64_t(read_le32(p)) * P1;
        h = rotl(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= uint64_t(*p) * P5;
        h = rotl(h, 11) * P1;
        ++p;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

// ---------------------------------------------------------------- bit readers

// Forward reader (FSE table descriptions): bits from the least significant
// bit of the first byte upwards.
struct ForwardBits {
    const uint8_t* data;
    size_t size;
    size_t origin;  // offset of data[0] in the whole input, for errors
    size_t bit = 0;

    uint32_t peek(int n) const {  // n <= 24; bits past the end read as 0
        uint32_t v = 0;
        size_t byte = bit >> 3;
        for (int i = 0; i < 4 && byte + i < size; ++i) v |= uint32_t(data[byte + i]) << (8 * i);
        return (v >> (bit & 7)) & ((1u << n) - 1);
    }
    void skip(int n) {
        bit += n;
        if (bit > size * 8) fail("FSE table description runs past its end", origin + size);
    }
    size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward reader (Huffman and FSE bitstreams): the last byte's highest set
// bit marks the start; bits are read from there towards the first byte.
// Reads below the first bit give zeros and drive `pos` negative, which the
// callers test where the format says the stream must end exactly.
struct BackwardBits {
    const uint8_t* data;
    size_t size;
    size_t origin;
    int64_t pos;  // bits [0, pos) are left

    BackwardBits(const uint8_t* d, size_t n, size_t org) : data(d), size(n), origin(org) {
        if (n == 0) fail("empty bitstream", org);
        uint8_t last = d[n - 1];
        if (last == 0) fail("bitstream's last byte has no start marker", org + n - 1);
        pos = int64_t(n - 1) * 8 + highbit(last);
    }
    uint64_t load64(int64_t byte) const {  // little-endian, zero past the end
        if (byte + 8 <= int64_t(size)) return read_le64(data + byte);
        uint64_t v = 0;
        for (int i = 0; i < 8 && byte + i < int64_t(size); ++i)
            v |= uint64_t(data[byte + i]) << (8 * i);
        return v;
    }
    uint64_t peek(int n) const {  // n <= 56
        if (n == 0) return 0;
        int64_t lo = pos - n;
        if (lo >= 0) return (load64(lo >> 3) >> (lo & 7)) & ((uint64_t(1) << n) - 1);
        if (pos <= 0) return 0;
        // Some of the bits lie below the first: they are zeros.
        uint64_t v = load64(0) & ((uint64_t(1) << pos) - 1);
        return v << (-lo);
    }
    void skip(int n) { pos -= n; }
    uint64_t read(int n) {
        uint64_t v = peek(n);
        pos -= n;
        return v;
    }
};

// ---------------------------------------------------------------- FSE

struct FseEntry {
    uint8_t symbol;
    uint8_t bits;
    uint16_t base;
};

struct FseTable {
    int log = -1;  // -1: no table yet (a repeat mode then fails)
    std::vector<FseEntry> cells;
};

void build_fse(FseTable& t, const int16_t* norm, int max_symbol, int log, size_t origin) {
    const uint32_t size = 1u << log;
    t.log = log;
    t.cells.assign(size, FseEntry{0, 0, 0});
    std::vector<uint16_t> next(max_symbol + 1);
    uint32_t high = size - 1;
    for (int s = 0; s <= max_symbol; ++s) {
        if (norm[s] == -1) {
            t.cells[high--].symbol = uint8_t(s);
            next[s] = 1;
        } else {
            next[s] = uint16_t(norm[s]);
        }
    }
    const uint32_t mask = size - 1, step = (size >> 1) + (size >> 3) + 3;
    uint32_t position = 0;
    for (int s = 0; s <= max_symbol; ++s) {
        for (int i = 0; i < norm[s]; ++i) {
            t.cells[position].symbol = uint8_t(s);
            do {
                position = (position + step) & mask;
            } while (position > high);
        }
    }
    if (position != 0) fail("FSE distribution does not fill its table", origin);
    for (uint32_t u = 0; u < size; ++u) {
        uint8_t s = t.cells[u].symbol;
        uint32_t state = next[s]++;
        int bits = log - highbit(state);
        t.cells[u].bits = uint8_t(bits);
        t.cells[u].base = uint16_t((state << bits) - size);
    }
}

// Reads an FSE table description at data[0..]; returns the bytes it took.
size_t read_fse_description(FseTable& t, const uint8_t* data, size_t size, size_t origin,
                            int max_log, int max_symbol) {
    if (size == 0) fail("missing FSE table description", origin);
    ForwardBits in{data, size, origin};
    int log = int(in.peek(4)) + 5;
    in.skip(4);
    if (log > max_log) fail("FSE accuracy log " + std::to_string(log) + " above " +
                            std::to_string(max_log), origin);
    int16_t norm[256] = {0};
    int32_t remaining = (1 << log) + 1, threshold = 1 << log;
    int bits = log + 1, symbol = 0;
    bool previous_zero = false;
    while (remaining > 1 && symbol <= max_symbol) {
        if (previous_zero) {
            int n0 = symbol;
            while (in.peek(2) == 3) {
                n0 += 3;
                in.skip(2);
            }
            n0 += int(in.peek(2));
            in.skip(2);
            if (n0 > max_symbol) fail("FSE zero run past the last symbol", origin);
            while (symbol < n0) norm[symbol++] = 0;
            if (symbol > max_symbol) break;
        }
        int32_t max = (2 * threshold - 1) - remaining;
        int32_t count;
        uint32_t v = in.peek(bits);
        if (int32_t(v & (threshold - 1)) < max) {
            count = int32_t(v & (threshold - 1));
            in.skip(bits - 1);
        } else {
            count = int32_t(v & (2 * threshold - 1));
            if (count >= threshold) count -= max;
            in.skip(bits);
        }
        count -= 1;  // -1 is the "less than 1" probability
        remaining -= count < 0 ? -count : count;
        norm[symbol++] = int16_t(count);
        previous_zero = count == 0;
        while (remaining < threshold) {
            --bits;
            threshold >>= 1;
        }
    }
    if (remaining != 1) fail("FSE probabilities do not sum to the table size", origin);
    build_fse(t, norm, symbol - 1, log, origin);
    return in.bytes_used();
}

void rle_fse(FseTable& t, uint8_t symbol) {
    t.log = 0;
    t.cells.assign(1, FseEntry{symbol, 0, 0});
}

struct FseState {
    const FseTable* table;
    uint32_t state;
    void init(const FseTable& t, BackwardBits& in) {
        table = &t;
        state = uint32_t(in.read(t.log));
    }
    uint8_t symbol() const { return table->cells[state].symbol; }
    void update(BackwardBits& in) {
        const FseEntry& e = table->cells[state];
        state = e.base + uint32_t(in.read(e.bits));
    }
};

// ---------------------------------------------------------------- Huffman

struct HufEntry {
    uint8_t symbol;
    uint8_t bits;
};

struct HufTable {
    int max_bits = 0;  // 0: no table yet (treeless literals then fail)
    std::vector<HufEntry> cells;
};

// Reads a Huffman tree description; returns the bytes it took.
size_t read_huffman(HufTable& h, const uint8_t* data, size_t size, size_t origin) {
    if (size == 0) fail("missing Huffman tree description", origin);
    uint8_t weights[256 + 2] = {0};
    int count = 0;
    size_t used;
    uint8_t header = data[0];
    if (header < 128) {
        used = 1 + size_t(header);
        if (header == 0 || used > size) fail("bad FSE-coded Huffman weights size", origin);
        FseTable t;
        size_t desc = read_fse_description(t, data + 1, header, origin + 1, 6, 255);
        if (desc >= header) fail("Huffman weights: no bitstream after the FSE table", origin + 1);
        BackwardBits in(data + 1 + desc, header - desc, origin + 1 + desc);
        FseState s1, s2;
        s1.init(t, in);
        s2.init(t, in);
        while (true) {
            if (count > 253) fail("more than 255 Huffman weights", origin);
            weights[count++] = s1.symbol();
            s1.update(in);
            if (in.pos < 0) {
                weights[count++] = s2.symbol();
                break;
            }
            if (count > 253) fail("more than 255 Huffman weights", origin);
            weights[count++] = s2.symbol();
            s2.update(in);
            if (in.pos < 0) {
                weights[count++] = s1.symbol();
                break;
            }
        }
    } else {
        count = header - 127;
        used = 1 + size_t(count + 1) / 2;
        if (used > size) fail("Huffman weights run past the literals section", origin);
        for (int i = 0; i < count; ++i) {
            uint8_t b = data[1 + i / 2];
            weights[i] = (i % 2 == 0) ? b >> 4 : b & 15;
        }
    }
    if (count > 255) fail("more than 255 Huffman weights", origin);
    uint32_t total = 0;
    for (int i = 0; i < count; ++i) {
        if (weights[i] > 11) fail("Huffman weight above 11", origin);
        if (weights[i]) total += 1u << (weights[i] - 1);
    }
    if (total == 0) fail("Huffman weights are all zero", origin);
    int max_bits = highbit(total) + 1;
    if (max_bits > 11) fail("Huffman code longer than 11 bits", origin);
    uint32_t rest = (1u << max_bits) - total;
    if (rest & (rest - 1)) fail("Huffman weights do not complete a power of two", origin);
    weights[count++] = uint8_t(highbit(rest) + 1);  // the implicit last weight
    int rank_count[13] = {0};
    for (int i = 0; i < count; ++i) ++rank_count[weights[i]];
    uint32_t rank_start[13] = {0};
    for (int w = 1, next = 0; w <= max_bits; ++w) {
        rank_start[w] = next;
        next += rank_count[w] << (w - 1);
    }
    h.max_bits = max_bits;
    h.cells.assign(size_t(1) << max_bits, HufEntry{0, 0});
    for (int s = 0; s < count; ++s) {
        int w = weights[s];
        if (!w) continue;
        uint32_t len = 1u << (w - 1);
        for (uint32_t u = rank_start[w]; u < rank_start[w] + len; ++u)
            h.cells[u] = HufEntry{uint8_t(s), uint8_t(max_bits + 1 - w)};
        rank_start[w] += len;
    }
    return used;
}

void huffman_stream(const HufTable& h, const uint8_t* data, size_t size, size_t origin,
                    uint8_t* out, size_t n) {
    BackwardBits in(data, size, origin);
    for (size_t i = 0; i < n; ++i) {
        const HufEntry& e = h.cells[in.peek(h.max_bits)];
        out[i] = e.symbol;
        in.skip(e.bits);
    }
    if (in.pos != 0) fail("Huffman stream does not end where its literals do", origin);
}

// ---------------------------------------------------------------- sequences

constexpr uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                                  12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                                  48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,  15,   16,   17,   18,   19,    20,
    21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,  33,   34,   35,   37,   39,    41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                    2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

constexpr size_t MAX_BLOCK = 128 * 1024;

// Decoder state that lives for one frame.
struct Frame {
    HufTable huffman;
    FseTable ll, of, ml;
    uint32_t rep[3] = {1, 4, 8};
};

struct Tables {
    FseTable ll, of, ml;
    Tables() {
        build_fse(ll, LL_DEFAULT, 35, 6, 0);
        build_fse(ml, ML_DEFAULT, 52, 6, 0);
        build_fse(of, OF_DEFAULT, 28, 5, 0);
    }
};

const Tables& predefined() {
    static const Tables t;
    return t;
}

// One of the three sequence tables by its 2-bit mode; returns the bytes read.
size_t sequence_table(FseTable& t, int mode, const FseTable& preset, int max_log,
                      int max_symbol, const uint8_t* data, size_t size, size_t origin,
                      const char* name) {
    switch (mode) {
        case 0:
            t = preset;
            return 0;
        case 1:
            if (size < 1) fail(std::string(name) + ": RLE symbol missing", origin);
            if (data[0] > max_symbol) fail(std::string(name) + ": RLE symbol out of range", origin);
            rle_fse(t, data[0]);
            return 1;
        case 2:
            return read_fse_description(t, data, size, origin, max_log, max_symbol);
        default:
            if (t.log < 0) fail(std::string(name) + ": repeat mode with no earlier table", origin);
            return 0;
    }
}

// Decodes the literals section; returns its size in bytes.
size_t literals_section(Frame& f, const uint8_t* data, size_t size, size_t origin,
                        std::vector<uint8_t>& lit) {
    if (size < 1) fail("empty compressed block", origin);
    int type = data[0] & 3, format = (data[0] >> 2) & 3;
    size_t regen, comp = 0, header;
    if (type < 2) {
        if ((format & 1) == 0) {
            header = 1;
            regen = data[0] >> 3;
        } else if (format == 1) {
            header = 2;
            if (size < 2) fail("literals header truncated", origin);
            regen = (data[0] >> 4) + (size_t(data[1]) << 4);
        } else {
            header = 3;
            if (size < 3) fail("literals header truncated", origin);
            regen = (data[0] >> 4) + (size_t(data[1]) << 4) + (size_t(data[2]) << 12);
        }
    } else {
        header = format < 2 ? 3 : format == 2 ? 4 : 5;
        if (size < header) fail("literals header truncated", origin);
        uint64_t v = 0;
        for (size_t i = 0; i < header; ++i) v |= uint64_t(data[i]) << (8 * i);
        int width = header == 3 ? 10 : header == 4 ? 14 : 18;
        regen = size_t((v >> 4) & ((1u << width) - 1));
        comp = size_t((v >> (4 + width)) & ((1u << width) - 1));
    }
    if (regen > MAX_BLOCK) fail("literals longer than a block", origin);
    lit.resize(regen);
    if (type == 0) {
        if (header + regen > size) fail("raw literals run past the block", origin);
        if (regen) memcpy(lit.data(), data + header, regen);
        return header + regen;
    }
    if (type == 1) {
        if (header + 1 > size) fail("RLE literals byte missing", origin);
        memset(lit.data(), data[header], regen);
        return header + 1;
    }
    if (header + comp > size) fail("compressed literals run past the block", origin);
    const uint8_t* p = data + header;
    size_t at = origin + header, left = comp;
    if (type == 2) {
        size_t tree = read_huffman(f.huffman, p, left, at);
        p += tree;
        at += tree;
        left -= tree;
    } else if (f.huffman.max_bits == 0) {
        fail("treeless literals with no earlier Huffman table", origin);
    }
    if (format == 0) {  // one stream; else four, behind a jump table
        huffman_stream(f.huffman, p, left, at, lit.data(), regen);
    } else {
        if (left < 6) fail("4-stream literals: jump table truncated", at);
        size_t s1 = p[0] | p[1] << 8, s2 = p[2] | p[3] << 8, s4 = p[4] | p[5] << 8;
        if (6 + s1 + s2 + s4 > left) fail("4-stream literals: jump table past the section", at);
        size_t sizes[4] = {s1, s2, s4, left - 6 - s1 - s2 - s4};
        size_t seg = (regen + 3) / 4;
        if (3 * seg > regen) fail("4-stream literals: too few literals for four streams", at);
        size_t outs[4] = {seg, seg, seg, regen - 3 * seg};
        const uint8_t* q = p + 6;
        size_t qat = at + 6, o = 0;
        for (int i = 0; i < 4; ++i) {
            huffman_stream(f.huffman, q, sizes[i], qat, lit.data() + o, outs[i]);
            q += sizes[i];
            qat += sizes[i];
            o += outs[i];
        }
    }
    return header + comp;
}

void compressed_block(Frame& f, const uint8_t* data, size_t size, size_t origin,
                      std::vector<uint8_t>& out, size_t frame_start,
                      std::vector<uint8_t>& lit) {
    size_t lit_size = literals_section(f, data, size, origin, lit);
    const uint8_t* p = data + lit_size;
    size_t at = origin + lit_size, left = size - lit_size;
    if (left < 1) fail("sequences section missing", at);
    size_t nseq = p[0], head = 1;
    if (nseq >= 128) {
        if (nseq < 255) {
            if (left < 2) fail("sequence count truncated", at);
            nseq = ((nseq - 128) << 8) + p[1];
            head = 2;
        } else {
            if (left < 3) fail("sequence count truncated", at);
            nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
            head = 3;
        }
    }
    size_t lit_pos = 0;
    if (nseq == 0) {
        if (head != left) fail("bytes after an empty sequences section", at + head);
    } else {
        if (left < head + 1) fail("sequence modes byte missing", at);
        uint8_t modes = p[head];
        if (modes & 3) fail("reserved bits set in the sequence modes", at + head);
        size_t q = head + 1;
        const Tables& pre = predefined();
        q += sequence_table(f.ll, modes >> 6, pre.ll, 9, 35, p + q, left - q, at + q,
                            "literal lengths");
        q += sequence_table(f.of, (modes >> 4) & 3, pre.of, 8, 31, p + q, left - q, at + q,
                            "offsets");
        q += sequence_table(f.ml, (modes >> 2) & 3, pre.ml, 9, 52, p + q, left - q, at + q,
                            "match lengths");
        if (q >= left) fail("sequence bitstream missing", at + q);
        BackwardBits in(p + q, left - q, at + q);
        FseState sll, sof, sml;
        sll.init(f.ll, in);
        sof.init(f.of, in);
        sml.init(f.ml, in);
        for (size_t i = 0; i < nseq; ++i) {
            uint8_t of_code = sof.symbol(), ml_code = sml.symbol(), ll_code = sll.symbol();
            if (of_code > 31) fail("offset code above 31", at + q);
            if (ml_code > 52 || ll_code > 35) fail("length code out of range", at + q);
            uint32_t of_value = (1u << of_code) + uint32_t(in.read(of_code));
            uint32_t ml = ML_BASE[ml_code] + uint32_t(in.read(ML_BITS[ml_code]));
            uint32_t ll = LL_BASE[ll_code] + uint32_t(in.read(LL_BITS[ll_code]));
            uint32_t offset;
            if (of_value > 3) {
                offset = of_value - 3;
                f.rep[2] = f.rep[1];
                f.rep[1] = f.rep[0];
                f.rep[0] = offset;
            } else {
                uint32_t idx = of_value - 1 + (ll == 0);
                if (idx == 0) {
                    offset = f.rep[0];
                } else {
                    offset = idx == 3 ? f.rep[0] - 1 : f.rep[idx];
                    if (offset == 0) fail("repeat offset of 0", at + q);
                    if (idx > 1) f.rep[2] = f.rep[1];
                    f.rep[1] = f.rep[0];
                    f.rep[0] = offset;
                }
            }
            if (i + 1 < nseq) {
                sll.update(in);
                sml.update(in);
                sof.update(in);
            }
            if (in.pos < 0) fail("sequence bitstream overrun", at + q);
            if (lit_pos + ll > lit.size()) fail("sequence takes more literals than decoded", at + q);
            out.insert(out.end(), lit.begin() + lit_pos, lit.begin() + lit_pos + ll);
            lit_pos += ll;
            size_t have = out.size() - frame_start;
            if (offset > have) fail("match offset before the frame's start", at + q);
            size_t src = out.size() - offset;
            out.resize(out.size() + ml);
            uint8_t* o = out.data();
            size_t dst = out.size() - ml;
            if (offset >= ml) {
                memcpy(o + dst, o + src, ml);
            } else {
                for (uint32_t k = 0; k < ml; ++k) o[dst + k] = o[src + k];
            }
        }
        if (in.pos != 0) fail("sequence bitstream not consumed to its start", at + q);
    }
    out.insert(out.end(), lit.begin() + lit_pos, lit.end());
}

// Decodes the frame at in[start..]; returns the offset just past it.
size_t decode_frame(const uint8_t* in, size_t n, size_t start, std::vector<uint8_t>& out) {
    size_t at = start + 4;
    if (at >= n) fail("frame header truncated", at);
    uint8_t fhd = in[at++];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
    if (fhd & 8) fail("reserved bit set in the frame header", at - 1);
    if (!single) {
        if (at >= n) fail("window descriptor missing", at);
        ++at;  // the window size bounds offsets; the whole frame is kept, so it is not needed
    }
    static const int DID_BYTES[4] = {0, 1, 2, 4}, FCS_BYTES[4] = {0, 2, 4, 8};
    int did_bytes = DID_BYTES[did_flag];
    if (at + did_bytes > n) fail("dictionary ID truncated", at);
    uint32_t did = 0;
    for (int i = 0; i < did_bytes; ++i) did |= uint32_t(in[at + i]) << (8 * i);
    if (did != 0) fail("frame needs dictionary " + std::to_string(did) + " (unsupported)", at);
    at += did_bytes;
    int fcs_bytes = (fcs_flag == 0 && single) ? 1 : FCS_BYTES[fcs_flag];
    bool has_fcs = fcs_bytes > 0;
    uint64_t fcs = 0;
    if (at + fcs_bytes > n) fail("frame content size truncated", at);
    for (int i = 0; i < fcs_bytes; ++i) fcs |= uint64_t(in[at + i]) << (8 * i);
    if (fcs_bytes == 2) fcs += 256;
    at += fcs_bytes;

    size_t frame_start = out.size();
    Frame f;
    std::vector<uint8_t> lit;
    while (true) {
        if (at + 3 > n) fail("block header truncated", at);
        uint32_t bh = in[at] | in[at + 1] << 8 | in[at + 2] << 16;
        size_t block_at = at;
        at += 3;
        bool last = bh & 1;
        int type = (bh >> 1) & 3;
        size_t size = bh >> 3;
        if (type == 3) fail("reserved block type", block_at);
        if (size > MAX_BLOCK) fail("block larger than 128 KiB", block_at);
        size_t before = out.size();
        if (type == 0) {
            if (at + size > n) fail("raw block runs past the input", block_at);
            out.insert(out.end(), in + at, in + at + size);
            at += size;
        } else if (type == 1) {
            if (at + 1 > n) fail("RLE block byte missing", block_at);
            out.insert(out.end(), size, in[at]);
            at += 1;
        } else {
            if (at + size > n) fail("compressed block runs past the input", block_at);
            compressed_block(f, in + at, size, at, out, frame_start, lit);
            at += size;
        }
        if (out.size() - before > MAX_BLOCK) fail("block decodes to more than 128 KiB", block_at);
        if (last) break;
    }
    size_t content = out.size() - frame_start;
    if (has_fcs && content != fcs)
        fail("frame decodes to " + std::to_string(content) + " bytes, its header says " +
             std::to_string(fcs), start);
    if (checksum) {
        if (at + 4 > n) fail("content checksum truncated", at);
        uint32_t want = read_le32(in + at);
        uint32_t got = uint32_t(xxh64(out.data() + frame_start, content, 0));
        if (want != got) fail("content checksum mismatch", at);
        at += 4;
    }
    return at;
}

void decode_all(const uint8_t* in, size_t n, std::vector<uint8_t>& out) {
    if (n == 0) fail("no zstd frame in an empty input", 0);
    size_t at = 0;
    while (at < n) {
        if (at + 4 > n) fail("trailing bytes after the last frame", at);
        uint32_t magic = read_le32(in + at);
        if (magic == 0xFD2FB528u) {
            at = decode_frame(in, n, at, out);
        } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
            if (at + 8 > n) fail("skippable frame header truncated", at);
            size_t len = read_le32(in + at + 4);
            if (at + 8 + len > n) fail("skippable frame runs past the input", at);
            at += 8 + len;
        } else {
            fail("not a zstd frame (bad magic)", at);
        }
    }
}

}  // namespace

extern "C" {

// Decodes every frame of src[0:n] into one buffer. On success returns 0,
// with *out (from malloc; free it with rift_zstd_free) and *out_n set. On
// failure returns 1 and writes "<message> at byte <offset>" into err
// (err_n bytes, NUL-terminated); *out is then NULL.
int rift_zstd_decompress(const uint8_t* src, size_t n, uint8_t** out, size_t* out_n,
                         char* err, size_t err_n) {
    *out = nullptr;
    *out_n = 0;
    try {
        std::vector<uint8_t> buf;
        decode_all(src, n, buf);
        uint8_t* p = static_cast<uint8_t*>(malloc(buf.size() ? buf.size() : 1));
        if (!p) {
            snprintf(err, err_n, "out of memory for %zu bytes at byte 0", buf.size());
            return 1;
        }
        if (!buf.empty()) memcpy(p, buf.data(), buf.size());
        *out = p;
        *out_n = buf.size();
        return 0;
    } catch (const DecodeError& e) {
        snprintf(err, err_n, "%s at byte %zu", e.what.c_str(), e.offset);
        return 1;
    } catch (const std::exception& e) {
        snprintf(err, err_n, "%s at byte 0", e.what());
        return 1;
    }
}

void rift_zstd_free(uint8_t* p) { free(p); }

}  // extern "C"
