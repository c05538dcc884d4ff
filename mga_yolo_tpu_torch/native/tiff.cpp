// TIFF strip and tile decompression for data/image_io.py: LZW, PackBits
// and the CCITT fax codes as libtiff decodes them for cv2, and the
// horizontal predictor.
//
// image_io.py parses the file's first IFD, inflates Deflate strips with
// Python's zlib, hands JPEG strips to jpeg.cpp, and puts the decoded
// samples together as libtiff's RGBA interface (tif_getimage.c) does for
// cv2; these are the byte loops it cannot run in numpy. Every function
// writes at most `cap` bytes and reads nothing past `n`.
//
// Exposed (extern "C"):
//   mga_tiff_lzw       - LZW (codes of 9-12 bits, MSB first, early change)
//   mga_tiff_packbits  - PackBits runs and literals
//   mga_tiff_predict   - undo predictor 2 on rows of 8- or 16-bit samples
//   mga_tiff_fax       - CCITT modified Huffman (2), T.4 / Group 3 1-D and
//                        2-D (3) and T.6 / Group 4 (4) into 1-bit rows

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// LZW-compressed bytes in[0, n) into out[0, cap). Returns the bytes
// written (cap once the output is full, fewer when an EOI code ends the
// data first), -1 for old-style (LSB first) LZW, -2 for a code the table
// does not hold yet, -3 when the data ends before EOI and before the output
// is full. Each code's string lies in the output already: the table holds
// where it starts and its length.
int64_t mga_tiff_lzw(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
    if (n >= 2 && in[0] == 0 && (in[1] & 1)) return -1;
    std::vector<int64_t> pos(4096);
    std::vector<int32_t> len(4096);
    int64_t bitpos = 0, o = 0, prev_pos = 0;
    const int64_t nbits_total = n * 8;
    int width = 9, free_ = 258, prev = -1;
    while (o < cap) {
        if (bitpos + width > nbits_total) return -3;
        uint32_t code = 0;
        for (int b = 0; b < width; ++b, ++bitpos) code = (code << 1) | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
        if (code == 257) break;
        if (code == 256) {
            width = 9;
            free_ = 258;
            prev = -1;
            continue;
        }
        if (prev < 0) {
            if (code > 255) return -2;
            prev_pos = o;
            out[o++] = (uint8_t)code;
            prev = (int)code;
            continue;
        }
        if ((int)code > free_ || free_ >= 4096) return -2;
        // the new entry: prev's string (at prev_pos) and the byte after it
        const int32_t plen = prev < 256 ? 1 : len[prev];
        pos[free_] = prev_pos;
        len[free_] = plen + 1;
        ++free_;
        const int64_t at = o;
        if (code < 256) {
            out[o++] = (uint8_t)code;
        } else {
            // copy forward a byte at a time: the string may end where it is written (code == free_ - 1)
            const int64_t from = pos[code];
            int64_t end = o + len[code];
            if (end > cap) end = cap;
            for (int64_t k = 0; o < end; ++k) out[o++] = out[from + k];
        }
        prev_pos = at;
        prev = (int)code;
        if (free_ + 1 >= (1 << width) && width < 12) ++width;
    }
    return o;
}

// PackBits bytes in[0, n) into out[0, cap). Returns the bytes written, or
// -3 when the data ends before the output is full.
int64_t mga_tiff_packbits(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
    int64_t i = 0, o = 0;
    while (o < cap) {
        if (i >= n) return -3;
        int c = (int8_t)in[i++];
        if (c >= 0) {
            int64_t len = c + 1;
            if (i + len > n) return -3;
            int64_t take = len < cap - o ? len : cap - o;
            std::memcpy(out + o, in + i, take);
            i += len;
            o += take;
        } else if (c != -128) {
            if (i >= n) return -3;
            int64_t len = 1 - c;
            int64_t take = len < cap - o ? len : cap - o;
            std::memset(out + o, in[i++], take);
            o += take;
        }
    }
    return o;
}

// Undo the horizontal predictor in place: rows of `row_samples` samples,
// `stride` samples apart within a row (the samples per pixel), each a byte
// (bits 8) or a 16-bit word in the file's byte order (big_endian).
void mga_tiff_predict(uint8_t* buf, int64_t rows, int64_t row_samples, int stride, int bits, int big_endian) {
    for (int64_t r = 0; r < rows; ++r) {
        if (bits == 8) {
            uint8_t* p = buf + r * row_samples;
            for (int64_t i = stride; i < row_samples; ++i) p[i] = (uint8_t)(p[i] + p[i - stride]);
        } else {
            uint8_t* p = buf + r * row_samples * 2;
            auto get = [&](int64_t i) -> uint32_t {
                return big_endian ? (p[2 * i] << 8) | p[2 * i + 1] : p[2 * i] | (p[2 * i + 1] << 8);
            };
            for (int64_t i = stride; i < row_samples; ++i) {
                uint32_t v = (get(i) + get(i - stride)) & 0xFFFF;
                p[2 * i + (big_endian ? 0 : 1)] = (uint8_t)(v >> 8);
                p[2 * i + (big_endian ? 1 : 0)] = (uint8_t)(v & 0xFF);
            }
        }
    }
}

}  // extern "C"

// ------------------------------------------------------------ CCITT fax
//
// The code tables are ITU-T T.4's (Tables 2 and 3, with the extended
// make-up codes of Table 3 bis shared by both colours, and the 2-D mode
// codes of Table 4). A row is held as its changing elements: the columns
// where the colour changes, white before the first. Decoded rows are packed
// a bit a pixel, most significant bit first, black runs 1 and white runs 0,
// as libtiff's fax decoder writes them; the photometric interpretation maps
// them later. The data is read most significant bit first (image_io.py
// reverses the bytes of FillOrder 2 first).

namespace {

struct FaxCode {
    uint16_t bits;
    uint8_t len;
    int16_t run;
};

const FaxCode kWhite[] = {
    {0x35, 8, 0},     {0x7, 6, 1},      {0x7, 4, 2},      {0x8, 4, 3},      {0xB, 4, 4},      {0xC, 4, 5},
    {0xE, 4, 6},      {0xF, 4, 7},      {0x13, 5, 8},     {0x14, 5, 9},     {0x7, 5, 10},     {0x8, 5, 11},
    {0x8, 6, 12},     {0x3, 6, 13},     {0x34, 6, 14},    {0x35, 6, 15},    {0x2A, 6, 16},    {0x2B, 6, 17},
    {0x27, 7, 18},    {0xC, 7, 19},     {0x8, 7, 20},     {0x17, 7, 21},    {0x3, 7, 22},     {0x4, 7, 23},
    {0x28, 7, 24},    {0x2B, 7, 25},    {0x13, 7, 26},    {0x24, 7, 27},    {0x18, 7, 28},    {0x2, 8, 29},
    {0x3, 8, 30},     {0x1A, 8, 31},    {0x1B, 8, 32},    {0x12, 8, 33},    {0x13, 8, 34},    {0x14, 8, 35},
    {0x15, 8, 36},    {0x16, 8, 37},    {0x17, 8, 38},    {0x28, 8, 39},    {0x29, 8, 40},    {0x2A, 8, 41},
    {0x2B, 8, 42},    {0x2C, 8, 43},    {0x2D, 8, 44},    {0x4, 8, 45},     {0x5, 8, 46},     {0xA, 8, 47},
    {0xB, 8, 48},     {0x52, 8, 49},    {0x53, 8, 50},    {0x54, 8, 51},    {0x55, 8, 52},    {0x24, 8, 53},
    {0x25, 8, 54},    {0x58, 8, 55},    {0x59, 8, 56},    {0x5A, 8, 57},    {0x5B, 8, 58},    {0x4A, 8, 59},
    {0x4B, 8, 60},    {0x32, 8, 61},    {0x33, 8, 62},    {0x34, 8, 63},    {0x1B, 5, 64},    {0x12, 5, 128},
    {0x17, 6, 192},   {0x37, 7, 256},   {0x36, 8, 320},   {0x37, 8, 384},   {0x64, 8, 448},   {0x65, 8, 512},
    {0x68, 8, 576},   {0x67, 8, 640},   {0xCC, 9, 704},   {0xCD, 9, 768},   {0xD2, 9, 832},   {0xD3, 9, 896},
    {0xD4, 9, 960},   {0xD5, 9, 1024},  {0xD6, 9, 1088},  {0xD7, 9, 1152},  {0xD8, 9, 1216},  {0xD9, 9, 1280},
    {0xDA, 9, 1344},  {0xDB, 9, 1408},  {0x98, 9, 1472},  {0x99, 9, 1536},  {0x9A, 9, 1600},  {0x18, 6, 1664},
    {0x9B, 9, 1728},
};

const FaxCode kBlack[] = {
    {0x37, 10, 0},    {0x2, 3, 1},      {0x3, 2, 2},      {0x2, 2, 3},      {0x3, 3, 4},      {0x3, 4, 5},
    {0x2, 4, 6},      {0x3, 5, 7},      {0x5, 6, 8},      {0x4, 6, 9},      {0x4, 7, 10},     {0x5, 7, 11},
    {0x7, 7, 12},     {0x4, 8, 13},     {0x7, 8, 14},     {0x18, 9, 15},    {0x17, 10, 16},   {0x18, 10, 17},
    {0x8, 10, 18},    {0x67, 11, 19},   {0x68, 11, 20},   {0x6C, 11, 21},   {0x37, 11, 22},   {0x28, 11, 23},
    {0x17, 11, 24},   {0x18, 11, 25},   {0xCA, 12, 26},   {0xCB, 12, 27},   {0xCC, 12, 28},   {0xCD, 12, 29},
    {0x68, 12, 30},   {0x69, 12, 31},   {0x6A, 12, 32},   {0x6B, 12, 33},   {0xD2, 12, 34},   {0xD3, 12, 35},
    {0xD4, 12, 36},   {0xD5, 12, 37},   {0xD6, 12, 38},   {0xD7, 12, 39},   {0x6C, 12, 40},   {0x6D, 12, 41},
    {0xDA, 12, 42},   {0xDB, 12, 43},   {0x54, 12, 44},   {0x55, 12, 45},   {0x56, 12, 46},   {0x57, 12, 47},
    {0x64, 12, 48},   {0x65, 12, 49},   {0x52, 12, 50},   {0x53, 12, 51},   {0x24, 12, 52},   {0x37, 12, 53},
    {0x38, 12, 54},   {0x27, 12, 55},   {0x28, 12, 56},   {0x58, 12, 57},   {0x59, 12, 58},   {0x2B, 12, 59},
    {0x2C, 12, 60},   {0x5A, 12, 61},   {0x66, 12, 62},   {0x67, 12, 63},   {0xF, 10, 64},    {0xC8, 12, 128},
    {0xC9, 12, 192},  {0x5B, 12, 256},  {0x33, 12, 320},  {0x34, 12, 384},  {0x35, 12, 448},  {0x6C, 13, 512},
    {0x6D, 13, 576},  {0x4A, 13, 640},  {0x4B, 13, 704},  {0x4C, 13, 768},  {0x4D, 13, 832},  {0x72, 13, 896},
    {0x73, 13, 960},  {0x74, 13, 1024}, {0x75, 13, 1088}, {0x76, 13, 1152}, {0x77, 13, 1216}, {0x52, 13, 1280},
    {0x53, 13, 1344}, {0x54, 13, 1408}, {0x55, 13, 1472}, {0x5A, 13, 1536}, {0x5B, 13, 1600}, {0x64, 13, 1664},
    {0x65, 13, 1728},
};

const FaxCode kExtended[] = {  // make-up codes of either colour
    {0x8, 11, 1792},  {0xC, 11, 1856},  {0xD, 11, 1920},  {0x12, 12, 1984}, {0x13, 12, 2048}, {0x14, 12, 2112},
    {0x15, 12, 2176}, {0x16, 12, 2240}, {0x17, 12, 2304}, {0x1C, 12, 2368}, {0x1D, 12, 2432}, {0x1E, 12, 2496},
    {0x1F, 12, 2560},
};

// A run table indexed by the next 13 bits: the code's length (0 for no
// code) and its run.
struct RunTable {
    uint8_t len[1 << 13];
    int16_t run[1 << 13];
    explicit RunTable(const FaxCode* codes, size_t n) {
        std::memset(len, 0, sizeof len);
        std::memset(run, 0, sizeof run);
        auto put = [&](const FaxCode& c) {
            const int shift = 13 - c.len;
            for (int k = 0; k < (1 << shift); ++k) {
                len[(c.bits << shift) | k] = c.len;
                run[(c.bits << shift) | k] = c.run;
            }
        };
        for (size_t i = 0; i < n; ++i) put(codes[i]);
        for (const FaxCode& c : kExtended) put(c);
    }
};

const RunTable& white_table() {
    static const RunTable t(kWhite, sizeof kWhite / sizeof kWhite[0]);
    return t;
}

const RunTable& black_table() {
    static const RunTable t(kBlack, sizeof kBlack / sizeof kBlack[0]);
    return t;
}

enum Mode { M_PASS, M_HORIZ, M_V0, M_VR1, M_VR2, M_VR3, M_VL1, M_VL2, M_VL3, M_EXT, M_EOL, M_BAD };

struct FaxError {
    std::string what;
};

struct FaxReader {
    const uint8_t* in;
    int64_t nbits, pos = 0;

    // the next n (<= 24) bits, zeros past the end
    uint32_t peek(int n) const {
        uint32_t v = 0;
        int64_t p = pos;
        for (int got = 0; got < n;) {
            const int64_t byte = p >> 3;
            const int off = (int)(p & 7);
            const int take = n - got < 8 - off ? n - got : 8 - off;
            const uint32_t b = byte < (nbits >> 3) ? in[byte] : 0;
            v = (v << take) | ((b >> (8 - off - take)) & ((1u << take) - 1));
            got += take;
            p += take;
        }
        return v;
    }
    void skip(int n) { pos += n; }
    bool over() const { return pos > nbits; }
};

struct FaxDecoder {
    FaxReader r;
    int64_t width;
    std::vector<int64_t> ref, cur;
    int64_t row = 0;

    [[noreturn]] void corrupt(const char* what) const {
        char buf[160];
        std::snprintf(buf, sizeof buf, "corrupt CCITT data (row %lld: %s)", (long long)row, what);
        throw FaxError{buf};
    }
    void check_end() const {
        if (r.over()) {
            char buf[160];
            std::snprintf(buf, sizeof buf, "the CCITT data ends before the strip or tile is full (row %lld)",
                          (long long)row);
            throw FaxError{buf};
        }
    }

    // a change of colour at column x; one at the column of the change
    // before undoes it (a run of no pixels)
    void change(int64_t x) {
        if (!cur.empty() && cur.back() == x)
            cur.pop_back();
        else
            cur.push_back(x);
    }

    // one run of colour `black`: make-up codes, then a terminating code
    int64_t run(bool black) {
        const RunTable& t = black ? black_table() : white_table();
        int64_t total = 0;
        for (;;) {
            const uint32_t look = r.peek(13);
            const int len = t.len[look];
            if (!len) {
                if (r.peek(12) == 1) corrupt("an EOL inside a row");
                check_end();
                corrupt(black ? "not a black run code" : "not a white run code");
            }
            r.skip(len);
            check_end();
            const int v = t.run[look];
            total += v;
            if (total > width) corrupt("a run past the row's end");
            if (v < 64) return total;
        }
    }

    void row_1d() {
        cur.clear();
        int64_t a0 = 0;
        for (bool black = false;; black = !black) {
            a0 += run(black);
            if (a0 > width) corrupt("runs past the row's end");
            if (a0 == width) break;
            change(a0);
        }
    }

    Mode mode() {
        const uint32_t v = r.peek(7);
        Mode m;
        int len;
        if (v >> 6) m = M_V0, len = 1;
        else if ((v >> 4) == 3) m = M_VR1, len = 3;
        else if ((v >> 4) == 2) m = M_VL1, len = 3;
        else if ((v >> 4) == 1) m = M_HORIZ, len = 3;
        else if ((v >> 3) == 1) m = M_PASS, len = 4;
        else if ((v >> 1) == 3) m = M_VR2, len = 6;
        else if ((v >> 1) == 2) m = M_VL2, len = 6;
        else if (v == 3) m = M_VR3, len = 7;
        else if (v == 2) m = M_VL3, len = 7;
        else if (v == 1) m = M_EXT, len = 7;
        else if (r.peek(12) == 1) m = M_EOL, len = 12;
        else m = M_BAD, len = 0;
        r.skip(len);
        check_end();
        return m;
    }

    void row_2d() {
        cur.clear();
        int64_t a0 = -1;  // the imaginary white element before the row
        bool black = false;
        size_t bi = 0;
        auto b1_at = [&]() -> size_t {  // T.4's b1: past a0, of the colour opposite a0's
            while (bi > 0 && ref[bi - 1] > a0) --bi;
            while (ref[bi] <= a0) ++bi;
            if ((bi & 1) != (size_t)black) ++bi;
            return bi;
        };
        while (a0 < width) {
            const Mode m = mode();
            if (m == M_PASS) {
                const size_t i = b1_at();
                a0 = ref[i + 1];
            } else if (m == M_HORIZ) {
                const int64_t start = a0 < 0 ? 0 : a0;
                const int64_t a1 = start + run(black);
                const int64_t a2 = a1 + run(!black);
                if (a2 > width) corrupt("horizontal mode runs past the row's end");
                if (a1 < width) change(a1);
                if (a2 < width) change(a2);
                a0 = a2;
            } else if (m >= M_V0 && m <= M_VL3) {
                static const int kDelta[] = {0, 1, 2, 3, -1, -2, -3};
                const int64_t a1 = ref[b1_at()] + kDelta[m - M_V0];
                if (a1 < (a0 < 0 ? 0 : a0) || a1 > width) corrupt("a vertical mode outside the row");
                if (a1 < width) change(a1);
                a0 = a1;
                black = !black;
            } else if (m == M_EXT) {
                corrupt("an extension code (uncompressed mode)");
            } else if (m == M_EOL) {
                corrupt("an EOL inside a row");
            } else {
                corrupt("not a 2-D mode code");
            }
        }
        if (a0 != width) corrupt("runs past the row's end");
    }

    // T.4's EOL, as libtiff finds it: slide to 11 zero bits, then past the
    // zeros (fill) and the 1 that ends them
    void sync_eol() {
        for (;;) {
            if (r.pos + 11 > r.nbits) {
                r.pos = r.nbits + 1;
                check_end();
            }
            if (r.peek(11) == 0) break;
            r.skip(1);
        }
        r.skip(11);
        while (r.pos < r.nbits && r.peek(1) == 0) r.skip(1);
        r.skip(1);
        check_end();
    }

    void put_row(uint8_t* dst) {
        const int64_t bytes = (width + 7) >> 3;
        std::memset(dst, 0, bytes);
        for (size_t i = 0; i < cur.size(); i += 2) {
            const int64_t from = cur[i], to = i + 1 < cur.size() ? cur[i + 1] : width;
            for (int64_t x = from; x < to; ++x) dst[x >> 3] |= (uint8_t)(0x80 >> (x & 7));
        }
    }
    void to_reference() {
        ref = cur;
        ref.push_back(width);
        ref.push_back(width);
        ref.push_back(width);
    }
};

}  // namespace

extern "C" {

// CCITT-coded bytes in[0, n) into `rows` rows of `width` pixels, packed
// (width + 7) / 8 bytes a row into out[0, cap). `compression` is TIFF's: 2
// modified Huffman (each row's runs byte-aligned), 3 T.4 (`options` is
// T4Options: bit 0 2-D coding, each row after its EOL tagged 1-D or 2-D;
// fill before the EOLs is passed over), 4 T.6. Returns 0, or -1 with the
// reason in err[0, errlen) for corrupt or short data (libtiff conceals
// both), an uncompressed-mode extension, or a buffer too small.
int mga_tiff_fax(const uint8_t* in, int64_t n, int compression, int options, int64_t width, int64_t rows,
                 uint8_t* out, int64_t cap, char* err, int errlen) {
    const int64_t bytes = (width + 7) >> 3;
    try {
        if (width <= 0 || rows < 0 || cap < bytes * rows) throw FaxError{"a CCITT strip or tile of no pixels"};
        FaxDecoder d{FaxReader{in, n * 8}, width, {}, {}, 0};
        d.cur.clear();
        d.to_reference();  // an all-white row above the first
        for (; d.row < rows; ++d.row) {
            if (compression == 2) {
                d.row_1d();
                d.r.pos = (d.r.pos + 7) & ~(int64_t)7;
            } else if (compression == 3) {
                d.sync_eol();
                bool one_d = true;
                if (options & 1) {
                    one_d = d.r.peek(1);
                    d.r.skip(1);
                    d.check_end();
                }
                if (one_d)
                    d.row_1d();
                else
                    d.row_2d();
            } else {
                d.row_2d();
            }
            d.put_row(out + d.row * bytes);
            d.to_reference();
        }
        return 0;
    } catch (const FaxError& e) {
        std::snprintf(err, errlen, "%s", e.what.c_str());
        return -1;
    } catch (const std::bad_alloc&) {
        std::snprintf(err, errlen, "out of memory decoding CCITT data");
        return -1;
    }
}

}  // extern "C"
