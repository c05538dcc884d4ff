// TIFF strip and tile decompression for data/image_io.py: LZW and PackBits
// as libtiff decodes them for cv2, and the horizontal predictor.
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

#include <cstdint>
#include <cstring>
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
