// The byte loops of the upload-only formats for data/raster_io.py: PNM's
// ASCII numbers and Radiance HDR's scanlines, as OpenCV's grfmt_pxm.cpp
// and rgbe.cpp read them for cv2.imdecode. The headers, the sample
// conversions and the colour order are done in numpy there.
//
// Exposed (extern "C"):
//   mga_pnm_numbers - decimal numbers as OpenCV's ReadNumber reads them
//   mga_hdr_pixels  - RGBE scanlines, run-length (new style) or flat

#include <cctype>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// `count` numbers from d[*pos, n) into out, *pos moved past them: each
// after whitespace and '#' comments (to a CR or LF), at most `maxdigits`
// digits (0: any), the character after it passed over. Returns 0, -1 for
// a character that is neither, -2 when the data ends first, -3 for a number
// past INT_MAX.
int mga_pnm_numbers(const uint8_t* d, int64_t n, int64_t* pos, int64_t count, int maxdigits, int32_t* out) {
    int64_t p = *pos;
    for (int64_t k = 0; k < count; ++k) {
        if (p >= n) return -2;
        int c = d[p++];
        while (!std::isdigit(c)) {
            if (c == '#') {
                do {
                    if (p >= n) return -2;
                    c = d[p++];
                } while (c != '\n' && c != '\r');
                if (p >= n) return -2;
                c = d[p++];
            } else if (std::isspace(c)) {
                while (std::isspace(c)) {
                    if (p >= n) return -2;
                    c = d[p++];
                }
            } else {
                *pos = p - 1;
                return -1;
            }
        }
        int64_t v = 0;
        int digits = 0;
        for (;;) {
            v = v * 10 + (c - '0');
            if (v > 2147483647) return -3;
            if (maxdigits && ++digits >= maxdigits) break;
            if (p >= n) return -2;
            c = d[p++];
            if (!std::isdigit(c)) break;
        }
        out[k] = (int32_t)v;
    }
    *pos = p;
    return 0;
}

// `height` scanlines of `width` RGBE pixels from d[off, n) into out (R, G,
// B, E bytes a pixel), as rgbe.cpp's RGBE_ReadPixels_RLE reads them: widths
// under 8 or over 32767 flat; a scanline that does not start 2, 2 (and a
// width under 32768) is the first pixel of a flat rest of the image;
// otherwise each of the four components in runs (count > 128: count - 128
// copies of one byte) and literals (count bytes). Returns 0, -1 for a
// scanline of another width or a run of 0 or past the scanline, -2 when
// the data ends first.
int mga_hdr_pixels(const uint8_t* d, int64_t n, int64_t off, int64_t width, int64_t height, uint8_t* out) {
    const int64_t total = width * height * 4;
    auto flat = [&](int64_t from) -> int {
        const int64_t need = total - from;
        if (n - off < need) return -2;
        std::memcpy(out + from, d + off, need);
        return 0;
    };
    if (width < 8 || width > 0x7fff) return flat(0);
    std::vector<uint8_t> line(width * 4);
    for (int64_t y = 0; y < height; ++y) {
        if (n - off < 4) return -2;
        const uint8_t* h = d + off;
        if (h[0] != 2 || h[1] != 2 || (h[2] & 0x80)) return flat(y * width * 4);
        if (((h[2] << 8) | h[3]) != width) return -1;
        off += 4;
        for (int c = 0; c < 4; ++c) {
            uint8_t* p = line.data() + c * width;
            uint8_t* end = p + width;
            while (p < end) {
                if (n - off < 2) return -2;
                int count = d[off];
                if (count > 128) {
                    count -= 128;
                    if (count > end - p) return -1;
                    std::memset(p, d[off + 1], count);
                    off += 2;
                } else {
                    if (count == 0 || count > end - p) return -1;
                    if (n - off < 1 + count) return -2;
                    std::memcpy(p, d + off + 1, count);
                    off += 1 + count;
                }
                p += count;
            }
        }
        uint8_t* o = out + y * width * 4;
        for (int64_t x = 0; x < width; ++x)
            for (int c = 0; c < 4; ++c) o[4 * x + c] = line[c * width + x];
    }
    return 0;
}

}  // extern "C"
