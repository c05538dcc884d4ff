// GIF decoding on the host for data/image_io.py and data/video_io.py: the
// logical screen, the colour tables, the graphic control extensions and the
// image descriptors, and each image's LZW data to its colour indices. The
// frames are put on the canvas in Python, by the rule of the reader they
// stand in for (cv2's own GIF codec for stills, ffmpeg's gif decoder for
// video), from what these functions return.
//
// GIF's LZW reads codes least significant bit first, starting one bit wider
// than the minimum code size, and widens when the next free code reaches
// the width's limit (no early change, unlike TIFF's); at 4096 entries the
// table stops growing and the codes stay 12 bits until a clear code.
//
// Exposed (extern "C"):
//   mga_gif_header - the logical screen and the global colour table
//   mga_gif_frame  - the next image from an offset: its descriptor, the
//                    graphic control extension before it, its colour table,
//                    and its indices (interlaced rows put in order)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

int rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }

// The bytes of the data sub-blocks from `off`, appended to `out`; the
// offset after the block terminator, or -1 when the data ends first.
int64_t sub_blocks(const uint8_t* d, int64_t n, int64_t off, std::vector<uint8_t>* out) {
    for (;;) {
        if (off >= n) return -1;
        const int len = d[off++];
        if (!len) return off;
        if (off + len > n) return -1;
        if (out) out->insert(out->end(), d + off, d + off + len);
        off += len;
    }
}

// LZW codes into `count` indices; 0, or -1 (corrupt) / -2 (the data ends
// before the image is full).
int lzw(const std::vector<uint8_t>& in, int min_size, uint8_t* out, int64_t count) {
    static thread_local uint16_t prefix[4096];
    static thread_local uint8_t suffix[4096], first[4096];
    static thread_local uint8_t stack[4097];
    const int clear = 1 << min_size, eoi = clear + 1;
    for (int i = 0; i < clear; ++i) suffix[i] = first[i] = (uint8_t)i;
    int width = min_size + 1, next = clear + 2, prev = -1;
    uint32_t acc = 0;
    int bits = 0;
    size_t pos = 0;
    int64_t o = 0;
    while (o < count) {
        while (bits < width) {
            if (pos >= in.size()) return -2;
            acc |= (uint32_t)in[pos++] << bits;
            bits += 8;
        }
        const int code = (int)(acc & ((1u << width) - 1));
        acc >>= width;
        bits -= width;
        if (code == clear) {
            width = min_size + 1;
            next = clear + 2;
            prev = -1;
            continue;
        }
        if (code == eoi) return -2;
        if (prev < 0) {
            if (code >= clear) return -1;
            out[o++] = (uint8_t)code;
            prev = code;
            continue;
        }
        int sp = 0, c = code;
        if (code > next || (code == next && next >= 4096)) return -1;
        if (code == next) {  // the string of prev and its first index
            stack[sp++] = first[prev];
            c = prev;
        }
        while (c >= clear) {
            stack[sp++] = suffix[c];
            c = prefix[c];
        }
        stack[sp++] = (uint8_t)c;
        if (next < 4096) {
            prefix[next] = (uint16_t)prev;
            suffix[next] = (uint8_t)c;
            first[next] = first[prev];
            ++next;
            if (next == (1 << width) && width < 12) ++width;
        }
        while (sp && o < count) out[o++] = stack[--sp];
        prev = code;
    }
    return 0;
}

}  // namespace

extern "C" {

// info: width, height, background index, global table entries (0 for
// none), offset of the first block after the table. palette: 256 RGB
// entries (zeros past the table). 0, or -1 with the reason in err.
int mga_gif_header(const uint8_t* d, int64_t n, int32_t* info, uint8_t* palette, char* err, int errlen) {
    if (n < 13 || std::memcmp(d, "GIF8", 4) || (d[4] != '7' && d[4] != '9') || d[5] != 'a')
        return std::snprintf(err, errlen, "not a GIF file"), -1;
    const int flags = d[10];
    const int entries = flags & 0x80 ? 2 << (flags & 7) : 0;
    if (13 + 3 * entries > n) return std::snprintf(err, errlen, "truncated GIF colour table"), -1;
    std::memset(palette, 0, 768);
    std::memcpy(palette, d + 13, 3 * entries);
    info[0] = rd16(d + 6);
    info[1] = rd16(d + 8);
    info[2] = d[11];
    info[3] = entries;
    info[4] = 13 + 3 * entries;
    return 0;
}

// The next image from offset `off` (blocks before it: extensions). info:
// left, top, width, height, interlaced, local table entries (0 for none),
// disposal, delay (1/100 s), transparent index (-1 for none), whether a
// graphic control extension came before the image, the offset after the
// image. palette: the local table's 256 RGB entries. The image's indices go
// to out[0, width * height) in row order (with out null, the LZW data is
// passed over undecoded). Returns 1 for an image, 0 at the trailer, -2 when
// out holds fewer than width * height bytes (info filled), -1 with the
// reason in err.
int mga_gif_frame(const uint8_t* d, int64_t n, int64_t off, int64_t* info, uint8_t* palette, uint8_t* out,
                  int64_t cap, char* err, int errlen) {
    int disposal = 0, delay = 0, transparent = -1, gce = 0;
    for (;;) {
        if (off >= n) return std::snprintf(err, errlen, "truncated GIF (no trailer)"), -1;
        const int block = d[off++];
        if (block == 0x3B) return 0;
        if (block == 0x21) {
            if (off >= n) return std::snprintf(err, errlen, "truncated GIF extension"), -1;
            const int label = d[off++];
            if (label == 0xF9 && off + 6 <= n && d[off] >= 4) {
                const int packed = d[off + 1];
                disposal = (packed >> 2) & 7;
                delay = rd16(d + off + 2);
                transparent = packed & 1 ? d[off + 4] : -1;
                gce = 1;
            }
            off = sub_blocks(d, n, off, nullptr);
            if (off < 0) return std::snprintf(err, errlen, "truncated GIF extension"), -1;
            continue;
        }
        if (block != 0x2C)
            return std::snprintf(err, errlen, "corrupt GIF (block 0x%02x at %lld)", block, (long long)(off - 1)), -1;
        if (off + 9 > n) return std::snprintf(err, errlen, "truncated GIF image descriptor"), -1;
        const int x = rd16(d + off), y = rd16(d + off + 2), w = rd16(d + off + 4), h = rd16(d + off + 6);
        const int flags = d[off + 8];
        off += 9;
        const int entries = flags & 0x80 ? 2 << (flags & 7) : 0;
        if (off + 3 * entries > n) return std::snprintf(err, errlen, "truncated GIF colour table"), -1;
        std::memset(palette, 0, 768);
        std::memcpy(palette, d + off, 3 * entries);
        off += 3 * entries;
        const int interlaced = (flags >> 6) & 1;
        const int64_t vals[10] = {x, y, w, h, interlaced, entries, disposal, delay, transparent, gce};
        std::memcpy(info, vals, sizeof vals);
        if (off >= n) return std::snprintf(err, errlen, "truncated GIF image"), -1;
        const int min_size = d[off++];
        std::vector<uint8_t> codes;
        off = sub_blocks(d, n, off, &codes);
        if (off < 0) return std::snprintf(err, errlen, "truncated GIF image data"), -1;
        info[10] = off;
        const int64_t count = (int64_t)w * h;
        if (!out) return 1;
        if (cap < count) return -2;
        if (!count) return 1;
        if (min_size < 2 || min_size > 8)
            return std::snprintf(err, errlen, "corrupt GIF image (LZW minimum code size %d)", min_size), -1;
        std::vector<uint8_t> rows(interlaced ? count : 0);
        uint8_t* dst = interlaced ? rows.data() : out;
        const int rc = lzw(codes, min_size, dst, count);
        if (rc == -1) return std::snprintf(err, errlen, "corrupt GIF LZW data (a code its table does not hold)"), -1;
        if (rc == -2) return std::snprintf(err, errlen, "the GIF LZW data ends before the image is full"), -1;
        if (interlaced) {  // passes of rows 0 mod 8, 4 mod 8, 2 mod 4, 1 mod 2
            static const int start[4] = {0, 4, 2, 1}, step[4] = {8, 8, 4, 2};
            int64_t r = 0;
            for (int p = 0; p < 4; ++p)
                for (int row = start[p]; row < h; row += step[p], ++r)
                    std::memcpy(out + (int64_t)row * w, rows.data() + r * w, w);
        }
        return 1;
    }
}

}  // extern "C"
