// WebP decoding for data/image_io.py, as libwebp decodes it for cv2
// (WebPDecodeBGRInto): VP8L (lossless) and VP8 (lossy) bitstreams to BGR.
//
// image_io.py parses the RIFF container (VP8X, ALPH, EXIF, ANIM / ANMF) and
// hands one frame's bitstream here. Alpha is not decoded: cv2's BGR read
// drops it and libwebp does not multiply it in.
//
// VP8L: the transforms (predictor, cross colour, subtract green, colour
// indexing), the colour cache, meta Huffman codes and LZ77 backward
// references of the WebP lossless format, to ARGB, then B, G, R.
//
// VP8: a key frame as RFC 6386 decodes it (boolean decoder, segments, the
// 16x16, chroma and 4x4 intra predictors on the unfiltered reconstruction,
// dequantisation, the inverse WHT and DCT, the simple and normal loop
// filters with segment and mode deltas), then libwebp's fancy upsampling
// of the chroma and its fixed-point YUV -> BGR (14-bit coefficients).
//
// No global state; every read is bounds-checked: a cut or corrupt file is
// refused with a message, never read past its end.
//
// Exposed (extern "C"):
//   mga_webp_vp8l_decode - a VP8L bitstream to (h, w, 3) BGR
//   mga_webp_vp8_decode  - a VP8 key frame to (h, w, 3) BGR

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <vector>

namespace {

struct Fail {
    std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Fail{msg}; }

// ======================================================================= VP8L

// Little-endian bit reader; reads past the end give zeros and are counted.
struct LBits {
    const uint8_t* p;
    int64_t n, next = 0, consumed = 0;
    uint64_t val = 0;
    int bits = 0;

    LBits(const uint8_t* data, int64_t size) : p(data), n(size) {}
    void fill() {
        while (bits <= 56) {
            uint64_t b = next < n ? p[next] : 0;
            ++next;
            val |= b << bits;
            bits += 8;
        }
    }
    uint32_t peek(int k) { return (uint32_t)(val & ((1ull << k) - 1)); }
    void skip(int k) {
        val >>= k;
        bits -= k;
        consumed += k;
    }
    uint32_t read(int k) {
        if (k == 0) return 0;
        fill();
        uint32_t v = peek(k);
        skip(k);
        return v;
    }
    bool eos() const { return consumed > n * 8; }
};

// A canonical prefix code: an 8-bit first-level table, the rest walked a
// bit at a time; a code of one symbol takes no bits.
struct Huff {
    std::vector<uint32_t> table;  // (length << 16) | symbol for codes of <= 8 bits, 0 otherwise
    std::vector<uint16_t> count, symbols;
    int single = -1;

    void build(const std::vector<int>& lengths) {
        const int n = (int)lengths.size();
        count.assign(16, 0);
        int nonzero = 0, last = 0;
        for (int s = 0; s < n; ++s) {
            if (lengths[s] < 0 || lengths[s] > 15) fail("corrupt VP8L prefix code");
            if (lengths[s]) ++count[lengths[s]], ++nonzero, last = s;
        }
        if (nonzero == 0) fail("VP8L prefix code without symbols");
        if (nonzero == 1) {
            single = last;
            return;
        }
        int open = 1;
        for (int l = 1; l < 16; ++l) {
            open = 2 * open - count[l];
            if (open < 0) fail("over-subscribed VP8L prefix code");
        }
        if (open != 0) fail("incomplete VP8L prefix code");
        std::vector<int> offs(16, 0);
        for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + count[l];
        symbols.assign(nonzero, 0);
        for (int s = 0; s < n; ++s)
            if (lengths[s]) symbols[offs[lengths[s]]++] = (uint16_t)s;
        table.assign(256, 0);
        int code = 0, k = 0;
        for (int l = 1; l <= 8; ++l) {
            for (int i = 0; i < count[l]; ++i, ++code, ++k) {
                int rev = 0;
                for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
                for (int j = rev; j < 256; j += 1 << l) table[j] = ((uint32_t)l << 16) | symbols[k];
            }
            code <<= 1;
        }
    }
    int read(LBits& br) const {
        if (single >= 0) return single;
        br.fill();
        uint32_t e = table[br.peek(8)];
        if (e) {
            br.skip((int)(e >> 16));
            return (int)(e & 0xFFFF);
        }
        uint32_t window = br.peek(15);
        int code = 0, first = 0, index = 0;
        for (int l = 1; l < 16; ++l) {
            code |= (window >> (l - 1)) & 1;
            int c = count[l];
            if (code - first < c) {
                br.skip(l);
                return symbols[index + code - first];
            }
            index += c;
            first += c;
            first <<= 1;
            code <<= 1;
        }
        fail("corrupt VP8L data (no prefix code matches)");
    }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
// (dx, dy) of the 120 short distance codes, WebP lossless's distance map
const int8_t kDistMap[120][2] = {
    {0, 1}, {1, 0}, {1, 1}, {-1, 1}, {0, 2}, {2, 0}, {1, 2}, {-1, 2}, {2, 1}, {-2, 1}, {2, 2}, {-2, 2},
    {0, 3}, {3, 0}, {1, 3}, {-1, 3}, {3, 1}, {-3, 1}, {2, 3}, {-2, 3}, {3, 2}, {-3, 2}, {0, 4}, {4, 0},
    {1, 4}, {-1, 4}, {4, 1}, {-4, 1}, {3, 3}, {-3, 3}, {2, 4}, {-2, 4}, {4, 2}, {-4, 2}, {0, 5}, {3, 4},
    {-3, 4}, {4, 3}, {-4, 3}, {5, 0}, {1, 5}, {-1, 5}, {5, 1}, {-5, 1}, {2, 5}, {-2, 5}, {5, 2}, {-5, 2},
    {4, 4}, {-4, 4}, {3, 5}, {-3, 5}, {5, 3}, {-5, 3}, {0, 6}, {6, 0}, {1, 6}, {-1, 6}, {6, 1}, {-6, 1},
    {2, 6}, {-2, 6}, {6, 2}, {-6, 2}, {4, 5}, {-4, 5}, {5, 4}, {-5, 4}, {3, 6}, {-3, 6}, {6, 3}, {-6, 3},
    {0, 7}, {7, 0}, {1, 7}, {-1, 7}, {5, 5}, {-5, 5}, {7, 1}, {-7, 1}, {4, 6}, {-4, 6}, {6, 4}, {-6, 4},
    {2, 7}, {-2, 7}, {7, 2}, {-7, 2}, {3, 7}, {-3, 7}, {7, 3}, {-7, 3}, {5, 6}, {-5, 6}, {6, 5}, {-6, 5},
    {8, 0}, {4, 7}, {-4, 7}, {7, 4}, {-7, 4}, {8, 1}, {8, 2}, {6, 6}, {-6, 6}, {8, 3}, {5, 7}, {-5, 7},
    {7, 5}, {-7, 5}, {8, 4}, {6, 7}, {-6, 7}, {7, 6}, {-7, 6}, {8, 5}, {7, 7}, {-7, 7}, {8, 6}, {8, 7}};

struct Group {
    Huff h[5];  // green + lengths + cache, red, blue, alpha, distance
};

struct Transform {
    int type, bits, xsize;
    std::vector<uint32_t> data;
};

struct Vp8l {
    LBits br;
    int width, height;
    unsigned seen = 0;
    std::vector<Transform> transforms;

    Vp8l(const uint8_t* p, int64_t n) : br(p, n) {}

    static int sub(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

    void read_code(int alphabet, Huff& out) {
        std::vector<int> lengths(alphabet, 0);
        if (br.read(1)) {  // simple code: one or two symbols
            int num = (int)br.read(1) + 1;
            int s0 = (int)br.read(br.read(1) ? 8 : 1);
            if (s0 >= alphabet) fail("corrupt VP8L prefix code (symbol past its alphabet)");
            lengths[s0] = 1;
            if (num == 2) {
                int s1 = (int)br.read(8);
                if (s1 >= alphabet) fail("corrupt VP8L prefix code (symbol past its alphabet)");
                lengths[s1] = 1;
            }
        } else {
            std::vector<int> cl(19, 0);
            int num_codes = (int)br.read(4) + 4;
            for (int i = 0; i < num_codes; ++i) cl[kCodeLengthOrder[i]] = (int)br.read(3);
            Huff lc;
            lc.build(cl);
            int max_symbol = alphabet;
            if (br.read(1)) {
                int nbits = 2 + 2 * (int)br.read(3);
                max_symbol = 2 + (int)br.read(nbits);
                if (max_symbol > alphabet) fail("corrupt VP8L code lengths");
            }
            int symbol = 0, prev = 8;
            while (symbol < alphabet) {
                if (max_symbol-- == 0) break;
                int len = lc.read(br);
                if (len < 16) {
                    lengths[symbol++] = len;
                    if (len) prev = len;
                } else {
                    static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
                    int repeat = (int)br.read(extra[len - 16]) + offset[len - 16];
                    if (symbol + repeat > alphabet) fail("corrupt VP8L code lengths");
                    int v = len == 16 ? prev : 0;
                    while (repeat-- > 0) lengths[symbol++] = v;
                }
            }
        }
        if (br.eos()) fail("truncated VP8L data");
        out.build(lengths);
    }

    static int copy_value(int sym, LBits& br) {
        if (sym < 4) return sym + 1;
        int extra = (sym - 2) >> 1;
        int offset = (2 + (sym & 1)) << extra;
        return offset + (int)br.read(extra) + 1;
    }

    // One entropy-coded image of xsize x ysize ARGB pixels (level0: the main
    // image, which may have transforms and a meta prefix-code image).
    std::vector<uint32_t> image(int xsize, int ysize, bool level0) {
        if (level0) {
            while (br.read(1)) {
                Transform t;
                t.type = (int)br.read(2);
                if (seen & (1u << t.type)) fail("VP8L transform repeated");
                seen |= 1u << t.type;
                t.xsize = xsize;
                t.bits = 0;
                if (t.type == 0 || t.type == 1) {
                    t.bits = (int)br.read(3) + 2;
                    t.data = image(sub(xsize, t.bits), sub(height, t.bits), false);
                } else if (t.type == 3) {
                    int num = (int)br.read(8) + 1;
                    t.bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
                    std::vector<uint32_t> pal = image(num, 1, false);
                    t.data.assign((size_t)1 << (8 >> t.bits), 0);
                    for (int i = 0; i < num; ++i) {  // each entry a delta of the one before, per channel
                        uint32_t d = pal[i], p = i ? t.data[i - 1] : 0;
                        t.data[i] = (((d & 0xff00ff00u) + (p & 0xff00ff00u)) & 0xff00ff00u) |
                                    (((d & 0x00ff00ffu) + (p & 0x00ff00ffu)) & 0x00ff00ffu);
                    }
                    xsize = sub(xsize, t.bits);
                }
                transforms.push_back(std::move(t));
            }
        }
        int cache_bits = 0;
        if (br.read(1)) {
            cache_bits = (int)br.read(4);
            if (cache_bits < 1 || cache_bits > 11) fail("VP8L colour cache of " + std::to_string(cache_bits) + " bits");
        }
        int meta_bits = 0, meta_w = 0;
        std::vector<uint32_t> meta;
        int groups = 1;
        if (level0 && br.read(1)) {
            meta_bits = (int)br.read(3) + 2;
            meta_w = sub(xsize, meta_bits);
            meta = image(meta_w, sub(ysize, meta_bits), false);
            for (auto& m : meta) {
                m = (m >> 8) & 0xffff;
                if ((int)m + 1 > groups) groups = (int)m + 1;
            }
        }
        const int cache_size = cache_bits ? 1 << cache_bits : 0;
        std::vector<Group> g(groups);
        for (auto& grp : g) {
            static const int sizes[5] = {256 + 24, 256, 256, 256, 40};
            for (int i = 0; i < 5; ++i) read_code(sizes[i] + (i == 0 ? cache_size : 0), grp.h[i]);
        }
        std::vector<uint32_t> data((size_t)xsize * ysize);
        std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
        const int64_t total = (int64_t)xsize * ysize;
        int64_t src = 0, cached = 0;
        int col = 0, row = 0;
        auto insert = [&](int64_t upto) {
            if (!cache_size) return;
            for (; cached < upto; ++cached) cache[(data[cached] * 0x1e35a7bdu) >> (32 - cache_bits)] = data[cached];
        };
        while (src < total) {
            const Group& grp = meta_bits ? g[meta[(size_t)(row >> meta_bits) * meta_w + (col >> meta_bits)]] : g[0];
            int code = grp.h[0].read(br);
            if (code < 256) {
                int red = grp.h[1].read(br), blue = grp.h[2].read(br), alpha = grp.h[3].read(br);
                if (br.eos()) fail("truncated VP8L data");
                data[src++] = ((uint32_t)alpha << 24) | (red << 16) | (code << 8) | blue;
                if (++col >= xsize) col = 0, ++row;
            } else if (code < 256 + 24) {
                int length = copy_value(code - 256, br);
                int dsym = grp.h[4].read(br);
                int dcode = copy_value(dsym, br);
                int64_t dist;
                if (dcode > 120) {
                    dist = dcode - 120;
                } else {
                    dist = (int64_t)kDistMap[dcode - 1][0] + (int64_t)kDistMap[dcode - 1][1] * xsize;
                    if (dist < 1) dist = 1;
                }
                if (br.eos()) fail("truncated VP8L data");
                if (src < dist || total - src < length) fail("corrupt VP8L data (a copy outside the image)");
                for (int i = 0; i < length; ++i, ++src) data[src] = data[src - dist];
                col += length;
                while (col >= xsize) col -= xsize, ++row;
            } else {
                int key = code - 256 - 24;
                if (key >= cache_size) fail("corrupt VP8L data (a colour cache code past the cache)");
                insert(src);
                data[src++] = cache[key];
                if (++col >= xsize) col = 0, ++row;
            }
            insert(src);
        }
        if (br.eos()) fail("truncated VP8L data");
        return data;
    }

    static uint32_t add(uint32_t a, uint32_t b) {
        return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
               (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
    }
    static uint32_t avg2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
    static int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
    static uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
        int d = 0;
        for (int s = 0; s < 32; s += 8) {
            int a = (t >> s) & 0xff, b = (l >> s) & 0xff, c = (tl >> s) & 0xff;
            d += std::abs(b - c) - std::abs(a - c);
        }
        return d <= 0 ? t : l;
    }
    static uint32_t full(uint32_t a, uint32_t b, uint32_t c) {
        uint32_t out = 0;
        for (int s = 0; s < 32; s += 8)
            out |= (uint32_t)clip255((int)((a >> s) & 0xff) + (int)((b >> s) & 0xff) - (int)((c >> s) & 0xff)) << s;
        return out;
    }
    static uint32_t half(uint32_t l, uint32_t t, uint32_t tl) {
        uint32_t ave = avg2(l, t), out = 0;
        for (int s = 0; s < 32; s += 8) {
            int a = (ave >> s) & 0xff, b = (tl >> s) & 0xff;
            out |= (uint32_t)clip255(a + (a - b) / 2) << s;
        }
        return out;
    }
    static uint32_t predict(int mode, uint32_t L, const uint32_t* top) {
        switch (mode) {
            case 1: return L;
            case 2: return top[0];
            case 3: return top[1];
            case 4: return top[-1];
            case 5: return avg2(avg2(L, top[1]), top[0]);
            case 6: return avg2(L, top[-1]);
            case 7: return avg2(L, top[0]);
            case 8: return avg2(top[-1], top[0]);
            case 9: return avg2(top[0], top[1]);
            case 10: return avg2(avg2(L, top[-1]), avg2(top[0], top[1]));
            case 11: return select(top[0], L, top[-1]);
            case 12: return full(L, top[0], top[-1]);
            case 13: return half(L, top[0], top[-1]);
            default: return 0xff000000u;
        }
    }

    // The inverse of transform t, in place (colour indexing widens the rows).
    void invert(const Transform& t, std::vector<uint32_t>& px) {
        const int w = t.xsize, h = height;
        if (t.type == 0) {
            const int tiles = sub(w, t.bits);
            for (int y = 0; y < h; ++y) {
                uint32_t* row = px.data() + (size_t)y * w;
                for (int x = 0; x < w; ++x) {
                    uint32_t pred;
                    if (y == 0) pred = x == 0 ? 0xff000000u : row[x - 1];
                    else if (x == 0) pred = row[-w];
                    else pred = predict((t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)] >> 8) & 0xf, row[x - 1],
                                        row - w + x);
                    row[x] = add(row[x], pred);
                }
            }
        } else if (t.type == 1) {
            const int tiles = sub(w, t.bits);
            for (int y = 0; y < h; ++y) {
                uint32_t* row = px.data() + (size_t)y * w;
                for (int x = 0; x < w; ++x) {
                    uint32_t m = t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)];
                    int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff), r2b = (int8_t)((m >> 16) & 0xff);
                    uint32_t argb = row[x];
                    int8_t green = (int8_t)(argb >> 8);
                    int r = (argb >> 16) & 0xff, b = argb & 0xff;
                    r = (r + ((g2r * green) >> 5)) & 0xff;
                    b = (b + ((g2b * green) >> 5) + ((r2b * (int8_t)r) >> 5)) & 0xff;
                    row[x] = (argb & 0xff00ff00u) | ((uint32_t)r << 16) | (uint32_t)b;
                }
            }
        } else if (t.type == 2) {
            for (auto& v : px) {
                uint32_t g = (v >> 8) & 0xff;
                uint32_t rb = ((v & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
                v = (v & 0xff00ff00u) | rb;
            }
        } else {
            const int packed_w = sub(w, t.bits), per = 1 << t.bits, bpp = 8 >> t.bits;
            std::vector<uint32_t> out((size_t)w * h);
            for (int y = 0; y < h; ++y) {
                const uint32_t* src = px.data() + (size_t)y * packed_w;
                uint32_t* dst = out.data() + (size_t)y * w;
                for (int x = 0; x < w; ++x) {
                    uint32_t idx = (src[x >> t.bits] >> 8) & 0xff;
                    idx = (idx >> ((x & (per - 1)) * bpp)) & ((1u << bpp) - 1);
                    dst[x] = t.data[idx];
                }
            }
            px.swap(out);
        }
    }

    void decode(uint8_t* bgr, int w, int h) {
        if (br.read(8) != 0x2f) fail("not a VP8L bitstream (signature)");
        width = (int)br.read(14) + 1;
        height = (int)br.read(14) + 1;
        br.read(1);
        if (br.read(3) != 0) fail("VP8L version is not 0");
        if (width != w || height != h) fail("VP8L size differs from its header");
        std::vector<uint32_t> px = image(width, height, true);
        for (int i = (int)transforms.size() - 1; i >= 0; --i) invert(transforms[i], px);
        for (size_t i = 0; i < px.size(); ++i) {
            bgr[3 * i] = px[i] & 0xff;
            bgr[3 * i + 1] = (px[i] >> 8) & 0xff;
            bgr[3 * i + 2] = (px[i] >> 16) & 0xff;
        }
    }
};

// ======================================================================== VP8

// VP8's constant tables (RFC 6386): the dequantisation steps, the key
// frame's 4x4 intra mode probabilities and the coefficient probabilities.

static const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
static const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};
static const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24};
static const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128};
static const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0}, kCat4[] = {176, 155, 140, 135, 0},
              kCat5[] = {180, 157, 141, 134, 130, 0}, kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
// libwebp's order of the 4x4 intra modes; the 16x16 and chroma modes use DC, TM, VE, HE
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };

// RFC 6386's boolean decoder. Like libwebp's (its "premature end of file"),
// it is at its end once a bit is asked for when every bit of its n bytes has
// been shifted in: that is, more than 8 (n - 1) shifts before the call.
struct BoolDec {
    const uint8_t* p = nullptr;
    const uint8_t* end = nullptr;
    uint32_t value = 0;
    int range = 255, count = 0;
    int64_t shifts = 0, limit = 0;
    bool at_end = false;

    void init(const uint8_t* data, int64_t n) {
        p = data;
        end = data + n;
        range = 255;
        count = 0;
        shifts = 0;
        limit = 8 * (n - 1);
        at_end = n == 0;
        value = (uint32_t)byte() << 8;
        value |= byte();
    }
    uint32_t byte() { return p < end ? *p++ : 0; }
    int get(int prob) {
        if (shifts > limit) at_end = true;
        uint32_t split = 1 + (((uint32_t)(range - 1) * (uint32_t)prob) >> 8);
        uint32_t big = split << 8;
        int bit;
        if (value >= big) {
            range -= (int)split;
            value -= big;
            bit = 1;
        } else {
            range = (int)split;
            bit = 0;
        }
        while (range < 128) {
            value <<= 1;
            range <<= 1;
            ++shifts;
            if (++count == 8) {
                count = 0;
                value |= byte();
            }
        }
        return bit;
    }
    int lit(int n) {
        int v = 0;
        while (n--) v = (v << 1) | get(128);
        return v;
    }
    int signed_lit(int n) {
        int v = lit(n);
        return get(128) ? -v : v;
    }
    bool eof() const { return at_end; }
};

struct MbInfo {
    uint8_t segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
    uint8_t imodes[16] = {0};
};

struct Vp8 {
    int width = 0, height = 0, mb_w = 0, mb_h = 0;
    BoolDec br;
    std::vector<BoolDec> parts;
    // header
    int use_segment = 0, update_map = 0, absolute_delta = 0;
    int quantizer[4] = {0}, filter_strength[4] = {0};
    int seg_probs[3] = {255, 255, 255};
    int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
    int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
    int filter_type = 0;
    int dq[4][3][2];  // segment, (y1, y2, uv), (dc, ac)
    uint8_t proba[4][8][3][11];
    int use_skip = 0, skip_p = 0;
    // frame
    int ystride = 0, uvstride = 0;
    std::vector<uint8_t> Y, U, V;
    std::vector<MbInfo> mbs;
    std::vector<uint8_t> fl_limit, fl_ilevel, fl_hev, fl_inner;

    static int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

    void headers(const uint8_t* data, int64_t n) {
        if (n < 10) fail("truncated VP8 header");
        uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
        int key = !(bits & 1), profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
        uint32_t part0 = bits >> 5;
        if (!key) fail("VP8 data that is not a key frame");
        if (profile > 3) fail("VP8 profile " + std::to_string(profile));
        if (!show) fail("VP8 frame not displayable");
        if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) fail("VP8 start code missing");
        width = (data[6] | (data[7] << 8)) & 0x3fff;
        height = (data[8] | (data[9] << 8)) & 0x3fff;
        if (!width || !height) fail("VP8 frame of no pixels");
        data += 10;
        n -= 10;
        if (part0 > (uint64_t)n) fail("truncated VP8 data (first partition)");
        br.init(data, part0);
        const uint8_t* rest = data + part0;
        int64_t rest_n = n - part0;
        br.get(128);  // colour space
        br.get(128);  // clamping type
        use_segment = br.get(128);
        if (use_segment) {
            update_map = br.get(128);
            if (br.get(128)) {
                absolute_delta = br.get(128);
                for (int s = 0; s < 4; ++s) quantizer[s] = br.get(128) ? br.signed_lit(7) : 0;
                for (int s = 0; s < 4; ++s) filter_strength[s] = br.get(128) ? br.signed_lit(6) : 0;
            }
            if (update_map)
                for (int s = 0; s < 3; ++s) seg_probs[s] = br.get(128) ? br.lit(8) : 255;
        }
        simple = br.get(128);
        level = br.lit(6);
        sharpness = br.lit(3);
        use_lf_delta = br.get(128);
        if (use_lf_delta && br.get(128)) {
            for (int i = 0; i < 4; ++i)
                if (br.get(128)) ref_lf_delta[i] = br.signed_lit(6);
            for (int i = 0; i < 4; ++i)
                if (br.get(128)) mode_lf_delta[i] = br.signed_lit(6);
        }
        filter_type = level == 0 ? 0 : simple ? 1 : 2;
        if (br.eof()) fail("truncated VP8 header");
        // token partitions
        const int nparts = 1 << br.lit(2);
        if (rest_n < 3 * (nparts - 1)) fail("truncated VP8 data (partition sizes)");
        const uint8_t* sz = rest;
        const uint8_t* start = rest + 3 * (nparts - 1);
        int64_t left = rest_n - 3 * (nparts - 1);
        parts.assign(nparts, BoolDec());
        for (int p = 0; p < nparts - 1; ++p) {
            int64_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
            if (psize > left) psize = left;
            parts[p].init(start, psize);
            start += psize;
            left -= psize;
            sz += 3;
        }
        if (left <= 0) fail("truncated VP8 data (token partitions)");
        parts[nparts - 1].init(start, left);
        // quantisers
        const int base_q = br.lit(7);
        int d[5];
        for (int i = 0; i < 5; ++i) d[i] = br.get(128) ? br.signed_lit(4) : 0;
        for (int s = 0; s < 4; ++s) {
            int q = base_q;
            if (use_segment) q = quantizer[s] + (absolute_delta ? 0 : base_q);
            else if (s > 0) {
                std::memcpy(dq[s], dq[0], sizeof(dq[0]));
                continue;
            }
            dq[s][0][0] = kDcTable[clip(q + d[0], 127)];
            dq[s][0][1] = kAcTable[clip(q, 127)];
            dq[s][1][0] = kDcTable[clip(q + d[1], 127)] * 2;
            dq[s][1][1] = (kAcTable[clip(q + d[2], 127)] * 101581) >> 16;
            if (dq[s][1][1] < 8) dq[s][1][1] = 8;
            dq[s][2][0] = kDcTable[clip(q + d[3], 117)];
            dq[s][2][1] = kAcTable[clip(q + d[4], 127)];
        }
        br.get(128);  // refresh entropy probabilities: a single frame either way
        for (int t = 0; t < 4; ++t)
            for (int b = 0; b < 8; ++b)
                for (int c = 0; c < 3; ++c)
                    for (int p = 0; p < 11; ++p)
                        proba[t][b][c][p] = br.get(kCoeffsUpdateProba[t][b][c][p]) ? (uint8_t)br.lit(8)
                                                                                   : kCoeffsProba0[t][b][c][p];
        use_skip = br.get(128);
        if (use_skip) skip_p = br.lit(8);
        if (br.eof()) fail("truncated VP8 header");
    }

    void intra_modes(MbInfo& mb, uint8_t* top, uint8_t* left) {
        if (update_map)
            mb.segment = !br.get(seg_probs[0]) ? br.get(seg_probs[1]) : br.get(seg_probs[2]) + 2;
        if (use_skip) mb.skip = br.get(skip_p);
        mb.is_i4x4 = !br.get(145);
        if (!mb.is_i4x4) {
            int ymode = br.get(156) ? (br.get(128) ? B_TM : B_HE) : (br.get(163) ? B_VE : B_DC);
            mb.imodes[0] = (uint8_t)ymode;
            std::memset(top, ymode, 4);
            std::memset(left, ymode, 4);
        } else {
            for (int y = 0; y < 4; ++y) {
                int ymode = left[y];
                for (int x = 0; x < 4; ++x) {
                    const uint8_t* prob = kBModesProba[top[x]][ymode];
                    ymode = !br.get(prob[0])   ? B_DC
                            : !br.get(prob[1]) ? B_TM
                            : !br.get(prob[2]) ? B_VE
                            : !br.get(prob[3]) ? (!br.get(prob[4]) ? B_HE : (!br.get(prob[5]) ? B_RD : B_VR))
                                               : (!br.get(prob[6]) ? B_LD
                                                  : !br.get(prob[7]) ? B_VL
                                                  : !br.get(prob[8]) ? B_HD
                                                                     : B_HU);
                    top[x] = (uint8_t)ymode;
                    mb.imodes[y * 4 + x] = (uint8_t)ymode;
                }
                left[y] = (uint8_t)ymode;
            }
        }
        mb.uvmode = !br.get(142) ? B_DC : !br.get(114) ? B_VE : br.get(183) ? B_TM : B_HE;
    }

    static int large_value(BoolDec& b, const uint8_t* p) {
        int v;
        if (!b.get(p[3])) {
            v = !b.get(p[4]) ? 2 : 3 + b.get(p[5]);
        } else if (!b.get(p[6])) {
            if (!b.get(p[7])) {
                v = 5 + b.get(159);
            } else {
                v = 7 + 2 * b.get(165);
                v += b.get(145);
            }
        } else {
            const int bit1 = b.get(p[8]);
            const int bit0 = b.get(p[9 + bit1]);
            const int cat = 2 * bit1 + bit0;
            v = 0;
            for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + b.get(*tab);
            v += 3 + (8 << cat);
        }
        return v;
    }

    // The coefficients of one 4x4 block from position n on, dequantised,
    // into out (natural order); returns the position after the last token.
    int coeffs(BoolDec& b, int type, int ctx, const int* q, int n, int16_t* out) {
        const uint8_t* p = proba[type][kBands[n]][ctx];
        for (; n < 16; ++n) {
            if (!b.get(p[0])) return n;
            while (!b.get(p[1])) {
                p = proba[type][kBands[++n]][0];
                if (n == 16) return 16;
            }
            int v;
            if (!b.get(p[2])) {
                v = 1;
                p = proba[type][kBands[n + 1]][1];
            } else {
                v = large_value(b, p);
                p = proba[type][kBands[n + 1]][2];
            }
            const int s = b.get(128) ? -v : v;
            out[kZigzag[n]] = (int16_t)(s * q[n > 0]);
        }
        return 16;
    }

    static void wht(const int16_t* in, int16_t* out) {
        int tmp[16];
        for (int i = 0; i < 4; ++i) {
            const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
            const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
            tmp[0 + i] = a0 + a1;
            tmp[8 + i] = a0 - a1;
            tmp[4 + i] = a3 + a2;
            tmp[12 + i] = a3 - a2;
        }
        for (int i = 0; i < 4; ++i) {
            const int dc = tmp[0 + i * 4] + 3;
            const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
            const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
            out[0] = (int16_t)((a0 + a1) >> 3);
            out[16] = (int16_t)((a3 + a2) >> 3);
            out[32] = (int16_t)((a0 - a1) >> 3);
            out[48] = (int16_t)((a3 - a2) >> 3);
            out += 64;
        }
    }

    static uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
    // in 64 bits: the products overflow 32 only on corrupt coefficients, where libwebp's C is undefined
    static int mul1(int a) { return (int)(((int64_t)a * 20091) >> 16) + a; }
    static int mul2(int a) { return (int)(((int64_t)a * 35468) >> 16); }

    // the inverse DCT of in, added to the 4x4 pixels at dst (stride bps)
    static void idct_add(const int16_t* in, uint8_t* dst, int bps) {
        int C[16], *tmp = C;
        for (int i = 0; i < 4; ++i) {
            const int a = in[0] + in[8], b = in[0] - in[8];
            const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
            tmp[0] = a + d;
            tmp[1] = b + c;
            tmp[2] = b - c;
            tmp[3] = a - d;
            tmp += 4;
            ++in;
        }
        tmp = C;
        for (int i = 0; i < 4; ++i) {
            const int dc = tmp[0] + 4;
            const int a = dc + tmp[8], b = dc - tmp[8];
            const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
            dst[0] = clip8(dst[0] + ((a + d) >> 3));
            dst[1] = clip8(dst[1] + ((b + c) >> 3));
            dst[2] = clip8(dst[2] + ((b - c) >> 3));
            dst[3] = clip8(dst[3] + ((a - d) >> 3));
            ++tmp;
            dst += bps;
        }
    }

    // ---- intra prediction on a work buffer of stride BPS, dst at (0, 0) with row -1 and column -1 filled
    static constexpr int BPS = 32;
    static uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
    static uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

    static void pred_block(uint8_t* dst, int size, int mode, int mb_x, int mb_y) {
        const uint8_t* top = dst - BPS;
        if (mode == B_DC) {
            int dc;
            const int shift = size == 16 ? 4 : 3;
            if (mb_x > 0 && mb_y > 0) {
                dc = size;
                for (int i = 0; i < size; ++i) dc += top[i] + dst[i * BPS - 1];
                dc >>= shift + 1;
            } else if (mb_y > 0) {
                dc = size >> 1;
                for (int i = 0; i < size; ++i) dc += top[i];
                dc >>= shift;
            } else if (mb_x > 0) {
                dc = size >> 1;
                for (int i = 0; i < size; ++i) dc += dst[i * BPS - 1];
                dc >>= shift;
            } else {
                dc = 0x80;
            }
            for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dc, size);
        } else if (mode == B_VE) {
            for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, top, size);
        } else if (mode == B_HE) {
            for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[y * BPS - 1], size);
        } else {  // TrueMotion
            const int tl = top[-1];
            for (int y = 0; y < size; ++y)
                for (int x = 0; x < size; ++x) dst[y * BPS + x] = clip8(top[x] + dst[y * BPS - 1] - tl);
        }
    }

    static void pred4(uint8_t* dst, int mode) {
#define DST(x, y) dst[(x) + (y) * BPS]
        const uint8_t* t = dst - BPS;
        const int X = t[-1], A = t[0], B = t[1], C = t[2], D = t[3], E = t[4], F = t[5], G = t[6], H = t[7];
        const int I = dst[-1], J = dst[BPS - 1], K = dst[2 * BPS - 1], L = dst[3 * BPS - 1];
        switch (mode) {
            case B_DC: {
                int dc = 4;
                for (int i = 0; i < 4; ++i) dc += t[i] + dst[i * BPS - 1];
                dc >>= 3;
                for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, dc, 4);
                break;
            }
            case B_TM:
                for (int y = 0; y < 4; ++y)
                    for (int x = 0; x < 4; ++x) DST(x, y) = clip8(t[x] + dst[y * BPS - 1] - X);
                break;
            case B_VE: {
                const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
                for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
                break;
            }
            case B_HE: {
                const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
                for (int i = 0; i < 4; ++i) std::memset(dst + i * BPS, v[i], 4);
                break;
            }
            case B_RD:
                DST(0, 3) = avg3(J, K, L);
                DST(1, 3) = DST(0, 2) = avg3(I, J, K);
                DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
                DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
                DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
                DST(3, 1) = DST(2, 0) = avg3(C, B, A);
                DST(3, 0) = avg3(D, C, B);
                break;
            case B_LD:
                DST(0, 0) = avg3(A, B, C);
                DST(1, 0) = DST(0, 1) = avg3(B, C, D);
                DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
                DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
                DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
                DST(3, 2) = DST(2, 3) = avg3(F, G, H);
                DST(3, 3) = avg3(G, H, H);
                break;
            case B_VR:
                DST(0, 0) = DST(1, 2) = avg2(X, A);
                DST(1, 0) = DST(2, 2) = avg2(A, B);
                DST(2, 0) = DST(3, 2) = avg2(B, C);
                DST(3, 0) = avg2(C, D);
                DST(0, 3) = avg3(K, J, I);
                DST(0, 2) = avg3(J, I, X);
                DST(0, 1) = DST(1, 3) = avg3(I, X, A);
                DST(1, 1) = DST(2, 3) = avg3(X, A, B);
                DST(2, 1) = DST(3, 3) = avg3(A, B, C);
                DST(3, 1) = avg3(B, C, D);
                break;
            case B_VL:
                DST(0, 0) = avg2(A, B);
                DST(1, 0) = DST(0, 2) = avg2(B, C);
                DST(2, 0) = DST(1, 2) = avg2(C, D);
                DST(3, 0) = DST(2, 2) = avg2(D, E);
                DST(0, 1) = avg3(A, B, C);
                DST(1, 1) = DST(0, 3) = avg3(B, C, D);
                DST(2, 1) = DST(1, 3) = avg3(C, D, E);
                DST(3, 1) = DST(2, 3) = avg3(D, E, F);
                DST(3, 2) = avg3(E, F, G);
                DST(3, 3) = avg3(F, G, H);
                break;
            case B_HU:
                DST(0, 0) = avg2(I, J);
                DST(2, 0) = DST(0, 1) = avg2(J, K);
                DST(2, 1) = DST(0, 2) = avg2(K, L);
                DST(1, 0) = avg3(I, J, K);
                DST(3, 0) = DST(1, 1) = avg3(J, K, L);
                DST(3, 1) = DST(1, 2) = avg3(K, L, L);
                DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
                break;
            default:  // B_HD
                DST(0, 0) = DST(2, 1) = avg2(I, X);
                DST(0, 1) = DST(2, 2) = avg2(J, I);
                DST(0, 2) = DST(2, 3) = avg2(K, J);
                DST(0, 3) = avg2(L, K);
                DST(3, 0) = avg3(A, B, C);
                DST(2, 0) = avg3(X, A, B);
                DST(1, 0) = DST(3, 1) = avg3(I, X, A);
                DST(1, 1) = DST(3, 2) = avg3(J, I, X);
                DST(1, 2) = DST(3, 3) = avg3(K, J, I);
                DST(1, 3) = avg3(L, K, J);
                break;
        }
#undef DST
    }

    // Residuals and reconstruction of macroblock (mb_x, mb_y) into the
    // (unfiltered) planes; returns whether it had no non-zero coefficient.
    bool macroblock(int mb_x, int mb_y, MbInfo& mb, BoolDec& tb, uint8_t* tnz, uint8_t* lnz) {
        int16_t co[25 * 16];
        std::memset(co, 0, sizeof(co));
        const int(*q)[2] = dq[mb.segment];
        // libwebp's test for a macroblock with no non-zero coefficient: per
        // 4x4 block, tokens past the second position or a non-zero DC (a
        // 16x16 block's DC from the WHT)
        bool any = false;
        if (!mb.skip || !use_skip) {
            int first = 0, ytype = 3;
            if (!mb.is_i4x4) {
                int16_t dc[16] = {0};
                const int ctx = tnz[8] + lnz[8];
                const int nz = coeffs(tb, 1, ctx, q[1], 0, dc);
                tnz[8] = lnz[8] = nz > 0;
                wht(dc, co);
                first = 1;
                ytype = 0;
            }
            for (int y = 0; y < 4; ++y)
                for (int x = 0; x < 4; ++x) {
                    int16_t* blk = co + (y * 4 + x) * 16;
                    const int nz = coeffs(tb, ytype, tnz[x] + lnz[y], q[0], first, blk);
                    tnz[x] = lnz[y] = nz > first;
                    any = any || nz > 1 || blk[0] != 0;
                }
            for (int ch = 0; ch < 2; ++ch)
                for (int y = 0; y < 2; ++y)
                    for (int x = 0; x < 2; ++x) {
                        uint8_t& t = tnz[4 + ch * 2 + x];
                        uint8_t& l = lnz[4 + ch * 2 + y];
                        int16_t* blk = co + (16 + ch * 4 + y * 2 + x) * 16;
                        const int nz = coeffs(tb, 2, t + l, q[2], 0, blk);
                        t = l = nz > 0;
                        any = any || nz > 1 || blk[0] != 0;
                    }
        } else {
            for (int i = 0; i < 8; ++i) tnz[i] = lnz[i] = 0;
            if (!mb.is_i4x4) tnz[8] = lnz[8] = 0;
        }
        // the work buffers: row -1 and column -1 around the block, four more pixels top right
        uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
        uint8_t* yd = ybuf + BPS + 1;
        uint8_t* ud = ubuf + BPS + 1;
        uint8_t* vd = vbuf + BPS + 1;
        const int x0 = mb_x * 16, y0 = mb_y * 16;
        for (int pl = 0; pl < 3; ++pl) {
            uint8_t* d = pl == 0 ? yd : pl == 1 ? ud : vd;
            const int size = pl == 0 ? 16 : 8, stride = pl == 0 ? ystride : uvstride;
            const uint8_t* plane = pl == 0 ? Y.data() : pl == 1 ? U.data() : V.data();
            const int px = mb_x * size, py = mb_y * size;
            for (int j = 0; j < size; ++j) d[j * BPS - 1] = mb_x > 0 ? plane[(size_t)(py + j) * stride + px - 1] : 129;
            if (mb_y > 0) {
                std::memcpy(d - BPS, plane + (size_t)(py - 1) * stride + px, size);
                d[-BPS - 1] = mb_x > 0 ? plane[(size_t)(py - 1) * stride + px - 1] : 129;
            } else {
                std::memset(d - BPS - 1, 127, size + 1 + (pl == 0 ? 4 : 0));
            }
        }
        if (mb.is_i4x4) {
            uint8_t* tr = yd - BPS + 16;
            if (mb_y > 0) {
                if (mb_x >= mb_w - 1) std::memset(tr, Y[(size_t)(y0 - 1) * ystride + x0 + 15], 4);
                else std::memcpy(tr, Y.data() + (size_t)(y0 - 1) * ystride + x0 + 16, 4);
            }
            for (int r = 1; r < 4; ++r) std::memcpy(tr + 4 * r * BPS, tr, 4);
            for (int n = 0; n < 16; ++n) {
                uint8_t* dst = yd + (n & 3) * 4 + (n >> 2) * 4 * BPS;
                pred4(dst, mb.imodes[n]);
                idct_add(co + n * 16, dst, BPS);
            }
        } else {
            pred_block(yd, 16, mb.imodes[0], mb_x, mb_y);
            for (int n = 0; n < 16; ++n) idct_add(co + n * 16, yd + (n & 3) * 4 + (n >> 2) * 4 * BPS, BPS);
        }
        pred_block(ud, 8, mb.uvmode, mb_x, mb_y);
        pred_block(vd, 8, mb.uvmode, mb_x, mb_y);
        for (int n = 0; n < 4; ++n) {
            idct_add(co + (16 + n) * 16, ud + (n & 1) * 4 + (n >> 1) * 4 * BPS, BPS);
            idct_add(co + (20 + n) * 16, vd + (n & 1) * 4 + (n >> 1) * 4 * BPS, BPS);
        }
        for (int j = 0; j < 16; ++j) std::memcpy(Y.data() + (size_t)(y0 + j) * ystride + x0, yd + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
            std::memcpy(U.data() + (size_t)(mb_y * 8 + j) * uvstride + mb_x * 8, ud + j * BPS, 8);
            std::memcpy(V.data() + (size_t)(mb_y * 8 + j) * uvstride + mb_x * 8, vd + j * BPS, 8);
        }
        return !any;
    }

    // ---- loop filters (RFC 6386 section 15, libwebp's formulation)
    static int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
    static int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
    static void filter2(uint8_t* p, int s) {
        const int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
        const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
        const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
        p[-s] = clip8(p0 + a2);
        p[0] = clip8(q0 - a1);
    }
    static void filter4(uint8_t* p, int s) {
        const int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
        const int a = 3 * (q0 - p0);
        const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
        p[-2 * s] = clip8(p1 + a3);
        p[-s] = clip8(p0 + a2);
        p[0] = clip8(q0 - a1);
        p[s] = clip8(q1 - a3);
    }
    static void filter6(uint8_t* p, int s) {
        const int p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s], q2 = p[2 * s];
        const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
        const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
        p[-3 * s] = clip8(p2 + a3);
        p[-2 * s] = clip8(p1 + a2);
        p[-s] = clip8(p0 + a1);
        p[0] = clip8(q0 - a1);
        p[s] = clip8(q1 - a2);
        p[2 * s] = clip8(q2 - a3);
    }
    static bool hev(const uint8_t* p, int s, int t) {
        return std::abs(p[-2 * s] - p[-s]) > t || std::abs(p[s] - p[0]) > t;
    }
    static bool needs(const uint8_t* p, int s, int t) {
        return 4 * std::abs(p[-s] - p[0]) + std::abs(p[-2 * s] - p[s]) <= t;
    }
    static bool needs2(const uint8_t* p, int s, int t, int it) {
        const int p3 = p[-4 * s], p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];
        const int q0 = p[0], q1 = p[s], q2 = p[2 * s], q3 = p[3 * s];
        if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
        return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
               std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
    }
    static void simple_edge(uint8_t* p, int hs, int vs, int thresh) {  // 16 pixels along vs
        const int t2 = 2 * thresh + 1;
        for (int i = 0; i < 16; ++i, p += vs)
            if (needs(p, hs, t2)) filter2(p, hs);
    }
    static void edge(uint8_t* p, int hs, int vs, int size, int thresh, int ithresh, int hev_t, bool mb_edge) {
        const int t2 = 2 * thresh + 1;
        for (int i = 0; i < size; ++i, p += vs) {
            if (!needs2(p, hs, t2, ithresh)) continue;
            if (hev(p, hs, hev_t)) filter2(p, hs);
            else if (mb_edge) filter6(p, hs);
            else filter4(p, hs);
        }
    }

    void loop_filter() {
        for (int mb_y = 0; mb_y < mb_h; ++mb_y)
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                const size_t i = (size_t)mb_y * mb_w + mb_x;
                const int limit = fl_limit[i];
                if (limit == 0) continue;
                const int il = fl_ilevel[i], hv = fl_hev[i];
                const bool inner = fl_inner[i];
                uint8_t* y = Y.data() + (size_t)mb_y * 16 * ystride + mb_x * 16;
                uint8_t* u = U.data() + (size_t)mb_y * 8 * uvstride + mb_x * 8;
                uint8_t* v = V.data() + (size_t)mb_y * 8 * uvstride + mb_x * 8;
                if (filter_type == 1) {
                    if (mb_x > 0) simple_edge(y, 1, ystride, limit + 4);
                    if (inner)
                        for (int k = 4; k < 16; k += 4) simple_edge(y + k, 1, ystride, limit);
                    if (mb_y > 0) simple_edge(y, ystride, 1, limit + 4);
                    if (inner)
                        for (int k = 4; k < 16; k += 4) simple_edge(y + k * ystride, ystride, 1, limit);
                } else {
                    if (mb_x > 0) {
                        edge(y, 1, ystride, 16, limit + 4, il, hv, true);
                        edge(u, 1, uvstride, 8, limit + 4, il, hv, true);
                        edge(v, 1, uvstride, 8, limit + 4, il, hv, true);
                    }
                    if (inner) {
                        for (int k = 4; k < 16; k += 4) edge(y + k, 1, ystride, 16, limit, il, hv, false);
                        edge(u + 4, 1, uvstride, 8, limit, il, hv, false);
                        edge(v + 4, 1, uvstride, 8, limit, il, hv, false);
                    }
                    if (mb_y > 0) {
                        edge(y, ystride, 1, 16, limit + 4, il, hv, true);
                        edge(u, uvstride, 1, 8, limit + 4, il, hv, true);
                        edge(v, uvstride, 1, 8, limit + 4, il, hv, true);
                    }
                    if (inner) {
                        for (int k = 4; k < 16; k += 4) edge(y + k * ystride, ystride, 1, 16, limit, il, hv, false);
                        edge(u + 4 * uvstride, uvstride, 1, 8, limit, il, hv, false);
                        edge(v + 4 * uvstride, uvstride, 1, 8, limit, il, hv, false);
                    }
                }
            }
    }

    void decode_frame() {
        mb_w = (width + 15) >> 4;
        mb_h = (height + 15) >> 4;
        ystride = mb_w * 16;
        uvstride = mb_w * 8;
        Y.assign((size_t)ystride * mb_h * 16, 0);
        U.assign((size_t)uvstride * mb_h * 8, 0);
        V.assign(U.size(), 0);
        const size_t nmb = (size_t)mb_w * mb_h;
        fl_limit.assign(nmb, 0);
        fl_ilevel.assign(nmb, 0);
        fl_hev.assign(nmb, 0);
        fl_inner.assign(nmb, 0);
        // filter strength per segment and per 4x4 / 16x16 mode
        int f_limit[4][2] = {{0}}, f_ilevel[4][2] = {{0}}, f_hev[4][2] = {{0}};
        if (filter_type > 0)
            for (int s = 0; s < 4; ++s) {
                int base = level;
                if (use_segment) base = filter_strength[s] + (absolute_delta ? 0 : level);
                for (int i4 = 0; i4 < 2; ++i4) {
                    int lv = base;
                    if (use_lf_delta) lv += ref_lf_delta[0] + (i4 ? mode_lf_delta[0] : 0);
                    lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
                    if (lv > 0) {
                        int il = lv;
                        if (sharpness > 0) {
                            il >>= sharpness > 4 ? 2 : 1;
                            if (il > 9 - sharpness) il = 9 - sharpness;
                        }
                        if (il < 1) il = 1;
                        f_ilevel[s][i4] = il;
                        f_limit[s][i4] = 2 * lv + il;
                        f_hev[s][i4] = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
                    }
                }
            }
        std::vector<uint8_t> intra_t((size_t)mb_w * 4, B_DC);
        std::vector<uint8_t> top_nz((size_t)mb_w * 9, 0);
        std::vector<MbInfo> row(mb_w);
        for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
            uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
            uint8_t left_nz[9] = {0};
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                row[mb_x] = MbInfo();
                intra_modes(row[mb_x], intra_t.data() + 4 * mb_x, intra_l);
            }
            if (br.eof()) fail("truncated VP8 data (first partition)");
            BoolDec& tb = parts[mb_y & (parts.size() - 1)];
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                MbInfo& mb = row[mb_x];
                bool skip = macroblock(mb_x, mb_y, mb, tb, top_nz.data() + 9 * mb_x, left_nz);
                if (tb.eof()) fail("truncated VP8 data (token partition)");
                if (filter_type > 0) {
                    const size_t i = (size_t)mb_y * mb_w + mb_x;
                    fl_limit[i] = (uint8_t)f_limit[mb.segment][mb.is_i4x4];
                    fl_ilevel[i] = (uint8_t)f_ilevel[mb.segment][mb.is_i4x4];
                    fl_hev[i] = (uint8_t)f_hev[mb.segment][mb.is_i4x4];
                    fl_inner[i] = mb.is_i4x4 || !skip;
                }
            }
        }
        if (filter_type > 0) loop_filter();
    }

    // ---- libwebp's fancy upsampler and YUV -> BGR
    static int mult_hi(int v, int c) { return (v * c) >> 8; }
    static uint8_t clip_yuv(int v) { return (v & ~16383) == 0 ? (uint8_t)(v >> 6) : v < 0 ? 0 : 255; }
    static void to_bgr(int y, int u, int v, uint8_t* bgr) {
        bgr[0] = clip_yuv(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
        bgr[1] = clip_yuv(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
        bgr[2] = clip_yuv(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    }
    static void upsample(const uint8_t* ty, const uint8_t* by, const uint8_t* tu, const uint8_t* tv, const uint8_t* cu,
                         const uint8_t* cv, uint8_t* tdst, uint8_t* bdst, int len) {
        auto load = [](int u, int v) { return (uint32_t)u | ((uint32_t)v << 16); };
        const int last = (len - 1) >> 1;
        uint32_t tl = load(tu[0], tv[0]), l = load(cu[0], cv[0]);
        {
            const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
            to_bgr(ty[0], uv0 & 0xff, uv0 >> 16, tdst);
        }
        if (by) {
            const uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
            to_bgr(by[0], uv0 & 0xff, uv0 >> 16, bdst);
        }
        for (int x = 1; x <= last; ++x) {
            const uint32_t t = load(tu[x], tv[x]), uv = load(cu[x], cv[x]);
            const uint32_t avg = tl + t + l + uv + 0x00080008u;
            const uint32_t d12 = (avg + 2 * (t + l)) >> 3, d03 = (avg + 2 * (tl + uv)) >> 3;
            {
                const uint32_t uv0 = (d12 + tl) >> 1, uv1 = (d03 + t) >> 1;
                to_bgr(ty[2 * x - 1], uv0 & 0xff, uv0 >> 16, tdst + (2 * x - 1) * 3);
                to_bgr(ty[2 * x], uv1 & 0xff, uv1 >> 16, tdst + 2 * x * 3);
            }
            if (by) {
                const uint32_t uv0 = (d03 + l) >> 1, uv1 = (d12 + uv) >> 1;
                to_bgr(by[2 * x - 1], uv0 & 0xff, uv0 >> 16, bdst + (2 * x - 1) * 3);
                to_bgr(by[2 * x], uv1 & 0xff, uv1 >> 16, bdst + 2 * x * 3);
            }
            tl = t;
            l = uv;
        }
        if (!(len & 1)) {
            {
                const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
                to_bgr(ty[len - 1], uv0 & 0xff, uv0 >> 16, tdst + (len - 1) * 3);
            }
            if (by) {
                const uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
                to_bgr(by[len - 1], uv0 & 0xff, uv0 >> 16, bdst + (len - 1) * 3);
            }
        }
    }

    void emit(uint8_t* bgr) {
        const int w = width, h = height, rs = w * 3;
        auto yr = [&](int r) { return Y.data() + (size_t)r * ystride; };
        auto ur = [&](int r) { return U.data() + (size_t)r * uvstride; };
        auto vr = [&](int r) { return V.data() + (size_t)r * uvstride; };
        upsample(yr(0), nullptr, ur(0), vr(0), ur(0), vr(0), bgr, nullptr, w);
        int y = 1;
        for (; y + 1 < h; y += 2) {
            const int k = (y + 1) >> 1;
            upsample(yr(y), yr(y + 1), ur(k - 1), vr(k - 1), ur(k), vr(k), bgr + (size_t)y * rs,
                     bgr + (size_t)(y + 1) * rs, w);
        }
        if (y < h) {  // the last row of an even height
            const int k = (h >> 1) - 1;
            upsample(yr(h - 1), nullptr, ur(k), vr(k), ur(k), vr(k), bgr + (size_t)(h - 1) * rs, nullptr, w);
        }
    }
};

int run(char* err, int errlen, const std::function<void()>& fn) {
    try {
        fn();
        return 0;
    } catch (const Fail& f) {
        std::snprintf(err, errlen, "%s", f.msg.c_str());
    } catch (const std::bad_alloc&) {
        std::snprintf(err, errlen, "out of memory");
    }
    return -1;
}
}  // namespace

extern "C" {

// A VP8L bitstream (the chunk's payload, signature byte first) of an image
// of w x h pixels into out, (h, w, 3) BGR. Returns 0, or -1 with the reason.
int mga_webp_vp8l_decode(const uint8_t* data, int64_t n, int32_t w, int32_t h, uint8_t* out, char* err, int errlen) {
    return run(err, errlen, [&] {
        Vp8l d(data, n);
        d.decode(out, w, h);
    });
}

// A VP8 key frame (the "VP8 " chunk's payload) of w x h pixels into out,
// (h, w, 3) BGR. Returns 0, or -1 with the reason.
int mga_webp_vp8_decode(const uint8_t* data, int64_t n, int32_t w, int32_t h, uint8_t* out, char* err, int errlen) {
    return run(err, errlen, [&] {
        Vp8 d;
        d.headers(data, n);
        if (d.width != w || d.height != h) fail("VP8 frame size differs from its header");
        d.decode_frame();
        d.emit(out);
    });
}

}  // extern "C"
