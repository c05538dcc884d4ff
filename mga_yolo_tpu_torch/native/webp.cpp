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
// VP8: a key frame as vp8.cpp decodes it (RFC 6386, with libwebp's test for
// a macroblock without coefficients), then libwebp's fancy upsampling of the
// chroma and its fixed-point YUV -> BGR (14-bit coefficients).
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

// vp8.cpp: a lossy still's key frame into macroblock-aligned planes
extern "C" int mga_vp8_still(const uint8_t* data, int64_t n, int32_t w, int32_t h, uint8_t* y, uint8_t* u,
                             uint8_t* v, char* err, int errlen);

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

// A VP8 key frame's planes (vp8.cpp) to BGR: libwebp's fancy upsampling
// of the chroma and its fixed-point YUV -> BGR (14-bit coefficients).
struct Vp8Emit {
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

    static void emit(const uint8_t* Y, const uint8_t* U, const uint8_t* V, int ystride, int uvstride, int w, int h,
                     uint8_t* bgr) {
        const int rs = w * 3;
        auto yr = [&](int r) { return Y + (size_t)r * ystride; };
        auto ur = [&](int r) { return U + (size_t)r * uvstride; };
        auto vr = [&](int r) { return V + (size_t)r * uvstride; };
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
        const int ystride = (w + 15) / 16 * 16, rows = (h + 15) / 16 * 16;
        std::vector<uint8_t> y((size_t)ystride * rows), u((size_t)ystride * rows / 4), v(u.size());
        char why[256] = {0};
        if (mga_vp8_still(data, n, w, h, y.data(), u.data(), v.data(), why, sizeof(why))) fail(why);
        Vp8Emit::emit(y.data(), u.data(), v.data(), ystride, ystride / 2, w, h, out);
    });
}

}  // extern "C"
