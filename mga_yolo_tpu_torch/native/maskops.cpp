// Host C++ for the data loader of the PyTorch port: the mask pyramid and
// PNG row unfiltering, per sample, on the host's CPU.
//
// The port's own copy of mga_yolo_tpu/native/maskops.cpp, plus the PNG
// unfilter of data/image_io.py. The loader runs these per sample in its
// worker threads (ctypes releases the GIL for the call), where numpy's
// per-row Python loops would bound the pipeline: Zhang-Suen thinning
// iterates to convergence, and PNG's Sub/Average/Paeth filters make every
// byte depend on its left neighbour. Each function has a numpy twin in
// data/mask_ops.py or data/image_io.py that the tests hold it equal to.
//
// Exposed (extern "C"):
//   block_reduce_max_u8   - stride-k block max (maxpool downsample)
//   block_reduce_mean_u8  - stride-k block mean -> float32 (prob masks)
//   zhang_suen_thin_u8    - in-place thinning to a 1-px skeleton
//   rasterize_edges_u8    - Bresenham lines of skeleton edges on coarse grid
//   close3x3_u8           - 3x3 morphological closing (bridge)
//   png_unfilter_u8       - undo PNG's per-row filters (types 0-4)
//   png_unpack_u8         - 1/2/4-bit samples to one byte each, scaled
//   png_adam7_scatter_u8  - one Adam7 pass's pixels into the whole image
//   png_strip16_u8        - 16-bit big-endian samples to their high byte
//   png_rgb16_to_gray_u8  - libpng's 16-bit rgb_to_gray, then the strip
//   bgr_to_gray_u8        - BGR -> grey with cv2's, libtiff-raster or libpng weights
//   gray_to_bgr_u8        - grey replicated into B, G and R

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// out[(H+k-1)/k, (W+k-1)/k] = max over each k x k block of in[H, W]
void block_reduce_max_u8(const uint8_t* in, uint8_t* out, int H, int W, int k) {
    int Hc = (H + k - 1) / k, Wc = (W + k - 1) / k;
    std::memset(out, 0, (size_t)Hc * Wc);
    for (int y = 0; y < H; ++y) {
        const uint8_t* row = in + (size_t)y * W;
        uint8_t* orow = out + (size_t)(y / k) * Wc;
        for (int x = 0; x < W; ++x) {
            uint8_t v = row[x];
            uint8_t& o = orow[x / k];
            if (v > o) o = v;
        }
    }
}

void block_reduce_mean_u8(const uint8_t* in, float* out, int H, int W, int k) {
    int Hc = (H + k - 1) / k, Wc = (W + k - 1) / k;
    std::vector<uint32_t> acc((size_t)Hc * Wc, 0);
    for (int y = 0; y < H; ++y) {
        const uint8_t* row = in + (size_t)y * W;
        uint32_t* arow = acc.data() + (size_t)(y / k) * Wc;
        for (int x = 0; x < W; ++x) arow[x / k] += row[x] > 0 ? 1u : 0u;
    }
    float inv = 1.0f / (float)(k * k);
    for (size_t i = 0; i < acc.size(); ++i) out[i] = acc[i] * inv;
}

// One Zhang–Suen subiteration; returns number of deleted pixels.
static int zs_pass(uint8_t* img, uint8_t* del, int H, int W, int step) {
    int removed = 0;
    std::memset(del, 0, (size_t)H * W);
    for (int y = 1; y < H - 1; ++y) {
        for (int x = 1; x < W - 1; ++x) {
            size_t i = (size_t)y * W + x;
            if (!img[i]) continue;
            // neighbors P2..P9 clockwise from north
            uint8_t p2 = img[i - W], p3 = img[i - W + 1], p4 = img[i + 1],
                    p5 = img[i + W + 1], p6 = img[i + W], p7 = img[i + W - 1],
                    p8 = img[i - 1], p9 = img[i - W - 1];
            int B = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9;
            if (B < 2 || B > 6) continue;
            int A = (!p2 && p3) + (!p3 && p4) + (!p4 && p5) + (!p5 && p6) +
                    (!p6 && p7) + (!p7 && p8) + (!p8 && p9) + (!p9 && p2);
            if (A != 1) continue;
            if (step == 0) {
                if ((p2 && p4 && p6) || (p4 && p6 && p8)) continue;
            } else {
                if ((p2 && p4 && p8) || (p2 && p6 && p8)) continue;
            }
            del[i] = 1;
            ++removed;
        }
    }
    if (removed) {
        size_t n = (size_t)H * W;
        for (size_t i = 0; i < n; ++i)
            if (del[i]) img[i] = 0;
    }
    return removed;
}

// In-place thinning of a {0,1} image to a 1-px skeleton.
void zhang_suen_thin_u8(uint8_t* img, int H, int W, int max_iters) {
    std::vector<uint8_t> del((size_t)H * W);
    for (int it = 0; it < max_iters; ++it) {
        int r0 = zs_pass(img, del.data(), H, W, 0);
        int r1 = zs_pass(img, del.data(), H, W, 1);
        if (r0 + r1 == 0) break;
    }
}

// Bresenham line on a coarse uint8 grid.
static void draw_line(uint8_t* out, int Hc, int Wc, int x0, int y0, int x1, int y1) {
    int dx = std::abs(x1 - x0), sx = x0 < x1 ? 1 : -1;
    int dy = -std::abs(y1 - y0), sy = y0 < y1 ? 1 : -1;
    int err = dx + dy;
    for (;;) {
        if (x0 >= 0 && x0 < Wc && y0 >= 0 && y0 < Hc) out[(size_t)y0 * Wc + x0] = 1;
        if (x0 == x1 && y0 == y1) break;
        int e2 = 2 * err;
        if (e2 >= dy) { err += dy; x0 += sx; }
        if (e2 <= dx) { err += dx; y0 += sy; }
    }
}

// edges: N x 4 int32 rows (y0, x0, y1, x1) in FINE coords; draws the
// projected (//factor) segments on the coarse grid.
void rasterize_edges_u8(const int32_t* edges, int n_edges, int factor,
                        uint8_t* out, int Hc, int Wc) {
    for (int e = 0; e < n_edges; ++e) {
        const int32_t* r = edges + (size_t)e * 4;
        int y0 = r[0] / factor, x0 = r[1] / factor;
        int y1 = r[2] / factor, x1 = r[3] / factor;
        if (y0 == y1 && x0 == x1) continue;
        draw_line(out, Hc, Wc, x0, y0, x1, y1);
    }
}

// 3x3 binary closing (dilate then erode), border-replicate-free (zero pad).
void close3x3_u8(const uint8_t* in, uint8_t* out, int H, int W) {
    std::vector<uint8_t> dil((size_t)H * W, 0);
    for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x) {
            uint8_t v = 0;
            for (int dy = -1; dy <= 1 && !v; ++dy)
                for (int dx = -1; dx <= 1; ++dx) {
                    int yy = y + dy, xx = x + dx;
                    if (yy >= 0 && yy < H && xx >= 0 && xx < W && in[(size_t)yy * W + xx]) {
                        v = 1;
                        break;
                    }
                }
            dil[(size_t)y * W + x] = v;
        }
    for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x) {
            uint8_t v = 1;
            for (int dy = -1; dy <= 1 && v; ++dy)
                for (int dx = -1; dx <= 1; ++dx) {
                    int yy = y + dy, xx = x + dx;
                    // cv2 erode treats out-of-border as padded with the
                    // replicated border for BORDER_CONSTANT(+inf); match
                    // cv2.morphologyEx(MORPH_CLOSE) by ignoring outside
                    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
                    if (!dil[(size_t)yy * W + xx]) {
                        v = 0;
                        break;
                    }
                }
            out[(size_t)y * W + x] = v;
        }
}

// PNG rows: in is h rows of (1 + stride) bytes, a filter type then the
// filtered row; out is h rows of stride bytes; bpp bytes per pixel (>= 1).
// Returns 0, or 1 + the row index whose filter type is not 0-4.
int png_unfilter_u8(const uint8_t* in, uint8_t* out, int h, int stride, int bpp) {
    for (int y = 0; y < h; ++y) {
        const uint8_t* f = in + (size_t)y * (stride + 1);
        uint8_t* r = out + (size_t)y * stride;
        const uint8_t* p = y ? r - stride : nullptr;  // the previous row, reconstructed
        const uint8_t* s = f + 1;
        switch (f[0]) {
            case 0:
                std::memcpy(r, s, stride);
                break;
            case 1:
                for (int x = 0; x < stride; ++x) r[x] = s[x] + (x >= bpp ? r[x - bpp] : 0);
                break;
            case 2:
                for (int x = 0; x < stride; ++x) r[x] = s[x] + (p ? p[x] : 0);
                break;
            case 3:
                for (int x = 0; x < stride; ++x) {
                    int a = x >= bpp ? r[x - bpp] : 0, b = p ? p[x] : 0;
                    r[x] = s[x] + (uint8_t)((a + b) >> 1);
                }
                break;
            case 4:
                for (int x = 0; x < stride; ++x) {
                    int a = x >= bpp ? r[x - bpp] : 0, b = p ? p[x] : 0;
                    int c = (p && x >= bpp) ? p[x - bpp] : 0;
                    int q = a + b - c, pa = std::abs(q - a), pb = std::abs(q - b), pc = std::abs(q - c);
                    r[x] = s[x] + (uint8_t)((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c));
                }
                break;
            default:
                return y + 1;
        }
    }
    return 0;
}

// Unpacked rows: in is h rows of stride bytes holding n samples of depth
// 1, 2 or 4 bits each, the first in the high bits; out is h rows of n
// bytes, each sample times scale (libpng's grey expansion to 8 bits is
// 255, 85 or 17; palette indices take 1).
void png_unpack_u8(const uint8_t* in, uint8_t* out, int h, int stride, int n, int depth, int scale) {
    const int per = 8 / depth, mask = (1 << depth) - 1;
    for (int y = 0; y < h; ++y) {
        const uint8_t* r = in + (size_t)y * stride;
        uint8_t* o = out + (size_t)y * n;
        for (int x = 0; x < n; ++x) {
            int shift = 8 - depth * (x % per + 1);
            o[x] = (uint8_t)(((r[x / per] >> shift) & mask) * scale);
        }
    }
}

// Adam7 pass p (0-6) of pw x ph pixels of px bytes each, into out, the
// whole image of w pixels a row: pixel (y, x) of the pass lands at row
// y0 + y * dy, column x0 + x * dx.
void png_adam7_scatter_u8(const uint8_t* pass, int pw, int ph, int p, int px, uint8_t* out, int w) {
    static const int X0[7] = {0, 4, 0, 2, 0, 1, 0}, Y0[7] = {0, 0, 4, 0, 2, 0, 1};
    static const int DX[7] = {8, 8, 4, 4, 2, 2, 1}, DY[7] = {8, 8, 8, 4, 4, 2, 2};
    for (int y = 0; y < ph; ++y) {
        uint8_t* o = out + ((size_t)(Y0[p] + y * DY[p]) * w + X0[p]) * px;
        const uint8_t* s = pass + (size_t)y * pw * px;
        for (int x = 0; x < pw; ++x) std::memcpy(o + (size_t)x * DX[p] * px, s + (size_t)x * px, px);
    }
}

// png_set_strip_16: each big-endian 16-bit sample's high byte.
void png_strip16_u8(const uint8_t* in, uint8_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = in[2 * i];
}

// libpng's rgb_to_gray on 16-bit samples (RGB or RGBA, alpha ignored) with
// cv2's weights 0.299, 0.587 in 15-bit fixed point, rounded, before the
// strip to 8 bits takes the high byte: libpng converts before it strips.
void png_rgb16_to_gray_u8(const uint8_t* in, uint8_t* out, int64_t npx, int channels) {
    for (int64_t i = 0; i < npx; ++i) {
        const uint8_t* s = in + i * channels * 2;
        uint32_t r = (s[0] << 8) | s[1], g = (s[2] << 8) | s[3], b = (s[4] << 8) | s[5];
        out[i] = (uint8_t)(((9797 * r + 19234 * g + 3737 * b + 16384) >> 15) >> 8);
    }
}

// Grey from BGR pixels (stride 3), with the weights of one of cv2's
// conversions: 0 cvtColor's BGR2GRAY (15-bit, rounded), 1 the BGRA2Gray cv2
// applies to libtiff's RGBA raster (14-bit, rounded), 2 libpng's
// rgb_to_gray at 8 bits (15-bit, truncated).
void bgr_to_gray_u8(const uint8_t* bgr, uint8_t* out, int64_t npx, int kind) {
    static const uint32_t W[3][5] = {{3735, 19235, 9798, 16384, 15}, {1868, 9617, 4899, 8192, 14},
                                     {3737, 19234, 9797, 0, 15}};
    const uint32_t* w = W[kind];
    for (int64_t i = 0; i < npx; ++i) {
        const uint8_t* p = bgr + 3 * i;
        out[i] = (uint8_t)((p[0] * w[0] + p[1] * w[1] + p[2] * w[2] + w[3]) >> w[4]);
    }
}

void gray_to_bgr_u8(const uint8_t* gray, int64_t stride, uint8_t* out, int64_t npx) {
    for (int64_t i = 0; i < npx; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = gray[i * stride];
}

}  // extern "C"
