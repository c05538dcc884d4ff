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

}  // extern "C"
