// Colour conversion of video frames, as cv2's video path makes it.
//
// YCbCr -> BGR24: what cv2.VideoCapture hands on for a 4:2:0 or 4:2:2
// frame: swscale's unscaled yuv2rgb converter at the same size, in its x86
// form (16-bit fixed point: each term a signed high-half product, summed and
// saturated to 0..255). Each chroma sample is replicated over its block,
// with no interpolation. JPEG's frames (yuvj*) are full range; MPEG-4's and
// raw I420 frames limited range; both BT.601. The coefficients are derived
// here from the BT.601 inverse matrix, as swscale derives its own.
//
// BGR24 -> YUV 4:2:0 for the MPEG-4 writer: BT.601 limited range (what
// cv2's writer hands the mp4v encoder), luma per pixel and chroma from the
// mean of each 2x2 block, in 15-bit fixed point.
//
// No global state.

#include <algorithm>
#include <cstdint>

namespace {

inline int high16(int a, int b) { return (a * b) >> 16; }  // a signed high-half product (pmulhw)

inline int round16(int64_t x) {  // to a 16-bit coefficient, rounded
  const int64_t v = (x + (1 << 15)) >> 16;
  return (int)std::min<int64_t>(32767, std::max<int64_t>(-32768, v));
}

inline uint8_t sat(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

}  // namespace

extern "C" {

// (h, w, 3) BGR from planes: y (h rows, stride ys), u and v (stride cs), each
// chroma sample covering 2^sx x 2^sy luma samples. full: 1 for JPEG's range.
void mga_yuv_to_bgr(const uint8_t* y, int32_t ys, const uint8_t* u, const uint8_t* v, int32_t cs, int32_t h,
                    int32_t w, int32_t sx, int32_t sy, int32_t full, uint8_t* out) {
  // The BT.601 inverse matrix in 16.16 (Cr->R, Cb->B, Cb->G, Cr->G) for limited-range chroma.
  int64_t crv = 104597, cbu = 132201, cgu = -25675, cgv = -53279;
  int64_t cy = 1 << 16, oy = 0;
  if (full) {  // chroma spans 0..255: the matrix scaled by 224 / 255
    crv = crv * 224 / 255;
    cbu = cbu * 224 / 255;
    cgu = cgu * 224 / 255;
    cgv = cgv * 224 / 255;
  } else {  // luma spans 16..235
    cy = cy * 255 / 219;
    oy = (int64_t)16 << 16;
  }
  const int yc = round16(cy * 8192), yo = round16(oy * 8);
  const int vr = round16(crv * 8192), ub = round16(cbu * 8192), ug = round16(cgu * 8192), vg = round16(cgv * 8192);
  for (int r = 0; r < h; ++r) {
    const uint8_t* yr = y + (int64_t)r * ys;
    const uint8_t* ur = u + (int64_t)(r >> sy) * cs;
    const uint8_t* vr_ = v + (int64_t)(r >> sy) * cs;
    uint8_t* o = out + (int64_t)r * w * 3;
    for (int c = 0; c < w; ++c) {
      const int yy = high16(yr[c] * 8 - yo, yc);
      const int uu = ur[c >> sx] * 8 - 1024, vv = vr_[c >> sx] * 8 - 1024;
      o[3 * c] = sat(yy + high16(uu, ub));
      o[3 * c + 1] = sat(yy + high16(uu, ug) + high16(vv, vg));
      o[3 * c + 2] = sat(yy + high16(vv, vr));
    }
  }
}

// (h, w, 3) BGR, h and w even -> y (h x w), u and v (h/2 x w/2), limited range.
void mga_bgr_to_yuv420(const uint8_t* bgr, int32_t h, int32_t w, uint8_t* y, uint8_t* u, uint8_t* v) {
  constexpr int S = 15;
  auto fix = [](double x) { return (int)(x * (1 << S) + 0.5); };
  const int ry = fix(0.299 * 219 / 255), gy = fix(0.587 * 219 / 255), by = fix(0.114 * 219 / 255);
  const int ru = -fix(0.168736 * 224 / 255), gu = -fix(0.331264 * 224 / 255), bu = fix(0.5 * 224 / 255);
  const int rv = fix(0.5 * 224 / 255), gv = -fix(0.418688 * 224 / 255), bv = -fix(0.081312 * 224 / 255);
  constexpr int half = 1 << (S - 1);
  for (int r = 0; r < h; ++r) {
    const uint8_t* p = bgr + (int64_t)r * w * 3;
    uint8_t* yo = y + (int64_t)r * w;
    for (int c = 0; c < w; ++c) yo[c] = sat(((ry * p[3 * c + 2] + gy * p[3 * c + 1] + by * p[3 * c] + half) >> S) + 16);
  }
  const int cw = w / 2;
  for (int r = 0; r < h / 2; ++r) {
    const uint8_t* p0 = bgr + (int64_t)(2 * r) * w * 3;
    const uint8_t* p1 = p0 + (int64_t)w * 3;
    for (int c = 0; c < cw; ++c) {
      int sb = 0, sg = 0, sr = 0;
      for (const uint8_t* q : {p0 + 6 * c, p0 + 6 * c + 3, p1 + 6 * c, p1 + 6 * c + 3}) {
        sb += q[0];
        sg += q[1];
        sr += q[2];
      }
      // the 2x2 sums carry 2 extra bits
      u[(int64_t)r * cw + c] = sat(((ru * sr + gu * sg + bu * sb + (half << 2)) >> (S + 2)) + 128);
      v[(int64_t)r * cw + c] = sat(((rv * sr + gv * sg + bv * sb + (half << 2)) >> (S + 2)) + 128);
    }
  }
}

}  // extern "C"
