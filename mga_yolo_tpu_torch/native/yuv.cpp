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
// A 4:2:0 frame of odd height is another matter: swscale's unscaled
// converter takes even heights only, so cv2 gets swscale's scaled path at
// the same size with SWS_BICUBIC (mga_yuv_to_bgr_scaled, measured against
// cv2 to the bit on MPEG-1, MPEG-2, MPEG-4 and VP8 frames of odd height, and
// on H.264 frames of odd height in both ranges; a full-range frame takes the
// same path with the full-range matrix and luma table). Chroma is upsampled by swscale's initFilter bicubic filters (B 0,
// C 0.6): vertically from ceil(h/2) rows to h, and horizontally where the
// chroma siting differs (MPEG-2 and MPEG-4 left-sited, MPEG-1 and VP8
// centred) or the width is odd; an odd width forces full horizontal chroma
// (libswscale's "Forcing full internal H chroma due to odd output size")
// and its C output stage (one rounding of 13-bit coefficients at 2^22); an
// even width takes the x86 packed path (each tap a pmulhw, a rounder of 4,
// then the unscaled converter's arithmetic), but for the last two rows,
// which swscale writes with its C functions (its yuv2rgb tables). A frame one
// row high is all last rows: its one-tap stage is those C functions
// (measured on MJPEG frames 1 to 64 samples wide). Frames of 3 to 7 rows
// have a chroma filter of 1 or 2 taps, which swscale's yuv2packed1 applies:
// on the x86 rows the first tap's row or the two rows' plain mean, on the C
// rows the rows blended by their taps (measured against libswscale through
// ctypes on 1 to 97 samples wide, either range and siting, and against cv2's
// MJPG and H.264 clips of 2 to 7 rows).
//
// 4:2:2 frames of odd height take the same scaled path, whose vertical chroma
// filter is then swscale's unscaled one (a tap a row, so yuv2packed1 on every
// row), and 4:4:4 frames of any size take it with full horizontal chroma
// ("Forcing full internal H chroma due to input having non subsampled
// chroma"): both measured against libswscale on random planes and against
// cv2's MJPEG, HuffYUV, FFVHuff and FFV1 clips. The full chroma stage sums in
// 32 bits, which wrap for chroma far outside 0..255, as swscale's C does.
//
// BGR24 -> YUV 4:2:0 for the MPEG-4 writer: BT.601 limited range (what
// cv2's writer hands the mp4v encoder), luma per pixel and chroma from the
// mean of each 2x2 block, in 15-bit fixed point.
//
// No global state.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

inline int high16(int a, int b) { return (a * b) >> 16; }  // a signed high-half product (pmulhw)

inline int round16(int64_t x) {  // to a 16-bit coefficient, rounded
  const int64_t v = (x + (1 << 15)) >> 16;
  return (int)std::min<int64_t>(32767, std::max<int64_t>(-32768, v));
}

inline uint8_t sat(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// The BT.601 inverse matrix in 16.16 (Cr->R, Cb->B, Cb->G, Cr->G), limited range.
constexpr int64_t kCrvL = 104597, kCbuL = 132201, kCguL = -25675, kCgvL = -53279;
constexpr int64_t kCyL = (int64_t(1) << 16) * 255 / 219, kOyL = int64_t(16) << 16;

// A filter as swscale's initFilter makes it for a bicubic upscale (srcW <=
// dstW): dstW rows of `size` coefficients summing to `one`, from source
// position pos[i]; positions in 1/256 of a sample (get_local_pos).
struct Filter {
  int size = 0;
  std::vector<int> pos;
  std::vector<int> coef;
};

int64_t rounded_div(int64_t a, int64_t b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

Filter bicubic_filter(int64_t xInc, int srcW, int dstW, int align, int64_t one, int srcPos, int dstPos) {
  if (std::llabs(xInc - 0x10000) < 10 && srcPos == dstPos) {  // unscaled: one tap a row
    Filter out;
    out.size = 1;
    out.pos.resize(dstW);
    for (int i = 0; i < dstW; ++i) out.pos[i] = i;
    out.coef.assign(dstW, (int)one);
    return out;
  }
  const int64_t fone = int64_t(1) << 54;  // an upscale: av_log2(srcW / dstW) is 0
  int size = std::max(std::min(1 + 4, srcW - 2), 1);
  std::vector<int64_t> f((size_t)dstW * size);
  std::vector<int> pos(dstW);
  int64_t xDstInSrc = ((dstPos * xInc) >> 7) - ((srcPos * int64_t(0x10000)) >> 7);
  const int64_t B = 0, C = (int64_t)(0.6 * (1 << 24));
  for (int i = 0; i < dstW; ++i) {
    int xx = (int)((xDstInSrc - (size - 2) * (int64_t(1) << 16)) / (1 << 17));
    pos[i] = xx;
    for (int j = 0; j < size; ++j, ++xx) {
      const int64_t d = std::llabs((int64_t)xx * (1 << 17) - xDstInSrc) << 13;
      int64_t coeff = 0;
      if (d < int64_t(1) << 31) {
        const int64_t dd = (d * d) >> 30, ddd = (dd * d) >> 30;
        if (d < int64_t(1) << 30)
          coeff = (12 * (int64_t(1) << 24) - 9 * B - 6 * C) * ddd + (-18 * (int64_t(1) << 24) + 12 * B + 6 * C) * dd +
                  (6 * (int64_t(1) << 24) - 2 * B) * (int64_t(1) << 30);
        else
          coeff = (-B - 6 * C) * ddd + (6 * B + 30 * C) * dd + (-12 * B - 48 * C) * d + (8 * B + 24 * C) * (int64_t(1) << 30);
      }
      f[(size_t)i * size + j] = coeff;
    }
    xDstInSrc += 2 * xInc;
  }
  // drop near-zero coefficients on the left (positions kept monotonic) and find the size the right ones allow
  const double cut = 0.002 * (double)fone;
  int minSize = 0;
  for (int i = dstW - 1; i >= 0; --i) {
    int64_t* row = &f[(size_t)i * size];
    int64_t cutOff = 0;
    for (int j = 0; j < size; ++j) {
      cutOff += std::llabs(row[0]);
      if ((double)cutOff > cut) break;
      if (i < dstW - 1 && pos[i] >= pos[i + 1]) break;
      for (int k = 1; k < size; ++k) row[k - 1] = row[k];
      row[size - 1] = 0;
      ++pos[i];
    }
    int keep = size;
    cutOff = 0;
    for (int j = size - 1; j > 0; --j) {
      cutOff += std::llabs(row[j]);
      if ((double)cutOff > cut) break;
      --keep;
    }
    minSize = std::max(minSize, keep);
  }
  if (align == 2 && minSize == 1) align = 1;
  const int out_size = std::max((minSize + align - 1) & ~(align - 1), 1);
  std::vector<int64_t> g((size_t)dstW * out_size, 0);
  for (int i = 0; i < dstW; ++i)
    for (int j = 0; j < out_size && j < size; ++j) g[(size_t)i * out_size + j] = f[(size_t)i * size + j];
  // fold what lies outside the source onto its edge samples
  for (int i = 0; i < dstW; ++i) {
    int64_t* row = &g[(size_t)i * out_size];
    if (pos[i] < 0) {
      for (int j = 1; j < out_size; ++j) {
        const int left = std::max(j + pos[i], 0);
        row[left] += row[j];
        row[j] = 0;
      }
      pos[i] = 0;
    }
    if (pos[i] + out_size > srcW) {
      const int shift = pos[i] + std::min(out_size - srcW, 0);
      int64_t acc = 0;
      for (int j = out_size - 1; j >= 0; --j)
        if (pos[i] + j >= srcW) {
          acc += row[j];
          row[j] = 0;
        }
      for (int j = out_size - 1; j >= 0; --j) row[j] = j < shift ? 0 : row[j - shift];
      pos[i] -= shift;
      row[srcW - 1 - pos[i]] += acc;
    }
  }
  Filter out;
  out.size = out_size;
  out.pos = pos;
  out.coef.resize((size_t)dstW * out_size);
  for (int i = 0; i < dstW; ++i) {
    const int64_t* row = &g[(size_t)i * out_size];
    int64_t sum = 0, error = 0;
    for (int j = 0; j < out_size; ++j) sum += row[j];
    sum = (sum + one / 2) / one;
    if (!sum) sum = 1;
    for (int j = 0; j < out_size; ++j) {
      const int64_t v = row[j] + error;
      const int iv = (int)rounded_div(v, sum);
      out.coef[(size_t)i * out_size + j] = iv;
      error = v - (int64_t)iv * sum;
    }
  }
  return out;
}

int local_pos(int subsample, int pos) {  // get_local_pos: -513 is swscale's unset, centred
  if (pos == -1 || pos <= -513) pos = (128 << subsample) - 128;
  return (pos + 128) >> subsample;
}

// Chroma rows (srcW samples) to 15-bit samples at dstW, as hScale8To15 filters them.
std::vector<int> hscale(const uint8_t* c, int cs, int rows, int srcW, int dstW, int srcPos, int dstPos) {
  std::vector<int> out((size_t)rows * dstW);
  const int64_t inc = ((int64_t(srcW) << 16) + (dstW >> 1)) / dstW;
  if (std::llabs(inc - 0x10000) < 10 && srcPos == dstPos) {
    for (int r = 0; r < rows; ++r)
      for (int x = 0; x < dstW; ++x) out[(size_t)r * dstW + x] = c[(int64_t)r * cs + x] << 7;
    return out;
  }
  const Filter f = bicubic_filter(inc, srcW, dstW, 4, 1 << 14, srcPos, dstPos);
  for (int r = 0; r < rows; ++r)
    for (int x = 0; x < dstW; ++x) {
      int64_t acc = 0;
      for (int j = 0; j < f.size && f.pos[x] + j < srcW; ++j)  // past the edge every coefficient is 0
        acc += (int64_t)c[(int64_t)r * cs + f.pos[x] + j] * f.coef[(size_t)x * f.size + j];
      out[(size_t)r * dstW + x] = (int)std::min<int64_t>(acc >> 7, 32767);
    }
  return out;
}

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

// (h, w, 3) BGR as swscale's scaled path gives it to cv2 (see the top): a
// 4:2:0 (sx, sy 1, 1) or 4:2:2 (1, 0) frame of odd height, or a 4:4:4 (0, 0)
// frame of any size. left: the chroma is left-sited (MPEG-2, MPEG-4), else
// centred. A 4:2:2 or 4:4:4 frame's vertical chroma filter is swscale's
// unscaled one, one tap a row, so every row is yuv2packed1's; a 4:4:4 frame
// forces full horizontal chroma ("input having non subsampled chroma").
void mga_yuv_to_bgr_scaled(const uint8_t* y, int32_t ys, const uint8_t* u, const uint8_t* v, int32_t cs, int32_t h,
                           int32_t w, int32_t sx, int32_t sy, int32_t left, int32_t full_range, uint8_t* out) {
  const int ch = sy ? (h + 1) / 2 : h, csw = sx ? (w + 1) / 2 : w;
  const bool full = (w & 1) || !sx;  // full horizontal chroma
  // the range's matrix, as mga_yuv_to_bgr's: full-range chroma scaled by 224 / 255, limited-range luma by 255 / 219
  const int64_t kCy = full_range ? int64_t(1) << 16 : kCyL, kOy = full_range ? 0 : kOyL;
  const int64_t kCrv = full_range ? kCrvL * 224 / 255 : kCrvL, kCbu = full_range ? kCbuL * 224 / 255 : kCbuL;
  const int64_t kCgu = full_range ? kCguL * 224 / 255 : kCguL, kCgv = full_range ? kCgvL * 224 / 255 : kCgvL;
  const int64_t yoffs = full_range ? 384 : 326;  // swscale's offset into its luma table
  const int cw = full ? w : csw;
  const int hpos = left ? 0 : -513;
  const std::vector<int> U = hscale(u, cs, ch, csw, cw, local_pos(sx, hpos), local_pos(full ? 0 : 1, -513));
  const std::vector<int> V = hscale(v, cs, ch, csw, cw, local_pos(sx, hpos), local_pos(full ? 0 : 1, -513));
  const int64_t vinc = ((int64_t(ch) << 16) + (h >> 1)) / h;
  const Filter f = bicubic_filter(vinc, ch, h, 2, 1 << 12, local_pos(sy, -513), local_pos(0, -513));
  // the full path's coefficients (13-bit, rounded to 16 bits) and the packed path's (as mga_yuv_to_bgr's)
  const int fy = round16(kCy * 8192), fyo = round16(kOy * 512), fvr = round16(kCrv * 8192), fub = round16(kCbu * 8192),
            fug = round16(kCgu * 8192), fvg = round16(kCgv * 8192);
  const int yc = fy, yo = round16(kOy * 8);
  // the C tables' coefficients, in luma steps, and their luma offset
  auto in_y = [kCy](int64_t c) { return (int64_t)((c * 65536 + 0x8000) / kCy); };
  const int64_t tr = in_y(kCrv), tb = in_y(kCbu), tgu = in_y(kCgu), tgv = in_y(kCgv);
  std::vector<int64_t> ua(cw), va(cw);
  for (int r = 0; r < h; ++r) {
    const uint8_t* yr = y + (int64_t)r * ys;
    uint8_t* o = out + (int64_t)r * w * 3;
    const int* taps = &f.coef[(size_t)r * f.size];
    const int p0 = f.pos[r];
    const int mode = full ? 0 : r >= h - 2 ? 1 : 2;  // full C, packed C (tables), packed x86
    // a chroma filter of 1 tap, or of 2 summing to 4096 (frames of 3 to 8 rows): swscale's yuv2packed1. On the
    // x86 packed path it takes the first tap's row when the second tap weighs under 2048, else the two rows'
    // plain mean; its C form blends the rows by the taps, which for packed rows is the general filter's sum and
    // for full chroma that sum without its rounder (measured against libswscale)
    const bool two = f.size == 2 && taps[0] + taps[1] == 4096 && (unsigned)taps[1] <= 4096u;
    const bool packed1 = f.size == 1 || (two && mode != 1);
    const bool mean = packed1 && f.size == 2 && taps[1] >= 2048;
    for (int x = 0; x < cw; ++x) {
      if (packed1) {
        const int64_t u0 = U[(size_t)p0 * cw + x], v0 = V[(size_t)p0 * cw + x];
        const int64_t u1 = mean ? U[(size_t)(p0 + 1) * cw + x] : 0, v1 = mean ? V[(size_t)(p0 + 1) * cw + x] : 0;
        if (mode == 0) {  // yuv2rgb_full_1
          const int64_t t1 = f.size == 2 ? taps[1] : 0, t0 = 4096 - t1;
          ua[x] = (u0 * t0 + (t1 ? U[(size_t)(p0 + 1) * cw + x] * t1 : 0) - (int64_t(128) << 19)) >> 10;
          va[x] = (v0 * t0 + (t1 ? V[(size_t)(p0 + 1) * cw + x] * t1 : 0) - (int64_t(128) << 19)) >> 10;
        } else if (mode == 1) {  // yuv2rgb_1's C tables, which clip their chroma index to 0..255
          ua[x] = std::min<int64_t>(255, std::max<int64_t>(0, mean ? (u0 + u1 + 128) >> 8 : (u0 + 64) >> 7));
          va[x] = std::min<int64_t>(255, std::max<int64_t>(0, mean ? (v0 + v1 + 128) >> 8 : (v0 + 64) >> 7));
        } else {  // the x86 yuv2bgr24_1: a 16-bit sum shifted logically, or one row shifted arithmetically
          ua[x] = mean ? (int64_t)((uint16_t)(u0 + u1) >> 5) : (int64_t)((int16_t)u0 >> 4);
          va[x] = mean ? (int64_t)((uint16_t)(v0 + v1) >> 5) : (int64_t)((int16_t)v0 >> 4);
        }
        continue;
      }
      int64_t a = mode == 0 ? (1 << 9) - (128 << 19) : mode == 1 ? 1 << 18 : 4, b = a;
      for (int j = 0; j < f.size && p0 + j < ch; ++j) {
        const int64_t cu = U[(size_t)(p0 + j) * cw + x], cv = V[(size_t)(p0 + j) * cw + x];
        if (mode == 2) {
          a += (cu * taps[j]) >> 16;
          b += (cv * taps[j]) >> 16;
        } else {
          a += cu * taps[j];
          b += cv * taps[j];
        }
      }
      ua[x] = mode == 0 ? a >> 10 : mode == 1 ? std::min<int64_t>(255, std::max<int64_t>(0, a >> 19)) : a;
      va[x] = mode == 0 ? b >> 10 : mode == 1 ? std::min<int64_t>(255, std::max<int64_t>(0, b >> 19)) : b;
    }
    const int yround = packed1 ? 0 : 4;  // the x86 packed path's luma: 8 Y, plus the vertical filter's rounder
    for (int c = 0; c < w; ++c) {
      const int64_t Y = yr[c];
      if (mode == 0) {  // yuv2rgb_write_full: sums in 32 bits, which wrap for chroma far outside 0..255
        const int64_t yy = ((Y << 9) - fyo) * fy + (1 << 21), uu = ua[c], vv = va[c];
        const int64_t chan[3] = {yy + uu * fub, yy + uu * fug + vv * fvg, yy + vv * fvr};
        for (int k = 0; k < 3; ++k) {
          const int32_t v = (int32_t)(uint32_t)chan[k];
          o[3 * c + k] = (uint8_t)(v < 0 ? 0 : v >= (1 << 30) ? 255 : v >> 22);
        }
      } else if (mode == 1) {
        const int64_t uu = ua[c >> 1], vv = va[c >> 1];
        const int64_t t[3] = {Y + ((uu * tb) >> 16) - (tb >> 9),
                              Y + ((uu * tgu) >> 16) - (tgu >> 9) + ((vv * tgv) >> 16) - (tgv >> 9),
                              Y + ((vv * tr) >> 16) - (tr >> 9)};
        for (int k = 0; k < 3; ++k)
          o[3 * c + k] = (uint8_t)std::min<int64_t>(255, std::max<int64_t>(0, ((yoffs + t[k]) * kCy - (384 << 16) - kOy + 0x8000) >> 16));
      } else {
        const int yy = high16((int)(Y * 8 + yround) - yo, yc);
        const int uu = (int)ua[c >> 1] - 1024, vv = (int)va[c >> 1] - 1024;
        o[3 * c] = sat(yy + high16(uu, round16(kCbu * 8192)));
        o[3 * c + 1] = sat(yy + high16(uu, round16(kCgu * 8192)) + high16(vv, round16(kCgv * 8192)));
        o[3 * c + 2] = sat(yy + high16(vv, round16(kCrv * 8192)));
      }
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
