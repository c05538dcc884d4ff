// ffmpeg's "simple" integer inverse DCT for 8-bit samples (rows with 11
// bits of headroom, then columns), which its MPEG-4 and MJPEG decoders run.
// Shared by mpeg4.cpp and jpeg.cpp's video planes.

#pragma once

#include <cstdint>

namespace simple_idct {

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20;

inline void idct_row(int16_t* row) {
  if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
    const int16_t v = (int16_t)(uint16_t)((unsigned)row[0] << 3);
    for (int i = 0; i < 8; ++i) row[i] = v;
    return;
  }
  int a0 = W4 * row[0] + (1 << (ROW_SHIFT - 1)), a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * row[2];
  a1 += W6 * row[2];
  a2 -= W6 * row[2];
  a3 -= W2 * row[2];
  int b0 = W1 * row[1] + W3 * row[3];
  int b1 = W3 * row[1] - W7 * row[3];
  int b2 = W5 * row[1] - W1 * row[3];
  int b3 = W7 * row[1] - W5 * row[3];
  if (row[4] | row[5] | row[6] | row[7]) {
    a0 += W4 * row[4] + W6 * row[6];
    a1 += -W4 * row[4] - W2 * row[6];
    a2 += -W4 * row[4] + W2 * row[6];
    a3 += W4 * row[4] - W6 * row[6];
    b0 += W5 * row[5] + W7 * row[7];
    b1 += -W1 * row[5] - W5 * row[7];
    b2 += W7 * row[5] + W3 * row[7];
    b3 += W3 * row[5] - W1 * row[7];
  }
  row[0] = (int16_t)((a0 + b0) >> ROW_SHIFT);
  row[7] = (int16_t)((a0 - b0) >> ROW_SHIFT);
  row[1] = (int16_t)((a1 + b1) >> ROW_SHIFT);
  row[6] = (int16_t)((a1 - b1) >> ROW_SHIFT);
  row[2] = (int16_t)((a2 + b2) >> ROW_SHIFT);
  row[5] = (int16_t)((a2 - b2) >> ROW_SHIFT);
  row[3] = (int16_t)((a3 + b3) >> ROW_SHIFT);
  row[4] = (int16_t)((a3 - b3) >> ROW_SHIFT);
}

// Column c of the row-transformed block -> 8 values (before the clip).
inline void idct_col(const int16_t* col, int* o) {
  int a0 = W4 * (col[0] + ((1 << (COL_SHIFT - 1)) / W4)), a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * col[16];
  a1 += W6 * col[16];
  a2 += -W6 * col[16];
  a3 += -W2 * col[16];
  int b0 = W1 * col[8] + W3 * col[24];
  int b1 = W3 * col[8] - W7 * col[24];
  int b2 = W5 * col[8] - W1 * col[24];
  int b3 = W7 * col[8] - W5 * col[24];
  if (col[32]) {
    a0 += W4 * col[32];
    a1 -= W4 * col[32];
    a2 -= W4 * col[32];
    a3 += W4 * col[32];
  }
  if (col[40]) {
    b0 += W5 * col[40];
    b1 -= W1 * col[40];
    b2 += W7 * col[40];
    b3 += W3 * col[40];
  }
  if (col[48]) {
    a0 += W6 * col[48];
    a1 -= W2 * col[48];
    a2 += W2 * col[48];
    a3 -= W6 * col[48];
  }
  if (col[56]) {
    b0 += W7 * col[56];
    b1 -= W5 * col[56];
    b2 += W3 * col[56];
    b3 -= W1 * col[56];
  }
  o[0] = (a0 + b0) >> COL_SHIFT;
  o[1] = (a1 + b1) >> COL_SHIFT;
  o[2] = (a2 + b2) >> COL_SHIFT;
  o[3] = (a3 + b3) >> COL_SHIFT;
  o[4] = (a3 - b3) >> COL_SHIFT;
  o[5] = (a2 - b2) >> COL_SHIFT;
  o[6] = (a1 - b1) >> COL_SHIFT;
  o[7] = (a0 - b0) >> COL_SHIFT;
}

// The block's samples put (add = false) or added to dst, clipped to 0..255.
inline void idct(int16_t* blk, uint8_t* dst, int stride, bool add) {
  for (int r = 0; r < 8; ++r) idct_row(blk + 8 * r);
  int o[8];
  for (int c = 0; c < 8; ++c) {
    idct_col(blk + c, o);
    for (int r = 0; r < 8; ++r) {
      uint8_t* p = dst + (size_t)r * stride + c;
      *p = clip8(add ? *p + o[r] : o[r]);
    }
  }
}

}  // namespace simple_idct
