// The XviD integer inverse DCT for 8-bit samples (rows in 11-bit fixed
// point with a per-row rounding, then a column pass of tangent rotations),
// which ffmpeg's MPEG-4 decoder switches to for a stream an XviD encoder
// wrote (user data "XviD<build>", or an XVID / XVIX / RMP4 / ZMP4 / SIPP
// fourcc on an unmarked stream). Same interface as simple_idct::idct.

#pragma once

#include <cstdint>

namespace xvid_idct {

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

constexpr int ROW_SHIFT = 11, COL_SHIFT = 6;
// the row constants c1..c7 of rows 0/4, 1/7, 2/6 and 3/5
constexpr int kTab04[7] = {22725, 21407, 19266, 16384, 12873, 8867, 4520};
constexpr int kTab17[7] = {31521, 29692, 26722, 22725, 17855, 12299, 6270};
constexpr int kTab26[7] = {29692, 27969, 25172, 21407, 16819, 11585, 5906};
constexpr int kTab35[7] = {26722, 25172, 22654, 19266, 15137, 10426, 5315};
constexpr int kRowRound[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};

inline void idct_row(int16_t* in, const int* tab, int rnd) {
  const int c1 = tab[0], c2 = tab[1], c3 = tab[2], c4 = tab[3], c5 = tab[4], c6 = tab[5], c7 = tab[6];
  const int right = in[5] | in[6] | in[7], left = in[1] | in[2] | in[3];
  if (!(right | in[4])) {
    const int k = c4 * in[0] + rnd;
    if (left) {
      const int a0 = k + c2 * in[2], a1 = k + c6 * in[2], a2 = k - c6 * in[2], a3 = k - c2 * in[2];
      const int b0 = c1 * in[1] + c3 * in[3], b1 = c3 * in[1] - c7 * in[3];
      const int b2 = c5 * in[1] - c1 * in[3], b3 = c7 * in[1] - c5 * in[3];
      in[0] = (int16_t)((a0 + b0) >> ROW_SHIFT);
      in[7] = (int16_t)((a0 - b0) >> ROW_SHIFT);
      in[1] = (int16_t)((a1 + b1) >> ROW_SHIFT);
      in[6] = (int16_t)((a1 - b1) >> ROW_SHIFT);
      in[2] = (int16_t)((a2 + b2) >> ROW_SHIFT);
      in[5] = (int16_t)((a2 - b2) >> ROW_SHIFT);
      in[3] = (int16_t)((a3 + b3) >> ROW_SHIFT);
      in[4] = (int16_t)((a3 - b3) >> ROW_SHIFT);
    } else {
      const int a0 = k >> ROW_SHIFT;
      if (a0)
        for (int i = 0; i < 8; ++i) in[i] = (int16_t)a0;
    }
    return;
  }
  const int k = c4 * in[0] + rnd;
  const int a0 = k + c2 * in[2] + c4 * in[4] + c6 * in[6];
  const int a1 = k + c6 * in[2] - c4 * in[4] - c2 * in[6];
  const int a2 = k - c6 * in[2] - c4 * in[4] + c2 * in[6];
  const int a3 = k - c2 * in[2] + c4 * in[4] - c6 * in[6];
  const int b0 = c1 * in[1] + c3 * in[3] + c5 * in[5] + c7 * in[7];
  const int b1 = c3 * in[1] - c7 * in[3] - c1 * in[5] - c5 * in[7];
  const int b2 = c5 * in[1] - c1 * in[3] + c7 * in[5] + c3 * in[7];
  const int b3 = c7 * in[1] - c5 * in[3] + c3 * in[5] - c1 * in[7];
  in[0] = (int16_t)((a0 + b0) >> ROW_SHIFT);
  in[7] = (int16_t)((a0 - b0) >> ROW_SHIFT);
  in[1] = (int16_t)((a1 + b1) >> ROW_SHIFT);
  in[6] = (int16_t)((a1 - b1) >> ROW_SHIFT);
  in[2] = (int16_t)((a2 + b2) >> ROW_SHIFT);
  in[5] = (int16_t)((a2 - b2) >> ROW_SHIFT);
  in[3] = (int16_t)((a3 + b3) >> ROW_SHIFT);
  in[4] = (int16_t)((a3 - b3) >> ROW_SHIFT);
}

// c * x >> 16 on 32 bits, as the fixed-point multiply of the column pass
inline int mult(int c, int x) { return (int)((int64_t)c * x) >> 16; }

constexpr int TAN1 = 0x32EC, TAN2 = 0x6A0A, TAN3 = 0xAB0E, SQRT2 = 0x5A82;

inline void idct_col(int16_t* in) {
  int m4 = in[7 * 8], m5 = in[5 * 8], m6 = in[3 * 8], m7 = in[1 * 8];
  int m0 = mult(TAN1, m4) + m7;
  int m1 = mult(TAN1, m7) - m4;
  int m2 = mult(TAN3, m5) + m6;
  int m3 = mult(TAN3, m6) - m5;
  m7 = m0 + m2;
  m4 = m1 - m3;
  m0 = m0 - m2;
  m1 = m1 + m3;
  m6 = m0 + m1;
  m5 = m0 - m1;
  m5 = 2 * mult(SQRT2, m5);
  m6 = 2 * mult(SQRT2, m6);
  m1 = in[2 * 8];
  m2 = in[6 * 8];
  m3 = mult(TAN2, m2) + m1;
  m2 = mult(TAN2, m1) - m2;
  m0 = in[0] + in[4 * 8];
  m1 = in[0] - in[4 * 8];
  int t = m0 + m3;  // even + odd butterflies
  m3 = m0 - m3;
  m0 = t;
  t = m0 + m7;
  m7 = m0 - m7;
  m0 = t;
  in[8 * 0] = (int16_t)(m0 >> COL_SHIFT);
  in[8 * 7] = (int16_t)(m7 >> COL_SHIFT);
  t = m3 + m4;
  m4 = m3 - m4;
  m3 = t;
  in[8 * 3] = (int16_t)(m3 >> COL_SHIFT);
  in[8 * 4] = (int16_t)(m4 >> COL_SHIFT);
  t = m1 + m2;
  m2 = m1 - m2;
  m1 = t;
  t = m1 + m6;
  m6 = m1 - m6;
  m1 = t;
  in[8 * 1] = (int16_t)(m1 >> COL_SHIFT);
  in[8 * 6] = (int16_t)(m6 >> COL_SHIFT);
  t = m2 + m5;
  m5 = m2 - m5;
  m2 = t;
  in[8 * 2] = (int16_t)(m2 >> COL_SHIFT);
  in[8 * 5] = (int16_t)(m5 >> COL_SHIFT);
}

// blk (64 coefficients, raster order) -> dst (8x8), stored or added with clipping.
inline void idct(int16_t* blk, uint8_t* dst, int stride, bool add) {
  static constexpr const int* kRowTab[8] = {kTab04, kTab17, kTab26, kTab35, kTab04, kTab35, kTab26, kTab17};
  for (int r = 0; r < 8; ++r) idct_row(blk + 8 * r, kRowTab[r], kRowRound[r]);
  for (int c = 0; c < 8; ++c) idct_col(blk + c);
  for (int r = 0; r < 8; ++r) {
    uint8_t* o = dst + (size_t)r * stride;
    const int16_t* b = blk + 8 * r;
    for (int c = 0; c < 8; ++c) o[c] = clip8(add ? o[c] + b[c] : b[c]);
  }
}

}  // namespace xvid_idct
