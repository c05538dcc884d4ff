// MPEG-1 (ISO/IEC 11172-2) and MPEG-2 (ISO/IEC 13818-2, Main profile, frame
// pictures) video on the host: the decoder computes what ffmpeg's mpeg1video
// and mpeg2video decoders compute for such a stream, which is what
// cv2.VideoCapture hands on for .mpg / .mpeg files and for MPEG-1/2 tracks in
// AVI, MP4 and Matroska.
//
// Headers: the sequence header with loaded intra and non-intra matrices, the
// sequence extension (progressive_sequence, chroma_format 4:2:0 and 4:2:2,
// the size extensions), the sequence display extension and user data (passed
// over), the GOP header (closed_gop), the picture header (I, P and B, MPEG-1's
// full_pel vectors) and the picture coding extension (f_codes,
// intra_dc_precision 8 to 11 bits, frame_pred_frame_dct,
// concealment_motion_vectors, q_scale_type, intra_vlc_format,
// alternate_scan; top_field_first, repeat_first_field and progressive_frame
// read, as ffmpeg reads them, without effect on the frame), and the quant
// matrix extension.
//
// Slices and macroblocks: slice_vertical_position and its extension,
// address increments with escape and stuffing, skipped macroblocks (zero
// motion in P-pictures; in B-pictures the previous macroblock's directions
// and its vectors' predictors, as ffmpeg takes them), the macroblock types of
// each picture type, the linear and non-linear quantiser scales, DC
// differentials, the coefficient tables B-14 and B-15 with MPEG-1's 8/16-bit
// and MPEG-2's 24-bit escapes, zigzag and alternate scans, MPEG-1's
// oddification and MPEG-2's mismatch control (ffmpeg's arithmetic: no
// saturation, 16-bit coefficients), frame and field prediction in frame
// pictures (motion_vertical_field_select, field vectors' vertical predictor
// halved), field DCT (dct_type), half-sample prediction and the B average with
// the standards' rounding, concealment vectors read and their predictors
// kept. The inverse DCT is ffmpeg's "simple" integer IDCT (simple_idct.h),
// which its MPEG-1/2 decoders run as its MPEG-4 decoder does. Reference
// frames are whole macroblocks; prediction reads inside them (ffmpeg's edge
// for MPEG-1/2).
//
// Output order as libavcodec's: an I- or P-picture is shown when the next
// one is decoded (or at flush), a B-picture at once; a B-picture decoded
// before two reference pictures of an open GOP is dropped.
//
// Refused by name: field pictures, dual-prime prediction, scalable
// extensions, 4:4:4, D-pictures, vectors that point outside the reference
// (ffmpeg skips the prediction), and any truncated or corrupt stream (no
// concealment: a picture must hold all its macroblocks).
//
// No global state: a decoder owns its frames and tables. Every read of the
// input is bounds-checked.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <new>
#include <stdexcept>
#include <vector>

#include "simple_idct.h"

namespace {

struct Refused : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void refuse(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Refused(buf);
}

template <class F>
int guarded(char* err, int errlen, F&& f) {
  try {
    return f();
  } catch (const std::bad_alloc&) {
    if (err && errlen > 0) snprintf(err, (size_t)errlen, "out of memory");
  } catch (const std::exception& e) {
    if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", e.what());
  }
  return -1;
}

// ------------------------------------------------------------------ tables
// Variable-length codes as (code, length), indexed by the value they code.

struct Code {
  uint16_t code;
  uint8_t len;
};

// macroblock_address_increment 1..33 (B-1), then stuffing and escape.
constexpr Code kMbAddr[35] = {
    {0x1, 1},  {0x3, 3},  {0x2, 3},  {0x3, 4},  {0x2, 4},  {0x3, 5},  {0x2, 5},  {0x7, 7},  {0x6, 7},
    {0xb, 8},  {0xa, 8},  {0x9, 8},  {0x8, 8},  {0x7, 8},  {0x6, 8},  {0x17, 10}, {0x16, 10}, {0x15, 10},
    {0x14, 10}, {0x13, 10}, {0x12, 10}, {0x23, 11}, {0x22, 11}, {0x21, 11}, {0x20, 11}, {0x1f, 11}, {0x1e, 11},
    {0x1d, 11}, {0x1c, 11}, {0x1b, 11}, {0x1a, 11}, {0x19, 11}, {0x18, 11}, {0xf, 11}, {0x8, 11}};
enum { kAddrStuffing = 33, kAddrEscape = 34 };

// macroblock_type flags
enum { kQuant = 1, kFwd = 2, kBwd = 4, kPat = 8, kIntra = 16 };
constexpr Code kMbTypeI[2] = {{0x1, 1}, {0x1, 2}};
constexpr int kMbTypeIFlags[2] = {kIntra, kIntra | kQuant};
constexpr Code kMbTypeP[7] = {{0x1, 1}, {0x1, 2}, {0x1, 3}, {0x3, 5}, {0x2, 5}, {0x1, 5}, {0x1, 6}};
constexpr int kMbTypePFlags[7] = {kFwd | kPat, kPat, kFwd, kIntra, kQuant | kFwd | kPat, kQuant | kPat, kQuant | kIntra};
constexpr Code kMbTypeB[11] = {{0x2, 2}, {0x3, 2}, {0x2, 3}, {0x3, 3}, {0x2, 4}, {0x3, 4},
                               {0x3, 5}, {0x2, 5}, {0x3, 6}, {0x2, 6}, {0x1, 6}};
constexpr int kMbTypeBFlags[11] = {kFwd | kBwd,          kFwd | kBwd | kPat,          kBwd,
                                   kBwd | kPat,          kFwd,                        kFwd | kPat,
                                   kIntra,               kQuant | kFwd | kBwd | kPat, kQuant | kFwd | kPat,
                                   kQuant | kBwd | kPat, kQuant | kIntra};

// coded_block_pattern 0..63 (B-9)
constexpr Code kCbp[64] = {
    {0x01, 9}, {0x0b, 5}, {0x09, 5}, {0x0d, 6}, {0x0d, 4}, {0x17, 7}, {0x13, 7}, {0x1f, 8}, {0x0c, 4}, {0x16, 7},
    {0x12, 7}, {0x1e, 8}, {0x13, 5}, {0x1b, 8}, {0x17, 8}, {0x13, 8}, {0x0b, 4}, {0x15, 7}, {0x11, 7}, {0x1d, 8},
    {0x11, 5}, {0x19, 8}, {0x15, 8}, {0x11, 8}, {0x0f, 6}, {0x0f, 8}, {0x0d, 8}, {0x03, 9}, {0x0f, 5}, {0x0b, 8},
    {0x07, 8}, {0x07, 9}, {0x0a, 4}, {0x14, 7}, {0x10, 7}, {0x1c, 8}, {0x0e, 6}, {0x0e, 8}, {0x0c, 8}, {0x02, 9},
    {0x10, 5}, {0x18, 8}, {0x14, 8}, {0x10, 8}, {0x0e, 5}, {0x0a, 8}, {0x06, 8}, {0x06, 9}, {0x12, 5}, {0x1a, 8},
    {0x16, 8}, {0x12, 8}, {0x0d, 5}, {0x09, 8}, {0x05, 8}, {0x05, 9}, {0x0c, 5}, {0x08, 8}, {0x04, 8}, {0x04, 9},
    {0x07, 3}, {0x0a, 5}, {0x08, 5}, {0x0c, 6}};

// |motion_code| 0..16 (B-10); a sign bit follows a nonzero one.
constexpr Code kMotion[17] = {{0x1, 1}, {0x1, 2}, {0x1, 3}, {0x1, 4},  {0x3, 6},  {0x5, 7},  {0x4, 7},  {0x3, 7}, {0xb, 9},
                              {0xa, 9}, {0x9, 9}, {0x11, 10}, {0x10, 10}, {0xf, 10}, {0xe, 10}, {0xd, 10}, {0xc, 10}};

// dct_dc_size 0..11 (B-12, B-13)
constexpr Code kDcLum[12] = {{0x4, 3}, {0x0, 2}, {0x1, 2}, {0x5, 3}, {0x6, 3}, {0xe, 4},
                             {0x1e, 5}, {0x3e, 6}, {0x7e, 7}, {0xfe, 8}, {0x1fe, 9}, {0x1ff, 9}};
constexpr Code kDcChrom[12] = {{0x0, 2}, {0x1, 2}, {0x2, 2}, {0x6, 3}, {0xe, 4}, {0x1e, 5},
                               {0x3e, 6}, {0x7e, 7}, {0xfe, 8}, {0x1fe, 9}, {0x3fe, 10}, {0x3ff, 10}};

// dct_coefficients: B-14 and B-15, each 111 (run, level) codes with a sign
// bit after each, then ESCAPE and End of Block.
enum { kEscape = 111, kEob = 112 };
constexpr Code kTcoefB14[113] = {
    {0x3, 2}, {0x4, 4}, {0x5, 5}, {0x6, 7}, {0x26, 8}, {0x21, 8}, {0xa, 10}, {0x1d, 12},
    {0x18, 12}, {0x13, 12}, {0x10, 12}, {0x1a, 13}, {0x19, 13}, {0x18, 13}, {0x17, 13}, {0x1f, 14},
    {0x1e, 14}, {0x1d, 14}, {0x1c, 14}, {0x1b, 14}, {0x1a, 14}, {0x19, 14}, {0x18, 14}, {0x17, 14},
    {0x16, 14}, {0x15, 14}, {0x14, 14}, {0x13, 14}, {0x12, 14}, {0x11, 14}, {0x10, 14}, {0x18, 15},
    {0x17, 15}, {0x16, 15}, {0x15, 15}, {0x14, 15}, {0x13, 15}, {0x12, 15}, {0x11, 15}, {0x10, 15},
    {0x3, 3}, {0x6, 6}, {0x25, 8}, {0xc, 10}, {0x1b, 12}, {0x16, 13}, {0x15, 13}, {0x1f, 15},
    {0x1e, 15}, {0x1d, 15}, {0x1c, 15}, {0x1b, 15}, {0x1a, 15}, {0x19, 15}, {0x13, 16}, {0x12, 16},
    {0x11, 16}, {0x10, 16}, {0x5, 4}, {0x4, 7}, {0xb, 10}, {0x14, 12}, {0x14, 13}, {0x7, 5},
    {0x24, 8}, {0x1c, 12}, {0x13, 13}, {0x6, 5}, {0xf, 10}, {0x12, 12}, {0x7, 6}, {0x9, 10},
    {0x12, 13}, {0x5, 6}, {0x1e, 12}, {0x14, 16}, {0x4, 6}, {0x15, 12}, {0x7, 7}, {0x11, 12},
    {0x5, 7}, {0x11, 13}, {0x27, 8}, {0x10, 13}, {0x23, 8}, {0x1a, 16}, {0x22, 8}, {0x19, 16},
    {0x20, 8}, {0x18, 16}, {0xe, 10}, {0x17, 16}, {0xd, 10}, {0x16, 16}, {0x8, 10}, {0x15, 16},
    {0x1f, 12}, {0x1a, 12}, {0x19, 12}, {0x17, 12}, {0x16, 12}, {0x1f, 13}, {0x1e, 13}, {0x1d, 13},
    {0x1c, 13}, {0x1b, 13}, {0x1f, 16}, {0x1e, 16}, {0x1d, 16}, {0x1c, 16}, {0x1b, 16}, {0x1, 6},
    {0x2, 2},
};
constexpr Code kTcoefB15[113] = {
    {0x2, 2}, {0x6, 3}, {0x7, 4}, {0x1c, 5}, {0x1d, 5}, {0x5, 6}, {0x4, 6}, {0x7b, 7},
    {0x7c, 7}, {0x23, 8}, {0x22, 8}, {0xfa, 8}, {0xfb, 8}, {0xfe, 8}, {0xff, 8}, {0x1f, 14},
    {0x1e, 14}, {0x1d, 14}, {0x1c, 14}, {0x1b, 14}, {0x1a, 14}, {0x19, 14}, {0x18, 14}, {0x17, 14},
    {0x16, 14}, {0x15, 14}, {0x14, 14}, {0x13, 14}, {0x12, 14}, {0x11, 14}, {0x10, 14}, {0x18, 15},
    {0x17, 15}, {0x16, 15}, {0x15, 15}, {0x14, 15}, {0x13, 15}, {0x12, 15}, {0x11, 15}, {0x10, 15},
    {0x2, 3}, {0x6, 5}, {0x79, 7}, {0x27, 8}, {0x20, 8}, {0x16, 13}, {0x15, 13}, {0x1f, 15},
    {0x1e, 15}, {0x1d, 15}, {0x1c, 15}, {0x1b, 15}, {0x1a, 15}, {0x19, 15}, {0x13, 16}, {0x12, 16},
    {0x11, 16}, {0x10, 16}, {0x5, 5}, {0x7, 7}, {0xfc, 8}, {0xc, 10}, {0x14, 13}, {0x7, 5},
    {0x26, 8}, {0x1c, 12}, {0x13, 13}, {0x6, 6}, {0xfd, 8}, {0x12, 12}, {0x7, 6}, {0x4, 9},
    {0x12, 13}, {0x6, 7}, {0x1e, 12}, {0x14, 16}, {0x4, 7}, {0x15, 12}, {0x5, 7}, {0x11, 12},
    {0x78, 7}, {0x11, 13}, {0x7a, 7}, {0x10, 13}, {0x21, 8}, {0x1a, 16}, {0x25, 8}, {0x19, 16},
    {0x24, 8}, {0x18, 16}, {0x5, 9}, {0x17, 16}, {0x7, 9}, {0x16, 16}, {0xd, 10}, {0x15, 16},
    {0x1f, 12}, {0x1a, 12}, {0x19, 12}, {0x17, 12}, {0x16, 12}, {0x1f, 13}, {0x1e, 13}, {0x1d, 13},
    {0x1c, 13}, {0x1b, 13}, {0x1f, 16}, {0x1e, 16}, {0x1d, 16}, {0x1c, 16}, {0x1b, 16}, {0x1, 6},
    {0x6, 4},
};
constexpr int8_t kTcoefRun[111] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31};
constexpr int8_t kTcoefLevel[111] = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};

constexpr uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
                                 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
                                 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
constexpr uint8_t kAlternate[64] = {0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49, 41, 33, 26, 18, 3,  11,
                                    4,  12, 19, 27, 34, 42, 50, 58, 35, 43, 51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44,
                                    52, 60, 37, 45, 53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
// The default intra matrix, in raster order.
constexpr uint8_t kDefaultIntra[64] = {8,  16, 19, 22, 26, 27, 29, 34, 16, 16, 22, 24, 27, 29, 34, 37,
                                       19, 22, 26, 27, 29, 34, 34, 38, 22, 22, 26, 27, 29, 34, 37, 40,
                                       22, 26, 27, 29, 32, 35, 40, 48, 26, 27, 29, 32, 35, 40, 48, 58,
                                       26, 27, 29, 34, 38, 46, 56, 69, 27, 29, 35, 38, 46, 56, 69, 83};
constexpr uint8_t kNonLinearQ[32] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  10, 12, 14, 16, 18,  20,  22,
                                     24, 28, 32, 36, 40, 44, 48, 52, 56, 64, 72, 80, 88, 96, 104, 112};

// A decoding table: the next `bits` bits -> (symbol, length); length 0 marks no code.
struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  void build(const Code* codes, int n) {
    bits = 0;
    for (int i = 0; i < n; ++i) bits = std::max(bits, (int)codes[i].len);
    sym.assign((size_t)1 << bits, 0);
    len.assign((size_t)1 << bits, 0);
    for (int i = 0; i < n; ++i) {
      const int l = codes[i].len;
      const uint32_t lo = (uint32_t)codes[i].code << (bits - l), hi = (uint32_t)(codes[i].code + 1) << (bits - l);
      for (uint32_t j = lo; j < hi; ++j) {
        sym[j] = (int16_t)i;
        len[j] = (uint8_t)l;
      }
    }
  }
};

struct BitReader {
  const uint8_t* d = nullptr;
  size_t nbytes = 0, pos = 0;  // pos in bits
  BitReader(const uint8_t* d_, size_t n_) : d(d_), nbytes(n_) {}
  uint32_t peek(int k) const {  // 1 <= k <= 32; zeros past the end
    const size_t b = pos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) v = (v << 8) | (b + i < nbytes ? d[b + i] : 0);
    v <<= (pos & 7);
    return (uint32_t)(v >> (64 - k));
  }
  uint32_t get(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    pos += (size_t)k;
    return v;
  }
  int get1() { return (int)get(1); }
  int sbits(int k) {  // a k-bit two's complement number
    const int v = (int)get(k);
    return v >= (1 << (k - 1)) ? v - (1 << k) : v;
  }
  bool overran() const { return pos > nbytes * 8; }
  void marker(const char* what) {
    if (!get1()) refuse("corrupt MPEG video: a marker bit is 0 in the %s", what);
  }
  int vlc(const Vlc& t, const char* what) {
    const uint32_t p = peek(t.bits);
    const int l = t.len[p];
    if (!l) refuse("corrupt MPEG video: no %s code matches", what);
    pos += (size_t)l;
    return t.sym[p];
  }
};

struct Plane {
  int w = 0, h = 0;  // whole macroblocks
  std::vector<uint8_t> px;
  uint8_t* at(int x, int y) { return px.data() + (size_t)y * w + x; }
};

struct Picture {
  Plane p[3];
  int type = 0;
};

struct Shown {  // a frame handed out, cropped to the display size
  int w, h, cw, ch, type;
  std::vector<uint8_t> y, u, v;
};

// What a decoder has met, counted (native/__init__.py MPEG12_TALLY, in this order).
struct Tally {
  int64_t pictures_i, pictures_p, pictures_b, mpeg1_pictures, mpeg2_pictures, mb_intra, mb_intra_in_p_b, mb_skipped_p,
      mb_skipped_b, mb_forward, mb_backward, mb_interpolated, mb_no_mc, mb_quant, frame_pred, field_pred, field_dct,
      halfpel_vectors, full_pel_pictures, escapes, escapes_long, mismatch_toggles, loaded_intra, loaded_non_intra,
      quant_matrix_ext, dc_precision_9, dc_precision_10, dc_precision_11, intra_vlc_pictures, alternate_scan_pictures,
      non_linear_q_pictures, concealment_pictures, chroma_422_pictures, interlaced_sequences, open_gops, closed_gops,
      reordered, dropped_b, slices, mv_wraps;
};

struct Decoder {
  // sequence
  bool have_seq = false, mpeg2 = false;
  int width = 0, height = 0, mbw = 0, mbh = 0, chroma = 1;  // chroma_format: 1 4:2:0, 2 4:2:2
  int progressive_seq = 1;
  uint8_t intra_m[64], inter_m[64], cintra_m[64], cinter_m[64];  // raster order
  bool closed_gop = false;
  // picture
  bool in_picture = false, skip_picture = false, ext_seen = false, started = false;
  int ptype = 0, fcode[2][2] = {{1, 1}, {1, 1}}, full_pel[2] = {0, 0}, dc_prec = 0, pic_struct = 3, fpfd = 1;
  int concealment = 0, q_type = 0, intra_vlc = 0, alt_scan = 0;
  int mb_done = 0;
  std::vector<uint8_t> mb_seen;
  // frames: pool[cur] is decoded into; fwd and bwd index the references
  Picture pool[3];
  int cur = 0, past = -1, future = -1;
  bool future_pending = false;  // the future reference is not shown yet
  std::deque<Shown> shown;
  // macroblock state
  int qscale = 2, last_dc[3] = {0, 0, 0}, pmv[2][2][2] = {}, mv[2][2][2] = {}, field_sel[2][2] = {};
  int mv_dir = 0, mv_field = 0, prev_intra = 0;
  Tally tally{};
  Vlc vlc_addr, vlc_i, vlc_p, vlc_b, vlc_cbp, vlc_motion, vlc_dc_lum, vlc_dc_chrom, vlc_b14, vlc_b15;
  alignas(16) int16_t blk[12][64];

  Decoder() {
    vlc_addr.build(kMbAddr, 35);
    vlc_i.build(kMbTypeI, 2);
    vlc_p.build(kMbTypeP, 7);
    vlc_b.build(kMbTypeB, 11);
    vlc_cbp.build(kCbp, 64);
    vlc_motion.build(kMotion, 17);
    vlc_dc_lum.build(kDcLum, 12);
    vlc_dc_chrom.build(kDcChrom, 12);
    vlc_b14.build(kTcoefB14, 113);
    vlc_b15.build(kTcoefB15, 113);
  }

  // ---- headers

  void load_matrix(BitReader& br, uint8_t* m, bool intra) {
    for (int i = 0; i < 64; ++i) {
      int v = (int)br.get(8);
      if (!v) refuse("corrupt MPEG video: a quantiser matrix entry of 0");
      if (intra && i == 0) v = 8;  // ffmpeg keeps the intra DC entry at 8
      m[kZigzag[i]] = (uint8_t)v;
    }
  }

  void sequence_header(BitReader& br) {
    const int w = (int)br.get(12), h = (int)br.get(12);
    br.get(4);  // aspect ratio
    if (!br.get(4)) refuse("corrupt MPEG video: frame_rate_code 0");
    br.get(18);  // bit rate
    br.marker("sequence header");
    br.get(10);  // vbv buffer size
    br.get1();   // constrained parameters
    if (br.get1()) {
      load_matrix(br, intra_m, true);
      ++tally.loaded_intra;
    } else {
      std::memcpy(intra_m, kDefaultIntra, 64);
    }
    if (br.get1()) {
      load_matrix(br, inter_m, false);
      ++tally.loaded_non_intra;
    } else {
      std::memset(inter_m, 16, 64);
    }
    std::memcpy(cintra_m, intra_m, 64);
    std::memcpy(cinter_m, inter_m, 64);
    if (br.overran()) refuse("truncated MPEG video: a cut sequence header");
    if (!w || !h) refuse("corrupt MPEG video: a sequence of %d x %d", w, h);
    width = w;
    height = h;
    have_seq = true;
    mpeg2 = false;  // until a sequence extension follows
    chroma = 1;
    progressive_seq = 1;
    ext_seen = false;
  }

  void extension(BitReader& br) {
    const int id = (int)br.get(4);
    switch (id) {
      case 1: {  // sequence extension
        if (!have_seq) refuse("corrupt MPEG video: a sequence extension before a sequence header");
        br.get(8);  // profile and level
        progressive_seq = br.get1();
        chroma = (int)br.get(2);
        if (chroma == 3) refuse("MPEG-2 video in 4:4:4 is not supported");
        if (chroma == 0) refuse("corrupt MPEG video: chroma_format 0");
        const int hx = (int)br.get(2), vx = (int)br.get(2);
        width = (width & 0xFFF) | (hx << 12);
        height = (height & 0xFFF) | (vx << 12);
        if (width > 16383 || height > 16383) refuse("MPEG video of %d x %d is too large", width, height);
        mpeg2 = true;
        if (!progressive_seq) ++tally.interlaced_sequences;
        break;
      }
      case 2:  // sequence display extension: ffmpeg takes no size from it
      case 4:  // copyright
      case 7:  // picture display
        break;
      case 3: {  // quant matrix extension
        ++tally.quant_matrix_ext;
        if (br.get1()) {
          load_matrix(br, intra_m, true);
          std::memcpy(cintra_m, intra_m, 64);
          ++tally.loaded_intra;
        }
        if (br.get1()) {
          load_matrix(br, inter_m, false);
          std::memcpy(cinter_m, inter_m, 64);
          ++tally.loaded_non_intra;
        }
        if (br.get1()) load_matrix(br, cintra_m, true);
        if (br.get1()) load_matrix(br, cinter_m, false);
        break;
      }
      case 5:
        refuse("MPEG-2 video with a sequence scalable extension is not supported");
      case 8: {  // picture coding extension
        if (!in_picture) refuse("corrupt MPEG video: a picture coding extension outside a picture");
        for (int s = 0; s < 2; ++s)
          for (int t = 0; t < 2; ++t) fcode[s][t] = (int)br.get(4);
        dc_prec = (int)br.get(2);
        pic_struct = (int)br.get(2);
        br.get1();  // top_field_first
        fpfd = br.get1();
        concealment = br.get1();
        q_type = br.get1();
        intra_vlc = br.get1();
        alt_scan = br.get1();
        br.get1();  // repeat_first_field
        br.get1();  // chroma_420_type
        br.get1();  // progressive_frame
        if (pic_struct != 3) refuse("MPEG-2 field pictures (picture_structure %d) are not supported", pic_struct);
        ext_seen = true;
        break;
      }
      case 9:
      case 10:
        refuse("MPEG-2 video with a picture scalable extension is not supported");
      default:
        refuse("corrupt MPEG video: extension_start_code_identifier %d", id);
    }
    if (br.overran()) refuse("truncated MPEG video: a cut extension");
  }

  void picture_header(BitReader& br) {
    if (!have_seq) refuse("corrupt MPEG video: a picture before a sequence header");
    br.get(10);  // temporal reference
    ptype = (int)br.get(3);
    if (ptype == 4) refuse("MPEG-1 D-pictures are not supported");
    if (ptype < 1 || ptype > 4) refuse("corrupt MPEG video: picture_coding_type %d", ptype);
    br.get(16);  // vbv delay
    full_pel[0] = full_pel[1] = 0;
    fcode[0][0] = fcode[0][1] = fcode[1][0] = fcode[1][1] = 7;
    if (ptype >= 2) {
      full_pel[0] = br.get1();
      fcode[0][0] = fcode[0][1] = (int)br.get(3);
      if (!fcode[0][0]) refuse("corrupt MPEG video: forward_f_code 0");
    }
    if (ptype == 3) {
      full_pel[1] = br.get1();
      fcode[1][0] = fcode[1][1] = (int)br.get(3);
      if (!fcode[1][0]) refuse("corrupt MPEG video: backward_f_code 0");
    }
    while (br.get1()) br.get(8);  // extra_information_picture
    if (br.overran()) refuse("truncated MPEG video: a cut picture header");
    dc_prec = 0;
    pic_struct = 3;
    fpfd = 1;
    concealment = q_type = intra_vlc = alt_scan = 0;
    ext_seen = false;
  }

  void start_picture() {
    // the MPEG-1 fields are in force until a picture coding extension says otherwise
    if (mbw == 0 || mbw != (width + 15) / 16 ||
        mbh != ((mpeg2 && !progressive_seq) ? 2 * ((height + 31) / 32) : (height + 15) / 16) ||
        pool[0].p[1].h != mbh * (chroma == 2 ? 16 : 8)) {
      flush_references();
      mbw = (width + 15) / 16;
      mbh = (mpeg2 && !progressive_seq) ? 2 * ((height + 31) / 32) : (height + 15) / 16;
      for (Picture& p : pool) {
        p.p[0].w = mbw * 16;
        p.p[0].h = mbh * 16;
        for (int c = 1; c < 3; ++c) {
          p.p[c].w = mbw * 8;
          p.p[c].h = mbh * (chroma == 2 ? 16 : 8);
        }
        for (Plane& q : p.p) q.px.assign((size_t)q.w * q.h, 128);
      }
      past = future = -1;
      future_pending = false;
    }
    in_picture = true;
    skip_picture = false;
    mb_done = 0;
    mb_seen.assign((size_t)mbw * mbh, 0);
  }

  // After the picture header and its extensions, before the first slice.
  void begin_slices() {
    if (mpeg2 && !ext_seen) refuse("corrupt MPEG video: an MPEG-2 picture without a picture coding extension");
    // libavcodec drops a B-picture of an open GOP whose forward reference is
    // before the stream, and a P-picture with nothing to predict from
    if ((ptype == 3 && past < 0 && !closed_gop) || (ptype == 2 && future < 0)) {
      skip_picture = true;
      return;
    }
    if (mpeg2) {
      for (int s = 0; s < 2; ++s)
        for (int t = 0; t < 2; ++t)
          if ((ptype == 2 && s == 0) || ptype == 3 || (ptype == 1 && concealment && s == 0))
            if (fcode[s][t] < 1 || fcode[s][t] > 9) refuse("corrupt MPEG video: f_code %d", fcode[s][t]);
    }
    cur = 0;
    while (cur == past || cur == future) ++cur;
    pool[cur].type = ptype;
    ++(ptype == 1 ? tally.pictures_i : ptype == 2 ? tally.pictures_p : tally.pictures_b);
    ++(mpeg2 ? tally.mpeg2_pictures : tally.mpeg1_pictures);
    if (dc_prec == 1) ++tally.dc_precision_9;
    if (dc_prec == 2) ++tally.dc_precision_10;
    if (dc_prec == 3) ++tally.dc_precision_11;
    if (intra_vlc) ++tally.intra_vlc_pictures;
    if (alt_scan) ++tally.alternate_scan_pictures;
    if (q_type) ++tally.non_linear_q_pictures;
    if (concealment) ++tally.concealment_pictures;
    if (chroma == 2) ++tally.chroma_422_pictures;
    if (full_pel[0] || full_pel[1]) ++tally.full_pel_pictures;
  }

  void finish_picture() {
    if (!in_picture) return;
    in_picture = false;
    if (skip_picture) {
      if (ptype == 3) ++tally.dropped_b;
      return;
    }
    if (!started) refuse("truncated MPEG video: a picture without slices");
    if (mb_done != mbw * mbh)
      refuse("truncated or corrupt MPEG video: a picture with %d of its %d macroblocks", mb_done, mbw * mbh);
    if (ptype == 3) {
      show(cur);
      if (future_pending) ++tally.reordered;
    } else {
      if (future_pending) show(future);
      past = future;
      future = cur;
      future_pending = true;
    }
  }

  void show(int idx) {
    Picture& p = pool[idx];
    Shown s;
    s.w = width;
    s.h = height;
    s.cw = (width + 1) / 2;
    s.ch = chroma == 2 ? height : (height + 1) / 2;
    s.type = p.type;
    s.y.resize((size_t)s.w * s.h);
    s.u.resize((size_t)s.cw * s.ch);
    s.v.resize((size_t)s.cw * s.ch);
    for (int r = 0; r < s.h; ++r) std::memcpy(&s.y[(size_t)r * s.w], p.p[0].at(0, r), (size_t)s.w);
    for (int r = 0; r < s.ch; ++r) {
      std::memcpy(&s.u[(size_t)r * s.cw], p.p[1].at(0, r), (size_t)s.cw);
      std::memcpy(&s.v[(size_t)r * s.cw], p.p[2].at(0, r), (size_t)s.cw);
    }
    shown.push_back(std::move(s));
  }

  void flush_references() {
    if (future_pending && future >= 0) show(future);
    future_pending = false;
  }

  // ---- slices

  void slice(BitReader& br, int code) {
    if (!in_picture) refuse("corrupt MPEG video: a slice outside a picture");
    if (!started) {
      begin_slices();
      started = true;
    }
    if (skip_picture) return;
    ++tally.slices;
    int mb_y = code - 1;
    if (mpeg2 && height > 2800) mb_y += (int)br.get(3) << 7;
    if (mb_y >= mbh) refuse("corrupt MPEG video: a slice at row %d of %d", mb_y, mbh);
    set_qscale((int)br.get(5));
    if (mpeg2) {
      if (br.peek(1)) {
        br.get(1 + 1 + 7);  // intra_slice_flag, intra_slice, reserved
        while (br.get1()) br.get(8);
      } else {
        br.get1();
      }
    } else {
      while (br.get1()) br.get(8);
    }
    reset_dc();
    std::memset(pmv, 0, sizeof pmv);
    int addr = mb_y * mbw - 1;
    int inc = address_increment(br);
    addr += inc;
    prev_intra = 1;  // no skipped macroblock may open a slice
    for (;;) {
      if (addr >= mbw * mbh) refuse("corrupt MPEG video: macroblock %d past the picture's %d", addr, mbw * mbh);
      macroblock(br, addr);
      if (br.overran()) refuse("truncated MPEG video: a cut slice");
      if (br.peek(23) == 0) break;  // the next start code (or the end of the data)
      inc = address_increment(br);
      if (inc > 1) {
        if (ptype == 1) refuse("corrupt MPEG video: a skipped macroblock in an I-picture");
        start_skip_run();
        for (int k = 1; k < inc; ++k) {
          ++addr;
          if (addr >= mbw * mbh) refuse("corrupt MPEG video: macroblock %d past the picture's %d", addr, mbw * mbh);
          skipped(addr);
        }
      }
      ++addr;
    }
    if (br.pos > br.nbytes * 8) refuse("truncated MPEG video: a cut slice");
  }

  int address_increment(BitReader& br) {
    int inc = 0;
    for (;;) {
      const int s = br.vlc(vlc_addr, "macroblock_address_increment");
      if (s == kAddrStuffing) continue;
      if (s == kAddrEscape) {
        inc += 33;
        continue;
      }
      return inc + s + 1;
    }
  }

  void set_qscale(int code) {
    if (!code) refuse("corrupt MPEG video: quantiser_scale_code 0");
    qscale = q_type ? kNonLinearQ[code] : code << 1;
  }

  void reset_dc() { last_dc[0] = last_dc[1] = last_dc[2] = 128 << dc_prec; }

  void mark(int addr) {
    if (mb_seen[(size_t)addr]) refuse("corrupt MPEG video: macroblock %d coded twice", addr);
    mb_seen[(size_t)addr] = 1;
    ++mb_done;
  }

  // ffmpeg's setup at the start of a run of skipped macroblocks
  void start_skip_run() {
    if (ptype == 2) {
      mv_dir = kFwd;
      mv_field = 0;
      mv[0][0][0] = mv[0][0][1] = 0;
      pmv[0][0][0] = pmv[0][0][1] = pmv[0][1][0] = pmv[0][1][1] = 0;
      field_sel[0][0] = 0;
    } else {
      if (prev_intra) refuse("corrupt MPEG video: a skipped macroblock after an intra one in a B-picture");
      mv[0][0][0] = pmv[0][0][0];
      mv[0][0][1] = pmv[0][0][1];
      mv[1][0][0] = pmv[1][0][0];
      mv[1][0][1] = pmv[1][0][1];
      field_sel[0][0] = field_sel[1][0] = 0;
    }
  }

  void skipped(int addr) {
    mark(addr);
    reset_dc();
    ++(ptype == 2 ? tally.mb_skipped_p : tally.mb_skipped_b);
    const int mx = addr % mbw, my = addr / mbw;
    predict(mx, my);
  }

  int motion_delta(BitReader& br, int f) {
    const int code = br.vlc(vlc_motion, "motion_code");
    if (code == 0) return 0;
    const int sign = br.get1();
    int v = code;
    if (f > 1) {
      v = ((v - 1) << (f - 1)) | (int)br.get(f - 1);
      ++v;
    }
    return sign ? -v : v;
  }

  int motion(BitReader& br, int f, int pred) {
    if (f < 1 || f > 9) refuse("corrupt MPEG video: a vector with f_code %d", f);
    const int delta = motion_delta(br, f);
    if (!delta) return pred;
    const int bits = 5 + f - 1, v = pred + delta;
    const int wrapped = (int)((uint32_t)v << (32 - bits)) >> (32 - bits);  // sign_extend
    if (wrapped != v) ++tally.mv_wraps;
    return wrapped;
  }

  void vectors(BitReader& br, int s, int motion_type) {
    if (!mpeg2) {
      for (int t = 0; t < 2; ++t) {
        const int v = motion(br, fcode[s][0], pmv[s][0][t]);
        pmv[s][0][t] = pmv[s][1][t] = v;
        mv[s][0][t] = v * (1 << full_pel[s]);
      }
      return;
    }
    if (motion_type == 2) {  // frame
      for (int t = 0; t < 2; ++t) {
        const int v = motion(br, fcode[s][t], pmv[s][0][t]);
        pmv[s][0][t] = pmv[s][1][t] = mv[s][0][t] = v;
      }
    } else {  // field, in a frame picture
      for (int r = 0; r < 2; ++r) {
        field_sel[s][r] = br.get1();
        int v = motion(br, fcode[s][0], pmv[s][r][0]);
        pmv[s][r][0] = mv[s][r][0] = v;
        v = motion(br, fcode[s][1], pmv[s][r][1] >> 1);
        pmv[s][r][1] = 2 * v;
        mv[s][r][1] = v;
      }
    }
  }

  void macroblock(BitReader& br, int addr) {
    mark(addr);
    const int mx = addr % mbw, my = addr / mbw;
    const int type = ptype == 1 ? kMbTypeIFlags[br.vlc(vlc_i, "macroblock_type")]
                     : ptype == 2 ? kMbTypePFlags[br.vlc(vlc_p, "macroblock_type")]
                                  : kMbTypeBFlags[br.vlc(vlc_b, "macroblock_type")];
    int motion_type = 2, dct_type = 0;
    if (mpeg2 && (type & (kFwd | kBwd))) {
      if (!fpfd) motion_type = (int)br.get(2);
      if (motion_type == 3) refuse("MPEG-2 dual-prime prediction is not supported");
      if (motion_type == 0) refuse("corrupt MPEG video: frame_motion_type 0");
    }
    if (mpeg2 && !fpfd && (type & (kIntra | kPat))) dct_type = br.get1();
    if (dct_type) ++tally.field_dct;
    if (type & kQuant) {
      set_qscale((int)br.get(5));
      ++tally.mb_quant;
    }
    const int nblocks = chroma == 2 ? 8 : 6;
    if (type & kIntra) {
      ++tally.mb_intra;
      if (ptype != 1) ++tally.mb_intra_in_p_b;
      if (concealment) {
        for (int t = 0; t < 2; ++t) {
          const int v = motion(br, fcode[0][t], pmv[0][0][t]);
          pmv[0][0][t] = pmv[0][1][t] = mv[0][0][t] = v;
        }
        br.marker("concealment motion vectors");
      } else {
        std::memset(pmv, 0, sizeof pmv);
      }
      prev_intra = 1;
      for (int b = 0; b < nblocks; ++b) intra_block(br, b);
      for (int b = 0; b < nblocks; ++b) put_block(mx, my, b, dct_type, false);
      return;
    }
    prev_intra = 0;
    if (!(type & (kFwd | kBwd))) {  // P, no motion compensation: a zero vector
      ++tally.mb_no_mc;
      mv_dir = kFwd;
      mv_field = 0;
      mv[0][0][0] = mv[0][0][1] = 0;
      pmv[0][0][0] = pmv[0][0][1] = pmv[0][1][0] = pmv[0][1][1] = 0;
      field_sel[0][0] = 0;
    } else {
      mv_dir = type & (kFwd | kBwd);
      mv_field = motion_type == 1;
      if (type & kFwd) vectors(br, 0, motion_type);
      if (type & kBwd) vectors(br, 1, motion_type);
      if ((type & kFwd) && (type & kBwd)) ++tally.mb_interpolated;
      else if (type & kFwd) ++tally.mb_forward;
      else ++tally.mb_backward;
    }
    reset_dc();
    int cbp = 0;
    if (type & kPat) {
      cbp = br.vlc(vlc_cbp, "coded_block_pattern");
      if (!mpeg2 && cbp == 0) refuse("corrupt MPEG video: coded_block_pattern 0 in MPEG-1");
      if (chroma == 2) cbp = (cbp << 2) | (int)br.get(2);
    }
    predict(mx, my);
    for (int b = 0; b < nblocks; ++b) {
      if (!(cbp & (1 << (nblocks - 1 - b)))) continue;
      inter_block(br, b);
      put_block(mx, my, b, dct_type, true);
    }
  }

  // ---- blocks

  int dc_diff(BitReader& br, int comp) {
    const int size = br.vlc(comp ? vlc_dc_chrom : vlc_dc_lum, "dct_dc_size");
    if (!size) return 0;
    const int v = (int)br.get(size);
    return v < (1 << (size - 1)) ? v - (1 << size) + 1 : v;
  }

  const uint8_t* scan() const { return alt_scan ? kAlternate : kZigzag; }

  // One coefficient after the first: (run, level) with the sign applied, or run -1 at the end of the block.
  void coefficient(BitReader& br, const Vlc& t, int& run, int& level) {
    const int s = br.vlc(t, "dct_coefficient");
    if (s == kEob) {
      run = -1;
      return;
    }
    if (s == kEscape) {
      ++tally.escapes;
      run = (int)br.get(6);
      if (mpeg2) {
        level = br.sbits(12);
      } else {
        level = br.sbits(8);
        if (level == -128) {
          level = (int)br.get(8) - 256;
          ++tally.escapes_long;
        } else if (level == 0) {
          level = (int)br.get(8);
          ++tally.escapes_long;
        }
      }
      return;
    }
    run = kTcoefRun[s];
    level = br.get1() ? -kTcoefLevel[s] : kTcoefLevel[s];
  }

  void intra_block(BitReader& br, int b) {
    int16_t* blk_ = blk[b];
    std::memset(blk_, 0, sizeof(int16_t) * 64);
    const int comp = b < 4 ? 0 : 1 + (b & 1);
    const uint8_t* m = comp ? cintra_m : intra_m;
    const uint8_t* sc = scan();
    const int dc = last_dc[comp] + dc_diff(br, comp);
    last_dc[comp] = dc;
    int mismatch;
    if (mpeg2) {
      blk_[0] = (int16_t)(dc * (1 << (3 - dc_prec)));
      mismatch = blk_[0] ^ 1;
    } else {
      blk_[0] = (int16_t)(dc * m[0]);
      mismatch = 0;
    }
    const Vlc& t = (mpeg2 && intra_vlc) ? vlc_b15 : vlc_b14;
    int i = 0;
    for (;;) {
      int run, level;
      coefficient(br, t, run, level);
      if (run < 0) break;
      i += run + 1;
      if (i > 63) refuse("corrupt MPEG video: a block of more than 64 coefficients");
      const int j = sc[i];
      const int a = level < 0 ? -level : level;
      int v;
      if (mpeg2) {
        v = (a * qscale * m[j]) >> 4;
      } else {
        v = (a * qscale * m[j]) >> 4;
        v = (v - 1) | 1;
      }
      v = level < 0 ? -v : v;
      mismatch ^= v;
      blk_[j] = (int16_t)v;
    }
    if (mpeg2) mismatch_control(blk_, mismatch);
  }

  void inter_block(BitReader& br, int b) {
    int16_t* blk_ = blk[b];
    std::memset(blk_, 0, sizeof(int16_t) * 64);
    const uint8_t* m = b < 4 ? inter_m : cinter_m;
    const uint8_t* sc = scan();
    int mismatch = 1, i = -1;
    if (br.peek(1)) {  // the first coefficient's short code: run 0, level 1
      int v = (3 * qscale * m[0]) >> 5;
      if (!mpeg2) v = (v - 1) | 1;
      br.get1();
      if (br.get1()) v = -v;
      blk_[0] = (int16_t)v;
      mismatch ^= v;
      i = 0;
      if (br.peek(2) == 2) {  // End of Block
        br.get(2);
        if (mpeg2) mismatch_control(blk_, mismatch);
        return;
      }
    }
    for (;;) {
      int run, level;
      coefficient(br, vlc_b14, run, level);
      if (run < 0) {
        if (i < 0) refuse("corrupt MPEG video: an End of Block first in a coded block");
        break;
      }
      i += run + 1;
      if (i > 63) refuse("corrupt MPEG video: a block of more than 64 coefficients");
      const int j = sc[i];
      const int a = level < 0 ? -level : level;
      int v = ((a * 2 + 1) * qscale * m[j]) >> 5;
      if (!mpeg2) v = (v - 1) | 1;
      v = level < 0 ? -v : v;
      mismatch ^= v;
      blk_[j] = (int16_t)v;
    }
    if (mpeg2) mismatch_control(blk_, mismatch);
  }

  void mismatch_control(int16_t* b, int mismatch) {
    if (mismatch & 1) {
      b[63] = (int16_t)(b[63] ^ 1);
      ++tally.mismatch_toggles;
    }
  }

  void put_block(int mx, int my, int b, int dct_type, bool add) {
    Picture& p = pool[cur];
    if (b < 4) {
      Plane& pl = p.p[0];
      int x = mx * 16 + (b & 1) * 8, y = my * 16, stride = pl.w;
      if (dct_type) {
        y += b >> 1;
        stride *= 2;
      } else {
        y += (b >> 1) * 8;
      }
      simple_idct::idct(blk[b], pl.at(x, y), stride, add);
      return;
    }
    const int c = 1 + (b & 1);
    Plane& pl = p.p[c];
    const int x = mx * 8;
    int y, stride = pl.w;
    if (chroma == 1) {
      y = my * 8;
    } else {
      const int lower = (b - 4) >> 1;
      y = my * 16;
      if (dct_type) {
        y += lower;
        stride *= 2;
      } else {
        y += lower * 8;
      }
    }
    simple_idct::idct(blk[b], pl.at(x, y), stride, add);
  }

  // ---- prediction

  // A w x h block of ref at (x, y) in half samples (dxy: bit 0 horizontal, bit 1 vertical), put or averaged into dst.
  static void hpel(const uint8_t* src, int sstride, uint8_t* dst, int dstride, int w, int h, int dxy, bool avg) {
    for (int r = 0; r < h; ++r) {
      const uint8_t* s0 = src + (size_t)r * sstride;
      const uint8_t* s1 = s0 + sstride;
      uint8_t* d = dst + (size_t)r * dstride;
      for (int c = 0; c < w; ++c) {
        int v;
        switch (dxy) {
          case 0: v = s0[c]; break;
          case 1: v = (s0[c] + s0[c + 1] + 1) >> 1; break;
          case 2: v = (s0[c] + s1[c] + 1) >> 1; break;
          default: v = (s0[c] + s0[c + 1] + s1[c] + s1[c + 1] + 2) >> 2; break;
        }
        d[c] = (uint8_t)(avg ? (d[c] + v + 1) >> 1 : v);
      }
    }
  }

  // ffmpeg's mpeg_motion_internal for MPEG-1/2: a frame (field_based 0) or
  // one field's (field_based 1, bottom: the destination field, sel: the
  // source field) prediction of the macroblock from ref.
  void mc(int mx, int my, Picture& ref, int field_based, int bottom, int sel, int vx, int vy, bool avg) {
    Picture& p = pool[cur];
    const int lw = p.p[0].w, cw = p.p[1].w;
    const int h = 16 >> field_based;
    const int ls = lw << field_based, cs = cw << field_based;
    const int hedge = mbw * 16, vedge = (mbh * 16) >> field_based;
    const int dxy = ((vy & 1) << 1) | (vx & 1);
    const int sx = mx * 16 + (vx >> 1), sy = (my << (4 - field_based)) + (vy >> 1);
    if (vx & 1 || vy & 1) ++tally.halfpel_vectors;
    if (sx < 0 || sy < 0 || sx > hedge - (vx & 1) - 16 || sy > vedge - (vy & 1) - h)
      refuse("MPEG video with a motion vector out of the picture (%d, %d) is not supported", vx, vy);
    int cvx, cvy, cdxy, csx, csy, ch;
    if (chroma == 1) {
      cvx = vx / 2;
      cvy = vy / 2;
      cdxy = ((cvy & 1) << 1) | (cvx & 1);
      csx = mx * 8 + (cvx >> 1);
      csy = (my << (3 - field_based)) + (cvy >> 1);
      ch = h >> 1;
    } else {
      cvx = vx / 2;
      cdxy = ((vy & 1) << 1) | (cvx & 1);
      csx = mx * 8 + (cvx >> 1);
      csy = sy;
      ch = h;
    }
    if (csx < 0 || csy < 0 || csx > cw - (cdxy & 1) - 8 || csy > ((ref.p[1].h) >> field_based) - (cdxy >> 1) - ch)
      refuse("MPEG video with a motion vector out of the picture (%d, %d) is not supported", vx, vy);
    const int off_l = (bottom ? lw : 0), soff_l = (sel ? lw : 0);
    const int off_c = (bottom ? cw : 0), soff_c = (sel ? cw : 0);
    hpel(ref.p[0].px.data() + soff_l + (size_t)sy * ls + sx, ls,
         p.p[0].px.data() + off_l + (size_t)((my << (4 - field_based)) * ls) + mx * 16, ls, 16, h, dxy, avg);
    const int dy = (my << (4 - field_based)) >> (chroma == 1 ? 1 : 0);
    for (int c = 1; c < 3; ++c)
      hpel(ref.p[c].px.data() + soff_c + (size_t)csy * cs + csx, cs,
           p.p[c].px.data() + off_c + (size_t)dy * cs + mx * 8, cs, 8, ch, cdxy, avg);
  }

  void predict(int mx, int my) {
    bool avg = false;
    for (int s = 0; s < 2; ++s) {
      if (!(mv_dir & (s ? kBwd : kFwd))) continue;
      const int r = ptype == 2 || s ? future : past;  // a P-picture predicts from the latest reference
      if (r < 0) refuse("corrupt MPEG video: a prediction without its reference picture");
      Picture& ref = pool[r];
      if (!mv_field) {
        ++tally.frame_pred;
        mc(mx, my, ref, 0, 0, 0, mv[s][0][0], mv[s][0][1], avg);
      } else {
        ++tally.field_pred;
        for (int f = 0; f < 2; ++f) mc(mx, my, ref, 1, f, field_sel[s][f], mv[s][f][0], mv[s][f][1], avg);
      }
      avg = true;
    }
  }

  // ---- the stream

  // Decodes every start code unit of data; a picture ends at the end of the data.
  void feed(const uint8_t* d, size_t n) {
    size_t i = 0;
    auto next_code = [&](size_t from) {
      for (size_t k = from; k + 3 < n + 1 && k + 2 < n; ++k)
        if (d[k] == 0 && d[k + 1] == 0 && d[k + 2] == 1) return k;
      return n;
    };
    i = next_code(0);
    if (i == n && n) refuse("corrupt MPEG video: no start code in %zu bytes", n);
    while (i < n) {
      if (i + 3 >= n) refuse("truncated MPEG video: a start code cut at the end");
      const int code = d[i + 3];
      const size_t body = i + 4, end = next_code(body);
      BitReader br(d + body, end - body);
      if (code == 0x00) {
        finish_picture();
        picture_header(br);
        start_picture();
        started = false;
      } else if (code >= 0x01 && code <= 0xAF) {
        slice(br, code);
      } else if (code == 0xB3) {
        finish_picture();
        sequence_header(br);
      } else if (code == 0xB5) {
        extension(br);
      } else if (code == 0xB8) {
        finish_picture();
        br.get(25);  // time code
        closed_gop = br.get1();
        br.get1();  // broken_link
        ++(closed_gop ? tally.closed_gops : tally.open_gops);
      } else if (code == 0xB7) {
        finish_picture();
      } else if (code == 0xB2) {
        // user data
      } else {
        refuse("corrupt MPEG video: start code 0x%02X in the video stream", code);
      }
      i = end;
    }
    if (in_picture && !started && !skip_picture) refuse("truncated MPEG video: a picture without slices");
    finish_picture();
  }
};

}  // namespace

extern "C" {

void* mga_mpeg12_new() {
  try {
    return new Decoder();
  } catch (...) {
    return nullptr;
  }
}

void mga_mpeg12_free(void* h) { delete static_cast<Decoder*>(h); }

// Decodes a chunk of elementary stream holding whole pictures; the number of
// frames ready, or -1 with the reason in err.
int mga_mpeg12_decode(void* h, const uint8_t* data, int64_t n, char* err, int errlen) {
  Decoder* d = static_cast<Decoder*>(h);
  return guarded(err, errlen, [&] {
    d->feed(data, (size_t)n);
    return (int)d->shown.size();
  });
}

// Shows the last reference picture (the end of the stream); the number of frames ready.
int mga_mpeg12_flush(void* h) {
  Decoder* d = static_cast<Decoder*>(h);
  d->flush_references();
  return (int)d->shown.size();
}

// The next frame's width, height, chroma width and rows and picture type;
// 0 when none is ready.
int mga_mpeg12_peek(void* h, int32_t* info) {
  Decoder* d = static_cast<Decoder*>(h);
  if (d->shown.empty()) return 0;
  const Shown& s = d->shown.front();
  info[0] = s.w;
  info[1] = s.h;
  info[2] = s.cw;
  info[3] = s.ch;
  info[4] = s.type;
  return 1;
}

void mga_mpeg12_pop(void* h, uint8_t* y, uint8_t* u, uint8_t* v) {
  Decoder* d = static_cast<Decoder*>(h);
  if (d->shown.empty()) return;
  const Shown& s = d->shown.front();
  std::memcpy(y, s.y.data(), s.y.size());
  std::memcpy(u, s.u.data(), s.u.size());
  std::memcpy(v, s.v.data(), s.v.size());
  d->shown.pop_front();
}

int mga_mpeg12_tally(void* h, int64_t* out, int n) {
  const Decoder* d = static_cast<const Decoder*>(h);
  const int total = (int)(sizeof(Tally) / sizeof(int64_t));
  std::memcpy(out, &d->tally, sizeof(int64_t) * (size_t)std::min(n, total));
  return total;
}

}  // extern "C"
