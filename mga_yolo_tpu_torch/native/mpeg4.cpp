// MPEG-4 Part 2 (ISO/IEC 14496-2) Simple profile video on the host: the
// decoder computes what ffmpeg's mpeg4 decoder computes for such a stream
// (the mp4v / XVID / DIVX / FMP4 streams cv2 writes), and the encoder writes
// I-VOPs that ffmpeg decodes.
//
// Decoder: video object layer headers from the stream or from the
// container's decoder configuration (esds), I-VOPs and P-VOPs, intra DC and
// AC prediction (ac_pred_flag, alternate scans), the intra and inter
// coefficient tables with all three escape modes, H.263 dequantisation,
// dquant, intra_dc_vlc_thr, median motion-vector prediction, half-sample
// motion compensation with vop_rounding_type, 4MV, unrestricted vectors
// (the reference extended past its edges), not-coded macroblocks,
// vop_coded = 0 (no frame: ffmpeg outputs none, so cv2 reads on), and resync
// markers with video packets (prediction does not cross a packet). The
// inverse DCT is ffmpeg's "simple" integer IDCT.
//
// Refused by name: B-VOPs (Advanced Simple profile and packed bitstreams),
// quarter-sample motion, GMC and sprites, interlacing, data partitioning and
// RVLC, non-rectangular shapes, not_8_bit, quant_type 1 (MPEG matrices),
// OBMC, scalability, complexity estimation headers, and any truncated or
// corrupt stream (no concealment: nothing is padded with grey).
//
// Encoder: a VOS, VO and VOL header, then I-VOPs at a fixed quantiser with
// ac_pred_flag 0, one video packet each.
//
// No global state: a decoder owns its frames and tables. Every read of the
// input is bounds-checked.

#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
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

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", msg);
}

template <class F>
int guarded(char* err, int errlen, F&& f) {
  try {
    f();
    return 0;
  } catch (const Refused& e) {
    set_error(err, errlen, e.what());
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return -1;
}

// ------------------------------------------------------------------ tables
// The variable-length codes of ISO/IEC 14496-2 Annex B (H.263's where shared),
// as (code, length).

struct Code {
  uint16_t code;
  uint8_t len;
};

// MCBPC of an I-VOP: cbpc 0-3 of Intra, of IntraQ, then stuffing.
constexpr Code kMcbpcI[9] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4}, {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// MCBPC of a P-VOP: cbpc 0-3 of Inter, Intra, InterQ, IntraQ, Inter4V, then stuffing.
constexpr Code kMcbpcP[21] = {{1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8}, {3, 7}, {3, 3}, {7, 7}, {6, 7},
                              {5, 9}, {4, 6}, {4, 9}, {3, 9}, {2, 9}, {2, 3}, {5, 7}, {4, 7}, {5, 8}, {1, 9}};
enum { kInter = 0, kIntra = 1, kInterQ = 2, kIntraQ = 3, kInter4V = 4 };
constexpr Code kCbpy[16] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                            {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// Motion vector differences 0..32 (a sign bit follows a nonzero one).
constexpr Code kMvd[33] = {{1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},   {3, 7},   {11, 9},
                           {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}, {11, 10},
                           {10, 10}, {9, 10},  {8, 10},  {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},
                           {5, 11},  {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
constexpr Code kDcLum[13] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                             {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
constexpr Code kDcChrom[13] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},  {1, 5},  {1, 6},
                               {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

// Coefficient tables: 102 (last, run, level) codes, a sign bit after each, then ESCAPE.
struct TcoefTable {
  Code vlc[103];
  int8_t run[102], level[102];
  int last_start;  // first index with last = 1
};

constexpr TcoefTable kInterTcoef = {
    {{0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},  {0x24, 9},  {0x21, 10}, {0x20, 10},
     {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x6, 3},   {0x14, 6},  {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12},
     {0xe, 4},   {0x1d, 8},  {0xe, 10},  {0x51, 12}, {0xd, 5},   {0x23, 9},  {0xd, 10},  {0xc, 5},   {0x22, 9},
     {0x52, 12}, {0xb, 5},   {0xc, 10},  {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},  {0xa, 10},
     {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12}, {0x15, 7},  {0x14, 7},  {0x1c, 8},
     {0x1b, 8},  {0x21, 9},  {0x20, 9},  {0x1f, 9},  {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},
     {0x22, 11}, {0x23, 11}, {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},  {0x5, 11},  {0xf, 6},   {0x4, 11},
     {0xe, 6},   {0xd, 6},   {0xc, 6},   {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},  {0x1a, 8},  {0x19, 8},
     {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},  {0x13, 8},  {0x18, 9},  {0x17, 9},  {0x16, 9},
     {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},
     {0x24, 11}, {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12}, {0x5a, 12}, {0x5b, 12}, {0x5c, 12},
     {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}},
    {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  2,  2,  2,  2,  3,  3,  3,  4,
     4,  4,  5,  5,  5,  6,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
     21, 22, 23, 24, 25, 26, 0,  0,  0,  1,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
     17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40},
    {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2, 3, 1,
     2, 3, 1, 2, 3, 1, 2, 3, 1, 2,  1,  2,  1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 2, 3, 1,  2,  1,  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    58};

constexpr TcoefTable kIntraTcoef = {
    {{0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},  {0x13, 6},  {0x12, 6},  {0x17, 7},
     {0x1f, 8},  {0x1e, 8},  {0x1d, 8},  {0x25, 9},  {0x24, 9},  {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10},
     {0xf, 10},  {0xe, 10},  {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x21, 11}, {0x50, 12}, {0x51, 12}, {0x52, 12},
     {0xe, 4},   {0x14, 6},  {0x16, 7},  {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11}, {0x53, 12},
     {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12}, {0x11, 6},  {0x1b, 8},  {0x1d, 9},
     {0xb, 10},  {0x10, 6},  {0x22, 9},  {0xa, 10},  {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},
     {0x54, 12}, {0x14, 7},  {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},  {0x18, 8},  {0x23, 11}, {0x17, 8},
     {0x19, 9},  {0x18, 9},  {0x7, 10},  {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},  {0x17, 9},  {0x6, 10},
     {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},  {0x5, 10},  {0xe, 6},   {0x4, 10},  {0x11, 7},
     {0x24, 11}, {0x10, 7},  {0x25, 11}, {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},
     {0x1a, 8},  {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},  {0x26, 11}, {0x27, 11}, {0x5c, 12},
     {0x5d, 12}, {0x5e, 12}, {0x5f, 12}, {0x3, 7}},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
     0, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  2,  2,  2,  2,  2,  3,  3,  3,  3,  4,  4,  4,  5,  5,  5,
     6, 6, 6, 7, 7, 7, 8, 8, 9, 9,  10, 11, 12, 13, 14, 0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,
     2, 2, 3, 3, 4, 4, 5, 5, 6, 6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20},
    {1,  2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
     27, 1, 2, 3, 4, 5, 6, 7, 8, 9,  10, 1,  2,  3,  4,  5,  1,  2,  3,  4,  1,  2,  3,  1,  2,  3,
     1,  2, 3, 1, 2, 3, 1, 2, 1, 2,  1,  1,  1,  1,  1,  1,  2,  3,  4,  5,  6,  7,  8,  1,  2,  3,
     1,  2, 1, 2, 1, 2, 1, 2, 1, 2,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1},
    67};

constexpr uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                                 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                                 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                                 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
constexpr uint8_t kAltHorizontal[64] = {0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
                                        13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
                                        30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
                                        46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
constexpr uint8_t kAltVertical[64] = {0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
                                      41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
                                      51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
                                      53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

constexpr int kDquant[4] = {-1, -2, 1, 2};
constexpr int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};  // intra_dc_vlc_thr -> QP below which DC has its VLC

inline int y_dc_scale(int q) { return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16; }
inline int c_dc_scale(int q) { return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6; }
inline int mid3(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }
inline int rounded_div(int a, int b) { return (a > 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

// A decoding table: the next `bits` bits -> (symbol, length); length 0 marks no code.
struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  void build(const Code* codes, int n, int maxbits) {
    bits = maxbits;
    sym.assign((size_t)1 << bits, 0);
    len.assign((size_t)1 << bits, 0);
    for (int i = 0; i < n; ++i) {
      const int l = codes[i].len, lo = codes[i].code << (bits - l), hi = (codes[i].code + 1) << (bits - l);
      for (int j = lo; j < hi; ++j) {
        sym[j] = (int16_t)i;
        len[j] = (uint8_t)l;
      }
    }
  }
};

// ------------------------------------------------------------------ bits

struct BitReader {
  const uint8_t* d = nullptr;
  size_t nbytes = 0, pos = 0;  // pos in bits
  BitReader() = default;
  BitReader(const uint8_t* d_, size_t n_) : d(d_), nbytes(n_) {}
  uint32_t peek(int k) const {  // 1 <= k <= 32; zeros past the end
    const size_t b = pos >> 3;
    uint64_t v = 0;
    if (b + 8 <= nbytes) {
      for (int i = 0; i < 8; ++i) v = (v << 8) | d[b + i];
    } else {
      for (int i = 0; i < 8; ++i) v = (v << 8) | (b + i < nbytes ? d[b + i] : 0);
    }
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
  void marker(const char* what) {
    if (!get1()) refuse("corrupt MPEG-4 video: a marker bit is 0 in the %s", what);
  }
  bool overran() const { return pos > nbytes * 8; }
  size_t left() const { return pos >= nbytes * 8 ? 0 : nbytes * 8 - pos; }
  int vlc(const Vlc& t, const char* what) {
    const uint32_t p = peek(t.bits);
    const int l = t.len[p];
    if (!l) refuse("corrupt MPEG-4 video: no %s code matches", what);
    pos += (size_t)l;
    return t.sym[p];
  }
};

struct BitWriter {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int n = 0;
  void put(uint32_t v, int k) {  // k <= 32
    for (int i = k - 1; i >= 0; --i) {
      acc = (acc << 1) | ((v >> i) & 1);
      if (++n == 8) {
        out.push_back((uint8_t)acc);
        acc = 0;
        n = 0;
      }
    }
  }
  void put(const Code& c) { put(c.code, c.len); }
  void stuff() {  // next_start_code(): a 0, then 1s to the byte boundary
    put(0, 1);
    while (n) put(1, 1);
  }
  void start_code(uint8_t c) {
    put(0x000001, 24);
    put(c, 8);
  }
};

// ------------------------------------------------------------------ frames

struct Plane {
  int w = 0, h = 0;  // allocated: whole macroblocks
  std::vector<uint8_t> px;
  void alloc(int w_, int h_) {
    w = w_;
    h = h_;
    px.assign((size_t)w * h, 128);
  }
  uint8_t* at(int x, int y) { return px.data() + (size_t)y * w + x; }
};

struct Frame {
  Plane p[3];
};

// ------------------------------------------------------------------ decoder

struct Decoder {
  // video object layer
  bool have_vol = false;
  int width = 0, height = 0, mbw = 0, mbh = 0, time_bits = 1, mb_num_bits = 1;
  bool resync = false;
  // frames
  Frame cur, ref;
  bool have_ref = false;
  int last_type = 0;
  // per macroblock and block state of the VOP being decoded
  std::vector<int> mb_packet;        // packet number, -1 before decoding
  std::vector<uint8_t> mb_intra, mb_qp;
  std::vector<int> dc[3];            // reconstructed DC per block (luma 2mbw x 2mbh, chroma mbw x mbh)
  std::vector<int16_t> ac[3];        // first row [0..7) and column [7..14) of QF per block
  std::vector<int> mv;               // luma blocks, (x, y) half samples
  Vlc vlc_mcbpc_i, vlc_mcbpc_p, vlc_cbpy, vlc_mvd, vlc_dc_lum, vlc_dc_chrom, vlc_inter, vlc_intra;
  int max_level[2][2][64], max_run[2][2][64];  // [intra][last][run or level]

  Decoder() {
    vlc_mcbpc_i.build(kMcbpcI, 9, 9);
    vlc_mcbpc_p.build(kMcbpcP, 21, 9);
    vlc_cbpy.build(kCbpy, 16, 6);
    vlc_mvd.build(kMvd, 33, 12);
    vlc_dc_lum.build(kDcLum, 13, 11);
    vlc_dc_chrom.build(kDcChrom, 13, 12);
    vlc_inter.build(kInterTcoef.vlc, 103, 12);
    vlc_intra.build(kIntraTcoef.vlc, 103, 12);
    std::memset(max_level, 0, sizeof max_level);
    std::memset(max_run, 0, sizeof max_run);
    for (int intra = 0; intra < 2; ++intra) {
      const TcoefTable& t = intra ? kIntraTcoef : kInterTcoef;
      for (int i = 0; i < 102; ++i) {
        const int last = i >= t.last_start, run = t.run[i], level = t.level[i];
        max_level[intra][last][run] = std::max(max_level[intra][last][run], level);
        max_run[intra][last][level] = std::max(max_run[intra][last][level], run);
      }
    }
  }

  // ---- headers

  void read_vol(BitReader& br) {
    br.get1();  // random_accessible_vol
    br.get(8);  // video_object_type_indication: the tools used are refused one by one below
    int verid = 1;
    if (br.get1()) {
      verid = (int)br.get(4);
      br.get(3);
    }
    if (br.get(4) == 15) br.get(16);  // aspect_ratio_info: extended PAR
    if (br.get1()) {                  // vol_control_parameters
      if (br.get(2) != 1) refuse("MPEG-4 video: chroma format other than 4:2:0 is not supported");
      br.get1();  // low_delay
      if (br.get1()) {  // vbv_parameters
        br.get(15);
        br.marker("VOL");
        br.get(15);
        br.marker("VOL");
        br.get(15);
        br.marker("VOL");
        br.get(3);
        br.get(11);
        br.marker("VOL");
        br.get(15);
        br.marker("VOL");
      }
    }
    const int shape = (int)br.get(2);
    if (shape != 0) refuse("MPEG-4 video: non-rectangular shapes (video_object_layer_shape %d) are not supported", shape);
    br.marker("VOL");
    const int res = (int)br.get(16);
    if (res == 0) refuse("corrupt MPEG-4 video: vop_time_increment_resolution is 0");
    int bits = 1;
    while ((1 << bits) < res) ++bits;
    br.marker("VOL");
    if (br.get1()) br.get(bits);  // fixed_vop_rate, fixed_vop_time_increment
    br.marker("VOL");
    const int w = (int)br.get(13);
    br.marker("VOL");
    const int h = (int)br.get(13);
    br.marker("VOL");
    if (w == 0 || h == 0) refuse("corrupt MPEG-4 video: a VOL of %dx%d", w, h);
    if (br.get1()) refuse("interlaced MPEG-4 video is not supported");
    if (!br.get1()) refuse("MPEG-4 video with OBMC is not supported");
    const int sprite = (int)br.get(verid == 1 ? 1 : 2);
    if (sprite) refuse("MPEG-4 video with sprites or GMC (sprite_enable %d) is not supported", sprite);
    if (br.get1()) refuse("MPEG-4 video with not_8_bit is not supported");
    if (br.get1()) refuse("MPEG-4 video with quant_type 1 (MPEG quantisation matrices) is not supported");
    if (verid != 1 && br.get1()) refuse("MPEG-4 video with quarter-sample motion is not supported");
    if (!br.get1()) refuse("MPEG-4 video with complexity estimation headers is not supported");
    const bool resync_disable = br.get1();
    if (br.get1()) refuse("MPEG-4 video with data partitioning (and RVLC) is not supported");
    if (verid != 1) {
      if (br.get1()) refuse("MPEG-4 video with NEWPRED is not supported");
      if (br.get1()) refuse("MPEG-4 video with reduced-resolution VOPs is not supported");
    }
    if (br.get1()) refuse("scalable MPEG-4 video is not supported");
    if (br.overran()) refuse("truncated MPEG-4 video: VOL header");
    if ((int64_t)w * h > (int64_t)1 << 26) refuse("MPEG-4 video of %dx%d is past the limit of 2^26 pixels", w, h);
    if (have_vol && (w != width || h != height)) have_ref = false;
    width = w;
    height = h;
    time_bits = bits;
    resync = !resync_disable;
    mbw = (w + 15) / 16;
    mbh = (h + 15) / 16;
    mb_num_bits = 1;
    while ((1 << mb_num_bits) < mbw * mbh) ++mb_num_bits;
    if (!have_vol || cur.p[0].w != mbw * 16 || cur.p[0].h != mbh * 16) {
      for (Frame* f : {&cur, &ref}) {
        f->p[0].alloc(mbw * 16, mbh * 16);
        f->p[1].alloc(mbw * 8, mbh * 8);
        f->p[2].alloc(mbw * 8, mbh * 8);
      }
      const size_t nmb = (size_t)mbw * mbh;
      mb_packet.assign(nmb, -1);
      mb_intra.assign(nmb, 0);
      mb_qp.assign(nmb, 1);
      dc[0].assign(nmb * 4, 1024);
      dc[1].assign(nmb, 1024);
      dc[2].assign(nmb, 1024);
      ac[0].assign(nmb * 4 * 14, 0);
      ac[1].assign(nmb * 14, 0);
      ac[2].assign(nmb * 14, 0);
      mv.assign(nmb * 4 * 2, 0);
      have_ref = false;
    }
    have_vol = true;
  }

  // Decodes one chunk (a container sample, or decoder configuration).
  // Returns true when a frame came out of it.
  bool decode(const uint8_t* d, size_t n) {
    bool frame = false, coded_seen = false;
    size_t i = 0;
    for (;;) {
      while (i + 3 < n && !(d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1)) ++i;
      if (i + 3 >= n) break;
      const int code = d[i + 3];
      BitReader br(d + i + 4, n - i - 4);
      if (code >= 0x20 && code <= 0x2F) {
        read_vol(br);
      } else if (code == 0xB6) {
        if (coded_seen) refuse("packed MPEG-4 bitstream (two VOPs in one sample, as with B-VOPs) is not supported");
        if (!have_vol) refuse("MPEG-4 video: a VOP before any VOL header");
        frame = decode_vop(br);
        coded_seen = true;
      }
      i += 4;  // VOS, VO, GOV, user data and other start codes carry nothing the decoding needs
    }
    return frame;
  }

  int packet_start = 0, packet = 0;

  // Decodes a VOP into the reference; false for an uncoded one, which ffmpeg
  // (and so cv2) passes over without a frame.
  bool decode_vop(BitReader& br) {
    const int type = (int)br.get(2);
    if (type == 2) refuse("MPEG-4 video with B-VOPs is not supported (Simple profile only)");
    if (type == 3) refuse("MPEG-4 video with S-VOPs (sprites, GMC) is not supported");
    while (br.get1())
      if (br.overran()) refuse("truncated MPEG-4 video: VOP header");
    br.marker("VOP header");
    br.get(time_bits);
    br.marker("VOP header");
    if (!br.get1()) return false;  // vop_coded = 0
    if (type == 1 && !have_ref) refuse("corrupt MPEG-4 video: a P-VOP with no reference frame");
    const int rounding = type == 1 ? br.get1() : 0;
    int dc_thr = kDcThreshold[br.get(3)];
    int qp = (int)br.get(5);
    if (qp == 0) refuse("corrupt MPEG-4 video: vop_quant is 0");
    int fcode = 1;
    if (type == 1) {
      fcode = (int)br.get(3);
      if (fcode == 0) refuse("corrupt MPEG-4 video: vop_fcode_forward is 0");
    }
    if (br.overran()) refuse("truncated MPEG-4 video: VOP header");
    // decoded into cur, predicted from ref (the last frame decoded)
    const int nmb = mbw * mbh;
    std::fill(mb_packet.begin(), mb_packet.end(), -1);
    packet = 0;
    packet_start = 0;
    const int marker_zeros = type == 0 ? 16 : 15 + fcode;
    for (int m = 0; m < nmb; ++m) {
      if (resync && m > 0 && at_resync(br, marker_zeros)) {
        br.pos = (br.pos + 8) & ~(size_t)7;  // the stuffing
        br.pos += (size_t)marker_zeros + 1;
        const int mbn = (int)br.get(mb_num_bits);
        if (mbn != m) refuse("corrupt MPEG-4 video: a video packet starts at macroblock %d, not %d", mbn, m);
        qp = (int)br.get(5);
        if (qp == 0) refuse("corrupt MPEG-4 video: quant_scale is 0");
        if (br.get1()) {  // header_extension_code
          while (br.get1())
            if (br.overran()) refuse("truncated MPEG-4 video: video packet header");
          br.marker("video packet header");
          br.get(time_bits);
          br.marker("video packet header");
          if ((int)br.get(2) != type) refuse("corrupt MPEG-4 video: a video packet of another VOP type");
          dc_thr = kDcThreshold[br.get(3)];
          if (type == 1 && (int)br.get(3) != fcode) refuse("corrupt MPEG-4 video: a video packet of another fcode");
        }
        ++packet;
        packet_start = m;
      }
      decode_mb(br, m, type, qp, dc_thr, fcode, rounding);
      if (br.overran()) refuse("truncated or corrupt MPEG-4 video");
    }
    std::swap(cur, ref);  // the decoded frame is the next reference and the output
    have_ref = true;
    last_type = type;
    return true;
  }

  // Stuffing to the next byte boundary (a 0, then 1s), then a resync marker.
  static bool at_resync(const BitReader& br, int zeros) {
    const int k = 8 - (int)(br.pos & 7);
    const uint32_t s = br.peek(k);
    if (s != (1u << (k - 1)) - 1) return false;
    BitReader q = br;
    q.pos += (size_t)k;
    if (q.left() < (size_t)zeros + 1) return false;
    int z = 0;
    while (z < zeros && q.get1() == 0) ++z;
    return z == zeros && q.get1() == 1;
  }

  // ---- macroblocks

  bool available(int mx, int my) const {  // a macroblock before this one in the same video packet
    if (mx < 0 || my < 0 || mx >= mbw || my >= mbh) return false;
    return mb_packet[(size_t)my * mbw + mx] == packet;
  }

  void decode_mb(BitReader& br, int m, int type, int& qp, int dc_thr, int fcode, int rounding) {
    const int mx = m % mbw, my = m / mbw;
    mb_packet[m] = packet;
    int kind, cbpc;
    if (type == 1) {
      if (br.get1()) {  // not coded: the reference's macroblock, vector 0
        set_inter(m);
        for (int b = 0; b < 4; ++b) set_mv(mx, my, b, 0, 0);
        predict(mx, my, rounding);
        mb_qp[m] = (uint8_t)qp;
        return;
      }
      int s;
      do s = br.vlc(vlc_mcbpc_p, "MCBPC");
      while (s == 20 && !br.overran());
      if (s == 20) refuse("truncated MPEG-4 video");
      kind = s >> 2;
      cbpc = s & 3;
    } else {
      int s;
      do s = br.vlc(vlc_mcbpc_i, "MCBPC");
      while (s == 8 && !br.overran());
      if (s == 8) refuse("truncated MPEG-4 video");
      kind = s < 4 ? kIntra : kIntraQ;
      cbpc = s & 3;
    }
    if (kind == kIntra || kind == kIntraQ) {
      const bool ac_pred = br.get1();
      const int cbpy = br.vlc(vlc_cbpy, "CBPY");
      const bool dc_vlc = qp < dc_thr;  // the running QP, before this macroblock's dquant
      if (kind == kIntraQ) qp = std::min(31, std::max(1, qp + kDquant[br.get(2)]));
      mb_intra[m] = 1;
      mb_qp[m] = (uint8_t)qp;
      for (int b = 0; b < 4; ++b) set_mv(mx, my, b, 0, 0);
      const int cbp = (cbpy << 2) | cbpc;
      for (int b = 0; b < 6; ++b) intra_block(br, mx, my, b, qp, dc_vlc, ac_pred, (cbp >> (5 - b)) & 1);
      return;
    }
    const int cbpy = br.vlc(vlc_cbpy, "CBPY") ^ 15;
    if (kind == kInterQ) qp = std::min(31, std::max(1, qp + kDquant[br.get(2)]));
    set_inter(m);
    mb_qp[m] = (uint8_t)qp;
    if (kind == kInter4V) {
      for (int b = 0; b < 4; ++b) {
        int px, py;
        pred_mv(mx, my, b, &px, &py);
        const int vx = read_mv(br, px, fcode), vy = read_mv(br, py, fcode);
        set_mv(mx, my, b, vx, vy);
      }
    } else {
      int px, py;
      pred_mv(mx, my, 0, &px, &py);
      const int vx = read_mv(br, px, fcode), vy = read_mv(br, py, fcode);
      for (int b = 0; b < 4; ++b) set_mv(mx, my, b, vx, vy);
    }
    predict(mx, my, rounding);
    const int cbp = (cbpy << 2) | cbpc;
    for (int b = 0; b < 6; ++b)
      if ((cbp >> (5 - b)) & 1) inter_block(br, mx, my, b, qp);
  }

  void set_inter(int m) {
    mb_intra[m] = 0;
    const int mx = m % mbw, my = m / mbw;
    for (int b = 0; b < 4; ++b) {
      const size_t k = luma_block(mx, my, b);
      dc[0][k] = 1024;
      std::fill_n(ac[0].begin() + (ptrdiff_t)k * 14, 14, 0);
    }
    for (int c = 1; c < 3; ++c) {
      dc[c][m] = 1024;
      std::fill_n(ac[c].begin() + (ptrdiff_t)m * 14, 14, 0);
    }
  }

  size_t luma_block(int mx, int my, int b) const {
    return (size_t)(2 * my + (b >> 1)) * (2 * mbw) + 2 * mx + (b & 1);
  }

  void set_mv(int mx, int my, int b, int x, int y) {
    const size_t k = luma_block(mx, my, b);
    mv[2 * k] = x;
    mv[2 * k + 1] = y;
  }

  int read_mv(BitReader& br, int pred, int fcode) {
    const int code = br.vlc(vlc_mvd, "motion vector");
    if (code == 0) return pred;
    const int sign = br.get1();
    const int shift = fcode - 1;
    int val = code;
    if (shift) val = (((val - 1) << shift) | (int)br.get(shift)) + 1;
    if (sign) val = -val;
    val += pred;
    const int bits = 5 + fcode;  // wrapped into [-16 f, 16 f) half samples
    val = (int)((unsigned)val << (32 - bits)) >> (32 - bits);
    return val;
  }

  // Median prediction of block b's vector from its left (A), above (B) and
  // above-right (C) neighbours; a neighbour outside the VOP or the video
  // packet is not valid (ISO/IEC 14496-2 7.6.5).
  void pred_mv(int mx, int my, int b, int* px, int* py) {
    const int bx = 2 * mx + (b & 1), by = 2 * my + (b >> 1);
    // (dx, dy) of A, B, C in luma blocks
    static constexpr int kOff[4][3][2] = {{{-1, 0}, {0, -1}, {2, -1}},
                                          {{-1, 0}, {0, -1}, {1, -1}},
                                          {{-1, 0}, {0, -1}, {1, -1}},
                                          {{-1, 0}, {-1, -1}, {0, -1}}};
    int vx[3], vy[3];
    bool ok[3];
    int nvalid = 0;
    for (int i = 0; i < 3; ++i) {
      const int x = bx + kOff[b][i][0], y = by + kOff[b][i][1];
      ok[i] = x >= 0 && y >= 0 && x < 2 * mbw && (x >> 1 == mx && y >> 1 == my ? true : available(x >> 1, y >> 1));
      vx[i] = vy[i] = 0;
      if (ok[i]) {
        const size_t k = (size_t)y * (2 * mbw) + x;
        vx[i] = mv[2 * k];
        vy[i] = mv[2 * k + 1];
        ++nvalid;
      }
    }
    if (nvalid == 1) {
      for (int i = 0; i < 3; ++i)
        if (ok[i]) {
          *px = vx[i];
          *py = vy[i];
        }
      return;
    }
    *px = mid3(vx[0], vx[1], vx[2]);
    *py = mid3(vy[0], vy[1], vy[2]);
  }

  // ---- motion compensation

  // size x size samples of plane src at (x, y) + half-sample (hx, hy), the
  // plane extended past (ew, eh) by its edge samples.
  static void mc_block(const Plane& src, int ew, int eh, int x, int y, int hx, int hy, int size, int rounding,
                       uint8_t* dst, int dstride) {
    uint8_t tmp[17 * 17];
    const uint8_t* s;
    int ss;
    if (x >= 0 && y >= 0 && x + size + hx <= ew && y + size + hy <= eh) {
      s = src.px.data() + (size_t)y * src.w + x;
      ss = src.w;
    } else {
      for (int r = 0; r <= size; ++r)
        for (int c = 0; c <= size; ++c) {
          const int yy = std::min(std::max(y + r, 0), eh - 1), xx = std::min(std::max(x + c, 0), ew - 1);
          tmp[r * 17 + c] = src.px[(size_t)yy * src.w + xx];
        }
      s = tmp;
      ss = 17;
    }
    for (int r = 0; r < size; ++r) {
      const uint8_t* a = s + (size_t)r * ss;
      const uint8_t* b = a + ss;
      uint8_t* o = dst + (size_t)r * dstride;
      if (!hx && !hy) {
        std::memcpy(o, a, (size_t)size);
      } else if (hx && !hy) {
        for (int c = 0; c < size; ++c) o[c] = (uint8_t)((a[c] + a[c + 1] + 1 - rounding) >> 1);
      } else if (!hx) {
        for (int c = 0; c < size; ++c) o[c] = (uint8_t)((a[c] + b[c] + 1 - rounding) >> 1);
      } else {
        for (int c = 0; c < size; ++c) o[c] = (uint8_t)((a[c] + a[c + 1] + b[c] + b[c + 1] + 2 - rounding) >> 2);
      }
    }
  }

  static int round_chroma4(int x) {  // the sum of four luma vectors -> a chroma vector (Table 7-9)
    static constexpr int kTab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
    return kTab[x & 15] + ((x >> 3) & ~1);
  }

  // The prediction of macroblock (mx, my) from ref into cur.
  void predict(int mx, int my, int rounding) {
    const Plane &ry = ref.p[0], &ru = ref.p[1], &rv = ref.p[2];
    Plane &cy = cur.p[0], &cu = cur.p[1], &cv = cur.p[2];
    const int ew = ry.w, eh = ry.h;  // the reference is extended from its whole macroblocks
    int sx = 0, sy = 0;
    bool four = false;
    const size_t k0 = luma_block(mx, my, 0);
    for (int b = 0; b < 4; ++b) {
      const size_t k = luma_block(mx, my, b);
      four |= mv[2 * k] != mv[2 * k0] || mv[2 * k + 1] != mv[2 * k0 + 1];
      sx += mv[2 * k];
      sy += mv[2 * k + 1];
    }
    if (!four) {
      const int vx = mv[2 * k0], vy = mv[2 * k0 + 1];
      mc_block(ry, ew, eh, mx * 16 + (vx >> 1), my * 16 + (vy >> 1), vx & 1, vy & 1, 16, rounding, cy.at(mx * 16, my * 16),
               cy.w);
      const int cx = (vx >> 1) | (vx & 1), cyv = (vy >> 1) | (vy & 1);
      for (int c = 0; c < 2; ++c)
        mc_block(c ? rv : ru, ew / 2, eh / 2, mx * 8 + (cx >> 1), my * 8 + (cyv >> 1), cx & 1, cyv & 1, 8, rounding,
                 (c ? cv : cu).at(mx * 8, my * 8), cu.w);
      return;
    }
    for (int b = 0; b < 4; ++b) {
      const size_t k = luma_block(mx, my, b);
      const int vx = mv[2 * k], vy = mv[2 * k + 1];
      const int x = mx * 16 + (b & 1) * 8, y = my * 16 + (b >> 1) * 8;
      mc_block(ry, ew, eh, x + (vx >> 1), y + (vy >> 1), vx & 1, vy & 1, 8, rounding, cy.at(x, y), cy.w);
    }
    const int cx = round_chroma4(sx), cyv = round_chroma4(sy);
    for (int c = 0; c < 2; ++c)
      mc_block(c ? rv : ru, ew / 2, eh / 2, mx * 8 + (cx >> 1), my * 8 + (cyv >> 1), cx & 1, cyv & 1, 8, rounding,
               (c ? cv : cu).at(mx * 8, my * 8), cu.w);
  }

  // ---- blocks

  // (run, level, last) of the next coefficient; levels signed.
  void read_coef(BitReader& br, bool intra, int* run, int* level, int* last) {
    const TcoefTable& t = intra ? kIntraTcoef : kInterTcoef;
    const Vlc& v = intra ? vlc_intra : vlc_inter;
    int s = br.vlc(v, "coefficient");
    if (s < 102) {
      *run = t.run[s];
      *level = t.level[s];
      *last = s >= t.last_start;
      if (br.get1()) *level = -*level;
      return;
    }
    if (!br.get1()) {  // escape 1: the level past the table's largest for the run
      s = br.vlc(v, "coefficient");
      if (s >= 102) refuse("corrupt MPEG-4 video: an escape inside an escape");
      *run = t.run[s];
      *last = s >= t.last_start;
      *level = t.level[s] + max_level[intra][*last][*run];
      if (br.get1()) *level = -*level;
    } else if (!br.get1()) {  // escape 2: the run past the table's longest for the level
      s = br.vlc(v, "coefficient");
      if (s >= 102) refuse("corrupt MPEG-4 video: an escape inside an escape");
      *last = s >= t.last_start;
      *level = t.level[s];
      *run = t.run[s] + max_run[intra][*last][*level] + 1;
      if (br.get1()) *level = -*level;
    } else {  // escape 3: fixed-length
      *last = br.get1();
      *run = (int)br.get(6);
      br.marker("escape code");
      *level = (int)((unsigned)br.get(12) << 20) >> 20;
      br.marker("escape code");
      if (*level == 0) refuse("corrupt MPEG-4 video: an escaped coefficient of 0");
    }
  }

  void inter_block(BitReader& br, int mx, int my, int b, int qp) {
    int16_t blk[64] = {0};
    const int qmul = 2 * qp, qadd = (qp - 1) | 1;
    int i = -1, last = 0;
    while (!last) {
      int run, level;
      read_coef(br, false, &run, &level, &last);
      i += run + 1;
      if (i > 63) refuse("corrupt MPEG-4 video: a coefficient past the end of a block");
      level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
      blk[kZigzag[i]] = (int16_t)std::min(2047, std::max(-2048, level));
      if (br.overran()) refuse("truncated or corrupt MPEG-4 video");
    }
    uint8_t* dst;
    int stride;
    block_dst(mx, my, b, &dst, &stride);
    simple_idct::idct(blk, dst, stride, true);
  }

  void block_dst(int mx, int my, int b, uint8_t** dst, int* stride) {
    if (b < 4) {
      *dst = cur.p[0].at(mx * 16 + (b & 1) * 8, my * 16 + (b >> 1) * 8);
      *stride = cur.p[0].w;
    } else {
      *dst = cur.p[b - 3].at(mx * 8, my * 8);
      *stride = cur.p[b - 3].w;
    }
  }

  // Block b's DC and AC prediction state: plane index, block index, the
  // block grid's width, and the block's position on it.
  void block_pos(int mx, int my, int b, int* c, int* x, int* y, int* gw) const {
    if (b < 4) {
      *c = 0;
      *x = 2 * mx + (b & 1);
      *y = 2 * my + (b >> 1);
      *gw = 2 * mbw;
    } else {
      *c = b - 3;
      *x = mx;
      *y = my;
      *gw = mbw;
    }
  }

  // A neighbouring block at (x, y) on plane c's grid that prediction may use.
  bool intra_neighbour(int c, int x, int y, int mx, int my) const {
    if (x < 0 || y < 0) return false;
    const int nmx = c ? x : x >> 1, nmy = c ? y : y >> 1;
    if (nmx == mx && nmy == my) return true;
    return available(nmx, nmy) && mb_intra[(size_t)nmy * mbw + nmx];
  }

  void intra_block(BitReader& br, int mx, int my, int b, int qp, bool dc_vlc, bool ac_pred, bool coded) {
    int c, x, y, gw;
    block_pos(mx, my, b, &c, &x, &y, &gw);
    const int scale = c ? c_dc_scale(qp) : y_dc_scale(qp);
    // DC prediction: B C / A X
    const int fa = intra_neighbour(c, x - 1, y, mx, my) ? dc[c][(size_t)y * gw + x - 1] : 1024;
    const int fb = intra_neighbour(c, x - 1, y - 1, mx, my) ? dc[c][(size_t)(y - 1) * gw + x - 1] : 1024;
    const int fc = intra_neighbour(c, x, y - 1, mx, my) ? dc[c][(size_t)(y - 1) * gw + x] : 1024;
    const bool top = std::abs(fa - fb) >= std::abs(fb - fc) ? false : true;  // predict from above
    const int pred = ((top ? fc : fa) + (scale >> 1)) / scale;
    int16_t qf[64] = {0};
    int i = 0;
    if (dc_vlc) {
      const int size = br.vlc(c ? vlc_dc_chrom : vlc_dc_lum, "DC size");
      int diff = 0;
      if (size) {
        const int v = (int)br.get(size);
        diff = (v >> (size - 1)) ? v : v - (1 << size) + 1;
        if (size > 8) br.marker("intra DC");
      }
      qf[0] = (int16_t)diff;
      i = 1;
    }
    const uint8_t* scan = ac_pred ? (top ? kAltHorizontal : kAltVertical) : kZigzag;
    if (coded) {
      int k = i - 1, last = 0;
      while (!last) {
        int run, level;
        read_coef(br, true, &run, &level, &last);
        k += run + 1;
        if (k > 63) refuse("corrupt MPEG-4 video: a coefficient past the end of a block");
        qf[scan[k]] = (int16_t)level;
        if (br.overran()) refuse("truncated or corrupt MPEG-4 video");
      }
    }
    // DC: QF and the clipped value neighbours predict from
    const int q0 = qf[0] + pred;
    qf[0] = (int16_t)q0;
    int f0 = q0 * scale;
    dc[c][(size_t)y * gw + x] = f0 < 0 ? 0 : f0 > 2047 ? 2047 : f0;
    // AC prediction from the first column of the left block or the first row of the one above
    int16_t* mine = ac[c].data() + ((size_t)y * gw + x) * 14;
    if (ac_pred) {
      const int nx = top ? x : x - 1, ny = top ? y - 1 : y;
      const bool inside = nx >= 0 && ny >= 0;
      const int nmx = c ? nx : nx >> 1, nmy = c ? ny : ny >> 1;
      // ffmpeg's reading: a non-intra neighbour holds zeros; outside the picture there is none
      if (inside) {
        const int16_t* nb = ac[c].data() + ((size_t)ny * gw + nx) * 14;
        const int nq = mb_qp[(size_t)nmy * mbw + nmx];
        const bool same = (nmx == mx && nmy == my) || nq == qp;
        for (int j = 1; j < 8; ++j) {
          const int v = top ? nb[j - 1] : nb[7 + j - 1];
          const int pos = top ? j : 8 * j;
          qf[pos] = (int16_t)(qf[pos] + (same ? v : rounded_div(v * nq, qp)));
        }
      }
    }
    for (int j = 1; j < 8; ++j) {
      mine[j - 1] = qf[j];
      mine[7 + j - 1] = qf[8 * j];
    }
    // dequantisation (H.263) and the inverse DCT
    int16_t blk[64];
    const int qmul = 2 * qp, qadd = (qp - 1) | 1;
    blk[0] = (int16_t)(q0 * scale);
    for (int j = 1; j < 64; ++j) {
      const int l = qf[j];
      const int v = l == 0 ? 0 : l > 0 ? l * qmul + qadd : l * qmul - qadd;
      blk[j] = (int16_t)std::min(2047, std::max(-2048, v));
    }
    uint8_t* dst;
    int stride;
    block_dst(mx, my, b, &dst, &stride);
    simple_idct::idct(blk, dst, stride, false);
  }

  // ---- output

  void copy_out(uint8_t* y, uint8_t* u, uint8_t* v) const {
    const Frame& f = ref;  // after decoding, the output frame is the reference
    const int cw = (width + 1) / 2, ch = (height + 1) / 2;
    for (int r = 0; r < height; ++r) std::memcpy(y + (size_t)r * width, f.p[0].px.data() + (size_t)r * f.p[0].w, (size_t)width);
    for (int r = 0; r < ch; ++r) {
      std::memcpy(u + (size_t)r * cw, f.p[1].px.data() + (size_t)r * f.p[1].w, (size_t)cw);
      std::memcpy(v + (size_t)r * cw, f.p[2].px.data() + (size_t)r * f.p[2].w, (size_t)cw);
    }
  }
};

// ------------------------------------------------------------------ encoder

// The 8x8 DCT-II with the standard's scaling (a flat block of p has DC 8 p).
void fdct(const double (&cosv)[8][8], const double* in, double* out) {
  double tmp[64];
  for (int r = 0; r < 8; ++r)
    for (int u = 0; u < 8; ++u) {
      double s = 0;
      for (int x = 0; x < 8; ++x) s += cosv[u][x] * in[r * 8 + x];
      tmp[r * 8 + u] = s;
    }
  for (int c = 0; c < 8; ++c)
    for (int v = 0; v < 8; ++v) {
      double s = 0;
      for (int y = 0; y < 8; ++y) s += cosv[v][y] * tmp[y * 8 + c];
      out[v * 8 + c] = s;
    }
}

struct Encoder {
  int w, h, mbw, mbh, qp;
  BitWriter bw;
  std::vector<int> dcv[3];  // reconstructed DC per block, for prediction
  Code inv[2][64][64];       // [last][run][level] -> intra code (len 0: none)
  double cosv[8][8];

  Encoder(int w_, int h_, int qp_) : w(w_), h(h_), mbw((w_ + 15) / 16), mbh((h_ + 15) / 16), qp(qp_) {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x) cosv[u][x] = std::cos((2 * x + 1) * u * M_PI / 16) * (u ? 0.5 : 0.5 / std::sqrt(2.0));
    std::memset(inv, 0, sizeof inv);
    for (int i = 0; i < 102; ++i) {
      const int last = i >= kIntraTcoef.last_start;
      inv[last][kIntraTcoef.run[i]][kIntraTcoef.level[i]] = kIntraTcoef.vlc[i];
    }
    dcv[0].assign((size_t)mbw * mbh * 4, 1024);
    dcv[1].assign((size_t)mbw * mbh, 1024);
    dcv[2].assign((size_t)mbw * mbh, 1024);
  }

  static void header(BitWriter& bw, int w, int h, int res) {
    bw.start_code(0xB0);  // visual object sequence
    bw.put(0x03, 8);      // Simple profile, level 3
    bw.start_code(0xB5);  // visual object: video, no identifier, no signal type
    bw.put(0, 1);
    bw.put(1, 4);
    bw.put(0, 1);
    bw.stuff();
    bw.start_code(0x00);  // video object 0
    bw.start_code(0x20);  // video object layer 0
    bw.put(0, 1);         // random_accessible_vol
    bw.put(1, 8);         // Simple object type
    bw.put(0, 1);         // is_object_layer_identifier
    bw.put(1, 4);         // square pixels
    bw.put(1, 1);         // vol_control_parameters
    bw.put(1, 2);         // 4:2:0
    bw.put(1, 1);         // low_delay
    bw.put(0, 1);         // no VBV parameters
    bw.put(0, 2);         // rectangular
    bw.put(1, 1);
    bw.put((uint32_t)res, 16);
    bw.put(1, 1);
    bw.put(0, 1);  // fixed_vop_rate
    bw.put(1, 1);
    bw.put((uint32_t)w, 13);
    bw.put(1, 1);
    bw.put((uint32_t)h, 13);
    bw.put(1, 1);
    bw.put(0, 1);  // progressive
    bw.put(1, 1);  // obmc_disable
    bw.put(0, 1);  // no sprites
    bw.put(0, 1);  // 8-bit
    bw.put(0, 1);  // H.263 quantisation
    bw.put(1, 1);  // complexity_estimation_disable
    bw.put(1, 1);  // resync_marker_disable
    bw.put(0, 1);  // not data partitioned
    bw.put(0, 1);  // not scalable
    bw.stuff();
  }

  void vop(const uint8_t* const planes[3], int ones, int tinc, int time_bits) {
    bw.start_code(0xB6);
    bw.put(0, 2);  // I-VOP
    for (int i = 0; i < ones; ++i) bw.put(1, 1);
    bw.put(0, 1);
    bw.put(1, 1);
    bw.put((uint32_t)tinc, time_bits);
    bw.put(1, 1);
    bw.put(1, 1);  // vop_coded
    bw.put(0, 3);  // intra_dc_vlc_thr: DC always by its own VLC
    bw.put((uint32_t)qp, 5);
    const int ys = w, cs = w / 2;
    for (int my = 0; my < mbh; ++my)
      for (int mx = 0; mx < mbw; ++mx) {
        int16_t qf[6][64];
        int cbp = 0;
        for (int b = 0; b < 6; ++b) {
          double px[64], F[64];
          const int c = b < 4 ? 0 : b - 3;
          const int pw = c ? w / 2 : w, ph = c ? h / 2 : h, stride = c ? cs : ys;
          const int x0 = c ? mx * 8 : mx * 16 + (b & 1) * 8, y0 = c ? my * 8 : my * 16 + (b >> 1) * 8;
          for (int r = 0; r < 8; ++r)
            for (int k = 0; k < 8; ++k) {  // edge samples repeated past the picture
              const int yy = std::min(y0 + r, ph - 1), xx = std::min(x0 + k, pw - 1);
              px[r * 8 + k] = planes[c][(size_t)yy * stride + xx];
            }
          fdct(cosv, px, F);
          const int scale = c ? c_dc_scale(qp) : y_dc_scale(qp);
          qf[b][0] = (int16_t)std::lround(F[0] / scale);
          const int even = qp % 2 == 0;
          bool any = false;
          for (int j = 1; j < 64; ++j) {
            const double a = std::fabs(F[j]);
            int n = (int)((a + even) / (2 * qp));
            n = std::min(n, 2047);
            qf[b][j] = (int16_t)(F[j] < 0 ? -n : n);
            any |= n != 0;
          }
          if (any) cbp |= 1 << (5 - b);
        }
        bw.put(kMcbpcI[cbp & 3]);
        bw.put(0, 1);  // ac_pred_flag
        bw.put(kCbpy[cbp >> 2]);
        for (int b = 0; b < 6; ++b) block(mx, my, b, qf[b], (cbp >> (5 - b)) & 1);
      }
    bw.stuff();
  }

  void block(int mx, int my, int b, const int16_t* qf, bool coded) {
    const int c = b < 4 ? 0 : b - 3;
    const int x = c ? mx : 2 * mx + (b & 1), y = c ? my : 2 * my + (b >> 1), gw = c ? mbw : 2 * mbw;
    const int scale = c ? c_dc_scale(qp) : y_dc_scale(qp);
    const int fa = x > 0 ? dcv[c][(size_t)y * gw + x - 1] : 1024;
    const int fb = x > 0 && y > 0 ? dcv[c][(size_t)(y - 1) * gw + x - 1] : 1024;
    const int fc = y > 0 ? dcv[c][(size_t)(y - 1) * gw + x] : 1024;
    const int pred = ((std::abs(fa - fb) < std::abs(fb - fc) ? fc : fa) + (scale >> 1)) / scale;
    const int diff = qf[0] - pred;
    const int f0 = qf[0] * scale;
    dcv[c][(size_t)y * gw + x] = f0 < 0 ? 0 : f0 > 2047 ? 2047 : f0;
    int size = 0;
    while ((std::abs(diff) >> size) != 0) ++size;
    bw.put(c ? kDcChrom[size] : kDcLum[size]);
    if (size) {
      bw.put((uint32_t)(diff > 0 ? diff : diff + (1 << size) - 1), size);
      if (size > 8) bw.put(1, 1);
    }
    if (!coded) return;
    int lastpos = 0;
    for (int j = 1; j < 64; ++j)
      if (qf[kZigzag[j]]) lastpos = j;
    int run = 0;
    for (int j = 1; j <= lastpos; ++j) {
      const int l = qf[kZigzag[j]];
      if (!l) {
        ++run;
        continue;
      }
      const int last = j == lastpos, a = std::abs(l);
      const Code code = a < 64 ? inv[last][run][a] : Code{0, 0};
      if (code.len) {
        bw.put(code);
        bw.put(l < 0, 1);
      } else {  // escape 3
        bw.put(kIntraTcoef.vlc[102]);
        bw.put(3, 2);
        bw.put((uint32_t)last, 1);
        bw.put((uint32_t)run, 6);
        bw.put(1, 1);
        bw.put((uint32_t)l & 0xFFF, 12);
        bw.put(1, 1);
      }
      run = 0;
    }
  }
};

int64_t emit(const std::vector<uint8_t>& bytes, uint8_t* out, int64_t cap) {
  if ((int64_t)bytes.size() <= cap) std::memcpy(out, bytes.data(), bytes.size());
  return (int64_t)bytes.size();
}

}  // namespace

extern "C" {

void* mga_mpeg4_decoder_new() {
  try {
    return new Decoder();
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

void mga_mpeg4_decoder_free(void* h) { delete static_cast<Decoder*>(h); }

// Decodes one chunk. Returns 1 when it gave a frame (info: width, height, and
// 0 for an I-VOP, 1 for a P-VOP), 0 when it gave none (headers only, or an
// uncoded VOP), -1 with a message.
int mga_mpeg4_decode(void* h, const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  Decoder* dec = static_cast<Decoder*>(h);
  bool frame = false;
  const int rc = guarded(err, errlen, [&] {
    frame = dec->decode(data, (size_t)n);
    info[0] = dec->width;
    info[1] = dec->height;
    info[2] = dec->last_type;
  });
  if (rc < 0) return -1;
  return frame ? 1 : 0;
}

// The last frame's planes: y (height x width), u and v ((height+1)/2 x (width+1)/2).
void mga_mpeg4_frame(void* h, uint8_t* y, uint8_t* u, uint8_t* v) { static_cast<Decoder*>(h)->copy_out(y, u, v); }

// The VOS, VO and VOL headers of a w x h stream with the given time resolution.
int64_t mga_mpeg4_encode_header(int32_t w, int32_t h, int32_t res, uint8_t* out, int64_t cap, char* err, int errlen) {
  int64_t size = -1;
  guarded(err, errlen, [&] {
    if (w < 2 || h < 2 || w > 8190 || h > 8190 || (w & 1) || (h & 1))
      refuse("MPEG-4 encoder: a frame of %dx%d (even sizes 2..8190)", w, h);
    if (res < 1 || res > 65535) refuse("MPEG-4 encoder: time resolution %d (1..65535)", res);
    BitWriter bw;
    Encoder::header(bw, w, h, res);
    size = emit(bw.out, out, cap);
  });
  return size;
}

// One I-VOP of planes y (h x w), u and v (h/2 x w/2) at quantiser qp: ones
// seconds past the previous VOP's (modulo_time_base), tinc the time
// increment within the second (res its resolution).
int64_t mga_mpeg4_encode_intra(const uint8_t* y, const uint8_t* u, const uint8_t* v, int32_t w, int32_t h, int32_t res,
                               int32_t ones, int32_t tinc, int32_t qp, uint8_t* out, int64_t cap, char* err,
                               int errlen) {
  int64_t size = -1;
  guarded(err, errlen, [&] {
    if (w < 2 || h < 2 || w > 8190 || h > 8190 || (w & 1) || (h & 1))
      refuse("MPEG-4 encoder: a frame of %dx%d (even sizes 2..8190)", w, h);
    if (qp < 1 || qp > 31) refuse("MPEG-4 encoder: quantiser %d (1..31)", qp);
    if (res < 1 || res > 65535 || tinc < 0 || tinc >= res || ones < 0 || ones > 1024)
      refuse("MPEG-4 encoder: time %d + %d/%d", ones, tinc, res);
    int bits = 1;
    while ((1 << bits) < res) ++bits;
    Encoder enc(w, h, qp);
    const uint8_t* planes[3] = {y, u, v};
    enc.vop(planes, ones, tinc, bits);
    size = emit(enc.bw.out, out, cap);
  });
  return size;
}

}  // extern "C"
