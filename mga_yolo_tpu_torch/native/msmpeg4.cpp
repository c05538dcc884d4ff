// The MS-MPEG-4 family on the host: MS MPEG-4 v2 (MP42, DIV2), MS MPEG-4 v3
// (MP43, DIV3 and its aliases), WMV1 (Windows Media Video 7) and WMV2
// (Windows Media Video 8), decoded as ffmpeg's msmpeg4v2, msmpeg4v3, wmv1 and
// wmv2 decoders decode them (the streams cv2 writes and reads).
//
// Each chunk is one picture: I or P, no reordering, so every picture comes
// out as soon as it is decoded. Decoded: the picture headers of each version
// (v2's and v3's extension header at the end of an I-picture, WMV1's inside
// its header, WMV2's in the container's extradata), the per-picture
// coefficient, DC and motion-vector table indices, skipped macroblocks,
// the coded block pattern of an I-picture predicted from its neighbours,
// DC prediction (v3's rule, WMV1's, and WMV1's prediction from the pixels
// of its neighbours for an intra macroblock of a P-picture), AC prediction
// with the alternate scans (WMV1's and WMV2's own scans), all three escape
// modes (WMV1's and WMV2's third escape with its lengths coded once a
// picture), H.263 motion-vector prediction (WMV2's own), half-sample motion
// compensation with the rounding that alternates between P-pictures, v2's
// MPEG-4 DC sizes and H.263 motion vectors, the simple IDCT, and WMV2's own
// IDCT and loop filter (H.263's deblocking).
//
// Refused by name, because ffmpeg's own encoders (the ones cv2 drives) never
// write them and so no test could check them: MS MPEG-4 v1, DC table 0, motion-vector table 0, more
// than one slice, per-macroblock coefficient tables, WMV1's inter-intra
// prediction in a direction other than 0, and WMV2's skipped-macroblock maps,
// quarter-sample ("mspel") motion, ABT (8x4 and 4x8 transforms),
// J-pictures (IntraX8) and top-left motion-vector prediction; and any
// truncated or corrupt stream (no concealment).
//
// No global state: a decoder owns its frames and tables. Every read of the
// input is bounds-checked.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include "h263.h"
#include "msmpeg4_tables.h"
#include "simple_idct.h"

namespace {

using namespace h263;
using namespace msmpeg4;

enum Version { kV2 = 2, kV3 = 3, kWmv1 = 4, kWmv2 = 5 };

constexpr int kDcMax = 119;                 // a DC difference's escape symbol
constexpr int64_t kMbacBitrate = 50 * 1024;  // WMV1: above it, per-macroblock coefficient tables may be on
constexpr int64_t kIiBitrate = 128 * 1024;   // WMV1: at or below it (and under 320x240), inter-intra prediction
// H.263's deblocking strength by quantiser (Annex J), as WMV2's loop filter takes it
constexpr uint8_t kLoopStrength[32] = {0, 1, 1, 2, 2, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 7,
                                       7, 8, 8, 8, 9, 9, 9, 10, 10, 10, 11, 11, 11, 12, 12, 12};

// The features decoded, counted (MSMPEG4_TALLY in native/__init__.py, in this order).
enum Tally {
  kPicturesI, kPicturesP, kMbIntraT, kMbIntraInP, kMbInter, kMbSkipped, kBlocksTable0, kBlocksTable1, kBlocksTable2,
  kBlocksTable3, kBlocksTable4, kBlocksTable5, kEscapes1, kEscapes2, kEscapes3, kEsc3LengthsLowQ, kEsc3LengthsHighQ,
  kDcEscapes, kMvEscapes, kInterIntraMbs, kNoRoundingPictures, kCbpTable0, kCbpTable1, kCbpTable2,
  kLoopFilterPictures, kTallyN
};

// A coefficient table as ffmpeg's RLTable: codes 0..n-1 for (last, run,
// level), code n the escape, and the longest run of each level and largest
// level of each run, for the escapes.
struct RlTable {
  Vlc vlc;
  const int8_t* run = nullptr;
  const int8_t* level = nullptr;
  int n = 0, last = 0;
  int max_level[2][65], max_run[2][65];  // [last][run], [last][level]
  void init(const Code* codes, const int8_t* run_, const int8_t* level_, int n_, int last_) {
    vlc.build(codes, n_ + 1, 9);
    run = run_;
    level = level_;
    n = n_;
    last = last_;
    std::memset(max_level, 0, sizeof max_level);
    std::memset(max_run, 0, sizeof max_run);
    for (int i = 0; i < n; ++i) {
      const int l = i >= last, r = run[i], v = level[i];
      max_level[l][r] = std::max(max_level[l][r], v);
      max_run[l][v] = std::max(max_run[l][v], r);
    }
  }
};

// WMV2's inverse DCT (its wmv2dsp): rows, then columns with 3 more bits.
namespace wmv2_idct {
constexpr int W0 = 2048, W1 = 2841, W2 = 2676, W3 = 2408, W4 = 2048, W5 = 1609, W6 = 1108, W7 = 565;

inline void row(int16_t* b) {
  const int a1 = W1 * b[1] + W7 * b[7], a7 = W7 * b[1] - W1 * b[7];
  const int a5 = W5 * b[5] + W3 * b[3], a3 = W3 * b[5] - W5 * b[3];
  const int a2 = W2 * b[2] + W6 * b[6], a6 = W6 * b[2] - W2 * b[6];
  const int a0 = W0 * b[0] + W0 * b[4], a4 = W0 * b[0] - W0 * b[4];
  const int s1 = (int)(181u * (unsigned)(a1 - a5 + a7 - a3) + 128) >> 8;
  const int s2 = (int)(181u * (unsigned)(a1 - a5 - a7 + a3) + 128) >> 8;
  b[0] = (int16_t)((a0 + a2 + a1 + a5 + (1 << 7)) >> 8);
  b[1] = (int16_t)((a4 + a6 + s1 + (1 << 7)) >> 8);
  b[2] = (int16_t)((a4 - a6 + s2 + (1 << 7)) >> 8);
  b[3] = (int16_t)((a0 - a2 + a7 + a3 + (1 << 7)) >> 8);
  b[4] = (int16_t)((a0 - a2 - a7 - a3 + (1 << 7)) >> 8);
  b[5] = (int16_t)((a4 - a6 - s2 + (1 << 7)) >> 8);
  b[6] = (int16_t)((a4 + a6 - s1 + (1 << 7)) >> 8);
  b[7] = (int16_t)((a0 + a2 - a1 - a5 + (1 << 7)) >> 8);
}

inline void col(int16_t* b) {
  const int a1 = (W1 * b[8 * 1] + W7 * b[8 * 7] + 4) >> 3, a7 = (W7 * b[8 * 1] - W1 * b[8 * 7] + 4) >> 3;
  const int a5 = (W5 * b[8 * 5] + W3 * b[8 * 3] + 4) >> 3, a3 = (W3 * b[8 * 5] - W5 * b[8 * 3] + 4) >> 3;
  const int a2 = (W2 * b[8 * 2] + W6 * b[8 * 6] + 4) >> 3, a6 = (W6 * b[8 * 2] - W2 * b[8 * 6] + 4) >> 3;
  const int a0 = (W0 * b[8 * 0] + W0 * b[8 * 4]) >> 3, a4 = (W0 * b[8 * 0] - W0 * b[8 * 4]) >> 3;
  const int s1 = (int)(181u * (unsigned)(a1 - a5 + a7 - a3) + 128) >> 8;
  const int s2 = (int)(181u * (unsigned)(a1 - a5 - a7 + a3) + 128) >> 8;
  b[8 * 0] = (int16_t)((a0 + a2 + a1 + a5 + (1 << 13)) >> 14);
  b[8 * 1] = (int16_t)((a4 + a6 + s1 + (1 << 13)) >> 14);
  b[8 * 2] = (int16_t)((a4 - a6 + s2 + (1 << 13)) >> 14);
  b[8 * 3] = (int16_t)((a0 - a2 + a7 + a3 + (1 << 13)) >> 14);
  b[8 * 4] = (int16_t)((a0 - a2 - a7 - a3 + (1 << 13)) >> 14);
  b[8 * 5] = (int16_t)((a4 - a6 - s2 + (1 << 13)) >> 14);
  b[8 * 6] = (int16_t)((a4 + a6 - s1 + (1 << 13)) >> 14);
  b[8 * 7] = (int16_t)((a0 + a2 - a1 - a5 + (1 << 13)) >> 14);
}

// The block's samples put (add = false) or added to dst, clipped to 0..255.
inline void idct(int16_t* blk, uint8_t* dst, int stride, bool add) {
  for (int r = 0; r < 8; ++r) row(blk + 8 * r);
  for (int c = 0; c < 8; ++c) col(blk + c);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) {
      uint8_t* p = dst + (size_t)r * stride + c;
      *p = clip8(add ? *p + blk[8 * r + c] : blk[8 * r + c]);
    }
}
}  // namespace wmv2_idct

struct Decoder {
  int version;
  const char* name;  // what messages call the stream
  int width, height, mbw, mbh;
  Plane pics[2][3];
  int cur = 0;
  bool have_ref = false;
  // the stream: WMV2's extradata, v2's / v3's / WMV1's extension header
  int64_t bit_rate = 0;
  bool flipflop = false, no_rounding = false;
  bool mspel_bit = false, loop_filter = false, abt_flag = false, j_type_bit = false, per_mb_rl_bit = false;  // WMV2's
  // the picture being decoded
  int type = 0, qscale = 1, rl_index = 0, rl_chroma_index = 0, cbp_table = 0, esc3_level_len = 0, esc3_run_len = 0;
  bool use_skip = false, inter_intra = false;
  // per block state as ffmpeg lays it out: the 8x8 luma blocks on a grid of
  // 2 * mbw + 1 columns (the last the border) with a border row above; the
  // chroma blocks on a grid of mbw + 1 with a border column and row
  std::vector<int> dc[3];
  std::vector<uint8_t> coded;  // luma blocks' coded flags (I-pictures' pattern prediction)
  std::vector<int16_t> mv;     // luma blocks' vectors (x, y), ffmpeg's motion_val
  RlTable rl[6];
  Vlc vlc_mb_intra, vlc_mb_non_intra[4], vlc_dc[2], vlc_mv, vlc_v2_dc[2], vlc_v2_mb, vlc_v2_cbpc, vlc_cbpy, vlc_mvd,
      vlc_inter_intra;
  const uint8_t *scan_inter, *scan_intra;
  const uint8_t *y_dc_scale, *c_dc_scale;
  int64_t tally[kTallyN] = {0};

  Decoder(int version_, const uint8_t* extra, size_t nextra, int w, int h)
      : version(version_), width(w), height(h), mbw((w + 15) / 16), mbh((h + 15) / 16) {
    name = version == kV2 ? "MS MPEG-4 v2 video" : version == kV3 ? "MS MPEG-4 v3 video"
         : version == kWmv1 ? "WMV1 video" : "WMV2 video";
    if (w <= 0 || h <= 0 || w > 16384 || h > 16384) refuse("%s of %dx%d pixels", name, w, h);
    for (auto& pic : pics) {
      pic[0].alloc(mbw * 16, mbh * 16);
      pic[1].alloc(mbw * 8, mbh * 8);
      pic[2].alloc(mbw * 8, mbh * 8);
    }
    const size_t ls = (size_t)(2 * mbw + 1) * (2 * mbh + 1), cs = (size_t)(mbw + 1) * (mbh + 1);
    dc[0].assign(ls, 1024);
    dc[1].assign(cs, 1024);
    dc[2].assign(cs, 1024);
    coded.assign(ls, 0);
    mv.assign(ls * 2, 0);
    rl[0].init(kRlIntraLowVlc, kRlIntraLowRun, kRlIntraLowLevel, kRlIntraLowN, kRlIntraLowLast);
    rl[1].init(kRlIntraHighVlc, kRlIntraHighRun, kRlIntraHighLevel, kRlIntraHighN, kRlIntraHighLast);
    rl[2].init(kIntraTcoef.vlc, kIntraTcoef.run, kIntraTcoef.level, 102, kIntraTcoef.last_start);
    rl[3].init(kRlInterLowVlc, kRlInterLowRun, kRlInterLowLevel, kRlInterLowN, kRlInterLowLast);
    rl[4].init(kRlInterHighVlc, kRlInterHighRun, kRlInterHighLevel, kRlInterHighN, kRlInterHighLast);
    rl[5].init(kInterTcoef.vlc, kInterTcoef.run, kInterTcoef.level, 102, kInterTcoef.last_start);
    vlc_mb_intra.build(kMbIntra, 64, 9);
    for (int t = 0; t < 4; ++t) vlc_mb_non_intra[t].build(kMbNonIntra[t], 128, 9);
    vlc_dc[0].build(kDc[0], 120, 9);
    vlc_dc[1].build(kDc[1], 120, 9);
    int syms[kMvCodes];
    for (int i = 0; i < kMvCodes; ++i) syms[i] = kMvSyms[i];
    vlc_mv.build_from_lengths(kMvLens, syms, kMvCodes, 9);
    vlc_cbpy.build(kCbpy, 16, 6);
    vlc_mvd.build(kMvd, 33, 12);
    vlc_v2_mb.build(kV2MbType, 8, 7);
    vlc_v2_cbpc.build(kV2IntraCbpc, 4, 3);
    vlc_inter_intra.build(kInterIntra, 4, 3);
    for (int c = 0; c < 2; ++c) {  // v2's DC: MPEG-4's size codes, their bits inverted, then the differential
      std::vector<Code> codes(512);
      for (int level = -256; level < 256; ++level) {
        const int size = level ? 32 - __builtin_clz((unsigned)std::abs(level)) : 0;
        const int l = level < 0 ? (-level) ^ ((1 << size) - 1) : level;
        const Code& t = (c ? kDcChrom : kDcLum)[size];
        uint32_t code = t.code ^ ((1u << t.len) - 1);
        int len = t.len;
        if (size > 0) {
          code = (code << size) | (uint32_t)l;
          len += size;
          if (size > 8) {
            code = (code << 1) | 1;
            ++len;
          }
        }
        codes[level + 256] = {code, (uint8_t)len};
      }
      vlc_v2_dc[c].build(codes.data(), 512, 9);
    }
    if (version >= kWmv1) {
      scan_inter = kWmv1Scan[0];
      scan_intra = kWmv1Scan[1];
      y_dc_scale = kWmv1YDcScale;
      c_dc_scale = kWmv1CDcScale;
    } else {
      scan_inter = scan_intra = kZigzag;
      y_dc_scale = version == kV3 ? kOldYDcScale : nullptr;  // v2: 8 at every quantiser
      c_dc_scale = version == kV3 ? kWmv1CDcScale : nullptr;
    }
    if (version == kWmv2) wmv2_extradata(extra, nextra);
  }

  // ---- headers

  void wmv2_extradata(const uint8_t* d, size_t n) {
    if (n < 4) refuse("%s without its 4-byte header in the container (%zu bytes)", name, n);
    BitReader br(d, 4, name);
    br.get(5);  // frames a second
    bit_rate = (int64_t)br.get(11) * 1024;
    mspel_bit = br.get1();
    loop_filter = br.get1();
    abt_flag = br.get1();
    j_type_bit = br.get1();
    if (br.get1()) refuse("WMV2 video with top-left motion vector prediction is not supported");
    per_mb_rl_bit = br.get1();
    const int slices = (int)br.get(3);
    if (slices == 0) refuse("corrupt WMV2 video: a slice count of 0 in its header");
    if (slices != 1) refuse("WMV2 video of %d slices a picture is not supported", slices);
  }

  static int decode012(BitReader& br) { return br.get1() ? 1 + br.get1() : 0; }

  void one_slice(int code) {
    if (code < 0x17) refuse("corrupt %s: a slice code of %d", name, code);
    if (code != 0x17) refuse("%s of %d slices a picture is not supported", name, code - 0x16);
  }

  // ff_msmpeg4_decode_picture_header
  void picture_header(BitReader& br) {
    type = (int)br.get(2);
    if (type > 1) refuse("corrupt %s: a picture of type %d", name, type + 1);
    qscale = (int)br.get(5);
    if (qscale == 0) refuse("corrupt %s: a quantiser of 0", name);
    int dc_index = 1, mv_index = 1;
    if (type == 0) {
      one_slice((int)br.get(5));
      if (version == kV2) {
        rl_index = rl_chroma_index = 2;
      } else {
        if (version == kWmv1) {
          br.get(5);  // frames a second
          bit_rate = (int64_t)br.get(11) * 1024;
          flipflop = br.get1();
          if (bit_rate > kMbacBitrate && br.get1()) refuse("%s with per-macroblock coefficient tables is not supported", name);
        }
        rl_chroma_index = decode012(br);
        rl_index = decode012(br);
        dc_index = br.get1();
      }
      no_rounding = true;
      inter_intra = false;
    } else {
      use_skip = br.get1();
      if (version == kV2) {
        rl_index = rl_chroma_index = 2;
      } else {
        if (version == kWmv1 && bit_rate > kMbacBitrate && br.get1())
          refuse("%s with per-macroblock coefficient tables is not supported", name);
        rl_index = rl_chroma_index = decode012(br);
        dc_index = br.get1();
        mv_index = br.get1();
      }
      inter_intra = version == kWmv1 && width * height < 320 * 240 && bit_rate <= kIiBitrate;
      no_rounding = flipflop ? !no_rounding : false;
    }
    check_tables(dc_index, mv_index);
  }

  // ff_wmv2_decode_picture_header and its secondary header
  void wmv2_picture_header(BitReader& br) {
    type = br.get1();
    if (type == 0) br.get(7);
    qscale = (int)br.get(5);
    if (qscale == 0) refuse("corrupt %s: a quantiser of 0", name);
    int dc_index, mv_index = 1;
    if (type == 0) {
      if (j_type_bit && br.get1()) refuse("WMV2 video with J-pictures (IntraX8) is not supported");
      if (per_mb_rl_bit && br.get1()) refuse("%s with per-macroblock coefficient tables is not supported", name);
      rl_chroma_index = decode012(br);
      rl_index = decode012(br);
      dc_index = br.get1();
      if (br.left() * 8 < (size_t)(mbw * mbh)) refuse("truncated %s: an I-picture of %zu bits", name, br.left());
      no_rounding = true;
    } else {
      const int skip_type = (int)br.get(2);
      if (skip_type) refuse("WMV2 video with skipped-macroblock maps (skip type %d) is not supported", skip_type);
      static constexpr int kCbpMap[3][3] = {{0, 2, 1}, {1, 0, 2}, {2, 1, 0}};
      cbp_table = kCbpMap[(qscale > 10) + (qscale > 20)][decode012(br)];
      if (mspel_bit && br.get1()) refuse("WMV2 video with quarter-sample (mspel) motion is not supported");
      if (abt_flag) {
        if (!br.get1()) refuse("WMV2 video with ABT (8x4 / 4x8 transforms) chosen per macroblock is not supported");
        const int abt = decode012(br);
        if (abt) refuse("WMV2 video with ABT (8x4 / 4x8 transforms, type %d) is not supported", abt);
      }
      if (per_mb_rl_bit && br.get1()) refuse("%s with per-macroblock coefficient tables is not supported", name);
      rl_index = rl_chroma_index = decode012(br);
      if (br.left() < 2) refuse("truncated %s: a P-picture header", name);
      dc_index = br.get1();
      mv_index = br.get1();
      no_rounding = !no_rounding;
      ++tally[kCbpTable0 + cbp_table];
    }
    inter_intra = false;
    check_tables(dc_index, mv_index);
  }

  void check_tables(int dc_index, int mv_index) {
    if (version == kV2) return;  // v2 codes its DC and vectors without these tables
    if (dc_index != 1) refuse("%s with DC table 0 is not supported", name);
    if (type == 1 && mv_index != 1) refuse("%s with motion vector table 0 is not supported", name);
  }

  // v2's and v3's extension header after an I-picture's macroblocks (fps,
  // bit rate, and v3's flip-flop rounding), ff_msmpeg4_decode_ext_header.
  void ext_header(BitReader& br) {
    const int length = version == kV3 ? 17 : 16;
    const size_t left = br.left();
    if (br.overran() || left < (size_t)length) refuse("%s: an I-picture without its extension header", name);
    if (left >= (size_t)length + 8) refuse("corrupt %s: %zu bits after an I-picture's macroblocks", name, left);
    br.get(5);
    bit_rate = (int64_t)br.get(11) * 1024;
    flipflop = version == kV3 && br.get1();
  }

  // ---- one chunk

  // Decodes one chunk; true when a picture comes out (every coded one does).
  bool decode(const uint8_t* d, size_t n) {
    if (n == 0) return false;  // an empty chunk: a dropped frame, none comes out
    BitReader br(d, n, name);
    if (version != kWmv2 && (size_t)mbw * mbh > n * 8 * 8) refuse("truncated %s: a picture of %zu bytes", name, n);
    if (version == kWmv2)
      wmv2_picture_header(br);
    else
      picture_header(br);
    if (type == 1 && !have_ref) refuse("corrupt %s: a P-picture before any I-picture", name);
    ++tally[type ? kPicturesP : kPicturesI];
    if (type == 1 && no_rounding) ++tally[kNoRoundingPictures];
    if (loop_filter) ++tally[kLoopFilterPictures];
    esc3_level_len = esc3_run_len = 0;
    cur ^= have_ref ? 1 : 0;
    for (int my = 0; my < mbh; ++my)
      for (int mx = 0; mx < mbw; ++mx) {
        decode_mb(br, mx, my);
        if (br.overran()) refuse("truncated or corrupt %s: the picture ends in macroblock %d of %d", name,
                                 my * mbw + mx, mbw * mbh);
        if (loop_filter) deblock(mx, my);
      }
    // what ffmpeg takes for the picture's end: up to 7 bits of padding, and
    // after an I-picture up to 17 more (v2's and v3's extension header)
    if (br.left() > (type == 0 ? 24u : 7u)) refuse("corrupt %s: %zu bits after the last macroblock", name, br.left());
    if (type == 0 && version <= kV3) ext_header(br);
    have_ref = true;
    return true;
  }

  // ---- macroblocks

  int bidx(int bx, int by) const { return (by + 1) * (2 * mbw + 1) + bx; }  // luma block's entry (ffmpeg's block_index)
  int cidx(int mx, int my) const { return (my + 1) * (mbw + 1) + mx + 1; }  // chroma block's entry

  // The prediction of a 16x16 vector in a picture of one slice: the left
  // vector on the first row (none at its start), else the median of the
  // left, upper and upper right ones (none past the right edge); H.263's
  // ff_h263_pred_motion and WMV2's wmv2_pred_motion agree on it.
  void pred_motion(int mx, int my, int* px, int* py) const {
    const int xy = bidx(2 * mx, 2 * my), wrap = 2 * mbw + 1;
    const int16_t* a = &mv[2 * (xy - 1)];  // the border column holds zeros
    if (my == 0) {
      *px = a[0];
      *py = a[1];
      return;
    }
    const int16_t *b = &mv[2 * (xy - wrap)], *c = &mv[2 * (xy + 2 - wrap)];
    *px = mid3(a[0], b[0], c[0]);
    *py = mid3(a[1], b[1], c[1]);
  }

  void set_mv(int mx, int my, int vx, int vy) {
    const int xy = bidx(2 * mx, 2 * my), wrap = 2 * mbw + 1;
    for (int k : {xy, xy + 1, xy + wrap, xy + 1 + wrap}) {
      mv[2 * k] = (int16_t)vx;
      mv[2 * k + 1] = (int16_t)vy;
    }
  }

  // ff_msmpeg4_decode_motion: the difference by table 1, added, wrapped into -63..63.
  void read_mv(BitReader& br, int* mx, int* my) {
    const int sym = br.vlc(vlc_mv, "motion vector");
    int x, y;
    if (sym) {
      x = sym >> 8;
      y = sym & 0xFF;
    } else {
      ++tally[kMvEscapes];
      x = (int)br.get(6);
      y = (int)br.get(6);
    }
    x += *mx - 32;
    y += *my - 32;
    *mx = x <= -64 ? x + 64 : x >= 64 ? x - 64 : x;
    *my = y <= -64 ? y + 64 : y >= 64 ? y - 64 : y;
  }

  // msmpeg4v2_decode_motion: H.263's vector difference, wrapped.
  int read_v2_mv(BitReader& br, int pred) {
    const int code = br.vlc(vlc_mvd, "motion vector");
    if (code == 0) return pred;
    int v = br.get1() ? -code : code;
    v += pred;
    return v <= -64 ? v + 64 : v >= 64 ? v - 64 : v;
  }

  // ff_clean_intra_table_entries: what a non-intra macroblock leaves its neighbours to predict from.
  void clean_intra(int mx, int my) {
    const int xy = bidx(2 * mx, 2 * my), wrap = 2 * mbw + 1;
    for (int k : {xy, xy + 1, xy + wrap, xy + 1 + wrap}) {
      dc[0][k + 1] = 1024;
      coded[k + 1] = 0;
    }
    const int c = cidx(mx, my);
    dc[1][c] = dc[2][c] = 1024;
  }

  void decode_mb(BitReader& br, int mx, int my) {
    int cbp;
    bool intra;
    if (type == 1) {
      if (version == kWmv2 ? false : use_skip && br.get1()) {
        ++tally[kMbSkipped];
        set_mv(mx, my, 0, 0);
        clean_intra(mx, my);
        predict(mx, my, 0, 0);
        return;
      }
      if (version == kV2) {
        const int code = br.vlc(vlc_v2_mb, "macroblock type");
        intra = code >> 2;
        cbp = code & 3;
      } else {
        const int code = br.vlc(vlc_mb_non_intra[version == kWmv2 ? cbp_table : 3], "macroblock type");
        intra = !(code & 0x40);
        cbp = code & 0x3F;
      }
    } else {
      intra = true;
      if (version == kV2) {
        cbp = br.vlc(vlc_v2_cbpc, "macroblock pattern");
      } else {  // the luma bits predicted from the neighbours' (B C / A X: A unless B equals C)
        const int code = br.vlc(vlc_mb_intra, "macroblock pattern");
        cbp = 0;
        for (int i = 0; i < 6; ++i) {
          int val = (code >> (5 - i)) & 1;
          if (i < 4) {
            const int k = bidx(2 * mx + (i & 1), 2 * my + (i >> 1)) + 1, wrap = 2 * mbw + 1;
            const int a = coded[k - 1], b = coded[k - 1 - wrap], c = coded[k - wrap];
            val ^= b == c ? a : c;
            coded[k] = (uint8_t)val;
          }
          cbp |= val << (5 - i);
        }
      }
    }
    if (version == kV2) {
      if (intra && br.get1()) refuse("%s with AC prediction is not supported", name);
      int cbpy = br.vlc(vlc_cbpy, "CBPY");
      cbp |= cbpy << 2;
      if (!intra && (cbp & 3) != 3) cbp ^= 0x3C;
    }
    if (!intra) {
      ++tally[kMbInter];
      int vx, vy;
      pred_motion(mx, my, &vx, &vy);
      if (version == kV2) {
        vx = read_v2_mv(br, vx);
        vy = read_v2_mv(br, vy);
      } else {
        read_mv(br, &vx, &vy);
      }
      set_mv(mx, my, vx, vy);
      clean_intra(mx, my);
      predict(mx, my, vx, vy);
      for (int b = 0; b < 6; ++b) {
        if (!((cbp >> (5 - b)) & 1)) continue;
        int16_t blk[64] = {0};
        coefficients(br, blk, b, false, scan_inter);
        put_block(mx, my, b, blk, true);
      }
      return;
    }
    ++tally[kMbIntraT];
    if (type == 1) ++tally[kMbIntraInP];
    int aic_dir = 0;
    if (version != kV2) {
      if (br.get1()) refuse("%s with AC prediction is not supported", name);
      if (inter_intra) {
        aic_dir = br.vlc(vlc_inter_intra, "prediction direction");
        ++tally[kInterIntraMbs];
        if (aic_dir) refuse("%s with inter-intra prediction in direction %d is not supported", name, aic_dir);
      }
    }
    set_mv(mx, my, 0, 0);
    for (int b = 0; b < 6; ++b) {
      int16_t blk[64] = {0};
      intra_block(br, mx, my, b, (cbp >> (5 - b)) & 1, blk);
      put_block(mx, my, b, blk, false);
    }
  }

  // The prediction of a non-intra macroblock from the reference: half-sample,
  // H.263's chroma vector, the picture's rounding.
  void predict(int mx, int my, int vx, int vy) {
    mpeg_motion(pics[cur], pics[cur ^ 1], mx, my, false, 0, 0, vx, vy, 16, no_rounding ? kPutNoRnd : kPut, mbw * 16,
                mbh * 16, false);
  }

  void put_block(int mx, int my, int b, int16_t* blk, bool add) {
    Plane& p = pics[cur][b < 4 ? 0 : b - 3];
    uint8_t* dst = b < 4 ? p.at(mx * 16 + (b & 1) * 8, my * 16 + (b >> 1) * 8) : p.at(mx * 8, my * 8);
    if (version == kWmv2)
      wmv2_idct::idct(blk, dst, p.w, add);
    else
      simple_idct::idct(blk, dst, p.w, add);
  }

  // ---- WMV2's loop filter: H.263's deblocking (ff_h263_loop_filter), each
  // macroblock's edges as soon as it is decoded. No macroblock is skipped in
  // a WMV2 picture decoded here (skip maps are refused), so every edge takes
  // the picture's quantiser.

  // One edge of 8 samples: across it (p0 p1 | p2 p3) at step `across`, along it at `along`.
  void edge(uint8_t* at, int across, int along) const {
    const int strength = kLoopStrength[qscale];
    for (int i = 0; i < 8; ++i) {
      uint8_t* q = at + i * along;
      const int p0 = q[-2 * across], p3 = q[across];
      int p1 = q[-across], p2 = q[0];
      const int d = (p0 - p3 + 4 * (p2 - p1)) / 8;
      const int d1 = d < -2 * strength ? 0 : d < -strength ? -2 * strength - d : d < strength ? d
                   : d < 2 * strength ? 2 * strength - d : 0;
      p1 += d1;
      p2 -= d1;
      if (p1 & 256) p1 = ~(p1 >> 31);
      if (p2 & 256) p2 = ~(p2 >> 31);
      q[-across] = (uint8_t)p1;
      q[0] = (uint8_t)p2;
      const int ad1 = std::abs(d1) >> 1;
      const int d2 = std::min(std::max((p0 - p3) / 4, -ad1), ad1);
      q[-2 * across] = (uint8_t)(p0 - d2);
      q[across] = (uint8_t)(p3 + d2);
    }
  }
  // A horizontal edge (between rows) at (x, y) of plane p, and a vertical one.
  void h_edge(int p, int x, int y) { Plane& pl = pics[cur][p]; edge(pl.at(x, y), pl.w, 1); }
  void v_edge(int p, int x, int y) { Plane& pl = pics[cur][p]; edge(pl.at(x, y), 1, pl.w); }

  void deblock(int mx, int my) {
    const int x = mx * 16, y = my * 16, cx = mx * 8, cy = my * 8;
    h_edge(0, x, y + 8);
    h_edge(0, x + 8, y + 8);
    if (my) {
      h_edge(0, x, y);
      h_edge(0, x + 8, y);
      h_edge(1, cx, cy);
      h_edge(2, cx, cy);
      v_edge(0, x + 8, y - 8);
      if (mx) {
        v_edge(0, x, y - 8);
        v_edge(1, cx, cy - 8);
        v_edge(2, cx, cy - 8);
      }
    }
    v_edge(0, x + 8, y);
    if (my + 1 == mbh) v_edge(0, x + 8, y + 8);
    if (mx) {
      v_edge(0, x, y);
      if (my + 1 == mbh) {
        v_edge(0, x, y + 8);
        v_edge(1, cx, cy);
        v_edge(2, cx, cy);
      }
    }
  }

  // ---- blocks

  int dc_scale(int b) const {
    const uint8_t* t = b < 4 ? y_dc_scale : c_dc_scale;
    return t ? t[qscale] : 8;
  }

  // The mean of an 8x8 block of the picture being decoded, over scale (get_dc).
  int pixel_dc(const Plane& p, int x, int y, int scale) const {
    int sum = 0;
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) sum += p.px[(size_t)(y + r) * p.w + x + c];
    return (sum + (scale >> 1)) / scale;
  }

  // ff_msmpeg4_pred_dc: the predicted DC (B C / A X, from C or A); *slot the
  // entry the reconstructed DC is stored in.
  int pred_dc(int mx, int my, int b, int** slot) {
    const int scale = dc_scale(b);
    int k, wrap, p;
    if (b < 4) {
      k = bidx(2 * mx + (b & 1), 2 * my + (b >> 1)) + 1;
      wrap = 2 * mbw + 1;
      p = 0;
    } else {
      k = cidx(mx, my);
      wrap = mbw + 1;
      p = b - 3;
    }
    *slot = &dc[p][k];
    const int a = (dc[p][k - 1] + (scale >> 1)) / scale, bb = (dc[p][k - 1 - wrap] + (scale >> 1)) / scale,
              c = (dc[p][k - wrap] + (scale >> 1)) / scale;
    if (version <= kV3) return std::abs(a - bb) <= std::abs(bb - c) ? c : a;
    if (!inter_intra || b == 3) return std::abs(a - bb) < std::abs(bb - c) ? c : a;
    // WMV1, an intra macroblock of a P-picture, direction 0: block 1 from the
    // left, 2 from above, 0 and chroma from the mean of the left neighbour's
    // pixels (1024 at the picture's left edge)
    if (b == 1) return a;
    if (b == 2) return c;
    if (mx == 0) return (1024 + (scale >> 1)) / scale;
    const Plane& pl = pics[cur][p];
    return pixel_dc(pl, (b < 4 ? mx * 16 : mx * 8) - 8, b < 4 ? my * 16 : my * 8, scale * 8);
  }

  // msmpeg4_decode_dc: the DC's quantised value, predicted.
  int read_dc(BitReader& br, int mx, int my, int b) {
    int level;
    if (version == kV2) {
      level = br.vlc(vlc_v2_dc[b >= 4], "DC") - 256;
    } else {
      level = br.vlc(vlc_dc[b >= 4], "DC");
      if (level == kDcMax) {
        ++tally[kDcEscapes];
        level = (int)br.get(8);
        if (br.get1()) level = -level;
      } else if (level != 0 && br.get1()) {
        level = -level;
      }
    }
    int* slot;
    level += pred_dc(mx, my, b, &slot);
    *slot = level * dc_scale(b);
    return level;
  }

  // The coefficients of a block after its DC (intra) or all of them (inter),
  // as ff_msmpeg4_decode_block reads them: an inter block's dequantised,
  // an intra block's as they are. Returns the last position.
  int coefficients(BitReader& br, int16_t* blk, int b, bool intra, const uint8_t* scan) {
    const int table = intra ? (b < 4 ? rl_index : 3 + rl_chroma_index) : 3 + rl_index;
    const RlTable& t = rl[table];
    ++tally[kBlocksTable0 + table];
    const int qmul = intra ? 1 : 2 * qscale, qadd = intra ? 0 : (qscale - 1) | 1;
    const int run_diff = intra ? version >= kWmv1 : version != kV2;
    int i = intra ? 0 : -1;  // an intra block's DC is at 0
    for (;;) {
      int s = br.vlc(t.vlc, "coefficient");
      int run, level, last;
      if (s < t.n) {
        run = t.run[s];
        last = s >= t.last;
        level = t.level[s] * qmul + qadd;
        if (br.get1()) level = -level;
        i += run + 1;
      } else if (!br.get1()) {  // escapes 2 and 3
        if (!br.get1()) {  // escape 3: fixed-length
          ++tally[kEscapes3];
          last = br.get1();
          if (version <= kV3) {
            run = (int)br.get(6);
            level = (int)(int8_t)br.get(8);
          } else {
            if (!esc3_level_len) {
              int ll;
              if (qscale < 8) {
                ++tally[kEsc3LengthsLowQ];
                ll = (int)br.get(3);
                if (ll == 0) ll = 8 + br.get1();
              } else {
                ++tally[kEsc3LengthsHighQ];
                ll = 2;
                while (ll < 8 && br.peek(1) == 0) {
                  ++ll;
                  br.get1();
                }
                if (ll < 8) br.get1();
              }
              esc3_level_len = ll;
              esc3_run_len = (int)br.get(2) + 3;
            }
            run = (int)br.get(esc3_run_len);
            const bool neg = br.get1();
            level = (int)br.get(esc3_level_len);
            if (neg) level = -level;
          }
          if (level == 0) refuse("corrupt %s: an escaped coefficient of 0", name);
          level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
          i += run + 1;
        } else {  // escape 2: the run past the table's longest for the level
          ++tally[kEscapes2];
          s = br.vlc(t.vlc, "coefficient");
          if (s >= t.n) refuse("corrupt %s: an escape inside an escape", name);
          last = s >= t.last;
          const int lev = t.level[s];
          run = t.run[s] + t.max_run[last][lev] + run_diff;
          level = lev * qmul + qadd;
          if (br.get1()) level = -level;
          i += run + 1;
        }
      } else {  // escape 1: the level past the table's largest for the run
        ++tally[kEscapes1];
        s = br.vlc(t.vlc, "coefficient");
        if (s >= t.n) refuse("corrupt %s: an escape inside an escape", name);
        last = s >= t.last;
        run = t.run[s];
        level = (t.level[s] + t.max_level[last][run]) * qmul + qadd;
        if (br.get1()) level = -level;
        i += run + 1;
      }
      if (i > 63 || (i == 63 && !last)) refuse("corrupt %s: a coefficient past the end of a block", name);
      blk[scan[i]] = (int16_t)level;
      if (last) return i;
      if (br.overran()) refuse("truncated or corrupt %s", name);
    }
  }

  // An intra block: DC, AC coefficients, dequantisation (H.263's); out in
  // raster order.
  void intra_block(BitReader& br, int mx, int my, int b, bool coded_, int16_t* blk) {
    const int dc_level = read_dc(br, mx, my, b);
    const int scale = dc_scale(b);
    if (dc_level < 0) refuse("corrupt %s: a negative DC", name);
    if (dc_level > 256 * scale) refuse("corrupt %s: a DC of %d at a scale of %d", name, dc_level, scale);
    if (coded_) coefficients(br, blk, b, true, scan_intra);
    // dct_unquantize_h263_intra
    const int qmul = 2 * qscale, qadd = (qscale - 1) | 1;
    blk[0] = (int16_t)(dc_level * scale);
    for (int j = 1; j < 64; ++j) {
      const int l = blk[j];
      blk[j] = (int16_t)(l == 0 ? 0 : l > 0 ? l * qmul + qadd : l * qmul - qadd);
    }
  }

  // ---- output

  void copy_out(uint8_t* y, uint8_t* u, uint8_t* v) const {
    const Plane* f = pics[cur];
    const int cw = (width + 1) / 2, ch = (height + 1) / 2;
    for (int r = 0; r < height; ++r) std::memcpy(y + (size_t)r * width, f[0].px.data() + (size_t)r * f[0].w, (size_t)width);
    for (int r = 0; r < ch; ++r) {
      std::memcpy(u + (size_t)r * cw, f[1].px.data() + (size_t)r * f[1].w, (size_t)cw);
      std::memcpy(v + (size_t)r * cw, f[2].px.data() + (size_t)r * f[2].w, (size_t)cw);
    }
  }
};

}  // namespace

extern "C" {

// A decoder of version 2 (MS MPEG-4 v2), 3 (v3), 4 (WMV1) or 5 (WMV2) for
// pictures of width x height, with the container's extradata (WMV2's header);
// null with a message when it refuses them.
void* mga_msmpeg4_new(int32_t version, const uint8_t* extra, int64_t n, int32_t width, int32_t height, char* err,
                      int errlen) {
  Decoder* dec = nullptr;
  if (version < kV2 || version > kWmv2) {
    set_error(err, errlen, version == 1 ? "MS MPEG-4 v1 video is not supported" : "not an MS-MPEG-4 family version");
    return nullptr;
  }
  guarded(err, errlen, [&] { dec = new Decoder(version, extra, (size_t)n, width, height); });
  return dec;
}

void mga_msmpeg4_free(void* h) { delete static_cast<Decoder*>(h); }

// Decodes one chunk. Returns 1 when a picture comes out (info: width,
// height, 0 for an I-picture or 1 for a P-picture), 0 for an empty chunk,
// -1 with a message.
int mga_msmpeg4_decode(void* h, const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  Decoder* dec = static_cast<Decoder*>(h);
  bool frame = false;
  if (guarded(err, errlen, [&] { frame = dec->decode(data, (size_t)n); }) < 0) return -1;
  info[0] = dec->width;
  info[1] = dec->height;
  info[2] = dec->type;
  return frame ? 1 : 0;
}

// The picture that came out: y (height x width), u and v ((height+1)/2 x (width+1)/2).
void mga_msmpeg4_frame(void* h, uint8_t* y, uint8_t* u, uint8_t* v) { static_cast<Decoder*>(h)->copy_out(y, u, v); }

// The tally's first n counts (MSMPEG4_TALLY's order); returns how many it has.
int mga_msmpeg4_tally(void* h, int64_t* out, int n) {
  const Decoder* dec = static_cast<const Decoder*>(h);
  for (int i = 0; i < n && i < kTallyN; ++i) out[i] = dec->tally[i];
  return kTallyN;
}

}  // extern "C"
