// H.264 video decoding (ITU-T H.264), the progressive 8-bit 4:2:0 tools of the
// Baseline, Main and High profiles: frame pictures of I, P and B slices,
// several slices a picture, entropy coded by CAVLC or CABAC; every macroblock
// and sub-macroblock type of those slices; Intra 4x4, 8x8 and 16x16
// prediction; the 4x4 and 8x8 transforms with scaling matrices (flat, the
// defaults, or lists sent in the SPS or PPS, with both fall-back rules);
// multiple and long-term reference frames, modification of both reference
// picture lists, spatial and temporal direct prediction, bi-prediction with
// default, explicit or implicit weights; adaptive marking (MMCO 1-6) and the
// deblocking filter. What a conforming decoder must do is fully specified, to
// the bit, so the reconstruction follows the standard's text (clauses 8.3-8.7,
// 9.2 and 9.3); libavcodec, cv2's decoder, is conforming, and the fixtures
// hold the two equal to the bit.
//
// What the standard leaves to the decoder follows libavcodec's h264 decoder:
//  * Output order: h264_select_output_frame's rule. Each picture joins a
//    delay queue; the one of lowest POC (not looking past a key frame or a
//    memory reset) goes out when the queue holds more than has_b_frames
//    pictures. has_b_frames starts at the SPS's num_reorder_frames when the
//    VUI carries a bitstream restriction; without one it grows when a
//    picture's POC comes out of order, when the last two POCs are more than 2
//    apart, or (by one) at a B picture. A picture whose POC is below the last
//    output one is dropped. flush() empties the queue in the same order.
//  * Cropping: the frame comes out at the SPS's cropped size, or at the
//    container's when that is smaller within the same 16-sample alignment
//    and the SPS crops neither top nor left (h264's "container cropping"),
//    which can make it odd. A left crop that is not a multiple of 64 luma
//    samples is refused: libavutil's av_frame_apply_cropping lowers it to
//    keep the planes aligned, and cv2 then rescales the wider frame.
//  * What libavcodec conceals (a missing reference, a slice lost, a gap in
//    frame_num, a stream that starts without an IDR picture) is refused.
// What the port does not decode is refused by name: SP / SI slices, field and
// MBAFF pictures, FMO, ASO, redundant pictures, data partitioning, chroma
// formats other than 4:2:0, bit depths above 8 and lossless coding.
//
// Three readers see a macroblock's coefficients, each its own way: CAVLC's nC
// (total_coeff of each 4x4 block, the four interleaved blocks of an 8x8 one
// counted apart), CABAC's coded_block_flag (each block's flag; an 8x8 block's
// is its coded_block_pattern bit) and the deblocking filter's bS 2
// (coefficients in the 4x4 block, or in its 8x8 block under the 8x8
// transform): MbInfo keeps nz, cbf and nzd for them.
//
// No global state but the VLC lookup tables, built once.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

#include "h264_tables.h"

namespace {

using namespace h264;

struct Error {
  std::string what;
};
[[noreturn]] void fail(const std::string& m) { throw Error{m}; }

enum Tally {
  kPicturesIdr, kPicturesI, kPicturesP, kPicturesNonRef, kSlices, kMultiSlicePictures, kAnnexB, kNalLength1,
  kNalLength2, kNalLength4, kEmulationPrevention, kNalSkipped, kProfile66, kProfile77, kProfile100, kPocType0,
  kPocType1, kPocType2, kCropped, kFullRange, kMbI4x4, kMbI16x16, kMbPcm, kMbIntraInP, kMbP16x16, kMbP16x8,
  kMbP8x16, kMbP8x8, kMbP8x8Ref0, kMbSkip, kSub8x8, kSub8x4, kSub4x8, kSub4x4, kI4x4Mode0, kI16x16Mode0 = kI4x4Mode0 + 9,
  kI16x16Chroma0 = kI16x16Mode0 + 4, kI16x16Ac = kI16x16Chroma0 + 3, kChromaMode0, kQpDelta = kChromaMode0 + 4,
  kCoeffToken0, kCoeffTokenChromaDc = kCoeffToken0 + 4, kSuffixLength0, kLevelPrefix14 = kSuffixLength0 + 7,
  kLevelPrefix15, kTotalZeros, kRunBeforeLong, kLumaDc, kChromaDc, kChromaAc, kMvMedian, kMv16x8, kMv8x16, kSkipZero,
  kSkipPredicted, kLumaFull, kLumaHalf, kLumaQuarter, kChromaFraction, kMcOffPicture, kRefIdxNonZero, kLongTermRefs,
  kListMod0, kListMod1, kListMod2, kSlidingWindow, kMmco1, kMmco2, kMmco3, kMmco4, kMmco5, kMmco6, kIdrLongTerm,
  kDeblockIdc0, kDeblockIdc1, kDeblockIdc2, kDeblockOffsets, kBs1, kBs2, kBs3, kBs4, kConstrainedIntra,
  // the Main and High profiles' tools
  kPicturesB, kPicturesBRef, kCabacSlices, kCabacInit0, kCabacPcm = kCabacInit0 + 3, kCabacCoeffEscape,
  kMbBDirect16x16, kMbBSkip, kMbB16x16, kMbB16x8, kMbB8x16, kMbB8x8, kMbIntraInB, kPredL0, kPredL1, kPredBi,
  kSubBDirect, kSubB8x8, kSubB8x4, kSubB4x8, kSubB4x4, kDirectSpatial, kDirectTemporal, kDirectZeroRefs,
  kDirectColZero, kDirectLongTerm, kDirectNoInference, kWeightsExplicitP, kWeightsExplicitB, kWeightsImplicit,
  kWeightsImplicitDefault, kWeightsSamePicture, kListSwap, kListModL1, kTransform8x8, kMbI8x8, kI8x8Mode0,
  kScalingSps = kI8x8Mode0 + 9, kScalingPps, kScalingSent, kScalingDefault, kScalingFallbackA, kScalingFallbackB,
  kDeblock8x8Coded, kLumaDcCoarse, kTallyCount
};

// ---------------------------------------------------------------- bits

struct Bits {
  const uint8_t* d;
  int64_t n, pos = 0, stop;  // stop: the rbsp_stop_one_bit's position
  Bits(const uint8_t* d_, int64_t n_) : d(d_), n(n_) {
    int64_t k = n - 1;
    while (k >= 0 && !d[k]) --k;
    stop = k < 0 ? 0 : k * 8 + 7 - __builtin_ctz(d[k]);
  }
  uint32_t peek32() const {
    const int64_t b = pos >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 5; ++i) v = (v << 8) | (b + i < n ? d[b + i] : 0);
    return (uint32_t)(v >> (8 - (pos & 7)));
  }
  void skip(int k) {
    pos += k;
    if (pos > n * 8) fail("the data ends inside a syntax element (a cut or corrupt stream)");
  }
  uint32_t u(int k) {
    if (!k) return 0;
    const uint32_t v = peek32() >> (32 - k);
    skip(k);
    return v;
  }
  bool flag() { return u(1); }
  uint32_t ue() {
    const uint32_t p = peek32();
    if (!p) fail("an Exp-Golomb code of more than 32 bits (a corrupt stream)");
    const int z = __builtin_clz(p);
    skip(z + 1);
    return (uint32_t)((1ull << z) - 1 + u(z));
  }
  int32_t se() {
    const uint32_t k = ue();
    return k & 1 ? (int32_t)((k + 1) / 2) : -(int32_t)(k / 2);
  }
  uint32_t ue_max(uint32_t most, const char* what) {
    const uint32_t v = ue();
    if (v > most) fail(std::string(what) + " " + std::to_string(v) + " out of range (a corrupt stream)");
    return v;
  }
  int32_t se_range(int32_t lo, int32_t hi, const char* what) {
    const int32_t v = se();
    if (v < lo || v > hi) fail(std::string(what) + " " + std::to_string(v) + " out of range (a corrupt stream)");
    return v;
  }
  bool more_data() const { return pos < stop; }
};

// A lookup of a VLC by its next `bits` bits: (length << 8) | value, 0 for no code.
struct Vlc {
  int bits = 0;
  std::vector<uint16_t> t;
  void add(int len, int code, int value) {
    if (!len) return;
    const int shift = bits - len;
    for (int s = 0; s < (1 << shift); ++s) t[(code << shift) | s] = (uint16_t)(len << 8 | value);
  }
  int read(Bits& b) const {
    const uint16_t e = t[b.peek32() >> (32 - bits)];
    if (!e) fail("a code no CAVLC table holds (a corrupt stream)");
    b.skip(e >> 8);
    return e & 0xFF;
  }
};

struct Vlcs {
  Vlc coeff[4], chroma_dc, total_zeros[15], chroma_dc_total_zeros[3], run[7];
  Vlcs() {
    const int cbits[4] = {16, 14, 10, 6};
    for (int t = 0; t < 4; ++t) {
      coeff[t].bits = cbits[t];
      coeff[t].t.assign(1 << cbits[t], 0);
      for (int i = 0; i < 4 * 17; ++i) {
        if ((i & 3) > (i >> 2)) continue;  // trailing ones above the total
        coeff[t].add(kCoeffTokenLen[t][i], kCoeffTokenBits[t][i], i);
      }
    }
    chroma_dc.bits = 8;
    chroma_dc.t.assign(256, 0);
    for (int i = 0; i < 4 * 5; ++i)
      if ((i & 3) <= (i >> 2)) chroma_dc.add(kChromaDcCoeffTokenLen[i], kChromaDcCoeffTokenBits[i], i);
    for (int k = 0; k < 15; ++k) {
      total_zeros[k].bits = 9;
      total_zeros[k].t.assign(512, 0);
      for (int v = 0; v < 16 - k; ++v) total_zeros[k].add(kTotalZerosLen[k][v], kTotalZerosBits[k][v], v);
    }
    for (int k = 0; k < 3; ++k) {
      chroma_dc_total_zeros[k].bits = 3;
      chroma_dc_total_zeros[k].t.assign(8, 0);
      for (int v = 0; v < 4 - k; ++v)
        chroma_dc_total_zeros[k].add(kChromaDcTotalZerosLen[k][v], kChromaDcTotalZerosBits[k][v], v);
    }
    for (int k = 0; k < 7; ++k) {
      run[k].bits = 11;
      run[k].t.assign(2048, 0);
      for (int v = 0; v < (k < 6 ? k + 2 : 15); ++v) run[k].add(kRunLen[k][v], kRunBits[k][v], v);
    }
  }
};

const Vlcs& vlcs() {
  static const Vlcs v;
  return v;
}

inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }

// ---------------------------------------------------------------- CABAC's arithmetic decoding engine (9.3.3.2)

struct Cabac {
  Bits* b = nullptr;
  uint32_t range = 510, offset = 0;
  uint8_t state[460];  // pStateIdx << 1 | valMPS by ctxIdx

  int bit() {
    if (b->pos >= b->n * 8) fail("the data ends inside a CABAC slice (a cut or corrupt stream)");
    const int v = (b->d[b->pos >> 3] >> (7 - (b->pos & 7))) & 1;
    ++b->pos;
    return v;
  }
  void start(Bits& bits) {
    b = &bits;
    range = 510;
    offset = 0;
    for (int i = 0; i < 9; ++i) offset = offset << 1 | bit();
    if (offset >= 510) fail("a CABAC slice whose first nine bits are 510 or 511 (a corrupt stream)");
  }
  void init_contexts(int table, int qp) {
    const int q = clip3(0, 51, qp);
    for (int i = 0; i < 460; ++i) {
      const int pre = clip3(1, 126, ((kCabacInit[table][i][0] * q) >> 4) + kCabacInit[table][i][1]);
      state[i] = (uint8_t)(pre <= 63 ? (63 - pre) << 1 : (pre - 64) << 1 | 1);
    }
  }
  int decision(int ctx) {
    uint8_t& s = state[ctx];
    int st = s >> 1, mps = s & 1, bin;
    const uint32_t lps = kRangeLps[st][(range >> 6) & 3];
    range -= lps;
    if (offset >= range) {
      bin = !mps;
      offset -= range;
      range = lps;
      if (st == 0) mps = 1 - mps;
      st = kTransLps[st];
    } else {
      bin = mps;
      st = st < 62 ? st + 1 : st;
    }
    s = (uint8_t)(st << 1 | mps);
    while (range < 256) {
      range <<= 1;
      offset = offset << 1 | bit();
    }
    return bin;
  }
  int bypass() {
    offset = offset << 1 | bit();
    if (offset >= range) {
      offset -= range;
      return 1;
    }
    return 0;
  }
  int terminate() {
    range -= 2;
    if (offset >= range) return 1;
    while (range < 256) {
      range <<= 1;
      offset = offset << 1 | bit();
    }
    return 0;
  }
};

// ---------------------------------------------------------------- parameter sets

struct Sps {
  bool valid = false;
  int profile = 0;
  int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4, delta_pic_order_always_zero = 0;
  int offset_for_non_ref_pic = 0, offset_for_top_to_bottom_field = 0;
  std::vector<int> offset_for_ref_frame;
  int max_num_ref_frames = 0, gaps_allowed = 0, mb_w = 0, mb_h = 0;
  int crop_l = 0, crop_r = 0, crop_t = 0, crop_b = 0;  // luma samples
  bool full_range = false, restriction = false, direct_8x8_inference = true, scaling = false;
  int chroma_loc = 0;  // libavcodec's chroma_sample_location: 0 unspecified (no VUI), 1 left, 2 centre, ...
  int num_reorder_frames = 0;
  int reorder_hint = 0;  // libavcodec's num_reorder_frames: the VUI's, else derived from the level's DPB size
  uint8_t sl4[6][16], sl8[2][64];  // the scaling lists, raster order
};

struct Pps {
  bool valid = false;
  int sps_id = 0, bottom_field_poc = 0, num_ref_idx_default[2] = {1, 1}, init_qp = 26, chroma_qp_offset[2] = {0, 0};
  int deblocking_control = 0, constrained_intra = 0, weighted_bipred = 0;
  bool cabac = false, weighted = false, transform_8x8 = false;
  uint8_t sl4[6][16], sl8[2][64];
};

// skip an hrd_parameters() of the VUI
void skip_hrd(Bits& b) {
  const int count = (int)b.ue_max(31, "cpb_cnt_minus1") + 1;
  b.u(8);
  for (int i = 0; i < count; ++i) {
    b.ue();
    b.ue();
    b.u(1);
  }
  b.u(20);
}

// ---------------------------------------------------------------- pictures

// what a later picture's direct prediction reads of a reference picture's macroblock (8.4.1.2.1)
struct ColMb {
  bool intra = true;
  int16_t mv[2][16][2];
  int8_t ref[2][4];
  int refpic[2][4];
};

struct Picture {
  int id = 0, w = 0, h = 0;
  std::vector<uint8_t> y, u, v;
  int poc = 0, frame_num = 0, long_term_idx = -1;
  bool short_ref = false, long_ref = false, key = false, mmco_reset = false, full_range = false;
  int chroma_loc = 0;               // as Sps::chroma_loc
  int type = 1;                     // 1 I, 2 P, 3 B (B: the picture's first slice; else its slices' highest)
  int out_x = 0, out_y = 0, out_w = 0, out_h = 0;  // the frame cv2 gives: origin and size in luma samples
  std::vector<ColMb> col;           // the motion of a reference picture, by macroblock
  bool ref() const { return short_ref || long_ref; }
};
using PicPtr = std::shared_ptr<Picture>;

enum Kind : uint8_t { kI4, kI8, kI16, kPcm, kInter, kSkip };

// coded_block_flag bits of MbInfo::cbf: luma 4x4 blocks (raster), the Intra 16x16 DC, chroma DC, chroma AC
constexpr int kCbfDc = 16, kCbfChromaDc = 17, kCbfChromaAc = 19;

struct MbInfo {
  int slice = -1;
  Kind kind = kSkip;
  bool t8 = false;        // transform_size_8x8_flag
  bool bdirect = false;   // B_Skip or B_Direct_16x16
  bool skipped = false;   // P_Skip or B_Skip
  uint8_t cbp = 0;        // coded_block_pattern (0x2F for I_PCM)
  uint8_t chroma_mode = 0;
  int qp = 0;          // QPY for deblocking (0 for I_PCM)
  int qpc[2] = {0, 0};  // QPc of Cb and Cr for deblocking
  uint8_t nz[16];      // CAVLC's nC: luma total_coeff, raster 4x4 blocks (x + 4 y)
  uint8_t nzc[2][4];   // CAVLC's nC: chroma AC total_coeff, raster 2x2
  uint8_t nzd[16];     // the deblocking filter's bS 2: coefficients in the 4x4 block (its 8x8 block under t8)
  uint32_t cbf = 0;    // CABAC's coded_block_flag of each block (kCbf*)
  int8_t mode[16];     // Intra 4x4 / 8x8 prediction modes, raster 4x4 blocks
  int16_t mv[2][16][2];  // by list, raster 4x4
  int8_t ref[2][4];      // ref_idx by list and 8x8, -1 unused
  int refpic[2][4];      // the referenced picture's id by list and 8x8, -1 unused
  uint8_t mvd[2][16][2];  // CABAC: |mvd| by list, raster 4x4 (at most 127)
  bool direct8[4];        // CABAC: 8x8 blocks predicted in direct mode
  bool intra() const { return kind == kI4 || kind == kI8 || kind == kI16 || kind == kPcm; }
};

struct SliceParams {
  int idc = 0, alpha = 0, beta = 0;
};

struct Mmco {
  int op, a, b;
};

struct Weights {  // pred_weight_table(): by list and ref_idx
  int luma_log2 = 0, chroma_log2 = 0;
  int lw[2][32], lo[2][32], cw[2][32][2], co[2][32][2];
  bool any = false;
};

struct SliceHeader {
  int first_mb = 0, type = 0, pps_id = 0, frame_num = 0, idr = 0, nal_ref_idc = 0;
  int poc_lsb = 0, delta_bottom = 0, delta0 = 0, delta1 = 0;
  int num_ref_idx[2] = {1, 1};
  bool direct_spatial = false;
  std::vector<std::pair<int, int>> list_mods[2];
  bool long_term_reference = false, adaptive = false;
  std::vector<Mmco> mmcos;
  int cabac_init_idc = 0;
  int qp = 26;
  SliceParams deblock;
  Weights wt;
};

// B mb_type 1-21: shape (0 16x16, 1 16x8, 2 8x16) and each partition's prediction (1 L0, 2 L1, 3 both)
constexpr int8_t kBTypes[22][3] = {{0, 0, 0}, {0, 1, 0}, {0, 2, 0}, {0, 3, 0}, {1, 1, 1}, {2, 1, 1}, {1, 2, 2},
                                   {2, 2, 2}, {1, 1, 2}, {2, 1, 2}, {1, 2, 1}, {2, 2, 1}, {1, 1, 3}, {2, 1, 3},
                                   {1, 2, 3}, {2, 2, 3}, {1, 3, 1}, {2, 3, 1}, {1, 3, 2}, {2, 3, 2}, {1, 3, 3},
                                   {2, 3, 3}};
// B sub_mb_type 0-12: prediction (0 direct), width and height in 4x4 blocks
constexpr int8_t kBSubs[13][3] = {{0, 2, 2}, {1, 2, 2}, {2, 2, 2}, {3, 2, 2}, {1, 2, 1}, {1, 1, 2}, {2, 2, 1},
                                  {2, 1, 2}, {3, 2, 1}, {3, 1, 2}, {1, 1, 1}, {2, 1, 1}, {3, 1, 1}};
constexpr int8_t kPSubs[4][2] = {{2, 2}, {2, 1}, {1, 2}, {1, 1}};  // P sub_mb_type: width, height in 4x4 blocks
constexpr int kBlockOrder[16][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}, {2, 0}, {3, 0}, {2, 1}, {3, 1},
                                    {0, 2}, {1, 2}, {0, 3}, {1, 3}, {2, 2}, {3, 2}, {2, 3}, {3, 3}};

// the direct prediction of the whole macroblock that spatial direct derives once (8.4.1.2.2)
struct Spatial {
  int ref[2] = {-1, -1};
  int mv[2][2] = {{0, 0}, {0, 0}};
  bool zero = false;
};

// one partition or sub-partition of an inter macroblock: position and size in 4x4 blocks, the lists it predicts
// from (bit 0 L0, bit 1 L1; 0 direct), its 8x8 block (sub-macroblocks) or partition index (which ref_idx)
struct Part {
  int x4, y4, w4, h4, pred, unit;
};

// ---------------------------------------------------------------- the decoder

struct Decoder {
  Sps sps_[32];
  Pps pps_[256];
  int length_size = 0;  // 0: Annex B start codes
  int caller_w = 0, caller_h = 0;
  int64_t tally[kTallyCount] = {};

  // the stream's state
  bool started = false;
  int next_id = 1;
  std::vector<PicPtr> refs;  // frames marked used for reference
  int max_long_term_idx = -1;  // -1: no long-term frame indices
  int prev_ref_frame_num = 0, prev_frame_num = 0, prev_frame_num_offset = 0, prev_poc_msb = 0, prev_poc_lsb = 0;
  bool prev_mmco5 = false;
  // output (h264_select_output_frame)
  std::vector<PicPtr> delayed, out_queue;
  int last_pocs[16];
  int has_b_frames = 0, next_outputed_poc = INT_MIN;
  bool pending_mmco_reset = false;

  // the picture being decoded
  PicPtr cur;
  const Sps* sps = nullptr;
  const Pps* pps = nullptr;
  int cur_pps_id = -1, mb_w = 0, mb_h = 0, mbs_done = 0, frame_num_offset = 0;
  SliceHeader first_header, sh;
  std::vector<MbInfo> mbs;
  std::vector<SliceParams> slice_params;
  int slice_num = -1, slice_type = 0;
  std::vector<Picture*> lists[2];
  int qp = 26;
  int ls4[6][6][16], ls8[2][6][64];  // LevelScale4x4 / 8x8 by list, qP % 6 and raster position
  bool cabac = false;
  Cabac cab;
  bool last_dqp = false;  // CABAC: the previous macroblock's mb_qp_delta was not 0
  // the macroblock being decoded
  int mbx = 0, mby = 0;
  MbInfo* m = nullptr;
  bool done[16];

  Decoder() { std::fill(last_pocs, last_pocs + 16, INT_MIN); }

  // ---- NAL units

  // the NAL units of data with start codes
  void annex_b(const uint8_t* d, int64_t n) {
    int64_t i = 0;
    auto start_at = [&](int64_t k) { return k + 2 < n && d[k] == 0 && d[k + 1] == 0 && d[k + 2] == 1; };
    while (i < n && !start_at(i)) ++i;
    if (n > 0 && i == n) fail("a sample without a start code (not H.264 in Annex B form, or a corrupt stream)");
    while (i < n) {
      i += 3;
      int64_t j = i;
      while (j < n && !start_at(j)) ++j;
      int64_t e = j;
      while (e > i && !d[e - 1]) --e;  // trailing_zero_8bits and a four-byte start code's zero
      if (e > i) nal(d + i, e - i);
      i = j;
    }
  }

  void decode_chunk(const uint8_t* d, int64_t n) {
    if (length_size == 0) {
      tally[kAnnexB] += n > 0;
      annex_b(d, n);
    } else {
      tally[length_size == 1 ? kNalLength1 : length_size == 2 ? kNalLength2 : kNalLength4] += n > 0;
      int64_t i = 0;
      while (i < n) {
        if (i + length_size > n) fail("a NAL unit length cut off (a truncated sample)");
        int64_t len = 0;
        for (int k = 0; k < length_size; ++k) len = (len << 8) | d[i + k];
        i += length_size;
        if (len > n - i) fail("a NAL unit of " + std::to_string(len) + " bytes in the " + std::to_string(n - i) +
                              " left of its sample (a truncated sample)");
        if (len) nal(d + i, len);
        i += len;
      }
    }
    if (cur && mbs_done == mb_w * mb_h) finish_picture();
  }

  void nal(const uint8_t* d, int64_t n) {
    if (d[0] & 0x80) fail("a NAL unit with forbidden_zero_bit set (a corrupt stream)");
    const int ref_idc = (d[0] >> 5) & 3, type = d[0] & 0x1F;
    if (type == 2 || type == 3 || type == 4) fail("data partitioning (NAL unit type " + std::to_string(type) + ")");
    if (type != 1 && type != 5 && type != 7 && type != 8) {
      tally[kNalSkipped]++;
      return;
    }
    std::vector<uint8_t> rbsp;
    rbsp.reserve(n);
    int zeros = 0;
    for (int64_t i = 1; i < n; ++i) {
      if (zeros >= 2 && d[i] == 3) {
        zeros = 0;
        tally[kEmulationPrevention]++;
        continue;
      }
      zeros = d[i] ? 0 : zeros + 1;
      rbsp.push_back(d[i]);
    }
    Bits b(rbsp.data(), (int64_t)rbsp.size());
    if (type == 7)
      parse_sps(b);
    else if (type == 8)
      parse_pps(b);
    else
      slice(b, type == 5, ref_idc);
  }

  // scaling_list() into out (raster order): 0 and the list, or 2 for useDefaultScalingMatrixFlag
  static int scaling_list(Bits& b, uint8_t* out, int size) {
    const uint8_t* scan = size == 16 ? kZigzag : kZigzag8;
    int last = 8, next = 8;
    for (int j = 0; j < size; ++j) {
      if (next) {
        next = (last + b.se_range(-128, 127, "delta_scale") + 256) % 256;
        if (j == 0 && next == 0) return 2;
      }
      out[scan[j]] = (uint8_t)(next ? next : last);
      last = out[scan[j]];
    }
    return 0;
  }

  // The scaling lists of an SPS (sps null) or a PPS over its SPS: lists 0-5 (4x4) and 6-7 (8x8) as sent, each
  // absent one by fall-back rule A (the defaults, and each chroma list its predecessor) or, for a PPS whose
  // SPS sent a matrix, rule B (the SPS's lists in place of the defaults).
  void scaling_matrix(Bits& b, uint8_t sl4[6][16], uint8_t sl8[2][64], int n8, const Sps* rule_b) {
    for (int i = 0; i < 6 + n8; ++i) {
      uint8_t* out = i < 6 ? sl4[i] : sl8[i - 6];
      const int size = i < 6 ? 16 : 64, inter = i < 6 ? i >= 3 : i == 7;
      const uint8_t* deflt = i < 6 ? kDefault4[inter] : kDefault8[inter];
      const uint8_t* scan = i < 6 ? kZigzag : kZigzag8;
      if (b.flag()) {
        tally[kScalingSent]++;
        if (scaling_list(b, out, size) == 0) continue;
        tally[kScalingDefault]++;
        for (int j = 0; j < size; ++j) out[scan[j]] = deflt[j];
      } else if (i == 1 || i == 2 || i == 4 || i == 5) {
        std::memcpy(out, sl4[i - 1], 16);
      } else if (rule_b) {
        tally[kScalingFallbackB]++;
        std::memcpy(out, i < 6 ? rule_b->sl4[i] : rule_b->sl8[i - 6], size);
      } else {
        tally[kScalingFallbackA]++;
        for (int j = 0; j < size; ++j) out[scan[j]] = deflt[j];
      }
    }
  }

  void parse_sps(Bits& b) {
    Sps s;
    std::memset(s.sl4, 16, sizeof s.sl4);
    std::memset(s.sl8, 16, sizeof s.sl8);
    s.profile = (int)b.u(8);
    b.u(8);  // constraint_set flags
    const int level = (int)b.u(8);
    const int id = (int)b.ue_max(31, "seq_parameter_set_id");
    static const int high[] = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135};
    if (std::find(std::begin(high), std::end(high), s.profile) != std::end(high)) {
      const int chroma = (int)b.ue_max(3, "chroma_format_idc");
      if (chroma != 1) fail(std::string("chroma format ") + (chroma == 0 ? "4:0:0 (monochrome)" : chroma == 2 ? "4:2:2" : "4:4:4"));
      const int depth_y = (int)b.ue() + 8, depth_c = (int)b.ue() + 8;
      if (depth_y != 8 || depth_c != 8) fail("bit depth " + std::to_string(std::max(depth_y, depth_c)));
      if (b.flag()) fail("lossless coding (qpprime_y_zero_transform_bypass_flag)");
      if ((s.scaling = b.flag())) {
        tally[kScalingSps]++;
        scaling_matrix(b, s.sl4, s.sl8, 2, nullptr);
      }
    }
    s.log2_max_frame_num = (int)b.ue_max(12, "log2_max_frame_num_minus4") + 4;
    s.poc_type = (int)b.ue_max(2, "pic_order_cnt_type");
    if (s.poc_type == 0) {
      s.log2_max_poc_lsb = (int)b.ue_max(12, "log2_max_pic_order_cnt_lsb_minus4") + 4;
    } else if (s.poc_type == 1) {
      s.delta_pic_order_always_zero = b.flag();
      s.offset_for_non_ref_pic = b.se();
      s.offset_for_top_to_bottom_field = b.se();
      const int cycle = (int)b.ue_max(255, "num_ref_frames_in_pic_order_cnt_cycle");
      for (int i = 0; i < cycle; ++i) s.offset_for_ref_frame.push_back(b.se());
    }
    s.max_num_ref_frames = (int)b.ue_max(16, "max_num_ref_frames");
    s.gaps_allowed = b.flag();
    s.mb_w = (int)b.ue_max(1023, "pic_width_in_mbs_minus1") + 1;
    s.mb_h = (int)b.ue_max(1023, "pic_height_in_map_units_minus1") + 1;
    if (!b.flag()) fail("field or MBAFF pictures (frame_mbs_only_flag 0)");
    s.direct_8x8_inference = b.flag();
    if (b.flag()) {
      s.crop_l = 2 * (int)b.ue();
      s.crop_r = 2 * (int)b.ue();
      s.crop_t = 2 * (int)b.ue();
      s.crop_b = 2 * (int)b.ue();
      if (s.crop_l + s.crop_r >= 16 * s.mb_w || s.crop_t + s.crop_b >= 16 * s.mb_h)
        fail("a frame cropping larger than the picture (a corrupt stream)");
      if (s.crop_l & 63)
        fail("a left frame crop of " + std::to_string(s.crop_l) +
             " samples (libavutil realigns it, and cv2 rescales the wider frame)");
    }
    if (b.flag()) {  // vui_parameters
      if (b.flag() && b.u(8) == 255) b.u(32);  // aspect ratio
      if (b.flag()) b.u(1);                     // overscan
      if (b.flag()) {                           // video signal type
        b.u(3);
        s.full_range = b.flag();
        if (b.flag()) b.u(24);
      }
      s.chroma_loc = 1;  // a VUI without chroma_loc_info: left
      if (b.flag()) {  // chroma_loc_info: the top field's type + 1
        const int top = (int)b.ue();
        b.ue();
        s.chroma_loc = top <= 5 ? top + 1 : 0;
      }
      if (b.flag()) b.u(32), b.u(32), b.u(1);  // timing
      const bool nal_hrd = b.flag();
      if (nal_hrd) skip_hrd(b);
      const bool vcl_hrd = b.flag();
      if (vcl_hrd) skip_hrd(b);
      if (nal_hrd || vcl_hrd) b.u(1);
      b.u(1);  // pic_struct_present_flag
      if ((s.restriction = b.flag())) {
        b.u(1);
        for (int i = 0; i < 4; ++i) b.ue();
        s.num_reorder_frames = (int)b.ue_max(16, "max_num_reorder_frames");
        b.ue();
      }
    }
    // libavcodec's num_reorder_frames without a bitstream restriction: MaxDpbMbs of the level over the
    // picture's macroblocks, at most 15 (ffmpeg's stream probing stops when its delay reaches it)
    static const int dpb_mbs[][2] = {{9, 396},     {10, 396},    {11, 900},    {12, 2376},   {13, 2376},   {20, 2376},
                                     {21, 4752},   {22, 8100},   {30, 8100},   {31, 18000},  {32, 20480},  {40, 32768},
                                     {41, 32768},  {42, 34816},  {50, 110400}, {51, 184320}, {52, 184320}};
    s.reorder_hint = s.num_reorder_frames;
    if (!s.restriction && s.max_num_ref_frames) {
      s.reorder_hint = 15;
      for (const auto& e : dpb_mbs)
        if (e[0] == level) s.reorder_hint = std::min(15, e[1] / (s.mb_w * s.mb_h));
    }
    s.valid = true;
    sps_[id] = s;
  }

  void parse_pps(Bits& b) {
    Pps p;
    const int id = (int)b.ue_max(255, "pic_parameter_set_id");
    p.sps_id = (int)b.ue_max(31, "seq_parameter_set_id");
    const Sps& s = sps_[p.sps_id];
    if (!s.valid) fail("a PPS of an SPS (" + std::to_string(p.sps_id) + ") the stream has not sent");
    std::memcpy(p.sl4, s.sl4, sizeof p.sl4);
    std::memcpy(p.sl8, s.sl8, sizeof p.sl8);
    p.cabac = b.flag();
    p.bottom_field_poc = b.flag();
    if (b.ue()) fail("FMO (slice groups: num_slice_groups_minus1 above 0)");
    p.num_ref_idx_default[0] = (int)b.ue_max(31, "num_ref_idx_l0_default_active_minus1") + 1;
    p.num_ref_idx_default[1] = (int)b.ue_max(31, "num_ref_idx_l1_default_active_minus1") + 1;
    p.weighted = b.flag();
    p.weighted_bipred = (int)b.u(2);
    if (p.weighted_bipred == 3) fail("weighted_bipred_idc 3 (a corrupt stream)");
    p.init_qp = 26 + b.se();
    if (p.init_qp < 0 || p.init_qp > 51) fail("pic_init_qp " + std::to_string(p.init_qp) + " out of range");
    b.se();  // pic_init_qs: SP / SI slices only
    p.chroma_qp_offset[0] = p.chroma_qp_offset[1] = b.se();
    if (p.chroma_qp_offset[0] < -12 || p.chroma_qp_offset[0] > 12) fail("chroma_qp_index_offset out of range");
    p.deblocking_control = b.flag();
    p.constrained_intra = b.flag();
    if (b.flag()) fail("redundant pictures (redundant_pic_cnt_present_flag 1)");
    if (b.more_data()) {
      p.transform_8x8 = b.flag();
      if (b.flag()) {
        tally[kScalingPps]++;
        scaling_matrix(b, p.sl4, p.sl8, p.transform_8x8 ? 2 : 0, s.scaling ? &s : nullptr);
      }
      p.chroma_qp_offset[1] = b.se();
      if (p.chroma_qp_offset[1] < -12 || p.chroma_qp_offset[1] > 12) fail("second_chroma_qp_index_offset out of range");
    }
    p.valid = true;
    pps_[id] = p;
  }

  // ---- slices

  void pred_weight_table(Bits& b, SliceHeader& h) {
    Weights& w = h.wt;
    w.luma_log2 = (int)b.ue_max(7, "luma_log2_weight_denom");
    w.chroma_log2 = (int)b.ue_max(7, "chroma_log2_weight_denom");
    for (int X = 0; X < (h.type == 1 ? 2 : 1); ++X)
      for (int i = 0; i < h.num_ref_idx[X]; ++i) {
        w.lw[X][i] = 1 << w.luma_log2;
        w.lo[X][i] = 0;
        if (b.flag()) {
          w.lw[X][i] = b.se_range(-128, 127, "luma_weight");
          w.lo[X][i] = b.se_range(-128, 127, "luma_offset");
          w.any |= w.lw[X][i] != 1 << w.luma_log2 || w.lo[X][i];
        }
        for (int c = 0; c < 2; ++c) {
          w.cw[X][i][c] = 1 << w.chroma_log2;
          w.co[X][i][c] = 0;
        }
        if (b.flag())
          for (int c = 0; c < 2; ++c) {
            w.cw[X][i][c] = b.se_range(-128, 127, "chroma_weight");
            w.co[X][i][c] = b.se_range(-128, 127, "chroma_offset");
            w.any |= w.cw[X][i][c] != 1 << w.chroma_log2 || w.co[X][i][c];
          }
      }
  }

  SliceHeader parse_header(Bits& b, bool idr, int ref_idc) {
    SliceHeader h;
    h.idr = idr;
    h.nal_ref_idc = ref_idc;
    h.first_mb = (int)b.ue();
    const int st = (int)b.ue_max(9, "slice_type");
    h.type = st % 5;
    if (h.type == 3 || h.type == 4) fail("SP / SI slices (the Extended profile)");
    if (idr && h.type != 2) fail("an IDR picture with a P or B slice (a corrupt stream)");
    h.pps_id = (int)b.ue_max(255, "pic_parameter_set_id");
    const Pps& p = pps_[h.pps_id];
    if (!p.valid) fail("a slice of a PPS (" + std::to_string(h.pps_id) + ") the stream has not sent");
    const Sps& s = sps_[p.sps_id];
    h.frame_num = (int)b.u(s.log2_max_frame_num);
    if (idr) b.ue();  // idr_pic_id
    if (s.poc_type == 0) {
      h.poc_lsb = (int)b.u(s.log2_max_poc_lsb);
      if (p.bottom_field_poc) h.delta_bottom = b.se();
    } else if (s.poc_type == 1 && !s.delta_pic_order_always_zero) {
      h.delta0 = b.se();
      if (p.bottom_field_poc) h.delta1 = b.se();
    }
    if (h.type == 1) h.direct_spatial = b.flag();
    h.num_ref_idx[0] = p.num_ref_idx_default[0];
    h.num_ref_idx[1] = p.num_ref_idx_default[1];
    const int lists_n = h.type == 2 ? 0 : h.type == 1 ? 2 : 1;
    if (lists_n) {
      if (b.flag())
        for (int X = 0; X < lists_n; ++X) h.num_ref_idx[X] = (int)b.ue() + 1;
      for (int X = 0; X < lists_n; ++X)
        if (h.num_ref_idx[X] > 16)
          fail("num_ref_idx_l" + std::to_string(X) + "_active " + std::to_string(h.num_ref_idx[X]) + " above 16");
      for (int X = 0; X < lists_n; ++X) {
        if (!b.flag()) continue;
        for (;;) {
          const int idc = (int)b.ue();
          if (idc == 3) break;
          if (idc > 3) fail("modification_of_pic_nums_idc " + std::to_string(idc) + " (a corrupt stream)");
          if (h.list_mods[X].size() > 32) fail("a reference list modification longer than the list");
          h.list_mods[X].emplace_back(idc, (int)b.ue());
        }
      }
    }
    if ((p.weighted && h.type == 0) || (p.weighted_bipred == 1 && h.type == 1)) pred_weight_table(b, h);
    if (ref_idc) {
      if (idr) {
        b.flag();  // no_output_of_prior_pics_flag
        h.long_term_reference = b.flag();
      } else if ((h.adaptive = b.flag())) {
        for (;;) {
          const int op = (int)b.ue();
          if (op == 0) break;
          if (op > 6) fail("memory_management_control_operation " + std::to_string(op) + " (a corrupt stream)");
          if (h.mmcos.size() > 64) fail("too many memory management control operations");
          Mmco mm{op, 0, 0};
          if (op == 1 || op == 3) mm.a = (int)b.ue();
          if (op == 2) mm.a = (int)b.ue();
          if (op == 3 || op == 6) mm.b = (int)b.ue();
          if (op == 4) mm.a = (int)b.ue();
          h.mmcos.push_back(mm);
        }
      }
    }
    if (p.cabac && h.type != 2) h.cabac_init_idc = (int)b.ue_max(2, "cabac_init_idc");
    h.qp = p.init_qp + b.se();
    if (h.qp < 0 || h.qp > 51) fail("slice QP " + std::to_string(h.qp) + " out of range (a corrupt stream)");
    if (p.deblocking_control) {
      h.deblock.idc = (int)b.ue_max(2, "disable_deblocking_filter_idc");
      if (h.deblock.idc != 1) {
        h.deblock.alpha = 2 * b.se();
        h.deblock.beta = 2 * b.se();
        if (std::abs(h.deblock.alpha) > 12 || std::abs(h.deblock.beta) > 12)
          fail("deblocking filter offsets out of range (a corrupt stream)");
      }
    }
    return h;
  }

  void slice(Bits& b, bool idr, int ref_idc) {
    SliceHeader h = parse_header(b, idr, ref_idc);
    if (h.first_mb == 0) {
      if (cur) {
        if (mbs_done != mb_w * mb_h)
          fail("a picture with " + std::to_string(mb_w * mb_h - mbs_done) +
               " macroblocks missing (a lost slice, which libavcodec conceals)");
        finish_picture();
      }
      start_picture(h);
    } else {
      if (!cur) fail("a slice without the start of its picture (first_mb_in_slice " + std::to_string(h.first_mb) + ")");
      if (h.first_mb < mbs_done) fail("arbitrary slice order (ASO: a slice at macroblock " + std::to_string(h.first_mb) +
                                      " after macroblock " + std::to_string(mbs_done - 1) + ")");
      if (h.first_mb > mbs_done)
        fail("a picture with macroblocks " + std::to_string(mbs_done) + "-" + std::to_string(h.first_mb - 1) +
             " missing (a lost slice, which libavcodec conceals)");
      if (h.pps_id != cur_pps_id) fail("a PPS that changes between the slices of a picture");
      if (h.frame_num != first_header.frame_num || h.idr != first_header.idr ||
          (h.nal_ref_idc != 0) != (first_header.nal_ref_idc != 0) || h.poc_lsb != first_header.poc_lsb)
        fail("a slice whose header disagrees with its picture's first (a corrupt stream)");
      if (h.first_mb >= mb_w * mb_h) fail("first_mb_in_slice past the picture (a corrupt stream)");
      tally[kMultiSlicePictures] += slice_num == 0;
    }
    ++slice_num;
    tally[kSlices]++;
    slice_params.push_back(h.deblock);
    tally[kDeblockIdc0 + h.deblock.idc]++;
    tally[kDeblockOffsets] += h.deblock.alpha != 0 || h.deblock.beta != 0;
    slice_type = h.type;
    if (cur->type != 3) cur->type = std::max(cur->type, h.type == 0 ? 2 : 1);
    build_lists(h);
    if (h.wt.any && h.type == 0)  // one picture at two indices with their own weights (x264's weightp)
      for (size_t i = 0; i < lists[0].size(); ++i)
        for (size_t j = i + 1; j < lists[0].size(); ++j)
          tally[kWeightsSamePicture] += lists[0][i] == lists[0][j] &&
                                        (h.wt.lw[0][i] != h.wt.lw[0][j] || h.wt.lo[0][i] != h.wt.lo[0][j]);
    sh = std::move(h);
    qp = sh.qp;
    if (cabac) {
      tally[kCabacSlices]++;
      if (slice_type != 2) tally[kCabacInit0 + sh.cabac_init_idc]++;
      slice_data_cabac(b);
    } else {
      slice_data(b);
    }
  }

  void start_picture(const SliceHeader& h) {
    const Pps& p = pps_[h.pps_id];
    const Sps& s = sps_[p.sps_id];
    if (!started && !h.idr) fail("a stream that does not start with an IDR picture");
    started = true;
    if (h.idr) {
      // libavcodec's idr(): the references go, and so does the POC history of its output rule
      for (auto& r : refs) r->short_ref = r->long_ref = false;
      refs.clear();
      max_long_term_idx = -1;
      prev_ref_frame_num = prev_frame_num = prev_frame_num_offset = prev_poc_msb = prev_poc_lsb = 0;
      prev_mmco5 = false;
      std::fill(last_pocs, last_pocs + 16, INT_MIN);
    } else {
      const int max_frame_num = 1 << s.log2_max_frame_num;
      if (h.frame_num != prev_ref_frame_num && h.frame_num != (prev_ref_frame_num + 1) % max_frame_num)
        fail("a gap in frame_num (" + std::to_string(prev_ref_frame_num) + " then " + std::to_string(h.frame_num) +
             ", which libavcodec conceals)");
      if (mb_w != s.mb_w || mb_h != s.mb_h) fail("a picture size that changes without an IDR picture");
    }
    // the frame cv2 gives (see the top)
    int cl = s.crop_l, ct = s.crop_t, w = 16 * s.mb_w - s.crop_l - s.crop_r, hh = 16 * s.mb_h - s.crop_t - s.crop_b;
    if (caller_w > 0 && caller_h > 0 && !ct && !cl && ((caller_w + 15) & ~15) == ((w + 15) & ~15) &&
        ((caller_h + 15) & ~15) == ((hh + 15) & ~15) && caller_w <= w && caller_h <= hh) {
      w = caller_w;
      hh = caller_h;
    }
    if (caller_w > 0 && caller_h > 0 && (w != caller_w || hh != caller_h))
      fail("a picture of " + std::to_string(w) + "x" + std::to_string(hh) + " in a track of " +
           std::to_string(caller_w) + "x" + std::to_string(caller_h));
    sps = &s;
    pps = &p;
    cabac = p.cabac;
    cur_pps_id = h.pps_id;
    first_header = h;
    mb_w = s.mb_w;
    mb_h = s.mb_h;
    cur = std::make_shared<Picture>();
    cur->id = next_id++;
    cur->w = mb_w * 16;
    cur->h = mb_h * 16;
    cur->y.assign((size_t)cur->w * cur->h, 0);
    cur->u.assign((size_t)cur->w * cur->h / 4, 0);
    cur->v.assign((size_t)cur->w * cur->h / 4, 0);
    cur->frame_num = h.frame_num;
    cur->key = h.idr;
    cur->type = h.type == 1 ? 3 : 1;
    cur->full_range = s.full_range;
    cur->chroma_loc = s.chroma_loc;
    cur->poc = compute_poc(h, s);
    mbs.assign((size_t)mb_w * mb_h, MbInfo());
    slice_params.clear();
    slice_num = -1;
    mbs_done = 0;
    cur->out_x = cl;
    cur->out_y = ct;
    cur->out_w = w;
    cur->out_h = hh;
    level_scales(p);
    tally[kCropped] += s.crop_l || s.crop_r || s.crop_t || s.crop_b;
    tally[kFullRange] += s.full_range;
    tally[s.profile == 66 ? kProfile66 : s.profile == 77 ? kProfile77 : kProfile100] +=
        s.profile == 66 || s.profile == 77 || s.profile == 100;
    tally[kPocType0 + s.poc_type]++;
    tally[kConstrainedIntra] += p.constrained_intra;
    tally[h.idr ? kPicturesIdr : h.type == 2 ? kPicturesI : h.type == 1 ? kPicturesB : kPicturesP]++;
    tally[kPicturesNonRef] += h.nal_ref_idc == 0;
    tally[kPicturesBRef] += h.type == 1 && h.nal_ref_idc != 0;
  }

  // LevelScale4x4 and LevelScale8x8 (8.5.9) of the PPS's scaling lists
  void level_scales(const Pps& p) {
    for (int q = 0; q < 6; ++q) {
      for (int k = 0; k < 16; ++k) {
        const int x = k & 3, y = k >> 2, cls = !(x & 1) && !(y & 1) ? 0 : (x & 1) && (y & 1) ? 1 : 2;
        for (int l = 0; l < 6; ++l) ls4[l][q][k] = p.sl4[l][k] * kDequant[q][cls];
      }
      for (int k = 0; k < 64; ++k) {
        const int x = k & 7, y = k >> 3;
        const int cls = x % 4 == 0 && y % 4 == 0   ? 0
                        : x % 2 == 1 && y % 2 == 1 ? 1
                        : x % 4 == 2 && y % 4 == 2 ? 2
                        : (x % 4 == 0 && y % 2 == 1) || (x % 2 == 1 && y % 4 == 0) ? 3
                        : (x % 4 == 0 && y % 4 == 2) || (x % 4 == 2 && y % 4 == 0) ? 4
                                                                                   : 5;
        for (int l = 0; l < 2; ++l) ls8[l][q][k] = p.sl8[l][k] * kDequant8[q][cls];
      }
    }
  }

  int compute_poc(const SliceHeader& h, const Sps& s) {
    const int max_frame_num = 1 << s.log2_max_frame_num;
    if (s.poc_type == 0) {
      const int max_lsb = 1 << s.log2_max_poc_lsb;
      int msb;
      if (h.poc_lsb < prev_poc_lsb && prev_poc_lsb - h.poc_lsb >= max_lsb / 2)
        msb = prev_poc_msb + max_lsb;
      else if (h.poc_lsb > prev_poc_lsb && h.poc_lsb - prev_poc_lsb > max_lsb / 2)
        msb = prev_poc_msb - max_lsb;
      else
        msb = prev_poc_msb;
      const int top = msb + h.poc_lsb, bottom = top + h.delta_bottom;
      if (h.nal_ref_idc) {
        cur_msb = msb;
        cur_lsb = h.poc_lsb;
      }
      cur_top = top;
      cur_bottom = bottom;
      return std::min(top, bottom);
    }
    frame_num_offset = h.idr ? 0 : prev_frame_num > h.frame_num ? prev_frame_num_offset + max_frame_num
                                                                 : prev_frame_num_offset;
    int top, bottom;
    if (s.poc_type == 1) {
      const int cycle = (int)s.offset_for_ref_frame.size();
      int abs_frame_num = cycle ? frame_num_offset + h.frame_num : 0;
      if (!h.nal_ref_idc && abs_frame_num > 0) --abs_frame_num;
      int expected = 0;
      if (abs_frame_num > 0) {
        int delta_cycle = 0;
        for (int o : s.offset_for_ref_frame) delta_cycle += o;
        const int cycle_cnt = (abs_frame_num - 1) / cycle, in_cycle = (abs_frame_num - 1) % cycle;
        expected = cycle_cnt * delta_cycle;
        for (int i = 0; i <= in_cycle; ++i) expected += s.offset_for_ref_frame[i];
      }
      if (!h.nal_ref_idc) expected += s.offset_for_non_ref_pic;
      top = expected + h.delta0;
      bottom = top + s.offset_for_top_to_bottom_field + h.delta1;
    } else {
      top = bottom = h.idr ? 0 : 2 * (frame_num_offset + h.frame_num) - (h.nal_ref_idc ? 0 : 1);
    }
    cur_top = top;
    cur_bottom = bottom;
    return std::min(top, bottom);
  }
  int cur_msb = 0, cur_lsb = 0, cur_top = 0, cur_bottom = 0;

  int pic_num(const Picture& p) const {  // FrameNumWrap
    const int max_frame_num = 1 << sps->log2_max_frame_num;
    return p.frame_num > first_header.frame_num ? p.frame_num - max_frame_num : p.frame_num;
  }

  // RefPicList0 (and RefPicList1 of a B slice): the initial lists (8.2.4.2), then their modification (8.2.4.3)
  void build_lists(const SliceHeader& h) {
    lists[0].clear();
    lists[1].clear();
    if (h.type == 2) return;
    std::vector<Picture*> st, lt, init[2];
    for (auto& r : refs) (r->long_ref ? lt : st).push_back(r.get());
    std::sort(lt.begin(), lt.end(), [](Picture* a, Picture* b) { return a->long_term_idx < b->long_term_idx; });
    if (h.type == 0) {
      std::sort(st.begin(), st.end(), [&](Picture* a, Picture* b) { return pic_num(*a) > pic_num(*b); });
      init[0] = st;
    } else {  // by POC: those before the current picture descending, then those after ascending; L1 the other way
      std::vector<Picture*> before, after;
      for (Picture* p : st) (p->poc <= cur->poc ? before : after).push_back(p);
      std::sort(before.begin(), before.end(), [](Picture* a, Picture* b) { return a->poc > b->poc; });
      std::sort(after.begin(), after.end(), [](Picture* a, Picture* b) { return a->poc < b->poc; });
      init[0] = before;
      init[0].insert(init[0].end(), after.begin(), after.end());
      init[1] = after;
      init[1].insert(init[1].end(), before.begin(), before.end());
      init[1].insert(init[1].end(), lt.begin(), lt.end());
    }
    init[0].insert(init[0].end(), lt.begin(), lt.end());
    if (h.type == 1 && init[1].size() > 1 && init[1] == init[0]) {
      std::swap(init[1][0], init[1][1]);
      tally[kListSwap]++;
    }
    for (int X = 0; X < (h.type == 1 ? 2 : 1); ++X) lists[X] = modify_list(init[X], h.num_ref_idx[X], h.list_mods[X], X);
  }

  std::vector<Picture*> modify_list(std::vector<Picture*> list, int n, const std::vector<std::pair<int, int>>& mods,
                                    int X) {
    list.resize(n + 1, nullptr);
    if (!mods.empty()) {
      tally[kListModL1] += X == 1;
      const int max_frame_num = 1 << sps->log2_max_frame_num, curr = first_header.frame_num;
      int pred = curr, idx = 0;
      for (auto [idc, v] : mods) {
        if (idx >= n) fail("a reference list modification longer than the list (a corrupt stream)");
        Picture* pic = nullptr;
        if (idc < 2) {
          tally[kListMod0 + idc]++;
          const int diff = v + 1;
          if (diff > max_frame_num) fail("abs_diff_pic_num_minus1 out of range (a corrupt stream)");
          int no_wrap = idc == 0 ? pred - diff : pred + diff;
          if (no_wrap < 0) no_wrap += max_frame_num;
          if (no_wrap >= max_frame_num) no_wrap -= max_frame_num;
          pred = no_wrap;
          const int num = no_wrap > curr ? no_wrap - max_frame_num : no_wrap;
          for (auto& r : refs)
            if (r->short_ref && !r->long_ref && pic_num(*r) == num) pic = r.get();
          if (!pic) fail("a reference list modification to a short-term picture (picNum " + std::to_string(num) +
                         ") the buffer does not hold, which libavcodec conceals");
        } else {
          tally[kListMod2]++;
          for (auto& r : refs)
            if (r->long_ref && r->long_term_idx == v) pic = r.get();
          if (!pic) fail("a reference list modification to a long-term picture (" + std::to_string(v) +
                         ") the buffer does not hold, which libavcodec conceals");
        }
        for (int c = n; c > idx; --c) list[c] = list[c - 1];
        list[idx++] = pic;
        int k = idx;
        for (int c = idx; c <= n; ++c)
          if (list[c] != pic) list[k++] = list[c];
      }
    }
    list.resize(n);
    for (int i = 0; i < n; ++i)
      if (!list[i])
        fail("a reference list of " + std::to_string(n) + " entries with " + std::to_string(i) +
             " pictures in the buffer (a missing reference, which libavcodec conceals)");
    return list;
  }

  // ---- macroblock neighbours

  bool mb_avail(int x, int y) const {
    return x >= 0 && y >= 0 && x < mb_w && mb_h > y && mbs[(size_t)y * mb_w + x].slice == slice_num;
  }
  const MbInfo* mb_at(int x, int y) const { return mb_avail(x, y) ? &mbs[(size_t)y * mb_w + x] : nullptr; }
  bool intra_avail(int x, int y) const {
    const MbInfo* n = mb_at(x, y);
    return n && (!pps->constrained_intra || n->intra());
  }
  const MbInfo* left() const { return mb_at(mbx - 1, mby); }
  const MbInfo* top() const { return mb_at(mbx, mby - 1); }

  // the 4x4 luma block at (x4, y4) relative to the current macroblock, for nC: its total_coeff, or -1
  int luma_nz(int x4, int y4) const {
    if (x4 >= 0 && y4 >= 0) return m->nz[y4 * 4 + x4];
    const MbInfo* n = mb_at(mbx + (x4 < 0 ? -1 : 0), mby + (y4 < 0 ? -1 : 0));
    return n ? n->nz[((y4 + 4) & 3) * 4 + ((x4 + 4) & 3)] : -1;
  }
  int chroma_nz(int c, int x2, int y2) const {
    if (x2 >= 0 && y2 >= 0) return m->nzc[c][y2 * 2 + x2];
    const MbInfo* n = mb_at(mbx + (x2 < 0 ? -1 : 0), mby + (y2 < 0 ? -1 : 0));
    return n ? n->nzc[c][((y2 + 2) & 1) * 2 + ((x2 + 2) & 1)] : -1;
  }
  static int nc_of(int a, int b) {
    if (a >= 0 && b >= 0) return (a + b + 1) >> 1;
    return a >= 0 ? a : b >= 0 ? b : 0;
  }

  // ---- CAVLC residual blocks

  // Reads one residual block of up to max_coeff levels into coef (in scan order); returns TotalCoeff.
  int residual_block(Bits& b, int nc, int max_coeff, int* coef) {
    const Vlcs& v = vlcs();
    int token;
    if (nc == -1) {
      token = v.chroma_dc.read(b);
      tally[kCoeffTokenChromaDc]++;
    } else {
      const int t = nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3;
      token = v.coeff[t].read(b);
      tally[kCoeffToken0 + t]++;
    }
    const int total = token >> 2, t1 = token & 3;
    for (int i = 0; i < max_coeff; ++i) coef[i] = 0;
    if (!total) return 0;
    if (total > max_coeff) fail("a residual block of " + std::to_string(total) + " coefficients in " +
                                std::to_string(max_coeff) + " places (a corrupt stream)");
    int level[16];
    int suffix_length = total > 10 && t1 < 3 ? 1 : 0;
    for (int i = 0; i < total; ++i) {
      if (i < t1) {
        level[i] = b.flag() ? -1 : 1;
        continue;
      }
      const uint32_t p = b.peek32();
      if (!p) fail("a level_prefix of more than 31 bits (a corrupt stream)");
      const int prefix = __builtin_clz(p);
      if (prefix > 25) fail("a level_prefix of " + std::to_string(prefix) + " (a corrupt stream)");
      b.skip(prefix + 1);
      tally[kSuffixLength0 + suffix_length]++;
      tally[kLevelPrefix14] += prefix == 14;
      tally[kLevelPrefix15] += prefix >= 15;
      int code = std::min(15, prefix) << suffix_length;
      if (suffix_length > 0 || prefix >= 14) {
        const int size = prefix == 14 && !suffix_length ? 4 : prefix >= 15 ? prefix - 3 : suffix_length;
        if (size > 0) code += (int)b.u(size);
      }
      if (prefix >= 15 && !suffix_length) code += 15;
      if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
      if (i == t1 && t1 < 3) code += 2;
      level[i] = code & 1 ? (-code - 1) >> 1 : (code + 2) >> 1;
      if (!suffix_length) suffix_length = 1;
      if (std::abs(level[i]) > (3 << (suffix_length - 1)) && suffix_length < 6) ++suffix_length;
    }
    int zeros = 0;
    if (total < max_coeff) {
      zeros = nc == -1 ? v.chroma_dc_total_zeros[total - 1].read(b) : v.total_zeros[total - 1].read(b);
      tally[kTotalZeros]++;
      if (zeros + total > max_coeff) fail("total_zeros past the block (a corrupt stream)");
    }
    int pos = zeros + total - 1;
    for (int i = 0; i < total; ++i) {
      coef[pos] = level[i];
      if (i == total - 1) break;
      int run = 0;
      if (zeros > 0) {
        tally[kRunBeforeLong] += zeros > 6;
        run = v.run[std::min(zeros, 7) - 1].read(b);
        if (run > zeros) fail("run_before past total_zeros (a corrupt stream)");
        zeros -= run;
      }
      pos -= run + 1;
    }
    return total;
  }

  // ---- CABAC syntax elements (9.3.2, 9.3.3.1)

  // coded_block_flag's condTermFlagN of a neighbouring block: bit of MbInfo::cbf in n (null: not available)
  int cbf_term(const MbInfo* n, int bit) const {
    if (!n) return m->intra() ? 1 : 0;
    return (n->cbf >> bit) & 1;
  }

  // Reads a residual block of ctxBlockCat cat (0 Intra 16x16 DC, 1 its AC, 2 luma 4x4, 3 chroma DC, 4 chroma AC,
  // 5 luma 8x8) with its coded_block_flag's ctxIdxInc into coef (levels in scan order); returns the levels coded.
  int residual_cabac(int cat, int cbf_inc, int max_coeff, int* coef) {
    static const int cbf_off[5] = {0, 4, 8, 12, 16}, sig_off[5] = {0, 15, 29, 44, 47}, abs_off[5] = {0, 10, 20, 30, 39};
    for (int i = 0; i < max_coeff; ++i) coef[i] = 0;
    if (cat != 5 && !cab.decision(85 + cbf_off[cat] + cbf_inc)) return 0;
    const int sig = cat == 5 ? 402 : 105 + sig_off[cat], last = cat == 5 ? 417 : 166 + sig_off[cat];
    const int abs_base = cat == 5 ? 426 : 227 + abs_off[cat];
    int pos[64], count = 0;
    bool ended = false;
    for (int i = 0; i < max_coeff - 1; ++i) {
      const int inc = cat == 5 ? kSig8x8[i] : cat == 3 ? std::min(i, 2) : i;
      if (!cab.decision(sig + inc)) continue;
      pos[count++] = i;
      if (cab.decision(last + (cat == 5 ? kLast8x8[i] : cat == 3 ? std::min(i, 2) : i))) {
        ended = true;
        break;
      }
    }
    if (!ended) pos[count++] = max_coeff - 1;
    int gt1 = 0, eq1 = 0;
    for (int k = count - 1; k >= 0; --k) {
      int level = 1;
      if (cab.decision(abs_base + (gt1 ? 0 : std::min(4, 1 + eq1)))) {
        const int inc = 5 + std::min(4 - (cat == 3), gt1);
        int prefix = 1;
        while (prefix < 14 && cab.decision(abs_base + inc)) ++prefix;
        if (prefix == 14) {  // the suffix, Exp-Golomb of order 0 in bypass bins
          tally[kCabacCoeffEscape]++;
          int e = 0;
          while (cab.bypass())
            if (++e > 24) fail("a coeff_abs_level_minus1 escape of more than 24 bits (a corrupt stream)");
          int suffix = (1 << e) - 1;
          for (int j = e - 1; j >= 0; --j) suffix += cab.bypass() << j;
          prefix = 14 + suffix;
        }
        level = prefix + 1;
        ++gt1;
      } else if (!gt1) {
        ++eq1;
      }
      coef[pos[k]] = cab.bypass() ? -level : level;
    }
    return count;
  }

  // mb_skip_flag of a P or B slice
  bool read_skip_cabac() {
    const MbInfo *a = left(), *b = top();
    const int inc = (a && !a->skipped) + (b && !b->skipped);
    return cab.decision((slice_type == 1 ? 24 : 11) + inc);
  }

  // the I macroblock types (0 I_NxN, 1-24 I_16x16, 25 I_PCM) with the ctxIdxOffset of their prefix or suffix
  int read_intra_type_cabac(int base, bool prefix) {
    if (prefix) {
      const MbInfo *a = left(), *b = top();
      const int inc = (a && a->kind != kI4 && a->kind != kI8) + (b && b->kind != kI4 && b->kind != kI8);
      if (!cab.decision(base + inc)) return 0;
    } else if (!cab.decision(base)) {
      return 0;
    }
    if (cab.terminate()) return 25;
    const int s = prefix ? base + 2 : base;  // the later bins' contexts: 3 + 3..7, or the suffix's 17 (32) + 1..3
    int t = 1 + 12 * cab.decision(s + 1);
    if (cab.decision(s + 2)) t += 4 + 4 * cab.decision(s + 2 + prefix);
    t += 2 * cab.decision(s + 3 + prefix);
    t += cab.decision(s + 3 + 2 * prefix);
    return t;
  }

  // mb_type as CAVLC numbers it: I 0-25; P 0-3 (no P_8x8ref0) and 5-30; B 0-22 and 23-48
  int read_mb_type(Bits& b) {
    if (!cabac) return (int)b.ue_max(slice_type == 2 ? 25 : slice_type == 0 ? 30 : 48, "mb_type");
    if (slice_type == 2) return read_intra_type_cabac(3, true);
    if (slice_type == 0) {
      if (cab.decision(14)) return 5 + read_intra_type_cabac(17, false);
      if (!cab.decision(15)) return 3 * cab.decision(16);
      return 2 - cab.decision(17);
    }
    const MbInfo *a = left(), *bm = top();
    const int inc = (a && !a->bdirect) + (bm && !bm->bdirect);
    if (!cab.decision(27 + inc)) return 0;
    if (!cab.decision(27 + 3)) return 1 + cab.decision(27 + 5);
    int bits = cab.decision(27 + 4) << 3;
    bits |= cab.decision(27 + 5) << 2;
    bits |= cab.decision(27 + 5) << 1;
    bits |= cab.decision(27 + 5);
    if (bits < 8) return bits + 3;
    if (bits == 13) return 23 + read_intra_type_cabac(32, false);
    if (bits == 14) return 11;
    if (bits == 15) return 22;
    return ((bits << 1) | cab.decision(27 + 5)) - 4;
  }

  int read_sub_type(Bits& b) {
    const bool B = slice_type == 1;
    if (!cabac) return (int)b.ue_max(B ? 12 : 3, "sub_mb_type");
    if (!B) {
      if (cab.decision(21)) return 0;
      if (!cab.decision(22)) return 1;
      return cab.decision(23) ? 2 : 3;
    }
    if (!cab.decision(36)) return 0;
    if (!cab.decision(37)) return 1 + cab.decision(39);
    int t = 3;
    if (cab.decision(38)) {
      if (cab.decision(39)) return 11 + cab.decision(39);
      t += 4;
    }
    t += 2 * cab.decision(39);
    t += cab.decision(39);
    return t;
  }

  // the 8x8 block of the 4x4 at (x4, y4) relative to the current macroblock: its MbInfo (null: not available)
  // and index; inside the macroblock, the current one
  const MbInfo* block_at(int x4, int y4, int& blk) const {
    const MbInfo* n = x4 >= 0 && y4 >= 0 ? m : mb_at(mbx + (x4 < 0 ? -1 : 0), mby + (y4 < 0 ? -1 : 0));
    blk = ((y4 + 4) & 3) * 4 + ((x4 + 4) & 3);
    return n;
  }

  int read_ref(Bits& b, int X, int x4, int y4, int n_ref) {
    int r;
    if (!cabac) {
      r = n_ref == 2 ? !b.flag() : (int)b.ue();
    } else {
      int inc = 0, blk;
      for (int k = 0; k < 2; ++k) {
        const MbInfo* n = block_at(x4 - (k == 0), y4 - (k == 1), blk);
        const int b8 = (blk >> 3) * 2 + ((blk & 3) >> 1);
        if (n && !n->direct8[b8] && n->ref[X][b8] > 0) inc += k + 1;
      }
      r = 0;
      while (cab.decision(54 + inc)) {
        inc = inc < 4 ? 4 : 5;
        if (++r >= 32) fail("a ref_idx of more than 32 (a corrupt stream)");
      }
    }
    if (r >= n_ref) fail("ref_idx " + std::to_string(r) + " past the list of " + std::to_string(n_ref));
    tally[kRefIdxNonZero] += r > 0;
    tally[kLongTermRefs] += lists[X][r]->long_ref;
    return r;
  }

  // mvd_lX of the (sub-)partition whose top-left 4x4 is (x4, y4); its magnitudes kept for CABAC's contexts
  void read_mvd(Bits& b, int X, const Part& p, int mvd[2]) {
    for (int c = 0; c < 2; ++c) {
      if (!cabac) {
        mvd[c] = b.se();
        continue;
      }
      int blk, sum = 0;
      for (int k = 0; k < 2; ++k) {
        const MbInfo* n = block_at(p.x4 - (k == 0), p.y4 - (k == 1), blk);
        if (n) sum += n->mvd[X][blk][c];
      }
      const int base = c ? 47 : 40;
      int v = 0;
      if (cab.decision(base + (sum < 3 ? 0 : sum <= 32 ? 1 : 2))) {
        v = 1;
        int ctx = base + 3;
        while (v < 9 && cab.decision(ctx)) {
          if (v < 4) ++ctx;
          ++v;
        }
        if (v >= 9) {  // the suffix: Exp-Golomb of order 3 in bypass bins
          int k = 3;
          while (cab.bypass()) {
            v += 1 << k;
            if (++k > 24) fail("an mvd escape of more than 24 bits (a corrupt stream)");
          }
          while (k--) v += cab.bypass() << k;
        }
        if (cab.bypass()) v = -v;
      }
      mvd[c] = v;
    }
    if (std::abs(mvd[0]) > 8192 || std::abs(mvd[1]) > 8192) fail("a motion vector difference out of range (a corrupt stream)");
    for (int y = p.y4; y < p.y4 + p.h4; ++y)
      for (int x = p.x4; x < p.x4 + p.w4; ++x)
        for (int c = 0; c < 2; ++c) m->mvd[X][y * 4 + x][c] = (uint8_t)std::min(127, std::abs(mvd[c]));
  }

  int read_cbp(Bits& b, bool intra) {
    if (!cabac) return intra ? kIntraCbp[b.ue_max(47, "coded_block_pattern")] : kInterCbp[b.ue_max(47, "coded_block_pattern")];
    const MbInfo *a = left(), *t = top();
    const int ca = a ? a->cbp : 0x0F, cb = t ? t->cbp : 0x0F;  // not available: as if every bit were set
    int cbp = 0;
    for (int k = 0; k < 4; ++k) {
      const int ba = k & 1 ? (cbp >> (k - 1)) & 1 : (ca >> (k + 1)) & 1;
      const int bb = k & 2 ? (cbp >> (k - 2)) & 1 : (cb >> (k + 2)) & 1;
      cbp |= cab.decision(73 + !ba + 2 * !bb) << k;
    }
    const int ach = a ? a->cbp >> 4 : 0, bch = t ? t->cbp >> 4 : 0;
    if (cab.decision(77 + (ach > 0) + 2 * (bch > 0))) cbp |= (1 + cab.decision(77 + 4 + (ach == 2) + 2 * (bch == 2))) << 4;
    return cbp;
  }

  bool read_t8(Bits& b) {
    if (!cabac) return b.flag();
    const MbInfo *a = left(), *t = top();
    return cab.decision(399 + (a && a->t8) + (t && t->t8));
  }

  int read_chroma_mode(Bits& b) {
    if (!cabac) return (int)b.ue_max(3, "intra_chroma_pred_mode");
    const MbInfo *a = left(), *t = top();
    const int inc = (a && a->intra() && a->kind != kPcm && a->chroma_mode) + (t && t->intra() && t->kind != kPcm && t->chroma_mode);
    if (!cab.decision(64 + inc)) return 0;
    if (!cab.decision(67)) return 1;
    return cab.decision(67) ? 3 : 2;
  }

  // prev_intra4x4_pred_mode_flag / prev_intra8x8_pred_mode_flag and the remaining mode: the mode given the
  // predicted one
  int read_intra_mode(Bits& b, int pred) {
    int rem;
    if (!cabac) {
      if (b.flag()) return pred;
      rem = (int)b.u(3);
    } else {
      if (cab.decision(68)) return pred;
      rem = cab.decision(69);
      rem |= cab.decision(69) << 1;
      rem |= cab.decision(69) << 2;
    }
    return rem < pred ? rem : rem + 1;
  }

  void read_qp_delta(Bits& b) {
    int d;
    if (!cabac) {
      d = b.se();
    } else {
      d = 0;
      if (cab.decision(60 + last_dqp)) {
        int k = 1, ctx = 62;
        while (cab.decision(ctx)) {
          ctx = 63;
          if (++k > 52) fail("an mb_qp_delta out of range (a corrupt stream)");
        }
        d = k & 1 ? (k + 1) / 2 : -(k / 2);
      }
    }
    if (d < -26 || d > 25) fail("mb_qp_delta " + std::to_string(d) + " out of range (a corrupt stream)");
    tally[kQpDelta] += d != 0;
    last_dqp = d != 0;
    qp = (qp + d + 52) % 52;
  }

  // ---- sample prediction and reconstruction

  // adds the inverse transform of the 4x4 block c (raster, dequantised) to the samples at dst
  static void idct_add(int* c, uint8_t* dst, int stride) {
    int t[16];
    for (int i = 0; i < 4; ++i) {  // rows
      const int* r = c + 4 * i;
      const int e0 = r[0] + r[2], e1 = r[0] - r[2], e2 = (r[1] >> 1) - r[3], e3 = r[1] + (r[3] >> 1);
      t[4 * i] = e0 + e3;
      t[4 * i + 1] = e1 + e2;
      t[4 * i + 2] = e1 - e2;
      t[4 * i + 3] = e0 - e3;
    }
    for (int j = 0; j < 4; ++j) {  // columns
      const int g0 = t[j] + t[8 + j], g1 = t[j] - t[8 + j], g2 = (t[4 + j] >> 1) - t[12 + j],
                g3 = t[4 + j] + (t[12 + j] >> 1);
      const int out[4] = {g0 + g3, g1 + g2, g1 - g2, g0 - g3};
      for (int i = 0; i < 4; ++i) dst[i * stride + j] = clip1(dst[i * stride + j] + ((out[i] + 32) >> 6));
    }
  }

  // the one-dimensional 8x8 inverse transform (8.5.13.2) of d[0], d[step], ... into f
  static void idct8_1d(const int* d, int step, int* f) {
    const int d0 = d[0], d1 = d[step], d2 = d[2 * step], d3 = d[3 * step], d4 = d[4 * step], d5 = d[5 * step],
              d6 = d[6 * step], d7 = d[7 * step];
    const int a0 = d0 + d4, a4 = d0 - d4, a2 = (d2 >> 1) - d6, a6 = d2 + (d6 >> 1);
    const int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
    const int a1 = -d3 + d5 - d7 - (d7 >> 1), a3 = d1 + d7 - d3 - (d3 >> 1);
    const int a5 = -d1 + d7 + d5 + (d5 >> 1), a7 = d3 + d5 + d1 + (d1 >> 1);
    const int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2), b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
    f[0] = b0 + b7;
    f[1] = b2 + b5;
    f[2] = b4 + b3;
    f[3] = b6 + b1;
    f[4] = b6 - b1;
    f[5] = b4 - b3;
    f[6] = b2 - b5;
    f[7] = b0 - b7;
  }

  static void idct8_add(const int* c, uint8_t* dst, int stride) {
    int t[64], f[8];
    for (int i = 0; i < 8; ++i) idct8_1d(c + 8 * i, 1, t + 8 * i);  // rows
    for (int j = 0; j < 8; ++j) {                                   // columns
      idct8_1d(t + j, 8, f);
      for (int i = 0; i < 8; ++i) dst[i * stride + j] = clip1(dst[i * stride + j] + ((f[i] + 32) >> 6));
    }
  }

  // a 4x4 block's level at raster position k dequantised with scaling list l (8.5.12.1)
  int dequant4(int level, int l, int q, int k) const {
    const int s = ls4[l][q % 6][k];
    return q >= 24 ? level * s * (1 << (q / 6 - 4)) : (level * s + (1 << (3 - q / 6))) >> (4 - q / 6);
  }
  int dequant8(int level, int l, int q, int k) const {
    const int s = ls8[l][q % 6][k];
    return q >= 36 ? level * s * (1 << (q / 6 - 6)) : (level * s + (1 << (5 - q / 6))) >> (6 - q / 6);
  }

  // the Intra 4x4 prediction of the block at luma (px, py) of the picture, block (bx, by) of the macroblock
  void intra4x4(int bx, int by, int mode) {
    const int W = cur->w;
    const int px = mbx * 16 + bx * 4, py = mby * 16 + by * 4;
    uint8_t* o = &cur->y[(size_t)py * W + px];
    const bool left = bx > 0 || intra_avail(mbx - 1, mby);
    const bool top = by > 0 || intra_avail(mbx, mby - 1);
    const bool topleft = bx > 0 && by > 0 ? true
                         : bx > 0          ? intra_avail(mbx, mby - 1)
                         : by > 0          ? intra_avail(mbx - 1, mby)
                                           : intra_avail(mbx - 1, mby - 1);
    bool topright;
    if (by == 0)
      topright = bx < 3 ? intra_avail(mbx, mby - 1) : intra_avail(mbx + 1, mby - 1);
    else if (bx == 3)
      topright = false;
    else {
      static const int idx[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};  // raster -> blkIdx
      topright = idx[(by - 1) * 4 + bx + 1] < idx[by * 4 + bx];
    }
    int T[8], L[4], X = 0;
    if (top) {
      for (int i = 0; i < 4; ++i) T[i] = o[i - W];
      for (int i = 4; i < 8; ++i) T[i] = topright ? o[i - W] : T[3];
    }
    if (left)
      for (int i = 0; i < 4; ++i) L[i] = o[i * W - 1];
    if (topleft) X = o[-W - 1];
    auto need = [&](bool ok) {
      if (!ok)
        fail("an Intra 4x4 prediction mode (" + std::to_string(mode) +
             ") whose neighbouring samples are not available (a corrupt stream)");
    };
    if (mode == 0 || mode == 3 || mode == 7) need(top);
    if (mode == 1 || mode == 8) need(left);
    if (mode >= 4 && mode <= 6) need(top && left && topleft);
    int pred[16];
    directional(mode, 4, T, L, X, top, left, pred);
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x) o[y * W + x] = (uint8_t)pred[y * 4 + x];
  }

  // The Intra 4x4 or 8x8 prediction (n 4 or 8) of mode from the samples above (T: x = 0..2n-1), left (L) and
  // above-left (X), the 8x8 ones filtered (8.3.1.2, 8.3.2.2)
  static void directional(int mode, int n, const int* T, const int* L, int X, bool top, bool left, int* pred) {
    auto P = [&](int x, int y) { return y < 0 ? (x < 0 ? X : T[x]) : L[y]; };
    const int last = 2 * n - 1;
    for (int y = 0; y < n && mode != 2; ++y)
      for (int x = 0; x < n; ++x) {
        int v = 0;
        switch (mode) {
          case 0:
            v = T[x];
            break;
          case 1:
            v = L[y];
            break;
          case 3:
            v = x == n - 1 && y == n - 1 ? (T[last - 1] + 3 * T[last] + 2) >> 2
                                         : (T[x + y] + 2 * T[x + y + 1] + T[x + y + 2] + 2) >> 2;
            break;
          case 4:
            v = x > y   ? (P(x - y - 2, -1) + 2 * P(x - y - 1, -1) + P(x - y, -1) + 2) >> 2
                : x < y ? (P(-1, y - x - 2) + 2 * P(-1, y - x - 1) + P(-1, y - x) + 2) >> 2
                        : (P(0, -1) + 2 * X + P(-1, 0) + 2) >> 2;
            break;
          case 5: {
            const int z = 2 * x - y;
            if (z >= 0 && !(z & 1))
              v = (P(x - (y >> 1) - 1, -1) + P(x - (y >> 1), -1) + 1) >> 1;
            else if (z >= 0)
              v = (P(x - (y >> 1) - 2, -1) + 2 * P(x - (y >> 1) - 1, -1) + P(x - (y >> 1), -1) + 2) >> 2;
            else if (z == -1)
              v = (P(-1, 0) + 2 * X + P(0, -1) + 2) >> 2;
            else
              v = (P(-1, y - 2 * x - 1) + 2 * P(-1, y - 2 * x - 2) + P(-1, y - 2 * x - 3) + 2) >> 2;
            break;
          }
          case 6: {
            const int z = 2 * y - x;
            if (z >= 0 && !(z & 1))
              v = (P(-1, y - (x >> 1) - 1) + P(-1, y - (x >> 1)) + 1) >> 1;
            else if (z >= 0)
              v = (P(-1, y - (x >> 1) - 2) + 2 * P(-1, y - (x >> 1) - 1) + P(-1, y - (x >> 1)) + 2) >> 2;
            else if (z == -1)
              v = (P(-1, 0) + 2 * X + P(0, -1) + 2) >> 2;
            else
              v = (P(x - 2 * y - 1, -1) + 2 * P(x - 2 * y - 2, -1) + P(x - 2 * y - 3, -1) + 2) >> 2;
            break;
          }
          case 7:
            v = y & 1 ? (T[x + (y >> 1)] + 2 * T[x + (y >> 1) + 1] + T[x + (y >> 1) + 2] + 2) >> 2
                      : (T[x + (y >> 1)] + T[x + (y >> 1) + 1] + 1) >> 1;
            break;
          case 8: {
            const int z = x + 2 * y, lim = 2 * n - 3;
            if (z > lim)
              v = L[n - 1];
            else if (z == lim)
              v = (L[n - 2] + 3 * L[n - 1] + 2) >> 2;
            else if (z & 1)
              v = (L[y + (x >> 1)] + 2 * L[y + (x >> 1) + 1] + L[y + (x >> 1) + 2] + 2) >> 2;
            else
              v = (L[y + (x >> 1)] + L[y + (x >> 1) + 1] + 1) >> 1;
            break;
          }
        }
        pred[y * n + x] = v;
      }
    if (mode == 2) {
      int s = 0;
      const int lg = n == 4 ? 2 : 3;
      if (top && left) {
        for (int i = 0; i < n; ++i) s += T[i] + L[i];
        s = (s + n) >> (lg + 1);
      } else if (left) {
        for (int i = 0; i < n; ++i) s += L[i];
        s = (s + n / 2) >> lg;
      } else if (top) {
        for (int i = 0; i < n; ++i) s += T[i];
        s = (s + n / 2) >> lg;
      } else {
        s = 128;
      }
      for (int i = 0; i < n * n; ++i) pred[i] = s;
    }
  }

  // the Intra 8x8 prediction of 8x8 block blk of the macroblock (8.3.2)
  void intra8x8(int blk, int mode) {
    const int W = cur->w, bx = blk & 1, by = blk >> 1;
    uint8_t* o = &cur->y[(size_t)(mby * 16 + by * 8) * W + mbx * 16 + bx * 8];
    const bool left = bx || intra_avail(mbx - 1, mby), top = by || intra_avail(mbx, mby - 1);
    const bool topleft = blk == 0 ? intra_avail(mbx - 1, mby - 1) : blk == 1 ? intra_avail(mbx, mby - 1)
                         : blk == 2 ? intra_avail(mbx - 1, mby) : true;
    const bool topright = blk == 0 ? intra_avail(mbx, mby - 1) : blk == 1 ? intra_avail(mbx + 1, mby - 1) : blk == 2;
    auto need = [&](bool ok) {
      if (!ok)
        fail("an Intra 8x8 prediction mode (" + std::to_string(mode) +
             ") whose neighbouring samples are not available (a corrupt stream)");
    };
    if (mode == 0 || mode == 3 || mode == 7) need(top);
    if (mode == 1 || mode == 8) need(left);
    if (mode >= 4 && mode <= 6) need(top && left && topleft);
    int t[16], l[8], x = 0, T[16], L[8], X = 0;
    if (top)
      for (int i = 0; i < 16; ++i) t[i] = i < 8 || topright ? o[i - W] : o[7 - W];
    if (left)
      for (int i = 0; i < 8; ++i) l[i] = o[i * W - 1];
    if (topleft) x = o[-W - 1];
    if (top) {  // the reference samples' filter (8.3.2.2.1)
      T[0] = topleft ? (x + 2 * t[0] + t[1] + 2) >> 2 : (3 * t[0] + t[1] + 2) >> 2;
      for (int i = 1; i < 15; ++i) T[i] = (t[i - 1] + 2 * t[i] + t[i + 1] + 2) >> 2;
      T[15] = (t[14] + 3 * t[15] + 2) >> 2;
    }
    if (topleft)
      X = top && left ? (t[0] + 2 * x + l[0] + 2) >> 2 : top ? (3 * x + t[0] + 2) >> 2 : left ? (3 * x + l[0] + 2) >> 2 : x;
    if (left) {
      L[0] = topleft ? (x + 2 * l[0] + l[1] + 2) >> 2 : (3 * l[0] + l[1] + 2) >> 2;
      for (int i = 1; i < 7; ++i) L[i] = (l[i - 1] + 2 * l[i] + l[i + 1] + 2) >> 2;
      L[7] = (l[6] + 3 * l[7] + 2) >> 2;
    }
    int pred[64];
    directional(mode, 8, T, L, X, top, left, pred);
    for (int y = 0; y < 8; ++y)
      for (int xx = 0; xx < 8; ++xx) o[y * W + xx] = (uint8_t)pred[y * 8 + xx];
  }

  // Intra 16x16 (n 16, one plane) and chroma (n 8) prediction: DC 0 / H 1 / V 2 / plane 3 in chroma's
  // numbering; luma's (V 0, H 1, DC 2, plane 3) is mapped by the caller
  void intra_block(uint8_t* plane, int W, int x0, int y0, int n, int mode, bool chroma) {
    uint8_t* o = plane + (size_t)y0 * W + x0;
    const bool left = intra_avail(mbx - 1, mby), top = intra_avail(mbx, mby - 1),
               topleft = intra_avail(mbx - 1, mby - 1);
    auto need = [&](bool ok) {
      if (!ok)
        fail(std::string(chroma ? "a chroma" : "an Intra 16x16") + " prediction mode whose neighbouring samples are " +
             "not available (a corrupt stream)");
    };
    if (mode == 1) {
      need(left);
      for (int y = 0; y < n; ++y)
        for (int x = 0; x < n; ++x) o[y * W + x] = o[y * W - 1];
    } else if (mode == 2) {
      need(top);
      for (int y = 0; y < n; ++y)
        for (int x = 0; x < n; ++x) o[y * W + x] = o[x - W];
    } else if (mode == 3) {
      need(left && top && topleft);
      const int half = n / 2;
      int H = 0, V = 0;
      for (int i = 0; i < half; ++i) {
        H += (i + 1) * (o[half + i - W] - o[half - 2 - i - W]);
        V += (i + 1) * (o[(half + i) * W - 1] - o[(half - 2 - i) * W - 1]);
      }
      const int a = 16 * (o[(n - 1) * W - 1] + o[n - 1 - W]);
      const int b = chroma ? (34 * H + 32) >> 6 : (5 * H + 32) >> 6, c = chroma ? (34 * V + 32) >> 6 : (5 * V + 32) >> 6;
      for (int y = 0; y < n; ++y)
        for (int x = 0; x < n; ++x) o[y * W + x] = clip1((a + b * (x - half + 1) + c * (y - half + 1) + 16) >> 5);
    } else if (!chroma) {
      int s = 0;
      if (top && left) {
        for (int i = 0; i < 16; ++i) s += o[i - W] + o[i * W - 1];
        s = (s + 16) >> 5;
      } else if (left) {
        for (int i = 0; i < 16; ++i) s += o[i * W - 1];
        s = (s + 8) >> 4;
      } else if (top) {
        for (int i = 0; i < 16; ++i) s += o[i - W];
        s = (s + 8) >> 4;
      } else {
        s = 128;
      }
      for (int y = 0; y < 16; ++y) std::memset(o + y * W, s, 16);
    } else {  // chroma DC, per 4x4 block
      for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx) {
          uint8_t* q = o + by * 4 * W + bx * 4;
          int st = 0, sl = 0;
          for (int i = 0; i < 4; ++i) {
            if (top) st += q[i - W - by * 4 * W];
            if (left) sl += q[i * W - 1 - bx * 4];
          }
          int s;
          if (bx == by) {  // (0, 0) and (4, 4)
            s = top && left ? (st + sl + 4) >> 3 : left ? (sl + 2) >> 2 : top ? (st + 2) >> 2 : 128;
          } else if (bx) {  // (4, 0)
            s = top ? (st + 2) >> 2 : left ? (sl + 2) >> 2 : 128;
          } else {  // (0, 4)
            s = left ? (sl + 2) >> 2 : top ? (st + 2) >> 2 : 128;
          }
          for (int y = 0; y < 4; ++y) std::memset(q + y * W, s, 4);
        }
    }
  }

  // ---- motion vectors

  // the neighbouring 4x4 block at (x4, y4) relative to the current macroblock: available, its ref_idx and vector
  // in list X
  bool neighbour(int X, int x4, int y4, int& ref, int mv[2]) const {
    ref = -1;
    mv[0] = mv[1] = 0;
    if (x4 >= 0 && x4 < 4 && y4 >= 0 && y4 < 4) {
      if (!done[y4 * 4 + x4]) return false;
      ref = m->ref[X][(y4 >> 1) * 2 + (x4 >> 1)];
      mv[0] = m->mv[X][y4 * 4 + x4][0];
      mv[1] = m->mv[X][y4 * 4 + x4][1];
      return true;
    }
    if (y4 >= 4 || (x4 >= 4 && y4 >= 0)) return false;
    const MbInfo* n = mb_at(mbx + (x4 < 0 ? -1 : x4 >= 4 ? 1 : 0), mby + (y4 < 0 ? -1 : 0));
    if (!n) return false;
    if (n->intra()) return true;
    const int lx = (x4 + 4) & 3, ly = (y4 + 4) & 3;
    ref = n->ref[X][(ly >> 1) * 2 + (lx >> 1)];
    mv[0] = n->mv[X][ly * 4 + lx][0];
    mv[1] = n->mv[X][ly * 4 + lx][1];
    return true;
  }

  static int median(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

  // shape: 0 any, 1 a 16x8 partition, 2 an 8x16 partition; part: its index. Returns the rule taken:
  // kMvMedian, kMv16x8 or kMv8x16.
  int predict_mv(int X, int x4, int y4, int w4, int ref, int shape, int part, int out[2]) const {
    int ra, rb, rc, a[2], b[2], c[2];
    const bool av_a = neighbour(X, x4 - 1, y4, ra, a);
    const bool av_b = neighbour(X, x4, y4 - 1, rb, b);
    bool av_c = neighbour(X, x4 + w4, y4 - 1, rc, c);
    if (!av_c) av_c = neighbour(X, x4 - 1, y4 - 1, rc, c);
    if (shape == 1) {
      if (part == 0 && rb == ref) {
        out[0] = b[0], out[1] = b[1];
        return kMv16x8;
      }
      if (part == 1 && ra == ref) {
        out[0] = a[0], out[1] = a[1];
        return kMv16x8;
      }
    } else if (shape == 2) {
      if (part == 0 && ra == ref) {
        out[0] = a[0], out[1] = a[1];
        return kMv8x16;
      }
      if (part == 1 && rc == ref) {
        out[0] = c[0], out[1] = c[1];
        return kMv8x16;
      }
    }
    if (!av_b && !av_c && av_a) {
      out[0] = a[0], out[1] = a[1];
      return kMvMedian;
    }
    const int matches = (ra == ref) + (rb == ref) + (rc == ref);
    if (matches == 1) {
      const int* v = ra == ref ? a : rb == ref ? b : c;
      out[0] = v[0], out[1] = v[1];
      return kMvMedian;
    }
    out[0] = median(a[0], b[0], c[0]);
    out[1] = median(a[1], b[1], c[1]);
    return kMvMedian;
  }

  // the motion of list X over the 4x4 blocks of a (sub-)partition: ref_idx (-1: the list unused) and vector
  void set_motion(int X, int x4, int y4, int w4, int h4, int ref, const int mv[2]) {
    if (ref >= 0 && (std::abs(mv[0]) > 32767 || std::abs(mv[1]) > 32767))
      fail("a motion vector out of range (a corrupt stream)");
    for (int y = y4; y < y4 + h4; ++y)
      for (int x = x4; x < x4 + w4; ++x) {
        m->mv[X][y * 4 + x][0] = (int16_t)(ref >= 0 ? mv[0] : 0);
        m->mv[X][y * 4 + x][1] = (int16_t)(ref >= 0 ? mv[1] : 0);
        m->ref[X][(y >> 1) * 2 + (x >> 1)] = (int8_t)ref;
        m->refpic[X][(y >> 1) * 2 + (x >> 1)] = ref >= 0 ? lists[X][ref]->id : -1;
      }
  }
  void mark_done(int x4, int y4, int w4, int h4) {
    for (int y = y4; y < y4 + h4; ++y)
      for (int x = x4; x < x4 + w4; ++x) done[y * 4 + x] = true;
  }

  // ---- direct prediction (8.4.1.2)

  Spatial spatial_direct() {
    Spatial s;
    for (int X = 0; X < 2; ++X) {
      int ra, rb, rc, a[2], b[2], c[2];
      neighbour(X, -1, 0, ra, a);
      neighbour(X, 0, -1, rb, b);
      if (!neighbour(X, 4, -1, rc, c)) neighbour(X, -1, -1, rc, c);
      auto min_positive = [](int x, int y) { return x >= 0 && y >= 0 ? std::min(x, y) : std::max(x, y); };
      s.ref[X] = min_positive(ra, min_positive(rb, rc));
      if (s.ref[X] >= 0) predict_mv(X, 0, 0, 4, s.ref[X], 0, 0, s.mv[X]);
    }
    if (s.ref[0] < 0 && s.ref[1] < 0) {
      s.ref[0] = s.ref[1] = 0;
      s.zero = true;
      tally[kDirectZeroRefs]++;
    }
    return s;
  }

  // the direct prediction of the 4x4 blocks (x4, y4) .. + size (1 or 2) from the co-located picture RefPicList1[0]
  void direct_block(int x4, int y4, int size, const Spatial& sp) {
    const Picture& colpic = *lists[1][0];
    if (colpic.col.empty()) fail("a direct prediction from a picture without motion (a corrupt stream)");
    const ColMb& cm = colpic.col[(size_t)mby * mb_w + mbx];
    int cx = x4, cy = y4;
    if (size == 2 && sps->direct_8x8_inference) cx = x4 ? 3 : 0, cy = y4 ? 3 : 0;  // the 8x8 block's corner
    const int cb8 = (cy >> 1) * 2 + (cx >> 1);
    int ref_col = -1, list_col = 0, mv_col[2] = {0, 0};
    if (!cm.intra) {
      list_col = cm.ref[0][cb8] >= 0 ? 0 : 1;
      ref_col = cm.ref[list_col][cb8];
      mv_col[0] = cm.mv[list_col][cy * 4 + cx][0];
      mv_col[1] = cm.mv[list_col][cy * 4 + cx][1];
    }
    int ref[2], mv[2][2];
    if (sh.direct_spatial) {
      for (int X = 0; X < 2; ++X) {
        ref[X] = sp.ref[X];
        mv[X][0] = sp.mv[X][0];
        mv[X][1] = sp.mv[X][1];
      }
      const bool col_zero = !colpic.long_ref && ref_col == 0 && std::abs(mv_col[0]) <= 1 && std::abs(mv_col[1]) <= 1;
      if (!sp.zero && col_zero) {
        tally[kDirectColZero]++;
        for (int X = 0; X < 2; ++X)
          if (ref[X] == 0) mv[X][0] = mv[X][1] = 0;
      }
    } else {
      ref[0] = 0;
      ref[1] = 0;
      if (ref_col >= 0) {
        const int id = cm.refpic[list_col][cb8];
        ref[0] = -1;
        for (int i = 0; i < (int)lists[0].size() && ref[0] < 0; ++i)
          if (lists[0][i]->id == id) ref[0] = i;
        if (ref[0] < 0) fail("a temporal direct prediction from a picture RefPicList0 does not hold (a corrupt stream)");
      }
      const Picture& p0 = *lists[0][ref[0]];
      const int tb = clip3(-128, 127, cur->poc - p0.poc), td = clip3(-128, 127, colpic.poc - p0.poc);
      if (p0.long_ref || td == 0) {
        tally[kDirectLongTerm]++;
        mv[0][0] = mv_col[0], mv[0][1] = mv_col[1];
        mv[1][0] = mv[1][1] = 0;
      } else {
        const int tx = (16384 + std::abs(td / 2)) / td, scale = clip3(-1024, 1023, (tb * tx + 32) >> 6);
        for (int c = 0; c < 2; ++c) {
          mv[0][c] = (scale * mv_col[c] + 128) >> 8;
          mv[1][c] = mv[0][c] - mv_col[c];
        }
      }
    }
    for (int X = 0; X < 2; ++X) set_motion(X, x4, y4, size, size, ref[X], mv[X]);
    mark_done(x4, y4, size, size);
  }

  // the direct prediction of 8x8 block k: one block with direct_8x8_inference_flag, else four 4x4 ones
  void direct_8x8(int k, const Spatial& sp) {
    const int x4 = (k & 1) * 2, y4 = (k >> 1) * 2;
    if (sps->direct_8x8_inference) {
      direct_block(x4, y4, 2, sp);
    } else {
      tally[kDirectNoInference]++;
      for (int j = 0; j < 4; ++j) direct_block(x4 + (j & 1), y4 + (j >> 1), 1, sp);
    }
    m->direct8[k] = true;
  }

  // ---- motion compensation

  // the prediction from ref of a block at luma (x0, y0), bw x bh, by mv: luma into py, chroma into pu and pv
  void predict(const Picture& r, const int16_t* mv, int x0, int y0, int bw, int bh, uint8_t* py, uint8_t* pu,
               uint8_t* pv) {
    const int mvx = mv[0], mvy = mv[1];
    const int W = cur->w, H = cur->h;
    const int xi = x0 + (mvx >> 2), yi = y0 + (mvy >> 2), fx = mvx & 3, fy = mvy & 3;
    tally[!fx && !fy ? kLumaFull : (fx & 1) || (fy & 1) ? kLumaQuarter : kLumaHalf]++;
    tally[kMcOffPicture] += xi - 2 < 0 || yi - 2 < 0 || xi + bw + 3 > W || yi + bh + 3 > H;
    // the reference samples, clamped at the picture's edges: rows yi-2 .. yi+bh+2, columns xi-2 .. xi+bw+2
    const int SW = bw + 5, SH = bh + 5;
    int G[21 * 21];
    for (int j = 0; j < SH; ++j) {
      const uint8_t* row = &r.y[(size_t)clip3(0, H - 1, yi - 2 + j) * W];
      for (int i = 0; i < SW; ++i) G[j * SW + i] = row[clip3(0, W - 1, xi - 2 + i)];
    }
    auto g = [&](int x, int y) { return G[(y + 2) * SW + x + 2]; };
    auto tap = [](int a, int b, int c, int d, int e, int f) { return a - 5 * b + 20 * c + 20 * d - 5 * e + f; };
    auto b1 = [&](int x, int y) { return tap(g(x - 2, y), g(x - 1, y), g(x, y), g(x + 1, y), g(x + 2, y), g(x + 3, y)); };
    auto h1 = [&](int x, int y) { return tap(g(x, y - 2), g(x, y - 1), g(x, y), g(x, y + 1), g(x, y + 2), g(x, y + 3)); };
    auto hb = [&](int x, int y) { return (int)clip1((b1(x, y) + 16) >> 5); };
    auto hh = [&](int x, int y) { return (int)clip1((h1(x, y) + 16) >> 5); };
    auto hj = [&](int x, int y) {
      return (int)clip1((tap(b1(x, y - 2), b1(x, y - 1), b1(x, y), b1(x, y + 1), b1(x, y + 2), b1(x, y + 3)) + 512) >> 10);
    };
    auto avg = [](int a, int b) { return (a + b + 1) >> 1; };
    for (int y = 0; y < bh; ++y)
      for (int x = 0; x < bw; ++x) {
        int v;
        switch (fy * 4 + fx) {
          case 0: v = g(x, y); break;
          case 1: v = avg(g(x, y), hb(x, y)); break;
          case 2: v = hb(x, y); break;
          case 3: v = avg(g(x + 1, y), hb(x, y)); break;
          case 4: v = avg(g(x, y), hh(x, y)); break;
          case 5: v = avg(hb(x, y), hh(x, y)); break;
          case 6: v = avg(hb(x, y), hj(x, y)); break;
          case 7: v = avg(hb(x, y), hh(x + 1, y)); break;
          case 8: v = hh(x, y); break;
          case 9: v = avg(hh(x, y), hj(x, y)); break;
          case 10: v = hj(x, y); break;
          case 11: v = avg(hj(x, y), hh(x + 1, y)); break;
          case 12: v = avg(g(x, y + 1), hh(x, y)); break;
          case 13: v = avg(hh(x, y), hb(x, y + 1)); break;
          case 14: v = avg(hj(x, y), hb(x, y + 1)); break;
          default: v = avg(hh(x + 1, y), hb(x, y + 1)); break;
        }
        py[y * bw + x] = (uint8_t)v;
      }
    // chroma: eighth-sample bilinear
    const int CW = W / 2, CH = H / 2, cbw = bw / 2, cbh = bh / 2;
    const int cx = x0 / 2 + (mvx >> 3), cy = y0 / 2 + (mvy >> 3), ax = mvx & 7, ay = mvy & 7;
    tally[kChromaFraction] += ax || ay;
    for (int c = 0; c < 2; ++c) {
      const std::vector<uint8_t>& src = c ? r.v : r.u;
      uint8_t* q = c ? pv : pu;
      for (int y = 0; y < cbh; ++y) {
        const uint8_t* r0 = &src[(size_t)clip3(0, CH - 1, cy + y) * CW];
        const uint8_t* r1 = &src[(size_t)clip3(0, CH - 1, cy + y + 1) * CW];
        for (int x = 0; x < cbw; ++x) {
          const int xa = clip3(0, CW - 1, cx + x), xb = clip3(0, CW - 1, cx + x + 1);
          q[y * cbw + x] = (uint8_t)(((8 - ax) * (8 - ay) * r0[xa] + ax * (8 - ay) * r0[xb] + (8 - ax) * ay * r1[xa] +
                                      ax * ay * r1[xb] + 32) >> 6);
        }
      }
    }
  }

  // implicit bi-predictive weight w1 of the pair (8.4.2.3.1); w0 is 64 - w1
  int implicit_w1(int r0, int r1) {
    const Picture &p0 = *lists[0][r0], &p1 = *lists[1][r1];
    const int td = clip3(-128, 127, p1.poc - p0.poc);
    if (!p0.long_ref && !p1.long_ref && td) {
      const int tb = clip3(-128, 127, cur->poc - p0.poc), tx = (16384 + std::abs(td / 2)) / td;
      const int w = clip3(-1024, 1023, (tb * tx + 32) >> 6) >> 2;
      if (w >= -64 && w <= 128) return w;
    }
    tally[kWeightsImplicitDefault]++;
    return 32;
  }

  // the inter prediction of the 4x4 blocks (x4, y4) .. + (w4, h4), one 8x8 block's motion (8.4.2)
  void mc(int x4, int y4, int w4, int h4) {
    const int b8 = (y4 >> 1) * 2 + (x4 >> 1);
    const int r[2] = {m->ref[0][b8], m->ref[1][b8]};
    const int W = cur->w, bw = w4 * 4, bh = h4 * 4, x0 = mbx * 16 + x4 * 4, y0 = mby * 16 + y4 * 4;
    uint8_t py[2][256], pc[2][2][64];
    for (int X = 0; X < 2; ++X)
      if (r[X] >= 0) predict(*lists[X][r[X]], m->mv[X][y4 * 4 + x4], x0, y0, bw, bh, py[X], pc[X][0], pc[X][1]);
    const bool bi = r[0] >= 0 && r[1] >= 0;
    const int one = r[0] >= 0 ? 0 : 1;
    tally[bi ? kPredBi : one ? kPredL1 : kPredL0] += slice_type == 1;
    // the weighted sample prediction (8.4.2.3): mode 0 default, 1 explicit, 2 implicit
    const int mode = slice_type == 1 ? pps->weighted_bipred : pps->weighted ? 1 : 0;
    int iw1 = 32;
    if (mode == 2 && bi) {
      iw1 = implicit_w1(r[0], r[1]);
      tally[kWeightsImplicit] += iw1 != 32;
    }
    if (mode == 1 && sh.wt.any) tally[slice_type == 1 ? kWeightsExplicitB : kWeightsExplicitP]++;
    for (int comp = 0; comp < 3; ++comp) {
      const int n = comp ? bw / 2 : bw, rows = comp ? bh / 2 : bh, stride = comp ? W / 2 : W;
      uint8_t* dst = comp == 0 ? &cur->y[(size_t)y0 * W + x0]
                               : &(comp == 1 ? cur->u : cur->v)[(size_t)(y0 / 2) * (W / 2) + x0 / 2];
      const uint8_t* a = comp ? pc[bi ? 0 : one][comp - 1] : py[bi ? 0 : one];
      const uint8_t* b = comp ? pc[1][comp - 1] : py[1];
      int w0 = 1, w1 = 1, o0 = 0, o1 = 0, logwd = 0;
      if (mode == 1) {
        logwd = comp ? sh.wt.chroma_log2 : sh.wt.luma_log2;
        const int ra = bi ? r[0] : r[one], la = bi ? 0 : one;
        w0 = comp ? sh.wt.cw[la][ra][comp - 1] : sh.wt.lw[la][ra];
        o0 = comp ? sh.wt.co[la][ra][comp - 1] : sh.wt.lo[la][ra];
        if (bi) {
          w1 = comp ? sh.wt.cw[1][r[1]][comp - 1] : sh.wt.lw[1][r[1]];
          o1 = comp ? sh.wt.co[1][r[1]][comp - 1] : sh.wt.lo[1][r[1]];
        }
      } else if (mode == 2 && bi) {
        logwd = 5;
        w0 = 64 - iw1;
        w1 = iw1;
      }
      for (int y = 0; y < rows; ++y)
        for (int x = 0; x < n; ++x) {
          const int p0 = a[y * n + x];
          int v;
          if (bi) {
            const int p1 = b[y * n + x];
            v = mode == 0 ? (p0 + p1 + 1) >> 1
                          : clip1(((p0 * w0 + p1 * w1 + (1 << logwd)) >> (logwd + 1)) + ((o0 + o1 + 1) >> 1));
          } else if (mode == 1) {
            v = logwd >= 1 ? clip1(((p0 * w0 + (1 << (logwd - 1))) >> logwd) + o0) : clip1(p0 * w0 + o0);
          } else {
            v = p0;
          }
          dst[y * stride + x] = (uint8_t)v;
        }
    }
  }

  // ---- macroblocks

  int chroma_qp(int c, int q) const { return kChromaQp[clip3(0, 51, q + pps->chroma_qp_offset[c])]; }

  void slice_data(Bits& b) {
    int addr = mbs_done;
    bool more = true;
    while (more) {
      if (slice_type != 2) {
        const uint32_t run = b.ue();
        for (uint32_t i = 0; i < run; ++i) {
          if (addr >= mb_w * mb_h) fail("mb_skip_run past the picture (a corrupt stream)");
          begin_mb(addr++);
          skip_mb();
        }
        if (run > 0 && !b.more_data()) break;
      }
      if (addr >= mb_w * mb_h) fail("a slice with more macroblocks than its picture (a corrupt stream)");
      begin_mb(addr++);
      macroblock(b);
      more = b.more_data();
    }
    mbs_done = addr;
  }

  void slice_data_cabac(Bits& b) {
    while (b.pos & 7)
      if (!b.flag()) fail("a cabac_alignment_one_bit of 0 (a corrupt stream)");
    cab.init_contexts(slice_type == 2 ? 0 : 1 + sh.cabac_init_idc, sh.qp);
    cab.start(b);
    last_dqp = false;
    int addr = mbs_done;
    for (;;) {
      if (addr >= mb_w * mb_h) fail("a slice with more macroblocks than its picture (a corrupt stream)");
      begin_mb(addr++);
      if (slice_type != 2 && read_skip_cabac()) {
        skip_mb();
      } else {
        macroblock(b);
      }
      if (cab.terminate()) break;  // end_of_slice_flag
    }
    mbs_done = addr;
  }

  void begin_mb(int addr) {
    mbx = addr % mb_w;
    mby = addr / mb_w;
    m = &mbs[addr];
    m->slice = slice_num;
    std::memset(m->nz, 0, sizeof m->nz);
    std::memset(m->nzc, 0, sizeof m->nzc);
    std::memset(m->nzd, 0, sizeof m->nzd);
    std::memset(m->mode, -1, sizeof m->mode);
    std::memset(m->mv, 0, sizeof m->mv);
    std::memset(m->ref, -1, sizeof m->ref);
    std::memset(m->mvd, 0, sizeof m->mvd);
    std::memset(m->direct8, 0, sizeof m->direct8);
    for (auto& l : m->refpic)
      for (int& r : l) r = -1;
    m->cbf = 0;
    m->cbp = 0;
    m->chroma_mode = 0;
    m->t8 = m->bdirect = m->skipped = false;
    std::memset(done, 0, sizeof done);
  }

  void set_qps(int q) {
    m->qp = q;
    m->qpc[0] = chroma_qp(0, q);
    m->qpc[1] = chroma_qp(1, q);
  }

  void skip_mb() {
    m->kind = kSkip;
    m->skipped = true;
    last_dqp = false;
    if (slice_type == 1) {  // B_Skip: direct prediction
      tally[kMbBSkip]++;
      m->bdirect = true;
      direct_mb();
    } else {
      tally[kMbSkip]++;
      int mv[2] = {0, 0}, ra, rb, a[2], bb[2];
      const bool av_a = neighbour(0, -1, 0, ra, a), av_b = neighbour(0, 0, -1, rb, bb);
      if (!av_a || !av_b || (ra == 0 && !a[0] && !a[1]) || (rb == 0 && !bb[0] && !bb[1])) {
        tally[kSkipZero]++;
      } else {
        predict_mv(0, 0, 0, 4, 0, 0, 0, mv);
        tally[kSkipPredicted]++;
      }
      set_motion(0, 0, 0, 4, 4, 0, mv);
      set_motion(1, 0, 0, 4, 4, -1, mv);
      mark_done(0, 0, 4, 4);
      mc(0, 0, 4, 4);
    }
    set_qps(qp);
  }

  // B_Skip and B_Direct_16x16: each 8x8 block predicted in direct mode, then compensated
  void direct_mb() {
    tally[sh.direct_spatial ? kDirectSpatial : kDirectTemporal]++;
    const Spatial sp = sh.direct_spatial ? spatial_direct() : Spatial();
    for (int k = 0; k < 4; ++k) direct_8x8(k, sp);
    for (int k = 0; k < 4; ++k) mc_8x8(k);
  }

  // the compensation of 8x8 block k: whole when its four 4x4 blocks share their motion, else one by one
  void mc_8x8(int k) {
    const int x4 = (k & 1) * 2, y4 = (k >> 1) * 2;
    bool same = true;
    for (int X = 0; X < 2; ++X)
      for (int j = 1; j < 4; ++j) {
        const int16_t *a = m->mv[X][y4 * 4 + x4], *b = m->mv[X][(y4 + (j >> 1)) * 4 + x4 + (j & 1)];
        same &= a[0] == b[0] && a[1] == b[1];
      }
    if (same)
      mc(x4, y4, 2, 2);
    else
      for (int j = 0; j < 4; ++j) mc(x4 + (j & 1), y4 + (j >> 1), 1, 1);
  }

  void macroblock(Bits& b) {
    int t = read_mb_type(b);
    if (slice_type == 0) {
      if (t < 5) {
        inter_mb(b, t);
        return;
      }
      t -= 5;
      tally[kMbIntraInP]++;
    } else if (slice_type == 1) {
      if (t < 23) {
        inter_mb(b, t);
        return;
      }
      t -= 23;
      tally[kMbIntraInB]++;
    }
    if (t == 25) {
      pcm_mb(b);
      return;
    }
    const bool i16 = t > 0, t8 = !i16 && pps->transform_8x8 && read_t8(b);
    m->kind = i16 ? kI16 : t8 ? kI8 : kI4;
    m->t8 = t8;
    int modes[16] = {};
    if (t8) {
      tally[kMbI8x8]++;
      for (int k = 0; k < 4; ++k) {
        const int bx = (k & 1) * 2, by = (k >> 1) * 2, mode = read_intra_mode(b, predicted_mode(bx, by));
        for (int j = 0; j < 4; ++j) m->mode[(by + (j >> 1)) * 4 + bx + (j & 1)] = (int8_t)mode;
        modes[k] = mode;
        tally[kI8x8Mode0 + mode]++;
      }
    } else if (!i16) {
      tally[kMbI4x4]++;
      for (int k = 0; k < 16; ++k) {
        const int bx = kBlockOrder[k][0], by = kBlockOrder[k][1], mode = read_intra_mode(b, predicted_mode(bx, by));
        m->mode[by * 4 + bx] = (int8_t)mode;
        modes[k] = mode;
        tally[kI4x4Mode0 + mode]++;
      }
    } else {
      tally[kMbI16x16]++;
    }
    const int chroma_mode = read_chroma_mode(b);
    m->chroma_mode = (uint8_t)chroma_mode;
    tally[kChromaMode0 + chroma_mode]++;
    int cbp;
    if (i16) {
      const int k = t - 1;
      cbp = ((k / 4) % 3) << 4 | (k >= 12 ? 15 : 0);
      tally[kI16x16Mode0 + k % 4]++;
      tally[kI16x16Chroma0 + (k / 4) % 3]++;
      tally[kI16x16Ac] += k >= 12;
    } else {
      cbp = read_cbp(b, true);
    }
    m->cbp = (uint8_t)cbp;
    if (cbp || i16)
      read_qp_delta(b);
    else
      last_dqp = false;
    set_qps(qp);
    int coef[16][16] = {}, coef8[4][64] = {}, dc[16] = {};
    int chroma[2][4][16] = {}, cdc[2][4] = {};
    residual(b, cbp, i16, t8, coef, coef8, dc, chroma, cdc);
    // reconstruction
    const int W = cur->w;
    if (i16) {
      static const int map[4] = {2, 1, 0, 3};  // luma's V, H, DC, plane in chroma's numbering
      intra_block(cur->y.data(), W, mbx * 16, mby * 16, 16, map[(t - 1) % 4], false);
      luma_dc(dc);
      for (int k = 0; k < 16; ++k) coef[k][0] = dc[k];
      for (int by = 0; by < 4; ++by)
        for (int bx = 0; bx < 4; ++bx)
          idct_add(coef[by * 4 + bx], &cur->y[(size_t)(mby * 16 + by * 4) * W + mbx * 16 + bx * 4], W);
    } else if (t8) {
      for (int k = 0; k < 4; ++k) {
        intra8x8(k, modes[k]);
        if (cbp >> k & 1)
          idct8_add(coef8[k], &cur->y[(size_t)(mby * 16 + (k >> 1) * 8) * W + mbx * 16 + (k & 1) * 8], W);
      }
    } else {
      for (int k = 0; k < 16; ++k) {
        const int bx = kBlockOrder[k][0], by = kBlockOrder[k][1];
        intra4x4(bx, by, modes[k]);
        idct_add(coef[by * 4 + bx], &cur->y[(size_t)(mby * 16 + by * 4) * W + mbx * 16 + bx * 4], W);
      }
    }
    intra_block(cur->u.data(), W / 2, mbx * 8, mby * 8, 8, chroma_mode, true);
    intra_block(cur->v.data(), W / 2, mbx * 8, mby * 8, 8, chroma_mode, true);
    add_chroma(chroma, cdc);
  }

  int predicted_mode(int bx, int by) const {
    auto mode_of = [&](int x4, int y4, bool& dc) {
      if (x4 >= 0 && y4 >= 0) return (int)m->mode[y4 * 4 + x4];
      const MbInfo* n = mb_at(mbx + (x4 < 0 ? -1 : 0), mby + (y4 < 0 ? -1 : 0));
      if (!n || (pps->constrained_intra && !n->intra())) {
        dc = true;
        return 2;
      }
      return n->kind == kI4 || n->kind == kI8 ? (int)n->mode[((y4 + 4) & 3) * 4 + ((x4 + 4) & 3)] : 2;
    };
    bool dc = false;
    const int a = mode_of(bx - 1, by, dc), b = mode_of(bx, by - 1, dc);
    return dc ? 2 : std::min(a, b);
  }

  void pcm_mb(Bits& b) {
    tally[kMbPcm]++;
    tally[kCabacPcm] += cabac;
    m->kind = kPcm;
    b.skip((int)((8 - (b.pos & 7)) & 7));
    const int W = cur->w;
    for (int y = 0; y < 16; ++y)
      for (int x = 0; x < 16; ++x) cur->y[(size_t)(mby * 16 + y) * W + mbx * 16 + x] = (uint8_t)b.u(8);
    for (int c = 0; c < 2; ++c)
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x) (c ? cur->v : cur->u)[(size_t)(mby * 8 + y) * (W / 2) + mbx * 8 + x] = (uint8_t)b.u(8);
    std::memset(m->nz, 16, sizeof m->nz);
    std::memset(m->nzc, 16, sizeof m->nzc);
    m->cbf = ~0u;
    m->cbp = 0x2F;
    last_dqp = false;
    set_qps(0);  // the deblocking filter takes an I_PCM macroblock's QP as 0; the QP prediction goes on unchanged
    if (cabac) cab.start(b);  // the arithmetic decoder starts again after the samples
  }

  // P macroblocks (mb_type 0-4) and B macroblocks (0-22): their prediction, residual and reconstruction
  void inter_mb(Bits& b, int t) {
    m->kind = kInter;
    const bool B = slice_type == 1;
    Part parts[16];
    int np = 0, sub[4] = {0, 0, 0, 0};
    bool direct = false, small = false, ref0 = false, is8x8 = false;
    int shape = 0;
    if (B && t == 0) {  // B_Direct_16x16
      tally[kMbBDirect16x16]++;
      m->bdirect = direct = true;
      for (int k = 0; k < 4; ++k) m->direct8[k] = true;
    } else if ((B && t < 22) || (!B && t < 3)) {
      shape = B ? kBTypes[t][0] : t;
      static const int shapes[3][2][4] = {{{0, 0, 4, 4}}, {{0, 0, 4, 2}, {0, 2, 4, 2}}, {{0, 0, 2, 4}, {2, 0, 2, 4}}};
      np = shape ? 2 : 1;
      for (int p = 0; p < np; ++p)
        parts[p] = Part{shapes[shape][p][0], shapes[shape][p][1], shapes[shape][p][2], shapes[shape][p][3],
                        B ? kBTypes[t][1 + p] : 1, p};
      tally[B ? (shape == 0 ? kMbB16x16 : shape == 1 ? kMbB16x8 : kMbB8x16) : kMbP16x16 + t]++;
    } else {  // P_8x8, P_8x8ref0, B_8x8
      is8x8 = true;
      ref0 = !B && t == 4;
      tally[B ? kMbB8x8 : ref0 ? kMbP8x8Ref0 : kMbP8x8]++;
      for (int k = 0; k < 4; ++k) {
        sub[k] = read_sub_type(b);
        if (B) {
          static const int kinds[13] = {kSubBDirect, kSubB8x8, kSubB8x8, kSubB8x8, kSubB8x4, kSubB4x8, kSubB8x4,
                                        kSubB4x8, kSubB8x4, kSubB4x8, kSubB4x4, kSubB4x4, kSubB4x4};
          tally[kinds[sub[k]]]++;
        } else {
          tally[kSub8x8 + sub[k]]++;
        }
      }
      for (int k = 0; k < 4; ++k) {
        const int pred = B ? kBSubs[sub[k]][0] : 1, w = B ? kBSubs[sub[k]][1] : kPSubs[sub[k]][0],
                  h = B ? kBSubs[sub[k]][2] : kPSubs[sub[k]][1], n = 4 / (w * h);
        if (!pred) {
          m->direct8[k] = true;
          small |= !sps->direct_8x8_inference;
        }
        small |= n > 1;
        for (int s = 0; s < n; ++s)
          parts[np++] = Part{(k & 1) * 2 + (w == 1 ? s & 1 : 0), (k >> 1) * 2 + (h == 1 ? (w == 1 ? s >> 1 : s) : 0),
                             w, h, pred, k};
      }
    }
    // ref_idx_l0 of every partition, then ref_idx_l1, then mvd_l0, then mvd_l1 (7.3.5.1, 7.3.5.2)
    int refs_[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}}, mvd[2][16][2] = {};
    for (int X = 0; X < (B ? 2 : 1); ++X) {
      const int n_ref = (int)lists[X].size();
      for (int p = 0; p < np; ++p) {
        const Part& q = parts[p];
        if (!(q.pred >> X & 1) || (p > 0 && parts[p - 1].unit == q.unit)) continue;
        refs_[X][q.unit] = n_ref > 1 && !ref0 ? read_ref(b, X, q.x4, q.y4, n_ref) : 0;
        const int x8 = is8x8 ? (q.unit & 1) * 2 : q.x4, y8 = is8x8 ? (q.unit >> 1) * 2 : q.y4;
        const int w8 = is8x8 ? 2 : q.w4, h8 = is8x8 ? 2 : q.h4;
        for (int y = y8; y < y8 + h8; y += 2)
          for (int x = x8; x < x8 + w8; x += 2) m->ref[X][(y >> 1) * 2 + (x >> 1)] = (int8_t)refs_[X][q.unit];
      }
    }
    for (int X = 0; X < (B ? 2 : 1); ++X)
      for (int p = 0; p < np; ++p)
        if (parts[p].pred >> X & 1) read_mvd(b, X, parts[p], mvd[X][p]);
    // the vectors, partition by partition in decoding order
    const bool any_direct = direct || (is8x8 && B && (!sub[0] || !sub[1] || !sub[2] || !sub[3]));
    Spatial sp;
    if (any_direct) {
      tally[sh.direct_spatial ? kDirectSpatial : kDirectTemporal]++;
      if (sh.direct_spatial) sp = spatial_direct();
    }
    if (direct) {
      for (int k = 0; k < 4; ++k) direct_8x8(k, sp);
    } else {
      for (int p = 0; p < np; ++p) {
        const Part& q = parts[p];
        if (!q.pred) {
          if (p == 0 || parts[p - 1].unit != q.unit) direct_8x8(q.unit, sp);
          continue;
        }
        for (int X = 0; X < 2; ++X) {
          int mv[2] = {0, 0};
          const int r = q.pred >> X & 1 ? refs_[X][q.unit] : -1;
          if (r >= 0) {
            tally[predict_mv(X, q.x4, q.y4, q.w4, r, is8x8 ? 0 : shape, q.unit, mv)]++;
            mv[0] += mvd[X][p][0];
            mv[1] += mvd[X][p][1];
          }
          set_motion(X, q.x4, q.y4, q.w4, q.h4, r, mv);
        }
        mark_done(q.x4, q.y4, q.w4, q.h4);
      }
    }
    const int cbp = read_cbp(b, false);
    m->cbp = (uint8_t)cbp;
    const bool t8 = (cbp & 15) && pps->transform_8x8 && !small && (!direct || sps->direct_8x8_inference) && read_t8(b);
    m->t8 = t8;
    tally[kTransform8x8] += t8;
    if (cbp)
      read_qp_delta(b);
    else
      last_dqp = false;
    set_qps(qp);
    int coef[16][16] = {}, coef8[4][64] = {}, dc[16] = {};
    int chroma[2][4][16] = {}, cdc[2][4] = {};
    residual(b, cbp, false, t8, coef, coef8, dc, chroma, cdc);
    if (direct || is8x8) {
      if (!is8x8) {
        for (int k = 0; k < 4; ++k) mc_8x8(k);
      } else {
        for (int p = 0; p < np; ++p)
          if (parts[p].pred)
            mc(parts[p].x4, parts[p].y4, parts[p].w4, parts[p].h4);
          else if (p == 0 || parts[p - 1].unit != parts[p].unit)
            mc_8x8(parts[p].unit);
      }
    } else {
      for (int p = 0; p < np; ++p) mc(parts[p].x4, parts[p].y4, parts[p].w4, parts[p].h4);
    }
    const int W = cur->w;
    for (int k = 0; k < 4; ++k) {
      if (!(cbp >> k & 1)) continue;
      uint8_t* o = &cur->y[(size_t)(mby * 16 + (k >> 1) * 8) * W + mbx * 16 + (k & 1) * 8];
      if (t8) {
        idct8_add(coef8[k], o, W);
      } else {
        for (int j = 0; j < 4; ++j) {
          const int bx = (k & 1) * 2 + (j & 1), by = (k >> 1) * 2 + (j >> 1);
          idct_add(coef[by * 4 + bx], o + (size_t)(j >> 1) * 4 * W + (j & 1) * 4, W);
        }
      }
    }
    add_chroma(chroma, cdc);
  }

  // Reads the macroblock's residual: coef by raster 4x4 block (dequantised, raster positions; an Intra 16x16
  // block's DC left for luma_dc), coef8 by 8x8 block under the 8x8 transform, dc the Intra 16x16 DC levels
  // (raster), chroma AC and DC levels. Keeps each reader's view of the counts (see the top).
  void residual(Bits& b, int cbp, bool i16, bool t8, int coef[16][16], int coef8[4][64], int dc[16],
                int chroma[2][4][16], int cdc[2][4]) {
    const bool intra = m->intra();
    const int l4 = intra ? 0 : 3, l8 = intra ? 0 : 1;
    int lv[64];
    if (i16) {
      tally[kLumaDc]++;
      const int n = cabac ? residual_cabac(0, cbf_term(left(), kCbfDc) + 2 * cbf_term(top(), kCbfDc), 16, lv)
                          : residual_block(b, nc_of(luma_nz(-1, 0), luma_nz(0, -1)), 16, lv);
      if (n) m->cbf |= 1u << kCbfDc;
      for (int k = 0; k < 16; ++k) dc[kZigzag[k]] = lv[k];
    }
    for (int k8 = 0; k8 < 4; ++k8) {
      if (!(cbp >> k8 & 1)) continue;
      if (t8 && cabac) {
        const int n = residual_cabac(5, 0, 64, lv);
        for (int i = 0; i < 64; ++i)
          if (lv[i]) coef8[k8][kZigzag8[i]] = dequant8(lv[i], l8, m->qp, kZigzag8[i]);
        for (int j = 0; j < 4; ++j) {
          const int blk = ((k8 >> 1) * 2 + (j >> 1)) * 4 + (k8 & 1) * 2 + (j & 1);
          m->cbf |= 1u << blk;
          m->nz[blk] = (uint8_t)n;
          m->nzd[blk] = 1;
        }
        continue;
      }
      bool any = false;
      for (int j = 0; j < 4; ++j) {
        const int bx = kBlockOrder[k8 * 4 + j][0], by = kBlockOrder[k8 * 4 + j][1], blk = by * 4 + bx;
        const int start = i16 ? 1 : 0;
        int n;
        if (cabac) {
          int ba, bb;
          const MbInfo* na = block_at(bx - 1, by, ba);
          const MbInfo* nb = block_at(bx, by - 1, bb);
          n = residual_cabac(i16 ? 1 : 2, cbf_term(na, ba) + 2 * cbf_term(nb, bb), 16 - start, lv);
          if (n) m->cbf |= 1u << blk;
        } else {
          n = residual_block(b, nc_of(luma_nz(bx - 1, by), luma_nz(bx, by - 1)), 16 - start, lv);
        }
        m->nz[blk] = (uint8_t)n;
        m->nzd[blk] = n > 0;
        any |= n > 0;
        if (t8) {  // CAVLC's 8x8 block: four interleaved 4x4 codes
          for (int i = 0; i < 16; ++i)
            if (lv[i]) coef8[k8][kZigzag8[4 * i + j]] = dequant8(lv[i], l8, m->qp, kZigzag8[4 * i + j]);
        } else {
          for (int i = 0; i < 16 - start; ++i)
            if (lv[i]) coef[blk][kZigzag[i + start]] = dequant4(lv[i], l4, m->qp, kZigzag[i + start]);
        }
      }
      if (t8)
        for (int j = 0; j < 4; ++j) m->nzd[kBlockOrder[k8 * 4 + j][1] * 4 + kBlockOrder[k8 * 4 + j][0]] = any;
    }
    const int cc = cbp >> 4;
    if (cc > 2) fail("coded_block_pattern chroma 3 (a corrupt stream)");
    if (cc) {
      for (int c = 0; c < 2; ++c) {
        tally[kChromaDc]++;
        const int bit = kCbfChromaDc + c;
        const int n = cabac ? residual_cabac(3, cbf_term(left(), bit) + 2 * cbf_term(top(), bit), 4, cdc[c])
                            : residual_block(b, -1, 4, cdc[c]);
        if (n) m->cbf |= 1u << bit;
      }
    }
    if (cc & 2) {
      for (int c = 0; c < 2; ++c)
        for (int k = 0; k < 4; ++k) {
          tally[kChromaAc]++;
          const int bx = k & 1, by = k >> 1;
          int n;
          if (cabac) {
            const int base = kCbfChromaAc + 4 * c;
            const MbInfo* na = bx ? m : left();
            const MbInfo* nb = by ? m : top();
            n = residual_cabac(4, cbf_term(na, base + (by * 2 + (bx ^ 1))) + 2 * cbf_term(nb, base + ((by ^ 1) * 2 + bx)),
                               15, lv);
            if (n) m->cbf |= 1u << (base + k);
          } else {
            n = residual_block(b, nc_of(chroma_nz(c, bx - 1, by), chroma_nz(c, bx, by - 1)), 15, lv);
          }
          m->nzc[c][k] = (uint8_t)n;
          for (int i = 0; i < 15; ++i)
            if (lv[i]) chroma[c][k][kZigzag[i + 1]] = dequant4(lv[i], (intra ? 1 : 4) + c, m->qpc[c], kZigzag[i + 1]);
        }
    }
  }

  // the Intra 16x16 DC: inverse Hadamard and dequantisation, in place (raster). libavcodec's SIMD dequantisation
  // (cv2's) multiplies by LevelScale4x4 << (qP / 6 + 2) and rounds at 2^8, as the standard does, while that
  // multiplier fits 15 bits; above, it drops the multiplier's low 7 bits, which only a scaling list makes non-zero
  void luma_dc(int c[16]) {
    int t[16];
    for (int i = 0; i < 4; ++i) {
      const int* r = c + 4 * i;
      t[4 * i] = r[0] + r[1] + r[2] + r[3];
      t[4 * i + 1] = r[0] + r[1] - r[2] - r[3];
      t[4 * i + 2] = r[0] - r[1] - r[2] + r[3];
      t[4 * i + 3] = r[0] - r[1] + r[2] - r[3];
    }
    const int q = m->qp, qmul = ls4[0][q % 6][0] * (1 << (q / 6 + 2));
    tally[kLumaDcCoarse] += qmul > 32767 && (qmul & 127);
    for (int j = 0; j < 4; ++j) {
      const int f[4] = {t[j] + t[4 + j] + t[8 + j] + t[12 + j], t[j] + t[4 + j] - t[8 + j] - t[12 + j],
                        t[j] - t[4 + j] - t[8 + j] + t[12 + j], t[j] - t[4 + j] + t[8 + j] - t[12 + j]};
      for (int i = 0; i < 4; ++i)
        c[4 * i + j] = qmul <= 32767 ? (f[i] * qmul + 128) >> 8 : (f[i] * (qmul >> 7) + 1) >> 1;
    }
  }

  void add_chroma(int chroma[2][4][16], int cdc[2][4]) {
    const int CW = cur->w / 2;
    for (int c = 0; c < 2; ++c) {
      const int* d = cdc[c];
      const int f[4] = {d[0] + d[1] + d[2] + d[3], d[0] - d[1] + d[2] - d[3], d[0] + d[1] - d[2] - d[3],
                        d[0] - d[1] - d[2] + d[3]};
      const int q = m->qpc[c], scale = ls4[(m->intra() ? 1 : 4) + c][q % 6][0];
      for (int k = 0; k < 4; ++k) {
        chroma[c][k][0] = (f[k] * scale * (1 << (q / 6))) >> 5;
        uint8_t* o = (c ? cur->v.data() : cur->u.data()) + (size_t)(mby * 8 + (k >> 1) * 4) * CW + mbx * 8 + (k & 1) * 4;
        idct_add(chroma[c][k], o, CW);
      }
    }
  }

  // ---- the deblocking filter (8.7)

  // bS of the edge between 4x4 block pb of p and qb of q: the reference pictures compared as sets, each
  // pairing of the vectors (8.7.2.1)
  int bs_of(const MbInfo& p, int pb, const MbInfo& q, int qb, bool mb_edge) {
    if (p.intra() || q.intra()) return mb_edge ? 4 : 3;
    if (p.nzd[pb] || q.nzd[qb]) return 2;
    const int p8 = (pb >> 3) * 2 + ((pb & 3) >> 1), q8 = (qb >> 3) * 2 + ((qb & 3) >> 1);
    auto far = [](const int16_t* a, const int16_t* b) { return std::abs(a[0] - b[0]) >= 4 || std::abs(a[1] - b[1]) >= 4; };
    const int p0 = p.refpic[0][p8], p1 = p.refpic[1][p8], q0 = q.refpic[0][q8], q1 = q.refpic[1][q8];
    bool v = p0 != q0 || (p0 >= 0 && far(p.mv[0][pb], q.mv[0][qb]));
    if (!v) v = p1 != q1 || far(p.mv[1][pb], q.mv[1][qb]);
    if (!v) return 0;
    if (p0 != q1 || p1 != q0) return 1;
    return far(p.mv[0][pb], q.mv[1][qb]) || far(p.mv[1][pb], q.mv[0][qb]);
  }

  // filters the samples across one edge: p[k] = s[-k-1 step], q[k] = s[k step], for n positions along `along`
  void filter_edge(uint8_t* s, int step, int along, int n, const int bs[4], int qp_av, const SliceParams& sp,
                   bool chroma) {
    const int ia = clip3(0, 51, qp_av + sp.alpha), ib = clip3(0, 51, qp_av + sp.beta);
    const int alpha = kAlpha[ia], beta = kBeta[ib];
    for (int i = 0; i < n; ++i) {
      const int strength = bs[chroma ? i / 2 : i / 4];
      if (!strength) continue;
      uint8_t* t = s + i * along;
      const int p0 = t[-step], p1 = t[-2 * step], q0 = t[0], q1 = t[step];
      if (std::abs(p0 - q0) >= alpha || std::abs(p1 - p0) >= beta || std::abs(q1 - q0) >= beta) continue;
      if (strength < 4) {
        const int tc0 = kTc0[ia][strength - 1];
        if (chroma) {
          const int tc = tc0 + 1;
          const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
          t[-step] = clip1(p0 + delta);
          t[0] = clip1(q0 - delta);
        } else {
          const int p2 = t[-3 * step], q2 = t[2 * step];
          const int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
          const int tc = tc0 + (ap < beta) + (aq < beta);
          const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
          t[-step] = clip1(p0 + delta);
          t[0] = clip1(q0 - delta);
          if (ap < beta) t[-2 * step] = (uint8_t)(p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1));
          if (aq < beta) t[step] = (uint8_t)(q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1));
        }
      } else if (chroma) {
        t[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
        t[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
      } else {
        const int p2 = t[-3 * step], q2 = t[2 * step], p3 = t[-4 * step], q3 = t[3 * step];
        const int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
        const bool small = std::abs(p0 - q0) < ((alpha >> 2) + 2);
        if (ap < beta && small) {
          t[-step] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
          t[-2 * step] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
          t[-3 * step] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
        } else {
          t[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
        }
        if (aq < beta && small) {
          t[0] = (uint8_t)((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
          t[step] = (uint8_t)((p0 + q0 + q1 + q2 + 2) >> 2);
          t[2 * step] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
        } else {
          t[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
        }
      }
    }
  }

  void deblock() {
    const int W = cur->w, CW = W / 2;
    for (int y = 0; y < mb_h; ++y)
      for (int x = 0; x < mb_w; ++x) {
        const MbInfo& q = mbs[(size_t)y * mb_w + x];
        const SliceParams& sp = slice_params[q.slice];
        if (sp.idc == 1) continue;
        for (int dir = 0; dir < 2; ++dir) {  // vertical edges, then horizontal
          const bool has_mb = dir ? y > 0 : x > 0;
          const MbInfo* pm = has_mb ? &mbs[(size_t)(y - dir) * mb_w + x - (1 - dir)] : nullptr;
          const bool mb_edge_on = pm && !(sp.idc == 2 && pm->slice != q.slice);
          // libavcodec's loop filter (its fast path, taken when both chroma QP offsets are equal) gives every
          // edge of an inter macroblock under the 8x8 transform whose 8x8 blocks 0-2 are coded bS 2 (4 next to
          // an intra one), coefficients or none: an 8x8 block CAVLC codes without any (no encoder writes one)
          const bool all2 = q.t8 && !q.intra() && (q.cbp & 7) == 7 && pps->chroma_qp_offset[0] == pps->chroma_qp_offset[1];
          tally[kDeblock8x8Coded] += all2;
          int bs_all[4][4];
          for (int e = 0; e < 4; ++e) {
            int* bs = bs_all[e];
            if ((e == 0 && !mb_edge_on) || (q.t8 && (e & 1))) {  // under the 8x8 transform, its edges only
              std::fill(bs, bs + 4, 0);
              continue;
            }
            const MbInfo& p = e ? q : *pm;
            for (int k = 0; k < 4; ++k) {
              const int qb = dir ? e * 4 + k : k * 4 + e;
              const int pb = dir ? (e ? qb - 4 : 12 + k) : (e ? qb - 1 : k * 4 + 3);
              bs[k] = all2 && !p.intra() ? 2 : bs_of(p, pb, q, qb, e == 0);
              if (bs[k]) tally[kBs1 + bs[k] - 1]++;
            }
            const int qp_av = (p.qp + q.qp + 1) >> 1;
            uint8_t* s = dir ? &cur->y[(size_t)(y * 16 + e * 4) * W + x * 16] : &cur->y[(size_t)(y * 16) * W + x * 16 + e * 4];
            filter_edge(s, dir ? W : 1, dir ? 1 : W, 16, bs, qp_av, sp, false);
          }
          for (int c = 0; c < 2; ++c) {
            uint8_t* plane = c ? cur->v.data() : cur->u.data();
            for (int e = 0; e < 2; ++e) {
              const int* bs = bs_all[2 * e];
              if (!bs[0] && !bs[1] && !bs[2] && !bs[3]) continue;
              const MbInfo& p = e ? q : *pm;
              const int qp_av = (p.qpc[c] + q.qpc[c] + 1) >> 1;
              uint8_t* s = dir ? plane + (size_t)(y * 8 + e * 4) * CW + x * 8 : plane + (size_t)(y * 8) * CW + x * 8 + e * 4;
              filter_edge(s, dir ? CW : 1, dir ? 1 : CW, 8, bs, qp_av, sp, true);
            }
          }
        }
      }
  }

  // ---- the end of a picture: deblocking, marking, output

  void finish_picture() {
    deblock();
    const SliceHeader& h = first_header;
    if (h.nal_ref_idc) {  // the motion later pictures' direct prediction reads
      cur->col.resize(mbs.size());
      for (size_t i = 0; i < mbs.size(); ++i) {
        ColMb& c = cur->col[i];
        c.intra = mbs[i].intra();
        std::memcpy(c.mv, mbs[i].mv, sizeof c.mv);
        std::memcpy(c.ref, mbs[i].ref, sizeof c.ref);
        std::memcpy(c.refpic, mbs[i].refpic, sizeof c.refpic);
      }
    }
    // h264_select_output_frame runs before the picture's own marking (its memory reset shows from the next on)
    cur->mmco_reset = pending_mmco_reset;
    pending_mmco_reset = false;
    select_output(cur);
    if (h.nal_ref_idc) mark(h);
    prev_frame_num = cur->frame_num;
    prev_frame_num_offset = frame_num_offset;
    if (prev_mmco5) {
      prev_frame_num = 0;
      prev_frame_num_offset = 0;
    }
    if (h.nal_ref_idc) {
      prev_ref_frame_num = prev_mmco5 ? 0 : cur->frame_num;
      if (prev_mmco5) {
        prev_poc_msb = 0;
        prev_poc_lsb = cur_top - std::min(cur_top, cur_bottom);
      } else if (sps->poc_type == 0) {
        prev_poc_msb = cur_msb;
        prev_poc_lsb = cur_lsb;
      }
    }
    prev_mmco5 = false;
    cur.reset();
    lists[0].clear();
    lists[1].clear();
  }

  void mark(const SliceHeader& h) {
    const int max_refs = std::max(sps->max_num_ref_frames, 1);
    if (h.idr) {
      if (h.long_term_reference) {
        tally[kIdrLongTerm]++;
        cur->long_ref = true;
        cur->long_term_idx = 0;
        max_long_term_idx = 0;
      } else {
        cur->short_ref = true;
        max_long_term_idx = -1;
      }
      refs.push_back(cur);
      return;
    }
    auto drop = [&](Picture* p) {
      p->short_ref = p->long_ref = false;
      refs.erase(std::remove_if(refs.begin(), refs.end(), [&](const PicPtr& r) { return r.get() == p; }), refs.end());
    };
    auto short_by_num = [&](int num) -> Picture* {
      for (auto& r : refs)
        if (r->short_ref && pic_num(*r) == num) return r.get();
      return nullptr;
    };
    auto long_by_idx = [&](int idx) -> Picture* {
      for (auto& r : refs)
        if (r->long_ref && r->long_term_idx == idx) return r.get();
      return nullptr;
    };
    const int curr_num = h.frame_num;
    if (h.adaptive) {
      for (const Mmco& mm : h.mmcos) {
        tally[kMmco1 + mm.op - 1]++;
        if (mm.op == 1 || mm.op == 3) {
          Picture* p = short_by_num(curr_num - (mm.a + 1));
          if (!p) fail("a memory management operation on a short-term picture the buffer does not hold");
          if (mm.op == 1) {
            drop(p);
          } else {
            if (mm.b > max_long_term_idx) fail("a long-term frame index above MaxLongTermFrameIdx (a corrupt stream)");
            if (Picture* o = long_by_idx(mm.b)) drop(o);
            p->short_ref = false;
            p->long_ref = true;
            p->long_term_idx = mm.b;
          }
        } else if (mm.op == 2) {
          Picture* p = long_by_idx(mm.a);
          if (!p) fail("a memory management operation on a long-term picture the buffer does not hold");
          drop(p);
        } else if (mm.op == 4) {
          max_long_term_idx = mm.a - 1;
          std::vector<Picture*> gone;
          for (auto& r : refs)
            if (r->long_ref && r->long_term_idx > max_long_term_idx) gone.push_back(r.get());
          for (Picture* p : gone) drop(p);
        } else if (mm.op == 5) {
          while (!refs.empty()) drop(refs.back().get());
          max_long_term_idx = -1;
          prev_mmco5 = true;
          pending_mmco_reset = true;
          cur->mmco_reset = true;
          cur->frame_num = 0;
          std::fill(last_pocs, last_pocs + 16, INT_MIN);
        } else {
          if (mm.b > max_long_term_idx) fail("a long-term frame index above MaxLongTermFrameIdx (a corrupt stream)");
          if (Picture* o = long_by_idx(mm.b)) drop(o);
          cur->long_ref = true;
          cur->long_term_idx = mm.b;
        }
      }
    } else {
      int shorts = 0;
      for (auto& r : refs) shorts += r->short_ref;
      if ((int)refs.size() >= max_refs && shorts) {
        Picture* oldest = nullptr;
        for (auto& r : refs)
          if (r->short_ref && (!oldest || pic_num(*r) < pic_num(*oldest))) oldest = r.get();
        drop(oldest);
        tally[kSlidingWindow]++;
      }
    }
    if (!cur->long_ref) cur->short_ref = true;
    refs.push_back(cur);
    if ((int)refs.size() > max_refs)
      fail("more reference frames (" + std::to_string(refs.size()) + ") than max_num_ref_frames (" +
           std::to_string(max_refs) + ")");
  }

  void select_output(const PicPtr& c) {
    if (sps->restriction) has_b_frames = std::max(has_b_frames, sps->num_reorder_frames);
    int i = 0;
    for (;; ++i) {
      if (i == 16 || c->poc < last_pocs[i]) {
        if (i) last_pocs[i - 1] = c->poc;
        break;
      } else if (i) {
        last_pocs[i - 1] = last_pocs[i];
      }
    }
    int out_of_order = 16 - i;
    if (c->type == 3 || (last_pocs[14] > INT_MIN && (int64_t)last_pocs[15] - last_pocs[14] > 2))
      out_of_order = std::max(out_of_order, 1);
    if (out_of_order == 16) {
      for (int k = 1; k < 16; ++k) last_pocs[k] = INT_MIN;
      last_pocs[0] = c->poc;
      c->mmco_reset = true;
    } else if (has_b_frames < out_of_order && !sps->restriction) {
      has_b_frames = out_of_order;
    }
    delayed.push_back(c);
    const int pics = (int)delayed.size();
    int out_idx = 0;
    for (int k = 1; k < pics && !delayed[k]->key && !delayed[k]->mmco_reset; ++k)
      if (delayed[k]->poc < delayed[out_idx]->poc) out_idx = k;
    PicPtr out = delayed[out_idx];
    if (has_b_frames == 0 && (delayed[0]->key || delayed[0]->mmco_reset)) next_outputed_poc = INT_MIN;
    const bool ooo = out->poc < next_outputed_poc;
    if (ooo || pics > has_b_frames) delayed.erase(delayed.begin() + out_idx);
    if (!ooo && pics > has_b_frames) {
      if (out_idx == 0 && !delayed.empty() && (delayed[0]->key || delayed[0]->mmco_reset))
        next_outputed_poc = INT_MIN;
      else
        next_outputed_poc = out->poc;
      out_queue.push_back(out);
    }
  }

  void flush() {
    if (cur) {
      if (mbs_done != mb_w * mb_h)
        fail("a picture with " + std::to_string(mb_w * mb_h - mbs_done) +
             " macroblocks missing at the end of the stream (libavcodec conceals them)");
      finish_picture();
    }
    while (!delayed.empty()) {
      int out_idx = 0;
      for (int k = 1; k < (int)delayed.size() && !delayed[k]->key && !delayed[k]->mmco_reset; ++k)
        if (delayed[k]->poc < delayed[out_idx]->poc) out_idx = k;
      out_queue.push_back(delayed[out_idx]);
      delayed.erase(delayed.begin() + out_idx);
    }
  }

  void configure(const uint8_t* d, int64_t n) {
    if (n >= 7 && d[0] == 1) {  // avcC
      length_size = (d[4] & 3) + 1;
      if (length_size == 3) fail("an avcC NAL length size of 3 bytes");
      int64_t p = 5;
      for (int list = 0; list < 2; ++list) {
        if (p >= n) fail("a truncated avcC");
        const int count = list ? d[p] : d[p] & 0x1F;
        ++p;
        for (int k = 0; k < count; ++k) {
          if (p + 2 > n) fail("a truncated avcC");
          const int len = d[p] << 8 | d[p + 1];
          p += 2;
          if (p + len > n || !len) fail("a truncated avcC");
          nal(d + p, len);
          p += len;
        }
      }
    } else {  // parameter sets with start codes
      annex_b(d, n);
    }
  }
};

void copy_error(const std::string& m, char* err, int errlen) {
  if (errlen > 0) {
    std::strncpy(err, m.c_str(), (size_t)errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// A decoder for a stream with `extradata` (an avcC record, parameter sets with start codes, or nothing: Annex B
// samples) in a container that gives its size as width x height (0 for none). NULL and err on failure.
void* mga_h264_new(const uint8_t* extradata, int64_t n, int32_t width, int32_t height, char* err, int32_t errlen) {
  Decoder* d = new Decoder();
  d->caller_w = width;
  d->caller_h = height;
  try {
    vlcs();
    d->configure(extradata, n);
  } catch (const Error& e) {
    copy_error(e.what, err, errlen);
    delete d;
    return nullptr;
  }
  return d;
}

void mga_h264_free(void* h) { delete static_cast<Decoder*>(h); }

// Decodes one sample (an access unit); 0, or -1 and err.
int32_t mga_h264_decode(void* h, const uint8_t* data, int64_t n, char* err, int32_t errlen) {
  Decoder* d = static_cast<Decoder*>(h);
  try {
    d->decode_chunk(data, n);
  } catch (const Error& e) {
    copy_error(e.what, err, errlen);
    d->cur.reset();
    return -1;
  } catch (const std::bad_alloc&) {
    copy_error("out of memory", err, errlen);
    return -1;
  }
  return 0;
}

int32_t mga_h264_flush(void* h, char* err, int32_t errlen) {
  Decoder* d = static_cast<Decoder*>(h);
  try {
    d->flush();
  } catch (const Error& e) {
    copy_error(e.what, err, errlen);
    d->cur.reset();
    return -1;
  }
  return 0;
}

// 1 and info (width, height, chroma width, chroma height, full range, picture type 1 I / 2 P / 3 B, key, chroma
// location: 0 unspecified, 1 left, 2 centre, 3 top-left, ... as libavcodec's AVChromaLocation) when a frame is
// ready, else 0.
int32_t mga_h264_peek(void* h, int32_t* info) {
  Decoder* d = static_cast<Decoder*>(h);
  if (d->out_queue.empty()) return 0;
  const Picture& p = *d->out_queue.front();
  info[0] = p.out_w;
  info[1] = p.out_h;
  info[2] = (p.out_w + 1) / 2;
  info[3] = (p.out_h + 1) / 2;
  info[4] = p.full_range;
  info[5] = p.type;
  info[6] = p.key;
  info[7] = p.chroma_loc;
  return 1;
}

// Copies the ready frame's planes (the sizes of mga_h264_peek) and lets it go.
void mga_h264_pop(void* h, uint8_t* y, uint8_t* u, uint8_t* v) {
  Decoder* d = static_cast<Decoder*>(h);
  const Picture& p = *d->out_queue.front();
  const int W = p.w, CW = p.w / 2, cw = (p.out_w + 1) / 2, ch = (p.out_h + 1) / 2;
  for (int r = 0; r < p.out_h; ++r) std::memcpy(y + (size_t)r * p.out_w, &p.y[(size_t)(p.out_y + r) * W + p.out_x], p.out_w);
  for (int r = 0; r < ch; ++r) {
    std::memcpy(u + (size_t)r * cw, &p.u[(size_t)(p.out_y / 2 + r) * CW + p.out_x / 2], cw);
    std::memcpy(v + (size_t)r * cw, &p.v[(size_t)(p.out_y / 2 + r) * CW + p.out_x / 2], cw);
  }
  d->out_queue.erase(d->out_queue.begin());
}

// The output rule's delay (has_b_frames): read, or set before the first sample as ffmpeg's stream probing sets it.
int32_t mga_h264_delay(void* h, int32_t set) {
  Decoder* d = static_cast<Decoder*>(h);
  if (set >= 0) d->has_b_frames = std::min(set, 16);
  return d->has_b_frames;
}

// The active SPS's num_reorder_frames as libavcodec keeps it (the VUI's, else the level's bound), -1 before one.
int32_t mga_h264_reorder_hint(void* h) {
  Decoder* d = static_cast<Decoder*>(h);
  return d->sps ? d->sps->reorder_hint : -1;
}

int32_t mga_h264_tally(void* h, int64_t* out, int32_t n) {
  Decoder* d = static_cast<Decoder*>(h);
  const int k = std::min<int>(n, kTallyCount);
  for (int i = 0; i < k; ++i) out[i] = d->tally[i];
  return kTallyCount;
}

}  // extern "C"
