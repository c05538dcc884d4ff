// H.264 video decoding (ITU-T H.264), the Constrained Baseline tools: CAVLC I
// and P slices of frame pictures, several slices a picture, every intra and
// inter macroblock type of those slices, multiple and long-term reference
// frames, reference picture list modification, adaptive marking (MMCO 1-6)
// and the deblocking filter. Streams of the Main and High profiles decode
// when they use only these tools. What a conforming decoder must do is fully
// specified, to the bit, so the reconstruction follows the standard's text
// (clauses 8.3-8.7); libavcodec, cv2's decoder, is conforming, and the
// fixtures hold the two equal to the bit.
//
// What the standard leaves to the decoder follows libavcodec's h264 decoder:
//  * Output order: h264_select_output_frame's rule. Each picture joins a
//    delay queue; the one of lowest POC (not looking past a key frame or a
//    memory reset) goes out when the queue holds more than has_b_frames
//    pictures. has_b_frames starts at the SPS's num_reorder_frames when the
//    VUI carries a bitstream restriction; without one it grows when a
//    picture's POC comes out of order or when the last two POCs are more
//    than 2 apart. A picture whose POC is below the last output one is
//    dropped. flush() empties the queue in the same order.
//  * Cropping: the frame comes out at the SPS's cropped size, or at the
//    container's when that is smaller within the same 16-sample alignment
//    and the SPS crops neither top nor left (h264's "container cropping"),
//    which can make it odd. A left crop that is not a multiple of 64 luma
//    samples is refused: libavutil's av_frame_apply_cropping lowers it to
//    keep the planes aligned, and cv2 then rescales the wider frame.
//  * What libavcodec conceals (a missing reference, a slice lost, a gap in
//    frame_num, a stream that starts without an IDR picture) is refused.
// What the port does not decode is refused by name: CABAC, B / SP / SI
// slices, field and MBAFF pictures, the 8x8 transform, scaling matrices,
// weighted prediction, FMO, ASO, redundant pictures, data partitioning,
// chroma formats other than 4:2:0 and bit depths above 8.
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
  kDeblockIdc0, kDeblockIdc1, kDeblockIdc2, kDeblockOffsets, kBs1, kBs2, kBs3, kBs4, kConstrainedIntra, kTallyCount
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

// ---------------------------------------------------------------- parameter sets

struct Sps {
  bool valid = false;
  int profile = 0;
  int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4, delta_pic_order_always_zero = 0;
  int offset_for_non_ref_pic = 0, offset_for_top_to_bottom_field = 0;
  std::vector<int> offset_for_ref_frame;
  int max_num_ref_frames = 0, gaps_allowed = 0, mb_w = 0, mb_h = 0;
  int crop_l = 0, crop_r = 0, crop_t = 0, crop_b = 0;  // luma samples
  bool full_range = false, restriction = false;
  int num_reorder_frames = 0;
};

struct Pps {
  bool valid = false;
  int sps_id = 0, bottom_field_poc = 0, num_ref_idx_default = 1, init_qp = 26, chroma_qp_offset[2] = {0, 0};
  int deblocking_control = 0, constrained_intra = 0;
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

struct Picture {
  int id = 0, w = 0, h = 0;
  std::vector<uint8_t> y, u, v;
  int poc = 0, frame_num = 0, long_term_idx = -1;
  bool short_ref = false, long_ref = false, key = false, mmco_reset = false, full_range = false;
  int type = 1;                     // 1 I, 2 P (the picture's last slice type)
  int out_x = 0, out_y = 0, out_w = 0, out_h = 0;  // the frame cv2 gives: origin and size in luma samples
  bool ref() const { return short_ref || long_ref; }
};
using PicPtr = std::shared_ptr<Picture>;

enum Kind : uint8_t { kI4, kI16, kPcm, kInter, kSkip };

struct MbInfo {
  int slice = -1;
  Kind kind = kSkip;
  int qp = 0;          // QPY for deblocking (0 for I_PCM)
  int qpc[2] = {0, 0};  // QPc of Cb and Cr for deblocking
  uint8_t nz[16];      // luma total_coeff, raster 4x4 blocks (x + 4 y)
  uint8_t nzc[2][4];   // chroma AC total_coeff, raster 2x2
  int8_t mode[16];     // Intra 4x4 prediction modes, raster
  int16_t mv[16][2];   // raster 4x4
  int8_t ref[4];       // ref_idx per 8x8, -1 intra
  int refpic[4];       // the referenced picture's id per 8x8, -1 intra
  bool intra() const { return kind == kI4 || kind == kI16 || kind == kPcm; }
};

struct SliceParams {
  int idc = 0, alpha = 0, beta = 0;
};

struct Mmco {
  int op, a, b;
};

struct SliceHeader {
  int first_mb = 0, type = 0, pps_id = 0, frame_num = 0, idr = 0, nal_ref_idc = 0;
  int poc_lsb = 0, delta_bottom = 0, delta0 = 0, delta1 = 0;
  int num_ref_idx = 1;
  std::vector<std::pair<int, int>> list_mods;
  bool long_term_reference = false, adaptive = false;
  std::vector<Mmco> mmcos;
  int qp = 26;
  SliceParams deblock;
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
  SliceHeader first_header;
  std::vector<MbInfo> mbs;
  std::vector<SliceParams> slice_params;
  int slice_num = -1, slice_type = 0;
  std::vector<Picture*> list0;
  int qp = 26;
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

  void parse_sps(Bits& b) {
    Sps s;
    s.profile = (int)b.u(8);
    b.u(8);  // constraint_set flags
    b.u(8);  // level_idc
    const int id = (int)b.ue_max(31, "seq_parameter_set_id");
    static const int high[] = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135};
    if (std::find(std::begin(high), std::end(high), s.profile) != std::end(high)) {
      const int chroma = (int)b.ue_max(3, "chroma_format_idc");
      if (chroma != 1) fail(std::string("chroma format ") + (chroma == 0 ? "4:0:0 (monochrome)" : chroma == 2 ? "4:2:2" : "4:4:4"));
      const int depth_y = (int)b.ue() + 8, depth_c = (int)b.ue() + 8;
      if (depth_y != 8 || depth_c != 8) fail("bit depth " + std::to_string(std::max(depth_y, depth_c)));
      if (b.flag()) fail("lossless coding (qpprime_y_zero_transform_bypass_flag)");
      if (b.flag()) fail("scaling matrices (seq_scaling_matrix_present_flag)");
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
    b.flag();  // direct_8x8_inference_flag
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
      if (b.flag()) {
        b.ue();
        b.ue();
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
    s.valid = true;
    sps_[id] = s;
  }

  void parse_pps(Bits& b) {
    Pps p;
    const int id = (int)b.ue_max(255, "pic_parameter_set_id");
    p.sps_id = (int)b.ue_max(31, "seq_parameter_set_id");
    if (!sps_[p.sps_id].valid) fail("a PPS of an SPS (" + std::to_string(p.sps_id) + ") the stream has not sent");
    if (b.flag()) fail("CABAC entropy coding (entropy_coding_mode_flag 1: the Main and High profiles)");
    p.bottom_field_poc = b.flag();
    if (b.ue()) fail("FMO (slice groups: num_slice_groups_minus1 above 0)");
    p.num_ref_idx_default = (int)b.ue_max(31, "num_ref_idx_l0_default_active_minus1") + 1;
    b.ue_max(31, "num_ref_idx_l1_default_active_minus1");
    if (b.flag()) fail("weighted prediction (weighted_pred_flag 1)");
    b.u(2);  // weighted_bipred_idc: B slices only
    p.init_qp = 26 + b.se();
    if (p.init_qp < 0 || p.init_qp > 51) fail("pic_init_qp " + std::to_string(p.init_qp) + " out of range");
    b.se();  // pic_init_qs: SP / SI slices only
    p.chroma_qp_offset[0] = p.chroma_qp_offset[1] = b.se();
    if (p.chroma_qp_offset[0] < -12 || p.chroma_qp_offset[0] > 12) fail("chroma_qp_index_offset out of range");
    p.deblocking_control = b.flag();
    p.constrained_intra = b.flag();
    if (b.flag()) fail("redundant pictures (redundant_pic_cnt_present_flag 1)");
    if (b.more_data()) {
      if (b.flag()) fail("the 8x8 transform (transform_8x8_mode_flag 1)");
      if (b.flag()) fail("scaling matrices (pic_scaling_matrix_present_flag)");
      p.chroma_qp_offset[1] = b.se();
      if (p.chroma_qp_offset[1] < -12 || p.chroma_qp_offset[1] > 12) fail("second_chroma_qp_index_offset out of range");
    }
    p.valid = true;
    pps_[id] = p;
  }

  // ---- slices

  SliceHeader parse_header(Bits& b, bool idr, int ref_idc) {
    SliceHeader h;
    h.idr = idr;
    h.nal_ref_idc = ref_idc;
    h.first_mb = (int)b.ue();
    const int st = (int)b.ue_max(9, "slice_type");
    h.type = st % 5;
    if (h.type == 1) fail("B slices (the Main and High profiles)");
    if (h.type == 3 || h.type == 4) fail("SP / SI slices (the Extended profile)");
    if (idr && h.type != 2) fail("an IDR picture with a P slice (a corrupt stream)");
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
    h.num_ref_idx = p.num_ref_idx_default;
    if (h.type == 0) {
      if (b.flag()) h.num_ref_idx = (int)b.ue() + 1;
      if (h.num_ref_idx > 16) fail("num_ref_idx_l0_active " + std::to_string(h.num_ref_idx) + " above 16");
      if (b.flag()) {
        for (;;) {
          const int idc = (int)b.ue();
          if (idc == 3) break;
          if (idc > 3) fail("modification_of_pic_nums_idc " + std::to_string(idc) + " (a corrupt stream)");
          if (h.list_mods.size() > 32) fail("a reference list modification longer than the list");
          h.list_mods.emplace_back(idc, (int)b.ue());
        }
      }
    }
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
    cur->type = std::max(cur->type, h.type == 0 ? 2 : 1);
    if (h.type == 0) build_list(h);
    qp = h.qp;
    slice_data(b);
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
    cur->full_range = s.full_range;
    cur->poc = compute_poc(h, s);
    mbs.assign((size_t)mb_w * mb_h, MbInfo());
    slice_params.clear();
    slice_num = -1;
    mbs_done = 0;
    cur->out_x = cl;
    cur->out_y = ct;
    cur->out_w = w;
    cur->out_h = hh;
    tally[kCropped] += s.crop_l || s.crop_r || s.crop_t || s.crop_b;
    tally[kFullRange] += s.full_range;
    tally[s.profile == 66 ? kProfile66 : s.profile == 77 ? kProfile77 : kProfile100] +=
        s.profile == 66 || s.profile == 77 || s.profile == 100;
    tally[kPocType0 + s.poc_type]++;
    tally[kConstrainedIntra] += p.constrained_intra;
    tally[h.idr ? kPicturesIdr : h.type == 2 ? kPicturesI : kPicturesP]++;
    tally[kPicturesNonRef] += h.nal_ref_idc == 0;
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

  void build_list(const SliceHeader& h) {
    std::vector<Picture*> st, lt;
    for (auto& r : refs) (r->long_ref ? lt : st).push_back(r.get());
    std::sort(st.begin(), st.end(), [&](Picture* a, Picture* b) { return pic_num(*a) > pic_num(*b); });
    std::sort(lt.begin(), lt.end(), [](Picture* a, Picture* b) { return a->long_term_idx < b->long_term_idx; });
    std::vector<Picture*> list(st);
    list.insert(list.end(), lt.begin(), lt.end());
    const int n = h.num_ref_idx;
    list.resize(n + 1, nullptr);
    if (!h.list_mods.empty()) {
      const int max_frame_num = 1 << sps->log2_max_frame_num, curr = first_header.frame_num;
      int pred = curr, idx = 0;
      for (auto [idc, v] : h.list_mods) {
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
    list0 = list;
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

  static int dequant(int level, int qp, int raster) {
    const int x = raster & 3, y = raster >> 2;
    const int cls = !(x & 1) && !(y & 1) ? 0 : (x & 1) && (y & 1) ? 1 : 2;
    return level * kDequant[qp % 6][cls] * (1 << (qp / 6));
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
    // p[x, -1] for x = -1..7 and p[-1, y] for y = -1..3
    auto P = [&](int x, int y) { return y < 0 ? (x < 0 ? X : T[x]) : (x < 0 ? (y < 0 ? X : L[y]) : 0); };
    int pred[16];
    for (int y = 0; y < 4 && mode != 2; ++y)
      for (int x = 0; x < 4; ++x) {
        int v = 0;
        switch (mode) {
          case 0:
            v = T[x];
            break;
          case 1:
            v = L[y];
            break;
          case 2:
            break;
          case 3:
            v = x == 3 && y == 3 ? (T[6] + 3 * T[7] + 2) >> 2 : (T[x + y] + 2 * T[x + y + 1] + T[x + y + 2] + 2) >> 2;
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
              v = (P(-1, y - 1) + 2 * P(-1, y - 2) + P(-1, y - 3) + 2) >> 2;
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
              v = (P(x - 1, -1) + 2 * P(x - 2, -1) + P(x - 3, -1) + 2) >> 2;
            break;
          }
          case 7:
            v = y & 1 ? (T[x + (y >> 1)] + 2 * T[x + (y >> 1) + 1] + T[x + (y >> 1) + 2] + 2) >> 2
                      : (T[x + (y >> 1)] + T[x + (y >> 1) + 1] + 1) >> 1;
            break;
          case 8: {
            const int z = x + 2 * y;
            if (z > 5)
              v = L[3];
            else if (z == 5)
              v = (L[2] + 3 * L[3] + 2) >> 2;
            else if (z & 1)
              v = (L[y + (x >> 1)] + 2 * L[y + (x >> 1) + 1] + L[y + (x >> 1) + 2] + 2) >> 2;
            else
              v = (L[y + (x >> 1)] + L[y + (x >> 1) + 1] + 1) >> 1;
            break;
          }
        }
        pred[y * 4 + x] = v;
      }
    if (mode == 2) {
      int s = 0;
      if (top && left) {
        for (int i = 0; i < 4; ++i) s += T[i] + L[i];
        s = (s + 4) >> 3;
      } else if (left) {
        for (int i = 0; i < 4; ++i) s += L[i];
        s = (s + 2) >> 2;
      } else if (top) {
        for (int i = 0; i < 4; ++i) s += T[i];
        s = (s + 2) >> 2;
      } else {
        s = 128;
      }
      for (int& p : pred) p = s;
    }
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x) o[y * W + x] = (uint8_t)pred[y * 4 + x];
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
  bool neighbour(int x4, int y4, int& ref, int mv[2]) const {
    ref = -1;
    mv[0] = mv[1] = 0;
    if (x4 >= 0 && x4 < 4 && y4 >= 0 && y4 < 4) {
      if (!done[y4 * 4 + x4]) return false;
      ref = m->ref[(y4 >> 1) * 2 + (x4 >> 1)];
      mv[0] = m->mv[y4 * 4 + x4][0];
      mv[1] = m->mv[y4 * 4 + x4][1];
      return true;
    }
    if (y4 >= 4 || (x4 >= 4 && y4 >= 0)) return false;
    const MbInfo* n = mb_at(mbx + (x4 < 0 ? -1 : x4 >= 4 ? 1 : 0), mby + (y4 < 0 ? -1 : 0));
    if (!n) return false;
    if (n->intra()) return true;
    const int lx = (x4 + 4) & 3, ly = (y4 + 4) & 3;
    ref = n->ref[(ly >> 1) * 2 + (lx >> 1)];
    mv[0] = n->mv[ly * 4 + lx][0];
    mv[1] = n->mv[ly * 4 + lx][1];
    return true;
  }

  static int median(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

  // shape: 0 any, 1 a 16x8 partition, 2 an 8x16 partition; part: its index. Returns the rule taken:
  // kMvMedian, kMv16x8 or kMv8x16.
  int predict_mv(int x4, int y4, int w4, int ref, int shape, int part, int out[2]) const {
    int ra, rb, rc, a[2], b[2], c[2];
    const bool av_a = neighbour(x4 - 1, y4, ra, a);
    const bool av_b = neighbour(x4, y4 - 1, rb, b);
    bool av_c = neighbour(x4 + w4, y4 - 1, rc, c);
    if (!av_c) av_c = neighbour(x4 - 1, y4 - 1, rc, c);
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

  void set_motion(int x4, int y4, int w4, int h4, int ref, const int mv[2]) {
    for (int y = y4; y < y4 + h4; ++y)
      for (int x = x4; x < x4 + w4; ++x) {
        m->mv[y * 4 + x][0] = (int16_t)mv[0];
        m->mv[y * 4 + x][1] = (int16_t)mv[1];
        m->ref[(y >> 1) * 2 + (x >> 1)] = (int8_t)ref;
        m->refpic[(y >> 1) * 2 + (x >> 1)] = list0[ref]->id;
        done[y * 4 + x] = true;
      }
  }

  // ---- motion compensation

  void mc(int x4, int y4, int w4, int h4) {
    const int ref = m->ref[(y4 >> 1) * 2 + (x4 >> 1)];
    const Picture& r = *list0[ref];
    const int mvx = m->mv[y4 * 4 + x4][0], mvy = m->mv[y4 * 4 + x4][1];
    const int W = cur->w, H = cur->h, bw = w4 * 4, bh = h4 * 4;
    const int x0 = mbx * 16 + x4 * 4, y0 = mby * 16 + y4 * 4;
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
    uint8_t* o = &cur->y[(size_t)y0 * W + x0];
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
        o[y * W + x] = (uint8_t)v;
      }
    // chroma: eighth-sample bilinear
    const int CW = W / 2, CH = H / 2, cbw = bw / 2, cbh = bh / 2;
    const int cx = x0 / 2 + (mvx >> 3), cy = y0 / 2 + (mvy >> 3), ax = mvx & 7, ay = mvy & 7;
    tally[kChromaFraction] += ax || ay;
    for (int c = 0; c < 2; ++c) {
      const std::vector<uint8_t>& src = c ? r.v : r.u;
      uint8_t* q = (c ? cur->v.data() : cur->u.data()) + (size_t)(y0 / 2) * CW + x0 / 2;
      for (int y = 0; y < cbh; ++y) {
        const uint8_t* r0 = &src[(size_t)clip3(0, CH - 1, cy + y) * CW];
        const uint8_t* r1 = &src[(size_t)clip3(0, CH - 1, cy + y + 1) * CW];
        for (int x = 0; x < cbw; ++x) {
          const int xa = clip3(0, CW - 1, cx + x), xb = clip3(0, CW - 1, cx + x + 1);
          q[y * CW + x] = (uint8_t)(((8 - ax) * (8 - ay) * r0[xa] + ax * (8 - ay) * r0[xb] + (8 - ax) * ay * r1[xa] +
                                     ax * ay * r1[xb] + 32) >> 6);
        }
      }
    }
  }

  // ---- macroblocks

  int chroma_qp(int c, int q) const { return kChromaQp[clip3(0, 51, q + pps->chroma_qp_offset[c])]; }

  void slice_data(Bits& b) {
    int addr = mbs_done;
    bool more = true;
    while (more) {
      if (slice_type == 0) {
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

  void begin_mb(int addr) {
    mbx = addr % mb_w;
    mby = addr / mb_w;
    m = &mbs[addr];
    m->slice = slice_num;
    std::memset(m->nz, 0, sizeof m->nz);
    std::memset(m->nzc, 0, sizeof m->nzc);
    std::memset(m->mode, -1, sizeof m->mode);
    std::memset(m->mv, 0, sizeof m->mv);
    std::memset(m->ref, -1, sizeof m->ref);
    for (int& r : m->refpic) r = -1;
    std::memset(done, 0, sizeof done);
  }

  void set_qps(int q) {
    m->qp = q;
    m->qpc[0] = chroma_qp(0, q);
    m->qpc[1] = chroma_qp(1, q);
  }

  void skip_mb() {
    tally[kMbSkip]++;
    m->kind = kSkip;
    int mv[2] = {0, 0}, ra, rb, a[2], bb[2];
    const bool av_a = neighbour(-1, 0, ra, a), av_b = neighbour(0, -1, rb, bb);
    if (!av_a || !av_b || (ra == 0 && !a[0] && !a[1]) || (rb == 0 && !bb[0] && !bb[1])) {
      tally[kSkipZero]++;
    } else {
      predict_mv(0, 0, 4, 0, 0, 0, mv);
      tally[kSkipPredicted]++;
    }
    set_motion(0, 0, 4, 4, 0, mv);
    mc(0, 0, 4, 4);
    set_qps(qp);
  }

  void macroblock(Bits& b) {
    int mb_type = (int)b.ue();
    if (slice_type == 0) {
      if (mb_type < 5) {
        inter_mb(b, mb_type);
        return;
      }
      mb_type -= 5;
      tally[kMbIntraInP]++;
    }
    if (mb_type > 25) fail("mb_type " + std::to_string(mb_type) + " out of range (a corrupt stream)");
    if (mb_type == 25) {
      pcm_mb(b);
      return;
    }
    const bool i16 = mb_type > 0;
    m->kind = i16 ? kI16 : kI4;
    int modes[16] = {};
    if (!i16) {
      tally[kMbI4x4]++;
      static const int order[16][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}, {2, 0}, {3, 0}, {2, 1}, {3, 1},
                                       {0, 2}, {1, 2}, {0, 3}, {1, 3}, {2, 2}, {3, 2}, {2, 3}, {3, 3}};
      for (int k = 0; k < 16; ++k) {
        const int bx = order[k][0], by = order[k][1];
        const int pred = predicted_mode(bx, by);
        int mode = pred;
        if (!b.flag()) {
          const int rem = (int)b.u(3);
          mode = rem < pred ? rem : rem + 1;
        }
        m->mode[by * 4 + bx] = (int8_t)mode;
        modes[k] = mode;
        tally[kI4x4Mode0 + mode]++;
      }
    } else {
      tally[kMbI16x16]++;
    }
    const int chroma_mode = (int)b.ue_max(3, "intra_chroma_pred_mode");
    tally[kChromaMode0 + chroma_mode]++;
    int cbp;
    if (i16) {
      const int t = mb_type - 1;
      cbp = ((t / 4) % 3) << 4 | (t >= 12 ? 15 : 0);
      tally[kI16x16Mode0 + t % 4]++;
      tally[kI16x16Chroma0 + (t / 4) % 3]++;
      tally[kI16x16Ac] += t >= 12;
    } else {
      cbp = kIntraCbp[b.ue_max(47, "coded_block_pattern")];
    }
    if (cbp || i16) read_qp_delta(b);
    set_qps(qp);
    int coef[16][16] = {}, dc[16] = {};
    int chroma[2][4][16] = {}, cdc[2][4] = {};
    residual(b, cbp, i16, coef, dc, chroma, cdc);
    // reconstruction
    const int W = cur->w;
    if (i16) {
      static const int map[4] = {2, 1, 0, 3};  // luma's V, H, DC, plane in chroma's numbering
      intra_block(cur->y.data(), W, mbx * 16, mby * 16, 16, map[(mb_type - 1) % 4], false);
      luma_dc(dc);
      for (int k = 0; k < 16; ++k) coef[k][0] = dc[k];
      for (int by = 0; by < 4; ++by)
        for (int bx = 0; bx < 4; ++bx)
          idct_add(coef[by * 4 + bx], &cur->y[(size_t)(mby * 16 + by * 4) * W + mbx * 16 + bx * 4], W);
    } else {
      static const int order[16][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}, {2, 0}, {3, 0}, {2, 1}, {3, 1},
                                       {0, 2}, {1, 2}, {0, 3}, {1, 3}, {2, 2}, {3, 2}, {2, 3}, {3, 3}};
      for (int k = 0; k < 16; ++k) {
        const int bx = order[k][0], by = order[k][1];
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
      return n->kind == kI4 ? (int)n->mode[((y4 + 4) & 3) * 4 + ((x4 + 4) & 3)] : 2;
    };
    bool dc = false;
    const int a = mode_of(bx - 1, by, dc), b = mode_of(bx, by - 1, dc);
    return dc ? 2 : std::min(a, b);
  }

  void read_qp_delta(Bits& b) {
    const int d = b.se();
    if (d < -26 || d > 25) fail("mb_qp_delta " + std::to_string(d) + " out of range (a corrupt stream)");
    tally[kQpDelta] += d != 0;
    qp = (qp + d + 52) % 52;
  }

  void pcm_mb(Bits& b) {
    tally[kMbPcm]++;
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
    set_qps(0);  // the deblocking filter takes an I_PCM macroblock's QP as 0; the QP prediction goes on unchanged
  }

  void inter_mb(Bits& b, int mb_type) {
    m->kind = kInter;
    const int n_ref = (int)list0.size();
    auto read_ref = [&]() {
      if (n_ref == 1) return 0;
      const int r = n_ref == 2 ? !b.flag() : (int)b.ue();
      if (r >= n_ref) fail("ref_idx " + std::to_string(r) + " past the list of " + std::to_string(n_ref));
      tally[kRefIdxNonZero] += r > 0;
      tally[kLongTermRefs] += list0[r]->long_ref;
      return r;
    };
    auto read_mvd = [&](int mvd[2]) {
      mvd[0] = b.se();
      mvd[1] = b.se();
    };
    if (mb_type < 3) {
      static const int shapes[3][2][4] = {{{0, 0, 4, 4}}, {{0, 0, 4, 2}, {0, 2, 4, 2}}, {{0, 0, 2, 4}, {2, 0, 2, 4}}};
      const int parts = mb_type ? 2 : 1;
      tally[kMbP16x16 + mb_type]++;
      int refs_[2], mvd[2][2];
      for (int p = 0; p < parts; ++p) refs_[p] = read_ref();
      for (int p = 0; p < parts; ++p) read_mvd(mvd[p]);
      for (int p = 0; p < parts; ++p) {
        const int* s = shapes[mb_type][p];
        int mv[2];
        tally[predict_mv(s[0], s[1], s[2], refs_[p], mb_type, p, mv)]++;
        mv[0] += mvd[p][0];
        mv[1] += mvd[p][1];
        set_motion(s[0], s[1], s[2], s[3], refs_[p], mv);
      }
      for (int p = 0; p < parts; ++p) mc(shapes[mb_type][p][0], shapes[mb_type][p][1], shapes[mb_type][p][2],
                                         shapes[mb_type][p][3]);
    } else {
      const bool ref0 = mb_type == 4;
      tally[ref0 ? kMbP8x8Ref0 : kMbP8x8]++;
      int sub[4], refs_[4] = {0, 0, 0, 0};
      for (int k = 0; k < 4; ++k) {
        sub[k] = (int)b.ue_max(3, "sub_mb_type");
        tally[kSub8x8 + sub[k]]++;
      }
      if (!ref0)
        for (int k = 0; k < 4; ++k) refs_[k] = read_ref();
      static const int sizes[4][2] = {{2, 2}, {2, 1}, {1, 2}, {1, 1}};  // sub-partition width, height in 4x4 blocks
      int mvd[4][4][2];
      for (int k = 0; k < 4; ++k) {
        const int n = 4 / (sizes[sub[k]][0] * sizes[sub[k]][1]);
        for (int s = 0; s < n; ++s) read_mvd(mvd[k][s]);
      }
      for (int k = 0; k < 4; ++k) {
        const int w = sizes[sub[k]][0], h = sizes[sub[k]][1], n = 4 / (w * h);
        for (int s = 0; s < n; ++s) {
          const int x4 = (k & 1) * 2 + (w == 1 ? s & 1 : 0), y4 = (k >> 1) * 2 + (h == 1 ? (w == 1 ? s >> 1 : s) : 0);
          int mv[2];
          tally[predict_mv(x4, y4, w, refs_[k], 0, 0, mv)]++;
          mv[0] += mvd[k][s][0];
          mv[1] += mvd[k][s][1];
          set_motion(x4, y4, w, h, refs_[k], mv);
        }
      }
      for (int k = 0; k < 4; ++k) {
        const int w = sizes[sub[k]][0], h = sizes[sub[k]][1], n = 4 / (w * h);
        for (int s = 0; s < n; ++s)
          mc((k & 1) * 2 + (w == 1 ? s & 1 : 0), (k >> 1) * 2 + (h == 1 ? (w == 1 ? s >> 1 : s) : 0), w, h);
      }
    }
    const int cbp = kInterCbp[b.ue_max(47, "coded_block_pattern")];
    if (cbp) read_qp_delta(b);
    set_qps(qp);
    int coef[16][16] = {}, dc[16] = {};
    int chroma[2][4][16] = {}, cdc[2][4] = {};
    residual(b, cbp, false, coef, dc, chroma, cdc);
    const int W = cur->w;
    for (int by = 0; by < 4; ++by)
      for (int bx = 0; bx < 4; ++bx)
        if (cbp >> ((by >> 1) * 2 + (bx >> 1)) & 1)
          idct_add(coef[by * 4 + bx], &cur->y[(size_t)(mby * 16 + by * 4) * W + mbx * 16 + bx * 4], W);
    add_chroma(chroma, cdc);
  }

  // Reads the macroblock's residual: coef by raster 4x4 block (dequantised, raster positions; an Intra 16x16
  // block's DC left for luma_dc), dc the Intra 16x16 DC levels (raster), chroma AC and DC levels.
  void residual(Bits& b, int cbp, bool i16, int coef[16][16], int dc[16], int chroma[2][4][16], int cdc[2][4]) {
    static const int order[16][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}, {2, 0}, {3, 0}, {2, 1}, {3, 1},
                                     {0, 2}, {1, 2}, {0, 3}, {1, 3}, {2, 2}, {3, 2}, {2, 3}, {3, 3}};
    int lv[16];
    if (i16) {
      tally[kLumaDc]++;
      residual_block(b, nc_of(luma_nz(-1, 0), luma_nz(0, -1)), 16, lv);
      for (int k = 0; k < 16; ++k) dc[kZigzag[k]] = lv[k];
    }
    for (int k = 0; k < 16; ++k) {
      const int bx = order[k][0], by = order[k][1];
      if (!(cbp >> (k / 4) & 1)) continue;
      const int nc = nc_of(luma_nz(bx - 1, by), luma_nz(bx, by - 1));
      const int start = i16 ? 1 : 0;
      const int total = residual_block(b, nc, 16 - start, lv);
      m->nz[by * 4 + bx] = (uint8_t)total;
      int* c = coef[by * 4 + bx];
      for (int i = 0; i < 16 - start; ++i)
        if (lv[i]) c[kZigzag[i + start]] = dequant(lv[i], m->qp, kZigzag[i + start]);
    }
    const int cc = cbp >> 4;
    if (cc) {
      for (int c = 0; c < 2; ++c) {
        tally[kChromaDc]++;
        residual_block(b, -1, 4, cdc[c]);
      }
    }
    if (cc & 2) {
      for (int c = 0; c < 2; ++c)
        for (int k = 0; k < 4; ++k) {
          tally[kChromaAc]++;
          const int bx = k & 1, by = k >> 1;
          const int total = residual_block(b, nc_of(chroma_nz(c, bx - 1, by), chroma_nz(c, bx, by - 1)), 15, lv);
          m->nzc[c][k] = (uint8_t)total;
          for (int i = 0; i < 15; ++i)
            if (lv[i]) chroma[c][k][kZigzag[i + 1]] = dequant(lv[i], m->qpc[c], kZigzag[i + 1]);
        }
    }
    if (cc > 2) fail("coded_block_pattern chroma 3 (a corrupt stream)");
  }

  // the Intra 16x16 DC: inverse Hadamard and dequantisation, in place (raster)
  void luma_dc(int c[16]) const {
    int t[16];
    for (int i = 0; i < 4; ++i) {
      const int* r = c + 4 * i;
      t[4 * i] = r[0] + r[1] + r[2] + r[3];
      t[4 * i + 1] = r[0] + r[1] - r[2] - r[3];
      t[4 * i + 2] = r[0] - r[1] - r[2] + r[3];
      t[4 * i + 3] = r[0] - r[1] + r[2] - r[3];
    }
    const int q = m->qp, scale = 16 * kDequant[q % 6][0];
    for (int j = 0; j < 4; ++j) {
      const int f[4] = {t[j] + t[4 + j] + t[8 + j] + t[12 + j], t[j] + t[4 + j] - t[8 + j] - t[12 + j],
                        t[j] - t[4 + j] - t[8 + j] + t[12 + j], t[j] - t[4 + j] + t[8 + j] - t[12 + j]};
      for (int i = 0; i < 4; ++i)
        c[4 * i + j] = q >= 36 ? f[i] * scale * (1 << (q / 6 - 6)) : (f[i] * scale + (1 << (5 - q / 6))) >> (6 - q / 6);
    }
  }

  void add_chroma(int chroma[2][4][16], int cdc[2][4]) {
    const int CW = cur->w / 2;
    for (int c = 0; c < 2; ++c) {
      const int* d = cdc[c];
      const int f[4] = {d[0] + d[1] + d[2] + d[3], d[0] - d[1] + d[2] - d[3], d[0] + d[1] - d[2] - d[3],
                        d[0] - d[1] - d[2] + d[3]};
      const int q = m->qpc[c];
      for (int k = 0; k < 4; ++k) {
        chroma[c][k][0] = (f[k] * 16 * kDequant[q % 6][0] * (1 << (q / 6))) >> 5;
        uint8_t* o = (c ? cur->v.data() : cur->u.data()) + (size_t)(mby * 8 + (k >> 1) * 4) * CW + mbx * 8 + (k & 1) * 4;
        idct_add(chroma[c][k], o, CW);
      }
    }
  }

  // ---- the deblocking filter (8.7)

  int bs_of(const MbInfo& p, int pb, const MbInfo& q, int qb, bool mb_edge) {
    if (p.intra() || q.intra()) return mb_edge ? 4 : 3;
    if (p.nz[pb] || q.nz[qb]) return 2;
    const int pr = p.refpic[(pb >> 3) * 2 + ((pb & 3) >> 1)], qr = q.refpic[(qb >> 3) * 2 + ((qb & 3) >> 1)];
    if (pr != qr || std::abs(p.mv[pb][0] - q.mv[qb][0]) >= 4 || std::abs(p.mv[pb][1] - q.mv[qb][1]) >= 4) return 1;
    return 0;
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
          int bs_all[4][4];
          for (int e = 0; e < 4; ++e) {
            int* bs = bs_all[e];
            if (e == 0 && !mb_edge_on) {
              std::fill(bs, bs + 4, 0);
              continue;
            }
            const MbInfo& p = e ? q : *pm;
            for (int k = 0; k < 4; ++k) {
              const int qb = dir ? e * 4 + k : k * 4 + e;
              const int pb = dir ? (e ? qb - 4 : 12 + k) : (e ? qb - 1 : k * 4 + 3);
              bs[k] = bs_of(p, pb, q, qb, e == 0);
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
    list0.clear();
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
    if (last_pocs[14] > INT_MIN && (int64_t)last_pocs[15] - last_pocs[14] > 2) out_of_order = std::max(out_of_order, 1);
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

// 1 and info (width, height, chroma width, chroma height, full range, picture type 1 I / 2 P, key) when a frame
// is ready, else 0.
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

int32_t mga_h264_tally(void* h, int64_t* out, int32_t n) {
  Decoder* d = static_cast<Decoder*>(h);
  const int k = std::min<int>(n, kTallyCount);
  for (int i = 0; i < k; ++i) out[i] = d->tally[i];
  return kTallyCount;
}

}  // extern "C"
