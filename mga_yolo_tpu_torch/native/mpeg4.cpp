// MPEG-4 Part 2 (ISO/IEC 14496-2) Simple and Advanced Simple profile video
// on the host: the decoder computes what ffmpeg's mpeg4 decoder computes (the
// mp4v / XviD / DivX / FMP4 streams cv2 reads), and the encoder writes I-VOPs
// that ffmpeg decodes.
//
// Decoder: video object layer headers from the stream or from the
// container's decoder configuration (esds), I-, P- and B-VOPs, intra DC and
// AC prediction (ac_pred_flag, alternate scans), the intra and inter
// coefficient tables with all three escape modes, H.263 or MPEG
// quantisation (quant_type 1: the default or loaded matrices, mismatch
// control), dquant and dbquant, intra_dc_vlc_thr, median motion-vector
// prediction, half- and quarter-sample motion compensation (the 8-tap filter
// mirrored at the block's edges) with vop_rounding_type, 4MV, unrestricted
// vectors with ffmpeg's edge emulation, not-coded macroblocks, B-VOP direct
// (TRB / TRD over the co-located vectors), forward, backward and
// interpolated macroblocks, interlacing (field DCT, field motion vectors in
// P- and B-VOPs, field direct mode, the alternate vertical scan), data
// partitioning, resync markers with video packets, vop_coded = 0 (no frame:
// ffmpeg outputs none, so cv2 reads on) and DivX's packed bitstream (a chunk
// of a P- and a B-VOP, then a placeholder N-VOP chunk). Frames come out in
// display order as ffmpeg gives them: one chunk late in a stream with
// B-VOPs, the last at flush. Who wrote the stream (user data "XviD<build>",
// "DivX<v>b<build>", "Lavc<v>", or the container's fourcc for an unmarked
// one) picks, as in ffmpeg, the inverse DCT (ffmpeg's "simple" one, or the
// XviD IDCT) and the workarounds of old encoders' bugs (edge, DC clip,
// quarter-sample chroma, half-sample field chroma).
//
// Refused by name: GMC and sprites (S-VOPs), RVLC, non-rectangular shapes,
// not_8_bit, OBMC, NEWPRED, reduced-resolution VOPs, scalability,
// complexity estimation headers, a packed chunk of three VOPs, and any
// truncated or corrupt stream (no concealment: nothing is padded with grey).
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

#include "h263.h"
#include "simple_idct.h"
#include "xvid_idct.h"

namespace {

using namespace h263;

// ------------------------------------------------------------------ tables
// MPEG-4's own codes (the ones it shares with msmpeg4.cpp are in h263.h).

// MCBPC of an I-VOP: cbpc 0-3 of Intra, of IntraQ, then stuffing.
constexpr Code kMcbpcI[9] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4}, {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// MCBPC of a P-VOP: cbpc 0-3 of Inter, Intra, InterQ, IntraQ, Inter4V, then stuffing.
constexpr Code kMcbpcP[21] = {{1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8}, {3, 7}, {3, 3}, {7, 7}, {6, 7},
                              {5, 9}, {4, 6}, {4, 9}, {3, 9}, {2, 9}, {2, 3}, {5, 7}, {4, 7}, {5, 8}, {1, 9}};
enum { kInter = 0, kIntra = 1, kInterQ = 2, kIntraQ = 3, kInter4V = 4 };
constexpr int kDquant[4] = {-1, -2, 1, 2};
// B-VOP macroblock types: direct '1', interpolated '01', backward '001', forward '0001'.
constexpr Code kMbTypeB[4] = {{1, 1}, {1, 2}, {1, 3}, {1, 4}};
// quant_type 1's default matrices (raster order)
constexpr int kDefaultIntra[64] = {8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28,
                                   20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32,
                                   22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
                                   25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
constexpr int kDefaultInter[64] = {16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24,
                                   18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27,
                                   20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
                                   22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};
constexpr size_t kMaxNvopSize = 19;  // ffmpeg's bound on a placeholder (N-VOP) chunk
constexpr int64_t kTimeLimit = 1 << 30;  // VOP time differences past it: out of order (no valid stream has them)

constexpr int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};  // intra_dc_vlc_thr -> QP below which DC has its VLC

inline int y_dc_scale(int q) { return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16; }
inline int c_dc_scale(int q) { return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6; }

// The encoder's bits, high bit first.
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

// What a B-VOP's direct mode and skip rule read of the reference after it.
enum : uint8_t { kMbIntra = 1, kMbSkip = 2, kMb16 = 4, kMb8x8 = 8, kMbField = 16 };

struct Pic {
  Plane p[3];
  int type = 0;                // 0 I, 1 P, 2 B
  std::vector<uint8_t> mbtype;  // kMb* per macroblock
  std::vector<int16_t> mv;      // luma blocks' vectors (x, y), as ffmpeg's motion_val
  std::vector<int16_t> fmv;     // per macroblock, the two field vectors (x, y) of a field-predicted one
  std::vector<uint8_t> fsel;    // per macroblock, the two fields' field_select
};

// The features decoded, counted (MPEG4_TALLY in native/__init__.py, in this order).
enum Tally {
  kVopsI, kVopsP, kVopsB, kVopsUncoded, kBDropped, kBSkippedTimes, kMbIntraT, kMbInterT, kMb4vT, kMbNotCoded,
  kMbFieldMv, kMbFieldDct, kBDirect, kBDirectSkip, kBForward, kBBackward, kBInterpolated, kBColocatedSkip,
  kBDirect8x8, kBDirectField, kQpelVops, kMpegQuantVops, kLoadedIntra, kLoadedInter, kPartitionedVops,
  kVideoPackets, kAltScanVops, kInterlacedVops, kPackedStored, kPackedDecoded, kNvopsSkipped, kXvidIdctVops,
  kEdgeBugVops, kDcClipBugVops, kQpelChromaBugVops, kMismatchToggles, kEscapes3, kFlushed,
  kTallyN
};

// The encoder's identity as ffmpeg's MPEG-4 decoder reads it (user data and
// the container's fourcc), and the bug workarounds that follow from it.
enum : unsigned {
  kBugEdge = 1, kBugDcClip = 2, kBugQpelChroma = 4, kBugQpelChroma2 = 8, kBugHpelChroma = 32, kBugStdQpel = 64, kBugXvidIlace = 128, kBugIedge = 256
};

// ------------------------------------------------------------------ decoder

struct Decoder {
  // video object layer
  bool have_vol = false;
  int width = 0, height = 0, mbw = 0, mbh = 0, time_bits = 1, mb_num_bits = 1, time_res = 1;
  int vo_type = 0;
  bool vol_control = false, resync = false, progressive = true, quarter_sample = false, mpeg_quant = false;
  bool partitioning = false, low_delay = false;
  int intra_matrix[64], inter_matrix[64];  // raster order
  // who wrote the stream
  uint32_t fourcc = 0;
  int xvid_build = -1, divx_version = -1, divx_build = -1, lavc_build = -1;
  bool divx_packed = false, xvid_idct = false;
  unsigned bugs = 0;
  // time
  int64_t time_base = 0, last_time_base = 0, time = 0, last_non_b_time = 0;
  int pp_time = 0, pb_time = 0, pp_field_time = 0, pb_field_time = 0, t_frame = 0;
  int picture_number = 0;
  // frames: last (the older reference), next (the newer), cur (being decoded)
  Pic pics[3];
  int last = -1, next = -1, cur = 0, out = -1, out_type = 0;
  bool skipped_last = false;
  std::vector<uint8_t> packed;  // a packed chunk's stored VOP
  // the VOP being decoded
  int type = 0, qscale = 1, fcode = 1, bcode = 1, rounding = 0, dc_thr = 99, h_edge = 0, v_edge = 0;
  bool alternate_scan = false, top_field_first = false;
  // per macroblock and block state of the VOP being decoded
  std::vector<int> mb_packet;        // packet number, -1 before decoding
  std::vector<uint8_t> mb_intra, mb_qp, mb_cbp, mb_dir, mb_acpred;
  std::vector<int> dc[3];            // reconstructed DC per block (luma 2mbw x 2mbh, chroma mbw x mbh)
  std::vector<int16_t> ac[3];        // first row [0..7) and column [7..14) of QF per block
  int last_mv[2][2][2];              // B-VOP predictors: [direction][field][x, y]
  int packet = 0, resync_mb = 0;
  Vlc vlc_mcbpc_i, vlc_mcbpc_p, vlc_cbpy, vlc_mvd, vlc_dc_lum, vlc_dc_chrom, vlc_inter, vlc_intra, vlc_mb_b;
  int max_level[2][2][64], max_run[2][2][64];  // [intra][last][run or level]
  int64_t tally[kTallyN] = {0};

  explicit Decoder(uint32_t tag) : fourcc(tag) {
    vlc_mcbpc_i.build(kMcbpcI, 9, 9);
    vlc_mcbpc_p.build(kMcbpcP, 21, 9);
    vlc_cbpy.build(kCbpy, 16, 6);
    vlc_mvd.build(kMvd, 33, 12);
    vlc_dc_lum.build(kDcLum, 13, 11);
    vlc_dc_chrom.build(kDcChrom, 13, 12);
    vlc_inter.build(kInterTcoef.vlc, 103, 12);
    vlc_intra.build(kIntraTcoef.vlc, 103, 12);
    vlc_mb_b.build(kMbTypeB, 4, 4);
    std::memset(max_level, 0, sizeof max_level);
    std::memset(max_run, 0, sizeof max_run);
    for (int intra = 0; intra < 2; ++intra) {
      const TcoefTable& t = intra ? kIntraTcoef : kInterTcoef;
      for (int i = 0; i < 102; ++i) {
        const int last_ = i >= t.last_start, run = t.run[i], level = t.level[i];
        max_level[intra][last_][run] = std::max(max_level[intra][last_][run], level);
        max_run[intra][last_][level] = std::max(max_run[intra][last_][level], run);
      }
    }
    for (int i = 0; i < 64; ++i) {
      intra_matrix[i] = kDefaultIntra[i];
      inter_matrix[i] = kDefaultInter[i];
    }
    std::memset(last_mv, 0, sizeof last_mv);
  }

  // ---- headers

  void load_matrix(BitReader& br, int* m) {
    int i = 0, v = 0, last_ = 0;
    for (; i < 64; ++i) {
      if (br.left() < 8) refuse("truncated MPEG-4 video: a quantisation matrix");
      v = (int)br.get(8);
      if (v == 0) break;
      last_ = v;
      m[kZigzag[i]] = v;
    }
    for (; i < 64; ++i) m[kZigzag[i]] = last_;  // the last value repeated
  }

  void read_vol(BitReader& br) {
    br.get1();  // random_accessible_vol
    const int vot = (int)br.get(8);
    int verid = 1;
    if (br.get1()) {
      verid = (int)br.get(4);
      br.get(3);
    }
    if (br.get(4) == 15) br.get(16);  // aspect_ratio_info: extended PAR
    const bool vcp = br.get1();
    int ld = -1;
    if (vcp) {  // vol_control_parameters
      if (br.get(2) != 1) refuse("MPEG-4 video: chroma format other than 4:2:0 is not supported");
      ld = br.get1();
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
    const bool interlaced = br.get1();
    if (!br.get1()) refuse("MPEG-4 video with OBMC is not supported");
    const int sprite = (int)br.get(verid == 1 ? 1 : 2);
    if (sprite) refuse("MPEG-4 video with sprites or GMC (sprite_enable %d) is not supported", sprite);
    if (br.get1()) refuse("MPEG-4 video with not_8_bit is not supported");
    const bool mq = br.get1();
    int im[64], nm[64];
    for (int i = 0; i < 64; ++i) {
      im[i] = kDefaultIntra[i];
      nm[i] = kDefaultInter[i];
    }
    if (mq) {  // quant_type 1: MPEG matrices, the defaults unless loaded
      if (br.get1()) {
        load_matrix(br, im);
        ++tally[kLoadedIntra];
      }
      if (br.get1()) {
        load_matrix(br, nm);
        ++tally[kLoadedInter];
      }
    }
    const bool qpel = verid != 1 && br.get1();
    if (!br.get1()) refuse("MPEG-4 video with complexity estimation headers is not supported");
    const bool resync_disable = br.get1();
    const bool dp = br.get1();
    if (dp && br.get1()) refuse("MPEG-4 video with RVLC (reversible_vlc) is not supported");
    if (verid != 1) {
      if (br.get1()) refuse("MPEG-4 video with NEWPRED is not supported");
      if (br.get1()) refuse("MPEG-4 video with reduced-resolution VOPs is not supported");
    }
    if (br.get1()) refuse("scalable MPEG-4 video is not supported");
    if (br.overran()) refuse("truncated MPEG-4 video: VOL header");
    if ((int64_t)w * h > (int64_t)1 << 26) refuse("MPEG-4 video of %dx%d is past the limit of 2^26 pixels", w, h);
    vo_type = vot;
    vol_control = vcp;
    if (vcp)
      low_delay = ld;
    else if (picture_number == 0)
      low_delay = vot == 1 || vot == 17;  // Simple and Advanced Simple object types
    if (have_vol && (w != width || h != height)) last = next = -1;
    width = w;
    height = h;
    time_bits = bits;
    time_res = res;
    t_frame = 0;
    resync = !resync_disable;
    progressive = !interlaced;
    mpeg_quant = mq;
    std::memcpy(intra_matrix, im, sizeof im);
    std::memcpy(inter_matrix, nm, sizeof nm);
    quarter_sample = qpel;
    partitioning = dp;
    mbw = (w + 15) / 16;
    mbh = (h + 15) / 16;
    mb_num_bits = 1;
    while ((1 << mb_num_bits) < mbw * mbh) ++mb_num_bits;
    if (!have_vol || pics[0].p[0].w != mbw * 16 || pics[0].p[0].h != mbh * 16) {
      const size_t nmb = (size_t)mbw * mbh;
      for (Pic& f : pics) {
        f.p[0].alloc(mbw * 16, mbh * 16);
        f.p[1].alloc(mbw * 8, mbh * 8);
        f.p[2].alloc(mbw * 8, mbh * 8);
        f.mbtype.assign(nmb, kMbIntra);
        f.mv.assign(nmb * 8, 0);
        f.fmv.assign(nmb * 4, 0);
        f.fsel.assign(nmb * 2, 0);
      }
      mb_packet.assign(nmb, -1);
      mb_intra.assign(nmb, 0);
      mb_qp.assign(nmb, 1);
      mb_cbp.assign(nmb, 0);
      mb_dir.assign(nmb, 0);
      mb_acpred.assign(nmb, 0);
      dc[0].assign(nmb * 4, 1024);
      dc[1].assign(nmb, 1024);
      dc[2].assign(nmb, 1024);
      ac[0].assign(nmb * 4 * 14, 0);
      ac[1].assign(nmb * 14, 0);
      ac[2].assign(nmb * 14, 0);
      last = next = -1;
    }
    h_edge = mbw * 16;
    v_edge = mbh * 16;
    have_vol = true;
  }

  // User data: the encoder's name and build (ffmpeg's decode_user_data).
  void read_user_data(BitReader& br) {
    char buf[256];
    int i = 0;
    for (; i < 255 && br.left() > 0; ++i) {
      if (br.peek(23) == 0) break;
      buf[i] = (char)br.get(8);
    }
    buf[i] = 0;
    int ver = 0, build = 0, ver2 = 0, ver3 = 0;
    char lastc = 0;
    int e = sscanf(buf, "DivX%dBuild%d%c", &ver, &build, &lastc);
    if (e < 2) e = sscanf(buf, "DivX%db%d%c", &ver, &build, &lastc);
    if (e >= 2) {
      divx_version = ver;
      divx_build = build;
      divx_packed = e == 3 && lastc == 'p';
    }
    e = sscanf(buf, "FFmpe%*[^b]b%d", &build) + 3;
    if (e != 4) e = sscanf(buf, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2, &ver3, &build);
    if (e != 4) {
      e = sscanf(buf, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
      if (e > 1) build = ((ver & 0xFF) << 16) + ((ver2 & 0xFF) << 8) + (ver3 & 0xFF);
    }
    if (e != 4 && std::strcmp(buf, "ffmpeg") == 0) lavc_build = 4600;
    if (e == 4) lavc_build = build;
    if (sscanf(buf, "XviD%d", &build) == 1) xvid_build = build;
  }

  static bool tag_is(uint32_t t, const char* s) {
    return t == ((uint32_t)(uint8_t)s[0] | (uint32_t)(uint8_t)s[1] << 8 | (uint32_t)(uint8_t)s[2] << 16 |
                 (uint32_t)(uint8_t)s[3] << 24);
  }

  // ffmpeg's ff_mpeg4_workaround_bugs; true when it switched to the XviD IDCT
  // (ffmpeg then parses the chunk again).
  bool workaround_bugs() {
    if (xvid_build == -1 && divx_version == -1 && lavc_build == -1) {
      for (const char* t : {"XVID", "XVIX", "RMP4", "ZMP4", "SIPP"})
        if (tag_is(fourcc, t)) xvid_build = 0;
    }
    if (xvid_build == -1 && divx_version == -1 && lavc_build == -1 && tag_is(fourcc, "DIVX") && vo_type == 0 &&
        !vol_control)
      divx_version = 400;
    if (xvid_build >= 0 && divx_version >= 0) divx_version = divx_build = -1;
    const auto u = [](int v) { return (unsigned)v; };  // ffmpeg compares against unsigned: -1 is never below
    if (tag_is(fourcc, "XVIX")) bugs |= kBugXvidIlace;
    if (divx_version >= 500 && divx_build < 1814) bugs |= kBugQpelChroma;
    if (divx_version > 502 && divx_build < 1814) bugs |= kBugQpelChroma2;
    if (u(xvid_build) <= 1u) bugs |= kBugQpelChroma;
    if (u(xvid_build) <= 12u) bugs |= kBugEdge;
    if (u(xvid_build) <= 32u) bugs |= kBugDcClip;
    if (u(lavc_build) < 4653u) bugs |= kBugStdQpel;
    if (u(lavc_build) < 4670u) bugs |= kBugEdge;
    if (u(lavc_build) <= 4712u) bugs |= kBugDcClip;
    if ((lavc_build & 0xFF) >= 100 && lavc_build > 3621476 && lavc_build < 3752552 &&
        (lavc_build < 3752037 || lavc_build > 3752191))
      bugs |= kBugIedge;
    if (u(divx_version) < 500u) bugs |= kBugEdge;
    if (divx_version >= 0) bugs |= kBugHpelChroma;
    if (xvid_build >= 0 && !xvid_idct) {
      xvid_idct = true;
      return true;
    }
    return false;
  }

  // Decodes one chunk (a container sample, or decoder configuration), as
  // ffmpeg's h263 / MPEG-4 decode_frame does. Returns true when a frame comes
  // out (display order: a reference picture one chunk late, unless low_delay).
  bool decode(const uint8_t* d, size_t n) {
    out = -1;
    std::vector<uint8_t> stored;
    const uint8_t* buf = d;
    size_t size = n;
    if (!packed.empty() && divx_packed) {
      for (size_t i = 0; i + 3 < n; ++i)
        if (d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1) {
          if (d[i + 3] == 0xB0) packed.clear();  // a new sequence: the stored VOP is dropped
          break;
        }
    }
    if (!packed.empty() && (divx_packed || n <= kMaxNvopSize)) {
      stored.swap(packed);  // the packed VOP decodes in this chunk's place
      buf = stored.data();
      size = stored.size();
      ++tally[kPackedDecoded];
      if (n <= kMaxNvopSize) ++tally[kNvopsSkipped];
    }
    packed.clear();
    for (int attempt = 0;; ++attempt) {
      size_t vop_end = 0;
      const int r = parse(buf, size, &vop_end);
      if (r <= 0) return false;  // headers only, or a VOP that gives no frame
      if (workaround_bugs() && attempt == 0) continue;  // the XviD IDCT: the chunk again, as ffmpeg retries
      if (bugs & kBugEdge) {
        h_edge = width;
        v_edge = height;
      }
      return decode_picture(buf, size, vop_end);
    }
  }

  // The headers of a chunk up to its first VOP and that VOP's header (read
  // on in vop_br; vop_start: where its payload begins in the chunk). 1 for a
  // VOP to decode, 0 for none (headers only, an uncoded VOP, a B-VOP of no
  // usable times).
  BitReader vop_br;

  int parse(const uint8_t* d, size_t n, size_t* vop_start) {
    bool vol_seen = false;
    size_t i = 0;
    for (;;) {
      while (i + 3 < n && !(d[i] == 0 && d[i + 1] == 0 && d[i + 2] == 1)) ++i;
      if (i + 3 >= n) {
        if (n == 1 && (divx_version >= 0 || xvid_build >= 0)) ++tally[kVopsUncoded];  // a DivX drop frame
        return 0;
      }
      const int code = d[i + 3];
      BitReader br(d + i + 4, n - i - 4);
      if (code >= 0x20 && code <= 0x2F) {
        if (!vol_seen) read_vol(br);
        vol_seen = true;
      } else if (code == 0xB2) {
        read_user_data(br);
      } else if (code == 0xB3) {
        if (br.peek(23) == 0) refuse("corrupt MPEG-4 video: a GOV header of zeros");
        const int hours = (int)br.get(5), minutes = (int)br.get(6);
        br.get1();
        const int seconds = (int)br.get(6);
        time_base = seconds + 60 * (minutes + 60 * hours);
      } else if (code == 0xB6) {
        if (!have_vol) refuse("MPEG-4 video: a VOP before any VOL header");
        *vop_start = i + 4;
        vop_br = br;
        return vop_header(vop_br);
      }
      i += 4;
    }
  }

  int vop_header(BitReader& br) {
    type = (int)br.get(2);
    if (type == 3) refuse("MPEG-4 video with S-VOPs (sprites, GMC) is not supported");
    if (type == 2 && low_delay && !vol_control) low_delay = false;  // ffmpeg: "low_delay flag set incorrectly"
    int time_incr = 0;
    while (br.get1())
      if (++time_incr > 1 << 20 || br.overran()) refuse("truncated MPEG-4 video: VOP header");
    br.marker("VOP header");
    const int time_increment = (int)br.get(time_bits);
    br.marker("VOP header");
    if (type != 2) {
      last_time_base = time_base;
      time_base += time_incr;
      time = time_base * time_res + time_increment;
      pp_time = (int)std::min<int64_t>(std::max<int64_t>(time - last_non_b_time, -kTimeLimit), kTimeLimit);
      last_non_b_time = time;
    } else {
      time = (last_time_base + time_incr) * time_res + time_increment;
      const int64_t pb = pp_time - (last_non_b_time - time);
      pb_time = (int)std::min<int64_t>(std::max<int64_t>(pb, -kTimeLimit), kTimeLimit);
      if (pp_time <= pb_time || pp_time <= pp_time - pb_time || pp_time <= 0 || pb != pb_time) {
        ++tally[kBSkippedTimes];  // out of order (ffmpeg skips the B-VOP)
        return 0;
      }
      if (t_frame == 0) t_frame = pb_time;
      if (t_frame == 0) t_frame = 1;
      const auto rd = [](int64_t a, int64_t b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; };
      const auto clamp = [](int64_t v) { return (int)std::min<int64_t>(std::max<int64_t>(v, -kTimeLimit), kTimeLimit); };
      pp_field_time = clamp((rd(last_non_b_time, t_frame) - rd(last_non_b_time - pp_time, t_frame)) * 2);
      pb_field_time = clamp((rd(time, t_frame) - rd(last_non_b_time - pp_time, t_frame)) * 2);
      if (pp_field_time <= pb_field_time || pb_field_time <= 1) {
        pb_field_time = 2;
        pp_field_time = 4;
        if (!progressive) {
          ++tally[kBSkippedTimes];
          return 0;
        }
      }
    }
    if (!br.get1()) {  // vop_coded = 0: no frame (ffmpeg passes over it, cv2 reads on)
      skipped_last = true;
      ++tally[kVopsUncoded];
      return 0;
    }
    rounding = type == 1 ? br.get1() : 0;
    dc_thr = kDcThreshold[br.get(3)];
    if (!progressive) {
      top_field_first = br.get1();
      alternate_scan = br.get1();
    } else {
      alternate_scan = false;
    }
    qscale = (int)br.get(5);
    if (qscale == 0) refuse("corrupt MPEG-4 video: vop_quant is 0");
    fcode = bcode = 1;
    if (type != 0) {
      fcode = (int)br.get(3);
      if (fcode == 0) refuse("corrupt MPEG-4 video: vop_fcode_forward is 0");
    }
    if (type == 2) {
      bcode = (int)br.get(3);
      if (bcode == 0) refuse("corrupt MPEG-4 video: vop_fcode_backward is 0");
    }
    if (br.overran()) refuse("truncated MPEG-4 video: VOP header");
    if (vo_type == 0 && !vol_control && divx_version == -1 && picture_number == 0) low_delay = true;
    ++picture_number;
    return 1;
  }

  // ---- pictures

  bool decode_picture(const uint8_t* buf, size_t size, size_t vop_start) {
    BitReader& br = vop_br;
    const int nmb = mbw * mbh;
    if (type != 2 && (size_t)nmb / 2 > br.left()) refuse("truncated MPEG-4 video: a VOP of %zu bits", br.left());
    if (type == 1 && next < 0) refuse("corrupt MPEG-4 video: a P-VOP with no reference frame");
    if (type == 2 && last < 0) {  // ffmpeg passes over B-VOPs before a second reference
      ++tally[kBDropped];
      return false;
    }
    if (type != 2) {  // the references move on: last <- next <- this picture
      int free_ = 0;
      while (free_ == next || free_ == last) ++free_;
      last = next;
      next = cur = free_;
    } else {
      cur = 0;
      while (cur == next || cur == last) ++cur;
    }
    Pic& pic = pics[cur];
    pic.type = type;
    skipped_last = false;
    ++tally[type == 0 ? kVopsI : type == 1 ? kVopsP : kVopsB];
    if (quarter_sample) ++tally[kQpelVops];
    if (mpeg_quant) ++tally[kMpegQuantVops];
    if (alternate_scan) ++tally[kAltScanVops];
    if (!progressive) ++tally[kInterlacedVops];
    if (xvid_idct) ++tally[kXvidIdctVops];
    if (bugs & kBugEdge) ++tally[kEdgeBugVops];
    if (bugs & kBugDcClip) ++tally[kDcClipBugVops];
    if (bugs & (kBugQpelChroma | kBugQpelChroma2)) ++tally[kQpelChromaBugVops];
    if (bugs & kBugStdQpel && quarter_sample) refuse("MPEG-4 video of an old libavcodec build with its quarter-sample filter");
    if (bugs & (kBugXvidIlace | kBugIedge)) refuse("MPEG-4 video needing ffmpeg's XVIX or IEDGE workaround is not supported");
    std::fill(mb_packet.begin(), mb_packet.end(), -1);
    packet = 0;
    resync_mb = 0;
    std::memset(last_mv, 0, sizeof last_mv);
    const bool partitioned = partitioning && type != 2;
    if (partitioned) {
      ++tally[kPartitionedVops];
      if (dc_thr != 99) refuse("data-partitioned MPEG-4 video with intra_dc_vlc_thr %d is not supported", dc_thr);
    }
    const int marker_zeros = type == 0 ? 16 : type == 1 ? 15 + fcode : 15 + std::max(std::max(fcode, bcode), 2);
    int m = 0;
    while (m < nmb) {
      if (m > 0) {
        if (!(resync && at_resync(br, marker_zeros)))
          refuse("corrupt MPEG-4 video: a partition ends at macroblock %d of %d", m, nmb);
        m = video_packet(br, m, marker_zeros);
      }
      if (partitioned) {
        m = decode_partitions(br, m);
      } else {
        for (; m < nmb; ++m) {
          if (m > 0 && !(type == 2 && pics[next].mbtype[m] & kMbSkip) && resync && at_resync(br, marker_zeros))
            break;
          mb_packet[m] = packet;
          if (type == 2)
            decode_b_mb(br, m);
          else
            decode_mb(br, m);
          if (br.overran()) refuse("truncated or corrupt MPEG-4 video");
        }
      }
    }
    // the frame that comes out
    if (type == 2 || low_delay) {
      out = cur;
    } else if (last >= 0) {
      out = last;
    }
    if (out >= 0) out_type = pics[out].type;
    // a packed chunk: the VOP after this one decodes in the next chunk's place
    if (divx_packed) {
      size_t pos = vop_start + ((br.pos + 7) >> 3);
      if (pos > size) pos = size;
      if (size - pos > 7) {
        int vops = 0;
        size_t first = 0;
        for (size_t i = pos; i + 4 < size; ++i)
          if (buf[i] == 0 && buf[i + 1] == 0 && buf[i + 2] == 1 && buf[i + 3] == 0xB6) {
            if (vops++ == 0) first = i;
          }
        if (vops > 1) refuse("a packed MPEG-4 chunk of three or more VOPs is not supported");
        if (vops == 1 && !(buf[first + 4] & 0x40)) {
          packed.assign(buf + pos, buf + size);
          ++tally[kPackedStored];
        }
      }
    } else {
      for (size_t i = vop_start + ((br.pos + 7) >> 3); i + 3 < size; ++i)
        if (buf[i] == 0 && buf[i + 1] == 0 && buf[i + 2] == 1 && buf[i + 3] == 0xB6)
          refuse("two VOPs in one chunk of MPEG-4 video not marked packed (DivX ...p user data)");
    }
    return out >= 0;
  }

  bool flush() {
    out = -1;
    if ((!low_delay || skipped_last) && next >= 0) {
      out = next;
      out_type = pics[out].type;
      next = -1;
      ++tally[kFlushed];
    }
    return out >= 0;
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

  // A video packet header at the resync marker before macroblock m; returns
  // the macroblock it starts at (ffmpeg's ff_mpeg4_decode_video_packet_header).
  int video_packet(BitReader& br, int m, int marker_zeros) {
    br.pos = (br.pos + 8) & ~(size_t)7;  // the stuffing
    br.pos += (size_t)marker_zeros + 1;
    const int mbn = (int)br.get(mb_num_bits);
    bool ok = mbn == m;
    if (type == 2 && mbn < m && mbn > 0) {  // B: macroblocks skipped with their co-located one take no bits
      ok = true;
      for (int k = mbn; k < m; ++k) ok &= (pics[next].mbtype[k] & kMbSkip) != 0;
    }
    if (!ok) refuse("corrupt MPEG-4 video: a video packet starts at macroblock %d, not %d", mbn, m);
    const int q = (int)br.get(5);
    if (q) qscale = q;
    if (br.get1()) {  // header_extension_code: what it repeats is not used
      while (br.get1())
        if (br.overran()) refuse("truncated MPEG-4 video: video packet header");
      br.marker("video packet header");
      br.get(time_bits);
      br.marker("video packet header");
      if ((int)br.get(2) != type) refuse("corrupt MPEG-4 video: a video packet of another VOP type");
      br.get(3);  // intra_dc_vlc_thr, which ffmpeg ignores here
      if (type != 0 && (int)br.get(3) != fcode) refuse("corrupt MPEG-4 video: a video packet of another fcode");
      if (type == 2 && (int)br.get(3) != bcode) refuse("corrupt MPEG-4 video: a video packet of another bcode");
    }
    ++packet;
    ++tally[kVideoPackets];
    resync_mb = m;
    last_mv[0][0][0] = last_mv[0][0][1] = last_mv[1][0][0] = last_mv[1][0][1] = 0;
    return m;
  }

  // ---- macroblocks

  bool available(int mx, int my) const {  // a macroblock before this one in the same video packet
    if (mx < 0 || my < 0 || mx >= mbw || my >= mbh) return false;
    return mb_packet[(size_t)my * mbw + mx] == packet;
  }

  int read_mcbpc(BitReader& br, bool inter) {
    int s;
    const Vlc& v = inter ? vlc_mcbpc_p : vlc_mcbpc_i;
    const int stuffing = inter ? 20 : 8;
    do s = br.vlc(v, "MCBPC");
    while (s == stuffing && !br.overran());
    if (s == stuffing) refuse("truncated MPEG-4 video");
    return s;
  }

  void set_qscale(int q) { qscale = std::min(31, std::max(1, q)); }

  // Per-macroblock motion of the picture being decoded, for the prediction.
  struct Motion {
    int dir = 1;            // 1 forward, 2 backward, 3 both
    int type = kMb16;       // kMb16, kMb8x8, kMbField
    int mv[2][4][2] = {};   // [direction][block or field][x, y]
    int fsel[2][2] = {};    // [direction][field]
  };

  void decode_mb(BitReader& br, int m) {
    const int mx = m % mbw, my = m / mbw;
    Pic& pic = pics[cur];
    int16_t* mv = pic.mv.data() + (size_t)m * 8;
    if (type == 1 && br.get1()) {  // not coded: the reference's macroblock, vector 0
      set_inter(m);
      std::fill_n(mv, 8, 0);
      pic.mbtype[m] = kMbSkip | kMb16;
      mb_qp[m] = (uint8_t)qscale;
      ++tally[kMbNotCoded];
      Motion mo;
      motion(mx, my, mo, false);
      return;
    }
    int s = read_mcbpc(br, type == 1);
    int kind, cbpc = s & 3;
    if (type == 1) {
      kind = s >> 2;
    } else {
      kind = s < 4 ? kIntra : kIntraQ;
    }
    if (kind == kIntra || kind == kIntraQ) {
      const bool ac_pred = br.get1();
      const int cbpy = br.vlc(vlc_cbpy, "CBPY");
      const bool dc_vlc = qscale < dc_thr;  // the running QP, before this macroblock's dquant
      if (kind == kIntraQ) set_qscale(qscale + kDquant[br.get(2)]);
      const bool field_dct = !progressive && br.get1();
      mb_intra[m] = 1;
      mb_qp[m] = (uint8_t)qscale;
      pic.mbtype[m] = kMbIntra;
      std::fill_n(mv, 8, 0);
      ++tally[kMbIntraT];
      if (field_dct) ++tally[kMbFieldDct];
      intra_mb(br, m, dc_vlc, ac_pred, (cbpy << 2) | cbpc, field_dct, false);
      return;
    }
    const int cbpy = br.vlc(vlc_cbpy, "CBPY") ^ 15;
    if (kind == kInterQ) set_qscale(qscale + kDquant[br.get(2)]);
    const int cbp = (cbpy << 2) | cbpc;
    const bool field_dct = !progressive && cbp && br.get1();
    set_inter(m);
    mb_qp[m] = (uint8_t)qscale;
    ++tally[kMbInterT];
    Motion mo;
    if (kind == kInter4V) {
      ++tally[kMb4vT];
      mo.type = kMb8x8;
      pic.mbtype[m] = kMb8x8;
      for (int b = 0; b < 4; ++b) {
        int px, py;
        pred_mv(mx, my, b, &px, &py);
        mo.mv[0][b][0] = read_mv(br, px, fcode);
        mo.mv[0][b][1] = read_mv(br, py, fcode);
        mv[2 * b] = (int16_t)mo.mv[0][b][0];
        mv[2 * b + 1] = (int16_t)mo.mv[0][b][1];
      }
    } else if (!progressive && br.get1()) {  // field motion: a vector for each field
      ++tally[kMbFieldMv];
      mo.type = kMbField;
      pic.mbtype[m] = kMbField;
      mo.fsel[0][0] = br.get1();
      mo.fsel[0][1] = br.get1();
      int px, py;
      pred_mv(mx, my, 0, &px, &py);
      for (int f = 0; f < 2; ++f) {
        mo.mv[0][f][0] = read_mv(br, px, fcode);
        mo.mv[0][f][1] = read_mv(br, py / 2, fcode);
      }
      int sx = mo.mv[0][0][0] + mo.mv[0][1][0];
      const int sy = mo.mv[0][0][1] + mo.mv[0][1][1];
      sx = (sx >> 1) | (sx & 1);
      for (int b = 0; b < 4; ++b) {
        mv[2 * b] = (int16_t)sx;
        mv[2 * b + 1] = (int16_t)sy;
      }
      for (int f = 0; f < 2; ++f) {
        pic.fmv[(size_t)m * 4 + 2 * f] = (int16_t)mo.mv[0][f][0];
        pic.fmv[(size_t)m * 4 + 2 * f + 1] = (int16_t)mo.mv[0][f][1];
        pic.fsel[(size_t)m * 2 + f] = (uint8_t)mo.fsel[0][f];
      }
    } else {
      pic.mbtype[m] = kMb16;
      int px, py;
      pred_mv(mx, my, 0, &px, &py);
      mo.mv[0][0][0] = read_mv(br, px, fcode);
      mo.mv[0][0][1] = read_mv(br, py, fcode);
      for (int b = 0; b < 4; ++b) {
        mv[2 * b] = (int16_t)mo.mv[0][0][0];
        mv[2 * b + 1] = (int16_t)mo.mv[0][0][1];
      }
    }
    if (field_dct) ++tally[kMbFieldDct];
    motion(mx, my, mo, false);
    for (int b = 0; b < 6; ++b)
      if ((cbp >> (5 - b)) & 1) {
        int16_t blk[64];
        inter_block(br, blk);
        put_block(mx, my, b, blk, field_dct, true);
      }
  }

  // A B-VOP's macroblock (ffmpeg's mpeg4_decode_mb, its B-VOP part).
  void decode_b_mb(BitReader& br, int m) {
    const int mx = m % mbw, my = m / mbw;
    if (mx == 0) std::memset(last_mv, 0, sizeof last_mv);
    const Pic& ref = pics[next];
    Motion mo;
    if (ref.mbtype[m] & kMbSkip) {  // not coded in the reference after: copied from the one before, vector 0
      ++tally[kBColocatedSkip];
      motion(mx, my, mo, true);
      return;
    }
    int cbp = 0, kind = 0;  // 0 direct, 1 interpolated, 2 backward, 3 forward
    bool field_dct = false, field = false, direct_skip = false;
    if (br.get1()) {  // modb '1': direct, no delta vector, no coefficients
      direct_skip = true;
    } else {
      const bool modb2 = br.get1();
      kind = br.vlc(vlc_mb_b, "B macroblock type");
      if (!modb2) cbp = (int)br.get(6);
      if (kind != 0 && cbp && br.get1()) set_qscale(qscale + (br.get1() ? 2 : -2));  // dbquant
      if (!progressive) {
        if (cbp) field_dct = br.get1();
        if (kind != 0 && br.get1()) {
          field = true;
          if (kind != 2) {
            mo.fsel[0][0] = br.get1();
            mo.fsel[0][1] = br.get1();
          }
          if (kind != 3) {
            mo.fsel[1][0] = br.get1();
            mo.fsel[1][1] = br.get1();
          }
        }
      }
    }
    if (kind != 0) {
      mo.dir = kind == 1 ? 3 : kind == 2 ? 2 : 1;
      mo.type = field ? kMbField : kMb16;
      ++tally[kind == 1 ? kBInterpolated : kind == 2 ? kBBackward : kBForward];
      if (field) ++tally[kMbFieldMv];
      for (int d = 0; d < 2; ++d) {
        if (!(mo.dir & (1 << d))) continue;
        const int code = d ? bcode : fcode;
        if (!field) {
          const int vx = read_mv(br, last_mv[d][0][0], code), vy = read_mv(br, last_mv[d][0][1], code);
          last_mv[d][0][0] = last_mv[d][1][0] = mo.mv[d][0][0] = vx;
          last_mv[d][0][1] = last_mv[d][1][1] = mo.mv[d][0][1] = vy;
        } else {
          for (int f = 0; f < 2; ++f) {
            const int vx = read_mv(br, last_mv[d][f][0], code), vy = read_mv(br, last_mv[d][f][1] / 2, code);
            last_mv[d][f][0] = mo.mv[d][f][0] = vx;
            mo.mv[d][f][1] = vy;
            last_mv[d][f][1] = vy * 2;
          }
        }
      }
    } else {
      int dmx = 0, dmy = 0;
      if (!direct_skip) {
        dmx = read_mv(br, 0, 1);
        dmy = read_mv(br, 0, 1);
      }
      ++tally[direct_skip ? kBDirectSkip : kBDirect];
      direct_mv(m, dmx, dmy, mo);
    }
    if (field_dct) ++tally[kMbFieldDct];
    motion(mx, my, mo, true);
    for (int b = 0; b < 6; ++b)
      if ((cbp >> (5 - b)) & 1) {
        int16_t blk[64];
        inter_block(br, blk);
        put_block(mx, my, b, blk, field_dct, true);
      }
  }

  // Direct mode: the co-located macroblock's vectors of the reference after,
  // scaled by the B-VOP's place between the two (TRB / TRD), plus the delta
  // (ffmpeg's ff_mpeg4_set_direct_mv).
  void direct_mv(int m, int dmx, int dmy, Motion& mo) {
    const Pic& ref = pics[next];
    const uint8_t t = ref.mbtype[m];
    mo.dir = 3;
    const auto scale = [](int v, int num, int den) { return (int)((int64_t)v * num / den); };
    const auto one = [&](int b, int px, int py) {
      mo.mv[0][b][0] = scale(px, pb_time, pp_time) + dmx;
      mo.mv[1][b][0] = dmx ? mo.mv[0][b][0] - px : scale(px, pb_time - pp_time, pp_time);
      mo.mv[0][b][1] = scale(py, pb_time, pp_time) + dmy;
      mo.mv[1][b][1] = dmy ? mo.mv[0][b][1] - py : scale(py, pb_time - pp_time, pp_time);
    };
    const int16_t* pmv = ref.mv.data() + (size_t)m * 8;
    if (t & kMb8x8) {
      ++tally[kBDirect8x8];
      mo.type = kMb8x8;
      for (int b = 0; b < 4; ++b) one(b, pmv[2 * b], pmv[2 * b + 1]);
    } else if (t & kMbField) {
      ++tally[kBDirectField];
      mo.type = kMbField;
      for (int f = 0; f < 2; ++f) {
        const int fs = ref.fsel[(size_t)m * 2 + f];
        mo.fsel[0][f] = fs;
        mo.fsel[1][f] = f;
        const int tpp = (uint16_t)(top_field_first ? pp_field_time - fs + f : pp_field_time + fs - f);
        const int tpb = (uint16_t)(top_field_first ? pb_field_time - fs + f : pb_field_time + fs - f);
        const int fx = ref.fmv[(size_t)m * 4 + 2 * f], fy = ref.fmv[(size_t)m * 4 + 2 * f + 1];
        if (tpp == 0) refuse("corrupt MPEG-4 video: field direct mode with no time between the fields");
        mo.mv[0][f][0] = scale(fx, tpb, tpp) + dmx;
        mo.mv[0][f][1] = scale(fy, tpb, tpp) + dmy;
        mo.mv[1][f][0] = dmx ? mo.mv[0][f][0] - fx : scale(fx, tpb - tpp, tpp);
        mo.mv[1][f][1] = dmy ? mo.mv[0][f][1] - fy : scale(fy, tpb - tpp, tpp);
      }
    } else {
      one(0, pmv[0], pmv[1]);
      for (int b = 1; b < 4; ++b)
        for (int d = 0; d < 2; ++d) {
          mo.mv[d][b][0] = mo.mv[d][0][0];
          mo.mv[d][b][1] = mo.mv[d][0][1];
        }
      // 8 x 8 with quarter samples: ffmpeg tests its direct-blocksize workaround in the codec
      // context's flags, which its autodetection never sets, so no stream gets 16 x 16
      mo.type = quarter_sample ? kMb8x8 : kMb16;
    }
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

  int read_mv(BitReader& br, int pred, int code_) {
    const int code = br.vlc(vlc_mvd, "motion vector");
    if (code == 0) return pred;
    const int sign = br.get1();
    const int shift = code_ - 1;
    int val = code;
    if (shift) val = (((val - 1) << shift) | (int)br.get(shift)) + 1;
    if (sign) val = -val;
    val += pred;
    const int bits = 5 + code_;  // wrapped into [-16 f, 16 f) units
    val = (int)((unsigned)val << (32 - bits)) >> (32 - bits);
    return val;
  }

  // Median prediction of block b's vector from its left (A), above (B) and
  // above-right (C) neighbours; a neighbour outside the VOP or the video
  // packet is not valid (ISO/IEC 14496-2 7.6.5).
  void pred_mv(int mx, int my, int b, int* px, int* py) {
    std::vector<int16_t>& mv = pics[cur].mv;
    if (b == 2 && my * mbw + mx == resync_mb && mx > 0) {
      // ffmpeg's ff_h263_pred_motion zeroes the left macroblock's block-3 vector in its table
      // here (a 4MV macroblock opening a video packet), which a B-VOP's direct mode then reads
      std::fill_n(mv.begin() + ((ptrdiff_t)my * mbw + mx - 1) * 8 + 6, 2, 0);
    }
    const int bx = 2 * mx + (b & 1), by = 2 * my + (b >> 1);
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
        const size_t k = (size_t)(y >> 1) * mbw + (x >> 1);
        const int blk = (x & 1) + 2 * (y & 1);
        vx[i] = mv[k * 8 + 2 * blk];
        vy[i] = mv[k * 8 + 2 * blk + 1];
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

  // ---- motion compensation (ffmpeg's mpegvideo_motion.c for an H.263-family decoder)

  // MPEG-4's quarter-sample 8-tap filter over n + 1 samples, mirrored at the block's edges.
  static inline int qtap(const uint8_t* s, int step, int n, int i) {
    const auto at = [&](int k) { return (int)s[(k < 0 ? -k - 1 : k > n ? 2 * n + 1 - k : k) * step]; };
    return 20 * (at(i) + at(i + 1)) - 6 * (at(i - 1) + at(i + 2)) + 3 * (at(i - 2) + at(i + 3)) - (at(i - 3) + at(i + 4));
  }
  static void h_lowpass(uint8_t* dst, int ds, const uint8_t* s, int ss, int n, int rows, Op op) {
    const int r = op == kPutNoRnd ? 15 : 16;
    for (int y = 0; y < rows; ++y)
      for (int x = 0; x < n; ++x) store(dst + y * ds + x, clip8((qtap(s + y * ss, 1, n, x) + r) >> 5), op);
  }
  static void v_lowpass(uint8_t* dst, int ds, const uint8_t* s, int ss, int n, Op op) {
    const int r = op == kPutNoRnd ? 15 : 16;
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x) store(dst + y * ds + x, clip8((qtap(s + x, ss, n, y) + r) >> 5), op);
  }
  static void l2(uint8_t* dst, int ds, const uint8_t* a, int as, const uint8_t* b, int bs, int n, int rows, Op op) {
    const int r = op == kPutNoRnd ? 0 : 1;
    for (int y = 0; y < rows; ++y)
      for (int x = 0; x < n; ++x) store(dst + y * ds + x, (a[y * as + x] + b[y * bs + x] + r) >> 1, op);
  }

  // An n x n quarter-sample prediction (ffmpeg's qpel{8,16}_mcXY), from src
  // holding (n + 1) x (n + 1) samples.
  static void qpel(uint8_t* dst, int ds, const uint8_t* src, int ss, int n, int dxy, Op op) {
    const Op rnd = op == kPutNoRnd ? kPutNoRnd : kPut;  // the intermediate passes
    uint8_t halfH[17 * 17], halfHV[16 * 16], half[16 * 16];
    const int fx = dxy & 3, fy = dxy >> 2;
    if (fy == 0) {
      if (fx == 0) {
        l2(dst, ds, src, ss, src, ss, n, n, op);  // an average of a sample with itself: a copy
      } else if (fx == 2) {
        h_lowpass(dst, ds, src, ss, n, n, op);
      } else {
        h_lowpass(half, n, src, ss, n, n, rnd);
        l2(dst, ds, src + (fx == 3), ss, half, n, n, n, op);
      }
      return;
    }
    if (fx == 0) {
      if (fy == 2) {
        v_lowpass(dst, ds, src, ss, n, op);
      } else {
        v_lowpass(half, n, src, ss, n, rnd);
        l2(dst, ds, src + (fy == 3) * ss, ss, half, n, n, n, op);
      }
      return;
    }
    h_lowpass(halfH, n, src, ss, n, n + 1, rnd);
    if (fx != 2) l2(halfH, n, halfH, n, src + (fx == 3), ss, n, n + 1, rnd);
    if (fy == 2) {
      v_lowpass(dst, ds, halfH, n, n, op);
      return;
    }
    v_lowpass(halfHV, n, halfH, n, n, rnd);
    l2(dst, ds, halfH + (fy == 3) * n, n, halfHV, n, n, n, op);
  }

  // ffmpeg's mpeg_motion (h263.h) into the picture being decoded, with the
  // stream's half-sample field chroma workaround.
  void mpeg_motion(const Pic& ref, int mx, int my, bool fb, int bottom, int fsel, int vx, int vy, int h, Op op) {
    h263::mpeg_motion(pics[cur].p, ref.p, mx, my, fb, bottom, fsel, vx, vy, h, op, h_edge, v_edge,
                      (bugs & kBugHpelChroma) != 0);
  }

  // ffmpeg's qpel_motion: the same with quarter-sample luma.
  void qpel_motion(const Pic& ref, int mx, int my, bool fb, int bottom, int fsel, int vx, int vy, int h, Op op) {
    Pic& pic = pics[cur];
    const int dxy = ((vy & 3) << 2) | (vx & 3);
    const int src_x = mx * 16 + (vx >> 2), src_y = my * (16 >> fb) + (vy >> 2);
    int cx, cy;
    if (fb) {
      cx = vx / 2;
      cy = vy >> 1;
    } else if (bugs & kBugQpelChroma2) {
      static constexpr int kRtab[8] = {0, 0, 1, 1, 0, 0, 0, 1};
      cx = (vx >> 1) + kRtab[vx & 7];
      cy = (vy >> 1) + kRtab[vy & 7];
    } else if (bugs & kBugQpelChroma) {
      cx = (vx >> 1) | (vx & 1);
      cy = (vy >> 1) | (vy & 1);
    } else {
      cx = vx / 2;
      cy = vy / 2;
    }
    cx = (cx >> 1) | (cx & 1);
    cy = (cy >> 1) | (cy & 1);
    const int uvdxy = (cx & 1) | ((cy & 1) << 1);
    const int uvsrc_x = mx * 8 + (cx >> 1), uvsrc_y = my * (8 >> fb) + (cy >> 1);
    const int vedge = v_edge >> fb;
    const bool emu = (unsigned)src_x >= (unsigned)std::max(h_edge - (vx & 3) - 15, 0) ||
                     (unsigned)src_y >= (unsigned)std::max(vedge - (vy & 3) - h + 1, 0);
    uint8_t s[18 * 17];
    const int step = fb ? 2 : 1;
    fetch(ref.p[0], src_x, src_y * step + fsel, step, h + 1, 17, emu, h_edge, v_edge, s, 17);
    const int ds = pic.p[0].w * step;
    uint8_t* d = pic.p[0].at(mx * 16, my * 16 + bottom);
    if (!fb) {
      qpel(d, ds, s, 17, 16, dxy, op);
    } else {  // two 8 x 8 halves, each filter mirrored at its own edges
      qpel(d, ds, s, 17, 8, dxy, op);
      qpel(d + 8, ds, s + 8, 17, 8, dxy, op);
    }
    for (int c = 1; c < 3; ++c) {
      fetch(ref.p[c], uvsrc_x, uvsrc_y * step + fsel, step, h / 2 + 1, 9, emu, h_edge >> 1, v_edge >> 1, s, 9);
      hpel(pic.p[c].at(mx * 8, my * 8 + bottom), pic.p[c].w * step, s, 9, 8, h / 2, uvdxy, op);
    }
  }

  // ffmpeg's apply_8x8: four 8 x 8 luma predictions, then one chroma vector
  // from their sum.
  void apply_8x8(const Pic& ref, int mx, int my, const int (*mv)[2], Op op) {
    Pic& pic = pics[cur];
    uint8_t s[9 * 9];
    int sx = 0, sy = 0;
    for (int b = 0; b < 4; ++b) {
      const int vx = mv[b][0], vy = mv[b][1];
      uint8_t* d = pic.p[0].at(mx * 16 + (b & 1) * 8, my * 16 + (b >> 1) * 8);
      if (quarter_sample) {
        int dxy = ((vy & 3) << 2) | (vx & 3);
        int src_x = mx * 16 + (vx >> 2) + (b & 1) * 8, src_y = my * 16 + (vy >> 2) + (b >> 1) * 8;
        src_x = std::min(std::max(src_x, -16), width);
        if (src_x == width) dxy &= ~3;
        src_y = std::min(std::max(src_y, -16), height);
        if (src_y == height) dxy &= ~12;
        const bool emu = (unsigned)src_x >= (unsigned)std::max(h_edge - (vx & 3) - 7, 0) ||
                         (unsigned)src_y >= (unsigned)std::max(v_edge - (vy & 3) - 7, 0);
        fetch(ref.p[0], src_x, src_y, 1, 9, 9, emu, h_edge, v_edge, s, 9);
        qpel(d, pic.p[0].w, s, 9, 8, dxy, op);
        sx += vx / 2;
        sy += vy / 2;
      } else {
        int dxy = 0;
        int src_x = mx * 16 + (b & 1) * 8 + (vx >> 1), src_y = my * 16 + (b >> 1) * 8 + (vy >> 1);
        src_x = std::min(std::max(src_x, -16), width);
        if (src_x != width) dxy |= vx & 1;
        src_y = std::min(std::max(src_y, -16), height);
        if (src_y != height) dxy |= (vy & 1) << 1;
        const bool emu = (unsigned)src_x >= (unsigned)std::max(h_edge - (vx & 1) - 7, 0) ||
                         (unsigned)src_y >= (unsigned)std::max(v_edge - (vy & 1) - 7, 0);
        fetch(ref.p[0], src_x, src_y, 1, 9, 9, emu, h_edge, v_edge, s, 9);
        hpel(d, pic.p[0].w, s, 9, 8, 8, dxy, op);
        sx += vx;
        sy += vy;
      }
    }
    // chroma_4mv_motion: the sum of the four vectors rounded (H.263 Table 7-9)
    static constexpr int kTab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
    const int cx = kTab[sx & 15] + ((sx >> 3) & ~1), cy = kTab[sy & 15] + ((sy >> 3) & ~1);
    int dxy = ((cy & 1) << 1) | (cx & 1);
    int src_x = mx * 8 + (cx >> 1), src_y = my * 8 + (cy >> 1);
    src_x = std::min(std::max(src_x, -8), width >> 1);
    if (src_x == (width >> 1)) dxy &= ~1;
    src_y = std::min(std::max(src_y, -8), height >> 1);
    if (src_y == (height >> 1)) dxy &= ~2;
    const bool emu = (unsigned)src_x >= (unsigned)std::max((h_edge >> 1) - (dxy & 1) - 7, 0) ||
                     (unsigned)src_y >= (unsigned)std::max((v_edge >> 1) - (dxy >> 1) - 7, 0);
    for (int c = 1; c < 3; ++c) {
      fetch(ref.p[c], src_x, src_y, 1, 9, 9, emu, h_edge >> 1, v_edge >> 1, s, 9);
      hpel(pic.p[c].at(mx * 8, my * 8), pic.p[c].w, s, 9, 8, 8, dxy, op);
    }
  }

  // The prediction of macroblock (mx, my) into the picture being decoded: a
  // P-VOP's from the reference before it; a B-VOP's forward from that one and
  // backward from the one after, averaged when both.
  void motion(int mx, int my, const Motion& mo, bool bvop) {
    Op op = bvop || !rounding ? kPut : kPutNoRnd;
    for (int d = 0; d < 2; ++d) {
      if (!(mo.dir & (1 << d))) continue;
      const Pic& ref = pics[d ? next : last];
      if (mo.type == kMb8x8) {
        apply_8x8(ref, mx, my, mo.mv[d], op);
      } else if (mo.type == kMbField) {
        for (int f = 0; f < 2; ++f) {
          if (quarter_sample)
            qpel_motion(ref, mx, my, true, f, mo.fsel[d][f], mo.mv[d][f][0], mo.mv[d][f][1], 8, op);
          else
            mpeg_motion(ref, mx, my, true, f, mo.fsel[d][f], mo.mv[d][f][0], mo.mv[d][f][1], 8, op);
        }
      } else if (quarter_sample) {
        qpel_motion(ref, mx, my, false, 0, 0, mo.mv[d][0][0], mo.mv[d][0][1], 16, op);
      } else {
        mpeg_motion(ref, mx, my, false, 0, 0, mo.mv[d][0][0], mo.mv[d][0][1], 16, op);
      }
      op = kAvg;
    }
  }

  // ---- blocks

  const uint8_t* scan_table() const { return alternate_scan ? kAltVertical : kZigzag; }

  // (run, level, last) of the next coefficient; levels signed.
  void read_coef(BitReader& br, bool intra, int* run, int* level, int* last_, bool* esc3) {
    *esc3 = false;
    const TcoefTable& t = intra ? kIntraTcoef : kInterTcoef;
    const Vlc& v = intra ? vlc_intra : vlc_inter;
    int s = br.vlc(v, "coefficient");
    if (s < 102) {
      *run = t.run[s];
      *level = t.level[s];
      *last_ = s >= t.last_start;
      if (br.get1()) *level = -*level;
      return;
    }
    if (!br.get1()) {  // escape 1: the level past the table's largest for the run
      s = br.vlc(v, "coefficient");
      if (s >= 102) refuse("corrupt MPEG-4 video: an escape inside an escape");
      *run = t.run[s];
      *last_ = s >= t.last_start;
      *level = t.level[s] + max_level[intra][*last_][*run];
      if (br.get1()) *level = -*level;
    } else if (!br.get1()) {  // escape 2: the run past the table's longest for the level
      s = br.vlc(v, "coefficient");
      if (s >= 102) refuse("corrupt MPEG-4 video: an escape inside an escape");
      *last_ = s >= t.last_start;
      *level = t.level[s];
      *run = t.run[s] + max_run[intra][*last_][*level] + 1;
      if (br.get1()) *level = -*level;
    } else {  // escape 3: fixed-length
      ++tally[kEscapes3];
      *last_ = br.get1();
      *run = (int)br.get(6);
      br.marker("escape code");
      *level = (int)((unsigned)br.get(12) << 20) >> 20;
      br.marker("escape code");
      if (*level == 0) refuse("corrupt MPEG-4 video: an escaped coefficient of 0");
      *esc3 = true;
    }
  }

  // An inter block's coefficients, dequantised (H.263, or MPEG with the
  // non-intra matrix and mismatch control), in raster order.
  void inter_block(BitReader& br, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof *blk);
    const uint8_t* scan = scan_table();
    const int qmul = 2 * qscale, qadd = (qscale - 1) | 1;
    int i = -1, last_ = 0;
    while (!last_) {
      int run, level;
      bool esc3;
      read_coef(br, false, &run, &level, &last_, &esc3);
      i += run + 1;
      if (i > 63) refuse("corrupt MPEG-4 video: a coefficient past the end of a block");
      if (!mpeg_quant) {
        level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
        if (esc3) level = std::min(2047, std::max(-2048, level));
      }
      blk[scan[i]] = (int16_t)level;
      if (br.overran()) refuse("truncated or corrupt MPEG-4 video");
    }
    if (mpeg_quant) {  // libavcodec's MPEG-2 dequantisers, the quantiser doubled (linear q_scale_type)
      int sum = -1;
      for (int j = 0; j < 64; ++j) {
        const int l = blk[j];
        if (!l) continue;
        const int a = (((std::abs(l) << 1) + 1) * 2 * qscale * inter_matrix[j]) >> 5;
        const int v = l < 0 ? -a : a;
        blk[j] = (int16_t)v;
        sum += v;
      }
      if (!(sum & 1)) ++tally[kMismatchToggles];
      blk[63] = (int16_t)(blk[63] ^ (sum & 1));
    }
  }

  // The IDCT of a block into the picture: added to the prediction or put.
  void put_block(int mx, int my, int b, int16_t* blk, bool field_dct, bool add) {
    Plane& p = pics[cur].p[b < 4 ? 0 : b - 3];
    uint8_t* dst;
    int stride = p.w;
    if (b < 4) {
      const int y = my * 16 + (field_dct ? (b >> 1) : (b >> 1) * 8);
      dst = p.at(mx * 16 + (b & 1) * 8, y);
      if (field_dct) stride *= 2;
    } else {
      dst = p.at(mx * 8, my * 8);
    }
    if (xvid_idct)
      xvid_idct::idct(blk, dst, stride, add);
    else
      simple_idct::idct(blk, dst, stride, add);
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

  // DC prediction (B C / A X): the predicted QF and the direction (true: from above).
  int dc_pred(int mx, int my, int b, bool* top) const {
    int c, x, y, gw;
    block_pos(mx, my, b, &c, &x, &y, &gw);
    const int scale = c ? c_dc_scale(qscale) : y_dc_scale(qscale);
    const int fa = intra_neighbour(c, x - 1, y, mx, my) ? dc[c][(size_t)y * gw + x - 1] : 1024;
    const int fb = intra_neighbour(c, x - 1, y - 1, mx, my) ? dc[c][(size_t)(y - 1) * gw + x - 1] : 1024;
    const int fc = intra_neighbour(c, x, y - 1, mx, my) ? dc[c][(size_t)(y - 1) * gw + x] : 1024;
    *top = std::abs(fa - fb) < std::abs(fb - fc);
    return ((*top ? fc : fa) + (scale >> 1)) / scale;
  }

  // Stores block b's reconstructed DC for its neighbours' prediction (the
  // clip at 2047 left out for XviD's early builds, as ffmpeg's DC_CLIP bug).
  void dc_store(int mx, int my, int b, int q0) {
    int c, x, y, gw;
    block_pos(mx, my, b, &c, &x, &y, &gw);
    const int scale = c ? c_dc_scale(qscale) : y_dc_scale(qscale);
    const int f0 = q0 * scale;
    dc[c][(size_t)y * gw + x] = f0 < 0 ? 0 : (f0 > 2047 && !(bugs & kBugDcClip)) ? 2047 : f0;
  }

  // A DC coefficient by its own VLC (size, then the differential), predicted.
  int intra_dc(BitReader& br, int mx, int my, int b, bool* top) {
    const int size = br.vlc(b >= 4 ? vlc_dc_chrom : vlc_dc_lum, "DC size");
    if (size > 9) refuse("corrupt MPEG-4 video: a DC size of %d", size);
    int diff = 0;
    if (size) {
      const int v = (int)br.get(size);
      diff = (v >> (size - 1)) ? v : v - (1 << size) + 1;
      if (size > 8) br.marker("intra DC");
    }
    const int q0 = diff + dc_pred(mx, my, b, top);
    dc_store(mx, my, b, q0);
    return q0;
  }

  // An intra block: DC (by its VLC, from the coefficients, or as partitioned),
  // AC coefficients, AC prediction, dequantisation; out in raster order.
  void intra_block(BitReader& br, int mx, int my, int b, bool dc_vlc, bool ac_pred, bool coded, bool partitioned,
                   int16_t* blk) {
    int c, x, y, gw;
    block_pos(mx, my, b, &c, &x, &y, &gw);
    const int scale = c ? c_dc_scale(qscale) : y_dc_scale(qscale);
    int16_t qf[64] = {0};
    int i = 0;
    bool top;
    if (partitioned) {  // DC decoded in the first partition; its QF back from the stored value
      top = (mb_dir[(size_t)my * mbw + mx] >> (5 - b)) & 1;
      qf[0] = (int16_t)((dc[c][(size_t)y * gw + x] + (scale >> 1)) / scale);
      i = 1;
    } else if (dc_vlc) {
      qf[0] = (int16_t)intra_dc(br, mx, my, b, &top);
      i = 1;
    } else {
      dc_pred(mx, my, b, &top);
    }
    const uint8_t* scan = alternate_scan ? kAltVertical : ac_pred ? (top ? kAltHorizontal : kAltVertical) : kZigzag;
    if (coded) {
      int k = i - 1, last_ = 0;
      while (!last_) {
        int run, level;
        bool esc3;
        read_coef(br, true, &run, &level, &last_, &esc3);
        k += run + 1;
        if (k > 63) refuse("corrupt MPEG-4 video: a coefficient past the end of a block");
        qf[scan[k]] = (int16_t)level;
        if (br.overran()) refuse("truncated or corrupt MPEG-4 video");
      }
    }
    if (!partitioned && !dc_vlc) {  // the DC came as the first coefficient
      qf[0] = (int16_t)(qf[0] + dc_pred(mx, my, b, &top));
      dc_store(mx, my, b, qf[0]);
    }
    // AC prediction from the first column of the left block or the first row of the one above
    int16_t* mine = ac[c].data() + ((size_t)y * gw + x) * 14;
    if (ac_pred) {
      const int nx = top ? x : x - 1, ny = top ? y - 1 : y;
      const bool inside = nx >= 0 && ny >= 0;
      const int nmx = c ? nx : nx >> 1, nmy = c ? ny : ny >> 1;
      if (inside) {  // ffmpeg's reading: a non-intra neighbour holds zeros; outside the picture there is none
        const int16_t* nb = ac[c].data() + ((size_t)ny * gw + nx) * 14;
        const int nq = mb_qp[(size_t)nmy * mbw + nmx];
        const bool same = (nmx == mx && nmy == my) || nq == qscale;
        for (int j = 1; j < 8; ++j) {
          const int v = top ? nb[j - 1] : nb[7 + j - 1];
          const int pos = top ? j : 8 * j;
          qf[pos] = (int16_t)(qf[pos] + (same ? v : rounded_div(v * nq, qscale)));
        }
      }
    }
    for (int j = 1; j < 8; ++j) {
      mine[j - 1] = qf[j];
      mine[7 + j - 1] = qf[8 * j];
    }
    // dequantisation: H.263's, or MPEG's with the intra matrix
    blk[0] = (int16_t)(qf[0] * scale);
    if (mpeg_quant) {
      for (int j = 1; j < 64; ++j) {
        const int l = qf[j];
        const int a = (std::abs(l) * 2 * qscale * intra_matrix[j]) >> 4;
        blk[j] = (int16_t)(l < 0 ? -a : a);
      }
    } else {
      const int qmul = 2 * qscale, qadd = (qscale - 1) | 1;
      for (int j = 1; j < 64; ++j) {
        const int l = qf[j];
        blk[j] = (int16_t)(l == 0 ? 0 : l > 0 ? l * qmul + qadd : l * qmul - qadd);
      }
    }
  }

  void intra_mb(BitReader& br, int m, bool dc_vlc, bool ac_pred, int cbp, bool field_dct, bool partitioned) {
    const int mx = m % mbw, my = m / mbw;
    for (int b = 0; b < 6; ++b) {
      int16_t blk[64];
      intra_block(br, mx, my, b, dc_vlc, ac_pred, (cbp >> (5 - b)) & 1, partitioned, blk);
      put_block(mx, my, b, blk, field_dct, false);
    }
  }

  // ---- data partitioning

  static constexpr uint32_t kDcMarker = 0x6B001, kMotionMarker = 0x1F001;

  // A data-partitioned video packet from macroblock m0 (I- and P-VOPs): the
  // first partition (modes, vectors; an I-VOP's DC), a marker, the second
  // (CBPY, dquant, an intra macroblock's DC), then the texture of each.
  // Returns the macroblock after the packet.
  int decode_partitions(BitReader& br, int m0) {
    Pic& pic = pics[cur];
    const int nmb = mbw * mbh;
    const int q0 = qscale;
    int m = m0;
    for (; m < nmb; ++m) {
      const int mx = m % mbw, my = m / mbw;
      int16_t* mv = pic.mv.data() + (size_t)m * 8;
      int s;
      if (type == 0) {
        if (br.peek(19) == kDcMarker) break;
        s = read_mcbpc(br, false);
        mb_packet[m] = packet;
        mb_cbp[m] = (uint8_t)(s & 3);
        if (s & 4) set_qscale(qscale + kDquant[br.get(2)]);
        mb_qp[m] = (uint8_t)qscale;
        mb_intra[m] = 1;
        pic.mbtype[m] = kMbIntra;
        std::fill_n(mv, 8, 0);
        int dir = 0;
        for (int b = 0; b < 6; ++b) {
          bool top;
          intra_dc(br, mx, my, b, &top);
          dir = (dir << 1) | top;
        }
        mb_dir[m] = (uint8_t)dir;
      } else {
        for (;;) {
          if (br.peek(17) == kMotionMarker) goto done;
          if (br.get1()) {
            s = -1;
            break;
          }
          s = br.vlc(vlc_mcbpc_p, "MCBPC");
          if (s != 20) break;
          if (br.overran()) refuse("truncated MPEG-4 video");
        }
        mb_packet[m] = packet;
        if (s < 0) {  // not coded
          pic.mbtype[m] = kMbSkip | kMb16;
          std::fill_n(mv, 8, 0);
          set_inter(m);
          continue;
        }
        mb_cbp[m] = (uint8_t)(s & 11);  // cbpc and the dquant flag
        const int kind = s >> 2;
        if (kind == kIntra || kind == kIntraQ) {
          pic.mbtype[m] = kMbIntra;
          mb_intra[m] = 1;
          std::fill_n(mv, 8, 0);
        } else {
          set_inter(m);
          if (kind == kInter4V) {
            pic.mbtype[m] = kMb8x8;
            for (int b = 0; b < 4; ++b) {
              int px, py;
              pred_mv(mx, my, b, &px, &py);
              mv[2 * b] = (int16_t)read_mv(br, px, fcode);
              mv[2 * b + 1] = (int16_t)read_mv(br, py, fcode);
            }
          } else {
            pic.mbtype[m] = kMb16;
            int px, py;
            pred_mv(mx, my, 0, &px, &py);
            const int vx = read_mv(br, px, fcode), vy = read_mv(br, py, fcode);
            for (int b = 0; b < 4; ++b) {
              mv[2 * b] = (int16_t)vx;
              mv[2 * b + 1] = (int16_t)vy;
            }
          }
        }
      }
      if (br.overran()) refuse("truncated or corrupt MPEG-4 video");
    }
  done:
    const int count = m - m0;
    if (count <= 0) refuse("corrupt MPEG-4 video: a data partition of no macroblocks");
    if (type == 0) {
      while (br.peek(9) == 1) br.get(9);
      if (br.get(19) != kDcMarker) refuse("corrupt MPEG-4 video: no DC marker after the first partition");
    } else {
      while (br.peek(10) == 1) br.get(10);
      if (br.get(17) != kMotionMarker) refuse("corrupt MPEG-4 video: no motion marker after the first partition");
    }
    for (m = m0; m < m0 + count; ++m) {
      const int mx = m % mbw, my = m / mbw;
      if (type == 0) {
        mb_acpred[m] = (uint8_t)br.get1();
        mb_cbp[m] = (uint8_t)(mb_cbp[m] | br.vlc(vlc_cbpy, "CBPY") << 2);
      } else if (pic.mbtype[m] & kMbIntra) {
        mb_acpred[m] = (uint8_t)br.get1();
        const int cbpy = br.vlc(vlc_cbpy, "CBPY");
        if (mb_cbp[m] & 8) set_qscale(qscale + kDquant[br.get(2)]);
        mb_qp[m] = (uint8_t)qscale;
        int dir = 0;
        for (int b = 0; b < 6; ++b) {
          bool top;
          intra_dc(br, mx, my, b, &top);
          dir = (dir << 1) | top;
        }
        mb_dir[m] = (uint8_t)dir;
        mb_cbp[m] = (uint8_t)((mb_cbp[m] & 3) | cbpy << 2);
      } else if (pic.mbtype[m] & kMbSkip) {
        mb_qp[m] = (uint8_t)qscale;
        mb_cbp[m] = 0;
      } else {
        const int cbpy = br.vlc(vlc_cbpy, "CBPY");
        if (mb_cbp[m] & 8) set_qscale(qscale + kDquant[br.get(2)]);
        mb_qp[m] = (uint8_t)qscale;
        mb_cbp[m] = (uint8_t)((mb_cbp[m] & 3) | (cbpy ^ 15) << 2);
      }
      if (br.overran()) refuse("truncated or corrupt MPEG-4 video");
    }
    qscale = q0;
    for (m = m0; m < m0 + count; ++m) {  // the texture
      const int mx = m % mbw, my = m / mbw;
      set_qscale(mb_qp[m]);
      const uint8_t t = pic.mbtype[m];
      const int cbp = mb_cbp[m];
      if (t & kMbIntra) {
        ++tally[kMbIntraT];
        intra_mb(br, m, true, mb_acpred[m], cbp, false, true);
      } else {
        Motion mo;
        if (t & kMbSkip) {
          ++tally[kMbNotCoded];
        } else {
          ++tally[kMbInterT];
          const int16_t* mv = pic.mv.data() + (size_t)m * 8;
          mo.type = t & kMb8x8 ? kMb8x8 : kMb16;
          if (t & kMb8x8) ++tally[kMb4vT];
          for (int b = 0; b < 4; ++b) {
            mo.mv[0][b][0] = mv[2 * b];
            mo.mv[0][b][1] = mv[2 * b + 1];
          }
        }
        motion(mx, my, mo, false);
        for (int b = 0; b < 6; ++b)
          if ((cbp >> (5 - b)) & 1) {
            int16_t blk[64];
            inter_block(br, blk);
            put_block(mx, my, b, blk, false, true);
          }
      }
      if (br.overran()) refuse("truncated or corrupt MPEG-4 video");
    }
    return m0 + count;
  }

  // ---- output

  void copy_out(uint8_t* y, uint8_t* u, uint8_t* v) const {
    if (out < 0) return;
    const Pic& f = pics[out];
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

// A decoder for a stream under the container's fourcc (little-endian; 0 for
// none), which names the encoder of an unmarked stream as ffmpeg reads it.
void* mga_mpeg4_decoder_new(uint32_t fourcc) {
  try {
    return new Decoder(fourcc);
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

void mga_mpeg4_decoder_free(void* h) { delete static_cast<Decoder*>(h); }

// Decodes one chunk. Returns 1 when a frame comes out of it, in display order
// (info: width, height, and 0 for an I-VOP, 1 for a P-VOP, 2 for a B-VOP),
// 0 when none does (headers only, an uncoded VOP, a B-VOP ffmpeg passes
// over, or the first reference of a stream with B-VOPs), -1 with a message.
int mga_mpeg4_decode(void* h, const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  Decoder* dec = static_cast<Decoder*>(h);
  bool frame = false;
  const int rc = guarded(err, errlen, [&] {
    frame = dec->decode(data, (size_t)n);
    info[0] = dec->width;
    info[1] = dec->height;
    info[2] = dec->out_type;
  });
  if (rc < 0) return -1;
  return frame ? 1 : 0;
}

// At the end of the stream: 1 when a frame is left (the last reference of a
// stream with B-VOPs), with info as mga_mpeg4_decode's.
int mga_mpeg4_flush(void* h, int32_t* info) {
  Decoder* dec = static_cast<Decoder*>(h);
  const bool frame = dec->flush();
  info[0] = dec->width;
  info[1] = dec->height;
  info[2] = dec->out_type;
  return frame ? 1 : 0;
}

// The frame that came out: y (height x width), u and v ((height+1)/2 x (width+1)/2).
void mga_mpeg4_frame(void* h, uint8_t* y, uint8_t* u, uint8_t* v) { static_cast<Decoder*>(h)->copy_out(y, u, v); }

// The tally's first n counts (MPEG4_TALLY's order); returns how many it has.
int mga_mpeg4_tally(void* h, int64_t* out, int n) {
  const Decoder* dec = static_cast<const Decoder*>(h);
  for (int i = 0; i < n && i < kTallyN; ++i) out[i] = dec->tally[i];
  return kTallyN;
}

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
