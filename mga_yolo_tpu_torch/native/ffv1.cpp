// FFV1 decoding on the host (versions 0, 1 and 3, 8 bits a sample), as
// libavcodec's ffv1dec.c decodes it for cv2 (RFC 9043).
//
// A frame opens with a range-coded key frame bit. Versions 0 and 1 then
// carry, in each key frame, the stream's parameters (coder, custom state
// transitions, colourspace, chroma planes and shifts, transparency) and the
// context quantisation tables, and have one slice. Version 3 keeps them in
// its configuration record (the container's extradata: Matroska's
// CodecPrivate, MP4's glbl box, AVI's strf tail), with several quantisation
// tables, the contexts' initial states and the error-correction flag, all
// under a CRC; its frames are slices, each found from the frame's end by the
// 24-bit size in its footer (with a CRC when error correction is on) and
// opening with its position, its planes' quantisation tables and the
// picture structure.
//
// Samples are coded as the difference to the median of left, above and
// left + above - above-left, in a context of the quantised differences of
// the neighbours (five where the tables use the two further ones), with the
// range coder (get_symbol: exponent and mantissa bits, each in a state of
// the context's 32) or Golomb-Rice codes with adaptive k and a run mode for
// context 0. The range coder's states follow the default transition table
// (ff_build_rac_states, factor 0.05, max 248) or one the header codes as
// differences. YUV planes are coded in turn (Cb and Cr share contexts),
// RGB line by line as G and the JPEG 2000 RCT's Cb and Cr (9-bit) and A.
// Contexts persist across frames and are reset at key frames.
//
// Cut or corrupt frames raise: an overread range coder, a slice size that
// leaves the frame, a bad CRC, a range-coded slice that does not end where
// its footer begins (libavcodec conceals these with the last frame).
//
// No global state.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <stdexcept>
#include <vector>

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
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return -1;
}

constexpr int kContextSize = 32;
constexpr int kMaxQuantTables = 8;
constexpr int kMaxSlices = 1024;
constexpr int kMaxOverread = 2;

const uint8_t kLog2Run[41] = {0, 0, 0, 0, 1, 1, 1,  1,  2,  2,  2,  2,  3,  3,  3,  3,  4,  4,  5,  5, 6,
                              6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24};

// What a decoder counts (FFV1_TALLY's order in __init__.py).
enum Tally {
  kFrames, kKeyFrames, kNonKeyFrames, kVersion0, kVersion1, kVersion3, kGolomb, kRangeDefault, kRangeCustom,
  kInitialStates, kMultiSlice, kSliceCrc, kGray, kYuv420, kYuv422, kYuv444, kAlpha, kRgb, kRuns, kRunBreaks,
  kGolombEscape, kFiveInputContexts, kOddSize, kTallyN
};

// libavutil's AV_CRC_32_IEEE (MSB first, its register kept byte-swapped).
uint32_t crc32_ieee(uint32_t crc, const uint8_t* p, size_t n) {
  uint32_t table[256];
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i << 24;
    for (int j = 0; j < 8; ++j) c = (c << 1) ^ (0x04C11DB7u & (uint32_t)((int32_t)c >> 31));
    table[i] = __builtin_bswap32(c);
  }
  for (size_t i = 0; i < n; ++i) crc = table[(uint8_t)crc ^ p[i]] ^ (crc >> 8);
  return crc;
}

struct RangeCoder {
  const uint8_t *start = nullptr, *p = nullptr, *end = nullptr;
  uint32_t low = 0, range = 0;
  int overread = 0;
  const uint8_t *zero = nullptr, *one = nullptr;

  void init(const uint8_t* buf, size_t n) {
    start = p = buf;
    end = buf + n;
    range = 0xFF00;
    low = (uint32_t)((n > 0 ? buf[0] : 0) << 8 | (n > 1 ? buf[1] : 0));
    p += 2;
    overread = 0;
    if (low >= 0xFF00) {
      low = 0xFF00;
      end = p;
    }
  }
  void refill() {
    if (range < 0x100) {
      range <<= 8;
      low <<= 8;
      if (p < end)
        low += *p++;
      else
        ++overread;
    }
  }
  int bit(uint8_t* state) {
    const uint32_t range1 = (range * *state) >> 8;
    range -= range1;
    if (low < range) {
      *state = zero[*state];
      refill();
      return 0;
    }
    low -= range;
    *state = one[*state];
    range = range1;
    refill();
    return 1;
  }
  int symbol(uint8_t* state, bool is_signed) {
    if (bit(state)) return 0;
    int e = 0;
    while (bit(state + 1 + std::min(e, 9))) {
      if (++e > 31) refuse("a corrupt range-coded symbol");
    }
    uint32_t a = 1;
    for (int i = e - 1; i >= 0; --i) a += a + bit(state + 22 + std::min(i, 9));
    const int neg = is_signed && bit(state + 11 + std::min(e, 10));
    return neg ? -(int)a : (int)a;
  }
  unsigned usymbol(uint8_t* state) { return (unsigned)symbol(state, false); }
};

// The range coder's default state transitions (ff_build_rac_states(0.05, 248)).
struct States {
  uint8_t zero[256] = {}, one[256] = {};
  States() {
    const int64_t onep = int64_t(1) << 32, factor = (int64_t)(0.05 * (double)(int64_t(1) << 32));
    const int max_p = 256 - 8;
    int last_p8 = 0;
    int64_t p = onep / 2;
    for (int i = 0; i < 128; ++i) {
      int p8 = (int)((256 * p + onep / 2) >> 32);
      if (p8 <= last_p8) p8 = last_p8 + 1;
      if (last_p8 && last_p8 < 256 && p8 <= max_p) one[last_p8] = (uint8_t)p8;
      p += ((onep - p) * factor + onep / 2) >> 32;
      last_p8 = p8;
    }
    for (int i = 256 - max_p; i <= max_p; ++i) {
      if (one[i]) continue;
      p = (i * onep + 128) >> 8;
      p += ((onep - p) * factor + onep / 2) >> 32;
      int p8 = (int)((256 * p + onep / 2) >> 32);
      if (p8 <= i) p8 = i + 1;
      if (p8 > max_p) p8 = max_p;
      one[i] = (uint8_t)p8;
    }
    for (int i = 1; i < 255; ++i) zero[i] = (uint8_t)(256 - one[256 - i]);
  }
  void custom(const uint8_t* transition) {
    for (int i = 1; i < 256; ++i) {
      one[i] = transition[i];
      zero[256 - i] = (uint8_t)(256 - one[i]);
    }
  }
};

// Golomb-Rice bits, MSB first; reads past the end give zeros and are caught by the caller.
struct Bits {
  const uint8_t* p = nullptr;
  int64_t n = 0, pos = 0;
  int bit() {
    const int v = pos < n ? (p[pos >> 3] >> (7 - (pos & 7))) & 1 : 0;
    ++pos;
    return v;
  }
  uint32_t get(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) v = (v << 1) | (uint32_t)bit();
    return v;
  }
  int left() const { return (int)std::max<int64_t>(-1, std::min<int64_t>(n - pos, 1 << 30)); }
};

struct VlcState {
  int16_t drift = 0;
  uint32_t error_sum = 4;
  int8_t bias = 0;
  uint8_t count = 1;
};

struct Plane {
  int quant_table_index = 0;
  int context_count = 0;
  std::vector<uint8_t> state;  // context_count x kContextSize
  std::vector<VlcState> vlc;
};

struct Slice {
  RangeCoder c;
  Bits gb;
  int x = 0, y = 0, w = 0, h = 0;
  Plane plane[4];
  int run_index = 0;
};

struct Decoder {
  int width, height;
  int version = 0, micro_version = 0, ac = 0, colorspace = 0, bits = 8, chroma_planes = 0, h_shift = 0, v_shift = 0;
  int transparency = 0, plane_count = 0, num_h = 1, num_v = 1, ec = 0;
  uint32_t crcref = 0;
  int quant_table_count = 0;
  int16_t quant[kMaxQuantTables][5][256] = {};
  int context_count[kMaxQuantTables] = {};
  std::vector<uint8_t> initial[kMaxQuantTables];
  uint8_t transition[256] = {};
  States defaults, states;
  bool key_ok = false, configured = false;
  int slice_count = 0;
  std::vector<Slice> slices;
  std::vector<uint8_t> out[4];  // Y (or packed BGRA), U, V, A
  int ow[4] = {0}, oh[4] = {0};
  int format = -1;  // 0 gray, 1 yuv420p, 2 yuv422p, 3 yuv444p, 4 yuva420p, 5 yuva422p, 6 yuva444p, 7 bgr0, 8 bgra
  std::vector<int16_t> sample_buffer;
  int64_t tally[kTallyN] = {};

  Decoder(const uint8_t* extra, int64_t n, int w, int h) : width(w), height(h) {
    if (w <= 0 || h <= 0 || w > 16384 || h > 16384) refuse("a picture of %d x %d (1 to 16384 a side)", w, h);
    if (n > 0) read_extra(extra, (size_t)n);
    if (w & 1 || h & 1) tally[kOddSize] = 1;
  }

  static int read_quant_table(RangeCoder& c, int16_t* table, int scale) {
    uint8_t state[kContextSize];
    memset(state, 128, sizeof state);
    int i = 0, v = 0;
    for (; i < 128; ++v) {
      const unsigned len = c.usymbol(state) + 1u;
      if (len > (unsigned)(128 - i) || !len) refuse("a corrupt context quantisation table");
      for (unsigned k = 0; k < len; ++k) table[i++] = (int16_t)(scale * v);
    }
    for (i = 1; i < 128; ++i) table[256 - i] = (int16_t)-table[i];
    table[128] = (int16_t)-table[127];
    return 2 * v - 1;
  }
  int read_quant_tables(RangeCoder& c, int16_t (*table)[256]) {
    int count = 1;
    for (int i = 0; i < 5; ++i) {
      count *= read_quant_table(c, table[i], count);
      if (count > 32768 || count <= 0) refuse("FFV1 quantisation tables of %d contexts", count);
    }
    return (count + 1) / 2;
  }

  void read_transitions(RangeCoder& c, uint8_t* state) {
    for (int i = 1; i < 256; ++i) {
      const int st = c.symbol(state, true) + c.one[i];
      if (st < 1 || st > 255) refuse("a corrupt state transition table");
      transition[i] = (uint8_t)st;
    }
  }

  void check_format() {
    if (bits > 8) refuse("FFV1 of %d bits a sample (8 at most)", bits);
    if (colorspace == 0) {
      if (!chroma_planes) {
        if (transparency) refuse("FFV1 grey with an alpha plane");
        format = 0;
        tally[kGray] = 1;
        return;
      }
      const int key = 16 * h_shift + v_shift;
      if (key == 0x11) format = 1;
      else if (key == 0x10) format = 2;
      else if (key == 0x00) format = 3;
      else refuse("FFV1 YUV of chroma shifts %d, %d (4:2:0, 4:2:2 and 4:4:4 only)", h_shift, v_shift);
      tally[format == 1 ? kYuv420 : format == 2 ? kYuv422 : kYuv444] = 1;
      if (transparency) {
        format += 3;
        tally[kAlpha] = 1;
      }
    } else if (colorspace == 1) {
      format = transparency ? 8 : 7;
      tally[kRgb] = 1;
      if (transparency) tally[kAlpha] = 1;
    } else {
      refuse("FFV1 of colourspace %d (Bayer, or unknown)", colorspace);
    }
  }

  void read_extra(const uint8_t* data, size_t n) {
    RangeCoder c;
    c.init(data, n);
    c.zero = defaults.zero;
    c.one = defaults.one;
    uint8_t state[kContextSize];
    memset(state, 128, sizeof state);
    version = c.symbol(state, false);
    if (version < 2) refuse("an FFV1 configuration record of version %d", version);
    if (version != 3) refuse("FFV1 version %d (0, 1 and 3 only)", version);
    if (n < 4) refuse("an FFV1 configuration record of %zu bytes", n);
    c.end -= 4;
    micro_version = c.symbol(state, false);
    ac = c.symbol(state, false);
    if (ac == 2) {
      read_transitions(c, state);
    } else {
      memcpy(transition, defaults.one, sizeof transition);
    }
    colorspace = c.symbol(state, false);
    bits = c.symbol(state, false);
    chroma_planes = c.bit(state);
    h_shift = c.symbol(state, false);
    v_shift = c.symbol(state, false);
    transparency = c.bit(state);
    plane_count = 2 + transparency;
    num_h = 1 + c.symbol(state, false);
    num_v = 1 + c.symbol(state, false);
    if (h_shift > 4 || v_shift > 4 || h_shift < 0 || v_shift < 0) refuse("FFV1 chroma shifts %d, %d", h_shift, v_shift);
    if (num_h > width || num_h < 1 || num_v > height || num_v < 1 || num_h > kMaxSlices / num_v)
      refuse("FFV1 slices of %d x %d", num_h, num_v);
    quant_table_count = c.symbol(state, false);
    if (quant_table_count > kMaxQuantTables || quant_table_count < 1)
      refuse("%d FFV1 quantisation tables", quant_table_count);
    for (int i = 0; i < quant_table_count; ++i) context_count[i] = read_quant_tables(c, quant[i]);
    uint8_t state2[kContextSize][kContextSize];
    memset(state2, 128, sizeof state2);
    for (int i = 0; i < quant_table_count; ++i) {
      initial[i].assign((size_t)context_count[i] * kContextSize, 128);
      if (c.bit(state)) {
        tally[kInitialStates] = 1;
        for (int j = 0; j < context_count[i]; ++j)
          for (int k = 0; k < kContextSize; ++k) {
            const int pred = j ? initial[i][(size_t)(j - 1) * kContextSize + k] : 128;
            initial[i][(size_t)j * kContextSize + k] = (uint8_t)((pred + c.symbol(state2[k], true)) & 0xFF);
          }
      }
    }
    ec = c.symbol(state, false);
    if (ec >= 2) crcref = 0x7a8c4079;
    if (micro_version >= 3) c.symbol(state, false);  // intra: every frame a key frame
    if (c.overread > kMaxOverread) refuse("a cut FFV1 configuration record");
    if (crc32_ieee(crcref, data, n) != crcref) refuse("an FFV1 configuration record with a bad CRC");
    check_format();
    configured = true;
    tally[kVersion3] = 1;
  }

  // A key frame's header (versions 0 and 1), or the slice count (version 3).
  void read_header(RangeCoder& c, const uint8_t* buf, size_t n) {
    uint8_t state[kContextSize];
    memset(state, 128, sizeof state);
    if (version < 2) {
      if (configured) refuse("an FFV1 configuration record in front of a version %d stream", version);
      const int v = c.symbol(state, false);
      if (v >= 2) refuse("FFV1 version %d in a frame header", v);
      version = v;
      ac = c.symbol(state, false);
      if (ac == 2) {
        read_transitions(c, state);
      } else {
        memcpy(transition, defaults.one, sizeof transition);
      }
      colorspace = c.symbol(state, false);
      bits = version > 0 ? c.symbol(state, false) : 8;
      if (bits == 0) bits = 8;
      chroma_planes = c.bit(state);
      h_shift = c.symbol(state, false);
      v_shift = c.symbol(state, false);
      transparency = c.bit(state);
      plane_count = 2 + transparency;
      if (h_shift > 4 || v_shift > 4 || h_shift < 0 || v_shift < 0) refuse("FFV1 chroma shifts %d, %d", h_shift, v_shift);
      check_format();
      quant_table_count = 1;
      context_count[0] = read_quant_tables(c, quant[0]);
      initial[0].assign((size_t)context_count[0] * kContextSize, 128);
      slice_count = 1;
      tally[version == 0 ? kVersion0 : kVersion1] = 1;
    } else {
      const int trailer = 3 + 5 * (ec != 0);
      const uint8_t* p = buf + n;
      for (slice_count = 0; slice_count < kMaxSlices && trailer < p - buf; ++slice_count) {
        const int size = p[-trailer] << 16 | p[-trailer + 1] << 8 | p[-trailer + 2];
        if (size + trailer > p - buf) break;
        p -= size + trailer;
      }
      if (slice_count < 1 || slice_count > num_h * num_v) refuse("FFV1 frame of %d slices", slice_count);
    }
    slices.resize(slice_count);
    for (Slice& s : slices)
      for (int i = 0; i < plane_count; ++i) {
        Plane& pl = s.plane[i];
        if (version < 2) {
          pl.quant_table_index = 0;
          pl.context_count = context_count[0];
        }
      }
    if (version < 2) {
      Slice& s = slices[0];
      s.x = s.y = 0;
      s.w = width;
      s.h = height;
    }
    states = defaults;
    if (ac == 2) {
      states.custom(transition);
      tally[kRangeCustom] = 1;
    } else if (ac == 1) {
      tally[kRangeDefault] = 1;
    } else if (ac == 0) {
      tally[kGolomb] = 1;
    } else {
      refuse("the FFV1 coder %d", ac);
    }
  }

  void slice_header(Slice& s) {
    RangeCoder& c = s.c;
    uint8_t state[kContextSize];
    memset(state, 128, sizeof state);
    const int64_t sx = c.usymbol(state), sy = c.usymbol(state), sw = c.usymbol(state) + 1u, sh = c.usymbol(state) + 1u;
    s.x = (int)(sx * width / num_h);
    s.y = (int)(sy * height / num_v);
    s.w = (int)((sx + sw) * width / num_h - s.x);
    s.h = (int)((sy + sh) * height / num_v - s.y);
    if (sx > num_h || sy > num_v || sw > num_h || sh > num_v || s.w <= 0 || s.h <= 0 || s.x + s.w > width ||
        s.y + s.h > height)
      refuse("an FFV1 slice at %lld, %lld of %lld x %lld slices", (long long)sx, (long long)sy, (long long)sw,
             (long long)sh);
    for (int i = 0; i < plane_count; ++i) {
      const int idx = c.symbol(state, false);
      if (idx < 0 || idx >= quant_table_count) refuse("an FFV1 slice of quantisation table %d", idx);
      s.plane[i].quant_table_index = idx;
      s.plane[i].context_count = context_count[idx];
    }
    c.symbol(state, false);  // picture structure
    c.symbol(state, false);  // sample aspect ratio
    c.symbol(state, false);
  }

  void clear(Slice& s) {
    for (int i = 0; i < plane_count; ++i) {
      Plane& p = s.plane[i];
      p.state = initial[p.quant_table_index];
      p.state.resize((size_t)p.context_count * kContextSize, 128);
      p.vlc.assign(p.context_count, VlcState());
    }
  }

  static int fold(int diff, int nbits) { return (int)((uint32_t)diff << (32 - nbits)) >> (32 - nbits); }

  int golomb(Bits& gb, int k, int esc_len) {
    int q = 0;
    while (q < 12 && !gb.bit()) ++q;
    uint32_t v;
    if (q < 12) {
      v = ((uint32_t)q << k) | gb.get(k);
    } else {
      v = gb.get(esc_len) + 11;
      tally[kGolombEscape] = 1;
    }
    return (int)(v >> 1) ^ -(int)(v & 1);
  }

  int vlc_symbol(Bits& gb, VlcState& st, int nbits) {
    int k = 0, i = st.count;
    while (i < st.error_sum) {
      ++k;
      i += i;
    }
    int v = golomb(gb, k, nbits);
    v ^= ((2 * st.drift + st.count) >> 31);
    const int ret = fold(v + st.bias, nbits);
    int drift = st.drift, count = st.count;
    int64_t error_sum = (int64_t)st.error_sum + std::abs(v);
    drift += v;
    if (count == 128) {
      count >>= 1;
      drift >>= 1;
      error_sum >>= 1;
    }
    ++count;
    if (drift <= -count) {
      st.bias = (int8_t)std::max(st.bias - 1, -128);
      drift = std::max(drift + count, -count + 1);
    } else if (drift > 0) {
      st.bias = (int8_t)std::min(st.bias + 1, 127);
      drift = std::min(drift - count, 0);
    }
    st.drift = (int16_t)drift;
    st.count = (uint8_t)count;
    st.error_sum = (uint32_t)error_sum;
    return ret;
  }

  bool input_end(Slice& s) const { return ac ? s.c.overread > kMaxOverread : s.gb.left() < 1; }

  // One line of w samples into cur (prev the line above, cur holding the one above that), masked to nbits.
  void decode_line(Slice& s, int w, int16_t* cur, const int16_t* prev, int plane_index, int nbits) {
    Plane& p = s.plane[plane_index];
    const int16_t(*q)[256] = quant[p.quant_table_index];
    const bool five = q[3][127] || q[4][127];
    if (five) tally[kFiveInputContexts] = 1;
    const int mask = (1 << nbits) - 1;
    int run_count = 0, run_mode = 0, run_index = s.run_index;
    if (input_end(s)) refuse("a cut FFV1 slice");
    for (int x = 0; x < w; ++x) {
      if (!(x & 1023) && x && input_end(s)) refuse("a cut FFV1 slice");
      const int L = cur[x - 1], LT = prev[x - 1], T = prev[x], RT = prev[x + 1];
      int context = q[0][(L - LT) & 0xFF] + q[1][(LT - T) & 0xFF] + q[2][(T - RT) & 0xFF];
      if (five) context += q[3][(cur[x - 2] - L) & 0xFF] + q[4][(cur[x] - T) & 0xFF];
      bool sign = false;
      if (context < 0) {
        context = -context;
        sign = true;
      }
      if (context >= p.context_count) refuse("an FFV1 context out of range");
      int diff;
      if (ac) {
        diff = s.c.symbol(&p.state[(size_t)context * kContextSize], true);
      } else {
        if (context == 0 && run_mode == 0) run_mode = 1;
        if (run_mode) {
          if (run_count == 0 && run_mode == 1) {
            if (s.gb.bit()) {
              run_count = 1 << kLog2Run[run_index];
              if (x + run_count <= w) ++run_index;
              tally[kRuns] = 1;
            } else {
              run_count = kLog2Run[run_index] ? (int)s.gb.get(kLog2Run[run_index]) : 0;
              if (run_index) --run_index;
              run_mode = 2;
              tally[kRunBreaks] = 1;
            }
            if (run_index > 40) refuse("a corrupt FFV1 run");
          }
          if (--run_count < 0) {
            run_mode = 0;
            run_count = 0;
            diff = vlc_symbol(s.gb, p.vlc[context], nbits);
            if (diff >= 0) ++diff;
          } else {
            diff = 0;
          }
        } else {
          diff = vlc_symbol(s.gb, p.vlc[context], nbits);
        }
      }
      if (sign) diff = -diff;
      const int pred = std::max(std::min(L, T), std::min(std::max(L, T), L + T - LT));
      cur[x] = (int16_t)((pred + diff) & mask);
    }
    s.run_index = run_index;
  }

  void decode_plane(Slice& s, uint8_t* dst, int stride, int w, int h, int plane_index) {
    sample_buffer.assign((size_t)2 * (w + 6), 0);
    int16_t* rows[2] = {sample_buffer.data() + 3, sample_buffer.data() + w + 6 + 3};
    s.run_index = 0;
    for (int y = 0; y < h; ++y) {
      std::swap(rows[0], rows[1]);  // rows[1]: this line (holding the line two above), rows[0]: the line above
      rows[1][-1] = rows[0][0];
      rows[0][w] = rows[0][w - 1];
      decode_line(s, w, rows[1], rows[0], plane_index, 8);
      uint8_t* o = dst + (size_t)y * stride;
      for (int x = 0; x < w; ++x) o[x] = (uint8_t)rows[1][x];
    }
  }

  void decode_rgb(Slice& s, uint8_t* dst, int stride, int w, int h) {
    sample_buffer.assign((size_t)8 * (w + 6), 0);
    int16_t* rows[4][2];
    for (int k = 0; k < 4; ++k) {
      rows[k][0] = sample_buffer.data() + (size_t)k * 2 * (w + 6) + 3;
      rows[k][1] = sample_buffer.data() + (size_t)(k * 2 + 1) * (w + 6) + 3;
    }
    s.run_index = 0;
    for (int y = 0; y < h; ++y) {
      for (int k = 0; k < 3 + transparency; ++k) {
        std::swap(rows[k][0], rows[k][1]);
        rows[k][1][-1] = rows[k][0][0];
        rows[k][0][w] = rows[k][0][w - 1];
        decode_line(s, w, rows[k][1], rows[k][0], (k + 1) / 2, 9);
      }
      uint8_t* o = dst + (size_t)y * stride;
      for (int x = 0; x < w; ++x) {
        int g = rows[0][1][x], b = rows[1][1][x] - 256, r = rows[2][1][x] - 256;
        const int a = transparency ? rows[3][1][x] : 0;
        g -= (b + r) >> 2;
        b += g;
        r += g;
        o[4 * x] = (uint8_t)b;
        o[4 * x + 1] = (uint8_t)g;
        o[4 * x + 2] = (uint8_t)r;
        o[4 * x + 3] = (uint8_t)a;
      }
    }
  }

  void decode_slice(Slice& s, bool key) {
    if (version > 2) slice_header(s);
    if (key) {
      clear(s);
    } else {
      for (int i = 0; i < plane_count; ++i)
        if (s.plane[i].state.size() != (size_t)s.plane[i].context_count * kContextSize)
          refuse("an FFV1 slice whose quantisation tables changed without a key frame");
    }
    if (!ac) {
      if ((version == 3 && micro_version > 1) || version > 3) {
        uint8_t st = 129;
        s.c.bit(&st);
      }
      const int64_t used = version > 2 || (!s.x && !s.y) ? (s.c.p - s.c.start) - 1 : 0;
      if (used < 0 || s.c.start + used > s.c.end) refuse("a cut FFV1 slice");
      s.gb.p = s.c.start + used;
      s.gb.n = (s.c.end - s.c.start - used) * 8;
      s.gb.pos = 0;
    }
    const int x = s.x, y = s.y, w = s.w, h = s.h;
    if (colorspace == 0) {
      decode_plane(s, out[0].data() + (size_t)y * ow[0] + x, ow[0], w, h, 0);
      if (chroma_planes) {
        const int cw = (w + (1 << h_shift) - 1) >> h_shift, ch = (h + (1 << v_shift) - 1) >> v_shift;
        const int cx = x >> h_shift, cy = y >> v_shift;
        decode_plane(s, out[1].data() + (size_t)cy * ow[1] + cx, ow[1], cw, ch, 1);
        decode_plane(s, out[2].data() + (size_t)cy * ow[2] + cx, ow[2], cw, ch, 1);
      }
      if (transparency) decode_plane(s, out[3].data() + (size_t)y * ow[3] + x, ow[3], w, h, 2);
    } else {
      decode_rgb(s, out[0].data() + (size_t)y * ow[0] + 4 * x, ow[0], w, h);
    }
    if (ac) {
      if (s.c.overread > kMaxOverread) refuse("a cut FFV1 slice");
      if (version > 2) {
        uint8_t st = 129;
        s.c.bit(&st);
        if (s.c.end - s.c.p - 2 - 5 * (ec != 0) != 0) refuse("an FFV1 slice that does not end at its footer");
      }
    } else if (s.gb.pos > s.gb.n) {
      refuse("a cut FFV1 slice");
    }
  }

  void decode(const uint8_t* buf, size_t n) {
    if (n < 2) refuse("an FFV1 frame of %zu bytes", n);
    RangeCoder c;
    c.init(buf, n);
    c.zero = defaults.zero;
    c.one = defaults.one;
    uint8_t keystate = 128;
    const bool key = c.bit(&keystate);
    if (key) {
      key_ok = false;
      read_header(c, buf, n);
      key_ok = true;
      ++tally[kKeyFrames];
    } else {
      if (!key_ok) refuse("an FFV1 frame that is not a key frame before any key frame");
      ++tally[kNonKeyFrames];
    }
    if (format < 0) refuse("an FFV1 stream without its parameters");
    if (ac == 1 && n < (size_t)width * height / (128 * 8)) refuse("an FFV1 frame of %zu bytes", n);
    alloc_out();
    // the slices, from the frame's end
    const uint8_t* p = buf + n;
    for (int i = slice_count - 1; i >= 0; --i) {
      Slice& s = slices[i];
      const int trailer = 3 + 5 * (ec != 0);
      int64_t v;
      if (i || version > 2) {
        v = trailer > p - buf ? INT64_MAX : (int64_t)(p[-trailer] << 16 | p[-trailer + 1] << 8 | p[-trailer + 2]) + trailer;
      } else {
        v = p - c.start;
      }
      if (p - c.start < v) refuse("a cut or corrupt FFV1 frame (its slices' sizes leave it)");
      p -= v;
      if (ec) {
        if (crc32_ieee(crcref, p, (size_t)v) != crcref) refuse("an FFV1 slice with a bad CRC");
        tally[kSliceCrc] = 1;
      }
      if (i) {
        s.c.init(p, (size_t)v);
      } else {
        s.c = c;
        s.c.end = p + v;
      }
      s.c.zero = states.zero;
      s.c.one = states.one;
    }
    if (slice_count > 1) tally[kMultiSlice] = 1;
    for (int i = 0; i < slice_count; ++i) decode_slice(slices[i], key);
    ++tally[kFrames];
  }

  void alloc_out() {
    int planes = 1;
    if (format == 7 || format == 8) {
      ow[0] = 4 * width;
      oh[0] = height;
    } else {
      ow[0] = width;
      oh[0] = height;
      if (chroma_planes) {
        ow[1] = ow[2] = (width + (1 << h_shift) - 1) >> h_shift;
        oh[1] = oh[2] = (height + (1 << v_shift) - 1) >> v_shift;
        planes = 3;
      }
      if (transparency) {
        ow[3] = width;
        oh[3] = height;
        planes = 4;
      }
    }
    for (int k = 0; k < planes; ++k) out[k].resize((size_t)ow[k] * oh[k]);
  }
};

}  // namespace

extern "C" {

// A decoder for an FFV1 stream of width x height with the container's
// extradata (a version 3 configuration record, or none for versions 0 and
// 1); null with a message when it refuses them.
void* mga_ffv1_new(const uint8_t* extra, int64_t n, int32_t width, int32_t height, char* err, int errlen) {
  Decoder* dec = nullptr;
  guarded(err, errlen, [&] { dec = new Decoder(extra, n, width, height); });
  return dec;
}

void mga_ffv1_free(void* h) { delete static_cast<Decoder*>(h); }

// Decodes one frame. Returns its format (Decoder::format), then gives each of
// four planes' width and height (bytes and rows, 0 for none) in info; -1
// with a message.
int mga_ffv1_decode(void* h, const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  Decoder* dec = static_cast<Decoder*>(h);
  if (guarded(err, errlen, [&] { dec->decode(data, (size_t)n); }) < 0) return -1;
  for (int p = 0; p < 4; ++p) {
    info[2 * p] = dec->out[p].empty() ? 0 : dec->ow[p];
    info[2 * p + 1] = dec->out[p].empty() ? 0 : dec->oh[p];
  }
  return dec->format;
}

// The last frame's planes, each as mga_ffv1_decode's info gives it (null for none).
void mga_ffv1_planes(void* h, uint8_t* p0, uint8_t* p1, uint8_t* p2, uint8_t* p3) {
  const Decoder* dec = static_cast<const Decoder*>(h);
  uint8_t* out[4] = {p0, p1, p2, p3};
  for (int p = 0; p < 4; ++p)
    if (out[p] && !dec->out[p].empty()) memcpy(out[p], dec->out[p].data(), dec->out[p].size());
}

// The tally's first n counts (FFV1_TALLY's order); returns how many it has.
int mga_ffv1_tally(void* h, int64_t* out, int n) {
  const Decoder* dec = static_cast<const Decoder*>(h);
  for (int i = 0; i < n && i < kTallyN; ++i) out[i] = dec->tally[i];
  return kTallyN;
}

}  // extern "C"
