// HuffYUV and FFVHuff decoding on the host, as libavcodec's huffyuvdec.c
// decodes them for cv2 (every frame a key frame).
//
// The stream header is the container's extradata (the BITMAPINFOHEADER's
// tail): byte 0 the predictor (0 left, 1 plane or gradient, 2 median) and,
// in bit 6, RGB decorrelation (G taken from B and R); byte 1 the bits a
// pixel of the classic formats (version 2) or, where byte 3 is not 0
// (FFVHuff's version 3), the sample depth and the chroma shifts; byte 2 the
// interlace choice (1 interlaced, 2 progressive, else by height > 288), the
// per-frame tables flag (0x40, "context") and, in version 3, chroma, YUV
// and alpha; then three run-length coded code-length tables (one a plane in
// version 3), whose canonical codes are built from the lengths, the longest
// codes first. A file without extradata (version 1) takes the classic
// tables below and its predictor from the bits a pixel's low 3 bits.
//
// A frame is read as 32-bit words byte-swapped, then MSB first. YUV 4:2:2
// (16 bits a pixel) and 4:2:0 (12) code their samples in pairs (Y U Y V);
// the first four samples are raw, the rest of the first row left-predicted;
// the plane predictor adds the row above (two above when interlaced, from
// the third row), the median predictor takes the median of left, above and
// left + above - above-left from the second row (after four more
// left-predicted samples; the second row left-predicted when interlaced).
// RGB (24 and 32 bits) is stored bottom-up as G, B - G, R - G (decorrelated;
// else B, G, R) and A differences, left (or plane) predicted in one run
// across the rows. Version 3 codes each plane on
// its own: grey, YUV 4:4:4 / 4:2:2 / 4:2:0 with or without alpha, planar
// RGB. Cut or corrupt frames raise (libavcodec fills what it cannot read).
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

// The classic tables of files without extradata: the luma and chroma code
// lengths (run-length coded as extradata's are) and their codes.
const uint8_t kShiftLuma[] = {34,  36, 35, 69, 135, 232, 9,  16, 10,  24,  11,  23,  12, 16, 13, 10, 14, 8,  15, 8,  16,
                              8,   17, 20, 16, 10,  207, 206, 205, 236, 11, 8,  10, 21, 9,  23, 8,  8,  199, 70, 69, 68};
const uint8_t kShiftChroma[] = {66,  36,  37,  38,  39, 40, 41,  75,  76,  77, 110, 239, 144, 81, 82,  83, 84, 85, 118, 183,
                                56,  57,  88,  89,  56, 89, 154, 57,  58,  57, 26,  141, 57,  56, 58,  57, 58, 57, 184, 119,
                                214, 245, 116, 83,  82, 49, 80,  79,  78,  77, 44,  75,  41,  40, 39,  38, 37, 36, 34};
const uint8_t kAddLuma[256] = {
    3,   9,   5,   12,  10,  35,  32,  29,  27,  50,  48,  45,  44,  41,  39,  37,  73,  70,  68,  65,  64,  61,
    58,  56,  53,  50,  49,  46,  44,  41,  38,  36,  68,  65,  63,  61,  58,  55,  53,  51,  48,  46,  45,  43,
    41,  39,  38,  36,  35,  33,  32,  30,  29,  27,  26,  25,  48,  47,  46,  44,  43,  41,  40,  39,  37,  36,
    35,  34,  32,  31,  30,  28,  27,  26,  24,  23,  22,  20,  19,  37,  35,  34,  33,  31,  30,  29,  27,  26,
    24,  23,  21,  20,  18,  17,  15,  29,  27,  26,  24,  22,  21,  19,  17,  16,  14,  26,  25,  23,  21,  19,
    18,  16,  15,  27,  25,  23,  21,  19,  17,  16,  14,  26,  25,  23,  21,  18,  17,  14,  12,  17,  19,  13,
    4,   9,   2,   11,  1,   7,   8,   0,   16,  3,   14,  6,   12,  10,  5,   15,  18,  11,  10,  13,  15,  16,
    19,  20,  22,  24,  27,  15,  18,  20,  22,  24,  26,  14,  17,  20,  22,  24,  27,  15,  18,  20,  23,  25,
    28,  16,  19,  22,  25,  28,  32,  36,  21,  25,  29,  33,  38,  42,  45,  49,  28,  31,  34,  37,  40,  42,
    44,  47,  49,  50,  52,  54,  56,  57,  59,  60,  62,  64,  66,  67,  69,  35,  37,  39,  40,  42,  43,  45,
    47,  48,  51,  52,  54,  55,  57,  59,  60,  62,  63,  66,  67,  69,  71,  72,  38,  40,  42,  43,  46,  47,
    49,  51,  26,  28,  30,  31,  33,  34,  18,  19,  11,  13,  7,   8};
const uint8_t kAddChroma[256] = {
    3,   1,   2,   2,   2,   2,   3,   3,   7,   5,   7,   5,   8,   6,   11,  9,   7,   13,  11,  10,  9,   8,
    7,   5,   9,   7,   6,   4,   7,   5,   8,   7,   11,  8,   13,  11,  19,  15,  22,  23,  20,  33,  32,  28,
    27,  29,  51,  77,  43,  45,  76,  81,  46,  82,  75,  55,  56,  144, 58,  80,  60,  74,  147, 63,  143, 65,
    66,  67,  68,  69,  70,  71,  72,  73,  74,  75,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,
    88,  89,  90,  91,  27,  30,  21,  22,  17,  14,  5,   6,   100, 54,  47,  50,  51,  53,  106, 107, 108, 109,
    110, 111, 112, 113, 114, 115, 4,   117, 118, 92,  94,  121, 122, 3,   124, 103, 2,   1,   0,   129, 130, 131,
    120, 119, 126, 125, 136, 137, 138, 139, 140, 141, 142, 134, 135, 132, 133, 104, 64,  101, 62,  57,  102, 95,
    93,  59,  61,  28,  97,  96,  52,  49,  48,  29,  32,  25,  24,  46,  23,  98,  45,  44,  43,  20,  42,  41,
    19,  18,  99,  40,  15,  39,  38,  16,  13,  12,  11,  37,  10,  9,   8,   36,  7,   128, 127, 105, 123, 116,
    35,  34,  33,  145, 31,  79,  42,  146, 78,  26,  83,  48,  49,  50,  44,  47,  26,  31,  30,  18,  17,  19,
    21,  24,  25,  13,  14,  16,  17,  18,  20,  21,  12,  14,  15,  9,   10,  6,   9,   6,   5,   8,   6,   12,
    8,   10,  7,   9,   6,   4,   6,   2,   2,   3,   3,   3,   3,   2};

// What a decoder counts (HUFFYUV_TALLY's order in __init__.py).
enum Tally {
  kFrames, kHuffyuv, kFfvhuff, kV1Classic, kV2, kV3, kPredLeft, kPredPlane, kPredMedian, kDecorrelate, kInterlaced,
  kPerFrameTables, kYuv422, kYuv420, kRgb24, kRgb32, kGray, kYuv444, kYuva, kGbrp, kOddWidth, kLongCodes,
  kTallyN
};

// MSB-first bits over a byte-swapped copy of a frame's whole 32-bit words.
struct Bits {
  const uint8_t* p = nullptr;
  int64_t n = 0, pos = 0;  // in bits
  uint32_t peek(int k) const {  // the next k (1..32) bits, zeros past the end
    int64_t byte = pos >> 3;
    uint64_t v = 0;
    if (byte + 8 <= (n >> 3)) {
      memcpy(&v, p + byte, 8);
      v = __builtin_bswap64(v);
    } else {
      for (int i = 0; i < 8; ++i, ++byte) v = (v << 8) | (byte < (n >> 3) ? p[byte] : 0);
    }
    return (uint32_t)((v << (pos & 7)) >> (64 - k));
  }
  uint32_t get(int k) {
    const uint32_t v = peek(k);
    pos += k;
    return v;
  }
  void check() const {
    if (pos > n) refuse("a cut or corrupt frame: %lld bits read of %lld", (long long)pos, (long long)n);
  }
};

// A canonical code of up to 256 symbols from its lengths, as
// ff_huffyuv_generate_bits_table builds it: a lookup of kRoot bits, then the
// longer codes by length.
struct Vlc {
  static constexpr int kRoot = 12;
  std::vector<int16_t> sym, len;  // by the next kRoot bits; len 0: a longer code (or none)
  std::vector<uint32_t> code;
  std::vector<uint8_t> lens;
  int n = 0;
  bool longer = false;
  int64_t* long_count = nullptr;

  void build(const uint8_t* l, int count) {
    std::vector<uint32_t> codes(count, 0);
    uint32_t bits = 0;
    for (int k = 32; k > 0; --k) {
      for (int i = 0; i < count; ++i)
        if (l[i] == k) codes[i] = bits++;
      if (bits & 1) refuse("a code-length table that does not make a prefix code (lengths of %d bits)", k);
      bits >>= 1;
    }
    assign(l, codes.data(), count);
  }
  // The lookup of the codes of the given lengths (0: a symbol not coded).
  template <class C>
  void assign(const uint8_t* l, const C* c, int count) {
    n = count;
    lens.assign(l, l + count);
    code.assign(c, c + count);
    sym.assign(1 << kRoot, -1);
    len.assign(1 << kRoot, 0);
    longer = false;
    for (int i = 0; i < count; ++i) {
      if (!lens[i]) continue;
      if (lens[i] < 32 && code[i] >> lens[i]) refuse("a code-length table that overflows (symbol %d)", i);
      if (lens[i] > kRoot) {
        longer = true;
        continue;
      }
      const int shift = kRoot - lens[i];
      for (uint32_t j = 0; j < (1u << shift); ++j) {
        sym[(code[i] << shift) | j] = (int16_t)i;
        len[(code[i] << shift) | j] = lens[i];
      }
    }
  }
  int read(Bits& b) const {
    const uint32_t top = b.peek(kRoot);
    if (len[top]) {
      b.pos += len[top];
      return sym[top];
    }
    if (longer)
      for (int k = kRoot + 1; k <= 31; ++k) {
        const uint32_t v = b.peek(k);
        for (int i = 0; i < n; ++i)
          if (lens[i] == k && code[i] == v) {
            b.pos += k;
            if (long_count) ++*long_count;
            return i;
          }
      }
    refuse("an invalid Huffman code at bit %lld", (long long)b.pos);
  }
};

inline uint8_t mid_pred(int a, int b, int c) {
  return (uint8_t)std::max(std::min(a, b), std::min(std::max(a, b), c));
}

struct Decoder {
  bool ffvhuff;
  int version = 0, predictor = 0, bitstream_bpp = 0, bps = 8;
  bool decorrelate = false, interlaced = false, context = false, yuv = false, chroma = true, alpha = false;
  int chroma_h_shift = 0, chroma_v_shift = 0;
  int width, height;
  int format = 0;  // 0 yuv422p, 1 yuv420p, 2 bgr0, 3 bgra, 4 gray, 5 yuv444p, 6 gbrp, 7 yuva420p, 8 yuva422p, 9 yuva444p
  Vlc vlc[4];
  std::vector<uint8_t> planes[4];  // the frame: formats 2-3 one packed plane, else Y (G), U (B), V (R), A
  int pw[4] = {0}, ph[4] = {0};
  std::vector<uint8_t> swapped;
  uint8_t temp[3][1 << 16] = {};  // a row's decoded differences (bgr: 4 a pixel)
  std::vector<uint8_t> rgb_temp;
  int64_t tally[kTallyN] = {};

  static int read_len_table(Bits& b, uint8_t* dst, int n) {
    for (int i = 0; i < n;) {
      int repeat = (int)b.get(3);
      const int val = (int)b.get(5);
      if (!repeat) repeat = (int)b.get(8);
      if (i + repeat > n || b.pos > b.n) refuse("a code-length table that overflows (%d lengths for %d symbols)",
                                                i + repeat, n);
      while (repeat--) dst[i++] = (uint8_t)val;
    }
    return 0;
  }

  // The tables at data (extradata's tail, or a frame's start); returns the bytes they take.
  int64_t read_tables(const uint8_t* data, int64_t size) {
    Bits b;
    b.p = data;
    b.n = size * 8;
    const int count = version > 2 ? 1 + alpha + 2 * chroma : 3;
    uint8_t lens[256];
    for (int i = 0; i < count; ++i) {
      read_len_table(b, lens, 256);
      vlc[i].build(lens, 256);
      vlc[i].long_count = &tally[kLongCodes];
    }
    return (b.pos + 7) / 8;
  }

  void classic_tables() {
    uint8_t luma[256], chr[256];
    Bits b;
    b.p = kShiftLuma;
    b.n = sizeof kShiftLuma * 8;
    read_len_table(b, luma, 256);
    b = Bits();
    b.p = kShiftChroma;
    b.n = sizeof kShiftChroma * 8;
    read_len_table(b, chr, 256);
    const bool rgb = bitstream_bpp >= 24;  // RGB takes the luma table for all three
    for (int t = 0; t < 3; ++t) {
      vlc[t].assign(t == 0 || rgb ? luma : chr, t == 0 || rgb ? kAddLuma : kAddChroma, 256);
      vlc[t].long_count = &tally[kLongCodes];
    }
  }

  Decoder(bool ffvh, const uint8_t* extra, int64_t n, int bits_per_coded_sample, int w, int h)
      : ffvhuff(ffvh), width(w), height(h) {
    if (w <= 0 || h <= 0 || w > 16384 || h > 16384) refuse("a picture of %d x %d (1 to 16384 a side)", w, h);
    tally[ffvh ? kFfvhuff : kHuffyuv] = 1;
    interlaced = h > 288;
    if (n > 0) {
      if ((bits_per_coded_sample & 7) && bits_per_coded_sample != 12)
        version = 1;
      else if (n > 3 && extra[3] == 0)
        version = 2;
      else
        version = 3;
    }
    if (version >= 2) {
      if (n < 4) refuse("extradata of %lld bytes (4 at least)", (long long)n);
      decorrelate = extra[0] & 64;
      predictor = extra[0] & 63;
      if (version == 2) {
        bitstream_bpp = extra[1] ? extra[1] : bits_per_coded_sample & ~7;
      } else {
        bps = (extra[1] >> 4) + 1;
        chroma_h_shift = extra[1] & 3;
        chroma_v_shift = (extra[1] >> 2) & 3;
        yuv = extra[2] & 1;
        chroma = extra[2] & 3;
        alpha = extra[2] & 4;
      }
      const int interlace = (extra[2] & 0x30) >> 4;
      interlaced = interlace == 1 ? true : interlace == 2 ? false : interlaced;
      context = extra[2] & 0x40;
      if (bps != 8) refuse("FFVHuff of %d bits a sample", bps);
      read_tables(extra + 4, n - 4);
      tally[version == 2 ? kV2 : kV3] = 1;
    } else {
      const int mode = bits_per_coded_sample & 7;
      predictor = mode == 3 ? 1 : mode == 4 ? 2 : 0;
      decorrelate = mode == 2 || (mode == 3 && bits_per_coded_sample >= 24);
      bitstream_bpp = bits_per_coded_sample & ~7;
      classic_tables();
      tally[kV1Classic] = 1;
    }
    if (predictor > 2) refuse("the HuffYUV predictor %d", predictor);
    if (version <= 2) {
      switch (bitstream_bpp) {
        case 12: format = 1; yuv = true; chroma_h_shift = chroma_v_shift = 1; break;
        case 16: format = 0; yuv = true; chroma_h_shift = 1; break;
        case 24: format = 2; break;
        case 32: format = 3; alpha = true; break;
        default: refuse("HuffYUV of %d bits a pixel", bitstream_bpp);
      }
      if (yuv && (w & 1)) refuse("HuffYUV YUV of odd width %d", w);
      if (format == 1 && (h & 1)) refuse("HuffYUV 4:2:0 of odd height %d", h);
      if (!yuv && predictor == 2) refuse("HuffYUV RGB with the median predictor (libavcodec does not decode it)");
    } else {
      if (bps != 8) refuse("FFVHuff of %d bits a sample", bps);
      const int key = (chroma << 10) | (yuv << 9) | (alpha << 8) | chroma_h_shift | (chroma_v_shift << 2);
      switch (key) {
        case 0x000: format = 4; break;
        case 0x600: format = 5; break;
        case 0x601: format = 0; break;
        case 0x605: format = 1; break;
        case 0x400: format = 6; break;
        case 0x705: format = 7; break;
        case 0x701: format = 8; break;
        case 0x700: format = 9; break;
        default: refuse("FFVHuff of pixel format 0x%03x", key);
      }
      if ((chroma_h_shift && (w & 1)) || (chroma_v_shift && (h & 1)))
        refuse("FFVHuff subsampled chroma of an odd size %d x %d", w, h);
    }
    // the frame's planes
    if (format == 2 || format == 3) {
      pw[0] = 4 * w;
      ph[0] = h;
    } else {
      const int planes_n = format == 4 ? 1 : (format >= 7 ? 4 : 3);
      for (int p = 0; p < planes_n; ++p) {
        const bool sub = (p == 1 || p == 2) && format != 6;
        pw[p] = sub ? (w + (1 << chroma_h_shift) - 1) >> chroma_h_shift : w;
        ph[p] = sub ? (h + (1 << chroma_v_shift) - 1) >> chroma_v_shift : h;
        if (format == 0 || format == 8) ph[p] = h;
      }
    }
    for (int p = 0; p < 4; ++p) planes[p].assign((size_t)pw[p] * ph[p], 0);
    if (w + 8 > (int)sizeof temp[0] / 4) refuse("a picture %d wide", w);
    if (predictor == 2 && format == 0 && (w & 3))
      refuse("HuffYUV 4:2:2 with the median predictor at a width of %d (libavcodec wants a multiple of 4)", w);
    tally[predictor == 0 ? kPredLeft : predictor == 1 ? kPredPlane : kPredMedian] = 1;
    if (decorrelate) tally[kDecorrelate] = 1;
    if (interlaced) tally[kInterlaced] = 1;
    if (context) tally[kPerFrameTables] = 1;
    const int kinds[] = {kYuv422, kYuv420, kRgb24, kRgb32, kGray, kYuv444, kGbrp, kYuva, kYuva, kYuva};
    tally[kinds[format]] = 1;
    if (w & 1) tally[kOddWidth] = 1;
  }

  uint8_t* row(int p, int y) { return planes[p].data() + (size_t)y * pw[p]; }

  static int left_pred(uint8_t* dst, const uint8_t* src, int w, int acc) {
    for (int i = 0; i < w; ++i) {
      acc += src[i];
      dst[i] = (uint8_t)acc;
    }
    return acc;
  }
  static void add_bytes(uint8_t* dst, const uint8_t* src, int w) {
    for (int i = 0; i < w; ++i) dst[i] = (uint8_t)(dst[i] + src[i]);
  }
  static void median_pred(uint8_t* dst, const uint8_t* src1, const uint8_t* diff, int w, int* left, int* left_top) {
    uint8_t l = (uint8_t)*left, lt = (uint8_t)*left_top;
    for (int i = 0; i < w; ++i) {
      l = (uint8_t)(mid_pred(l, src1[i], (l + src1[i] - lt) & 0xFF) + diff[i]);
      lt = src1[i];
      dst[i] = l;
    }
    *left = l;
    *left_top = lt;
  }

  void read_422(Bits& b, int count) {  // count samples of luma: Y U Y V pairs
    count /= 2;
    for (int i = 0; i < count; ++i) {
      temp[0][2 * i] = (uint8_t)vlc[0].read(b);
      temp[1][i] = (uint8_t)vlc[1].read(b);
      temp[0][2 * i + 1] = (uint8_t)vlc[0].read(b);
      temp[2][i] = (uint8_t)vlc[2].read(b);
    }
  }
  void read_gray(Bits& b, int count) {
    count /= 2;
    for (int i = 0; i < count; ++i) {
      temp[0][2 * i] = (uint8_t)vlc[0].read(b);
      temp[0][2 * i + 1] = (uint8_t)vlc[0].read(b);
    }
  }
  void read_plane(Bits& b, int w, int plane) {
    for (int i = 0; i < (w & ~1); ++i) temp[0][i] = (uint8_t)vlc[plane].read(b);
    if (w & 1) temp[0][w - 1] = (uint8_t)vlc[plane].read(b);
  }
  void read_bgr(Bits& b, int count) {
    for (int i = 0; i < count; ++i) {
      uint8_t* t = &rgb_temp[4 * (size_t)i];
      if (decorrelate) {  // G, then B and R less G
        const int g = vlc[1].read(b);
        t[1] = (uint8_t)g;
        t[0] = (uint8_t)(vlc[0].read(b) + g);
        t[2] = (uint8_t)(vlc[2].read(b) + g);
      } else {  // B, G, R
        t[0] = (uint8_t)vlc[0].read(b);
        t[1] = (uint8_t)vlc[1].read(b);
        t[2] = (uint8_t)vlc[2].read(b);
      }
      if (format == 3) t[3] = (uint8_t)vlc[2].read(b);
    }
  }

  void decode(const uint8_t* data, int64_t n) {
    const int64_t words = n / 4;
    swapped.assign((size_t)words * 4 + 8, 0);
    for (int64_t i = 0; i < words; ++i)
      for (int k = 0; k < 4; ++k) swapped[(size_t)(4 * i + k)] = data[4 * i + 3 - k];
    int64_t table_size = 0;
    if (context) table_size = read_tables(swapped.data(), words * 4);
    Bits b;
    b.p = swapped.data() + table_size;
    b.n = (words * 4 - table_size) * 8;
    if (b.n <= 0) refuse("an empty frame");
    const int w = width, h = height, w2 = w >> 1;
    const int fy = interlaced ? 2 : 1;  // the rows the plane and median predictors look up
    if (version > 2) {
      for (int plane = 0; plane < 1 + 2 * chroma + alpha; ++plane) {
        int pwid = w, phgt = h;
        if (chroma && (plane == 1 || plane == 2)) {
          pwid >>= chroma_h_shift;
          phgt >>= chroma_v_shift;
        }
        if (predictor != 2) {
          read_plane(b, pwid, plane);
          int left = left_pred(row(plane, 0), temp[0], pwid, 0);
          for (int y = 1; y < phgt; ++y) {
            read_plane(b, pwid, plane);
            left = left_pred(row(plane, y), temp[0], pwid, left);
            if (predictor == 1 && y > (int)interlaced) add_bytes(row(plane, y), row(plane, y - fy), pwid);
          }
        } else {
          read_plane(b, pwid, plane);
          int left = left_pred(row(plane, 0), temp[0], pwid, 0);
          int y = 1;
          if (y >= phgt) continue;
          if (interlaced) {
            read_plane(b, pwid, plane);
            left = left_pred(row(plane, 1), temp[0], pwid, left);
            if (++y >= phgt) continue;
          }
          int lefttop = row(plane, 0)[0];
          read_plane(b, pwid, plane);
          median_pred(row(plane, fy), row(plane, 0), temp[0], pwid, &left, &lefttop);
          for (++y; y < phgt; ++y) {
            read_plane(b, pwid, plane);
            median_pred(row(plane, y), row(plane, y - fy), temp[0], pwid, &left, &lefttop);
          }
        }
      }
    } else if (bitstream_bpp < 24) {
      int leftv = row(2, 0)[0] = (uint8_t)b.get(8);
      int lefty = row(0, 0)[1] = (uint8_t)b.get(8);
      int leftu = row(1, 0)[0] = (uint8_t)b.get(8);
      row(0, 0)[0] = (uint8_t)b.get(8);
      const bool c420 = bitstream_bpp == 12;
      auto crow = [&](int p, int cy) { return row(p, cy); };
      if (predictor != 2) {
        read_422(b, w - 2);
        lefty = left_pred(row(0, 0) + 2, temp[0], w - 2, lefty);
        leftu = left_pred(row(1, 0) + 1, temp[1], w2 - 1, leftu);
        leftv = left_pred(row(2, 0) + 1, temp[2], w2 - 1, leftv);
        for (int cy = 1, y = 1; y < h; ++y, ++cy) {
          if (c420) {
            read_gray(b, w);
            uint8_t* yd = row(0, y);
            lefty = left_pred(yd, temp[0], w, lefty);
            if (predictor == 1 && y > (int)interlaced) add_bytes(yd, row(0, y - fy), w);
            if (++y >= h) break;
          }
          uint8_t *yd = row(0, y), *ud = crow(1, cy), *vd = crow(2, cy);
          read_422(b, w);
          lefty = left_pred(yd, temp[0], w, lefty);
          leftu = left_pred(ud, temp[1], w2, leftu);
          leftv = left_pred(vd, temp[2], w2, leftv);
          if (predictor == 1 && cy > (int)interlaced) {
            add_bytes(yd, row(0, y - fy), w);
            add_bytes(ud, crow(1, cy - fy), w2);
            add_bytes(vd, crow(2, cy - fy), w2);
          }
        }
      } else {
        read_422(b, w - 2);
        lefty = left_pred(row(0, 0) + 2, temp[0], w - 2, lefty);
        leftu = left_pred(row(1, 0) + 1, temp[1], w2 - 1, leftu);
        leftv = left_pred(row(2, 0) + 1, temp[2], w2 - 1, leftv);
        int y = 1, cy = 1;
        if (y < h) {
          bool done = false;
          if (interlaced) {
            read_422(b, w);
            lefty = left_pred(row(0, 1), temp[0], w, lefty);
            leftu = left_pred(crow(1, 1), temp[1], w2, leftu);
            leftv = left_pred(crow(2, 1), temp[2], w2, leftv);
            ++y;
            ++cy;
            done = y >= h;
          }
          if (!done) {
            read_422(b, 4);  // the next four samples left-predicted too
            lefty = left_pred(row(0, fy), temp[0], 4, lefty);
            leftu = left_pred(crow(1, fy), temp[1], 2, leftu);
            leftv = left_pred(crow(2, fy), temp[2], 2, leftv);
            int lefttopy = row(0, 0)[3];
            read_422(b, w - 4);
            median_pred(row(0, fy) + 4, row(0, 0) + 4, temp[0], w - 4, &lefty, &lefttopy);
            int lefttopu = crow(1, 0)[1], lefttopv = crow(2, 0)[1];
            median_pred(crow(1, fy) + 2, crow(1, 0) + 2, temp[1], w2 - 2, &leftu, &lefttopu);
            median_pred(crow(2, fy) + 2, crow(2, 0) + 2, temp[2], w2 - 2, &leftv, &lefttopv);
            ++y;
            ++cy;
            for (; y < h; ++y, ++cy) {
              if (c420) {
                while (2 * cy > y) {
                  read_gray(b, w);
                  median_pred(row(0, y), row(0, y - fy), temp[0], w, &lefty, &lefttopy);
                  ++y;
                }
                if (y >= h) break;
              }
              read_422(b, w);
              median_pred(row(0, y), row(0, y - fy), temp[0], w, &lefty, &lefttopy);
              median_pred(crow(1, cy), crow(1, cy - fy), temp[1], w2, &leftu, &lefttopu);
              median_pred(crow(2, cy), crow(2, cy - fy), temp[2], w2, &leftv, &lefttopv);
            }
          }
        }
      }
    } else {
      rgb_temp.assign((size_t)4 * w, 0);
      uint8_t left[4];
      uint8_t* last = row(0, h - 1);
      if (bitstream_bpp == 32) {
        left[3] = last[3] = (uint8_t)b.get(8);
        left[2] = last[2] = (uint8_t)b.get(8);
        left[1] = last[1] = (uint8_t)b.get(8);
        left[0] = last[0] = (uint8_t)b.get(8);
      } else {
        left[2] = last[2] = (uint8_t)b.get(8);
        left[1] = last[1] = (uint8_t)b.get(8);
        left[0] = last[0] = (uint8_t)b.get(8);
        left[3] = last[3] = 255;
        b.get(8);
      }
      auto bgr_left = [&](uint8_t* dst, int count) {
        for (int i = 0; i < count; ++i)
          for (int k = 0; k < 4; ++k) dst[4 * i + k] = left[k] = (uint8_t)(left[k] + rgb_temp[4 * (size_t)i + k]);
      };
      read_bgr(b, w - 1);
      bgr_left(last + 4, w - 1);
      for (int y = h - 2; y >= 0; --y) {  // stored upside down
        read_bgr(b, w);
        bgr_left(row(0, y), w);
        if (predictor == 1) {
          if (bitstream_bpp != 32) left[3] = 0;
          if (y < h - 1 - (int)interlaced) add_bytes(row(0, y), row(0, y + fy), 4 * w);
        }
      }
    }
    b.check();
    ++tally[kFrames];
  }
};

}  // namespace

extern "C" {

// A decoder for a HuffYUV (ffvhuff 0) or FFVHuff (1) stream of width x height
// with the container's extradata and bits a pixel (BITMAPINFOHEADER
// biBitCount); null with a message when it refuses them. info: the frame's
// format (Decoder::format), then each of four planes' width and height
// (bytes and rows; 0 for none).
void* mga_huffyuv_new(int32_t ffvhuff, const uint8_t* extra, int64_t n, int32_t bits_per_coded_sample, int32_t width,
                      int32_t height, int32_t* info, char* err, int errlen) {
  Decoder* dec = nullptr;
  if (guarded(err, errlen, [&] { dec = new Decoder(ffvhuff != 0, extra, n, bits_per_coded_sample, width, height); }))
    return nullptr;
  info[0] = dec->format;
  for (int p = 0; p < 4; ++p) {
    info[1 + 2 * p] = dec->pw[p];
    info[2 + 2 * p] = dec->ph[p];
  }
  return dec;
}

void mga_huffyuv_free(void* h) { delete static_cast<Decoder*>(h); }

// Decodes one frame into the four planes (each as wide and high as new's
// info gives; null for none). Returns 0, or -1 with a message.
int mga_huffyuv_decode(void* h, const uint8_t* data, int64_t n, uint8_t* p0, uint8_t* p1, uint8_t* p2, uint8_t* p3,
                       char* err, int errlen) {
  Decoder* dec = static_cast<Decoder*>(h);
  if (guarded(err, errlen, [&] { dec->decode(data, n); }) < 0) return -1;
  uint8_t* out[4] = {p0, p1, p2, p3};
  for (int p = 0; p < 4; ++p)
    if (out[p] && !dec->planes[p].empty()) memcpy(out[p], dec->planes[p].data(), dec->planes[p].size());
  return 0;
}

// The tally's first n counts (HUFFYUV_TALLY's order); returns how many it has.
int mga_huffyuv_tally(void* h, int64_t* out, int n) {
  const Decoder* dec = static_cast<const Decoder*>(h);
  for (int i = 0; i < n && i < kTallyN; ++i) out[i] = dec->tally[i];
  return kTallyN;
}

}  // extern "C"
