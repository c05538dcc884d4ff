// JPEG decoding and encoding on the host, computing what libjpeg(-turbo)
// computes under OpenCV's settings, so the port reads and writes the JPEG
// files that cv2 reads and writes, to the bit.
//
// Decoding: Huffman-coded 8-bit JPEG with 1 or 3 components: baseline
// (SOF0), extended sequential (SOF1) and progressive (SOF2) frames, restart
// intervals, interleaved and non-interleaved scans, any integral sampling
// ratio. Samples come out as libjpeg's defaults make them: the ISLOW inverse
// DCT (jidctint.c), fancy upsampling (jdsample.c: h2v1 and h2v2 triangle
// filters with alternating bias, libjpeg-turbo's h1v2 filter, replication for
// other ratios) and jdcolor.c's fixed-point YCbCr -> RGB. A grey read of a
// colour file is the luma plane (jdcolor.c's RGB -> grey for an RGB file).
// The EXIF orientation is applied, as cv2.imread and cv2.imdecode do.
//
// A sequential scan that uses Huffman table 0 or 1 where no DHT defined it
// gets the standard Annex K.3 table, as in libjpeg-turbo (MJPEG frames often
// carry no DHT); a progressive one is refused, as there.
//
// mga_jpeg_decode_planes serves the video path: the component planes as
// ffmpeg's MJPEG decoder reconstructs them (its simple IDCT,
// simple_idct.h), at their own sampled size, for yuv.cpp to convert as
// ffmpeg's swscale does.
//
// Refused with a message: 4 components (CMYK/YCCK), 12-bit samples,
// arithmetic coding, lossless and hierarchical frames, more than 2^30
// pixels, and any truncated or corrupt stream (libjpeg pads those with grey
// and warns; the port raises). A progressive file whose scans leave one of
// the first nine AC coefficients unrefined is refused too: libjpeg smooths
// such blocks (jdcoefct.c block smoothing), which this decoder does not.
//
// Encoding: baseline JPEG as cv2.imencode(".jpg") writes it: the JFIF APP0,
// the Annex K tables scaled by jpeg_quality_scaling (clamped to 255), 4:2:0
// for colour and one component for grey, the standard Huffman tables,
// jccolor.c's RGB -> YCbCr, jcsample.c's h2v2 downsampling with its 1, 2
// bias, edge replication to whole MCUs, the ISLOW forward DCT and rounded
// quantisation.
//
// No global state: every call owns its buffers, so handler threads and
// loader threads may decode at once. Every read of the input is bounds-checked.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
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

// Zigzag position -> natural (row-major) position in an 8x8 block.
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int64_t kMaxPixels = int64_t(1) << 30;  // cv2's CV_IO_MAX_IMAGE_PIXELS

inline int clamp_int(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// ------------------------------------------------------------------ Huffman

// The standard tables (Annex K.3): the encoder writes them, and the decoder
// loads them for a sequential scan that uses table 0 or 1 when no DHT
// defined it, as libjpeg-turbo does (jdhuff.c, jstdhuff.c).
constexpr uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5,
    0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa};
constexpr uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0,
    0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8,
    0xf9, 0xfa};


struct HuffTable {
  bool defined = false;
  uint8_t fast_len[512];  // codes of <= 9 bits, looked up by the next 9 bits
  uint8_t fast_val[512];
  int32_t maxcode[17];    // largest code of each length, -1 if none
  int32_t valoff[17];     // value index = code + valoff[length]
  uint8_t vals[256];
};

// The decoding tables of one DHT entry (jdhuff.c jpeg_make_d_derived_tbl's checks).
void build_table(HuffTable& t, const uint8_t* counts, const uint8_t* vals, int nvals, bool dc) {
  std::memset(t.fast_len, 0, sizeof t.fast_len);
  std::memcpy(t.vals, vals, (size_t)nvals);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    const int n = counts[len - 1];
    t.valoff[len] = k - code;
    for (int i = 0; i < n; ++i, ++k, ++code) {
      if (code >= (1 << len)) refuse("corrupt JPEG data: bad Huffman table");  // before it indexes fast_*
      if (len <= 9) {
        const int lo = code << (9 - len), hi = (code + 1) << (9 - len);
        for (int j = lo; j < hi; ++j) {
          t.fast_len[j] = (uint8_t)len;
          t.fast_val[j] = vals[k];
        }
      }
    }
    if (n && code >= (1 << len)) refuse("corrupt JPEG data: bad Huffman table");
    t.maxcode[len] = n ? code - 1 : -1;
    code <<= 1;
  }
  if (dc)
    for (int i = 0; i < nvals; ++i)
      if (vals[i] > 15) refuse("corrupt JPEG data: bad Huffman table");
  t.defined = true;
}

// A table that no DHT defined: the standard one for numbers 0 and 1 in a
// sequential scan, else refused (libjpeg-turbo refuses it in a progressive scan).
void std_table(HuffTable& t, int number, bool dc, bool progressive) {
  if (number > 1 || progressive) refuse("corrupt JPEG data: Huffman table %d is not defined", number);
  if (dc) build_table(t, number ? kDcChromaBits : kDcLumaBits, kDcVals, 12, true);
  else build_table(t, number ? kAcChromaBits : kAcLumaBits, number ? kAcChromaVals : kAcLumaVals, 162, false);
}

// Entropy-coded bits: 0xFF00 unstuffed; at a marker or the end of the data
// zeros are fed, and counted, so a scan that reads past its data is caught.
struct Bits {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int nbits = 0;
  int64_t fake = 0;  // zero bits fed past the data, still counted in nbits or consumed
  bool at_marker = false;

  Bits(const uint8_t* d_, size_t n_, size_t pos_) : d(d_), n(n_), pos(pos_) {}

  void fill() {
    while (nbits <= 56) {
      uint32_t b = 0;
      if (!at_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          if (pos + 1 < n && d[pos + 1] == 0x00) {
            pos += 2;
          } else {
            at_marker = true;
            b = 0;
            fake += 8;
          }
        } else {
          ++pos;
        }
      } else {
        fake += 8;
      }
      acc |= (uint64_t)b << (56 - nbits);
      nbits += 8;
    }
  }
  inline void ensure() {
    if (nbits < 32) fill();
  }
  inline uint32_t peek(int k) const { return (uint32_t)(acc >> (64 - k)); }
  inline void skip(int k) {
    acc <<= k;
    nbits -= k;
  }
  inline int get(int k) {  // k <= 16, after ensure()
    if (k == 0) return 0;
    const int v = (int)peek(k);
    skip(k);
    return v;
  }
  // True once a read went past the data (consumed a fed zero).
  bool overran() const { return fake > nbits; }
  // Drop the bits left in the buffer and every fed zero (at a restart marker).
  void reset() {
    acc = 0;
    nbits = 0;
    fake = 0;
    at_marker = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

inline int decode_symbol(Bits& br, const HuffTable& t) {
  const uint32_t p9 = br.peek(9);
  const int len = t.fast_len[p9];
  if (len) {
    br.skip(len);
    return t.fast_val[p9];
  }
  const uint32_t p16 = br.peek(16);
  for (int l = 10; l <= 16; ++l) {
    const int c = (int)(p16 >> (16 - l));
    if (c <= t.maxcode[l]) {
      br.skip(l);
      return t.vals[c + t.valoff[l]];
    }
  }
  refuse("corrupt JPEG data: bad Huffman code");
}

// ------------------------------------------------------------------ decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int ds_w = 0, ds_h = 0;  // samples: ceil(W h / hmax), ceil(H v / vmax)
  int bw = 0, bh = 0;      // blocks holding samples: ceil(ds_w / 8), ceil(ds_h / 8)
  int aw = 0, ah = 0;      // blocks allocated: whole MCUs of an interleaved scan
  bool qlatched = false;
  uint16_t q[64];          // natural order, latched at the component's first scan
  int coef_bits[64];       // progressive: the last bit received of each coefficient, -1 none
  std::vector<int16_t> coef;
  int dc_pred = 0;
  int16_t* block(int row, int col) { return coef.data() + ((size_t)row * aw + col) * 64; }
};

struct Scan {
  int ns = 0;
  int ci[4];
  int td[4], ta[4];
  int ss = 0, se = 63, ah = 0, al = 0;
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_def[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int orientation = 0;  // EXIF, 0 when absent
  bool frame = false, progressive = false, scanned = false;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[3];
  int eobrun = 0;

  Decoder(const uint8_t* d_, size_t n_) : d(d_), n(n_) {}

  int u16(size_t p) const {
    if (p + 2 > n) refuse("truncated JPEG");
    return (d[p] << 8) | d[p + 1];
  }

  // The next marker code, past fill bytes and any stray bytes; -1 at the end.
  int next_marker() {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) ++pos;
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) return -1;
      const int m = d[pos++];
      if (m != 0) return m;
    }
  }

  // Reads markers up to the frame header (headers_only) or to EOI.
  void run(bool headers_only) {
    if (n < 3 || d[0] != 0xFF || d[1] != 0xD8) refuse("not a JPEG file");
    pos = 2;
    for (;;) {
      const int m = next_marker();
      if (m < 0) refuse("truncated JPEG: no EOI marker");
      if (m == 0xD9) break;  // EOI
      if (m == 0xD8) refuse("corrupt JPEG data: a second SOI marker");
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM, a stray RSTn: no length
      const int len = u16(pos);
      if (len < 2 || pos + (size_t)len > n) refuse("truncated JPEG: marker 0x%02X segment", m);
      const uint8_t* seg = d + pos + 2;
      const int sl = len - 2;
      pos += (size_t)len;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          read_frame(seg, sl, m == 0xC2);
          if (headers_only) return;
          break;
        case 0xC3: refuse("lossless JPEG (SOF3) is not supported");
        case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
          refuse("hierarchical JPEG (SOF%d) is not supported", m - 0xC0);
        case 0xC9: case 0xCA: case 0xCB:
          refuse("arithmetic-coded JPEG (SOF%d) is not supported", m - 0xC0);
        case 0xC4: read_dht(seg, sl); break;
        case 0xCC: refuse("arithmetic-coded JPEG (DAC marker) is not supported");
        case 0xDB: read_dqt(seg, sl); break;
        case 0xDD:
          if (sl < 2) refuse("corrupt JPEG data: DRI segment");
          restart_interval = (seg[0] << 8) | seg[1];
          break;
        case 0xDC: refuse("JPEG with a DNL marker is not supported");
        case 0xDA: {
          if (!frame) refuse("corrupt JPEG data: scan before the frame header");
          Scan s = read_sos(seg, sl);
          decode_scan(s);
          scanned = true;
          break;
        }
        case 0xE0:
          if (!scanned && sl >= 14 && std::memcmp(seg, "JFIF\0", 5) == 0) saw_jfif = true;
          break;
        case 0xE1:
          if (!scanned && orientation == 0) orientation = exif_orientation(seg, sl);
          break;
        case 0xEE:
          if (!scanned && sl >= 12 && std::memcmp(seg, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = seg[11];
          }
          break;
        default: break;  // other APPn, COM, JPGn
      }
    }
    if (headers_only) refuse("JPEG without a frame header");
    if (!scanned) refuse("JPEG without image data");
  }

  // Orientation (1-8) from an APP1 body: the EXIF IFD0 tag 0x0112, 0 if absent.
  static int exif_orientation(const uint8_t* s, int sl) {
    if (sl < 14 || std::memcmp(s, "Exif\0\0", 6) != 0) return 0;
    const uint8_t* t = s + 6;
    const int64_t tl = sl - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return 0;
    auto rd16 = [&](int64_t p) { return le ? (t[p] | (t[p + 1] << 8)) : ((t[p] << 8) | t[p + 1]); };
    auto rd32 = [&](int64_t p) {
      return le ? ((uint32_t)t[p] | ((uint32_t)t[p + 1] << 8) | ((uint32_t)t[p + 2] << 16) | ((uint32_t)t[p + 3] << 24))
                : (((uint32_t)t[p] << 24) | ((uint32_t)t[p + 1] << 16) | ((uint32_t)t[p + 2] << 8) | (uint32_t)t[p + 3]);
    };
    const int64_t ifd = rd32(4);
    if (tl < ifd + 2) return 0;
    const int cnt = rd16(ifd);
    for (int i = 0; i < cnt; ++i) {
      const int64_t e = ifd + 2 + 12 * (int64_t)i;
      if (tl < e + 12) return 0;
      if (rd16(e) == 0x0112) {
        const int v = rd16(e + 8);
        return (v >= 1 && v <= 8) ? v : 0;
      }
    }
    return 0;
  }

  void read_dqt(const uint8_t* s, int sl) {
    int p = 0;
    while (p < sl) {
      const int pq = s[p] >> 4, tq = s[p] & 15;
      ++p;
      if (tq > 3 || pq > 1) refuse("corrupt JPEG data: DQT segment");
      if (p + 64 * (pq + 1) > sl) refuse("corrupt JPEG data: DQT segment");
      for (int k = 0; k < 64; ++k) {
        const int v = pq ? (s[p + 2 * k] << 8) | s[p + 2 * k + 1] : s[p + k];
        qt[tq][kNatural[k]] = (uint16_t)v;
      }
      p += 64 * (pq + 1);
      qt_def[tq] = true;
    }
  }

  void read_dht(const uint8_t* s, int sl) {
    int p = 0;
    while (p < sl) {
      if (p + 17 > sl) refuse("corrupt JPEG data: DHT segment");
      const int tc = s[p] >> 4, th = s[p] & 15;
      if (tc > 1 || th > 3) refuse("corrupt JPEG data: DHT segment");
      int total = 0;
      for (int i = 0; i < 16; ++i) total += s[p + 1 + i];
      if (total > 256 || p + 17 + total > sl) refuse("corrupt JPEG data: DHT segment");
      build_table(tc ? ac[th] : dc[th], s + p + 1, s + p + 17, total, tc == 0);
      p += 17 + total;
    }
  }

  void read_frame(const uint8_t* s, int sl, bool prog) {
    if (frame) refuse("corrupt JPEG data: a second frame header");
    if (sl < 6) refuse("corrupt JPEG data: SOF segment");
    const int prec = s[0];
    height = (s[1] << 8) | s[2];
    width = (s[3] << 8) | s[4];
    ncomp = s[5];
    if (prec != 8) refuse("%d-bit JPEG is not supported (8-bit only)", prec);
    if (ncomp == 4) refuse("4-component (CMYK/YCCK) JPEG is not supported");
    if (ncomp != 1 && ncomp != 3) refuse("%d-component JPEG is not supported", ncomp);
    if (sl != 6 + 3 * ncomp) refuse("corrupt JPEG data: SOF segment");
    if (width == 0 || height == 0) refuse("JPEG of %dx%d pixels (a DNL height is not supported)", width, height);
    if ((int64_t)width * height > kMaxPixels)
      refuse("JPEG of %dx%d pixels is past the limit of 2^30 pixels", width, height);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) refuse("corrupt JPEG data: SOF component");
      for (int j = 0; j < i; ++j)
        if (comp[j].id == c.id) refuse("corrupt JPEG data: duplicate component id %d", c.id);
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (hmax % c.h || vmax % c.v) refuse("JPEG with fractional sampling factors is not supported");
      c.ds_w = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.ds_h = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.bw = (c.ds_w + 7) / 8;
      c.bh = (c.ds_h + 7) / 8;
      c.aw = mcux * c.h;
      c.ah = mcuy * c.v;
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    progressive = prog;
    frame = true;
  }

  void allocate() {
    for (int i = 0; i < ncomp; ++i) comp[i].coef.assign((size_t)comp[i].aw * comp[i].ah * 64, 0);
  }

  Scan read_sos(const uint8_t* s, int sl) {
    Scan sc;
    if (sl < 1) refuse("corrupt JPEG data: SOS segment");
    sc.ns = s[0];
    if (sc.ns < 1 || sc.ns > 4 || sl != 4 + 2 * sc.ns) refuse("corrupt JPEG data: SOS segment");
    for (int i = 0; i < sc.ns; ++i) {
      const int id = s[1 + 2 * i], t = s[2 + 2 * i];
      int ci = -1;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) ci = j;
      if (ci < 0) refuse("corrupt JPEG data: scan names component %d, not in the frame", id);
      for (int j = 0; j < i; ++j)
        if (sc.ci[j] == ci) refuse("corrupt JPEG data: scan names component %d twice", id);
      sc.ci[i] = ci;
      sc.td[i] = t >> 4;
      sc.ta[i] = t & 15;
      if (sc.td[i] > 3 || sc.ta[i] > 3) refuse("corrupt JPEG data: SOS table number");
    }
    const uint8_t* t = s + 1 + 2 * sc.ns;
    sc.ss = t[0];
    sc.se = t[1];
    sc.ah = t[2] >> 4;
    sc.al = t[2] & 15;
    if (progressive) {
      bool ok = true;
      if (sc.ss == 0) {
        if (sc.se != 0) ok = false;
      } else {
        if (sc.se < sc.ss || sc.se > 63 || sc.ns != 1) ok = false;
      }
      if (sc.ah != 0 && sc.al != sc.ah - 1) ok = false;
      if (sc.al > 13) ok = false;
      if (!ok) refuse("corrupt JPEG data: invalid progressive scan (Ss=%d Se=%d Ah=%d Al=%d)", sc.ss, sc.se, sc.ah, sc.al);
    }
    int blocks = 0;
    for (int i = 0; i < sc.ns; ++i) blocks += sc.ns == 1 ? 1 : comp[sc.ci[i]].h * comp[sc.ci[i]].v;
    if (blocks > 10) refuse("corrupt JPEG data: %d blocks in an MCU", blocks);
    return sc;
  }

  // ---- entropy decoding of one block per scan kind (jdhuff.c, jdphuff.c)

  void block_sequential(Bits& br, const HuffTable& dct, const HuffTable& act, Component& c, int16_t* blk) {
    br.ensure();
    const int t = decode_symbol(br, dct);
    const int diff = t ? extend(br.get(t), t) : 0;
    c.dc_pred = (int)((unsigned)c.dc_pred + (unsigned)diff);
    blk[0] = (int16_t)c.dc_pred;
    for (int k = 1; k < 64;) {
      br.ensure();
      const int rs = decode_symbol(br, act);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) refuse("corrupt JPEG data: coefficient past the end of a block");
        blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  void block_dc_first(Bits& br, const HuffTable& dct, Component& c, int16_t* blk, int al) {
    br.ensure();
    const int t = decode_symbol(br, dct);
    const int diff = t ? extend(br.get(t), t) : 0;
    c.dc_pred = (int)((unsigned)c.dc_pred + (unsigned)diff);
    blk[0] = (int16_t)((unsigned)c.dc_pred << al);
  }

  void block_dc_refine(Bits& br, int16_t* blk, int al) {
    br.ensure();
    if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
  }

  void block_ac_first(Bits& br, const HuffTable& act, int16_t* blk, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      br.ensure();
      const int rs = decode_symbol(br, act);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) refuse("corrupt JPEG data: coefficient past the end of a band");
        blk[kNatural[k]] = (int16_t)((unsigned)extend(br.get(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }

  void block_ac_refine(Bits& br, const HuffTable& act, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    auto correct = [&](int16_t* coef) {
      br.ensure();
      if (br.get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        br.ensure();
        const int rs = decode_symbol(br, act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) refuse("corrupt JPEG data: refinement coefficient of size %d", s);
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > se) refuse("corrupt JPEG data: coefficient past the end of a band");
          blk[kNatural[k]] = (int16_t)s;
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  void decode_scan(const Scan& sc) {
    if (comp[0].coef.empty()) allocate();
    for (int i = 0; i < sc.ns; ++i) {
      Component& c = comp[sc.ci[i]];
      if (!c.qlatched) {
        if (!qt_def[c.tq]) refuse("corrupt JPEG data: quantization table %d is not defined", c.tq);
        std::memcpy(c.q, qt[c.tq], sizeof c.q);
        c.qlatched = true;
      }
      const bool need_dc = !progressive || (sc.ss == 0 && sc.ah == 0);
      const bool need_ac = !progressive || sc.ss > 0;
      if (need_dc && !dc[sc.td[i]].defined) std_table(dc[sc.td[i]], sc.td[i], true, progressive);
      if (need_ac && !ac[sc.ta[i]].defined) std_table(ac[sc.ta[i]], sc.ta[i], false, progressive);
      c.dc_pred = 0;
      if (progressive)
        for (int k = sc.ss; k <= sc.se; ++k) c.coef_bits[k] = sc.al;
    }
    eobrun = 0;
    Bits br(d, n, pos);
    const bool single = sc.ns == 1;
    const Component& c0 = comp[sc.ci[0]];
    const int64_t cols = single ? c0.bw : mcux;
    const int64_t total = single ? (int64_t)c0.bw * c0.bh : (int64_t)mcux * mcuy;
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        if (br.overran()) refuse("truncated or corrupt JPEG data");
        pos = br.pos;
        const int mk = next_marker();
        if (mk != 0xD0 + next_rst) refuse("corrupt JPEG data: expected the marker RST%d", next_rst);
        next_rst = (next_rst + 1) & 7;
        br.pos = pos;
        br.reset();
        for (int i = 0; i < sc.ns; ++i) comp[sc.ci[i]].dc_pred = 0;
        eobrun = 0;
      }
      if (m % cols == 0 && br.overran()) refuse("truncated or corrupt JPEG data");
      const int my = (int)(m / cols), mx = (int)(m % cols);
      for (int i = 0; i < sc.ns; ++i) {
        Component& c = comp[sc.ci[i]];
        const int bv = single ? 1 : c.v, bh = single ? 1 : c.h;
        for (int y = 0; y < bv; ++y)
          for (int x = 0; x < bh; ++x) {
            int16_t* blk = c.block(my * bv + y, mx * bh + x);
            if (!progressive) block_sequential(br, dc[sc.td[i]], ac[sc.ta[i]], c, blk);
            else if (sc.ss == 0 && sc.ah == 0) block_dc_first(br, dc[sc.td[i]], c, blk, sc.al);
            else if (sc.ss == 0) block_dc_refine(br, blk, sc.al);
            else if (sc.ah == 0) block_ac_first(br, ac[sc.ta[i]], blk, sc.ss, sc.se, sc.al);
            else block_ac_refine(br, ac[sc.ta[i]], blk, sc.ss, sc.se, sc.al);
          }
      }
    }
    if (br.overran()) refuse("truncated or corrupt JPEG data");
    pos = br.pos;
  }

  // ---- sample reconstruction

  // jidctint.c jpeg_idct_islow: one dequantised block into 8x8 samples.
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    constexpr int CB = 13, P1 = 2;
    auto desc = [](int64_t x, int nb) { return (int64_t)((x + ((int64_t)1 << (nb - 1))) >> nb); };
    auto range = [](int64_t x) -> uint8_t {
      const int t = (int)(x & 1023);
      return (uint8_t)(t < 128 ? t + 128 : t < 512 ? 255 : t < 896 ? 0 : t - 896);
    };
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        const int dcv = (int)(ip[0] * qp[0]) * (1 << P1);
        for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dcv;
        continue;
      }
      int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * 4433;
      int64_t tmp2 = z1 + z3 * -15137, tmp3 = z1 + z2 * 6270;
      z2 = ip[0] * qp[0];
      z3 = ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << CB), tmp1 = (z2 - z3) * (1 << CB);
      const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      tmp0 = ip[56] * qp[56];
      tmp1 = ip[40] * qp[40];
      tmp2 = ip[24] * qp[24];
      tmp3 = ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * 9633;
      tmp0 *= 2446;
      tmp1 *= 16819;
      tmp2 *= 25172;
      tmp3 *= 12299;
      z1 *= -7373;
      z2 *= -20995;
      z3 *= -16069;
      z4 *= -3196;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      ws[0 * 8 + c] = (int)desc(t10 + tmp3, CB - P1);
      ws[7 * 8 + c] = (int)desc(t10 - tmp3, CB - P1);
      ws[1 * 8 + c] = (int)desc(t11 + tmp2, CB - P1);
      ws[6 * 8 + c] = (int)desc(t11 - tmp2, CB - P1);
      ws[2 * 8 + c] = (int)desc(t12 + tmp1, CB - P1);
      ws[5 * 8 + c] = (int)desc(t12 - tmp1, CB - P1);
      ws[3 * 8 + c] = (int)desc(t13 + tmp0, CB - P1);
      ws[4 * 8 + c] = (int)desc(t13 - tmp0, CB - P1);
    }
    for (int r = 0; r < 8; ++r) {
      const int* w = ws + r * 8;
      uint8_t* o = out + (size_t)r * stride;
      if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
        const uint8_t v = range(desc(w[0], P1 + 3));
        for (int i = 0; i < 8; ++i) o[i] = v;
        continue;
      }
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * 4433;
      int64_t tmp2 = z1 + z3 * -15137, tmp3 = z1 + z2 * 6270;
      int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CB), tmp1 = ((int64_t)w[0] - w[4]) * (1 << CB);
      const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * 9633;
      tmp0 *= 2446;
      tmp1 *= 16819;
      tmp2 *= 25172;
      tmp3 *= 12299;
      z1 *= -7373;
      z2 *= -20995;
      z3 *= -16069;
      z4 *= -3196;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int S = CB + P1 + 3;
      o[0] = range(desc(t10 + tmp3, S));
      o[7] = range(desc(t10 - tmp3, S));
      o[1] = range(desc(t11 + tmp2, S));
      o[6] = range(desc(t11 - tmp2, S));
      o[2] = range(desc(t12 + tmp1, S));
      o[5] = range(desc(t12 - tmp1, S));
      o[3] = range(desc(t13 + tmp0, S));
      o[4] = range(desc(t13 - tmp0, S));
    }
  }

  // The component's samples (bw*8 x bh*8, stride bw*8).
  std::vector<uint8_t> component_plane(Component& c) const {
    const int stride = c.bw * 8;
    std::vector<uint8_t> plane((size_t)stride * c.bh * 8);
    if (!c.qlatched) return plane;  // never scanned: libjpeg's zero coefficients give 128
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.block(by, bx), c.q, plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
    return plane;
  }

  // The component's samples as ffmpeg's MJPEG decoder reconstructs them: the
  // dequantised block, level-shifted by 128 in its DC, through the simple IDCT.
  std::vector<uint8_t> component_plane_simple(Component& c) const {
    const int stride = c.bw * 8;
    std::vector<uint8_t> plane((size_t)stride * c.bh * 8);
    if (!c.qlatched) return plane;
    int16_t blk[64];
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx) {
        const int16_t* in = c.block(by, bx);
        for (int k = 0; k < 64; ++k) blk[k] = (int16_t)(in[k] * c.q[k]);
        blk[0] = (int16_t)(blk[0] + 1024);
        simple_idct::idct(blk, plane.data() + (size_t)by * 8 * stride + bx * 8, stride, false);
      }
    return plane;
  }

  // jdsample.c: the component upsampled to width x height.
  std::vector<uint8_t> upsample(Component& c) const {
    std::vector<uint8_t> plane = component_plane(c);
    const int stride = c.bw * 8, W = width, H = height, dw = c.ds_w, dh = c.ds_h;
    const int hr = hmax / c.h, vr = vmax / c.v;
    std::vector<uint8_t> out((size_t)W * H);
    std::vector<uint8_t> row((size_t)2 * dw + 2);
    std::vector<int> cs((size_t)dw);
    for (int y = 0; y < H; ++y) {
      uint8_t* o = out.data() + (size_t)y * W;
      if (hr == 1 && vr == 1) {
        std::memcpy(o, plane.data() + (size_t)y * stride, (size_t)W);
      } else if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
        const uint8_t* in = plane.data() + (size_t)y * stride;
        row[0] = in[0];
        row[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
        for (int i = 1; i < dw - 1; ++i) {
          const int iv = in[i] * 3;
          row[2 * i] = (uint8_t)((iv + in[i - 1] + 1) >> 2);
          row[2 * i + 1] = (uint8_t)((iv + in[i + 1] + 2) >> 2);
        }
        row[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        row[2 * dw - 1] = in[dw - 1];
        std::memcpy(o, row.data(), (size_t)W);
      } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
        const int r = y / 2, nb = clamp_int(y % 2 ? r + 1 : r - 1, 0, dh - 1), bias = y % 2 ? 2 : 1;
        const uint8_t *in0 = plane.data() + (size_t)r * stride, *in1 = plane.data() + (size_t)nb * stride;
        for (int x = 0; x < W; ++x) o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      } else if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
        const int r = y / 2, nb = clamp_int(y % 2 ? r + 1 : r - 1, 0, dh - 1);
        const uint8_t *in0 = plane.data() + (size_t)r * stride, *in1 = plane.data() + (size_t)nb * stride;
        for (int i = 0; i < dw; ++i) cs[i] = in0[i] * 3 + in1[i];
        row[0] = (uint8_t)((cs[0] * 4 + 8) >> 4);
        row[1] = (uint8_t)((cs[0] * 3 + cs[1] + 7) >> 4);
        for (int i = 1; i < dw - 1; ++i) {
          row[2 * i] = (uint8_t)((cs[i] * 3 + cs[i - 1] + 8) >> 4);
          row[2 * i + 1] = (uint8_t)((cs[i] * 3 + cs[i + 1] + 7) >> 4);
        }
        row[2 * dw - 2] = (uint8_t)((cs[dw - 1] * 3 + cs[dw - 2] + 8) >> 4);
        row[2 * dw - 1] = (uint8_t)((cs[dw - 1] * 4 + 7) >> 4);
        std::memcpy(o, row.data(), (size_t)W);
      } else {  // int_upsample, and h2v1 / h2v2 replication of narrow planes
        const uint8_t* in = plane.data() + (size_t)(y / vr) * stride;
        for (int x = 0; x < W; ++x) o[x] = in[x / hr];
      }
    }
    return out;
  }

  // The decoded image, before orientation: (height, width, 3) BGR or (height, width) grey.
  // The 3 components are R, G, B (else Y, Cb, Cr).
  bool is_rgb() const {
    if (ncomp != 3 || saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }

  std::vector<uint8_t> pixels(bool gray) {
    const bool rgb = is_rgb();
    if (progressive) check_no_smoothing();
    const size_t np = (size_t)width * height;
    if (ncomp == 1 || (gray && !rgb)) {
      std::vector<uint8_t> y = upsample(comp[0]);
      if (gray) return y;
      std::vector<uint8_t> out(np * 3);
      for (size_t i = 0; i < np; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      return out;
    }
    std::vector<uint8_t> p0 = upsample(comp[0]), p1 = upsample(comp[1]), p2 = upsample(comp[2]);
    constexpr int SB = 16;
    auto fix = [](double x) { return (int64_t)(x * (1 << SB) + 0.5); };
    constexpr int64_t half = (int64_t)1 << (SB - 1);
    if (gray) {  // rgb_gray_convert
      std::vector<uint8_t> out(np);
      for (size_t i = 0; i < np; ++i)
        out[i] = (uint8_t)((fix(0.29900) * p0[i] + fix(0.58700) * p1[i] + fix(0.11400) * p2[i] + half) >> SB);
      return out;
    }
    std::vector<uint8_t> out(np * 3);
    if (rgb) {
      for (size_t i = 0; i < np; ++i) {
        out[3 * i] = p2[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p0[i];
      }
      return out;
    }
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    for (size_t i = 0; i < np; ++i) {
      const int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i + 2] = (uint8_t)clamp_int(y + cr_r[cr], 0, 255);
      out[3 * i + 1] = (uint8_t)clamp_int(y + (int)((cb_g[cb] + cr_g[cr]) >> SB), 0, 255);
      out[3 * i] = (uint8_t)clamp_int(y + cb_b[cb], 0, 255);
    }
    return out;
  }

  // jdcoefct.c smoothing_ok: libjpeg smooths a progressive image whose first
  // nine AC coefficients are not all known to their last bit.
  void check_no_smoothing() const {
    static constexpr int kQpos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      if (!c.qlatched) return;
      for (int k = 0; k < 10; ++k)
        if (c.q[kQpos[k]] == 0) return;
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; ++k) useful |= c.coef_bits[k] != 0;
    }
    if (useful)
      refuse("progressive JPEG whose scans leave low AC coefficients unrefined "
             "(libjpeg would smooth its blocks) is not supported");
  }
};

// Output dims after the EXIF orientation (5-8 transpose).
void oriented_dims(int orient, int h, int w, int* oh, int* ow) {
  const bool t = orient >= 5 && orient <= 8;
  *oh = t ? w : h;
  *ow = t ? h : w;
}

// cv2's ExifTransform: out[y][x] = img[sy][sx] for the orientation.
void orient_copy(const uint8_t* img, int h, int w, int ch, int orient, uint8_t* out) {
  int oh, ow;
  oriented_dims(orient, h, w, &oh, &ow);
  for (int y = 0; y < oh; ++y)
    for (int x = 0; x < ow; ++x) {
      int sy, sx;
      switch (orient) {
        case 2: sy = y; sx = w - 1 - x; break;
        case 3: sy = h - 1 - y; sx = w - 1 - x; break;
        case 4: sy = h - 1 - y; sx = x; break;
        case 5: sy = x; sx = y; break;
        case 6: sy = h - 1 - x; sx = y; break;
        case 7: sy = h - 1 - x; sx = w - 1 - y; break;
        case 8: sy = x; sx = w - 1 - y; break;
        default: sy = y; sx = x; break;
      }
      std::memcpy(out + ((size_t)y * ow + x) * ch, img + ((size_t)sy * w + sx) * ch, (size_t)ch);
    }
}

// ------------------------------------------------------------------ encoder

constexpr uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
constexpr uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
};

EncTable enc_table(const uint8_t* bits, const uint8_t* vals) {
  EncTable t{};
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code) {
      t.code[vals[k]] = (uint16_t)code;
      t.size[vals[k]] = (uint8_t)len;
    }
    code <<= 1;
  }
  return t;
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t v, int k) {
    acc = (acc << k) | (v & ((1u << k) - 1));
    nbits += k;
    while (nbits >= 8) {
      const uint8_t b = (uint8_t)(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {  // pad the last byte with ones
    if (nbits > 0) put(0x7F, 7);
    nbits = 0;
    acc = 0;
  }
};

inline int nbits_of(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

// jfdctint.c jpeg_fdct_islow, in place on samples minus 128.
void fdct_islow(int* d) {
  constexpr int CB = 13, P1 = 2;
  auto desc = [](int64_t x, int nb) { return (int)((x + ((int64_t)1 << (nb - 1))) >> nb); };
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, next = pass ? 1 : 8;
    for (int i = 0; i < 8; ++i) {
      int* p = d + i * next;
      const int64_t t0 = p[0] + p[7 * step], t7 = p[0] - p[7 * step];
      const int64_t t1 = p[step] + p[6 * step], t6 = p[step] - p[6 * step];
      const int64_t t2 = p[2 * step] + p[5 * step], t5 = p[2 * step] - p[5 * step];
      const int64_t t3 = p[3 * step] + p[4 * step], t4 = p[3 * step] - p[4 * step];
      const int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
      if (!pass) {
        p[0] = (int)((t10 + t11) * (1 << P1));
        p[4 * step] = (int)((t10 - t11) * (1 << P1));
      } else {
        p[0] = desc(t10 + t11, P1);
        p[4 * step] = desc(t10 - t11, P1);
      }
      const int sh = pass ? CB + P1 : CB - P1;
      const int64_t z1 = (t12 + t13) * 4433;
      p[2 * step] = desc(z1 + t13 * 6270, sh);
      p[6 * step] = desc(z1 + t12 * -15137, sh);
      int64_t y1 = t4 + t7, y2 = t5 + t6, y3 = t4 + t6, y4 = t5 + t7;
      const int64_t z5 = (y3 + y4) * 9633;
      const int64_t a4 = t4 * 2446, a5 = t5 * 16819, a6 = t6 * 25172, a7 = t7 * 12299;
      y1 *= -7373;
      y2 *= -20995;
      y3 *= -16069;
      y4 *= -3196;
      y3 += z5;
      y4 += z5;
      p[7 * step] = desc(a4 + y1 + y3, sh);
      p[5 * step] = desc(a5 + y2 + y4, sh);
      p[3 * step] = desc(a6 + y2 + y3, sh);
      p[step] = desc(a7 + y1 + y4, sh);
    }
  }
}

struct Encoder {
  int H, W, C;  // C is 1 (grey) or 3 (BGR)
  uint16_t q[2][64];
  std::vector<uint8_t> out;

  Encoder(int h, int w, int c, int quality) : H(h), W(w), C(c) {
    quality = clamp_int(quality, 1, 100);
    const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; ++i) {
      q[0][i] = (uint16_t)clamp_int((int)(((int64_t)kStdLumaQ[i] * scale + 50) / 100), 1, 255);
      q[1][i] = (uint16_t)clamp_int((int)(((int64_t)kStdChromaQ[i] * scale + 50) / 100), 1, 255);
    }
  }

  void marker(int m) {
    out.push_back(0xFF);
    out.push_back((uint8_t)m);
  }
  void word(int v) {
    out.push_back((uint8_t)(v >> 8));
    out.push_back((uint8_t)v);
  }

  void headers() {
    marker(0xD8);
    marker(0xE0);  // JFIF 1.01, no density units, 1:1
    const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    word(16);
    out.insert(out.end(), jfif, jfif + 14);
    for (int t = 0; t < (C == 3 ? 2 : 1); ++t) {
      marker(0xDB);
      word(67);
      out.push_back((uint8_t)t);
      for (int k = 0; k < 64; ++k) out.push_back((uint8_t)q[t][kNatural[k]]);
    }
    marker(0xC0);
    word(8 + 3 * C);
    out.push_back(8);
    word(H);
    word(W);
    out.push_back((uint8_t)C);
    for (int i = 0; i < C; ++i) {
      out.push_back((uint8_t)(i + 1));
      out.push_back(C == 3 && i == 0 ? 0x22 : 0x11);
      out.push_back(i ? 1 : 0);
    }
    auto dht = [&](int cls, int id, const uint8_t* bits, const uint8_t* vals) {
      int nv = 0;
      for (int i = 0; i < 16; ++i) nv += bits[i];
      marker(0xC4);
      word(2 + 1 + 16 + nv);
      out.push_back((uint8_t)(cls << 4 | id));
      out.insert(out.end(), bits, bits + 16);
      out.insert(out.end(), vals, vals + nv);
    };
    dht(0, 0, kDcLumaBits, kDcVals);
    dht(1, 0, kAcLumaBits, kAcLumaVals);
    if (C == 3) {
      dht(0, 1, kDcChromaBits, kDcVals);
      dht(1, 1, kAcChromaBits, kAcChromaVals);
    }
    marker(0xDA);
    word(6 + 2 * C);
    out.push_back((uint8_t)C);
    for (int i = 0; i < C; ++i) {
      out.push_back((uint8_t)(i + 1));
      out.push_back(i ? 0x11 : 0x00);
    }
    out.push_back(0);
    out.push_back(63);
    out.push_back(0);
  }

  // jcsample.c / jcprepct.c: the component planes, padded to whole blocks
  // by edge replication (full-resolution rows to a multiple of 2 before the
  // h2v2 downsampling, then the last downsampled row).
  void planes(const uint8_t* img, std::vector<uint8_t> p[3], int bw[3], int bh[3]) const {
    if (C == 1) {
      bw[0] = (W + 7) / 8;
      bh[0] = (H + 7) / 8;
      const int pw = bw[0] * 8, ph = bh[0] * 8;
      p[0].resize((size_t)pw * ph);
      for (int y = 0; y < ph; ++y)
        for (int x = 0; x < pw; ++x) p[0][(size_t)y * pw + x] = img[(size_t)std::min(y, H - 1) * W + std::min(x, W - 1)];
      return;
    }
    constexpr int SB = 16;
    auto fix = [](double x) { return (int64_t)(x * (1 << SB) + 0.5); };
    constexpr int64_t half = (int64_t)1 << (SB - 1), cbcr_off = (int64_t)128 << SB;
    std::vector<uint8_t> Y((size_t)W * H), Cb((size_t)W * H), Cr((size_t)W * H);
    for (size_t i = 0; i < (size_t)W * H; ++i) {  // rgb_ycc_convert
      const int64_t b = img[3 * i], g = img[3 * i + 1], r = img[3 * i + 2];
      Y[i] = (uint8_t)((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> SB);
      Cb[i] = (uint8_t)((-fix(0.16874) * r - fix(0.33126) * g + fix(0.50000) * b + cbcr_off + half - 1) >> SB);
      Cr[i] = (uint8_t)((fix(0.50000) * r - fix(0.41869) * g - fix(0.08131) * b + cbcr_off + half - 1) >> SB);
    }
    bw[0] = (W + 7) / 8;
    bh[0] = (H + 7) / 8;
    {
      const int pw = bw[0] * 8, ph = bh[0] * 8;
      p[0].resize((size_t)pw * ph);
      for (int y = 0; y < ph; ++y)
        for (int x = 0; x < pw; ++x) p[0][(size_t)y * pw + x] = Y[(size_t)std::min(y, H - 1) * W + std::min(x, W - 1)];
    }
    const int dh = (H + 1) / 2;  // downsampled rows made from image rows
    for (int ci = 1; ci < 3; ++ci) {
      const std::vector<uint8_t>& src = ci == 1 ? Cb : Cr;
      bw[ci] = (W + 15) / 16;
      bh[ci] = (H + 15) / 16;
      const int pw = bw[ci] * 8, ph = bh[ci] * 8;
      p[ci].resize((size_t)pw * ph);
      for (int y = 0; y < ph; ++y) {
        const int sy = std::min(y, dh - 1);
        const uint8_t* r0 = src.data() + (size_t)std::min(2 * sy, H - 1) * W;
        const uint8_t* r1 = src.data() + (size_t)std::min(2 * sy + 1, H - 1) * W;
        for (int x = 0; x < pw; ++x) {
          const int x0 = std::min(2 * x, W - 1), x1 = std::min(2 * x + 1, W - 1);
          p[ci][(size_t)y * pw + x] = (uint8_t)((r0[x0] + r0[x1] + r1[x0] + r1[x1] + 1 + (x & 1)) >> 2);
        }
      }
    }
  }

  // FDCT and quantisation of one block (natural order out).
  void forward(const uint8_t* plane, int pw, int by, int bx, const uint16_t* qt, int16_t* coef) const {
    int d[64];
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) d[y * 8 + x] = plane[(size_t)(by * 8 + y) * pw + bx * 8 + x] - 128;
    fdct_islow(d);
    for (int i = 0; i < 64; ++i) {
      const int div = qt[i] << 3;
      const int v = d[i];
      coef[i] = (int16_t)(v < 0 ? -((-v + (div >> 1)) / div) : (v + (div >> 1)) / div);
    }
  }

  static void encode_block(BitWriter& bw, const int16_t* coef, int& last_dc, const EncTable& dct, const EncTable& act) {
    int t = coef[0] - last_dc, t2 = t;
    last_dc = coef[0];
    if (t < 0) {
      t = -t;
      --t2;
    }
    int nb = nbits_of(t);
    if (nb > 11) refuse("JPEG encoder: DC coefficient out of range");
    bw.put(dct.code[nb], dct.size[nb]);
    if (nb) bw.put((uint32_t)t2, nb);
    int r = 0;
    for (int k = 1; k < 64; ++k) {
      t = coef[kNatural[k]];
      if (t == 0) {
        ++r;
        continue;
      }
      while (r > 15) {
        bw.put(act.code[0xF0], act.size[0xF0]);
        r -= 16;
      }
      t2 = t;
      if (t < 0) {
        t = -t;
        --t2;
      }
      nb = nbits_of(t);
      if (nb > 10) refuse("JPEG encoder: AC coefficient out of range");
      const int sym = (r << 4) + nb;
      bw.put(act.code[sym], act.size[sym]);
      bw.put((uint32_t)t2, nb);
      r = 0;
    }
    if (r > 0) bw.put(act.code[0], act.size[0]);
  }

  void encode(const uint8_t* img) {
    headers();
    std::vector<uint8_t> p[3];
    int bw[3], bh[3];
    planes(img, p, bw, bh);
    const EncTable dct[2] = {enc_table(kDcLumaBits, kDcVals), enc_table(kDcChromaBits, kDcVals)};
    const EncTable act[2] = {enc_table(kAcLumaBits, kAcLumaVals), enc_table(kAcChromaBits, kAcChromaVals)};
    BitWriter w(out);
    int last_dc[3] = {0, 0, 0};
    int16_t blk[6][64];
    if (C == 1) {
      for (int by = 0; by < bh[0]; ++by)
        for (int bx = 0; bx < bw[0]; ++bx) {
          forward(p[0].data(), bw[0] * 8, by, bx, q[0], blk[0]);
          encode_block(w, blk[0], last_dc[0], dct[0], act[0]);
        }
    } else {
      const int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          // jccoefct.c: blocks past the luma plane are zeros carrying the DC of the block before
          for (int v = 0; v < 2; ++v)
            for (int h = 0; h < 2; ++h) {
              const int n = v * 2 + h, by = my * 2 + v, bx = mx * 2 + h;
              if (by < bh[0] && bx < bw[0]) {
                forward(p[0].data(), bw[0] * 8, by, bx, q[0], blk[n]);
              } else {
                std::memset(blk[n], 0, sizeof blk[n]);
                blk[n][0] = blk[n - 1][0];
              }
            }
          forward(p[1].data(), bw[1] * 8, my, mx, q[1], blk[4]);
          forward(p[2].data(), bw[2] * 8, my, mx, q[1], blk[5]);
          for (int n = 0; n < 4; ++n) encode_block(w, blk[n], last_dc[0], dct[0], act[0]);
          encode_block(w, blk[4], last_dc[1], dct[1], act[1]);
          encode_block(w, blk[5], last_dc[2], dct[1], act[1]);
        }
    }
    w.flush();
    marker(0xD9);
  }
};

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

}  // namespace

extern "C" {

// info: height and width as decoded (after the EXIF orientation), the
// number of components, the EXIF orientation (0 when absent), progressive.
int mga_jpeg_header(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  return guarded(err, errlen, [&] {
    Decoder dec(data, (size_t)n);
    dec.run(true);
    int oh, ow;
    oriented_dims(dec.orientation, dec.height, dec.width, &oh, &ow);
    info[0] = oh;
    info[1] = ow;
    info[2] = dec.ncomp;
    info[3] = dec.orientation;
    info[4] = dec.progressive;
  });
}

// Decodes into out: (h, w, 3) BGR, or (h, w) when gray; h, w as the header gave.
int mga_jpeg_decode(const uint8_t* data, int64_t n, int gray, uint8_t* out, int32_t h, int32_t w, char* err,
                    int errlen) {
  return guarded(err, errlen, [&] {
    Decoder dec(data, (size_t)n);
    dec.run(false);
    int oh, ow;
    oriented_dims(dec.orientation, dec.height, dec.width, &oh, &ow);
    if (oh != h || ow != w) refuse("JPEG size differs from the buffer given");
    std::vector<uint8_t> img = dec.pixels(gray != 0);
    const int ch = gray ? 1 : 3;
    if (dec.orientation >= 2 && dec.orientation <= 8)
      orient_copy(img.data(), dec.height, dec.width, ch, dec.orientation, out);
    else
      std::memcpy(out, img.data(), img.size());
  });
}

// The component planes through ffmpeg's simple IDCT, each at its own sampled
// size, back to back in frame order: no upsampling, no colour conversion and
// no EXIF orientation, as ffmpeg's MJPEG decoder hands a video frame on.
// info (16 entries): height, width, components, 1 when they are R, G, B;
// then for each component its rows, columns and h, v sampling factors.
// Returns the bytes of the planes; when that is more than cap nothing is
// copied; -1 with a message on failure.
int64_t mga_jpeg_decode_planes(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int32_t* info, char* err,
                               int errlen) {
  int64_t size = -1;
  guarded(err, errlen, [&] {
    Decoder dec(data, (size_t)n);
    dec.run(false);
    if (dec.progressive) dec.check_no_smoothing();
    std::memset(info, 0, 16 * sizeof(int32_t));
    info[0] = dec.height;
    info[1] = dec.width;
    info[2] = dec.ncomp;
    info[3] = dec.is_rgb();
    int64_t total = 0;
    for (int i = 0; i < dec.ncomp; ++i) {
      const Component& c = dec.comp[i];
      info[4 + 4 * i] = c.ds_h;
      info[5 + 4 * i] = c.ds_w;
      info[6 + 4 * i] = c.h;
      info[7 + 4 * i] = c.v;
      total += (int64_t)c.ds_h * c.ds_w;
    }
    size = total;
    if (total > cap) return;
    uint8_t* o = out;
    for (int i = 0; i < dec.ncomp; ++i) {
      Component& c = dec.comp[i];
      const std::vector<uint8_t> plane = dec.component_plane_simple(c);
      const int stride = c.bw * 8;
      for (int y = 0; y < c.ds_h; ++y, o += c.ds_w) std::memcpy(o, plane.data() + (size_t)y * stride, (size_t)c.ds_w);
    }
  });
  return size;
}

// Encodes an (h, w) grey or (h, w, 3) BGR image. Returns the size of the
// file; when it is more than cap nothing is copied (call again with room);
// -1 with a message on failure.
int64_t mga_jpeg_encode(const uint8_t* img, int32_t h, int32_t w, int32_t c, int32_t quality, uint8_t* out,
                        int64_t cap, char* err, int errlen) {
  int64_t size = -1;
  guarded(err, errlen, [&] {
    if (h < 1 || w < 1 || h > 65535 || w > 65535) refuse("JPEG encoder: %dx%d is outside 1..65535", h, w);
    if (c != 1 && c != 3) refuse("JPEG encoder: %d channels (1 or 3)", c);
    Encoder enc(h, w, c, quality);
    enc.encode(img);
    size = (int64_t)enc.out.size();
    if (size <= cap) std::memcpy(out, enc.out.data(), enc.out.size());
  });
  return size;
}

}  // extern "C"
