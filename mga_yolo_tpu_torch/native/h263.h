// The H.263 family's common ground on the host, shared by mpeg4.cpp (MPEG-4
// Part 2) and msmpeg4.cpp (MS MPEG-4 v2 and v3, WMV1, WMV2): errors that
// name what is refused, variable-length codes (in levels, for codes longer
// than a table's root), the bit reader, the code tables the two share
// (H.263's CBPY and motion vector differences, MPEG-4's DC sizes, the intra
// and inter coefficient tables, the zigzag and alternate scans), planes of
// whole macroblocks, and ffmpeg's half-sample motion compensation of an
// H.263-family decoder with H.263's chroma vector rounding.

#pragma once

#include <algorithm>
#include <cstdarg>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <new>
#include <stdexcept>
#include <vector>

namespace h263 {

struct Refused : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] inline void refuse(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Refused(buf);
}

inline void set_error(char* err, int errlen, const char* msg) {
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

// ------------------------------------------------------------------ codes

// A variable-length code, as (code, length).
struct Code {
  uint32_t code;
  uint8_t len;
};

// The variable-length codes of ISO/IEC 14496-2 Annex B (H.263's where shared).
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

inline int mid3(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }
inline int rounded_div(int a, int b) { return (a > 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

// A decoding table: the next `bits` bits -> (symbol, length). A code longer
// than the root's bits goes through a second table (and a third) indexed by
// the bits after it, as ffmpeg's VLC tables do.
struct Vlc {
  int bits = 0;
  std::vector<int32_t> sym;  // the symbol, or the offset of the table the entry leads to
  std::vector<int8_t> len;   // > 0: the code's length (within its table); < 0: a table of -len bits; 0: no code
  void build(const Code* codes, int n, int maxbits) {
    std::vector<Entry> all;
    for (int i = 0; i < n; ++i)
      if (codes[i].len) all.push_back({codes[i].code, codes[i].len, i});
    build(all, maxbits);
  }
  // Codes given by their lengths alone, in the order of the code tree (ffmpeg's
  // ff_vlc_init_from_lengths): each the next free code of its length.
  void build_from_lengths(const uint8_t* lens, const int* syms, int n, int root) {
    std::vector<Entry> all;
    uint64_t next = 0;
    for (int i = 0; i < n; ++i) {
      all.push_back({(uint32_t)(next >> (32 - lens[i])), lens[i], syms[i]});
      next += (uint64_t)1 << (32 - lens[i]);
    }
    build(all, root);
  }

 private:
  struct Entry {
    uint32_t code;
    int len, sym;
  };
  void build(const std::vector<Entry>& all, int root) {
    bits = root;
    sym.assign((size_t)1 << root, 0);
    len.assign((size_t)1 << root, 0);
    fill(0, root, 0, all);
  }
  // The table at `at` of `tb` bits for the codes whose first `done` bits led to it.
  void fill(size_t at, int tb, int done, const std::vector<Entry>& codes) {
    std::vector<std::vector<Entry>> longer((size_t)1 << tb);
    for (const Entry& c : codes) {
      const int rest = c.len - done;
      const uint32_t tail = rest >= 32 ? c.code : c.code & ((1u << rest) - 1);
      if (rest <= tb) {
        const size_t lo = (size_t)tail << (tb - rest), hi = lo + ((size_t)1 << (tb - rest));
        for (size_t j = lo; j < hi; ++j) {
          sym[at + j] = c.sym;
          len[at + j] = (int8_t)rest;
        }
      } else {
        longer[tail >> (rest - tb)].push_back(c);
      }
    }
    for (size_t j = 0; j < longer.size(); ++j) {
      if (longer[j].empty()) continue;
      int deepest = 0;
      for (const Entry& c : longer[j]) deepest = std::max(deepest, c.len - done - tb);
      const int sub = std::min(deepest, tb);
      const size_t off = sym.size();
      sym.resize(off + ((size_t)1 << sub), 0);
      len.resize(off + ((size_t)1 << sub), 0);
      sym[at + j] = (int32_t)off;
      len[at + j] = (int8_t)-sub;
      fill(off, sub, done + tb, longer[j]);
    }
  }
};

// ------------------------------------------------------------------ bits

struct BitReader {
  const uint8_t* d = nullptr;
  size_t nbytes = 0, pos = 0;  // pos in bits
  const char* codec = "MPEG-4 video";  // what a corrupt stream's message names
  BitReader() = default;
  BitReader(const uint8_t* d_, size_t n_, const char* codec_ = "MPEG-4 video") : d(d_), nbytes(n_), codec(codec_) {}
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
    if (!get1()) refuse("corrupt %s: a marker bit is 0 in the %s", codec, what);
  }
  bool overran() const { return pos > nbytes * 8; }
  size_t left() const { return pos >= nbytes * 8 ? 0 : nbytes * 8 - pos; }
  int vlc(const Vlc& t, const char* what) {
    size_t at = 0;
    int bits = t.bits;
    for (;;) {
      const size_t j = at + peek(bits);
      const int l = t.len[j];
      if (l > 0) {
        pos += (size_t)l;
        return t.sym[j];
      }
      if (!l) refuse("corrupt %s: no %s code matches", codec, what);
      pos += (size_t)bits;
      at = (size_t)t.sym[j];
      bits = -l;
    }
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
  uint8_t get(int x, int y) const {  // clamped to the allocation
    x = x < 0 ? 0 : x >= w ? w - 1 : x;
    y = y < 0 ? 0 : y >= h ? h - 1 : y;
    return px[(size_t)y * w + x];
  }
};

enum Op { kPut, kPutNoRnd, kAvg };

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// rows x cols samples of plane p from column x, frame row y, every step-th
// row; with emu, coordinates clamped to the edge (ew, eh) as ffmpeg's
// emulated_edge_mc extends a reference, else read where they lie.
inline void fetch(const Plane& p, int x, int y, int step, int rows, int cols, bool emu, int ew, int eh, uint8_t* o,
                  int os) {
  for (int r = 0; r < rows; ++r) {
    int yy = y + r * step;
    if (emu) yy = yy < 0 ? 0 : yy >= eh ? eh - 1 : yy;
    for (int c = 0; c < cols; ++c) {
      int xx = x + c;
      if (emu) xx = xx < 0 ? 0 : xx >= ew ? ew - 1 : xx;
      o[r * os + c] = p.get(xx, yy);
    }
  }
}

inline void store(uint8_t* d, int v, Op op) { *d = (uint8_t)(op == kAvg ? (*d + v + 1) >> 1 : v); }

// half-sample prediction of a w x h block (dxy: bit 0 horizontal, bit 1 vertical)
inline void hpel(uint8_t* dst, int ds, const uint8_t* s, int ss, int w, int h, int dxy, Op op) {
  const int r = op == kPutNoRnd ? 0 : 1;
  for (int y = 0; y < h; ++y) {
    const uint8_t* a = s + y * ss;
    const uint8_t* b = a + ss;
    uint8_t* o = dst + (ptrdiff_t)y * ds;
    for (int x = 0; x < w; ++x) {
      int v;
      switch (dxy) {
        case 0: v = a[x]; break;
        case 1: v = (a[x] + a[x + 1] + r) >> 1; break;
        case 2: v = (a[x] + b[x] + r) >> 1; break;
        default: v = (a[x] + a[x + 1] + b[x] + b[x + 1] + 1 + r) >> 2; break;
      }
      store(o + x, v, op);
    }
  }
}

// ffmpeg's mpeg_motion for an H.263-family stream: a 16 x h prediction of
// macroblock (mx, my) into dst (a field of it with fb: rows from field fsel
// of ref into field bottom of dst) and its chroma, the chroma vector rounded
// as H.263's (or, with hpel_chroma_bug, as ffmpeg's FF_BUG_HPEL_CHROMA for a
// field). Past (h_edge, v_edge) the reference is its edge repeated.
inline void mpeg_motion(Plane* dst, const Plane* ref, int mx, int my, bool fb, int bottom, int fsel, int vx, int vy,
                        int h, Op op, int h_edge, int v_edge, bool hpel_chroma_bug) {
  const int dxy = ((vy & 1) << 1) | (vx & 1);
  const int src_x = mx * 16 + (vx >> 1), src_y = (my << (4 - fb)) + (vy >> 1);
  int uvdxy, uvsrc_x, uvsrc_y;
  if (hpel_chroma_bug && fb) {
    const int cx = (vx >> 1) | (vx & 1), cy = vy >> 1;
    uvdxy = ((cy & 1) << 1) | (cx & 1);
    uvsrc_x = mx * 8 + (cx >> 1);
    uvsrc_y = (my << (3 - fb)) + (cy >> 1);
  } else {
    uvdxy = dxy | (vy & 2) | ((vx & 2) >> 1);
    uvsrc_x = src_x >> 1;
    uvsrc_y = src_y >> 1;
  }
  const int vedge = v_edge >> fb;
  const bool emu = (unsigned)src_x >= (unsigned)std::max(h_edge - (vx & 1) - 15, 0) ||
                   (unsigned)src_y >= (unsigned)std::max(vedge - (vy & 1) - h + 1, 0);
  uint8_t s[18 * 17];
  const int step = fb ? 2 : 1;
  fetch(ref[0], src_x, src_y * step + fsel, step, h + 1, 17, emu, h_edge, v_edge, s, 17);
  const int dy = my * 16 + bottom, ds = dst[0].w * step;
  hpel(dst[0].at(mx * 16, dy), ds, s, 17, 16, h, dxy, op);
  for (int c = 1; c < 3; ++c) {
    fetch(ref[c], uvsrc_x, uvsrc_y * step + fsel, step, h / 2 + 1, 9, emu, h_edge >> 1, v_edge >> 1, s, 9);
    hpel(dst[c].at(mx * 8, my * 8 + bottom), dst[c].w * step, s, 9, 8, h / 2, uvdxy, op);
  }
}

}  // namespace h263
