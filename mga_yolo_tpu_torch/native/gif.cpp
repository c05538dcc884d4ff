// GIF decoding on the host for data/image_io.py and data/video_io.py: the
// logical screen, the colour tables, the graphic control extensions and the
// image descriptors, and each image's LZW data to its colour indices. The
// frames are put on the canvas in Python, by the rule of the reader they
// stand in for (cv2's own GIF codec for stills, ffmpeg's gif decoder for
// video), from what these functions return.
//
// GIF's LZW reads codes least significant bit first, starting one bit wider
// than the minimum code size, and widens when the next free code reaches
// the width's limit (no early change, unlike TIFF's); at 4096 entries the
// table stops growing and the codes stay 12 bits until a clear code.
//
// Encoding, for the video writer's numbered stills: the file cv2.imwrite
// writes for a BGR image (OpenCV 5's GIF encoder at its defaults, measured):
// a fixed palette of 3-3-2 bits (R and G levels 36 k, B levels 85 k), each
// channel Floyd-Steinberg dithered on its own (errors 7/16, 3/16, 5/16, 1/16
// kept unrounded, levels round(v / step) clamped), a NETSCAPE2.0 loop of 0, a
// graphic control extension of disposal 3 and a delay of 100, and LZW of
// minimum code size 8 that sends a clear code as soon as code 4095 is taken,
// in sub-blocks of 255 bytes.
//
// Exposed (extern "C"):
//   mga_gif_header - the logical screen and the global colour table
//   mga_gif_frame  - the next image from an offset: its descriptor, the
//                    graphic control extension before it, its colour table,
//                    and its indices (interlaced rows put in order)
//   mga_gif_encode - a BGR image as cv2.imwrite's GIF

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

int rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }

// The bytes of the data sub-blocks from `off`, appended to `out`; the
// offset after the block terminator, or -1 when the data ends first.
int64_t sub_blocks(const uint8_t* d, int64_t n, int64_t off, std::vector<uint8_t>* out) {
    for (;;) {
        if (off >= n) return -1;
        const int len = d[off++];
        if (!len) return off;
        if (off + len > n) return -1;
        if (out) out->insert(out->end(), d + off, d + off + len);
        off += len;
    }
}

// LZW codes into `count` indices; 0, or -1 (corrupt) / -2 (the data ends
// before the image is full).
int lzw(const std::vector<uint8_t>& in, int min_size, uint8_t* out, int64_t count) {
    static thread_local uint16_t prefix[4096];
    static thread_local uint8_t suffix[4096], first[4096];
    static thread_local uint8_t stack[4097];
    const int clear = 1 << min_size, eoi = clear + 1;
    for (int i = 0; i < clear; ++i) suffix[i] = first[i] = (uint8_t)i;
    int width = min_size + 1, next = clear + 2, prev = -1;
    uint32_t acc = 0;
    int bits = 0;
    size_t pos = 0;
    int64_t o = 0;
    while (o < count) {
        while (bits < width) {
            if (pos >= in.size()) return -2;
            acc |= (uint32_t)in[pos++] << bits;
            bits += 8;
        }
        const int code = (int)(acc & ((1u << width) - 1));
        acc >>= width;
        bits -= width;
        if (code == clear) {
            width = min_size + 1;
            next = clear + 2;
            prev = -1;
            continue;
        }
        if (code == eoi) return -2;
        if (prev < 0) {
            if (code >= clear) return -1;
            out[o++] = (uint8_t)code;
            prev = code;
            continue;
        }
        int sp = 0, c = code;
        if (code > next || (code == next && next >= 4096)) return -1;
        if (code == next) {  // the string of prev and its first index
            stack[sp++] = first[prev];
            c = prev;
        }
        while (c >= clear) {
            stack[sp++] = suffix[c];
            c = prefix[c];
        }
        stack[sp++] = (uint8_t)c;
        if (next < 4096) {
            prefix[next] = (uint16_t)prev;
            suffix[next] = (uint8_t)c;
            first[next] = first[prev];
            ++next;
            if (next == (1 << width) && width < 12) ++width;
        }
        while (sp && o < count) out[o++] = stack[--sp];
        prev = code;
    }
    return 0;
}

struct LzwWriter {
  std::vector<uint8_t> out;
  uint32_t acc = 0;
  int nbits = 0;
  void put(int code, int width) {
    acc |= (uint32_t)code << nbits;
    nbits += width;
    while (nbits >= 8) {
      out.push_back((uint8_t)acc);
      acc >>= 8;
      nbits -= 8;
    }
  }
};

// LZW of indices at minimum code size 8, as OpenCV's GIF encoder codes them.
std::vector<uint8_t> lzw_encode(const uint8_t* idx, int64_t n) {
  constexpr int kClear = 256, kEoi = 257;
  LzwWriter w;
  std::vector<int32_t> child((size_t)4096 * 256, -1);  // (prefix code, next index) -> code
  std::vector<size_t> taken;  // the slots of child in use, reset at a clear code
  int width = 9, next = kEoi + 1;
  w.put(kClear, width);
  int cur = -1;
  for (int64_t i = 0; i < n; ++i) {
    const int k = idx[i];
    if (cur < 0) {
      cur = k;
      continue;
    }
    int32_t& slot = child[(size_t)cur * 256 + k];
    if (slot >= 0) {
      cur = slot;
      continue;
    }
    w.put(cur, width);
    slot = next++;
    taken.push_back((size_t)cur * 256 + k);
    if (next > (1 << width) && width < 12) ++width;
    if (next >= 4096) {
      w.put(kClear, width);
      for (size_t t : taken) child[t] = -1;
      taken.clear();
      next = kEoi + 1;
      width = 9;
    }
    cur = k;
  }
  if (cur >= 0) w.put(cur, width);
  w.put(kEoi, width);
  if (w.nbits) w.out.push_back((uint8_t)w.acc);
  return w.out;
}

}  // namespace

extern "C" {

// (h, w, 3) BGR -> the GIF cv2.imwrite writes; the file's size (written
// only when it fits in cap).
int64_t mga_gif_encode(const uint8_t* bgr, int32_t h, int32_t w, uint8_t* out, int64_t cap) {
  const int64_t n = (int64_t)h * w;
  std::vector<double> err((size_t)n * 3);
  for (int64_t i = 0; i < n * 3; ++i) err[(size_t)i] = bgr[i];
  std::vector<uint8_t> idx((size_t)n);
  const int step[3] = {85, 36, 36}, top[3] = {3, 7, 7}, shift[3] = {0, 2, 5};  // B, G, R
  std::fill(idx.begin(), idx.end(), 0);
  for (int c = 0; c < 3; ++c)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const int64_t p = ((int64_t)y * w + x) * 3 + c;
        const double v = err[(size_t)p];
        int k = (int)std::floor(v / step[c] + 0.5);
        k = k < 0 ? 0 : k > top[c] ? top[c] : k;
        idx[(size_t)(p / 3)] |= (uint8_t)(k << shift[c]);
        const double e = v - k * step[c];
        if (x + 1 < w) err[(size_t)(p + 3)] += e * 7 / 16;
        if (y + 1 < h) {
          const int64_t below = p + (int64_t)w * 3;
          if (x > 0) err[(size_t)(below - 3)] += e * 3 / 16;
          err[(size_t)below] += e * 5 / 16;
          if (x + 1 < w) err[(size_t)(below + 3)] += e * 1 / 16;
        }
      }
  std::vector<uint8_t> f = {'G', 'I', 'F', '8', '9', 'a', (uint8_t)w, (uint8_t)(w >> 8), (uint8_t)h, (uint8_t)(h >> 8),
                            0xF7, 0, 0};
  for (int i = 0; i < 256; ++i) {
    f.push_back((uint8_t)((i >> 5) * 36));
    f.push_back((uint8_t)(((i >> 2) & 7) * 36));
    f.push_back((uint8_t)((i & 3) * 85));
  }
  const uint8_t app[] = {0x21, 0xFF, 0x0B, 'N', 'E', 'T', 'S', 'C', 'A', 'P', 'E', '2', '.', '0', 3, 1, 0, 0, 0};
  const uint8_t gce[] = {0x21, 0xF9, 0x04, 0x0C, 100, 0, 0, 0};
  f.insert(f.end(), app, app + sizeof app);
  f.insert(f.end(), gce, gce + sizeof gce);
  const uint8_t desc[] = {0x2C, 0, 0, 0, 0, (uint8_t)w, (uint8_t)(w >> 8), (uint8_t)h, (uint8_t)(h >> 8), 0x07, 8};
  f.insert(f.end(), desc, desc + sizeof desc);
  const std::vector<uint8_t> data = lzw_encode(idx.data(), n);
  for (size_t i = 0; i < data.size(); i += 255) {
    const size_t k = std::min<size_t>(255, data.size() - i);
    f.push_back((uint8_t)k);
    f.insert(f.end(), data.begin() + (int64_t)i, data.begin() + (int64_t)(i + k));
  }
  f.push_back(0);
  f.push_back(0x3B);
  if ((int64_t)f.size() <= cap) std::memcpy(out, f.data(), f.size());
  return (int64_t)f.size();
}


// info: width, height, background index, global table entries (0 for
// none), offset of the first block after the table. palette: 256 RGB
// entries (zeros past the table). 0, or -1 with the reason in err.
int mga_gif_header(const uint8_t* d, int64_t n, int32_t* info, uint8_t* palette, char* err, int errlen) {
    if (n < 13 || std::memcmp(d, "GIF8", 4) || (d[4] != '7' && d[4] != '9') || d[5] != 'a')
        return std::snprintf(err, errlen, "not a GIF file"), -1;
    const int flags = d[10];
    const int entries = flags & 0x80 ? 2 << (flags & 7) : 0;
    if (13 + 3 * entries > n) return std::snprintf(err, errlen, "truncated GIF colour table"), -1;
    std::memset(palette, 0, 768);
    std::memcpy(palette, d + 13, 3 * entries);
    info[0] = rd16(d + 6);
    info[1] = rd16(d + 8);
    info[2] = d[11];
    info[3] = entries;
    info[4] = 13 + 3 * entries;
    return 0;
}

// The next image from offset `off` (blocks before it: extensions). info:
// left, top, width, height, interlaced, local table entries (0 for none),
// disposal, delay (1/100 s), transparent index (-1 for none), whether a
// graphic control extension came before the image, the offset after the
// image. palette: the local table's 256 RGB entries. The image's indices go
// to out[0, width * height) in row order (with out null, the LZW data is
// passed over undecoded). Returns 1 for an image, 0 at the trailer, -2 when
// out holds fewer than width * height bytes (info filled), -1 with the
// reason in err.
int mga_gif_frame(const uint8_t* d, int64_t n, int64_t off, int64_t* info, uint8_t* palette, uint8_t* out,
                  int64_t cap, char* err, int errlen) {
    int disposal = 0, delay = 0, transparent = -1, gce = 0;
    for (;;) {
        if (off >= n) return std::snprintf(err, errlen, "truncated GIF (no trailer)"), -1;
        const int block = d[off++];
        if (block == 0x3B) return 0;
        if (block == 0x21) {
            if (off >= n) return std::snprintf(err, errlen, "truncated GIF extension"), -1;
            const int label = d[off++];
            if (label == 0xF9 && off + 6 <= n && d[off] >= 4) {
                const int packed = d[off + 1];
                disposal = (packed >> 2) & 7;
                delay = rd16(d + off + 2);
                transparent = packed & 1 ? d[off + 4] : -1;
                gce = 1;
            }
            off = sub_blocks(d, n, off, nullptr);
            if (off < 0) return std::snprintf(err, errlen, "truncated GIF extension"), -1;
            continue;
        }
        if (block != 0x2C)
            return std::snprintf(err, errlen, "corrupt GIF (block 0x%02x at %lld)", block, (long long)(off - 1)), -1;
        if (off + 9 > n) return std::snprintf(err, errlen, "truncated GIF image descriptor"), -1;
        const int x = rd16(d + off), y = rd16(d + off + 2), w = rd16(d + off + 4), h = rd16(d + off + 6);
        const int flags = d[off + 8];
        off += 9;
        const int entries = flags & 0x80 ? 2 << (flags & 7) : 0;
        if (off + 3 * entries > n) return std::snprintf(err, errlen, "truncated GIF colour table"), -1;
        std::memset(palette, 0, 768);
        std::memcpy(palette, d + off, 3 * entries);
        off += 3 * entries;
        const int interlaced = (flags >> 6) & 1;
        const int64_t vals[10] = {x, y, w, h, interlaced, entries, disposal, delay, transparent, gce};
        std::memcpy(info, vals, sizeof vals);
        if (off >= n) return std::snprintf(err, errlen, "truncated GIF image"), -1;
        const int min_size = d[off++];
        std::vector<uint8_t> codes;
        off = sub_blocks(d, n, off, &codes);
        if (off < 0) return std::snprintf(err, errlen, "truncated GIF image data"), -1;
        info[10] = off;
        const int64_t count = (int64_t)w * h;
        if (!out) return 1;
        if (cap < count) return -2;
        if (!count) return 1;
        if (min_size < 2 || min_size > 8)
            return std::snprintf(err, errlen, "corrupt GIF image (LZW minimum code size %d)", min_size), -1;
        std::vector<uint8_t> rows(interlaced ? count : 0);
        uint8_t* dst = interlaced ? rows.data() : out;
        const int rc = lzw(codes, min_size, dst, count);
        if (rc == -1) return std::snprintf(err, errlen, "corrupt GIF LZW data (a code its table does not hold)"), -1;
        if (rc == -2) return std::snprintf(err, errlen, "the GIF LZW data ends before the image is full"), -1;
        if (interlaced) {  // passes of rows 0 mod 8, 4 mod 8, 2 mod 4, 1 mod 2
            static const int start[4] = {0, 4, 2, 1}, step[4] = {8, 8, 4, 2};
            int64_t r = 0;
            for (int p = 0; p < 4; ++p)
                for (int row = start[p]; row < h; row += step[p], ++r)
                    std::memcpy(out + (int64_t)row * w, rows.data() + r * w, w);
        }
        return 1;
    }
}

}  // extern "C"
