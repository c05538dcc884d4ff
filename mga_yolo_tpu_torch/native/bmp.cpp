// BMP decoding on the host, as cv2.imread reads it (OpenCV's grfmt_bmp.cpp):
// uncompressed (BI_RGB) files of 1, 4 or 8 bits with a palette, or of 24 or
// 32 bits; bottom-up and top-down rows; the 40-byte and later info headers
// (not the 12-byte OS/2 one). Colour reads give BGR (a 32-bit pixel's fourth
// byte dropped); grey reads convert BGR as cv2 does (14-bit fixed point,
// rounded). RLE, bit-field, 16-bit and embedded JPEG/PNG files are refused
// with their names, as is a file whose pixels run past its end.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

struct Bmp {
  int width = 0, height = 0, bpp = 0;
  bool bottom_up = true;
  int64_t offset = 0;
  uint8_t palette[256][3] = {};  // B, G, R
};

uint32_t rd32(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24); }
int rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }

const char* compression_name(uint32_t c) {
  switch (c) {
    case 1: return "RLE8";
    case 2: return "RLE4";
    case 3: return "BI_BITFIELDS";
    case 4: return "embedded JPEG";
    case 5: return "embedded PNG";
    case 6: return "BI_ALPHABITFIELDS";
    default: return "unknown";
  }
}

// 0, or -1 with the reason in err.
int parse(const uint8_t* d, int64_t n, Bmp& b, char* err, int errlen) {
  if (n < 26 || d[0] != 'B' || d[1] != 'M') return snprintf(err, (size_t)errlen, "not a BMP file"), -1;
  b.offset = rd32(d + 10);
  const uint32_t size = rd32(d + 14);
  if (size < 36) return snprintf(err, (size_t)errlen, "BMP with an info header of %u bytes is not supported", size), -1;
  if (n < 14 + 36) return snprintf(err, (size_t)errlen, "truncated BMP header"), -1;
  const int32_t w = (int32_t)rd32(d + 18), h = (int32_t)rd32(d + 22);
  b.bpp = rd16(d + 28);
  const uint32_t comp = rd32(d + 30), clrused = rd32(d + 46);
  if (comp != 0)
    return snprintf(err, (size_t)errlen, "BMP with %s compression is not supported (uncompressed BI_RGB only)",
                    compression_name(comp)), -1;
  if (h == INT32_MIN) return snprintf(err, (size_t)errlen, "corrupt BMP header"), -1;
  b.width = w;
  b.height = h < 0 ? -h : h;
  b.bottom_up = h > 0;
  if (b.bpp != 1 && b.bpp != 4 && b.bpp != 8 && b.bpp != 24 && b.bpp != 32)
    return snprintf(err, (size_t)errlen, "%d-bit BMP is not supported (1, 4, 8, 24 or 32 bits)", b.bpp), -1;
  int entries = 0;
  if (b.bpp <= 8) {
    if (clrused > 256) return snprintf(err, (size_t)errlen, "corrupt BMP palette"), -1;
    entries = clrused ? (int)clrused : 1 << b.bpp;
  }
  if (b.width <= 0 || b.height == 0)
    return snprintf(err, (size_t)errlen, "BMP of %dx%d pixels", b.width, b.height), -1;
  if ((int64_t)b.width * b.height > ((int64_t)1 << 30))
    return snprintf(err, (size_t)errlen, "BMP of %dx%d pixels is past the limit of 2^30 pixels", b.width, b.height), -1;
  const int64_t pal_at = 14 + (int64_t)size;  // BGRx entries after the info header
  if (pal_at + (int64_t)entries * 4 > n) return snprintf(err, (size_t)errlen, "truncated BMP palette"), -1;
  for (int i = 0; i < entries; ++i) std::memcpy(b.palette[i], d + pal_at + (int64_t)i * 4, 3);
  return 0;
}

// cv2's icvCvt_BGR2Gray_8u_C3C1R: (B 1868 + G 9617 + R 4899 + 2^13) >> 14.
inline uint8_t gray_of(const uint8_t* bgr) {
  constexpr int cR = (int)(0.299 * (1 << 14) + 0.5), cG = (int)(0.587 * (1 << 14) + 0.5), cB = (1 << 14) - cR - cG;
  return (uint8_t)((bgr[0] * cB + bgr[1] * cG + bgr[2] * cR + (1 << 13)) >> 14);
}

}  // namespace

extern "C" {

// info: height, width, bits per pixel.
int mga_bmp_header(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  Bmp b;
  if (parse(data, n, b, err, errlen)) return -1;
  info[0] = b.height;
  info[1] = b.width;
  info[2] = b.bpp;
  return 0;
}

// Decodes into out: (h, w, 3) BGR, or (h, w) when gray.
int mga_bmp_decode(const uint8_t* data, int64_t n, int gray, uint8_t* out, int32_t h, int32_t w, char* err,
                   int errlen) {
  Bmp b;
  if (parse(data, n, b, err, errlen)) return -1;
  if (b.height != h || b.width != w) return snprintf(err, (size_t)errlen, "BMP size differs from the buffer given"), -1;
  const int64_t pitch = (((int64_t)b.width * b.bpp + 7) / 8 + 3) & ~(int64_t)3;
  if (b.offset < 0 || b.offset + pitch * b.height > n)
    return snprintf(err, (size_t)errlen, "truncated BMP: pixel data runs past the end of the file"), -1;
  uint8_t gray_palette[256];
  for (int i = 0; i < 256; ++i) gray_palette[i] = gray_of(b.palette[i]);
  const int ch = gray ? 1 : 3;
  for (int y = 0; y < b.height; ++y) {
    const uint8_t* src = data + b.offset + pitch * y;
    const int oy = b.bottom_up ? b.height - 1 - y : y;
    uint8_t* o = out + (size_t)oy * b.width * ch;
    for (int x = 0; x < b.width; ++x, o += ch) {
      if (b.bpp <= 8) {
        const int per = 8 / b.bpp, shift = 8 - b.bpp * (x % per + 1);
        const int idx = (src[x / per] >> shift) & ((1 << b.bpp) - 1);
        if (gray) *o = gray_palette[idx];
        else std::memcpy(o, b.palette[idx], 3);
      } else {
        const uint8_t* px = src + (int64_t)x * (b.bpp / 8);
        if (gray) *o = gray_of(px);
        else std::memcpy(o, px, 3);
      }
    }
  }
  return 0;
}

}  // extern "C"
