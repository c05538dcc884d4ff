"""Image decoding and encoding without OpenCV or PIL: PNG and the TIFF,
WebP and GIF containers in Python (the standard library's ``zlib``
inflates), their byte loops and the JPEG, BMP, TIFF, WebP and GIF codecs
in the host C++ library (``mga_yolo_tpu_torch.native``).

The card's host has no OpenCV and no PIL, so the port reads and writes its
images itself, and reads every still format the JAX package's ``IMG_EXTS``
lists, and the ones its server's ``cv2.imdecode`` takes beyond them, as
cv2 reads them, to the bit:

* PNG, bit depths 1, 2, 4, 8 and 16 in the five colour types (grey, grey +
  alpha, RGB, RGBA, palette, with tRNS), all five row filters, Adam7
  interlace; libpng's transforms as cv2 asks for them (grey expanded to 8
  bits, 16 bits cut to the high byte, alpha dropped, RGB -> grey at the
  file's depth, through the file's gamma when a ``gAMA`` or ``sRGB`` chunk
  gives one); sub-byte unpacking, the 16-bit strip and the Adam7 scatter
  in ``native/maskops.cpp`` beside the row unfilter;
* JPEG, Huffman-coded, 8-bit, grey or 3-component, baseline, extended or
  progressive, as libjpeg decodes it for cv2 (``native/jpeg.cpp``);
* BMP, uncompressed, 1, 4 or 8 bits with a palette, 24 or 32 bits
  (``native/bmp.cpp``);
* TIFF, classic, either byte order, the first page: strips or tiles,
  chunky or planar, uncompressed, LZW (``native/tiff.cpp``), Deflate,
  PackBits, JPEG (``native/jpeg.cpp``, with the JPEGTables tag) or CCITT
  (modified Huffman, T.4 1-D and 2-D, T.6: ``native/tiff.cpp``), grey
  (1, 8, 16 bits, MinIsWhite or MinIsBlack), RGB (8, 16), palette (1, 4,
  8) and YCbCr JPEG, extra samples, the horizontal predictor and FillOrder
  2, put together as libtiff's RGBA interface does for cv2 (16-bit colour
  rounded to 8 bits, unassociated alpha multiplied in);
* WebP, lossless (VP8L) and lossy (VP8, libwebp's fancy upsampling and
  YUV -> BGR), simple or extended (VP8X), alpha dropped, an animation's
  first frame on its canvas (``native/webp.cpp``);
* GIF, its first frame as cv2's own GIF codec puts it on the canvas
  (``native/gif.cpp``; a GIF read as a video is ``data/video_io.py``'s);
* PNM / PAM / PFM, Sun raster and Radiance HDR (``data/raster_io.py``),
  which only the JAX server's uploads and single files named to its
  predictor reach.

The EXIF orientation is applied as cv2 applies it: a JPEG's APP1, a PNG's
eXIf chunk (before or after the image data), a TIFF's Orientation tag, a
WebP's EXIF chunk. CMYK, 12-bit, arithmetic-coded and lossless JPEGs,
compressed BMPs, TIFF compressions other than those above (LZMA, ZSTD,
WebP, old-style JPEG, LERC, JPEG 2000), float or 32-bit TIFF samples,
BigTIFF, raw YCbCr TIFF, JPEG 2000, AVIF and every other format raise
``ValueError`` naming the file and the feature, as do truncated or
corrupt files. Dispatch is on the
file's signature, not its suffix.

``imread`` / ``imdecode`` return what ``cv2.imread(path)`` /
``cv2.imdecode(buf, IMREAD_COLOR)`` return: BGR (H, W, 3) uint8, grey
replicated, alpha dropped, a palette expanded. ``imread_gray`` returns what
``cv2.IMREAD_GRAYSCALE`` returns: a grey PNG as it is and libpng's grey
conversion of a colour one, a JPEG's luma plane, cv2's own conversion of a
colour BMP or WebP, the 14-bit conversion cv2 applies to libtiff's RGBA
raster. ``imwrite`` writes by the path's suffix: ``.png``
with ``encode_png`` ((H, W) as grey, (H, W, 3) BGR as RGB, (H, W, 4) BGRA
as RGBA, every row with the Up filter), ``.jpg`` / ``.jpeg`` with
``encode_jpeg`` (the bytes ``cv2.imwrite`` writes, quality 95). The host
C++ library raises when it cannot be built; :func:`unfilter_rows`,
:func:`unpack_bits`, :func:`adam7_scatter`, :func:`strip16`,
:func:`rgb16_to_gray`, :func:`cvt_gray`, :func:`tiff_gray`,
:func:`png_gray`, :func:`lzw_expand`, :func:`packbits_expand` and
:func:`undo_predictor` are its helpers' numpy twins, the tests' oracle.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from mga_yolo_tpu_torch import native
from mga_yolo_tpu_torch.data import raster_io

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
BMP_SIGNATURE = b"BM"
JPEG_QUALITY = 95  # cv2.imwrite's default
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")  # classic TIFF and BigTIFF, both byte orders
# formats the port still refuses, named in its message: JPEG 2000 (codestream and JP2 box) and AVIF / HEIF
_SIGNATURES = ((b"\xff\x4f\xff\x51", "JPEG 2000"), (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000 (JP2)"))
READS = "PNG, JPEG, BMP, TIFF, WebP, GIF, PNM / PAM / PFM, Sun raster and Radiance HDR"


def _what(data: bytes) -> str:
    if data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis", b"heic", b"heix", b"mif1", b"msf1"):
        return f"AVIF / HEIF ('{data[8:12].decode()}'), which the port does not read"
    return next((f"{name}, which the port does not read" for sig, name in _SIGNATURES if data.startswith(sig)),
                "not an image the port reads")


def unfilter_rows(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Numpy twin of the C++ ``png_unfilter_u8``: undo PNG's filter of each
    row (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth). Sub and Up are vectorised;
    Average and Paeth walk the row a pixel at a time."""
    rows = np.asarray(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft, s = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ft == 0:
            r = s
        elif ft == 1:
            r = np.cumsum(np.pad(s, (0, -stride % bpp)).reshape(-1, bpp), 0).reshape(-1)[:stride] & 255
        elif ft == 2:
            r = (s + prev) & 255
        elif ft in (3, 4):
            r = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                a = r[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prev[x:x + bpp]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    q = a + b - c
                    pa, pb, pc = np.abs(q - a), np.abs(q - b), np.abs(q - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                r[x:x + bpp] = (s[x:x + bpp] + pred) & 255
        else:
            raise ValueError(f"PNG row {y} has filter type {ft}")
        out[y] = r
        prev = r.astype(np.int32)
    return out


_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}  # colour type -> bit depths


def unpack_bits(rows: np.ndarray, n: int, depth: int, scale: int) -> np.ndarray:
    """Numpy twin of the C++ ``png_unpack_u8``: (h, n) bytes from rows of
    ``depth``-bit samples, the first in the high bits, each times ``scale``."""
    rows = np.asarray(rows, np.uint8)
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    s = (rows[..., None] >> shifts) & ((1 << depth) - 1)
    return (s.reshape(rows.shape[0], -1)[:, :n] * scale).astype(np.uint8)


def adam7_scatter(pixels: np.ndarray, p: int, out: np.ndarray) -> None:
    """Numpy twin of the C++ ``png_adam7_scatter_u8``: pass ``p``'s pixels
    into the whole image ``out``, in place."""
    x0, y0, dx, dy = native.ADAM7[p]
    ph, pw = pixels.shape[:2]
    out[y0:y0 + ph * dy:dy, x0:x0 + pw * dx:dx] = pixels


def strip16(samples: np.ndarray) -> np.ndarray:
    """Numpy twin of the C++ ``png_strip16_u8``: each big-endian 16-bit sample's high byte."""
    return np.ascontiguousarray(np.asarray(samples, np.uint8)[..., 0::2])


def rgb16_to_gray(pixels: np.ndarray) -> np.ndarray:
    """Numpy twin of the C++ ``png_rgb16_to_gray_u8``: libpng's rgb_to_gray
    on 16-bit samples (cv2's weights, rounded), then the high byte."""
    v = np.asarray(pixels, np.uint8).astype(np.uint32)
    r, g, b = ((v[..., 2 * i] << 8) | v[..., 2 * i + 1] for i in range(3))
    return (((9797 * r + 19234 * g + 3737 * b + 16384) >> 15) >> 8).astype(np.uint8)


def _png_pixels(raw: np.ndarray, w: int, h: int, depth: int, ctype: int, interlace: int, name: str) -> np.ndarray:
    """(h, w, B) uint8 pixels from the inflated IDAT bytes: rows unfiltered,
    1/2/4-bit samples unpacked to a byte each (grey scaled to 8 bits as
    libpng expands it, palette indices as they are), 16-bit samples as two
    big-endian bytes, Adam7's seven passes put in their places."""
    spp = _CHANNELS[ctype]
    scale = 1 if ctype == 3 else 255 // ((1 << depth) - 1) if depth < 8 else 1
    px = spp * max(depth, 8) // 8
    if interlace:
        passes = [(p, -(-(w - x0) // dx) if w > x0 else 0, -(-(h - y0) // dy) if h > y0 else 0)
                  for p, (x0, y0, dx, dy) in enumerate(native.ADAM7)]
        out = np.empty((h, w, px), np.uint8)
    else:
        passes, out = [(0, w, h)], None
    pos = 0
    for p, pw, ph in passes:
        if not pw or not ph:  # an empty pass has no rows, not even filter bytes
            continue
        stride = (pw * spp * depth + 7) // 8
        n = ph * (stride + 1)
        if raw.size < pos + n:
            want = pos + n + sum(ph_ * ((pw_ * spp * depth + 7) // 8 + 1) for q, pw_, ph_ in passes if q > p and pw_)
            raise ValueError(f"{name}: PNG data holds {raw.size} bytes, want {want}")
        rows = native.png_unfilter(raw[pos:pos + n], ph, stride, max(1, spp * depth // 8))
        pos += n
        if depth < 8:
            rows = native.png_unpack(rows, pw * spp, depth, scale)
        pix = rows.reshape(ph, pw, px)
        if out is None:
            return pix
        native.png_adam7_scatter(pix, p, out)
    return out


class _Png(NamedTuple):
    pix: np.ndarray  # see _png_pixels
    depth: int
    ctype: int
    palette: Optional[np.ndarray]
    trns: Optional[np.ndarray]
    orientation: int  # EXIF, 0 when none
    gamma: int  # the file's gamma in libpng's fixed point (sRGB's 45455), 0 when none
    sbit: int  # significant bits of the colour samples (sBIT), 0 when none


def _png(data: bytes, name: str) -> _Png:
    """A PNG's pixels and what its chunks say of them."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name}: {_what(data)}, not a PNG")
    pos, idat, palette, trns, ihdr, orientation = 8, [], None, None, None, 0
    gama, srgb, sbit = 0, False, 0
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        early = palette is None and not idat  # libpng takes gAMA, sRGB and sBIT only before PLTE and IDAT
        if kind == b"IHDR":
            if n != 13:
                raise ValueError(f"{name}: PNG IHDR chunk of {n} bytes")
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:n - n % 3], np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf" and not orientation:  # before or after the IDAT chunks; a raw TIFF structure
            orientation = _tiff_orientation(body)
        elif kind == b"gAMA" and early and n == 4 and not gama:
            gama = int.from_bytes(body, "big")
        elif kind == b"sRGB" and early and n == 1:
            srgb = True
        elif kind == b"sBIT" and early and ihdr is not None and n == {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}.get(ihdr[3]) \
                and all(0 < v <= (8 if ihdr[3] == 3 else ihdr[2]) for v in body):
            sbit = max(body[:3]) if ihdr[3] & 2 else body[0]
        elif kind == b"IEND":
            break
        pos += 12 + n
    if ihdr is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype} is not valid")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"{name}: PNG of bit depth {depth} in colour type {ctype} is not valid")
    if interlace > 1:
        raise ValueError(f"{name}: PNG interlace method {interlace} is not valid")
    if not 0 < w < 2 ** 31 or not 0 < h < 2 ** 31 or w * h > 2 ** 30:
        raise ValueError(f"{name}: PNG of {w} x {h} pixels is past the limit of 2^30 pixels")
    spp = _CHANNELS[ctype]
    passes = [(-(-(w - x0) // dx), -(-(h - y0) // dy)) if w > x0 and h > y0 else (0, 0)
              for x0, y0, dx, dy in native.ADAM7] if interlace else [(w, h)]
    need = sum(ph * ((pw * spp * depth + 7) // 8 + 1) for pw, ph in passes if pw)
    try:  # inflate no more than the image holds
        raw = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat), need), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG data ({e})") from None
    return _Png(_png_pixels(raw, w, h, depth, ctype, interlace, name), depth, ctype, palette, trns, orientation,
                45455 if srgb else gama, sbit)


def _recip(g: int) -> int:
    """libpng's ``png_reciprocal`` of a fixed-point gamma."""
    return int(np.floor(1e10 / g + 0.5))


def _significant(g: int) -> bool:
    """libpng's ``png_gamma_significant``: more than 5% from 1."""
    return g < 95000 or g > 105000


def _gamma8(g: int) -> np.ndarray:
    """libpng's ``png_build_8bit_table``: 255 (i / 255)^g, rounded."""
    t = np.arange(256)
    if not _significant(g):
        return t
    out = np.floor(255 * np.power(t / 255.0, g * 1e-5) + 0.5).astype(np.int64)
    out[0], out[255] = 0, 255
    return out


def _gamma16(shift: int, g: int) -> np.ndarray:
    """libpng's ``png_build_16bit_table``, indexed by the sample >> shift."""
    n = 1 << (16 - shift)
    ig = np.arange(n, dtype=np.int64)
    if not _significant(g):
        return (ig * 65535 + (1 << (15 - shift))) // (n - 1) if shift else ig
    return np.floor(65535.0 * np.power(ig / (n - 1), g * 1e-5) + 0.5).astype(np.int64)


def _gamma16to8(shift: int, g: int) -> np.ndarray:
    """libpng's ``png_build_16to8_table``, indexed by the sample >> shift:
    the nearest of the 256 values i * 257 after the gamma."""
    top = (1 << (16 - shift)) - 1
    out = np.full(top + 1, 65535, np.int64)
    last = 0
    for i in range(255):
        v = i * 257 + 128
        bound = int(np.floor(65535 * (v / 65535.0) ** (g * 1e-5) + 0.5)) if 0 < v < 65535 else v
        bound = (bound * top + 32768) // 65535 + 1
        if bound > last:
            out[last:bound] = i * 257
            last = bound
    return out


def png_gamma_gray(rgb: np.ndarray, depth: int, gamma: int, sbit: int) -> np.ndarray:
    """libpng's ``rgb_to_gray`` with the file's gamma, as cv2's grey read of
    an RGB or palette PNG with a significant ``gAMA`` or ``sRGB`` gets it:
    each sample to linear light, cv2's weights (15-bit, rounded), back to
    the file's gamma; a grey pixel (R = G = B) passes as it is (at 16 bits
    through libpng's 16-to-8 table). ``rgb`` is (h, w, 3) uint8 or uint16
    samples; returns (h, w) uint8."""
    screen = _recip(gamma)
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    grey = (r == g) & (r == b)
    if depth == 8:
        to1, from1 = _gamma8(_recip(gamma)), _gamma8(_recip(screen))
        out = from1[(9797 * to1[r] + 19234 * to1[g] + 3737 * to1[b] + 16384) >> 15]
        return np.where(grey, r, out).astype(np.uint8)
    shift = min(max(16 - sbit if 0 < sbit < 16 else 0, 5), 8)  # 16 - PNG_MAX_GAMMA_8 = 5 when cut to 8 bits
    to1, from1 = _gamma16(shift, _recip(gamma)), _gamma16(shift, _recip(screen))
    lin = (9797 * to1[r >> shift] + 19234 * to1[g >> shift] + 3737 * to1[b >> shift] + 16384) >> 15
    product = int(np.floor(gamma * screen * 1e-5 + 0.5))
    out = np.where(grey, _gamma16to8(shift, product)[r >> shift], from1[lin >> shift])
    return (out >> 8).astype(np.uint8)


def _png_samples(pix: np.ndarray, depth: int, ctype: int, palette, trns, name: str) -> np.ndarray:
    img = native.png_strip16(pix) if depth == 16 else pix
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without a PLTE chunk")
        idx = img[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError(f"{name}: palette index outside its PLTE chunk")
        img = palette[idx]
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[:len(trns)] = trns[:len(palette)]
            img = np.concatenate([img, alpha[idx][..., None]], -1)
    return img


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 in the file's sample order and
    orientation: grey (C=1), grey + alpha (2), RGB (3), RGBA (4); a palette
    expands to RGB, or RGBA when it has a tRNS chunk; 16-bit samples keep
    their high byte and 1/2/4-bit grey expands to 8 bits, as libpng does."""
    png = _png(data, name)
    return _png_samples(png.pix, png.depth, png.ctype, png.palette, png.trns, name)


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """``img`` as an EXIF ``orientation`` (1-8; 0 for none) asks it shown,
    as cv2 applies it: 2 mirrors, 3 turns half round, 4 flips, 5 transposes,
    6 turns a quarter clockwise, 7 transposes across the other diagonal,
    8 turns a quarter anticlockwise."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
        orientation = {5: 1, 6: 2, 7: 3, 8: 4}[orientation]
    if orientation in (2, 3):
        img = img[:, ::-1]
    if orientation in (3, 4):
        img = img[::-1]
    return np.ascontiguousarray(img)


# ------------------------------------------------------------------ TIFF

_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 7: "B", 16: "Q"}  # the unsigned types; a tag of another is passed over
_TIFF_REFUSED = {6: "old-style JPEG", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP", 34887: "LERC", 34712: "JPEG 2000"}
_TIFF_CCITT = (2, 3, 4)  # modified Huffman, T.4 (Group 3), T.6 (Group 4)
_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))  # FillOrder 2


def _tiff_tags(data: bytes, name: str) -> tuple[str, dict]:
    """The byte order and the tags of a TIFF's first IFD: tag -> tuple of
    values (JPEGTables as bytes)."""
    bo = "<" if data[:2] == b"II" else ">"
    if len(data) < 8:
        raise ValueError(f"{name}: truncated TIFF header")
    version, off = struct.unpack(bo + "HI", data[2:8])
    if version == 43:
        raise ValueError(f"{name}: BigTIFF; the port reads classic TIFF only")
    if off + 2 > len(data):
        raise ValueError(f"{name}: TIFF IFD at {off} past the end of the file")
    tags = {}
    for i in range(struct.unpack(bo + "H", data[off:off + 2])[0]):
        e = off + 2 + 12 * i
        if e + 12 > len(data):
            raise ValueError(f"{name}: truncated TIFF IFD")
        tag, typ, cnt = struct.unpack(bo + "HHI", data[e:e + 8])
        if typ not in _TIFF_TYPES:
            continue
        size = struct.calcsize(_TIFF_TYPES[typ]) * cnt
        if size <= 4:
            raw = data[e + 8:e + 8 + size]
        else:
            at = struct.unpack(bo + "I", data[e + 8:e + 12])[0]
            raw = data[at:at + size]
            if len(raw) != size:
                raise ValueError(f"{name}: TIFF tag {tag} points past the end of the file")
        tags[tag] = raw if tag == 347 else struct.unpack(bo + _TIFF_TYPES[typ] * cnt, raw)
    return bo, tags


def lzw_expand(data: bytes, size: int) -> np.ndarray:
    """Python twin of the C++ ``mga_tiff_lzw``: ``size`` bytes from TIFF LZW
    data (codes of 9-12 bits, high bits first, the width growing one code
    early, 256 clears the table, 257 ends)."""
    out, bits, pos, width = bytearray(), int.from_bytes(data, "big"), 0, 9
    nbits, table, prev = len(data) * 8, [bytes([i]) for i in range(256)] + [b"", b""], None
    while len(out) < size:
        if pos + width > nbits:
            raise ValueError("the data ends before the strip or tile is full")
        code = (bits >> (nbits - pos - width)) & ((1 << width) - 1)
        pos += width
        if code == 257:
            break
        if code == 256:
            table, prev, width = table[:258], None, 9
            continue
        if prev is None:
            entry = table[code] if code < 256 else None
            if entry is None:
                raise ValueError("corrupt LZW data (a code its table does not hold)")
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("corrupt LZW data (a code its table does not hold)")
        out += entry
        prev = entry
        if len(table) + 1 >= 1 << width and width < 12:
            width += 1
    if len(out) < size:
        raise ValueError(f"the data holds {len(out)} bytes of a strip or tile of {size}")
    return np.frombuffer(bytes(out[:size]), np.uint8)


def packbits_expand(data: bytes, size: int) -> np.ndarray:
    """Python twin of the C++ ``mga_tiff_packbits``."""
    out, i = bytearray(), 0
    while len(out) < size:
        if i >= len(data):
            raise ValueError("the data ends before the strip or tile is full")
        c = data[i] - 256 if data[i] > 127 else data[i]
        i += 1
        if c >= 0:
            if i + c + 1 > len(data):
                raise ValueError("the data ends before the strip or tile is full")
            out += data[i:i + c + 1]
            i += c + 1
        elif c != -128:
            if i >= len(data):
                raise ValueError("the data ends before the strip or tile is full")
            out += bytes([data[i]]) * (1 - c)
            i += 1
    return np.frombuffer(bytes(out[:size]), np.uint8)


def undo_predictor(buf: np.ndarray, rows: int, row_samples: int, spp: int, bits: int, big_endian: bool) -> np.ndarray:
    """Numpy twin of the C++ ``mga_tiff_predict``, returning a new buffer."""
    dtype = np.dtype((">" if big_endian else "<") + "u2") if bits == 16 else np.dtype(np.uint8)
    v = np.frombuffer(np.ascontiguousarray(buf).tobytes(), dtype, rows * row_samples).reshape(rows, -1, spp)
    return np.cumsum(v, 1, dtype=np.uint64).astype(dtype).view(np.uint8).reshape(-1)


def _tiff_chunk(raw: bytes, comp: int, size: int, name: str, cols: int = 0, t4: int = 0) -> np.ndarray:
    """A strip's or tile's ``size`` bytes from its compressed data (a CCITT
    one of 1-bit rows ``cols`` pixels wide, ``t4`` its T4Options)."""
    try:
        if comp in _TIFF_CCITT:
            return native.tiff_fax(raw, comp, t4, cols, size // ((cols + 7) // 8))
        if comp == 1:
            if len(raw) < size:
                raise ValueError(f"the data holds {len(raw)} bytes of a strip or tile of {size}")
            return np.frombuffer(raw, np.uint8, size)
        if comp == 5:
            return native.tiff_lzw(raw, size)
        if comp == 32773:
            return native.tiff_packbits(raw, size)
        try:
            out = zlib.decompressobj().decompress(raw, size)
        except zlib.error as e:
            raise ValueError(f"corrupt Deflate data ({e})") from None
        if len(out) < size:
            raise ValueError(f"the data holds {len(out)} bytes of a strip or tile of {size}")
        return np.frombuffer(out, np.uint8)
    except ValueError as e:
        raise ValueError(f"{name}: TIFF {e}") from None


def _tiff_bgr(samples: np.ndarray, photometric: int, bits: int, alpha: int, colormap) -> np.ndarray:
    """(h, w, 3) BGR uint8 as libtiff's RGBA interface gives it to cv2: grey
    through its photometric map (16-bit by the high byte), 16-bit colour
    rounded to 8 bits, unassociated alpha multiplied in, a palette of
    16-bit entries cut to their high byte."""
    if photometric in (0, 1):
        v = samples[..., 0]
        v = (v * 255).astype(np.uint8) if bits == 1 else (v >> 8).astype(np.uint8) if bits == 16 else v
        return native.gray_to_bgr(255 - v if photometric == 0 else v)
    if photometric == 3:
        cmap = np.asarray(colormap, np.int32).reshape(3, -1)[::-1]
        if cmap.max() >= 256:
            cmap = cmap >> 8
        return np.ascontiguousarray(cmap.astype(np.uint8).T[samples[..., 0]])
    if bits == 8 and alpha != 2:
        return np.ascontiguousarray(samples[..., 2::-1])
    rgba = samples.astype(np.int32)
    if bits == 16:
        rgba = (rgba * 255 + 32767) // 65535
    bgr = rgba[..., 2::-1]
    if alpha == 2:  # unassociated: libtiff multiplies it in
        bgr = (bgr * rgba[..., 3:4] + 127) // 255
    return bgr.astype(np.uint8)


def _tiff(data: bytes, name: str, gray: bool) -> np.ndarray:
    """TIFF bytes -> BGR (H, W, 3) or grey (H, W) uint8, as cv2 reads it
    through libtiff's RGBA interface."""
    bo, t = _tiff_tags(data, name)

    def one(tag, default=None):
        v = t.get(tag)
        return v[0] if v else default

    w, h = one(256), one(257)
    if not w or not h:
        raise ValueError(f"{name}: TIFF without its width or height")
    if w * h > 2 ** 30:
        raise ValueError(f"{name}: TIFF of {w} x {h} pixels is past the limit of 2^30 pixels")
    comp, spp, planar = one(259, 1), one(277, 1), one(284, 1)
    bits_all = t.get(258, (1,))
    bits = bits_all[0]
    if comp in _TIFF_REFUSED:
        raise ValueError(f"{name}: TIFF compressed with {_TIFF_REFUSED[comp]} (compression {comp}); "
                         f"the port reads none, LZW, Deflate, PackBits, JPEG and CCITT")
    if comp not in (1, 2, 3, 4, 5, 7, 8, 32773, 32946):
        raise ValueError(f"{name}: TIFF compression {comp}; the port reads none, LZW, Deflate, PackBits, JPEG and CCITT")
    if comp in _TIFF_CCITT and (bits != 1 or spp != 1):
        raise ValueError(f"{name}: CCITT-compressed TIFF of {spp} samples of {bits} bits a pixel; CCITT codes 1-bit "
                         f"samples, one a pixel")
    if any(b != bits for b in bits_all):
        raise ValueError(f"{name}: TIFF with samples of {'/'.join(map(str, bits_all))} bits")
    if any(f == 3 for f in t.get(339, (1,))):
        raise ValueError(f"{name}: TIFF of floating-point samples, which cv2 does not read as 8 bits either")
    if any(f == 2 for f in t.get(339, (1,))):
        raise ValueError(f"{name}: TIFF of signed samples")
    extras = t.get(338, ())
    alpha = 0
    if extras:
        alpha = 1 if extras[0] == 0 and spp > 3 else extras[0] if extras[0] in (1, 2) else 0
    photometric = one(262)
    if photometric is None:
        photometric = {1: 1, 3: 2}.get(spp - len(extras))
        if photometric is None:
            raise ValueError(f"{name}: TIFF without a PhotometricInterpretation tag")
    if photometric == 2 and not extras and spp == 4:
        alpha = 1
    if bits in (32, 64):
        raise ValueError(f"{name}: TIFF of {bits}-bit samples; cv2 can not handle images with {bits}-bit samples")
    if photometric == 6 and comp != 7:
        raise ValueError(f"{name}: raw YCbCr TIFF (not JPEG-compressed); the port reads YCbCr as JPEG-in-TIFF only")
    ok = {0: (1, 8, 16), 1: (1, 8, 16), 2: (8, 16), 3: (1, 4, 8), 6: (8,)}
    if photometric not in ok:
        raise ValueError(f"{name}: TIFF of photometric interpretation {photometric} (CMYK, Lab, ...); "
                         f"the port reads grey, RGB, palette and YCbCr JPEG")
    if bits not in ok[photometric]:
        raise ValueError(f"{name}: {bits}-bit TIFF of photometric interpretation {photometric}; cv2 reads 1, 8 "
                         f"and 16-bit grey, 8 and 16-bit RGB and 1, 4 and 8-bit palettes")
    channels = 3 if photometric in (2, 6) else 1
    if spp < channels or spp > 4 or (bits < 8 and spp != 1):
        raise ValueError(f"{name}: TIFF of {spp} samples a pixel at {bits} bits (photometric {photometric})")
    colormap = t.get(320)
    if photometric == 3 and (colormap is None or len(colormap) != 3 << bits):
        raise ValueError(f"{name}: palette TIFF without a colour map of {1 << bits} entries")
    predictor = one(317, 1) if comp in (5, 8, 32946) else 1  # the codecs libtiff runs the predictor for
    if predictor == 3:
        raise ValueError(f"{name}: TIFF with the floating-point predictor")
    if predictor not in (1, 2) or (predictor == 2 and bits not in (8, 16)):
        raise ValueError(f"{name}: TIFF with predictor {predictor} at {bits} bits")
    if comp == 7 and planar != 1:
        raise ValueError(f"{name}: JPEG-in-TIFF with separate planes")
    tiled = 322 in t
    if tiled:
        tw, th = one(322), one(323)
        offsets, counts = t.get(324), t.get(325)
        if not tw or not th or tw > 2 ** 24 or th > 2 ** 24 or tw * th * spp * max(1, bits // 8) >= 2 ** 30:
            raise ValueError(f"{name}: TIFF tiles of {tw} x {th} pixels (cv2 reads tiles under 1 GiB)")
    else:
        rps = one(278, h)
        rps = h if not rps or rps > h else rps
        tw, th = w, rps
        offsets, counts = t.get(273), t.get(279)
    if offsets is None or counts is None:
        raise ValueError(f"{name}: TIFF without its strip or tile offsets and byte counts")
    across, down = -(-w // tw), -(-h // th)
    planes = spp if planar == 2 else 1
    n = 1 if planar == 2 else spp
    if len(offsets) < across * down * planes or len(counts) < len(offsets):
        raise ValueError(f"{name}: TIFF holds {len(offsets)} strips or tiles, want {across * down * planes}")
    fill_reversed = one(266, 1) == 2
    tables = t.get(347, b"")
    dtype = np.dtype(bo + "u2") if bits == 16 else np.uint8
    full = np.zeros((h, w, spp), dtype)
    row_bytes = (tw * n * bits + 7) // 8
    # libtiff's RGBA interface reads the rows of a clipped rightmost tile of
    # 16-bit grey, or of 8-bit grey with an extra sample, from the wrong
    # place: cv2's pixels there are what _skewed_grey_tile reads
    skewed = tiled and w % tw and photometric in (0, 1) and planes == 1 and (bits == 16 or spp > 1)
    k = 0
    for plane in range(planes):
        for ty in range(down):
            for tx in range(across):
                raw = data[offsets[k]:offsets[k] + counts[k]]
                k += 1
                if fill_reversed:
                    raw = raw.translate(_REVERSED)
                rows = th if tiled else min(th, h - ty * th)
                if comp == 7:
                    block = _tiff_jpeg(raw, tables, rows, tw, spp, name)
                else:
                    buf = _tiff_chunk(raw, comp, rows * row_bytes, name, tw, one(292, 0))
                    if predictor == 2:
                        buf = buf.copy()
                        native.tiff_predict(buf, rows, tw * n, n, bits, bo == ">")
                    if bits >= 8:
                        block = buf.view(dtype).reshape(rows, tw, n)
                        if skewed and tx == across - 1:
                            block = _skewed_grey_tile(buf, block, w - tx * tw, bits, n)
                    else:
                        block = native.png_unpack(buf.reshape(rows, row_bytes), tw * n, bits, 1).reshape(rows, tw, n)
                y, x = ty * th, tx * tw
                full[y:y + rows, x:x + tw, plane:plane + n] = block[:h - y, :w - x]
    orientation = one(274, 1)
    if tiled and orientation in (2, 3, 6, 7):
        # libtiff mirrors the order of the tiles in a row and not the pixels
        # within each: cv2's pixels are each tile mirrored in place, then
        # the orientation without its mirror
        for x in range(0, w, tw):
            full[:, x:x + tw] = full[:, x:x + tw][:, ::-1].copy()
        orientation = {2: 1, 3: 4, 6: 7, 7: 6}[orientation]
    if planes > 1 and photometric in (0, 1):  # separate grey planes go through libtiff's RGB path
        full, photometric = full[..., [0, 0, 0, 1]], 2
    bgr = _tiff_bgr(full, photometric, bits, alpha, colormap)
    if gray:  # cv2's BGRA -> grey of the RGBA raster, 14-bit weights, rounded
        return orient(native.bgr_to_gray(bgr, "tiff"), orientation)
    return orient(bgr, orientation)


def _skewed_grey_tile(buf: np.ndarray, block: np.ndarray, cols: int, bits: int, spp: int) -> np.ndarray:
    """A clipped rightmost grey tile as libtiff's put16bitbwtile and
    putgreytile / putagreytile read it: each row starts ``tw - cols`` bytes
    (not samples) past the end of the row before, and a 16-bit grey value
    is the high byte of the little-endian word at that byte."""
    rows, tw = block.shape[:2]
    width = bits // 8
    step = cols * width * spp + (tw - cols)
    at = np.arange(rows)[:, None] * step + np.arange(cols)[None] * width * spp
    out = block.copy()
    if bits == 16:
        host = block.astype("<u2").view(np.uint8).reshape(-1)
        out[:, :cols, 0] = host[at + 1].astype(np.uint16) << 8
    else:
        out[:, :cols, 0] = buf[at]
    return out


def _tiff_jpeg(raw: bytes, tables: bytes, rows: int, cols: int, spp: int, name: str) -> np.ndarray:
    """One JPEG strip or tile, its tables from the JPEGTables tag, decoded
    to (rows, cols, spp) samples (RGB for colour)."""
    stream = tables[:-2] + raw[2:] if tables[:2] == b"\xff\xd8" and raw[:2] == b"\xff\xd8" else raw
    try:
        img = native.jpeg_decode(stream, gray=spp == 1)
    except ValueError as e:
        raise ValueError(f"{name}: JPEG-in-TIFF: {e}") from None
    if img.shape[:2] != (rows, cols):
        raise ValueError(f"{name}: JPEG-in-TIFF strip or tile of {img.shape[1]} x {img.shape[0]}, "
                         f"want {cols} x {rows}")
    return img[..., None] if spp == 1 else np.ascontiguousarray(img[..., ::-1])


def tiff_gray(bgr: np.ndarray) -> np.ndarray:
    """Numpy twin of the C++ ``bgr_to_gray`` with the weights cv2 applies to
    libtiff's RGBA raster: (4899 R + 9617 G + 1868 B + 8192) >> 14."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14).astype(np.uint8)


def _tiff_size(data: bytes, name: str) -> tuple[int, int]:
    """(h, w) as cv2 gives a TIFF, from its first IFD."""
    _, t = _tiff_tags(data, name)
    w, h, o = t.get(256, (0,))[0], t.get(257, (0,))[0], t.get(274, (1,))[0]
    return (w, h) if o in (5, 6, 7, 8) else (h, w)


# ------------------------------------------------------------------ WebP


def _riff_chunks(data: bytes, start: int, end: int, name: str):
    """(fourcc, payload, payload offset) of each RIFF chunk in data[start:end]."""
    pos = start
    while pos + 8 <= end:
        kind, n = data[pos:pos + 4], int.from_bytes(data[pos + 4:pos + 8], "little")
        if pos + 8 + n > end:
            raise ValueError(f"{name}: truncated WebP chunk {kind!r}")
        yield kind, data[pos + 8:pos + 8 + n], pos + 8
        pos += 8 + n + (n & 1)


def _webp_frame_size(kind: bytes, payload: bytes, name: str) -> tuple[int, int]:
    """(h, w) from a VP8 or VP8L bitstream's header."""
    if kind == b"VP8L":
        if len(payload) < 5 or payload[0] != 0x2F:
            raise ValueError(f"{name}: not a VP8L bitstream")
        bits = int.from_bytes(payload[1:5], "little")
        return ((bits >> 14) & 0x3FFF) + 1, (bits & 0x3FFF) + 1
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{name}: not a VP8 key frame")
    return (int.from_bytes(payload[8:10], "little") & 0x3FFF), (int.from_bytes(payload[6:8], "little") & 0x3FFF)


def _webp_parse(data: bytes, name: str):
    """(canvas (h, w), frame (kind, payload, y, x, h, w), EXIF orientation)
    of a WebP: its still image, or its animation's first frame."""
    if len(data) < 20 or data[8:12] != b"WEBP":
        raise ValueError(f"{name}: RIFF file that is not a WebP")
    riff = int.from_bytes(data[4:8], "little")
    if riff < 12 or riff + 8 > len(data):
        raise ValueError(f"{name}: truncated WebP (RIFF size {riff}, file of {len(data)} bytes)")
    end = riff + 8
    canvas, frame, orientation, animated = None, None, 0, False
    for kind, body, at in _riff_chunks(data, 12, end, name):
        if kind == b"VP8X":
            if len(body) < 10:
                raise ValueError(f"{name}: WebP VP8X chunk of {len(body)} bytes")
            animated = bool(body[0] & 0x02)
            canvas = (int.from_bytes(body[7:10], "little") + 1, int.from_bytes(body[4:7], "little") + 1)
        elif kind in (b"VP8 ", b"VP8L") and frame is None and not animated:
            h, w = _webp_frame_size(kind, body, name)
            # libwebp's last VP8 token partition runs to the end of the
            # buffer it is given, past the chunk: where a cut partition
            # reads a byte it lacks is decided there
            frame = (kind, data[at:] if kind == b"VP8 " else body, 0, 0, h, w)
        elif kind == b"ANMF" and frame is None and animated:
            if len(body) < 16:
                raise ValueError(f"{name}: WebP ANMF chunk of {len(body)} bytes")
            x, y = 2 * int.from_bytes(body[0:3], "little"), 2 * int.from_bytes(body[3:6], "little")
            fw, fh = int.from_bytes(body[6:9], "little") + 1, int.from_bytes(body[9:12], "little") + 1
            sub = [(k, b) for k, b, _ in _riff_chunks(body, 16, len(body), name) if k in (b"VP8 ", b"VP8L")]
            if not sub:
                raise ValueError(f"{name}: WebP animation frame without a VP8 or VP8L bitstream")
            if _webp_frame_size(*sub[0], name) != (fh, fw):
                raise ValueError(f"{name}: WebP animation frame of another size than its bitstream")
            frame = (sub[0][0], sub[0][1], y, x, fh, fw)
        elif kind == b"EXIF" and not orientation:
            orientation = _tiff_orientation(body)
    if frame is None:
        raise ValueError(f"{name}: WebP without an image")
    fh, fw = frame[4:]
    if canvas is None:
        canvas = (fh, fw)
    if frame[2] + fh > canvas[0] or frame[3] + fw > canvas[1] or (not animated and (fh, fw) != canvas):
        raise ValueError(f"{name}: WebP frame of {fw} x {fh} at ({frame[3]}, {frame[2]}) outside its canvas of "
                         f"{canvas[1]} x {canvas[0]}")
    if canvas[0] * canvas[1] > 2 ** 30:
        raise ValueError(f"{name}: WebP of {canvas[1]} x {canvas[0]} pixels is past the limit of 2^30 pixels")
    return canvas, frame, orientation


def _webp(data: bytes, name: str, gray: bool) -> np.ndarray:
    """WebP bytes -> BGR (H, W, 3) or grey (H, W) uint8, as cv2 reads them:
    the still image (alpha dropped) or an animation's first frame on its
    canvas (transparent black elsewhere), the EXIF orientation applied,
    grey as cv2's BGR -> grey of the colour decode."""
    canvas, (kind, payload, y, x, fh, fw), orientation = _webp_parse(data, name)
    decode_frame = native.webp_vp8l_decode if kind == b"VP8L" else native.webp_vp8_decode
    try:
        img = decode_frame(payload, fh, fw)
    except ValueError as e:
        raise ValueError(f"{name}: WebP: {e}") from None
    if (fh, fw) != canvas:
        full = np.zeros(canvas + (3,), np.uint8)
        full[y:y + fh, x:x + fw] = img
        img = full
    img = orient(img, orientation)
    return native.bgr_to_gray(img, "cvtcolor") if gray else img


# ------------------------------------------------------------------ GIF

GIF_SIGNATURES = (b"GIF87a", b"GIF89a")


def _gif(data: bytes, name: str, gray: bool) -> np.ndarray:
    """A GIF's first frame as cv2's own GIF codec gives it: the canvas
    filled with the global table's background colour (black without a
    global table), the frame's opaque pixels drawn at their place (a file
    with no colour table at all through cv2's grey ramp, index 1 white);
    grey as cvtColor's of that. What cv2 refuses raises: a background index
    past the global table, a disposal method past 3, an index past the
    frame's colour table, a frame outside the canvas."""
    try:
        g, off = native.gif_header(data)
        f = next(native.gif_frames(data, off), None)
    except ValueError as e:
        raise ValueError(f"{name}: GIF: {e}") from None
    if not g.width or not g.height:
        raise ValueError(f"{name}: GIF of {g.width} x {g.height} pixels")
    if g.width * g.height > 2 ** 30:
        raise ValueError(f"{name}: GIF of {g.width} x {g.height} pixels is past the limit of 2^30 pixels")
    if f is None:
        raise ValueError(f"{name}: GIF without an image")
    h, w = f.indices.shape
    palette = f.palette if f.palette is not None else g.palette
    size = f.table_size if f.palette is not None else g.table_size
    if palette is None:  # cv2's table for a file without one: grey ramp, index 1 white
        palette, size = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1), 256
        palette[1] = 255
    if g.palette is not None and g.background >= g.table_size:
        raise ValueError(f"{name}: GIF background index {g.background} past its global table of {g.table_size}")
    if f.disposal > 3:
        raise ValueError(f"{name}: GIF disposal method {f.disposal} (cv2 reads 0-3)")
    if not w or not h or f.x + w > g.width or f.y + h > g.height:
        raise ValueError(f"{name}: GIF frame of {w} x {h} at ({f.x}, {f.y}) outside its canvas of {g.width} x {g.height}")
    if int(f.indices.max()) >= size:
        raise ValueError(f"{name}: GIF colour index past its table of {size}")
    canvas = np.empty((g.height, g.width, 3), np.uint8)
    canvas[:] = g.palette[g.background, ::-1] if g.palette is not None else 0
    bgr = np.ascontiguousarray(palette[:, ::-1])
    sub = canvas[f.y:f.y + h, f.x:f.x + w]
    if f.transparent < 0:
        sub[:] = bgr[f.indices]
    else:
        opaque = f.indices != f.transparent
        sub[opaque] = bgr[f.indices[opaque]]
    return native.bgr_to_gray(canvas, "cvtcolor") if gray else canvas


def cvt_gray(bgr: np.ndarray) -> np.ndarray:
    """Numpy twin of the C++ ``bgr_to_gray`` with cvtColor's weights:
    ``cv2.cvtColor(bgr, COLOR_BGR2GRAY)``, 15-bit fixed point, rounded."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + 16384) >> 15).astype(np.uint8)


def _to_bgr(img: np.ndarray) -> np.ndarray:
    c = img.shape[2]
    if c <= 2:
        return native.gray_to_bgr(img)
    return np.ascontiguousarray(img[..., 2::-1])


def png_gray(bgr: np.ndarray) -> np.ndarray:
    """Numpy twin of the C++ ``bgr_to_gray`` with libpng's weights: libpng's
    RGB -> grey as cv2 asks for it (0.299, 0.587 in 15-bit fixed point,
    truncated): (9797 R + 19234 G + 3737 B) >> 15."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((r * 9797 + g * 19234 + b * 3737) >> 15).astype(np.uint8)


def decode(data: bytes, name: str = "<bytes>", gray: bool = False) -> np.ndarray:
    """Image bytes -> BGR (H, W, 3) uint8, or with ``gray`` (H, W), as
    ``cv2.imdecode`` with IMREAD_COLOR / IMREAD_GRAYSCALE (a PFM keeps its
    channel count either way, as cv2's does)."""
    if data.startswith(PNG_SIGNATURE):
        png = _png(data, name)
        colour = png.ctype in (2, 3, 6)
        if gray and colour and png.gamma and (_significant(png.gamma) or _significant(_recip(png.gamma))):
            rgb = png.pix.view(">u2")[..., :3] if png.depth == 16 else _png_samples(
                png.pix, png.depth, png.ctype, png.palette, png.trns, name)[..., :3]
            return orient(png_gamma_gray(rgb, 16 if png.depth == 16 else 8, png.gamma, png.sbit), png.orientation)
        if gray and png.depth == 16 and colour:  # libpng converts before it strips to 8 bits
            return orient(native.png_rgb16_to_gray(png.pix), png.orientation)
        img = _png_samples(png.pix, png.depth, png.ctype, png.palette, png.trns, name)
        if not gray:
            return orient(_to_bgr(img), png.orientation)
        return orient(img[..., 0] if img.shape[2] <= 2 else native.bgr_to_gray(_to_bgr(img), "libpng"), png.orientation)
    if data.startswith(TIFF_SIGNATURES):
        return _tiff(data, name, gray)
    if data.startswith(b"RIFF"):
        return _webp(data, name, gray)
    if data.startswith(GIF_SIGNATURES):
        return _gif(data, name, gray)
    if raster_io.kind(data):
        return raster_io.decode(data, name, gray)
    codec = (native.jpeg_decode if data.startswith(JPEG_SIGNATURE)
             else native.bmp_decode if data.startswith(BMP_SIGNATURE) else None)
    if codec is None:
        raise ValueError(f"{name}: {_what(data)}; the port reads {READS}")
    try:
        return codec(data, gray)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def imdecode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Image bytes -> BGR (H, W, 3) uint8, as ``cv2.imdecode(..., IMREAD_COLOR)``."""
    return decode(data, name)


def imread(path: str | Path) -> np.ndarray:
    """BGR (H, W, 3) uint8, as ``cv2.imread``; FileNotFoundError if absent."""
    return decode(Path(path).read_bytes(), str(path))


def imread_gray(path: str | Path) -> np.ndarray:
    """(H, W) uint8, as ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``."""
    return decode(Path(path).read_bytes(), str(path), gray=True)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) grey, (H, W, 3) BGR or (H, W, 4) BGRA uint8 -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png: uint8 images only, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"encode_png: (H, W), (H, W, 3) or (H, W, 4) images only, got {img.shape}")
    h, w, c = img.shape
    if c >= 3:  # BGR(A) -> RGB(A)
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], -1)
    rows = np.ascontiguousarray(img).reshape(h, w * c)
    up = np.empty((h, w * c + 1), np.uint8)
    up[:, 0] = 2  # the Up filter: each row minus the one above, modulo 256
    up[:, 1:] = rows
    up[1:, 1:] -= rows[:-1]
    ctype = {1: 0, 3: 2, 4: 6}[c]
    return (PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(up.tobytes(), level)) + _chunk(b"IEND", b""))


def encode_jpeg(img: np.ndarray, quality: int = JPEG_QUALITY) -> bytes:
    """(H, W) grey, (H, W, 3) BGR or (H, W, 4) BGRA uint8 -> baseline JPEG
    bytes, those of ``cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY,
    quality])`` (alpha dropped, 4:2:0 for colour)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_jpeg: uint8 images only, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] in (1, 4):
        img = img[..., 0] if img.shape[2] == 1 else img[..., :3]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_jpeg: (H, W), (H, W, 3) or (H, W, 4) images only, got {img.shape}")
    return native.jpeg_encode(img, quality)


_ENCODERS = {".png": encode_png, ".jpg": encode_jpeg, ".jpeg": encode_jpeg}


def imwrite(path: str | Path, img: np.ndarray) -> None:
    """Write ``img`` as a PNG or a JPEG file, by the path's suffix."""
    path = Path(path)
    encoder = _ENCODERS.get(path.suffix.lower())
    if encoder is None:
        raise ValueError(f"{path}: the port writes .png, .jpg and .jpeg files only")
    path.write_bytes(encoder(img))


def _exif_orientation(app1: bytes) -> int:
    """Orientation (1-8) from a JPEG APP1/EXIF segment body, 0 if absent."""
    return _tiff_orientation(app1[6:]) if app1[:6] == b"Exif\x00\x00" else 0


def _tiff_orientation(tiff: bytes) -> int:
    """Orientation (1-8) from the TIFF structure of an EXIF block, 0 if absent."""
    if len(tiff) < 8:
        return 0
    bo = "little" if tiff[:2] == b"II" else "big" if tiff[:2] == b"MM" else None
    if bo is None:
        return 0
    ifd = int.from_bytes(tiff[4:8], bo)
    if len(tiff) < ifd + 2:
        return 0
    n = int.from_bytes(tiff[ifd: ifd + 2], bo)
    for i in range(n):
        e = ifd + 2 + 12 * i
        if len(tiff) < e + 12:
            return 0
        if int.from_bytes(tiff[e: e + 2], bo) == 0x0112:  # Orientation tag
            v = int.from_bytes(tiff[e + 8: e + 10], bo)
            return v if 1 <= v <= 8 else 0
    return 0


def _png_orientation(f) -> int:
    """The EXIF orientation of the PNG open in ``f``, 0 if none: its chunk
    headers are read and their bodies passed over, but for an eXIf chunk's."""
    f.seek(8)
    while True:
        head = f.read(8)
        if len(head) < 8 or head[4:] == b"IEND":
            return 0
        n = int.from_bytes(head[:4], "big")
        if head[4:] == b"eXIf":
            body = f.read(n)
            return _tiff_orientation(body)
        f.seek(n + 4, 1)


def image_size(path: str | Path) -> tuple[int, int]:
    """(h, w) as ``imread`` gives it, from the file's headers without
    decoding the pixels (PNG, JPEG, BMP, TIFF, WebP); a full decode for
    anything else. Where the EXIF orientation is 5-8 (a transpose: a JPEG's
    APP1, a PNG's eXIf chunk, a TIFF's Orientation tag, a WebP's EXIF
    chunk) the header's h and w swap. The JAX package's
    ``data.dataset.image_size``, for rect bucketing (its PNG branch misses
    the eXIf orientation)."""
    try:
        with open(path, "rb") as f:
            head = f.read(32)
            if head[:8] == PNG_SIGNATURE:  # IHDR: w, h big-endian at 16; an eXIf chunk anywhere
                h, w = int.from_bytes(head[20:24], "big"), int.from_bytes(head[16:20], "big")
                return (w, h) if _png_orientation(f) >= 5 else (h, w)
            if head[:4] in TIFF_SIGNATURES:  # the first IFD's tags
                f.seek(0)
                return _tiff_size(f.read(), str(path))
            if head[:4] == b"RIFF" and head[8:12] == b"WEBP":  # the canvas and the EXIF chunk
                f.seek(0)
                (h, w), _, orientation = _webp_parse(f.read(), str(path))
                return (w, h) if orientation >= 5 else (h, w)
            if head[:2] == BMP_SIGNATURE:  # BITMAPINFOHEADER at offset 18
                w, h = struct.unpack("<ii", head[18:26])
                return abs(h), abs(w)
            if head[:2] == b"\xff\xd8":  # JPEG: scan for the SOFn marker
                f.seek(2)
                orient = 1
                while True:
                    marker = f.read(2)
                    if len(marker) < 2 or marker[0] != 0xFF:
                        break
                    if 0xC0 <= marker[1] <= 0xCF and marker[1] not in (0xC4, 0xC8, 0xCC):
                        f.read(3)
                        h = int.from_bytes(f.read(2), "big")
                        w = int.from_bytes(f.read(2), "big")
                        return (w, h) if orient >= 5 else (h, w)
                    seg_len = int.from_bytes(f.read(2), "big")
                    if marker[1] == 0xE1 and seg_len >= 16:  # APP1/EXIF
                        orient = _exif_orientation(f.read(seg_len - 2)) or orient
                    else:
                        f.seek(seg_len - 2, 1)
    except OSError:
        pass
    return imread(path).shape[:2]
