"""PNG and TIFF writers for the still-format tests and fixtures: the layouts
cv2 and PIL do not write (sub-byte and 16-bit PNG of every colour type,
Adam7 interlace, eXIf chunks; TIFF tiles, planar configuration 2, both byte
orders, MinIsWhite, palettes, 1- and 4-bit samples, the Orientation tag),
from numpy arrays. cv2, the JAX package's decoder, reads what they write and
is the oracle; the port's decoders are what is tested.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def exif_block(orientation: int, big_endian: bool = False) -> bytes:
    """A TIFF structure holding one IFD with the Orientation tag."""
    e = ">" if big_endian else "<"
    return ((b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(e + "IH", 8, 1)
            + struct.pack(e + "HHIHH", 0x112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, n) samples -> (h, stride) bytes: 16-bit big-endian, 1/2/4-bit high bits first."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.pad(samples.astype(np.uint8), ((0, 0), (0, -n % per))).reshape(h, -1, per)
    out = np.zeros(s.shape[:2], np.uint8)
    for k in range(per):
        out |= s[..., k] << (8 - depth * (k + 1))
    return out


def _filter(rows: np.ndarray, bpp: int, types) -> bytes:
    """PNG rows, row y with filter types[y % len(types)] applied."""
    h, stride = rows.shape
    r = rows.astype(np.int32)
    out = np.empty((h, stride + 1), np.uint8)
    for y in range(h):
        ft = types[y % len(types)]
        cur = r[y]
        up = r[y - 1] if y else np.zeros(stride, np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])[:stride]
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])[:stride]
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) >> 1
        else:
            q = left + up - ul
            pa, pb, pc = np.abs(q - left), np.abs(q - up), np.abs(q - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out[y, 0] = ft
        out[y, 1:] = (cur - pred) & 255
    return out.tobytes()


def png_bytes(samples: np.ndarray, depth: int, ctype: int, *, interlace: bool = False, palette=None, trns=None,
              filters=(0, 1, 2, 3, 4), orientation: int = 0, exif_after_idat: bool = False,
              idat_parts: int = 1, level: int = 9) -> bytes:
    """A PNG of (h, w, c) samples (file order, RGB) at ``depth`` bits in colour
    type ``ctype``, rows filtered with each of ``filters`` in turn, optionally
    Adam7-interlaced, with PLTE / tRNS bodies and an eXIf chunk."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filter(pack_rows(sub.reshape(sub.shape[0], -1), depth), bpp, filters)
    else:
        raw = _filter(pack_rows(samples.reshape(h, -1), depth), bpp, filters)
    z = zlib.compress(raw, level)
    cut = np.linspace(0, len(z), idat_parts + 1).astype(int)
    idat = b"".join(_chunk(b"IDAT", z[a:b]) for a, b in zip(cut[:-1], cut[1:]))
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    exif = _chunk(b"eXIf", exif_block(orientation, exif_after_idat)) if orientation else b""
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", bytes(trns))
    if not exif_after_idat:
        out += exif
    out += idat
    if exif_after_idat:
        out += exif
    return out + _chunk(b"IEND", b"")


# ------------------------------------------------------------------ TIFF


def lzw(data: bytes) -> bytes:
    """TIFF's LZW (MSB first, the code width grows one code early); the
    table is keyed by (prefix code << 8) | byte."""
    out = bytearray()
    acc, nacc = 0, 0
    width, free, table = 9, 258, {}

    def put(code: int) -> None:
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    put(256)
    w = -1
    for ch in data:
        if w < 0:
            w = ch
            continue
        key = (w << 8) | ch
        code = table.get(key)
        if code is not None:
            w = code
            continue
        put(w)
        table[key] = free
        free += 1
        w = ch
        width = 9 if free <= 511 else 10 if free <= 1023 else 11 if free <= 2047 else 12
        if free >= 4093:
            put(256)
            width, free, table = 9, 258, {}
    if w >= 0:
        put(w)
        free += 1
        width = 9 if free <= 511 else 10 if free <= 1023 else 11 if free <= 2047 else 12
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits runs of up to 128 equal bytes and literals of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _predict(block: np.ndarray, spp: int, depth: int) -> np.ndarray:
    """Horizontal differencing (predictor 2) of (rows, n) samples."""
    d = block.astype(np.int64)
    d[:, spp:] -= block[:, :-spp].astype(np.int64)
    return d & ((1 << depth) - 1)


def tiff_bytes(samples: np.ndarray, depth: int, photometric: int, *, compression: int = 1, predictor: int = 1,
               big_endian: bool = False, rows_per_strip: int | None = None, tile: tuple[int, int] | None = None,
               planar: int = 1, orientation: int = 0, colormap=None, extra_samples=None) -> bytes:
    """A classic TIFF of (h, w, spp) samples at ``depth`` bits (1, 4, 8, 16)
    in strips of ``rows_per_strip`` rows (all rows if None) or tiles of
    ``tile`` = (width, height), chunky (planar 1) or one plane a sample
    (planar 2), compressed with 1 (none), 5 (LZW), 8 / 32946 (Deflate) or
    32773 (PackBits)."""
    h, w, spp = samples.shape
    e = ">" if big_endian else "<"
    compress = {1: bytes, 5: lzw, 8: zlib.compress, 32946: zlib.compress, 32773: packbits}[compression]
    planes = [samples] if planar == 1 else [samples[..., i:i + 1] for i in range(spp)]
    chunks = []
    for plane in planes:
        n = plane.shape[2]
        if tile is None:
            rps = rows_per_strip or h
            blocks = [plane[y:y + rps] for y in range(0, h, rps)]
        else:
            tw, th = tile
            padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw, n), plane.dtype)
            padded[:h, :w] = plane
            blocks = [padded[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
        for b in blocks:
            rows = b.reshape(b.shape[0], -1)
            if predictor == 2:
                rows = _predict(rows, n, depth)
            if depth == 16 and not big_endian:
                data = rows.astype("<u2").tobytes()
            else:
                data = pack_rows(rows, depth).tobytes()
            chunks.append(compress(data))
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [depth] * spp), 259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if orientation:
        tags[274] = (3, [orientation])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if colormap is not None:
        tags[320] = (3, list(np.asarray(colormap, np.uint16).T.reshape(-1)))
    if extra_samples is not None:
        tags[338] = (3, list(extra_samples))
    offsets_tag, counts_tag = (273, 279) if tile is None else (324, 325)
    if tile is None:
        tags[278] = (4, [rows_per_strip or h])
    else:
        tags[322], tags[323] = (4, [tile[0]]), (4, [tile[1]])
    tags[offsets_tag] = (4, [0] * len(chunks))
    tags[counts_tag] = (4, [len(c) for c in chunks])
    # layout: header, pixel data, then the IFD and the values that do not fit in an entry
    data_start = 8
    offsets, pos = [], data_start
    for c in chunks:
        offsets.append(pos)
        pos += len(c) + (len(c) & 1)
    tags[offsets_tag] = (4, offsets)
    ifd = pos
    entries, extra = b"", b""
    extra_pos = ifd + 2 + 12 * len(tags) + 4
    for tag in sorted(tags):
        typ, vals = tags[tag]
        fmt = e + ("H" if typ == 3 else "I") * len(vals)
        body = struct.pack(fmt, *map(int, vals))
        if len(body) <= 4:
            entries += struct.pack(e + "HHI", tag, typ, len(vals)) + body.ljust(4, b"\x00")
        else:
            entries += struct.pack(e + "HHII", tag, typ, len(vals), extra_pos + len(extra))
            extra += body + b"\x00" * (len(body) & 1)
    head = (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(e + "I", ifd)
    body = b"".join(c + b"\x00" * (len(c) & 1) for c in chunks)
    return head + body + struct.pack(e + "H", len(tags)) + entries + struct.pack(e + "I", 0) + extra


def _segments(jpeg: bytes):
    """(marker, whole segment) of a JPEG up to its SOS, then the rest (marker 0xDA)."""
    pos, out = 2, []
    while pos < len(jpeg):
        marker = jpeg[pos + 1]
        if marker == 0xDA:
            out.append((marker, jpeg[pos:]))
            break
        n = int.from_bytes(jpeg[pos + 2:pos + 4], "big")
        out.append((marker, jpeg[pos:pos + 2 + n]))
        pos += 2 + n
    return out


def jpeg_tiff_bytes(img: np.ndarray, *, quality: int = 90, rows_per_strip: int | None = None,
                    tile: tuple[int, int] | None = None, ycbcr: bool = True, shared_tables: bool = True,
                    orientation: int = 0) -> bytes:
    """A JPEG-in-TIFF (compression 7) of a BGR or grey uint8 image: each strip
    or tile a JPEG from cv2 (YCbCr 4:2:0 for colour, photometric 6), its
    quantisation and Huffman tables moved to the JPEGTables tag when
    ``shared_tables``."""
    import cv2

    h, w = img.shape[:2]
    grey = img.ndim == 2
    if tile is None:
        rps = rows_per_strip or h
        blocks = [img[y:y + rps] for y in range(0, h, rps)]
    else:
        tw, th = tile
        padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw) + img.shape[2:], np.uint8)
        padded[:h, :w] = img
        blocks = [padded[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
    chunks, tables = [], b""
    for b in blocks:
        segs = _segments(cv2.imencode(".jpg", np.ascontiguousarray(b), [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes())
        if shared_tables:
            tables = b"\xff\xd8" + b"".join(s for m, s in segs if m in (0xDB, 0xC4)) + b"\xff\xd9"
            segs = [(m, s) for m, s in segs if m not in (0xDB, 0xC4, 0xE0)]
        chunks.append(b"\xff\xd8" + b"".join(s for _, s in segs))
    spp = 1 if grey else 3
    e = "<"
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [7]), 262: (3, [1 if grey else 6 if ycbcr else 2]),
            277: (3, [spp]), 284: (3, [1])}
    if not grey and ycbcr:
        tags[530] = (3, [2, 2])
    if orientation:
        tags[274] = (3, [orientation])
    if tile is None:
        tags[278] = (4, [rows_per_strip or h])
        off_tag, cnt_tag = 273, 279
    else:
        tags[322], tags[323] = (4, [tile[0]]), (4, [tile[1]])
        off_tag, cnt_tag = 324, 325
    pos, offsets = 8, []
    for c in chunks:
        offsets.append(pos)
        pos += len(c) + (len(c) & 1)
    tags[off_tag], tags[cnt_tag] = (4, offsets), (4, [len(c) for c in chunks])
    if shared_tables:
        tags[347] = (7, list(tables))
    ifd = pos
    entries, extra = b"", b""
    extra_pos = ifd + 2 + 12 * len(tags) + 4
    for tag in sorted(tags):
        typ, vals = tags[tag]
        body = bytes(vals) if typ == 7 else struct.pack(e + ("H" if typ == 3 else "I") * len(vals), *vals)
        if len(body) <= 4:
            entries += struct.pack(e + "HHI", tag, typ, len(vals)) + body.ljust(4, b"\x00")
        else:
            entries += struct.pack(e + "HHII", tag, typ, len(vals), extra_pos + len(extra))
            extra += body + b"\x00" * (len(body) & 1)
    body = b"".join(c + b"\x00" * (len(c) & 1) for c in chunks)
    return b"II*\x00" + struct.pack("<I", ifd) + body + struct.pack("<H", len(tags)) + entries + b"\x00" * 4 + extra


# ------------------------------------------------------------------ WebP


def riff_chunks(data: bytes) -> dict:
    """{fourcc: payload} of a WebP's top-level chunks (the first of each)."""
    out, pos = {}, 12
    while pos + 8 <= len(data):
        kind, n = data[pos:pos + 4], int.from_bytes(data[pos + 4:pos + 8], "little")
        out.setdefault(kind, data[pos + 8:pos + 8 + n])
        pos += 8 + n + (n & 1)
    return out


def _riff_chunk(kind: bytes, body: bytes) -> bytes:
    return kind + struct.pack("<I", len(body)) + body + b"\x00" * (len(body) & 1)


def webp_bytes(canvas: tuple[int, int], frames, *, exif: bytes | None = None) -> bytes:
    """A VP8X WebP of canvas (w, h): one still bitstream, or an animation of
    ``frames`` = [(fourcc, payload, x, y, w, h)] (x, y even), with an EXIF chunk."""
    w, h = canvas
    animated = len(frames) > 1 or frames[0][2:4] != (0, 0) or frames[0][4:] != canvas
    flags = (0x02 if animated else 0) | (0x08 if exif else 0)
    out = _riff_chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little"))
    if animated:
        out += _riff_chunk(b"ANIM", b"\x00\x00\x00\x00" + b"\x00\x00")
        for kind, payload, x, y, fw, fh in frames:
            head = ((x // 2).to_bytes(3, "little") + (y // 2).to_bytes(3, "little") + (fw - 1).to_bytes(3, "little")
                    + (fh - 1).to_bytes(3, "little") + (100).to_bytes(3, "little") + b"\x00")
            out += _riff_chunk(b"ANMF", head + _riff_chunk(kind, payload))
    else:
        out += _riff_chunk(frames[0][0], frames[0][1])
    if exif:
        out += _riff_chunk(b"EXIF", exif)
    return b"RIFF" + struct.pack("<I", 4 + len(out)) + b"WEBP" + out


# ------------------------------------------- libwebp's encoder, every setting


def _libwebp():
    """PIL's libwebp (and the libsharpyuv it needs), loaded with ctypes."""
    import ctypes

    import PIL

    libs = Path(PIL.__file__).resolve().parents[1] / "pillow.libs"
    ctypes.CDLL(str(next(libs.glob("libsharpyuv-*"))), mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(str(next(libs.glob("libwebp-*"))))


def libwebp_encode(rgb: np.ndarray, **settings) -> bytes:
    """A lossy WebP of (h, w, 3) RGB uint8 from libwebp's advanced API, with
    any ``WebPConfig`` field set (``filter_type`` 0 for the simple loop
    filter, ``partitions`` 0-3, ``segments``, ``filter_sharpness`` ...):
    the encodings cv2 and PIL never ask for."""
    import ctypes

    c_int, c_float, c_void_p, c_uint32 = ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_uint32
    config_fields = ["lossless", "quality", "method", "image_hint", "target_size", "target_PSNR", "segments",
                     "sns_strength", "filter_strength", "filter_sharpness", "filter_type", "autofilter",
                     "alpha_compression", "alpha_filtering", "alpha_quality", "pass", "show_compressed",
                     "preprocessing", "partitions", "partition_limit", "emulate_jpeg_size", "thread_level",
                     "low_memory", "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv", "qmin", "qmax"]

    class Config(ctypes.Structure):
        _fields_ = [(f, c_float if f in ("quality", "target_PSNR") else c_int) for f in config_fields]

    class Picture(ctypes.Structure):
        _fields_ = [("use_argb", c_int), ("colorspace", c_int), ("width", c_int), ("height", c_int),
                    ("y", c_void_p), ("u", c_void_p), ("v", c_void_p), ("y_stride", c_int), ("uv_stride", c_int),
                    ("a", c_void_p), ("a_stride", c_int), ("pad1", c_uint32 * 2), ("argb", c_void_p),
                    ("argb_stride", c_int), ("pad2", c_uint32 * 3), ("writer", c_void_p), ("custom_ptr", c_void_p),
                    ("extra_info_type", c_int), ("extra_info", c_void_p), ("stats", c_void_p), ("error_code", c_int),
                    ("progress_hook", c_void_p), ("user_data", c_void_p), ("pad3", c_uint32 * 3),
                    ("pad4", c_void_p), ("pad5", c_void_p), ("pad6", c_uint32 * 8), ("memory_", c_void_p),
                    ("memory_argb_", c_void_p), ("pad7", c_void_p * 2)]

    class MemoryWriter(ctypes.Structure):
        _fields_ = [("mem", c_void_p), ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                    ("pad", c_uint32 * 1)]

    abi = 0x020F
    lib = _libwebp()
    config, pic, wrt = Config(), Picture(), MemoryWriter()
    assert lib.WebPConfigInitInternal(ctypes.byref(config), 0, c_float(75.0), abi)
    for key, value in settings.items():
        setattr(config, key, value)
    assert lib.WebPValidateConfig(ctypes.byref(config)), settings
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), abi)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    pic.width, pic.height = rgb.shape[1], rgb.shape[0]
    assert lib.WebPPictureImportRGB(ctypes.byref(pic), rgb.ctypes.data_as(c_void_p), rgb.shape[1] * 3)
    lib.WebPMemoryWriterInit(ctypes.byref(wrt))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, c_void_p)
    pic.custom_ptr = ctypes.cast(ctypes.pointer(wrt), c_void_p)
    try:
        assert lib.WebPEncode(ctypes.byref(config), ctypes.byref(pic)), pic.error_code
        return ctypes.string_at(wrt.mem, wrt.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(wrt))
