"""PNG, TIFF, GIF, Sun raster and Radiance HDR writers for the still-format
tests and fixtures: the layouts cv2 and PIL do not write (sub-byte and
16-bit PNG of every colour type, Adam7 interlace, eXIf chunks; TIFF tiles,
planar configuration 2, both byte orders, MinIsWhite, palettes, 1- and
4-bit samples, the Orientation tag; GIF frames of any disposal,
transparency, place and colour table, LZW with a deferred clear; Sun
raster types, colour maps and byte encoding; HDR scanlines run-length or
flat), from numpy arrays. cv2, the JAX package's decoder, reads what they write and
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


# ------------------------------------------------------------------ GIF


def gif_lzw(indices: np.ndarray, min_size: int, *, clear_at_full: bool = True) -> bytes:
    """GIF's LZW of the indices (codes least significant bit first), the
    code width growing to 12 bits. With ``clear_at_full`` a clear code
    follows the table's 4096th entry, as most encoders write; without it
    the table stays full and the codes 12 bits wide (a deferred clear), as
    PIL never writes."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out, acc, nbits = bytearray(), 0, 0

    def put(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    table, width, nxt = {}, min_size + 1, clear + 2
    put(clear, width)
    data = bytes(np.asarray(indices, np.uint8).reshape(-1))
    prefix = b""
    for ch in data:
        s = prefix + bytes([ch])
        if len(s) == 1 or s in table:
            prefix = s
            continue
        put(table[prefix] if len(prefix) > 1 else prefix[0], width)
        if nxt < 4096:
            table[s] = nxt
            nxt += 1
            if nxt == (1 << width) + 1 and width < 12:  # the decoder widens a code after the encoder adds
                width += 1
        elif clear_at_full:
            put(clear, width)
            table, width, nxt = {}, min_size + 1, clear + 2
        prefix = bytes([ch])
    if prefix:
        put(table[prefix] if len(prefix) > 1 else prefix[0], width)
    put(eoi, width)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _gif_table(palette) -> tuple[int, bytes]:
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    bits = max(1, int(np.ceil(np.log2(max(len(pal), 2)))))
    full = np.zeros((1 << bits, 3), np.uint8)
    full[:len(pal)] = pal
    return bits - 1, full.tobytes()


def gif_bytes(size: tuple[int, int], frames, *, palette=None, background: int = 0, loop: bool = True) -> bytes:
    """A GIF of ``size`` (width, height). Each frame is a dict: ``indices``
    (h, w) uint8, and optionally ``x``, ``y``, ``palette`` (a local table),
    ``interlace``, ``disposal``, ``delay`` (1/100 s), ``transparent`` (an
    index), ``gce`` (False: no graphic control extension), ``min_size``
    (the LZW minimum code size), ``clear_at_full``."""
    w, h = size
    flags = 0
    table = b""
    if palette is not None:
        bits, table = _gif_table(palette)
        flags = 0x80 | 0x70 | bits
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h, flags, background, 0) + table)
    if loop and len(frames) > 1:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f in frames:
        idx = np.asarray(f["indices"], np.uint8)
        fh, fw = idx.shape
        if f.get("gce", True):
            t = f.get("transparent")
            packed = (f.get("disposal", 0) << 2) | (t is not None)
            out += b"\x21\xf9\x04" + struct.pack("<BHB", packed, f.get("delay", 10), t or 0) + b"\x00"
        dflags, local = 0, b""
        if f.get("palette") is not None:
            bits, local = _gif_table(f["palette"])
            dflags = 0x80 | bits
        rows = idx
        if f.get("interlace"):
            dflags |= 0x40
            rows = np.concatenate([idx[0::8], idx[4::8], idx[2::4], idx[1::2]])
        out += b"\x2c" + struct.pack("<HHHHB", f.get("x", 0), f.get("y", 0), fw, fh, dflags) + local
        min_size = f.get("min_size", max(2, int(idx.max(initial=0)).bit_length()))
        codes = gif_lzw(rows, min_size, clear_at_full=f.get("clear_at_full", True))
        out.append(min_size)
        for i in range(0, len(codes), 255):
            out += bytes([len(codes[i:i + 255])]) + codes[i:i + 255]
        out.append(0)
    return bytes(out + b"\x3b")


# ------------------------------------------- PNM, Sun raster, Radiance HDR


def sun_bytes(rows: np.ndarray, depth: int, *, kind: int = 1, colormap=None) -> bytes:
    """A Sun raster of (h, w) 1- or 8-bit samples, or (h, w, 3 / 4) bytes a
    pixel as they lie, each row padded to 16 bits (``kind`` 1 standard,
    0 old, 3 RGB); ``kind`` 2 (byte-encoded) run-length codes the rows,
    unpadded; ``colormap`` (3, n) uint8 is an RGB colour map."""
    rows = np.asarray(rows, np.uint8)
    h, w = rows.shape[:2]
    data = np.packbits(rows, axis=1) if depth == 1 else rows.reshape(h, -1)
    if kind == 2:
        body = sun_rle(data.tobytes())
    else:
        pad = (-data.shape[1]) % 2
        body = np.pad(data, ((0, 0), (0, pad))).tobytes()
    cmap = b"" if colormap is None else np.asarray(colormap, np.uint8).tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), kind, 1 if cmap else 0, len(cmap)) + cmap + body


def sun_rle(data: bytes) -> bytes:
    """Sun's byte encoding: 0x80 n v for n + 1 copies of v, 0x80 0 for a lone 0x80."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 256:
            j += 1
        if j - i >= 3:
            out += bytes([0x80, j - i - 1, data[i]])
        else:
            for _ in range(j - i):
                out += b"\x80\x00" if data[i] == 0x80 else bytes([data[i]])
        i = j
    return bytes(out)


def hdr_bytes(rgbe: np.ndarray, *, rle: bool = True, header: bytes = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n",
              resolution: bytes | None = None) -> bytes:
    """A Radiance HDR of (h, w, 4) RGBE bytes: new-style run-length
    scanlines (widths 8-32767) or flat ones."""
    rgbe = np.asarray(rgbe, np.uint8)
    h, w = rgbe.shape[:2]
    out = bytearray(header + (resolution or b"-Y %d +X %d\n" % (h, w)))
    for row in rgbe:
        if not rle or not 8 <= w <= 0x7FFF:
            out += row.tobytes()
            continue
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            d, i = row[:, c], 0
            while i < w:
                j = i
                while j < w and d[j] == d[i] and j - i < 127:
                    j += 1
                if j - i >= 3:
                    out += bytes([128 + j - i, d[i]])
                    i = j
                    continue
                k = i
                while k < w and k - i < 128 and not (k + 2 < w and d[k] == d[k + 1] == d[k + 2]):
                    k += 1
                out += bytes([k - i]) + d[i:k].tobytes()
                i = k
    return bytes(out)


# ------------------------------------------------------------ CCITT T.6

_WHITE_TERM = ("00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 110101 "
               "101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 "
               "0011000 00000010 00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110 00010111 "
               "00101000 00101001 00101010 00101011 00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
               "01010011 01010100 01010101 00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 "
               "00110010 00110011 00110100").split()
_BLACK_TERM = ("0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 00000111 "
               "000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 00000110111 "
               "00000101000 00000010111 00000011000 000011001010 000011001011 000011001100 000011001101 "
               "000001101000 000001101001 000001101010 000001101011 000011010010 000011010011 000011010100 "
               "000011010101 000011010110 000011010111 000001101100 000001101101 000011011010 000011011011 "
               "000001010100 000001010101 000001010110 000001010111 000001100100 000001100101 000001010010 "
               "000001010011 000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 "
               "000001011001 000000101011 000000101100 000001011010 000001100110 000001100111").split()
_WHITE_MAKEUP = ("11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 "
                 "011001101 011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 "
                 "011011010 011011011 010011000 010011001 010011010 011000 010011011").split()
_BLACK_MAKEUP = ("0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 "
                 "0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 "
                 "0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 0000001110111 "
                 "0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
                 "0000001100100 0000001100101").split()
_EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 "
               "000000010110 000000010111 000000011100 000000011101 000000011110 000000011111").split()
_VERTICAL = {0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010", -2: "000010", -3: "0000010"}


def _fax_run(n: int, black: bool) -> str:
    """ITU-T T.4's codes of one run: 2560 make-ups, a make-up, a terminating code."""
    term, makeup = (_BLACK_TERM, _BLACK_MAKEUP) if black else (_WHITE_TERM, _WHITE_MAKEUP)
    out = ""
    while n >= 2624:
        out += _EXT_MAKEUP[-1]
        n -= 2560
    if n >= 64:
        m = n // 64
        out += makeup[m - 1] if m <= 27 else _EXT_MAKEUP[m - 28]
        n -= 64 * m
    return out + term[n]


def ccitt_t6(bits: np.ndarray) -> bytes:
    """T.6 (Group 4) codes of (h, w) 0/1 pixels (1 black), with pass,
    vertical and horizontal modes chosen as T.4 says, and the EOFB."""
    h, w = bits.shape
    out, ref = [], [w, w]
    for row in np.asarray(bits, np.uint8):
        d = np.flatnonzero(np.diff(np.concatenate([[0], row]).astype(np.int8))).tolist()
        cur = d + [w, w]
        a0, colour = -1, 0
        while a0 < w:
            a1 = next(x for x in cur if x > a0 or (a0 < 0 and x >= 0))
            i = next(k for k, x in enumerate(ref) if (x > a0 or (a0 < 0 and x >= 0)) and k % 2 == colour)
            b1, b2 = ref[i], ref[i + 1] if i + 1 < len(ref) else w
            if b2 < a1:
                out.append("0001")
                a0 = b2
            elif abs(a1 - b1) <= 3:
                out.append(_VERTICAL[a1 - b1])
                a0, colour = a1, 1 - colour
            else:
                a2 = next((x for x in cur if x > a1), w)
                out.append("001" + _fax_run(a1 - max(a0, 0), bool(colour)) + _fax_run(a2 - a1, not colour))
                a0 = a2
        ref = d + [w, w, w]
    code = "".join(out) + "000000000001" * 2
    code += "0" * (-len(code) % 8)
    return int(code, 2).to_bytes(len(code) // 8, "big") if code else b""


def t6_tiff_bytes(bits: np.ndarray, *, photometric: int = 0) -> bytes:
    """A one-strip T.6 TIFF of (h, w) 0/1 pixels (1 black; MinIsWhite by default)."""
    h, w = bits.shape
    data = ccitt_t6(bits)
    tags = [(256, 4, w), (257, 4, h), (258, 3, 1), (259, 3, 4), (262, 3, photometric), (273, 4, 8), (277, 3, 1),
            (278, 4, h), (279, 4, len(data))]
    ifd = struct.pack("<H", len(tags)) + b"".join(struct.pack("<HHII", t, k, 1, v) if k == 4 else
                                                  struct.pack("<HHIHH", t, k, 1, v, 0) for t, k, v in tags)
    return b"II*\x00" + struct.pack("<I", 8 + len(data)) + data + ifd + b"\x00\x00\x00\x00"
