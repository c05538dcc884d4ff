"""Image decoding and encoding without OpenCV or PIL: PNG with the standard
library's ``zlib`` and numpy, JPEG and BMP in the host C++ library.

The card's host has no OpenCV and no PIL, so the port reads and writes its
images itself, and reads these files as ``cv2.imread`` reads them, to the
bit:

* PNG, bit depth 8, not interlaced, in any of the five colour types (grey,
  grey + alpha, RGB, RGBA, palette), with all five row filters;
* JPEG, Huffman-coded, 8-bit, grey or 3-component, baseline, extended or
  progressive, as libjpeg decodes it for cv2, the EXIF orientation applied
  (``native/jpeg.cpp``);
* BMP, uncompressed, 1, 4 or 8 bits with a palette, 24 or 32 bits
  (``native/bmp.cpp``).

16-bit and interlaced PNGs, CMYK, 12-bit, arithmetic-coded and lossless
JPEGs, compressed BMPs, and every other format (TIFF, WebP, GIF, ...)
raise ``ValueError`` naming the file and what it is, as do truncated or
corrupt files. Dispatch is on the file's signature, not its suffix.

``imread`` / ``imdecode`` return what ``cv2.imread(path)`` /
``cv2.imdecode(buf, IMREAD_COLOR)`` return: BGR (H, W, 3) uint8, grey
replicated, alpha dropped, a palette expanded. ``imread_gray`` returns what
``cv2.IMREAD_GRAYSCALE`` returns: a grey PNG as it is and libpng's grey
conversion of a colour one, a JPEG's luma plane, cv2's own conversion of a
colour BMP. ``imwrite`` writes by the path's suffix: ``.png`` with
``encode_png`` ((H, W) as grey, (H, W, 3) BGR as RGB, (H, W, 4) BGRA as
RGBA, every row with the Up filter), ``.jpg`` / ``.jpeg`` with
``encode_jpeg`` (the bytes ``cv2.imwrite`` writes, quality 95). PNG row
unfiltering runs in the host C++ library (``mga_yolo_tpu_torch.native``),
which raises when it cannot be built; :func:`unfilter_rows` is its numpy
twin, the tests' oracle.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from mga_yolo_tpu_torch import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
BMP_SIGNATURE = b"BM"
JPEG_QUALITY = 95  # cv2.imwrite's default
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_SIGNATURES = ((PNG_SIGNATURE, "PNG"), (JPEG_SIGNATURE, "JPEG"), (BMP_SIGNATURE, "BMP"), (b"GIF8", "GIF"),
               (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"RIFF", "RIFF/WebP"))


def _what(data: bytes) -> str:
    return next((name for sig, name in _SIGNATURES if data.startswith(sig)), "not an image the port reads")


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


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 in the file's sample order: grey (C=1),
    grey + alpha (2), RGB (3), RGBA (4); a palette expands to RGB, or RGBA
    when it has a tRNS chunk."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name}: {_what(data)}, not a PNG")
    pos, idat, palette, trns, ihdr = 8, [], None, None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if ihdr is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8:
        raise ValueError(f"{name}: PNG of bit depth {depth}; the port reads bit depth 8 only")
    if interlace:
        raise ValueError(f"{name}: interlaced PNG; the port reads non-interlaced PNG only")
    if ctype not in _CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype} is not valid")
    bpp = _CHANNELS[ctype]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG data ({e})") from None
    if raw.size < h * (w * bpp + 1):
        raise ValueError(f"{name}: PNG data holds {raw.size} bytes, want {h * (w * bpp + 1)}")
    raw = raw[:h * (w * bpp + 1)]
    rows = native.png_unfilter(raw, h, w * bpp, bpp)
    img = rows.reshape(h, w, bpp)
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


def _to_bgr(img: np.ndarray) -> np.ndarray:
    c = img.shape[2]
    if c <= 2:
        return np.repeat(img[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


def _bgr_to_gray(bgr: np.ndarray) -> np.ndarray:
    """libpng's RGB -> grey as cv2 asks for it (0.299, 0.587 in 15-bit fixed
    point, truncated): (9797 R + 19234 G + 3737 B) >> 15."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((r * 9797 + g * 19234 + b * 3737) >> 15).astype(np.uint8)


def decode(data: bytes, name: str = "<bytes>", gray: bool = False) -> np.ndarray:
    """PNG, JPEG or BMP bytes -> BGR (H, W, 3) uint8, or with ``gray`` (H, W),
    as ``cv2.imdecode`` with IMREAD_COLOR / IMREAD_GRAYSCALE."""
    if data.startswith(PNG_SIGNATURE):
        img = decode_png(data, name)
        if not gray:
            return _to_bgr(img)
        return np.ascontiguousarray(img[..., 0]) if img.shape[2] <= 2 else _bgr_to_gray(_to_bgr(img))
    codec = (native.jpeg_decode if data.startswith(JPEG_SIGNATURE)
             else native.bmp_decode if data.startswith(BMP_SIGNATURE) else None)
    if codec is None:
        raise ValueError(f"{name}: {_what(data)}; the port reads PNG, JPEG and BMP")
    try:
        return codec(data, gray)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def imdecode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG, JPEG or BMP bytes -> BGR (H, W, 3) uint8, as ``cv2.imdecode(..., IMREAD_COLOR)``."""
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
    if app1[:6] != b"Exif\x00\x00":
        return 0
    tiff = app1[6:]
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


def image_size(path: str | Path) -> tuple[int, int]:
    """(h, w) as ``imread`` gives it, from the file header without decoding
    the pixels (PNG, JPEG, BMP); a full decode for anything else. For a JPEG
    whose EXIF orientation is 5-8 (a transpose) the header's h and w swap.
    The JAX package's ``data.dataset.image_size``, for rect bucketing."""
    try:
        with open(path, "rb") as f:
            head = f.read(32)
            if head[:8] == PNG_SIGNATURE:  # IHDR: w, h big-endian at 16
                return int.from_bytes(head[20:24], "big"), int.from_bytes(head[16:20], "big")
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
