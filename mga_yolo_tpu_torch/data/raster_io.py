"""The still formats only ``cv2.imdecode`` / ``cv2.imread`` take in the JAX
package (uploads to its server, single files and globs named to its
predictor): PNM (``P1``-``P6``), PAM (``P7``), PFM (``PF`` / ``Pf``), Sun
raster and Radiance HDR, read as OpenCV 5's ``grfmt_pxm.cpp``,
``grfmt_pam.cpp``, ``grfmt_pfm.cpp``, ``grfmt_sunras.cpp`` and
``grfmt_hdr.cpp`` read them, to the bit, quirks included (measured against
cv2, fixture by fixture):

* PNM: ASCII samples scaled ``v * 255 // maxval`` (clamped to maxval),
  binary 8-bit samples as they are (no scaling), 16-bit samples (maxval
  over 255, big-endian) by their high byte, 1-bit samples black for 1;
  RGB turned to BGR, grey replicated; the grey read of a colour file with
  14-bit weights.
* PAM: GRAYSCALE (or no tuple type, depth 1) as PNM's binary samples;
  BLACKANDWHITE and any depth-1 file of maxval 1 as packed bits (1 white),
  each row taking ``width`` bytes of which the first ``(width + 7) // 8``
  hold its bits; RGB (or no tuple type, depth 3) copied in the file's order
  (cv2 does not swap it), its grey read with 14-bit weights taking the
  first sample as red. cv2's reads of the alpha tuple types and of RGB at
  maxval 1 fill pixels from memory it never wrote: the port refuses them.
* PFM: rows bottom-up, the scale's sign the byte order, samples divided by
  its magnitude and rounded half to even into 0-255 (NaN, infinities and
  values past 2^31 to 0), RGB turned to BGR; the file's channel count is
  kept whatever is asked for (``Pf`` gives (H, W) even as colour, ``PF``
  (H, W, 3) even as grey), as cv2 gives them.
* Sun raster: the old and standard types at 1, 8, 24 and 32 bits, with
  or without an RGB colour map, rows padded to 16 bits; 1-bit pixels 255
  for 1 without a map; 32-bit pixels drop their first byte. The grey read
  of a colour map or of 24 / 32 bits takes 14-bit weights; that of 1- or
  8-bit pixels without a map is all zeros, as cv2's (its grey palette is
  never filled). cv2 reads neither the byte-encoded (RLE) nor the RGB type
  (its header check compares the wrong field), so the port refuses both.
* Radiance HDR: ``#?RADIANCE`` / ``#?RGBE``, ``FORMAT=32-bit_rle_rgbe``
  last in the header, ``-Y h +X w`` only; new-style run-length or flat
  scanlines (``native/raster.cpp``); each RGBE pixel to floats
  ``m * 2^(e - 136)``, then ``255 v`` to uint8 as PFM's samples, as BGR;
  the grey read is cvtColor's of that.

Each raises ``ValueError`` naming the file and the feature for what cv2
refuses or what is cut or corrupt.
"""

from __future__ import annotations

import struct

import numpy as np

from mga_yolo_tpu_torch import native

SUN_MAGIC = b"\x59\xa6\x6a\x95"
HDR_SIGNATURES = (b"#?RGBE", b"#?RADIANCE")
_SPACE = b" \t\n\v\f\r"


def kind(data: bytes) -> str | None:
    """The upload-only format ``data`` starts like, or None."""
    if len(data) >= 3 and data[:1] == b"P" and data[2] in _SPACE:
        return {**dict.fromkeys(b"123456", "PNM"), ord("7"): "PAM", ord("f"): "PFM", ord("F"): "PFM"}.get(data[1])
    if data.startswith(SUN_MAGIC):
        return "Sun raster"
    if data.startswith(HDR_SIGNATURES):
        return "Radiance HDR"
    return None


def decode(data: bytes, name: str, gray: bool) -> np.ndarray:
    """``data`` of one of these formats as ``cv2.imdecode`` with
    IMREAD_COLOR (``gray`` False) or IMREAD_GRAYSCALE gives it."""
    what = kind(data)
    read = {"PNM": _pnm, "PAM": _pam, "PFM": lambda d, g: _pfm(d), "Sun raster": _sun, "Radiance HDR": _hdr}.get(what)
    if read is None:
        raise ValueError(f"{name}: not a PNM, PAM, PFM, Sun raster or Radiance HDR file")
    try:
        out = read(data, gray)
    except ValueError as e:
        raise ValueError(f"{name}: {what}: {e}") from None
    return out if out.flags.writeable else out.copy()  # samples read in place lie in the bytes


def _size_ok(w: int, h: int) -> None:
    if w <= 0 or h <= 0:
        raise ValueError(f"an image of {w} x {h} pixels")
    if w * h > 2 ** 30:
        raise ValueError(f"an image of {w} x {h} pixels is past the limit of 2^30 pixels")


def _rgb_gray(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's icvCvt_BGR2Gray with 14-bit weights, from samples in R, G, B order."""
    return native.bgr_to_gray(np.ascontiguousarray(rgb[..., ::-1]), "tiff")


def _colour(s: np.ndarray, gray: bool) -> np.ndarray:
    """(h, w) or (h, w, 3) RGB uint8 samples as cv2 gives them: BGR or grey."""
    if s.ndim == 2:
        return s if gray else native.gray_to_bgr(s)
    return _rgb_gray(s) if gray else np.ascontiguousarray(s[..., ::-1])


def saturate_u8(v: np.ndarray) -> np.ndarray:
    """OpenCV's float -> uint8 (``saturate_cast`` through ``cvRound``):
    rounded half to even, clipped to 0-255; NaN, infinities and values
    past 2^31, which cvRound's int32 cannot hold, give 0."""
    with np.errstate(invalid="ignore", over="ignore"):
        r = np.rint(v)
        ok = np.isfinite(r) & (np.abs(r) < 2 ** 31)
        return np.where(ok, np.clip(np.where(ok, r, 0), 0, 255), 0).astype(np.uint8)


def _need(data: bytes, pos: int, n: int) -> bytes:
    if len(data) - pos < n:
        raise ValueError(f"the data holds {len(data) - pos} bytes of samples, want {n}")
    return data[pos:pos + n]


# ------------------------------------------------------------------ PNM


def _pnm(data: bytes, gray: bool) -> np.ndarray:
    magic = data[1] - ord("0")
    bits = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[magic]
    binary = magic >= 4
    head, pos = native.pnm_numbers(data, 2, 2 if bits == 1 else 3)
    w, h = int(head[0]), int(head[1])
    maxval = 1 if bits == 1 else int(head[2])
    if not 0 < maxval < 65536:
        raise ValueError(f"maxval {maxval} (want 1-65535)")
    _size_ok(w, h)
    ch = 3 if bits == 24 else 1
    if bits == 1:
        if binary:
            stride = (w + 7) // 8
            rows = np.frombuffer(_need(data, pos, stride * h), np.uint8).reshape(h, stride)
            v = np.unpackbits(rows, axis=1)[:, :w]
        else:
            v = native.pnm_numbers(data, pos, w * h, maxdigits=1)[0].reshape(h, w) != 0
        return _colour(np.where(v, 0, 255).astype(np.uint8), gray)
    n = w * h * ch
    if binary:
        wide = maxval > 255
        raw = np.frombuffer(_need(data, pos, n * (2 if wide else 1)), ">u2" if wide else np.uint8)
        s = (raw >> 8).astype(np.uint8) if wide else raw
    else:
        v = np.minimum(native.pnm_numbers(data, pos, n)[0], maxval)
        s = (v >> 8 if maxval > 255 else v * 255 // maxval).astype(np.uint8)
    return _colour(s.reshape((h, w, ch) if ch == 3 else (h, w)), gray)


# ------------------------------------------------------------------ PAM

_PAM_TUPLES = ("BLACKANDWHITE", "GRAYSCALE", "RGB")
_PAM_REFUSED = ("GRAYSCALE_ALPHA", "RGB_ALPHA", "BLACKANDWHITE_ALPHA")


def _pam(data: bytes, gray: bool) -> np.ndarray:
    end = data.find(b"ENDHDR")
    if end < 0:
        raise ValueError("header without ENDHDR")
    fields: dict = {}
    for line in data[3:end].split(b"\n"):
        words = line.split()
        if words and not words[0].startswith(b"#"):
            fields[words[0].decode("latin-1")] = b" ".join(words[1:]).decode("latin-1")
    pos = data.find(b"\n", end) + 1
    if not pos:
        raise ValueError("header without a line end after ENDHDR")
    try:
        w, h, depth, maxval = (int(fields[k]) for k in ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL"))
    except (KeyError, ValueError):
        raise ValueError("header without WIDTH, HEIGHT, DEPTH and MAXVAL numbers") from None
    tuple_type = fields.get("TUPLTYPE")
    _size_ok(w, h)
    if not 0 < maxval < 65536:
        raise ValueError(f"maxval {maxval} (want 1-65535)")
    if tuple_type in _PAM_REFUSED or (tuple_type is not None and tuple_type not in _PAM_TUPLES):
        raise ValueError(f"tuple type {tuple_type}; cv2's read of it fills pixels from memory it never wrote "
                         f"(the port reads BLACKANDWHITE, GRAYSCALE and RGB)")
    want = {"BLACKANDWHITE": 1, "GRAYSCALE": 1, "RGB": 3}.get(tuple_type, depth)
    if depth != want or depth not in (1, 3) or (tuple_type is None and maxval > 255):
        raise ValueError(f"depth {depth} with tuple type {tuple_type} at maxval {maxval}, which cv2 does not read")
    if tuple_type == "BLACKANDWHITE" and maxval != 1:
        raise ValueError(f"BLACKANDWHITE at maxval {maxval}")
    if depth == 1 and maxval == 1:  # cv2 reads these as packed bits, a row in `w` bytes
        rows = np.frombuffer(_need(data, pos, w * h), np.uint8).reshape(h, w)[:, :(w + 7) // 8]
        return _colour((np.unpackbits(rows, axis=1)[:, :w] * 255).astype(np.uint8), gray)
    if maxval == 1:
        raise ValueError("RGB at maxval 1; cv2's read of it fills pixels from memory it never wrote")
    wide = maxval > 255
    raw = np.frombuffer(_need(data, pos, w * h * depth * (2 if wide else 1)), ">u2" if wide else np.uint8)
    s = ((raw >> 8) if wide else raw).astype(np.uint8).reshape((h, w, 3) if depth == 3 else (h, w))
    if depth == 1:
        return _colour(s, gray)
    return _rgb_gray(s) if gray else s.copy()  # cv2 copies the samples as they lie: no RGB -> BGR


# ------------------------------------------------------------------ PFM


def _pfm_token(data: bytes, pos: int) -> tuple[str, int]:
    end = pos
    while end < len(data) and data[end] not in _SPACE:
        end += 1
    if end >= len(data):
        raise ValueError("truncated header")
    return data[pos:end].decode("latin-1"), end + 1


def _pfm(data: bytes) -> np.ndarray:
    ch = 3 if data[1:2] == b"F" else 1
    if data[2:3] != b"\n":
        raise ValueError("header without a line break after its magic")
    w, pos = _pfm_token(data, 3)
    h, pos = _pfm_token(data, pos)
    scale, pos = _pfm_token(data, pos)
    try:
        w, h, scale = int(w), int(h), float(scale)
    except ValueError:
        raise ValueError("header without its width, height and scale") from None
    _size_ok(w, h)
    if scale == 0 or not np.isfinite(scale):
        raise ValueError(f"scale {scale}")
    v = np.frombuffer(_need(data, pos, 4 * w * h * ch), "<f4" if scale < 0 else ">f4")
    v = v.reshape((h, w, ch) if ch == 3 else (h, w))[::-1].astype(np.float32)
    out = saturate_u8(v * np.float32(1.0 / abs(scale)))
    return np.ascontiguousarray(out[..., ::-1]) if ch == 3 else out


# ------------------------------------------------------------------ Sun raster


def _sun(data: bytes, gray: bool) -> np.ndarray:
    if len(data) < 32:
        raise ValueError("truncated header")
    _, w, h, depth, _, kind_, maptype, maplength = struct.unpack(">8I", data[:32])
    if depth not in (1, 8, 24, 32):
        raise ValueError(f"depth {depth} (cv2 reads 1, 8, 24 and 32)")
    if kind_ in (2, 3):
        raise ValueError(f"{'byte-encoded (RLE)' if kind_ == 2 else 'RGB'} type, which cv2 does not read "
                         f"(the port reads the old and standard types)")
    if kind_ not in (0, 1):
        raise ValueError(f"type {kind_} (the port reads the old and standard types)")
    mapped = maptype == 1
    if not ((maptype == 0 and maplength == 0) or (mapped and depth <= 8 and 0 < maplength <= 3 << depth)):
        raise ValueError(f"colour map type {maptype} of {maplength} bytes at {depth} bits, which cv2 does not read")
    _size_ok(w, h)
    pos = 32 + maplength
    palette = np.zeros((256, 3), np.uint8)
    if mapped:
        m = np.frombuffer(_need(data, 32, maplength), np.uint8)
        n = maplength // 3
        palette[:n] = m[:3 * n].reshape(3, n).T  # R, G and B blocks
    stride = ((w * depth + 7) // 8 + 1) & ~1
    rows = np.frombuffer(_need(data, pos, stride * h), np.uint8).reshape(h, stride)
    if depth == 1:
        idx = np.unpackbits(rows, axis=1)[:, :w]
    elif depth == 8:
        idx = rows[:, :w]
    else:
        px = rows[:, :w * depth // 8].reshape(h, w, depth // 8)
        bgr = np.ascontiguousarray(px[..., -3:])  # a 32-bit pixel drops its first byte
        return native.bgr_to_gray(bgr, "tiff") if gray else bgr
    if mapped:
        rgb = palette[idx]
        return _rgb_gray(rgb) if gray else np.ascontiguousarray(rgb[..., ::-1])
    if gray:  # cv2's grey palette for an unmapped raster is left unfilled
        return np.zeros((h, w), np.uint8)
    return native.gray_to_bgr(np.ascontiguousarray((idx * 255).astype(np.uint8) if depth == 1 else idx))


# ------------------------------------------------------------------ Radiance HDR


def _hdr(data: bytes, gray: bool) -> np.ndarray:
    lines, pos = [], 0
    while len(lines) < 64:  # rgbe.cpp's header: fgets lines of at most 127 bytes
        nl = data.find(b"\n", pos, pos + 127)
        end = nl + 1 if nl >= 0 else pos + 127
        if pos >= len(data):
            raise ValueError("truncated header")
        lines.append(data[pos:end])
        pos = end
        if lines[-1] in (b"\n", b"") or lines[-1] == b"FORMAT=32-bit_rle_rgbe\n":
            break
    if lines[-1] != b"FORMAT=32-bit_rle_rgbe\n":
        raise ValueError("no FORMAT=32-bit_rle_rgbe line before the header's end (cv2 reads RGBE only)")
    blank = data[pos:pos + 1]
    if blank != b"\n":
        raise ValueError("FORMAT is not the header's last line")
    nl = data.find(b"\n", pos + 1, pos + 128)
    size = data[pos + 1:nl if nl >= 0 else pos + 128].split()
    if len(size) < 4 or size[0] != b"-Y" or size[2] != b"+X" or not size[1].isdigit() or not size[3].isdigit():
        raise ValueError(f"resolution {b' '.join(size[:4]).decode('latin-1')!r} (cv2 reads '-Y h +X w' only)")
    h, w = int(size[1]), int(size[3])
    _size_ok(w, h)
    rgbe = native.hdr_pixels(data, nl + 1, w, h)
    e = rgbe[..., 3].astype(np.int32)
    f = np.where(e > 0, np.ldexp(np.float32(1), e - 136), 0).astype(np.float32)
    with np.errstate(over="ignore"):
        bgr = saturate_u8(rgbe[..., 2::-1].astype(np.float32) * f[..., None] * np.float32(255))
    return native.bgr_to_gray(bgr, "cvtcolor") if gray else bgr
