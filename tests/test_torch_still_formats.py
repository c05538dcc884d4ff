"""The port's still-format decoders (PNG at every bit depth and Adam7, TIFF,
WebP; ``data/image_io.py`` on ``native/maskops.cpp``, ``native/tiff.cpp``,
``native/webp.cpp``) against the JAX package's decoder, cv2, on the CPU.

Tolerances: none. Every file reads through ``imread`` / ``imdecode`` /
``imread_gray`` equal to ``cv2.imread`` / ``cv2.imdecode`` /
``IMREAD_GRAYSCALE`` to the bit, EXIF orientations applied, and
``image_io.image_size`` equals ``cv2.imread(...).shape`` (the JAX
package's ``image_size`` where its header read is right). Files are made
here from numpy seeds at odd sizes, with cv2 and PIL where they write the
layout and with ``tests/still_fixtures/writers.py`` where they do not.
What the port refuses raises ValueError naming the file and the feature;
no cut or corrupt file crashes the process. The C++ helpers are held to
their numpy twins.
"""

from __future__ import annotations

import hashlib
import io
import itertools
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from tests._torch_port import few_torch_threads  # noqa: F401
from tests.still_fixtures import writers as W

FIXTURES = Path(__file__).resolve().parent / "still_fixtures"


def _smooth(h, w, c, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, c)).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 1.5).reshape(h, w, c)


def _assert_reads_as_cv2(tmp_path, data: bytes, name: str = "x.img"):
    """imread, imread_gray, imdecode and image_size of ``data`` equal cv2's."""
    from mga_yolo_tpu_torch.data import image_io

    path = tmp_path / name
    path.write_bytes(data)
    want, want_g = cv2.imread(str(path)), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if want is None and data.startswith(image_io.TIFF_SIGNATURES):  # cv2.imread's fault on TIFF orientations 5-8
        buf = np.frombuffer(data, np.uint8)
        want, want_g = cv2.imdecode(buf, cv2.IMREAD_COLOR), cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
    assert want is not None and want_g is not None
    np.testing.assert_array_equal(image_io.imread(path), want)
    np.testing.assert_array_equal(image_io.imread_gray(path), want_g)
    np.testing.assert_array_equal(image_io.imdecode(data), want)
    assert image_io.image_size(path) == want.shape[:2]
    return want


# ------------------------------------------------------------------ PNG

PNG_CASES = [(c, d) for c, ds in {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}.items()
             for d in ds]


def _png_samples(ctype: int, depth: int, h: int, w: int, seed: int):
    rng = np.random.default_rng(seed)
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    if ctype == 3:
        return rng.integers(0, 1 << depth, (h, w, 1)), rng.integers(0, 256, (1 << depth, 3))
    img = _smooth(h, w, c, seed).astype(np.int64)
    if depth == 16:
        img = img * 257 + rng.integers(0, 257, img.shape)
    elif depth < 8:
        img >>= 8 - depth
    return img, None


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", PNG_CASES, ids=[f"ctype{c}_{d}bit" for c, d in PNG_CASES])
def test_png_depth_colour_type_and_interlace_equal_cv2(tmp_path, ctype, depth, interlace):
    """Each colour type at each of its bit depths, plain and Adam7, at odd
    sizes that leave passes empty (1 x 1, 3 x 2) and ragged (13 x 21, 37 x
    53), with and without tRNS, every row filter: colour and grey equal cv2."""
    for i, (h, w) in enumerate(((1, 1), (3, 2), (13, 21), (37, 53))):
        samples, palette = _png_samples(ctype, depth, h, w, 10 * i + depth)
        trns = None
        if i % 2 and ctype == 3:
            trns = bytes(np.random.default_rng(i).integers(0, 256, max(1, len(palette) // 2)).astype(np.uint8))
        elif i % 2 and ctype in (0, 2):
            trns = b"".join(struct.pack(">H", int(v)) for v in samples[0, 0])
        data = W.png_bytes(samples, depth, ctype, interlace=interlace, palette=palette, trns=trns,
                           idat_parts=1 + i % 3)
        _assert_reads_as_cv2(tmp_path, data, f"p{i}.png")


def test_png_from_cv2_and_pil_equal_cv2(tmp_path):
    """16-bit grey and BGR(A) PNGs cv2 writes, and PIL's 1-bit, palette
    (with transparency) and grey + alpha files."""
    from PIL import Image

    img = _smooth(29, 43, 4, 5).astype(np.uint16) * 257 + 3
    files = {"c16g.png": cv2.imencode(".png", img[..., 0])[1].tobytes(),
             "c16bgr.png": cv2.imencode(".png", img[..., :3])[1].tobytes(),
             "c16bgra.png": cv2.imencode(".png", img)[1].tobytes()}
    for mode, arr in (("1", _smooth(29, 43, 1, 6)[..., 0] > 128), ("LA", _smooth(29, 43, 2, 7)),
                      ("P", _smooth(29, 43, 1, 8)[..., 0] // 16)):
        buf = io.BytesIO()
        im = Image.fromarray(arr if mode != "LA" else arr, None if mode == "P" else mode)
        if mode == "P":
            im = im.convert("P")
            im.putpalette(list(np.random.default_rng(1).integers(0, 256, 48)))
            im.info["transparency"] = 3
        im.save(buf, "PNG", **({"transparency": 3} if mode == "P" else {}))
        files[f"pil_{mode}.png"] = buf.getvalue()
    for name, data in files.items():
        _assert_reads_as_cv2(tmp_path, data, name)


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("fmt", ["png", "png_after_idat", "png_grey16", "tiff", "tiff_tiles", "webp_lossless",
                                 "webp_lossy", "jpeg_in_tiff"])
def test_exif_orientation_equals_cv2(tmp_path, fmt, orientation):
    """An EXIF orientation 1-8 (a PNG's eXIf chunk before or after IDAT, a
    TIFF's Orientation tag, a WebP's EXIF chunk) reads through imread,
    imread_gray, imdecode and image_size as cv2 gives it. Before this
    change the port's PNG ignored the eXIf chunk: orientations 5-8 read 20 x
    30 where cv2 reads 30 x 20. ``cv2.imread`` of a TIFF at orientations
    5-8 fails ("Internal imread issue") where ``cv2.imdecode`` of its bytes
    gives the turned image: the port reads both as ``cv2.imdecode``."""
    from mga_yolo_tpu.data.dataset import image_size as jax_image_size

    img = _smooth(20, 30, 3, orientation)
    if fmt.startswith("png"):
        samples, depth, ctype = (img, 8, 2) if fmt != "png_grey16" else (img[..., :1].astype(np.int64) * 257, 16, 0)
        data = W.png_bytes(samples, depth, ctype, orientation=orientation, exif_after_idat=fmt == "png_after_idat")
    elif fmt.startswith("tiff"):
        data = W.tiff_bytes(img, 8, 2, compression=5, orientation=orientation,
                            **({"tile": (16, 16)} if fmt == "tiff_tiles" else {"rows_per_strip": 7}))
    elif fmt == "jpeg_in_tiff":
        data = W.jpeg_tiff_bytes(img[..., ::-1].copy(), rows_per_strip=16, orientation=orientation)
    else:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "WEBP", lossless=fmt == "webp_lossless", quality=80)
        kind = b"VP8L" if fmt == "webp_lossless" else b"VP8 "
        data = W.webp_bytes((30, 20), [(kind, W.riff_chunks(buf.getvalue())[kind], 0, 0, 30, 20)],
                            exif=W.exif_block(orientation, big_endian=orientation % 2 == 0))
    want = _assert_reads_as_cv2(tmp_path, data, "o.img")
    assert want.shape[:2] == ((30, 20) if orientation >= 5 else (20, 30))
    if fmt.startswith("png"):  # the JAX package reads PNG IHDR without the orientation (ROADMAP section 3)
        assert jax_image_size(tmp_path / "o.img") == (20, 30)
    elif "tiff" in fmt and orientation >= 5:  # cv2.imread fails where cv2.imdecode turns the image (ROADMAP 3)
        assert cv2.imread(str(tmp_path / "o.img")) is None
        with pytest.raises(FileNotFoundError):
            jax_image_size(tmp_path / "o.img")
    else:
        assert jax_image_size(tmp_path / "o.img") == want.shape[:2]  # cv2's full decode


def test_png_exif_edge_cases_equal_cv2(tmp_path):
    """cv2 takes the first eXIf chunk and ignores one with an "Exif\\0\\0"
    prefix, a cut one and an orientation outside 1-8."""
    img = _smooth(20, 30, 3, 1)
    base = W.png_bytes(img, 8, 2)
    at = base.index(b"IDAT") - 4
    bodies = ([W.exif_block(6)], [b"Exif\x00\x00" + W.exif_block(6)], [W.exif_block(9)], [W.exif_block(6)[:12]],
              [W.exif_block(6), W.exif_block(3)])
    for chunks in bodies:
        data = base[:at] + b"".join(W._chunk(b"eXIf", body) for body in chunks) + base[at:]
        _assert_reads_as_cv2(tmp_path, data, "e.png")


GAMMA_CHUNKS = {"gAMA_0.45455": [("gAMA", 45455)], "sRGB": [("sRGB", 0)], "gAMA_0.22": [("gAMA", 22000)],
                "gAMA_1.04_insignificant": [("gAMA", 104000)], "gAMA_then_sRGB": [("gAMA", 80000), ("sRGB", 0)],
                "sBIT10": [("gAMA", 45455), ("sBIT", 10)], "gAMA_0_invalid": [("gAMA", 0)]}
GAMMA_TYPES = [(2, 8), (6, 8), (3, 8), (3, 4), (2, 16), (6, 16), (0, 8), (0, 16), (4, 16)]


@pytest.mark.parametrize("chunks", GAMMA_CHUNKS)
@pytest.mark.parametrize("ctype,depth", GAMMA_TYPES, ids=[f"ctype{c}_{d}bit" for c, d in GAMMA_TYPES])
def test_png_gamma_in_the_grey_read_equals_cv2(tmp_path, ctype, depth, chunks):
    """A ``gAMA`` or ``sRGB`` chunk (with an ``sBIT``) before PLTE and IDAT:
    cv2's grey read of an RGB or palette PNG then has libpng's gamma in its
    rgb_to_gray (8-bit tables; at 16 bits its 16-bit tables and the 16-to-8
    table for grey pixels); the same chunks after IDAT, or after PLTE, are
    out of place and change nothing; colour reads and grey files are as
    without them. Plain and Adam7, colour and grey equal cv2."""
    rng = np.random.default_rng(depth * 10 + ctype)
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    palette = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
    samples = rng.integers(0, 1 << depth, (13, 19, c))
    if ctype != 3:
        samples[0, :4, :min(c, 3)] = samples[0, :4, :1]  # grey pixels pass through their own table
    body = b""
    for kind, v in GAMMA_CHUNKS[chunks]:
        body += W._chunk(kind.encode(), struct.pack(">I", v) if kind == "gAMA" else b"\x00" if kind == "sRGB"
                         else bytes([v] * {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}[ctype]))
    for i, interlace in enumerate((False, True)):
        data = W.png_bytes(samples, depth, ctype, palette=palette, interlace=interlace)
        first = data.index(b"PLTE" if palette is not None else b"IDAT") - 4
        for j, at in enumerate((first, data.index(b"IEND") - 4)):
            _assert_reads_as_cv2(tmp_path, data[:at] + body + data[at:], f"g{i}{j}.png")


# ------------------------------------------------------------------ TIFF

TIFF_KINDS = {  # name: (photometric, bits, samples a pixel, extra samples, colour map entries)
    "grey8": (1, 8, 1, None), "grey8_miniswhite": (0, 8, 1, None), "grey16": (1, 16, 1, None),
    "grey16_miniswhite": (0, 16, 1, None), "grey1": (1, 1, 1, None), "grey1_miniswhite": (0, 1, 1, None),
    "grey_alpha8": (1, 8, 2, [2]), "grey_alpha16": (1, 16, 2, [2]), "rgb8": (2, 8, 3, None), "rgb16": (2, 16, 3, None),
    "rgba8_unassociated": (2, 8, 4, [2]), "rgba8_associated": (2, 8, 4, [1]), "rgba8_unspecified": (2, 8, 4, [0]),
    "rgba8_no_extrasamples": (2, 8, 4, None), "rgba16_unassociated": (2, 16, 4, [2]), "palette8": (3, 8, 1, None),
    "palette4": (3, 4, 1, None), "palette1": (3, 1, 1, None),
}
TIFF_LAYOUTS = {"strip": {}, "strips5": {"rows_per_strip": 5}, "tiles": {"tile": (16, 32)}}


@pytest.mark.parametrize("layout", TIFF_LAYOUTS)
@pytest.mark.parametrize("kind", TIFF_KINDS)
def test_tiff_compression_photometric_bits_layout_planar_equal_cv2(tmp_path, kind, layout):
    """Each photometric / bit depth / extra-sample kind in one strip, strips
    of 5 rows and 16 x 32 tiles (the right column clipped; cv2.imread reads
    uncompressed tiles, cv2.imdecode fails on them), with none, LZW,
    Deflate (8 and 32946) and PackBits, the horizontal predictor at 8 and
    16 bits, both byte orders, chunky and planar, 16-bit or 8-bit colour
    maps: colour and grey equal cv2 through libtiff's RGBA interface."""
    photometric, bits, spp, extra = TIFF_KINDS[kind]
    rng = np.random.default_rng(len(kind))
    h, w = 23, 37
    samples = rng.integers(0, 1 << bits, (h, w, spp))
    if bits >= 8 and photometric != 3:
        samples = _smooth(h, w, spp, 3).astype(np.int64) * (257 if bits == 16 else 1)
    n = 0
    for comp, pred, big, planar in itertools.product((1, 5, 8, 32946, 32773), (1, 2), (False, True), (1, 2)):
        if (pred == 2 and (comp not in (5, 8, 32946) or bits < 8)) or (planar == 2 and spp == 1):
            continue
        cmap = None
        if photometric == 3:
            cmap = rng.integers(0, 65536 if big else 256, (1 << bits, 3))
        data = W.tiff_bytes(samples, bits, photometric, compression=comp, predictor=pred, big_endian=big,
                            planar=planar, colormap=cmap, extra_samples=extra, **TIFF_LAYOUTS[layout])
        _assert_reads_as_cv2(tmp_path, data, f"t{n}.tif")
        n += 1
    assert n >= 8


@pytest.mark.parametrize("case", ["strip", "strips16", "tiles", "no_shared_tables", "grey", "grey_tiles",
                                  "pil_rgb", "pil_ycbcr"])
def test_jpeg_in_tiff_equals_cv2(tmp_path, case):
    """New-style JPEG (compression 7): YCbCr 4:2:0 strips and tiles with the
    tables in JPEGTables or in each strip, grey, and PIL's RGB and YCbCr
    files: colour and grey equal cv2."""
    from PIL import Image

    img = _smooth(45, 61, 3, 9)
    if case.startswith("pil"):
        buf = io.BytesIO()
        im = Image.fromarray(img[..., ::-1])
        (im.convert("YCbCr") if case == "pil_ycbcr" else im).save(buf, "TIFF", compression="jpeg", quality=75)
        data = buf.getvalue()
    else:
        kw = {"strip": {}, "strips16": {"rows_per_strip": 16}, "tiles": {"tile": (32, 16)},
              "no_shared_tables": {"rows_per_strip": 16, "shared_tables": False}, "grey": {"rows_per_strip": 8},
              "grey_tiles": {"tile": (16, 16)}}[case]
        data = W.jpeg_tiff_bytes(img[..., 0].copy() if case.startswith("grey") else img, **kw)
    _assert_reads_as_cv2(tmp_path, data, "j.tif")


def test_tiff_from_cv2_and_pil_equal_cv2(tmp_path):
    """TIFFs cv2 writes (its default LZW, each compression it offers that
    the port reads, 16-bit, grey, with the predictor, rows per strip) and
    PIL's 1-bit, palette, grey + alpha, RGBA, 16-bit grey in both byte
    orders and two-page files."""
    from PIL import Image

    img = _smooth(31, 47, 3, 11)
    C, P, R = cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_PREDICTOR, cv2.IMWRITE_TIFF_ROWSPERSTRIP
    files = {"default.tif": cv2.imencode(".tif", img)[1].tobytes(),
             "grey16.tif": cv2.imencode(".tif", img[..., 0].astype(np.uint16) * 300)[1].tobytes(),
             "bgr16_pred.tif": cv2.imencode(".tif", img.astype(np.uint16) * 257, [C, 5, P, 2])[1].tobytes(),
             "bgra.tif": cv2.imencode(".tif", np.concatenate([img, img[..., :1]], -1))[1].tobytes()}
    for comp in (1, 5, 8, 32946, 32773):
        files[f"c{comp}.tif"] = cv2.imencode(".tif", img, [C, comp, R, 7])[1].tobytes()
    for mode, arr in (("1", img[..., 0] > 128), ("P", None), ("LA", img[..., :2]), ("RGBA", np.concatenate(
            [img, img[..., :1]], -1)), ("L", img[..., 0])):
        buf = io.BytesIO()
        im = Image.fromarray(img[..., ::-1]).quantize(37) if mode == "P" else Image.fromarray(arr, mode)
        im.save(buf, "TIFF", compression="tiff_lzw" if mode != "1" else "packbits")
        files[f"pil_{mode}.tif"] = buf.getvalue()
    for mode in ("I;16", "I;16B"):  # 16-bit grey in either byte order
        buf = io.BytesIO()
        g16 = img[..., 0].astype(np.uint16) * 257 + 7
        Image.frombytes(mode, (47, 31), g16.astype("<u2" if mode == "I;16" else ">u2").tobytes()).save(
            buf, "TIFF", compression="tiff_deflate")
        files[f"pil_{mode}.tif"] = buf.getvalue()
    buf = io.BytesIO()  # two pages: cv2 reads the first
    Image.fromarray(img).save(buf, "TIFF", save_all=True, append_images=[Image.fromarray(img[::-1].copy())],
                              compression="tiff_adobe_deflate")
    files["pil_two_pages.tif"] = buf.getvalue()
    for name, data in files.items():
        _assert_reads_as_cv2(tmp_path, data, name)


def _tiff_with_tag(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian classic TIFF with one SHORT/LONG tag's value set."""
    off = struct.unpack("<I", data[4:8])[0]
    b = bytearray(data)
    for i in range(struct.unpack("<H", data[off:off + 2])[0]):
        e = off + 2 + 12 * i
        if struct.unpack("<H", data[e:e + 2])[0] == tag:
            typ = struct.unpack("<H", data[e + 2:e + 4])[0]
            b[e + 8:e + 12] = struct.pack("<HH", value, 0) if typ == 3 else struct.pack("<I", value)
            return bytes(b)
    raise KeyError(tag)


def _refused_tiffs():
    img = _smooth(21, 33, 3, 12)
    grey = img[..., 0]
    base = W.tiff_bytes(img, 8, 2, compression=5)
    return {
        # raw 1-bit rows labelled CCITT: read as T.6 codes they happen to decode (as in cv2); as T.4 they
        # are no valid code, which the port raises on and libtiff conceals
        "ccitt_g4": (_tiff_with_tag(W.tiff_bytes((grey[..., None] > 128).astype(np.uint8), 1, 0), 259, 4), None),
        "ccitt_g3": (_tiff_with_tag(W.tiff_bytes((grey[..., None] > 128).astype(np.uint8), 1, 0), 259, 3),
                     "corrupt CCITT data"),
        "lzma": (_tiff_with_tag(base, 259, 34925), "LZMA \\(compression 34925\\)"),
        "zstd": (_tiff_with_tag(base, 259, 50000), "ZSTD \\(compression 50000\\)"),
        "webp_in_tiff": (_tiff_with_tag(base, 259, 50001), "WebP \\(compression 50001\\)"),
        "old_jpeg": (_tiff_with_tag(base, 259, 6), "old-style JPEG \\(compression 6\\)"),
        "float32": (cv2.imencode(".tif", img.astype(np.float32))[1].tobytes(), "floating-point samples"),
        "int32": (_tiff_with_tag(W.tiff_bytes(img[..., :1].astype(np.int64) * 99999, 16, 1), 258, 32),
                  "32-bit samples"),
        "bigtiff": (b"II+\x00\x08\x00\x00\x00" + bytes(40), "BigTIFF"),
        "raw_ycbcr": (_tiff_with_tag(base, 262, 6), "raw YCbCr"),
        "cmyk": (_tiff_with_tag(W.tiff_bytes(np.concatenate([img, img[..., :1]], -1), 8, 5), 262, 5),
                 "photometric interpretation 5"),
        "grey4": (W.tiff_bytes(grey[..., None] >> 4, 4, 1), "4-bit TIFF of photometric interpretation 1"),
        "grey2": (W.tiff_bytes(grey[..., None] >> 6, 2, 1), "2-bit TIFF"),
        "float_predictor": (_tiff_with_tag(W.tiff_bytes(img, 8, 2, compression=5, predictor=2), 317, 3),
                            "floating-point predictor"),
    }


@pytest.mark.parametrize("kind", list(_refused_tiffs()))
def test_tiff_features_the_port_does_not_read_raise_naming_them(tmp_path, kind):
    """LZMA, ZSTD, WebP-in-TIFF, old-style JPEG, float and 32-bit samples
    (cv2 returns None for them too), BigTIFF, raw YCbCr, CMYK, 4-bit grey
    and 2-bit samples (cv2 refuses them too) and the floating-point
    predictor raise ValueError naming the file and the feature. CCITT,
    once refused, now decodes: raw rows labelled T.6 read as cv2 reads
    them, and labelled T.4 (no valid code) raise as corrupt."""
    from mga_yolo_tpu_torch.data import image_io

    data, what = _refused_tiffs()[kind]
    path = tmp_path / "r.tif"
    path.write_bytes(data)
    if what is None:
        _assert_reads_as_cv2(tmp_path, data, "ccitt.tif")
        return
    with pytest.raises(ValueError, match=rf"r\.tif: .*{what}"):
        image_io.imread(path)
    with pytest.raises(ValueError, match=what):
        image_io.decode(data, gray=True)
    if kind in ("float32", "int32", "grey4", "grey2"):
        assert cv2.imread(str(path)) is None


# ------------------------------------------------------------------ WebP


def _webp_pil(img, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, "RGBA" if img.shape[-1] == 4 else None).save(buf, "WEBP", **kw)
    return buf.getvalue()


WEBP_CASES = ["lossless", "lossless_noise", "lossless_palette2", "lossless_palette4", "lossless_palette16",
              "lossless_palette200", "lossless_method0", "lossless_method6", "lossless_alpha", "lossy_q5", "lossy_q30",
              "lossy_q75", "lossy_q95", "lossy_q100", "lossy_noise", "lossy_method0", "lossy_method6", "lossy_alpha",
              "lossy_tiny", "lossless_tiny", "cv2_lossy", "cv2_lossless", "cv2_grey_lossy", "anim_lossless",
              "anim_lossy", "anim_subcanvas_lossless", "anim_subcanvas_lossy", "vp8x_still"]


@pytest.mark.parametrize("case", WEBP_CASES)
def test_webp_equals_cv2(tmp_path, case):
    """Lossless (transforms, colour cache, meta prefix codes, palettes of 2
    to 200 colours) and lossy (qualities 5-100, the encoder's fastest and
    slowest methods, segments, both loop filters) WebP, with alpha, from PIL
    and cv2, at odd sizes; an animation's first frame, also on a larger
    canvas: colour and grey equal cv2."""
    rng = np.random.default_rng(len(case))
    h, w = (3, 5) if case.endswith("tiny") else (45, 67)
    img = _smooth(h, w, 3, 13) if "noise" not in case else rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if case.startswith("cv2"):
        q = {"cv2_lossy": 60, "cv2_lossless": 101, "cv2_grey_lossy": 40}[case]
        data = cv2.imencode(".webp", img[..., 0] if "grey" in case else img, [cv2.IMWRITE_WEBP_QUALITY, q])[1]
        data = data.tobytes()
    elif "palette" in case:
        n = int(case.rsplit("palette", 1)[1])
        data = _webp_pil(rng.integers(0, 256, (n, 3)).astype(np.uint8)[rng.integers(0, n, (h, w))], lossless=True)
    elif "alpha" in case:
        rgba = np.concatenate([img, _smooth(h, w, 1, 14)], -1)
        data = _webp_pil(rgba, lossless=case.startswith("lossless"), quality=80)
    elif case.startswith("anim"):
        from PIL import Image

        lossless = "lossless" in case
        if "subcanvas" in case:
            kind = b"VP8L" if lossless else b"VP8 "
            payload = W.riff_chunks(_webp_pil(img[:21, :27], lossless=lossless, quality=70))[kind]
            data = W.webp_bytes((67, 45), [(kind, payload, 10, 8, 27, 21), (kind, payload, 0, 0, 27, 21)])
        else:
            frames = [Image.fromarray(np.roll(img, 5 * i, 0)) for i in range(3)]
            buf = io.BytesIO()
            frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], lossless=lossless, quality=70,
                           duration=50)
            data = buf.getvalue()
    elif case == "vp8x_still":
        payload = W.riff_chunks(_webp_pil(img, quality=70))[b"VP8 "]
        data = W.webp_bytes((w, h), [(b"VP8 ", payload, 0, 0, w, h)])
    else:
        lossless = case.startswith("lossless")
        kw = {"lossless": lossless}
        if "_q" in case:
            kw["quality"] = int(case.rsplit("_q", 1)[1])
        if "method" in case:
            kw["method"] = int(case[-1])
        data = _webp_pil(img, **kw)
    _assert_reads_as_cv2(tmp_path, data, "w.webp")


VP8_SETTINGS = {  # libwebp's advanced API: what cv2 and PIL never ask for (tokens in 2-8 partitions need method <= 2)
    "simple_filter_weak": dict(filter_type=0, filter_strength=20), "simple_filter_strong": dict(filter_type=0,
                                                                                             filter_strength=100),
    "simple_filter_sharp": dict(filter_type=0, filter_strength=60, filter_sharpness=7),
    "normal_filter_sharp3": dict(filter_strength=60, filter_sharpness=3), "no_filter": dict(filter_strength=0),
    "autofilter": dict(autofilter=1), "partitions2": dict(partitions=1, method=2),
    "partitions4": dict(partitions=2, method=1), "partitions8": dict(partitions=3, method=0),
    "partitions8_low_memory": dict(partitions=3, low_memory=1), "one_segment": dict(segments=1),
    "two_segments_sns0": dict(segments=2, sns_strength=0), "four_segments_sns100": dict(segments=4, sns_strength=100),
    "sharp_yuv": dict(use_sharp_yuv=1), "dithering": dict(preprocessing=2), "quality1": dict(quality=1.0),
    "quality100_method6": dict(quality=100.0, method=6),
    "all_at_once": dict(filter_type=0, filter_strength=80, filter_sharpness=5, partitions=2, method=2, segments=3),
}


@pytest.mark.parametrize("setting", VP8_SETTINGS)
def test_vp8_encoder_settings_equal_cv2(tmp_path, setting):
    """Lossy WebP from libwebp's encoder at settings that change what the
    decoder must do (the simple loop filter, sharpness, no filter, 2 to 8
    token partitions, 1 to 4 segments, extreme quantisers), on an angiogram
    and on noise: colour and grey equal cv2."""
    from tests.jpeg_fixtures.make import picture

    for i, img in enumerate((picture(131, 173, 3, 4)[..., ::-1],
                             np.random.default_rng(1).integers(0, 256, (67, 45, 3)).astype(np.uint8))):
        _assert_reads_as_cv2(tmp_path, W.libwebp_encode(img, **VP8_SETTINGS[setting]), f"s{i}.webp")


def _libwebp_decodes(data: bytes) -> bool:
    """Whether libwebp (PIL's, through ctypes) decodes ``data``."""
    import ctypes

    lib = W._libwebp()
    lib.WebPDecodeBGR.restype = ctypes.c_void_p
    w, h = ctypes.c_int(), ctypes.c_int()
    out = lib.WebPDecodeBGR(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if out:
        lib.WebPFree(ctypes.c_void_p(out))
    return bool(out)


def _cut_vp8(data: bytes, k: int) -> bytes:
    """The lossy WebP with its last token partition ``k`` bytes short (the
    chunk left odd, unpadded, so that no pad byte stands in for the cut)."""
    body = W.riff_chunks(data)[b"VP8 "][:-k]
    chunk = b"VP8 " + struct.pack("<I", len(body)) + body
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


@pytest.mark.parametrize("partitions", [1, 4])
def test_vp8_cut_in_its_last_token_partition_raises_where_libwebp_fails(tmp_path, partitions):
    """Lossy files (libwebp's encoder, 1 and 4 token partitions) with their
    last partition cut 1, 2 and 3 bytes short: the port raises ValueError
    naming the file exactly where libwebp fails ("premature end of file":
    a bit asked for past the data), and reads the others as cv2 does. Cut
    2 bytes, some of the six pictures fail in libwebp; the port read those
    while it allowed two bytes past a partition. libwebp's encoder never
    needs its last byte, so no 1-byte cut fails in either."""
    from mga_yolo_tpu_torch.data import image_io
    from tests.jpeg_fixtures.make import picture

    failed = {1: 0, 2: 0, 3: 0}
    for seed in range(6):
        data = W.libwebp_encode(np.ascontiguousarray(picture(45, 61, 3, seed)[..., ::-1]),
                                partitions={1: 0, 4: 2}[partitions], method=2, quality=70.0)
        for k in failed:
            cut = _cut_vp8(data, k)
            path = tmp_path / f"cut{seed}_{k}.webp"
            path.write_bytes(cut)
            if _libwebp_decodes(cut):
                _assert_reads_as_cv2(tmp_path, cut, f"ok{seed}_{k}.webp")
                continue
            failed[k] += 1
            assert cv2.imread(str(path)) is None
            with pytest.raises(ValueError, match=rf"cut{seed}_{k}\.webp: WebP: truncated VP8 data \(token partition"):
                image_io.imread(path)
    assert failed[1] == 0 and failed[2] >= 2 and failed[3] >= failed[2]


def test_webp_at_angiogram_size_equals_cv2(tmp_path):
    """512 x 512 grey pictures (ARCADE's size: every intra mode, segment and
    partition count the encoder picks, meta prefix codes over many tiles),
    lossy at three qualities with 1 and 4 token partitions and lossless."""
    from tests.jpeg_fixtures.make import picture

    img = picture(512, 512, 1, 21)[..., 0]
    for q in (20, 70, 95, 101):
        _assert_reads_as_cv2(tmp_path, cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, q])[1].tobytes(),
                             f"g{q}.webp")
    from PIL import Image

    for kw in ({"quality": 60, "method": 2}, {"quality": 80, "method": 5}):
        buf = io.BytesIO()
        Image.fromarray(np.stack([img] * 3, -1)).save(buf, "WEBP", **kw)
        _assert_reads_as_cv2(tmp_path, buf.getvalue(), "p.webp")


def _webp_refused():
    img = _smooth(13, 17, 3, 15)
    lossy = W.riff_chunks(_webp_pil(img, quality=70))[b"VP8 "]
    inter = bytearray(lossy)
    inter[0] |= 1  # the frame tag's key-frame bit: an inter frame
    return {
        "inter_frame": (W.webp_bytes((17, 13), [(b"VP8 ", bytes(inter), 0, 0, 17, 13)]), "not a key frame"),
        "frame_outside_canvas": (W.webp_bytes((20, 14), [(b"VP8 ", lossy, 4, 2, 17, 13), (b"VP8 ", lossy, 0, 0, 17, 13)]),
                                 "outside its canvas"),
        "canvas_other_size": (W.webp_bytes((19, 13), [(b"VP8 ", lossy, 0, 0, 19, 13)]), "outside its canvas"),
        "no_image": (b"RIFF\x16\x00\x00\x00WEBPVP8X\x0a\x00\x00\x00" + bytes(10), "without an image"),
        "not_webp": (b"RIFF\x0c\x00\x00\x00WAVEfmt \x00\x00\x00\x00", "RIFF file that is not a WebP"),
        "vp8l_version": (b"RIFF" + struct.pack("<I", 4 + 8 + 6) + b"WEBPVP8L" + struct.pack("<I", 6)
                         + b"\x2f" + (0xE0000000 | (12 << 14) | 16).to_bytes(4, "little") + b"\x00",
                         "VP8L version is not 0"),
    }


@pytest.mark.parametrize("kind", list(_webp_refused()))
def test_webp_the_port_does_not_read_raises_naming_it(tmp_path, kind):
    """An inter frame, a frame outside its canvas, a still whose bitstream
    and canvas sizes differ, a RIFF without an image or that is not a WebP,
    and a VP8L of another version raise ValueError naming the file."""
    from mga_yolo_tpu_torch.data import image_io

    data, what = _webp_refused()[kind]
    path = tmp_path / "r.webp"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=rf"r\.webp: .*({what})"):
        image_io.imread(path)


# ------------------------------------------------------- cut and flipped files


def _valid_files():
    img = _smooth(29, 41, 3, 16)
    return {
        "png16_adam7": W.png_bytes(img.astype(np.int64) * 257, 16, 2, interlace=True),
        "png_grey2": W.png_bytes(img[..., :1] >> 6, 2, 0),
        "tiff_lzw_pred": W.tiff_bytes(img, 8, 2, compression=5, predictor=2, rows_per_strip=8),
        "tiff_packbits_tiles": W.tiff_bytes(img.astype(np.int64) * 257, 16, 2, compression=32773, tile=(16, 16)),
        "tiff_jpeg": W.jpeg_tiff_bytes(img, rows_per_strip=16),
        "webp_lossless": _webp_pil(img, lossless=True),
        "webp_lossy": _webp_pil(img, quality=60),
        "webp_anim": W.webp_bytes((41, 29), [(b"VP8L", W.riff_chunks(_webp_pil(img, lossless=True))[b"VP8L"], 0, 0,
                                              41, 29)] * 2),
    }


@pytest.mark.parametrize("source", list(_valid_files()))
def test_cut_and_flipped_files_raise_or_decode_at_their_header_size(source):
    """60 seeded truncations and byte flips of each file: each raises
    ValueError or gives an image of the size its (possibly flipped) header
    states, in colour and grey; none crashes the process."""
    from mga_yolo_tpu_torch.data import image_io

    data = _valid_files()[source]
    rng = np.random.default_rng(sum(map(ord, source)))
    for i in range(60):
        b = bytearray(data)
        if i % 2:
            b = b[:int(rng.integers(0, len(b)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                j = int(rng.integers(len(b)))
                b[j] = int(rng.integers(256)) if rng.random() < 0.5 else b[j] ^ (1 << int(rng.integers(8)))
        b = bytes(b)
        for gray in (False, True):
            try:
                out = image_io.decode(b, gray=gray)
            except ValueError:
                continue
            size = _header_size(b)
            assert out.shape == size + (() if gray else (3,)) and out.dtype == np.uint8


def _header_size(data: bytes) -> tuple[int, int]:
    """(h, w) an image's header states, as shown (EXIF orientation applied)."""
    from mga_yolo_tpu_torch.data import image_io

    if data.startswith(image_io.PNG_SIGNATURE):
        return struct.unpack(">I", data[20:24])[0], struct.unpack(">I", data[16:20])[0]
    if data.startswith(image_io.TIFF_SIGNATURES):
        return image_io._tiff_size(data, "x")
    canvas, _, orientation = image_io._webp_parse(data, "x")
    return canvas[::-1] if orientation >= 5 else canvas


# ------------------------------------------------------------ the C++ helpers


def test_png_helpers_equal_their_numpy_twins():
    """``png_unpack`` (1, 2, 4 bits, grey scales and palette indices),
    ``png_adam7_scatter`` (every pass), ``png_strip16``,
    ``png_rgb16_to_gray`` (RGB and RGBA), ``bgr_to_gray`` (cvtColor's,
    the TIFF raster's and libpng's weights) and ``gray_to_bgr`` equal the
    numpy twins (and cvtColor's twin equals cv2)."""
    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data import image_io

    rng = np.random.default_rng(0)
    for depth in (1, 2, 4):
        for n in (1, 7, 8, 13, 64):
            rows = rng.integers(0, 256, (5, (n * depth + 7) // 8)).astype(np.uint8)
            for scale in (1, 255 // ((1 << depth) - 1)):
                np.testing.assert_array_equal(native.png_unpack(rows, n, depth, scale),
                                              image_io.unpack_bits(rows, n, depth, scale))
    for h, w, px in ((1, 1, 1), (9, 13, 3), (16, 17, 8)):
        a, b = np.zeros((h, w, px), np.uint8), np.zeros((h, w, px), np.uint8)
        for p, (x0, y0, dx, dy) in enumerate(native.ADAM7):
            ph, pw = max(0, -(-(h - y0) // dy)), max(0, -(-(w - x0) // dx))
            pix = rng.integers(0, 256, (ph, pw, px)).astype(np.uint8)
            native.png_adam7_scatter(pix, p, a)
            image_io.adam7_scatter(pix, p, b)
        np.testing.assert_array_equal(a, b)
    s = rng.integers(0, 256, (7, 11, 8)).astype(np.uint8)
    np.testing.assert_array_equal(native.png_strip16(s), image_io.strip16(s))
    for c in (6, 8):
        np.testing.assert_array_equal(native.png_rgb16_to_gray(s[..., :c]), image_io.rgb16_to_gray(s[..., :c]))
    bgr = rng.integers(0, 256, (33, 65, 3)).astype(np.uint8)
    for weights, twin in (("cvtcolor", image_io.cvt_gray), ("tiff", image_io.tiff_gray),
                          ("libpng", image_io.png_gray)):
        np.testing.assert_array_equal(native.bgr_to_gray(bgr, weights), twin(bgr))
    np.testing.assert_array_equal(image_io.cvt_gray(bgr), cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))
    for c in (1, 2, 4):
        np.testing.assert_array_equal(native.gray_to_bgr(s[..., :c]), np.repeat(s[..., :1], 3, -1))


def test_tiff_helpers_equal_their_numpy_twins():
    """``tiff_lzw`` and ``tiff_packbits`` on encoded runs, noise, empty and
    long inputs (the LZW table cleared at 4093 codes), and
    ``tiff_predict`` at 8 and 16 bits in both byte orders, equal the
    Python twins and invert the writers; corrupt LZW raises in both."""
    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data import image_io

    rng = np.random.default_rng(1)
    for n, levels in ((0, 2), (1, 2), (300, 3), (5000, 256), (20000, 4)):
        raw = rng.integers(0, levels, n).astype(np.uint8).tobytes()
        for enc, fn, twin in ((W.lzw, native.tiff_lzw, image_io.lzw_expand),
                              (W.packbits, native.tiff_packbits, image_io.packbits_expand)):
            coded = enc(raw)
            assert fn(coded, n).tobytes() == twin(coded, n).tobytes() == raw
            if n:
                for f in (fn, twin):
                    with pytest.raises(ValueError):
                        f(coded[:len(coded) // 3], n)
    with pytest.raises(ValueError, match="corrupt LZW"):
        native.tiff_lzw(bytes([0x80, 0x3F, 0xFF, 0xFF]), 8)
    with pytest.raises(ValueError, match="corrupt LZW"):
        image_io.lzw_expand(bytes([0x80, 0x3F, 0xFF, 0xFF]), 8)
    for bits in (8, 16):
        for big in (False, True):
            samples = rng.integers(0, 1 << bits, (6, 10 * 3))
            dtype = (">" if big else "<") + ("u2" if bits == 16 else "u1")
            buf = np.frombuffer(W._predict(samples, 3, bits).astype(dtype).tobytes(), np.uint8).copy()
            twin = image_io.undo_predictor(buf, 6, 30, 3, bits, big)
            native.tiff_predict(buf, 6, 30, 3, bits, big)
            np.testing.assert_array_equal(buf, twin)
            np.testing.assert_array_equal(np.frombuffer(buf.tobytes(), dtype).reshape(6, 30), samples)


def test_new_formats_raise_when_the_library_does_not_build(tmp_path, monkeypatch):
    """No fallback: with a ``webp.cpp`` that g++ rejects, a WebP, an LZW
    TIFF and a 16-bit PNG raise RuntimeError with the compiler's message."""
    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data import image_io

    bad = tmp_path / "webp.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "CODEC_SOURCES", (*native.CODEC_SOURCES[:-1], bad))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    img = _smooth(9, 11, 3, 0)
    files = (cv2.imencode(".webp", img)[1].tobytes(), W.tiff_bytes(img, 8, 2, compression=5),
             W.png_bytes(img.astype(np.int64) * 257, 16, 2))
    for data in files:
        with pytest.raises(RuntimeError, match=r"webp\.cpp.* is not available: g\+\+ .* failed:\n.*error"):
            image_io.imdecode(data)


# ---------------------------------------------------------------- fixtures


def _fixture_names():
    return sorted(k for k in np.load(FIXTURES / "pixels.npz").files if not k.endswith("_gray"))


@pytest.mark.parametrize("name", _fixture_names())
def test_committed_fixture_pixels_equal_cv2(name):
    """The fixtures ``chip_smoke.py`` ``[formats]`` decodes on the card's
    host: cv2's decode of each today equals the pixels stored beside it,
    and so does the port's (colour and grey); ``image_size`` gives its shape
    from the headers, with decoding made to fail."""
    from unittest import mock

    from mga_yolo_tpu_torch.data import image_io

    pixels = np.load(FIXTURES / "pixels.npz")
    data = (FIXTURES / name).read_bytes()
    for key, flag in ((name, cv2.IMREAD_COLOR), (f"{name}_gray", cv2.IMREAD_GRAYSCALE)):
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), flag), pixels[key])
        np.testing.assert_array_equal(image_io.decode(data, name, gray=flag == cv2.IMREAD_GRAYSCALE), pixels[key])
    with mock.patch.object(image_io, "decode", side_effect=AssertionError("image_size decoded the pixels")):
        assert image_io.image_size(FIXTURES / name) == pixels[name].shape[:2]


def test_committed_timing_fixtures_decode_to_cv2_digests():
    """The four 512 x 512 timing files: cv2's decodes and the port's have
    the SHA-256 stored in ``bench.json``."""
    from mga_yolo_tpu_torch.data import image_io

    digests = json.loads((FIXTURES / "bench.json").read_text())
    assert len(digests) == 4
    for name, want in digests.items():
        data = (FIXTURES / name).read_bytes()
        for mode, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE)):
            assert hashlib.sha256(cv2.imdecode(np.frombuffer(data, np.uint8), flag).tobytes()).hexdigest() \
                == want[mode]
            assert hashlib.sha256(image_io.decode(data, gray=mode == "gray").tobytes()).hexdigest() == want[mode]


# --------------------------------------------------------------- consumers


def _format_files(root: Path, img: np.ndarray, stem: str) -> dict[str, Path]:
    """``img`` (BGR) as a 16-bit PNG, an LZW TIFF and a lossy and a lossless WebP."""
    from PIL import Image

    root.mkdir(parents=True, exist_ok=True)
    out = {"png16": root / f"{stem}.png", "tiff": root / f"{stem}.tif", "webp": root / f"{stem}.webp",
           "webp_lossless": root / f"{stem}_l.webp"}
    cv2.imwrite(str(out["png16"]), img.astype(np.uint16) * 257 + 100)
    cv2.imwrite(str(out["tiff"]), img, [cv2.IMWRITE_TIFF_COMPRESSION, 5])
    cv2.imwrite(str(out["webp"]), img, [cv2.IMWRITE_WEBP_QUALITY, 80])
    Image.fromarray(img[..., ::-1]).save(out["webp_lossless"], "WEBP", lossless=True)
    return out


def test_masks_sources_calibration_uploads_and_plot_read_the_new_formats(tmp_path):
    """The readers that go through image_io take a 16-bit PNG, an LZW TIFF
    and lossy and lossless WebP: masks (1-bit PNG, 1-bit and 8-bit TIFF,
    grey read > 0) equal the JAX ``load_binary_mask``; the prediction
    sources (a file and a directory), the int8 calibration reader, the
    server's upload decode and the predictor's plot give cv2's pixels."""
    from mga_yolo_tpu.data import mask_ops as jax_mask_ops
    from mga_yolo_tpu_torch.data import image_io, mask_ops, sources
    from mga_yolo_tpu_torch.data.transforms import letterbox
    from mga_yolo_tpu_torch.export.tflite import _representative_gen
    from mga_yolo_tpu_torch.train.predictor import Results

    img = _smooth(40, 56, 3, 21)
    mask = (img[..., 0] > 128).astype(np.uint8)
    (tmp_path / "m1.png").write_bytes(W.png_bytes(mask[..., None], 1, 0))
    (tmp_path / "m.tif").write_bytes(W.tiff_bytes(mask[..., None], 1, 0, compression=32773))
    cv2.imwrite(str(tmp_path / "m8.tif"), mask * 255)
    for m in ("m1.png", "m.tif", "m8.tif"):
        got = mask_ops.load_binary_mask(tmp_path / m)
        np.testing.assert_array_equal(got, jax_mask_ops.load_binary_mask(tmp_path / m))
        assert got.sum() == (mask if m != "m.tif" else 1 - mask).sum()  # m.tif is MinIsWhite
    files = _format_files(tmp_path / "src", img, "a")
    for path in files.values():
        want = cv2.imread(str(path))
        (frame,) = list(sources.iter_source(path))
        np.testing.assert_array_equal(frame.img, want)
        (batch,) = next(_representative_gen(path, 1, 64)())
        np.testing.assert_array_equal(batch[0], letterbox(want, 64, scaleup=False)[0].astype(np.float32))
        np.testing.assert_array_equal(image_io.imdecode(path.read_bytes(), "upload"), want)  # serve.py's call
        r = Results(path=str(path), orig_shape=want.shape[:2], boxes=np.zeros((0, 6), np.float32), mga_masks={})
        np.testing.assert_array_equal(r.plot(), want)
    frames = list(sources.iter_source(tmp_path / "src"))
    assert sorted(Path(f.path).name for f in frames) == sorted(p.name for p in files.values())


@pytest.fixture(scope="module")
def formats_ds(tmp_path_factory):
    """The synthetic dataset's six images in the new formats, three aspects
    (96 x 96, 64 rows x 96, 96 x 64): 16-bit PNG, LZW TIFF (one stored
    turned half round with Orientation 3), lossy WebP stored turned a
    quarter with an EXIF orientation 6 and lossless WebP; masks as 1-bit
    PNG, PackBits TIFF and 8-bit LZW TIFF."""
    import yaml

    from tests.synth import create_synthetic_dataset

    synth = create_synthetic_dataset(tmp_path_factory.mktemp("synth"), n=6, size=96, seed=3)
    src, root = synth.parent, tmp_path_factory.mktemp("formats")
    for d in ("images/train", "labels/train", "masks"):
        (root / d).mkdir(parents=True)
    from PIL import Image

    for i, png in enumerate(sorted((src / "images" / "train").glob("*.png"))):
        size = ((96, 96), (96, 64), (64, 96))[i % 3]  # (w, h)
        img = cv2.resize(cv2.imread(str(png)), size, interpolation=cv2.INTER_LINEAR)
        mask = cv2.resize(cv2.imread(str(src / "masks" / png.name), cv2.IMREAD_GRAYSCALE), size,
                          interpolation=cv2.INTER_NEAREST)
        out = root / "images" / "train" / png.stem
        if i in (0, 3):
            cv2.imwrite(f"{out}.png", img.astype(np.uint16) * 257 + 55)
        elif i == 1:  # stored turned half round, Orientation 3
            (root / "images" / "train" / f"{png.stem}.tif").write_bytes(
                W.tiff_bytes(img[::-1, ::-1, ::-1], 8, 2, compression=5, predictor=2, orientation=3, rows_per_strip=7))
        elif i == 4:
            cv2.imwrite(f"{out}.tif", img, [cv2.IMWRITE_TIFF_COMPRESSION, 5])
        elif i == 2:  # stored turned a quarter, shown upright by its EXIF orientation 6
            turned = np.ascontiguousarray(np.rot90(img, 1)[..., ::-1])
            buf = io.BytesIO()
            Image.fromarray(turned).save(buf, "WEBP", quality=90)
            (root / "images" / "train" / f"{png.stem}.webp").write_bytes(W.webp_bytes(
                turned.shape[1::-1], [(b"VP8 ", W.riff_chunks(buf.getvalue())[b"VP8 "], 0, 0) + turned.shape[1::-1]],
                exif=W.exif_block(6)))
        else:
            Image.fromarray(img[..., ::-1]).save(f"{out}.webp", "WEBP", lossless=True)
        m = (mask > 0).astype(np.uint8)
        if i % 3 == 0:
            (root / "masks" / f"{png.stem}.png").write_bytes(W.png_bytes(m[..., None], 1, 0))
        elif i % 3 == 1:
            (root / "masks" / f"{png.stem}.tif").write_bytes(W.tiff_bytes(m[..., None], 1, 1, compression=32773))
        else:
            cv2.imwrite(str(root / "masks" / f"{png.stem}.tif"), m * 255, [cv2.IMWRITE_TIFF_COMPRESSION, 5])
        (root / "labels" / "train" / f"{png.stem}.txt").write_text(
            (src / "labels" / "train" / f"{png.stem}.txt").read_text())
    data = yaml.safe_load(synth.read_text())
    data.update(path=str(root), dataset=str(root))
    (root / "data.yaml").write_text(yaml.safe_dump(data))
    return root / "data.yaml"


@pytest.mark.parametrize("rect", [False, True])
def test_dataset_samples_and_rect_buckets_of_the_new_formats_equal_jax(formats_ds, rect):
    """MGADataset over 16-bit PNG, TIFF (one with an orientation) and WebP
    images with 1-bit PNG and TIFF masks: the rect buckets (the port's
    header reads; the JAX package's cv2 decode for TIFF and WebP) and every
    eval sample equal the JAX dataset's (boxes within 1e-3 px, image within
    one grey level of the resize, masks as the JAX pyramid)."""
    from mga_yolo_tpu.config import load_config as jload
    from mga_yolo_tpu.data.dataset import MGADataset as JDS
    from mga_yolo_tpu_torch.config import load_config as pload
    from mga_yolo_tpu_torch.data.dataset import MGADataset as PDS

    kw = dict(data=str(formats_ds), imgsz=64, max_boxes=8, rect=rect, cache="ram")
    jds, pds = JDS(jload(**kw), "val", augment=False), PDS(pload(**kw), "val", augment=False)
    assert {p.suffix for p in pds.img_files} == {".png", ".tif", ".webp"}
    if rect:
        np.testing.assert_array_equal(pds.bucket, jds.bucket)
        assert len(set(pds.bucket.tolist())) == 3  # wide, square and tall
    for i in range(len(jds)):
        got, want = pds.get(i), jds.get(i)
        np.testing.assert_allclose(got["gt_boxes"], want["gt_boxes"], rtol=0, atol=1e-3)
        np.testing.assert_array_equal(got["mask_gt"], want["mask_gt"])
        assert np.abs(got["image"].astype(int) - want["image"]).max() <= 1
        for a, b in zip(got["masks"], want["masks"]):
            assert a.shape == b.shape and (a != b).mean() < 0.005


def test_kfold_lists_the_new_formats_as_jax(formats_ds, tmp_path):
    """The k-fold splitter takes the TIFF, WebP and 16-bit PNG images: the
    port's fold trees hold the files the JAX package's hold."""
    from mga_yolo_tpu.data import kfold as jax_kfold
    from mga_yolo_tpu_torch.data import kfold

    images = formats_ds.parent / "images" / "train"
    for mod, out in ((kfold, tmp_path / "port"), (jax_kfold, tmp_path / "jax")):
        mod.main(["--images", str(images), "--out", str(out), "--k", "3", "--seed", "1"])
    for fold in range(3):
        for split in ("train", "val"):
            names = [sorted(p.name for p in (tmp_path / side / f"fold_{fold}" / "images" / split).iterdir())
                     for side in ("port", "jax")]
            assert names[0] == names[1] and names[0]
    assert {p.suffix for p in (tmp_path / "port" / "fold_0" / "images").rglob("*")} >= {".png", ".tif", ".webp"}


@pytest.mark.usefixtures("few_torch_threads")
def test_server_uploads_and_cli_predict_take_the_new_formats(tmp_path, capsys):
    """The flagship (64 px, seeded weights, CPU) behind ``build_server``
    answers POSTed 16-bit PNG, TIFF and WebP uploads with the boxes it gives
    for cv2's decode of the same bytes, and ``cli.predict`` over a
    directory of them writes each overlay at the source's cv2 shape."""
    import torch
    import urllib.request

    from mga_yolo_tpu_torch.cli import predict as cli_predict
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.serve import build_server

    torch.manual_seed(0)
    model, _ = create_model("configs/models/yolov8_cbam.yaml", scale="n", nc=1, device="cpu")
    ckpt = tmp_path / "best.pt"
    torch.save({"ema_state_dict": model.state_dict(), "train_args": {"nc": 1, "model": "configs/models/yolov8_cbam.yaml",
                                                                     "model_scale": "n"},
                "meta": {"imgsz": 64, "model_yaml": "configs/models/yolov8_cbam.yaml", "model_scale": "n", "nc": 1}},
               ckpt)
    img = _smooth(48, 60, 3, 31)
    files = _format_files(tmp_path / "src", img, "u")
    exif6 = tmp_path / "src" / "u_exif6.png"
    exif6.write_bytes(W.png_bytes(img[..., ::-1], 8, 2, orientation=6))
    files["png_exif6"] = exif6
    server = build_server(ckpt, imgsz=64, batch=2, conf=0.001, port=0, device="cpu")
    server.start()
    try:
        for path in files.values():
            req = urllib.request.Request(f"http://127.0.0.1:{server.port}/predict", data=path.read_bytes(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                reply = json.loads(r.read())
            want = server.batcher.submit(cv2.imread(str(path)))
            got = np.array([[b["x1"], b["y1"], b["x2"], b["y2"], b["conf"], b["cls"]] for b in reply["boxes"]],
                           np.float32).reshape(-1, 6)
            assert reply["orig_shape"] == list(want.orig_shape) == list(cv2.imread(str(path)).shape[:2])
            np.testing.assert_allclose(got, want.boxes, rtol=1e-5, atol=1e-4)
    finally:
        server.stop()
    out = tmp_path / "pred"
    res = cli_predict.main(["--weights", str(ckpt), "--source", str(tmp_path / "src"), "--out", str(out),
                            "--device", "cpu"])
    assert res["images"] == len(files)
    for path in files.values():
        stem = path.stem
        assert image_io.imread(out / f"{stem}_pred.jpg").shape == cv2.imread(str(path)).shape
    capsys.readouterr()
