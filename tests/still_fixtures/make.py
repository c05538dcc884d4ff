"""Writes the still-format fixtures in this directory, and cv2's decodes of them.

``python -m tests.still_fixtures.make`` (cv2 and PIL, the JAX package's
decoders, in the test environment). Small files (at most 64 x 64) cover
the decoders' modes: PNG at bit depths 1, 2, 4, 16 with tRNS, Adam7 and
eXIf orientations before and after the image data; TIFF strips and tiles,
both byte orders, LZW with the predictor, Deflate, PackBits, JPEG with
shared tables, MinIsWhite, palettes, unassociated alpha on separate
planes, the Orientation tag and the clipped 16-bit grey tile libtiff reads
askew; WebP lossless and lossy, grey, alpha, palettes, an animation with a
first frame smaller than its canvas, an EXIF orientation, and one with
the simple loop filter in four token partitions (libwebp's encoder
through ctypes).
``pixels.npz`` holds cv2's colour (``<name>``) and grey (``<name>_gray``)
decode of each, keyed by file name. The four larger files time the
decoders: one 512 x 512 grey angiogram (ARCADE's size) as a 16-bit PNG, an
LZW TIFF, a lossless and a lossy WebP; ``bench.json`` holds the SHA-256 of
cv2's decodes of each. ``tests/test_torch_still_formats.py`` checks that
both still hold; ``chip_smoke.py`` ``[formats]`` decodes them on the card's
host.
"""

from __future__ import annotations

import hashlib
import io
import json
from pathlib import Path

import cv2
import numpy as np

from tests.jpeg_fixtures.make import picture
from tests.still_fixtures.writers import (exif_block, jpeg_tiff_bytes, libwebp_encode, png_bytes, riff_chunks,
                                          tiff_bytes, webp_bytes)

HERE = Path(__file__).resolve().parent


def _pil(img: np.ndarray, mode: str | None = None, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, **kw)
    return buf.getvalue()


def angiogram16(size: int, seed: int) -> np.ndarray:
    """A smooth 16-bit grey picture with thin dark curves and mild noise."""
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.uniform(0.2, 0.8, (size, size)).astype(np.float32), (0, 0), size / 16)
    img = (img - img.min()) / np.ptp(img) * 0.7 + 0.15
    for _ in range(size // 16):
        pts = np.cumsum(rng.normal(0, size / 12, (8, 2)), 0) + rng.uniform(0, size, 2)
        cv2.polylines(img, [pts.astype(np.int32)], False, 0.08, int(rng.integers(1, 4)), cv2.LINE_AA)
    img = cv2.GaussianBlur(img, (3, 3), 0.8) + rng.normal(0, 0.0004, img.shape)
    return np.clip(img * 65535, 0, 65535).astype(np.uint16)


def small_files() -> dict[str, bytes]:
    rng = np.random.default_rng(0)
    bgr = picture(45, 61, 3, 1)
    rgb = bgr[..., ::-1]
    grey = picture(47, 53, 1, 2)[..., 0]
    mask = (picture(45, 61, 1, 3)[..., 0] < 90).astype(np.uint8)
    g16 = angiogram16(48, 4)[:41, :37, None]
    rgb16 = rgb.astype(np.uint16) * 257 + rng.integers(0, 257, rgb.shape).astype(np.uint16)
    pal = rng.integers(0, 256, (16, 3))
    idx4 = rng.integers(0, 16, (33, 29, 1))
    cmap16 = rng.integers(0, 65536, (256, 3))
    alpha = picture(45, 61, 1, 5)
    out = {
        "png_grey1_mask.png": png_bytes(mask[..., None], 1, 0),
        "png_grey2_adam7.png": png_bytes(grey[..., None] >> 6, 2, 0, interlace=True),
        "png_grey4_trns.png": png_bytes(grey[..., None] >> 4, 4, 0, trns=b"\x00\x07"),
        "png_grey16.png": png_bytes(g16, 16, 0),
        "png_grey16_adam7.png": png_bytes(g16, 16, 0, interlace=True),
        "png_rgb16.png": png_bytes(rgb16, 16, 2),
        "png_rgba16_adam7.png": png_bytes(np.concatenate([rgb16, alpha.astype(np.uint16) * 257], -1), 16, 6,
                                          interlace=True),
        "png_grey_alpha16.png": png_bytes(np.concatenate([g16, g16[::-1]], -1), 16, 4),
        "png_pal4_trns_adam7.png": png_bytes(idx4, 4, 3, palette=pal, trns=bytes(range(0, 160, 10)), interlace=True),
        "png_pal1.png": png_bytes(mask[..., None], 1, 3, palette=pal[:2]),
        "png_rgb8_exif6_after_idat.png": png_bytes(rgb, 8, 2, orientation=6, exif_after_idat=True),
        "png_grey8_exif8.png": png_bytes(grey[..., None], 8, 0, orientation=8),
        "tiff_rgb8_lzw_predictor_cv2.tif": cv2.imencode(".tif", bgr, [cv2.IMWRITE_TIFF_COMPRESSION, 5,
                                                                     cv2.IMWRITE_TIFF_PREDICTOR, 2])[1].tobytes(),
        "tiff_grey16_lzw_predictor_be_tiles.tif": tiff_bytes(angiogram16(64, 6)[..., None], 16, 1, compression=5,
                                                             predictor=2, big_endian=True, tile=(32, 32)),
        "tiff_grey16_deflate_clipped_tile.tif": tiff_bytes(g16, 16, 1, compression=8, tile=(32, 16)),
        "tiff_grey1_miniswhite_packbits.tif": tiff_bytes(mask[..., None], 1, 0, compression=32773, rows_per_strip=8),
        "tiff_pal8_deflate.tif": tiff_bytes(rng.integers(0, 256, (29, 35, 1)), 8, 3, compression=32946,
                                            colormap=cmap16),
        "tiff_pal4_lzw.tif": tiff_bytes(idx4, 4, 3, compression=5, colormap=cmap16[:16]),
        "tiff_rgba8_unassociated_planar.tif": tiff_bytes(np.concatenate([rgb, alpha], -1), 8, 2, compression=5,
                                                         planar=2, rows_per_strip=16, extra_samples=[2]),
        "tiff_rgb16_deflate_be.tif": tiff_bytes(rgb16, 16, 2, compression=8, predictor=2, big_endian=True),
        "tiff_grey_alpha8_clipped_tile.tif": tiff_bytes(np.concatenate([grey[..., None], grey[::-1, :, None]], -1), 8,
                                                        1, compression=32773, tile=(32, 32), extra_samples=[2]),
        "tiff_jpeg_ycbcr_strips.tif": jpeg_tiff_bytes(bgr, rows_per_strip=16, quality=85),
        "tiff_jpeg_rgb_pil.tif": _pil(rgb, format="TIFF", compression="jpeg", quality=80),
        "tiff_grey8_lzw_exif6.tif": tiff_bytes(grey[..., None], 8, 1, compression=5, orientation=6, rows_per_strip=9),
        "webp_lossless.webp": _pil(rgb, format="WEBP", lossless=True),
        "webp_lossy_q75_cv2.webp": cv2.imencode(".webp", bgr, [cv2.IMWRITE_WEBP_QUALITY, 75])[1].tobytes(),
        "webp_grey_lossy_q30_cv2.webp": cv2.imencode(".webp", grey, [cv2.IMWRITE_WEBP_QUALITY, 30])[1].tobytes(),
        "webp_alpha_lossy.webp": _pil(np.concatenate([rgb, alpha], -1), "RGBA", format="WEBP", quality=80),
        "webp_alpha_lossless.webp": _pil(np.concatenate([rgb, alpha], -1), "RGBA", format="WEBP", lossless=True),
        "webp_palette_lossless.webp": _pil(pal[rng.integers(0, 5, (37, 41))].astype(np.uint8), format="WEBP",
                                           lossless=True),
    }
    from PIL import Image

    frames = [Image.fromarray(np.roll(rgb, 9 * i, 1)) for i in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], lossless=True, duration=80)
    out["webp_anim_lossless.webp"] = buf.getvalue()
    lossy = riff_chunks(_pil(rgb[:21, :27], format="WEBP", quality=70))[b"VP8 "]
    out["webp_anim_subcanvas_lossy.webp"] = webp_bytes((61, 45), [(b"VP8 ", lossy, 8, 6, 27, 21),
                                                                 (b"VP8 ", lossy, 0, 0, 27, 21)])
    out["webp_exif6_lossy.webp"] = webp_bytes((27, 21), [(b"VP8 ", lossy, 0, 0, 27, 21)], exif=exif_block(6))
    out["webp_simple_filter_4partitions.webp"] = libwebp_encode(picture(64, 61, 3, 7)[..., ::-1], filter_type=0,
                                                                filter_strength=70, filter_sharpness=4, partitions=2,
                                                                method=2, segments=4)
    return out


def bench_files() -> dict[str, bytes]:
    g16 = angiogram16(512, 100)
    g8 = (g16 >> 8).astype(np.uint8)
    return {
        "grey512_16bit.png": png_bytes(g16[..., None], 16, 0, filters=(4,)),
        "grey512_lzw.tif": cv2.imencode(".tif", g8, [cv2.IMWRITE_TIFF_COMPRESSION, 5])[1].tobytes(),
        "grey512_lossless.webp": cv2.imencode(".webp", g8, [cv2.IMWRITE_WEBP_QUALITY, 101])[1].tobytes(),
        "grey512_lossy.webp": cv2.imencode(".webp", g8, [cv2.IMWRITE_WEBP_QUALITY, 90])[1].tobytes(),
    }


def decoded(data: bytes, flag: int) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
    assert img is not None
    return img


def main() -> None:
    for old in HERE.glob("*"):
        if old.suffix in (".png", ".tif", ".webp", ".npz", ".json"):
            old.unlink()
    pixels = {}
    for name, data in small_files().items():
        (HERE / name).write_bytes(data)
        pixels[name] = decoded(data, cv2.IMREAD_COLOR)
        pixels[f"{name}_gray"] = decoded(data, cv2.IMREAD_GRAYSCALE)
    np.savez_compressed(HERE / "pixels.npz", **pixels)
    digests = {}
    for name, data in bench_files().items():
        (HERE / name).write_bytes(data)
        digests[name] = {"color": hashlib.sha256(decoded(data, cv2.IMREAD_COLOR).tobytes()).hexdigest(),
                         "gray": hashlib.sha256(decoded(data, cv2.IMREAD_GRAYSCALE).tobytes()).hexdigest()}
    (HERE / "bench.json").write_text(json.dumps(digests, indent=1) + "\n")


if __name__ == "__main__":
    main()
