"""Writes the fixtures of the formats the port reads since its CCITT, GIF
and upload-only decoders (``data/image_io.py``, ``data/raster_io.py``,
``data/video_io.py``), and cv2's decodes of them.

``python -m tests.format_fixtures.make`` (cv2 and PIL, the JAX package's
decoders, in the test environment). Small files cover the decoders' modes:

* CCITT TIFF masks (PIL through libtiff): modified Huffman, T.4 1-D, 2-D
  and 2-D with byte-aligned EOLs, T.6, FillOrder 2, MinIsWhite;
* GIF stills and clips: PIL's disposals 0-3 with a transparent index and
  interlace at variable delays, and ``writers.gif_bytes``' frames smaller
  than the canvas and offset, local colour tables, a transparent index on
  the first and on later frames, the background index, a file without a
  global table, codes grown to 12 bits with and without a clear at 4096;
* PNM (``P1``-``P6``, ASCII and binary, maxval 1-65535), PAM (GRAYSCALE,
  RGB, BLACKANDWHITE), PFM (both byte orders and scales), Sun raster
  (1, 8 with and without a colour map, 24 and 32 bits) and Radiance HDR
  (run-length and flat scanlines), from cv2's encoders and the writers.

``pixels.npz`` holds cv2's colour (``<name>``) and grey (``<name>_gray``)
decode of each still (a GIF's first frame), ``frames.npz`` every frame
``cv2.VideoCapture`` gives of each clip (``<name>``) and ``clips.json``
its ``CAP_PROP_FPS``, ``CAP_PROP_FRAME_COUNT`` and fourcc. The two larger
files time the decoders: a 640 x 640 angiogram mask as a T.6 TIFF and a
two-frame 640 x 640 angiogram GIF (``bench.json``: SHA-256 of cv2's
decodes and, for the GIF, of its video frames).
``tests/test_torch_more_formats.py`` checks that all of it still holds;
``chip_smoke.py`` ``[formats2]`` decodes them on the card's host.
"""

from __future__ import annotations

import hashlib
import io
import json
import tempfile
from pathlib import Path

import cv2
import numpy as np

from tests.jpeg_fixtures.make import picture
from tests.still_fixtures.writers import gif_bytes, hdr_bytes, sun_bytes

HERE = Path(__file__).resolve().parent
SUFFIXES = (".tif", ".gif", ".pbm", ".pgm", ".ppm", ".pam", ".pfm", ".ras", ".hdr", ".npz", ".json")


def _pil(img: np.ndarray, fmt: str, mode: str | None = None, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, fmt, **kw)
    return buf.getvalue()


def mask(h: int, w: int, seed: int) -> np.ndarray:
    """A bool vessel mask: the dark curves of an angiogram-like picture."""
    return picture(h, w, 1, seed)[..., 0] < 90


def ccitt_files() -> dict[str, bytes]:
    m = mask(70, 90, 1)
    tif = lambda comp, info=None: _pil(m, "TIFF", compression=comp, tiffinfo=info or {})  # noqa: E731
    return {  # tags: 262 PhotometricInterpretation, 266 FillOrder, 278 RowsPerStrip, 292 T4Options
        "ccitt_rle.tif": tif("tiff_ccitt"),
        "ccitt_g3_1d.tif": tif("group3"),
        "ccitt_g3_2d.tif": tif("group3", {292: 1}),
        "ccitt_g3_2d_aligned_eol.tif": tif("group3", {292: 5}),
        "ccitt_g3_1d_fill2.tif": tif("group3", {266: 2}),
        "ccitt_g4.tif": tif("group4"),
        "ccitt_g4_fill2.tif": tif("group4", {266: 2}),
        "ccitt_g4_miniswhite_strips.tif": tif("group4", {262: 0, 278: 16}),
    }


def gif_stills_and_clips() -> dict[str, bytes]:
    from PIL import Image

    rng = np.random.default_rng(3)
    rgb = [np.ascontiguousarray(picture(48, 64, 3, 10 + i)[..., ::-1]) for i in range(4)]
    frames = [Image.fromarray(f).quantize(32, dither=Image.Dither.NONE) for f in rgb]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=[40, 100, 70, 200],
                   disposal=[0, 1, 2, 3], transparency=0, interlace=True, optimize=False)
    pal = rng.integers(0, 256, (16, 3))
    idx = lambda h, w, n, s: np.random.default_rng(s).integers(0, n, (h, w)).astype(np.uint8)  # noqa: E731
    sub = [
        {"indices": idx(30, 40, 16, 1), "transparent": 3, "disposal": 1, "delay": 5},
        {"indices": idx(12, 20, 8, 2), "x": 7, "y": 5, "palette": rng.integers(0, 256, (8, 3)), "disposal": 2,
         "transparent": 1, "delay": 12},
        {"indices": idx(17, 9, 16, 3), "x": 30, "y": 13, "interlace": True, "disposal": 3, "delay": 0},
        {"indices": idx(30, 40, 4, 4), "palette": rng.integers(0, 256, (4, 3)), "transparent": 0, "delay": 9},
        {"indices": idx(6, 6, 16, 5), "x": 1, "y": 1, "gce": False},
    ]
    big = idx(96, 96, 256, 6)
    pal256 = rng.integers(0, 256, (256, 3))
    return {
        "gif_pil_disposals_interlaced.gif": buf.getvalue(),
        "gif_subframes_local_tables.gif": gif_bytes((40, 30), sub, palette=pal, background=6),
        "gif_first_frame_offset_background.gif": gif_bytes((33, 21), [
            {"indices": idx(9, 11, 16, 7), "x": 20, "y": 10, "delay": 7},
            {"indices": idx(21, 33, 16, 8), "disposal": 2, "delay": 7}], palette=pal, background=11),
        "gif_no_global_table.gif": gif_bytes((25, 19), [
            {"indices": idx(10, 12, 4, 9), "x": 3, "y": 4, "palette": pal[:4], "transparent": 2},
            {"indices": idx(19, 25, 4, 10), "palette": pal[4:8], "delay": 3}]),
        "gif_lzw_12bit_clear.gif": gif_bytes((96, 96), [{"indices": big}], palette=pal256),
        "gif_lzw_12bit_deferred_clear.gif": gif_bytes((96, 96), [{"indices": big, "clear_at_full": False},
                                                                 {"indices": big[::-1], "clear_at_full": False}],
                                                      palette=pal256),
        "gif_grey_pil.gif": _pil(picture(37, 29, 1, 11)[..., 0], "GIF"),
    }


def raster_files() -> dict[str, bytes]:
    rng = np.random.default_rng(5)
    bgr = picture(23, 31, 3, 20)
    grey = picture(19, 27, 1, 21)[..., 0]
    bits = mask(21, 19, 22).astype(np.uint8)
    enc = lambda ext, img, *p: cv2.imencode(ext, img, list(p))[1].tobytes()  # noqa: E731
    ascii_ppm = rng.integers(0, 1001, (11, 13, 3))
    g16 = rng.integers(0, 65536, (9, 14))
    pam = lambda w, h, d, m, t, body: (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {d}\nMAXVAL {m}\nTUPLTYPE {t}\nENDHDR\n"  # noqa: E731
                                       .encode() + body)
    floats = (picture(15, 17, 3, 23).astype(np.float32) / 97 - 0.3)
    rgbe = rng.integers(0, 256, (13, 37, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, rgbe.shape[:2])
    rgbe[:, 5:20] = rgbe[:, 5:6]
    cmap = rng.integers(0, 256, (3, 256)).astype(np.uint8)
    return {
        "pnm_p1_ascii.pbm": enc(".pbm", bits * 255, cv2.IMWRITE_PXM_BINARY, 0),
        "pnm_p4_binary.pbm": enc(".pbm", bits * 255),
        "pnm_p2_ascii_maxval100.pgm": b"P2\n# a comment\n27 19\n100\n"
        + " ".join(map(str, (grey.astype(np.int64) * 100 // 255).reshape(-1))).encode() + b"\n",
        "pnm_p5_binary.pgm": enc(".pgm", grey),
        "pnm_p5_16bit.pgm": b"P5\n14 9\n65535\n" + g16.astype(">u2").tobytes(),
        "pnm_p3_ascii_maxval1000.ppm": b"P3\n13 11\n1000\n" + " ".join(map(str, ascii_ppm.reshape(-1))).encode() + b"\n",
        "pnm_p6_binary.ppm": enc(".ppm", bgr),
        "pnm_p6_maxval200_unscaled.ppm": b"P6 31 23 200\n" + np.minimum(bgr[..., ::-1], 200).tobytes(),
        "pam_grayscale.pam": enc(".pam", grey),
        "pam_rgb_cv2.pam": enc(".pam", bgr),
        "pam_rgb_16bit.pam": pam(13, 11, 3, 1000, "RGB", ascii_ppm.astype(">u2").tobytes()),
        "pam_blackandwhite.pam": pam(19, 21, 1, 1, "BLACKANDWHITE",
                                     np.pad(np.packbits(bits, axis=1), ((0, 0), (0, 16))).tobytes()),
        "pfm_rgb_cv2.pfm": enc(".pfm", floats),
        "pfm_grey_big_endian_scale2.pfm": b"Pf\n17 15\n2.0\n" + (floats[::-1, :, 1] * 600).astype(">f4").tobytes(),
        "sun_24bit_cv2.ras": enc(".ras", bgr),
        "sun_8bit_grey_cv2.ras": enc(".ras", grey),
        "sun_1bit.ras": sun_bytes(bits, 1),
        "sun_8bit_colormap.ras": sun_bytes(grey, 8, colormap=cmap),
        "sun_8bit_partial_colormap_old.ras": sun_bytes(grey >> 4, 8, kind=0, colormap=cmap[:, :16]),
        "sun_32bit.ras": sun_bytes(np.concatenate([grey[..., None], picture(19, 27, 3, 24)], -1), 32),
        "hdr_rle_cv2.hdr": enc(".hdr", floats),
        "hdr_rle.hdr": hdr_bytes(rgbe),
        "hdr_flat_rgbe_header.hdr": hdr_bytes(rgbe, rle=False, header=b"#?RGBE\nEXPOSURE=1.0\nFORMAT=32-bit_rle_rgbe\n\n"),
    }


def small_files() -> dict[str, bytes]:
    return {**ccitt_files(), **gif_stills_and_clips(), **raster_files()}


def bench_files() -> dict[str, bytes]:
    from PIL import Image

    m = mask(640, 640, 100)
    frames = [Image.fromarray(cv2.GaussianBlur(picture(640, 640, 1, 101 + i), (0, 0), 2)).quantize(
        16, dither=Image.Dither.NONE) for i in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=100, optimize=False)
    return {"bench_mask640_g4.tif": _pil(m, "TIFF", compression="group4"), "bench_angio640.gif": buf.getvalue()}


def decoded(data: bytes, flag: int) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
    assert img is not None
    return img


def video_frames(data: bytes) -> tuple[list[np.ndarray], dict]:
    """cv2.VideoCapture's frames of a GIF and its FPS, FRAME_COUNT and fourcc."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "clip.gif"
        path.write_bytes(data)
        cap = cv2.VideoCapture(str(path))
        meta = {"fps": cap.get(cv2.CAP_PROP_FPS), "total": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                "fourcc": int(cap.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little").decode("latin-1")}
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
        cap.release()
    return frames, meta


def main() -> None:
    for old in HERE.glob("*"):
        if old.suffix in SUFFIXES:
            old.unlink()
    pixels, clips, meta = {}, {}, {}
    for name, data in small_files().items():
        (HERE / name).write_bytes(data)
        pixels[name] = decoded(data, cv2.IMREAD_COLOR)
        pixels[f"{name}_gray"] = decoded(data, cv2.IMREAD_GRAYSCALE)
        if name.endswith(".gif"):
            frames, meta[name] = video_frames(data)
            clips[name] = np.stack(frames)
    np.savez_compressed(HERE / "pixels.npz", **pixels)
    np.savez_compressed(HERE / "frames.npz", **clips)
    (HERE / "clips.json").write_text(json.dumps(meta, indent=1) + "\n")
    digests = {}
    for name, data in bench_files().items():
        (HERE / name).write_bytes(data)
        digests[name] = {"color": hashlib.sha256(decoded(data, cv2.IMREAD_COLOR).tobytes()).hexdigest(),
                         "gray": hashlib.sha256(decoded(data, cv2.IMREAD_GRAYSCALE).tobytes()).hexdigest()}
        if name.endswith(".gif"):
            frames, clip = video_frames(data)
            digests[name]["frames"] = [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]
            digests[name].update(clip)
    (HERE / "bench.json").write_text(json.dumps(digests, indent=1) + "\n")


if __name__ == "__main__":
    main()
