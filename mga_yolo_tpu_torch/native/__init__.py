"""ctypes bindings of the port's host C++: ``maskops.cpp`` (mask pyramid, PNG
rows, sub-byte samples, Adam7 and 16-bit samples, the port's copy of
``mga_yolo_tpu/native``), ``jpeg.cpp`` (JPEG decoding and encoding, and
MJPEG frames' planes), ``bmp.cpp`` (BMP decoding), ``yuv.cpp`` (video
colour conversion), ``mpeg4.cpp`` (MPEG-4 Part 2 decoding and I-VOP
encoding), ``mpeg12.cpp`` (MPEG-1 and MPEG-2 video decoding),
``msmpeg4.cpp`` (MS MPEG-4 v2 and v3, WMV1 and WMV2 decoding), ``h264.cpp``
(H.264 Baseline, Main and High decoding), ``huffyuv.cpp`` (HuffYUV and
FFVHuff decoding), ``ffv1.cpp`` (FFV1 decoding), ``tiff.cpp``
(TIFF's LZW, PackBits, CCITT fax codes and predictor), ``webp.cpp``
(WebP's VP8L bitstream, and the upsampling of a lossy still), ``vp8.cpp``
(VP8 key and inter frames, for WebM / Matroska video and WebP stills),
``gif.cpp`` (GIF's blocks and LZW, and cv2's GIF encoder) and
``raster.cpp`` (PNM numbers, Radiance HDR scanlines), with
``simple_idct.h``, ``xvid_idct.h``, ``h263.h`` (what ``mpeg4.cpp`` and
``msmpeg4.cpp`` share), ``msmpeg4_tables.h`` and ``h264_tables.h``.

The fifteen sources are compiled at first use, each in a process of its
own and all at once, with ``g++ -O3 -fPIC -std=c++17``, and linked into
``mga_yolo_tpu_torch/_build/libmaskops-<hash>.so``,
keyed by a hash of the sources, and loaded with ctypes. Nothing is built at
import time. The data pipeline and the image codecs have no other path: when
the library cannot be built or loaded, :func:`load` (and so every entry
point) raises RuntimeError with the compiler's or the loader's message. The
numpy twins in ``data/mask_ops.py`` and ``data/image_io.py`` are the oracle
the tests hold the mask ops, PNG rows and TIFF strips equal to; cv2, the
JAX package's decoder, is the codecs' oracle. The codecs hold no global
state, and ctypes releases the GIL around each call, so threads decode at
once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, NamedTuple, Optional

import numpy as np

SOURCE = Path(__file__).with_name("maskops.cpp")
CODEC_SOURCES = tuple(Path(__file__).with_name(f) for f in (
    "jpeg.cpp", "bmp.cpp", "yuv.cpp", "mpeg4.cpp", "mpeg12.cpp", "msmpeg4.cpp", "h264.cpp", "huffyuv.cpp", "ffv1.cpp",
    "tiff.cpp", "webp.cpp", "vp8.cpp", "gif.cpp", "raster.cpp"))
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def sources() -> tuple[Path, ...]:
    return (*CODEC_SOURCES, SOURCE)


HEADERS = tuple(Path(__file__).with_name(f) for f in ("simple_idct.h", "xvid_idct.h", "h263.h", "msmpeg4_tables.h",
                                                       "h264_tables.h"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode()
                       + b"".join(p.read_bytes() for p in (*sources(), *HEADERS))).hexdigest()[:16]
    return BUILD_DIR / f"libmaskops-{h}.so"


def _compile(target: Path) -> Optional[str]:
    """Build the library into ``target``; the compiler's message on failure.
    Each source compiles in a process of its own, all at once, then one link;
    the first source that fails stops the others. A lock file beside the
    target keeps processes that build the same library at once (test workers)
    from building it twice: the later ones wait, then load it."""
    import fcntl
    import shutil
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(target.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():
            return None
        objs = target.with_name(f"{target.stem}.{os.getpid()}.objs")
        objs.mkdir(exist_ok=True)
        try:
            running = []
            for src in sources():
                cmd = ["g++", *(f for f in CXX_FLAGS if f != "-shared"), "-c", str(src), "-o",
                       str(objs / f"{src.stem}.o")]
                running.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            error, start = None, time.monotonic()
            while running and error is None:
                for cmd, proc in list(running):
                    if proc.poll() is None:
                        continue
                    running.remove((cmd, proc))
                    if proc.returncode:
                        error = f"{' '.join(cmd)} failed:\n{proc.stderr.read()}"
                if running and time.monotonic() - start > 300:
                    error = f"{' '.join(running[0][0])} did not finish in 300 s"
                time.sleep(0.02)
            for _, proc in running:
                proc.kill()
                proc.wait()
            if error is not None:
                return error
            tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
            cmd = ["g++", "-shared", *(str(objs / f"{src.stem}.o") for src in sources()), "-o", str(tmp)]
            try:
                subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
            except subprocess.CalledProcessError as e:
                tmp.unlink(missing_ok=True)
                return f"{' '.join(cmd)} failed:\n{e.stderr}"
            os.replace(tmp, target)
            return None
        except (subprocess.SubprocessError, OSError) as e:
            return f"g++ did not run: {e}"
        finally:
            shutil.rmtree(objs, ignore_errors=True)


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed. Raises RuntimeError when
    it cannot be built or loaded (and again on every later call)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is None:
            _lib, _error = _open(library_path())
        if _lib is None:
            names = ", ".join(p.name for p in sources())
            raise RuntimeError(f"the host C++ library of {names} is not available: {_error}")
        return _lib


def _open(target: Path):
    """(library, None), or (None, why it could not be built or loaded)."""
    if not target.exists():
        error = _compile(target)
        if error is not None:
            return None, error
    try:
        lib = ctypes.CDLL(str(target))
    except OSError as e:
        return None, f"loading {target} failed: {e}"
    u8p = ctypes.POINTER(ctypes.c_uint8)
    c = ctypes.c_int
    lib.block_reduce_max_u8.argtypes = [u8p, u8p, c, c, c]
    lib.block_reduce_mean_u8.argtypes = [u8p, ctypes.POINTER(ctypes.c_float), c, c, c]
    lib.zhang_suen_thin_u8.argtypes = [u8p, c, c, c]
    lib.rasterize_edges_u8.argtypes = [ctypes.POINTER(ctypes.c_int32), c, c, u8p, c, c]
    lib.close3x3_u8.argtypes = [u8p, u8p, c, c]
    lib.png_unfilter_u8.argtypes = [u8p, u8p, c, c, c]
    lib.png_unfilter_u8.restype = c
    lib.png_unpack_u8.argtypes = [u8p, u8p, c, c, c, c, c]
    lib.png_adam7_scatter_u8.argtypes = [u8p, c, c, c, c, u8p, c]
    lib.png_strip16_u8.argtypes = [u8p, u8p, ctypes.c_int64]
    lib.png_rgb16_to_gray_u8.argtypes = [u8p, u8p, ctypes.c_int64, c]
    lib.bgr_to_gray_u8.argtypes = [u8p, u8p, ctypes.c_int64, c]
    lib.gray_to_bgr_u8.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
    for fn in ("block_reduce_max_u8", "block_reduce_mean_u8", "zhang_suen_thin_u8",
               "rasterize_edges_u8", "close3x3_u8", "png_unpack_u8", "png_adam7_scatter_u8", "png_strip16_u8",
               "png_rgb16_to_gray_u8", "bgr_to_gray_u8", "gray_to_bgr_u8"):
        getattr(lib, fn).restype = None
    i32p, buf, n64 = ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int64
    for fn in (lib.mga_jpeg_header, lib.mga_bmp_header):
        fn.argtypes = [buf, n64, i32p, buf, c]
        fn.restype = c
    for fn in (lib.mga_jpeg_decode, lib.mga_bmp_decode):
        fn.argtypes = [buf, n64, c, u8p, c, c, buf, c]
        fn.restype = c
    lib.mga_jpeg_encode.argtypes = [u8p, c, c, c, c, u8p, n64, buf, c]
    lib.mga_jpeg_encode.restype = n64
    lib.mga_jpeg_decode_planes.argtypes = [buf, n64, u8p, n64, i32p, buf, c]
    lib.mga_jpeg_decode_planes.restype = n64
    lib.mga_yuv_to_bgr.argtypes = [u8p, c, u8p, u8p, c, c, c, c, c, c, u8p]
    lib.mga_yuv_to_bgr.restype = None
    lib.mga_yuv_to_bgr_scaled.argtypes = [u8p, c, u8p, u8p, c, c, c, c, c, c, c, u8p]
    lib.mga_yuv_to_bgr_scaled.restype = None
    lib.mga_bgr_to_yuv420.argtypes = [u8p, c, c, u8p, u8p, u8p]
    lib.mga_bgr_to_yuv420.restype = None
    lib.mga_mpeg4_decoder_new.argtypes = [ctypes.c_uint32]
    lib.mga_mpeg4_decoder_new.restype = ctypes.c_void_p
    lib.mga_mpeg4_decoder_free.argtypes = [ctypes.c_void_p]
    lib.mga_mpeg4_decoder_free.restype = None
    lib.mga_mpeg4_decode.argtypes = [ctypes.c_void_p, buf, n64, i32p, buf, c]
    lib.mga_mpeg4_decode.restype = c
    lib.mga_mpeg4_frame.argtypes = [ctypes.c_void_p, u8p, u8p, u8p]
    lib.mga_mpeg4_frame.restype = None
    lib.mga_mpeg4_flush.argtypes = [ctypes.c_void_p, i32p]
    lib.mga_mpeg4_flush.restype = c
    lib.mga_mpeg4_tally.argtypes = [ctypes.c_void_p, ctypes.POINTER(n64), c]
    lib.mga_mpeg4_tally.restype = c
    lib.mga_mpeg4_encode_header.argtypes = [c, c, c, u8p, n64, buf, c]
    lib.mga_mpeg4_encode_header.restype = n64
    lib.mga_mpeg4_encode_intra.argtypes = [u8p, u8p, u8p, c, c, c, c, c, c, u8p, n64, buf, c]
    lib.mga_mpeg4_encode_intra.restype = n64
    for fn in (lib.mga_tiff_lzw, lib.mga_tiff_packbits):
        fn.argtypes = [buf, n64, u8p, n64]
        fn.restype = n64
    lib.mga_tiff_predict.argtypes = [u8p, n64, n64, c, c, c]
    lib.mga_tiff_predict.restype = None
    lib.mga_tiff_fax.argtypes = [buf, n64, c, c, n64, n64, u8p, n64, buf, c]
    lib.mga_tiff_fax.restype = c
    lib.mga_gif_header.argtypes = [buf, n64, i32p, u8p, buf, c]
    lib.mga_gif_header.restype = c
    lib.mga_gif_frame.argtypes = [buf, n64, n64, ctypes.POINTER(n64), u8p, u8p, n64, buf, c]
    lib.mga_gif_frame.restype = c
    lib.mga_gif_encode.argtypes = [u8p, c, c, u8p, n64]
    lib.mga_gif_encode.restype = n64
    lib.mga_pnm_numbers.argtypes = [buf, n64, ctypes.POINTER(n64), n64, c, i32p]
    lib.mga_pnm_numbers.restype = c
    lib.mga_hdr_pixels.argtypes = [buf, n64, n64, n64, n64, u8p]
    lib.mga_hdr_pixels.restype = c
    for fn in (lib.mga_webp_vp8l_decode, lib.mga_webp_vp8_decode):
        fn.argtypes = [buf, n64, c, c, u8p, buf, c]
        fn.restype = c
    lib.mga_vp8_new.argtypes = []
    lib.mga_vp8_new.restype = ctypes.c_void_p
    lib.mga_vp8_free.argtypes = [ctypes.c_void_p]
    lib.mga_vp8_free.restype = None
    lib.mga_vp8_decode.argtypes = [ctypes.c_void_p, buf, n64, i32p, buf, c]
    lib.mga_vp8_decode.restype = c
    lib.mga_vp8_planes.argtypes = [ctypes.c_void_p, u8p, u8p, u8p]
    lib.mga_vp8_planes.restype = None
    lib.mga_vp8_tally.argtypes = [ctypes.c_void_p, ctypes.POINTER(n64), c]
    lib.mga_vp8_tally.restype = c
    lib.mga_mpeg12_new.argtypes = []
    lib.mga_mpeg12_new.restype = ctypes.c_void_p
    lib.mga_mpeg12_free.argtypes = [ctypes.c_void_p]
    lib.mga_mpeg12_free.restype = None
    lib.mga_mpeg12_decode.argtypes = [ctypes.c_void_p, buf, n64, buf, c]
    lib.mga_mpeg12_decode.restype = c
    lib.mga_mpeg12_flush.argtypes = [ctypes.c_void_p]
    lib.mga_mpeg12_flush.restype = c
    lib.mga_mpeg12_peek.argtypes = [ctypes.c_void_p, i32p]
    lib.mga_mpeg12_peek.restype = c
    lib.mga_mpeg12_pop.argtypes = [ctypes.c_void_p, u8p, u8p, u8p]
    lib.mga_mpeg12_pop.restype = None
    lib.mga_mpeg12_tally.argtypes = [ctypes.c_void_p, ctypes.POINTER(n64), c]
    lib.mga_mpeg12_tally.restype = c
    lib.mga_msmpeg4_new.argtypes = [c, buf, n64, c, c, buf, c]
    lib.mga_msmpeg4_new.restype = ctypes.c_void_p
    lib.mga_msmpeg4_free.argtypes = [ctypes.c_void_p]
    lib.mga_msmpeg4_free.restype = None
    lib.mga_msmpeg4_decode.argtypes = [ctypes.c_void_p, buf, n64, i32p, buf, c]
    lib.mga_msmpeg4_decode.restype = c
    lib.mga_msmpeg4_frame.argtypes = [ctypes.c_void_p, u8p, u8p, u8p]
    lib.mga_msmpeg4_frame.restype = None
    lib.mga_msmpeg4_tally.argtypes = [ctypes.c_void_p, ctypes.POINTER(n64), c]
    lib.mga_msmpeg4_tally.restype = c
    lib.mga_h264_new.argtypes = [buf, n64, c, c, buf, c]
    lib.mga_h264_new.restype = ctypes.c_void_p
    lib.mga_h264_free.argtypes = [ctypes.c_void_p]
    lib.mga_h264_free.restype = None
    lib.mga_h264_decode.argtypes = [ctypes.c_void_p, buf, n64, buf, c]
    lib.mga_h264_decode.restype = c
    lib.mga_h264_flush.argtypes = [ctypes.c_void_p, buf, c]
    lib.mga_h264_flush.restype = c
    lib.mga_h264_peek.argtypes = [ctypes.c_void_p, i32p]
    lib.mga_h264_peek.restype = c
    lib.mga_h264_pop.argtypes = [ctypes.c_void_p, u8p, u8p, u8p]
    lib.mga_h264_pop.restype = None
    lib.mga_h264_delay.argtypes = [ctypes.c_void_p, c]
    lib.mga_h264_delay.restype = c
    lib.mga_h264_reorder_hint.argtypes = [ctypes.c_void_p]
    lib.mga_h264_reorder_hint.restype = c
    lib.mga_h264_tally.argtypes = [ctypes.c_void_p, ctypes.POINTER(n64), c]
    lib.mga_h264_tally.restype = c
    lib.mga_huffyuv_new.argtypes = [c, buf, n64, c, c, c, i32p, buf, c]
    lib.mga_huffyuv_new.restype = ctypes.c_void_p
    lib.mga_huffyuv_free.argtypes = [ctypes.c_void_p]
    lib.mga_huffyuv_free.restype = None
    lib.mga_huffyuv_decode.argtypes = [ctypes.c_void_p, buf, n64, u8p, u8p, u8p, u8p, buf, c]
    lib.mga_huffyuv_decode.restype = c
    lib.mga_huffyuv_tally.argtypes = [ctypes.c_void_p, ctypes.POINTER(n64), c]
    lib.mga_huffyuv_tally.restype = c
    lib.mga_ffv1_new.argtypes = [buf, n64, c, c, buf, c]
    lib.mga_ffv1_new.restype = ctypes.c_void_p
    lib.mga_ffv1_free.argtypes = [ctypes.c_void_p]
    lib.mga_ffv1_free.restype = None
    lib.mga_ffv1_decode.argtypes = [ctypes.c_void_p, buf, n64, i32p, buf, c]
    lib.mga_ffv1_decode.restype = c
    lib.mga_ffv1_planes.argtypes = [ctypes.c_void_p, u8p, u8p, u8p, u8p]
    lib.mga_ffv1_planes.restype = None
    lib.mga_ffv1_tally.argtypes = [ctypes.c_void_p, ctypes.POINTER(n64), c]
    lib.mga_ffv1_tally.restype = c
    return lib, None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def block_reduce_max(m: np.ndarray, k: int) -> np.ndarray:
    """uint8 max over each k x k block (the last ones ragged)."""
    lib = load()
    m = np.ascontiguousarray(m, np.uint8)
    h, w = m.shape
    out = np.empty((-(-h // k), -(-w // k)), np.uint8)
    lib.block_reduce_max_u8(_u8(m), _u8(out), h, w, k)
    return out


def block_reduce_mean(m: np.ndarray, k: int) -> np.ndarray:
    """float32 share of nonzero pixels in each k x k block, over k * k."""
    lib = load()
    m = np.ascontiguousarray(m, np.uint8)
    h, w = m.shape
    out = np.empty((-(-h // k), -(-w // k)), np.float32)
    lib.block_reduce_mean_u8(_u8(m), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, k)
    return out


def zhang_suen_thin(m: np.ndarray, max_iters: int = 10000) -> np.ndarray:
    """Boolean 1-px skeleton of m > 0."""
    lib = load()
    img = np.ascontiguousarray((m > 0).astype(np.uint8))
    h, w = img.shape
    lib.zhang_suen_thin_u8(_u8(img), h, w, max_iters)
    return img.astype(bool)


def rasterize_edges(edges: np.ndarray, factor: int, out: np.ndarray) -> None:
    """Draw each (y0, x0, y1, x1) edge, divided by ``factor``, into the
    uint8 grid ``out`` as a Bresenham line of 1s (in place)."""
    lib = load()
    edges = np.ascontiguousarray(edges, np.int32)
    out_c = np.ascontiguousarray(out, np.uint8)
    lib.rasterize_edges_u8(edges.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(edges), factor,
                           _u8(out_c), out.shape[0], out.shape[1])
    out[...] = out_c


def close3x3(m: np.ndarray) -> np.ndarray:
    """3x3 binary closing with the image border ignored (cv2 MORPH_CLOSE)."""
    lib = load()
    m = np.ascontiguousarray(m, np.uint8)
    out = np.empty_like(m)
    lib.close3x3_u8(_u8(m), _u8(out), m.shape[0], m.shape[1])
    return out


def png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """(h, stride) uint8 rows from the h * (1 + stride) inflated bytes of a
    PNG image; raises ValueError on a filter type outside 0-4."""
    lib = load()
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, want {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    bad = lib.png_unfilter_u8(_u8(raw), _u8(out), h, stride, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type {int(raw[(bad - 1) * (stride + 1)])}")
    return out


def png_unpack(rows: np.ndarray, n: int, depth: int, scale: int) -> np.ndarray:
    """(h, n) uint8 samples from (h, stride) rows of ``depth``-bit (1, 2, 4)
    samples, high bits first, each times ``scale``."""
    lib = load()
    rows = np.ascontiguousarray(rows, np.uint8)
    h, stride = rows.shape
    if stride * 8 < n * depth or depth not in (1, 2, 4):
        raise ValueError(f"rows of {stride} bytes do not hold {n} samples of {depth} bits")
    out = np.empty((h, n), np.uint8)
    lib.png_unpack_u8(_u8(rows), _u8(out), h, stride, n, depth, scale)
    return out


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
"""Adam7's passes as (x0, y0, dx, dy)."""


def png_adam7_scatter(pixels: np.ndarray, p: int, out: np.ndarray) -> None:
    """Write pass ``p``'s (ph, pw, px) pixels into ``out``, the whole
    (h, w, px) uint8 image, in place."""
    lib = load()
    pixels = np.ascontiguousarray(pixels, np.uint8)
    ph, pw, px = pixels.shape
    x0, y0, dx, dy = ADAM7[p]
    h, w = out.shape[:2]
    if (not out.flags.c_contiguous or out.dtype != np.uint8 or out.shape[2] != px
            or (ph and y0 + (ph - 1) * dy >= h) or (pw and x0 + (pw - 1) * dx >= w)):
        raise ValueError(f"pass {p} of {pixels.shape} does not fit an image of {out.shape}")
    lib.png_adam7_scatter_u8(_u8(pixels), pw, ph, p, px, _u8(out), w)


def png_strip16(samples: np.ndarray) -> np.ndarray:
    """The high byte of each big-endian 16-bit sample: (..., 2n) -> (..., n)."""
    lib = load()
    samples = np.ascontiguousarray(samples, np.uint8)
    out = np.empty(samples.shape[:-1] + (samples.shape[-1] // 2,), np.uint8)
    lib.png_strip16_u8(_u8(samples), _u8(out), out.size)
    return out


def png_rgb16_to_gray(pixels: np.ndarray) -> np.ndarray:
    """(h, w) grey from (h, w, 6 or 8) big-endian RGB(A) 16-bit pixels,
    libpng's conversion at 16 bits, then the high byte."""
    lib = load()
    pixels = np.ascontiguousarray(pixels, np.uint8)
    if pixels.ndim != 3 or pixels.shape[2] not in (6, 8):
        raise ValueError(f"want (h, w, 6 or 8) pixels, got {pixels.shape}")
    out = np.empty(pixels.shape[:2], np.uint8)
    lib.png_rgb16_to_gray_u8(_u8(pixels), _u8(out), out.size, pixels.shape[2] // 2)
    return out


GRAY_WEIGHTS = {"cvtcolor": 0, "tiff": 1, "libpng": 2}


def bgr_to_gray(bgr: np.ndarray, weights: str) -> np.ndarray:
    """(h, w) grey from (h, w, 3) BGR uint8 with one of cv2's conversions'
    weights (``GRAY_WEIGHTS``)."""
    lib = load()
    bgr = np.ascontiguousarray(bgr, np.uint8)
    if bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f"want (h, w, 3) BGR, got {bgr.shape}")
    out = np.empty(bgr.shape[:2], np.uint8)
    lib.bgr_to_gray_u8(_u8(bgr), _u8(out), out.size, GRAY_WEIGHTS[weights])
    return out


def gray_to_bgr(img: np.ndarray) -> np.ndarray:
    """(h, w, 3) with the first sample of each pixel of (h, w, c) uint8 in B, G and R."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty(img.shape[:2] + (3,), np.uint8)
    lib.gray_to_bgr_u8(_u8(img), img.shape[2] if img.ndim == 3 else 1, _u8(out), out.size // 3)
    return out


_ERR_LEN = 256


def _header(fn, data: bytes) -> list[int]:
    err = ctypes.create_string_buffer(_ERR_LEN)
    info = (ctypes.c_int32 * 5)()
    if fn(data, len(data), info, err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return list(info)


def _decode(header, decode, data: bytes, gray: bool) -> np.ndarray:
    h, w = _header(header, data)[:2]
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if decode(data, len(data), int(gray), _u8(out), h, w, err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return out


def jpeg_decode(data: bytes, gray: bool = False) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) BGR or, with ``gray``, (H, W) uint8, as
    ``cv2.imdecode`` with IMREAD_COLOR / IMREAD_GRAYSCALE (EXIF orientation
    applied). Raises ValueError with the reason for what it does not read."""
    lib = load()
    return _decode(lib.mga_jpeg_header, lib.mga_jpeg_decode, bytes(data), gray)


def jpeg_header(data: bytes) -> dict:
    """Height and width as decoded (after the EXIF orientation), components,
    EXIF orientation (0 when absent) and whether the frame is progressive."""
    h, w, c, orientation, progressive = _header(load().mga_jpeg_header, bytes(data))
    return {"height": h, "width": w, "components": c, "orientation": orientation, "progressive": bool(progressive)}


def _grow(call, cap: int) -> bytes:
    """The bytes of an encoder entry that returns its size, called again with room when short."""
    err = ctypes.create_string_buffer(_ERR_LEN)
    while True:
        out = np.empty(cap, np.uint8)
        n = call(out, cap, err)
        if n < 0:
            raise ValueError(err.value.decode())
        if n <= cap:
            return out[:n].tobytes()
        cap = n


def jpeg_encode(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W) grey or (H, W, 3) BGR uint8 -> baseline JPEG bytes, as
    ``cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])``."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    return _grow(lambda out, cap, err: lib.mga_jpeg_encode(_u8(img), h, w, c, int(quality), _u8(out), cap, err,
                                                           _ERR_LEN), img.size + 4096)


def jpeg_decode_planes(data: bytes) -> tuple[list[np.ndarray], dict]:
    """JPEG bytes -> the component planes as ffmpeg's MJPEG decoder makes
    them (its simple IDCT), each (rows, cols) uint8 at its own sampled size
    (no upsampling, colour conversion or EXIF orientation), and
    {"height", "width", "rgb", "sampling": [(h, v), ...]}."""
    lib = load()
    data = bytes(data)
    h, w = _header(lib.mga_jpeg_header, data)[:2]
    cap = 3 * h * w
    out = np.empty(cap, np.uint8)
    info = (ctypes.c_int32 * 16)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    n = lib.mga_jpeg_decode_planes(data, len(data), _u8(out), cap, info, err, _ERR_LEN)
    if n < 0:
        raise ValueError(err.value.decode())
    planes, off = [], 0
    for i in range(info[2]):
        rows, cols = info[4 + 4 * i], info[5 + 4 * i]
        planes.append(out[off:off + rows * cols].reshape(rows, cols))
        off += rows * cols
    meta = {"height": info[0], "width": info[1], "rgb": bool(info[3]),
            "sampling": [(info[6 + 4 * i], info[7 + 4 * i]) for i in range(info[2])]}
    return planes, meta


def yuv_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray, full_range: bool,
               chroma_left: bool = False, subsampling: Optional[tuple[int, int]] = None) -> np.ndarray:
    """(H, W, 3) BGR uint8 from a luma plane and two chroma planes of half
    (4:2:0) or half-width (4:2:2) or equal size (4:4:4), as cv2.VideoCapture
    converts a frame (BT.601; JPEG's range when ``full_range``, else
    limited): swscale's unscaled yuv2rgb, chroma replicated, for 4:2:0 and
    4:2:2 frames of even height; its scaled path for those of odd height, their
    chroma upsampled from where the codec sites it (``chroma_left``: MPEG-2,
    MPEG-4 and H.264 with a VUI; centred: MPEG-1, VP8, JPEG, H.264 without
    one), frames of 1 to 7 rows through its yuv2packed1 stage; and its full
    chroma stage for 4:4:4. ``subsampling`` is (log2 horizontal, log2
    vertical) of the chroma, which a frame one sample wide needs; else it is
    told by the planes' sizes (one sample wide: 4:2:2, or 4:2:0 where the
    height says so)."""
    lib = load()
    y, u, v = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
    h, w = y.shape
    if u.shape != v.shape:
        raise ValueError(f"chroma planes of {u.shape} and {v.shape}")
    if subsampling is None:
        sy = 0 if u.shape[0] == h else 1
        sx = 0 if u.shape[1] == w and w > 1 else 1
    else:
        sx, sy = subsampling
    if (sx, sy) not in ((0, 0), (1, 0), (1, 1)) or u.shape != (-(-h // (1 << sy)), -(-w // (1 << sx))):
        raise ValueError(f"chroma planes of {u.shape} for luma of {y.shape}")
    out = np.empty((h, w, 3), np.uint8)
    if h & 1 or not sx:  # odd heights and 4:4:4 take swscale's scaled path
        lib.mga_yuv_to_bgr_scaled(_u8(y), w, _u8(u), _u8(v), u.shape[1], h, w, sx, sy, int(chroma_left),
                                  int(full_range), _u8(out))
    else:
        lib.mga_yuv_to_bgr(_u8(y), w, _u8(u), _u8(v), u.shape[1], h, w, sx, sy, int(full_range), _u8(out))
    return out


def bgr_to_yuv420(img: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H, W, 3) BGR uint8, H and W even -> limited-range BT.601 planes y
    (H, W), u and v (H/2, W/2), chroma the mean of each 2x2 block."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    if img.ndim != 3 or img.shape[2] != 3 or h % 2 or w % 2:
        raise ValueError(f"want an (H, W, 3) image of even sizes, got {img.shape}")
    y = np.empty((h, w), np.uint8)
    u = np.empty((h // 2, w // 2), np.uint8)
    v = np.empty_like(u)
    lib.mga_bgr_to_yuv420(_u8(img), h, w, _u8(y), _u8(u), _u8(v))
    return y, u, v


# what an Mpeg4Decoder counts (mpeg4.cpp's Tally, in its order)
MPEG4_TALLY = ("vops_i", "vops_p", "vops_b", "vops_uncoded", "b_dropped", "b_skipped_times", "mb_intra", "mb_inter",
               "mb_inter4v", "mb_not_coded", "mb_field_mv", "mb_field_dct", "b_direct", "b_direct_skip", "b_forward",
               "b_backward", "b_interpolated", "b_colocated_skip", "b_direct_8x8", "b_direct_field", "qpel_vops",
               "mpeg_quant_vops", "loaded_intra", "loaded_inter", "partitioned_vops", "video_packets",
               "alternate_scan_vops", "interlaced_vops", "packed_stored", "packed_decoded", "nvops_skipped",
               "xvid_idct_vops", "edge_bug_vops", "dc_clip_bug_vops", "qpel_chroma_bug_vops",
               "mismatch_toggles", "escapes_3", "flushed")


class Mpeg4Decoder:
    """An MPEG-4 Part 2 (Simple and Advanced Simple profile) decoder
    (``mpeg4.cpp``): feed it the stream's chunks in order (the container's
    decoder configuration first, where it has one), then :meth:`flush` at
    the end. Frames come out in display order, as libavcodec gives them: a
    stream with B-VOPs one chunk late. ``fourcc`` is the container's codec
    tag (AVI's, a Matroska VfW track's; none for MP4, Matroska's own IDs and
    MPEG-PS), which names the encoder of a stream whose user data does not,
    as ffmpeg reads it (``XVID`` switches to the XviD IDCT). Holds its
    reference frames; :meth:`close` frees them."""

    def __init__(self, fourcc: bytes = b""):
        self._lib = load()
        tag = bytes(fourcc[:4]).upper().ljust(4, b"\0") if fourcc else b"\0" * 4
        self._h = self._lib.mga_mpeg4_decoder_new(int.from_bytes(tag, "little"))
        if not self._h:
            raise MemoryError("MPEG-4 decoder")

    def _frame(self, info):
        w, h = info[0], info[1]
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.mga_mpeg4_frame(self._h, _u8(y), _u8(u), _u8(v))
        return (y, u, v), info[2]

    def decode(self, chunk: bytes):
        """(y, u, v) planes and the VOP type (0 I, 1 P, 2 B) of the frame that
        comes out after the chunk, or None when none does (headers only, an
        uncoded VOP, a B-VOP before two references, or the first reference
        of a stream with B-VOPs), as in ffmpeg. Raises ValueError naming what
        it does not decode."""
        if not self._h:
            raise ValueError("the MPEG-4 decoder is closed")
        chunk = bytes(chunk)
        info = (ctypes.c_int32 * 3)()
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self._lib.mga_mpeg4_decode(self._h, chunk, len(chunk), info, err, _ERR_LEN)
        if rc < 0:
            raise ValueError(err.value.decode())
        return self._frame(info) if rc else None

    def flush(self):
        """The frame left at the end of the stream (the last reference of a
        stream with B-VOPs), as decode gives it, or None."""
        if not self._h:
            raise ValueError("the MPEG-4 decoder is closed")
        info = (ctypes.c_int32 * 3)()
        return self._frame(info) if self._lib.mga_mpeg4_flush(self._h, info) else None

    def tally(self) -> dict:
        """The features decoded so far, counted (``MPEG4_TALLY``'s names)."""
        out = (ctypes.c_int64 * len(MPEG4_TALLY))()
        self._lib.mga_mpeg4_tally(self._h, out, len(MPEG4_TALLY))
        return dict(zip(MPEG4_TALLY, out))

    def close(self) -> None:
        if self._h:
            self._lib.mga_mpeg4_decoder_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


# what a Vp8Decoder counts (vp8.cpp's Tally, in its order)
VP8_TALLY = ("frames", "key_frames", "inter_frames", "hidden_frames", "intra16_in_inter", "bpred_in_inter", "zero_mv",
             "nearest_mv", "near_mv", "new_mv", "split_16x8", "split_8x16", "split_8x8", "split_4x4", "ref_last",
             "ref_golden", "ref_altref", "sign_bias_flips", "golden_refreshes", "altref_refreshes", "golden_copies",
             "altref_copies", "entropy_saves", "no_refresh_last", "segmented_frames", "segment_map_updates",
             "partitioned_frames", "subpel_sixtap", "subpel_bilinear", "edge_emulated", "mv_clamped", "mv_long",
             "lf_delta_frames", "inner_edges_skipped", "mode_prob_updates", "mv_prob_updates", "simple_filter_frames",
             "submv_left", "submv_above", "submv_zero", "submv_new", "golden_sign_bias", "altref_sign_bias",
             "full_pixel_frames")


class Vp8Decoder:
    """A VP8 decoder (``vp8.cpp``) for a WebM / Matroska track: feed it the
    track's blocks in order. Holds its reference frames; :meth:`close` frees
    them."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.mga_vp8_new()
        if not self._h:
            raise MemoryError("VP8 decoder")

    def decode(self, frame: bytes):
        """(y, u, v) planes (cropped to the frame's size, chroma
        ((h + 1) // 2, (w + 1) // 2)) and whether it is a key frame, or None
        for a frame that is not shown (an alt-ref). Raises ValueError naming
        what is wrong with a cut or corrupt frame."""
        if not self._h:
            raise ValueError("the VP8 decoder is closed")
        frame = bytes(frame)
        info = (ctypes.c_int32 * 3)()
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self._lib.mga_vp8_decode(self._h, frame, len(frame), info, err, _ERR_LEN)
        if rc < 0:
            raise ValueError(err.value.decode())
        if rc == 0:
            return None
        w, h = info[0], info[1]
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.mga_vp8_planes(self._h, _u8(y), _u8(u), _u8(v))
        return (y, u, v), bool(info[2])

    def tally(self) -> dict:
        """The features decoded so far, counted (``VP8_TALLY``'s names)."""
        out = (ctypes.c_int64 * len(VP8_TALLY))()
        self._lib.mga_vp8_tally(self._h, out, len(VP8_TALLY))
        return dict(zip(VP8_TALLY, out))

    def close(self) -> None:
        if self._h:
            self._lib.mga_vp8_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


# what an Mpeg12Decoder counts (mpeg12.cpp's Tally, in its order)
MPEG12_TALLY = ("pictures_i", "pictures_p", "pictures_b", "mpeg1_pictures", "mpeg2_pictures", "mb_intra",
                "mb_intra_in_p_b", "mb_skipped_p", "mb_skipped_b", "mb_forward", "mb_backward", "mb_interpolated",
                "mb_no_mc", "mb_quant", "frame_pred", "field_pred", "field_dct", "halfpel_vectors",
                "full_pel_pictures", "escapes", "escapes_long", "mismatch_toggles", "loaded_intra", "loaded_non_intra",
                "quant_matrix_ext", "dc_precision_9", "dc_precision_10", "dc_precision_11", "intra_vlc_pictures",
                "alternate_scan_pictures", "non_linear_q_pictures", "concealment_pictures", "chroma_422_pictures",
                "interlaced_sequences", "open_gops", "closed_gops", "reordered", "dropped_b", "slices", "mv_wraps")


class Mpeg12Decoder:
    """An MPEG-1 / MPEG-2 video decoder (``mpeg12.cpp``): feed it the
    stream's chunks in order, each holding whole pictures (a container's
    packets, or a program stream's joined payloads), then :meth:`flush` at
    the end. Frames come out in display order, as libavcodec gives them.
    Holds its reference frames; :meth:`close` frees them."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.mga_mpeg12_new()
        if not self._h:
            raise MemoryError("MPEG-1/2 decoder")

    def _ready(self) -> list:
        out = []
        info = (ctypes.c_int32 * 5)()
        while self._lib.mga_mpeg12_peek(self._h, info):
            w, h, cw, ch, kind = list(info)
            y = np.empty((h, w), np.uint8)
            u = np.empty((ch, cw), np.uint8)
            v = np.empty_like(u)
            self._lib.mga_mpeg12_pop(self._h, _u8(y), _u8(u), _u8(v))
            out.append(((y, u, v), kind))
        return out

    def decode(self, chunk: bytes) -> list:
        """The frames ready after the chunk: ((y, u, v), picture type 1 I,
        2 P, 3 B) each, chroma at 4:2:0 or 4:2:2. Raises ValueError naming
        what it does not decode."""
        if not self._h:
            raise ValueError("the MPEG-1/2 decoder is closed")
        chunk = bytes(chunk)
        err = ctypes.create_string_buffer(_ERR_LEN)
        if self._lib.mga_mpeg12_decode(self._h, chunk, len(chunk), err, _ERR_LEN) < 0:
            raise ValueError(err.value.decode())
        return self._ready()

    def flush(self) -> list:
        """The frames left at the end of the stream (the last reference picture)."""
        if not self._h:
            raise ValueError("the MPEG-1/2 decoder is closed")
        self._lib.mga_mpeg12_flush(self._h)
        return self._ready()

    def tally(self) -> dict:
        """The features decoded so far, counted (``MPEG12_TALLY``'s names)."""
        out = (ctypes.c_int64 * len(MPEG12_TALLY))()
        self._lib.mga_mpeg12_tally(self._h, out, len(MPEG12_TALLY))
        return dict(zip(MPEG12_TALLY, out))

    def close(self) -> None:
        if self._h:
            self._lib.mga_mpeg12_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


# what an MsMpeg4Decoder counts (msmpeg4.cpp's Tally, in its order)
MSMPEG4_TALLY = ("pictures_i", "pictures_p", "mb_intra", "mb_intra_in_p", "mb_inter", "mb_skipped", "blocks_table_0",
                 "blocks_table_1", "blocks_table_2", "blocks_table_3", "blocks_table_4", "blocks_table_5",
                 "escapes_1", "escapes_2", "escapes_3", "esc3_lengths_low_q", "esc3_lengths_high_q", "dc_escapes",
                 "mv_escapes", "inter_intra_mbs", "no_rounding_pictures", "cbp_table_0", "cbp_table_1",
                 "cbp_table_2", "loop_filter_pictures")
# the MS-MPEG-4 family's fourccs as libavformat's RIFF tags name them (compared in upper case), by version
MSMPEG4_VERSIONS = {b"MP42": 2, b"DIV2": 2, b"MP43": 3, b"DIV3": 3, b"MPG3": 3, b"DIV4": 3, b"DIV5": 3, b"DIV6": 3,
                    b"DVX3": 3, b"AP41": 3, b"COL1": 3, b"WMV1": 4, b"WMV2": 5}
MSMPEG4_NAMES = {2: "MS MPEG-4 v2", 3: "MS MPEG-4 v3", 4: "WMV1", 5: "WMV2"}


class MsMpeg4Decoder:
    """A decoder of the MS-MPEG-4 family (``msmpeg4.cpp``: MS MPEG-4 v2 and
    v3, WMV1, WMV2) for a stream under the container's ``fourcc`` (one of
    ``MSMPEG4_VERSIONS``), its ``extradata`` (WMV2's header) and its picture
    ``size`` (width, height), which the streams do not carry. Feed it the
    stream's chunks in order, a picture each; every picture comes out at once
    (no reordering), so :meth:`flush` has none. Raises ValueError naming what
    it does not decode. Holds its frames; :meth:`close` frees them."""

    def __init__(self, fourcc: bytes, extradata: bytes, size: tuple[int, int]):
        self._h = None
        self._lib = load()
        version = MSMPEG4_VERSIONS.get(bytes(fourcc[:4]).upper())
        if version is None:
            raise ValueError(f"'{bytes(fourcc).decode('latin-1')}' is not a fourcc of the MS-MPEG-4 family")
        extradata = bytes(extradata)
        err = ctypes.create_string_buffer(_ERR_LEN)
        self._h = self._lib.mga_msmpeg4_new(version, extradata, len(extradata), int(size[0]), int(size[1]), err,
                                            _ERR_LEN)
        if not self._h:
            raise ValueError(err.value.decode())
        self.version = version

    def decode(self, chunk: bytes):
        """(y, u, v) planes and the picture type (0 I, 1 P) of the chunk's
        picture, or None for an empty chunk (a dropped frame)."""
        if not self._h:
            raise ValueError("the MS-MPEG-4 decoder is closed")
        chunk = bytes(chunk)
        info = (ctypes.c_int32 * 3)()
        err = ctypes.create_string_buffer(_ERR_LEN)
        rc = self._lib.mga_msmpeg4_decode(self._h, chunk, len(chunk), info, err, _ERR_LEN)
        if rc < 0:
            raise ValueError(err.value.decode())
        if rc == 0:
            return None
        w, h = info[0], info[1]
        y = np.empty((h, w), np.uint8)
        u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = np.empty_like(u)
        self._lib.mga_msmpeg4_frame(self._h, _u8(y), _u8(u), _u8(v))
        return (y, u, v), info[2]

    def flush(self):
        """None: the family has no reordering, so nothing is left at the end."""
        return None

    def tally(self) -> dict:
        """The features decoded so far, counted (``MSMPEG4_TALLY``'s names)."""
        out = (ctypes.c_int64 * len(MSMPEG4_TALLY))()
        self._lib.mga_msmpeg4_tally(self._h, out, len(MSMPEG4_TALLY))
        return dict(zip(MSMPEG4_TALLY, out))

    def close(self) -> None:
        if self._h:
            self._lib.mga_msmpeg4_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


# what an H264Decoder counts (h264.cpp's Tally, in its order)
H264_TALLY = ("pictures_idr", "pictures_i", "pictures_p", "pictures_non_ref", "slices", "multi_slice_pictures",
              "annex_b", "nal_length_1", "nal_length_2", "nal_length_4", "emulation_prevention", "nal_skipped",
              "profile_66", "profile_77", "profile_100", "poc_type_0", "poc_type_1", "poc_type_2", "cropped",
              "full_range", "mb_i4x4", "mb_i16x16", "mb_pcm", "mb_intra_in_p", "mb_p16x16", "mb_p16x8", "mb_p8x16",
              "mb_p8x8", "mb_p8x8ref0", "mb_skip", "sub_8x8", "sub_8x4", "sub_4x8", "sub_4x4",
              *(f"i4x4_mode_{k}" for k in range(9)), *(f"i16x16_mode_{k}" for k in range(4)),
              *(f"i16x16_cbp_chroma_{k}" for k in range(3)), "i16x16_ac", *(f"chroma_mode_{k}" for k in range(4)),
              "qp_delta", *(f"coeff_token_{k}" for k in range(4)), "coeff_token_chroma_dc",
              *(f"suffix_length_{k}" for k in range(7)), "level_prefix_14", "level_prefix_15", "total_zeros",
              "run_before_long", "luma_dc", "chroma_dc", "chroma_ac", "mv_median", "mv_16x8", "mv_8x16", "skip_zero",
              "skip_predicted", "luma_full", "luma_half", "luma_quarter", "chroma_fraction", "mc_off_picture",
              "ref_idx_nonzero", "long_term_refs", "list_mod_0", "list_mod_1", "list_mod_2", "sliding_window",
              *(f"mmco_{k}" for k in range(1, 7)), "idr_long_term", *(f"deblock_idc_{k}" for k in range(3)),
              "deblock_offsets", "bs_1", "bs_2", "bs_3", "bs_4", "constrained_intra",
              # the Main and High profiles' tools
              "pictures_b", "pictures_b_ref", "cabac_slices", *(f"cabac_init_{k}" for k in range(3)), "cabac_pcm",
              "cabac_coeff_escape", "mb_b_direct16x16", "mb_b_skip", "mb_b16x16", "mb_b16x8", "mb_b8x16", "mb_b8x8",
              "mb_intra_in_b", "pred_l0", "pred_l1", "pred_bi", "sub_b_direct", "sub_b8x8", "sub_b8x4", "sub_b4x8",
              "sub_b4x4", "direct_spatial", "direct_temporal", "direct_zero_refs", "direct_col_zero",
              "direct_long_term", "direct_no_inference", "weights_explicit_p", "weights_explicit_b",
              "weights_implicit", "weights_implicit_default", "weights_same_picture", "list_swap", "list_mod_l1",
              "transform_8x8", "mb_i8x8", *(f"i8x8_mode_{k}" for k in range(9)), "scaling_sps", "scaling_pps",
              "scaling_sent", "scaling_default", "scaling_fallback_a", "scaling_fallback_b", "deblock_8x8_coded",
              "luma_dc_coarse")


class H264Decoder:
    """An H.264 decoder (``h264.cpp``: the progressive 8-bit 4:2:0 tools of the
    Baseline, Main and High profiles, CAVLC or CABAC, I, P and B slices; see its top) for
    a stream with ``extradata`` (an avcC record, whose NAL length size the
    samples then use; parameter sets with start codes; or nothing, for
    samples with start codes) in a container that gives its picture ``size``
    (width, height; (0, 0) for none), which replaces the SPS's cropped size
    as in libavcodec. Feed it the samples in order, an access unit each, then
    :meth:`flush`; frames come out in libavcodec's output order, cropped as
    cv2 crops them. Raises ValueError naming what it does not decode. Holds
    its reference frames; :meth:`close` frees them."""

    def __init__(self, extradata: bytes = b"", size: tuple[int, int] = (0, 0)):
        self._h = None
        self._lib = load()
        extradata = bytes(extradata)
        err = ctypes.create_string_buffer(_ERR_LEN)
        self._h = self._lib.mga_h264_new(extradata, len(extradata), int(size[0]), int(size[1]), err, _ERR_LEN)
        if not self._h:
            raise ValueError(err.value.decode())

    def _ready(self) -> list:
        out = []
        info = (ctypes.c_int32 * 8)()
        while self._lib.mga_h264_peek(self._h, info):
            w, h, cw, ch, full, kind, key, loc = list(info)
            y = np.empty((h, w), np.uint8)
            u = np.empty((ch, cw), np.uint8)
            v = np.empty_like(u)
            self._lib.mga_h264_pop(self._h, _u8(y), _u8(u), _u8(v))
            out.append(((y, u, v), {"full_range": bool(full), "type": kind, "key": bool(key), "chroma_location": loc}))
        return out

    def decode(self, chunk: bytes) -> list:
        """The frames ready after the sample: ((y, u, v), info) each, info
        the picture's ``full_range`` (the VUI's flag), ``type`` (1 I, 2 P, 3 B),
        ``key`` (an IDR picture) and ``chroma_location`` (libavcodec's
        AVChromaLocation from the VUI: 0 unspecified when the SPS has none,
        1 left when it has one without chroma_loc_info, else the type + 1)."""
        if not self._h:
            raise ValueError("the H.264 decoder is closed")
        chunk = bytes(chunk)
        err = ctypes.create_string_buffer(_ERR_LEN)
        if self._lib.mga_h264_decode(self._h, chunk, len(chunk), err, _ERR_LEN) < 0:
            raise ValueError(err.value.decode())
        return self._ready()

    def flush(self) -> list:
        """The frames left at the end of the stream."""
        if not self._h:
            raise ValueError("the H.264 decoder is closed")
        err = ctypes.create_string_buffer(_ERR_LEN)
        if self._lib.mga_h264_flush(self._h, err, _ERR_LEN) < 0:
            raise ValueError(err.value.decode())
        return self._ready()

    @property
    def delay(self) -> int:
        """The output rule's delay, libavcodec's has_b_frames: the pictures held back for reordering."""
        return self._lib.mga_h264_delay(self._h, -1)

    @delay.setter
    def delay(self, n: int) -> None:
        self._lib.mga_h264_delay(self._h, int(n))

    @property
    def reorder_hint(self) -> int:
        """The active SPS's num_reorder_frames as libavcodec keeps it: the VUI's
        bitstream restriction, else the level's DPB size over the picture's
        macroblocks (at most 15); -1 before a picture."""
        return self._lib.mga_h264_reorder_hint(self._h)

    def tally(self) -> dict:
        """The tools decoded so far, counted (``H264_TALLY``'s names)."""
        out = (ctypes.c_int64 * len(H264_TALLY))()
        n = self._lib.mga_h264_tally(self._h, out, len(H264_TALLY))
        if n != len(H264_TALLY):
            raise RuntimeError(f"h264.cpp counts {n} tools, H264_TALLY names {len(H264_TALLY)}")
        return dict(zip(H264_TALLY, out))

    def close(self) -> None:
        if self._h:
            self._lib.mga_h264_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


# what a HuffyuvDecoder counts (huffyuv.cpp's Tally, in its order)
HUFFYUV_TALLY = ("frames", "huffyuv", "ffvhuff", "v1_classic_tables", "v2", "v3", "pred_left", "pred_plane",
                 "pred_median", "decorrelate", "interlaced", "per_frame_tables", "yuv422", "yuv420", "rgb24", "rgb32",
                 "gray", "yuv444", "yuva", "gbrp", "odd_width", "long_codes")
# a decoded frame's layout by huffyuv.cpp's format number: pixel format, chroma (log2 horizontal, vertical) or None
HUFFYUV_FORMATS = {0: ("yuv422p", (1, 0)), 1: ("yuv420p", (1, 1)), 2: ("bgr0", None), 3: ("bgra", None),
                   4: ("gray", None), 5: ("yuv444p", (0, 0)), 6: ("gbrp", None), 7: ("yuva420p", (1, 1)),
                   8: ("yuva422p", (1, 0)), 9: ("yuva444p", (0, 0))}


def planes_to_bgr(pix_fmt: str, planes: list, subsampling: Optional[tuple[int, int]] = None) -> np.ndarray:
    """(H, W, 3) BGR uint8 of a lossless codec's decoded planes as cv2 turns
    them into BGR24 with swscale (each measured against libswscale): grey
    copied into B, G and R (swscale takes grey as full range), packed BGR0 /
    BGRA and planar GBR copied, YUV (alpha dropped) through
    :func:`yuv_to_bgr` in limited range, its chroma centred."""
    if pix_fmt == "gray":
        return gray_to_bgr(planes[0])
    if pix_fmt in ("bgr0", "bgra"):
        h = planes[0].shape[0]
        return np.ascontiguousarray(planes[0].reshape(h, -1, 4)[:, :, :3])
    if pix_fmt == "gbrp":
        return np.stack([planes[1], planes[0], planes[2]], axis=2)
    return yuv_to_bgr(planes[0], planes[1], planes[2], full_range=False, subsampling=subsampling)


class HuffyuvDecoder:
    """A HuffYUV or FFVHuff decoder (``huffyuv.cpp``, libavcodec's
    huffyuvdec.c: versions 1 to 3, the left, plane and median predictors,
    interlacing, decorrelated RGB, per-frame tables; 8 bits a sample) for a
    stream of ``size`` (width, height) with the container's ``extradata`` and
    ``bits_per_coded_sample`` (biBitCount, or an MP4 sample entry's depth).
    Every frame is a key frame. Raises ValueError naming what it does not
    decode, and on a cut or corrupt frame."""

    def __init__(self, ffvhuff: bool, extradata: bytes, bits_per_coded_sample: int, size: tuple[int, int]):
        self._h = None
        self._lib = load()
        extradata = bytes(extradata)
        info = (ctypes.c_int32 * 9)()
        err = ctypes.create_string_buffer(_ERR_LEN)
        self._h = self._lib.mga_huffyuv_new(int(ffvhuff), extradata, len(extradata), int(bits_per_coded_sample),
                                            int(size[0]), int(size[1]), info, err, _ERR_LEN)
        if not self._h:
            raise ValueError(err.value.decode())
        self.pix_fmt, self.subsampling = HUFFYUV_FORMATS[info[0]]
        self._shapes = [(info[2 + 2 * p], info[1 + 2 * p]) for p in range(4) if info[1 + 2 * p]]

    def decode(self, chunk: bytes) -> list:
        """The frame's planes (uint8, as :func:`planes_to_bgr` takes them)."""
        if not self._h:
            raise ValueError("the HuffYUV decoder is closed")
        chunk = bytes(chunk)
        planes = [np.empty(s, np.uint8) for s in self._shapes]
        ptrs = [_u8(p) for p in planes] + [None] * (4 - len(planes))
        err = ctypes.create_string_buffer(_ERR_LEN)
        if self._lib.mga_huffyuv_decode(self._h, chunk, len(chunk), *ptrs, err, _ERR_LEN) < 0:
            raise ValueError(err.value.decode())
        return planes

    def tally(self) -> dict:
        """The tools decoded so far, counted (``HUFFYUV_TALLY``'s names)."""
        out = (ctypes.c_int64 * len(HUFFYUV_TALLY))()
        n = self._lib.mga_huffyuv_tally(self._h, out, len(HUFFYUV_TALLY))
        if n != len(HUFFYUV_TALLY):
            raise RuntimeError(f"huffyuv.cpp counts {n} tools, HUFFYUV_TALLY names {len(HUFFYUV_TALLY)}")
        return dict(zip(HUFFYUV_TALLY, out))

    def close(self) -> None:
        if self._h:
            self._lib.mga_huffyuv_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


# what an Ffv1Decoder counts (ffv1.cpp's Tally, in its order)
FFV1_TALLY = ("frames", "key_frames", "non_key_frames", "version_0", "version_1", "version_3", "golomb_rice",
              "range_default", "range_custom", "initial_states", "multi_slice", "slice_crc", "gray", "yuv420",
              "yuv422", "yuv444", "alpha", "rgb", "runs", "run_breaks", "golomb_escape", "five_input_contexts",
              "odd_size")
# a decoded frame's layout by ffv1.cpp's format number: pixel format, chroma (log2 horizontal, vertical) or None
FFV1_FORMATS = {0: ("gray", None), 1: ("yuv420p", (1, 1)), 2: ("yuv422p", (1, 0)), 3: ("yuv444p", (0, 0)),
                4: ("yuva420p", (1, 1)), 5: ("yuva422p", (1, 0)), 6: ("yuva444p", (0, 0)), 7: ("bgr0", None),
                8: ("bgra", None)}


class Ffv1Decoder:
    """An FFV1 decoder (``ffv1.cpp``, RFC 9043 as libavcodec's ffv1dec.c
    decodes it: versions 0, 1 and 3, 8 bits a sample, Golomb-Rice or range
    coding with the default or a custom state table, slices with their CRCs,
    grey, YUV 4:2:0 / 4:2:2 / 4:4:4 with or without alpha, RGB by the JPEG
    2000 RCT) for a stream of ``size`` (width, height) with the container's
    ``extradata`` (version 3's configuration record; none for versions 0 and
    1). Feed it the frames in order: a non-key frame keeps the contexts of
    the frames before it. Raises ValueError naming what it does not decode,
    and on a cut or corrupt frame."""

    def __init__(self, extradata: bytes, size: tuple[int, int]):
        self._h = None
        self._lib = load()
        extradata = bytes(extradata)
        err = ctypes.create_string_buffer(_ERR_LEN)
        self._h = self._lib.mga_ffv1_new(extradata, len(extradata), int(size[0]), int(size[1]), err, _ERR_LEN)
        if not self._h:
            raise ValueError(err.value.decode())
        self.pix_fmt, self.subsampling = None, None

    def decode(self, chunk: bytes) -> list:
        """The frame's planes (uint8, as :func:`planes_to_bgr` takes them, in
        the format ``pix_fmt`` then names)."""
        if not self._h:
            raise ValueError("the FFV1 decoder is closed")
        chunk = bytes(chunk)
        info = (ctypes.c_int32 * 8)()
        err = ctypes.create_string_buffer(_ERR_LEN)
        fmt = self._lib.mga_ffv1_decode(self._h, chunk, len(chunk), info, err, _ERR_LEN)
        if fmt < 0:
            raise ValueError(err.value.decode())
        self.pix_fmt, self.subsampling = FFV1_FORMATS[fmt]
        planes = [np.empty((info[2 * p + 1], info[2 * p]), np.uint8) for p in range(4) if info[2 * p]]
        self._lib.mga_ffv1_planes(self._h, *([_u8(p) for p in planes] + [None] * (4 - len(planes))))
        return planes

    def tally(self) -> dict:
        """The tools decoded so far, counted (``FFV1_TALLY``'s names)."""
        out = (ctypes.c_int64 * len(FFV1_TALLY))()
        n = self._lib.mga_ffv1_tally(self._h, out, len(FFV1_TALLY))
        if n != len(FFV1_TALLY):
            raise RuntimeError(f"ffv1.cpp counts {n} tools, FFV1_TALLY names {len(FFV1_TALLY)}")
        return dict(zip(FFV1_TALLY, out))

    def close(self) -> None:
        if self._h:
            self._lib.mga_ffv1_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


def mpeg4_header(width: int, height: int, time_resolution: int) -> bytes:
    """The VOS, VO and VOL headers of an I-VOP-only Simple profile stream."""
    lib = load()
    return _grow(lambda out, cap, err: lib.mga_mpeg4_encode_header(width, height, time_resolution, _u8(out), cap,
                                                                   err, _ERR_LEN), 64)


def mpeg4_encode_intra(y: np.ndarray, u: np.ndarray, v: np.ndarray, time_resolution: int, seconds: int,
                       increment: int, qp: int) -> bytes:
    """One I-VOP of 4:2:0 planes at quantiser ``qp``: ``seconds`` whole
    seconds past the previous VOP's, ``increment`` ticks into its second."""
    lib = load()
    y, u, v = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
    h, w = y.shape
    if u.shape != (h // 2, w // 2) or v.shape != u.shape:
        raise ValueError(f"chroma planes of {u.shape}, {v.shape} for luma of {y.shape}")
    return _grow(lambda out, cap, err: lib.mga_mpeg4_encode_intra(
        _u8(y), _u8(u), _u8(v), w, h, time_resolution, seconds, increment, qp, _u8(out), cap, err, _ERR_LEN),
        y.size + 4096)


def bmp_decode(data: bytes, gray: bool = False) -> np.ndarray:
    """BMP bytes -> (H, W, 3) BGR or, with ``gray``, (H, W) uint8, as
    ``cv2.imdecode``. Raises ValueError naming what it does not read."""
    lib = load()
    return _decode(lib.mga_bmp_header, lib.mga_bmp_decode, bytes(data), gray)


_TIFF_ERRORS = {-1: "old-style (LSB-first) LZW", -2: "corrupt LZW data (a code its table does not hold)",
                -3: "the data ends before the strip or tile is full"}


def _tiff_expand(fn, data: bytes, size: int) -> np.ndarray:
    out = np.empty(size, np.uint8)
    n = fn(bytes(data), len(data), _u8(out), size)
    if n < 0:
        raise ValueError(_TIFF_ERRORS[n])
    if n < size:
        raise ValueError(f"the data holds {n} bytes of a strip or tile of {size}")
    return out


def tiff_lzw(data: bytes, size: int) -> np.ndarray:
    """The ``size`` bytes of a TIFF strip or tile from its LZW data, as
    libtiff decodes it; ValueError for corrupt or short data."""
    return _tiff_expand(load().mga_tiff_lzw, data, size)


def tiff_packbits(data: bytes, size: int) -> np.ndarray:
    """The ``size`` bytes of a TIFF strip or tile from its PackBits data."""
    return _tiff_expand(load().mga_tiff_packbits, data, size)


def tiff_predict(buf: np.ndarray, rows: int, row_samples: int, spp: int, bits: int, big_endian: bool) -> None:
    """Undo TIFF's horizontal predictor (2) in place on ``rows`` rows of
    ``row_samples`` samples of ``bits`` (8 or 16) bits each, ``spp`` a pixel."""
    if not buf.flags.c_contiguous or buf.dtype != np.uint8 or buf.size < rows * row_samples * bits // 8:
        raise ValueError(f"a buffer of {buf.size} bytes does not hold {rows} rows of {row_samples} samples")
    load().mga_tiff_predict(_u8(buf), rows, row_samples, spp, bits, int(big_endian))


def tiff_fax(data: bytes, compression: int, options: int, width: int, rows: int) -> np.ndarray:
    """``rows`` rows of ``width`` pixels of CCITT-coded TIFF data
    (``compression`` 2 modified Huffman, 3 T.4 with its T4Options, 4 T.6),
    packed a bit a pixel, black 1, each row (width + 7) // 8 bytes, as
    libtiff decodes them; ValueError for corrupt or short data."""
    size = (width + 7) // 8 * rows
    out = np.empty(size, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    data = bytes(data)
    if load().mga_tiff_fax(data, len(data), compression, options, width, rows, _u8(out), size, err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return out


def _webp(fn, data: bytes, h: int, w: int) -> np.ndarray:
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    data = bytes(data)
    if fn(data, len(data), w, h, _u8(out), err, _ERR_LEN):
        raise ValueError(err.value.decode())
    return out


def webp_vp8l_decode(data: bytes, h: int, w: int) -> np.ndarray:
    """A VP8L (lossless WebP) bitstream of an h x w image -> (h, w, 3) BGR, as
    libwebp decodes it; ValueError naming what is wrong with a corrupt one."""
    return _webp(load().mga_webp_vp8l_decode, data, h, w)


def webp_vp8_decode(data: bytes, h: int, w: int) -> np.ndarray:
    """A VP8 (lossy WebP) key frame of an h x w image -> (h, w, 3) BGR, as
    libwebp decodes it for cv2 (fancy upsampling, its YUV -> BGR)."""
    return _webp(load().mga_webp_vp8_decode, data, h, w)


_PNM_ERRORS = {-1: "a character that is not a digit, a space or a comment", -2: "the data ends before its numbers",
               -3: "a number past 2^31 - 1"}


def pnm_numbers(data: bytes, pos: int, count: int, maxdigits: int = 0) -> tuple[np.ndarray, int]:
    """``count`` decimal numbers of a PNM file from byte ``pos`` as OpenCV's
    ReadNumber reads them (whitespace and '#' comments before each, at most
    ``maxdigits`` digits, the byte after each passed over): the int32
    numbers and the offset after them. ValueError naming what is wrong."""
    out = np.empty(count, np.int32)
    at = ctypes.c_int64(pos)
    data = bytes(data)
    rc = load().mga_pnm_numbers(data, len(data), ctypes.byref(at), count, maxdigits,
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc:
        raise ValueError(f"{_PNM_ERRORS[rc]} (byte {at.value})")
    return out, at.value


def hdr_pixels(data: bytes, pos: int, width: int, height: int) -> np.ndarray:
    """(height, width, 4) RGBE bytes of a Radiance HDR's scanlines from byte
    ``pos``, run-length or flat, as OpenCV's rgbe.cpp reads them."""
    out = np.empty((height, width, 4), np.uint8)
    data = bytes(data)
    rc = load().mga_hdr_pixels(data, len(data), pos, width, height, _u8(out))
    if rc == -1:
        raise ValueError("corrupt run-length scanline")
    if rc == -2:
        raise ValueError("the data ends before the image is full")
    return out


class GifFrame(NamedTuple):
    """One GIF image as the file holds it: its place on the canvas, its
    colour indices (h, w; interlaced rows put in order), its colour table
    ((256, 3) RGB, or None to use the global one) and the graphic control
    extension before it."""

    x: int
    y: int
    indices: np.ndarray
    palette: Optional[np.ndarray]
    disposal: int
    delay: int  # 1/100 s
    transparent: int  # -1 for none
    has_gce: bool
    table_size: int  # entries of the local table (0 for none)


class Gif(NamedTuple):
    width: int
    height: int
    background: int
    palette: Optional[np.ndarray]  # (256, 3) RGB, zeros past the table, or None
    table_size: int  # entries of the global table (0 for none)
    frames: list


def gif_header(data: bytes) -> tuple[Gif, int]:
    """A GIF's logical screen and global colour table (``frames`` empty)
    and the offset of its first block after them."""
    info = (ctypes.c_int32 * 5)()
    pal = np.empty((256, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if load().mga_gif_header(data, len(data), info, _u8(pal), err, _ERR_LEN):
        raise ValueError(err.value.decode())
    width, height, background, entries, off = list(info)
    return Gif(width, height, background, pal if entries else None, entries, []), off


def gif_encode(img: np.ndarray) -> bytes:
    """(H, W, 3) BGR uint8 -> the GIF bytes cv2.imwrite writes for it
    (``gif.cpp``: a fixed 3-3-2 palette, Floyd-Steinberg dithered)."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want an (H, W, 3) BGR image, got {img.shape}")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a GIF of {w} x {h} pixels (1 to 65535 a side)")
    return _grow(lambda out, cap, err: lib.mga_gif_encode(_u8(img), h, w, _u8(out), cap), img.size + 4096)


def gif_frames(data: bytes, off: int, decode: bool = True) -> Iterator[GifFrame]:
    """Each image of a GIF from offset ``off`` to its trailer, its LZW data
    decoded to indices (``gif.cpp``); with ``decode`` False the data is
    passed over and ``indices`` is an empty (h, w) view. Raises ValueError
    naming what is corrupt or cut."""
    lib = load()
    info = (ctypes.c_int64 * 11)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    buf = np.empty(0 if not decode else 1 << 16, np.uint8)
    while True:
        local = np.empty((256, 3), np.uint8)
        out = _u8(buf) if decode else None
        rc = lib.mga_gif_frame(data, len(data), off, info, _u8(local), out, buf.size, err, _ERR_LEN)
        if rc == -2:
            if info[2] * info[3] > 2 ** 30:
                raise ValueError(f"GIF image of {info[2]} x {info[3]} pixels is past the limit of 2^30 pixels")
            buf = np.empty(info[2] * info[3], np.uint8)
            rc = lib.mga_gif_frame(data, len(data), off, info, _u8(local), _u8(buf), buf.size, err, _ERR_LEN)
        if rc < 0:
            raise ValueError(err.value.decode())
        if rc == 0:
            return
        x, y, w, h, _, n_local, disposal, delay, transparent, gce, off = list(info)
        indices = buf[:w * h].reshape(h, w).copy() if decode else np.broadcast_to(np.uint8(0), (h, w))
        yield GifFrame(x, y, indices, local if n_local else None, disposal, delay, transparent, bool(gce), n_local)
