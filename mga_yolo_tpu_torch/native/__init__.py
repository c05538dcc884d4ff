"""ctypes bindings of the port's host C++: ``maskops.cpp`` (mask pyramid, PNG
rows, the port's copy of ``mga_yolo_tpu/native``), ``jpeg.cpp`` (JPEG
decoding and encoding) and ``bmp.cpp`` (BMP decoding).

The three sources are compiled at first use, together, with ``g++ -O3
-shared -fPIC -std=c++17`` into ``mga_yolo_tpu_torch/_build/libmaskops-<hash>.so``,
keyed by a hash of the sources, and loaded with ctypes. Nothing is built at
import time. The data pipeline and the image codecs have no other path: when
the library cannot be built or loaded, :func:`load` (and so every entry
point) raises RuntimeError with the compiler's or the loader's message. The
numpy twins in ``data/mask_ops.py`` and ``data/image_io.py`` are the oracle
the tests hold the mask ops and PNG rows equal to; cv2, the JAX package's
decoder, is the codecs' oracle. The codecs hold no global state, and ctypes
releases the GIL around each call, so threads decode at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).with_name("maskops.cpp")
CODEC_SOURCES = (Path(__file__).with_name("jpeg.cpp"), Path(__file__).with_name("bmp.cpp"))
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def sources() -> tuple[Path, ...]:
    return (*CODEC_SOURCES, SOURCE)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"".join(p.read_bytes() for p in sources())).hexdigest()[:16]
    return BUILD_DIR / f"libmaskops-{h}.so"


def _compile(target: Path) -> Optional[str]:
    """Build the library into ``target``; the compiler's message on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, *map(str, sources()), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        return f"{' '.join(cmd)} failed:\n{e.stderr}"
    except (subprocess.SubprocessError, OSError) as e:
        tmp.unlink(missing_ok=True)
        return f"{' '.join(cmd)} did not run: {e}"
    os.replace(tmp, target)
    return None


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
    for fn in ("block_reduce_max_u8", "block_reduce_mean_u8", "zhang_suen_thin_u8",
               "rasterize_edges_u8", "close3x3_u8"):
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


def jpeg_encode(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W) grey or (H, W, 3) BGR uint8 -> baseline JPEG bytes, as
    ``cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])``."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    err = ctypes.create_string_buffer(_ERR_LEN)
    cap = img.size + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.mga_jpeg_encode(_u8(img), h, w, c, int(quality), _u8(out), cap, err, _ERR_LEN)
        if n < 0:
            raise ValueError(err.value.decode())
        if n <= cap:
            return out[:n].tobytes()
        cap = n


def bmp_decode(data: bytes, gray: bool = False) -> np.ndarray:
    """BMP bytes -> (H, W, 3) BGR or, with ``gray``, (H, W) uint8, as
    ``cv2.imdecode``. Raises ValueError naming what it does not read."""
    lib = load()
    return _decode(lib.mga_bmp_header, lib.mga_bmp_decode, bytes(data), gray)
