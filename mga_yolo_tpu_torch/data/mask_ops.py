"""Host-side mask loading and pyramid downsampling without OpenCV.

Counterpart of ``mga_yolo_tpu/data/mask_ops.py``, the same methods and
results, with each cv2 call replaced by numpy:

* ``INTER_NEAREST`` resize: source index floor(dst * src / dst);
* ``INTER_AREA`` resize: the box average over each output pixel's
  footprint in the source (fractional at the edges when the sizes do not
  divide), rounded into uint8 as cv2 rounds (:func:`resize_area`);
* ``pyrDown``: the 5x5 binomial [1 4 6 4 1]^2 / 256 with
  ``BORDER_REFLECT_101``, every second pixel, rounded (:func:`pyr_down`);
* ``GaussianBlur`` of float32 with cv2's kernel size for sigma (round(8
  sigma + 1), odd) and ``BORDER_REFLECT`` (:func:`gaussian_blur`);
* ``morphologyEx(MORPH_CLOSE)`` 3x3 with the image border ignored, and
  ``cv2.line`` as Bresenham: the host C++ of ``mga_yolo_tpu_torch.native``
  (the JAX package's own C++), which this module always calls; its numpy
  twins here (``*_numpy``, :func:`zhang_suen_thin`) are the tests' oracle;
* ``connectedComponents``: 8- (or 4-) connected labelling.

Methods of :func:`downsample_mask`, binary uint8 {0, 1} at ceil(H/s) x
ceil(W/s): nearest | area (+ thresh, + close) | maxpool | pyrdown (+ close)
| gaussian_maxpool | skeleton_bresenham (non-strict: maxpool + close;
strict: Zhang-Suen skeleton, its nodes projected to the coarse grid and its
8-neighbour edges drawn as Bresenham lines). :func:`downsample_mask_prob`
gives float32 in [0, 1] (area | avgpool | nearest).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from mga_yolo_tpu_torch import native
from mga_yolo_tpu_torch.config import MaskPipelineConfig
from mga_yolo_tpu_torch.data import image_io


def infer_mask_path(im_file: str | Path, data_root: Optional[str], masks_dir: Optional[str]) -> Optional[Path]:
    """{data_root}/{masks_dir}/{image_stem}.{png,jpg,...}, the first that exists."""
    if not data_root or not masks_dir:
        return None
    stem = Path(im_file).stem
    base = Path(data_root) / masks_dir
    for ext in (".png", ".jpg", ".jpeg", ".tif", ".tiff"):
        p = base / f"{stem}{ext}"
        if p.exists():
            return p
    return None


def load_binary_mask(path: str | Path) -> np.ndarray:
    """Greyscale read (any format image_io reads, as cv2.IMREAD_GRAYSCALE), > 0 -> 1, uint8."""
    return (image_io.imread_gray(path) > 0).astype(np.uint8)


def _coarse_shape(h: int, w: int, stride: int) -> tuple[int, int]:
    return math.ceil(h / stride), math.ceil(w / stride)


# ---------------------------------------------------------------- resizes


def resize_nearest(m: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """cv2.resize INTER_NEAREST to (h, w): source index floor(i * src / dst)."""
    h, w = m.shape[:2]
    ys = np.minimum(np.floor(np.arange(hw[0]) * (h / hw[0])).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(hw[1]) * (w / hw[1])).astype(np.int64), w - 1)
    return m[ys[:, None], xs[None, :]]


def _area_weights(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) share of each source pixel in each output pixel's
    footprint [i * s, (i + 1) * s), s = n_src / n_dst, over s."""
    s = n_src / n_dst
    lo = np.arange(n_dst)[:, None] * s
    edges = np.arange(n_src)[None, :]
    overlap = np.clip(np.minimum(lo + s, edges + 1) - np.maximum(lo, edges), 0, None)
    return overlap / s


def resize_area(m: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """cv2.resize INTER_AREA of a 2-D image to (h, w) when shrinking: float
    box averages; a uint8 input comes back rounded half to even, but half up
    at an exact 2x shrink (cv2's (a + b + c + d + 2) >> 2 there)."""
    h, w = m.shape
    if m.dtype == np.uint8 and (h, w) == (2 * hw[0], 2 * hw[1]):
        q = m.astype(np.int32).reshape(hw[0], 2, hw[1], 2).sum((1, 3))
        return ((q + 2) >> 2).astype(np.uint8)
    out = _area_weights(h, hw[0]) @ m.astype(np.float64) @ _area_weights(w, hw[1]).T
    return np.rint(out).astype(np.uint8) if m.dtype == np.uint8 else out.astype(m.dtype)


def _reflect101(n: int, pad: int) -> np.ndarray:
    i = np.arange(-pad, n + pad)
    i = np.abs(i)
    return np.where(i >= n, 2 * (n - 1) - i, i)


def pyr_down(m: np.ndarray) -> np.ndarray:
    """cv2.pyrDown of a uint8 image: 5x5 binomial / 256, BORDER_REFLECT_101,
    every second pixel, (sum + 128) >> 8; output ((h+1)//2, (w+1)//2)."""
    k = np.array([1, 4, 6, 4, 1], np.int64)
    h, w = m.shape
    x = m.astype(np.int64)[_reflect101(h, 2)][:, _reflect101(w, 2)]
    rows = sum(k[i] * x[i:i + h] for i in range(5))[::2]
    full = sum(k[i] * rows[:, i:i + w] for i in range(5))[:, ::2]
    return ((full + 128) >> 8).astype(np.uint8)


def gaussian_blur(m: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(float32, (0, 0), sigma) with BORDER_REFLECT: kernel
    size round(8 sigma + 1) | 1, weights exp(-x^2 / 2 sigma^2) normalised."""
    ksize = int(round(sigma * 8 + 1)) | 1
    r = ksize // 2
    x = np.arange(ksize) - r
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k = (k / k.sum()).astype(np.float32)
    h, w = m.shape

    def reflect(n):
        i = np.arange(-r, n + r)
        i = np.where(i < 0, -i - 1, i)
        return np.where(i >= n, 2 * n - 1 - i, i)

    x = m.astype(np.float32)[reflect(h)][:, reflect(w)]
    rows = sum(k[i] * x[i:i + h] for i in range(ksize))
    return sum(k[i] * rows[:, i:i + w] for i in range(ksize)).astype(np.float32)


# -------------------------------------------- block reductions and morphology


def _blocks(m: np.ndarray, k: int) -> np.ndarray:
    h, w = m.shape
    m = np.pad(m, ((0, -h % k), (0, -w % k)))
    return m.reshape(m.shape[0] // k, k, m.shape[1] // k, k)


def block_reduce_max(m: np.ndarray, k: int) -> np.ndarray:
    """Max over each k x k block (zero-padded at the ragged edge)."""
    if m.dtype == np.uint8:
        return native.block_reduce_max(m, k)
    return _blocks(m, k).max(axis=(1, 3))


def block_reduce_mean(m: np.ndarray, k: int) -> np.ndarray:
    """float32 share of nonzero pixels in each k x k block, over k * k."""
    return native.block_reduce_mean((m > 0).astype(np.uint8), k)


def close3x3_numpy(m: np.ndarray) -> np.ndarray:
    """Numpy twin of the C++ ``close3x3_u8``: 3x3 dilation (zero outside),
    then 3x3 erosion (one outside: the border is ignored)."""
    h, w = m.shape

    def window(x, fill, op):
        p = np.pad(x, 1, constant_values=fill)
        out = p[0:h, 0:w]
        for dy in range(3):
            for dx in range(3):
                out = op(out, p[dy:dy + h, dx:dx + w])
        return out

    dil = window((m > 0).astype(np.uint8), 0, np.maximum)
    return window(dil, 1, np.minimum)


def close3x3(m: np.ndarray) -> np.ndarray:
    return native.close3x3(m)


def zhang_suen_thin(mask: np.ndarray, max_iters: int = 10000) -> np.ndarray:
    """Numpy twin of the C++ ``zhang_suen_thin_u8``: thin a binary mask to a
    1-px skeleton, the classic two sub-iterations, vectorised. As in the
    C++, pixels on the image's border are never removed."""
    img = np.pad((mask > 0).astype(np.uint8), 1)
    interior = np.zeros(mask.shape, bool)
    interior[1:-1, 1:-1] = True
    for _ in range(max_iters):
        changed = False
        for step in (0, 1):
            p = img
            # 8-neighbourhood P2..P9: N, NE, E, SE, S, SW, W, NW
            n = [p[:-2, 1:-1], p[:-2, 2:], p[1:-1, 2:], p[2:, 2:], p[2:, 1:-1], p[2:, :-2], p[1:-1, :-2],
                 p[:-2, :-2]]
            b = sum(x.astype(np.int32) for x in n)
            a = sum(((n[i] == 0) & (n[(i + 1) % 8] == 1)).astype(np.int32) for i in range(8))
            cond = interior & (p[1:-1, 1:-1] == 1) & (b >= 2) & (b <= 6) & (a == 1)
            if step == 0:
                cond &= (n[0] * n[2] * n[4] == 0) & (n[2] * n[4] * n[6] == 0)
            else:
                cond &= (n[0] * n[2] * n[6] == 0) & (n[0] * n[4] * n[6] == 0)
            if cond.any():
                img[1:-1, 1:-1][cond] = 0
                changed = True
        if not changed:
            break
    return img[1:-1, 1:-1].astype(bool)


def skeletonize(mask: np.ndarray) -> np.ndarray:
    """Zhang-Suen skeleton (host C++)."""
    return native.zhang_suen_thin((mask > 0).astype(np.uint8))


def skeleton_edges(skel: np.ndarray) -> np.ndarray:
    """(N, 4) int32 (y0, x0, y1, x1) 8-neighbour skeleton edges, each
    undirected direction (E, S, SE, SW) tested once with an array shift."""
    s = skel.astype(bool)
    out = []
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        if dx >= 0:
            a, b, off = s[:s.shape[0] - dy, :s.shape[1] - dx], s[dy:, dx:], 0
        else:
            a, b, off = s[:s.shape[0] - dy, -dx:], s[dy:, :dx], -dx
        ys, xs = np.nonzero(a & b)
        if ys.size:
            out.append(np.stack([ys, xs + off, ys + dy, xs + off + dx], axis=1))
    return np.concatenate(out).astype(np.int32) if out else np.empty((0, 4), np.int32)


def rasterize_edges_numpy(edges: np.ndarray, factor: int, out: np.ndarray) -> None:
    """Numpy twin of the C++ ``rasterize_edges_u8``: each edge divided by
    ``factor`` drawn into ``out`` as a Bresenham line of 1s (in place)."""
    hc, wc = out.shape
    for y0, x0, y1, x1 in (np.asarray(edges, np.int64) // factor).tolist():
        if (y0, x0) == (y1, x1):
            continue
        dx, sx = abs(x1 - x0), 1 if x0 < x1 else -1
        dy, sy = -abs(y1 - y0), 1 if y0 < y1 else -1
        err = dx + dy
        while True:
            if 0 <= x0 < wc and 0 <= y0 < hc:
                out[y0, x0] = 1
            if (x0, y0) == (x1, y1):
                break
            e2 = 2 * err
            if e2 >= dy:
                err += dy
                x0 += sx
            if e2 <= dx:
                err += dx
                y0 += sy


def _skeleton_bresenham_from(skel: np.ndarray, edges: np.ndarray, shape: tuple[int, int], stride: int,
                             bridge: bool) -> np.ndarray:
    out = np.zeros(_coarse_shape(shape[0], shape[1], stride), np.uint8)
    ys, xs = np.nonzero(skel)
    if ys.size == 0:
        return out
    out[ys // stride, xs // stride] = 1
    native.rasterize_edges(edges, stride, out)
    return close3x3(out) if bridge else out


# ---------------------------------------------------------------- pyramids


def downsample_mask(mask: np.ndarray, stride: int, cfg: MaskPipelineConfig) -> np.ndarray:
    """Binary downsample by ``stride`` (uint8 {0, 1})."""
    m = (mask > 0).astype(np.uint8)
    if stride <= 1:
        return m
    hc, wc = _coarse_shape(*m.shape, stride)
    method = cfg.method.lower()

    if method == "nearest":
        return resize_nearest(m, (hc, wc))
    if method == "area":
        out = (resize_area(m, (hc, wc)) > cfg.thresh).astype(np.uint8)
        return close3x3(out) if cfg.bridge else out
    if method == "maxpool":
        return block_reduce_max(m, stride)
    if method == "pyrdown" and stride & (stride - 1) == 0:
        out, s = m, stride
        while s > 1:
            out = pyr_down(out)
            s //= 2
        out = (out > 0).astype(np.uint8)
        return close3x3(out) if cfg.bridge else out
    if method == "gaussian_maxpool":
        pooled = block_reduce_max(gaussian_blur(m, stride / 2.0), stride)
        return (pooled >= (cfg.thresh if cfg.thresh > 0 else 0.2)).astype(np.uint8)

    # skeleton_bresenham (the default), and pyrdown at a stride that is no power of two
    if not cfg.skeleton_strict:
        out = block_reduce_max(m, stride)
        return close3x3(out) if cfg.bridge else out
    skel = skeletonize(m)
    return _skeleton_bresenham_from(skel, skeleton_edges(skel), m.shape, stride, cfg.bridge)


def downsample_mask_multi(mask: np.ndarray, strides: Sequence[int], cfg: MaskPipelineConfig) -> Dict[int, np.ndarray]:
    """Every stride's downsample; the strict skeleton path thins once."""
    if cfg.method.lower() == "skeleton_bresenham" and cfg.skeleton_strict:
        m = (mask > 0).astype(np.uint8)
        skel = skeletonize(m)
        edges = skeleton_edges(skel)
        return {s: _skeleton_bresenham_from(skel, edges, m.shape, s, cfg.bridge) for s in strides}
    return {s: downsample_mask(mask, s, cfg) for s in strides}


def downsample_mask_prob(mask: np.ndarray, stride: int, method: str = "area") -> np.ndarray:
    """Probabilistic downsample, float32 in [0, 1]: ``avgpool`` is the block's
    foreground share; ``area`` is cv2's uint8 INTER_AREA of the {0, 1} mask
    (so the share rounded to 0 or 1, as the JAX package computes it);
    ``nearest`` the nearest pixel."""
    m = (mask > 0).astype(np.uint8)
    if stride <= 1:
        return m.astype(np.float32)
    hc, wc = _coarse_shape(*m.shape, stride)
    if method == "avgpool":
        return block_reduce_mean(m, stride)
    if method == "nearest":
        return resize_nearest(m, (hc, wc)).astype(np.float32)
    return np.clip(resize_area(m, (hc, wc)).astype(np.float32), 0.0, 1.0)


def connected_components(mask: np.ndarray, connectivity: int = 8) -> int:
    """Number of foreground components (8- or 4-connected)."""
    m = mask > 0
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    h, w = m.shape
    ys, xs = np.nonzero(m)
    label = np.full(h * w, -1, np.int64)
    label[ys * w + xs] = ys * w + xs
    pairs = []
    for dy, dx in [(0, 1), (1, 0)] + ([(1, 1), (1, -1)] if connectivity == 8 else []):
        yy, xx = ys + dy, xs + dx
        ok = (yy < h) & (xx >= 0) & (xx < w)
        ok[ok] = m[yy[ok], xx[ok]]
        pairs.append(np.stack([ys[ok] * w + xs[ok], yy[ok] * w + xx[ok]], 1))
    pairs = np.concatenate(pairs)
    # every pixel takes the least label of its neighbours, then of its
    # label's pixel (pointer jumping), until nothing moves
    while len(pairs):
        new = label.copy()
        lo = np.minimum(label[pairs[:, 0]], label[pairs[:, 1]])
        np.minimum.at(new, pairs[:, 0], lo)
        np.minimum.at(new, pairs[:, 1], lo)
        new[new >= 0] = new[new[new >= 0]]
        if np.array_equal(new, label):
            break
        label = new
    return int(np.unique(label[label >= 0]).size)
