"""Image geometry and the mask-synced training augmentation without OpenCV.

Counterpart of ``mga_yolo_tpu/data/transforms.py`` (the card's host has no
OpenCV). ``letterbox`` is its geometry (reference LetterBox, including the
round(d -/+ 0.1) padding split); the bilinear resize is PyTorch's half-pixel
``interpolate`` of uint8 on the CPU, which stays within one grey level of
OpenCV's fixed-point INTER_LINEAR. ``scale_boxes`` maps letterboxed boxes
back to the original image.

The training half works on sample dicts (``img`` (H, W, 3) uint8 BGR,
``boxes`` (N, 4) float32 xyxy pixels, ``cls`` (N,), ``mask`` (H, W) uint8 or
None) and draws every random number from the ``np.random.Generator`` it is
given, in the JAX package's order, so a seed gives the same geometry:
``letterbox_sample``, ``random_flip``, ``random_hsv``, ``random_affine``,
``mosaic3/4/9``, ``mixup`` and ``cutmix``. The mask rides through every
geometric step with the image's matrix. The warps are inverse-mapped on
the CPU with torch's ``grid_sample`` (one ``affine_grid`` for an affine
matrix), as the JAX package's ``data/device_augment.py`` computes them:
bilinear with a constant-114 border for the image (cv2 INTER_LINEAR +
BORDER_CONSTANT semantics, within one grey level), nearest with a 0 border
for the mask; the HSV jitter is that module's, in cv2's uint8 HSV space.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mga_yolo_tpu_torch.data.mask_ops import resize_nearest

Sample = dict


def letterbox(
    img: np.ndarray,
    new_shape: int | tuple[int, int],
    scaleup: bool = True,
    center: bool = True,
    pad_value: int = 114,
) -> tuple[np.ndarray, tuple[float, tuple[int, int]]]:
    """Aspect-preserving resize + constant pad of an (H, W, 3) uint8 image.

    Returns the padded image and ``ratio_pad = (r, (left, top))``.
    """
    h, w = img.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / h, new_shape[1] / w)
    if not scaleup:
        r = min(r, 1.0)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    dw, dh = new_shape[1] - new_w, new_shape[0] - new_h
    if center:
        dw /= 2
        dh /= 2
    if (w, h) != (new_w, new_h):  # uint8 in and out (PyTorch's fixed-point path, channels last)
        t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
        t = F.interpolate(t, size=(new_h, new_w), mode="bilinear", align_corners=False)
        img = t[0].permute(1, 2, 0).numpy()
    top = int(round(dh - 0.1)) if center else 0
    bottom = int(round(dh + 0.1))
    left = int(round(dw - 0.1)) if center else 0
    right = int(round(dw + 0.1))
    out = np.full((new_h + top + bottom, new_w + left + right, img.shape[2]), pad_value, np.uint8)
    out[top:top + new_h, left:left + new_w] = img
    return out, (r, (left, top))


def scale_boxes(boxes: np.ndarray, ratio_pad, orig_shape) -> np.ndarray:
    """Letterboxed xyxy -> original image coordinates, clipped to the image."""
    r, (left, top) = ratio_pad
    out = boxes.copy()
    out[:, [0, 2]] = (out[:, [0, 2]] - left) / r
    out[:, [1, 3]] = (out[:, [1, 3]] - top) / r
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, orig_shape[1])
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, orig_shape[0])
    return out


def letterbox_sample(sample: Sample, new_shape: int | tuple[int, int], scaleup: bool = True,
                     center: bool = True, pad_value: int = 114) -> Sample:
    """:func:`letterbox` of a sample: boxes scaled and shifted, the mask
    resized nearest and padded with 0; adds ``ratio_pad``."""
    img, (r, (left, top)) = letterbox(sample["img"], new_shape, scaleup, center, pad_value)
    out = dict(sample)
    out["img"] = img
    if len(sample.get("boxes", ())):
        b = sample["boxes"].copy()
        b[:, [0, 2]] = b[:, [0, 2]] * r + left
        b[:, [1, 3]] = b[:, [1, 3]] * r + top
        out["boxes"] = b
    if sample.get("mask") is not None:
        h, w = sample["img"].shape[:2]
        new_h, new_w = int(round(h * r)), int(round(w * r))
        m = sample["mask"]
        if m.shape[:2] != (new_h, new_w):
            m = resize_nearest(m, (new_h, new_w))
        padded = np.zeros(img.shape[:2], np.uint8)
        padded[top:top + new_h, left:left + new_w] = m
        out["mask"] = padded
    out["ratio_pad"] = (r, (left, top))
    return out


def random_flip(sample: Sample, rng: np.random.Generator, fliplr: float, flipud: float) -> Sample:
    """Vertical, then horizontal flip of image + boxes + mask."""
    img, boxes, mask = sample["img"], sample.get("boxes"), sample.get("mask")
    h, w = img.shape[:2]
    if flipud and rng.random() < flipud:
        img = np.flipud(img)
        mask = None if mask is None else np.flipud(mask)
        if boxes is not None and len(boxes):
            boxes = boxes.copy()
            boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
    if fliplr and rng.random() < fliplr:
        img = np.fliplr(img)
        mask = None if mask is None else np.fliplr(mask)
        if boxes is not None and len(boxes):
            boxes = boxes.copy()
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    out = dict(sample)
    out["img"] = np.ascontiguousarray(img)
    if boxes is not None:
        out["boxes"] = boxes
    if mask is not None:
        out["mask"] = np.ascontiguousarray(mask)
    return out


def hsv_jitter_tensor(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """HSV gains on float BGR pixels ``x`` (..., 3) in [0, 255], in cv2's
    uint8 HSV space (H in [0, 180)): BGR -> HSV, h * r0 % 180 / clip(s * r1)
    / clip(v * r2) truncated as the JAX package's LUTs are, HSV -> BGR,
    rounded. ``r`` (..., 3) broadcasts against ``x``: (3,) for one image,
    (B, 1, 1, 3) for a batch. Float32 on ``x``'s device."""
    b, g, rr = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(b, g), rr)
    mn = torch.minimum(torch.minimum(b, g), rr)
    diff = v - mn
    safe = torch.where(diff > 0, diff, torch.ones_like(diff))
    s = torch.where(v > 0, torch.floor(255.0 * diff / torch.where(v > 0, v, torch.ones_like(v)) + 0.5),
                    torch.zeros_like(v))
    h = torch.where(v == rr, 30.0 * (g - b) / safe,
                    torch.where(v == g, 60.0 + 30.0 * (b - rr) / safe, 120.0 + 30.0 * (rr - g) / safe))
    h = torch.floor(torch.where(diff > 0, h, torch.zeros_like(h)) + 0.5)
    h = torch.where(h < 0, h + 180.0, h)
    h = torch.floor(torch.remainder(h * r[..., 0], 180.0))
    s = torch.floor(torch.clamp(s * r[..., 1], 0, 255))
    v = torch.floor(torch.clamp(v * r[..., 2], 0, 255))
    sector = torch.floor(h / 30.0)
    f = h / 30.0 - sector
    sf = s / 255.0
    p, q, t = v * (1.0 - sf), v * (1.0 - sf * f), v * (1.0 - sf * (1.0 - f))
    i = sector.long()

    def pick(*vals):
        out = v.clone()
        for k, val in enumerate(vals):
            out = torch.where(i == k, val, out)
        return out

    red, grn, blu = pick(v, q, p, p, t, v), pick(t, v, v, q, p, p), pick(p, p, t, v, v, q)
    return torch.clamp(torch.floor(torch.stack([blu, grn, red], -1) + 0.5), 0, 255)


def hsv_jitter(img: np.ndarray, r: np.ndarray) -> np.ndarray:
    """:func:`hsv_jitter_tensor` of a BGR uint8 image with gains ``r`` (3,)."""
    x = torch.from_numpy(np.ascontiguousarray(img)).float()
    return hsv_jitter_tensor(x, torch.as_tensor(np.asarray(r, np.float32))).to(torch.uint8).numpy()


def random_hsv(sample: Sample, rng: np.random.Generator, hgain: float, sgain: float, vgain: float) -> Sample:
    """HSV colour jitter with gains 1 + U(-1, 1) * (hgain, sgain, vgain)."""
    if not (hgain or sgain or vgain):
        return sample
    r = rng.uniform(-1, 1, 3) * (hgain, sgain, vgain) + 1
    out = dict(sample)
    out["img"] = hsv_jitter(sample["img"], r.astype(np.float32))
    return out


def _rotation_matrix_2d(angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center=(0, 0), angle, scale), float64."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, 0.0], [-beta, alpha, 0.0]])


def _affine_matrix(rng: np.random.Generator, size: tuple[int, int], img_shape: tuple[int, ...], degrees: float,
                   translate: float, scale: float, shear: float, perspective: float) -> tuple[np.ndarray, float]:
    """Random C -> P -> R -> S -> T matrix (float32) and the scale drawn."""
    W, H = size
    C = np.eye(3, dtype=np.float32)
    C[0, 2] = -img_shape[1] / 2
    C[1, 2] = -img_shape[0] / 2
    P = np.eye(3, dtype=np.float32)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    R = np.eye(3, dtype=np.float32)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = _rotation_matrix_2d(a, s)
    S = np.eye(3, dtype=np.float32)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    T = np.eye(3, dtype=np.float32)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * W
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * H
    return T @ S @ R @ P @ C, s


def _grid(M: np.ndarray, src_hw: tuple[int, int], out_hw: tuple[int, int], perspective: bool) -> torch.Tensor:
    """``grid_sample``'s (1, H, W, 2) grid: each output pixel's source
    position under M^-1, in the normalised coordinates of a source of size
    ``src_hw`` (align_corners=False). An affine M becomes one
    ``affine_grid`` theta, composed in float64."""
    minv = np.linalg.inv(M.astype(np.float64))
    (hs, ws), (ho, wo) = src_hw, out_hw
    to_norm = np.array([[2 / ws, 0, 1 / ws - 1], [0, 2 / hs, 1 / hs - 1], [0, 0, 1]])
    if not perspective:
        from_norm = np.array([[wo / 2, 0, (wo - 1) / 2], [0, ho / 2, (ho - 1) / 2], [0, 0, 1]])
        theta = torch.from_numpy((to_norm @ minv @ from_norm)[:2]).float()[None]
        return F.affine_grid(theta, [1, 1, ho, wo], align_corners=False)
    ys, xs = torch.meshgrid(torch.arange(ho, dtype=torch.float64), torch.arange(wo, dtype=torch.float64),
                            indexing="ij")
    m = torch.from_numpy(to_norm @ minv)
    w = m[2, 0] * xs + m[2, 1] * ys + m[2, 2]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    x = (m[0, 0] * xs + m[0, 1] * ys + m[0, 2]) / w
    y = (m[1, 0] * xs + m[1, 1] * ys + m[1, 2]) / w
    return torch.stack([x, y], -1)[None].float()


def _sample(img: np.ndarray, grid: torch.Tensor, mode: str, border: float) -> np.ndarray:
    """grid_sample of an (H, W) or (H, W, C) uint8 image with a constant
    border: sampled from img - border with a zero border, border added back."""
    src = torch.from_numpy(np.ascontiguousarray(img))
    src = (src[None] if src.dim() == 2 else src.permute(2, 0, 1))[None].float() - border
    out = F.grid_sample(src, grid, mode=mode, padding_mode="zeros", align_corners=False)[0] + border
    out = out[0] if img.ndim == 2 else out.permute(1, 2, 0)
    return torch.clamp(torch.floor(out + 0.5), 0, 255).to(torch.uint8).numpy()


def warp_bilinear(img: np.ndarray, M: np.ndarray, out_hw: tuple[int, int], perspective: bool,
                  border: float = 114.0) -> np.ndarray:
    """cv2.warpAffine / warpPerspective(img, M) INTER_LINEAR with a constant
    border: each output pixel interpolates the 4 source pixels around M^-1
    of it, rounded to uint8."""
    return _sample(img, _grid(M, img.shape[:2], out_hw, perspective), "bilinear", border)


def warp_nearest(mask: np.ndarray, M: np.ndarray, out_hw: tuple[int, int], perspective: bool) -> np.ndarray:
    """cv2 warp INTER_NEAREST with a 0 border: the source pixel nearest to
    M^-1 of each output pixel."""
    return _sample(mask, _grid(M, mask.shape[:2], out_hw, perspective), "nearest", 0.0)


def random_affine(sample: Sample, rng: np.random.Generator, cfg, border: tuple[int, int] = (0, 0)) -> Sample:
    """Random perspective / affine warp of image + boxes + mask with one
    matrix (``cfg`` holds degrees, translate, scale, shear, perspective).
    Boxes keep the reference's candidate rule: w, h > 2 px, aspect < 100,
    area ratio > 0.1."""
    img = sample["img"]
    h0, w0 = img.shape[:2]
    size = (w0 + border[1] * 2, h0 + border[0] * 2)  # (W, H) output
    M, s = _affine_matrix(rng, size, img.shape, cfg.degrees, cfg.translate, cfg.scale, cfg.shear,
                          cfg.perspective)
    persp = cfg.perspective != 0
    grid = _grid(M, (h0, w0), (size[1], size[0]), persp)  # the mask has the image's size
    out = dict(sample)
    out["img"] = _sample(img, grid, "bilinear", 114.0)
    if sample.get("mask") is not None:
        out["mask"] = _sample(sample["mask"], grid, "nearest", 0.0)
    boxes, cls = sample.get("boxes"), sample.get("cls")
    if boxes is not None and len(boxes):
        n = len(boxes)
        corners = np.ones((n * 4, 3), np.float32)
        corners[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        warped = corners @ M.T
        warped = (warped[:, :2] / warped[:, 2:3] if persp else warped[:, :2]).reshape(n, 8)
        xs, ys = warped[:, [0, 2, 4, 6]], warped[:, [1, 3, 5, 7]]
        new = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, size[0])
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, size[1])
        w1, h1 = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
        w2, h2 = new[:, 2] - new[:, 0], new[:, 3] - new[:, 1]
        ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
        keep = (w2 > 2) & (h2 > 2) & (w2 * h2 / (w1 * h1 * s**2 + 1e-16) > 0.1) & (ar < 100)
        out["boxes"] = new[keep].astype(np.float32)
        if cls is not None:
            out["cls"] = cls[keep]
    return out


def _merge(all_boxes: list, all_cls: list) -> tuple[np.ndarray, np.ndarray]:
    boxes = np.concatenate(all_boxes).astype(np.float32) if all_boxes else np.zeros((0, 4), np.float32)
    return boxes, np.concatenate(all_cls) if all_cls else np.zeros((0,), np.float32)


def mosaic4(samples: Sequence[Sample], rng: np.random.Generator, imgsz: int) -> Sample:
    """4-image mosaic on a 2s canvas around a jittered centre; masks on the
    same canvas with a 0 background."""
    s = imgsz
    yc = int(rng.uniform(s // 2, 2 * s - s // 2))
    xc = int(rng.uniform(s // 2, 2 * s - s // 2))
    canvas = np.full((2 * s, 2 * s, 3), 114, np.uint8)
    mask_canvas = np.zeros((2 * s, 2 * s), np.uint8)
    has_mask = any(sm.get("mask") is not None for sm in samples)
    all_boxes, all_cls = [], []
    for i, sm in enumerate(samples):
        h, w = sm["img"].shape[:2]
        if i == 0:  # top-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
            x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(2 * s, yc + h)
            x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
        else:  # bottom-right
            x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(2 * s, yc + h)
            x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
        canvas[y1a:y2a, x1a:x2a] = sm["img"][y1b:y2b, x1b:x2b]
        if sm.get("mask") is not None:
            mask_canvas[y1a:y2a, x1a:x2a] = sm["mask"][y1b:y2b, x1b:x2b]
        if len(sm.get("boxes", ())):
            b = sm["boxes"].copy()
            b[:, [0, 2]] += x1a - x1b
            b[:, [1, 3]] += y1a - y1b
            all_boxes.append(b)
            all_cls.append(sm["cls"])
    boxes, cls = _merge(all_boxes, all_cls)
    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, 2 * s)
    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, 2 * s)
    return {"img": canvas, "boxes": boxes, "cls": cls, "mask": mask_canvas if has_mask else None}


def _crop(canvas, mask_canvas, has_mask, boxes, cls, oy, ox, s) -> Sample:
    """The 2s x 2s window at (oy, ox) of a 3s canvas; boxes shifted, clipped
    and kept when wider and taller than 2 px."""
    crop = canvas[oy:oy + 2 * s, ox:ox + 2 * s]
    mask_crop = mask_canvas[oy:oy + 2 * s, ox:ox + 2 * s]
    if len(boxes):
        boxes[:, [0, 2]] = (boxes[:, [0, 2]] - ox).clip(0, 2 * s)
        boxes[:, [1, 3]] = (boxes[:, [1, 3]] - oy).clip(0, 2 * s)
        keep = ((boxes[:, 2] - boxes[:, 0]) > 2) & ((boxes[:, 3] - boxes[:, 1]) > 2)
        boxes, cls = boxes[keep], cls[keep]
    return {"img": np.ascontiguousarray(crop), "boxes": boxes, "cls": cls,
            "mask": np.ascontiguousarray(mask_crop) if has_mask else None}


def mosaic3(samples: Sequence[Sample], rng: np.random.Generator, imgsz: int) -> Sample:
    """1x3 mosaic: the main image centred on a 3s canvas, one to its right,
    one to its left (bottom-aligned); the centred 2s x 2s crop."""
    s = imgsz
    canvas = np.full((3 * s, 3 * s, 3), 114, np.uint8)
    mask_canvas = np.zeros((3 * s, 3 * s), np.uint8)
    has_mask = any(sm.get("mask") is not None for sm in samples[:3])
    all_boxes, all_cls = [], []
    h0 = w0 = 0
    for i, sm in enumerate(samples[:3]):
        h, w = sm["img"].shape[:2]
        if i == 0:  # centre
            h0, w0 = h, w
            c = (s, s, s + w, s + h)
        elif i == 1:  # right of centre
            c = (s + w0, s, s + w0 + w, s + h)
        else:  # left of centre, bottom-aligned with it
            c = (s - w, s + h0 - h, s, s + h0)
        padw, padh = c[:2]
        x1, y1, x2, y2 = (max(v, 0) for v in c)
        canvas[y1:y2, x1:x2] = sm["img"][y1 - padh:, x1 - padw:]
        if sm.get("mask") is not None:
            mask_canvas[y1:y2, x1:x2] = sm["mask"][y1 - padh:, x1 - padw:]
        if len(sm.get("boxes", ())):
            b = sm["boxes"].copy()
            b[:, [0, 2]] += padw
            b[:, [1, 3]] += padh
            all_boxes.append(b)
            all_cls.append(sm["cls"])
    boxes, cls = _merge(all_boxes, all_cls)
    return _crop(canvas, mask_canvas, has_mask, boxes, cls, s // 2, s // 2, s)


def mosaic9(samples: Sequence[Sample], rng: np.random.Generator, imgsz: int) -> Sample:
    """9-image mosaic on a 3x3 grid of a 3s canvas; a random 2s x 2s crop."""
    s = imgsz
    canvas = np.full((3 * s, 3 * s, 3), 114, np.uint8)
    mask_canvas = np.zeros((3 * s, 3 * s), np.uint8)
    has_mask = any(sm.get("mask") is not None for sm in samples)
    all_boxes, all_cls = [], []
    for idx, sm in enumerate(samples[:9]):
        gy, gx = divmod(idx, 3)
        h, w = sm["img"].shape[:2]
        y0, x0 = gy * s, gx * s
        y1, x1 = min(y0 + h, 3 * s), min(x0 + w, 3 * s)
        canvas[y0:y1, x0:x1] = sm["img"][:y1 - y0, :x1 - x0]
        if sm.get("mask") is not None:
            mask_canvas[y0:y1, x0:x1] = sm["mask"][:y1 - y0, :x1 - x0]
        if len(sm.get("boxes", ())):
            b = sm["boxes"].copy()
            b[:, [0, 2]] += x0
            b[:, [1, 3]] += y0
            all_boxes.append(b)
            all_cls.append(sm["cls"])
    boxes, cls = _merge(all_boxes, all_cls)
    oy = int(rng.integers(0, s))
    ox = int(rng.integers(0, s))
    return _crop(canvas, mask_canvas, has_mask, boxes, cls, oy, ox, s)


def mixup(a: Sample, b: Sample, rng: np.random.Generator) -> Sample:
    """Beta(32, 32) blend of two images; boxes joined, masks max-combined."""
    lam = rng.beta(32.0, 32.0)
    img = (a["img"].astype(np.float32) * lam + b["img"].astype(np.float32) * (1 - lam)).astype(np.uint8)
    out = {"img": img, "boxes": np.concatenate([a["boxes"], b["boxes"]]).astype(np.float32),
           "cls": np.concatenate([a["cls"], b["cls"]]), "mask": None}
    ma, mb = a.get("mask"), b.get("mask")
    if ma is not None and mb is not None:
        out["mask"] = np.maximum(ma, mb)
    elif ma is not None or mb is not None:
        out["mask"] = ma if ma is not None else mb
    return out


def cutmix(a: Sample, b: Sample, rng: np.random.Generator, beta: float = 1.0) -> Sample:
    """Paste a random window of b into a (image and mask); b's boxes that
    lie more than half inside the window join a's."""
    h, w = a["img"].shape[:2]
    lam = rng.beta(beta, beta)
    cut_ratio = math.sqrt(1 - lam)
    cw, ch = int(w * cut_ratio), int(h * cut_ratio)
    cx, cy = rng.integers(0, w), rng.integers(0, h)
    x1, y1 = max(cx - cw // 2, 0), max(cy - ch // 2, 0)
    x2, y2 = min(cx + cw // 2, w), min(cy + ch // 2, h)
    img = a["img"].copy()
    img[y1:y2, x1:x2] = b["img"][y1:y2, x1:x2]
    keep_b, cls_b = np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)
    if len(b.get("boxes", ())):
        bx = b["boxes"]
        inter = (np.clip(np.minimum(bx[:, 2], x2) - np.maximum(bx[:, 0], x1), 0, None)
                 * np.clip(np.minimum(bx[:, 3], y2) - np.maximum(bx[:, 1], y1), 0, None))
        sel = inter / ((bx[:, 2] - bx[:, 0]) * (bx[:, 3] - bx[:, 1]) + 1e-9) > 0.5
        keep_b, cls_b = bx[sel], b["cls"][sel]
    out = {"img": img, "boxes": np.concatenate([a["boxes"], keep_b]).astype(np.float32),
           "cls": np.concatenate([a["cls"], cls_b]), "mask": None}
    ma, mb = a.get("mask"), b.get("mask")
    if ma is not None:
        m = ma.copy()
        m[y1:y2, x1:x2] = mb[y1:y2, x1:x2] if mb is not None else 0
        out["mask"] = m
    return out


def albumentations(sample: Sample, rng: np.random.Generator, p: float = 1.0) -> Sample:
    """The reference's Albumentations adapter needs the ``albumentations``
    package, which neither the card's host nor this package carries."""
    raise NotImplementedError("augment.albumentations needs the albumentations package, which the port does "
                              "not carry; set it to 0")
