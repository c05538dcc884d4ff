"""Device-side training augmentation: the warp, HSV, flip and mask pyramid
of a whole batch as tensor operations on the card (counterpart of
``mga_yolo_tpu/data/device_augment.py``).

The host keeps what is cheap and draws every random number: it decodes,
letterboxes and places the mosaic parts on a canvas (memory copies), and it
draws the affine matrix, the HSV gains and the flip flags from the sample's
``np.random.Generator`` in the order of ``MGADataset._train_sample``, so a
(seed, index) pair gives the same geometry on either path
(:func:`build_raw_sample`). The card does the per-pixel work, batched over B
with plain tensor operations (:func:`make_augment_fn`): the inverse-mapped
bilinear warp of the image canvas with a constant-114 border, the nearest
warp of the mask with the same matrix and a 0 border, the boxes' corner
transform and the reference's candidate filter, the HSV jitter in cv2's
uint8 HSV space, the flips, the mask pyramid, and the stable compaction of
the kept boxes to ``max_boxes``.

Shapes are fixed: the canvas is (2S, 2S) while mosaic can fire (the affine
output crops it to S) and (S, S) without; the boxes ride as
``2 * max_boxes`` padded rows with a validity flag. A raw batch is larger
than a finished one: at 640 px, B=16 with mosaic, 78.6 MB of canvas and
26.2 MB of mask canvas against about 20 MB.

Supported (:func:`supported` gives the reason otherwise): no mixup, cutmix
or albumentations (they compose finished samples, host only), and a mask
method with a batched equivalent: ``maxpool``, ``area``, ``nearest``,
non-strict ``skeleton_bresenham`` (maxpool + the 3x3 close bridge), or
``prob_mode`` with ``area`` / ``avgpool`` / ``nearest``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mga_yolo_tpu_torch.config import AugmentConfig, MGAConfig
from mga_yolo_tpu_torch.data import transforms as T

STRIDES = (8, 16, 32)


def supported(cfg: MGAConfig) -> tuple[bool, str]:
    """Can this config's augmentation run on the card? (ok, reason if not)."""
    a = cfg.augment
    if a.mixup or a.cutmix:
        return False, "mixup/cutmix compose finished samples recursively (host-only)"
    if a.albumentations:
        return False, "albumentations is a host cv2 pipeline"
    m = cfg.mask
    if m.prob_mode:
        if m.prob_method not in ("area", "avgpool", "nearest"):
            return False, f"prob_method={m.prob_method!r} has no device equivalent"
        return True, ""
    method = m.method.lower()
    if method in ("maxpool", "area", "nearest"):
        return True, ""
    if method == "skeleton_bresenham" and not m.skeleton_strict:
        return True, ""  # non-strict = maxpool (+ close bridge)
    return False, f"mask method={method!r} (strict={m.skeleton_strict}) is host-only"


def canvas_multiplier(aug: AugmentConfig, use_mosaic: bool) -> int:
    """Canvas side in multiples of imgsz: 2 while mosaic can fire, else 1."""
    return 2 if (use_mosaic and aug.mosaic > 0) else 1


# ----------------------------------------------------------------- host half


def build_raw_sample(ds, i: int, rng: np.random.Generator, use_mosaic: bool, size: int | None = None) -> dict:
    """One un-warped training sample of the ``MGADataset`` ``ds``: canvas,
    mask canvas, matrices, gains, flip flags and padded boxes. The draws
    follow ``ds._train_sample``: mosaic gate, part indices, mosaic jitter,
    affine matrix, HSV gains, flip flags."""
    aug = ds.cfg.augment
    s = size or ds.imgsz
    cm = canvas_multiplier(aug, use_mosaic)
    if use_mosaic and rng.random() < aug.mosaic:
        n = aug.mosaic_n if aug.mosaic_n in (3, 4, 9) else 4
        idxs = [i] + list(rng.integers(0, len(ds), n - 1))
        parts = [T.letterbox_sample(ds.load_raw(j), s, scaleup=True, center=False) for j in idxs]
        sample = {3: T.mosaic3, 4: T.mosaic4, 9: T.mosaic9}[n](parts, rng, s)
    else:
        sample = T.letterbox_sample(ds.load_raw(i), s, scaleup=True)

    img = sample["img"]
    canvas = np.full((cm * s, cm * s, 3), 114, np.uint8)
    mask_canvas = np.zeros((cm * s, cm * s), np.uint8)
    h0, w0 = img.shape[:2]
    canvas[:h0, :w0] = img  # mosaic: an exact fit; a plain image in a 2S canvas: top-left
    if sample.get("mask") is not None:
        mask_canvas[:h0, :w0] = sample["mask"]

    # the host path's matrix: output (s, s) (mosaic border -s//2 or none),
    # centred on the image before the embed; what it reads past the image
    # is the 114 fill, as cv2's constant border gives
    M, sc = T._affine_matrix(rng, (s, s), img.shape, aug.degrees, aug.translate, aug.scale, aug.shear,
                             aug.perspective)
    minv = np.linalg.inv(M.astype(np.float64)).astype(np.float32)
    if aug.hsv_h or aug.hsv_s or aug.hsv_v:
        hsv = (rng.uniform(-1, 1, 3) * (aug.hsv_h, aug.hsv_s, aug.hsv_v) + 1).astype(np.float32)
    else:
        hsv = np.ones(3, np.float32)
    flips = np.zeros(2, np.float32)  # [flipud, fliplr], drawn as random_flip draws them
    if aug.flipud and rng.random() < aug.flipud:
        flips[0] = 1.0
    if aug.fliplr and rng.random() < aug.fliplr:
        flips[1] = 1.0

    P = 2 * ds.max_boxes  # room for the boxes before the affine filter drops some
    boxes = np.zeros((P, 4), np.float32)
    cls = np.zeros((P,), np.float32)
    valid = np.zeros((P,), np.float32)
    nb = min(len(sample.get("boxes", ())), P)
    if nb:
        boxes[:nb] = sample["boxes"][:nb]
        cls[:nb] = sample["cls"][:nb]
        valid[:nb] = 1.0
    return {"canvas": canvas, "mask_canvas": mask_canvas, "pboxes": boxes, "pcls": cls, "pvalid": valid,
            "mfwd": M.astype(np.float32), "minv": minv, "ascale": np.float32(sc), "hsv": hsv, "flips": flips,
            "index": np.int32(i)}


def collate_raw(samples: Sequence[dict]) -> dict:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def batch_bytes(batch: dict) -> int:
    """Bytes of a batch of arrays (or lists of arrays, as ``masks``): what
    its host-to-card copy moves."""
    return sum(sum(int(np.asarray(a).nbytes) for a in (v if isinstance(v, list) else [v])) for v in batch.values())


# --------------------------------------------------------------- device half


def _src_coords(minv: torch.Tensor, S: int, perspective: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Source x, y (B, S, S) float32 of every output pixel under ``minv`` (B, 3, 3)."""
    ar = torch.arange(S, dtype=torch.float32, device=minv.device)
    ys, xs = ar[:, None].expand(S, S), ar[None, :].expand(S, S)
    m = minv[:, :, :, None, None]  # (B, 3, 3, 1, 1)
    x = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
    y = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    if perspective:
        w = m[:, 2, 0] * xs + m[:, 2, 1] * ys + m[:, 2, 2]
        w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
        x, y = x / w, y / w
    return x, y


def _gather(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, ...) at the integer grids (B, S, S), clamped into it."""
    B, H, W = img.shape[:3]
    b = torch.arange(B, device=img.device)[:, None, None]
    return img[b, yi.clamp(0, H - 1), xi.clamp(0, W - 1)]


def _inside(yi: torch.Tensor, xi: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)


def _warp_bilinear(canvas: torch.Tensor, minv: torch.Tensor, S: int, perspective: bool,
                   border: float = 114.0) -> torch.Tensor:
    """cv2 warpAffine / warpPerspective INTER_LINEAR with a constant border,
    in float32: (B, H, W, 3) uint8 -> (B, S, S, 3) float32 (unrounded).
    An explicit floor of the source position, four gathers and four weights."""
    H, W = canvas.shape[1:3]
    x, y = _src_coords(minv, S, perspective)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    out = None
    for dy, dx, wgt in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)), (1, 0, (1 - fx) * fy),
                        (1, 1, fx * fy)):
        yi, xi = y0i + dy, x0i + dx
        tap = torch.where(_inside(yi, xi, H, W)[..., None], _gather(canvas, yi, xi).float(),
                          torch.full((), border, device=canvas.device))
        out = wgt * tap if out is None else out + wgt * tap
    return out


def _warp_nearest(mask: torch.Tensor, minv: torch.Tensor, S: int, perspective: bool) -> torch.Tensor:
    """Nearest warp with a 0 border: (B, H, W) uint8 -> (B, S, S) float32."""
    H, W = mask.shape[1:3]
    x, y = _src_coords(minv, S, perspective)
    xi, yi = torch.floor(x + 0.5).long(), torch.floor(y + 0.5).long()
    return torch.where(_inside(yi, xi, H, W), _gather(mask, yi, xi).float(), torch.zeros((), device=mask.device))


def _transform_boxes(boxes: torch.Tensor, valid: torch.Tensor, M: torch.Tensor, sc: torch.Tensor, S: int,
                     perspective: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``random_affine``'s box corners and candidate filter, batched:
    boxes (B, P, 4), valid (B, P), M (B, 3, 3), sc (B,) -> (boxes, keep)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    cx = torch.stack([x1, x2, x1, x2], -1)  # corners (x1,y1) (x2,y2) (x1,y2) (x2,y1)
    cy = torch.stack([y1, y2, y2, y1], -1)
    m = M[:, :, :, None, None]  # (B, 3, 3, 1, 1) against corners (B, P, 4)
    wx = m[:, 0, 0] * cx + m[:, 0, 1] * cy + m[:, 0, 2]
    wy = m[:, 1, 0] * cx + m[:, 1, 1] * cy + m[:, 1, 2]
    if perspective:
        ww = m[:, 2, 0] * cx + m[:, 2, 1] * cy + m[:, 2, 2]
        wx, wy = wx / ww, wy / ww
    nx1, ny1 = wx.amin(-1).clamp(0, S), wy.amin(-1).clamp(0, S)
    nx2, ny2 = wx.amax(-1).clamp(0, S), wy.amax(-1).clamp(0, S)
    w1, h1 = x2 - x1, y2 - y1
    w2, h2 = nx2 - nx1, ny2 - ny1
    ar = torch.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    keep = ((w2 > 2) & (h2 > 2) & (w2 * h2 / (w1 * h1 * (sc * sc)[:, None] + 1e-16) > 0.1) & (ar < 100)
            & (valid > 0))
    return torch.stack([nx1, ny1, nx2, ny2], -1), keep.float()


def _hsv_jitter(img: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """HSV gains r (B, 3) on float BGR images (B, S, S, 3) in [0, 255]."""
    return T.hsv_jitter_tensor(img, r[:, None, None, :])


def _close3(x: torch.Tensor) -> torch.Tensor:
    """3x3 morphological close of (B, H, W) binary float32 (cv2 MORPH_CLOSE):
    a max, then a min, each over the 3x3 window inside the image."""
    dil = F.max_pool2d(x[:, None], 3, stride=1, padding=1)
    return -F.max_pool2d(-dil, 3, stride=1, padding=1)[:, 0]


def _area_u8(blocks: torch.Tensor, stride: int) -> torch.Tensor:
    """cv2 INTER_AREA of a {0, 1} uint8 mask: the block mean rounded into
    uint8, half to even (cvRound), but half up at an exact 2x shrink
    (cv2's (a + b + c + d + 2) >> 2 there), as ``mask_ops.resize_area``."""
    mean = blocks.mean((2, 4))
    return torch.floor(mean + 0.5) if stride == 2 else torch.round(mean)


def downsample_batch(masks: torch.Tensor, stride: int, mcfg) -> torch.Tensor:
    """(B, S, S) binary float32 -> (B, S/st, S/st) by the configured method:
    ``mask_ops.downsample_mask`` / ``downsample_mask_prob`` for the methods
    :func:`supported` accepts, equal to them cell for cell."""
    B, H, W = masks.shape
    blocks = masks.reshape(B, H // stride, stride, W // stride, stride)
    if mcfg.prob_mode:
        if mcfg.prob_method == "nearest":
            return masks[:, ::stride, ::stride]
        if mcfg.prob_method == "avgpool":
            return blocks.mean((2, 4))
        return _area_u8(blocks, stride)  # "area": the uint8 resize, then float
    method = mcfg.method.lower()
    if method == "nearest":
        return masks[:, ::stride, ::stride]
    if method == "area":
        out = (_area_u8(blocks, stride) > mcfg.thresh).float()
        return _close3(out) if mcfg.bridge else out
    out = blocks.amax((2, 4))  # maxpool, and non-strict skeleton_bresenham
    if method == "skeleton_bresenham" and mcfg.bridge:
        out = _close3(out)
    return out


def make_augment_fn(cfg: MGAConfig, max_boxes: int, strides: Sequence[int] = STRIDES) -> Callable[[dict, int], dict]:
    """``augment(raw, out_size) -> batch``: a raw batch (the
    :func:`collate_raw` keys, as tensors on one device) to the batch dict
    ``dataset.collate`` gives and ``train.state.make_train_step`` takes,
    computed on the raw batch's device: ``image`` (B, S, S, 3) uint8,
    ``gt_boxes`` (B, M, 4), ``gt_labels`` (B, M) int32, ``mask_gt`` (B, M)
    float32 and ``masks`` [(B, S/st, S/st, 1) float32 per stride]."""
    aug, mcfg = cfg.augment, cfg.mask
    perspective = bool(aug.perspective)
    do_hsv = bool(aug.hsv_h or aug.hsv_s or aug.hsv_v)
    do_flipud, do_fliplr = bool(aug.flipud), bool(aug.fliplr)

    def augment(raw: dict, out_size: int) -> dict:
        S = int(out_size)
        minv, mfwd = raw["minv"].float(), raw["mfwd"].float()
        img = _warp_bilinear(raw["canvas"], minv, S, perspective)
        img = torch.clamp(torch.floor(img + 0.5), 0, 255)
        if do_hsv:
            img = _hsv_jitter(img, raw["hsv"].float())
        m = _warp_nearest(raw["mask_canvas"], minv, S, perspective)
        nb, keep = _transform_boxes(raw["pboxes"].float(), raw["pvalid"], mfwd, raw["ascale"].float(), S,
                                    perspective)
        if do_flipud:
            fud = raw["flips"][:, 0] > 0
            img = torch.where(fud[:, None, None, None], img.flip(1), img)
            m = torch.where(fud[:, None, None], m.flip(1), m)
            x1, y1, x2, y2 = nb.unbind(-1)
            nb = torch.where(fud[:, None, None], torch.stack([x1, S - y2, x2, S - y1], -1), nb)
        if do_fliplr:
            flr = raw["flips"][:, 1] > 0
            img = torch.where(flr[:, None, None, None], img.flip(2), img)
            m = torch.where(flr[:, None, None], m.flip(2), m)
            x1, y1, x2, y2 = nb.unbind(-1)
            nb = torch.where(flr[:, None, None], torch.stack([S - x2, y1, S - x1, y2], -1), nb)
        # the kept boxes first, in their order (finalize's compaction)
        order = torch.argsort(1.0 - keep, dim=1, stable=True)[:, :max_boxes]
        kv = torch.gather(keep, 1, order)
        gt_boxes = torch.gather(nb, 1, order[..., None].expand(-1, -1, 4)) * kv[..., None]
        gt_labels = (torch.gather(raw["pcls"].float(), 1, order) * kv).to(torch.int32)
        return {"image": img.to(torch.uint8), "gt_boxes": gt_boxes, "gt_labels": gt_labels, "mask_gt": kv,
                "masks": [downsample_batch(m, st, mcfg)[..., None] for st in strides]}

    return augment
