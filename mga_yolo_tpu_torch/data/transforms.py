"""Serving-side image geometry without OpenCV (the CUDA host has none).

``letterbox`` is the geometry of ``mga_yolo_tpu/data/transforms.py``
``letterbox`` (reference LetterBox, including the round(d -/+ 0.1) padding
split); the bilinear resize is PyTorch's half-pixel ``interpolate`` on the
CPU, which stays within one grey level of OpenCV's fixed-point INTER_LINEAR.
``scale_boxes`` maps letterboxed boxes back to the original image.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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
    if (w, h) != (new_w, new_h):
        t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
        t = F.interpolate(t, size=(new_h, new_w), mode="bilinear", align_corners=False)
        img = t[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()
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
