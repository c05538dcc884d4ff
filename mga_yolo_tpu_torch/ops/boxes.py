"""Box geometry for the decode, NMS and loss (counterpart of ``ops/boxes.py``)."""

from __future__ import annotations

import math
from typing import Sequence

import torch


def make_anchors(
    shapes: Sequence[tuple[int, int]],
    strides: Sequence[int],
    grid_cell_offset: float = 0.5,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Anchor centres (A, 2) in grid units and per-anchor stride (A, 1).

    Anchors run row-major over each level's (H, W), levels in order, which is
    the order of ``maps.flatten(2)`` for NCHW maps.
    """
    pts, sts = [], []
    for (h, w), s in zip(shapes, strides):
        sx = torch.arange(w, dtype=dtype, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=dtype, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
        sts.append(torch.full((h * w, 1), s, dtype=dtype, device=device))
    return torch.cat(pts), torch.cat(sts)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True) -> torch.Tensor:
    """ltrb distances -> boxes (xywh or xyxy), last-dim layout."""
    lt, rb = distance[..., :2], distance[..., 2:]
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1)
    return torch.cat([x1y1, x2y2], -1)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: float) -> torch.Tensor:
    """xyxy boxes -> ltrb distances, clamped to [0, reg_max - 0.01]."""
    x1y1, x2y2 = bbox[..., :2], bbox[..., 2:]
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1).clamp(0, reg_max - 0.01)


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh / 2
    return torch.cat([xy - half, xy + half], -1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    x1y1, x2y2 = x[..., :2], x[..., 2:4]
    return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1)


def bbox_iou_ciou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete-IoU of broadcastable xyxy boxes (last dim 4) -> broadcast shape.

    The aspect-ratio coupling ``alpha`` is a constant (detached), as in the
    JAX package (``stop_gradient``) and the reference (``torch.no_grad``).
    The JAX package's planar (4, B, A) variant is a TPU layout device with
    the same values.
    """
    b1_x1, b1_y1, b1_x2, b1_y2 = box1.unbind(-1)
    b2_x1, b2_y1, b2_x2, b2_y2 = box2.unbind(-1)
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp_min(0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp_min(0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    c2 = cw**2 + ch**2 + eps
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
    v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)
