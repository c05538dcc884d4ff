"""Box geometry for the eval decode and NMS (counterpart of ``ops/boxes.py``)."""

from __future__ import annotations

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


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh / 2
    return torch.cat([xy - half, xy + half], -1)
