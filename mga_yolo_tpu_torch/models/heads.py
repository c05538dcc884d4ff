"""Detection and mask heads (counterpart of ``models/heads.py``), NCHW.

* :class:`MGAMaskHead` — 1x1 conv -> BN -> SiLU -> 3x3 conv to mask logits at
  feature resolution (keys ``proj.0``, ``proj.1``, ``head``).
* :class:`Detect` — anchor-free DFL head. ``forward`` returns, in eval
  mode, ``(decoded (B, A, 4+nc), maps)``: xywh in input pixels ++ sigmoid
  class probabilities, and the raw per-level maps (B, 4*reg_max+nc, H, W);
  in train mode the maps alone. Under a mesh that splits rows the maps are
  gathered whole over the space ranks first (``parallel.spatial.gather_rows``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from mga_yolo_tpu_torch import parallel
from mga_yolo_tpu_torch.models.layers import BatchNorm2d, ConvBN, DWConv
from mga_yolo_tpu_torch.parallel import spatial
from mga_yolo_tpu_torch.ops.boxes import dist2bbox, make_anchors


class MGAMaskHead(nn.Module):
    """Lightweight coarse mask head producing logits at feature resolution."""

    def __init__(self, c1: int, hidden: int, out_ch: int = 1):
        super().__init__()
        self.proj = nn.Sequential(
            nn.Conv2d(c1, hidden, 1, bias=False),
            BatchNorm2d(hidden),
            nn.SiLU(),
        )
        self.head = nn.Conv2d(hidden, out_ch, 3, padding=1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return spatial.conv(self.head, self.proj(x))


class DFL(nn.Module):
    """Distribution-focal expectation: (B, A, 4*reg_max) -> (B, A, 4).

    ``conv.weight`` is the fixed ``arange(reg_max)`` projection the reference
    keeps as a frozen 1x1 conv; it is read as the projection vector.
    """

    def __init__(self, reg_max: int = 16):
        super().__init__()
        self.reg_max = reg_max
        self.conv = nn.Conv2d(reg_max, 1, 1, bias=False).requires_grad_(False)
        with torch.no_grad():
            self.conv.weight.copy_(torch.arange(reg_max, dtype=torch.float32).view(1, reg_max, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, a, _ = x.shape
        x = x.reshape(b, a, 4, self.reg_max)
        proj = self.conv.weight.reshape(self.reg_max).to(x.dtype)
        return (x.softmax(-1) * proj).sum(-1)


class Detect(nn.Module):
    """YOLOv8/11 anchor-free detection head.

    ``legacy=False`` (every MGA graph, which uses C3k2) gives the DWConv
    class branch: cv3.{l} = [[DWConv, ConvBN 1x1], [DWConv, ConvBN 1x1], conv].
    """

    def __init__(self, nc: int, ch: Sequence[int], strides: Sequence[int],
                 legacy: bool = False, reg_max: int = 16):
        super().__init__()
        self.nc, self.reg_max = nc, reg_max
        self.strides = tuple(int(s) for s in strides)
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(ConvBN(x, c2, 3), ConvBN(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1))
            for x in ch
        )
        if legacy:
            self.cv3 = nn.ModuleList(
                nn.Sequential(ConvBN(x, c3, 3), ConvBN(c3, c3, 3), nn.Conv2d(c3, nc, 1))
                for x in ch
            )
        else:
            self.cv3 = nn.ModuleList(
                nn.Sequential(
                    nn.Sequential(DWConv(x, x, 3), ConvBN(x, c3, 1)),
                    nn.Sequential(DWConv(c3, c3, 3), ConvBN(c3, c3, 1)),
                    nn.Conv2d(c3, nc, 1),
                )
                for x in ch
            )
        self.dfl = DFL(reg_max)
        with torch.no_grad():  # reference bias_init, as the JAX package initialises them
            for box, cls, s in zip(self.cv2, self.cv3, self.strides):
                box[-1].bias.fill_(1.0)
                cls[-1].bias.fill_(math.log(5 / nc / (640 / s) ** 2))

    def forward(self, xs: Sequence[torch.Tensor]):
        """Train mode: the raw maps. Eval mode: ``(decoded, maps)``."""
        maps = [torch.cat([self.cv2[i](x), self.cv3[i](x)], 1) for i, x in enumerate(xs)]
        if parallel.mesh() is not None:  # every anchor of the images, for the loss and the decode
            maps = spatial.gather_rows(maps)
        if self.training:
            return maps
        return self.decode(maps), maps

    def decode(self, maps: Sequence[torch.Tensor]) -> torch.Tensor:
        """(B, A, 4+nc): xywh in input-image pixels ++ sigmoid(cls)."""
        b = maps[0].shape[0]
        no = 4 * self.reg_max + self.nc
        flat = torch.cat([m.reshape(b, no, -1) for m in maps], 2).transpose(1, 2)
        box, cls = flat[..., : 4 * self.reg_max], flat[..., 4 * self.reg_max:]
        shapes = [tuple(m.shape[-2:]) for m in maps]
        anchors, stride_t = make_anchors(shapes, self.strides, 0.5, dtype=flat.dtype, device=flat.device)
        dbox = dist2bbox(self.dfl(box), anchors[None], xywh=True) * stride_t[None]
        return torch.cat([dbox, cls.sigmoid()], -1)
