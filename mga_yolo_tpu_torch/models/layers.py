"""Building blocks of the YOLOv8/MGA graph in PyTorch (NCHW).

Counterpart of ``mga_yolo_tpu/models/layers.py``. Attribute names follow the
reference state_dict (``cv1.conv.weight``, ``m.0.cv2.bn.running_var``, ...)
so converted weights load with ``strict=True``.

The virtual-concat 1x1 (ConvBNSum) and the separable SPPF pool of the JAX
package's train mode are TPU memory devices: they compute what concat +
1x1 conv and one k x k pool compute, which is what these modules do in both
modes. Train mode differs from PyTorch's default only in the BatchNorm's
running variance (:class:`BatchNorm2d`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3  # reference initialize_weights sets eps=1e-3 on every BatchNorm2d
BN_MOMENTUM = 0.03  # torch convention; flax's momentum=0.97


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm whose train-mode update follows the JAX package (flax).

    flax moves ``running_var`` toward the *biased* batch variance,
    ``torch.nn.BatchNorm2d`` toward the unbiased one, n/(n-1) times larger
    (n = B*H*W values per channel: 8/7 at P5 of a 64 px batch of 2). After
    PyTorch's own update, made on a copy, this rescales its variance term to
    the biased one:
    new = (1-m)*old + m*n/(n-1)*var  ->  (1-m)*old + m*var
        = new*(n-1)/n + (1-m)*old/n,
    a few (C,) operations and no second pass over the activations. (The
    copy matters: autograd saves the variance tensor that batch_norm
    updates.) Keys, eval mode and normalisation are PyTorch's.
    """

    def __init__(self, c: int, affine: bool = True):
        super().__init__(c, eps=BN_EPS, momentum=BN_MOMENTUM, affine=affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        n = x.numel() // x.shape[1]
        new = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, new, self.weight, self.bias, True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.mul_((1.0 - self.momentum) / n).add_(new, alpha=(n - 1) / n)
        return y


def autopad(k: int, p: int | None = None, d: int = 1) -> int:
    """Symmetric 'same' padding k//2 (reference conv.py autopad)."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


class ConvBN(nn.Module):
    """Conv2d (no bias) + BatchNorm + SiLU: the reference's ``Conv``.

    After :func:`mga_yolo_tpu_torch.utils.model_utils.fuse_model` the BN is
    folded into ``conv`` (which then has a bias) and ``bn`` is an Identity.
    """

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, d: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), dilation=d, groups=g, bias=False)
        self.bn = BatchNorm2d(c2)
        self.act = nn.SiLU() if act else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class DWConv(ConvBN):
    """Depthwise ConvBN with ``g = gcd(c1, c2)`` (reference conv.py DWConv)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, act: bool = True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


class Bottleneck(nn.Module):
    """Standard bottleneck (reference block.py Bottleneck)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: tuple[int, int] = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, k[0], 1)
        self.cv2 = ConvBN(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with 2 convs (reference block.py C2f); inner e=1.0."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * self.c, 1, 1)
        self.cv2 = ConvBN((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(
            Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).split((self.c, self.c), 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class C3(nn.Module):
    """CSP bottleneck with 3 convs (reference block.py C3 / C3k).

    ``k_inner=None`` gives plain C3's (1, 3) bottlenecks; an int gives C3k's
    square (k, k) ones.
    """

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, k_inner: int | None = None):
        super().__init__()
        c_ = int(c2 * e)
        kk = (1, 3) if k_inner is None else (k_inner, k_inner)
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c1, c_, 1, 1)
        self.cv3 = ConvBN(2 * c_, c2, 1)
        self.m = nn.ModuleList(Bottleneck(c_, c_, shortcut, g, k=kk, e=1.0) for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        for m in self.m:
            a = m(a)
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class C3k2(C2f):
    """C2f whose inner blocks are C3k (c3k=True) or e=0.5 Bottlenecks
    (c3k=False; not the e=1.0 of C2f) — reference block.py C3k2."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5,
                 g: int = 1, shortcut: bool = True):
        super().__init__(c1, c2, n, shortcut, g, e)
        c = self.c
        self.m = nn.ModuleList(
            C3(c, c, 2, shortcut, g, k_inner=3) if c3k
            else Bottleneck(c, c, shortcut, g, k=(3, 3), e=0.5)
            for _ in range(n)
        )


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: three chained k x k max-pools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBN(c1, c_, 1, 1)
        self.cv2 = ConvBN(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(F.max_pool2d(outs[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(outs, 1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (reference nn.Upsample(None, 2, 'nearest'))."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_bilinear(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize to (H, W), half-pixel centres (align_corners=False).

    ``jax.image.resize`` antialiases when it shrinks an axis, so does this.
    """
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    shrink = hw[0] < x.shape[-2] or hw[1] < x.shape[-1]
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False, antialias=shrink)


def resize_nearest(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize to (H, W) with half-pixel centres, as ``jax.image.resize``
    'nearest' (PyTorch's ``"nearest"`` mode floors without the half pixel)."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=hw, mode="nearest-exact")
