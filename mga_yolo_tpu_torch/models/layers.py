"""Building blocks of the YOLOv8/MGA graph in PyTorch (NCHW).

Counterpart of ``mga_yolo_tpu/models/layers.py``. Attribute names follow the
reference state_dict (``cv1.conv.weight``, ``m.0.cv2.bn.running_var``, ...)
so converted weights load with ``strict=True``.

The virtual-concat 1x1 (ConvBNSum) and the separable SPPF pool of the JAX
package's train mode are TPU memory devices: they compute what concat +
1x1 conv and one k x k pool compute, which is what these modules do in both
modes. Train mode differs from PyTorch's default only in the BatchNorm's
running variance (:class:`BatchNorm2d`), and, with a process group of two
or more, in its statistics: those of the global batch. Under a mesh that
splits rows (``parallel/spatial.py``) each conv and pool runs on the rank's
band of rows with the halo it needs, and a resize must be an identity.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mga_yolo_tpu_torch import parallel
from mga_yolo_tpu_torch.parallel import spatial

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

    With a process group of two or more ranks (``parallel.active()``), train
    mode normalises with the statistics of the global batch, as the JAX
    package's BatchNorm over a batch sharded on the data axis does:
    :class:`SyncBatchNormFn`. Every rank then makes the same running update.
    """

    def __init__(self, c: int, affine: bool = True):
        super().__init__(c, eps=BN_EPS, momentum=BN_MOMENTUM, affine=affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if parallel.active():
            return self._forward_global(x)
        self.num_batches_tracked.add_(1)
        n = x.numel() // x.shape[1]
        new = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, new, self.weight, self.bias, True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.mul_((1.0 - self.momentum) / n).add_(new, alpha=(n - 1) / n)
        return y

    def _forward_global(self, x: torch.Tensor) -> torch.Tensor:
        self.num_batches_tracked.add_(1)
        y, mean, var = SyncBatchNormFn.apply(x, self.weight, self.bias, self.eps)
        with torch.no_grad():  # flax's update, toward the biased variance
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return y


class SyncBatchNormFn(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of all ranks.

    ``(x, weight, bias, eps) -> (y, mean, var)``: per channel the global
    mean and *biased* variance, in two passes as one process computes them:
    the sum and count all-reduced, then the sum of squared deviations from
    the global mean (``E[x^2] - E[x]^2`` cancels at 640 px in bf16). The
    output and the backward follow the formulas of PyTorch's own CPU batch
    norm (``y = x * a + c``; ``dx = (dy - sum(dy)/n - (x - mean) * sum((x -
    mean) * dy) * invstd^2/n) * invstd * weight``), and the backward
    all-reduces its two per-channel sums. The affine gradients stay this
    rank's; the train step sums them over the ranks with every other
    gradient. Three collectives a layer and micro-step. ``weight`` and
    ``bias`` may be None.

    The arithmetic is in float32, and in float64 for a float32 input on the
    card. One process there runs cuDNN's fused BatchNorm, which rounds each
    output once; these formulas in float32 round several times an element,
    which puts a float32 step of the flagship at 640 px several times
    further from the same step in float64 than cuDNN does (root-mean-square
    over the parameters; ``chip_smoke.py`` ``[ddp]`` holds it within 2x).
    On the CPU they are what its one-process BatchNorm computes.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        C = x.shape[1]
        acc = _acc_dtype(x)
        xf = x.to(acc)
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, C] + [1] * (x.dim() - 2)
        s = torch.cat([xf.sum(dims), xf.new_full((1,), x.numel() // C)])
        parallel.all_reduce_sum_([s])
        n = s[C]
        mean = s[:C] / n
        d = xf - mean.view(shape)
        m2 = (d * d).sum(dims)
        parallel.all_reduce_sum_([m2])
        var = m2 / n
        invstd = torch.rsqrt(var + eps)
        a = invstd if weight is None else invstd * weight.to(acc)
        c = -mean * a if bias is None else bias.to(acc) - mean * a
        y = xf * a.view(shape) + c.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean.float(), var.float()

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        C = x.shape[1]
        acc = _acc_dtype(x)
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, C] + [1] * (x.dim() - 2)
        g = dy.to(acc)
        d = x.to(acc) - mean.view(shape)
        local = torch.stack([g.sum(dims), (d * g).sum(dims)])  # (2, C): this rank's sum(dy), sum((x - mean) * dy)
        dweight = dbias = None
        if weight is not None and ctx.needs_input_grad[1]:
            dweight = (local[1] * invstd).to(weight.dtype)
        if weight is not None and ctx.needs_input_grad[2]:
            dbias = local[0].to(weight.dtype)
        glob = local.clone()
        parallel.all_reduce_sum_([glob])
        k = glob[1] * invstd * invstd / n
        scale = invstd if weight is None else invstd * weight.to(acc)
        dx = (g - (glob[0] / n).view(shape) - d * k.view(shape)) * scale.view(shape)
        return dx.to(x.dtype), dweight, dbias, None


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """:class:`SyncBatchNormFn`'s arithmetic type for ``x``."""
    return torch.float64 if x.dtype == torch.float64 or (x.is_cuda and x.dtype == torch.float32) else torch.float32


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
        return self.act(self.bn(spatial.conv(self.conv, x)))


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
            outs.append(spatial.max_pool2d(outs[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(outs, 1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (reference nn.Upsample(None, 2, 'nearest'))."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_bilinear(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize to (H, W), half-pixel centres (align_corners=False).

    ``jax.image.resize`` antialiases when it shrinks an axis, so does this.
    Under a mesh that splits rows only the identity is allowed.
    """
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    _no_resize_under_mesh(x, hw)
    shrink = hw[0] < x.shape[-2] or hw[1] < x.shape[-1]
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False, antialias=shrink)


def resize_nearest(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize to (H, W) with half-pixel centres, as ``jax.image.resize``
    'nearest' (PyTorch's ``"nearest"`` mode floors without the half pixel).
    Under a mesh that splits rows only the identity is allowed."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    _no_resize_under_mesh(x, hw)
    return F.interpolate(x, size=hw, mode="nearest-exact")


def _no_resize_under_mesh(x: torch.Tensor, hw: tuple[int, int]) -> None:
    """Raise under a mesh that splits rows: a band cannot be resized on its
    own (every resize of the model and the losses is an identity there)."""
    if parallel.mesh() is not None:
        raise ValueError(f"a resize of {tuple(x.shape[-2:])} to {tuple(hw)} under a mesh that splits rows: "
                         "only the identity is supported")
