"""Fused masked average + max pooling: kernel wrapper and its plain version.

``masked_pool(x, m)`` takes NCHW features x (B, C, H, W) and mask
probabilities m (B, 1, H, W) of the same spatial size, and returns the two
descriptors (avg, max), each (B, C) in x's type: the masked average with the
tiny-mask GAP blend (``valid = sum(m) / N >= tiny_thr``, else the plain
spatial mean) and the masked max over pixels with m > 0.5, with the GAP
fallback where no pixel has m > 0.5. Counterpart of the JAX package's
``masked_pool_fused`` (``ops/pallas/masked_pool.py``).

Kernel: ``csrc/masked_pool.cu``, which replaces the TPU kernel
``mga_yolo_tpu/ops/pallas/masked_pool.py`` ``_kernel`` and its ``_combine``:
one device kernel per call, whose blocks each own ``tile`` channels of one
image over their whole planes (no workspace, no counter); :func:`pool_plan`
picks ``tile`` and the warps per channel. It reads x and m once and does a
few operations per element, so its bound is the bytes (B*N*C + B*N elements
in, 2*B*C out) over the card's memory rate. A CUDA tensor launches the
kernel (or raises); a CPU tensor takes :func:`masked_pool_ref`. The kernel's
gradient is :func:`masked_pool_bwd_ref`, the analytic VJP of the JAX
package's ``_bwd`` (it has no backward kernel either). ``launches`` counts
kernel launches.

Types: both routes sum in float32 and cast the descriptors to x's type, in
eval and under autograd alike. The JAX package's ``"auto"`` mode takes the
fused pool only in eval and, under grad, ``masked_avg_pool``, which sums in
the feature type; in float32 the two routes agree, so the parity tests build
the JAX model with ``use_pallas=True`` and both sides go through
``masked_pool_fused`` and its ``_bwd``.
"""

from __future__ import annotations

import ctypes

import torch

NEG = -3.0e38  # masked-max sentinel (finfo(f32).min rounds badly in bf16)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _reductions(x: torch.Tensor, m: torch.Tensor):
    """(B, C, N) float32 features, (B, 1, N) float32 mask -> msum (B, 1),
    wsum, gsum, mmax (B, C), sel (B, 1, N), cnt (B, 1)."""
    msum = m.sum(-1)
    wsum = (x * m).sum(-1)
    gsum = x.sum(-1)
    sel = m > 0.5
    mmax = torch.where(sel, x, NEG).amax(-1)
    return msum, wsum, gsum, mmax, sel, sel.float().sum(-1)


def combine(msum, wsum, gsum, mmax, cnt, N: int, tiny_thr: float = 1e-4, eps: float = 1e-6):
    """The JAX package's ``_combine``: the five reductions over N pixels ->
    the float32 (avg, max) descriptors, with the tiny-mask and no-pixel GAP
    fallbacks."""
    gap = gsum / N
    mavg = wsum / msum.clamp_min(eps)
    valid = (msum / N >= tiny_thr).float()
    return mavg * valid + gap * (1.0 - valid), torch.where(cnt > 0, mmax, gap)


def pool_f32(x: torch.Tensor, m: torch.Tensor, tiny_thr: float = 1e-4, eps: float = 1e-6):
    """Plain version's float32 (avg, max) descriptors, (B, C) each; the CAM
    gate's plain version shares it."""
    B, C, H, W = x.shape
    N = H * W
    msum, wsum, gsum, mmax, _, cnt = _reductions(x.reshape(B, C, N).float(), m.reshape(B, 1, N).float())
    return combine(msum, wsum, gsum, mmax, cnt, N, tiny_thr, eps)


def masked_pool_ref(x: torch.Tensor, m: torch.Tensor, tiny_thr: float = 1e-4, eps: float = 1e-6):
    """Plain version: the five reductions in float32, the blend, then the
    descriptors cast to x's type."""
    avg, mx = pool_f32(x, m, tiny_thr, eps)
    return avg.to(x.dtype), mx.to(x.dtype)


def masked_pool_bwd_ref(x, m, g_avg, g_max, tiny_thr: float = 1e-4, eps: float = 1e-6):
    """Analytic (dx, dm) of :func:`masked_pool_ref` for cotangents g_avg and
    g_max (B, C); either may be None (no gradient through that output).

    The JAX package's ``_bwd``: the average spreads g_avg / max(msum, eps)
    over the mask (or g_avg / N over all pixels when the mask is tiny) and
    gives the mask (x - avg) . g_avg / max(msum, eps); the max splits g_max
    evenly over its tied argmax pixels (or g_max / N over all pixels when no
    pixel has m > 0.5)."""
    B, C, H, W = x.shape
    N = H * W
    x32 = x.reshape(B, C, N).float()
    m32 = m.reshape(B, 1, N).float()
    msum, wsum, _, mmax, sel, cnt = _reductions(x32, m32)
    dx = torch.zeros_like(x32)
    dm = torch.zeros_like(m32)
    if g_avg is not None:
        ga = g_avg.float()
        denom = msum.clamp_min(eps)
        v = (msum / N >= tiny_thr).float()[:, :, None]            # (B, 1, 1)
        ga_d = (ga / denom)[:, :, None]                            # (B, C, 1)
        dx = dx + v * m32 * ga_d + (1.0 - v) * (ga[:, :, None] / N)
        dm = v * ((x32 - (wsum / denom)[:, :, None]) * ga_d).sum(1, keepdim=True)
    if g_max is not None:
        gm = g_max.float()[:, :, None]
        is_max = sel & (x32 == mmax[:, :, None])
        n_ties = is_max.float().sum(-1, keepdim=True).clamp_min(1.0)
        any_sel = (cnt > 0)[:, :, None]
        dx = dx + torch.where(any_sel & is_max, gm / n_ties, 0.0) + torch.where(any_sel, 0.0, gm / N)
    return dx.reshape(x.shape).to(x.dtype), dm.reshape(m.shape).to(m.dtype)


def check_pool_inputs(op: str, x: torch.Tensor, m: torch.Tensor) -> None:
    """Raise on features and mask the kernels cannot take: not (B, C,
    H, W) and (B, 1, H, W), other types or devices, empty, or H*W planes that
    are not contiguous (NCHW; batch and channel strides go to the kernel)."""
    if x.dim() != 4:
        raise ValueError(f"{op}: x must be (B, C, H, W), got {tuple(x.shape)}")
    B, C, H, W = x.shape
    if tuple(m.shape) != (B, 1, H, W):
        raise ValueError(f"{op}: m must be {(B, 1, H, W)}, got {tuple(m.shape)}")
    if m.dtype != x.dtype or m.device != x.device:
        raise ValueError(f"{op}: m is {m.dtype} on {m.device}, x is {x.dtype} on {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{op}: kernel takes float32 or bfloat16, got {x.dtype}")
    if H * W == 0 or B == 0 or C == 0:
        raise ValueError(f"{op}: empty input")
    for name, t in (("x", x), ("m", m)):
        if t.stride(3) != 1 or t.stride(2) != W:
            raise ValueError(f"{op}: {name} needs contiguous H*W planes, strides {t.stride()}")


WARPS = 8             # warps a block of the kernel (256 threads)
BLOCKS_PER_SM = 2     # what the grid aims at
MAX_TILE = 64         # channels a block, at most (the kernel's partial slots)


def pool_plan(B: int, C: int, n_sm: int) -> tuple[int, int, int]:
    """Launch plan of a call on B images of C channels (any plane size) on a
    card of ``n_sm`` SMs: (tile, warps per channel, blocks). Block i takes image i // tiles and channels
    [(i % tiles) * tile, + tile), tiles = ceil(C / tile). ``tile`` is the
    smallest power of two that keeps the grid within BLOCKS_PER_SM blocks
    per SM (at most MAX_TILE, and no wider than C needs); a tile of
    fewer than WARPS channels gives each channel WARPS // tile warps, which
    split its pixels, and a wider one gives each warp tile // WARPS channels
    in turn."""
    target = BLOCKS_PER_SM * n_sm
    tile = 1
    while tile < MAX_TILE and tile < C and B * -(-C // tile) > target:
        tile *= 2
    return tile, max(1, WARPS // tile), B * -(-C // tile)


_lib = None


def _library():
    """The built library, its entry point typed once."""
    global _lib
    if _lib is None:
        from mga_yolo_tpu_torch.kernels import _build

        lib = _build.load("masked_pool")
        lib.masked_pool_launch.restype = ctypes.c_int
        lib.masked_pool_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
            + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3
        )
        _lib = lib
    return _lib


def _launch(x: torch.Tensor, m: torch.Tensor, tiny_thr: float, eps: float):
    global launches
    from mga_yolo_tpu_torch.kernels import _build

    lib = _library()
    B, C, H, W = x.shape
    tile, wpc, _ = pool_plan(B, C, torch.cuda.get_device_properties(x.device).multi_processor_count)
    with torch.cuda.device(x.device):
        avg = torch.empty((B, C), dtype=x.dtype, device=x.device)
        mx = torch.empty((B, C), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.masked_pool_launch(
            DTYPES[x.dtype], x.data_ptr(), m.data_ptr(), x.stride(0), x.stride(1), m.stride(0),
            B, C, H * W, tile, wpc, tiny_thr, eps, avg.data_ptr(), mx.data_ptr(), stream,
        )
    _build.check(err, "masked_pool_launch")
    launches += 1
    return avg, mx


class _MaskedPool(torch.autograd.Function):
    """Forward: the kernel. Backward: :func:`masked_pool_bwd_ref` on the
    saved inputs; an output that takes no part in the loss gets None."""

    @staticmethod
    def forward(ctx, x, m, tiny_thr, eps):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, m)
        ctx.consts = (tiny_thr, eps)
        return _launch(x, m, tiny_thr, eps)

    @staticmethod
    def backward(ctx, g_avg, g_max):
        x, m = ctx.saved_tensors
        dx, dm = masked_pool_bwd_ref(x, m, g_avg, g_max, *ctx.consts)
        return (dx if ctx.needs_input_grad[0] else None, dm if ctx.needs_input_grad[1] else None,
                None, None)


def masked_pool(x: torch.Tensor, m: torch.Tensor, tiny_thr: float = 1e-4, eps: float = 1e-6):
    """(B, C, H, W) features x (B, 1, H, W) mask probabilities -> (avg, max)
    descriptors (B, C) in x's type, differentiable on both devices."""
    if x.device.type == "cpu":
        return masked_pool_ref(x, m, tiny_thr, eps)
    if x.device.type != "cuda":
        raise ValueError(f"masked_pool: no kernel for device {x.device}")
    check_pool_inputs("masked_pool", x, m)
    return _MaskedPool.apply(x, m, tiny_thr, eps)
