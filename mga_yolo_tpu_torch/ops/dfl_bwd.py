"""Fused DFL decode + CE backward: kernel wrapper and its plain PyTorch version.

``dfl_decode_ce_bwd(pd, ltrb, g_ltrb, g_ce, target)`` takes the logits pd
(B, A, 4, R) (float32 or bfloat16), the decoded expectation ltrb, its
cotangent g_ltrb and the DFL target (each (B, A, 4) float32, any strides)
and the per-anchor CE cotangent g_ce (B, A) float32, and returns

    dz = p*((j - ltrb)*g_ltrb + g_ce/4) - q*g_ce/4,   p = softmax(pd, -1),
    q = wl*onehot(tl) + (1-wl)*onehot(tl+1), t = clip(target, 0, R-1-0.01),
    tl = floor(t), wl = tl+1-t

in pd's shape and dtype: the gradient of ``(decode(pd), dfl_ce(pd, target))``
(``losses/detection.py`` ``DflDecodeCE``).

Kernel: ``csrc/dfl_bwd.cu``, which replaces both TPU kernels of
``mga_yolo_tpu/ops/pallas/dfl_bwd.py`` (``_kernel`` with (B, A, 4) aux and
``_kernel_planar`` with planar (4, B, A) aux): the aux tensors go in with
their own strides, so ``t.permute(1, 2, 0)`` of a planar tensor launches it
without a copy. It reads pd and writes dz once, so its bound is those bytes
over the card's memory rate. A CUDA tensor launches the kernel (or raises);
a CPU tensor takes :func:`dfl_decode_ce_bwd_ref`. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
REG_MAX = (8, 16, 32, 64)  # the kernel's template instances

launches = 0


def dfl_decode_ce_bwd_ref(pd, ltrb, g_ltrb, g_ce, target) -> torch.Tensor:
    """Plain version: the jnp branch of ``_dfl_decode_ce_bwd``, op for op."""
    R = pd.shape[-1]
    proj = torch.arange(R, dtype=torch.float32, device=pd.device)
    t = target.float().clamp(0, R - 1 - 0.01)
    tl = t.floor()
    wl = (tl + 1.0) - t
    idx = proj.expand(*t.shape, R)
    q = (torch.where(idx == tl[..., None], wl[..., None], 0.0)
         + torch.where(idx == tl[..., None] + 1.0, (1.0 - wl)[..., None], 0.0))
    p = torch.softmax(pd.float(), -1)
    gs = (g_ce.float() / 4.0)[..., None, None]
    dz = p * ((proj - ltrb.float()[..., None]) * g_ltrb.float()[..., None] + gs) - q * gs
    return dz.to(pd.dtype)


def _check(pd, ltrb, g_ltrb, g_ce, target) -> None:
    if pd.dim() != 4 or pd.shape[2] != 4:
        raise ValueError(f"dfl_bwd: pd must be (B, A, 4, R), got {tuple(pd.shape)}")
    B, A, _, R = pd.shape
    if R not in REG_MAX:
        raise ValueError(f"dfl_bwd: the kernel takes R in {REG_MAX}, got {R}")
    if pd.dtype not in DTYPES:
        raise TypeError(f"dfl_bwd: kernel takes float32 or bfloat16 pd, got {pd.dtype}")
    if not pd.is_contiguous() or pd.data_ptr() % 16:
        raise ValueError("dfl_bwd: pd must be contiguous and 16-byte aligned")
    for name, t, shape in (("ltrb", ltrb, (B, A, 4)), ("g_ltrb", g_ltrb, (B, A, 4)),
                           ("target", target, (B, A, 4)), ("g_ce", g_ce, (B, A))):
        if tuple(t.shape) != shape:
            raise ValueError(f"dfl_bwd: {name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"dfl_bwd: {name} must be float32, got {t.dtype}")
        if t.device != pd.device:
            raise ValueError(f"dfl_bwd: {name} is on {t.device}, pd on {pd.device}")


def _launch(pd, ltrb, g_ltrb, g_ce, target) -> torch.Tensor:
    global launches
    from mga_yolo_tpu_torch.kernels import _build

    lib = _build.load("dfl_bwd")
    lib.dfl_bwd_launch.restype = ctypes.c_int
    lib.dfl_bwd_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2
        + ([ctypes.c_void_p] + [ctypes.c_longlong] * 3) * 3
        + [ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    )
    B, A, _, R = pd.shape
    with torch.cuda.device(pd.device):
        dz = torch.empty_like(pd, memory_format=torch.contiguous_format)
        stream = torch.cuda.current_stream(pd.device).cuda_stream
        err = lib.dfl_bwd_launch(
            DTYPES[pd.dtype], R, B, A, pd.data_ptr(), dz.data_ptr(),
            ltrb.data_ptr(), *ltrb.stride(), g_ltrb.data_ptr(), *g_ltrb.stride(),
            target.data_ptr(), *target.stride(), g_ce.data_ptr(), *g_ce.stride(), stream,
        )
    _build.check(err, "dfl_bwd_launch")
    launches += 1
    return dz


def dfl_decode_ce_bwd(pd, ltrb, g_ltrb, g_ce, target) -> torch.Tensor:
    """dz (B, A, 4, R) in pd's dtype; aux (B, A, 4) / (B, A) float32 of any strides."""
    if pd.device.type == "cpu":
        return dfl_decode_ce_bwd_ref(pd, ltrb, g_ltrb, g_ce, target)
    if pd.device.type != "cuda":
        raise ValueError(f"dfl_bwd: no kernel for device {pd.device}")
    _check(pd, ltrb, g_ltrb, g_ce, target)
    return _launch(pd, ltrb, g_ltrb, g_ce, target)
