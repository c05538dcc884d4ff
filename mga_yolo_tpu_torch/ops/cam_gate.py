"""Fused CAM gate of MaskCBAM: kernel wrapper and its plain PyTorch version.

``cam_gate(x, m, w1, b1, w2, b2)`` takes NCHW features x (B, C, H, W), mask
probabilities m (B, 1, H, W) and the shared MLP in ``nn.Linear`` layout
(w1 (h, C), b1 (h), w2 (C, h), b2 (C)), and returns the channel gate
``sigmoid(mlp(avg) + mlp(max))`` (B, C) in float32, where avg is the masked
average with the tiny-mask GAP blend and max the masked max (pixels with
m > 0.5) with the GAP fallback.

Kernel: ``csrc/cam_gate.cu``, which replaces the TPU kernel
``mga_yolo_tpu/ops/pallas/masked_pool.py`` ``_cam_kernel_factory``. It reads
x and m once and does a few operations per byte, so its bound is the bytes
(B*N*C + B*N elements) over the card's memory rate; see the source for the
design. A CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`cam_gate_ref`. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

NEG = -3.0e38  # masked-max sentinel (finfo(f32).min rounds badly in bf16)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def cam_gate_ref(x, m, w1, b1, w2, b2, tiny_thr: float = 1e-4, eps: float = 1e-6) -> torch.Tensor:
    """Plain version: the five reductions in float32, then the MLP and sigmoid."""
    B, C, H, W = x.shape
    N = H * W
    x32 = x.reshape(B, C, N).float()
    m32 = m.reshape(B, 1, N).float()
    msum = m32.sum(-1)                                   # (B, 1)
    wsum = (x32 * m32).sum(-1)                           # (B, C)
    gsum = x32.sum(-1)
    sel = m32 > 0.5
    mmax = torch.where(sel, x32, NEG).amax(-1)
    cnt = sel.float().sum(-1)                            # (B, 1)
    gap = gsum / N
    mavg = wsum / msum.clamp_min(eps)
    valid = (msum / N >= tiny_thr).float()
    avg = mavg * valid + gap * (1.0 - valid)
    mx = torch.where(cnt > 0, mmax, gap)

    def mlp(d):
        return F.linear(F.relu(F.linear(d, w1.float(), b1.float())), w2.float(), b2.float())

    return torch.sigmoid(mlp(avg) + mlp(mx))


def _check(x, m, w1, b1, w2, b2) -> None:
    if x.dim() != 4:
        raise ValueError(f"cam_gate: x must be (B, C, H, W), got {tuple(x.shape)}")
    B, C, H, W = x.shape
    h = w1.shape[0]
    want = {"m": (B, 1, H, W), "w1": (h, C), "b1": (h,), "w2": (C, h), "b2": (C,)}
    for name, t in zip(want, (m, w1, b1, w2, b2)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"cam_gate: {name} must be {want[name]}, got {tuple(t.shape)}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"cam_gate: {name} is {t.dtype} on {t.device}, x is {x.dtype} on {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"cam_gate: kernel takes float32 or bfloat16, got {x.dtype}")
    if H * W == 0 or B == 0:
        raise ValueError("cam_gate: empty input")
    # each channel's H*W pixels must be contiguous (NCHW); batch and channel
    # strides are passed to the kernel
    for name, t in (("x", x), ("m", m)):
        if t.stride(3) != 1 or t.stride(2) != W:
            raise ValueError(f"cam_gate: {name} needs contiguous H*W planes, strides {t.stride()}")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if not t.is_contiguous():
            raise ValueError(f"cam_gate: {name} must be contiguous")


def _launch(x, m, w1, b1, w2, b2, tiny_thr: float, eps: float) -> torch.Tensor:
    global launches
    from mga_yolo_tpu_torch.kernels import _build

    lib = _build.load("cam_gate")
    lib.cam_gate_pix_chunk.restype = ctypes.c_int
    lib.cam_gate_pix_chunk.argtypes = []
    lib.cam_gate_launch.restype = ctypes.c_int
    lib.cam_gate_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3
        + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3
    )
    B, C, H, W = x.shape
    N, hdim = H * W, w1.shape[0]
    splits = -(-N // lib.cam_gate_pix_chunk())
    with torch.cuda.device(x.device):
        ws = torch.empty(B * splits * (3 * C + 2), dtype=torch.float32, device=x.device)
        gate = torch.empty((B, C), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cam_gate_launch(
            DTYPES[x.dtype], x.data_ptr(), m.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), x.stride(0), x.stride(1), m.stride(0),
            B, C, N, hdim, tiny_thr, eps, ws.data_ptr(), gate.data_ptr(), stream,
        )
    _build.check(err, "cam_gate_launch")
    launches += 1
    return gate


def cam_gate(x, m, w1, b1, w2, b2, tiny_thr: float = 1e-4, eps: float = 1e-6) -> torch.Tensor:
    """(B, C, H, W) features x (B, 1, H, W) mask probabilities -> (B, C) float32 gate."""
    if x.device.type == "cpu":
        return cam_gate_ref(x, m, w1, b1, w2, b2, tiny_thr, eps)
    if x.device.type != "cuda":
        raise ValueError(f"cam_gate: no kernel for device {x.device}")
    _check(x, m, w1, b1, w2, b2)
    return _launch(x, m, w1, b1, w2, b2, tiny_thr, eps)
