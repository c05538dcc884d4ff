"""The masked pool's five reductions, without the combine: kernel wrapper.

``masked_reductions(x, m)`` takes NCHW features x (B, C, H, W) and mask
probabilities m (B, 1, H, W), float32 or bfloat16, and returns, in float32,
``msum`` (B, 1) = sum m, ``wsum`` (B, C) = sum x*m, ``gsum`` (B, C) = sum x,
``mmax`` (B, C) = max of x over the pixels with m > 0.5 (-3e38 where there
is none) and ``cnt`` (B, 1) = the number of those pixels. These are what
the TPU kernel ``mga_yolo_tpu/ops/pallas/masked_pool.py`` ``_kernel``
writes before ``_combine``. The spatial mesh takes them on each rank's band
of rows and sums and maxes them over the ranks before the combine
(``parallel/spatial.py``).

Kernel: ``csrc/masked_pool.cu`` ``masked_reductions_launch``, the masked
pool's grid and row reduction (``ops.masked_pool.pool_plan``) with the
combine left out: one launch per call, no workspace. Its bound is the bytes
(B*N*C + B*N elements in, 3*B*C + 2*B float32 out) over the card's memory
rate. A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain ``ops.masked_pool._reductions``, its twin. ``launches`` counts kernel
launches. No gradient here: ``parallel.spatial.SpaceReductions`` carries it.
"""

from __future__ import annotations

import ctypes

import torch

from mga_yolo_tpu_torch.ops.masked_pool import DTYPES, _reductions, check_pool_inputs, pool_plan

launches = 0

_lib = None


def _library():
    """The masked pool's library, this entry point typed once."""
    global _lib
    if _lib is None:
        from mga_yolo_tpu_torch.kernels import _build

        lib = _build.load("masked_pool")
        lib.masked_reductions_launch.restype = ctypes.c_int
        lib.masked_reductions_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
            + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
        )
        _lib = lib
    return _lib


def masked_reductions_ref(x: torch.Tensor, m: torch.Tensor):
    """Plain version: ``ops.masked_pool._reductions`` on float32 copies."""
    B, C, H, W = x.shape
    msum, wsum, gsum, mmax, _, cnt = _reductions(x.reshape(B, C, H * W).float(), m.reshape(B, 1, H * W).float())
    return msum, wsum, gsum, mmax, cnt


def _launch(x: torch.Tensor, m: torch.Tensor):
    global launches
    from mga_yolo_tpu_torch.kernels import _build

    lib = _library()
    B, C, H, W = x.shape
    tile, wpc, _ = pool_plan(B, C, torch.cuda.get_device_properties(x.device).multi_processor_count)
    with torch.cuda.device(x.device):
        out = torch.empty((3 * B * C + 2 * B,), dtype=torch.float32, device=x.device)
        msum, cnt, wsum, gsum, mmax = out.split([B, B, B * C, B * C, B * C])
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.masked_reductions_launch(
            DTYPES[x.dtype], x.data_ptr(), m.data_ptr(), x.stride(0), x.stride(1), m.stride(0),
            B, C, H * W, tile, wpc, msum.data_ptr(), wsum.data_ptr(), gsum.data_ptr(), mmax.data_ptr(),
            cnt.data_ptr(), stream,
        )
    _build.check(err, "masked_reductions_launch")
    launches += 1
    return msum.view(B, 1), wsum.view(B, C), gsum.view(B, C), mmax.view(B, C), cnt.view(B, 1)


def masked_reductions(x: torch.Tensor, m: torch.Tensor):
    """(B, C, H, W) features x (B, 1, H, W) mask -> float32 msum (B, 1),
    wsum, gsum, mmax (B, C), cnt (B, 1)."""
    if x.device.type == "cpu":
        return masked_reductions_ref(x, m)
    if x.device.type != "cuda":
        raise ValueError(f"masked_reductions: no kernel for device {x.device}")
    check_pool_inputs("masked_reductions", x, m)
    return _launch(x, m)
