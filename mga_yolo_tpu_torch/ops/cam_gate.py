"""Fused CAM gate of MaskCBAM: kernel wrapper and its plain PyTorch version.

``cam_gate(x, m, w1, b1, w2, b2)`` takes NCHW features x (B, C, H, W), mask
probabilities m (B, 1, H, W) and the shared MLP in ``nn.Linear`` layout
(w1 (h, C), b1 (h), w2 (C, h), b2 (C)), and returns the channel gate
``sigmoid(mlp(avg) + mlp(max))`` (B, C) in float32, where avg is the masked
average with the tiny-mask GAP blend and max the masked max (pixels with
m > 0.5) with the GAP fallback.

Kernel: ``csrc/cam_gate.cu``, which replaces the TPU kernel
``mga_yolo_tpu/ops/pallas/masked_pool.py`` ``_cam_kernel_factory``: one
device kernel per call, whose blocks write float32 partial sums and whose
last block of each image, found by a counter, combines them and runs the
MLP. It reads x and m once and does a few operations per byte, so its bound
is the bytes (B*N*C + B*N elements) over the card's memory rate; see the
source for the design. Each launch takes B counters of its own from a ring
of zeroed int32 counters on the device, which the launch leaves at zero
(:class:`CounterRing` hands them out; a launch captured in a CUDA graph
keeps its counters for every replay, so the ring never hands them out
again). A
CUDA tensor launches the kernel (or raises); a CPU tensor takes
:func:`cam_gate_ref`. Under autograd the kernel's gradient is that of
:func:`cam_gate_ref`, recomputed in the backward. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import bisect
import ctypes
import threading

import torch
import torch.nn.functional as F

from mga_yolo_tpu_torch.ops.masked_pool import DTYPES, check_pool_inputs, pool_f32

launches = 0


def cam_gate_ref(x, m, w1, b1, w2, b2, tiny_thr: float = 1e-4, eps: float = 1e-6) -> torch.Tensor:
    """Plain version: the masked pool's float32 descriptors, then the MLP and sigmoid."""
    return gate_of(*pool_f32(x, m, tiny_thr, eps), w1, b1, w2, b2)


def gate_of(avg, mx, w1, b1, w2, b2) -> torch.Tensor:
    """sigmoid(mlp(avg) + mlp(max)) of the (B, C) descriptors, in float32."""
    def mlp(d):
        return F.linear(F.relu(F.linear(d, w1.float(), b1.float())), w2.float(), b2.float())

    return torch.sigmoid(mlp(avg) + mlp(mx))


def _check(x, m, w1, b1, w2, b2) -> None:
    check_pool_inputs("cam_gate", x, m)
    C, h = x.shape[1], w1.shape[0]
    want = {"w1": (h, C), "b1": (h,), "w2": (C, h), "b2": (C,)}
    for name, t in zip(want, (w1, b1, w2, b2)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"cam_gate: {name} must be {want[name]}, got {tuple(t.shape)}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"cam_gate: {name} is {t.dtype} on {t.device}, x is {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"cam_gate: {name} must be contiguous")


class CounterRing:
    """Offsets of blocks of counters in a ring of ``size``, taken in turn.

    An eager launch's counters are free again once the launch has ended, so
    the cursor wraps to 0 and hands them out anew after ``size / b`` further
    launches. A launch taken during CUDA-graph capture (``captured=True``)
    keeps its counters for every replay of the graph, which may run while an
    eager launch runs on another stream: its range stays reserved, and every
    take skips it, until :meth:`release` gives it back once the graph is
    destroyed.
    """

    def __init__(self, size: int):
        self.size = size
        self.cursor = 0
        self.reserved: list[tuple[int, int]] = []  # sorted, disjoint [start, end)

    def take(self, b: int, captured: bool = False) -> int:
        if not 0 < b <= self.size:
            raise ValueError(f"cam_gate: {b} counters do not fit a ring of {self.size}")
        off, wraps = self.cursor, 0
        while True:
            if off + b > self.size:
                off, wraps = 0, wraps + 1
                if wraps > 1:
                    raise RuntimeError("cam_gate: captured CUDA graphs hold the whole counter ring")
            i = bisect.bisect_right(self.reserved, (off + b, -1))  # ranges that start before off + b
            if i == 0 or self.reserved[i - 1][1] <= off:
                break
            off = self.reserved[i - 1][1]
        self.cursor = off + b
        if captured:
            bisect.insort(self.reserved, (off, off + b))
        return off

    def release(self, off: int) -> None:
        """Give back the captured range that starts at ``off``."""
        i = bisect.bisect_left(self.reserved, (off, -1))
        if i == len(self.reserved) or self.reserved[i][0] != off:
            raise ValueError(f"cam_gate: no captured counters at offset {off}")
        del self.reserved[i]


_lib = None
_RING = 1 << 20  # int32 counters of a device
_rings: dict[int, tuple[torch.Tensor, CounterRing]] = {}  # device index -> (counters, allocator)
_ring_lock = threading.Lock()
_ws_floats: dict[tuple, int] = {}


def _library():
    """The built library, its entry points typed once."""
    global _lib
    if _lib is None:
        from mga_yolo_tpu_torch.kernels import _build

        lib = _build.load("cam_gate")
        lib.cam_gate_workspace_floats.restype = ctypes.c_longlong
        lib.cam_gate_workspace_floats.argtypes = [ctypes.c_int] * 3
        lib.cam_gate_hold_counters.restype = ctypes.c_int
        lib.cam_gate_hold_counters.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.cam_gate_released.restype = ctypes.c_int
        lib.cam_gate_released.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
        lib.cam_gate_launch.restype = ctypes.c_int
        lib.cam_gate_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3
            + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 4
        )
        _lib = lib
    return _lib


def _counters(lib, device: torch.device, b: int, stream: int) -> int:
    """Address of b zeroed counters of the device's ring that no launch in
    flight holds (unless 2**20 / b eager launches are) and no living
    captured graph keeps. Counters taken during capture are tied to the
    graph on ``stream``, and come back to the ring once it is destroyed."""
    from mga_yolo_tpu_torch.kernels import _build

    capturing = torch.cuda.is_current_stream_capturing()
    with _ring_lock:
        entry = _rings.get(device.index)
        if entry is None:
            if capturing:
                raise RuntimeError("cam_gate: call it once on this device before capturing a CUDA graph")
            entry = _rings[device.index] = (torch.zeros(_RING, dtype=torch.int32, device=device),
                                            CounterRing(_RING))
            torch.cuda.synchronize(device)  # zeroed before a launch on any stream reads it
        counters, ring = entry
        for off in _released(lib):  # graphs of any device: the offset names its ring
            _rings[off >> 40][1].release(off & ((1 << 40) - 1))
        off = ring.take(b, captured=capturing)
        if capturing:
            _build.check(lib.cam_gate_hold_counters(stream, (device.index << 40) | off), "cam_gate_hold_counters")
    return counters.data_ptr() + 4 * off


def _released(lib) -> list[int]:
    """Offsets (device index << 40 | ring offset) of the counters of
    destroyed graphs, queued by the library since the last call."""
    out, buf = [], (ctypes.c_longlong * 64)()
    while True:
        n = lib.cam_gate_released(buf, len(buf))
        out += buf[:n]
        if n < len(buf):
            return out


def _launch(x, m, w1, b1, w2, b2, tiny_thr: float, eps: float) -> torch.Tensor:
    global launches
    from mga_yolo_tpu_torch.kernels import _build

    lib = _library()
    B, C, H, W = x.shape
    with torch.cuda.device(x.device):
        key = (x.device.index, B, C, H * W)
        if key not in _ws_floats:
            _ws_floats[key] = lib.cam_gate_workspace_floats(B, C, H * W)
        ws = torch.empty(_ws_floats[key], dtype=torch.float32, device=x.device)
        gate = torch.empty((B, C), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cam_gate_launch(
            DTYPES[x.dtype], x.data_ptr(), m.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), x.stride(0), x.stride(1), m.stride(0),
            B, C, H * W, w1.shape[0], tiny_thr, eps, ws.data_ptr(), _counters(lib, x.device, B, stream),
            gate.data_ptr(), stream,
        )
    _build.check(err, "cam_gate_launch")
    launches += 1
    return gate


class _CamGate(torch.autograd.Function):
    """Forward: the kernel. Backward: recompute :func:`cam_gate_ref` on the
    saved inputs and differentiate it, as the JAX package's ``_cam_bwd``
    does (it has no backward kernel: the gate's activations are O(B*C))."""

    @staticmethod
    def forward(ctx, x, m, w1, b1, w2, b2, tiny_thr, eps):
        ctx.save_for_backward(x, m, w1, b1, w2, b2)
        ctx.consts = (tiny_thr, eps)
        return _launch(x, m, w1, b1, w2, b2, tiny_thr, eps)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = cam_gate_ref(*inputs, *ctx.consts)
        grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], g))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None)


def cam_gate(x, m, w1, b1, w2, b2, tiny_thr: float = 1e-4, eps: float = 1e-6) -> torch.Tensor:
    """(B, C, H, W) features x (B, 1, H, W) mask probabilities -> (B, C) float32
    gate, differentiable on both devices."""
    if x.device.type == "cpu":
        return cam_gate_ref(x, m, w1, b1, w2, b2, tiny_thr, eps)
    if x.device.type != "cuda":
        raise ValueError(f"cam_gate: no kernel for device {x.device}")
    _check(x, m, w1, b1, w2, b2)
    return _CamGate.apply(x, m, w1, b1, w2, b2, tiny_thr, eps)
