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

All five are views of one float32 allocation: ``sums`` (B, 2C + 2) =
msum | wsum | gsum | cnt, then ``mmax`` (B, C) (:func:`reduction_buffers`
gives the two, :func:`views` the five), so the mesh all-reduces ``sums`` as
it is.

Kernel: ``csrc/masked_reductions.cu``, one launch per call, no workspace,
on one of two routes that :func:`reductions_plan` picks with the cut of the
work: blocks whose threads load a group of an image's channel rows and its
mask row straight into registers (at the band shapes, and wherever the rows
are not on 16 bytes), or blocks whose thread 0 (then a producer warp)
copies them into a ring of shared-memory stages with ``cp.async.bulk`` for
consumer warps to reduce (larger planes, several groups a block).
Its bound is the bytes (B*N*C + B*N elements in, 3*B*C + 2*B float32 out)
over the card's memory rate. A CUDA tensor launches the kernel (or raises);
a CPU tensor takes the plain :func:`reduction_buffers_ref` (on
``ops.masked_pool._reductions``). ``launches`` counts kernel launches. No
gradient here: ``parallel.spatial.SpaceReductions`` carries it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mga_yolo_tpu_torch.ops.masked_pool import DTYPES, _reductions, check_pool_inputs

launches = 0

WARPS = 8                 # consumer warps a block (and one producer warp on the bulk-copy route)
CONSUMERS = 32 * WARPS
MAX_STAGES = 4            # the ring's stages
MAX_SMEM = 232448         # dynamic shared memory a block may use on sm_90 (227 KB)
BLOCK_SMEM = 115712       # shared memory a block while BLOCKS_PER_SM fit an SM (228 KB, 1 KB a block reserved)
STAGE_BYTES = 16 * 1024   # what a stage holds: an item of a group's rows over a chunk of pixels
BLOCKS_PER_SM = 2         # blocks an SM that the groups aim at
MAX_GROUP = 1024          # channels a group, at most
MAX_GROUPS = 1 << 20      # groups a call, at most (the kernel finds a block's first in float32)
REGISTER_LOADS = 32       # 16-byte vectors of x a thread at most on the registers' route (kDirectI = 4 at once)
ELEMENTS, BULK, VECTORS = 0, 1, 2  # routes: to registers one element a load, cp.async.bulk, to registers 16 bytes a load


class Plan(NamedTuple):
    """A call's launch plan: ``q`` groups an image (group k of gsz + 1
    channels for k < grem, else gsz: C = q gsz + grem), chunks of ``L``
    pixels (``nch`` a plane), items of ``R`` rows of a chunk, ``S`` stages, ``M`` mask slots, ``grid``
    blocks (block i takes groups i, i + grid, ...), ``smem`` bytes of
    shared memory; the layout: ``gmax`` channels a group at most, ``tpc``
    consumer threads a row (``spr`` = tpc // 32 warps where tpc > 32), rows
    of ``pitch`` bytes, stages of ``stage`` bytes; ``route``: how the rows
    reach the threads (:data:`ELEMENTS`, :data:`BULK` or :data:`VECTORS`)."""

    q: int
    L: int
    nch: int
    R: int
    S: int
    M: int
    grid: int
    smem: int
    gmax: int
    tpc: int
    spr: int
    pitch: int
    stage: int
    route: int


def layout(C: int, q: int, N: int, L: int, R: int, S: int, M: int, itemsize: int) -> dict:
    """The kernel's ``Layout``: S stages of R rows of ``pitch`` bytes (a
    16-byte multiple), M mask slots of ``pitch`` bytes, 2 S + 4 mbarriers of
    8 bytes, then two sets of float partials (3 a slot, 2 a warp of a row
    for the mask); ``bytes`` in all. ``tpc``: the largest power of two with
    tpc R <= CONSUMERS; ``direct``: tpc <= 32 and a plane is one chunk or
    an item holds the group's whole rows (its threads keep their partials
    over the chunks), so a row's warp writes its channel's sums once its
    lanes have met."""
    gmax = -(-C // q)
    tpc = CONSUMERS
    while tpc > 1 and tpc * R > CONSUMERS:
        tpc //= 2
    direct = tpc <= 32 and (L == N or R >= gmax)
    spr = tpc // 32 if tpc > 32 else 1
    pitch = -(-L * itemsize // 16) * 16
    stage = R * pitch
    mask_off = S * stage
    bar_off = mask_off + M * pitch
    acc_off = bar_off + 8 * (2 * S + 4)
    acc_floats = 3 * gmax * spr + 2 * spr
    return dict(gmax=gmax, tpc=tpc, spr=spr, pitch=pitch, stage=stage, mask_off=mask_off, bar_off=bar_off,
                acc_off=acc_off, bytes=acc_off + 2 * acc_floats * 4, direct=direct)


def tma_rows(x_ptr: int, m_ptr: int, x_sb: int, x_sc: int, m_sb: int, N: int, itemsize: int) -> bool:
    """Whether every row may go by ``cp.async.bulk``: both bases, the batch
    and channel strides and the row length in bytes multiples of 16 (then
    chunks of a multiple of 16 bytes keep every copy so)."""
    return all(v % 16 == 0 for v in (x_ptr, m_ptr, x_sb * itemsize, x_sc * itemsize, m_sb * itemsize,
                                     N * itemsize))


@functools.lru_cache(maxsize=256)
def reductions_plan(B: int, C: int, N: int, itemsize: int, n_sm: int, aligned: bool) -> Plan:
    """Launch plan of a call on B images of C channels of N pixels.

    Groups: ``q`` an image, of about equal bytes, the q (at least C /
    MAX_GROUP) that gives the busiest SM the fewest rows (its waves of
    BLOCKS_PER_SM blocks times gmax + 1 rows, the mask's included), the
    smallest such q; where the B images alone make BLOCKS_PER_SM blocks an
    SM, the least q. Route: the registers' route where each of a row's
    threads (tpc for the group's rows at once) has at most REGISTER_LOADS
    of its 16-byte vectors (VECTORS), and wherever the rows are not on 16
    bytes (``aligned``, :func:`tma_rows`: ELEMENTS, one element a load): a
    block a group, no chunks, no stages, smem 0. Else ``cp.async.bulk``
    into the ring (BULK): a grid of min(B q, BLOCKS_PER_SM n_sm) blocks;
    items of the group's rows (R = gmax, at most CONSUMERS) over a chunk of
    L pixels, a whole number of 16-byte vectors, that fills STAGE_BYTES
    (twice that where a block has its SM alone); stages: as many as a block
    has items, at most MAX_STAGES, and fewer where BLOCKS_PER_SM blocks
    share an SM and would not fit it (BLOCK_SMEM); mask slots: two, or one
    where a block takes one chunk of one group."""
    V = 16 // itemsize
    slots = BLOCKS_PER_SM * n_sm
    best = None
    for q in range(max(1, -(-C // MAX_GROUP)), C + 1):
        cost = -(-B * q // slots) * (-(-C // q) + 1)
        if best is None or cost < best[0]:
            best = (cost, q)
    q = best[1] if B < slots else max(1, -(-C // MAX_GROUP))  # where the images fill the card, a group an image
    G = B * q
    assert G <= MAX_GROUPS, f"masked_reductions: {B} images of {C} channels make {G} groups, more than {MAX_GROUPS}"
    grid = min(G, slots)
    gmax = -(-C // q)
    R = min(gmax, CONSUMERS)  # an item: the group's rows (all of them where they fit), in chunks of a stage
    stage_bytes = STAGE_BYTES * (2 if grid <= n_sm else 1)  # a block alone on its SM: stages twice the size
    L = min(N, max(V, stage_bytes // (R * itemsize) // V * V))
    nch = -(-N // L)
    lay = layout(C, q, N, N, R, 1, 1, itemsize)
    if not aligned or -(-(N // V) // lay["tpc"]) <= REGISTER_LOADS:  # a block a group
        return Plan(q, N, 1, R, 1, 1, G, 0, gmax, lay["tpc"], lay["spr"], lay["pitch"], lay["stage"],
                    VECTORS if aligned else ELEMENTS)
    units = -(-G // grid) * nch
    M = min(2, units)
    S = min(MAX_STAGES, units * -(-gmax // R))
    lay = layout(C, q, N, L, R, S, M, itemsize)
    while S > 1 and lay["bytes"] > (BLOCK_SMEM if grid > n_sm else MAX_SMEM):
        S -= 1
        lay = layout(C, q, N, L, R, S, M, itemsize)
    assert lay["bytes"] <= MAX_SMEM, (B, C, N, itemsize, q, L, R, S, lay)
    return Plan(q, L, nch, R, S, M, grid, lay["bytes"], gmax, lay["tpc"], lay["spr"], lay["pitch"], lay["stage"], BULK)


_lib = None


def _library():
    """The kernel's library, its entry point typed once."""
    global _lib
    if _lib is None:
        from mga_yolo_tpu_torch.kernels import _build

        lib = _build.load("masked_reductions")
        lib.masked_reductions_launch.restype = ctypes.c_int
        lib.masked_reductions_launch.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
            + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 3
        )
        _lib = lib
    return _lib


def _buffers(B: int, C: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """One float32 allocation: sums (B, 2C + 2), then mmax (B, C)."""
    out = torch.empty((B * (3 * C + 2),), dtype=torch.float32, device=device)
    return out[:B * (2 * C + 2)].view(B, 2 * C + 2), out[B * (2 * C + 2):].view(B, C)


def views(sums: torch.Tensor, mmax: torch.Tensor):
    """msum (B, 1), wsum, gsum (B, C), mmax, cnt (B, 1): views of the two."""
    C = mmax.shape[1]
    return sums[:, :1], sums[:, 1:C + 1], sums[:, C + 1:2 * C + 1], mmax, sums[:, 2 * C + 1:]


def reduction_buffers_ref(x: torch.Tensor, m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``ops.masked_pool._reductions`` on float32 copies,
    written into the kernel's two buffers."""
    B, C, H, W = x.shape
    msum, wsum, gsum, mmax, _, cnt = _reductions(x.reshape(B, C, H * W).float(), m.reshape(B, 1, H * W).float())
    sums, mx = _buffers(B, C, x.device)
    torch.cat([msum, wsum, gsum, cnt], 1, out=sums)
    mx.copy_(mmax)
    return sums, mx


def masked_reductions_ref(x: torch.Tensor, m: torch.Tensor):
    """Plain version's five reductions (views of its two buffers)."""
    return views(*reduction_buffers_ref(x, m))


def _launch(x: torch.Tensor, m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on :func:`reductions_plan`'s plan."""
    global launches
    from mga_yolo_tpu_torch.kernels import _build

    lib = _library()
    B, C, H, W = x.shape
    N = H * W
    isz = x.element_size()
    aligned = tma_rows(x.data_ptr(), m.data_ptr(), x.stride(0), x.stride(1), m.stride(0), N, isz)
    p = reductions_plan(B, C, N, isz, torch.cuda.get_device_properties(x.device).multi_processor_count, aligned)
    with torch.cuda.device(x.device):
        sums, mmax = _buffers(B, C, x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.masked_reductions_launch(
            DTYPES[x.dtype], p.route, x.data_ptr(), m.data_ptr(), x.stride(0), x.stride(1), m.stride(0),
            B, C, N, p.q, p.L, p.R, p.S, p.M, p.grid, p.smem, sums.data_ptr(), mmax.data_ptr(), stream,
        )
    _build.check(err, "masked_reductions_launch")
    launches += 1
    return sums, mmax


def reduction_buffers(x: torch.Tensor, m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) features x (B, 1, H, W) mask -> float32 sums (B, 2C + 2)
    = msum | wsum | gsum | cnt and mmax (B, C), one allocation."""
    if x.device.type == "cpu":
        return reduction_buffers_ref(x, m)
    if x.device.type != "cuda":
        raise ValueError(f"masked_reductions: no kernel for device {x.device}")
    check_pool_inputs("masked_reductions", x, m)
    return _launch(x, m)


def masked_reductions(x: torch.Tensor, m: torch.Tensor):
    """(B, C, H, W) features x (B, 1, H, W) mask -> float32 msum (B, 1),
    wsum, gsum, mmax (B, C), cnt (B, 1), views of :func:`reduction_buffers`."""
    return views(*reduction_buffers(x, m))
