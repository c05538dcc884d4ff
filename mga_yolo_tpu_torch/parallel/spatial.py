"""The space axis of a DP x SP mesh: image rows split over ranks.

Counterpart of what the JAX package gets from ``data_mesh(spatial=k)``
(``mga_yolo_tpu/train/state.py``), where XLA's partitioner inserts the halo
exchanges and the cross-shard reductions itself. Here they are written out.
Under a mesh (``parallel.mesh()``, ``space`` k > 1) space rank s of a data
shard holds rows ``[s * H/k, (s + 1) * H/k)`` of its images at every stride
(:func:`keep_rows`), so ``imgsz`` must be a multiple of 32 k. Then:

* every conv and pool with a kernel taller than its stride takes the rows
  it needs from the ranks above and below (:func:`halo`, :func:`conv`,
  :func:`max_pool2d`), and runs with no row padding;
* reductions over H x W go through :func:`sum_space` and the masked pool's
  reductions through :class:`SpaceReductions` (the masked-reductions kernel
  on the card, summed and maxed over the space ranks);
* the detection head's raw maps are gathered whole (:func:`gather_rows`),
  as the detection loss and the decode need every anchor of an image.

Gradients: a tensor the space ranks hold alike (after a gather or an
all-reduce) gets from each rank's backward that rank's part of its
gradient, and the backward of every gather and all-reduce sums the parts
over the space group. A loss term computed alike on the k ranks is counted
1/k on each (``losses.GlobalBatch.space``), so the world's gradient
all-reduce counts it once.

Every collective here is over the space group, counted in
``parallel.collectives`` and in :data:`space_collectives`;
:data:`halo_exchanges` counts the halo exchanges among them (forward and
backward). Without a mesh none of this runs: the callers keep their
one-process paths.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mga_yolo_tpu_torch import parallel
from mga_yolo_tpu_torch.ops import masked_reductions
from mga_yolo_tpu_torch.ops.cam_gate import gate_of
from mga_yolo_tpu_torch.ops.masked_pool import combine

space_collectives = 0  # collectives over the space group
halo_exchanges = 0     # the halo exchanges among them


def _count(halo: bool = False) -> None:
    global space_collectives, halo_exchanges
    space_collectives += 1
    halo_exchanges += int(halo)
    parallel.collectives += 1


def _mesh() -> parallel.Mesh:
    m = parallel.mesh()
    if m is None:
        raise RuntimeError("spatial: no mesh with more than one space rank is in effect")
    return m


def _all_gather(t: torch.Tensor, m: parallel.Mesh, halo: bool = False) -> list:
    parts = [torch.empty_like(t) for _ in range(m.space)]
    dist.all_gather(parts, t.contiguous(), group=m.space_group)
    _count(halo)
    return parts


def _all_reduce_(t: torch.Tensor, m: parallel.Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=m.space_group)
    _count()
    return t


def check_rows(H: int, k: int) -> None:
    """Raise unless an image of H rows splits into k bands at every stride
    of the model (8 to 32): H a multiple of 32 k."""
    if H % (32 * k):
        raise ValueError(f"mesh_spatial={k} needs the image size to be a multiple of 32 x {k} = {32 * k}, "
                         f"got {H} rows")


def keep_rows(batch: dict, masks: bool = True) -> dict:
    """This space rank's rows of a batch (numpy arrays or tensors, NHWC):
    its band of ``image`` and, with ``masks``, of each of ``masks``; boxes,
    labels and ``mask_gt`` stay whole, as in the JAX package's
    ``_batch_shardings``. Device augmentation warps whole canvases and the
    trainer slices the finished batch. The batch as it is without a mesh."""
    m = parallel.mesh()
    if m is None:
        return batch
    check_rows(batch["image"].shape[1], m.space)

    def band(a):
        h = a.shape[1] // m.space
        out = a[:, m.space_rank * h:(m.space_rank + 1) * h]
        return out.contiguous() if isinstance(out, torch.Tensor) else out.copy()

    out = dict(batch)
    out["image"] = band(batch["image"])
    if masks and "masks" in batch:
        out["masks"] = [band(a) for a in batch["masks"]]
    return out


def halo_rows(k: int, s: int, p: int, d: int = 1) -> tuple[int, int]:
    """Rows a band needs above and below for a window of k rows (dilation
    d) at stride s with p rows of padding, when bands are s-aligned: p
    above, k_eff - s - p below (none when negative)."""
    return p, max(0, d * (k - 1) + 1 - s - p)


def _halo_index(k: int, r: int, h: int, top: int, bottom: int, nt: int, nb: int) -> tuple[list, list]:
    """Rows of the gathered stack (rank q's first ``nb`` rows, then its last
    ``nt``, for q = 0..k-1, then one padding row) that make rank r's top and
    bottom halos."""
    part, pad = nb + nt, k * (nb + nt)
    up = []
    for i in range(top):
        g = r * h - top + i
        up.append(pad if g < 0 else (g // h) * part + nb + (g % h) - (h - nt))
    down = []
    for j in range(bottom):
        g = (r + 1) * h + j
        down.append(pad if g >= k * h else (g // h) * part + g % h)
    return up, down


class _Halo(torch.autograd.Function):
    """``(x (B, C, h, W), top, bottom, pad) -> (B, C, top + h + bottom, W)``:
    this rank's rows with ``top`` rows of the image above them and
    ``bottom`` below, rows past the image's edge filled with ``pad``. One
    all-gather of every rank's first ``min(bottom, h)`` and last
    ``min(top, h)`` rows, so a halo taller than a band takes rows from as
    many ranks as it needs. Backward: one all-gather of the halos'
    gradients; each rank adds those of its own rows."""

    @staticmethod
    def forward(ctx, x, top, bottom, pad):
        m = _mesh()
        k, r, h = m.space, m.space_rank, x.shape[2]
        nt, nb = min(top, h), min(bottom, h)
        parts = _all_gather(torch.cat([x[:, :, :nb], x[:, :, h - nt:]], 2), m, halo=True)
        stack = torch.cat([*parts, x.new_full((*x.shape[:2], 1, x.shape[3]), pad)], 2)
        up, down = _halo_index(k, r, h, top, bottom, nt, nb)
        idx = torch.tensor(up + down, dtype=torch.long, device=x.device)
        rows = stack.index_select(2, idx)
        ctx.shape = (k, r, h, top, bottom)
        return torch.cat([rows[:, :, :top], x, rows[:, :, top:]], 2)

    @staticmethod
    def backward(ctx, g):
        m = _mesh()
        k, r, h, top, bottom = ctx.shape
        parts = _all_gather(torch.cat([g[:, :, :top], g[:, :, top + h:]], 2), m, halo=True)
        dx = g[:, :, top:top + h].clone()
        for q in range(k):  # rank q's halo rows that are rank r's rows, one slice a direction
            for first, n, off in ((q * h - top, top, 0), ((q + 1) * h, bottom, top)):
                lo, hi = max(first, r * h), min(first + n, (r + 1) * h)
                if q != r and lo < hi:
                    dx[:, :, lo - r * h:hi - r * h] += parts[q][:, :, off + lo - first:off + hi - first]
        return dx, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int, pad: float = 0.0) -> torch.Tensor:
    """:class:`_Halo`; ``x`` as it is when no rows are needed."""
    if top == 0 and bottom == 0:
        return x
    return _Halo.apply(x, top, bottom, pad)


def _without_cudnn():
    """cuDNN off for the block, its other flags as they are."""
    b = torch.backends.cudnn
    return b.flags(enabled=False, benchmark=b.benchmark, deterministic=b.deterministic, allow_tf32=b.allow_tf32)


class _GemmConv(torch.autograd.Function):
    """A band's conv in float32 on the card as GEMMs: the forward and the
    input gradient by PyTorch's own im2col / col2im convolution (cuDNN
    off), the weight gradient of a dense conv as one float32 GEMM over the
    unfolded input (dy (O, B*L) times the columns (B*L, C*kh*kw)); a
    grouped conv's weight gradient stays cuDNN's.

    cuDNN picks its float32 algorithms by shape, and for a band's shapes
    they are less exact than for the whole image's: the flagship's float32
    micro-steps at 640 px on two bands lay 2.16x one process's
    root-mean-square error from the float64 step with cuDNN's convs, 0.64x
    with these (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6). :func:`conv`
    takes this in float32 on the card outside autocast; bf16 keeps cuDNN."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups, b is not None)
        with _without_cudnn():
            return F.conv2d(x, w, b, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups, has_b = ctx.conf
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            with _without_cudnn():
                dx = torch.nn.grad.conv2d_input(x.shape, w, g, stride, padding, dilation, groups)
        if ctx.needs_input_grad[1] and groups == 1:
            cols = F.unfold(x, w.shape[2:], dilation=dilation, padding=padding, stride=stride)  # (B, C*kh*kw, L)
            dw = torch.einsum("bol,bkl->ok", g.flatten(2), cols).reshape(w.shape)
        elif ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x, w.shape, g, stride, padding, dilation, groups)
        if has_b and ctx.needs_input_grad[2]:
            db = g.sum((0, 2, 3))
        return dx, dw, db, None, None, None, None


def conv(module: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``module(x)``; under a mesh the same conv on this rank's band: the
    halo its kernel, stride and padding need, then no row padding (in
    float32 on the card, by :class:`_GemmConv`)."""
    if parallel.mesh() is None:
        return module(x)
    (kh, _), (sh, _), (ph, pw), (dh, _) = module.kernel_size, module.stride, module.padding, module.dilation
    xh = halo(x, *halo_rows(kh, sh, ph, dh))
    if xh.is_cuda and xh.dtype == torch.float32 and not torch.is_autocast_enabled("cuda"):
        y = _GemmConv.apply(xh, module.weight, module.bias, module.stride, (0, pw), module.dilation, module.groups)
    else:
        y = F.conv2d(xh, module.weight, module.bias, module.stride, (0, pw), module.dilation, module.groups)
    if y.shape[2] * sh != x.shape[2]:
        raise ValueError(f"spatial conv: a band of {x.shape[2]} rows at stride {sh} gave {y.shape[2]} rows")
    return y


def max_pool2d(x: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
    """``F.max_pool2d(x, k, s, p)``; under a mesh on this rank's band, the
    halo padded with -inf as the pool pads."""
    if parallel.mesh() is None:
        return F.max_pool2d(x, k, s, p)
    return F.max_pool2d(halo(x, *halo_rows(k, s, p), float("-inf")), k, s, (0, p))


class _SumSpace(torch.autograd.Function):
    """Sum over the space ranks; backward: the gradients' sum over them."""

    @staticmethod
    def forward(ctx, t):
        return _all_reduce_(t.clone(), _mesh())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), _mesh())


def sum_space(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the space ranks, differentiable (:class:`_SumSpace`)."""
    return _SumSpace.apply(t)


class _GatherRows(torch.autograd.Function):
    """``(*tensors (B, C_i, h_i, W_i)) -> the whole images (B, C_i, k h_i,
    W_i)``, one all-gather for all of them. Backward: each output's
    gradient summed over the space ranks (one all-reduce), this rank's rows
    of it."""

    @staticmethod
    def forward(ctx, *ts):
        m = _mesh()
        ctx.rows = [t.shape[2] for t in ts]
        ctx.space_rank = m.space_rank
        flat = torch.cat([t.reshape(-1) for t in ts])
        parts = _all_gather(flat, m)
        sizes = [t.numel() for t in ts]
        per_rank = [p.split(sizes) for p in parts]
        return tuple(torch.cat([pr[i].view_as(t) for pr in per_rank], 2) for i, t in enumerate(ts))

    @staticmethod
    def backward(ctx, *gs):
        m = _mesh()
        flat = torch.cat([g.reshape(-1) for g in gs])
        _all_reduce_(flat, m)
        out = []
        for g, h, part in zip(gs, ctx.rows, flat.split([g.numel() for g in gs])):
            out.append(part.view_as(g)[:, :, ctx.space_rank * h:(ctx.space_rank + 1) * h])
        return tuple(out)


def gather_rows(tensors: list) -> list:
    """The whole images of this rank's bands (:class:`_GatherRows`)."""
    return list(_GatherRows.apply(*tensors))


class SpaceReductions(torch.autograd.Function):
    """``(x (B, C, h, W), m (B, 1, h, W)) -> msum (B, 1), wsum, gsum, mmax
    (B, C), cnt (B, 1)``, float32, over the whole images: this band's five
    masked reductions (TPU kernel 3b, ``ops/masked_reductions.py``; the
    kernel on the card, which writes the sums as one (B, 2C + 2) buffer),
    then one all-reduce of that buffer and one of the max over the space
    ranks.

    Backward (plain PyTorch, the JAX package's ``_bwd`` written for the
    reductions): the cotangents summed over the space ranks and the number
    of pixels at each channel's max (``n_ties``: a max tied on two bands
    splits its gradient over both) in one all-reduce; then dx = dwsum * m +
    dgsum + dmmax / n_ties at the masked maxima, dm = dmsum + sum_c dwsum *
    x. ``cnt`` takes no gradient."""

    @staticmethod
    def forward(ctx, x, m):
        mesh = _mesh()
        ctx.set_materialize_grads(False)
        sums, mmax = masked_reductions.reduction_buffers(x, m)  # msum | wsum | gsum | cnt, and mmax
        C = x.shape[1]
        sums = _all_reduce_(sums, mesh)
        mmax = _all_reduce_(mmax, mesh, dist.ReduceOp.MAX)
        msum, wsum, gsum, cnt = (t.clone() for t in sums.split([1, C, C, 1], 1))  # outputs of their own
        ctx.save_for_backward(x, m, mmax)
        ctx.mark_non_differentiable(cnt)
        return msum, wsum, gsum, mmax, cnt

    @staticmethod
    def backward(ctx, d_msum, d_wsum, d_gsum, d_mmax, _d_cnt):
        x, m, mmax = ctx.saved_tensors
        B, C = x.shape[:2]
        x32, m32 = x.reshape(B, C, -1).float(), m.reshape(B, 1, -1).float()
        zero = x32.new_zeros((B, C))
        is_max = (m32 > 0.5) & (x32 == mmax[:, :, None])
        parts = [d.float().reshape(B, -1) if d is not None else z
                 for d, z in ((d_msum, zero[:, :1]), (d_wsum, zero), (d_gsum, zero), (d_mmax, zero))]
        buf = _all_reduce_(torch.cat([*parts, is_max.float().sum(-1)], 1), _mesh())
        d_msum, d_wsum, d_gsum, d_mmax, n_ties = buf.split([1, C, C, C, C], 1)
        dx = d_wsum[:, :, None] * m32 + d_gsum[:, :, None]
        dx = dx + torch.where(is_max, (d_mmax / n_ties.clamp_min(1.0))[:, :, None], 0.0)
        dm = d_msum[:, :, None] + (d_wsum[:, :, None] * x32).sum(1, keepdim=True)
        return (dx.reshape(x.shape).to(x.dtype) if ctx.needs_input_grad[0] else None,
                dm.reshape(m.shape).to(m.dtype) if ctx.needs_input_grad[1] else None)


def pool_f32(x: torch.Tensor, m: torch.Tensor, tiny_thr: float = 1e-4, eps: float = 1e-6):
    """The masked pool's float32 (avg, max) descriptors (B, C) of the whole
    images, from this rank's band: :class:`SpaceReductions`, then
    ``ops.masked_pool.combine`` with the whole images' N."""
    N = x.shape[2] * x.shape[3] * _mesh().space
    return combine(*SpaceReductions.apply(x, m), N, tiny_thr, eps)


def cam_gate(x, m, w1, b1, w2, b2, tiny_thr: float = 1e-4, eps: float = 1e-6) -> torch.Tensor:
    """MaskCBAM's channel gate (``ops.cam_gate.cam_gate_ref``) of the whole
    images from this rank's band: :func:`pool_f32`, then the MLP and
    sigmoid in float32 on the (B, C) descriptors (``ops.cam_gate.gate_of``)."""
    with torch.autocast(x.device.type, enabled=False):
        return gate_of(*pool_f32(x, m, tiny_thr, eps), w1, b1, w2, b2)
