"""YOLOv8 detection loss: task-aligned assignment + CIoU + DFL + BCE.

Counterpart of ``mga_yolo_tpu/losses/detection.py``. Every image carries a
fixed-size padded GT tensor (``gt_bboxes (B, M, 4)`` xyxy pixels +
``mask_gt (B, M)``), and data-dependent selection is masking and one-hot
products, so the loss has static shapes and never syncs with the host.
Box quantities are (B, A, 4); the JAX package's planar (4, B, A) copies are a
TPU lane-padding device with the same values. The anchor order is that of
``make_anchors``: levels in order, each row-major, i.e. ``maps.flatten(2)``.

The gradient of the DFL decode and the distribution-focal CE goes through
one :class:`DflDecodeCE`, whose backward is the kernel ``csrc/dfl_bwd.cu``
on CUDA tensors (``ops/dfl_bwd.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from mga_yolo_tpu_torch.ops.boxes import bbox2dist, bbox_iou_ciou, dist2bbox, make_anchors
from mga_yolo_tpu_torch.ops.dfl_bwd import dfl_decode_ce_bwd


@dataclasses.dataclass(frozen=True)
class DetLossConfig:
    box: float = 7.5   # gains, reference cfg/default.yaml
    cls: float = 0.5
    dfl: float = 1.5
    reg_max: int = 16
    tal_topk: int = 10
    tal_alpha: float = 0.5
    tal_beta: float = 6.0
    eps: float = 1e-9


def select_candidates_in_gts(xy_centers: torch.Tensor, gt_bboxes: torch.Tensor,
                             eps: float = 1e-9) -> torch.Tensor:
    """(A, 2) centres x (B, M, 4) xyxy -> (B, M, A) bool: centre strictly inside."""
    lt = gt_bboxes[..., None, :2]
    rb = gt_bboxes[..., None, 2:]
    xy = xy_centers[None, None]
    d_min = torch.minimum((xy - lt).amin(-1), (rb - xy).amin(-1))
    return d_min > eps


def _fast_pow(x: torch.Tensor, p: float) -> torch.Tensor:
    """x**p as the JAX package computes it: sqrt for 0.5, repeated products
    for small integers (a one-ulp change in the metric can flip a top-k pick)."""
    if p == 0.5:
        return torch.sqrt(x)
    if float(p).is_integer() and 1 <= int(p) <= 8:
        out = x
        for _ in range(int(p) - 1):
            out = out * x
        return out
    return x**p


def _kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest value (with multiplicity) along the last axis, keepdim.

    k rounds of distinct-max with a running >=-count: the k-th largest in
    sorted-with-duplicates order is the largest distinct value d with
    count(x >= d) >= k (the JAX package's ``iter`` form; its ``approx``
    switch is a TPU A/B lever the port does not carry).
    """
    lead = x.shape[:-1] + (1,)
    d = torch.full(lead, float("inf"), dtype=x.dtype, device=x.device)
    kth = torch.zeros(lead, dtype=x.dtype, device=x.device)
    done = torch.zeros(lead, dtype=torch.bool, device=x.device)
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    for _ in range(k):
        nm = torch.where(x < d, x, neg).amax(-1, keepdim=True)
        nc = (x >= nm).float().sum(-1, keepdim=True)
        hit = ~done & (nc >= k)
        kth = torch.where(hit, nm, kth)
        done = done | hit
        d = nm
    return kth


def task_aligned_assigner(
    pd_scores: torch.Tensor,   # (B, A, nc) sigmoided class scores
    pd_bboxes: torch.Tensor,   # (B, A, 4) xyxy, image units
    anc_points: torch.Tensor,  # (A, 2), image units
    gt_labels: torch.Tensor,   # (B, M) int
    gt_bboxes: torch.Tensor,   # (B, M, 4) xyxy, image units
    mask_gt: torch.Tensor,     # (B, M) 0/1
    num_classes: int,
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
    eps: float = 1e-9,
):
    """Returns (target_bboxes (B, A, 4), target_scores (B, A, nc), fg_mask (B, A))."""
    B, A, nc = pd_scores.shape
    M = gt_bboxes.shape[1]
    dt = pd_scores.dtype
    cand = select_candidates_in_gts(anc_points, gt_bboxes).to(dt) * mask_gt.to(dt)[..., None]

    onehot = F.one_hot(gt_labels.long(), nc).to(dt)                        # (B, M, nc)
    bbox_scores = torch.einsum("bac,bmc->bma", pd_scores, onehot) * cand   # (B, M, A)
    overlaps = bbox_iou_ciou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :]).clamp_min(0) * cand
    align_metric = _fast_pow(bbox_scores, alpha) * _fast_pow(overlaps, beta)

    # selected iff the metric reaches the gt's k-th largest and is positive
    kth = _kth_largest(align_metric, topk)
    mask_pos = ((align_metric >= kth) & (align_metric > 0)).to(dt)

    # an anchor claimed by several gts keeps the one of highest overlap
    # (argmax takes the first maximum, as jnp.argmax does)
    fg = mask_pos.sum(-2)
    is_max = F.one_hot(overlaps.argmax(1), M).to(dt).transpose(1, 2)      # (B, M, A)
    mask_pos = torch.where(fg[:, None, :] > 1, is_max, mask_pos)
    fg_mask = mask_pos.sum(-2)
    target_gt_idx = mask_pos.argmax(-2)                                    # (B, A)

    sel = F.one_hot(target_gt_idx, M).to(dt)                               # (B, A, M)
    target_bboxes = torch.einsum("bam,bmf->baf", sel, gt_bboxes.to(dt))
    # labels route through float32 (bf16 would round class ids above 256)
    tl = torch.einsum("bam,bm->ba", sel.float(), gt_labels.float()).long()
    target_scores = F.one_hot(tl, nc).to(dt) * fg_mask[..., None]

    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(-1, keepdim=True)
    pos_overlap = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align_metric * pos_overlap / (pos_align + eps)).amax(-2)[..., None]
    return target_bboxes, target_scores * norm, fg_mask


def flatten_det_maps(det_maps: Sequence[torch.Tensor], reg_max: int, nc: int):
    """NCHW per-level maps -> (pred_distri (B, A, 4*reg_max), pred_scores (B, A, nc))."""
    b = det_maps[0].shape[0]
    flat = torch.cat([m.reshape(b, 4 * reg_max + nc, -1) for m in det_maps], 2).transpose(1, 2)
    return flat[..., : 4 * reg_max], flat[..., 4 * reg_max:]


def optax_sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise BCE-with-logits (``optax`` form)."""
    return logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def dfl_loss(pred_dist: torch.Tensor, target: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution focal loss per anchor: (..., 4, R) logits, (..., 4) bins -> (...)."""
    target = target.clamp(0, reg_max - 1 - 0.01)
    tl = target.long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    logp = torch.log_softmax(pred_dist, -1)
    ce_l = -logp.gather(-1, tl[..., None])[..., 0]
    ce_r = -logp.gather(-1, tr.clamp_max(reg_max - 1)[..., None])[..., 0]
    return (ce_l * wl + ce_r * (1.0 - wl)).mean(-1)


def dfl_decode(pd: torch.Tensor) -> torch.Tensor:
    """(B, A, 4, R) logits -> (B, A, 4) float32 expectation sum(softmax * arange(R))."""
    pd = pd.float()
    proj = torch.arange(pd.shape[-1], dtype=torch.float32, device=pd.device)
    return (torch.softmax(pd, -1) * proj).sum(-1)


def _dfl_ce(pd: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-anchor distribution-focal CE (value of :func:`dfl_loss`), float32."""
    R = pd.shape[-1]
    pd = pd.float()
    t = target.float().clamp(0, R - 1 - 0.01)
    tl = t.long()
    tr = (tl + 1).clamp_max(R - 1)
    wl = tr.float() - t
    lse = torch.logsumexp(pd, -1)
    z_tl = pd.gather(-1, tl[..., None])[..., 0]
    z_tr = pd.gather(-1, tr[..., None])[..., 0]
    return ((lse - z_tl) * wl + (lse - z_tr) * (1.0 - wl)).mean(-1)


class DflDecodeCE(torch.autograd.Function):
    """``(pd, target) -> (decode(pd) (B, A, 4), dfl_ce(pd, target) (B, A))``, float32.

    pd (B, A, 4, R) stays in its storage type (bf16 under autocast). One
    backward reads pd once, recomputes p = softmax(pd) and writes the summed
    cotangent of both outputs (``ops/dfl_bwd.py``): the kernel on CUDA, the
    plain version on the CPU. ``target`` is ground truth and gets no gradient.
    """

    @staticmethod
    def forward(ctx, pd, target):
        ltrb = dfl_decode(pd)
        ce = _dfl_ce(pd, target)
        ctx.save_for_backward(pd, ltrb, target)
        return ltrb, ce

    @staticmethod
    def backward(ctx, g_ltrb, g_ce):
        pd, ltrb, target = ctx.saved_tensors
        if g_ltrb is None:
            g_ltrb = torch.zeros_like(ltrb)
        if g_ce is None:
            g_ce = torch.zeros(ltrb.shape[:2], dtype=torch.float32, device=ltrb.device)
        dz = dfl_decode_ce_bwd(pd, ltrb, g_ltrb.float(), g_ce.float(), target.float())
        return dz, None


def v8_detection_loss(
    det_maps: Sequence[torch.Tensor],
    strides: Sequence[int],
    gt_labels: torch.Tensor,   # (B, M)
    gt_bboxes: torch.Tensor,   # (B, M, 4) xyxy image pixels
    mask_gt: torch.Tensor,     # (B, M)
    nc: int,
    cfg: DetLossConfig = DetLossConfig(),
    share=None,
):
    """Returns (total, {'box', 'cls', 'dfl', 'norm'} detached): BCE cls +
    CIoU box + DFL with the cfg gains, scaled by the batch size (reference
    loss.py); 'norm' is this batch's unclamped target-score sum.

    With ``share`` (a ``losses.GlobalBatch``) the target-score normaliser is
    summed over the data shards (one detached scalar) and the scale is the
    global batch: the rank's share of the global batch's loss and items. On
    ``share.space`` ranks that hold the same maps (gathered over bands of
    rows) each takes 1/space of it."""
    reg_max = cfg.reg_max
    B = det_maps[0].shape[0]
    pred_distri, pred_scores = flatten_det_maps(det_maps, reg_max, nc)
    A = pred_scores.shape[1]
    # score and box math in float32; the (B, A, 4, R) distribution keeps its
    # storage type, which DflDecodeCE reads (and differentiates) in float32
    pred_scores = pred_scores.float()
    dev = pred_scores.device
    shapes = [tuple(m.shape[-2:]) for m in det_maps]
    anchor_points, stride_tensor = make_anchors(shapes, strides, 0.5, dtype=torch.float32, device=dev)
    gt_bboxes = gt_bboxes.float()

    # the kernel reads each segment of R logits contiguously
    pd = pred_distri.reshape(B, A, 4, reg_max).contiguous()
    with torch.no_grad():  # the assigner needs values only
        pred_bboxes_sg = dist2bbox(dfl_decode(pd), anchor_points, xywh=False)
        target_bboxes, target_scores, fg_mask = task_aligned_assigner(
            pred_scores.sigmoid(), pred_bboxes_sg * stride_tensor, anchor_points * stride_tensor,
            gt_labels, gt_bboxes, mask_gt, nc,
            topk=cfg.tal_topk, alpha=cfg.tal_alpha, beta=cfg.tal_beta,
        )
        norm = target_scores.sum()
        target_scores_sum = (norm if share is None else share.sum_ranks(norm)).clamp_min(1.0)
        tb_feat = target_bboxes / stride_tensor
        weight = target_scores.sum(-1) * fg_mask
        target_ltrb = bbox2dist(anchor_points, tb_feat, reg_max - 1)

    loss_cls = optax_sigmoid_bce(pred_scores, target_scores).sum() / target_scores_sum
    ltrb, per_anchor_dfl = DflDecodeCE.apply(pd, target_ltrb)
    pred_bboxes = dist2bbox(ltrb, anchor_points, xywh=False)
    iou = bbox_iou_ciou(pred_bboxes, tb_feat)
    loss_iou = ((1.0 - iou) * weight).sum() / target_scores_sum
    loss_dfl = (per_anchor_dfl * weight).sum() / target_scores_sum

    loss_box = loss_iou * cfg.box
    loss_cls = loss_cls * cfg.cls
    loss_dfl = loss_dfl * cfg.dfl
    total = (loss_box + loss_cls + loss_dfl) * (B if share is None else B * (share.world // share.space))
    comps = {"box": loss_box.detach(), "cls": loss_cls.detach(), "dfl": loss_dfl.detach()}
    if share is not None and share.space > 1:  # alike on the space ranks: each counts 1/space
        total = total / share.space
        comps = {k: v / share.space for k, v in comps.items()}
    return total, {**comps, "norm": norm}
