"""Multi-scale segmentation loss: BCE + soft Dice, or the Unified Focal Loss.

Counterpart of ``mga_yolo_tpu/losses/segmentation.py``, NCHW: per scale
(p3/p4/p5) the (B, 1, H, W) logits meet the GT mask at their resolution,
then either BCE-with-logits + soft Dice or LsUF = lambda*LmF +
(1-lambda)*LmFT, everything in float32. The data pipeline delivers targets
at each scale's resolution, so the resize is a safety net for odd shapes;
it resizes as ``jax.image.resize`` does (nearest with half-pixel centres
for binary masks, antialiased bilinear in probabilistic-mask mode).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from mga_yolo_tpu_torch.losses.detection import optax_sigmoid_bce
from mga_yolo_tpu_torch.models.layers import resize_bilinear, resize_nearest


@dataclasses.dataclass(frozen=True)
class SegLossConfig:
    bce_weight: float = 1.0
    dice_weight: float = 1.0
    scale_weights: tuple[float, float, float] = (1.0, 1.0, 1.0)
    smooth: float = 1.0
    loss_lambda: float = 1.0
    enabled: bool = True
    prob_mode: bool = False
    use_unified_focal: bool = False
    ufl_lambda: float = 0.5
    ufl_delta: float = 0.6
    ufl_gamma: float = 0.5


def _image_sums(terms: list, sum_space=None) -> list:
    """Each (B, 1, H, W) term summed over its image, (B,) each; with
    ``sum_space``, over the whole images of the space ranks' bands (one sum)."""
    sums = torch.stack([t.sum((1, 2, 3)) for t in terms])
    return list(sums if sum_space is None else sum_space(sums))


def soft_dice(probs: torch.Tensor, tgt: torch.Tensor, smooth: float, sum_space=None) -> torch.Tensor:
    """1 - Dice per batch element."""
    inter, psum, tsum = _image_sums([probs * tgt, probs, tgt], sum_space)
    denom = psum + tsum + smooth
    return 1.0 - (2.0 * inter + smooth) / denom


def modified_focal_ce(logits: torch.Tensor, tgt: torch.Tensor, delta: float, gamma: float,
                      eps: float = 1e-6) -> torch.Tensor:
    """LmF, float32, clamped bases."""
    x, t = logits.float(), tgt.float()
    probs = torch.sigmoid(x)
    pt = torch.where(t > 0.5, probs, 1.0 - probs).clamp(eps, 1.0 - eps)
    ce = optax_sigmoid_bce(x, t)
    w = torch.where(t > 0.5, delta, 1.0 - delta)
    base = (1.0 - pt).clamp_min(eps)
    return (base ** (1.0 - gamma) * ce * w).mean()


def modified_focal_tversky(logits: torch.Tensor, tgt: torch.Tensor, delta: float, gamma: float,
                           smooth: float, eps: float = 1e-6, sum_space=None) -> torch.Tensor:
    """LmFT, float32, guarded denominator."""
    x, t = logits.float(), tgt.float()
    p = torch.sigmoid(x)
    tp, fn, fp = _image_sums([p * t, t * (1.0 - p), (1.0 - t) * p], sum_space)
    denom = (tp + delta * fn + (1.0 - delta) * fp + smooth).clamp_min(eps)
    base = (1.0 - (tp + smooth) / denom).clamp_min(eps)
    return (base**gamma).mean()


def segmentation_loss(
    preds: Dict[str, torch.Tensor],     # {"p3", "p4", "p5"}: (B, 1, H, W) logits
    targets: Sequence[torch.Tensor],    # per-scale GT masks (B, 1, H, W) or (B, H, W)
    cfg: SegLossConfig = SegLossConfig(),
    device: torch.device | None = None,
    world: int = 1,
    sum_space=None,
):
    """Returns (total, logs {sk_bce, sk_dice, sk_combined, seg_total}).

    The total is a zero on ``device`` (by default the predictions') when the
    loss is disabled or the model has no mask heads (plain YOLOv8). A rank
    of ``world`` holding an even shard of the global batch divides each
    term, a mean over its images or pixels, by ``world``: the shares sum
    over the ranks to the global batch's means. Where the ranks hold bands
    of rows of their images, ``sum_space`` (``losses.GlobalBatch``) sums the
    per-image sums of Dice and Tversky over the bands; the per-pixel means
    need nothing more."""
    if device is None:
        device = next((v.device for v in preds.values()), None)
    total = torch.zeros((), device=device)
    if not cfg.enabled:
        return total, {}
    logs: Dict[str, torch.Tensor] = {}
    for i, sk in enumerate(("p3", "p4", "p5")):
        if sk not in preds or i >= len(targets):
            continue
        pred = preds[sk]
        tgt = targets[i]
        if tgt.dim() == 3:
            tgt = tgt[:, None]
        tgt = tgt.float()
        if tgt.shape[-2:] != pred.shape[-2:]:
            resize = resize_bilinear if cfg.prob_mode else resize_nearest
            tgt = resize(tgt, tuple(pred.shape[-2:]))
        w_scale = cfg.scale_weights[i] if i < len(cfg.scale_weights) else 1.0
        if cfg.use_unified_focal:
            first = modified_focal_ce(pred, tgt, cfg.ufl_delta, cfg.ufl_gamma) / world
            second = modified_focal_tversky(pred, tgt, cfg.ufl_delta, cfg.ufl_gamma, cfg.smooth,
                                            sum_space=sum_space) / world
            combined = w_scale * (cfg.ufl_lambda * first + (1.0 - cfg.ufl_lambda) * second)
        else:
            p32 = pred.float()
            first = optax_sigmoid_bce(p32, tgt).mean() / world
            second = soft_dice(torch.sigmoid(p32), tgt, cfg.smooth, sum_space).mean() / world
            combined = w_scale * (cfg.bce_weight * first + cfg.dice_weight * second)
        logs[f"{sk}_bce"] = first.detach()
        logs[f"{sk}_dice"] = second.detach()
        total = total + combined.float()
        logs[f"{sk}_combined"] = combined.detach()
    total = total * cfg.loss_lambda
    logs["seg_total"] = total.detach()
    return total, logs
