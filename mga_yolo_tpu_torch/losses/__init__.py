"""Loss package: detection (TAL/CIoU/DFL/BCE), segmentation (BCE+Dice/UFL),
Kendall MTL, and :func:`mga_loss`, the full multi-task criterion
(counterpart of ``mga_yolo_tpu/losses/__init__.py``) with the reference's
10-item ``loss_items`` vector :data:`LOSS_ITEM_NAMES`.

Data-parallel: given a :class:`GlobalBatch`, :func:`mga_loss` returns this
rank's *share* of the loss of the global batch, whose shares (and their
gradients) sum over the ranks to the global loss (and its gradient); under
a mesh that splits rows too, where each rank holds a band of its data
shard's images.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from mga_yolo_tpu_torch.losses.detection import DetLossConfig, v8_detection_loss
from mga_yolo_tpu_torch.losses.mtl import kendall_combine
from mga_yolo_tpu_torch.losses.segmentation import SegLossConfig, segmentation_loss

__all__ = [
    "GlobalBatch",
    "DetLossConfig",
    "SegLossConfig",
    "v8_detection_loss",
    "segmentation_loss",
    "kendall_combine",
    "mga_loss",
    "LOSS_ITEM_NAMES",
]

LOSS_ITEM_NAMES = (
    "box_loss",
    "cls_loss",
    "dfl_loss",
    "p3_bce",
    "p3_dice",
    "p4_bce",
    "p4_dice",
    "p5_bce",
    "p5_dice",
    "seg_total",
)


@dataclasses.dataclass(frozen=True)
class GlobalBatch:
    """A rank's view of a global batch split into ``world`` even shards.

    ``sum_ranks(t)`` returns the sum over the data shards of a detached
    tensor (``parallel.all_reduce_sum``; a test may return the known global
    value). The detection loss sums its target-score normaliser with it and
    scales by the global batch; every per-image or per-pixel mean, and the
    Kendall regularisers, are divided by ``world``.

    Under a mesh that splits rows (``parallel/spatial.py``), ``world`` is
    still every rank, and each data shard's images are split in ``space``
    bands of rows, one a rank. ``sum_space(t)`` sums a tensor over those
    ranks, differentiably (``parallel.spatial.sum_space``): the segmentation
    loss takes its per-image sums (Dice, Tversky) with it. The detection
    loss runs on the raw maps gathered whole, alike on the ``space`` ranks,
    so each counts 1/``space`` of it, and ``sum_ranks`` is over the data
    shards only.
    """

    world: int
    sum_ranks: Callable[[torch.Tensor], torch.Tensor]
    space: int = 1
    sum_space: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def mga_loss(
    outputs: dict,
    batch: dict,
    strides: Sequence[int],
    nc: int,
    mtl_log_vars: torch.Tensor,
    det_cfg: DetLossConfig = DetLossConfig(),
    seg_cfg: SegLossConfig = SegLossConfig(),
    share: Optional[GlobalBatch] = None,
):
    """Full multi-task loss (with ``share``, this rank's share of it and of
    its items).

    Args:
        outputs: the model's ``{"det": maps or (decoded, maps), "seg": {...}}``.
        batch: {"gt_labels" (B, M), "gt_bboxes" (B, M, 4) xyxy px, "mask_gt"
            (B, M), "masks": per-scale (B, 1, H, W)}.
        strides: detect strides (8, 16, 32).
        mtl_log_vars: (2,) Kendall log-variances (trainable).

    Returns:
        (total, loss_items (10,), logs dict); ``logs["det/norm"]`` is this
        batch's own target-score sum (not summed over ranks)
    """
    det_maps = outputs["det"]
    if isinstance(det_maps, tuple):  # eval-mode output (decoded, maps)
        det_maps = det_maps[1]
    # loss math in float32; the det maps keep their storage type and
    # v8_detection_loss casts per consumer (the DFL tensor stays bf16)
    seg = {k: v.float() for k, v in outputs["seg"].items()}
    world = 1 if share is None else share.world
    l_det, det_comps = v8_detection_loss(
        det_maps, strides, batch["gt_labels"], batch["gt_bboxes"], batch["mask_gt"], nc, det_cfg, share
    )
    # a model without mask heads (plain YOLOv8) has seg items of exactly 0
    l_seg, seg_logs = segmentation_loss(seg, batch.get("masks", ()), seg_cfg, device=l_det.device, world=world,
                                        sum_space=None if share is None else share.sum_space)
    total, mtl_logs = kendall_combine(l_det, l_seg, mtl_log_vars, world)

    z = torch.zeros((), device=l_det.device)
    items = torch.stack([
        det_comps["box"], det_comps["cls"], det_comps["dfl"],
        *(seg_logs.get(k, z) for k in LOSS_ITEM_NAMES[3:]),
    ])
    logs = {**{f"det/{k}": v for k, v in det_comps.items()},
            **{f"seg/{k}": v for k, v in seg_logs.items()}, **mtl_logs}
    return total, items, logs
