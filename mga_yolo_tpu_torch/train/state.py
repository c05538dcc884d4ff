"""Train state and the train / eval steps (counterpart of
``mga_yolo_tpu/train/state.py``).

``make_train_step(...)`` builds ``train_step(state, batch, lr, lr_bias,
momentum) -> (state, metrics)``, which updates ``state`` in place: a uint8
batch is normalised on the device, the forward runs in ``compute_dtype``
autocast over float32 masters, :func:`~mga_yolo_tpu_torch.losses.mga_loss`
runs in float32, and the gradients are summed over micro-steps until an
apply (global-norm clip, the optimizer, the ramped EMA of the parameters and
BN statistics). BN statistics update on every micro-step. The counters and
the apply decision live on the host, where the step count is known, so the
step never waits for the device.

With a process group of two or more ranks (``parallel``), each rank takes
its shard of the global batch; BatchNorm and the loss normalisers are those
of the global batch, each rank's loss is its share of the global loss, and
the accumulated gradient is summed over the ranks once at each apply,
before the clip (by linearity the same as a sum every micro-step, at one
collective an apply). Every rank then applies the same update, so the
states stay equal; :func:`create_train_state` starts them from rank 0's.
Under a mesh that splits rows (``parallel.using(parallel.data_mesh(k))``)
the batch a step takes holds this rank's band of rows of its data shard's
images and masks (``parallel.spatial.keep_rows``); the model, the loss
share and the eval step take it from there.

A batch is the JAX package's batch dict: ``image`` (B, H, W, 3) uint8,
``gt_boxes`` (B, M, 4) xyxy pixels, ``gt_labels`` (B, M), ``mask_gt`` (B, M)
and ``masks``, one (B, H/s, W/s, 1) mask per stride 8, 16, 32; numpy arrays
or tensors on any device.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from mga_yolo_tpu_torch import parallel
from mga_yolo_tpu_torch.losses import mga_loss
from mga_yolo_tpu_torch.losses.detection import DetLossConfig
from mga_yolo_tpu_torch.losses.segmentation import SegLossConfig
from mga_yolo_tpu_torch.models.yolo import MGAModel
from mga_yolo_tpu_torch.ops.nms import nms
from mga_yolo_tpu_torch.parallel import spatial
from mga_yolo_tpu_torch.train import optim

Tensors = Dict[str, torch.Tensor]
BN_STATS = ("running_mean", "running_var")


@dataclasses.dataclass
class TrainState:
    """What a train step reads and writes.

    ``model`` holds the float32 master parameters and the BN running
    statistics; ``mtl_log_vars`` (2,) is the Kendall head, kept outside the
    model so its state_dict stays the reference format. Slots, EMA copies and
    the accumulation buffer are dicts keyed like :meth:`params` and
    :meth:`bn_stats`.
    """

    model: MGAModel
    mtl_log_vars: torch.Tensor
    opt_state: Dict[str, Tensors]
    ema_params: Tensors
    ema_bn_stats: Tensors
    groups: Dict[str, int]
    step: int = 0            # micro-steps taken
    opt_step: int = 0        # optimizer applies
    last_apply: int = 0      # micro-step of the last apply
    accum_grads: Optional[Tensors] = None

    def params(self) -> Tensors:
        """Trainable tensors by name: the model's parameters (the frozen DFL
        projection excluded) and ``mtl_log_vars``."""
        out = {k: p for k, p in self.model.named_parameters() if p.requires_grad}
        out["mtl_log_vars"] = self.mtl_log_vars
        return out

    def bn_stats(self) -> Tensors:
        return {k: b for k, b in self.model.named_buffers() if k.endswith(BN_STATS)}


def create_train_state(model: MGAModel, opt_name: str = "sgd") -> TrainState:
    """State for ``model`` as it stands (its weights become the EMA's start),
    with zeroed ``mtl_log_vars`` and optimizer slots. With a process group
    of two or more, the model's parameters and buffers are rank 0's first."""
    dev = next(model.parameters()).device
    mtl = torch.zeros(2, dtype=torch.float32, device=dev, requires_grad=True)
    state = TrainState(model=model, mtl_log_vars=mtl, opt_state={}, ema_params={},
                       ema_bn_stats={}, groups={})
    params = state.params()
    parallel.broadcast_state(list(model.state_dict(keep_vars=True).values()))
    with torch.no_grad():
        state.opt_state = optim.init_opt_state(opt_name, params)
        state.ema_params = {k: p.detach().clone() for k, p in params.items()}
        state.ema_bn_stats = {k: b.detach().clone() for k, b in state.bn_stats().items()}
    state.groups = optim.param_groups(params)
    return state


def broadcast_train_state(state: TrainState) -> None:
    """Rank 0's whole state on every rank (after a resume): the model's
    parameters and buffers, ``mtl_log_vars``, the EMA, the optimizer slots
    and the accumulation buffer. The counters come from the same file."""
    tensors = [*state.model.state_dict(keep_vars=True).values(), state.mtl_log_vars,
               *state.ema_params.values(), *state.ema_bn_stats.values(),
               *(t for slot in state.opt_state.values() for t in slot.values()),
               *(state.accum_grads or {}).values()]
    parallel.broadcast_state(tensors)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> float32 [0, 1] NCHW (reference preprocess /255),
    contiguous: a permuted view would carry NHWC memory through every conv,
    and the CAM-gate kernel reads NCHW planes."""
    return images.permute(0, 3, 1, 2).contiguous().float() / 255.0


def _loss_batch(batch: dict, device: torch.device) -> dict:
    """The loss's view of a batch, on ``device``, masks NCHW."""
    def dev(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    return {
        "gt_labels": dev(batch["gt_labels"]),
        "gt_bboxes": dev(batch["gt_boxes"]),
        "mask_gt": dev(batch["mask_gt"]),
        "masks": [dev(m).permute(0, 3, 1, 2) for m in batch["masks"]],
    }


def _forward(model, batch, device, compute_dtype, generator=None):
    images = normalize_images(torch.as_tensor(batch["image"]).to(device, non_blocking=True))
    with torch.autocast(device.type, dtype=compute_dtype, enabled=compute_dtype != torch.float32):
        return model(images, generator=generator)


def make_train_step(
    model: MGAModel,
    strides: Sequence[int],
    nc: int,
    det_cfg: DetLossConfig,
    seg_cfg: SegLossConfig,
    weight_decay: float,
    ema_decay: float,
    ema_tau: float,
    accumulate: int = 1,
    compute_dtype: torch.dtype = torch.float32,
    opt_name: str = "sgd",
    nesterov: bool = True,
    warmup_steps: int = 0,
    max_grad_norm: float = 10.0,
) -> Callable:
    """Build the train step (the JAX package's arguments, same meaning).

    ``train_step(state, batch, lr, lr_bias, momentum, generator=None)``:
    ``generator`` (a ``torch.Generator`` on the model's device) feeds the
    random draws of the mask gates of a ``prob_mode`` model, as the JAX
    step's ``rng`` feeds its ``"gater"`` collection.

    Gradient accumulation follows the reference's *summed* convention: the
    v8 loss is already scaled by the micro-batch size, so micro-batch
    gradients add up until the apply, which clips the sum to global norm
    ``max_grad_norm``. With ``warmup_steps > 0`` the effective accumulate
    ramps from 1 to ``accumulate`` over warmup (reference trainer
    ``np.interp(ni, [0, nw], [1, nbs / batch]).round()``). ``model`` is
    the state's model; it is put in train mode.
    """
    update_fn = optim.make_update_fn(opt_name, weight_decay, nesterov)
    device = next(model.parameters()).device

    def acc_now(step: int) -> int:
        if warmup_steps <= 0:
            return accumulate
        t = np.clip(np.float32(step) / np.float32(warmup_steps), 0.0, 1.0)
        return max(1, int(np.round(np.float32(1.0) + t * np.float32(accumulate - 1))))

    @torch.no_grad()
    def apply(state: TrainState, grads: list, lr, lr_bias, momentum) -> None:
        state.opt_step += 1
        parallel.all_reduce_sum_(grads)  # the global batch's gradient, before the clip
        params = state.params()
        if max_grad_norm and max_grad_norm > 0:
            optim.clip_by_global_norm(grads, max_grad_norm)
        update_fn(params, dict(zip(params, grads)), state.opt_state, state.groups,
                  lr, lr_bias, momentum, state.opt_step)
        optim.ema_update(list(state.ema_params.values()),
                         [params[k] for k in state.ema_params], state.opt_step, ema_decay, ema_tau)
        stats = state.bn_stats()
        optim.ema_update(list(state.ema_bn_stats.values()),
                         [stats[k] for k in state.ema_bn_stats], state.opt_step, ema_decay, ema_tau)
        state.last_apply = state.step

    def train_step(state: TrainState, batch: dict, lr: float, lr_bias: float, momentum: float,
                   generator: Optional[torch.Generator] = None):
        state.model.train()
        out = _forward(state.model, batch, device, compute_dtype, generator)
        total, items, logs = mga_loss(out, _loss_batch(batch, device), strides, nc,
                                      state.mtl_log_vars, det_cfg, seg_cfg, parallel.loss_share())
        params = state.params()
        grads = list(torch.autograd.grad(total, list(params.values())))
        state.step += 1
        if accumulate <= 1:
            apply(state, grads, lr, lr_bias, momentum)
        else:
            with torch.no_grad():
                if state.accum_grads is None:
                    state.accum_grads = {k: torch.zeros_like(p) for k, p in params.items()}
                acc = list(state.accum_grads.values())
                torch._foreach_add_(acc, grads)
            if state.step - state.last_apply >= acc_now(state.step):
                apply(state, acc, lr, lr_bias, momentum)
                torch._foreach_zero_(acc)
        return state, {"loss": total.detach(), "items": items, **logs}

    return train_step


def make_eval_step(
    model: MGAModel,
    strides: Sequence[int],
    nc: int,
    det_cfg: DetLossConfig,
    seg_cfg: SegLossConfig,
    compute_dtype: torch.dtype = torch.float32,
    nms_conf: float = 0.001,
    nms_iou: float = 0.7,
    max_det: int = 300,
    nms_multi_label: bool = False,
) -> Callable:
    """Eval step on the EMA weights: decoded predictions, seg logits, the
    val loss items and the device NMS's fixed-shape detections
    ``dets`` (B, max_det', 6) = xyxy, score, class; with a model built with
    ``tap_indices``, its ``taps`` too. ``model`` is copied once into an
    eval-mode twin.

    ``eval_step(state, batch)`` loads the state's EMA into the twin and runs
    the batch. A validation pass, whose EMA does not change between batches,
    calls ``eval_step.load(state)`` once and then ``eval_step.run(state,
    batch)`` for each batch.

    The eval step reduces nothing: with a process group of two or more it
    runs this rank's shard, its ``items`` are the shard's own, and
    ``det_norm`` is the shard's target-score sum, from which the validator
    rebuilds the global batch's items once a pass. Under a mesh that splits
    rows the batch holds this rank's band of the images and the masks
    whole: the model gathers the detection maps whole, the eval step the
    mask logits, and every space rank of a data shard returns the shard's
    outputs, items and detections alike."""
    twin = copy.deepcopy(model).eval()
    device = next(twin.parameters()).device

    @torch.no_grad()
    def load(state: TrainState) -> None:
        dst, src = [], []
        for name, t in (*twin.named_parameters(), *twin.named_buffers()):
            ema = state.ema_params.get(name, state.ema_bn_stats.get(name))
            if ema is not None:
                dst.append(t)
                src.append(ema)
        torch._foreach_copy_(dst, src)

    @torch.no_grad()
    def run(state: TrainState, batch: dict) -> dict:
        out = _forward(twin, batch, device, compute_dtype)
        decoded, raw = out["det"]
        decoded = decoded.float()
        if parallel.mesh() is not None and out["seg"]:
            out["seg"] = dict(zip(out["seg"], spatial.gather_rows(list(out["seg"].values()))))
        _, items, logs = mga_loss({"det": raw, "seg": out["seg"]}, _loss_batch(batch, device), strides,
                                  nc, state.ema_params["mtl_log_vars"], det_cfg, seg_cfg)
        result: dict[str, Any] = {"decoded": decoded, "seg": out["seg"], "items": items,
                                  "det_norm": logs["det/norm"]}
        if "taps" in out:
            result["taps"] = out["taps"]
        boxes, scores, cls = nms(decoded, conf_thres=nms_conf, iou_thres=nms_iou,
                                 max_det=max_det, multi_label=nms_multi_label)
        result["dets"] = torch.cat([boxes, scores[..., None], cls[..., None]], -1)
        return result

    def eval_step(state: TrainState, batch: dict) -> dict:
        load(state)
        return run(state, batch)

    eval_step.load, eval_step.run = load, run
    return eval_step
