"""Optimizer choice, parameter groups, updates, schedule and EMA.

Counterpart of ``mga_yolo_tpu/train/optim.py`` (the reference recipe:
Ultralytics ``build_optimizer``, the warmup interpolation of ``_do_train``
and ``ModelEMA``):

* :func:`resolve_optimizer` with the reference's ``auto`` rule;
* three parameter groups by name (:func:`param_groups`): 0 = weights with
  ndim > 1 (decayed; MaskECA's ``conv1d.weight`` too), 1 = the rest (BN
  weights, the attention blocks' ``beta``, ``mtl_log_vars``), 2 = biases
  (no decay, their own warmup lr);
* SGD (Nesterov), Adam / AdamW and RMSProp updates (:func:`make_update_fn`)
  with the JAX package's decay conventions, :func:`clip_by_global_norm`;
* :class:`Schedule` (lr / bias lr / momentum per iteration) and the ramped
  :func:`ema_update`, counted in optimizer steps.

Parameters, gradients and slots are dicts of tensors keyed by the PyTorch
parameter name (plus ``"mtl_log_vars"``). Updates run as ``torch._foreach``
operations over each group; the JAX package's flat (N,) buffers are a TPU
dispatch device with the same values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]

_ADAM_FAMILY = {"adam", "adamax", "nadam", "radam"}
_KNOWN = _ADAM_FAMILY | {"adamw", "rmsprop", "sgd"}
SLOTS = {"sgd": ("m",), "adam": ("m", "v"), "adamw": ("m", "v"), "rmsprop": ("m", "sq")}


@dataclasses.dataclass(frozen=True)
class OptSpec:
    """Resolved optimizer choice (after the reference's 'auto' rule)."""

    name: str            # canonical: sgd | adam | adamw | rmsprop
    lr0: float
    momentum: float      # SGD momentum / Adam beta1 / RMSProp momentum
    warmup_bias_lr: float
    auto_selected: bool = False


def resolve_optimizer(name: str, nc: int, iterations: float, lr0: float, momentum: float,
                      warmup_bias_lr: float) -> OptSpec:
    """Reference name resolution incl. the 'auto' rule: SGD(0.01, 0.9) above
    10k iterations, else AdamW(lr 0.002*5/(4+nc), 0.9); auto zeroes the
    bias warmup lr. iterations = ceil(n_images / max(batch, nbs)) * epochs."""
    n = name.lower()
    if n == "auto":
        if iterations > 10000:
            return OptSpec("sgd", 0.01, 0.9, 0.0, auto_selected=True)
        return OptSpec("adamw", round(0.002 * 5 / (4 + nc), 6), 0.9, 0.0, auto_selected=True)
    if n not in _KNOWN:
        raise ValueError(f"unknown optimizer {name!r}; choose from auto|SGD|Adam|AdamW|Adamax|NAdam|RAdam|RMSProp")
    return OptSpec("adam" if n in _ADAM_FAMILY else n, lr0, momentum, warmup_bias_lr)


def param_groups(params: Tensors) -> Dict[str, int]:
    """Group tag of every parameter: 2 for ``*.bias``, 0 for weights with
    ndim > 1 (conv, Linear, ``sam_conv``), 1 for the rest."""
    def tag(name: str, p: torch.Tensor) -> int:
        if name.endswith(".bias"):
            return 2
        if name.endswith("weight") and p.dim() > 1:
            return 0
        return 1
    return {k: tag(k, p) for k, p in params.items()}


def init_opt_state(opt_name: str, params: Tensors) -> Dict[str, Tensors]:
    """Zeroed slot buffers per optimizer: {"m"[, "v" | "sq"]: {name: tensor}}."""
    if opt_name not in SLOTS:
        raise ValueError(opt_name)
    return {s: {k: torch.zeros_like(p) for k, p in params.items()} for s in SLOTS[opt_name]}


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """Scale ``grads`` in place to global L2 norm <= max_norm (reference
    ``clip_grad_norm_(max_norm=10)``); the scale stays on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = (max_norm / (norm + 1e-6)).clamp(max=1.0)
    torch._foreach_mul_(grads, scale)


def make_update_fn(opt_name: str, weight_decay: float, nesterov: bool = True) -> Callable:
    """``update(params, grads, opt_state, groups, lr, lr_bias, momentum,
    opt_step)`` for the chosen optimizer, updating params and slots in place.

    Decay as the JAX package: SGD / Adam / RMSProp add ``wd * p`` to the
    gradient of group 0; AdamW decays decoupled (p *= 1 - lr*wd). Group 2
    steps with ``lr_bias``. ``opt_step`` is the 1-based optimizer step
    (Adam's bias correction). ``grads`` may be modified.
    """
    if opt_name not in SLOTS:
        raise ValueError(opt_name)

    def split(params, grads, opt_state, groups):
        """Per group: (tag, [p], [g], {slot: [buf]})."""
        out = []
        for tag in (0, 1, 2):
            keys = [k for k in params if groups[k] == tag]
            if keys:
                out.append((tag, [params[k] for k in keys], [grads[k] for k in keys],
                            {s: [opt_state[s][k] for k in keys] for s in opt_state}))
        return out

    def update(params, grads, opt_state, groups, lr, lr_bias, momentum, opt_step):
        for tag, p, g, slots in split(params, grads, opt_state, groups):
            step_lr = lr_bias if tag == 2 else lr
            decay = weight_decay if tag == 0 else 0.0
            if opt_name == "sgd":
                if decay:
                    g = torch._foreach_add(g, p, alpha=decay)
                buf = slots["m"]
                torch._foreach_mul_(buf, momentum)
                torch._foreach_add_(buf, g)
                d = torch._foreach_add(g, buf, alpha=momentum) if nesterov else buf
                torch._foreach_add_(p, d, alpha=-step_lr)
            elif opt_name in ("adam", "adamw"):
                beta2, eps = 0.999, 1e-8
                t = np.float32(opt_step)
                bc1 = float(np.float32(1.0) - np.power(np.float32(momentum), t))
                bc2 = float(np.float32(1.0) - np.power(np.float32(beta2), t))
                if opt_name == "adam" and decay:
                    g = torch._foreach_add(g, p, alpha=decay)
                m, v = slots["m"], slots["v"]
                torch._foreach_mul_(m, momentum)
                torch._foreach_add_(m, g, alpha=1.0 - momentum)
                torch._foreach_mul_(v, beta2)
                torch._foreach_addcmul_(v, g, g, value=1.0 - beta2)
                if opt_name == "adamw" and decay:
                    torch._foreach_mul_(p, 1.0 - step_lr * decay)
                denom = torch._foreach_div(v, bc2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, eps)
                num = torch._foreach_div(m, bc1)
                torch._foreach_mul_(num, step_lr)
                torch._foreach_div_(num, denom)
                torch._foreach_sub_(p, num)
            else:  # rmsprop
                alpha, eps = 0.99, 1e-8
                if decay:
                    g = torch._foreach_add(g, p, alpha=decay)
                m, sq = slots["m"], slots["sq"]
                torch._foreach_mul_(sq, alpha)
                torch._foreach_addcmul_(sq, g, g, value=1.0 - alpha)
                denom = torch._foreach_sqrt(sq)
                torch._foreach_add_(denom, eps)
                torch._foreach_mul_(m, momentum)
                torch._foreach_add_(m, torch._foreach_div(g, denom))
                torch._foreach_add_(p, m, alpha=-step_lr)

    return update


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Per-iteration lr / bias lr / momentum schedule (host floats)."""

    lr0: float
    lrf: float
    momentum: float
    warmup_epochs: float
    warmup_momentum: float
    warmup_bias_lr: float
    epochs: int
    steps_per_epoch: int
    cos_lr: bool = False

    def epoch_lr_factor(self, epoch: int) -> float:
        x = epoch / max(1, self.epochs)
        if self.cos_lr:
            return (1 - self.lrf) * 0.5 * (1 + math.cos(math.pi * x)) + self.lrf
        return max(1 - x, 0) * (1.0 - self.lrf) + self.lrf

    @property
    def warmup_steps(self) -> int:
        return max(round(self.warmup_epochs * self.steps_per_epoch), 100)

    def at(self, step: int) -> tuple[float, float, float]:
        """(lr, lr_bias, momentum) for global iteration ``step``."""
        epoch = step // max(1, self.steps_per_epoch)
        base = self.lr0 * self.epoch_lr_factor(epoch)
        nw = self.warmup_steps
        if step < nw:
            t = step / nw
            lr = t * base
            lr_bias = self.warmup_bias_lr + t * (base - self.warmup_bias_lr)
            mom = self.warmup_momentum + t * (self.momentum - self.warmup_momentum)
        else:
            lr = lr_bias = base
            mom = self.momentum
        return lr, lr_bias, mom


def ema_decay_at(updates: int, decay: float, tau: float) -> float:
    """Ramped decay d = decay * (1 - exp(-updates / tau)), in float32 as the
    JAX package computes it on the device."""
    u, dc, tu = np.float32(updates), np.float32(decay), np.float32(tau)
    return float(dc * (np.float32(1.0) - np.exp(-u / tu)))


def ema_update(ema: list[torch.Tensor], values: list[torch.Tensor], updates: int, decay: float,
               tau: float) -> None:
    """ema = ema * d + value * (1 - d) in place (reference ModelEMA);
    ``updates`` is the optimizer-step count, not the micro-step count."""
    d = ema_decay_at(updates, decay, tau)
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, values, alpha=1.0 - d)
