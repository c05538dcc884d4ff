"""Checkpoints: the whole train state in one ``torch.save`` file, plus a JSON
metadata file beside it (counterpart of ``mga_yolo_tpu/utils/checkpoint.py``).

``weights/last.pt`` holds what a resume needs: the float32 masters and BN
statistics (``model_state_dict``), the EMA (``ema_state_dict``, the same keys
with the EMA's values), ``mtl_log_vars`` and its EMA, the optimizer slots,
the gradient-accumulation buffer and the step counters ``step`` /
``opt_step`` / ``last_apply``. Its ``model_state_dict``, ``ema_state_dict``
and ``train_args`` (``nc``, ``model``, ``model_scale``) are the reference's
minimal checkpoint format, so ``serve.build_server`` and the reference
toolchain read the file as it is, with no export step. Its ``meta`` holds the
JAX package's metadata keys (epoch, fitness, model YAML path and text, scale,
optimizer, nc, imgsz, date), so one atomic write carries the state and the
epoch it belongs to; ``weights/last.meta.json`` is a copy of them for people
and tools, and is read only for a file without ``meta``.

Files are read with ``torch.load(..., weights_only=True)``: tensors, numbers,
strings and dicts only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import torch

_WRITER: Optional[ThreadPoolExecutor] = None
_PENDING: list[Future] = []
_LOCK = threading.Lock()


def meta_path(path: str | Path) -> Path:
    """``weights/best.pt`` -> ``weights/best.meta.json``."""
    return Path(path).with_suffix(".meta.json")


def checkpoint_meta(ckpt: dict, path: str | Path) -> dict:
    """The metadata of a loaded checkpoint: its own ``meta``, else (a
    reference-format file) the ``.meta.json`` beside it, else {}."""
    if "meta" in ckpt:
        return dict(ckpt["meta"])
    p = meta_path(path)
    return json.loads(p.read_text()) if p.exists() else {}


def _cpu(t: torch.Tensor) -> torch.Tensor:
    """A host copy that later in-place updates of ``t`` cannot reach; from
    the card it is enqueued without waiting (:func:`payload` waits once for
    all of them)."""
    return t.detach().to("cpu", copy=True, non_blocking=t.is_cuda)


def ema_state_dict(state) -> dict:
    """The model's state_dict with the EMA's parameters and BN statistics
    (the other buffers, such as the DFL projection, are the model's)."""
    ema = {**state.ema_params, **state.ema_bn_stats}
    return {k: ema.get(k, v) for k, v in state.model.state_dict().items()}


def payload(state, meta: dict) -> dict:
    """The checkpoint of ``state`` as a dict of host tensors (a copy). The
    copies from the card are enqueued one after another and waited for
    once: one synchronisation instead of one per tensor (~2,400)."""
    out = {
        "model_state_dict": {k: _cpu(v) for k, v in state.model.state_dict().items()},
        "ema_state_dict": {k: _cpu(v) for k, v in ema_state_dict(state).items()},
        "train_args": {"nc": int(meta.get("nc", 1)), "model": meta.get("model_yaml"),
                       "model_scale": meta.get("model_scale")},
        "meta": dict(meta),
        "mtl_log_vars": _cpu(state.mtl_log_vars),
        "ema_mtl_log_vars": _cpu(state.ema_params["mtl_log_vars"]),
        "opt_state": {s: {k: _cpu(v) for k, v in slot.items()} for s, slot in state.opt_state.items()},
        "accum_grads": (None if state.accum_grads is None
                        else {k: _cpu(v) for k, v in state.accum_grads.items()}),
        "step": int(state.step),
        "opt_step": int(state.opt_step),
        "last_apply": int(state.last_apply),
    }
    if state.mtl_log_vars.is_cuda:
        torch.cuda.synchronize(state.mtl_log_vars.device)
    return out


def _write(path: Path, data: dict, meta: dict) -> None:
    """Write each file to a temporary name, then rename: a run stopped
    mid-write leaves the previous file whole. The ``.pt`` carries its own
    metadata, so a stop between the two renames leaves only the side copy
    stale."""
    tmp = path.with_name(path.name + ".tmp")
    torch.save(data, str(tmp))
    os.replace(tmp, path)
    mp = meta_path(path)
    tmp = mp.with_name(mp.name + ".tmp")
    tmp.write_text(json.dumps(meta, indent=2))
    os.replace(tmp, mp)


def save_checkpoint(path: str | Path, state, meta: dict, async_save: bool = False) -> float:
    """Write ``state`` and ``meta`` to ``path`` (a ``.pt`` file) and its
    ``.meta.json``; returns the milliseconds the caller was held.

    The train step updates ``state`` in place, so the host copy is taken
    here, before the call returns, in both modes; ``async_save`` only moves
    the serialisation and the disk write to a background thread, which
    writes the saves in the order they were asked for. Call
    :func:`wait_for_saves` before reading a checkpoint back or exiting.
    """
    global _WRITER
    t0 = time.perf_counter()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = payload(state, meta)
    if async_save:
        with _LOCK:
            if _WRITER is None:
                _WRITER = ThreadPoolExecutor(max_workers=1, thread_name_prefix="mga-ckpt")
            _PENDING.append(_WRITER.submit(_write, path, data, dict(meta)))
    else:
        _write(path, data, meta)
    return (time.perf_counter() - t0) * 1e3


def wait_for_saves() -> None:
    """Block until every background save has been written; re-raises the
    first one's error."""
    with _LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    for fut in pending:
        fut.result()


@torch.no_grad()
def load_checkpoint(path: str | Path, state) -> tuple[Any, dict]:
    """Restore a checkpoint into ``state`` in place (its model, slots, EMA,
    buffer and counters); returns ``(state, meta)``, the metadata saved in
    the same file as the state."""
    wait_for_saves()  # a background save of this very file may still be running
    dev = next(state.model.parameters()).device
    ckpt = torch.load(str(path), map_location=dev, weights_only=True)
    state.model.load_state_dict(ckpt["model_state_dict"], strict=True)
    state.mtl_log_vars.copy_(ckpt["mtl_log_vars"])
    ema_sd = ckpt["ema_state_dict"]
    for k, t in state.ema_params.items():
        t.copy_(ckpt["ema_mtl_log_vars"] if k == "mtl_log_vars" else ema_sd[k])
    for k, t in state.ema_bn_stats.items():
        t.copy_(ema_sd[k])
    if set(ckpt["opt_state"]) != set(state.opt_state):
        raise ValueError(f"{path}: optimizer slots {sorted(ckpt['opt_state'])}, this run has "
                         f"{sorted(state.opt_state)}")
    for s, slot in state.opt_state.items():
        for k, t in slot.items():
            t.copy_(ckpt["opt_state"][s][k])
    acc = ckpt["accum_grads"]
    if acc is None:
        state.accum_grads = None
    elif state.accum_grads is None:
        state.accum_grads = {k: v.clone() for k, v in acc.items()}
    else:
        for k, t in state.accum_grads.items():
            t.copy_(acc[k])
    state.step, state.opt_step, state.last_apply = ckpt["step"], ckpt["opt_step"], ckpt["last_apply"]
    return state, checkpoint_meta(ckpt, path)


def model_config(meta: dict, train_args: dict):
    """The graph of a checkpoint: the recorded YAML if it exists here, else
    the YAML text the metadata keeps, else the recorded path (an absent
    shipped config's stem gives its dict), else the flagship."""
    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.utils import yaml_lite

    path = meta.get("model_yaml") or train_args.get("model")
    if path and Path(path).exists():
        return path
    if meta.get("model_yaml_text"):
        return yaml_lite.loads(meta["model_yaml_text"])
    return path or YOLOV8_CBAM


def rebuild_from_checkpoint(path: str | Path, model_yaml=None, scale: Optional[str] = None,
                            prefer_ema: bool = True, tap_indices: tuple = (),
                            device: str | torch.device | None = None):
    """``(model, meta)`` from a checkpoint file alone, in eval mode on
    ``device`` (CUDA when None).

    Reads the trainer's ``.pt`` (with its ``meta``) or a
    reference-format file (``export-torch``). The graph is ``model_yaml``
    if given, else :func:`model_config`; the scale ``scale``, else
    ``train_args["model_scale"]``, ``train_args["scale"]``, the metadata's;
    ``nc`` from ``train_args``. The EMA weights are preferred, as in the
    reference. Loads with ``strict=True``.
    """
    from mga_yolo_tpu_torch.models.yolo import create_model

    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    meta = checkpoint_meta(ckpt, path)
    train_args = ckpt.get("train_args") or {}
    cfg = model_yaml or model_config(meta, train_args)
    scale = scale or train_args.get("model_scale") or train_args.get("scale") or meta.get("model_scale")
    nc = int(train_args.get("nc", meta.get("nc", 1)))
    net, _ = create_model(cfg, scale=scale, nc=nc, device=device, tap_indices=tuple(tap_indices))
    sd = (prefer_ema and ckpt.get("ema_state_dict")) or ckpt["model_state_dict"]
    net.load_state_dict(sd, strict=True)
    return net, meta
