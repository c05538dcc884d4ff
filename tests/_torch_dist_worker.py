"""Ranks of the port's multi-process gloo checks (tests/test_torch_metrics.py,
tests/test_torch_ddp.py). Imports neither JAX nor the JAX package, so a
spawned rank starts fast."""

from __future__ import annotations

import datetime
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def _init(rank: int, world: int, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))


def metrics_rank(rank: int, world: int, out_dir: str, images: list) -> None:
    """Accumulate this rank's contiguous share of ``images``, gather, and
    save the computed DetMetrics fields to ``out_dir/rank{rank}.npz``."""
    from mga_yolo_tpu_torch.utils.metrics import MetricAccumulator

    _init(rank, world, out_dir)
    try:
        share = len(images) // world
        acc = MetricAccumulator()
        for pb, conf, pc, gt, gc in images[rank * share:(rank + 1) * share]:
            acc.update(pb, conf, pc, gt, gc)
        acc.gather_across_hosts()
        d = acc.compute()
        fields = {f: getattr(d, f) for f in ("precision", "recall", "map50", "map", "ap_class", "ap50_per_class",
                                             "ap_per_class_", "p_per_class", "r_per_class", "nt_per_class",
                                             "curves")}
        np.savez(Path(out_dir) / f"rank{rank}.npz", fields=np.array(fields, dtype=object))
    finally:
        dist.destroy_process_group()


def shard(batch: dict, rank: int, world: int) -> dict:
    """The rank's rows of a global batch dict (the loader's strided shard)."""
    return {k: [m[rank::world] for m in v] if isinstance(v, list) else v[rank::world] for k, v in batch.items()}


def batchnorm_run(x: np.ndarray, dy: np.ndarray, affine: bool, rank: int = 0, world: int = 1) -> dict:
    """A train-mode port ``BatchNorm2d`` (seeded affine parameters and
    running statistics) on the rank's shard of ``x``, backward with ``dy``:
    the output, the input gradient, the affine gradients summed over the
    ranks (as the train step sums every gradient) and the running
    statistics."""
    from mga_yolo_tpu_torch import parallel
    from mga_yolo_tpu_torch.models.layers import BatchNorm2d

    C = x.shape[1]
    rng = np.random.default_rng(1)
    bn = BatchNorm2d(C, affine=affine).train()
    with torch.no_grad():
        if affine:
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, C).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, C).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)))
    xs = torch.from_numpy(x[rank::world].copy()).requires_grad_(True)
    y = bn(xs)
    (y * torch.from_numpy(dy[rank::world].copy())).sum().backward()
    out = {"y": y.detach(), "dx": xs.grad, "running_mean": bn.running_mean, "running_var": bn.running_var}
    if affine:
        grads = [bn.weight.grad, bn.bias.grad]
        parallel.all_reduce_sum_(grads)
        out.update(dweight=grads[0], dbias=grads[1])
    return {k: v.detach().clone() for k, v in out.items()}


def train_steps_run(job: dict, rank: int = 0, world: int = 1) -> list:
    """``job["n_steps"]`` port train steps on the rank's shard of
    ``job["batch"]`` from the weights in ``job["weights"]`` (a state_dict
    file) and ``job["mtl"]``; with ``job["prob"]``, a model with that
    ProbMaskGater mode and a generator seeded 11. Per step a view: the loss
    and items summed over the ranks (the global batch's) and copies of the
    params, BN statistics, momentum, EMA and EMA BN statistics."""
    from mga_yolo_tpu_torch import parallel
    from mga_yolo_tpu_torch.losses import DetLossConfig, SegLossConfig
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.train import state as TS

    kw = {"prob_approach": job["prob"]} if job.get("prob") else {}
    model, _ = create_model(job["cfg"], scale="n", nc=1, device="cpu", training=True, **kw)
    model.load_state_dict(torch.load(job["weights"], weights_only=True), strict=True)
    st = TS.create_train_state(model)
    with torch.no_grad():
        st.mtl_log_vars.copy_(torch.from_numpy(job["mtl"]))
        st.ema_params["mtl_log_vars"].copy_(torch.from_numpy(job["mtl"]))
    step = TS.make_train_step(model, (8, 16, 32), 1, DetLossConfig(), SegLossConfig(), **job["step_kw"])
    gen = torch.Generator().manual_seed(11) if job.get("prob") else None
    batch = shard(job["batch"], rank, world)
    views = []
    for _ in range(job["n_steps"]):
        st, m = step(st, batch, *job["lr"], gen)
        loss_items = torch.cat([m["loss"].reshape(1), m["items"]])
        parallel.all_reduce_sum_([loss_items])
        clone = lambda d: {k: t.detach().clone() for k, t in d.items()}  # noqa: E731
        views.append({"loss": float(loss_items[0]), "items": loss_items[1:].numpy(), "params": clone(st.params()),
                      "bn": clone(st.bn_stats()), "m": clone(st.opt_state["m"]), "ema": clone(st.ema_params),
                      "ema_bn": clone(st.ema_bn_stats), "opt_step": st.opt_step})
    return views


def fit_run(fit: dict, rank: int = 0, world: int = 1) -> dict:
    """``MGA.train`` with ``fit["kw"]``, then a resume for one more epoch;
    returns each run's results.csv rows (every rank's, from the callbacks),
    final state and final evaluation's confusion matrix (with the file's
    copy of it, where this rank wrote one), and whether this rank's trainer
    had a results.csv."""
    from mga_yolo_tpu_torch.api import MGA
    from mga_yolo_tpu_torch.train import trainer as T

    rows: list = []

    class RecordingBus(T.CallbackBus):
        def fire(self, event, **kw):
            if event == "on_fit_epoch_end":
                rows.append({k: v for k, v in kw["row"].items() if k != "time"})
            super().fire(event, **kw)

    T.CallbackBus = RecordingBus
    out = {}
    for run, epochs in (("fit", fit["epochs"]), ("resume", fit["epochs"] + 1)):
        rows.clear()
        m = MGA("configs/models/yolov8_cbam.yaml", scale="n")
        result = m.train(fit["cfg"], epochs=epochs, resume=run == "resume", **fit["kw"])
        tr = m._trainer
        cm_file = tr.save_dir / "confusion_matrix.npy"
        out[run] = {"rows": list(rows), "start_epoch": tr.start_epoch, "save_dir": str(tr.save_dir),
                    "has_csv": tr.csv is not None, "step": tr.state.step, "confusion": result.confusion.matrix,
                    "confusion_file": np.load(cm_file) if tr.is_main and cm_file.exists() else None,
                    "state": {k: v.detach().clone() for k, v in tr.state.params().items()}}
    return out


def refusals(fit: dict) -> dict:
    """The messages of the trainer's refusals under the group: a global batch
    that does not divide by the world size, and the spatial mesh axis."""
    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.train.trainer import MGATrainer

    out = {}
    for what, kw in (("batch", {"batch": 3}), ("spatial", {"mesh_spatial": 2})):
        try:
            MGATrainer(load_config(fit["cfg"], model="configs/models/yolov8_cbam.yaml",
                                   **{**fit["kw"], "epochs": 1, **kw}))
            out[what] = None
        except (ValueError, NotImplementedError) as e:
            out[what] = f"{type(e).__name__}: {e}"
    return out


def ddp_rank(rank: int, world: int, out_dir: str, jobs: dict) -> None:
    """One rank of tests/test_torch_ddp.py: each job in ``jobs`` on this
    rank's shard, the results saved to ``out_dir/rank{rank}.pt``."""
    torch.set_num_threads(2)
    _init(rank, world, out_dir)
    try:
        out = {}
        for name, (x, dy, affine) in jobs.get("bn", {}).items():
            out[f"bn_{name}"] = batchnorm_run(x, dy, affine, rank, world)
        for name, job in jobs.get("steps", {}).items():
            out[f"steps_{name}"] = train_steps_run(job, rank, world)
        if "fit" in jobs:
            out["refusals"] = refusals(jobs["fit"])
            out["fit"] = fit_run(jobs["fit"], rank, world)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def cli_train_rank(rank: int, world: int, port: int, argv: list, out_dir: str) -> None:
    """One rank as ``torchrun`` starts it: its variables in the environment
    and ``cli.train.main(argv)``, which initialises the group from them and
    destroys it at the end. Saves the final evaluation and whether a group
    is left to ``out_dir/cli_rank{rank}.pt``."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(2)
    from mga_yolo_tpu_torch.cli.train import main

    result = main(argv)
    torch.save({"map": (result.metrics.map50, result.metrics.map), "loss_items": result.loss_items,
                "confusion": result.confusion.matrix, "group_left": dist.is_initialized()},
               Path(out_dir) / f"cli_rank{rank}.pt")
