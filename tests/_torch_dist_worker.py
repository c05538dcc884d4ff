"""Ranks of the port's multi-process gloo checks (tests/test_torch_metrics.py,
tests/test_torch_ddp.py, tests/test_torch_spatial.py). Imports neither JAX
nor the JAX package, so a spawned rank starts fast."""

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
    ProbMaskGater mode and a generator seeded 11; with ``job["spatial"]`` k,
    on a DP x SP mesh of k space ranks (the rank's band of its data shard);
    with ``job["f64"]``, the model, the images and the optimizer in float64
    (the loss and the plain CAM gate compute in float32, as the port's do).
    Per step a view: the loss and items summed over the ranks (the global
    batch's) and copies of the params, BN statistics, momentum, EMA and EMA
    BN statistics; with a mesh also the tallest input any conv saw."""
    from mga_yolo_tpu_torch import parallel

    with parallel.using(parallel.data_mesh(job.get("spatial", 1))) as mesh:
        return _train_steps(job, mesh)


def _train_steps(job: dict, mesh) -> list:
    from unittest import mock

    import torch.nn.functional as F

    from mga_yolo_tpu_torch import parallel
    from mga_yolo_tpu_torch.losses import DetLossConfig, SegLossConfig
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.parallel import spatial
    from mga_yolo_tpu_torch.train import state as TS

    kw = {"prob_approach": job["prob"]} if job.get("prob") else {}
    model, _ = create_model(job["cfg"], scale="n", nc=1, device="cpu", training=True, **kw)
    model.load_state_dict(torch.load(job["weights"], weights_only=True), strict=True)
    normalize = base = TS.normalize_images
    if job.get("f64"):
        model.double()
        normalize = lambda im: base(im).double()  # noqa: E731
    st = TS.create_train_state(model)
    with torch.no_grad():
        st.mtl_log_vars.copy_(torch.from_numpy(job["mtl"]))
        st.ema_params["mtl_log_vars"].copy_(torch.from_numpy(job["mtl"]))
    step = TS.make_train_step(model, (8, 16, 32), 1, DetLossConfig(), SegLossConfig(), **job["step_kw"])
    gen = torch.Generator().manual_seed(11) if job.get("prob") else None
    batch = spatial.keep_rows(shard(job["batch"], mesh.data_rank, mesh.data))
    views = []
    conv2d, rows = F.conv2d, []

    def seen(x, *a, **kw):  # the rows of every conv's input
        rows.append(x.shape[2])
        return conv2d(x, *a, **kw)

    for _ in range(job["n_steps"]):
        with mock.patch.object(F, "conv2d", seen), mock.patch.object(TS, "normalize_images", normalize):
            st, m = step(st, batch, *job["lr"], gen)
        loss_items = torch.cat([m["loss"].reshape(1), m["items"]])
        parallel.all_reduce_sum_([loss_items])
        clone = lambda d: {k: t.detach().clone() for k, t in d.items()}  # noqa: E731
        views.append({"loss": float(loss_items[0]), "items": loss_items[1:].numpy(), "params": clone(st.params()),
                      "bn": clone(st.bn_stats()), "m": clone(st.opt_state["m"]), "ema": clone(st.ema_params),
                      "ema_bn": clone(st.ema_bn_stats), "opt_step": st.opt_step, "conv_rows": max(rows)})
    return views


def fit_run(fit: dict, rank: int = 0, world: int = 1) -> dict:
    """``MGA.train`` with ``fit["kw"]``, then (unless ``fit["resume"]`` is
    False) a resume for one more epoch; returns each run's results.csv rows
    (every rank's, from the callbacks), final state and final evaluation's
    confusion matrix (with the file's copy of it, where this rank wrote
    one), whether this rank's trainer had a results.csv and took the device
    augmentation, and the PNGs of its run directory. The ranks run without
    matplotlib (``block_matplotlib``), so a run with ``plots`` saves the
    arrays, as on the card's host."""
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
    runs = (("fit", fit["epochs"]), ("resume", fit["epochs"] + 1))
    for run, epochs in runs if fit.get("resume", True) else runs[:1]:
        rows.clear()
        m = MGA("configs/models/yolov8_cbam.yaml", scale="n")
        result = m.train(fit["cfg"], epochs=epochs, resume=run == "resume", **fit["kw"])
        tr = m._trainer
        cm_file = tr.save_dir / "confusion_matrix.npy"
        out[run] = {"rows": list(rows), "start_epoch": tr.start_epoch, "save_dir": str(tr.save_dir),
                    "has_csv": tr.csv is not None, "step": tr.state.step, "confusion": result.confusion.matrix,
                    "confusion_file": np.load(cm_file) if tr.is_main and cm_file.exists() else None,
                    "device_augment": tr.device_augment, "pngs": sorted(p.name for p in tr.save_dir.glob("*.png")),
                    "state": {k: v.detach().clone() for k, v in tr.state.params().items()}}
    return out


def refusals(fit: dict) -> dict:
    """The messages of the trainer's refusals under the group: a global batch
    that does not divide by the world size, a world that does not divide by
    ``mesh_spatial``, and an image size that is no multiple of 32
    ``mesh_spatial``."""
    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.train.trainer import MGATrainer

    out = {}
    for what, kw in (("batch", {"batch": 3, "mesh_spatial": 1}), ("world", {"mesh_spatial": 3, "imgsz": 96}),
                     ("imgsz", {"mesh_spatial": 2, "imgsz": 96})):
        try:
            MGATrainer(load_config(fit["cfg"], model="configs/models/yolov8_cbam.yaml",
                                   **{**fit["kw"], "epochs": 1, **kw}))
            out[what] = None
        except (ValueError, NotImplementedError) as e:
            out[what] = f"{type(e).__name__}: {e}"
    return out


HALO_OPS = {  # name -> (a module of seeded weights or a pool's (k, s, p), input rows a band at k=2 and k=4)
    "conv3_s1": (lambda: torch.nn.Conv2d(3, 4, 3, 1, 1), (1, 1)),
    "conv3_s2": (lambda: torch.nn.Conv2d(3, 4, 3, 2, 1), (2, 2)),
    "pool5": ((5, 1, 2), (1, 1)),
    "conv7": (lambda: torch.nn.Conv2d(3, 1, 7, 1, 3, bias=False), (1, 1)),
    "conv3_s1_tall": (lambda: torch.nn.Conv2d(3, 4, 3, 1, 1), (4, 3)),
}


def halo_ops_run(rank: int, world: int) -> dict:
    """Each op of :data:`HALO_OPS` on this rank's band of a seeded input,
    under a mesh of ``world`` space ranks, beside the op on the whole input
    (no mesh): the outputs, the input gradients (this band's rows) and the
    weight gradients (summed over the ranks) for a seeded cotangent."""
    from mga_yolo_tpu_torch import parallel
    from mga_yolo_tpu_torch.parallel import spatial

    out = {}
    with parallel.using(parallel.data_mesh(world)) as mesh:
        for name, (make, rows) in HALO_OPS.items():
            h = rows[0] if world == 2 else rows[1]
            rng = np.random.default_rng(len(name) + h)
            x = torch.from_numpy(rng.normal(0, 1, (2, 3, h * world, 5)).astype(np.float32))
            if callable(make):
                torch.manual_seed(3)
                mod = make()
                fn, whole = (lambda t: spatial.conv(mod, t)), mod
            else:
                mod = None
                fn = lambda t: spatial.max_pool2d(t, *make)  # noqa: E731
                whole = lambda t: torch.nn.functional.max_pool2d(t, *make)  # noqa: E731
            res = {}
            for what, xin, f in (("whole", x, whole), ("band", x[:, :, rank * h:(rank + 1) * h], fn)):
                xin = xin.detach().clone().requires_grad_(True)
                with parallel.using(None if what == "whole" else mesh):
                    y = f(xin)
                dy = torch.from_numpy(np.random.default_rng(7).normal(0, 1, (2, y.shape[1], y.shape[2] *
                                                                            (1 if what == "whole" else world),
                                                                            y.shape[3])).astype(np.float32))
                if what == "band":
                    dy = dy[:, :, rank * y.shape[2]:(rank + 1) * y.shape[2]]
                leaves = [xin] + ([] if mod is None else list(mod.parameters()))
                grads = list(torch.autograd.grad((y * dy).sum(), leaves))
                if what == "band" and mod is not None:
                    parallel.all_reduce_sum_(grads[1:])
                res[what] = {"y": y.detach(), "grads": [g.detach() for g in grads]}
            out[name] = {**res, "h": h}
    return out


def pool_cases(world: int) -> dict:
    """Seeded MaskCBAM / MaskECA pool inputs (B=3, C=16, 8 x 6), float32:
    random; a channel's max planted on two bands (the rows either side of
    the first band boundary) of one image; no pixel over 0.5 and a tiny
    mask (both GAP fallbacks); and msum / N just under ``tiny_thr`` 1e-4,
    all of the mask on the first band."""
    rng = np.random.default_rng(5)
    B, C, H, W = 3, 16, 8, 6
    x = rng.normal(0, 1, (B, C, H, W)).astype(np.float32)
    m = (rng.uniform(0, 1, (B, 1, H, W)) ** 2).astype(np.float32)
    cases = {"random": (x, m)}
    tie_x, tie_m = x.copy(), m.copy()
    edge = H // world
    tie_x[1, 5, edge - 1, 0] = tie_x[1, 5, edge, 2] = 9.0
    tie_m[1, 0, edge - 1, 0] = tie_m[1, 0, edge, 2] = 0.9
    cases["tie"] = (tie_x, tie_m)
    cases["invalid"] = (x, np.zeros_like(m))
    tiny = np.zeros_like(m)
    tiny[:, :, :edge] = 0.999e-4 * H / edge
    cases["tiny"] = (x, tiny)
    return cases


def pool_run(rank: int, world: int) -> dict:
    """For each of :func:`pool_cases`: the space-reduced CAM gate and masked
    pool on this rank's band beside ``cam_gate_ref`` and ``masked_pool_ref``
    on the whole image, forward and backward: seeded cotangents, of which
    each rank, holding the (B, C) outputs alike, takes 1/world (its part of
    a loss counted once); the MLP's gradients summed over the ranks."""
    from mga_yolo_tpu_torch import parallel
    from mga_yolo_tpu_torch.ops.cam_gate import cam_gate_ref
    from mga_yolo_tpu_torch.ops.masked_pool import masked_pool_ref
    from mga_yolo_tpu_torch.parallel import spatial

    rng = np.random.default_rng(9)
    C, hid = 16, 4
    mlp = [torch.from_numpy((0.3 * rng.normal(0, 1, s)).astype(np.float32)) for s in ((hid, C), (hid,), (C, hid), (C,))]
    g_gate, g_avg, g_max = (torch.from_numpy(rng.normal(0, 1, (3, C)).astype(np.float32)) for _ in range(3))
    out = {}
    with parallel.using(parallel.data_mesh(world)) as mesh:
        for name, (x, m) in pool_cases(world).items():
            h = x.shape[2] // world
            res = {}
            for what in ("whole", "band"):
                sl = slice(None) if what == "whole" else slice(rank * h, (rank + 1) * h)
                xs = torch.from_numpy(x[:, :, sl].copy()).requires_grad_(True)
                ms = torch.from_numpy(m[:, :, sl].copy()).requires_grad_(True)
                ws = [w.clone().requires_grad_(True) for w in mlp]
                part = 1.0 if what == "whole" else 1.0 / world  # exact: world is 2 or 4
                with parallel.using(None if what == "whole" else mesh):
                    gate = (cam_gate_ref if what == "whole" else spatial.cam_gate)(xs, ms, *ws)
                    pool = masked_pool_ref(xs, ms) if what == "whole" else spatial.pool_f32(xs, ms)
                    gg = list(torch.autograd.grad((gate * g_gate * part).sum(), [xs, ms, *ws]))
                    gp = list(torch.autograd.grad(((pool[0] * g_avg).sum() + (pool[1] * g_max).sum()) * part,
                                                  [xs, ms]))
                if what == "band":
                    parallel.all_reduce_sum_(gg[2:])
                res[what] = {"gate": gate.detach(), "gate_grads": gg, "pool": [p.detach() for p in pool],
                             "pool_grads": gp}
            out[name] = {**res, "h": h}
    return out


def val_run(job: dict, rank: int = 0, world: int = 1) -> dict:
    """A seeded flagship's EMA validated on ``job["data"]``'s val split
    (batch 4, the rank's shard of each global batch): the confusion matrix,
    the images scored and the metrics."""
    from mga_yolo_tpu_torch.config import det_loss_config, load_config, seg_loss_config
    from mga_yolo_tpu_torch.data.dataset import MGADataset
    from mga_yolo_tpu_torch.data.loader import DataLoader
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.train import state as TS
    from mga_yolo_tpu_torch.train.validator import Validator

    cfg = load_config("configs/hyperparams/cbam_defaults.yaml", data=job["data"], imgsz=64, max_boxes=4)
    torch.manual_seed(0)
    model, spec = create_model("configs/models/yolov8_cbam.yaml", scale="n", nc=1, device="cpu", training=True)
    with torch.no_grad():  # a class bias that lets detections through, so the matching has work
        for seq in model.model[-1].cv3:
            seq[-1].bias.fill_(0.0)
    st = TS.create_train_state(model)
    step = TS.make_eval_step(model, model.det_strides, 1, det_loss_config(cfg), seg_loss_config(cfg))
    loader = DataLoader(MGADataset(cfg, "val", augment=False), batch_size=4, shuffle=False, drop_last=False,
                        workers=1, device="cpu", num_shards=world, shard_index=rank)
    res = Validator(step, loader, cfg)(st)
    return {"confusion": res.confusion.matrix, "n_images": res.n_images, "map": (res.metrics.map50, res.metrics.map),
            "nt": res.metrics.nt_per_class}


def resize_refusals() -> list:
    """The messages of a bilinear and a nearest resize that is not an
    identity, under a mesh of the world's ranks as space ranks."""
    from mga_yolo_tpu_torch import parallel
    from mga_yolo_tpu_torch.models.layers import resize_bilinear, resize_nearest

    out = []
    with parallel.using(parallel.data_mesh(parallel.world())):
        for fn in (resize_bilinear, resize_nearest):
            try:
                fn(torch.zeros(1, 1, 4, 4), (8, 8))
                out.append(None)
            except ValueError as e:
                out.append(str(e))
        out.append(tuple(resize_bilinear(torch.ones(1, 1, 4, 4), (4, 4)).shape))  # the identity passes
    return out


def block_matplotlib() -> None:
    """Make ``import matplotlib`` fail in this process, as on the card's host."""
    import sys

    sys.modules["matplotlib"] = None


def wait_for(path: str, timeout: float = 600.0) -> None:
    """Return once ``path`` exists (the test writes the JAX package's
    weights while the ranks run)."""
    import time

    deadline = time.monotonic() + timeout
    while not Path(path).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no weights at {path}")
        time.sleep(0.2)


def ddp_rank(rank: int, world: int, out_dir: str, jobs: dict) -> None:
    """One rank of tests/test_torch_ddp.py: each job in ``jobs`` on this
    rank's shard, the jobs that need no weights first, then the train
    steps, each once its weights file exists; the results saved to
    ``out_dir/rank{rank}.pt``."""
    torch.set_num_threads(2)
    block_matplotlib()
    _init(rank, world, out_dir)
    try:
        out = {}
        for name, (x, dy, affine) in jobs.get("bn", {}).items():
            out[f"bn_{name}"] = batchnorm_run(x, dy, affine, rank, world)
        if "fit" in jobs:
            out["refusals"] = refusals(jobs["fit"])
            out["fit"] = fit_run(jobs["fit"], rank, world)
        for name, job in jobs.get("steps", {}).items():
            wait_for(job["weights"])
            out[f"steps_{name}"] = train_steps_run(job, rank, world)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spatial_rank(rank: int, world: int, out_dir: str, jobs: dict) -> None:
    """One rank of tests/test_torch_spatial.py (a gloo group when ``world`` >
    1; none for the one-process references): the jobs that need no weights
    first, then the train steps, each once its weights file exists (the
    test writes the JAX package's weights while the ranks run). The results
    are saved to ``out_dir/rank{rank}.pt``."""
    torch.set_num_threads(2)
    block_matplotlib()
    if world > 1:
        _init(rank, world, out_dir)
    try:
        out = {}
        if jobs.get("halo"):
            out["halo"] = halo_ops_run(rank, world)
        if jobs.get("pool"):
            out["pool"] = pool_run(rank, world)
        if "val" in jobs:
            out["val"] = val_run(jobs["val"], rank, world)
        if "resize" in jobs:
            out["resize"] = resize_refusals()
        if "fit" in jobs:
            if world > 1:
                out["refusals"] = refusals(jobs["fit"])
            out["fit"] = fit_run(jobs["fit"], rank, world)
        if "fit_dev" in jobs:
            out["fit_dev"] = fit_run(jobs["fit_dev"], rank, world)
        for name, job in jobs.get("steps", {}).items():
            wait_for(job["weights"])
            out[f"steps_{name}"] = train_steps_run(job, rank, world)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        if world > 1:
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
