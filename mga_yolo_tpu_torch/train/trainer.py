"""MGATrainer: a whole training run (counterpart of
``mga_yolo_tpu/train/trainer.py``).

Epochs of train micro-steps fed by the loader through its pinned copy, the
warmup and linear / cosine schedule, the EMA, a validation per epoch with
mAP, early stopping on fitness, results.csv with the reference's columns
(the learned Kendall weights, the attention gates and SPADE statistics
included), best / last / periodic checkpoints, resume, the final evaluation
of the EMA, and profiling.yaml.

Runs on one device: CUDA unless ``train.device`` says ``cpu`` (or
``cuda:N``); ``amp`` is bf16 autocast on CUDA and float32 on the CPU.
Data-parallel on the ranks of an initialised process group (``parallel``),
as the JAX trainer is on ``jax.process_count()`` hosts: ``train.batch`` is
the global batch, each rank takes its strided shard of every train and val
batch (on ``cuda:LOCAL_RANK`` when the device is ``cuda`` or unset), the
steps compute the global batch's update, and only rank 0 writes (the run
directory, results.csv, checkpoints, profiling.yaml, plots, traces,
the callbacks' loggers).
With ``augment.on_device`` (and a config ``device_augment.supported``
accepts) the loader hands over raw canvases and the warp, HSV, flip and
mask pyramid run on the run's device before each micro-step
(:attr:`MGATrainer.device_augment`); otherwise the reason is printed and the
host path runs, as in the JAX package. ``mesh_spatial`` k > 1 trains on a DP
x SP mesh (``parallel.data_mesh``, the JAX package's ``mesh_spatial``): the
world's ranks form ``world / k`` data shards of the global batch and each
rank of a shard holds a band of ``imgsz / k`` rows of its images
(``parallel/spatial.py``), so the world must divide by k, the global batch
by the data shards, and ``imgsz`` by 32 k.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from mga_yolo_tpu_torch import parallel
from mga_yolo_tpu_torch.config import MGAConfig, det_loss_config, seg_loss_config
from mga_yolo_tpu_torch.data import device_augment as DA
from mga_yolo_tpu_torch.data.dataset import MGADataset
from mga_yolo_tpu_torch.data.loader import DataLoader
from mga_yolo_tpu_torch.device import resolve_device
from mga_yolo_tpu_torch.models.yolo import MGAModel, create_model
from mga_yolo_tpu_torch.parallel import spatial
from mga_yolo_tpu_torch.train import optim
from mga_yolo_tpu_torch.train import state as S
from mga_yolo_tpu_torch.train.validator import Validator, ValResult
from mga_yolo_tpu_torch.utils import checkpoint as ckpt_util
from mga_yolo_tpu_torch.utils import yaml_lite
from mga_yolo_tpu_torch.utils.callbacks import CallbackBus, MLflowLogger, TensorBoardLogger, WandBLogger
from mga_yolo_tpu_torch.utils.csvlog import ResultsCSV, loss_items_to_row
from mga_yolo_tpu_torch.utils.metrics import DetMetrics

PROFILE_STEPS = 8  # micro-steps the ``extra.profile`` trace covers


class EarlyStopping:
    """Patience-based stop on fitness (the reference's ``EarlyStopping``)."""

    def __init__(self, patience: int = 100):
        self.patience = patience or float("inf")
        self.best_fitness = 0.0
        self.best_epoch = 0

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_fitness = fitness
            self.best_epoch = epoch
        return (epoch - self.best_epoch) >= self.patience


def count_gflops(spec, imgsz: int) -> Optional[float]:
    """GFLOPs of one eval forward at ``imgsz`` by
    ``torch.utils.flop_counter.FlopCounterMode``: twice the multiply-adds of
    the convolutions and matrix products. The model is built and run on fake
    tensors (shapes only), so nothing is computed and no kernel launches.
    This is not the JAX package's XLA ``cost_analysis`` (which counts every
    operation) and is not held to it. None if the count fails."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with FakeTensorMode(), parallel.using(None):  # one process's model, whatever mesh is in effect
            model = MGAModel(spec).eval()
            with FlopCounterMode(display=False) as fc, torch.no_grad():
                model(torch.zeros(1, 3, imgsz, imgsz))
        return round(fc.get_total_flops() / 1e9, 3)
    except Exception as e:
        print(f"[MGA] GFLOPs at {imgsz} px not counted: {type(e).__name__}: {e}")
        return None


class MGATrainer:
    def __init__(self, cfg: MGAConfig):
        self.cfg = cfg
        t = cfg.train
        # everything that can refuse the config runs before the run directory exists
        self.world, self.rank, self.is_main = parallel.world(), parallel.rank(), parallel.is_main()
        self.device = resolve_device(parallel.local_device(t.device))
        k = int(cfg.extra.get("mesh_spatial", 1) or 1)
        if k > 1:
            spatial.check_rows(cfg.data.imgsz, k)
        self.mesh = parallel.data_mesh(k)  # in effect while train() runs
        if t.batch % self.mesh.data:
            shards = "ranks" if k == 1 else f"data shards ({self.world} ranks / mesh_spatial {k})"
            raise ValueError(f"the global batch {t.batch} does not divide into {self.mesh.data} {shards}")
        if self.device.type == "cuda" and self.world > 1:
            torch.cuda.set_device(self.device)  # NCCL's object collectives use the current card
        from mga_yolo_tpu_torch.utils.files import resolve_save_dir

        # rank 0 names the run directory (a second run lands in name2) and alone creates it
        self.save_dir = parallel.broadcast_object(
            resolve_save_dir(t.project, t.name, exist_ok=t.exist_ok, resume=t.resume) if self.is_main else None)

        torch.manual_seed(t.seed)  # the weights' initialisation
        self.model, self.spec = create_model(
            t.model, scale=t.model_scale, device=self.device, training=True,
            tap_indices=tuple(t.save_layers) if t.save_fm else ())
        self.strides = self.model.det_strides

        self.train_ds = MGADataset(cfg, "train", augment=True)
        self.val_ds = MGADataset(cfg, "val", augment=False)
        shards = dict(num_shards=self.mesh.data, shard_index=self.mesh.data_rank)
        self.train_loader = DataLoader(self.train_ds, batch_size=t.batch, seed=t.seed,
                                       workers=cfg.data.workers, device=self.device, **shards)
        if t.multi_scale:  # one size a batch from a small set (the reference resizes continuously)
            s = cfg.data.imgsz
            self.train_loader.size_buckets = sorted({max(64, round(s * f / 64) * 64) for f in (0.75, 1.0, 1.25)})
        # device-side augmentation: raw canvases + matrices from the loader,
        # the per-pixel work batched on the device (data/device_augment.py)
        self._dev_augment = None
        if cfg.augment.on_device:
            ok, why = DA.supported(cfg)
            if ok:
                self.train_loader.raw_mode = True
                self._dev_augment = DA.make_augment_fn(cfg, cfg.data.max_boxes)
            else:
                print(f"[MGA] augment.on_device disabled: {why}; using host path")
        self.device_augment = self._dev_augment is not None
        vb = min(t.batch, len(self.val_ds)) or 1
        vb = max(self.mesh.data, vb - vb % self.mesh.data)  # a whole shard a data shard
        self.val_loader = DataLoader(self.val_ds, batch_size=vb, shuffle=False, workers=cfg.data.workers,
                                     drop_last=False, device=self.device, **shards)

        self.steps_per_epoch = max(len(self.train_loader), 1)
        # the reference's 'auto' rule: iterations decide SGD vs AdamW, and
        # auto sets lr0 / momentum / warmup_bias_lr
        iterations = math.ceil(len(self.train_ds) / max(t.batch, t.nbs)) * t.epochs
        self.opt = optim.resolve_optimizer(t.optimizer, self.spec.nc, iterations, t.lr0, t.momentum,
                                           t.warmup_bias_lr)
        if self.opt.auto_selected:
            print(f"[MGA] optimizer=auto -> {self.opt.name} (lr0={self.opt.lr0}, "
                  f"momentum={self.opt.momentum}) from {iterations} iterations")
        if self.is_main:
            self.save_dir.mkdir(parents=True, exist_ok=True)
            (self.save_dir / "weights").mkdir(exist_ok=True)
        # torch's Adam keeps beta1 fixed through the warmup
        warm_mom = self.opt.momentum if self.opt.name in ("adam", "adamw") else t.warmup_momentum
        self.schedule = optim.Schedule(
            lr0=self.opt.lr0, lrf=t.lrf, momentum=self.opt.momentum, warmup_epochs=t.warmup_epochs,
            warmup_momentum=warm_mom, warmup_bias_lr=self.opt.warmup_bias_lr, epochs=t.epochs,
            steps_per_epoch=self.steps_per_epoch, cos_lr=t.cos_lr)
        # the reference scales the decay by the accumulated batch: wd * batch * accumulate / nbs
        self.accumulate = max(round(t.nbs / t.batch), 1)
        self.weight_decay = t.weight_decay * t.batch * self.accumulate / t.nbs

        det_cfg, seg_cfg = det_loss_config(cfg), seg_loss_config(cfg)
        self.compute_dtype = torch.bfloat16 if (t.amp and self.device.type == "cuda") else torch.float32
        self.state = S.create_train_state(self.model, opt_name=self.opt.name)
        if self.accumulate > 1:  # allocated up front, so every checkpoint holds it
            self.state.accum_grads = {k: torch.zeros_like(p) for k, p in self.state.params().items()}
        self._train_step = S.make_train_step(
            self.model, self.strides, self.spec.nc, det_cfg, seg_cfg, weight_decay=self.weight_decay,
            ema_decay=t.ema_decay, ema_tau=t.ema_tau, accumulate=self.accumulate,
            compute_dtype=self.compute_dtype, opt_name=self.opt.name, warmup_steps=self.schedule.warmup_steps)
        self._eval_step = S.make_eval_step(
            self.model, self.strides, self.spec.nc, det_cfg, seg_cfg, compute_dtype=self.compute_dtype,
            nms_conf=0.001, nms_iou=0.7, max_det=300, nms_multi_label=self.spec.nc > 1)
        self.validator = Validator(self._eval_step, self.val_loader, cfg, iou_thres=0.7)
        self.csv = ResultsCSV(self.save_dir) if self.is_main else None
        self.callbacks = CallbackBus()
        if t.plots and self.is_main:
            TensorBoardLogger(self.save_dir / "tb").register(self.callbacks)
            if cfg.extra.get("wandb"):
                WandBLogger(t.project, t.name).register(self.callbacks)
            if cfg.extra.get("mlflow"):
                MLflowLogger(t.project, t.name).register(self.callbacks)
        self.stopper = EarlyStopping(t.patience)
        self.best_fitness = 0.0
        self.start_epoch = 0
        self.epoch_stats: list[dict] = []  # per epoch: wall times, images/s, loader wait, val speed

        if t.resume:
            self._try_resume()
        self._host_step = int(self.state.step)  # the schedule's step, counted on the host

    # ------------------------------------------------------------------ utils

    def n_params(self) -> int:
        return sum(p.numel() for p in self.state.params().values())

    def write_profiling_yaml(self) -> None:
        """profiling.yaml: parameters and GFLOPs (see :func:`count_gflops`)."""
        imgsz = self.cfg.data.imgsz
        info = {
            "parameters": self.n_params(),
            "trainable_parameters": self.n_params(),
            f"gflops_at_{imgsz}": count_gflops(self.spec, imgsz),
            "gflops_at_640": count_gflops(self.spec, 640) if imgsz != 640 else None,
            "model": str(self.cfg.train.model),
            "scale": self.cfg.train.model_scale,
        }
        yaml_lite.dump(info, self.save_dir / "profiling.yaml")

    def _ema(self, name: str) -> Optional[np.ndarray]:
        t = self.state.ema_params.get(name)
        return None if t is None else t.detach().cpu().numpy()

    def _collect_alpha_params(self) -> dict:
        """softplus(beta) of each attention layer's gate, from the EMA; the
        layers come from the graph's tap registry (``attention_taps``)."""
        out = {}
        for name, tag in self.spec.attention_taps.items():
            beta = self._ema(f"{name}.beta")
            if beta is not None:
                out[f"alpha_{tag}"] = float(np.log1p(np.exp(beta)))
        return out

    def _collect_spade_stats(self) -> dict:
        """Mean and std of each SPADE layer's gamma / beta conv weights (EMA)."""
        out = {}
        for name, tag in self.spec.attention_taps.items():
            g, b = self._ema(f"{name}.conv_gamma.weight"), self._ema(f"{name}.conv_beta.weight")
            if g is None or b is None:
                continue
            out[f"spade/{tag}/gamma_mean"] = float(g.mean())
            out[f"spade/{tag}/gamma_std"] = float(g.std())
            out[f"spade/{tag}/beta_mean"] = float(b.mean())
            out[f"spade/{tag}/beta_std"] = float(b.std())
        return out

    # ------------------------------------------------------------ checkpoints

    def save_checkpoint(self, name: str, epoch: int, fitness: float) -> float:
        """weights/{name}.pt + .meta.json (background write); returns the ms
        the run was held for the host copy."""
        model_path = Path(self.cfg.train.model)
        meta = {
            "epoch": epoch,
            "best_fitness": float(self.best_fitness),
            "fitness": float(fitness),
            # an absolute path and the YAML text, so the file rebuilds from any directory
            "model_yaml": str(model_path.resolve()),
            "model_yaml_text": model_path.read_text() if model_path.exists() else None,
            "model_scale": self.cfg.train.model_scale,
            "optimizer": self.opt.name,
            "nc": self.spec.nc,
            "imgsz": self.cfg.data.imgsz,
            "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        }
        return ckpt_util.save_checkpoint(self.save_dir / "weights" / f"{name}.pt", self.state, meta,
                                         async_save=True)

    def _try_resume(self) -> None:
        last = self.save_dir / "weights" / "last.pt"
        if parallel.broadcast_object(last.exists()):  # rank 0's answer: every rank resumes, or none
            self.state, meta = ckpt_util.load_checkpoint(last, self.state)  # every rank reads the same file
            S.broadcast_train_state(self.state)
            self.start_epoch = int(meta.get("epoch", -1)) + 1
            self.best_fitness = float(meta.get("best_fitness", 0.0))
            # drop rows of the epochs this run repeats: no duplicate epoch rows
            if self.is_main:
                self.csv.truncate_after_epoch(self.start_epoch)
            print(f"[MGA] resumed from epoch {self.start_epoch} (step {self.state.step})")

    # ------------------------------------------------------------------ train

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        return profile(activities=acts)

    def _train_epoch(self, epoch: int) -> tuple[np.ndarray, dict]:
        """One epoch of micro-steps; returns the mean loss items (read from
        the device once) and the epoch's timing."""
        profiling = bool(self.cfg.extra.get("profile")) and epoch == self.start_epoch and self.is_main
        prof = self._profiler().__enter__() if profiling else None
        items_dev = None  # a running sum on the device: no host sync per step
        n_it = n_img = 0
        wait = 0.0
        step_start = self._host_step
        aug_cm = DA.canvas_multiplier(self.cfg.augment, self.train_loader.use_mosaic)
        t0 = time.perf_counter()
        it = iter(self.train_loader)
        while True:
            tw = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            wait += time.perf_counter() - tw
            batch.pop("index", None)
            if self._dev_augment is None:
                dev = self.train_loader.to_device(spatial.keep_rows(batch))
            else:  # the whole canvases warped, then this rank's rows kept
                dev = self.train_loader.to_device(batch)
                dev = spatial.keep_rows(self._dev_augment(dev, dev["canvas"].shape[1] // aug_cm))
            n_img += dev["image"].shape[0]
            step = self._host_step
            lr, lr_bias, mom = self.schedule.at(step)
            self.state, metrics = self._train_step(self.state, dev, lr, lr_bias, mom)
            items_dev = metrics["items"] if items_dev is None else items_dev + metrics["items"]
            self._host_step = step + 1
            n_it += 1
            if prof is not None and n_it >= PROFILE_STEPS:
                prof.__exit__(None, None, None)
                self._save_trace(prof)
                prof = None
            self.callbacks.fire("on_train_batch_end", trainer=self, step=step)
        if prof is not None:
            prof.__exit__(None, None, None)
            self._save_trace(prof)
        if items_dev is not None:  # with a group: each rank's shares, summed to the global batches' items
            parallel.all_reduce_sum_([items_dev])
        tloss = (items_dev.detach().double().cpu().numpy() / max(n_it, 1) if items_dev is not None
                 else np.zeros(10, np.float64))
        secs = time.perf_counter() - t0
        return tloss, {"steps": n_it, "images": n_img, "train_s": secs, "wait_s": wait, "step_start": step_start}

    def _save_trace(self, prof) -> None:
        out = self.save_dir / "profile"
        out.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        print(f"[MGA] profile of the first {PROFILE_STEPS} micro-steps -> {out / 'trace.json'}")

    def train(self) -> ValResult:
        with parallel.using(self.mesh):
            return self._train()

    def _train(self) -> ValResult:
        t = self.cfg.train
        if self.is_main:
            self.write_profiling_yaml()
        ranks = f" (rank {self.rank} of {self.world})" if self.world > 1 else ""
        print(f"[MGA] training {t.model} scale={t.model_scale} on {len(self.train_ds)} images, "
              f"{self.steps_per_epoch} it/epoch, {self.device}{ranks}, {self.n_params() / 1e6:.2f}M params")
        last_result: Optional[ValResult] = None
        self.callbacks.fire("on_train_start", trainer=self)
        parallel.barrier("mga:pre-train")
        for epoch in range(self.start_epoch, t.epochs):
            self.callbacks.fire("on_train_epoch_start", trainer=self, epoch=epoch)
            self.train_loader.set_epoch(epoch, t.epochs)
            tloss, stats = self._train_epoch(epoch)
            # non-finite guard, once an epoch (the reference's seg loss raises
            # FloatingPointError); the loss items are read here anyway
            if not np.isfinite(tloss).all():
                raise FloatingPointError(f"non-finite training loss at epoch {epoch + 1}: {tloss}")

            row = {"epoch": float(epoch + 1)}
            row.update(loss_items_to_row("train", tloss))
            fitness = 0.0
            if t.val:
                art_dir = None
                if t.save_fm and self._is_capture_epoch(epoch) and self.is_main:
                    art_dir = self.save_dir / "feature_maps" / f"epoch_{epoch + 1}"
                tv = time.perf_counter()
                result = self.validator(self.state, save_artifacts_dir=art_dir, max_artifacts=t.save_fm_max)
                stats.update(val_s=time.perf_counter() - tv, val_speed=result.speed, map50=result.metrics.map50,
                             map=result.metrics.map)
                last_result = result
                row.update(loss_items_to_row("val", result.loss_items))
                row.update(result.results_dict())
                fitness = result.metrics.fitness

            lv = self.state.mtl_log_vars.detach().cpu().numpy()
            row["mtl/sigma2_det"] = float(np.exp(lv[0]))
            row["mtl/sigma2_seg"] = float(np.exp(lv[1]))
            row["mtl/w_det"] = float(np.exp(-lv[0]))
            row["mtl/w_seg"] = float(np.exp(-lv[1]))
            row.update(self._collect_alpha_params())
            row.update(self._collect_spade_stats())
            row["lr"] = self.schedule.at(self._host_step)[0]
            row["time"] = stats["train_s"]
            if self.is_main:
                self.csv.append(row)
            self.callbacks.fire("on_fit_epoch_end", trainer=self, epoch=epoch, row=row)

            save_ms = 0.0
            if fitness >= self.best_fitness:  # the same fitness on every rank (gathered metrics)
                self.best_fitness = fitness
                if t.save and self.is_main:
                    save_ms += self.save_checkpoint("best", epoch, fitness)
            if t.save and self.is_main:
                save_ms += self.save_checkpoint("last", epoch, fitness)
                self.callbacks.fire("on_model_save", trainer=self, epoch=epoch)
                if t.save_period > 0 and (epoch + 1) % t.save_period == 0:
                    save_ms += self.save_checkpoint(f"epoch{epoch + 1}", epoch, fitness)
            stats.update(epoch=epoch, step_end=self._host_step, save_ms=save_ms)
            self.epoch_stats.append(stats)

            print(f"[MGA] epoch {epoch + 1}/{t.epochs} det={row['train/det/total']:.3f} "
                  f"seg={row['train/seg/total']:.3f} mAP50={row.get('metrics/mAP50(B)', 0.0):.4f} "
                  f"fitness={fitness:.4f} ({stats['train_s']:.1f}s, "
                  f"{stats['images'] / max(stats['train_s'], 1e-9):.1f} img/s, "
                  f"{100 * stats['wait_s'] / max(stats['train_s'], 1e-9):.1f}% waiting on the loader)")
            if self.stopper(epoch, fitness):
                print(f"[MGA] early stopping at epoch {epoch + 1} (patience {t.patience})")
                break

        ckpt_util.wait_for_saves()
        self.callbacks.fire("on_train_end", trainer=self)

        # the final evaluation of the in-memory EMA, with the class table and the plots
        if t.val:
            last_result = self.validator(self.state, plots_dir=self.save_dir if t.plots and self.is_main else None,
                                         verbose=self.is_main)
            speed_str = ", ".join(f"{k} {v:.1f}ms" for k, v in last_result.speed.items())
            print(f"[MGA] final: mAP50={last_result.metrics.map50:.4f} "
                  f"mAP50-95={last_result.metrics.map:.4f} speed: {speed_str}")
        return last_result if last_result is not None else ValResult(
            metrics=DetMetrics(), loss_items=np.zeros(10, np.float32))

    def _is_capture_epoch(self, epoch: int) -> bool:
        """The 25 / 50 / 75 / 100% epochs (the reference validator's capture points)."""
        e = self.cfg.train.epochs
        return (epoch + 1) in sorted({max(1, round(e * f)) for f in (0.25, 0.5, 0.75, 1.0)})


def train(config, **overrides) -> ValResult:
    """Programmatic entry: ``train(cfg_yaml_or_dict_or_MGAConfig, **overrides)``."""
    from mga_yolo_tpu_torch.config import load_config

    cfg = config if isinstance(config, MGAConfig) else load_config(config, **overrides)
    return MGATrainer(cfg).train()
