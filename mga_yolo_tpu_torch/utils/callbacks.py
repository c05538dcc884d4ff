"""Callback bus and logger adapters (counterpart of
``mga_yolo_tpu/utils/callbacks.py``).

The trainer fires the reference's event names (``on_train_start``,
``on_train_epoch_start``, ``on_train_batch_end``, ``on_fit_epoch_end``,
``on_model_save``, ``on_train_end``, ...); adapters are plain callables
registered per event. A handler that raises is reported and skipped: it never
stops training. The TensorBoard, W&B and MLflow adapters need packages the
port does not depend on; without them (or when they fail to start) each
prints one line and registers nothing.
"""

from __future__ import annotations

import csv
import dataclasses
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable, Dict, List

EVENTS = (
    "on_pretrain_routine_start",
    "on_train_start",
    "on_train_epoch_start",
    "on_train_batch_end",
    "on_train_epoch_end",
    "on_fit_epoch_end",
    "on_model_save",
    "on_train_end",
    "on_val_start",
    "on_val_end",
)


class CallbackBus:
    def __init__(self):
        self._hooks: Dict[str, List[Callable]] = defaultdict(list)

    def add(self, event: str, fn: Callable) -> None:
        if event not in EVENTS:
            raise ValueError(f"unknown event {event!r}; valid: {EVENTS}")
        self._hooks[event].append(fn)

    def fire(self, event: str, **kwargs: Any) -> None:
        for fn in self._hooks.get(event, ()):
            try:
                fn(**kwargs)
            except Exception as e:  # callbacks must never kill training
                print(f"[callbacks] {event} handler {fn} failed: {e}")


def _disabled(what: str, err: Exception) -> None:
    print(f"[callbacks] {what} logging off: {type(err).__name__}: {err}")


def _scalars(row: dict) -> dict:
    return {k: v for k, v in row.items() if isinstance(v, (int, float)) and k != "epoch"}


class TensorBoardLogger:
    """Per-epoch scalars through ``torch.utils.tensorboard`` (needs the
    ``tensorboard`` package)."""

    def __init__(self, log_dir: str | Path):
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer = SummaryWriter(str(log_dir))
        except Exception as e:
            _disabled("TensorBoard", e)
            self.writer = None

    def register(self, bus: CallbackBus) -> None:
        if self.writer is None:
            return
        bus.add("on_fit_epoch_end", self._on_epoch_end)
        bus.add("on_train_end", self._on_train_end)

    def _on_epoch_end(self, epoch: int = 0, row: dict | None = None, **_):
        for k, v in _scalars(row or {}).items():
            self.writer.add_scalar(k, v, epoch)
        self.writer.flush()

    def _on_train_end(self, **_):
        self.writer.close()


class CSVLoggerCallback:
    """Mirrors each epoch's row into another CSV (e.g. metrics_mirror.csv)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)

    def register(self, bus: CallbackBus) -> None:
        bus.add("on_fit_epoch_end", self._on_epoch_end)

    def _on_epoch_end(self, row: dict | None = None, **_):
        if not row:
            return
        exists = self.path.exists()
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=sorted(row.keys()))
            if not exists:
                w.writeheader()
            w.writerow(row)


class WandBLogger:
    """Weights & Biases adapter (the reference's ``utils/callbacks/wb.py``)."""

    def __init__(self, project: str, name: str, config: dict | None = None):
        try:
            import wandb

            self.run = wandb.init(project=project, name=name, config=config or {}, reinit=True)
        except Exception as e:
            _disabled("W&B", e)
            self.run = None

    def register(self, bus: CallbackBus) -> None:
        if self.run is None:
            return
        bus.add("on_fit_epoch_end", self._on_epoch_end)
        bus.add("on_train_end", self._on_train_end)

    def _on_epoch_end(self, epoch: int = 0, row: dict | None = None, **_):
        if row:
            self.run.log(_scalars(row), step=epoch)

    def _on_train_end(self, **_):
        self.run.finish()


class MLflowLogger:
    """MLflow adapter (the reference's ``utils/callbacks/mlflow.py``): the
    train config as parameters at the start, each epoch's row as metrics,
    with the characters MLflow rejects in keys replaced."""

    def __init__(self, experiment: str, run_name: str, tracking_uri: str | None = None):
        try:
            import mlflow

            if tracking_uri:
                mlflow.set_tracking_uri(tracking_uri)
            mlflow.set_experiment(experiment)
            self.run = mlflow.start_run(run_name=run_name)
            self._mlflow = mlflow
        except Exception as e:
            _disabled("MLflow", e)
            self.run = None

    @staticmethod
    def _clean(k: str) -> str:
        return "".join(c if (c.isalnum() or c in "_-./ ") else "_" for c in k)

    def register(self, bus: CallbackBus) -> None:
        if self.run is None:
            return
        bus.add("on_train_start", self._on_train_start)
        bus.add("on_fit_epoch_end", self._on_epoch_end)
        bus.add("on_train_end", self._on_train_end)

    def _on_train_start(self, trainer=None, **_):
        if trainer is not None:
            params = dataclasses.asdict(trainer.cfg.train)
            self._mlflow.log_params({self._clean(k): str(v) for k, v in params.items()})

    def _on_epoch_end(self, epoch: int = 0, row: dict | None = None, **_):
        if row:
            self._mlflow.log_metrics({self._clean(k): float(v) for k, v in _scalars(row).items()}, step=epoch)

    def _on_train_end(self, **_):
        self._mlflow.end_run()
