"""User-facing facade, the reference's ``YOLO(model, task="mga")`` surface
(counterpart of ``mga_yolo_tpu/api.py``).

``MGA(model_yaml_or_checkpoint)``: ``train`` runs :class:`MGATrainer`,
``val`` the val CLI and ``predict`` the predictor on the trained (or given)
checkpoint, ``info`` the model summary. The task is "mga" when the graph
has mask heads, else "detect".
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from mga_yolo_tpu_torch.config import load_config
from mga_yolo_tpu_torch.graph import parse_graph


class MGA:
    """Facade: a model YAML or a checkpoint in; train / val / predict / info out.

    >>> m = MGA("configs/models/yolov8_cbam.yaml", scale="n")
    >>> m.train(data="data.yaml", epochs=100, imgsz=512)      # on CUDA; device="cpu" for the CPU
    >>> m.val("data.yaml")                                     # weights/best.pt
    >>> results = m.predict(["img.png"])                       # [Results], boxes + mga_masks
    """

    def __init__(self, model: str | Path, scale: str = "n", task: Optional[str] = None):
        self.model_path = str(model)
        self.scale = scale
        self._ckpt: Optional[Path] = None
        if str(model).endswith((".yaml", ".yml")):
            self.spec = parse_graph(model, scale=scale)
        else:  # a checkpoint file
            from mga_yolo_tpu_torch.utils.checkpoint import checkpoint_meta, model_config

            self._ckpt = Path(model)
            ckpt = torch.load(str(self._ckpt), map_location="cpu", weights_only=True)
            meta = checkpoint_meta(ckpt, self._ckpt)
            train_args = ckpt.get("train_args") or {}
            self.model_path = meta.get("model_yaml") or train_args.get("model") or self.model_path
            self.scale = train_args.get("model_scale") or train_args.get("scale") or meta.get("model_scale", scale)
            self.spec = parse_graph(model_config(meta, train_args), scale=self.scale,
                                    nc=int(train_args.get("nc", meta.get("nc", 1))))
        self.task = task or ("mga" if self.spec.mask_head_indices else "detect")

    def train(self, cfg: str | dict | None = None, **overrides):
        """Train with :class:`MGATrainer`: on the ranks of the process group
        the caller initialised (``torch.distributed.init_process_group``),
        if any, as one global batch of ``batch``; else on one device."""
        from mga_yolo_tpu_torch.train.trainer import MGATrainer

        overrides.setdefault("model", self.model_path)
        overrides.setdefault("model_scale", self.scale)
        overrides.setdefault("task", self.task)
        if self.task != "mga":
            overrides.setdefault("enabled", False)
        trainer = MGATrainer(load_config(cfg, **overrides))
        result = trainer.train()
        self._ckpt = trainer.save_dir / "weights" / "best.pt"
        self._trainer = trainer
        return result

    def val(self, data: str, **kw):
        from mga_yolo_tpu_torch.cli.val import main as val_main

        if self._ckpt is None:
            raise RuntimeError("no weights: train first or construct from a checkpoint")
        args = ["--weights", str(self._ckpt), "--data", data]
        for k, v in kw.items():
            flag = f"--{k.replace('_', '-')}"
            if v is True:  # a switch (--rect, --plots, --save-json)
                args.append(flag)
            elif v is not False:
                args += [flag, str(v)]
        return val_main(args)

    def predict(self, sources, **kw):
        """Results of ``sources`` (image paths or BGR arrays) from the
        weights; ``kw`` goes to ``train.predictor.load_predictor`` (imgsz,
        conf, iou, max_det, fuse, device)."""
        from mga_yolo_tpu_torch.train.predictor import load_predictor

        if self._ckpt is None:
            raise RuntimeError("no weights: train first or construct from a checkpoint")
        return load_predictor(self._ckpt, **kw)(sources)

    def info(self) -> dict:
        """The model summary (parameters counted on a model without storage)."""
        from mga_yolo_tpu_torch.models.yolo import MGAModel
        from mga_yolo_tpu_torch.utils.model_utils import model_info

        with torch.device("meta"):
            return model_info(MGAModel(self.spec))
