"""Validation: inference and NMS on the card, then mAP on the host
(counterpart of ``mga_yolo_tpu/train/validator.py``).

The eval step (``train.state.make_eval_step``: the forward on the EMA and
the device NMS, which launch the CAM-gate and NMS kernels on the card)
gives each batch's detections; the host matches them to the ground truth in
numpy (``utils.metrics``), fills the confusion matrix, and optionally writes
COCO JSON and artifacts: the detections drawn on the images and the mask
probabilities as PNGs, the raw mask logits and tapped features as ``.npy``.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from mga_yolo_tpu_torch.data import image_io
from mga_yolo_tpu_torch.data.loader import DataLoader
from mga_yolo_tpu_torch.ops.nms import nms_numpy
from mga_yolo_tpu_torch.utils.coco import CocoWriter
from mga_yolo_tpu_torch.utils.metrics import ConfusionMatrix, DetMetrics, MetricAccumulator

PLOTS_WAIT = ("[val] confusion-matrix and curve PNGs need matplotlib (ROADMAP.md section 1, item 11); "
              "saved their arrays as confusion_matrix.npy and curves.npz")


@dataclasses.dataclass
class ValResult:
    metrics: DetMetrics
    loss_items: np.ndarray  # (10,) mean val loss items
    n_images: int = 0
    # ms per image per phase (the reference validator's speed dict)
    speed: dict = dataclasses.field(default_factory=dict)
    confusion: Optional[ConfusionMatrix] = None
    names: dict = dataclasses.field(default_factory=dict)

    def results_dict(self):
        return self.metrics.results_dict()

    def class_table(self) -> str:
        """Per-class results (the reference's ``print_results``): Class /
        Instances / P / R / mAP50 / mAP50-95."""
        m = self.metrics
        rows = [f"{'Class':<20}{'Instances':>10}{'P':>10}{'R':>10}{'mAP50':>10}{'mAP50-95':>10}"]
        rows.append(
            f"{'all':<20}{int(m.nt_per_class.sum()):>10}{m.precision:>10.3f}"
            f"{m.recall:>10.3f}{m.map50:>10.3f}{m.map:>10.3f}"
        )
        if len(m.ap_class) > 1:
            for i, c in enumerate(m.ap_class):
                name = str(self.names.get(int(c), int(c)))
                rows.append(
                    f"{name:<20}{int(m.nt_per_class[i]):>10}{m.p_per_class[i]:>10.3f}"
                    f"{m.r_per_class[i]:>10.3f}{m.ap50_per_class[i]:>10.3f}{m.ap_per_class_[i]:>10.3f}"
                )
        return "\n".join(rows)


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _nhwc(x) -> np.ndarray:
    """A port (B, C, H, W) map as the JAX package's (B, H, W, C) array."""
    return np.transpose(_host(x), (0, 2, 3, 1))


def draw_boxes(img: np.ndarray, dets: np.ndarray) -> np.ndarray:
    """``img`` (H, W, 3) uint8 BGR with each detection's box outline drawn
    in green, 1 px wide (cv2.rectangle's integer corners, clipped to the
    image)."""
    color = (0, 255, 0)
    im = np.ascontiguousarray(img).copy()
    h, w = im.shape[:2]
    for x1, y1, x2, y2 in dets[:, :4].astype(int):
        x1, x2 = sorted((int(np.clip(x1, 0, w - 1)), int(np.clip(x2, 0, w - 1))))
        y1, y2 = sorted((int(np.clip(y1, 0, h - 1)), int(np.clip(y2, 0, h - 1))))
        im[y1, x1:x2 + 1] = im[y2, x1:x2 + 1] = color
        im[y1:y2 + 1, x1] = im[y1:y2 + 1, x2] = color
    return im


class Validator:
    """Runs an eval step over a loader and computes the detection metrics.

    ``eval_fn(state, batch)`` returns ``dets`` (B, max_det, 6) from the
    device NMS, ``items`` (10,) and, for the artifacts, ``decoded``
    (B, A, 4+nc), ``seg`` and ``taps``. An eval step of ``make_eval_step``
    loads the EMA once per pass (its ``load``).
    Batches go to the loader's device through its ``to_device``; rows whose
    ``index`` was already seen (a padded tail) are skipped.
    """

    def __init__(self, eval_fn: Callable, loader: DataLoader, cfg, iou_thres: float = 0.7):
        self.eval_fn = eval_fn
        self.loader = loader
        self.cfg = cfg
        self.iou_thres = iou_thres  # the artifacts' host NMS; the scored dets come from eval_fn
        self.names = dict(loader.dataset.names or {})
        self.nc = max(len(self.names), 1)

    def __call__(self, state, save_artifacts_dir: Optional[Path] = None, max_artifacts: int = 4,
                 plots_dir: Optional[Path] = None, save_json: Optional[Path] = None,
                 verbose: bool = False) -> ValResult:
        acc = MetricAccumulator()
        seen: set[int] = set()
        confusion = ConfusionMatrix(self.nc, conf=0.25, iou_thres=0.45)
        coco = CocoWriter(save_json) if save_json is not None else None
        ds = self.loader.dataset
        run = self.eval_fn
        if hasattr(self.eval_fn, "load"):
            self.eval_fn.load(state)
            run = self.eval_fn.run

        items_sum = np.zeros(10, np.float64)
        n_batches = n_images = saved = 0
        t_pre = t_inf = t_post = 0.0
        it = iter(self.loader)
        while True:
            # preprocess = the host's batch assembly (letterbox, mask pyramid)
            t0 = time.perf_counter()
            try:
                batch = dict(next(it))
            except StopIteration:
                break
            index = batch.pop("index", None)
            t_pre += time.perf_counter() - t0

            # inference = the copy to the card, the forward and the NMS; it
            # ends at the host copy of the detections, which waits for the card
            t0 = time.perf_counter()
            out = run(state, self.loader.to_device(batch))
            device_dets = _host(out["dets"])
            items = _host(out["items"]).astype(np.float64)
            t_inf += time.perf_counter() - t0

            t0 = time.perf_counter()
            items_sum += items
            n_batches += 1
            gt_boxes, gt_labels, mask_gt = (np.asarray(batch[k]) for k in ("gt_boxes", "gt_labels", "mask_gt"))
            for i in range(gt_boxes.shape[0]):
                if index is not None:
                    di = int(index[i])
                    if di in seen:
                        continue  # a padded row repeats an image already scored
                    seen.add(di)
                d = device_dets[i]
                dets = d[d[:, 4] > 0]  # trim the zero-score padding
                n = int(mask_gt[i].sum())
                gtb = gt_boxes[i, :n]
                gtc = gt_labels[i, :n].astype(np.float32)
                acc.update(dets[:, :4], dets[:, 4], dets[:, 5], gtb, gtc)
                confusion.process_batch(dets[:, :4], dets[:, 4], dets[:, 5], gtb, gtc)
                if coco is not None:
                    img_id = n_images
                    if index is not None:
                        stem = Path(ds.img_files[int(index[i])]).stem
                        img_id = int(stem) if stem.isnumeric() else stem  # COCO: numeric stem -> int id
                    coco.add(dets, img_id)
                n_images += 1
            t_post += time.perf_counter() - t0
            if save_artifacts_dir is not None and saved < max_artifacts:
                self._save_batch_artifacts(batch, out, Path(save_artifacts_dir), saved)
                saved += 1

        n = max(n_images, 1)
        speed = {
            "preprocess": 1000.0 * t_pre / n,
            "inference": 1000.0 * t_inf / n,
            "loss": 0.0,  # the val loss runs inside the eval step: no phase of its own
            "postprocess": 1000.0 * t_post / n,
        }
        if coco is not None:
            coco.save()
        acc.gather_across_hosts()  # a distributed validation's ranks; no-op on one process
        result = ValResult(metrics=acc.compute(), loss_items=(items_sum / max(n_batches, 1)).astype(np.float32),
                           n_images=n_images, speed=speed, confusion=confusion, names=self.names)
        if plots_dir is not None:
            self._save_plot_arrays(result, Path(plots_dir))
        if verbose:
            print(result.class_table())
        return result

    def _save_plot_arrays(self, result: ValResult, out_dir: Path) -> None:
        """The arrays the JAX package draws as confusion_matrix(_normalized).png
        and the PR / F1 / P / R curve PNGs."""
        out_dir.mkdir(parents=True, exist_ok=True)
        np.save(out_dir / "confusion_matrix.npy", result.confusion.matrix)
        c = result.metrics.curves
        if c:
            np.savez(out_dir / "curves.npz", ap50_per_class=result.metrics.ap50_per_class, **c)
        print(PLOTS_WAIT)

    def _save_batch_artifacts(self, batch, out, root: Path, batch_idx: int) -> None:
        """Detections drawn on the first images (PNG), the mask probabilities
        (PNG) and logits (.npy, NHWC), and the tapped features (.npy, NHWC)."""
        (root / "preds").mkdir(parents=True, exist_ok=True)
        decoded = _host(out["decoded"])
        images = np.asarray(batch["image"])
        for i in range(min(images.shape[0], 4)):
            dets = nms_numpy(decoded[i], conf_thres=0.25, iou_thres=self.iou_thres, max_det=50)
            image_io.imwrite(root / "preds" / f"batch{batch_idx}_img{i}_dets.png", draw_boxes(images[i], dets))
        for sk, logits in out["seg"].items():
            arr = _nhwc(logits)
            np.save(root / "preds" / f"batch{batch_idx}_{sk}.npy", arr)
            prob = 1.0 / (1.0 + np.exp(-arr))
            for i in range(min(arr.shape[0], 4)):
                image_io.imwrite(root / "preds" / f"batch{batch_idx}_img{i}_{sk}.png",
                                 (prob[i, ..., 0] * 255).astype(np.uint8))
        if "taps" in out:
            (root / "fm").mkdir(parents=True, exist_ok=True)
            for idx, feat in out["taps"].items():
                np.save(root / "fm" / f"batch{batch_idx}_layer{idx}.npy", _nhwc(feat))
            if batch_idx == 0:
                print("[val] feature-map PNGs (feature_visualization) need matplotlib "
                      "(ROADMAP.md section 1, item 11); saved the maps as .npy")
