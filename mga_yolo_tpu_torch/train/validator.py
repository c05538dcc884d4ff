"""Validation: inference and NMS on the card, then mAP on the host
(counterpart of ``mga_yolo_tpu/train/validator.py``).

The eval step (``train.state.make_eval_step``: the forward on the EMA and
the device NMS, which launch the CAM-gate and NMS kernels on the card)
gives each batch's detections; the host matches them to the ground truth in
numpy (``utils.metrics``), fills the confusion matrix, and optionally writes
COCO JSON and artifacts: the detections drawn on the images and the mask
probabilities as PNGs, the raw mask logits and tapped features as ``.npy``.
Where matplotlib imports it draws the JAX package's plots (the confusion
matrices, the PR / F1 / P / R curves and each tapped map's channel grid);
on a host without it (the card's) it saves their arrays instead.

With a process group of two or more, each rank validates its shard of every
global batch (the loader pads the last one, and a row whose image came
earlier in the epoch's global order, on whichever rank, is skipped: the
loader's ``first``); the matching statistics are gathered, and the confusion
matrix, the images scored and the loss items of the global batches summed
over the ranks, once at the end of a pass, so every rank computes the
metrics, confusion matrix and val loss of one process (the JAX package
skips a repeat only on the rank that saw it first, ``ROADMAP.md`` section
3). Under a mesh that splits rows each space rank runs its band, and only
space rank 0 of each data shard adds to the statistics and sums.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from mga_yolo_tpu_torch import parallel
from mga_yolo_tpu_torch.data import image_io
from mga_yolo_tpu_torch.data.loader import DataLoader
from mga_yolo_tpu_torch.ops.nms import nms_numpy
from mga_yolo_tpu_torch.parallel import spatial
from mga_yolo_tpu_torch.utils.coco import CocoWriter
from mga_yolo_tpu_torch.utils import plotting
from mga_yolo_tpu_torch.utils.metrics import ConfusionMatrix, DetMetrics, MetricAccumulator

PLOTS_WAIT = ("[val] matplotlib is not installed: saved the confusion matrix and the curves as "
              "confusion_matrix.npy and curves.npz instead of their PNGs")
FM_WAIT = "[val] matplotlib is not installed: saved the feature maps as .npy without their PNGs"


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
    in green, 1 px wide, as ``cv2.rectangle(..., 1)`` draws it: integer
    corners (truncated), each side's pixels that fall inside the image."""
    color = (0, 255, 0)
    im = np.ascontiguousarray(img).copy()
    h, w = im.shape[:2]
    for x1, y1, x2, y2 in dets[:, :4].astype(int):
        (x1, x2), (y1, y2) = sorted((int(x1), int(x2))), sorted((int(y1), int(y2)))
        xa, xb, ya, yb = max(x1, 0), min(x2, w - 1), max(y1, 0), min(y2, h - 1)
        for y in (y1, y2):
            if 0 <= y < h and xa <= xb:
                im[y, xa:xb + 1] = color
        for x in (x1, x2):
            if 0 <= x < w and ya <= yb:
                im[ya:yb + 1, x] = color
    return im


def global_item_parts(items: torch.Tensor, det_norm: torch.Tensor, world: int) -> torch.Tensor:
    """(11,) float64: what a rank's shard adds to its global batch's loss
    items. The detection items' numerators (the shard's items times its
    clamped target-score sum), the segmentation items (means over an even
    shard) divided by ``world``, and the shard's target-score sum."""
    items, norm = items.double(), det_norm.double().reshape(1)
    return torch.cat([items[:3] * norm.clamp_min(1.0), items[3:] / world, norm])


def global_items(parts: torch.Tensor) -> torch.Tensor:
    """The loss items (n_batches, 10) of the global batches, from the sum
    over the ranks of their :func:`global_item_parts` (n_batches, 11)."""
    return torch.cat([parts[:, :3] / parts[:, 10:].clamp_min(1.0), parts[:, 3:10]], 1)


class Validator:
    """Runs an eval step over a loader and computes the detection metrics.

    ``eval_fn(state, batch)`` returns ``dets`` (B, max_det, 6) from the
    device NMS, ``items`` (10,) and, for the artifacts, ``decoded``
    (B, A, 4+nc), ``seg`` and ``taps``. An eval step of ``make_eval_step``
    loads the EMA once per pass (its ``load``).
    Batches go to the loader's device through its ``to_device``; rows that
    are not their image's ``first`` (a padded tail) are skipped.
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
        mesh = parallel.mesh()
        scores = mesh is None or mesh.space_rank == 0  # one space rank of a data shard counts its images
        confusion = ConfusionMatrix(self.nc, conf=0.25, iou_thres=0.45)
        coco = CocoWriter(save_json) if save_json is not None else None
        ds = self.loader.dataset
        run = self.eval_fn
        if hasattr(self.eval_fn, "load"):
            self.eval_fn.load(state)
            run = self.eval_fn.run

        items_sum = np.zeros(10, np.float64)
        shards: list = []  # with a group: per batch, the shard's parts of the global batch's items
        n_batches = n_images = n_rows = saved = 0
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
            first = batch.pop("first", None)
            t_pre += time.perf_counter() - t0

            # inference = the copy to the card, the forward and the NMS; it
            # ends at the host copy of the detections, which waits for the card
            t0 = time.perf_counter()
            out = run(state, self.loader.to_device(spatial.keep_rows(batch, masks=False)))
            device_dets = _host(out["dets"])
            items = _host(out["items"]).astype(np.float64)
            t_inf += time.perf_counter() - t0

            t0 = time.perf_counter()
            if parallel.active():
                part = global_item_parts(out["items"], out["det_norm"], parallel.data_world())
                shards.append(part if scores else torch.zeros_like(part))
            items_sum += items
            n_batches += 1
            gt_boxes, gt_labels, mask_gt = (np.asarray(batch[k]) for k in ("gt_boxes", "gt_labels", "mask_gt"))
            n_rows += gt_boxes.shape[0]
            for i in range(gt_boxes.shape[0] if scores else 0):
                if first is not None and not first[i]:
                    continue  # a padded row repeats an image scored before, here or on another rank
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

        n = max(n_images if scores else n_rows, 1)  # a space rank that scores nothing: per row it ran
        speed = {
            "preprocess": 1000.0 * t_pre / n,
            "inference": 1000.0 * t_inf / n,
            "loss": 0.0,  # the val loss runs inside the eval step: no phase of its own
            "postprocess": 1000.0 * t_post / n,
        }
        if coco is not None:
            coco.save()
        acc.gather_across_hosts()  # a distributed validation's ranks; no-op on one process
        if parallel.active():  # the global batches' loss items, the confusion matrix, the images: one collective
            parts = torch.stack(shards)
            counts = torch.as_tensor(np.append(confusion.matrix.ravel(), n_images), dtype=torch.float64,
                                     device=parts.device)
            parallel.all_reduce_sum_([parts, counts])
            items_sum = global_items(parts).sum(0).cpu().numpy()
            counts = np.rint(counts.cpu().numpy())
            confusion.matrix = counts[:-1].reshape(confusion.matrix.shape).astype(confusion.matrix.dtype)
            n_images = int(counts[-1])
        result = ValResult(metrics=acc.compute(), loss_items=(items_sum / max(n_batches, 1)).astype(np.float32),
                           n_images=n_images, speed=speed, confusion=confusion, names=self.names)
        if plots_dir is not None:
            self._save_plots(result, Path(plots_dir))
        if verbose:
            print(result.class_table())
        return result

    def _save_plots(self, result: ValResult, out_dir: Path) -> None:
        """confusion_matrix(_normalized).png and the PR / F1 / P / R curve
        PNGs, as the JAX validator draws them; without matplotlib, their
        arrays (confusion_matrix.npy, curves.npz)."""
        out_dir.mkdir(parents=True, exist_ok=True)
        c = result.metrics.curves
        if not plotting.available():
            np.save(out_dir / "confusion_matrix.npy", result.confusion.matrix)
            if c:
                np.savez(out_dir / "curves.npz", ap50_per_class=result.metrics.ap50_per_class, **c)
            print(PLOTS_WAIT)
            return
        names = {i: self.names.get(i, str(i)) for i in range(self.nc)}
        for normalize, fname in ((False, "confusion_matrix.png"), (True, "confusion_matrix_normalized.png")):
            plotting.plot_confusion_matrix(result.confusion.matrix, names, out_dir / fname, normalize=normalize)
        if c:
            plotting.plot_pr_curve(c["px101"], c["py"], result.metrics.ap50_per_class, names, out_dir / "PR_curve.png")
            for key, ylabel, fname in (("f1", "F1", "F1_curve.png"), ("p", "Precision", "P_curve.png"),
                                       ("r", "Recall", "R_curve.png")):
                plotting.plot_mc_curve(c["px"], c[key], names, out_dir / fname, ylabel=ylabel)

    def _save_batch_artifacts(self, batch, out, root: Path, batch_idx: int) -> None:
        """Detections drawn on the first images (JPEG), the mask probabilities
        (PNG) and logits (.npy, NHWC), and the tapped features (.npy, NHWC,
        and the first image's channel grid as PNG where matplotlib imports)."""
        (root / "preds").mkdir(parents=True, exist_ok=True)
        decoded = _host(out["decoded"])
        images = np.asarray(batch["image"])
        for i in range(min(images.shape[0], 4)):
            dets = nms_numpy(decoded[i], conf_thres=0.25, iou_thres=self.iou_thres, max_det=50)
            image_io.imwrite(root / "preds" / f"batch{batch_idx}_img{i}_dets.jpg", draw_boxes(images[i], dets))
        for sk, logits in out["seg"].items():
            arr = _nhwc(logits)
            np.save(root / "preds" / f"batch{batch_idx}_{sk}.npy", arr)
            prob = 1.0 / (1.0 + np.exp(-arr))
            for i in range(min(arr.shape[0], 4)):
                image_io.imwrite(root / "preds" / f"batch{batch_idx}_img{i}_{sk}.png",
                                 (prob[i, ..., 0] * 255).astype(np.uint8))
        if "taps" in out:
            (root / "fm").mkdir(parents=True, exist_ok=True)
            draw = plotting.available()
            for idx, feat in out["taps"].items():
                arr = _nhwc(feat)
                np.save(root / "fm" / f"batch{batch_idx}_layer{idx}.npy", arr)
                if draw:
                    plotting.feature_visualization(arr[0], root / "fm" / f"batch{batch_idx}_layer{idx}.png")
            if batch_idx == 0 and not draw:
                print(FM_WAIT)
