"""Detection metrics: mAP50 / mAP50-95 / P / R, on the host in numpy.

Counterpart of ``mga_yolo_tpu/utils/metrics.py``, the reference's evaluation
protocol: ``compute_ap`` with 101-point COCO interpolation, ``ap_per_class``,
``match_predictions`` (greedy IoU matching at the 10 thresholds 0.5:0.95),
the ``DetMetrics`` summary with fitness = 0.9 * mAP50-95 + 0.1 * mAP50, the
confusion matrix and the per-image accumulator. It stays numpy after the
card's inference, as in the JAX package, so the mAP equals the reference's
to the last bit; a distributed validation merges its ranks' statistics over
``torch.distributed``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

IOUV = np.linspace(0.5, 0.95, 10)


def box_iou(a: np.ndarray, b: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area_a = (a[:, 2:] - a[:, :2]).prod(-1)
    area_b = (b[:, 2:] - b[:, :2]).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + eps)


def match_predictions(
    pred_cls: np.ndarray, true_cls: np.ndarray, iou: np.ndarray, iouv: np.ndarray = IOUV
) -> np.ndarray:
    """Greedy one-to-one matching -> bool TP matrix (N_pred, len(iouv)).

    iou is (n_true, n_pred). Matches are sorted by IoU desc and deduplicated
    per-detection then per-label, exactly like the reference.
    """
    correct = np.zeros((pred_cls.shape[0], len(iouv)), bool)
    if len(true_cls) == 0 or len(pred_cls) == 0:
        return correct
    iou = iou * (true_cls[:, None] == pred_cls[None, :])
    for i, thr in enumerate(iouv):
        matches = np.array(np.nonzero(iou >= thr)).T  # (K, 2) [label, det]
        if matches.shape[0]:
            if matches.shape[0] > 1:
                matches = matches[iou[matches[:, 0], matches[:, 1]].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


def compute_ap(recall: np.ndarray, precision: np.ndarray, return_curve: bool = False):
    """COCO 101-point interpolated AP (reference metrics.py:727-757)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    trapz = np.trapezoid if hasattr(np, "trapezoid") else np.trapz
    ap = float(trapz(np.interp(x, mrec, mpre), x))
    if return_curve:
        return ap, mpre, mrec
    return ap


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing used for the max-F1 threshold pick."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]))
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


@dataclasses.dataclass
class DetMetrics:
    """Aggregated detection metrics over an eval epoch."""

    precision: float = 0.0
    recall: float = 0.0
    map50: float = 0.0
    map: float = 0.0
    ap_class: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0,)))
    ap50_per_class: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0,)))
    ap_per_class_: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0,)))
    # per-class P/R at the max-F1 threshold (reference class_result)
    p_per_class: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0,)))
    r_per_class: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0,)))
    # per-class GT counts + seen-image/pred stats for the results table
    nt_per_class: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0,), int))
    # confidence-axis curves for PR/F1/P/R plots (reference plot_pr_curve /
    # plot_mc_curve inputs): px (1000,), py (nc, 101) precision-over-recall
    # at IoU 0.5, and p/r/f1 (nc, 1000) over confidence
    curves: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def fitness(self) -> float:
        return 0.1 * self.map50 + 0.9 * self.map

    def results_dict(self) -> Dict[str, float]:
        return {
            "metrics/precision(B)": self.precision,
            "metrics/recall(B)": self.recall,
            "metrics/mAP50(B)": self.map50,
            "metrics/mAP50-95(B)": self.map,
            "fitness": self.fitness,
        }


def ap_per_class(
    tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray, target_cls: np.ndarray, eps: float = 1e-16
) -> DetMetrics:
    """Per-class AP + max-F1 P/R (reference metrics.py:760-855, no plotting)."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]
    if nc == 0 or len(conf) == 0:
        return DetMetrics()

    x = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    px101 = np.linspace(0, 1, 101)
    py = np.zeros((nc, 101))  # precision over recall axis at IoU 0.5
    for ci, c in enumerate(unique_classes):
        sel = pred_cls == c
        n_l, n_p = nt[ci], int(sel.sum())
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_l + eps)
        precision = tpc / (tpc + fpc)
        r_curve[ci] = np.interp(-x, -conf[sel], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-x, -conf[sel], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            if j == 0:
                ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j], return_curve=True)
                py[ci] = np.interp(px101, mrec, mpre)
            else:
                ap[ci, j] = compute_ap(recall[:, j], precision[:, j])

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = smooth(f1_curve.mean(0), 0.1).argmax()
    p, r = p_curve[:, i], r_curve[:, i]
    return DetMetrics(
        precision=float(p.mean()),
        recall=float(r.mean()),
        map50=float(ap[:, 0].mean()),
        map=float(ap.mean()),
        ap_class=unique_classes.astype(int),
        ap50_per_class=ap[:, 0],
        ap_per_class_=ap.mean(1),
        p_per_class=p,
        r_per_class=r,
        nt_per_class=nt.astype(int),
        curves={"px": x, "py": py, "px101": px101,
                "p": p_curve, "r": r_curve, "f1": f1_curve},
    )


class ConfusionMatrix:
    """Detection confusion matrix (reference metrics.py:313).

    (nc+1) x (nc+1): rows = predicted class (last = background/FN column
    source), cols = true class (last = background -> FP).
    """

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1), np.int64)

    def process_batch(
        self,
        pred_boxes: np.ndarray,   # (N,4) xyxy
        pred_conf: np.ndarray,
        pred_cls: np.ndarray,
        true_boxes: np.ndarray,   # (M,4)
        true_cls: np.ndarray,
    ) -> None:
        keep = pred_conf > self.conf
        pred_boxes, pred_cls = pred_boxes[keep], pred_cls[keep].astype(int)
        true_cls = true_cls.astype(int)
        if len(true_cls) == 0:
            for pc in pred_cls:
                self.matrix[pc, self.nc] += 1  # FP
            return
        if len(pred_cls) == 0:
            for tc in true_cls:
                self.matrix[self.nc, tc] += 1  # FN
            return
        iou = box_iou(true_boxes, pred_boxes)
        matches = np.array(np.nonzero(iou >= self.iou_thres)).T
        if matches.shape[0] > 1:
            matches = matches[iou[matches[:, 0], matches[:, 1]].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        matched_t = set()
        matched_p = set()
        for ti, pi in matches:
            self.matrix[pred_cls[pi], true_cls[ti]] += 1
            matched_t.add(int(ti))
            matched_p.add(int(pi))
        for ti, tc in enumerate(true_cls):
            if ti not in matched_t:
                self.matrix[self.nc, tc] += 1  # FN
        for pi, pc in enumerate(pred_cls):
            if pi not in matched_p:
                self.matrix[pc, self.nc] += 1  # FP


class MetricAccumulator:
    """Collects per-image stats during validation, then computes DetMetrics."""

    def __init__(self):
        self.tp: List[np.ndarray] = []
        self.conf: List[np.ndarray] = []
        self.pred_cls: List[np.ndarray] = []
        self.target_cls: List[np.ndarray] = []

    def update(
        self,
        pred_boxes: np.ndarray,   # (N,4) xyxy
        pred_conf: np.ndarray,    # (N,)
        pred_cls: np.ndarray,     # (N,)
        true_boxes: np.ndarray,   # (M,4) xyxy
        true_cls: np.ndarray,     # (M,)
    ) -> None:
        iou = box_iou(true_boxes, pred_boxes)
        self.tp.append(match_predictions(pred_cls, true_cls, iou))
        self.conf.append(pred_conf)
        self.pred_cls.append(pred_cls)
        self.target_cls.append(true_cls)

    def gather_across_hosts(self) -> None:
        """Merge the per-rank statistics of a distributed validation (each
        rank validates its shard of the val set) so every rank computes the
        same global metrics: ``torch.distributed.all_gather_object`` of the
        raw arrays, concatenated in rank order. A no-op unless a process
        group is initialised with a world size above 1."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return
        local = (self.tp, self.conf, self.pred_cls, self.target_cls)
        gathered: list = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, local)
        self.tp, self.conf, self.pred_cls, self.target_cls = (
            [a for rank in gathered for a in rank[i]] for i in range(4))

    def compute(self) -> DetMetrics:
        if not self.tp:
            return DetMetrics()
        return ap_per_class(
            np.concatenate(self.tp),
            np.concatenate(self.conf),
            np.concatenate(self.pred_cls),
            np.concatenate(self.target_cls),
        )
