"""Fixed-shape batched NMS with the greedy suppression as a CUDA kernel.

Counterpart of ``mga_yolo_tpu/ops/nms.py`` ``nms_jax`` and of its drop-in
``mga_yolo_tpu/ops/pallas/nms.py`` ``nms_jax_pallas``: confidence filter,
best class (or every (anchor, class) pair with ``multi_label``), pre-cut to
the top ``max_nms`` candidates, class separation by a ``cls * max_wh``
offset, greedy IoU suppression, ``max_det`` cut. Output shapes are fixed;
empty slots have score 0 and class -1.

The top-k cuts use a stable descending sort, so equal scores keep the lower
index first as ``lax.top_k`` does (``torch.topk`` promises no order).

The suppression step, :func:`suppress`, is the kernel ``csrc/nms_suppress.cu``
(it replaces ``mga_yolo_tpu/ops/pallas/nms.py`` ``_suppress_kernel_factory``)
on CUDA tensors and :func:`suppress_ref` on CPU tensors. The greedy chain of
k dependent steps bounds it; a plain PyTorch loop would take several small
launches for each of the k steps. The kernel is two device kernels: an IoU
bitmask of all pairs over many blocks into a (B, k, ceil(k / 64)) 64-bit
workspace that the wrapper allocates, then a word-blocked greedy scan, one
block per image. ``launches`` counts calls of the launch function.

:func:`nms_numpy` is the JAX package's one-image host NMS, in numpy: the
validator's artifacts use it, and the tests hold the device NMS to it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mga_yolo_tpu_torch.ops.boxes import xywh2xyxy

launches = 0


def suppress_ref(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                 conf_thres: float) -> torch.Tensor:
    """Plain version: boxes (B, k, 4) xyxy, scores (B, k) sorted -> keep (B, k) bool.

    The IoU matrix is formed with the kernel's operation order; the loop over
    candidates is ``nms_jax``'s ``fori_loop``.
    """
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    iw = (torch.minimum(x2[:, :, None], x2[:, None, :])
          - torch.maximum(x1[:, :, None], x1[:, None, :])).clamp_min(0.0)
    ih = (torch.minimum(y2[:, :, None], y2[:, None, :])
          - torch.maximum(y1[:, :, None], y1[:, None, :])).clamp_min(0.0)
    inter = iw * ih
    iou = inter / (area[:, :, None] + area[:, None, :] - inter + 1e-7)  # [b, i, j]
    above = iou > iou_thres
    live = scores > conf_thres
    b, k = scores.shape
    keep = torch.zeros((b, k), dtype=torch.bool, device=scores.device)
    for i in range(k):
        sup = (above[:, i, :i] & keep[:, :i]).any(1)
        keep[:, i] = ~sup & live[:, i]
    return keep


def _check(boxes: torch.Tensor, scores: torch.Tensor) -> None:
    b, k = scores.shape
    if tuple(boxes.shape) != (b, k, 4) or scores.device != boxes.device:
        raise ValueError(f"suppress: boxes {tuple(boxes.shape)} do not match scores {tuple(scores.shape)}")
    if k == 0 or b == 0:
        raise ValueError("suppress: empty input")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("suppress: kernel takes float32 boxes and scores")
    if not (boxes.is_contiguous() and scores.is_contiguous()) or boxes.data_ptr() % 16:
        raise ValueError("suppress: boxes and scores must be contiguous, boxes 16-byte aligned")


_lib = None


def _library():
    """The built library, its entry points typed once."""
    global _lib
    if _lib is None:
        from mga_yolo_tpu_torch.kernels import _build

        lib = _build.load("nms_suppress")
        lib.nms_suppress_max_k.restype = ctypes.c_int
        lib.nms_suppress_max_k.argtypes = []
        lib.nms_suppress_launch.restype = ctypes.c_int
        lib.nms_suppress_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        )
        lib.max_k = lib.nms_suppress_max_k()
        _lib = lib
    return _lib


def _launch(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
            conf_thres: float) -> torch.Tensor:
    global launches
    from mga_yolo_tpu_torch.kernels import _build

    lib = _library()
    b, k = scores.shape
    if k > lib.max_k:
        raise ValueError(f"suppress: k={k} exceeds the kernel's {lib.max_k}")
    with torch.cuda.device(boxes.device):
        keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
        ws = torch.empty((b, k, -(-k // 64)), dtype=torch.int64, device=boxes.device)
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.nms_suppress_launch(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), ws.data_ptr(),
                                      b, k, iou_thres, conf_thres, stream)
    _build.check(err, "nms_suppress_launch")
    launches += 1
    return keep


def suppress(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
             conf_thres: float) -> torch.Tensor:
    """Greedy keep mask over score-sorted candidates: (B, k, 4), (B, k) -> (B, k) bool."""
    if boxes.device.type == "cpu":
        return suppress_ref(boxes, scores, iou_thres, conf_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"suppress: no kernel for device {boxes.device}")
    _check(boxes, scores)
    return _launch(boxes, scores, iou_thres, conf_thres)


def _top(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` order: descending, equal scores by ascending index."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def nms(
    pred: torch.Tensor,          # (B, A, 4+nc) decoded: xywh px + class probs
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    max_nms: int = 1024,
    class_agnostic: bool = False,
    max_wh: float = 7680.0,
    multi_label: bool = False,
):
    """Batched fixed-shape NMS.

    Returns (boxes (B, max_det', 4) xyxy, scores (B, max_det'), cls
    (B, max_det')) with max_det' = min(max_det, max_nms, candidates), zero
    scores and class -1 in empty slots.
    """
    b, a, no = pred.shape
    nc = no - 4
    boxes = xywh2xyxy(pred[..., :4]).float()
    cls_probs = pred[..., 4:].float()
    if multi_label and nc > 1:
        # anchor i, class j -> candidate i*nc+j
        scores = cls_probs.reshape(b, a * nc)
        cls = torch.arange(nc, dtype=torch.float32, device=pred.device).repeat(b, a)
        boxes = boxes.repeat_interleave(nc, dim=1)
        n_cand = a * nc
    else:
        scores = cls_probs.amax(-1)
        cls = cls_probs.argmax(-1).float()
        n_cand = a
    scores = torch.where(scores > conf_thres, scores, 0.0)

    k = min(max_nms, n_cand)
    top_scores, top_idx = _top(scores, k)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls, 1, top_idx)
    offset = torch.zeros_like(top_cls) if class_agnostic else top_cls * max_wh
    obox = (top_boxes + offset[..., None]).contiguous()

    keep = suppress(obox, top_scores.contiguous(), iou_thres, conf_thres)

    final_scores = torch.where(keep, top_scores, 0.0)
    sel_scores, sel = _top(final_scores, min(max_det, k))
    sel_boxes = torch.gather(top_boxes, 1, sel[..., None].expand(-1, -1, 4))
    sel_cls = torch.gather(top_cls, 1, sel)
    sel_cls = torch.where(sel_scores > 0, sel_cls, -1.0)
    return sel_boxes, sel_scores, sel_cls


def nms_numpy(
    pred: np.ndarray,            # (A, 4+nc) decoded: xywh px + class probs
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    multi_label: bool = False,
    class_agnostic: bool = False,
    max_wh: float = 7680.0,
) -> np.ndarray:
    """One image's host NMS -> (N, 6) float32 [x1, y1, x2, y2, conf, cls]."""
    nc = pred.shape[-1] - 4
    xy, half = pred[:, :2], pred[:, 2:4] / 2
    boxes = np.concatenate([xy - half, xy + half], -1)
    probs = pred[:, 4:]

    if multi_label and nc > 1:
        ii, jj = np.nonzero(probs > conf_thres)
        cand = np.concatenate([boxes[ii], probs[ii, jj][:, None], jj[:, None].astype(np.float32)], 1)
    else:
        conf = probs.max(-1)
        cls = probs.argmax(-1).astype(np.float32)
        keep = conf > conf_thres
        cand = np.concatenate([boxes[keep], conf[keep][:, None], cls[keep][:, None]], 1)
    if not len(cand):
        return np.zeros((0, 6), np.float32)

    cand = cand[np.argsort(-cand[:, 4])][:30000]
    off = np.zeros(len(cand)) if class_agnostic else cand[:, 5] * max_wh
    b = cand[:, :4] + off[:, None]
    keep_idx = []
    order = np.arange(len(cand))
    while order.size:
        i = order[0]
        keep_idx.append(i)
        if len(keep_idx) >= max_det or order.size == 1:
            break
        rest = order[1:]
        lt = np.maximum(b[i, :2], b[rest, :2])
        rb = np.minimum(b[i, 2:], b[rest, 2:])
        inter = np.clip(rb - lt, 0, None).prod(-1)
        area_i = (b[i, 2:] - b[i, :2]).prod()
        area_r = (b[rest, 2:] - b[rest, :2]).prod(-1)
        iou = inter / (area_i + area_r - inter + 1e-7)
        order = rest[iou <= iou_thres]
    return cand[np.array(keep_idx, int)].astype(np.float32)
