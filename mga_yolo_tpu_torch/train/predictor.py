"""Inference API: images in, detection :class:`Results` with the MGA masks
out (counterpart of ``mga_yolo_tpu/train/predictor.py``).

The letterbox runs on the host, the batched eval forward (with the
attention kernels) on the model's device, and the NMS on the host with
``ops.nms.nms_numpy``, as in the JAX package; boxes are rescaled to the
original image and each scale's mask logits come back as sigmoid
probabilities in ``Results.mga_masks``. Float32 by default. A short last
batch runs at its own size (the JAX package pads it to one compiled shape;
the results are the same).

:class:`TFLitePredictor` runs an exported ``.tflite`` file or SavedModel
directory (TensorFlow, on the host) in place of the model.

``Results.plot`` draws in numpy: the boxes as ``cv2.rectangle`` draws them
at thickness 2, the ``"{cls}:{conf:.2f}"`` label in a small built-in bitmap
font (the card's host has no OpenCV and no font package).
"""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from mga_yolo_tpu_torch.data import image_io
from mga_yolo_tpu_torch.data.sources import iter_source
from mga_yolo_tpu_torch.data.transforms import letterbox, scale_boxes
from mga_yolo_tpu_torch.ops.nms import nms_numpy
from mga_yolo_tpu_torch.utils.model_utils import fuse_model

GREEN = (0, 255, 0)  # BGR, the boxes' and labels' colour
TEXT_SCALE = 2  # pixels per glyph pixel: labels 10 px high, about cv2's FONT_HERSHEY_SIMPLEX at 0.5

# 3x5 glyphs of the label's characters, one row string per pixel row
_GLYPHS = {
    "0": ("###", "#.#", "#.#", "#.#", "###"), "1": (".#.", "##.", ".#.", ".#.", "###"),
    "2": ("###", "..#", "###", "#..", "###"), "3": ("###", "..#", "###", "..#", "###"),
    "4": ("#.#", "#.#", "###", "..#", "..#"), "5": ("###", "#..", "###", "..#", "###"),
    "6": ("###", "#..", "###", "#.#", "###"), "7": ("###", "..#", "..#", "..#", "..#"),
    "8": ("###", "#.#", "###", "#.#", "###"), "9": ("###", "#.#", "###", "..#", "###"),
    ":": ("...", ".#.", "...", ".#.", "..."), ".": ("...", "...", "...", "...", ".#."),
}


def draw_rectangle(img: np.ndarray, p1: tuple[int, int], p2: tuple[int, int]) -> np.ndarray:
    """``cv2.rectangle(img, p1, p2, GREEN, 2)`` in place: each side a band
    three pixels wide centred on it, the four outer corner pixels left out;
    clipped to the image."""
    (x1, x2), (y1, y2) = sorted((p1[0], p2[0])), sorted((p1[1], p2[1]))
    H, W = img.shape[:2]

    def fill(ya: int, yb: int, xa: int, xb: int) -> None:  # inclusive bounds
        ya, xa, yb, xb = max(ya, 0), max(xa, 0), min(yb, H - 1), min(xb, W - 1)
        if ya <= yb and xa <= xb:
            img[ya:yb + 1, xa:xb + 1] = GREEN

    for y in (y1, y2):
        fill(y - 1, y + 1, x1, x2)
    for x in (x1, x2):
        fill(y1, y2, x - 1, x + 1)
    return img


def draw_text(img: np.ndarray, text: str, origin: tuple[int, int]) -> np.ndarray:
    """``text`` (digits, ':' and '.') in GREEN in place, its bottom-left
    corner at ``origin``, each glyph 3x5 pixels times ``TEXT_SCALE``;
    clipped to the image."""
    H, W = img.shape[:2]
    x0, y_bottom = origin
    scale = TEXT_SCALE
    top = y_bottom - 5 * scale + 1
    for ch in text:
        for r, row in enumerate(_GLYPHS[ch]):
            for c, on in enumerate(row):
                if on == "#":
                    ya, xa = top + r * scale, x0 + c * scale
                    ys, xs = slice(max(ya, 0), min(ya + scale, H)), slice(max(xa, 0), min(xa + scale, W))
                    img[ys, xs] = GREEN
        x0 += 4 * scale
    return img


@dataclasses.dataclass
class Results:
    """One image's predictions."""

    path: str
    orig_shape: tuple[int, int]
    boxes: np.ndarray                   # (N, 6) [x1, y1, x2, y2, conf, cls] in original coordinates
    mga_masks: Dict[str, np.ndarray]    # {"p3", "p4", "p5"}: (h, w) sigmoid probabilities

    def __len__(self) -> int:
        return len(self.boxes)

    def plot(self, img: Optional[np.ndarray] = None) -> np.ndarray:
        """The boxes and their labels drawn on ``img`` (in place) or on the
        image read from :attr:`path`."""
        im = img if img is not None else image_io.imread(self.path)
        for x1, y1, x2, y2, conf, c in self.boxes:
            draw_rectangle(im, (int(x1), int(y1)), (int(x2), int(y2)))
            draw_text(im, f"{int(c)}:{conf:.2f}", (int(x1), max(0, int(y1) - 4)))
        return im


class MGAPredictor:
    """Batched prediction with an ``MGAModel`` on its device. The predictor
    works on a copy of the model, BN-folded when ``fuse``, cast to ``dtype``."""

    def __init__(self, model: torch.nn.Module, imgsz: int = 640, conf: float = 0.25, iou: float = 0.45,
                 max_det: int = 300, dtype: torch.dtype = torch.float32, fuse: bool = False):
        model = copy.deepcopy(model).eval()
        if fuse:
            fuse_model(model)
        self.model = model.to(dtype)
        self.device = next(model.parameters()).device
        self.imgsz, self.conf, self.iou, self.max_det, self.dtype = imgsz, conf, iou, max_det, dtype

    @torch.inference_mode()
    def forward_batch(self, x_np: np.ndarray):
        """(B, S, S, 3) uint8 -> (decoded (B, A, 4+nc) float32, {scale: mask
        logits (B, h, w, 1) float32}) as numpy, the JAX package's layout."""
        x = torch.from_numpy(np.ascontiguousarray(x_np)).to(self.device)
        out = self.model(x.permute(0, 3, 1, 2).contiguous().to(self.dtype) / 255.0)
        decoded = out["det"][0].float().cpu().numpy()
        return decoded, {k: v.float().permute(0, 2, 3, 1).cpu().numpy() for k, v in out["seg"].items()}

    def _preprocess(self, img: np.ndarray) -> tuple[np.ndarray, tuple]:
        lb, ratio_pad = letterbox(img, self.imgsz, scaleup=False)
        return lb, (img.shape[:2], ratio_pad)

    def _infer_batch(self, imgs: list, metas: list) -> List[Results]:
        """Forward one batch of letterboxed images and postprocess each row."""
        decoded, seg = self.forward_batch(np.stack(imgs))
        out: List[Results] = []
        for i, (path, orig_shape, ratio_pad) in enumerate(metas):
            dets = nms_numpy(decoded[i], self.conf, self.iou, self.max_det)
            dets[:, :4] = scale_boxes(dets[:, :4], ratio_pad, orig_shape)
            masks = {k: 1.0 / (1.0 + np.exp(-seg[k][i, ..., 0])) for k in seg}
            out.append(Results(path, orig_shape, dets, masks))
        return out

    def stream(self, source, batch_size: int = 16, max_frames: int = 0):
        """(Frame, Results) pairs over any source ``data.sources.iter_source``
        takes, in frame order, ``batch_size`` frames a forward."""
        frames, imgs, metas = [], [], []
        for frame in iter_source(source, max_frames=max_frames):
            lb, (shape, ratio_pad) = self._preprocess(frame.img)
            frames.append(frame)
            imgs.append(lb)
            metas.append((frame.path, shape, ratio_pad))
            if len(imgs) == batch_size:
                yield from zip(frames, self._infer_batch(imgs, metas))
                frames, imgs, metas = [], [], []
        if imgs:
            yield from zip(frames, self._infer_batch(imgs, metas))

    def __call__(self, sources: Iterable[str | Path | np.ndarray], batch_size: int = 16) -> List[Results]:
        """Results of image paths or BGR arrays, in order."""
        return [r for _, r in self.stream(list(sources), batch_size)]


class TFLitePredictor(MGAPredictor):
    """Predictor over an exported ``.tflite`` file (``cli.ckpt
    export-tflite``) or SavedModel directory (``export-savedmodel``), with
    :class:`MGAPredictor`'s stream / call / postprocess surface.

    The forward is ``export.tflite.ExportedModel``: TensorFlow on the host,
    at the file's own batch, in chunks with the tail padded; the file embeds
    the /255, so it takes the same 0-255 letterboxed pixels. The int8 split
    layout's boxes and scores are joined again, and the mask logits named by
    their stride. The NMS runs on the host as for a checkpoint. ``device``
    is resolved as for a checkpoint (CUDA when None), though nothing of the
    prediction runs there. ``imgsz`` must be the file's own, or None. Where
    TensorFlow does not import, the constructor raises an ImportError naming
    it.
    """

    def __init__(self, path: str | Path, imgsz: Optional[int] = None, conf: float = 0.25, iou: float = 0.45,
                 max_det: int = 300, device: str | torch.device | None = None, **_ignored):
        from mga_yolo_tpu_torch.device import resolve_device
        from mga_yolo_tpu_torch.export.tflite import ExportedModel

        self.exported = ExportedModel(path, f"a predictor of {Path(path).name}")
        self.device = resolve_device(device)
        self.imgsz = self.exported.check_size(imgsz)
        self.conf, self.iou, self.max_det = conf, iou, max_det

    def forward_batch(self, x_np: np.ndarray):
        """(B, S, S, 3) 0-255 -> (decoded (B, A, 4+nc), {scale: (B, h, w, 1)}), float32 numpy."""
        return self.exported(x_np)


def load_predictor(ckpt_path: str | Path, model_yaml=None, scale: Optional[str] = None,
                   imgsz: Optional[int] = None, use_pallas="auto", device: str | torch.device | None = None,
                   **kw) -> MGAPredictor:
    """An :class:`MGAPredictor` of a checkpoint (the trainer's ``.pt`` or a
    reference-format file), on ``device`` (CUDA when None), or a
    :class:`TFLitePredictor` of a ``.tflite`` file or SavedModel directory.
    ``imgsz`` defaults to the checkpoint's (the file's); ``use_pallas`` (the
    JAX package's kernel switch) changes nothing."""
    from mga_yolo_tpu_torch.export.tflite import is_saved_model

    if str(ckpt_path).endswith(".tflite") or is_saved_model(ckpt_path):
        return TFLitePredictor(ckpt_path, imgsz=imgsz, device=device, **kw)
    from mga_yolo_tpu_torch.utils.checkpoint import rebuild_from_checkpoint

    net, meta = rebuild_from_checkpoint(ckpt_path, model_yaml, scale, device=device)
    return MGAPredictor(net, imgsz=imgsz or int(meta.get("imgsz", 640)), **kw)
