"""YOLO-format detection dataset with per-image binary masks, without OpenCV.

Counterpart of ``mga_yolo_tpu/data/dataset.py``: YOLO txt labels (parsed
once into an on-disk cache), stem-matched mask discovery, the mask-synced
augmentation pipeline and the mask pyramid at strides 8/16/32, emitted at
fixed shapes. Images (PNG, JPEG, BMP, TIFF, WebP) are read by ``data/image_io.py``; the data YAML
is read by the port's own reader (``config.read_yaml``).

A sample (:meth:`MGADataset.get`) is numpy on the host: ``image`` (S, S, 3)
uint8 BGR, ``gt_boxes`` (M, 4) float32 xyxy pixels, ``gt_labels`` (M,)
int32, ``mask_gt`` (M,) float32, ``masks`` [(S/8, S/8, 1), (S/16, ...),
(S/32, ...)] float32 (binary, or probabilities with ``prob_mode``) and
``index``; :func:`collate` stacks samples into the batch dict that
``train.state.make_train_step`` takes (``data/loader.py`` moves it to the
card). A training sample draws its random numbers from the
``np.random.Generator`` it is given in the JAX package's order, so a seed
gives the same geometry.
"""

from __future__ import annotations

import hashlib
import logging
import math
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from mga_yolo_tpu_torch.config import MGAConfig, read_yaml, resolve_cache_mode
from mga_yolo_tpu_torch.data import image_io, mask_ops
from mga_yolo_tpu_torch.data import transforms as T

IMG_EXTS = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}
STRIDES = (8, 16, 32)
LABEL_CACHE_VERSION = 1
log = logging.getLogger("mga.data")


def _resolve(root: Optional[str], p: str) -> Path:
    path = Path(p)
    return Path(root) / p if not path.is_absolute() and root else path


def list_images(source: Path) -> list[Path]:
    """The images of a directory (recursive, sorted) or of a .txt list."""
    if source.is_file() and source.suffix == ".txt":
        return [_resolve(str(source.parent), line.strip()) for line in source.read_text().splitlines()
                if line.strip()]
    if source.is_dir():
        return sorted(p for p in source.rglob("*") if p.suffix.lower() in IMG_EXTS)
    raise FileNotFoundError(f"image source not found: {source}")


def rect_bucket_shapes(imgsz: int) -> list[tuple[int, int]]:
    """Static (h, w) aspect buckets for rect batching, /32-aligned: wide,
    square, tall."""
    def r32(x: float) -> int:
        return max(32, int(math.ceil(x / 32)) * 32)

    fracs = (0.5, 0.75)
    return ([(r32(imgsz * q), imgsz) for q in fracs] + [(imgsz, imgsz)]
            + [(imgsz, r32(imgsz * q)) for q in reversed(fracs)])


def label_path_for(img_path: Path) -> Path:
    """images/.../x.png -> labels/.../x.txt (standard YOLO layout)."""
    parts = list(img_path.parts)
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "images":
            parts[i] = "labels"
            break
    return Path(*parts).with_suffix(".txt")


def parse_yolo_label_file(path: Path) -> np.ndarray:
    """YOLO txt -> (N, 5) float32 rows [cls, cx, cy, w, h] (normalised)."""
    if not path.exists():
        return np.zeros((0, 5), np.float32)
    rows = [[float(v) for v in line.split()[:5]] for line in path.read_text().splitlines()
            if len(line.split()) >= 5]
    return np.asarray(rows, np.float32) if rows else np.zeros((0, 5), np.float32)


def rows_to_labels(rows: np.ndarray, w: int, h: int) -> tuple[np.ndarray, np.ndarray]:
    """(N, 5) normalised rows -> (cls (N,), boxes (N, 4) xyxy px)."""
    if not len(rows):
        return np.zeros((0,), np.float32), np.zeros((0, 4), np.float32)
    cx, cy, bw, bh = rows[:, 1] * w, rows[:, 2] * h, rows[:, 3] * w, rows[:, 4] * h
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    return rows[:, 0].astype(np.float32), boxes.astype(np.float32)


def load_labels_cached(img_files: list[Path], split: str) -> list[np.ndarray]:
    """Every label file parsed once, kept in ``.mga_labels_{split}.cache.npz``
    beside the first label file, keyed by a hash of the label files' paths,
    mtimes and sizes (a change to any re-parses them all). A cache that
    cannot be read or written falls back to parsing. The cache is written to
    a name of this process's and renamed into place, so the ranks of a
    data-parallel run, which start together, never read a partial file."""
    lbl_paths = [label_path_for(p) for p in img_files]
    if not lbl_paths:
        return []
    h = hashlib.sha1(f"v{LABEL_CACHE_VERSION}".encode())
    for p in lbl_paths:
        st = p.stat() if p.exists() else None
        h.update(str(p).encode())
        h.update(str(st.st_mtime_ns if st else 0).encode())
        h.update(str(st.st_size if st else -1).encode())
    key = h.hexdigest()
    cache_path = lbl_paths[0].parent / f".mga_labels_{split}.cache.npz"
    try:
        if cache_path.exists():
            z = np.load(cache_path, allow_pickle=False)
            if str(z["key"]) == key:
                offs = np.concatenate([[0], np.cumsum(z["lengths"])]) * 5
                return [z["flat"][a:b].reshape(-1, 5) for a, b in zip(offs[:-1], offs[1:])]
    except (OSError, ValueError, KeyError, EOFError):
        pass
    labels = [parse_yolo_label_file(p) for p in lbl_paths]
    tmp = cache_path.with_name(f"{cache_path.name}.{os.getpid()}.tmp")
    try:
        flat = np.concatenate([x.reshape(-1) for x in labels]).astype(np.float32)
        with open(tmp, "wb") as f:
            np.savez(f, key=key, flat=flat, lengths=np.asarray([len(x) for x in labels], np.int64))
        os.replace(tmp, cache_path)
    except OSError:
        tmp.unlink(missing_ok=True)  # a read-only label directory: parsing on every start still works
    return labels


def check_cache_ram(sample_bytes: int, n: int, safety: float = 1.1) -> bool:
    """True when n decoded images fit in the available RAM with a margin."""
    try:
        avail = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        return False
    return sample_bytes * n * safety < avail


def check_cache_disk(sample_bytes: int, n: int, path: Path, safety: float = 1.1) -> bool:
    """True when n .npy sidecars fit in the filesystem holding ``path``."""
    try:
        free = shutil.disk_usage(path).free
    except OSError:
        return False
    return sample_bytes * n * safety < free


class MGADataset:
    """Image + boxes + binary-mask dataset producing fixed-shape samples.

    Host-side numpy throughout; ``data/loader.py`` batches the samples and
    moves them to the card."""

    def __init__(self, cfg: MGAConfig, split: str = "train", augment: bool = True):
        self.cfg = cfg
        self.split = split
        self.augment = augment
        self.imgsz = cfg.data.imgsz
        self.max_boxes = cfg.data.max_boxes

        dy = read_yaml(cfg.data.data) or {}
        root = dy.get("path") or dy.get("dataset")
        self.dataset_root = cfg.data.dataset_root or dy.get("dataset") or root
        self.masks_dir = cfg.data.masks_dir or dy.get("masks_dir")
        self.names = dy.get("names", {0: "object"})
        self.img_files = list_images(_resolve(root, dy.get(split) or dy.get("val")))
        if cfg.data.fraction < 1.0:
            self.img_files = self.img_files[:max(1, int(len(self.img_files) * cfg.data.fraction))]
        self.mask_paths = [mask_ops.infer_mask_path(p, self.dataset_root, self.masks_dir) for p in self.img_files]
        self._labels = load_labels_cached(self.img_files, split)
        self._cache: dict[int, tuple] = {}
        self._final_cache: dict[tuple, dict] = {}  # eval samples, processed
        self._aug_dumped = 0

        # image cache: "ram" decodes every image and mask once; "disk" keeps
        # each decoded image as a .npy sidecar. Either is turned off, with a
        # warning, when the RAM or the disk would not hold it.
        self.cache_mode = resolve_cache_mode(cfg.data.cache)
        if self.cache_mode and len(self.img_files):
            est = image_io.imread(self.img_files[0]).nbytes
            n = len(self.img_files)
            if self.cache_mode == "ram":
                est_ram = est * (1 if augment else 2)  # eval also keeps the processed sample
                if not check_cache_ram(est_ram, n):
                    log.warning("cache='ram' needs ~%.1f GB for %d images but less is free; caching disabled "
                                "(use cache='disk')", est_ram * n * 1.1 / 2**30, n)
                    self.cache_mode = None
            else:
                missing = sum(1 for i in range(n) if not self._npy_sidecar(i).exists())
                if missing and not check_cache_disk(est, missing, self.img_files[0].parent):
                    log.warning("cache='disk' needs ~%.1f GB free next to the images; caching disabled",
                                est * missing * 1.1 / 2**30)
                    self.cache_mode = None
        if self.cache_mode:
            self._cache_images()

        # rectangular val batching: images binned into a few static
        # /32-aligned aspect buckets; the loader batches within a bucket
        self.rect = bool(cfg.data.rect) and not augment
        self.bucket: Optional[np.ndarray] = None
        self.bucket_shapes: list[tuple[int, int]] = []
        if self.rect:
            self.bucket_shapes = rect_bucket_shapes(self.imgsz)
            log_b = np.log([h / w for h, w in self.bucket_shapes])
            ars = np.array([h / w for h, w in map(image_io.image_size, self.img_files)])  # file headers
            self.bucket = np.abs(np.log(ars)[:, None] - log_b[None, :]).argmin(1)

    def __len__(self) -> int:
        return len(self.img_files)

    # ---- raw sample loading ----

    def _npy_sidecar(self, i: int) -> Path:
        p = self.img_files[i]
        return p.with_name(p.name + ".npy")  # <name>.<ext>.npy: a.png and a.jpg do not collide

    def _decode_image(self, i: int) -> np.ndarray:
        if self.cache_mode == "disk":
            npy = self._npy_sidecar(i)
            if npy.exists():
                try:
                    return np.load(npy)
                except (OSError, ValueError):
                    npy.unlink(missing_ok=True)  # a corrupt sidecar: decode again
        return image_io.imread(self.img_files[i])

    def _cache_images(self) -> None:
        n = len(self.img_files)
        workers = max(1, min(8, self.cfg.data.workers))
        if self.cache_mode == "ram":
            with ThreadPoolExecutor(max_workers=workers) as pool:
                for _ in pool.map(self.load_raw, range(n)):  # drained, not kept: the RAM check budgets one copy
                    pass
            return

        def write(i: int) -> None:  # renamed into place: another rank may be reading the sidecars
            npy = self._npy_sidecar(i)
            if not npy.exists():
                tmp = npy.with_name(f"{npy.name}.{os.getpid()}.tmp")
                with open(tmp, "wb") as f:
                    np.save(f, image_io.imread(self.img_files[i]))
                os.replace(tmp, npy)

        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(write, range(n)))

    def load_raw(self, i: int) -> T.Sample:
        """Image, labels (boxes in pixels) and the full-resolution mask."""
        if self.cache_mode == "ram" and i in self._cache:
            img, cls, boxes, mask = self._cache[i]
            return {"img": img.copy(), "cls": cls.copy(), "boxes": boxes.copy(),
                    "mask": None if mask is None else mask.copy()}
        img = self._decode_image(i)
        h, w = img.shape[:2]
        cls, boxes = rows_to_labels(self._labels[i], w, h)
        if self.cfg.data.single_cls:
            cls = np.zeros_like(cls)
        mask = None
        if self.mask_paths[i] is not None:
            mask = mask_ops.load_binary_mask(self.mask_paths[i])
            if mask.shape[:2] != (h, w):
                mask = mask_ops.resize_nearest(mask, (h, w))
        if self.cache_mode == "ram":
            self._cache[i] = (img, cls, boxes, mask)
            return {"img": img.copy(), "cls": cls.copy(), "boxes": boxes.copy(),
                    "mask": None if mask is None else mask.copy()}
        return {"img": img, "cls": cls, "boxes": boxes, "mask": mask}

    # ---- augmentation pipeline ----

    def _train_sample(self, i: int, rng: np.random.Generator, use_mosaic: bool,
                      size: Optional[int] = None) -> T.Sample:
        aug = self.cfg.augment
        s = size or self.imgsz
        if use_mosaic and rng.random() < aug.mosaic:
            n = aug.mosaic_n if aug.mosaic_n in (3, 4, 9) else 4
            idxs = [i] + list(rng.integers(0, len(self), n - 1))
            parts = [T.letterbox_sample(self.load_raw(j), s, scaleup=True, center=False) for j in idxs]
            sample = {3: T.mosaic3, 4: T.mosaic4, 9: T.mosaic9}[n](parts, rng, s)
            sample = T.random_affine(sample, rng, aug, border=(-s // 2, -s // 2))
            if aug.mixup and rng.random() < aug.mixup:
                other = self._train_sample(int(rng.integers(0, len(self))), rng, use_mosaic, s)
                sample = T.mixup(sample, other, rng)
            elif aug.cutmix and rng.random() < aug.cutmix:
                other = self._train_sample(int(rng.integers(0, len(self))), rng, use_mosaic, s)
                sample = T.cutmix(sample, other, rng)
        else:
            sample = T.letterbox_sample(self.load_raw(i), s, scaleup=True)
            sample = T.random_affine(sample, rng, aug)
        if aug.albumentations:
            sample = T.albumentations(sample, rng, aug.albumentations)
        sample = T.random_hsv(sample, rng, aug.hsv_h, aug.hsv_s, aug.hsv_v)
        return T.random_flip(sample, rng, aug.fliplr, aug.flipud)

    def get(self, i: int, rng: Optional[np.random.Generator] = None, use_mosaic: bool = True,
            imgsz: Optional[int] = None) -> dict:
        """One fixed-shape sample; ``imgsz`` overrides the configured size
        (bucketed multi-scale training)."""
        size = imgsz or self.imgsz
        if self.augment:
            rng = rng or np.random.default_rng()
            return self.finalize(self._train_sample(i, rng, use_mosaic, size), i, imgsz=size)
        shape = self.bucket_shapes[self.bucket[i]] if self.rect else (size, size)
        # an eval sample depends only on (i, shape): with cache="ram" the
        # processed sample is kept (consumers never write to it)
        if self.cache_mode == "ram":
            hit = self._final_cache.get((i, shape))
            if hit is None:
                hit = self.finalize(T.letterbox_sample(self.load_raw(i), shape, scaleup=False), i, shape=shape)
                self._final_cache[(i, shape)] = hit
            return dict(hit)
        return self.finalize(T.letterbox_sample(self.load_raw(i), shape, scaleup=False), i, shape=shape)

    def finalize(self, sample: T.Sample, index: int = -1, imgsz: Optional[int] = None,
                 shape: Optional[tuple[int, int]] = None) -> dict:
        """Pad the GT to ``max_boxes``, build the mask pyramid, emit the
        fixed-shape arrays; ``shape`` is an (h, w) rect bucket, else square
        ``imgsz``."""
        hs, ws = shape if shape is not None else ((imgsz or self.imgsz),) * 2
        img = sample["img"]
        if img.shape[:2] != (hs, ws):
            raise ValueError(f"pipeline produced {img.shape}, expected {(hs, ws)}")

        n = min(len(sample.get("boxes", ())), self.max_boxes)
        gt_boxes = np.zeros((self.max_boxes, 4), np.float32)
        gt_cls = np.zeros((self.max_boxes,), np.int32)
        gt_valid = np.zeros((self.max_boxes,), np.float32)
        if n:
            gt_boxes[:n] = sample["boxes"][:n]
            gt_cls[:n] = sample["cls"][:n].astype(np.int32)
            gt_valid[:n] = 1.0

        mask = sample.get("mask")
        mcfg = self.cfg.mask
        if mcfg.save_aug_masks and self._aug_dumped < mcfg.save_max and mask is not None:
            dump = Path(self.cfg.train.project) / self.cfg.train.name / "aug_debug"
            dump.mkdir(parents=True, exist_ok=True)
            image_io.imwrite(dump / f"aug_{self._aug_dumped}_img.png", img)
            image_io.imwrite(dump / f"aug_{self._aug_dumped}_mask.png", (mask * 255).astype(np.uint8))
            self._aug_dumped += 1
        if mask is None:
            mask = np.zeros((hs, ws), np.uint8)
        if mcfg.prob_mode:
            pyr = {st: mask_ops.downsample_mask_prob(mask, st, mcfg.prob_method) for st in STRIDES}
        else:
            pyr = mask_ops.downsample_mask_multi(mask, STRIDES, mcfg)
        masks = []
        for st in STRIDES:
            m = pyr[st].astype(np.float32)
            if m.shape != (hs // st, ws // st):  # ceil vs exact division
                m = mask_ops.resize_nearest(m, (hs // st, ws // st))
            masks.append(m[..., None])
        return {
            "image": np.ascontiguousarray(img),  # (S, S, 3) uint8 BGR
            "gt_boxes": gt_boxes,                # (M, 4) xyxy px
            "gt_labels": gt_cls,                 # (M,)
            "mask_gt": gt_valid,                 # (M,)
            "masks": masks,                      # [(S/8, S/8, 1), (S/16, ...), (S/32, ...)]
            "index": np.int32(index),
        }


def collate(samples: Sequence[dict]) -> dict:
    """Stack fixed-shape samples into a batch of numpy arrays."""
    out = {k: np.stack([s[k] for s in samples]) for k in ("image", "gt_boxes", "gt_labels", "mask_gt", "index")}
    out["masks"] = [np.stack([s["masks"][k] for s in samples]) for k in range(len(samples[0]["masks"]))]
    return out
