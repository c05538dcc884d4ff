"""A synthetic ARCADE-shaped dataset, written with numpy and ``data/image_io``.

Grey angiogram-like PNGs (dark vessels on a noisy bright background), a
binary vessel mask per image, 1 to ``max_boxes`` YOLO boxes per image on
the vessels (where a stenosis would be marked), and a data YAML with the MGA
``dataset`` / ``masks_dir`` keys, in the layout ``data/dataset.py`` reads:
``images/train``, ``labels/train``, ``masks``. It needs neither OpenCV nor
PyYAML, so the card's host can make it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mga_yolo_tpu_torch.data import image_io
from mga_yolo_tpu_torch.utils import yaml_lite


def _draw_segment(mask: np.ndarray, p0: np.ndarray, p1: np.ndarray, radius: float) -> None:
    """Set every pixel within ``radius`` of the segment p0-p1 (x, y)."""
    h, w = mask.shape
    lo = np.floor(np.minimum(p0, p1) - radius).astype(int).clip(0, [w - 1, h - 1])
    hi = np.ceil(np.maximum(p0, p1) + radius).astype(int).clip(0, [w - 1, h - 1])
    ys, xs = np.mgrid[lo[1]:hi[1] + 1, lo[0]:hi[0] + 1]
    d = p1 - p0
    t = np.clip(((xs - p0[0]) * d[0] + (ys - p0[1]) * d[1]) / max(float(d @ d), 1e-9), 0, 1)
    near = (xs - p0[0] - t * d[0]) ** 2 + (ys - p0[1] - t * d[1]) ** 2 <= radius * radius
    mask[lo[1]:hi[1] + 1, lo[0]:hi[0] + 1] |= near


def vessel_image(rng: np.random.Generator, size: int, max_boxes: int):
    """One (grey image (size, size) uint8, mask {0, 255} uint8, YOLO rows)."""
    mask = np.zeros((size, size), bool)
    centre_lines = []
    for _ in range(int(rng.integers(3, 7))):
        pts = np.cumsum(np.vstack([rng.uniform(0.1, 0.9, 2) * size,
                                   rng.normal(0, size / 6, (int(rng.integers(3, 6)), 2))]), 0)
        pts = pts.clip(0, size - 1)
        radius = rng.uniform(size / 160, size / 60)
        for p0, p1 in zip(pts[:-1], pts[1:]):
            _draw_segment(mask, p0, p1, radius)
            centre_lines.append((p0, p1))
    img = rng.normal(170, 12, (size, size)) - 90 * mask
    img = np.clip(img, 0, 255).astype(np.uint8)
    rows = []
    for _ in range(int(rng.integers(1, max_boxes + 1))):
        p0, p1 = centre_lines[int(rng.integers(0, len(centre_lines)))]
        c = p0 + rng.uniform(0, 1) * (p1 - p0)
        bw, bh = rng.uniform(size / 20, size / 8, 2)
        x1, y1 = np.clip(c - (bw / 2, bh / 2), 0, size)
        x2, y2 = np.clip(c + (bw / 2, bh / 2), 0, size)
        rows.append(f"0 {(x1 + x2) / 2 / size:.6f} {(y1 + y2) / 2 / size:.6f} {(x2 - x1) / size:.6f} "
                    f"{(y2 - y1) / size:.6f}")
    return img, (mask * 255).astype(np.uint8), rows


def write_synthetic_dataset(root: str | Path, n: int = 64, size: int = 512, max_boxes: int = 8,
                            seed: int = 0) -> Path:
    """Write ``n`` images of ``size`` px under ``root``; returns the data YAML."""
    root = Path(root)
    img_dir, lbl_dir, mask_dir = root / "images" / "train", root / "labels" / "train", root / "masks"
    for d in (img_dir, lbl_dir, mask_dir):
        d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        img, mask, rows = vessel_image(rng, size, max_boxes)
        image_io.imwrite(img_dir / f"im{i:04d}.png", img)
        image_io.imwrite(mask_dir / f"im{i:04d}.png", mask)
        (lbl_dir / f"im{i:04d}.txt").write_text("\n".join(rows) + "\n")
    data_yaml = root / "data.yaml"
    yaml_lite.dump({"path": str(root), "train": "images/train", "val": "images/train", "dataset": str(root),
                    "masks_dir": "masks", "names": {0: "stenosis"}, "nc": 1}, data_yaml)
    return data_yaml
