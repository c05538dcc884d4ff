"""K-fold dataset splitter (counterpart of ``mga_yolo_tpu/data/kfold.py``).

A seeded shuffle cut into k contiguous validation slices; per fold, trees
of symlinks to the images and labels and a data YAML that points at the
shared masks directory. The YAML is written by the port's own writer
(``utils/yaml_lite.py``), as ``yaml.safe_dump`` writes it.

    python -m mga_yolo_tpu_torch.data.kfold --images DIR --out DIR [--k 3]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from mga_yolo_tpu_torch.data.dataset import IMG_EXTS, label_path_for
from mga_yolo_tpu_torch.utils import yaml_lite


def kfold_indices(n: int, k: int, seed: int = 0) -> list[tuple[np.ndarray, np.ndarray]]:
    """k (train_idx, val_idx) pairs: contiguous validation slices of a shuffle."""
    order = np.arange(n)
    np.random.default_rng(seed).shuffle(order)
    folds = np.array_split(order, k)
    out = []
    for i in range(k):
        val = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i]) if k > 1 else val
        out.append((np.sort(train), np.sort(val)))
    return out


def write_fold(images: list[Path], root: Path, fold: int, train_idx: np.ndarray, val_idx: np.ndarray,
               masks_dir: str, dataset_root: str, names: dict) -> Path:
    """fold_<fold>/{images,labels}/{train,val} symlink trees and data.yaml."""
    fold_dir = root / f"fold_{fold}"
    for split, idxs in (("train", train_idx), ("val", val_idx)):
        img_out, lbl_out = fold_dir / "images" / split, fold_dir / "labels" / split
        img_out.mkdir(parents=True, exist_ok=True)
        lbl_out.mkdir(parents=True, exist_ok=True)
        for i in idxs:
            src = images[i]
            dst = img_out / src.name
            if not dst.exists():
                dst.symlink_to(src.resolve())
            lbl = label_path_for(src)
            if lbl.exists() and not (lbl_out / lbl.name).exists():
                (lbl_out / lbl.name).symlink_to(lbl.resolve())
    data_yaml = fold_dir / "data.yaml"
    yaml_lite.dump({"path": str(fold_dir), "train": "images/train", "val": "images/val",
                    "dataset": dataset_root, "masks_dir": masks_dir, "names": names, "nc": len(names)}, data_yaml)
    return data_yaml


def main(argv=None) -> None:
    p = argparse.ArgumentParser("mga-kfold")
    p.add_argument("--images", required=True, help="source images directory")
    p.add_argument("--out", required=True, help="output root for fold trees")
    p.add_argument("--k", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--masks-dir", default="masks")
    p.add_argument("--dataset-root", default=None, help="root containing masks/ (default: images parent)")
    p.add_argument("--names", default="stenosis", help="comma-separated class names")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    src = Path(args.images)
    images = sorted(x for x in src.rglob("*") if x.suffix.lower() in IMG_EXTS)
    if not images:
        raise SystemExit(f"no images under {src}")
    names = dict(enumerate(args.names.split(",")))
    dataset_root = args.dataset_root or str(src.parent)
    for fold, (tr, va) in enumerate(kfold_indices(len(images), args.k, args.seed)):
        dy = write_fold(images, Path(args.out), fold, tr, va, args.masks_dir, dataset_root, names)
        print(f"fold {fold}: {len(tr)} train / {len(va)} val -> {dy}")


if __name__ == "__main__":
    main()
