"""results.csv with the reference's columns (counterpart of
``mga_yolo_tpu/utils/csvlog.py``).

The header is fixed: epoch, train/val det {total, box, dfl, cls}, train/val
seg {total, p3/p4/p5 x bce/dice}, Kendall ``mtl/sigma2_*`` and ``mtl/w_*``,
then the other keys of the first row, sorted (``metrics/*``, ``alpha_P*``,
``spade/*``, ``lr``, ``time``). The reference's plotting suite reads it.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict

import numpy as np

HEADER_ORDER = [
    "epoch",
    "train/det/total", "train/det/box", "train/det/dfl", "train/det/cls",
    "train/seg/total", "train/seg/p3_bce", "train/seg/p3_dice",
    "train/seg/p4_bce", "train/seg/p4_dice", "train/seg/p5_bce", "train/seg/p5_dice",
    "val/det/total", "val/det/box", "val/det/dfl", "val/det/cls",
    "val/seg/total", "val/seg/p3_bce", "val/seg/p3_dice",
    "val/seg/p4_bce", "val/seg/p4_dice", "val/seg/p5_bce", "val/seg/p5_dice",
    "mtl/sigma2_det", "mtl/sigma2_seg", "mtl/w_det", "mtl/w_seg",
]
SEG_KEYS = ("p3_bce", "p3_dice", "p4_bce", "p4_dice", "p5_bce", "p5_dice")


class ResultsCSV:
    """Appends one row per epoch to ``save_dir/results.csv``."""

    def __init__(self, save_dir: Path):
        self.path = Path(save_dir) / "results.csv"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._header: list[str] | None = None

    def truncate_after_epoch(self, start_epoch: int) -> None:
        """Drop the rows with epoch > ``start_epoch`` (1-based epochs), so a
        resume that re-runs those epochs writes no duplicate rows."""
        if not self.path.exists():
            return
        with open(self.path, newline="") as f:
            rows = list(csv.reader(f))
        if not rows:
            return
        header, body = rows[0], rows[1:]
        if "epoch" not in header:
            return
        ei = header.index("epoch")
        kept = [r for r in body if r and float(r[ei]) <= start_epoch]
        with open(self.path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerows(kept)
        self._header = header

    def append(self, row: Dict[str, float]) -> None:
        if self._header is None:
            extras = [k for k in row if k not in HEADER_ORDER]
            self._header = HEADER_ORDER + sorted(extras)
            write_header = not self.path.exists()
        else:
            write_header = False
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._header, extrasaction="ignore")
            if write_header:
                w.writeheader()
            w.writerow({k: row.get(k) for k in self._header})


def loss_items_to_row(prefix: str, items) -> Dict[str, float]:
    """The 10 loss items (box, cls, dfl, six seg terms, seg total) -> the
    ``train/`` or ``val/`` columns."""
    v = np.asarray(items, dtype=np.float64)
    box, cls_, dfl = v[0], v[1], v[2]
    row = {
        f"{prefix}/det/total": float(box + cls_ + dfl),
        f"{prefix}/det/box": float(box),
        f"{prefix}/det/dfl": float(dfl),
        f"{prefix}/det/cls": float(cls_),
        f"{prefix}/seg/total": float(v[9]),
    }
    for k, x in zip(SEG_KEYS, v[3:9]):
        row[f"{prefix}/seg/{k}"] = float(x)
    return row
