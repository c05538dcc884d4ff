"""COCO-format prediction export (counterpart of ``mga_yolo_tpu/utils/coco.py``,
the reference's ``pred_to_json``)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np


def dets_to_coco(dets: np.ndarray, image_id: int | str,
                 class_map: Dict[int, int] | None = None) -> List[dict]:
    """(N, 6) [x1, y1, x2, y2, conf, cls] -> COCO result dicts (xywh boxes)."""
    out = []
    for x1, y1, x2, y2, conf, c in dets:
        cid = int(c)
        out.append({
            "image_id": image_id,
            "category_id": class_map.get(cid, cid) if class_map else cid,
            "bbox": [round(float(x1), 3), round(float(y1), 3),
                     round(float(x2 - x1), 3), round(float(y2 - y1), 3)],
            "score": round(float(conf), 5),
        })
    return out


class CocoWriter:
    """Collects the detections of a validation pass into ``path``."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.records: List[dict] = []

    def add(self, dets: np.ndarray, image_id: int | str, class_map=None) -> None:
        self.records.extend(dets_to_coco(dets, image_id, class_map))

    def save(self) -> Path:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self.records))
        return self.path
