"""Run directories (counterpart of ``mga_yolo_tpu/utils/files.py``).

A second run named ``train`` lands in ``train2``, then ``train3`` ...,
unless ``exist_ok`` (reuse) or ``resume`` (continue in place) is set, as the
reference's ``increment_path`` / ``get_save_dir`` do.
"""

from __future__ import annotations

from pathlib import Path


def increment_path(path: str | Path, exist_ok: bool = False, sep: str = "") -> Path:
    """``path`` unchanged if free (or ``exist_ok``), else ``path{sep}2`` ..."""
    path = Path(path)
    if exist_ok or not path.exists():
        return path
    for n in range(2, 9999):
        cand = Path(f"{path}{sep}{n}")
        if not cand.exists():
            return cand
    raise RuntimeError(f"could not find a free run dir for {path}")


def resolve_save_dir(project: str | Path, name: str, exist_ok: bool = False,
                     resume: bool = False) -> Path:
    """The run directory: ``resume`` continues in ``project/name`` itself."""
    base = Path(project) / name
    if resume:
        return base
    return increment_path(base, exist_ok=exist_ok)
