"""Baseline grid runner: the grid orchestrator for plain YOLOv8 (counterpart
of ``tools/scripts/base_comparison.py``, the reference's
``tools/scripts/ultralytics_base_comparison.py``).

Reuses :mod:`.performance_comparison`'s scheduler with the base model graph
and the segmentation loss off; jobs are ``base_{scale}_fold{k}``. As in the
JAX tool it exits 0 even when a job fails (read each job's ``status``)::

    python -m mga_yolo_tpu_torch.scripts.base_comparison --exp exp.yaml
"""

from __future__ import annotations

import argparse
import itertools
import sys
from pathlib import Path

from mga_yolo_tpu_torch.scripts.performance_comparison import Job, prepare_config, schedule_loop
from mga_yolo_tpu_torch.utils import yaml_lite


def main(argv=None) -> list[Job]:
    """Run the baseline grid; returns the jobs."""
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser("base-grid")
    p.add_argument("--exp", required=True)
    args = p.parse_args(argv)

    exp = yaml_lite.load(args.exp)
    hyp = yaml_lite.load(exp["hyp"]) or {}
    hyp["enabled"] = False  # detection-only

    project = exp.get("project", "runs/base_grid")
    folds_root = exp.get("folds_root")
    cfg_dir = Path(project) / "_configs"
    jobs = []
    for scale, fold in itertools.product(exp.get("scales", ["n"]), exp.get("folds", [0])):
        name = f"base_{scale}_fold{fold}"
        data_yaml = str(Path(folds_root) / f"fold_{fold}" / "data.yaml") if folds_root else exp["data"]
        cfg_path = prepare_config(hyp, "", scale, data_yaml, project, name, cfg_dir)
        # base model graph instead of a variant graph
        cfg = yaml_lite.load(cfg_path)
        cfg["model"] = "configs/models/yolov8.yaml"
        yaml_lite.dump(cfg, cfg_path)
        jobs.append(Job("base", scale, fold, cfg_path, name))
    schedule_loop(jobs, slots=int(exp.get("slots", 1)))
    return jobs


if __name__ == "__main__":
    main()
