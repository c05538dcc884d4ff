"""``python -m mga_yolo_tpu_torch.tools.train --cfg config.yaml [--key value ...]``

Baseline trainer: plain YOLOv8 detection, no MGA components (counterpart of
``tools/cli/train.py``, the reference's BaseFMTrainer path). The same
arguments as ``cli.train`` and the same trainer; ``model`` defaults to the
MGA-free graph ``configs/models/yolov8.yaml``, ``task`` to ``detect``, and
the segmentation loss is always off (``enabled: false``). The run is on CUDA
unless ``--device cpu`` (or ``cuda:N``).
"""

from __future__ import annotations

import argparse
import sys

BASE_MODEL = "configs/models/yolov8.yaml"


def main(argv=None):
    """Run the baseline training; returns the final evaluation's ``ValResult``."""
    from mga_yolo_tpu_torch.cli import train as cli_train

    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser("base-train")
    p.add_argument("--cfg", default=None)
    args, rest = p.parse_known_args(argv)
    overrides = cli_train.parse_overrides(rest)
    overrides.setdefault("model", BASE_MODEL)
    overrides["enabled"] = False  # seg loss off (detection-only baseline)
    overrides.setdefault("task", "detect")
    return cli_train.run(args.cfg, overrides)


if __name__ == "__main__":
    main()
