"""``python -m mga_yolo_tpu_torch.cli.train --cfg config.yaml [--key value ...]``

Counterpart of ``mga_yolo_tpu/cli/train.py`` (the reference's ``mga-train``):
a training YAML plus ``--key value`` (or ``--key=value``) overrides, typed
as YAML values by the port's own reader (numbers, bools, lists), forwarded to
the trainer. The run is on CUDA unless ``--device cpu`` (or ``cuda:N``).
"""

from __future__ import annotations

import argparse
import sys
from typing import Any

from mga_yolo_tpu_torch.utils import yaml_lite


def parse_overrides(argv: list[str]) -> dict[str, Any]:
    """--key value pairs -> dict with YAML-typed values."""
    out: dict[str, Any] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise SystemExit(f"unexpected argument {tok!r}; overrides use --key value")
        key = tok[2:]
        if "=" in key:
            key, val = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise SystemExit(f"missing value for --{key}")
            val = argv[i + 1]
            i += 2
        out[key] = yaml_lite.loads(val)
    return out


def main(argv: list[str] | None = None):
    """Run the training; returns the final evaluation's ``ValResult``."""
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser("mga-train", add_help=True)
    parser.add_argument("--cfg", default=None, help="training YAML (the reference's schema)")
    args, rest = parser.parse_known_args(argv)
    overrides = parse_overrides(rest)

    from mga_yolo_tpu_torch.train.trainer import train

    return train(args.cfg, **overrides)


if __name__ == "__main__":
    main()
