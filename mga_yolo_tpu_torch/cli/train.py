"""``python -m mga_yolo_tpu_torch.cli.train --cfg config.yaml [--key value ...]``

Counterpart of ``mga_yolo_tpu/cli/train.py`` (the reference's ``mga-train``):
a training YAML plus ``--key value`` (or ``--key=value``) overrides, typed
as YAML values by the port's own reader (numbers, bools, lists), forwarded to
the trainer. The run is on CUDA unless ``--device cpu`` (or ``cuda:N``).

Data-parallel under ``torchrun`` (the reference's DDP launch): with
``WORLD_SIZE`` > 1 in the environment and no process group yet, the CLI
initialises one from torchrun's variables, NCCL on the card and gloo with
``--device cpu``, and destroys it when the run ends::

    torchrun --nproc_per_node=N -m mga_yolo_tpu_torch.cli.train --cfg ... --batch 64

``--mesh_spatial k`` splits the N ranks into N / k data shards of k ranks,
each holding a band of ``imgsz / k`` rows of its shard's images (the JAX
package's DP x SP mesh; ``imgsz`` a multiple of 32 k)::

    torchrun --nproc_per_node=2 -m mga_yolo_tpu_torch.cli.train --cfg ... --mesh_spatial 2 --device cpu
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
    return run(args.cfg, parse_overrides(rest))


def run(cfg_path, overrides: dict[str, Any]):
    """Train from the YAML ``cfg_path`` (or None) and ``overrides``, in a
    process group from torchrun's variables where there are several ranks
    and none exists yet; returns the final evaluation's ``ValResult``."""
    import torch.distributed as dist

    from mga_yolo_tpu_torch import parallel
    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.train.trainer import train

    cfg = load_config(cfg_path, **overrides)
    own_group = parallel.init_from_env(cfg.train.device)
    try:
        return train(cfg)
    finally:
        if own_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
