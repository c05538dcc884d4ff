"""``python -m mga_yolo_tpu_torch.cli.profile --model configs/models/yolov8_cbam.yaml [--imgsz 640] [--yaml out.yaml]``

Counterpart of ``mga_yolo_tpu/cli/profile.py``: the per-layer parameters /
FLOPs / output-shape table of a model graph (``utils/layer_profile.py``),
computed on fake tensors, so no device is needed; ``--yaml`` also writes the
rows (``{"layers": [row, ...]}``) with the port's YAML writer.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> list[dict]:
    """Print the table; returns the rows."""
    p = argparse.ArgumentParser("mga-profile")
    p.add_argument("--model", default="configs/models/yolov8_cbam.yaml")
    p.add_argument("--scale", default="n")
    p.add_argument("--nc", type=int, default=1)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--yaml", default=None, help="also write rows to this YAML file")
    args = p.parse_args(argv)

    from mga_yolo_tpu_torch.graph import parse_graph
    from mga_yolo_tpu_torch.utils import yaml_lite
    from mga_yolo_tpu_torch.utils.layer_profile import format_table, profile_layers

    rows = profile_layers(parse_graph(args.model, scale=args.scale, nc=args.nc), args.imgsz)
    print(format_table(rows))
    if args.yaml:
        yaml_lite.dump({"layers": rows}, args.yaml)
        print(f"[mga-profile] wrote {args.yaml}")
    return rows


if __name__ == "__main__":
    main()
