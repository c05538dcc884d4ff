"""``python -m mga_yolo_tpu_torch.cli.val --weights best.pt --data data.yaml``

Counterpart of ``mga_yolo_tpu/cli/val.py`` (the reference's ``yolo val``):
validates a checkpoint (the trainer's ``weights/*.pt`` or a reference-format
``export-torch`` file) on a dataset split, in float32 with a zero loss, and
prints the per-class table, the speed dict and the metrics. ``--plots``
saves the confusion matrix and curve arrays, ``--save-json`` COCO
predictions; with an output directory, metrics.json records the metrics and
the speed. The run is on CUDA unless ``--device cpu`` (or ``cuda:N``).
Exported ``.tflite`` files and SavedModels wait for the export
(``ROADMAP.md`` section 1, item 12).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser("mga-val")
    p.add_argument("--weights", required=True, help="checkpoint .pt (weights/best.pt) or an export-torch file")
    p.add_argument("--data", required=True, help="data YAML")
    p.add_argument("--imgsz", type=int, default=None)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--conf", type=float, default=0.001)
    p.add_argument("--iou", type=float, default=0.7)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--split", default="val")
    p.add_argument("--rect", action="store_true", help="rectangular batching (static aspect buckets)")
    p.add_argument("--plots", action="store_true", help="save the confusion matrix and curve arrays")
    p.add_argument("--save-json", action="store_true", help="save COCO-format predictions.json")
    p.add_argument("--out", default=None, help="output dir (default: runs/val)")
    p.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    return p.parse_args(argv)


def build_validator(args: argparse.Namespace):
    """A ``Validator`` over the split's loader whose ``eval_fn`` runs the
    checkpoint's float32 model and the device NMS."""
    weights = Path(args.weights)
    if weights.suffix == ".tflite" or (weights / "saved_model.pb").is_file():
        raise NotImplementedError(f"{weights}: validating exported TFLite / SavedModel files waits for the "
                                  "export (ROADMAP.md section 1, item 12); pass a .pt checkpoint")

    import torch

    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.data.dataset import MGADataset
    from mga_yolo_tpu_torch.data.loader import DataLoader
    from mga_yolo_tpu_torch.device import resolve_device
    from mga_yolo_tpu_torch.ops.nms import nms
    from mga_yolo_tpu_torch.train.state import normalize_images
    from mga_yolo_tpu_torch.train.validator import Validator
    from mga_yolo_tpu_torch.utils.checkpoint import rebuild_from_checkpoint

    device = resolve_device(args.device)
    model, meta = rebuild_from_checkpoint(weights, device=device)
    imgsz = args.imgsz or int(meta.get("imgsz", 640))
    nc = model.spec.nc
    cfg = load_config({"data": args.data, "imgsz": imgsz, "batch": args.batch, "rect": args.rect})
    ds = MGADataset(cfg, args.split, augment=False)
    dl = DataLoader(ds, batch_size=min(args.batch, len(ds)), shuffle=False, drop_last=False, device=device)

    @torch.no_grad()
    def eval_fn(_, batch):
        out = model(normalize_images(batch["image"]))
        decoded = out["det"][0].float()
        boxes, scores, cls = nms(decoded, conf_thres=args.conf, iou_thres=args.iou, max_det=args.max_det,
                                 multi_label=nc > 1)
        return {"decoded": decoded, "seg": out["seg"], "items": torch.zeros(10),
                "dets": torch.cat([boxes, scores[..., None], cls[..., None]], -1)}

    return Validator(eval_fn, dl, cfg, iou_thres=args.iou)


def main(argv=None):
    """Validate; returns the ``ValResult``."""
    from mga_yolo_tpu_torch.utils.files import increment_path

    args = parse_args(argv)
    validator = build_validator(args)
    out_dir = None
    if args.out or args.plots or args.save_json:
        out_dir = increment_path(Path(args.out) if args.out else Path("runs") / "val")
        out_dir.mkdir(parents=True, exist_ok=True)
    result = validator(None, plots_dir=out_dir if args.plots else None,
                       save_json=(out_dir / "predictions.json") if args.save_json else None, verbose=True)
    speed_str = ", ".join(f"{k} {v:.1f}ms" for k, v in result.speed.items())
    print(f"speed: {speed_str} per image")
    print(json.dumps(result.results_dict(), indent=2))
    if out_dir is not None:
        with open(out_dir / "metrics.json", "w") as f:
            json.dump({**result.results_dict(), "speed": result.speed}, f, indent=2)
        print(f"[mga-val] metrics -> {out_dir / 'metrics.json'}")
    return result


if __name__ == "__main__":
    main()
