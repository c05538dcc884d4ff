"""``python -m mga_yolo_tpu_torch.tools.val --weights best.pt --data data.yaml [--save-fm]``

Baseline validator with feature-map capture (counterpart of
``tools/cli/val.py``, the reference's BaseFMValidator): detection metrics
of a plain (no-MGA) checkpoint, written to ``metrics.json``, plus, with
``--save-fm``, the tapped layers of the first ``--save-fm-max`` batches.
The default layers 15/18/21 are the P3/P4/P5 neck outputs of the base
graph (``BASE_FM_LAYERS`` and ``BASE_FM_MAX`` in the environment set the
defaults, as in the reference). Each tap is saved as
``fm/batch{b}_layer{idx}.npy`` in the JAX package's NHWC layout, with its
channel grid as PNG where matplotlib imports, and the first four images
get their detections (conf 0.25, at most 50) drawn as
``preds/batch{b}_img{i}_dets.jpg`` (JPEG, as the JAX tool writes them).

The forward runs in float32 on ``image / 255``; each image's detections
come from the host NMS (``nms_numpy``), as in the JAX tool. The run is on
CUDA unless ``--device cpu`` (or ``cuda:N``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def parse_args(argv=None) -> argparse.Namespace:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser("base-val")
    p.add_argument("--weights", required=True, help="checkpoint .pt (weights/best.pt)")
    p.add_argument("--data", required=True, help="data YAML")
    p.add_argument("--imgsz", type=int, default=None)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--conf", type=float, default=0.001)
    p.add_argument("--iou", type=float, default=0.7)
    p.add_argument("--split", default="val")
    p.add_argument("--save-fm", action="store_true", help="capture feature maps")
    p.add_argument("--save-layers", default=os.environ.get("BASE_FM_LAYERS", "15,18,21"),
                   help="comma-separated layer indices to capture")
    p.add_argument("--save-fm-max", type=int, default=int(os.environ.get("BASE_FM_MAX", "4")),
                   help="max batches to capture")
    p.add_argument("--out", default="runs/base_val")
    p.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    return p.parse_args(argv)


def main(argv=None) -> Path:
    """Validate; returns the output directory (``metrics.json``, ``fm/``, ``preds/``)."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.data.dataset import MGADataset
    from mga_yolo_tpu_torch.data.loader import DataLoader
    from mga_yolo_tpu_torch.device import resolve_device
    from mga_yolo_tpu_torch.ops.nms import nms_numpy
    from mga_yolo_tpu_torch.train.state import normalize_images
    from mga_yolo_tpu_torch.train.validator import FM_WAIT, _nhwc, draw_boxes
    from mga_yolo_tpu_torch.utils import plotting
    from mga_yolo_tpu_torch.utils.checkpoint import rebuild_from_checkpoint
    from mga_yolo_tpu_torch.utils.files import increment_path
    from mga_yolo_tpu_torch.utils.metrics import MetricAccumulator

    device = resolve_device(args.device)
    layers = tuple(int(x) for x in str(args.save_layers).split(",") if x.strip())
    model, meta = rebuild_from_checkpoint(args.weights, tap_indices=layers if args.save_fm else (), device=device)
    imgsz = args.imgsz or int(meta.get("imgsz", 640))
    cfg = load_config({"data": args.data, "imgsz": imgsz, "batch": args.batch})
    ds = MGADataset(cfg, args.split, augment=False)
    dl = DataLoader(ds, batch_size=min(args.batch, len(ds)), shuffle=False, drop_last=False, device=device)
    out_dir = increment_path(Path(args.out))
    fm_dir = out_dir / "fm"
    pred_dir = out_dir / "preds"
    draw = plotting.available()

    acc = MetricAccumulator()
    saved = 0
    for bi, batch in enumerate(dl):
        with torch.no_grad():
            out = model(normalize_images(dl.to_device({"image": batch["image"]})["image"]))
        decoded = out["det"][0].float().cpu().numpy()
        for i in range(decoded.shape[0]):
            dets = nms_numpy(decoded[i], args.conf, args.iou)
            n = int(batch["mask_gt"][i].sum())
            acc.update(dets[:, :4], dets[:, 4], dets[:, 5], batch["gt_boxes"][i, :n],
                       batch["gt_labels"][i, :n].astype(np.float32))
        if args.save_fm and saved < args.save_fm_max:
            fm_dir.mkdir(parents=True, exist_ok=True)
            pred_dir.mkdir(parents=True, exist_ok=True)
            for idx, feat in out["taps"].items():
                arr = _nhwc(feat)
                np.save(fm_dir / f"batch{bi}_layer{idx}.npy", arr)
                if draw:
                    plotting.feature_visualization(arr[0], fm_dir / f"batch{bi}_layer{idx}.png")
            if bi == 0 and not draw:
                print(FM_WAIT)
            # prediction overlays (the reference saves the predictions, no masks)
            for i in range(min(decoded.shape[0], 4)):
                dets = nms_numpy(decoded[i], 0.25, args.iou, max_det=50)
                image_io.imwrite(pred_dir / f"batch{bi}_img{i}_dets.jpg", draw_boxes(batch["image"][i], dets))
            saved += 1

    m = acc.compute()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "metrics.json").write_text(json.dumps(m.results_dict(), indent=2))
    print(json.dumps(m.results_dict(), indent=2))
    return out_dir


if __name__ == "__main__":
    main()
