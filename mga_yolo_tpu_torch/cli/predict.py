"""``python -m mga_yolo_tpu_torch.cli.predict --weights best.pt --source images/``

Counterpart of ``mga_yolo_tpu/cli/predict.py`` (the reference's predict
surface with ``--save-feature-maps``): per image ``{stem}_pred.jpg`` (the
boxes and labels drawn on it, a JPEG as the JAX package writes it),
``{stem}_mask_{p3,p4,p5}.png`` (the sigmoid masks times 255) and, with
``--save-feature-maps``, ``{stem}_masks.npz``. Sources are PNG, JPEG or BMP
files (``data/image_io.py``). Stems are made unique across a recursive directory
(``a/x.png``, ``b/x.png`` -> ``x``, ``x_2``). The run is on CUDA unless
``--device cpu`` (or ``cuda:N``). ``--use-pallas`` (the JAX package's
kernel switch) is accepted and changes nothing; video sources raise
``NotImplementedError`` (``data/sources.py``), so ``--max-frames`` and
``--save-frame-masks`` have nothing to act on. ``--weights`` may be an
exported ``.tflite`` file or SavedModel directory
(``train.predictor.TFLitePredictor``: TensorFlow on the host; an
ImportError naming it where TensorFlow does not import).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> dict:
    """Predict and write the files; returns {"images": n, "out": out_dir}."""
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser("mga-predict")
    p.add_argument("--weights", required=True, help="checkpoint .pt, an exported .tflite or a SavedModel directory")
    p.add_argument("--source", required=True, help="image file, directory, or glob (PNG, JPEG, BMP)")
    p.add_argument("--imgsz", type=int, default=None)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--out", default="runs/predict")
    p.add_argument("--save-feature-maps", action="store_true")
    p.add_argument("--fuse", action="store_true", help="fold BN into convs before inference")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--use-pallas", default="auto", choices=["auto", "true", "false"],
                   help="the JAX package's kernel switch; accepted, changes nothing")
    p.add_argument("--max-frames", type=int, default=0, help="frames per video source (video raises)")
    p.add_argument("--save-frame-masks", action="store_true", help="per-frame masks of video (video raises)")
    p.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)

    import numpy as np

    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.train.predictor import load_predictor

    pred = load_predictor(args.weights, imgsz=args.imgsz, conf=args.conf, iou=args.iou, fuse=args.fuse,
                          device=args.device)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    stems: dict[str, str] = {}
    used: set[str] = set()

    def unique_stem(frame) -> str:
        s = stems.get(frame.path)
        if s is None:
            s, n = frame.stem, 1
            while s in used:
                n += 1
                s = f"{frame.stem}_{n}"
            used.add(s)
            stems[frame.path] = s
        return s

    n_img = 0
    for frame, r in pred.stream(args.source, batch_size=args.batch, max_frames=args.max_frames):
        stem = unique_stem(frame)
        image_io.imwrite(out_dir / f"{stem}_pred.jpg", r.plot(img=frame.img.copy()))
        for sk, m in r.mga_masks.items():
            image_io.imwrite(out_dir / f"{stem}_mask_{sk}.png", (m * 255).astype(np.uint8))
        if args.save_feature_maps:
            np.savez(out_dir / f"{stem}_masks.npz", **r.mga_masks)
        n_img += 1
        print(f"{Path(frame.path).name}: {len(r)} detections")
    print(f"[mga-predict] {n_img} images, 0 video frames -> {out_dir}")
    return {"images": n_img, "out": out_dir}


if __name__ == "__main__":
    main()
