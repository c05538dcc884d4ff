"""``python -m mga_yolo_tpu_torch.cli.predict --weights best.pt --source images/``

Counterpart of ``mga_yolo_tpu/cli/predict.py`` (the reference's predict
surface with ``--save-feature-maps``): per image ``{stem}_pred.jpg`` (the
boxes and labels drawn on it, a JPEG as the JAX package writes it),
``{stem}_mask_{p3,p4,p5}.png`` (the sigmoid masks times 255) and, with
``--save-feature-maps``, ``{stem}_masks.npz``. Per video source one
annotated video, ``{stem}_pred.avi`` (MJPG) for an ``.avi`` source and
``{stem}_pred.mp4`` (mp4v) for any other, at the source's fps; with
``--save-frame-masks`` (or ``--save-feature-maps``) each frame's masks as
``{stem}_f{index:05d}_mask_*.png`` (and ``_masks.npz``). ``--max-frames``
caps the frames taken per video. Sources are PNG, JPEG, BMP, TIFF or WebP images and
AVI / MP4 / MOV videos (``data/image_io.py``, ``data/video_io.py``). Stems
are made unique across a recursive directory (``a/x.png``, ``b/x.png`` ->
``x``, ``x_2``). The run is on CUDA unless ``--device cpu`` (or
``cuda:N``). ``--use-pallas`` (the JAX package's kernel switch) is accepted
and changes nothing. ``--weights`` may be an exported ``.tflite`` file or
SavedModel directory (``train.predictor.TFLitePredictor``: TensorFlow on the
host; an ImportError naming it where TensorFlow does not import).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> dict:
    """Predict and write the files; returns {"images": n, "frames": m, "out": out_dir}."""
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser("mga-predict")
    p.add_argument("--weights", required=True, help="checkpoint .pt, an exported .tflite or a SavedModel directory")
    p.add_argument("--source", required=True,
                   help="image or video file, directory, or glob (PNG, JPEG, BMP, TIFF, WebP; AVI, MP4, MOV)")
    p.add_argument("--imgsz", type=int, default=None)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--out", default="runs/predict")
    p.add_argument("--save-feature-maps", action="store_true")
    p.add_argument("--fuse", action="store_true", help="fold BN into convs before inference")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--use-pallas", default="auto", choices=["auto", "true", "false"],
                   help="the JAX package's kernel switch; accepted, changes nothing")
    p.add_argument("--max-frames", type=int, default=0, help="cap frames taken per video source (0 = all)")
    p.add_argument("--save-frame-masks", action="store_true", help="also save per-frame mask PNGs for video sources")
    p.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)

    import numpy as np

    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.data.sources import VideoSink
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

    sinks: dict[str, VideoSink] = {}  # one annotated-video writer per source video

    def save_masks(tag: str, r) -> None:
        for sk, m in r.mga_masks.items():
            image_io.imwrite(out_dir / f"{tag}_mask_{sk}.png", (m * 255).astype(np.uint8))

    n_img = n_frames = 0
    try:
        for frame, r in pred.stream(args.source, batch_size=args.batch, max_frames=args.max_frames):
            annotated = r.plot(img=frame.img.copy())
            if frame.is_video:
                sink = sinks.get(frame.path)
                if sink is None:
                    suffix = ".avi" if frame.path.lower().endswith(".avi") else ".mp4"
                    sink = sinks[frame.path] = VideoSink(out_dir / f"{unique_stem(frame)}_pred{suffix}", fps=frame.fps)
                sink.write(annotated)
                n_frames += 1
                tag = f"{unique_stem(frame)}_f{frame.index:05d}"
                if args.save_frame_masks:
                    save_masks(tag, r)
                if args.save_feature_maps:
                    np.savez(out_dir / f"{tag}_masks.npz", **r.mga_masks)
            else:
                stem = unique_stem(frame)
                image_io.imwrite(out_dir / f"{stem}_pred.jpg", annotated)
                save_masks(stem, r)
                if args.save_feature_maps:
                    np.savez(out_dir / f"{stem}_masks.npz", **r.mga_masks)
                n_img += 1
                print(f"{Path(frame.path).name}: {len(r)} detections")
    finally:
        for sink in sinks.values():
            sink.close()
    for path, sink in sinks.items():
        print(f"{Path(path).name}: {sink.frames_written} frames -> {sink.out_path.name}")
    print(f"[mga-predict] {n_img} images, {n_frames} video frames -> {out_dir}")
    return {"images": n_img, "frames": n_frames, "out": out_dir}


if __name__ == "__main__":
    main()
