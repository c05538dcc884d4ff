"""``python -m mga_yolo_tpu_torch.cli.ckpt {load,export-torch,...} PATH``

Counterpart of ``mga_yolo_tpu/cli/ckpt.py`` (the reference's ``mga-ckpt``):

* ``load PATH``: rebuild the model from a checkpoint (the trainer's ``.pt``
  or a reference-format file) and print the model, nc / imgsz, the
  parameter count and sample state_dict keys.
* ``export-torch PATH OUT``: write the reference's minimal checkpoint,
  ``{"ema_state_dict": sd, "train_args": {"nc", "model", "model_scale"}}``
  (``model_scale`` added so a scale other than the YAML's first serves
  as it is). The port's state_dict already has the reference's keys: no
  mapping. ``serve.build_server`` and ``cli.val`` read the file.
* ``export-tflite PATH [--out F.tflite] [--quantize fp16|dynamic|int8]``
  and ``export-savedmodel PATH OUT``: the eval forward as a TFLite
  flatbuffer or a TF SavedModel (``export/tflite.py``), checked against the
  port's float32 forward unless ``--no-verify``. They need TensorFlow, and
  raise an ImportError naming it where it does not import (the card's
  host); the export rebuilds the model on the CPU, and ``--device`` is not
  used.

``load`` and ``export-torch`` rebuild the model on CUDA unless ``--device
cpu`` (or ``cuda:N``).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> dict:
    """Run the subcommand; returns what it reported."""
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser("mga-ckpt")
    sub = p.add_subparsers(dest="cmd", required=True)
    load = sub.add_parser("load", help="rebuild model from checkpoint and report")
    load.add_argument("path")
    exp = sub.add_parser("export-torch", help="export to the torch reference's minimal .pt checkpoint")
    exp.add_argument("path")
    exp.add_argument("out", help="output .pt path")
    tfl = sub.add_parser("export-tflite", help="TFLite export of the eval forward (decoded head + mask logits; "
                                               "NMS outside, as the reference's TFLite export)")
    tfl.add_argument("path")
    tfl.add_argument("--out", default=None)
    tfl.add_argument("--imgsz", type=int, default=None)
    tfl.add_argument("--batch", type=int, default=1)
    tfl.add_argument("--quantize", choices=["fp16", "dynamic", "int8"], default=None)
    tfl.add_argument("--calib", default=None, help="int8 calibration images (directory of PNGs), e.g. the val set")
    tfl.add_argument("--no-verify", action="store_true")
    svm = sub.add_parser("export-savedmodel", help="TF SavedModel export of the eval forward (TF-Serving)")
    svm.add_argument("path")
    svm.add_argument("out")
    svm.add_argument("--imgsz", type=int, default=None)
    svm.add_argument("--batch", type=int, default=1)
    svm.add_argument("--no-verify", action="store_true")
    for sp in (load, exp, tfl, svm):
        sp.add_argument("--model", default=None, help="model YAML override")
        sp.add_argument("--scale", default=None)
        sp.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)

    if args.cmd == "export-savedmodel":
        from mga_yolo_tpu_torch.export.tflite import export_saved_model

        info = export_saved_model(args.path, args.out, imgsz=args.imgsz, batch=args.batch, model_yaml=args.model,
                                  scale=args.scale, verify=not args.no_verify)
        print(f"[mga-ckpt] SavedModel -> {info['path']} (imgsz {info['imgsz']})")
        _print_verified(info)
        return info
    if args.cmd == "export-tflite":
        from mga_yolo_tpu_torch.export.tflite import export_tflite

        info = export_tflite(args.path, args.out, imgsz=args.imgsz, batch=args.batch, model_yaml=args.model,
                             scale=args.scale, quantize=args.quantize, verify=not args.no_verify,
                             representative=args.calib)
        print(f"[mga-ckpt] tflite -> {info['path']} ({info['bytes'] / 1e6:.2f} MB, imgsz {info['imgsz']}, "
              f"quantize {info['quantize']})")
        _print_verified(info)
        return info

    import torch

    from mga_yolo_tpu_torch.utils.checkpoint import rebuild_from_checkpoint

    net, meta = rebuild_from_checkpoint(args.path, args.model, args.scale, device=args.device)
    spec = net.spec
    if args.cmd == "export-torch":
        sd = {k: v.detach().to("cpu", copy=True) for k, v in net.state_dict().items()}
        train_args = {"nc": int(spec.nc), "model": meta.get("model_yaml") or args.model, "model_scale": spec.scale}
        torch.save({"ema_state_dict": sd, "train_args": train_args}, str(args.out))
        print(f"[mga-ckpt] exported {len(sd)} tensors -> {args.out} (reference minimal-ckpt format, EMA weights)")
        return {"tensors": len(sd), "out": args.out}
    n_params = sum(p.numel() for p in net.parameters())
    keys = list(net.state_dict())
    print(f"model:  {meta.get('model_yaml')} scale={spec.scale}")
    print(f"nc:     {spec.nc}  imgsz: {meta.get('imgsz')}")
    print(f"params: {n_params / 1e6:.3f} M ({len(list(net.parameters()))} tensors)")
    print(f"keys:   {keys[:5]} ... {keys[-3:]}")
    return {"params": n_params, "nc": spec.nc, "scale": spec.scale, "imgsz": meta.get("imgsz")}


def _print_verified(info: dict) -> None:
    if info["max_abs_diff_decoded"] is not None:
        print(f"[mga-ckpt] verified vs the port's forward: outputs {info['outputs']}, "
              f"max |d| decoded = {info['max_abs_diff_decoded']:.2e}")


if __name__ == "__main__":
    main()
