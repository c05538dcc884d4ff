"""``python -m mga_yolo_tpu_torch.cli.serve --weights best.pt [--port 8008]``

Counterpart of ``mga_yolo_tpu/cli/serve.py``: ``serve.build_server`` on a
checkpoint (the trainer's ``.pt`` or an ``export-torch`` file), then the
HTTP server until interrupted (``POST /predict`` with PNG, JPEG,
BMP, TIFF or WebP bytes). The last
line printed before serving names the bound port, so ``--port 0`` (any
free port) can be used. The run is on CUDA unless ``--device cpu`` (or
``cuda:N``); ``--use-pallas`` is accepted and changes nothing.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser("mga-serve")
    p.add_argument("--weights", required=True)
    p.add_argument("--imgsz", type=int, default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--masks", action="store_true", help="serve sigmoid masks too")
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--use-pallas", default="auto", choices=["auto", "true", "false"],
                   help="the JAX package's kernel switch; accepted, changes nothing")
    p.add_argument("--device", default=None, help="cuda (default), cuda:N or cpu")
    args = p.parse_args(argv)

    from mga_yolo_tpu_torch.serve import build_server

    server = build_server(args.weights, imgsz=args.imgsz, batch=args.batch, conf=args.conf, iou=args.iou,
                          max_det=args.max_det, port=args.port, host=args.host, with_masks=args.masks,
                          max_wait_ms=args.max_wait_ms, device=args.device)
    print(f"[mga-serve] listening on http://{args.host}:{server.port}", flush=True)
    try:
        server.httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
