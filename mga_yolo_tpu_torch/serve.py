"""Serving: micro-batched inference on the card + a threaded HTTP server.

Counterpart of ``mga_yolo_tpu/serve.py``. One fixed batch size: short
batches are padded with their last image and the padded rows dropped on the
host. The forward, the DFL decode and the NMS (suppression kernel included)
run on the device; the host letterboxes and rescales boxes.

Threading: one dispatcher thread launches batches and a completion thread
fetches results. The dispatcher enqueues the forward, NMS and the
non-blocking device-to-host copies on the current stream and records a
``torch.cuda.Event`` after them; the completion thread waits on that event
only, so up to ``depth`` batches are in flight and the dispatcher never
waits for the device.
"""

from __future__ import annotations

import base64
import copy
import dataclasses
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from mga_yolo_tpu_torch.data.image_io import encode_png, imdecode
from mga_yolo_tpu_torch.data.transforms import letterbox, scale_boxes
from mga_yolo_tpu_torch.ops.nms import nms
from mga_yolo_tpu_torch.utils.model_utils import fuse_model

MAX_UPLOAD_BYTES = 32 * 1024 * 1024


@dataclasses.dataclass
class Prediction:
    boxes: np.ndarray                 # (N, 6) [x1,y1,x2,y2,conf,cls] original coords
    orig_shape: tuple[int, int]
    masks: Optional[Dict[str, np.ndarray]] = None  # sigmoid probs per scale
    latency_ms: float = 0.0


class InferenceEngine:
    """Fixed-batch eval forward + device NMS for a model on its device.

    ``model`` is an ``MGAModel`` with its weights loaded; the engine works on
    a copy (BN-folded when ``fuse``), cast to ``dtype``: bfloat16 on CUDA and
    float32 on the CPU unless given.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        imgsz: int = 640,
        batch: int = 8,
        conf: float = 0.25,
        iou: float = 0.45,
        max_det: int = 300,
        dtype: torch.dtype | None = None,
        fuse: bool = True,
        with_masks: bool = False,
    ):
        self.device = next(model.parameters()).device
        model = copy.deepcopy(model).eval()
        if fuse:
            fuse_model(model)
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype
        self.model = model.to(dtype)
        self.imgsz, self.batch = imgsz, batch
        self.conf, self.iou, self.max_det = conf, iou, max_det
        self.with_masks = with_masks

    def forward(self, x_u8: torch.Tensor):
        """(B, H, W, 3) uint8 on the device -> (dets (B, max_det, 6), seg probs)."""
        with torch.inference_mode():
            x = x_u8.permute(0, 3, 1, 2).contiguous().to(self.dtype) / 255
            out = self.model(x)
            decoded = out["det"][0].float()
            boxes, scores, cls = nms(decoded, conf_thres=self.conf, iou_thres=self.iou,
                                     max_det=self.max_det)
            dets = torch.cat([boxes, scores[..., None], cls[..., None]], -1)
            seg = {k: torch.sigmoid(s.float()) for k, s in out["seg"].items()} if self.with_masks else {}
        return dets, seg

    def warmup(self) -> float:
        """Run one batch (building the kernels on first use); returns wall seconds."""
        t0 = time.perf_counter()
        x = np.zeros((self.imgsz, self.imgsz, 3), np.uint8)
        self.finalize_batch(self.dispatch_batch([x]), [])
        return time.perf_counter() - t0

    def preprocess(self, img: np.ndarray):
        lb, ratio_pad = letterbox(img, self.imgsz, scaleup=False)
        return lb, (img.shape[:2], ratio_pad)

    def dispatch_batch(self, imgs: List[np.ndarray]):
        """Enqueue one device batch and its copy back to the host; returns handles."""
        n = len(imgs)
        if n < self.batch:
            imgs = imgs + [imgs[-1]] * (self.batch - n)
        x = torch.from_numpy(np.stack(imgs))
        t0 = time.perf_counter()
        dets, seg = self.forward(x.to(self.device, non_blocking=True))
        dets = dets.to("cpu", non_blocking=True)
        seg = {k: v.to("cpu", non_blocking=True) for k, v in seg.items()}
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return dets, seg, done, t0

    def finalize_batch(self, handles, metas: List) -> List[Prediction]:
        """Wait for one batch's results and rescale them per request."""
        dets, seg, done, t0 = handles
        if done is not None:
            done.synchronize()
        dets = dets.numpy()
        seg_np = {k: v.numpy() for k, v in seg.items()}
        dt = (time.perf_counter() - t0) * 1e3
        out = []
        for i, (orig_shape, ratio_pad) in enumerate(metas):
            d = dets[i]
            boxes = d[d[:, 4] > 0].copy()  # drop empty slots (zero score)
            if len(boxes):
                boxes[:, :4] = scale_boxes(boxes[:, :4], ratio_pad, orig_shape)
            # a model without mask heads (plain YOLOv8) has no masks to return
            masks = {k: seg_np[k][i, 0] for k in seg_np} if self.with_masks and seg_np else None
            out.append(Prediction(boxes, orig_shape, masks, dt))
        return out

    def infer_batch(self, imgs: List[np.ndarray], metas: List) -> List[Prediction]:
        """imgs: letterboxed uint8 HWC arrays (<= batch). Returns per-image preds."""
        return self.finalize_batch(self.dispatch_batch(imgs), metas)


class _Request:
    __slots__ = ("img", "meta", "event", "result")

    def __init__(self, img, meta):
        self.img, self.meta = img, meta
        self.event = threading.Event()
        self.result: Optional[Prediction] = None


class MicroBatcher:
    """Coalesce concurrent requests into fixed-size device batches.

    A request waits at most ``max_wait_ms`` for its batch to fill; a full
    batch goes at once. At most ``depth`` batches are in flight.
    """

    def __init__(self, engine: InferenceEngine, max_wait_ms: float = 5.0, depth: int = 4):
        self.engine = engine
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._inflight: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._completer = threading.Thread(target=self._complete_loop, daemon=True)
        self._lock = threading.Lock()
        self.n_requests = 0
        self.n_batches = 0
        self._latencies: List[float] = []
        self._dispatcher.start()
        self._completer.start()

    def _dispatch_loop(self) -> None:
        B = self.engine.batch
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < B:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            try:
                handles = self.engine.dispatch_batch([r.img for r in batch])
            except Exception as e:  # propagate to all waiters
                for r in batch:
                    r.result = e
                    r.event.set()
                continue
            self._inflight.put((handles, batch))  # blocks at `depth` in flight

    def _complete_loop(self) -> None:
        while not self._stop.is_set() or not self._inflight.empty():
            try:
                handles, batch = self._inflight.get(timeout=0.1)
            except queue.Empty:
                continue
            t0 = handles[-1]
            try:
                preds = self.engine.finalize_batch(handles, [r.meta for r in batch])
            except Exception as e:
                for r in batch:
                    r.result = e
                    r.event.set()
                continue
            dt = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self.n_batches += 1
                self._latencies.append(dt)
                if len(self._latencies) > 10_000:
                    del self._latencies[:5_000]
            for r, p in zip(batch, preds):
                r.result = p
                r.event.set()

    def submit(self, img: np.ndarray, timeout: float = 30.0) -> Prediction:
        lb, meta = self.engine.preprocess(img)
        req = _Request(lb, meta)
        with self._lock:
            self.n_requests += 1
        self._q.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if isinstance(req.result, Exception):
            raise req.result
        return req.result

    def stats(self) -> dict:
        with self._lock:
            lat = np.asarray(self._latencies[-1000:], np.float64)
            n_req, n_b = self.n_requests, self.n_batches
        out = {"requests": n_req, "batches": n_b,
               "avg_batch_fill": round(n_req / n_b, 2) if n_b else None}
        if len(lat):
            out.update(
                batch_ms_p50=round(float(np.percentile(lat, 50)), 2),
                batch_ms_p99=round(float(np.percentile(lat, 99)), 2),
            )
        return out

    def close(self) -> None:
        self._stop.set()
        self._dispatcher.join(timeout=2)
        self._completer.join(timeout=5)


def _json_prediction(p: Prediction, want_masks: bool) -> dict:
    out = {
        "boxes": [
            {"x1": float(b[0]), "y1": float(b[1]), "x2": float(b[2]),
             "y2": float(b[3]), "conf": float(b[4]), "cls": int(b[5])}
            for b in p.boxes
        ],
        "orig_shape": list(p.orig_shape),
        "batch_ms": round(p.latency_ms, 2),
    }
    if want_masks and p.masks is not None:
        out["mga_masks_png"] = {k: base64.b64encode(encode_png((m * 255).astype(np.uint8))).decode()
                                for k, m in p.masks.items()}
    return out


class MGAServer:
    """Threaded HTTP server over a MicroBatcher.

    Endpoints:
      POST /predict        PNG image bytes -> detections JSON (another format: 400)
                           (?masks=1 adds base64-PNG sigmoid masks)
      GET  /healthz        200 once warm
      GET  /stats          micro-batcher statistics
    """

    def __init__(self, batcher: MicroBatcher, host: str = "127.0.0.1", port: int = 8008):
        self.batcher = batcher
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/healthz"):
                    self._send(200, {"status": "ok"})
                elif self.path.startswith("/stats"):
                    self._send(200, outer.batcher.stats())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if not self.path.startswith("/predict"):
                    self._send(404, {"error": "not found"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_UPLOAD_BYTES:
                    self._send(413, {"error": f"payload too large (max {MAX_UPLOAD_BYTES} bytes)"})
                    return
                raw = self.rfile.read(n)
                try:
                    img = imdecode(raw, "upload")
                except ValueError as e:
                    self._send(400, {"error": f"could not decode image: {e}"})
                    return
                t0 = time.perf_counter()
                try:
                    pred = outer.batcher.submit(img)
                except TimeoutError:
                    self._send(503, {"error": "timeout"})
                    return
                except Exception as e:  # engine/device failure: JSON 500
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                want_masks = "masks=1" in (self.path.partition("?")[2] or "")
                payload = _json_prediction(pred, want_masks)
                payload["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
                self._send(200, payload)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2)
        self.batcher.close()


def build_server(
    weights: str | Path,
    imgsz: int = 640,
    batch: int = 8,
    conf: float = 0.25,
    iou: float = 0.45,
    max_det: int = 300,
    port: int = 8008,
    host: str = "127.0.0.1",
    with_masks: bool = False,
    max_wait_ms: float = 5.0,
    model: str | Path | dict | None = None,
    scale: str | None = None,
    device: str | torch.device | None = None,
) -> MGAServer:
    """Serve a checkpoint: the trainer's ``weights/best.pt`` (or ``last.pt``)
    or a reference-format file (what ``mga-ckpt export-torch`` writes), as
    they are: ``ema_state_dict`` (else ``model_state_dict``) + ``train_args``.

    The graph comes from ``model`` if given, else from the checkpoint
    (``utils.checkpoint.model_config``: its metadata's YAML, else
    ``train_args["model"]``, else the flagship config); a file that exists is
    read by the port's own YAML reader, and an absent path naming a shipped
    config (``yolov8``, ``yolov8_cbam``, ``yolov8_eca``, ``yolov8_spade``)
    gives its dict (``graph.parse_graph``). The scale is ``scale`` if given,
    else ``train_args["model_scale"]``, else ``train_args["scale"]``.
    ``device`` defaults to CUDA.
    """
    from mga_yolo_tpu_torch.utils.checkpoint import rebuild_from_checkpoint

    net, _ = rebuild_from_checkpoint(weights, model_yaml=model, scale=scale, device=device)
    engine = InferenceEngine(net, imgsz=imgsz, batch=batch, conf=conf, iou=iou,
                             max_det=max_det, with_masks=with_masks)
    warm_s = engine.warmup()
    print(f"[mga-serve] warmed {engine.batch}x{engine.imgsz}px on {engine.device} in {warm_s:.1f}s")
    return MGAServer(MicroBatcher(engine, max_wait_ms), host=host, port=port)
