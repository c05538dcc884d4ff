#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check its kernels.

Run from the repository root on a machine with one NVIDIA H100 (or another
sm_90a card), the CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. build   — compiles ``mga_yolo_tpu_torch/csrc/*.cu`` with nvcc, one
             process per source, all at once.
2. kernels — every kernel of the serving path against its plain PyTorch
             version on the card, on the shapes the path gives it (and on
             ragged / tiny-mask / no-pixel / tie cases), with its median
             time beside the plain version's and its bound.
3. parity  — one 640 px batch through the engine in float32 with TF32 off,
             kernels against the plain versions patched in.
4. path    — the flagship YOLOv8n-MGA (MaskCBAM), 640 px, random weights from
             ``torch.manual_seed(0)``, BN-folded, bfloat16, through
             ``MicroBatcher`` from 4 threads on images of mixed sizes; the
             kernels' launch counters are zeroed just before and read just
             after; then the steady-state batch latency and images/s.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing
no result, when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM3 bytes/s and float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

IMGSZ, BATCH = 640, 8
CAM_SHAPES = ((80, 80, 64, 4), (40, 40, 128, 8), (20, 20, 256, 16))  # (H, W, C, hidden) at 640 px
CAM_TOL = 2e-5     # float32 sums in another order; the gate is a sigmoid in (0, 1)
PATH_RTOL, PATH_ATOL = 1e-4, 1e-3  # decoded pixels (<= ~1000) after 28 float32 layers


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, reps: int = 5) -> float:
    """Median device ms of one ``fn()`` call: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events (so host launch
    overhead is not counted)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    del g
    return sorted(times)[len(times) // 2]


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ kernels


def cam_inputs(torch, b, h, w, c, hid, dtype, kind="random", seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=g, device="cuda").to(dtype)
    if kind == "tiny":
        m = torch.zeros((b, 1, h, w), device="cuda", dtype=dtype)
    elif kind == "no_pixel":
        m = (0.05 + 0.4 * torch.rand((b, 1, h, w), generator=g, device="cuda")).to(dtype)
    else:
        m = (torch.rand((b, 1, h, w), generator=g, device="cuda") ** 2).to(dtype)
    w1 = (0.2 * torch.randn((hid, c), generator=g, device="cuda")).to(dtype)
    b1 = (0.2 * torch.randn((hid,), generator=g, device="cuda")).to(dtype)
    w2 = (0.2 * torch.randn((c, hid), generator=g, device="cuda")).to(dtype)
    b2 = (0.2 * torch.randn((c,), generator=g, device="cuda")).to(dtype)
    return x, m, w1, b1, w2, b2


def kernel_phase_cam(torch) -> dict:
    from mga_yolo_tpu_torch.ops import cam_gate as cg

    max_err = 0.0
    cases = [(BATCH, h, w, c, hid, dt, "random") for (h, w, c, hid) in CAM_SHAPES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(2, 7, 16, 64, 4, torch.bfloat16, "random"),      # N = 16*7: ragged tail
              (3, 41, 43, 128, 8, torch.float32, "random"),      # N prime-ish, C tile ragged
              (BATCH, 80, 80, 64, 4, torch.bfloat16, "tiny"),    # tiny-mask GAP blend
              (BATCH, 40, 40, 128, 8, torch.bfloat16, "no_pixel")]  # masked-max fallback
    for i, (b, h, w, c, hid, dt, kind) in enumerate(cases):
        args = cam_inputs(torch, b, h, w, c, hid, dt, kind, seed=i)
        got = cg.cam_gate(*args)
        want = cg.cam_gate_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"[kernels] cam_gate B={b} {h}x{w} C={c} {str(dt)[6:]} {kind}: max_abs_err={err:.3e}")
        check(err <= CAM_TOL, f"cam_gate disagrees with its plain version: {err} > {CAM_TOL}")
        max_err = max(max_err, err)

    ms = plain = bound = 0.0
    for h, w, c, hid in CAM_SHAPES:  # the serving path's shapes and type
        args = cam_inputs(torch, BATCH, h, w, c, hid, torch.bfloat16)
        k_ms = time_ms(torch, lambda: cg.cam_gate(*args), iters=50)
        p_ms = time_ms(torch, lambda: cg.cam_gate_ref(*args), iters=10)
        n = h * w
        n_bytes = 2 * (BATCH * n * c + BATCH * n + 2 * c * hid + hid + c) + 4 * BATCH * c
        n_ops = BATCH * (4 * n * c + 2 * n + 8 * c * hid)
        b_ms, _ = bound_ms(n_bytes, n_ops)
        print(f"[kernels] cam_gate B={BATCH} {h}x{w} C={c} bf16: {k_ms * 1e3:.1f} us "
              f"(plain {p_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us by bytes)")
        ms, plain, bound = ms + k_ms, plain + p_ms, bound + b_ms
    return {"name": "cam_gate", "route": "cuda", "source": "mga_yolo_tpu_torch/csrc/cam_gate.cu",
            "replaces": "mga_yolo_tpu/ops/pallas/masked_pool.py:227", "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def nms_candidates(torch, b=BATCH, k=1024, nc=3, seed=0):
    """Score-sorted, class-offset candidates with exact score ties."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xy = 600 * torch.rand((b, k, 2), generator=g, device="cuda")
    wh = 10 + 150 * torch.rand((b, k, 2), generator=g, device="cuda")
    cls = torch.randint(0, nc, (b, k), generator=g, device="cuda").float()
    scores = torch.round(torch.rand((b, k), generator=g, device="cuda") * 64) / 64
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    boxes = torch.cat([xy, xy + wh], -1) + (cls * 7680.0)[..., None]
    return torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous(), scores.contiguous()


def kernel_phase_nms(torch) -> dict:
    from mga_yolo_tpu_torch.ops import nms as tn

    mismatches = 0
    for seed, (k, iou, conf) in enumerate(((1024, 0.45, 0.001), (1024, 0.7, 0.25), (84, 0.45, 0.01),
                                           (1000, 0.3, 0.1))):
        boxes, scores = nms_candidates(torch, k=k, seed=seed)
        got = tn.suppress(boxes, scores, iou, conf)
        want = tn.suppress_ref(boxes, scores, iou, conf)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        print(f"[kernels] nms_suppress B={BATCH} k={k} iou={iou} conf={conf}: "
              f"kept {int(got.sum())}, mismatches {bad}")
        mismatches += bad
    check(mismatches == 0, f"nms_suppress disagrees with its plain version on {mismatches} candidates")

    boxes, scores = nms_candidates(torch, seed=7)
    keep = tn.suppress(boxes, scores, 0.45, 0.001)
    k_ms = time_ms(torch, lambda: tn.suppress(boxes, scores, 0.45, 0.001), iters=20)
    p_ms = time_ms(torch, lambda: tn.suppress_ref(boxes, scores, 0.45, 0.001), iters=2, reps=3)
    # work this data needs: one IoU (~16 float32 ops) for each (kept j < i) pair
    kept_before = torch.cumsum(keep.int(), 1) - keep.int()
    n_ops = 16 * float(kept_before.sum()) + 3 * keep.numel()
    n_bytes = boxes.numel() * 4 + scores.numel() * 4 + keep.numel()
    b_ms, by = bound_ms(n_bytes, n_ops)
    print(f"[kernels] nms_suppress B={BATCH} k=1024: {k_ms * 1e3:.1f} us "
          f"(plain {p_ms * 1e3:.1f} us, bound {b_ms * 1e3:.3f} us by {by})")
    return {"name": "nms_suppress", "route": "cuda", "source": "mga_yolo_tpu_torch/csrc/nms_suppress.cu",
            "replaces": "mga_yolo_tpu/ops/pallas/nms.py:32", "max_abs_err": float(mismatches),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": None}


# --------------------------------------------------------------------- path


def make_images(np, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    shapes = ((480, 640, 3), (720, 1280, 3), (640, 640, 3), (300, 500, 3))
    return [rng.integers(0, 256, shapes[i % len(shapes)]).astype(np.uint8) for i in range(n)]


def parity_phase(torch, np, model) -> None:
    """One 640 px batch in float32 (TF32 off): kernels vs plain versions."""
    from unittest import mock

    from mga_yolo_tpu_torch.models import attention
    from mga_yolo_tpu_torch.ops import cam_gate as cg
    from mga_yolo_tpu_torch.ops import nms as tn
    from mga_yolo_tpu_torch.serve import InferenceEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    eng = InferenceEngine(model, imgsz=IMGSZ, batch=BATCH, conf=0.001, dtype=torch.float32)
    imgs = [eng.preprocess(im)[0] for im in make_images(np, BATCH, seed=1)]
    x = torch.from_numpy(np.stack(imgs)).cuda().permute(0, 3, 1, 2).contiguous().float() / 255
    n_cam, n_nms = cg.launches, tn.launches
    with torch.inference_mode():
        out_k = eng.model(x)
        with mock.patch.object(attention, "cam_gate", cg.cam_gate_ref):
            out_p = eng.model(x)
        dec = out_k["det"][0].float()
        nms_k = tn.nms(dec, conf_thres=0.001)
        with mock.patch.object(tn, "suppress", tn.suppress_ref):
            nms_p = tn.nms(dec, conf_thres=0.001)
    torch.cuda.synchronize()
    check((cg.launches - n_cam, tn.launches - n_nms) == (3, 1),
          f"parity: kernels launched {cg.launches - n_cam} / {tn.launches - n_nms} times, want 3 / 1")
    torch.testing.assert_close(out_k["det"][0], out_p["det"][0], rtol=PATH_RTOL, atol=PATH_ATOL)
    for key in ("p3", "p4", "p5"):
        torch.testing.assert_close(out_k["seg"][key], out_p["seg"][key], rtol=PATH_RTOL, atol=1e-4)
    for a, b in zip(nms_k, nms_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    err = float((out_k["det"][0] - out_p["det"][0]).abs().max())
    print(f"[parity] f32 engine batch {BATCH}x{IMGSZ}: decoded max_abs_err {err:.3e} "
          f"(rtol {PATH_RTOL}, atol {PATH_ATOL}); NMS kept {int((nms_k[1] > 0).sum())} identical")
    torch.backends.cudnn.allow_tf32 = True


def path_phase(torch, np, model) -> dict:
    from mga_yolo_tpu_torch.ops import cam_gate as cg
    from mga_yolo_tpu_torch.ops import nms as tn
    from mga_yolo_tpu_torch.serve import InferenceEngine, MicroBatcher

    eng = InferenceEngine(model, imgsz=IMGSZ, batch=BATCH, conf=0.001)  # bf16, BN-folded
    check(eng.dtype == torch.bfloat16, f"engine dtype {eng.dtype}")
    print(f"[path] warmup {eng.warmup():.2f} s")
    imgs = make_images(np, 24, seed=2)
    results: list = [None] * len(imgs)
    errors: list = []

    def client(t: int) -> None:
        for i in range(t, len(imgs), 4):
            try:
                results[i] = mb.submit(imgs[i], timeout=120)
            except Exception as e:  # recorded and failed below
                errors.append(e)

    cg.launches = 0
    tn.launches = 0
    mb = MicroBatcher(eng, max_wait_ms=5.0)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        mb.close()
    wall = time.perf_counter() - t0
    launches = {"cam_gate": cg.launches, "nms_suppress": tn.launches}
    stats = mb.stats()
    check(not errors and not any(th.is_alive() for th in threads), f"requests failed: {errors[:3]}")
    n_batches = stats["batches"]
    print(f"[path] {len(imgs)} requests from 4 threads in {n_batches} batches, {wall:.2f} s; "
          f"stats {stats}; launches {launches}")
    check(n_batches > 0 and launches["cam_gate"] == 3 * n_batches,
          f"cam_gate launched {launches['cam_gate']} times for {n_batches} batches (want 3 each)")
    check(launches["nms_suppress"] == n_batches,
          f"nms_suppress launched {launches['nms_suppress']} times for {n_batches} batches")
    n_boxes = 0
    for img, p in zip(imgs, results):
        h, w = img.shape[:2]
        b = p.boxes
        check(p.orig_shape == (h, w) and b.ndim == 2 and b.shape[1] == 6, f"bad prediction {b.shape}")
        check(bool(np.isfinite(b).all()), "non-finite boxes")
        check(bool((b[:, [0, 2]] >= 0).all() and (b[:, [0, 2]] <= w).all()
                   and (b[:, [1, 3]] >= 0).all() and (b[:, [1, 3]] <= h).all()), "box outside image")
        check(bool((b[:, 4] > 0.001).all() and (b[:, 5] == 0).all()), "bad scores or classes")
        n_boxes += len(b)
    check(n_boxes > 0, "no detections at conf 0.001")
    print(f"[path] {n_boxes} boxes, all finite and inside their images")

    # steady state: full batches through the engine, one at a time
    lbs, metas = zip(*(eng.preprocess(im) for im in imgs[:BATCH]))
    lat = []
    for _ in range(20):
        t1 = time.perf_counter()
        eng.infer_batch(list(lbs), list(metas))
        lat.append((time.perf_counter() - t1) * 1e3)
    lat = sorted(lat[2:])
    p50 = lat[len(lat) // 2]
    print(f"[path] batch {BATCH}x{IMGSZ} bf16 latency p50 {p50:.2f} ms, max {lat[-1]:.2f} ms "
          f"({len(lat)} batches) -> {BATCH * 1e3 / p50:.1f} img/s")
    profile_phase(torch, eng, list(lbs), list(metas), p50)
    return launches


def profile_phase(torch, eng, lbs, metas, batch_ms: float, n: int = 5) -> None:
    """Device time of one steady-state batch by kernel (torch.profiler), and
    the device's busy share of the unprofiled batch latency."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.infer_batch(lbs, metas)
    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / n
    if not rows or dev_ms == 0:
        print("[profile] the profiler saw no device time: busy share not measured")
        return
    launches = sum(e.count for e in rows) / n
    print(f"[profile] per batch: device busy {dev_ms:.3f} ms in {launches:.0f} device ops "
          f"= {100 * dev_ms / batch_ms:.1f}% of the {batch_ms:.2f} ms batch latency")
    for e in rows[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3 / n:8.3f} ms  x{e.count / n:5.0f}  {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a CUDA card only", file=sys.stderr)
        return 1
    import numpy as np

    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.kernels import _build
    from mga_yolo_tpu_torch.models.yolo import create_model

    card = gpu_name_and_power()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    secs = _build.build(["cam_gate", "nms_suppress"])
    print(f"[build] {time.perf_counter() - t0:.2f} s wall, per source {secs}")
    for name in secs:
        log = _build.library_path(name).with_suffix(".log").read_text().strip()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    kernels = [kernel_phase_cam(torch), kernel_phase_nms(torch)]

    torch.manual_seed(0)
    model, _ = create_model(YOLOV8_CBAM, scale="n", nc=1)
    parity_phase(torch, np, model)
    launches = path_phase(torch, np, model)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} was not launched on the serving path")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
