#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card and
check their kernels.

Run from the repository root on a machine with one NVIDIA H100 (or another
sm_90a card), the CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. build   — compiles ``mga_yolo_tpu_torch/csrc/*.cu`` with nvcc, one
             process per source, all at once.
2. kernels — every kernel of the paths against its plain PyTorch version
             on the card, on the shapes the paths give it (and on ragged /
             tiny-mask / no-pixel / tie / integer-target / +-40-logit cases,
             every accepted R, both aux layouts of the DFL backward, NMS at
             k = 1 ... 2048 and on chains where each decision rests on the
             last), with its median time beside the plain version's and its
             bound; the CAM gate computed by the timed graph replays against
             the plain version; the masked pool's launch plan per shape, its
             descriptors computed by the timed graph replays against the
             plain version, and its time at the train batch too; the device
             kernels one call runs (torch.profiler: CAM gate 1, NMS 2,
             masked pool 1); the CAM gate's and the masked pool's autograd
             gradients against plain autograd.
Then, for each of four models at full width and depth, 640 px, random
weights from ``torch.manual_seed(0)``: the flagship YOLOv8n-MGA (MaskCBAM,
tags ``[parity]`` ... ``[train]``), YOLOv8n-MGA-ECA (MaskECA, the same tags
with ``-eca``), YOLOv8n-MGA-SPADE (MaskSPADE, no attention kernel, ``-spade``)
and the plain YOLOv8n baseline (no mask heads, ``[path-base]`` and
``[train-base]`` only):
3. parity  — one 640 px batch through the engine in float32 with TF32 off,
             kernels against the plain versions patched in.
4. path    — BN-folded, bfloat16, batch 8, through ``MicroBatcher`` from
             several threads on images of mixed sizes; the kernels' launch
             counters are zeroed just before and read just after; then the
             steady-state batch latency, images/s and a profile of a batch.
5. train-parity — one train step, 640 px, batch 2, float32 with TF32 off:
             kernels against the plain versions patched in (loss items,
             every gradient, the updated parameters).
6. train   — the train step at micro-batch 16, bf16 autocast, accumulate 4
             (nbs 64) inside the warmup ramp, 8 micro-steps with the launch
             counters zeroed just before and read just after (plain YOLOv8:
             every seg loss item exactly 0); then the steady-state step
             time, images/s and a profile of one step.
7. train-prob — the flagship with ``prob_mode``: a gumbel ProbMaskGater,
             drawing from a seeded torch.Generator on the card, in front of
             each MaskCBAM; its samples checked in [0, 1], then phase 6.
8. data    — the data stack without OpenCV or PyYAML: a synthetic
             ARCADE-shaped dataset (256 grey 512 px PNGs, vessel masks, 1-8
             boxes each) written by the port, read through MGADataset and
             DataLoader (8 threads) on the shipped cbam_defaults profile,
             as a 64-image split (``fraction`` 0.25, 4 batches an epoch)
             and whole (16 batches an epoch); the host pipeline's images/s
             alone on each, then 12 bf16 micro-steps of the flagship fed by
             the loader through the pinned copy on each, with the share of
             each spent waiting on the loader (on the 64-image split also
             without the micro-steps that begin an epoch); one batch of
             the MGA_PROB_MODE path. Fails unless the host C++ library of
             ``mga_yolo_tpu_torch/native`` builds and loads. The dataset
             also has a 64-image val split, drawn from another seed.
9. fit     — a whole training run of the flagship through ``MGA.train``:
             3 epochs on the 256 images at 640 px, batch 16, nbs 64, bf16,
             a validation of the 64 val images each epoch and of the EMA at
             the end, results.csv, best / last checkpoints; the launch
             counters zeroed just before and read just after (CAM gate 3
             per micro-step and per validation batch, DFL backward 1 per
             micro-step, NMS 1 per validation batch, exactly); a resume to
             epoch 4 in the same directory (from the first run's last step,
             no duplicate results.csv row); the val CLI on best.pt (float32)
             within ``FIT_VAL_TOL`` mAP of the trainer's evaluation (bf16),
             and its decoded boxes, scores and mask logits of the first
             val batch within the path tolerances of a float32 eval step
             of the trainer's model on best.pt (other random weights fall
             outside), from the same letterboxed images;
             best.pt served through ``build_server`` and ``MicroBatcher``.
             Per epoch it prints the wall time, images/s, the share spent
             waiting on the loader, the val speed per phase and mAP50.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing
no result, when CUDA is unavailable or any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM3 bytes/s and float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

IMGSZ, BATCH = 640, 8
TRAIN_BATCH, NBS, MAX_BOXES = 16, 64, 8  # config.py defaults: batch 16, nbs 64
CAM_SHAPES = ((80, 80, 64, 4), (40, 40, 128, 8), (20, 20, 256, 16))  # (H, W, C, hidden) at 640 px
CAM_TOL = 2e-5     # float32 sums in another order; the gate is a sigmoid in (0, 1)
POOL_SHAPES = tuple((h, w, c) for h, w, c, _ in CAM_SHAPES)  # MaskECA's (H, W, C) at 640 px
POOL_TOL = {"f32": (1e-5, 1e-6), "bf16": (2 ** -7, 1e-6)}  # float32 sums in another order; one bf16 ulp
PATH_RTOL, PATH_ATOL = 1e-4, 1e-3  # decoded pixels (<= ~1000) after 28 float32 layers
DFL_TOL = {"f32": (2e-6, 2e-6), "bf16": (8e-3, 2e-4)}  # (rtol, atol): one ulp; one bf16 ulp
DFL_REG_MAX = (8, 16, 32, 64)
FIT_EPOCHS = 3
FIT_VAL_TOL = 0.02  # mAP: the val CLI in float32 against the trainer's evaluation in bf16
FIT_WRONG_SEED = 1234  # the random weights a wrong reading of best.pt is shown to differ from
# train-parity, kernels vs plain in float32: the CAM gate's and dz's last-bit
# differences pass a 640 px backward through 60 train-mode BNs
TRAIN_ITEMS_RTOL, TRAIN_GRAD_TOL, TRAIN_PARAM_ATOL = 1e-4, 1e-3, 1e-6


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def kernel_modules() -> dict:
    """The wrapper module of each kernel, which holds its launch counter."""
    from mga_yolo_tpu_torch.ops import cam_gate, dfl_bwd, masked_pool, nms

    return {"cam_gate": cam_gate, "nms_suppress": nms, "dfl_bwd": dfl_bwd, "masked_pool": masked_pool}


def zero_launches() -> None:
    for mod in kernel_modules().values():
        mod.launches = 0


def read_launches() -> dict:
    return {name: mod.launches for name, mod in kernel_modules().items()}


def want_launches(counts: dict | None = None) -> dict:
    """Every kernel's count 0 but those given; a None key (the attention
    kernel of a model that has none: SPADE, plain YOLOv8) is dropped."""
    counts = {k: v for k, v in (counts or {}).items() if k is not None}
    check(set(counts) <= set(kernel_modules()), f"unknown kernels in {counts}")
    return {name: counts.get(name, 0) for name in kernel_modules()}


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, reps: int = 5, after=None) -> float:
    """Median device ms of one ``fn()`` call: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events (so host launch
    overhead is not counted). ``after()``, if given, runs once the timed
    replays are done, while the graph's outputs are alive."""
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
    if after is not None:
        after()
    del g
    return sorted(times)[len(times) // 2]


def device_kernels(torch, fn, n: int = 10) -> tuple[float, dict]:
    """Device kernels that one ``fn()`` call runs, and device ms per call by
    kernel name (torch.profiler over ``n`` calls, after a warm call). Now
    and then the profiler's trace comes back without a single device event
    (one session of about fifty on the card, on code that traced before and
    after); such a session is profiled again, at most twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if rows:
            break
        print("[kernels] the profiler saw no device event; profiling again")
    return sum(e.count for e in rows) / n, {e.key[:60]: e.self_device_time_total / 1e3 / n for e in rows}


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
    per_call = []
    for h, w, c, hid in CAM_SHAPES:  # the serving path's shapes and type
        args = cam_inputs(torch, BATCH, h, w, c, hid, torch.bfloat16)
        out = {}

        def run():
            out["gate"] = cg.cam_gate(*args)

        def replayed():  # the gate the last replay wrote, against the plain version
            torch.cuda.synchronize()
            err = float((out["gate"] - cg.cam_gate_ref(*args)).abs().max())
            print(f"[kernels] cam_gate B={BATCH} {h}x{w} C={c} bf16 after the timed graph replays: "
                  f"max_abs_err={err:.3e}")
            check(err <= CAM_TOL, f"cam_gate after graph replays disagrees: {err} > {CAM_TOL}")
            out["err"] = err

        k_ms = time_ms(torch, run, iters=50, after=replayed)
        max_err = max(max_err, out["err"])
        p_ms = time_ms(torch, lambda: cg.cam_gate_ref(*args), iters=10)
        n_kern, by_name = device_kernels(torch, lambda: cg.cam_gate(*args))
        print(f"[kernels] cam_gate B={BATCH} {h}x{w} C={c} bf16: {n_kern:g} device kernels per call "
              f"(profiler: {', '.join(f'{k} {v * 1e3:.2f} us' for k, v in by_name.items())})")
        check(n_kern == 1, f"cam_gate ran {n_kern} device kernels per call, want 1")
        per_call.append(n_kern)
        n = h * w
        n_bytes = 2 * (BATCH * n * c + BATCH * n + 2 * c * hid + hid + c) + 4 * BATCH * c
        n_ops = BATCH * (4 * n * c + 2 * n + 8 * c * hid)
        b_ms, _ = bound_ms(n_bytes, n_ops)
        print(f"[kernels] cam_gate B={BATCH} {h}x{w} C={c} bf16: {k_ms * 1e3:.1f} us "
              f"(plain {p_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us by bytes)")
        ms, plain, bound = ms + k_ms, plain + p_ms, bound + b_ms
    return {"name": "cam_gate", "route": "cuda", "source": "mga_yolo_tpu_torch/csrc/cam_gate.cu",
            "replaces": "mga_yolo_tpu/ops/pallas/masked_pool.py:227", "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            "device_kernels_per_call": max(per_call)}


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


def nms_chain(torch, b=BATCH, k=2048):
    """Box i overlaps box i + 1 above 0.45 (IoU 7/13) and box i + 2 below
    (4/16): the keep mask alternates, each decision resting on the last."""
    x = 3.0 * torch.arange(k, device="cuda", dtype=torch.float32)
    boxes = torch.stack([x, torch.zeros_like(x), x + 10, torch.full_like(x, 10.0)], -1)
    scores = 1.0 - torch.arange(k, device="cuda", dtype=torch.float32) / (2 * k)
    return boxes.expand(b, k, 4).contiguous(), scores.expand(b, k).contiguous()


def kernel_phase_nms(torch) -> dict:
    from mga_yolo_tpu_torch.ops import nms as tn

    mismatches = 0
    cases = [(k, iou, conf, False) for k, iou, conf in ((1024, 0.45, 0.001), (1024, 0.7, 0.25), (84, 0.45, 0.01),
                                                         (1000, 0.3, 0.1), (1, 0.45, 0.01), (65, 0.45, 0.01),
                                                         (2048, 0.45, 0.001))]
    cases += [(130, 0.45, 0.0, True), (2048, 0.45, 0.0, True)]  # chains across word boundaries
    for seed, (k, iou, conf, chain) in enumerate(cases):
        boxes, scores = nms_chain(torch, k=k) if chain else nms_candidates(torch, k=k, seed=seed)
        got = tn.suppress(boxes, scores, iou, conf)
        want = tn.suppress_ref(boxes, scores, iou, conf)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        if chain:
            bad += int((want != (torch.arange(k, device="cuda") % 2 == 0)).sum())
        print(f"[kernels] nms_suppress B={BATCH} k={k} iou={iou} conf={conf}{' chain' if chain else ''}: "
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
          f"(plain {p_ms * 1e3:.1f} us, bound {b_ms * 1e3:.3f} us by {by}); kept {int(keep.sum())}")
    n_kern, by_name = device_kernels(torch, lambda: tn.suppress(boxes, scores, 0.45, 0.001))
    print(f"[kernels] nms_suppress B={BATCH} k=1024: {n_kern:g} device kernels per call "
          f"(profiler: {', '.join(f'{k} {v * 1e3:.2f} us' for k, v in by_name.items())})")
    check(n_kern == 2, f"nms_suppress ran {n_kern} device kernels per call, want 2 (mask, scan)")
    return {"name": "nms_suppress", "route": "cuda", "source": "mga_yolo_tpu_torch/csrc/nms_suppress.cu",
            "replaces": "mga_yolo_tpu/ops/pallas/nms.py:32", "max_abs_err": float(mismatches),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "device_kernels_per_call": n_kern}


def dfl_inputs(torch, b, a, r, dtype, planar=False, seed=0):
    """pd (B, A, 4, R) with +-40 logits, float32 aux with integer targets;
    aux (B, A, 4), or permuted views of planar (4, B, A) tensors."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    pd = 3 * torch.randn((b, a, 4, r), generator=g, device="cuda")
    pd[0, 0], pd[0, 1] = 40.0, -40.0
    shape = (4, b, a) if planar else (b, a, 4)
    ltrb = r / 2 + 3 * torch.randn(shape, generator=g, device="cuda")
    g_ltrb = torch.randn(shape, generator=g, device="cuda")
    target = (r - 1) * torch.rand(shape, generator=g, device="cuda")
    if planar:
        ltrb, g_ltrb, target = (t.permute(1, 2, 0) for t in (ltrb, g_ltrb, target))
    target[0, :4] = target[0, :4].floor()
    g_ce = 2 * torch.rand((b, a), generator=g, device="cuda")
    return pd.to(dtype), ltrb, g_ltrb, g_ce, target


def kernel_phase_dfl(torch) -> dict:
    from mga_yolo_tpu_torch.ops import dfl_bwd as db

    b, a, r = TRAIN_BATCH, 8400, 16  # the train path: B=16, A=8400 at 640 px, R=16
    cases = [(b, a, r, dt, planar) for dt in ("f32", "bf16") for planar in (False, True)]
    cases += [(1, 1050, r, "f32", False), (1, 1050, r, "bf16", True)]  # ragged tail
    cases += [(2, 84, rr, dt, False) for rr in DFL_REG_MAX for dt in ("f32", "bf16")]
    max_err = 0.0
    for i, (bb, aa, rr, dt, planar) in enumerate(cases):
        args = dfl_inputs(torch, bb, aa, rr, getattr(torch, {"f32": "float32", "bf16": "bfloat16"}[dt]),
                          planar, seed=i)
        got = db.dfl_decode_ce_bwd(*args)
        want = db.dfl_decode_ce_bwd_ref(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        rtol, atol = DFL_TOL[dt]
        ok = bool(((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all())
        print(f"[kernels] dfl_bwd B={bb} A={aa} R={rr} {dt} {'planar' if planar else 'BA4'} aux: "
              f"max_abs_err={err:.3e}")
        check(ok, f"dfl_bwd disagrees with its plain version (rtol {rtol}, atol {atol}): {err}")
        max_err = max(max_err, err)

    times = {}
    for planar in (False, True):  # the path's (B, A, 4) aux, then planar views
        args = dfl_inputs(torch, b, a, r, torch.bfloat16, planar)
        times[planar] = time_ms(torch, lambda: db.dfl_decode_ce_bwd(*args), iters=50)
    p_ms = time_ms(torch, lambda: db.dfl_decode_ce_bwd_ref(*args), iters=5)
    n_el = b * a * 4 * r
    n_bytes = 2 * n_el * 2 + 3 * b * a * 4 * 4 + b * a * 4  # pd in, dz out (bf16); 3 aux + g_ce f32
    b_ms, by = bound_ms(n_bytes, 10 * n_el)  # ~10 float32 operations per logit
    print(f"[kernels] dfl_bwd B={b} A={a} R={r} bf16: {times[False] * 1e3:.1f} us with (B,A,4) aux, "
          f"{times[True] * 1e3:.1f} us with planar aux (plain {p_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us "
          f"by {by})")
    return {"name": "dfl_bwd", "route": "cuda", "source": "mga_yolo_tpu_torch/csrc/dfl_bwd.cu",
            "replaces": "mga_yolo_tpu/ops/pallas/dfl_bwd.py:155",
            "also_replaces": "mga_yolo_tpu/ops/pallas/dfl_bwd.py:53", "max_abs_err": max_err,
            "ms": times[False], "ms_planar_aux": times[True], "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": by, "library_ms": None}


def kernel_phase_cam_grad(torch) -> None:
    """The CAM gate's autograd Function (kernel forward, recomputed plain
    backward) against autograd through the plain version: six gradients."""
    from mga_yolo_tpu_torch.ops import cam_gate as cg

    for i, (h, w, c, hid) in enumerate(CAM_SHAPES):
        args = cam_inputs(torch, 4, h, w, c, hid, torch.float32, seed=10 + i)
        g = torch.randn((4, c), device="cuda")
        grads = []
        for fn in (cg.cam_gate, cg.cam_gate_ref):
            leaves = [t.clone().requires_grad_(True) for t in args]
            grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
        torch.cuda.synchronize()
        errs = [float((x - y).abs().max()) for x, y in zip(*grads)]
        print(f"[kernels] cam_gate grad B=4 {h}x{w} C={c} f32: max_abs_err per input {[f'{e:.1e}' for e in errs]}")
        for x, y in zip(*grads):
            torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)


def pool_inputs(torch, b, h, w, c, dtype, kind="random", seed=0):
    x, m, *_ = cam_inputs(torch, b, h, w, c, 1, dtype, kind, seed)
    return x, m


def kernel_phase_pool(torch) -> dict:
    from mga_yolo_tpu_torch.ops import masked_pool as mp

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for b in (BATCH, TRAIN_BATCH):
        for h, w, c in POOL_SHAPES:
            tile, wpc, blocks = mp.pool_plan(b, c, n_sm)
            print(f"[kernels] masked_pool plan B={b} {h}x{w} C={c}: tile {tile} channel(s) a block, "
                  f"{wpc} warp(s) a channel, {blocks} blocks on {n_sm} SMs")

    max_err = 0.0

    def compare(got, want, x, m, what: str) -> list:
        """Output types and shapes, max descriptors exact where a pixel has
        m > 0.5, the rest within POOL_TOL; returns the two max abs errors."""
        rtol, atol = POOL_TOL["f32" if x.dtype == torch.float32 else "bf16"]
        errs = []
        for g, wnt in zip(got, want):
            check(g.dtype == x.dtype and g.shape == x.shape[:2], f"masked_pool output {g.dtype} {tuple(g.shape)}")
            errs.append(float((g.float() - wnt.float()).abs().max()))
            torch.testing.assert_close(g.float(), wnt.float(), rtol=rtol, atol=atol, msg=lambda e: f"{what}: {e}")
        any_sel = (m.float() > 0.5).flatten(1).any(1)
        torch.testing.assert_close(got[1][any_sel], want[1][any_sel], rtol=0, atol=0, msg=lambda e: f"{what}: {e}")
        return errs

    cases = [(b, h, w, c, dt, "random") for b in (BATCH, TRAIN_BATCH) for (h, w, c) in POOL_SHAPES
             for dt in ("f32", "bf16")]
    cases += [(2, 7, 16, 64, "bf16", "random"),          # N = 16*7: ragged tail
              (3, 41, 43, 72, "f32", "random"),          # N odd: one element a load; C = 72
              (1, 80, 80, 64, "bf16", "random"),         # B = 1: 64 blocks, fewer than the SMs
              (16, 9, 11, 37, "bf16", "random"),         # C = 37: a ragged last tile
              (BATCH, 80, 80, 64, "bf16", "tiny"),       # tiny-mask GAP blend for avg
              (BATCH, 40, 40, 128, "f32", "no_pixel")]   # masked-max GAP fallback
    for i, (b, h, w, c, dt, kind) in enumerate(cases):
        x, m = pool_inputs(torch, b, h, w, c, getattr(torch, {"f32": "float32", "bf16": "bfloat16"}[dt]), kind,
                           seed=20 + i)
        what = f"masked_pool B={b} {h}x{w} C={c} {dt} {kind}"
        errs = compare(mp.masked_pool(x, m), mp.masked_pool_ref(x, m), x, m, what)
        print(f"[kernels] {what}: max_abs_err avg {errs[0]:.3e}, max {errs[1]:.3e}")
        max_err = max(max_err, *errs)

    times = {}
    bound = plain = 0.0
    for b in (BATCH, TRAIN_BATCH):  # the serving path's batch, then the train path's
        for h, w, c in POOL_SHAPES:
            x, m = pool_inputs(torch, b, h, w, c, torch.bfloat16, seed=b + c)
            out = {}

            def run():
                out["pool"] = mp.masked_pool(x, m)

            def replayed():  # the descriptors the last replay wrote, against the plain version
                torch.cuda.synchronize()
                what = f"masked_pool B={b} {h}x{w} C={c} bf16 after the timed graph replays"
                out["errs"] = compare(out["pool"], mp.masked_pool_ref(x, m), x, m, what)
                print(f"[kernels] {what}: max_abs_err avg {out['errs'][0]:.3e}, max {out['errs'][1]:.3e}")

            k_ms = time_ms(torch, run, iters=50, after=replayed)
            max_err = max(max_err, *out["errs"])
            n_kern, by_name = device_kernels(torch, lambda: mp.masked_pool(x, m))
            check(n_kern == 1, f"masked_pool ran {n_kern} device kernels per call at B={b} {h}x{w}, want 1")
            n = h * w
            b_ms, _ = bound_ms(2 * (b * n * c + b * n) + 2 * 2 * b * c, b * (4 * n * c + 2 * n))
            msg = f"bound {b_ms * 1e3:.2f} us by bytes"
            if b == BATCH:
                p_ms = time_ms(torch, lambda: mp.masked_pool_ref(x, m), iters=10)
                plain, bound = plain + p_ms, bound + b_ms
                msg = f"plain {p_ms * 1e3:.1f} us, {msg}"
            times[(b, c)] = k_ms
            print(f"[kernels] masked_pool B={b} {h}x{w} C={c} bf16: {k_ms * 1e3:.1f} us ({msg}); {n_kern:g} device "
                  f"kernel per call (profiler: {', '.join(f'{k} {v * 1e3:.2f} us' for k, v in by_name.items())})")
    ms = sum(times[(BATCH, c)] for _, _, c in POOL_SHAPES)
    ms_train = sum(times[(TRAIN_BATCH, c)] for _, _, c in POOL_SHAPES)
    print(f"[kernels] masked_pool, three calls: {ms * 1e3:.1f} us at B={BATCH}, {ms_train * 1e3:.1f} us at "
          f"B={TRAIN_BATCH} (bf16)")
    return {"name": "masked_pool", "route": "cuda", "source": "mga_yolo_tpu_torch/csrc/masked_pool.cu",
            "replaces": "mga_yolo_tpu/ops/pallas/masked_pool.py:36", "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            "ms_train_batch": ms_train, "device_kernels_per_call": 1}


def kernel_phase_pool_grad(torch) -> None:
    """The masked pool's autograd Function (kernel forward, analytic plain
    backward) against autograd through the plain version: x and m gradients,
    with a cotangent on the average only (as MaskECA gives) and on both."""
    from mga_yolo_tpu_torch.ops import masked_pool as mp

    for i, (h, w, c) in enumerate(POOL_SHAPES):
        x, m = pool_inputs(torch, 4, h, w, c, torch.float32, seed=30 + i)
        ga, gm = torch.randn((2, 4, c), device="cuda")
        for both in (False, True):
            grads = []
            for fn in (mp.masked_pool, mp.masked_pool_ref):
                leaves = [x.clone().requires_grad_(True), m.clone().requires_grad_(True)]
                avg, mx = fn(*leaves)
                loss = (avg * ga).sum() + ((mx * gm).sum() if both else 0)
                grads.append(torch.autograd.grad(loss, leaves))
            torch.cuda.synchronize()
            errs = [float((a - b).abs().max()) for a, b in zip(*grads)]
            print(f"[kernels] masked_pool grad B=4 {h}x{w} C={c} f32, cotangent on {'both' if both else 'avg'}: "
                  f"max_abs_err dx {errs[0]:.1e}, dm {errs[1]:.1e}")
            for a, b in zip(*grads):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------- path


def make_images(np, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    shapes = ((480, 640, 3), (720, 1280, 3), (640, 640, 3), (300, 500, 3))
    return [rng.integers(0, 256, shapes[i % len(shapes)]).astype(np.uint8) for i in range(n)]


def parity_phase(torch, np, model, attn: str, sfx: str = "") -> None:
    """One 640 px batch in float32 (TF32 off): kernels vs plain versions.
    ``attn`` names the model's attention kernel (3 launches, the other 0)."""
    from unittest import mock

    from mga_yolo_tpu_torch.models import attention
    from mga_yolo_tpu_torch.ops import cam_gate as cg
    from mga_yolo_tpu_torch.ops import masked_pool as mp
    from mga_yolo_tpu_torch.ops import nms as tn
    from mga_yolo_tpu_torch.serve import InferenceEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    eng = InferenceEngine(model, imgsz=IMGSZ, batch=BATCH, conf=0.001, dtype=torch.float32)
    imgs = [eng.preprocess(im)[0] for im in make_images(np, BATCH, seed=1)]
    x = torch.from_numpy(np.stack(imgs)).cuda().permute(0, 3, 1, 2).contiguous().float() / 255
    zero_launches()
    with torch.inference_mode():
        out_k = eng.model(x)
        with mock.patch.object(attention, "cam_gate", cg.cam_gate_ref), \
                mock.patch.object(attention, "masked_pool", mp.masked_pool_ref):
            out_p = eng.model(x)
        dec = out_k["det"][0].float()
        nms_k = tn.nms(dec, conf_thres=0.001)
        with mock.patch.object(tn, "suppress", tn.suppress_ref):
            nms_p = tn.nms(dec, conf_thres=0.001)
    torch.cuda.synchronize()
    launched, want = read_launches(), want_launches({attn: 3, "nms_suppress": 1})
    check(launched == want, f"parity{sfx}: kernels launched {launched}, want {want}")
    torch.testing.assert_close(out_k["det"][0], out_p["det"][0], rtol=PATH_RTOL, atol=PATH_ATOL)
    for key in out_p["seg"]:  # p3, p4, p5; none for plain YOLOv8
        torch.testing.assert_close(out_k["seg"][key], out_p["seg"][key], rtol=PATH_RTOL, atol=1e-4)
    for a, b in zip(nms_k, nms_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    err = float((out_k["det"][0] - out_p["det"][0]).abs().max())
    print(f"[parity{sfx}] f32 engine batch {BATCH}x{IMGSZ}: decoded max_abs_err {err:.3e} "
          f"(rtol {PATH_RTOL}, atol {PATH_ATOL}); NMS kept {int((nms_k[1] > 0).sum())} identical; "
          f"launches {launched}")
    torch.backends.cudnn.allow_tf32 = True


def path_phase(torch, np, model, attn: str, sfx: str = "", n_requests: int = 24, n_threads: int = 4) -> dict:
    """``n_requests`` images of mixed sizes from ``n_threads`` threads through
    ``MicroBatcher`` (bf16, BN-folded), then the steady-state batch and a
    profile. ``attn`` names the model's attention kernel."""
    from mga_yolo_tpu_torch.serve import InferenceEngine, MicroBatcher

    tag = f"path{sfx}"
    eng = InferenceEngine(model, imgsz=IMGSZ, batch=BATCH, conf=0.001)  # bf16, BN-folded
    check(eng.dtype == torch.bfloat16, f"engine dtype {eng.dtype}")
    print(f"[{tag}] warmup {eng.warmup():.2f} s")
    imgs = make_images(np, n_requests, seed=2)
    results: list = [None] * len(imgs)
    errors: list = []

    def client(t: int) -> None:
        for i in range(t, len(imgs), n_threads):
            try:
                results[i] = mb.submit(imgs[i], timeout=120)
            except Exception as e:  # recorded and failed below
                errors.append(e)

    zero_launches()
    mb = MicroBatcher(eng, max_wait_ms=5.0)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        mb.close()
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = mb.stats()
    check(not errors and not any(th.is_alive() for th in threads), f"requests failed: {errors[:3]}")
    n_batches = stats["batches"]
    print(f"[{tag}] {len(imgs)} requests from {n_threads} threads in {n_batches} batches, {wall:.2f} s; "
          f"stats {stats}; launches {launches}")
    want = want_launches({attn: 3 * n_batches, "nms_suppress": n_batches})
    check(n_batches > 0 and launches == want, f"launches {launches} for {n_batches} batches, want {want}")
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
    print(f"[{tag}] {n_boxes} boxes, all finite and inside their images")

    # steady state: full batches through the engine, one at a time
    lbs, metas = zip(*(eng.preprocess(im) for im in make_images(np, BATCH, seed=2)))
    lat = []
    for _ in range(20):
        t1 = time.perf_counter()
        eng.infer_batch(list(lbs), list(metas))
        lat.append((time.perf_counter() - t1) * 1e3)
    lat = sorted(lat[2:])
    p50 = lat[len(lat) // 2]
    print(f"[{tag}] batch {BATCH}x{IMGSZ} bf16 latency p50 {p50:.2f} ms, max {lat[-1]:.2f} ms "
          f"({len(lat)} batches) -> {BATCH * 1e3 / p50:.1f} img/s")
    profile_phase(torch, lambda: eng.infer_batch(list(lbs), list(metas)), p50, tag=f"profile{sfx}")
    return launches


def profile_phase(torch, run, step_ms: float, what: str = "batch", tag: str = "profile", n: int = 5) -> None:
    """Host time of one steady-state ``run()`` by operator and device time by
    kernel (torch.profiler), and the device's busy share of its unprofiled
    wall time ``step_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # the host side: operators and CUDA runtime calls by self time on the
    # host (under the profiler, which adds its own cost to each)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)
    print(f"[{tag}] per {what}: host self time {sum(e.self_cpu_time_total for e in host) / 1e3 / n:.3f} ms "
          f"in {sum(e.count for e in host) / n:.0f} host events (profiled)")
    for e in host[:10]:
        print(f"[{tag}]   host {e.self_cpu_time_total / 1e3 / n:8.3f} ms  x{e.count / n:5.0f}  {e.key[:80]}")
    rows = sorted((e for e in events if e.device_type == DeviceType.CUDA), key=lambda e: -e.self_device_time_total)
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / n
    if not rows or dev_ms == 0:
        print(f"[{tag}] the profiler saw no device time: busy share not measured")
        return
    launches = sum(e.count for e in rows) / n
    print(f"[{tag}] per {what}: device busy {dev_ms:.3f} ms in {launches:.0f} device ops "
          f"= {100 * dev_ms / step_ms:.1f}% of the {step_ms:.2f} ms {what} time")
    for e in rows[:12]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3 / n:8.3f} ms  x{e.count / n:5.0f}  {e.key[:90]}")


# -------------------------------------------------------------------- train


def train_batch(np, torch, b: int, seed: int = 0) -> dict:
    """Synthetic train batch on the card: uint8 images, 1-8 boxes per image
    (the rest padding), and the masks those boxes draw at strides 8/16/32."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, MAX_BOXES, 4), np.float32)
    mask_gt = np.zeros((b, MAX_BOXES), np.float32)
    for i in range(b):
        n = int(rng.integers(1, MAX_BOXES + 1))
        xy = rng.uniform(0, 0.7 * IMGSZ, (n, 2))
        boxes[i, :n] = np.concatenate([xy, xy + rng.uniform(IMGSZ / 40, 0.3 * IMGSZ, (n, 2))], -1)
        mask_gt[i, :n] = 1
    masks = []
    for s in (8, 16, 32):
        c = (np.arange(IMGSZ // s) + 0.5) * s
        m = np.zeros((b, IMGSZ // s, IMGSZ // s, 1), np.float32)
        for i in range(b):
            for x1, y1, x2, y2 in boxes[i, mask_gt[i] > 0]:
                m[i, (c[:, None] >= y1) & (c[:, None] <= y2) & (c[None] >= x1) & (c[None] <= x2), 0] = 1
        masks.append(m)
    host = {"image": rng.integers(0, 256, (b, IMGSZ, IMGSZ, 3)).astype(np.uint8), "gt_boxes": boxes,
            "gt_labels": np.zeros((b, MAX_BOXES), np.int32), "mask_gt": mask_gt, "masks": masks}
    return {k: [torch.from_numpy(x).cuda() for x in v] if isinstance(v, list) else torch.from_numpy(v).cuda()
            for k, v in host.items()}


def make_step(torch, model, accumulate: int, dtype, warmup_steps: int = 0, seg_cfg=None):
    from mga_yolo_tpu_torch.losses import DetLossConfig, SegLossConfig
    from mga_yolo_tpu_torch.train import state as S

    # weight decay scaled as the trainer does: wd * batch * accumulate / nbs
    wd = 5e-4 * TRAIN_BATCH * accumulate / NBS
    return S.make_train_step(model, model.det_strides, 1, DetLossConfig(), seg_cfg or SegLossConfig(), weight_decay=wd,
                             ema_decay=0.9999, ema_tau=2000, accumulate=accumulate, compute_dtype=dtype,
                             warmup_steps=warmup_steps)


def train_parity_phase(torch, np, model, attn: str, sfx: str = "") -> None:
    """One train step, 640 px, batch 2, float32, TF32 off: kernels against
    the plain versions patched in, from the same weights and batch."""
    import copy
    from unittest import mock

    from mga_yolo_tpu_torch.losses import detection
    from mga_yolo_tpu_torch.models import attention
    from mga_yolo_tpu_torch.ops import cam_gate as cg
    from mga_yolo_tpu_torch.ops import dfl_bwd as db
    from mga_yolo_tpu_torch.ops import masked_pool as mp
    from mga_yolo_tpu_torch.train import state as S

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = train_batch(np, torch, 2, seed=3)
    results = []
    for plain in (False, True):
        m = copy.deepcopy(model).train()
        st = S.create_train_state(m)
        step = make_step(torch, m, 1, torch.float32)
        zero_launches()
        with mock.patch.object(attention, "cam_gate", cg.cam_gate_ref if plain else cg.cam_gate), \
                mock.patch.object(attention, "masked_pool", mp.masked_pool_ref if plain else mp.masked_pool), \
                mock.patch.object(detection, "dfl_decode_ce_bwd",
                                  db.dfl_decode_ce_bwd_ref if plain else db.dfl_decode_ce_bwd):
            st, metrics = step(st, batch, 0.01, 0.1, 0.8)
        torch.cuda.synchronize()
        launched = read_launches()
        want = want_launches() if plain else want_launches({attn: 3, "dfl_bwd": 1})
        check(launched == want, f"train-parity{sfx}: launched {launched}, want {want}")
        if not plain:
            kernel_launches = launched
        results.append((metrics["items"], st.opt_state["m"], {k: p.detach() for k, p in st.params().items()}))
    (items_k, m_k, p_k), (items_p, m_p, p_p) = results
    torch.testing.assert_close(items_k, items_p, rtol=TRAIN_ITEMS_RTOL, atol=0)
    g_err = p_err = 0.0
    for k in m_p:  # first step from zero momentum: m = clipped gradient + decay
        scale = float(m_p[k].abs().max())
        g_err = max(g_err, float((m_k[k] - m_p[k]).abs().max()) / max(scale, 1e-30))
        torch.testing.assert_close(m_k[k], m_p[k], rtol=0, atol=TRAIN_GRAD_TOL * scale, msg=lambda s: f"{k}: {s}")
        p_err = max(p_err, float((p_k[k] - p_p[k]).abs().max()))
        torch.testing.assert_close(p_k[k], p_p[k], rtol=0, atol=TRAIN_PARAM_ATOL, msg=lambda s: f"{k}: {s}")
    print(f"[train-parity{sfx}] f32 step B=2x{IMGSZ}: items max rel err "
          f"{float(((items_k - items_p).abs() / items_p.abs()).max()):.2e} (rtol {TRAIN_ITEMS_RTOL}); "
          f"{len(m_p)} gradients max err {g_err:.2e} x max|g| (tol {TRAIN_GRAD_TOL}); "
          f"params max abs err {p_err:.2e} (atol {TRAIN_PARAM_ATOL}); kernels launched {kernel_launches}")
    torch.backends.cudnn.allow_tf32 = True


def train_phase(torch, np, model, attn: str, sfx: str = "", n_timed: int = 12, gen=None,
                seg: bool = True) -> dict:
    """The bf16 train step at micro-batch 16 and accumulate 4: 8 counted
    micro-steps, then ``n_timed`` timed ones and a profile. ``gen`` is the
    torch.Generator of a prob_mode model's mask gates; without ``seg`` (no
    mask heads) every seg loss item must be exactly 0."""
    from mga_yolo_tpu_torch.train import optim
    from mga_yolo_tpu_torch.train import state as S

    tag = f"train{sfx}"
    model.train()
    accumulate = max(round(NBS / TRAIN_BATCH), 1)
    sched = optim.Schedule(lr0=0.01, lrf=0.01, momentum=0.937, warmup_epochs=3.0, warmup_momentum=0.8,
                           warmup_bias_lr=0.1, epochs=100, steps_per_epoch=10)
    step = make_step(torch, model, accumulate, torch.bfloat16, warmup_steps=sched.warmup_steps)
    st = S.create_train_state(model)
    # start inside the warmup, where the ramp's accumulate has reached 4, as a
    # run resumed at micro-step 96 of its 100-step warmup
    st.step = st.last_apply = sched.warmup_steps - 4
    batch = train_batch(np, torch, TRAIN_BATCH, seed=4)
    ema0 = {k: v.clone() for k, v in st.ema_params.items()}
    bn0 = {k: v.clone() for k, v in st.bn_stats().items()}
    t0 = time.perf_counter()
    step(st, batch, *sched.at(st.step), gen)  # first use: cuDNN plans, allocator
    torch.cuda.synchronize()
    print(f"[{tag}] first micro-step {time.perf_counter() - t0:.2f} s")
    st.step = st.last_apply = sched.warmup_steps - 4  # forget the first-use micro-step
    torch._foreach_zero_(list(st.accum_grads.values()))
    n_steps, applies = 8, []
    zero_launches()
    for _ in range(n_steps):
        before = [p.detach().clone() for p in st.params().values()]
        opt_before = st.opt_step
        st, metrics = step(st, batch, *sched.at(st.step), gen)
        loss = float(metrics["loss"])
        check(np.isfinite(loss) and bool(torch.isfinite(metrics["items"]).all()), f"non-finite loss {loss}")
        check(seg or bool((metrics["items"][3:] == 0).all()), f"seg items of a model without mask heads: "
              f"{metrics['items'][3:].tolist()}")
        moved = any(not torch.equal(a, p) for a, p in zip(before, st.params().values()))
        applied = st.opt_step > opt_before
        check(moved == applied, f"micro-step {st.step}: parameters moved={moved}, applied={applied}")
        applies.append(applied)
    launches = read_launches()
    print(f"[{tag}] {n_steps} micro-steps B={TRAIN_BATCH}x{IMGSZ} bf16, accumulate {accumulate}: applies at "
          f"{[i + 1 for i, a in enumerate(applies) if a]}, last loss {loss:.4f}, items "
          f"{[round(float(x), 4) for x in metrics['items']]}; launches {launches}")
    check(sum(applies) == 2, f"{sum(applies)} applies in {n_steps} micro-steps, want 2")
    want = want_launches({attn: 3 * n_steps, "dfl_bwd": n_steps})
    check(launches == want, f"launches {launches} in {n_steps} micro-steps, want {want}")
    check(any(not torch.equal(ema0[k], v) for k, v in st.ema_params.items()), "the EMA did not move")
    check(any(not torch.equal(bn0[k], v) for k, v in st.bn_stats().items()), "BN running statistics did not move")

    times = []
    for _ in range(n_timed):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st, _ = step(st, batch, *sched.at(st.step), gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    lat = sorted(times)
    p50 = lat[len(lat) // 2]
    img_s = TRAIN_BATCH * len(times) * 1e3 / sum(times)
    print(f"[{tag}] steady state over {len(times)} micro-steps ({sum(times) / len(times):.2f} ms mean, "
          f"{len(times) // accumulate} applies): p50 {p50:.2f} ms, max {lat[-1]:.2f} ms -> {img_s:.1f} img/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_phase(torch, lambda: step(st, batch, *sched.at(st.step), gen), sum(times) / len(times),
                  what="micro-step", tag=f"train-profile{sfx}", n=accumulate)
    return launches


def train_prob_phase(torch, np) -> dict:
    """The flagship with ``prob_mode``: each MaskCBAM's mask goes through a
    gumbel ProbMaskGater that draws from a seeded torch.Generator on the
    card; then the train phase (3 CAM-gate launches a micro-step)."""
    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.models.attention import MaskCBAM
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.train.state import normalize_images

    torch.manual_seed(0)
    model, _ = create_model(YOLOV8_CBAM, scale="n", nc=1, prob_approach="gumbel")
    gates = [m.gater for m in model.modules() if isinstance(m, MaskCBAM)]
    check(len(gates) == 3 and all(g is not None and g.mode == "gumbel" for g in gates), "prob_mode gates missing")
    gen = torch.Generator(device="cuda").manual_seed(0)
    samples = []
    hooks = [g.register_forward_hook(lambda mod, inp, out: samples.append(out.detach())) for g in gates]
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        model.train()(normalize_images(train_batch(np, torch, 2, seed=5)["image"]), generator=gen)
    for h in hooks:
        h.remove()
    inside = [float(((x > 0) & (x < 1)).float().mean()) for x in samples]
    check(len(samples) == 3 and all(x.dtype == torch.float32 and bool(torch.isfinite(x).all())
                                    and float(x.min()) >= 0 and float(x.max()) <= 1 for x in samples),
          "gumbel samples outside [0, 1]")
    check(all(f > 0.05 for f in inside), f"gumbel samples all but binary: {inside}")
    print(f"[train-prob] gumbel gate samples at P3/P4/P5 in [0, 1]; share strictly inside (0, 1) "
          f"{', '.join(f'{f:.3f}' for f in inside)} (float32 rounds sigmoid(x > 17) to 1)")
    return train_phase(torch, np, model, "cam_gate", "-prob", n_timed=4, gen=gen)


def check_batch(np, batch: dict, b: int, prob: bool = False) -> int:
    """A loader batch has the shapes, types and box counts of the train
    step's batch dict; returns its number of boxes."""
    want = {"image": ((b, IMGSZ, IMGSZ, 3), np.uint8), "gt_boxes": ((b, MAX_BOXES, 4), np.float32),
            "gt_labels": ((b, MAX_BOXES), np.int32), "mask_gt": ((b, MAX_BOXES), np.float32),
            "index": ((b,), np.int32)}
    for k, (shape, dtype) in want.items():
        check(batch[k].shape == shape and batch[k].dtype == dtype, f"batch {k}: {batch[k].shape} {batch[k].dtype}")
    for m, st in zip(batch["masks"], (8, 16, 32)):
        check(m.shape == (b, IMGSZ // st, IMGSZ // st, 1) and m.dtype == np.float32, f"masks /{st}: {m.shape}")
        check(bool(((m >= 0) & (m <= 1)).all()) and (prob or bool(np.isin(m, (0.0, 1.0)).all())),
              f"mask values at /{st}")
    valid = batch["mask_gt"]
    check(bool(np.isin(valid, (0.0, 1.0)).all()) and bool((np.diff(valid, axis=1) <= 0).all()),
          "mask_gt is not a prefix of ones")
    boxes = batch["gt_boxes"][valid > 0]
    check(bool((boxes[:, 2:] > boxes[:, :2]).all() and (boxes >= 0).all() and (boxes <= IMGSZ).all()),
          "boxes outside the image or empty")
    check(len(boxes) > 0, "a batch without boxes")
    return len(boxes)


def host_rate(np, loader, epochs: int) -> tuple[float, int, int]:
    """The loader alone over ``epochs`` epochs from epoch 0: (images/s,
    images, boxes), every batch checked."""
    n_img, n_boxes, t0 = 0, 0, time.perf_counter()
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        for batch in loader:
            n_boxes += check_batch(np, batch, TRAIN_BATCH)
            n_img += len(batch["image"])
    return n_img / (time.perf_counter() - t0), n_img, n_boxes


def in_flight(loader) -> int:
    """Batches the loader builds at once, one thread each: at most
    ``prefetch`` (one more while a finished batch is handed over), never more
    than an epoch holds or than ``workers``."""
    return min(loader.workers, loader.prefetch + 1, len(loader))


def fed_steps(torch, np, loader, step, st, sched, n_steps: int):
    """``n_steps`` micro-steps of ``step`` fed by ``loader`` through
    ``to_device``, from a new epoch, after one untimed step. Returns the
    state, the last metrics and, per timed micro-step, (ms, ms waiting on
    the loader, whether its batch began an epoch)."""
    def batches():
        epoch = 1000
        while True:
            loader.set_epoch(epoch)
            for bi, batch in enumerate(loader):
                yield batch, bi == 0
            epoch += 1

    it = batches()
    st, _ = step(st, loader.to_device(next(it)[0]), *sched.at(st.step))  # first use: cuDNN plans, allocator
    torch.cuda.synchronize()
    rows = []
    for _ in range(n_steps):
        t1 = time.perf_counter()
        batch, first = next(it)
        check_batch(np, batch, TRAIN_BATCH)
        dev = loader.to_device(batch)
        t2 = time.perf_counter()
        st, metrics = step(st, dev, *sched.at(st.step))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rows.append(((t3 - t1) * 1e3, (t2 - t1) * 1e3, first))
        check(bool(torch.isfinite(metrics["loss"])), f"non-finite loss {float(metrics['loss'])}")
    return st, metrics, rows


def fed_summary(rows) -> str:
    """p50 (max), mean, img/s and the waiting share of micro-steps."""
    tot = sorted(r[0] for r in rows)
    wait = sorted(r[1] for r in rows)
    n, s_tot = len(rows), sum(tot)
    return (f"p50 {tot[n // 2]:.2f} ms, max {tot[-1]:.2f} ms, mean {s_tot / n:.2f} ms -> "
            f"{TRAIN_BATCH * n * 1e3 / s_tot:.1f} img/s; waiting on the loader (next batch + pinned copy "
            f"enqueued) p50 {wait[n // 2]:.2f} ms, {100 * sum(wait) / s_tot:.1f}% of the micro-step time")


def data_phase(torch, np, data_yaml, n_steps: int = 12) -> dict:
    """The port's data stack on the card's host (no OpenCV, no PyYAML):
    read the synthetic ARCADE-shaped dataset ``data_yaml`` (written by the
    port) through MGADataset and DataLoader on the shipped cbam_defaults
    profile, time the host pipeline alone, then feed the flagship's bf16
    train step from the loader through the pinned ``to_device`` copy. The
    64-image split has 4 batches an epoch, so the loader builds at most 4 at
    once and every fourth micro-step begins an epoch; the 256-image split
    (16 batches an epoch) shows the loader in its steady state, at its
    default prefetch and with all 8 threads at work."""
    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.config import load_config, seg_loss_config
    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.data.dataset import MGADataset
    from mga_yolo_tpu_torch.data.loader import DataLoader
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.train import optim
    from mga_yolo_tpu_torch.train import state as S

    native.load()  # raises with the compiler's message when g++ cannot build it
    print(f"[data] host C++ library loaded: {native.library_path().name}")
    kw = dict(data=str(data_yaml), imgsz=IMGSZ, batch=TRAIN_BATCH, workers=8, max_boxes=MAX_BOXES)
    cfg = load_config("configs/hyperparams/cbam_defaults.yaml", fraction=0.25, **kw)
    big_cfg = load_config("configs/hyperparams/cbam_defaults.yaml", **kw)
    a = cfg.augment
    print(f"[data] profile cbam_defaults: translate {a.translate} scale {a.scale} fliplr {a.fliplr} mosaic "
          f"{a.mosaic} hsv {(a.hsv_h, a.hsv_s, a.hsv_v)}; mask {cfg.mask.method}; {IMGSZ} px, batch "
          f"{TRAIN_BATCH}, {cfg.data.workers} workers, max_boxes {MAX_BOXES}")
    loader = DataLoader(MGADataset(cfg, "train", augment=True), TRAIN_BATCH, seed=0, workers=cfg.data.workers)
    big = DataLoader(MGADataset(big_cfg, "train", augment=True), TRAIN_BATCH, seed=0, workers=8)
    big8 = DataLoader(big.dataset, TRAIN_BATCH, seed=0, workers=8, prefetch=8)
    check(len(loader.dataset) == 64 and len(big.dataset) == 256, "the splits are not 64 and 256 images")

    for name, ld, epochs in (("64 images", loader, 2), ("256 images", big, 1),
                             ("256 images, prefetch 8", big8, 1)):
        rate, n_img, n_boxes = host_rate(np, ld, epochs)
        print(f"[data] host pipeline alone, {name}: {n_img} images in {len(ld) * epochs} batches "
              f"({len(ld)} an epoch, prefetch {ld.prefetch}, at most {in_flight(ld)} of {ld.workers} threads "
              f"at work) -> {rate:.1f} images/s ({n_boxes} boxes)")

    torch.manual_seed(0)
    model, _ = create_model(YOLOV8_CBAM, scale="n", nc=1, training=True)
    accumulate = max(round(NBS / TRAIN_BATCH), 1)
    sched = optim.Schedule(lr0=0.01, lrf=0.01, momentum=0.937, warmup_epochs=3.0, warmup_momentum=0.8,
                           warmup_bias_lr=0.1, epochs=100, steps_per_epoch=10)
    step = make_step(torch, model, accumulate, torch.bfloat16, warmup_steps=sched.warmup_steps)
    st = S.create_train_state(model)
    st.step = st.last_apply = sched.warmup_steps - 4
    zero_launches()
    st, metrics, rows = fed_steps(torch, np, loader, step, st, sched, n_steps)
    launches = read_launches()
    want = want_launches({"cam_gate": 3 * (n_steps + 1), "dfl_bwd": n_steps + 1})
    check(launches == want, f"[data] launches {launches} in {n_steps} + 1 micro-steps, want {want}")
    steady = [r for r in rows if not r[2]]
    print(f"[data] {n_steps} micro-steps B={TRAIN_BATCH}x{IMGSZ} bf16 fed by the loader, 64 images: "
          f"{fed_summary(rows)}; last loss {float(metrics['loss']):.4f}; launches {launches}")
    print(f"[data]   of which the {len(steady)} that begin no epoch: {fed_summary(steady)}")
    st, metrics, rows = fed_steps(torch, np, big, step, st, sched, n_steps)
    check(not any(r[2] for r in rows), "a timed micro-step of the 256-image split began an epoch")
    print(f"[data] {n_steps} micro-steps fed by the loader, 256 images (inside one epoch): "
          f"{fed_summary(rows)}; last loss {float(metrics['loss']):.4f}")

    pcfg = load_config("configs/hyperparams/cbam_defaults.yaml", MGA_PROB_MODE=True, fraction=0.25, **kw)
    ploader = DataLoader(MGADataset(pcfg, "train", augment=True), TRAIN_BATCH, seed=1, workers=8)
    pbatch = next(iter(ploader))
    check_batch(np, pbatch, TRAIN_BATCH, prob=True)
    pstep = make_step(torch, model, 1, torch.bfloat16, seg_cfg=seg_loss_config(pcfg))
    _, pm = pstep(st, ploader.to_device(pbatch), *sched.at(st.step))
    check(seg_loss_config(pcfg).prob_mode and bool(torch.isfinite(pm["loss"])), "MGA_PROB_MODE batch failed")
    print(f"[data] MGA_PROB_MODE batch (prob masks, method {pcfg.mask.prob_method}): loss "
          f"{float(pm['loss']):.4f}, seg items {[round(float(x), 4) for x in pm['items'][3:]]}")
    return launches


def fit_decode_agreement(torch, best: Path, data_yaml, trainer) -> None:
    """The val CLI and the trainer read best.pt alike: the CLI's eval
    function and a float32 eval step of the trainer's model on its state
    loaded from best.pt give the same decoded boxes and scores and mask
    logits on the first val batch, within the path tolerances, from the same
    letterboxed images. The mAP check alone cannot tell while both read 0;
    a model of other random weights must fail the same comparison (images
    mirrored cannot show a wrong letterbox: after a few tens of steps the
    eval-mode outputs hardly depend on the image, hence the input check)."""
    from mga_yolo_tpu_torch.cli import val as cli_val
    from mga_yolo_tpu_torch.config import det_loss_config, seg_loss_config
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.train.state import make_eval_step, normalize_images
    from mga_yolo_tpu_torch.utils.checkpoint import load_checkpoint

    def first(loader) -> dict:
        batch = dict(next(iter(loader)))
        batch.pop("index", None)
        return loader.to_device(batch)

    cli = cli_val.build_validator(cli_val.parse_args(["--weights", str(best), "--data", str(data_yaml),
                                                      "--batch", str(TRAIN_BATCH)]))
    batch, batch_t = first(cli.loader), first(trainer.val_loader)
    check(batch["image"].shape == batch_t["image"].shape and torch.equal(batch["image"], batch_t["image"]),
          "[fit] the val CLI's images differ from the trainer's (size or letterbox)")
    load_checkpoint(best, trainer.state)
    step = make_eval_step(trainer.model, trainer.strides, trainer.spec.nc, det_loss_config(trainer.cfg),
                          seg_loss_config(trainer.cfg))
    want = step(trainer.state, batch_t)
    torch.manual_seed(FIT_WRONG_SEED)
    other, _ = create_model("configs/models/yolov8_cbam.yaml", scale="n", nc=1)
    with torch.no_grad():
        out = other(normalize_images(batch["image"]))
    readings = {"val CLI": cli.eval_fn(None, batch),
                "other random weights": {"decoded": out["det"][0].float(), "seg": out["seg"]},
                "mirrored images": cli.eval_fn(None, {**batch, "image": batch["image"].flip(2)})}  # (B, H, W, 3)

    def errors(got) -> tuple:
        """Max abs errors (decoded, mask logits) and whether both are within tolerance."""
        pairs = [(got["decoded"], want["decoded"], PATH_ATOL)] + [
            (got["seg"][k].float(), want["seg"][k].float(), 1e-4) for k in want["seg"]]
        close = all(a.shape == b.shape and torch.allclose(a, b, rtol=PATH_RTOL, atol=atol) for a, b, atol in pairs)
        err = [float((a - b).abs().max()) if a.shape == b.shape else float("inf") for a, b, _ in pairs]
        return err[0], max(err[1:]), close

    res = {name: errors(got) for name, got in readings.items()}
    print(f"[fit] best.pt on {len(batch['image'])} val images (the same letterboxed images in both loaders) "
          f"against the trainer's float32 eval step, max abs "
          f"error (decoded px, mask logits) at rtol {PATH_RTOL}, atol {PATH_ATOL} / 1e-4: " + "; ".join(
              f"{name} {d:.4g}, {m:.4g} ({'within' if ok else 'outside'})" for name, (d, m, ok) in res.items()))
    check(res["val CLI"][2], "[fit] the val CLI's reading of best.pt disagrees with the trainer's")
    check(not res["other random weights"][2], "[fit] other random weights pass the comparison: it cannot tell "
                                              "a wrong checkpoint")


def fit_phase(torch, np, data_yaml, project) -> dict:
    """A whole training run of the flagship through the port's entry points:
    ``MGA(...).train`` on the 256-image set, validating on the 64-image val
    split each epoch, 3 epochs at 640 px, batch 16, nbs 64, bf16, 8 loader
    threads, the shipped cbam_defaults profile; the launch counters zeroed
    just before and read just after, and held to the run's micro-steps and
    validation batches exactly. Then a resume to epoch 4 in the same
    directory, the val CLI on best.pt (float32) against the trainer's own
    evaluation of the epoch that wrote it (bf16), and best.pt served through
    ``build_server`` and ``MicroBatcher``. Returns the first run's launches."""
    import csv
    from concurrent.futures import ThreadPoolExecutor

    from mga_yolo_tpu_torch.api import MGA
    from mga_yolo_tpu_torch.cli import val as cli_val
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.serve import build_server
    from mga_yolo_tpu_torch.utils.csvlog import HEADER_ORDER

    kw = dict(data=str(data_yaml), imgsz=IMGSZ, batch=TRAIN_BATCH, nbs=NBS, workers=8, max_boxes=MAX_BOXES,
              val=True, save=True, amp=True, project=str(project), name="fit")
    evals = {}  # epoch (0-based) -> the trainer's (mAP50, mAP50-95) of it, bf16

    def run(epochs: int, resume: bool):
        m = MGA("configs/models/yolov8_cbam.yaml", scale="n")
        zero_launches()
        t0 = time.perf_counter()
        final = m.train("configs/hyperparams/cbam_defaults.yaml", epochs=epochs, resume=resume, **kw)
        wall = time.perf_counter() - t0
        launches = read_launches()
        tr = m._trainer
        for st in tr.epoch_stats:
            evals[st["epoch"]] = (st["map50"], st["map"])
            v, secs = st["val_speed"], st["train_s"]
            print(f"[fit] epoch {st['epoch'] + 1}/{epochs}: train {secs:.2f} s, {st['images']} images in "
                  f"{st['steps']} micro-steps from step {st['step_start']} -> {st['images'] / secs:.1f} img/s, "
                  f"{100 * st['wait_s'] / secs:.1f}% waiting on the loader; val {st['val_s']:.2f} s, ms per image: "
                  f"preprocess {v['preprocess']:.2f}, inference {v['inference']:.2f}, postprocess "
                  f"{v['postprocess']:.2f}; mAP50 {st['map50']:.4f}, mAP50-95 {st['map']:.4f}; the checkpoint "
                  f"saves held the run {st['save_ms']:.1f} ms")
        steps = sum(st["steps"] for st in tr.epoch_stats)
        val_batches = (len(tr.epoch_stats) + 1) * len(tr.val_loader)  # each epoch's and the final evaluation
        want = want_launches({"cam_gate": 3 * (steps + val_batches), "dfl_bwd": steps, "nms_suppress": val_batches})
        check(launches == want, f"[fit] launches {launches} in {steps} micro-steps and {val_batches} validation "
                                f"batches, want {want}")
        v = final.speed
        print(f"[fit] to epoch {epochs}: {wall:.1f} s wall; final EMA evaluation mAP50 {final.metrics.map50:.4f}, "
              f"mAP50-95 {final.metrics.map:.4f}, ms per image preprocess {v['preprocess']:.2f}, inference "
              f"{v['inference']:.2f}, postprocess {v['postprocess']:.2f}; launches {launches} ({steps} micro-steps, "
              f"{val_batches} validation batches)")
        return tr, launches

    def rows(tr) -> list:
        with open(tr.save_dir / "results.csv", newline="") as f:
            out = list(csv.DictReader(f))
        check(bool(out) and list(out[0])[:len(HEADER_ORDER)] == HEADER_ORDER, "results.csv lacks the reference columns")
        losses = [float(r[k]) for r in out for k in HEADER_ORDER if k.startswith(("train/", "val/"))]
        check(all(np.isfinite(losses)), "a non-finite loss item in results.csv")
        return out

    tr, launches = run(FIT_EPOCHS, False)
    check(tr.start_epoch == 0 and len(tr.epoch_stats) == FIT_EPOCHS
          and [st["steps"] for st in tr.epoch_stats] == [len(tr.train_loader)] * FIT_EPOCHS,
          f"[fit] ran epochs {[st['epoch'] for st in tr.epoch_stats]}")
    check(len(rows(tr)) == FIT_EPOCHS, "[fit] results.csv does not have a row per epoch")
    weights = tr.save_dir / "weights"
    for name in ("best.pt", "best.meta.json", "last.pt", "last.meta.json"):
        check((weights / name).is_file(), f"[fit] {weights / name} missing")

    res, _ = run(FIT_EPOCHS + 1, True)
    epochs = [r["epoch"] for r in rows(res)]
    check(res.save_dir == tr.save_dir and res.start_epoch == FIT_EPOCHS
          and res.epoch_stats[0]["step_start"] == tr.state.step, f"[fit] resume started at epoch {res.start_epoch}, "
          f"step {res.epoch_stats[0]['step_start']} (the first run ended at step {tr.state.step})")
    check(epochs == [f"{e + 1}.0" for e in range(FIT_EPOCHS + 1)], f"[fit] results.csv epochs {epochs} after resume")
    print(f"[fit] resume: started at epoch {res.start_epoch} (0-based) from step {res.epoch_stats[0]['step_start']} "
          f"in {res.save_dir.name}; results.csv epochs {epochs}")

    best = weights / "best.pt"
    best_epoch = json.loads((weights / "best.meta.json").read_text())["epoch"]
    val = cli_val.main(["--weights", str(best), "--data", str(data_yaml), "--batch", str(TRAIN_BATCH)])
    got, want = (val.metrics.map50, val.metrics.map), evals[best_epoch]
    print(f"[fit] val CLI on best.pt (epoch {best_epoch + 1}), float32: mAP50 {got[0]:.4f}, mAP50-95 {got[1]:.4f}; "
          f"the trainer's evaluation of that epoch, bf16: mAP50 {want[0]:.4f}, mAP50-95 {want[1]:.4f}")
    check(all(np.isfinite(got)) and all(0 <= x <= 1 for x in got)
          and all(abs(a - b) <= FIT_VAL_TOL for a, b in zip(got, want)), "[fit] the val CLI disagrees with the trainer")

    fit_decode_agreement(torch, best, data_yaml, res)

    server = build_server(best, imgsz=IMGSZ, batch=BATCH, conf=0.001, port=0)
    try:
        imgs = [image_io.imread(p) for p in sorted((Path(data_yaml).parent / "images" / "val").iterdir())[:8]]
        with ThreadPoolExecutor(4) as pool:
            preds = list(pool.map(server.batcher.submit, imgs))
        n_boxes = 0
        for img, pred in zip(imgs, preds):
            b = pred.boxes
            h, w = img.shape[:2]
            check(bool(np.isfinite(b).all()) and bool((b[:, :4] >= 0).all()) and bool((b[:, [0, 2]] <= w).all())
                  and bool((b[:, [1, 3]] <= h).all()), "[fit] a served box is not finite or outside its image")
            n_boxes += len(b)
        print(f"[fit] served best.pt: {len(imgs)} requests through MicroBatcher, {n_boxes} boxes, all finite and "
              f"inside their images; {server.batcher.stats()}")
    finally:
        server.httpd.server_close()
        server.batcher.close()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a CUDA card only", file=sys.stderr)
        return 1
    import numpy as np

    from mga_yolo_tpu_torch.configs import YOLOV8, YOLOV8_CBAM, YOLOV8_ECA, YOLOV8_SPADE
    from mga_yolo_tpu_torch.data.synthetic import write_synthetic_dataset
    from mga_yolo_tpu_torch.kernels import _build
    from mga_yolo_tpu_torch.models.yolo import create_model

    t_start = time.perf_counter()
    card = gpu_name_and_power()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    secs = _build.build(["cam_gate", "nms_suppress", "dfl_bwd", "masked_pool"])
    print(f"[build] {time.perf_counter() - t0:.2f} s wall, per source {secs}")
    for name in secs:
        log = _build.library_path(name).with_suffix(".log").read_text().strip()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    kernels = [kernel_phase_cam(torch), kernel_phase_nms(torch), kernel_phase_dfl(torch),
               kernel_phase_pool(torch)]
    kernel_phase_cam_grad(torch)
    kernel_phase_pool_grad(torch)

    # (path-name suffix, config, attention kernel, tag suffix, MicroBatcher round, timed micro-steps,
    #  parity phases); SPADE and plain YOLOv8 have no attention kernel
    paths = {}
    short = dict(n_requests=8, n_threads=2)
    for name, cfg, attn, sfx, serve_kw, n_timed, parity in (
            ("", YOLOV8_CBAM, "cam_gate", "", {}, 12, True),
            ("_eca", YOLOV8_ECA, "masked_pool", "-eca", short, 8, True),
            ("_spade", YOLOV8_SPADE, None, "-spade", short, 8, True),
            ("_base", YOLOV8, None, "-base", short, 8, False)):
        torch.manual_seed(0)
        model, _ = create_model(cfg, scale="n", nc=1)
        if parity:
            parity_phase(torch, np, model, attn, sfx)
        paths["serve" + name] = path_phase(torch, np, model, attn, sfx, **serve_kw)
        if parity:
            train_parity_phase(torch, np, model, attn, sfx)
        paths["train" + name] = train_phase(torch, np, model, attn, sfx, n_timed=n_timed, seg=name != "_base")
        del model
    paths["train_prob"] = train_prob_phase(torch, np)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:  # a scratch directory git ignores
        t0 = time.perf_counter()
        data_yaml = write_synthetic_dataset(Path(tmp) / "ds", n=256, size=512, max_boxes=MAX_BOXES, seed=0,
                                            n_val=64)
        print(f"[data] wrote 256 + 64 (val) grey 512x512 PNGs, their masks and labels in "
              f"{time.perf_counter() - t0:.2f} s")
        paths["train_data"] = data_phase(torch, np, data_yaml)
        paths["fit"] = fit_phase(torch, np, data_yaml, Path(tmp) / "runs")
    # each kernel's launches are those of this slice's path first (the
    # training run), then the earlier slices' (the loader-fed train step,
    # prob_mode, SPADE, plain YOLOv8), else MaskECA's, else the flagship's
    order = ("fit", "train_data", "train_prob", "serve_spade", "train_spade", "serve_base", "train_base",
             "train_eca", "serve_eca", "train", "serve")
    for k in kernels:
        by_path = {p: counts[k["name"]] for p, counts in paths.items()}
        k["launches_by_path"] = by_path
        k["launches"] = next((by_path[p] for p in order if by_path[p]), 0)
        check(k["launches"] > 0, f"{k['name']} was not launched on its path")

    print(f"[done] the whole run took {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
