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
             gradients against plain autograd; the masked reductions
             (``csrc/masked_reductions.cu``, which the spatial mesh runs on
             each band) at the band shapes of a 640 px row split in two, in
             bf16 and float32, on rows TMA cannot take, channel slices, a
             plane larger than a stage, fewer groups than SMs, no-pixel and
             tiny masks and ten calls captured in a graph, with each band's
             time warm (inputs in L2) and cold (a 64 MB write between calls).
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
   data-dev — device-side augmentation (``augment.on_device``) on the same
             256 images: a batch of the raw loader finished on the card by
             ``device_augment.make_augment_fn`` against the host pipeline's
             batch of the same seeds (the profile's S canvas, and mosaic +
             HSV on the 2S canvas; every augment tensor on the card); the
             raw host pipeline's images/s alone and the bytes a batch copies;
             the augment's device kernels; 12 micro-steps of phase 8's step
             fed by the raw loader and the augment, beside phase 8's
             host-fed ones, with launches exact.
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
   fit-dev — one epoch of ``MGA.train`` with ``augment.on_device`` (the S
             canvas), validated: the trainer must take the device path;
             launches exact.
   predict — on best.pt: ``cli.predict`` over the 64 val PNGs (images/s,
             files written, 3 CAM gates a batch exactly); the predictor's
             decoded output and mask logits against a float32 eval step of
             the trainer's model, within the path tolerances; ``cli.ckpt
             export-torch`` and the exported file served; ``cli.serve``
             started as a process on ``--port 0`` answering 4 PNG POSTs,
             then interrupted; ``cli.profile`` at 640 px against
             ``count_gflops``.
Then data parallelism (``mga_yolo_tpu_torch/parallel``), with ranks that
share the one card: they show the step is right and what the collectives
cost, not scaling.
10. ddp    — two gloo ranks spawned on ``cuda:0`` (NCCL refuses two ranks on
             one device), each on the strided half of 16-image global
             batches at 640 px: 4 float32 micro-steps (TF32 off, one apply)
             against one process on the whole batches (items and BN
             statistics within train-parity's rtol) and against the same
             step in float64 (parameters, EMA and momentum: a root-mean-square
             error at most twice one float32 process's, a max error within
             fixed limits), the two ranks bit-equal; then 8 bf16 micro-steps
             a rank: p50, collectives per micro-step, the gradient
             all-reduce's ms; launches exact.
    ddp-nccl — one rank in an NCCL group: 4 bf16 micro-steps bit-equal to
             the no-group step (cuDNN deterministic), the same launches.
    ddp-fit — two gloo ranks on ``cuda:0`` run ``MGA.train`` for one
             validated epoch on the first 128 + 32 of the 256 + 64 images
             (``MESH_FIT_FRACTION``; global batch 16): rank 0 alone writes
             results.csv and weights/, both ranks compute the same rows and
             metrics, launches exact (a rank: 8 micro-steps and 2 + 2
             validation batches of 8 images).
Then the spatial mesh axis (``mesh_spatial``, ``parallel/spatial.py``), with
two ranks sharing the card on a 1x2 mesh (each holds every image and half
of its rows): it shows the step is right and what the halo exchanges and
space collectives cost, not a benefit (one image fits one card at 640 px).
11. spatial — ``[ddp]``'s 4 float32 micro-steps of its 16-image global
             batches on the 1x2 mesh, held to one process and the float64
             step by ``[ddp]``'s method, the ranks bit-equal; the
             space-reduced pools against the plain versions with a max tied
             across the bands; then 8 bf16 micro-steps a rank: p50, halo
             exchanges and space collectives per micro-step; launches exact.
    spatial-fit — ``MGA.train`` with ``mesh_spatial: 2`` for one validated
             epoch on ``[ddp-fit]``'s 128 + 32 images: launches exact (a
             rank: 8 micro-steps and 2 + 2 validation batches of 16 images'
             bands), rank 0 alone writes.
    spatial-fit-dev — the same with ``augment.on_device``: each rank
             warps the whole canvases, then keeps its band; the same
             launches, both ranks on the device path.
Then the baseline toolchain and the experiment grid:
12. base   — ``tools.train`` (plain YOLOv8n, base_defaults, bf16, batch 16)
             for one validated epoch on the 256 + 64 images, launches exact
             (DFL backward and NMS; no attention kernel); ``tools.val
             --save-fm`` on its best.pt: metrics.json equal to ``cli.val``'s
             at conf 0.001 / iou 0.7, the layer 15/18/21 maps NHWC at
             80/40/20 rows, and without matplotlib (the card's host) no
             feature-map PNG and the message that says so.
    grid   — ``scripts.performance_comparison`` on a two-job experiment
             (cbam and eca, scale n, one epoch on 64 of the 256 images and
             16 of the 64 val images, ``slots: 2``: both on the card at
             once), then
             ``scripts.base_comparison`` with one job; every job ``done``
             with progress ``1/1`` parsed from its output, each run with
             its results.csv and weights/best.pt. The jobs are child
             processes, so their runs' results are the check, not the
             launch counters.
13. export — the TFLite / SavedModel export (``mga_yolo_tpu_torch/export``).
             The card's host has no TensorFlow: ``cli.ckpt export-tflite``
             and ``export-savedmodel`` on best.pt, ``load_predictor`` of a
             ``.tflite`` and ``cli.val`` on one must each raise an
             ImportError naming tensorflow, write nothing and launch
             nothing. Where TensorFlow imports, best.pt is exported at
             640 px, the file held to the port's forward on the card
             within ``EXPORT_TOL``, and ``cli.val`` run on it with the NMS
             on the card (launches exact).
14. jpeg   — the image codecs of the host C++ library (``native/jpeg.cpp``,
             ``native/bmp.cpp``), built on the card's host: the committed
             fixtures (``tests/jpeg_fixtures``) decoded equal to cv2's
             pixels, colour and grey; decode ms per image (1 and 8 threads)
             of a 512 px grey file, baseline and progressive, and a 640 px
             BGR one; encode ms; the flagship behind ``MGAServer`` answering
             64 JPEG uploads from 4 threads with the boxes of the port's
             decode of the same bytes (launches exact), requests/s beside
             PNG uploads of the same pictures; 4 + 1 micro-steps fed from
             64 JPEG training files through MGADataset and DataLoader
             (launches exact) beside the same pictures as PNG; ``cli.predict``
             over a JPEG directory writing ``{stem}_pred.jpg``.
15. video  — the video path (``data/video_io.py`` on ``native/mpeg4.cpp``,
             ``native/yuv.cpp`` and ``native/jpeg.cpp``'s planes): the
             committed clips (``tests/video_fixtures``) held to cv2's
             frames; 64 synthetic 512 px angiograms written as an MJPG
             .avi and an mp4v .mp4 and read back (count, fps, PSNR);
             decode and encode ms a frame; ``cli.predict`` over both clips
             and two images on best.pt: the JAX package's file names, the
             annotated videos' frame counts and fps, each frame's boxes
             against the predictor's (launches exact); frames/s.
16. formats — the still formats of the JAX package's ``IMG_EXTS`` (PNG at
             every bit depth and Adam7, TIFF, WebP; ``data/image_io.py``
             on ``native/maskops.cpp``, ``native/tiff.cpp``,
             ``native/webp.cpp``): the committed fixtures
             (``tests/still_fixtures``) decoded equal to cv2's pixels,
             colour and grey; decode ms of a 512 px grey angiogram as a
             16-bit PNG, an LZW TIFF, a lossless and a lossy WebP; the
             flagship behind ``MGAServer`` answering 16-bit PNG, LZW TIFF,
             eXIf-turned PNG and WebP uploads with the boxes of the port's
             decode of the same bytes (launches exact); 4 + 1 micro-steps
             fed from 64 16-bit PNGs with 1-bit PNG masks, then from 64 LZW
             TIFFs with TIFF masks (launches exact).
17. formats2 — the formats only cv2 gave the JAX package until now: CCITT
             TIFF masks, GIF as a still and as a video, PNM / PAM / PFM,
             Sun raster and Radiance HDR (``native/tiff.cpp``,
             ``native/gif.cpp``, ``native/raster.cpp``): the committed
             fixtures (``tests/format_fixtures``) equal to cv2's pixels and
             cv2.VideoCapture's frames; decode ms of 640 px files; the
             flagship behind ``MGAServer`` answering uploads of each
             (launches exact); 2 + 1 micro-steps fed from PNGs with T.6
             TIFF masks whose pyramids equal the PNG masks'; ``cli.predict``
             over two GIF clips, its ``_pred.mp4`` read back (launches
             exact).
18. matroska — Matroska and WebM (``data/video_io.py``'s EBML demuxer and
             muxer, ``native/vp8.cpp``'s VP8 key and inter frames): the
             committed ``.mkv`` / ``.webm`` fixtures equal to cv2's frame
             digests, fps, counts and fourccs; VP8 decode ms a frame at
             512 px, key and inter frames apart; ``cli.predict`` on the
             seeded flagship over a 512 px VP8 WebM and an MJPEG ``.mkv``
             (launches exact, boxes against the predictor's); the ``.mkv``
             writer read back.
19. mpeg —   MPEG-1 and MPEG-2 (``data/video_io.py``'s MPEG-PS demuxer,
             ``native/mpeg12.cpp``): the committed fixtures of
             ``tests/video_fixtures/mpeg.json`` equal to cv2's frame
             digests, fps, counts and fourccs (odd heights too);
             MPEG-2 decode ms a picture at 512 px, I, P and B apart;
             ``cli.predict`` on the seeded flagship over a 512 px MPEG-2
             ``.mpg`` and an MPEG-1 ``.mpeg`` (launches exact, boxes against
             the predictor's); the writer's ``.mpg``, ``.wmv`` and numbered
             ``.gif`` equal to the CPU run's bytes, the ``.mpg`` read back.
20. asp —    MPEG-4 Part 2 Advanced Simple profile (``native/mpeg4.cpp``,
             ``native/xvid_idct.h``): the committed fixtures of
             ``tests/video_fixtures/asp.json`` equal to cv2's frame digests,
             fps, counts and fourccs (B-VOPs in four containers, packed
             DivX, MPEG matrices, quarter-sample, data partitioning, a bare
             .m4v, the XviD IDCT), the interlaced ones' planes to the CPU
             run's libavcodec digests; decode ms a VOP at 512 px, I, P and B
             apart; ``cli.predict`` on the seeded flagship over an XviD
             512 px ``.avi`` and a packed DivX one (launches exact, boxes
             against the predictor's).
21. wmv —    ASF and the MS-MPEG-4 family (``native/msmpeg4.cpp``,
             ``native/h263.h``, ``data/video_io.py``'s ASF demuxer): the
             committed fixtures of ``tests/video_fixtures/wmv.json`` (WMV1,
             WMV2, MP42, MP43 in ASF, AVI and Matroska; mp4v, XVID, MJPG
             and MPEG-1/2 in ASF) equal to cv2's frame digests, fps, counts and fourccs;
             decode ms a picture at 512 px, I and P apart, for WMV2 and
             MP43; ``cli.predict`` on the seeded flagship over a WMV2
             ``.wmv`` and an MP43 ``.avi`` (launches exact, boxes against
             the predictor's); the writer's ``.wmv`` read back.
22. h264 —   H.264, the progressive tools of the Baseline, Main and High
             profiles (``native/h264.cpp``, ``native/h264_tables.h``,
             ``data/video_io.py``'s avc1 / avcC, ``V_MPEG4/ISO/AVC`` and AVI
             ``H264`` tracks): the committed fixtures of
             ``tests/video_fixtures/h264.json`` (the tests' writer's syntax
             clips over every tool the decoder counts: CAVLC and CABAC, I, P
             and B slices, direct prediction, weights, the 8x8 transform,
             scaling matrices; a 512 px angiogram in the Baseline and in the
             High profile, each in MP4 and Matroska) checked by their own
             SHA-256 and equal to cv2's frame digests, fps, counts and
             fourccs, every tool counted; decode ms a 512 px Baseline I and
             P picture, and a 512 px High (CABAC, 8x8 transform) IDR, P and
             B picture; ``cli.predict`` on the seeded flagship over the
             Baseline and the High 512 px ``.mp4``, 16 frames in one batch
             (exactly 3 CAM-gate launches, boxes equal to the predictor's,
             max error 0); cv2's one-row MJPG clips against their digests.
23. lossless — PNG frames, FFV1, HuffYUV and FFVHuff (``native/ffv1.cpp``,
             ``native/huffyuv.cpp``, ``data/video_io.py``'s lossless codecs
             in AVI, Matroska, MP4 / MOV and ASF): the committed fixtures of
             ``tests/video_fixtures/lossless.json`` checked by their own
             SHA-256 and equal to cv2's frame digests (libpng's for the Adam7
             clip), fps, counts and fourccs, every tool of ``FFV1_TALLY`` and
             ``HUFFYUV_TALLY`` counted; decode ms a 512 px frame by codec and
             pixel format (FFV1 grey, HuffYUV RGB24) and of the conversion;
             ``cli.predict`` on the seeded flagship over the FFV1 ``.mkv``
             and the HuffYUV ``.avi``, 16 frames in one batch (exactly 3
             CAM-gate launches, boxes equal to the predictor's, max error 0).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing
no result, when CUDA is unavailable or any phase fails.

``python3 chip_smoke.py --ddp-alone`` runs ``[ddp]`` alone;
``python3 chip_smoke.py --ddp-faults`` runs it on copies of the checkout,
unchanged and with each planted fault of ``DDP_FAULTS`` (a BatchNorm or
gradient all-reduce dropped, per-rank statistics, the unbiased variance),
and exits non-zero unless the first passes and every fault fails.
``--spatial-alone`` and ``--spatial-faults`` do the same for ``[spatial]``
and ``SPATIAL_FAULTS`` (a halo row dropped, the reductions not all-reduced
over the space ranks, the detection loss counted k times, the max's ties
counted on one band). ``--formats-alone`` and ``--formats2-alone`` run
``[formats]`` and ``[formats2]`` alone, on a synthetic set of 64 + 16
images (``[formats2]``'s ``cli.predict`` on the seeded flagship);
``--matroska-alone``, ``--mpeg-alone``, ``--asp-alone``, ``--wmv-alone``,
``--h264-alone`` and ``--lossless-alone`` run ``[matroska]``, ``[mpeg]``,
``[asp]``, ``[wmv]``, ``[h264]`` and ``[lossless]`` alone.
``--reductions-alone [PARENT]`` runs the masked reductions' ``[kernels]``
phase alone, then times the planner's plan beside two others at the band
shapes; given PARENT, an unpacked checkout of an earlier commit whose
``csrc/masked_pool.cu`` has the ``masked_reductions_launch`` entry, it
builds that and times it beside the new kernel in turns (parent, new, new,
parent), warm and cold.
"""

from __future__ import annotations

import json
import struct
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

KERNEL_SOURCES = ("cam_gate", "nms_suppress", "dfl_bwd", "masked_pool", "masked_reductions")  # csrc/<name>.cu
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
    from mga_yolo_tpu_torch.ops import cam_gate, dfl_bwd, masked_pool, masked_reductions, nms

    return {"cam_gate": cam_gate, "nms_suppress": nms, "dfl_bwd": dfl_bwd, "masked_pool": masked_pool,
            "masked_reductions": masked_reductions}


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


def time_ms(torch, fn, iters: int, reps: int = 5, after=None, before_each=None) -> float:
    """Median device ms of one ``fn()`` call: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events (so host launch
    overhead is not counted). ``after()``, if given, runs once the timed
    replays are done, while the graph's outputs are alive;
    ``before_each()``, if given, is captured before each call (and timed
    with it)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            if before_each is not None:
                before_each()
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


def device_kernels(torch, fn, n: int = 10, fixed: bool = True) -> tuple[float, dict]:
    """Device kernels that one ``fn()`` call runs, and device ms per call by
    kernel name (torch.profiler over ``n`` calls, after a warm call). Now
    and then the profiler's trace comes back without a single device event
    (one session of about fifty on the card, on code that traced before and
    after), or without one of them (19 events for 10 calls of a function
    that launches the same 2 kernels on every call); such a trace, where a
    kernel's count is not a whole multiple of ``n`` though ``fixed`` says
    every call launches the same kernels, is profiled again, at most twice."""
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
        if rows and (not fixed or all(e.count % n == 0 for e in rows)):
            break
        print(f"[kernels] the profiler saw {sum(e.count for e in rows)} device events in {n} calls "
              f"({', '.join(f'{e.key[:40]} {e.count}' for e in rows)}); profiling again")
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


RED_SHAPES = tuple((h // 2, w, c) for h, w, c in POOL_SHAPES)  # a band of a 640 px row split in two: 40/20/10 rows
RED_TOL = (1e-5, 1e-6)  # the sums / N: float32 sums in another order (both dtypes sum in float32)
FLUSH_BYTES = 64 << 20  # written between the cold calls: more than the card's 50 MB L2
ROUTES = ("registers, element loads", "TMA bulk copies", "registers, 16-byte loads")  # ELEMENTS, BULK, VECTORS
RED_MORE = ((TRAIN_BATCH, 80, 160, 64), (TRAIN_BATCH, 40, 80, 128), (TRAIN_BATCH, 20, 40, 256),  # 1280 px bands
            (TRAIN_BATCH, 160, 320, 64),  # a 2560 px image's P3 band: bulk copies, 25 chunks
            (1, 320, 320, 8),             # bulk copies: 8 blocks, planes of 7 chunks
            (300, 4, 8, 8),               # 16-byte loads: an image a block
            (4, 41, 43, 64))              # rows not on 16 bytes: element loads


def cold_ms(torch, fn, iters: int = 20) -> float:
    """Device ms of one ``fn()`` call on inputs out of L2: ``iters`` calls,
    each after a FLUSH_BYTES write, captured in a graph, less the writes'
    own time in a graph of their own (the same count)."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def write():
        flush.fill_(1)

    both = time_ms(torch, fn, iters=iters, before_each=write)
    alone = time_ms(torch, lambda: None, iters=iters, before_each=write)
    return both - alone


def parent_reductions(torch, root: Path):
    """The parent commit's 3b entry (``csrc/masked_pool.cu``
    ``masked_reductions_launch``, #3's grid and plan) built from ``root``
    (an unpacked checkout of it) into the build directory: a function of
    (x, m) writing the five reductions as that commit's wrapper did."""
    import ctypes

    from mga_yolo_tpu_torch.kernels import _build
    from mga_yolo_tpu_torch.ops.masked_pool import DTYPES, pool_plan

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / "parent_masked_pool.so"
    run = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(root / "mga_yolo_tpu_torch" / "csrc" / "masked_pool.cu")],
                         capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, f"[kernels] the parent's masked_pool.cu did not build:\n{run.stdout}{run.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.masked_reductions_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 6)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def run_parent(x, m):
        B, C, H, W = x.shape
        tile, wpc, _ = pool_plan(B, C, n_sm)
        out = torch.empty((3 * B * C + 2 * B,), dtype=torch.float32, device=x.device)
        msum, cnt, wsum, gsum, mmax = out.split([B, B, B * C, B * C, B * C])
        err = fn(DTYPES[x.dtype], x.data_ptr(), m.data_ptr(), x.stride(0), x.stride(1), m.stride(0), B, C, H * W,
                 tile, wpc, msum.data_ptr(), wsum.data_ptr(), gsum.data_ptr(), mmax.data_ptr(), cnt.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        _build.check(err, "parent masked_reductions_launch")
        return msum.view(B, 1), wsum.view(B, C), gsum.view(B, C), mmax.view(B, C), cnt.view(B, 1)

    return run_parent


def kernel_phase_reductions(torch, parent: Path | None = None) -> dict:
    """The masked reductions (``csrc/masked_reductions.cu``) against the
    plain version (``reduction_buffers_ref``) on the spatial path's band
    shapes (B=16, 40/20/10 rows of 80/40/20, C=64/128/256) in bf16 and
    float32 and those of a 1280 px image, on rows not on 16 bytes (N = 41 x
    43), channel slices at an aligned and an unaligned offset, planes larger
    than a stage, fewer groups than SMs, several groups a block, the
    no-pixel and tiny masks, and ten calls captured in a CUDA graph replayed
    on new inputs, every route: msum, wsum and gsum / N within ``RED_TOL``,
    mmax and cnt exact; one launch and one device kernel a call. Its time at
    the band shapes (bf16), CUDA events over graph replays, warm (the same
    inputs, in L2) and cold (:func:`cold_ms`), beside the plain version's
    and the bound; with ``parent``, the parent commit's kernel built from
    that checkout, timed in turns (parent, new, new, parent, twice) in both
    conditions, at those shapes and at one shape of each other route
    (``RED_MORE``)."""
    from mga_yolo_tpu_torch.ops import masked_reductions as mr

    max_err = 0.0
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}

    def compare(got, x, m, what: str) -> float:
        want = mr.masked_reductions_ref(x, m)
        torch.cuda.synchronize()
        n = x.shape[2] * x.shape[3]
        errs = []
        for name, g, w in zip(("msum", "wsum", "gsum", "mmax", "cnt"), got, want):
            check(g.dtype == torch.float32 and g.shape == w.shape, f"{what} {name}: {g.dtype} {tuple(g.shape)}")
            if name in ("mmax", "cnt"):
                torch.testing.assert_close(g, w, rtol=0, atol=0, msg=lambda e: f"{what} {name}: {e}")
            else:
                torch.testing.assert_close(g / n, w / n, rtol=RED_TOL[0], atol=RED_TOL[1],
                                           msg=lambda e: f"{what} {name} / N: {e}")
            errs.append(float(((g - w) / (1 if name in ("mmax", "cnt") else n)).abs().max()))
        return max(errs)

    def case(x, m, what: str) -> None:
        nonlocal max_err
        B, C, H, W = x.shape
        aligned = mr.tma_rows(x.data_ptr(), m.data_ptr(), x.stride(0), x.stride(1), m.stride(0), H * W,
                              x.element_size())
        p = mr.reductions_plan(B, C, H * W, x.element_size(), n_sm, aligned)
        before = mr.launches
        got = mr.masked_reductions(x, m)
        check(mr.launches == before + 1, f"{what}: {mr.launches - before} launches")
        check(len({t.untyped_storage().data_ptr() for t in got}) == 1, f"{what}: outputs in several allocations")
        err = compare(got, x, m, what)
        max_err = max(max_err, err)
        print(f"[kernels] masked_reductions {what}: {ROUTES[p.route]}, {p.q} group(s) an "
              f"image of <= {p.gmax} channels, {p.nch} chunk(s) of {p.L} px, {p.S} stage(s) of {p.stage} B, "
              f"{p.grid} blocks, {p.smem} B shared; max_abs_err (sums / N) {err:.3e}")

    cases = [(TRAIN_BATCH, h, w, c, dt, "random") for h, w, c in RED_SHAPES for dt in dts]
    cases += [(TRAIN_BATCH, 2 * h, 2 * w, c, "bf16", "random") for h, w, c in RED_SHAPES]  # a 1280 px image's
    cases += [(3, 41, 43, 72, "f32", "random"), (4, 41, 43, 64, "bf16", "random"),  # N odd: element loads
              (300, 3, 5, 8, "f32", "random"),            # element loads, an image a block
              (2, 160, 160, 8, "f32", "random"), (2, 160, 160, 8, "bf16", "random"),  # a row of 8 warps
              (1, 320, 320, 8, "f32", "random"), (1, 320, 320, 8, "bf16", "random"),  # bulk: planes over a stage
              (TRAIN_BATCH, 160, 320, 64, "bf16", "random"),  # bulk: a 2560 px image's P3 band
              (300, 4, 8, 8, "bf16", "random"),           # 16-byte loads, an image a block
              (300, 256, 264, 1, "bf16", "random"),       # bulk: several groups a block
              (1, 40, 80, 16, "bf16", "random"),          # 16 groups: fewer than the SMs
              (TRAIN_BATCH, 10, 20, 600, "bf16", "random"),  # 38 channels a group, 4 threads a row
              (TRAIN_BATCH, 20, 40, 128, "bf16", "no_pixel"), (TRAIN_BATCH, 40, 80, 64, "f32", "tiny")]
    for i, (b, h, w, c, dt, kind) in enumerate(cases):
        x, m = pool_inputs(torch, b, h, w, c, dts[dt], kind, seed=50 + i)
        case(x, m, f"B={b} {h}x{w} C={c} {dt} {kind}")
    x, m = pool_inputs(torch, TRAIN_BATCH, 20, 40, 128, torch.bfloat16, seed=60)
    case(x[:, 32:96], m, f"channel slice 32:96 of B={TRAIN_BATCH} 20x40 C=128 bf16 (aligned)")
    x, m = pool_inputs(torch, TRAIN_BATCH, 5, 7, 48, torch.bfloat16, seed=61)
    case(x[:, 7:40], m, f"channel slice 7:40 of B={TRAIN_BATCH} 5x7 C=48 bf16 (unaligned)")

    x, m = pool_inputs(torch, TRAIN_BATCH, 20, 40, 128, torch.bfloat16, seed=62)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mr.masked_reductions(x, m)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [mr.masked_reductions(x, m) for _ in range(10)]
    for seed in (63, 64):
        fresh = pool_inputs(torch, TRAIN_BATCH, 20, 40, 128, torch.bfloat16, seed=seed)
        x.copy_(fresh[0])
        m.copy_(fresh[1])
        graph.replay()
        for i, got in enumerate(outs):
            max_err = max(max_err, compare(got, x, m, f"masked_reductions graph replay {seed}, call {i}"))
    del graph, outs
    print("[kernels] masked_reductions: ten calls captured in a CUDA graph, replayed on two new inputs, each "
          "equal to the plain version")

    run_parent = parent_reductions(torch, parent) if parent is not None else None
    ms = cold = plain = bound = 0.0
    parent_ms = {"warm": 0.0, "cold": 0.0}
    card = gpu_name_and_power()
    timers = (("warm", lambda f: time_ms(torch, f, iters=50)), ("cold", lambda f: cold_ms(torch, f)))

    def timed(b, h, w, c):
        """One shape in bf16: the kernel's device kernels a call, its bound,
        and with the parent, both timed in turns; (warm, cold, parent warm,
        parent cold, bound, plan, the turns' text)."""
        nonlocal max_err
        x, m = pool_inputs(torch, b, h, w, c, torch.bfloat16, seed=b + c)
        kernel = lambda: mr.masked_reductions(x, m)  # noqa: E731
        n_kern, by_name = device_kernels(torch, kernel)
        check(n_kern == 1, f"masked_reductions ran {n_kern} device kernels per call at {b}x{h}x{w}x{c}, want 1")
        n = h * w
        b_ms, _ = bound_ms(2 * (b * n * c + b * n) + 4 * (3 * b * c + 2 * b), b * (4 * n * c + 2 * n))
        aligned = mr.tma_rows(x.data_ptr(), m.data_ptr(), x.stride(0), x.stride(1), m.stride(0), n, 2)
        plan = mr.reductions_plan(b, c, n, 2, torch.cuda.get_device_properties(0).multi_processor_count, aligned)
        if run_parent is None:
            return time_ms(torch, kernel, iters=50), cold_ms(torch, kernel), None, None, b_ms, plan, by_name, ""
        max_err = max(max_err, compare(run_parent(x, m), x, m, f"the parent's masked_reductions {b}x{h}x{w}x{c}"))
        parent_fn = lambda: run_parent(x, m)  # noqa: E731
        turns = {}
        for cond, timer in timers:
            got = {"new": [], "parent": []}
            for who in ("parent", "new", "new", "parent") * 2:
                got[who].append(timer(kernel if who == "new" else parent_fn))
            turns[cond] = got
        mean = {cond: {who: sum(v) / len(v) for who, v in t.items()} for cond, t in turns.items()}
        text = "; " + "; ".join(
            f"{cond}: new {' / '.join(f'{v * 1e3:.3f}' for v in t['new'])} us, parent "
            f"{' / '.join(f'{v * 1e3:.3f}' for v in t['parent'])} us" for cond, t in turns.items()
        ) + " (turns parent, new, new, parent, twice)"
        return (mean["warm"]["new"], mean["cold"]["new"], mean["warm"]["parent"], mean["cold"]["parent"], b_ms, plan,
                by_name, text)

    for h, w, c in RED_SHAPES:
        b = TRAIN_BATCH
        k_warm, k_cold, p_warm, p_cold, b_ms, plan, by_name, extra = timed(b, h, w, c)
        if p_warm is not None:
            parent_ms["warm"] += p_warm
            parent_ms["cold"] += p_cold
        x, m = pool_inputs(torch, b, h, w, c, torch.bfloat16, seed=b + c)
        p_ms = time_ms(torch, lambda: mr.masked_reductions_ref(x, m), iters=10)
        ms, cold, plain, bound = ms + k_warm, cold + k_cold, plain + p_ms, bound + b_ms
        print(f"[kernels] masked_reductions B={b} {h}x{w} C={c} bf16 ({ROUTES[plan.route]}): warm {k_warm * 1e3:.3f} "
              f"us, cold {k_cold * 1e3:.3f} us (plain {p_ms * 1e3:.1f} us; bound {b_ms * 1e3:.3f} us by bytes: "
              f"{b_ms / k_warm:.0%} warm, {b_ms / k_cold:.0%} cold); 1 device kernel per call (profiler: "
              f"{', '.join(f'{k} {v * 1e3:.2f} us' for k, v in by_name.items())}){extra}; {card}")
    print(f"[kernels] masked_reductions, the three bands of a micro-step (bf16): warm {ms * 1e3:.3f} us, cold "
          f"{cold * 1e3:.3f} us, bound {bound * 1e3:.3f} us ({bound / ms:.0%} / {bound / cold:.0%})"
          + (f"; the parent's warm {parent_ms['warm'] * 1e3:.3f} us, cold {parent_ms['cold'] * 1e3:.3f} us"
             if run_parent is not None else "") + f"; {card}")
    if run_parent is not None:
        for b, h, w, c in RED_MORE:
            k_warm, k_cold, p_warm, p_cold, b_ms, plan, _, extra = timed(b, h, w, c)
            print(f"[kernels] masked_reductions B={b} {h}x{w} C={c} bf16 ({ROUTES[plan.route]}, {plan.grid} blocks, "
                  f"{plan.nch} chunk(s), {plan.S} stage(s)): warm {k_warm * 1e3:.3f} us against the parent's "
                  f"{p_warm * 1e3:.3f}, cold {k_cold * 1e3:.3f} against {p_cold * 1e3:.3f} (bound "
                  f"{b_ms * 1e3:.3f} us){extra}; {card}")
    out = {"name": "masked_reductions", "route": "cuda", "source": "mga_yolo_tpu_torch/csrc/masked_reductions.cu",
           "replaces": "mga_yolo_tpu/ops/pallas/masked_pool.py:36", "max_abs_err": max_err, "ms": ms,
           "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes", "library_ms": None, "ms_cold": cold,
           "device_kernels_per_call": 1}
    if run_parent is not None:
        out["parent_ms"], out["parent_ms_cold"] = parent_ms["warm"], parent_ms["cold"]
    return out


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


def data_phase(torch, np, data_yaml, n_steps: int = 12) -> tuple[dict, dict]:
    """The port's data stack on the card's host (no OpenCV, no PyYAML):
    read the synthetic ARCADE-shaped dataset ``data_yaml`` (written by the
    port) through MGADataset and DataLoader on the shipped cbam_defaults
    profile, time the host pipeline alone, then feed the flagship's bf16
    train step from the loader through the pinned ``to_device`` copy. The
    64-image split has 4 batches an epoch, so the loader builds at most 4 at
    once and every fourth micro-step begins an epoch; the 256-image split
    (16 batches an epoch) shows the loader in its steady state, at its
    default prefetch and with all 8 threads at work. Returns the launches and
    what ``data_dev_phase`` compares with: the train step, its state and
    schedule, the 256-image loader and its fed micro-steps."""
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
    st, metrics, big_rows = fed_steps(torch, np, big, step, st, sched, n_steps)
    check(not any(r[2] for r in big_rows), "a timed micro-step of the 256-image split began an epoch")
    print(f"[data] {n_steps} micro-steps fed by the loader, 256 images (inside one epoch): "
          f"{fed_summary(big_rows)}; last loss {float(metrics['loss']):.4f}")

    pcfg = load_config("configs/hyperparams/cbam_defaults.yaml", MGA_PROB_MODE=True, fraction=0.25, **kw)
    ploader = DataLoader(MGADataset(pcfg, "train", augment=True), TRAIN_BATCH, seed=1, workers=8)
    pbatch = next(iter(ploader))
    check_batch(np, pbatch, TRAIN_BATCH, prob=True)
    pstep = make_step(torch, model, 1, torch.bfloat16, seg_cfg=seg_loss_config(pcfg))
    _, pm = pstep(st, ploader.to_device(pbatch), *sched.at(st.step))
    check(seg_loss_config(pcfg).prob_mode and bool(torch.isfinite(pm["loss"])), "MGA_PROB_MODE batch failed")
    print(f"[data] MGA_PROB_MODE batch (prob masks, method {pcfg.mask.prob_method}): loss "
          f"{float(pm['loss']):.4f}, seg items {[round(float(x), 4) for x in pm['items'][3:]]}")
    return launches, dict(step=step, st=st, sched=sched, host_rows=big_rows, host_loader=big)


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


def fit_phase(torch, np, data_yaml, project) -> tuple[dict, object, Path]:
    """A whole training run of the flagship through the port's entry points:
    ``MGA(...).train`` on the 256-image set, validating on the 64-image val
    split each epoch, 3 epochs at 640 px, batch 16, nbs 64, bf16, 8 loader
    threads, the shipped cbam_defaults profile; the launch counters zeroed
    just before and read just after, and held to the run's micro-steps and
    validation batches exactly. Then a resume to epoch 4 in the same
    directory, the val CLI on best.pt (float32) against the trainer's own
    evaluation of the epoch that wrote it (bf16), and best.pt served through
    ``build_server`` and ``MicroBatcher``. Returns the first run's launches,
    the resumed run's trainer and best.pt."""
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
    return launches, res, best

# ------------------------------------------------- device augmentation, predict


def host_vs_device(np, torch, got: dict, host: dict, pvalid) -> str:
    """The augment's batch on the card against the host pipeline's batch of
    the same seeds: images within 2 grey levels and a mean under 1, mask
    pyramids exact, and boxes within 1e-3 px with labels and mask_gt exact
    (the JAX package's own bounds); returns the figures. The boxes of a
    sample whose raw rows are all taken (``pvalid``: 2 * max_boxes boxes
    before the affine filter) are not compared: the device path, as the
    JAX package's, keeps only the first 2 * max_boxes, the host filters
    them all (``ROADMAP.md`` section 3)."""
    tensors = [v for k, v in got.items() if k != "masks"] + list(got["masks"])
    check(all(t.is_cuda for t in tensors), "[data-dev] an augment output is not on the card")
    d = np.abs(got["image"].cpu().numpy().astype(int) - host["image"].astype(int))
    masks = all(np.array_equal(g.cpu().numpy(), h) for g, h in zip(got["masks"], host["masks"]))
    rows = pvalid.cpu().numpy().sum(1) < pvalid.shape[1]
    box = float(np.abs(got["gt_boxes"].cpu().numpy()[rows] - host["gt_boxes"][rows]).max(initial=0.0))
    labels = (np.array_equal(got["gt_labels"].cpu().numpy()[rows], host["gt_labels"][rows])
              and np.array_equal(got["mask_gt"].cpu().numpy()[rows], host["mask_gt"][rows]))
    msg = (f"image max {d.max()} grey levels, mean {d.mean():.5f}, {100 * (d > 0).mean():.3f}% of values differ; "
           f"pyramids {'equal' if masks else 'DIFFER'}; on {rows.sum()} of {len(rows)} samples (the others hold "
           f"{pvalid.shape[1]} boxes before the filter) boxes max {box:.2e} px, labels and mask_gt "
           f"{'equal' if labels else 'DIFFER'}")
    check(d.max() <= 2 and d.mean() < 1 and masks and box <= 1e-3 and labels, f"[data-dev] device vs host: {msg}")
    return msg


def data_dev_phase(torch, np, data_yaml, fed: dict, n_steps: int = 12) -> dict:
    """The device-side augmentation (``augment.on_device``) on the card, on
    the 256-image set with the cbam_defaults profile (no mosaic: the S
    canvas): one batch against the host pipeline's batch of the same seeds,
    and one with mosaic 1.0 and the default HSV gains (the 2S canvas);
    the raw host pipeline's images/s alone; then ``n_steps`` micro-steps of
    ``data_phase``'s train step fed by the raw loader and the augment, beside
    that phase's host-fed micro-steps of the same run, with the augment's
    device time (CUDA events around it in each step, and its kernels'
    time under the profiler) and the bytes each batch copies to the card;
    launches exact (3 CAM gates and 1 DFL backward per micro-step)."""
    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.data import device_augment as DA
    from mga_yolo_tpu_torch.data.dataset import MGADataset
    from mga_yolo_tpu_torch.data.loader import DataLoader

    kw = dict(data=str(data_yaml), imgsz=IMGSZ, batch=TRAIN_BATCH, workers=8, max_boxes=MAX_BOXES, on_device=True)
    cfg = load_config("configs/hyperparams/cbam_defaults.yaml", **kw)
    ok, why = DA.supported(cfg)
    check(ok and cfg.augment.on_device, f"[data-dev] cbam_defaults not supported on the card: {why}")
    raw = DataLoader(MGADataset(cfg, "train", augment=True), TRAIN_BATCH, seed=0, workers=8)
    raw.raw_mode = True
    host = fed["host_loader"]
    check(len(raw.dataset) == len(host.dataset) == 256, "[data-dev] the split is not 256 images")
    augment = DA.make_augment_fn(cfg, MAX_BOXES)
    cm = DA.canvas_multiplier(cfg.augment, True)

    def first_batches(raw_ld, host_ld):
        """Batch 0 of epoch 0 of both loaders: the same images and seeds."""
        raw_ld.set_epoch(0)
        host_ld.set_epoch(0)
        rb = raw_ld._make_batch(raw_ld._epoch_batches(), 0, True)
        return rb, host_ld._make_batch(host_ld._epoch_batches(), 0, True)

    # the profile (no mosaic: the S canvas), then mosaic and the default HSV
    # gains on the same images (the 2S canvas)
    mcfg = load_config("configs/hyperparams/cbam_defaults.yaml", **kw, mosaic=1.0, hsv_h=0.015, hsv_s=0.7,
                       hsv_v=0.4)
    mraw = DataLoader(MGADataset(mcfg, "train", augment=True), TRAIN_BATCH, seed=0, workers=8)
    mraw.raw_mode = True
    mhost = DataLoader(MGADataset(mcfg, "train", augment=True), TRAIN_BATCH, seed=0, workers=8)
    for what, c, (rb, hb) in (("cbam_defaults", cfg, first_batches(raw, host)),
                              ("mosaic 1.0 + HSV", mcfg, first_batches(mraw, mhost))):
        rb.pop("index")
        d = raw.to_device(rb)
        check(all(t.is_cuda for t in d.values()), "[data-dev] a raw tensor is not on the card")
        k = DA.canvas_multiplier(c.augment, True)
        msg = host_vs_device(np, torch, DA.make_augment_fn(c, MAX_BOXES)(d, d["canvas"].shape[1] // k), hb,
                             d["pvalid"])
        print(f"[data-dev] {what}: one batch of {TRAIN_BATCH} (canvas {tuple(rb['canvas'].shape[1:3])}) on the card "
              f"against the host pipeline, same seeds: {msg}")
    rb, hb = first_batches(raw, host)
    rb.pop("index")
    dev = raw.to_device(rb)
    n_bytes, host_bytes = DA.batch_bytes(rb), DA.batch_bytes(hb)

    def h2d_ms(batch: dict) -> float:
        """Device ms of one batch's copies from pinned host memory (median of 5)."""
        pinned = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for v in batch.values()
                  for a in (v if isinstance(v, list) else [v])]
        times = []
        for _ in range(5):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for t in pinned:
                t.to("cuda", non_blocking=True)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return sorted(times)[2]

    hb_copy = {k: v for k, v in hb.items() if k != "index"}
    print(f"[data-dev] H2D from pinned memory, one batch: raw {h2d_ms(rb):.3f} ms ({n_bytes / 1e6:.1f} MB), "
          f"finished {h2d_ms(hb_copy):.3f} ms ({DA.batch_bytes(hb_copy) / 1e6:.1f} MB)")

    n_img, t0 = 0, time.perf_counter()
    raw.set_epoch(0)
    for b in raw:
        check(b["canvas"].shape == (TRAIN_BATCH, cm * IMGSZ, cm * IMGSZ, 3), f"[data-dev] canvas {b['canvas'].shape}")
        n_img += len(b["canvas"])
    rate = n_img / (time.perf_counter() - t0)
    print(f"[data-dev] raw host pipeline alone, 256 images: {n_img} images in {len(raw)} batches -> {rate:.1f} "
          f"images/s; {n_bytes / 1e6:.1f} MB a batch to the card (canvas {rb['canvas'].nbytes / 1e6:.1f}, mask "
          f"canvas {rb['mask_canvas'].nbytes / 1e6:.1f}) against {host_bytes / 1e6:.1f} MB of a finished batch")

    dev_ms, names = device_kernels(torch, lambda: augment(dev, dev["canvas"].shape[1] // cm), n=5,
                                   fixed=False)  # not every call launches the same kernels
    top = sorted(names.items(), key=lambda kv: -kv[1])[:3]
    aug_dev = sum(names.values())
    print(f"[data-dev] augment B={TRAIN_BATCH}: {aug_dev:.3f} ms of device kernels a batch ({dev_ms:.0f} kernels); "
          f"largest: " + ", ".join(f"{k} {v:.3f} ms" for k, v in top))

    step, st, sched = fed["step"], fed["st"], fed["sched"]

    def stream():
        epoch = 2000
        while True:
            raw.set_epoch(epoch)
            for bi, b in enumerate(raw):
                yield b, bi == 0
            epoch += 1

    def augmented(d):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = augment(d, d["canvas"].shape[1] // cm)
        e1.record()
        return out, (e0, e1)

    def copied(b):
        b.pop("index", None)
        return raw.to_device(b)

    zero_launches()
    it = stream()
    batch, _ = augmented(copied(next(it)[0]))
    st, _ = step(st, batch, *sched.at(st.step))
    torch.cuda.synchronize()
    rows, aug_ms = [], []
    for _ in range(n_steps):
        t1 = time.perf_counter()
        b, first = next(it)
        d = copied(b)
        t2 = time.perf_counter()
        batch, (e0, e1) = augmented(d)
        st, metrics = step(st, batch, *sched.at(st.step))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rows.append(((t3 - t1) * 1e3, (t2 - t1) * 1e3, first))
        aug_ms.append(e0.elapsed_time(e1))
        check(bool(torch.isfinite(metrics["loss"])), f"[data-dev] non-finite loss {float(metrics['loss'])}")
    launches = read_launches()
    want = want_launches({"cam_gate": 3 * (n_steps + 1), "dfl_bwd": n_steps + 1})
    check(launches == want, f"[data-dev] launches {launches} in {n_steps} + 1 micro-steps, want {want}")
    check(not any(r[2] for r in rows), "[data-dev] a timed micro-step began an epoch")
    a = sorted(aug_ms)
    print(f"[data-dev] {n_steps} micro-steps fed by the raw loader + the augment on the card, 256 images (inside "
          f"one epoch): {fed_summary(rows)}; the augment between "
          f"CUDA events p50 {a[len(a) // 2]:.3f} ms, max {a[-1]:.3f} ms; last loss {float(metrics['loss']):.4f}; "
          f"launches {launches}")
    print(f"[data-dev]   host-fed, the same step in [data] of this run: {fed_summary(fed['host_rows'])}")
    return launches


def fit_dev_phase(torch, np, data_yaml, project) -> dict:
    """One epoch of the flagship through ``MGA.train`` with
    ``augment.on_device`` on the 256 images (close_mosaic 10 of 1 epoch:
    mosaic off, the S canvas), validated; the trainer must take the device
    path, and the launches are held to its micro-steps and validation
    batches exactly."""
    from mga_yolo_tpu_torch.api import MGA

    kw = dict(data=str(data_yaml), imgsz=IMGSZ, batch=TRAIN_BATCH, nbs=NBS, workers=8, max_boxes=MAX_BOXES,
              val=True, save=True, amp=True, project=str(project), name="fit-dev", on_device=True)
    m = MGA("configs/models/yolov8_cbam.yaml", scale="n")
    zero_launches()
    t0 = time.perf_counter()
    final = m.train("configs/hyperparams/cbam_defaults.yaml", epochs=1, **kw)
    wall = time.perf_counter() - t0
    launches = read_launches()
    tr = m._trainer
    check(tr.device_augment and tr.train_loader.raw_mode and not tr.train_loader.use_mosaic,
          f"[fit-dev] device path {tr.device_augment}, raw {tr.train_loader.raw_mode}, "
          f"mosaic {tr.train_loader.use_mosaic}")
    (st,) = tr.epoch_stats
    steps, val_batches = st["steps"], 2 * len(tr.val_loader)  # the epoch's and the final evaluation
    want = want_launches({"cam_gate": 3 * (steps + val_batches), "dfl_bwd": steps, "nms_suppress": val_batches})
    check(launches == want, f"[fit-dev] launches {launches} in {steps} micro-steps and {val_batches} validation "
                            f"batches, want {want}")
    check(steps == len(tr.train_loader) and np.isfinite(final.metrics.map50), "[fit-dev] the epoch did not run")
    v, secs = st["val_speed"], st["train_s"]
    print(f"[fit-dev] 1 epoch, device augmentation (S canvas): train {secs:.2f} s, {st['images']} images in {steps} "
          f"micro-steps -> {st['images'] / secs:.1f} img/s, {100 * st['wait_s'] / secs:.1f}% waiting on the loader; "
          f"val {st['val_s']:.2f} s (preprocess {v['preprocess']:.2f}, inference {v['inference']:.2f}, postprocess "
          f"{v['postprocess']:.2f} ms an image); mAP50 {final.metrics.map50:.4f}; {wall:.1f} s wall; launches "
          f"{launches}")
    return launches


def predict_phase(torch, np, data_yaml, trainer, best: Path, tmp: Path) -> dict:
    """The prediction surface on best.pt: ``cli.predict`` over the 64 val
    PNGs (images/s, the files it writes; launches exact: 3 CAM gates a
    batch of 16, no device NMS); the predictor's decoded output and mask
    logits of the first val batch against a float32 eval step of the
    trainer's model on best.pt, within the path tolerances; ``cli.ckpt
    export-torch`` and the exported file served; ``cli.serve`` started as a
    process on ``--port 0`` answering 4 PNG POSTs; ``cli.profile`` at 640 px
    against ``count_gflops``. Returns the ``cli.predict`` run's launches."""
    import contextlib
    import io
    import queue
    import signal
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from mga_yolo_tpu_torch.cli import ckpt as cli_ckpt
    from mga_yolo_tpu_torch.cli import predict as cli_predict
    from mga_yolo_tpu_torch.cli import profile as cli_profile
    from mga_yolo_tpu_torch.config import det_loss_config, seg_loss_config
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.graph import parse_graph
    from mga_yolo_tpu_torch.serve import build_server
    from mga_yolo_tpu_torch.train.predictor import load_predictor
    from mga_yolo_tpu_torch.train.state import make_eval_step
    from mga_yolo_tpu_torch.train.trainer import count_gflops
    from mga_yolo_tpu_torch.utils.checkpoint import load_checkpoint
    from mga_yolo_tpu_torch.utils.layer_profile import total_gflops

    val_dir = Path(data_yaml).parent / "images" / "val"
    n_val = len(list(val_dir.iterdir()))
    out_dir = tmp / "predict"
    log = io.StringIO()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        res = cli_predict.main(["--weights", str(best), "--source", str(val_dir), "--out", str(out_dir), "--batch",
                                str(TRAIN_BATCH), "--save-feature-maps"])
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = want_launches({"cam_gate": 3 * -(-n_val // TRAIN_BATCH)})
    check(launches == want, f"[predict] cli.predict launches {launches} over {n_val} images, want {want}")
    files = sorted(p.name for p in out_dir.iterdir())
    check(res["images"] == n_val == 64 and len(files) == 5 * n_val, f"[predict] {res['images']} images, {len(files)} files")
    lines = log.getvalue().splitlines()
    n_det = sum(int(ln.split(": ")[1].split()[0]) for ln in lines if ln.endswith("detections"))
    print(f"[predict] cli.predict on best.pt, {n_val} val PNGs, batch {TRAIN_BATCH}, conf 0.25, float32: {wall:.2f} s "
          f"wall with the model load -> {n_val / wall:.1f} images/s; {len(files)} files ({files[0]} ...), {n_det} "
          f"detections; last line {lines[-1]!r}; launches {launches}")
    t0 = time.perf_counter()
    pred = load_predictor(best)
    load_s = time.perf_counter() - t0
    paths = sorted(val_dir.iterdir())
    pred(paths[:TRAIN_BATCH], batch_size=TRAIN_BATCH)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = pred(paths, batch_size=TRAIN_BATCH)
    warm = time.perf_counter() - t0
    print(f"[predict] load_predictor(best.pt) {load_s:.2f} s; MGAPredictor warm, {n_val} images read, letterboxed, "
          f"forward, host NMS: {warm:.2f} s -> {n_val / warm:.1f} images/s; {sum(len(r) for r in results)} detections")

    vl = trainer.val_loader
    hb = vl._make_batch(vl._epoch_batches(), 0, False)
    hb.pop("index")
    batch = vl.to_device(hb)
    load_checkpoint(best, trainer.state)
    ref = make_eval_step(trainer.model, trainer.strides, trainer.spec.nc, det_loss_config(trainer.cfg),
                         seg_loss_config(trainer.cfg))(trainer.state, batch)
    decoded, seg = pred.forward_batch(hb["image"])
    pairs = [(torch.from_numpy(decoded), ref["decoded"].float().cpu(), PATH_ATOL)] + [
        (torch.from_numpy(seg[k]).permute(0, 3, 1, 2), ref["seg"][k].float().cpu(), 1e-4) for k in ref["seg"]]
    errs = [float((a - b).abs().max()) if a.shape == b.shape else float("inf") for a, b, _ in pairs]
    close = all(a.shape == b.shape and torch.allclose(a, b, rtol=PATH_RTOL, atol=atol) for a, b, atol in pairs)
    print(f"[predict] the predictor's forward on the first {len(hb['image'])} val images against the trainer's float32 "
          f"eval step on best.pt: max abs error decoded {errs[0]:.4g} px, mask logits {max(errs[1:]):.4g} "
          f"(rtol {PATH_RTOL}, atol {PATH_ATOL} / 1e-4)")
    check(close, "[predict] the predictor's reading of best.pt disagrees with the trainer's")

    ref_pt = tmp / "export.pt"
    with contextlib.redirect_stdout(log):
        cli_ckpt.main(["export-torch", str(best), str(ref_pt)])
    server = build_server(ref_pt, imgsz=IMGSZ, batch=BATCH, conf=0.001, port=0)
    try:
        imgs = [image_io.imread(p) for p in paths[:4]]
        with ThreadPoolExecutor(4) as pool:
            preds = list(pool.map(server.batcher.submit, imgs))
        check(all(bool(np.isfinite(p.boxes).all()) and len(p.boxes) for p in preds), "[predict] the export served badly")
        print(f"[predict] cli.ckpt export-torch -> {ref_pt.name} ({ref_pt.stat().st_size / 1e6:.1f} MB), served: "
              f"{len(preds)} requests, {sum(len(p.boxes) for p in preds)} boxes, all finite")
    finally:
        server.httpd.server_close()
        server.batcher.close()

    proc = subprocess.Popen([sys.executable, "-m", "mga_yolo_tpu_torch.cli.serve", "--weights", str(best), "--port",
                             "0", "--batch", "4"], cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines_q: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [lines_q.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    try:
        t0, port, seen = time.perf_counter(), None, []
        while port is None and time.perf_counter() - t0 < 240:
            try:
                ln = lines_q.get(timeout=1.0)
            except queue.Empty:
                check(proc.poll() is None, f"[predict] cli.serve exited {proc.returncode}: {seen[-5:]}")
                continue
            seen.append(ln.rstrip())
            if "listening on http://" in ln:
                port = int(ln.rsplit(":", 1)[1])
        check(port is not None, f"[predict] cli.serve printed no port: {seen[-5:]}")
        up = time.perf_counter() - t0

        def post(p: Path) -> dict:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=p.read_bytes(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        with ThreadPoolExecutor(4) as pool:
            replies = list(pool.map(post, paths[:4]))
        check([r["orig_shape"] for r in replies] == [list(im.shape[:2]) for im in imgs]
              and all(np.isfinite(b["conf"]) for r in replies for b in r["boxes"]),
              f"[predict] cli.serve replies {[r.get('orig_shape') for r in replies]}")
        print(f"[predict] cli.serve as a process on --port 0: up on port {port} in {up:.1f} s (start, model, "
              f"warm-up); 4 PNG POSTs answered, {sum(len(r['boxes']) for r in replies)} boxes, batch ms "
              f"{[r['batch_ms'] for r in replies]}; its last lines {seen[-2:]}")
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"[predict] cli.serve exited {proc.returncode} on SIGINT")

    with contextlib.redirect_stdout(log):
        rows = cli_profile.main(["--imgsz", str(IMGSZ)])
    gf = count_gflops(parse_graph("configs/models/yolov8_cbam.yaml", scale="n", nc=1), IMGSZ)
    check(len(rows) == 29 and total_gflops(rows) == gf, f"[predict] cli.profile: {len(rows)} rows, "
                                                         f"{total_gflops(rows)} GFLOPs against {gf}")
    print(f"[predict] cli.profile at {IMGSZ} px: {len(rows)} rows, {sum(r['params'] for r in rows):,} parameters, "
          f"{total_gflops(rows)} GFLOPs (= count_gflops); Detect out {rows[-1]['out_shape']}")
    return launches


# ------------------------------------------------------------- export

EXPORT_TOL = 1e-3  # decoded pixels: the TFLite interpreter's float32 against the port's forward


def export_phase(torch, np, data_yaml, best: Path, tmp: Path, device: str = "cuda") -> dict:
    """The TFLite / SavedModel export and the consumers of exported files.

    Where ``tensorflow`` does not import (the card's host has none):
    ``cli.ckpt export-tflite`` and ``export-savedmodel`` on best.pt,
    ``load_predictor`` of a ``.tflite`` and ``cli.val --weights x.tflite``
    must each raise an ImportError naming tensorflow, write nothing and
    launch nothing; another exception or a success fails the run. Where it
    imports: best.pt exported at 640 px (float32, batch 1), the file's
    decoded head on the val images within ``EXPORT_TOL`` of the port's
    float32 forward on the card, and ``cli.val`` on the file with the NMS on
    the card, one launch a val batch exactly. Returns the ``cli.val`` run's
    launches (all 0 in the first case)."""
    import contextlib
    import io

    from mga_yolo_tpu_torch.cli import ckpt as cli_ckpt
    from mga_yolo_tpu_torch.cli import val as cli_val
    from mga_yolo_tpu_torch.train.predictor import load_predictor

    out = tmp / "export"
    out.mkdir()
    tfl = out / "best.tflite"
    try:
        import tensorflow  # noqa: F401
    except ImportError:
        calls = {
            "cli.ckpt export-tflite": lambda: cli_ckpt.main(["export-tflite", str(best), "--out", str(tfl)]),
            "cli.ckpt export-savedmodel": lambda: cli_ckpt.main(["export-savedmodel", str(best), str(out / "sm")]),
            "load_predictor(.tflite)": lambda: load_predictor(tfl, device=device),
            "cli.val --weights .tflite": lambda: cli_val.main(["--weights", str(tfl), "--data", str(data_yaml),
                                                               "--device", device]),
        }
        zero_launches()
        for what, call in calls.items():
            try:
                call()
            except ImportError as e:
                check("tensorflow" in str(e), f"[export] {what}: the ImportError does not name tensorflow: {e}")
                continue
            raise RuntimeError(f"[export] {what} did not refuse without tensorflow")
        launches = read_launches()
        check(launches == want_launches(), f"[export] the refusals launched {launches}")
        check(not list(out.iterdir()), f"[export] the refusals wrote {sorted(p.name for p in out.iterdir())}")
        print(f"[export] tensorflow does not import here: {', '.join(calls)} each raised an ImportError naming it, "
              "wrote nothing and launched nothing")
        return launches

    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.data.transforms import letterbox
    from mga_yolo_tpu_torch.export.tflite import port_forward
    from mga_yolo_tpu_torch.utils.checkpoint import rebuild_from_checkpoint

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        info = cli_ckpt.main(["export-tflite", str(best), "--out", str(tfl), "--imgsz", str(IMGSZ)])
    print(f"[export] best.pt -> {tfl.name}: {info['bytes'] / 1e6:.2f} MB in {time.perf_counter() - t0:.1f} s, "
          f"outputs {info['outputs']}, max |d| decoded against the port's forward on the CPU "
          f"{info['max_abs_diff_decoded']:.2e}")
    check(info["max_abs_diff_decoded"] < EXPORT_TOL, f"[export] the file is {info['max_abs_diff_decoded']} "
                                                     f"from the port's forward on the CPU")
    val_dir = Path(data_yaml).parent / "images" / "val"
    x = np.stack([letterbox(image_io.imread(p), IMGSZ, scaleup=False)[0] for p in sorted(val_dir.iterdir())[:4]])
    pred = load_predictor(tfl, device=device)
    net, _ = rebuild_from_checkpoint(best, device=device)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        want = port_forward(net, x.astype(np.float32))[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    err = float(np.abs(pred.forward_batch(x)[0] - want).max())
    print(f"[export] the file's decoded head on 4 val images against the port's float32 forward on the "
          f"{device}: max |d| {err:.2e}")
    check(err < EXPORT_TOL, f"[export] the file is {err} from the port's forward on the {device}")
    n_val = len(list(val_dir.iterdir()))
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = cli_val.main(["--weights", str(tfl), "--data", str(data_yaml), "--batch", str(TRAIN_BATCH),
                            "--device", device])
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_batches = -(-n_val // TRAIN_BATCH)
    check(launches == want_launches({"nms_suppress": n_batches}), f"[export] cli.val on {tfl.name} launched "
                                                                   f"{launches}, want {n_batches} NMS")
    print(f"[export] cli.val on {tfl.name}: {n_val} images in {wall:.1f} s, mAP50 {res.metrics.map50:.4f}, "
          f"launches {launches}")
    return launches


# ------------------------------------------------------------- data-parallel

DDP_WORLD = 2  # two ranks that share the one card (gloo: NCCL refuses two ranks on one device)
MESH_FIT_FRACTION = 0.5  # [ddp-fit] and [spatial-fit*] train and validate on half of the 256 + 64 images (depth)
DDP_BATCH, DDP_ACC, DDP_TIMED = 16, 4, 8  # global micro-batch, accumulate, timed bf16 micro-steps
DDP_TIMEOUT_S = 300  # every collective's (the group's), and the wait for the ranks
# [ddp]'s float32 states against the float64 step: a root-mean-square error over each part of the state at most
# this many times one float32 process's, and a max error within these fixed limits (abs; x max|m| per tensor)
DDP_F64_FACTOR, DDP_PARAM_CAP, DDP_M_CAP = 2.0, 1e-5, 5e-3


def ddp_group(torch, backend: str, rank: int, world: int, out_dir: str) -> None:
    import datetime

    torch.distributed.init_process_group(backend, init_method=f"file://{out_dir}/rendezvous-{backend}", rank=rank,
                                         world_size=world, timeout=datetime.timedelta(seconds=DDP_TIMEOUT_S))


def spawn_ranks(fn, args: tuple, world: int = DDP_WORLD) -> None:
    """``fn(rank, world, *args)`` in ``world`` processes started with spawn;
    raises if a rank fails or they are not done in twice the collectives'
    timeout (the ranks are killed)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 2 * DDP_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise RuntimeError(f"{fn.__name__}: the ranks did not finish in {2 * DDP_TIMEOUT_S} s")


def ddp_shard(batch: dict, rank: int, world: int) -> dict:
    """The rank's rows of a global batch (the loader's strided shard)."""
    return {k: [m[rank::world] for m in v] if isinstance(v, list) else v[rank::world] for k, v in batch.items()}


def ddp_f32_steps(torch, np, rank: int = 0, world: int = 1, f64: bool = False) -> dict:
    """The flagship (``torch.manual_seed(0)``) takes ``DDP_ACC`` float32
    micro-steps (TF32 off) at accumulate ``DDP_ACC``, one apply, on the
    rank's shard of 4 global batches of ``DDP_BATCH`` (under a mesh in
    effect: its data shard's, and of those its band of rows); the loss items
    summed over the ranks each micro-step, the state on the host after the
    apply, and the launches of the micro-steps.

    ``f64``: one process takes the same step in float64, the referee of
    ``[ddp]``: the model (its convolutions, BatchNorm's ``F.batch_norm``),
    the images after their float32 normalisation, the optimizer and the EMA
    in float64, with the kernels' plain versions patched in; the loss and
    the plain CAM gate, which the port computes in float32, stay float32."""
    import contextlib
    from unittest import mock

    from mga_yolo_tpu_torch import parallel
    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.losses import detection
    from mga_yolo_tpu_torch.models import attention
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.ops import cam_gate as cg
    from mga_yolo_tpu_torch.ops import dfl_bwd as db
    from mga_yolo_tpu_torch.parallel import spatial
    from mga_yolo_tpu_torch.train import state as S

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    model, _ = create_model(YOLOV8_CBAM, scale="n", nc=1, training=True)
    plain = contextlib.ExitStack()
    if f64:
        model.double()
        normalize = S.normalize_images
        for target, name, fn in ((S, "normalize_images", lambda im: normalize(im).double()),
                                 (attention, "cam_gate", cg.cam_gate_ref),
                                 (detection, "dfl_decode_ce_bwd", db.dfl_decode_ce_bwd_ref)):
            plain.enter_context(mock.patch.object(target, name, fn))
    st = S.create_train_state(model)
    step = make_step(torch, model, DDP_ACC, torch.float32)
    # the rank's data shard of each global batch, and under a mesh its band of rows
    batches = [spatial.keep_rows(ddp_shard(train_batch(np, torch, DDP_BATCH, seed=20 + i), parallel.data_rank(),
                                           parallel.data_world())) for i in range(DDP_ACC)]
    items = []
    zero_launches()
    with plain:
        for b in batches:
            st, metrics = step(st, b, 0.01, 0.1, 0.8)
            items.append(parallel.all_reduce_sum(metrics["items"]))
    torch.cuda.synchronize()
    launches = read_launches()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    host = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
    return {"items": torch.stack(items).cpu(), "params": host(st.params()), "bn": host(st.bn_stats()),
            "ema": host(st.ema_params), "ema_bn": host(st.ema_bn_stats), "m": host(st.opt_state["m"]),
            "opt_step": st.opt_step, "launches": launches}


def ddp_bf16_steps(torch, np, rank: int, world: int, n_timed: int = DDP_TIMED) -> dict:
    """The flagship's bf16 micro-step at the global micro-batch
    ``DDP_BATCH`` (the rank's shard of it; under a mesh in effect its data
    shard's, and of that its band of rows), accumulate ``DDP_ACC``: after a
    first use, ``n_timed`` micro-steps with the launch and collective
    counters zeroed just before, each timed on the host clock to a
    synchronise, with its collectives, space collectives and halo exchanges;
    then the apply's gradient all-reduce alone."""
    from mga_yolo_tpu_torch import parallel
    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.models.layers import BatchNorm2d
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.parallel import spatial
    from mga_yolo_tpu_torch.train import state as S

    torch.manual_seed(0)
    model, _ = create_model(YOLOV8_CBAM, scale="n", nc=1, training=True)
    st = S.create_train_state(model)
    step = make_step(torch, model, DDP_ACC, torch.bfloat16)
    batch = spatial.keep_rows(ddp_shard(train_batch(np, torch, DDP_BATCH, seed=4), parallel.data_rank(),
                                        parallel.data_world()))
    st, _ = step(st, batch, 0.01, 0.1, 0.8)  # first use: cuDNN plans, allocator
    for _ in range(DDP_ACC - 1):  # to an apply boundary, so the timed steps hold two applies
        st, _ = step(st, batch, 0.01, 0.1, 0.8)
    torch.cuda.synchronize()
    zero_launches()
    parallel.collectives = 0
    times, per_step, space, halos = [], [], [], []
    for _ in range(n_timed):
        c0, s0, h0, t0 = parallel.collectives, spatial.space_collectives, spatial.halo_exchanges, time.perf_counter()
        st, metrics = step(st, batch, 0.01, 0.1, 0.8)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(parallel.collectives - c0)
        space.append(spatial.space_collectives - s0)
        halos.append(spatial.halo_exchanges - h0)
        check(bool(torch.isfinite(metrics["loss"])), f"rank {rank}: non-finite loss")
    launches = read_launches()
    grads = [torch.zeros_like(p) for p in st.params().values()]
    ar = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parallel.all_reduce_sum_(grads)
        torch.cuda.synchronize()
        ar.append((time.perf_counter() - t0) * 1e3)
    n_bn = sum(1 for m in model.modules() if isinstance(m, BatchNorm2d))
    return {"times": times, "collectives": per_step, "space_collectives": space, "halo_exchanges": halos,
            "launches": launches, "allreduce_ms": ar[1:], "grad_numel": sum(g.numel() for g in grads),
            "n_bn": n_bn, "opt_step": st.opt_step}


def ddp_step_rank(rank: int, world: int, out_dir: str) -> None:
    """One rank of ``[ddp]``: gloo, on ``cuda:0``; saves its results to
    ``out_dir/rank{rank}.pt``."""
    import numpy as np
    import torch

    torch.cuda.set_device(0)
    ddp_group(torch, "gloo", rank, world, out_dir)
    try:
        out = {"f32": ddp_f32_steps(torch, np, rank, world), "bf16": ddp_bf16_steps(torch, np, rank, world)}
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


DDP_STATE = ("params", "ema", "m", "bn", "ema_bn")


def ddp_state_errors(got: dict, want: dict) -> dict:
    """Per part of the state, the max abs error, the max error relative to
    each tensor's max |want|, the tensor of the latter, and the
    root-mean-square error over all the part's values."""
    out = {"items": float(((got["items"] - want["items"]).abs() / want["items"].abs()).max())}
    for what in DDP_STATE:
        rows = [(float((got[what][k] - w).abs().max()), max(float(w.abs().max()), 1e-30), k,
                 float((got[what][k].double() - w.double()).square().sum()), w.numel())
                for k, w in want[what].items()]
        worst = max(rows, key=lambda r: r[0] / r[1])
        rms = (sum(r[3] for r in rows) / sum(r[4] for r in rows)) ** 0.5
        out[what] = (max(r[0] for r in rows), worst[0] / worst[1], worst[2], rms)
    return out


_F32_REFS: dict = {}


def f32_references(torch, np, tag: str) -> tuple[dict, dict]:
    """One float32 process and the float64 step on ``[ddp]``'s global
    batches (``ddp_f32_steps``), computed once for ``[ddp]`` and
    ``[spatial]``, which take the same batches."""
    if not _F32_REFS:
        want = ddp_f32_steps(torch, np)
        check(want["launches"] == want_launches({"cam_gate": 3 * DDP_ACC, "dfl_bwd": DDP_ACC}),
              f"{tag} one process launched {want['launches']}")
        ref = ddp_f32_steps(torch, np, f64=True)
        check(ref["launches"] == want_launches() and ref["opt_step"] == 1, f"{tag} the float64 step launched "
              f"{ref['launches']} (the plain versions only), {ref['opt_step']} applies")
        _F32_REFS.update(want=want, ref=ref)
    return _F32_REFS["want"], _F32_REFS["ref"]


def ddp_phase(torch, np, tmp: Path) -> dict:
    """``[ddp]``: two gloo ranks on the card, each on half of every global
    batch, against one process on the whole of it (float32, one apply); the
    ranks bit-equal; then the bf16 micro-step, its collectives and the
    gradient all-reduce. Returns rank 0's launches over the timed bf16
    micro-steps.

    The loss items and BN statistics are held to ``train_parity_phase``'s
    tolerances against one float32 process. The parameters, EMA and
    momentum are held to a referee independent of the data-parallel code:
    the same step in float64 (``ddp_f32_steps(f64=True)``). Over each part
    of the state, the two ranks' root-mean-square error against it may be
    at most ``DDP_F64_FACTOR`` times one float32 process's, and their max
    error stays within the fixed ``DDP_PARAM_CAP`` / ``DDP_M_CAP``. (A max
    alone is no measure to take a ratio of: it sits on a bias or scalar
    whose gradient cancels, and equally valid float32 orders of the
    BatchNorm sums move it severalfold.) Their distance from one float32
    process is printed beside train-parity's tolerances. ``chip_smoke.py
    --ddp-faults`` shows that planted faults of the data-parallel code fail
    these checks."""
    out_dir = tmp / "ddp"
    out_dir.mkdir()
    t0 = time.perf_counter()
    spawn_ranks(ddp_step_rank, (str(out_dir),))
    wall = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(DDP_WORLD)]
    want, ref = f32_references(torch, np, "[ddp]")
    a, b = (rk["f32"] for rk in ranks)
    e_one, e_two, e_direct = ddp_state_errors(want, ref), ddp_state_errors(a, ref), ddp_state_errors(a, want)
    fmt = lambda e: f"items {e['items']:.2e}; " + ", ".join(  # noqa: E731
        f"{w} {e[w][0]:.2e} / {e[w][1]:.2e} ({e[w][2]}), rms {e[w][3]:.2e}" for w in DDP_STATE)
    print(f"[ddp] {DDP_WORLD} gloo ranks on cuda:0, {DDP_ACC} float32 micro-steps (TF32 off) of a global batch "
          f"{DDP_BATCH}x{IMGSZ} ({DDP_BATCH // DDP_WORLD} a rank), one apply; launches per rank {a['launches']}; "
          f"{wall:.1f} s wall. Max abs / rel-to-max err (tensor), rms, against the float64 step: two ranks "
          f"{fmt(e_two)}")
    print(f"[ddp] one float32 process against the float64 step: {fmt(e_one)}")
    print(f"[ddp] two ranks against one float32 process: {fmt(e_direct)}; train-parity's tolerances (params "
          f"{TRAIN_PARAM_ATOL} abs, momentum {TRAIN_GRAD_TOL} x max|m|) "
          + ("met" if e_direct["params"][0] <= TRAIN_PARAM_ATOL and e_direct["ema"][0] <= TRAIN_PARAM_ATOL
             and e_direct["m"][1] <= TRAIN_GRAD_TOL else "not met"))
    for r, g in enumerate((a, b)):
        check(g["opt_step"] == want["opt_step"] == 1, f"[ddp] rank {r}: {g['opt_step']} applies")
        check(g["launches"] == want["launches"], f"[ddp] rank {r}: launched {g['launches']}, want {want['launches']}")
        torch.testing.assert_close(g["items"], want["items"], rtol=TRAIN_ITEMS_RTOL, atol=0)
        for what in ("bn", "ema_bn"):  # BN running statistics: float32 sums in another order
            for k, w in want[what].items():
                torch.testing.assert_close(g[what][k], w, rtol=TRAIN_ITEMS_RTOL, atol=TRAIN_PARAM_ATOL,
                                           msg=lambda s: f"[ddp] rank {r} {what} {k}: {s}")
        e = ddp_state_errors(g, ref)
        for w, i, cap in (("params", 0, DDP_PARAM_CAP), ("ema", 0, DDP_PARAM_CAP), ("m", 1, DDP_M_CAP)):
            check(e[w][3] <= DDP_F64_FACTOR * e_one[w][3], f"[ddp] rank {r}: {w} rms err {e[w][3]:.2e} against "
                  f"the float64 step, over {DDP_F64_FACTOR:g}x one float32 process's {e_one[w][3]:.2e}")
            check(e[w][i] <= cap, f"[ddp] rank {r}: {w} max err {e[w][i]:.2e} against the float64 step "
                  f"({e[w][2]}), over the limit {cap}")
    for what in DDP_STATE:
        check(all(torch.equal(a[what][k], b[what][k]) for k in a[what]), f"[ddp] ranks 0 and 1 differ in {what}")
    print(f"[ddp] items and BN statistics within rtol {TRAIN_ITEMS_RTOL} of one process (train-parity's); against "
          f"the float64 step params, EMA and momentum within {DDP_F64_FACTOR:g}x one float32 process's rms error "
          f"(ratios {', '.join(f'{w} {e_two[w][3] / e_one[w][3]:.2f}' for w in ('params', 'ema', 'm'))}), max "
          f"errors within {DDP_PARAM_CAP} abs / {DDP_M_CAP} x max|m|; ranks 0 and 1 bit-equal")
    for r, rk in enumerate(ranks):
        h = rk["bf16"]
        lat = sorted(h["times"])
        n_bn, per = h["n_bn"], h["collectives"]
        want_c = 3 * n_bn + 1  # BN: forward sum + count and squared deviations, backward the two sums; the normaliser
        check(sorted(set(per)) == [want_c, want_c + 1] and per.count(want_c + 1) == DDP_TIMED // DDP_ACC,
              f"[ddp] rank {r}: collectives per micro-step {per}, want {want_c} (+1 at an apply)")
        want_l = want_launches({"cam_gate": 3 * DDP_TIMED, "dfl_bwd": DDP_TIMED})
        check(h["launches"] == want_l, f"[ddp] rank {r}: bf16 launches {h['launches']}, want {want_l}")
        ar = sorted(h["allreduce_ms"])
        print(f"[ddp] rank {r}: {DDP_TIMED} bf16 micro-steps of {DDP_BATCH // DDP_WORLD}x{IMGSZ} (global "
              f"{DDP_BATCH}, accumulate {DDP_ACC}): p50 {lat[len(lat) // 2]:.2f} ms, max {lat[-1]:.2f} ms; "
              f"collectives per micro-step {want_c} ({n_bn} BNs x 3 + the loss normaliser; +1 gradient all-reduce "
              f"at an apply); gradient all-reduce of {h['grad_numel']:,} float32 on the card p50 "
              f"{ar[len(ar) // 2]:.2f} ms (max {ar[-1]:.2f}); launches {h['launches']}")
    return ranks[0]["bf16"]["launches"]


def ddp_nccl_phase(torch, np, tmp: Path) -> dict:
    """``[ddp-nccl]``: one rank in an NCCL group (world size 1) takes the
    bf16 micro-step 4 times (one apply) and equals the no-group step bit for
    bit, with the same launches; cuDNN deterministic, and the no-group step
    taken twice first to show it is repeatable. Returns the group's launches."""
    import torch.distributed as dist

    from mga_yolo_tpu_torch import parallel
    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.train import state as S

    batch = train_batch(np, torch, DDP_BATCH // DDP_WORLD, seed=6)

    def run():
        torch.manual_seed(0)
        model, _ = create_model(YOLOV8_CBAM, scale="n", nc=1, training=True)
        st = S.create_train_state(model)
        step = make_step(torch, model, DDP_ACC, torch.bfloat16)
        zero_launches()
        for _ in range(DDP_ACC):
            st, _ = step(st, batch, 0.01, 0.1, 0.8)
        torch.cuda.synchronize()
        state = {**st.params(), **st.bn_stats(), **{f"ema.{k}": v for k, v in st.ema_params.items()},
                 **{f"m.{k}": v for k, v in st.opt_state["m"].items()}}
        return {k: v.detach().clone() for k, v in state.items()}, read_launches(), st.opt_step

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref, ref_l, _ = run()
        again, _, _ = run()
        check(all(torch.equal(again[k], v) for k, v in ref.items()), "[ddp-nccl] the no-group step is not repeatable")
        out_dir = tmp / "ddp-nccl"
        out_dir.mkdir()
        ddp_group(torch, "nccl", 0, 1, str(out_dir))
        try:
            check(dist.get_backend() == "nccl" and parallel.world() == 1 and not parallel.active(),
                  "[ddp-nccl] not a one-rank NCCL group")
            got, got_l, applies = run()
            probe = torch.arange(4.0).cuda()
            dist.all_reduce(probe)
            parallel.barrier("ddp-nccl")
            check(probe.tolist() == [0.0, 1.0, 2.0, 3.0], f"[ddp-nccl] an NCCL all-reduce over one rank gave {probe}")
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = det
    same = [k for k, v in ref.items() if torch.equal(got[k], v)]
    check(len(same) == len(ref), f"[ddp-nccl] {len(ref) - len(same)} of {len(ref)} tensors differ from the no-group "
                                 f"step, e.g. {next((k for k in ref if k not in same), None)}")
    check(got_l == ref_l == want_launches({"cam_gate": 3 * DDP_ACC, "dfl_bwd": DDP_ACC}),
          f"[ddp-nccl] launches {got_l}, no group {ref_l}")
    print(f"[ddp-nccl] a one-rank NCCL group: {DDP_ACC} bf16 micro-steps of {DDP_BATCH // DDP_WORLD}x{IMGSZ} "
          f"({applies} apply) bit-equal to the no-group step ({len(ref)} tensors: parameters, BN statistics, EMA, "
          f"momentum), launches {got_l} in both; an NCCL all-reduce on the card")
    return got_l


def ddp_fit_rank(rank: int, world: int, out_dir: str, data_yaml: str, project: str, mesh_spatial: int = 1,
                 name: str = "ddp-fit", on_device: bool = False) -> None:
    """One rank of ``[ddp-fit]``: ``MGA.train`` for one validated epoch on
    ``cuda:0`` in a gloo group (with ``augment.on_device`` if asked); saves
    what it computed and launched."""
    import torch

    from mga_yolo_tpu_torch.api import MGA
    from mga_yolo_tpu_torch.train import trainer as T

    rows = []

    class RecordingBus(T.CallbackBus):
        def fire(self, event, **kw):
            if event == "on_fit_epoch_end":
                rows.append({k: v for k, v in kw["row"].items() if k != "time"})
            super().fire(event, **kw)

    T.CallbackBus = RecordingBus
    torch.cuda.set_device(0)
    ddp_group(torch, "gloo", rank, world, out_dir)
    try:
        m = MGA("configs/models/yolov8_cbam.yaml", scale="n")
        zero_launches()
        t0 = time.perf_counter()
        final = m.train("configs/hyperparams/cbam_defaults.yaml", data=data_yaml, imgsz=IMGSZ, batch=TRAIN_BATCH,
                        nbs=NBS, fraction=MESH_FIT_FRACTION, workers=4, max_boxes=MAX_BOXES, val=True, save=True, amp=True, epochs=1,
                        device="cuda:0", project=project, name=name, mesh_spatial=mesh_spatial,
                        on_device=on_device)
        wall = time.perf_counter() - t0
        tr = m._trainer
        (st,) = tr.epoch_stats
        out = {"launches": read_launches(), "rows": rows, "map": (final.metrics.map50, final.metrics.map),
               "has_csv": tr.csv is not None, "save_dir": str(tr.save_dir), "steps": st["steps"],
               "images": st["images"], "train_s": st["train_s"], "wait_s": st["wait_s"], "val_s": st["val_s"],
               "val_batches": 2 * len(tr.val_loader), "wall": wall, "device_augment": tr.device_augment}
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def ddp_fit_phase(torch, np, data_yaml, tmp: Path) -> dict:
    """``[ddp-fit]``: two gloo ranks on the card run ``MGA.train`` for one
    validated epoch on the first 128 + 32 of the 256 + 64 images
    (cbam_defaults, global batch 16): rank 0 alone writes results.csv and
    weights/, both ranks compute the same rows and metrics, and each rank's
    launches are exact (its 8 micro-steps of 8 images and 2 + 2 validation
    batches of 8). Returns rank 0's."""
    import csv

    out_dir = tmp / "ddp-fit"
    out_dir.mkdir()
    spawn_ranks(ddp_fit_rank, (str(out_dir), str(data_yaml), str(tmp / "runs")))
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(DDP_WORLD)]
    a, b = ranks
    check(a["rows"] == b["rows"] and len(a["rows"]) == 1 and a["map"] == b["map"],
          f"[ddp-fit] the ranks computed different rows or metrics: {a['rows']} {b['rows']}")
    check(a["has_csv"] and not b["has_csv"] and a["save_dir"] == b["save_dir"], "[ddp-fit] a rank other than 0 writes")
    run_dir = Path(a["save_dir"])
    with open(run_dir / "results.csv", newline="") as f:
        check(len(list(csv.DictReader(f))) == 1, "[ddp-fit] results.csv does not have one row")
    for name in ("best.pt", "last.pt"):
        check((run_dir / "weights" / name).is_file(), f"[ddp-fit] {name} missing")
    steps = int(256 * MESH_FIT_FRACTION) // TRAIN_BATCH  # every rank takes every micro-step, on its 8 images
    val_batches = 2 * (int(64 * MESH_FIT_FRACTION) // TRAIN_BATCH)  # the epoch's and the final evaluation's
    want = want_launches({"cam_gate": 3 * (steps + val_batches), "dfl_bwd": steps, "nms_suppress": val_batches})
    for r, rk in enumerate(ranks):
        check(rk["steps"] == steps and rk["val_batches"] == val_batches and rk["images"] == steps * TRAIN_BATCH // 2,
              f"[ddp-fit] rank {r}: {rk['steps']} micro-steps, {rk['images']} images, {rk['val_batches']} val batches")
        check(rk["launches"] == want, f"[ddp-fit] rank {r}: launches {rk['launches']}, want {want}")
        print(f"[ddp-fit] rank {r}: 1 epoch, {rk['steps']} micro-steps of {TRAIN_BATCH // 2} images: train "
              f"{rk['train_s']:.2f} s -> {rk['images'] / rk['train_s']:.1f} img/s a rank, "
              f"{100 * rk['wait_s'] / rk['train_s']:.1f}% waiting on the loader; val {rk['val_s']:.2f} s; "
              f"{rk['wall']:.1f} s wall; launches {rk['launches']}")
    row = a["rows"][0]
    print(f"[ddp-fit] both ranks: train det {row['train/det/total']:.4f} seg {row['train/seg/total']:.4f}, val det "
          f"{row['val/det/total']:.4f}, mAP50 {a['map'][0]:.4f}; rank 0 alone wrote results.csv and weights/")
    return a["launches"]


# ------------------------------------------------------------ spatial mesh

SPATIAL_K, SPATIAL_TIMED = 2, 8  # a 1x2 mesh (each rank: every image, 320 of its 640 rows); timed bf16 micro-steps
SPATIAL_POOL_TOL = {"fwd": (1e-5, 1e-6), "bwd": (1e-4, 1e-5)}  # as the masked pool's kernel checks


def spatial_pool_check(torch, np) -> dict:
    """Under the mesh in effect, on the card in float32: the space-reduced
    CAM gate and masked pool (the reductions kernel on this rank's band,
    then the all-reduces) against ``cam_gate_ref`` / ``masked_pool_ref`` on
    the whole P3 map (B=4, C=64, 80 x 80), forward and backward, with one
    channel's max planted on both sides of the band boundary (its gradient
    splits over the two bands). Each rank takes 1/k of the cotangents of
    the (B, C) outputs it holds alike; the MLP's gradients are summed over
    the ranks. Returns the max abs errors; raises outside the tolerances."""
    from mga_yolo_tpu_torch import parallel
    from mga_yolo_tpu_torch.ops.cam_gate import cam_gate_ref
    from mga_yolo_tpu_torch.ops.masked_pool import masked_pool_ref
    from mga_yolo_tpu_torch.parallel import spatial

    mesh = parallel.mesh()
    k, r = mesh.space, mesh.space_rank
    x, m, *mlp = cam_inputs(torch, 4, 80, 80, 64, 4, torch.float32, seed=70)
    h = 80 // k
    x[1, 5, h - 1, 0] = x[1, 5, h, 2] = 9.0  # a max on both bands
    m[1, 0, h - 1, 0] = m[1, 0, h, 2] = 0.9
    g = torch.Generator(device="cuda").manual_seed(71)
    g_gate, g_avg, g_max = torch.randn((3, 4, 64), generator=g, device="cuda")
    res = {}
    for what in ("whole", "band"):
        rows = slice(None) if what == "whole" else slice(r * h, (r + 1) * h)
        part = 1.0 if what == "whole" else 1.0 / k
        xs, ms = x[:, :, rows].clone().requires_grad_(True), m[:, :, rows].clone().requires_grad_(True)
        ws = [w.clone().requires_grad_(True) for w in mlp]
        with parallel.using(None if what == "whole" else mesh):
            gate = (cam_gate_ref if what == "whole" else spatial.cam_gate)(xs, ms, *ws)
            pool = masked_pool_ref(xs, ms) if what == "whole" else spatial.pool_f32(xs, ms)
            gg = list(torch.autograd.grad((gate * g_gate * part).sum(), [xs, ms, *ws]))
            gp = list(torch.autograd.grad(((pool[0] * g_avg).sum() + (pool[1] * g_max).sum()) * part, [xs, ms]))
        if what == "band":
            parallel.all_reduce_sum_(gg[2:])
        res[what] = {"fwd": [gate, *pool], "bwd": gg + gp}
    errs = {}
    for kind in ("fwd", "bwd"):
        rtol, atol = SPATIAL_POOL_TOL[kind]
        errs[kind] = 0.0
        for i, (got, want) in enumerate(zip(res["band"][kind], res["whole"][kind])):
            if kind == "bwd" and i in (0, 1, 6, 7):  # dx and dm: this band's rows
                want = want[:, :, r * h:(r + 1) * h]
            errs[kind] = max(errs[kind], float((got - want).detach().abs().max()))
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                       msg=lambda e: f"[spatial] rank {r} pool check {kind} {i}: {e}")
    return errs


def spatial_step_rank(rank: int, world: int, out_dir: str) -> None:
    """One rank of ``[spatial]``: gloo on ``cuda:0``, a 1 x ``SPATIAL_K``
    mesh; the pool check, ``[ddp]``'s float32 micro-steps and the bf16
    micro-steps on the rank's band; saves to ``out_dir/rank{rank}.pt``."""
    import numpy as np
    import torch

    from mga_yolo_tpu_torch import parallel

    torch.cuda.set_device(0)
    ddp_group(torch, "gloo", rank, world, out_dir)
    try:
        with parallel.using(parallel.data_mesh(SPATIAL_K)):
            out = {"pool": spatial_pool_check(torch, np), "f32": ddp_f32_steps(torch, np, rank, world),
                   "bf16": ddp_bf16_steps(torch, np, rank, world, SPATIAL_TIMED)}
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def spatial_phase(torch, np, tmp: Path) -> dict:
    """``[spatial]``: two gloo ranks on the card on a 1x2 mesh, each holding
    every image of ``[ddp]``'s 16-image global batches and half of its rows,
    held to one float32 process and to the float64 step by ``[ddp]``'s
    method (``ddp_phase``), the ranks bit-equal; the space-reduced pools
    against the plain versions with a max tied across the bands; then the
    bf16 micro-step: p50, halo exchanges and space collectives per
    micro-step. Returns rank 0's launches over the timed bf16 micro-steps.
    ``chip_smoke.py --spatial-faults`` shows that planted faults of the
    spatial code fail it."""
    out_dir = tmp / "spatial"
    out_dir.mkdir()
    t0 = time.perf_counter()
    spawn_ranks(spatial_step_rank, (str(out_dir),))
    wall = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(DDP_WORLD)]
    want, ref = f32_references(torch, np, "[spatial]")
    a, b = (rk["f32"] for rk in ranks)
    e_one, e_two, e_direct = ddp_state_errors(want, ref), ddp_state_errors(a, ref), ddp_state_errors(a, want)
    fmt = lambda e: f"items {e['items']:.2e}; " + ", ".join(  # noqa: E731
        f"{w} {e[w][0]:.2e} / {e[w][1]:.2e} ({e[w][2]}), rms {e[w][3]:.2e}" for w in DDP_STATE)
    want_l = want_launches({"masked_reductions": 3 * DDP_ACC, "dfl_bwd": DDP_ACC})
    print(f"[spatial] {DDP_WORLD} gloo ranks on cuda:0 on a 1x{SPATIAL_K} mesh, {DDP_ACC} float32 micro-steps (TF32 "
          f"off) of a global batch {DDP_BATCH}x{IMGSZ} (every image a rank, {IMGSZ // SPATIAL_K} of its rows), one "
          f"apply; launches per rank {a['launches']}; {wall:.1f} s wall. Against the float64 step: {fmt(e_two)}")
    print(f"[spatial] against one float32 process: {fmt(e_direct)}")
    for r, rk in enumerate(ranks):
        g = rk["f32"]
        print(f"[spatial] rank {r}: pools against the plain versions on the whole map, max abs err forward "
              f"{rk['pool']['fwd']:.2e}, backward {rk['pool']['bwd']:.2e} (a max tied across the bands)")
        check(g["opt_step"] == want["opt_step"] == 1, f"[spatial] rank {r}: {g['opt_step']} applies")
        check(g["launches"] == want_l, f"[spatial] rank {r}: launched {g['launches']}, want {want_l}")
        torch.testing.assert_close(g["items"], want["items"], rtol=TRAIN_ITEMS_RTOL, atol=0,
                                   msg=lambda s: f"[spatial] rank {r} items: {s}")
        for what in ("bn", "ema_bn"):
            for k, w in want[what].items():
                torch.testing.assert_close(g[what][k], w, rtol=TRAIN_ITEMS_RTOL, atol=TRAIN_PARAM_ATOL,
                                           msg=lambda s: f"[spatial] rank {r} {what} {k}: {s}")
        e = ddp_state_errors(g, ref)
        for w, i, cap in (("params", 0, DDP_PARAM_CAP), ("ema", 0, DDP_PARAM_CAP), ("m", 1, DDP_M_CAP)):
            check(e[w][3] <= DDP_F64_FACTOR * e_one[w][3], f"[spatial] rank {r}: {w} rms err {e[w][3]:.2e} against "
                  f"the float64 step, over {DDP_F64_FACTOR:g}x one float32 process's {e_one[w][3]:.2e}")
            check(e[w][i] <= cap, f"[spatial] rank {r}: {w} max err {e[w][i]:.2e} against the float64 step "
                  f"({e[w][2]}), over the limit {cap}")
    for what in DDP_STATE:
        check(all(torch.equal(a[what][k], b[what][k]) for k in a[what]), f"[spatial] ranks 0 and 1 differ in {what}")
    print(f"[spatial] items and BN statistics within rtol {TRAIN_ITEMS_RTOL} of one process; against the float64 step "
          f"params, EMA and momentum within {DDP_F64_FACTOR:g}x one float32 process's rms error (ratios "
          f"{', '.join(f'{w} {e_two[w][3] / e_one[w][3]:.2f}' for w in ('params', 'ema', 'm'))}), max errors within "
          f"{DDP_PARAM_CAP} abs / {DDP_M_CAP} x max|m|; ranks 0 and 1 bit-equal")
    for r, rk in enumerate(ranks):
        h = rk["bf16"]
        lat = sorted(h["times"])
        halos, space, per = h["halo_exchanges"], h["space_collectives"], h["collectives"]
        check(len(set(halos)) == 1 and len(set(space)) == 1 and halos[0] > 0,
              f"[spatial] rank {r}: halo exchanges {halos}, space collectives {space} per micro-step")
        check(sorted(set(per)) == [min(per), min(per) + 1] and per.count(min(per) + 1) == SPATIAL_TIMED // DDP_ACC,
              f"[spatial] rank {r}: collectives per micro-step {per}, want one more at an apply")
        want_l = want_launches({"masked_reductions": 3 * SPATIAL_TIMED, "dfl_bwd": SPATIAL_TIMED})
        check(h["launches"] == want_l, f"[spatial] rank {r}: bf16 launches {h['launches']}, want {want_l}")
        print(f"[spatial] rank {r}: {SPATIAL_TIMED} bf16 micro-steps of {DDP_BATCH}x{IMGSZ // SPATIAL_K}x{IMGSZ} "
              f"(a band of the global {DDP_BATCH}x{IMGSZ}, accumulate {DDP_ACC}): p50 {lat[len(lat) // 2]:.2f} ms, "
              f"max {lat[-1]:.2f} ms; per micro-step {min(per)} collectives (+1 at an apply), of them {space[0]} "
              f"over the space ranks, {halos[0]} halo exchanges; launches {h['launches']}")
    return ranks[0]["bf16"]["launches"]


def spatial_fit_phase(torch, np, data_yaml, tmp: Path, on_device: bool = False) -> dict:
    """``[spatial-fit]``: two gloo ranks on the card run ``MGA.train`` with
    ``mesh_spatial: 2`` for one validated epoch on ``[ddp-fit]``'s 128 + 32 images
    (cbam_defaults, global batch 16): each rank takes every micro-step on
    its band of the 16 images, rank 0 alone writes, both compute the same
    rows and metrics, and each rank's launches are exact (the masked
    reductions 3 a micro-step and a validation batch, the DFL backward 1 a
    micro-step, NMS 1 a validation batch of the gathered outputs). With
    ``on_device`` (``[spatial-fit-dev]``) both ranks take the device
    augmentation (each warps the whole canvases of the 16 images, then keeps
    its band), with the same launches: the augment runs no kernel of this
    repository. Returns rank 0's."""
    import csv

    tag = "[spatial-fit-dev]" if on_device else "[spatial-fit]"
    out_dir = tmp / tag[1:-1]
    out_dir.mkdir()
    spawn_ranks(ddp_fit_rank, (str(out_dir), str(data_yaml), str(tmp / "runs"), SPATIAL_K, tag[1:-1], on_device))
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(DDP_WORLD)]
    a, b = ranks
    check(a["device_augment"] == b["device_augment"] == on_device, f"{tag} the device augmentation ran: "
                                                                       f"{a['device_augment']}, {b['device_augment']}")
    check(a["rows"] == b["rows"] and len(a["rows"]) == 1 and a["map"] == b["map"],
          f"{tag} the ranks computed different rows or metrics: {a['rows']} {b['rows']}")
    check(a["has_csv"] and not b["has_csv"] and a["save_dir"] == b["save_dir"], f"{tag} a rank other than 0 writes")
    run_dir = Path(a["save_dir"])
    with open(run_dir / "results.csv", newline="") as f:
        check(len(list(csv.DictReader(f))) == 1, f"{tag} results.csv does not have one row")
    steps = int(256 * MESH_FIT_FRACTION) // TRAIN_BATCH  # every rank: every micro-step and val batch
    val_batches = 2 * (int(64 * MESH_FIT_FRACTION) // TRAIN_BATCH)
    want = want_launches({"masked_reductions": 3 * (steps + val_batches), "dfl_bwd": steps,
                          "nms_suppress": val_batches})
    for r, rk in enumerate(ranks):
        check(rk["steps"] == steps and rk["val_batches"] == val_batches and rk["images"] == steps * TRAIN_BATCH,
              f"{tag} rank {r}: {rk['steps']} micro-steps, {rk['images']} images, {rk['val_batches']} val "
              f"batches")
        check(rk["launches"] == want, f"{tag} rank {r}: launches {rk['launches']}, want {want}")
        print(f"{tag} rank {r}: 1 epoch, {rk['steps']} micro-steps of {TRAIN_BATCH} images' bands of "
              f"{IMGSZ // SPATIAL_K} rows: train {rk['train_s']:.2f} s -> {rk['images'] / rk['train_s']:.1f} img/s "
              f"(bands), {100 * rk['wait_s'] / rk['train_s']:.1f}% waiting on the loader; val {rk['val_s']:.2f} s; "
              f"{rk['wall']:.1f} s wall; launches {rk['launches']}")
    row = a["rows"][0]
    print(f"{tag} both ranks: train det {row['train/det/total']:.4f} seg {row['train/seg/total']:.4f}, val "
          f"det {row['val/det/total']:.4f}, mAP50 {a['map'][0]:.4f}; rank 0 alone wrote results.csv and weights/")
    return a["launches"]


# ------------------------------------------- baseline toolchain and the grid

BASE_LAYERS = {15: 80, 18: 40, 21: 20}  # the plain graph's P3/P4/P5 neck outputs -> rows at 640 px
GRID_FRACTION = 0.25  # the grid's jobs train on 64 of the 256 images, validate on 16 of the 64 (depth)


def base_phase(torch, np, data_yaml, tmp: Path) -> dict:
    """``[base]``: ``tools.train`` (plain YOLOv8n, base_defaults, 640 px,
    bf16, batch 16, nbs 64) for one validated epoch on the 256 + 64 images,
    launches exact (the DFL backward 1 a micro-step, NMS 1 a validation
    batch, no attention kernel); then ``tools.val --save-fm`` on its
    best.pt: ``metrics.json`` equal to ``cli.val``'s on the same checkpoint
    at conf 0.001 / iou 0.7, the layer 15/18/21 maps NHWC at 80/40/20 rows,
    and without matplotlib (the card's host) no feature-map PNG and the
    message that says why. Returns the training run's launches."""
    import contextlib
    import csv
    import io

    from mga_yolo_tpu_torch.cli import val as cli_val
    from mga_yolo_tpu_torch.tools import train as base_train
    from mga_yolo_tpu_torch.tools import val as base_val
    from mga_yolo_tpu_torch.train import trainer as T
    from mga_yolo_tpu_torch.train.validator import FM_WAIT
    from mga_yolo_tpu_torch.utils import plotting

    held = {}
    fit = T.MGATrainer.train

    def keep(self):
        held["tr"] = self
        return fit(self)

    T.MGATrainer.train = keep
    zero_launches()
    t0 = time.perf_counter()
    try:
        final = base_train.main(["--cfg", "configs/hyperparams/base_defaults.yaml", "--data", str(data_yaml),
                                 "--imgsz", str(IMGSZ), "--batch", str(TRAIN_BATCH), "--nbs", str(NBS), "--epochs",
                                 "1", "--workers", "8", "--max_boxes", str(MAX_BOXES), "--amp", "true",
                                 "--project", str(tmp / "runs"), "--name", "base"])
    finally:
        T.MGATrainer.train = fit
    wall = time.perf_counter() - t0
    launches = read_launches()
    tr = held["tr"]
    plain = (tr.cfg.train.model, tr.cfg.train.task, tr.cfg.seg.enabled) == ("configs/models/yolov8.yaml", "detect", False)
    check(plain and not tr.spec.mask_head_indices, "[base] the run is not the plain baseline")
    (st,) = tr.epoch_stats
    steps, val_batches = st["steps"], 2 * len(tr.val_loader)  # the epoch's and the final evaluation's
    check(steps == 256 // TRAIN_BATCH and val_batches == 2 * (64 // TRAIN_BATCH),
          f"[base] {steps} micro-steps, {val_batches} validation batches")
    want = want_launches({"dfl_bwd": steps, "nms_suppress": val_batches})
    check(launches == want, f"[base] launches {launches}, want {want}")
    with open(tr.save_dir / "results.csv", newline="") as f:
        (row,) = list(csv.DictReader(f))
    check(float(row["train/seg/total"]) == 0.0 and np.isfinite(float(row["train/det/total"])),
          f"[base] train seg {row['train/seg/total']}, det {row['train/det/total']}")
    v, secs = st["val_speed"], st["train_s"]
    print(f"[base] tools.train, plain YOLOv8n, 1 epoch: train {secs:.2f} s, {st['images']} images in {steps} "
          f"micro-steps -> {st['images'] / secs:.1f} img/s, {100 * st['wait_s'] / secs:.1f}% waiting on the loader; "
          f"val {st['val_s']:.2f} s (preprocess {v['preprocess']:.2f}, inference {v['inference']:.2f}, postprocess "
          f"{v['postprocess']:.2f} ms an image); mAP50 {final.metrics.map50:.4f}; {wall:.1f} s wall; "
          f"launches {launches}")

    best = tr.save_dir / "weights" / "best.pt"
    buf = io.StringIO()
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = base_val.main(["--weights", str(best), "--data", str(data_yaml), "--batch", str(TRAIN_BATCH),
                             "--save-fm", "--out", str(tmp / "base-val")])
    val_wall = time.perf_counter() - t0
    val_launches = read_launches()
    check(val_launches == want_launches(), f"[base] tools.val launched {val_launches}: its NMS is the host's")
    got = json.loads((out / "metrics.json").read_text())
    ref = cli_val.main(["--weights", str(best), "--data", str(data_yaml), "--batch", str(TRAIN_BATCH), "--conf",
                        "0.001", "--iou", "0.7"])
    check(got == ref.results_dict(), f"[base] tools.val metrics {got} differ from cli.val's {ref.results_dict()}")
    fm = sorted(p.name for p in (out / "fm").iterdir())
    n_batches = min(4, 64 // TRAIN_BATCH)  # --save-fm-max 4
    for b in range(n_batches):
        for layer, rows in BASE_LAYERS.items():
            a = np.load(out / "fm" / f"batch{b}_layer{layer}.npy", mmap_mode="r")
            check(a.ndim == 4 and a.shape[:3] == (TRAIN_BATCH, rows, rows) and bool(np.isfinite(a).all()),
                  f"[base] fm batch{b} layer{layer}: {a.shape}")
    npy = [n for n in fm if n.endswith(".npy")]
    pngs = [n for n in fm if n.endswith(".png")]
    if plotting.available():
        check(len(pngs) == len(npy), f"[base] {len(npy)} maps but {len(pngs)} feature-map PNGs")
    else:
        check(not pngs and FM_WAIT in buf.getvalue(), f"[base] without matplotlib: PNGs {pngs}, message "
                                                      f"{FM_WAIT in buf.getvalue()}")
    overlays = sorted((out / "preds").glob("*_dets.jpg"))
    check(len(overlays) == 4 * n_batches, f"[base] {len(overlays)} overlays")
    print(f"[base] tools.val --save-fm on best.pt: 64 images in {val_wall:.1f} s wall "
          f"({64 / val_wall:.1f} img/s with the maps and files), launches {val_launches}; metrics.json equal to "
          f"cli.val's ({got}); {len(npy)} NHWC maps (layers 15/18/21 at 80/40/20 rows), {len(pngs)} feature-map "
          f"PNGs (matplotlib {'present' if plotting.available() else 'absent: ' + FM_WAIT}), {len(overlays)} "
          f"overlays")
    return launches


def grid_phase(torch, np, data_yaml, tmp: Path) -> None:
    """``[grid]``: ``scripts.performance_comparison`` on a two-job experiment
    (MaskCBAM and MaskECA, scale n, one epoch each on 64 of the 256 images,
    validated on 16 of the 64 val images, 640 px, batch 16, ``slots: 2``:
    both train on the one card at once), then ``scripts.base_comparison``
    with one job.
    Every job must end ``done`` with progress ``1/1`` parsed from its
    output, and leave its results.csv and weights/best.pt. The jobs are
    child processes: the check is their runs' own results, not the launch
    counters."""
    import csv

    from mga_yolo_tpu_torch.scripts import base_comparison, performance_comparison
    from mga_yolo_tpu_torch.utils import yaml_lite

    def hyp(name: str) -> str:
        cfg = yaml_lite.load(f"configs/hyperparams/{name}_defaults.yaml")
        cfg.update(epochs=1, imgsz=IMGSZ, batch=TRAIN_BATCH, nbs=NBS, workers=4, max_boxes=MAX_BOXES,
                   fraction=GRID_FRACTION)
        path = tmp / f"grid-{name}.yaml"
        yaml_lite.dump(cfg, path)
        return str(path)

    def run(module, exp: dict, tag: str) -> list:
        path = tmp / f"{tag}.yaml"
        yaml_lite.dump({**exp, "data": str(data_yaml), "project": str(tmp / tag)}, path)
        t0 = time.perf_counter()
        try:
            jobs = module.main(["--exp", str(path)])
        except SystemExit as e:
            raise RuntimeError(f"[grid] {tag}: a job failed (exit {e.code})") from None
        wall = time.perf_counter() - t0
        for j in jobs:
            check(j.status == "done" and j.progress == "1/1", f"[grid] {tag} {j.name}: {j.status}, progress "
                                                              f"{j.progress!r}")
            run_dir = tmp / tag / j.name
            check((run_dir / "weights" / "best.pt").is_file(), f"[grid] {run_dir}/weights/best.pt missing")
            with open(run_dir / "results.csv", newline="") as f:
                (row,) = list(csv.DictReader(f))
            secs = float(row["time"])
            print(f"[grid] {tag} {j.name}: {j.status}, epoch {j.progress}; train {secs:.2f} s -> "
                  f"{int(256 * GRID_FRACTION) / secs:.1f} img/s, det {float(row['train/det/total']):.4f}, mAP50 "
                  f"{float(row['metrics/mAP50(B)']):.4f}")
        print(f"[grid] {tag}: {len(jobs)} job(s) done in {wall:.1f} s wall (slots {exp['slots']})")
        return jobs

    run(performance_comparison, {"models": ["cbam", "eca"], "scales": ["n"], "folds": [0], "hyp": hyp("cbam"),
                                 "slots": 2}, "grid")
    run(base_comparison, {"scales": ["n"], "folds": [0], "hyp": hyp("base"), "slots": 1}, "base-grid")


# planted faults of ``--ddp-faults``, each [ddp] must catch: (file, text as it stands, its replacement)
_LAYERS, _STATE = "mga_yolo_tpu_torch/models/layers.py", "mga_yolo_tpu_torch/train/state.py"
DDP_FAULTS = {
    "bn-backward-unreduced": [(_LAYERS, "        parallel.all_reduce_sum_([glob])\n", "")],
    "bn-statistics-per-rank": [(_LAYERS, "        parallel.all_reduce_sum_([s])\n", ""),
                               (_LAYERS, "        parallel.all_reduce_sum_([m2])\n", "")],
    "bn-variance-unbiased": [(_LAYERS, "        var = m2 / n\n", "        var = m2 / (n - 1)\n")],
    "gradient-unreduced": [(_STATE, "parallel.all_reduce_sum_(grads)", "pass")],
}


# planted faults of ``--spatial-faults``, each [spatial] must catch
_SPATIAL, _DET = "mga_yolo_tpu_torch/parallel/spatial.py", "mga_yolo_tpu_torch/losses/detection.py"
SPATIAL_FAULTS = {
    "halo-row-dropped": [(_SPATIAL, "        up.append(pad if g < 0 else", "        up.append(pad if g < 0 or i == 0 else")],
    "reductions-not-all-reduced": [
        (_SPATIAL, "        sums = _all_reduce_(sums, mesh)\n", ""),
        (_SPATIAL, "        mmax = _all_reduce_(mmax, mesh, dist.ReduceOp.MAX)\n", "")],
    "detection-loss-k-times": [(_DET, "        total = total / share.space\n", "")],
    "n-ties-local": [(_SPATIAL, "        buf = _all_reduce_(torch.cat([*parts, is_max.float().sum(-1)], 1), _mesh())\n",
                      "        buf = torch.cat([_all_reduce_(torch.cat(parts, 1), _mesh()), is_max.float().sum(-1)], 1)\n")],
}


# ------------------------------------------------------------- image codecs

JPEG_FIXTURES = Path(__file__).resolve().parent / "tests" / "jpeg_fixtures"
JPEG_REQUESTS, JPEG_THREADS = 64, 4  # uploads POSTed to the server, client threads
JPEG_FED_IMAGES = 64  # JPEG training images: 4 micro-steps of 16 an epoch
JPEG_PREDICT_IMAGES = 16


def decode_ms(fn, data: bytes, reps: int, threads: int) -> float:
    """ms per image of ``fn(data)``: the median of ``reps`` calls on one
    thread, or with ``threads`` > 1 the wall time of ``threads * reps``
    calls spread over that many threads, divided by the calls."""
    from concurrent.futures import ThreadPoolExecutor

    fn(data)
    if threads == 1:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(data)
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]
    with ThreadPoolExecutor(threads) as pool:
        t0 = time.perf_counter()
        list(pool.map(lambda _: fn(data), range(threads * reps)))
        return (time.perf_counter() - t0) * 1e3 / (threads * reps)


def jpeg_dataset(np, data_yaml, root: Path, n: int) -> Path:
    """The first ``n`` training images of ``data_yaml``'s dataset written as
    JPEG by the port's encoder (quality 95), with their labels and masks:
    the images a ``fraction`` of n / 256 of the PNG dataset reads."""
    import shutil

    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.utils import yaml_lite

    src = Path(data_yaml).parent
    for d in ("images/train", "labels/train"):
        (root / d).mkdir(parents=True)
    shutil.copytree(src / "masks", root / "masks")
    for png in sorted((src / "images" / "train").iterdir())[:n]:
        image_io.imwrite(root / "images" / "train" / f"{png.stem}.jpg", image_io.imread(png))
        shutil.copy(src / "labels" / "train" / f"{png.stem}.txt", root / "labels" / "train")
    yaml_lite.dump({"path": str(root), "train": "images/train", "val": "images/train", "dataset": str(root),
                    "masks_dir": "masks", "names": {0: "stenosis"}, "nc": 1}, root / "data.yaml")
    return root / "data.yaml"


def jpeg_phase(torch, np, data_yaml, best: Path, tmp: Path, device: str = "cuda") -> dict:
    """The image codecs of the port's host C++ library (``native/jpeg.cpp``,
    ``native/bmp.cpp``) on the card's host, and the paths that read JPEG.

    (a) each committed fixture (``tests/jpeg_fixtures``) decoded, colour and
    grey, equal to cv2's pixels stored beside it; the three timing files'
    decodes to their stored SHA-256. (b) decode ms per image, 1 thread and
    8, of a 512 px grey baseline file, the same picture progressive, and a
    640 px BGR 4:2:0 file. (c) encode ms of the 640 px picture, and
    ``decode(encode(x))`` deterministic. (d) the flagship (``[path]``'s
    model: seed 0, bf16, BN-folded) behind ``MGAServer`` on 127.0.0.1: 64
    JPEG uploads POSTed from 4 threads, each reply's boxes within
    ``[parity]``'s tolerance of ``InferenceEngine`` on the port's decode of
    the same bytes, launches exact (3 CAM gates and 1 NMS a batch);
    requests/s for the JPEG uploads and for PNG uploads of the same
    pictures, in turns (JPEG, PNG, PNG, JPEG), a new server each. (e) 64 JPEG training images written by the port's encoder,
    read through MGADataset and DataLoader (batch 16, 8 threads): the
    loader's images/s alone and 4 + 1 fed bf16 micro-steps (3 CAM gates and
    1 DFL backward each, exactly), beside the same 64 pictures as PNG.
    (f) ``cli.predict`` on best.pt over a JPEG directory: ``{stem}_pred.jpg``
    files that the port's decoder reads back. Returns the launches of (d)
    and (e)."""
    import contextlib
    import hashlib
    import io
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.cli import predict as cli_predict
    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.data.dataset import MGADataset
    from mga_yolo_tpu_torch.data.loader import DataLoader
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.serve import InferenceEngine, MGAServer, MicroBatcher
    from mga_yolo_tpu_torch.train import optim
    from mga_yolo_tpu_torch.train import state as S

    t_phase = time.perf_counter()
    # (a) the fixtures, exactly
    pixels = np.load(JPEG_FIXTURES / "pixels.npz")
    digests = json.loads((JPEG_FIXTURES / "bench.json").read_text())
    stems = sorted(p.stem for p in JPEG_FIXTURES.glob("*.jpg") if p.stem not in digests)
    check(len(stems) >= 12, f"[jpeg] {len(stems)} fixtures")
    for stem in stems:
        data = (JPEG_FIXTURES / f"{stem}.jpg").read_bytes()
        for key, got in ((stem, image_io.imdecode(data)), (f"{stem}_gray", image_io.decode(data, gray=True))):
            check(got.shape == pixels[key].shape and bool((got == pixels[key]).all()),
                  f"[jpeg] {key}: the port's decode differs from cv2's pixels")
    bench = {stem: (JPEG_FIXTURES / f"{stem}.jpg").read_bytes() for stem in digests}
    for stem, data in bench.items():
        for mode, gray in (("color", False), ("gray", True)):
            got = hashlib.sha256(image_io.decode(data, gray=gray).tobytes()).hexdigest()
            check(got == digests[stem][mode], f"[jpeg] {stem} {mode}: SHA-256 {got[:12]} is not cv2's")
    print(f"[jpeg] (a) {len(stems)} fixtures ({', '.join(stems)}) decoded by {native.library_path().name}, "
          f"built on this host: colour and grey equal to cv2's pixels exactly; the 3 timing files' decodes "
          f"have cv2's SHA-256")

    # (b) decode and (c) encode times
    for stem, data in bench.items():
        info = native.jpeg_header(data)
        one, eight = decode_ms(image_io.imdecode, data, 15, 1), decode_ms(image_io.imdecode, data, 8, 8)
        print(f"[jpeg] (b) decode {stem} ({info['height']}x{info['width']}, {info['components']} component(s), "
              f"{'progressive' if info['progressive'] else 'baseline'}, {len(data) / 1e3:.1f} kB) to BGR: "
              f"{one:.3f} ms an image on 1 thread, {eight:.3f} ms an image with 8 threads -> "
              f"{1e3 / eight:.0f} images/s")
    x = image_io.imdecode(bench["bgr640_420"])
    enc = decode_ms(image_io.encode_jpeg, x, 15, 1)
    a, b = image_io.encode_jpeg(x), image_io.encode_jpeg(x)
    check(a == b and bool((image_io.imdecode(a) == image_io.imdecode(b)).all()), "[jpeg] encode is not deterministic")
    print(f"[jpeg] (c) encode the 640x640 BGR picture at quality 95: {enc:.3f} ms ({len(a) / 1e3:.1f} kB); "
          f"decode(encode(x)) deterministic")

    # (d) the flagship behind MGAServer, JPEG uploads
    val_pngs = sorted((Path(data_yaml).parent / "images" / "val").iterdir())[:JPEG_REQUESTS]
    pngs = [p.read_bytes() for p in val_pngs]
    jpgs = [image_io.encode_jpeg(image_io.imdecode(d)) for d in pngs]
    torch.manual_seed(0)
    model, _ = create_model(YOLOV8_CBAM, scale="n", nc=1, device=device)
    eng = InferenceEngine(model, imgsz=IMGSZ, batch=BATCH, conf=0.001)  # bf16, BN-folded on the card
    eng.warmup()
    del model
    decoded = [image_io.imdecode(d) for d in jpgs]
    want = []
    for i in range(0, len(decoded), BATCH):
        lbs, metas = zip(*(eng.preprocess(im) for im in decoded[i:i + BATCH]))
        want += eng.infer_batch(list(lbs), list(metas))
    rates, replies, launches = {"JPEG": [], "PNG": []}, [], {"JPEG": {}}
    for kind, uploads in (("JPEG", jpgs), ("PNG", pngs), ("PNG", pngs), ("JPEG", jpgs)):  # in turns
        server = MGAServer(MicroBatcher(eng, max_wait_ms=5.0), host="127.0.0.1", port=0)
        server.start()

        def post(data: bytes, port=server.port) -> dict:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=data, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        try:
            zero_launches()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(JPEG_THREADS) as pool:
                got = list(pool.map(post, uploads))
            rates[kind].append(len(uploads) / (time.perf_counter() - t0))
            counts = read_launches()
            n_batches = server.batcher.stats()["batches"]
        finally:
            server.stop()
        want_l = want_launches({"cam_gate": 3 * n_batches, "nms_suppress": n_batches})
        check(counts == want_l, f"[jpeg] {kind} uploads: launches {counts} for {n_batches} batches, want {want_l}")
        if kind == "JPEG":
            replies += got
            launches["JPEG"] = {k: launches["JPEG"].get(k, 0) + v for k, v in counts.items()}
        print(f"[jpeg] (d) {len(uploads)} {kind} uploads ({sum(map(len, uploads)) / len(uploads) / 1e3:.1f} kB "
              f"each) POSTed from {JPEG_THREADS} threads to MGAServer on the flagship: {n_batches} batches, "
              f"{rates[kind][-1]:.1f} requests/s; launches {counts}")
    n_boxes, err = 0, 0.0
    for r, w in zip(replies, want + want):
        got = np.array([[b["x1"], b["y1"], b["x2"], b["y2"], b["conf"], b["cls"]] for b in r["boxes"]],
                       np.float32).reshape(-1, 6)
        check(r["orig_shape"] == list(w.orig_shape) and got.shape == w.boxes.shape
              and bool(np.allclose(got, w.boxes, rtol=PATH_RTOL, atol=PATH_ATOL)),
              f"[jpeg] a JPEG upload's boxes {got.shape} differ from the engine's on the port's decode "
              f"{w.boxes.shape}")
        n_boxes += len(got)
        err = max(err, float(np.abs(got - w.boxes).max(initial=0.0)))
    check(n_boxes > 0, "[jpeg] no boxes at conf 0.001")
    print(f"[jpeg] (d) every JPEG reply's boxes ({n_boxes}, two rounds) equal InferenceEngine's on the port's "
          f"decode of the same bytes: max abs error {err:.3g} (rtol {PATH_RTOL}, atol {PATH_ATOL}); requests/s "
          f"in turns JPEG {rates['JPEG'][0]:.1f}, PNG {rates['PNG'][0]:.1f}, PNG {rates['PNG'][1]:.1f}, JPEG "
          f"{rates['JPEG'][1]:.1f}")
    del eng

    # (e) fed training from JPEG files, beside the same pictures as PNG
    jpg_yaml = jpeg_dataset(np, data_yaml, tmp / "jpeg_ds", JPEG_FED_IMAGES)
    kw = dict(imgsz=IMGSZ, batch=TRAIN_BATCH, workers=8, max_boxes=MAX_BOXES)
    loaders = {
        "JPEG": DataLoader(MGADataset(load_config("configs/hyperparams/cbam_defaults.yaml", data=str(jpg_yaml),
                                                  **kw), "train", augment=True), TRAIN_BATCH, seed=0, workers=8),
        "PNG": DataLoader(MGADataset(load_config("configs/hyperparams/cbam_defaults.yaml", data=str(data_yaml),
                                                 fraction=JPEG_FED_IMAGES / 256, **kw), "train", augment=True),
                          TRAIN_BATCH, seed=0, workers=8)}
    check([p.stem for p in loaders["JPEG"].dataset.img_files] == [p.stem for p in loaders["PNG"].dataset.img_files],
          "[jpeg] the JPEG and PNG splits hold other pictures")
    torch.manual_seed(0)
    model, _ = create_model(YOLOV8_CBAM, scale="n", nc=1, training=True, device=device)
    sched = optim.Schedule(lr0=0.01, lrf=0.01, momentum=0.937, warmup_epochs=3.0, warmup_momentum=0.8,
                           warmup_bias_lr=0.1, epochs=100, steps_per_epoch=10)
    step = make_step(torch, model, max(round(NBS / TRAIN_BATCH), 1), torch.bfloat16, warmup_steps=sched.warmup_steps)
    st = S.create_train_state(model)
    st.step = st.last_apply = sched.warmup_steps - 4
    n_steps = len(loaders["JPEG"])
    for kind, loader in loaders.items():
        rate, n_img, n_b = host_rate(np, loader, 1)
        zero_launches()
        st, metrics, rows = fed_steps(torch, np, loader, step, st, sched, n_steps)
        got = read_launches()
        if kind == "JPEG":
            launches["fed"] = got
        want_l = want_launches({"cam_gate": 3 * (n_steps + 1), "dfl_bwd": n_steps + 1})
        check(got == want_l, f"[jpeg] {kind}-fed: launches {got} in {n_steps} + 1 micro-steps, want {want_l}")
        print(f"[jpeg] (e) {kind}: the loader alone {rate:.1f} images/s ({n_img} images, {n_b} boxes); "
              f"{n_steps} micro-steps B={TRAIN_BATCH}x{IMGSZ} bf16 fed by it: {fed_summary(rows)}; last loss "
              f"{float(metrics['loss']):.4f}; launches {got}")
    del step, st, model

    # (f) cli.predict over a JPEG directory
    src = tmp / "jpeg_ds" / "images" / "train"
    pred_src, out_dir = tmp / "jpeg_predict_src", tmp / "jpeg_predict"
    pred_src.mkdir()
    for f in sorted(src.iterdir())[:JPEG_PREDICT_IMAGES]:
        (pred_src / f.name).write_bytes(f.read_bytes())
    zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = cli_predict.main(["--weights", str(best), "--source", str(pred_src), "--out", str(out_dir), "--batch",
                                str(TRAIN_BATCH)] + ([] if device == "cuda" else ["--device", device]))
    wall = time.perf_counter() - t0
    got = read_launches()
    check(got == want_launches({"cam_gate": 3 * -(-JPEG_PREDICT_IMAGES // TRAIN_BATCH)}),
          f"[jpeg] cli.predict launches {got}")
    overlays = sorted(out_dir.glob("*_pred.jpg"))
    check(res["images"] == JPEG_PREDICT_IMAGES and [p.name for p in overlays]
          == [f"{f.stem}_pred.jpg" for f in sorted(pred_src.iterdir())], f"[jpeg] cli.predict wrote {len(overlays)}")
    shapes = {image_io.imread(p).shape for p in overlays}
    check(shapes == {image_io.imread(next(pred_src.iterdir())).shape}, f"[jpeg] overlays read back as {shapes}")
    print(f"[jpeg] (f) cli.predict on best.pt over {JPEG_PREDICT_IMAGES} JPEGs: {wall:.2f} s with the model load; "
          f"{len(overlays)} overlays {overlays[0].name} ... read back by the port's decoder as {shapes.pop()}; "
          f"launches {got}")
    print(f"[jpeg] the phase took {time.perf_counter() - t_phase:.1f} s")
    return {k: sum(v[k] for v in (launches["JPEG"], launches["fed"])) for k in launches["JPEG"]}


STILL_FIXTURES = Path(__file__).resolve().parent / "tests" / "still_fixtures"
FORMATS_UPLOADS = 16  # uploads of each kind POSTed to the server
FORMATS_FED_IMAGES, FORMATS_DISTINCT_TIFF = 64, 16  # training files a format; distinct LZW encodes among them


def formats_dataset(np, data_yaml, root: Path, kind: str) -> Path:
    """The first ``FORMATS_FED_IMAGES`` training images of ``data_yaml``'s
    dataset with their labels, as 16-bit PNG images with 1-bit PNG masks
    (``kind`` "png16") or as LZW TIFF images (predictor 2) with PackBits
    1-bit TIFF masks ("tiff"), written here by the test writers (numpy and
    zlib; the card's host has no cv2 or PIL). The TIFF set holds
    ``FORMATS_DISTINCT_TIFF`` pictures, each under four names with its
    labels: the writer's Python LZW takes ~0.25 s a picture."""
    import shutil

    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.utils import yaml_lite
    from tests.still_fixtures import writers

    src = Path(data_yaml).parent
    for d in ("images/train", "labels/train", "masks"):
        (root / d).mkdir(parents=True)
    pngs = sorted((src / "images" / "train").iterdir())
    for i in range(FORMATS_FED_IMAGES):
        png = pngs[i if kind == "png16" else i % FORMATS_DISTINCT_TIFF]
        stem = f"{kind}{i:04d}"
        img = image_io.imread_gray(png)[..., None].astype(np.int64)
        mask = (image_io.imread_gray(src / "masks" / png.name) > 0).astype(np.uint8)[..., None]
        if kind == "png16":
            (root / "images/train" / f"{stem}.png").write_bytes(
                writers.png_bytes(img * 256 + (255 - img), 16, 0, filters=(1,), level=6))
            (root / "masks" / f"{stem}.png").write_bytes(writers.png_bytes(mask, 1, 0, filters=(0,), level=6))
        elif i < FORMATS_DISTINCT_TIFF:
            (root / "images/train" / f"{stem}.tif").write_bytes(
                writers.tiff_bytes(img, 8, 1, compression=5, predictor=2, rows_per_strip=64))
            (root / "masks" / f"{stem}.tif").write_bytes(writers.tiff_bytes(mask, 1, 1, compression=32773))
        else:
            first = f"{kind}{i % FORMATS_DISTINCT_TIFF:04d}"
            shutil.copy(root / "images/train" / f"{first}.tif", root / "images/train" / f"{stem}.tif")
            shutil.copy(root / "masks" / f"{first}.tif", root / "masks" / f"{stem}.tif")
        shutil.copy(src / "labels" / "train" / f"{png.stem}.txt", root / "labels/train" / f"{stem}.txt")
    yaml_lite.dump({"path": str(root), "train": "images/train", "val": "images/train", "dataset": str(root),
                    "masks_dir": "masks", "names": {0: "stenosis"}, "nc": 1}, root / "data.yaml")
    return root / "data.yaml"


def formats_phase(torch, np, data_yaml, tmp: Path, device: str = "cuda") -> dict:
    """The still formats the JAX package lists (``IMG_EXTS``): PNG at every
    bit depth and Adam7, TIFF, WebP (``data/image_io.py`` on
    ``native/maskops.cpp``, ``native/tiff.cpp``, ``native/webp.cpp``),
    built on the card's host.

    (a) each committed fixture (``tests/still_fixtures``) decoded, colour
    and grey, equal to cv2's pixels stored beside it; the four timing files'
    decodes to their stored SHA-256. (b) decode ms of the 512 x 512 grey
    angiogram on one thread, colour and grey read: 16-bit PNG, LZW TIFF,
    lossless and lossy WebP. (c) the flagship (seed 0, bf16, BN-folded)
    behind ``MGAServer`` on 127.0.0.1: 16 uploads of each kind (16-bit PNG,
    LZW TIFF, PNG with eXIf orientation 6, written from the val pictures;
    WebP, the committed lossless and lossy files) POSTed from 4 threads,
    each reply's boxes within ``[parity]``'s tolerance of
    ``InferenceEngine`` on the port's decode of the same bytes, the turned
    PNG answered at its turned size, launches exact (3 CAM gates and 1 NMS
    a batch). (d) 4 + 1 bf16 micro-steps at batch 16, 640 px, fed through
    MGADataset and DataLoader from 64 16-bit PNG images with 1-bit PNG
    masks, then from 64 LZW TIFF images with PackBits TIFF masks: launches
    exact (3 CAM gates and 1 DFL backward a micro-step). Returns the
    launches of (c) and (d)."""
    import hashlib
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.data.dataset import MGADataset
    from mga_yolo_tpu_torch.data.loader import DataLoader
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.serve import InferenceEngine, MGAServer, MicroBatcher
    from mga_yolo_tpu_torch.train import optim
    from mga_yolo_tpu_torch.train import state as S
    from tests.still_fixtures import writers

    t_phase = time.perf_counter()
    # (a) the fixtures, exactly
    pixels = np.load(STILL_FIXTURES / "pixels.npz")
    digests = json.loads((STILL_FIXTURES / "bench.json").read_text())
    names = sorted(k for k in pixels.files if not k.endswith("_gray"))
    check(len(names) >= 30, f"[formats] {len(names)} fixtures")
    for name in names:
        data = (STILL_FIXTURES / name).read_bytes()
        for key, got in ((name, image_io.imdecode(data, name)), (f"{name}_gray", image_io.decode(data, name, True))):
            check(got.shape == pixels[key].shape and bool((got == pixels[key]).all()),
                  f"[formats] {key}: the port's decode differs from cv2's pixels")
    bench = {name: (STILL_FIXTURES / name).read_bytes() for name in digests}
    for name, data in bench.items():
        for mode, gray in (("color", False), ("gray", True)):
            got = hashlib.sha256(image_io.decode(data, name, gray).tobytes()).hexdigest()
            check(got == digests[name][mode], f"[formats] {name} {mode}: SHA-256 {got[:12]} is not cv2's")
    by_kind = {k: sum(n.startswith(k) for n in names) for k in ("png", "tiff", "webp")}
    print(f"[formats] (a) {len(names)} fixtures ({by_kind}) decoded by {native.library_path().name}, built on this "
          f"host: colour and grey equal to cv2's pixels exactly; the 4 timing files' decodes have cv2's SHA-256")

    # (b) decode times, one thread
    for name, data in bench.items():
        color = decode_ms(image_io.imdecode, data, 15, 1)
        grey = decode_ms(lambda d: image_io.decode(d, gray=True), data, 15, 1)
        print(f"[formats] (b) decode {name} (512x512 grey, {len(data) / 1e3:.1f} kB): {color:.3f} ms to BGR, "
              f"{grey:.3f} ms to grey, on 1 thread")

    # (c) the flagship behind MGAServer, uploads in each format
    val_pngs = sorted((Path(data_yaml).parent / "images" / "val").iterdir())[:FORMATS_UPLOADS]
    greys = [image_io.imread_gray(p)[..., None].astype(np.int64) for p in val_pngs]
    uploads = {
        "PNG 16-bit": [writers.png_bytes(g * 256 + (255 - g), 16, 0, filters=(1,), level=6) for g in greys],
        "TIFF LZW": [writers.tiff_bytes(g, 8, 1, compression=5, predictor=2, rows_per_strip=64) for g in greys[:8]],
        "PNG eXIf 6": [writers.png_bytes(g[:, :384], 8, 0, filters=(1,), level=6, orientation=6) for g in greys],
        "WebP": [bench["grey512_lossless.webp"], bench["grey512_lossy.webp"]] * 4
                + [(STILL_FIXTURES / n).read_bytes() for n in names if n.endswith(".webp")][:8],
    }
    torch.manual_seed(0)
    model, _ = create_model(YOLOV8_CBAM, scale="n", nc=1, device=device)
    eng = InferenceEngine(model, imgsz=IMGSZ, batch=BATCH, conf=0.001)  # bf16, BN-folded on the card
    eng.warmup()
    del model
    launches, n_boxes, err = {}, 0, 0.0
    for kind, datas in uploads.items():
        decoded = [image_io.imdecode(d) for d in datas]
        want = []
        for i in range(0, len(decoded), BATCH):
            lbs, metas = zip(*(eng.preprocess(im) for im in decoded[i:i + BATCH]))
            want += eng.infer_batch(list(lbs), list(metas))
        server = MGAServer(MicroBatcher(eng, max_wait_ms=5.0), host="127.0.0.1", port=0)
        server.start()

        def post(data: bytes, port=server.port) -> dict:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=data, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return json.loads(r.read())

        try:
            zero_launches()
            t0 = time.perf_counter()
            with ThreadPoolExecutor(4) as pool:
                got = list(pool.map(post, datas))
            rate = len(datas) / (time.perf_counter() - t0)
            counts = read_launches()
            n_batches = server.batcher.stats()["batches"]
        finally:
            server.stop()
        want_l = want_launches({"cam_gate": 3 * n_batches, "nms_suppress": n_batches})
        check(counts == want_l, f"[formats] {kind} uploads: launches {counts} for {n_batches} batches, want {want_l}")
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
        for r, w in zip(got, want):
            boxes = np.array([[b["x1"], b["y1"], b["x2"], b["y2"], b["conf"], b["cls"]] for b in r["boxes"]],
                             np.float32).reshape(-1, 6)
            check(r["orig_shape"] == list(w.orig_shape) and boxes.shape == w.boxes.shape
                  and bool(np.allclose(boxes, w.boxes, rtol=PATH_RTOL, atol=PATH_ATOL)),
                  f"[formats] a {kind} upload's boxes {boxes.shape} differ from the engine's on the port's decode "
                  f"{w.boxes.shape}")
            n_boxes += len(boxes)
            err = max(err, float(np.abs(boxes - w.boxes).max(initial=0.0)))
        if kind == "PNG eXIf 6":
            check(all(r["orig_shape"] == [384, 512] for r in got), "[formats] a turned PNG answered unturned")
        print(f"[formats] (c) {len(datas)} {kind} uploads ({sum(map(len, datas)) / len(datas) / 1e3:.1f} kB each, "
              f"shown {sorted({tuple(r['orig_shape']) for r in got})}) POSTed from 4 threads to MGAServer on the "
              f"flagship: {n_batches} batches, {rate:.1f} requests/s; launches {counts}")
    check(n_boxes > 0, "[formats] no boxes at conf 0.001")
    print(f"[formats] (c) every reply's boxes ({n_boxes}) equal InferenceEngine's on the port's decode of the same "
          f"bytes: max abs error {err:.3g} (rtol {PATH_RTOL}, atol {PATH_ATOL})")
    del eng

    # (d) fed training from 16-bit PNG and from LZW TIFF files
    t0 = time.perf_counter()
    yamls = {kind: formats_dataset(np, data_yaml, tmp / f"formats_{kind}", kind) for kind in ("png16", "tiff")}
    print(f"[formats] (d) wrote {FORMATS_FED_IMAGES} 16-bit PNGs with 1-bit PNG masks and {FORMATS_FED_IMAGES} LZW "
          f"TIFFs ({FORMATS_DISTINCT_TIFF} pictures) with PackBits TIFF masks in {time.perf_counter() - t0:.2f} s")
    kw = dict(imgsz=IMGSZ, batch=TRAIN_BATCH, workers=8, max_boxes=MAX_BOXES)
    torch.manual_seed(0)
    model, _ = create_model(YOLOV8_CBAM, scale="n", nc=1, training=True, device=device)
    sched = optim.Schedule(lr0=0.01, lrf=0.01, momentum=0.937, warmup_epochs=3.0, warmup_momentum=0.8,
                           warmup_bias_lr=0.1, epochs=100, steps_per_epoch=10)
    step = make_step(torch, model, max(round(NBS / TRAIN_BATCH), 1), torch.bfloat16, warmup_steps=sched.warmup_steps)
    st = S.create_train_state(model)
    st.step = st.last_apply = sched.warmup_steps - 4
    for kind, y in yamls.items():
        ds = MGADataset(load_config("configs/hyperparams/cbam_defaults.yaml", data=str(y), **kw), "train",
                        augment=True)
        check(len(ds) == FORMATS_FED_IMAGES and {p.suffix for p in ds.img_files} == {".png" if kind == "png16" else
                                                                                     ".tif"},
              f"[formats] {kind}: {len(ds)} images")
        src = Path(data_yaml).parent
        for i in (0, FORMATS_FED_IMAGES - 1):  # the 16-bit high byte and the LZW strips are the source's pixels
            raw, png = ds.load_raw(i), sorted((src / "images" / "train").iterdir())[
                i if kind == "png16" else i % FORMATS_DISTINCT_TIFF]
            check(bool((raw["img"] == image_io.imread(png)).all()) and bool(
                (raw["mask"] == (image_io.imread_gray(src / "masks" / png.name) > 0)).all()),
                f"[formats] {kind} {ds.img_files[i].name}: image or mask differs from its source")
        loader = DataLoader(ds, TRAIN_BATCH, seed=0, workers=8)
        rate, n_img, n_b = host_rate(np, loader, 1)
        n_steps = len(loader)
        zero_launches()
        st, metrics, rows = fed_steps(torch, np, loader, step, st, sched, n_steps)
        got = read_launches()
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        want_l = want_launches({"cam_gate": 3 * (n_steps + 1), "dfl_bwd": n_steps + 1})
        check(got == want_l, f"[formats] {kind}-fed: launches {got} in {n_steps} + 1 micro-steps, want {want_l}")
        print(f"[formats] (d) {kind}: the loader alone {rate:.1f} images/s ({n_img} images, {n_b} boxes); "
              f"{n_steps} + 1 micro-steps B={TRAIN_BATCH}x{IMGSZ} bf16 fed by it: {fed_summary(rows)}; last loss "
              f"{float(metrics['loss']):.4f}; launches {got}")
    del step, st, model
    print(f"[formats] the phase took {time.perf_counter() - t_phase:.1f} s on {gpu_name_and_power()}")
    return launches


FORMAT2_FIXTURES = Path(__file__).resolve().parent / "tests" / "format_fixtures"
FORMATS2_UPLOADS = 8  # uploads of each kind POSTed to the server
FORMATS2_FED_IMAGES = 32  # PNG images with T.6 TIFF masks, fed to the step
FORMATS2_GIF_FRAMES, FORMATS2_GIF_SIZE = 8, 256  # the clip cli.predict reads besides the 640 px GIF


def formats2_files(np, frame) -> dict:
    """640 x 640 files of the upload-only formats, written here from the
    BGR ``frame`` by numpy and the test writers (the card's host has no
    encoder of them): binary PPM (decodes to ``frame``), a 24-bit standard
    Sun raster (decodes to ``frame``) and a run-length Radiance HDR of
    RGBE ``frame`` / 256 (exponent 128)."""
    from tests.still_fixtures import writers

    h, w = frame.shape[:2]
    rgbe = np.concatenate([frame[..., ::-1], np.full((h, w, 1), 128, np.uint8)], -1)
    return {"PPM": b"P6\n%d %d\n255\n" % (w, h) + frame[..., ::-1].tobytes(),
            "Sun raster": writers.sun_bytes(frame, 24), "HDR": writers.hdr_bytes(rgbe)}


def seeded_checkpoint(torch, path: Path, device: str = "cuda") -> Path:
    """The flagship (``torch.manual_seed(0)``) saved as ``cli.train`` saves best.pt."""
    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.models.yolo import create_model

    torch.manual_seed(0)
    model, _ = create_model(YOLOV8_CBAM, scale="n", nc=1, device=device)
    cfg = "configs/models/yolov8_cbam.yaml"
    torch.save({"ema_state_dict": model.state_dict(), "train_args": {"nc": 1, "model": cfg, "model_scale": "n"},
                "meta": {"imgsz": IMGSZ, "model_yaml": cfg, "model_scale": "n", "nc": 1}}, path)
    return path


def formats2_phase(torch, np, data_yaml, best: Path, tmp: Path, device: str = "cuda") -> dict:
    """The formats only cv2 gave the JAX package until now: CCITT TIFF
    masks (``native/tiff.cpp``), GIF as a still and as a video
    (``native/gif.cpp``, ``data/video_io.py``), PNM / PAM / PFM, Sun raster
    and Radiance HDR (``data/raster_io.py`` on ``native/raster.cpp``), on
    the card's host.

    (a) each committed fixture (``tests/format_fixtures``) decoded, colour
    and grey, equal to cv2's stored pixels; each GIF clip's frames, fps,
    count and fourcc equal to cv2.VideoCapture's; the two timing files to
    their stored SHA-256. (b) decode ms on one host thread: the 640 px
    vessel mask as a T.6 TIFF (the mask read), the 640 px GIF's first
    frame (imdecode) and a later one (the video reader), and 640 px PPM,
    Sun raster and HDR files written here. (c) the flagship (seed 0, bf16,
    BN-folded) behind ``MGAServer``: 8 uploads of each kind (T.6 TIFF, GIF,
    PNM / PAM / PFM, Sun raster, HDR) POSTed from 4 threads, each reply's
    boxes within ``[parity]``'s tolerance of ``InferenceEngine`` on the
    port's decode of the same bytes, launches exact (3 CAM gates and 1 NMS
    a batch). (d) 32 PNG images with their masks as T.6 TIFFs (the test
    writer's codes): each sample's mask pyramid equal to the PNG-mask
    dataset's, then 2 + 1 bf16 micro-steps at batch 16 fed by the loader,
    launches exact (3 CAM gates and 1 DFL backward a micro-step). (e)
    ``cli.predict`` on ``best`` over the 640 px GIF and an 8-frame 256 px
    GIF: the JAX package's file names, every frame read and written, each
    ``_pred.mp4`` read back by the port's reader at the source's fps and
    frame count, each frame's boxes equal to the predictor's on the frames
    decoded anew, launches exact (3 CAM gates a batch); frames/s. Returns
    the launches of (c), (d) and (e)."""
    import contextlib
    import hashlib
    import io
    import shutil
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.cli import predict as cli_predict
    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.data.dataset import MGADataset
    from mga_yolo_tpu_torch.data.loader import DataLoader
    from mga_yolo_tpu_torch.data.synthetic import vessel_image
    from mga_yolo_tpu_torch.data.video_io import VideoReader
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.serve import InferenceEngine, MGAServer, MicroBatcher
    from mga_yolo_tpu_torch.train import optim
    from mga_yolo_tpu_torch.train import predictor as predictor_mod
    from mga_yolo_tpu_torch.train import state as S
    from mga_yolo_tpu_torch.utils import yaml_lite
    from tests.still_fixtures import writers

    t_phase = time.perf_counter()
    card = gpu_name_and_power() if device == "cuda" else "the CPU"
    # (a) the fixtures, exactly
    pixels = np.load(FORMAT2_FIXTURES / "pixels.npz")
    stored = np.load(FORMAT2_FIXTURES / "frames.npz")
    clips = json.loads((FORMAT2_FIXTURES / "clips.json").read_text())
    digests = json.loads((FORMAT2_FIXTURES / "bench.json").read_text())
    names = sorted(k for k in pixels.files if not k.endswith("_gray"))
    check(len(names) >= 35 and len(clips) >= 6, f"[formats2] {len(names)} fixtures, {len(clips)} clips")
    for name in names:
        data = (FORMAT2_FIXTURES / name).read_bytes()
        for key, got in ((name, image_io.imdecode(data, name)), (f"{name}_gray", image_io.decode(data, name, True))):
            check(got.shape == pixels[key].shape and bool((got == pixels[key]).all()),
                  f"[formats2] {key}: the port's decode differs from cv2's pixels")
    for name, meta in clips.items():
        with VideoReader(FORMAT2_FIXTURES / name) as r:
            got = np.stack(list(r))
            check((r.fps, r.total, r.fourcc.decode("latin-1")) == (meta["fps"], meta["total"], meta["fourcc"])
                  and got.shape == stored[name].shape and bool((got == stored[name]).all()),
                  f"[formats2] {name}: frames, fps {r.fps} or count {r.total} differ from cv2.VideoCapture's {meta}")
    bench = {name: (FORMAT2_FIXTURES / name).read_bytes() for name in digests}
    gif_frames = []
    for name, data in bench.items():
        for mode, gray in (("color", False), ("gray", True)):
            got = hashlib.sha256(image_io.decode(data, name, gray).tobytes()).hexdigest()
            check(got == digests[name][mode], f"[formats2] {name} {mode}: SHA-256 {got[:12]} is not cv2's")
        if "frames" in digests[name]:
            with VideoReader(FORMAT2_FIXTURES / name) as r:
                gif_frames = list(r)
            check([hashlib.sha256(f.tobytes()).hexdigest() for f in gif_frames] == digests[name]["frames"],
                  f"[formats2] {name}: video frames differ from cv2's digests")
    by_kind = {k: sum(n.startswith(k) for n in names) for k in ("ccitt", "gif", "pnm", "pam", "pfm", "sun", "hdr")}
    print(f"[formats2] (a) {len(names)} fixtures ({by_kind}) and {len(clips)} GIF clips decoded by "
          f"{native.library_path().name}, built on this host: colour and grey equal to cv2's pixels, every clip's "
          f"frames, fps, count and fourcc equal to cv2.VideoCapture's; the 2 timing files' decodes have cv2's "
          f"SHA-256")

    # (b) decode times, one thread
    made = formats2_files(np, gif_frames[0])
    for kind, data in made.items():
        check(kind == "HDR" or bool((image_io.imdecode(data) == gif_frames[0]).all()),
              f"[formats2] the 640 px {kind} does not decode to the frame written")
    gif = bench["bench_angio640.gif"]
    times = {"T.6 TIFF mask (grey read)": decode_ms(lambda d: image_io.decode(d, gray=True),
                                                    bench["bench_mask640_g4.tif"], 15, 1),
             "GIF first frame (imdecode)": decode_ms(image_io.imdecode, gif, 15, 1)}
    reps = []
    for _ in range(7):
        with VideoReader(FORMAT2_FIXTURES / "bench_angio640.gif") as r:
            it = iter(r)
            next(it)
            t0 = time.perf_counter()
            next(it)
            reps.append((time.perf_counter() - t0) * 1e3)
    times["GIF later frame (video reader)"] = sorted(reps)[len(reps) // 2]
    for kind, data in made.items():
        times[kind] = decode_ms(image_io.imdecode, data, 15, 1)
    sizes = {"T.6 TIFF mask (grey read)": len(bench["bench_mask640_g4.tif"]), "GIF first frame (imdecode)": len(gif),
             "GIF later frame (video reader)": len(gif), **{k: len(v) for k, v in made.items()}}
    print("[formats2] (b) decode 640x640 on 1 thread, " + card + ": " + ", ".join(
        f"{k} {v:.3f} ms ({sizes[k] / 1e3:.1f} kB)" for k, v in times.items()))

    # (c) the flagship behind MGAServer, uploads of each new format
    def fixtures(*prefixes):
        return [(FORMAT2_FIXTURES / n).read_bytes() for n in names
                if n.startswith(prefixes) and pixels[n].ndim == 3][:FORMATS2_UPLOADS - 1]

    uploads = {"TIFF T.6": [bench["bench_mask640_g4.tif"]] + fixtures("ccitt"),
               "GIF": [gif] + fixtures("gif"),
               "PNM / PAM / PFM": [made["PPM"]] + fixtures("pnm", "pam", "pfm"),
               "Sun raster": [made["Sun raster"]] + fixtures("sun"),
               "HDR": [made["HDR"]] + fixtures("hdr")}
    torch.manual_seed(0)
    model, _ = create_model(YOLOV8_CBAM, scale="n", nc=1, device=device)
    eng = InferenceEngine(model, imgsz=IMGSZ, batch=BATCH, conf=0.001)
    eng.warmup()
    del model
    launches, n_boxes, err = {}, 0, 0.0
    kinds = [k for k, datas in uploads.items() for _ in datas]
    datas = [d for ds in uploads.values() for d in ds]
    decoded = [image_io.imdecode(d) for d in datas]
    want = []
    for i in range(0, len(decoded), BATCH):
        lbs, metas = zip(*(eng.preprocess(im) for im in decoded[i:i + BATCH]))
        want += eng.infer_batch(list(lbs), list(metas))
    server = MGAServer(MicroBatcher(eng, max_wait_ms=5.0), host="127.0.0.1", port=0)
    server.start()

    def post(data: bytes, port=server.port) -> dict:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=data, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        zero_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            got = list(pool.map(post, datas))
        rate = len(datas) / (time.perf_counter() - t0)
        counts = read_launches()
        n_batches = server.batcher.stats()["batches"]
    finally:
        server.stop()
    want_l = want_launches({"cam_gate": 3 * n_batches, "nms_suppress": n_batches})
    check(counts == want_l, f"[formats2] uploads: launches {counts} for {n_batches} batches, want {want_l}")
    launches = dict(counts)
    for kind, r, w in zip(kinds, got, want):
        boxes = np.array([[b["x1"], b["y1"], b["x2"], b["y2"], b["conf"], b["cls"]] for b in r["boxes"]],
                         np.float32).reshape(-1, 6)
        check(r["orig_shape"] == list(w.orig_shape) and boxes.shape == w.boxes.shape
              and bool(np.allclose(boxes, w.boxes, rtol=PATH_RTOL, atol=PATH_ATOL)),
              f"[formats2] a {kind} upload's boxes {boxes.shape} differ from the engine's on the port's decode "
              f"{w.boxes.shape}")
        n_boxes += len(boxes)
        err = max(err, float(np.abs(boxes - w.boxes).max(initial=0.0)))
    check(n_boxes > 0, "[formats2] no boxes at conf 0.001")
    print(f"[formats2] (c) {len(datas)} uploads ({', '.join(f'{len(v)} {k}' for k, v in uploads.items())}) POSTed "
          f"from 4 threads to MGAServer on the flagship: {n_batches} batches, {rate:.1f} requests/s; every reply's "
          f"boxes ({n_boxes}) equal InferenceEngine's on the port's decode of the same bytes, max abs error "
          f"{err:.3g}; launches {counts}")
    del eng

    # (d) a dataset with T.6 TIFF masks, fed by the loader
    src = Path(data_yaml).parent
    root = tmp / "formats2_g4"
    for d in ("images/train", "labels/train", "masks"):
        (root / d).mkdir(parents=True)
    t0 = time.perf_counter()
    for png in sorted((src / "images" / "train").iterdir())[:FORMATS2_FED_IMAGES]:
        shutil.copy(png, root / "images/train" / png.name)
        shutil.copy(src / "labels" / "train" / f"{png.stem}.txt", root / "labels/train")
        mask = image_io.imread_gray(src / "masks" / png.name) > 0
        (root / "masks" / f"{png.stem}.tif").write_bytes(writers.t6_tiff_bytes(mask.astype(np.uint8), photometric=1))
    yaml_lite.dump({"path": str(root), "train": "images/train", "val": "images/train", "dataset": str(root),
                    "masks_dir": "masks", "names": {0: "stenosis"}, "nc": 1}, root / "data.yaml")
    write_s = time.perf_counter() - t0
    kw = dict(imgsz=IMGSZ, batch=TRAIN_BATCH, workers=8, max_boxes=MAX_BOXES)
    hyp = "configs/hyperparams/cbam_defaults.yaml"
    g4 = MGADataset(load_config(hyp, data=str(root / "data.yaml"), **kw), "train", augment=False)
    png = MGADataset(load_config(hyp, data=str(data_yaml), **kw), "train", augment=False)
    check(len(g4) == FORMATS2_FED_IMAGES and all(p.suffix == ".tif" for p in g4.mask_paths),
          f"[formats2] the T.6 mask dataset holds {len(g4)} images")
    for i in range(FORMATS2_FED_IMAGES):
        a, b = g4.get(i)["masks"], png.get(i)["masks"]
        check(len(a) == len(b) == 3 and all(x.shape == y.shape and bool((x == y).all()) for x, y in zip(a, b)),
              f"[formats2] {g4.img_files[i].name}: the T.6 mask's pyramid differs from the PNG mask's")
    ds = MGADataset(load_config(hyp, data=str(root / "data.yaml"), **kw), "train", augment=True)
    torch.manual_seed(0)
    model, _ = create_model(YOLOV8_CBAM, scale="n", nc=1, training=True, device=device)
    sched = optim.Schedule(lr0=0.01, lrf=0.01, momentum=0.937, warmup_epochs=3.0, warmup_momentum=0.8,
                           warmup_bias_lr=0.1, epochs=100, steps_per_epoch=10)
    step = make_step(torch, model, max(round(NBS / TRAIN_BATCH), 1), torch.bfloat16, warmup_steps=sched.warmup_steps)
    st = S.create_train_state(model)
    st.step = st.last_apply = sched.warmup_steps - 4
    loader = DataLoader(ds, TRAIN_BATCH, seed=0, workers=8)
    rate, n_img, n_b = host_rate(np, loader, 1)
    n_steps = len(loader)
    zero_launches()
    st, metrics, rows = fed_steps(torch, np, loader, step, st, sched, n_steps)
    got_l = read_launches()
    launches = {k: launches.get(k, 0) + v for k, v in got_l.items()}
    want_l = want_launches({"cam_gate": 3 * (n_steps + 1), "dfl_bwd": n_steps + 1})
    check(got_l == want_l, f"[formats2] T.6-mask-fed: launches {got_l} in {n_steps} + 1 micro-steps, want {want_l}")
    print(f"[formats2] (d) {FORMATS2_FED_IMAGES} PNGs with T.6 TIFF masks written in {write_s:.2f} s; every "
          f"sample's mask pyramid equal to the PNG-mask dataset's; the loader alone {rate:.1f} images/s ({n_img} "
          f"images, {n_b} boxes); {n_steps} + 1 micro-steps B={TRAIN_BATCH}x{IMGSZ} bf16 fed by it: "
          f"{fed_summary(rows)}; last loss {float(metrics['loss']):.4f}; launches {got_l}")
    del step, st, model, loader

    # (e) cli.predict over two GIF clips
    clip_dir = tmp / "formats2_gifs"
    clip_dir.mkdir()
    (clip_dir / "angio640.gif").write_bytes(gif)
    rng = np.random.default_rng(1)
    small = [vessel_image(rng, FORMATS2_GIF_SIZE, MAX_BOXES)[0] // 16 for _ in range(FORMATS2_GIF_FRAMES)]
    (clip_dir / "vessels.gif").write_bytes(writers.gif_bytes(
        (FORMATS2_GIF_SIZE, FORMATS2_GIF_SIZE), [{"indices": f, "delay": 8} for f in small],
        palette=np.repeat(np.arange(0, 256, 17)[:, None], 3, 1)))
    recorded, loaded = [], []
    real_load = predictor_mod.load_predictor

    def recording_load(*a, **k):
        pred = real_load(*a, **k)
        stream = pred.stream

        def recording_stream(*sa, **sk):
            for frame, r in stream(*sa, **sk):
                recorded.append((frame.path, frame.index, r.boxes.copy()))
                yield frame, r

        pred.stream = recording_stream
        loaded.append(pred)
        return pred

    out_dir = tmp / "formats2_predict"
    predictor_mod.load_predictor = recording_load
    try:
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            res = cli_predict.main(["--weights", str(best), "--source", str(clip_dir), "--out", str(out_dir),
                                    "--batch", str(TRAIN_BATCH), "--conf", "0.01"]
                                   + ([] if device == "cuda" else ["--device", device]))
        wall = time.perf_counter() - t0
        counts = read_launches()
    finally:
        predictor_mod.load_predictor = real_load
    n_frames = len(gif_frames) + FORMATS2_GIF_FRAMES
    n_batches = -(-n_frames // TRAIN_BATCH)  # the predictor's batches run on across sources
    want_l = want_launches({"cam_gate": 3 * n_batches})
    check(counts == want_l, f"[formats2] cli.predict launches {counts} for {n_batches} batches, want {want_l}")
    launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
    names_out = {p.name for p in out_dir.iterdir()}
    check(res["frames"] == n_frames and res["images"] == 0 and names_out == {"angio640_pred.mp4", "vessels_pred.mp4"},
          f"[formats2] cli.predict wrote {sorted(names_out)}, result {res}")
    check(log.getvalue().splitlines()[-3:-1] == [f"angio640.gif: {len(gif_frames)} frames -> angio640_pred.mp4",
                                                  f"vessels.gif: {FORMATS2_GIF_FRAMES} frames -> vessels_pred.mp4"],
          f"[formats2] cli.predict summary {log.getvalue().splitlines()[-3:]}")
    for name, src_name in (("angio640_pred.mp4", "angio640.gif"), ("vessels_pred.mp4", "vessels.gif")):
        with VideoReader(clip_dir / src_name) as s, VideoReader(out_dir / name) as r:
            n = sum(1 for _ in r)
            check(n == r.total == s.total and r.fps == s.fps and r.size == s.size,
                  f"[formats2] {name}: {n} frames at {r.fps} fps, {r.size}; the source {s.total} at {s.fps}, {s.size}")
    pred = loaded[0]
    del pred.stream  # the class's own stream again
    frames_again = []  # the frames decoded anew, in cli.predict's order and batches
    for f in sorted(clip_dir.iterdir()):
        with VideoReader(f) as r:
            frames_again += list(r)
    again = [b for _, b in pred.stream(frames_again, batch_size=TRAIN_BATCH)]
    check(len(recorded) == len(again) == n_frames, f"[formats2] {len(recorded)} results, {len(again)} again")
    n_boxes, err = 0, 0.0
    for (path, idx, got_b), w in zip(recorded, again):
        check(got_b.shape == w.boxes.shape, f"[formats2] {Path(path).name} frame {idx}: {got_b.shape} boxes, the "
                                            f"predictor's {w.boxes.shape}")
        e = float(np.abs(got_b - w.boxes).max(initial=0.0))
        check(bool(np.allclose(got_b, w.boxes, rtol=PATH_RTOL, atol=PATH_ATOL)),
              f"[formats2] {Path(path).name} frame {idx}: boxes differ from the predictor's by up to {e:.3g}")
        n_boxes += len(got_b)
        err = max(err, e)
    print(f"[formats2] (e) cli.predict on {best.name} over angio640.gif ({len(gif_frames)} frames, 640 px) and "
          f"vessels.gif ({FORMATS2_GIF_FRAMES} frames, {FORMATS2_GIF_SIZE} px): {sorted(names_out)} read back by "
          f"the port's reader at the sources' fps and counts; {n_boxes} boxes, each frame's equal to the "
          f"predictor's on the frames decoded anew (max abs error {err:.3g}); launches {counts}; "
          f"{n_frames / wall:.1f} frames/s on one host thread, model load included ({wall:.2f} s), {card}")
    print(f"[formats2] the phase took {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


VIDEO_FIXTURES = Path(__file__).resolve().parent / "tests" / "video_fixtures"
VIDEO_FRAMES, VIDEO_SIZE = 64, 512  # each clip [video] writes: 64 frames of 512 x 512
VIDEO_FPS = {"avi": 25.0, "mp4": 29.97}
VIDEO_PSNR = 35.0  # dB, the port's clips against the frames written
VIDEO_BOUNDS = {"mjpeg": (0.5, 8), "mpeg4": (40.0, 0.75)}  # (mean, max) levels; (PSNR dB, mean) per frame


def psnr(np, a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def video_phase(torch, np, data_yaml, best: Path, tmp: Path, device: str = "cuda") -> dict:
    """The video path of the port's host C++ (``native/mpeg4.cpp``,
    ``native/yuv.cpp``, ``native/jpeg.cpp``'s planes) and ``data/video_io.py``
    on the card's host, and ``cli.predict`` over video on the flagship.

    (a) each committed fixture (``tests/video_fixtures``: clips cv2 wrote)
    read and held to cv2's stored frames: MJPEG within mean 0.5 / max 8
    levels, MPEG-4 at PSNR >= 40 dB and mean <= 0.75, uncompressed exactly,
    the 512 px mp4v clip to cv2's frame digests; frame counts, fps and
    ``total`` equal. (b) 64 synthetic angiograms of 512 x 512 written as an
    MJPG .avi (25 fps) and an mp4v .mp4 (29.97 fps) by the port's writer,
    read back: count, fps, PSNR >= 35 dB against the frames written; encode
    and decode ms per frame (MJPEG; mp4v I-VOPs, and P-VOPs of the 512 px
    fixture). (c) ``cli.predict`` on best.pt over a directory of both clips
    and two images: the JAX package's file names, 64 frames at the source's
    fps in each annotated video, each frame's boxes equal to the
    predictor's on the same frames decoded anew, CAM-gate launches exactly
    3 a batch; its frames/s on one thread. Returns (c)'s launches."""
    import contextlib
    import hashlib
    import io

    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.cli import predict as cli_predict
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.data.synthetic import vessel_image
    from mga_yolo_tpu_torch.data.video_io import VideoReader, VideoWriter
    from mga_yolo_tpu_torch.train import predictor as predictor_mod

    t_phase = time.perf_counter()
    card = gpu_name_and_power() if device == "cuda" else "the CPU"
    # (a) the fixtures against cv2
    meta = json.loads((VIDEO_FIXTURES / "meta.json").read_text())
    stored = np.load(VIDEO_FIXTURES / "frames.npz")
    worst = {"mjpeg": [0.0, 0], "mpeg4": [float("inf"), 0.0]}
    meta = {n: m for n, m in meta.items() if not n.endswith((".mkv", ".webm"))}  # [matroska] reads those
    for name, m in sorted(meta.items()):
        with VideoReader(VIDEO_FIXTURES / name) as r:
            got = list(r)
            codec = r.codec
            check(r.total == m["total"] and abs(r.fps - m["fps"]) <= 1e-9 * m["fps"] and len(got) == m["frames"]
                  and int.from_bytes(r.fourcc, "little") == m["fourcc"],
                  f"[video] {name}: {len(got)} frames, fps {r.fps}, total {r.total}, fourcc {r.fourcc}; cv2 {m}")
        if "sha256" in m:
            check([hashlib.sha256(g.tobytes()).hexdigest() for g in got] == m["sha256"],
                  f"[video] {name}: frames differ from cv2's digests")
            continue
        for i, (g, w) in enumerate(zip(got, stored[name])):
            check(g.shape == w.shape, f"[video] {name} frame {i}: shape {g.shape}, cv2 {w.shape}")
            d = np.abs(g.astype(np.int16) - w)
            if codec == "mjpeg":
                check(d.mean() <= 0.5 and d.max() <= 8, f"[video] {name} frame {i}: mean {d.mean()} max {d.max()}")
                worst["mjpeg"] = [max(worst["mjpeg"][0], float(d.mean())), max(worst["mjpeg"][1], int(d.max()))]
            elif codec == "mpeg4":
                q = psnr(np, g, w)
                check(q >= 40 and d.mean() <= 0.75, f"[video] {name} frame {i}: PSNR {q:.2f} mean {d.mean()}")
                worst["mpeg4"] = [min(worst["mpeg4"][0], q), max(worst["mpeg4"][1], float(d.mean()))]
            else:
                check(not d.any(), f"[video] {name} frame {i}: an uncompressed frame differs")
    print(f"[video] (a) {len(meta)} fixtures read on this host with {native.library_path().name}: counts, fps, "
          f"total and fourcc as cv2's; MJPEG worst frame mean {worst['mjpeg'][0]:.4f} max {worst['mjpeg'][1]} "
          f"levels; MPEG-4 worst frame PSNR {worst['mpeg4'][0]:.2f} dB mean {worst['mpeg4'][1]:.4f}; "
          f"uncompressed exact; big512.mp4 equal to cv2's frame digests")

    # (b) the writer at 512 x 512, both formats, read back; codec times
    rng = np.random.default_rng(0)
    frames = []
    for _ in range(VIDEO_FRAMES):
        grey = vessel_image(rng, VIDEO_SIZE, MAX_BOXES)[0]
        frames.append(np.repeat(grey[:, :, None], 3, axis=2))
    src = tmp / "video_src"
    src.mkdir()
    timing = {}
    for ext, fps in VIDEO_FPS.items():
        path = src / f"run.{ext}"
        t0 = time.perf_counter()
        with VideoWriter(path, fps, (VIDEO_SIZE, VIDEO_SIZE)) as vw:
            for img in frames:
                vw.write(img)
        timing[f"encode_{ext}"] = (time.perf_counter() - t0) * 1e3 / VIDEO_FRAMES
        with VideoReader(path) as r:
            t0 = time.perf_counter()
            back = list(r)
            timing[f"read_{ext}"] = (time.perf_counter() - t0) * 1e3 / VIDEO_FRAMES
            check(len(back) == r.total == VIDEO_FRAMES and r.fps == fps and r.size == (VIDEO_SIZE, VIDEO_SIZE),
                  f"[video] {path.name}: {len(back)} frames, fps {r.fps}, size {r.size}")
            chunks = [r.extradata] + [r._read(o, n) for o, n in r.samples]  # the MP4's VOL is in its esds
        q = min(psnr(np, b, f) for b, f in zip(back, frames))
        check(q >= VIDEO_PSNR, f"[video] {path.name}: PSNR {q:.2f} dB against the frames written")
        timing[f"psnr_{ext}"] = q
        timing[f"kb_{ext}"] = path.stat().st_size / 1e3 / VIDEO_FRAMES
        if ext == "avi":  # MJPEG: the planes of one frame, converted
            one = lambda data: native.yuv_to_bgr(*native.jpeg_decode_planes(data)[0], True)  # noqa: E731
            timing["decode_mjpeg"] = decode_ms(one, chunks[2], 15, 1)
    big = VideoReader(VIDEO_FIXTURES / "big512.mp4")
    with big:  # cv2's MP4 holds the VOL in its esds only
        big_chunks = [big.extradata] + [big._read(o, n) for o, n in big.samples]
    for stream, label in ((chunks[:17], "i"), (big_chunks, "p")):
        dec = native.Mpeg4Decoder()
        times = {0: [], 1: []}
        for c in stream:
            t0 = time.perf_counter()
            got = dec.decode(c)
            if got is not None:
                native.yuv_to_bgr(*got[0], False)
                times[got[1]].append((time.perf_counter() - t0) * 1e3)
        dec.close()
        kind = 0 if label == "i" else 1
        check(len(times[kind]) > 0, f"[video] no {'I' if kind == 0 else 'P'}-VOPs timed")
        timing[f"decode_mp4v_{label}"] = sorted(times[kind])[len(times[kind]) // 2]
    print(f"[video] (b) {VIDEO_FRAMES} synthetic angiograms of {VIDEO_SIZE}x{VIDEO_SIZE} written and read back: "
          f"run.avi (MJPG, {VIDEO_FPS['avi']} fps, {timing['kb_avi']:.1f} kB a frame) PSNR {timing['psnr_avi']:.2f} "
          f"dB, run.mp4 (mp4v I-VOPs, {VIDEO_FPS['mp4']} fps, {timing['kb_mp4']:.1f} kB a frame) PSNR "
          f"{timing['psnr_mp4']:.2f} dB; counts and fps exact")
    print(f"[video] (b) on one host thread, {card}: decode to BGR {timing['decode_mjpeg']:.3f} ms a frame (MJPEG), "
          f"{timing['decode_mp4v_i']:.3f} (mp4v I-VOP), {timing['decode_mp4v_p']:.3f} (mp4v P-VOP, big512.mp4); "
          f"encode from BGR {timing['encode_avi']:.3f} ms a frame (MJPG .avi), {timing['encode_mp4']:.3f} (mp4v .mp4), "
          f"file writes included; read back {timing['read_avi']:.3f} / {timing['read_mp4']:.3f} ms a frame")

    # (c) cli.predict over both clips and two images, on the flagship
    val_pngs = sorted((Path(data_yaml).parent / "images" / "val").iterdir())[:2]
    for i, png in enumerate(val_pngs):
        (src / f"im{i}.png").write_bytes(png.read_bytes())
    recorded, loaded = [], []
    real_load = predictor_mod.load_predictor

    def recording_load(*a, **k):
        pred = real_load(*a, **k)
        stream = pred.stream

        def recording_stream(*sa, **sk):
            for frame, r in stream(*sa, **sk):
                recorded.append((frame.path, frame.index, r.boxes.copy()))
                yield frame, r

        pred.stream = recording_stream
        loaded.append(pred)
        return pred

    out_dir = tmp / "video_predict"
    predictor_mod.load_predictor = recording_load
    try:
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            res = cli_predict.main(["--weights", str(best), "--source", str(src), "--out", str(out_dir), "--batch",
                                    str(TRAIN_BATCH), "--conf", "0.01", "--save-frame-masks"]
                                   + ([] if device == "cuda" else ["--device", device]))
        wall = time.perf_counter() - t0
        counts = read_launches()
    finally:
        predictor_mod.load_predictor = real_load
    n_frames = 2 * VIDEO_FRAMES
    n_batches = -(-(n_frames + 2) // TRAIN_BATCH)
    want_l = want_launches({"cam_gate": 3 * n_batches})
    check(counts == want_l, f"[video] cli.predict launches {counts} for {n_batches} batches, want {want_l}")
    check(res["images"] == 2 and res["frames"] == n_frames, f"[video] cli.predict result {res}")
    want_names = {"run_pred.avi", "run_2_pred.mp4"} | {f"im{i}{s}" for i in range(2) for s in (
        "_pred.jpg", "_mask_p3.png", "_mask_p4.png", "_mask_p5.png")} | {
        f"{stem}_f{j:05d}_mask_{k}.png" for stem in ("run", "run_2") for j in range(VIDEO_FRAMES)
        for k in ("p3", "p4", "p5")}
    names = {p.name for p in out_dir.iterdir()}
    check(names == want_names, f"[video] cli.predict wrote {sorted(names ^ want_names)[:6]} beyond / short of "
                               f"the JAX package's names")
    lines = log.getvalue().splitlines()
    check(lines[-3:] == [f"run.avi: {VIDEO_FRAMES} frames -> run_pred.avi",
                         f"run.mp4: {VIDEO_FRAMES} frames -> run_2_pred.mp4",
                         f"[mga-predict] 2 images, {n_frames} video frames -> {out_dir}"],
          f"[video] cli.predict summary {lines[-3:]}")
    for name, fps in (("run_pred.avi", VIDEO_FPS["avi"]), ("run_2_pred.mp4", VIDEO_FPS["mp4"])):
        with VideoReader(out_dir / name) as r:
            n = sum(1 for _ in r)
            check(n == r.total == VIDEO_FRAMES and r.fps == fps and r.size == (VIDEO_SIZE, VIDEO_SIZE),
                  f"[video] {name}: {n} frames at {r.fps} fps, {r.size}")
    # each frame's boxes against the predictor on the same frames decoded anew, in the same batches
    pred = loaded[0]
    del pred.stream  # the class's own stream again
    again = []
    for f in sorted(src.iterdir()):
        if f.suffix == ".png":
            again.append(image_io.imread(f))
        else:
            with VideoReader(f) as r:
                again += list(r)
    want = [r.boxes for _, r in pred.stream(again, batch_size=TRAIN_BATCH)]
    check(len(recorded) == len(want) == n_frames + 2, f"[video] {len(recorded)} results, {len(want)} again")
    n_boxes, err = 0, 0.0
    for (path, idx, got), w in zip(recorded, want):
        check(got.shape == w.shape and bool(np.allclose(got, w, rtol=PATH_RTOL, atol=PATH_ATOL)),
              f"[video] {Path(path).name} frame {idx}: boxes {got.shape} differ from the predictor's {w.shape}")
        n_boxes += len(got)
        err = max(err, float(np.abs(got - w).max(initial=0.0)))
    print(f"[video] (c) cli.predict on best.pt over run.avi, run.mp4 ({VIDEO_FRAMES} frames each) and 2 PNGs: "
          f"{len(names)} files as the JAX package names them ({', '.join(sorted(names)[:3])} ...), each video "
          f"{VIDEO_FRAMES} frames at its source's fps; {n_boxes} boxes, each frame's equal to the predictor's on "
          f"the frames decoded anew (max abs error {err:.3g}); launches {counts} ({n_batches} batches of "
          f"{TRAIN_BATCH})")
    print(f"[video] (c) cli.predict {(n_frames + 2) / wall:.1f} frames/s on one host thread, model load included "
          f"({wall:.2f} s for {n_frames} video frames and 2 images), {card}")
    print(f"[video] the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


MKV_PREDICT_FRAMES = 16  # the MJPEG .mkv [matroska] writes for cli.predict: 16 frames of 512 x 512, as big512.webm
MKV_TIMING_REPS = 5  # big512.webm decoded 5 times for its per-frame times


def mjpeg_mkv(frames: list, fps: float) -> bytes:
    """An MJPEG Matroska file (``V_MJPEG``, one cluster of key-frame
    SimpleBlocks, Duration and DefaultDuration) of BGR frames, laid out as
    ffmpeg's muxer lays out cv2's."""
    from mga_yolo_tpu_torch.data.image_io import encode_jpeg
    from mga_yolo_tpu_torch.data.video_io import MKV, _ebml, _ebml_uint

    h, w = frames[0].shape[:2]
    ms = 1000 / fps
    head = _ebml(MKV["EBML"], _ebml_uint(0x4286, 1) + _ebml_uint(0x42F7, 1) + _ebml_uint(0x42F2, 4) +
                 _ebml_uint(0x42F3, 8) + _ebml(MKV["DocType"], b"matroska") + _ebml_uint(0x4287, 4) +
                 _ebml_uint(0x4285, 2))
    info = _ebml_uint(MKV["TimestampScale"], 1000000) + _ebml(MKV["Duration"], struct.pack(">d", len(frames) * ms))
    entry = _ebml_uint(MKV["TrackNumber"], 1) + _ebml(MKV["CodecID"], b"V_MJPEG") + _ebml_uint(MKV["TrackType"], 1) + \
        _ebml_uint(MKV["DefaultDuration"], round(1e9 / fps)) + \
        _ebml(MKV["Video"], _ebml_uint(MKV["PixelWidth"], w) + _ebml_uint(MKV["PixelHeight"], h))
    cluster = _ebml_uint(MKV["Timestamp"], 0) + b"".join(
        _ebml(MKV["SimpleBlock"], b"\x81" + int(round(i * ms)).to_bytes(2, "big") + b"\x80" + encode_jpeg(img))
        for i, img in enumerate(frames))
    return head + _ebml(MKV["Segment"], _ebml(MKV["Info"], info) + _ebml(MKV["Tracks"], _ebml(MKV["TrackEntry"], entry))
                        + _ebml(MKV["Cluster"], cluster))


def predict_recorded(np, best: Path, src: Path, out_dir: Path, device: str, tag: str, n_video: int):
    """``cli.predict`` on ``best`` over the videos in ``src`` with each
    frame's boxes recorded: exactly 3 CAM-gate launches a batch (the batches
    run on across files), ``n_video`` frames and no image, and each frame's
    boxes equal to the warm predictor's on the frames decoded anew. Returns
    (launches, names written, boxes, max abs error, seconds, log lines)."""
    import contextlib
    import io

    from mga_yolo_tpu_torch.cli import predict as cli_predict
    from mga_yolo_tpu_torch.data.video_io import VideoReader
    from mga_yolo_tpu_torch.train import predictor as predictor_mod

    recorded, loaded = [], []
    real_load = predictor_mod.load_predictor

    def recording_load(*a, **k):
        pred = real_load(*a, **k)
        stream = pred.stream

        def recording_stream(*sa, **sk):
            for frame, r in stream(*sa, **sk):
                recorded.append((frame.path, frame.index, r.boxes.copy()))
                yield frame, r

        pred.stream = recording_stream
        loaded.append(pred)
        return pred

    predictor_mod.load_predictor = recording_load
    try:
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            res = cli_predict.main(["--weights", str(best), "--source", str(src), "--out", str(out_dir), "--batch",
                                    str(TRAIN_BATCH), "--conf", "0.01"] + ([] if device == "cuda" else
                                                                            ["--device", device]))
        wall = time.perf_counter() - t0
        counts = read_launches()
    finally:
        predictor_mod.load_predictor = real_load
    n_batches = -(-n_video // TRAIN_BATCH)
    want_l = want_launches({"cam_gate": 3 * n_batches})
    check(counts == want_l, f"[{tag}] cli.predict launches {counts} for {n_batches} batches, want {want_l}")
    check(res["images"] == 0 and res["frames"] == n_video, f"[{tag}] cli.predict result {res}")
    pred = loaded[0]
    del pred.stream  # the class's own stream again
    again = []
    for f in sorted(src.iterdir()):
        with VideoReader(f) as r:
            again += list(r)
    want = [r.boxes for _, r in pred.stream(again, batch_size=TRAIN_BATCH)]
    check(len(recorded) == len(want) == n_video, f"[{tag}] {len(recorded)} results, {len(want)} again")
    n_boxes, err = 0, 0.0
    for (path, idx, got), w in zip(recorded, want):
        check(got.shape == w.shape and bool(np.allclose(got, w, rtol=PATH_RTOL, atol=PATH_ATOL)),
              f"[{tag}] {Path(path).name} frame {idx}: boxes {got.shape} differ from the predictor's {w.shape}")
        n_boxes += len(got)
        err = max(err, float(np.abs(got - w).max(initial=0.0)))
    return counts, {p.name for p in out_dir.iterdir()}, n_boxes, err, wall, log.getvalue().splitlines()


def matroska_phase(torch, np, best: Path, tmp: Path, device: str = "cuda") -> dict:
    """Matroska and WebM on the card's host (``data/video_io.py``'s EBML
    demuxer and muxer, ``native/vp8.cpp``'s VP8 key and inter frames), and
    ``cli.predict`` over them on the flagship.

    (a) each committed Matroska / WebM fixture (``tests/video_fixtures``:
    cv2's writer, and libvpx with hidden alt-ref frames, key frames every 5,
    token partitions, error-resilient frames, profiles 1 and 3, odd widths)
    decoded and held to cv2's frame digests, fps, count and fourcc. (b) VP8
    decode to BGR on one host thread, ms a frame, key and inter frames
    apart (big512.webm: 16 frames of 512 x 512, key frames 0 and 8). (c)
    ``cli.predict`` on ``best`` over big512.webm and a 512 px MJPEG .mkv (16
    frames each): the JAX package's file names (a ``_pred.mp4`` per clip),
    each frame's boxes equal to the predictor's on the frames decoded anew,
    CAM-gate launches exactly 3 a batch. (d) 16 synthetic 512 px angiograms
    written as ``.mkv`` (mp4v in Matroska) and read back: count, fps, PSNR.
    Returns (c)'s launches."""
    import hashlib

    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data.synthetic import vessel_image
    from mga_yolo_tpu_torch.data.video_io import VideoReader, VideoWriter

    t_phase = time.perf_counter()
    card = gpu_name_and_power() if device == "cuda" else "the CPU"
    # (a) the fixtures against cv2's digests
    meta = json.loads((VIDEO_FIXTURES / "meta.json").read_text())
    names = sorted(n for n in meta if n.endswith((".mkv", ".webm")))
    check(len(names) >= 17, f"[matroska] {len(names)} Matroska / WebM fixtures")
    tally: dict = {}
    n_frames = 0
    for name in names:
        m = meta[name]
        with VideoReader(VIDEO_FIXTURES / name) as r:
            got = [hashlib.sha256(g.tobytes()).hexdigest() for g in r]
            check(got == m["sha256"], f"[matroska] {name}: frames differ from cv2's digests")
            check((r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (m["fps"], m["total"], m["fourcc"]),
                  f"[matroska] {name}: fps {r.fps}, total {r.total}, fourcc {r.fourcc}; cv2 {m}")
            for k, v in getattr(r, "vp8_tally", {}).items():
                tally[k] = tally.get(k, 0) + v
        n_frames += len(got)
    print(f"[matroska] (a) {len(names)} Matroska / WebM fixtures ({n_frames} frames) decoded on this host with "
          f"{native.library_path().name}, each frame equal to cv2's digest, fps, count and fourcc as cv2's; VP8 "
          f"features decoded: " + ", ".join(f"{k} {v}" for k, v in tally.items() if v))
    never = sorted(k for k, v in tally.items() if not v)
    print(f"[matroska] (a) VP8 features no fixture has: {', '.join(never) or 'none'}")

    # (b) VP8 decode times at 512 px, key and inter frames apart
    big = VideoReader(VIDEO_FIXTURES / "big512.webm")
    with big:
        blocks = [big._read(o, n) for o, n in big.samples]
    times: dict = {True: [], False: []}
    for _ in range(MKV_TIMING_REPS):
        dec = native.Vp8Decoder()
        for b in blocks:
            t0 = time.perf_counter()
            got = dec.decode(b)
            if got is not None:
                native.yuv_to_bgr(*got[0], False)
                times[got[1]].append((time.perf_counter() - t0) * 1e3)
        dec.close()
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    check(len(times[True]) == 2 * MKV_TIMING_REPS and len(times[False]) == 14 * MKV_TIMING_REPS,
          f"[matroska] big512.webm: {len(times[True])} key and {len(times[False])} inter frames timed")
    print(f"[matroska] (b) VP8 decode to BGR on one host thread, {card}: {med[True]:.3f} ms a key frame, "
          f"{med[False]:.3f} ms an inter frame (512x512, medians of {len(times[True])} and {len(times[False])})")

    # (c) cli.predict over the WebM and an MJPEG .mkv on the flagship
    rng = np.random.default_rng(3)
    frames = [np.repeat(vessel_image(rng, VIDEO_SIZE, MAX_BOXES)[0][:, :, None], 3, axis=2)
              for _ in range(MKV_PREDICT_FRAMES)]
    src = tmp / "mkv_src"
    src.mkdir()
    (src / "big512.webm").write_bytes((VIDEO_FIXTURES / "big512.webm").read_bytes())
    (src / "angio.mkv").write_bytes(mjpeg_mkv(frames, 25.0))
    out_dir = tmp / "mkv_predict"
    n_video = 16 + MKV_PREDICT_FRAMES
    n_batches = -(-n_video // TRAIN_BATCH)
    counts, written, n_boxes, err, wall, lines = predict_recorded(np, best, src, out_dir, device, "matroska", n_video)
    check(written == {"angio_pred.mp4", "big512_pred.mp4"}, f"[matroska] cli.predict wrote {sorted(written)}")
    check(lines[-3:] == [f"angio.mkv: {MKV_PREDICT_FRAMES} frames -> angio_pred.mp4",
                         "big512.webm: 16 frames -> big512_pred.mp4",
                         f"[mga-predict] 0 images, {n_video} video frames -> {out_dir}"],
          f"[matroska] cli.predict summary {lines[-3:]}")
    for name, fps in (("angio_pred.mp4", 25.0), ("big512_pred.mp4", 25.0)):
        with VideoReader(out_dir / name) as r:
            n = sum(1 for _ in r)
            check(n == r.total == 16 and r.fps == fps and r.size == (VIDEO_SIZE, VIDEO_SIZE),
                  f"[matroska] {name}: {n} frames at {r.fps} fps, {r.size}")
    print(f"[matroska] (c) cli.predict on the seeded flagship over big512.webm (VP8) and angio.mkv (MJPEG), 16 "
          f"frames of {VIDEO_SIZE}x{VIDEO_SIZE} each: {sorted(written)} as the JAX package names them; {n_boxes} "
          f"boxes, each frame's equal to the predictor's on the frames decoded anew (max abs error {err:.3g}); "
          f"launches {counts} ({n_batches} batches of {TRAIN_BATCH}); {n_video / wall:.1f} frames/s on one host "
          f"thread, model load included ({wall:.2f} s), {card}")

    # (d) the .mkv writer, read back
    path = tmp / "angio_out.mkv"
    t0 = time.perf_counter()
    with VideoWriter(path, 29.97, (VIDEO_SIZE, VIDEO_SIZE)) as vw:
        for img in frames:
            vw.write(img)
    enc = (time.perf_counter() - t0) * 1e3 / len(frames)
    with VideoReader(path) as r:
        back = list(r)
        check(r.container == "Matroska" and len(back) == r.total == len(frames) and r.fps == 29.97
              and r.size == (VIDEO_SIZE, VIDEO_SIZE), f"[matroska] {path.name}: {len(back)} frames, {r.total}, "
                                                      f"fps {r.fps}, {r.size}")
    q = min(psnr(np, b, f) for b, f in zip(back, frames))
    check(q >= VIDEO_PSNR, f"[matroska] {path.name}: PSNR {q:.2f} dB against the frames written")
    print(f"[matroska] (d) {len(frames)} angiograms written as {path.name} (mp4v in Matroska, 29.97 fps, "
          f"{path.stat().st_size / 1e3 / len(frames):.1f} kB a frame, {enc:.3f} ms a frame on one host thread) and "
          f"read back: count, total and fps exact, PSNR {q:.2f} dB")
    print(f"[matroska] the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


MPEG_WRITE_FRAMES = 6  # the 512 px angiograms [mpeg] writes as .mpg, .wmv and numbered .gif
# what the writer makes of MPEG_WRITE_FRAMES seeded angiograms on the CPU (SHA-256 of each file)
MPEG_WRITTEN_SHA256 = {
    "angio_out.mpg": "c9f3620a8d218a18440d8a7ef2253349ddfd5daecd07ade972503e238857e7a5",
    "angio_out.wmv": "3535bd6a90e4b2c1f8ef5a50c341f15e9b1bc8e07e7331936ac0a6746c8128ad",
    "angio_out07.gif": "d8b95befd8ab10fb6fdf1557652504ca88b8476610e10dfcf562b2f999e8e2ad",
    "angio_out08.gif": "7345b1bbc7683da99ce2e554557b04a2a9c26f7a80472def6055bef19d14bd98",
    "angio_out09.gif": "dd5fa1b29f36a9e9a5ca13b25f6412dc9955d463401175505c8d65eea93b0fdb",
    "angio_out10.gif": "38c38e5dff367c4bc77fb4a96209a4c68e31988b4e708bb85d03aee34a21809e",
    "angio_out11.gif": "e3401e600153ef447e9aa2c9dc9aa559359289b00faeb830c582f766eda08c7e",
    "angio_out12.gif": "00ebe7adfa3ccc4fc48fd96d1d141127d54ac1d9d4ccb6b58c923b03efe43bf6"}


def mpeg_phase(torch, np, best: Path, tmp: Path, device: str = "cuda") -> dict:
    """MPEG-1 and MPEG-2 on the card's host (``data/video_io.py``'s MPEG-PS
    demuxer, ``native/mpeg12.cpp``), ``cli.predict`` over ``.mpg`` and
    ``.mpeg`` on the flagship, and the writer's ``.mpg``, ``.wmv`` and
    ``.gif``.

    (a) each committed fixture of ``tests/video_fixtures/mpeg.json`` (cv2's
    writer in PS, AVI, MP4 and Matroska; libavcodec's MPEG-1/2 with
    B-pictures, field prediction and field DCT, alternate scan, intra_vlc,
    DC precision 9-11, 4:2:2, loaded matrices, an open GOP; VP8 and MPEG-2
    of odd height) decoded and held to cv2's frame digests, fps, count and
    fourcc. (b) MPEG-2 decode
    on one host thread, ms a picture at 512 px, I, P and B apart
    (big512.mpg). (c) ``cli.predict`` on ``best`` over big512.mpg (MPEG-2,
    16 frames) and big512_m1.mpeg (MPEG-1, 8): the JAX package's file names,
    each frame's boxes equal to the predictor's on the frames decoded anew,
    CAM-gate launches exactly 3 a batch. (d) MPEG_WRITE_FRAMES seeded 512 px
    angiograms written as ``.mpg``, ``.wmv`` and numbered ``.gif``, each
    file's bytes equal to the CPU run's; the ``.mpg`` read back. Returns
    (c)'s launches."""
    import hashlib

    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data.synthetic import vessel_image
    from mga_yolo_tpu_torch.data.video_io import VideoReader, VideoWriter

    t_phase = time.perf_counter()
    card = gpu_name_and_power() if device == "cuda" else "the CPU"
    # (a) the fixtures against cv2's digests
    meta = json.loads((VIDEO_FIXTURES / "mpeg.json").read_text())
    check(len(meta) >= 24, f"[mpeg] {len(meta)} MPEG fixtures")
    tally: dict = {}
    n_frames = 0
    for name, m in sorted(meta.items()):
        with VideoReader(VIDEO_FIXTURES / name) as r:
            imgs = list(r)
            got = [hashlib.sha256(g.tobytes()).hexdigest() for g in imgs]
            check(got == m["sha256"], f"[mpeg] {name}: frames differ from cv2's digests")
            check((r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (m["fps"], m["total"], m["fourcc"]),
                  f"[mpeg] {name}: fps {r.fps}, total {r.total}, fourcc {r.fourcc}; cv2 {m}")
            for k, v in getattr(r, "mpeg12_tally", {}).items():
                tally[k] = tally.get(k, 0) + v
        n_frames += len(got)
    print(f"[mpeg] (a) {len(meta)} MPEG fixtures ({n_frames} frames) decoded on this host with "
          f"{native.library_path().name}, each frame equal to cv2's digest (odd heights too), fps, count and "
          f"fourcc as cv2's; MPEG-1/2 features decoded: "
          + ", ".join(f"{k} {v}" for k, v in tally.items() if v))
    print(f"[mpeg] (a) MPEG-1/2 features no fixture has: {', '.join(sorted(k for k, v in tally.items() if not v))}")

    # (b) MPEG-2 decode times at 512 px, I, P and B pictures apart
    with VideoReader(VIDEO_FIXTURES / "big512.mpg") as big:
        chunks = list(big._es_chunks(b"\x00\x00\x01\x00"))
    times: dict = {1: [], 2: [], 3: []}
    conv = []
    for _ in range(MKV_TIMING_REPS):
        dec = native.Mpeg12Decoder()
        for c in chunks:
            k = c.find(b"\x00\x00\x01\x00")
            t0 = time.perf_counter()
            got = dec.decode(c)
            if k >= 0:  # the chunks but the first (the sequence header alone) hold a picture each
                times[(c[k + 5] >> 3) & 7].append((time.perf_counter() - t0) * 1e3)
            for planes, _ in got:
                t0 = time.perf_counter()
                native.yuv_to_bgr(*planes, False)
                conv.append((time.perf_counter() - t0) * 1e3)
        dec.flush()
        dec.close()
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    check(all(times.values()), f"[mpeg] big512.mpg: pictures timed {[len(v) for v in times.values()]}")
    print(f"[mpeg] (b) MPEG-2 decode on one host thread, {card}: {med[1]:.3f} ms an I-picture, {med[2]:.3f} ms a "
          f"P-picture, {med[3]:.3f} ms a B-picture, {sorted(conv)[len(conv) // 2]:.3f} ms the BGR conversion "
          f"(512x512, medians of {len(times[1])}, {len(times[2])}, {len(times[3])} and {len(conv)})")

    # (c) cli.predict over the MPEG-2 .mpg and the MPEG-1 .mpeg on the flagship
    src = tmp / "mpeg_src"
    src.mkdir()
    for name in ("big512.mpg", "big512_m1.mpeg"):
        (src / name).write_bytes((VIDEO_FIXTURES / name).read_bytes())
    out_dir = tmp / "mpeg_predict"
    n_video = 16 + 8
    n_batches = -(-n_video // TRAIN_BATCH)
    counts, written, n_boxes, err, wall, lines = predict_recorded(np, best, src, out_dir, device, "mpeg", n_video)
    check(written == {"big512_pred.mp4", "big512_m1_pred.mp4"}, f"[mpeg] cli.predict wrote {sorted(written)}")
    check(lines[-3:] == ["big512.mpg: 16 frames -> big512_pred.mp4", "big512_m1.mpeg: 8 frames -> big512_m1_pred.mp4",
                         f"[mga-predict] 0 images, {n_video} video frames -> {out_dir}"],
          f"[mpeg] cli.predict summary {lines[-3:]}")
    print(f"[mpeg] (c) cli.predict on the seeded flagship over big512.mpg (MPEG-2, B-pictures, 16 frames) and "
          f"big512_m1.mpeg (MPEG-1, 8 frames) of {VIDEO_SIZE}x{VIDEO_SIZE}: {sorted(written)} as the JAX package names "
          f"them; {n_boxes} boxes, each frame's equal to the predictor's on the frames decoded anew (max abs error "
          f"{err:.3g}); launches {counts} ({n_batches} batches of {TRAIN_BATCH}); {n_video / wall:.1f} frames/s on "
          f"one host thread, model load included ({wall:.2f} s), {card}")

    # (d) the writer's .mpg, .wmv and numbered .gif, held to the CPU run's bytes
    rng = np.random.default_rng(5)
    frames = [np.repeat(vessel_image(rng, VIDEO_SIZE, MAX_BOXES)[0][:, :, None], 3, axis=2)
              for _ in range(MPEG_WRITE_FRAMES)]
    frames = [np.ascontiguousarray(np.concatenate([f[:, :, :2], np.clip(f[:, :, 2:] + 12, 0, 255)], 2))
              for f in frames]  # a tint, so chroma is not flat
    digests, t_write = {}, {}
    out = tmp / "mpeg_written"  # apart from what earlier phases wrote
    out.mkdir()
    for name in ("angio_out.mpg", "angio_out.wmv", "angio_out07.gif"):
        t0 = time.perf_counter()
        with VideoWriter(out / name, 25, (VIDEO_SIZE, VIDEO_SIZE)) as vw:
            for img in frames:
                vw.write(img)
        t_write[Path(name).suffix] = (time.perf_counter() - t0) * 1e3 / len(frames)
    for p in sorted(out.iterdir()):
        digests[p.name] = hashlib.sha256(p.read_bytes()).hexdigest()
    check(digests == MPEG_WRITTEN_SHA256, f"[mpeg] written files {digests} differ from the CPU run's")
    with VideoReader(out / "angio_out.mpg") as r:
        back = list(r)
        check(r.container == "MPEG-PS" and len(back) == r.total == len(frames) and r.fps == 25.0,
              f"[mpeg] angio_out.mpg: {len(back)} frames, {r.total}, fps {r.fps}")
    q = min(psnr(np, b, f) for b, f in zip(back, frames))
    check(q >= VIDEO_PSNR, f"[mpeg] angio_out.mpg: PSNR {q:.2f} dB against the frames written")
    print(f"[mpeg] (d) {len(frames)} angiograms written as .mpg (mp4v in MPEG-PS, {t_write['.mpg']:.3f} ms a frame), "
          f".wmv (mp4v in ASF, {t_write['.wmv']:.3f} ms) and numbered .gif stills ({t_write['.gif']:.3f} ms) on one "
          f"host thread, {len(digests)} files equal to the CPU run's bytes; the .mpg read back: count, total and fps "
          f"exact, PSNR {q:.2f} dB")
    print(f"[mpeg] the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


def asp_phase(torch, np, best: Path, tmp: Path, device: str = "cuda") -> dict:
    """MPEG-4 Part 2 Advanced Simple profile on the card's host
    (``native/mpeg4.cpp``, ``native/xvid_idct.h``, ``data/video_io.py``) and
    ``cli.predict`` over XviD / DivX clips on the flagship.

    (a) each committed fixture of ``tests/video_fixtures/asp.json`` (B-VOPs
    in AVI, MP4, Matroska and MPEG-PS, DivX's packed bitstream, MPEG
    quantisation, quarter-sample motion, data partitioning, a bare .m4v, the
    XviD IDCT and its workarounds) decoded and held to cv2's frame digests,
    fps, count and fourcc; the interlaced ones to the CPU run's digests of
    libavcodec's planes. (b) decode on one host thread, ms a VOP at 512 px,
    I, P and B apart (big512_asp.avi: XviD-marked, B-VOPs, quarter-sample
    motion). (c) ``cli.predict`` on ``best`` over big512_asp.avi (16 frames)
    and the packed DivX clip (12): each frame's boxes equal to the
    predictor's on the frames decoded anew, CAM-gate launches exactly 3 a
    batch. Returns (c)'s launches."""
    import hashlib

    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    t_phase = time.perf_counter()
    card = gpu_name_and_power() if device == "cuda" else "the CPU"
    # (a) the fixtures against cv2's digests, the interlaced ones against libavcodec's planes
    meta = json.loads((VIDEO_FIXTURES / "asp.json").read_text())
    clips = sorted(n for n in meta if (VIDEO_FIXTURES / n).exists())
    check(len(clips) >= 24, f"[asp] {len(clips)} ASP fixtures")
    tally: dict = {}
    n_frames = 0
    for name in clips:
        m = meta[name]
        with VideoReader(VIDEO_FIXTURES / name) as r:
            imgs = list(r)
            check((r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (m["fps"], m["total"], m["fourcc"]),
                  f"[asp] {name}: fps {r.fps}, total {r.total}, fourcc {r.fourcc}; cv2 {m['fps'], m['total']}")
            for k, v in getattr(r, "mpeg4_tally", {}).items():
                tally[k] = tally.get(k, 0) + v
        if "sha256" in m:
            got = [hashlib.sha256(g.tobytes()).hexdigest() for g in imgs]
            check(got == m["sha256"], f"[asp] {name}: frames differ from cv2's digests")
        else:
            dec = native.Mpeg4Decoder(b"XVID")
            with VideoReader(VIDEO_FIXTURES / name) as r:
                planes = [g[0] for g in (dec.decode(r._read(o, k)) for o, k in r.samples) if g is not None]
            tail = dec.flush()
            dec.close()
            planes += [tail[0]] if tail is not None else []
            got = [hashlib.sha256(b"".join(np.ascontiguousarray(p).tobytes() for p in f)).hexdigest() for f in planes]
            check(got == m["planes_sha256"] and len(imgs) == len(got), f"[asp] {name}: planes differ from the CPU run's")
        n_frames += len(imgs)
    print(f"[asp] (a) {len(clips)} MPEG-4 ASP fixtures ({n_frames} frames) decoded on this host with "
          f"{native.library_path().name}, each frame equal to cv2's digest (the interlaced ones' planes to "
          f"libavcodec's), fps, count and fourcc as cv2's; MPEG-4 features decoded: "
          + ", ".join(f"{k} {v}" for k, v in tally.items() if v))

    # (b) decode times at 512 px, I, P and B-VOPs apart
    with VideoReader(VIDEO_FIXTURES / "big512_asp.avi") as big:
        chunks = [big._read(o, k) for o, k in big.samples]
    times: dict = {0: [], 1: [], 2: []}
    conv = []
    for _ in range(MKV_TIMING_REPS):
        dec = native.Mpeg4Decoder(b"XVID")
        for c in chunks:
            kind = c[c.find(b"\x00\x00\x01\xb6") + 4] >> 6
            t0 = time.perf_counter()
            got = dec.decode(c)
            times[kind].append((time.perf_counter() - t0) * 1e3)
            if got is not None:
                t0 = time.perf_counter()
                native.yuv_to_bgr(*got[0], False, chroma_left=True)
                conv.append((time.perf_counter() - t0) * 1e3)
        check(dec.flush() is not None and dec.tally()["xvid_idct_vops"] == len(chunks), "[asp] big512_asp.avi tally")
        dec.close()
    check(all(times.values()), f"[asp] big512_asp.avi: VOPs timed {[len(v) for v in times.values()]}")
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"[asp] (b) MPEG-4 ASP decode on one host thread, {card}: {med[0]:.3f} ms an I-VOP, {med[1]:.3f} ms a "
          f"P-VOP, {med[2]:.3f} ms a B-VOP, {sorted(conv)[len(conv) // 2]:.3f} ms the BGR conversion (512x512, "
          f"XviD IDCT, quarter-sample; medians of {len(times[0])}, {len(times[1])}, {len(times[2])} and {len(conv)})")

    # (c) cli.predict over the XviD 512 px clip and the packed DivX clip on the flagship
    src = tmp / "asp_src"
    src.mkdir()
    for name in ("big512_asp.avi", "asp_packed.avi"):
        (src / name).write_bytes((VIDEO_FIXTURES / name).read_bytes())
    out_dir = tmp / "asp_predict"
    n_video = 16 + 12
    n_batches = -(-n_video // TRAIN_BATCH)
    counts, written, n_boxes, err, wall, lines = predict_recorded(np, best, src, out_dir, device, "asp", n_video)
    check(written == {"big512_asp_pred.avi", "asp_packed_pred.avi"}, f"[asp] cli.predict wrote {sorted(written)}")
    check(lines[-3:] == ["asp_packed.avi: 12 frames -> asp_packed_pred.avi",
                         "big512_asp.avi: 16 frames -> big512_asp_pred.avi",
                         f"[mga-predict] 0 images, {n_video} video frames -> {out_dir}"],
          f"[asp] cli.predict summary {lines[-3:]}")
    print(f"[asp] (c) cli.predict on the seeded flagship over big512_asp.avi (XviD, B-VOPs, quarter-sample, 16 "
          f"frames of {VIDEO_SIZE}x{VIDEO_SIZE}) and asp_packed.avi (DivX packed, 12 frames): {sorted(written)} as the "
          f"JAX package names them; {n_boxes} boxes, each frame's equal to the predictor's on the frames decoded "
          f"anew (max abs error {err:.3g}); launches {counts} ({n_batches} batches of {TRAIN_BATCH}); "
          f"{n_video / wall:.1f} frames/s on one host thread, model load included ({wall:.2f} s), {card}")
    print(f"[asp] the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


def wmv_phase(torch, np, best: Path, tmp: Path, device: str = "cuda") -> dict:
    """ASF and the MS-MPEG-4 family on the card's host (``native/msmpeg4.cpp``,
    ``native/h263.h``, ``data/video_io.py``'s ASF demuxer) and ``cli.predict``
    over ``.wmv`` and ``.avi`` clips on the flagship.

    (a) each committed fixture of ``tests/video_fixtures/wmv.json`` (cv2's
    WMV1, WMV2, MP42 and MP43 in ASF, AVI and Matroska, mp4v at 12.5, 7 and
    29.97 fps, XVID, MJPG, MPEG-1 and MPEG-2 in ASF, libavcodec's encoders
    at fixed quantisers)
    decoded and held to cv2's frame digests, fps, count and fourcc. (b)
    decode on one host thread, ms a picture at 512 px, I and P apart, for
    WMV2 (wmv_big512.wmv, its frames over several ASF packets) and MP43
    (wmv_big512_mp43.avi). (c) ``cli.predict`` on ``best`` over the two (8
    frames each): each frame's boxes equal to the predictor's on the frames
    decoded anew, CAM-gate launches exactly 3 a batch. (d) the writer's
    ``.wmv`` (mp4v in ASF) read back: 12 frames equal to its ``.mp4`` of
    the same frames read back, at the input's PSNR. Returns (c)'s launches."""
    import hashlib

    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data.video_io import VideoReader, VideoWriter

    t_phase = time.perf_counter()
    card = gpu_name_and_power() if device == "cuda" else "the CPU"
    # (a) the fixtures against cv2's digests, fps, counts and fourccs
    meta = json.loads((VIDEO_FIXTURES / "wmv.json").read_text())
    clips = sorted(meta)
    check(len(clips) >= 30, f"[wmv] {len(clips)} WMV fixtures")
    tally: dict = {}
    n_frames = 0
    for name in clips:
        m = meta[name]
        with VideoReader(VIDEO_FIXTURES / name) as r:
            got = [hashlib.sha256(g.tobytes()).hexdigest() for g in r]
            check((r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (m["fps"], m["total"], m["fourcc"]),
                  f"[wmv] {name}: fps {r.fps}, total {r.total}, fourcc {r.fourcc}; cv2 {m['fps'], m['total']}")
            for k, v in getattr(r, "msmpeg4_tally", {}).items():
                tally[k] = tally.get(k, 0) + v
        check(got == m["sha256"], f"[wmv] {name}: frames differ from cv2's digests")
        n_frames += len(got)
    check(all(tally.get(k) for k in native.MSMPEG4_TALLY), f"[wmv] tools not decoded: {tally}")
    print(f"[wmv] (a) {len(clips)} ASF / MS-MPEG-4 family fixtures ({n_frames} frames) decoded on this host with "
          f"{native.library_path().name}, each frame equal to cv2's digest, fps, count and fourcc as cv2's; "
          f"MS-MPEG-4 features decoded: " + ", ".join(f"{k} {v}" for k, v in tally.items()))

    # (b) decode times at 512 px, I and P-pictures apart, WMV2 and MP43
    med = {}
    for name, fourcc in (("wmv_big512.wmv", b"WMV2"), ("wmv_big512_mp43.avi", b"MP43")):
        with VideoReader(VIDEO_FIXTURES / name) as big:
            chunks = [big._sample(s) for s in big.samples]
            extradata, size = big.extradata, big.size
        times: dict = {0: [], 1: []}
        conv = []
        for _ in range(MKV_TIMING_REPS):
            dec = native.MsMpeg4Decoder(fourcc, extradata, size)
            for c in chunks:
                t0 = time.perf_counter()
                (y, u, v), kind = dec.decode(c)
                times[kind].append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                native.yuv_to_bgr(y, u, v, full_range=False)
                conv.append((time.perf_counter() - t0) * 1e3)
            dec.close()
        check(all(times.values()), f"[wmv] {name}: pictures timed {[len(v) for v in times.values()]}")
        med[fourcc.decode()] = [sorted(times[k])[len(times[k]) // 2] for k in (0, 1)] + \
            [sorted(conv)[len(conv) // 2], len(times[0]), len(times[1])]
    print(f"[wmv] (b) decode on one host thread, {card}, 512x512: " + "; ".join(
        f"{k} {i:.3f} ms an I-picture, {p:.3f} ms a P-picture, {c:.3f} ms the BGR conversion (medians of {ni} and "
        f"{npp})" for k, (i, p, c, ni, npp) in med.items()))

    # (c) cli.predict over the WMV2 .wmv and the MP43 .avi on the flagship
    src = tmp / "wmv_src"
    src.mkdir()
    for name in ("wmv_big512.wmv", "wmv_big512_mp43.avi"):
        (src / name).write_bytes((VIDEO_FIXTURES / name).read_bytes())
    out_dir = tmp / "wmv_predict"
    n_video = 8 + 8
    n_batches = -(-n_video // TRAIN_BATCH)
    counts, written, n_boxes, err, wall, lines = predict_recorded(np, best, src, out_dir, device, "wmv", n_video)
    check(written == {"wmv_big512_pred.mp4", "wmv_big512_mp43_pred.avi"}, f"[wmv] cli.predict wrote {sorted(written)}")
    check(lines[-3:] == ["wmv_big512.wmv: 8 frames -> wmv_big512_pred.mp4",
                         "wmv_big512_mp43.avi: 8 frames -> wmv_big512_mp43_pred.avi",
                         f"[mga-predict] 0 images, {n_video} video frames -> {out_dir}"],
          f"[wmv] cli.predict summary {lines[-3:]}")
    print(f"[wmv] (c) cli.predict on the seeded flagship over wmv_big512.wmv (WMV2 in ASF) and wmv_big512_mp43.avi "
          f"(MP43 in AVI), 8 frames each of {VIDEO_SIZE}x{VIDEO_SIZE}: {sorted(written)} as the JAX package names "
          f"them; {n_boxes} boxes, each frame's equal to the predictor's on the frames decoded anew (max abs error "
          f"{err:.3g}); launches {counts} ({n_batches} batches of {TRAIN_BATCH}); {n_video / wall:.1f} frames/s on "
          f"one host thread, model load included ({wall:.2f} s), {card}")

    # (d) the writer's .wmv read back, against its .mp4 of the same frames
    ramp = 40 + np.add.outer(np.arange(48) * 2, np.arange(64) * 1.5)  # smooth ramps, brighter a little each frame
    imgs = [np.stack([ramp + 5 * i + 10 * c for c in range(3)], -1).astype(np.uint8) for i in range(12)]
    back = {}
    for suffix in (".wmv", ".mp4"):
        with VideoWriter(tmp / f"written{suffix}", 25, (64, 48)) as vw:
            for img in imgs:
                vw.write(img)
        with VideoReader(tmp / f"written{suffix}") as r:
            back[suffix] = (list(r), r.fps, r.total, r.container)
    frames_wmv, fps, total, container = back[".wmv"]
    mse = float(np.mean([(a.astype(np.float64) - b) ** 2 for a, b in zip(frames_wmv, imgs)]))
    psnr = 10 * float(np.log10(255 ** 2 / mse))
    check(container == "ASF" and (fps, total) == (25.0, 12) and len(frames_wmv) == 12 and
          all((a == b).all() for a, b in zip(frames_wmv, back[".mp4"][0])) and psnr >= 30,
          f"[wmv] the writer's .wmv read back: {container}, {fps} fps, {total} frames, PSNR {psnr:.1f}")
    print(f"[wmv] (d) the writer's .wmv (mp4v in ASF) read back: 12 frames at {fps} fps, equal to its .mp4 of the "
          f"same frames read back, PSNR {psnr:.1f} dB against the frames written")
    print(f"[wmv] the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


H264_TIMING_REPS = 5  # each 512 px clip decoded 5 times for its per-picture times


def h264_picture_kind(sample: bytes, length_size: int) -> str:
    """"IDR", "I", "P" or "B": the first slice's of an access unit (NAL lengths of length_size bytes, 0 for start
    codes), read from its first_mb_in_slice and slice_type."""
    i = 0
    while i < len(sample):
        if length_size:
            n = int.from_bytes(sample[i:i + length_size], "big")
            nal, i = sample[i + length_size:i + length_size + n], i + length_size + n
        else:
            j = sample.find(b"\x00\x00\x01", i)
            k = sample.find(b"\x00\x00\x01", j + 3)
            nal, i = sample[j + 3:k if k >= 0 else len(sample)], k if k >= 0 else len(sample)
        if nal and nal[0] & 0x1F in (1, 5):
            bits = "".join(f"{b:08b}" for b in nal[1:9])
            vals, p = [], 0
            for _ in range(2):  # two ue(v)
                z = bits.index("1", p) - p
                vals.append(int(bits[p + z:p + 2 * z + 1], 2) - 1)
                p += 2 * z + 1
            return "IDR" if nal[0] & 0x1F == 5 else ("P", "B", "I", "SP", "SI")[vals[1] % 5]
    return "none"


def h264_phase(torch, np, best: Path, tmp: Path, device: str = "cuda") -> dict:
    """H.264 Baseline, Main and High on the card's host (``native/h264.cpp``,
    ``data/video_io.py``'s avc1 / Matroska / AVI tracks) and ``cli.predict``
    over ``.mp4`` clips on the flagship.

    (a) each committed H.264 fixture of ``tests/video_fixtures/h264.json``
    (the tests' writer's syntax clips in AVI, MP4, MOV and Matroska, and the
    512 px angiogram in the Baseline and the High profile, each in MP4 and
    Matroska) checked by its own SHA-256, decoded and held to cv2's frame
    digests, fps, count and fourcc, every tool of ``native.H264_TALLY``
    counted. (b) decode on one host thread, ms a 512 px picture by kind: the
    Baseline clip's IDR and P pictures, the High clip's (CABAC, the 8x8
    transform, a pyramid of B pictures) IDR, P and B pictures; and the BGR
    conversion. (c) ``cli.predict`` on ``best`` over the Baseline and the
    High 512 px ``.mp4`` (8 frames each, 16 in one batch): exactly 3 CAM-gate
    launches, each frame's boxes equal to the predictor's on the frames
    decoded anew, max abs error 0. (d) cv2's MJPG clips one row high against
    their digests. Returns (c)'s launches."""
    import hashlib

    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    t_phase = time.perf_counter()
    card = gpu_name_and_power() if device == "cuda" else "the CPU"
    meta = json.loads((VIDEO_FIXTURES / "h264.json").read_text())
    for name, m in meta.items():
        digest = hashlib.sha256((VIDEO_FIXTURES / name).read_bytes()).hexdigest()
        check(digest == m["file_sha256"], f"[h264] {name}: the file is not the one h264.json records")
    # (a) the fixtures against cv2's digests, fps, counts and fourccs
    clips = sorted(n for n in meta if n.startswith("h264_"))
    check(len(clips) >= 26, f"[h264] {len(clips)} H.264 fixtures")
    tally = dict.fromkeys(native.H264_TALLY, 0)
    n_frames = 0
    for name in clips:
        m = meta[name]
        with VideoReader(VIDEO_FIXTURES / name) as r:
            got = [hashlib.sha256(g.tobytes()).hexdigest() for g in r]
            check((r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (m["fps"], m["total"], m["fourcc"]),
                  f"[h264] {name}: fps {r.fps}, total {r.total}, fourcc {r.fourcc}; cv2 {m['fps'], m['total']}")
            for k, v in r.h264_tally.items():
                tally[k] += v
        check(got == m["sha256"], f"[h264] {name}: frames differ from cv2's digests")
        n_frames += len(got)
    check(all(tally.values()), f"[h264] tools not decoded: {[k for k, v in tally.items() if not v]}")
    print(f"[h264] (a) {len(clips)} H.264 fixtures ({n_frames} frames) decoded on this host with "
          f"{native.library_path().name}, each file's SHA-256 as recorded, each frame equal to cv2's digest, fps, "
          f"count and fourcc as cv2's; all {len(tally)} tools counted: " +
          ", ".join(f"{k} {v}" for k, v in tally.items()))

    # (b) decode times at 512 px by picture kind, the Baseline and the High profile's clips
    med: dict = {}
    conv = []
    for clip, kinds in (("h264_big512.mp4", ("IDR", "P")), ("h264_high512.mp4", ("IDR", "P", "B"))):
        with VideoReader(VIDEO_FIXTURES / clip) as big:
            chunks = [big._sample(s) for s in big.samples]
            extradata, size = big.extradata, big.size
        length_size = (extradata[4] & 3) + 1
        kind_of = [h264_picture_kind(c, length_size) for c in chunks]
        check(set(kind_of) == set(kinds), f"[h264] {clip}: pictures {kind_of}")
        times: dict = {k: [] for k in kinds}
        for _ in range(H264_TIMING_REPS):
            dec = native.H264Decoder(extradata, size)
            out = []
            for c, kind in zip(chunks, kind_of):
                t0 = time.perf_counter()
                out += dec.decode(c)
                times[kind].append((time.perf_counter() - t0) * 1e3)
            out += dec.flush()
            check(len(out) == len(chunks), f"[h264] {clip}: {len(out)} frames out of {len(chunks)} samples")
            for (y, u, v), info in out:
                t0 = time.perf_counter()
                native.yuv_to_bgr(y, u, v, full_range=info["full_range"], chroma_left=True)
                conv.append((time.perf_counter() - t0) * 1e3)
            dec.close()
        med[clip] = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        med[clip]["n"] = {k: len(v) for k, v in times.items()}
    mc = sorted(conv)[len(conv) // 2]
    base, high = med["h264_big512.mp4"], med["h264_high512.mp4"]
    print(f"[h264] (b) decode on one host thread, {card}, 512x512: Baseline (CAVLC) {base['IDR']:.3f} ms the IDR "
          f"picture, {base['P']:.3f} ms a P picture; High (CABAC, 8x8 transform, B pyramid) {high['IDR']:.3f} ms the "
          f"IDR picture, {high['P']:.3f} ms a P picture, {high['B']:.3f} ms a B picture (medians of "
          f"{base['n']} and {high['n']} samples); {mc:.3f} ms the BGR conversion (median of {len(conv)}); "
          f"{1e3 / ((high['IDR'] + 2 * high['P'] + 5 * high['B']) / 8 + mc):.1f} frames/s decoded and converted over "
          f"the High clip's 1 IDR + 2 P + 5 B")

    # (c) cli.predict over the Baseline and the High 512 px .mp4 on the flagship, 16 frames in one batch
    src = tmp / "h264_src"
    src.mkdir()
    for name in ("h264_big512.mp4", "h264_high512.mp4"):
        (src / name).write_bytes((VIDEO_FIXTURES / name).read_bytes())
    out_dir = tmp / "h264_predict"
    n_video = 8 + 8
    counts, written, n_boxes, err, wall, lines = predict_recorded(np, best, src, out_dir, device, "h264", n_video)
    check(counts.get("cam_gate") == 3, f"[h264] cli.predict launched {counts}, want exactly 3 CAM gates")
    check(err == 0.0, f"[h264] cli.predict boxes differ from the predictor's by {err}")
    check(written == {"h264_big512_pred.mp4", "h264_high512_pred.mp4"}, f"[h264] cli.predict wrote {sorted(written)}")
    check(lines[-3:] == ["h264_big512.mp4: 8 frames -> h264_big512_pred.mp4",
                         "h264_high512.mp4: 8 frames -> h264_high512_pred.mp4",
                         f"[mga-predict] 0 images, {n_video} video frames -> {out_dir}"],
          f"[h264] cli.predict summary {lines[-3:]}")
    print(f"[h264] (c) cli.predict on the seeded flagship over h264_big512.mp4 (Baseline) and h264_high512.mp4 "
          f"(High: CABAC, 8x8 transform, B pictures), 8 frames each of 512x512, {TRAIN_BATCH} frames a batch: "
          f"{sorted(written)} as the JAX package names them; {n_boxes} boxes, each frame's equal to the predictor's on "
          f"the frames decoded anew (max abs error {err:.3g}); launches {counts}; {n_video / wall:.1f} frames/s on one "
          f"host thread, model load included ({wall:.2f} s), {card}")

    # (d) cv2's MJPG clips one row high
    rows = sorted(n for n in meta if n.startswith("mjpg_row"))
    check(len(rows) == 5, f"[h264] {len(rows)} one-row MJPG clips")
    for name in rows:
        with VideoReader(VIDEO_FIXTURES / name) as r:
            got = [hashlib.sha256(g.tobytes()).hexdigest() for g in r]
        check(got == meta[name]["sha256"], f"[h264] {name}: frames differ from cv2's digests")
    print(f"[h264] (d) {len(rows)} MJPG clips one row high ({', '.join(rows)}) equal to cv2's digests")
    print(f"[h264] the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


LOSSLESS_TIMING_REPS = 3  # each 512 px clip decoded 3 times for its per-frame times


def lossless_phase(torch, np, best: Path, tmp: Path, device: str = "cuda") -> dict:
    """PNG frames, FFV1, HuffYUV and FFVHuff on the card's host
    (``native/ffv1.cpp``, ``native/huffyuv.cpp``, ``data/video_io.py``) and
    ``cli.predict`` over lossless clips on the flagship.

    (a) each committed fixture of ``tests/video_fixtures/lossless.json``
    (cv2's writer's PNG, FFV1, HuffYUV and FFVHuff in AVI, Matroska, ASF,
    MOV and MP4; libavcodec's encoders over every version, coder, predictor
    and pixel format; the tests' own HuffYUV writer's clips) checked by its
    own SHA-256, decoded and held to cv2's frame digests (libpng's for the
    Adam7 clip), fps, count and fourcc, every tool of ``native.FFV1_TALLY``
    and ``native.HUFFYUV_TALLY`` counted. (b) decode on one host thread, ms a
    512 px frame: FFV1 grey and HuffYUV RGB24, and their conversions to BGR.
    (c) ``cli.predict`` on ``best`` over the FFV1 ``.mkv`` and the HuffYUV
    ``.avi`` (8 frames each of a 512 px grey angiogram, 16 in one batch):
    exactly 3 CAM-gate launches, each frame's boxes equal to the predictor's
    on the frames decoded anew, max abs error 0. Returns (c)'s launches."""
    import hashlib

    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    t_phase = time.perf_counter()
    card = gpu_name_and_power() if device == "cuda" else "the CPU"
    meta = json.loads((VIDEO_FIXTURES / "lossless.json").read_text())
    # (a) the fixtures against cv2's digests, fps, counts and fourccs
    check(len(meta) >= 58, f"[lossless] {len(meta)} lossless fixtures")
    tallies = {"ffv1": dict.fromkeys(native.FFV1_TALLY, 0), "huffyuv": dict.fromkeys(native.HUFFYUV_TALLY, 0)}
    n_frames = 0
    for name, m in sorted(meta.items()):
        data = (VIDEO_FIXTURES / name).read_bytes()
        check(hashlib.sha256(data).hexdigest() == m["file_sha256"],
              f"[lossless] {name}: the file is not the one lossless.json records")
        with VideoReader(VIDEO_FIXTURES / name) as r:
            got = [hashlib.sha256(g.tobytes()).hexdigest() for g in r]
            check((r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (m["fps"], m["total"], m["fourcc"]),
                  f"[lossless] {name}: fps {r.fps}, total {r.total}, fourcc {r.fourcc}; cv2 {m['fps'], m['total']}")
            for attr, key in (("ffv1_tally", "ffv1"), ("huffyuv_tally", "huffyuv"), ("ffvhuff_tally", "huffyuv")):
                for k, v in getattr(r, attr, {}).items():
                    tallies[key][k] += v
        check(got == m["sha256"], f"[lossless] {name}: frames differ from the oracle's digests ({m['oracle']})")
        n_frames += len(got)
    for key, tally in tallies.items():
        check(all(tally.values()), f"[lossless] {key} tools not decoded: {[k for k, v in tally.items() if not v]}")
    print(f"[lossless] (a) {len(meta)} PNG, FFV1, HuffYUV and FFVHuff fixtures ({n_frames} frames) decoded on this "
          f"host with {native.library_path().name}, each file's SHA-256 as recorded, each frame equal to cv2's digest "
          f"(libpng's for the Adam7 PNG clip), fps, count and fourcc as cv2's; all {len(tallies['ffv1'])} FFV1 and "
          f"{len(tallies['huffyuv'])} HuffYUV tools counted: FFV1 " +
          ", ".join(f"{k} {v}" for k, v in tallies["ffv1"].items()) + "; HuffYUV " +
          ", ".join(f"{k} {v}" for k, v in tallies["huffyuv"].items()))

    # (b) decode times of a 512 px frame by codec and pixel format, on one host thread
    med = {}
    for clip, label in (("ffv1_big512.mkv", "FFV1 grey"), ("hfyu_big512.avi", "HuffYUV RGB24")):
        with VideoReader(VIDEO_FIXTURES / clip) as big:
            chunks = [big._sample(s) for s in big.samples]
            extradata, size, bits = big.extradata, big.size, big.bits_per_coded_sample
        dec_ms, conv_ms = [], []
        for _ in range(LOSSLESS_TIMING_REPS):
            dec = native.Ffv1Decoder(extradata, size) if clip.startswith("ffv1") else \
                native.HuffyuvDecoder(False, extradata, bits, size)
            for c in chunks:
                t0 = time.perf_counter()
                planes = dec.decode(c)
                t1 = time.perf_counter()
                native.planes_to_bgr(dec.pix_fmt, planes, dec.subsampling)
                dec_ms.append((t1 - t0) * 1e3)
                conv_ms.append((time.perf_counter() - t1) * 1e3)
            dec.close()
        med[label] = (sorted(dec_ms)[len(dec_ms) // 2], sorted(conv_ms)[len(conv_ms) // 2], len(dec_ms))
    print(f"[lossless] (b) decode on one host thread, {card}, 512x512: " + "; ".join(
        f"{label} {d:.3f} ms a frame, {c:.3f} ms its BGR conversion (medians of {n}), {1e3 / (d + c):.1f} frames/s"
        for label, (d, c, n) in med.items()))

    # (c) cli.predict over the FFV1 .mkv and the HuffYUV .avi on the flagship, 16 frames in one batch
    src = tmp / "lossless_src"
    src.mkdir()
    for name in ("ffv1_big512.mkv", "hfyu_big512.avi"):
        (src / name).write_bytes((VIDEO_FIXTURES / name).read_bytes())
    out_dir = tmp / "lossless_predict"
    n_video = 8 + 8
    counts, written, n_boxes, err, wall, lines = predict_recorded(np, best, src, out_dir, device, "lossless", n_video)
    check(counts.get("cam_gate") == 3, f"[lossless] cli.predict launched {counts}, want exactly 3 CAM gates")
    check(err == 0.0, f"[lossless] cli.predict boxes differ from the predictor's by {err}")
    check(written == {"ffv1_big512_pred.mp4", "hfyu_big512_pred.avi"},
          f"[lossless] cli.predict wrote {sorted(written)}")
    check(lines[-3:] == ["ffv1_big512.mkv: 8 frames -> ffv1_big512_pred.mp4",
                         "hfyu_big512.avi: 8 frames -> hfyu_big512_pred.avi",
                         f"[mga-predict] 0 images, {n_video} video frames -> {out_dir}"],
          f"[lossless] cli.predict summary {lines[-3:]}")
    print(f"[lossless] (c) cli.predict on the seeded flagship over ffv1_big512.mkv (FFV1 grey) and hfyu_big512.avi "
          f"(HuffYUV RGB24), 8 frames each of 512x512, {TRAIN_BATCH} frames a batch: {sorted(written)} as the JAX "
          f"package names them; {n_boxes} boxes, each frame's equal to the predictor's on the frames decoded anew "
          f"(max abs error {err:.3g}); launches {counts}; {n_video / wall:.1f} frames/s on one host thread, model load "
          f"included ({wall:.2f} s), {card}")
    print(f"[lossless] the phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


def planted_faults(tag: str, faults: dict) -> int:
    """``chip_smoke.py --{tag}-faults``: ``[tag]`` alone (``--{tag}-alone``)
    on a copy of this checkout, then on a copy with each of ``faults``
    planted; exits non-zero unless the first passes and every fault fails.
    The copies live in the build directory, which git ignores."""
    import shutil

    from mga_yolo_tpu_torch.kernels import _build

    root = Path(__file__).resolve().parent
    print(gpu_name_and_power())
    _build.build(KERNEL_SOURCES)  # the copies take the libraries
    ok = True
    for name, edits in (("none", []), *faults.items()):
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            tree = Path(tmp) / "tree"
            shutil.copytree(root, tree, ignore=shutil.ignore_patterns(".git", "chiprun_out", "_build",
                                                                     ".smoke_checkout"))
            shutil.copytree(_build.BUILD_DIR, tree / _build.BUILD_DIR.relative_to(root),
                            ignore=shutil.ignore_patterns("tmp*"))
            for f, old, new in edits:
                text = (tree / f).read_text()
                check(text.count(old) == 1, f"[{tag}-faults] {name}: {old.strip()!r} is not once in {f}")
                (tree / f).write_text(text.replace(old, new))
            run = subprocess.run([sys.executable, "chip_smoke.py", f"--{tag}-alone"], cwd=tree, capture_output=True,
                                 text=True, timeout=2 * DDP_TIMEOUT_S)
        lines = [ln for ln in (run.stdout + run.stderr).splitlines() if ln.startswith((f"[{tag}]", "RuntimeError",
                                                                                       "AssertionError"))]
        caught = run.returncode != 0
        ok &= caught == bool(edits)
        print(f"[{tag}-faults] {name}: [{tag}] {'failed' if caught else 'passed'} (exit {run.returncode})"
              + ("" if caught == bool(edits) else " -- WRONG"))
        for ln in lines[:3] + lines[-1:]:
            print(f"[{tag}-faults] {name}:   {ln[:600]}")
    return 0 if ok else 1


def phase_alone(tag: str) -> int:
    """``chip_smoke.py --{tag}-alone``: build the kernels and run ``[ddp]``,
    ``[spatial]``, ``[formats]``, ``[formats2]`` (on a synthetic set of
    64 + 16 images; ``[formats2]``'s cli.predict on the seeded flagship),
    ``[matroska]``, ``[mpeg]``, ``[asp]``, ``[wmv]``, ``[h264]`` or
    ``[lossless]`` (the seeded flagship)."""
    import numpy as np
    import torch

    from mga_yolo_tpu_torch.data.synthetic import write_synthetic_dataset
    from mga_yolo_tpu_torch.kernels import _build

    print(gpu_name_and_power())
    _build.build(KERNEL_SOURCES)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        if tag in ("matroska", "mpeg", "asp", "wmv", "h264", "lossless"):
            {"matroska": matroska_phase, "mpeg": mpeg_phase, "asp": asp_phase, "wmv": wmv_phase,
             "h264": h264_phase, "lossless": lossless_phase}[tag](
                torch, np, seeded_checkpoint(torch, Path(tmp) / "seeded.pt"), Path(tmp))
        elif tag in ("formats", "formats2"):
            data_yaml = write_synthetic_dataset(Path(tmp) / "ds", n=64, size=512, max_boxes=MAX_BOXES, seed=0, n_val=16)
            if tag == "formats":
                formats_phase(torch, np, data_yaml, Path(tmp))
            else:
                formats2_phase(torch, np, data_yaml, seeded_checkpoint(torch, Path(tmp) / "seeded.pt"), Path(tmp))
        else:
            {"ddp": ddp_phase, "spatial": spatial_phase}[tag](torch, np, Path(tmp))
    return 0


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
    secs = _build.build(KERNEL_SOURCES)
    print(f"[build] {time.perf_counter() - t0:.2f} s wall, per source {secs}")
    for name in secs:
        log = _build.library_path(name).with_suffix(".log").read_text().strip()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    kernels = [kernel_phase_cam(torch), kernel_phase_nms(torch), kernel_phase_dfl(torch),
               kernel_phase_pool(torch), kernel_phase_reductions(torch)]
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
        paths["train_data"], fed = data_phase(torch, np, data_yaml)
        paths["data_dev"] = data_dev_phase(torch, np, data_yaml, fed)
        del fed
        paths["fit"], trainer, best = fit_phase(torch, np, data_yaml, Path(tmp) / "runs")
        paths["fit_dev"] = fit_dev_phase(torch, np, data_yaml, Path(tmp) / "runs")
        paths["predict"] = predict_phase(torch, np, data_yaml, trainer, best, Path(tmp))
        paths["export"] = export_phase(torch, np, data_yaml, best, Path(tmp))
        del trainer
        t0 = time.perf_counter()
        paths["ddp"] = ddp_phase(torch, np, Path(tmp))
        paths["ddp_nccl"] = ddp_nccl_phase(torch, np, Path(tmp))
        paths["ddp_fit"] = ddp_fit_phase(torch, np, data_yaml, Path(tmp))
        print(f"[ddp] the three data-parallel phases took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        paths["spatial"] = spatial_phase(torch, np, Path(tmp))
        paths["spatial_fit"] = spatial_fit_phase(torch, np, data_yaml, Path(tmp))
        paths["spatial_fit_dev"] = spatial_fit_phase(torch, np, data_yaml, Path(tmp), on_device=True)
        print(f"[spatial] the three spatial-mesh phases took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        paths["base"] = base_phase(torch, np, data_yaml, Path(tmp))
        grid_phase(torch, np, data_yaml, Path(tmp))  # child processes: no launch of this process
        print(f"[base] [grid] the baseline toolchain and the grid took {time.perf_counter() - t0:.1f} s")
        paths["jpeg"] = jpeg_phase(torch, np, data_yaml, best, Path(tmp))
        paths["video"] = video_phase(torch, np, data_yaml, best, Path(tmp))
        paths["formats"] = formats_phase(torch, np, data_yaml, Path(tmp))
        paths["formats2"] = formats2_phase(torch, np, data_yaml, best, Path(tmp))
        paths["matroska"] = matroska_phase(torch, np, seeded_checkpoint(torch, Path(tmp) / "mkv_seeded.pt"), Path(tmp))
        paths["mpeg"] = mpeg_phase(torch, np, seeded_checkpoint(torch, Path(tmp) / "mpeg_seeded.pt"), Path(tmp))
        paths["asp"] = asp_phase(torch, np, seeded_checkpoint(torch, Path(tmp) / "asp_seeded.pt"), Path(tmp))
        paths["wmv"] = wmv_phase(torch, np, seeded_checkpoint(torch, Path(tmp) / "wmv_seeded.pt"), Path(tmp))
        paths["h264"] = h264_phase(torch, np, seeded_checkpoint(torch, Path(tmp) / "h264_seeded.pt"), Path(tmp))
        paths["lossless"] = lossless_phase(torch, np, seeded_checkpoint(torch, Path(tmp) / "lossless_seeded.pt"),
                                           Path(tmp))
    # each kernel's launches are those of this slice's path first (cli.predict
    # over an FFV1 .mkv and a HuffYUV .avi), then the earlier slices' (cli.predict
    # over an H.264 .mp4 and .mkv, over a WMV2 .wmv and an MP43 .avi, over an
    # XviD and a packed DivX .avi, over an MPEG-2 .mpg and an MPEG-1 .mpeg, over a VP8 WebM
    # and an MJPEG .mkv, uploads of
    # CCITT TIFF, GIF, PNM / PAM / PFM, Sun raster and HDR served, micro-steps
    # fed from T.6 masks, cli.predict over GIF clips, uploads of the still
    # formats served and micro-steps fed from
    # them, cli.predict over video, JPEG uploads served and
    # JPEG-fed micro-steps, cli.val on an exported file, where tensorflow imports, the baseline
    # toolchain's run, the spatial-mesh run with device
    # augmentation, the spatial-mesh run and
    # micro-steps, the data-parallel run, micro-steps and NCCL group, the
    # predictor, device augmentation, the training run, the loader-fed train
    # step, prob_mode, SPADE, plain YOLOv8), else MaskECA's, else the flagship's
    order = ("lossless", "h264", "wmv", "asp", "mpeg", "matroska", "formats2", "formats", "video", "jpeg", "export",
             "base", "spatial_fit_dev", "spatial_fit", "spatial", "ddp_fit", "ddp", "ddp_nccl", "predict",
             "fit_dev", "data_dev", "fit", "train_data", "train_prob", "serve_spade", "train_spade", "serve_base",
             "train_base", "train_eca", "serve_eca", "train", "serve")
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


def reductions_alone(parent: Path | None) -> int:
    """``chip_smoke.py --reductions-alone [PARENT]``: build the kernels and
    run the masked reductions' ``[kernels]`` phase alone; with PARENT (an
    unpacked checkout of the parent commit), the parent's kernel timed beside
    the new one in turns."""
    import torch

    from mga_yolo_tpu_torch.kernels import _build

    print(gpu_name_and_power())
    secs = _build.build(KERNEL_SOURCES)
    print(f"[build] per source {secs}")
    for line in _build.library_path("masked_reductions").with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower() or "warning" in line.lower():
            print(f"[build] masked_reductions: {line.strip()}")
    print(json.dumps({"kernels": [kernel_phase_reductions(torch, parent)]}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reductions-alone"] and len(sys.argv) <= 3:
        import torch

        if not torch.cuda.is_available():
            sys.exit("chip_smoke: CUDA is not available; this script runs on a CUDA card only")
        sys.exit(reductions_alone(Path(sys.argv[2]).resolve() if len(sys.argv) == 3 else None))
    if sys.argv[1:] in (["--ddp-faults"], ["--ddp-alone"], ["--spatial-faults"], ["--spatial-alone"],
                        ["--formats-alone"], ["--formats2-alone"], ["--matroska-alone"], ["--mpeg-alone"],
                        ["--asp-alone"], ["--wmv-alone"], ["--h264-alone"], ["--lossless-alone"]):
        import torch

        if not torch.cuda.is_available():
            sys.exit("chip_smoke: CUDA is not available; this script runs on a CUDA card only")
        tag, what = sys.argv[1][2:].rsplit("-", 1)
        sys.exit(planted_faults(tag, {"ddp": DDP_FAULTS, "spatial": SPATIAL_FAULTS}[tag]) if what == "faults"
                 else phase_alone(tag))
    sys.exit(main())
