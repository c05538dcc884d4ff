"""The port's host-side metrics stack against the JAX package, exactly.

The same seeded numpy detections and ground truth go through
``mga_yolo_tpu.utils.metrics`` and ``mga_yolo_tpu_torch.utils.metrics``
(IoU, matching, AP, per-class AP, confusion matrix, the accumulator), and the
same decoded predictions through both ``nms_numpy``; the results.csv, run
directory and COCO writers give the same files. Tolerance 0 everywhere: the
port keeps the JAX package's numpy code. A distributed validation's gather
(two gloo processes) gives one process's metrics over all the data.
"""

from __future__ import annotations

import csv
import json

import numpy as np
import pytest

from mga_yolo_tpu.ops import nms as jnms
from mga_yolo_tpu.utils import coco as jcoco
from mga_yolo_tpu.utils import csvlog as jcsv
from mga_yolo_tpu.utils import files as jfiles
from mga_yolo_tpu.utils import metrics as jm
from mga_yolo_tpu_torch.ops import nms as tnms
from mga_yolo_tpu_torch.utils import coco as tcoco
from mga_yolo_tpu_torch.utils import csvlog as tcsv
from mga_yolo_tpu_torch.utils import files as tfiles
from mga_yolo_tpu_torch.utils import metrics as tm

# (seed, images, classes, what is special)
CASES = {
    "one_class": (0, 6, 1, None),
    "three_classes": (1, 8, 3, None),
    "score_ties": (2, 8, 2, "ties"),
    "no_predictions": (3, 4, 2, "empty_pred"),
    "no_ground_truth": (4, 4, 2, "empty_gt"),
    "some_images_empty": (5, 10, 3, "mixed"),
}


def det_case(seed: int, n_img: int, nc: int, special):
    """Per image: (pred boxes, conf, cls, gt boxes, gt cls); predictions are
    jittered copies of the ground truth (some with a wrong class) plus random
    boxes, so every IoU threshold has hits and misses."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_img):
        m = 0 if special == "empty_gt" or (special == "mixed" and i % 3 == 0) else int(rng.integers(1, 6))
        xy = rng.uniform(0, 200, (m, 2))
        gt = np.concatenate([xy, xy + rng.uniform(10, 80, (m, 2))], 1).astype(np.float32)
        gcls = rng.integers(0, nc, m).astype(np.float32)
        jit = gt + rng.normal(0, 4, gt.shape).astype(np.float32)
        k = int(rng.integers(0, 6))
        xy2 = rng.uniform(0, 200, (k, 2))
        rnd = np.concatenate([xy2, xy2 + rng.uniform(5, 60, (k, 2))], 1).astype(np.float32)
        pb = np.concatenate([jit, rnd]).astype(np.float32)
        pc = np.concatenate([np.where(rng.random(m) < 0.8, gcls, rng.integers(0, nc, m)),
                             rng.integers(0, nc, k)]).astype(np.float32)
        conf = rng.uniform(0.001, 1.0, len(pb)).astype(np.float32)
        if special == "ties":
            conf = np.round(conf, 1).clip(0.1, 1.0).astype(np.float32)
        if special == "empty_pred" or (special == "mixed" and i % 3 == 1):
            pb, pc, conf = pb[:0], pc[:0], conf[:0]
        out.append((pb, conf, pc, gt, gcls))
    return out


def assert_same(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=what)
        assert np.asarray(got).dtype == want.dtype, what
    else:
        assert got == want, (what, got, want)


def det_fields(d) -> dict:
    return {f: getattr(d, f) for f in ("precision", "recall", "map50", "map", "ap_class", "ap50_per_class",
                                       "ap_per_class_", "p_per_class", "r_per_class", "nt_per_class", "curves")}


@pytest.mark.parametrize("case", list(CASES))
def test_box_iou_and_matching_equal_jax(case):
    for pb, conf, pc, gt, gc in det_case(*CASES[case]):
        iou = tm.box_iou(gt, pb)
        assert_same(iou, jm.box_iou(gt, pb), "box_iou")
        assert_same(tm.match_predictions(pc, gc, iou), jm.match_predictions(pc, gc, iou), "match")


@pytest.mark.parametrize("case", list(CASES))
def test_accumulator_ap_per_class_and_confusion_equal_jax(case):
    """MetricAccumulator.compute (so ap_per_class, compute_ap and smooth)
    and ConfusionMatrix over the same images: every field, bit for bit."""
    nc = CASES[case][2]
    ta, ja = tm.MetricAccumulator(), jm.MetricAccumulator()
    tc, jc = tm.ConfusionMatrix(nc), jm.ConfusionMatrix(nc)
    for pb, conf, pc, gt, gc in det_case(*CASES[case]):
        ta.update(pb, conf, pc, gt, gc)
        ja.update(pb, conf, pc, gt, gc)
        tc.process_batch(pb, conf, pc, gt, gc)
        jc.process_batch(pb, conf, pc, gt, gc)
    got, want = ta.compute(), ja.compute()
    assert_same(det_fields(got), det_fields(want), case)
    assert got.fitness == want.fitness and got.results_dict() == want.results_dict()
    assert_same(tc.matrix, jc.matrix, "confusion")
    if case not in ("no_predictions", "no_ground_truth"):
        assert want.map50 > 0 and jc.matrix.sum() > 0  # the case exercises the matching


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_ap_and_smooth_equal_jax(seed):
    rng = np.random.default_rng(seed)
    recall = np.sort(rng.random(int(rng.integers(1, 40))))
    precision = rng.random(len(recall))
    got, want = tm.compute_ap(recall, precision, True), jm.compute_ap(recall, precision, True)
    assert got[0] == want[0]
    assert_same(got[1], want[1]), assert_same(got[2], want[2])
    y = rng.random(int(rng.integers(5, 200)))
    assert_same(tm.smooth(y, 0.1), jm.smooth(y, 0.1))


@pytest.mark.parametrize("nc,multi_label,conf,seed", [(1, False, 0.001, 0), (3, False, 0.25, 1),
                                                      (3, True, 0.05, 2), (2, False, 0.99, 3)])
def test_nms_numpy_equals_jax(nc, multi_label, conf, seed):
    """Decoded (A, 4+nc) predictions with clustered boxes (so suppression
    has work) and some equal scores; the last case keeps no candidate."""
    rng = np.random.default_rng(seed)
    a = 300
    centres = rng.uniform(50, 550, (12, 2))[rng.integers(0, 12, a)] + rng.normal(0, 6, (a, 2))
    wh = rng.uniform(20, 90, (a, 2))
    probs = rng.random((a, nc))
    probs[::7] = np.round(probs[::7], 1)
    pred = np.concatenate([centres, wh, probs], 1).astype(np.float32)
    for max_det in (300, 7):
        got = tnms.nms_numpy(pred, conf_thres=conf, iou_thres=0.6, max_det=max_det, multi_label=multi_label)
        want = jnms.nms_numpy(pred, conf_thres=conf, iou_thres=0.6, max_det=max_det, multi_label=multi_label)
        assert_same(got, want, "nms_numpy")
    if conf < 0.9:
        assert len(want) > 3


def test_loss_items_row_and_results_csv_equal_jax(tmp_path):
    """Rows of loss items and extras through both ResultsCSV writers, then a
    resume's truncation: the two files are byte-identical."""
    rng = np.random.default_rng(0)
    items = rng.random((4, 10))
    files = {}
    for name, csvmod in (("jax", jcsv), ("port", tcsv)):
        d = tmp_path / name
        w = csvmod.ResultsCSV(d)
        for e in range(4):
            w.append({"epoch": float(e + 1), **csvmod.loss_items_to_row("train", items[e]),
                      **csvmod.loss_items_to_row("val", items[e][::-1]), "mtl/w_det": 0.5, "lr": 1e-3 * (e + 1),
                      "alpha_P3": 0.69, "metrics/mAP50(B)": 0.25, "time": 1.5})
        csvmod.ResultsCSV(d).truncate_after_epoch(2)
        files[name] = (d / "results.csv").read_text()
    assert files["port"] == files["jax"]
    rows = list(csv.DictReader(files["port"].splitlines()))
    assert [r["epoch"] for r in rows] == ["1.0", "2.0"]
    assert tcsv.HEADER_ORDER == jcsv.HEADER_ORDER


@pytest.mark.parametrize("exist_ok,resume,existing", [(False, False, 0), (False, False, 1), (False, False, 3),
                                                      (True, False, 2), (False, True, 2)])
def test_run_directories_equal_jax(tmp_path, exist_ok, resume, existing):
    for name, mod in (("jax", jfiles), ("port", tfiles)):
        proj = tmp_path / name
        for i in range(existing):
            (proj / ("t" if i == 0 else f"t{i + 1}")).mkdir(parents=True)
        got = mod.resolve_save_dir(proj, "t", exist_ok=exist_ok, resume=resume)
        want = jfiles.resolve_save_dir(proj, "t", exist_ok=exist_ok, resume=resume)
        assert got == want and got.name == want.name
        assert mod.increment_path(proj / "t", sep="_") == jfiles.increment_path(proj / "t", sep="_")


def test_coco_writer_equals_jax(tmp_path):
    writers = {"jax": jcoco.CocoWriter(tmp_path / "j.json"), "port": tcoco.CocoWriter(tmp_path / "p.json")}
    for i, (pb, conf, pc, _, _) in enumerate(det_case(1, 5, 3, None)):
        dets = np.concatenate([pb, conf[:, None], pc[:, None]], 1)
        cmap = {0: 1, 1: 2, 2: 3} if i % 2 else None
        for w in writers.values():
            w.add(dets, i if i % 2 else f"im{i}", cmap)
    assert json.loads(writers["port"].save().read_text()) == json.loads(writers["jax"].save().read_text())
    assert writers["port"].path.read_text() == writers["jax"].path.read_text()


def test_gather_is_a_noop_without_a_process_group():
    acc = tm.MetricAccumulator()
    for pb, conf, pc, gt, gc in det_case(0, 3, 1, None):
        acc.update(pb, conf, pc, gt, gc)
    before = [list(x) for x in (acc.tp, acc.conf)]
    acc.gather_across_hosts()
    assert [list(x) for x in (acc.tp, acc.conf)] == before


def test_gather_across_two_gloo_processes_equals_one_process(tmp_path):
    """Two ranks each accumulate half the images (rank 0 the first half),
    gather over gloo and compute: both give the DetMetrics of one process
    over all the images."""
    import torch.multiprocessing as mp

    from tests._torch_dist_worker import metrics_rank

    images = det_case(1, 8, 3, None)
    mp.spawn(metrics_rank, args=(2, str(tmp_path), images), nprocs=2, join=True)
    acc = tm.MetricAccumulator()
    for pb, conf, pc, gt, gc in images:
        acc.update(pb, conf, pc, gt, gc)
    want = det_fields(acc.compute())
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz", allow_pickle=True)["fields"].item()
        assert_same(got, want, f"rank {rank}")
