"""The port's Validator against the JAX package's, exactly.

A synthetic val set (8 grey 64 px PNGs, written by the port) goes through
the JAX ``MGADataset`` / ``DataLoader`` and the port's, which give the same
batches. The port's ``make_eval_step`` runs on weights carried from a seeded
JAX model (``utils/jax_weights.py``); its outputs, as numpy, also feed the
JAX ``Validator`` through a stub ``eval_fn`` (the JAX Validator is numpy
after ``eval_fn``, so nothing is compiled). Both validators must give the
same ``results_dict()``, confusion matrix, ``n_images``, loss items, COCO
JSON and artifact arrays, on a plain loader and on a rect loader whose last
batch wraps round (batch 3 over 8 images: the ``index`` deduplication).
A second eval function puts detections near the ground truth, so the
matching has true positives to count.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from tests._torch_port import few_torch_threads, model_pair  # noqa: F401  (a module fixture)

CBAM = "configs/models/yolov8_cbam.yaml"
IMGSZ = 64
pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from mga_yolo_tpu_torch.data.synthetic import write_synthetic_dataset
    from mga_yolo_tpu_torch.losses import DetLossConfig, SegLossConfig
    from mga_yolo_tpu_torch.train import state as TS

    root = tmp_path_factory.mktemp("valset")
    data_yaml = write_synthetic_dataset(root, n=8, size=IMGSZ, max_boxes=4, seed=3)
    pair = model_pair(CBAM, IMGSZ)
    state = TS.create_train_state(pair["tmodel"])
    eval_step = TS.make_eval_step(pair["tmodel"], (8, 16, 32), 1, DetLossConfig(), SegLossConfig())
    return {"data": str(data_yaml), "state": state, "eval_step": eval_step, "root": root}


def loaders(data: str, batch: int, rect: bool):
    from mga_yolo_tpu.config import load_config as jload
    from mga_yolo_tpu.data.dataset import MGADataset as JDataset
    from mga_yolo_tpu.data.loader import DataLoader as JLoader
    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.data.dataset import MGADataset
    from mga_yolo_tpu_torch.data.loader import DataLoader

    kw = {"data": data, "imgsz": IMGSZ, "max_boxes": 4, "rect": rect}
    jcfg, tcfg = jload(kw), load_config(kw)
    jl = JLoader(JDataset(jcfg, "val", augment=False), batch_size=batch, shuffle=False, drop_last=False, workers=1)
    tl = DataLoader(MGADataset(tcfg, "val", augment=False), batch_size=batch, shuffle=False, drop_last=False,
                    workers=1, device="cpu")
    return jl, jcfg, tl, tcfg


def as_numpy(out: dict) -> dict:
    """The port eval step's outputs as the JAX package's arrays (maps NHWC)."""
    nhwc = lambda t: np.transpose(t.numpy(), (0, 2, 3, 1))  # noqa: E731
    return {"decoded": out["decoded"].numpy(), "items": out["items"].numpy(), "dets": out["dets"].numpy(),
            "seg": {k: nhwc(v) for k, v in out["seg"].items()}}


def near_gt_eval(batch: dict) -> dict:
    """Detections made from the batch's ground truth: jittered copies (one in
    five moved far off) plus random boxes, scored from a seed, in the eval
    step's (B, 300, 6) form; zero loss items."""
    gt = np.asarray(batch["gt_boxes"])
    mask_gt = np.asarray(batch["mask_gt"])
    b = gt.shape[0]
    rng = np.random.default_rng(int(np.asarray(batch["image"]).sum()) % 2**32)
    dets = np.zeros((b, 300, 6), np.float32)
    dets[..., 5] = -1
    for i in range(b):
        g = gt[i, mask_gt[i] > 0]
        jit = g + rng.normal(0, 0.04, g.shape) * np.tile(g[:, 2:] - g[:, :2], 2)
        jit[rng.random(len(g)) < 0.2] += 30
        xy = rng.uniform(0, 48, (5, 2))
        boxes = np.concatenate([jit, np.concatenate([xy, xy + rng.uniform(4, 16, (5, 2))], 1)])
        conf = np.round(rng.uniform(0.05, 1.0, len(boxes)), 2)
        order = np.argsort(-conf, kind="stable")
        n = len(boxes)
        dets[i, :n, :4], dets[i, :n, 4], dets[i, :n, 5] = boxes[order], conf[order], 0
    return {"decoded": np.zeros((b, 84, 5), np.float32), "items": np.zeros(10, np.float32), "dets": dets,
            "seg": {}}


@pytest.mark.parametrize("kind", ["eval_step", "near_gt"])
@pytest.mark.parametrize("batch,rect", [(4, False), (3, True)], ids=["batch4", "batch3_padded_tail"])
def test_validator_equals_jax(setup, tmp_path, kind, batch, rect):
    from mga_yolo_tpu.train.validator import Validator as JValidator
    from mga_yolo_tpu_torch.train.validator import Validator

    jl, jcfg, tl, tcfg = loaders(setup["data"], batch, rect)
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) == (3 if batch == 3 else 2)
    for a, b in zip(jb, tb):  # the same batches, padded rows included
        for k in ("image", "gt_boxes", "gt_labels", "mask_gt", "index"):
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
    if rect:
        assert list(np.asarray(tb[-1]["index"])) == [6, 7, 6]

    step, st = setup["eval_step"], setup["state"]
    if kind == "eval_step":
        def port_eval(state, b):
            return step(st, b)

        def jax_eval(state, b):
            return as_numpy(step(st, b))
    else:
        def port_eval(state, b):
            out = near_gt_eval(b)
            return {"decoded": torch.from_numpy(out["decoded"]), "items": torch.from_numpy(out["items"]),
                    "dets": torch.from_numpy(out["dets"]), "seg": {}}

        def jax_eval(state, b):
            return near_gt_eval(b)

    got = Validator(port_eval, tl, tcfg)(None, save_json=tmp_path / "port.json")
    want = JValidator(jax_eval, jl, jcfg)(None, save_json=tmp_path / "jax.json")
    assert got.results_dict() == want.results_dict()
    np.testing.assert_array_equal(got.confusion.matrix, want.confusion.matrix)
    assert got.n_images == want.n_images == 8
    np.testing.assert_array_equal(got.loss_items, want.loss_items)
    assert got.loss_items.dtype == want.loss_items.dtype
    assert got.class_table() == want.class_table()
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads((tmp_path / "jax.json").read_text())
    assert set(got.speed) == set(want.speed) == {"preprocess", "inference", "loss", "postprocess"}
    if kind == "near_gt":
        assert want.metrics.map50 > 0.3 and want.confusion.matrix[0, 0] > 0
    else:
        assert np.isfinite(want.loss_items).all() and want.loss_items[:3].sum() > 0


def test_eval_step_loads_the_ema_once_per_pass(setup):
    """The validator loads the EMA into the eval twin once (``load``), then
    runs every batch (``run``); the result equals calling the step itself."""
    from mga_yolo_tpu_torch.train.validator import Validator

    step, st = setup["eval_step"], setup["state"]
    calls = {"load": 0, "run": 0}

    def counting(state, b):
        return step(state, b)

    def load(state):
        calls["load"] += 1
        step.load(state)

    def run(state, b):
        calls["run"] += 1
        return step.run(state, b)

    counting.load, counting.run = load, run
    _, _, tl, tcfg = loaders(setup["data"], 3, False)
    got = Validator(counting, tl, tcfg)(st)
    want = Validator(lambda s, b: step(s, b), tl, tcfg)(st)
    assert calls == {"load": 1, "run": 3}
    assert got.results_dict() == want.results_dict()
    np.testing.assert_array_equal(got.loss_items, want.loss_items)


def test_artifacts_and_plot_arrays(setup, tmp_path):
    """``save_artifacts_dir``: the mask logits as the JAX package's NHWC
    ``.npy`` (equal to its own artifacts from the same outputs) and PNGs of
    the detections and mask probabilities; ``plots_dir``: the confusion
    matrix and the curves as arrays."""
    from mga_yolo_tpu.train.validator import Validator as JValidator
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.train.validator import Validator

    jl, jcfg, tl, tcfg = loaders(setup["data"], 4, False)
    step, st = setup["eval_step"], setup["state"]
    res = Validator(step, tl, tcfg)(st, save_artifacts_dir=tmp_path / "port", max_artifacts=1,
                                    plots_dir=tmp_path / "plots")
    JValidator(lambda s, b: as_numpy(step(st, b)), jl, jcfg)(None, save_artifacts_dir=tmp_path / "jax",
                                                            max_artifacts=1)
    for sk in ("p3", "p4", "p5"):
        np.testing.assert_array_equal(np.load(tmp_path / "port/preds" / f"batch0_{sk}.npy"),
                                      np.load(tmp_path / "jax/preds" / f"batch0_{sk}.npy"))
        png = image_io.imread_gray(tmp_path / "port/preds" / f"batch0_img0_{sk}.png")
        assert png.shape == (IMGSZ // {"p3": 8, "p4": 16, "p5": 32}[sk],) * 2
    assert image_io.imread(tmp_path / "port/preds" / "batch0_img3_dets.png").shape == (IMGSZ, IMGSZ, 3)
    assert not (tmp_path / "port/preds" / "batch1_img0_p3.png").exists()
    np.testing.assert_array_equal(np.load(tmp_path / "plots" / "confusion_matrix.npy"), res.confusion.matrix)


def test_draw_boxes_outlines_each_box():
    from mga_yolo_tpu_torch.train.validator import draw_boxes

    img = np.zeros((20, 30, 3), np.uint8)
    out = draw_boxes(img, np.array([[2.7, 3.2, 10.9, 8.0, 0.9, 0], [25, 15, 40, 30, 0.5, 0]], np.float32))
    green = (out == (0, 255, 0)).all(-1)
    assert green[3, 2:11].all() and green[8, 2:11].all() and green[3:9, 2].all() and green[3:9, 10].all()
    assert not green[4:8, 3:10].any()  # the inside stays as it was
    assert green[15, 25:30].all() and green[15:20, 29].all()  # clipped to the image
    assert not img.any()


def test_model_taps_are_the_layer_outputs(setup):
    """``tap_indices`` returns those layers' outputs as ``taps``, and the
    eval step passes them on."""
    from mga_yolo_tpu_torch.graph import parse_graph
    from mga_yolo_tpu_torch.models.yolo import MGAModel

    base = setup["state"].model
    tapped = MGAModel(parse_graph(CBAM, scale="n", nc=1), tap_indices=(23, 25, 27)).eval()
    tapped.load_state_dict(base.state_dict(), strict=True)
    x = torch.rand(1, 3, IMGSZ, IMGSZ)
    seen = {}
    hooks = [base.model[i].register_forward_hook(lambda m, a, o, i=i: seen.__setitem__(i, o)) for i in (23, 25, 27)]
    with torch.no_grad():
        want = base.eval()(x)
        got = tapped(x)
    for h in hooks:
        h.remove()
    assert "taps" not in want and set(got["taps"]) == {23, 25, 27}
    for i in (23, 25, 27):
        torch.testing.assert_close(got["taps"][i], seen[i], rtol=0, atol=0)
    torch.testing.assert_close(got["det"][0], want["det"][0], rtol=0, atol=0)
