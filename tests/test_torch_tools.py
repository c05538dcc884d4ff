"""The port's baseline toolchain (``mga_yolo_tpu_torch/tools``) against the
JAX package's ``tools/cli``.

* ``tools.val``: the same seeded plain-YOLOv8n weights (BN statistics
  perturbed, a zero class bias so every anchor is a candidate, box sides
  near one stride; the dataset's labels are a few of the model's own
  detections, so the metrics are not all zero), saved by
  the JAX package's ``save_checkpoint`` and carried into a port checkpoint
  by ``utils/jax_weights.py``; both tools' ``main()`` run in this process at
  64 px on tests/synth.py's dataset with ``--save-fm``. ``metrics.json`` is
  equal (rel 1e-5), the tapped layer 15/18/21 maps agree (rtol 1e-4, atol
  1e-5), the files under ``fm/`` and ``preds/`` are the same, and each
  overlay is the bytes of ``cv2.imencode(".jpg")`` of ``cv2.rectangle``
  drawn on the same letterboxed image (cv2 in the test only). Without matplotlib the
  maps are saved with no PNG and a message says why.
* ``tools.train``: the config it hands the trainer has the plain graph,
  ``task: detect`` and the segmentation loss off, as the JAX tool's; and a
  one-epoch run on the CPU whose ``best.pt`` ``tools.val`` validates.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

from tests._torch_port import few_torch_threads, perturb_bn  # noqa: F401  (a module fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")
BASE = "configs/models/yolov8.yaml"
IMGSZ = 64
LAYERS = (15, 18, 21)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """(data YAML, the JAX checkpoint directory, the port's .pt) of the same weights."""
    import jax

    from mga_yolo_tpu.models.yolo import create_model as jcreate
    from mga_yolo_tpu.train.optim import flatten_tree
    from mga_yolo_tpu.train.state import create_train_state
    from mga_yolo_tpu.utils.checkpoint import save_checkpoint
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax
    from tests.synth import create_synthetic_dataset

    root = tmp_path_factory.mktemp("base")
    data = create_synthetic_dataset(root / "ds", n=6, size=IMGSZ)
    jmodel, _ = jcreate(BASE, scale="n", nc=1)
    state = create_train_state(jmodel, jax.random.PRNGKey(0), imgsz=IMGSZ)
    v = perturb_bn({"params": state.params, "batch_stats": state.batch_stats}, seed=1)
    detect = next(k for k in v["params"] if k.endswith("_Detect"))
    for k, p in v["params"][detect].items():
        if k.startswith("cv3_") and k.endswith("_2"):
            p["bias"] = np.zeros_like(p["bias"])
        if k.startswith("cv2_") and k.endswith("_2"):  # box sides near one stride: boxes inside the image
            p["kernel"] = np.asarray(p["kernel"]) * 0.05
            p["bias"] = np.tile(8.0 * np.eye(16, dtype=np.float32)[1], 4)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"], ema_params=flatten_tree(v["params"]),
                          ema_batch_stats=flatten_tree(v["batch_stats"]))
    meta = {"model_yaml": BASE, "model_scale": "n", "nc": 1, "imgsz": IMGSZ, "optimizer": "sgd"}
    save_checkpoint(root / "jax_best", state, meta)
    _, tspec = create_model(BASE, scale="n", nc=1, device="cpu")
    torch.save({"model_state_dict": state_dict_from_jax(v, tspec), "meta": meta,
                "train_args": {"nc": 1, "model": BASE, "model_scale": "n"}}, root / "best.pt")
    relabel_from_detections(root / "best.pt", root / "ds")
    return {"data": str(data), "jax": root / "jax_best", "port": root / "best.pt", "root": root}


def relabel_from_detections(weights, ds):
    """Each image's labels become the first three of the model's own
    detections (conf 0.25, clipped to the image), so that the random
    weights have true positives and the metrics something to count."""
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.ops.nms import nms_numpy
    from mga_yolo_tpu_torch.train.state import normalize_images
    from mga_yolo_tpu_torch.utils.checkpoint import rebuild_from_checkpoint

    model, _ = rebuild_from_checkpoint(weights, device="cpu")
    for path in sorted((ds / "images" / "train").glob("*.png")):
        with torch.no_grad():  # 64 px images: the letterbox is the identity
            decoded = model(normalize_images(torch.from_numpy(image_io.imread(path)[None])))["det"][0][0].numpy()
        boxes = np.clip(nms_numpy(decoded, 0.25, 0.7)[:3, :4], 0, IMGSZ) / IMGSZ
        assert len(boxes)
        (ds / "labels" / "train" / f"{path.stem}.txt").write_text("".join(
            f"0 {(x1 + x2) / 2:.6f} {(y1 + y2) / 2:.6f} {x2 - x1:.6f} {y2 - y1:.6f}\n" for x1, y1, x2, y2 in boxes))


@pytest.fixture(scope="module")
def vals(ckpts):
    from mga_yolo_tpu_torch.tools import val as port_val
    from tools.cli import val as jax_val

    argv = ["--data", ckpts["data"], "--batch", "4", "--save-fm", "--save-layers", "15,18,21"]
    root = ckpts["root"]
    jax_val.main(["--weights", str(ckpts["jax"]), *argv, "--out", str(root / "jax_val")])
    out = port_val.main(["--weights", str(ckpts["port"]), *argv, "--out", str(root / "port_val"), "--device", "cpu"])
    assert out == root / "port_val"
    return {"jax": root / "jax_val", "port": out}


def test_base_val_metrics_equal_jax(vals):
    got = json.loads((vals["port"] / "metrics.json").read_text())
    want = json.loads((vals["jax"] / "metrics.json").read_text())
    assert set(got) == set(want) and want["metrics/mAP50(B)"] > 0 and want["metrics/recall(B)"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)


def test_base_val_taps_and_files_equal_jax(vals):
    def names(d, sub):
        return sorted(p.name for p in (d / sub).iterdir())

    for sub in ("fm", "preds"):
        assert names(vals["port"], sub) == names(vals["jax"], sub)
    # 6 images in batches of 4: two batches captured, 4 + 2 overlays
    assert names(vals["port"], "fm") == sorted(f"batch{b}_layer{i}.{x}" for b in (0, 1) for i in LAYERS
                                               for x in ("npy", "png"))
    assert len(names(vals["port"], "preds")) == 6
    for b in (0, 1):
        for i, rows in zip(LAYERS, (8, 4, 2)):
            got = np.load(vals["port"] / "fm" / f"batch{b}_layer{i}.npy")
            want = np.load(vals["jax"] / "fm" / f"batch{b}_layer{i}.npy")
            assert got.shape == want.shape and got.shape[1:3] == (rows, rows)  # NHWC
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"batch{b} layer{i}")


def test_base_val_overlays_equal_cv2_rectangle(ckpts, vals):
    """Each overlay is the JPEG ``cv2.imencode`` makes of the letterboxed
    image with ``cv2.rectangle(..., 1)`` of the detections at conf 0.25 (at
    most 50), to the byte, and it has boxes to draw."""
    import cv2

    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.data.dataset import MGADataset
    from mga_yolo_tpu_torch.data.loader import DataLoader
    from mga_yolo_tpu_torch.ops.nms import nms_numpy
    from mga_yolo_tpu_torch.train.state import normalize_images
    from mga_yolo_tpu_torch.utils.checkpoint import rebuild_from_checkpoint

    model, _ = rebuild_from_checkpoint(ckpts["port"], device="cpu")
    ds = MGADataset(load_config({"data": ckpts["data"], "imgsz": IMGSZ}), "val", augment=False)
    n_boxes = 0
    for b, batch in enumerate(DataLoader(ds, 4, shuffle=False, drop_last=False, device="cpu")):
        with torch.no_grad():
            decoded = model(normalize_images(torch.from_numpy(np.asarray(batch["image"]))))["det"][0].numpy()
        for i in range(len(decoded)):
            dets = nms_numpy(decoded[i], 0.25, 0.7, max_det=50)
            want = np.ascontiguousarray(batch["image"][i]).copy()
            for x1, y1, x2, y2, _, _ in dets:
                cv2.rectangle(want, (int(x1), int(y1)), (int(x2), int(y2)), (0, 255, 0), 1)
            got = (vals["port"] / "preds" / f"batch{b}_img{i}_dets.jpg").read_bytes()
            assert got == cv2.imencode(".jpg", want)[1].tobytes(), f"batch{b} img{i}"
            n_boxes += len(dets)
    assert n_boxes > 0


def test_base_val_without_matplotlib_saves_the_maps_alone(ckpts, tmp_path, monkeypatch, capsys):
    from mga_yolo_tpu_torch.tools import val as port_val
    from mga_yolo_tpu_torch.train.validator import FM_WAIT

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = port_val.main(["--weights", str(ckpts["port"]), "--data", ckpts["data"], "--batch", "4", "--save-fm",
                         "--save-fm-max", "1", "--out", str(tmp_path / "v"), "--device", "cpu"])
    assert sorted(p.name for p in (out / "fm").iterdir()) == [f"batch0_layer{i}.npy" for i in LAYERS]
    assert len(list((out / "preds").glob("*_dets.jpg"))) == 4 and (out / "metrics.json").is_file()
    assert FM_WAIT in capsys.readouterr().out


def test_base_val_env_defaults_and_device(monkeypatch):
    from mga_yolo_tpu_torch.tools import val as port_val

    monkeypatch.setenv("BASE_FM_LAYERS", "4,6")
    monkeypatch.setenv("BASE_FM_MAX", "2")
    args = port_val.parse_args(["--weights", "w.pt", "--data", "d.yaml"])
    assert (args.save_layers, args.save_fm_max, args.device, args.conf, args.iou) == ("4,6", 2, None, 0.001, 0.7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_val.main(["--weights", "w.pt", "--data", "d.yaml"])


def test_base_train_config_equals_the_jax_tools(monkeypatch):
    """The config each tool hands its trainer: the plain graph, ``task:
    detect`` and the segmentation loss off, even when asked for it; a model
    given on the command line is kept."""
    from mga_yolo_tpu import config as jconfig
    from mga_yolo_tpu.train import trainer as jtrainer
    from mga_yolo_tpu_torch.train import trainer as ttrainer
    from mga_yolo_tpu_torch.tools import train as port_train
    from tools.cli import train as jax_train

    seen = {}
    monkeypatch.setattr(jtrainer, "train", lambda cfg, **kw: seen.__setitem__("jax", jconfig.load_config(cfg, **kw)))
    monkeypatch.setattr(ttrainer, "train", lambda cfg: seen.__setitem__("port", cfg))
    for extra, model in (([], BASE), (["--model", "configs/models/yolov8_cbam.yaml"], "configs/models/yolov8_cbam.yaml")):
        argv = ["--cfg", "configs/hyperparams/base_defaults.yaml", "--imgsz", "64", "--enabled", "true",
                "--device", "cpu", *extra]
        jax_train.main(argv)
        port_train.main(argv)
        j, t = seen["jax"], seen["port"]
        assert (t.train.model, t.train.task, t.seg.enabled) == (j.train.model, j.train.task, j.seg.enabled) == (
            model, "detect", False)
        assert (t.data.imgsz, t.train.device, t.train.epochs) == (j.data.imgsz, j.train.device, j.train.epochs)


def test_base_train_then_val_on_the_cpu(tmp_path, monkeypatch):
    """``tools.train`` for one validated epoch at 64 px on the CPU (4 + 2
    images), then ``tools.val --save-fm`` on its ``best.pt``: the plain
    graph's taps at 8 / 4 / 2 rows, and the val loss has no segmentation."""
    import csv

    from mga_yolo_tpu_torch.data.synthetic import write_synthetic_dataset
    from mga_yolo_tpu_torch.tools import train as port_train
    from mga_yolo_tpu_torch.tools import val as port_val

    data = write_synthetic_dataset(tmp_path / "ds", n=4, size=IMGSZ, max_boxes=4, seed=1, n_val=2)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # the run's plots as arrays: not what is tested here
    res = port_train.main(["--data", str(data), "--imgsz", str(IMGSZ), "--batch", "2", "--epochs", "1",
                           "--max_boxes", "4", "--workers", "1", "--device", "cpu", "--project",
                           str(tmp_path / "runs"), "--name", "b"])
    run = tmp_path / "runs" / "b"
    with open(run / "results.csv", newline="") as f:
        (row,) = list(csv.DictReader(f))
    assert float(row["train/seg/total"]) == 0.0 and float(row["train/det/total"]) > 0
    assert res.n_images == 2
    out = port_val.main(["--weights", str(run / "weights" / "best.pt"), "--data", str(data), "--save-fm",
                         "--out", str(tmp_path / "v"), "--device", "cpu"])
    for i, rows in zip(LAYERS, (8, 4, 2)):
        assert np.load(out / "fm" / f"batch0_layer{i}.npy").shape[:3] == (2, rows, rows)
    assert set(json.loads((out / "metrics.json").read_text())) == set(res.results_dict())
