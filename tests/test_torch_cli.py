"""The port's training run end to end on the CPU, and what reads its files.

``cli.train`` trains the flagship for 2 epochs on 8 synthetic 64 px images
(batch 4, ``--device cpu``), as ``tests/test_train_e2e.py`` does for the JAX
package: the run directory, results.csv, profiling.yaml and checkpoints;
``rebuild_from_checkpoint`` gives the trainer's EMA; ``cli.val`` on
``best.pt`` gives the trainer's final evaluation; ``build_server`` serves
``best.pt`` as it is (and a scale-s checkpoint with no ``scale``); the
``MGA`` facade; a device the port does not run on is refused before a run
directory exists; the checkpoint keeps every part of the train state.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

from tests._torch_port import few_torch_threads  # noqa: F401  (the module fixture below)

IMGSZ = 64
pytestmark = pytest.mark.usefixtures("few_torch_threads")
CBAM = "configs/models/yolov8_cbam.yaml"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from mga_yolo_tpu_torch.cli import train as cli_train
    from mga_yolo_tpu_torch.data.synthetic import write_synthetic_dataset
    from mga_yolo_tpu_torch.train import trainer as T

    root = tmp_path_factory.mktemp("e2e")
    data = str(write_synthetic_dataset(root / "ds", n=8, size=IMGSZ, max_boxes=4, seed=2, n_val=4))
    held = {}
    train = T.MGATrainer.train

    def keep(self):
        held["trainer"] = self
        return train(self)

    T.MGATrainer.train = keep
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "matplotlib", None)  # the run as on the card's host: the plots' arrays, no PNG
    try:
        result = cli_train.main(["--cfg", "configs/hyperparams/cbam_defaults.yaml", "--data", data,
                                 "--imgsz", str(IMGSZ), "--batch", "4", "--epochs", "2", "--max_boxes", "4",
                                 "--workers", "2", "--device", "cpu", "--project", str(root / "runs"),
                                 "--name=t", "--MGA_SAVE_FM", "true", "--save_fm_max", "1"])
    finally:
        T.MGATrainer.train = train
        mp.undo()
    tr = held["trainer"]
    return {"root": root, "data": data, "trainer": tr, "result": result, "dir": tr.save_dir}


def test_run_directory_results_and_profiling(run):
    import csv

    from mga_yolo_tpu.utils.csvlog import HEADER_ORDER
    from mga_yolo_tpu_torch.utils import yaml_lite

    d = run["dir"]
    assert d == run["root"] / "runs" / "t"
    with open(d / "results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["1.0", "2.0"]
    assert list(rows[0])[:len(HEADER_ORDER)] == HEADER_ORDER
    for r in rows:
        vals = {k: float(v) for k, v in r.items()}
        assert all(np.isfinite(v) for v in vals.values())
        assert vals["train/det/total"] > 0 and vals["val/seg/total"] > 0  # validation ran
        assert {"metrics/mAP50(B)", "fitness", "alpha_P3", "lr", "time"} <= set(vals)
    prof = yaml_lite.load(d / "profiling.yaml")
    assert prof["parameters"] == run["trainer"].n_params() and prof["scale"] == "n"
    assert 0 < prof[f"gflops_at_{IMGSZ}"] < prof["gflops_at_640"] < 20
    for name in ("best", "last"):
        assert (d / "weights" / f"{name}.pt").is_file()
        meta = json.loads((d / "weights" / f"{name}.meta.json").read_text())
        assert {"epoch", "best_fitness", "fitness", "model_yaml", "model_yaml_text", "model_scale", "optimizer",
                "nc", "imgsz", "date"} == set(meta)
    assert json.loads((d / "weights" / "last.meta.json").read_text())["epoch"] == 1
    assert np.load(d / "confusion_matrix.npy").shape == (2, 2)
    assert run["result"].n_images == 4 and np.isfinite(run["result"].loss_items).all()
    assert [s["epoch"] for s in run["trainer"].epoch_stats] == [0, 1]
    for e in (1, 2):  # MGA_SAVE_FM: the capture epochs' artifacts, the tapped attention outputs among them
        art = d / "feature_maps" / f"epoch_{e}"
        assert (art / "preds" / "batch0_p3.npy").is_file() and (art / "preds" / "batch0_img0_dets.jpg").is_file()
        assert {p.name for p in (art / "fm").iterdir()} == {f"batch0_layer{i}.npy" for i in (23, 25, 27)}
    assert not list(d.rglob("*_curve.png")) and not list(d.rglob("confusion_matrix*.png"))


def test_rebuild_from_checkpoint_gives_the_trainers_ema(run):
    from mga_yolo_tpu_torch.utils.checkpoint import ema_state_dict, rebuild_from_checkpoint

    model, meta = rebuild_from_checkpoint(run["dir"] / "weights" / "last.pt", device="cpu")
    assert meta["epoch"] == 1 and not model.training
    want = ema_state_dict(run["trainer"].state)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    plain, _ = rebuild_from_checkpoint(run["dir"] / "weights" / "last.pt", prefer_ema=False, device="cpu")
    masters = run["trainer"].state.model.state_dict()
    for k, v in plain.state_dict().items():
        torch.testing.assert_close(v, masters[k], rtol=0, atol=0, msg=k)


def test_cli_val_on_best_equals_the_trainers_final_evaluation(run, tmp_path, monkeypatch):
    """On the CPU the val CLI (float32, zero loss) and the trainer's final
    evaluation of the same EMA run the same float32 operations. Without
    matplotlib (as on the card's host) ``--plots`` saves the arrays."""
    from mga_yolo_tpu_torch.cli import val as cli_val

    monkeypatch.setitem(sys.modules, "matplotlib", None)

    res = cli_val.main(["--weights", str(run["dir"] / "weights" / "best.pt"), "--data", run["data"],
                        "--batch", "4", "--device", "cpu", "--out", str(tmp_path / "v"), "--plots", "--save-json"])
    assert res.results_dict() == run["result"].results_dict()
    np.testing.assert_array_equal(res.confusion.matrix, run["result"].confusion.matrix)
    assert res.n_images == 4 and not res.loss_items.any()
    saved = json.loads((tmp_path / "v" / "metrics.json").read_text())
    assert set(saved) == {*res.results_dict(), "speed"}
    assert isinstance(json.loads((tmp_path / "v" / "predictions.json").read_text()), list)
    assert (tmp_path / "v" / "confusion_matrix.npy").is_file() and not list((tmp_path / "v").glob("*.png"))
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # the card's host: a .tflite needs TensorFlow
    with pytest.raises(ImportError, match="mga-val --weights m.tflite needs tensorflow"):
        cli_val.main(["--weights", str(tmp_path / "m.tflite"), "--data", run["data"], "--device", "cpu"])


def test_build_server_serves_the_trainers_best_pt(run):
    from mga_yolo_tpu_torch.serve import build_server

    server = build_server(run["dir"] / "weights" / "best.pt", imgsz=IMGSZ, batch=2, conf=0.001, port=0,
                          device="cpu")
    try:
        img = np.random.default_rng(1).integers(0, 255, (80, 60, 3)).astype(np.uint8)
        pred = server.batcher.submit(img)
        b = pred.boxes
        assert np.isfinite(b).all() and len(b) > 0
        assert (b[:, [0, 2]] >= 0).all() and (b[:, [0, 2]] <= 60).all() and (b[:, [1, 3]] <= 80).all()
    finally:
        server.httpd.server_close()
        server.batcher.close()


def test_build_server_reads_the_scale_from_the_checkpoint(tmp_path):
    """A scale-s checkpoint serves with no ``scale`` argument
    (``train_args["model_scale"]``, then ``train_args["scale"]``)."""
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.serve import build_server
    from mga_yolo_tpu_torch.train.state import create_train_state
    from mga_yolo_tpu_torch.utils.checkpoint import save_checkpoint

    torch.manual_seed(0)
    model, _ = create_model(CBAM, scale="s", device="cpu", training=True)
    path = tmp_path / "weights" / "best.pt"
    save_checkpoint(path, create_train_state(model), {"nc": 1, "model_yaml": CBAM, "model_scale": "s"})
    want = [m.conv.weight.shape for m in model.model[:2]]
    ckpt = torch.load(path, weights_only=True)
    legacy = tmp_path / "scale_key.pt"
    torch.save({"ema_state_dict": ckpt["ema_state_dict"], "train_args": {"nc": 1, "model": CBAM, "scale": "s"}},
               legacy)
    for p in (path, legacy):
        server = build_server(p, imgsz=IMGSZ, batch=1, port=0, device="cpu")
        try:
            assert server.batcher.engine.model.spec.scale == "s"
            assert [m.conv.weight.shape for m in server.batcher.engine.model.model[:2]] == want
        finally:
            server.httpd.server_close()
            server.batcher.close()


def test_mga_facade(run, tmp_path):
    from mga_yolo_tpu_torch.api import MGA

    m = MGA(str(run["dir"] / "weights" / "last.pt"))
    assert m.task == "mga" and m.scale == "n" and m.spec.nc == 1
    info = m.info()
    trainable = sum(p.numel() for k, p in run["trainer"].state.params().items() if k != "mtl_log_vars")
    assert info["gradients"] == trainable < info["parameters"] and info["n_layers"] == 29
    assert info["detect_strides"] == [8, 16, 32]
    res = m.val(run["data"], batch=4, device="cpu")
    assert res.n_images == 4
    img = sorted((run["root"] / "ds" / "images" / "val").iterdir())[0]
    (pred,) = m.predict([img], imgsz=IMGSZ, conf=0.001, device="cpu")  # the predictor is ported
    assert pred.path == str(img) and pred.boxes.shape[1] == 6 and set(pred.mga_masks) == {"p3", "p4", "p5"}
    assert MGA("configs/models/yolov8.yaml").task == "detect" and MGA(CBAM).task == "mga"


def test_a_device_the_port_does_not_run_on_is_refused_before_a_run_dir(run, tmp_path, monkeypatch):
    from mga_yolo_tpu_torch.cli import train as cli_train
    from mga_yolo_tpu_torch.cli import val as cli_val
    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.train.trainer import MGATrainer

    base = ["--data", run["data"], "--imgsz", str(IMGSZ), "--epochs", "1", "--project", str(tmp_path)]
    for dev in ("tpu", "tpu:0", "cuda:x"):
        with pytest.raises(ValueError, match=f"device={dev!r} not available"):
            cli_train.main(base + ["--name", "bad", "--device", dev])
    with pytest.raises(ValueError, match="not available"):
        cli_val.main(["--weights", str(run["dir"] / "weights" / "best.pt"), "--data", run["data"],
                      "--device", "tpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MGATrainer(load_config(data=run["data"], device="cuda:0", project=str(tmp_path), name="bad"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):  # no device key: CUDA
        MGATrainer(load_config(data=run["data"], project=str(tmp_path), name="bad"))
    assert not (tmp_path / "bad").exists()


def test_parse_overrides_types_values_as_yaml():
    from mga_yolo_tpu.cli.train import parse_overrides as jparse
    from mga_yolo_tpu_torch.cli.train import parse_overrides

    argv = ["--epochs", "3", "--lr0=0.01", "--amp", "false", "--name", "run1", "--scale_weights", "[1.0, 0.5, 2]",
            "--device", "cpu", "--x", "null", "--MGA_SAVE_LAYERS", "23,25,27", "--y=yes", "--z", "1e-3"]
    assert parse_overrides(argv) == jparse(argv)
    with pytest.raises(SystemExit):
        parse_overrides(["--epochs"])


def test_checkpoint_keeps_every_part_of_the_train_state(tmp_path):
    """Non-trivial slots, EMA, accumulation buffer and counters survive a
    save (in the background, then the state changes) and a load into a fresh
    state, exactly."""
    from mga_yolo_tpu_torch.configs import YOLOV8_ECA
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.train.state import create_train_state
    from mga_yolo_tpu_torch.utils import checkpoint as C

    def state(seed):
        torch.manual_seed(seed)
        model, _ = create_model(YOLOV8_ECA, scale="n", device="cpu", training=True)
        st = create_train_state(model, opt_name="adamw")
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for t in [*st.params().values(), *st.bn_stats().values(), *st.ema_params.values(),
                      *st.ema_bn_stats.values(), *(x for s in st.opt_state.values() for x in s.values())]:
                t.copy_(torch.randn(t.shape, generator=g))
        st.accum_grads = {k: torch.randn(p.shape, generator=g) for k, p in st.params().items()}
        st.step, st.opt_step, st.last_apply = 11, 5, 9
        return st

    def same(got, want, what):
        if isinstance(want, dict):
            assert set(got) == set(want), what
            for k in want:
                same(got[k], want[k], f"{what}.{k}")
        elif isinstance(want, torch.Tensor):
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=what)
        else:
            assert got == want, what

    src = state(1)
    meta = {"nc": 1, "epoch": 4, "model_scale": "n"}
    want = C.payload(src, meta)
    path = tmp_path / "w" / "last.pt"
    C.save_checkpoint(path, src, meta, async_save=True)
    with torch.no_grad():  # the train step changes the state in place right after a save
        for t in src.params().values():
            t.add_(1.0)
    C.wait_for_saves()
    C.meta_path(path).write_text(json.dumps({"epoch": 3}))  # a side copy left stale by a stop
    dst, got_meta = C.load_checkpoint(path, state(2))
    assert got_meta == meta and (dst.step, dst.opt_step, dst.last_apply) == (11, 5, 9)
    same(C.payload(dst, meta), want, "checkpoint")
    assert torch.load(path, weights_only=True)["train_args"] == {"nc": 1, "model": None, "model_scale": "n"}


def test_synthetic_val_split(tmp_path):
    """``n_val`` adds images/val and names it in the data YAML; the training
    images are those of a write without it."""
    from mga_yolo_tpu_torch.data.synthetic import write_synthetic_dataset
    from mga_yolo_tpu_torch.utils import yaml_lite

    a = yaml_lite.load(write_synthetic_dataset(tmp_path / "a", n=3, size=64, seed=4))
    b = yaml_lite.load(write_synthetic_dataset(tmp_path / "b", n=3, size=64, seed=4, n_val=2))
    assert a["val"] == "images/train" and b["val"] == "images/val"
    for split in ("images/train", "labels/train"):
        for f in sorted((tmp_path / "a" / split).iterdir()):
            assert (tmp_path / "b" / split / f.name).read_bytes() == f.read_bytes()
    assert sorted(p.name for p in (tmp_path / "b" / "images" / "val").iterdir()) == ["val0000.png", "val0001.png"]
    assert len(list((tmp_path / "b" / "masks").iterdir())) == 5
