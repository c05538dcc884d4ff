"""PyTorch port, prediction and the remaining entry points, against the JAX
package on the CPU.

The flagship (scale n, nc=1) at 64 px with weights from a numpy seed
(``seeded_variables``: no JAX compile for them), carried to the port by
``utils/jax_weights.py``. Tolerances:

* ``MGAPredictor`` (float32, conf 0.001, fuse off and on) on three PNGs of
  different sizes (the JAX side's fold is its own ``fuse_variables`` under
  ``jax.jit``, which is what ``fuse=True`` calls; run eagerly it takes
  5 s on the CPU): the same number of detections per image, boxes within
  1e-3 px (matched by nearest box: near-equal scores may swap rank), the
  sigmoid masks within 1e-5. The images are no larger than ``imgsz``, so
  the letterbox only pads: the port's resize is held to cv2's within one
  grey level by ``tests/test_torch_data.py``, not here.
* ``draw_rectangle`` equals ``cv2.rectangle(..., thickness=2)`` pixel for
  pixel.
* ``profile_layers``: ``params``, ``inputs``, ``stride`` and ``out_shape``
  of every row equal the JAX package's; the FLOP total equals
  ``trainer.count_gflops`` (both FlopCounterMode, not JAX's XLA count).
* The CLIs (``predict``, ``ckpt``, ``serve``, ``profile``) on the CPU
  (``--device cpu``): their files and replies.
"""

from __future__ import annotations

import json
import sys
import threading
import urllib.request
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from tests._torch_port import assert_dets_match, few_torch_threads, seeded_variables  # noqa: F401

IMGSZ = 64
CBAM = "configs/models/yolov8_cbam.yaml"
SHAPES = ((64, 64, 3), (48, 64, 3), (40, 56, 3))  # (h, w, c), none larger than IMGSZ
pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The JAX model and variables, the port's model with the same weights,
    a checkpoint of them, and PNGs on disk."""
    from mga_yolo_tpu.models.yolo import create_model as jcreate
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax

    root = tmp_path_factory.mktemp("predict")
    jmodel, jspec = jcreate(CBAM, scale="n", nc=1)
    v = seeded_variables(jmodel, IMGSZ, seed=4)
    tmodel, tspec = create_model(CBAM, scale="n", nc=1, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(v, tspec), strict=True)
    ckpt = root / "best.pt"
    torch.save({"ema_state_dict": tmodel.state_dict(), "train_args": {"nc": 1, "model": CBAM, "model_scale": "n"},
                "meta": {"imgsz": IMGSZ, "model_yaml": CBAM, "model_scale": "n", "nc": 1}}, ckpt)
    imgs = root / "imgs"
    (imgs / "sub").mkdir(parents=True)
    paths = []
    for i, shape in enumerate(SHAPES):
        img = cv2.GaussianBlur(np.random.default_rng(10 + i).integers(0, 256, shape).astype(np.uint8), (5, 5), 2)
        paths.append(imgs / f"im{i}.png")
        image_io.imwrite(paths[-1], img)
    big = np.random.default_rng(20).integers(0, 256, (96, 80, 3)).astype(np.uint8)
    image_io.imwrite(imgs / "sub" / "im0.png", big)  # a larger image, and a stem seen twice
    return dict(jmodel=jmodel, v=v, tmodel=tmodel, tspec=tspec, ckpt=ckpt, imgs=imgs, paths=paths, root=root)


@pytest.mark.parametrize("fuse", [False, True])
def test_predictor_equals_jax(pair, fuse):
    from mga_yolo_tpu.train.predictor import MGAPredictor as JPredictor
    from mga_yolo_tpu_torch.train.predictor import MGAPredictor

    from mga_yolo_tpu.utils.model_utils import fuse_variables

    paths = [str(p) for p in pair["paths"]]
    v = jax.jit(fuse_variables)(pair["v"]) if fuse else pair["v"]
    want = JPredictor(pair["jmodel"], v, imgsz=IMGSZ, conf=0.001)(paths)
    got = MGAPredictor(pair["tmodel"], imgsz=IMGSZ, conf=0.001, fuse=fuse)(paths)
    assert [r.path for r in got] == paths and len(got) == len(want)
    for g, w, shape in zip(got, want, SHAPES):
        assert g.orig_shape == w.orig_shape == shape[:2]
        assert len(g) == len(w) > 0
        assert_dets_match(g.boxes, w.boxes, rtol=0, atol=1e-3)
        assert set(g.mga_masks) == set(w.mga_masks) == {"p3", "p4", "p5"}
        for k in w.mga_masks:
            assert g.mga_masks[k].shape == w.mga_masks[k].shape == (IMGSZ // {"p3": 8, "p4": 16, "p5": 32}[k],) * 2
            np.testing.assert_allclose(g.mga_masks[k], w.mga_masks[k], rtol=0, atol=1e-5)


def test_stream_order_facade_and_load_predictor(pair):
    """``stream`` in batches of 2 over 3 images (the last batch short) gives
    the frames in order and the results of one ``__call__``; ``MGA.predict``
    and ``load_predictor`` read the checkpoint's weights and imgsz."""
    from mga_yolo_tpu_torch.api import MGA
    from mga_yolo_tpu_torch.train.predictor import MGAPredictor, load_predictor

    pred = MGAPredictor(pair["tmodel"], imgsz=IMGSZ, conf=0.01)
    paths = [str(p) for p in pair["paths"]]
    want = pred(paths)
    got = list(pred.stream(paths, batch_size=2))
    assert [f.path for f, _ in got] == paths and [f.img.shape for f, _ in got] == list(SHAPES)
    for (_, r), w in zip(got, want):
        np.testing.assert_allclose(r.boxes, w.boxes, rtol=0, atol=1e-4)
    loaded = load_predictor(pair["ckpt"], conf=0.01, device="cpu")
    assert loaded.imgsz == IMGSZ and loaded.device.type == "cpu"
    facade = MGA(str(pair["ckpt"])).predict(paths, conf=0.01, device="cpu")
    for a, b, w in zip(loaded(paths), facade, want):
        np.testing.assert_allclose(a.boxes, w.boxes, rtol=0, atol=1e-4)
        np.testing.assert_allclose(b.boxes, w.boxes, rtol=0, atol=1e-4)
    with pytest.MonkeyPatch.context() as mp, pytest.raises(ImportError, match="needs tensorflow"):
        mp.setitem(sys.modules, "tensorflow", None)  # the card's host: a .tflite needs TensorFlow
        load_predictor(pair["root"] / "model.tflite")


def _clips(root: Path) -> dict:
    """Two short clips written by cv2 (the JAX package's writer): an MJPG
    .avi and an mp4v .mp4, seeded frames no larger than IMGSZ."""
    root.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, fourcc, fps, n in (("clip.avi", "MJPG", 25.0, 5), ("run.mp4", "mp4v", 29.97, 4)):
        vw = cv2.VideoWriter(str(root / name), cv2.VideoWriter_fourcc(*fourcc), fps, (56, 40))
        rng = np.random.default_rng(len(name))
        for _ in range(n):
            vw.write(cv2.GaussianBlur(rng.integers(0, 256, (40, 56, 3)).astype(np.uint8), (5, 5), 2))
        vw.release()
        out[name] = (fps, n)
    return out


def test_sources_kinds_equal_jax_and_video_raises(pair, tmp_path):
    """Images and videos: the JAX package's paths, indices, ``is_video``,
    ``fps``, ``total`` and ``max_frames`` caps, frames within the video
    bounds of ``tests/test_torch_video.py``; webcams and stream URLs (which
    the JAX package opens with cv2) raise NotImplementedError naming why."""
    import shutil

    from mga_yolo_tpu.data import sources as J
    from mga_yolo_tpu_torch.data import sources as P

    imgs = pair["imgs"]
    for src in (imgs, str(imgs / "*.png"), str(imgs / "**" / "*.png"), imgs / "im1.png"):
        assert P.list_files(src) == J.list_files(src), src
    frames = list(P.iter_source([str(imgs), np.zeros((5, 6, 3), np.uint8)]))
    assert [f.path for f in frames] == [str(p) for p in J.list_files(imgs)] + ["<array>"]
    for f, jf in zip(frames, J.iter_source(str(imgs))):
        np.testing.assert_array_equal(f.img, jf.img)
        assert f.stem == jf.stem and f.index == jf.index == 0 and not f.is_video and f.fps == jf.fps == 0.0
    mixed = tmp_path / "mixed"
    shutil.copytree(imgs, mixed)
    _clips(mixed / "vids")
    assert P.list_files(mixed) == J.list_files(mixed)
    for cap in (0, 2):
        got, want = list(P.iter_source(mixed, max_frames=cap)), list(J.iter_source(mixed, max_frames=cap))
        assert [(f.path, f.index, f.is_video, f.fps, f.total) for f in got] == \
            [(f.path, f.index, f.is_video, f.fps, f.total) for f in want]
        for f, jf in zip(got, want):
            d = np.abs(f.img.astype(np.int16) - jf.img)
            assert f.img.shape == jf.img.shape and d.mean() <= 0.75 and d.max() <= 8 if f.is_video else not d.any()
    assert sum(f.is_video for f in got) == 4
    for src in (0, "0", "rtsp://127.0.0.1/stream", "http://127.0.0.1/a.mp4"):
        with pytest.raises(NotImplementedError, match="camera|stream URLs"):
            list(P.iter_source(src))
    with pytest.raises(ValueError, match=r"clip\.mkv: Matroska with Theora video \('V_THEORA'\) is not supported"):
        from tests.video_fixtures.make import mkv_bytes  # FFV1, once refused here, reads now

        (tmp_path / "clip.mkv").write_bytes(mkv_bytes("V_THEORA", 56, 40, [(b"\0" * 8, True, 0)], doctype="matroska"))
        list(P.iter_source(tmp_path / "clip.mkv"))
    sink = P.VideoSink(tmp_path / "out.mp4", 0.0)
    for f in got[:3]:
        sink.write(f.img if f.img.shape == (40, 56, 3) else np.zeros((40, 56, 3), np.uint8))
    sink.close()
    assert sink.frames_written == 3 and sink.fps == 30.0
    assert int(cv2.VideoCapture(str(tmp_path / "out.mp4")).get(cv2.CAP_PROP_FRAME_COUNT)) == 3


def test_cli_predict_over_video_writes_what_the_jax_cli_writes(pair, tmp_path, monkeypatch, capsys):
    """``cli.predict`` over a directory of two images, an .avi and an .mp4
    writes the file names and summary lines of the JAX package's
    ``cli.predict`` (run here with the port's predictor in place of its
    own, so both draw the same boxes), and cv2 reads its videos with the
    JAX outputs' frame counts and fps."""
    import shutil

    import mga_yolo_tpu.train.predictor as jax_predictor
    from mga_yolo_tpu.cli import predict as jax_cli
    from mga_yolo_tpu.utils import compile_cache
    from mga_yolo_tpu_torch.cli import predict as cli_predict
    from mga_yolo_tpu_torch.train.predictor import load_predictor

    src = tmp_path / "src"
    src.mkdir()
    for name in ("im0.png", "im1.png"):
        shutil.copy(pair["imgs"] / name, src / name)
    clips = _clips(src)
    args = ["--weights", str(pair["ckpt"]), "--source", str(src), "--conf", "0.01", "--batch", "3",
            "--save-frame-masks"]
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    res = cli_predict.main(args + ["--out", str(port_out), "--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(jax_predictor, "load_predictor", lambda *a, **k: load_predictor(
        pair["ckpt"], conf=0.01, device="cpu"))
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: None)  # no JAX compile here to cache
    jax_cli.main(args + ["--out", str(jax_out)])
    jax_lines = capsys.readouterr().out.splitlines()
    assert res["images"] == 2 and res["frames"] == sum(n for _, n in clips.values()) == 9
    names = sorted(p.name for p in port_out.iterdir())
    assert names == sorted(p.name for p in jax_out.iterdir())
    assert {"clip_pred.avi", "run_pred.mp4", "clip_f00004_mask_p3.png", "run_f00003_mask_p5.png"} <= set(names)
    assert [ln.replace(str(port_out), "OUT") for ln in port_lines] == \
        [ln.replace(str(jax_out), "OUT") for ln in jax_lines]
    assert port_lines[-3:] == ["clip.avi: 5 frames -> clip_pred.avi", "run.mp4: 4 frames -> run_pred.mp4",
                               f"[mga-predict] 2 images, 9 video frames -> {port_out}"]
    for name in ("clip_pred.avi", "run_pred.mp4"):
        caps = [cv2.VideoCapture(str(d / name)) for d in (port_out, jax_out)]
        for prop in (cv2.CAP_PROP_FRAME_COUNT, cv2.CAP_PROP_FPS, cv2.CAP_PROP_FOURCC, cv2.CAP_PROP_FRAME_WIDTH,
                     cv2.CAP_PROP_FRAME_HEIGHT):
            assert caps[0].get(prop) == caps[1].get(prop), (name, prop)
        assert caps[0].get(cv2.CAP_PROP_FPS) == clips["clip.avi" if name.endswith("avi") else "run.mp4"][0]


def test_rectangle_equals_cv2_and_plot_draws_labels(pair):
    from mga_yolo_tpu_torch.train.predictor import GREEN, Results, draw_rectangle

    rng = np.random.default_rng(0)
    for _ in range(200):
        h, w = rng.integers(8, 40, 2)
        p1, p2 = tuple(int(x) for x in rng.integers(-5, 45, 2)), tuple(int(x) for x in rng.integers(-5, 45, 2))
        want = cv2.rectangle(np.zeros((h, w, 3), np.uint8), p1, p2, GREEN, 2)
        got = draw_rectangle(np.zeros((h, w, 3), np.uint8), p1, p2)
        np.testing.assert_array_equal(got, want, err_msg=f"{(h, w)} {p1} {p2}")
    boxes = np.array([[10.7, 30.2, 50.1, 60.9, 0.8765, 3]], np.float32)
    r = Results(str(pair["paths"][0]), (64, 64), boxes, {})
    img = r.plot()
    rect = draw_rectangle(np.zeros_like(img), (10, 30), (50, 60))
    assert (img[rect.any(-1)] == GREEN).all()
    label = (img == GREEN).all(-1) & ~rect.any(-1)
    assert label[16:27].sum() > 30 and not label[27:].any()  # "3:0.88" above the box, bottom row y1 - 4


def test_cli_predict_writes_its_files(pair, tmp_path, capsys):
    from mga_yolo_tpu_torch.cli import predict as cli_predict
    from mga_yolo_tpu_torch.data import image_io

    out = tmp_path / "pred"
    res = cli_predict.main(["--weights", str(pair["ckpt"]), "--source", str(pair["imgs"]), "--out", str(out),
                            "--conf", "0.01", "--batch", "3", "--save-feature-maps", "--use-pallas", "true",
                            "--device", "cpu"])
    assert res["images"] == 4
    stems = ["im0", "im1", "im2", "im0_2"]  # sub/im0.png comes last (sorted) and gets the next free stem
    want = {f"{s}{suffix}" for s in stems for suffix in ("_pred.jpg", "_mask_p3.png", "_mask_p4.png",
                                                          "_mask_p5.png", "_masks.npz")}
    assert {p.name for p in out.iterdir()} == want
    assert image_io.imread(out / "im0_2_pred.jpg").shape == (96, 80, 3)  # a JPEG, as the JAX package writes
    assert image_io.imread_gray(out / "im1_mask_p3.png").shape == (8, 8)
    z = np.load(out / "im2_masks.npz")
    assert sorted(z.files) == ["p3", "p4", "p5"] and ((z["p3"] >= 0) & (z["p3"] <= 1)).all()
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines[:4]] == ["im0.png", "im1.png", "im2.png", "im0.png"]
    assert all(ln.endswith("detections") for ln in lines[:4])
    assert lines[-1] == f"[mga-predict] 4 images, 0 video frames -> {out}"


def test_cli_ckpt_load_export_and_the_export_serves(pair, tmp_path, capsys):
    from mga_yolo_tpu_torch.cli import ckpt as cli_ckpt
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.serve import build_server

    info = cli_ckpt.main(["load", str(pair["ckpt"]), "--device", "cpu"])
    assert info["params"] == sum(p.numel() for p in pair["tmodel"].parameters()) and info["nc"] == 1
    text = capsys.readouterr().out
    assert "scale=n" in text and "imgsz: 64" in text and "model.0.conv.weight" in text
    out = tmp_path / "ref.pt"
    cli_ckpt.main(["export-torch", str(pair["ckpt"]), str(out), "--device", "cpu"])
    ref = torch.load(str(out), map_location="cpu", weights_only=True)
    assert set(ref) == {"ema_state_dict", "train_args"} and ref["train_args"]["nc"] == 1
    sd = pair["tmodel"].state_dict()
    assert list(ref["ema_state_dict"]) == list(sd)
    assert all(torch.equal(ref["ema_state_dict"][k], sd[k]) for k in sd)
    for cmd in (["export-tflite", str(out)], ["export-savedmodel", str(out), str(tmp_path / "sm")]):
        with pytest.MonkeyPatch.context() as mp, \
                pytest.raises(ImportError, match=f"mga-ckpt {cmd[0]} needs tensorflow"):
            mp.setitem(sys.modules, "tensorflow", None)  # the card's host has no TensorFlow
            cli_ckpt.main(cmd + ["--device", "cpu"])
    server = build_server(out, imgsz=IMGSZ, batch=2, conf=0.01, port=0, device="cpu")
    try:
        img = image_io.imread(pair["paths"][1])
        pred = server.batcher.submit(img)
        assert pred.orig_shape == (48, 64) and len(pred.boxes) > 0
    finally:
        server.httpd.server_close()
        server.batcher.close()


def test_cli_serve_answers_on_port_0(pair, monkeypatch):
    from mga_yolo_tpu_torch import serve
    from mga_yolo_tpu_torch.cli import serve as cli_serve

    started = []
    build = serve.build_server
    monkeypatch.setattr(serve, "build_server", lambda *a, **kw: started.append(build(*a, **kw)) or started[-1])
    th = threading.Thread(target=cli_serve.main, args=(["--weights", str(pair["ckpt"]), "--port", "0", "--batch",
                                                        "2", "--conf", "0.01", "--device", "cpu"],), daemon=True)
    th.start()
    try:
        for _ in range(600):
            if started:
                break
            th.join(0.05)
        server = started[0]
        assert server.port > 0 and server.batcher.engine.imgsz == IMGSZ  # from the checkpoint
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/predict", method="POST",
                                     data=pair["paths"][2].read_bytes())
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert out["orig_shape"] == [40, 56] and len(out["boxes"]) > 0
    finally:
        if started:
            started[0].httpd.shutdown()
        th.join(10)
    assert not th.is_alive()


def test_profile_layers_equal_jax_and_cli_profile_yaml(pair, tmp_path):
    import yaml

    from mga_yolo_tpu.utils.layer_profile import profile_layers as jprofile
    from mga_yolo_tpu_torch.cli import profile as cli_profile
    from mga_yolo_tpu_torch.train.trainer import count_gflops
    from mga_yolo_tpu_torch.utils import yaml_lite
    from mga_yolo_tpu_torch.utils.layer_profile import format_table, total_gflops

    want = jprofile(pair["jmodel"], pair["v"], IMGSZ)
    out = tmp_path / "layers.yaml"
    rows = cli_profile.main(["--imgsz", str(IMGSZ), "--yaml", str(out)])
    assert len(rows) == len(want) == 29
    for r, w in zip(rows, want):
        for k in ("index", "module", "inputs", "stride", "params", "out_shape"):
            assert r[k] == w[k], (r["index"], k, r[k], w[k])
        assert (r["gflops"] > 0) == (r["module"] not in ("Upsample", "Concat"))
    assert total_gflops(rows) == count_gflops(pair["tspec"], IMGSZ) > 0
    assert yaml.safe_load(out.read_text()) == yaml_lite.load(out) == {"layers": rows}
    assert "TOTAL" in format_table(rows)
