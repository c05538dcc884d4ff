"""PyTorch port, the serving slice as a whole, against the JAX package.

The flagship (configs/models/yolov8_cbam.yaml, scale n, nc=1) at 64 px,
batch 2, float32 on the CPU, with the JAX model's weights (BN statistics
perturbed with a numpy seed) carried over by ``utils/jax_weights.py``.
Tolerances: decoded boxes rtol 1e-3 / atol 2e-3 and seg logits rtol 1e-3 /
atol 1e-4 (as tests/test_torch_export.py holds the torch reference: 28
layers of float32 convolutions summed in another order).
"""

import threading
import urllib.request
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests._torch_port import perturb_bn

CFG = "configs/models/yolov8_cbam.yaml"
IMGSZ = 64


@pytest.fixture(scope="module")
def pair():
    from mga_yolo_tpu.models.yolo import create_model as jcreate
    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax

    jmodel, jspec = jcreate(CFG, scale="n", nc=1)
    variables = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(
        jax.random.PRNGKey(0), np.zeros((1, IMGSZ, IMGSZ, 3), np.float32)
    )
    v = perturb_bn(variables, seed=1)
    # class bias 0 instead of the prior's -8.7, so every anchor clears the
    # confidence threshold and NMS has real work
    for k, p in v["params"]["l28_Detect"].items():
        if k.startswith("cv3_") and k.endswith("_2"):
            p["bias"] = np.zeros_like(p["bias"])
    tmodel, tspec = create_model(YOLOV8_CBAM, scale="n", nc=1, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(v, tspec), strict=True)
    x = np.random.default_rng(2).random((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    return dict(jmodel=jmodel, jspec=jspec, v=v, tmodel=tmodel, tspec=tspec, x=x)


def test_config_dict_and_graph_match_yaml():
    import dataclasses

    from mga_yolo_tpu.graph import parse_graph as jparse
    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.graph import parse_graph

    assert YOLOV8_CBAM == yaml.safe_load(Path(CFG).read_text())
    a = dataclasses.asdict(parse_graph(YOLOV8_CBAM, scale="n", nc=1))
    b = dataclasses.asdict(jparse(CFG, scale="n", nc=1))
    b["yaml_path"] = None
    assert a == b
    cam = [(n.c_out, n.args) for n in parse_graph(YOLOV8_CBAM, scale="n").nodes if n.module == "MaskCBAM"]
    assert [c for c, _ in cam] == [64, 128, 256]


def test_state_dict_equals_torch_export(pair):
    from mga_yolo_tpu.utils.torch_export import export_torch_state_dict
    from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax

    want = export_torch_state_dict(pair["v"], pair["jspec"])
    got = state_dict_from_jax(pair["v"], pair["tspec"])
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert set(pair["tmodel"].state_dict()) == set(want)


def test_forward_matches_jax(pair):
    out_j = pair["jmodel"].apply(pair["v"], jnp.asarray(pair["x"]), train=False)
    with torch.no_grad():
        out_t = pair["tmodel"](torch.from_numpy(pair["x"]).permute(0, 3, 1, 2).contiguous())
    dec_t, maps_t = out_t["det"]
    dec_j, maps_j = out_j["det"]
    assert dec_t.shape == (2, 84, 5)
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), rtol=1e-3, atol=2e-3)
    for mt, mj in zip(maps_t, maps_j):
        np.testing.assert_allclose(mt.permute(0, 2, 3, 1).numpy(), np.asarray(mj), rtol=1e-3, atol=2e-3)
    assert set(out_t["seg"]) == {"p3", "p4", "p5"}
    for k in ("p3", "p4", "p5"):
        np.testing.assert_allclose(out_t["seg"][k].permute(0, 2, 3, 1).numpy(), np.asarray(out_j["seg"][k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)


def test_bn_fold_keeps_outputs(pair):
    import copy

    from mga_yolo_tpu_torch.models.layers import ConvBN
    from mga_yolo_tpu_torch.utils.model_utils import fuse_model

    fused = fuse_model(copy.deepcopy(pair["tmodel"]))
    assert not any(isinstance(m, ConvBN) and isinstance(m.bn, torch.nn.BatchNorm2d) for m in fused.modules())
    x = torch.from_numpy(pair["x"]).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        a, b = pair["tmodel"](x), fused(x)
    torch.testing.assert_close(b["det"][0], a["det"][0], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def engines(pair):
    from mga_yolo_tpu.serve import InferenceEngine as JEngine
    from mga_yolo_tpu_torch.serve import InferenceEngine

    kw = dict(imgsz=IMGSZ, batch=2, conf=0.01, max_det=16, fuse=True, with_masks=True)
    return JEngine(pair["jmodel"], pair["v"], **kw), InferenceEngine(pair["tmodel"], **kw)


def _assert_dets_match(got, want):
    """Same detections, matched by nearest box (near-equal scores may swap rank)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    for row in got:
        err = np.abs(want[:, :5] - row[:5]).max(1)
        j = int(np.argmin(err))
        np.testing.assert_allclose(row[:5], want[j, :5], rtol=1e-3, atol=2e-3)
        assert row[5] == want[j, 5]


def test_engine_matches_jax_engine(engines):
    jeng, teng = engines
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 255, s).astype(np.uint8) for s in ((48, 80, 3), (64, 64, 3))]
    lbs, metas = zip(*(jeng.preprocess(im) for im in imgs))  # same letterboxed pixels
    pj = jeng.infer_batch(list(lbs), list(metas))
    pt = teng.infer_batch(list(lbs), list(metas))
    n_boxes = 0
    for a, b in zip(pt, pj):
        assert a.orig_shape == b.orig_shape
        _assert_dets_match(a.boxes, b.boxes)
        n_boxes += len(a.boxes)
        for k in ("p3", "p4", "p5"):
            np.testing.assert_allclose(a.masks[k], b.masks[k], rtol=1e-3, atol=1e-4)
    assert n_boxes > 0


def test_short_batch_is_padded(engines):
    _, teng = engines
    img = np.random.default_rng(0).integers(0, 255, (48, 80, 3)).astype(np.uint8)
    lb, meta = teng.preprocess(img)
    assert lb.shape == (IMGSZ, IMGSZ, 3)
    (p,) = teng.infer_batch([lb], [meta])  # 1 < batch
    assert p.boxes.shape[1] == 6 and p.orig_shape == (48, 80)
    if len(p.boxes):
        assert p.boxes[:, [0, 2]].max() <= 80 + 1e-3
        assert p.boxes[:, [1, 3]].max() <= 48 + 1e-3


def test_microbatcher_coalesces(engines):
    from mga_yolo_tpu_torch.serve import MicroBatcher

    mb = MicroBatcher(engines[1], max_wait_ms=200.0)
    try:
        img = np.zeros((IMGSZ, IMGSZ, 3), np.uint8)
        results = [None, None]

        def call(i):
            results[i] = mb.submit(img)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert all(r is not None for r in results)
        s = mb.stats()
        assert s["requests"] == 2
        assert s["batches"] == 1  # two requests inside the wait window -> one batch
    finally:
        mb.close()


@pytest.mark.parametrize("shape", [(48, 80, 3), (72, 56, 3), (200, 120, 3), (64, 64, 3), (33, 130, 3)])
def test_letterbox_matches_jax(shape):
    from mga_yolo_tpu.data.transforms import letterbox as jletterbox
    from mga_yolo_tpu_torch.data.transforms import letterbox

    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    for scaleup in (False, True):
        want = jletterbox({"img": img, "boxes": np.zeros((0, 4), np.float32),
                           "cls": np.zeros((0,), np.float32)}, IMGSZ, scaleup=scaleup)
        got, ratio_pad = letterbox(img, IMGSZ, scaleup=scaleup)
        assert got.shape == want["img"].shape
        assert ratio_pad == want["ratio_pad"]
        diff = np.abs(got.astype(np.int16) - want["img"].astype(np.int16))
        assert diff.max() <= 1, diff.max()


def test_scale_boxes_matches_jax():
    from mga_yolo_tpu.train.predictor import scale_boxes as jscale
    from mga_yolo_tpu_torch.data.transforms import scale_boxes

    b = np.random.default_rng(0).uniform(0, 64, (10, 4)).astype(np.float32)
    rp = (0.4, (0, 16))
    np.testing.assert_array_equal(scale_boxes(b, rp, (120, 160)), jscale(b, rp, (120, 160)))


def test_build_server_serves_exported_checkpoint(pair, engines, tmp_path):
    import cv2

    from mga_yolo_tpu.utils.torch_export import save_reference_checkpoint
    from mga_yolo_tpu_torch.serve import build_server

    ckpt = tmp_path / "export.pt"
    save_reference_checkpoint(pair["v"], pair["jspec"], ckpt, nc=1, is_ema=True)
    server = build_server(ckpt, imgsz=IMGSZ, batch=2, conf=0.01, max_det=16, port=0,
                          with_masks=True, device="cpu")
    server.start()
    try:
        img = np.random.default_rng(5).integers(0, 255, (72, 56, 3)).astype(np.uint8)
        lb, meta = engines[1].preprocess(img)
        (want,) = engines[1].infer_batch([lb], [meta])
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        ok, payload = cv2.imencode(".png", img)
        assert ok
        req = urllib.request.Request(f"{base}/predict?masks=1", data=payload.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert out["orig_shape"] == [72, 56]
        assert set(out["mga_masks_png"]) == {"p3", "p4", "p5"}
        got = np.array([[b["x1"], b["y1"], b["x2"], b["y2"], b["conf"], b["cls"]] for b in out["boxes"]],
                       np.float32).reshape(-1, 6)
        np.testing.assert_allclose(got, want.boxes, rtol=1e-5, atol=1e-4)
    finally:
        server.stop()
