"""PyTorch port, the MaskECA model as a whole, against the JAX package.

YOLOv8n-MGA-ECA (configs/models/yolov8_eca.yaml, scale n, nc=1) on the CPU
in float32, with the JAX model's weights (BN statistics perturbed with a
numpy seed) carried over by ``utils/jax_weights.py``. The JAX model is built
with ``use_pallas=True``, so its MaskECA goes through ``masked_pool_fused``
and its analytic ``_bwd``, as the port's does (see
``mga_yolo_tpu_torch/ops/masked_pool.py``).

Serving, at 64 px, batch 2: decoded boxes rtol 1e-3 / atol 2e-3 and seg
logits rtol 1e-3 / atol 1e-4, the tolerances of tests/test_torch_slice.py.
Training, at 128 px, batch 2 (why 128 px: tests/test_torch_train_step.py),
three micro-steps with accumulate = 2 and a 4-step warmup ramp (an apply, an
accumulate, an apply), with the tolerances of tests/test_torch_train_step.py.
"""

import dataclasses
import json
import sys
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests._torch_port import assert_dets_match, close_dict, model_pair, train_step_run
from tests._torch_port import few_torch_threads  # noqa: F401  (a module fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

CFG = "configs/models/yolov8_eca.yaml"
IMGSZ, TRAIN_IMGSZ = 64, 128
LR, LR_BIAS, MOM = 1e-3, 1e-2, 0.9
KW = dict(weight_decay=5e-4, ema_decay=0.9999, ema_tau=2000.0)


@pytest.fixture(scope="module")
def pair():
    return model_pair(CFG, IMGSZ, dict(use_pallas=True))


def test_config_dict_and_graph_match_yaml():
    from mga_yolo_tpu.graph import parse_graph as jparse
    from mga_yolo_tpu_torch.configs import SHIPPED, YOLOV8_ECA
    from mga_yolo_tpu_torch.graph import parse_graph

    assert YOLOV8_ECA == yaml.safe_load(Path(CFG).read_text())
    for stem, cfg in SHIPPED.items():
        assert cfg == yaml.safe_load(Path(f"configs/models/{stem}.yaml").read_text()), stem
    a = dataclasses.asdict(parse_graph(YOLOV8_ECA, scale="n", nc=1))
    b = dataclasses.asdict(jparse(CFG, scale="n", nc=1))
    b["yaml_path"] = None
    assert a == b
    eca = [n.c_out for n in parse_graph(YOLOV8_ECA, scale="n").nodes if n.module == "MaskECA"]
    assert eca == [64, 128, 256]


def test_shipped_config_path_needs_no_yaml_and_no_file(monkeypatch):
    """A path whose stem names a shipped config reads its dict: PyYAML
    blocked and the file absent, the graph is that of the YAML file."""
    from mga_yolo_tpu.graph import parse_graph as jparse
    from mga_yolo_tpu_torch.graph import parse_graph

    monkeypatch.setitem(sys.modules, "yaml", None)  # `import yaml` now raises
    for stem in ("yolov8_eca", "yolov8_cbam"):
        got = dataclasses.asdict(parse_graph(f"/nonexistent/dir/{stem}.yaml", nc=1))
        monkeypatch.undo()
        want = dataclasses.asdict(jparse(f"configs/models/{stem}.yaml", nc=1))
        monkeypatch.setitem(sys.modules, "yaml", None)
        assert got.pop("yaml_path") == f"/nonexistent/dir/{stem}.yaml"
        want.pop("yaml_path")
        assert got == want
    # any other path is read by the port's own YAML reader, not PyYAML
    with pytest.raises(FileNotFoundError):
        parse_graph("/nonexistent/dir/custom.yaml")


def test_state_dict_equals_torch_export(pair):
    from mga_yolo_tpu.utils.torch_export import export_torch_state_dict
    from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax

    want = export_torch_state_dict(pair["v"], pair["jspec"])
    got = state_dict_from_jax(pair["v"], pair["tspec"])
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert set(pair["tmodel"].state_dict()) == set(want)
    assert want["model.23.conv1d.weight"].shape == (1, 1, 5)


def test_param_groups_match_jax(pair):
    """conv1d.weight (ndim 3) decays with the kernels (tag 0), beta is tag 1."""
    from mga_yolo_tpu.train.optim import param_groups as jgroups
    from mga_yolo_tpu_torch.train.optim import param_groups
    from mga_yolo_tpu_torch.utils.jax_weights import params_from_jax

    params = pair["v"]["params"]
    tags = jax.tree_util.tree_map(lambda t, p: np.full(np.shape(p), t, np.float32), jgroups(params), params)
    want = {k: int(v.flatten()[0]) for k, v in params_from_jax(tags, pair["tspec"]).items()}
    got = param_groups({k: p for k, p in pair["tmodel"].named_parameters() if p.requires_grad})
    assert got == want
    assert [got[f"model.{i}.{n}"] for i in (23, 25, 27) for n in ("conv1d.weight", "beta")] == [0, 1] * 3


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
    for k in ("p3", "p4", "p5"):
        np.testing.assert_allclose(out_t["seg"][k].permute(0, 2, 3, 1).numpy(), np.asarray(out_j["seg"][k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)


def test_bn_fold_keeps_outputs(pair):
    import copy

    from mga_yolo_tpu_torch.utils.model_utils import fuse_model

    fused = fuse_model(copy.deepcopy(pair["tmodel"]))
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
        assert_dets_match(a.boxes, b.boxes)
        n_boxes += len(a.boxes)
        for k in ("p3", "p4", "p5"):
            np.testing.assert_allclose(a.masks[k], b.masks[k], rtol=1e-3, atol=1e-4)
    assert n_boxes > 0


def test_build_server_serves_exported_eca_checkpoint(pair, engines, tmp_path, monkeypatch):
    """An ECA checkpoint whose train_args["model"] is the YAML path serves
    with PyYAML blocked, as on a host without it."""
    import cv2

    from mga_yolo_tpu.utils.torch_export import save_reference_checkpoint
    from mga_yolo_tpu_torch.serve import build_server

    ckpt = tmp_path / "export.pt"
    save_reference_checkpoint(pair["v"], pair["jspec"], ckpt, nc=1, model_yaml=CFG, is_ema=True)
    assert torch.load(ckpt, weights_only=True)["train_args"]["model"] == CFG
    monkeypatch.setitem(sys.modules, "yaml", None)
    server = build_server(ckpt, imgsz=IMGSZ, batch=2, conf=0.01, max_det=16, port=0, with_masks=True,
                          device="cpu")
    monkeypatch.undo()
    server.start()
    try:
        img = np.random.default_rng(5).integers(0, 255, (72, 56, 3)).astype(np.uint8)
        lb, meta = engines[1].preprocess(img)
        (want,) = engines[1].infer_batch([lb], [meta])
        base = f"http://127.0.0.1:{server.port}"
        ok, payload = cv2.imencode(".png", img)
        assert ok
        req = urllib.request.Request(f"{base}/predict?masks=1", data=payload.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert out["orig_shape"] == [72, 56]
        assert set(out["mga_masks_png"]) == {"p3", "p4", "p5"}
        got = np.array([[b["x1"], b["y1"], b["x2"], b["y2"], b["conf"], b["cls"]] for b in out["boxes"]],
                       np.float32).reshape(-1, 6)
        assert len(got) > 0
        np.testing.assert_allclose(got, want.boxes, rtol=1e-5, atol=1e-4)
    finally:
        server.stop()


@pytest.fixture(scope="module")
def run():
    return train_step_run(CFG, TRAIN_IMGSZ, dict(accumulate=2, warmup_steps=4, **KW), (LR, LR_BIAS, MOM),
                          jax_kw=dict(use_pallas=True))


@pytest.mark.parametrize("i", [0, 1, 2], ids=["step1_apply", "step2_accumulate", "step3_apply"])
def test_train_step_matches_jax(run, i):
    t, j = run["views"][i]
    first = i == 0
    assert t["opt_step"] == j["opt_step"] == (1, 1, 2)[i]
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4 if first else 1e-3)
    np.testing.assert_allclose(t["items"], j["items"], rtol=1e-4 if first else 1e-3)
    close_dict(t["params"], j["params"], "params", atol=1e-6)
    close_dict(t["m"], j["m"], "momentum", atol=1e-3 if first else 2e-2, rel_to_max=True)
    close_dict(t["bn"], j["bn"], "bn stats", rtol=1e-5 if first else 1e-4, atol=1e-6 if first else 1e-5)
    close_dict(t["ema"], j["ema"], "ema", atol=1e-6)
    close_dict(t["ema_bn"], j["ema_bn"], "ema bn", rtol=1e-5 if first else 1e-4, atol=1e-6 if first else 1e-5)
    # the ECA layers take part: their gradients are not zero
    assert all(float(t["m"][f"model.{i}.{n}"].abs().max()) > 0 for i in (23, 25, 27) for n in ("conv1d.weight", "beta"))
