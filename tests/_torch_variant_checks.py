"""Checks of one model variant of the PyTorch port against the JAX package,
shared by tests/test_torch_variants.py (MaskSPADE) and
tests/test_torch_baseline.py (plain YOLOv8): a test class derives from
:class:`VariantChecks` and sets ``NAME`` and ``CFG``.

Each model (scale n, nc=1) on the CPU in float32 with the JAX model's
weights (BN statistics perturbed with a numpy seed) carried over by
``utils/jax_weights.py``. Serving at 64 px, batch 2: decoded boxes rtol 1e-3
/ atol 2e-3 and seg logits rtol 1e-3 / atol 1e-4, the tolerances of
tests/test_torch_slice.py. Training at 128 px, batch 2 (why 128 px:
tests/test_torch_train_step.py), three micro-steps with accumulate = 2 and a
4-step warmup ramp (an apply, an accumulate, an apply), with the tolerances
of tests/test_torch_eca_slice.py, but two after micro-step 3:

* the momentum of SPADE's first ``shared`` conv at P3
  (``model.23.shared.0.weight`` and ``.bias``) may differ from JAX's by
  5% of its max (``KINK_MOMENTUM``; measured 3.84% and 3.11%, against the
  ECA slice's 2%): a ReLU of ``shared`` sits at its kink for a pixel, so a
  last-bit difference of the weights after step 1 switches it. The port's
  own run from weights scaled by 1 + 1e-7 moves that momentum by 3.8% of
  its max too.
* a parameter, and the EMA, which is the parameters this early in its
  ramp, may differ by what the ECA slice's momentum tolerance lets the
  update move it, 2 * lr * 2e-2 * max|m| (Nesterov SGD adds lr * (g +
  momentum * m)), where that is above 1e-6: plain YOLOv8 has no seg term,
  its momenta are larger, and three of its tensors differ by up to
  1.19e-6.
"""

import copy
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests._torch_port import assert_dets_match, close_dict, model_pair, nchw, nhwc, train_step_run

IMGSZ, TRAIN_IMGSZ = 64, 128
LR, LR_BIAS, MOM = 1e-3, 1e-2, 0.9
STEP_KW = dict(accumulate=2, warmup_steps=4, weight_decay=5e-4, ema_decay=0.9999, ema_tau=2000.0)
# the momentum tensors whose step-3 limit is wider, as a share of their max
KINK_MOMENTUM = {("spade", "model.23.shared.0.weight"): 5e-2, ("spade", "model.23.shared.0.bias"): 5e-2}


class VariantChecks:
    """The serving and training checks of one model; ``NAME`` is "spade" or
    "base", ``CFG`` its YAML path."""

    NAME: str
    CFG: str

    @pytest.fixture(scope="class")
    def pair(self):
        return model_pair(self.CFG, IMGSZ)

    def test_config_dict_and_graph_match_yaml(self):
        from mga_yolo_tpu.graph import parse_graph as jparse
        from mga_yolo_tpu_torch.configs import SHIPPED
        from mga_yolo_tpu_torch.graph import parse_graph

        stem = Path(self.CFG).stem
        assert SHIPPED[stem] == yaml.safe_load(Path(self.CFG).read_text())
        a = dataclasses.asdict(parse_graph(SHIPPED[stem], scale="n", nc=1))
        b = dataclasses.asdict(jparse(self.CFG, scale="n", nc=1))
        b["yaml_path"] = None
        assert a == b
        spec = parse_graph(SHIPPED[stem], scale="n")
        if self.NAME == "base":
            assert (len(spec.nodes), spec.mask_head_indices, spec.attention_indices, spec.detect_index) == (
                23, (), (), 22)
        else:
            assert [n.c_out for n in spec.nodes if n.module == "MaskSPADE"] == [64, 128, 256]

    def test_state_dict_equals_torch_export(self, pair):
        from mga_yolo_tpu.utils.torch_export import export_torch_state_dict
        from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax

        want = export_torch_state_dict(pair["v"], pair["jspec"])
        got = state_dict_from_jax(pair["v"], pair["tspec"])
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        assert set(pair["tmodel"].state_dict()) == set(want)
        if self.NAME == "spade":
            assert want["model.23.conv_gamma.weight"].shape == (64, 64, 3, 3)
        else:
            assert not any(".cam_mlp." in k or ".proj." in k for k in want)

    def test_forward_matches_jax(self, pair):
        out_j = pair["jmodel"].apply(pair["v"], jnp.asarray(pair["x"]), train=False)
        with torch.no_grad():
            out_t = pair["tmodel"](nchw(pair["x"]))
        (dec_t, maps_t), (dec_j, maps_j) = out_t["det"], out_j["det"]
        assert dec_t.shape == (2, 84, 5)
        np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), rtol=1e-3, atol=2e-3)
        for mt, mj in zip(maps_t, maps_j):
            np.testing.assert_allclose(nhwc(mt), np.asarray(mj), rtol=1e-3, atol=2e-3)
        assert set(out_t["seg"]) == set(out_j["seg"]) == ({"p3", "p4", "p5"} if self.NAME == "spade" else set())
        for k in out_t["seg"]:
            np.testing.assert_allclose(nhwc(out_t["seg"][k]), np.asarray(out_j["seg"][k]), rtol=1e-3, atol=1e-4,
                                       err_msg=k)

    def test_bn_fold_keeps_outputs(self, pair):
        from mga_yolo_tpu_torch.utils.model_utils import fuse_model

        fused = fuse_model(copy.deepcopy(pair["tmodel"]))
        x = nchw(pair["x"])
        with torch.no_grad():
            a, b = pair["tmodel"](x), fused(x)
        torch.testing.assert_close(b["det"][0], a["det"][0], rtol=1e-4, atol=1e-4)

    def test_engine_matches_jax_engine(self, pair):
        from mga_yolo_tpu.serve import InferenceEngine as JEngine
        from mga_yolo_tpu_torch.serve import InferenceEngine

        kw = dict(imgsz=IMGSZ, batch=2, conf=0.01, max_det=16, fuse=True, with_masks=True)
        jeng, teng = JEngine(pair["jmodel"], pair["v"], **kw), InferenceEngine(pair["tmodel"], **kw)
        rng = np.random.default_rng(3)
        imgs = [rng.integers(0, 255, s).astype(np.uint8) for s in ((48, 80, 3), (64, 64, 3))]
        lbs, metas = zip(*(jeng.preprocess(im) for im in imgs))
        pj = jeng.infer_batch(list(lbs), list(metas))
        pt = teng.infer_batch(list(lbs), list(metas))
        n_boxes = 0
        for a, b in zip(pt, pj):
            assert a.orig_shape == b.orig_shape
            assert_dets_match(a.boxes, b.boxes)
            n_boxes += len(a.boxes)
            if self.NAME == "base":
                assert a.masks is None  # no mask heads: no masks in the reply
            else:
                for k in ("p3", "p4", "p5"):
                    np.testing.assert_allclose(a.masks[k], b.masks[k], rtol=1e-3, atol=1e-4)
        assert n_boxes > 0

    @pytest.fixture(scope="class")
    def run(self):
        return train_step_run(self.CFG, TRAIN_IMGSZ, STEP_KW, (LR, LR_BIAS, MOM))

    @pytest.mark.parametrize("i", [0, 1, 2], ids=["step1_apply", "step2_accumulate", "step3_apply"])
    def test_train_step_matches_jax(self, run, i):
        t, j = run["views"][i]
        first = i == 0
        assert t["opt_step"] == j["opt_step"] == (1, 1, 2)[i]
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4 if first else 1e-3)
        np.testing.assert_allclose(t["items"], j["items"], rtol=1e-4 if first else 1e-3)
        if i < 2:
            close_dict(t["params"], j["params"], "params", atol=1e-6)
            close_dict(t["m"], j["m"], "momentum", atol=1e-3 if first else 2e-2, rel_to_max=True)
            close_dict(t["ema"], j["ema"], "ema", atol=1e-6)
        else:
            for what in ("params", "ema", "m"):
                for k, w in j[what].items():
                    m_max = float(j["m"][k].abs().max()) if k in j["m"] else 0.0
                    if what == "m":
                        tol = KINK_MOMENTUM.get((self.NAME, k), 2e-2) * float(w.abs().max())
                    else:
                        tol = max(1e-6, 2 * LR * 2e-2 * m_max)
                    np.testing.assert_allclose(t[what][k].numpy(), w.numpy(), rtol=0, atol=tol,
                                               err_msg=f"{what} {k}")
        close_dict(t["bn"], j["bn"], "bn stats", rtol=1e-5 if first else 1e-4, atol=1e-6 if first else 1e-5)
        close_dict(t["ema_bn"], j["ema_bn"], "ema bn", rtol=1e-5 if first else 1e-4,
                   atol=1e-6 if first else 1e-5)
        if self.NAME == "base":
            assert (t["items"][3:] == 0).all()  # detection only: every seg item exactly 0
        else:  # the SPADE layers take part: their gradients are not zero
            assert all(float(t["m"][f"model.{k}.{n}.weight"].abs().max()) > 0
                       for k in (23, 25, 27) for n in ("shared.0", "conv_gamma", "conv_beta"))
