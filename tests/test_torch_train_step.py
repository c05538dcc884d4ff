"""PyTorch port, the flagship's train and eval steps against the JAX package.

The flagship (configs/models/yolov8_cbam.yaml, scale n, nc=1) at 128 px,
batch 2, float32 on the CPU. Both packages start from the same state: the
JAX model's weights with perturbed BN statistics and ``mtl_log_vars`` =
(0.2, -0.3), carried over by ``utils/jax_weights.py``. Both take the same
three micro-steps with accumulate = 2 and a 4-step warmup ramp, so
micro-step 1 applies at once (the ramp's accumulate is still 1), micro-step
2 only accumulates and micro-step 3 applies the sum of two gradients. The
JAX step is jitted once for the file.

Why 128 px: a train-mode BN normalises over B*H*W values per channel, 8 at
P5 of a 64 px batch of 2, and there a one-ulp change of the weights moves
the port's own P5 seg loss by 3e-5 after one step; the two packages then
differ by up to 6e-4 of the largest first-layer gradient. At 128 px (32
values) every difference below is about ten times smaller.

Tolerances, from the same state (micro-step 1): loss and items rtol 1e-4;
momentum buffers (the clipped gradient plus decay) atol 1e-3 * max|m| per
tensor (measured 3e-4: the gradient passes 60 train-mode BNs); parameters,
``mtl_log_vars`` and the EMA atol 1e-6; BN running statistics rtol 1e-5 /
atol 1e-6 (flax takes E[x^2] - E[x]^2, PyTorch a two-pass variance). After
micro-steps 2 and 3 the states already differ in the last bits, so: items
rtol 1e-3, BN statistics rtol 1e-4 / atol 1e-5, momentum atol 2e-2 *
max|m| per tensor (measured 1e-2), parameters and EMA still atol 1e-6. Eval
decoded boxes rtol 1e-3 / atol 2e-3 as tests/test_torch_slice.py, val
items rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port import close_dict, few_torch_threads, train_step_run  # noqa: F401  (a module fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

CFG = "configs/models/yolov8_cbam.yaml"
IMGSZ, B = 128, 2
LR, LR_BIAS, MOM = 1e-3, 1e-2, 0.9
KW = dict(weight_decay=5e-4, ema_decay=0.9999, ema_tau=2000.0)


@pytest.fixture(scope="module")
def run():
    """Both packages' states after each of three micro-steps, and eval outputs."""
    from mga_yolo_tpu.losses.detection import DetLossConfig as JDet
    from mga_yolo_tpu.losses.segmentation import SegLossConfig as JSeg
    from mga_yolo_tpu.train import state as JS
    from mga_yolo_tpu_torch.losses import DetLossConfig, SegLossConfig
    from mga_yolo_tpu_torch.train import state as TS

    r = train_step_run(CFG, IMGSZ, dict(accumulate=2, warmup_steps=4, **KW), (LR, LR_BIAS, MOM))
    jeval = jax.jit(JS.make_eval_step(r["jmodel"], (8, 16, 32), 1, JDet(), JSeg(), nms_conf=1e-5, nms_iou=0.5,
                                      max_det=32))
    teval = TS.make_eval_step(r["tmodel"], (8, 16, 32), 1, DetLossConfig(), SegLossConfig(), nms_conf=1e-5,
                              nms_iou=0.5, max_det=32)
    return {**r, "eval": (teval(r["tstate"], r["batch"]), jeval(r["jstate"], r["jbatch"]))}


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


def test_accumulate_applies_on_the_second_micro_step_only(run):
    (t1, j1), (t2, _), (t3, j3) = run["views"]
    assert all(torch.equal(t2["params"][k], t1["params"][k]) for k in t1["params"])
    assert all(torch.equal(t2["ema"][k], t1["ema"][k]) for k in t1["ema"])
    assert not all(torch.equal(t2["bn"][k], t1["bn"][k]) for k in t1["bn"])  # BN moves every micro-step
    # the apply moves every tensor whose update is above float resolution,
    # the same tensors as in JAX (a few head BNs get ~1e-9 updates)
    changed = {k for k in t2["params"] if not torch.equal(t3["params"][k], t2["params"][k])}
    assert changed == {k for k in j1["params"] if not torch.equal(j3["params"][k], j1["params"][k])}
    assert len(changed) > 0.9 * len(t2["params"])


def test_one_step_without_accumulation_equals_the_first_apply(run):
    """accumulate = 1 (no buffer, no ramp) takes the same first step."""
    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.losses import DetLossConfig, SegLossConfig
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.train import state as TS
    from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax

    model, spec = create_model(YOLOV8_CBAM, scale="n", nc=1, device="cpu", training=True)
    model.load_state_dict(state_dict_from_jax(run["v"], spec), strict=True)
    s = TS.create_train_state(model)
    with torch.no_grad():
        s.mtl_log_vars.copy_(torch.from_numpy(run["mtl"]))
        s.ema_params["mtl_log_vars"].copy_(torch.from_numpy(run["mtl"]))
    step = TS.make_train_step(model, (8, 16, 32), 1, DetLossConfig(), SegLossConfig(), **KW)
    s, _ = step(s, run["batch"], LR, LR_BIAS, MOM)
    want = run["views"][0][0]
    assert s.opt_step == 1 and s.accum_grads is None
    for k, p in s.params().items():
        torch.testing.assert_close(p.detach(), want["params"][k], rtol=0, atol=1e-7)


def test_eval_step_matches_jax(run):
    """Decoded boxes and val items against JAX's eval step; the detections
    against JAX's ``nms_jax`` on the same decoded boxes (the two steps'
    decoded boxes differ in the last bits, and with the class prior's
    near-equal scores that can reorder NMS: NMS parity itself is
    tests/test_torch_nms.py's)."""
    from mga_yolo_tpu.ops.nms import nms_jax

    t, j = run["eval"]
    np.testing.assert_allclose(t["decoded"].numpy(), np.asarray(j["decoded"]), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(t["items"].numpy(), np.asarray(j["items"]), rtol=1e-4)
    boxes, scores, cls = nms_jax(jnp.asarray(t["decoded"].numpy()), conf_thres=1e-5, iou_thres=0.5, max_det=32)
    want = np.concatenate([np.asarray(boxes), np.asarray(scores)[..., None], np.asarray(cls)[..., None]], -1)
    assert t["dets"].shape == j["dets"].shape == want.shape and (want[..., 4] > 0).sum() > 0
    np.testing.assert_allclose(t["dets"].numpy(), want, rtol=1e-6, atol=1e-6)
