"""PyTorch port, the two CUDA kernels against their plain versions.

This file imports neither JAX nor the JAX package, so the ``cuda``-marked
tests also run on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Without a card they skip (the kernels have no CPU or interpret mode); the
wrapper's input checks, which are plain Python, run everywhere.

Tolerances on the card: the CAM gate to atol 1e-5 in float32 and bfloat16
(both sum in float32, in another order; the gate is a sigmoid in (0, 1));
NMS exactly (the kernel rounds its IoU as the plain version does).
"""

import numpy as np
import pytest
import torch

from mga_yolo_tpu_torch.ops import cam_gate as tcg
from mga_yolo_tpu_torch.ops import nms as tnms


def _cam_case(kind="random", b=2, h=8, w=8, c=32, seed=0):
    """NCHW features, (B, 1, H, W) mask probabilities, nn.Linear MLP weights."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, c, h, w))
    if kind == "tiny":
        m = np.zeros((b, 1, h, w))
    elif kind == "no_pixel":
        m = rng.uniform(0.05, 0.45, (b, 1, h, w))
    else:
        m = rng.uniform(0, 1, (b, 1, h, w)) ** 2
    hid = max(1, c // 16)
    ws = [rng.normal(0, 0.2, s) for s in ((hid, c), (hid,), (c, hid), (c,))]
    return [torch.from_numpy(a.astype(np.float32)) for a in (x, m, *ws)]


CAM_CASES = {
    "random": dict(),
    "tiny": dict(kind="tiny"),
    "no_pixel": dict(kind="no_pixel"),
    "ragged_16x7": dict(h=7, w=16, seed=4),
    "p3_width": dict(h=80, w=80, c=64, b=2, seed=5),
    "p5_width": dict(h=20, w=20, c=256, b=2, seed=6),
    "odd_channels": dict(h=9, w=11, c=40, seed=7),
}


def _pred(b=2, a=300, nc=3, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(40, 200, (b, a, 2))
    wh = rng.uniform(10, 60, (b, a, 2))
    probs = rng.uniform(0, 1, (b, a, nc)) ** 3
    if ties:
        probs = np.round(probs * 8) / 8
    return torch.from_numpy(np.concatenate([xy, wh, probs], -1).astype(np.float32))


NMS_CASES = {
    "multi_class": dict(pred=dict(nc=3), kw=dict(conf_thres=0.1)),
    "k_84": dict(pred=dict(a=84, nc=2, seed=2), kw=dict(conf_thres=0.01)),
    "full_1024": dict(pred=dict(a=1500, nc=1, seed=3), kw=dict(conf_thres=0.001)),
    "all_below_conf": dict(pred=dict(seed=4), kw=dict(conf_thres=1.5)),
    "score_ties": dict(pred=dict(nc=2, seed=5, ties=True), kw=dict(conf_thres=0.1)),
    "multi_label": dict(pred=dict(nc=3, seed=6), kw=dict(conf_thres=0.1, multi_label=True)),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CAM_CASES))
def test_cam_gate_kernel_matches_plain(card, case, dtype):
    args = [a.to(card, dtype) for a in _cam_case(**CAM_CASES[case])]
    before = tcg.launches
    got = tcg.cam_gate(*args)
    want = tcg.cam_gate_ref(*args)
    torch.cuda.synchronize()
    assert tcg.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(NMS_CASES))
def test_nms_kernel_matches_plain(card, case):
    pred = _pred(**NMS_CASES[case]["pred"])
    before = tnms.launches
    got = tnms.nms(pred.to(card), **NMS_CASES[case]["kw"])
    want = tnms.nms(pred, **NMS_CASES[case]["kw"])
    torch.cuda.synchronize()
    assert tnms.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


def test_cam_gate_checks_refuse_what_the_kernel_cannot_take():
    x, m, w1, b1, w2, b2 = _cam_case()
    tcg._check(x, m, w1, b1, w2, b2)  # NCHW-contiguous: taken
    tcg._check(x[:, :16], m, w1[:, :16].contiguous(), b1, w2[:16].contiguous(), b2[:16])  # channel slice
    with pytest.raises(ValueError, match="contiguous H\\*W planes"):
        tcg._check(x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2), m, w1, b1, w2, b2)  # NHWC memory
    with pytest.raises(ValueError, match="m must be"):
        tcg._check(x, m[:, :, :4], w1, b1, w2, b2)
    with pytest.raises(ValueError, match="w1 is"):
        tcg._check(x, m, w1.double(), b1, w2, b2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tcg._check(*(a.half() for a in (x, m, w1, b1, w2, b2)))


def test_suppress_checks_refuse_what_the_kernel_cannot_take():
    boxes, scores = torch.zeros((2, 8, 4)), torch.zeros((2, 8))
    for bad, err in (((boxes[:, :4], scores), ValueError), ((boxes.double(), scores), TypeError),
                     ((boxes.transpose(0, 1).contiguous().transpose(0, 1), scores), ValueError),
                     ((boxes[:, :0], scores[:, :0]), ValueError)):
        with pytest.raises(err):
            tnms._check(*bad)
    tnms._check(boxes, scores)
