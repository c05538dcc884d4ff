"""PyTorch port, NMS with the suppression kernel: the plain version against
the JAX package's ``nms_jax`` (XLA) and ``nms_jax_pallas`` (Pallas body run
by the interpreter), on identical numpy predictions in float32.

Kept scores, classes and box counts must agree exactly; boxes to rtol 1e-6
(xywh -> xyxy is the same float32 arithmetic). Only rows with score > 0 are
compared: empty slots carry arbitrary boxes in every implementation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mga_yolo_tpu.ops.pallas.nms as jpnms
from mga_yolo_tpu.ops.nms import nms_jax
from mga_yolo_tpu_torch.ops import nms as tnms


def _pred(b=2, a=300, nc=3, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(40, 200, (b, a, 2))
    wh = rng.uniform(10, 60, (b, a, 2))
    probs = rng.uniform(0, 1, (b, a, nc)) ** 3
    if ties:  # exact score ties: every score drawn from 8 values
        probs = np.round(probs * 8) / 8
    return np.concatenate([xy, wh, probs], -1).astype(np.float32)


def _interpret(fn, *args, **kw):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    jpnms.pl.pallas_call = interp_call
    try:
        return fn(*args, **kw)
    finally:
        jpnms.pl.pallas_call = orig


def _assert_same(got, want):
    gb, gs, gc = (t.numpy() for t in got)
    wb, ws, wc = (np.asarray(t) for t in want)
    assert gs.shape == ws.shape
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gc, wc)
    live = ws > 0
    np.testing.assert_allclose(gb[live], wb[live], rtol=1e-6, atol=1e-4)


CASES = {
    "multi_class": dict(pred=dict(nc=3), kw=dict(conf_thres=0.1)),
    "single_class": dict(pred=dict(nc=1, seed=1), kw=dict(conf_thres=0.05)),
    "k_below_max_nms": dict(pred=dict(a=84, nc=2, seed=2), kw=dict(conf_thres=0.01, max_nms=1024)),
    "precut": dict(pred=dict(a=300, nc=2, seed=3), kw=dict(conf_thres=0.01, max_nms=128, max_det=50)),
    "all_below_conf": dict(pred=dict(seed=4), kw=dict(conf_thres=1.5)),
    "score_ties": dict(pred=dict(nc=2, seed=5, ties=True), kw=dict(conf_thres=0.1)),
    "multi_label": dict(pred=dict(nc=3, seed=6), kw=dict(conf_thres=0.1, multi_label=True)),
    "class_agnostic": dict(pred=dict(nc=3, seed=7), kw=dict(conf_thres=0.1, class_agnostic=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_nms_matches_nms_jax(case):
    pred = _pred(**CASES[case]["pred"])
    kw = CASES[case]["kw"]
    got = tnms.nms(torch.from_numpy(pred), **kw)
    _assert_same(got, nms_jax(jnp.asarray(pred), **kw))


@pytest.mark.parametrize("case", ["multi_class", "k_below_max_nms", "all_below_conf", "score_ties", "multi_label"])
def test_nms_matches_pallas_interpret(case):
    pred = _pred(**CASES[case]["pred"])
    kw = CASES[case]["kw"]
    got = tnms.nms(torch.from_numpy(pred), **kw)
    _assert_same(got, _interpret(jpnms.nms_jax_pallas, jnp.asarray(pred), **kw))


def test_all_below_conf_is_empty():
    pred = _pred(seed=4)
    _, s, c = tnms.nms(torch.from_numpy(pred), conf_thres=1.5)
    assert float(s.sum()) == 0.0
    assert bool((c == -1).all())


def test_suppress_wrapper_takes_plain_version_on_cpu_only():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 100, (2, 64, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + 30], -1))
    scores = torch.sort(torch.from_numpy(rng.uniform(0, 1, (2, 64)).astype(np.float32)),
                        descending=True).values
    before = tnms.launches
    assert torch.equal(tnms.suppress(boxes, scores, 0.45, 0.1), tnms.suppress_ref(boxes, scores, 0.45, 0.1))
    assert tnms.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        tnms.suppress(boxes.to("meta"), scores.to("meta"), 0.45, 0.1)
