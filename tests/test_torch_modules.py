"""PyTorch port, building blocks: each port module against its flax module.

Same weights (flax init, BN statistics perturbed with a numpy seed, carried
over by ``utils/jax_weights.py``) and the same numpy input; float32 on the
CPU. Tolerance rtol 1e-4 / atol 1e-5: the two frameworks sum convolutions in
different orders, a few float32 ulps per layer.
"""

import jax
import numpy as np
import pytest
import torch

from mga_yolo_tpu.models import heads as jheads
from mga_yolo_tpu.models import layers as jlayers
from mga_yolo_tpu_torch.models import heads as theads
from mga_yolo_tpu_torch.models import layers as tlayers
from tests._torch_port import few_torch_threads, load_layer, nchw, nhwc, perturb_bn  # noqa: F401  (a module fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

RTOL, ATOL = 1e-4, 1e-5


def _run_pair(flax_mod, torch_mod, name, x_nhwc, seed=0, legacy=False):
    variables = flax_mod.init(jax.random.PRNGKey(seed), x_nhwc)
    v = perturb_bn(variables, seed)
    want = flax_mod.apply(v, x_nhwc)
    load_layer(torch_mod, name, v["params"], v.get("batch_stats"), legacy_detect=legacy)
    with torch.no_grad():
        got = torch_mod(nchw(x_nhwc))
    return want, got


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize(
    "name,flax_mod,torch_mod,c_in",
    [
        ("Conv", jlayers.ConvBN(16, 3, 2), tlayers.ConvBN(8, 16, 3, 2), 8),
        ("Conv", jlayers.ConvBN(16, 1, 1), tlayers.ConvBN(8, 16, 1, 1), 8),
        ("C2f", jlayers.C2f(16, n=2, shortcut=True), tlayers.C2f(8, 16, n=2, shortcut=True), 8),
        ("C3k2", jlayers.C3k2(32, n=1, c3k=False), tlayers.C3k2(16, 32, n=1, c3k=False), 16),
        ("C3k2", jlayers.C3k2(32, n=2, c3k=True), tlayers.C3k2(16, 32, n=2, c3k=True), 16),
        ("SPPF", jlayers.SPPF(16, 5), tlayers.SPPF(16, 16, 5), 16),
    ],
    ids=["convbn_k3s2", "convbn_k1", "c2f", "c3k2_plain", "c3k2_c3k", "sppf"],
)
def test_block_matches_flax(name, flax_mod, torch_mod, c_in):
    x = _x((2, 12, 12, c_in))
    want, got = _run_pair(flax_mod, torch_mod, name, x)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_upsample_and_resize_match_jax():
    x = _x((2, 5, 6, 4))
    np.testing.assert_array_equal(nhwc(tlayers.upsample2x(nchw(x))), np.asarray(jlayers.upsample2x(x)))
    got = nhwc(tlayers.resize_bilinear(nchw(x), (10, 12)))
    np.testing.assert_allclose(got, np.asarray(jlayers.resize_bilinear(x, (10, 12))), rtol=RTOL, atol=ATOL)


def test_mask_head_matches_flax():
    x = _x((2, 8, 8, 16))
    want, got = _run_pair(jheads.MGAMaskHead(hidden=8, out_ch=1), theads.MGAMaskHead(16, 8, 1),
                          "MGAMaskHead", x)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nc", [1, 3])
def test_detect_and_decode_match_flax(nc):
    ch, strides = (16, 32, 64), (8, 16, 32)
    xs = [_x((2, 64 // s, 64 // s, c), seed=i) for i, (c, s) in enumerate(zip(ch, strides))]
    jdet = jheads.Detect(nc=nc, ch=ch, strides=strides, legacy=False)
    variables = jdet.init(jax.random.PRNGKey(0), xs)
    v = perturb_bn(variables, 3)
    want_dec, want_maps = jdet.apply(v, xs)
    tdet = load_layer(theads.Detect(nc, ch, strides, legacy=False), "Detect", v["params"],
                      v["batch_stats"])
    with torch.no_grad():
        got_dec, got_maps = tdet([nchw(x) for x in xs])
    assert got_dec.shape == (2, 64 + 16 + 4, 4 + nc)
    for g, w in zip(got_maps, want_maps):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=RTOL, atol=ATOL)
    # decoded boxes are in pixels (up to ~16 * stride): the same relative
    # tolerance, with atol scaled by the largest stride
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(want_dec), rtol=RTOL, atol=ATOL * 32)
