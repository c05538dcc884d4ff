"""PyTorch port, CAM-gate kernel: the plain version against the JAX package.

``cam_gate_ref`` (what a CPU tensor runs) is held against the XLA
composition ``_cam_gate_ref`` and against the Pallas kernel body run by the
interpreter, on identical numpy inputs in float32. Tolerance rtol 1e-5 /
atol 1e-6 against XLA (same float32 reductions, another summation order)
and atol 1e-5 against the Pallas body (it sums tile by tile). The CUDA
kernel itself is compared on the card (``chip_smoke.py`` and
``tests/test_torch_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mga_yolo_tpu.ops.pallas.masked_pool as jmp
from mga_yolo_tpu.models.attention import MaskCBAM as JMaskCBAM
from mga_yolo_tpu_torch.models.attention import MaskCBAM
from mga_yolo_tpu_torch.ops import cam_gate as tcg
from tests._torch_port import few_torch_threads, load_layer, nchw, nhwc  # noqa: F401  (a module fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def _case(kind, b=2, h=8, w=8, c=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    if kind == "tiny":          # all-zero mask: GAP blend for the average
        m = np.zeros((b, h, w, 1), np.float32)
    elif kind == "no_pixel":    # no pixel above 0.5: GAP fallback for the max
        m = rng.uniform(0.05, 0.45, (b, h, w, 1)).astype(np.float32)
    else:
        m = (rng.uniform(0, 1, (b, h, w, 1)) ** 2).astype(np.float32)
    hid = max(1, c // 16)
    w1 = rng.normal(0, 0.2, (c, hid)).astype(np.float32)
    b1 = rng.normal(0, 0.2, (hid,)).astype(np.float32)
    w2 = rng.normal(0, 0.2, (hid, c)).astype(np.float32)
    b2 = rng.normal(0, 0.2, (c,)).astype(np.float32)
    return x, m, w1, b1, w2, b2


def _port(x, m, w1, b1, w2, b2):
    """Port layout: NCHW activations, nn.Linear (out, in) weights."""
    t = torch.from_numpy
    return nchw(x), nchw(m), t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2)


CASES = {
    "random": dict(kind="random"),
    "tiny": dict(kind="tiny"),
    "no_pixel": dict(kind="no_pixel"),
    "ragged_16x7": dict(kind="random", h=7, w=16, seed=4),  # N = 16*7
    "p5_width": dict(kind="random", h=5, w=5, c=256, seed=5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cam_gate_ref_matches_xla(case):
    x, m, w1, b1, w2, b2 = _case(**CASES[case])
    want = jmp._cam_gate_ref(jnp.asarray(x), jnp.asarray(m), w1, b1, w2, b2, 1e-4, 1e-6)
    got = tcg.cam_gate_ref(*_port(x, m, w1, b1, w2, b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_cam_gate_ref_matches_pallas_interpret(case):
    from jax.experimental import pallas as pl

    x, m, w1, b1, w2, b2 = _case(**CASES[case])
    b, h, w, c = x.shape
    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    jmp.pl.pallas_call = interp_call
    try:
        want = jmp._cam_gate_pallas(
            jnp.asarray(x.reshape(b, h * w, c)), jnp.asarray(m.reshape(b, h * w, 1)),
            w1, b1, w2, b2, tiny_thr=1e-4, eps=1e-6, rows_tile=16,
        )
    finally:
        jmp.pl.pallas_call = orig
    got = tcg.cam_gate_ref(*_port(x, m, w1, b1, w2, b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cam_gate_wrapper_takes_plain_version_on_cpu_only():
    args = _port(*_case("random"))
    before = tcg.launches
    torch.testing.assert_close(tcg.cam_gate(*args), tcg.cam_gate_ref(*args), rtol=0, atol=0)
    assert tcg.launches == before  # no kernel launch for CPU tensors
    with pytest.raises(ValueError, match="no kernel"):
        tcg.cam_gate(*(a.to("meta") for a in args))


@pytest.mark.parametrize("case", ["random", "tiny"])
def test_mask_cbam_matches_flax(case):
    x, m_prob, *_ = _case(case, c=32, seed=9)
    # MaskCBAM takes mask logits; give both the same logits
    logits = np.log(np.clip(m_prob, 1e-6, 1 - 1e-6) / np.clip(1 - m_prob, 1e-6, 1)).astype(np.float32)
    if case == "tiny":
        logits = np.full_like(m_prob, -30.0)
    jmod = JMaskCBAM(channels=32, use_pallas=True)  # CPU: the fused gate's XLA path
    variables = jmod.init(jax.random.PRNGKey(0), x, logits)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["beta"] = np.asarray(0.7, np.float32)  # a non-zero residual weight
    want = jmod.apply({"params": params}, x, logits)
    tmod = load_layer(MaskCBAM(32), "MaskCBAM", params)
    with torch.no_grad():
        got = tmod(nchw(x), nchw(logits))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-5)
