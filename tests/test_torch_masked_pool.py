"""PyTorch port, masked-pool kernel and MaskECA: plain versions against the
JAX package.

``masked_pool_ref`` (what a CPU tensor runs) is held against
``masked_pool_fused(..., use_pallas=False)`` (``_reductions_xla`` +
``_combine``) and against the Pallas kernel body run by the interpreter
(``_reductions_pallas`` + ``_combine``), on identical numpy inputs in
float32: rtol 1e-5 / atol 1e-6 against XLA (the same float32 reductions in
another summation order) and atol 1e-5 against the Pallas body (it sums tile
by tile). ``masked_pool_bwd_ref`` (the kernel's backward) and autograd
through ``masked_pool_ref`` are held against ``jax.vjp`` of
``masked_pool_fused`` (its analytic ``_bwd``) to rtol 1e-4 / atol 1e-5, with
a cotangent on the average only (as MaskECA gives) and on both outputs.
MaskECA is held against flax ``MaskECA(use_pallas=True)`` (the fused pool's
XLA route on the CPU) to rtol 1e-4 / atol 1e-5. The CUDA kernel itself is
compared on the card (``chip_smoke.py`` and ``tests/test_torch_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mga_yolo_tpu.ops.pallas.masked_pool as jmp
from mga_yolo_tpu.models.attention import MaskECA as JMaskECA
from mga_yolo_tpu.models.attention import eca_kernel_size as jeca_kernel_size
from mga_yolo_tpu_torch.models.attention import MaskECA, eca_kernel_size
from mga_yolo_tpu_torch.ops import masked_pool as tmp
from tests._torch_port import few_torch_threads, load_layer, nchw, nhwc  # noqa: F401  (a module fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def _case(kind, b=2, h=8, w=8, c=32, seed=0):
    """NHWC features and (B, H, W, 1) mask probabilities, float32."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    if kind == "ties":          # coarse values: several pixels share a channel's max
        x = np.round(x * 2) / 2
    if kind == "tiny":          # all-zero mask: GAP blend for the average
        m = np.zeros((b, h, w, 1), np.float32)
    elif kind == "no_pixel":    # no pixel above 0.5: GAP fallback for the max
        m = rng.uniform(0.05, 0.45, (b, h, w, 1)).astype(np.float32)
    else:
        m = (rng.uniform(0, 1, (b, h, w, 1)) ** 2).astype(np.float32)
    return x, m


CASES = {
    "random": dict(kind="random"),
    "tiny": dict(kind="tiny"),
    "no_pixel": dict(kind="no_pixel"),
    "ragged_16x7": dict(kind="random", h=7, w=16, seed=4),  # N = 16*7
    "c256": dict(kind="random", h=5, w=5, c=256, seed=5),
}
GRAD_CASES = {**CASES, "ties": dict(kind="ties", seed=6)}


@pytest.mark.parametrize("case", list(CASES))
def test_masked_pool_ref_matches_xla(case):
    x, m = _case(**CASES[case])
    want = jmp.masked_pool_fused(jnp.asarray(x), jnp.asarray(m), 1e-4, 1e-6, False)
    got = tmp.masked_pool_ref(nchw(x), nchw(m))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_masked_pool_ref_matches_pallas_interpret(case):
    from jax.experimental import pallas as pl

    x, m = _case(**CASES[case])
    b, h, w, c = x.shape
    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    jmp.pl.pallas_call = interp_call
    try:
        reds = jmp._reductions_pallas(jnp.asarray(x.reshape(b, h * w, c)), jnp.asarray(m.reshape(b, h * w, 1)),
                                      rows_tile=16)
        want = jmp._combine(reds, h * w, 1e-4, 1e-6, jnp.float32)
    finally:
        jmp.pl.pallas_call = orig
    got = tmp.masked_pool_ref(nchw(x), nchw(m))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cotangent", ["avg", "both"])
@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_masked_pool_backward_matches_jax_vjp(case, cotangent):
    x, m = _case(**GRAD_CASES[case])
    b, c = x.shape[0], x.shape[-1]
    rng = np.random.default_rng(11)
    ga = rng.normal(0, 1, (b, c)).astype(np.float32)
    gm = rng.normal(0, 1, (b, c)).astype(np.float32) if cotangent == "both" else None
    _, vjp = jax.vjp(lambda a, k: jmp.masked_pool_fused(a, k, 1e-4, 1e-6, False), jnp.asarray(x), jnp.asarray(m))
    want = vjp((jnp.asarray(ga), jnp.asarray(gm if gm is not None else np.zeros_like(ga))))

    tga, tgm = torch.from_numpy(ga), None if gm is None else torch.from_numpy(gm)
    analytic = tmp.masked_pool_bwd_ref(nchw(x), nchw(m), tga, tgm)
    leaves = [nchw(x).requires_grad_(True), nchw(m).requires_grad_(True)]
    avg, mx = tmp.masked_pool_ref(*leaves)
    loss = (avg * tga).sum() + (0 if tgm is None else (mx * tgm).sum())
    autograd = torch.autograd.grad(loss, leaves)
    for got in (analytic, autograd):
        for g, w in zip(got, want):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_masked_pool_wrapper_takes_plain_version_on_cpu_only():
    x, m = (nchw(a) for a in _case("random"))
    before = tmp.launches
    for got, want in zip(tmp.masked_pool(x, m), tmp.masked_pool_ref(x, m)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tmp.launches == before  # no kernel launch for CPU tensors
    with pytest.raises(ValueError, match="no kernel"):
        tmp.masked_pool(x.to("meta"), m.to("meta"))


@pytest.mark.parametrize("channels", [1, 16, 32, 64, 100, 128, 256, 512, 1024, 4096])
def test_eca_kernel_size_matches_jax(channels):
    assert eca_kernel_size(channels) == jeca_kernel_size(channels)


@pytest.mark.parametrize("case", ["random", "tiny", "no_mask"])
def test_mask_eca_matches_flax(case):
    x, m_prob = _case("tiny" if case == "tiny" else "random", c=32, seed=9)
    # MaskECA takes mask logits; give both the same logits
    logits = np.log(np.clip(m_prob, 1e-6, 1 - 1e-6) / np.clip(1 - m_prob, 1e-6, 1)).astype(np.float32)
    if case == "tiny":
        logits = np.full_like(m_prob, -30.0)
    mask = None if case == "no_mask" else logits
    jmod = JMaskECA(channels=32, use_pallas=True)  # CPU: masked_pool_fused's XLA route
    variables = jmod.init(jax.random.PRNGKey(0), x, mask)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["beta"] = np.asarray(0.7, np.float32)  # a non-zero gate weight
    want = jmod.apply({"params": params}, x, mask)
    tmod = load_layer(MaskECA(32), "MaskECA", params)
    with torch.no_grad():
        got = tmod(nchw(x), None if mask is None else nchw(mask))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_mask_eca_refuses_a_mask_of_another_size():
    x, m = _case("random")
    with pytest.raises(ValueError, match="does not match"):
        MaskECA(32)(nchw(x), nchw(m)[:, :, :4])
