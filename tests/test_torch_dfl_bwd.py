"""PyTorch port, the fused DFL backward's plain version against the JAX package.

``ops/dfl_bwd.py`` ``dfl_decode_ce_bwd_ref`` (the CPU path of the kernel
``csrc/dfl_bwd.cu``) against the jnp branch of ``_dfl_decode_ce_bwd``
(``losses/detection.py``) and against both Pallas kernels run in interpret
mode, as tests/test_dfl_bwd_pallas.py runs them. Tolerances are that
file's: float32 rtol/atol 2e-6; bfloat16 rtol 8e-3 / atol 2e-4 (an f32
intermediate one ulp apart can round to the other side of a bf16 boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mga_yolo_tpu.losses.detection import _dfl_decode_ce_bwd, _dfl_decode_primal, dfl_decode_ce
from mga_yolo_tpu.ops.pallas.dfl_bwd import dfl_decode_ce_bwd_pallas, dfl_decode_ce_bwd_pallas_planar
from mga_yolo_tpu_torch.ops import dfl_bwd as tdfl
from tests._torch_port import few_torch_threads  # noqa: F401  (a module fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

TOL = {"f32": (2e-6, 2e-6), "bf16": (8e-3, 2e-4)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _case(B=2, A=84, R=16, seed=0, edges=True):
    """pd (B, A, 4, R) and float32 aux, with integer targets and +-40 logits."""
    rng = np.random.default_rng(seed)
    pd = rng.normal(0, 3, (B, A, 4, R)).astype(np.float32)
    g_ltrb = rng.normal(0, 1, (B, A, 4)).astype(np.float32)
    g_ce = rng.uniform(0, 2, (B, A)).astype(np.float32)
    target = rng.uniform(0, R - 1, (B, A, 4)).astype(np.float32)
    if edges:
        target[0, :4] = np.floor(target[0, :4])   # wl = 1
        pd[0, 0] = 40.0
        pd[0, 1] = -40.0
    return pd, g_ltrb, g_ce, target


def _both(pd, g_ltrb, g_ce, target, dt):
    """(port dz, JAX inputs) on the same numbers; ltrb is JAX's decode."""
    jpd = jnp.asarray(pd, JDT[dt])
    ltrb = np.asarray(_dfl_decode_primal(jpd), np.float32)
    tpd = torch.from_numpy(np.array(jpd.astype(jnp.float32))).to(TDT[dt])
    got = tdfl.dfl_decode_ce_bwd(tpd, *(torch.from_numpy(a) for a in (ltrb, g_ltrb, g_ce, target)))
    return got, (jpd, ltrb, g_ltrb, g_ce, target)


def _close(got, want, dt):
    rtol, atol = TOL[dt]
    assert got.dtype == TDT[dt]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [dict(), dict(B=1, A=1050, seed=1, edges=False)], ids=["B2A84", "ragged_A1050"])
def test_plain_matches_jnp_branch(dt, shape):
    got, (jpd, ltrb, g_ltrb, g_ce, target) = _both(*_case(**shape), dt)
    # the jnp branch itself: the custom VJP of dfl_decode_ce off the TPU
    want, _ = _dfl_decode_ce_bwd((jpd, ltrb.transpose(2, 0, 1), target.transpose(2, 0, 1)),
                                 (g_ltrb.transpose(2, 0, 1), g_ce))
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [dict(), dict(B=1, A=1050, seed=1, edges=False)], ids=["B2A84", "ragged_A1050"])
def test_plain_matches_pallas_kernels(dt, shape):
    got, (jpd, ltrb, g_ltrb, g_ce, target) = _both(*_case(**shape), dt)
    v1 = dfl_decode_ce_bwd_pallas(jpd, ltrb, g_ltrb, g_ce, target, interpret=True)
    v2 = dfl_decode_ce_bwd_pallas_planar(jpd, ltrb.transpose(2, 0, 1), g_ltrb.transpose(2, 0, 1), g_ce,
                                         target.transpose(2, 0, 1), interpret=True)
    _close(got, v1, dt)
    _close(got, v2, dt)


@pytest.mark.parametrize("R", [8, 16, 32, 64])
def test_plain_matches_jnp_branch_every_reg_max(R):
    """Every R the kernel accepts, including 64, where the JAX planar
    wrapper crashes (its row packing needs 128 % (4 R) == 0)."""
    pd, g_ltrb, g_ce, target = _case(B=2, A=21, R=R, seed=R)
    got, (jpd, ltrb, *_) = _both(pd, g_ltrb, g_ce, target, "f32")
    want, _ = _dfl_decode_ce_bwd((jpd, ltrb.transpose(2, 0, 1), target.transpose(2, 0, 1)),
                                 (g_ltrb.transpose(2, 0, 1), g_ce))
    _close(got, want, "f32")


def test_planar_views_give_the_same_dz():
    """A permuted view of planar (4, B, A) aux equals its (B, A, 4) copy."""
    pd, g_ltrb, g_ce, target = (torch.from_numpy(a) for a in _case())
    ltrb = torch.randn(2, 84, 4)
    planar = [t.permute(2, 0, 1).contiguous().permute(1, 2, 0) for t in (ltrb, g_ltrb, target)]
    assert not planar[0].is_contiguous()
    a = tdfl.dfl_decode_ce_bwd(pd, ltrb, g_ltrb, g_ce, target)
    b = tdfl.dfl_decode_ce_bwd(pd, planar[0], planar[1], g_ce, planar[2])
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_ce_function_matches_jax_vjp(dt):
    """DflDecodeCE (forward values and backward) against JAX's dfl_decode_ce."""
    from mga_yolo_tpu_torch.losses.detection import DflDecodeCE

    pd, g_ltrb, g_ce, target = _case(B=2, A=30, seed=3)
    jpd = jnp.asarray(pd, JDT[dt])
    (lt_j, ce_j), vjp = jax.vjp(dfl_decode_ce, jpd, jnp.asarray(target.transpose(2, 0, 1)))
    dz_j, _ = vjp((jnp.asarray(g_ltrb.transpose(2, 0, 1)), jnp.asarray(g_ce)))

    tpd = torch.from_numpy(np.array(jpd.astype(jnp.float32))).to(TDT[dt]).requires_grad_(True)
    lt, ce = DflDecodeCE.apply(tpd, torch.from_numpy(target))
    assert lt.dtype == ce.dtype == torch.float32
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lt_j).transpose(1, 2, 0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(ce_j), rtol=1e-5, atol=1e-5)
    dz, = torch.autograd.grad((lt, ce), tpd, (torch.from_numpy(g_ltrb), torch.from_numpy(g_ce)))
    # here each side uses its own decode, whose float32 sums differ in the
    # last ulp and enter dz through (j - ltrb) * g_ltrb: f32 tolerance 1e-5
    rtol, atol = (1e-5, 1e-5) if dt == "f32" else TOL[dt]
    np.testing.assert_allclose(dz.float().numpy(), np.asarray(dz_j, np.float32), rtol=rtol, atol=atol)
