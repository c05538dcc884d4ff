"""PyTorch port, the probabilistic mask gate (``ProbMaskGater``, MaskCBAM's
``prob_mode``) against the JAX package.

Eval mode and ``deterministic`` mode are exactly the JAX gate. The random
modes draw from a ``torch.Generator`` where JAX draws from its ``"gater"``
RNG stream, so they are held to their distributions over 10^5 draws (from a
seeded generator, so each run draws the same numbers):
``bernoulli_detach`` has mean p within 0.01; a ``gumbel`` sample is above
1/2 with probability p (logit(p) + logistic noise > 0), within 0.01, and its
noise, recovered at p = 1/2 as logit(M), has mean within 1% of the noise's
standard deviation pi / sqrt(3) of 0 and variance within 1% of pi^2 / 3;
``hard_st`` is in {0, 1}, above 1/2 as often, and its gradient is the soft
sample's. The flagship's train step with ``prob_mode`` in
``deterministic`` mode matches JAX's at 128 px with the tolerances of
tests/test_torch_train_step.py, but one: the momentum of the three scalar
``beta``s is held to 1e-3 (2e-2 after step 1) of the largest of the three,
not of itself. P3's beta gradient is a cancellation (the sum of
dL/dout * (sam_out - feat)) about 40 times smaller than the other two, so
float32 sums in another order move it by more than 1e-3 of itself; held
against the group's scale it is checked as the other two are.
"""

import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port import close_dict, few_torch_threads, train_step_run  # noqa: F401  (a module fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

N = 100_000
MODES = ("deterministic", "gumbel", "hard_st", "bernoulli_detach")


def _p(seed=0, shape=(2, 1, 8, 8)):
    # probabilities with values outside [0, 1] as well: the gate clips them
    return np.random.default_rng(seed).uniform(-0.2, 1.2, shape).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_eval_mode_is_the_jax_gate(mode):
    from mga_yolo_tpu.models.attention import ProbMaskGater as JGater
    from mga_yolo_tpu_torch.models.attention import ProbMaskGater

    p = _p()
    want = JGater(mode=mode).apply({}, jnp.asarray(p), False)
    got = ProbMaskGater(mode).eval()(torch.from_numpy(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_deterministic_train_mode_is_the_jax_gate():
    from mga_yolo_tpu.models.attention import ProbMaskGater as JGater
    from mga_yolo_tpu_torch.models.attention import ProbMaskGater

    p = _p(1)
    for p_min in (0.0, 0.3):
        want = JGater(mode="deterministic", p_min=p_min).apply({}, jnp.asarray(p), True)
        got = ProbMaskGater("deterministic", p_min=p_min).train()(torch.from_numpy(p))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _draw(mode, p, seed=0, requires_grad=False):
    from mga_yolo_tpu_torch.models.attention import ProbMaskGater

    pt = torch.full((N,), p, requires_grad=requires_grad)
    g = torch.Generator().manual_seed(seed)
    return pt, ProbMaskGater(mode).train()(pt, g)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_bernoulli_mean_is_p(p):
    pt, m = _draw("bernoulli_detach", p, requires_grad=True)
    assert set(np.unique(m.numpy())) <= {0.0, 1.0}
    assert abs(float(m.mean()) - p) < 0.01
    assert not m.requires_grad  # no gradient to p


@pytest.mark.parametrize("mode", ["gumbel", "hard_st"])
@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_sample_is_above_half_with_probability_p(mode, p):
    _, m = _draw(mode, p, seed=1)
    assert abs(float((m > 0.5).float().mean()) - p) < 0.01
    if mode == "hard_st":
        assert set(np.unique(m.detach().numpy())) <= {0.0, 1.0}
    else:
        assert 0.0 < float(m.min()) and float(m.max()) < 1.0


def test_gumbel_noise_is_logistic():
    _, m = _draw("gumbel", 0.5, seed=2)
    g = torch.logit(m.double())
    var = math.pi ** 2 / 3
    assert abs(float(g.mean())) < 0.01 * math.sqrt(var)
    assert abs(float(g.var()) - var) < 0.01 * var


def test_hard_st_gradient_is_the_soft_samples():
    from mga_yolo_tpu_torch.models.attention import ProbMaskGater

    p = torch.from_numpy(np.random.default_rng(3).uniform(0.05, 0.95, 4096).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(4).normal(0, 1, 4096).astype(np.float32))
    grads = []
    for mode in ("hard_st", "gumbel"):
        x = p.clone().requires_grad_(True)
        (ProbMaskGater(mode).train()(x, torch.Generator().manual_seed(5)) * w).sum().backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
    assert float(grads[0].abs().max()) > 0


def test_random_modes_need_a_generator():
    from mga_yolo_tpu_torch.models.attention import ProbMaskGater

    with pytest.raises(ValueError, match="generator"):
        ProbMaskGater("gumbel").train()(torch.rand(4))
    with pytest.raises(ValueError, match="mode"):
        ProbMaskGater("softmax")


def test_gumbel_model_trains_on_a_seeded_generator():
    """The flagship with ``prob_approach="gumbel"``: the same generator seed
    gives the same step, another seed another; the state_dict keys are the
    flagship's (the gate has no parameters)."""
    from mga_yolo_tpu_torch.losses import DetLossConfig, SegLossConfig
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.train import state as TS
    from tests._torch_port import train_batch

    plain, _ = create_model("configs/models/yolov8_cbam.yaml", scale="n", nc=1, device="cpu")
    losses = []
    for seed in (0, 0, 1):
        torch.manual_seed(0)
        model, _ = create_model("configs/models/yolov8_cbam.yaml", scale="n", nc=1, device="cpu",
                                training=True, prob_approach="gumbel")
        assert set(model.state_dict()) == set(plain.state_dict())
        st = TS.create_train_state(model)
        step = TS.make_train_step(model, (8, 16, 32), 1, DetLossConfig(), SegLossConfig(), 5e-4, 0.9999, 2000.0)
        _, metrics = step(st, train_batch(2, 64), 1e-3, 1e-2, 0.9, torch.Generator().manual_seed(seed))
        losses.append(float(metrics["loss"]))
    assert all(math.isfinite(x) for x in losses)
    assert losses[0] == losses[1] != losses[2]


@pytest.fixture(scope="module")
def run():
    """The flagship with MaskCBAM ``prob_mode`` in ``deterministic`` mode in
    both packages (the JAX graph builder wires no ``prob_mode``, so its
    MaskCBAM is wrapped for the build)."""
    import functools

    from mga_yolo_tpu.models import yolo as jyolo

    kw = dict(weight_decay=5e-4, ema_decay=0.9999, ema_tau=2000.0, accumulate=2, warmup_steps=4)
    gated = functools.partial(jyolo.MaskCBAM, prob_mode=True, prob_approach="deterministic")
    with mock.patch.object(jyolo, "MaskCBAM", gated):
        return train_step_run("configs/models/yolov8_cbam.yaml", 128, kw, (1e-3, 1e-2, 0.9),
                              port_kw=dict(prob_approach="deterministic"))


@pytest.mark.parametrize("i", [0, 1, 2], ids=["step1_apply", "step2_accumulate", "step3_apply"])
def test_prob_mode_train_step_matches_jax(run, i):
    from mga_yolo_tpu_torch.models.attention import MaskCBAM

    assert all(m.gater is not None and m.gater.mode == "deterministic"
               for m in run["tmodel"].modules() if isinstance(m, MaskCBAM))
    t, j = run["views"][i]
    first = i == 0
    assert t["opt_step"] == j["opt_step"] == (1, 1, 2)[i]
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4 if first else 1e-3)
    np.testing.assert_allclose(t["items"], j["items"], rtol=1e-4 if first else 1e-3)
    close_dict(t["params"], j["params"], "params", atol=1e-6)
    betas = [k for k in j["m"] if k.endswith(".beta")]
    rel = 1e-3 if first else 2e-2
    close_dict({k: v for k, v in t["m"].items() if k not in betas}, {k: v for k, v in j["m"].items() if k not in betas},
               "momentum", atol=rel, rel_to_max=True)
    scale = max(float(j["m"][k].abs().max()) for k in betas)
    close_dict({k: t["m"][k] for k in betas}, {k: j["m"][k] for k in betas}, "momentum", atol=rel * scale)
    close_dict(t["bn"], j["bn"], "bn stats", rtol=1e-5 if first else 1e-4, atol=1e-6 if first else 1e-5)
    close_dict(t["ema"], j["ema"], "ema", atol=1e-6)
    close_dict(t["ema_bn"], j["ema_bn"], "ema bn", rtol=1e-5 if first else 1e-4, atol=1e-6 if first else 1e-5)
