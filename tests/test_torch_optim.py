"""PyTorch port, ``train/optim.py`` against the JAX package.

Parameter groups of the flagship (the port's tags against JAX's
``param_groups`` carried through the weight converter), two steps of every
optimizer from the same parameters, gradients and slots, the global-norm
clip, ``resolve_optimizer``, ``Schedule`` and the ramped EMA. Float32 on the
CPU; tolerance rtol 1e-5 / atol 1e-7 (the same operations, float32 scalars
rounded once on either side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mga_yolo_tpu.train import optim as J
from mga_yolo_tpu_torch.train import optim as T
from tests._torch_port import few_torch_threads  # noqa: F401  (a module fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

TOL = dict(rtol=1e-5, atol=1e-7)


def test_param_groups_match_jax_through_the_converter():
    from mga_yolo_tpu.models.yolo import create_model as jcreate
    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.train.state import create_train_state
    from mga_yolo_tpu_torch.utils.jax_weights import params_from_jax

    jmodel, _ = jcreate("configs/models/yolov8_cbam.yaml", scale="n", nc=1)
    shapes = jax.eval_shape(lambda r, x: jmodel.init(r, x, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    shapes = {**shapes, "mtl_log_vars": jax.ShapeDtypeStruct((2,), jnp.float32)}
    tags = jax.tree_util.tree_map(lambda t, s: np.full(s.shape, t, np.float32), J.param_groups(shapes), shapes)
    tmodel, tspec = create_model(YOLOV8_CBAM, scale="n", nc=1, device="cpu")
    want = {k: int(v.reshape(-1)[0]) for k, v in params_from_jax(tags, tspec).items()}
    got = create_train_state(tmodel).groups
    assert got == want
    assert {t: sum(v == t for v in got.values()) for t in (0, 1, 2)} == {
        t: sum(v == t for v in want.values()) for t in (0, 1, 2)}
    assert got["mtl_log_vars"] == 1 and got["model.23.beta"] == 1 and got["model.23.sam_conv.weight"] == 0
    assert got["model.0.bn.bias"] == 2 and got["model.0.bn.weight"] == 1 and "model.28.dfl.conv.weight" not in got


def _tree(seed):
    """Params, grads and groups shaped like a conv, a Linear, a BN and mtl_log_vars."""
    rng = np.random.default_rng(seed)
    shapes = {"conv.weight": ((8, 4, 3, 3), 0), "fc.weight": ((6, 8), 0), "fc.bias": ((6,), 2),
              "bn.weight": ((8,), 1), "bn.bias": ((8,), 2), "mtl_log_vars": ((2,), 1)}
    p = {k: rng.normal(0, 1, s).astype(np.float32) for k, (s, _) in shapes.items()}
    g = [{k: rng.normal(0, 0.5, s).astype(np.float32) for k, (s, _) in shapes.items()} for _ in range(2)]
    return p, g, {k: t for k, (_, t) in shapes.items()}


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw", "rmsprop"])
def test_two_updates_match_jax(opt):
    p, grads, groups = _tree(1)
    wd, lr, lr_bias, mom = 5e-4, 0.01, 0.05, 0.9
    jfn = J.make_update_fn(opt, wd)
    jp, js = {k: jnp.asarray(v) for k, v in p.items()}, J.init_opt_state(opt, p)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ts = T.init_opt_state(opt, tp)
    tfn = T.make_update_fn(opt, wd)
    for i, g in enumerate(grads, start=1):
        jp, js = jfn(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, groups, lr, lr_bias, mom,
                     jnp.asarray(i, jnp.int32))
        tfn(tp, {k: torch.from_numpy(v.copy()) for k, v in g.items()}, ts, groups, lr, lr_bias, mom, i)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), err_msg=k, **TOL)
        for slot in js:
            np.testing.assert_allclose(ts[slot][k].numpy(), np.asarray(js[slot][k]), err_msg=f"{slot} {k}", **TOL)


@pytest.mark.parametrize("scale", [0.01, 100.0], ids=["under", "over"])
def test_clip_by_global_norm_matches_jax(scale):
    _, (g, _), _ = _tree(2)
    g = {k: v * scale for k, v in g.items()}
    want = J.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 10.0)
    got = [torch.from_numpy(v.copy()) for v in g.values()]
    T.clip_by_global_norm(got, 10.0)
    for t, k in zip(got, g):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-8)


def test_resolve_optimizer_and_schedule_match_jax():
    for args in (("auto", 1, 20000, 0.01, 0.937, 0.1), ("auto", 3, 500, 0.01, 0.937, 0.1),
                 ("SGD", 1, 10, 0.02, 0.9, 0.1), ("NAdam", 1, 10, 0.001, 0.9, 0.0),
                 ("AdamW", 1, 10, 0.001, 0.9, 0.0), ("RMSProp", 1, 10, 0.001, 0.9, 0.0)):
        assert T.resolve_optimizer(*args).__dict__ == J.resolve_optimizer(*args).__dict__
    with pytest.raises(ValueError, match="unknown optimizer"):
        T.resolve_optimizer("lion", 1, 10, 0.01, 0.9, 0.1)
    for cos in (False, True):
        kw = dict(lr0=0.01, lrf=0.01, momentum=0.937, warmup_epochs=3.0, warmup_momentum=0.8,
                  warmup_bias_lr=0.1, epochs=10, steps_per_epoch=50, cos_lr=cos)
        ts, js = T.Schedule(**kw), J.Schedule(**kw)
        assert ts.warmup_steps == js.warmup_steps == 150
        for step in (0, 1, 75, 149, 150, 151, 320, 499):
            assert ts.at(step) == js.at(step)


@pytest.mark.parametrize("updates", [1, 7, 3000])
def test_ema_update_matches_jax(updates):
    p, (g, _), _ = _tree(3)
    want = J.ema_update({k: jnp.asarray(v) for k, v in p.items()}, {k: jnp.asarray(v) for k, v in g.items()},
                        jnp.asarray(updates, jnp.int32), 0.9999, 2000.0)
    ema = [torch.from_numpy(v.copy()) for v in p.values()]
    T.ema_update(ema, [torch.from_numpy(v) for v in g.values()], updates, 0.9999, 2000.0)
    for t, k in zip(ema, p):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[k]), **TOL)
