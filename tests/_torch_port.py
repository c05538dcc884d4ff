"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Weights and inputs are made once with a numpy seed and handed to both the
JAX package and the port, so the two are compared on identical numbers.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def to_numpy_tree(tree):
    """jax.device_get of a variable tree, as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def perturb_bn(variables, seed: int = 0):
    """Give every BatchNorm non-trivial statistics and affine parameters so a
    BN fold or a missed BN shows up (flax initialises them to identity)."""
    rng = np.random.default_rng(seed)
    v = to_numpy_tree(variables)

    def walk(params, stats):
        if isinstance(params, dict) and "scale" in params and "bias" in params:
            n = params["scale"].shape[0]
            params["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            params["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
            if stats is not None:
                stats["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
                stats["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            return
        if isinstance(params, dict):
            for k in params:
                walk(params[k], stats.get(k) if isinstance(stats, dict) else None)

    walk(v["params"], v.get("batch_stats"))
    return v


def load_layer(torch_module: torch.nn.Module, module_name: str, params, stats=None,
               legacy_detect: bool = False) -> torch.nn.Module:
    """Load one flax module's variables into the matching port module, through
    the port's own converter (as layer ``l0_<module_name>``)."""
    from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax

    variables = {"params": {f"l0_{module_name}": params}}
    if stats is not None:
        variables["batch_stats"] = {f"l0_{module_name}": stats}
    sd = state_dict_from_jax(variables, SimpleNamespace(legacy_detect=legacy_detect))
    sd = {k[len("model.0."):]: v for k, v in sd.items()}
    torch_module.load_state_dict(sd, strict=True)
    return torch_module.eval()


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def model_pair(cfg: str, imgsz: int, jax_kw: dict | None = None) -> dict:
    """The JAX model of ``cfg`` (scale n, nc=1, eval) with perturbed BN
    statistics and a zero class bias (every anchor clears the confidence
    threshold, so NMS has real work), and the port's model carrying the same
    weights, on the CPU; plus a float32 NHWC batch of 2."""
    from mga_yolo_tpu.models.yolo import create_model as jcreate
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax

    jmodel, jspec = jcreate(cfg, scale="n", nc=1, **(jax_kw or {}))
    variables = jax.jit(lambda r, x: jmodel.init(r, x, train=False))(
        jax.random.PRNGKey(0), np.zeros((1, imgsz, imgsz, 3), np.float32)
    )
    v = perturb_bn(variables, seed=1)
    detect = next(k for k in v["params"] if k.endswith("_Detect"))
    for k, p in v["params"][detect].items():
        if k.startswith("cv3_") and k.endswith("_2"):
            p["bias"] = np.zeros_like(p["bias"])
    tmodel, tspec = create_model(cfg, scale="n", nc=1, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(v, tspec), strict=True)
    x = np.random.default_rng(2).random((2, imgsz, imgsz, 3)).astype(np.float32)
    return dict(jmodel=jmodel, jspec=jspec, v=v, tmodel=tmodel, tspec=tspec, x=x)


def assert_dets_match(got, want, rtol=1e-3, atol=2e-3):
    """Same detections, matched by nearest box (near-equal scores may swap rank)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    for row in got:
        err = np.abs(want[:, :5] - row[:5]).max(1)
        j = int(np.argmin(err))
        np.testing.assert_allclose(row[:5], want[j, :5], rtol=rtol, atol=atol)
        assert row[5] == want[j, 5]


def train_batch(b: int, imgsz: int, seed: int = 7) -> dict:
    """The JAX package's train batch dict: uint8 NHWC images, 3 and 1 boxes
    (the rest padding), and the masks those boxes draw at strides 8/16/32."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, 4, 4), np.float32)
    mask_gt = np.zeros((b, 4), np.float32)
    for i, n in enumerate((3, 1)):
        xy = rng.uniform(0, 36, (n, 2))
        boxes[i, :n] = np.concatenate([xy, xy + rng.uniform(16, 28, (n, 2))], -1)
        mask_gt[i, :n] = 1
    masks = []
    for s in (8, 16, 32):
        m = np.zeros((b, imgsz // s, imgsz // s, 1), np.float32)
        c = (np.arange(imgsz // s) + 0.5) * s
        for i in range(b):
            for x1, y1, x2, y2 in boxes[i, mask_gt[i] > 0]:
                m[i, (c[:, None] >= y1) & (c[:, None] <= y2) & (c[None] >= x1) & (c[None] <= x2), 0] = 1
        masks.append(m)
    return {"image": rng.integers(0, 256, (b, imgsz, imgsz, 3)).astype(np.uint8), "gt_boxes": boxes,
            "gt_labels": np.zeros((b, 4), np.int32), "mask_gt": mask_gt, "masks": masks}


def jax_init(jmodel, imgsz: int) -> dict:
    """``jmodel``'s variables from ``PRNGKey(0)``, as numpy: the init that
    the JAX package's ``create_train_state`` jits (the same program, so the
    same values)."""
    x = jnp.zeros((1, imgsz, imgsz, 3), jnp.float32)
    return to_numpy_tree(jax.jit(functools.partial(jmodel.init, train=False))(jax.random.PRNGKey(0), x))


def jax_train_state(params: dict, batch_stats: dict):
    """The JAX package's SGD ``TrainState`` at step 0 holding ``params``
    (with ``mtl_log_vars``) and ``batch_stats``, its EMA equal to them and a
    zero accumulation buffer: what ``create_train_state`` builds, with the
    flat buffers concatenated on the host (the eager ``flatten_tree``
    compiles a program a leaf shape)."""
    from mga_yolo_tpu.train import optim as JO
    from mga_yolo_tpu.train.state import TrainState

    def flat(tree):
        return jnp.asarray(np.concatenate([np.ravel(np.asarray(a)).astype(np.float32)
                                           for a in jax.tree_util.tree_leaves(tree)]))

    total = JO.FlatMeta(params).total
    zero = jnp.zeros((), jnp.int32)
    return TrainState(step=zero, opt_step=zero, last_apply=zero, params=jax.tree_util.tree_map(jnp.asarray, params),
                      batch_stats=jax.tree_util.tree_map(jnp.asarray, batch_stats),
                      opt_state=JO.init_flat_opt_state("sgd", total), ema_params=flat(params),
                      ema_batch_stats=flat(batch_stats), groups=JO.param_groups(params),
                      accum_grads=jnp.zeros((total,), jnp.float32))


def train_step_run(cfg: str, imgsz: int, step_kw: dict, lr: tuple, jax_kw: dict | None = None,
                   n_steps: int = 3, b: int = 2, port_kw: dict | None = None, on_weights=None) -> dict:
    """Both packages' train states after each of ``n_steps`` micro-steps
    from the same state: the JAX model's weights with perturbed BN statistics
    and ``mtl_log_vars`` = (0.2, -0.3). ``step_kw`` goes to both
    ``make_train_step``s, ``lr`` = (lr, lr_bias, momentum) to every step;
    ``jax_kw`` / ``port_kw`` go to the two packages' ``create_model``.

    Returns ``views`` [(port view, JAX view)] per micro-step (each a dict of
    loss, items, params, bn, m, ema, ema_bn, opt_step) and the states, steps
    and batches for further use. ``on_weights(state_dict)``, if given, gets
    the port's starting weights before the first step (before the JAX step
    compiles)."""
    from mga_yolo_tpu.losses.detection import DetLossConfig as JDet
    from mga_yolo_tpu.losses.segmentation import SegLossConfig as JSeg
    from mga_yolo_tpu.models.yolo import create_model as jcreate
    from mga_yolo_tpu.train import optim as JO
    from mga_yolo_tpu.train import state as JS
    from mga_yolo_tpu_torch.losses import DetLossConfig, SegLossConfig
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.train import state as TS
    from mga_yolo_tpu_torch.utils.jax_weights import bn_stats_from_jax, params_from_jax, state_dict_from_jax

    jmodel, _ = jcreate(cfg, scale="n", nc=1, **(jax_kw or {}))
    v = perturb_bn(jax_init(jmodel, imgsz), seed=3)
    mtl = np.array([0.2, -0.3], np.float32)
    params = {**v["params"], "mtl_log_vars": mtl}
    st = jax_train_state(params, v["batch_stats"])
    jstep = jax.jit(JS.make_train_step(jmodel, (8, 16, 32), 1, JDet(), JSeg(), **step_kw))
    tmodel, tspec = create_model(cfg, scale="n", nc=1, device="cpu", training=True, **(port_kw or {}))
    tmodel.load_state_dict(state_dict_from_jax(v, tspec), strict=True)
    ts = TS.create_train_state(tmodel)
    with torch.no_grad():
        ts.mtl_log_vars.copy_(torch.from_numpy(mtl))
        ts.ema_params["mtl_log_vars"].copy_(torch.from_numpy(mtl))
    tstep = TS.make_train_step(tmodel, (8, 16, 32), 1, DetLossConfig(), SegLossConfig(), **step_kw)
    batch = train_batch(b, imgsz)

    def jax_view(s, metrics):
        p = to_numpy_tree(s.params)
        meta = JO.FlatMeta(s.params)
        # the flat buffers are cut up on the host: eager slices would compile one program a leaf
        return {
            "loss": float(metrics["loss"]), "items": np.asarray(metrics["items"]),
            "params": params_from_jax(p, tspec),
            "bn": bn_stats_from_jax(p, to_numpy_tree(s.batch_stats), tspec),
            "m": params_from_jax(meta.unflatten(np.asarray(s.opt_state["m"])), tspec),
            "ema": params_from_jax(meta.unflatten(np.asarray(s.ema_params)), tspec),
            "ema_bn": bn_stats_from_jax(p, JO.FlatMeta(s.batch_stats).unflatten(np.asarray(s.ema_batch_stats)),
                                        tspec),
            "opt_step": int(s.opt_step),
        }

    def torch_view(s, metrics):
        clone = lambda d: {k: t.detach().clone() for k, t in d.items()}  # noqa: E731
        return {"loss": float(metrics["loss"]), "items": metrics["items"].numpy(), "params": clone(s.params()),
                "bn": clone(s.bn_stats()), "m": clone(s.opt_state["m"]), "ema": clone(s.ema_params),
                "ema_bn": clone(s.ema_bn_stats), "opt_step": s.opt_step}

    jbatch = {**batch, "masks": [jnp.asarray(m) for m in batch["masks"]]}
    if on_weights is not None:
        on_weights(state_dict_from_jax(v, tspec))
    views = []
    for _ in range(n_steps):
        st, jm = jstep(st, jbatch, *lr, jax.random.PRNGKey(1))
        ts, tm = tstep(ts, batch, *lr)
        views.append((torch_view(ts, tm), jax_view(st, jm)))
    return {"views": views, "jmodel": jmodel, "jstate": st, "tmodel": tmodel, "tstate": ts, "batch": batch,
            "jbatch": jbatch, "v": v, "tspec": tspec, "mtl": mtl}


def close_dict(got, want, what, rtol=0.0, atol=1e-6, rel_to_max=False):
    """Every tensor of ``got`` against ``want`` (same keys); with
    ``rel_to_max`` the atol scales with each tensor's max |want|."""
    assert set(got) == set(want), what
    for k in want:
        w = want[k].numpy()
        a = atol * max(float(np.abs(w).max()), 1e-30) if rel_to_max else atol
        np.testing.assert_allclose(got[k].numpy(), w, rtol=rtol, atol=a, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def few_torch_threads():
    """Two intra-op threads for the module's torch work, restored after: the
    suite runs in several processes on one machine, and torch's default of a
    thread per core in each makes them wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def seeded_variables(jmodel, imgsz: int, seed: int = 0) -> dict:
    """Variables for ``jmodel`` made with a numpy seed, with no JAX compile:
    the tree's shapes from ``jax.eval_shape`` of ``init``; kernels normal
    with std 1/sqrt(fan-in), every other parameter N(0, 0.1), BN statistics
    and affine parameters perturbed (:func:`perturb_bn`), the Detect class
    biases zero (so every anchor clears a low confidence threshold)."""
    shapes = jax.eval_shape(lambda r, x: jmodel.init(r, x, train=False), jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, imgsz, imgsz, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(s.dtype)
        return (rng.standard_normal(s.shape) * 0.1).astype(s.dtype)

    v = perturb_bn(jax.tree_util.tree_map_with_path(fill, shapes), seed=seed + 1)
    detect = next(k for k in v["params"] if k.endswith("_Detect"))
    for k, p in v["params"][detect].items():
        if k.startswith("cv3_") and k.endswith("_2"):
            p["bias"] = np.zeros_like(p["bias"])
    return v
