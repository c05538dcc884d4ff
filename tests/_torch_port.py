"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Weights and inputs are made once with a numpy seed and handed to both the
JAX package and the port, so the two are compared on identical numbers.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax
import numpy as np
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
