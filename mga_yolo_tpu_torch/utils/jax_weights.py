"""Carry weights from the JAX package's variable tree to the port's state_dict.

Input: the ``{"params", "batch_stats"}`` tree as nested dicts of numpy arrays
(``jax.device_get`` of the JAX variables). Output: the reference-keyed
state_dict that ``MGAModel.load_state_dict(..., strict=True)`` takes — the
same keys and values as ``mga_yolo_tpu/utils/torch_export.py``
``export_torch_state_dict`` writes, reproduced here because the port imports
nothing of the JAX package:

    conv kernel (kh, kw, I, O) -> Conv2d weight (O, I, kh, kw)
    dense kernel (I, O)        -> Linear weight (O, I)
    bn scale/bias + mean/var   -> BatchNorm weight/bias/running_mean/running_var
                                  (+ num_batches_tracked = 0)
    analytic DFL projection    -> fixed dfl.conv.weight = arange(reg_max)
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mga_yolo_tpu_torch.graph import GraphSpec


def _conv2d(k) -> np.ndarray:
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _bn(out: dict, prefix: str, p: dict, s: dict | None) -> None:
    n = np.asarray(p["scale"]).shape[0]
    s = s or {}
    out[prefix + ".weight"] = np.asarray(p["scale"])
    out[prefix + ".bias"] = np.asarray(p["bias"])
    out[prefix + ".running_mean"] = np.asarray(s.get("mean", np.zeros(n, np.float32)))
    out[prefix + ".running_var"] = np.asarray(s.get("var", np.ones(n, np.float32)))
    out[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)


def _convbn(out: dict, prefix: str, p: dict, s: dict | None) -> None:
    out[prefix + ".conv.weight"] = _conv2d(p["conv"]["kernel"])
    _bn(out, prefix + ".bn", p["bn"], (s or {}).get("bn"))


def _generic(out: dict, prefix: str, p: dict, s: dict | None) -> None:
    """Conv/C2f/C3k2/C3/SPPF/Bottleneck subtrees: ``cvN`` -> ``cvN.``,
    ``mN`` -> ``m.N.``, a {conv, bn} pair -> ConvBN keys."""
    if "conv" in p and "bn" in p:
        _convbn(out, prefix, p, s)
        return
    s = s or {}
    for k in p:
        sub = f"{prefix}.m.{k[1:]}" if k[0] == "m" and k[1:].isdigit() else f"{prefix}.{k}"
        _generic(out, sub, p[k], s.get(k))


def _mask_head(out: dict, prefix: str, p: dict, s: dict | None) -> None:
    out[prefix + ".proj.0.weight"] = _conv2d(p["proj"]["kernel"])
    _bn(out, prefix + ".proj.1", p["bn"], (s or {}).get("bn"))
    out[prefix + ".head.weight"] = _conv2d(p["head"]["kernel"])
    out[prefix + ".head.bias"] = np.asarray(p["head"]["bias"])


def _cbam(out: dict, prefix: str, p: dict) -> None:
    out[prefix + ".cam_mlp.0.weight"] = np.asarray(p["cam_fc1"]["kernel"]).T
    out[prefix + ".cam_mlp.0.bias"] = np.asarray(p["cam_fc1"]["bias"])
    out[prefix + ".cam_mlp.2.weight"] = np.asarray(p["cam_fc2"]["kernel"]).T
    out[prefix + ".cam_mlp.2.bias"] = np.asarray(p["cam_fc2"]["bias"])
    out[prefix + ".sam_conv.weight"] = _conv2d(p["sam_conv"]["kernel"])
    out[prefix + ".beta"] = np.asarray(p["beta"], np.float32).reshape(())


def _detect(out: dict, prefix: str, p: dict, s: dict | None, legacy: bool, reg_max: int) -> None:
    s = s or {}
    for key in sorted(p):
        parts = key.split("_")
        if key.startswith("cv2_"):
            lvl, j = parts[1], parts[2]
            tp = f"{prefix}.cv2.{lvl}.{j}"
            if j == "2":  # plain conv with bias
                out[tp + ".weight"] = _conv2d(p[key]["kernel"])
                out[tp + ".bias"] = np.asarray(p[key]["bias"])
            else:
                _convbn(out, tp, p[key], s.get(key))
        elif key.startswith("cv3_"):
            lvl, tail = parts[1], parts[2]
            if tail == "2":
                tp = f"{prefix}.cv3.{lvl}.2"
                out[tp + ".weight"] = _conv2d(p[key]["kernel"])
                out[tp + ".bias"] = np.asarray(p[key]["bias"])
            elif legacy:
                _convbn(out, f"{prefix}.cv3.{lvl}.{tail}", p[key], s.get(key))
            else:
                # cv3_{l}_{i}dw (ConvBN under "dw") -> cv3.{l}.{i}.0; cv3_{l}_{i}pw -> .1
                i, kind = tail[:-2], tail[-2:]
                node = p[key]["dw"] if kind == "dw" else p[key]
                snode = (s.get(key) or {}).get("dw") if kind == "dw" else s.get(key)
                _convbn(out, f"{prefix}.cv3.{lvl}.{i}.{0 if kind == 'dw' else 1}", node, snode)
    out[prefix + ".dfl.conv.weight"] = np.arange(reg_max, dtype=np.float32).reshape(1, reg_max, 1, 1)


def state_dict_from_jax(variables: dict[str, Any], spec: GraphSpec, reg_max: int = 16) -> dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree (numpy leaves) -> port state_dict.

    The ``mtl_log_vars`` training head is not part of the model and is skipped.
    """
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: dict[str, np.ndarray] = {}
    for layer_name, p in params.items():
        if layer_name == "mtl_log_vars":
            continue
        idx, _, module = layer_name[1:].partition("_")
        prefix = f"model.{idx}"
        s = stats.get(layer_name)
        if module == "Detect":
            _detect(out, prefix, p, s, spec.legacy_detect, reg_max)
        elif module == "MGAMaskHead":
            _mask_head(out, prefix, p, s)
        elif module == "MaskCBAM":
            _cbam(out, prefix, p)
        elif module in ("MaskECA", "MaskSPADE"):
            raise NotImplementedError(f"{module} comes with a later slice of the port")
        else:
            _generic(out, prefix, p, s)
    return {
        k: torch.tensor(np.ascontiguousarray(v if v.dtype == np.int64 else np.asarray(v, np.float32)))
        for k, v in out.items()
    }
