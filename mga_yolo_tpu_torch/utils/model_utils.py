"""BN fold for inference and the model summary (counterparts of
``utils/model_utils.fuse_variables`` and ``model_info``)."""

from __future__ import annotations

import torch
from torch import nn

from mga_yolo_tpu_torch.models.layers import ConvBN


@torch.no_grad()
def fuse_model(model: nn.Module) -> nn.Module:
    """Fold every ConvBN's BatchNorm running statistics into its conv, in place.

    conv.weight *= gamma / sqrt(var + eps) per output channel, conv.bias =
    beta - mean * gamma / sqrt(var + eps), and the BN becomes an Identity —
    the same ConvBN pairs the JAX package folds. Eval only.
    """
    for mod in model.modules():
        if isinstance(mod, ConvBN) and isinstance(mod.bn, nn.BatchNorm2d):
            conv, bn = mod.conv, mod.bn
            factor = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            conv.weight.mul_(factor.reshape(-1, 1, 1, 1))
            conv.bias = nn.Parameter(bn.bias - bn.running_mean * factor)
            mod.bn = nn.Identity()
    return model


def model_info(model: nn.Module, imgsz: int = 640) -> dict:
    """Model summary (counterpart of ``utils/model_utils.model_info``): the
    layer table of its graph, parameters, gradients (parameters that train),
    nc, scale and the Detect strides."""
    from mga_yolo_tpu_torch.models.yolo import compute_strides

    spec = model.spec
    strides = compute_strides(spec)
    rows = [{"i": n.index, "from": n.from_, "module": n.module, "args": list(n.args), "c_out": n.c_out,
             "stride": strides[n.index]} for n in spec.nodes]
    return {
        "layers": rows,
        "n_layers": len(rows),
        "parameters": sum(p.numel() for p in model.parameters()),
        "gradients": sum(p.numel() for p in model.parameters() if p.requires_grad),
        "nc": spec.nc,
        "scale": spec.scale,
        "detect_strides": [strides[i] for i in spec.nodes[spec.detect_index].inputs],
        "imgsz": imgsz,
    }
