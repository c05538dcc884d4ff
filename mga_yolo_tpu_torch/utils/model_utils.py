"""BN fold for inference (counterpart of ``utils/model_utils.fuse_variables``)."""

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
