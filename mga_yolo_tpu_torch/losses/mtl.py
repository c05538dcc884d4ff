"""Kendall homoscedastic-uncertainty multi-task weighting (counterpart of
``mga_yolo_tpu/losses/mtl.py``):

    L = exp(-s_det) * L_det + s_det + exp(-s_seg) * L_seg + s_seg

with ``s = mtl_log_vars`` (2,), learned jointly with the model. A rank of
``world`` adds its share, ``s / world``, of the regularisers.
"""

from __future__ import annotations

import torch


def kendall_combine(l_det: torch.Tensor, l_seg: torch.Tensor, log_vars: torch.Tensor, world: int = 1):
    """Returns (total, logs {sigma2_det, sigma2_seg, w_det, w_seg})."""
    s_det, s_seg = log_vars[0], log_vars[1]
    w_det = torch.exp(-s_det)
    w_seg = torch.exp(-s_seg)
    total = w_det * l_det + s_det / world + w_seg * l_seg + s_seg / world  # x / 1 is exact
    logs = {
        "mtl/sigma2_det": torch.exp(s_det).detach(),
        "mtl/sigma2_seg": torch.exp(s_seg).detach(),
        "mtl/w_det": w_det.detach(),
        "mtl/w_seg": w_seg.detach(),
    }
    return total, logs
