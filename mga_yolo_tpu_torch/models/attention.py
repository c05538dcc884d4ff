"""Mask-guided attention (counterpart of ``models/attention.py``), NCHW.

Only MaskCBAM is on this slice's path. MaskECA, MaskSPADE and the
probabilistic mask gate (``prob_mode``) come with a later slice of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mga_yolo_tpu_torch.models.layers import resize_bilinear
from mga_yolo_tpu_torch.ops.cam_gate import cam_gate


class MaskCBAM(nn.Module):
    """Mask-guided CBAM: masked channel gate, then mask-aware spatial gate.

    out = feat + softplus(beta) * (SAM(CAM(feat)) - feat). The channel gate
    is the fused CAM-gate kernel on CUDA (its plain version on the CPU), and
    differentiable on both; the SAM conv reads [channel max, channel mean,
    mask] in that order.
    """

    def __init__(self, channels: int, r: int = 16, spatial_k: int = 7, use_sigmoid_mask: bool = True,
                 tiny_mask_thr: float = 1e-4, eps: float = 1e-6, prob_mode: bool = False):
        super().__init__()
        if prob_mode:
            raise NotImplementedError("MaskCBAM prob_mode (ProbMaskGater) comes with a later slice of the port")
        hidden = max(1, channels // r)
        self.use_sigmoid_mask = use_sigmoid_mask
        self.tiny_mask_thr, self.eps = tiny_mask_thr, eps
        self.cam_mlp = nn.Sequential(nn.Linear(channels, hidden), nn.ReLU(), nn.Linear(hidden, channels))
        k = spatial_k if spatial_k % 2 == 1 else spatial_k + 1
        self.sam_conv = nn.Conv2d(3, 1, k, padding=k // 2, bias=False)
        self.beta = nn.Parameter(torch.zeros(()))

    def _prob(self, mask: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(mask) if self.use_sigmoid_mask else mask

    def forward(self, feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        fc1, fc2 = self.cam_mlp[0], self.cam_mlp[2]
        # under autocast feat is bf16 and the masters float32: the gate reads
        # the MLP in the activations' type, as the JAX package's bf16 step
        # casts its parameters (the casts are no-ops in float32 and serving)
        dt = feat.dtype
        gate = cam_gate(feat, self._prob(mask).to(dt), fc1.weight.to(dt), fc1.bias.to(dt),
                        fc2.weight.to(dt), fc2.bias.to(dt), self.tiny_mask_thr, self.eps).to(dt)
        cam_out = feat * gate[:, :, None, None]

        x_max = cam_out.amax(1, keepdim=True)
        x_avg = cam_out.mean(1, keepdim=True)
        m_plane = self._prob(resize_bilinear(mask, tuple(feat.shape[-2:]))).to(feat.dtype)
        att = self.sam_conv(torch.cat([x_max, x_avg, m_plane], 1))
        sam_out = cam_out * torch.sigmoid(att).to(feat.dtype)

        a = F.softplus(self.beta).to(sam_out.dtype)
        return feat + a * (sam_out - feat)
