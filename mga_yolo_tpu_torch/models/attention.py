"""Mask-guided attention (counterpart of ``models/attention.py``), NCHW.

MaskCBAM and MaskECA. MaskSPADE and the probabilistic mask gate
(``prob_mode``) come with a later slice of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mga_yolo_tpu_torch.models.layers import resize_bilinear
from mga_yolo_tpu_torch.ops.cam_gate import cam_gate
from mga_yolo_tpu_torch.ops.masked_pool import masked_pool


def _prob(mask: torch.Tensor, use_sigmoid: bool) -> torch.Tensor:
    return torch.sigmoid(mask) if use_sigmoid else mask


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

    def forward(self, feat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        fc1, fc2 = self.cam_mlp[0], self.cam_mlp[2]
        # under autocast feat is bf16 and the masters float32: the gate reads
        # the MLP in the activations' type, as the JAX package's bf16 step
        # casts its parameters (the casts are no-ops in float32 and serving)
        dt = feat.dtype
        gate = cam_gate(feat, _prob(mask, self.use_sigmoid_mask).to(dt), fc1.weight.to(dt), fc1.bias.to(dt),
                        fc2.weight.to(dt), fc2.bias.to(dt), self.tiny_mask_thr, self.eps).to(dt)
        cam_out = feat * gate[:, :, None, None]

        x_max = cam_out.amax(1, keepdim=True)
        x_avg = cam_out.mean(1, keepdim=True)
        m_plane = _prob(resize_bilinear(mask, tuple(feat.shape[-2:])), self.use_sigmoid_mask).to(feat.dtype)
        att = self.sam_conv(torch.cat([x_max, x_avg, m_plane], 1))
        sam_out = cam_out * torch.sigmoid(att).to(feat.dtype)

        a = F.softplus(self.beta).to(sam_out.dtype)
        return feat + a * (sam_out - feat)


def eca_kernel_size(channels: int, gamma: float = 2.0, b: float = 1.0, k_min: int = 3, k_max: int = 15) -> int:
    """Adaptive odd 1-D kernel size over the channels (log2 by bit_length)."""
    if channels <= 0:
        return k_min
    k = int(abs((channels.bit_length() - 1) / gamma + b))
    k = max(k_min, min(k, k_max))
    return k if k % 2 == 1 else k + 1


class MaskECA(nn.Module):
    """Mask-guided efficient channel attention.

    g = 1 + softplus(beta) * (sigmoid(conv1d(avg)) - 0.5), out = feat * g,
    where avg is the masked average of the masked-pool kernel on CUDA (its
    plain version on the CPU), or the plain spatial mean without a mask. The
    mask must have the feature's H x W: it is not resized. ``conv1d`` runs
    over the channels as the JAX package's NWC conv does (cross-correlation,
    ``k // 2`` zero padding each side).
    """

    def __init__(self, channels: int, gamma: float = 2.0, b: float = 1.0, k_min: int = 3, k_max: int = 15,
                 use_sigmoid_mask: bool = True, tiny_mask_thr: float = 1e-4, eps: float = 1e-6):
        super().__init__()
        self.use_sigmoid_mask = use_sigmoid_mask
        self.tiny_mask_thr, self.eps = tiny_mask_thr, eps
        k = eca_kernel_size(channels, gamma, b, k_min, k_max)
        self.conv1d = nn.Conv1d(1, 1, k, padding=k // 2, bias=False)
        self.beta = nn.Parameter(torch.zeros(()))

    def forward(self, feat: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if mask is None:
            y = feat.mean((2, 3))
        else:
            if mask.shape[-2:] != feat.shape[-2:]:
                raise ValueError(f"MaskECA: mask {tuple(mask.shape)} does not match features {tuple(feat.shape)}")
            # under autocast the mask logits are float32 and feat bf16: the
            # kernel takes one type
            y, _ = masked_pool(feat, _prob(mask, self.use_sigmoid_mask).to(feat.dtype), self.tiny_mask_thr,
                               self.eps)
        w = torch.sigmoid(self.conv1d(y[:, None, :]))[:, 0]          # (B, C)
        a = F.softplus(self.beta).to(w.dtype)
        g = (1.0 + a * (w - 0.5)).to(feat.dtype)
        return feat * g[:, :, None, None]
