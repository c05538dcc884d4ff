"""Mask-guided attention (counterpart of ``models/attention.py``), NCHW.

MaskCBAM (with the probabilistic mask gate :class:`ProbMaskGater` under
``prob_mode``), MaskECA and MaskSPADE. Every random draw takes the
``torch.Generator`` its caller passes (the train step's), as the JAX package
draws from the ``"gater"`` RNG collection. With a process group of two or
more, each rank draws for the global batch from its identically seeded
generator and keeps its own rows (the loader's strided shard) and, under
a mesh that splits rows, its own band of rows, so N ranks draw what one
process draws. Under such a mesh the pools and norms over H x W are taken
over the whole images: MaskCBAM's and MaskECA's through the masked
reductions summed over the space ranks (``parallel.spatial``), MaskSPADE's
instance norm through sums over them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mga_yolo_tpu_torch import parallel
from mga_yolo_tpu_torch.models.layers import BatchNorm2d, resize_bilinear
from mga_yolo_tpu_torch.parallel import spatial
from mga_yolo_tpu_torch.ops.cam_gate import cam_gate
from mga_yolo_tpu_torch.ops.masked_pool import masked_pool


def _prob(mask: torch.Tensor, use_sigmoid: bool) -> torch.Tensor:
    return torch.sigmoid(mask) if use_sigmoid else mask


GATER_MODES = ("deterministic", "gumbel", "hard_st", "bernoulli_detach")


class ProbMaskGater(nn.Module):
    """Differentiable spatial gate over probability masks, float32.

    deterministic: M = p; gumbel: M = sigmoid((logit(p) + L) / tau) with
    logistic noise L = -log(-log U1) + log(-log U2); hard_st: the gumbel
    sample thresholded, with the soft sample's gradient (straight through);
    bernoulli_detach: M ~ Bernoulli(p), no gradient to p. p is clipped to
    [0, 1] (and to at least ``p_min``). Eval mode is always deterministic,
    as is ``deterministic`` mode; the others need ``generator``.
    """

    def __init__(self, mode: str = "gumbel", tau: float = 1.0, p_min: float = 0.0, threshold: float = 0.5):
        super().__init__()
        if mode not in GATER_MODES:
            raise ValueError(f"ProbMaskGater: mode {mode!r} is not one of {GATER_MODES}")
        self.mode, self.tau, self.p_min, self.threshold = mode, tau, p_min, threshold

    def forward(self, p: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        p = p.float().clamp(0.0, 1.0)
        if self.p_min > 0:
            p = p.clamp_min(self.p_min)
        if not self.training or self.mode == "deterministic":
            return p
        if generator is None:
            raise ValueError(f"ProbMaskGater: mode {self.mode!r} in train mode draws from a generator; pass one")
        W, r = parallel.data_world(), parallel.data_rank()
        m = parallel.mesh()
        shape, own = (p.shape[0] * W, *p.shape[1:]), (slice(r, None, W),)  # the global batch, this rank's rows
        if m is not None:  # of its whole images, this rank's band
            h = p.shape[2]
            shape = (*shape[:2], h * m.space, *shape[3:])
            own = (*own, slice(None), slice(m.space_rank * h, (m.space_rank + 1) * h))
        if self.mode == "bernoulli_detach":
            pg = p.new_zeros(shape)
            pg[own] = p.detach()
            return torch.bernoulli(pg, generator=generator)[own]
        eps = 1e-6
        u = torch.rand((2, *shape), generator=generator, device=p.device)[(slice(None), *own)]
        u = u.clamp(eps, 1 - eps)
        g = -torch.log(-torch.log(u[0])) + torch.log(-torch.log(u[1]))
        pc = p.clamp(eps, 1 - eps)
        m_soft = torch.sigmoid((torch.log(pc) - torch.log1p(-pc) + g) / self.tau)
        if self.mode == "gumbel":
            return m_soft
        m_hard = (m_soft > self.threshold).to(m_soft.dtype)
        return m_hard + (m_soft - m_soft.detach())


class MaskCBAM(nn.Module):
    """Mask-guided CBAM: masked channel gate, then mask-aware spatial gate.

    out = feat + softplus(beta) * (SAM(CAM(feat)) - feat). The channel gate
    is the fused CAM-gate kernel on CUDA (its plain version on the CPU), and
    differentiable on both; the SAM conv reads [channel max, channel mean,
    mask] in that order. With ``prob_mode`` the mask first goes through a
    :class:`ProbMaskGater` of mode ``prob_approach`` (it has no parameters,
    so the state_dict is the same).
    """

    def __init__(self, channels: int, r: int = 16, spatial_k: int = 7, use_sigmoid_mask: bool = True,
                 tiny_mask_thr: float = 1e-4, eps: float = 1e-6, prob_mode: bool = False,
                 prob_approach: str = "gumbel"):
        super().__init__()
        self.gater = ProbMaskGater(prob_approach) if prob_mode else None
        hidden = max(1, channels // r)
        self.use_sigmoid_mask = use_sigmoid_mask
        self.tiny_mask_thr, self.eps = tiny_mask_thr, eps
        self.cam_mlp = nn.Sequential(nn.Linear(channels, hidden), nn.ReLU(), nn.Linear(hidden, channels))
        k = spatial_k if spatial_k % 2 == 1 else spatial_k + 1
        self.sam_conv = nn.Conv2d(3, 1, k, padding=k // 2, bias=False)
        self.beta = nn.Parameter(torch.zeros(()))

    def forward(self, feat: torch.Tensor, mask: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.gater is not None:
            mask = self.gater(mask, generator)
        fc1, fc2 = self.cam_mlp[0], self.cam_mlp[2]
        # under autocast feat is bf16 and the masters float32: the gate reads
        # the MLP in the activations' type, as the JAX package's bf16 step
        # casts its parameters (the casts are no-ops in float32 and serving)
        dt = feat.dtype
        gate_fn = cam_gate if parallel.mesh() is None else spatial.cam_gate
        gate = gate_fn(feat, _prob(mask, self.use_sigmoid_mask).to(dt), fc1.weight.to(dt), fc1.bias.to(dt),
                       fc2.weight.to(dt), fc2.bias.to(dt), self.tiny_mask_thr, self.eps).to(dt)
        cam_out = feat * gate[:, :, None, None]

        x_max = cam_out.amax(1, keepdim=True)
        x_avg = cam_out.mean(1, keepdim=True)
        m_plane = _prob(resize_bilinear(mask, tuple(feat.shape[-2:])), self.use_sigmoid_mask).to(feat.dtype)
        att = spatial.conv(self.sam_conv, torch.cat([x_max, x_avg, m_plane], 1))
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

    def forward(self, feat: torch.Tensor, mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if mask is None:
            y = feat.mean((2, 3))
        else:
            if mask.shape[-2:] != feat.shape[-2:]:
                raise ValueError(f"MaskECA: mask {tuple(mask.shape)} does not match features {tuple(feat.shape)}")
            # under autocast the mask logits are float32 and feat bf16: the
            # kernel takes one type
            m = _prob(mask, self.use_sigmoid_mask).to(feat.dtype)
            if parallel.mesh() is None:
                y, _ = masked_pool(feat, m, self.tiny_mask_thr, self.eps)
            else:
                y = spatial.pool_f32(feat, m, self.tiny_mask_thr, self.eps)[0].to(feat.dtype)
        w = torch.sigmoid(self.conv1d(y[:, None, :]))[:, 0]          # (B, C)
        a = F.softplus(self.beta).to(w.dtype)
        g = (1.0 + a * (w - 0.5)).to(feat.dtype)
        return feat * g[:, :, None, None]


class MaskSPADE(nn.Module):
    """SPADE/FiLM normalisation conditioned on the mask.

    out = gamma(m) * norm(feat) + beta(m), where norm is the affine-free
    instance norm over H x W (eps ``eps``) or, with ``norm_type="bn"``, a
    scale- and bias-free BatchNorm (eps 1e-3, flax momentum 0.97, the biased
    running variance of :class:`BatchNorm2d`); m is the mask resized
    bilinearly to the feature's H x W and sigmoided, and ``shared`` (3x3,
    ReLU) feeds the 3x3 ``conv_gamma`` / ``conv_beta``. Without a mask it
    returns norm(feat). Convs start as the JAX package's (Kaiming normal,
    fan out, zero bias).
    """

    def __init__(self, channels: int, hidden: int = 64, mask_channels: int = 1, norm_type: str = "in",
                 use_sigmoid_mask: bool = True, eps: float = 1e-6):
        super().__init__()
        if norm_type not in ("in", "bn"):
            raise ValueError(f"MaskSPADE: norm_type {norm_type!r} is not 'in' or 'bn'")
        self.use_sigmoid_mask, self.eps = use_sigmoid_mask, eps
        self.norm = BatchNorm2d(channels, affine=False) if norm_type == "bn" else None
        self.shared = nn.Sequential(nn.Conv2d(mask_channels, hidden, 3, padding=1), nn.ReLU())
        self.conv_gamma = nn.Conv2d(hidden, channels, 3, padding=1)
        self.conv_beta = nn.Conv2d(hidden, channels, 3, padding=1)
        for conv in (self.shared[0], self.conv_gamma, self.conv_beta):
            nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu")
            nn.init.zeros_(conv.bias)

    def forward(self, feat: torch.Tensor, mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.norm is not None:
            x_hat = self.norm(feat)
        elif parallel.mesh() is None:
            var, mu = torch.var_mean(feat, (2, 3), correction=0, keepdim=True)
            x_hat = (feat - mu) * torch.rsqrt(var + self.eps)
        else:  # the whole images' mean, then variance: two sums over the space ranks
            n = feat.shape[2] * feat.shape[3] * parallel.mesh().space
            mu = spatial.sum_space(feat.float().sum((2, 3), keepdim=True)) / n
            d = feat.float() - mu
            var = spatial.sum_space((d * d).sum((2, 3), keepdim=True)) / n
            x_hat = (d * torch.rsqrt(var + self.eps)).to(feat.dtype)
        if mask is None:
            return x_hat
        m = _prob(resize_bilinear(mask, tuple(feat.shape[-2:])), self.use_sigmoid_mask)
        h = self.shared[1](spatial.conv(self.shared[0], m))
        gamma, beta = spatial.conv(self.conv_gamma, h), spatial.conv(self.conv_beta, h)
        return gamma.to(feat.dtype) * x_hat + beta.to(feat.dtype)
