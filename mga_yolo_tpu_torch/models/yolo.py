"""MGAModel: the detection + segmentation graph as one ``nn.Module``.

Counterpart of ``mga_yolo_tpu/models/yolo.py``. The graph walk returns
``{"det": (decoded (B, A, 4+nc), maps), "seg": {"p3", "p4", "p5"}}`` in eval
mode and ``{"det": maps, "seg": ...}`` in train mode, with NCHW maps and
(B, 1, H/s, W/s) mask logits. Layers live in
``self.model[i]`` as in the reference, so state_dict keys are
``model.{i}.…`` and converted weights load with ``strict=True``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import torch
from torch import nn

from mga_yolo_tpu_torch.device import resolve_device
from mga_yolo_tpu_torch.graph import GraphSpec, NodeSpec, parse_graph
from mga_yolo_tpu_torch.models import layers as L
from mga_yolo_tpu_torch.models.attention import MaskCBAM, MaskECA, MaskSPADE
from mga_yolo_tpu_torch.models.heads import Detect, MGAMaskHead


def compute_strides(spec: GraphSpec) -> dict[int, int]:
    """Static cumulative stride of every node (input = 1): Conv/DWConv multiply
    by their ``s`` arg, Upsample divides by its factor, others pass through."""
    strides: dict[int, int] = {}
    for node in spec.nodes:
        f = node.inputs[0]
        s = 1 if f < 0 else strides[f]
        if node.module in ("Conv", "DWConv"):
            s *= int(node.args[2] if len(node.args) > 2 else 1)
        elif node.module == "Upsample":
            s = max(1, s // int(node.args[1] if len(node.args) > 1 else 2))
        strides[node.index] = s
    return strides


class Upsample(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.upsample2x(x)


class Concat(nn.Module):
    def forward(self, xs: list[torch.Tensor]) -> torch.Tensor:
        return torch.cat(xs, 1)


def build_node(node: NodeSpec, spec: GraphSpec, strides: dict[int, int],
               prob_approach: str | None = None) -> nn.Module:
    """The module of one graph node (parameter-free modules for Upsample/Concat).
    ``prob_approach`` puts a ProbMaskGater of that mode in front of each
    MaskCBAM (its ``prob_mode``)."""
    m, a, c1 = node.module, node.args, node.c_in
    if m == "Conv":
        return L.ConvBN(c1, a[0], a[1] if len(a) > 1 else 1, a[2] if len(a) > 2 else 1)
    if m == "DWConv":
        return L.DWConv(c1, a[0], a[1] if len(a) > 1 else 1, a[2] if len(a) > 2 else 1)
    if m == "C2f":
        return L.C2f(c1, a[0], n=node.repeats, shortcut=a[1] if len(a) > 1 else False)
    if m == "C3":
        return L.C3(c1, a[0], n=node.repeats, shortcut=a[1] if len(a) > 1 else True)
    if m == "C3k2":
        return L.C3k2(c1, a[0], n=node.repeats, c3k=bool(a[1]) if len(a) > 1 else False)
    if m == "SPPF":
        return L.SPPF(c1, a[0], k=a[1] if len(a) > 1 else 5)
    if m == "MGAMaskHead":
        return MGAMaskHead(c1, hidden=a[0], out_ch=a[1] if len(a) > 1 else 1)
    if m == "MaskCBAM":
        return MaskCBAM(channels=a[0], prob_mode=prob_approach is not None,
                        prob_approach=prob_approach or "gumbel")
    if m == "MaskECA":
        return MaskECA(channels=a[0])
    if m == "MaskSPADE":
        return MaskSPADE(channels=a[0])
    if m == "Detect":
        return Detect(spec.nc, ch=tuple(a[1]), strides=tuple(strides[i] for i in node.inputs),
                      legacy=spec.legacy_detect)
    if m == "Upsample":
        return Upsample()
    if m == "Concat":
        return Concat()
    raise ValueError(f"No builder for module {m!r}")


class MGAModel(nn.Module):
    """Graph-walking forward returning det outputs and seg logits."""

    def __init__(self, spec: GraphSpec, prob_approach: str | None = None):
        super().__init__()
        self.spec = spec
        strides = compute_strides(spec)
        self.model = nn.ModuleList(build_node(n, spec, strides, prob_approach) for n in spec.nodes)
        self.det_strides = tuple(strides[i] for i in spec.nodes[spec.detect_index].inputs)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> dict[str, Any]:
        """``generator`` feeds the random draws of the attention modules'
        mask gates in train mode (``prob_mode``)."""
        save = set(self.spec.save)
        cache: dict[int, torch.Tensor] = {}
        seg: dict[str, torch.Tensor] = {}
        prev: Any = x
        det_out = None
        for node, mod in zip(self.spec.nodes, self.model):
            ins = [prev if f == node.index - 1 else (x if f < 0 else cache[f]) for f in node.inputs]
            if node.module in ("Concat", "Detect"):
                out = mod(ins)
            elif node.module in ("MaskCBAM", "MaskECA", "MaskSPADE"):
                out = mod(*ins, generator=generator)
            else:
                out = mod(ins[0])
            if node.module == "Detect":
                det_out = out
            if node.module == "MGAMaskHead" and node.scale_name:
                seg[node.scale_name] = out
            if node.index in save:
                cache[node.index] = out
            prev = out
        return {"det": det_out, "seg": seg}


def create_model(
    cfg: str | Path | dict,
    scale: str | None = None,
    nc: int | None = None,
    device: str | torch.device | None = None,
    lane_pack: Any = False,
    lane_pack_regions: str = "auto",
    remat: Any = False,
    training: bool = False,
    prob_approach: str | None = None,
) -> tuple[MGAModel, GraphSpec]:
    """Parse the config and build the model on ``device`` (CUDA when None;
    raises if CUDA is absent), in train mode when ``training`` else in eval
    mode (``model.train()`` / ``model.eval()`` switch it later).

    Weights are PyTorch's default initialisation from the global generator
    (seed it with ``torch.manual_seed``), or load converted ones with
    ``load_state_dict``. ``lane_pack``, ``lane_pack_regions`` and ``remat``
    are accepted for config compatibility with the JAX package and do
    nothing: lane packing is a TPU layout and remat a TPU memory lever. In
    the JAX package ``training`` only picks kernels; here it sets the mode,
    and its default stays eval, which the serving path builds on.
    ``prob_approach`` (``"deterministic"``, ``"gumbel"``, ``"hard_st"`` or
    ``"bernoulli_detach"``) builds every MaskCBAM with ``prob_mode``, its
    mask gated by a ProbMaskGater of that mode; None builds none.
    """
    dev = resolve_device(device)
    spec = parse_graph(cfg, scale=scale, nc=nc)
    return MGAModel(spec, prob_approach).to(dev).train(training), spec
