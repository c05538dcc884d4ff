"""Per-layer profile: parameters, FLOPs and output shape of every graph node
(counterpart of ``mga_yolo_tpu/utils/layer_profile.py``, the reference's
``profile=True`` layer report).

The model is built and run once on fake tensors (shapes only: nothing is
computed, no kernel launches, no device is touched) under
``torch.utils.flop_counter.FlopCounterMode``; each node's FLOPs are the
counter's growth across that node's forward. FlopCounterMode counts twice
the multiply-adds of the convolutions and matrix products; it is not the
JAX package's XLA ``cost_analysis``, which also counts elementwise work,
so the port's figures are lower. ``out_shape`` is given in the JAX
package's order (N, H, W, C) for a feature map; Detect's is its decoded
output (N, A, 4 + nc).
"""

from __future__ import annotations

from typing import Optional

import torch

from mga_yolo_tpu_torch.graph import GraphSpec
from mga_yolo_tpu_torch.models.yolo import MGAModel, compute_strides


def _first_shape(out) -> list[int]:
    """The first tensor's shape, NCHW feature maps as NHWC."""
    t = out
    while isinstance(t, (tuple, list)):
        t = t[0]
    shape = list(t.shape)
    return [shape[0], shape[2], shape[3], shape[1]] if len(shape) == 4 else shape


def profile_layers(spec: GraphSpec, imgsz: int, batch: int = 1) -> list[dict]:
    """One row per graph node: ``index``, ``module``, ``inputs``, ``stride``,
    ``params`` (trainable parameters), ``gflops`` and ``out_shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    strides = compute_strides(spec)
    rows: list[dict] = []
    with FakeTensorMode():
        model = MGAModel(spec, tap_indices=tuple(n.index for n in spec.nodes)).eval()
        marks: dict[int, float] = {}
        with FlopCounterMode(display=False) as fc:
            def before(i):
                return lambda mod, args: marks.__setitem__(i, fc.get_total_flops())

            def after(i):
                return lambda mod, args, out: marks.__setitem__(i, fc.get_total_flops() - marks[i])

            hooks = []
            for node, mod in zip(spec.nodes, model.model):
                hooks += [mod.register_forward_pre_hook(before(node.index)),
                          mod.register_forward_hook(after(node.index))]
            with torch.no_grad():
                taps = model(torch.zeros(batch, 3, imgsz, imgsz))["taps"]
            for h in hooks:
                h.remove()
        for node, mod in zip(spec.nodes, model.model):
            rows.append({
                "index": node.index,
                "module": node.module,
                "inputs": list(node.inputs),
                "stride": strides.get(node.index),
                "params": sum(p.numel() for p in mod.parameters() if p.requires_grad),
                "gflops": marks[node.index] / 1e9,
                "out_shape": _first_shape(taps[node.index]),
            })
    return rows


def format_table(rows: list[dict]) -> str:
    total_p = sum(r["params"] for r in rows)
    total_f = sum(r["gflops"] or 0.0 for r in rows)
    lines = [f"{'idx':>4} {'module':<12} {'stride':>6} {'params':>10} {'GFLOPs':>9} {'%FLOPs':>7}  out_shape"]
    for r in rows:
        pct = 100.0 * (r["gflops"] or 0.0) / total_f if total_f else 0.0
        gf = f"{r['gflops']:.3f}" if r["gflops"] is not None else "-"
        lines.append(f"{r['index']:>4} {r['module']:<12} {str(r['stride']):>6} {r['params']:>10,} {gf:>9} "
                     f"{pct:>6.1f}%  {tuple(r['out_shape'])}")
    lines.append(f"{'':>4} {'TOTAL':<12} {'':>6} {total_p:>10,} {total_f:>9.3f}")
    return "\n".join(lines)


def total_gflops(rows: list[dict]) -> Optional[float]:
    """The rows' GFLOPs summed, rounded as ``trainer.count_gflops`` rounds."""
    return round(sum(r["gflops"] for r in rows), 3)
