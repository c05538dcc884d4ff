"""Model-graph parser: YOLO-style YAML (or dict) -> static GraphSpec.

The port's own copy of ``mga_yolo_tpu/graph.py``: ``[from, repeats, module,
args]`` rows, depth/width/max_channels compound scaling, make_divisible
channel rounding, the MGA channel-inference branches (MGAMaskHead and the
attention modules), and the save-list of outputs read by later layers.

The CUDA host has no PyYAML: a path whose stem names a shipped config
(``yolov8``, ``yolov8_cbam``, ``yolov8_eca``, ``yolov8_spade``) reads its
dict from ``mga_yolo_tpu_torch.configs``, any other path is read by the
port's own YAML reader (``utils/yaml_lite.py``).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Any

BASE_MODULES = frozenset(
    {"Conv", "DWConv", "ConvTranspose", "Bottleneck", "SPP", "SPPF", "C1", "C2", "C2f", "C3", "C3k2", "C3k"}
)
REPEAT_MODULES = frozenset({"C1", "C2", "C2f", "C3", "C3k2", "C3k"})
ATTENTION_MODULES = frozenset({"MaskCBAM", "MaskECA", "MaskSPADE"})
HEAD_MODULES = frozenset({"Detect"})


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round channel count up to the nearest multiple of ``divisor``."""
    return int(math.ceil(x / divisor) * divisor)


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One layer of the model graph."""

    index: int
    from_: int | tuple[int, ...]
    module: str
    args: tuple[Any, ...]
    repeats: int
    c_in: int | tuple[int, ...]
    c_out: int
    scale_name: str | None = None  # "p3"/"p4"/"p5" tag for mask heads / attention

    @property
    def inputs(self) -> tuple[int, ...]:
        f = self.from_
        return (f,) if isinstance(f, int) else tuple(f)


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Fully resolved model graph."""

    nodes: tuple[NodeSpec, ...]
    save: tuple[int, ...]          # indices whose outputs are needed by later layers
    nc: int
    scale: str
    depth: float
    width: float
    max_channels: float
    mask_head_indices: tuple[int, ...]
    attention_indices: tuple[int, ...]
    detect_index: int
    legacy_detect: bool            # False when C3k2 present (YOLO11-style cls branch)
    yaml_path: str | None = None


def layer_param_name(node: NodeSpec) -> str:
    """The JAX package's parameter-collection name for a graph node."""
    return f"l{node.index}_{node.module}"


def _resolve_from(f: Any, i: int) -> int | tuple[int, ...]:
    """Normalize a YAML `from` field to absolute layer indices (-1 -> i-1)."""
    if isinstance(f, int):
        return f % i if f != -1 else i - 1
    return tuple((x % i if x != -1 else i - 1) for x in f)


def parse_graph(cfg: dict | str | Path, ch: int = 3, scale: str | None = None, nc: int | None = None) -> GraphSpec:
    """Parse a model YAML path or pre-loaded dict into a GraphSpec."""
    yaml_path = None
    if isinstance(cfg, (str, Path)):
        from mga_yolo_tpu_torch.configs import SHIPPED

        yaml_path = str(cfg)
        stem = Path(cfg).stem
        if stem in SHIPPED and not Path(cfg).exists():  # a shipped config without its file
            cfg = SHIPPED[stem]
        else:
            from mga_yolo_tpu_torch.utils import yaml_lite

            cfg = yaml_lite.load(cfg)
        if scale is None:
            for s in ("n", "s", "m", "l", "x"):
                if stem.startswith("yolov8" + s) or stem.endswith("-" + s) or stem.endswith("_" + s):
                    scale = s
                    break
    if not isinstance(cfg, dict):
        raise TypeError(f"model config must be a dict or a YAML path, got {type(cfg).__name__}")

    nc = int(nc if nc is not None else cfg.get("nc", 80))
    scales = cfg.get("scales") or {}
    if scale is None:
        scale = cfg.get("scale") or (next(iter(scales)) if scales else "n")
    if scales:
        depth, width, max_channels = scales[scale]
    else:
        depth = cfg.get("depth_multiple", 1.0)
        width = cfg.get("width_multiple", 1.0)
        max_channels = float("inf")

    rows = list(cfg["backbone"]) + list(cfg["head"])
    ch_list: list[int] = [ch]
    nodes: list[NodeSpec] = []
    save: set[int] = set()
    mask_heads: list[int] = []
    attns: list[int] = []
    detect_index = -1
    legacy = True

    for i, (f, n, m, args) in enumerate(rows):
        args = list(args)
        f = _resolve_from(f, i)
        n_rep = max(round(n * depth), 1) if n > 1 else int(n)
        if m.startswith("nn."):
            m = m[3:]

        if m in BASE_MODULES:
            c1 = ch_list[f] if isinstance(f, int) else ch_list[f[0]]
            c2 = args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c2, *args[1:]]
            if m not in REPEAT_MODULES:
                n_rep = 1
            if m == "C3k2":
                legacy = False
                # m/l/x scales force c3k=True (reference parse_model)
                if scale in "mlx":
                    if len(args) >= 2:
                        args[1] = True
                    else:
                        args.append(True)
            c_in: int | tuple[int, ...] = c1
        elif m == "Upsample":
            c2 = ch_list[f] if isinstance(f, int) else ch_list[f[0]]
            c_in = c2
        elif m == "Concat":
            c2 = sum(ch_list[x] for x in f)
            c_in = tuple(ch_list[x] for x in f)
        elif m == "MGAMaskHead":
            c1 = ch_list[f]
            hidden = args[1] if len(args) > 1 else max(8, c1 // 4)
            out_ch = args[2] if len(args) > 2 else 1
            hidden = make_divisible(min(hidden, max_channels) * width, 8)
            args = [hidden, out_ch, *args[3:]]
            c2 = out_ch
            c_in = c1
        elif m in ATTENTION_MODULES:
            c1 = ch_list[f[0]] if isinstance(f, tuple) else ch_list[f]
            args = [c1, *args[1:]] if args else [c1]
            c2 = c1
            c_in = tuple(ch_list[x] for x in f) if isinstance(f, tuple) else c1
        elif m in HEAD_MODULES:
            args = [nc, tuple(ch_list[x] for x in f)]
            c2 = nc
            c_in = tuple(ch_list[x] for x in f)
            detect_index = i
        else:
            raise ValueError(f"Unsupported module in model YAML: {m!r} (layer {i})")

        if m == "MGAMaskHead":
            mask_heads.append(i)
        if m in ATTENTION_MODULES:
            attns.append(i)
        nodes.append(NodeSpec(index=i, from_=f, module=m, args=tuple(args), repeats=n_rep, c_in=c_in, c_out=c2))
        for x in (f,) if isinstance(f, int) else f:
            if x != i - 1:
                save.add(x)
        ch_list.append(c2)
        if i == 0:
            ch_list = [c2]

    # pyramid tags in graph order, as the reference's MGAModel assigns them
    level_names = ["p3", "p4", "p5"]
    tagged: list[NodeSpec] = []
    mh_seen = att_seen = 0
    for node in nodes:
        if node.index in mask_heads:
            node = dataclasses.replace(node, scale_name=level_names[min(mh_seen, 2)])
            mh_seen += 1
        elif node.index in attns:
            node = dataclasses.replace(node, scale_name=level_names[min(att_seen, 2)])
            att_seen += 1
        tagged.append(node)

    return GraphSpec(
        nodes=tuple(tagged),
        save=tuple(sorted(save)),
        nc=nc,
        scale=scale,
        depth=depth,
        width=width,
        max_channels=max_channels,
        mask_head_indices=tuple(mask_heads),
        attention_indices=tuple(attns),
        detect_index=detect_index,
        legacy_detect=legacy,
        yaml_path=yaml_path,
    )
