"""Typed configuration (counterpart of ``mga_yolo_tpu/config.py``).

One :class:`MGAConfig` of dataclasses, filled by :func:`load_config` from a
training YAML with the reference's keys (flat Ultralytics-style keys go to
their section, ``MGA_*`` keys through ``_MGA_KEY_MAP``), from a dict, or
from keyword overrides. The card's host has no PyYAML: a path whose stem
names a shipped profile (``base_defaults``, ``cbam_defaults``,
``eca_defaults``, ``spade_defaults``) reads its dict from
``mga_yolo_tpu_torch.configs``, any other YAML file (a user's experiment
config, the data YAML) is read by the port's own reader
(``utils/yaml_lite.py``).

The JAX package's TPU implementation selectors (its ``perf`` section:
``kth_impl``, ``dfl_bwd``, ``vconcat_acc``, ``vconcat_min_k``,
``packed_split``) choose between implementations the port does not have;
their keys land in ``extra`` with the other keys no section takes.
``augment.on_device`` moves the warp, HSV, flip and mask pyramid onto the
card (``data/device_augment.py``) where ``device_augment.supported`` allows.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional


@dataclasses.dataclass
class MaskPipelineConfig:
    """Mask loading + pyramid downsampling (the reference's MGA_MASK_* / MGA_PROB_* flags)."""

    method: str = "skeleton_bresenham"  # nearest|area|maxpool|pyrdown|skeleton_bresenham|gaussian_maxpool
    bridge: bool = True                 # 3x3 morphological-close bridge
    thresh: float = 0.0                 # area-method threshold
    skeleton_strict: bool = False       # strict skeleton path
    prob_mode: bool = False             # probabilistic masks (MGA_PROB_MODE)
    prob_method: str = "area"           # area|avgpool|nearest
    prob_approach: str = "gumbel"       # gater mode: deterministic|gumbel|hard_st|bernoulli_detach
    save_aug_masks: bool = False        # debug dumps (MGA_SAVE_AUG_MASKS)
    save_max: int = 16


@dataclasses.dataclass
class AugmentConfig:
    """Geometric/photometric augmentation (the reference's cfg/default.yaml keys)."""

    hsv_h: float = 0.015
    hsv_s: float = 0.7
    hsv_v: float = 0.4
    degrees: float = 0.0
    translate: float = 0.1
    scale: float = 0.5
    shear: float = 0.0
    perspective: float = 0.0
    flipud: float = 0.0
    fliplr: float = 0.5
    mosaic: float = 1.0
    mosaic_n: int = 4       # mosaic layout: 3 (1x3), 4 (2x2) or 9 (3x3) images
    mixup: float = 0.0
    cutmix: float = 0.0
    albumentations: float = 0.0  # pixel-transform adapter prob (needs a package neither host has)
    close_mosaic: int = 10  # disable mosaic for the last N epochs
    on_device: bool = False  # warp / HSV / flip / mask pyramid on the card (data/device_augment.py)


@dataclasses.dataclass
class DataConfig:
    data: str = ""                 # data YAML path
    imgsz: int = 640
    max_boxes: int = 64            # static GT padding per image
    workers: int = 8
    cache: "bool | str" = False    # False | True/"ram" (decoded RAM cache) | "disk" (.npy sidecars)
    rect: bool = False             # rectangular val batching (static aspect buckets)
    fraction: float = 1.0
    single_cls: bool = False
    # resolved from the data YAML:
    dataset_root: Optional[str] = None
    masks_dir: Optional[str] = None


@dataclasses.dataclass
class SegCfg:
    bce_weight: float = 1.0
    dice_weight: float = 1.0
    scale_weights: tuple = (1.0, 1.0, 1.0)
    smooth: float = 1.0
    loss_lambda: float = 1.0
    enabled: bool = True
    use_unified_focal: bool = False
    ufl_lambda: float = 0.5
    ufl_delta: float = 0.6
    ufl_gamma: float = 0.5


@dataclasses.dataclass
class TrainConfig:
    model: str = "configs/models/yolov8_cbam.yaml"
    model_scale: str = "n"
    task: str = "mga"
    epochs: int = 100
    batch: int = 16
    nbs: int = 64                  # nominal batch size for grad accumulation
    optimizer: str = "auto"        # SGD|Adam|AdamW|auto
    lr0: float = 0.01
    lrf: float = 0.01
    momentum: float = 0.937
    weight_decay: float = 0.0005
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    cos_lr: bool = False
    multi_scale: bool = False      # bucketed multi-scale (0.75/1.0/1.25 x imgsz)
    box: float = 7.5
    cls: float = 0.5
    dfl: float = 1.5
    patience: int = 100
    seed: int = 0
    deterministic: bool = True
    amp: bool = True               # bfloat16 autocast
    ema_decay: float = 0.9999
    ema_tau: int = 2000
    val: bool = True
    save: bool = True              # write best/last checkpoints (reference `save`)
    save_period: int = -1
    project: str = "runs"
    name: str = "train"
    exist_ok: bool = False
    resume: bool = False
    device: Optional[str] = None
    plots: bool = True
    # the JAX package's kernel, layout and memory selectors; create_model
    # takes them and they change nothing in the port
    use_pallas: "bool | str" = "auto"
    lane_pack: "bool | str" = "auto"
    remat: "bool | str" = "auto"
    # feature-map capture (reference MGA_SAVE_FM flags)
    save_fm: bool = False
    save_layers: tuple = (23, 25, 27)
    save_fm_max: int = 4


@dataclasses.dataclass
class MGAConfig:
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    augment: AugmentConfig = dataclasses.field(default_factory=AugmentConfig)
    mask: MaskPipelineConfig = dataclasses.field(default_factory=MaskPipelineConfig)
    seg: SegCfg = dataclasses.field(default_factory=SegCfg)
    extra: dict = dataclasses.field(default_factory=dict)  # keys no section takes, kept for forwarding

    @property
    def save_dir(self) -> Path:
        return Path(self.train.project) / self.train.name


# the reference's MGA_* env-style YAML keys -> (section, field)
_MGA_KEY_MAP = {
    "MGA_PROB_MODE": ("mask", "prob_mode"),
    "MGA_PROB_APPROACH": ("mask", "prob_approach"),
    "MGA_MASK_METHOD": ("mask", "method"),
    "MGA_MASK_BRIDGE": ("mask", "bridge"),
    "MGA_MASK_THRESH": ("mask", "thresh"),
    "MGA_SKELETON_STRICT": ("mask", "skeleton_strict"),
    "MGA_MASK_PROB_METHOD": ("mask", "prob_method"),
    "MGA_SAVE_AUG_MASKS": ("mask", "save_aug_masks"),
    "MGA_SAVE_MAX": ("mask", "save_max"),
    "MGA_SAVE_FM": ("train", "save_fm"),
    "MGA_SAVE_LAYERS": ("train", "save_layers"),
    "MGA_SAVE_FM_MAX": ("train", "save_fm_max"),
}

_SECTIONS = [(name, {f.name for f in dataclasses.fields(cls)})
             for name, cls in (("seg", SegCfg), ("augment", AugmentConfig), ("data", DataConfig),
                               ("train", TrainConfig))]


def resolve_cache_mode(value) -> Optional[str]:
    """The ``cache`` value as None / "ram" / "disk" (True means "ram")."""
    if isinstance(value, str):
        low = value.lower()
        if low == "disk":
            return "disk"
        if low in {"ram", "1", "true", "yes", "on"}:
            return "ram"
        return None
    return "ram" if value else None


def _coerce(value: Any, target: Any) -> Any:
    """Best-effort coercion of a YAML value to the field's type."""
    if isinstance(target, bool):
        if isinstance(value, str):
            return value.lower() in {"1", "true", "yes", "on"}
        return bool(value)
    if isinstance(target, tuple) and isinstance(value, (list, tuple)):
        return tuple(value)
    if isinstance(target, tuple) and isinstance(value, str):
        return tuple(int(x) for x in value.split(",") if x.strip())
    if isinstance(target, int) and not isinstance(value, bool) and value is not None:
        return int(value)
    if isinstance(target, float) and value is not None:
        return float(value)
    return value


def read_yaml(path: str | Path) -> Any:
    """A YAML file's value, read by the port's own reader. Only when the file
    is absent does a shipped profile's stem give its dict."""
    from mga_yolo_tpu_torch.configs import HYPERPARAMS
    from mga_yolo_tpu_torch.utils import yaml_lite

    stem = Path(path).stem
    if not Path(path).exists() and stem in HYPERPARAMS:
        return dict(HYPERPARAMS[stem])
    return yaml_lite.load(path)


def load_config(cfg: str | Path | dict | None = None, **overrides) -> MGAConfig:
    """An MGAConfig from a training YAML (the reference's schema) or a dict,
    plus keyword overrides. Unknown keys are kept in ``cfg.extra``."""
    raw: dict[str, Any] = {}
    if cfg is not None:
        raw = dict(read_yaml(cfg) or {}) if isinstance(cfg, (str, Path)) else dict(cfg)
    raw.update(overrides)

    out = MGAConfig()
    for key, value in raw.items():
        if key == "cache":
            out.data.cache = resolve_cache_mode(value) or False
            continue
        if key in _MGA_KEY_MAP:
            section, field = _MGA_KEY_MAP[key]
        else:
            section = next((name for name, keys in _SECTIONS if key in keys), None)
            field = key
        if section is None:
            out.extra[key] = value
            continue
        obj = getattr(out, section)
        setattr(obj, field, _coerce(value, getattr(obj, field)))

    if out.data.data:
        p = Path(out.data.data)
        if p.exists():
            dy = read_yaml(p) or {}
            out.data.dataset_root = dy.get("dataset") or dy.get("path")
            out.data.masks_dir = dy.get("masks_dir")
    return out


def det_loss_config(cfg: MGAConfig):
    from mga_yolo_tpu_torch.losses.detection import DetLossConfig

    return DetLossConfig(box=cfg.train.box, cls=cfg.train.cls, dfl=cfg.train.dfl)


def seg_loss_config(cfg: MGAConfig):
    from mga_yolo_tpu_torch.losses.segmentation import SegLossConfig

    return SegLossConfig(
        bce_weight=cfg.seg.bce_weight,
        dice_weight=cfg.seg.dice_weight,
        scale_weights=tuple(cfg.seg.scale_weights),
        smooth=cfg.seg.smooth,
        loss_lambda=cfg.seg.loss_lambda,
        enabled=cfg.seg.enabled,
        prob_mode=cfg.mask.prob_mode,
        use_unified_focal=cfg.seg.use_unified_focal,
        ufl_lambda=cfg.seg.ufl_lambda,
        ufl_delta=cfg.seg.ufl_delta,
        ufl_gamma=cfg.seg.ufl_gamma,
    )
