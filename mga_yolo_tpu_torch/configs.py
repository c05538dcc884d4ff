"""The shipped model configs as Python dicts, so the CUDA host needs no PyYAML.

``YOLOV8_CBAM``, ``YOLOV8_ECA`` and ``YOLOV8_SPADE`` are
``configs/models/yolov8_{cbam,eca,spade}.yaml`` as ``yaml.safe_load`` reads
them (a test holds each equal to its file): the YOLOv8-MGA graph with a mask
head and an attention block (MaskCBAM, MaskECA or MaskSPADE) on each of
P3/P4/P5, Detect on the refined features. Built layer indices: P3/P4/P5
features 15/18/21, mask heads 22/24/26, attention 23/25/27, Detect 28.
``YOLOV8`` is ``configs/models/yolov8.yaml``, the plain detection baseline:
the same backbone and neck, no mask head and no attention, Detect at 22.

``SHIPPED`` maps each file's stem to its dict. ``graph.parse_graph`` reads a
config file that exists with the port's YAML reader, and takes the dict
only for an absent path with one of these stems, so a checkpoint whose
``train_args["model"]`` names a shipped config builds on a host without
the file.

``HYPERPARAMS`` holds ``configs/hyperparams/{base,cbam,eca,spade}_defaults.yaml``
and ``MGA_DATA`` ``configs/data/mga_data.yaml`` the same way (a test holds
each equal to its file); ``config.load_config`` takes one of ``HYPERPARAMS``
for an absent path with its stem.
"""


def _graph(attention: str | None) -> dict:
    """The YOLOv8 graph; with ``attention``, the MGA head on P3/P4/P5."""
    if attention is None:
        tail = [[[15, 18, 21], 1, "Detect", ["nc"]]]
    else:
        tail = [
            [15, 1, "MGAMaskHead", [256, 64]],
            [[15, 22], 1, attention, [256]],
            [18, 1, "MGAMaskHead", [512, 128]],
            [[18, 24], 1, attention, [512]],
            [21, 1, "MGAMaskHead", [1024, 256]],
            [[21, 26], 1, attention, [1024]],
            [[23, 25, 27], 1, "Detect", ["nc"]],
        ]
    return {
        "nc": 1,
        "scales": {
            "n": [0.50, 0.25, 1024],
            "s": [0.50, 0.50, 1024],
            "m": [0.50, 1.00, 512],
            "l": [1.00, 1.00, 512],
            "x": [1.00, 1.50, 512],
        },
        "backbone": [
            [-1, 1, "Conv", [64, 3, 2]],
            [-1, 1, "Conv", [128, 3, 2]],
            [-1, 3, "C2f", [128, True]],
            [-1, 1, "Conv", [256, 3, 2]],
            [-1, 6, "C2f", [256, True]],
            [-1, 1, "Conv", [512, 3, 2]],
            [-1, 6, "C2f", [512, True]],
            [-1, 1, "Conv", [1024, 3, 2]],
            [-1, 3, "C2f", [1024, True]],
            [-1, 1, "SPPF", [1024, 5]],
        ],
        "head": [
            [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
            [[-1, 6], 1, "Concat", [1]],
            [-1, 2, "C3k2", [512, False]],
            [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
            [[-1, 4], 1, "Concat", [1]],
            [-1, 2, "C3k2", [256, False]],
            [-1, 1, "Conv", [256, 3, 2]],
            [[-1, 12], 1, "Concat", [1]],
            [-1, 2, "C3k2", [512, False]],
            [-1, 1, "Conv", [512, 3, 2]],
            [[-1, 9], 1, "Concat", [1]],
            [-1, 2, "C3k2", [1024, True]],
            *tail,
        ],
    }


YOLOV8 = _graph(None)
YOLOV8_CBAM = _graph("MaskCBAM")
YOLOV8_ECA = _graph("MaskECA")
YOLOV8_SPADE = _graph("MaskSPADE")

SHIPPED = {"yolov8": YOLOV8, "yolov8_cbam": YOLOV8_CBAM, "yolov8_eca": YOLOV8_ECA, "yolov8_spade": YOLOV8_SPADE}


def _hyperparams(model: str, task: str = "mga", seg_enabled: bool = True) -> dict:
    """A training profile: the reference's Ultralytics-style arguments, the
    MGA_* mask flags, the seg-loss knobs and the medical-imaging
    augmentation profile (mosaic, mixup and HSV off, mild geometry)."""
    return {
        "task": task, "model": f"configs/models/{model}.yaml", "model_scale": "n",
        "MGA_PROB_MODE": False, "MGA_PROB_APPROACH": "gumbel", "MGA_MASK_METHOD": "skeleton_bresenham",
        "MGA_MASK_BRIDGE": True, "MGA_MASK_THRESH": 0.0, "MGA_SKELETON_STRICT": False, "MGA_SAVE_FM": False,
        "MGA_SAVE_LAYERS": "23,25,27", "MGA_SAVE_FM_MAX": 4,
        "bce_weight": 1.0, "dice_weight": 1.0, "loss_lambda": 1.0, "enabled": seg_enabled,
        "scale_weights": [1.0, 1.0, 1.0], "smooth": 1.0, "use_unified_focal": False, "ufl_lambda": 0.5,
        "ufl_delta": 0.6, "ufl_gamma": 0.5,
        "epochs": 100, "batch": 4, "imgsz": 512, "patience": 100, "optimizer": "auto", "seed": 0,
        "deterministic": True, "amp": True, "cos_lr": False, "lr0": 0.01, "lrf": 0.01, "momentum": 0.937,
        "weight_decay": 0.0005, "warmup_epochs": 3.0, "warmup_momentum": 0.8, "warmup_bias_lr": 0.1,
        "box": 7.5, "cls": 0.5, "dfl": 1.5, "nbs": 64, "val": True, "plots": True,
        "hsv_h": 0.0, "hsv_s": 0.0, "hsv_v": 0.0, "degrees": 0.0, "translate": 0.2, "scale": 0.2, "shear": 0.0,
        "perspective": 0.0, "flipud": 0.0, "fliplr": 0.2, "mosaic": 0.0, "mixup": 0.0, "cutmix": 0.0,
        "close_mosaic": 10,
    }


HYPERPARAMS = {
    "base_defaults": _hyperparams("yolov8", task="detect", seg_enabled=False),
    "cbam_defaults": _hyperparams("yolov8_cbam"),
    "eca_defaults": _hyperparams("yolov8_eca"),
    "spade_defaults": _hyperparams("yolov8_spade"),
}

MGA_DATA = {
    "path": "/path/to/arcade", "train": "images/train", "val": "images/val", "dataset": "/path/to/arcade",
    "masks_dir": "masks", "nc": 1, "names": {0: "stenosis"},
}
