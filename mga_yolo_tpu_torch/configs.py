"""Model configs as Python dicts, so the CUDA host needs no PyYAML.

``YOLOV8_CBAM`` is ``configs/models/yolov8_cbam.yaml`` as ``yaml.safe_load``
reads it (a test holds the two equal): the flagship YOLOv8-MGA graph with a
mask head and a MaskCBAM block on each of P3/P4/P5, Detect on the refined
features. Built layer indices: P3/P4/P5 features 15/18/21, mask heads
22/24/26, attention 23/25/27, Detect 28.
"""

YOLOV8_CBAM = {
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
        [15, 1, "MGAMaskHead", [256, 64]],
        [[15, 22], 1, "MaskCBAM", [256]],
        [18, 1, "MGAMaskHead", [512, 128]],
        [[18, 24], 1, "MaskCBAM", [512]],
        [21, 1, "MGAMaskHead", [1024, 256]],
        [[21, 26], 1, "MaskCBAM", [1024]],
        [[23, 25, 27], 1, "Detect", ["nc"]],
    ],
}
