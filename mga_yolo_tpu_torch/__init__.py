"""MGA-YOLO in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A second implementation of the serving path and the train step of
``mga_yolo_tpu`` (the JAX package, which stays the reference the port is
tested against). The module
layout mirrors the JAX package so each counterpart is easy to find:

    graph.py, configs.py        model-graph parser + the shipped configs
                                (flagship MaskCBAM, MaskECA)
    models/                     ConvBN/C2f/C3k2/SPPF, heads, MaskCBAM, MaskECA,
                                MGAModel
    ops/                        boxes, CAM gate, masked pool, NMS and
                                DFL-backward wrappers (kernel + plain)
    losses/                     TAL assigner + v8 detection loss, seg loss, Kendall
    train/                      optimizers, schedule, EMA, train and eval steps
    csrc/, kernels/_build.py    CUDA C++ sources and their nvcc/ctypes build
    utils/                      BN fold, JAX -> port weight conversion
    data/transforms.py          serving letterbox + box rescale
    serve.py                    InferenceEngine, MicroBatcher, MGAServer

The package imports torch only; it never imports jax or ``mga_yolo_tpu``.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
