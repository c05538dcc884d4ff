"""MGA-YOLO in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A second implementation of ``mga_yolo_tpu`` (the JAX package, which stays
the reference the port is tested against). The module layout mirrors the
JAX package so each counterpart is easy to find:

    graph.py, configs.py        model-graph parser + the shipped configs
                                (plain YOLOv8, MaskCBAM, MaskECA, MaskSPADE;
                                the hyperparameter and data profiles)
    config.py                   MGAConfig, load_config
    models/                     ConvBN/C2f/C3k2/SPPF, heads, MaskCBAM (+
                                ProbMaskGater), MaskECA, MaskSPADE, MGAModel
    ops/                        boxes, CAM gate, masked pool, NMS and
                                DFL-backward wrappers (kernel + plain)
    losses/                     TAL assigner + v8 detection loss, seg loss, Kendall
    train/                      optimizers, schedule, EMA, train and eval steps,
                                the trainer and the validator
    csrc/, kernels/_build.py    CUDA C++ sources and their nvcc/ctypes build
    native/                     host C++ of the data pipeline and the image
                                codecs (g++/ctypes)
    data/                       image I/O, mask pyramid, transforms, dataset,
                                loader, k-fold, a synthetic dataset
    utils/                      BN fold, model_info, JAX -> port weight
                                conversion, the YAML subset reader/writer,
                                metrics, checkpoints, results.csv, callbacks,
                                run directories, COCO export
    serve.py                    InferenceEngine, MicroBatcher, MGAServer
    api.py, cli/                the MGA facade; the train, val, predict,
                                serve, ckpt and profile CLIs
    utils/plotting/             the plotting suite (matplotlib, pandas and
                                scipy imported when a figure is drawn)
    tools/                      the plain-YOLOv8 baseline's train and val
    scripts/                    the experiment grid orchestrator
    export/                     the eval forward as TensorFlow ops, the
                                TFLite / SavedModel export and the runner of
                                exported files (TensorFlow imported inside
                                the functions)

The package imports torch and numpy; it never imports jax, ``mga_yolo_tpu``,
OpenCV, PyYAML or PIL, nor TensorFlow at module level. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
