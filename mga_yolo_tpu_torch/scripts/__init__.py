"""Experiment orchestration (counterpart of ``mga_yolo_tpu/scripts`` and
``tools/scripts/base_comparison.py``): :mod:`.performance_comparison` runs
an (attention variant x scale x fold) grid of training runs as
subprocesses, :mod:`.base_comparison` the plain-YOLOv8 baseline's grid."""
