"""A rank of the two-process gloo check of the port's
``MetricAccumulator.gather_across_hosts`` (tests/test_torch_metrics.py).
Imports neither JAX nor the JAX package, so a spawned rank starts fast."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch.distributed as dist


def metrics_rank(rank: int, world: int, out_dir: str, images: list) -> None:
    """Accumulate this rank's contiguous share of ``images``, gather, and
    save the computed DetMetrics fields to ``out_dir/rank{rank}.npz``."""
    from mga_yolo_tpu_torch.utils.metrics import MetricAccumulator

    dist.init_process_group("gloo", init_method=f"file://{out_dir}/rendezvous", rank=rank, world_size=world)
    try:
        share = len(images) // world
        acc = MetricAccumulator()
        for pb, conf, pc, gt, gc in images[rank * share:(rank + 1) * share]:
            acc.update(pb, conf, pc, gt, gc)
        acc.gather_across_hosts()
        d = acc.compute()
        fields = {f: getattr(d, f) for f in ("precision", "recall", "map50", "map", "ap_class", "ap50_per_class",
                                             "ap_per_class_", "p_per_class", "r_per_class", "nt_per_class",
                                             "curves")}
        np.savez(Path(out_dir) / f"rank{rank}.npz", fields=np.array(fields, dtype=object))
    finally:
        dist.destroy_process_group()
