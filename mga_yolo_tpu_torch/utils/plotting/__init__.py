"""Publication plotting suite consuming results.csv / profiling.yaml
(counterpart of ``mga_yolo_tpu/utils/plotting``).

* :func:`plot_results`       — per-run training-curve figure, Gaussian smoothing
* :func:`model_comparison`   — N-run det-loss grid / seg-loss grid / val-metric panel
* :func:`pareto_performance` — mAP-vs-model-size Pareto front from results.csv + profiling.yaml
* :func:`mask_showcase`      — side-by-side panels of the mask-downsampling methods
  (:func:`mask_showcase_precomputed` from masks already on disk)
* :func:`feature_visualization`, :func:`gumbel_tau_sweep` and the validator's
  :func:`plot_pr_curve`, :func:`plot_mc_curve`, :func:`plot_confusion_matrix`

All functions consume the results.csv schema the trainer writes
(``mga_yolo_tpu_torch.utils.csvlog``). matplotlib and pandas are imported
when a function runs, not with this package: the card's host has neither,
and there :func:`available` is False and the validator keeps the arrays.
"""

from mga_yolo_tpu_torch.utils.plotting.results import (
    feature_visualization,
    gumbel_tau_sweep,
    mask_showcase,
    mask_showcase_precomputed,
    model_comparison,
    pareto_performance,
    plot_confusion_matrix,
    plot_mc_curve,
    plot_pr_curve,
    plot_results,
    strip_fold,
)


def available() -> bool:
    """Whether matplotlib imports here (the figures can be drawn)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


__all__ = [
    "available",
    "plot_results",
    "model_comparison",
    "pareto_performance",
    "strip_fold",
    "mask_showcase",
    "mask_showcase_precomputed",
    "feature_visualization",
    "gumbel_tau_sweep",
    "plot_pr_curve",
    "plot_mc_curve",
    "plot_confusion_matrix",
]
