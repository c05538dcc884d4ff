"""Plot implementations (matplotlib Agg, headless-safe); counterpart of
``mga_yolo_tpu/utils/plotting/results.py``.

Each function makes the JAX package's figure with the same matplotlib
calls, figure sizes and dpi, so both write the same pixels from the same
inputs. matplotlib, pandas and scipy are imported inside the functions:
the card's host has no matplotlib and no pandas, and every module of the
port imports there. Files are read with the port's own modules:
``profiling.yaml`` with ``utils/yaml_lite.py``, PNGs with
``data/image_io.py``.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

DET_COLS = ["train/det/box", "train/det/cls", "train/det/dfl", "train/det/total"]
VAL_DET_COLS = ["val/det/box", "val/det/cls", "val/det/dfl", "val/det/total"]
SEG_COLS = [
    "train/seg/p3_bce", "train/seg/p3_dice", "train/seg/p4_bce", "train/seg/p4_dice",
    "train/seg/p5_bce", "train/seg/p5_dice", "train/seg/total",
]
METRIC_COLS = [
    "metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)",
]


def _plt():
    """``matplotlib.pyplot`` on the Agg backend; ImportError without matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _smooth(y: np.ndarray, sigma: float = 2.0) -> np.ndarray:
    """Gaussian smoothing (reference plot_results smooth_sigma param)."""
    if sigma <= 0 or len(y) < 5:
        return y
    from scipy.ndimage import gaussian_filter1d

    return gaussian_filter1d(y.astype(float), sigma, mode="nearest")


def _plot_panel(ax, df, col: str, smooth_sigma: float):
    import pandas as pd

    if col not in df.columns:
        ax.set_visible(False)
        return
    y = pd.to_numeric(df[col], errors="coerce").to_numpy()
    x = df["epoch"].to_numpy()
    ax.plot(x, y, ".", markersize=3, alpha=0.4, label="raw")
    ax.plot(x, _smooth(y, smooth_sigma), "-", linewidth=1.5, label="smooth")
    ax.set_title(col, fontsize=8)
    ax.tick_params(labelsize=7)


def plot_results(
    csv_path: str | Path, save: Optional[str | Path] = None, smooth_sigma: float = 2.0
) -> Path:
    """Training-curves figure for one run (reference plotting.py:860-1200)."""
    import pandas as pd

    plt = _plt()
    csv_path = Path(csv_path)
    df = pd.read_csv(csv_path)
    cols = [c for c in DET_COLS + VAL_DET_COLS + SEG_COLS + METRIC_COLS if c in df.columns]
    n = len(cols)
    ncols = 4
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3.2 * ncols, 2.4 * nrows), squeeze=False)
    for i, col in enumerate(cols):
        _plot_panel(axes[i // ncols][i % ncols], df, col, smooth_sigma)
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].set_visible(False)
    fig.tight_layout()
    out = Path(save) if save else csv_path.parent / "results.png"
    fig.savefig(out, dpi=180)
    plt.close(fig)
    return out


def model_comparison(
    runs: Dict[str, str | Path],
    save_dir: str | Path,
    smooth_sigma: float = 2.0,
    fold_bands: bool = False,
) -> list[Path]:
    """N-run comparison: det-loss 2x4 grid, seg-loss grid, val-metric panel.

    ``runs`` maps display name -> results.csv path (reference
    model_comparison.py YAML spec surface).

    With ``fold_bands``, runs whose fold-stripped names coincide
    ('cbam_n_fold0/1/2') are k-fold repeats of one experiment: each panel
    shows the per-epoch fold mean as the line with a +-std shaded band
    (reference pareto_performance_size.py:28-34 aggregation, applied to the
    training curves).
    """
    import pandas as pd

    plt = _plt()
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    dfs = {name: pd.read_csv(p) for name, p in runs.items()}
    if fold_bands:
        grouped: Dict[str, list] = {}
        for name, df in dfs.items():
            grouped.setdefault(strip_fold(name), []).append(df)
    else:
        grouped = {name: [df] for name, df in dfs.items()}
    outs = []

    panels = [
        ("det_losses.png", DET_COLS + VAL_DET_COLS, (2, 4)),
        ("seg_losses.png", SEG_COLS + [c.replace("train/", "val/") for c in SEG_COLS], (4, 4)),
        ("val_metrics.png", METRIC_COLS, (1, 4)),
    ]
    for fname, cols, (nr, nc) in panels:
        fig, axes = plt.subplots(nr, nc, figsize=(3.2 * nc, 2.4 * nr), squeeze=False)
        flat = [a for row in axes for a in row]
        for ax, col in zip(flat, cols):
            any_data = False
            for name, group in grouped.items():
                with_col = [df for df in group if col in df.columns]
                if not with_col:
                    continue
                if len(with_col) == 1:
                    df = with_col[0]
                    y = pd.to_numeric(df[col], errors="coerce").to_numpy()
                    ax.plot(df["epoch"], _smooth(y, smooth_sigma), linewidth=1.2, label=name)
                else:
                    n_ep = min(len(df) for df in with_col)
                    ys = np.stack([
                        _smooth(pd.to_numeric(df[col], errors="coerce").to_numpy()[:n_ep],
                                smooth_sigma)
                        for df in with_col
                    ])
                    ep = with_col[0]["epoch"].to_numpy()[:n_ep]
                    mean, std = ys.mean(0), ys.std(0)
                    line, = ax.plot(ep, mean, linewidth=1.2,
                                    label=f"{name} (k={len(with_col)})")
                    ax.fill_between(ep, mean - std, mean + std,
                                    alpha=0.2, color=line.get_color(), linewidth=0)
                any_data = True
            if any_data:
                ax.set_title(col, fontsize=8)
                ax.tick_params(labelsize=7)
            else:
                ax.set_visible(False)
        for ax in flat[len(cols):]:
            ax.set_visible(False)
        if flat and any(a.get_visible() for a in flat):
            handles, labels = flat[0].get_legend_handles_labels()
            if handles:
                fig.legend(handles, labels, loc="lower center", ncol=min(4, len(runs)), fontsize=8)
        fig.tight_layout(rect=(0, 0.05, 1, 1))
        out = save_dir / fname
        fig.savefig(out, dpi=180)
        plt.close(fig)
        outs.append(out)
    return outs


_FOLD_RE = re.compile(r"[_\-/]?fold[_\-]?\d+", re.IGNORECASE)


def strip_fold(name: str) -> str:
    """Normalize a run name by removing a fold token: 'cbam_n_fold2' -> 'cbam_n'."""
    return _FOLD_RE.sub("", str(name)).strip("_-/") or str(name)


def pareto_performance(
    runs: Sequence[dict],
    save: str | Path,
    metric: str = "metrics/mAP50(B)",
    aggregate_folds: bool = True,
) -> Path:
    """mAP-vs-size Pareto front (reference pareto_performance_size.py).

    Each run dict: {name, results_csv, profiling_yaml, group(optional),
    fold(optional)}. Uses the best epoch of ``metric`` and the params count
    from profiling.yaml (read with the port's YAML subset); marks the
    non-dominated front.

    With ``aggregate_folds`` (default, reference
    pareto_performance_size.py:28-34,95-97), runs sharing a fold-stripped
    name are k-fold repeats: one point at the fold mean with +-std error
    bars in both axes; the front is computed over the aggregated means.
    """
    import pandas as pd

    from mga_yolo_tpu_torch.utils import yaml_lite

    plt = _plt()
    pts = []
    for r in runs:
        df = pd.read_csv(r["results_csv"])
        best = float(pd.to_numeric(df[metric], errors="coerce").max()) if metric in df else 0.0
        prof = yaml_lite.load(r["profiling_yaml"])
        params = prof.get("parameters", 0) / 1e6
        name = r.get("name", Path(r["results_csv"]).parent.name)
        pts.append((name, params, best, r.get("group", "run")))

    if aggregate_folds:
        # only runs carrying an actual fold token are k-fold repeats; two
        # distinct runs that merely share a name must stay separate points
        by_key: dict[tuple, tuple] = {}
        for i, (name, x, y, g) in enumerate(pts):
            if _FOLD_RE.search(str(name)):
                key = (strip_fold(name), g)
            else:
                key = (i, g)  # unique: never merged
            disp = strip_fold(name) if _FOLD_RE.search(str(name)) else name
            by_key.setdefault(key, (disp, g, []))[2].append((x, y))
        agg = []
        for disp, g, vals in by_key.values():
            xs = np.array([v[0] for v in vals])
            ys = np.array([v[1] for v in vals])
            agg.append((disp, float(xs.mean()), float(ys.mean()), g,
                        float(xs.std()), float(ys.std()), len(vals)))
    else:
        agg = [(n, x, y, g, 0.0, 0.0, 1) for n, x, y, g in pts]

    fig, ax = plt.subplots(figsize=(6, 4.5))
    groups = sorted({p[3] for p in agg})
    for g in groups:
        sel = [p for p in agg if p[3] == g]
        xs = [p[1] for p in sel]
        ys = [p[2] for p in sel]
        if any(p[4] or p[5] for p in sel):
            ax.errorbar(xs, ys, xerr=[p[4] for p in sel], yerr=[p[5] for p in sel],
                        fmt="o", ms=4, capsize=3, linewidth=1, label=g)
        else:
            ax.scatter(xs, ys, label=g, s=30)
        for name, x, y, _, _, _, k in sel:
            tag = f"{name} (k={k})" if k > 1 else name
            ax.annotate(tag, (x, y), fontsize=6, xytext=(3, 3), textcoords="offset points")

    # non-dominated front: sort by params, keep strictly improving metric
    srt = sorted(agg, key=lambda p: p[1])
    front, best_y = [], -1.0
    for p in srt:
        if p[2] > best_y:
            front.append(p)
            best_y = p[2]
    ax.plot([p[1] for p in front], [p[2] for p in front], "k--", linewidth=1, label="Pareto front")
    ax.set_xlabel("Parameters (M)")
    ax.set_ylabel(metric)
    ax.legend(fontsize=7)
    fig.tight_layout()
    save = Path(save)
    fig.savefig(save, dpi=180)
    plt.close(fig)
    return save


def gumbel_tau_sweep(
    mask_probs: np.ndarray,
    save: str | Path,
    taus: Sequence[float] = (0.1, 0.5, 1.0, 2.0, 5.0),
    seed: int = 0,
) -> Path:
    """Gumbel-sigmoid gate visualization across temperatures
    (reference mask_process_visualized.py): shows how tau sharpens/softens
    the stochastic gate over a probability mask."""
    plt = _plt()
    rng = np.random.default_rng(seed)
    eps = 1e-6
    p = np.clip(mask_probs.astype(np.float64), eps, 1 - eps)
    u1 = np.clip(rng.uniform(size=p.shape), eps, 1 - eps)
    u2 = np.clip(rng.uniform(size=p.shape), eps, 1 - eps)
    g = -np.log(-np.log(u1)) + np.log(-np.log(u2))
    logits = np.log(p) - np.log1p(-p)

    fig, axes = plt.subplots(1, len(taus) + 1, figsize=(2.0 * (len(taus) + 1), 2.2), squeeze=False)
    axes[0][0].imshow(mask_probs, cmap="gray", vmin=0, vmax=1)
    axes[0][0].set_title("p", fontsize=8)
    for j, tau in enumerate(taus):
        m = 1.0 / (1.0 + np.exp(-(logits + g) / tau))
        axes[0][j + 1].imshow(m, cmap="gray", vmin=0, vmax=1)
        axes[0][j + 1].set_title(f"tau={tau}", fontsize=8)
    for ax in axes[0]:
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    save = Path(save)
    fig.savefig(save, dpi=160)
    plt.close(fig)
    return save


def feature_visualization(
    feat: np.ndarray, save: str | Path, max_channels: int = 32
) -> Path:
    """Per-layer feature-map PNG grid (reference vendored utils/plotting.py:1316).

    ``feat`` is one image's NHWC tap (H, W, C): the port's taps are NCHW,
    so callers pass ``validator._nhwc(feat)[0]``. Plots the first
    ``max_channels`` channels in a square-ish grid.
    """
    plt = _plt()
    if feat.ndim == 4:
        feat = feat[0]
    c = min(feat.shape[-1], max_channels)
    ncols = int(np.ceil(np.sqrt(c)))
    nrows = -(-c // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(1.4 * ncols, 1.4 * nrows), squeeze=False)
    flat = [a for row in axes for a in row]
    for i in range(c):
        flat[i].imshow(feat[..., i], cmap="viridis")
    for ax in flat:
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    save = Path(save)
    fig.savefig(save, dpi=120)
    plt.close(fig)
    return save


def mask_showcase(
    mask: np.ndarray,
    save: str | Path,
    strides: Sequence[int] = (8, 16, 32),
    methods: Sequence[str] = ("nearest", "area", "maxpool", "gaussian_maxpool", "skeleton_bresenham"),
) -> Path:
    """Side-by-side downsampling-method panels per pyramid level
    (reference mask_showcase_ds.py), with the port's mask pyramid
    (``data/mask_ops.downsample_mask``; its ``gaussian_maxpool`` takes the
    float max, as the JAX package's numpy path does, ``ROADMAP.md`` section 3)."""
    from mga_yolo_tpu_torch.config import MaskPipelineConfig
    from mga_yolo_tpu_torch.data.mask_ops import downsample_mask

    plt = _plt()
    fig, axes = plt.subplots(
        len(strides), len(methods) + 1,
        figsize=(2.0 * (len(methods) + 1), 2.0 * len(strides)),
        squeeze=False,
    )
    for i, s in enumerate(strides):
        axes[i][0].imshow(mask, cmap="gray")
        axes[i][0].set_ylabel(f"/{s}", fontsize=9)
        axes[i][0].set_xticks([])
        axes[i][0].set_yticks([])
        if i == 0:
            axes[i][0].set_title("original", fontsize=8)
        for j, meth in enumerate(methods):
            out = downsample_mask(mask, s, MaskPipelineConfig(method=meth, skeleton_strict=True))
            ax = axes[i][j + 1]
            ax.imshow(out, cmap="gray", interpolation="nearest")
            ax.set_xticks([])
            ax.set_yticks([])
            if i == 0:
                ax.set_title(meth, fontsize=8)
    fig.tight_layout()
    save = Path(save)
    fig.savefig(save, dpi=180)
    plt.close(fig)
    return save


# --------------------------------------------------------------------- val plots


def plot_pr_curve(px, py, ap50, names: Dict[int, str], save: str | Path) -> Path:
    """Precision-Recall curves per class + mean (reference metrics.py plot_pr_curve)."""
    plt = _plt()
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.atleast_2d(py)
    if 0 < len(names) == py.shape[0] < 21:
        for i, y in enumerate(py):
            ax.plot(px, y, linewidth=1, label=f"{names.get(i, i)} {ap50[i]:.3f}")
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    ax.plot(px, py.mean(0), linewidth=3, color="blue",
            label=f"all classes {float(np.mean(ap50)):.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left", fontsize=8)
    ax.set_title("Precision-Recall Curve")
    out = Path(save)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=180)
    plt.close(fig)
    return out


def plot_mc_curve(px, py, names: Dict[int, str], save: str | Path,
                  ylabel: str = "Metric") -> Path:
    """Metric-confidence curves (F1/P/R vs conf; reference plot_mc_curve)."""
    from mga_yolo_tpu_torch.utils.metrics import smooth

    plt = _plt()
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.atleast_2d(py)
    if 0 < len(names) == py.shape[0] < 21:
        for i, y in enumerate(py):
            ax.plot(px, y, linewidth=1, label=str(names.get(i, i)))
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = smooth(py.mean(0), 0.05)
    ax.plot(px, y, linewidth=3, color="blue",
            label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel("Confidence")
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left", fontsize=8)
    ax.set_title(f"{ylabel}-Confidence Curve")
    out = Path(save)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=180)
    plt.close(fig)
    return out


def plot_confusion_matrix(matrix: np.ndarray, names: Dict[int, str],
                          save: str | Path, normalize: bool = True) -> Path:
    """Confusion-matrix heatmap (reference ConfusionMatrix.plot, metrics.py:313)."""
    plt = _plt()
    m = matrix.astype(float)
    if normalize:
        m = m / (m.sum(0, keepdims=True) + 1e-9)
    nc = matrix.shape[0] - 1
    labels = [str(names.get(i, i)) for i in range(nc)] + ["background"]
    fig, ax = plt.subplots(1, 1, figsize=(max(6, nc), max(5, nc * 0.8)), tight_layout=True)
    im = ax.imshow(m, cmap="Blues", vmin=0.0)
    fig.colorbar(im, ax=ax, fraction=0.046)
    ax.set_xticks(range(len(labels)))
    ax.set_xticklabels(labels, rotation=90, fontsize=8)
    ax.set_yticks(range(len(labels)))
    ax.set_yticklabels(labels, fontsize=8)
    ax.set_xlabel("True")
    ax.set_ylabel("Predicted")
    thresh = m.max() / 2 if m.size else 0.5
    for i in range(m.shape[0]):
        for j in range(m.shape[1]):
            v = m[i, j]
            if v > 0.005:
                ax.text(j, i, f"{v:.2f}" if normalize else f"{int(matrix[i, j])}",
                        ha="center", va="center", fontsize=7,
                        color="white" if v > thresh else "black")
    ax.set_title("Confusion Matrix" + (" (normalized)" if normalize else ""))
    out = Path(save)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=180)
    plt.close(fig)
    return out


def _read_png(path: Path) -> np.ndarray:
    """A PNG's samples as PIL's ``np.asarray(Image.open(path))`` gives them
    for grey (H, W), grey + alpha, RGB and RGBA (H, W, C); a palette
    expands to its colours (PIL keeps the indices)."""
    from mga_yolo_tpu_torch.data import image_io

    img = image_io.decode_png(path.read_bytes(), str(path))
    return img[..., 0] if img.shape[2] == 1 else img


def mask_showcase_precomputed(
    input_dir: str | Path,
    out_dir: str | Path,
    prefix: str | None = None,
    keep_order: bool = False,
) -> list[Path]:
    """Assemble side-by-side panels from PRE-COMPUTED downsampled masks.

    Directory contract matches the reference
    (``mga_yolo/utils/plotting/mask_showcase_precomputed.py``):
    ``input_dir/<method>/*_p{3,4,5}.png``; one output PNG per pyramid level
    with columns = methods, images used exactly as found (no thresholding,
    ``interpolation='none'``), tickless axes, leftmost ylabel "P{n}\\n(HxW)".
    Method columns are sorted alphabetically unless ``keep_order`` (then
    filesystem iteration order); ``prefix`` filters filenames when given.
    """
    plt = _plt()
    input_dir, out_dir = Path(input_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    methods = [d for d in input_dir.iterdir() if d.is_dir() and any(d.iterdir())]
    if not keep_order:
        methods = sorted(methods, key=lambda d: d.name)
    outs: list[Path] = []
    for level in ("p3", "p4", "p5"):
        cols = []
        for mdir in methods:
            cands = sorted(
                f for f in mdir.iterdir()
                if f.name.lower().endswith(f"_{level}.png")
                and (prefix is None or f.name.startswith(prefix))
            )
            if cands:
                cols.append((mdir.name, _read_png(cands[0])))
        if not cols:
            continue
        fig, axes = plt.subplots(1, len(cols), figsize=(2.2 * len(cols), 2.4), squeeze=False)
        for j, (name, img) in enumerate(cols):
            ax = axes[0][j]
            ax.imshow(img, cmap="gray", interpolation="none")
            ax.set_title(name, fontsize=8)
            ax.set_xticks([])
            ax.set_yticks([])
            if j == 0:
                h, w = img.shape[:2]
                ax.set_ylabel(f"{level.upper()}\n({h}x{w})", fontsize=9)
        fig.tight_layout()
        out = out_dir / f"showcase_{level}.png"
        fig.savefig(out, dpi=180)
        plt.close(fig)
        outs.append(out)
    return outs
