"""The port's plotting suite against the JAX package's, pixel for pixel.

Every function of ``mga_yolo_tpu/utils/plotting`` and its port
(``mga_yolo_tpu_torch/utils/plotting``) draw from the same inputs, made from
a numpy seed, in this process (one matplotlib, the Agg backend): the cases
of tests/test_plotting.py, plus the feature-map grid, the gumbel tau sweep
and the validator's curves and confusion matrices. Each pair of PNGs must
decode to exactly the same pixels. ``mask_showcase_precomputed`` reads PNGs
written by the port's ``image_io``.

``mask_showcase``'s ``gaussian_maxpool`` column differs on purpose: the JAX
package's C++ ``block_reduce_max`` casts the float32 blur to uint8, and the
port takes the float max, as the JAX package's numpy path does
(``ROADMAP.md`` section 3). So the JAX side runs with
``mga_yolo_tpu.native.block_reduce_max`` patched to None, as
tests/test_torch_data.py does.
"""

from __future__ import annotations

from pathlib import Path
from unittest import mock

import numpy as np
import pytest
from PIL import Image

from tests._torch_port import few_torch_threads  # noqa: F401  (a module fixture)
from tests.test_plotting import _synthetic_results

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def pixels(path) -> np.ndarray:
    return np.asarray(Image.open(path))


def _profiled(root: Path, name: str, seed: int, params: int) -> dict:
    from mga_yolo_tpu_torch.utils import yaml_lite

    csvp = _synthetic_results(root / name, seed=seed)
    prof = root / name / "profiling.yaml"
    yaml_lite.dump({"parameters": params}, prof)
    return {"name": name, "results_csv": csvp, "profiling_yaml": prof}


def _fold_grid(root: Path) -> list:
    runs = []
    for i, model in enumerate(["cbam_n", "eca_n"]):
        for fold in range(2):
            r = _profiled(root, f"{model}_fold{fold}", 10 * i + fold, (i + 1) * 3_000_000)
            runs.append({**r, "group": model.split("_")[0]})
    return runs


def _curves(nc: int = 2, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    px = np.linspace(0, 1, 1000)
    f1, p, r = (np.sort(rng.random((nc, 1000)), 1)[:, ::-1] for _ in range(3))
    return {"px": px, "px101": np.linspace(0, 1, 101), "py": np.sort(rng.random((nc, 101)), 1)[:, ::-1],
            "f1": f1, "p": p, "r": r, "ap50": rng.random(nc)}


def _vessel_mask() -> np.ndarray:
    m = np.zeros((128, 128), np.uint8)
    m[30:90, 60:64] = 1  # thin vertical vessel
    return m


# name -> fn(plotting module, inputs root, output dir) -> list of PNGs written
CASES = {
    "plot_results": lambda P, root, out: [P.plot_results(_synthetic_results(root / "r"), out / "results.png")],
    "model_comparison": lambda P, root, out: P.model_comparison(
        {"cbam": _synthetic_results(root / "a", seed=1), "eca": _synthetic_results(root / "b", seed=2)}, out),
    "model_comparison_fold_bands": lambda P, root, out: P.model_comparison(
        {f"{m}_fold{f}": _synthetic_results(root / f"{m}{f}", seed=3 * f + i)
         for i, m in enumerate(("cbam_n", "eca_n")) for f in range(2)}, out, fold_bands=True),
    "pareto": lambda P, root, out: [P.pareto_performance(
        [_profiled(root, n, i, (i + 1) * 3_000_000) for i, n in enumerate(["n", "s"])], out / "pareto.png")],
    "pareto_fold_aggregation": lambda P, root, out: [
        P.pareto_performance(_fold_grid(root), out / "pareto_folds.png"),
        P.pareto_performance(_fold_grid(root), out / "pareto_raw.png", aggregate_folds=False)],
    "mask_showcase": lambda P, root, out: [P.mask_showcase(_vessel_mask(), out / "showcase.png")],
    "feature_visualization": lambda P, root, out: [
        P.feature_visualization(np.random.default_rng(4).normal(size=(1, 10, 12, 40)).astype(np.float32),
                                out / "fm.png"),
        P.feature_visualization(np.random.default_rng(5).normal(size=(8, 8, 5)).astype(np.float32), out / "fm5.png")],
    "gumbel_tau_sweep": lambda P, root, out: [
        P.gumbel_tau_sweep(np.random.default_rng(6).random((24, 24)), out / "tau.png", seed=3)],
    "plot_pr_curve": lambda P, root, out: [
        P.plot_pr_curve(c["px101"], c["py"], c["ap50"], {0: "stenosis", 1: "other"}, out / "PR_curve.png")
        for c in [_curves()]] + [P.plot_pr_curve(c["px101"], c["py"], c["ap50"], {}, out / "PR_unnamed.png")
                                 for c in [_curves(3, 1)]],
    "plot_mc_curve": lambda P, root, out: [
        P.plot_mc_curve(c["px"], c[k], {0: "stenosis", 1: "other"}, out / f"{k}.png", ylabel=k)
        for c in [_curves()] for k in ("f1", "p", "r")],
    "plot_confusion_matrix": lambda P, root, out: [
        P.plot_confusion_matrix(m, {0: "stenosis", 1: "other"}, out / f"cm{int(norm)}.png", normalize=norm)
        for m in [np.random.default_rng(7).integers(0, 20, (3, 3)).astype(np.float64)] for norm in (False, True)],
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_draws_the_jax_packages_pixels(case, tmp_path):
    from mga_yolo_tpu import native as jnative
    from mga_yolo_tpu.utils import plotting as J
    from mga_yolo_tpu_torch.utils import plotting as P

    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    with mock.patch.object(jnative, "block_reduce_max", lambda *a: None):
        want = CASES[case](J, tmp_path / "jax_in", tmp_path / "jax")
    got = CASES[case](P, tmp_path / "port_in", tmp_path / "port")
    assert [Path(p).name for p in got] == [Path(p).name for p in want] and got
    for g, w in zip(got, want):
        a, b = pixels(g), pixels(w)
        assert a.shape == b.shape and a.shape[0] > 100, (g, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=str(g))


def test_strip_fold_equals_jax():
    from mga_yolo_tpu.utils.plotting.results import strip_fold as jstrip
    from mga_yolo_tpu_torch.utils.plotting import strip_fold

    for name in ("cbam_n_fold2", "cbam_n-fold_13", "cbam_n", "fold3", "x/FOLD_1/y", ""):
        assert strip_fold(name) == jstrip(name)
    assert strip_fold("cbam_n_fold2") == "cbam_n"


def test_mask_showcase_precomputed_reads_port_pngs(tmp_path):
    """Method folders of *_p{3,4,5}.png written by the port's ``image_io``
    (grey, and one RGB column): the port reads them with ``image_io``, the
    JAX package with PIL, and both draw the same panels."""
    from mga_yolo_tpu.utils.plotting.results import mask_showcase_precomputed as jshow
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.utils.plotting import mask_showcase_precomputed

    rng = np.random.default_rng(0)
    for meth in ("nearest", "maxpool", "colour"):
        d = tmp_path / "in" / meth
        d.mkdir(parents=True)
        for lvl, size in (("p3", 16), ("p4", 8), ("p5", 4)):
            img = (rng.random((size, size)) > 0.5).astype(np.uint8) * 255
            if meth == "colour":
                img = np.stack([img, 255 - img, img // 2], -1)
            image_io.imwrite(d / f"x_{lvl}.png", img)
        image_io.imwrite(d / "y_p3.png", np.zeros((4, 4), np.uint8))  # filtered out by the prefix
    for kw in ({}, {"prefix": "x"}):
        want = jshow(tmp_path / "in", tmp_path / "jax", **kw)
        got = mask_showcase_precomputed(tmp_path / "in", tmp_path / "port", **kw)
        assert [o.name for o in got] == [o.name for o in want] == ["showcase_p3.png", "showcase_p4.png",
                                                                   "showcase_p5.png"]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(pixels(g), pixels(w), err_msg=str(g))
