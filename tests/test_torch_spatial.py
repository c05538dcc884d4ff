"""PyTorch port, the spatial mesh axis (``mesh_spatial``) on gloo ranks on the CPU.

Under a DP x SP mesh each rank holds a band of rows of its data shard's
images; the port writes out the halo exchanges and the reductions over the
bands that XLA inserts on the JAX package's mesh, and its step computes the
JAX package's one-device step on the global batch. Two ranks, four ranks
and one process for the one-process references are spawned once for the
module (``spatial_rank`` in tests/_torch_dist_worker.py, which imports no
JAX), two more run ``cli.train`` as torchrun starts them; the JAX step runs
in this process meanwhile.

* (a) Halo ops: 3x3 stride 1 and 2, SPPF's 5x5 max-pool and a 7x7 conv on
  bands of a seeded input split 2 and 4 ways (bands of 1 row included, so
  a halo takes rows from beyond the next rank): output and input gradient
  equal the op on the whole input (rtol 1e-6, atol 1e-7); so do the weight
  gradients, summed over the bands: float32 sums over the pixels in another
  order, so their atol is 1e-6 x the tensor's max |value| (seen: up to
  2.1e-6 abs where that max is about 10).
* (b) Pools: the space-reduced MaskCBAM gate and MaskECA pool equal
  ``cam_gate_ref`` / ``masked_pool_ref`` on the whole image, forward (rtol
  1e-5, atol 1e-6) and backward (rtol 1e-4, atol 1e-5; the tolerances of
  tests/test_torch_masked_pool.py), with a max tied across a band boundary,
  no pixel over 0.5 with a tiny mask, and msum / N just under ``tiny_thr``.
* (c) The flagship on a 1x2 mesh (both images on both ranks, half of their
  rows each) takes tests/test_torch_ddp.py (c)'s three micro-steps (128
  px, accumulate 2, warmup 4): the states equal the JAX step on the global
  batch of 2 at that test's tolerances, the ranks bit-equal, and no conv
  sees more than a band and its halo.
* (d) The same on a 2x2 mesh (4 ranks: data 2 x space 2), but for the
  momentum of one-element tensors: there (c)'s ``1e-3 x max|m|`` is a bare
  relative tolerance on one float32 sum that cancels (a MaskCBAM ``beta``:
  the JAX step lies 4.5e-4 from the float64 step, the 2x2 ranks 9.4e-4 on
  the other side, 1.4e-3 apart). The momentum is held, as ``chip_smoke.py``
  ``[ddp]`` holds it, to the port's step in float64: its root-mean-square
  error over all tensors at most twice the JAX float32 step's, every tensor
  of more than one element within (c)'s tolerance of the JAX step.
* (e) MaskECA, MaskSPADE and the gumbel ProbMaskGater on 1x2: one
  micro-step equals one process at (c)'s tolerances.
* (f) ``MGA.train`` with ``mesh_spatial: 2`` on two ranks (64 px, 8
  images, batch 4, one validated epoch): the results.csv rows of one
  process (rel 1e-3, abs 1e-5), rank 0 alone writes, the confusion matrix
  counts every val box once; the same with ``augment.on_device`` against
  one process with it; ``cli.train --mesh_spatial 2`` under torchrun's
  variables likewise. The ranks run without matplotlib, as on the card's
  host, so ``plots`` saves the confusion matrix as an array.
* (g) Refusals: a world that does not divide by ``mesh_spatial``, an image
  size that is no multiple of 32 ``mesh_spatial``, a resize that is not an
  identity under a mesh.
* Validation on two data-parallel ranks with 5 val images (a padded last
  batch) scores each image once: the confusion matrix, the images scored
  and the metrics of one process.
"""

from __future__ import annotations

import csv

import numpy as np
import pytest
import torch

from tests._torch_dist_worker import HALO_OPS, pool_cases
from tests._torch_port import few_torch_threads, train_batch, train_step_run  # noqa: F401
from tests.test_torch_ddp import CFG, LR, STEP_KW, assert_ranks_equal, assert_step_close, free_port, val_boxes

pytestmark = pytest.mark.usefixtures("few_torch_threads")

VARIANTS = {"eca": "configs/models/yolov8_eca.yaml", "spade": "configs/models/yolov8_spade.yaml",
            "gumbel": CFG}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from mga_yolo_tpu_torch.data.synthetic import write_synthetic_dataset

    return str(write_synthetic_dataset(tmp_path_factory.mktemp("ds"), n=8, size=64, max_boxes=4, seed=5, n_val=5))


def fit_job(data, project, **kw) -> dict:
    return {"cfg": "configs/hyperparams/cbam_defaults.yaml", "epochs": 1, "resume": False,
            "kw": dict(data=data, imgsz=64, batch=4, nbs=8, device="cpu", workers=1, max_boxes=4,
                       project=str(project), name="sp", plots=True, warmup_epochs=1.0, **kw)}


def cli_argv(data, project) -> list:
    job = fit_job(data, project, mesh_spatial=2)
    kw = {**job["kw"], "model": CFG, "model_scale": "n", "epochs": job["epochs"], "name": "cli", "plots": False}
    return ["--cfg", job["cfg"], *(a for k, v in kw.items() for a in (f"--{k}", str(v).lower() if
                                                                        isinstance(v, bool) else str(v)))]


def spawn(fn, args, n):
    import torch.multiprocessing as mp

    return mp.start_processes(fn, args=(n, *args), nprocs=n, join=False, start_method="spawn")


@pytest.fixture(scope="module")
def run(tmp_path_factory, data):
    """Every rank started first (``spatial_rank``: the jobs on 2 ranks, 1x2
    mesh; on 4 ranks, 1x4 and 2x2; the one-process references in one more
    process; ``cli.train`` on 2 ranks), then the JAX and one-process port
    steps here, whose weights the ranks' train steps wait for."""
    import os

    from mga_yolo_tpu_torch.models.yolo import create_model
    from tests import _torch_dist_worker as worker

    tmp = tmp_path_factory.mktemp("spatial")
    weights = {"flagship": tmp / "flagship.pt"}
    for name, cfg in VARIANTS.items():
        if name != "gumbel":
            torch.manual_seed(1)
            model, _ = create_model(cfg, scale="n", nc=1, device="cpu")
            weights[name] = tmp / f"{name}.pt"
            torch.save(model.state_dict(), weights[name])
    batch = train_batch(2, 128)  # train_step_run's batch
    job = dict(mtl=np.array([0.2, -0.3], np.float32), batch=batch, step_kw=STEP_KW, lr=LR)
    flagship = dict(job, cfg=CFG, weights=str(weights["flagship"]), n_steps=3, spatial=2)
    variants = {name: dict(job, cfg=cfg, weights=str(weights.get(name, weights["flagship"])), n_steps=1,
                           prob="gumbel" if name == "gumbel" else None) for name, cfg in VARIANTS.items()}
    jobs = {"two": {"halo": True, "pool": True, "resize": True, "val": {"data": data},
                    "fit": fit_job(data, tmp / "runs", mesh_spatial=2),
                    "fit_dev": fit_job(data, tmp / "runs_dev", mesh_spatial=2, on_device=True),
                    "steps": {"flagship": flagship, **{k: dict(v, spatial=2) for k, v in variants.items()}}},
            "four": {"halo": True, "pool": True, "steps": {"flagship": flagship}},
            "one": {"val": {"data": data}, "fit": fit_job(data, tmp / "one"),
                    "fit_dev": fit_job(data, tmp / "one_dev", on_device=True),
                    "steps": {**variants, "f64": dict(flagship, spatial=1, f64=True)}}}
    ctxs = [spawn(worker.cli_train_rank, (free_port(), cli_argv(data, tmp / "cli_runs"), str(tmp)), 2)]
    for name, n in (("two", 2), ("four", 4), ("one", 1)):
        (tmp / name).mkdir()
        ctxs.append(spawn(worker.spatial_rank, (str(tmp / name), jobs[name]), n))
    try:
        def publish(state_dict):  # the ranks' steps start once the file is there
            torch.save(state_dict, tmp / "flagship.tmp")
            os.replace(tmp / "flagship.tmp", weights["flagship"])

        r = train_step_run(CFG, 128, STEP_KW, LR, on_weights=publish)
        np.testing.assert_array_equal(r["mtl"], job["mtl"])
        for k, v in batch.items():
            assert all(np.array_equal(a, b) for a, b in zip(v, r["batch"][k])) if k == "masks" else \
                np.array_equal(v, r["batch"][k])
        for ctx in ctxs:
            while not ctx.join():
                pass
    finally:
        for ctx in ctxs:
            for p in ctx.processes:
                p.kill()
    load = lambda d, n: [torch.load(tmp / d / f"rank{i}.pt", weights_only=False) for i in range(n)]  # noqa: E731
    one = load("one", 1)[0]
    one = {"steps": {k: one[f"steps_{k}"] for k in variants}, "f64": one["steps_f64"], "val": one["val"],
           "fit": one["fit"], "fit_dev": one["fit_dev"]}
    return {"jax": r, "two": load("two", 2), "four": load("four", 4), "one": one, "tmp": tmp, "data": data,
            "clis": [torch.load(tmp / f"cli_rank{i}.pt", weights_only=False) for i in range(2)]}


def close(got, want, rtol, atol, what):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("ranks", ["two", "four"])
@pytest.mark.parametrize("op", list(HALO_OPS))
def test_halo_ops_equal_the_whole_image(run, op, ranks):
    """Each band's output rows, input-gradient rows and the weight
    gradients summed over the bands equal the op on the whole input."""
    k = len(run[ranks])
    for r, rk in enumerate(run[ranks]):
        res = rk["halo"][op]
        whole, band, h = res["whole"], res["band"], res["h"]
        ho = band["y"].shape[2]
        assert ho * k == whole["y"].shape[2]
        close(band["y"], whole["y"][:, :, r * ho:(r + 1) * ho], 1e-6, 1e-7, f"{op} k={k} rank {r} output")
        close(band["grads"][0], whole["grads"][0][:, :, r * h:(r + 1) * h], 1e-6, 1e-7, f"{op} rank {r} dx")
        for i, (g, w) in enumerate(zip(band["grads"][1:], whole["grads"][1:])):
            close(g, w, 1e-6, 1e-6 * float(w.abs().max()), f"{op} rank {r} weight grad {i}")
    assert min(rk["halo"]["conv7"]["h"] for rk in run[ranks]) == 1  # a 7x7 halo of 3 rows over bands of 1


@pytest.mark.parametrize("ranks", ["two", "four"])
@pytest.mark.parametrize("case", list(pool_cases(2)))
def test_space_pools_equal_the_whole_image(run, case, ranks):
    """The gate and the pool descriptors of the whole image on every band,
    their gradients: this band's rows of dx and dm, the MLP's summed."""
    for r, rk in enumerate(run[ranks]):
        res = rk["pool"][case]
        whole, band, h = res["whole"], res["band"], res["h"]
        close(band["gate"], whole["gate"], 1e-5, 1e-6, f"{case} rank {r} gate")
        for i in range(2):
            close(band["pool"][i], whole["pool"][i], 1e-5, 1e-6, f"{case} rank {r} pool {i}")
        for name, grads in (("gate", "gate_grads"), ("pool", "pool_grads")):
            for i, (g, w) in enumerate(zip(band[grads], whole[grads])):
                if i < 2:  # dx, dm: this band's rows
                    w = w[:, :, r * h:(r + 1) * h]
                close(g, w, 1e-4, 1e-5, f"{case} rank {r} {name} grad {i}")


def rms_err(got: dict, ref: dict) -> float:
    num = sum(float((torch.as_tensor(got[k]).double() - ref[k].double()).square().sum()) for k in ref)
    return (num / sum(ref[k].numel() for k in ref)) ** 0.5


def _check_flagship(run, ranks, i):
    j = run["jax"]["views"][i][1]
    views = [rk["steps_flagship"][i] for rk in run[ranks]]
    for t in views:
        assert t["opt_step"] == j["opt_step"] == (1, 1, 2)[i]
        if ranks == "two":
            assert_step_close(t, j, i == 0)
        else:
            ref = run["one"]["f64"][i]["m"]
            assert rms_err(t["m"], ref) <= 2 * rms_err(j["m"], ref)
            big = [k for k in ref if ref[k].numel() > 1]
            assert_step_close({**t, "m": {k: t["m"][k] for k in big}}, {**j, "m": {k: j["m"][k] for k in big}},
                              i == 0)
        assert t["conv_rows"] == 128 // 2 + 1  # the image's band and its one halo row: never a whole image
    for v in views[1:]:
        assert_ranks_equal(views[0], v)


@pytest.mark.parametrize("i", [0, 1, 2], ids=["step1_apply", "step2_accumulate", "step3_apply"])
def test_flagship_1x2_matches_the_jax_global_batch_step(run, i):
    _check_flagship(run, "two", i)


@pytest.mark.parametrize("i", [0, 1, 2], ids=["step1_apply", "step2_accumulate", "step3_apply"])
def test_flagship_2x2_matches_the_jax_global_batch_step(run, i):
    _check_flagship(run, "four", i)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_on_1x2_equals_one_process(run, name):
    want = run["one"]["steps"][name][0]
    views = [rk[f"steps_{name}"][0] for rk in run["two"]]
    for t in views:
        assert t["opt_step"] == want["opt_step"] == 1
        assert_step_close(t, want, True)
    assert_ranks_equal(*views)


@pytest.mark.parametrize("fit", ["fit", "fit_dev"], ids=["host_augment", "on_device"])
def test_mga_train_mesh_spatial_equals_one_process(run, fit):
    """Both ranks log the rows of one process; only rank 0 has a
    results.csv; the final evaluation's confusion matrix is one process's
    and counts every val box once. ``on_device``: the same with
    ``augment.on_device``, on both sides (each space rank augments the
    whole canvases of its shard's images, then keeps its band). The ranks
    run without matplotlib: the plots' arrays, no PNG."""
    one = run["one"][fit]["fit"]
    a, b = (rk[fit]["fit"] for rk in run["two"])
    assert a["device_augment"] == b["device_augment"] == one["device_augment"] == (fit == "fit_dev")
    assert a["pngs"] == one["pngs"] == []
    assert a["rows"] == b["rows"] and len(a["rows"]) == 1
    assert a["save_dir"] == b["save_dir"] and a["has_csv"] and not b["has_csv"]
    assert a["step"] == b["step"] == one["step"]
    for got, want in zip(a["rows"], one["rows"]):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5, err_msg=k)
    for got in (a, b):
        np.testing.assert_array_equal(got["confusion"], one["confusion"])
    np.testing.assert_array_equal(a["confusion_file"], one["confusion_file"])
    assert b["confusion_file"] is None and int(a["confusion"][:, :-1].sum()) == val_boxes(run["data"]) > 0
    assert sorted(p.name for p in (run["tmp"] / {"fit": "runs", "fit_dev": "runs_dev"}[fit]).iterdir()) == ["sp"]


def test_cli_train_mesh_spatial_under_torchrun_environment(run):
    a, b = run["clis"]
    assert not a["group_left"] and not b["group_left"]
    assert a["map"] == b["map"]
    np.testing.assert_array_equal(a["confusion"], run["one"]["fit"]["fit"]["confusion"])
    np.testing.assert_array_equal(a["confusion"], b["confusion"])
    project = run["tmp"] / "cli_runs"
    assert sorted(p.name for p in project.iterdir()) == ["cli"]
    with open(project / "cli" / "results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    want_rows = run["one"]["fit"]["fit"]["rows"]
    assert len(rows) == len(want_rows) == 1
    for got, want in zip(rows, want_rows):
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), v, rtol=1e-3, atol=1e-5, err_msg=k)


def test_refusals(run, data, tmp_path):
    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.train.trainer import MGATrainer

    for rk in run["two"]:
        assert rk["refusals"]["world"] == "ValueError: 2 ranks not divisible by spatial=3"
        assert rk["refusals"]["imgsz"] == ("ValueError: mesh_spatial=2 needs the image size to be a multiple of "
                                           "32 x 2 = 64, got 96 rows")
        bilinear, nearest, identity = rk["resize"]
        assert "under a mesh that splits rows" in bilinear and "under a mesh that splits rows" in nearest
        assert identity == (1, 1, 4, 4)
    job = fit_job(data, tmp_path, mesh_spatial=2)
    with pytest.raises(ValueError, match="1 ranks not divisible by spatial=2"):  # no process group
        MGATrainer(load_config(job["cfg"], model=CFG, **job["kw"]))
    assert not (tmp_path / "sp").exists()


def test_validation_on_two_ranks_scores_each_image_once(run):
    """5 val images in global batches of 4 on two ranks: the last batch
    wraps to 4 rows, and a repeat that lands on the other rank than its
    first is skipped there too: one process's confusion matrix, images
    scored and metrics."""
    want = run["one"]["val"]
    for rk in run["two"]:
        got = rk["val"]
        assert got["n_images"] == want["n_images"] == 5
        np.testing.assert_array_equal(got["confusion"], want["confusion"])
        np.testing.assert_array_equal(got["nt"], want["nt"])
        assert got["map"] == want["map"]
    assert int(want["confusion"].sum()) >= val_boxes(run["data"]) > 0


@pytest.mark.parametrize("stride,padding,groups", [(1, (0, 1), 1), (2, (0, 1), 1), (1, (0, 3), 1), (1, (0, 1), 4)],
                         ids=["3x3_s1", "3x3_s2", "7x7", "grouped"])
def test_gemm_band_conv_equals_conv2d(stride, padding, groups):
    """The band conv the card takes in float32 (``_GemmConv``: GEMM
    forward and gradients) against ``F.conv2d`` and autograd, in float64
    on the CPU (rtol 1e-12): output, input, weight and bias gradients."""
    import torch.nn.functional as F

    from mga_yolo_tpu_torch.parallel.spatial import _GemmConv

    rng = np.random.default_rng(stride + padding[1] + groups)
    k = 2 * padding[1] + 1
    x, w, b = (torch.from_numpy(rng.normal(0, 1, s)).requires_grad_(True)
               for s in ((2, 4, 9, 8), (4, 4 // groups, k, k), (4,)))
    want = F.conv2d(x, w, b, stride, padding, 1, groups)
    got = _GemmConv.apply(x, w, b, (stride, stride), padding, (1, 1), groups)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    g = torch.from_numpy(rng.normal(0, 1, want.shape))
    for a, c in zip(torch.autograd.grad((got * g).sum(), [x, w, b]), torch.autograd.grad((want * g).sum(), [x, w, b])):
        torch.testing.assert_close(a, c, rtol=1e-12, atol=1e-12)
