"""PyTorch port, data-parallel training on two gloo ranks on the CPU.

The port trains on N processes as one global batch and computes what the
JAX package's data-mesh step computes, which is its one-device step on the
global batch. Two ranks are spawned once for the module (``ddp_rank`` in
tests/_torch_dist_worker.py, which imports no JAX) and run every job; the
one-process references run in this process.

* (a) Train-mode ``BatchNorm2d`` on two halves of a seeded batch equals one
  process on the whole batch: output, input and affine gradients, running
  statistics (rtol 1e-5, atol 1e-6).
* (b) With no processes: the loss shares of two halves, given the global
  normalisers, sum to the global ``mga_loss``, its items and its gradient.
* (c) Two ranks of one image each take tests/test_torch_train_step.py's
  three micro-steps (flagship, 128 px, accumulate 2, warmup 4) from its
  weights and batch: their states equal the JAX step's on the global batch
  of 2 at ``test_train_step_matches_jax``'s tolerances, and rank 0's and
  rank 1's are bit-equal.
* (d) The flagship with a gumbel ProbMaskGater: two ranks equal one process
  at (c)'s tolerances.
* (e) ``MGA.train`` on two ranks (8 images at 64 px, batch 4, 2 epochs, then
  a resume for a third): both ranks log the same rows, equal to one
  process's (rel 1e-3, abs 1e-5), and hold its confusion matrix, which
  counts every val box once; only rank 0 writes. Two more ranks, started
  as ``torchrun`` starts them, run ``cli.train``, which initialises the
  group from their environment: the same rows, rank 0 alone writes.
* (f) Refusals, each a ``ValueError``: a global batch that does not divide
  by the world size, a world that does not divide by ``mesh_spatial``, an
  image size that is no multiple of 32 ``mesh_spatial``, and
  ``mesh_spatial`` 2 without a process group.
* (g) The loader under shards: the ranks' shards make up the global batch
  (multi-scale, device augmentation's raw samples, the padded val tail).
"""

from __future__ import annotations

import csv
import socket
import sys

import numpy as np
import pytest
import torch

from tests._torch_dist_worker import batchnorm_run, fit_run, shard, train_steps_run
from tests._torch_port import close_dict, few_torch_threads, train_batch, train_step_run  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

CFG = "configs/models/yolov8_cbam.yaml"
WORLD = 2
LR = (1e-3, 1e-2, 0.9)
STEP_KW = dict(weight_decay=5e-4, ema_decay=0.9999, ema_tau=2000.0, accumulate=2, warmup_steps=4)
BN_SHAPES = {"affine": ((4, 8, 6, 6), True), "plain": ((4, 8, 5, 3), False)}


def bn_inputs(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(0.5, 2.0, shape)).astype(np.float32)
    return x, rng.normal(0, 1, shape).astype(np.float32)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from mga_yolo_tpu_torch.data.synthetic import write_synthetic_dataset

    return str(write_synthetic_dataset(tmp_path_factory.mktemp("ds"), n=8, size=64, max_boxes=4, seed=5, n_val=4))


def fit_job(data, project) -> dict:
    return {"cfg": "configs/hyperparams/cbam_defaults.yaml", "epochs": 2,
            "kw": dict(data=data, imgsz=64, batch=4, nbs=8, device="cpu", workers=1, max_boxes=4,
                       project=str(project), name="ddp", plots=True, warmup_epochs=1.0)}


def cli_argv(data, project) -> list:
    """``cli.train``'s arguments for :func:`fit_job`'s first run."""
    job = fit_job(data, project)
    kw = {**job["kw"], "model": CFG, "model_scale": "n", "epochs": job["epochs"], "name": "cli", "plots": False}
    return ["--cfg", job["cfg"], *(a for k, v in kw.items() for a in (f"--{k}", str(v).lower() if
                                                                        isinstance(v, bool) else str(v)))]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory, data):
    """The JAX and one-process port runs of (c), the jobs of (a), (c), (d)
    and (e) on two spawned ranks, the ``cli.train`` ranks of (e) beside
    them, and the one-process references. Every rank is started first; the
    ranks' train steps wait for the JAX package's weights, which
    ``train_step_run`` writes before it compiles the JAX step."""
    import os

    import torch.multiprocessing as mp

    from tests import _torch_dist_worker as worker

    tmp = tmp_path_factory.mktemp("ddp")
    cli = mp.start_processes(worker.cli_train_rank, args=(WORLD, free_port(), cli_argv(data, tmp / "cli_runs"),
                                                          str(tmp)), nprocs=WORLD, join=False, start_method="spawn")
    weights = tmp / "weights.pt"
    mtl, batch = np.array([0.2, -0.3], np.float32), train_batch(2, 128)  # train_step_run's
    steps = {
        "jax": dict(cfg=CFG, weights=str(weights), mtl=mtl, batch=batch, step_kw=STEP_KW, lr=LR, n_steps=3),
        "gumbel": dict(cfg=CFG, weights=str(weights), mtl=mtl, batch=batch, step_kw=STEP_KW, lr=LR,
                       n_steps=2, prob="gumbel"),
    }
    bn = {name: (*bn_inputs(shape), affine) for name, (shape, affine) in BN_SHAPES.items()}
    jobs = {"bn": bn, "steps": steps, "fit": fit_job(data, tmp / "runs")}
    ddp = mp.start_processes(worker.ddp_rank, args=(WORLD, str(tmp), jobs), nprocs=WORLD, join=False,
                             start_method="spawn")

    def publish(state_dict):  # the ranks' steps start once the file is there
        torch.save(state_dict, tmp / "weights.tmp")
        os.replace(tmp / "weights.tmp", weights)

    try:
        r = train_step_run(CFG, 128, STEP_KW, LR, on_weights=publish)
        np.testing.assert_array_equal(r["mtl"], mtl)
        for k, v in batch.items():
            assert all(np.array_equal(a, b) for a, b in zip(v, r["batch"][k])) if k == "masks" else \
                np.array_equal(v, r["batch"][k])
        # the one-process references while the ranks run
        with pytest.MonkeyPatch.context() as mp_:  # without matplotlib, as the ranks (block_matplotlib)
            mp_.setitem(sys.modules, "matplotlib", None)
            one = {
                "bn": {name: batchnorm_run(x, dy, affine) for name, (x, dy, affine) in bn.items()},
                "gumbel": train_steps_run(steps["gumbel"]),
                "fit": fit_run(fit_job(data, tmp / "one")),
            }
        for ctx in (ddp, cli):
            while not ctx.join():
                pass
    finally:
        for p in (*ddp.processes, *cli.processes):
            p.kill()
    ranks = [torch.load(tmp / f"rank{i}.pt", weights_only=False) for i in range(WORLD)]
    clis = [torch.load(tmp / f"cli_rank{i}.pt", weights_only=False) for i in range(WORLD)]
    return {"jax": r, "ranks": ranks, "clis": clis, "one": one, "tmp": tmp, "data": data}


@pytest.mark.parametrize("name", list(BN_SHAPES))
def test_batchnorm_on_two_ranks_equals_one_process(run, name):
    want = run["one"]["bn"][name]
    for rank, got in enumerate(run["ranks"]):
        got = got[f"bn_{name}"]
        assert set(got) == set(want)
        for k, w in want.items():
            w = w[rank::WORLD] if k in ("y", "dx") else w
            torch.testing.assert_close(got[k], w, rtol=1e-5, atol=1e-6, msg=f"rank {rank} {k}")


def loss_inputs(seed: int, seg: bool):
    """A batch of 4 for ``mga_loss`` at 64 px: random det maps and seg logits,
    1-3 boxes an image, random masks."""
    rng = np.random.default_rng(seed)
    B, M = 4, 4
    maps = [torch.from_numpy(rng.normal(0, 1, (B, 65, 64 // s, 64 // s)).astype(np.float32)) for s in (8, 16, 32)]
    xy = rng.uniform(0, 40, (B, M, 2))
    gt = np.concatenate([xy, xy + rng.uniform(12, 24, (B, M, 2))], -1).astype(np.float32)
    mask_gt = (np.arange(M)[None] < np.array([3, 1, 2, 1])[:, None]).astype(np.float32)
    out = {"det": maps, "seg": {}}
    batch = {"gt_labels": torch.zeros(B, M, dtype=torch.int32), "gt_bboxes": torch.from_numpy(gt),
             "mask_gt": torch.from_numpy(mask_gt), "masks": []}
    if seg:
        for k, s in zip(("p3", "p4", "p5"), (8, 16, 32)):
            out["seg"][k] = torch.from_numpy(rng.normal(0, 2, (B, 1, 64 // s, 64 // s)).astype(np.float32))
            batch["masks"].append(torch.from_numpy((rng.uniform(0, 1, (B, 1, 64 // s, 64 // s)) > 0.6)
                                                   .astype(np.float32)))
    return out, batch


@pytest.mark.parametrize("kind", ["bce_dice", "unified_focal", "plain_yolov8"])
def test_loss_shares_sum_to_the_global_loss_and_gradient(kind):
    """Two halves (the strided shards), given the global target-score sum,
    give shares whose totals, items and gradients (w.r.t. every map, logit
    and ``mtl_log_vars``) sum to the global batch's (rtol 1e-5)."""
    from mga_yolo_tpu_torch.losses import GlobalBatch, SegLossConfig, mga_loss

    out, batch = loss_inputs({"bce_dice": 0, "unified_focal": 1, "plain_yolov8": 2}[kind], kind != "plain_yolov8")
    seg_cfg = SegLossConfig(use_unified_focal=kind == "unified_focal", scale_weights=(1.0, 0.5, 0.25))
    leaves = lambda o: [*o["det"], *o["seg"].values()]  # noqa: E731

    def loss(o, b, share=None):
        o = {"det": [m.detach().clone().requires_grad_(True) for m in o["det"]],
             "seg": {k: v.detach().clone().requires_grad_(True) for k, v in o["seg"].items()}}
        lv = torch.tensor([0.2, -0.3], requires_grad=True)
        total, items, logs = mga_loss(o, b, (8, 16, 32), 1, lv, seg_cfg=seg_cfg, share=share)
        grads = torch.autograd.grad(total, [*leaves(o), lv])
        return total.detach(), items, grads, logs["det/norm"]

    total, items, grads, _ = loss(out, batch)
    halves = [({"det": [m[r::WORLD] for m in out["det"]], "seg": {k: v[r::WORLD] for k, v in out["seg"].items()}},
               shard(batch, r, WORLD)) for r in range(WORLD)]
    norm = sum(loss(o, b)[3] for o, b in halves)  # each half's own target-score sum
    shares = [loss(o, b, GlobalBatch(WORLD, lambda t: norm.clone())) for o, b in halves]
    torch.testing.assert_close(shares[0][0] + shares[1][0], total, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(shares[0][1] + shares[1][1], items, rtol=1e-5, atol=1e-7)
    assert kind != "plain_yolov8" or bool((items[3:] == 0).all())
    for i, g in enumerate(grads[:-1]):  # the batch's rows come back from the two strided shards
        got = torch.empty_like(g)
        for r, (_, _, gr, _) in enumerate(shares):
            got[r::WORLD] = gr[i]
        torch.testing.assert_close(got, g, rtol=1e-5, atol=1e-7 * float(g.abs().max()))
    torch.testing.assert_close(shares[0][2][-1] + shares[1][2][-1], grads[-1], rtol=1e-5, atol=1e-7)


def assert_step_close(t: dict, j: dict, first: bool) -> None:
    """test_train_step_matches_jax's tolerances (tests/test_torch_train_step.py)."""
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4 if first else 1e-3)
    np.testing.assert_allclose(t["items"], j["items"], rtol=1e-4 if first else 1e-3)
    close_dict(t["params"], j["params"], "params", atol=1e-6)
    close_dict(t["m"], j["m"], "momentum", atol=1e-3 if first else 2e-2, rel_to_max=True)
    close_dict(t["bn"], j["bn"], "bn stats", rtol=1e-5 if first else 1e-4, atol=1e-6 if first else 1e-5)
    close_dict(t["ema"], j["ema"], "ema", atol=1e-6)
    close_dict(t["ema_bn"], j["ema_bn"], "ema bn", rtol=1e-5 if first else 1e-4, atol=1e-6 if first else 1e-5)


def assert_ranks_equal(a: dict, b: dict) -> None:
    for k in ("params", "bn", "m", "ema", "ema_bn"):
        close_dict(a[k], b[k], f"rank 0 vs 1 {k}", atol=0)


@pytest.mark.parametrize("i", [0, 1, 2], ids=["step1_apply", "step2_accumulate", "step3_apply"])
def test_two_ranks_match_the_jax_global_batch_step(run, i):
    """Each rank against the JAX step on the global batch of 2; the ranks
    bit-equal."""
    j = run["jax"]["views"][i][1]
    views = [rk["steps_jax"][i] for rk in run["ranks"]]
    for t in views:
        assert t["opt_step"] == j["opt_step"] == (1, 1, 2)[i]
        assert_step_close(t, j, i == 0)
    assert_ranks_equal(*views)


@pytest.mark.parametrize("i", [0, 1], ids=["step1_apply", "step2_accumulate"])
def test_prob_mode_gumbel_on_two_ranks_equals_one_process(run, i):
    """Each rank draws the gumbel noise of the global batch from its seeded
    generator and keeps its rows: two ranks take one process's steps, at
    the same tolerances; the ranks bit-equal."""
    want = run["one"]["gumbel"][i]
    views = [rk["steps_gumbel"][i] for rk in run["ranks"]]
    for t in views:
        assert t["opt_step"] == want["opt_step"] == 1
        assert_step_close(t, want, i == 0)
    assert_ranks_equal(*views)


def val_boxes(data) -> int:
    """The boxes of the val split (one label line each)."""
    from pathlib import Path

    root = Path(data).parent / "labels" / "val"
    return sum(1 for p in root.glob("*.txt") for line in p.read_text().splitlines() if line.strip())


def test_mga_train_on_two_ranks_equals_one_process(run):
    """Both ranks log the same rows; the losses and metrics equal one
    process's (rel 1e-3, abs 1e-5); only rank 0 has a results.csv, the one
    run directory has one row an epoch and the weights; the resume starts
    both ranks at epoch 2 from the same file and ends them equal. The final
    evaluations' confusion matrices, summed over the ranks, are one
    process's, count every val box once, and rank 0 alone saved them."""
    one = run["one"]["fit"]
    fits = [rk["fit"] for rk in run["ranks"]]
    for what, epochs in (("fit", 2), ("resume", 3)):
        a, b = (f[what] for f in fits)
        assert a["rows"] == b["rows"] and len(a["rows"]) == epochs - (what == "resume") * 2
        assert a["save_dir"] == b["save_dir"] and a["has_csv"] and not b["has_csv"]
        assert a["step"] == b["step"] == one[what]["step"]
        close_dict(a["state"], b["state"], f"{what}: rank 0 vs 1", atol=0)
        for got, want in zip(a["rows"], one[what]["rows"]):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5, err_msg=f"{what} {k}")
        np.testing.assert_array_equal(a["confusion"], one[what]["confusion"])
        np.testing.assert_array_equal(b["confusion"], one[what]["confusion"])
        np.testing.assert_array_equal(a["confusion_file"], one[what]["confusion_file"])
        assert b["confusion_file"] is None and int(a["confusion"][:, :-1].sum()) == val_boxes(run["data"]) > 0
        assert a["pngs"] == one[what]["pngs"] == []  # the ranks run without matplotlib: the arrays, no PNG
    assert fits[0]["resume"]["start_epoch"] == 2
    run_dir = run["tmp"] / "runs" / "ddp"
    assert sorted(p.name for p in (run["tmp"] / "runs").iterdir()) == ["ddp"]
    with open(run_dir / "results.csv", newline="") as f:
        assert [r["epoch"] for r in csv.DictReader(f)] == ["1.0", "2.0", "3.0"]
    assert {"best.pt", "last.pt"} <= {p.name for p in (run_dir / "weights").iterdir()}


def test_cli_train_under_torchrun_environment_equals_one_process(run):
    """Two ranks with torchrun's variables run ``cli.train --device cpu``:
    it initialises a gloo group from them and destroys it; both ranks end
    with the same evaluation; rank 0 alone wrote the one run directory,
    whose results.csv rows equal one process's ``MGA.train`` (rel 1e-3,
    abs 1e-5)."""
    a, b = run["clis"]
    assert not a["group_left"] and not b["group_left"]
    assert a["map"] == b["map"]
    np.testing.assert_array_equal(a["loss_items"], b["loss_items"])
    np.testing.assert_array_equal(a["confusion"], b["confusion"])
    np.testing.assert_array_equal(a["confusion"], run["one"]["fit"]["fit"]["confusion"])
    project = run["tmp"] / "cli_runs"
    assert sorted(p.name for p in project.iterdir()) == ["cli"]
    with open(project / "cli" / "results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    want_rows = run["one"]["fit"]["fit"]["rows"]
    assert len(rows) == len(want_rows) == 2
    for got, want in zip(rows, want_rows):
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), v, rtol=1e-3, atol=1e-5, err_msg=k)
    assert {"best.pt", "last.pt"} <= {p.name for p in (project / "cli" / "weights").iterdir()}


def test_refusals(run, data, tmp_path):
    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.train.trainer import MGATrainer

    for rk in run["ranks"]:
        assert rk["refusals"]["batch"] == "ValueError: the global batch 3 does not divide into 2 ranks"
        assert rk["refusals"]["world"] == "ValueError: 2 ranks not divisible by spatial=3"
        assert rk["refusals"]["imgsz"] == ("ValueError: mesh_spatial=2 needs the image size to be a multiple of "
                                           "32 x 2 = 64, got 96 rows")
    job = fit_job(data, tmp_path)
    with pytest.raises(ValueError, match="1 ranks not divisible by spatial=2"):
        MGATrainer(load_config(job["cfg"], model=CFG, **job["kw"], mesh_spatial=2))
    assert not (tmp_path / "ddp").exists()


@pytest.mark.parametrize("case", ["multi_scale", "raw_mode", "val_tail"])
def test_loader_shards_make_up_the_global_batch(data, case):
    """Two shards of each batch, stacked in the strided order, equal the
    unsharded loader's batch: multi-scale picks one size a batch on every
    shard, the raw samples are drawn by index, and the padded val tail
    carries the index of every row (its repeats are the first rows)."""
    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.data.dataset import MGADataset
    from mga_yolo_tpu_torch.data.loader import DataLoader

    cfg = load_config("configs/hyperparams/cbam_defaults.yaml", data=data, imgsz=64, max_boxes=4)
    split, kw = ("val", dict(batch_size=6, shuffle=False, drop_last=False)) if case == "val_tail" else \
        ("train", dict(batch_size=4, seed=3))
    ds = MGADataset(cfg, split, augment=split == "train")

    def batches(num_shards=1, shard_index=0):
        ld = DataLoader(ds, workers=1, device="cpu", num_shards=num_shards, shard_index=shard_index, **kw)
        ld.raw_mode = case == "raw_mode"
        if case == "multi_scale":
            ld.size_buckets = [64, 96, 128]
        return list(ld)

    whole, parts = batches(), [batches(WORLD, r) for r in range(WORLD)]
    assert len(whole) == len(parts[0]) == len(parts[1]) > 0
    for b, *ps in zip(whole, *parts):
        for k, v in b.items():
            for i, m in enumerate(v if k == "masks" else [v]):
                got = np.stack([p[k][i] if k == "masks" else p[k] for p in ps], 1)
                got = got.reshape(-1, *got.shape[2:])  # rows back in the global batch's order
                np.testing.assert_array_equal(got[:len(m)], m, err_msg=k)
    if case == "val_tail":  # 4 images in a batch of 6: two rows repeat, by index, and carry it
        assert [int(i) for p in parts for i in p[-1]["index"]] == [0, 2, 0, 1, 3, 1]
