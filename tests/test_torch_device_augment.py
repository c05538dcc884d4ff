"""PyTorch port, device-side augmentation (``data/device_augment.py``),
against the JAX package's and against the port's own host path, on the CPU.

Inputs: a synthetic dataset of 64 px images (``imgsz`` 64, so the
letterbox only places them) read by both packages' ``MGADataset``, and
per-sample generators seeded with numpy. Tolerances:

* ``build_raw_sample``: exactly the JAX package's (canvases, matrices,
  gains, flips, padded boxes), with the same draws consumed.
* ``make_augment_fn`` on the JAX raw batch, against the JAX package's
  (mosaic on / off, perspective 0 / non-zero): images within 1 grey level
  (float32 sums in another order; the share of differing pixels is held
  under 1%), boxes within 1e-4 px, labels, ``mask_gt`` and every pyramid
  level equal.
* ``downsample_batch``, each method ``supported`` accepts, on the warped
  masks: equal to the JAX package's, but for one documented difference:
  where an ``area`` block mean is exactly 0.5 the JAX package rounds up and
  the port rounds half to even, as cv2's INTER_AREA and both packages'
  host paths do. The JAX side is given those blocks with one pixel
  cleared (so it rounds down too) and must then equal the port's.
* The port's device path against its host path on the same seeds (the JAX
  package's own bounds, ``tests/test_device_augment.py``): image max <= 2
  grey levels and mean < 1, boxes 1e-3, labels, ``mask_gt`` and pyramids
  exact.
"""

from __future__ import annotations

import csv
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port import few_torch_threads  # noqa: F401  (the module fixture below)
from tests.synth import create_synthetic_dataset

IMGSZ, MAX_BOXES, N = 64, 8, 6
GEOMETRY = dict(degrees=10.0, shear=3.0, flipud=0.3, mosaic=0.7)  # a fractional mosaic: both canvas kinds
METHODS = {  # name -> config overrides; every mask method supported() accepts
    "skeleton_bridge": {}, "skeleton": dict(MGA_MASK_BRIDGE=False), "maxpool": dict(MGA_MASK_METHOD="maxpool"),
    "area_bridge": dict(MGA_MASK_METHOD="area"), "area": dict(MGA_MASK_METHOD="area", MGA_MASK_BRIDGE=False),
    "nearest": dict(MGA_MASK_METHOD="nearest"), "prob_area": dict(MGA_PROB_MODE=True),
    "prob_avgpool": dict(MGA_PROB_MODE=True, MGA_MASK_PROB_METHOD="avgpool"),
    "prob_nearest": dict(MGA_PROB_MODE=True, MGA_MASK_PROB_METHOD="nearest"),
}
pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return create_synthetic_dataset(tmp_path_factory.mktemp("synth"), n=N, size=IMGSZ, seed=3)


def _configs(data_yaml, **kw):
    from mga_yolo_tpu.config import load_config as jload
    from mga_yolo_tpu_torch.config import load_config as pload

    kw = dict(data=str(data_yaml), imgsz=IMGSZ, max_boxes=MAX_BOXES, **kw)
    return jload(kw), pload(kw)


def _raw(ds, build, mosaic: bool, seed: int = 100) -> list:
    return [build(ds, i, np.random.default_rng(seed + i), mosaic) for i in range(N)]


@pytest.fixture(scope="module")
def runs(synth):
    """Per (mosaic, perspective): the JAX raw batch and both packages'
    augment outputs on it (one JAX compile each)."""
    from mga_yolo_tpu.data import device_augment as JDA
    from mga_yolo_tpu.data.dataset import MGADataset as JDS
    from mga_yolo_tpu_torch.data import device_augment as PDA

    out = {}
    for persp in (0.0, 0.0005):
        jcfg, pcfg = _configs(synth, perspective=persp, **GEOMETRY)
        jds = JDS(jcfg, "train")
        for mosaic in (True, False):
            raw = JDA.collate_raw(_raw(jds, JDA.build_raw_sample, mosaic))
            size = raw["canvas"].shape[1] // JDA.canvas_multiplier(jcfg.augment, mosaic)
            want = {k: [np.asarray(m) for m in v] if k == "masks" else np.asarray(v)
                    for k, v in JDA.make_augment_fn(jcfg, MAX_BOXES)(raw, size).items()}
            traw = {k: torch.from_numpy(v) for k, v in raw.items()}
            got = PDA.make_augment_fn(pcfg, MAX_BOXES)(traw, size)
            out[(mosaic, persp)] = dict(raw=traw, size=size, got=got, want=want, pcfg=pcfg)
    return out


@pytest.mark.parametrize("mosaic", [True, False])
def test_build_raw_sample_equals_jax(synth, mosaic):
    from mga_yolo_tpu.data import device_augment as JDA
    from mga_yolo_tpu.data.dataset import MGADataset as JDS
    from mga_yolo_tpu_torch.data import device_augment as PDA
    from mga_yolo_tpu_torch.data.dataset import MGADataset as PDS

    jcfg, pcfg = _configs(synth, perspective=0.0005, **GEOMETRY)
    jds, pds = JDS(jcfg, "train"), PDS(pcfg, "train")
    for i in range(N):
        rj, rp = np.random.default_rng(7 + i), np.random.default_rng(7 + i)
        want, got = JDA.build_raw_sample(jds, i, rj, mosaic), PDA.build_raw_sample(pds, i, rp, mosaic)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (i, k)
        assert rp.random() == rj.random()  # the same draws consumed
    assert got["canvas"].shape == (PDA.canvas_multiplier(pcfg.augment, mosaic) * IMGSZ,) * 2 + (3,)
    assert got["pboxes"].shape == (2 * MAX_BOXES, 4)


@pytest.mark.parametrize("mosaic,persp", [(True, 0.0), (False, 0.0), (True, 0.0005), (False, 0.0005)])
def test_augment_equals_jax(runs, mosaic, persp):
    r = runs[(mosaic, persp)]
    got, want = r["got"], r["want"]
    assert got["image"].dtype == torch.uint8 and got["image"].shape == (N, r["size"], r["size"], 3)
    d = np.abs(got["image"].numpy().astype(int) - want["image"].astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
    np.testing.assert_allclose(got["gt_boxes"].numpy(), want["gt_boxes"], rtol=0, atol=1e-4)
    assert got["gt_labels"].dtype == torch.int32
    np.testing.assert_array_equal(got["gt_labels"].numpy(), want["gt_labels"])
    np.testing.assert_array_equal(got["mask_gt"].numpy(), want["mask_gt"])
    assert got["mask_gt"].sum() > 0
    for g, w in zip(got["masks"], want["masks"]):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


def _clear_area_ties(masks: np.ndarray, st: int) -> np.ndarray:
    """The masks with one set pixel cleared in every st x st block whose
    mean is exactly 0.5."""
    out = masks.copy()
    B, H, W = masks.shape
    blocks = masks.reshape(B, H // st, st, W // st, st)
    for b, y, x in zip(*np.nonzero(blocks.mean((2, 4)) == 0.5)):
        ys, xs = np.nonzero(out[b, y * st:(y + 1) * st, x * st:(x + 1) * st])
        out[b, y * st + ys[0], x * st + xs[0]] = 0
    return out


@pytest.mark.parametrize("method", list(METHODS))
def test_downsample_batch_equals_jax(runs, synth, method):
    from mga_yolo_tpu.data import device_augment as JDA
    from mga_yolo_tpu_torch.data import device_augment as PDA

    jcfg, pcfg = _configs(synth, **METHODS[method])
    assert PDA.supported(pcfg) == JDA.supported(jcfg) == (True, "")
    area = (pcfg.mask.prob_method if pcfg.mask.prob_mode else pcfg.mask.method) == "area"
    n_ties = 0
    for (mosaic, persp), r in runs.items():
        m = PDA._warp_nearest(r["raw"]["mask_canvas"], r["raw"]["minv"], r["size"], bool(persp))
        for st in (8, 16, 32):
            got = PDA.downsample_batch(m, st, pcfg.mask).numpy()
            jm = _clear_area_ties(m.numpy(), st) if area else m.numpy()
            n_ties += int((jm != m.numpy()).sum())
            want = JDA.downsample_batch(jnp.asarray(jm), st, jcfg.mask)
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=f"{method} {mosaic} {persp} /{st}")
    if area:
        assert n_ties > 0  # the data does hold ties, where the two packages round apart


@pytest.mark.parametrize("method", ["skeleton_bridge", "maxpool", "area_bridge", "nearest", "prob_area"])
@pytest.mark.parametrize("mosaic", [True, False])
def test_device_path_equals_host_path(synth, method, mosaic):
    """The port's raw sample through its augment against ``MGADataset.get``
    of the same seeds (cv2-equivalent host warps, host mask pyramid)."""
    from mga_yolo_tpu_torch.data import device_augment as PDA
    from mga_yolo_tpu_torch.data.dataset import MGADataset, collate

    _, cfg = _configs(synth, perspective=0.0005, **GEOMETRY, **METHODS[method])
    ds = MGADataset(cfg, "train", augment=True)
    host = collate([ds.get(i, np.random.default_rng(100 + i), use_mosaic=mosaic) for i in range(N)])
    raw = PDA.collate_raw(_raw(ds, PDA.build_raw_sample, mosaic))
    got = PDA.make_augment_fn(cfg, MAX_BOXES)({k: torch.from_numpy(v) for k, v in raw.items()},
                                               raw["canvas"].shape[1] // PDA.canvas_multiplier(cfg.augment, mosaic))
    d = np.abs(got["image"].numpy().astype(int) - host["image"].astype(int))
    assert d.max() <= 2 and d.mean() < 1.0, (d.max(), d.mean())
    np.testing.assert_allclose(got["gt_boxes"].numpy(), host["gt_boxes"], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got["gt_labels"].numpy(), host["gt_labels"])
    np.testing.assert_array_equal(got["mask_gt"].numpy(), host["mask_gt"])
    for g, h in zip(got["masks"], host["masks"]):
        np.testing.assert_array_equal(g.numpy(), h)


def test_supported_equals_jax(synth):
    from mga_yolo_tpu.data import device_augment as JDA
    from mga_yolo_tpu_torch.data import device_augment as PDA

    cases = [{}, dict(mixup=0.2), dict(cutmix=0.2), dict(albumentations=0.5), dict(MGA_SKELETON_STRICT=True),
             dict(MGA_MASK_METHOD="pyrdown"), dict(MGA_MASK_METHOD="gaussian_maxpool"),
             dict(MGA_PROB_MODE=True, MGA_MASK_PROB_METHOD="gaussian"), *METHODS.values()]
    for kw in cases:
        jcfg, pcfg = _configs(synth, **kw)
        assert PDA.supported(pcfg) == JDA.supported(jcfg), kw
    assert not PDA.supported(_configs(synth, mixup=0.2)[1])[0]
    a = _configs(synth)[1].augment
    assert PDA.canvas_multiplier(a, True) == 2 and PDA.canvas_multiplier(a, False) == 1
    assert PDA.canvas_multiplier(dataclasses.replace(a, mosaic=0.0), True) == 1


def test_loader_raw_mode_batches_and_config(synth):
    from mga_yolo_tpu_torch.data import device_augment as PDA
    from mga_yolo_tpu_torch.data.dataset import MGADataset
    from mga_yolo_tpu_torch.data.loader import DataLoader

    _, cfg = _configs(synth, on_device=True, **GEOMETRY)
    assert cfg.augment.on_device  # load_config no longer refuses it
    loader = DataLoader(MGADataset(cfg, "train"), 4, seed=3, workers=2, device="cpu")
    loader.raw_mode = True
    (batch,) = list(loader)  # 6 images, batch 4, drop_last
    want = PDA.collate_raw([PDA.build_raw_sample(loader.dataset, int(i), np.random.default_rng(
        (3 * 1_000_003 + int(i)) % (2**63)), True) for i in batch["index"]])
    assert list(batch) == list(want)
    for k in want:
        np.testing.assert_array_equal(batch[k], want[k])
    assert PDA.batch_bytes(batch) == sum(v.nbytes for v in want.values())
    dev = loader.to_device(batch)
    assert dev["canvas"].dtype == torch.uint8 and dev["minv"].dtype == torch.float32


def test_one_epoch_on_device_trains_and_an_unsupported_config_uses_the_host(synth, tmp_path, capsys):
    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.train.trainer import MGATrainer

    kw = dict(data=str(synth), imgsz=IMGSZ, batch=4, epochs=1, max_boxes=MAX_BOXES, workers=2, device="cpu",
              project=str(tmp_path), plots=False, on_device=True, close_mosaic=0)
    tr = MGATrainer(load_config("configs/hyperparams/cbam_defaults.yaml", name="dev", **kw))
    assert tr.device_augment and tr.train_loader.raw_mode
    tr.train()
    with open(tr.save_dir / "results.csv", newline="") as f:
        (row,) = list(csv.DictReader(f))
    losses = [float(v) for k, v in row.items() if k.startswith("train/")]
    assert losses and all(np.isfinite(losses)) and float(row["train/det/total"]) > 0
    host = MGATrainer(load_config("configs/hyperparams/cbam_defaults.yaml", name="host", mixup=0.1, **kw))
    assert not host.device_augment and not host.train_loader.raw_mode
    assert "augment.on_device disabled: mixup/cutmix" in capsys.readouterr().out
