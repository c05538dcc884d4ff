"""PyTorch port, the losses against the JAX package.

CIoU and ``bbox2dist``, ``dfl_loss``, the tie-exact ``_kth_largest``, the task-aligned
assigner, ``v8_detection_loss`` (value and gradient w.r.t. the maps against
``jax.grad``), the segmentation loss in both modes, ``kendall_combine`` and
``mga_loss``. Same numpy inputs through both, float32 on the CPU.
Tolerances: values rtol 1e-4 (float32 sums in another order); gradients
rtol 1e-3 / atol 1e-5 * max|g|; the assigner's ``fg_mask`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mga_yolo_tpu import losses as JL
from mga_yolo_tpu.losses import detection as JD
from mga_yolo_tpu.losses import segmentation as JS
from mga_yolo_tpu.ops import boxes as JB
from mga_yolo_tpu_torch import losses as TL
from mga_yolo_tpu_torch.losses import detection as TD
from mga_yolo_tpu_torch.losses import segmentation as TS
from mga_yolo_tpu_torch.ops import boxes as TB
from tests._torch_port import few_torch_threads  # noqa: F401  (a module fixture)

pytestmark = pytest.mark.usefixtures("few_torch_threads")

STRIDES = (8, 16, 32)
IMGSZ = 64


def _boxes(rng, shape, lo=0.0, hi=64.0):
    xy = rng.uniform(lo, hi * 0.7, shape + (2,))
    wh = rng.uniform(2.0, hi * 0.4, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * float(np.abs(want).max()))


def test_ciou_and_bbox2dist_match_jax():
    rng = np.random.default_rng(0)
    b1, b2 = _boxes(rng, (3, 50)), _boxes(rng, (3, 50))
    b2[0, :5] = b1[0, :5]  # identical boxes: iou 1, v 0
    want = JB.bbox_iou_ciou(jnp.asarray(b1), jnp.asarray(b2))
    got = TB.bbox_iou_ciou(_t(b1), _t(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # planar JAX variant: same values
    want_p = JB.bbox_iou_ciou_p(jnp.asarray(b1.transpose(2, 0, 1)), jnp.asarray(b2.transpose(2, 0, 1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_p), rtol=1e-5, atol=1e-6)
    # gradient through box1 with alpha detached on both sides
    g_j = jax.grad(lambda a: JB.bbox_iou_ciou(a, jnp.asarray(b2)).sum())(jnp.asarray(b1))
    t1 = _t(b1).requires_grad_(True)
    TB.bbox_iou_ciou(t1, _t(b2)).sum().backward()
    _grad_close(t1.grad.numpy(), g_j)

    anc = rng.uniform(0, 8, (50, 2)).astype(np.float32)
    box = _boxes(rng, (3, 50), hi=8.0)
    np.testing.assert_allclose(TB.bbox2dist(_t(anc), _t(box), 15).numpy(),
                               np.asarray(JB.bbox2dist(jnp.asarray(anc), jnp.asarray(box), 15)), rtol=0, atol=0)
    np.testing.assert_allclose(TB.xyxy2xywh(_t(box)).numpy(), np.asarray(JB.xyxy2xywh(jnp.asarray(box))),
                               rtol=0, atol=0)


def test_dfl_loss_matches_jax_and_the_fused_ce():
    rng = np.random.default_rng(9)
    pd = rng.normal(0, 3, (2, 30, 4, 16)).astype(np.float32)
    target = rng.uniform(0, 15, (2, 30, 4)).astype(np.float32)
    target[0, :3] = np.floor(target[0, :3])
    got = TD.dfl_loss(_t(pd), _t(target), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(JD.dfl_loss(jnp.asarray(pd), jnp.asarray(target), 16)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), TD._dfl_ce(_t(pd), _t(target)).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1, 3, 10])
def test_kth_largest_with_ties(k):
    rng = np.random.default_rng(k)
    x = np.round(rng.uniform(0, 1, (2, 3, 40)) * 6) / 6  # many exact ties
    x[0, 0] = 0.0                                        # all-equal row
    x[1, 2, :5] = 1.0                                    # k-th inside a tie run
    x = x.astype(np.float32)
    got = TD._kth_largest(_t(x), k)
    want = np.sort(x, -1)[..., ::-1][..., k - 1:k]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JD._kth_largest(jnp.asarray(x), k)))


def _assigner_inputs(seed=0, B=2, A=84, M=5, nc=2):
    rng = np.random.default_rng(seed)
    anc, st = (np.asarray(a) for a in JB.make_anchors([(8, 8), (4, 4), (2, 2)], STRIDES))
    anc_px = anc * st
    scores = rng.uniform(0, 1, (B, A, nc)).astype(np.float32)
    pd_boxes = np.concatenate([anc_px - rng.uniform(2, 20, (B, A, 2)),
                               anc_px + rng.uniform(2, 20, (B, A, 2))], -1).astype(np.float32)
    gt = _boxes(rng, (B, M), hi=64.0)
    labels = rng.integers(0, nc, (B, M)).astype(np.int32)
    mask_gt = (rng.uniform(0, 1, (B, M)) < 0.7).astype(np.float32)
    mask_gt[:, 0] = 1.0
    return scores, pd_boxes, anc_px.astype(np.float32), labels, gt, mask_gt, nc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assigner_matches_jax(seed):
    scores, pd_boxes, anc, labels, gt, mask_gt, nc = _assigner_inputs(seed)
    tb_p, ts_j, fg_j = JD.task_aligned_assigner(
        jnp.asarray(scores), jnp.asarray(pd_boxes.transpose(2, 0, 1)), jnp.asarray(anc),
        jnp.asarray(labels), jnp.asarray(gt), jnp.asarray(mask_gt), nc)
    tb, ts, fg = TD.task_aligned_assigner(_t(scores), _t(pd_boxes), _t(anc), _t(labels), _t(gt),
                                          _t(mask_gt), nc)
    assert fg.sum() > 0
    np.testing.assert_array_equal(fg.numpy(), np.asarray(fg_j))
    np.testing.assert_allclose(tb.numpy(), np.asarray(tb_p).transpose(1, 2, 0), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ts_j), rtol=1e-4, atol=1e-6)


def _det_inputs(seed=0, B=2, M=4):
    rng = np.random.default_rng(seed)
    maps = [rng.normal(0, 1, (B, 65, IMGSZ // s, IMGSZ // s)).astype(np.float32) for s in STRIDES]
    gt = _boxes(rng, (B, M), hi=64.0)
    gt[..., 2:] += 8.0  # boxes large enough to hold anchor centres
    labels = np.zeros((B, M), np.int32)
    mask_gt = np.array([[1, 1, 1, 0], [1, 0, 0, 0]], np.float32)
    return maps, labels, gt, mask_gt


def _jax_maps(maps):
    return [jnp.asarray(m.transpose(0, 2, 3, 1)) for m in maps]


@pytest.mark.parametrize("seed", [0, 1])
def test_v8_detection_loss_value_and_grad_match_jax(seed):
    maps, labels, gt, mask_gt = _det_inputs(seed)

    def jloss(ms):
        return JD.v8_detection_loss(ms, STRIDES, jnp.asarray(labels), jnp.asarray(gt), jnp.asarray(mask_gt), 1)

    (total_j, comps_j), g_j = jax.value_and_grad(jloss, has_aux=True)(_jax_maps(maps))
    tmaps = [_t(m).requires_grad_(True) for m in maps]
    total, comps = TD.v8_detection_loss(tmaps, STRIDES, _t(labels), _t(gt), _t(mask_gt), 1)
    assert float(comps["box"]) > 0 and float(comps["dfl"]) > 0
    np.testing.assert_allclose(float(total.detach()), float(total_j), rtol=1e-4)
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(float(comps[k]), float(comps_j[k]), rtol=1e-4, err_msg=k)
    total.backward()
    for tm, gj in zip(tmaps, g_j):
        _grad_close(tm.grad.numpy(), np.asarray(gj).transpose(0, 3, 1, 2))


def _seg_inputs(seed=0, B=2):
    rng = np.random.default_rng(seed)
    preds = {k: rng.normal(0, 2, (B, 1, IMGSZ // s, IMGSZ // s)).astype(np.float32)
             for k, s in zip(("p3", "p4", "p5"), STRIDES)}
    tgts = [(rng.uniform(0, 1, (B, 1, IMGSZ // s, IMGSZ // s)) > 0.6).astype(np.float32) for s in STRIDES]
    return preds, tgts


@pytest.mark.parametrize("ufl", [False, True], ids=["bce_dice", "unified_focal"])
def test_segmentation_loss_matches_jax(ufl):
    preds, tgts = _seg_inputs(int(ufl))
    cfg_j = JS.SegLossConfig(use_unified_focal=ufl, scale_weights=(1.0, 0.5, 0.25))
    cfg_t = TS.SegLossConfig(use_unified_focal=ufl, scale_weights=(1.0, 0.5, 0.25))
    jp = {k: jnp.asarray(v.transpose(0, 2, 3, 1)) for k, v in preds.items()}
    (tot_j, logs_j), g_j = jax.value_and_grad(
        lambda p: JS.segmentation_loss(p, [jnp.asarray(t.transpose(0, 2, 3, 1)) for t in tgts], cfg_j),
        has_aux=True)(jp)
    tp = {k: _t(v).requires_grad_(True) for k, v in preds.items()}
    tot, logs = TS.segmentation_loss(tp, [_t(t) for t in tgts], cfg_t)
    assert set(logs) == set(logs_j)
    np.testing.assert_allclose(float(tot), float(tot_j), rtol=1e-4)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(logs_j[k]), rtol=1e-4, err_msg=k)
    tot.backward()
    for k in tp:
        _grad_close(tp[k].grad.numpy(), np.asarray(g_j[k]).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("prob_mode", [False, True], ids=["nearest", "bilinear_antialias"])
def test_segmentation_loss_resizes_targets_as_jax(prob_mode):
    """The safety net: GT at twice the prediction resolution."""
    preds, _ = _seg_inputs(3)
    rng = np.random.default_rng(4)
    big = [rng.uniform(0, 1, (2, 1, 2 * IMGSZ // s, 2 * IMGSZ // s)).astype(np.float32) for s in STRIDES]
    if not prob_mode:
        big = [(b > 0.5).astype(np.float32) for b in big]
    tot_j, _ = JS.segmentation_loss({k: jnp.asarray(v.transpose(0, 2, 3, 1)) for k, v in preds.items()},
                                    [jnp.asarray(b.transpose(0, 2, 3, 1)) for b in big],
                                    JS.SegLossConfig(prob_mode=prob_mode))
    tot, _ = TS.segmentation_loss({k: _t(v) for k, v in preds.items()}, [_t(b) for b in big],
                                  TS.SegLossConfig(prob_mode=prob_mode))
    np.testing.assert_allclose(float(tot), float(tot_j), rtol=1e-4)


def test_kendall_and_mga_loss_items_match_jax():
    from mga_yolo_tpu.losses.mtl import kendall_combine as jk
    from mga_yolo_tpu_torch.losses.mtl import kendall_combine as tk

    lv = np.array([0.3, -0.7], np.float32)
    tot_j, logs_j = jk(jnp.float32(2.5), jnp.float32(1.25), jnp.asarray(lv))
    tot, logs = tk(torch.tensor(2.5), torch.tensor(1.25), _t(lv))
    np.testing.assert_allclose(float(tot), float(tot_j), rtol=1e-6)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(logs_j[k]), rtol=1e-6, err_msg=k)

    maps, labels, gt, mask_gt = _det_inputs(2)
    preds, tgts = _seg_inputs(5)
    jb = {"gt_labels": jnp.asarray(labels), "gt_bboxes": jnp.asarray(gt), "mask_gt": jnp.asarray(mask_gt),
          "masks": [jnp.asarray(t.transpose(0, 2, 3, 1)) for t in tgts]}
    jout = {"det": _jax_maps(maps), "seg": {k: jnp.asarray(v.transpose(0, 2, 3, 1)) for k, v in preds.items()}}
    tot_j, items_j, _ = JL.mga_loss(jout, jb, STRIDES, 1, jnp.asarray(lv))
    tb = {"gt_labels": _t(labels), "gt_bboxes": _t(gt), "mask_gt": _t(mask_gt), "masks": [_t(t) for t in tgts]}
    tout = {"det": [_t(m) for m in maps], "seg": {k: _t(v) for k, v in preds.items()}}
    tot, items, logs = TL.mga_loss(tout, tb, STRIDES, 1, _t(lv))
    assert TL.LOSS_ITEM_NAMES == JL.LOSS_ITEM_NAMES and items.shape == (10,)
    np.testing.assert_allclose(float(tot), float(tot_j), rtol=1e-4)
    np.testing.assert_allclose(items.numpy(), np.asarray(items_j), rtol=1e-4)
    # eval-mode det output (decoded, maps) takes the maps
    tot2, _, _ = TL.mga_loss({**tout, "det": (None, tout["det"])}, tb, STRIDES, 1, _t(lv))
    assert float(tot2) == float(tot)
