"""PyTorch port, the config and data stack (no OpenCV, no PyYAML) against
the JAX package's cv2 / PyYAML path.

Both run here on the same inputs: arrays from numpy seeds and datasets from
``tests/synth.create_synthetic_dataset`` (PNGs that cv2 wrote). Tolerances:

* PNG decoding, the affine matrix, kfold indices, the YAML subset and the
  shipped config dicts: exact.
* Warps and HSV, the JAX package's own bounds for its cv2-free versions
  (tests/test_device_augment.py): the bilinear image warp within 1 grey
  level of cv2, the nearest mask warp differing in < 0.5% of pixels, HSV
  p99 <= 2 and mean < 1 grey level.
* Mask pyramids: exact, but for three methods whose cv2 call rounds in
  float32 where the port computes in float64. ``area`` (cv2 INTER_AREA): a
  coarse cell may differ only where its box average lies within 1e-5 of a
  rounding tie (x.5), which happens only when the size does not divide by
  the stride. ``gaussian_maxpool``: the port blurs within 2e-4 of cv2's
  GaussianBlur, so a cell may differ only where the pooled blur lies within
  2e-4 of the threshold; it is exact against the JAX package's numpy path
  (see below). ``pyrdown`` is integer arithmetic in both: exact.
* ``MGADataset.get``, train and eval, the same seed: gt_boxes atol 1e-3,
  gt_labels and mask_gt equal, mask pyramids differing in < 0.5% of cells,
  and images within 1 grey level (the letterbox resize and the warp) or,
  where the profile jitters HSV, within that level passed through the HSV
  step plus the HSV bound: p99 <= 1 + 2, mean < 1 (the one-level warp
  difference enters HSV, whose gains reach 1.7). The profiles that mix two
  samples (mixup, cutmix) run with HSV off:
  there each sample is jittered, blended, and the blend jittered again,
  and two HSV steps compound the one-level differences past that bound.

The JAX package's ``gaussian_maxpool`` gives its float blur to the C++ block
max, which casts it to uint8 (``mga_yolo_tpu/native/__init__.py``
``block_reduce_max``), so with its native library loaded the blur truncates
to 0 almost everywhere; the port takes the float max, as the JAX package's
numpy path does, and is compared with that path.
"""

import dataclasses
import struct
import sys
import zlib
from pathlib import Path
from unittest import mock

import cv2
import numpy as np
import pytest
import torch
import yaml

from tests.synth import create_synthetic_dataset

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------------ image I/O


def _image(seed=0, shape=(37, 53, 3)):
    rng = np.random.default_rng(seed)
    return cv2.GaussianBlur(rng.integers(0, 256, shape).astype(np.uint8), (5, 5), 1.5)


@pytest.mark.parametrize("kind", ["grey", "bgr", "bgra", "grey_noise"])
def test_imread_equals_cv2_and_round_trips(tmp_path, kind):
    from mga_yolo_tpu_torch.data import image_io

    img = {"grey": _image()[..., 0], "bgr": _image(), "bgra": np.dstack([_image(), _image(1)[..., 0]]),
           "grey_noise": np.random.default_rng(2).integers(0, 256, (64, 48)).astype(np.uint8)}[kind]
    path = tmp_path / "a.png"
    cv2.imwrite(str(path), img)
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(str(path)))
    np.testing.assert_array_equal(image_io.imread_gray(path), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    out = tmp_path / "b.png"
    image_io.imwrite(out, img)
    np.testing.assert_array_equal(cv2.imread(str(out), cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(image_io.imread(out), cv2.imread(str(path)))
    assert image_io.image_size(out) == img.shape[:2]


def _png(rows: np.ndarray, ctype: int, filters, extra: bytes = b"") -> bytes:
    """A PNG of (h, w * c) uint8 rows, row y filtered with filters[y % 5]."""
    h, stride = rows.shape
    bpp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    prev = np.zeros(stride, np.int32)
    raw = bytearray()
    for y in range(h):
        r, ft = rows[y].astype(np.int32), filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ft == 0:
            pred = np.zeros_like(r)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) >> 1
        else:
            q = left + prev - upleft
            pa, pb, pc = np.abs(q - left), np.abs(q - prev), np.abs(q - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw += bytes([ft]) + ((r - pred) & 255).astype(np.uint8).tobytes()
        prev = r

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    w = stride // bpp
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)) + extra
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype", [0, 2, 4, 6, 3], ids=["grey", "rgb", "grey_alpha", "rgba", "palette"])
def test_every_filter_and_colour_type_decodes_as_cv2(tmp_path, ctype):
    """Rows filtered None / Sub / Up / Average / Paeth in turn; the C++
    unfilter and its numpy twin agree, and imread equals cv2.imread."""
    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data import image_io

    rng = np.random.default_rng(ctype)
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    h, w = 21, 17
    extra = b""
    if ctype == 3:
        rows = rng.integers(0, 40, (h, w)).astype(np.uint8)
        body = rng.integers(0, 256, (40, 3)).astype(np.uint8).tobytes()
        extra = struct.pack(">I", len(body)) + b"PLTE" + body + struct.pack(">I", zlib.crc32(b"PLTE" + body))
    else:
        rows = _image(ctype, (h, w * c))
    data = _png(rows, ctype, (0, 1, 2, 3, 4), extra)
    (tmp_path / "f.png").write_bytes(data)
    np.testing.assert_array_equal(image_io.imread(tmp_path / "f.png"), cv2.imread(str(tmp_path / "f.png")))
    if ctype != 3:
        raw = np.frombuffer(zlib.decompress(data[data.index(b"IDAT") + 4:-16]), np.uint8)  # to CRC + IEND
        np.testing.assert_array_equal(image_io.unfilter_rows(raw, h, w * c, c), rows)
        native.load()
        np.testing.assert_array_equal(native.png_unfilter(raw, h, w * c, c), rows)


def test_formats_the_port_does_not_read_raise_naming_the_file(tmp_path):
    """A JPEG reads as cv2 reads it and ``imwrite`` writes ``.jpg`` as cv2
    writes it; 16-bit and interlaced PNGs and TIFF, once refused, now read
    as cv2 reads them, at the JAX package's ``image_size``; a suffix the
    port does not write still raises, naming the file."""
    from mga_yolo_tpu.data.dataset import image_size as jax_image_size
    from mga_yolo_tpu_torch.data import image_io
    from tests.still_fixtures.writers import png_bytes

    img = _image()
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    np.testing.assert_array_equal(image_io.imread(tmp_path / "a.jpg"), cv2.imread(str(tmp_path / "a.jpg")))
    cv2.imwrite(str(tmp_path / "b16.png"), img.astype(np.uint16) * 257)
    (tmp_path / "c.png").write_bytes(png_bytes(img[..., :1], 8, 0, interlace=True))  # Adam7
    cv2.imwrite(str(tmp_path / "d.tif"), img)
    for name in ("b16.png", "c.png", "d.tif"):
        path = tmp_path / name
        np.testing.assert_array_equal(image_io.imread(path), cv2.imread(str(path)))
        np.testing.assert_array_equal(image_io.imread_gray(path), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
        assert image_io.image_size(path) == jax_image_size(path) == (37, 53)
    image_io.imwrite(tmp_path / "x.jpg", img)
    assert (tmp_path / "x.jpg").read_bytes() == cv2.imencode(".jpg", img)[1].tobytes()
    with pytest.raises(ValueError, match=r"x\.tif: the port writes \.png, \.jpg and \.jpeg"):
        image_io.imwrite(tmp_path / "x.tif", img)


# ------------------------------------------------------------ YAML and config


def _yaml_files():
    return sorted(str(p.relative_to(ROOT)) for p in ROOT.glob("configs/**/*.yaml"))


@pytest.mark.parametrize("path", _yaml_files())
def test_yaml_reader_equals_safe_load(path):
    from mga_yolo_tpu_torch.utils import yaml_lite

    assert yaml_lite.load(ROOT / path) == yaml.safe_load((ROOT / path).read_text())


def test_yaml_reader_on_the_synthetic_data_yaml_and_edge_cases(tmp_path):
    from mga_yolo_tpu_torch.utils import yaml_lite

    data_yaml = create_synthetic_dataset(tmp_path, n=1, size=32)
    assert yaml_lite.load(data_yaml) == yaml.safe_load(data_yaml.read_text())
    text = ("# c\nk1: 1e-3\nk2: 5.0e-4\nk3: 017\nk4: 0x1F\nk5: ~\nk6:\nk7: 'it''s'\nk8: \"a\\tb\"\n"
            "k9: [1, [2, 3], {b: 4, c: [5]}]\nk10: yes\nk11: On\nk12: y\nk13: x #c\n'q k': .inf\n"
            "k14:\n  - a\n  - [1, 2]\nk15:\n- 1\n- 2\nk16:\n  0: s\n  x: [1]\n")
    assert yaml_lite.loads(text) == yaml.safe_load(text)
    for bad in ("a: &x 1", "a: |\n  t", "a:\n  b:\n    c: 1", "a: 2001-01-01", "a: [1, 2"):
        with pytest.raises(ValueError, match="line"):
            yaml_lite.loads(bad)


def test_yaml_writer_equals_safe_dump():
    from mga_yolo_tpu_torch.utils import yaml_lite

    d = {"path": "/data/fold_0", "train": "images/train", "dataset": "/data/ar cade", "names": {0: "stenosis",
         1: "no", 2: "1.5"}, "nc": 3, "flag": True, "none": None, "f": 0.5, "l": [1, "a"], "q": "a: b"}
    assert yaml_lite.dumps(d) == yaml.safe_dump(d)
    assert yaml.safe_load(yaml_lite.dumps(d)) == d


def test_shipped_config_dicts_equal_their_yaml():
    from mga_yolo_tpu_torch.configs import HYPERPARAMS, MGA_DATA

    for stem, cfg in HYPERPARAMS.items():
        assert cfg == yaml.safe_load((ROOT / f"configs/hyperparams/{stem}.yaml").read_text()), stem
    assert MGA_DATA == yaml.safe_load((ROOT / "configs/data/mga_data.yaml").read_text())


@pytest.mark.parametrize("stem", ["base_defaults", "cbam_defaults", "eca_defaults", "spade_defaults"])
def test_load_config_equals_jax(tmp_path, monkeypatch, stem):
    """Every section of the port's config equals the JAX package's, from the
    shipped profile (read as a dict, PyYAML blocked) plus MGA_* and perf
    overrides; the JAX perf keys land in ``extra``."""
    from mga_yolo_tpu.config import load_config as jload
    from mga_yolo_tpu_torch import config as C

    data_yaml = create_synthetic_dataset(tmp_path, n=1, size=32)
    kw = dict(data=str(data_yaml), MGA_PROB_MODE="true", MGA_SAVE_LAYERS="15,18", cache="disk", kth_impl="approx",
              custom_key=3)
    want = jload(f"configs/hyperparams/{stem}.yaml", **kw)
    monkeypatch.setitem(sys.modules, "yaml", None)
    got = C.load_config(f"/nowhere/{stem}.yaml", **kw)
    for section in ("train", "data", "augment", "mask", "seg"):
        assert dataclasses.asdict(getattr(got, section)) == dataclasses.asdict(getattr(want, section)), section
    assert got.extra == {**want.extra, "kth_impl": "approx"}
    monkeypatch.undo()
    from mga_yolo_tpu.config import det_loss_config, seg_loss_config

    assert dataclasses.asdict(C.det_loss_config(got)) == dataclasses.asdict(det_loss_config(want))
    assert dataclasses.asdict(C.seg_loss_config(got)) == dataclasses.asdict(seg_loss_config(want))
    on_dev = C.load_config({"on_device": True})  # device-side augmentation is ported: accepted
    assert on_dev.augment.on_device
    assert dataclasses.asdict(on_dev.augment) == dataclasses.asdict(jload({"on_device": True}).augment)


@pytest.mark.parametrize("stem", ["cbam_defaults", "yolov8"])
def test_an_edited_shipped_yaml_on_disk_is_read_as_edited(tmp_path, monkeypatch, stem):
    """A file that exists is read from disk, even when its stem names a
    shipped dict: an edited cbam_defaults.yaml or a user's own yolov8.yaml
    keeps its edits, equal to the JAX package's reading of the same file."""
    from mga_yolo_tpu.config import load_config as jload
    from mga_yolo_tpu.graph import parse_graph as jparse
    from mga_yolo_tpu_torch.config import load_config
    from mga_yolo_tpu_torch.graph import parse_graph

    src = ROOT / ("configs/hyperparams" if stem.endswith("defaults") else "configs/models") / f"{stem}.yaml"
    edits = ({"lr0: 0.01\n": "lr0: 0.0123\n", "fliplr: 0.2\n": "fliplr: 0.7\n",
              "MGA_MASK_METHOD: skeleton_bresenham\n": "MGA_MASK_METHOD: area\n"} if stem == "cbam_defaults" else
             {"nc: 1\n": "nc: 7\n", "[-1, 1, Conv, [64, 3, 2]]": "[-1, 1, Conv, [32, 3, 2]]"})  # stem conv narrowed
    text = src.read_text()
    for old, new in edits.items():
        assert old in text, old
        text = text.replace(old, new, 1)
    edited = tmp_path / f"{stem}.yaml"
    edited.write_text(text)
    if stem == "cbam_defaults":
        want = jload(edited)
        monkeypatch.setitem(sys.modules, "yaml", None)
        got = load_config(edited)
        assert (got.train.lr0, got.augment.fliplr, got.mask.method) == (0.0123, 0.7, "area")
        for section in ("train", "data", "augment", "mask", "seg"):
            assert dataclasses.asdict(getattr(got, section)) == dataclasses.asdict(getattr(want, section)), section
    else:
        want = dataclasses.asdict(jparse(str(edited)))
        monkeypatch.setitem(sys.modules, "yaml", None)
        got = dataclasses.asdict(parse_graph(str(edited)))
        shipped = dataclasses.asdict(parse_graph(f"/nonexistent/{stem}.yaml"))
        assert got == want
        assert got["nc"] == 7 and got["nodes"][0]["c_out"] == shipped["nodes"][0]["c_out"] // 2


# ------------------------------------------------------- transforms and warps


@pytest.mark.parametrize("seed", range(6))
def test_affine_matrix_is_bit_identical(seed):
    from mga_yolo_tpu.data import transforms as JT
    from mga_yolo_tpu_torch.data import transforms as PT

    for args in (((64, 64), (96, 96, 3), 10.0, 0.1, 0.5, 5.0, 0.0), ((640, 640), (640, 640, 3), 0.0, 0.2, 0.2, 0.0, 0.0),
                 ((64, 48), (96, 72, 3), 30.0, 0.3, 0.9, 10.0, 0.001)):
        a, sa = JT._affine_matrix(np.random.default_rng(seed), *args)
        b, sb = PT._affine_matrix(np.random.default_rng(seed), *args)
        assert a.dtype == b.dtype == np.float32 and sa == sb
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("perspective", [0.0, 0.0005])
@pytest.mark.parametrize("seed", range(3))
def test_warps_match_cv2(perspective, seed):
    from mga_yolo_tpu.data import transforms as JT
    from mga_yolo_tpu_torch.data import transforms as PT

    img = _image(seed, (96, 96, 3))
    mask = cv2.dilate((np.random.default_rng(seed).uniform(0, 1, (96, 96)) > 0.7).astype(np.uint8),
                      np.ones((3, 3), np.uint8))
    M, _ = JT._affine_matrix(np.random.default_rng(seed + 1), (64, 64), img.shape, 10.0, 0.1, 0.5, 5.0, perspective)
    if perspective:
        ref = cv2.warpPerspective(img, M, (64, 64), borderValue=(114,) * 3)
        mref = cv2.warpPerspective(mask, M, (64, 64), flags=cv2.INTER_NEAREST, borderValue=0)
    else:
        ref = cv2.warpAffine(img, M[:2], (64, 64), borderValue=(114,) * 3)
        mref = cv2.warpAffine(mask, M[:2], (64, 64), flags=cv2.INTER_NEAREST, borderValue=0)
    assert np.abs(PT.warp_bilinear(img, M, (64, 64), bool(perspective)).astype(int) - ref).max() <= 1
    assert (PT.warp_nearest(mask, M, (64, 64), bool(perspective)) != mref).mean() < 0.005


def test_hsv_jitter_matches_cv2():
    from mga_yolo_tpu.data import transforms as JT
    from mga_yolo_tpu_torch.data import transforms as PT

    img = np.random.default_rng(0).integers(0, 256, (64, 64, 3)).astype(np.uint8)
    gains = np.array([0.015, 0.7, 0.4])
    for trial in range(3):
        rng_j, rng_p = np.random.default_rng(trial), np.random.default_rng(trial)
        want = JT.random_hsv({"img": img.copy()}, rng_j, *gains)["img"]
        got = PT.random_hsv({"img": img.copy()}, rng_p, *gains)["img"]
        d = np.abs(got.astype(int) - want)
        assert np.percentile(d, 99) <= 2 and d.mean() < 1.0, (d.mean(), d.max())
        assert rng_j.random() == rng_p.random()  # the same draws were consumed


def test_mosaics_mixup_cutmix_and_flip_equal_jax():
    """Pure array placement: the same seed gives the same arrays."""
    from mga_yolo_tpu.data import transforms as JT
    from mga_yolo_tpu_torch.data import transforms as PT

    rng = np.random.default_rng(0)

    def sample(i):
        img = _image(i, (40 + 3 * i, 48, 3))
        b = np.array([[2, 3, 20, 25], [10, 5, 30, 35]], np.float32)
        return {"img": img, "boxes": b, "cls": np.array([0, 1], np.float32),
                "mask": (rng.uniform(0, 1, img.shape[:2]) > 0.6).astype(np.uint8)}

    parts = [sample(i) for i in range(9)]
    for fn, n in (("mosaic3", 3), ("mosaic4", 4), ("mosaic9", 9)):
        a = getattr(JT, fn)(parts[:n], np.random.default_rng(5), 48)
        b = getattr(PT, fn)(parts[:n], np.random.default_rng(5), 48)
        for k in ("img", "boxes", "cls", "mask"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{fn} {k}")
    for fn in ("mixup", "cutmix"):
        a = getattr(JT, fn)(parts[1], {**parts[1], "img": parts[1]["img"][::-1].copy()}, np.random.default_rng(6))
        b = getattr(PT, fn)(parts[1], {**parts[1], "img": parts[1]["img"][::-1].copy()}, np.random.default_rng(6))
        for k in ("img", "boxes", "cls", "mask"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{fn} {k}")
    a = JT.random_flip(parts[2], np.random.default_rng(7), 1.0, 1.0)
    b = PT.random_flip(parts[2], np.random.default_rng(7), 1.0, 1.0)
    for k in ("img", "boxes", "mask"):
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(NotImplementedError, match="albumentations"):
        PT.albumentations(parts[0], rng)


# ---------------------------------------------------------------- mask ops


def _vessel(h, w, seed):
    r = np.random.default_rng(seed)
    m = np.zeros((h, w), np.uint8)
    for _ in range(6):
        pts = (r.uniform(0, 1, (5, 2)) * [w, h]).astype(np.int32)
        cv2.polylines(m, [pts], False, 255, int(r.integers(1, 6)))
    return m


MASK_SHAPES = [(128, 128), (100, 72), (97, 131), (256, 192)]
METHODS = [("nearest", False, True), ("area", False, True), ("area", False, False), ("maxpool", False, True),
           ("pyrdown", False, True), ("pyrdown", False, False), ("skeleton_bresenham", False, True),
           ("skeleton_bresenham", False, False), ("skeleton_bresenham", True, True),
           ("skeleton_bresenham", True, False)]


@pytest.mark.parametrize("method,strict,bridge", METHODS)
def test_downsample_mask_equals_jax(method, strict, bridge):
    from mga_yolo_tpu.config import MaskPipelineConfig as JC
    from mga_yolo_tpu.data import mask_ops as J
    from mga_yolo_tpu_torch.config import MaskPipelineConfig as PC
    from mga_yolo_tpu_torch.data import mask_ops as P

    for h, w in MASK_SHAPES:
        m = _vessel(h, w, h + w)
        want = J.downsample_mask_multi(m, (8, 16, 32), JC(method=method, skeleton_strict=strict, bridge=bridge))
        got = P.downsample_mask_multi(m, (8, 16, 32), PC(method=method, skeleton_strict=strict, bridge=bridge))
        for s in (8, 16, 32):
            assert got[s].dtype == np.uint8 and got[s].shape == want[s].shape
            if method == "area":
                # before the close: cells may differ only at a rounding tie of
                # the box average, which needs a size the stride does not divide
                binary = (m > 0).astype(np.uint8)
                pre_p = P.resize_area(binary, got[s].shape)
                pre_j = cv2.resize(binary, got[s].shape[::-1], interpolation=cv2.INTER_AREA)
                apart = pre_p != pre_j
                if apart.any():
                    assert h % s or w % s
                    avg = P.resize_area(binary.astype(np.float64), got[s].shape)
                    assert (np.abs(avg[apart] - 0.5) < 1e-5).all()
                    continue
            np.testing.assert_array_equal(got[s], want[s], err_msg=f"{h}x{w} stride {s}")


def test_gaussian_maxpool_equals_jax_numpy_path():
    from mga_yolo_tpu import native as jnative
    from mga_yolo_tpu.config import MaskPipelineConfig as JC
    from mga_yolo_tpu.data import mask_ops as J
    from mga_yolo_tpu_torch.config import MaskPipelineConfig as PC
    from mga_yolo_tpu_torch.data import mask_ops as P

    for h, w in MASK_SHAPES + [(640, 640)]:
        m = _vessel(h, w, h * w)
        for s in (8, 16, 32):
            with mock.patch.object(jnative, "block_reduce_max", lambda *a: None):
                want = J.downsample_mask(m, s, JC(method="gaussian_maxpool"))
            got = P.downsample_mask(m, s, PC(method="gaussian_maxpool"))
            np.testing.assert_array_equal(got, want)
    # the blur itself against cv2's
    x = np.random.default_rng(0).random((45, 67)).astype(np.float32)
    for sigma in (4.0, 8.0, 16.0):
        ref = cv2.GaussianBlur(x, (0, 0), sigmaX=sigma, sigmaY=sigma, borderType=cv2.BORDER_REFLECT)
        assert np.abs(P.gaussian_blur(x, sigma) - ref).max() < 2e-4


@pytest.mark.parametrize("method", ["area", "avgpool", "nearest"])
def test_downsample_mask_prob_equals_jax(method):
    from mga_yolo_tpu.data import mask_ops as J
    from mga_yolo_tpu_torch.data import mask_ops as P

    for h, w in MASK_SHAPES:
        m = _vessel(h, w, abs(h - w))
        for s in (8, 16, 32):
            want, got = J.downsample_mask_prob(m, s, method), P.downsample_mask_prob(m, s, method)
            assert got.dtype == np.float32 and got.shape == want.shape
            if method == "area" and (h % s or w % s):  # a tie may round apart: see test_downsample_mask_equals_jax
                assert (got != want).mean() < 0.02
            else:
                np.testing.assert_array_equal(got, want)


def test_area_and_pyrdown_match_cv2_on_grey_levels():
    from mga_yolo_tpu_torch.data import mask_ops as P

    x = np.random.default_rng(1).integers(0, 256, (45, 67)).astype(np.uint8)
    np.testing.assert_array_equal(P.pyr_down(x), cv2.pyrDown(x))
    for hw in ((5, 7), (15, 22), (23, 33), (9, 67 // 5)):
        np.testing.assert_array_equal(P.resize_area(x, hw), cv2.resize(x, hw[::-1], interpolation=cv2.INTER_AREA))
    half = np.zeros((64, 64), np.uint8)
    half[:, ::2] = 1  # every block exactly half full: the tie
    for s in (2, 4, 8):
        np.testing.assert_array_equal(P.resize_area(half, (64 // s, 64 // s)),
                                      cv2.resize(half, (64 // s, 64 // s), interpolation=cv2.INTER_AREA))


def test_native_mask_ops_equal_their_numpy_twins():
    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data import mask_ops as P

    native.load()
    for h, w in MASK_SHAPES:
        m = (_vessel(h, w, 7 * h) > 0).astype(np.uint8)
        for k in (8, 16, 32):
            np.testing.assert_array_equal(native.block_reduce_max(m, k), P._blocks(m, k).max(axis=(1, 3)))
            np.testing.assert_array_equal(native.block_reduce_mean(m, k),
                                          P._blocks(m.astype(np.float32), k).mean(axis=(1, 3), dtype=np.float32))
        np.testing.assert_array_equal(native.close3x3(m), P.close3x3_numpy(m))
        np.testing.assert_array_equal(native.close3x3(m), cv2.morphologyEx(m, cv2.MORPH_CLOSE, np.ones((3, 3), np.uint8)))
        np.testing.assert_array_equal(native.zhang_suen_thin(m), P.zhang_suen_thin(m))
        skel = P.skeletonize(m)
        edges = P.skeleton_edges(skel)
        for k in (8, 32):
            a = np.zeros(-(-np.array(m.shape) // k), np.uint8)
            b = a.copy()
            native.rasterize_edges(edges, k, a)
            P.rasterize_edges_numpy(edges, k, b)
            np.testing.assert_array_equal(a, b)


def test_native_library_that_does_not_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    """No silent numpy path: a source g++ rejects makes load() and the mask
    ops raise RuntimeError carrying g++'s error, on every call."""
    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data import mask_ops as P

    bad = tmp_path / "maskops.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    for call in (native.load, lambda: P.close3x3(np.zeros((8, 8), np.uint8))):
        with pytest.raises(RuntimeError, match=r"maskops\.cpp is not available: g\+\+ .* failed:\n.*error"):
            call()


@pytest.mark.parametrize("connectivity", [4, 8])
def test_connected_components_equals_cv2(connectivity):
    from mga_yolo_tpu_torch.data import mask_ops as P

    for h, w in MASK_SHAPES:
        for m in (_vessel(h, w, h), (np.random.default_rng(w).uniform(0, 1, (h, w)) > 0.6).astype(np.uint8)):
            n, _ = cv2.connectedComponents((m > 0).astype(np.uint8), connectivity=connectivity)
            assert P.connected_components(m, connectivity) == n - 1
    assert P.connected_components(np.zeros((5, 5), np.uint8)) == 0


# ----------------------------------------------------------------- dataset


def _configs(data_yaml, **over):
    from mga_yolo_tpu.config import load_config as jload
    from mga_yolo_tpu_torch.config import load_config as pload

    kw = dict(data=str(data_yaml), imgsz=64, max_boxes=8, **over)
    return jload(**kw), pload(**kw)


NO_HSV = dict(hsv_h=0.0, hsv_s=0.0, hsv_v=0.0)
PROFILES = {
    "cbam_defaults": dict(),  # the shipped medical profile (set below): mild geometry, no mosaic or HSV
    "default_mosaic": dict(degrees=10.0, shear=2.0),  # the config defaults: mosaic 1.0, HSV, scale 0.5, flips
    "mosaic9_mixup": dict(mosaic_n=9, mixup=0.5, flipud=0.5, **NO_HSV),
    "mosaic3_cutmix_prob": dict(mosaic_n=3, cutmix=0.5, MGA_PROB_MODE=True, MGA_MASK_PROB_METHOD="avgpool",
                                **NO_HSV),
    "strict_skeleton": dict(MGA_SKELETON_STRICT=True, perspective=0.0005, **NO_HSV),
}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return create_synthetic_dataset(tmp_path_factory.mktemp("synth"), n=6, size=96, seed=3)


@pytest.fixture(scope="module")
def synth_jpg(synth, tmp_path_factory):
    """``synth`` as JPEG files (cv2.imwrite, quality 95) of three aspects:
    image i resized to 96 x 96, 64 rows x 96 or 96 rows x 64 (the labels are
    normalised, so they still hold), image 1 stored turned a quarter with
    EXIF orientation 6 (written with PIL) so that it decodes upright, and
    the masks of the even images as JPEG too. The rect buckets then differ."""
    import io

    from PIL import Image

    src, root = synth.parent, tmp_path_factory.mktemp("synth_jpg")
    for d in ("images/train", "labels/train", "masks"):
        (root / d).mkdir(parents=True)
    for i, png in enumerate(sorted((src / "images" / "train").glob("*.png"))):
        size = ((96, 96), (96, 64), (64, 96))[i % 3]  # (w, h)
        img = cv2.resize(cv2.imread(str(png)), size, interpolation=cv2.INTER_LINEAR)
        mask = cv2.resize(cv2.imread(str(src / "masks" / png.name), cv2.IMREAD_GRAYSCALE), size,
                          interpolation=cv2.INTER_NEAREST)
        if i == 1:
            exif = Image.Exif()
            exif[0x0112] = 6  # shown turned a quarter clockwise
            buf = io.BytesIO()
            Image.fromarray(np.ascontiguousarray(np.rot90(img, 1)[..., ::-1])).save(buf, "JPEG", quality=95,
                                                                                     exif=exif.tobytes())
            (root / "images" / "train" / f"{png.stem}.jpg").write_bytes(buf.getvalue())
        else:
            cv2.imwrite(str(root / "images" / "train" / f"{png.stem}.jpg"), img)
        cv2.imwrite(str(root / "masks" / f"{png.stem}{'.jpg' if i % 2 == 0 else '.png'}"), mask)
        (root / "labels" / "train" / f"{png.stem}.txt").write_text(
            (src / "labels" / "train" / f"{png.stem}.txt").read_text())
    data = yaml.safe_load(synth.read_text())
    data.update(path=str(root), dataset=str(root))
    (root / "data.yaml").write_text(yaml.safe_dump(data))
    return root / "data.yaml"


def _assert_samples_match(got, want, what, hsv=False):
    assert set(got) == set(want)
    np.testing.assert_allclose(got["gt_boxes"], want["gt_boxes"], rtol=0, atol=1e-3, err_msg=what)
    np.testing.assert_array_equal(got["gt_labels"], want["gt_labels"], err_msg=what)
    np.testing.assert_array_equal(got["mask_gt"], want["mask_gt"], err_msg=what)
    assert got["index"] == want["index"]
    assert got["image"].shape == want["image"].shape and got["image"].dtype == np.uint8
    d = np.abs(got["image"].astype(int) - want["image"])
    if hsv:
        assert np.percentile(d, 99) <= 1 + 2 and d.mean() < 1.0, (what, np.percentile(d, 99), d.mean())
    else:
        assert d.max() <= 1, (what, d.max())
    for a, b in zip(got["masks"], want["masks"]):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        assert (a != b).mean() < 0.005, (what, (a != b).mean())


@pytest.mark.parametrize("profile, ext", [pytest.param(p, e, id=p + "-jpg" * (e == "jpg"))
                                          for e in ("png", "jpg") for p in PROFILES])
def test_dataset_train_samples_equal_jax(request, profile, ext):
    from mga_yolo_tpu.config import load_config as jload
    from mga_yolo_tpu.data.dataset import MGADataset as JDS
    from mga_yolo_tpu_torch.config import load_config as pload
    from mga_yolo_tpu_torch.data.dataset import MGADataset as PDS

    synth = request.getfixturevalue({"png": "synth", "jpg": "synth_jpg"}[ext])

    if profile == "cbam_defaults":
        kw = dict(data=str(synth), imgsz=64, max_boxes=8)
        jcfg, pcfg = jload("configs/hyperparams/cbam_defaults.yaml", **kw), pload("configs/hyperparams/cbam_defaults.yaml", **kw)
    else:
        jcfg, pcfg = _configs(synth, **PROFILES[profile])
    jds, pds = JDS(jcfg, "train", augment=True), PDS(pcfg, "train", augment=True)
    assert [p.name for p in jds.img_files] == [p.name for p in pds.img_files]
    for i in range(len(jds)):
        for seed in (0, 1):
            rj, rp = np.random.default_rng(seed * 100 + i), np.random.default_rng(seed * 100 + i)
            hsv = bool(pcfg.augment.hsv_h or pcfg.augment.hsv_s or pcfg.augment.hsv_v)
            _assert_samples_match(pds.get(i, rp), jds.get(i, rj), f"{profile} {i} {seed}", hsv)
            assert rj.random() == rp.random()  # the same random draws were consumed


@pytest.mark.parametrize("rect, ext", [pytest.param(r, e, id=str(r) + "-jpg" * (e == "jpg"))
                                       for e in ("png", "jpg") for r in (False, True)])
def test_dataset_eval_samples_equal_jax(request, rect, ext):
    from mga_yolo_tpu.data.dataset import MGADataset as JDS
    from mga_yolo_tpu_torch.data.dataset import MGADataset as PDS

    synth = request.getfixturevalue({"png": "synth", "jpg": "synth_jpg"}[ext])
    jcfg, pcfg = _configs(synth, rect=rect, cache="ram")
    jds, pds = JDS(jcfg, "val", augment=False), PDS(pcfg, "val", augment=False)
    assert {p.suffix for p in pds.img_files} == {f".{ext}"}
    if rect:
        np.testing.assert_array_equal(pds.bucket, jds.bucket)
        assert len(set(pds.bucket.tolist())) == (3 if ext == "jpg" else 1)  # wide, square and tall
    for i in range(len(jds)):
        _assert_samples_match(pds.get(i), jds.get(i), f"eval {i}")


def test_dataset_options_cache_fraction_single_cls_and_dumps(synth, tmp_path):
    from mga_yolo_tpu_torch.data.dataset import MGADataset, collate

    _, cfg = _configs(synth, cache="disk", fraction=0.5, single_cls=True, MGA_SAVE_AUG_MASKS=True,
                      project=str(tmp_path), name="run")
    ds = MGADataset(cfg, "train", augment=True)
    assert len(ds) == 3 and ds.cache_mode == "disk"
    assert all(ds._npy_sidecar(i).exists() for i in range(len(ds)))
    batch = collate([ds.get(i, np.random.default_rng(i)) for i in range(len(ds))])
    assert batch["image"].shape == (3, 64, 64, 3) and [m.shape for m in batch["masks"]] == [
        (3, 8, 8, 1), (3, 4, 4, 1), (3, 2, 2, 1)]
    assert (batch["gt_labels"] == 0).all()
    dumps = sorted(p.name for p in (tmp_path / "run" / "aug_debug").iterdir())
    assert dumps[:2] == ["aug_0_img.png", "aug_0_mask.png"]


# ------------------------------------------------------------------ loader


def test_loader_order_and_batches_equal_jax(synth):
    from mga_yolo_tpu.data.dataset import MGADataset as JDS
    from mga_yolo_tpu.data.loader import DataLoader as JDL
    from mga_yolo_tpu_torch.data.dataset import MGADataset as PDS
    from mga_yolo_tpu_torch.data.loader import DataLoader as PDL

    jcfg, pcfg = _configs(synth, close_mosaic=2)
    jdl = JDL(JDS(jcfg, "train"), 4, seed=3, workers=2)
    pdl = PDL(PDS(pcfg, "train"), 4, seed=3, workers=2, device="cpu")
    for epoch in (0, 1):
        jdl.set_epoch(epoch)
        pdl.set_epoch(epoch)
        np.testing.assert_array_equal(pdl._epoch_order(), jdl._epoch_order())
        (jb,), (pb,) = list(jdl), list(pdl)  # 6 images, batch 4, drop_last: one batch
        np.testing.assert_array_equal(pb["index"], jb["index"])
        np.testing.assert_allclose(pb["gt_boxes"], jb["gt_boxes"], atol=1e-3)
    assert len(pdl) == 1
    pdl.set_epoch(7, epochs=10)
    assert pdl.use_mosaic
    pdl.set_epoch(8, epochs=10)
    assert not pdl.use_mosaic
    tb = pdl.to_device(pb)
    assert tb["image"].dtype == torch.uint8 and tb["image"].shape == (4, 64, 64, 3)
    assert [tuple(m.shape) for m in tb["masks"]] == [(4, 8, 8, 1), (4, 4, 4, 1), (4, 2, 2, 1)]
    # this process's shard of each global batch, at a per-batch bucket size
    jdl = JDL(JDS(jcfg, "train"), 4, seed=5, workers=2, drop_last=False, num_shards=2, shard_index=1)
    pdl = PDL(PDS(pcfg, "train"), 4, seed=5, workers=2, drop_last=False, num_shards=2, shard_index=1,
              device="cpu")
    jdl.size_buckets = pdl.size_buckets = [64, 96]
    jbs, pbs = list(jdl), list(pdl)
    assert len(pbs) == len(jbs) == 2
    for jb, pb in zip(jbs, pbs):
        np.testing.assert_array_equal(pb["index"], jb["index"])
        assert pb["image"].shape == jb["image"].shape and pb["image"].shape[0] == 2
        np.testing.assert_allclose(pb["gt_boxes"], jb["gt_boxes"], atol=1e-3)


def test_kfold_equals_jax(tmp_path):
    from mga_yolo_tpu.data import kfold as J
    from mga_yolo_tpu_torch.data import kfold as P

    for n, k, seed in ((10, 3, 0), (7, 2, 5), (5, 1, 1)):
        for (a, b), (c, d) in zip(P.kfold_indices(n, k, seed), J.kfold_indices(n, k, seed)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    data_yaml = create_synthetic_dataset(tmp_path / "ds", n=4, size=32)
    images = sorted((data_yaml.parent / "images" / "train").glob("*.png"))
    tr, va = P.kfold_indices(len(images), 2)[0]
    got = P.write_fold(images, tmp_path / "p", 0, tr, va, "masks", "/data/root", {0: "stenosis"})
    want = J.write_fold(images, tmp_path / "j", 0, tr, va, "masks", "/data/root", {0: "stenosis"})
    assert got.read_text() == want.read_text().replace(str(tmp_path / "j"), str(tmp_path / "p"))
    assert yaml.safe_load(got.read_text())["names"] == {0: "stenosis"}
    assert sorted(p.name for p in (got.parent / "images" / "val").iterdir()) == sorted(images[i].name for i in va)


# ------------------------------------------------------ the port on its own


def test_port_alone_writes_reads_and_trains_two_steps(tmp_path, monkeypatch):
    """A synthetic dataset written and read by the port with cv2, PyYAML and
    PIL blocked feeds make_train_step for two steps on the CPU."""
    for name in ("cv2", "yaml", "PIL"):
        monkeypatch.setitem(sys.modules, name, None)
    from mga_yolo_tpu_torch.config import det_loss_config, load_config, seg_loss_config
    from mga_yolo_tpu_torch.data.dataset import MGADataset
    from mga_yolo_tpu_torch.data.loader import DataLoader
    from mga_yolo_tpu_torch.data.synthetic import write_synthetic_dataset
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.train import state as S

    data_yaml = write_synthetic_dataset(tmp_path, n=4, size=96, max_boxes=4, seed=1)
    cfg = load_config("configs/hyperparams/cbam_defaults.yaml", data=str(data_yaml), imgsz=64, max_boxes=8)
    loader = DataLoader(MGADataset(cfg, "train"), 2, workers=2, device="cpu")
    torch.manual_seed(0)
    model, _ = create_model(cfg.train.model, scale="n", nc=1, device="cpu", training=True)
    state = S.create_train_state(model)
    step = S.make_train_step(model, model.det_strides, 1, det_loss_config(cfg), seg_loss_config(cfg), 5e-4,
                             0.9999, 2000.0)
    losses = []
    for batch in loader:
        b = loader.to_device(batch)
        assert b["image"].shape == (2, 64, 64, 3) and float(b["mask_gt"].sum()) >= 1
        state, metrics = step(state, b, 1e-3, 1e-2, 0.9)
        losses.append(float(metrics["loss"]))
    assert len(losses) == 2 and all(np.isfinite(losses))
