"""The port's CCITT TIFF, GIF and upload-only decoders (``data/image_io.py``,
``data/raster_io.py`` and ``data/video_io.py`` on ``native/tiff.cpp``,
``native/gif.cpp`` and ``native/raster.cpp``) against the JAX package's
decoders, cv2, on the CPU.

Tolerances: none. Every still reads through ``imdecode`` / ``imread`` /
``imread_gray`` equal to ``cv2.imdecode`` / ``cv2.imread`` with
IMREAD_COLOR and IMREAD_GRAYSCALE to the bit (shape included, PFM's kept
channel count too); a GIF read as a video gives ``cv2.VideoCapture``'s
frames, ``CAP_PROP_FPS``, ``CAP_PROP_FRAME_COUNT`` and fourcc. The
committed fixtures (``tests/format_fixtures``) are held to cv2's stored
decodes; seeded files made here from numpy (PIL for CCITT, the writers of
``tests/still_fixtures/writers.py`` for GIF, Sun raster and HDR) are held
to cv2 live. What cv2 refuses the port refuses; cut and corrupt files
raise ValueError and never crash the process. ``cli.predict`` over a GIF
gives the JAX package's frame count and boxes (within 1e-3 px), and a
dataset with T.6 TIFF masks gives the PNG-mask dataset's pyramid.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from tests._torch_port import assert_dets_match, few_torch_threads, seeded_variables  # noqa: F401
from tests.still_fixtures import writers as W

FIXTURES = Path(__file__).resolve().parent / "format_fixtures"
pytestmark = pytest.mark.usefixtures("few_torch_threads")
PIXELS = np.load(FIXTURES / "pixels.npz")
CLIPS = json.loads((FIXTURES / "clips.json").read_text())


def _cv2(data: bytes, gray: bool = False):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)


def _assert_decodes_as_cv2(data: bytes, what: str = "") -> None:
    """The port's colour and grey decode of ``data`` equal cv2's, or both fail."""
    from mga_yolo_tpu_torch.data import image_io

    for gray in (False, True):
        want = _cv2(data, gray)
        if want is None:
            with pytest.raises(ValueError):
                image_io.decode(data, "x", gray=gray)
            continue
        got = image_io.decode(data, "x", gray=gray)
        assert got.shape == want.shape and got.dtype == np.uint8, (what, gray, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{what} gray={gray}")


def _video_capture(path: Path) -> tuple[list, tuple]:
    cap = cv2.VideoCapture(str(path))
    props = (cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
             int(cap.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little"))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames, props


def _assert_reads_as_video_capture(path: Path) -> int:
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    want, props = _video_capture(path)
    with VideoReader(path) as r:
        got = list(r)
        assert (r.fps, r.total, r.fourcc) == props
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{path.name} frame {i}")
    return len(got)


# ------------------------------------------------------------- committed fixtures

STILLS = sorted(k for k in PIXELS.files if not k.endswith("_gray"))


@pytest.mark.parametrize("name", STILLS)
def test_committed_fixture_pixels_equal_cv2(name):
    """Each fixture reads to cv2's stored decode (colour and grey) through
    ``imread``, ``imread_gray`` and ``imdecode``, and to cv2's live decode;
    ``image_size`` gives its (h, w)."""
    from mga_yolo_tpu_torch.data import image_io

    path = FIXTURES / name
    for gray, key in ((False, name), (True, f"{name}_gray")):
        got = image_io.imread_gray(path) if gray else image_io.imread(path)
        assert got.shape == PIXELS[key].shape
        np.testing.assert_array_equal(got, PIXELS[key])
    np.testing.assert_array_equal(image_io.imdecode(path.read_bytes(), name), PIXELS[name])
    assert image_io.image_size(path) == PIXELS[name].shape[:2]
    _assert_decodes_as_cv2(path.read_bytes(), name)


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_committed_gif_clips_equal_video_capture(name):
    """Each GIF read as a video gives cv2.VideoCapture's stored frames, fps,
    frame count and fourcc (``gif ``), and its live ones."""
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    with VideoReader(FIXTURES / name) as r:
        frames = np.stack(list(r))
        meta = {"fps": r.fps, "total": r.total, "fourcc": r.fourcc.decode("latin-1")}
    assert meta == CLIPS[name]
    np.testing.assert_array_equal(frames, np.load(FIXTURES / "frames.npz")[name])
    _assert_reads_as_video_capture(FIXTURES / name)


def test_committed_timing_fixtures_decode_to_cv2_digests():
    """The 640 x 640 T.6 mask and GIF decode to the SHA-256 of cv2's
    decodes (colour, grey, and the GIF's video frames)."""
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    for name, want in json.loads((FIXTURES / "bench.json").read_text()).items():
        data = (FIXTURES / name).read_bytes()
        assert hashlib.sha256(image_io.decode(data, name).tobytes()).hexdigest() == want["color"]
        assert hashlib.sha256(image_io.decode(data, name, gray=True).tobytes()).hexdigest() == want["gray"]
        if "frames" in want:
            with VideoReader(FIXTURES / name) as r:
                assert [hashlib.sha256(f.tobytes()).hexdigest() for f in r] == want["frames"]
                assert (r.fps, r.total) == (want["fps"], want["total"])


# ------------------------------------------------------------------ CCITT

CCITT = {"rle": ("tiff_ccitt", {}), "g3_1d": ("group3", {}), "g3_2d": ("group3", {292: 1}),
         "g3_2d_aligned_eol": ("group3", {292: 5}), "g3_1d_aligned_eol": ("group3", {292: 4}),
         "g3_2d_fill2": ("group3", {292: 1, 266: 2}), "rle_fill2": ("tiff_ccitt", {266: 2}),
         "g4": ("group4", {}), "g4_fill2": ("group4", {266: 2}), "g4_miniswhite_strips": ("group4", {262: 0, 278: 5}),
         "t6_writer": (None, {})}


def _ccitt(mask: np.ndarray, kind: str) -> bytes:
    """``mask`` (1 white) as a CCITT TIFF: PIL's libtiff, or the test writer's T.6 codes."""
    from PIL import Image

    if kind == "t6_writer":
        return W.t6_tiff_bytes(mask.astype(np.uint8), photometric=1)
    comp, info = CCITT[kind]
    buf = io.BytesIO()
    Image.fromarray(mask).save(buf, "TIFF", compression=comp, tiffinfo=info)
    return buf.getvalue()


def _masks(seed: int):
    rng = np.random.default_rng(seed)
    for i in range(6):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 70))
        yield (rng.random((h, w)) < rng.random()) if i % 2 else (cv2.GaussianBlur(
            rng.random((h, w)).astype(np.float32), (0, 0), 2) > 0.5)
    for w in (2559, 2560, 2561, 2624, 5200):  # runs that need the extended make-up codes
        m = np.zeros((3, w), bool)
        m[1, 5:] = True
        m[2, : w // 2] = True
        yield m
    yield np.zeros((4, 9), bool)
    yield np.ones((4, 9), bool)


@pytest.mark.parametrize("kind", list(CCITT))
def test_ccitt_tiffs_equal_cv2(kind):
    """Masks of every width up to past 2560-pixel runs, noise and blobs, all
    black and all white, as modified Huffman, T.4 1-D and 2-D (with and
    without byte-aligned EOLs), T.6, FillOrder 2 and MinIsWhite strips, and
    the T.6 codes of ``writers.t6_tiff_bytes`` (which ``chip_smoke.py``
    writes masks with): colour and grey equal cv2 (libtiff)."""
    for i, m in enumerate(_masks(len(kind))):
        _assert_decodes_as_cv2(_ccitt(m, kind), f"{kind} #{i} {m.shape}")


def test_ccitt_mask_reads_as_the_jax_load_binary_mask(tmp_path):
    """``load_binary_mask`` of a T.6 and a T.4 mask equals the JAX package's."""
    from mga_yolo_tpu.data import mask_ops as jax_mask_ops
    from mga_yolo_tpu_torch.data import mask_ops

    m = next(_masks(3))
    for kind in ("g4", "g3_2d"):
        path = tmp_path / f"{kind}.tif"
        path.write_bytes(_ccitt(m, kind))
        got = mask_ops.load_binary_mask(path)
        np.testing.assert_array_equal(got, jax_mask_ops.load_binary_mask(path))
        assert got.sum() == m.sum()


# -------------------------------------------------------------------- GIF


def _random_gif(rng) -> bytes:
    w, h = int(rng.integers(4, 40)), int(rng.integers(4, 30))
    glob = rng.random() < 0.8
    gsize = int(rng.choice([2, 4, 16, 256]))
    frames = []
    for _ in range(int(rng.integers(1, 6))):
        fw, fh = int(rng.integers(1, w + 1)), int(rng.integers(1, h + 1))
        x, y = int(rng.integers(0, w - fw + 1)), int(rng.integers(0, h - fh + 1))
        if rng.random() < 0.3:
            x, y, fw, fh = 0, 0, w, h
        local = not glob or rng.random() < 0.3
        size = int(rng.choice([2, 4, 16, 256])) if local else gsize
        frames.append({"indices": rng.integers(0, size, (fh, fw)).astype(np.uint8), "x": x, "y": y,
                       "palette": rng.integers(0, 256, (size, 3)) if local else None,
                       "interlace": rng.random() < 0.3, "disposal": int(rng.integers(0, 4)),
                       "delay": int(rng.integers(0, 20)), "gce": rng.random() < 0.9,
                       "transparent": int(rng.integers(0, size)) if rng.random() < 0.5 else None})
    return W.gif_bytes((w, h), frames, palette=rng.integers(0, 256, (gsize, 3)) if glob else None,
                       background=int(rng.integers(0, gsize)))


@pytest.mark.parametrize("seed", range(4))
def test_random_gifs_equal_imdecode_and_video_capture(tmp_path, seed):
    """Seeded GIFs of 1-5 frames (disposal 0-3, transparent indices on any
    frame, frames smaller than the canvas and offset, local tables, no
    global table, interlace, frames without a graphic control extension):
    the first frame equals cv2.imdecode (colour and grey) and every frame,
    fps and count cv2.VideoCapture."""
    rng = np.random.default_rng(100 + seed)
    for i in range(12):
        data = _random_gif(rng)
        _assert_decodes_as_cv2(data, f"gif {i}")
        path = tmp_path / f"g{i}.gif"
        path.write_bytes(data)
        _assert_reads_as_video_capture(path)


def test_gif_lzw_grows_to_12_bits_with_and_without_a_clear(tmp_path):
    """A 256-colour frame whose LZW table fills: with a clear code at 4096
    entries and with the table left full at 12 bits (a deferred clear, as
    PIL never writes), one and two frames."""
    rng = np.random.default_rng(9)
    no_table = W.gif_bytes((9, 7), [{"indices": rng.integers(0, 64, (5, 6)).astype(np.uint8), "x": 2, "y": 1,
                                     "transparent": 3}])
    _assert_decodes_as_cv2(no_table, "no colour table")  # cv2's grey ramp, index 1 white
    big = rng.integers(0, 256, (120, 130)).astype(np.uint8)
    pal = rng.integers(0, 256, (256, 3))
    for clear in (True, False):
        data = W.gif_bytes((130, 120), [{"indices": big, "clear_at_full": clear},
                                        {"indices": big[::-1], "clear_at_full": clear, "x": 0}], palette=pal)
        _assert_decodes_as_cv2(data, f"clear={clear}")
        (tmp_path / "g.gif").write_bytes(data)
        assert _assert_reads_as_video_capture(tmp_path / "g.gif") == 2


def _gif_refused():
    pal = np.arange(12).reshape(4, 3)
    idx = np.arange(12, dtype=np.uint8).reshape(3, 4) % 4
    ok = W.gif_bytes((4, 3), [{"indices": idx}], palette=pal)
    return {
        "background_past_table": W.gif_bytes((4, 3), [{"indices": idx}], palette=pal, background=9),
        "disposal_5": W.gif_bytes((4, 3), [{"indices": idx, "disposal": 5}], palette=pal),
        "index_past_table": W.gif_bytes((4, 3), [{"indices": idx * 2 + 1, "min_size": 3}], palette=pal),
        "frame_outside_canvas": W.gif_bytes((4, 3), [{"indices": idx, "x": 2}], palette=pal),
        "frame_past_2e30_pixels": ok[:13 + 12] + b"\x2c" + struct.pack("<HHHHB", 0, 0, 65535, 65535, 0) + b"\x02\x00\x3b",
        "cut_in_the_image": ok[:-6],
        "no_image": ok[:13 + 12] + b"\x3b",
    }


@pytest.mark.parametrize("kind", list(_gif_refused()))
def test_gif_the_port_does_not_read_raises_where_cv2_fails(kind):
    """What cv2's GIF codec refuses (a background index past the global
    table, a disposal past 3, an index past the colour table, a frame
    outside its canvas or past 2^30 pixels (refused before any
    allocation), a cut image, no image) raises
    ValueError naming the file."""
    from mga_yolo_tpu_torch.data import image_io

    data = _gif_refused()[kind]
    assert _cv2(data) is None
    with pytest.raises(ValueError, match=r"^up\.gif: "):
        image_io.decode(data, "up.gif")


# ------------------------------------------------- PNM, PAM, PFM, Sun, HDR


def _pnm(rng, magic: int) -> bytes:
    h, w = int(rng.integers(1, 9)), int(rng.integers(1, 30))
    ch = 3 if magic in (3, 6) else 1
    maxval = 1 if magic in (1, 4) else int(rng.choice([1, 2, 15, 100, 255, 256, 1000, 65535]))
    v = rng.integers(0, maxval + 1, (h, w, ch))
    head = b"P%d\n%s%d %d\n" % (magic, b"# seeded\n" if rng.random() < 0.3 else b"", w, h)
    head += b"" if magic in (1, 4) else b"%d\n" % maxval
    if magic == 4:
        return head + np.packbits(v[..., 0].astype(np.uint8), axis=1).tobytes()
    if magic >= 5:
        return head + (v.astype(">u2") if maxval > 255 else v.astype(np.uint8)).tobytes()
    sep = "" if magic == 1 and rng.random() < 0.5 else " "
    return head + sep.join(map(str, v.reshape(-1))).encode() + b"\n"


def _pam(rng) -> bytes:
    h, w = int(rng.integers(1, 9)), int(rng.integers(1, 30))
    tuple_type, depth = [("GRAYSCALE", 1), (None, 1), ("RGB", 3), (None, 3), ("BLACKANDWHITE", 1)][int(rng.integers(5))]
    maxval = 1 if tuple_type == "BLACKANDWHITE" else int(rng.choice([2, 100, 255] + ([] if tuple_type is None
                                                                                     else [256, 65535])))
    if depth == 1 and rng.random() < 0.2:
        maxval = 1
    if maxval == 1:  # cv2's packed rows of `w` bytes
        body = rng.integers(0, 256, h * w).astype(np.uint8).tobytes()
    else:
        v = rng.integers(0, maxval + 1, (h, w, depth))
        body = (v.astype(">u2") if maxval > 255 else v.astype(np.uint8)).tobytes()
    return (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL {maxval}\n"
            + (f"TUPLTYPE {tuple_type}\n" if tuple_type else "") + "ENDHDR\n").encode() + body


def _pfm(rng) -> bytes:
    h, w, c = int(rng.integers(1, 9)), int(rng.integers(1, 20)), int(rng.choice([1, 3]))
    v = (rng.random((h, w, c)) * 400 - 60).astype(np.float32)
    v[rng.random(v.shape) < 0.05] = np.float32(rng.choice([np.nan, np.inf, -np.inf, 3e9, 254.5, 0.5]))
    scale = float(rng.choice([-1.0, 1.0, -0.5, 2.0, 3.0]))
    body = (v if c == 3 else v[..., 0])[::-1].astype("<f4" if scale < 0 else ">f4").tobytes()
    return (b"PF\n" if c == 3 else b"Pf\n") + b"%d %d\n" % (w, h) + repr(scale).encode() + b"\n" + body


def _sun(rng) -> bytes:
    h, w = int(rng.integers(1, 9)), int(rng.integers(1, 30))
    depth = int(rng.choice([1, 8, 24, 32]))
    rows = rng.integers(0, 2 if depth == 1 else 256, (h, w) if depth <= 8 else (h, w, depth // 8))
    cmap = None
    if depth <= 8 and rng.random() < 0.5:
        cmap = rng.integers(0, 256, (3, int(rng.integers(1, (1 << depth) + 1))))
    return W.sun_bytes(rows, depth, kind=int(rng.choice([0, 1])), colormap=cmap)


def _hdr(rng) -> bytes:
    h, w = int(rng.integers(1, 7)), int(rng.integers(1, 50))
    rgbe = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(0, 160, (h, w))
    rgbe[:, : w // 3] = rgbe[:, :1]
    header = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n", b"#?RGBE\nGAMMA=1.0\nFORMAT=32-bit_rle_rgbe\n\n"][int(
        rng.integers(2))]
    return W.hdr_bytes(rgbe, rle=bool(rng.integers(2)), header=header)


def _cv2_encoded(rng) -> bytes:
    img = rng.integers(0, 256, (int(rng.integers(1, 20)), int(rng.integers(1, 20)), 3)).astype(np.uint8)
    ext = [".ppm", ".pgm", ".pbm", ".pam", ".ras", ".sr", ".hdr", ".pfm", ".pnm"][int(rng.integers(9))]
    im = img[..., 0] if ext in (".pgm", ".pbm", ".sr") and rng.random() < 0.7 else img
    if ext in (".hdr", ".pfm"):
        im = im.astype(np.float32) / 200
    params = [cv2.IMWRITE_PXM_BINARY, int(rng.integers(2))] if ext in (".ppm", ".pgm", ".pbm", ".pnm") else []
    return cv2.imencode(ext, im, params)[1].tobytes()


RASTER = {**{f"pnm_p{m}": (lambda rng, m=m: _pnm(rng, m)) for m in range(1, 7)}, "pam": _pam, "pfm": _pfm,
          "sun": _sun, "hdr": _hdr, "cv2_encoders": _cv2_encoded}


@pytest.mark.parametrize("fmt", list(RASTER))
def test_upload_only_formats_equal_cv2(fmt):
    """Seeded PNM (P1-P6, ASCII and binary, maxval 1-65535, comments), PAM
    (GRAYSCALE, RGB, BLACKANDWHITE, no tuple type; maxval 1-65535), PFM
    (both byte orders, scales, NaN and infinities), Sun raster (1, 8, 24,
    32 bits, old and standard types, full and partial colour maps), HDR
    (run-length and flat, both magics) and every cv2 encoder of them:
    colour and grey equal cv2."""
    rng = np.random.default_rng(sum(map(ord, fmt)))
    for i in range(25):
        _assert_decodes_as_cv2(RASTER[fmt](rng), f"{fmt} #{i}")


def _raster_refused():
    rows = np.arange(60, dtype=np.uint8).reshape(5, 12)
    rgbe = np.full((3, 9, 4), 130, np.uint8)
    return {
        "sun_byte_encoded": (W.sun_bytes(rows, 8, kind=2), "byte-encoded", True),
        "sun_rgb_type": (W.sun_bytes(np.stack([rows] * 3, -1), 24, kind=3), "RGB type", True),
        "sun_24bit_byte_encoded": (W.sun_bytes(np.stack([rows] * 3, -1), 24, kind=2), "byte-encoded", True),
        "pam_rgb_alpha": (b"P7\nWIDTH 12\nHEIGHT 5\nDEPTH 4\nMAXVAL 255\nTUPLTYPE RGB_ALPHA\nENDHDR\n" + bytes(240),
                          "tuple type RGB_ALPHA", False),
        "pam_grayscale_alpha": (b"P7\nWIDTH 12\nHEIGHT 5\nDEPTH 2\nMAXVAL 255\nTUPLTYPE GRAYSCALE_ALPHA\nENDHDR\n"
                                + bytes(120), "tuple type GRAYSCALE_ALPHA", False),
        "hdr_plus_y": (W.hdr_bytes(rgbe, resolution=b"+Y 3 +X 9\n"), "-Y h \\+X w", True),
        "hdr_xyze": (W.hdr_bytes(rgbe, header=b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n"), "RGBE only", True),
        "pnm_maxval_0": (b"P5\n2 2\n0\n" + bytes(4), "maxval 0", True),
        "tiff_lzma": (_tiff_compressed(34925), "LZMA", True),
        "tiff_zstd": (_tiff_compressed(50000), "ZSTD", True),
    }


def _tiff_compressed(comp: int) -> bytes:
    data = bytearray(W.tiff_bytes(np.zeros((4, 4, 1), np.uint8), 8, 1))
    i = data.find(struct.pack("<HHI", 259, 3, 1))
    data[i + 8:i + 10] = struct.pack("<H", comp)
    return bytes(data)


@pytest.mark.parametrize("kind", list(_raster_refused()))
def test_upload_only_variants_the_port_refuses_raise_naming_them(kind):
    """Sun raster's byte-encoded and RGB types and Radiance HDR's other
    orientations and XYZE, which cv2 fails on, PAM's alpha tuple types,
    whose cv2 decode fills pixels from memory it never wrote, and LZMA and
    ZSTD TIFFs (cv2 here: "compression support is not configured") raise
    ValueError naming the file and the feature."""
    from mga_yolo_tpu_torch.data import image_io

    data, what, cv2_fails = _raster_refused()[kind]
    if cv2_fails:
        assert _cv2(data) is None
    with pytest.raises(ValueError, match=rf"^up\.img: .*{what}"):
        image_io.decode(data, "up.img")


# --------------------------------------------------------- cut and flipped


def _valid_files() -> dict[str, bytes]:
    rng = np.random.default_rng(4)
    m = next(_masks(5))
    return {"ccitt_g4": _ccitt(m, "g4"), "ccitt_g3_2d": _ccitt(m, "g3_2d"), "ccitt_rle": _ccitt(m, "rle"),
            "gif": _random_gif(np.random.default_rng(3)), "pnm_p3": _pnm(rng, 3), "pnm_p6": _pnm(rng, 6),
            "pam": _pam(rng), "pfm": _pfm(rng), "sun": _sun(rng), "hdr_rle": W.hdr_bytes(
                rng.integers(100, 140, (4, 21, 4)).astype(np.uint8))}


@pytest.mark.parametrize("source", list(_valid_files()))
def test_cut_and_flipped_files_raise_or_decode(tmp_path, source):
    """60 seeded truncations and byte flips of each file: each raises
    ValueError or gives a uint8 image, in colour and grey and as a GIF
    video; none crashes the process. A cut CCITT strip, GIF image, PNM or
    HDR raises where libtiff, cv2, ffmpeg and rgbe.cpp conceal the damage."""
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    data = _valid_files()[source]
    rng = np.random.default_rng(sum(map(ord, source)))
    for i in range(60):
        b = bytearray(data)
        if i % 2:
            b = b[:int(rng.integers(0, len(b)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                j = int(rng.integers(len(b)))
                b[j] = int(rng.integers(256)) if rng.random() < 0.5 else b[j] ^ (1 << int(rng.integers(8)))
        b = bytes(b)
        for gray in (False, True):
            try:
                out = image_io.decode(b, gray=gray)
            except ValueError:
                continue
            assert out.dtype == np.uint8 and out.ndim in (2, 3)
        if source == "gif":
            (tmp_path / "c.gif").write_bytes(b)
            try:
                with VideoReader(tmp_path / "c.gif") as r:
                    assert all(f.shape == r.size[::-1] + (3,) for f in r)
            except ValueError:
                pass
    if source == "gif":  # the last frame cut: the video reader raises where ffmpeg stops early
        (tmp_path / "c.gif").write_bytes(data[:-4])
        with pytest.raises(ValueError), VideoReader(tmp_path / "c.gif") as r:
            list(r)
    else:
        with pytest.raises(ValueError):
            image_io.decode(data[:len(data) * 2 // 3], "cut")


def test_native_helpers_equal_their_python_readings():
    """``pnm_numbers`` reads OpenCV's ReadNumber way (comments, one
    terminator, digit limits, errors) and ``gif_frames`` without decoding
    gives the decoded frames' descriptors."""
    from mga_yolo_tpu_torch import native

    nums, pos = native.pnm_numbers(b"P2 # c\n12\t 7\r\n# x\r255 ", 2, 3)
    assert nums.tolist() == [12, 7, 255] and pos == 22
    assert native.pnm_numbers(b"0110 1", 0, 5, maxdigits=1)[0].tolist() == [0, 1, 1, 0, 1]
    for bad, what in ((b" 12 x3 ", "not a digit"), (b" 12", "ends before"), (b" 99999999999 ", "past 2\\^31")):
        with pytest.raises(ValueError, match=what):
            native.pnm_numbers(bad, 0, 2)
    data = _random_gif(np.random.default_rng(7))
    gif, off = native.gif_header(data)
    full = list(native.gif_frames(data, off))
    quick = list(native.gif_frames(data, off, decode=False))
    strip = lambda f: (f.x, f.y, f.indices.shape, f.disposal, f.delay, f.transparent, f.has_gce, f.table_size,  # noqa: E731
                       None if f.palette is None else f.palette.tobytes())
    assert len(full) == len(quick) > 0 and [strip(f) for f in full] == [strip(f) for f in quick]


# ------------------------------------------------------------- consumers


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The JAX flagship at 64 px with seeded weights, the port's model with
    the same weights, and a checkpoint of them."""
    import torch

    from mga_yolo_tpu.models.yolo import create_model as jcreate
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax

    cbam = "configs/models/yolov8_cbam.yaml"
    jmodel, _ = jcreate(cbam, scale="n", nc=1)
    v = seeded_variables(jmodel, 64, seed=4)
    tmodel, tspec = create_model(cbam, scale="n", nc=1, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(v, tspec), strict=True)
    ckpt = tmp_path_factory.mktemp("flagship") / "best.pt"
    torch.save({"ema_state_dict": tmodel.state_dict(), "train_args": {"nc": 1, "model": cbam, "model_scale": "n"},
                "meta": {"imgsz": 64, "model_yaml": cbam, "model_scale": "n", "nc": 1}}, ckpt)
    return dict(jmodel=jmodel, v=v, ckpt=ckpt)


class _Recorder:
    """A predictor whose ``stream`` records each frame's boxes."""

    def __init__(self, pred):
        self.pred, self.boxes = pred, []

    def __getattr__(self, name):
        return getattr(self.pred, name)

    def stream(self, *a, **k):
        for frame, r in self.pred.stream(*a, **k):
            self.boxes.append(np.asarray(r.boxes))
            yield frame, r


def test_cli_predict_over_a_gif_gives_the_jax_frames_and_boxes(flagship, tmp_path, monkeypatch, capsys):
    """``cli.predict`` of the port and of the JAX package (its own predictor
    and JAX model, cv2.VideoCapture's frames) over one small GIF clip: the
    same files (``<stem>_pred.mp4`` and the frame masks), the same frame
    count and summary lines, each frame's boxes within 1e-3 px; the port
    reads its own ``_pred.mp4`` back at the clip's fps and frame count."""
    import mga_yolo_tpu.train.predictor as jax_predictor
    from mga_yolo_tpu.cli import predict as jax_cli
    from mga_yolo_tpu.utils import compile_cache
    from mga_yolo_tpu_torch.cli import predict as cli_predict
    from mga_yolo_tpu_torch.data.video_io import VideoReader
    from mga_yolo_tpu_torch.train import predictor as port_predictor

    src = tmp_path / "src"
    src.mkdir()
    clip = src / "clip.gif"
    clip.write_bytes((FIXTURES / "gif_pil_disposals_interlaced.gif").read_bytes())
    args = ["--weights", str(flagship["ckpt"]), "--source", str(src), "--conf", "0.01", "--batch", "2",
            "--save-frame-masks"]
    port_rec = _Recorder(port_predictor.load_predictor(flagship["ckpt"], conf=0.01, device="cpu"))
    monkeypatch.setattr(port_predictor, "load_predictor", lambda *a, **k: port_rec)
    res = cli_predict.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    jax_rec = _Recorder(jax_predictor.MGAPredictor(flagship["jmodel"], flagship["v"], imgsz=64, conf=0.01))
    monkeypatch.setattr(jax_predictor, "load_predictor", lambda *a, **k: jax_rec)
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: None)
    jax_cli.main(args + ["--out", str(tmp_path / "jax")])
    jax_lines = capsys.readouterr().out.splitlines()
    assert res["frames"] == len(port_rec.boxes) == len(jax_rec.boxes) == CLIPS["gif_pil_disposals_interlaced.gif"][
        "total"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert [ln.replace(str(tmp_path / "port"), "OUT") for ln in port_lines] == \
        [ln.replace(str(tmp_path / "jax"), "OUT") for ln in jax_lines]
    assert "clip.gif: 4 frames -> clip_pred.mp4" in port_lines
    for got, want in zip(port_rec.boxes, jax_rec.boxes):
        assert len(want) > 0
        assert_dets_match(got, want, rtol=0, atol=1e-3)
    with VideoReader(tmp_path / "port" / "clip_pred.mp4") as r:
        assert (len(list(r)), r.fps, r.size) == (4, 10.0, (64, 48))


def test_g4_mask_dataset_pyramid_equals_the_png_mask_dataset(tmp_path):
    """A synthetic dataset with its masks as T.6 TIFFs and as PNGs: the
    port's samples of both (and the JAX package's of the TIFF masks, cv2
    reading them through libtiff) have the same mask pyramids."""
    import yaml
    from PIL import Image

    from mga_yolo_tpu.config import load_config as jload
    from mga_yolo_tpu.data.dataset import MGADataset as JDS
    from mga_yolo_tpu_torch.config import load_config as pload
    from mga_yolo_tpu_torch.data.dataset import MGADataset as PDS
    from tests.synth import create_synthetic_dataset

    synth = create_synthetic_dataset(tmp_path / "png", n=4, size=96, seed=5)
    g4 = tmp_path / "g4"
    (g4 / "masks").mkdir(parents=True)
    for d in ("images", "labels"):
        (g4 / d).symlink_to(synth.parent / d)
    for png in (synth.parent / "masks").glob("*.png"):
        Image.fromarray(cv2.imread(str(png), cv2.IMREAD_GRAYSCALE) > 0).save(g4 / "masks" / f"{png.stem}.tif",
                                                                              compression="group4")
    data = yaml.safe_load(synth.read_text())
    data.update(path=str(g4), dataset=str(g4))
    (g4 / "data.yaml").write_text(yaml.safe_dump(data))
    kw = dict(imgsz=64, max_boxes=8, cache="ram")
    png_ds = PDS(pload(data=str(synth), **kw), "val", augment=False)
    g4_ds = PDS(pload(data=str(g4 / "data.yaml"), **kw), "val", augment=False)
    jax_ds = JDS(jload(data=str(g4 / "data.yaml"), **kw), "val", augment=False)
    assert len(png_ds) == len(g4_ds) == len(jax_ds) > 0
    for i in range(len(png_ds)):
        a, b, c = png_ds.get(i)["masks"], g4_ds.get(i)["masks"], jax_ds.get(i)["masks"]
        assert len(a) == len(b) == len(c) == 3 and any(m.any() for m in a)
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
