"""The port's lossless video codecs (``native/ffv1.cpp`` behind
``native.Ffv1Decoder``, ``native/huffyuv.cpp`` behind
``native.HuffyuvDecoder``, and PNG frames through ``data/image_io.py``'s PNG
reader) in AVI, Matroska, MP4 / MOV and ASF, against the JAX package's reader,
``cv2.VideoCapture``, on the CPU; and the colour conversion of 4:2:2 and
4:4:4 frames of odd height that they bring.

The committed clips (``python -m tests.video_fixtures.make lossless``) are
cv2's own writer's (PNG, FFV1, HuffYUV and FFVHuff in every container it
writes them to) and libavcodec's encoders' through ctypes (FFV1 versions 0, 1
and 3 with each coder, context model, slice count, CRC choice and pixel
format; HuffYUV and FFVHuff with each predictor, interlacing, per-frame
tables and pixel format; PNG of every colour type), HuffYUV files of the
tests' own writer (version 1 without extradata on the classic tables, and the
512 px RGB clip with fitted tables) and PNG frames of the stills' writer (2-
and 4-bit grey, palettes with tRNS, gAMA and eXIf, Adam7). Every frame equals
cv2's to the bit (tolerance 0; the SHA-256 stored in ``lossless.json``, and
cv2 read live) with cv2's fps, frame count and fourcc, but the Adam7 clip's,
for whose frames cv2 hands on a stale buffer ("Cannot convert interlaced to
progressive frames"): there libpng's frames (``cv2.imdecode``) are the
oracle. Every tool ``native.FFV1_TALLY`` and ``native.HUFFYUV_TALLY`` count
occurs in some clip.

What the port does not decode raises ``ValueError`` naming the file, the
container and the feature (FFV1 and FFVHuff above 8 bits, 16-bit RGB PNG
frames, APNG); cut and corrupt frames raise (a cut range-coded slice, a bad
slice CRC, a code-length table that overflows, a truncated PNG), where
libavcodec conceals the damage. ``cli.predict`` over an FFV1 clip writes what
the JAX CLI writes.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import shutil
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from tests._torch_port import assert_dets_match, few_torch_threads, seeded_variables  # noqa: F401
from tests.video_fixtures.make import (avi_bytes, avi_parts, frames, lavc_encode_planes, lossless_mux, lossless_planes,
                                       pack_avi, smooth_angiogram)

FIXTURES = Path(__file__).resolve().parent / "video_fixtures"
META = json.loads((FIXTURES / "lossless.json").read_text())
CLIPS = sorted(META)
IMGSZ = 64
pytestmark = pytest.mark.usefixtures("few_torch_threads")


def cv2_read(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        out.append(img)
    meta = cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), int(cap.get(cv2.CAP_PROP_FOURCC))
    cap.release()
    return out, meta


def sha(imgs) -> list:
    return [hashlib.sha256(np.ascontiguousarray(i).tobytes()).hexdigest() for i in imgs]


def read_all(path):
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    with VideoReader(path) as r:
        return list(r), r


def tally_of(r) -> dict:
    return getattr(r, "ffv1_tally", None) or getattr(r, "huffyuv_tally", None) or getattr(r, "ffvhuff_tally", None) \
        or {}


@pytest.fixture(scope="module")
def decoded():
    """name -> (frames' SHA-256, fps, total, fourcc, tally) of each committed clip, read once."""
    out = {}
    for name in CLIPS:
        got, r = read_all(FIXTURES / name)
        out[name] = (sha(got), r.fps, r.total, int.from_bytes(r.fourcc, "little"), tally_of(r))
    return out


def test_fixtures_cover_every_codec_and_container():
    kinds = {(Path(n).stem.split("_")[n.startswith("cv2_")], Path(n).suffix) for n in CLIPS}
    for codec, suffixes in (("png", ".avi .mkv .wmv .mov .mp4"), ("ffv1", ".avi .mkv .wmv .mov .mp4"),
                            ("hfyu", ".avi .mkv .wmv .mov"), ("ffvh", ".avi .mkv .wmv .mov")):
        assert {(codec, s) for s in suffixes.split()} <= kinds, codec
    fourccs = {META[n]["fourcc"].to_bytes(4, "little") for n in CLIPS}
    assert fourccs == {b"MPNG", b"ffv1", b"HFYU", b"FFVH"}
    assert META["ffv1_big512.mkv"]["shape"] == META["hfyu_big512.avi"]["shape"] == [512, 512, 3]
    assert META["ffv1_big512.mkv"]["frames"] == META["hfyu_big512.avi"]["frames"] == 8
    assert sum((FIXTURES / n).stat().st_size for n in CLIPS) + (FIXTURES / "lossless.json").stat().st_size < 1_500_000


@pytest.mark.parametrize("name", CLIPS)
def test_reader_equals_cv2_to_the_bit(decoded, name):
    """Every frame equal to cv2's (its SHA-256 stored, and cv2 read live;
    libpng's for the Adam7 clip), with cv2's fps, frame count and fourcc;
    the file the one recorded."""
    meta = META[name]
    data = (FIXTURES / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == meta["file_sha256"]
    got, fps, total, fourcc, _ = decoded[name]
    want, cv2_meta = cv2_read(FIXTURES / name)
    if meta["oracle"].startswith("libpng"):
        want = [cv2.imdecode(np.frombuffer(d, np.uint8), cv2.IMREAD_COLOR) for d in avi_parts(data)[1]]
    assert got == meta["sha256"] == sha(want)
    assert (fps, total, fourcc) == cv2_meta == (meta["fps"], meta["total"], meta["fourcc"])
    assert len(got) == meta["frames"]


def test_lossless_clips_give_back_the_frames_written():
    """The tests' own HuffYUV writer's clips (version 1 on the classic
    tables, and the 512 px clip on fitted ones) read back as the frames
    written, in cv2 as in the port: the classic tables are right."""
    src = sha(frames(4, 30, 40, 230))
    for name in ("hfyu_v1_classic_rgb24.avi", "hfyu_v1_classic_decorrelated.avi", "hfyu_rgb24_left.mov"):
        assert META[name]["sha256"] == src, name
    big = [cv2.cvtColor(g, cv2.COLOR_GRAY2BGR) for g in smooth_angiogram(8, 512, 512, 242)]
    assert META["hfyu_big512.avi"]["sha256"] == sha(big) == META["ffv1_big512.mkv"]["sha256"]


TOOLS = {  # per fixture, the tools its decoding must have counted
    "ffv1_v0_golomb_gray.avi": ("version_0", "golomb_rice", "gray", "runs", "run_breaks"),
    "ffv1_v0_range_yuv420p_g2.mkv": ("version_0", "range_default", "yuv420", "non_key_frames"),
    "ffv1_v1_custom_yuv422p_ctx1_odd.avi": ("version_1", "range_custom", "yuv422", "five_input_contexts", "odd_size"),
    "ffv1_v1_golomb_yuv444p_noisy.mp4": ("version_1", "golomb_rice", "yuv444", "golomb_escape"),
    "ffv1_v3_golomb_yuva420p_4slices.mkv": ("version_3", "multi_slice", "slice_crc", "alpha", "yuv420"),
    "ffv1_v3_range_gray_16slices_nocrc.mov": ("version_3", "range_default", "multi_slice", "gray"),
    "ffv1_v3_custom_bgr0_ctx1.mp4": ("range_custom", "rgb", "five_input_contexts"),
    "ffv1_v3_range_yuv444p_states.avi": ("initial_states", "range_custom", "yuv444"),
    "cv2_ffv1.avi": ("version_3", "rgb", "alpha", "slice_crc"),
    "hfyu_yuv422p_median.avi": ("huffyuv", "v2", "pred_median", "yuv422"),
    "hfyu_yuv422p_plane_ilace.mkv": ("pred_plane", "interlaced"),
    "hfyu_rgb24_plane_ilace_odd.avi": ("rgb24", "decorrelate", "interlaced", "odd_width"),
    "hfyu_bgra_left_noisy.avi": ("rgb32", "long_codes"),
    "hfyu_v1_classic_rgb24.avi": ("v1_classic_tables", "rgb24", "pred_left"),
    "hfyu_v1_classic_decorrelated.avi": ("v1_classic_tables", "decorrelate"),
    "ffvh_yuv420p_median_ctx1.avi": ("ffvhuff", "v2", "per_frame_tables", "yuv420"),
    "ffvh_gray_left_odd.mov": ("v3", "gray", "odd_width", "per_frame_tables"),
    "ffvh_yuv444p_median_ilace.mkv": ("v3", "yuv444", "pred_median", "interlaced"),
    "ffvh_gbrp_median.avi": ("gbrp",),
    "ffvh_yuva420p_left.avi": ("yuva",),
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tally_counts_each_tool(decoded, name):
    tally = decoded[name][4]
    missing = [k for k in TOOLS[name] if not tally[k]]
    assert not missing, (name, missing, tally)


@pytest.mark.parametrize("codec", ["ffv1", "huffyuv"])
def test_every_counted_tool_occurs_in_some_fixture(decoded, codec):
    """Each thing a decoder counts is used by at least one committed clip."""
    from mga_yolo_tpu_torch import native

    names = native.FFV1_TALLY if codec == "ffv1" else native.HUFFYUV_TALLY
    total = dict.fromkeys(names, 0)
    for name in CLIPS:
        tally = decoded[name][4]
        if set(tally) == set(names):
            for k, v in tally.items():
                total[k] += v
    assert all(total.values()), [k for k, v in total.items() if not v]


FRESH = {  # seed: (encoder, pixel format, options, (height, width), container) of clips written anew
    1: ("ffv1", "yuv422p", {"level": 3, "coder": 0, "slices": 6, "context": 1, "g": 3}, (41, 57), "mkv"),
    2: ("ffv1", "bgr0", {"level": 1, "coder": 1, "g": 2}, (23, 35), "avi"),
    3: ("ffv1", "yuv420p", {"level": 3, "coder": -2, "slices": 9, "slicecrc": 0}, (48, 64), "mp4"),
    4: ("ffv1", "gray", {"level": 0, "coder": 1, "context": 1, "g": 4}, (33, 17), "avi"),
    5: ("huffyuv", "yuv422p", {"pred": "median", "flags": "+ilme"}, (36, 48), "avi"),
    6: ("ffvhuff", "yuv444p", {"pred": "plane", "context": 1}, (21, 35), "mkv"),
    7: ("ffvhuff", "gray", {"pred": "median", "flags": "+ilme"}, (300, 24), "avi"),
    8: ("huffyuv", "bgra", {"pred": "plane"}, (19, 27), "mov"),
}


@pytest.mark.parametrize("seed", sorted(FRESH))
def test_fresh_encoder_clips_equal_cv2(tmp_path, seed):
    """Clips libavcodec's encoders write anew (other options, sizes and
    containers) read as cv2 reads them."""
    encoder, fmt, options, (h, w), container = FRESH[seed]
    imgs = frames(4, h, w, 300 + seed)
    ex = []
    packets = [d for d, _, _ in lavc_encode_planes(encoder, [lossless_planes(fmt, f, i) for i, f in enumerate(imgs)],
                                                   fmt, options, ex)]
    tag = {"ffv1": b"FFV1", "huffyuv": b"HFYU", "ffvhuff": b"FFVH"}[encoder]
    bits = {"yuv422p": 16, "bgr0": 32, "bgra": 32, "gray": 8}.get(fmt, 24)
    path = tmp_path / f"fresh.{container}"
    path.write_bytes(lossless_mux(container, packets, w, h, tag, ex[0], bits))
    got, r = read_all(path)
    want, (fps, total, fourcc) = cv2_read(path)
    assert len(got) == len(want) == 4 and sha(got) == sha(want)
    assert (r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (fps, total, fourcc)


# ---------------------------------------------------------------- 4:2:2 and 4:4:4 frames of odd height


@pytest.mark.parametrize("height", [1, 2, 3, 4, 5, 6, 7, 8, 9, 15, 17, 63])
def test_mjpeg_422_and_444_frames_of_any_height_equal_cv2(tmp_path, height):
    """MJPEG clips of 4:2:2 and 4:4:4 JPEGs (``cv2.imencode``'s sampling
    factors, random pixels) 1, 2, 17 and 64 samples wide: equal to cv2's
    frames at tolerance 0. swscale's unscaled converter takes even heights of
    4:2:0 and 4:2:2 only, so cv2 converts 4:2:2 frames of odd height on its
    scaled path (vertical chroma filter of one tap: yuv2packed1), and every
    4:4:4 frame with full chroma; the port took the unscaled rule for both
    (off by up to 218 and 2 before, ``ROADMAP.md`` section 3)."""
    for sampling in (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444):
        for w in (1, 2, 17, 64):
            rng = np.random.default_rng(height * 1000 + w)
            jpegs = [cv2.imencode(".jpg", rng.integers(0, 256, (height, w, 3), np.uint8),
                                  [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])[1].tobytes() for _ in range(2)]
            path = tmp_path / f"m{w}.avi"
            path.write_bytes(avi_bytes(jpegs, w, height, 25, 1, b"MJPG"))
            got, _ = read_all(path)
            want, _ = cv2_read(path)
            assert len(got) == len(want) == 2
            for g, x in zip(got, want):
                np.testing.assert_array_equal(g, x, err_msg=f"{w} x {height}, sampling {sampling:#x}")


@pytest.mark.parametrize("height", [3, 5, 7, 9, 15, 17])
def test_limited_range_422_frames_of_odd_height_equal_cv2(tmp_path, height):
    """HuffYUV's and FFV1's yuv422p frames of odd height (limited range,
    chroma centred), and FFVHuff's and FFV1's yuv444p: equal to cv2's."""
    imgs = frames(2, height, 32, 400 + height)
    for encoder, fmt, tag, bits in (("huffyuv", "yuv422p", b"HFYU", 16), ("ffv1", "yuv422p", b"FFV1", 16),
                                    ("ffvhuff", "yuv444p", b"FFVH", 24), ("ffv1", "yuv444p", b"FFV1", 24)):
        ex = []
        packets = [d for d, _, _ in lavc_encode_planes(encoder, [lossless_planes(fmt, f, i) for i, f in
                                                                 enumerate(imgs)], fmt, {}, ex)]
        path = tmp_path / f"{encoder}_{fmt}.avi"
        path.write_bytes(avi_bytes(packets, 32, height, 25, 1, tag, ex[0], bits))
        got, _ = read_all(path)
        want, _ = cv2_read(path)
        assert len(got) == len(want) == 2 and sha(got) == sha(want), (encoder, fmt, height)


def _swscale_bgr(planes: list, fmt: str, w: int, h: int) -> np.ndarray:
    """libswscale's BGR24 of planes in ``fmt`` (the one in cv2's wheel, through
    ctypes), as cv2 calls it: SWS_BICUBIC at the same size, the planes in
    buffers aligned and padded as libavcodec's."""
    libs = Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs"
    avutil = ctypes.CDLL(str(next(libs.glob("libavutil-*"))), mode=ctypes.RTLD_GLOBAL)
    sws = ctypes.CDLL(str(next(libs.glob("libswscale-*"))), mode=ctypes.RTLD_GLOBAL)
    vp = ctypes.c_void_p
    sws.sws_alloc_context.restype = vp
    sws.sws_init_context.argtypes = [vp, vp, vp]
    sws.sws_scale.argtypes = [vp, ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_int)]
    sws.sws_freeContext.argtypes = [vp]
    avutil.av_opt_set_int.argtypes = [vp, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    avutil.av_get_pix_fmt.argtypes = [ctypes.c_char_p]
    avutil.av_log_set_level(8)
    ctx = sws.sws_alloc_context()
    for key, val in ((b"srcw", w), (b"srch", h), (b"src_format", avutil.av_get_pix_fmt(fmt.encode())), (b"dstw", w),
                     (b"dsth", h), (b"dst_format", avutil.av_get_pix_fmt(b"bgr24")), (b"sws_flags", 4)):
        assert avutil.av_opt_set_int(ctx, key, val, 0) >= 0, key
    assert sws.sws_init_context(ctx, None, None) >= 0

    def aligned(rows, cols):
        raw = np.zeros(rows * cols + 64, np.uint8)
        off = -raw.ctypes.data % 64
        return raw[off:off + rows * cols].reshape(rows, cols)
    bufs = []
    for p in planes:
        b = aligned(p.shape[0] + 4, (p.shape[1] + 63) // 64 * 64 + 64)
        b[:] = np.pad(p, ((0, 4), (0, b.shape[1] - p.shape[1])), mode="edge")
        bufs.append(b)
    out = aligned(h + 2, (w * 3 + 63) // 64 * 64 + 64)
    src = (vp * 4)(*[b.ctypes.data for b in bufs], *([None] * (4 - len(bufs))))
    strides = (ctypes.c_int * 4)(*[b.shape[1] for b in bufs], *([0] * (4 - len(bufs))))
    sws.sws_scale(ctx, src, strides, 0, h, (vp * 4)(out.ctypes.data, None, None, None),
                  (ctypes.c_int * 4)(out.shape[1], 0, 0, 0))
    sws.sws_freeContext(ctx)
    return out[:h, :w * 3].reshape(h, w, 3)


@pytest.mark.parametrize("height", [1, 2, 3, 4, 5, 7, 8, 9, 17])
def test_conversions_equal_libswscale(height):
    """``native.planes_to_bgr`` against libswscale itself on random planes 1
    to 65 samples wide: yuv422p, yuv444p and yuva420p in limited range, grey
    (swscale takes it as full range: a copy), BGR0 / BGRA and GBR planes
    (copies); equal at tolerance 0."""
    from mga_yolo_tpu_torch import native

    rng = np.random.default_rng(height)
    for w in (1, 2, 3, 16, 17, 64, 65):
        def p(hh, ww):
            return rng.integers(0, 256, (hh, ww), np.uint8)
        cases = {"yuv422p": ([p(height, w), p(height, (w + 1) // 2), p(height, (w + 1) // 2)], (1, 0)),
                 "yuv444p": ([p(height, w), p(height, w), p(height, w)], (0, 0)),
                 "yuva420p": ([p(height, w), p((height + 1) // 2, (w + 1) // 2), p((height + 1) // 2, (w + 1) // 2),
                               p(height, w)], (1, 1)),
                 "gray": ([p(height, w)], None), "bgr0": ([p(height, 4 * w)], None),
                 "bgra": ([p(height, 4 * w)], None), "gbrp": ([p(height, w), p(height, w), p(height, w)], None)}
        for fmt, (planes, sub) in cases.items():
            np.testing.assert_array_equal(native.planes_to_bgr(fmt, planes, sub), _swscale_bgr(planes, fmt, w, height),
                                          err_msg=f"{fmt} {w} x {height}")


# ---------------------------------------------------------------- refusals and damage


def _lavc_avi(tmp_path, name, encoder, fmt, options, tag, bits=24, h=24, w=32, n=2):
    ex = []
    packets = [d for d, _, _ in lavc_encode_planes(encoder, [lossless_planes(fmt, f, i) for i, f in
                                                             enumerate(frames(n, h, w, 500))], fmt, options, ex)]
    path = tmp_path / name
    path.write_bytes(avi_bytes(packets, w, h, 25, 1, tag, ex[0], bits))
    return path, packets, ex[0]


@pytest.mark.parametrize("encoder, fmt, what", [("ffv1", "gray10le", "FFV1 of 10 bits a sample"),
                                                 ("ffv1", "yuv411p", "FFV1 YUV of chroma shifts 2, 0"),
                                                 ("ffvhuff", "yuv420p10le", "FFVHuff of 10 bits a sample")])
def test_what_the_port_does_not_decode_raises_naming_it(tmp_path, encoder, fmt, what):
    """cv2 reads these; the port refuses them by name, with the file and the
    container."""
    import tests.video_fixtures.make as make

    planes = {"gray10le": lambda: [np.zeros((24, 64), np.uint8)],
              "yuv420p10le": lambda: [np.zeros((24, 64), np.uint8), np.zeros((12, 32), np.uint8),
                                      np.zeros((12, 32), np.uint8)],
              "yuv411p": lambda: [np.full((24, 32), 70, np.uint8), np.full((24, 8), 90, np.uint8),
                                  np.full((24, 8), 90, np.uint8)]}[fmt]()
    ex = []
    packets = [d for d, _, _ in make.lavc_encode_planes(encoder, [planes] * 2, fmt, {}, ex, width=32)]
    path = tmp_path / "refused.avi"
    path.write_bytes(avi_bytes(packets, 32, 24, 25, 1, b"FFV1" if encoder == "ffv1" else b"FFVH", ex[0], 24))
    assert len(cv2_read(path)[0]) == 2
    name = "FFV1" if encoder == "ffv1" else "FFVHuff"
    with pytest.raises(ValueError, match=rf"^{path}: AVI with {name} video.*{what}"):
        read_all(path)


def test_sixteen_bit_rgb_png_frames_and_apng_raise_naming_them(tmp_path):
    from tests.still_fixtures.writers import png_bytes

    rgb16 = png_bytes(np.full((6, 8, 3), 40000, ">u2").view(np.uint8).reshape(6, 8, 6), 16, 2)
    path = tmp_path / "rgb16.avi"
    path.write_bytes(avi_bytes([rgb16], 8, 6, 25, 1, b"MPNG"))
    with pytest.raises(ValueError, match=rf"^{path}: AVI with PNG video, frame 0: 16-bit RGB PNG frames"):
        read_all(path)
    still = png_bytes(np.zeros((6, 8, 1), np.uint8), 8, 0)
    actl = struct.pack(">I4sII", 8, b"acTL", 1, 0) + b"\0\0\0\0"
    path.write_bytes(avi_bytes([still[:33] + actl + still[33:]], 8, 6, 25, 1, b"MPNG"))
    with pytest.raises(ValueError, match=rf"^{path}: AVI with PNG video, frame 0: an APNG frame"):
        read_all(path)


def test_damage_libavcodec_conceals_is_refused(tmp_path):
    """A range-coded FFV1 slice cut short, a slice whose CRC does not hold,
    a HuffYUV code-length table that overflows its 256 lengths, and a PNG
    frame cut short: ValueError naming the file, where cv2 conceals or skips
    the frame."""
    path, packets, ex = _lavc_avi(tmp_path, "cut.avi", "ffv1", "gray", {"level": 1, "coder": 1}, b"FFV1")
    path.write_bytes(avi_bytes([packets[0], packets[1][:len(packets[1]) // 2]], 32, 24, 25, 1, b"FFV1", ex))
    with pytest.raises(ValueError, match=rf"^{path}: AVI with FFV1 video, frame 1: .*cut"):
        read_all(path)
    path, packets, ex = _lavc_avi(tmp_path, "crc.avi", "ffv1", "gray", {"level": 3, "slices": 4, "slicecrc": 1},
                                  b"FFV1")
    bad = bytearray(packets[0])
    bad[len(bad) // 3] ^= 0x10
    path.write_bytes(avi_bytes([bytes(bad), packets[1]], 32, 24, 25, 1, b"FFV1", ex))
    with pytest.raises(ValueError, match=rf"^{path}: AVI with FFV1 video, frame 0: an FFV1 slice with a bad CRC"):
        read_all(path)
    path, packets, ex = _lavc_avi(tmp_path, "table.avi", "huffyuv", "yuv422p", {}, b"HFYU", 16)
    overflow = ex[:4] + bytes([1, 255, 1, 255]) + ex[8:]  # two runs of 255 lengths: past the table's 256
    path.write_bytes(avi_bytes(packets, 32, 24, 25, 1, b"HFYU", overflow, 16))
    with pytest.raises(ValueError, match=rf"^{path}: AVI with HuffYUV video: a code-length table that overflows"):
        read_all(path)
    data = (FIXTURES / "png_rgb24.avi").read_bytes()
    head, chunks = avi_parts(data)
    path = tmp_path / "png_cut.avi"
    path.write_bytes(pack_avi(head, [chunks[0], chunks[1][:len(chunks[1]) // 2]] + chunks[2:]))
    with pytest.raises(ValueError, match=rf"^{path}: AVI with PNG video, frame 1: "):
        read_all(path)


def _flip(data: bytes, bit: int) -> bytes:
    out = bytearray(data)
    out[bit >> 3] ^= 0x80 >> (bit & 7)
    return bytes(out)


@pytest.mark.parametrize("name", ["ffv1_v0_golomb_gray.avi", "ffv1_v3_golomb_yuva420p_4slices.mkv",
                                  "ffv1_v1_custom_yuv422p_ctx1_odd.avi", "ffv1_v3_custom_bgr0_ctx1.mp4",
                                  "hfyu_yuv422p_median.avi", "ffvh_yuv420p_median_ctx1.avi",
                                  "hfyu_v1_classic_decorrelated.avi", "png_pal4_trns.avi", "cv2_ffvh.wmv"])
def test_cut_and_flipped_files_raise_value_errors_or_give_frames(tmp_path, name):
    """Cut at 30 seeded places, or a bit flipped at 90: a ValueError naming
    the file, or frames of the header's size; never a crash."""
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    data = (FIXTURES / name).read_bytes()
    rng = np.random.default_rng(11)
    path = tmp_path / name
    variants = [data[:k] for k in sorted(rng.choice(len(data), 30, replace=False))]
    for k in rng.choice(len(data), 90, replace=False):
        variants.append(_flip(data, 8 * int(k) + int(rng.integers(8))))
    for v in variants:
        path.write_bytes(v)
        try:
            with VideoReader(path) as r:
                for img in r:
                    assert img.shape == (r.size[1], r.size[0], 3)
        except ValueError as e:
            assert str(e).startswith(str(path)), e


# ---------------------------------------------------------------- the path


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The JAX flagship with seeded weights, the port's model with the same
    weights and a checkpoint of them (as ``tests/test_torch_predict.py``)."""
    import torch

    from mga_yolo_tpu.models.yolo import create_model as jcreate
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax

    cfg = "configs/models/yolov8_cbam.yaml"
    root = tmp_path_factory.mktemp("lossless_predict")
    jmodel, _ = jcreate(cfg, scale="n", nc=1)
    v = seeded_variables(jmodel, IMGSZ, seed=5)
    tmodel, tspec = create_model(cfg, scale="n", nc=1, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(v, tspec), strict=True)
    ckpt = root / "best.pt"
    torch.save({"ema_state_dict": tmodel.state_dict(), "train_args": {"nc": 1, "model": cfg, "model_scale": "n"},
                "meta": {"imgsz": IMGSZ, "model_yaml": cfg, "model_scale": "n", "nc": 1}}, ckpt)
    return dict(jmodel=jmodel, v=v, tmodel=tmodel, ckpt=ckpt, root=root)


def _source_dir(root: Path, names) -> Path:
    src = root / "src"
    src.mkdir(parents=True, exist_ok=True)
    for name in names:
        shutil.copy(FIXTURES / name, src / name)
    return src


def test_iter_source_over_lossless_clips_equals_jax(tmp_path):
    """FFV1, HuffYUV, FFVHuff and PNG clips in AVI, Matroska, MP4 and MOV read
    through ``iter_source`` as the JAX package reads them."""
    from mga_yolo_tpu.data import sources as J
    from mga_yolo_tpu_torch.data import sources as P

    src = _source_dir(tmp_path, ("ffv1_v3_golomb_yuva420p_4slices.mkv", "hfyu_rgb24_left.mov", "cv2_ffvh.avi",
                                 "png_pal8.avi", "ffv1_v3_custom_bgr0_ctx1.mp4"))
    assert P.list_files(src) == J.list_files(src)
    for cap in (0, 2):
        got, want = list(P.iter_source(src, max_frames=cap)), list(J.iter_source(src, max_frames=cap))
        assert [(f.path, f.index, f.is_video, f.fps, f.total) for f in got] == \
            [(f.path, f.index, f.is_video, f.fps, f.total) for f in want]
        for f, jf in zip(got, want):
            np.testing.assert_array_equal(f.img, jf.img)
    assert sum(f.is_video for f in got) == 10


def test_cli_predict_on_an_ffv1_clip_writes_what_the_jax_cli_writes(flagship, tmp_path, monkeypatch, capsys):
    """``cli.predict`` over a small FFV1 ``.mkv`` writes the JAX CLI's files
    and lines (the JAX CLI run with the port's predictor, so only decoding,
    naming and writing differ); the port's boxes on its frames equal the JAX
    predictor's on cv2's within 1e-3 px."""
    import mga_yolo_tpu.train.predictor as jax_predictor
    from mga_yolo_tpu.cli import predict as jax_cli
    from mga_yolo_tpu.data import sources as J
    from mga_yolo_tpu.train.predictor import MGAPredictor as JPredictor
    from mga_yolo_tpu.utils import compile_cache
    from mga_yolo_tpu_torch.cli import predict as cli_predict
    from mga_yolo_tpu_torch.data import sources as P
    from mga_yolo_tpu_torch.train.predictor import MGAPredictor, load_predictor

    src = _source_dir(tmp_path, ("ffv1_v3_range_gray_16slices_nocrc.mov",))
    args = ["--weights", str(flagship["ckpt"]), "--source", str(src), "--conf", "0.01", "--batch", "4",
            "--max-frames", "3"]
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    res = cli_predict.main(args + ["--out", str(port_out), "--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(jax_predictor, "load_predictor", lambda *a, **k: load_predictor(
        flagship["ckpt"], conf=0.01, device="cpu"))
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: None)
    jax_cli.main(args + ["--out", str(jax_out)])
    jax_lines = capsys.readouterr().out.splitlines()
    assert res["frames"] == 3
    assert sorted(p.name for p in port_out.iterdir()) == sorted(p.name for p in jax_out.iterdir())
    assert [ln.replace(str(port_out), "OUT") for ln in port_lines] == \
        [ln.replace(str(jax_out), "OUT") for ln in jax_lines]
    port_frames = [f.img for f in P.iter_source(src, max_frames=3) if f.is_video]
    jax_frames = [f.img for f in J.iter_source(src, max_frames=3) if f.is_video]
    got = MGAPredictor(flagship["tmodel"], imgsz=IMGSZ, conf=0.01)(port_frames)
    want = JPredictor(flagship["jmodel"], flagship["v"], imgsz=IMGSZ, conf=0.01)(jax_frames)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        assert_dets_match(g.boxes, w.boxes, rtol=0, atol=1e-3)
