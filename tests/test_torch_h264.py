"""The port's H.264 decoder (``native/h264.cpp`` behind ``native.H264Decoder``;
``data/video_io.py``'s avc1 / avcC, ``V_MPEG4/ISO/AVC`` and AVI ``H264``
tracks) against the JAX package's reader, ``cv2.VideoCapture``, on the CPU.

Nothing in cv2's wheel encodes H.264, so the committed clips
(``python -m tests.video_fixtures.make h264``) come from the tests' own
writer (``tests/video_fixtures/h264_writer.py``): syntax clips of seeded
random choices over every tool the decoder counts (``native.H264_TALLY``:
the Baseline tools, and the Main and High profiles' CABAC, B slices, direct
prediction, weights, the 8x8 transform and scaling matrices), in AVI (start
codes), MP4 and MOV (NAL lengths of 1, 2 and 4 bytes; composition offsets
and edit lists for B pictures) and Matroska, and a 512 x 512 angiogram in
the Baseline and in the High profile, each in MP4 and Matroska. Every frame
equals cv2's to the bit (tolerance 0; the SHA-256 stored in ``h264.json``,
and cv2 read live) with cv2's fps, frame count and fourcc; fresh clips of the
writer too. cv2's MJPG clips one row high are held to cv2 the same way, and
frames 2 to 7 rows high of MJPG and of cropped H.264 written anew.

What the port does not decode is refused by name, each found by flipping
one bit of a clip (the first flip, in order, whose ValueError names it):
SP / SI slices, field and MBAFF pictures, FMO, ASO, redundant pictures, data
partitioning, chroma formats other than 4:2:0 (4:0:0, 4:2:2), bit depths
above 8 and lossless coding; HEVC by its tags. Damage libavcodec conceals
(a gap in frame_num, a lost slice, a stream without its IDR picture) is
refused; cut and flipped files raise ValueError naming the file or give
frames. ``iter_source`` and ``cli.predict`` over the 512 px ``.mp4`` equal
the JAX package's, boxes within ``tests/test_torch_predict.py``'s 1e-3 px.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from tests._torch_port import assert_dets_match, few_torch_threads, seeded_variables  # noqa: F401
from tests.video_fixtures import h264_writer as hw
from tests.video_fixtures.make import avi_bytes, avi_parts, mkv_bytes, pack_avi

FIXTURES = Path(__file__).resolve().parent / "video_fixtures"
META = json.loads((FIXTURES / "h264.json").read_text())
CLIPS = sorted(n for n in META if n.startswith("h264_"))
ROWS = sorted(n for n in META if n.startswith("mjpg_row"))
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


@pytest.fixture(scope="module")
def decoded():
    """name -> (frames' SHA-256, fps, total, fourcc, H.264 tally) of each committed clip, read once."""
    out = {}
    for name in CLIPS + ROWS:
        got, r = read_all(FIXTURES / name)
        out[name] = (sha(got), r.fps, r.total, int.from_bytes(r.fourcc, "little"), getattr(r, "h264_tally", {}))
    return out


def test_fixtures_cover_every_container_and_kind():
    exts = {Path(n).suffix for n in CLIPS}
    assert exts == {".avi", ".mp4", ".mov", ".mkv"}
    assert META["h264_big512.mp4"]["shape"] == META["h264_big512.mkv"]["shape"] == [512, 512, 3]
    assert META["h264_big512.mp4"]["sha256"] == META["h264_big512.mkv"]["sha256"]  # one stream in two containers
    assert META["h264_odd_full.mp4"]["shape"] == [63, 97, 3]  # the container's size, odd: swscale's scaled path
    assert META["h264_crop_full.mkv"]["shape"] == [60, 98, 3]  # the SPS's crop, right and top and bottom
    assert {META[n]["fps"] for n in CLIPS} == {25.0, 30.0, 30000 / 1001}
    assert all(META[n]["fourcc"] == int.from_bytes(b"h264", "little") for n in CLIPS)
    assert [META[n]["shape"] for n in ROWS] == [[1, w, 3] for w in (1, 16, 2, 64, 8)]
    assert META["h264_high512.mp4"]["sha256"] == META["h264_high512.mkv"]["sha256"]  # the High profile's stream
    trim, full = META["h264_b_cabac_trim.mp4"], META["h264_b_cabac.mp4"]
    assert trim["sha256"] == full["sha256"][2:]  # an edit list from the third frame: frames after the reordering
    assert sum((FIXTURES / n).stat().st_size for n in META) < 1_000_000


@pytest.mark.parametrize("name", CLIPS + ROWS)
def test_reader_equals_cv2_to_the_bit(decoded, name):
    """Every frame equal to cv2's (its SHA-256 stored, and cv2 read live),
    with cv2's fps, frame count and fourcc; the file the one recorded."""
    meta = META[name]
    assert hashlib.sha256((FIXTURES / name).read_bytes()).hexdigest() == meta["file_sha256"]
    got, fps, total, fourcc, _ = decoded[name]
    want, cv2_meta = cv2_read(FIXTURES / name)
    assert got == meta["sha256"] == sha(want)
    assert (fps, total, fourcc) == cv2_meta == (meta["fps"], meta["total"], meta["fourcc"])
    assert len(got) == meta["frames"]


# per fixture, the tools its decoding must have counted
TOOLS = {
    "h264_intra.avi": ("pictures_i", "mb_pcm", "suffix_length_6", "level_prefix_15", "coeff_token_3",
                       "emulation_prevention"),
    "h264_inter.mp4": ("list_mod_1", "mb_p8x8ref0", "sub_4x4", "mc_off_picture", "nal_length_4"),
    "h264_longterm.mkv": ("idr_long_term", "long_term_refs", "list_mod_2", "mmco_6", "nal_length_2"),
    "h264_mmco5.avi": ("mmco_5", "pictures_non_ref", "nal_skipped", "skip_predicted"),
    "h264_poc1.mp4": ("poc_type_1", "profile_77", "nal_length_1", "multi_slice_pictures"),
    "h264_poc2.avi": ("poc_type_2", "nal_skipped"),
    "h264_crop_full.mkv": ("cropped", "full_range", "profile_100"),
    "h264_constrained.avi": ("constrained_intra", "mb_intra_in_p", "deblock_idc_2"),
    "h264_wrap.avi": ("sliding_window",),
    "h264_big512.mp4": ("mb_i16x16", "mb_skip", "skip_zero", "bs_2", "i16x16_ac"),
    "h264_cabac_intra.avi": ("cabac_slices", "cabac_pcm", "mb_i8x8", "i8x8_mode_4", "cabac_coeff_escape"),
    "h264_cabac_p.mp4": ("weights_explicit_p", "weights_same_picture", "cabac_init_2", "mb_p8x8"),
    "h264_b_cavlc.avi": ("pictures_b", "pictures_b_ref", "direct_spatial", "direct_no_inference", "transform_8x8",
                         "deblock_8x8_coded", "sub_b4x4"),
    "h264_b_cabac.mp4": ("mb_b_skip", "mb_b8x8", "sub_b_direct", "weights_implicit", "direct_temporal",
                         "direct_col_zero"),
    "h264_b_noreorder.mkv": ("pictures_b", "mb_b_direct16x16", "pred_bi", "mb_intra_in_b"),
    "h264_b_weighted.mov": ("weights_explicit_b", "pred_l1", "mb_b16x8"),
    "h264_b_longterm.mkv": ("direct_long_term", "weights_implicit_default", "list_swap", "list_mod_l1"),
    "h264_scaling_sps.mp4": ("scaling_sps", "scaling_default", "scaling_fallback_a", "luma_dc_coarse"),
    "h264_scaling_pps.avi": ("scaling_pps", "scaling_fallback_b", "scaling_sent"),
    "h264_high512.mp4": ("cabac_slices", "transform_8x8", "mb_b_direct16x16", "weights_implicit", "list_mod_0"),
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tally_counts_each_tool(decoded, name):
    tally = decoded[name][4]
    missing = [k for k in TOOLS[name] if not tally[k]]
    assert not missing, (name, missing, tally)


def test_every_counted_tool_occurs_in_some_fixture(decoded):
    """Each thing the decoder counts (every tool it decodes) is used by at
    least one committed clip; what none uses is refused instead."""
    from mga_yolo_tpu_torch import native

    total = dict.fromkeys(native.H264_TALLY, 0)
    for name in CLIPS:
        for k, v in decoded[name][4].items():
            total[k] += v
    assert all(total.values()), [k for k, v in total.items() if not v]


FRESH = {  # seed: (macroblocks across and down, frames, SPS, PPS, choices) of clips written anew
    1: ((3, 2), 6, {"refs": 3}, {"refs": 2, "cqp": -3}, {"slices": 2, "deblock_idc": [0, 2], "mods": 0.5}),
    2: ((2, 3), 8, {"refs": 2, "poc_type": 2}, {"refs": 2, "constrained": 1},
        {"non_ref": 0.3, "intra_in_p": 0.4, "deblock_idc": [0]}),
    3: ((4, 1), 6, {"refs": 4}, {"refs": 4}, {"mmco": 0.6, "mods": 0.5, "qp_range": (0, 20), "deblock_idc": [0, 1]}),
    4: ((1, 4), 5, {"refs": 1, "profile": 100}, {"cqp": 5, "cqp2": -7}, {"qp_range": (20, 51), "deblock_idc": [0]}),
    # the Main and High profiles: CABAC, B pictures, weights, the 8x8 transform, scaling matrices
    5: ((3, 2), 8, {"refs": 3, "profile": 77, "log2_max_poc_lsb": 8}, {"cabac": 1, "refs": 2, "refs1": 2},
        {"b": 1, "pyramid": 1, "slices": 2, "deblock_idc": [0, 2]}),
    6: ((2, 3), 8, {"refs": 3, "profile": 100, "log2_max_poc_lsb": 8}, {"t8x8": 1, "bipred": 2, "refs": 2, "refs1": 2},
        {"b": 1, "mods": 0.4, "deblock_idc": [0]}),
    7: ((3, 2), 7, {"refs": 3, "profile": 100, "log2_max_poc_lsb": 8, "scaling": 1},
        {"cabac": 1, "t8x8": 1, "weighted": 1, "bipred": 1, "refs": 2, "refs1": 2, "cqp": 2},
        {"b": 1, "dup": 0.5, "deblock_idc": [0, 1]}),
}


@pytest.mark.parametrize("seed", sorted(FRESH))
def test_fresh_writer_clips_equal_cv2(tmp_path, seed):
    """Clips written anew (other seeds and sizes) read as cv2 reads them."""
    (mw, mh), n, sps, pps, choices = FRESH[seed]
    units, _, _ = hw.syntax_clip(1000 + seed, mw, mh, n, sps, pps, dict(choices, qp_range=choices.get("qp_range",
                                                                                                       (10, 40))))
    path = tmp_path / "fresh.avi"
    path.write_bytes(avi_bytes([hw.annex_b(u) for u in units], 16 * mw, 16 * mh, 25, 1, b"H264"))
    got, r = read_all(path)
    want, (fps, total, fourcc) = cv2_read(path)
    assert len(got) == len(want) == n and sha(got) == sha(want)
    assert (r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (fps, total, fourcc)


@pytest.mark.parametrize("width", [1, 2, 8, 16, 64])
def test_one_row_mjpeg_equals_cv2(tmp_path, width):
    """MJPG frames one row high, written anew by cv2 (3 frames of random
    pixels): equal to cv2's frames at tolerance 0 (swscale's scaled path,
    its one-tap C output stage, in full range)."""
    path = tmp_path / f"row{width}.avi"
    rng = np.random.default_rng(width)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 25, (width, 1))
    for _ in range(3):
        vw.write(rng.integers(0, 256, (1, width, 3), np.uint8))
    vw.release()
    got, _ = read_all(path)
    want, _ = cv2_read(path)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("height", range(2, 8))
def test_frames_two_to_seven_rows_high_equal_cv2(tmp_path, height):
    """Frames 2 to 7 rows high written anew: cv2's MJPG clips 1, 2, 17 and 64
    samples wide (3 frames of random pixels), and H.264 clips 32 wide whose
    SPS crops them to an even height (the AVI's size crops an odd one), in
    both ranges: equal to cv2's frames at tolerance 0. Odd heights take
    swscale's scaled path, whose chroma filter has one or two taps here
    (``native/yuv.cpp``)."""
    from tests.video_fixtures.make import h264_pack

    for w in (1, 2, 17, 64):
        path = tmp_path / f"m{w}.avi"
        rng = np.random.default_rng(height * 100 + w)
        vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 25, (w, height))
        for _ in range(3):
            vw.write(rng.integers(0, 256, (height, w, 3), np.uint8))
        vw.release()
        got, _ = read_all(path)
        want, _ = cv2_read(path)
        assert len(got) == len(want) == 3
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x, err_msg=f"MJPG {w} x {height}")
    for full in (0, 1):
        sps = {"refs": 1, "crop": (0, 0, 0, (16 - height - (height & 1)) // 2), **({"full_range": 1} if full else {})}
        units, _, _ = hw.syntax_clip(300 + height, 2, 1, 3, sps, {}, {"deblock_idc": [0], "qp_range": (10, 40)})
        path = tmp_path / f"h{full}.avi"
        path.write_bytes(h264_pack(path.name, units, 32, height, 4, (25, 1)))
        got, _ = read_all(path)
        want, _ = cv2_read(path)
        assert len(got) == len(want) == 3 and got[0].shape == (height, 32, 3)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x, err_msg=f"H.264 32 x {height}, full range {full}")


@pytest.mark.parametrize("height", [3, 5, 7, 9, 11, 13, 15])
def test_odd_heights_of_h264_equal_cv2_in_either_siting(tmp_path, height):
    """H.264 clips of odd height (the SPS's crop to the even height above,
    the AVI's size to the odd one) 16 to 96 wide: without a VUI libavcodec
    leaves the chroma siting unspecified, which swscale takes as centred;
    with one (the full-range clips) it is left-sited. Both equal cv2's frames
    at tolerance 0."""
    from tests.video_fixtures.make import h264_pack

    mh = (height + 15) // 16
    for full in (0, 1):
        for w in (16, 48, 96):
            sps = {"refs": 1, "crop": (0, 0, 0, (16 * mh - height - 1) // 2), **({"full_range": 1} if full else {})}
            units, _, _ = hw.syntax_clip(500 + height + w, w // 16, mh, 2, sps, {}, {"deblock_idc": [0],
                                                                                      "qp_range": (10, 40)})
            path = tmp_path / f"o{w}_{full}.avi"
            path.write_bytes(h264_pack(path.name, units, w, height, 4, (25, 1)))
            got, _ = read_all(path)
            want, _ = cv2_read(path)
            assert len(got) == len(want) == 2
            for g, x in zip(got, want):
                np.testing.assert_array_equal(g, x, err_msg=f"{w} x {height}, full range {full}")


def _swscale_bgr(y, u, v, full: bool, left: bool):
    """libswscale's BGR24 of 4:2:0 planes (the one in cv2's wheel, through
    ctypes), as cv2 calls it: SWS_BICUBIC at the same size, the planes in
    buffers aligned and padded as libavcodec's, the chroma left-sited or
    centred (unspecified). swscale reads past the edge at odd widths.
    """
    import ctypes

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
    avutil.av_log_set_level(8)
    h, w = y.shape
    ctx = sws.sws_alloc_context()
    for key, val in ((b"srcw", w), (b"srch", h), (b"src_format", 12 if full else 0), (b"dstw", w), (b"dsth", h),
                     (b"dst_format", 3), (b"sws_flags", 4), *(((b"src_h_chr_pos", 0),) if left else ())):
        assert avutil.av_opt_set_int(ctx, key, val, 0) >= 0, key
    assert sws.sws_init_context(ctx, None, None) >= 0

    def aligned(rows, cols):
        raw = np.zeros(rows * cols + 64, np.uint8)
        off = -raw.ctypes.data % 64
        return raw[off:off + rows * cols].reshape(rows, cols)
    bufs = []
    for p in (y, u, v):  # past its edge a row repeats its last sample, as a decoder's padded buffer does
        b = aligned(p.shape[0] + 4, (p.shape[1] + 63) // 64 * 64 + 64)
        b[:] = np.pad(p, ((0, 4), (0, b.shape[1] - p.shape[1])), mode="edge")
        bufs.append(b)
    out = aligned(h + 2, (w * 3 + 63) // 64 * 64 + 64)  # room for the SIMD converter's last 8-pixel block
    src = (vp * 4)(*[b.ctypes.data for b in bufs], None)
    strides = (ctypes.c_int * 4)(*[b.shape[1] for b in bufs], 0)
    sws.sws_scale(ctx, src, strides, 0, h, (vp * 4)(out.ctypes.data, None, None, None),
                  (ctypes.c_int * 4)(out.shape[1], 0, 0, 0))
    sws.sws_freeContext(ctx)
    return out[:h, :w * 3].reshape(h, w, 3)


@pytest.mark.parametrize("height", [1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 17])
def test_colour_conversion_equals_libswscale(height):
    """``native.yuv_to_bgr`` against libswscale itself (cv2's, through
    ctypes) on video-like 4:2:0 planes 1 to 97 samples wide, in both ranges
    and both sitings: equal at tolerance 0, the short frames whose chroma
    filter has one or two taps (swscale's yuv2packed1) included."""
    from mga_yolo_tpu_torch import native

    rng = np.random.default_rng(height)

    def smooth(shape):
        yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
        base = 128 + 60 * np.sin(xx / 7.0 + rng.random() * 6) * np.cos(yy / 5.0 + rng.random() * 6)
        return np.clip(base + rng.normal(0, 6, shape), 0, 255).astype(np.uint8)
    for full in (False, True):
        for left in (False, True):
            for w in (1, 2, 3, 16, 17, 32, 63, 64, 97):
                y = smooth((height, w))
                u, v = smooth(((height + 1) // 2, (w + 1) // 2)), smooth(((height + 1) // 2, (w + 1) // 2))
                np.testing.assert_array_equal(native.yuv_to_bgr(y, u, v, full_range=full, chroma_left=left),
                                              _swscale_bgr(y, u, v, full, left),
                                              err_msg=f"{w} x {height}, full range {full}, left {left}")


def test_reader_starts_with_the_delay_ffmpeg_probes(decoded):
    """Without the VUI's bitstream restriction libavcodec's output delay
    grows at the first B picture, too late for a picture already passed, which
    it drops; cv2's decoder starts with the delay ffmpeg's stream probing
    reached, and so does the reader, which gives every frame. The probe stops
    early where the delay is the SPS's num_reorder_frames."""
    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    name = "h264_b_noreorder.mkv"
    with VideoReader(FIXTURES / name) as r:
        samples = [r._sample(s) for s in r.samples]
        delay = r._h264_probed_delay()
        dec = native.H264Decoder(r.extradata, r.size)
    out = sum(len(dec.decode(x)) for x in samples) + len(dec.flush())
    assert delay > 0 and dec.delay == delay
    assert out < META[name]["frames"] == len(decoded[name][0])
    # the probe's other stop, libavcodec's num_reorder_frames: the level's DPB over 6 macroblocks, at most 15,
    # here; the VUI's value (2) where the SPS sends it, which the delay reaches at the first picture
    assert dec.reorder_hint == 15
    with VideoReader(FIXTURES / "h264_b_cabac.mp4") as r:
        assert r._h264_probed_delay() == 2
        first = native.H264Decoder(r.extradata, r.size)
        first.decode(r._sample(r.samples[0]))
        assert first.delay == first.reorder_hint == 2


# ---------------------------------------------------------------- refusals


def _nals(sample: bytes, size: int) -> list:
    """(offset, length) of the NAL units of a sample: start codes (size 0) or lengths of size bytes."""
    out = []
    if size:
        p = 0
        while p < len(sample):
            n = int.from_bytes(sample[p:p + size], "big")
            out.append((p + size, n))
            p += size + n
        return out
    starts = [m.end() for m in re.finditer(b"\x00\x00\x01", sample)]
    for i, s in enumerate(starts):
        end = starts[i + 1] - 3 if i + 1 < len(starts) else len(sample)
        while end > s and sample[end - 1] == 0:
            end -= 1
        out.append((s, end - s))
    return out


def _locate(name: str, kind: int, sample: int, nth: int = 0):
    """(file offset, length) of the nth NAL unit of type kind in the given sample (-1: the avcC record), and the
    reader's samples, extradata and size."""
    _, r = read_all(FIXTURES / name)
    data = (FIXTURES / name).read_bytes()
    size = (r.extradata[4] & 3) + 1 if r.extradata[:1] == b"\x01" else 0
    if sample < 0:
        base = data.find(r.extradata)
        cfg, p, units = r.extradata, 5, []
        for count_mask in (0x1F, 0xFF):
            count = cfg[p] & count_mask
            p += 1
            for _ in range(count):
                n = int.from_bytes(cfg[p:p + 2], "big")
                units.append((p + 2, n))
                p += 2 + n
        o, n = [u for u in units if cfg[u[0]] & 0x1F == kind][nth]
        return base + o, n, r
    so, sn = r.samples[sample]
    units = [u for u in _nals(data[so:so + sn], size) if data[so + u[0]] & 0x1F == kind]
    o, n = units[nth]
    return so + o, n, r


def _flip(data: bytes, bit: int) -> bytes:
    out = bytearray(data)
    out[bit >> 3] ^= 0x80 >> (bit & 7)
    return bytes(out)


def _refused_by_flip(tmp_path, name: str, kind: int, sample: int, what: str, nth: int = 0, limit: int = 400):
    """The first bit, in order, of the nth NAL unit of type kind in the sample (-1: the avcC record) whose flip
    makes the decoder refuse ``what``; the clip so flipped."""
    from mga_yolo_tpu_torch import native

    off, n, r = _locate(name, kind, sample, nth)
    data = (FIXTURES / name).read_bytes()
    ex_off = data.find(r.extradata) if r.extradata else -1
    upto = max(sample, 0)
    for bit in range(min(limit, 8 * n)):
        x = _flip(data, 8 * off + bit)
        try:
            dec = native.H264Decoder(x[ex_off:ex_off + len(r.extradata)] if ex_off >= 0 else b"", r.size)
            for o, k in r.samples[:upto + 2]:
                dec.decode(x[o:o + k])
        except ValueError as e:
            if what in str(e):
                path = tmp_path / f"flip{bit}{Path(name).suffix}"
                path.write_bytes(x)
                return path
    raise AssertionError(f"no flip of {name} gives {what!r}")


@pytest.mark.parametrize("name, kind, sample, what", [
    ("h264_cabac_intra.avi", 7, 0, "4:0:0"), ("h264_intra.avi", 8, 0, "FMO"),
    ("h264_b_cabac.mp4", 7, -1, "4:2:2"), ("h264_intra.avi", 8, 0, "redundant pictures"),
    ("h264_intra.avi", 7, 0, "field or MBAFF"), ("h264_b_cavlc.avi", 7, 0, "bit depth 10"),
    ("h264_scaling_pps.avi", 7, 0, "lossless"), ("h264_crop_full.mkv", 7, -1, "chroma format"),
    ("h264_crop_full.mkv", 7, -1, "bit depth"), ("h264_high512.mkv", 7, -1, "field or MBAFF"),
    ("h264_inter.mp4", 1, 2, "SP / SI slices"), ("h264_inter.mp4", 1, 1, "data partitioning")])
def test_each_refused_feature_raises_naming_it(tmp_path, name, kind, sample, what):
    """A feature the port does not decode, switched on by one flipped bit of
    a clip: ValueError naming the file, the container, H.264 and the
    feature."""
    path = _refused_by_flip(tmp_path, name, kind, sample, what)
    container = {".avi": "AVI", ".mp4": "MP4", ".mkv": "Matroska"}[path.suffix]
    with pytest.raises(ValueError, match=rf"^{path}: {container} with H\.264 video.*: .*{re.escape(what)}"):
        read_all(path)


def test_arbitrary_slice_order_raises_naming_it(tmp_path):
    """ASO: a flip in the second slice of a picture that starts it before
    the first slice's end."""
    _, r = read_all(FIXTURES / "h264_intra.avi")
    data = (FIXTURES / "h264_intra.avi").read_bytes()
    sample = next(i for i, (o, n) in enumerate(r.samples) if len(_nals(data[o:o + n], 0)) >= 4)
    path = _refused_by_flip(tmp_path, "h264_intra.avi", 5 if sample % 2 == 0 else 1, sample,
                            "arbitrary slice order", nth=1)
    with pytest.raises(ValueError, match=rf"^{path}: AVI with H\.264 video, sample {sample}: arbitrary slice order"):
        read_all(path)


@pytest.mark.parametrize("form", ["mp4", "avi"])
def test_hevc_raises_naming_it(tmp_path, form):
    src = {"mp4": "h264_inter.mp4", "avi": "h264_intra.avi"}[form]
    old, new = {"mp4": (b"avc1", b"hvc1"), "avi": (b"H264", b"HEVC")}[form]
    path = tmp_path / f"hevc.{form}"
    path.write_bytes((FIXTURES / src).read_bytes().replace(old, new))
    with pytest.raises(ValueError, match=rf"^{path}: (MP4|AVI) with HEVC video \('{new.decode()}'\) is not supported"):
        read_all(path)


def test_h264_in_webm_raises_naming_it(tmp_path):
    """WebM cannot carry H.264: the port refuses the track by name."""
    from tests.video_fixtures.make import mkv_blocks

    data = (FIXTURES / "h264_longterm.mkv").read_bytes()
    _, r = read_all(FIXTURES / "h264_longterm.mkv")
    packets = [(data[o:o + n], i == 0, 40 * i) for i, (o, n) in enumerate(mkv_blocks(data))]
    path = tmp_path / "h264.webm"
    path.write_bytes(mkv_bytes("V_MPEG4/ISO/AVC", 64, 48, packets, private=r.extradata, default_duration=40000000))
    with pytest.raises(ValueError, match=rf"^{path}: WebM with H\.264 video \('V_MPEG4/ISO/AVC'\)"):
        read_all(path)


def _damaged(kind: str) -> tuple[bytes, str]:
    head, chunks = avi_parts((FIXTURES / "h264_constrained.avi").read_bytes())
    if kind == "gap":  # a reference P picture left out: the next one's frame_num jumps
        k = next(i for i, c in enumerate(chunks) if i > 0 and any(c[o] & 0x60 for o, _ in _nals(c, 0)))
        return pack_avi(head, chunks[:k] + chunks[k + 1:]), "a gap in frame_num"
    if kind == "lost_slice":  # the second slice of a picture left out
        k, c = next((i, c) for i, c in enumerate(chunks) if sum(c[o] & 0x1F in (1, 5) for o, _ in _nals(c, 0)) >= 2)
        slices = [(o, n) for o, n in _nals(c, 0) if c[o] & 0x1F in (1, 5)]
        o, n = slices[1]
        return pack_avi(head, chunks[:k] + [c[:o - 3] + c[o + n:]] + chunks[k + 1:]), "macroblocks"
    # no IDR picture: the first chunk's parameter sets only
    first = chunks[0]
    keep = b"".join(b"\x00\x00\x00\x01" + first[o:o + n] for o, n in _nals(first, 0) if first[o] & 0x1F in (7, 8))
    return pack_avi(head, [keep] + chunks[1:]), "does not start with an IDR picture"


@pytest.mark.parametrize("kind", ["gap", "lost_slice", "no_idr"])
def test_damage_libavcodec_conceals_is_refused(tmp_path, kind):
    data, what = _damaged(kind)
    path = tmp_path / f"{kind}.avi"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=rf"^{path}: AVI with H\.264 video.*{what}"):
        read_all(path)


def test_left_crop_libavutil_realigns_is_refused(tmp_path):
    units, _, _ = hw.syntax_clip(5, 2, 1, 2, {"crop": (1, 0, 0, 0)}, {}, {"deblock_idc": [0]})
    path = tmp_path / "left.avi"
    path.write_bytes(avi_bytes([hw.annex_b(u) for u in units], 30, 16, 25, 1, b"H264"))
    with pytest.raises(ValueError, match=rf"^{path}: AVI with H\.264 video.*a left frame crop of 2 samples"):
        read_all(path)


@pytest.mark.parametrize("name", ["h264_intra.avi", "h264_inter.mp4", "h264_longterm.mkv", "h264_mmco5.avi",
                                  "h264_cabac_intra.avi", "h264_b_cabac.mp4", "h264_b_cavlc.avi",
                                  "h264_scaling_sps.mp4"])
def test_cut_and_flipped_files_raise_value_errors_or_give_frames(tmp_path, name):
    """Cut at 40 seeded places, or a bit flipped at 120: a ValueError naming
    the file, or frames of the header's size; never a crash. libavcodec
    conceals damage; the port refuses it."""
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    data = (FIXTURES / name).read_bytes()
    rng = np.random.default_rng(7)
    path = tmp_path / name
    variants = [data[:k] for k in sorted(rng.choice(len(data), 40, replace=False))]
    for k in rng.choice(len(data), 120, replace=False):
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
    root = tmp_path_factory.mktemp("h264_predict")
    jmodel, _ = jcreate(cfg, scale="n", nc=1)
    v = seeded_variables(jmodel, IMGSZ, seed=4)
    tmodel, tspec = create_model(cfg, scale="n", nc=1, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(v, tspec), strict=True)
    ckpt = root / "best.pt"
    torch.save({"ema_state_dict": tmodel.state_dict(), "train_args": {"nc": 1, "model": cfg, "model_scale": "n"},
                "meta": {"imgsz": IMGSZ, "model_yaml": cfg, "model_scale": "n", "nc": 1}}, ckpt)
    return dict(jmodel=jmodel, v=v, tmodel=tmodel, ckpt=ckpt, root=root)


def _source_dir(root: Path, names=("h264_big512.mp4", "h264_clip.mov")) -> Path:
    src = root / "src"
    src.mkdir(parents=True, exist_ok=True)
    for name in names:
        shutil.copy(FIXTURES / name, src / name)
    return src


def test_iter_source_over_h264_clips_equals_jax(tmp_path):
    """Baseline, Main and High clips (B pictures in MP4 with composition
    offsets, one whose edit list starts after the reordering, Matroska and
    MOV) read through ``iter_source`` as the JAX package reads them."""
    from mga_yolo_tpu.data import sources as J
    from mga_yolo_tpu_torch.data import sources as P

    src = _source_dir(tmp_path, ("h264_big512.mp4", "h264_clip.mov", "h264_high512.mp4", "h264_b_cabac_trim.mp4",
                                 "h264_b_longterm.mkv"))
    assert P.list_files(src) == J.list_files(src)
    for cap in (0, 3):
        got, want = list(P.iter_source(src, max_frames=cap)), list(J.iter_source(src, max_frames=cap))
        assert [(f.path, f.index, f.is_video, f.fps, f.total) for f in got] == \
            [(f.path, f.index, f.is_video, f.fps, f.total) for f in want]
        for f, jf in zip(got, want):
            np.testing.assert_array_equal(f.img, jf.img)
    assert sum(f.is_video for f in got) == 15


def test_cli_predict_on_h264_clips_writes_what_the_jax_cli_writes(flagship, tmp_path, monkeypatch, capsys):
    """``cli.predict`` over the 512 px H.264 ``.mp4`` and a ``.mov`` writes
    the JAX CLI's files and lines (the JAX CLI run with the port's
    predictor, so only decoding, naming and writing differ); the port's
    boxes on its frames equal the JAX predictor's on cv2's within 1e-3 px."""
    import mga_yolo_tpu.train.predictor as jax_predictor
    from mga_yolo_tpu.cli import predict as jax_cli
    from mga_yolo_tpu.data import sources as J
    from mga_yolo_tpu.train.predictor import MGAPredictor as JPredictor
    from mga_yolo_tpu.utils import compile_cache
    from mga_yolo_tpu_torch.cli import predict as cli_predict
    from mga_yolo_tpu_torch.data import sources as P
    from mga_yolo_tpu_torch.train.predictor import MGAPredictor, load_predictor

    src = _source_dir(tmp_path)
    args = ["--weights", str(flagship["ckpt"]), "--source", str(src), "--conf", "0.01", "--batch", "4",
            "--max-frames", "5"]
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    res = cli_predict.main(args + ["--out", str(port_out), "--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(jax_predictor, "load_predictor", lambda *a, **k: load_predictor(
        flagship["ckpt"], conf=0.01, device="cpu"))
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: None)
    jax_cli.main(args + ["--out", str(jax_out)])
    jax_lines = capsys.readouterr().out.splitlines()
    assert res["frames"] == 2 * 5
    assert sorted(p.name for p in port_out.iterdir()) == sorted(p.name for p in jax_out.iterdir())
    assert [ln.replace(str(port_out), "OUT") for ln in port_lines] == \
        [ln.replace(str(jax_out), "OUT") for ln in jax_lines]
    port_frames = [f.img for f in P.iter_source(src, max_frames=3) if f.is_video]
    jax_frames = [f.img for f in J.iter_source(src, max_frames=3) if f.is_video]
    got = MGAPredictor(flagship["tmodel"], imgsz=IMGSZ, conf=0.01)(port_frames)
    want = JPredictor(flagship["jmodel"], flagship["v"], imgsz=IMGSZ, conf=0.01)(jax_frames)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        assert_dets_match(g.boxes, w.boxes, rtol=0, atol=1e-3)
