"""The port's Matroska / WebM path (``data/video_io.py``'s EBML demuxer and
muxer, ``native/vp8.cpp``'s VP8 key and inter frames) against the JAX
package's reader and writer, ``cv2.VideoCapture`` / ``cv2.VideoWriter``, on
the CPU.

Reading: the committed clips of ``tests/video_fixtures`` (``python -m
tests.video_fixtures.make``: cv2's writer, and libvpx through libavcodec for
what cv2's writer leaves off) against cv2, live and as the SHA-256 of each
frame stored beside them: every frame equal to the bit (tolerance 0), with
cv2's fps, frame count and fourcc. The decoder's tally shows which VP8
features the clips exercise. Cut files raise ValueError naming the file
(libavcodec conceals what it can; the port refuses), flipped bytes give a
ValueError or frames, never a crash.

Writing: ``.mkv`` is mp4v in Matroska that cv2 reads back equal to the
port's own reader, at the fps and count written; ``.mov`` and ``.m4v`` carry
cv2's brands; ``.webm`` and suffixes cv2 refuses raise RuntimeError.

The path on top: ``iter_source`` over ``.mkv``, ``.webm`` and images equals
the JAX package's, and ``cli.predict`` writes what the JAX CLI writes, its
boxes equal to the JAX predictor's within ``tests/test_torch_predict.py``'s
1e-3 px.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from tests._torch_port import assert_dets_match, few_torch_threads, seeded_variables  # noqa: F401
from tests.video_fixtures.make import mkv_blocks, mkv_bytes

FIXTURES = Path(__file__).resolve().parent / "video_fixtures"
META = json.loads((FIXTURES / "meta.json").read_text())
CLIPS = sorted(n for n in META if n.endswith((".mkv", ".webm")))
VP8 = [n for n in CLIPS if n.startswith(("vp8", "big512"))]
# VP8 features no writer here produces (ROADMAP.md section 3 lists them as untested)
UNTESTED = {"golden_copies", "mode_prob_updates", "golden_sign_bias"}
IMGSZ = 64
pytestmark = pytest.mark.usefixtures("few_torch_threads")


def cv2_read(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(img)
    meta = cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), int(cap.get(cv2.CAP_PROP_FOURCC))
    cap.release()
    return frames, meta


def sha(imgs) -> list:
    return [hashlib.sha256(np.ascontiguousarray(i).tobytes()).hexdigest() for i in imgs]


def read_all(path):
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    with VideoReader(path) as r:
        frames = list(r)
        return frames, r


def test_fixtures_cover_every_kind():
    assert CLIPS == sorted(["big512.webm", "i420.mkv", "mjpeg_vfw.mkv", "mjpg.mkv", "mp4v.mkv", "vp8.mkv", "vp8.webm",
                            "vp8_altref.webm", "vp8_error_resilient.webm", "vp8_keys.webm", "vp8_live.webm",
                            "vp8_no_default_duration.webm", "vp8_odd97x63.webm", "vp8_odd97x64.webm",
                            "vp8_parts.webm", "vp8_profile1.webm", "vp8_profile3.webm"])
    assert META["vp8_odd97x63.webm"]["shape"] == [62, 96, 3] and META["vp8_odd97x64.webm"]["shape"] == [64, 97, 3]
    assert META["big512.webm"]["shape"] == [512, 512, 3] and len(META["big512.webm"]["sha256"]) == 16
    assert META["vp8_live.webm"]["total"] < 0  # cv2's count for a file without a Duration
    assert sum((FIXTURES / n).stat().st_size for n in CLIPS) < 400_000


@pytest.mark.parametrize("name", CLIPS)
def test_reader_equals_cv2_to_the_bit(name):
    """Every frame equal to cv2's (its SHA-256 stored, and cv2 read live),
    with cv2's fps, frame count and fourcc."""
    meta = META[name]
    frames, r = read_all(FIXTURES / name)
    want, (fps, total, fourcc) = cv2_read(FIXTURES / name)
    assert sha(frames) == meta["sha256"] == sha(want)
    assert (r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (fps, total, fourcc) == \
        (meta["fps"], meta["total"], meta["fourcc"])
    assert r.container == ("WebM" if name.endswith(".webm") and name != "vp8_parts.webm" else "Matroska")
    assert list(frames[0].shape) == meta["shape"] and len(frames) == meta["frames"]


def test_vp8_tally_covers_the_inter_frame_features():
    """Each VP8 feature the decoder handles occurs in some clip; each clip
    made for a feature has it."""
    from mga_yolo_tpu_torch import native

    tallies = {}
    for name in VP8:
        _, r = read_all(FIXTURES / name)
        tallies[name] = r.vp8_tally
    union = {k: sum(t[k] for t in tallies.values()) for k in native.VP8_TALLY}
    assert {k for k, v in union.items() if not v} == UNTESTED
    t = tallies
    assert t["vp8_altref.webm"]["hidden_frames"] >= 1 and t["vp8_altref.webm"]["altref_refreshes"] >= 1
    assert t["vp8_altref.webm"]["ref_altref"] and t["vp8_altref.webm"]["sign_bias_flips"]
    assert t["vp8_altref.webm"]["no_refresh_last"] >= 1
    assert t["vp8_keys.webm"]["key_frames"] == 4 and t["vp8_keys.webm"]["inter_frames"] == 12
    assert t["vp8_parts.webm"]["partitioned_frames"] == 16
    er = t["vp8_error_resilient.webm"]
    assert er["entropy_saves"] == er["frames"] == er["segmented_frames"] == er["segment_map_updates"] == 16
    assert t["vp8_profile1.webm"]["subpel_bilinear"] and not t["vp8_profile1.webm"]["subpel_sixtap"]
    assert t["vp8_profile1.webm"]["simple_filter_frames"] >= 14  # two frames without a loop filter
    assert t["vp8_profile3.webm"]["full_pixel_frames"] == 16
    for name in ("vp8_altref.webm", "vp8_keys.webm"):
        assert all(t[name][k] for k in ("split_16x8", "split_8x16", "split_8x8", "split_4x4", "new_mv", "near_mv",
                                         "nearest_mv", "submv_new", "edge_emulated", "mv_long")), name


def test_vp8_decoder_states_and_refusals():
    """A hidden frame gives no planes; an inter frame before the first key
    frame, a change of size and a closed decoder raise ValueError."""
    from mga_yolo_tpu_torch import native

    data = (FIXTURES / "vp8_altref.webm").read_bytes()
    blocks = [data[o:o + n] for o, n in mkv_blocks(data)]
    dec = native.Vp8Decoder()
    with pytest.raises(ValueError, match="inter frame before the first key frame"):
        dec.decode(blocks[1])
    got = [dec.decode(b) for b in blocks]
    assert sum(g is None for g in got) == 1 and got[0][1] and not any(g[1] for g in got[1:] if g)
    other = (FIXTURES / "vp8.webm").read_bytes()
    with pytest.raises(ValueError, match="frame size changes from 80x64 to 64x48"):
        dec.decode(other[slice(*(lambda o, n: (o, o + n))(*mkv_blocks(other)[0]))])
    dec.close()
    with pytest.raises(ValueError, match="closed"):
        dec.decode(blocks[0])


def test_av_reduce_and_cv2_fps_rules():
    from mga_yolo_tpu_torch.data.video_io import av_reduce

    assert av_reduce(10 ** 9, 33366700, 30000) == (2997, 100)
    assert av_reduce(10 ** 9, 33366667, 30000) == (30000, 1001)
    assert av_reduce(10 ** 9, 40000000, 30000) == (25, 1) and av_reduce(10 ** 9, 500000, 30000) == (2000, 1)
    assert av_reduce(1000, 333, 60000) == (1000, 333)


def _refused(kind: str, tmp_path: Path) -> tuple[Path, str]:
    """A Matroska file the port refuses, and the words of its refusal."""
    mj = (FIXTURES / "mjpg.mkv").read_bytes()
    packets = [(mj[o:o + n], True, 40 * i) for i, (o, n) in enumerate(mkv_blocks(mj))]
    codec = {"vp9": ("V_VP9", "WebM with VP9 video"), "av1": ("V_AV1", "WebM with AV1 video"),
             "h264": ("V_MPEG4/ISO/AVC", r"with H\.264 video"), "hevc": ("V_MPEGH/ISO/HEVC", "with HEVC video"),
             "ffv1": ("V_FFV1", "with FFV1 video"), "theora": ("V_THEORA", "with Theora video"),
             "other": ("V_REAL/RV40", r"with the 'V_REAL/RV40' codec video")}
    if kind in codec:
        cid, what = codec[kind]
        data = mkv_bytes(cid, 64, 48, packets, default_duration=40000000, duration=520)
    elif kind == "content_encoding":  # ContentEncodings > ContentEncoding > ContentCompression (zlib)
        data = mkv_bytes("V_MJPEG", 64, 48, packets, default_duration=40000000,
                         track_extra=b"\x6d\x80\x86\x62\x40\x83\x50\x34\x80")
        what = "content encoding"
    elif kind == "laced":  # Xiph lacing
        data, what = mkv_bytes("V_MJPEG", 64, 48, packets, default_duration=40000000, block_flags=0x02), "laced blocks"
    elif kind == "raw_bgr":
        data = mkv_bytes("V_UNCOMPRESSED", 64, 48, packets, colour_space=b"BGR3")
        what = "uncompressed video of ColourSpace 'BGR3'"
    elif kind == "vfw_h264":
        bih = struct.pack("<IiiHH4sIiiII", 40, 64, 48, 1, 24, b"H264", 0, 0, 0, 0, 0)
        data = mkv_bytes("V_MS/VFW/FOURCC", 64, 48, packets, private=bih)
        what = r"H\.264 video \('V_MS/VFW/FOURCC', 'H264'\)"
    elif kind == "no_video":
        data = mkv_bytes("A_OPUS", 64, 48, packets).replace(b"\x83\x81\x01", b"\x83\x81\x02")
        what = "without a video track"
    elif kind == "doctype":
        data = mkv_bytes("V_VP8", 64, 48, packets).replace(b"webm", b"mka ", 1)
        what = "DocType 'mka ' is not Matroska or WebM"
    else:
        raise KeyError(kind)
    path = tmp_path / f"clip_{kind}.{'mkv' if kind in ('ffv1', 'h264', 'content_encoding') else 'webm'}"
    path.write_bytes(data)
    return path, what


@pytest.mark.parametrize("kind", ["vp9", "av1", "h264", "hevc", "ffv1", "theora", "other", "content_encoding",
                                  "laced", "raw_bgr", "vfw_h264", "no_video", "doctype"])
def test_what_the_port_does_not_read_raises_naming_it(tmp_path, kind):
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    path, what = _refused(kind, tmp_path)
    with pytest.raises(ValueError, match=rf"{path.name}: .*{what}"):
        with VideoReader(path) as r:
            list(r)


@pytest.mark.parametrize("name", ["mp4v.mkv", "vp8_parts.webm", "vp8_altref.webm", "i420.mkv"])
def test_cut_files_raise_value_errors(tmp_path, name):
    """A file of known size cut anywhere (60 seeded places) raises
    ValueError naming it: cv2 would give the frames before the cut."""
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    data = (FIXTURES / name).read_bytes()
    path = tmp_path / name
    for k in sorted(np.random.default_rng(1).choice(len(data), 60, replace=False)):
        path.write_bytes(data[:k])
        with pytest.raises(ValueError, match=rf"^{path}"):
            with VideoReader(path) as r:
                list(r)


@pytest.mark.parametrize("name", ["vp8_altref.webm", "vp8_parts.webm", "mp4v.mkv", "vp8_live.webm"])
def test_flipped_bytes_give_a_value_error_or_frames(tmp_path, name):
    """A bit flipped at 200 seeded places: a ValueError naming the file, or
    frames of the track's size; never a crash (the C++ also ran this under
    ASan and UBSan)."""
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    data = (FIXTURES / name).read_bytes()
    rng = np.random.default_rng(2)
    path = tmp_path / name
    for k in rng.choice(len(data), 200, replace=False):
        flipped = bytearray(data)
        flipped[k] ^= 1 << int(rng.integers(8))
        path.write_bytes(bytes(flipped))
        try:
            with VideoReader(path) as r:
                for img in r:
                    assert img.shape == (r.size[1], r.size[0], 3)
        except ValueError as e:
            assert str(e).startswith(str(path)), e


def test_cut_vp8_inter_frames_raise_value_errors(tmp_path):
    """Each inter frame of a clip cut to 10 % ... 90 % of its bytes (the
    file's sizes fixed up) raises ValueError naming the file and the block."""
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    data = (FIXTURES / "vp8_keys.webm").read_bytes()
    blocks = [data[o:o + n] for o, n in mkv_blocks(data)]
    rng = np.random.default_rng(3)
    path = tmp_path / "cut.webm"
    for i in (1, 2, 7, 11):
        assert blocks[i][0] & 1  # an inter frame
        for frac in (0.1, 0.3, 0.5, 0.7, 0.9):
            cut = blocks[:i] + [blocks[i][:int(len(blocks[i]) * frac)]] + blocks[i + 1:]
            path.write_bytes(mkv_bytes("V_VP8", 80, 64, [(b, not b[0] & 1, 40 * j) for j, b in enumerate(cut)],
                                       default_duration=40000000, duration=640))
            with pytest.raises(ValueError, match=rf"^{path}: WebM with VP8 video, block {i}: truncated VP8"):
                with VideoReader(path) as r:
                    list(r)
        flipped = bytearray(blocks[i])
        flipped[int(rng.integers(3, len(flipped)))] ^= 0xFF
        path.write_bytes(mkv_bytes("V_VP8", 80, 64, [(b, not b[0] & 1, 40 * j) for j, b in
                                                      enumerate(blocks[:i] + [bytes(flipped)] + blocks[i + 1:])],
                                   default_duration=40000000, duration=640))
        try:
            assert len(read_all(path)[0]) == len(blocks)
        except ValueError as e:
            assert str(e).startswith(str(path)), e


@pytest.mark.parametrize("fps", [10, 25, 29.97, 30, 0])
def test_mkv_writer_round_trips_through_cv2(tmp_path, fps):
    """``.mkv`` is mp4v in Matroska: cv2 reads back the port's own reader's
    frames to the bit, the count written and the fps (0 -> 30) as it does
    for the MP4 writer; frames cropped to even sizes."""
    from mga_yolo_tpu_torch.data.video_io import VideoWriter
    from tests.video_fixtures.make import frames

    imgs = frames(7, 49, 67, 5)
    path = tmp_path / "out.mkv"
    with VideoWriter(path, fps, (67, 49)) as vw:
        for img in imgs:
            vw.write(img)
    data = path.read_bytes()
    assert data[:4] == b"\x1a\x45\xdf\xa3" and b"matroska" in data[:64] and b"V_MPEG4/ISO/ASP" in data
    got, r = read_all(path)
    want, (cfps, total, fourcc) = cv2_read(path)
    assert sha(got) == sha(want) and len(got) == total == 7 and got[0].shape == (48, 66, 3)
    assert r.fps == cfps == (fps or 30) and r.total == total and int.from_bytes(r.fourcc, "little") == fourcc
    psnr = 10 * np.log10(255.0 ** 2 / np.mean((got[3].astype(float) - imgs[3][:48, :66]) ** 2))
    assert psnr >= 35


def test_mkv_writer_starts_a_cluster_every_five_seconds(tmp_path):
    from mga_yolo_tpu_torch.data.video_io import VideoWriter

    path = tmp_path / "long.mkv"
    img = np.full((16, 16, 3), 90, np.uint8)
    with VideoWriter(path, 10, (16, 16)) as vw:
        for i in range(120):
            vw.write(np.roll(img + (i % 7), i, 1))
    data = path.read_bytes()
    assert data.count(b"\x1f\x43\xb6\x75") == 3 and data.count(b"\xbb") >= 3  # clusters at 0, 5 and 10 s, cues
    got, r = read_all(path)
    want, (cfps, total, _) = cv2_read(path)
    assert sha(got) == sha(want) and total == r.total == 120 and cfps == r.fps == 10


def test_writer_follows_the_suffix_as_cv2_does(tmp_path):
    """``.mov`` and ``.m4v`` get cv2's ftyp brands; ``.mpg`` and ``.mpeg``
    are MPEG-PS, ``.wmv`` ASF and ``.gif`` cv2's numbered stills, as cv2
    writes them (``tests/test_torch_mpeg.py`` holds them to cv2); ``.webm``
    and a suffix cv2 refuses raise RuntimeError at the first write, as the
    JAX ``VideoSink`` does, and leave no file."""
    from mga_yolo_tpu.data.sources import VideoSink as JSink
    from mga_yolo_tpu_torch.data.sources import VideoSink

    img = np.full((48, 64, 3), 100, np.uint8)
    for suffix in (".mov", ".m4v", ".mp4", ".mkv", ".MKV", ".avi"):
        outs = []
        for sink_cls, d in ((VideoSink, "port"), (JSink, "jax")):
            (tmp_path / d).mkdir(exist_ok=True)
            sink = sink_cls(tmp_path / d / f"a{suffix}", 25)
            for _ in range(3):
                sink.write(img)
            sink.close()
            outs.append((tmp_path / d / f"a{suffix}").read_bytes())
        kind = [d[4:16] if d[4:8] == b"ftyp" else d[:4] + d[8:12] for d in outs]
        assert kind[0] == kind[1], suffix  # the same container, with the same brand
        assert cv2_read(tmp_path / "port" / f"a{suffix}")[1][:2] == (25.0, 3)
    for suffix, head in ((".mpg", b"\x00\x00\x01\xba"), (".mpeg", b"\x00\x00\x01\xba"),
                         (".wmv", b"\x30\x26\xb2\x75"), (".gif", b"GIF89a")):
        sink = VideoSink(tmp_path / f"b1{suffix}", 25)
        sink.write(img)
        sink.close()
        assert (tmp_path / f"b1{suffix}").read_bytes().startswith(head), suffix
        if suffix != ".gif":
            assert len(cv2_read(tmp_path / f"b1{suffix}")[0]) == 1, suffix
    for suffix in (".webm", ".xyz", ".ogv"):
        for sink_cls in (VideoSink, JSink):
            sink = sink_cls(tmp_path / f"c{suffix}", 25)
            with pytest.raises(RuntimeError, match=rf"cannot open video writer: .*c\{suffix}"):
                sink.write(img)
            assert not (tmp_path / f"c{suffix}").exists()


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The JAX flagship with seeded weights, the port's model with the same
    weights and a checkpoint of them (as ``tests/test_torch_predict.py``)."""
    import torch

    from mga_yolo_tpu.models.yolo import create_model as jcreate
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax

    cfg = "configs/models/yolov8_cbam.yaml"
    root = tmp_path_factory.mktemp("mkv_predict")
    jmodel, _ = jcreate(cfg, scale="n", nc=1)
    v = seeded_variables(jmodel, IMGSZ, seed=4)
    tmodel, tspec = create_model(cfg, scale="n", nc=1, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(v, tspec), strict=True)
    ckpt = root / "best.pt"
    torch.save({"ema_state_dict": tmodel.state_dict(), "train_args": {"nc": 1, "model": cfg, "model_scale": "n"},
                "meta": {"imgsz": IMGSZ, "model_yaml": cfg, "model_scale": "n", "nc": 1}}, ckpt)
    return dict(jmodel=jmodel, v=v, tmodel=tmodel, ckpt=ckpt, root=root)


def _source_dir(root: Path) -> Path:
    from mga_yolo_tpu_torch.data import image_io

    src = root / "src"
    src.mkdir(parents=True, exist_ok=True)
    for name in ("vp8.webm", "mjpg.mkv", "vp8_altref.webm"):
        shutil.copy(FIXTURES / name, src / name)
    img = cv2.GaussianBlur(np.random.default_rng(9).integers(0, 256, (48, 64, 3)).astype(np.uint8), (5, 5), 2)
    image_io.imwrite(src / "im0.png", img)
    return src


def test_iter_source_over_matroska_equals_jax(tmp_path):
    from mga_yolo_tpu.data import sources as J
    from mga_yolo_tpu_torch.data import sources as P

    src = _source_dir(tmp_path)
    assert P.list_files(src) == J.list_files(src)
    for cap in (0, 3):
        got, want = list(P.iter_source(src, max_frames=cap)), list(J.iter_source(src, max_frames=cap))
        assert [(f.path, f.index, f.is_video, f.fps, f.total) for f in got] == \
            [(f.path, f.index, f.is_video, f.fps, f.total) for f in want]
        for f, jf in zip(got, want):
            np.testing.assert_array_equal(f.img, jf.img)
    assert sum(f.is_video for f in got) == 9


def test_cli_predict_on_matroska_writes_what_the_jax_cli_writes(flagship, tmp_path, monkeypatch, capsys):
    """``cli.predict`` over a VP8 ``.webm``, an MJPEG ``.mkv``, an alt-ref
    ``.webm`` and an image writes the JAX CLI's files (a ``_pred.mp4`` per
    clip) and lines (the JAX CLI run with the port's predictor, so only
    decoding, naming and writing differ); the port's boxes on its frames
    equal the JAX predictor's on cv2's within 1e-3 px."""
    import mga_yolo_tpu.train.predictor as jax_predictor
    from mga_yolo_tpu.cli import predict as jax_cli
    from mga_yolo_tpu.data import sources as J
    from mga_yolo_tpu.train.predictor import MGAPredictor as JPredictor
    from mga_yolo_tpu.utils import compile_cache
    from mga_yolo_tpu_torch.cli import predict as cli_predict
    from mga_yolo_tpu_torch.data import sources as P
    from mga_yolo_tpu_torch.train.predictor import MGAPredictor, load_predictor

    src = _source_dir(tmp_path)
    args = ["--weights", str(flagship["ckpt"]), "--source", str(src), "--conf", "0.01", "--batch", "4"]
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    res = cli_predict.main(args + ["--out", str(port_out), "--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(jax_predictor, "load_predictor", lambda *a, **k: load_predictor(
        flagship["ckpt"], conf=0.01, device="cpu"))
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: None)
    jax_cli.main(args + ["--out", str(jax_out)])
    jax_lines = capsys.readouterr().out.splitlines()
    assert res["images"] == 1 and res["frames"] == 13 + 13 + 20
    assert sorted(p.name for p in port_out.iterdir()) == sorted(p.name for p in jax_out.iterdir())
    assert {"vp8_pred.mp4", "mjpg_pred.mp4", "vp8_altref_pred.mp4"} <= {p.name for p in port_out.iterdir()}
    assert [ln.replace(str(port_out), "OUT") for ln in port_lines] == \
        [ln.replace(str(jax_out), "OUT") for ln in jax_lines]
    for name in ("vp8_pred.mp4", "mjpg_pred.mp4", "vp8_altref_pred.mp4"):
        caps = [cv2.VideoCapture(str(d / name)) for d in (port_out, jax_out)]
        for prop in (cv2.CAP_PROP_FRAME_COUNT, cv2.CAP_PROP_FPS, cv2.CAP_PROP_FOURCC, cv2.CAP_PROP_FRAME_WIDTH,
                     cv2.CAP_PROP_FRAME_HEIGHT):
            assert caps[0].get(prop) == caps[1].get(prop), (name, prop)
    # the boxes: the port on its own frames, the JAX predictor on cv2's
    port_frames = [f.img for f in P.iter_source(src, max_frames=3) if f.is_video]
    jax_frames = [f.img for f in J.iter_source(src, max_frames=3) if f.is_video]
    got = MGAPredictor(flagship["tmodel"], imgsz=IMGSZ, conf=0.01)(port_frames)
    want = JPredictor(flagship["jmodel"], flagship["v"], imgsz=IMGSZ, conf=0.01)(jax_frames)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        assert_dets_match(g.boxes, w.boxes, rtol=0, atol=1e-3)
