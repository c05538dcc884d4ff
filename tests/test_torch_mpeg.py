"""The port's MPEG-1 / MPEG-2 path (``data/video_io.py``'s MPEG-PS demuxer and
its MPEG-1/2 tracks in AVI, MP4 and Matroska, ``native/mpeg12.cpp``), its
writer's ``.mpg`` / ``.mpeg`` (mp4v in MPEG-PS), ``.wmv`` (mp4v in ASF) and
``.gif`` (cv2's numbered stills), against ``cv2.VideoCapture`` /
``cv2.VideoWriter`` and the JAX package, on the CPU.

Reading: the committed clips of ``tests/video_fixtures`` (``python -m
tests.video_fixtures.make mpeg``: cv2's writer, and libavcodec's
mpeg1video / mpeg2video / libvpx encoders with what cv2's writer leaves off)
against cv2, live and as the SHA-256 of each frame stored in ``mpeg.json``:
every frame equal to the bit, with cv2's fps, frame count and fourcc,
the clips of odd height among them (cv2 takes swscale's scaled path
there, which ``native/yuv.cpp`` follows). The decoder's
tally shows which features the clips exercise. Cut files raise ValueError
naming the file (libavcodec conceals damage; the port refuses), flipped
bytes give a ValueError or frames, never a crash.

The path on top: ``iter_source`` over ``.mpg``, ``.mpeg`` and images equals
the JAX package's, and ``cli.predict`` writes what the JAX CLI writes, its
boxes equal to the JAX predictor's within 1e-3 px.
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
from tests.video_fixtures.make import avi_parts, frames, ps_bytes

FIXTURES = Path(__file__).resolve().parent / "video_fixtures"
META = json.loads((FIXTURES / "mpeg.json").read_text())
CLIPS = sorted(META)
# decoder features no writer here produces (ROADMAP.md section 3 lists them as untested)
UNTESTED = {"full_pel_pictures", "escapes_long", "concealment_pictures"}
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


def test_fixtures_cover_every_kind():
    assert CLIPS == sorted(["big512.mpg", "big512_m1.mpeg", "m1v_es.mpg", "m1v_intra.mpg", "m1v_naq.mpeg",
                            "m2v_422.mpg", "m2v_altscan.mpg", "m2v_bframes.mpg", "m2v_field.mpg", "m2v_odd97x63.mpg",
                            "m2v_odd97x64.mpg", "m2v_opengop.mpg", "m2v_tools.mpg", "mp4v.mpg", "mpeg2.avi",
                            "mpeg2.mkv", "mpeg2.mp4", "mpeg2.mpg", "pim1.avi", "pim1.mkv", "pim1.mp4", "pim1.mpg",
                            "vp8_lavc96x63.webm", "vp8_lavc97x63.webm"])
    assert META["m2v_odd97x63.mpg"]["shape"] == [63, 97, 3] and META["vp8_lavc96x63.webm"]["shape"] == [63, 96, 3]
    assert sum((FIXTURES / n).stat().st_size for n in CLIPS) < 400_000


@pytest.mark.parametrize("name", CLIPS)
def test_reader_equals_cv2_to_the_bit(name):
    """Every frame equal to cv2's (its SHA-256 stored, and cv2 read live),
    with cv2's fps, frame count and fourcc."""
    meta = META[name]
    got, r = read_all(FIXTURES / name)
    want, (fps, total, fourcc) = cv2_read(FIXTURES / name)
    assert sha(want) == meta["sha256"]
    assert (r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (fps, total, fourcc) == \
        (meta["fps"], meta["total"], meta["fourcc"])
    assert len(got) == meta["frames"] and list(got[0].shape) == meta["shape"]
    assert sha(got) == meta["sha256"]
    kind = {".mpg": "MPEG-PS", ".mpeg": "MPEG-PS", ".avi": "AVI", ".mp4": "MP4", ".mkv": "Matroska", ".webm": "WebM"}
    assert r.container == ("MPEG video" if name == "m1v_es.mpg" else kind[Path(name).suffix])


def test_mpeg12_tally_covers_the_decoder_features():
    """Summed over the clips, each feature of the decoder occurs (but the
    ones no writer here produces), and the clips that carry a feature are
    the ones meant to."""
    from mga_yolo_tpu_torch.native import MPEG12_TALLY

    tallies = {}
    for name in CLIPS:
        _, r = read_all(FIXTURES / name)
        if r.codec in ("mpeg1", "mpeg2"):
            tallies[name] = r.mpeg12_tally
    total = {k: sum(t[k] for t in tallies.values()) for k in MPEG12_TALLY}
    assert {k for k, v in total.items() if not v} == UNTESTED
    assert tallies["m2v_field.mpg"]["field_pred"] > 0 and tallies["m2v_field.mpg"]["field_dct"] > 0
    alt = tallies["m2v_altscan.mpg"]
    assert alt["alternate_scan_pictures"] == alt["intra_vlc_pictures"] == alt["dc_precision_10"] == 12
    assert tallies["m2v_422.mpg"]["chroma_422_pictures"] == 12 and tallies["m2v_422.mpg"]["dc_precision_9"] == 12
    tools = tallies["m2v_tools.mpg"]
    assert tools["non_linear_q_pictures"] == tools["dc_precision_11"] == 12 and tools["quant_matrix_ext"] == 12
    assert tools["loaded_intra"] > 0 and tallies["m1v_naq.mpeg"]["loaded_non_intra"] > 0
    assert tallies["m1v_naq.mpeg"]["mb_quant"] > 0
    assert tallies["m2v_opengop.mpg"]["dropped_b"] == 2 and tallies["m2v_opengop.mpg"]["open_gops"] > 0
    assert tallies["m1v_intra.mpg"]["pictures_i"] == 12 == tallies["m1v_intra.mpg"]["mpeg1_pictures"]
    assert tallies["mpeg2.mpg"]["reordered"] > 0 and tallies["pim1.mpg"]["pictures_b"] == 0


@pytest.mark.parametrize("fourcc,fps,n", [("PIM1", 30, 12), ("PIM1", 24, 13), ("PIM1", 29.97, 7), ("MPEG", 30, 7),
                                          ("MPEG", 10, 13), ("mp4v", 30, 31), ("mp4v", 29.97, 13)])
def test_ps_frame_count_and_rate_follow_cv2(tmp_path, fourcc, fps, n):
    """cv2's count of an MPEG-PS comes from ffmpeg's estimate off the
    timestamps (a half frame after the last PTS for MPEG-1, a whole one for
    MPEG-2 and MPEG-4), its rate from the sequence header or, for MPEG-4,
    from the PTS: the reader gives both for cv2's own files."""
    path = tmp_path / "c.mpg"
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (64, 48))
    for img in frames(n, 48, 64, 5):
        vw.write(img)
    vw.release()
    got, r = read_all(path)
    want, (cfps, total, fcc) = cv2_read(path)
    assert sha(got) == sha(want)
    assert (r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (cfps, total, fcc)


@pytest.mark.parametrize("encoder", ["mpeg1video", "mpeg2video", "mpeg4", "libvpx"])
@pytest.mark.parametrize("h,w", [(63, 97), (63, 96), (31, 66), (9, 21)])
def test_odd_heights_follow_swscales_scaled_path(tmp_path, encoder, h, w):
    """A 4:2:0 frame of odd height converts as cv2's swscale converts it
    off its unscaled path (bicubic chroma from the codec's siting, full
    chroma for odd widths), to the bit; colourful frames, so the filters
    show."""
    from mga_yolo_tpu_torch import native
    from tests.video_fixtures.make import lavc_encode, mkv_bytes

    rng = np.random.default_rng(h * w)
    imgs = [cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (5, 5), 1.5) for _ in range(2)]
    packets = lavc_encode(encoder, imgs, {}, pts=True)
    if encoder == "libvpx":
        path = tmp_path / "c.webm"
        path.write_bytes(mkv_bytes("V_VP8", w, h, [(d, k, int(p * 40)) for d, k, p in packets],
                                   default_duration=40000000, duration=80))
    else:
        path = tmp_path / "c.mpg"
        path.write_bytes(ps_bytes([(d, k, int(p)) for d, k, p in packets], 25))
    if encoder == "mpeg4":  # straight into the decoder: cv2 reads the bare stream
        path = tmp_path / "c.m4v"
        path.write_bytes(b"".join(d for d, _, _ in packets))
        dec = native.Mpeg4Decoder()
        got = [native.yuv_to_bgr(*g[0], False, chroma_left=True) for g in map(dec.decode, (d for d, _, _ in packets))
               if g]
    else:
        got = read_all(path)[0]
    want = cv2_read(path)[0]
    assert len(got) == len(want) == 2 and sha(got) == sha(want)


def _picture_coding_ext(es: bytes, edit) -> bytes:
    b = bytearray(es)
    i = b.find(b"\x00\x00\x01\xb5")
    while i >= 0:
        if b[i + 4] >> 4 == 8:
            edit(b, i + 4)
            break
        i = b.find(b"\x00\x00\x01\xb5", i + 4)
    return bytes(b)


def _refused(kind: str, tmp_path: Path):
    """(path, message pattern) of a file the port refuses, by kind."""
    head, chunks = avi_parts((FIXTURES / "mpeg2.avi").read_bytes())
    packets = [(c, i == 0, i) for i, c in enumerate(chunks)]
    path = tmp_path / f"{kind}.mpg"
    if kind == "audio_only":
        pes = b"\x00\x00\x01\xc0\x00\x10\x0f" + bytes(15)
        data, what = b"\x00\x00\x01\xba\x21\x00\x01\x00\x01\x80\x1b\x83" + pes * 4, "without a video stream"
    elif kind == "h264":
        data, what = ps_bytes([(b"\x00\x00\x00\x01\x67\x42\x00\x1e" + bytes(64), True, 0)], 25), r"H\.264 video"
    elif kind == "field_picture":
        first = _picture_coding_ext(chunks[0], lambda b, k: b.__setitem__(k + 2, (b[k + 2] & 0xFC) | 1))
        data, what = ps_bytes([(first, True, 0)] + packets[1:], 25), r"field pictures \(picture_structure 1\)"
    elif kind == "d_picture":
        b = bytearray(chunks[0])
        k = b.find(b"\x00\x00\x01\x00")
        b[k + 5] = (b[k + 5] & 0xC7) | (4 << 3)
        data, what = ps_bytes([(bytes(b), True, 0)], 25), "D-pictures"
    elif kind == "chroma444":
        b = bytearray(chunks[0])
        k = b.find(b"\x00\x00\x01\xb5")
        b[k + 5] |= 0x06
        data, what = ps_bytes([(bytes(b), True, 0)], 25), "4:4:4"
    elif kind == "scalable":
        b = bytearray(chunks[0])
        k = b.find(b"\x00\x00\x01\xb8")
        b[k:k] = b"\x00\x00\x01\xb5\x50\x00"
        data, what = ps_bytes([(bytes(b), True, 0)], 25), "sequence scalable extension"
    else:  # ASF / WMV reads now (tests/test_torch_wmv.py): a header cut at 64 bytes raises naming ASF
        path = tmp_path / "clip.wmv"
        data, what = b"\x30\x26\xb2\x75" + bytes(60), r"corrupt or truncated ASF file"
    path.write_bytes(data)
    return path, what


@pytest.mark.parametrize("kind", ["audio_only", "h264", "field_picture", "d_picture", "chroma444", "scalable", "wmv"])
def test_what_the_port_does_not_read_raises_naming_it(tmp_path, kind):
    path, what = _refused(kind, tmp_path)
    with pytest.raises(ValueError, match=rf"^{path}: .*{what}"):
        read_all(path)


@pytest.mark.parametrize("name", ["m2v_bframes.mpg", "m1v_naq.mpeg", "mpeg2.avi", "m2v_422.mpg"])
def test_cut_files_raise_value_errors(tmp_path, name):
    """A file cut anywhere before its last video byte (40 seeded places)
    raises ValueError naming it: cv2 would give the frames before the cut.
    (What follows, a program stream's padding or an AVI's index, may go.)"""
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    data = (FIXTURES / name).read_bytes()
    with VideoReader(FIXTURES / name) as r:
        end = sum(r.samples[-1])
    path = tmp_path / name
    for k in sorted(np.random.default_rng(3).choice(end, 40, replace=False)):
        path.write_bytes(data[:k])
        with pytest.raises(ValueError, match=rf"^{path}"):
            read_all(path)


@pytest.mark.parametrize("name", ["m2v_field.mpg", "m2v_tools.mpg", "m1v_intra.mpg", "pim1.mkv"])
def test_flipped_bytes_give_a_value_error_or_frames(tmp_path, name):
    """A bit flipped at 150 seeded places: a ValueError naming the file, or
    frames of the clip's size; never a crash (the C++ also ran this under
    ASan and UBSan)."""
    data = (FIXTURES / name).read_bytes()
    rng = np.random.default_rng(4)
    path = tmp_path / name
    for k in rng.choice(len(data), 150, replace=False):
        flipped = bytearray(data)
        flipped[k] ^= 1 << int(rng.integers(8))
        path.write_bytes(bytes(flipped))
        try:
            for img in read_all(path)[0]:
                assert img.shape == tuple(META[name]["shape"])
        except ValueError as e:
            assert str(e).startswith(str(path)), e


def test_cut_pictures_raise_value_errors():
    """Each picture of an MPEG-1 and an MPEG-2 stream cut to 10 % ... 90 %
    of its bytes raises ValueError in the decoder (no concealment)."""
    from mga_yolo_tpu_torch.native import Mpeg12Decoder

    for name in ("pim1.avi", "mpeg2.avi"):
        _, chunks = avi_parts((FIXTURES / name).read_bytes())
        for i in range(1, len(chunks)):
            for cut in (0.1, 0.5, 0.9):
                dec = Mpeg12Decoder()
                for c in chunks[:i]:
                    dec.decode(c)
                with pytest.raises(ValueError, match="MPEG video"):
                    dec.decode(chunks[i][:max(8, int(len(chunks[i]) * cut))])
                dec.close()


def test_mpeg12_decoder_states():
    from mga_yolo_tpu_torch.native import Mpeg12Decoder

    _, chunks = avi_parts((FIXTURES / "mpeg2.avi").read_bytes())
    seq = chunks[0][:chunks[0].find(b"\x00\x00\x01\x00")]
    dec = Mpeg12Decoder()
    assert dec.decode(seq) == [] and dec.flush() == []
    shown = [k for c in chunks for _, k in dec.decode(c)] + [k for _, k in dec.flush()]
    assert len(shown) == len(chunks) and shown[0] == 1 and 3 in shown and dec.flush() == []
    dec.close()
    with pytest.raises(ValueError, match="closed"):
        dec.decode(chunks[0])
    with pytest.raises(ValueError, match="no start code"):
        Mpeg12Decoder().decode(b"\xff" * 16)


@pytest.mark.parametrize("suffix,fps", [(".mpg", 25), (".mpeg", 29.97), (".mpg", 10), (".mpg", 30)])
def test_ps_writer_round_trips_through_cv2(tmp_path, suffix, fps):
    """``.mpg`` / ``.mpeg`` is mp4v in MPEG-PS packs of 2048 bytes: cv2 reads
    it back equal to the port's reader, every frame stamped (cv2's own file
    can lose its last frame's PTS to a shared packet and read one short)."""
    from mga_yolo_tpu_torch.data.video_io import VideoWriter

    imgs = frames(14, 48, 64, 6)
    path = tmp_path / f"a{suffix}"
    with VideoWriter(path, fps, (64, 48)) as vw:
        for img in imgs:
            vw.write(img)
    data = path.read_bytes()
    assert data[:4] == b"\x00\x00\x01\xba" and len(data) % 2048 == 0 and data.count(b"\x00\x00\x01\xbb") == 1
    got, r = read_all(path)
    want, (cfps, total, fcc) = cv2_read(path)
    assert sha(got) == sha(want) and len(got) == total == r.total == 14
    assert (r.fps, r.fourcc) == (cfps, b"FMP4") and struct.pack("<I", fcc) == b"FMP4"
    psnr = cv2.PSNR(np.stack(got), np.stack(imgs))
    assert psnr >= 35


@pytest.mark.parametrize("fps", [25, 30])
def test_wmv_writer_is_read_by_cv2(tmp_path, fps):
    """``.wmv`` is mp4v in ASF (3200-byte packets, a simple index): cv2 reads
    it back equal to the port's reader of the same frames in ``.mpg``, with
    the fps and count cv2 gives its own ``.wmv`` of them; the port's reader
    reads it back as cv2 does (frames, fps and count)."""
    from mga_yolo_tpu_torch.data.video_io import VideoWriter

    imgs = frames(12, 48, 64, 7)
    for suffix in (".wmv", ".mpg"):
        with VideoWriter(tmp_path / f"a{suffix}", fps, (64, 48)) as vw:
            for img in imgs:
                vw.write(img)
    data = (tmp_path / "a.wmv").read_bytes()
    assert data[:4] == b"\x30\x26\xb2\x75" and (len(data) - data.find(b"\x36\x26\xb2\x75") - 50 - 86) % 3200 == 0
    want, meta = cv2_read(tmp_path / "a.wmv")
    assert sha(want) == sha(read_all(tmp_path / "a.mpg")[0])
    vw = cv2.VideoWriter(str(tmp_path / "c.wmv"), cv2.VideoWriter_fourcc(*"mp4v"), fps, (64, 48))
    for img in imgs:
        vw.write(img)
    vw.release()
    assert meta == cv2_read(tmp_path / "c.wmv")[1]
    got, r = read_all(tmp_path / "a.wmv")
    assert sha(got) == sha(want) and (r.fps, r.total) == meta[:2]


def test_gif_writer_writes_cv2s_numbered_stills(tmp_path):
    """``.gif`` goes to cv2's images backend: frame i under the name whose
    first run of digits counts up from its value (zero padding kept), each
    a still GIF with cv2.imwrite's bytes; a name without a digit raises
    RuntimeError as the JAX ``VideoSink`` does."""
    from mga_yolo_tpu.data.sources import VideoSink as JSink
    from mga_yolo_tpu_torch.data.sources import VideoSink

    imgs = frames(4, 63, 97, 8)
    for name in ("clip7.gif", "out_03.gif", "a1b2.gif", "x99.gif", "run09.GIF"):
        for sink_cls, d in ((VideoSink, "port"), (JSink, "jax")):
            (tmp_path / d).mkdir(exist_ok=True)
            sink = sink_cls(tmp_path / d / name, 25)
            for img in imgs:
                sink.write(img)
            sink.close()
    port, jax = sorted((tmp_path / "port").iterdir()), sorted((tmp_path / "jax").iterdir())
    assert [p.name for p in port] == [p.name for p in jax] and len(port) == 20
    assert {"clip10.gif", "out_06.gif", "a4b2.gif", "x102.gif", "run12.GIF"} <= {p.name for p in port}
    for p, j in zip(port, jax):
        assert p.read_bytes() == j.read_bytes(), p.name
    for sink_cls in (VideoSink, JSink):
        sink = sink_cls(tmp_path / "run2" / "g.gif", 25)
        (tmp_path / "run2").mkdir(exist_ok=True)
        with pytest.raises(RuntimeError, match=r"cannot open video writer: .*g\.gif"):
            sink.write(imgs[0])
        assert not list((tmp_path / "run2").iterdir())


def test_gif_encoder_equals_cv2_imwrite(tmp_path):
    from mga_yolo_tpu_torch import native

    rng = np.random.default_rng(10)
    for k in range(6):
        h, w = (int(v) for v in rng.integers(1, 150, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if k % 2:
            img = cv2.GaussianBlur(img, (9, 9), 3)
        cv2.imwrite(str(tmp_path / "c.gif"), img)
        assert native.gif_encode(img) == (tmp_path / "c.gif").read_bytes()


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The JAX flagship with seeded weights, the port's model with the same
    weights and a checkpoint of them (as ``tests/test_torch_predict.py``)."""
    import torch

    from mga_yolo_tpu.models.yolo import create_model as jcreate
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax

    cfg = "configs/models/yolov8_cbam.yaml"
    root = tmp_path_factory.mktemp("mpeg_predict")
    jmodel, _ = jcreate(cfg, scale="n", nc=1)
    v = seeded_variables(jmodel, IMGSZ, seed=5)
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
    for name in ("mpeg2.mpg", "m1v_naq.mpeg", "mp4v.mpg"):
        shutil.copy(FIXTURES / name, src / name)
    img = cv2.GaussianBlur(np.random.default_rng(11).integers(0, 256, (48, 64, 3)).astype(np.uint8), (5, 5), 2)
    image_io.imwrite(src / "im0.png", img)
    return src


def test_iter_source_over_mpeg_equals_jax(tmp_path):
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


def test_cli_predict_on_mpeg_writes_what_the_jax_cli_writes(flagship, tmp_path, monkeypatch, capsys):
    """``cli.predict`` over an MPEG-2 ``.mpg`` with B-pictures, an MPEG-1
    ``.mpeg``, cv2's mp4v ``.mpg`` and an image writes the JAX CLI's files
    (a ``_pred.mp4`` per clip) and lines (the JAX CLI run with the port's
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
    args = ["--weights", str(flagship["ckpt"]), "--source", str(src), "--conf", "0.01", "--batch", "4"]
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    res = cli_predict.main(args + ["--out", str(port_out), "--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(jax_predictor, "load_predictor", lambda *a, **k: load_predictor(
        flagship["ckpt"], conf=0.01, device="cpu"))
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: None)
    jax_cli.main(args + ["--out", str(jax_out)])
    jax_lines = capsys.readouterr().out.splitlines()
    assert res["images"] == 1 and res["frames"] == 13 + 12 + 13
    assert sorted(p.name for p in port_out.iterdir()) == sorted(p.name for p in jax_out.iterdir())
    assert {"mpeg2_pred.mp4", "m1v_naq_pred.mp4", "mp4v_pred.mp4"} <= {p.name for p in port_out.iterdir()}
    assert [ln.replace(str(port_out), "OUT") for ln in port_lines] == \
        [ln.replace(str(jax_out), "OUT") for ln in jax_lines]
    port_frames = [f.img for f in P.iter_source(src, max_frames=3) if f.is_video]
    jax_frames = [f.img for f in J.iter_source(src, max_frames=3) if f.is_video]
    got = MGAPredictor(flagship["tmodel"], imgsz=IMGSZ, conf=0.01)(port_frames)
    want = JPredictor(flagship["jmodel"], flagship["v"], imgsz=IMGSZ, conf=0.01)(jax_frames)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        assert_dets_match(g.boxes, w.boxes, rtol=0, atol=1e-3)
