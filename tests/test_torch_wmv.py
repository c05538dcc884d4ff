"""The port's ASF container and MS-MPEG-4 family (``data/video_io.py``'s ASF
demuxer, ``native/msmpeg4.cpp`` behind ``native.MsMpeg4Decoder``: MS MPEG-4
v2 and v3, WMV1, WMV2) against the JAX package's reader,
``cv2.VideoCapture``, on the CPU.

The committed clips (``python -m tests.video_fixtures.make wmv``) are cv2's
writer's WMV1, WMV2, MP42 and MP43 in ``.wmv``, ``.avi`` and ``.mkv``, its
mp4v in ``.wmv`` at 12.5, 7 and 29.97 fps and MJPG in ``.wmv``, two 512 x 512
clips (WMV2 in ASF, each frame over several packets; MP43 in AVI), XVID,
MPEG-1 and MPEG-2 in ``.wmv``, and
libavcodec's msmpeg4v2, msmpeg4, wmv1 and wmv2 encoders (inside cv2's wheel,
through ctypes) at fixed quantisers in AVI, for the tools cv2's writer leaves
off (WMV2's loop filter among them). Every frame equals cv2's to the bit (tolerance 0; the SHA-256 stored in
``wmv.json``, and cv2 read live) with cv2's fps, frame count and fourcc.

What no writer here produces is refused by name: AC prediction, DC and
motion-vector table 0, more than one slice, per-macroblock coefficient
tables, WMV1's inter-intra directions 1-3, WMV2's skip maps, mspel, ABT,
J-pictures and top-left prediction, MS MPEG-4 v1, VC-1 and the other
codecs cv2 puts in ASF that the port does not decode, and ASF's compressed
payloads, extended stream properties, encryption and broadcast files. The
tool refusals are found by flipping one bit of a clip (the first flip, in
order, whose ValueError names the tool). Cut and flipped files raise
ValueError naming the file or give frames. ``iter_source`` and
``cli.predict`` over ``.wmv`` / ``.avi`` clips of the family equal the JAX
package's, boxes within ``tests/test_torch_predict.py``'s 1e-3 px.
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
from tests.video_fixtures.make import avi_parts, frames, pack_avi

FIXTURES = Path(__file__).resolve().parent / "video_fixtures"
META = json.loads((FIXTURES / "wmv.json").read_text())
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


def test_fixtures_cover_every_kind():
    for codec in ("wmv1", "wmv2", "mp42", "mp43"):
        assert {f"wmv_{codec}.{ext}" for ext in ("wmv", "avi", "mkv")} <= set(CLIPS)
    assert {"wmv_mp4v_12.5.wmv", "wmv_mp4v_7.wmv", "wmv_mp4v_29.97.wmv", "wmv_mjpg.wmv", "wmv_xvid.wmv", "wmv_pim1.wmv",
            "wmv_mpg2.wmv"} <= set(CLIPS)
    # ffmpeg's rates over millisecond times: 29.97 -> 359/12, mp4v at 12.5 -> 25 (a count of 16 for 8 frames)
    assert META["wmv_wmv1.wmv"]["fps"] == META["wmv_mp4v_29.97.wmv"]["fps"] == 359 / 12
    assert (META["wmv_mp4v_12.5.wmv"]["fps"], META["wmv_mp4v_12.5.wmv"]["total"],
            META["wmv_mp4v_12.5.wmv"]["frames"]) == (25.0, 16, 8)
    assert META["wmv_mp4v_7.wmv"]["fps"] == 85 / 12 and META["wmv_mp42.wmv"]["fps"] == 7.0
    assert META["wmv_mp43.wmv"]["fps"] == 12.5
    # MPEG-1 at 25: ffmpeg trusts its decoder's rate, counted in fields (50), and cv2 counts 26 for 12 frames
    assert (META["wmv_pim1.wmv"]["fps"], META["wmv_pim1.wmv"]["total"]) == (50.0, 26)
    assert META["wmv_big512.wmv"]["shape"] == META["wmv_big512_mp43.avi"]["shape"] == [512, 512, 3]
    assert META["wmv_lavc_mp43_97x63.avi"]["shape"] == [63, 97, 3]
    assert all(48 <= META[n]["shape"][0] <= 66 for n in CLIPS if "512" not in n and "97x63" not in n)
    assert sum((FIXTURES / n).stat().st_size for n in CLIPS) < 450_000


@pytest.mark.parametrize("name", CLIPS)
def test_reader_equals_cv2_to_the_bit(name):
    """Every frame equal to cv2's (its SHA-256 stored, and cv2 read live),
    with cv2's fps, frame count and fourcc."""
    meta = META[name]
    got, r = read_all(FIXTURES / name)
    want, (fps, total, fourcc) = cv2_read(FIXTURES / name)
    assert sha(got) == meta["sha256"] == sha(want)
    assert (r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (fps, total, fourcc) == \
        (meta["fps"], meta["total"], meta["fourcc"])
    assert list(got[0].shape) == meta["shape"] and len(got) == meta["frames"]


def test_big_asf_frames_span_packets():
    """The 512 px WMV2 clip's frames lie in fragments over several 3200-byte
    packets (single- and multiple-payload ones), put together by object."""
    _, r = read_all(FIXTURES / "wmv_big512.wmv")
    assert all(isinstance(s[0], tuple) and len(s) > 2 for s in r.samples)
    assert r.msmpeg4_tally["pictures_i"] == 1 and r.msmpeg4_tally["pictures_p"] == 7


# per fixture, the tools its decoding must have counted
TOOLS = {
    "wmv_lavc_mp43_q3.avi": ("escapes_1", "escapes_2", "escapes_3", "blocks_table_1", "blocks_table_4",
                             "mb_intra_in_p", "no_rounding_pictures"),
    "wmv_lavc_mp43_q24.avi": ("blocks_table_3", "mv_escapes"),
    "wmv_lavc_wmv1_q3.avi": ("dc_escapes", "inter_intra_mbs", "esc3_lengths_low_q", "mb_skipped"),
    "wmv_lavc_wmv1_q12.avi": ("esc3_lengths_high_q", "inter_intra_mbs"),
    "wmv_lavc_wmv2_q12.avi": ("cbp_table_1", "blocks_table_0", "blocks_table_3"),
    "wmv_lavc_wmv2_q24.avi": ("cbp_table_2", "mv_escapes"),
    "wmv_lavc_wmv2_loop.avi": ("loop_filter_pictures", "esc3_lengths_high_q"),
    "wmv_lavc_mp42_q24.avi": ("mb_skipped", "blocks_table_2", "blocks_table_5"),
    "wmv_wmv2.wmv": ("cbp_table_0", "esc3_lengths_low_q"),
    "wmv_big512.wmv": ("mv_escapes",),
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tally_counts_each_tool(name):
    _, r = read_all(FIXTURES / name)
    missing = [k for k in TOOLS[name] if not r.msmpeg4_tally[k]]
    assert not missing, (name, missing, r.msmpeg4_tally)


def test_every_counted_tool_occurs_in_some_fixture():
    """Each thing the decoder counts (every tool it decodes) is used by at
    least one committed clip; what none uses is refused instead."""
    from mga_yolo_tpu_torch import native

    total = dict.fromkeys(native.MSMPEG4_TALLY, 0)
    for name in CLIPS:
        _, r = read_all(FIXTURES / name)
        for k, v in getattr(r, "msmpeg4_tally", {}).items():
            total[k] += v
    assert all(total.values()), [k for k, v in total.items() if not v]


@pytest.mark.parametrize("fps", [25, 12.5, 7])
def test_port_wmv_writer_reads_back_equal_to_cv2(tmp_path, fps):
    """The port's own ``.wmv`` (mp4v in ASF) reads back in the port equal to
    cv2's reading of the same file: frames, fps and count."""
    from mga_yolo_tpu_torch.data.video_io import VideoWriter

    path = tmp_path / "a.wmv"
    with VideoWriter(path, fps, (64, 48)) as vw:
        for img in frames(12, 48, 64, 17):
            vw.write(img)
    got, r = read_all(path)
    want, (cfps, total, fourcc) = cv2_read(path)
    assert len(got) == 12 and sha(got) == sha(want)
    assert (r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (cfps, total, fourcc)


@pytest.mark.parametrize("base, tags", [
    ("wmv_mp43.avi", (b"DIV3", b"MPG3", b"DIV4", b"DIV5", b"DIV6", b"DVX3", b"AP41", b"COL1", b"mp43", b"div3")),
    ("wmv_mp42.avi", (b"DIV2", b"mp42")), ("wmv_wmv1.avi", (b"wmv1",)), ("wmv_wmv2.avi", (b"wmv2",))])
def test_riff_tags_of_the_family_read_as_their_version(tmp_path, base, tags):
    """libavformat's RIFF tags of each version (in either case) read as cv2
    reads them: the same frames, and the version's own fourcc."""
    data = (FIXTURES / base).read_bytes()
    own = data[data.find(b"strf") + 24:data.find(b"strf") + 28]
    for tag in tags:
        path = tmp_path / f"{tag.decode()}.avi"
        path.write_bytes(data.replace(own, tag))
        got, r = read_all(path)
        want, (fps, total, fourcc) = cv2_read(path)
        assert sha(got) == sha(want) == META[base]["sha256"]
        assert int.from_bytes(r.fourcc, "little") == fourcc == META[base]["fourcc"]


def _flip(data: bytes, bit: int) -> bytes:
    out = bytearray(data)
    out[bit >> 3] ^= 0x80 >> (bit & 7)
    return bytes(out)


def _refused_by_flip(tmp_path, base, chunk, what, extradata=False, limit=600):
    """The first bit, in order, of the chunk-th frame (or of the WMV2
    header in the container, ``extradata``) of an AVI clip whose flip makes
    the decoder refuse ``what``; the clip so flipped."""
    from mga_yolo_tpu_torch import native

    data = (FIXTURES / base).read_bytes()
    head, chunks = avi_parts(data)
    s = head.find(b"strf") + 8
    tag, extra = head[s + 16:s + 20], head[s + 40:s + struct.unpack("<I", head[s:s + 4])[0]]
    w, h = struct.unpack("<ii", head[s + 4:s + 12])
    for bit in range(min(limit, 8 * (len(extra) if extradata else len(chunks[chunk])))):
        x, cs = (_flip(extra, bit), chunks) if extradata else (extra, chunks[:chunk] + [_flip(chunks[chunk], bit)])
        try:
            dec = native.MsMpeg4Decoder(tag, x, (w, h))
            for c in cs[:chunk + 1]:
                dec.decode(c)
        except ValueError as e:
            if what in str(e):
                path = tmp_path / f"flip{bit}.avi"
                path.write_bytes(pack_avi(head.replace(extra, x) if extradata else head, cs))
                return path
    raise AssertionError(f"no flip of {base} gives {what!r}")


@pytest.mark.parametrize("base, chunk, what, extradata", [
    ("wmv_mp42.avi", 0, "AC prediction", False), ("wmv_mp43.avi", 0, "AC prediction", False),
    ("wmv_wmv1.avi", 0, "AC prediction", False), ("wmv_wmv2.avi", 0, "AC prediction", False),
    ("wmv_mp43.avi", 0, "DC table 0", False), ("wmv_wmv2.avi", 1, "DC table 0", False),
    ("wmv_mp43.avi", 1, "motion vector table 0", False), ("wmv_wmv1.avi", 1, "motion vector table 0", False),
    ("wmv_wmv2.avi", 1, "motion vector table 0", False), ("wmv_mp43.avi", 0, "slices a picture", False),
    ("wmv_wmv1.avi", 0, "slices a picture", False), ("wmv_mp42.avi", 0, "slices a picture", False),
    ("wmv_lavc_wmv1_q3.avi", 0, "per-macroblock coefficient tables", False),
    ("wmv_wmv2.avi", 0, "per-macroblock coefficient tables", False),
    ("wmv_lavc_wmv1_q3.avi", 3, "inter-intra prediction in direction", False),
    ("wmv_wmv2.avi", 0, "J-pictures (IntraX8)", False), ("wmv_wmv2.avi", 1, "skipped-macroblock maps", False),
    ("wmv_wmv2.avi", 1, "quarter-sample (mspel)", False), ("wmv_wmv2.avi", 1, "ABT", False),
    ("wmv_wmv2.avi", 0, "top-left motion vector prediction", True),
    ("wmv_wmv2.avi", 0, "slices a picture", True)])
def test_each_refused_tool_raises_naming_it(tmp_path, base, chunk, what, extradata):
    """A tool no writer here produces, switched on by one flipped bit of a
    clip: ValueError naming the file, the container, the version and the
    tool, from the frame that uses it (or, for WMV2's header, before any)."""
    from mga_yolo_tpu_torch import native

    path = _refused_by_flip(tmp_path, base, chunk, what, extradata)
    version = native.MSMPEG4_NAMES[native.MSMPEG4_VERSIONS[META[base]["fourcc"].to_bytes(4, "little").upper()]]
    where = "" if extradata else f", frame {chunk}"
    with pytest.raises(ValueError, match=rf"^{path}: AVI with {version} video{where}: .*{re.escape(what)}"):
        read_all(path)


def _asf_refusal(data: bytes, kind: str) -> tuple[bytes, str]:
    from mga_yolo_tpu_torch.data.video_io import ASF_GUID

    fp = data.find(ASF_GUID["file"]) + 24
    if kind == "broadcast":
        return data[:fp + 64] + bytes([data[fp + 64] | 1]) + data[fp + 65:], r"a broadcast \(live\) stream"
    if kind == "varying_packets":
        return data[:fp + 68] + struct.pack("<I", 100) + data[fp + 72:], "packets of varying size"
    if kind in ("ext_stream", "encryption"):  # an object put at the end of the header
        size = struct.unpack("<Q", data[16:24])[0]
        if kind == "ext_stream":
            inner = ASF_GUID["ext_stream"] + struct.pack("<Q", 24 + 64) + bytes(64)
            obj = ASF_GUID["extension"] + struct.pack("<Q", 46 + len(inner)) + bytes(18) + \
                struct.pack("<I", len(inner)) + inner
            what = r"Extended Stream Properties"
        else:
            obj, what = ASF_GUID["encryption"] + struct.pack("<Q", 24 + 16) + bytes(16), "content encryption"
        head = data[:16] + struct.pack("<QI", size + len(obj), struct.unpack("<I", data[24:28])[0] + 1) + \
            data[28:size] + obj
        out = head + data[size:]
        return out[:fp + 16] + struct.pack("<Q", len(out)) + out[fp + 24:], what
    # compressed payloads: the first payload's replicated data length set to 1 (ffmpeg's muxer's layout: error
    # correction data, the flags, a padding length WORD or none, send time and duration, then the payloads)
    p = struct.unpack("<Q", data[16:24])[0] + 50
    flags = data[p + 3]
    p += 5 + (2 if flags & 0x18 else 0) + 6 + (flags & 1)
    p += 1 + 1 + 4  # stream, object number, offset
    return data[:p] + b"\x01" + data[p + 1:], "compressed payloads"


@pytest.mark.parametrize("kind", ["broadcast", "varying_packets", "ext_stream", "encryption", "compressed"])
def test_asf_forms_ffmpegs_muxer_does_not_write_raise_naming_them(tmp_path, kind):
    data, what = _asf_refusal((FIXTURES / "wmv_wmv2.wmv").read_bytes(), kind)
    path = tmp_path / "form.wmv"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=rf"^{path}: ASF with {what}"):
        read_all(path)


@pytest.mark.parametrize("fourcc, what", [("FFV1", "FFV1"), ("HFYU", "HuffYUV"), ("FLV1", "FLV1"),
                                          ("VP90", "VP9"), ("I420", "I420")])
def test_codecs_cv2_puts_in_asf_that_the_port_does_not_decode_raise_naming_them(tmp_path, fourcc, what):
    """FFV1 and HuffYUV, once refused, now read as cv2 reads them
    (``tests/test_torch_lossless.py`` holds the rest); the others raise."""
    path = tmp_path / f"{fourcc}.wmv"
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25, (64, 48))
    if not vw.isOpened():
        pytest.fail(f"cv2 writes no {fourcc} into .wmv")
    for img in frames(4, 48, 64, 3):
        vw.write(img)
    vw.release()
    if fourcc in ("FFV1", "HFYU"):
        got, want = read_all(path)[0], cv2_read(path)[0]
        assert len(got) == len(want) == 4 and all((g == w).all() for g, w in zip(got, want))
        return
    with pytest.raises(ValueError, match=rf"^{path}: ASF with .*{what}.* video \('{fourcc}'\) is not supported"):
        read_all(path)


@pytest.mark.parametrize("tag, what", [(b"MP41", "MS MPEG-4 v1"), (b"MPG4", "MS MPEG-4 v1"),
                                       (b"WMV3", r"VC-1 / WMV9"), (b"WVC1", r"VC-1 / WMV9")])
def test_codecs_of_the_family_the_port_does_not_decode_raise_naming_them(tmp_path, tag, what):
    data = (FIXTURES / "wmv_mp43.avi").read_bytes()
    path = tmp_path / "other.avi"
    path.write_bytes(data.replace(b"MP43", tag))
    with pytest.raises(ValueError, match=rf"^{path}: AVI with {what} video"):
        read_all(path)


def test_cut_asf_header_raises_naming_asf(tmp_path):
    path = tmp_path / "clip.wmv"
    path.write_bytes(b"\x30\x26\xb2\x75" + bytes(60))
    with pytest.raises(ValueError, match=rf"^{path}: corrupt or truncated ASF file"):
        read_all(path)


@pytest.mark.parametrize("name", ["wmv_wmv2.wmv", "wmv_mp43.avi", "wmv_lavc_wmv1_q3.avi", "wmv_mp42.mkv",
                                  "wmv_lavc_mp43_97x63.avi"])
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


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The JAX flagship with seeded weights, the port's model with the same
    weights and a checkpoint of them (as ``tests/test_torch_predict.py``)."""
    import torch

    from mga_yolo_tpu.models.yolo import create_model as jcreate
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax

    cfg = "configs/models/yolov8_cbam.yaml"
    root = tmp_path_factory.mktemp("wmv_predict")
    jmodel, _ = jcreate(cfg, scale="n", nc=1)
    v = seeded_variables(jmodel, IMGSZ, seed=4)
    tmodel, tspec = create_model(cfg, scale="n", nc=1, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(v, tspec), strict=True)
    ckpt = root / "best.pt"
    torch.save({"ema_state_dict": tmodel.state_dict(), "train_args": {"nc": 1, "model": cfg, "model_scale": "n"},
                "meta": {"imgsz": IMGSZ, "model_yaml": cfg, "model_scale": "n", "nc": 1}}, ckpt)
    return dict(jmodel=jmodel, v=v, tmodel=tmodel, ckpt=ckpt, root=root)


def _source_dir(root: Path) -> Path:
    src = root / "src"
    src.mkdir(parents=True, exist_ok=True)
    for name in ("wmv_wmv2.wmv", "wmv_mp43.avi", "wmv_mp4v_7.wmv", "wmv_wmv1.mkv"):
        shutil.copy(FIXTURES / name, src / name)
    return src


def test_iter_source_over_wmv_clips_equals_jax(tmp_path):
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
    assert sum(f.is_video for f in got) == 12


def test_cli_predict_on_wmv_clips_writes_what_the_jax_cli_writes(flagship, tmp_path, monkeypatch, capsys):
    """``cli.predict`` over WMV2 and mp4v in ASF, MP43 in AVI and WMV1 in
    Matroska writes the JAX CLI's files and lines (the JAX CLI run with the
    port's predictor, so only decoding, naming and writing differ); the
    port's boxes on its frames equal the JAX predictor's on cv2's within
    1e-3 px."""
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
    assert res["frames"] == 4 * 5
    assert sorted(p.name for p in port_out.iterdir()) == sorted(p.name for p in jax_out.iterdir())
    assert [ln.replace(str(port_out), "OUT") for ln in port_lines] == \
        [ln.replace(str(jax_out), "OUT") for ln in jax_lines]
    port_frames = [f.img for f in P.iter_source(src, max_frames=3) if f.is_video]
    jax_frames = [f.img for f in J.iter_source(src, max_frames=3) if f.is_video]
    got = MGAPredictor(flagship["tmodel"], imgsz=IMGSZ, conf=0.01)(port_frames)
    want = JPredictor(flagship["jmodel"], flagship["v"], imgsz=IMGSZ, conf=0.01)(jax_frames)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        assert_dets_match(g.boxes, w.boxes, rtol=0, atol=1e-3)
