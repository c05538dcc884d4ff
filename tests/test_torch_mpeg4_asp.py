"""The port's MPEG-4 Part 2 Advanced Simple profile path (``native/mpeg4.cpp``
behind ``native.Mpeg4Decoder``, ``native/xvid_idct.h``, ``data/video_io.py``)
against the JAX package's reader, ``cv2.VideoCapture``, on the CPU.

The committed clips (``python -m tests.video_fixtures.make asp``: libavcodec's
mpeg4 encoder inside cv2's wheel, through ctypes, over a moving synthetic
angiogram) hold B-VOPs in AVI, MP4 (composition offsets and an edit list),
Matroska and MPEG-PS, DivX's packed bitstream, MPEG quantisation with the
default and loaded matrices, quarter-sample motion, data partitioning,
interlacing and the alternate scan, a bare ``.m4v`` stream, a 97x63 clip and
the encoder identities that switch libavcodec to the XviD IDCT and its bug
workarounds. Every frame equals cv2's to the bit (tolerance 0; the SHA-256
stored in ``asp.json``, and cv2 read live) with cv2's fps, frame count and
fourcc; the interlaced clips, whose frames cv2 cannot convert (it hands on a
stale buffer), equal libavcodec's Y, U and V planes instead.

What the port refuses (GMC / S-VOPs, RVLC, OBMC, shapes, not_8_bit, NEWPRED,
reduced resolution, scalability, complexity estimation, a packed chunk of
three VOPs) raises ValueError naming the file, container, codec and tool;
cut and flipped files raise ValueError or give frames. ``iter_source`` and
``cli.predict`` over ASP clips equal the JAX package's, boxes within
``tests/test_torch_predict.py``'s 1e-3 px.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest

from tests._torch_port import assert_dets_match, few_torch_threads, seeded_variables  # noqa: F401
from tests.video_fixtures.make import (ASP_XVID, asp_rewrites, avi_parts, lavc_planes, pack_avi, plane_digests,
                                       user_data)

FIXTURES = Path(__file__).resolve().parent / "video_fixtures"
META = json.loads((FIXTURES / "asp.json").read_text())
CLIPS = sorted(n for n in META if (FIXTURES / n).exists())
CV2_CLIPS = [n for n in CLIPS if "sha256" in META[n]]
PLANE_CLIPS = [n for n in CLIPS if "planes_sha256" in META[n]]
REWRITES = sorted(n for n in META if n not in CLIPS)
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
    assert CLIPS == sorted(["asp_altscan.avi", "asp_bf1.avi", "asp_bf1.mkv", "asp_bf1.mp4", "asp_bf1.mpg",
                            "asp_bf2.avi", "asp_bf2.mkv", "asp_bf2.mp4", "asp_bf2.mpg", "asp_bf2_trim.mp4",
                            "asp_divx.avi", "asp_dp.avi", "asp_es.m4v", "asp_ilace.avi", "asp_ilace_qpel.avi",
                            "asp_mpegquant.avi", "asp_mpegquant_loaded.avi", "asp_odd97x63.avi", "asp_packed.avi",
                            "asp_qpel.avi", "asp_qpel_bf.avi", "asp_xvid.avi", "asp_xvid_fourcc.avi",
                            "big512_asp.avi"])
    assert REWRITES == sorted(f"{base}_{kind}.avi" for base in ("lavc_tools", "xvid") for kind in ASP_XVID)
    assert PLANE_CLIPS == ["asp_altscan.avi", "asp_ilace.avi", "asp_ilace_qpel.avi"]
    assert META["big512_asp.avi"]["shape"] == [512, 512, 3] and len(META["big512_asp.avi"]["sha256"]) == 16
    assert META["asp_odd97x63.avi"]["shape"] == [63, 97, 3]
    assert META["asp_bf2_trim.mp4"]["frames"] == META["asp_bf2_trim.mp4"]["total"] - 2  # the edit list trims 2
    assert META["asp_es.m4v"]["total"] < 0  # cv2's count for a stream of unknown duration
    assert sum((FIXTURES / n).stat().st_size for n in CLIPS) < 400_000


@pytest.mark.parametrize("name", CV2_CLIPS)
def test_reader_equals_cv2_to_the_bit(name):
    """Every frame equal to cv2's (its SHA-256 stored, and cv2 read live),
    with cv2's fps, frame count and fourcc."""
    meta = META[name]
    frames, r = read_all(FIXTURES / name)
    want, (fps, total, fourcc) = cv2_read(FIXTURES / name)
    assert sha(frames) == meta["sha256"] == sha(want)
    assert (r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (fps, total, fourcc) == \
        (meta["fps"], meta["total"], meta["fourcc"])
    assert list(frames[0].shape) == meta["shape"] and len(frames) == meta["frames"]


@pytest.mark.parametrize("name", REWRITES)
def test_encoder_identity_rewrites_equal_cv2(tmp_path, name):
    """lavc_tools.avi and xvid.avi with their user data rewritten to
    'XviD0050', taken out under an XVID fourcc (both: libavcodec's XviD IDCT,
    the second with its edge and DC-clip workarounds) and rewritten to
    'DivX503b1393' under DIVX: every frame equal to cv2's (max |d| 0)."""
    path = tmp_path / name
    path.write_bytes(asp_rewrites()[name])
    frames, r = read_all(path)
    want, (fps, total, fourcc) = cv2_read(path)
    assert sha(frames) == META[name]["sha256"] == sha(want)
    assert (r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (fps, total, fourcc)
    assert r.mpeg4_tally["xvid_idct_vops"] == (0 if name.endswith("_divx.avi") else len(frames))


@pytest.mark.parametrize("name", PLANE_CLIPS)
def test_interlaced_clips_equal_libavcodecs_planes(name):
    """Field DCT, field motion vectors in P- and B-VOPs, field direct mode
    and the alternate vertical scan: the decoder's Y, U and V planes equal
    libavcodec's (stored, and decoded live through ctypes); the reader's
    frames are their conversion, with cv2's fps, frame count and fourcc.
    cv2 itself returns stale buffers for these frames (ROADMAP.md section 3)."""
    from mga_yolo_tpu_torch import native

    _, chunks = avi_parts((FIXTURES / name).read_bytes())
    dec = native.Mpeg4Decoder(b"XVID")
    planes = [g[0] for g in (dec.decode(c) for c in chunks) if g is not None]
    tail = dec.flush()
    planes += [tail[0]] if tail is not None else []
    tally = dec.tally()
    dec.close()
    assert plane_digests(planes) == META[name]["planes_sha256"] == plane_digests(lavc_planes(chunks, b"XVID"))
    frames, r = read_all(FIXTURES / name)
    assert len(frames) == len(planes) == META[name]["frames"]
    for img, (y, u, v) in zip(frames, planes):
        np.testing.assert_array_equal(img, native.yuv_to_bgr(y, u, v, full_range=False, chroma_left=True))
    _, (fps, total, fourcc) = cv2_read(FIXTURES / name)
    assert (r.fps, r.total, int.from_bytes(r.fourcc, "little")) == (fps, total, fourcc) == \
        (META[name]["fps"], META[name]["total"], META[name]["fourcc"])
    assert tally["interlaced_vops"] == len(planes) and tally["mb_field_dct"] > 0
    if name == "asp_altscan.avi":
        assert tally["alternate_scan_vops"] == len(planes) and tally["mpeg_quant_vops"] == len(planes)
    else:
        assert tally["mb_field_mv"] > 0 and tally["vops_b"] > 0


# per fixture, the tools its decoding must have counted
TOOLS = {
    "asp_bf2.avi": ("vops_b", "b_direct", "b_direct_skip", "b_forward", "b_backward", "b_interpolated", "b_direct_8x8",
                    "mb_inter4v", "flushed"),
    "asp_bf1.avi": ("vops_b", "qpel_vops", "b_direct", "flushed"),
    "asp_packed.avi": ("vops_b", "packed_stored", "packed_decoded", "nvops_skipped"),
    "asp_mpegquant.avi": ("mpeg_quant_vops", "mismatch_toggles", "vops_b"),
    "asp_mpegquant_loaded.avi": ("mpeg_quant_vops", "loaded_intra", "loaded_inter", "mismatch_toggles"),
    "asp_qpel.avi": ("qpel_vops", "mb_inter4v"),
    "asp_qpel_bf.avi": ("qpel_vops", "vops_b", "b_direct_8x8", "video_packets"),
    "asp_dp.avi": ("partitioned_vops", "video_packets", "mb_inter4v", "mb_intra"),
    "asp_odd97x63.avi": ("qpel_vops", "vops_b"),
    "asp_xvid.avi": ("xvid_idct_vops",),
    "asp_xvid_fourcc.avi": ("xvid_idct_vops", "edge_bug_vops", "dc_clip_bug_vops", "qpel_chroma_bug_vops"),
    "asp_divx.avi": ("vops_b", "b_direct"),
    "big512_asp.avi": ("xvid_idct_vops", "qpel_vops", "vops_b", "b_direct_8x8"),
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tally_counts_each_tool(name):
    _, r = read_all(FIXTURES / name)
    missing = [k for k in TOOLS[name] if not r.mpeg4_tally[k]]
    assert not missing, (name, missing, r.mpeg4_tally)
    if name not in ("asp_xvid_fourcc.avi", "asp_xvid.avi", "big512_asp.avi"):
        assert r.mpeg4_tally["xvid_idct_vops"] == 0


def test_display_order_and_edit_lists():
    """An MP4's samples in decode order come out in display order (the
    decoder's reordering, the ctts times); the edit list of the trimmed clip
    drops the first two displayed frames, as ffmpeg's mov demuxer does."""
    full, r = read_all(FIXTURES / "asp_bf2.mp4")
    assert r.pts is not None and r.shown is None and r.pts != sorted(r.pts)
    trim, rt = read_all(FIXTURES / "asp_bf2_trim.mp4")
    assert len(trim) == len(full) - 2 and sha(trim) == sha(full)[2:]
    assert rt.shown == sorted(rt.shown, key=lambda i: rt.pts[i])
    avi, _ = read_all(FIXTURES / "asp_bf2.avi")
    mkv, _ = read_all(FIXTURES / "asp_bf2.mkv")
    mpg, _ = read_all(FIXTURES / "asp_bf2.mpg")
    assert sha(full) == sha(avi) == sha(mkv) == sha(mpg)


def test_decoder_delay_flush_and_identity():
    """A stream with B-VOPs gives its frames one chunk late and the last at
    flush; a B-VOP before a second reference gives none; the container's
    fourcc names the encoder of an unmarked stream (XVID: the XviD IDCT),
    user data wins over it, and DIVX / DX50 / FMP4 change nothing."""
    from mga_yolo_tpu_torch import native

    _, chunks = avi_parts((FIXTURES / "asp_bf2.avi").read_bytes())
    dec = native.Mpeg4Decoder()
    kinds = [dec.decode(c) for c in chunks]
    assert kinds[0] is None and kinds[1][1] == 0  # the I-VOP comes out after the P-VOP after it
    assert dec.flush()[1] == 1 and dec.flush() is None
    dec.close()
    _, plain = avi_parts((FIXTURES / "xvid.avi").read_bytes())
    unmarked = [user_data(c, b"") for c in plain]

    def planes(fourcc, stream):
        d = native.Mpeg4Decoder(fourcc)
        out = [d.decode(c)[0] for c in stream]
        t = d.tally()
        d.close()
        return plane_digests(out), t["xvid_idct_vops"]

    base = planes(b"", unmarked)
    assert base[1] == 0
    for tag in (b"DIVX", b"DX50", b"FMP4", b"divx"):
        assert planes(tag, unmarked) == base
    xvid = planes(b"XVID", unmarked)
    assert xvid[1] == len(unmarked) and xvid[0] != base[0] and planes(b"xvid", unmarked) == xvid
    assert planes(b"XVID", plain)[1] == 0  # the Lavc user data: libavcodec's own IDCT
    assert xvid[0] == plane_digests(lavc_planes(unmarked, b"XVID"))


def test_b_vops_where_cv2_passes_over_them(tmp_path):
    """A B-VOP before a second reference (an I-VOP's successor retyped, and
    one mid-stream whose times are out of order), and a stream ending on an
    uncoded VOP (cv2 gives the last frame again): frames and count as cv2's."""
    head, chunks = avi_parts((FIXTURES / "xvid.avi").read_bytes())

    def retype(c, k):
        i = c.index(b"\x00\x00\x01\xb6") + 4
        return c[:i] + bytes([(c[i] & 0x3F) | (k << 6)]) + c[i + 1:]

    bits = "01" + "0" + "1" + format(100, "012b") + "1" + "0"
    bits += "0" + "1" * (-(len(bits) + 1) % 8)
    uncoded = b"\x00\x00\x01\xb6" + int(bits, 2).to_bytes(len(bits) // 8, "big")
    for k, stream in enumerate(([chunks[0], retype(chunks[1], 2)] + chunks[2:], chunks[:4] + [retype(chunks[4], 2)] +
                                chunks[5:], chunks + [uncoded])):
        path = tmp_path / f"b{k}.avi"
        path.write_bytes(pack_avi(head, stream))
        frames, _ = read_all(path)
        want, _ = cv2_read(path)
        assert len(frames) == len(want) == (14 if k == 2 else 12)
        assert sha(frames) == sha(want)


def _vol_avi(tmp_path: Path, **fields) -> Path:
    """asp_bf2.avi with its first chunk's VOL replaced by one of the given
    fields (a version-2 VOL of the clip's size that ffmpeg's encoder could
    write, its tools flags overridden)."""
    f = dict(shape=0, obmc_disable=1, sprite=0, not_8_bit=0, complexity_disable=1, partitioned=0, rvlc=0, newpred=0,
             reduced=0, scalable=0)
    f.update(fields)
    bits = "0" + format(17, "08b") + "1" + format(2, "04b") + "001" + "0001" + "1" + "01" + "0" + "0"
    bits += format(f["shape"], "02b") + "1" + format(25, "016b") + "1" + "0" + "1" + format(64, "013b") + "1" + \
        format(48, "013b") + "1" + "0" + str(f["obmc_disable"]) + format(f["sprite"], "02b") + str(f["not_8_bit"])
    bits += "0" + "0" + str(f["complexity_disable"]) + "1" + str(f["partitioned"])
    bits += str(f["rvlc"]) if f["partitioned"] else ""
    bits += str(f["newpred"]) + ("000" if f["newpred"] else "") + str(f["reduced"]) + str(f["scalable"])
    bits += "0" + "1" * (-(len(bits) + 1) % 8)
    vol = b"\x00\x00\x01\x20" + int(bits, 2).to_bytes(len(bits) // 8, "big")
    head, chunks = avi_parts((FIXTURES / "asp_bf2.avi").read_bytes())
    first = chunks[0]
    i, j = first.index(b"\x00\x00\x01\x20"), first.index(b"\x00\x00\x01", first.index(b"\x00\x00\x01\x20") + 4)
    path = tmp_path / "tool.avi"
    path.write_bytes(pack_avi(head, [first[:i] + vol + first[j:]] + chunks[1:]))
    return path


@pytest.mark.parametrize("kind, what", [
    ("s_vop", "S-VOPs"), ("gmc", "sprites or GMC"), ("static_sprite", "sprites or GMC"), ("rvlc", "RVLC"),
    ("obmc", "OBMC"), ("shape", "non-rectangular shapes"), ("not_8_bit", "not_8_bit"), ("newpred", "NEWPRED"),
    ("reduced", "reduced-resolution"), ("scalable", "scalable"), ("complexity", "complexity estimation"),
    ("three_vops", "packed MPEG-4 chunk of three or more VOPs"), ("unpacked_pair", "two VOPs in one chunk")])
def test_what_the_port_does_not_read_raises_naming_it(tmp_path, kind, what):
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    fields = {"gmc": {"sprite": 2}, "static_sprite": {"sprite": 1}, "rvlc": {"partitioned": 1, "rvlc": 1},
              "obmc": {"obmc_disable": 0}, "shape": {"shape": 2}, "not_8_bit": {"not_8_bit": 1},
              "newpred": {"newpred": 1}, "reduced": {"reduced": 1}, "scalable": {"scalable": 1},
              "complexity": {"complexity_disable": 0}}
    assert len(read_all(_vol_avi(tmp_path))[0]) == META["asp_bf2.avi"]["frames"]  # the VOL as written reads
    if kind in fields:
        path = _vol_avi(tmp_path, **fields[kind])
    else:
        head, chunks = avi_parts((FIXTURES / ("asp_bf2.avi" if kind != "three_vops" else "xvid.avi")).read_bytes())
        if kind == "s_vop":
            i = chunks[1].index(b"\x00\x00\x01\xb6") + 4
            chunks[1] = chunks[1][:i] + bytes([chunks[1][i] | 0xC0]) + chunks[1][i + 1:]
        elif kind == "three_vops":
            chunks = [user_data(chunks[0], b"DivX503b1393p"), chunks[1] + chunks[2] + chunks[3]] + chunks[4:]
        else:
            chunks = [chunks[0], chunks[1] + chunks[2]] + chunks[3:]
        path = tmp_path / "tool.avi"
        path.write_bytes(pack_avi(head, chunks))
    with pytest.raises(ValueError, match=rf"^{path}: AVI with MPEG-4 video: .*{what}"):
        read_all(path)


@pytest.mark.parametrize("name", ["asp_bf2.avi", "asp_packed.avi", "asp_dp.avi", "asp_ilace.avi", "asp_qpel_bf.avi",
                                  "asp_es.m4v", "asp_bf1.mp4"])
def test_cut_and_flipped_files_raise_value_errors_or_give_frames(tmp_path, name):
    """Cut at 40 seeded places, or a bit flipped at 120: a ValueError naming
    the file, or frames of the header's size; never a crash (the C++ also ran
    such sweeps under ASan and UBSan). libavcodec conceals damage; the port
    refuses it."""
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    data = (FIXTURES / name).read_bytes()
    rng = np.random.default_rng(5)
    path = tmp_path / name
    variants = [data[:k] for k in sorted(rng.choice(len(data), 40, replace=False))]
    for k in rng.choice(len(data), 120, replace=False):
        flipped = bytearray(data)
        flipped[k] ^= 1 << int(rng.integers(8))
        variants.append(bytes(flipped))
    for v in variants:
        path.write_bytes(v)
        try:
            with VideoReader(path) as r:
                for img in r:
                    assert img.shape == (r.size[1], r.size[0], 3)
        except ValueError as e:
            assert str(e).startswith(str(path)), e


def test_bare_stream_under_any_suffix(tmp_path):
    """The .m4v stream renamed .bin and .avi reads as cv2 reads it there."""
    for suffix in (".bin", ".avi"):
        path = tmp_path / f"es{suffix}"
        shutil.copy(FIXTURES / "asp_es.m4v", path)
        frames, r = read_all(path)
        want, (fps, total, fourcc) = cv2_read(path)
        assert sha(frames) == sha(want) == META["asp_es.m4v"]["sha256"]
        assert (r.container, r.fps, r.total, int.from_bytes(r.fourcc, "little")) == ("MPEG-4 video", fps, total, fourcc)


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """The JAX flagship with seeded weights, the port's model with the same
    weights and a checkpoint of them (as ``tests/test_torch_predict.py``)."""
    import torch

    from mga_yolo_tpu.models.yolo import create_model as jcreate
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax

    cfg = "configs/models/yolov8_cbam.yaml"
    root = tmp_path_factory.mktemp("asp_predict")
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
    for name in ("asp_bf2.avi", "asp_packed.avi", "asp_es.m4v", "asp_bf1.mp4"):
        shutil.copy(FIXTURES / name, src / name)
    return src


def test_iter_source_over_asp_clips_equals_jax(tmp_path):
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


def test_cli_predict_on_asp_clips_writes_what_the_jax_cli_writes(flagship, tmp_path, monkeypatch, capsys):
    """``cli.predict`` over B-VOP, packed, bare-stream and MP4 clips writes
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
