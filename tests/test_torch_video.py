"""The port's video path (``data/video_io.py`` on ``native/jpeg.cpp``,
``native/mpeg4.cpp`` and ``native/yuv.cpp``) against the JAX package's
reader and writer, ``cv2.VideoCapture`` / ``cv2.VideoWriter``, on the CPU.

Reading: the committed clips (``tests/video_fixtures``, written by cv2 from
numpy seeds; ``python -m tests.video_fixtures.make``) against the frames,
fps, frame count and fourcc cv2 read from them, stored beside them. Bounds,
per frame:

* the frame count, shape and ``total`` equal, ``fps`` within 1e-9 relative;
* MJPEG: mean |d| <= 0.5 and max |d| <= 8 levels (decoding each frame as a
  still image, with libjpeg's upsampling, misses cv2 by 1.34 / 89);
* MPEG-4 Part 2 (mp4v, XVID): PSNR >= 40 dB and mean |d| <= 0.75;
* uncompressed (BI_RGB, cv2's I420): exact.

Writing: cv2 reads the port's ``.avi`` as MJPG and its ``.mp4`` as the
mp4v cv2 itself writes, with the frame count, fps (10, 25, 29.97, 30; 0 ->
30) and the even-cropped size; PSNR against the frames written >= 35 dB.
What the port refuses raises ValueError naming the file, its container and
its codec.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from tests._torch_port import few_torch_threads  # noqa: F401

FIXTURES = Path(__file__).resolve().parent / "video_fixtures"
META = json.loads((FIXTURES / "meta.json").read_text())
MJPEG = {"mjpg.avi", "mjpeg.mov", "nodht.avi", "odd97x63.avi"}
MPEG4 = {"xvid.avi", "mp4v.mp4", "odd97x63.mp4", "lavc_tools.avi"}  # lavc_tools: 4MV, video packets, dquant
RAW = {"bgr24.avi", "bgr24_top_down.avi", "i420.avi"}
pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.fixture(scope="module")
def stored():
    with np.load(FIXTURES / "frames.npz") as z:
        return {k: z[k] for k in z.files}


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


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


def test_fixtures_cover_every_kind():
    # the Matroska / WebM clips beside them are tests/test_torch_matroska.py's
    assert {n for n in META if not n.endswith((".mkv", ".webm"))} == MJPEG | MPEG4 | RAW | {"big512.mp4"}
    assert META["odd97x63.mp4"]["shape"] == [62, 96, 3] and META["xvid.avi"]["fps"] == 29.97


@pytest.mark.parametrize("name", sorted(MJPEG | MPEG4 | RAW))
def test_reader_equals_cv2_on_the_fixtures(name, stored):
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    meta, want = META[name], stored[name]
    with VideoReader(FIXTURES / name) as r:
        got = list(r)
        assert r.total == meta["total"] and abs(r.fps - meta["fps"]) <= 1e-9 * meta["fps"]
        assert int.from_bytes(r.fourcc, "little") == meta["fourcc"]
        assert r.size == (meta["shape"][1], meta["shape"][0])
    assert len(got) == len(want) == meta["frames"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == np.uint8
        d = np.abs(g.astype(np.int16) - w)
        if name in MJPEG:
            assert d.mean() <= 0.5 and d.max() <= 8, (name, i, d.mean(), d.max())
        elif name in MPEG4:
            assert psnr(g, w) >= 40 and d.mean() <= 0.75, (name, i, psnr(g, w), d.mean())
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{name} frame {i}")


def test_512_mp4v_clip_equals_cv2s_frame_digests():
    """The clip [video] times on the card: each frame's SHA-256 is cv2's
    (the port's MPEG-4 decode equals ffmpeg's for the streams cv2 writes)."""
    import hashlib

    from mga_yolo_tpu_torch.data.video_io import VideoReader

    meta = META["big512.mp4"]
    with VideoReader(FIXTURES / "big512.mp4") as r:
        got = [hashlib.sha256(img.tobytes()).hexdigest() for img in r]
        assert (r.total, r.fps, r.size) == (meta["total"], meta["fps"], (512, 512))
    assert got == meta["sha256"] and len(got) == meta["frames"] == 13


def test_mjpeg_frames_are_not_still_decodes(tmp_path):
    """Colour MJPEG frames meet the bound where decoding each as a still
    image (libjpeg's fancy chroma upsampling) misses cv2's frames by far."""
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    rng = np.random.default_rng(3)
    frames = [cv2.GaussianBlur(rng.integers(0, 256, (48, 64, 3), np.uint8), (3, 3), 0) for _ in range(3)]
    vw = cv2.VideoWriter(str(tmp_path / "c.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 25, (64, 48))
    for img in frames:
        vw.write(img)
    vw.release()
    want, _ = cv2_read(tmp_path / "c.avi")
    with VideoReader(tmp_path / "c.avi") as r:
        got = list(r)
        stills = [image_io.imdecode(r._read(o, n)) for o, n in r.samples]
    for g, s, w in zip(got, stills, want):
        d = np.abs(g.astype(np.int16) - w)
        assert d.mean() <= 0.5 and d.max() <= 8
        assert np.abs(s.astype(np.int16) - w).max() > 8


def _angiograms(n: int, h: int, w: int, seed: int) -> list:
    """BGR frames of the synthetic angiograms the port's tests train on."""
    from mga_yolo_tpu_torch.data.synthetic import vessel_image

    rng = np.random.default_rng(seed)
    return [np.repeat(vessel_image(rng, max(h, w), 4)[0][:h, :w, None], 3, axis=2) for _ in range(n)]


@pytest.mark.parametrize("suffix", [".avi", ".mp4"])
@pytest.mark.parametrize("fps", [10, 25, 29.97, 30, 0])
def test_writer_is_read_by_cv2(tmp_path, suffix, fps):
    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data.video_io import VideoReader, VideoWriter

    h, w = (63, 97) if fps == 25 else (64, 96)
    frames = _angiograms(5, h, w, seed=int(fps * 100))
    path = tmp_path / f"out{suffix}"
    with VideoWriter(path, fps, (w, h)) as vw:
        for img in frames:
            vw.write(img)
        assert vw.frames_written == 5
    got, (cfps, total, fourcc) = cv2_read(path)
    own = tmp_path / f"cv2{suffix}"  # the fourcc cv2 reports for the file it writes itself
    vw = cv2.VideoWriter(str(own), cv2.VideoWriter_fourcc(*("MJPG" if suffix == ".avi" else "mp4v")), 30, (w, h))
    vw.write(frames[0])
    vw.release()
    assert fourcc == cv2_read(own)[1][2] == int.from_bytes(b"MJPG" if suffix == ".avi" else b"FMP4", "little")
    assert len(got) == total == 5 and cfps == (fps or 30)
    assert got[0].shape == (h - h % 2, w - w % 2, 3)
    for g, img in zip(got, frames):
        assert psnr(g, img[:g.shape[0], :g.shape[1]]) >= 35
    with VideoReader(path) as r:
        back = list(r)
        assert r.fps == cfps and r.total == total
        chunks = [r._read(o, n) for o, n in r.samples]
    assert len(back) == 5
    for i, (b, g) in enumerate(zip(back, got)):
        if suffix == ".avi":  # each frame is its chunk's planes, converted
            np.testing.assert_array_equal(b, native.yuv_to_bgr(*native.jpeg_decode_planes(chunks[i])[0], True))
            d = np.abs(b.astype(np.int16) - g)
            assert d.mean() <= 0.5 and d.max() <= 8
        else:
            assert psnr(b, g) >= 40


def test_mpeg4_stream_is_all_sync_samples_with_the_vol_in_esds(tmp_path):
    from mga_yolo_tpu_torch.data.video_io import VideoReader, VideoWriter

    with VideoWriter(tmp_path / "a.mp4", 25, (64, 48)) as vw:
        for img in _angiograms(3, 48, 64, 1):
            vw.write(img)
    data = (tmp_path / "a.mp4").read_bytes()
    assert b"stss" not in data and data.count(b"\x00\x00\x01\xb6") == 3 and b"mp4v" in data
    with VideoReader(tmp_path / "a.mp4") as r:
        assert r.extradata.startswith(b"\x00\x00\x01\xb0") and r.codec == "mpeg4" and r.keyframes is None


def _mp4_with(data: bytes, old: bytes, new: bytes) -> bytes:
    i = data.index(old)
    return data[:i] + new + data[i + len(old):]


def _vop_type(chunk: bytes, kind: int) -> bytes:
    i = chunk.index(b"\x00\x00\x01\xb6") + 4
    return chunk[:i] + bytes([(chunk[i] & 0x3F) | (kind << 6)]) + chunk[i + 1:]


def _refused(kind: str, tmp_path: Path) -> tuple[Path, str]:
    from tests.video_fixtures.make import avi_parts, pack_avi

    mp4 = (FIXTURES / "mp4v.mp4").read_bytes()
    head, chunks = avi_parts((FIXTURES / "xvid.avi").read_bytes())
    if kind == "avc1":
        # H.264 reads now (tests/test_torch_h264.py): an avc1 sample entry without its configuration does not
        data, what = _mp4_with(mp4, b"mp4v", b"avc1"), r"an 'avc1' sample entry without an 'avcC' box"
    elif kind == "hvc1":
        data, what = _mp4_with(mp4, b"mp4v", b"hvc1"), r"MP4 with HEVC video \('hvc1'\)"
    elif kind == "moof":
        data, what = mp4 + struct.pack(">I4s", 16, b"moof") + bytes(8), r"fragmented MP4 \('moof'"
    elif kind == "b_vop":  # B-VOPs read now: one before a second reference, which ffmpeg passes over
        data, what = pack_avi(head, [chunks[0], _vop_type(chunks[1], 2)] + chunks[2:]), None
    elif kind == "s_vop":
        data, what = pack_avi(head, [chunks[0], _vop_type(chunks[1], 3)] + chunks[2:]), "S-VOPs"
    elif kind == "packed":  # DivX's packed bitstream reads now: a packed chunk of three VOPs does not
        from tests.video_fixtures.make import user_data

        data, what = pack_avi(head, [user_data(chunks[0], b"DivX503b1393p"), chunks[1] + chunks[2] + chunks[3]] +
                              chunks[4:]), "AVI with MPEG-4 video: a packed MPEG-4 chunk of three or more VOPs"
    elif kind == "h264_avi":
        data, what = (FIXTURES / "xvid.avi").read_bytes().replace(b"XVID", b"H264"), r"AVI with H\.264 video"
    elif kind == "interlaced":
        mhead, mchunks = avi_parts((FIXTURES / "mjpg.avi").read_bytes())
        data, what = pack_avi(mhead, [c + c for c in mchunks]), r"interlaced MJPEG \(two fields per chunk\)"
    elif kind in ("mkv", "webm"):  # Matroska and WebM read now: codecs in them the port still refuses (FFV1 reads)
        from tests.video_fixtures.make import mkv_blocks, mkv_bytes

        mj = (FIXTURES / "mjpg.mkv").read_bytes()
        packets = [(mj[o:o + n], True, 40 * i) for i, (o, n) in enumerate(mkv_blocks(mj))]
        cid, what = ("V_THEORA", r"Matroska with Theora video \('V_THEORA'\)") if kind == "mkv" else \
            ("V_VP9", r"WebM with VP9 video \('V_VP9'\)")
        path = tmp_path / f"clip.{kind}"
        path.write_bytes(mkv_bytes(cid, 64, 48, packets, doctype="matroska" if kind == "mkv" else "webm"))
        return path, what
    elif kind in ("mpg", "mpeg"):  # MPEG-PS reads now: a stream of no video, and a codec the port refuses in it
        from tests.video_fixtures.make import ps_bytes

        path = tmp_path / f"clip.{kind}"
        if kind == "mpg":
            pes = b"\x00\x00\x01\xc0\x00\x10\x0f" + bytes(15)
            path.write_bytes(b"\x00\x00\x01\xba\x21\x00\x01\x00\x01\x80\x1b\x83" + pes * 4)
            return path, "MPEG-PS file without a video stream"
        path.write_bytes(ps_bytes([(b"\x00\x00\x00\x01\x67\x42\x00\x1e" + bytes(64), True, 0)], 25))
        return path, r"MPEG-PS with H\.264 video"
    else:  # ASF / WMV reads now (tests/test_torch_wmv.py): a header cut at 64 bytes raises naming ASF
        path = tmp_path / f"clip.{kind}"
        path.write_bytes(b"\x30\x26\xb2\x75" + bytes(60))
        return path, "corrupt or truncated ASF file"
    path = tmp_path / f"clip_{kind}.{'mp4' if kind in ('avc1', 'hvc1', 'moof') else 'avi'}"
    path.write_bytes(data)
    return path, what


@pytest.mark.parametrize("kind", ["avc1", "hvc1", "moof", "b_vop", "s_vop", "packed", "h264_avi", "interlaced",
                                  "mkv", "webm", "mpg", "mpeg", "wmv", "gif"])
def test_what_the_port_does_not_read_raises_naming_it(tmp_path, kind):
    """Each refused codec, layout and container raises ValueError naming the
    file and what it is. GIF, once refused, now reads as cv2.VideoCapture
    reads it (``tests/test_torch_more_formats.py`` holds every frame);
    Matroska and WebM, once refused, now read, and their cases are codecs
    the port still refuses in them (``tests/test_torch_matroska.py`` holds
    the rest); so do MPEG-PS (``.mpg``, ``.mpeg``: a stream without video
    and an H.264 stream; ``tests/test_torch_mpeg.py`` holds the rest).
    B-VOPs and packed bitstreams, once refused, now read
    (``tests/test_torch_mpeg4_asp.py`` holds them): the B-VOP case is one
    before a second reference, which the port passes over as cv2 does, and
    the packed case a packed chunk of three VOPs, which it refuses. H.264,
    once refused, now reads (``tests/test_torch_h264.py`` holds it): the
    avc1 case is a sample entry without its avcC record, and the AVI case
    MPEG-4 data under an H.264 tag, which the decoder refuses as corrupt."""
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    if kind == "gif":
        clip = Path(__file__).resolve().parent / "format_fixtures" / "gif_pil_disposals_interlaced.gif"
        cap = cv2.VideoCapture(str(clip))
        with VideoReader(clip) as r:
            assert (len(list(r)), r.fps, r.total, r.fourcc) == (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                                                                cap.get(cv2.CAP_PROP_FPS), 4, b"gif ")
        return
    path, what = _refused(kind, tmp_path)
    if what is None:
        want, _ = cv2_read(path)
        with VideoReader(path) as r:
            got = list(r)
        assert len(got) == len(want) == 12 and all((g == w).all() for g, w in zip(got, want))
        return
    with pytest.raises(ValueError, match=rf"{path.name}: .*{what}"):
        with VideoReader(path) as r:
            list(r)


def _with_edits(data: bytes, edits: list) -> bytes:
    """An MP4 with its one-entry elst replaced by ``edits`` ((duration in
    the movie's timescale, media time), rate 1), the parents' sizes fixed."""
    i = data.index(b"elst")
    body = struct.pack(">II", 0, len(edits)) + b"".join(struct.pack(">Iihh", d, m, 1, 0) for d, m in edits)
    old = struct.unpack(">I", data[i - 4:i])[0]
    out = bytearray(data[:i - 4] + struct.pack(">I", 8 + len(body)) + b"elst" + body + data[i - 4 + old:])
    for t in (b"edts", b"trak", b"moov"):  # all before the elst, so at the same offsets
        j = data.index(t)
        out[j - 4:j] = struct.pack(">I", struct.unpack(">I", data[j - 4:j])[0] + 8 + len(body) - old)
    return bytes(out)


@pytest.mark.parametrize("edits", [[(266, 1024)], [(166, 1536)], [(100, 0), (100, 3072)], [(0, 0)],
                                   [(100, -1), (133, 512)], [(100000, 0)]],
                         ids=["skip_2", "middle_5", "two_edits", "zero_duration", "empty_edit_first", "past_the_end"])
def test_edit_lists_show_the_frames_cv2_shows(tmp_path, edits):
    """mp4v.mp4 (15360 ticks a second, 512 a frame; the movie 1000) with
    other edit lists: the frames cv2 shows, from the P-VOPs decoded after
    their I-VOP; fps and total stay the whole track's."""
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    path = tmp_path / "edited.mp4"
    path.write_bytes(_with_edits((FIXTURES / "mp4v.mp4").read_bytes(), edits))
    want, (fps, total, _) = cv2_read(path)
    with VideoReader(path) as r:
        got = list(r)
        assert (r.fps, r.total) == (fps, total) == (30.0, 13)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert psnr(g, w) >= 40


@pytest.mark.parametrize("layout", ["no_idx1", "avix", "rec_lists"])
def test_avi_layouts_read_as_cv2_reads_them(tmp_path, layout):
    """An AVI with no idx1 (the movi chunks scanned), one continued in an
    OpenDML RIFF AVIX segment, and one whose chunks sit in LIST rec."""
    from mga_yolo_tpu_torch.data.video_io import VideoReader
    from tests.video_fixtures.make import avi_parts, pack_avi

    head, chunks = avi_parts((FIXTURES / "mjpg.avi").read_bytes())

    def movi(payloads, rec=False):
        body = b"".join(struct.pack("<4sI", b"00dc", len(p)) + p + b"\0" * (len(p) & 1) for p in payloads)
        if rec:
            body = struct.pack("<4sI4s", b"LIST", 4 + len(body), b"rec ") + body
        return struct.pack("<4sI4s", b"LIST", 4 + len(body), b"movi") + body

    if layout == "avix":
        seg = movi(chunks[6:])
        data = pack_avi(head, chunks[:6]) + b"RIFF" + struct.pack("<I", 4 + len(seg)) + b"AVIX" + seg
    else:
        body = head[12:] + movi(chunks, rec=layout == "rec_lists")
        data = b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI " + body
    path = tmp_path / f"{layout}.avi"
    path.write_bytes(data)
    want, (fps, total, _) = cv2_read(path)
    with VideoReader(path) as r:
        got = list(r)
        assert (r.fps, r.total) == (fps, total)
    assert len(got) == len(want) == len(chunks)
    for g, w in zip(got, want):
        d = np.abs(g.astype(np.int16) - w)
        assert d.mean() <= 0.5 and d.max() <= 8


def test_mp4_with_moov_before_mdat(tmp_path):
    """moov wherever it lies: mp4v.mp4 rewritten with moov first (its
    chunk offsets moved by moov's size), as a "faststart" writer lays it out."""
    from mga_yolo_tpu_torch.data.video_io import VideoReader

    data = (FIXTURES / "mp4v.mp4").read_bytes()
    boxes, off = {}, 0
    while off < len(data):
        n, t = struct.unpack(">I4s", data[off:off + 8])
        boxes[t] = data[off:off + n]
        off += n
    moov = bytearray(boxes[b"moov"])
    i = moov.index(b"stco")
    count = struct.unpack(">I", moov[i + 8:i + 12])[0]
    for k in range(count):
        o = i + 12 + 4 * k
        moov[o:o + 4] = struct.pack(">I", struct.unpack(">I", moov[o:o + 4])[0] + len(moov))
    path = tmp_path / "faststart.mp4"
    path.write_bytes(boxes[b"ftyp"] + bytes(moov) + b"".join(v for k, v in boxes.items() if k not in (b"ftyp", b"moov")))
    want, _ = cv2_read(path)
    with VideoReader(path) as r:
        got = list(r)
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        assert psnr(g, w) >= 40


def _vol(**fields) -> bytes:
    """A video object layer header of a 64x48 stream (the fields a Simple
    profile one carries), with ``fields`` overriding its bits."""
    f = dict(verid=1, shape=0, interlaced=0, obmc_disable=1, sprite=0, not_8_bit=0, quant_type=0, quarter=0,
             complexity_disable=1, partitioned=0, rvlc=0, scalable=0)
    f.update(fields)
    bits = "0" + format(1, "08b")  # random_accessible_vol, object type
    bits += ("1" + format(f["verid"], "04b") + "001") if f["verid"] != 1 else "0"
    bits += "0001" + "0" + format(f["shape"], "02b") + "1" + format(25, "016b") + "1" + "0"
    bits += "1" + format(64, "013b") + "1" + format(48, "013b") + "1"
    bits += str(f["interlaced"]) + str(f["obmc_disable"])
    bits += format(f["sprite"], "01b" if f["verid"] == 1 else "02b")
    bits += str(f["not_8_bit"]) + str(f["quant_type"]) + ("00" if f["quant_type"] else "")  # no matrices loaded
    bits += str(f["quarter"]) if f["verid"] != 1 else ""
    bits += str(f["complexity_disable"]) + "1" + str(f["partitioned"]) + (str(f["rvlc"]) if f["partitioned"] else "")
    bits += "00" if f["verid"] != 1 else ""
    bits += str(f["scalable"])
    bits += "0" + "1" * (-(len(bits) + 1) % 8)
    return b"\x00\x00\x01\x20" + int(bits, 2).to_bytes(len(bits) // 8, "big")


@pytest.mark.parametrize("fields, what", [
    ({}, None), ({"verid": 2}, None),
    ({"shape": 1}, "non-rectangular shapes"), ({"interlaced": 1}, None),
    ({"obmc_disable": 0}, "OBMC"), ({"sprite": 1}, "sprites or GMC"), ({"verid": 2, "sprite": 2}, "sprites or GMC"),
    ({"not_8_bit": 1}, "not_8_bit"), ({"quant_type": 1}, None),
    ({"verid": 2, "quarter": 1}, None), ({"complexity_disable": 0}, "complexity estimation"),
    ({"partitioned": 1}, None), ({"partitioned": 1, "rvlc": 1}, "RVLC"), ({"scalable": 1}, "scalable")],
    ids=["simple", "verid2", "shape", "interlaced", "obmc", "sprite", "gmc", "not_8_bit", "quant_type", "qpel",
         "complexity", "partitioned", "rvlc", "scalable"])
def test_vol_tools_outside_simple_profile_are_refused_by_name(fields, what):
    """The VOL flags of tools the port does not decode raise naming them;
    interlacing, quant_type 1, quarter-sample motion and data partitioning
    (the Advanced Simple profile's, read now) give a header and no frame."""
    from mga_yolo_tpu_torch import native

    dec = native.Mpeg4Decoder()
    try:
        if what is None:
            assert dec.decode(_vol(**fields)) is None  # a header, no frame
        else:
            with pytest.raises(ValueError, match=what):
                dec.decode(_vol(**fields))
    finally:
        dec.close()


def test_uncoded_vop_gives_no_frame_as_in_cv2(tmp_path):
    """vop_coded = 0 gives no frame: ffmpeg passes it over, and cv2 reads on
    (the frame count of the stream header still counts it)."""
    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data.video_io import VideoReader
    from tests.video_fixtures.make import avi_parts, pack_avi

    head, chunks = avi_parts((FIXTURES / "xvid.avi").read_bytes())
    dec = native.Mpeg4Decoder()
    assert dec.decode(chunks[0])[1] == 0
    # an uncoded P-VOP: type 01, modulo_time_base 0, marker, 12 bits of time (2997 ticks a second), marker, coded 0
    bits = "01" + "0" + "1" + format(100, "012b") + "1" + "0"
    bits += "0" + "1" * (-(len(bits) + 1) % 8)
    uncoded = b"\x00\x00\x01\xb6" + int(bits, 2).to_bytes(len(bits) // 8, "big")
    assert dec.decode(uncoded) is None and dec.decode(chunks[1])[1] == 1
    dec.close()
    path = tmp_path / "uncoded.avi"
    path.write_bytes(pack_avi(head, chunks[:5] + [uncoded] + chunks[5:]))
    want, _ = cv2_read(path)
    with VideoReader(path) as r:
        got = list(r)
    assert len(got) == len(want) == len(chunks)
    for g, w in zip(got, want):
        assert psnr(g, w) >= 40


@pytest.mark.parametrize("name", ["mjpg.avi", "xvid.avi", "mp4v.mp4", "bgr24.avi"])
def test_cut_and_flipped_files_raise_value_errors(name):
    """Cut at 150 places, or a byte flipped at 150: a ValueError naming the
    file, or frames of the header's size; never a crash."""
    import tempfile

    from mga_yolo_tpu_torch.data.video_io import VideoReader

    data = (FIXTURES / name).read_bytes()
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / name
        step = max(1, len(data) // 150)
        variants = [data[:k] for k in range(0, len(data), step)]
        for k in range(200, len(data), step):
            flipped = bytearray(data)
            flipped[k] ^= 1 << int(rng.integers(8))
            variants.append(bytes(flipped))
        for v in variants:
            path.write_bytes(v)
            try:
                with VideoReader(path) as r:
                    for img in r:
                        assert img.shape[:2] == (r.size[1], r.size[0]) or name.startswith("mp4v")
            except ValueError as e:
                assert str(e).startswith(str(path)), e
