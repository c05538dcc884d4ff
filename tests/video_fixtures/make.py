"""Writes the video fixtures that ``tests/test_torch_video.py``,
``tests/test_torch_matroska.py`` and ``chip_smoke.py`` ``[video]`` and
``[matroska]`` read: small clips written by cv2 (the JAX
package's video reader and writer, with ffmpeg inside) from numpy seeds, and
beside them what ``cv2.VideoCapture`` reads from each, the oracle:
``frames.npz`` (every frame, BGR uint8) and ``meta.json`` (``CAP_PROP_FPS``,
``CAP_PROP_FRAME_COUNT``, ``CAP_PROP_FOURCC`` and the frame shape).

    python -m tests.video_fixtures.make

The clips: MJPG in AVI, XVID in AVI, mp4v in MP4 (13 frames: a GOP of 12
and the next I-VOP), MJPEG in MOV, an MJPG AVI of libjpeg's frames with
their DHT taken out (the standard Huffman tables assumed, as cameras'
MJPEG does), a 97x63
source written as mp4v and as MJPG (cv2 crops to 96x62), uncompressed
24-bit BI_RGB AVIs (bottom-up and top-down, packed here) and cv2's own
"uncompressed" AVI (fourcc 0: I420). cv2 aborts reading the bottom-up
BI_RGB file, so the frames written are its oracle. An XVID AVI from
ffmpeg's mpeg4 encoder with the tools cv2's writer leaves off (4MV, video
packets with resync markers, per-macroblock dquant; ``lavc_mpeg4``). And a
512x512 mp4v clip
(a GOP of 12 and an I-VOP), for decode times at the model's input size,
with the SHA-256 of cv2's frames in place of the frames.

Matroska and WebM (their oracle the SHA-256 of each frame cv2 reads, with
its fps, count and fourcc): cv2's writer's MJPG and mp4v in ``.mkv``, VP8 in
``.webm`` and ``.mkv``, a 97x63 VP8 source (cropped to 96x62) and a fourcc
of 0 (``V_UNCOMPRESSED`` I420); libvpx (inside cv2's wheel, through
libavcodec's ``libvpx`` encoder) with what cv2's writer leaves off, over a
moving synthetic angiogram (shifted, turned and zoomed a little a frame):
two-pass hidden alt-ref frames, a key-frame interval of 5, four token
partitions, error-resilient frames (probabilities saved and put back,
segmentation), profiles 1 and 3 (bilinear and full-pixel prediction) and an
odd width, in files this module lays out (``mkv_bytes``): BlockGroups with
CRC-32 and Void elements and several clusters, a live-style file (Segment
and Clusters of unknown size, no Duration, no Cues), a track without
DefaultDuration and a ``V_MS/VFW/FOURCC`` MJPEG track. And ``big512.webm``,
16 VP8 frames at 512 x 512 (key frames 0 and 8) for ``[matroska]``'s decode
times.
"""

from __future__ import annotations

import hashlib
import json
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
N = 13
SIZE = (48, 64)  # (h, w)
RAW_SIZE = (32, 48)


def frames(n: int, h: int, w: int, seed: int) -> list:
    """Angiogram-like frames: a textured grey background, dark vessels that
    move, and a noise patch every fifth frame (intra macroblocks in P-VOPs)."""
    rng = np.random.default_rng(seed)
    bg = cv2.GaussianBlur(rng.integers(90, 200, (2 * h, 2 * w)).astype(np.uint8), (5, 5), 1.5)
    out = []
    for i in range(n):
        f = bg[(3 * i) % h:(3 * i) % h + h, (2 * i) % w:(2 * i) % w + w].copy()
        for k in range(3):
            y0 = int(h * (0.2 + 0.3 * k) + 4 * np.sin(i / 2 + k))
            cv2.line(f, (0, y0), (w - 1, int(y0 + h * 0.3 * np.cos(k))), 40 + 20 * k, 2 + k)
        if i % 5 == 3:
            f[h // 4:h // 4 + h // 4, w // 4:w // 4 + w // 4] = rng.integers(0, 256, (h // 4, w // 4))
        img = cv2.cvtColor(f, cv2.COLOR_GRAY2BGR)
        img[..., 2] = np.clip(img[..., 2].astype(int) + 12, 0, 255)  # a tint, so chroma is not flat
        out.append(img)
    return out


def _chunks(data: bytes, start: int, end: int):
    while start + 8 <= end:
        cid, n = struct.unpack("<4sI", data[start:start + 8])
        yield cid, start + 8, n
        start += 8 + n + (n & 1)


def avi_parts(data: bytes):
    """(the bytes before movi's chunks, the video chunks' payloads) of a simple AVI."""
    for cid, o, n in _chunks(data, 12, len(data)):
        if cid == b"LIST" and data[o:o + 4] == b"movi":
            return data[:o - 8], [data[o2:o2 + n2] for c2, o2, n2 in _chunks(data, o + 4, o + n) if c2[2:] == b"dc"]
    raise ValueError("no movi list")


def pack_avi(head: bytes, payloads: list) -> bytes:
    """An AVI of ``head`` (RIFF header and hdrl, as avi_parts gives it) and
    the payloads as 00dc chunks, with an idx1 index."""
    movi, idx, off = bytearray(b"movi"), bytearray(), 4
    for p in payloads:
        idx += struct.pack("<4sIII", b"00dc", 0x10, off, len(p))
        movi += struct.pack("<4sI", b"00dc", len(p)) + p + b"\0" * (len(p) & 1)
        off += 8 + len(p) + (len(p) & 1)
    body = bytes(head[12:]) + struct.pack("<4sI", b"LIST", len(movi)) + movi
    body += struct.pack("<4sI", b"idx1", len(idx)) + idx
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI " + body


def bgr24_avi(imgs: list, fps: int, top_down: bool) -> bytes:
    """An uncompressed 24-bit BI_RGB AVI (rows padded to 4 bytes)."""
    h, w = imgs[0].shape[:2]
    stride = (3 * w + 3) & ~3
    payloads = []
    for img in imgs:
        rows = img if top_down else img[::-1]
        buf = np.zeros((h, stride), np.uint8)
        buf[:, :3 * w] = rows.reshape(h, 3 * w)
        payloads.append(buf.tobytes())
    avih = struct.pack("<10I4I", 1000000 // fps, 0, 0, 0x10, len(imgs), 0, 1, stride * h, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHH8I4h", b"vids", b"\0\0\0\0", 0, 0, 0, 0, 1, fps, 0, len(imgs), stride * h,
                       0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, 24, 0, stride * h, 0, 0, 0, 0)

    def chunk(cid, b):
        return struct.pack("<4sI", cid, len(b)) + b

    def lst(kind, b):
        return struct.pack("<4sI", b"LIST", 4 + len(b)) + kind + b

    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    return pack_avi(b"RIFF\0\0\0\0AVI " + hdrl, payloads)


def strip_dht(jpeg: bytes) -> bytes:
    out, p = bytearray(jpeg[:2]), 2
    while jpeg[p + 1] != 0xDA:
        n = (jpeg[p + 2] << 8) | jpeg[p + 3]
        if jpeg[p + 1] != 0xC4:
            out += jpeg[p:p + 2 + n]
        p += 2 + n
    return bytes(out + jpeg[p:])


def cv2_write(path: Path, fourcc, fps: float, imgs: list) -> None:
    h, w = imgs[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc) if fourcc else 0, fps, (w, h))
    assert vw.isOpened(), path
    for img in imgs:
        vw.write(img)
    vw.release()


def cv2_read(path: Path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        out.append(img)
    meta = {"fps": cap.get(cv2.CAP_PROP_FPS), "total": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            "fourcc": int(cap.get(cv2.CAP_PROP_FOURCC)), "frames": len(out), "shape": list(out[0].shape)}
    cap.release()
    return out, meta


def lavc_mpeg4(imgs: list, options: dict) -> list:
    """The packets of ffmpeg's mpeg4 encoder (the libavcodec inside cv2's
    wheel, driven through ctypes) for BGR frames, with encoder options that
    cv2's writer does not pass on: 4MV, video packets (resync markers) and
    per-macroblock quantiser changes (dquant)."""
    return [data for data, _, _ in lavc_encode("mpeg4", imgs, options)]


def libav():
    """(libavutil, libavcodec) of cv2's wheel through ctypes, with the
    signatures of the encode and decode calls the fixtures use."""
    import ctypes

    libs = Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs"
    avutil = ctypes.CDLL(str(next(libs.glob("libavutil-*"))), mode=ctypes.RTLD_GLOBAL)
    avcodec = ctypes.CDLL(str(next(libs.glob("libavcodec-*"))), mode=ctypes.RTLD_GLOBAL)
    vp, c = ctypes.c_void_p, ctypes.c_int
    for lib, name, res, args in (
            (avcodec, "avcodec_find_encoder_by_name", vp, [ctypes.c_char_p]),
            (avcodec, "avcodec_find_decoder_by_name", vp, [ctypes.c_char_p]),
            (avcodec, "avcodec_alloc_context3", vp, [vp]), (avutil, "av_opt_set", c, [vp, ctypes.c_char_p,
                                                                                       ctypes.c_char_p, c]),
            (avcodec, "avcodec_open2", c, [vp, vp, vp]), (avutil, "av_frame_alloc", vp, []),
            (avutil, "av_frame_get_buffer", c, [vp, c]), (avutil, "av_frame_make_writable", c, [vp]),
            (avcodec, "av_packet_alloc", vp, []), (avcodec, "av_new_packet", c, [vp, c]),
            (avcodec, "avcodec_send_frame", c, [vp, vp]), (avcodec, "avcodec_receive_packet", c, [vp, vp]),
            (avcodec, "avcodec_send_packet", c, [vp, vp]), (avcodec, "avcodec_receive_frame", c, [vp, vp]),
            (avcodec, "av_packet_unref", None, [vp])):
        getattr(lib, name).restype, getattr(lib, name).argtypes = res, args
    return avutil, avcodec


def lavc_encode(encoder: str, imgs: list, options: dict, pts: bool = False, two_pass: bool = False,
                extradata: list | None = None) -> list:
    """(data, key, pts) of each packet of a libavcodec encoder (the one inside
    cv2's wheel, driven through ctypes) for BGR frames of any size, with the
    encoder's own options; ``pts`` numbers the frames 0, 1, ... (libvpx wants
    timestamps), ``two_pass`` runs a first pass and hands its statistics to
    the second (libvpx's alt-ref frames need both); the encoder's extradata
    is appended to ``extradata`` when one is given. The AVFrame / AVPacket /
    AVCodecContext field offsets are those of libavutil 60 / libavcodec 62."""
    import ctypes

    avutil, avcodec = libav()
    vp = ctypes.c_void_p
    h, w = imgs[0].shape[:2]
    chroma422 = options.get("pixel_format") == "yuv422p"
    codec = avcodec.avcodec_find_encoder_by_name(encoder.encode())
    assert codec, encoder

    def run(extra: dict, stats: bytes | None = None):
        ctx = avcodec.avcodec_alloc_context3(codec)
        for k, v in {"video_size": f"{w}x{h}", "pixel_format": "yuv420p", "time_base": "1/25", **options,
                     **extra}.items():
            assert avutil.av_opt_set(ctx, k.encode(), v.encode(), 1) >= 0, k
        keep = None
        if stats is not None:  # AVCodecContext.stats_in, the pointer after stats_out
            keep = ctypes.create_string_buffer(stats)
            ctypes.cast(ctx, ctypes.POINTER(vp))[run.stats_out + 1] = ctypes.addressof(keep)
        assert avcodec.avcodec_open2(ctx, codec, None) == 0
        frame, pkt = avutil.av_frame_alloc(), avcodec.av_packet_alloc()
        ints, ptrs = ctypes.cast(frame, ctypes.POINTER(ctypes.c_int)), ctypes.cast(frame, ctypes.POINTER(vp))
        ints[26], ints[27], ints[29] = w, h, 4 if chroma422 else 0  # width, height, format (yuv422p, yuv420p)
        assert avutil.av_frame_get_buffer(frame, 0) == 0
        packets = []

        def drain():
            while avcodec.avcodec_receive_packet(ctx, pkt) == 0:
                words, fields = ctypes.cast(pkt, ctypes.POINTER(vp)), ctypes.cast(pkt, ctypes.POINTER(ctypes.c_int))
                packets.append((ctypes.string_at(words[3], fields[8]), bool(fields[10] & 1),
                                ctypes.cast(pkt, ctypes.POINTER(ctypes.c_int64))[1]))
                avcodec.av_packet_unref(pkt)

        for i, img in enumerate(imgs):
            assert avutil.av_frame_make_writable(frame) == 0
            hh, ww = h + (h & 1), w + (w & 1)  # an odd size: the planes of the image with its edge repeated
            yuv = cv2.cvtColor(cv2.copyMakeBorder(img, 0, hh - h, 0, ww - w, cv2.BORDER_REPLICATE),
                               cv2.COLOR_BGR2YUV_I420).ravel()
            cs = (hh // 2) * (ww // 2)
            planes = (yuv[:hh * ww].reshape(hh, ww)[:h, :w], yuv[hh * ww:hh * ww + cs].reshape(hh // 2, ww // 2),
                      yuv[hh * ww + cs:].reshape(hh // 2, ww // 2))
            if chroma422:  # 4:2:2: each chroma row of the 4:2:0 planes twice
                planes = (planes[0], *(np.repeat(c, 2, axis=0)[:h] for c in planes[1:]))
            for k, plane in enumerate(planes):
                for r in range(plane.shape[0]):
                    ctypes.memmove(ptrs[k] + r * ints[16 + k], np.ascontiguousarray(plane[r]).ctypes.data,
                                   plane.shape[1])
            if pts:
                ctypes.cast(frame, ctypes.POINTER(ctypes.c_int64))[17] = i  # AVFrame.pts
            assert avcodec.avcodec_send_frame(ctx, frame) == 0
            drain()
        avcodec.avcodec_send_frame(ctx, None)
        drain()
        del keep
        if extradata is not None:  # AVCodecContext.extradata and extradata_size
            size = ctypes.cast(ctx, ctypes.POINTER(ctypes.c_int))[20]
            extradata.append(ctypes.string_at(ctypes.cast(ctx, ctypes.POINTER(vp))[9], size) if size else b"")
        return ctx, packets

    if not two_pass:
        return run({})[1]
    ctx, _ = run({"flags": "+pass1"})
    # stats_out: the context's pointer to the first pass's statistics (base64 text)
    regions = [tuple(int(x, 16) for x in line.split()[0].split("-")) for line in open("/proc/self/maps")
               if line.split()[1].startswith("r")]
    words = ctypes.cast(ctx, ctypes.POINTER(vp))
    b64 = set(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/=")
    for i in range(256):
        p = words[i]
        if p and any(a <= p and p + 64 <= b for a, b in regions) and set(ctypes.string_at(p, 64)) <= b64:
            run.stats_out = i
            return run({"flags": "+pass2"}, ctypes.string_at(p))[1]
    raise RuntimeError("no first-pass statistics in the codec context")


PACKED_BYTES = {"bgr0": 4, "bgra": 4, "rgb24": 3, "bgr24": 3, "rgba": 4, "ya8": 2, "gray16be": 2, "ya16be": 4,
                "rgb48be": 6, "rgba64be": 8}  # bytes a pixel of the packed formats


def lavc_encode_planes(encoder: str, frames_: list, pix_fmt: str, options: dict, extradata: list | None = None,
                       width: int = 0, two_pass: bool = False) -> list:
    """(data, key, pts) of each packet of a libavcodec encoder (the one inside
    cv2's wheel, through ctypes) for frames given as their planes in
    ``pix_fmt`` (a list of 2-D uint8 arrays each, a packed format's one plane
    (h, w x bytes a pixel), ``width`` given where that does not tell it),
    with the encoder's own options (``flags`` among them); the encoder's
    extradata is appended to ``extradata`` when one is given. ``two_pass``
    runs a first pass and hands its statistics (text) to the second, as
    ``lavc_encode`` does (FFV1 then codes its contexts' initial states). The
    field offsets are ``lavc_encode``'s."""
    import ctypes

    avutil, avcodec = libav()
    avutil.av_get_pix_fmt.argtypes, avutil.av_get_pix_fmt.restype = [ctypes.c_char_p], ctypes.c_int
    vp = ctypes.c_void_p
    h = frames_[0][0].shape[0]
    codec = avcodec.avcodec_find_encoder_by_name(encoder.encode())
    assert codec, encoder
    fmt = avutil.av_get_pix_fmt(pix_fmt.encode())
    assert fmt >= 0, pix_fmt
    w = width or frames_[0][0].shape[1] // PACKED_BYTES.get(pix_fmt, 1)

    def run(extra: dict, stats: bytes | None = None):
        ctx = avcodec.avcodec_alloc_context3(codec)
        for k, v in {"video_size": f"{w}x{h}", "pixel_format": pix_fmt, "time_base": "1/25", **options,
                     **extra}.items():
            assert avutil.av_opt_set(ctx, k.encode(), str(v).encode(), 1) >= 0, k
        keep = None
        if stats is not None:  # AVCodecContext.stats_in, the pointer after stats_out
            keep = ctypes.create_string_buffer(stats)
            ctypes.cast(ctx, ctypes.POINTER(vp))[run.stats_out + 1] = ctypes.addressof(keep)
        assert avcodec.avcodec_open2(ctx, codec, None) == 0, (encoder, pix_fmt, options)
        frame, pkt = avutil.av_frame_alloc(), avcodec.av_packet_alloc()
        ints, ptrs = ctypes.cast(frame, ctypes.POINTER(ctypes.c_int)), ctypes.cast(frame, ctypes.POINTER(vp))
        ints[26], ints[27], ints[29] = w, h, fmt
        assert avutil.av_frame_get_buffer(frame, 0) == 0
        packets = []

        def drain():
            while avcodec.avcodec_receive_packet(ctx, pkt) == 0:
                words, fields = ctypes.cast(pkt, ctypes.POINTER(vp)), ctypes.cast(pkt, ctypes.POINTER(ctypes.c_int))
                packets.append((ctypes.string_at(words[3], fields[8]), bool(fields[10] & 1),
                                ctypes.cast(pkt, ctypes.POINTER(ctypes.c_int64))[1]))
                avcodec.av_packet_unref(pkt)

        stats = []  # a first pass's statistics (text), after each frame
        for i, planes in enumerate(frames_):
            assert avutil.av_frame_make_writable(frame) == 0
            for k, plane in enumerate(planes):
                for r in range(plane.shape[0]):
                    ctypes.memmove(ptrs[k] + r * ints[16 + k], np.ascontiguousarray(plane[r]).ctypes.data,
                                   plane.shape[1])
            ctypes.cast(frame, ctypes.POINTER(ctypes.c_int64))[17] = i  # AVFrame.pts
            assert avcodec.avcodec_send_frame(ctx, frame) == 0
            drain()
            if "pass1" in extra.get("flags", ""):
                stats.append(first_pass_stats(ctx))
        avcodec.avcodec_send_frame(ctx, None)
        drain()
        del keep
        if extradata is not None and "pass1" not in extra.get("flags", ""):
            size = ctypes.cast(ctx, ctypes.POINTER(ctypes.c_int))[20]  # AVCodecContext.extradata, extradata_size
            extradata.append(ctypes.string_at(ctypes.cast(ctx, ctypes.POINTER(vp))[9], size) if size else b"")
        if "pass1" in extra.get("flags", ""):
            stats.append(first_pass_stats(ctx))
        return b"".join(stats), packets

    def first_pass_stats(ctx) -> bytes:
        """AVCodecContext.stats_out (the word 62 of libavcodec 62's context), text or none."""
        run.stats_out = 62
        p = ctypes.cast(ctx, ctypes.POINTER(vp))[run.stats_out]
        return ctypes.string_at(p) if p else b""

    if not two_pass:
        return run({})[1]
    stats, _ = run({"flags": "+pass1"})
    return run({"flags": "+pass2"}, stats)[1]


def moving(n: int, h: int, w: int, seed: int) -> list:
    """A moving synthetic angiogram: one frame of ``frames`` at twice the
    size, shifted, turned and zoomed a little more each frame (so that
    motion vectors, sub-pixel positions and split MVs occur)."""
    base = frames(1, 2 * h, 2 * w, seed)[0]
    out = []
    for i in range(n):
        m = cv2.getRotationMatrix2D((w, h), 1.5 * i, 1.0 + 0.01 * i)
        m[:, 2] += (2.3 * i, -1.7 * i)
        out.append(cv2.warpAffine(base, m, (2 * w, 2 * h), borderMode=cv2.BORDER_REFLECT)[h // 2:h // 2 + h,
                                                                                        w // 2:w // 2 + w].copy())
    return out


def _ebml(eid: int, payload: bytes, unknown: bool = False) -> bytes:
    n = len(payload)
    size = b"\x01\xff\xff\xff\xff\xff\xff\xff" if unknown else \
        next(((1 << (7 * k)) | n).to_bytes(k, "big") for k in range(1, 9) if n < (1 << (7 * k)) - 1)
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big") + size + payload


def _uint(eid: int, v: int) -> bytes:
    return _ebml(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def mkv_bytes(codec_id: str, w: int, h: int, packets: list, doctype: str = "webm", private: bytes = b"",
              default_duration: int | None = None, duration: float | None = None, unknown: bool = False,
              block_groups: bool = False, cluster_frames: int = 0, cues: bool = True, extras: bool = False,
              colour_space: bytes = b"", track_extra: bytes = b"", block_flags: int = 0) -> bytes:
    """A Matroska / WebM file of one video track: packets are (data, key,
    timestamp in ms). ``unknown``: a Segment and Clusters of unknown size
    (ffmpeg's live layout); ``block_groups``: Blocks in BlockGroups (with a
    ReferenceBlock on inter frames); ``cluster_frames``: frames per cluster;
    ``extras``: CRC-32, Void, SeekHead and Tags elements on the way;
    ``track_extra``: elements added to the TrackEntry; ``block_flags``: bits
    set in each SimpleBlock's flags (lacing)."""
    crc = _ebml(0xBF, b"\0\0\0\0") if extras else b""
    head = _ebml(0x1A45DFA3, _uint(0x4286, 1) + _uint(0x42F7, 1) + _uint(0x42F2, 4) + _uint(0x42F3, 8) +
                 _ebml(0x4282, doctype.encode()) + _uint(0x4287, 4 if doctype == "matroska" else 2) +
                 _uint(0x4285, 2))
    info = crc + _uint(0x2AD7B1, 1000000) + _ebml(0x4D80, b"make.py") + _ebml(0x5741, b"make.py")
    if duration is not None:
        info += _ebml(0x4489, struct.pack(">d", float(duration)))
    video = _uint(0xB0, w) + _uint(0xBA, h) + (_ebml(0x2EB524, colour_space) if colour_space else b"")
    entry = _uint(0xD7, 1) + _uint(0x73C5, 1) + _uint(0x9C, 0) + _ebml(0x86, codec_id.encode()) + _uint(0x83, 1)
    if default_duration:
        entry += _uint(0x23E383, default_duration)
    entry += _ebml(0xE0, video) + (_ebml(0x63A2, private) if private else b"") + track_extra
    body = _ebml(0x1549A966, info) + _ebml(0x1654AE6B, crc + _ebml(0xAE, entry))
    if extras:
        body = _ebml(0x114D9B74, _ebml(0x4DBB, _ebml(0x53AB, b"\x15\x49\xa9\x66") + _uint(0x53AC, 0))) + \
            _ebml(0xEC, bytes(20)) + body + _ebml(0x1254C367, _ebml(0x7373, _ebml(0x63C0, b"")))
    clusters, step = [], cluster_frames or len(packets)
    for c in range(0, len(packets), step):
        group = packets[c:c + step]
        t0 = group[0][2]
        cl = (crc if c else b"") + _uint(0xE7, t0) + (_ebml(0xEC, bytes(3)) if extras else b"")
        for data, key, ts in group:
            blk = b"\x81" + struct.pack(">h", ts - t0)
            if block_groups:
                cl += _ebml(0xA0, _ebml(0xA1, blk + b"\0" + data) + (b"" if key else _ebml(0xFB, b"\xd8")))
            else:
                cl += _ebml(0xA3, blk + bytes([(0x80 if key else 0) | block_flags]) + data)
        clusters.append((t0, cl))
    out = b"".join(_ebml(0x1F43B675, cl, unknown) for _, cl in clusters)
    if cues and not unknown:
        pos, points = len(body), b""
        for t0, cl in clusters:
            points += _ebml(0xBB, _uint(0xB3, t0) + _ebml(0xB7, _uint(0xF7, 1) + _uint(0xF1, pos)))
            pos += len(_ebml(0x1F43B675, cl))
        out += _ebml(0x1C53BB6B, points)
    return head + _ebml(0x18538067, body + out, unknown)


def mkv_blocks(data: bytes) -> list:
    """The payloads of a Matroska file's SimpleBlocks and Blocks, in order
    (a fixture's own reader, for the tests' sweeps)."""
    out = []

    def num(p, keep):
        n = 9 - data[p].bit_length()
        v = int.from_bytes(data[p:p + n], "big")
        return (v if keep else v & ((1 << (7 * n)) - 1)), n

    def walk(p, end):
        while p < end:
            eid, n1 = num(p, True)
            size, n2 = num(p + n1, False)
            o = p + n1 + n2
            unknown = size == (1 << (7 * n2)) - 1
            if eid in (0x18538067, 0x1F43B675, 0xA0):
                walk(o, len(data) if unknown else o + size)
                if unknown:
                    return
            elif eid in (0xA3, 0xA1):
                _, tl = num(o, False)
                out.append((o + tl + 3, size - tl - 3))
            p = o + size

    walk(0, len(data))
    return out


def digests(imgs: list) -> list:
    return [hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest() for img in imgs]


MKV_CV2 = {  # name: (fourcc, fps, source frames) for cv2's writer
    "mjpg.mkv": ("MJPG", 25, lambda: frames(N, 48, 64, 21)),
    "mp4v.mkv": ("mp4v", 29.97, lambda: frames(N, 48, 64, 22)),
    "vp8.webm": ("VP80", 25, lambda: frames(N, 48, 64, 23)),
    "vp8.mkv": ("VP80", 30, lambda: frames(N, 48, 64, 24)),
    "vp8_odd97x63.webm": ("VP80", 25, lambda: frames(N, 63, 97, 25)),
    "i420.mkv": (None, 25, lambda: frames(N, 32, 48, 26)),
}


def lavc_vp8_clips() -> dict:
    """name -> the bytes of the libvpx clips (see the module's docstring)."""
    ms = 40  # 25 fps
    out = {}

    def webm(name, imgs, options, two_pass=False, **layout):
        h, w = imgs[0].shape[:2]
        packets = lavc_encode("libvpx", imgs, options, pts=True, two_pass=two_pass)
        layout.setdefault("default_duration", 40000000)
        layout.setdefault("duration", ms * len(imgs))
        step = layout.pop("ms", ms)
        out[name] = mkv_bytes("V_VP8", w, h, [(d, k, int(p * step + 0.5)) for d, k, p in packets], **layout)

    clip = moving(16, 64, 80, 31)
    webm("vp8_altref.webm", moving(20, 64, 80, 32), {"auto-alt-ref": "1", "lag-in-frames": "16", "b": "300k",
                                                     "arnr-maxframes": "5", "arnr-strength": "5"}, two_pass=True)
    webm("vp8_keys.webm", clip, {"g": "5"})
    webm("vp8_parts.webm", clip, {"slices": "4"}, block_groups=True, cluster_frames=6, extras=True,
         doctype="matroska")
    webm("vp8_error_resilient.webm", clip, {"error-resilient": "1"})
    webm("vp8_profile1.webm", clip, {"profile": "1"})
    webm("vp8_profile3.webm", clip, {"profile": "3"})
    webm("vp8_odd97x64.webm", moving(12, 64, 97, 33), {})
    webm("vp8_live.webm", moving(12, 48, 64, 34), {}, unknown=True, duration=None, cluster_frames=5)
    webm("big512.webm", moving(16, 512, 512, 36), {"b": "400k", "g": "8"})
    webm("vp8_no_default_duration.webm", moving(12, 48, 64, 35), {}, default_duration=None, ms=1001 / 30,
         duration=round(12 * 1001 / 30))
    return out


def mkv_clips() -> dict:
    """name -> (bytes of each Matroska / WebM fixture)."""
    out = {}
    for name, (fourcc, fps, make) in MKV_CV2.items():
        cv2_write(HERE / name, fourcc, fps, make())
        out[name] = (HERE / name).read_bytes()
    out.update(lavc_vp8_clips())
    # a V_MS/VFW/FOURCC track: cv2's MJPG frames behind a BITMAPINFOHEADER
    mj = out["mjpg.mkv"]
    bih = struct.pack("<IiiHH4sIiiII", 40, 64, 48, 1, 24, b"MJPG", 64 * 48 * 3, 0, 0, 0, 0)
    out["mjpeg_vfw.mkv"] = mkv_bytes("V_MS/VFW/FOURCC", 64, 48,
                                     [(mj[o:o + n], True, 40 * i) for i, (o, n) in enumerate(mkv_blocks(mj))],
                                     doctype="matroska", private=bih, default_duration=40000000, duration=40 * N)
    return out


def _ts(marker: int, t: int) -> bytes:
    return bytes([marker | ((t >> 29) & 0x0E) | 1, (t >> 22) & 0xFF, ((t >> 14) & 0xFE) | 1, (t >> 7) & 0xFF,
                  ((t << 1) & 0xFE) | 1])


def ps_bytes(packets: list, fps: float, mpeg2: bool = False, extras: bool = False, drop: int = 0) -> bytes:
    """An MPEG-PS of video packets (data, key, display index) in decode
    order, as ffmpeg's mpeg muxer stamps them for MPEG video: PTS 0.5 s +
    (display index + 1) frames, DTS 0.5 s + decode index frames (written
    when it differs), each frame opening a PES packet of its own in packs
    of 2048 bytes. ``mpeg2``: MPEG-2 pack and PES headers (else MPEG-1's,
    with stuffing and STD fields); ``extras``: an audio and a private
    stream's packets on the way; ``drop``: the first packets left out (a
    stream cut at a later GOP)."""
    tick = 90000 / fps
    out, pack = bytearray(), bytearray()

    def head():
        if mpeg2:
            h = b"\x00\x00\x01\xba" + bytes([0x44, 0, 4, 0, 4, 1, 0x01, 0x89, 0xC3, 0xF8])
        else:
            h = b"\x00\x00\x01\xba" + _ts(0x20, len(out) // 2048) + b"\x80\x1b\x83"
        if not out:
            h += b"\x00\x00\x01\xbb\x00\x0c\x80\x1b\x83\x04\xe1\xff\xe0\xe0\xe6\xc0\xc0\x20"
        return h

    def flush():
        nonlocal pack
        h = head()
        room = 2048 - len(h) - len(pack)
        pad = b"\x00\x00\x01\xbe" + (room - 6).to_bytes(2, "big") + b"\xff" * (room - 6) if room else b""
        out.extend(h + pack + pad)
        pack = bytearray()

    def pes_head(pts=None, dts=None) -> bytes:
        if mpeg2:
            flags = (0x80 if pts is not None else 0) | (0x40 if dts is not None else 0)
            opt = (_ts(0x30 if dts is not None else 0x20, pts) if pts is not None else b"") + \
                (_ts(0x10, dts) if dts is not None else b"")
            return bytes([0x81, flags, len(opt)]) + opt
        return b"\xff\xff" + (b"" if pts is None else b"\x40\x20") + (
            (_ts(0x30, pts) + _ts(0x10, dts)) if dts is not None else _ts(0x20, pts) if pts is not None else b"\x0f")

    def put(sid: int, h: bytes, body: bytes):
        pack.extend(b"\x00\x00\x01" + bytes([sid]) + (len(h) + len(body)).to_bytes(2, "big") + h + body)

    def room() -> int:  # what is left of the pack, keeping 6 bytes for a padding packet's header
        return 2048 - len(head()) - len(pack) - 6

    for dec, (data, _, shown) in enumerate(packets):
        if dec < drop:
            continue
        pts, dts = 45000 + round((shown + 1) * tick), 45000 + round(dec * tick)
        if extras and dec % 3 == 1:
            for sid, h, body in ((0xC0, pes_head(pts), bytes(range(40))), (0xBD, pes_head(), b"\x80" + bytes(30))):
                if room() < 6 + len(h) + len(body):
                    flush()
                put(sid, h, body)
        off = 0
        while off < len(data):
            h = pes_head(pts, dts if dts != pts else None) if off == 0 else pes_head()
            if room() < 6 + len(h) + 16:
                flush()
                continue
            n = min(room() - 6 - len(h), len(data) - off)
            put(0xE0, h, data[off:off + n])
            off += n
    if pack:
        flush()
    return bytes(out) + b"\x00\x00\x01\xb9"


def progressive_frames(es: bytes) -> bytes:
    """MPEG-2 video with progressive_frame set in every picture coding
    extension. cv2 (its swscale) refuses to convert a frame flagged
    interlaced and hands on a stale buffer, so the clips with field DCT,
    field prediction and alternate scan carry the flag set; no decoder
    reads it to decode."""
    b = bytearray(es)
    i = b.find(b"\x00\x00\x01\xb5")
    while i >= 0:
        if b[i + 4] >> 4 == 8:
            b[i + 8] |= 0x80
        i = b.find(b"\x00\x00\x01\xb5", i + 4)
    return bytes(b)


ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
          21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60,
          61, 54, 47, 55, 62, 63]
DEFAULT_INTRA = [8, 16, 19, 22, 26, 27, 29, 34, 16, 16, 22, 24, 27, 29, 34, 37, 19, 22, 26, 27, 29, 34, 34, 38, 22, 22, 26,
                 27, 29, 34, 37, 40, 22, 26, 27, 29, 32, 35, 40, 48, 26, 27, 29, 32, 35, 40, 48, 58, 26, 27, 29, 34, 38,
                 46, 56, 69, 27, 29, 35, 38, 46, 56, 69, 83]
# matrices the encoder did not use, in zigzag order: the decoder dequantises with them all the same
LOADED_INTRA = [8] + [DEFAULT_INTRA[ZIGZAG[i]] + i * 7 % 9 for i in range(1, 64)]
LOADED_NON_INTRA = [16 + i % 11 for i in range(64)]


def load_matrices(data: bytes, ext: bool = False) -> bytes:
    """MPEG-1/2 video with LOADED_INTRA and LOADED_NON_INTRA loaded in each
    sequence header (the encoder loads none), and with ``ext`` a quant
    matrix extension after each picture coding extension loading the
    non-intra matrix reversed."""
    def bits(v: list) -> str:
        return "".join(f"{x:08b}" for x in v)

    out, i = bytearray(), 0
    while True:
        j = data.find(b"\x00\x00\x01\xb3", i)
        if j < 0:
            break
        head = "".join(f"{b:08b}" for b in data[j + 4:j + 12])[:62]
        body = head + "1" + bits(LOADED_INTRA) + "1" + bits(LOADED_NON_INTRA)
        out += data[i:j + 4] + int(body, 2).to_bytes(len(body) // 8, "big")
        i = j + 12
    data = bytes(out + data[i:])
    if not ext:
        return data
    out, i = bytearray(), 0
    while True:
        j = data.find(b"\x00\x00\x01\xb5", i)
        while j >= 0 and data[j + 4] >> 4 != 8:
            j = data.find(b"\x00\x00\x01\xb5", j + 4)
        if j < 0:
            break
        k = data.find(b"\x00\x00\x01", j + 4)
        quant = "0011" + "0" + "1" + bits(LOADED_NON_INTRA[::-1]) + "0" + "0"
        out += data[i:k] + b"\x00\x00\x01\xb5" + int(quant, 2).to_bytes(len(quant) // 8, "big")
        i = k
    return bytes(out + data[i:])


def lavc_packets(encoder: str, imgs: list, options: dict, patch=None) -> list:
    """(data, key, display index) of each MPEG-1/2 packet in decode order."""
    out = [(d, k, int(p)) for d, k, p in lavc_encode(encoder, imgs, options, pts=True)]
    return [(patch(d), k, p) for d, k, p in out] if patch else out


MPEG_CV2 = {  # name: (fourcc, fps, source frames) for cv2's writer
    "pim1.mpg": ("PIM1", 30, lambda: frames(N, 48, 64, 41)),
    "mpeg2.mpg": ("MPEG", 25, lambda: frames(N, 48, 64, 42)),
    "mp4v.mpg": ("mp4v", 29.97, lambda: frames(N, 48, 64, 43)),
    "pim1.avi": ("PIM1", 25, lambda: frames(N, 48, 64, 44)),
    "mpeg2.avi": ("MPEG", 30, lambda: frames(N, 48, 64, 45)),
    "pim1.mp4": ("PIM1", 25, lambda: frames(N, 48, 64, 46)),
    "mpeg2.mp4": ("MPEG", 25, lambda: frames(N, 48, 64, 47)),
    "pim1.mkv": ("PIM1", 25, lambda: frames(N, 48, 64, 48)),
    "mpeg2.mkv": ("MPEG", 29.97, lambda: frames(N, 48, 64, 49)),
}


def mpeg_clips() -> dict:
    """name -> bytes of the MPEG-1/2 clips of libavcodec's encoders, over
    the moving synthetic angiogram (see the module's docstring)."""
    clip = moving(12, 48, 64, 51)
    m2, m1 = "mpeg2video", "mpeg1video"
    out = {
        "m2v_bframes.mpg": ps_bytes(lavc_packets(m2, clip, {"bf": "2", "g": "6"}), 25),
        "m2v_field.mpg": ps_bytes(lavc_packets(m2, clip, {"flags": "+ildct+ilme", "bf": "2", "g": "6"},
                                               progressive_frames), 25, mpeg2=True),
        "m2v_altscan.mpg": ps_bytes(lavc_packets(m2, clip, {"alternate_scan": "1", "intra_vlc": "1",
                                                            "intra_dc_precision": "2", "bf": "1"}, progressive_frames),
                                    30000 / 1001, mpeg2=True, extras=True),
        "m2v_422.mpg": ps_bytes(lavc_packets(m2, clip, {"pixel_format": "yuv422p", "bf": "2", "intra_dc_precision": "1"}), 25, mpeg2=True),
        "m2v_tools.mpg": ps_bytes(lavc_packets(m2, clip, {"non_linear_quant": "1", "qmax": "28", "bf": "3", "g": "6",
                                                          "mbd": "rd", "mpv_flags": "+naq", "intra_dc_precision": "3",
                                                          "seq_disp_ext": "always", "lumi_mask": "0.4", "dark_mask": "0.3"},
                                               lambda d: load_matrices(d, ext=True)), 30),
        "m2v_opengop.mpg": ps_bytes(lavc_packets(m2, moving(14, 48, 64, 52), {"bf": "2", "g": "6"}), 25, drop=4),
        "m2v_odd97x63.mpg": ps_bytes(lavc_packets(m2, moving(10, 63, 97, 53), {"bf": "2"}), 25),
        "m2v_odd97x64.mpg": ps_bytes(lavc_packets(m2, moving(10, 64, 97, 58), {"bf": "2"}), 25),
        "m1v_intra.mpg": ps_bytes(lavc_packets(m1, clip, {"g": "1", "qmin": "1", "qmax": "2", "b": "8M"}), 25),
        "m1v_naq.mpeg": ps_bytes(lavc_packets(m1, clip, {"bf": "2", "g": "6", "lumi_mask": "0.4",
                                                         "dark_mask": "0.3", "qmin": "2", "qmax": "12", "mbd": "rd",
                                                         "mpv_flags": "+naq+qp_rd"}, load_matrices),
                                 24, extras=True),
        "m1v_es.mpg": b"".join(d for d, _, _ in lavc_packets(m1, moving(8, 48, 64, 54), {"bf": "1"})),
        "big512.mpg": ps_bytes(lavc_packets(m2, moving(16, 512, 512, 55), {"bf": "2", "g": "8", "b": "300k", "qmin": "12"}), 25),
        "big512_m1.mpeg": ps_bytes(lavc_packets(m1, moving(8, 512, 512, 56), {"bf": "2", "b": "300k", "qmin": "12"}), 25),
    }
    for name, w in (("vp8_lavc97x63.webm", 97), ("vp8_lavc96x63.webm", 96)):
        packets = lavc_encode("libvpx", moving(10, 63, w, 57), {}, pts=True)
        out[name] = mkv_bytes("V_VP8", w, 63, [(d, k, int(p * 40)) for d, k, p in packets],
                              default_duration=40000000, duration=400)
    return out


# ------------------------------------------------------------------ MPEG-4 Advanced Simple profile

def avi_bytes(payloads: list, w: int, h: int, rate: int, scale: int, fourcc: bytes, extradata: bytes = b"",
              bits: int = 24) -> bytes:
    """An AVI of one video stream under ``fourcc`` (strh's handler and
    strf's compression, ``extradata`` after its BITMAPINFOHEADER of ``bits``
    a pixel), its chunks in the order given (decode order), at rate / scale
    frames a second, with an idx1 index."""
    n = len(payloads)
    avih = struct.pack("<10I4I", 1000000 * scale // rate, 0, 0, 0x10, n, 0, 1, 0, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHH8I4h", b"vids", fourcc, 0, 0, 0, 0, scale, rate, 0, n, 0, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), w, h, 1, bits, fourcc, w * h * 3, 0, 0, 0, 0) + extradata

    def chunk(cid, b):  # padded to an even size, as RIFF wants
        return struct.pack("<4sI", cid, len(b)) + b + b"\0" * (len(b) & 1)

    def lst(kind, b):
        return struct.pack("<4sI", b"LIST", 4 + len(b)) + kind + b

    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    return pack_avi(b"RIFF\0\0\0\0AVI " + hdrl, payloads)


def mp4_bytes(packets: list, w: int, h: int, fps: int, trim: int = 0, entry: bytes | None = None) -> bytes:
    """An MP4 of MPEG-4 Part 2 packets (data, key, display index) in decode
    order, laid out as ffmpeg's mov muxer writes B-VOPs: decode times one
    frame apart, composition offsets (ctts) to the display times shifted by
    the reordering delay, and an edit list from that delay on, which shows
    every frame; ``trim`` frames more left out at the start of the edit. The
    VOL stays in the first sample and is copied into the esds. ``entry``:
    another sample entry box in place of the mp4v one (an avc1 of H.264
    samples, ``h264_writer.avc1_entry``)."""
    ts, delta = fps * 512, 512
    n = len(packets)
    shift = max(dec - shown for dec, (_, _, shown) in enumerate(packets)) + 1
    offsets = [(shown + shift - dec) * delta for dec, (_, _, shown) in enumerate(packets)]
    first = packets[0][0]
    vol = first[:first.find(b"\x00\x00\x01\xb6")] if entry is None else b""

    def box(t: bytes, payload: bytes) -> bytes:
        return struct.pack(">I4s", 8 + len(payload), t) + payload

    def desc(tag: int, body: bytes) -> bytes:
        k = len(body)
        return bytes([tag, 0x80 | (k >> 21) & 0x7F, 0x80 | (k >> 14) & 0x7F, 0x80 | (k >> 7) & 0x7F, k & 0x7F]) + body

    ftyp = box(b"ftyp", b"isom\0\0\2\0isomiso2mp41")
    mdat_start = len(ftyp) + 8
    sizes = [len(d) for d, _, _ in packets]
    duration = (n - trim) * delta
    movie_duration = duration * 1000 // ts
    matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
    mvhd = struct.pack(">IIIII", 0, 0, 0, 1000, movie_duration) + struct.pack(">IH10x", 0x10000, 0x100) + matrix + \
        b"\0" * 24 + struct.pack(">I", 2)
    tkhd = struct.pack(">IIIII4xI8xHHH2x", 3, 0, 0, 1, 0, movie_duration, 0, 0, 0) + matrix + \
        struct.pack(">II", w << 16, h << 16)
    elst = box(b"elst", struct.pack(">IIIiHH", 0, 1, movie_duration, (shift + trim) * delta, 1, 0))
    mdhd = struct.pack(">IIIIIHH", 0, 0, 0, ts, n * delta, 0x55C4, 0)
    hdlr = struct.pack(">II4s12x", 0, 0, b"vide") + b"VideoHandler\0"
    dref = box(b"dref", struct.pack(">II", 0, 1) + box(b"url ", struct.pack(">I", 1)))
    dcd = desc(4, struct.pack(">BB3sII", 0x20, 0x11, max(sizes).to_bytes(3, "big"), 0, 0) + desc(5, vol))
    esds = box(b"esds", struct.pack(">I", 0) + desc(3, struct.pack(">HB", 1, 0) + dcd + desc(6, b"\x02")))
    mp4v = box(b"mp4v", b"\0" * 6 + struct.pack(">H", 1) + b"\0" * 16 + struct.pack(">HHIIIH", w, h, 0x480000, 0x480000,
                                                                                      0, 1) + b"\0" * 32 +
               struct.pack(">Hh", 24, -1) + esds)
    runs: list = []
    for o in offsets:
        if runs and runs[-1][1] == o:
            runs[-1][0] += 1
        else:
            runs.append([1, o])
    stbl = box(b"stbl", box(b"stsd", struct.pack(">II", 0, 1) + (mp4v if entry is None else entry)) +
               box(b"stts", struct.pack(">IIII", 0, 1, n, delta)) +
               box(b"ctts", struct.pack(">II", 0, len(runs)) + b"".join(struct.pack(">II", c, o) for c, o in runs)) +
               box(b"stss", struct.pack(">II", 0, sum(k for _, k, _ in packets)) +
                   b"".join(struct.pack(">I", i + 1) for i, (_, k, _) in enumerate(packets) if k)) +
               box(b"stsc", struct.pack(">IIIII", 0, 1, 1, n, 1)) +
               box(b"stsz", struct.pack(">III", 0, 0, n) + b"".join(struct.pack(">I", x) for x in sizes)) +
               box(b"stco", struct.pack(">III", 0, 1, mdat_start)))
    minf = box(b"minf", box(b"vmhd", struct.pack(">I4H", 1, 0, 0, 0, 0)) + box(b"dinf", dref) + stbl)
    trak = box(b"trak", box(b"tkhd", tkhd) + box(b"edts", elst) +
               box(b"mdia", box(b"mdhd", mdhd) + box(b"hdlr", hdlr) + minf))
    return ftyp + box(b"mdat", b"".join(d for d, _, _ in packets)) + box(b"moov", box(b"mvhd", mvhd) + trak)


def woven(n: int, h: int, w: int, seed: int) -> list:
    """Interlaced frames: each the even rows of one ``moving`` frame and the
    odd rows of the next (two fields a field period apart), so that an
    encoder picks field DCT and field motion."""
    src = moving(2 * n, h, w, seed)
    out = []
    for k in range(n):
        f = src[2 * k].copy()
        f[1::2] = src[2 * k + 1][1::2]
        out.append(f)
    return out


def mpeg4_packets(imgs: list, options: dict) -> list:
    """(data, key, display index) of each packet of libavcodec's mpeg4
    encoder, in decode order."""
    return [(d, k, int(p)) for d, k, p in lavc_encode("mpeg4", imgs, options, pts=True)]


def user_data(data: bytes, text: bytes) -> bytes:
    """data with its user data (the encoder's name, 'Lavc...') replaced by
    text (empty: the user data start code and all taken out)."""
    i = data.find(b"\x00\x00\x01\xb2")
    if i < 0:
        return data
    j = data.find(b"\x00\x00\x01", i + 4)
    return data[:i] + (b"\x00\x00\x01\xb2" + text if text else b"") + data[j:]


def vop_kind(data: bytes) -> int:
    """The type of the first VOP in data: 0 I, 1 P, 2 B, 3 S."""
    i = data.find(b"\x00\x00\x01\xb6")
    return data[i + 4] >> 6


NVOP = b"\x00\x00\x01\xb6\x50\x00"  # a P-VOP of vop_coded 0: DivX's placeholder chunk (time bits left at 0)


def pack_divx(payloads: list) -> list:
    """DivX's packed bitstream from an unpacked one of single B-VOPs: each
    reference with the B-VOP after it in one chunk, a placeholder N-VOP
    chunk in the B-VOP's place, and the user data 'DivX503b1393p' (the
    inverse of ffmpeg's mpeg4_unpack_bframes)."""
    out, i = [], 0
    while i < len(payloads):
        d = payloads[i]
        if i + 1 < len(payloads) and vop_kind(payloads[i + 1]) == 2:
            assert i + 2 >= len(payloads) or vop_kind(payloads[i + 2]) != 2, "two B-VOPs in a row"
            out += [d + payloads[i + 1], NVOP]
            i += 2
        else:
            out.append(d)
            i += 1
    out[0] = user_data(out[0], b"DivX503b1393p")
    return out


def vol_matrices(data: bytes, intra: list, inter: list) -> bytes:
    """data with its VOL (quant_type 1, no matrices loaded) loading intra
    and inter (values in zigzag order; a list shorter than 64 ends with a 0,
    the last value repeated)."""
    m = data.find(b"\x00\x00\x01\x20")
    end = data.find(b"\x00\x00\x01", m + 4)
    bits = "".join(f"{b:08b}" for b in data[m + 4:end])
    p = 1 + 8
    verid = 1
    if bits[p] == "1":
        verid = int(bits[p + 1:p + 5], 2)
        p += 8
    else:
        p += 1
    p += 4 + (16 if bits[p:p + 4] == "1111" else 0)
    if bits[p] == "1":  # vol_control_parameters: chroma_format, low_delay, vbv_parameters
        p += 4
        p += 1 + (79 if bits[p] == "1" else 0)
    else:
        p += 1
    assert bits[p:p + 2] == "00"
    p += 2 + 1
    res = int(bits[p:p + 16], 2)
    tb = max(1, (res - 1).bit_length())
    p += 16 + 1
    p += 1 + (tb if bits[p] == "1" else 0)
    p += 1 + 13 + 1 + 13 + 1 + 1 + 1 + (1 if verid == 1 else 2) + 1  # marker, w, marker, h, marker, interlaced, obmc, sprite, not_8_bit
    assert bits[p:p + 3] == "100", "quant_type 1 with no matrices loaded"
    load = "1" + "".join(f"{v:08b}" for v in intra) + "1" + "".join(f"{v:08b}" for v in inter)
    bits = bits[:p + 1] + load + bits[p + 3:]
    body = bits.rstrip("1")[:-1]  # the stuffing (a 0, then 1s) redone
    body += "0" + "1" * (-(len(body) + 1) % 8)
    return data[:m + 4] + int(body, 2).to_bytes(len(body) // 8, "big") + data[end:]


def lavc_planes(packets: list, fourcc: bytes = b"", decoder: str = "mpeg4") -> list:
    """The Y, U and V planes of each frame libavcodec's mpeg4 decoder (the
    one inside cv2's wheel, through ctypes) gives for the packets: the oracle
    of interlaced clips, whose frames cv2 cannot convert (it hands on a stale
    buffer for a frame flagged interlaced); ``decoder`` another of its
    decoders (``h264``: the reference pictures of ``h264_writer.encode``). The AVFrame / AVPacket /
    AVCodecContext field offsets are those of libavutil 60 / libavcodec 62."""
    import ctypes

    avutil, avcodec = libav()
    vp = ctypes.c_void_p
    codec = avcodec.avcodec_find_decoder_by_name(decoder.encode())
    ctx = avcodec.avcodec_alloc_context3(codec)
    if fourcc:
        ctypes.cast(ctx, ctypes.POINTER(ctypes.c_uint32))[7] = int.from_bytes(fourcc, "little")  # codec_tag
    assert avcodec.avcodec_open2(ctx, codec, None) == 0
    frame, pkt = avutil.av_frame_alloc(), avcodec.av_packet_alloc()
    out = []

    def drain():
        while avcodec.avcodec_receive_frame(ctx, frame) == 0:
            ptrs, ints = ctypes.cast(frame, ctypes.POINTER(vp)), ctypes.cast(frame, ctypes.POINTER(ctypes.c_int))
            w, h = ints[26], ints[27]
            planes = []
            for k, (pw, ph) in enumerate(((w, h), ((w + 1) // 2, (h + 1) // 2), ((w + 1) // 2, (h + 1) // 2))):
                rows = np.frombuffer(ctypes.string_at(ptrs[k], ints[16 + k] * ph), np.uint8).reshape(ph, -1)
                planes.append(rows[:, :pw].copy())
            out.append(planes)

    for data in packets:
        assert avcodec.av_new_packet(pkt, len(data)) == 0
        ctypes.memmove(ctypes.cast(pkt, ctypes.POINTER(vp))[3], data, len(data))
        avcodec.avcodec_send_packet(ctx, pkt)
        avcodec.av_packet_unref(pkt)
        drain()
    avcodec.avcodec_send_packet(ctx, None)
    drain()
    return out


def plane_digests(frames_: list) -> list:
    """The SHA-256 of each frame's Y, U and V planes, joined."""
    return [hashlib.sha256(b"".join(np.ascontiguousarray(p).tobytes() for p in f)).hexdigest() for f in frames_]


ASP_XVID = {  # the encoder's identity, rewritten: (user data, AVI fourcc)
    "xvid": (b"XviD0050", b"XVID"), "xvid_fourcc": (b"", b"XVID"), "divx": (b"DivX503b1393", b"DIVX")}


def asp_clips() -> dict:
    """name -> (bytes, oracle) of the MPEG-4 Advanced Simple profile clips
    of libavcodec's mpeg4 encoder over the moving synthetic angiogram (see
    ``asp_main``); oracle "cv2", or "planes" (libavcodec's planes) with the
    packets to decode."""
    def moving_clip(seed, n=12, h=48, w=64):
        return moving(n, h, w, seed)

    def avi(packets, w=64, h=48, fourcc=b"XVID", rate=25, scale=1):
        return avi_bytes([d for d, _, _ in packets], w, h, rate, scale, fourcc)

    bf2 = mpeg4_packets(moving_clip(71), {"bf": "2", "g": "8", "flags": "+mv4"})
    bf1 = mpeg4_packets(moving_clip(72), {"bf": "1", "flags": "+qpel"})
    out = {
        "asp_bf2.avi": (avi(bf2), "cv2"),
        "asp_bf2.mp4": (mp4_bytes(bf2, 64, 48, 25), "cv2"),
        "asp_bf2_trim.mp4": (mp4_bytes(bf2, 64, 48, 25, trim=2), "cv2"),
        "asp_bf2.mkv": (mkv_bytes("V_MPEG4/ISO/ASP", 64, 48, [(d, k, 40 * p) for d, k, p in bf2], doctype="matroska",
                                  default_duration=40000000, duration=40 * len(bf2)), "cv2"),
        "asp_bf2.mpg": (ps_bytes(bf2, 25), "cv2"),
        "asp_bf1.avi": (avi(bf1, rate=30000, scale=1001), "cv2"),
        "asp_bf1.mp4": (mp4_bytes(bf1, 64, 48, 30), "cv2"),
        "asp_bf1.mkv": (mkv_bytes("V_MPEG4/ISO/ASP", 64, 48, [(d, k, 40 * p) for d, k, p in bf1], doctype="matroska",
                                  default_duration=40000000, duration=40 * len(bf1)), "cv2"),
        "asp_bf1.mpg": (ps_bytes(bf1, 25), "cv2"),
        "asp_packed.avi": (avi_bytes(pack_divx([d for d, _, _ in mpeg4_packets(moving_clip(73), {"bf": "1"})]), 64, 48,
                                     25, 1, b"DX50"), "cv2"),
        "asp_mpegquant.avi": (avi(mpeg4_packets(moving_clip(74), {"mpeg_quant": "1", "bf": "1"})), "cv2"),
        "asp_qpel.avi": (avi(mpeg4_packets(moving_clip(76), {"flags": "+qpel+mv4"})), "cv2"),
        "asp_qpel_bf.avi": (avi(mpeg4_packets(moving_clip(77), {"flags": "+qpel+mv4", "bf": "2", "ps": "60"})), "cv2"),
        "asp_dp.avi": (avi(mpeg4_packets(frames(12, 48, 64, 78), {"data_partitioning": "1", "ps": "60",
                                                                  "flags": "+mv4"})), "cv2"),
        "asp_odd97x63.avi": (avi(mpeg4_packets(moving_clip(79, 10, 63, 97), {"bf": "2", "flags": "+qpel+mv4"}), 97, 63),
                             "cv2"),
    }
    loaded = [d for d, _, _ in mpeg4_packets(moving_clip(75), {"mpeg_quant": "1", "bf": "2"})]
    loaded[0] = vol_matrices(loaded[0], [8] + [12 + i % 23 for i in range(1, 64)], [16 + 3 * i for i in range(20)] + [0])
    out["asp_mpegquant_loaded.avi"] = (avi_bytes(loaded, 64, 48, 25, 1, b"XVID"), "cv2")
    out["asp_es.m4v"] = (b"".join(d for d, _, _ in mpeg4_packets(moving_clip(80), {"bf": "2"})), "cv2")
    for name, opts, seed in (("asp_ilace.avi", {"flags": "+ildct+ilme+mv4", "bf": "2"}, 81),
                             ("asp_ilace_qpel.avi", {"flags": "+ildct+ilme+qpel", "bf": "1"}, 82),
                             ("asp_altscan.avi", {"flags": "+ildct+ilme", "alternate_scan": "1", "mpeg_quant": "1"},
                              83)):
        packets = [d for d, _, _ in mpeg4_packets(woven(12, 48, 64, seed), opts)]
        out[name] = (avi_bytes(packets, 64, 48, 25, 1, b"XVID"), ("planes", packets))
    fresh = [d for d, _, _ in mpeg4_packets(moving_clip(84, 12, 63, 97), {"bf": "1", "flags": "+mv4"})]
    for kind, (text, fourcc) in ASP_XVID.items():
        out[f"asp_{kind}.avi"] = (avi_bytes([user_data(d, text) for d in fresh], 97, 63, 25, 1, fourcc), "cv2")
    big = [d for d, _, _ in mpeg4_packets(moving(16, 512, 512, 85), {"bf": "2", "flags": "+qpel+mv4", "b": "400k",
                                                                         "qmin": "10", "g": "16"})]
    out["big512_asp.avi"] = (avi_bytes([user_data(d, b"XviD0050") for d in big], 512, 512, 25, 1, b"XVID"),
                             "cv2")
    return out


def asp_rewrites() -> dict:
    """name -> bytes of lavc_tools.avi and xvid.avi with their encoder's
    identity rewritten three ways (``ASP_XVID``), which the tests make from
    the committed clips and hold to the digests ``asp.json`` keeps."""
    out = {}
    for base in ("lavc_tools.avi", "xvid.avi"):
        head, chunks = avi_parts((HERE / base).read_bytes())
        for kind, (text, fourcc) in ASP_XVID.items():
            out[f"{Path(base).stem}_{kind}.avi"] = pack_avi(head.replace(b"XVID", fourcc),
                                                            [user_data(c, text) for c in chunks])
    return out


def asp_main() -> None:
    """Writes the MPEG-4 Advanced Simple profile fixtures and their oracle,
    ``asp.json``: the SHA-256 of each frame cv2 reads with its fps, count
    and fourcc, or for the interlaced clips (which cv2 cannot convert) the
    SHA-256 of libavcodec's planes; and the digests of the rewrites of
    ``asp_rewrites``, leaving the other fixtures as they are."""
    meta = {}
    for name, (data, oracle) in asp_clips().items():
        (HERE / name).write_bytes(data)
        if oracle == "cv2":
            imgs, meta[name] = cv2_read(HERE / name)
            meta[name]["oracle"] = "cv2, as the SHA-256 of each frame"
            meta[name]["sha256"] = digests(imgs)
        else:
            planes = lavc_planes(oracle[1], b"XVID")
            _, meta[name] = cv2_read(HERE / name)  # fps, count and fourcc; its frames are stale buffers
            assert meta[name]["frames"] == len(planes)
            meta[name]["oracle"] = "libavcodec's Y, U and V planes (cv2 cannot convert interlaced frames)"
            meta[name]["planes_sha256"] = plane_digests(planes)
    for name, data in asp_rewrites().items():
        path = HERE / f"_{name}"
        path.write_bytes(data)
        imgs, meta[name] = cv2_read(path)
        path.unlink()
        meta[name]["oracle"] = "cv2, as the SHA-256 of each frame"
        meta[name]["sha256"] = digests(imgs)
    (HERE / "asp.json").write_text(json.dumps(meta, indent=1, sort_keys=True) + "\n")


def main() -> None:
    """Writes every fixture. cv2's Matroska writer draws random UIDs, so
    its ``.mkv`` / ``.webm`` files come out with other bytes (the same
    frames) each time; ``mpeg_main`` remakes only the MPEG set."""
    h, w = SIZE
    clips = {
        "mjpg.avi": ("MJPG", 25, frames(N, h, w, 1)),
        "xvid.avi": ("XVID", 29.97, frames(N, h, w, 2)),
        "mp4v.mp4": ("mp4v", 30, frames(N, h, w, 3)),
        "mjpeg.mov": ("MJPG", 10, frames(N, h, w, 4)),
        "odd97x63.mp4": ("mp4v", 25, frames(N, 63, 97, 5)),
        "odd97x63.avi": ("MJPG", 25, frames(N, 63, 97, 6)),
        "i420.avi": (None, 25, frames(N, h, w, 7)),
    }
    for name, (fourcc, fps, imgs) in clips.items():
        cv2_write(HERE / name, fourcc, fps, imgs)
    # camera-style MJPEG: libjpeg's frames (the standard tables) with their DHT taken out
    head, _ = avi_parts((HERE / "mjpg.avi").read_bytes())
    jpegs = [cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes() for img in frames(N, h, w, 10)]
    (HERE / "nodht.avi").write_bytes(pack_avi(head, [strip_dht(j) for j in jpegs]))
    # ffmpeg's tools beyond cv2's writer's: 4MV, video packets and dquant, in an XVID AVI
    tools = [np.roll(img, (3 * i, 5 * i), (0, 1)) for i, img in enumerate(frames(N, h, w, 12))]
    packets = lavc_mpeg4(tools, {"flags": "+mv4", "ps": "120", "lumi_mask": "0.4", "dark_mask": "0.3", "mbd": "2",
                                 "qmin": "2", "qmax": "12"})
    (HERE / "lavc_tools.avi").write_bytes(pack_avi(avi_parts((HERE / "xvid.avi").read_bytes())[0], packets))
    rh, rw = RAW_SIZE
    bottom_up = frames(N, rh, rw, 8)
    (HERE / "bgr24.avi").write_bytes(bgr24_avi(bottom_up, 25, top_down=False))
    (HERE / "bgr24_top_down.avi").write_bytes(bgr24_avi(frames(N, rh, rw, 9), 25, top_down=True))
    stored, meta = {}, {}
    for name in sorted([*clips, "nodht.avi", "bgr24_top_down.avi", "lavc_tools.avi"]):
        imgs, meta[name] = cv2_read(HERE / name)
        meta[name]["oracle"] = "cv2"
        stored[name] = np.stack(imgs)
    # cv2 (OpenCV 5.0 with avcodec 62) aborts reading a bottom-up BI_RGB AVI
    # (heap corruption), so its oracle is the frames written, which a reader
    # of uncompressed frames gives back exactly, as cv2 does for top-down rows
    assert (stored["bgr24_top_down.avi"] == np.stack(frames(N, rh, rw, 9))).all()
    stored["bgr24.avi"] = np.stack(bottom_up)
    meta["bgr24.avi"] = {"fps": 25.0, "total": N, "fourcc": 0, "frames": N, "shape": [rh, rw, 3],
                         "oracle": "the frames written"}
    # a 512 x 512 mp4v clip for decode times at the model's size: cv2's frames kept as SHA-256 digests
    cv2_write(HERE / "big512.mp4", "mp4v", 25, frames(N, 512, 512, 11))
    imgs, meta["big512.mp4"] = cv2_read(HERE / "big512.mp4")
    meta["big512.mp4"]["oracle"] = "cv2, as the SHA-256 of each frame"
    meta["big512.mp4"]["sha256"] = [hashlib.sha256(img.tobytes()).hexdigest() for img in imgs]
    np.savez_compressed(HERE / "frames.npz", **stored)
    for name, data in mkv_clips().items():
        (HERE / name).write_bytes(data)
        imgs, meta[name] = cv2_read(HERE / name)
        meta[name]["oracle"] = "cv2, as the SHA-256 of each frame"
        meta[name]["sha256"] = digests(imgs)
    (HERE / "meta.json").write_text(json.dumps(meta, indent=1, sort_keys=True) + "\n")
    mpeg_main()
    wmv_main()


def mpeg_main() -> None:
    """Writes the MPEG-1/2 and odd-height fixtures and their oracle,
    ``mpeg.json`` (the SHA-256 of each frame cv2 reads, its fps, count and
    fourcc), leaving the other fixtures as they are."""
    meta = {}
    for name, (fourcc, fps, make) in MPEG_CV2.items():
        cv2_write(HERE / name, fourcc, fps, make())
    clips = mpeg_clips()
    for name, data in clips.items():
        (HERE / name).write_bytes(data)
    for name in [*MPEG_CV2, *clips]:
        imgs, meta[name] = cv2_read(HERE / name)
        meta[name]["oracle"] = "cv2, as the SHA-256 of each frame"
        meta[name]["sha256"] = digests(imgs)
    (HERE / "mpeg.json").write_text(json.dumps(meta, indent=1, sort_keys=True) + "\n")


WMV_CV2 = {  # name: (fourcc, fps, source frames) for cv2's writer
    "wmv_wmv2.wmv": ("WMV2", 25, lambda: moving(12, 48, 64, 81)),
    "wmv_wmv1.wmv": ("WMV1", 29.97, lambda: frames(8, 48, 64, 82)),
    "wmv_mp43.wmv": ("MP43", 12.5, lambda: moving(12, 48, 64, 83)),
    "wmv_mp42.wmv": ("MP42", 7, lambda: frames(12, 48, 64, 84)),
    "wmv_mp4v_12.5.wmv": ("mp4v", 12.5, lambda: frames(8, 48, 64, 85)),
    "wmv_mp4v_7.wmv": ("mp4v", 7, lambda: moving(12, 48, 64, 86)),
    "wmv_mp4v_29.97.wmv": ("mp4v", 29.97, lambda: frames(8, 48, 64, 87)),
    "wmv_mjpg.wmv": ("MJPG", 25, lambda: frames(12, 48, 64, 88)),
    "wmv_xvid.wmv": ("XVID", 25, lambda: frames(12, 48, 64, 97)),
    "wmv_pim1.wmv": ("PIM1", 25, lambda: moving(12, 48, 64, 98)),
    "wmv_mpg2.wmv": ("mpg2", 25, lambda: frames(12, 48, 64, 99)),
    "wmv_mp43.avi": ("MP43", 25, lambda: frames(12, 50, 66, 89)),
    "wmv_mp42.avi": ("MP42", 25, lambda: moving(12, 66, 50, 90)),
    "wmv_wmv1.avi": ("WMV1", 25, lambda: moving(12, 50, 66, 91)),
    "wmv_wmv2.avi": ("WMV2", 25, lambda: frames(12, 66, 50, 92)),
    "wmv_mp43.mkv": ("MP43", 25, lambda: frames(12, 48, 64, 93)),
    "wmv_mp42.mkv": ("MP42", 25, lambda: frames(12, 48, 64, 94)),
    "wmv_wmv1.mkv": ("WMV1", 25, lambda: moving(12, 48, 64, 95)),
    "wmv_wmv2.mkv": ("WMV2", 25, lambda: moving(12, 48, 64, 96)),
    "wmv_big512.wmv": ("WMV2", 25, lambda: moving(8, 512, 512, 61)),
    "wmv_big512_mp43.avi": ("MP43", 25, lambda: moving(8, 512, 512, 62)),
}


def blocks(n: int, h: int, w: int, seed: int) -> list:
    """``frames`` with its upper left quarter a random board of black and
    white 8x8 blocks, whose DC differences are past the DC tables' codes."""
    rng = np.random.default_rng(seed)
    out = []
    for img in frames(n, h, w, seed):
        board = np.kron(rng.integers(0, 2, (h // 16 + 1, w // 16 + 1)) * 255, np.ones((8, 8), int))
        img[:h // 2, :w // 2] = board[:h // 2, :w // 2, None].astype(np.uint8)
        out.append(img)
    return out


WMV_LAVC = {  # name: (encoder, source frames, options) for libavcodec's encoders, in AVI: the tools cv2's writer
    # leaves off (fixed quantisers, short GOPs, a bit rate low enough for WMV1's inter-intra prediction, WMV2's
    # loop filter)
    "wmv_lavc_mp43_q3.avi": ("msmpeg4", lambda: frames(12, 48, 64, 101), {"qmin": "3", "qmax": "3", "g": "5"}),
    "wmv_lavc_mp43_q24.avi": ("msmpeg4", lambda: moving(12, 48, 64, 102), {"qmin": "24", "qmax": "24", "g": "5"}),
    "wmv_lavc_mp43_97x63.avi": ("msmpeg4", lambda: frames(12, 63, 97, 103), {"qmin": "4", "qmax": "4", "g": "5"}),
    "wmv_lavc_wmv1_q3.avi": ("wmv1", lambda: blocks(12, 48, 64, 104), {"qmin": "3", "qmax": "3", "g": "5",
                                                                        "b": "100000"}),
    "wmv_lavc_wmv1_q12.avi": ("wmv1", lambda: frames(12, 48, 64, 105), {"qmin": "12", "qmax": "12", "g": "5",
                                                                         "b": "100000"}),
    "wmv_lavc_wmv2_q12.avi": ("wmv2", lambda: frames(12, 48, 64, 106), {"qmin": "12", "qmax": "12", "g": "5"}),
    "wmv_lavc_wmv2_q24.avi": ("wmv2", lambda: moving(12, 48, 64, 107), {"qmin": "24", "qmax": "24", "g": "5"}),
    "wmv_lavc_wmv2_loop.avi": ("wmv2", lambda: frames(12, 48, 64, 109), {"qmin": "8", "qmax": "8", "g": "5",
                                                                         "flags": "+loop"}),
    "wmv_lavc_mp42_q24.avi": ("msmpeg4v2", lambda: moving(12, 48, 64, 108), {"qmin": "24", "qmax": "24",
                                                                              "g": "5"}),
}
LAVC_FOURCC = {"msmpeg4v2": b"MP42", "msmpeg4": b"MP43", "wmv1": b"WMV1", "wmv2": b"WMV2"}


def wmv_main() -> None:
    """Writes the ASF / WMV and MS-MPEG-4 family fixtures and their oracle,
    ``wmv.json`` (the SHA-256 of each frame cv2 reads, its fps, count and
    fourcc), leaving the other fixtures as they are: cv2's writer's WMV1,
    WMV2, MP42 and MP43 in ``.wmv``, ``.avi`` and ``.mkv``, its mp4v in
    ``.wmv`` at 12.5, 7 and 29.97 fps, XVID, MJPG, MPEG-1 and MPEG-2 in
    ``.wmv``, two 512 x 512
    clips (WMV2 in ASF, its frames over several packets, and MP43 in AVI),
    and libavcodec's encoders with fixed quantisers in AVI (``WMV_LAVC``)."""
    meta = {}
    for name, (fourcc, fps, make) in WMV_CV2.items():
        cv2_write(HERE / name, fourcc, fps, make())
    for name, (encoder, make, options) in WMV_LAVC.items():
        imgs, extradata = make(), []
        packets = [data for data, _, _ in lavc_encode(encoder, imgs, options, extradata=extradata)]
        h, w = imgs[0].shape[:2]
        (HERE / name).write_bytes(avi_bytes(packets, w, h, 25, 1, LAVC_FOURCC[encoder], extradata[0]))
    for name in [*WMV_CV2, *WMV_LAVC]:
        imgs, meta[name] = cv2_read(HERE / name)
        meta[name]["oracle"] = "cv2, as the SHA-256 of each frame"
        meta[name]["sha256"] = digests(imgs)
    (HERE / "wmv.json").write_text(json.dumps(meta, indent=1, sort_keys=True) + "\n")


# ------------------------------------------------------------------ H.264

# name: (seed, macroblocks across and down, frames, SPS options, PPS options, choices (h264_writer.syntax_clip),
#        container layout: NAL length size (0: start codes), rate (frames a second, as num / den), container size)
H264_SYNTAX = {
    "h264_intra.avi": (211, (6, 4), 4, {}, {"cqp": 3},
                       {"p": 0.0, "qp_range": (0, 51), "slices": 3, "deblock_idc": [0, 1, 2], "idr_every": 2,
                        "i4": 0.6, "pcm": 0.08}, 0, (25, 1), None),
    "h264_inter.mp4": (212, (5, 4), 10, {"refs": 4}, {"refs": 3},
                       {"qp_range": (8, 40), "slices": 2, "deblock_idc": [0, 2], "mods": 0.5, "mmco": 0.3,
                        "big_mvd": 0.2}, 4, (25, 1), None),
    "h264_longterm.mkv": (213, (4, 3), 12, {"refs": 5}, {"refs": 4},
                          {"qp_range": (14, 40), "slices": 2, "deblock_idc": [0, 1, 2], "mods": 0.6, "mmco": 0.6,
                           "idr_long": 1.0}, 2, (25, 1), None),
    "h264_mmco5.avi": (214, (3, 2), 14, {"refs": 3}, {"refs": 2},
                       {"qp_range": (14, 40), "deblock_idc": [0], "mods": 0.5, "mmco": 0.5, "mmco5": 0.3,
                        "non_ref": 0.3, "aud": True}, 0, (30000, 1001), None),
    "h264_poc1.mp4": (215, (2, 2), 10, {"refs": 2, "profile": 77, "poc_type": 1, "poc1": (0, 1, 0, [2])},
                      {"refs": 2}, {"qp_range": (32, 44), "non_ref": 0.3, "pcm": 0.0, "slices": 4,
                                    "deblock_idc": [0]}, 1, (30, 1), None),
    "h264_poc2.avi": (216, (4, 2), 10, {"refs": 2, "poc_type": 2}, {"refs": 2},
                      {"qp_range": (10, 40), "non_ref": 0.3, "deblock_idc": [0, 2], "sei": True}, 0, (30, 1), None),
    "h264_crop_full.mkv": (217, (7, 4), 6, {"refs": 2, "profile": 100, "crop": (0, 7, 1, 1), "full_range": 1},
                           {"refs": 2, "cqp": -4, "cqp2": 6}, {"qp_range": (10, 40), "deblock_idc": [0]}, 4,
                           (30000, 1001), None),
    "h264_odd_full.mp4": (218, (7, 4), 4, {"refs": 1, "full_range": 1}, {},
                          {"qp_range": (10, 40), "deblock_idc": [0]}, 4, (25, 1), (97, 63)),
    "h264_constrained.avi": (219, (5, 4), 8, {"refs": 2}, {"refs": 2, "constrained": 1},
                             {"qp_range": (10, 40), "slices": 3, "deblock_idc": [0, 2], "intra_in_p": 0.4}, 0,
                             (25, 1), None),
    "h264_wrap.avi": (220, (2, 1), 22, {"refs": 2, "log2_max_frame_num": 4}, {"refs": 2},
                      {"qp_range": (20, 40), "mods": 0.5, "non_ref": 0.1, "deblock_idc": [0]}, 0, (25, 1), None),
    "h264_reorder.avi": (221, (3, 2), 10, {"refs": 2, "log2_max_poc_lsb": 5}, {"refs": 2},
                         {"qp_range": (20, 40), "poc_step": 4, "deblock_idc": [0]}, 0, (25, 1), None),
    "h264_clip.mov": (222, (4, 3), 8, {"refs": 2, "timing": (1001, 60000)}, {"refs": 2},
                      {"qp_range": (10, 40), "deblock_idc": [0, 1]}, 4, (30, 1), None),
}
# the Main and High profiles' syntax clips, laid out as H264_SYNTAX's (in MP4 and Matroska at their display
# times); each list of scaling_lists' values a list's zigzag order
_W = [59, 20, 24, 30, 17, 40, 45, 12, 33, 51, 28, 19, 38, 25, 41, 55]  # an Intra Y list of odd DC weight
_W8 = [int(v) for v in np.random.default_rng(8).integers(6, 60, 64)]
H264_HIGH = {
    "h264_cabac_intra.avi": (231, (5, 3), 4, {"profile": 100, "refs": 1}, {"cabac": 1, "t8x8": 1, "cqp": 2, "cqp2": -2},
                             {"p": 0.0, "qp_range": (0, 51), "slices": 2, "deblock_idc": [0, 1, 2], "pcm": 0.08,
                              "i8": 0.6, "idr_every": 2}, 0, (25, 1), None),
    "h264_cabac_p.mp4": (232, (4, 3), 8, {"profile": 77, "refs": 3}, {"cabac": 1, "weighted": 1, "refs": 3},
                         {"qp_range": (10, 40), "slices": 2, "deblock_idc": [0, 2], "dup": 0.5, "mods": 0.3}, 4,
                         (25, 1), None),
    "h264_b_cavlc.avi": (233, (4, 3), 10, {"profile": 100, "refs": 3, "log2_max_poc_lsb": 8, "direct8x8": 0},
                         {"t8x8": 1, "refs": 2, "refs1": 2},
                         {"b": 1, "b_max": 3, "pyramid": 1, "qp_range": (10, 40), "deblock_idc": [0]}, 0, (25, 1),
                         None),
    "h264_b_cabac.mp4": (234, (4, 3), 12, {"profile": 100, "refs": 4, "log2_max_poc_lsb": 8, "reorder": 2},
                         {"cabac": 1, "t8x8": 1, "bipred": 2, "refs": 3, "refs1": 2},
                         {"b": 1, "b_max": 3, "pyramid": 1, "qp_range": (10, 40), "deblock_idc": [0], "skip": 0.3},
                         4, (25, 1), None),
    "h264_b_noreorder.mkv": (235, (3, 2), 12, {"profile": 77, "refs": 3, "log2_max_poc_lsb": 8},
                             {"cabac": 1, "refs": 2, "refs1": 1},
                             {"b": 1, "b_max": 4, "pyramid": 1, "qp_range": (10, 40), "deblock_idc": [0]}, 4,
                             (30000, 1001), None),
    "h264_b_weighted.mov": (236, (3, 3), 9, {"profile": 77, "refs": 3, "log2_max_poc_lsb": 8, "reorder": 3},
                            {"cabac": 1, "weighted": 1, "bipred": 1, "refs": 2, "refs1": 2},
                            {"b": 1, "b_max": 2, "qp_range": (10, 40), "deblock_idc": [0]}, 4, (30, 1), None),
    "h264_b_longterm.mkv": (244, (3, 2), 14, {"profile": 77, "refs": 4, "log2_max_poc_lsb": 8},
                            {"bipred": 2, "refs": 3, "refs1": 2},
                            {"b": 1, "b_max": 3, "pyramid": 1, "mmco": 0.4, "mods": 0.4, "idr_long": 1.0,
                             "qp_range": (10, 40), "deblock_idc": [0]}, 2, (25, 1), None),
    "h264_scaling_sps.mp4": (238, (4, 3), 6, {"profile": 100, "refs": 2, "log2_max_poc_lsb": 8,
                                              "scaling": [_W[::-1], None, "default", None, [16, 20, 28] + [28] * 13,
                                                          None, _W8, "default"]},
                             {"cabac": 1, "t8x8": 1, "refs": 2, "refs1": 1},
                             {"b": 1, "qp_range": (0, 40), "deblock_idc": [0]}, 4, (25, 1), None),
    "h264_scaling_pps.avi": (239, (4, 3), 6, {"profile": 100, "refs": 2, "log2_max_poc_lsb": 8,
                                              "scaling": [None, [12] * 16, None, _W, None, None, None, _W8]},
                             {"t8x8": 1, "refs": 2, "refs1": 1,
                              "scaling": [_W, None, [30] * 16, None, "default", None, None, None]},
                             {"b": 1, "qp_range": (24, 29), "deblock_idc": [0], "i4": 0.2}, 0, (25, 1), None),
}
H264_TRIM = {"h264_b_cabac_trim.mp4": ("h264_b_cabac.mp4", 2)}  # a clip's stream with its edit list from frame 2
H264_BIG = ("h264_big512.mp4", "h264_big512.mkv")  # the same stream of moving(8, 512, 512, 63) in each
H264_BIG_HIGH = ("h264_high512.mp4", "h264_high512.mkv")  # h264_writer.encode_high of moving(8, 512, 512, 64)
H264_HIGH_QP = 30
H264_BIG_QP = 30
MJPEG_ROWS = (1, 2, 8, 16, 64)  # the widths of cv2's one-row MJPG clips, 3 frames each


def h264_pack(name: str, units: list, w: int, h: int, size: int, rate: tuple, shown: list | None = None,
              keys: list | None = None, trim: int = 0) -> bytes:
    """The access units in the container of name's suffix: AVI (start codes, tag H264), MP4 / MOV (an avc1
    sample entry, NAL lengths of ``size`` bytes; composition offsets and an edit list from the display indices
    ``shown``, ``trim`` frames left out at its start) or Matroska (V_MPEG4/ISO/AVC, its avcC in CodecPrivate;
    blocks at their display times). ``keys``: the key (IDR) samples, the first alone unless given."""
    shown = list(range(len(units))) if shown is None else shown
    keys = [i == 0 for i in range(len(units))] if keys is None else keys
    from tests.video_fixtures import h264_writer as hw

    if name.endswith(".avi"):
        return avi_bytes([hw.annex_b(u, long_codes=i % 2 == 0) for i, u in enumerate(units)], w, h, rate[0], rate[1],
                         b"H264")
    sps = [n for n in units[0] if n[0] & 0x1F == 7]
    pps = [n for n in units[0] if n[0] & 0x1F == 8]
    config = hw.avcc(sps, pps, size)
    samples = [hw.length_prefixed([n for n in u if n[0] & 0x1F not in (7, 8)], size) for u in units]
    if size == 1:
        assert all(len(n) < 256 for u in units for n in u), "a NAL unit too long for a length of one byte"
    if name.endswith(".mkv"):
        ms = 1000 * rate[1] / rate[0]
        return mkv_bytes("V_MPEG4/ISO/AVC", w, h, [(d, keys[i], round(shown[i] * ms)) for i, d in enumerate(samples)],
                         doctype="matroska", private=config, default_duration=round(1e9 * rate[1] / rate[0]),
                         duration=len(samples) * ms)
    data = mp4_bytes([(d, keys[i], shown[i]) for i, d in enumerate(samples)], w, h, rate[0] // rate[1], trim=trim,
                     entry=hw.avc1_entry(w, h, config))
    return data.replace(b"isom\0\0\2\0isomiso2mp41", b"qt  \0\0\2\0qt  qt  mp41") if name.endswith(".mov") else data


def h264_clips() -> dict:
    """name -> bytes of the H.264 fixtures (see ``h264_main``)."""
    from tests.video_fixtures import h264_writer as hw

    out = {}
    for name, (seed, (mw, mh), n, sps, pps, choices, size, rate, shown) in H264_SYNTAX.items():
        units, _, _ = hw.syntax_clip(seed, mw, mh, n, sps, pps, choices)
        w, h = shown or (16 * mw - 2 * sum(sps.get("crop", (0, 0, 0, 0))[:2]),
                         16 * mh - 2 * sum(sps.get("crop", (0, 0, 0, 0))[2:]))
        out[name] = h264_pack(name, units, w, h, size, rate)
    planes = []
    for img in moving(8, 512, 512, 63):
        yuv = cv2.cvtColor(img, cv2.COLOR_BGR2YUV_I420)
        planes.append((yuv[:512], yuv[512:640].reshape(256, 256), yuv[640:].reshape(256, 256)))
    units = hw.encode(planes, H264_BIG_QP, lambda us: lavc_planes([hw.annex_b(u) for u in us], decoder="h264")[-1])
    for name in H264_BIG:
        out[name] = h264_pack(name, units, 512, 512, 4, (25, 1))
    streams = {}
    for name, (seed, (mw, mh), n, sps, pps, choices, size, rate, _) in H264_HIGH.items():
        info: dict = {}
        units, _, _ = hw.syntax_clip(seed, mw, mh, n, sps, pps, choices, info)
        period = np.cumsum(info["idr"])
        order = sorted(range(n), key=lambda i: (period[i], info["poc"][i]))
        shown = [order.index(i) for i in range(n)]
        streams[name] = (units, 16 * mw, 16 * mh, size, rate, shown, info["idr"])
        out[name] = h264_pack(name, *streams[name])
    for name, (src, trim) in H264_TRIM.items():
        out[name] = h264_pack(name, *streams[src], trim=trim)
    planes = []
    for img in moving(8, 512, 512, 64):
        yuv = cv2.cvtColor(img, cv2.COLOR_BGR2YUV_I420)
        planes.append((yuv[:512], yuv[512:640].reshape(256, 256), yuv[640:].reshape(256, 256)))
    units, shown = hw.encode_high(planes, H264_HIGH_QP, lambda us: lavc_planes([hw.annex_b(u) for u in us],
                                                                               decoder="h264"))
    for name in H264_BIG_HIGH:
        out[name] = h264_pack(name, units, 512, 512, 4, (25, 1), shown)
    return out


def h264_main() -> None:
    """Writes the H.264 fixtures and their oracle, ``h264.json`` (the
    SHA-256 of each frame cv2 reads, its fps, count and fourcc, and each
    file's own SHA-256), leaving the other fixtures as they are: the syntax
    clips of ``H264_SYNTAX`` and ``H264_HIGH`` (``h264_writer.syntax_clip``'s
    random choices over every tool the decoder counts, Baseline and then Main
    and High, in AVI, MP4, MOV and Matroska; ``H264_TRIM`` one of them in an
    MP4 whose edit list leaves its first frames out), the 512 x 512 angiogram
    in the Baseline profile (``h264_writer.encode``) and in the High profile
    (``h264_writer.encode_high``), each in MP4 and Matroska with its
    references from libavcodec, and cv2's MJPG clips one row high."""
    meta = {}
    for name, data in h264_clips().items():
        (HERE / name).write_bytes(data)
    rng = np.random.default_rng(64)
    for w in MJPEG_ROWS:
        cv2_write(HERE / f"mjpg_row{w}.avi", "MJPG", 25, [rng.integers(0, 256, (1, w, 3), np.uint8) for _ in range(3)])
    for name in [*H264_SYNTAX, *H264_BIG, *H264_HIGH, *H264_TRIM, *H264_BIG_HIGH,
                 *(f"mjpg_row{w}.avi" for w in MJPEG_ROWS)]:
        imgs, meta[name] = cv2_read(HERE / name)
        meta[name]["oracle"] = "cv2, as the SHA-256 of each frame"
        meta[name]["sha256"] = digests(imgs)
        meta[name]["file_sha256"] = hashlib.sha256((HERE / name).read_bytes()).hexdigest()
    (HERE / "h264.json").write_text(json.dumps(meta, indent=1, sort_keys=True) + "\n")


# ---------------------------------------------------------------- the lossless codecs

LOSSLESS_SIZE = (30, 40)  # (h, w) of the small clips


def lossless_planes(fmt: str, img: np.ndarray, seed: int) -> list:
    """The planes of a BGR frame in a libavcodec pixel format, as
    ``lavc_encode_planes`` takes them: YUV by cv2's BT.601 (chroma
    subsampled by cv2's I420, or resized for 4:4:4), alpha seeded noise."""
    h, w = img.shape[:2]
    hh, ww = h + (h & 1), w + (w & 1)
    yuv = cv2.cvtColor(cv2.copyMakeBorder(img, 0, hh - h, 0, ww - w, cv2.BORDER_REPLICATE),
                       cv2.COLOR_BGR2YUV_I420).ravel()
    cs = (hh // 2) * (ww // 2)
    y = yuv[:hh * ww].reshape(hh, ww)[:h, :w]
    u, v = yuv[hh * ww:hh * ww + cs].reshape(hh // 2, ww // 2), yuv[hh * ww + cs:].reshape(hh // 2, ww // 2)
    a = np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)
    g = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    return {"gray": [g], "yuv420p": [y, u, v], "yuv422p": [y, np.repeat(u, 2, 0)[:h], np.repeat(v, 2, 0)[:h]],
            "yuv444p": [y, cv2.resize(u, (w, h)), cv2.resize(v, (w, h))], "yuva420p": [y, u, v, a],
            "gbrp": [img[..., 1], img[..., 0], img[..., 2]],
            "bgr0": [np.dstack([img, np.zeros((h, w), np.uint8)]).reshape(h, 4 * w)],
            "bgra": [np.dstack([img, a]).reshape(h, 4 * w)], "rgb24": [img[..., ::-1].reshape(h, 3 * w).copy()],
            "rgba": [np.dstack([img[..., ::-1], a]).reshape(h, 4 * w)], "ya8": [np.dstack([g, a]).reshape(h, 2 * w)],
            "gray16be": [(g.astype(">u2") * 257 + a).view(np.uint8).reshape(h, 2 * w)],
            "ya16be": [np.dstack([g.astype(">u2") * 257 + a, np.full((h, w), 65535, ">u2")]).view(np.uint8)
                       .reshape(h, 4 * w)],
            "monob": [np.packbits(g > 128, axis=1)], "pal8": [g // 17, np.random.default_rng(seed).integers(
                0, 256, (1, 1024), np.uint8)]}[fmt]


def bitmap_header(w: int, h: int, bits: int, fourcc: bytes, extradata: bytes = b"") -> bytes:
    """A BITMAPINFOHEADER and its extradata (a Matroska VfW track's CodecPrivate)."""
    return struct.pack("<IiiHH4sIiiII", 40 + len(extradata), w, h, 1, bits, fourcc, w * h * 3, 0, 0, 0, 0) + extradata


def _box(t: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), t) + payload


def visual_entry(fourcc: bytes, w: int, h: int, depth: int = 24, boxes: bytes = b"") -> bytes:
    """An MP4 / MOV visual sample entry of ``fourcc`` with its boxes (a
    ``glbl`` of the codec's extradata, an ``esds``)."""
    return _box(fourcc, b"\0" * 6 + struct.pack(">H", 1) + b"\0" * 16 + struct.pack(">HHIIIH", w, h, 0x480000,
                                                                                     0x480000, 0, 1) +
                b"\0" * 32 + struct.pack(">Hh", depth, -1) + boxes)


def png_mp4v_entry(w: int, h: int) -> bytes:
    """The mp4v sample entry ffmpeg's mp4 muxer writes for PNG frames: an
    esds of objectTypeIndication 0x6D and no decoder specific info."""
    def desc(tag: int, body: bytes) -> bytes:
        k = len(body)
        return bytes([tag, 0x80 | (k >> 21) & 0x7F, 0x80 | (k >> 14) & 0x7F, 0x80 | (k >> 7) & 0x7F, k & 0x7F]) + body
    dcd = desc(4, struct.pack(">BB3sII", 0x6D, 0x11, b"\0\0\0", 0, 0))
    return visual_entry(b"mp4v", w, h, 24, _box(b"esds", struct.pack(">I", 0) +
                                                 desc(3, struct.pack(">HB", 1, 0) + dcd + desc(6, b"\x02"))))


def lossless_mux(container: str, packets: list, w: int, h: int, tag: bytes, extradata: bytes = b"",
                 bits: int = 24) -> bytes:
    """``packets`` (bytes each, every one a key frame for the container) at
    25 fps in AVI (``tag`` and ``bits`` in its BITMAPINFOHEADER), Matroska
    (``V_FFV1`` for FFV1, else a VfW track), or MP4 / MOV (a ``tag`` sample
    entry with a ``glbl`` box of the extradata, or PNG's mp4v)."""
    if container == "avi":
        return avi_bytes(packets, w, h, 25, 1, tag, extradata, bits)
    if container == "mkv":
        blocks = [(d, True, 40 * i) for i, d in enumerate(packets)]
        if tag == b"FFV1":
            return mkv_bytes("V_FFV1", w, h, blocks, doctype="matroska", private=extradata, default_duration=40000000,
                             duration=40.0 * len(packets))
        return mkv_bytes("V_MS/VFW/FOURCC", w, h, blocks, doctype="matroska", default_duration=40000000,
                         private=bitmap_header(w, h, bits, tag, extradata), duration=40.0 * len(packets))
    entry = png_mp4v_entry(w, h) if tag == b"mp4v" else \
        visual_entry(tag, w, h, bits, _box(b"glbl", extradata) if extradata else b"")
    return mp4_bytes([(d, True, i) for i, d in enumerate(packets)], w, h, 25, entry=entry)


def smooth_angiogram(n: int, h: int, w: int, seed: int) -> list:
    """Grey angiogram-like frames that lossless codecs keep small: a smooth
    background, dark vessels drawn anti-aliased that drift a little each
    frame, no noise."""
    rng = np.random.default_rng(seed)
    yy = np.mgrid[0:h, 0:w][0].astype(np.float64)
    base = 140 + 40 * yy / h  # a slow vertical ramp: most samples equal their left neighbour
    paths = [(rng.uniform(0, w), rng.uniform(0, h), rng.uniform(-1, 1) * w, rng.uniform(-1, 1) * h) for _ in range(6)]
    out = []
    for i in range(n):
        f = np.clip(base, 0, 255).astype(np.uint8)
        for k, (x0, y0, dx, dy) in enumerate(paths):
            cv2.line(f, (int(x0 + 2 * i), int(y0)), (int(x0 + dx), int(y0 + dy + 3 * i)), 55 + 10 * k, 3 + k % 3,
                     cv2.LINE_AA)
        out.append(cv2.GaussianBlur(f, (5, 5), 1.2))
    return out


def png_frames(kind: str, n: int, seed: int) -> list:
    """PNG frames that libavcodec's encoder does not write, from the still
    fixtures' writer: grey of 2 and 4 bits, palettes of 1, 2 and 4 bits with
    tRNS and indices past PLTE, a gAMA and an eXIf chunk (neither applied
    by ffmpeg), Adam7."""
    from tests.still_fixtures.writers import png_bytes

    h, w = LOSSLESS_SIZE
    rng = np.random.default_rng(seed)
    out = []
    for g in (cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in frames(n, h, w, seed)):
        if kind == "grey2":
            out.append(png_bytes((g >> 6)[..., None], 2, 0))
        elif kind == "grey4_gamma_exif":
            data = png_bytes((g >> 4)[..., None], 4, 0, orientation=6)
            out.append(data[:33] + struct.pack(">I4sI", 4, b"gAMA", 100000) + struct.pack(">I", zlib.crc32(
                b"gAMA" + struct.pack(">I", 100000))) + data[33:])
        elif kind == "pal4_trns":
            pal = rng.integers(0, 256, (12, 3), np.uint8)  # indices 12-15 past PLTE: black in ffmpeg
            out.append(png_bytes((g >> 4)[..., None], 4, 3, palette=pal, trns=bytes(range(0, 240, 40))))
        elif kind == "pal1":
            out.append(png_bytes((g > 128).astype(np.uint8)[..., None], 1, 3, palette=[[10, 200, 30], [250, 5, 90]]))
        elif kind == "rgb8_adam7":
            out.append(png_bytes(cv2.cvtColor(g, cv2.COLOR_GRAY2RGB) + np.array([0, 9, 20], np.uint8), 8, 2,
                                 interlace=True))
    return out


def lossless_clips() -> dict:
    """name -> (file bytes, oracle) of the lossless fixtures this module lays
    out; oracle "cv2", or "libpng" (cv2.imdecode of each frame, for PNG
    frames cv2 cannot convert: Adam7 flags them interlaced)."""
    h, w = LOSSLESS_SIZE
    imgs = frames(4, h, w, 230)
    odd = frames(3, 37, 45, 231)
    tall = frames(3, 40, 40, 232)
    noisy = frames(3, h, w, 233)
    for f in noisy:  # golomb escapes and long Huffman codes
        f[::3, ::2] = np.random.default_rng(7).integers(0, 256, f[::3, ::2].shape, np.uint8)
    out = {}

    def add(name, encoder, fmt, src, options, container, tag, bits=24, strip=False, **kw):
        ex = []
        packets = [d for d, _, _ in lavc_encode_planes(encoder, [lossless_planes(fmt, f, i) for i, f in enumerate(src)],
                                                       fmt, options, ex, **kw)]
        sh, sw = src[0].shape[:2]
        out[name] = (lossless_mux(container, packets, sw, sh, tag, b"" if strip else ex[0], bits), "cv2")

    # FFV1: versions 0, 1 and 3, both coders and the custom table, contexts, slices and CRCs, each pixel format
    add("ffv1_v0_golomb_gray.avi", "ffv1", "gray", imgs, {"level": 0, "coder": 0}, "avi", b"FFV1")
    add("ffv1_v0_range_yuv420p_g2.mkv", "ffv1", "yuv420p", imgs, {"level": 0, "coder": -2, "g": 2}, "mkv", b"FFV1")
    add("ffv1_v1_custom_yuv422p_ctx1_odd.avi", "ffv1", "yuv422p", odd, {"level": 1, "coder": 1, "context": 1,
                                                                         "g": 2}, "avi", b"FFV1")
    add("ffv1_v1_golomb_yuv444p_noisy.mp4", "ffv1", "yuv444p", noisy, {"level": 1, "coder": 0, "context": 1}, "mp4",
        b"FFV1")
    add("ffv1_v3_golomb_yuva420p_4slices.mkv", "ffv1", "yuva420p", imgs, {"level": 3, "coder": 0, "slices": 4,
                                                                          "slicecrc": 1, "g": 2}, "mkv", b"FFV1")
    add("ffv1_v3_range_gray_16slices_nocrc.mov", "ffv1", "gray", tall, {"level": 3, "coder": -2, "slices": 16,
                                                                        "slicecrc": 0}, "mp4", b"FFV1")
    add("ffv1_v3_custom_bgr0_ctx1.mp4", "ffv1", "bgr0", imgs, {"level": 3, "coder": 1, "context": 1, "slices": 4,
                                                               "g": 2}, "mp4", b"FFV1", 32)
    add("ffv1_v3_golomb_bgr0_odd.avi", "ffv1", "bgr0", odd, {"level": 3, "coder": 0, "slices": 4}, "avi", b"FFV1", 32)
    add("ffv1_v3_range_yuv444p_states.avi", "ffv1", "yuv444p", imgs, {"level": 3, "coder": 1, "slices": 4},
        "avi", b"FFV1", two_pass=True)
    # HuffYUV (v2) and FFVHuff (v2 and v3): the three predictors, interlacing, per-frame tables, each pixel format
    add("hfyu_yuv422p_left.avi", "huffyuv", "yuv422p", imgs, {"pred": "left"}, "avi", b"HFYU", 16)
    add("hfyu_yuv422p_plane_ilace.mkv", "huffyuv", "yuv422p", tall, {"pred": "plane", "flags": "+ilme"}, "mkv",
        b"HFYU", 16)
    add("hfyu_yuv422p_median.avi", "huffyuv", "yuv422p", imgs, {"pred": "median"}, "avi", b"HFYU", 16)
    add("hfyu_rgb24_left.mov", "huffyuv", "rgb24", imgs, {"pred": "left"}, "mov", b"HFYU", 24)
    add("hfyu_rgb24_plane_ilace_odd.avi", "huffyuv", "rgb24", odd, {"pred": "plane", "flags": "+ilme"}, "avi",
        b"HFYU", 24)
    add("hfyu_bgra_left_noisy.avi", "huffyuv", "bgra", noisy, {"pred": "left"}, "avi", b"HFYU", 32)
    for name, decorrelate in (("hfyu_v1_classic_rgb24.avi", False), ("hfyu_v1_classic_decorrelated.avi", True)):
        _, packets = huffyuv_rgb(imgs, classic=True, decorrelate=decorrelate)
        out[name] = (lossless_mux("avi", packets, w, h, b"HFYU", b"", 26 if decorrelate else 24), "cv2")
    add("ffvh_yuv420p_median_ctx1.avi", "ffvhuff", "yuv420p", imgs, {"pred": "median", "context": 1}, "avi",
        b"FFVH", 12)
    add("ffvh_yuv420p_plane_ilace.mkv", "ffvhuff", "yuv420p", tall, {"pred": "plane", "flags": "+ilme"}, "mkv",
        b"FFVH", 12)
    add("ffvh_gray_median_2rows.avi", "ffvhuff", "gray", [f[:2, :33] for f in odd], {"pred": "median"}, "avi",
        b"FFVH", 8)
    add("ffvh_gray_left_odd.mov", "ffvhuff", "gray", odd, {"pred": "left", "context": 1}, "mov", b"FFVH", 8)
    add("ffvh_yuv444p_plane.avi", "ffvhuff", "yuv444p", imgs, {"pred": "plane"}, "avi", b"FFVH", 24)
    add("ffvh_yuv444p_median_ilace.mkv", "ffvhuff", "yuv444p", tall, {"pred": "median", "flags": "+ilme"}, "mkv",
        b"FFVH", 24)
    add("ffvh_gbrp_median.avi", "ffvhuff", "gbrp", imgs, {"pred": "median"}, "avi", b"FFVH", 24)
    add("ffvh_yuva420p_left.avi", "ffvhuff", "yuva420p", imgs, {"pred": "left"}, "avi", b"FFVH", 32)
    # PNG frames: libavcodec's encoder for its pixel formats, the stills' writer for the rest
    for fmt, container, tag in (("gray", "avi", b"MPNG"), ("gray16be", "mkv", b"png "), ("ya8", "avi", b"MPNG"),
                                ("ya16be", "mov", b"png "), ("monob", "avi", b"MPNG"), ("pal8", "avi", b"PNG1"),
                                ("rgba", "mp4", b"mp4v"), ("rgb24", "avi", b"MPNG")):
        ex = []
        packets = [d for d, _, _ in lavc_encode_planes("png", [lossless_planes(fmt, f, i) for i, f in enumerate(imgs)],
                                                       fmt, {"pred": "mixed"} if fmt == "rgb24" else {}, ex,
                                                       width=w)]
        out[f"png_{fmt}.{container}"] = (lossless_mux(container, packets, w, h, tag), "cv2")
    for kind in ("grey2", "grey4_gamma_exif", "pal4_trns", "pal1"):
        out[f"png_{kind}.avi"] = (lossless_mux("avi", png_frames(kind, 3, 240), w, h, b"MPNG"), "cv2")
    out["png_rgb8_adam7.avi"] = (lossless_mux("avi", png_frames("rgb8_adam7", 3, 241), w, h, b"MPNG"), "libpng")
    # the 512 px clips of chip_smoke.py's [lossless]: a grey angiogram, FFV1 in Matroska and HuffYUV RGB in AVI
    big = smooth_angiogram(8, 512, 512, 242)
    ex = []
    packets = [d for d, _, _ in lavc_encode_planes("ffv1", [[g] for g in big], "gray", {"level": 3, "g": 8}, ex)]
    out["ffv1_big512.mkv"] = (lossless_mux("mkv", packets, 512, 512, b"FFV1", ex[0]), "cv2")
    extradata, packets = huffyuv_rgb([cv2.cvtColor(g, cv2.COLOR_GRAY2BGR) for g in big])
    out["hfyu_big512.avi"] = (lossless_mux("avi", packets, 512, 512, b"HFYU", extradata), "cv2")
    return out


def classic_huffyuv_table() -> tuple:
    """(lengths, codes) of HuffYUV's classic luma table, which files without
    extradata take (as ``native/huffyuv.cpp`` holds it: kShiftLuma run-length
    coded as extradata's tables are, kAddLuma)."""
    import re

    src = (HERE.parents[1] / "mga_yolo_tpu_torch" / "native" / "huffyuv.cpp").read_text()
    shift, add = ([int(v) for v in re.search(name + r"\[[^\]]*\] = \{([^}]*)\}", src).group(1).split(",")]
                  for name in ("kShiftLuma", "kAddLuma"))
    bits, lens = "".join(f"{b:08b}" for b in shift), []
    while len(lens) < 256:
        rep, val, bits = int(bits[:3], 2), int(bits[3:8], 2), bits[8:]
        if not rep:
            rep, bits = int(bits[:8], 2), bits[8:]
        lens += [val] * rep
    return np.array(lens, np.int64), np.array(add, np.int64)


def huffyuv_rgb(imgs: list, classic: bool = False, decorrelate: bool = True) -> tuple:
    """(extradata, frames) of HuffYUV RGB24, left-predicted, with code
    lengths fitted to the frames' own differences (libavcodec's encoder
    takes fixed generic tables, which cost a 512 px grey clip more than 6
    bits a pixel); with ``classic``, the classic tables and no extradata (a
    version 1 file, whose BITMAPINFOHEADER's bits a pixel then say 24, or 26
    when ``decorrelate``). Bottom-up rows; the first pixel raw (R, G, B and a
    byte), then the left differences in one stream across rows, G, B - G and
    R - G (or B, G, R), packed MSB first and byte-swapped in 32-bit words."""
    import heapq

    def symbols(img):  # the first pixel, then (n, 3) symbols in stream order, each with its table (0 B, 1 G, 2 R)
        flat = img[::-1].reshape(-1, 3).astype(np.int64)  # B, G, R bottom-up
        d = (flat[1:] - flat[:-1]) & 255
        if not decorrelate:
            return flat[0], d, (0, 1, 2)
        return flat[0], np.stack([d[:, 1], (d[:, 0] - d[:, 1]) & 255, (d[:, 2] - d[:, 1]) & 255], 1), (1, 0, 2)

    if classic:
        lens, codes = [classic_huffyuv_table()[0]] * 3, [classic_huffyuv_table()[1]] * 3
    else:
        counts = np.ones((3, 256), np.int64)  # by table; every symbol coded
        for img in imgs:
            _, sym, tables = symbols(img)
            for c, t in enumerate(tables):
                counts[t] += np.bincount(sym[:, c], minlength=256)
        lens, codes = [], []
        for t in range(3):  # Huffman code lengths, then ff_huffyuv_generate_bits_table's codes, the longest first
            heap = [(int(n), i, (i,)) for i, n in enumerate(counts[t])]
            heapq.heapify(heap)
            depth, k = np.zeros(256, np.int64), 256
            while len(heap) > 1:
                n1, _, a = heapq.heappop(heap)
                n2, _, b = heapq.heappop(heap)
                depth[list(a + b)] += 1
                heapq.heappush(heap, (n1 + n2, k, a + b))
                k += 1
            assert depth.max() <= 31
            code, bits = np.zeros(256, np.int64), 0
            for k in range(32, 0, -1):
                for i in np.flatnonzero(depth == k):
                    code[i], bits = bits, bits + 1
                bits >>= 1
            lens.append(depth)
            codes.append(code)

    def table(ln):  # run-length coded lengths: 3 bits of repeat (0: 8 more bits), 5 of length
        out, i = "", 0
        while i < 256:
            j = i
            while j < 256 and ln[j] == ln[i] and j - i < 255:
                j += 1
            rep = j - i
            out += f"{rep:03b}{ln[i]:05b}" if rep < 8 else f"000{ln[i]:05b}{rep:08b}"
            i = j
        return out

    head = "".join(table(ln) for ln in lens)
    head += "0" * (-len(head) % 8)
    extradata = b"" if classic else bytes([0x40, 24, 0x20, 0]) + int(head, 2).to_bytes(len(head) // 8, "big")
    packets = []
    for img in imgs:
        first, sym, tables = symbols(img)
        ln = np.stack([lens[t][sym[:, c]] for c, t in enumerate(tables)], 1).ravel()
        cd = np.stack([codes[t][sym[:, c]] for c, t in enumerate(tables)], 1).ravel()
        prefix = "".join(f"{v:08b}" for v in (int(first[2]), int(first[1]), int(first[0]), 0))
        bits = np.concatenate([np.array([int(b) for b in prefix], np.uint8)] +
                              [((cd[:, None] >> (ln[:, None] - 1 - np.arange(32)[None, :])) & 1)
                               [np.arange(32)[None, :] < ln[:, None]].astype(np.uint8)])
        bits = np.concatenate([bits, np.zeros(-len(bits) % 32, np.uint8)])
        packets.append(np.packbits(bits).reshape(-1, 4)[:, ::-1].tobytes())  # the decoder byte-swaps 32-bit words
    return extradata, packets


# cv2's own writer: each lossless fourcc in every container it writes it to
LOSSLESS_CV2 = {"png ": (".avi", ".mkv", ".wmv", ".mov", ".mp4"), "FFV1": (".avi", ".mkv", ".wmv", ".mov", ".mp4"),
                "HFYU": (".avi", ".mkv", ".wmv", ".mov"), "FFVH": (".avi", ".mkv", ".wmv", ".mov")}


def lossless_main() -> None:
    """Writes the lossless fixtures (``lossless_clips`` and cv2's writer's
    ``cv2_*`` clips) and their oracle, ``lossless.json``: the SHA-256 of each
    frame cv2 reads (libpng's, for Adam7 PNG frames), its fps, count and
    fourcc, and each file's own SHA-256."""
    meta = {}
    clips = lossless_clips()
    h, w = LOSSLESS_SIZE
    for fourcc, suffixes in LOSSLESS_CV2.items():
        for suffix in suffixes:
            name = f"cv2_{fourcc.strip().lower()}{suffix}"
            cv2_write(HERE / name, fourcc, 25, frames(3, h, w, 250))
            clips[name] = ((HERE / name).read_bytes(), "cv2")
    for name, (data, oracle) in clips.items():
        (HERE / name).write_bytes(data)
        imgs, meta[name] = cv2_read(HERE / name)
        meta[name]["oracle"] = "cv2, as the SHA-256 of each frame"
        if oracle == "libpng":  # cv2 hands on a stale buffer for a frame flagged interlaced
            imgs = [cv2.imdecode(np.frombuffer(d, np.uint8), cv2.IMREAD_COLOR) for d in avi_parts(data)[1]]
            meta[name]["oracle"] = "libpng (cv2.imdecode of each frame), as the SHA-256 of each frame"
        meta[name]["sha256"] = digests(imgs)
        meta[name]["file_sha256"] = hashlib.sha256(data).hexdigest()
    (HERE / "lossless.json").write_text(json.dumps(meta, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    import sys

    {"mpeg": mpeg_main, "asp": asp_main, "wmv": wmv_main, "h264": h264_main, "lossless": lossless_main}.get(
        sys.argv[1] if sys.argv[1:] else "", main)()
