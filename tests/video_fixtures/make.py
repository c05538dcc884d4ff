"""Writes the video fixtures that ``tests/test_torch_video.py`` and
``chip_smoke.py`` ``[video]`` read: small clips written by cv2 (the JAX
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
"""

from __future__ import annotations

import hashlib
import json
import struct
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
    per-macroblock quantiser changes (dquant). The AVFrame / AVPacket field
    offsets are those of libavutil 60 / libavcodec 62."""
    import ctypes

    libs = Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs"
    avutil = ctypes.CDLL(str(next(libs.glob("libavutil-*"))), mode=ctypes.RTLD_GLOBAL)
    avcodec = ctypes.CDLL(str(next(libs.glob("libavcodec-*"))), mode=ctypes.RTLD_GLOBAL)
    vp = ctypes.c_void_p
    for lib, name, res, args in (
            (avcodec, "avcodec_find_encoder_by_name", vp, [ctypes.c_char_p]),
            (avcodec, "avcodec_alloc_context3", vp, [vp]),
            (avutil, "av_opt_set", ctypes.c_int, [vp, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]),
            (avcodec, "avcodec_open2", ctypes.c_int, [vp, vp, vp]), (avutil, "av_frame_alloc", vp, []),
            (avutil, "av_frame_get_buffer", ctypes.c_int, [vp, ctypes.c_int]),
            (avutil, "av_frame_make_writable", ctypes.c_int, [vp]), (avcodec, "av_packet_alloc", vp, []),
            (avcodec, "avcodec_send_frame", ctypes.c_int, [vp, vp]),
            (avcodec, "avcodec_receive_packet", ctypes.c_int, [vp, vp]), (avcodec, "av_packet_unref", None, [vp])):
        getattr(lib, name).restype, getattr(lib, name).argtypes = res, args
    h, w = imgs[0].shape[:2]
    codec = avcodec.avcodec_find_encoder_by_name(b"mpeg4")
    ctx = avcodec.avcodec_alloc_context3(codec)
    for k, v in {"video_size": f"{w}x{h}", "pixel_format": "yuv420p", "time_base": "1/25", **options}.items():
        assert avutil.av_opt_set(ctx, k.encode(), v.encode(), 1) >= 0, k
    assert avcodec.avcodec_open2(ctx, codec, None) == 0
    frame, pkt = avutil.av_frame_alloc(), avcodec.av_packet_alloc()
    ints, ptrs = ctypes.cast(frame, ctypes.POINTER(ctypes.c_int)), ctypes.cast(frame, ctypes.POINTER(vp))
    ints[26], ints[27], ints[29] = w, h, 0  # width, height, format (yuv420p)
    assert avutil.av_frame_get_buffer(frame, 0) == 0
    packets = []

    def drain():
        while avcodec.avcodec_receive_packet(ctx, pkt) == 0:
            data, size = ctypes.cast(pkt, ctypes.POINTER(vp))[3], ctypes.cast(pkt, ctypes.POINTER(ctypes.c_int))[8]
            packets.append(ctypes.string_at(data, size))
            avcodec.av_packet_unref(pkt)

    for img in imgs:
        assert avutil.av_frame_make_writable(frame) == 0
        yuv = cv2.cvtColor(img, cv2.COLOR_BGR2YUV_I420)
        planes = (yuv[:h], yuv[h:h + h // 4].reshape(h // 2, w // 2), yuv[h + h // 4:].reshape(h // 2, w // 2))
        for k, plane in enumerate(planes):
            for r in range(plane.shape[0]):
                ctypes.memmove(ptrs[k] + r * ints[16 + k], np.ascontiguousarray(plane[r]).ctypes.data, plane.shape[1])
        assert avcodec.avcodec_send_frame(ctx, frame) == 0
        drain()
    avcodec.avcodec_send_frame(ctx, None)
    drain()
    return packets


def main() -> None:
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
    (HERE / "meta.json").write_text(json.dumps(meta, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
