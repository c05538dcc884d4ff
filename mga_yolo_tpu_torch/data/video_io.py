"""Video files without OpenCV: the containers in Python, the codecs in the
host C++ library (``native/jpeg.cpp``, ``native/mpeg4.cpp``,
``native/mpeg12.cpp``, ``native/msmpeg4.cpp``, ``native/vp8.cpp``,
``native/h264.cpp``, ``native/ffv1.cpp``, ``native/huffyuv.cpp``,
``native/gif.cpp``, ``native/yuv.cpp``).

The card's host has no OpenCV and no libavcodec, so the port reads and
writes the video files the JAX package reads and writes through
``cv2.VideoCapture`` / ``cv2.VideoWriter``:

* :class:`VideoReader` reads AVI (RIFF, ``idx1`` or a scan of ``movi``,
  OpenDML ``AVIX`` segments) and ISO-BMFF (``.mp4``, ``.mov``, ``.m4v``:
  ``moov`` wherever it lies, the sample tables, edit lists, ``ctts``
  display times) holding MJPEG, MPEG-4 Part 2 Simple and Advanced Simple
  profile (mp4v, XVID, DIVX, DX50, FMP4: B-VOPs in display order, DivX's
  packed bitstream, the XviD IDCT where ffmpeg takes it; see
  ``native.Mpeg4Decoder``), MPEG-1 and
  MPEG-2 video (AVI's ``mpg1`` / ``mpg2`` / ``MPEG`` / ``PIM1`` tags and
  their aliases, MP4's object types 0x60-0x65 and 0x6A), uncompressed
  24-bit BI_RGB or I420. Frames come out as cv2 gives them: BGR uint8, an
  MJPEG frame's planes through ffmpeg's simple IDCT and converted as
  ffmpeg's swscale converts them (full range, chroma replicated), MPEG-4's
  and MPEG-1/2's likewise in limited range, BI_RGB copied (equal to cv2's
  frames on every test clip). ``fps``, ``total`` and ``fourcc`` are what
  ``CAP_PROP_FPS``, ``CAP_PROP_FRAME_COUNT`` and ``CAP_PROP_FOURCC`` give.
* It reads MPEG-PS (``.mpg``, ``.mpeg``: MPEG-1 and MPEG-2 packs, the first
  video stream) holding MPEG-1/2 video (``native.Mpeg12Decoder``: I, P and
  B-pictures in display order, field prediction and field DCT in frame
  pictures, 4:2:0 and 4:2:2) or MPEG-4 Part 2 (cv2's own ``.mpg``), and a
  bare MPEG-1/2 or MPEG-4 stream (any suffix); see
  :meth:`VideoReader._open_ps` and :meth:`VideoReader._open_m4v` for cv2's
  fps and frame count.
* It reads Matroska and WebM (EBML: the first video track; Segments and
  Clusters of known or unknown size, SimpleBlocks and BlockGroups; SeekHead,
  Cues, Tags, CRC-32 and Void skipped) holding VP8 (``native.Vp8Decoder``:
  key and inter frames, hidden alt-ref frames decoded and not shown, each
  frame converted as MPEG-4's), MJPEG, MPEG-4 Part 2 (``CodecPrivate`` its
  configuration), MPEG-1/2 (``V_MPEG1``, ``V_MPEG2``), ``V_MS/VFW/FOURCC``
  tracks of those codecs, and ``V_UNCOMPRESSED`` I420 (what cv2's writer
  puts in ``.mkv`` for a fourcc of 0). See :meth:`VideoReader._open_mkv`
  for cv2's fps and frame count.
* It reads ASF (``.wmv``, ``.asf``; by its signature, whatever the suffix:
  the first video stream's frames put together from the fixed-size data
  packets) holding the MS-MPEG-4 family (``native.MsMpeg4Decoder``: MS
  MPEG-4 v2 and v3, WMV1, WMV2, as ffmpeg's own encoders write them),
  mp4v, MJPEG or MPEG-1/2; the family reads in AVI and Matroska too (its
  RIFF tags, ``V_MPEG4/MS/V3``). See :meth:`VideoReader._open_asf` for
  cv2's fps and frame count.
* :class:`VideoWriter` writes what ``VideoSink`` asks cv2 for, by suffix:
  ``.avi`` as MJPG (``encode_jpeg``'s frames, an ``idx1`` index), ``.mkv``
  as mp4v in Matroska, ``.mp4``, ``.mov`` and ``.m4v`` as mp4v in an MP4
  with cv2's ``ftyp`` brand (I-VOPs at a fixed quantiser, ``moov`` last),
  ``.mpg`` / ``.mpeg`` as mp4v in MPEG-PS, ``.wmv`` as mp4v in ASF, and
  ``.gif`` as cv2's images backend writes it (one still a frame, under
  numbered names), odd sizes cropped to even and an fps of 0 taken as 30,
  as cv2's writer does. ``.webm``, suffixes cv2's writer refuses and a
  ``.gif`` name without a digit raise ``RuntimeError`` as ``VideoSink``
  does.

  GIF's frames come out as cv2 gives them through ffmpeg's gif decoder
  (``native/gif.cpp`` decodes the LZW data; the frames are put on the
  canvas by ffmpeg's rule of disposal and transparency, see
  :meth:`VideoReader._gif_frames`), with its frame count, frame rate and
  fourcc ``gif ``.

* It reads the lossless codecs cv2 reads, in AVI, Matroska (``V_FFV1``,
  VfW), MP4 / MOV (their sample entries with a ``glbl`` box, PNG's mp4v of
  object type 0x6D) and ASF: PNG frames (ffmpeg's png decoder's pixel
  formats, as swscale turns them into BGR: :func:`png_frame`), FFV1
  (``native.Ffv1Decoder``: versions 0, 1 and 3, 8 bits a sample) and HuffYUV
  and FFVHuff (``native.HuffyuvDecoder``: versions 1 to 3), each frame
  converted as cv2 converts its pixel format (``native.planes_to_bgr``);
  cv2's fourccs ``MPNG``, ``ffv1``, ``HFYU`` and ``FFVH``.

HEVC, MPEG-4 GMC and RVLC, VP9, AV1, VC-1 / WMV9,
MS MPEG-4 v1, the MS-MPEG-4 tools ffmpeg's encoders never write (AC
prediction, DC and vector table 0, WMV2's J-pictures, ABT, mspel, ...),
fragmented MP4, interlaced MJPEG, Matroska's content encodings and laced
blocks, ASF's compressed payloads, payload extensions and encryption,
MPEG-2 field pictures, dual-prime prediction, scalable extensions, 4:4:4
and D-pictures, FFV1 and FFVHuff above 8 bits, 16-bit RGB PNG frames and
APNG raise ``ValueError`` naming the file, its container and its codec, as do
truncated and corrupt files (libavcodec conceals damage; the port refuses).
Frames of odd height, and 4:4:4 frames, take swscale's scaled path as cv2's do
(``native.yuv_to_bgr``).
"""

from __future__ import annotations

import itertools
import math
import re
import struct
import uuid
from collections import deque
from pathlib import Path
from typing import BinaryIO, Iterator, List, NoReturn, Optional, Tuple

import numpy as np

from mga_yolo_tpu_torch import native
from mga_yolo_tpu_torch.data.image_io import GIF_SIGNATURES, PNG_SIGNATURE, _png, encode_jpeg

MJPEG_TAGS = {b"MJPG", b"mjpg", b"AVRn", b"AVDJ", b"dmb1", b"JPEG", b"jpeg", b"IJPG", b"JPGL", b"mjpa"}
MPEG4_TAGS = {b"XVID", b"xvid", b"DIVX", b"divx", b"DX50", b"dx50", b"FMP4", b"fmp4", b"mp4v", b"MP4V", b"M4S2",
              b"m4s2"}
I420_TAGS = {b"I420", b"IYUV", b"i420", b"iyuv"}
# MPEG-1/2 tags cv2 reads in AVI (libavformat's riff tags); MPEG-1 or MPEG-2 is told by the stream itself
MPEG12_TAGS = {b"mpg1", b"MPG1", b"PIM1", b"VCR2", b"mpg2", b"MPG2", b"PIM2", b"DVR ", b"MMES", b"mmes", b"LMP2",
               b"slif", b"MPEG", b"mpeg", b"hdv1", b"hdv2", b"hdv3", b"hdv5", b"hdv6", b"hdv7", b"hdv8", b"hdv9",
               b"xdv1", b"xdv2", b"xdv3", b"xdv4", b"xdv5", b"xdv6", b"xdv7", b"xdv8", b"xdv9", b"xdva", b"xdvb",
               b"xdvc", b"xdvd", b"xdve", b"xdvf", b"mx5p", b"BW10"}
# the esds objectTypeIndication of MPEG-2 (0x60-0x65: its profiles) and MPEG-1 (0x6A) video in MP4
MP4_MPEG12_OTI = {0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0x6A}
# frame_rate_code 1-8 of a sequence header, as fractions
MPEG12_RATES = {1: (24000, 1001), 2: (24, 1), 3: (25, 1), 4: (30000, 1001), 5: (30, 1), 6: (50, 1), 7: (60000, 1001),
                8: (60, 1)}
# H.264's tags in AVI (libavformat's RIFF tags) and MP4's sample entries
H264_TAGS = {b"avc1", b"avc3", b"H264", b"h264", b"X264", b"x264"}
NAMED_TAGS = {b"hvc1": "HEVC", b"hev1": "HEVC", b"HEVC": "HEVC", b"MP41": "MS MPEG-4 v1",
              b"MPG4": "MS MPEG-4 v1", b"WMV3": "VC-1 / WMV9", b"WVC1": "VC-1 / WMV9", b"WMVA": "VC-1 / WMV9",
              b"vp09": "VP9", b"VP90": "VP9", b"av01": "AV1", b"FLV1": "FLV1 (Sorenson H.263)", b"apng": "APNG"}
# the lossless codecs' tags (libavformat's RIFF and MOV tags, compared in upper case)
LOSSLESS_TAGS = {b"HFYU": "huffyuv", b"FFVH": "ffvhuff", b"FFV1": "ffv1", b"MPNG": "png", b"PNG1": "png",
                 b"PNG ": "png"}
LOSSLESS_NAMES = {"huffyuv": "HuffYUV", "ffvhuff": "FFVHuff", "ffv1": "FFV1", "png": "PNG"}
MP4_PNG_OTI = 0x6D  # the esds objectTypeIndication of PNG frames (cv2's .mp4 of png)
# the MS-MPEG-4 family's codecs by native.MSMPEG4_VERSIONS' version
MSMPEG4_CODECS = {2: "msmpeg4v2", 3: "msmpeg4v3", 4: "wmv1", 5: "wmv2"}
# what cv2's CAP_PROP_FOURCC reports: the codec's own tag, not the file's
CV2_FOURCC = {"mjpeg": b"MJPG", "mpeg4": b"FMP4", "bgr24": b"\0\0\0\0", "i420": b"\0\0\0\0", "gif": b"gif ",
              "vp8": b"VP80", "mpeg1": b"mpg1", "mpeg2": b"mpg2", "msmpeg4v2": b"MP42", "msmpeg4v3": b"MP43",
              "wmv1": b"wmv1", "wmv2": b"wmv2", "h264": b"h264", "huffyuv": b"HFYU", "ffvhuff": b"FFVH",
              "ffv1": b"ffv1", "png": b"MPNG"}
ASF_MAGIC = b"\x30\x26\xb2\x75"
PS_PACK, PS_END, PS_SYSTEM = 0xBA, 0xB9, 0xBB
PS_TICKS = 90000  # the system clock's PTS / DTS units a second
EBML_MAGIC = b"\x1a\x45\xdf\xa3"
# Matroska's element IDs (marker bits kept) that the reader and the writer use
MKV = {"EBML": 0x1A45DFA3, "DocType": 0x4282, "Segment": 0x18538067, "SeekHead": 0x114D9B74, "Info": 0x1549A966,
       "TimestampScale": 0x2AD7B1, "Duration": 0x4489, "MuxingApp": 0x4D80, "WritingApp": 0x5741,
       "Tracks": 0x1654AE6B, "TrackEntry": 0xAE, "TrackNumber": 0xD7, "TrackUID": 0x73C5, "TrackType": 0x83,
       "FlagLacing": 0x9C, "Language": 0x22B59C, "CodecID": 0x86, "CodecPrivate": 0x63A2,
       "DefaultDuration": 0x23E383, "Video": 0xE0, "PixelWidth": 0xB0, "PixelHeight": 0xBA,
       "ColourSpace": 0x2EB524, "ContentEncodings": 0x6D80, "Cluster": 0x1F43B675, "Timestamp": 0xE7,
       "SimpleBlock": 0xA3, "BlockGroup": 0xA0, "Block": 0xA1, "EncryptedBlock": 0xAF, "Cues": 0x1C53BB6B,
       "CuePoint": 0xBB, "CueTime": 0xB3, "CueTrackPositions": 0xB7, "CueTrack": 0xF7,
       "CueClusterPosition": 0xF1, "Tags": 0x1254C367, "Chapters": 0x1043A770, "Attachments": 0x1941A469}
MKV_TOP_LEVEL = {MKV[k] for k in ("SeekHead", "Info", "Tracks", "Cluster", "Cues", "Tags", "Chapters", "Attachments")}
MKV_CODECS = {"V_VP8": "vp8", "V_MJPEG": "mjpeg", "V_MPEG4/ISO/SP": "mpeg4", "V_MPEG4/ISO/ASP": "mpeg4",
              "V_MPEG4/ISO/AP": "mpeg4", "V_MPEG1": "mpeg12", "V_MPEG2": "mpeg12", "V_MPEG4/MS/V3": "msmpeg4v3",
              "V_MPEG4/ISO/AVC": "h264", "V_FFV1": "ffv1"}
MKV_NAMED = {"V_VP9": "VP9", "V_AV1": "AV1", "V_MPEGH/ISO/HEVC": "HEVC", "V_THEORA": "Theora", "V_PRORES": "ProRes",
             "V_MS/VFW/FOURCC": "VfW"}
# ffmpeg's standard frame rates (get_std_framerate), as fractions over 12 * 1001
_STD_RATES = [(i + 1) * 1001 for i in range(30 * 12)] + [(i + 61) * 1001 * 12 for i in range(30)] + \
    [r * 1001 * 12 for r in (80, 120, 240)] + [r * 1000 * 12 for r in (24, 30, 60, 12, 15, 48)]
GIF_DEFAULT_DELAY = 10  # ffmpeg's, in 1/100 s, for a graphic control delay of 0
GIF_TRANSPARENT = np.array([255, 255, 255], np.uint8)  # ffmpeg's trans_color 0x00ffffff, its alpha dropped
MPEG4_QP = 2  # the writer's fixed quantiser: reconstruction steps of 4 on DCT coefficients
# the ftyp box (major brand, minor version, compatible brands) cv2 writes per suffix
MP4_FTYP = {".mp4": b"isom\0\0\2\0isomiso2mp41", ".mov": b"qt  \0\0\2\0qt  ", ".m4v": b"M4V \0\0\2\0M4V isomiso2"}
PS_SUFFIXES = (".mpg", ".mpeg")
PS_PACK_SIZE = 2048  # ffmpeg's mpeg muxer's packet size
PS_PRELOAD = 45000  # its preload of 0.5 s before the first PTS, in 90 kHz ticks
PS_MUX_RATE = 2202035  # in 50 bytes/s, the rate cv2's files carry
# the system header cv2's .mpg files carry: rate bound, one video stream, stream 0xE0's buffer bound
PS_SYSTEM_HEADER = b"\x00\x00\x01\xbb\x00\x09\xc3\x33\x67\x00\x21\xff\xe0\xe0\xe6"
ASF_PACKET = 3200  # ffmpeg's asf muxer's packet size
ASF_PRELOAD_MS = 3100  # its preroll
ASF_PAYLOAD_HEADER = 17  # stream, object number, offset, replicated data (size, time), length
MKV_CLUSTER_MS = 5000  # ffmpeg's cluster_time_limit


def _tag(t: bytes) -> str:
    return t.decode("latin-1").strip("\x00") or "0"


def _codec_of(tag: bytes) -> Optional[str]:
    if tag in MJPEG_TAGS:
        return "mjpeg"
    if tag in MPEG4_TAGS:
        return "mpeg4"
    if tag in I420_TAGS:
        return "i420"
    if tag in MPEG12_TAGS:
        return "mpeg12"
    if tag in H264_TAGS:
        return "h264"
    if tag.upper() in LOSSLESS_TAGS:
        return LOSSLESS_TAGS[tag.upper()]
    version = native.MSMPEG4_VERSIONS.get(tag.upper())
    return MSMPEG4_CODECS[version] if version else None


def mpeg12_kind(data: bytes) -> Optional[str]:
    """"mpeg2" when the first sequence header in data is followed by a
    sequence extension, "mpeg1" when it is not, None without one."""
    i = data.find(b"\x00\x00\x01\xb3")
    if i < 0:
        return None
    j = data.find(b"\x00\x00\x01", i + 4)
    return "mpeg2" if j >= 0 and data[j + 3:j + 4] == b"\xb5" and data[j + 4:j + 5] and data[j + 4] >> 4 == 1 \
        else "mpeg1"


def vol_header(data: bytes) -> Tuple[int, int, int]:
    """(vop_time_increment_resolution, width, height) of the first MPEG-4 VOL
    in data ((0, 0, 0) without one)."""
    res, _, w, h = vol_fields(data)
    return res, w, h


def vol_fields(data: bytes) -> Tuple[int, int, int, int]:
    """(vop_time_increment_resolution, fixed_vop_time_increment (0 without a
    fixed rate), width, height) of the first MPEG-4 VOL in data (zeros
    without one)."""
    m = re.search(rb"\x00\x00\x01[\x20-\x2f]", data)
    if m is None:
        return 0, 0, 0, 0
    bits = "".join(f"{b:08b}" for b in data[m.end():m.end() + 32])
    p = 1 + 8  # random_accessible_vol, video_object_type_indication
    p += 1 + (7 if bits[p] == "1" else 0)  # is_object_layer_identifier: verid, priority
    p += 4 + (16 if bits[p:p + 4] == "1111" else 0)  # aspect_ratio_info: an extended PAR
    if bits[p] == "1":  # vol_control_parameters: chroma_format, low_delay, vbv_parameters
        p += 3
        p += 79 if bits[p + 1] == "1" else 0
        p += 1
    p += 1
    p += 2 + 1  # video_object_layer_shape, marker
    res = int(bits[p:p + 16] or "0", 2)
    p += 16 + 1  # marker
    fixed = 0
    if bits[p:p + 1] == "1":  # fixed_vop_rate, fixed_vop_time_increment
        k = max(1, (res - 1).bit_length())
        fixed = int(bits[p + 1:p + 1 + k] or "0", 2)
        p += k
    p += 1
    w, h = int(bits[p + 1:p + 14] or "0", 2), int(bits[p + 15:p + 28] or "0", 2)
    return res, fixed, w, h


def vol_time_resolution(data: bytes) -> int:
    """vop_time_increment_resolution of the first MPEG-4 VOL in data (0 without one)."""
    return vol_header(data)[0]


def mpeg12_rate(data: bytes) -> Tuple[int, int]:
    """The frame rate (num, den) of the first sequence header in data, with
    MPEG-2's frame_rate_extension_n / _d, as libavcodec reports it."""
    i = data.find(b"\x00\x00\x01\xb3")
    if i < 0 or len(data) < i + 12:
        return 0, 1
    num, den = MPEG12_RATES.get(data[i + 7] & 15, (0, 1))
    j = data.find(b"\x00\x00\x01\xb5", i + 4)
    if j >= 0 and len(data) >= j + 10 and data[j + 4] >> 4 == 1 and mpeg12_kind(data[i:]) == "mpeg2":
        n, d = (data[j + 9] >> 5) & 3, data[j + 9] & 31
        num, den = num * (n + 1), den * (d + 1)
    g = math.gcd(num, den) or 1
    return num // g, den // g


def av_reduce(num: int, den: int, limit: int) -> Tuple[int, int]:
    """num / den as the closest fraction with both terms at most limit, as
    libavutil's av_reduce computes it (continued fractions)."""
    g = math.gcd(num, den)
    if g:
        num, den = num // g, den // g
    a0n, a0d, a1n, a1d = 0, 1, 1, 0
    if num <= limit and den <= limit:
        return num, den
    while den:
        x = num // den
        nxt = num - den * x
        a2n, a2d = x * a1n + a0n, x * a1d + a0d
        if a2n > limit or a2d > limit:
            if a1n:
                x = (limit - a0n) // a1n
            if a1d:
                x = min(x, (limit - a0d) // a1d)
            if den * (2 * x * a1d + a0d) > num * a1d:
                a1n, a1d = x * a1n + a0n, x * a1d + a0d
            break
        a0n, a0d, a1n, a1d = a1n, a1d, a2n, a2d
        num, den = den, nxt
    return a1n, a1d


def cv2_fps_fraction(fps: float) -> Tuple[int, int]:
    """fps as (num, den), den a power of ten, as cv2's writer turns a
    double into a frame rate."""
    den = 1
    num = int(fps + 0.5)
    while abs(num / den - fps) > 0.001:
        den *= 10
        num = int(fps * den + 0.5)
    return num, den


def png_frame(data: bytes, size: Tuple[int, int]) -> np.ndarray:
    """One PNG video frame as cv2 gives it: ffmpeg's png decoder (no gamma,
    no EXIF orientation; 1-, 2- and 4-bit grey scaled to 8 bits; a palette
    index past PLTE black), then swscale to BGR24, which drops alpha, copies
    8-bit samples and rounds 16-bit grey to (v + 128) >> 8 (all measured
    against libswscale). 16-bit RGB, which swscale converts through its
    internal YUV, raises ValueError, as do APNG, a cut frame and a frame of
    another size than the track's."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("a frame that is not a PNG")
    if b"acTL" in data[:max(data.find(b"IDAT"), 0)]:
        raise ValueError("an APNG frame (an animated PNG) is not supported")
    png = _png(data, "PNG frame")
    h, w = png.pix.shape[:2]
    if (w, h) != tuple(size):
        raise ValueError(f"a PNG frame of {w}x{h} in a track of {size[0]}x{size[1]}")
    pix, depth, ctype = png.pix, png.depth, png.ctype
    if depth == 16:
        if ctype in (2, 6):
            raise ValueError("16-bit RGB PNG frames (swscale converts them through its internal YUV) are not "
                             "supported")
        v = (pix[..., 0].astype(np.int32) << 8) | pix[..., 1]  # the grey sample, big-endian
        grey = np.minimum((v + 128) >> 8, 255).astype(np.uint8)
        return np.repeat(grey[:, :, None], 3, axis=2)
    if ctype in (0, 4):
        return np.repeat(pix[:, :, :1], 3, axis=2)
    if ctype == 3:
        palette = np.zeros((256, 3), np.uint8)
        if png.palette is None:
            raise ValueError("a palette PNG frame without a PLTE chunk")
        palette[:min(len(png.palette), 256)] = png.palette[:256]
        return np.ascontiguousarray(palette[pix[..., 0]][:, :, ::-1])
    return np.ascontiguousarray(pix[:, :, 2::-1])


# ------------------------------------------------------------------ reading


class VideoReader:
    """Frames of a video file, BGR uint8, in order; ``fps``, ``total``,
    ``fourcc`` and ``size`` (width, height) as cv2 reports them. Use as an
    iterable, once; :meth:`close` (or ``with``) releases the file."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._f: BinaryIO = open(self.path, "rb")
        try:
            self._open()
        except (ValueError, struct.error, IndexError) as e:
            self._f.close()
            if isinstance(e, ValueError) and str(e).startswith(str(self.path)):
                raise
            raise ValueError(f"{self.path}: corrupt or truncated {self.container} file ({e})") from None
        except BaseException:
            self._f.close()
            raise

    # container dispatch
    container = "video"

    def _open(self) -> None:
        head = self._f.read(12)
        self._f.seek(0, 2)
        self._size = self._f.tell()
        self.extradata = b""
        self.keyframes: Optional[set] = None  # MP4 stss: the sync samples, None when all are
        self.shown: Optional[list] = None  # MP4 edit list: the samples shown, None for all
        self.pts: Optional[list] = None  # MP4 composition (display) times where they differ from decode times
        self.codec_tag = b""  # the container's fourcc for the codec (AVI, a Matroska VfW track), as ffmpeg's codec_tag
        self.bits_per_coded_sample = 0  # BITMAPINFOHEADER's biBitCount, or an MP4 sample entry's depth
        self.bottom_up = False
        if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
            self.container = "AVI"
            self._open_avi()
        elif head.startswith(EBML_MAGIC):
            self.container = "Matroska"
            self._open_mkv()
        elif head.startswith(GIF_SIGNATURES):
            self.container = "GIF"
            self._open_gif()
        elif head[4:8] in (b"ftyp", b"moov", b"mdat", b"free", b"wide", b"skip", b"pnot", b"moof", b"uuid"):
            self.container = "MP4" if self.path.suffix.lower() in (".mp4", ".m4v") else "QuickTime/MP4"
            self._open_mp4()
        elif head.startswith(b"\x00\x00\x01\xba"):
            self.container = "MPEG-PS"
            self._open_ps()
        elif head.startswith(b"\x00\x00\x01\xb3"):
            self.container = "MPEG video"
            self._open_es()
        elif head.startswith(b"\x00\x00\x01") and (head[3] <= 0x2F or head[3] in (0xB0, 0xB2, 0xB5, 0xB6)):
            self.container = "MPEG-4 video"
            self._open_m4v()
        elif head.startswith(ASF_MAGIC):
            self.container = "ASF"
            self._open_asf()
        else:
            raise ValueError(f"{self.path}: not a video file the port reads (GIF, AVI, MP4, MOV, MPEG-PS, MPEG "
                             f"video, MPEG-4 video, Matroska, WebM, ASF / WMV)")
        if self.codec == "mpeg12":
            self.codec = self._mpeg12_kind()
        self.fourcc = CV2_FOURCC[self.codec]

    def _sample(self, sample) -> bytes:
        """A sample's bytes: (offset, size), or an ASF frame's fragments as a
        tuple of them."""
        if isinstance(sample[0], tuple):
            return b"".join(self._read(o, n) for o, n in sample)
        return self._read(*sample)

    def _refuse(self, what: str) -> NoReturn:
        raise ValueError(f"{self.path}: {self.container} with {what} is not supported")

    def _read(self, off: int, n: int) -> bytes:
        if off < 0 or n < 0 or off + n > self._size:
            raise ValueError(f"{self.path}: truncated {self.container} file (a chunk of {n} bytes at {off} "
                             f"is past the end of {self._size})")
        self._f.seek(off)
        return self._f.read(n)

    # ---- AVI

    def _riff_chunks(self, off: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
        """(fourcc, data offset, data size) of the chunks in [off, end)."""
        while off + 8 <= end:
            cid, n = struct.unpack("<4sI", self._read(off, 8))
            if off + 8 + n > self._size:
                if cid == b"LIST" or cid == b"RIFF":
                    n = self._size - off - 8  # a list cut short: its chunks are read as far as they go
                else:
                    raise ValueError(f"{self.path}: truncated AVI file (chunk {_tag(cid)} of {n} bytes)")
            yield cid, off + 8, n
            off += 8 + n + (n & 1)

    def _open_avi(self) -> None:
        riff_end = min(self._size, 8 + struct.unpack("<I", self._read(4, 4))[0])
        hdrl = movi = None
        idx1 = None
        for cid, o, n in self._riff_chunks(12, riff_end):
            if cid == b"LIST":
                kind = self._read(o, 4)
                if kind == b"hdrl":
                    hdrl = (o + 4, o + n)
                elif kind == b"movi":
                    movi = (o, o + n)
            elif cid == b"idx1":
                idx1 = (o, n)
        if hdrl is None or movi is None:
            raise ValueError(f"{self.path}: corrupt AVI file (no {'hdrl' if hdrl is None else 'movi'} list)")
        stream = 0
        strh = strf = None
        for cid, o, n in self._riff_chunks(*hdrl):
            if cid == b"LIST" and self._read(o, 4) == b"strl":
                h = f = None
                for c2, o2, n2 in self._riff_chunks(o + 4, o + n):
                    if c2 == b"strh":
                        h = self._read(o2, n2)
                    elif c2 == b"strf":
                        f = self._read(o2, n2)
                if h is not None and h[:4] == b"vids" and f is not None:
                    strh, strf = h, f
                    break
                stream += 1
        if strh is None:
            raise ValueError(f"{self.path}: AVI file without a video stream")
        handler = strh[4:8]
        scale, rate = struct.unpack("<II", strh[20:28])
        length = struct.unpack("<I", strh[32:36])[0]
        _, width, height, _, bits, compression = struct.unpack("<IiiHHI", strf[:20])
        tag = struct.pack("<I", compression)
        if compression == 0:
            if bits != 24:
                self._refuse(f"{bits}-bit uncompressed (BI_RGB) video")
            self.codec = "bgr24"
            self.bottom_up = height > 0
        else:
            self.codec = _codec_of(tag) or _codec_of(handler)
            if self.codec is None:
                name = NAMED_TAGS.get(tag, NAMED_TAGS.get(handler, f"the '{_tag(tag)}' codec"))
                self._refuse(f"{name} video ('{_tag(tag)}')")
            if self.codec not in ("mjpeg", "i420", "mpeg12") and len(strf) > 40:
                self.extradata = strf[40:]
            self.codec_tag = tag
            self.bits_per_coded_sample = bits
        self.size = (abs(width), abs(height))
        if not (scale and rate):
            raise ValueError(f"{self.path}: corrupt AVI file (stream rate {rate}/{scale})")
        self.fps = rate / scale
        ids = (b"%02ddc" % stream, b"%02ddb" % stream)
        samples = self._avi_index(idx1, movi, ids) if idx1 else []
        if not samples:
            samples = list(self._scan_movi(*movi, ids))
        # OpenDML: the RIFF AVIX segments after the first hold more of movi
        off = riff_end + (riff_end & 1)
        while off + 12 <= self._size:
            cid, n, kind = struct.unpack("<4sI4s", self._read(off, 12))
            if cid != b"RIFF" or kind != b"AVIX":
                break
            end = min(self._size, off + 8 + n)
            for c2, o2, n2 in self._riff_chunks(off + 12, end):
                if c2 == b"LIST" and self._read(o2, 4) == b"movi":
                    samples += list(self._scan_movi(o2, o2 + n2, ids))
            off = end + (end & 1)
        self.samples = [(o, n) for o, n in samples if n > 0]
        self.total = length if length else len(self.samples)

    def _avi_index(self, idx1, movi, ids) -> List[Tuple[int, int]]:
        o, n = idx1
        raw = self._read(o, n - n % 16)
        entries = [struct.unpack("<4sIII", raw[i:i + 16]) for i in range(0, len(raw), 16)]
        entries = [(e[2], e[3]) for e in entries if e[0] in ids]
        if not entries:
            return []
        # offsets count from the movi list's fourcc, or from the file's start
        base = movi[0]
        first_off, _ = entries[0]
        if self._read(first_off + base, 4) not in ids and first_off + 8 <= self._size and \
                self._read(first_off, 4) in ids:
            base = 0
        out = []
        for off, size in entries:
            if self._read(base + off, 4) not in ids:
                raise ValueError(f"{self.path}: corrupt AVI index (entry at {off} does not name the video stream)")
            out.append((base + off + 8, size))
            self._read(base + off + 8, size)  # bounds
        return out

    def _scan_movi(self, o: int, end: int, ids) -> Iterator[Tuple[int, int]]:
        for cid, o2, n2 in self._riff_chunks(o + 4 if self._read(o, 4) == b"movi" else o, end):
            if cid in ids:
                yield o2, n2
            elif cid == b"LIST" and self._read(o2, 4) == b"rec ":
                yield from self._scan_movi(o2 + 4, o2 + n2, ids)

    # ---- ISO-BMFF

    def _boxes(self, off: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
        """(type, payload offset, payload size) of the boxes in [off, end)."""
        while off + 8 <= end:
            n, t = struct.unpack(">I4s", self._read(off, 8))
            h = 8
            if n == 1:
                n = struct.unpack(">Q", self._read(off + 8, 8))[0]
                h = 16
            elif n == 0:
                n = end - off
            if n < h or off + n > end:
                raise ValueError(f"{self.path}: truncated {self.container} file (box '{_tag(t)}' of {n} bytes)")
            yield t, off + h, n - h
            off += n

    def _child(self, o: int, n: int, t: bytes) -> Optional[Tuple[int, int]]:
        return next(((o2, n2) for t2, o2, n2 in self._boxes(o, o + n) if t2 == t), None)

    def _open_mp4(self) -> None:
        moov = None
        for t, o, n in self._boxes(0, self._size):
            if t in (b"moof", b"mfra"):
                raise ValueError(f"{self.path}: fragmented MP4 ('{_tag(t)}' boxes) is not supported")
            if t == b"moov":
                moov = (o, n)
        if moov is None:
            raise ValueError(f"{self.path}: {self.container} file without a 'moov' box")
        if self._child(*moov, b"mvex"):
            raise ValueError(f"{self.path}: fragmented MP4 ('mvex' box) is not supported")
        mvhd = self._child(*moov, b"mvhd")
        movie_scale = self._full_box_times(mvhd)[0] if mvhd else 1000
        for t, o, n in self._boxes(moov[0], moov[0] + moov[1]):
            if t != b"trak":
                continue
            mdia = self._child(o, n, b"mdia")
            hdlr = mdia and self._child(*mdia, b"hdlr")
            if not hdlr or self._read(hdlr[0] + 8, 4) != b"vide":
                continue
            self._read_track(o, n, mdia, movie_scale)
            return
        raise ValueError(f"{self.path}: {self.container} file without a video track")

    def _full_box_times(self, box) -> Tuple[int, int]:
        """(timescale, duration) of an mvhd or mdhd box."""
        o, _ = box
        if self._read(o, 1)[0] == 1:
            scale, duration = struct.unpack(">IQ", self._read(o + 20, 12))
        else:
            scale, duration = struct.unpack(">II", self._read(o + 12, 8))
        return scale, duration

    def _read_track(self, o: int, n: int, mdia, movie_scale: int) -> None:
        mdhd = self._child(*mdia, b"mdhd")
        if not mdhd:
            raise ValueError(f"{self.path}: corrupt {self.container} file (video track without an 'mdhd' box)")
        timescale = self._full_box_times(mdhd)[0]
        minf = self._child(*mdia, b"minf")
        stbl = minf and self._child(*minf, b"stbl")
        if not stbl or not timescale:
            raise ValueError(f"{self.path}: corrupt {self.container} file (video track without a sample table)")
        box = {t: (o2, n2) for t, o2, n2 in self._boxes(stbl[0], stbl[0] + stbl[1])}
        if b"stsd" not in box:
            raise ValueError(f"{self.path}: corrupt {self.container} file (no 'stsd' box)")
        so, _ = box[b"stsd"]
        entry_size, fmt = struct.unpack(">I4s", self._read(so + 8, 8))
        entry = self._read(so + 8, entry_size)
        self.codec = _codec_of(fmt)
        if self.codec is None or self.codec == "i420":
            name = NAMED_TAGS.get(fmt, f"the '{_tag(fmt)}' codec")
            self._refuse(f"{name} video ('{_tag(fmt)}')")
        width, height = struct.unpack(">HH", entry[32:36])
        self.size = (width, height)
        self.bits_per_coded_sample = struct.unpack(">H", entry[82:84])[0] if len(entry) >= 84 else 0
        if self.codec in ("huffyuv", "ffvhuff", "ffv1"):  # the codec's header in a 'glbl' box
            at = entry.find(b"glbl", 86)
            if at >= 4:
                self.extradata = entry[at + 4:at - 4 + struct.unpack(">I", entry[at - 4:at])[0]]
        if self.codec == "h264":
            at = entry.find(b"avcC", 86)
            if at < 4:
                raise ValueError(f"{self.path}: an '{_tag(fmt)}' sample entry without an 'avcC' box")
            n_avcc = struct.unpack(">I", entry[at - 4:at])[0]
            self.extradata = entry[at + 4:at - 4 + n_avcc]
        if self.codec == "mpeg4":
            esds = entry.find(b"esds")
            if esds < 0:
                raise ValueError(f"{self.path}: mp4v sample entry without an 'esds' box")
            oti, self.extradata = self._decoder_specific_info(entry[esds + 4:])
            if oti in MP4_MPEG12_OTI:
                self.codec = "mpeg12"
            elif oti == MP4_PNG_OTI:
                self.codec, self.extradata = "png", b""
            elif oti != 0x20:
                raise ValueError(f"{self.path}: mp4v track of object type 0x{oti:02x} (not MPEG-4 Visual, MPEG-1, "
                                 f"MPEG-2 video or PNG) is not supported")
        # the sample table
        sizes = self._stsz(box)
        chunks = self._chunk_offsets(box)
        stsc = self._table(box, b"stsc", ">III")
        offsets = []
        for i, (first, per, _) in enumerate(stsc):
            last = stsc[i + 1][0] - 1 if i + 1 < len(stsc) else len(chunks)
            for c in range(first - 1, min(last, len(chunks))):
                off = chunks[c]
                for _ in range(per):
                    if len(offsets) == len(sizes):
                        break
                    offsets.append(off)
                    off += sizes[len(offsets) - 1]
        if len(offsets) != len(sizes):
            raise ValueError(f"{self.path}: corrupt {self.container} sample table ({len(offsets)} offsets for "
                             f"{len(sizes)} samples)")
        durations = []
        for count, delta in self._table(box, b"stts", ">II"):  # a run no longer than the samples left to time
            durations += [delta] * min(count, len(sizes) - len(durations))
        if b"stss" in box:
            self.keyframes = {k - 1 for (k,) in self._table(box, b"stss", ">I")}
        total_duration = sum(durations)
        self.fps = timescale * len(durations) / total_duration if total_duration else 0.0
        self.total = len(sizes)
        samples = [(o2, s) for o2, s in zip(offsets, sizes)]
        for o2, s in samples:
            if o2 + s > self._size:
                raise ValueError(f"{self.path}: truncated {self.container} file (sample at {o2} past the end)")
        self.samples = samples
        times = [int(t) for t in np.concatenate([[0], np.cumsum(durations)])[:-1]]
        if b"ctts" in box:  # composition offsets: display times (B-VOPs) apart from decode times
            version = self._read(box[b"ctts"][0], 1)[0]
            offsets = []
            for count, off in self._table(box, b"ctts", ">Ii" if version else ">II"):
                offsets += [off] * min(count, len(times) - len(offsets))
            offsets = (offsets + [0] * len(times))[:len(times)]
            self.pts = [t + off for t, off in zip(times, offsets)]
            times = self.pts
        self.shown = self._edit_list(o, n, times, timescale, movie_scale)

    def _decoder_specific_info(self, esds: bytes) -> Tuple[int, bytes]:
        """The objectTypeIndication and the DecoderSpecificInfo (tag 5) of an
        esds payload (after version/flags)."""
        p = 4

        def desc(p):
            tag = esds[p]
            p += 1
            size = 0
            for _ in range(4):
                b = esds[p]
                p += 1
                size = (size << 7) | (b & 0x7F)
                if not b & 0x80:
                    break
            return tag, p, size

        tag, p, size = desc(p)
        if tag != 3:
            raise ValueError(f"{self.path}: corrupt esds (no ES descriptor)")
        flags = esds[p + 2]
        p += 3 + (2 if flags & 0x80 else 0)
        if flags & 0x40:
            p += 1 + esds[p]
        if flags & 0x20:
            p += 2
        tag, p, size = desc(p)
        if tag != 4:
            raise ValueError(f"{self.path}: corrupt esds (no decoder configuration)")
        oti = esds[p]
        p += 13
        if p >= len(esds):
            return oti, b""
        tag, p, size = desc(p)
        return oti, (esds[p:p + size] if tag == 5 else b"")

    def _table(self, box, name: bytes, fmt: str) -> list:
        if name not in box:
            raise ValueError(f"{self.path}: corrupt {self.container} file (no '{_tag(name)}' box)")
        o, n = box[name]
        count = struct.unpack(">I", self._read(o + 4, 4))[0]
        width = struct.calcsize(fmt)
        if 8 + count * width > n:
            raise ValueError(f"{self.path}: corrupt {self.container} file ('{_tag(name)}' holds {count} entries "
                             f"in {n} bytes)")
        raw = self._read(o + 8, count * width)
        return list(struct.iter_unpack(fmt, raw))

    def _stsz(self, box) -> list:
        if b"stsz" not in box:
            raise ValueError(f"{self.path}: corrupt {self.container} file (no 'stsz' box)")
        o, n = box[b"stsz"]
        uniform, count = struct.unpack(">II", self._read(o + 4, 8))
        if uniform:
            return [uniform] * count
        if 12 + 4 * count > n:
            raise ValueError(f"{self.path}: corrupt {self.container} file ('stsz' holds {count} entries in {n} bytes)")
        return list(np.frombuffer(self._read(o + 12, 4 * count), ">u4").astype(np.int64))

    def _chunk_offsets(self, box) -> list:
        if b"stco" in box:
            return [v for (v,) in self._table(box, b"stco", ">I")]
        if b"co64" in box:
            return [v for (v,) in self._table(box, b"co64", ">Q")]
        raise ValueError(f"{self.path}: corrupt {self.container} file (no 'stco' or 'co64' box)")

    def _edit_list(self, o: int, n: int, times: list, timescale: int, movie_scale: int) -> Optional[list]:
        """The indices of the samples the edit list shows, in display order,
        or None for all in their order; as ffmpeg's mov demuxer applies a
        list (rate 1): each edit shows the samples whose display time (the
        decode time plus the composition offset) lies in [media_time,
        media_time + duration); empty edits shift presentation only."""
        edts = self._child(o, n, b"edts")
        elst = edts and self._child(*edts, b"elst")
        if not elst:
            return None
        eo, _ = elst
        version = self._read(eo, 1)[0]
        count = struct.unpack(">I", self._read(eo + 4, 4))[0]
        fmt = ">QqHH" if version == 1 else ">IiHH"
        width = struct.calcsize(fmt)
        edits = list(struct.iter_unpack(fmt, self._read(eo + 8, count * width)))
        shown: list = []
        for seg, media_time, rate, _ in edits:
            if media_time == -1:
                continue
            if rate != 1:
                raise ValueError(f"{self.path}: an edit list with rate {rate} is not supported")
            stop = media_time + -(-seg * timescale // movie_scale)  # an edit of duration 0 shows nothing
            shown += sorted((i for i, t in enumerate(times) if media_time <= t < stop), key=lambda i: (times[i], i))
        everything = sorted(range(len(times)), key=lambda i: (times[i], i))
        return None if shown == everything else shown

    # ---- Matroska / WebM

    def _vint(self, off: int, marker: bool) -> Tuple[Optional[int], int]:
        """(value, length) of the EBML number at off: an element ID with its
        marker bit kept, or a size without it (None when all its bits are
        set: an unknown size)."""
        first = self._read(off, 1)[0]
        n = 9 - first.bit_length()
        if n > (4 if marker else 8):
            raise ValueError(f"{self.path}: corrupt {self.container} file (a bad EBML {'ID' if marker else 'size'} "
                             f"at {off})")
        raw = int.from_bytes(self._read(off, n), "big")
        if marker:
            return raw, n
        v = raw & ((1 << (7 * n)) - 1)
        return (None if v == (1 << (7 * n)) - 1 else v), n

    def _element(self, off: int, end: int) -> Tuple[int, int, Optional[int]]:
        """(ID, data offset, size or None) of the element at off, inside a
        parent that ends at end."""
        eid, n1 = self._vint(off, True)
        size, n2 = self._vint(off + n1, False)
        data = off + n1 + n2
        if data > end or (size is not None and data + size > end):
            raise ValueError(f"{self.path}: truncated {self.container} file (element 0x{eid:X} of "
                             f"{size} bytes at {off} is past its end at {end})")
        return eid, data, size

    def _children(self, off: int, end: int) -> Iterator[Tuple[int, int, int]]:
        while off < end:
            eid, data, size = self._element(off, end)
            if size is None:
                raise ValueError(f"{self.path}: corrupt {self.container} file (element 0x{eid:X} of unknown size)")
            yield eid, data, size
            off = data + size

    def _uint(self, off: int, size: int) -> int:
        return int.from_bytes(self._read(off, size), "big") if size else 0

    def _open_mkv(self) -> None:
        """Matroska and WebM as ffmpeg's demuxer reads them for cv2: the first
        video track's blocks in file order. ``fps`` is ffmpeg's average frame
        rate, 1e9 / DefaultDuration as av_reduce gives it with terms up to
        30000 (29.97 for a DefaultDuration of 33366700 ns, 30000/1001 for
        33366667); without DefaultDuration, the first of ffmpeg's standard
        rates that puts every block on its timestamp (rounded to the tick),
        else the mean rate of the timestamps. ``total`` is cv2's
        floor(duration * fps + 0.5) on the Info Duration (in microseconds,
        truncated), and without a Duration the same on INT64_MIN ticks, the
        negative count cv2 reports for such a file (ffmpeg's live output).
        Measured against cv2 at 25, 30, 29.97 and 30000/1001 fps, without a
        Duration, and without a DefaultDuration at 25, 3.003 and 30000/1001."""
        eid, data, size = self._element(0, self._size)
        if size is None:
            raise ValueError(f"{self.path}: corrupt Matroska file (EBML header of unknown size)")
        doctype = ""
        for e, o, n in self._children(data, data + size):
            if e == MKV["DocType"]:
                doctype = self._read(o, n).rstrip(b"\0").decode("latin-1")
        if doctype not in ("matroska", "webm"):
            raise ValueError(f"{self.path}: an EBML file of DocType '{doctype}' is not Matroska or WebM")
        self.container = "WebM" if doctype == "webm" else "Matroska"
        off = data + size
        while True:
            eid, data, size = self._element(off, self._size)
            if eid == MKV["Segment"]:
                break
            if size is None:
                raise ValueError(f"{self.path}: corrupt {self.container} file (element 0x{eid:X} of unknown size)")
            off = data + size
        seg_end = self._size if size is None else data + size
        scale, duration, entries, blocks = 1000000, None, [], []
        pos = data
        while pos < seg_end:
            eid, o, n = self._element(pos, seg_end)
            if eid == MKV["Cluster"]:
                pos = self._mkv_cluster(o, n, seg_end, blocks)
                continue
            if n is None:
                raise ValueError(f"{self.path}: corrupt {self.container} file (element 0x{eid:X} of unknown size)")
            if eid == MKV["Info"]:
                for e, o2, n2 in self._children(o, o + n):
                    if e == MKV["TimestampScale"]:
                        scale = self._uint(o2, n2)
                    elif e == MKV["Duration"] and n2 in (4, 8):
                        duration = struct.unpack(">f" if n2 == 4 else ">d", self._read(o2, n2))[0]
            elif eid == MKV["Tracks"]:
                entries += [self._mkv_track(o2, n2) for e, o2, n2 in self._children(o, o + n)
                            if e == MKV["TrackEntry"]]
            pos = o + n
        track = next((t for t in entries if t.get("type") == 1), None)
        if track is None:
            raise ValueError(f"{self.path}: {self.container} file without a video track")
        if not scale:
            raise ValueError(f"{self.path}: corrupt {self.container} file (TimestampScale 0)")
        self._mkv_codec(track)
        self.size = (track.get("width", 0), track.get("height", 0))
        mine = [(ts, o, n) for num, ts, o, n in blocks if num == track.get("number")]
        self.samples = [(o, n) for _, o, n in mine]
        tick_num, tick_den = scale // math.gcd(scale, 10 ** 9), 10 ** 9 // math.gcd(scale, 10 ** 9)
        dd = track.get("default_duration")
        if dd:
            num, den = av_reduce(10 ** 9, dd, 30000)
        else:
            num, den = self._guess_rate([ts for ts, _, _ in mine], tick_num, tick_den, True)
        self.fps = num / den if den else 0.0
        if duration is not None:
            seconds = int(duration * scale * 1000 / 1000000) / 1000000
        else:
            seconds = float(-2 ** 63) * (tick_num / tick_den)
        self.total = int(math.floor(seconds * self.fps + 0.5))

    def _mkv_track(self, off: int, size: int) -> dict:
        t: dict = {}
        for e, o, n in self._children(off, off + size):
            if e == MKV["TrackNumber"]:
                t["number"] = self._uint(o, n)
            elif e == MKV["TrackType"]:
                t["type"] = self._uint(o, n)
            elif e == MKV["CodecID"]:
                t["codec"] = self._read(o, n).rstrip(b"\0").decode("latin-1")
            elif e == MKV["CodecPrivate"]:
                t["private"] = self._read(o, n)
            elif e == MKV["DefaultDuration"]:
                t["default_duration"] = self._uint(o, n)
            elif e == MKV["ContentEncodings"]:
                t["encoded"] = True
            elif e == MKV["Video"]:
                for e2, o2, n2 in self._children(o, o + n):
                    if e2 == MKV["PixelWidth"]:
                        t["width"] = self._uint(o2, n2)
                    elif e2 == MKV["PixelHeight"]:
                        t["height"] = self._uint(o2, n2)
                    elif e2 == MKV["ColourSpace"]:
                        t["colour_space"] = self._read(o2, n2)
        return t

    def _mkv_codec(self, track: dict) -> None:
        cid = track.get("codec", "")
        if track.get("encoded"):
            self._refuse(f"a content encoding (compression or encryption) on its {cid} track")
        private = track.get("private", b"")
        self.codec = MKV_CODECS.get(cid)
        if cid == "V_MS/VFW/FOURCC" and len(private) >= 40:
            tag = private[16:20]
            self.codec = _codec_of(tag)
            self.codec_tag = tag
            if self.codec is None or self.codec == "h264" and self.container == "WebM":
                name = "H.264" if self.codec else NAMED_TAGS.get(tag, f"the {_tag(tag)!r} codec")
                self._refuse(f"{name} video ('V_MS/VFW/FOURCC', '{_tag(tag)}')")
            self.bits_per_coded_sample = struct.unpack("<H", private[14:16])[0]
            private = private[40:]
        elif cid == "V_UNCOMPRESSED":
            space = track.get("colour_space", b"")
            if space[:4] not in I420_TAGS:
                self._refuse(f"uncompressed video of ColourSpace '{_tag(space[:4])}'")
            self.codec = "i420"
        if self.codec is None or self.codec == "h264" and self.container == "WebM":
            self._refuse(f"{MKV_NAMED.get(cid, 'H.264' if self.codec else f'the {cid!r} codec')} video ('{cid}')")
        if self.codec not in ("mjpeg", "i420", "vp8", "png"):
            self.extradata = private

    def _mkv_cluster(self, off: int, size: Optional[int], seg_end: int, blocks: list) -> int:
        """Appends the cluster's blocks (track, timestamp, offset, size) to
        blocks; returns where the cluster ends (for one of unknown size, at
        the next element of the segment's level)."""
        end = seg_end if size is None else off + size
        t0 = None
        pos = off
        while pos < end:
            eid, o, n = self._element(pos, end)
            if size is None and eid in MKV_TOP_LEVEL:
                return pos
            if n is None:
                raise ValueError(f"{self.path}: corrupt {self.container} file (element 0x{eid:X} of unknown size)")
            if eid == MKV["Timestamp"]:
                t0 = self._uint(o, n)
            elif eid == MKV["SimpleBlock"]:
                blocks.append(self._mkv_block(o, n, t0))
            elif eid == MKV["BlockGroup"]:
                blocks += [self._mkv_block(o2, n2, t0) for e, o2, n2 in self._children(o, o + n) if e == MKV["Block"]]
            elif eid == MKV["EncryptedBlock"]:
                self._refuse("encrypted blocks")
            pos = o + n
        return end

    def _mkv_block(self, off: int, size: int, t0: Optional[int]) -> Tuple[int, int, int, int]:
        track, n = self._vint(off, False)
        if size < n + 4 or track is None:
            raise ValueError(f"{self.path}: corrupt {self.container} file (a block of {size} bytes at {off})")
        rel, flags = struct.unpack(">hB", self._read(off + n, 3))
        if flags & 0x06:
            self._refuse("laced blocks")
        if t0 is None:
            raise ValueError(f"{self.path}: corrupt {self.container} file (a block before its cluster's Timestamp)")
        return track, t0 + rel, off + n + 3, size - n - 3

    @staticmethod
    def _guess_rate(stamps: list, tick_num: int, tick_den: int, consecutive: bool) -> Tuple[int, int]:
        """(num, den) frame rate of timestamps in ticks of tick_num /
        tick_den s: of ffmpeg's standard rates (with ``consecutive``, only
        those whose frame times, rounded to the tick, are within a tick of
        every timestamp, one a frame), the one whose frame phases vary least
        (ffmpeg's error measure), else the mean rate of the timestamps."""
        if len(stamps) < 2 or stamps[-1] <= stamps[0]:
            return 0, 1
        rel = np.array([t - stamps[0] for t in stamps], np.float64)
        seconds = rel * tick_num / tick_den
        best, best_error = None, 0.01
        for rate in _STD_RATES:  # frames per 12 * 1001 seconds
            frames = seconds * rate / (12 * 1001)
            if consecutive and np.abs(np.floor(np.arange(len(rel)) * 12 * 1001 * tick_den / (rate * tick_num) + 0.5)
                                      - rel).max() > 1:
                continue
            for k in (0, 0.5):
                phase = frames - np.rint(frames + k) + k
                error = (phase ** 2).mean() - phase.mean() ** 2
                if error < best_error and (consecutive or best_error > 1e-9):  # a PS: the first rate that fits
                    best, best_error = rate, error
        if best is not None:
            return av_reduce(best, 12 * 1001, 2 ** 31 - 1)
        return av_reduce((len(stamps) - 1) * tick_den, int(rel[-1]) * tick_num, 60000)

    # ---- MPEG-PS and MPEG video

    def _pes_payload(self, o: int, end: int) -> Tuple[int, Optional[int]]:
        """(payload offset, PTS or None) of the PES packet whose header
        starts at o (after its length), in the MPEG-2 or the MPEG-1 form."""
        b = self._read(o, min(end - o, 3) or 1)
        if b[0] >> 6 == 2:  # MPEG-2: flags, header length, then PTS / DTS and the rest
            if len(b) < 3:
                raise ValueError(f"{self.path}: corrupt MPEG-PS file (a PES header cut at {o})")
            hdr = o + 3 + b[2]
            pts = self._pts(o + 3) if b[1] & 0x80 else None
        else:  # MPEG-1: stuffing, STD buffer, PTS / DTS
            p, k = o, 0
            while self._read(p, 1)[0] == 0xFF:
                p, k = p + 1, k + 1
                if k > 16:
                    raise ValueError(f"{self.path}: corrupt MPEG-PS file (more than 16 stuffing bytes at {o})")
            if self._read(p, 1)[0] >> 6 == 1:
                p += 2
            c = self._read(p, 1)[0]
            if c >> 4 == 2:
                pts, hdr = self._pts(p), p + 5
            elif c >> 4 == 3:
                pts, hdr = self._pts(p), p + 10
            elif c == 0x0F:
                pts, hdr = None, p + 1
            else:
                raise ValueError(f"{self.path}: corrupt MPEG-PS file (a PES header byte 0x{c:02x} at {p})")
        if hdr > end:
            raise ValueError(f"{self.path}: corrupt MPEG-PS file (a PES header past its packet at {o})")
        return hdr, pts

    def _pts(self, o: int) -> int:
        b = self._read(o, 5)
        return ((b[0] >> 1) & 7) << 30 | (b[1] << 7 | b[2] >> 1) << 15 | (b[3] << 7 | b[4] >> 1)

    def _open_ps(self) -> None:
        """MPEG-PS as ffmpeg's mpeg demuxer reads it for cv2: pack headers
        of MPEG-1 and MPEG-2, the system header, PES packets of either form
        (MPEG-1 stuffing and STD fields, MPEG-2 header extensions), padding,
        private and audio streams passed over; the first video stream
        (0xE0-0xEF) in file order, its payloads joined. Its codec is what
        the stream holds: a sequence header is MPEG-1/2 (``native.
        Mpeg12Decoder``), a VOL MPEG-4 Part 2 (cv2's own ``.mpg`` writer).

        ``fps`` is the sequence header's frame rate (MPEG-2's extension
        applied); for MPEG-4, ffmpeg's guess among its standard rates from
        the packets' PTS (a PTS is on the first frame that starts in a
        packet only), and with one PTS the VOL's vop_time_increment_resolution. ``total`` is cv2's floor(seconds x fps + 0.5), seconds
        from ffmpeg's estimate off the timestamps: the largest PTS of a
        packet plus one packet's duration (a frame, and half a frame for
        MPEG-1, whose parser counts fields: 90 kHz ticks rounded down), less
        the first packet's PTS, turned into microseconds and rounded.
        Measured against cv2's own files at 24, 25, 29.97, 30 and
        10 fps, MPEG-1, MPEG-2 with and without B-pictures and MPEG-4; it
        gives 11 for cv2's twelve MPEG-1 frames at 30 fps, as cv2 does."""
        pos, end = 0, self._size
        stream, pieces, stamps = None, [], []
        while pos + 4 <= end:
            head = self._read(pos, 4)
            if head[:3] != b"\x00\x00\x01":
                raise ValueError(f"{self.path}: corrupt MPEG-PS file (no start code at {pos})")
            sid = head[3]
            if sid == PS_END:
                pos += 4
                continue
            if sid == PS_PACK:
                first = self._read(pos + 4, 1)[0]
                if first >> 6 == 1:
                    pos += 14 + (self._read(pos + 13, 1)[0] & 7)
                elif first >> 4 == 2:
                    pos += 12
                else:
                    raise ValueError(f"{self.path}: corrupt MPEG-PS file (a pack header of neither form at {pos})")
                continue
            if sid < PS_SYSTEM:
                raise ValueError(f"{self.path}: corrupt MPEG-PS file (start code 0x{sid:02X} between packets at "
                                 f"{pos})")
            length = int.from_bytes(self._read(pos + 4, 2), "big")
            body, nxt = pos + 6, pos + 6 + length
            if nxt > end:
                raise ValueError(f"{self.path}: truncated MPEG-PS file (a packet of {length} bytes at {pos})")
            if 0xE0 <= sid <= 0xEF and stream in (None, sid) and length:
                stream = sid
                hdr, pts = self._pes_payload(body, nxt)
                if pts is not None:
                    stamps.append(pts)
                if nxt > hdr:
                    pieces.append((hdr, nxt - hdr))
            pos = nxt
        if pos != end:
            raise ValueError(f"{self.path}: truncated MPEG-PS file ({end - pos} bytes after its last packet)")
        if not pieces:
            raise ValueError(f"{self.path}: MPEG-PS file without a video stream")
        self.samples = pieces
        start = b"".join(self._read(o, n) for o, n in pieces[:64])[:1 << 16]
        self.codec = self._es_codec(start)
        if self.codec == "mpeg4":
            steps = len(set(stamps)) > 1
            num, den = self._guess_rate(stamps, 1, PS_TICKS, False) if steps else (vol_time_resolution(start), 1)
        else:
            num, den = mpeg12_rate(start)
        self.fps = num / den if den and num else 0.0
        self.size = self._es_size(start) if self.codec == "mpeg12" else vol_header(start)[1:]
        if not stamps or not num:
            self.total = 0
            return
        per_field = 2 if self.codec == "mpeg12" and mpeg12_kind(start) == "mpeg1" else 1
        ticks = max(stamps) + PS_TICKS * den // (num * per_field) - stamps[0]
        us = (ticks * 1000000 + PS_TICKS // 2) // PS_TICKS  # in microseconds, rounded to the nearest
        self.total = int(math.floor(us / 1e6 * self.fps + 0.5))

    def _open_es(self) -> None:
        """A bare MPEG-1/2 video stream (a ``.mpg`` of sequence headers and
        pictures, no system layer), as ffmpeg's raw demuxer reads it for
        cv2: ``fps`` the sequence header's, ``total`` from ffmpeg's estimate
        off the header's bit rate (the file's bits over it; where that is
        below 25 microseconds cv2 takes the stream's unknown duration,
        INT64_MIN ticks of 1/1200000 s). Measured against cv2 on MPEG-1 and
        MPEG-2 streams of libavcodec's."""
        start = self._read(0, min(self._size, 1 << 16))
        self.samples = [(0, self._size)]
        self.codec = "mpeg12"
        num, den = mpeg12_rate(start)
        self.fps = num / den if den else 0.0
        self.size = self._es_size(start)
        i = start.find(b"\x00\x00\x01\xb3")
        rate = (int.from_bytes(start[i + 8:i + 11], "big") >> 6) & 0x3FFFF
        j = start.find(b"\x00\x00\x01\xb5", i + 4)
        if mpeg12_kind(start) == "mpeg2" and j >= 0:
            rate |= ((int.from_bytes(start[j + 5:j + 8], "big") >> 9) & 0xFFF) << 18
        seconds = self._size * 8 / (rate * 400) if rate else 0.0
        if seconds < 0.000025:
            seconds = -2 ** 63 / 1200000
        self.total = int(math.floor(seconds * self.fps + 0.5))

    def _open_m4v(self) -> None:
        """A bare MPEG-4 Part 2 stream (VOS / VO / VOL headers and VOPs, no
        container, under any suffix), as ffmpeg's m4v demuxer reads it for
        cv2: the raw demuxer's frame rate, 25 whatever the VOL says, and its
        unknown duration, INT64_MIN ticks of 1/1200000 s, for ``total`` (the
        negative count cv2 reports). Measured against cv2 on libavcodec's
        streams at 10, 25, 29.97, 30 and 60 fps, with and without B-VOPs,
        as .m4v, .bin and .avi."""
        start = self._read(0, min(self._size, 1 << 16))
        self.samples = [(0, self._size)]
        self.codec = "mpeg4"
        self.fps = 25.0
        _, w, h = vol_header(start)
        self.size = (w, h)
        self.total = int(math.floor(-2 ** 63 / 1200000 * self.fps + 0.5))

    def _es_codec(self, data: bytes) -> str:
        """The codec of a program stream's video payload, by its first start code."""
        i = data.find(b"\x00\x00\x01")
        code = data[i + 3] if 0 <= i < len(data) - 3 else None
        if code == 0xB3:
            return "mpeg12"
        if code is not None and (code <= 0x2F or code in (0xB0, 0xB5)):
            return "mpeg4"
        if code is not None and code & 0x1F in (7, 9) and data[i - 1:i] == b"\x00":
            self._refuse("H.264 video (an H.264 stream in its video packets)")
        self._refuse(f"a video stream of no codec the port reads (first start code "
                     f"{'none' if code is None else f'0x{code:02X}'})")

    def _es_size(self, data: bytes) -> Tuple[int, int]:
        i = data.find(b"\x00\x00\x01\xb3")
        if i < 0 or len(data) < i + 7:
            return 0, 0
        w, h = int.from_bytes(data[i + 4:i + 7], "big") >> 12, int.from_bytes(data[i + 4:i + 7], "big") & 0xFFF
        j = data.find(b"\x00\x00\x01\xb5", i + 4)
        if j >= 0 and len(data) >= j + 7 and data[j + 4] >> 4 == 1 and mpeg12_kind(data[i:]) == "mpeg2":
            w |= ((data[j + 5] & 1) << 1 | data[j + 6] >> 7) << 12
            h |= ((data[j + 6] >> 5) & 3) << 12
        return w, h

    def _mpeg12_kind(self) -> str:
        data = self.extradata + b"".join(map(self._sample, self.samples[:4]))
        kind = mpeg12_kind(data)
        if kind is None:
            raise ValueError(f"{self.path}: {self.container} with MPEG-1/2 video without a sequence header")
        if self.size == (0, 0):
            self.size = self._es_size(data)
        return kind

    def _es_chunks(self, picture: bytes) -> Iterator[bytes]:
        """A program stream's (or a bare stream's) video as chunks that end
        where a picture (its start code ``picture``) starts."""
        buf = bytearray()
        for o, n in self.samples:
            for k in range(0, n, 1 << 20):
                buf += self._read(o + k, min(n - k, 1 << 20))
                at, cut = 0, buf.find(picture, 1)
                while cut > 0:
                    yield bytes(buf[at:cut])
                    at, cut = cut, buf.find(picture, cut + 1)
                del buf[:at]
        if buf:
            yield bytes(buf)

    def _mpeg12_frames(self) -> Iterator[np.ndarray]:
        """Each frame in display order, converted as MPEG-4's are (cv2's
        limited-range BT.601 of yuv420p or yuv422p)."""
        name = "MPEG-2" if self.codec == "mpeg2" else "MPEG-1"
        dec = native.Mpeg12Decoder()
        try:
            chunks = self._es_chunks(b"\x00\x00\x01\x00") if self.container in ("MPEG-PS", "MPEG video") else \
                map(self._sample, self.samples)
            for chunk in itertools.chain([self.extradata] if self.extradata else [], chunks):
                try:
                    got = dec.decode(chunk)
                except ValueError as e:
                    raise ValueError(f"{self.path}: {self.container} with {name} video: {e}") from None
                for (y, u, v), _ in got:
                    yield native.yuv_to_bgr(y, u, v, full_range=False, chroma_left=self.codec == "mpeg2")
            for (y, u, v), _ in dec.flush():
                yield native.yuv_to_bgr(y, u, v, full_range=False, chroma_left=self.codec == "mpeg2")
            self.mpeg12_tally = dec.tally()
        finally:
            dec.close()

    # ---- ASF

    def _asf_objects(self, off: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
        """(GUID, data offset, data size) of the objects in [off, end)."""
        while off + 24 <= end:
            guid, n = self._read(off, 16), struct.unpack("<Q", self._read(off + 16, 8))[0]
            if n < 24 or off + n > end:
                raise ValueError(f"{self.path}: corrupt or truncated ASF file (an object of {n} bytes at {off})")
            yield guid, off + 24, n - 24
            off += n

    def _open_asf(self) -> None:
        """ASF (``.wmv``, ``.asf``) as ffmpeg's asf demuxer reads it for cv2:
        the Header Object's File Properties (preroll, packet size, play
        duration) and first video Stream Properties (a BITMAPINFOHEADER and
        its extradata), then the Data Object's packets of that size: error
        correction data, the length types, several payloads a packet, each a
        fragment of a media object (a frame) with the object's size and
        presentation time, put together by object number and offset, and
        padding; other streams' payloads skipped. A frame's time is its
        presentation time less the preroll (ms).

        ``fps`` is ffmpeg's frame rate as cv2 reads it. For mp4v it comes
        from the packets' durations, which ffmpeg's mpeg4 parser derives from
        the VOL's time resolution (1000 / resolution ms, rounded down, where
        that is at least 1 ms), rounded to a standard rate within 1 %: 25
        for a clip written at 12.5 fps (a resolution of 25), 85/12 for 7
        fps. For MPEG-1 it is the sequence header's rate in fields (50 for
        25: ffmpeg trusts that rate). For the others, and mp4v whose
        resolution is 1000 or more, it is the rate ffmpeg's r_frame_rate
        estimate picks from the first frames' millisecond times
        (:meth:`_asf_rate`): 359/12 (29.9167) for 8 frames at 29.97.
        ``total`` is cv2's floor(duration * fps + 0.5) over the File
        Properties' play duration less the preroll. Measured against cv2 at
        25, 29.97, 12.5 and 7 fps for mp4v, MJPEG and the MS-MPEG-4 family,
        and at 25 for XVID, MPEG-1 and MPEG-2."""
        g = ASF_GUID
        guid, n = struct.unpack("<16sQ", self._read(0, 24))
        if guid != g["header"] or n < 30 or n > self._size:
            raise ValueError(f"{self.path}: corrupt or truncated ASF file (a Header Object of {n} bytes)")
        fileprops = stream = None
        for oguid, o, size in self._asf_objects(30, n):
            if oguid == g["file"]:
                fileprops = self._read(o, size)
            elif oguid == g["stream"] and stream is None:
                body = self._read(o, size)
                if body[:16] == g["video"]:
                    stream = body
            elif oguid == g["extension"]:
                for eguid, _, _ in self._asf_objects(o + 22, o + size):
                    if eguid == g["ext_stream"]:
                        self._refuse("Extended Stream Properties (payload extensions)")
            elif oguid in (g["encryption"], g["ext_encryption"]):
                self._refuse("content encryption")
        if fileprops is None or len(fileprops) < 80:
            raise ValueError(f"{self.path}: corrupt ASF file (no File Properties)")
        file_size, _, _, play, _, preroll, flags, packet, max_packet = struct.unpack("<QQQQQQIII", fileprops[16:76])
        if flags & 1:
            self._refuse("a broadcast (live) stream, of no duration")
        if abs(self._size - file_size) >= min(self._size, file_size) / 20:
            raise ValueError(f"{self.path}: truncated ASF file ({self._size} bytes of the {file_size} its header "
                             f"gives)")
        if packet != max_packet or packet < 24:
            self._refuse(f"packets of varying size ({packet} to {max_packet} bytes)")
        if stream is None:
            raise ValueError(f"{self.path}: ASF file without a video stream")
        ts_len, _, sflags = struct.unpack("<IIH", stream[40:50])
        number = sflags & 0x7F
        if sflags & 0x8000:
            self._refuse("an encrypted video stream")
        specific = stream[54:54 + ts_len]
        width, height, _, fmt_size = struct.unpack("<IIBH", specific[:11])
        bih = specific[11:11 + fmt_size]
        if len(bih) < 40:
            raise ValueError(f"{self.path}: corrupt ASF file (a BITMAPINFOHEADER of {len(bih)} bytes)")
        tag = bih[16:20]
        self.codec = _codec_of(tag)
        if self.codec in (None, "i420", "h264"):
            name = "H.264" if self.codec == "h264" else NAMED_TAGS.get(tag, f"the {_tag(tag)!r} codec")
            self._refuse(f"{name} video ('{_tag(tag)}')")
        self.codec_tag = tag
        self.extradata = bih[40:struct.unpack("<I", bih[:4])[0]]
        self.bits_per_coded_sample = struct.unpack("<H", bih[14:16])[0]
        bw, bh = struct.unpack("<ii", bih[4:12])
        self.size = (abs(bw) or width, abs(bh) or height)
        # the Data Object: its header, then packets of the fixed size
        data = n
        guid, dsize = struct.unpack("<16sQ", self._read(data, 24))
        if guid != g["data"] or dsize < 50:
            raise ValueError(f"{self.path}: corrupt ASF file (no Data Object after the header)")
        end = min(self._size, data + dsize)
        frames, pending = [], {}  # (time ms, data offsets and sizes), object number -> [size, time, parts, filled]
        for p in range(data + 50, end - packet + 1, packet):
            for obj, off, size, osize, ms, pos in self._asf_payloads(self._read(p, packet), p, packet, number):
                got = pending.get(obj)
                if got is None:
                    if off:
                        raise ValueError(f"{self.path}: corrupt ASF file (object {obj} starts at offset {off})")
                    got = pending[obj] = [osize, ms, [], 0]
                if off != got[3] or off + size > got[0]:
                    raise ValueError(f"{self.path}: corrupt ASF file (a fragment of object {obj} at {off} of "
                                     f"{got[0]} bytes, {got[3]} put together)")
                got[2].append((pos, size))
                got[3] += size
                if got[3] == got[0]:
                    frames.append((got[1], got[2]))
                    del pending[obj]
        if pending or (end - data - 50) % packet:
            raise ValueError(f"{self.path}: truncated ASF file (a frame or a packet cut short)")
        self.samples = [parts[0] if len(parts) == 1 else tuple(parts) for _, parts in frames]
        stamps = [ms - preroll for ms, _ in frames]
        # the decoder's frame rate: mp4v's from its VOL, MPEG-1/2's from the
        # sequence header (doubled: ffmpeg counts their fields), none for the others
        rate, mpeg2 = (0, 1), False
        if self.codec == "mpeg4":
            res, fixed = vol_fields(self.extradata)[:2]
            rate = (res, fixed or 1)
        elif self.codec == "mpeg12" and self.samples:
            head = self.extradata + self._sample(self.samples[0])
            num, den = mpeg12_rate(head)
            rate, mpeg2 = (2 * num, den), mpeg12_kind(head) == "mpeg2"
        # a packet's duration as ffmpeg's mpeg4 parser gives it (ms, rounded
        # down); the other codecs have no parser in ASF, and so none
        duration = 1000 * rate[1] // rate[0] if self.codec == "mpeg4" and rate[0] and rate[1] * 1000 > rate[0] else 0
        # ffmpeg estimates r_frame_rate from the times unless the decoder's rate
        # is a time base it trusts (tb_unreliable: 5 to 100 fps, not mp4v, not MPEG-2)
        trusted = 5 * rate[1] <= rate[0] < 101 * rate[1] and tag != b"mp4v" and not mpeg2
        num, den = self._asf_rate(stamps, duration, not trusted)
        if not num:  # r_frame_rate then: the decoder's rate if at most 1000, else the time base's
            num, den = rate if rate[0] and rate[0] <= 1000 * rate[1] else (1000, 1)
        self.fps = num / den
        seconds = (play // 10000 - preroll) / 1000
        self.total = int(math.floor(seconds * self.fps + 0.5))

    def _asf_payloads(self, pk: bytes, at: int, packet: int, number: int):
        """(object number, offset in the object, size, object size, time ms,
        file offset) of each payload of stream ``number`` in the data packet
        pk (at file offset ``at``), as ffmpeg's asf_get_packet and
        asf_read_frame_header read them."""
        def field(kind: int, p: int) -> Tuple[int, int]:
            k = (0, 1, 2, 4)[kind & 3]
            return (int.from_bytes(pk[p:p + k], "little") if k else 0), p + k

        p = 0
        if pk[0] & 0x80:  # error correction data: ffmpeg's muxer writes two bytes (0x82, then 0, 0)
            if (pk[0] & 0x8F) != 0x82 or pk[1] or pk[2]:
                raise ValueError(f"{self.path}: corrupt ASF file (error correction data 0x{pk[0]:02x} in the packet "
                                 f"at {at})")
            p = 3
        lflags, prop = pk[p], pk[p + 1]
        length, p = field(lflags >> 5, p + 2)
        _, p = field(lflags >> 1, p)  # sequence
        padding, p = field(lflags >> 3, p)
        p += 6  # send time, duration
        length = length or packet
        if length > packet or padding >= length:
            raise ValueError(f"{self.path}: corrupt ASF file (a packet of {length} bytes, {padding} of padding, "
                             f"at {at})")
        single = not lflags & 1  # one payload, to the packet's end (before its padding)
        count, kind = (1, 0) if single else (pk[p] & 0x3F, pk[p] >> 6)
        p += 0 if single else 1
        stop = length - padding
        for _ in range(count):
            stream = pk[p] & 0x7F
            obj, p = field(prop >> 4, p + 1)
            off, p = field(prop >> 2, p)
            rep, p = field(prop, p)
            if rep == 1:
                self._refuse("compressed payloads")
            if rep and rep < 8:
                raise ValueError(f"{self.path}: corrupt ASF file (replicated data of {rep} bytes at {at + p})")
            osize, ms = struct.unpack("<II", pk[p:p + 8]) if rep else (0, 0)
            p += rep
            size, p = (stop - p, p) if single else field(kind, p)
            if p + size > stop or not rep:
                raise ValueError(f"{self.path}: corrupt ASF file (a payload of {size} bytes at {at + p})")
            if stream == number:
                yield obj, off, size, osize, ms, at + p
            p += size

    @staticmethod
    def _asf_rate(stamps: list, duration: int, estimate: bool) -> Tuple[int, int]:
        """ffmpeg's frame rate of a stream of millisecond times, as
        avformat_find_stream_info estimates it over the frames it reads (up
        to 41 of them, or until the packets' durations add up to 5 s):
        with ``duration`` (each packet's, in ms) the mean rate rounded to a
        standard rate within 1 %; without, with ``estimate``, r_frame_rate
        from ff_rfps_calculate (the standard rate whose frame times fit the
        timestamps best), which becomes the average rate when its period is
        within 1 ms of the mean interval; else (0, 1)."""
        dts, total = [], 0
        for k, t in enumerate(stamps[:41]):
            if k >= 2:
                if total * 1000 >= 5000000:
                    break
                total += duration
            dts.append(t)
        if total:
            rate = len(dts[2:]) * 1000 / total
            best, best_error = 0, 0.01
            for std in _STD_RATES:
                error = abs(rate / (std / (12 * 1001)) - 1)
                if error < best_error:
                    best, best_error = std, error
            return av_reduce(best, 12 * 1001, 2 ** 31 - 1) if best else av_reduce(len(dts[2:]) * 1000, total, 60000)
        if not estimate:
            return 0, 1
        rates = np.array(_STD_RATES, np.float64)
        err = np.zeros((2, 2, len(rates)))
        alive = np.ones(len(rates), bool)
        n, summed, gcd, last = 0, 0, 0, None
        for t in dts:
            if last is not None and t > last:
                sdts = t / 1000 * rates / (12 * 1001)
                for j in (0, 1):
                    e = sdts - np.rint(sdts + j * 0.5) + j * 0.5
                    err[j, 0] += np.where(alive, e, 0)
                    err[j, 1] += np.where(alive, e * e, 0)
                n += 1
                summed += t - last
                if n % 10 == 0:
                    var = err[:, 1] / n - (err[:, 0] / n) ** 2
                    alive &= ~((var[0] > 0.04) & (var[1] > 0.04))
                if n > 3:
                    gcd = math.gcd(gcd, t - last)
            last = t
        if n > 15 and gcd > 2:
            r = av_reduce(1000, gcd, 2 ** 31 - 1)
        else:
            r = (0, 1)
            if n > 1:
                best, best_error = 0, 0.01
                for i, std in enumerate(_STD_RATES):
                    if not alive[i] or std < 12 * 1001 or summed / n / 1000 < 12 * 1001 * 0.8 / std:
                        continue
                    for j in (0, 1):
                        a = err[j, 0, i] / n
                        error = err[j, 1, i] / n - a * a
                        if error < best_error and best_error > 1e-9:
                            best, best_error = std, error
                if best and best / (12 * 1001) < 1.01 * 1000:
                    r = av_reduce(best, 12 * 1001, 2 ** 31 - 1)
        return r  # also the average rate when it is within 1 ms of the mean interval; cv2 takes it either way

    # ---- GIF

    def _open_gif(self) -> None:
        """ffmpeg's gif demuxer: the frame count is the images', the frame
        rate 100 over the graphic control delays' sum divided by that count
        in whole hundredths (a delay of 0 counted as 10), as cv2 reports
        them; where that is 0 (frames without a graphic control extension),
        100, the time base's rate, which ffmpeg's own guess from the
        timestamps gives for files of one or two frames."""
        self._f.seek(0)
        self._gif_data = self._f.read()
        self.codec = "gif"
        self._gif, self._gif_off = native.gif_header(self._gif_data)
        self.size = (self._gif.width, self._gif.height)
        if not self._gif.width or not self._gif.height or self._gif.width * self._gif.height > 2 ** 30:
            raise ValueError(f"{self.path}: GIF of {self._gif.width} x {self._gif.height} pixels (1 to 2^30)")
        delays = [(f.delay or GIF_DEFAULT_DELAY) if f.has_gce else 0
                  for f in native.gif_frames(self._gif_data, self._gif_off, decode=False)]
        self.total = len(delays)
        per = sum(delays) // max(self.total, 1)
        self.fps = 100.0 / per if per else 100.0

    def _gif_frames(self) -> Iterator[np.ndarray]:
        """Each frame on the canvas as ffmpeg's gif decoder composes it and
        cv2 converts it (BGRA to BGR, alpha dropped): the first frame's
        canvas the global background colour when that frame has no
        transparent index and the file a global table, else ffmpeg's
        transparent colour (white once its alpha is dropped); a frame's
        transparent pixels left as they are; disposal 2 filling its
        rectangle before the next frame (with the transparent colour when
        the frame had a transparent index), 3 restoring the rectangle as it
        was before it, 0, 1 and 4-7 keeping it."""
        g = self._gif
        h, w = g.height, g.width
        canvas = np.empty((h, w, 3), np.uint8)
        background = g.palette[g.background, ::-1] if g.palette is not None else np.zeros(3, np.uint8)
        pending = None  # (rectangle, what to put back) of the previous frame's disposal
        for i, f in enumerate(native.gif_frames(self._gif_data, self._gif_off)):
            fh, fw = f.indices.shape
            if not fw or not fh or f.x + fw > w or f.y + fh > h:
                raise ValueError(f"{self.path}: GIF frame {i} of {fw} x {fh} at ({f.x}, {f.y}) outside its canvas "
                                 f"of {w} x {h}")
            palette = f.palette if f.palette is not None else g.palette
            if palette is None:
                raise ValueError(f"{self.path}: GIF frame {i} without a colour table")
            if i == 0:
                canvas[:] = background if f.transparent < 0 and g.palette is not None else GIF_TRANSPARENT
            elif pending is not None:
                (y, x, ph, pw), fill = pending
                canvas[y:y + ph, x:x + pw] = fill
            rect = (f.y, f.x, fh, fw)
            sub = canvas[f.y:f.y + fh, f.x:f.x + fw]
            pending = None
            if f.disposal == 2:
                pending = rect, GIF_TRANSPARENT if f.transparent >= 0 else background
            elif f.disposal == 3:
                pending = rect, sub.copy()
            bgr = np.ascontiguousarray(palette[:, ::-1])
            if f.transparent < 0:
                sub[:] = bgr[f.indices]
            else:
                opaque = f.indices != f.transparent
                sub[opaque] = bgr[f.indices[opaque]]
            yield canvas.copy()

    # ---- frames

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.codec == "gif":
            try:
                yield from self._gif_frames()
            except ValueError as e:
                if str(e).startswith(str(self.path)):
                    raise
                raise ValueError(f"{self.path}: GIF: {e}") from None
            return
        if self.codec == "mpeg4":
            yield from self._mpeg4_frames()
            return
        if self.codec == "vp8":
            yield from self._vp8_frames()
            return
        if self.codec in MSMPEG4_CODECS.values():
            yield from self._msmpeg4_frames()
            return
        if self.codec == "h264":
            yield from self._h264_frames()
            return
        if self.codec in ("mpeg1", "mpeg2"):
            yield from self._mpeg12_frames()
            return
        if self.codec in LOSSLESS_NAMES:
            yield from self._lossless_frames()
            return
        order = self.shown if self.shown is not None else range(len(self.samples))
        for i in order:
            data = self._sample(self.samples[i])
            try:
                img = self._still(data)
            except ValueError as e:
                if str(e).startswith(str(self.path)):
                    raise
                raise ValueError(f"{self.path}: {self.container} with {self.codec} video, frame {i}: {e}") from None
            yield img

    def _still(self, data: bytes) -> np.ndarray:
        w, h = self.size
        if self.codec == "mjpeg":
            return self._mjpeg_frame(data)
        if self.codec == "bgr24":
            stride = (w * 3 + 3) & ~3
            if len(data) < stride * h:
                raise ValueError(f"{self.path}: an uncompressed frame of {len(data)} bytes, want {stride * h}")
            img = np.frombuffer(data, np.uint8, stride * h).reshape(h, stride)[:, :w * 3].reshape(h, w, 3)
            return (img[::-1] if self.bottom_up else img).copy()
        cw, ch = (w + 1) // 2, (h + 1) // 2  # i420
        if len(data) < w * h + 2 * cw * ch:
            raise ValueError(f"{self.path}: an I420 frame of {len(data)} bytes, want {w * h + 2 * cw * ch}")
        a = np.frombuffer(data, np.uint8)
        y = a[:w * h].reshape(h, w)
        u = a[w * h:w * h + cw * ch].reshape(ch, cw)
        v = a[w * h + cw * ch:w * h + 2 * cw * ch].reshape(ch, cw)
        return native.yuv_to_bgr(y, u, v, full_range=False)

    def _mjpeg_frame(self, data: bytes) -> np.ndarray:
        """One MJPEG frame as cv2.VideoCapture gives it."""
        planes, meta = native.jpeg_decode_planes(data)
        if meta["rgb"]:
            self._refuse("MJPEG frames in RGB")
        if len(planes) == 1:
            return np.repeat(planes[0][:, :, None], 3, axis=2)
        eoi = data.rfind(b"\xff\xd9")
        if meta["height"] * 2 in (self.size[1], self.size[1] - 1) or data.find(b"\xff\xd8", 2, eoi) > 0:
            self._refuse("interlaced MJPEG (two fields per chunk)")
        (h0, v0), (h1, v1) = meta["sampling"][:2]
        sub = (int(h0 // h1).bit_length() - 1, int(v0 // v1).bit_length() - 1) if h1 and v1 else None
        return native.yuv_to_bgr(*planes, full_range=True, subsampling=sub if sub in ((0, 0), (1, 0), (1, 1)) else None)

    def _mpeg4_chunks(self) -> Iterator[bytes]:
        """A program stream's or a bare stream's MPEG-4 video as ffmpeg's
        mpeg4video parser frames it: each chunk ends where a start code
        follows a VOP (so a GOV or a VOL opens the next frame's chunk)."""
        buf = bytearray()
        for o, n in self.samples:
            for k in range(0, n, 1 << 20):
                buf += self._read(o + k, min(n - k, 1 << 20))
                at = 0
                while True:
                    vop = buf.find(b"\x00\x00\x01\xb6", at)
                    cut = buf.find(b"\x00\x00\x01", vop + 4) if vop >= 0 else -1
                    if cut < 0:
                        break
                    yield bytes(buf[at:cut])
                    at = cut
                del buf[:at]
        if buf:
            yield bytes(buf)

    def _display_order(self) -> Tuple[int, list, Optional[set]]:
        """(the first sample to decode, the samples in display order from
        it, the samples an MP4 edit list shows or None for all): the
        decoder's k-th frame is the sample with the k-th display time, and
        an edit list's first frame decodes from the sync sample before it."""
        n = len(self.samples)
        wanted = set(self.shown) if self.shown is not None else None
        start = 0
        if wanted and self.keyframes:
            start = max((k for k in self.keyframes if k <= min(wanted)), default=0)
        order = sorted(range(start, n), key=lambda i: (self.pts[i], i)) if self.pts is not None else \
            list(range(start, n))
        return start, order, wanted

    def _mpeg4_frames(self) -> Iterator[np.ndarray]:
        """Each frame in display order, as libavcodec gives them (B-VOPs
        reordered, one chunk late); an MP4 edit list's frames only
        (:meth:`_display_order`)."""
        start, order, wanted = self._display_order()
        dec = native.Mpeg4Decoder(self.codec_tag)

        def shown(got, k):
            if got is None:
                return None
            if wanted is not None and (k >= len(order) or order[k] not in wanted):
                return None
            (y, u, v), _ = got
            return native.yuv_to_bgr(y, u, v, full_range=False, chroma_left=True)

        try:
            if self.extradata:
                dec.decode(self.extradata)
            chunks = self._mpeg4_chunks() if self.container in ("MPEG-PS", "MPEG-4 video") else \
                map(self._sample, self.samples[start:])
            k = 0  # frames out so far
            for chunk in chunks:
                got = dec.decode(chunk)
                img = shown(got, k)
                k += got is not None
                if img is not None:
                    yield img
            img = shown(dec.flush(), k)
            if img is not None:
                yield img
            self.mpeg4_tally = dec.tally()
        except ValueError as e:
            raise ValueError(f"{self.path}: {self.container} with MPEG-4 video: {e}") from None
        finally:
            dec.close()

    def _msmpeg4_frames(self) -> Iterator[np.ndarray]:
        """Each picture of an MS-MPEG-4 family stream (``native.MsMpeg4Decoder``:
        no reordering, so one a chunk), converted as MPEG-4's are (swscale's
        limited-range BT.601)."""
        tag = CV2_FOURCC[self.codec].upper()  # the version's own fourcc, whatever alias the file gives
        what = f"{self.container} with {native.MSMPEG4_NAMES[native.MSMPEG4_VERSIONS[tag]]} video"
        try:
            dec = native.MsMpeg4Decoder(tag, self.extradata, self.size)
        except ValueError as e:
            raise ValueError(f"{self.path}: {what}: {e}") from None
        try:
            for i, sample in enumerate(self.samples):
                try:
                    got = dec.decode(self._sample(sample))
                except ValueError as e:
                    raise ValueError(f"{self.path}: {what}, frame {i}: {e}") from None
                if got is not None:
                    yield native.yuv_to_bgr(*got[0], full_range=False)
            self.msmpeg4_tally = dec.tally()
        finally:
            dec.close()

    def _h264_frames(self) -> Iterator[np.ndarray]:
        """Each frame of an H.264 stream (``native.H264Decoder``) in
        libavcodec's output order, an MP4 edit list's frames only (as
        :meth:`_display_order`), cropped as libavcodec crops it and converted
        as cv2 converts MPEG-4's, its chroma sited as the VUI says (left, or
        centred without one), in the range the VUI flags: a full-range stream
        as yuvj420p."""
        start, order, wanted = self._display_order()
        what = f"{self.container} with H.264 video"
        try:
            dec = native.H264Decoder(self.extradata, self.size)
        except ValueError as e:
            raise ValueError(f"{self.path}: {what}: {e}") from None
        dec.delay = self._h264_probed_delay()
        k = 0  # frames out so far

        def shown(frames):
            nonlocal k
            for (y, u, v), info in frames:
                k += 1
                if wanted is not None and (k > len(order) or order[k - 1] not in wanted):
                    continue
                # the VUI's chroma siting as libavcodec reports it to cv2's swscale: left-sited (locations 1, 3,
                # 5: a VUI without chroma_loc_info, x264's and phones') or centred (0, no VUI: unspecified; 2, 4, 6)
                yield native.yuv_to_bgr(y, u, v, full_range=info["full_range"],
                                        chroma_left=info["chroma_location"] in (1, 3, 5))

        try:
            for i in range(start, len(self.samples)):
                try:
                    got = dec.decode(self._sample(self.samples[i]))
                except ValueError as e:
                    raise ValueError(f"{self.path}: {what}, sample {i}: {e}") from None
                yield from shown(got)
            try:
                got = dec.flush()
            except ValueError as e:
                raise ValueError(f"{self.path}: {what}, at its end: {e}") from None
            yield from shown(got)
            self.h264_tally = dec.tally()
        finally:
            dec.close()

    def _h264_probed_delay(self) -> int:
        """The output delay cv2's decoder starts with: ffmpeg's avformat_find_stream_info decodes the first
        samples until the delay (has_b_frames) is the SPS's num_reorder_frames (libavcodec's:
        ``H264Decoder.reorder_hint``) or it has seen 7 frames out (18 at a delay of 3, 20 above), or the whole
        stream, and hands the delay it reached to the decoder cv2 opens. Damage raises in the decoding
        proper."""
        dec = native.H264Decoder(self.extradata, self.size)
        out = 0
        try:
            for o, n in self.samples:
                out += len(dec.decode(self._sample((o, n))))
                if (dec.delay and dec.delay == dec.reorder_hint) or \
                        out >= (7 if dec.delay < 3 else 18 if dec.delay < 4 else 20):
                    return dec.delay
            dec.flush()
            return dec.delay
        except ValueError:
            return dec.delay
        finally:
            dec.close()

    def _lossless_frames(self) -> Iterator[np.ndarray]:
        """Each frame of a lossless codec (HuffYUV, FFVHuff, FFV1, PNG: every
        frame decodes on its own but for FFV1's non-key frames, which keep the
        contexts' states), in decode order, which is the display order, an MP4
        edit list's frames only; converted as cv2 converts the codec's pixel
        format (``native.planes_to_bgr``)."""
        what = f"{self.container} with {LOSSLESS_NAMES[self.codec]} video"
        wanted = set(self.shown) if self.shown is not None else None
        try:
            if self.codec in ("huffyuv", "ffvhuff"):
                dec = native.HuffyuvDecoder(self.codec == "ffvhuff", self.extradata, self.bits_per_coded_sample,
                                            self.size)
            elif self.codec == "ffv1":
                dec = native.Ffv1Decoder(self.extradata, self.size)
            else:
                dec = None
        except ValueError as e:
            raise ValueError(f"{self.path}: {what}: {e}") from None
        try:
            for i, sample in enumerate(self.samples):
                if dec is None and wanted is not None and i not in wanted:
                    continue
                data = self._sample(sample)
                try:
                    if dec is None:
                        img = png_frame(data, self.size)
                    else:
                        planes = dec.decode(data)
                        img = native.planes_to_bgr(dec.pix_fmt, planes, dec.subsampling)
                except ValueError as e:
                    raise ValueError(f"{self.path}: {what}, frame {i}: {e}") from None
                if wanted is None or i in wanted:
                    yield img
            if dec is not None:
                setattr(self, f"{self.codec}_tally", dec.tally())
        finally:
            if dec is not None:
                dec.close()

    def _vp8_frames(self) -> Iterator[np.ndarray]:
        """Each shown frame, its planes converted as MPEG-4's are (swscale's
        limited-range BT.601, as cv2 converts vp8's yuv420p); a hidden frame
        (an alt-ref) updates the references and gives none, as in ffmpeg."""
        dec = native.Vp8Decoder()
        try:
            for i, (o, n) in enumerate(self.samples):
                data = self._read(o, n)
                if n >= 10 and not data[0] & 1:  # a key frame: its size is the track's (or memory runs away)
                    size = (int.from_bytes(data[6:8], "little") & 0x3FFF, int.from_bytes(data[8:10], "little") & 0x3FFF)
                    if size != self.size:
                        raise ValueError(f"{self.path}: {self.container} with VP8 video, block {i}: a key frame of "
                                         f"{size[0]}x{size[1]} in a track of {self.size[0]}x{self.size[1]}")
                try:
                    got = dec.decode(data)
                except ValueError as e:
                    raise ValueError(f"{self.path}: {self.container} with VP8 video, block {i}: {e}") from None
                if got is not None:
                    (y, u, v), _ = got
                    yield native.yuv_to_bgr(y, u, v, full_range=False)
            self.vp8_tally = dec.tally()
        finally:
            dec.close()

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "VideoReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------------ writing


def _ebml(eid: int, payload: bytes) -> bytes:
    """An EBML element: its ID, its size (in the fewest bytes), its payload."""
    n = len(payload)
    width = next(k for k in range(1, 9) if n < (1 << (7 * k)) - 1)
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big") + ((1 << (7 * width)) | n).to_bytes(width, "big") + payload


def _ebml_uint(eid: int, v: int) -> bytes:
    return _ebml(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))



def _guid(text: str) -> bytes:
    return uuid.UUID(text).bytes_le


ASF_GUID = {name: _guid(g) for name, g in (
    ("header", "75b22630-668e-11cf-a6d9-00aa0062ce6c"), ("file", "8cabdca1-a947-11cf-8ee4-00c00c205365"),
    ("extension", "5fbf03b5-a92e-11cf-8ee3-00c00c205365"), ("reserved1", "abd3d211-a9ba-11cf-8ee6-00c00c205365"),
    ("stream", "b7dc0791-a9b7-11cf-8ee6-00c00c205365"), ("video", "bc19efc0-5b4d-11cf-a8fd-00805f5c442b"),
    ("no_ec", "20fb5700-5b55-11cf-a8fd-00805f5c442b"), ("codecs", "86d15240-311d-11d0-a3a4-00a0c90348f6"),
    ("reserved2", "86d15241-311d-11d0-a3a4-00a0c90348f6"), ("data", "75b22636-668e-11cf-a6d9-00aa0062ce6c"),
    ("index", "33000890-e5b1-11cf-89f4-00a0c90349cb"), ("ext_stream", "14e6a5cb-c672-4332-8399-a96952065b5a"),
    ("encryption", "2211b3fb-bd23-11d2-b4b7-00a0c955fc6e"),
    ("ext_encryption", "298ae614-2622-4c17-b935-dae07ee9289c"))}


def gif_still_names(path: Path):
    """cv2's images backend's file names for a video of stills at path: the
    first run of digits in the file's name counts up from its value, zero
    padded to its width when it starts with 0; None when the name has no
    digit (cv2 does not open the writer)."""
    m = re.search(r"\d+", path.name)
    if m is None:
        return None
    digits = m.group(0)
    width = len(digits) if digits.startswith("0") else 0

    def name(i: int) -> Path:
        return path.with_name(f"{path.name[:m.start()]}{int(digits) + i:0{width}d}{path.name[m.end():]}")

    return name


class VideoWriter:
    """Writes BGR uint8 frames of one size as ``cv2.VideoWriter`` does with
    the JAX ``VideoSink``'s fourccs, by suffix: ``.avi`` as MJPG, ``.mkv``
    as mp4v in Matroska, ``.mp4`` / ``.mov`` / ``.m4v`` as mp4v in MP4 with
    cv2's brands, ``.mpg`` / ``.mpeg`` as mp4v in MPEG-PS and ``.wmv`` as
    mp4v in ASF (laid out as ffmpeg's muxers lay them out for cv2), and
    ``.gif`` as cv2's images backend writes it, one still GIF a frame under
    numbered names (:func:`gif_still_names`). Any other suffix, ``.webm``
    among them, and a ``.gif`` name without a digit, raise RuntimeError as
    ``VideoSink`` does when cv2's writer does not open. Frames are cropped to
    even width and height (not the stills); an fps of 0 (or less) is 30.
    :meth:`close` finishes the file (the index and headers)."""

    def __init__(self, path: str | Path, fps: float, size: Tuple[int, int]):
        self.path = Path(path)
        suffix = self.path.suffix.lower()
        self.kind = {".avi": "avi", ".mkv": "mkv", ".wmv": "asf", ".gif": "gif", **{k: "mp4" for k in MP4_FTYP},
                     **{k: "ps" for k in PS_SUFFIXES}}.get(suffix)
        self._stills = gif_still_names(self.path) if self.kind == "gif" else None
        if self.kind is None or (self.kind == "gif" and self._stills is None):
            raise RuntimeError(f"cannot open video writer: {self.path}")
        self.fps = fps if fps and fps > 0 else 30.0
        self.num, self.den = cv2_fps_fraction(self.fps)
        w, h = size
        self.sizes: List[int] = []
        if self.kind == "gif":
            self.width, self.height = w, h
            self._f: Optional[BinaryIO] = None
            self._open = True
            return
        self.width, self.height = w - (w & 1), h - (h & 1)
        if self.width < 2 or self.height < 2:
            raise ValueError(f"{self.path}: a video of {w}x{h} pixels is too small to write")
        self._f = open(self.path, "wb")
        self._open = True
        if self.kind == "avi":
            self._f.write(self._avi_header(0, 0))
            return
        self.res = self.num
        while self.res > 65535:  # the VOP time resolution is 16 bits
            self.res //= 10
        self.vol = native.mpeg4_header(self.width, self.height, self.res)
        if self.kind == "mkv":
            self._start_mkv()
        elif self.kind == "ps":
            self._queue: deque = deque()  # [PTS or None, bytes, offset] of what is not in a pack yet
            self._queued = 0
            self._packs = 0
        elif self.kind == "asf":
            self._queue = deque()  # [object number, bytes, offset, time ms] of what is not in a packet yet
            self._queued = 0
            self._packets: List[int] = []  # the first object starting in each packet, or -1
            self._f.write(self._asf_header())
        else:
            self._f.write(self._box(b"ftyp", MP4_FTYP[suffix]))
            self._mdat = self._f.tell()
            self._f.write(struct.pack(">I4sQ", 1, b"mdat", 16))

    @property
    def frames_written(self) -> int:
        return len(self.sizes)

    def write(self, img: np.ndarray) -> None:
        if not self._open:
            raise ValueError(f"{self.path}: the writer is closed")
        img = np.asarray(img)
        if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
            raise ValueError(f"{self.path}: want (H, W, 3) uint8 BGR frames, got {img.shape} {img.dtype}")
        h, w = img.shape[:2]
        if self.kind == "gif":
            if (w, h) != (self.width, self.height):
                raise ValueError(f"{self.path}: a frame of {w}x{h} in a video of {self.width}x{self.height}")
            data = native.gif_encode(img)
            self._stills(len(self.sizes)).write_bytes(data)
            self.sizes.append(len(data))
            return
        if (w - (w & 1), h - (h & 1)) != (self.width, self.height):
            raise ValueError(f"{self.path}: a frame of {w}x{h} in a video of {self.width}x{self.height}")
        img = img[:self.height, :self.width]
        if self.kind == "avi":
            data = encode_jpeg(img)
            if self._f.tell() + 8 + len(data) + 16 * (len(self.sizes) + 1) >= 1 << 31:
                raise ValueError(f"{self.path}: past the 2 GiB an AVI 1.0 file holds")
            self._f.write(struct.pack("<4sI", b"00dc", len(data)) + data + b"\0" * (len(data) & 1))
        else:
            i = len(self.sizes)
            t0, t1 = (i - 1) * self.den * self.res // self.num if i else 0, i * self.den * self.res // self.num
            seconds = t1 // self.res - (t0 // self.res if i else 0)
            y, u, v = native.bgr_to_yuv420(img)
            data = native.mpeg4_encode_intra(y, u, v, self.res, seconds, t1 % self.res, MPEG4_QP)
            if i == 0 and self.kind in ("ps", "asf"):
                data = self.vol + data  # the stream's headers before its first VOP, as cv2's writer sends them
            if self.kind == "mkv":
                self._mkv_block(data)
            elif self.kind == "ps":
                self._ps_frame(data, i)
            elif self.kind == "asf":
                self._asf_frame(data, i)
            else:
                self._f.write(data)
        self.sizes.append(len(data))

    def close(self) -> None:
        if not self._open:
            return
        self._open = False
        if self._f is None:
            return
        try:
            {"avi": self._finish_avi, "mkv": self._finish_mkv, "ps": self._finish_ps, "asf": self._finish_asf,
             "mp4": self._finish_mp4}[self.kind]()
        finally:
            self._f.close()
            self._f = None

    def __enter__(self) -> "VideoWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- MPEG-PS

    @staticmethod
    def _ps_time(marker: int, t: int) -> bytes:
        """A 33-bit PTS or SCR in the 5-byte form with its marker bits."""
        return bytes([marker | ((t >> 29) & 0x0E) | 1, (t >> 22) & 0xFF, ((t >> 14) & 0xFE) | 1, (t >> 7) & 0xFF,
                      ((t << 1) & 0xFE) | 1])

    def _ps_frame(self, data: bytes, i: int) -> None:
        pts = PS_PRELOAD + (2 * i * self.den * PS_TICKS + self.num) // (2 * self.num)
        self._queue.append([pts, data, 0])
        self._queued += len(data)
        while self._queued >= PS_PACK_SIZE:
            self._ps_pack()

    def _ps_pack(self) -> None:
        """One MPEG-1 pack of PS_PACK_SIZE bytes: its header (and the system
        header in the first), then video PES packets, each frame opening a
        packet of its own that carries its PTS, and a padding packet where
        the data runs out. Room too small for a packet goes to the PES
        header's stuffing bytes."""
        scr = self._packs * PS_PACK_SIZE * PS_TICKS // (PS_MUX_RATE * 50)
        mux = PS_MUX_RATE
        out = bytearray(b"\x00\x00\x01\xba" + self._ps_time(0x20, scr) +
                        bytes([0x80 | mux >> 15, (mux >> 7) & 0xFF, ((mux << 1) & 0xFE) | 1]))
        if not self._packs:
            out += PS_SYSTEM_HEADER
        room = PS_PACK_SIZE - len(out)
        while self._queue:
            pts, data, off = self._queue[0]
            head = 5 if off == 0 else 1
            if room < 6 + head + 1:
                break
            n = min(len(data) - off, room - 6 - head)
            left = room - 6 - head - n
            stuff = left if left < 6 else 0
            out += b"\x00\x00\x01\xe0" + (stuff + head + n).to_bytes(2, "big") + b"\xff" * stuff
            out += (self._ps_time(0x20, pts) if off == 0 else b"\x0f") + data[off:off + n]
            room -= 6 + stuff + head + n
            self._queued -= n
            if off + n == len(data):
                self._queue.popleft()
            else:
                self._queue[0][2] = off + n
        if room:
            out += b"\x00\x00\x01\xbe" + (room - 6).to_bytes(2, "big") + b"\xff" * (room - 6)
        self._f.write(out)
        self._packs += 1

    def _finish_ps(self) -> None:
        while self._queue:
            self._ps_pack()

    # ---- ASF

    def _asf_ms(self, i: int) -> int:
        return (2 * i * self.den * 1000 + self.num) // (2 * self.num)

    def _asf_header(self, packets: int = 0, index_size: int = 0) -> bytes:
        """The Header Object (File Properties, Header Extension, Stream
        Properties with a BITMAPINFOHEADER of mp4v and the VOL, Codec List)
        and the Data Object's header, as ffmpeg's asf muxer writes them for
        cv2; written again at close with the counts and durations."""
        n = len(self.sizes)
        send = self._asf_ms(n) * 10000  # in 100 ns
        bitrate = int(8 * sum(self.sizes) * 1000 / max(self._asf_ms(n), 1)) if n else 0
        g = ASF_GUID

        def obj(guid: bytes, body: bytes) -> bytes:
            return guid + struct.pack("<Q", 24 + len(body)) + body

        bih = struct.pack("<IiiHH4sIiiII", 40 + len(self.vol), self.width, self.height, 1, 24, b"mp4v",
                          self.width * self.height * 3, 0, 0, 0, 0) + self.vol
        specific = struct.pack("<IIBH", self.width, self.height, 2, len(bih)) + bih
        name = "mpeg4\0".encode("utf-16-le")
        rest = obj(g["extension"], g["reserved1"] + struct.pack("<HI", 6, 0)) + \
            obj(g["stream"], g["video"] + g["no_ec"] + struct.pack("<QIIHI", 0, len(specific), 0, 1, 0) + specific) + \
            obj(g["codecs"], g["reserved2"] + struct.pack("<IHH", 1, 1, len(name) // 2) + name +
                struct.pack("<HH", 0, 4) + b"mp4v")
        size = 30 + 104 + len(rest)  # the Header Object, File Properties (104 bytes) included
        data_size = 50 + packets * ASF_PACKET
        fileprops = obj(g["file"], bytes(16) + struct.pack("<QQQQQQIIII", size + data_size + index_size, 0, packets,
                                                           send + ASF_PRELOAD_MS * 10000, send, ASF_PRELOAD_MS, 2,
                                                           ASF_PACKET, ASF_PACKET, bitrate))
        header = g["header"] + struct.pack("<QIBB", size, 4, 1, 2) + fileprops + rest
        return header + g["data"] + struct.pack("<Q", data_size) + bytes(16) + struct.pack("<QBB", packets, 1, 1)

    def _index_entries(self) -> int:
        return math.ceil((self._asf_ms(len(self.sizes)) + ASF_PRELOAD_MS) / 1000) + 1

    def _asf_frame(self, data: bytes, i: int) -> None:
        self._queue.append([i + 1, data, 0, self._asf_ms(i)])
        self._queued += len(data)
        while self._queued >= ASF_PACKET:
            self._asf_packet()

    def _asf_packet(self) -> None:
        """One data packet of ASF_PACKET bytes: error correction data, its
        flags, send time and duration, then payloads (a fragment of a frame
        each, with the frame's size and presentation time), then padding
        (its length in a WORD, when there is any)."""
        room = ASF_PACKET - 12
        payloads, first = [], -1
        while self._queue and room > ASF_PAYLOAD_HEADER and len(payloads) < 63:
            number, data, off, ms = self._queue[0]
            n = min(len(data) - off, room - ASF_PAYLOAD_HEADER)
            if 0 < room - ASF_PAYLOAD_HEADER - n < 2:  # the padding length's WORD must fit
                n -= 2 - (room - ASF_PAYLOAD_HEADER - n)
            if n <= 0:
                break
            if off == 0 and first < 0:
                first = number
            payloads.append(struct.pack("<BBIBIIH", 0x81, number & 0xFF, off, 8, len(data), ASF_PRELOAD_MS + ms, n) +
                            data[off:off + n])
            room -= ASF_PAYLOAD_HEADER + n
            self._queued -= n
            times = [ms] if len(payloads) == 1 else times + [ms]
            if off + n == len(data):
                self._queue.popleft()
            else:
                self._queue[0][2] = off + n
        padding = room - 2 if room else 0
        head = b"\x82\x00\x00" + (b"\x11\x5d" + struct.pack("<H", padding) if room else b"\x01\x5d")
        head += struct.pack("<IHB", times[0], times[-1] - times[0], 0x80 | len(payloads))
        self._f.write(head + b"".join(payloads) + bytes(padding))
        self._packets.append(first)

    def _finish_asf(self) -> None:
        while self._queue:
            self._asf_packet()
        f = self._f
        # the Simple Index: for each second of presentation time, the packet where the last frame before it starts
        entries, starts = [], [(k, number) for k, number in enumerate(self._packets) if number > 0]
        for t in range(self._index_entries()):
            before = [k for k, number in starts if self._asf_ms(number - 1) <= t * 1000 - ASF_PRELOAD_MS] or [0]
            entries.append(struct.pack("<IH", before[-1], 1))
        f.write(ASF_GUID["index"] + struct.pack("<Q", 56 + 6 * len(entries)) + bytes(16) +
                struct.pack("<QII", 10000000, 1, len(entries)) + b"".join(entries))
        f.seek(0)
        f.write(self._asf_header(len(self._packets), 56 + 6 * len(entries)))

    # ---- AVI

    def _avi_header(self, movi_size: int, riff_size: int) -> bytes:
        n = len(self.sizes)
        biggest = max(self.sizes, default=0)
        avih = struct.pack("<IIIIIIIIII4I", round(1e6 * self.den / self.num), 0, 0, 0x10, n, 0, 1, biggest,
                           self.width, self.height, 0, 0, 0, 0)
        strh = struct.pack("<4s4sIHH8I4h", b"vids", b"MJPG", 0, 0, 0, 0, self.den, self.num, 0, n, biggest,
                           0xFFFFFFFF, 0, 0, 0, self.width, self.height)
        strf = struct.pack("<IiiHH4sIiiII", 40, self.width, self.height, 1, 24, b"MJPG", self.width * self.height * 3,
                           0, 0, 0, 0)
        strl = self._list(b"strl", self._chunk(b"strh", strh) + self._chunk(b"strf", strf))
        hdrl = self._list(b"hdrl", self._chunk(b"avih", avih) + strl)
        return struct.pack("<4sI4s", b"RIFF", riff_size, b"AVI ") + hdrl + struct.pack("<4sI4s", b"LIST", movi_size,
                                                                                         b"movi")

    @staticmethod
    def _chunk(cid: bytes, data: bytes) -> bytes:
        return struct.pack("<4sI", cid, len(data)) + data + b"\0" * (len(data) & 1)

    @staticmethod
    def _list(kind: bytes, data: bytes) -> bytes:
        return struct.pack("<4sI4s", b"LIST", 4 + len(data), kind) + data

    def _finish_avi(self) -> None:
        f = self._f
        header_len = len(self._avi_header(0, 0))
        movi_end = f.tell()
        idx = bytearray()
        off = 4
        for n in self.sizes:
            idx += struct.pack("<4sIII", b"00dc", 0x10, off, n)
            off += 8 + n + (n & 1)
        f.write(self._chunk(b"idx1", bytes(idx)))
        end = f.tell()
        f.seek(0)
        f.write(self._avi_header(movi_end - header_len + 4, end - 8))

    # ---- MP4

    @staticmethod
    def _box(t: bytes, payload: bytes) -> bytes:
        return struct.pack(">I4s", 8 + len(payload), t) + payload

    def _finish_mp4(self) -> None:
        f = self._f
        end = f.tell()
        f.seek(self._mdat + 8)
        f.write(struct.pack(">Q", end - self._mdat))
        f.seek(end)
        n = len(self.sizes)
        ts, delta = self.num, self.den
        duration = n * delta
        movie_duration = duration * 1000 // ts
        box = self._box
        offsets, o = [], self._mdat + 16
        for s in self.sizes:
            offsets.append(o)
            o += s
        matrix = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        mvhd = struct.pack(">IIIII", 0, 0, 0, 1000, movie_duration) + struct.pack(">IH10x", 0x10000, 0x100) + matrix + \
            b"\0" * 24 + struct.pack(">I", 2)
        tkhd = struct.pack(">IIIII4xI8xHHH2x", 3, 0, 0, 1, 0, movie_duration, 0, 0, 0) + matrix + \
            struct.pack(">II", self.width << 16, self.height << 16)
        mdhd = struct.pack(">IIIIIHH", 0, 0, 0, ts, duration, 0x55C4, 0)
        hdlr = struct.pack(">II4s12x", 0, 0, b"vide") + b"VideoHandler\0"
        vmhd = struct.pack(">I4H", 1, 0, 0, 0, 0)
        dref = box(b"dref", struct.pack(">II", 0, 1) + box(b"url ", struct.pack(">I", 1)))

        def desc(tag: int, body: bytes) -> bytes:  # an MPEG-4 descriptor, its size in 4 bytes of 7 bits
            n = len(body)
            size = [0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F, 0x80 | (n >> 7) & 0x7F, n & 0x7F]
            return bytes([tag, *size]) + body

        bitrate = int(8 * sum(self.sizes) * ts / max(duration, 1))
        dcd = desc(4, struct.pack(">BB3sII", 0x20, 0x11, max(self.sizes, default=0).to_bytes(3, "big")
                                  if max(self.sizes, default=0) < 1 << 24 else b"\xff\xff\xff", bitrate, bitrate) +
                   desc(5, self.vol))
        esds = box(b"esds", struct.pack(">I", 0) + desc(3, struct.pack(">HB", 1, 0) + dcd + desc(6, b"\x02")))
        mp4v = box(b"mp4v", b"\0" * 6 + struct.pack(">H", 1) + b"\0" * 16 +
                   struct.pack(">HHIIIH", self.width, self.height, 0x480000, 0x480000, 0, 1) + b"\0" * 32 +
                   struct.pack(">Hh", 24, -1) + esds)
        stsd = box(b"stsd", struct.pack(">II", 0, 1) + mp4v)
        stts = box(b"stts", struct.pack(">IIII", 0, 1, n, delta) if n else struct.pack(">II", 0, 0))
        stsc = box(b"stsc", struct.pack(">IIIII", 0, 1, 1, 1, 1) if n else struct.pack(">II", 0, 0))
        stsz = box(b"stsz", struct.pack(">III", 0, 0, n) + b"".join(struct.pack(">I", s) for s in self.sizes))
        if offsets and offsets[-1] >= 1 << 32:
            stco = box(b"co64", struct.pack(">II", 0, n) + b"".join(struct.pack(">Q", x) for x in offsets))
        else:
            stco = box(b"stco", struct.pack(">II", 0, n) + b"".join(struct.pack(">I", x) for x in offsets))
        stbl = box(b"stbl", stsd + stts + stsc + stsz + stco)
        minf = box(b"minf", box(b"vmhd", vmhd) + box(b"dinf", dref) + stbl)
        mdia = box(b"mdia", box(b"mdhd", mdhd) + box(b"hdlr", hdlr) + minf)
        trak = box(b"trak", box(b"tkhd", tkhd) + mdia)
        f.write(box(b"moov", box(b"mvhd", mvhd) + trak))

    # ---- Matroska

    def _mkv_ms(self, i: int) -> int:
        """Frame i's time in milliseconds, rounded as ffmpeg rescales it."""
        return (2 * i * 1000 * self.den + self.num) // (2 * self.num)

    def _start_mkv(self) -> None:
        """The EBML header, the Segment (its size written at close), Info (its
        Duration at close) and the mp4v track, as ffmpeg's muxer lays them out
        for cv2."""
        f = self._f
        f.write(_ebml(MKV["EBML"], _ebml_uint(0x4286, 1) + _ebml_uint(0x42F7, 1) + _ebml_uint(0x42F2, 4) +
                      _ebml_uint(0x42F3, 8) + _ebml(MKV["DocType"], b"matroska") + _ebml_uint(0x4287, 4) +
                      _ebml_uint(0x4285, 2)))
        f.write(MKV["Segment"].to_bytes(4, "big"))
        self._segment = f.tell()
        f.write(b"\x01" + b"\0" * 7)  # an 8-byte size, filled in at close
        app = b"mga_yolo_tpu_torch"
        info = _ebml_uint(MKV["TimestampScale"], 1000000) + _ebml(MKV["MuxingApp"], app) + \
            _ebml(MKV["WritingApp"], app)
        f.write(_ebml(MKV["Info"], info + _ebml(MKV["Duration"], struct.pack(">d", 0.0))))
        self._duration = f.tell() - 8
        video = _ebml_uint(MKV["PixelWidth"], self.width) + _ebml_uint(MKV["PixelHeight"], self.height)
        entry = _ebml_uint(MKV["TrackNumber"], 1) + _ebml_uint(MKV["TrackUID"], 1) + \
            _ebml_uint(MKV["FlagLacing"], 0) + _ebml(MKV["Language"], b"und") + \
            _ebml(MKV["CodecID"], b"V_MPEG4/ISO/ASP") + _ebml_uint(MKV["TrackType"], 1) + \
            _ebml_uint(MKV["DefaultDuration"], (2 * 10 ** 9 * self.den + self.num) // (2 * self.num)) + \
            _ebml(MKV["Video"], video) + _ebml(MKV["CodecPrivate"], self.vol)
        f.write(_ebml(MKV["Tracks"], _ebml(MKV["TrackEntry"], entry)))
        self._cluster: Optional[Tuple[int, bytearray]] = None
        self._cues: List[Tuple[int, int]] = []  # (cluster time, cluster position in the segment)

    def _mkv_block(self, data: bytes) -> None:
        t = self._mkv_ms(len(self.sizes))
        if self._cluster is not None and (t - self._cluster[0] >= MKV_CLUSTER_MS or len(self._cluster[1]) >= 5 << 20):
            self._flush_cluster()
        if self._cluster is None:
            self._cluster = (t, bytearray(_ebml_uint(MKV["Timestamp"], t)))
        block = b"\x81" + struct.pack(">hB", t - self._cluster[0], 0x80) + data  # track 1, key frame
        self._cluster[1].extend(_ebml(MKV["SimpleBlock"], block))

    def _flush_cluster(self) -> None:
        t0, body = self._cluster
        self._cues.append((t0, self._f.tell() - self._segment - 8))
        self._f.write(_ebml(MKV["Cluster"], bytes(body)))
        self._cluster = None

    def _finish_mkv(self) -> None:
        f = self._f
        if self._cluster is not None:
            self._flush_cluster()
        if self._cues:
            f.write(_ebml(MKV["Cues"], b"".join(
                _ebml(MKV["CuePoint"], _ebml_uint(MKV["CueTime"], t) + _ebml(MKV["CueTrackPositions"], _ebml_uint(
                    MKV["CueTrack"], 1) + _ebml_uint(MKV["CueClusterPosition"], pos))) for t, pos in self._cues)))
        end = f.tell()
        n = len(self.sizes)
        duration = self._mkv_ms(n - 1) + self._mkv_ms(1) if n else 0
        f.seek(self._duration)
        f.write(struct.pack(">d", float(duration)))
        f.seek(self._segment)
        f.write(((1 << 56) | (end - self._segment - 8)).to_bytes(8, "big"))
        f.seek(end)
