"""Prediction sources: image files, video files, directories, globs and
arrays as one stream of frames (counterpart of ``mga_yolo_tpu/data/sources.py``).

Every source kind yields :class:`Frame` records, so the predictor has one
code path. Images are read with ``data/image_io.py`` (PNG, JPEG, BMP,
TIFF, WebP, PNM / PAM / PFM, Sun raster and HDR, decoded as cv2 decodes
them), video files with ``data/video_io.py`` (GIF, and AVI and MP4/MOV
holding MJPEG, MPEG-4 Part 2 or uncompressed frames, decoded as
``cv2.VideoCapture`` decodes them), and :class:`VideoSink` writes the
annotated video as the JAX package's does (MJPG for ``.avi``, mp4v
otherwise). Webcams and stream URLs raise ``NotImplementedError``: the
card's host has no camera, and stream URLs need a network client and
H.264. No source is ever skipped: what cannot be read raises.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Union

import numpy as np

from mga_yolo_tpu_torch.data import image_io
from mga_yolo_tpu_torch.data.dataset import IMG_EXTS
from mga_yolo_tpu_torch.data.video_io import VideoReader, VideoWriter

VID_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".m4v", ".mpg", ".mpeg", ".webm", ".wmv", ".gif"}
STREAM_PREFIXES = ("rtsp://", "rtmp://", "http://", "https://", "tcp://")
NO_CAMERA = "the card's host has no camera; record the run to a video file and pass its path"
NO_STREAM = ("stream URLs are not read (no network client, and RTSP streams carry H.264, which the port does not "
             "decode); record the stream to an AVI or MP4 file and pass its path")


@dataclasses.dataclass
class Frame:
    """One decoded BGR frame and where it came from."""

    img: np.ndarray
    path: str                 # source file ("<array>" for an array)
    index: int = 0            # frame index within its source (0 for stills)
    is_video: bool = False
    fps: float = 0.0          # source fps (0 when unknown / still image)
    total: int = 0            # total frames if known, else 0

    @property
    def stem(self) -> str:
        return Path(self.path).stem if "://" not in self.path else "stream"


SourceLike = Union[str, Path, int, np.ndarray]


def _iter_video(path: str, max_frames: int = 0) -> Iterator[Frame]:
    """The frames of a video file, at most ``max_frames`` (0: all)."""
    with VideoReader(path) as reader:
        fps, total = float(reader.fps), int(reader.total)
        for i, img in enumerate(reader):
            yield Frame(img=img, path=path, index=i, is_video=True, fps=fps, total=total)
            if max_frames and i + 1 >= max_frames:
                break


def list_files(source: Union[str, Path]) -> List[Path]:
    """A directory (recursive, images and videos), a glob or a single file,
    as a sorted file list."""
    s = str(source)
    p = Path(s)
    if p.is_dir():
        return sorted(q for q in p.rglob("*") if q.suffix.lower() in IMG_EXTS | VID_EXTS)
    if any(ch in s for ch in "*?["):
        return sorted(Path(q) for q in _glob.glob(s, recursive=True))
    return [p]


def iter_source(source: Union[SourceLike, Iterable[SourceLike]], max_frames: int = 0) -> Iterator[Frame]:
    """Frames of any source kind: an image or video file, a directory
    (recursive, images and videos), a glob, a decoded BGR array, or an
    iterable of these. ``max_frames`` caps the frames taken per video
    source (0: all). A webcam index (an int or a digit string) or a stream
    URL raises ``NotImplementedError``."""
    if isinstance(source, np.ndarray):
        yield Frame(img=source, path="<array>")
        return
    if isinstance(source, int):
        raise NotImplementedError(f"webcam {source}: {NO_CAMERA}")
    if isinstance(source, (str, Path)):
        s = str(source)
        if s.lower().startswith(STREAM_PREFIXES):
            raise NotImplementedError(f"stream {s}: {NO_STREAM}")
        if s.isdigit():
            raise NotImplementedError(f"webcam {s}: {NO_CAMERA}")
        for f in list_files(s):
            if f.suffix.lower() in VID_EXTS:
                yield from _iter_video(str(f), max_frames=max_frames)
            else:
                yield Frame(img=image_io.imread(f), path=str(f))
        return
    for item in source:
        yield from iter_source(item, max_frames=max_frames)


class VideoSink:
    """Lazily-opened annotated-video writer, one per source video: MJPG for
    ``.avi``, mp4v otherwise in the container the suffix names, and for
    ``.gif`` cv2's numbered stills, sized by the first frame
    (``data/video_io.VideoWriter``). A suffix cv2's writer refuses
    (``.webm`` among them) and a ``.gif`` name without a digit raise
    RuntimeError at the first write."""

    def __init__(self, out_path: Path, fps: float):
        self.out_path = Path(out_path)
        self.fps = fps if fps and fps > 0 else 30.0
        self._writer: Optional[VideoWriter] = None
        self.frames_written = 0

    def write(self, img: np.ndarray) -> None:
        if self._writer is None:
            self._writer = VideoWriter(self.out_path, self.fps, (img.shape[1], img.shape[0]))
        self._writer.write(img)
        self.frames_written += 1

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
