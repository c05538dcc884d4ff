"""Prediction sources: image files, directories, globs and arrays as one
stream of frames (counterpart of ``mga_yolo_tpu/data/sources.py``).

Every source kind yields :class:`Frame` records, so the predictor has one
code path. Images are read with ``data/image_io.py`` (PNG, JPEG and BMP,
decoded as cv2 decodes them). Video files, webcams and stream URLs need
``cv2.VideoCapture``, which the card's host does not have: they raise
``NotImplementedError`` naming the missing decoder, as does
:class:`VideoSink`; no source is ever skipped.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
from pathlib import Path
from typing import Iterable, Iterator, List, Union

import numpy as np

from mga_yolo_tpu_torch.data import image_io
from mga_yolo_tpu_torch.data.dataset import IMG_EXTS

VID_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".m4v", ".mpg", ".mpeg", ".webm", ".wmv", ".gif"}
STREAM_PREFIXES = ("rtsp://", "rtmp://", "http://", "https://", "tcp://")
NO_VIDEO = ("needs a video decoder (cv2.VideoCapture), which the port does not carry: the card's host "
            "has no OpenCV; extract the frames as PNG or JPEG images")


@dataclasses.dataclass
class Frame:
    """One decoded BGR frame and where it came from."""

    img: np.ndarray
    path: str                 # source file ("<array>" for an array)
    index: int = 0            # frame index within its source (0 for stills: no video is read)

    @property
    def stem(self) -> str:
        return Path(self.path).stem


SourceLike = Union[str, Path, int, np.ndarray]


def _no_video(what: str):
    raise NotImplementedError(f"{what}: {NO_VIDEO}")


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
    """Frames of any source kind: an image file, a directory, a glob, a
    decoded BGR array, or an iterable of these. A video file, a webcam
    index (an int or a digit string) or a stream URL raises
    ``NotImplementedError``; ``max_frames`` is kept for the JAX package's
    signature (it caps the frames of a video source)."""
    if isinstance(source, np.ndarray):
        yield Frame(img=source, path="<array>")
        return
    if isinstance(source, int):
        _no_video(f"webcam {source}")
    if isinstance(source, (str, Path)):
        s = str(source)
        if s.lower().startswith(STREAM_PREFIXES):
            _no_video(f"stream {s}")
        if s.isdigit():
            _no_video(f"webcam {s}")
        for f in list_files(s):
            if f.suffix.lower() in VID_EXTS:
                _no_video(f"video {f}")
            yield Frame(img=image_io.imread(f), path=str(f))
        return
    for item in source:
        yield from iter_source(item, max_frames=max_frames)


class VideoSink:
    """The annotated-video writer of the JAX package; it needs
    ``cv2.VideoWriter``, which the card's host does not have."""

    def __init__(self, out_path: Path, fps: float):
        _no_video(f"video writer {out_path}")
