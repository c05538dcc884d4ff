"""Writes the JPEG fixtures in this directory, and cv2's decodes of them.

``python -m tests.jpeg_fixtures.make`` (cv2 and PIL, the JAX package's
decoders, in the test environment). Small files (at most 64 x 64) cover the
decoder's modes: grey and colour, baseline and progressive, 4:4:4, 4:2:2,
4:2:0, 4:4:0 and 4:1:1 sampling, optimised Huffman tables, restart
intervals and an EXIF orientation. ``pixels.npz`` holds cv2's colour
(``<stem>``) and grey (``<stem>_gray``) decode of each. The three larger
files time the decoder: a 512 x 512 grey image (ARCADE's size), baseline
and progressive, and a 640 x 640 BGR 4:2:0 one; ``bench.json`` holds the
SHA-256 of cv2's decode of each. ``tests/test_torch_image_codecs.py`` checks
that both still hold; ``chip_smoke.py`` ``[jpeg]`` decodes them on the
card's host.
"""

from __future__ import annotations

import hashlib
import io
import json
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
P, O, R, S = cv2.IMWRITE_JPEG_PROGRESSIVE, cv2.IMWRITE_JPEG_OPTIMIZE, cv2.IMWRITE_JPEG_RST_INTERVAL, \
    cv2.IMWRITE_JPEG_SAMPLING_FACTOR
Q = cv2.IMWRITE_JPEG_QUALITY
# stem: (h, w, channels, cv2.imencode parameters)
SMALL = {
    "grey_baseline_q75": (48, 64, 1, [Q, 75]),
    "grey_progressive_q95": (48, 64, 1, [Q, 95, P, 1]),
    "grey_progressive_rst2": (33, 47, 1, [Q, 90, P, 1, R, 2]),
    "bgr420_baseline_q95": (64, 64, 3, [Q, 95]),
    "bgr420_progressive_q75": (37, 53, 3, [Q, 75, P, 1]),
    "bgr422_baseline_q50": (37, 53, 3, [Q, 50, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    "bgr444_baseline_q75": (37, 53, 3, [Q, 75, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    "bgr440_progressive_q90": (53, 37, 3, [Q, 90, P, 1, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440]),
    "bgr411_baseline_q85": (40, 61, 3, [Q, 85, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411]),
    "bgr420_optimized_q80": (64, 48, 3, [Q, 80, O, 1]),
    "bgr420_rst3_q95": (64, 48, 3, [Q, 95, R, 3]),
}
EXIF6 = "bgr420_exif6_q90"  # 32 x 48 stored, shown turned a quarter (PIL)
BENCH = {
    "grey512_baseline": (512, 512, 1, [Q, 95]),
    "grey512_progressive": (512, 512, 1, [Q, 95, P, 1]),
    "bgr640_420": (640, 640, 3, [Q, 95]),
}


def picture(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """A smooth image with thin dark curves, like an angiogram's vessels."""
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.integers(60, 200, (h, w, c)).astype(np.uint8), (0, 0), max(h, w) / 16)
    img = cv2.normalize(img, None, 40, 220, cv2.NORM_MINMAX).reshape(h, w, c)
    for _ in range(max(3, h // 16)):
        pts = np.cumsum(rng.normal(0, max(h, w) / 12, (8, 2)), 0) + rng.uniform(0, [w, h])
        cv2.polylines(img, [pts.astype(np.int32)], False, (20,) * c, int(rng.integers(1, 4)), cv2.LINE_AA)
    noise = rng.normal(0, 6, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8).reshape(h, w, c)


def main() -> None:
    from PIL import Image

    pixels = {}
    for i, (stem, (h, w, c, params)) in enumerate(SMALL.items()):
        img = picture(h, w, c, i)
        (HERE / f"{stem}.jpg").write_bytes(cv2.imencode(".jpg", img[..., 0] if c == 1 else img, params)[1].tobytes())
    exif = Image.Exif()
    exif[0x0112] = 6
    buf = io.BytesIO()
    Image.fromarray(picture(32, 48, 3, 99)[..., ::-1]).save(buf, "JPEG", quality=90, exif=exif.tobytes())
    (HERE / f"{EXIF6}.jpg").write_bytes(buf.getvalue())
    for path in sorted(HERE.glob("*.jpg")):
        if path.stem in BENCH:
            continue
        pixels[path.stem] = cv2.imread(str(path), cv2.IMREAD_COLOR)
        pixels[f"{path.stem}_gray"] = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    np.savez_compressed(HERE / "pixels.npz", **pixels)
    digests = {}
    for i, (stem, (h, w, c, params)) in enumerate(BENCH.items()):
        img = picture(h, w, c, 100 + (i if c == 3 else 0))  # both grey files hold one picture
        path = HERE / f"{stem}.jpg"
        path.write_bytes(cv2.imencode(".jpg", img[..., 0] if c == 1 else img, params)[1].tobytes())
        digests[stem] = {"color": hashlib.sha256(cv2.imread(str(path)).tobytes()).hexdigest(),
                         "gray": hashlib.sha256(cv2.imread(str(path), cv2.IMREAD_GRAYSCALE).tobytes()).hexdigest()}
    (HERE / "bench.json").write_text(json.dumps(digests, indent=1) + "\n")


if __name__ == "__main__":
    main()
