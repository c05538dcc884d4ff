"""The port's image codecs (``native/jpeg.cpp``, ``native/bmp.cpp`` through
``data/image_io.py``) against the JAX package's decoder, cv2, on the CPU.

Tolerances: none. The port's JPEG decode equals ``cv2.imdecode`` /
``cv2.imread`` / ``cv2.IMREAD_GRAYSCALE`` to the bit (libjpeg-turbo's ISLOW
IDCT, fancy upsampling and fixed-point colour conversion, the EXIF
orientation applied), its encoder writes ``cv2.imencode(".jpg")``'s bytes,
its BMP decode equals cv2's, and ``image_io.image_size`` equals the JAX
package's ``data.dataset.image_size``. Files are made here with cv2 (and
PIL where cv2 cannot write what is wanted: EXIF tags, palettes, CMYK) from
numpy seeds, at odd sizes. What the port refuses raises ValueError naming
the file and what it is; no corrupt file crashes the process.
"""

from __future__ import annotations

import hashlib
import io
import json
import threading
from pathlib import Path

import cv2
import numpy as np
import pytest

FIXTURES = Path(__file__).resolve().parent / "jpeg_fixtures"
Q, P, O, R, S = (cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_PROGRESSIVE, cv2.IMWRITE_JPEG_OPTIMIZE,
                 cv2.IMWRITE_JPEG_RST_INTERVAL, cv2.IMWRITE_JPEG_SAMPLING_FACTOR)
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _image(h, w, c, seed, smooth=True):
    """Seeded uint8 noise, blurred unless ``smooth`` is False; (h, w) when c == 1."""
    img = np.random.default_rng(seed).integers(0, 256, (h, w, c)).astype(np.uint8)
    if smooth:
        img = cv2.GaussianBlur(img, (5, 5), 1.5).reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def _cases():
    """(id, h, w, channels, smooth, cv2.imencode parameters)."""
    out = []
    for samp in SAMPLING:
        for prog in (0, 1):
            out.append((f"bgr{samp}_{'progressive' if prog else 'baseline'}", 37, 53, 3, True,
                        [Q, 75, P, prog, S, SAMPLING[samp]]))
    out += [
        ("bgr420_q50", 67, 93, 3, True, [Q, 50]),
        ("bgr420_q95", 67, 93, 3, True, [Q, 95]),
        ("bgr422_q95_progressive", 64, 64, 3, True, [Q, 95, P, 1, S, SAMPLING["422"]]),
        ("bgr420_optimized", 37, 53, 3, True, [Q, 75, O, 1]),
        ("bgr444_optimized_q95", 64, 64, 3, True, [Q, 95, O, 1, S, SAMPLING["444"]]),
        ("bgr420_rst1", 37, 53, 3, True, [Q, 75, R, 1]),
        ("bgr411_rst3_progressive", 67, 93, 3, True, [Q, 95, R, 3, P, 1, S, SAMPLING["411"]]),
        ("bgr420_noise_q95", 37, 53, 3, False, [Q, 95]),
        ("bgr440_noise_q50_progressive", 37, 53, 3, False, [Q, 50, P, 1, S, SAMPLING["440"]]),
        ("grey_q50", 37, 53, 1, True, [Q, 50]),
        ("grey_q75", 67, 93, 1, True, [Q, 75]),
        ("grey_q95", 64, 64, 1, True, [Q, 95]),
        ("grey_progressive", 37, 53, 1, True, [Q, 95, P, 1]),
        ("grey_optimized_rst2", 37, 53, 1, True, [Q, 75, O, 1, R, 2]),
        ("grey_noise_progressive", 67, 93, 1, False, [Q, 75, P, 1]),
        ("bgr420_1x1", 1, 1, 3, False, [Q, 95]),
        ("bgr420_2x3", 2, 3, 3, False, [Q, 95]),
        ("bgr422_5x2_progressive", 5, 2, 3, False, [Q, 95, P, 1, S, SAMPLING["422"]]),
        ("bgr440_17x4", 17, 4, 3, False, [Q, 75, S, SAMPLING["440"]]),
    ]
    return out


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_jpeg_decode_equals_cv2(tmp_path, case):
    from mga_yolo_tpu_torch.data import image_io

    name, h, w, c, smooth, params = case
    data = cv2.imencode(".jpg", _image(h, w, c, len(name), smooth), params)[1].tobytes()
    path = tmp_path / "a.jpg"
    path.write_bytes(data)
    buf = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(image_io.imdecode(data), cv2.imdecode(buf, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(str(path)))
    np.testing.assert_array_equal(image_io.imread_gray(path), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(image_io.decode(data, gray=True), cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))


def _exif_jpeg(img_bgr: np.ndarray, orientation: int, quality: int = 90, mode: str = "RGB") -> bytes:
    """A JPEG written by PIL carrying the EXIF orientation tag."""
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = orientation
    im = Image.fromarray(img_bgr[..., ::-1] if img_bgr.ndim == 3 else img_bgr)
    buf = io.BytesIO()
    im.convert(mode).save(buf, "JPEG", quality=quality, exif=exif.tobytes())
    return buf.getvalue()


@pytest.mark.parametrize("orientation", range(1, 9))
def test_jpeg_exif_orientation_equals_cv2(tmp_path, orientation):
    """cv2 turns and flips by the EXIF orientation on imread and imdecode,
    colour and grey; the port does the same, and image_size swaps h and w
    for 5-8 as the JAX package's does."""
    from mga_yolo_tpu.data.dataset import image_size as jax_image_size
    from mga_yolo_tpu_torch.data import image_io

    data = _exif_jpeg(_image(20, 42, 3, orientation), orientation, mode="L" if orientation % 2 else "RGB")
    path = tmp_path / "a.jpg"
    path.write_bytes(data)
    want = cv2.imread(str(path))
    assert want.shape[:2] == ((42, 20) if orientation >= 5 else (20, 42))
    np.testing.assert_array_equal(image_io.imread(path), want)
    np.testing.assert_array_equal(image_io.imdecode(data), cv2.imdecode(np.frombuffer(data, np.uint8), 1))
    np.testing.assert_array_equal(image_io.imread_gray(path), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    assert image_io.image_size(path) == jax_image_size(path) == want.shape[:2]


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_adobe_rgb_jpeg_equals_cv2(progressive):
    """Components stored as R, G, B (Adobe APP14 transform 0, written by PIL
    with ``keep_rgb``): no colour conversion in colour, jdcolor.c's
    RGB -> grey in grey."""
    from PIL import Image

    from mga_yolo_tpu_torch.data import image_io

    buf = io.BytesIO()
    Image.fromarray(_image(37, 53, 3, 4)[..., ::-1]).save(buf, "JPEG", quality=90, keep_rgb=True,
                                                          progressive=progressive)
    data = buf.getvalue()
    assert b"Adobe" in data[:64]
    for flag, gray in ((cv2.IMREAD_COLOR, False), (cv2.IMREAD_GRAYSCALE, True)):
        np.testing.assert_array_equal(image_io.decode(data, gray=gray), cv2.imdecode(np.frombuffer(data, np.uint8), flag))


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("shape", [(37, 53), (64, 64), (67, 93, 3), (64, 64, 3), (17, 4, 3), (9, 33, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_jpeg_encode_bytes_equal_cv2(tmp_path, shape, quality):
    """encode_jpeg gives cv2.imencode's bytes (JFIF, 4:2:0 for colour, alpha
    dropped), and imwrite(.jpg / .jpeg) writes them at cv2's quality 95."""
    from mga_yolo_tpu_torch.data import image_io

    img = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    if len(shape) == 3 and shape[0] > 32:
        img = cv2.GaussianBlur(img, (3, 3), 1.0).reshape(shape)
    want = cv2.imencode(".jpg", img, [Q, quality])[1].tobytes()
    assert image_io.encode_jpeg(img, quality) == want
    if quality == 95:
        image_io.imwrite(tmp_path / "a.JPEG", img)
        assert (tmp_path / "a.JPEG").read_bytes() == want
        np.testing.assert_array_equal(image_io.imread(tmp_path / "a.JPEG"),
                                      cv2.imdecode(np.frombuffer(want, np.uint8), cv2.IMREAD_COLOR))


def _bmp(kind: str, img: np.ndarray) -> bytes:
    """BMP bytes of ``img`` (BGR) in the layout ``kind`` names."""
    from PIL import Image

    rgb = Image.fromarray(np.ascontiguousarray(img[..., ::-1]))
    if kind == "bgr24":
        return cv2.imencode(".bmp", img)[1].tobytes()
    if kind == "grey8":
        return cv2.imencode(".bmp", img[..., 0])[1].tobytes()
    im = {"palette8": lambda: rgb.quantize(60), "palette4": lambda: rgb.quantize(16),
          "mono1": lambda: Image.fromarray(img[..., 0] > 100),
          "bgra32": lambda: Image.fromarray(np.dstack([img[..., ::-1], img[..., 1]]), "RGBA")}[kind.split("_")[0]]()
    buf = io.BytesIO()
    im.save(buf, "BMP")
    return buf.getvalue()


def _top_down(data: bytes) -> bytes:
    """The same BMP with its rows stored top row first (negative height)."""
    off, w, h, bpp = (int.from_bytes(data[a:a + n], "little", signed=True)
                      for a, n in ((10, 4), (18, 4), (22, 4), (28, 2)))
    pitch = ((w * bpp + 7) // 8 + 3) & ~3
    rows = [data[off + y * pitch: off + (y + 1) * pitch] for y in range(h)]
    return data[:22] + (-h).to_bytes(4, "little", signed=True) + data[26:off] + b"".join(rows[::-1])


@pytest.mark.parametrize("kind", ["bgr24", "grey8", "palette8", "palette4", "mono1", "bgra32", "bgr24_top_down",
                                  "palette8_top_down"])
def test_bmp_decode_equals_cv2(tmp_path, kind):
    from mga_yolo_tpu.data.dataset import image_size as jax_image_size
    from mga_yolo_tpu_torch.data import image_io

    data = _bmp(kind.replace("_top_down", ""), _image(23, 37, 3, len(kind)))
    if kind.endswith("top_down"):
        data = _top_down(data)
    path = tmp_path / "a.bmp"
    path.write_bytes(data)
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(str(path)))
    np.testing.assert_array_equal(image_io.imread_gray(path), cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
    assert image_io.image_size(path) == jax_image_size(path) == (23, 37)


@pytest.mark.parametrize("compression, what", [(1, "RLE8"), (2, "RLE4"), (3, "BI_BITFIELDS"), (4, "embedded JPEG")])
def test_compressed_bmp_raises_naming_its_compression(tmp_path, compression, what):
    from mga_yolo_tpu_torch.data import image_io

    data = bytearray(cv2.imencode(".bmp", _image(8, 8, 3, 0))[1].tobytes())
    data[30:34] = compression.to_bytes(4, "little")
    (tmp_path / "c.bmp").write_bytes(bytes(data))
    with pytest.raises(ValueError, match=rf"c\.bmp: BMP with {what} compression is not supported"):
        image_io.imread(tmp_path / "c.bmp")


def _patched(data: bytes, marker: int, offset: int, value: bytes) -> bytes:
    """``data`` with ``value`` written ``offset`` bytes into the segment body of its first marker 0xFF ``marker``."""
    i = data.index(bytes([0xFF, marker])) + 4 + offset
    return data[:i] + value + data[i + len(value):]


def _refused():
    base = cv2.imencode(".jpg", _image(37, 53, 3, 7), [Q, 90])[1].tobytes()
    prog = cv2.imencode(".jpg", _image(37, 53, 3, 8), [Q, 90, P, 1])[1].tobytes()
    scans = [i for i in range(len(prog) - 1) if prog[i:i + 2] == b"\xff\xda"]
    return {
        "12-bit": (_patched(base, 0xC0, 0, b"\x0c"), "12-bit JPEG is not supported"),
        "arithmetic": (base.replace(b"\xff\xc0", b"\xff\xc9", 1), r"arithmetic-coded JPEG \(SOF9\)"),
        "lossless": (base.replace(b"\xff\xc0", b"\xff\xc3", 1), r"lossless JPEG \(SOF3\)"),
        "hierarchical": (base.replace(b"\xff\xc0", b"\xff\xc5", 1), r"hierarchical JPEG \(SOF5\)"),
        "past_2e30_pixels": (_patched(base, 0xC0, 1, b"\xff\xff\xff\xff"), "past the limit of 2\\^30 pixels"),
        "unrefined_progressive": (prog[:scans[3]] + b"\xff\xd9", "unrefined"),  # the DC and first AC scans only
        "truncated": (base[:len(base) // 2], "truncated or corrupt JPEG data"),
        "no_eoi": (base[:-2], "no EOI marker"),
    }


@pytest.mark.parametrize("kind", ["cmyk", "12-bit", "arithmetic", "lossless", "hierarchical", "past_2e30_pixels",
                                  "unrefined_progressive", "truncated", "no_eoi", "webp", "gif", "jpeg2000"])
def test_what_the_port_does_not_read_raises_naming_it(tmp_path, kind):
    """CMYK, 12-bit, arithmetic-coded, lossless and hierarchical JPEGs, more
    than 2^30 pixels (refused from the header, before any allocation), a
    progressive file whose blocks libjpeg would smooth, a cut file, and
    other formats (JPEG 2000) raise ValueError naming the file and what it
    is (libjpeg pads a cut file with grey and cv2 returns it; the port
    refuses it). WebP and GIF, once refused, now read as cv2 reads them,
    with their ``image_size`` (the JAX package's too for WebP)."""
    from mga_yolo_tpu.data.dataset import image_size as jax_image_size
    from mga_yolo_tpu_torch.data import image_io

    if kind in ("webp", "gif"):
        if kind == "webp":
            ok, enc = cv2.imencode(".webp", _image(16, 16, 3, 0))
            assert ok
            data = enc.tobytes()
        else:
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(_image(16, 16, 3, 0)[..., ::-1]).quantize(16).save(buf, "GIF")
            data = buf.getvalue()
        path = tmp_path / "x.img"
        path.write_bytes(data)
        np.testing.assert_array_equal(image_io.imread(path), cv2.imread(str(path)))
        np.testing.assert_array_equal(image_io.decode(data, gray=True),
                                      cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE))
        assert image_io.image_size(path) == (16, 16)
        if kind == "webp":
            assert jax_image_size(path) == (16, 16)
        return
    if kind == "cmyk":
        data, what = _exif_jpeg(_image(16, 16, 3, 0), 1, mode="CMYK"), r"4-component \(CMYK/YCCK\)"
    elif kind == "jpeg2000":
        data = b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(40)
        what = "JPEG 2000 \\(JP2\\), which the port does not read; the port reads PNG, JPEG"
    else:
        data, what = _refused()[kind]
    path = tmp_path / "x.img"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=rf"x\.img: .*{what}"):
        image_io.imread(path)
    with pytest.raises(ValueError, match=what):
        image_io.decode(data, gray=True)


@pytest.mark.parametrize("source", ["baseline420", "progressive444", "rst2_progressive", "grey", "bmp"])
def test_cut_and_flipped_files_raise_or_decode_at_their_header_size(source):
    """40 seeded truncations and byte flips of each valid file: each raises
    ValueError or gives an image of the size its (possibly flipped) header
    states; none crashes the process."""
    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data import image_io

    img = _image(37, 53, 3, 11)
    data = {"baseline420": lambda: cv2.imencode(".jpg", img)[1],
            "progressive444": lambda: cv2.imencode(".jpg", img, [P, 1, S, SAMPLING["444"]])[1],
            "rst2_progressive": lambda: cv2.imencode(".jpg", img, [P, 1, R, 2])[1],
            "grey": lambda: cv2.imencode(".jpg", img[..., 0], [O, 1])[1],
            "bmp": lambda: cv2.imencode(".bmp", img)[1]}[source]().tobytes()
    rng = np.random.default_rng(len(source))
    decoded = 0
    for i in range(40):
        b = bytearray(data)
        if i % 2:
            b = b[:int(rng.integers(0, len(b)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                j = int(rng.integers(len(b)))
                b[j] = int(rng.integers(256)) if rng.random() < 0.5 else b[j] ^ (1 << int(rng.integers(8)))
        b = bytes(b)
        for gray in (False, True):
            try:
                out = image_io.decode(b, gray=gray)
            except ValueError:
                continue
            decoded += 1
            if source == "bmp":
                size = (abs(int.from_bytes(b[22:26], "little", signed=True)), int.from_bytes(b[18:22], "little"))
            else:
                info = native.jpeg_header(b)
                size = (info["height"], info["width"])
            assert out.shape == size + (() if gray else (3,)) and out.dtype == np.uint8
    assert decoded > 0  # a flip in the entropy-coded data decodes (to other pixels)


@pytest.mark.parametrize("kind", ["png", "png_grey", "bmp", "bmp_top_down", "jpeg", "jpeg_progressive", "tiff"])
def test_image_size_equals_jax(tmp_path, kind):
    """``image_io.image_size`` is the JAX package's ``image_size``: PNG, BMP
    and JPEG headers (EXIF orientations: the parametrised test above); for
    TIFF the port reads the first IFD where the JAX package decodes with cv2,
    and both give cv2's (h, w)."""
    from mga_yolo_tpu.data.dataset import image_size as jax_image_size
    from mga_yolo_tpu_torch.data import image_io

    img = _image(29, 45, 3, 3)
    path = tmp_path / f"a.{kind.split('_')[0]}"
    if kind.startswith("bmp"):
        path.write_bytes(_top_down(_bmp("bgr24", img)) if kind == "bmp_top_down" else _bmp("bgr24", img))
    elif kind == "png_grey":
        cv2.imwrite(str(path), img[..., 0])
    else:
        cv2.imwrite(str(path), img, [P, 1] if kind == "jpeg_progressive" else [])
    if kind == "tiff":
        np.testing.assert_array_equal(image_io.imread(path), cv2.imread(str(path)))
    assert image_io.image_size(path) == jax_image_size(path) == (29, 45)


def _fixture_stems():
    return sorted(p.stem for p in FIXTURES.glob("*.jpg") if p.stem not in json.loads(
        (FIXTURES / "bench.json").read_text()))


@pytest.mark.parametrize("stem", _fixture_stems())
def test_committed_fixture_pixels_equal_cv2(stem):
    """The fixtures ``chip_smoke.py`` ``[jpeg]`` decodes on the card's host:
    their stored pixels are still cv2's decode, and the port's."""
    from mga_yolo_tpu_torch.data import image_io

    pixels = np.load(FIXTURES / "pixels.npz")
    path = FIXTURES / f"{stem}.jpg"
    for key, want in ((stem, cv2.imread(str(path))), (f"{stem}_gray", cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))):
        np.testing.assert_array_equal(pixels[key], want)
    np.testing.assert_array_equal(image_io.imread(path), pixels[stem])
    np.testing.assert_array_equal(image_io.imread_gray(path), pixels[f"{stem}_gray"])


def test_bench_files_decode_to_their_stored_digests():
    """The three larger files ``[jpeg]`` times: cv2's decode still has the
    stored SHA-256, the port's too, and the progressive grey file decodes to
    the baseline one's pixels (the same coefficients)."""
    from mga_yolo_tpu_torch.data import image_io

    digests = json.loads((FIXTURES / "bench.json").read_text())
    assert set(digests) == {"grey512_baseline", "grey512_progressive", "bgr640_420"}
    for stem, want in digests.items():
        path = FIXTURES / f"{stem}.jpg"
        for mode, flag, port in (("color", cv2.IMREAD_COLOR, image_io.imread), ("gray", cv2.IMREAD_GRAYSCALE,
                                                                                 image_io.imread_gray)):
            assert hashlib.sha256(cv2.imread(str(path), flag).tobytes()).hexdigest() == want[mode], (stem, mode)
            assert hashlib.sha256(port(path).tobytes()).hexdigest() == want[mode], (stem, mode)
    assert digests["grey512_baseline"] == digests["grey512_progressive"]


def test_threads_decode_at_once_as_one_thread_does():
    """The codecs hold no global state: 8 threads decoding and encoding
    different files at once give what one thread gives."""
    from mga_yolo_tpu_torch.data import image_io

    files = [cv2.imencode(".jpg", _image(48 + i, 64 - i, 3, i), [P, i % 2, S, list(SAMPLING.values())[i % 5]])[1]
             .tobytes() for i in range(8)]
    want = [image_io.imdecode(f) for f in files]
    got, errors = [None] * 8, []

    def work(i):
        try:
            for _ in range(5):
                got[i] = image_io.imdecode(files[i])
                assert image_io.encode_jpeg(got[i]) == cv2.imencode(".jpg", got[i])[1].tobytes()
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_jpeg_masks_sources_calibration_and_predictor_read_through_image_io(tmp_path):
    """The readers that go through image_io take JPEG: a mask (grey read,
    > 0), the prediction sources, the int8 calibration reader and the
    predictor's plot give the pixels cv2 gives (the JAX package's
    ``load_binary_mask`` on the same file)."""
    from mga_yolo_tpu.data import mask_ops as jax_mask_ops
    from mga_yolo_tpu_torch.data import mask_ops, sources
    from mga_yolo_tpu_torch.data.transforms import letterbox
    from mga_yolo_tpu_torch.export.tflite import _representative_gen
    from mga_yolo_tpu_torch.train.predictor import Results

    img = _image(40, 56, 3, 21)
    cv2.imwrite(str(tmp_path / "m.jpg"), (img[..., 0] > 128).astype(np.uint8) * 255)
    np.testing.assert_array_equal(mask_ops.load_binary_mask(tmp_path / "m.jpg"),
                                  jax_mask_ops.load_binary_mask(tmp_path / "m.jpg"))
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    want = cv2.imread(str(tmp_path / "a.jpg"))
    (frame,) = list(sources.iter_source(tmp_path / "a.jpg"))
    np.testing.assert_array_equal(frame.img, want)
    (batch,) = next(_representative_gen(tmp_path / "a.jpg", 1, 64)())
    np.testing.assert_array_equal(batch[0], letterbox(want, 64, scaleup=False)[0].astype(np.float32))
    r = Results(path=str(tmp_path / "a.jpg"), orig_shape=(40, 56), boxes=np.zeros((0, 6), np.float32), mga_masks={})
    np.testing.assert_array_equal(r.plot(), want)


def test_codecs_raise_when_the_library_does_not_build(tmp_path, monkeypatch):
    """No fallback: with a source g++ rejects, reading a JPEG or BMP and
    writing a JPEG raise RuntimeError with the compiler's message."""
    from mga_yolo_tpu_torch import native
    from mga_yolo_tpu_torch.data import image_io

    bad = tmp_path / "jpeg.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "CODEC_SOURCES", (bad, native.CODEC_SOURCES[1]))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    jpg = cv2.imencode(".jpg", _image(8, 8, 3, 0))[1].tobytes()
    bmp = cv2.imencode(".bmp", _image(8, 8, 3, 0))[1].tobytes()
    for call in (lambda: image_io.imdecode(jpg), lambda: image_io.imdecode(bmp),
                 lambda: image_io.encode_jpeg(_image(8, 8, 3, 0))):
        with pytest.raises(RuntimeError, match=r"jpeg\.cpp.* is not available: g\+\+ .* failed:\n.*error"):
            call()


def _without_dht(data: bytes, selectors: int | None = None) -> bytes:
    """``data`` with every DHT segment before its first scan taken out (later
    ones, between progressive scans, stay); with ``selectors`` the first
    scan's table numbers set to it, DC and AC."""
    out, p = bytearray(data[:2]), 2
    while data[p + 1] != 0xDA:
        n = (data[p + 2] << 8) | data[p + 3]
        if data[p + 1] != 0xC4:
            out += data[p:p + 2 + n]
        p += 2 + n
    sos = bytearray(data[p:])
    if selectors is not None:
        for i in range(sos[4]):
            sos[6 + 2 * i] = selectors * 0x11
    return bytes(out + sos)


@pytest.mark.parametrize("case", [f"bgr{s}" for s in SAMPLING] + ["grey", "grey_restarts"])
def test_jpeg_without_dht_decodes_as_cv2_with_the_standard_tables(case):
    """A sequential scan whose Huffman tables no DHT defined gets the Annex
    K.3 tables, as libjpeg-turbo (and MJPEG cameras) assume: colour at each
    sampling and grey, equal to cv2 in colour and grey reads, tolerance 0."""
    from mga_yolo_tpu_torch.data import image_io

    if case.startswith("grey"):
        params = [Q, 85] + ([R, 2] if case == "grey_restarts" else [])
        data = cv2.imencode(".jpg", _image(37, 53, 1, 21), params)[1].tobytes()
    else:
        data = cv2.imencode(".jpg", _image(37, 53, 3, 22), [Q, 85, S, SAMPLING[case[3:]]])[1].tobytes()
    stripped = _without_dht(data)
    assert b"\xff\xc4" not in stripped[:stripped.index(b"\xff\xda")]
    for gray, flag in ((False, cv2.IMREAD_COLOR), (True, cv2.IMREAD_GRAYSCALE)):
        want = cv2.imdecode(np.frombuffer(stripped, np.uint8), flag)
        assert want is not None
        np.testing.assert_array_equal(image_io.decode(stripped, gray=gray), want)
        np.testing.assert_array_equal(want, cv2.imdecode(np.frombuffer(data, np.uint8), flag))


@pytest.mark.parametrize("case", ["progressive420", "progressive444", "grey_progressive", "table2", "table3"])
def test_jpeg_without_dht_that_cv2_refuses_is_refused(case):
    """Where cv2 decodes no DHT-less file, neither does the port: libjpeg-turbo
    loads no standard table for a progressive scan, and has none for table
    numbers 2 and 3."""
    from mga_yolo_tpu_torch.data import image_io

    if case.startswith("table"):
        data = _without_dht(cv2.imencode(".jpg", _image(37, 53, 3, 23), [Q, 85])[1].tobytes(), int(case[-1]))
    elif case == "grey_progressive":
        data = _without_dht(cv2.imencode(".jpg", _image(37, 53, 1, 24), [Q, 85, P, 1])[1].tobytes())
    else:
        data = _without_dht(cv2.imencode(".jpg", _image(37, 53, 3, 25), [Q, 85, P, 1, S, SAMPLING[case[-3:]]])[1]
                            .tobytes())
    assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match=r"Huffman table \d is not defined"):
        image_io.decode(data)


@pytest.mark.parametrize("samp", list(SAMPLING))
def test_jpeg_planes_are_the_unconverted_components(samp):
    """``jpeg_decode_planes`` (the video path's MJPEG read) gives each
    component at its sampled size, through ffmpeg's simple IDCT: its luma
    plane is within one level of libjpeg's (cv2's grey read)."""
    from mga_yolo_tpu_torch import native

    h, w = 37, 53
    data = cv2.imencode(".jpg", _image(h, w, 3, 26), [Q, 90, S, SAMPLING[samp]])[1].tobytes()
    planes, meta = native.jpeg_decode_planes(_without_dht(data))
    hs, vs = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2), "411": (4, 1)}[samp]
    assert meta["sampling"][0] == (hs, vs) and (meta["height"], meta["width"], meta["rgb"]) == (h, w, False)
    assert [p.shape for p in planes] == [(h, w)] + [(-(-h // vs), -(-w // hs))] * 2
    grey = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    assert np.abs(planes[0].astype(np.int16) - grey).max() <= 1
