"""TFLite and SavedModel export of the port's eval forward, and the runner
of exported files (counterpart of ``mga_yolo_tpu/utils/tflite_export.py``).

``export_tflite`` converts :func:`tf_graph.tf_forward`'s concrete function
with TensorFlow's own ``TFLiteConverter``, in float32 or quantized with the
JAX package's settings (``fp16``, ``dynamic``, or static-range ``int8``
through the ``QuantizationDebugger`` with ``DIV`` and ``SOFTMAX`` kept in
float, boxes and scores as separate outputs); ``export_saved_model`` writes
the same function as a TF SavedModel (TF-Serving) whose ``f`` maps
``images (B, S, S, 3) float32`` to ``(decoded, p3, p4, p5)``. NMS stays
outside the file, as in the reference's default TFLite export. The
checkpoint is rebuilt on the CPU, and ``verify`` holds the file against the
port's own float32 forward there.

:class:`ExportedModel` runs either file on the host at its own batch
(chunks and a padded tail), for ``train.predictor.TFLitePredictor`` and
``cli.val``.

Every entry imports TensorFlow inside it, and where it does not import (the
card's host) raises an ``ImportError`` that names ``tensorflow`` and the
entry: nothing falls back to another format.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

QUANTIZE_MODES = ("fp16", "dynamic", "int8")


def require_tensorflow(what: str):
    """The ``tensorflow`` module, or an ImportError naming it and ``what``."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(f"{what} needs tensorflow, which does not import here ({e}); run it on a host "
                          "with TensorFlow") from e
    return tf


def is_saved_model(path) -> bool:
    return (Path(path) / "saved_model.pb").is_file()


def make_interpreter(model_path: Optional[str] = None, model_content: Optional[bytes] = None):
    """TFLite interpreter with allocated tensors, falling back to the
    no-default-delegate resolver when XNNPACK refuses a node (int8
    static-range graphs: "Node ... (TfLiteXNNPackDelegate) failed to
    prepare")."""
    tf = require_tensorflow("the TFLite interpreter")
    kw = {"model_path": model_path} if model_path else {"model_content": model_content}
    interp = tf.lite.Interpreter(**kw)
    try:
        interp.allocate_tensors()
        return interp
    except RuntimeError:
        interp = tf.lite.Interpreter(
            **kw, experimental_op_resolver_type=tf.lite.experimental.OpResolverType.BUILTIN_WITHOUT_DEFAULT_DELEGATES)
        interp.allocate_tensors()
        return interp


def reassemble_decoded(outs: list) -> np.ndarray:
    """The (B, A, 4+nc) decoded head from the output arrays: one rank-3
    ``decoded``, or the int8 split pair (boxes (B, A, 4), scores (B, A, nc)),
    told apart by the last dim 4 of the boxes (by order when nc == 4: boxes
    come first)."""
    three = [np.asarray(o) for o in outs if np.asarray(o).ndim == 3]
    if len(three) == 1:
        return three[0]
    if len(three) != 2:
        raise ValueError(f"expected 1 or 2 rank-3 outputs, got {len(three)}")
    a, b = three
    if b.shape[-1] == 4 and a.shape[-1] != 4:
        a, b = b, a
    return np.concatenate([a, b], axis=-1)


def decoded_output_details(interp) -> tuple[list, int]:
    """(rank-3 output details in concat order, nc) of a loaded interpreter:
    ``([decoded], nc)`` or, for the int8 split layout, ``([boxes, scores],
    nc)``."""
    dets = [o for o in interp.get_output_details() if len(o["shape"]) == 3]
    if len(dets) == 1:
        return dets, int(dets[0]["shape"][-1]) - 4
    if len(dets) != 2:
        raise ValueError(f"expected 1 or 2 rank-3 outputs, got {len(dets)}")
    a, b = dets
    if int(b["shape"][-1]) == 4 and int(a["shape"][-1]) != 4:
        a, b = b, a  # boxes first; nc == 4 ties fall back to output order
    return [a, b], int(b["shape"][-1])


def _representative_gen(source, batch: int, size: int, n_max: int = 32):
    """Calibration batches for the int8 export: ``source`` is a directory
    of images, one image, a list of image paths, or None (8 uniform-noise
    batches from ``default_rng(0)``: functional but weak calibration). A
    source that does not exist or holds no image is a ValueError; images are
    read with ``data.image_io`` (PNG, JPEG, BMP, TIFF or WebP: any other file
    raises, naming the file and its format) and letterboxed to ``size`` without upscaling."""
    from mga_yolo_tpu_torch.data.dataset import IMG_EXTS

    paths = []
    if source is not None:
        if isinstance(source, (list, tuple)):
            paths = [Path(q) for q in source]
        else:
            p = Path(source)
            if p.is_dir():
                paths = sorted(q for q in p.rglob("*") if q.suffix.lower() in IMG_EXTS)
            elif p.is_file():
                paths = [p]
            else:
                raise ValueError(f"int8 calibration source not found: {source}")
        if not paths:
            raise ValueError(f"no images under calibration source: {source}")
    paths = paths[:n_max]

    def gen():
        if not paths:
            rng = np.random.default_rng(0)
            for _ in range(8):
                yield [rng.uniform(0, 255, (batch, size, size, 3)).astype(np.float32)]
            return
        from mga_yolo_tpu_torch.data import image_io
        from mga_yolo_tpu_torch.data.transforms import letterbox

        buf = []
        for q in paths:
            img, _ = letterbox(image_io.imread(q), size, scaleup=False)
            buf.append(img.astype(np.float32))
            if len(buf) == batch:
                yield [np.stack(buf)]
                buf = []
        if buf:  # pad the tail to the static batch
            buf += [buf[-1]] * (batch - len(buf))
            yield [np.stack(buf)]

    return gen


def _rebuild(ckpt_path, model_yaml, scale):
    from mga_yolo_tpu_torch.utils.checkpoint import rebuild_from_checkpoint

    return rebuild_from_checkpoint(ckpt_path, model_yaml, scale, device="cpu")


def port_forward(net, x: np.ndarray, split_decoded: bool = False) -> tuple:
    """The port's float32 eval forward of NHWC 0-255 ``x`` on ``net``'s
    device, in the export's output layout, as numpy."""
    import torch

    dev = next(net.parameters()).device
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(x).to(dev).permute(0, 3, 1, 2).contiguous() / 255.0)
    decoded = out["det"][0].float().cpu().numpy()
    segs = tuple(out["seg"][k].float().permute(0, 2, 3, 1).cpu().numpy() for k in sorted(out["seg"]))
    return ((decoded[..., :4], decoded[..., 4:]) if split_decoded else (decoded,)) + segs


def convert_tflite(net, batch: int, imgsz: int, quantize: Optional[str] = None,
                   representative: Optional[object] = None) -> bytes:
    """The ``.tflite`` flatbuffer of ``net``'s eval forward (an ``MGAModel``
    in memory) at a fixed ``batch`` and ``imgsz``: :func:`export_tflite`
    without the checkpoint, the file and the check."""
    tf = require_tensorflow("the TFLite export")
    from mga_yolo_tpu_torch.export.tf_graph import tf_forward

    if quantize and quantize not in QUANTIZE_MODES:
        raise ValueError(f"unknown quantize mode {quantize!r} (fp16|dynamic|int8)")
    fn = tf_forward(net, batch, imgsz, split_decoded=quantize == "int8").get_concrete_function()
    converter = tf.lite.TFLiteConverter.from_concrete_functions([fn])
    if quantize:
        converter.optimizations = [tf.lite.Optimize.DEFAULT]
    if quantize == "fp16":
        converter.target_spec.supported_types = [tf.float16]
    if quantize != "int8":
        return converter.convert()
    rep = _representative_gen(representative, batch, imgsz)
    converter.representative_dataset = rep
    dbg = tf.lite.experimental.QuantizationDebugger(
        converter=converter, debug_dataset=rep,
        debug_options=tf.lite.experimental.QuantizationDebugOptions(denylisted_ops=["DIV", "SOFTMAX"]))
    return dbg.get_nondebug_quantized_model()


def export_tflite(ckpt_path: str | Path, out_path: Optional[str | Path] = None, imgsz: Optional[int] = None,
                  batch: int = 1, model_yaml: Optional[str] = None, scale: Optional[str] = None,
                  quantize: Optional[str] = None, verify: bool = True,
                  representative: Optional[object] = None) -> dict:
    """Convert a checkpoint (the trainer's ``.pt`` or a reference-format
    file) to a ``.tflite`` flatbuffer of a fixed batch; returns an info dict
    (path, bytes, imgsz, batch, quantize, outputs, max_abs_diff_decoded).

    ``quantize``: None (float32), ``"fp16"``, ``"dynamic"`` or ``"int8"``
    (static range, calibrated on ``representative``: see
    :func:`_representative_gen`). Static int8 caveats, as in the JAX
    package: a quantized DIV traps on the masked average's eps denominator
    and the 16-bin DFL loses its resolution, so the QuantizationDebugger
    keeps ``DIV`` and ``SOFTMAX`` in float; one per-tensor scale over box
    pixels (0..imgsz) and confidences (0..1) crushes the confidences, so the
    int8 graph returns boxes and scores as separate outputs
    (:func:`reassemble_decoded` joins them). Boxes still dequantize at about
    imgsz/255 px: validate with ``cli.val --weights model.tflite``.

    ``verify`` runs the flatbuffer on a uniform-noise input (``default_rng(0)``)
    and reports the max |d| of the decoded head against the port's float32
    forward on the CPU.
    """
    require_tensorflow("mga-ckpt export-tflite")
    if quantize and quantize not in QUANTIZE_MODES:
        raise ValueError(f"unknown quantize mode {quantize!r} (fp16|dynamic|int8)")
    net, meta = _rebuild(ckpt_path, model_yaml, scale)
    size = int(imgsz or meta.get("imgsz", 640))
    split = quantize == "int8"
    flatbuffer = convert_tflite(net, batch, size, quantize, representative)
    out = Path(out_path) if out_path else Path(str(ckpt_path)).with_suffix(".tflite")
    out = out.absolute()
    out.write_bytes(flatbuffer)
    info = {"path": str(out), "bytes": len(flatbuffer), "imgsz": size, "batch": batch,
            "quantize": quantize or "none", "outputs": None, "max_abs_diff_decoded": None}
    if verify:
        x = np.random.default_rng(0).uniform(0, 255, (batch, size, size, 3)).astype(np.float32)
        interp = make_interpreter(model_content=flatbuffer)
        (inp,) = interp.get_input_details()
        interp.set_tensor(inp["index"], x)
        interp.invoke()
        outs = [interp.get_tensor(o["index"]) for o in interp.get_output_details()]
        info["outputs"] = [tuple(o.shape) for o in outs]
        ref = reassemble_decoded(list(port_forward(net, x, split)))
        info["max_abs_diff_decoded"] = float(np.max(np.abs(reassemble_decoded(outs) - ref)))
    return info


def export_saved_model(ckpt_path: str | Path, out_dir: str | Path, imgsz: Optional[int] = None, batch: int = 1,
                       model_yaml: Optional[str] = None, scale: Optional[str] = None, verify: bool = True) -> dict:
    """Export the eval forward as a TF SavedModel (TF-Serving deployable)
    whose ``f(images (B, S, S, 3) float32)`` returns ``(decoded, p3, p4,
    p5)``; returns an info dict (path, imgsz, batch, outputs,
    max_abs_diff_decoded: the loaded model against the port's float32
    forward on the CPU, on the input of :func:`export_tflite`'s check)."""
    tf = require_tensorflow("mga-ckpt export-savedmodel")
    from mga_yolo_tpu_torch.export.tf_graph import tf_forward

    net, meta = _rebuild(ckpt_path, model_yaml, scale)
    size = int(imgsz or meta.get("imgsz", 640))
    module = tf.Module()
    module.f = tf_forward(net, batch, size)
    out_dir = Path(out_dir).absolute()
    tf.saved_model.save(module, str(out_dir))
    info = {"path": str(out_dir), "imgsz": size, "batch": batch, "outputs": None, "max_abs_diff_decoded": None}
    if verify:
        x = np.random.default_rng(0).uniform(0, 255, (batch, size, size, 3)).astype(np.float32)
        got = tf.saved_model.load(str(out_dir)).f(tf.constant(x))
        info["outputs"] = [tuple(g.shape) for g in got]
        ref = port_forward(net, x)[0]
        info["max_abs_diff_decoded"] = float(np.max(np.abs(got[0].numpy() - ref)))
    return info


class ExportedModel:
    """An exported ``.tflite`` file or SavedModel directory, run on the host
    at the batch it was exported with: ``x (n, S, S, 3)`` float 0-255 goes
    through in chunks of that batch, the last one padded with copies of its
    last image and the padding's outputs dropped (the batch is baked in:
    the graph's reshapes have constant shapes, so resizing the input is
    unsafe). ``what`` names the entry in the error where TensorFlow does
    not import.

    Attributes: ``batch``, ``imgsz``, ``nc``; calling returns ``(decoded
    (n, A, 4+nc) float32, {"p3": (n, h, w, 1), ...})``, the mask logits
    named by their stride.
    """

    def __init__(self, path: str | Path, what: str):
        tf = self.tf = require_tensorflow(what)
        self.path = str(path)
        if is_saved_model(path):
            self._f = tf.saved_model.load(self.path).f
            shape = self._f.concrete_functions[0].inputs[0].shape.as_list()     # (B, S, S, 3)
            self.batch, self.imgsz = int(shape[0]), int(shape[1])
            outs = [tuple(o.shape) for o in self._f(tf.zeros(shape, tf.float32))]
            self._interp = None
        else:
            self._interp = make_interpreter(model_path=self.path)
            self._inp = self._interp.get_input_details()[0]
            self.batch, self.imgsz = int(self._inp["shape"][0]), int(self._inp["shape"][1])
            details = self._interp.get_output_details()
            self._dec, _ = decoded_output_details(self._interp)
            self._seg = [o for o in details if len(o["shape"]) == 4]
            outs = [tuple(o["shape"]) for o in details]
        three = [s for s in outs if len(s) == 3]
        self.nc = sum(s[-1] for s in three) - 4
        self.seg_names = [f"p{int(np.log2(self.imgsz // s[1]))}" for s in outs if len(s) == 4]

    def check_size(self, imgsz: Optional[int]) -> int:
        """The file's image size; a ValueError for another ``imgsz``."""
        if imgsz and int(imgsz) != self.imgsz:
            raise ValueError(f"{self.path} takes {self.imgsz} px images (its size is baked in); got imgsz {imgsz}")
        return self.imgsz

    def _run(self, chunk: np.ndarray) -> tuple[np.ndarray, list]:
        if self._interp is None:
            got = [g.numpy() for g in self._f(self.tf.constant(chunk))]
            return reassemble_decoded(got), [g for g in got if g.ndim == 4]
        self._interp.set_tensor(self._inp["index"], chunk)
        self._interp.invoke()
        parts = [self._interp.get_tensor(o["index"]) for o in self._dec]
        dec = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=-1)
        return dec, [self._interp.get_tensor(o["index"]) for o in self._seg]

    def __call__(self, x: np.ndarray) -> tuple[np.ndarray, dict]:
        x = np.asarray(x, np.float32)
        dec, segs = [], [[] for _ in self.seg_names]
        for i in range(0, x.shape[0], self.batch):
            chunk = x[i:i + self.batch]
            keep = chunk.shape[0]
            if keep < self.batch:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], self.batch - keep, 0)])
            d, s = self._run(chunk)
            dec.append(d[:keep])
            for acc, a in zip(segs, s):
                acc.append(a[:keep])
        return (np.concatenate(dec).astype(np.float32),
                {k: np.concatenate(v).astype(np.float32) for k, v in zip(self.seg_names, segs)})
