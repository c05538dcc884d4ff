"""PyTorch port: the TFLite and SavedModel export and the consumers of
exported files, against the port's forward and the JAX package.

The models are ``tests/test_remat.py``'s MINI graph (MaskCBAM at P3) and
MINI-sized heads of each variant (MaskECA, MaskSPADE, the prob gate in eval
mode, plain YOLOv8), at 64 px, batch 1, on weights from the JAX package's
init shapes filled with a numpy seed (``seeded_variables``) and carried
over by ``utils/jax_weights.py``. Each file is exported once, in a module
fixture.

Tolerances. float32 files against the port's CPU forward: decoded atol
1e-3 (as the JAX package's ``test_tflite_export.py``), mask logits atol
1e-4; against the JAX package's eval forward, ``test_torch_slice.py``'s
rtol 1e-3 / atol 2e-3 (decoded) and rtol 1e-3 / atol 1e-4 (mask logits); the
port's file against the JAX package's own export, atol 1e-3. Quantized
files against the port's forward, measured with TensorFlow 2.21 on an
x86 CPU at 64 px on these weights and held at four to six times the
measured error: fp16 decoded atol 1e-4 (measured 1.6e-5) and logits atol
1e-4 (2.3e-5); dynamic range decoded atol 1e-3 (2.2e-4) and logits atol
3e-4 (6.7e-5); int8 decoded within 64 px, as the JAX test holds it.
"""

import contextlib
import io
import json
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from mga_yolo_tpu_torch.export.tflite import port_forward  # noqa: E402
from tests._torch_port import few_torch_threads, seeded_variables  # noqa: E402,F401  (a module fixture)
from tests.test_remat import MINI_CFG  # noqa: E402

pytestmark = pytest.mark.usefixtures("few_torch_threads")
IMGSZ = 64


def _variant(module: str | None) -> dict:
    """MINI_CFG with the P3 attention ``module``; None: plain YOLOv8 (no
    mask head, Detect on P3/P4/P5 straight)."""
    cfg = json.loads(json.dumps(MINI_CFG))
    if module is None:
        cfg["head"] = [[[4, 5, 7], 1, "Detect", ["nc"]]]
    else:
        cfg["head"][1][2] = module
    return cfg


VARIANTS = {"eca": ("MaskECA", None), "spade": ("MaskSPADE", None), "prob": ("MaskCBAM", "gumbel"),
            "base": (None, None)}


def cfg_text(cfg: dict) -> str:
    """The model YAML of ``cfg`` in the layout the port's YAML reader takes."""
    lines = []
    for k, v in cfg.items():
        if k in ("backbone", "head"):
            lines += [f"{k}:"] + [f"  - {json.dumps(row)}" for row in v]
        elif isinstance(v, dict):
            lines += [f"{k}:"] + [f"  {a}: {json.dumps(b)}" for a, b in v.items()]
        else:
            lines.append(f"{k}: {json.dumps(v)}")
    return "\n".join(lines) + "\n"


def port_model(cfg: dict, seed: int, prob_approach=None):
    """(JAX model, its variables, the port's model carrying them, eval, CPU)."""
    from mga_yolo_tpu.models.yolo import create_model as jcreate
    from mga_yolo_tpu_torch.models.yolo import create_model
    from mga_yolo_tpu_torch.utils.jax_weights import state_dict_from_jax

    jmodel, _ = jcreate(dict(cfg), scale="n", nc=1)
    v = seeded_variables(jmodel, IMGSZ, seed=seed)
    det = next(k for k in v["params"] if k.endswith("_Detect"))
    for k, p in v["params"][det].items():  # box sides near one stride: boxes inside the image
        if k.startswith("cv2_") and k.endswith("_2"):
            p["kernel"] = np.asarray(p["kernel"]) * 0.05
            p["bias"] = np.tile(8.0 * np.eye(16, dtype=np.float32)[1], 4)
    net, spec = create_model(dict(cfg), scale="n", nc=1, device="cpu", prob_approach=prob_approach)
    net.load_state_dict(state_dict_from_jax(v, spec), strict=True)
    return jmodel, v, net.eval()


def interp_run(path_or_bytes, x: np.ndarray) -> list:
    from mga_yolo_tpu_torch.export.tflite import make_interpreter

    kw = {"model_content": path_or_bytes} if isinstance(path_or_bytes, bytes) else {"model_path": str(path_or_bytes)}
    interp = make_interpreter(**kw)
    interp.set_tensor(interp.get_input_details()[0]["index"], x)
    interp.invoke()
    return [interp.get_tensor(o["index"]) for o in interp.get_output_details()]


def plain_interpreter(path):
    """An interpreter without the default delegate: every node stays visible."""
    interp = tf.lite.Interpreter(
        model_path=str(path),
        experimental_op_resolver_type=tf.lite.experimental.OpResolverType.BUILTIN_WITHOUT_DEFAULT_DELEGATES)
    interp.allocate_tensors()
    return interp


@pytest.fixture(scope="module")
def flagship(tmp_path_factory, few_torch_threads):  # noqa: F811
    """The MINI flagship as a port checkpoint, its fp32 / fp16 / dynamic /
    int8 ``.tflite`` files and its SavedModel, and an input."""
    import jax

    from mga_yolo_tpu_torch.cli import ckpt as cli_ckpt
    from mga_yolo_tpu_torch.export.tflite import export_tflite

    root = tmp_path_factory.mktemp("tfl")
    jmodel, v, net = port_model(MINI_CFG, seed=0)
    (root / "mini.yaml").write_text(cfg_text(MINI_CFG))
    meta = {"model_yaml": str(root / "mini.yaml"), "model_scale": "n", "nc": 1, "imgsz": IMGSZ}
    torch.save({"model_state_dict": net.state_dict(), "meta": meta,
                "train_args": {"nc": 1, "model": meta["model_yaml"], "model_scale": "n"}}, root / "best.pt")
    pt, log = str(root / "best.pt"), io.StringIO()
    with contextlib.redirect_stdout(log):  # float32 through the CLI, the quantized modes through the function
        info = {"fp32": cli_ckpt.main(["export-tflite", pt, "--out", str(root / "mini_fp32.tflite")]),
                "saved": cli_ckpt.main(["export-savedmodel", pt, str(root / "sm")])}
    info.update({q: export_tflite(pt, root / f"mini_{q}.tflite", quantize=q) for q in ("fp16", "dynamic", "int8")})
    x = np.random.default_rng(5).uniform(0, 255, (1, IMGSZ, IMGSZ, 3)).astype(np.float32)
    out_j = jax.jit(lambda b: jmodel.apply(v, b / 255.0, train=False))(x)  # the JAX package's eval forward
    jax_out = (np.asarray(out_j["det"][0]), np.asarray(out_j["seg"]["p3"]))
    return dict(root=root, jmodel=jmodel, v=v, net=net, meta=meta, info=info, x=x, jax_out=jax_out,
                log=log.getvalue())


# -- 1. fp32 against the forwards ------------------------------------------------


@pytest.mark.parametrize("kind", ["tflite", "saved_model"])
def test_fp32_file_matches_the_port_and_the_jax_forward(flagship, kind):
    x = flagship["x"]
    if kind == "tflite":
        got = interp_run(flagship["root"] / "mini_fp32.tflite", x)
        info = flagship["info"]["fp32"]
    else:
        got = [g.numpy() for g in tf.saved_model.load(str(flagship["root"] / "sm")).f(tf.constant(x))]
        info = flagship["info"]["saved"]
    assert info["max_abs_diff_decoded"] < 1e-3 and info["imgsz"] == IMGSZ and info["batch"] == 1
    assert f"max |d| decoded = {info['max_abs_diff_decoded']:.2e}" in flagship["log"]
    assert "verified vs the port's forward" in flagship["log"]
    assert info["outputs"] == [(1, 84, 5), (1, 8, 8, 1)]
    want = port_forward(flagship["net"], x)
    assert [g.shape for g in got] == [w.shape for w in want] == [(1, 84, 5), (1, 8, 8, 1)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[0], flagship["jax_out"][0], rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got[1], flagship["jax_out"][1], rtol=1e-3, atol=1e-4)


# -- 2. every variant ------------------------------------------------------------


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_fp32_file_matches_the_port_forward(name):
    from mga_yolo_tpu_torch.export.tflite import convert_tflite

    module, prob = VARIANTS[name]
    _, _, net = port_model(_variant(module), seed=1, prob_approach=prob)
    x = np.random.default_rng(6).uniform(0, 255, (1, IMGSZ, IMGSZ, 3)).astype(np.float32)
    got = interp_run(convert_tflite(net, 1, IMGSZ), x)
    want = port_forward(net, x)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert len(got) == (1 if module is None else 2)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


# -- 3. against the JAX package's own export -----------------------------------------


def test_same_inputs_outputs_and_values_as_the_jax_export(flagship, monkeypatch):
    """The JAX package's ``export_tflite`` of the same weights: its own
    conversion (jax2tf, ``experimental_from_jax``), with its checkpoint
    reader handing it the weights in memory (a checkpoint round trip would
    add a JAX init compile and orbax, and tests nothing of the export)."""
    from mga_yolo_tpu.utils import checkpoint as jax_checkpoint
    from mga_yolo_tpu.utils.tflite_export import export_tflite as jax_export

    root = flagship["root"]
    monkeypatch.setattr(jax_checkpoint, "rebuild_from_checkpoint",
                        lambda *a, **kw: (flagship["jmodel"], flagship["v"], dict(flagship["meta"])))
    jax_export(root / "best.pt", root / "jax.tflite", imgsz=IMGSZ, verify=False)

    ours, theirs = (plain_interpreter(root / f) for f in ("mini_fp32.tflite", "jax.tflite"))
    for get in ("get_input_details", "get_output_details"):
        a, b = getattr(ours, get)(), getattr(theirs, get)()
        assert [(list(d["shape"]), d["dtype"]) for d in a] == [(list(d["shape"]), d["dtype"]) for d in b], get
    x = flagship["x"]
    for g, w in zip(interp_run(root / "mini_fp32.tflite", x), interp_run(root / "jax.tflite", x)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)


# -- 4. quantized files ----------------------------------------------------------------


def weight_dtypes(interp) -> dict:
    """{stored type: the sizes of the conv and fully-connected weights of
    that type}: each filter input, or the input of the DEQUANTIZE that
    makes it."""
    tensors = {t["index"]: t for t in interp.get_tensor_details()}
    made_by = {o: op for op in interp._get_ops_details() for o in op["outputs"]}
    out: dict = {}
    for op in interp._get_ops_details():
        if op["op_name"] in ("CONV_2D", "DEPTHWISE_CONV_2D", "FULLY_CONNECTED"):
            w = op["inputs"][1]
            src = made_by.get(w)
            if src is not None and src["op_name"] == "DEQUANTIZE":
                w = src["inputs"][0]
            out.setdefault(np.dtype(tensors[w]["dtype"]).name, []).append(int(np.prod(tensors[w]["shape"])))
    return out


@pytest.mark.parametrize("mode, dec_atol, seg_atol", [("fp16", 1e-4, 1e-4), ("dynamic", 1e-3, 3e-4)])
def test_fp16_and_dynamic_files(flagship, mode, dec_atol, seg_atol):
    """fp16 stores every weight in float16; dynamic range stores in int8
    every weight of 1024 elements or more (the converter's threshold), the
    smaller ones in float32."""
    path = flagship["root"] / f"mini_{mode}.tflite"
    assert flagship["info"][mode]["quantize"] == mode
    assert flagship["info"][mode]["bytes"] < flagship["info"]["fp32"]["bytes"]
    got = interp_run(path, flagship["x"])
    want = port_forward(flagship["net"], flagship["x"])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=dec_atol)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=seg_atol)
    types = weight_dtypes(plain_interpreter(path))
    if mode == "fp16":
        assert set(types) == {"float16"}
    else:
        assert set(types) == {"int8", "float32"}
        assert min(types["int8"]) >= 1024 > max(types["float32"])


def test_int8_file_splits_boxes_and_scores_and_keeps_div_and_softmax_float(flagship):
    from mga_yolo_tpu_torch.export.tflite import decoded_output_details, make_interpreter

    path = flagship["root"] / "mini_int8.tflite"
    info = flagship["info"]["int8"]
    assert len(info["outputs"]) == 3 and sorted(s[-1] for s in info["outputs"] if len(s) == 3) == [1, 4]
    assert info["max_abs_diff_decoded"] < 64.0
    dec_outs, nc = decoded_output_details(make_interpreter(model_path=str(path)))
    assert nc == 1 and len(dec_outs) == 2 and int(dec_outs[0]["shape"][-1]) == 4  # boxes first
    interp = plain_interpreter(path)
    tensors = {t["index"]: t for t in interp.get_tensor_details()}
    ops = [op for op in interp._get_ops_details() if op["op_name"] in ("DIV", "SOFTMAX")]
    assert {op["op_name"] for op in ops} == {"DIV", "SOFTMAX"}
    for op in ops:
        for t in (*op["inputs"], *op["outputs"]):
            assert tensors[t]["dtype"] == np.float32, (op["op_name"], tensors[t]["name"])
    assert "int8" in weight_dtypes(interp)


# -- 5. interop ---------------------------------------------------------------------


def test_jax_predictor_reads_the_port_file(flagship):
    from mga_yolo_tpu.train.predictor import TFLitePredictor as JaxPredictor
    from mga_yolo_tpu_torch.train.predictor import TFLitePredictor, load_predictor

    path = flagship["root"] / "mini_fp32.tflite"
    x = np.random.default_rng(7).integers(0, 256, (3, IMGSZ, IMGSZ, 3)).astype(np.uint8)  # a chunk and a padded tail
    dec_j, seg_j = JaxPredictor(path).forward_batch(x)
    pred = load_predictor(path, conf=0.01, device="cpu")
    assert isinstance(pred, TFLitePredictor) and pred.imgsz == IMGSZ
    dec, seg = pred.forward_batch(x)
    np.testing.assert_array_equal(dec, dec_j)
    assert list(seg) == list(seg_j) == ["p3"]
    np.testing.assert_array_equal(seg["p3"], seg_j["p3"])
    with pytest.raises(ValueError, match="takes 64 px images"):  # the size is baked into the file
        load_predictor(path, imgsz=32, device="cpu")
    saved = load_predictor(flagship["root"] / "sm", device="cpu")
    dec_s, seg_s = saved.forward_batch(x)
    np.testing.assert_allclose(dec_s, dec, rtol=0, atol=1e-3)
    np.testing.assert_allclose(seg_s["p3"], seg["p3"], rtol=0, atol=1e-4)


def test_cli_val_and_predict_on_the_files_give_the_checkpoints_results(flagship, tmp_path):
    """``cli.val`` on the fp32 ``.tflite``, the SavedModel and their source
    ``.pt``: the same metrics.json keys, the metrics equal to 1e-6 (the
    speed dict is a timing). The val labels are the model's own detections,
    so the metrics count true positives."""
    from mga_yolo_tpu_torch.cli import predict as cli_predict
    from mga_yolo_tpu_torch.cli import val as cli_val
    from mga_yolo_tpu_torch.data import image_io
    from mga_yolo_tpu_torch.data.synthetic import write_synthetic_dataset
    from mga_yolo_tpu_torch.ops.nms import nms_numpy

    root = flagship["root"]
    data = write_synthetic_dataset(tmp_path / "ds", n=1, size=IMGSZ, n_val=3)
    for path in sorted((tmp_path / "ds" / "images" / "val").glob("*.png")):
        decoded = port_forward(flagship["net"], image_io.imread(path)[None].astype(np.float32))[0][0]
        boxes = np.clip(nms_numpy(decoded, 0.25, 0.7)[:3, :4], 0, IMGSZ) / IMGSZ
        assert len(boxes)
        (tmp_path / "ds" / "labels" / "val" / f"{path.stem}.txt").write_text("".join(
            f"0 {(x1 + x2) / 2:.6f} {(y1 + y2) / 2:.6f} {x2 - x1:.6f} {y2 - y1:.6f}\n" for x1, y1, x2, y2 in boxes))
    res = {}
    for name, w in (("pt", root / "best.pt"), ("tflite", root / "mini_fp32.tflite"), ("sm", root / "sm")):
        cli_val.main(["--weights", str(w), "--data", str(data), "--batch", "2", "--device", "cpu",
                      "--out", str(tmp_path / name)])
        res[name] = json.loads((tmp_path / name / "metrics.json").read_text())
    assert res["pt"]["metrics/mAP50(B)"] > 0
    for name in ("tflite", "sm"):
        assert set(res[name]) == set(res["pt"])
        for k in res["pt"]:
            if k != "speed":
                np.testing.assert_allclose(res[name][k], res["pt"][k], rtol=0, atol=1e-6, err_msg=(name, k))
    with pytest.raises(ValueError, match="takes 64 px images"):
        cli_val.main(["--weights", str(root / "sm"), "--data", str(data), "--imgsz", "32", "--device", "cpu"])
    val_dir, pred = tmp_path / "ds" / "images" / "val", tmp_path / "pred"
    out = cli_predict.main(["--weights", str(root / "mini_fp32.tflite"), "--source", str(val_dir), "--out", str(pred),
                            "--device", "cpu"])
    assert out["images"] == 3
    assert len(list(pred.glob("*_pred.jpg"))) == len(list(pred.glob("*_mask_p3.png"))) == 3


# -- 6. refusals ---------------------------------------------------------------------


def test_without_tensorflow_every_entry_raises_naming_it(flagship, tmp_path, monkeypatch):
    """Every port module imports with tensorflow blocked:
    ``test_torch_isolation.py`` imports them all so in a fresh interpreter."""
    from mga_yolo_tpu_torch.cli import ckpt as cli_ckpt
    from mga_yolo_tpu_torch.cli import predict as cli_predict
    from mga_yolo_tpu_torch.cli import val as cli_val
    from mga_yolo_tpu_torch.export import tflite as T
    from mga_yolo_tpu_torch.train.predictor import TFLitePredictor, load_predictor

    root = flagship["root"]
    pt, tfl, sm = str(root / "best.pt"), str(root / "mini_fp32.tflite"), str(root / "sm")
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # `import tensorflow` now raises
    calls = {
        "export-tflite": lambda: cli_ckpt.main(["export-tflite", pt, "--out", str(tmp_path / "a.tflite")]),
        "export-savedmodel": lambda: cli_ckpt.main(["export-savedmodel", pt, str(tmp_path / "b")]),
        "export_tflite": lambda: T.export_tflite(pt, tmp_path / "c.tflite"),
        "export_saved_model": lambda: T.export_saved_model(pt, tmp_path / "d"),
        "TFLitePredictor": lambda: TFLitePredictor(tfl, device="cpu"),
        "load_predictor": lambda: load_predictor(sm, device="cpu"),
        "mga-val": lambda: cli_val.main(["--weights", tfl, "--data", "x.yaml", "--device", "cpu"]),
        "mga-val saved": lambda: cli_val.main(["--weights", sm, "--data", "x.yaml", "--device", "cpu"]),
        "mga-predict": lambda: cli_predict.main(["--weights", tfl, "--source", str(root), "--out",
                                                 str(tmp_path / "p"), "--device", "cpu"]),
    }
    for what, call in calls.items():
        with pytest.raises(ImportError, match="needs tensorflow") as e:
            call()
        assert "tensorflow" in str(e.value), what
    assert not list(tmp_path.iterdir())


def test_unknown_quantize_mode_and_calibration_sources_raise(flagship, tmp_path):
    from mga_yolo_tpu_torch.export.tflite import _representative_gen, export_tflite
    from mga_yolo_tpu_torch.data import image_io

    with pytest.raises(ValueError, match="unknown quantize mode 'int4'"):
        export_tflite(flagship["root"] / "best.pt", tmp_path / "q.tflite", quantize="int4")
    with pytest.raises(ValueError, match="not found"):
        _representative_gen(tmp_path / "nope", 1, 64)
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no images"):
        _representative_gen(tmp_path / "empty", 1, 64)
    (first,) = next(_representative_gen(None, 2, 64)())  # noise batches
    assert first.shape == (2, 64, 64, 3) and first.dtype == np.float32
    img = np.random.default_rng(0).integers(0, 256, (48, 80, 3)).astype(np.uint8)
    image_io.imwrite(tmp_path / "a.png", img)
    batches = [b for (b,) in _representative_gen([tmp_path / "a.png"] * 3, 2, 64)()]
    assert [b.shape for b in batches] == [(2, 64, 64, 3)] * 2  # the tail padded
    np.testing.assert_array_equal(batches[1][0], batches[1][1])
    (tmp_path / "b.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(16))  # a JPEG signature, then garbage
    with pytest.raises(ValueError, match=r"b\.jpg: truncated JPEG"):
        next(_representative_gen(tmp_path / "b.jpg", 1, 64)())
