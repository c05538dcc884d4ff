"""PyTorch port: it stands alone and never drops to the CPU on its own.

* Importing every module of ``mga_yolo_tpu_torch`` (in a fresh interpreter)
  pulls in neither JAX nor the JAX package.
* No source of the port, nor ``chip_smoke.py``, imports them.
* Entry points given no ``device`` raise when CUDA is absent.
* ``chip_smoke.py`` exits non-zero with no result line without a card, and
  in a directory that holds nothing else of the repository.
"""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "mga_yolo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mga_yolo_tpu")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import mga_yolo_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'mga_yolo_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps({'names': names, 'new': sorted(set(sys.modules) - before)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "mga_yolo_tpu_torch.serve" in res["names"]
    assert "mga_yolo_tpu_torch.ops.cam_gate" in res["names"]
    assert [m for m in res["new"] if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from mga_yolo_tpu_torch.configs import YOLOV8_CBAM
    from mga_yolo_tpu_torch.device import resolve_device
    from mga_yolo_tpu_torch.models.yolo import create_model

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_model(YOLOV8_CBAM, scale="n", nc=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
