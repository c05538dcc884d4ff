"""Build the CUDA sources of ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

into ``mga_yolo_tpu_torch/_build/``, keyed by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads at once. The
compiler's report (registers, shared memory, spills) is kept beside the
library as ``<name>-<hash>.log``. Nothing is built at import time: the first
wrapper call that needs a library builds it, or :func:`build` builds several
at once, one ``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str] | tuple[str, ...]) -> dict[str, float]:
    """Compile every listed source whose library is missing, in parallel.

    Returns the wall seconds each compile took (0.0 for a library that was
    already built). Raises with the compiler's output if one fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, target, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        target.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
