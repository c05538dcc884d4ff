"""Device selection: CUDA unless the caller asks for something else."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return ``device`` as a ``torch.device``; ``None`` (or ``""``) means CUDA.

    The port runs on ``cuda``, ``cuda:N`` or ``cpu``; any other value, or a
    card index that is not there, is a ``ValueError``. Raises a
    ``RuntimeError`` when CUDA is requested (explicitly or by default) and
    absent: the port never moves to the CPU on its own. Pass ``device="cpu"``
    to run the plain PyTorch versions of the kernels on the CPU.
    """
    name = "cuda" if device is None or device == "" else str(device)
    plat, _, idx = name.partition(":")
    if plat not in ("cpu", "cuda") or (idx and not idx.isdigit()):
        raise ValueError(f"device={device!r} not available: the port runs on 'cuda', 'cuda:N' or 'cpu'")
    if plat == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run the port on the CPU")
        if int(idx or 0) >= torch.cuda.device_count():
            raise ValueError(f"device={device!r} not available: {torch.cuda.device_count()} CUDA device(s)")
    return torch.device(name)
