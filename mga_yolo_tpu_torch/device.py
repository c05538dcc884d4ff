"""Device selection: CUDA unless the caller asks for something else."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return ``device`` as a ``torch.device``; ``None`` means CUDA.

    Raises when CUDA is requested (explicitly or by default) and absent: the
    port never moves to the CPU on its own. Pass ``device="cpu"`` to run the
    plain PyTorch versions of the kernels on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev
