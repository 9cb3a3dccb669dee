"""Device ops of the port: hand-written CUDA kernels for the hot stages,
each with a plain PyTorch version beside it.

There is no global device state: every entry point takes an explicit
``device``. ``resolve_device`` is the one place that turns it into a
``torch.device``; ``"cuda"`` without a usable CUDA device raises instead
of falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev
