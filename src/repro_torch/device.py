"""Where the port runs: a CUDA device unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (the port
    never moves to the CPU unless the caller asks for it)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device: {device}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch finds no CUDA device; pass "
            "device='cpu' to run the port on the CPU")
    return dev
