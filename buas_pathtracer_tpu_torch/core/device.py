"""Device resolution shared by every entry point.

``None`` means the CUDA card.  There is no silent CPU fallback: a caller
that wants the CPU (the tests, debugging) passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev


def check_on(dev: torch.device, t: torch.Tensor, what: str) -> None:
    if t.device.type != dev.type:
        raise ValueError(f"{what} lives on {t.device}, expected {dev}")
