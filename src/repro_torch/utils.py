"""Shared small utilities: padding arithmetic, byte formatting, logging."""
from __future__ import annotations

import logging

logger = logging.getLogger("repro_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[repro_torch %(levelname)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def round_up(x: int, multiple: int) -> int:
    """Smallest multiple of `multiple` that is >= x."""
    return ((x + multiple - 1) // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    return (a + b - 1) // b


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB", "PiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} EiB"


def resolve_device(device):
    """`torch.device` for an entry point's `device` argument. Asking for
    "cuda" on a machine without one raises: an entry point never carries on
    on the CPU by itself."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' explicitly to run on the CPU")
    return dev
