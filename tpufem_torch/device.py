"""The device an entry point of the port runs on: the card, unless the caller
asks for the CPU. There is no silent fallback: asking for CUDA where no CUDA
device is present raises.

Also the card's peak rates, which the kernels' bounds are computed from
(NVIDIA H100 SXM data sheet): the memory rate, and the arithmetic rate per
dtype outside the tensor cores."""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}


def resolve_device(device="cuda",
                   hint: str = "pass device='cpu' to run on the CPU") -> torch.device:
    """torch.device(device); raises RuntimeError (with `hint`) if it names CUDA
    and no CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device here; {hint}")
    return dev
