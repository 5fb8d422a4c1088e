"""The device an entry point of the port runs on: the card, unless the caller
asks for the CPU. There is no silent fallback: asking for CUDA where no CUDA
device is present raises.

Also the card's peak rates, which the kernels' bounds are computed from
(NVIDIA H100 SXM data sheet): the memory rate, and the arithmetic rate per
dtype outside the tensor cores."""

from __future__ import annotations

import numpy as np
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


def float_dtype(dtype) -> torch.dtype:
    """torch.float32 or torch.float64 for `dtype` in any of tpufem's
    spellings: a torch dtype, or anything numpy reads as float32 / float64
    (np.float64, "float64", tpufem's jnp.float64). Raises ValueError on any
    other dtype."""
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        try:
            out = {np.dtype(np.float32): torch.float32,
                   np.dtype(np.float64): torch.float64}.get(np.dtype(dtype))
        except TypeError:
            out = None
    if out not in (torch.float32, torch.float64):
        raise ValueError(f"dtype {dtype!r}: float32 or float64 only")
    return out
