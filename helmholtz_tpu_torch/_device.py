"""Device resolution shared by the port's entry points.

Every entry point takes `device=` with the default "cuda".  Asking for the
card where there is none raises: the port never carries on on the CPU unless
the caller asked for the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def real_dtype_of(complex_dtype: torch.dtype) -> torch.dtype:
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}[complex_dtype]
