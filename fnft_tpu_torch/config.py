"""Precision policy of the PyTorch port.

The reference library (fnft_numtypes.h:40-62) fixes FNFT_COMPLEX = double
complex. As in ``fnft_tpu/config.py`` the port is dtype polymorphic: every
function takes its working precision from the input's dtype. complex128 is
the default (a real or complex float64 signal, or a numpy array, which
torch reads as float64/complex128); a caller opts into complex64 by casting
``q``. Devices are never guessed either: work runs where the input lies.
"""

from __future__ import annotations

import torch


def default_complex_dtype() -> torch.dtype:
    """complex128: the H100 has native FP64, so no x64 switch is needed."""
    return torch.complex128


def real_dtype_of(cdtype: torch.dtype) -> torch.dtype:
    """Real dtype paired with a complex (or real) dtype."""
    if cdtype in (torch.complex128, torch.float64):
        return torch.float64
    return torch.float32


def complex_dtype_of(x) -> torch.dtype:
    """Working complex dtype of a tensor (or of a dtype)."""
    dt = x if isinstance(x, torch.dtype) else x.dtype
    if dt in (torch.complex128, torch.float64):
        return torch.complex128
    return torch.complex64


def eps_of(dtype: torch.dtype) -> float:
    """Machine epsilon of the real part of ``dtype``."""
    return float(torch.finfo(real_dtype_of(dtype)).eps)
