"""Numeric helpers: the subset of ``fnft_tpu/utils/misc.py`` that the nsev
path uses (reference: fnft__misc.c).

Filtering and merging return boolean masks over fixed-size tensors; the
transforms compact once at the API boundary, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from fnft_tpu_torch.config import eps_of


def l2norm2(vals: torch.Tensor, t0: float, t1: float) -> torch.Tensor:
    """Trapezoid-weighted squared L2 norm of a sampled signal."""
    n = vals.shape[-1]
    h = (t1 - t0) / n
    mag2 = torch.abs(vals) ** 2
    w = torch.ones(n, dtype=mag2.dtype, device=vals.device)
    w[0] = 0.5
    w[-1] = 0.5
    return h * torch.sum(w * mag2, dim=-1)


def csinc(x: torch.Tensor) -> torch.Tensor:
    """sinc(x) = sin(x)/x with a series-stable branch near 0 (complex-safe)."""
    small = torch.abs(x) < 1e-8
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, torch.cos(x / math.sqrt(3.0)),
                       torch.sin(safe) / safe)


def next_power_of_2(n: int) -> int:
    if n <= 0:
        return 0
    return 1 << (int(n) - 1).bit_length()


def next_fft_length(n: int) -> int:
    """Smallest 2^a 3^b 5^c >= n (kiss_fft_next_fast_size semantics).

    pocketfft on the CPU and cuFFT on the GPU both run mixed-radix 2/3/5
    sizes efficiently, so one rule serves every device (and matches the
    JAX package's CPU choice, which the parity tests compare against).
    """
    n = int(n)
    if n <= 1:
        return 1
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def filter_mask(vals: torch.Tensor, bounding_box) -> torch.Tensor:
    """Mask of values inside [re0, re1] x [im0, im1]; NaNs excluded."""
    re, im = vals.real, vals.imag
    re0, re1, im0, im1 = bounding_box
    return (re >= re0) & (re <= re1) & (im >= im0) & (im <= im1)


def merge_mask(vals: torch.Tensor, tol: float, mask=None) -> torch.Tensor:
    """Keep the first of every cluster of points closer than ``tol``.

    Point i survives if no valid earlier point j lies within tol. Above
    2048 points the distance matrix is built 1024 columns at a time so the
    transient buffer stays bounded.
    """
    k = vals.shape[-1]
    dev = vals.device
    if mask is None:
        mask = torch.ones(k, dtype=torch.bool, device=dev)
    idx = torch.arange(k, dtype=torch.int64, device=dev)
    close_to_earlier = torch.zeros(k, dtype=torch.bool, device=dev)
    chunk = k if k <= 2048 else 1024
    for c0 in range(0, k, chunk):
        vc = vals[c0:c0 + chunk]
        close = ((torch.abs(vals[:, None] - vc[None, :]) < tol)
                 & mask[None, c0:c0 + chunk]
                 & (idx[None, c0:c0 + chunk] < idx[:, None]))
        close_to_earlier |= torch.any(close, dim=1)
    return mask & ~close_to_earlier


def compact_masked(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Compaction of (values, mask) into a short tensor (one host sync)."""
    return vals[mask]


def downsample_indices(d: int, dsub_desired: int) -> tuple[int, int]:
    """(actual Dsub, skip) for decimation, reference misc.c:275-282."""
    dsub = min(max(int(dsub_desired), 2), d)
    nskip = int(round(d / dsub))
    dsub = int(round(d / nskip))
    return dsub, nskip


def merge_tol_default(dtype) -> float:
    """sqrt(machine eps), the reference's bound-state merge tolerance."""
    return math.sqrt(eps_of(dtype))
