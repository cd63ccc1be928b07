"""Numeric helpers: the port of ``fnft_tpu/utils/misc.py`` (reference:
fnft__misc.c).

Filtering and merging return boolean masks over fixed-size tensors; the
transforms compact once at the API boundary, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fnft_tpu_torch.config import complex_dtype_of, eps_of, real_dtype_of


def rel_err(numer: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
    """Sum-of-abs relative error between two complex vectors."""
    numer, exact = numer.reshape(-1), exact.reshape(-1)
    return torch.sum(torch.abs(numer - exact)) / torch.sum(torch.abs(exact))


def hausdorff_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric Hausdorff distance between two point sets in C."""
    d = torch.abs(a.reshape(-1)[:, None] - b.reshape(-1)[None, :])
    return torch.maximum(d.amin(dim=1).max(), d.amin(dim=0).max())


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
    """Mask of values inside [re0, re1] x [im0, im1]; NaNs excluded. The
    bounds are numbers or tensors that broadcast against ``vals`` (one box
    a row of a batch: ``[B, 1]``)."""
    re, im = vals.real, vals.imag
    re0, re1, im0, im1 = bounding_box
    return (re >= re0) & (re <= re1) & (im >= im0) & (im <= im1)


def merge_mask(vals: torch.Tensor, tol: float, mask=None) -> torch.Tensor:
    """Keep the first of every cluster of points closer than ``tol``, in
    each row of ``vals [..., k]``.

    Point i survives if no valid earlier point j of its row lies within
    tol. Above 2048 points the distance matrix is built 1024 columns at a
    time so the transient buffer stays bounded.
    """
    k = vals.shape[-1]
    dev = vals.device
    if mask is None:
        mask = torch.ones(vals.shape, dtype=torch.bool, device=dev)
    idx = torch.arange(k, dtype=torch.int64, device=dev)
    close_to_earlier = torch.zeros(vals.shape, dtype=torch.bool, device=dev)
    chunk = k if k <= 2048 else 1024
    for c0 in range(0, k, chunk):
        vc = vals[..., c0:c0 + chunk]
        close = ((torch.abs(vals[..., :, None] - vc[..., None, :]) < tol)
                 & mask[..., None, c0:c0 + chunk]
                 & (idx[None, c0:c0 + chunk] < idx[:, None]))
        close_to_earlier |= torch.any(close, dim=-1)
    return mask & ~close_to_earlier


def merge_points_host(vals, tol: float) -> np.ndarray:
    """Host-side dedupe of complex points within ``tol`` (keep-first).

    Sorted sliding window in the real part: O(k log k + k w) instead of a
    k x k distance matrix.
    """
    vals = np.asarray(vals)
    k = vals.shape[0]
    if k <= 1:
        return vals
    order = np.argsort(vals.real, kind="stable")
    svals = vals[order]
    keep_sorted = np.ones(k, dtype=bool)
    start = 0
    for i in range(1, k):
        while svals[i].real - svals[start].real > tol:
            start += 1
        window = svals[start:i][keep_sorted[start:i]]
        if window.size and np.min(np.abs(window - svals[i])) < tol:
            keep_sorted[i] = False
    keep = np.zeros(k, dtype=bool)
    keep[order] = keep_sorted
    return vals[keep]


def compact_masked(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Compaction of (values, mask) into a short tensor (one host sync)."""
    return vals[mask]


def resample(q: torch.Tensor, eps_t: float, delta) -> torch.Tensor:
    """Band-limited fractional-delay resampling: q(t) -> q(t + delta).

    FFT phase shift on the periodic continuation of the signal. ``delta``
    may be a scalar or a sequence (a stack ``[..., len(delta), D]`` of
    shifted copies is returned).
    """
    cdt = complex_dtype_of(q)
    rdt = real_dtype_of(cdt)
    q = q.to(cdt)
    d = q.shape[-1]
    spec = torch.fft.fft(q, dim=-1)
    freq = torch.fft.fftfreq(d, d=eps_t, dtype=rdt, device=q.device)
    delta_arr = torch.as_tensor(np.atleast_1d(np.asarray(delta, np.float64)),
                                device=q.device).to(rdt)
    ang = (2.0 * math.pi) * delta_arr[:, None] * freq[None, :]
    phase = torch.complex(torch.cos(ang), torch.sin(ang))
    out = torch.fft.ifft(spec[..., None, :] * phase, dim=-1)
    return out[..., 0, :] if np.ndim(delta) == 0 else out


def bandlimit_violation(q: torch.Tensor, eps_t: float) -> torch.Tensor:
    """Square root of the share of spectral energy in the top 10% band
    (the reference warns above sqrt(machine eps); misc.c:370-380), for
    each signal of ``q [..., D]``."""
    d = q.shape[-1]
    spec = torch.fft.fft(q, dim=-1)
    dlp = d // 20
    if dlp == 0:   # fewer than 20 samples: no band to inspect
        return torch.zeros(q.shape[:-1], dtype=real_dtype_of(q.dtype),
                           device=q.device)
    hi = torch.cat([spec[..., d // 2 - 1 - dlp: d // 2 - 1],
                    spec[..., d // 2 + 1: d // 2 + 1 + dlp]], dim=-1)
    # the same trapezoid step eps_t for both norms
    num = l2norm2(hi, 0.0, hi.shape[-1] * eps_t)
    den = l2norm2(spec, 0.0, d * eps_t)
    return torch.sqrt(num / den)


def downsample_indices(d: int, dsub_desired: int) -> tuple[int, int]:
    """(actual Dsub, skip) for decimation, reference misc.c:275-282."""
    dsub = min(max(int(dsub_desired), 2), d)
    nskip = int(round(d / dsub))
    dsub = int(round(d / nskip))
    return dsub, nskip


def merge_tol_default(dtype) -> float:
    """sqrt(machine eps), the reference's bound-state merge tolerance."""
    return math.sqrt(eps_of(dtype))
