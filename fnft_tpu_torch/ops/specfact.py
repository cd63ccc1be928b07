"""Kolmogorov spectral factorization on an oversampled FFT grid.

Port of ``fnft_tpu/ops/specfact.py`` (reference fnft__poly_specfact.c:
26-147). Given B(z), computes A(z) with A A* + kappa B B* = 1
(kappa = +-1) or the minimum-phase factor of |P| (kappa = 0), following
Dumitrescu, "Positive Trigonometric Polynomials and Signal Processing
Applications", App. B.4: log-magnitude on the circle -> Hilbert transform
for the phase -> inverse FFT.
"""

from __future__ import annotations

import math

import torch

from fnft_tpu_torch.config import complex_dtype_of, eps_of, real_dtype_of
from fnft_tpu_torch.errors import warn
from fnft_tpu_torch.utils.misc import next_fft_length


def poly_specfact(coeffs: torch.Tensor, *, oversampling_factor: int = 32,
                  kappa: int = 0) -> torch.Tensor:
    """Spectral factor of a polynomial given by ascending ``coeffs``.

    Returns ascending coefficients of the factor, same length as the input.
    With kappa = +1 the problem is ill-posed where |B| reaches 1 on the
    circle: the reference warns without aborting (fnft__poly_specfact.c:
    96-111), and so does this function, through :func:`errors.warn` after
    one host read, before it clamps the logarithm's argument.
    """
    if kappa not in (-1, 0, 1):
        raise ValueError("kappa must be -1, 0 or +1")
    cdt = complex_dtype_of(coeffs)
    coeffs = coeffs.to(cdt)
    deg = coeffs.shape[-1] - 1
    m = next_fft_length((deg + 1) * oversampling_factor)

    # the factorization operates on the reversed polynomial, matching the
    # reference's descending-order convention (result conj-compensated below)
    abs2 = torch.abs(torch.fft.fft(coeffs.flip(-1), n=m, dim=-1)) ** 2
    tol = math.sqrt(eps_of(cdt))
    if kappa == 0:
        x = torch.log(torch.clamp(torch.sqrt(abs2), min=tol * tol))
    elif kappa == -1:
        x = 0.5 * torch.log1p(abs2)
    else:
        if bool(torch.any(abs2 > 1.0 - tol)):
            warn("Ill-posed spectral factorization problem.")
        x = 0.5 * torch.log(torch.clamp(1.0 - abs2, min=tol * tol))

    # Hilbert transform: multiply FFT(x) by -i sgn(freq)
    sgn = torch.zeros(m, dtype=real_dtype_of(cdt), device=coeffs.device)
    sgn[1: m // 2] = -1.0
    sgn[m // 2 + 1:] = 1.0
    y = torch.fft.ifft(torch.fft.fft(x.to(cdt), dim=-1) * (1j * sgn), dim=-1)
    factor = torch.fft.ifft(torch.exp(x - 1j * y), dim=-1)
    # reference: result_desc[i] = conj(factor[deg-i]) -> ascending = conj
    return torch.conj(factor[..., : deg + 1]).resolve_conj()
