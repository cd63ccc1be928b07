"""Unit-circle root search on a chirp-Z grid.

Port of ``fnft_tpu/ops/gridsearch.py`` (reference
fnft__poly_roots_fftgridsearch.c). Both variants evaluate the polynomial
along arcs of (near-)unit circles with :func:`poly.chirpz` and locate roots
by purely local, elementwise tests:

* :func:`roots_fftgridsearch` — minimum-modulus test on a 3x3 moving grid
  over three concentric rings, then a local linear least-squares root
  estimate (reference :35-154).
* :func:`roots_fftgridsearch_paraherm` — for polynomials where
  p(z) z^-(deg/2) is real on the circle: sign changes between consecutive
  grid points bracket roots (reference :162-219).

Shapes are fixed: the functions return ``(roots, mask)`` of length ``m``
on the device of ``coeffs``; invalid slots are 0 and masked out.
"""

from __future__ import annotations

import cmath

import torch

from fnft_tpu_torch.config import real_dtype_of
from fnft_tpu_torch.ops.poly import chirpz

# the eight neighbours of a grid point: (ring, shift along the arc)
_NEIGHBOURS = tuple((ring, s) for ring in range(3) for s in (-1, 0, 1)
                    if (ring, s) != (1, 0))


def _shift(x: torch.Tensor, s: int) -> torch.Tensor:
    """x[..., (j + s) mod m] at position j."""
    return torch.roll(x, -s, dims=-1)


def roots_fftgridsearch(coeffs: torch.Tensor, *, phi0: float, phi1: float,
                        m: int):
    """Roots near the unit-circle arc exp(i [phi0, phi1]).

    Returns (roots[m], mask[m]); masked-out entries are 0.
    """
    eps = (phi1 - phi0) / (m - 1)
    w = cmath.exp(1j * eps)
    vals = torch.stack([chirpz(coeffs, cmath.exp(1j * phi0) / (1.0 + k * eps),
                               w, m)
                        for k in (-1, 0, 1)])   # [3, m]: radii 1/(1+k eps)
    mag = torch.abs(vals)

    # 3x3 minimum-modulus test centered on the middle ring
    center = mag[1]
    is_min = torch.ones(m, dtype=torch.bool, device=vals.device)
    for ring, s in _NEIGHBOURS:
        is_min &= center <= _shift(mag[ring], s)
    is_min[0] = False
    is_min[-1] = False

    # local linear LSQ fit p(z) ~ y0 + c (z - z0) over the 3x3 neighbourhood
    rdt = real_dtype_of(vals.dtype)
    angles = phi0 + eps * torch.arange(m, dtype=rdt, device=vals.device)
    radii = torch.tensor([1.0 / (1.0 - eps), 1.0, 1.0 / (1.0 + eps)],
                         dtype=rdt, device=vals.device)
    z0 = torch.exp(1j * angles)
    zgrid = radii[:, None] * z0[None, :]
    y0 = vals[1]
    num = torch.zeros_like(y0)
    den = torch.zeros_like(center)
    for ring, s in _NEIGHBOURS:
        dz = _shift(zgrid[ring], s) - z0
        num = num + torch.conj(dz) * (_shift(vals[ring], s) - y0)
        den = den + torch.abs(dz) ** 2
    c = num / torch.where(den == 0, 1.0, den)
    c_zero = c == 0
    zr = torch.where(c_zero, z0, z0 - y0 / torch.where(c_zero, 1.0, c))
    ok_dist = torch.where(c_zero, y0 == 0, torch.abs(zr - z0) <= eps)
    mask = is_min & ok_dist
    return torch.where(mask, zr, 0.0), mask


def roots_fftgridsearch_paraherm(coeffs: torch.Tensor, *, phi0: float,
                                 phi1: float, m: int):
    """Unit-circle roots of a para-hermitian polynomial (even degree).

    After removing the phase factor z^{deg/2}, the values are real on the
    circle; sign changes between neighbours bracket roots, refined by linear
    interpolation. Returns (roots[m], mask[m]).
    """
    deg = coeffs.shape[-1] - 1
    eps = (phi1 - phi0) / (m - 1)
    vals = chirpz(coeffs, cmath.exp(1j * phi0), cmath.exp(1j * eps), m)
    rdt = real_dtype_of(vals.dtype)
    angles = phi0 + eps * torch.arange(m, dtype=rdt, device=vals.device)
    v = torch.real(vals * torch.exp(-1j * angles * (deg // 2)))
    v_prev, v_next = v[:-1], v[1:]
    denom = v_next - v_prev
    frac = torch.where(denom == 0, 0.5,
                       -v_prev / torch.where(denom == 0, 1.0, denom))
    mask = v_prev * v_next <= 0.0
    out = torch.where(mask, torch.exp(1j * (angles[:-1] + eps * frac)), 0.0)
    # pad to m entries for a fixed shape
    return (torch.cat([out, torch.zeros_like(out[:1])]),
            torch.cat([mask, torch.zeros_like(mask[:1])]))
