"""Fast AKNS scattering: per-sample polynomial transfer matrices + FFT tree.

Port of ``fnft_tpu/ops/fscatter.py`` (reference fnft__akns_fscatter.c).
SPLIT2_MODAL, SPLIT2A and SPLIT4B have closed forms; every other fast
scheme is generated from its splitting specification
(``models.discretization.splitting_spec``): constant-matrix factors
``E(a)`` and monomial factors ``Z(a) = diag(1, z^a)``, evaluated in value
space on every device (:func:`_coeffs_via_values`), with the
coefficient-space fold (:func:`_coeffs_symbolic`) kept as the independent
version the tests hold it against.
"""

from __future__ import annotations

import math

import torch

from fnft_tpu_torch.config import complex_dtype_of, real_dtype_of
from fnft_tpu_torch.models.discretization import (
    Discretization,
    degree,
    splitting_spec,
)
from fnft_tpu_torch.ops.poly import fmult2x2_tree
from fnft_tpu_torch.utils.misc import csinc, next_power_of_2


def _zero_freq_matrix(q, r, h):
    """E = expm([[0, q], [r, 0]] * h): closed form via cos / sinc.

    Reference: akns_fscatter_zero_freq_scatter_matrix
    (fnft__akns_fscatter.c:46-59). Returns [..., 2, 2].
    """
    delta = h * torch.sqrt(-q * r)
    dsinc = h * csinc(delta)
    c = torch.cos(delta)
    return torch.stack([
        torch.stack([c, q * dsinc], dim=-1),
        torch.stack([r * dsinc, c], dim=-1),
    ], dim=-2)


def _diag_antidiag(d0, a01, a10, d1):
    """Degree-1 matrices ``[[d0, a01 z], [a10, d1 z]]`` as ``[..., 2, 2, 2]``."""
    zero = torch.zeros_like(d0)
    return torch.stack([
        torch.stack([torch.stack([d0, zero], dim=-1),
                     torch.stack([zero, a01], dim=-1)], dim=-2),
        torch.stack([torch.stack([a10, zero], dim=-1),
                     torch.stack([zero, d1], dim=-1)], dim=-2),
    ], dim=-3)


def transfer_matrix_coeffs(q: torch.Tensor, r: torch.Tensor, eps_t: float,
                           disc: Discretization, *,
                           rsym: bool = False) -> torch.Tensor:
    """Per-sample polynomial transfer matrices ``[..., D, 2, 2, deg+1]``.

    ``q`` and ``r`` are the (preprocessed) AKNS potentials on the effective
    sample grid; ``eps_t`` is the step of the *original* grid (the splitting
    uses eps_t/deg internally, matching the reference's conventions).
    ``rsym`` asserts real-valued q and r (KdV), letting the generic path
    evaluate only the Hermitian half grid.
    """
    cdt = complex_dtype_of(q)
    q = q.to(cdt)
    r = r.to(cdt)
    if degree(disc) == 0:
        raise ValueError(f"{disc} is not a fast (polynomial) discretization")

    if disc is Discretization.SPLIT2_MODAL:
        # Modified Ablowitz-Ladik: P = s [[1, eps q], [eps r, 1]] diag(1, z),
        # s = 1/sqrt(1 - eps^2 q r)   (fnft__akns_fscatter.c:118-147)
        scl = 1.0 / torch.sqrt(1.0 - (eps_t * eps_t) * q * r)
        return _diag_antidiag(scl, scl * eps_t * q, scl * eps_t * r, scl)

    if disc is Discretization.SPLIT2A:
        # P = E(1) Z (deg = 1)
        delta = eps_t * torch.sqrt(-q * r)
        c = torch.cos(delta)
        s = eps_t * csinc(delta)
        return _diag_antidiag(c, q * s, r * s, c)

    if disc is not Discretization.SPLIT4B:
        return _coeffs_via_values(q, r, eps_t, disc, real_coeffs=rsym)
    # Closed form of -1/3 E(1) Z^2 E(1) + 4/3 E(1/2) Z E(1) Z E(1/2)
    # (deg = 2, E(a) = expm([[0,q],[r,0]] a eps_t/2)); P11 is the
    # coefficient-reverse of P00 and P01/q == P10/r (fnft_tpu fscatter.py:99)
    qr = q * r
    d1 = (eps_t / 2) * torch.sqrt(-qr)
    c1 = torch.cos(d1)
    s1 = (eps_t / 2) * csinc(d1)
    dh = d1 / 2
    ch = torch.cos(dh)
    sh = (eps_t / 4) * csinc(dh)
    third = 1.0 / 3.0
    u0 = (4.0 * third) * ch * ch * c1 - third * c1 * c1
    u1 = (8.0 * third) * qr * ch * sh * s1
    u2 = (4.0 * third) * qr * sh * sh * c1 - third * qr * s1 * s1
    g0 = (4.0 * third) * ch * sh * c1 - third * c1 * s1
    g1 = (4.0 * third) * (qr * sh * sh * s1 + ch * ch * s1)
    g = torch.stack([g0, g1, g0], dim=-1)
    p00 = torch.stack([u0, u1, u2], dim=-1)
    p11 = torch.stack([u2, u1, u0], dim=-1)
    return torch.stack([
        torch.stack([p00, q[..., None] * g], dim=-2),
        torch.stack([r[..., None] * g, p11], dim=-2),
    ], dim=-3)


def _coeffs_via_values(q, r, eps_t: float, disc: Discretization, *,
                       real_coeffs: bool = False):
    """Generic splitting-spec transfer matrices, built in value space.

    Every term of the splitting specification is a product of constant
    matrices ``E(a)`` (shared across evaluation points) and monomial
    factors ``Z(a) = diag(1, z^a)`` (per-point scalings of the second
    column), so the per-sample degree-``deg`` polynomial matrix is built by
    evaluating the whole chain at the n-th roots of unity
    (n = next power of two >= deg+1), a sequence of elementwise 2x2
    products, and recovering the exact coefficients with one small inverse
    FFT. The reference instead hard-codes per-scheme coefficient formulas
    (fnft__akns_fscatter.c:64-925).

    With ``real_coeffs`` (KdV: real q and r = -1 make every coefficient
    real) only the Hermitian half grid k = 0..n/2 is evaluated and an
    irfft recovers the coefficients.
    """
    cdt = complex_dtype_of(q)
    rdt = real_dtype_of(cdt)
    deg = degree(disc)
    spec = splitting_spec(disc)
    n = next_power_of_2(deg + 1)
    npts = n // 2 + 1 if real_coeffs else n
    h = eps_t / deg
    delta = h * torch.sqrt(-q * r)
    emat = {}
    for a in sorted({a for _, fs in spec for kind, a in fs if kind == "E"}):
        da = a * delta
        s = (a * h) * csinc(da)
        emat[a] = (torch.cos(da)[..., None], (q * s)[..., None],
                   (r * s)[..., None])

    zpow_cache: dict[int, torch.Tensor] = {}

    def _zp(ai: int):
        # z_k^ai with z_k = w_n^k, w_n = exp(-2i pi / n) (FFT grid order)
        if ai not in zpow_cache:
            ang = torch.arange(npts, dtype=rdt, device=q.device) * (
                -2.0 * math.pi * ai / n)
            zpow_cache[ai] = torch.complex(torch.cos(ang), torch.sin(ang))
        return zpow_cache[ai]

    tot = None
    for coeff, factors in spec:
        m = None       # running product (m00, m01, m10, m11), right-mult
        pend = 0       # z power accumulated before the first E factor
        for kind, a in factors:
            if kind == "Z":
                ai = int(round(a))
                if m is None:
                    pend += ai
                else:
                    zp = _zp(ai)
                    m = (m[0], m[1] * zp, m[2], m[3] * zp)
            else:
                c, qs, rs = emat[a]
                if m is None:
                    if pend:
                        zp = _zp(pend)
                        m = (c, qs, zp * rs, zp * c)
                        pend = 0
                    else:
                        m = (c, qs, rs, c)
                else:
                    m00, m01, m10, m11 = m
                    m = (m00 * c + m01 * rs, m00 * qs + m01 * c,
                         m10 * c + m11 * rs, m10 * qs + m11 * c)
        tgt = q.shape + (npts,)
        e00, e01, e10, e11 = (x.expand(tgt) for x in m)
        term = torch.stack([torch.stack([e00, e01], dim=-2),
                            torch.stack([e10, e11], dim=-2)], dim=-3)
        tot = coeff * term if tot is None else tot + coeff * term

    if real_coeffs:
        return torch.fft.irfft(tot, n=n, dim=-1)[..., : deg + 1].to(cdt)
    return torch.fft.ifft(tot, dim=-1)[..., : deg + 1]


def _coeffs_symbolic(q, r, eps_t: float, disc: Discretization):
    """Symbolic (coefficient-space) splitting-spec fold: E factors contract
    on the matrix axes, Z factors shift coefficients. The independent
    version :func:`_coeffs_via_values` is tested against."""
    cdt = complex_dtype_of(q)
    q, r = q.to(cdt), r.to(cdt)
    deg = degree(disc)
    spec = splitting_spec(disc)
    e_mats = {a: _zero_freq_matrix(q, r, a * eps_t / deg)
              for a in {a for _, fs in spec for kind, a in fs if kind == "E"}}

    def zeros(*tail):
        return torch.zeros(q.shape + tail, dtype=cdt, device=q.device)

    total = zeros(2, 2, deg + 1)
    for coeff, factors in spec:
        p = None  # running product, [..., 2, 2, c]
        for kind, a in factors:
            if kind == "E":
                e = e_mats[a]
                if p is None:
                    p = e[..., None]
                else:   # p @ e on the matrix axes, coefficientwise
                    p = (p[..., :, :, None, :]
                         * e[..., None, :, :, None]).sum(dim=-3)
            else:  # Z(a): right-multiplication scales column 2 by z^a
                ai = int(round(a))
                if p is None:
                    p = zeros(2, 2, ai + 1)
                    p[..., 0, 0, 0] = 1.0
                    p[..., 1, 1, ai] = 1.0
                elif ai:
                    c = p.shape[-1]
                    grown = zeros(2, 2, c + ai)
                    grown[..., :, 0, :c] = p[..., :, 0, :]
                    grown[..., :, 1, ai:] = p[..., :, 1, :]
                    p = grown
        c = min(p.shape[-1], deg + 1)
        total[..., :c] += coeff * p[..., :c]
    return total


def fscatter(q: torch.Tensor, r: torch.Tensor, eps_t: float,
             disc: Discretization, *, normalize: bool = True, want=None,
             jsym: int | None = None, rsym: bool = False):
    """Combined polynomial scattering matrix of D samples.

    Returns (transfer_matrix ``[..., 2, 2, D*deg+1]``, w) with
    ``true = stored * 2**w``; see :func:`fmult2x2_tree` for ``want``,
    ``jsym`` and ``rsym`` (pass True when ``q`` and ``r`` are both
    real-valued, as for KdV).
    """
    p = transfer_matrix_coeffs(q, r, eps_t, disc, rsym=rsym)
    return fmult2x2_tree(p, normalize=normalize, want=want, jsym=jsym,
                         rsym=rsym)
