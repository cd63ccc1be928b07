"""Inverse NFT for the vanishing-BC NSE.

Port of ``fnft_tpu/models/nsev_inverse.py`` (reference
fnft_nsev_inverse.c:121-1033). Pipeline:

  1. Build a transfer-matrix polynomial from the continuous spectrum:
     * REFLECTION_COEFFICIENT (default): B(z) from an M-point FFT of the
       boundary-compensated spectrum, A(z) = 1 (Skaar et al. 2001);
       or the defocusing-only iterative method (Algorithm 1 of
       arXiv:1607.01305v2) that alternates B <- FFT(rho/sqrt(1+kappa|rho|^2))
       with A <- specfact(B) phase updates (its convergence test reads the
       host once an iteration, as the reference's loop does).
     * B_OF_XI: B(z) from the FFT, A(z) by spectral factorization.
     * B_OF_TAU: b-coefficients are trapezoid-weighted samples of B(tau),
       A(z) by spectral factorization (ECOC 2017 approach).
  2. Fast inverse scattering (``ops/finvscatter.py``) recovers q.
  3. Bound states are added by a classical Darboux transform; with a seed
     potential the CDT uses phi/psi eigenfunctions (prefix products of the
     BO step matrices, ``scatter._prefix_product``), without one a
     closed-form recursive multi-soliton formula, both vectorized over the
     time axis with the (small) K loop unrolled in Python.

Internally the reference's descending-coefficient formulas are kept and
flipped once to the ascending convention. Everything runs on the device
of the first tensor among the contspec, the seed and the bound states;
arrays go to the CUDA device unless ``device=`` says otherwise.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np
import torch

from fnft_tpu_torch.config import complex_dtype_of, eps_of, real_dtype_of
from fnft_tpu_torch.errors import check_arg, warn
from fnft_tpu_torch.models import nse
from fnft_tpu_torch.models.discretization import (
    Discretization,
    degree,
    degree1step_total,
)
from fnft_tpu_torch.models.nsev import _array_device
from fnft_tpu_torch.ops.finvscatter import finvscatter
from fnft_tpu_torch.ops.scatter import (_mm2, _mv2, _prefix_product,
                                        scatter_bound_states)
from fnft_tpu_torch.ops.specfact import poly_specfact


class InverseContspecType(enum.Enum):   # fnft_nsev_inverse.h:58-62
    REFLECTION_COEFFICIENT = "reflection_coefficient"
    B_OF_XI = "b_of_xi"
    B_OF_TAU = "b_of_tau"


class InverseCstMethod(enum.Enum):      # fnft_nsev_inverse.h:108-113
    DEFAULT = "default"
    TFMATRIX_CONTAINS_REFL_COEFF = "tf_refl"
    TFMATRIX_CONTAINS_AB_FROM_ITER = "tf_ab_iter"
    USE_SEED_POTENTIAL_INSTEAD = "seed_potential"


class InverseDiscspecType(enum.Enum):
    NORMING_CONSTANTS = "norming_constants"
    RESIDUES = "residues"


@dataclasses.dataclass(frozen=True)
class NsevInverseOpts:
    """Defaults mirror fnft_nsev_inverse_default_opts (:26-33)."""

    discretization: Discretization = Discretization.SPLIT2A
    contspec_type: InverseContspecType = InverseContspecType.REFLECTION_COEFFICIENT
    contspec_method: InverseCstMethod = InverseCstMethod.DEFAULT
    discspec_type: InverseDiscspecType = InverseDiscspecType.NORMING_CONSTANTS
    max_iter: int = 100
    oversampling_factor: int = 8


def nsev_inverse_xi_grid(d: int, t_span, m: int,
                         disc: Discretization = Discretization.SPLIT2A):
    """Canonical xi grid matching the M-point FFT (fnft_nsev_inverse_XI,
    :40-65): XI = [(-pi + 2pi/M), pi] * deg1 / (2 eps_t)."""
    t0, t1 = float(t_span[0]), float(t_span[1])
    scale = degree1step_total(disc) / (2.0 * (t1 - t0) / (d - 1))
    return ((-math.pi + 2.0 * math.pi / m) * scale, math.pi * scale)


def _xi_grid(xi_span, m: int, like: torch.Tensor) -> torch.Tensor:
    xi0, xi1 = float(xi_span[0]), float(xi_span[1])
    return xi0 + (xi1 - xi0) / (m - 1) * torch.arange(
        m, dtype=real_dtype_of(like.dtype), device=like.device)


def _reorder(cs: torch.Tensor, m: int) -> torch.Tensor:
    """FFT ordering of the xi grid (reference :251-296), along the last
    axis."""
    return torch.cat([cs[..., m // 2 - 1:], cs[..., : m // 2 - 1]], dim=-1)


def _remove_bc(contspec, xi_span, m, eps_t, t0, t1, d, ctype, disc):
    """Strip boundary phase factors (reference :251-296) from ``contspec
    [..., M]``."""
    if ctype is InverseContspecType.REFLECTION_COEFFICIENT:
        pf = nse.phase_factor_rho(eps_t, t1, disc)
    else:
        pf = nse.phase_factor_b(eps_t, d, t0, t1, disc)
    return contspec * torch.exp(-1j * _xi_grid(xi_span, m, contspec) * pf)


def _stack_desc(tm11_d, tm12_d, tm21_d, tm22_d) -> torch.Tensor:
    """[..., 2, 2, deg+1] ascending from the four descending entries
    ``[..., deg+1]`` (broadcast against each other)."""
    e = torch.broadcast_tensors(tm11_d, tm12_d, tm21_d, tm22_d)
    return torch.stack([torch.stack(e[:2], dim=-2),
                        torch.stack(e[2:], dim=-2)], dim=-3).flip(-1)


def _tm_from_b_fft(b_fft, m, deg, kappa, cdt):
    """Descending-order B blocks ``[..., deg+1]`` from FFT coefficients
    ``[..., m]`` (reference :344-358)."""
    i0 = 0 if deg <= m - 1 else deg - (m - 1)
    idx = np.arange(deg + 1)
    dev = b_fft.device
    valid = torch.as_tensor(idx >= i0, device=dev)
    take21 = b_fft[..., torch.as_tensor((deg - idx) % m, device=dev)]
    take12 = b_fft[..., torch.as_tensor((m - 1 - deg + idx) % m, device=dev)]
    tm21_d = torch.where(valid, take21, 0.0) / m
    tm12_d = torch.where(valid, -kappa * torch.conj(take12) / m, 0.0)
    return tm12_d.to(cdt), tm21_d.to(cdt)


def _a_one(deg, cdt, device):
    """Descending A(z) = 1 and its partner z^deg."""
    tm11_d = torch.zeros(deg + 1, dtype=cdt, device=device)
    tm11_d[deg] = 1.0
    return tm11_d, tm11_d.flip(-1)


def _build_tm_reflection(contspec, xi_span, m, d, t0, t1, deg, kappa, disc,
                         opts):
    """B(z) from the FFT of the reflection coefficient ``[..., M]``, A = 1
    (reference :300-371); returns ``[..., 2, 2, deg+1]``."""
    eps_t = (t1 - t0) / (d - 1)
    cdt = complex_dtype_of(contspec)
    cs = _remove_bc(contspec, xi_span, m, eps_t, t0, t1, d,
                    InverseContspecType.REFLECTION_COEFFICIENT, disc)
    tm12_d, tm21_d = _tm_from_b_fft(torch.fft.fft(_reorder(cs, m)), m, deg,
                                    kappa, cdt)
    tm11_d, tm22_d = _a_one(deg, cdt, contspec.device)
    return _stack_desc(tm11_d, tm12_d, tm21_d, tm22_d)


def _tm_from_ab(a_d, b_d, d, deg, kappa, cdt):
    """Transfer matrix from descending length-D A and B coefficient blocks
    ``[..., D]`` (reference :486-507, :660-678)."""
    idx = torch.arange(d, device=a_d.device)
    z = torch.zeros(*a_d.shape[:-1], deg + 1, dtype=cdt, device=a_d.device)
    tm11_d, tm12_d, tm21_d, tm22_d = z.clone(), z.clone(), z.clone(), z.clone()
    tm11_d[..., 1 + idx] = a_d[..., :d].to(cdt)
    tm12_d[..., idx] = (-kappa * torch.conj(b_d[..., d - 1 - idx])).to(cdt)
    tm21_d[..., 1 + idx] = b_d[..., :d].to(cdt)
    tm22_d[..., idx] = a_d[..., d - 1 - idx].to(cdt)
    return _stack_desc(tm11_d, tm12_d, tm21_d, tm22_d)


def _build_tm_reflection_iter(contspec, xi_span, m, d, t0, t1, deg, kappa,
                              disc, opts):
    """Defocusing-only iterative method (reference :375-507)."""
    check_arg(kappa == -1, "AB_FROM_ITER requires the defocusing case")
    check_arg(m == d and deg == d, "AB_FROM_ITER requires M == D")
    eps_t = (t1 - t0) / (d - 1)
    cdt = complex_dtype_of(contspec)
    reordered = _reorder(_remove_bc(
        contspec, xi_span, m, eps_t, t0, t1, d,
        InverseContspecType.REFLECTION_COEFFICIENT, disc), m)

    eps = eps_of(cdt)
    reordered_cur = reordered
    prev_change = math.inf
    prev_change_diff = math.inf
    a_coeffs = b_coeffs = None
    for _ in range(opts.max_iter):
        x = reordered_cur / torch.sqrt(
            1.0 + kappa * torch.abs(reordered_cur) ** 2) / d
        # reference swaps b[i] <-> b[D-1-i] for i < D/2, i.e. a full reversal
        b_coeffs = torch.fft.fft(x).flip(-1)
        a_coeffs = poly_specfact(b_coeffs.flip(-1), oversampling_factor=32,
                                 kappa=kappa).flip(-1)   # descending
        ph = torch.angle(torch.fft.ifft(a_coeffs.flip(-1)) * d)
        cur_change = float(torch.sum(torch.abs(ph)) / d)
        reordered_cur = reordered * torch.exp(1j * ph)
        change_diff = abs(cur_change - prev_change)
        if change_diff < 10 * eps:
            break
        prev_change = cur_change
        if change_diff > 0.9 * prev_change_diff:
            break
        prev_change_diff = change_diff
    else:
        warn("Maximum iterations reached when constructing transfer matrix.")
    return _tm_from_ab(a_coeffs, b_coeffs, d, deg, kappa, cdt)


def _build_tm_b_of_xi(contspec, xi_span, m, d, t0, t1, deg, kappa, disc,
                      opts):
    """B(z) from FFT of b(xi) ``[..., M]``, A(z) by spectral factorization
    (:560-627)."""
    eps_t = (t1 - t0) / (d - 1)
    cdt = complex_dtype_of(contspec)
    cs = _remove_bc(contspec, xi_span, m, eps_t, t0, t1, d,
                    InverseContspecType.B_OF_XI, disc)
    tm12_d, tm21_d = _tm_from_b_fft(torch.fft.fft(_reorder(cs, m)), m, deg,
                                    kappa, cdt)
    tm11_d = poly_specfact(tm21_d.flip(-1),
                           oversampling_factor=opts.oversampling_factor,
                           kappa=kappa).flip(-1)
    return _stack_desc(tm11_d, tm12_d, tm21_d, tm11_d.flip(-1))


def _build_tm_b_of_tau(contspec, m, d, t0, t1, deg, kappa, disc, opts):
    """b-coefficients directly from B(tau) samples (:632-678)."""
    check_arg(m == d, "B_OF_TAU requires M == D")
    check_arg(abs(t0 + t1) < 1e-12, "B_OF_TAU requires T[0] == -T[1]")
    eps_t = (t1 - t0) / (d - 1)
    cdt = complex_dtype_of(contspec)
    b = 2.0 * eps_t * contspec.to(cdt) / degree(disc)
    b[0] *= 0.5
    b[d - 1] *= 0.5
    a = poly_specfact(b.flip(-1), oversampling_factor=opts.oversampling_factor,
                      kappa=kappa).flip(-1)   # descending, length d
    return _tm_from_ab(a, b, d, deg, kappa, cdt)


def _precompensate_cdt(contspec, xi_span, m, bound_states):
    """Blaschke-factor precompensation (reference :1013-1033)."""
    xi = _xi_grid(xi_span, m, contspec)
    out = contspec
    for bs in bound_states:
        out = out * (xi - complex(bs)) / (xi - complex(bs).conjugate())
    return out


# ---------------------------------------------------------------------------
# Darboux: adding the discrete spectrum
# ---------------------------------------------------------------------------

def _multisoliton(bs, norm_consts, tgrid, zc_point):
    """Closed-form recursive multi-soliton (reference :796-840), vectorized
    over the time axis; the K^2 recursion is unrolled (K is small)."""
    k = bs.shape[0]
    bs_diff = 2j * bs.imag

    def sweep(t_local, consts, conj_result):
        rhok = [consts[i] * torch.exp(2j * bs[i] * t_local) for i in range(k)]
        qt = torch.zeros_like(rhok[0])
        for i in range(k):
            rho = rhok[i]
            rhoc = torch.conj(rho)
            f = bs_diff[i] / (1.0 + torch.abs(rho) ** 2)
            qt = qt + 2j * rhoc * f
            for j in range(i + 1, k):
                rhok[j] = ((bs[j] - bs[i]) * rhok[j] + (rhok[j] - rho) * f) / \
                    (bs[j] - torch.conj(bs[i]) - (1.0 + rhoc * rhok[j]) * f)
        return torch.conj(qt) if conj_result else qt

    q_pos = sweep(tgrid, [norm_consts[i] for i in range(k)], False)
    q_neg = sweep(-tgrid, [1.0 / norm_consts[i] for i in range(k)], True)
    n = torch.arange(tgrid.shape[0], device=tgrid.device)
    return torch.where(n >= zc_point, q_pos, q_neg)


def _half_step_matrix(qn, l, h):
    """BO half-step matrix for the CDT eigenfunctions (reference :934-960);
    ks == 0 degenerates to the identity, matching the C branch."""
    ks = -(torch.abs(qn) ** 2) - l * l
    small = ks == 0
    k = torch.sqrt(torch.where(small, 1.0, ks))
    ch = torch.cosh(k * h)
    sh = torch.sinh(k * h) / k
    u1 = 1j * l * sh
    m = torch.stack([
        torch.stack([ch - u1, qn * sh], dim=-1),
        torch.stack([-torch.conj(qn) * sh, ch + u1], dim=-1),
    ], dim=-2)
    eye = torch.eye(2, dtype=m.dtype, device=m.device).expand(m.shape)
    return torch.where(small[..., None, None], eye, m)


def _compute_eigenfunctions(bs, q, t0, t1):
    """phi/psi trajectories at all samples (reference :908-1006).

    The reference integrates sequentially over the time grid; here the
    per-step BO matrices are built in one batched pass and the D-deep
    matrix recurrence is a log-depth prefix product of 2x2 products —
    prefix products for phi, suffix products of the inverses (the reversed
    prefix of the reversed inverses) for psi.

    Returns (phi, psi), each [D, K, 2].
    """
    d = q.shape[-1]
    l = bs.to(q.dtype)
    h = ((t1 - t0) / (d - 1)) / 2.0

    # step matrices M[n] = U(q[n+1]) U(q[n]), n = 0..D-2: [D-1, K, 2, 2]
    m = _mm2(_half_step_matrix(q[1:, None], l, h),
             _half_step_matrix(q[:-1, None], l, h))

    zeros = torch.zeros_like(l)
    phi0 = torch.stack([torch.exp(-1j * l * t0), zeros], dim=-1)
    # P[n] = M[n] @ ... @ M[0]; phi[n+1] = P[n] @ phi0
    phi = torch.cat([phi0[None], _mv2(_prefix_product(m)[0], phi0)])

    psi_end = torch.stack([zeros, torch.exp(1j * l * t1)], dim=-1)
    # psi[n] = inv(M[n]) @ ... @ inv(M[D-2]) @ psi_end
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    minv = torch.stack([
        torch.stack([m[..., 1, 1], -m[..., 0, 1]], dim=-1),
        torch.stack([-m[..., 1, 0], m[..., 0, 0]], dim=-1),
    ], dim=-2) / det[..., None, None]
    suff = _prefix_product(minv.flip(0))[0].flip(0)
    psi = torch.cat([_mv2(suff, psi_end), psi_end[None]])
    return phi, psi


def _darboux_with_seed(bs, norm_consts, q_seed, t0, t1):
    """CDT on a seed potential (reference :841-891), vectorized over time;
    the K^2 dressing recursion is unrolled."""
    phi, psi = _compute_eigenfunctions(bs, q_seed, t0, t1)
    qn = q_seed
    s1: list = []
    s2: list = []
    for i in range(bs.shape[0]):
        phi1, phi2 = phi[:, i, 0], phi[:, i, 1]
        psi1, psi2 = psi[:, i, 0], psi[:, i, 1]
        for j in range(i):
            phi1, phi2 = ((bs[i] - s1[j]) * phi1 - s2[j] * phi2,
                          torch.conj(s2[j]) * phi1
                          + (bs[i] - torch.conj(s1[j])) * phi2)
            psi1, psi2 = ((bs[i] - s1[j]) * psi1 - s2[j] * psi2,
                          torch.conj(s2[j]) * psi1
                          + (bs[i] - torch.conj(s1[j])) * psi2)
        beta = (phi1 - norm_consts[i] * psi1) / (phi2 - norm_consts[i] * psi2)
        b2 = torch.abs(beta) ** 2
        s1.append((b2 * bs[i] + torch.conj(bs[i])) / (1.0 + b2))
        s2.append((2j * bs[i].imag * beta) / (1.0 + b2))
        qn = qn - 2j * s2[i]
    return qn


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _add_discrete_spectrum(bound_states, normconsts_or_residues, q, t0, t1,
                           have_contspec, opts):
    """Reference add_discrete_spectrum (:680-906). The bound states are
    sorted and the residues converted on the host (K numbers)."""
    d = q.shape[-1]
    eps_t = (t1 - t0) / (d - 1)
    bs = _host(bound_states).astype(complex)
    nc = _host(normconsts_or_residues).astype(complex)
    order = np.argsort(-np.imag(bs), kind="stable")
    bs, nc = bs[order], nc[order]
    if len(bs) > 1 and np.any(bs[1:] == bs[:-1]):
        raise ValueError("bound states must be simple (multiplicity 1)")

    if opts.discspec_type is InverseDiscspecType.RESIDUES:
        if have_contspec:
            a_vals, _, _ = scatter_bound_states(
                q, -torch.conj(q), torch.as_tensor(bs, device=q.device),
                eps_t, t0, t1, Discretization.BO, skip_b=True)
            acoeff = _host(a_vals).astype(complex)
        else:
            acoeff = np.ones(len(bs), dtype=complex)
        for i in range(len(bs)):
            tmp = acoeff[i]
            for j in range(len(bs)):
                if j != i:
                    tmp *= (bs[i] - bs[j]) / (bs[i] - np.conj(bs[j]))
            nc[i] = (nc[i] / (2j * np.imag(bs[i]))) * tmp

    bs_t = torch.as_tensor(bs, device=q.device)
    nc_t = torch.as_tensor(nc, device=q.device)
    use_seed = (have_contspec or opts.contspec_method is
                InverseCstMethod.USE_SEED_POTENTIAL_INSTEAD)
    if not use_seed:
        tgrid = t0 + eps_t * torch.arange(d, dtype=real_dtype_of(q.dtype),
                                          device=q.device)
        zc = torch.searchsorted(tgrid, torch.zeros(1, dtype=tgrid.dtype,
                                                   device=q.device))
        return _multisoliton(bs_t, nc_t, tgrid, zc)
    return _darboux_with_seed(bs_t, nc_t, q, t0, t1)


def _target_device(device, *inputs):
    """The device of the first tensor among ``inputs``, else ``device``
    (default CUDA), as the forward transforms decide for ``q``."""
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return x.device
    return _array_device(device)


def nsev_inverse(contspec, xi_span, d: int, t_span, *, kappa: int = +1,
                 bound_states=None, normconsts_or_residues=None,
                 seed_potential=None, opts: NsevInverseOpts | None = None,
                 device=None):
    """Inverse NFT: recover D time-domain samples (fnft_nsev_inverse:121).

    Args:
      contspec: M samples of the chosen contspec representation on the
        canonical xi grid (see :func:`nsev_inverse_xi_grid`), or None.
      xi_span: (XI0, XI1) grid bounds (ignored for B_OF_TAU).
      d: number of output samples; must be a power of two.
      t_span: (T0, T1).
      kappa: +1 focusing / -1 defocusing.
      bound_states / normconsts_or_residues: discrete spectrum (kappa=+1).
      seed_potential: the CDT's seed with USE_SEED_POTENTIAL_INSTEAD.
      device: where arrays go when none of ``contspec``, ``seed_potential``
        and ``bound_states`` is a tensor (default: the CUDA device; raises
        without one).

    Returns q ``[d]``, a tensor on that device.
    """
    opts = opts or NsevInverseOpts()
    disc = opts.discretization
    check_arg(disc in (Discretization.SPLIT2A, Discretization.SPLIT2_MODAL),
              "inverse supports 2SPLIT2A / 2SPLIT2_MODAL")
    check_arg(d >= 2 and (d & (d - 1)) == 0, "D must be a power of two")
    t0, t1 = float(t_span[0]), float(t_span[1])
    check_arg(t0 < t1, "T[0] < T[1] required")
    check_arg(kappa in (-1, 1), "kappa must be +-1")
    k = 0 if bound_states is None else len(_host(bound_states))
    if k > 0:
        check_arg(kappa == +1, "discrete spectrum requires kappa = +1")
        check_arg(bool(np.all(np.imag(_host(bound_states)) > 0)),
                  "bound states must lie strictly in the upper half plane")
        check_arg(normconsts_or_residues is not None,
                  "norming constants / residues required with bound states")
    check_arg(contspec is not None or k > 0,
              "neither contspec nor discrete spectrum provided")
    dev = _target_device(device, contspec, seed_potential, bound_states)

    q = None
    if contspec is not None:
        contspec = torch.as_tensor(contspec, device=dev)
        m = contspec.shape[-1]
        check_arg(m % 2 == 0 and m >= d, "M must be even and >= D")
        deg = d * degree(disc)
        eps_t = (t1 - t0) / (d - 1)

        ctype = opts.contspec_type
        if ctype is InverseContspecType.REFLECTION_COEFFICIENT:
            if k > 0:
                contspec = _precompensate_cdt(contspec, xi_span, m,
                                              _host(bound_states))
            if opts.contspec_method is InverseCstMethod.TFMATRIX_CONTAINS_AB_FROM_ITER:
                tm = _build_tm_reflection_iter(contspec, xi_span, m, d, t0,
                                               t1, deg, kappa, disc, opts)
            else:
                tm = _build_tm_reflection(contspec, xi_span, m, d, t0, t1,
                                          deg, kappa, disc, opts)
        elif ctype is InverseContspecType.B_OF_XI:
            tm = _build_tm_b_of_xi(contspec, xi_span, m, d, t0, t1, deg,
                                   kappa, disc, opts)
        elif ctype is InverseContspecType.B_OF_TAU:
            tm = _build_tm_b_of_tau(contspec, m, d, t0, t1, deg, kappa, disc,
                                    opts)
        else:
            raise ValueError(ctype)
        q = finvscatter(tm, eps_t, kappa, disc)

    if k > 0:
        if q is None:
            # the reference passes a seed through the in/out q array when
            # csmethod is USE_SEED_POTENTIAL_INSTEAD (addsoliton test)
            if seed_potential is not None:
                q = torch.as_tensor(seed_potential, device=dev)
                q = q.to(complex_dtype_of(q))
            else:
                q = torch.zeros(d, dtype=complex_dtype_of(
                    torch.as_tensor(_host(bound_states))), device=dev)
        q = _add_discrete_spectrum(bound_states, normconsts_or_residues,
                                   q, t0, t1, contspec is not None, opts)
    return q
