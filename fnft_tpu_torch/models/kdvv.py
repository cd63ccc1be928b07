"""Forward NFT for the Korteweg-de Vries equation, vanishing BCs.

Port of ``fnft_tpu/models/kdvv.py`` (reference fnft_kdvv.c:59-209). KdV maps
onto the AKNS system with r = -1 (fnft__kdv_fscatter.c:75-76); the
reflection coefficient is read off the transfer matrix evaluated on the
*negated* xi grid:

    rho(xi) = exp(2 i xi' (T1 + c eps)) H12(xi') / (2 i xi' H22(xi') - H12(xi'))

with xi' = -xi (tf2contspec_negxi, fnft_kdvv.c:126-209). The reference has
no discrete spectrum (fnft_kdvv.c:87-92); :func:`kdvv_bound_states` is the
JAX package's extension through the generic AKNS machinery.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fnft_tpu_torch.config import complex_dtype_of, real_dtype_of
from fnft_tpu_torch.errors import check_arg
from fnft_tpu_torch.models.discretization import (
    BOUNDARY_COEFF,
    Discretization,
    degree,
    is_fast,
    lambda_stage_weights,
    z_to_lambda,
)
from fnft_tpu_torch.models.nsev import _as_signal
from fnft_tpu_torch.ops.fscatter import fscatter
from fnft_tpu_torch.ops.poly import chirpz
from fnft_tpu_torch.ops.roots import poly_roots
from fnft_tpu_torch.ops.scatter import scatter_matrix
from fnft_tpu_torch.utils import misc


@dataclasses.dataclass(frozen=True)
class KdvvOpts:
    """Defaults mirror fnft_kdvv_default_opts (fnft_kdvv.c:34-36).

    ``rsym``: assert that the potential is real-valued (the physical KdV
    case) even when it arrives as a complex tensor, which is not inspected
    (that would copy it to the host); the real-coefficient half-grid FFT
    tree then runs. None = decide from real dtypes and host arrays."""

    discretization: Discretization = Discretization.SPLIT8B
    rsym: Optional[bool] = None


@dataclasses.dataclass
class KdvvResult:
    """Requested spectra as tensors on the input's device."""

    reflection_coefficient: Optional[torch.Tensor] = None
    bound_states: Optional[torch.Tensor] = None  # zeta_n = i kappa_n


def _is_real_valued(u) -> bool:
    """True when ``u`` is demonstrably real-valued.

    Anything of a real dtype is decided from the dtype alone; complex host
    arrays (numpy, lists) are inspected elementwise. A complex tensor
    returns False without inspection: callers that know it holds real
    values pass ``rsym``."""
    if isinstance(u, torch.Tensor):
        return not u.is_complex()
    a = np.asarray(u)
    return not np.iscomplexobj(a) or not np.any(a.imag)


def kdv_fscatter(u: torch.Tensor, eps_t: float, disc: Discretization, *,
                 normalize: bool = True, want=None, rsym: bool | None = None):
    """KdV polynomial scattering matrix: r = -1, then the AKNS kernel
    (reference fnft__kdv_fscatter.c:36-83).

    A real-valued potential gives all-real transfer-matrix coefficients, so
    the FFT tree runs on conjugate-symmetric half grids (``rsym``); pass
    ``rsym`` explicitly when ``u`` is a complex tensor known to hold real
    values."""
    if rsym is None:
        rsym = _is_real_valued(u)
    return fscatter(u, -torch.ones_like(u), eps_t, disc, normalize=normalize,
                    want=want, rsym=bool(rsym))


def kdv_scatter_matrix(q, lam, eps_t: float,
                       disc: Discretization = Discretization.BO, *,
                       derivative: bool = False, device=None):
    """Slow KdV scattering matrix (reference
    fnft__kdv_scatter_matrix.c:33-143).

    The AKNS r-potential is a per-stage constant: -1 for BO, the CF stage
    weights times -1 for the commutator-free schemes. ``device`` as in
    :func:`kdvv`; ``lam`` follows ``q``.
    """
    q = _as_signal(q, device)
    q = q.to(complex_dtype_of(q))
    if not isinstance(lam, torch.Tensor):
        lam = torch.as_tensor(np.asarray(lam))
    lam = lam.to(q.device)
    stage_r = -np.asarray(lambda_stage_weights(disc))
    r = torch.as_tensor(np.tile(stage_r, q.shape[-1] // len(stage_r)),
                        device=q.device).to(q.dtype)
    return scatter_matrix(q, r, lam, eps_t, disc, derivative=derivative)


def kdvv(u, t_span, *, m: int, xi_span, opts: KdvvOpts | None = None,
         device=None) -> KdvvResult:
    """Continuous KdV spectrum (reflection coefficient) on a xi grid.

    ``u`` is a tensor (the work runs on its device, in its precision) or
    an array, which goes to ``device`` (default: the CUDA device; raises
    without one)."""
    opts = opts or KdvvOpts()
    disc = opts.discretization
    check_arg(is_fast(disc) and degree(disc) > 0,
              "kdvv requires a fast (2SPLIT) discretization")
    rsym = opts.rsym if opts.rsym is not None else _is_real_valued(u)
    u = _as_signal(u, device)
    cdt = complex_dtype_of(u)
    u = u.to(cdt)
    d = u.shape[-1]
    t0, t1 = float(t_span[0]), float(t_span[1])
    xi0, xi1 = float(xi_span[0]), float(xi_span[1])
    check_arg(d >= 2 and t0 < t1 and xi0 < xi1 and m >= 2, "invalid grids")

    eps_t = (t1 - t0) / (d - 1)
    eps_xi = (xi1 - xi0) / (m - 1)
    deg1 = degree(disc)
    tm, _ = kdv_fscatter(u, eps_t, disc, want=((0, 1), (1, 1)), rsym=rsym)

    # evaluate H12, H22 at z(-xi_i), xi_i = xi0 + i eps_xi
    a_pt = complex(np.exp(-2j * xi0 * eps_t / deg1))
    w_pt = complex(np.exp(-2j * eps_xi * eps_t / deg1))
    h12, h22 = chirpz(tm[:, 1], a_pt, w_pt, m)

    xi_neg = -(xi0 + eps_xi * torch.arange(m, dtype=real_dtype_of(cdt),
                                           device=u.device))
    if disc is Discretization.SPLIT2A:
        # undo the first-order-polynomial trick (fnft_kdvv.c:186-195)
        h12 = h12 / torch.exp(1j * xi_neg * (eps_t / deg1))

    num = torch.exp(2j * xi_neg * (t1 + BOUNDARY_COEFF * eps_t)) * h12
    den = 2j * xi_neg * h22 - h12
    return KdvvResult(reflection_coefficient=num / den)


def kdvv_bound_states(u, t_span, *, opts: KdvvOpts | None = None,
                      tol_re: float = 1e-2, device=None) -> torch.Tensor:
    """Discrete KdV spectrum zeta_n = i kappa_n (eigenvalues E_n = -kappa_n^2).

    An extension beyond the reference (src/fnft_kdvv.c:87-92): zeros of
    a(zeta) on the positive imaginary axis from the Aberth roots of the
    transfer-matrix polynomial, like nsev's FAST_EIGENVALUE path. The few
    roots kept are filtered and merged on the host and returned on ``u``'s
    device (``device`` as in :func:`kdvv`).
    """
    opts = opts or KdvvOpts()
    disc = opts.discretization
    rsym = opts.rsym if opts.rsym is not None else _is_real_valued(u)
    u = _as_signal(u, device)
    u = u.to(complex_dtype_of(u))
    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / (u.shape[-1] - 1)
    tm, _ = kdv_fscatter(u, eps_t, disc, want=((0, 0),), rsym=rsym)
    lam = z_to_lambda(poly_roots(tm[0, 0]), eps_t, disc).cpu().numpy()
    # keep near-imaginary-axis roots with positive imaginary part, inside
    # the resolvable band, then dedupe
    im_max = 0.9 * np.pi / (2.0 / degree(disc) * eps_t)
    keep = (np.abs(lam.real) < tol_re) & (lam.imag > tol_re) \
        & (lam.imag < im_max)
    lam = 1j * np.unique(np.round(lam.imag[keep], 12))
    return torch.as_tensor(misc.merge_points_host(lam, 1e-6), device=u.device)
