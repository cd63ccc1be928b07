"""Slow (ODE-style) AKNS scattering at bound states: phi/psi sweeps.

Port of ``fnft_tpu/ops/scatter.py`` (reference
fnft__nse_scatter_bound_states.c) for the BO step, the Newton base of every
one-sample-per-step fast scheme. The D-axis recurrence is a product of
per-step 2x2 matrices, each vectorized over the K spectral points; torch
has no ``associative_scan``, so prefix products are log-depth
(Hillis-Steele) and full products a pairwise tree, on every device. The
one-shot trajectory ``[S, K, 2, 2]`` (64 S K bytes in complex128) is kept
at every D; the chunked two-pass sweep of the JAX package and the other
slow schemes are ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import numpy as np
import torch

from fnft_tpu_torch.config import complex_dtype_of
from fnft_tpu_torch.models.discretization import (
    BOUNDARY_COEFF,
    Discretization,
    lambda_stage_weights,
)


def _stage_weight_per_step(disc: Discretization, d_eff: int, dtype, device):
    """Per-step lambda scaling: stage weights tiled over the sample axis."""
    w = lambda_stage_weights(disc)
    return torch.as_tensor(np.tile(w, d_eff // len(w)), device=device).to(dtype)


def _cf_step_matrices(qn, rn, l, eps_t, *, derivative: bool):
    """One CF-family step: U (and dU/dlam), broadcast over qn and l.

    U = [[ch - i l sh, q sh], [r sh, ch + i l sh]] with k = sqrt(qr - l^2),
    ch = cosh(k eps), sh = sinh(k eps)/k (reference scatter_matrix.c:172-233).
    """
    ks = qn * rn - l * l
    k = torch.sqrt(ks)
    ch = torch.cosh(k * eps_t)
    small = torch.abs(ks) < 1e-30
    ks_safe = torch.where(small, 1.0, ks)
    sh = torch.where(small, eps_t,
                     torch.sinh(k * eps_t) / torch.where(small, 1.0, k))
    u1 = 1j * l * sh
    U = torch.stack([
        torch.stack([ch - u1, qn * sh], dim=-1),
        torch.stack([rn * sh, ch + u1], dim=-1),
    ], dim=-2)
    if not derivative:
        return U, None
    # g = (eps ch - sh)/ks, series limit eps^3/3 as ks -> 0
    g = torch.where(small, (eps_t ** 3) / 3.0, (eps_t * ch - sh) / ks_safe)
    du00 = 1j * l * l * g - (l * eps_t + 1j) * sh
    du11 = -1j * l * l * g - (l * eps_t - 1j) * sh
    dU = torch.stack([
        torch.stack([du00, -qn * l * g], dim=-1),
        torch.stack([-rn * l * g, du11], dim=-1),
    ], dim=-2)
    return U, dU


def _step_matrices(q, r, lam, eps_t, disc, *, derivative: bool,
                   backward: bool = False):
    """All per-step matrices ``U [S, K, 2, 2]`` (and dU), in time order of
    ``q`` (the caller reverses ``q`` for the backward sweep)."""
    if disc is not Discretization.BO:
        raise NotImplementedError(
            f"slow scheme {disc} is not ported yet (ROADMAP Queue 1 item 7)")
    wsteps = _stage_weight_per_step(disc, q.shape[-1], q.dtype, q.device)
    h = -eps_t if backward else eps_t
    return _cf_step_matrices(q[:, None], r[:, None],
                             lam[None, :] * wsteps[:, None], h,
                             derivative=derivative)


def _mm2(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """b @ a over [..., 2, 2] stacks as one broadcast product and one sum:
    torch.matmul sends batched 2x2 complex products to cuBLAS GEMM tiles,
    which dominated nsev's device time at large D (PERF.md), and writing
    the eight products out costs a dozen launches per product."""
    return (b[..., :, :, None] * a[..., None, :, :]).sum(dim=-2)


def _mv2(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m @ v for [..., 2, 2] matrices and [..., 2] vectors (broadcast)."""
    return (m * v[..., None, :]).sum(dim=-1)


def _pair_combine(a, b):
    """Associative combine for (T, T') with later blocks on the left:
    (AB = B @ A, (AB)' = B' A + B A')."""
    am, ad = a
    bm, bd = b
    return _mm2(bm, am), _mm2(bd, am) + _mm2(bm, ad)


def _tree_product(u: torch.Tensor, du: torch.Tensor | None):
    """Log-depth product U[S-1] ... U[0] (and its derivative), padding with
    identities to a power of two."""
    s = u.shape[0]
    if du is None:
        du = torch.zeros_like(u)
    s_pad = 1 << max(0, s - 1).bit_length()
    if s_pad != s:
        eye = torch.eye(2, dtype=u.dtype, device=u.device).expand(
            (s_pad - s,) + u.shape[1:])
        u = torch.cat([u, eye], dim=0)
        du = torch.cat([du, torch.zeros_like(eye)], dim=0)
    while u.shape[0] > 1:
        u, du = _pair_combine((u[0::2], du[0::2]), (u[1::2], du[1::2]))
    return u[0], du[0]


def _prefix_product(u: torch.Tensor, du: torch.Tensor | None = None):
    """Inclusive prefix products P_s = U_s ... U_0 (and dP_s) along dim 0,
    Hillis-Steele: log2(S) batched combines, no per-step loop."""
    d = 1
    s = u.shape[0]
    while d < s:
        if du is not None:
            du = torch.cat([du[:d],
                            _mm2(du[d:], u[:-d]) + _mm2(u[d:], du[:-d])])
        u = torch.cat([u[:d], _mm2(u[d:], u[:-d])])
        d *= 2
    return u, du


def scatter_bound_states(q, r, lam, eps_t: float, t0: float, t1: float,
                         disc: Discretization, *, skip_b: bool = False):
    """a(lam), a'(lam) and b(lam) at bound states via phi/psi sweeps.

    phi scatters forward from T[0], psi backward from T[1]; b is read off
    at the grid point minimizing |log| phi2 psi1 / (psi2 phi1)||/2
    (reference bound_states.c:642-654). With ``skip_b`` only the full
    products are formed (a pairwise tree instead of the trajectory).

    Returns (a, a_prime, b), each ``[K]``.
    """
    cdt = complex_dtype_of(q)
    q, r, lam = q.to(cdt), r.to(cdt), lam.to(cdt)
    scl = 1.0 / len(lambda_stage_weights(disc))
    tb = t0 - eps_t * BOUNDARY_COEFF
    te = t1 + eps_t * BOUNDARY_COEFF
    zeros = torch.zeros_like(lam)
    phi0 = torch.stack([torch.exp(-1j * lam * tb), zeros], dim=-1)
    dphi0 = torch.stack([phi0[:, 0] * (-1j * tb), zeros], dim=-1)

    u, du = _step_matrices(q, r, lam, eps_t, disc, derivative=True)
    if skip_b:
        pm_end, pd_end = _tree_product(u, du)
    else:
        pm, pd = _prefix_product(u, du)
        pm_end, pd_end = pm[-1], pd[-1]
    phi_end = _mv2(pm_end, phi0)
    dphi_end = _mv2(pd_end, phi0) + _mv2(pm_end, dphi0)
    e_te = torch.exp(1j * lam * te)
    a = phi_end[:, 0] * e_te
    aprime = scl * (dphi_end[:, 0] * e_te + (1j * te) * a)
    if skip_b:
        return a, aprime, torch.zeros_like(a)

    # one step per sample for BO: the trajectory is stored at every sample
    phi_samples = torch.cat(
        [phi0[None], _mv2(pm, phi0)], dim=0)

    psi_end = torch.stack([zeros, e_te], dim=-1)
    ub, _ = _step_matrices(q.flip(-1), r.flip(-1), lam, eps_t, disc,
                           derivative=False, backward=True)
    rm, _ = _prefix_product(ub)
    psi_samples = torch.cat(
        [psi_end[None], _mv2(rm, psi_end)],
        dim=0).flip(0)                                  # [D+1, K, 2]

    ratio = (phi_samples[..., 1] / psi_samples[..., 1]) / \
            (phi_samples[..., 0] / psi_samples[..., 0])
    metric = torch.abs(0.5 * torch.log(torch.abs(ratio)))
    metric = torch.where(torch.isnan(metric), torch.inf, metric)
    n_best = torch.argmin(metric, dim=0)[None, :]       # [1, K]
    b = (torch.take_along_dim(phi_samples[..., 0], n_best, dim=0)[0]
         / torch.take_along_dim(psi_samples[..., 0], n_best, dim=0)[0])
    return a, aprime, b
