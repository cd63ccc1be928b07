"""Polynomial rootfinding by Ehrlich-Aberth sweeps (eiscor's replacement).

Port of ``fnft_tpu/ops/roots.py``: Newton-polygon initial guesses on the
host, then simultaneous all-root sweeps

    z_i <- z_i - w_i / (1 - w_i * sum_{j != i} 1/(z_i - z_j)),  w_i = p/p'

with per-root freezing and one golden-angle stagnation restart. The JAX
``while_loop`` is a Python loop with one host check per sweep. The
repulsion sum is dense up to ``DENSE_REPULSION_MAX`` roots and goes to the
K2 kernel above (plain version on the CPU). Above ``MAX_UNDEFLATED_DEG``
:func:`poly_roots` takes :func:`aberth_roots_deflated`, where only the
roots still moving iterate (K2 at ``[deg, m]`` with m < deg).
"""

from __future__ import annotations

import numpy as np
import torch

from fnft_tpu_torch.config import complex_dtype_of, eps_of, real_dtype_of
from fnft_tpu_torch.ops.kernels import repulsion_sum

_CHUNK = 64
DENSE_REPULSION_MAX = 4096   # above: low-precision repulsion (K2)
MAX_UNDEFLATED_DEG = 16384   # above: aberth_roots_deflated


def _repulsion_chunked(z_all, z_t, t_idx, lowprec: bool = True):
    """Aberth repulsion ``s_i = sum_{j != t_idx_i} 1/(z_t_i - z_all_j)``
    with the low-precision contract of fnft_tpu roots.py:68-80 (K2)."""
    return repulsion_sum(z_all, z_t, t_idx.to(torch.int32), lowprec=lowprec)


def _repulsion(z_all, z_t, t_idx):
    """The sweeps' repulsion term of the roots ``z_t = z_all[..., t_idx]``
    against all of ``z_all [..., deg]``: dense and in full precision up to
    ``DENSE_REPULSION_MAX`` roots, K2 above (row by row under a leading
    batch axis). The term only steers the iteration's path (the fixed
    point p(z) = 0 does not depend on it), so K2's fp32 reciprocals cost
    no accuracy."""
    deg = z_all.shape[-1]
    if deg > DENSE_REPULSION_MAX:
        if z_all.dim() == 1:
            return _repulsion_chunked(z_all, z_t, t_idx)
        return torch.stack([_repulsion_chunked(za, zt, t_idx)
                            for za, zt in zip(z_all, z_t)])
    own = t_idx[:, None] == torch.arange(deg, device=z_all.device)[None, :]
    diff = z_t[..., :, None] - z_all[..., None, :]
    return torch.where(own, 0.0, 1.0 / torch.where(own, 1.0, diff)).sum(dim=-1)


def _horner_blocks(rows: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Evaluate the polynomials ``rows [..., R, n]`` (ascending) at
    ``u [..., K]`` by block Horner: the coefficients are cut into chunks of
    64 and contracted against a Vandermonde block by one matrix product;
    the chunks are then combined by a Horner loop over n/64 steps. Returns
    ``[..., R, K]``."""
    *lead, n_rows, n = rows.shape
    nch = -(-n // _CHUNK)
    rows = torch.nn.functional.pad(rows, (0, nch * _CHUNK - n))
    # Vandermonde block u^j for j < CHUNK: [..., CHUNK, K]
    u1 = u[..., None, :]
    xp = torch.cumprod(torch.cat(
        [torch.ones_like(u1), u1.expand(*lead, _CHUNK - 1, -1)], dim=-2),
        dim=-2)
    inner = (rows.reshape(*lead, n_rows * nch, _CHUNK) @ xp).reshape(
        *lead, n_rows, nch, -1)
    x_l = xp[..., -1:, :] * u1                          # u^CHUNK
    acc = torch.zeros_like(inner[..., 0, :])
    for c in range(nch - 1, -1, -1):
        acc = acc * x_l + inner[..., c, :]
    return acc


def _block_eval_ratio(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """w = p(z)/p'(z) for ``coeffs [..., deg+1]`` at ``z [..., K]``,
    evaluated stably inside and outside the unit disk.

    p and the reversed polynomial are evaluated together (one block
    Horner), as the two are at the same points; only ratios are formed, so
    nothing overflows.
    """
    deg = coeffs.shape[-1] - 1
    kvec = torch.arange(deg + 1, dtype=real_dtype_of(coeffs.dtype),
                        device=coeffs.device)
    inside = torch.abs(z) <= 1.0
    u = torch.where(inside, z, 1.0 / torch.where(z == 0, 1.0, z))

    rev = coeffs.flip(-1)
    p_in, s_in, p_rev, s_rev = _horner_blocks(
        torch.stack([coeffs, coeffs * kvec, rev, rev * kvec], dim=-2),
        u).unbind(dim=-2)

    # inside: p'/p = s_in / (z * p_in)
    lg_in = s_in / (u * torch.where(p_in == 0, 1.0, p_in))
    # outside: p(z) = z^deg q(u);  p'/p = u*(deg - s_rev/q)
    lg_out = u * (deg - s_rev / torch.where(p_rev == 0, 1.0, p_rev))
    log_deriv = torch.where(inside, lg_in, lg_out)
    p_is_zero = torch.where(inside, p_in == 0, p_rev == 0)
    w = 1.0 / torch.where(log_deriv == 0, 1.0, log_deriv)
    return torch.where(p_is_zero, 0.0, w)  # exactly at a root: no update


def _newton_polygon_init(abs_coeffs: np.ndarray) -> np.ndarray:
    """Bini initial guesses from the upper convex hull of (k, log|c_k|)."""
    n = len(abs_coeffs) - 1
    with np.errstate(divide="ignore"):
        logc = np.where(abs_coeffs > 0, np.log(np.where(abs_coeffs > 0,
                                                        abs_coeffs, 1.0)), -np.inf)
    # upper convex hull via monotone chain over indices with finite logc
    idx = [k for k in range(n + 1) if np.isfinite(logc[k])]
    if len(idx) < 2:  # degenerate polynomial; fall back to unit circle
        ang = 2 * np.pi * (np.arange(n) + 0.5) / max(n, 1) + 0.3
        return np.exp(1j * ang)
    hull: list[int] = []
    for k in idx:
        while len(hull) >= 2:
            i, j = hull[-2], hull[-1]
            # keep hull upper-convex: drop j if it lies below segment (i, k)
            if (logc[j] - logc[i]) * (k - i) <= (logc[k] - logc[i]) * (j - i):
                hull.pop()
            else:
                break
        hull.append(k)
    guesses = np.zeros(n, dtype=np.complex128)
    pos = 0
    # roots "at infinity" for leading zero coefficients: big circle
    if hull[-1] < n:
        m = n - hull[-1]
        ang = 2 * np.pi * (np.arange(m) + 0.5) / m
        guesses[pos: pos + m] = 1e6 * np.exp(1j * ang)
        pos += m
    # roots at ~0 for trailing zero coefficients
    if hull[0] > 0:
        m = hull[0]
        ang = 2 * np.pi * (np.arange(m) + 0.5) / m
        guesses[pos: pos + m] = 1e-6 * np.exp(1j * ang)
        pos += m
    sigma = 0.7  # fixed rotation offset decorrelating circles (Bini sec. 5)
    for a, b in zip(hull[:-1], hull[1:]):
        m = b - a
        r = (abs_coeffs[a] / abs_coeffs[b]) ** (1.0 / m)
        r = min(max(r, 1e-12), 1e12)
        ang = 2 * np.pi * (np.arange(m) + 0.5) / m + sigma * b
        guesses[pos: pos + m] = r * np.exp(1j * ang)
        pos += m
    return guesses[:n]


def _aberth_sweep(coeffs, z_all, za, idx, frozen_a, tol):
    """One Ehrlich-Aberth sweep of the roots ``za = z_all[..., idx]``; roots
    marked frozen stop moving but keep repelling the others. Returns
    (za, frozen_a, moved), ``moved [...]`` the largest relative update of
    a root not yet frozen."""
    w = _block_eval_ratio(coeffs, za)
    denom = 1.0 - w * _repulsion(z_all, za, idx)
    corr = w / torch.where(denom == 0, 1.0, denom)
    za_new = torch.where(frozen_a, za, za - corr)
    rel = torch.abs(corr) / torch.clamp(torch.abs(za_new), min=1e-30)
    frozen_a = frozen_a | (rel < tol)
    return za_new, frozen_a, torch.where(frozen_a, 0.0, rel).amax(dim=-1)


def _golden_kick(idx: torch.Tensor, tol: float, rdt) -> torch.Tensor:
    """Deterministic per-root factor that nudges stagnating roots off
    their cycle."""
    return 1.0 + 64.0 * tol * torch.cos(idx.to(rdt) * 2.399963229728653)


def aberth_roots(coeffs: torch.Tensor, z0: torch.Tensor,
                 num_iters: int = 80) -> torch.Tensor:
    """Run Ehrlich-Aberth sweeps from initial guesses ``z0``.

    ``coeffs [deg+1]`` (ascending) and ``z0 [deg]``, or both with one
    leading batch axis: the polynomials then share every sweep's launches,
    and each stops after as many sweeps as it would take alone. Sweeps stop
    once every root is frozen (relative update below 100 eps) or after
    ``num_iters``; roots still moving then get a deterministic golden-angle
    kick and ``num_iters // 2`` more sweeps (fnft_tpu roots.py:293-368).
    One host check per sweep.
    """
    cdt = complex_dtype_of(coeffs)
    coeffs = coeffs.to(cdt)
    deg = coeffs.shape[-1] - 1
    tol = 100.0 * eps_of(cdt)
    idx = torch.arange(deg, dtype=torch.int32, device=coeffs.device)

    def run(z, frozen, it, active):
        """Sweeps of the polynomials marked ``active [...]`` (a bool
        tensor) until each has converged or ``it`` reaches the budget."""
        while it < num_iters and bool(active.any()):
            z_new, frozen_new, moved = _aberth_sweep(coeffs, z, z, idx,
                                                     frozen, tol)
            z = torch.where(active[..., None], z_new, z)
            frozen = torch.where(active[..., None], frozen_new, frozen)
            active = active & (moved > tol)
            it += 1
        return z, frozen

    z = z0.to(cdt)
    everyone = torch.ones(z.shape[:-1], dtype=torch.bool, device=z.device)
    z, frozen = run(z, torch.zeros_like(z, dtype=torch.bool), 0, everyone)
    stuck = ~frozen.all(dim=-1)
    if bool(stuck.any()):
        kick = _golden_kick(idx, tol, real_dtype_of(cdt))
        z, _ = run(torch.where(frozen, z, z * kick), frozen, num_iters // 2,
                   stuck)
    return z


def aberth_roots_deflated(coeffs: torch.Tensor, z0: torch.Tensor,
                          num_iters: int = 80, block: int = 3,
                          deflate_frac: float = 0.5, min_cap: int = 256,
                          return_iters: bool = False):
    """Ehrlich-Aberth with active-set deflation, for large degrees.

    eiscor deflates converged roots out of its QR iteration
    (src/3rd_party/eiscor/z_poly_roots_modified.f90:39-122); this is the
    batched analogue. Full sweeps run in blocks of ``block`` until at most
    ``deflate_frac`` of the roots are still moving; after that only the
    unfrozen tail iterates, at O(m deg) per sweep for m active roots,
    while every root, frozen or not, keeps repelling through the current
    ``z``. The active set is taken anew every ``block`` sweeps. The JAX
    package pads it to a power-of-two capacity ``cap``; here it is exact,
    and ``cap`` only decides, as there, between active-set sweeps and full
    sweeps (``cap >= deg``: the tail is not small enough to gain), so
    both take the same sequence of sweeps.

    Semantics match :func:`aberth_roots` (same tolerance, freeze rule and
    golden-angle stagnation kick); the budget ``num_iters`` may be overshot
    by at most ``block - 1`` sweeps per stage. With ``return_iters`` also
    returns the number of sweeps run.
    """
    cdt = complex_dtype_of(coeffs)
    coeffs = coeffs.to(cdt)
    z = z0.to(cdt).clone()
    deg = coeffs.shape[-1] - 1
    tol = 100.0 * eps_of(cdt)
    all_idx = torch.arange(deg, dtype=torch.int32, device=coeffs.device)

    def sweeps(z, idx, frozen_a):
        """Up to ``block`` sweeps of the roots ``z[idx]``, written back
        into ``z``; returns (frozen_a, moved, sweeps run)."""
        za, moved, n = z[idx.long()], float("inf"), 0
        while moved > tol and n < block:
            za, frozen_a, moved = _aberth_sweep(coeffs, z, za, idx, frozen_a,
                                                tol)
            moved = float(moved)
            z[idx.long()] = za
            n += 1
        return frozen_a, moved, n

    def polish_until(frozen, budget):
        """Stages on the unfrozen roots until convergence or ``budget``
        sweeps; returns (frozen, sweeps run)."""
        done = 0
        while done < budget:
            idx = all_idx[~frozen]
            na = idx.shape[0]
            if na == 0:
                break
            cap = max(min_cap, 1 << (na - 1).bit_length())
            if cap >= deg:
                frozen, moved, n = sweeps(z, all_idx, frozen)
                done += n
                if moved <= tol:
                    return torch.ones_like(frozen), done
                continue
            frozen_a, moved, n = sweeps(z, idx, torch.zeros_like(
                idx, dtype=torch.bool))
            done += n
            frozen = frozen.clone()
            frozen[idx.long()] = frozen_a | (moved <= tol)
            if moved <= tol:
                break
        return frozen, done

    frozen = torch.zeros(deg, dtype=torch.bool, device=coeffs.device)
    it = 0
    converged = False
    while it < num_iters:
        frozen, moved, n = sweeps(z, all_idx, frozen)
        it += n
        if moved <= tol:
            converged = True
            break
        if int((~frozen).sum()) <= deflate_frac * deg:
            frozen, n = polish_until(frozen, num_iters - it)
            it += n
            converged = bool(frozen.all())
            break

    # stagnation kick (cf. aberth_roots): nudge survivors off any cycle
    # and grant num_iters // 2 extra polish sweeps
    if not converged and not bool(frozen.all()):
        idx = all_idx[~frozen]
        z[idx.long()] *= _golden_kick(idx, tol, real_dtype_of(cdt))
        _, n = polish_until(frozen, num_iters // 2)
        it += n
    return (z, it) if return_iters else z


def root_residuals(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Per-root relative backward error ``eta_i`` of ``z`` w.r.t. ``coeffs``.

    ``eta_i = |p(z_i)| / sum_k |c_k| |z_i|^k`` is the smallest relative
    coefficient-wise perturbation making ``z_i`` an exact root; certified
    Aberth roots (``eta <= ~deg * eps``, see :func:`certified_tol`) match
    the contract of a backward-stable method. For ``|z| > 1`` the reversed
    polynomial is used so nothing overflows.

    Returns ``eta`` with the shape of ``z`` (real dtype).
    """
    cdt = complex_dtype_of(coeffs)
    rdt = real_dtype_of(cdt)
    coeffs, z = coeffs.to(cdt), z.to(cdt)
    inside = torch.abs(z) <= 1.0
    u = torch.where(inside, z, 1.0 / torch.where(z == 0, 1.0, z))
    rev = coeffs.flip(-1)
    p_in, p_rev = _horner_blocks(torch.stack([coeffs, rev]), u)
    a_in, a_rev = _horner_blocks(torch.abs(torch.stack([coeffs, rev])),
                                 torch.abs(u))
    pv = torch.where(inside, torch.abs(p_in), torch.abs(p_rev))
    av = torch.where(inside, a_in, a_rev)
    # tiny of the working real dtype guards 0/0 at exact roots of
    # polynomials with zero constant coefficient
    return pv / torch.clamp(av, min=torch.finfo(rdt).tiny)


def certified_tol(deg: int, dtype: torch.dtype = torch.complex128) -> float:
    """Default acceptance threshold for :func:`root_residuals`: a backward
    error of O(deg * eps) is what a backward-stable method (eiscor)
    guarantees; the 64x headroom absorbs Aberth's final-sweep noise."""
    return 64.0 * max(deg, 1) * eps_of(dtype)


def _initial_guesses(coeffs: torch.Tensor) -> torch.Tensor:
    """Newton-polygon initial guesses, built on the host."""
    abs_c = np.abs(coeffs.detach().cpu().numpy().astype(np.complex128))
    return torch.as_tensor(_newton_polygon_init(abs_c), device=coeffs.device)


def poly_roots(coeffs: torch.Tensor, num_iters: int = 80,
               return_residuals: bool = False):
    """All roots of a polynomial (ascending ``coeffs [deg+1]``) by
    Ehrlich-Aberth sweeps from Newton-polygon initial guesses; above
    ``MAX_UNDEFLATED_DEG`` with active-set deflation.

    With ``return_residuals`` also returns the per-root relative backward
    error from :func:`root_residuals` (accept roots with
    ``eta <= certified_tol(deg)``).
    """
    z0 = _initial_guesses(coeffs)
    if coeffs.shape[-1] - 1 > MAX_UNDEFLATED_DEG:
        roots = aberth_roots_deflated(coeffs, z0, num_iters=num_iters)
    else:
        roots = aberth_roots(coeffs, z0, num_iters=num_iters)
    if return_residuals:
        return roots, root_residuals(coeffs, roots)
    return roots


def poly_roots_batched(coeffs: torch.Tensor,
                       num_iters: int = 80) -> torch.Tensor:
    """Roots of a batch of same-degree polynomials ``[B, deg+1] -> [B, deg]``
    (e.g. the reference's per-spine eiscor calls, fnft_nsep.c:556-608)."""
    z0 = torch.stack([_initial_guesses(c) for c in coeffs])
    return aberth_roots(coeffs, z0, num_iters=num_iters)
