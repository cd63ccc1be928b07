"""Polynomial rootfinding by Ehrlich-Aberth sweeps (eiscor's replacement).

Port of ``fnft_tpu/ops/roots.py``: Newton-polygon initial guesses on the
host, then simultaneous all-root sweeps

    z_i <- z_i - w_i / (1 - w_i * sum_{j != i} 1/(z_i - z_j)),  w_i = p/p'

with per-root freezing and one golden-angle stagnation restart. The JAX
``while_loop`` is a Python loop with one host check per sweep. The
repulsion sum is dense up to ``DENSE_REPULSION_MAX`` roots and goes to the
K2 kernel above (plain version on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from fnft_tpu_torch.config import complex_dtype_of, eps_of, real_dtype_of
from fnft_tpu_torch.ops.kernels import repulsion_sum

_CHUNK = 64
DENSE_REPULSION_MAX = 4096   # above: chunked low-precision repulsion (K2)
MAX_UNDEFLATED_DEG = 16384   # above: aberth_roots_deflated (not ported)


def _repulsion_chunked(z_all, z_t, t_idx, lowprec: bool = True):
    """Aberth repulsion ``s_i = sum_{j != t_idx_i} 1/(z_t_i - z_all_j)``
    with the low-precision contract of fnft_tpu roots.py:68-80 (K2)."""
    return repulsion_sum(z_all, z_t, t_idx.to(torch.int32), lowprec=lowprec)


def _block_eval_ratio(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """w = p(z)/p'(z), evaluated stably inside and outside the unit disk.

    Block Horner: the coefficients are cut into chunks of 64 and contracted
    against a Vandermonde block by one matrix product; the chunks are then
    combined by a Horner loop over deg/64 steps. p and the reversed
    polynomial are evaluated together, as the two are at the same points.
    """
    deg = coeffs.shape[-1] - 1
    n = deg + 1
    kvec = torch.arange(n, dtype=real_dtype_of(coeffs.dtype),
                        device=coeffs.device)
    inside = torch.abs(z) <= 1.0
    u = torch.where(inside, z, 1.0 / torch.where(z == 0, 1.0, z))

    rev = coeffs.flip(-1)
    rows = torch.stack([coeffs, coeffs * kvec, rev, rev * kvec])  # [4, n]
    nch = -(-n // _CHUNK)
    rows = torch.nn.functional.pad(rows, (0, nch * _CHUNK - n))
    # Vandermonde block u^j for j < CHUNK: [CHUNK, K]
    xp = torch.cumprod(torch.cat([torch.ones_like(u)[None],
                                  u[None].expand(_CHUNK - 1, -1)]), dim=0)
    inner = (rows.reshape(4 * nch, _CHUNK) @ xp).reshape(4, nch, -1)
    x_l = xp[-1] * u                                   # u^CHUNK
    acc = torch.zeros((4,) + u.shape, dtype=u.dtype, device=u.device)
    for c in range(nch - 1, -1, -1):
        acc = acc * x_l + inner[:, c]
    p_in, s_in, p_rev, s_rev = acc

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


def aberth_roots(coeffs: torch.Tensor, z0: torch.Tensor,
                 num_iters: int = 80) -> torch.Tensor:
    """Run Ehrlich-Aberth sweeps from initial guesses ``z0``.

    Sweeps stop once every root is frozen (relative update below
    100 eps) or after ``num_iters``; roots still moving then get a
    deterministic golden-angle kick and ``num_iters // 2`` more sweeps
    (fnft_tpu roots.py:293-368).
    """
    cdt = complex_dtype_of(coeffs)
    coeffs = coeffs.to(cdt)
    z0 = z0.to(cdt)
    deg = coeffs.shape[-1] - 1
    tol = 100.0 * eps_of(cdt)
    dev = coeffs.device
    idx = torch.arange(deg, dtype=torch.int32, device=dev)

    def pairwise_sum(z):
        if deg <= DENSE_REPULSION_MAX:
            eye = torch.eye(deg, dtype=torch.bool, device=dev)
            diff = z[:, None] - z[None, :]
            inv = torch.where(eye, 0.0, 1.0 / torch.where(eye, 1.0, diff))
            return torch.sum(inv, dim=1)
        return _repulsion_chunked(z, z, idx)

    def run(z, frozen, it):
        moved = float("inf")
        while moved > tol and it < num_iters:
            w = _block_eval_ratio(coeffs, z)
            s = pairwise_sum(z)
            denom = 1.0 - w * s
            corr = w / torch.where(denom == 0, 1.0, denom)
            z_new = torch.where(frozen, z, z - corr)
            rel = torch.abs(corr) / torch.clamp(torch.abs(z_new), min=1e-30)
            # converged roots stop moving but keep repelling the others
            frozen = frozen | (rel < tol)
            moved = float(torch.max(torch.where(frozen, 0.0, rel)))
            z = z_new
            it += 1
        return z, frozen

    z, frozen = run(z0, torch.zeros(deg, dtype=torch.bool, device=dev), 0)
    if not bool(torch.all(frozen)):
        ang = torch.arange(deg, dtype=real_dtype_of(cdt), device=dev)
        kick = 1.0 + 64.0 * tol * torch.cos(ang * 2.399963229728653)
        z, _ = run(torch.where(frozen, z, z * kick), frozen, num_iters // 2)
    return z


def poly_roots(coeffs: torch.Tensor, num_iters: int = 80) -> torch.Tensor:
    """All roots of a polynomial (ascending ``coeffs [deg+1]``), with
    Newton-polygon initial guesses built on the host."""
    deg = coeffs.shape[-1] - 1
    if deg > MAX_UNDEFLATED_DEG:
        raise NotImplementedError(
            f"degree {deg} > {MAX_UNDEFLATED_DEG} needs aberth_roots_deflated"
            ", which is not ported yet (ROADMAP Queue 1 item 6)")
    abs_c = np.abs(coeffs.detach().cpu().numpy().astype(np.complex128))
    z0 = torch.as_tensor(_newton_polygon_init(abs_c), device=coeffs.device)
    return aberth_roots(coeffs, z0, num_iters=num_iters)
