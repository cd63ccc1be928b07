"""Slow (ODE-style) AKNS scattering: monodromy matrices and phi/psi sweeps.

Port of ``fnft_tpu/ops/scatter.py`` (reference fnft__akns_scatter_matrix.c,
fnft__nse_scatter_bound_states.c) for every slow scheme: the CF family
(BO, CF4_2, CF4_3, CF5_3, CF6_4 and the 4SPLIT4 stage layouts), ES4 and
TES4. The D-axis recurrence is a product of per-step 2x2 matrices, each
vectorized over the K spectral points; torch has no ``associative_scan``,
so on every device prefix products are log-depth (Hillis-Steele) and full
products a pairwise tree. Derivatives ride along as pairs
(T, T') -> (U T, U' T + U T'). From ``_CHUNK_THRESHOLD`` steps on, the
phi/psi sweeps take the two-pass chunked route, which never holds the
``[S, K, 2, 2]`` trajectory. Signals ``[..., D_eff]`` may carry leading
batch axes, with the spectral points ``[..., K]`` of each signal beside
them: the step matrices are then ``[S, ..., K, 2, 2]``.
"""

from __future__ import annotations

import numpy as np
import torch

from fnft_tpu_torch.config import complex_dtype_of
from fnft_tpu_torch.models.discretization import (
    BOUNDARY_COEFF,
    Discretization,
    lambda_stage_weights,
    upsampling_factor,
)

_CF_FAMILY = (Discretization.BO, Discretization.CF4_2, Discretization.CF4_3,
              Discretization.CF5_3, Discretization.CF6_4,
              Discretization.SPLIT4A4, Discretization.SPLIT4B4)


def _stage_weight_per_step(disc: Discretization, d_eff: int, dtype, device):
    """Per-step lambda scaling: stage weights tiled over the sample axis."""
    w = lambda_stage_weights(disc)
    return torch.as_tensor(np.tile(w, d_eff // len(w)), device=device).to(dtype)


def _steps_first(x: torch.Tensor, width: int = 1) -> torch.Tensor:
    """``[..., S * width]`` samples as ``[S, ..., 1(, width)]``: steps along
    dim 0, a singleton axis where the K spectral points broadcast."""
    if width == 1:
        return x.movedim(-1, 0)[..., None]
    return x.reshape(*x.shape[:-1], -1, width).movedim(-2, 0)[..., None, :]


def _mm2(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """b @ a over [..., 2, 2] stacks as one broadcast product and one sum:
    torch.matmul sends batched 2x2 complex products to cuBLAS GEMM tiles,
    which dominated nsev's device time at large D (PERF.md), and writing
    the eight products out costs a dozen launches per product."""
    return (b[..., :, :, None] * a[..., None, :, :]).sum(dim=-2)


def _mv2(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m @ v for [..., 2, 2] matrices and [..., 2] vectors (broadcast)."""
    return (m * v[..., None, :]).sum(dim=-1)


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


def _pauli_exp(a1, a2, a3):
    """expm-style closed form used by ES4/TES4:
    U = c I + s [a3, a1 - i a2; a1 + i a2, -a3], w = sqrt(-a1^2-a2^2-a3^2).
    Returns (U, w, s, c)."""
    w = torch.sqrt(-(a1 * a1) - (a2 * a2) - (a3 * a3))
    small = torch.abs(w) < 1e-30
    s = torch.where(small, 1.0, torch.sin(w) / torch.where(small, 1.0, w))
    c = torch.cos(w)
    s, c, a1, a2, a3 = torch.broadcast_tensors(s, c, a1, a2, a3)
    U = torch.stack([
        torch.stack([c + s * a3, s * (a1 - 1j * a2)], dim=-1),
        torch.stack([s * (a1 + 1j * a2), c - s * a3], dim=-1),
    ], dim=-2)
    return U, w, s, c


def _es4_coeffs(q3, r3, eps_t):
    """Sample triplet [q, q', q''] -> Pauli coefficients
    (scatter_matrix.c:266-269)."""
    e3 = eps_t ** 3
    t0 = e3 * (q3[..., 2] + r3[..., 2]) / 48.0 + eps_t * (q3[..., 0] + r3[..., 0]) * 0.5
    t1 = (eps_t * (q3[..., 0] - r3[..., 0]) * 1j) * 0.5 + (e3 * (q3[..., 2] - r3[..., 2]) * 1j) / 48.0
    t2 = -e3 * (q3[..., 0] * r3[..., 1] - q3[..., 1] * r3[..., 0]) / 12.0
    return t0, t1, t2


def _es4_step(q3, r3, l, eps_t, *, derivative: bool, backward: bool = False):
    e3 = eps_t ** 3
    t0, t1, t2 = _es4_coeffs(q3, r3, eps_t)
    a1 = t0 + e3 * (l * 1j * (q3[..., 1] - r3[..., 1])) / 12.0
    a2 = t1 - e3 * l * (q3[..., 1] + r3[..., 1]) / 12.0
    a3 = -eps_t * 1j * l + t2
    if backward:
        a1, a2, a3 = -a1, -a2, -a3
    U, w, s, c = _pauli_exp(a1, a2, a3)
    if not derivative:
        return U, None
    # derivatives of (a1, a2, a3) w.r.t. lambda (sign flips with backward)
    d1 = 1j * e3 * (q3[..., 1] - r3[..., 1]) / 12.0
    d2 = -e3 * (q3[..., 1] + r3[..., 1]) / 12.0
    d3 = -1j * eps_t * torch.ones_like(a3)
    if backward:
        d1, d2, d3 = -d1, -d2, -d3
    w_safe = torch.where(w == 0, 1.0, w)
    w_d = -(a1 * d1 + a2 * d2 + a3 * d3) / w_safe
    c_d = -torch.sin(w) * w_d
    s_d = w_d * (c - s) / w_safe
    dU = torch.stack([
        torch.stack([c_d + s_d * a3 + s * d3,
                     s_d * a1 + s * d1 - 1j * (s_d * a2 + s * d2)], dim=-1),
        torch.stack([s_d * a1 + s * d1 + 1j * (s_d * a2 + s * d2),
                     c_d - s_d * a3 - s * d3], dim=-1),
    ], dim=-2)
    return U, dU


def _tes4_outer_coeffs(q3, r3, eps_t, *, backward: bool):
    """TES4 first/third factors (scatter_matrix.c:298-303, bound_states
    :165-183)."""
    e3, e2 = eps_t ** 3, eps_t ** 2
    sgn = -1.0 if backward else 1.0
    t1a = sgn * e3 * (q3[..., 2] + r3[..., 2]) / 96.0 - e2 * (q3[..., 1] + r3[..., 1]) / 24.0
    t1b = sgn * e3 * (q3[..., 2] - r3[..., 2]) * 1j / 96.0 + e2 * (r3[..., 1] - q3[..., 1]) * 1j / 24.0
    t2a = sgn * e3 * (q3[..., 2] + r3[..., 2]) / 96.0 + e2 * (q3[..., 1] + r3[..., 1]) / 24.0
    t2b = sgn * e3 * (q3[..., 2] - r3[..., 2]) * 1j / 96.0 + e2 * (q3[..., 1] - r3[..., 1]) * 1j / 24.0
    return (t1a, t1b), (t2a, t2b)


def _tes4_step(q3, r3, l, eps_t, *, derivative: bool, backward: bool = False):
    """TES4: product of three Pauli exponentials per step; only the middle
    factor depends on lambda (scatter_matrix.c:356-437)."""
    h = -eps_t if backward else eps_t
    (t1a, t1b), (t2a, t2b) = _tes4_outer_coeffs(q3, r3, eps_t,
                                                backward=backward)
    F1 = _pauli_exp(t1a, t1b, torch.zeros_like(t1a))[0]
    a1 = h * (q3[..., 0] + r3[..., 0]) * 0.5
    a2 = h * (q3[..., 0] * 1j - r3[..., 0] * 1j) * 0.5
    a3 = -h * l * 1j
    M, w, _, _ = _pauli_exp(a1, a2, a3)
    F3 = _pauli_exp(t2a, t2b, torch.zeros_like(t2a))[0]
    U = _mm2(_mm2(F3, M), F1)
    if not derivative:
        return U, None
    # middle-factor derivative as the reference has it, eps_t (not the
    # signed h) included: scatter_matrix.c:391-397
    w_safe = torch.where(w == 0, 1.0, w)
    s_d = torch.sin(w * eps_t) / w_safe
    c_d = -eps_t * l * s_d
    w_d = l * (eps_t * w * torch.cos(w * eps_t) - torch.sin(w * eps_t)) / (w_safe ** 3)
    w_d, q0, r0 = torch.broadcast_tensors(w_d, q3[..., 0], r3[..., 0])
    dM = torch.stack([
        torch.stack([c_d - 1j * s_d, w_d * q0], dim=-1),
        torch.stack([w_d * r0, c_d + 1j * s_d], dim=-1),
    ], dim=-2)
    return U, _mm2(_mm2(F3, dM), F1)


def _family_inputs(q, r, eps_t, disc):
    """(xs, step_fn, derivative scale) of a slow scheme. ``xs`` are the
    per-step inputs along dim 0 with a singleton axis where the K spectral
    points broadcast: ``[S, ..., 1]`` for the CF family (q, r, stage
    weight), ``[S, ..., 1, 3]`` sample triplets for ES4/TES4, ``...`` the
    batch axes of ``q``. ``step_fn(lam, *xs, derivative=, backward=)``
    gives all step matrices at once, ``U [S, ..., K, 2, 2]`` and dU/dlam
    (or None), in the order of ``xs`` (the caller reverses ``xs`` for a
    backward sweep)."""
    if disc in _CF_FAMILY:
        wsteps = _stage_weight_per_step(disc, q.shape[-1], q.dtype, q.device)
        wsteps = wsteps.reshape((-1,) + (1,) * q.dim())
        scl = 1.0 / len(lambda_stage_weights(disc))

        def step(lam, qn, rn, wn, *, derivative, backward=False):
            h = -eps_t if backward else eps_t
            return _cf_step_matrices(qn, rn, lam * wn, h,
                                     derivative=derivative)

        return (_steps_first(q), _steps_first(r), wsteps), step, scl
    if disc in (Discretization.ES4, Discretization.TES4):
        inner = _es4_step if disc is Discretization.ES4 else _tes4_step

        def step(lam, q3n, r3n, *, derivative, backward=False):
            return inner(q3n, r3n, lam, eps_t, derivative=derivative,
                         backward=backward)

        return (_steps_first(q, 3), _steps_first(r, 3)), step, 1.0
    raise ValueError(f"{disc} is not a slow discretization")


def _pair_combine(a, b):
    """Associative combine for (T, T') with later blocks on the left:
    (AB = B @ A, (AB)' = B' A + B A')."""
    am, ad = a
    bm, bd = b
    return _mm2(bm, am), _mm2(bd, am) + _mm2(bm, ad)


def _tree_product(u: torch.Tensor, du: torch.Tensor | None):
    """Log-depth product U[S-1] ... U[0] along dim 0 (and its derivative,
    None without ``du``), padding with identities to a power of two."""
    s = u.shape[0]
    s_pad = 1 << max(0, s - 1).bit_length()
    if s_pad != s:
        eye = torch.eye(2, dtype=u.dtype, device=u.device).expand(
            (s_pad - s,) + u.shape[1:])
        u = torch.cat([u, eye], dim=0)
        if du is not None:
            du = torch.cat([du, torch.zeros_like(eye)], dim=0)
    while u.shape[0] > 1:
        if du is None:
            u = _mm2(u[1::2], u[0::2])
        else:
            u, du = _pair_combine((u[0::2], du[0::2]), (u[1::2], du[1::2]))
    return u[0], (None if du is None else du[0])


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


def _all_step_matrices(xs, step_fn, lam, derivative: bool):
    """All step matrices at once, ``U [S, ..., K, 2, 2]`` and dU/dlam (or
    None): the JAX package's vmap of ``step_fn`` over the steps, which the
    port's step functions do in one call."""
    return step_fn(lam, *xs, derivative=derivative)


def _mat_scan(u: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products (later factors left) without
    derivatives."""
    return _prefix_product(u)[0]


def scatter_matrix(q, r, lam, eps_t: float, disc: Discretization, *,
                   derivative: bool = False):
    """Full-interval scattering matrix at each lambda.

    Args:
      q, r: effective-sample potentials ``[..., D_eff]``.
      lam: spectral points ``[..., K]`` (the same batch axes as ``q``).

    Returns ``T [..., K, 2, 2]``, and with ``derivative`` also ``dT/dlam
    [..., K, 2, 2]``, already multiplied by the CF stage scale (reference
    :207-210).
    """
    cdt = complex_dtype_of(q)
    q, r, lam = q.to(cdt), r.to(cdt), lam.to(cdt)
    xs, step_fn, scl = _family_inputs(q, r, eps_t, disc)
    t, td = _tree_product(*step_fn(lam, *xs, derivative=derivative))
    if derivative:
        return t, td * scl
    return t


def _pick_chunk_len(s: int, store_every: int) -> int:
    """Largest chunk length L = store_every * 2^k <= ~4096 dividing ``s``."""
    base = s // store_every
    g = 1
    while g * 2 <= max(1, 4096 // store_every) and base % (g * 2) == 0:
        g *= 2
    return g * store_every


# from this many steps on, the one-shot trajectory [S, K, 2, 2] is traded
# for the two-pass chunked sweeps below
_CHUNK_THRESHOLD = 1 << 15
# step matrices held at once by the chunked sweeps: that many chunks are
# worked as one batch, so few states cost few launches and many states
# little memory (2^21 complex128 matrices are 128 MiB)
_CHUNK_BATCH_MATRICES = 1 << 21


def _b_metric(phi_s, psi_s):
    """The error metric |log|phi2 psi1 / (psi2 phi1)||/2 (NaN -> inf) and
    the b candidate phi1/psi1 at stored samples (bound_states.c:642-654)."""
    b = phi_s[..., 0] / psi_s[..., 0]
    ratio = (phi_s[..., 1] / psi_s[..., 1]) / b
    metric = torch.abs(0.5 * torch.log(torch.abs(ratio)))
    return torch.where(torch.isnan(metric), torch.inf, metric), b


def _bound_states_chunked(xs, step_fn, lam, phi0, dphi0, psi_end, te, scl,
                          store_every: int, chunk_len: int, skip_b: bool):
    """Two-pass phi/psi sweeps with O(S/L + L) live matrices per state.

    The reference stores phi at all D+1 grid points in host RAM
    (fnft__nse_scatter_bound_states.c:29-668). Pass 1 reduces each
    length-L chunk to one transfer matrix (tree product) and prefix-scans
    the C = S/L chunk products; pass 2 re-derives the per-sample phi/psi
    values chunk by chunk and streams the argmin of the b error metric
    instead of holding the trajectories. Chunks are worked in batches of
    up to ``_CHUNK_BATCH_MATRICES`` step matrices.
    """
    k = lam.numel()
    c_num = xs[0].shape[0] // chunk_len
    batch = max(1, _CHUNK_BATCH_MATRICES // (chunk_len * k))

    def chunks(c0, reverse=False):
        """Inputs of chunks c0 .. c0+batch-1 as ``[L, G, 1(, 3)]``, steps
        along dim 0; with ``reverse`` the chunks of the reversed step
        sequence."""
        out = []
        for x in xs:
            x = x.flip(0) if reverse else x
            x = x.reshape((c_num, chunk_len) + x.shape[1:])
            out.append(x[c0:c0 + batch].transpose(0, 1))
        return out

    def chunk_products(derivative, backward):
        ms, dms = [], []
        for c0 in range(0, c_num, batch):
            u, du = step_fn(lam, *chunks(c0, reverse=backward),
                            derivative=derivative, backward=backward)
            m, dm = _tree_product(u, du)
            ms.append(m)
            dms.append(dm)
        return torch.cat(ms), (torch.cat(dms) if derivative else None)

    # ---- pass 1 forward: chunk products with derivative -----------------
    pm, pd = _prefix_product(*chunk_products(True, False))
    phi_end = _mv2(pm[-1], phi0)
    dphi_end = _mv2(pd[-1], phi0) + _mv2(pm[-1], dphi0)
    e_te = torch.exp(1j * lam * te)
    a = phi_end[..., 0] * e_te
    aprime = scl * (dphi_end[..., 0] * e_te + (1j * te) * a)
    if skip_b:
        return a, aprime, torch.zeros_like(a)

    # phi at each chunk's left edge (grid position c*L)
    phi_b = torch.cat([phi0[None], _mv2(pm[:-1], phi0)])

    # ---- pass 1 backward: psi chunk products ----------------------------
    qm, _ = _prefix_product(chunk_products(False, True)[0])
    # psi at position S - c*L, i.e. each forward chunk's RIGHT edge
    psi_right = torch.cat([psi_end[None], _mv2(qm[:-1], psi_end)]).flip(0)
    psi0 = _mv2(qm[-1], psi_end)                           # position 0

    # ---- pass 2: stream the per-sample error metric ---------------------
    best_m, best_b = _b_metric(phi0, psi0)
    for c0 in range(0, c_num, batch):
        xc = chunks(c0)
        u, _ = step_fn(lam, *xc, derivative=False)
        phi_vals = _mv2(_prefix_product(u)[0], phi_b[c0:c0 + batch])
        ub, _ = step_fn(lam, *(x.flip(0) for x in xc), derivative=False,
                        backward=True)
        psi_rc = psi_right[c0:c0 + batch]
        psi_rev = _mv2(_prefix_product(ub)[0], psi_rc)     # (c+1)L-1 .. cL
        psi_vals = torch.cat([psi_rev.flip(0)[1:], psi_rc[None]])
        # [L/se, G, ..., K, 2] -> samples in time order along dim 0
        phi_s = phi_vals[store_every - 1::store_every].transpose(0, 1)
        psi_s = psi_vals[store_every - 1::store_every].transpose(0, 1)
        metric, bc = _b_metric(phi_s.reshape(-1, *lam.shape, 2),
                               psi_s.reshape(-1, *lam.shape, 2))
        j = torch.argmin(metric, dim=0)[None, :]
        m_loc = torch.take_along_dim(metric, j, dim=0)[0]
        b_loc = torch.take_along_dim(bc, j, dim=0)[0]
        better = m_loc < best_m
        best_m = torch.where(better, m_loc, best_m)
        best_b = torch.where(better, b_loc, best_b)
    return a, aprime, best_b


def scatter_bound_states(q, r, lam, eps_t: float, t0: float, t1: float,
                         disc: Discretization, *, skip_b: bool = False):
    """a(lam), a'(lam) and b(lam) at bound states via phi/psi sweeps.

    phi scatters forward from T[0], its value kept at every original
    sample; psi scatters backward from T[1]; b is read off at the grid
    point minimizing |log| phi2 psi1 / (psi2 phi1)||/2 (the error metric of
    DOI 10.1109/ACCESS.2019.2932256; reference bound_states.c:642-654).
    With ``skip_b`` only the full products are formed (a pairwise tree
    instead of the trajectory). ``q, r [..., D_eff]`` and ``lam [..., K]``
    share their leading batch axes.

    Returns (a, a_prime, b), each ``[..., K]``.
    """
    cdt = complex_dtype_of(q)
    q, r, lam = q.to(cdt), r.to(cdt), lam.to(cdt)
    xs, step_fn, scl = _family_inputs(q, r, eps_t, disc)
    store_every = upsampling_factor(disc) if disc in _CF_FAMILY else 1
    tb = t0 - eps_t * BOUNDARY_COEFF
    te = t1 + eps_t * BOUNDARY_COEFF
    zeros = torch.zeros_like(lam)
    e_te = torch.exp(1j * lam * te)
    phi0 = torch.stack([torch.exp(-1j * lam * tb), zeros], dim=-1)
    dphi0 = torch.stack([phi0[..., 0] * (-1j * tb), zeros], dim=-1)
    psi_end = torch.stack([zeros, e_te], dim=-1)

    s_len = xs[0].shape[0]
    chunk_len = _pick_chunk_len(s_len, store_every)
    if s_len >= _CHUNK_THRESHOLD and chunk_len >= 256 * store_every:
        return _bound_states_chunked(xs, step_fn, lam, phi0, dphi0, psi_end,
                                     te, scl, store_every, chunk_len, skip_b)

    u, du = step_fn(lam, *xs, derivative=True)
    if skip_b:
        pm_end, pd_end = _tree_product(u, du)
    else:
        pm, pd = _prefix_product(u, du)
        pm_end, pd_end = pm[-1], pd[-1]
    phi_end = _mv2(pm_end, phi0)
    dphi_end = _mv2(pd_end, phi0) + _mv2(pm_end, dphi0)
    a = phi_end[..., 0] * e_te
    aprime = scl * (dphi_end[..., 0] * e_te + (1j * te) * a)
    if skip_b:
        return a, aprime, torch.zeros_like(a)

    # trajectories at the original grid points: [D_given + 1, ..., K, 2]
    phi_samples = torch.cat(
        [phi0[None], _mv2(pm[store_every - 1::store_every], phi0)])
    ub, _ = step_fn(lam, *(x.flip(0) for x in xs), derivative=False,
                    backward=True)
    rm, _ = _prefix_product(ub)
    psi_samples = torch.cat(
        [psi_end[None], _mv2(rm[store_every - 1::store_every], psi_end)]
    ).flip(0)

    metric, b_all = _b_metric(phi_samples, psi_samples)
    n_best = torch.argmin(metric, dim=0)[None]          # [1, ..., K]
    return a, aprime, torch.take_along_dim(b_all, n_best, dim=0)[0]
