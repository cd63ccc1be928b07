"""Time-axis (D) sharding of the fast NFT over a mesh of ranks.

Port of ``fnft_tpu/parallel/dshard.py``: sequence parallelism for the
O(D log^2 D) pipeline (the sequential tree it distributes is
fnft__poly_fmult.c:381-546):

* the D samples are split into S contiguous time chunks, one per rank on
  the ``seq`` mesh axis;
* each rank builds its per-sample transfer matrices and runs the FFT tree
  (K1 in its first levels) **only on its chunk**;
* each rank chirp-Z-evaluates its chunk polynomial at the M spectral
  points, and the ordered product ``H(xi) = P_{S-1}(xi) @ ... @ P_0(xi)`` is
  composed **in value space** by a log2(S)-step butterfly of pairwise
  exchanges (:meth:`MeshAxis.ppermute_xor`), with a power-of-two rescale
  per step (the reference's 2^W normalization, fnft__poly_fmult.c:123-150,
  carried as an integer exponent);
* each rank keeps its M/S block of the result.

Every rank calls the ``make_*`` function with the same arguments and then
the returned function on the full signal (or, through ``.local``, on its
own block). The 4SPLIT4A/B schemes gather q once for the CF-stage
resample. The butterfly is differentiable (the exchange's backward sends
the cotangent back), so a loss on the blocks trains the signal's chunks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fnft_tpu_torch.config import complex_dtype_of
from fnft_tpu_torch.errors import check_arg
from fnft_tpu_torch.models import nse
from fnft_tpu_torch.models.discretization import (
    BOUNDARY_COEFF,
    Discretization,
    degree,
    is_fast,
    upsampling_factor,
)
from fnft_tpu_torch.models.nsev import (
    ContspecType,
    _apply_phase_factors,
    _as_signal,
    _chirpz_points,
)
from fnft_tpu_torch.ops.fscatter import transfer_matrix_coeffs
from fnft_tpu_torch.ops.poly import _pow2, chirpz, fmult2x2_tree
from fnft_tpu_torch.ops.scatter import _mm2
from fnft_tpu_torch.parallel.mesh import MeshAxis, as_auto_mesh


def _value_renorm(v: torch.Tensor, w: torch.Tensor):
    """Rescale a ``[..., M, 2, 2]`` value stack by 2^-floor(log2(max|v|))
    and fold the exponent into ``w`` (the JAX package's rule, kept so that
    the replica and the sharded run do the same floating-point work)."""
    with torch.no_grad():
        max_abs = torch.abs(v).amax(dim=(-3, -2, -1))
        safe = torch.where(max_abs > 0, max_abs, 1.0)
        a_exp = torch.where(max_abs > 0, torch.floor(torch.log2(safe)),
                            0.0).to(torch.int32)
    v = v * _pow2(-a_exp, max_abs.dtype)[..., None, None, None]
    return v, w + a_exp


def _butterfly_fold(v: torch.Tensor, w: torch.Tensor, seq: MeshAxis):
    """Ordered product over the seq axis of each rank's ``[..., M, 2, 2]``
    values: after log2(S) exchanges every rank holds
    ``V_{S-1} @ ... @ V_0`` and the summed exponent. Later time chunks
    multiply from the left: the rank whose ``bit`` is set takes
    ``v @ v_in``."""
    for k in range(int(math.log2(seq.size))):
        bit = 1 << k
        v_in = seq.ppermute_xor(v, bit)
        w_in = seq.ppermute_xor(w, bit)
        v = _mm2(v, v_in) if seq.index & bit else _mm2(v_in, v)
        v, w = _value_renorm(v, w + w_in)
    return v, w


def _seq_axis(mesh, seq_axis: str, d: int, m: int) -> MeshAxis:
    seq = MeshAxis(as_auto_mesh(mesh), seq_axis)
    s = seq.size
    if d % s or m % s:
        raise ValueError(f"D={d} and M={m} must be divisible by the "
                         f"'{seq_axis}' mesh size {s}")
    if s & (s - 1):
        raise ValueError(f"the '{seq_axis}' mesh size {s} must be a power "
                         f"of two (butterfly)")
    return seq


def _grid(t_span, xi_span, d, m):
    t0, t1 = float(t_span[0]), float(t_span[1])
    xi0, xi1 = float(xi_span[0]), float(xi_span[1])
    check_arg(d >= 2 and t0 < t1, "D >= 2 and T[0] < T[1] required")
    check_arg(m >= 2 and xi0 < xi1, "M >= 2 and XI[0] < XI[1] required")
    return t0, t1, xi0, xi1, (t1 - t0) / (d - 1)


def _sharded_run(local, seq, batch, device):
    """``run(q)``: this rank's block of the full ``q`` (rows of the batch
    axis, if any, then the time chunk) through ``local``."""
    def run(q):
        q = _as_signal(q, device)
        if batch is not None:
            q = batch.block(q, 0)
        return local(seq.block(q))

    run.local = local
    return run


def make_dshard_contspec(d: int, t_span, m: int, xi_span, mesh, *,
                         kappa: int = +1,
                         disc: Discretization = Discretization.SPLIT4B,
                         seq_axis: str = "seq", batch_axis: str | None = None,
                         contspec_type=ContspecType.REFLECTION_COEFFICIENT,
                         device=None):
    """A D-sharded contspec ``q[..., D] -> dict of [..., M/S]``.

    The returned function takes the full signal (with ``batch_axis`` a
    batch ``[B, D]`` whose rows split over that axis) and gives this
    rank's M/S block of each spectrum; ``run.local`` takes this rank's
    block ``[..., D/S]`` itself. ``device`` is where an array input goes
    (default: the CUDA device)."""
    check_arg(is_fast(disc),
              f"dshard supports fast (polynomial) schemes; got {disc}")
    ups = upsampling_factor(disc)
    seq = _seq_axis(mesh, seq_axis, d, m)
    batch = None if batch_axis is None else MeshAxis(mesh, batch_axis)
    t0, t1, xi0, xi1, eps_t = _grid(t_span, xi_span, d, m)
    a_pt, w_pt = _chirpz_points(eps_t, xi0, xi1, m, disc)

    def local(q_loc):
        q_loc = q_loc.to(complex_dtype_of(q_loc))
        if ups == 1:
            q_eff, r_eff = q_loc, -kappa * torch.conj(q_loc)
        else:
            # 4SPLIT4A/B (CF4_2 stages): the stage construction resamples
            # the whole signal, so gather q once, build the stages
            # replicated and keep this rank's ups*D/S stage samples (stages
            # are interleaved per sample, so chunk boundaries align)
            q_full = seq.all_gather(q_loc, dim=-1, tiled=True)
            qe, re, _, _ = nse.preprocess_signal(q_full, eps_t, kappa, disc)
            q_eff, r_eff = seq.block(qe), seq.block(re)
        p = transfer_matrix_coeffs(q_eff, r_eff, eps_t, disc)
        tm, w = fmult2x2_tree(p, normalize=True, jsym=kappa)
        v = _chunk_values(tm, a_pt, w_pt, m)
        v, w = _butterfly_fold(*_value_renorm(v, w), seq)
        cs = _apply_phase_factors(v[..., 0, 0], v[..., 1, 0], w, eps_t, t0,
                                  t1, d, xi0, xi1, m, disc, contspec_type)
        return {k: seq.block(val) for k, val in cs.items()}

    return _sharded_run(local, seq, batch, device)


def _chunk_values(tm, a_pt, w_pt, m):
    """Chirp-Z values ``[..., M, 2, 2]`` of the chunk polynomials
    ``tm [..., 2, 2, c]`` (all four entries)."""
    c = tm.shape[-1]
    vals = chirpz(tm.reshape(tm.shape[:-3] + (4, c)), a_pt, w_pt, m)
    return vals.movedim(-2, -1).reshape(tm.shape[:-3] + (m, 2, 2))


def dshard_contspec_reference(
        q, d: int, t_span, m: int, xi_span, *, kappa: int = +1,
        disc: Discretization = Discretization.SPLIT4B, s: int = 8,
        contspec_type=ContspecType.REFLECTION_COEFFICIENT, device=None):
    """Single-process replica of the sharded math: the same chunk trees
    (the S chunks a leading axis) and the same butterfly, done by indexing
    instead of exchanges, so an S-rank run of :func:`make_dshard_contspec`
    can be held against it."""
    t0, t1, xi0, xi1, eps_t = _grid(t_span, xi_span, d, m)
    check_arg(s >= 1 and not s & (s - 1) and d % s == 0,
              f"S={s} must be a power of two dividing D={d}")
    a_pt, w_pt = _chirpz_points(eps_t, xi0, xi1, m, disc)
    q = _as_signal(q, device)
    q_eff, r_eff, _, _ = nse.preprocess_signal(q, eps_t, kappa, disc)
    # [..., S, ups*D/S]: stage samples are interleaved per original sample,
    # so contiguous chunks align with the sharded fold's time chunks
    qs = q_eff.unflatten(-1, (s, -1))
    p = transfer_matrix_coeffs(qs, r_eff.unflatten(-1, (s, -1)), eps_t, disc)
    tm, w = fmult2x2_tree(p, normalize=True, jsym=kappa)  # [..., S, 2, 2, c]
    v, w = _value_renorm(_chunk_values(tm, a_pt, w_pt, m), w)
    idx = torch.arange(s, device=v.device)
    for k in range(int(math.log2(s))):
        bit = 1 << k
        v_in = v.index_select(-4, idx ^ bit)
        w_in = w.index_select(-1, idx ^ bit)
        upper = ((idx & bit) != 0)[:, None, None, None]
        v = torch.where(upper, _mm2(v, v_in), _mm2(v_in, v))
        v, w = _value_renorm(v, w + w_in)
    v0 = v.select(-4, 0)
    return _apply_phase_factors(v0[..., 0, 0], v0[..., 1, 0], w[..., 0],
                                eps_t, t0, t1, d, xi0, xi1, m, disc,
                                contspec_type)


# ---------------------------------------------------------------------------
# D-sharded KdV contspec (reference fnft_kdvv.c:129-204 semantics)
# ---------------------------------------------------------------------------

def make_dshard_kdvv_contspec(d: int, t_span, m: int, xi_span, mesh, *,
                              disc: Discretization = Discretization.SPLIT8B,
                              seq_axis: str = "seq",
                              batch_axis: str | None = None,
                              rsym: bool = True, device=None):
    """A D-sharded KdV contspec ``u[..., D] -> {"rho": [..., M/S]}``.

    The chunk trees and butterfly of :func:`make_dshard_contspec` with the
    KdV kernel: r = -1 per sample, real-coefficient (``rsym``) chunk
    trees, evaluation at the negated grid z(-xi), and the reference's
    reflection formula rho = e^{2i xi' (T1+eps/2)} H12 / (2i xi' H22 - H12),
    xi' = -xi (fnft_kdvv.c:129-204; the 2SPLIT2A sqrt-z fix of :186-195).
    ``rsym=False`` only if ``u`` may be complex."""
    check_arg(is_fast(disc) and upsampling_factor(disc) == 1,
              f"kdvv dshard supports fast ups=1 schemes; got {disc}")
    seq = _seq_axis(mesh, seq_axis, d, m)
    batch = None if batch_axis is None else MeshAxis(mesh, batch_axis)
    _, t1, xi0, xi1, eps_t = _grid(t_span, xi_span, d, m)
    eps_xi = (xi1 - xi0) / (m - 1)
    deg1 = degree(disc)
    a_pt = complex(np.exp(-2j * xi0 * eps_t / deg1))
    w_pt = complex(np.exp(-2j * eps_xi * eps_t / deg1))

    def local(u_loc):
        u = u_loc.to(complex_dtype_of(u_loc))
        p = transfer_matrix_coeffs(u, -torch.ones_like(u), eps_t, disc)
        tm, w = fmult2x2_tree(p, normalize=True, rsym=rsym)
        v, w = _butterfly_fold(*_value_renorm(
            _chunk_values(tm, a_pt, w_pt, m), w), seq)
        h12, h22 = v[..., 0, 1], v[..., 1, 1]
        xi_neg = -(xi0 + eps_xi * torch.arange(m, dtype=v.real.dtype,
                                               device=v.device))
        if disc is Discretization.SPLIT2A:
            # undo the first-order-polynomial trick (fnft_kdvv.c:186-195)
            h12 = h12 / torch.exp(1j * xi_neg * (eps_t / deg1))
        num = torch.exp(2j * xi_neg * (t1 + BOUNDARY_COEFF * eps_t)) * h12
        rho = num / (2j * xi_neg * h22 - h12)   # the shared 2^w cancels
        return {"rho": seq.block(rho)}

    return _sharded_run(local, seq, batch, device)


# ---------------------------------------------------------------------------
# Grid-sharded chirp-Z: each rank computes only its M/S spectral points
# ---------------------------------------------------------------------------

def chirpz_block_tables(a: complex, w: complex, n: int, m: int,
                        s: int) -> list:
    """Start points ``a_j = a * w**(j * M/S)`` of the S contiguous blocks
    of an M-point spiral, computed in extended precision on the host."""
    m_loc = m // s
    theta_w = np.longdouble(math.atan2(w.imag, w.real))
    log_w = np.longdouble(0.0 if abs(w) == 1.0 else math.log(abs(w)))
    theta_a = np.longdouble(math.atan2(a.imag, a.real))
    log_a = np.longdouble(0.0 if abs(a) == 1.0 else math.log(abs(a)))
    out = []
    for j in range(s):
        e = np.longdouble(j * m_loc)
        phase = float(np.mod(theta_a + e * theta_w,
                             np.longdouble(2 * math.pi)))
        mag = float(np.exp(log_a + e * log_w))
        out.append(complex(mag * math.cos(phase), mag * math.sin(phase)))
    return out


def make_gridsharded_chirpz(n: int, a: complex, w: complex, m: int, mesh, *,
                            grid_axis: str = "seq"):
    """An M-sharded chirp-Z ``coeffs[..., n] -> values[..., M/S]``: the
    coefficients are replicated, and each rank evaluates only its own
    block of the spiral, from its start point ``a_j``
    (:func:`chirpz_block_tables`)."""
    grid = MeshAxis(as_auto_mesh(mesh), grid_axis)
    if m % grid.size:
        raise ValueError(f"M={m} must be divisible by mesh axis size "
                         f"{grid.size}")
    a_mine = chirpz_block_tables(a, w, n, m, grid.size)[grid.index]
    m_loc = m // grid.size

    def fn(coeffs):
        return chirpz(coeffs, a_mine, w, m_loc)

    return fn
