"""Forward NFT for the (quasi-)periodic NSE: main and auxiliary spectra.

Port of ``fnft_tpu/models/nsep.py`` (reference fnft_nsep.c:82-864). The
main spectrum consists of the lambdas where the Floquet discriminant
Delta(lam) = trace of the monodromy matrix equals +-2 (more generally, the
values in ``floquet_range`` scaled by 2, which yields spines); the
auxiliary spectrum are the roots of the monodromy's upper-right entry.

Localization strategies, as in the reference:

* GRIDSEARCH — evaluate the monodromy polynomial on unit-circle arcs with
  the chirp transform and locate real-line spectrum by the 3x3 minimum-
  modulus test (``ops/gridsearch.py``; K1 in the full-D tree).
* SUBSAMPLE_AND_REFINE — Ehrlich-Aberth on the subsampled monodromy
  polynomials of every spine value and the aux polynomial in one batched
  run (K1 in the Dsub tree, K2 above 4096 roots), then vectorized Newton
  against the full-resolution monodromy.
* MIXED runs the second for the non-real spectrum and the first for the
  real line.

The Newton evaluators build the ``[S, K, 2, 2]`` step matrices of the base
scheme, so they take the K lambdas in slices of at most
``_LAM_BATCH_MATRICES`` step matrices, and the sweeps evaluate only the
points not yet frozen. A main-spectrum Newton sweep that does not converge
returns its iterate of least residual (:func:`_mainspec_newton_sweep`).
Quasi-periodic signals are handled by removing the phase rotation up front
and shifting the spectra back afterwards (reference :118-135, 200-213).
Results are tensors on the input's device.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import numpy as np
import torch

from fnft_tpu_torch.config import complex_dtype_of, eps_of, real_dtype_of
from fnft_tpu_torch.errors import check_arg
from fnft_tpu_torch.models import nse
from fnft_tpu_torch.models.discretization import (
    Discretization,
    degree,
    is_fast,
    upsampling_factor,
    z_to_lambda,
)
from fnft_tpu_torch.models.nsev import _as_signal
from fnft_tpu_torch.ops.fscatter import fscatter
from fnft_tpu_torch.ops.gridsearch import roots_fftgridsearch
from fnft_tpu_torch.ops.roots import (certified_tol, poly_roots_batched,
                                      root_residuals)
from fnft_tpu_torch.ops.scatter import scatter_matrix
from fnft_tpu_torch.utils import misc

OVERSAMPLING = 32  # grid points per polynomial degree (reference :43)
# step matrices the Newton evaluators hold at once: the K lambdas go
# through scatter_matrix in slices of at most this many [S] step stacks
# (2^21 complex128 matrices are 128 MiB), as the chunked phi/psi route
# batches its chunks (ops/scatter.py)
_LAM_BATCH_MATRICES = 1 << 21


class Localization(enum.Enum):          # fnft_nsep.h:54-58
    SUBSAMPLE_AND_REFINE = "subsample_and_refine"
    GRIDSEARCH = "gridsearch"
    MIXED = "mixed"


class PointFilter(enum.Enum):           # fnft_nsep.h:70-74
    NONE = "none"
    MANUAL = "manual"
    AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class NsepOpts:
    """Defaults mirror fnft_nsep_default_opts (fnft_nsep.c:27-41)."""

    localization: Localization = Localization.MIXED
    filtering: PointFilter = PointFilter.AUTO
    bounding_box: tuple = (-np.inf, np.inf, -np.inf, np.inf)
    max_evals: int = 20
    discretization: Discretization = Discretization.SPLIT2A
    floquet_range: tuple = (-1.0, 1.0)
    points_per_spine: int = 2
    normalization_flag: bool = True
    dsub: int = 0
    tol: float = -1.0  # negative = auto (sqrt machine eps)


@dataclasses.dataclass
class NsepResult:
    """Requested spectra as tensors on the input's device."""

    main_spectrum: Optional[torch.Tensor] = None
    aux_spectrum: Optional[torch.Tensor] = None


def _auto_box(eps_t: float, map_coeff: float) -> tuple:
    """Resolvable region of the z-map (reference :837-864)."""
    re = 0.9 * math.pi / (abs(map_coeff) * eps_t)
    im = -math.log(0.1) / (abs(map_coeff) * eps_t)
    return (-re, re, -im, im)


def _filter(vals: torch.Tensor, box) -> torch.Tensor:
    return vals[misc.filter_mask(vals, box)]


def _monodromy_poly(tm11: torch.Tensor) -> torch.Tensor:
    """p(z) ~ z^{deg/2} Delta(z): tm11 + conjugate-reversed tm11 (:319-320)."""
    return tm11 + torch.conj(tm11.flip(-1))


def _gridsearch(q_pre, eps_t, kappa, box, opts, want_main, want_aux):
    disc = opts.discretization
    q_eff, r_eff, _, _ = nse.preprocess_signal(q_pre, eps_t, kappa, disc)
    tm, w = fscatter(q_eff, r_eff, eps_t, disc,
                     normalize=opts.normalization_flag,
                     want=((0, 0), (0, 1)), jsym=kappa)
    deg = tm.shape[-1] - 1
    map_coeff = 2.0 / degree(disc)
    if opts.filtering is PointFilter.AUTO:
        box = _auto_box(eps_t, map_coeff)
    phi = sorted((map_coeff * eps_t * box[0], map_coeff * eps_t * box[1]))
    if not math.isfinite(phi[0]) or not math.isfinite(phi[1]):
        phi = [0.0, 2.0 * math.pi]
    m_grid = OVERSAMPLING * deg

    def circle_roots(coeffs):
        roots_z, mask = roots_fftgridsearch(
            coeffs, phi0=float(phi[0]), phi1=float(phi[1]), m=m_grid)
        lam = z_to_lambda(misc.compact_masked(roots_z, mask), eps_t, disc)
        if opts.filtering is not PointFilter.NONE:
            lam = _filter(lam, box)
        return lam

    main = aux = None
    if want_main:
        p = _monodromy_poly(tm[0, 0])
        scale = 2.0 ** (-int(w))
        p_plus, p_minus = p.clone(), p.clone()
        p_plus[deg // 2] += 2.0 * scale
        p_minus[deg // 2] -= 2.0 * scale
        main = torch.cat([circle_roots(p_plus), circle_roots(p_minus)])
    if want_aux:
        aux = circle_roots(tm[0, 1])
    return main, aux, box


def _sliced(evaluate, lam: torch.Tensor, steps: int, rows=None):
    """``evaluate(lam_s, rows_s)`` over ``lam`` (and the signal row of each
    point, ``rows``, or None) in slices of at most
    ``_LAM_BATCH_MATRICES // steps`` points; every lambda is independent,
    so the result is the one-slice result."""
    per = max(1, _LAM_BATCH_MATRICES // max(steps, 1))
    if lam.shape[0] <= per:
        return evaluate(lam, rows)
    parts = [evaluate(lam[k0:k0 + per],
                      None if rows is None else rows[k0:k0 + per])
             for k0 in range(0, lam.shape[0], per)]
    return tuple(torch.cat(x) for x in zip(*parts))


def _monodromy(q_eff, r_eff, lam, eps_t, base_disc, rows):
    """T and dT/dlam ``[K, 2, 2]`` of the full monodromy at ``lam [K]``:
    of the one signal ``q_eff [D_eff]``, or with ``rows [K]`` of the
    signal ``q_eff[rows[k]]`` of a batch ``[B, D_eff]`` at each point."""
    if rows is None:
        return scatter_matrix(q_eff, r_eff, lam, eps_t, base_disc,
                              derivative=True)
    t, td = scatter_matrix(q_eff[rows], r_eff[rows], lam[:, None], eps_t,
                           base_disc, derivative=True)
    return t[:, 0], td[:, 0]


def _eval_floquet(q_eff, r_eff, lam, eps_t, base_disc, rows=None):
    """(f, f') with f = Delta(lam) = T00 + T11 of the full monodromy (of
    ``q_eff[rows]`` with ``rows``, see :func:`_monodromy`)."""
    def evaluate(lam_s, rows_s):
        t, td = _monodromy(q_eff, r_eff, lam_s, eps_t, base_disc, rows_s)
        return t[:, 0, 0] + t[:, 1, 1], td[:, 0, 0] + td[:, 1, 1]
    return _sliced(evaluate, lam, q_eff.shape[-1], rows)


def _eval_b(q_eff, r_eff, lam, eps_t, base_disc, rows=None):
    """(f, f') with f = T01 of the full monodromy (of ``q_eff[rows]`` with
    ``rows``)."""
    def evaluate(lam_s, rows_s):
        t, td = _monodromy(q_eff, r_eff, lam_s, eps_t, base_disc, rows_s)
        return t[:, 0, 1], td[:, 0, 1]
    return _sliced(evaluate, lam, q_eff.shape[-1], rows)


def _mainspec_newton_sweep(floquet, lam0, rhs, tol, iters, frozen=None):
    """The reference's higher-order-root Newton with m in {1,2} line
    search (refine_mainspec, :707-793): ``iters`` iterations in lock step.

    ``floquet(lam, idx)`` gives ``(f, f')`` at the points ``lam`` of the
    candidates ``idx`` (int64 indices into ``lam0 [K]``). Points that are
    ``frozen`` from the start (default: none), or have frozen since, keep
    their values and are left out of the evaluations, which the JAX
    package makes and never reads: one host read an iteration finds the
    live points, and the sweep ends early once none is left.

    A point whose residual |f| never falls below ``tol`` comes back at its
    iterate of least residual, not at its last one as in the JAX package.
    At a fourfold point (the plane wave's spines crossing at -1.5) the
    full-resolution discriminant has no root within the sweep's reach, and
    the last step of such a sweep lands anywhere: a start 3e-6 away, the
    rounding of the fourfold root cluster on another device, moves it from
    -1.53-0.03i to -1.70-0.17i (``tests/test_torch_nsep.py``). Converged
    points are untouched.

    Parameterized over the evaluator so another evaluator of the monodromy
    (a batch of signals, e.g. a D-sharded one) shares one Newton body."""
    # match the pipeline dtype: a float64 rhs would promote the c64 carry
    rhs = torch.as_tensor(rhs, device=lam0.device).to(
        real_dtype_of(lam0.dtype)).expand(lam0.shape)
    frozen = (torch.zeros(lam0.shape, dtype=torch.bool, device=lam0.device)
              if frozen is None else frozen.clone())
    live = torch.nonzero(~frozen)[:, 0]
    f, fp = torch.zeros_like(lam0), torch.zeros_like(lam0)
    f_l, fp_l = floquet(lam0[live], live)
    f[live], fp[live] = f_l + rhs[live], fp_l
    lam, best, best_res = lam0.clone(), lam0.clone(), torch.abs(f)
    converged = torch.zeros_like(frozen)
    for _ in range(iters):
        if live.numel() == 0:
            break
        n = live.numel()
        lam_l, f_l, fp_l, rhs_l = lam[live], f[live], fp[live], rhs[live]
        incr = f_l / torch.where(fp_l == 0, 1.0, fp_l)
        fc, fpc = floquet(torch.cat([lam_l - incr, lam_l - 2 * incr]),
                          torch.cat([live, live]))
        fc = fc + torch.cat([rhs_l, rhs_l])
        f1, f2 = fc[:n], fc[n:]
        pick2 = torch.abs(f2) < torch.abs(f1)
        lam_new = torch.where(pick2, lam_l - 2 * incr, lam_l - incr)
        f_new = torch.where(pick2, f2, f1)
        fp_new = torch.where(pick2, fpc[n:], fpc[:n])
        # converged states take a final plain Newton step and freeze (:781-788)
        conv = torch.abs(f_new) < tol
        fp_new_safe = torch.where(fp_new == 0, 1.0, fp_new)
        better = torch.abs(f_new) < best_res[live]
        best[live] = torch.where(better, lam_new, best[live])
        best_res[live] = torch.where(better, torch.abs(f_new), best_res[live])
        lam[live] = torch.where(conv, lam_new - f_new / fp_new_safe, lam_new)
        f[live], fp[live], converged[live] = f_new, fp_new, conv
        frozen[live] = conv | (fp_new == 0)
        live = live[~frozen[live]]
    return torch.where(converged, lam, best)


def _auxspec_newton_sweep(evalb, lam0, tol, iters, frozen=None):
    """Plain Newton on ``(f, f') = evalb(lam, idx)`` with per-root freezing
    (refine_auxspec, :796-835): ``iters`` iterations; frozen points, those
    ``frozen`` from the start included, are left out as in
    :func:`_mainspec_newton_sweep`."""
    lam = lam0.clone()
    frozen = (torch.zeros(lam0.shape, dtype=torch.bool, device=lam0.device)
              if frozen is None else frozen.clone())
    live = torch.nonzero(~frozen)[:, 0]
    for _ in range(iters):
        if live.numel() == 0:
            break
        lam_l = lam[live]
        f, fp = evalb(lam_l, live)
        lam[live] = torch.where(fp == 0, lam_l,
                                lam_l - f / torch.where(fp == 0, 1.0, fp))
        frozen[live] = (torch.abs(f) < tol) | (fp == 0)
        live = live[~frozen[live]]
    return lam


def _refine_mainspec(q_eff, r_eff, lam0, eps_t, rhs, tol, max_evals,
                     base_disc):
    """Vectorized higher-order-root Newton (reference refine_mainspec,
    :707-793)."""
    if lam0.numel() == 0 or max_evals == 0:
        return lam0
    return _mainspec_newton_sweep(
        lambda lam, _: _eval_floquet(q_eff, r_eff, lam, eps_t, base_disc),
        lam0, rhs, tol, max(1, (max_evals - 1) // 2))


def _refine_auxspec(q_eff, r_eff, lam0, eps_t, tol, max_evals, base_disc):
    """Vectorized Newton on b(lam) (reference refine_auxspec, :796-835)."""
    if lam0.numel() == 0 or max_evals == 0:
        return lam0
    return _auxspec_newton_sweep(
        lambda lam, _: _eval_b(q_eff, r_eff, lam, eps_t, base_disc),
        lam0, tol, max_evals)


def _sr_localize(q_pre, eps_t, d, kappa, box, opts, want_main, want_aux,
                 skip_real):
    """S&R localization stage: subsampled fast monodromy, one batched
    Aberth run over all spines + aux, per-spine candidate pre-filtering
    and aux backward-error certification.

    Returns ``(lam_cat, rhs_cat, aux_lam, ctx)`` where ``lam_cat``/
    ``rhs_cat`` are the main-spectrum Newton candidates with per-point
    spine values, ``aux_lam`` the certified aux candidates, and ``ctx``
    a dict with q_eff/r_eff/box/refine_tol/base/max_evals/post_filter.
    ``lam_cat``/``aux_lam`` are None when not wanted.
    """
    disc = opts.discretization
    q_eff, r_eff, _, _ = nse.preprocess_signal(q_pre, eps_t, kappa, disc)

    dsub = opts.dsub
    if dsub == 0:
        dsub = int(2.0 ** math.ceil(0.5 * math.log2(d * math.log2(d) ** 2)))
    else:
        dsub = int(2.0 ** round(math.log2(dsub)))
    qs_eff, rs_eff, dsub_act, _ = nse.preprocess_signal(
        q_pre, eps_t, kappa, disc, dsub)
    eps_t_sub = (d // dsub_act) * eps_t

    tm, w = fscatter(qs_eff, rs_eff, eps_t_sub, disc,
                     normalize=opts.normalization_flag,
                     want=((0, 0), (0, 1)), jsym=kappa)
    deg = tm.shape[-1] - 1
    map_coeff = 2.0 / degree(disc)
    if opts.filtering is PointFilter.AUTO:
        box = _auto_box(eps_t_sub, map_coeff)
    tol_im = (box[1] - box[0]) / (OVERSAMPLING * (d - 1))
    cdt = complex_dtype_of(q_pre)
    refine_tol = math.sqrt(eps_of(cdt)) if opts.tol < 0 else opts.tol
    base = nse.newton_base_discretization(disc)
    assert q_eff.shape[-1] == d * upsampling_factor(disc)

    def post_filter(lam):
        if opts.filtering is not PointFilter.NONE:
            lam = _filter(lam, box)
        if skip_real:
            lam = lam[torch.abs(lam.imag) > tol_im]
        return lam

    # every spine value and the aux polynomial share one batched Aberth
    # run: the reference calls eiscor once per spine (fnft_nsep.c:556-608)
    rhs_vals = np.zeros(0)
    polys = []
    if want_main:
        p = _monodromy_poly(tm[0, 0])
        scale = 2.0 ** (-int(w))
        rhs0, rhs1 = opts.floquet_range
        nvals = opts.points_per_spine
        step = (rhs1 - rhs0) / (nvals - 1) if nvals > 1 else 0.0
        rhs_vals = 2.0 * (rhs0 + step * np.arange(nvals))
        p_all = p[None, :].repeat(nvals, 1)
        p_all[:, deg // 2] = p[deg // 2] - torch.as_tensor(
            rhs_vals, device=p.device).to(p.dtype) * scale
        polys.append(p_all)
    if want_aux:
        polys.append(tm[0, 1][None, :])
    ctx = dict(q_eff=q_eff, r_eff=r_eff, box=box, refine_tol=refine_tol,
               base=base, max_evals=opts.max_evals, post_filter=post_filter)
    if not polys:  # e.g. MIXED with kappa=-1 and want_aux=False
        return None, None, None, ctx
    roots_all = poly_roots_batched(torch.cat(polys))
    lam_all = z_to_lambda(roots_all.reshape(-1), eps_t_sub,
                          disc).reshape(roots_all.shape)

    lam_cat = rhs_cat = aux_lam = None
    if want_main:
        # pre-filter each spine's roots; every survivor goes into one
        # vectorized Newton call with a per-point rhs
        lam_parts = [post_filter(lam_all[k]) for k in range(len(rhs_vals))]
        lam_cat = torch.cat(lam_parts)
        rhs_cat = torch.cat([torch.full(lam.shape, -rhs_vals[k],
                                        dtype=torch.float64,
                                        device=lam.device)
                             for k, lam in enumerate(lam_parts)])
    if want_aux:
        # per-root backward-error certificate, in the pipeline dtype:
        # uncertified Aberth outputs (eta > O(deg*eps)) are spurious, and
        # the aux path has no spine cross-check, so drop them before Newton
        eta = root_residuals(tm[0, 1], roots_all[-1])
        aux_lam = lam_all[-1][eta <= certified_tol(deg, cdt)]
        if opts.filtering is not PointFilter.NONE:
            aux_lam = _filter(aux_lam, box)
    return lam_cat, rhs_cat, aux_lam, ctx


def _subsample_and_refine(q_pre, eps_t, d, kappa, box, opts, want_main,
                          want_aux, skip_real):
    lam_cat, rhs_cat, aux_lam, ctx = _sr_localize(
        q_pre, eps_t, d, kappa, box, opts, want_main, want_aux, skip_real)
    q_eff, r_eff = ctx["q_eff"], ctx["r_eff"]
    post_filter = ctx["post_filter"]
    main = aux = None
    if lam_cat is not None:
        main = post_filter(_refine_mainspec(
            q_eff, r_eff, lam_cat, eps_t, rhs_cat, ctx["refine_tol"],
            ctx["max_evals"], ctx["base"]))
    if aux_lam is not None:
        aux = post_filter(_refine_auxspec(
            q_eff, r_eff, aux_lam, eps_t, ctx["refine_tol"],
            ctx["max_evals"], ctx["base"]))
    return main, aux, ctx["box"]


def nsep(q, t_span, *, kappa: int = +1, phase_shift: float = 0.0,
         want_main: bool = True, want_aux: bool = True,
         opts: NsepOpts | None = None, device=None) -> NsepResult:
    """Main/auxiliary spectrum of a (quasi-)periodic signal.

    Args:
      q: samples on t_n = T0 + n*(T1-T0)/D, n = 0..D-1 (period T1-T0;
        the last sample is *before* T1). D must be a power of two. A
        tensor (the work runs on its device, in its precision) or an array.
      t_span: (T0, T1) — one period.
      kappa: +1 focusing / -1 defocusing.
      phase_shift: for quasi-periodic signals, arg(q(t+L)/q(t)).
      device: where an array ``q`` goes (default: the CUDA device; raises
        without one). A tensor ``q`` stays on its own device.
    """
    opts = opts or NsepOpts()
    q = _as_signal(q, device)
    d = q.shape[-1]
    check_arg(d >= 2 and (d & (d - 1)) == 0, "D must be a power of two")
    t0, t1 = float(t_span[0]), float(t_span[1])
    check_arg(t0 < t1, "T[0] < T[1] required")
    check_arg(kappa in (-1, 1), "kappa must be +-1")
    check_arg(is_fast(opts.discretization),
              "nsep requires a fast (polynomial) discretization")

    eps_t = (t1 - t0) / d
    lam_shift = phase_shift / (-2.0 * (t1 - t0))
    tgrid = t0 + eps_t * torch.arange(d, dtype=real_dtype_of(q.dtype),
                                      device=q.device)
    q_pre = q * torch.exp(2j * lam_shift * tgrid)

    box = list(opts.bounding_box)
    if opts.filtering is PointFilter.MANUAL:
        box[0] -= lam_shift
        box[1] -= lam_shift
    box = tuple(box)

    main = aux = None
    if opts.localization is Localization.MIXED:
        m1, a1, _ = _subsample_and_refine(
            q_pre, eps_t, d, kappa, box, opts,
            want_main and kappa == +1, want_aux, skip_real=True)
        m2, a2, _ = _gridsearch(q_pre, eps_t, kappa, box, opts, want_main,
                                want_aux)
        if want_main:
            main = torch.cat([x for x in (m1, m2) if x is not None])
        if want_aux:
            aux = torch.cat([x for x in (a1, a2) if x is not None])
    elif opts.localization is Localization.SUBSAMPLE_AND_REFINE:
        main, aux, _ = _subsample_and_refine(q_pre, eps_t, d, kappa, box,
                                             opts, want_main, want_aux,
                                             skip_real=False)
    elif opts.localization is Localization.GRIDSEARCH:
        main, aux, _ = _gridsearch(q_pre, eps_t, kappa, box, opts,
                                   want_main, want_aux)
    else:
        raise ValueError(opts.localization)

    return NsepResult(
        main_spectrum=None if main is None else main + lam_shift,
        aux_spectrum=None if aux is None else aux + lam_shift)
