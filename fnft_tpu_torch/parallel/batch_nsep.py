"""Batched (quasi-)periodic NFT: main/aux spectra of q[B, D].

Port of ``fnft_tpu/parallel/batch_nsep.py``, the serving analogue of
``models.nsep``'s SUBSAMPLE_AND_REFINE localization (reference
fnft_nsep.c:441-705). Every signal returns ``deg`` candidate points per
spine value and ``deg`` auxiliary ones, with validity masks; the caller
compacts at the boundary or reads the masks. Pipeline per batch:

  remove each signal's quasi-periodic phase -> subsampled monodromy
  polynomials (batched FFT tree, K1) -> one Aberth run over every spine
  value's shifted polynomial AND the aux polynomial of every signal, the
  B (nvals + 1) rows sharing each sweep (K2 in one launch above 4096
  roots) -> in-box masking -> lock-step multiplicity-aware Newton against
  the full-resolution monodromy (``models.nsep``'s sweeps over a batched
  evaluator, in lambda slices of at most 2^21 step matrices; masked-out
  and frozen points stay as they are and are left out of the
  evaluations) -> masked results.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from fnft_tpu_torch.config import complex_dtype_of, eps_of, real_dtype_of
from fnft_tpu_torch.errors import check_arg
from fnft_tpu_torch.models import nse
from fnft_tpu_torch.models.discretization import (
    Discretization,
    degree,
    z_to_lambda,
)
from fnft_tpu_torch.models.nsep import (
    _auto_box,
    _auxspec_newton_sweep,
    _eval_b,
    _eval_floquet,
    _mainspec_newton_sweep,
    _monodromy_poly,
)
from fnft_tpu_torch.models.nsev import _array_device
from fnft_tpu_torch.ops.fscatter import fscatter
from fnft_tpu_torch.ops.poly import _pow2
from fnft_tpu_torch.ops.roots import aberth_roots, newton_polygon_init
from fnft_tpu_torch.parallel.sharding import _as_batch, _batch_sharded
from fnft_tpu_torch.utils import misc


@dataclasses.dataclass
class BatchedNsepResult:
    main_spectrum: torch.Tensor      # [B, nvals * deg]
    main_mask: torch.Tensor          # [B, nvals * deg] bool
    aux_spectrum: torch.Tensor       # [B, deg]
    aux_mask: torch.Tensor           # [B, deg] bool


def make_batched_nsep_fn(d: int, t_span, *, kappa: int = +1,
                         disc: Discretization = Discretization.SPLIT2A,
                         dsub: int = 0, floquet_range=(-1.0, 1.0),
                         points_per_spine: int = 2, max_evals: int = 20,
                         num_aberth_iters: int = 80, mesh=None,
                         device=None):
    """A batched nsep ``(q[B, D], lam_shift[B]) -> (main, main mask, aux,
    aux mask)``, ``lam_shift`` the spectral shift of each quasi-periodic
    signal (:func:`batched_nsep` takes phase shifts). ``device`` is where
    array inputs go (default: the CUDA device; raises without one). With
    ``mesh`` each rank refines its rows of the ``"batch"`` axis and
    returns the full batch."""
    dev = _array_device(device)
    t0, t1 = float(t_span[0]), float(t_span[1])
    check_arg(d >= 2 and (d & (d - 1)) == 0, "D must be a power of two")
    check_arg(t0 < t1, "T[0] < T[1] required")
    check_arg(kappa in (-1, 1), "kappa must be +-1")
    check_arg(degree(disc) > 0,
              "nsep requires a fast (polynomial) discretization")
    eps_t = (t1 - t0) / d
    nvals = points_per_spine
    rhs0, rhs1 = floquet_range
    step = (rhs1 - rhs0) / (nvals - 1) if nvals > 1 else 0.0
    rhs_vals = 2.0 * (rhs0 + step * np.arange(nvals))
    dsub_target = dsub or int(
        2.0 ** math.ceil(0.5 * math.log2(d * math.log2(d) ** 2)))
    base = nse.newton_base_discretization(disc)
    map_coeff = 2.0 / degree(disc)

    def fn(q_batch, lam_shift):
        q = _as_batch(q_batch, dev)
        check_arg(q.shape[-1] == d, f"the geometry has D={d}, got "
                  f"{q.shape[-1]} samples")
        lam_shift = torch.as_tensor(lam_shift, device=q.device).to(
            real_dtype_of(complex_dtype_of(q)))
        return sharded(q, lam_shift)

    def rows(q, lam_shift):
        cdt = complex_dtype_of(q)
        rdt = real_dtype_of(cdt)
        b = q.shape[0]
        tgrid = t0 + eps_t * torch.arange(d, dtype=rdt, device=q.device)
        q_pre = q.to(cdt) * torch.exp(2j * lam_shift[:, None] * tgrid)

        q_eff, r_eff, _, _ = nse.preprocess_signal(q_pre, eps_t, kappa, disc)
        qs_eff, rs_eff, dsub_act, _ = nse.preprocess_signal(
            q_pre, eps_t, kappa, disc, dsub_target)
        eps_sub = (d // dsub_act) * eps_t
        tm, w = fscatter(qs_eff, rs_eff, eps_sub, disc,
                         want=((0, 0), (0, 1)), jsym=kappa)
        deg = tm.shape[-1] - 1
        box = _auto_box(eps_sub, map_coeff)

        # every spine value's shifted polynomial and the aux polynomial of
        # every signal: [B, nvals + 1, deg + 1], one Aberth run
        p = _monodromy_poly(tm[..., 0, 0, :])
        rhs_t = torch.as_tensor(rhs_vals, device=q.device).to(rdt)
        p_all = p[:, None, :].repeat(1, nvals, 1)
        p_all[..., deg // 2] = (p[:, None, deg // 2]
                                - rhs_t * _pow2(-w, rdt)[:, None])
        polys = torch.cat([p_all, tm[:, None, 0, 1, :]], dim=1)
        rows = polys.reshape(-1, deg + 1)
        roots = aberth_roots(rows, newton_polygon_init(rows),
                             num_iters=num_aberth_iters)
        lam_all = z_to_lambda(roots, eps_sub, disc).reshape(b, nvals + 1, deg)
        in_box = misc.filter_mask(lam_all, box)

        # lock-step Newton, models.nsep's sweeps (multiplicity line search,
        # final plain step on convergence) over the candidates of all
        # signals at once, masked-out points frozen from the start
        refine_tol = math.sqrt(eps_of(cdt))
        row_main = torch.arange(b, device=q.device).repeat_interleave(
            nvals * deg)
        lam_main = _mainspec_newton_sweep(
            lambda lam, idx: _eval_floquet(q_eff, r_eff, lam, eps_t, base,
                                           row_main[idx]),
            lam_all[:, :nvals].reshape(-1),
            -rhs_t.repeat_interleave(deg).repeat(b), refine_tol,
            max(1, (max_evals - 1) // 2),
            frozen=~in_box[:, :nvals].reshape(-1)).reshape(b, -1)
        row_aux = torch.arange(b, device=q.device).repeat_interleave(deg)
        lam_aux = _auxspec_newton_sweep(
            lambda lam, idx: _eval_b(q_eff, r_eff, lam, eps_t, base,
                                     row_aux[idx]),
            lam_all[:, nvals].reshape(-1), refine_tol, max_evals,
            frozen=~in_box[:, nvals].reshape(-1)).reshape(b, -1)
        # post filter: refined points must still be in the box
        mask_main = (in_box[:, :nvals].reshape(b, -1)
                     & misc.filter_mask(lam_main, box))
        mask_aux = in_box[:, nvals] & misc.filter_mask(lam_aux, box)
        return (lam_main + lam_shift[:, None], mask_main,
                lam_aux + lam_shift[:, None], mask_aux)

    sharded = _batch_sharded(rows, mesh)
    return fn


@functools.lru_cache(maxsize=32)
def _cached_nsep_fn(d, t_span, kappa, disc, device, mesh, kw_items):
    return make_batched_nsep_fn(d, t_span, kappa=kappa, disc=disc,
                                mesh=mesh, device=device, **dict(kw_items))


def batched_nsep(q_batch, t_span, *, phase_shifts=None, kappa: int = +1,
                 disc: Discretization = Discretization.SPLIT2A,
                 mesh=None, device=None, **kw) -> BatchedNsepResult:
    """Main/aux spectra of a batch of periodic signals ``q_batch [B, D]``
    (masked results), ``phase_shifts [B]`` for quasi-periodic ones.

    The function is cached per (D, t_span, config, device, mesh), so
    repeated serving calls reuse one. ``device`` is where an array input
    goes (default: the CUDA device; raises without one); ``mesh`` shards
    the batch over its ``"batch"`` axis; keyword arguments go to
    :func:`make_batched_nsep_fn`.
    """
    q = _as_batch(q_batch, device)
    b, d = q.shape
    t0, t1 = float(t_span[0]), float(t_span[1])
    rdt = real_dtype_of(complex_dtype_of(q))
    if phase_shifts is None:
        shifts = torch.zeros(b, dtype=rdt, device=q.device)
    else:
        shifts = (torch.as_tensor(phase_shifts, device=q.device).to(
            torch.float64) / (-2.0 * (t1 - t0))).to(rdt)
    kw_items = tuple(sorted(
        (k, tuple(v) if isinstance(v, (list, tuple)) else v)
        for k, v in kw.items()))
    fn = _cached_nsep_fn(d, (t0, t1), kappa, disc, q.device, mesh, kw_items)
    main, mmask, aux, amask = fn(q, shifts)
    return BatchedNsepResult(main_spectrum=main, main_mask=mmask,
                             aux_spectrum=aux, aux_mask=amask)
