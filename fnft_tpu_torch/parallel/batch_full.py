"""Batched full-spectrum forward NFT (contspec + bound states) of q[B, D],
and the batched inverse NFT.

Port of ``fnft_tpu/parallel/batch_full.py``. The per-signal driver
(``models.nsev``) compacts variable-length bound-state arrays on the
host; for batches every signal returns up to ``k_max`` bound states with
a validity mask, so the shapes are fixed. Pipeline per batch:

  fscatter (batched FFT tree, K1) -> chirp-Z contspec
  -> Aberth on each signal's subsampled a-polynomial, the rows sharing
     every sweep (K2 takes the batch in one launch above 4096 roots),
     from Newton-polygon starts (one host read of |coeffs|)
  -> in-box filtering + dedup as masked top-k selection (a stable
     descending sort: ties, -inf among them, go to the lower index as in
     XLA's top_k)
  -> masked Newton refinement against the full-resolution scattering
     (``niter`` fixed iterations, no host read)
  -> phi/psi sweeps for norming constants.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from fnft_tpu_torch.config import eps_of
from fnft_tpu_torch.errors import check_arg
from fnft_tpu_torch.models import nse
from fnft_tpu_torch.models.discretization import (
    Discretization,
    degree,
    z_to_lambda,
)
from fnft_tpu_torch.models.nsev import ContspecType, _array_device
from fnft_tpu_torch.ops.fscatter import fscatter
from fnft_tpu_torch.ops.roots import aberth_roots, newton_polygon_init
from fnft_tpu_torch.ops.scatter import scatter_bound_states
from fnft_tpu_torch.parallel.sharding import _as_batch, _ContspecPass
from fnft_tpu_torch.utils import misc


def make_batched_inverse_fn(d: int, t_span, m: int, *, kappa: int = +1,
                            disc: Discretization = Discretization.SPLIT2A,
                            contspec_type=None, device=None):
    """A batched inverse NFT ``rho[B, M] -> q[B, D]`` (contspec only; bound
    states are added per signal by ``models.nsev_inverse``). Returns
    ``(fn, xi_span)``, the canonical grid the contspec is sampled on.
    ``contspec_type`` is REFLECTION_COEFFICIENT (default) or B_OF_XI;
    ``device`` is where array inputs go (default: the CUDA device)."""
    from fnft_tpu_torch.models.nsev_inverse import (
        InverseContspecType,
        NsevInverseOpts,
        _build_tm_b_of_xi,
        _build_tm_reflection,
        nsev_inverse_xi_grid,
    )
    from fnft_tpu_torch.ops.finvscatter import finvscatter

    contspec_type = contspec_type or InverseContspecType.REFLECTION_COEFFICIENT
    check_arg(contspec_type in (InverseContspecType.REFLECTION_COEFFICIENT,
                                InverseContspecType.B_OF_XI),
              "the batched inverse takes the reflection coefficient or b(xi)")
    check_arg(d >= 2 and (d & (d - 1)) == 0, "D must be a power of two")
    check_arg(m % 2 == 0 and m >= d, "M must be even and >= D")
    dev = _array_device(device)
    t0, t1 = float(t_span[0]), float(t_span[1])
    xi_span = nsev_inverse_xi_grid(d, t_span, m, disc)
    eps_t = (t1 - t0) / (d - 1)
    deg = d * degree(disc)
    opts = NsevInverseOpts(discretization=disc, contspec_type=contspec_type)
    build = (_build_tm_b_of_xi
             if contspec_type is InverseContspecType.B_OF_XI
             else _build_tm_reflection)

    def fn(contspec):
        cs = _as_batch(contspec, dev)
        check_arg(cs.shape[-1] == m, f"the grid has M={m}, got "
                  f"{cs.shape[-1]} points")
        tm = build(cs, xi_span, m, d, t0, t1, deg, kappa, disc, opts)
        return finvscatter(tm, eps_t, kappa, disc)

    return fn, xi_span


@dataclasses.dataclass
class BatchedNsevResult:
    rho: Optional[torch.Tensor]            # [B, M]
    a: Optional[torch.Tensor]              # [B, M]
    b: Optional[torch.Tensor]              # [B, M]
    bound_states: torch.Tensor             # [B, k_max]
    bound_state_mask: torch.Tensor         # [B, k_max] bool
    norming_constants: torch.Tensor        # [B, k_max]


def _masked_newton(q_eff, r_eff, lam, mask, eps_t, t0, t1, disc, niter, box):
    """``niter`` Newton steps on a(lam) for ``lam [B, k]``; a point stops
    once unmasked, its step is below 100 eps, or it left the box."""
    eprec = 100.0 * eps_of(lam.dtype)
    active = mask
    for _ in range(niter):
        a, ap, _ = scatter_bound_states(q_eff, r_eff, lam, eps_t, t0, t1,
                                        disc, skip_b=True)
        step = torch.where((a == 0) | (ap == 0), 0.0,
                           a / torch.where(ap == 0, 1.0, ap))
        lam_new = torch.where(active, lam - step, lam)
        in_box = misc.filter_mask(lam_new, box)
        active = active & (torch.abs(step) > eprec) & in_box
        lam = lam_new
    return lam


def _top(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores of each row, ties to the lower
    index (``jax.lax.top_k``)."""
    return torch.sort(score, dim=-1, descending=True, stable=True)[1][..., :k]


def make_batched_full_nsev(d: int, t_span, m: int, xi_span, *, k_max: int = 8,
                           disc: Discretization = Discretization.SPLIT4B,
                           dsub: int = 0, niter: int = 10,
                           contspec_type=ContspecType.BOTH, device=None):
    """A batched ``q[B, D] -> BatchedNsevResult`` pipeline (kappa = +1).

    ``k_max`` bounds the per-signal number of returned bound states (fixed
    shape); candidates are selected inside the resolution/Parseval
    bounding box and deduplicated before refinement. ``device`` is where
    array inputs go (default: the CUDA device; raises without one).
    """
    dev = _array_device(device)
    contspec = _ContspecPass(d, t_span, m, xi_span, +1, disc, contspec_type,
                             dev)
    t0, t1, eps_t = contspec.t0, contspec.t1, contspec.eps_t
    deg1 = max(degree(disc), 1)
    if dsub == 0:
        dsub = int(math.sqrt(d * math.log2(d) ** 2))
    base = nse.newton_base_discretization(disc)

    def boundstates(q, q_eff, r_eff):
        # subsampled fast-eigenvalue pass
        qs_eff, rs_eff, dsub_act, (i0, i1) = nse.preprocess_signal(
            q, eps_t, +1, disc, dsub)
        ts0, ts1 = t0 + i0 * eps_t, t0 + i1 * eps_t
        eps_sub = (ts1 - ts0) / (dsub_act - 1)
        tm, _ = fscatter(qs_eff, rs_eff, eps_sub, disc,
                         want=((0, 0), (1, 0)), jsym=+1)
        coeffs = tm[..., 0, 0, :]
        deg_sub = coeffs.shape[-1] - 1
        roots_z = aberth_roots(coeffs, newton_polygon_init(coeffs),
                               num_iters=100)
        lam = z_to_lambda(roots_z, eps_sub, disc)

        # bounding box (reference re/im bounds), one a signal
        re_b = 0.9 * np.pi / abs((2.0 / deg1) * eps_sub)
        im_b = 1.5 * 0.25 * misc.l2norm2(q, t0, t1)
        box = (-re_b, re_b, 0.0, im_b[:, None])
        mask = misc.filter_mask(lam, box)

        # preselect before the O(k^2) dedupe: a merge over all ~deg roots
        # would materialize a deg x deg distance matrix
        tol = misc.merge_tol_default(lam.dtype)
        neg_inf = torch.tensor(-math.inf, dtype=lam.real.dtype,
                               device=lam.device)
        idx = _top(torch.where(mask, lam.imag, neg_inf),
                   min(4 * k_max, deg_sub))
        lam_pre = torch.take_along_dim(lam, idx, dim=-1)
        mask_pre = misc.merge_mask(lam_pre, tol,
                                   torch.take_along_dim(mask, idx, dim=-1))
        idx = _top(torch.where(mask_pre, lam_pre.imag, neg_inf), k_max)
        lam_k = torch.take_along_dim(lam_pre, idx, dim=-1)
        mask_k = torch.take_along_dim(mask_pre, idx, dim=-1)

        lam_ref = _masked_newton(q_eff, r_eff, lam_k, mask_k, eps_t, t0, t1,
                                 base, niter, box)
        mask_k = mask_k & misc.filter_mask(lam_ref, box)
        mask_k = misc.merge_mask(lam_ref, tol, mask_k)
        _, _, b_v = scatter_bound_states(q_eff, r_eff, lam_ref, eps_t, t0,
                                         t1, base, skip_b=False)
        return (torch.where(mask_k, lam_ref, 0.0), mask_k,
                torch.where(mask_k, b_v, 0.0))

    def fn(q_batch) -> BatchedNsevResult:
        q = _as_batch(q_batch, dev)
        cs, q_eff, r_eff = contspec(q)
        bs, bs_mask, nc = boundstates(q.to(q_eff.dtype), q_eff, r_eff)
        return BatchedNsevResult(rho=cs.get("rho"), a=cs.get("a"),
                                 b=cs.get("b"), bound_states=bs,
                                 bound_state_mask=bs_mask,
                                 norming_constants=nc)

    return fn
