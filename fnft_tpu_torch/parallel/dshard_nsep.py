"""Time-axis (D) sharding of the nsep refinement.

Port of ``fnft_tpu/parallel/dshard_nsep.py``. The reference's periodic
driver refines every candidate main/aux spectrum point with Newton sweeps
over the full signal (refine_mainspec / refine_auxspec,
src/fnft_nsep.c:707-835), each evaluation a full monodromy matrix and its
lambda-derivative. That evaluation is sharded as in
``dshard_boundstates``:

* the D (effective) samples are split into S contiguous time chunks, one
  per rank on the ``seq`` mesh axis;
* each rank reduces its chunk to one (T, T') per candidate (log-depth
  products over its O(D/S) steps, the candidates in slices of at most
  ``models.nsep._LAM_BATCH_MATRICES`` step matrices);
* the S chunk matrices meet in one ``all_gather`` an evaluation, and every
  rank composes the total monodromy.

The Newton bodies are the single-device driver's own
(``models.nsep._mainspec_newton_sweep``, ``_auxspec_newton_sweep``): only
the evaluator differs. Their live set (the points not yet frozen) is
found on the host once an iteration; every rank holds the same gathered
values, so every rank finds the same set, and the gathers stay in step.

The subsampled localization (fast monodromy tree, one batched Aberth run)
runs replicated; its cost does not scale with D.
"""

from __future__ import annotations

import torch

from fnft_tpu_torch.models import nsep as nsep_mod
from fnft_tpu_torch.models.discretization import (Discretization,
                                                  upsampling_factor)
from fnft_tpu_torch.models.nsep import (_LAM_BATCH_MATRICES,
                                        _auxspec_newton_sweep,
                                        _mainspec_newton_sweep)
from fnft_tpu_torch.models.nsev import _as_signal
from fnft_tpu_torch.ops.scatter import _family_inputs, _tree_product
from fnft_tpu_torch.parallel.dshard_boundstates import _local_products
from fnft_tpu_torch.parallel.mesh import MeshAxis, as_auto_mesh


def _total_monodromy(q_loc, r_loc, lam, eps_t, disc, seq: MeshAxis):
    """(T, T') ``[K, 2, 2]`` of the full monodromy at ``lam [K]``, composed
    from every rank's chunk product with one all_gather (the semantics of
    ``ops/scatter.scatter_matrix``)."""
    xs, step_fn, scl = _family_inputs(q_loc, r_loc, eps_t, disc)
    per = max(1, _LAM_BATCH_MATRICES // q_loc.shape[-1])
    parts = [_local_products(xs, step_fn, lam[k0:k0 + per], True)
             for k0 in range(0, lam.shape[0], per)]
    m_loc = torch.cat([p[0] for p in parts])
    dm_loc = torch.cat([p[1] for p in parts])
    g = seq.all_gather(torch.stack([m_loc, dm_loc]))     # [S, 2, K, 2, 2]
    tm, td = _tree_product(g[:, 0], g[:, 1])
    return tm, td * scl


def make_dshard_nsep_refine(d: int, mesh, *, eps_t: float,
                            base_disc: Discretization, iters_main: int,
                            iters_aux: int, seq_axis: str = "seq"):
    """D-sharded nsep Newton refinement: ``(refine_main, refine_aux)``.

    * ``refine_main(q_eff, r_eff, lam0 [K], rhs [K], tol) -> lam [K]``: the
      reference's higher-order-root Newton with m in {1, 2} line search on
      Delta(lam) + rhs (refine_mainspec, fnft_nsep.c:707-793);
    * ``refine_aux(q_eff, r_eff, lam0 [K], tol) -> lam [K]``: plain Newton
      on T12 (refine_auxspec, fnft_nsep.c:796-835).

    ``q_eff, r_eff`` are the full effective signal (each rank takes its
    chunk); the candidates are replicated, and so are the results.
    """
    seq = MeshAxis(as_auto_mesh(mesh), seq_axis)
    ups = upsampling_factor(base_disc)
    d_eff = d * ups
    if d_eff % seq.size or (d_eff // seq.size) % ups:
        raise ValueError(
            f"D_eff={d_eff} must split into {seq.size} whole-sample chunks")

    def monodromy(q_eff, r_eff, lam):
        return _total_monodromy(seq.block(q_eff), seq.block(r_eff),
                                lam, eps_t, base_disc, seq)

    def refine_main(q_eff, r_eff, lam0, rhs, tol):
        if lam0.numel() == 0:
            return lam0

        def floquet(lam, _):
            t, td = monodromy(q_eff, r_eff, lam)
            return t[:, 0, 0] + t[:, 1, 1], td[:, 0, 0] + td[:, 1, 1]

        return _mainspec_newton_sweep(floquet, lam0, rhs, tol, iters_main)

    def refine_aux(q_eff, r_eff, lam0, tol):
        if lam0.numel() == 0:
            return lam0

        def evalb(lam, _):
            t, td = monodromy(q_eff, r_eff, lam)
            return t[:, 0, 1], td[:, 0, 1]

        return _auxspec_newton_sweep(evalb, lam0, tol, iters_aux)

    return refine_main, refine_aux


def dshard_nsep_reference(q, t_span, mesh, *, kappa: int = +1,
                          phase_shift: float = 0.0, opts=None,
                          want_main: bool = True, want_aux: bool = True,
                          skip_real: bool = False, seq_axis: str = "seq",
                          device=None):
    """The D-sharded nsep SUBSAMPLE_AND_REFINE (fnft_nsep.c:441-705 and the
    refine loops :707-835): the subsampled localization replicated
    (``models.nsep._sr_localize``), the full-D Newton refinement sharded
    over ``seq_axis``. Returns ``(main, aux)`` filtered, on the device of
    ``q``, comparable with ``models.nsep.nsep`` under
    ``Localization.SUBSAMPLE_AND_REFINE``."""
    opts = opts or nsep_mod.NsepOpts()
    q = _as_signal(q, device)
    d = q.shape[-1]
    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / d        # periodic grid: no endpoint duplication
    lam_shift = phase_shift / (-2.0 * (t1 - t0))
    tgrid = t0 + eps_t * torch.arange(d, dtype=q.real.dtype, device=q.device)
    q_pre = q * torch.exp(2j * lam_shift * tgrid)

    box = list(opts.bounding_box)
    if opts.filtering is nsep_mod.PointFilter.MANUAL:
        box[0] -= lam_shift
        box[1] -= lam_shift
    lam_cat, rhs_cat, aux_lam, ctx = nsep_mod._sr_localize(
        q_pre, eps_t, d, kappa, tuple(box), opts, want_main, want_aux,
        skip_real)
    q_eff, r_eff = ctx["q_eff"], ctx["r_eff"]
    post_filter = ctx["post_filter"]
    tol = ctx["refine_tol"]
    # max_evals == 0 disables refinement, as in the single-device driver
    refine = opts.max_evals > 0
    if refine:
        refine_main, refine_aux = make_dshard_nsep_refine(
            d, mesh, eps_t=eps_t, base_disc=ctx["base"],
            iters_main=max(1, (opts.max_evals - 1) // 2),
            iters_aux=opts.max_evals, seq_axis=seq_axis)

    main = aux = None
    if lam_cat is not None:
        if refine:
            lam_cat = refine_main(q_eff, r_eff, lam_cat, rhs_cat, tol)
        main = post_filter(lam_cat) + lam_shift
    if aux_lam is not None:
        if refine:
            aux_lam = refine_aux(q_eff, r_eff, aux_lam, tol)
        aux = post_filter(aux_lam) + lam_shift
    return main, aux
