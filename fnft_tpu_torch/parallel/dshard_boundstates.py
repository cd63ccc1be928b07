"""Time-axis (D) sharding of the discrete-spectrum pipeline.

Port of ``fnft_tpu/parallel/dshard_boundstates.py``. The reference's
bound-state path (src/fnft_nsev.c:595-741) is a subsampled eigenvalue
problem followed by ``niter`` full-D Newton sweeps and a phi/psi pass for
the norming constants (fnft__nse_scatter_bound_states.c:29-668). What
scales with D is sharded:

* the D (effective) samples are split into S contiguous time chunks, one
  per rank on the ``seq`` mesh axis;
* each rank reduces its chunk to one transfer matrix with its lambda-
  derivative (log-depth products), so the O(D) work divides by S;
* the S chunk matrices (``[S, K, 2, 2]`` for K bound states, a few KiB)
  meet in one ``all_gather`` a sweep, and every rank composes the
  prefix/suffix products it needs;
* the ``niter`` Newton sweeps run as a loop on the device: a fixed number
  of sweeps, the freeze/leave-the-box test kept on the device, no host
  read (fnft_nsev.c:973-1038, as ``models.nsev._newton_refine``);
* the norming-constant pass re-derives each rank's per-sample phi/psi
  values from its edge states and picks b at the global argmin of the
  error metric (DOI 10.1109/ACCESS.2019.2932256), with two more small
  gathers.

The subsampled Aberth localization (K2 above 4096 roots) runs replicated
in every rank: its cost, O(Dsub^2) with Dsub = sqrt(D log^2 D), does not
scale with the D this module shards.
"""

from __future__ import annotations

import math

import torch

from fnft_tpu_torch.config import complex_dtype_of, eps_of
from fnft_tpu_torch.models import nse
from fnft_tpu_torch.models import nsev as nsev_mod
from fnft_tpu_torch.models.discretization import (
    BOUNDARY_COEFF,
    Discretization,
    degree,
    upsampling_factor,
)
from fnft_tpu_torch.ops.scatter import (
    _all_step_matrices,
    _b_metric,
    _family_inputs,
    _mat_scan,
    _mv2,
    _prefix_product,
    _tree_product,
)
from fnft_tpu_torch.parallel.mesh import MeshAxis, as_auto_mesh
from fnft_tpu_torch.utils import misc


def _local_products(xs_loc, step_fn, lam, derivative: bool):
    """This rank's chunk as one (T, T') transfer matrix ``[K, 2, 2]``:
    every step matrix at once, then a log-depth product (T' is None
    without ``derivative``)."""
    return _tree_product(*_all_step_matrices(xs_loc, step_fn, lam,
                                             derivative))


def _local_backward_product(xs_loc, step_fn, lam):
    """The backward (psi) product of this rank's chunk, later steps on the
    right."""
    ub, _ = step_fn(lam, *(x.flip(0) for x in xs_loc), derivative=False,
                    backward=True)
    return _tree_product(ub, None)[0]


def _exclusive_prefix(gm, gdm, idx: int):
    """The product of chunks 0..idx-1 (identity at idx = 0) and of all
    chunks, with derivatives, from the gathered chunk matrices
    ``gm [S, K, 2, 2]``; every rank computes them (S is small)."""
    pm, pd = _prefix_product(gm, gdm)
    if idx == 0:
        eye = torch.eye(2, dtype=gm.dtype, device=gm.device).expand(
            gm.shape[1:])
        return eye, torch.zeros_like(eye), pm[-1], pd[-1]
    return pm[idx - 1], pd[idx - 1], pm[-1], pd[-1]


def make_dshard_boundstates(d: int, t_span, mesh, *, kappa: int = +1,
                            disc: Discretization = Discretization.BO,
                            niter: int = 10, seq_axis: str = "seq"):
    """The D-sharded bound-state refinement and norming constants.

    Returns ``run(q_eff, r_eff, lam0, box) -> (lam, a, aprime, b)``, each
    ``[K]`` and the same on every rank: ``q_eff, r_eff`` are the full
    effective signal (each rank takes its chunk; ``run.local`` takes the
    chunk itself), ``lam0 [K]`` the initial bound states and ``box`` the
    Newton bounding box (re0, re1, im0, im1), with the reference's
    freeze/leave semantics (fnft_nsev.c:973-1038). ``kappa`` is carried
    for the JAX signature; the sweeps use ``q_eff`` and ``r_eff``."""
    seq = MeshAxis(as_auto_mesh(mesh), seq_axis)
    s = seq.size
    ups = upsampling_factor(disc)
    d_eff = d * ups
    if d % s or d_eff % s:
        raise ValueError(f"D={d} must be divisible by mesh axis size {s}")
    if (d_eff // s) % ups:
        raise ValueError("each rank's chunk must hold whole samples")
    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / (d - 1)
    tb = t0 - eps_t * BOUNDARY_COEFF
    te = t1 + eps_t * BOUNDARY_COEFF
    idx = seq.index

    def local(q_loc, r_loc, lam0, box):
        cdt = complex_dtype_of(q_loc)
        q_loc, r_loc = q_loc.to(cdt), r_loc.to(cdt)
        lam0 = torch.as_tensor(lam0, device=q_loc.device).to(cdt)
        re0, re1, im0, im1 = (float(x) for x in box)
        eprec = 100.0 * eps_of(cdt)
        xs, step_fn, scl = _family_inputs(q_loc, r_loc, eps_t, disc)

        def gathered_prefix(lam):
            m_loc, dm_loc = _local_products(xs, step_fn, lam, True)
            g = seq.all_gather(torch.stack([m_loc, dm_loc]))  # [S, 2, K, 2, 2]
            return _exclusive_prefix(g[:, 0], g[:, 1], idx)

        def edge_states(lam):
            zeros = torch.zeros_like(lam)
            phi0 = torch.stack([torch.exp(-1j * lam * tb), zeros], dim=-1)
            dphi0 = torch.stack([phi0[:, 0] * (-1j * tb), zeros], dim=-1)
            return phi0, dphi0

        def a_ap(lam, tot_m, tot_d):
            phi0, dphi0 = edge_states(lam)
            phi_end = _mv2(tot_m, phi0)
            dphi_end = _mv2(tot_d, phi0) + _mv2(tot_m, dphi0)
            e_te = torch.exp(1j * lam * te)
            a = phi_end[:, 0] * e_te
            return a, scl * (dphi_end[:, 0] * e_te + (1j * te) * a)

        # ---- Newton: niter sweeps, one gather a sweep, no host read -----
        lam = lam0
        active = torch.ones(lam.shape, dtype=torch.bool, device=lam.device)
        for _ in range(niter):
            a, ap = a_ap(lam, *gathered_prefix(lam)[2:])
            step = a / torch.where(ap == 0, 1.0, ap)
            step = torch.where((a == 0) | (ap == 0), 0.0, step)
            lam_new = torch.where(active, lam - step, lam)
            in_box = ((lam_new.real >= re0) & (lam_new.real <= re1)
                      & (lam_new.imag >= im0) & (lam_new.imag <= im1))
            active = active & (torch.abs(step) > eprec) & in_box
            lam = lam_new

        # ---- final pass: a, a', b at the refined states -----------------
        pm_ex, _, tot_m, tot_d = gathered_prefix(lam)
        a, aprime = a_ap(lam, tot_m, tot_d)
        phi0, _ = edge_states(lam)
        psi_end = torch.stack([torch.zeros_like(lam),
                               torch.exp(1j * lam * te)], dim=-1)

        # edge states: phi at this chunk's left edge, psi at its right one
        phi_left = _mv2(pm_ex, phi0)
        gwb = seq.all_gather(_local_backward_product(xs, step_fn, lam))
        # psi_right(i) = Wb(i+1) ... Wb(S-1) psi_end: the gathered backward
        # products scanned from the last chunk leftward
        qm = _mat_scan(gwb.flip(0))
        psi_right = psi_end if idx == s - 1 else _mv2(qm[s - 2 - idx],
                                                      psi_end)

        # per-sample trajectories of this chunk from its edge states
        u, _ = _all_step_matrices(xs, step_fn, lam, derivative=False)
        phi_vals = _mv2(_mat_scan(u), phi_left)
        ub, _ = step_fn(lam, *(x.flip(0) for x in xs), derivative=False,
                        backward=True)
        rb = _mat_scan(ub)
        psi_rev = _mv2(rb, psi_right)
        psi_vals = torch.cat([psi_rev.flip(0)[1:], psi_right[None]])
        phi_s = phi_vals[ups - 1::ups]
        psi_s = psi_vals[ups - 1::ups]
        # rank 0 also holds the T[0] boundary sample (the reference keeps
        # phi at D+1 grid points, the left boundary included)
        first_phi = phi0 if idx == 0 else phi_s[0]
        first_psi = _mv2(rb[-1], psi_right) if idx == 0 else psi_s[0]
        phi_s = torch.cat([first_phi[None], phi_s])
        psi_s = torch.cat([first_psi[None], psi_s])
        metric, b_all = _b_metric(phi_s, psi_s)
        j = torch.argmin(metric, dim=0)[None]
        m_best = torch.take_along_dim(metric, j, dim=0)[0]
        b_best = torch.take_along_dim(b_all, j, dim=0)[0]

        # the argmin over ranks: one small gather of [S, 2, K]
        g = seq.all_gather(torch.stack([m_best.to(cdt), b_best]))
        jdev = torch.argmin(g[:, 0].real, dim=0)[None]
        b = torch.take_along_dim(g[:, 1], jdev, dim=0)[0]
        return lam, a, aprime, b

    def run(q_eff, r_eff, lam0, box):
        return local(seq.block(q_eff), seq.block(r_eff), lam0, box)

    run.local = local
    return run


def dshard_boundstates_reference(q, t_span, mesh, *, kappa: int = +1,
                                 disc: Discretization = Discretization.SPLIT4B,
                                 niter: int = 10, dsub: int = 0,
                                 seq_axis: str = "seq", device=None):
    """The D-sharded discrete spectrum of ``q`` (the reference's
    SUBSAMPLE_AND_REFINE with norming constants, fnft_nsev.c:595-741).

    The subsampled Aberth localization runs replicated; the full-D Newton
    sweeps and the norming-constant pass run sharded over ``seq_axis``.
    Returns ``(bound_states, norming_constants)``, filtered and merged as
    ``nsev`` does, on the device of ``q`` (``device`` as in ``nsev`` for an
    array)."""
    q = nsev_mod._as_signal(q, device)
    d = q.shape[-1]
    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / (d - 1)
    base = nse.newton_base_discretization(disc)

    # replicated subsampled localization (fast eigenvalue at Dsub)
    dsub = dsub or int(math.sqrt(d * math.log2(d) ** 2))
    qs_eff, rs_eff, _, (i0, i1) = nse.preprocess_signal(q, eps_t, kappa,
                                                        disc, dsub)
    ts0, ts1 = t0 + i0 * eps_t, t0 + i1 * eps_t
    sub = nsev_mod._nsev_base(
        qs_eff, rs_eff, q, ts0, ts1, 0, -1.0, 1.0, kappa,
        nsev_mod.NsevOpts(discretization=disc),
        nsev_mod.BoundStateLocalization.FAST_EIGENVALUE, None, False, True)
    lam0 = sub.bound_states
    if lam0.numel() == 0:
        return lam0, torch.zeros_like(lam0)

    map_coeff = 2.0 / max(1, degree(disc))
    box = (-nsev_mod._re_bound(eps_t, map_coeff),
           nsev_mod._re_bound(eps_t, map_coeff), 0.0,
           nsev_mod._im_bound(q, t0, t1))
    q_eff, r_eff, _, _ = nse.preprocess_signal(q, eps_t, kappa, base)
    fn = make_dshard_boundstates(d, t_span, mesh, kappa=kappa, disc=base,
                                 niter=niter, seq_axis=seq_axis)
    lam, _, _, b = fn(q_eff, r_eff, lam0, box)
    mask = misc.filter_mask(lam, box)
    mask = misc.merge_mask(lam, misc.merge_tol_default(torch.complex128), mask)
    return lam[mask], b[mask]
