"""NSE equation adapter: signal preprocessing and boundary phase factors.

Port of ``fnft_tpu/models/nse.py`` (reference fnft__nse_discretization.c).
The NSE maps onto the AKNS system with r = -kappa * conj(q)
(fnft__nse_fscatter.c:77-84).
"""

from __future__ import annotations

import math

import torch

from fnft_tpu_torch.config import complex_dtype_of, eps_of
from fnft_tpu_torch.errors import check_arg, warn
from fnft_tpu_torch.models.discretization import (
    BOUNDARY_COEFF,
    Discretization,
    degree,
    degree1step_total,
    method_weights,
    upsampling_factor,
)
from fnft_tpu_torch.utils.misc import (
    bandlimit_violation,
    downsample_indices,
    resample,
)


def _warn_if_not_bandlimited(q: torch.Tensor, eps_t: float) -> None:
    """The reference's warning that the resampling step is ill-posed
    (fnft__misc.c:370-380), once for a batch of signals; costs one
    device-to-host read."""
    if float(bandlimit_violation(q, eps_t).max()) > math.sqrt(eps_of(q.dtype)):
        warn("Signal does not appear to be bandlimited; the "
             "interpolation step may be inaccurate. Reduce the step "
             "size or use a discretization without resampling.")


def _stage_mix(weights: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """Stage samples ``[..., Dsub * stages]`` from node samples
    ``[..., Dsub, nodes]`` and stage weights ``[stages, nodes]``."""
    return (nodes[..., None, :] * weights).sum(dim=-1).flatten(-2)


def preprocess_signal(q: torch.Tensor, eps_t: float, kappa: int,
                      disc: Discretization, dsub: int | None = None):
    """Resample/subsample a signal as required by the discretization.

    Returns (q_eff, r_eff, dsub_actual, (first_index, last_index)) where
    the effective tensors have ``dsub_actual * upsampling_factor`` samples.
    ``q [..., D]`` may carry leading batch axes. Mirrors
    fnft__nse_discretization.c:386-656.
    """
    cdt = complex_dtype_of(q)
    q = q.to(cdt)
    d = q.shape[-1]
    check_arg(d >= 2, "D must be >= 2")
    dsub_actual, nskip = downsample_indices(d, dsub if dsub else d)
    ups = upsampling_factor(disc)
    idx = torch.arange(dsub_actual, dtype=torch.int64, device=q.device) * nskip

    def conj_r(qe):
        return -kappa * torch.conj(qe)

    if ups == 1 and disc not in (Discretization.ES4, Discretization.TES4):
        q_eff = q[..., idx]
        r_eff = conj_r(q_eff)
    elif disc in (Discretization.CF4_2, Discretization.SPLIT4A4,
                  Discretization.SPLIT4B4):
        _warn_if_not_bandlimited(q, eps_t)
        s = math.sqrt(3.0) / 6.0
        q12 = resample(q, eps_t, [-eps_t * s * nskip, eps_t * s * nskip])
        w = torch.as_tensor(method_weights(disc).reshape(2, 2),
                            device=q.device).to(cdt)
        q_eff = _stage_mix(w, q12[..., idx].transpose(-1, -2))
        r_eff = conj_r(q_eff)
    elif disc in (Discretization.CF4_3, Discretization.CF5_3,
                  Discretization.CF6_4):
        _warn_if_not_bandlimited(q, eps_t)
        node = math.sqrt(3.0 / 20.0) if disc is Discretization.CF4_3 \
            else math.sqrt(15.0) / 10.0  # equal up to rounding, as the
        #                                  reference writes them
        q13 = resample(q, eps_t, [-eps_t * node * nskip, eps_t * node * nskip])
        qs = torch.stack([q13[..., 0, idx], q[..., idx], q13[..., 1, idx]],
                         dim=-1)  # [..., Dsub, 3]
        stages = 3 if disc is not Discretization.CF6_4 else 4
        w = torch.as_tensor(method_weights(disc).reshape(stages, 3),
                            device=q.device).to(cdt)
        q_eff = _stage_mix(w, qs)
        if disc is Discretization.CF4_3:
            r_eff = conj_r(q_eff)
        else:
            # complex weights: r stages are weighted combinations of the
            # *conjugated nodes*, not conjugates of q_eff (reference :531-607)
            r_eff = _stage_mix(w, conj_r(qs))
    elif disc in (Discretization.ES4, Discretization.TES4):
        # 3-slot layout [q, q', q''] with central finite differences
        # (reference :609-633); boundaries use zero exterior samples.
        qsub = q[..., idx]
        h = eps_t * nskip
        zero = torch.zeros_like(qsub[..., :1])
        qm = torch.cat([zero, qsub[..., :-1]], dim=-1)
        qp = torch.cat([qsub[..., 1:], zero], dim=-1)
        d1 = (qp - qm) / (2 * h)
        d2 = (qp - 2 * qsub + qm) / (h * h)
        q_eff = torch.stack([qsub, d1, d2], dim=-1).flatten(-2)
        r_eff = conj_r(q_eff)
    else:
        raise ValueError(f"unknown discretization {disc}")
    return q_eff, r_eff, dsub_actual, (0, (dsub_actual - 1) * nskip)


# ---------------------------------------------------------------------------
# Boundary-condition phase factors (fnft__nse_discretization.c:240-379)
# ---------------------------------------------------------------------------

def phase_factor_rho(eps_t: float, t1: float, disc: Discretization) -> float:
    pf = -2.0 * (t1 + eps_t * BOUNDARY_COEFF)
    if disc in (Discretization.SPLIT2A, Discretization.SPLIT2_MODAL):
        pf += eps_t / degree(disc)
    return pf


def phase_factor_a(eps_t: float, d_given: int, t0: float, t1: float,
                   disc: Discretization) -> float:
    pf = (t1 + eps_t * BOUNDARY_COEFF) - (t0 - eps_t * BOUNDARY_COEFF)
    if degree(disc) > 0:  # fast methods carry the z^{-D deg/2} normalization
        pf += -eps_t * d_given
    return pf


def phase_factor_b(eps_t: float, d_given: int, t0: float, t1: float,
                   disc: Discretization) -> float:
    pf = -(t1 + eps_t * BOUNDARY_COEFF) - (t0 - eps_t * BOUNDARY_COEFF)
    if degree(disc) > 0:
        pf += -eps_t * d_given
    if disc in (Discretization.SPLIT2A, Discretization.SPLIT2_MODAL):
        pf += eps_t / degree(disc)
    return pf


def newton_base_discretization(disc: Discretization) -> Discretization:
    """Slow scheme used for Newton refinement / norming constants of a fast
    scheme (fnft_nsev.c:675-681, 930-939)."""
    if degree(disc) == 0:
        return disc
    ups = upsampling_factor(disc)
    if ups == 1:
        return Discretization.BO
    if ups == 2:
        return Discretization.CF4_2
    return disc


def xi_map_coeff(disc: Discretization) -> float:
    """z = exp(i * map_coeff * lam * eps_t) with map_coeff = 2/(deg*ups)."""
    return 2.0 / degree1step_total(disc)
