"""NSE equation adapter: signal preprocessing and boundary phase factors.

Port of ``fnft_tpu/models/nse.py`` (reference fnft__nse_discretization.c).
The NSE maps onto the AKNS system with r = -kappa * conj(q)
(fnft__nse_fscatter.c:77-84).
"""

from __future__ import annotations

import torch

from fnft_tpu_torch.config import complex_dtype_of
from fnft_tpu_torch.errors import check_arg
from fnft_tpu_torch.models.discretization import (
    BOUNDARY_COEFF,
    Discretization,
    degree,
    degree1step_total,
    upsampling_factor,
)
from fnft_tpu_torch.utils.misc import downsample_indices


def preprocess_signal(q: torch.Tensor, eps_t: float, kappa: int,
                      disc: Discretization, dsub: int | None = None):
    """Subsample a signal as required by the discretization.

    Returns (q_eff, r_eff, dsub_actual, (first_index, last_index)) where
    the effective tensors have ``dsub_actual * upsampling_factor`` samples.
    Mirrors fnft__nse_discretization.c:386-656 for schemes without
    resampling (one sample per step); the others are ROADMAP Queue 1
    item 4.
    """
    q = q.to(complex_dtype_of(q))
    d = q.shape[-1]
    check_arg(d >= 2, "D must be >= 2")
    if upsampling_factor(disc) != 1 or disc in (Discretization.ES4,
                                                Discretization.TES4):
        raise NotImplementedError(
            f"preprocessing for {disc} (resampling / derivative slots) is "
            "not ported yet (ROADMAP Queue 1 item 4)")
    dsub_actual, nskip = downsample_indices(d, dsub if dsub else d)
    idx = torch.arange(dsub_actual, dtype=torch.int64, device=q.device) * nskip
    q_eff = q[..., idx]
    r_eff = -kappa * torch.conj(q_eff)
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
