"""Fast AKNS scattering: per-sample polynomial transfer matrices + FFT tree.

Port of ``fnft_tpu/ops/fscatter.py`` (reference fnft__akns_fscatter.c) for
the default 2SPLIT4B scheme. The other fast schemes (SPLIT2A, SPLIT2_MODAL
and the generic splitting-spec fold) are ROADMAP Queue 1 item 3.
"""

from __future__ import annotations

import torch

from fnft_tpu_torch.config import complex_dtype_of
from fnft_tpu_torch.models.discretization import Discretization
from fnft_tpu_torch.ops.poly import fmult2x2_tree
from fnft_tpu_torch.utils.misc import csinc


def _zero_freq_matrix(q, r, h):
    """E = expm([[0, q], [r, 0]] * h): closed form via cos / sinc.

    Reference: akns_fscatter_zero_freq_scatter_matrix
    (fnft__akns_fscatter.c:46-59). Returns [..., 2, 2].
    """
    delta = h * torch.sqrt(-q * r)
    dsinc = h * csinc(delta)
    c = torch.cos(delta)
    return torch.stack([
        torch.stack([c, q * dsinc], dim=-1),
        torch.stack([r * dsinc, c], dim=-1),
    ], dim=-2)


def transfer_matrix_coeffs(q: torch.Tensor, r: torch.Tensor, eps_t: float,
                           disc: Discretization) -> torch.Tensor:
    """Per-sample polynomial transfer matrices ``[..., D, 2, 2, deg+1]``."""
    cdt = complex_dtype_of(q)
    q = q.to(cdt)
    r = r.to(cdt)
    if disc is not Discretization.SPLIT4B:
        raise NotImplementedError(
            f"fast scheme {disc} is not ported yet (ROADMAP Queue 1 item 3)")
    # Closed form of -1/3 E(1) Z^2 E(1) + 4/3 E(1/2) Z E(1) Z E(1/2)
    # (deg = 2, E(a) = expm([[0,q],[r,0]] a eps_t/2)); P11 is the
    # coefficient-reverse of P00 and P01/q == P10/r (fnft_tpu fscatter.py:99)
    qr = q * r
    d1 = (eps_t / 2) * torch.sqrt(-qr)
    c1 = torch.cos(d1)
    s1 = (eps_t / 2) * csinc(d1)
    dh = d1 / 2
    ch = torch.cos(dh)
    sh = (eps_t / 4) * csinc(dh)
    third = 1.0 / 3.0
    u0 = (4.0 * third) * ch * ch * c1 - third * c1 * c1
    u1 = (8.0 * third) * qr * ch * sh * s1
    u2 = (4.0 * third) * qr * sh * sh * c1 - third * qr * s1 * s1
    g0 = (4.0 * third) * ch * sh * c1 - third * c1 * s1
    g1 = (4.0 * third) * (qr * sh * sh * s1 + ch * ch * s1)
    g = torch.stack([g0, g1, g0], dim=-1)
    p00 = torch.stack([u0, u1, u2], dim=-1)
    p11 = torch.stack([u2, u1, u0], dim=-1)
    return torch.stack([
        torch.stack([p00, q[..., None] * g], dim=-2),
        torch.stack([r[..., None] * g, p11], dim=-2),
    ], dim=-3)


def fscatter(q: torch.Tensor, r: torch.Tensor, eps_t: float,
             disc: Discretization, *, normalize: bool = True, want=None,
             jsym: int | None = None):
    """Combined polynomial scattering matrix of D samples.

    Returns (transfer_matrix ``[..., 2, 2, D*deg+1]``, w) with
    ``true = stored * 2**w``; see :func:`fmult2x2_tree` for ``want`` and
    ``jsym``.
    """
    p = transfer_matrix_coeffs(q, r, eps_t, disc)
    return fmult2x2_tree(p, normalize=normalize, want=want, jsym=jsym)
