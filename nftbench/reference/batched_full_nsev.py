"""Reference and comparison for the entry kind ``batched_full_nsev``: the
continuous spectrum (rho, a, b) of each signal on a xi grid, its bound
states and their norming constants.

The continuous spectrum is the configuration's scheme stepped sample by
sample (``nsev_batch.contspec``). Bound states are the zeros of a(lam) of
the exact piecewise-constant step (BO) on the full-resolution signal, the
scheme the fast schemes refine and norm their bound states with; they are
found by Newton's method from the traffic's analytic eigenvalues, and b is
read where the forward and backward sweeps meet (``akns.bo_b``). Every row
is compared; the program's outputs are read only to be judged.
"""

from __future__ import annotations

import torch

from nftbench.reference import akns
from nftbench.reference.nsev_batch import contspec, geometry, xi_grid


def plan(cfg, batch: int, check: dict, seed: int):
    """Every row and every entry is compared."""
    return {}


def expected(cfg, item, pl, dtype=torch.complex128):
    q = item["q"].to(dtype)
    xi = xi_grid(cfg, q.real.dtype, q.device)
    a, b = contspec(cfg, q, xi)
    h, t_b, t_e = geometry(cfg)
    count = item["hints"]["count"].to(q.device)
    start = item["hints"]["eigenvalues"].to(dtype).to(q.device)
    valid = torch.arange(start.shape[-1], device=q.device) < count[:, None]
    start = torch.where(valid, start, 1j * torch.ones_like(start))
    kappa = cfg["kappa"]
    lam = akns.bo_newton(q, start, h, t_b, t_e, kappa)
    nc = akns.bo_b(q, lam, h, t_b, t_e, kappa)
    c128 = torch.complex128
    return _ordered({"rho": (b / a).to(c128), "a": a.to(c128),
                     "b": b.to(c128), "count": count,
                     "lam": lam.to(c128), "nc": nc.to(c128), "valid": valid})


def observed(cfg, output, pl):
    mask = output.bound_state_mask
    return _ordered({"rho": output.rho, "a": output.a, "b": output.b,
                     "count": mask.sum(dim=-1), "lam": output.bound_states,
                     "nc": output.norming_constants, "valid": mask})


def _ordered(out):
    """Bound states and norming constants of each row in descending
    imaginary part, the valid ones first."""
    lam, valid = out.pop("lam"), out.pop("valid")
    key = torch.where(valid, lam.imag.double(), -torch.inf)
    order = torch.sort(key, dim=-1, descending=True, stable=True)[1]
    out["lam"] = torch.take_along_dim(lam, order, dim=-1)
    out["nc"] = torch.take_along_dim(out["nc"], order, dim=-1)
    return {k: v.to(torch.complex128) if v.is_complex() else v
            for k, v in out.items()}


def _gap(o, e, rel: bool) -> float:
    if o.numel() == 0:
        return 0.0
    d = (o - e).abs()
    if rel:
        d = d / torch.clamp(e.abs(), min=1.0)
    g = d.max()
    return float(g) if torch.isfinite(g) else float("inf")


def compare(exp, obs) -> dict:
    """``contspec_err``: the largest gap of rho, a or b over max(1, |ref|);
    ``count_miss``: rows whose number of bound states differs;
    ``bound_state_err``: the largest |lam - lam_ref| of the other rows;
    ``norming_err``: the largest gap of their norming constants over
    max(1, |ref|)."""
    dev = exp["rho"].device
    obs = {k: v.to(dev) for k, v in obs.items()}
    contspec_err = max(_gap(obs[k], exp[k], True) for k in ("rho", "a", "b"))
    same = obs["count"] == exp["count"]
    k = exp["lam"].shape[-1]
    sel = same[:, None] & (torch.arange(k, device=dev) < exp["count"][:, None])
    lam_o = obs["lam"][:, :k]
    nc_o = obs["nc"][:, :k]
    return {"contspec_err": contspec_err,
            "count_miss": float((~same).sum()),
            "bound_state_err": _gap(lam_o[sel], exp["lam"][sel], False),
            "norming_err": _gap(nc_o[sel], exp["nc"][sel], True)}
