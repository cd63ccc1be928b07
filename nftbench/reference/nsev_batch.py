"""Reference and comparison for the entry kind ``nsev_batch``: the
reflection coefficient rho(xi) of a batch of signals on a xi grid.

The reference is the configuration's scheme stepped sample by sample at
each xi (``akns.py``); the program's rho is read only to be judged. Rows
of a batch are independent answers, so the check takes every row at a
sample of xi points and a sample of rows at every xi point, both drawn
from the seed.
"""

from __future__ import annotations

import torch

from nftbench.reference import akns


def xi_grid(cfg, dtype=torch.float64, device="cpu"):
    xi0, xi1 = cfg["xi_span"]
    return torch.linspace(xi0, xi1, cfg["M"], dtype=dtype, device=device)


def geometry(cfg):
    t0, t1 = cfg["t_span"]
    h = (t1 - t0) / (cfg["D"] - 1)
    return h, t0 - h / 2, t1 + h / 2


def contspec(cfg, q, xi):
    """(a, b) of the rows ``q [R, D]`` at ``xi [X]`` or ``[R, X]``."""
    if cfg["discretization"] != "2split4b":
        raise ValueError(f"no reference for {cfg['discretization']}")
    h, t_b, t_e = geometry(cfg)
    t00, _, t10, _ = akns.split4b_product(q, xi, h, cfg["kappa"])
    return (t00 * torch.exp(1j * xi * (t_e - t_b)),
            t10 * torch.exp(-1j * xi * (t_e + t_b)))


def plan(cfg, batch: int, check: dict, seed: int):
    """Which entries are compared: ``cols`` (every row at these xi) and
    ``rows`` (these rows at every xi), drawn from the seed."""
    g = torch.Generator().manual_seed(seed)
    m = cfg["M"]
    cols = torch.randperm(m, generator=g)[:check["sample_xi"]].sort()[0]
    rows = torch.randperm(batch, generator=g)[:check["sample_rows"]].sort()[0]
    return {"cols": cols, "rows": rows}


def expected(cfg, item, pl, dtype=torch.complex128):
    """The reference at the planned entries, computed in ``dtype``."""
    q = item["q"].to(dtype)
    xi = xi_grid(cfg, q.real.dtype, q.device)
    out = {}
    for key, rows, cols in (("cols", slice(None), pl["cols"]),
                            ("rows", pl["rows"], slice(None))):
        a, b = contspec(cfg, q[rows], xi[cols])
        out[key] = (b / a).to(torch.complex128)
    return out


def observed(cfg, output, pl):
    """The program's rho at the planned entries."""
    rho = output["rho"]
    dev = rho.device
    return {"cols": rho[:, pl["cols"].to(dev)].to(torch.complex128),
            "rows": rho[pl["rows"].to(dev)].to(torch.complex128)}


def compare(exp, obs) -> dict:
    """``rho_err``: the largest gap over the compared entries, relative to
    the largest reference |rho| among them (non-finite reads as inf)."""
    worst = 0.0
    for key in exp:
        e, o = exp[key], obs[key].to(exp[key].device)
        gap = (o - e).abs().max() / e.abs().max()
        worst = max(worst, float(gap) if torch.isfinite(gap) else float("inf"))
    return {"rho_err": worst}
