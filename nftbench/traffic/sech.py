"""Traffic family ``sech``: ``{"q": [B, D], "hints": {count, eigenvalues}}``.

q = A sech(t) exp(i phi) with A = n + f: n cycles through
``bound_states`` (each class equally often, rows shuffled), f uniform in
[-frac, frac], phi uniform in [0, 2 pi). Its bound states are
i (A - 1/2 - k), k = 0 .. n-1 (Satsuma and Yajima 1974).
"""

from __future__ import annotations

import math

import torch

from nftbench.harness.generate import grid


def make(traffic, cfg, g, device):
    b, d = traffic["batch"], cfg["D"]
    classes = torch.tensor(traffic["bound_states"], dtype=torch.int64,
                           device=device)
    if b % classes.numel():
        raise ValueError("the batch must be a multiple of the classes")
    n = classes.repeat(b // classes.numel())
    n = n[torch.randperm(b, generator=g, device=device)]
    f = (2 * torch.rand(b, generator=g, device=device, dtype=torch.float64)
         - 1) * traffic["frac"]
    phi = 2 * math.pi * torch.rand(b, generator=g, device=device,
                                   dtype=torch.float64)
    amp = n.to(torch.float64) + f
    t = grid(*cfg["t_span"], d, device)
    q = (amp[:, None] / torch.cosh(t)[None, :]).to(torch.complex128) \
        * torch.exp(1j * phi)[:, None]
    k = torch.arange(int(classes.max()), device=device)
    eig = 1j * (amp[:, None] - 0.5 - k[None, :]).to(torch.complex128)
    eig = torch.where(k[None, :] < n[:, None], eig, torch.zeros_like(eig))
    return {"q": q.contiguous(), "hints": {"count": n, "eigenvalues": eig}}
