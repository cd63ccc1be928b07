"""Traffic family ``qpsk_bursts``: NFDM bursts, ``{"q": [B, D]}``.

QPSK symbols on ``carriers`` Gaussian pulses of the xi grid (centres
evenly from ``centers[0]`` to ``centers[1]``, width ``width``, amplitude
``amplitude``) give rho_tx [B, M]; the waveform is its first-order (Born)
inverse on the time grid,
q(t) = -(dxi / pi) sum_k conj(rho_tx(xi_k)) exp(-2 i xi_k t).
"""

from __future__ import annotations

import math

import torch

from nftbench.harness.generate import grid


def make(traffic, cfg, g, device):
    b, m, d = traffic["batch"], cfg["M"], cfg["D"]
    xi = grid(*cfg["xi_span"], m, device)
    t = grid(*cfg["t_span"], d, device)
    centers = grid(*traffic["centers"], traffic["carriers"], device)
    pulses = torch.exp(-((xi[None, :] - centers[:, None])
                         / traffic["width"]) ** 2).to(torch.complex128)
    kernel = torch.exp(-2j * xi[:, None] * t[None, :])          # [M, D]
    dxi = (cfg["xi_span"][1] - cfg["xi_span"][0]) / (m - 1)
    bits = torch.randint(0, 2, (b, traffic["carriers"], 2), generator=g,
                         device=device).to(torch.float64) * 2 - 1
    symbols = torch.complex(bits[..., 0], bits[..., 1]) / math.sqrt(2.0)
    rho_tx = traffic["amplitude"] * (symbols @ pulses)          # [B, M]
    q = (-dxi / math.pi) * (rho_tx.conj() @ kernel)
    return {"q": q.contiguous(), "hints": {}}
