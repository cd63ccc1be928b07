"""Entry kind ``batched_full_nsev``:
``fnft_tpu_torch.parallel.make_batched_full_nsev``, the continuous
spectrum, bound states and norming constants of a batch's ``q [B, D]``."""

from __future__ import annotations

import math

from nftbench.entries.nsev_batch import DEGREE


def build(cfg, device):
    from fnft_tpu_torch.models.discretization import Discretization
    from fnft_tpu_torch.models.nsev import ContspecType
    from fnft_tpu_torch.parallel import make_batched_full_nsev

    fn = make_batched_full_nsev(
        cfg["D"], tuple(cfg["t_span"]), cfg["M"], tuple(cfg["xi_span"]),
        k_max=cfg["k_max"], disc=Discretization(cfg["discretization"]),
        niter=cfg["niter"], contspec_type=ContspecType.BOTH, device=device)
    return lambda batch: fn(batch["q"])


def dsub(cfg) -> int:
    """Samples of the subsampled signal whose a-polynomial Aberth roots
    (the program's default, Dsub = sqrt(D) log2 D, rounded to a step)."""
    d = cfg["D"]
    want = max(int(math.sqrt(d * math.log2(d) ** 2)), 2)
    skip = int(round(d / min(want, d)))
    return int(round(d / skip))


def k1_shapes(cfg, batch: int) -> list:
    """K1 launches a call: the full-resolution tree and the subsampled
    one, each over B x (its samples) per-sample matrices."""
    c = DEGREE[cfg["discretization"]] + 1
    return [(batch * cfg["D"] // 4, c, 8), (batch * dsub(cfg) // 4, c, 8)]

