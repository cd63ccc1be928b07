"""Entry kind ``nsev_batch``: ``fnft_tpu_torch.parallel.make_nsev_batch_fn``,
the batched continuous spectrum of a batch's ``q [B, D]``:
``{"rho": [B, M]}``."""

from __future__ import annotations

# per-sample polynomial degree of the schemes a configuration may name
DEGREE = {"2split4b": 2}


def build(cfg, device):
    from fnft_tpu_torch.models.discretization import Discretization
    from fnft_tpu_torch.models.nsev import ContspecType
    from fnft_tpu_torch.parallel import make_nsev_batch_fn

    fn = make_nsev_batch_fn(
        cfg["D"], tuple(cfg["t_span"]), cfg["M"], tuple(cfg["xi_span"]),
        kappa=cfg["kappa"], disc=Discretization(cfg["discretization"]),
        contspec_type=ContspecType.REFLECTION_COEFFICIENT, device=device)
    return lambda batch: fn(batch["q"])


def k1_shapes(cfg, batch: int) -> list:
    """(subtrees, coefficients, bytes of a real) of each K1 launch a call:
    the first two tree levels over all B x D per-sample matrices."""
    return [(batch * cfg["D"] // 4, DEGREE[cfg["discretization"]] + 1, 8)]
