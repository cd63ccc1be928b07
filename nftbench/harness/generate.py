"""The traffic generator: the pool of input batches of a run, made on the
device from the seed by the family that the traffic file's ``family``
names (``nftbench/traffic/<family>.py``, found by name).

A family module has ``make(traffic, cfg, g, device) -> dict``: one batch,
drawn from the ``torch.Generator`` ``g``, as the dict that the entry's
callable takes whole. Keys other than the program's inputs (``hints``:
what the family knows of the signal in closed form) are for the
reference. Every batch of a pool is drawn from one generator seeded with
the run's seed, in a fixed order, so a seed gives the same inputs on the
same card. A family gives every seed the same sizes and the same multiset
of classes (the seed changes which row gets which), so seeds differ in
values and not in the amount of work.
"""

from __future__ import annotations

import torch


def grid(lo, hi, n, device):
    return torch.linspace(lo, hi, n, dtype=torch.float64, device=device)


def generate(registry, traffic, cfg, seed: int, device) -> list:
    """The pool of ``traffic["pool"]`` batches for this seed."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    family = registry.family(traffic["family"])
    return [family.make(traffic, cfg, g, device)
            for _ in range(traffic["pool"])]
