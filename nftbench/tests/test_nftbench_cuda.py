"""On the card: the program's outputs pass each cell's limits and the
controls fail them (the program's own complex64 path, and the reference
in complex64 in the program's place),
on three seeds, at the sizes the files name under ``cpu_test``. (The
readings at the cells' own sizes come from ``nftbench/calibrate.py``.)

    python -m pytest -m cuda nftbench/tests/test_nftbench_cuda.py
"""

import pytest
import torch

from nftbench.calibrate import lowered
from nftbench.harness.generate import generate
from nftbench.harness.runner import judge
from nftbench.tests.tinytree import tiny_tree

WORKLOADS = ["nfdm_4096.rx_b1024", "nsev_65536.full_b128"]
SEEDS = [2**31 + 17, 2**31 + 19, 2**31 + 23]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_passes_and_control_fails_on_the_card(workload, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    reg = tiny_tree(tmp_path)
    cell = reg.cell(workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    limits = reg.limits(workload)
    entry, ref = reg.entry(cfg["entry"]), reg.reference(cfg["entry"])
    fn = entry.build(cfg, "cuda")
    for seed in SEEDS:
        pool = generate(reg, traffic, cfg, seed, "cuda")
        kept = {p: fn(item) for p, item in enumerate(pool)}
        ok, checks = judge(ref, cfg, limits, pool, kept, seed,
                           traffic["batch"])
        assert ok, checks
        kept64 = {p: fn(lowered(item)) for p, item in enumerate(pool)}
        ok, checks = judge(ref, cfg, limits, pool, kept64, seed,
                           traffic["batch"])
        assert not ok, checks
        ok, checks = judge(ref, cfg, limits, pool, dict(enumerate(pool)),
                           seed, traffic["batch"],
                           lambda c, item, pl: ref.expected(
                               c, item, pl, torch.complex64))
        assert not ok, checks
