"""The frozen copies of chip_smoke.py's bound, k1_work and k2_work give
the bounds that PERF.md's kernel table records."""

import pytest

from nftbench.harness.roofline import bound, k1_work, k2_work


@pytest.mark.parametrize("work, ms, by", [
    # K1 at [1024,4096,2,2,3]: 2^20 subtrees of 3 coefficients, complex128
    # (PERF.md's table gives 0.42188 ms; the function gives 0.42193)
    (k1_work(1024 * 4096 // 4, 3, 8), 0.42193, "bytes"),
    # K2 at [4,8192,8192]
    (k2_work(8192, 8192, 4), 0.04784, "operations"),
    # K1 at [2^20,2,2,3] and K2 at [8192,8192], two more rows of the table
    (k1_work(2**20 // 4, 3, 8), 0.10548, "bytes"),
    (k2_work(8192, 8192), 0.01196, "operations"),
])
def test_bounds_of_the_kernel_table(work, ms, by):
    got, got_by = bound(*work)
    assert got == pytest.approx(ms, abs=5e-5) and got_by == by


def test_copies_equal_chip_smoke():
    chip_smoke = pytest.importorskip("chip_smoke")
    for args in ((2**18, 3, 8), (2**20, 3, 8), (4096, 2, 4)):
        assert k1_work(*args) == chip_smoke.k1_work(*args)
    for args in ((8192, 8192, 128), (18724, 7116, 1)):
        assert k2_work(*args) == chip_smoke.k2_work(*args)
    assert bound(*k2_work(8192, 8192, 128)) == chip_smoke.bound(
        *chip_smoke.k2_work(8192, 8192, 128))
