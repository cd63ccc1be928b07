"""Least device times for a kernel's work on the NVIDIA H100: frozen copies
of ``chip_smoke.py``'s ``bound``, ``k1_work`` and ``k2_work``.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W power limit):
HBM3 3.35 TB/s; 34 TFLOP/s fp64 and 67 TFLOP/s fp32 outside the tensor
cores. A share of the roofline is bound time over measured time; a card
set below 700 W has the same published peak, so its power limit is
printed beside every run.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp64": 34e12, "fp32": 67e12}


def bound(nbytes: float, flops: dict) -> tuple[float, str]:
    """Least time in ms for moving ``nbytes`` and doing ``flops`` (by type)
    on the H100, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_FLOPS[kind] for kind, n in flops.items())
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by


def k1_work(n_sub: int, c: int, itemsize: int) -> tuple[float, dict]:
    """Bytes and flops of K1 at L = 2 on n_sub subtrees of c coefficients:
    each input read once, each output and exponent written once; 16 flops
    a coefficient pair of a 2x2 polynomial product (two complex products
    and two complex sums), 4 c^2 pairs in each of the two level-1 products
    and 4 (2c - 1)^2 in the level-2 one, one multiply a real output."""
    c_out = 4 * c - 3
    nbytes = n_sub * ((16 * c + 4 * c_out) * 2 * itemsize + 4)
    flops = n_sub * (16 * (2 * 4 * c * c + 4 * (2 * c - 1) ** 2) + 8 * c_out)
    return nbytes, {"fp64" if itemsize == 8 else "fp32": flops}


def k2_work(deg: int, m: int, batch: int = 1) -> tuple[float, dict]:
    """Bytes and flops of K2 (complex128, lowprec) on ``batch`` rows with
    every t_idx < deg: z_all, z_t and s of each row and the shared t_idx
    read or written once; a pair costs two fp64 subtractions and eight
    fp32 operations (|d|^2, reciprocal, two products, two tile sums)."""
    pairs = batch * (m * deg - m)
    return batch * (deg * 16 + m * 32) + m * 4, {"fp64": 2 * pairs,
                                                 "fp32": 8 * pairs}
