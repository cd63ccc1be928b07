"""Device ms a call in cuFFT's kernels (tree value levels, chirp-Z), by
the kernel names beside this reader."""

from nftbench.harness.readers import device_ms_per_call
from nftbench.harness.registry import kernel_patterns

PATTERNS = kernel_patterns(__file__)


def read(d):
    return device_ms_per_call(d, PATTERNS)
