"""K1's share of its roofline, %, over the device time of the kernels
named beside this reader."""

from nftbench.harness.readers import k1_roofline
from nftbench.harness.registry import kernel_patterns

PATTERNS = kernel_patterns(__file__)


def read(d):
    return k1_roofline(d, PATTERNS)
