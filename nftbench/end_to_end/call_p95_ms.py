"""The nearest-rank 95th percentile of all calls' times in the window, ms:
the time that 95% of the calls do not exceed."""

import math


def read(w):
    s = sorted(w.times)
    return 1e3 * s[max(0, math.ceil(0.95 * len(s)) - 1)]
