"""The device's idle share of the profiled window, %."""

from nftbench.harness.readers import idle_pct as read  # noqa: F401
