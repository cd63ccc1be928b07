"""Kernel and graph launches a call (profiler)."""

from nftbench.harness.readers import launches_per_call as read  # noqa: F401
