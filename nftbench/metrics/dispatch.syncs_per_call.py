"""Host synchronizations a call (profiler)."""

from nftbench.harness.readers import syncs_per_call as read  # noqa: F401
