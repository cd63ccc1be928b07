"""The arithmetic of the per-layer metrics, shared by the readers in
``nftbench/metrics/`` (one file a metric, which names its kernels)."""

from __future__ import annotations

from nftbench.harness.roofline import bound, k1_work

LAUNCHES = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
            "cuLaunchKernel", "cuLaunchKernelEx"}
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize"}


def launches_per_call(d):
    """Kernel and graph launches a call: the host's runtime calls that
    launch work on the device, in the profiled window, over its calls."""
    return d.host_count(LAUNCHES) / d.calls if d.calls else None


def syncs_per_call(d):
    """Host synchronizations a call: the host's runtime calls that wait
    for the device, over the calls. One of them is the harness's own
    ``torch.cuda.synchronize()`` that ends each call."""
    return d.host_count(SYNCS) / d.calls if d.calls else None


def device_ms_per_call(d, patterns):
    """Device milliseconds a call in the kernels ``patterns`` name."""
    ns = d.device_ns(patterns)
    return ns / 1e6 / d.calls if d.calls and ns > 0 else None


def k1_roofline(d, patterns):
    """K1's share of its roofline, %: the least time the H100 needs for
    K1's work at the cell's shapes (each input read once, each output
    written once, at 3.35 TB/s or 34 / 67 TFLOP/s fp64 / fp32, the
    larger), times its launches, over the device time of its kernels."""
    shapes = d.entry.k1_shapes(d.cfg, d.batch)
    launches = d.counters.get("fused_tree_levels", 0)
    ns = d.device_ns(patterns)
    if not shapes or ns <= 0 or launches != len(shapes) * d.calls:
        return None
    bound_ms = sum(bound(*k1_work(*s))[0] for s in shapes) * d.calls
    return 100.0 * bound_ms * 1e6 / ns


def idle_pct(d):
    """The share of the profiled window, %, in which no operation ran on
    the device (kernels, copies and fills, their intervals merged)."""
    w = d.window[1] - d.window[0]
    return 100.0 * (1.0 - d.busy_ns() / w) if w > 0 else None
