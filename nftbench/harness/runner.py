"""One run of one cell: set-up, a measured window, the trace's reading and
the check of what the window produced.

Set-up builds the entry (the program's kernels and tables), makes the
pool of input batches on the device from the seed and warms every shape
the window uses. The window is a closed loop: one caller, each call on the
next batch of the pool (the dict the traffic family made, handed whole to
the entry's callable) and ended by ``torch.cuda.synchronize()``, until
``seconds`` have passed; the calls started are all finished and counted.
The output of the last call on each batch of the pool is kept and, once
the window has closed and the program's state is freed, judged against
the plain reference (``nftbench/reference``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import sys
import time
from pathlib import Path

from nftbench.harness import devinfo
from nftbench.harness.generate import generate
from nftbench.harness.registry import Registry
from nftbench.harness.trace import WINDOW_MARK, digest

FORBIDDEN = ("jax", "jaxlib", "flax", "fnft_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not load, compared
    whole (``fnft_tpu_torch`` is not ``fnft_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Window:
    """What the end-to-end readers (``nftbench/end_to_end/``) take."""
    calls: int          # calls started and finished in the window
    batch: int          # transforms a call
    seconds: float      # window's start to the last call's synchronize
    times: list         # each call's seconds, call to synchronize
    setup_s: float      # process start to the window's start


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def judge(ref, cfg, limits, pool, kept, seed, batch,
          observe=None) -> tuple[bool, dict]:
    """Every kept output against the reference; the numbers compared are
    the worst over the kept outputs, each beside its limit. ``observe``
    reads the compared entries of an output (``ref.observed``; a control
    puts its own in the program's place)."""
    observe = observe or ref.observed
    worst = {}
    for p, out in sorted(kept.items()):
        pl = ref.plan(cfg, batch, limits["check"], seed + p)
        exp = ref.expected(cfg, pool[p], pl)
        obs = observe(cfg, out, pl)
        for k, v in ref.compare(exp, obs).items():
            worst[k] = max(worst.get(k, 0.0), v)
    checks = {k: {"value": v, "limit": limits["limits"][k]}
              for k, v in worst.items()}
    ok = bool(kept) and all(math.isfinite(c["value"])
                            and c["value"] <= c["limit"]
                            for c in checks.values())
    return ok, checks


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, *, registry: Registry | None = None,
             device="cuda", fault=None, out_dir: Path | None = None) -> dict:
    """The result of one run (the dict printed as the last line).
    ``fault`` wraps the entry's callable (a test breaks the timed path
    with it); ``t_start`` is the process's start on ``time.perf_counter``.
    """
    import torch

    reg = registry or Registry()
    cell = reg.cell(workload)
    cfg = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    limits = reg.limits(workload)
    entry, ref = reg.entry(cfg["entry"]), reg.reference(cfg["entry"])
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    batch = traffic["batch"]

    fn = entry.build(cfg, device)
    if fault is not None:
        fn = fault(fn)
    pool = generate(reg, traffic, cfg, seed, device)
    sync()
    t_warm, n = time.perf_counter(), 0
    while n < len(pool) or time.perf_counter() - t_warm < traffic["warmup_s"]:
        out = fn(pool[n % len(pool)])
        sync()
        n += 1
    from fnft_tpu_torch.ops.kernels import LAUNCHES

    gc.collect()
    gc.freeze()
    clocks_before = devinfo.clocks() if on_card else "cpu"
    out = fn(pool[0])   # one call after the reading, still set-up
    sync()
    del out
    counters0 = dict(LAUNCHES)
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
    max_calls = traffic["trace_calls"] if trace else math.inf
    kept, times = {}, []
    with prof:
        mark = (torch.profiler.record_function(WINDOW_MARK) if trace
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        with mark:
            end = t0
            while end - t0 < seconds and len(times) < max_calls:
                i = len(times)
                c0 = time.perf_counter()
                out = fn(pool[i % len(pool)])
                sync()
                end = time.perf_counter()
                times.append(end - c0)
                kept[i % len(pool)] = out
    calls = len(times)
    counters = {k: LAUNCHES[k] - counters0[k] for k in LAUNCHES}
    clocks_after = devinfo.clocks() if on_card else "cpu"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    gc.unfreeze()

    result = {"correct": False, "attempted": calls * batch, "failed": 0}
    metrics = {}
    if not trace:
        window = Window(calls, batch, end - t0, times, setup_s)
        for m in reg.metrics("end_to_end", workload):
            metrics[m["name"]] = {
                "value": reg.end_to_end(m["name"]).read(window),
                "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        dg = digest(prof, calls, counters, cfg, batch, entry)
        dev["busy_s"] = dg.busy_ns() / 1e9
        dev["window_s"] = (dg.window[1] - dg.window[0]) / 1e9
        for m in reg.metrics("per_layer", workload):
            v = reg.reader(m["name"]).read(dg)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = dg.breakdown()
        del dg, prof

    _log(f"calls {calls} in {end - t0:.6f} s (setup {setup_s:.6f} s); call "
         f"s min {min(times):.6f} median {sorted(times)[calls // 2]:.6f} "
         f"max {max(times):.6f}; launches {counters}")
    _log(f"clocks before: {clocks_before}")
    _log(f"clocks after:  {clocks_after}")
    _log(f"memory_peak_bytes {peak}")

    del fn, out
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ok, checks = judge(ref, cfg, limits, pool, kept, seed, batch)
    result["correct"] = ok
    result["metrics"] = metrics
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks

    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        rec = {"workload": workload, "seed": seed, "trace": int(trace),
               "setup_s": setup_s, "window_s": end - t0, "call_s": times,
               "clocks_before": clocks_before, "clocks_after": clocks_after,
               "memory_peak_bytes": peak, "counters": counters,
               "checks": checks}
        path = out_dir / f"{workload}.seed{seed}.trace{int(trace)}.json"
        path.write_text(json.dumps(rec))
    for k, c in checks.items():
        _log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return result
