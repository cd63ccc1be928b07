"""What a ``--trace 1`` run reads from ``torch.profiler``: the device's
operations and the host's runtime calls inside the traced window, the
device's busy time, the largest device operations and the longest idle
gaps named by what the host was doing. Per-layer metric readers
(``nftbench/metrics/``) take a ``Digest``.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

WINDOW_MARK = "nftbench.window"
TOP = 10    # entries of each list of the breakdown


@dataclasses.dataclass
class Digest:
    calls: int                      # calls inside the traced window
    window: tuple                   # (start, end) ns, profiler clock
    device_ops: list                # (name, start, end) ns, device
    host_ops: list                  # (name, start, end) ns, host
    counters: dict                  # program counters, difference over calls
    cfg: dict
    batch: int
    entry: object                   # the entry module (kernel shapes)

    def device_ns(self, patterns) -> float:
        """Summed device time of operations whose name any of the compiled
        ``patterns`` finds."""
        return sum(e - s for n, s, e in self.device_ops
                   if any(p.search(n) for p in patterns))

    def host_count(self, names) -> int:
        return sum(1 for n, _, _ in self.host_ops if n in names)

    def busy_ns(self) -> float:
        return sum(e - s for s, e in _merged(self.device_ops, self.window))

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each gap named by the innermost host operation running at
        its middle (seconds)."""
        by_name = defaultdict(float)
        for n, s, e in self.device_ops:
            by_name[n] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        busy = _merged(self.device_ops, self.window)
        edges = [self.window[0]] + [x for iv in busy for x in iv] \
            + [self.window[1]]
        gaps = sorted(((edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]),
                      key=lambda g: g[0] - g[1])[:TOP]
        named = []
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2
            inside = [(e - s, n) for n, s, e in self.host_ops
                      if s <= mid <= e]
            named.append([min(inside)[1] if inside else "host (untraced)",
                          (g1 - g0) / 1e9])
        return {"device_ops": [[n[:96], t / 1e9] for n, t in ops],
                "idle_gaps": named}


def _merged(ops, window):
    w0, w1 = window
    ivs = sorted((max(s, w0), min(e, w1)) for _, s, e in ops
                 if e > w0 and s < w1)
    out = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _events(prof):
    """(name, on_device, start_ns, end_ns, is_annotation) of every event."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        ann = getattr(e, "is_user_annotation", lambda: False)()
        yield (e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
               e.start_ns() + e.duration_ns(), ann)


def digest(prof, calls, counters, cfg, batch, entry) -> Digest:
    device_ops, host_ops, window = [], [], None
    for name, on_device, s, e, ann in _events(prof):
        if name == WINDOW_MARK:
            if not on_device:
                window = (s, e)
            continue
        if ann:
            continue
        (device_ops if on_device else host_ops).append((name, s, e))
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW_MARK} range")
    return Digest(calls, window, device_ops, host_ops, counters, cfg, batch,
                  entry)
