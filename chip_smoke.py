#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fnft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from fnft_tpu_torch/csrc with nvcc, holds each
against its plain PyTorch version at the shapes of the nsev main path
and at ragged, batched and clustered ones, then drives
``fnft_tpu_torch.nsev`` (default options, 2SPLIT4B) on the Satsuma-Yajima
sech at D = 4096, 2^16 and 2^20 and checks the errors against the
reference bounds and that the kernels were launched. It profiles one warm
run at D = 2^16 (device time, K1's and K2's share, the device's busy share
of the wall). Then the other paths: nsev with 2SPLIT2A, 4SPLIT4B, 2SPLIT3A
and 2SPLIT8B at D = 2^16 (K1 at 2, 3 and 4 coefficients), the rows of the
reference's test table (fast, slow and Richardson) at their own sizes, a
slow scheme (CF4_2) at D = m = 4096, the full spectrum at D = 2^18, where
the Aberth sweeps deflate and K2 runs on the roots still moving, and kdvv
with its real-coefficient tree. While the paths run, the inputs of each
kernel's first launch at every distinct shape are kept, and at the end the
kernel is held against its plain version on each of them. Any failure
raises and exits non-zero. The second line from the end is a JSON record of
the kernels at those shapes: the path that gave the shape, launches at it
in one run of that path, device time of the kernel and of its plain
version (both by CUDA-graph replay), and the least time the H100 could
take for the same work (bytes at 3.35 TB/s, or operations at 34 TFLOP/s
fp64 and 67 TFLOP/s fp32, the larger). The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or outside the repository, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# (contspec, a, b, bound states, norming constants, residues) at D = 4096,
# 2SPLIT4B (reference test fnft_nsev_test_sech_focusing_2split4B.c)
BOUNDS_4096 = (3.9e-6, 6.3e-6, 2.0e-6, 1.6e-5, 5e-14, 2.1e-6)
KEYS = ("contspec", "a", "b", "bound_states", "normconsts", "residues")
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp64": 34e12, "fp32": 67e12}


def check(cond: bool, message: str) -> None:
    if not cond:
        raise AssertionError(message)


def rel_dev(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device time of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    launch cost is not in it."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


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


def k2_work(deg: int, m: int) -> tuple[float, dict]:
    """Bytes and flops of K2 (complex128, lowprec) with every t_idx < deg:
    z_all, z_t and t_idx read once, s written once; a pair costs two fp64
    subtractions and eight fp32 operations (|d|^2, reciprocal, two
    products, two tile sums)."""
    pairs = m * deg - m
    return deg * 16 + m * 36, {"fp64": 2 * pairs, "fp32": 8 * pairs}


def record(name, source, replaces, shape, path, launches, err, ms, plain_ms,
           work) -> dict:
    """One kernel's entry of the ``kernels`` line: ``launches`` is the
    count at ``shape`` in one run of ``path``."""
    bound_ms, bound_by = bound(*work)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape, "path": path,
            "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "pct_of_bound": 100.0 * bound_ms / ms, "library_ms": None}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check_k1(kernels, torch, dev) -> None:
    """(788, ...) gives 197 subtrees, not a multiple of a block's 64;
    n = 1024, 4096, 2^20 (c = 3) are the main path's shapes."""
    rng = np.random.default_rng(1)
    for shape in ((1024, 2, 2, 3), (4096, 2, 2, 3), (1024, 2, 2, 2),
                  (3, 512, 2, 2, 2), (1024, 2, 2, 4), (788, 2, 2, 3),
                  (2, 3, 196, 2, 2, 4), (1 << 20, 2, 2, 3)):
        base = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        for dtype, tol in ((torch.complex128, 1e-12), (torch.complex64, 5e-6)):
            p = torch.as_tensor(base).to(dtype).to(dev)
            for normalize in (False, True):
                got, w = kernels.fused_tree_levels(p, 2, normalize=normalize)
                ref, w_ref = kernels.fused_tree_levels_plain(
                    p, 2, normalize=normalize)
                torch.cuda.synchronize()
                dev_rel = rel_dev(got, ref)
                check(torch.equal(w, w_ref), f"K1 w differs {shape} {dtype}")
                check(dev_rel <= tol, f"K1 {shape} {dtype} norm={normalize}: "
                      f"{dev_rel:.3e} > {tol}")
                if normalize:
                    mx = torch.view_as_real(got).abs().amax(dim=(-4, -3, -2, -1))
                    check(bool(torch.all((mx >= 1) & (mx < 2))),
                          f"K1 {shape} {dtype}: max not in [1, 2)")
                print(f"K1 {tuple(shape)} {str(dtype)[6:]} normalize="
                      f"{normalize}: max rel dev {dev_rel:.3e}, w equal")


def oracle_k2(torch, z_all, z_t, idx):
    """Brute-force repulsion sum in complex128, in blocks of rows."""
    ar = torch.arange(z_all.shape[0], device=z_all.device)
    out = []
    for r0 in range(0, z_t.shape[0], 2048):
        self_mask = idx[r0:r0 + 2048].long()[:, None] == ar[None]
        diff = z_t[r0:r0 + 2048, None] - z_all[None, :]
        out.append(torch.where(self_mask, 0.0, 1.0 / torch.where(
            self_mask, 1.0, diff)).sum(dim=1))
    return torch.cat(out)


def check_k2(kernels, torch, dev) -> None:
    rng = np.random.default_rng(2)
    for deg, m in ((97, 23), (700, 700), (1500, 300), (8192, 8192),
                   (8191, 8191), (5000, 1237), (16384, 16384)):
        z_all = torch.as_tensor(rng.normal(size=deg)
                                + 1j * rng.normal(size=deg)).to(dev)
        idx = torch.as_tensor(np.sort(rng.choice(deg, size=m, replace=False))
                              .astype(np.int32)).to(dev)
        z_t = z_all[idx.long()]
        oracle = oracle_k2(torch, z_all, z_t, idx)
        exact = kernels.repulsion_sum(z_all, z_t, idx, lowprec=False)
        low = kernels.repulsion_sum(z_all, z_t, idx, lowprec=True)
        again = kernels.repulsion_sum(z_all, z_t, idx, lowprec=True)
        low_ref = kernels.repulsion_sum_plain(z_all, z_t, idx, lowprec=True)
        z64, t64 = z_all.to(torch.complex64), z_t.to(torch.complex64)
        c64 = kernels.repulsion_sum(z64, t64, idx)
        c64_ref = kernels.repulsion_sum_plain(z64, t64, idx)
        torch.cuda.synchronize()
        d_exact, d_low = rel_dev(exact, oracle), rel_dev(low, low_ref)
        d_orc, d_64 = rel_dev(low, oracle), rel_dev(c64, c64_ref)
        check(d_exact <= 1e-12, f"K2 ({deg},{m}) exact: {d_exact:.3e}")
        check(max(d_low, d_orc) <= 1e-5, f"K2 ({deg},{m}) lowprec: "
              f"{d_low:.3e} vs plain, {d_orc:.3e} vs oracle")
        check(d_64 <= 1e-5, f"K2 ({deg},{m}) complex64: {d_64:.3e}")
        check(torch.equal(torch.view_as_real(low), torch.view_as_real(again)),
              f"K2 ({deg},{m}): two launches differ")
        print(f"K2 deg={deg} m={m}: exact vs oracle {d_exact:.3e}, lowprec "
              f"vs plain {d_low:.3e} vs oracle {d_orc:.3e}, complex64 vs "
              f"plain {d_64:.3e}, bitwise repeatable")
    half = 4096
    base = np.exp(2j * np.pi * rng.random(half)) * (
        1 + 0.01 * rng.normal(size=half))
    z = torch.as_tensor(np.concatenate([base, base + 1e-9 * np.exp(
        2j * np.pi * rng.random(half))])).to(dev)
    idx = torch.arange(2 * half, dtype=torch.int32, device=dev)
    got = kernels.repulsion_sum(z, z, idx)
    d_cl = rel_dev(got, oracle_k2(torch, z, z, idx))
    check(d_cl <= 1e-5, f"K2 clustered roots: {d_cl:.3e}")
    print(f"K2 deg=m=8192, pairs 1e-9 apart: lowprec vs oracle {d_cl:.3e}")


class KernelSpy:
    """Stands between the port's modules and the two kernel wrappers while
    the paths are driven. It counts each run's launches by shape and keeps
    the inputs of the first launch at each distinct shape, so that each
    kernel can afterwards be held against its plain version on what a path
    really gave it (:func:`records_of_kept`)."""

    def __init__(self, kernels, poly, roots):
        self.kernels, self.poly, self.roots = kernels, poly, roots
        self.kept = {}     # key -> {"args", "kwargs", "path", "launches"}
        self.counts = {}   # key -> launches since begin()
        self.path = None

    def install(self) -> None:
        self.poly.fused_tree_levels = self._spied(
            "fused_tree_levels", self.kernels.fused_tree_levels)
        self.roots.repulsion_sum = self._spied(
            "repulsion_sum", self.kernels.repulsion_sum)

    def remove(self) -> None:
        self.poly.fused_tree_levels = self.kernels.fused_tree_levels
        self.roots.repulsion_sum = self.kernels.repulsion_sum

    def _spied(self, name, wrapper):
        def call(*args, **kwargs):
            if name == "fused_tree_levels":
                shape = tuple(args[0].shape)
            else:
                shape = (args[0].shape[0], args[1].shape[0])
            key = (name, shape)
            self.counts[key] = self.counts.get(key, 0) + 1
            if key not in self.kept:
                self.kept[key] = {
                    "args": tuple(a.clone() if hasattr(a, "clone") else a
                                  for a in args),
                    "kwargs": dict(kwargs), "path": self.path, "launches": 0}
            return wrapper(*args, **kwargs)
        return call

    def begin(self, path: str) -> None:
        """Start of one run of the path ``path``: every count to 0."""
        self.path, self.counts = path, {}
        self.kernels.reset_launches()

    def end(self) -> dict:
        """End of the run: the wrappers' own counts must be the launches
        seen here; a shape first seen on this path takes this run's count.
        Returns the wrappers' counts."""
        for name, n in self.kernels.LAUNCHES.items():
            seen = sum(c for key, c in self.counts.items() if key[0] == name)
            check(seen == n, f"{self.path}: {name} counted {n} launches, "
                  f"{seen} went through the modules")
        for key, n in self.counts.items():
            if self.kept[key]["path"] == self.path:
                self.kept[key]["launches"] = n
        return dict(self.kernels.LAUNCHES)

    def by_shape(self, name: str) -> dict:
        """Launches of ``name`` in the last run, by shape."""
        return {key[1]: n for key, n in self.counts.items() if key[0] == name}

    def launches(self, name: str, shape) -> int:
        return self.kept[(name, tuple(shape))]["launches"]


def k1_record(kernels, torch, p, normalize, launches, path,
              timed=True) -> dict | None:
    """K1 (two levels, complex128) on the stack ``p`` against its plain
    version: equal exponents, coefficients to 1e-12; with ``timed`` its
    record."""
    check(p.dtype == torch.complex128, f"K1 {path}: {p.dtype} on the path")
    got, w = kernels.fused_tree_levels(p, 2, normalize=normalize)
    ref, w_ref = kernels.fused_tree_levels_plain(p, 2, normalize=normalize)
    torch.cuda.synchronize()
    check(torch.equal(w, w_ref), f"K1 {path} {list(p.shape)}: w differs")
    check(rel_dev(got, ref) <= 1e-12, f"K1 {path} {list(p.shape)}: "
          f"{rel_dev(got, ref):.3e} > 1e-12")
    if not timed:
        print(f"K1 {list(p.shape)} ({path}): max rel dev "
              f"{rel_dev(got, ref):.3e}, w equal")
        return None
    ms = graph_ms(lambda: kernels.fused_tree_levels(p, 2,
                                                    normalize=normalize),
                  reps=50)
    plain_ms = graph_ms(lambda: kernels.fused_tree_levels_plain(
        p, 2, normalize=normalize), reps=5, replays=2)
    n_sub = p[..., 0, 0, 0].numel() // 4
    rec = record("fused_tree_levels", "fnft_tpu_torch/csrc/tree_levels.cu",
                 "fnft_tpu/ops/pallas_kernels.py:113", list(p.shape), path,
                 launches, float((got - ref).abs().max()), ms, plain_ms,
                 k1_work(n_sub, p.shape[-1], 8))
    print(f"K1 {list(p.shape)} c128 ({path}, {launches} launches): kernel "
          f"{ms:.4f} ms ({rec['pct_of_bound']:.1f}% of its "
          f"{rec['bound_by']} bound {rec['bound_ms']:.4f} ms), plain "
          f"{plain_ms:.4f} ms")
    return rec


def k1_main_path_record(kernels, torch, dev, d, launches) -> dict:
    """K1 at the full pass of D: the D transfer matrices of 2SPLIT4B on the
    sech (3 coefficients), complex128."""
    from fnft_tpu_torch.ops import fscatter as fs
    from fnft_tpu_torch.testcases import NsevTestcase, nsev_testcase

    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    q = torch.as_tensor(data.q).to(dev)
    eps_t = (data.t_span[1] - data.t_span[0]) / (q.shape[0] - 1)
    p = fs.transfer_matrix_coeffs(q, -torch.conj(q), eps_t,
                                  fs.Discretization.SPLIT4B).contiguous()
    return k1_record(kernels, torch, p, True, launches, f"SPLIT4B D={d}")


def k2_record(kernels, torch, z_all, z_t, idx, launches, path,
              timed=True) -> dict | None:
    """K2 (complex128, low precision) on the roots ``z_t = z_all[idx]``
    against its plain version, to 1e-5; with ``timed`` its record."""
    deg, m = z_all.shape[0], z_t.shape[0]
    check(z_all.dtype == torch.complex128, f"K2 {path}: {z_all.dtype}")
    got = kernels.repulsion_sum(z_all, z_t, idx)
    ref = kernels.repulsion_sum_plain(z_all, z_t, idx)
    torch.cuda.synchronize()
    check(rel_dev(got, ref) <= 1e-5,
          f"K2 {path} [{deg}, {m}]: {rel_dev(got, ref):.3e} > 1e-5")
    if not timed:
        print(f"K2 [{deg}, {m}] ({path}): max rel dev "
              f"{rel_dev(got, ref):.3e}")
        return None
    ms = graph_ms(lambda: kernels.repulsion_sum(z_all, z_t, idx))
    plain_ms = graph_ms(lambda: kernels.repulsion_sum_plain(z_all, z_t, idx),
                        reps=5, replays=2)
    rec = record("repulsion_sum", "fnft_tpu_torch/csrc/repulsion.cu",
                 "fnft_tpu/ops/pallas_kernels.py:254", [deg, m], path,
                 launches, float((got - ref).abs().max()), ms, plain_ms,
                 k2_work(deg, m))
    print(f"K2 [{deg}, {m}] c128 lowprec ({path}, {launches} launches): "
          f"kernel {ms:.4f} ms ({rec['pct_of_bound']:.1f}% of its "
          f"{rec['bound_by']} bound {rec['bound_ms']:.4f} ms), plain "
          f"{plain_ms:.4f} ms, max rel dev {rel_dev(got, ref):.3e}")
    return rec


def k2_main_path_record(kernels, torch, dev, launches) -> dict:
    """K2 at the D = 2^16 sub pass: deg = m = 8192 roots, complex128."""
    rng = np.random.default_rng(3)
    ang = 2 * np.pi * rng.random(8192)
    z = torch.as_tensor(np.exp(1j * ang) * (1 + 0.01 * rng.normal(size=8192))
                        ).to(dev)
    idx = torch.arange(8192, dtype=torch.int32, device=dev)
    return k2_record(kernels, torch, z, z, idx, launches,
                     "SPLIT4B D=65536, seeded roots")


def records_of_kept(spy, torch, done) -> list:
    """Every shape a driven path gave a kernel, on the inputs of its first
    launch there: kernel against plain version, and a record with that
    shape's launches in the run of the path where it was first seen.
    Shapes in ``done`` have their record already and are compared only."""
    recs = []
    for (name, shape), kept in spy.kept.items():
        timed = (name, shape) not in done
        if name == "fused_tree_levels":
            p, levels = kept["args"]
            check(levels == 2, f"K1 {kept['path']}: {levels} levels")
            rec = k1_record(spy.kernels, torch, p, kept["kwargs"]["normalize"],
                            kept["launches"], kept["path"], timed)
        else:
            z_all, z_t, idx = kept["args"]
            check(kept["kwargs"].get("lowprec", True),
                  f"K2 {kept['path']}: full precision on the path")
            rec = k2_record(spy.kernels, torch, z_all, z_t, idx,
                            kept["launches"], kept["path"], timed)
        if rec is not None:
            recs.append(rec)
    return recs


def nsev_call(ft, torch, dev, d, bound_states, scheme="SPLIT4B"):
    """The sech at D samples, and a call of nsev on it as a tensor on the
    card (default options but ``scheme``, contspec and discspec BOTH)."""
    from fnft_tpu_torch.testcases import NsevTestcase, nsev_testcase

    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    q = torch.as_tensor(data.q).to(dev)
    opts = ft.NsevOpts(contspec_type=ft.ContspecType.BOTH,
                       discspec_type=ft.DiscspecType.BOTH,
                       discretization=ft.Discretization[scheme])
    return data, lambda: ft.nsev(q, data.t_span, m=data.m,
                                 xi_span=data.xi_span, opts=opts,
                                 want_bound_states=bound_states)


def run_nsev(ft, spy, torch, dev, d, *, bound_states=True, warm=1,
             scheme="SPLIT4B"):
    """A cold run, then ``warm`` warm runs of nsev on the sech at D samples,
    each with the launch counts set to 0 just before it; returns (errors,
    warm seconds, launch counts of the first warm run, result)."""
    from fnft_tpu_torch.testcases import nsev_errors

    data, call = nsev_call(ft, torch, dev, d, bound_states, scheme)
    path = f"{scheme} D={d}"
    spy.begin(path)
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    spy.end()
    walls, launches = [], None
    for _ in range(warm):
        spy.begin(path)
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counted = spy.end()
        launches = launches or counted
    errs = nsev_errors(res, data)
    n_bs = None if res.bound_states is None else int(res.bound_states.numel())
    print(f"nsev {scheme} D={d}: cold {cold:.4f} s, warm "
          + " ".join(f"{t:.4f}" for t in walls)
          + f" s, bound states {n_bs}, launches {launches}")
    print("  errors " + ", ".join(
        f"{k}={errs[k]:.3e}" if errs[k] is not None else f"{k}=None"
        for k in KEYS))
    return errs, walls, launches, res


def profile_nsev(ft, torch, dev, d) -> None:
    """One warm nsev at D samples under torch.profiler: device time of all
    device activity (kernels, copies), of K1's and K2's kernels, and the
    device's busy share of the profiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, call = nsev_call(ft, torch, dev, d, True)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total = k1 = k2 = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue  # a host op's device time is its kernels', counted here
        total += evt.self_device_time_total
        if "repulsion" in evt.key or "sum_splits" in evt.key:
            k2 += evt.self_device_time_total
        elif "fused_levels" in evt.key:
            k1 += evt.self_device_time_total
    check(total > 0 and k1 > 0 and k2 > 0,
          f"profile D={d}: no device time seen ({total}, {k1}, {k2} us)")
    print(f"profiled nsev D={d}: wall {wall:.4f} s, device {total / 1e3:.3f}"
          f" ms (busy {total / 1e4 / wall:.2f}%), K2 {k2 / 1e3:.3f} ms "
          f"({100 * k2 / total:.2f}%), K1 {k1 / 1e3:.3f} ms "
          f"({100 * k1 / total:.2f}%)")


def check_default_device(ft, torch, res_tensor) -> None:
    """nsev on a numpy array runs on the card and gives what it gives for
    the same samples as a CUDA tensor."""
    from fnft_tpu_torch.testcases import NsevTestcase, nsev_testcase

    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, 4096)
    res = ft.nsev(data.q, data.t_span, m=data.m, xi_span=data.xi_span,
                  opts=ft.NsevOpts(contspec_type=ft.ContspecType.BOTH,
                                   discspec_type=ft.DiscspecType.BOTH))
    for key, val in vars(res).items():
        ref = getattr(res_tensor, key)
        if val is None:
            check(ref is None, f"numpy input: {key} missing")
            continue
        check(val.device.type == "cuda", f"numpy input: {key} on {val.device}")
        check(torch.equal(val, ref), f"numpy input: {key} differs")
    print("nsev D=4096 on a numpy array: ran on the card, equal to the "
          "CUDA-tensor run")


# Rows of the reference's test table (test/fnft_nsev/*.c), as
# (testcase, scheme, D, six bounds, Newton seeded by the exact states,
# Richardson): the fast rows not driven above, every slow scheme, and the
# Richardson rows.
TABLE_ROWS = [
    ("SECH_FOCUSING", "SPLIT2_MODAL", 4096,
     (5.0e-3, 2.6e-3, 3.6e-3, 1.6e-5, 5e-14, 2.1e-6), False, False),
    ("SECH_FOCUSING", "SPLIT4A", 4096,
     (3.9e-6, 6.3e-6, 2.0e-6, 1.6e-5, 5e-14, 2.1e-6), False, True),
    ("SECH_FOCUSING", "SPLIT8B", 1024,
     (6.2e-5, 1.0e-4, 3.1e-5, 2.4e-4, 5e-14, 3.3e-5), False, False),
    ("SECH_FOCUSING", "SPLIT7A", 256,
     (9.9e-4, 1.7e-3, 4.9e-4, 3.9e-3, 5e-14, 6.0e-4), False, False),
    ("SECH_FOCUSING", "SPLIT4A4", 512,
     (1.6e-6, 4.3e-6, 1.5e-6, 2.2e-7, 6e-15, 1.1e-6), False, False),
    ("SECH_FOCUSING2", "BO", 2048,
     (5.7e-2, 2.8e-2, 9.1e-3, 8.9e-3, 5e-14, 1.6e-2), True, False),
    ("SECH_FOCUSING2", "CF4_2", 512,
     (7.1e-3, 3.5e-3, 1.2e-3, 1.2e-3, 3.2e-11, 1.6e-3), True, False),
    ("SECH_FOCUSING2", "CF4_3", 513,
     (2.8e-4, 1.5e-4, 4.1e-5, 1.6e-4, 4.0e-14, 6.2e-4), True, False),
    ("SECH_FOCUSING2", "CF5_3", 399,
     (7.5e-5, 4.2e-5, 4.2e-5, 4.1e-5, 2.8e-4, 2.7e-4), True, False),
    ("SECH_FOCUSING2", "CF6_4", 400,
     (1.7e-4, 7.9e-5, 2.4e-5, 4.3e-5, 5.0e-14, 7.7e-5), True, False),
    ("SECH_FOCUSING2", "ES4", 512,
     (9.7e-2, 4.8e-2, 1.7e-2, 2.5e-2, 3.2e-11, 4.7e-2), True, False),
    ("SECH_FOCUSING2", "TES4", 1024,
     (7.7e-3, 3.8e-3, 1.2e-3, 1.2e-3, 3.2e-11, 4.8e-2), True, False),
    ("SECH_FOCUSING2", "CF4_2", 512,
     (8.8e-4, 1.2e-4, 5.6e-5, 8.8e-5, 5e-14, 9.8e-5), True, True),
    ("SECH_FOCUSING2", "CF5_3", 701,
     (3e-6, 1.5e-6, 4.5e-7, 1.6e-6, 1.8e-5, 1.7e-5), True, True),
    ("SECH_FOCUSING2", "TES4", 1024,
     (1.1e-3, 1.6e-4, 5.6e-5, 5.5e-5, 5e-14, 3.9e-2), True, True),
]
BOUNDS_SPLIT2A = (8.5e-5, 1.7e-4, 7.9e-5, 1.6e-5, 5e-14, 2.1e-6)
BOUNDS_SPLIT4B4 = (5.2e-8, 1.6e-7, 4.5e-8, 1.4e-8, 5e-15, 6.3e-8)
BOUNDS_CF4_2 = TABLE_ROWS[6][3]
BOUND_RHO_SPLIT8B = 6.2e-5
BOUND_KDVV_SPLIT8B = 5.78e-5    # test/fnft_kdvv/fnft_kdvv_test_sech_2split8B.c


def check_bounds(what, errs, bounds, keys=KEYS) -> None:
    print(f"  {what}: " + ", ".join(f"{k}={errs[k]:.3e}" for k in keys))
    for key, bound_ in zip(KEYS, bounds):
        if key in keys:
            check(errs[key] is not None and errs[key] <= bound_,
                  f"{what} {key}: {errs[key]} > {bound_}")


def table_row(ft, spy, torch, dev, case, scheme, d, seeded, rich, m=None):
    """One row of the reference's table on the card; returns (errors,
    wall seconds of the call). With ``m`` the continuous spectrum is taken
    on m points, a multiple of 15 plus 1, whose every ((m-1)/15)-th point is
    one of the 16 tabulated ones."""
    from fnft_tpu_torch.testcases import (NsevTestcase, nsev_errors,
                                          nsev_testcase)

    data = nsev_testcase(NsevTestcase[case], d)
    opts = ft.NsevOpts(contspec_type=ft.ContspecType.BOTH,
                       discspec_type=ft.DiscspecType.BOTH,
                       discretization=ft.Discretization[scheme],
                       richardson_extrapolation=rich)
    kw = dict(m=m or data.m, xi_span=data.xi_span, kappa=data.kappa,
              opts=opts)
    q = torch.as_tensor(data.q).to(dev)
    spy.begin(f"{scheme} D={d}{' Richardson' if rich else ''}, {case}")
    t0 = time.perf_counter()
    if seeded:
        res = ft.nsev_with_initial_states(q, data.t_span, data.bound_states,
                                          **kw)
    else:
        res = ft.nsev(q, data.t_span, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spy.end()
    if m:
        check((m - 1) % 15 == 0, f"m={m} does not hold the tabulated grid")
        for field in ("reflection_coefficient", "a", "b"):
            setattr(res, field, getattr(res, field)[::(m - 1) // 15])
    check(all(v is None or v.device.type == "cuda" for v in vars(res).values()),
          f"{scheme} D={d}: a result left the card")
    return nsev_errors(res, data), wall


def fast_schemes_full_width(ft, spy, torch, dev) -> None:
    """nsev at D = 2^16 with the other tree widths: 2SPLIT2A (K1 on 2
    coefficients, both passes), 4SPLIT4B (resampling, 2^17 effective
    samples, K1 on 3, CF4_2 Newton base), contspec with 2SPLIT3A (K1 on 4)
    and 2SPLIT8B (13 coefficients: no K1)."""
    d = 1 << 16
    for scheme, bound_states, bounds, keys, want_k1 in (
            ("SPLIT2A", True, BOUNDS_SPLIT2A, KEYS, 2),
            # norming constants: the row's 5e-15 is 22 eps, set at D = 1024
            # and met there and at D = 4096 (tests/test_torch_nsev_schemes.py
            # reads port and JAX package); 2^17 steps round to 1.4e-14
            ("SPLIT4B4", True, BOUNDS_SPLIT4B4[:4] + (2e-14,)
             + BOUNDS_SPLIT4B4[5:], KEYS, 2),
            ("SPLIT3A", False, BOUNDS_SPLIT2A, KEYS[:1], 1),
            ("SPLIT8B", False, (BOUND_RHO_SPLIT8B,), KEYS[:1], 0)):
        errs, _, launches, res = run_nsev(ft, spy, torch, dev, d,
                                          bound_states=bound_states,
                                          scheme=scheme)
        check_bounds(f"{scheme} D=2^16", errs, bounds, keys)
        check(launches["fused_tree_levels"] == want_k1, f"{scheme} D=2^16: "
              f"K1 launched {launches['fused_tree_levels']} times, want "
              f"{want_k1}")
        print(f"  K1 by shape: {spy.by_shape('fused_tree_levels')}, K2: "
              f"{spy.by_shape('repulsion_sum')}")
        if bound_states:
            check(res.bound_states.numel() == 3,
                  f"{scheme} D=2^16: {res.bound_states.numel()} bound states")


def reference_table_rows(ft, spy, torch, dev) -> None:
    for case, scheme, d, bounds, seeded, rich in TABLE_ROWS:
        errs, wall = table_row(ft, spy, torch, dev, case, scheme, d, seeded,
                               rich)
        check_bounds(f"{scheme} D={d}{' Richardson' if rich else ''} "
                     f"({wall:.3f} s cold)", errs, bounds)


def slow_scheme_at_size(ft, spy, torch, dev) -> None:
    """CF4_2 with D = 4096 samples and m = 4096 spectral points (the slow
    schemes cost O(D m)), Newton seeded by the five exact states."""
    table_row(ft, spy, torch, dev, "SECH_FOCUSING2", "CF4_2", 4096, True,
              False, m=4096)
    torch.cuda.reset_peak_memory_stats()
    errs, wall = table_row(ft, spy, torch, dev, "SECH_FOCUSING2", "CF4_2",
                           4096, True, False, m=4096)
    check_bounds("CF4_2 D=4096 m=4096", errs, BOUNDS_CF4_2)
    print(f"  warm wall {wall:.4f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")


def deflated_aberth(ft, spy, torch, dev) -> None:
    """Full spectrum with 2SPLIT4B at D = 2^18: the sub pass has 9362
    samples, so a(z) has degree 18724 > 16384 and the Aberth sweeps
    deflate: K2 runs at [deg, deg] and on the roots still moving."""
    from fnft_tpu_torch.models import nsev as nsev_mod
    from fnft_tpu_torch.models.discretization import z_to_lambda
    from fnft_tpu_torch.ops import roots
    from fnft_tpu_torch.utils import misc

    d = 1 << 18
    seen = {"deflated": 0, "roots": None}
    orig_deflated, orig_poly_roots = (roots.aberth_roots_deflated,
                                      nsev_mod.poly_roots)

    def spy_deflated(coeffs, z0, **kw):
        seen["deflated"] += 1
        return orig_deflated(coeffs, z0, **kw)

    def spy_poly_roots(coeffs, **kw):
        seen["roots"] = (coeffs, orig_poly_roots(coeffs, **kw))
        return seen["roots"][1]

    roots.aberth_roots_deflated = spy_deflated
    nsev_mod.poly_roots = spy_poly_roots
    try:
        errs, walls, launches, res = run_nsev(ft, spy, torch, dev, d, warm=1)
    finally:
        roots.aberth_roots_deflated = orig_deflated
        nsev_mod.poly_roots = orig_poly_roots
    k2 = spy.by_shape("repulsion_sum")
    check_bounds("SPLIT4B D=2^18", errs, BOUNDS_4096)
    check(res.bound_states.numel() == 3,
          f"D=2^18: {res.bound_states.numel()} bound states, want 3")
    check(seen["deflated"] == 2, "D=2^18: aberth_roots_deflated ran "
          f"{seen['deflated']} times in two calls")
    deg = 18724
    check(all(shape[0] == deg for shape in k2),
          f"D=2^18: K2 saw degrees {sorted({shape[0] for shape in k2})}")
    active = {m: n for (_, m), n in sorted(k2.items(), reverse=True)
              if m < deg}
    check(k2.get((deg, deg), 0) > 0 and active, f"D=2^18: K2 shapes {k2}")
    print(f"  K2 per call: {k2[(deg, deg)]} launches at [{deg}, {deg}]; at "
          f"[{deg}, m] with m < deg, launches by m: {active}")
    print(f"  K1 by shape: {spy.by_shape('fused_tree_levels')}")
    # certificate of the roots that pass the bound-state filter
    coeffs, z = seen["roots"]
    data, _ = nsev_call(ft, torch, dev, d, True)
    eps_t = (data.t_span[1] - data.t_span[0]) / (d - 1)
    eps_sub = eps_t * round(d / (coeffs.shape[0] // 2))
    lam = z_to_lambda(z, eps_sub, ft.Discretization.SPLIT4B)
    box = (-nsev_mod._re_bound(eps_sub, 1.0), nsev_mod._re_bound(eps_sub, 1.0),
           0.0, nsev_mod._im_bound(torch.as_tensor(data.q), *data.t_span))
    kept = misc.filter_mask(lam, box)
    eta = roots.root_residuals(coeffs, z)[kept]
    tol = roots.certified_tol(deg)
    check(int(kept.sum()) >= 3 and float(eta.max()) <= tol,
          f"D=2^18: {int(kept.sum())} roots kept, residual "
          f"{float(eta.max()):.3e} > {tol:.3e}")
    print(f"  {int(kept.sum())} roots pass the filter, largest residual "
          f"{float(eta.max()):.3e} <= certified {tol:.3e}; warm wall "
          f"{walls[0]:.4f} s")


def kdvv_paths(ft, spy, torch, dev) -> None:
    from fnft_tpu_torch.testcases import (kdvv_poschl_teller_case,
                                          kdvv_sech_case)
    from fnft_tpu_torch.utils.misc import rel_err

    d, m = 1 << 16, 1 << 12
    u, t_span, xi_span, rho = kdvv_sech_case(d, m)
    ut = torch.as_tensor(u).to(dev)
    exact = torch.as_tensor(rho).to(dev)
    opts = ft.KdvvOpts()   # 2SPLIT8B
    for label, arg in (("real", ut), ("complex", ut + 0j)):
        ft.kdvv(arg, t_span, m=m, xi_span=xi_span, opts=opts)
        torch.cuda.synchronize()
        spy.begin(f"kdvv SPLIT8B D={d}, {label} potential")
        t0 = time.perf_counter()
        res = ft.kdvv(arg, t_span, m=m, xi_span=xi_span, opts=opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = spy.end()
        err = float(rel_err(res.reflection_coefficient, exact))
        print(f"  kdvv 2SPLIT8B D=2^16 m=2^12 {label} potential: error "
              f"{err:.3e}, warm wall {wall:.4f} s, launches {launches}")
        check(err <= BOUND_KDVV_SPLIT8B, f"kdvv {label}: {err} > "
              f"{BOUND_KDVV_SPLIT8B}")
        check(launches["fused_tree_levels"] == 0,
              f"kdvv 2SPLIT8B {label}: K1 launched")
        if label == "real":
            rho_real = res.reflection_coefficient
    # the complex route keeps the 1e-15 imaginary rounding of its transfer
    # matrices, which D non-unitary products carry to 2e-15 D; the JAX
    # package's two routes differ as much (tests/test_torch_kdvv.py)
    dev_rel = rel_dev(res.reflection_coefficient, rho_real)
    check(dev_rel <= 2e-10, f"kdvv complex vs real route: {dev_rel:.3e}")
    # a complex potential with a narrow scheme does go through K1
    spy.begin(f"kdvv SPLIT2A D={d}, complex potential")
    res = ft.kdvv(ut + 0j, t_span, m=m, xi_span=xi_span,
                  opts=ft.KdvvOpts(discretization=ft.Discretization.SPLIT2A))
    torch.cuda.synchronize()
    launches = spy.end()
    err = float(rel_err(res.reflection_coefficient, exact))
    check(launches["fused_tree_levels"] == 1 and err <= 1.37e-4,
          f"kdvv 2SPLIT2A complex: K1 {launches}, error {err}")
    print(f"  routes agree to {dev_rel:.3e}; 2SPLIT2A on a complex tensor: "
          f"error {err:.3e}, K1 launched once")
    for s in (1.3, 2.0):
        u, t_span, kappa = kdvv_poschl_teller_case(1024, s)
        t0 = time.perf_counter()
        bs = ft.kdvv_bound_states(u, t_span, opts=ft.KdvvOpts(
            discretization=ft.Discretization.SPLIT4B))
        wall = time.perf_counter() - t0
        check(bs.device.type == "cuda", "kdvv_bound_states left the card")
        got = np.sort(bs.imag.cpu().numpy())
        check(got.shape == kappa.shape
              and np.max(np.abs(got - np.sort(kappa))) <= 2e-4,
              f"kdvv_bound_states s={s}: {got} vs {np.sort(kappa)}")
        print(f"  kdvv_bound_states s={s}: {got} ({wall:.3f} s)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import fnft_tpu_torch as ft
    from fnft_tpu_torch.ops import _build, kernels, poly, roots

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")

    phase("2 build")
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    print(f"built {so.name} in {time.perf_counter() - t0:.2f} s")
    log = (_build.BUILD_DIR / "build.log")
    for line in log.read_text().splitlines() if log.exists() else []:
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())

    spy = KernelSpy(kernels, poly, roots)
    spy.install()

    phase("3 K1 kernel vs plain")
    check_k1(kernels, torch, dev)

    phase("4 K2 kernel vs plain")
    check_k2(kernels, torch, dev)

    phase("5 nsev D=4096")
    errs, walls_12, launches, res = run_nsev(ft, spy, torch, dev, 4096,
                                             warm=3)
    for key, bound_ in zip(KEYS, BOUNDS_4096):
        check(errs[key] is not None and errs[key] <= bound_,
              f"D=4096 {key}: {errs[key]} > {bound_}")
    check(launches["fused_tree_levels"] > 0, "D=4096: K1 not launched")
    check_default_device(ft, torch, res)

    phase("6 nsev D=2^16")
    errs, walls_16, launches_16, res = run_nsev(ft, spy, torch, dev, 1 << 16,
                                                warm=3)
    check(res.bound_states.numel() == 3,
          f"D=2^16: {res.bound_states.numel()} bound states, want 3")
    for key, bound_ in zip(KEYS[:4], BOUNDS_4096[:4]):
        check(errs[key] <= bound_, f"D=2^16 {key}: {errs[key]} > {bound_}")
    check(launches_16["fused_tree_levels"] > 0, "D=2^16: K1 not launched")
    check(launches_16["repulsion_sum"] > 0, "D=2^16: K2 not launched")

    phase("7 nsev D=2^20 contspec")
    errs, walls_20, launches_20, _ = run_nsev(
        ft, spy, torch, dev, 1 << 20, bound_states=False, warm=3)
    check(errs["contspec"] <= BOUNDS_4096[0],
          f"D=2^20 contspec: {errs['contspec']} > {BOUNDS_4096[0]}")
    check(launches_20["fused_tree_levels"] > 0, "D=2^20: K1 not launched")
    for d, walls in (("4096", walls_12), ("2^16", walls_16),
                     ("2^20", walls_20)):
        print(f"warm wall D={d}: {min(walls):.4f}-{max(walls):.4f} s "
              f"over {len(walls)} runs")

    phase("8 profile of a warm nsev at D=2^16")
    profile_nsev(ft, torch, dev, 1 << 16)

    phase("9 kernels at the main path's shapes")
    k1, k2 = "fused_tree_levels", "repulsion_sum"
    records = [
        k1_main_path_record(kernels, torch, dev, d,
                            spy.launches(k1, (d, 2, 2, 3)))
        for d in (4096, 1 << 16, 1 << 20)]
    records.append(k2_main_path_record(kernels, torch, dev,
                                       spy.launches(k2, (8192, 8192))))
    done = {(rec["name"], tuple(rec["shape"])) for rec in records}

    phase("10 fast schemes at D=2^16: 2SPLIT2A, 4SPLIT4B, 2SPLIT3A, 2SPLIT8B")
    fast_schemes_full_width(ft, spy, torch, dev)

    phase("11 the reference's table rows on the card")
    reference_table_rows(ft, spy, torch, dev)

    phase("12 a slow scheme at D = m = 4096")
    slow_scheme_at_size(ft, spy, torch, dev)

    phase("13 deflated Aberth: full spectrum at D=2^18")
    deflated_aberth(ft, spy, torch, dev)

    phase("14 kdvv")
    kdvv_paths(ft, spy, torch, dev)
    spy.remove()

    phase("15 kernels at every shape the paths gave them")
    records += records_of_kept(spy, torch, done)
    for name, shape in (
            (k1, (1 << 16, 2, 2, 2)), (k1, (1 << 16, 2, 2, 4)),
            (k1, (1 << 17, 2, 2, 3)), (k1, (1 << 18, 2, 2, 3)),
            (k2, (18724, 18724)), (k2, (1 << 14, 1 << 14))):
        check((name, shape) in spy.kept, f"{name} never ran at {shape}")
    check(any(name == k2 and shape[1] < shape[0] for name, shape in spy.kept),
          "K2 never ran on an active set")

    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
