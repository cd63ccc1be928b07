#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fnft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from fnft_tpu_torch/csrc with nvcc, holds each
against its plain PyTorch version at the shapes of the nsev main path
and at ragged, batched and clustered ones, then drives
``fnft_tpu_torch.nsev`` (default options, 2SPLIT4B) on the Satsuma-Yajima
sech at D = 4096, 2^16 and 2^20 and checks the errors against the
reference bounds and that the kernels were launched. Any failure raises
and exits non-zero. It also profiles one warm run at D = 2^16 (device
time, K1's and K2's share, the device's busy share of the wall). The
second line from the end is a JSON record of the kernels at the main
path's shapes: device time of the kernel and of its plain version (both
by CUDA-graph replay), and the least time the H100 could take for the
same work (bytes at 3.35 TB/s, or operations at 34 TFLOP/s fp64 and
67 TFLOP/s fp32, the larger). The last line is
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


def record(name, source, replaces, shape, launches, err, ms, plain_ms,
           work) -> dict:
    bound_ms, bound_by = bound(*work)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape, "launches": launches,
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


def k1_main_path_record(kernels, torch, dev, d, launches) -> dict:
    """K1 at the full pass of D: D 2SPLIT4B matrices, complex128."""
    from fnft_tpu_torch.ops import fscatter as fs
    from fnft_tpu_torch.testcases import NsevTestcase, nsev_testcase

    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    q = torch.as_tensor(data.q).to(dev)
    eps_t = (data.t_span[1] - data.t_span[0]) / (q.shape[0] - 1)
    p = fs.transfer_matrix_coeffs(q, -torch.conj(q), eps_t,
                                  fs.Discretization.SPLIT4B).contiguous()
    got, w = kernels.fused_tree_levels(p, 2, normalize=True)
    ref, w_ref = kernels.fused_tree_levels_plain(p, 2, normalize=True)
    torch.cuda.synchronize()
    check(torch.equal(w, w_ref), f"K1 main path D={d}: w differs")
    check(rel_dev(got, ref) <= 1e-12,
          f"K1 main path D={d}: {rel_dev(got, ref):.3e} > 1e-12")
    ms = graph_ms(lambda: kernels.fused_tree_levels(p, 2, normalize=True),
                  reps=50)
    plain_ms = graph_ms(lambda: kernels.fused_tree_levels_plain(
        p, 2, normalize=True), reps=5, replays=2)
    rec = record("fused_tree_levels", "fnft_tpu_torch/csrc/tree_levels.cu",
                 "fnft_tpu/ops/pallas_kernels.py:113", list(p.shape),
                 launches, float((got - ref).abs().max()), ms, plain_ms,
                 k1_work(d // 4, 3, 8))
    print(f"K1 {list(p.shape)} c128: kernel {ms:.4f} ms "
          f"({rec['pct_of_bound']:.1f}% of its {rec['bound_by']} bound "
          f"{rec['bound_ms']:.4f} ms), plain {plain_ms:.4f} ms")
    return rec


def k2_main_path_record(kernels, torch, dev, launches) -> dict:
    """K2 at the D = 2^16 sub pass: deg = m = 8192 roots, complex128."""
    rng = np.random.default_rng(3)
    ang = 2 * np.pi * rng.random(8192)
    z = torch.as_tensor(np.exp(1j * ang) * (1 + 0.01 * rng.normal(size=8192))
                        ).to(dev)
    idx = torch.arange(8192, dtype=torch.int32, device=dev)
    got = kernels.repulsion_sum(z, z, idx)
    ref = kernels.repulsion_sum_plain(z, z, idx)
    torch.cuda.synchronize()
    check(rel_dev(got, ref) <= 1e-5,
          f"K2 main path: {rel_dev(got, ref):.3e} > 1e-5")
    ms = graph_ms(lambda: kernels.repulsion_sum(z, z, idx))
    plain_ms = graph_ms(lambda: kernels.repulsion_sum_plain(z, z, idx),
                        reps=5, replays=2)
    rec = record("repulsion_sum", "fnft_tpu_torch/csrc/repulsion.cu",
                 "fnft_tpu/ops/pallas_kernels.py:254", [8192, 8192],
                 launches, float((got - ref).abs().max()), ms, plain_ms,
                 k2_work(8192, 8192))
    print(f"K2 deg=m=8192 c128 lowprec: kernel {ms:.4f} ms "
          f"({rec['pct_of_bound']:.1f}% of its {rec['bound_by']} bound "
          f"{rec['bound_ms']:.4f} ms), plain {plain_ms:.4f} ms")
    return rec


def nsev_call(ft, torch, dev, d, bound_states):
    """The sech at D samples, and a call of nsev on it as a tensor on the
    card (default options, contspec and discspec BOTH)."""
    from fnft_tpu_torch.testcases import NsevTestcase, nsev_testcase

    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    q = torch.as_tensor(data.q).to(dev)
    opts = ft.NsevOpts(contspec_type=ft.ContspecType.BOTH,
                       discspec_type=ft.DiscspecType.BOTH)
    return data, lambda: ft.nsev(q, data.t_span, m=data.m,
                                 xi_span=data.xi_span, opts=opts,
                                 want_bound_states=bound_states)


def run_nsev(ft, kernels, torch, dev, d, *, bound_states=True, warm=1):
    """A cold run, then ``warm`` warm runs of nsev on the sech at D samples,
    each with the launch counts set to 0 just before it; returns (errors,
    warm seconds, launch counts of the first warm run, result)."""
    from fnft_tpu_torch.testcases import nsev_errors

    data, call = nsev_call(ft, torch, dev, d, bound_states)
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    walls, launches = [], None
    for _ in range(warm):
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = launches or dict(kernels.LAUNCHES)
    errs = nsev_errors(res, data)
    n_bs = None if res.bound_states is None else int(res.bound_states.numel())
    print(f"nsev D={d}: cold {cold:.4f} s, warm "
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import fnft_tpu_torch as ft
    from fnft_tpu_torch.ops import _build, kernels

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

    phase("3 K1 kernel vs plain")
    check_k1(kernels, torch, dev)

    phase("4 K2 kernel vs plain")
    check_k2(kernels, torch, dev)

    phase("5 nsev D=4096")
    errs, walls_12, launches, res = run_nsev(ft, kernels, torch, dev, 4096,
                                             warm=3)
    for key, bound_ in zip(KEYS, BOUNDS_4096):
        check(errs[key] is not None and errs[key] <= bound_,
              f"D=4096 {key}: {errs[key]} > {bound_}")
    check(launches["fused_tree_levels"] > 0, "D=4096: K1 not launched")
    check_default_device(ft, torch, res)

    phase("6 nsev D=2^16")
    errs, walls_16, launches_16, res = run_nsev(ft, kernels, torch, dev,
                                                1 << 16, warm=3)
    check(res.bound_states.numel() == 3,
          f"D=2^16: {res.bound_states.numel()} bound states, want 3")
    for key, bound_ in zip(KEYS[:4], BOUNDS_4096[:4]):
        check(errs[key] <= bound_, f"D=2^16 {key}: {errs[key]} > {bound_}")
    check(launches_16["fused_tree_levels"] > 0, "D=2^16: K1 not launched")
    check(launches_16["repulsion_sum"] > 0, "D=2^16: K2 not launched")

    phase("7 nsev D=2^20 contspec")
    errs, walls_20, launches_20, _ = run_nsev(
        ft, kernels, torch, dev, 1 << 20, bound_states=False, warm=3)
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
    records = [
        k1_main_path_record(kernels, torch, dev, 4096,
                            launches["fused_tree_levels"]),
        k1_main_path_record(kernels, torch, dev, 1 << 16,
                            launches_16["fused_tree_levels"]),
        k1_main_path_record(kernels, torch, dev, 1 << 20,
                            launches_20["fused_tree_levels"]),
        k2_main_path_record(kernels, torch, dev,
                            launches_16["repulsion_sum"]),
    ]
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
