#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fnft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from fnft_tpu_torch/csrc with nvcc, holds each
against its plain PyTorch version at the shapes of the nsev main path,
then drives ``fnft_tpu_torch.nsev`` (default options, 2SPLIT4B) on the
Satsuma-Yajima sech at D = 4096, 2^16 and 2^20 and checks the errors
against the reference bounds and that the kernels were launched. Any
failure raises and exits non-zero. The second line from the end is a JSON
record of the kernels; the last line is
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


def check(cond: bool, message: str) -> None:
    if not cond:
        raise AssertionError(message)


def rel_dev(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check_k1(kernels, torch, dev) -> None:
    rng = np.random.default_rng(1)
    for shape in ((1024, 2, 2, 3), (1024, 2, 2, 2), (3, 512, 2, 2, 2)):
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


def check_k2(kernels, torch, dev) -> None:
    rng = np.random.default_rng(2)
    for deg, m in ((97, 23), (700, 700), (1500, 300), (8192, 8192)):
        z_all = torch.as_tensor(rng.normal(size=deg)
                                + 1j * rng.normal(size=deg)).to(dev)
        idx = torch.as_tensor(np.sort(rng.choice(deg, size=m, replace=False))
                              .astype(np.int32)).to(dev)
        z_t = z_all[idx.long()]
        self_mask = idx.long()[:, None] == torch.arange(deg, device=dev)[None]
        oracle = torch.where(self_mask, 0.0, 1.0 / torch.where(
            self_mask, 1.0, z_t[:, None] - z_all[None, :])).sum(dim=1)
        exact = kernels.repulsion_sum(z_all, z_t, idx, lowprec=False)
        low = kernels.repulsion_sum(z_all, z_t, idx, lowprec=True)
        low_ref = kernels.repulsion_sum_plain(z_all, z_t, idx, lowprec=True)
        torch.cuda.synchronize()
        d_exact, d_low = rel_dev(exact, oracle), rel_dev(low, low_ref)
        check(d_exact <= 1e-12, f"K2 ({deg},{m}) exact: {d_exact:.3e}")
        check(d_low <= 1e-5, f"K2 ({deg},{m}) lowprec: {d_low:.3e}")
        print(f"K2 deg={deg} m={m}: rel dev vs oracle {d_exact:.3e}, "
              f"lowprec vs plain {d_low:.3e}")


def k1_main_path_record(kernels, torch, dev, launches) -> dict:
    """K1 at the D = 2^16 full pass: 65536 2SPLIT4B matrices, complex128."""
    from fnft_tpu_torch.ops import fscatter as fs
    from fnft_tpu_torch.testcases import NsevTestcase, nsev_testcase

    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, 1 << 16)
    q = torch.as_tensor(data.q).to(dev)
    eps_t = (data.t_span[1] - data.t_span[0]) / (q.shape[0] - 1)
    p = fs.transfer_matrix_coeffs(q, -torch.conj(q), eps_t,
                                  fs.Discretization.SPLIT4B).contiguous()
    got, w = kernels.fused_tree_levels(p, 2, normalize=True)
    ref, w_ref = kernels.fused_tree_levels_plain(p, 2, normalize=True)
    torch.cuda.synchronize()
    check(torch.equal(w, w_ref), "K1 main-path w differs")
    check(rel_dev(got, ref) <= 1e-12,
          f"K1 main path: {rel_dev(got, ref):.3e} > 1e-12")
    ms = time_ms(lambda: kernels.fused_tree_levels(p, 2, normalize=True))
    plain_ms = time_ms(lambda: kernels.fused_tree_levels_plain(
        p, 2, normalize=True))
    print(f"K1 [65536,2,2,3] c128: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "fused_tree_levels", "route": "cuda",
            "source": "fnft_tpu_torch/csrc/tree_levels.cu",
            "replaces": "fnft_tpu/ops/pallas_kernels.py:113",
            "launches": launches,
            "max_abs_err": float((got - ref).abs().max()),
            "ms": ms, "plain_ms": plain_ms}


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
    ms = time_ms(lambda: kernels.repulsion_sum(z, z, idx))
    plain_ms = time_ms(lambda: kernels.repulsion_sum_plain(z, z, idx))
    print(f"K2 deg=m=8192 c128 lowprec: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    return {"name": "repulsion_sum", "route": "cuda",
            "source": "fnft_tpu_torch/csrc/repulsion.cu",
            "replaces": "fnft_tpu/ops/pallas_kernels.py:254",
            "launches": launches,
            "max_abs_err": float((got - ref).abs().max()),
            "ms": ms, "plain_ms": plain_ms}


def run_nsev(ft, kernels, torch, dev, d, *, bound_states=True):
    """Two runs (cold, warm) of nsev on the sech at D samples; returns
    (errors, warm seconds, kernel launches of the warm run, result)."""
    from fnft_tpu_torch.testcases import (NsevTestcase, nsev_errors,
                                          nsev_testcase)

    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    q = torch.as_tensor(data.q).to(dev)
    opts = ft.NsevOpts(contspec_type=ft.ContspecType.BOTH,
                       discspec_type=ft.DiscspecType.BOTH)
    kw = dict(m=data.m, xi_span=data.xi_span, opts=opts,
              want_bound_states=bound_states)
    t0 = time.perf_counter()
    ft.nsev(q, data.t_span, **kw)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = ft.nsev(q, data.t_span, **kw)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    errs = nsev_errors(res, data)
    n_bs = None if res.bound_states is None else int(res.bound_states.numel())
    print(f"nsev D={d}: cold {cold:.4f} s, warm {warm:.4f} s, "
          f"bound states {n_bs}, launches {launches}")
    print("  errors " + ", ".join(
        f"{k}={errs[k]:.3e}" if errs[k] is not None else f"{k}=None"
        for k in KEYS))
    return errs, warm, launches, res


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
    errs, _, launches, _ = run_nsev(ft, kernels, torch, dev, 4096)
    for key, bound in zip(KEYS, BOUNDS_4096):
        check(errs[key] is not None and errs[key] <= bound,
              f"D=4096 {key}: {errs[key]} > {bound}")
    check(launches["fused_tree_levels"] > 0, "D=4096: K1 not launched")

    phase("6 nsev D=2^16")
    errs, _, launches_16, res = run_nsev(ft, kernels, torch, dev, 1 << 16)
    check(res.bound_states.numel() == 3,
          f"D=2^16: {res.bound_states.numel()} bound states, want 3")
    for key, bound in zip(KEYS[:4], BOUNDS_4096[:4]):
        check(errs[key] <= bound, f"D=2^16 {key}: {errs[key]} > {bound}")
    check(launches_16["fused_tree_levels"] > 0, "D=2^16: K1 not launched")
    check(launches_16["repulsion_sum"] > 0, "D=2^16: K2 not launched")

    phase("7 nsev D=2^20 contspec")
    errs, _, launches, _ = run_nsev(ft, kernels, torch, dev, 1 << 20,
                                    bound_states=False)
    check(errs["contspec"] <= BOUNDS_4096[0],
          f"D=2^20 contspec: {errs['contspec']} > {BOUNDS_4096[0]}")
    check(launches["fused_tree_levels"] > 0, "D=2^20: K1 not launched")

    phase("8 kernels at the main path's shapes")
    records = [
        k1_main_path_record(kernels, torch, dev,
                            launches_16["fused_tree_levels"]),
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
