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
with its real-coefficient tree. Then the periodic nsep: every row of the
reference's tests, and the plane wave at D = 2^16 (2SPLIT4B) and 2^18
(2SPLIT2A), where K1 runs in the grid search's and the subsampled tree and
K2 on the batched Aberth rows (the D = 2^18 grid search once more on CPU
tensors, a second witness of the real points it misses); and the inverse:
every case of the
reference's tests, fscatter -> finvscatter at D = 2^16 with the peel's
sub-blocks as CUDA graphs (and once eagerly), and an nsev -> nsev_inverse
round trip with bound states at D = 2^16. Then the batched transforms of
``fnft_tpu_torch.parallel``: the continuous spectrum of B = 64 and 1024
signals at D = M = 4096 (complex128, and B = 64 in complex64), the full
spectrum of B = 16 signals at D = 4096 and B = 4 at 2^16 (K2 taking the
four Aberth rows in one launch), the NFDM link of examples/nfdm_modem.py
with 64 bursts at D = M = 4096, and nsep of B = 2 plane waves at D = 2^16;
each row against the per-signal transform on the card. Each such run
prints its errors, three warm wall times, its launches and its peak device
memory (the batched ones their spectra per second too). While the paths
run, the inputs of each kernel's first launch at every distinct shape (and
transform) are kept, and at the end the kernel is held against its plain
version on each of them (a batched K2 launch also against its rows' own
launches, bit for bit). Any failure
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

import contextlib
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


def k2_work(deg: int, m: int, batch: int = 1) -> tuple[float, dict]:
    """Bytes and flops of K2 (complex128, lowprec) on ``batch`` rows with
    every t_idx < deg: z_all, z_t and s of each row and the shared t_idx
    read or written once; a pair costs two fp64 subtractions and eight
    fp32 operations (|d|^2, reciprocal, two products, two tile sums)."""
    pairs = batch * (m * deg - m)
    return batch * (deg * 16 + m * 32) + m * 4, {"fp64": 2 * pairs,
                                                 "fp32": 8 * pairs}


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
    # a batch of rows in one launch, as the batched Aberth sweeps give it
    # (shared root indices): each row has the bits of its own launch
    for batch, deg, m in ((4, 8192, 8192), (12, 8192, 8192), (3, 5000, 1237),
                          (2, 700, 700)):
        z_all = torch.as_tensor(rng.normal(size=(batch, deg))
                                + 1j * rng.normal(size=(batch, deg))).to(dev)
        idx = torch.as_tensor(np.sort(rng.choice(deg, size=m, replace=False))
                              .astype(np.int32)).to(dev)
        z_t = z_all[:, idx.long()].contiguous()
        for dtype in (torch.complex128, torch.complex64):
            za, zt = z_all.to(dtype), z_t.to(dtype)
            got = kernels.repulsion_sum(za, zt, idx)
            ref = kernels.repulsion_sum_plain(za, zt, idx)
            k2_rows_bitwise(kernels, torch, za, zt, idx, got,
                            f"[{batch}, {deg}, {m}] {dtype}")
            d_b = rel_dev(got, ref)
            check(d_b <= 1e-5, f"K2 [{batch}, {deg}, {m}] {dtype}: {d_b:.3e}")
            print(f"K2 batch={batch} deg={deg} m={m} {str(dtype)[6:]}: vs "
                  f"plain {d_b:.3e}, rows bitwise equal to their own launches")


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
        self.tag = ""      # "" for nsev and kdvv, else the transform's name

    def install(self) -> None:
        self.poly.fused_tree_levels = self._spied(
            "fused_tree_levels", self.kernels.fused_tree_levels)
        self.roots.repulsion_sum = self._spied(
            "repulsion_sum", self.kernels.repulsion_sum)

    def remove(self) -> None:
        self.poly.fused_tree_levels = self.kernels.fused_tree_levels
        self.roots.repulsion_sum = self.kernels.repulsion_sum

    @contextlib.contextmanager
    def aside(self):
        """Launches made to check a path against another (the per-signal
        transforms a batch is held to) are not the path's: the spy steps
        aside for them."""
        self.remove()
        try:
            yield
        finally:
            self.install()

    def _spied(self, name, wrapper):
        def call(*args, **kwargs):
            if name == "fused_tree_levels":
                shape = tuple(args[0].shape)
            else:   # ([B,] deg, m)
                shape = tuple(args[0].shape) + (args[1].shape[-1],)
            key = (name, shape, self.tag)
            self.counts[key] = self.counts.get(key, 0) + 1
            if key not in self.kept:
                self.kept[key] = {
                    "args": tuple(a.clone() if hasattr(a, "clone") else a
                                  for a in args),
                    "kwargs": dict(kwargs), "path": self.path, "launches": 0}
            return wrapper(*args, **kwargs)
        return call

    def begin(self, path: str, tag: str = "") -> None:
        """Start of one run of the path ``path``: every count to 0. Shapes
        are kept apart by ``tag`` too, so that a transform (nsep, the
        inverse) has its own inputs at a shape an earlier path also gave
        the kernel."""
        self.path, self.tag, self.counts = path, tag, {}
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

    def launches(self, name: str, shape, tag: str = "") -> int:
        return self.kept[(name, tuple(shape), tag)]["launches"]


def k1_record(kernels, torch, p, normalize, launches, path,
              timed=True) -> dict | None:
    """K1 (two levels) on the stack ``p`` against its plain version: equal
    exponents, coefficients to 1e-12 in complex128 (5e-6 in complex64);
    with ``timed`` its record."""
    tol = {torch.complex128: 1e-12, torch.complex64: 5e-6}[p.dtype]
    got, w = kernels.fused_tree_levels(p, 2, normalize=normalize)
    ref, w_ref = kernels.fused_tree_levels_plain(p, 2, normalize=normalize)
    torch.cuda.synchronize()
    check(torch.equal(w, w_ref), f"K1 {path} {list(p.shape)}: w differs")
    check(rel_dev(got, ref) <= tol, f"K1 {path} {list(p.shape)}: "
          f"{rel_dev(got, ref):.3e} > {tol}")
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
                 k1_work(n_sub, p.shape[-1], p.element_size() // 2))
    print(f"K1 {list(p.shape)} {str(p.dtype)[6:]} ({path}, {launches} "
          f"launches): kernel "
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


def k2_rows_bitwise(kernels, torch, z_all, z_t, idx, got, what) -> None:
    """A batched K2 launch equals the stack of its rows' own launches, bit
    for bit."""
    rows = torch.stack([kernels.repulsion_sum(za, zt, idx)
                        for za, zt in zip(z_all, z_t)])
    torch.cuda.synchronize()
    check(torch.equal(torch.view_as_real(got), torch.view_as_real(rows)),
          f"K2 {what}: the batched launch differs from its rows' launches")


def k2_record(kernels, torch, z_all, z_t, idx, launches, path,
              timed=True) -> dict | None:
    """K2 (complex128, low precision) on the roots ``z_t = z_all[..., idx]``
    ([deg] or a batch [B, deg]) against its plain version, to 1e-5, and a
    batched launch against its rows' own launches, bit for bit; with
    ``timed`` its record."""
    deg, m = z_all.shape[-1], z_t.shape[-1]
    batch = z_all.shape[0] if z_all.dim() == 2 else 1
    shape = list(z_all.shape) + [m]
    check(z_all.dtype == torch.complex128, f"K2 {path}: {z_all.dtype}")
    got = kernels.repulsion_sum(z_all, z_t, idx)
    ref = kernels.repulsion_sum_plain(z_all, z_t, idx)
    torch.cuda.synchronize()
    check(rel_dev(got, ref) <= 1e-5,
          f"K2 {path} {shape}: {rel_dev(got, ref):.3e} > 1e-5")
    if z_all.dim() == 2:
        k2_rows_bitwise(kernels, torch, z_all, z_t, idx, got,
                        f"{path} {shape}")
    if not timed:
        print(f"K2 {shape} ({path}): max rel dev {rel_dev(got, ref):.3e}"
              + (", rows bitwise" if batch > 1 else ""))
        return None
    ms = graph_ms(lambda: kernels.repulsion_sum(z_all, z_t, idx))
    plain_ms = graph_ms(lambda: kernels.repulsion_sum_plain(z_all, z_t, idx),
                        reps=5 if batch == 1 else 1, replays=2)
    rec = record("repulsion_sum", "fnft_tpu_torch/csrc/repulsion.cu",
                 "fnft_tpu/ops/pallas_kernels.py:254", shape, path,
                 launches, float((got - ref).abs().max()), ms, plain_ms,
                 k2_work(deg, m, batch))
    print(f"K2 {shape} c128 lowprec ({path}, {launches} launches): "
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
    for key, kept in spy.kept.items():
        name, shape, _ = key
        timed = key not in done
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


def drive(spy, torch, path, call, tag="", warm=3):
    """A cold call, then ``warm`` warm calls of ``call`` on the card, each
    with the launch counts set to 0 just before it and read just after.
    Returns (result of the last call, cold seconds, warm seconds, launches
    of the first warm call (of the cold call when ``warm`` is 0), peak
    device MiB over the warm calls)."""
    spy.begin(path, tag)
    t0 = time.perf_counter()
    res = call()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = spy.end()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(warm):
        spy.begin(path, tag)
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counted = spy.end()
        if i == 0:
            launches = counted
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    return res, cold, walls, launches, peak


def run_nsev(ft, spy, torch, dev, d, *, bound_states=True, warm=1,
             scheme="SPLIT4B"):
    """A cold run, then ``warm`` warm runs of nsev on the sech at D samples
    (:func:`drive`); returns (errors, warm seconds, launch counts of the
    first warm run, result)."""
    from fnft_tpu_torch.testcases import nsev_errors

    data, call = nsev_call(ft, torch, dev, d, bound_states, scheme)
    res, cold, walls, launches, _ = drive(spy, torch, f"{scheme} D={d}",
                                          call, warm=warm)
    errs = nsev_errors(res, data)
    n_bs = None if res.bound_states is None else int(res.bound_states.numel())
    print(f"nsev {scheme} D={d}: cold {cold:.4f} s, warm "
          + " ".join(f"{t:.4f}" for t in walls)
          + f" s, bound states {n_bs}, launches {launches}")
    print("  errors " + ", ".join(
        f"{k}={errs[k]:.3e}" if errs[k] is not None else f"{k}=None"
        for k in KEYS))
    return errs, walls, launches, res


def device_profile(torch, call) -> dict:
    """One warm ``call()`` under torch.profiler: its wall seconds, the
    device time of all device activity (kernels, copies), of K1's and K2's
    kernels (ms), and the device's busy share of the wall (%)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    check(total > 0, "profile: no device time seen")
    return {"wall": wall, "device_ms": total / 1e3, "k1_ms": k1 / 1e3,
            "k2_ms": k2 / 1e3, "busy": total / 1e4 / wall}


def profile_nsev(ft, torch, dev, d) -> None:
    """One warm nsev at D samples under torch.profiler (device_profile)."""
    _, call = nsev_call(ft, torch, dev, d, True)
    prof = device_profile(torch, call)
    total, k1, k2 = prof["device_ms"], prof["k1_ms"], prof["k2_ms"]
    check(k1 > 0 and k2 > 0,
          f"profile D={d}: no kernel time seen ({total}, {k1}, {k2} ms)")
    print(f"profiled nsev D={d}: wall {prof['wall']:.4f} s, device "
          f"{total:.3f} ms (busy {prof['busy']:.2f}%), K2 {k2:.3f} ms "
          f"({100 * k2 / total:.2f}%), K1 {k1:.3f} ms "
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
    if seeded:
        def call():
            return ft.nsev_with_initial_states(q, data.t_span,
                                               data.bound_states, **kw)
    else:
        def call():
            return ft.nsev(q, data.t_span, **kw)
    res, wall, *_ = drive(spy, torch, f"{scheme} D={d}"
                          f"{' Richardson' if rich else ''}, {case}", call,
                          warm=0)
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
        res, _, walls, launches, _ = drive(
            spy, torch, f"kdvv SPLIT8B D={d}, {label} potential",
            lambda: ft.kdvv(arg, t_span, m=m, xi_span=xi_span, opts=opts),
            warm=1)
        err = float(rel_err(res.reflection_coefficient, exact))
        print(f"  kdvv 2SPLIT8B D=2^16 m=2^12 {label} potential: error "
              f"{err:.3e}, warm wall {walls[0]:.4f} s, launches {launches}")
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
    res, _, _, launches, _ = drive(
        spy, torch, f"kdvv SPLIT2A D={d}, complex potential",
        lambda: ft.kdvv(ut + 0j, t_span, m=m, xi_span=xi_span,
                        opts=ft.KdvvOpts(
                            discretization=ft.Discretization.SPLIT2A)),
        warm=0)
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


def timing(cold, walls, launches, peak) -> str:
    return (f"cold {cold:.4f} s, warm " + " ".join(f"{t:.4f}" for t in walls)
            + f" s, launches {launches}, peak {peak:.1f} MiB")


NSEP_BOX = (-10.0, 10.0, -10.0, 10.0)
# rows of tests/test_nsep.py (the reference's test/fnft_nsep/*.c bounds):
# (testcase, scheme, D, main bound, aux bound, box)
NSEP_ROWS = [
    ("plane_wave", "SPLIT2A", 1024, 3.2e-4, 2.9e-4, NSEP_BOX),
    ("plane_wave", "SPLIT2_MODAL", 1024, 3.5e-4, 3.1e-4, NSEP_BOX),
    ("plane_wave", "SPLIT4B", 1024, 9.6e-5, 4.4e-5, NSEP_BOX),
    ("plane_wave", "SPLIT4A", 1024, 6.3e-5, 4.6e-5, NSEP_BOX),
    ("plane_wave", "SPLIT2A", 1024, 4.5e-5, 4.4e-5, (-10.0, 10.0, 0.1, 10.0)),
    ("constant", "SPLIT2A", 2048, 7.6e-5, 7.6e-8, NSEP_BOX),
    ("constant", "SPLIT2_MODAL", 2048, 7.6e-5, 7.6e-8, NSEP_BOX),
    ("constant", "SPLIT4B", 1024, 7.6e-5, 2.5e-8, NSEP_BOX),
    ("constant", "SPLIT4A", 512, 7.6e-5, 2.5e-8, NSEP_BOX),
    ("constant", "SPLIT4A4", 64, 6.8e-4, 1.3e-6, NSEP_BOX),
    ("plane_wave", "SPLIT4B4", 512, 1.6e-4, 6.1e-7, NSEP_BOX),
]


def nsep_case(name, d, **kw):
    from fnft_tpu_torch.testcases import (nsep_constant_defocusing_case,
                                          nsep_plane_wave_case)

    if name == "plane_wave":
        return nsep_plane_wave_case(d, **kw)
    return nsep_constant_defocusing_case(d)


def nsep_opts(ft, scheme, box=NSEP_BOX, loc="MIXED", **kw):
    return ft.NsepOpts(filtering=ft.PointFilter.MANUAL, bounding_box=box,
                       localization=ft.Localization[loc],
                       discretization=ft.Discretization[scheme], **kw)


def nsep_row(ft, spy, torch, dev, name, scheme, d, main_bound, aux_bound,
             box, warm=3, **kw):
    """nsep (MIXED, manual box) on a test signal at D samples on the card,
    held to the row's bounds on the main and auxiliary spectra. Returns
    the launches of a warm call."""
    from fnft_tpu_torch.testcases import nsep_errors

    q, t_span, kappa, main, aux, remove_box = nsep_case(name, d, **kw)
    qt = torch.as_tensor(q).to(dev)
    opts = nsep_opts(ft, scheme, box)
    path = f"nsep {scheme} D={d} {name}{' non-real box' if box[2] > 0 else ''}"
    res, *run = drive(spy, torch, path, lambda: ft.nsep(
        qt, t_span, kappa=kappa, opts=opts), "nsep", warm)
    check(res.main_spectrum.device.type == res.aux_spectrum.device.type
          == dev.type, f"{path}: a spectrum left the card")
    em, ea = nsep_errors(res, main, aux, box, remove_box)
    print(f"{path}: main {em:.3e} <= {main_bound}, aux {ea:.3e} <= "
          f"{aux_bound}; " + timing(*run))
    if em > main_bound or ea > aux_bound:
        for label, got, exact in (("main", res.main_spectrum, main),
                                  ("aux", res.aux_spectrum, aux)):
            got = got.cpu().numpy()
            got = got[(np.abs(got.real) <= 10) & (np.abs(got.imag) <= 10)]
            dist = np.abs(got[:, None] - exact[None, :])
            far = np.argsort(-dist.min(axis=1))[:4]
            missed = np.argsort(-dist.min(axis=0))[:4]
            print(f"  {label}: farthest computed points {got[far].tolist()}, "
                  f"worst-matched exact points {exact[missed].tolist()} "
                  f"({dist.min(axis=0)[missed].tolist()})")
    check(em <= main_bound and ea <= aux_bound,
          f"{path}: main {em:.3e}, aux {ea:.3e} over the bounds")
    return run[2]


def nsep_reference_rows(ft, spy, torch, dev) -> None:
    """Every row of tests/test_nsep.py on the card, at its D and within its
    bounds, and its other checks: spines, the quasi-periodic shift, the
    complex64 aux certificate, the defocusing main-only call."""
    for name, scheme, d, mb, ab, box in NSEP_ROWS:
        nsep_row(ft, spy, torch, dev, name, scheme, d, mb, ab, box)
    # quasi-periodic: 2 exp(3.5 i t) with phase_shift pi is the plane wave's
    # spectrum shifted by -0.25 (bound 5e-4 on the main spectrum)
    from fnft_tpu_torch.testcases import nsep_errors

    q, t_span, kappa, main, aux, remove_box = nsep_case("plane_wave", 1024,
                                                        nu=3.5)
    qt = torch.as_tensor(q).to(dev)
    res, *run = drive(spy, torch, "nsep quasi-periodic D=1024", lambda: ft.nsep(
        qt, t_span, kappa=kappa, phase_shift=np.pi,
        opts=nsep_opts(ft, "SPLIT2A")), "nsep")
    em, _ = nsep_errors(res, main, aux, NSEP_BOX, remove_box)
    print(f"nsep quasi-periodic D=1024: main {em:.3e} <= 5e-4; "
          + timing(*run))
    check(em <= 5e-4, f"quasi-periodic: {em:.3e}")
    # spines: 5 points per spine give more points, off the axis on Re = -1.5
    q, t_span, *_ = nsep_case("plane_wave", 512)
    qt = torch.as_tensor(q).to(dev)
    counts = {}
    for n in (2, 5):
        res, *run = drive(spy, torch, f"nsep spines {n} D=512", lambda: ft.nsep(
            qt, t_span, want_aux=False, opts=nsep_opts(
                ft, "SPLIT2A", loc="SUBSAMPLE_AND_REFINE",
                points_per_spine=n)), "nsep")
        check(res.aux_spectrum is None, "spines: aux spectrum not asked for")
        counts[n] = res.main_spectrum.numel()
        print(f"nsep spines {n} points D=512: {counts[n]} points; "
              + timing(*run))
    # off the real axis (|Im| > 0.05, as tests/test_nsep.py) the spine
    # points lie on Re = -1.5
    sp = res.main_spectrum.cpu().numpy()
    off = sp[np.abs(sp.imag) > 0.05]
    off_axis = float(np.max(np.abs(off.real + 1.5)))
    near = sp[np.abs(sp + 1.5) < 0.05]
    print(f"  spine points off the axis: |Re + 1.5| <= {off_axis:.3e}; "
          f"within 0.05 of the crossing -1.5: {near.tolist()}")
    check(counts[5] > 1.5 * counts[2] and off_axis < 1e-3,
          f"spines: {counts}, off-axis |Re + 1.5| {off_axis:.3e}: "
          f"{off[np.abs(off.real + 1.5) >= 1e-3].tolist()}")
    # complex64: the aux certificate in complex64's eps keeps the aux roots
    q, t_span, *_ = nsep_case("plane_wave", 256)
    qt = torch.as_tensor(q.astype(np.complex64)).to(dev)
    res, *run = drive(spy, torch, "nsep complex64 D=256", lambda: ft.nsep(
        qt, t_span, opts=nsep_opts(ft, "SPLIT2A", (-5.0, 5.0, -5.0, 5.0),
                                   "SUBSAMPLE_AND_REFINE")), "nsep")
    j = np.arange(1, 50)
    aux_e = -1.5 + 1j * np.concatenate([np.sqrt(4 - j * j / 4.0 + 0j),
                                        -np.sqrt(4 - j * j / 4.0 + 0j)])
    aux_e = aux_e[(np.abs(aux_e.real) < 5) & (np.abs(aux_e.imag) < 5)]
    aux = res.aux_spectrum.cpu().numpy()
    err = max(float(np.min(np.abs(aux - e))) if aux.size else np.inf
              for e in aux_e if abs(e.imag) > 0.3)
    print(f"nsep complex64 D=256: {aux.size} aux points, error {err:.3e} "
          f"< 5e-3; " + timing(*run))
    check(res.aux_spectrum.dtype == torch.complex64 and err < 5e-3,
          f"complex64: {res.aux_spectrum.dtype}, aux error {err:.3e}")
    ones = torch.ones(64, dtype=torch.complex128, device=dev)
    res, *run = drive(spy, torch, "nsep defocusing main only D=64",
                      lambda: ft.nsep(ones, (0.0, 2 * np.pi), kappa=-1,
                                      want_aux=False), "nsep")
    check(res.aux_spectrum is None and res.main_spectrum.numel() > 0,
          "defocusing main-only call")
    print(f"nsep defocusing, main only, D=64: {res.main_spectrum.numel()} "
          f"points; " + timing(*run))


def nsep_full_width(ft, spy, torch, dev) -> None:
    """The chirp-Z tables and grid memory at m = 2^23, one call with the
    default options (AUTO box) at D = 2^16, then the plane wave at D = 2^16
    (2SPLIT4B, box +-10) and 2^18 (2SPLIT2A, the non-real box; then the
    whole box), MIXED: grid search on the full-D monodromy polynomial (K1
    in its tree), subsample-and-refine on Dsub samples (K1 in that tree, K2
    on the batched rows of degree > 4096), held to the reference's D = 1024
    bounds for the scheme and box."""
    from fnft_tpu_torch.models import nsep as nsep_mod
    from fnft_tpu_torch.ops import gridsearch, poly

    k1, k2 = "fused_tree_levels", "repulsion_sum"
    # chirp-Z tables of the D = 2^18 grid search (m = 2^23, three rings):
    # built on the host in extended precision, once per geometry
    n, m = (1 << 18) + 1, 32 * (1 << 18)
    phi0, phi1 = sorted(2.0 * (2 * np.pi / (1 << 18)) * b for b in (-10, 10))
    eps = (phi1 - phi0) / (m - 1)
    poly._chirpz_tables.cache_clear()
    t0 = time.perf_counter()
    for k in (-1, 0, 1):
        poly._chirpz_tables(complex(np.exp(1j * phi0) / (1.0 + k * eps)),
                            complex(np.exp(1j * eps)), n, m,
                            torch.complex128, dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    coeffs = torch.randn(n, dtype=torch.complex128, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gridsearch.roots_fftgridsearch(coeffs, phi0=phi0, phi1=phi1, m=m)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    grid_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    print(f"  chirp-Z tables at m=2^23, deg 2^18: {cold:.3f} s cold for the "
          f"three rings; one grid search with them {warm:.4f} s, "
          f"{grid_mib:.1f} MiB of device memory above its input")
    # default options (AUTO box): the box is what the grid resolves, so
    # Newton refines thousands of candidates, in lambda slices
    seen = {}
    orig = nsep_mod._refine_mainspec, nsep_mod._refine_auxspec

    def count(which, fn):
        def call(q_eff, r_eff, lam0, *args):
            seen[which] = int(lam0.numel())
            return fn(q_eff, r_eff, lam0, *args)
        return call

    nsep_mod._refine_mainspec = count("main", orig[0])
    nsep_mod._refine_auxspec = count("aux", orig[1])
    try:
        q, t_span, *_ = nsep_case("plane_wave", 1 << 16)
        qt = torch.as_tensor(q).to(dev)
        res, *run = drive(spy, torch, "nsep default options D=65536",
                          lambda: ft.nsep(qt, t_span), "nsep", warm=1)
    finally:
        nsep_mod._refine_mainspec, nsep_mod._refine_auxspec = orig
    check(res.main_spectrum.numel() > 0 and res.aux_spectrum.numel() > 0,
          "default options: empty spectra")
    print(f"  default options (2SPLIT2A, MIXED, AUTO box) D=2^16: Newton "
          f"candidates {seen}, {res.main_spectrum.numel()} main and "
          f"{res.aux_spectrum.numel()} aux points; " + timing(*run))
    # 2SPLIT2A at D = 2^18 is held to the reference's non-real box and its
    # bounds (tests/test_nsep.py): its grid of 2^23 points does not always
    # keep the plane wave's real double points (below)
    for scheme, d, mb, ab, box, n_full, n_sub, c in (
            ("SPLIT4B", 1 << 16, 9.6e-5, 4.4e-5, NSEP_BOX, 1 << 16, 4096, 3),
            ("SPLIT2A", 1 << 18, 4.5e-5, 4.4e-5, NSEP_ROWS[4][5], 1 << 18,
             1 << 14, 2)):
        launches = nsep_row(ft, spy, torch, dev, "plane_wave", scheme, d, mb,
                            ab, box)
        by_k1, by_k2 = spy.by_shape(k1), spy.by_shape(k2)
        deg = n_sub * (c - 1)
        print(f"  K1 by shape {by_k1}, K2 by shape {by_k2}")
        check((n_full, 2, 2, c) in by_k1 and (n_sub, 2, 2, c) in by_k1,
              f"nsep {scheme} D={d}: K1 missed a tree: {by_k1}")
        check(launches[k2] > 0 and set(by_k2) == {(3, deg, deg)},
              f"nsep {scheme} D={d}: K2 {by_k2}, want [3, {deg}, {deg}]: "
              f"3 rows in each launch")
    # the same signal in the whole box: each real double point of the plane
    # wave is a double root of p -+ 2 on the unit circle, which rounding
    # splits along the circle or off it; off it by more than the grid's
    # rings (1e-10 apart at m = 2^23), the 3x3 test rejects the point. Every
    # point found is held to the D = 1024 bounds, the aux spectrum whole; at
    # most one real point may be missed, and the same grid search on CPU
    # tensors, on the polynomials of this run, misses the same points.
    from fnft_tpu_torch.models.discretization import z_to_lambda
    from fnft_tpu_torch.testcases import nsep_errors
    from fnft_tpu_torch.utils.misc import compact_masked

    d = 1 << 18
    q, t_span, kappa, main, aux, remove_box = nsep_case("plane_wave", d)
    qt = torch.as_tensor(q).to(dev)
    grids, orig = [], nsep_mod.roots_fftgridsearch

    def kept(coeffs, **kw):
        grids.append((coeffs.clone(), kw))
        return orig(coeffs, **kw)

    nsep_mod.roots_fftgridsearch = kept
    try:
        res, wall, *_ = drive(spy, torch, f"nsep SPLIT2A D={d} plane_wave "
                              "whole box", lambda: ft.nsep(
                                  qt, t_span, opts=nsep_opts(ft, "SPLIT2A")),
                              "nsep", warm=0)
    finally:
        nsep_mod.roots_fftgridsearch = orig
    em, ea = nsep_errors(res, main, aux, NSEP_BOX, remove_box)
    keep = ((np.abs(main.real) <= 10) & (np.abs(main.imag) <= 10)
            & ~((np.abs(main.real + 1.5) < 0.1) & (np.abs(main.imag) < 0.1)))

    def missed_of(pts, exact):
        dist = np.abs(pts[:, None] - exact[None, :])
        return exact[dist.min(axis=0) > 3.2e-4], dist

    got = res.main_spectrum.cpu().numpy()
    inside = got[(np.abs(got.real) <= 10) & (np.abs(got.imag) <= 10)
                 & ~((np.abs(got.real + 1.5) < 0.1) & (np.abs(got.imag) < 0.1))]
    missed, dist = missed_of(inside, main[keep])
    stray = float(dist.min(axis=1).max())
    # the witness: the main half (p + 2, p - 2) of this run's grid search
    # again on the host's CPU, in the same precision, and the real exact
    # points it misses (the non-real ones are subsample-and-refine's)
    t0 = time.perf_counter()
    on_cpu = [z_to_lambda(compact_masked(*gridsearch.roots_fftgridsearch(
        coeffs.cpu(), **kw)), 2 * np.pi / d, ft.Discretization.SPLIT2A)
        for coeffs, kw in grids[:2]]
    cpu_wall = time.perf_counter() - t0
    on_cpu = torch.cat(on_cpu).numpy()
    missed_cpu, _ = missed_of(on_cpu[np.abs(on_cpu.imag) < 1e-3],
                              main[keep & (main.imag == 0)])
    print(f"nsep SPLIT2A D=2^18 whole box: main {em:.3e} (farthest computed "
          f"point {stray:.3e} from an exact one; exact points missed: "
          f"{missed.tolist()}), aux {ea:.3e}; {wall:.4f} s. The same grid "
          f"search on CPU tensors misses the real points "
          f"{missed_cpu.tolist()} ({cpu_wall:.1f} s)")
    check(stray <= 3.2e-4 and ea <= 2.9e-4 and missed.size <= 1
          and np.all(missed.imag == 0)
          and np.array_equal(np.sort_complex(missed),
                             np.sort_complex(missed_cpu)),
          f"nsep SPLIT2A D=2^18 whole box: stray {stray:.3e}, aux {ea:.3e}, "
          f"missed {missed.tolist()} (CPU tensors: {missed_cpu.tolist()})")


def inverse_reference_cases(ft, spy, torch, dev) -> None:
    """Every case of tests/test_nsev_inverse.py on the card, within its
    bound (the reference's test/fnft_nsev_inverse/*.c)."""
    from fnft_tpu_torch.utils.misc import rel_err

    q8 = np.array([0.1, 0.1j, 0.2, -0.2, 0.0, 0.05 + 0.05j, -0.03j, 0.06])
    t8 = (0.0, 7.0)
    cases = []
    spy.begin("inverse: forward nsev of the round trips", "inverse")
    for m, kappa, method, scheme, bound in (
            (10, +1, "DEFAULT", "SPLIT2A", 0.022),
            (32, +1, "DEFAULT", "SPLIT2A", 5.3e-8),
            (10, -1, "DEFAULT", "SPLIT2A", 0.03),
            (32, -1, "DEFAULT", "SPLIT2A", 0.016),
            (32, +1, "DEFAULT", "SPLIT2_MODAL", 1e-7),
            (8, -1, "TFMATRIX_CONTAINS_AB_FROM_ITER", "SPLIT2A", 0.016)):
        disc = ft.Discretization[scheme]
        xi = ft.nsev_inverse_xi_grid(8, t8, m, disc)
        rho = ft.nsev(torch.as_tensor(q8 + 0j).to(dev), t8, m=m, xi_span=xi,
                      kappa=kappa, opts=ft.NsevOpts(discretization=disc),
                      want_bound_states=False).reflection_coefficient
        opts = ft.NsevInverseOpts(
            discretization=disc,
            contspec_method=ft.InverseCstMethod[method])
        cases.append((f"round trip M={m} kappa={kappa} {scheme} {method}",
                      (rho, xi, 8, t8), dict(kappa=kappa, opts=opts), q8,
                      bound))
    a, t0 = 0.45, 1.2
    t_span = (-25.0, 25.0)
    t = np.linspace(*t_span, 256)
    xi_span = ft.nsev_inverse_xi_grid(256, t_span, 256)
    xi = np.linspace(*xi_span, 256)
    cases.append(("B(tau) D=256", (
        1j / (2 * np.pi) * np.sin(np.pi * a) / np.cosh(t - t0), None, 256,
        t_span), dict(opts=ft.NsevInverseOpts(
            contspec_type=ft.InverseContspecType.B_OF_TAU)),
        1j * a / np.cosh(t - t0), 0.0009))
    cases.append(("b(xi) D=256", (
        1j * np.exp(-2j * xi * t0) * np.sin(np.pi * a) / np.cosh(np.pi * xi),
        xi_span, 256, t_span), dict(opts=ft.NsevInverseOpts(
            contspec_type=ft.InverseContspecType.B_OF_XI)),
        1j * a / np.cosh(t - t0), 0.0009))
    a = 2.45
    t = np.linspace(*t_span, 512)
    xi_span = ft.nsev_inverse_xi_grid(512, t_span, 512)
    xi = np.linspace(*xi_span, 512)
    disc_kw = dict(bound_states=1j * (a - np.arange(2) - 0.5),
                   normconsts_or_residues=np.array([1j, -1j]))
    cases.append(("b(xi) with bound states D=512", (
        1j * np.sin(np.pi * a) / np.cosh(np.pi * xi), xi_span, 512, t_span),
        dict(opts=ft.NsevInverseOpts(
            contspec_type=ft.InverseContspecType.B_OF_XI), **disc_kw),
        1j * a / np.cosh(t), 6.3e-4))
    cases.append(("B(tau) with bound states D=512", (
        1j / (2 * np.pi) * np.sin(np.pi * a) / np.cosh(t), None, 512, t_span),
        dict(opts=ft.NsevInverseOpts(
            contspec_type=ft.InverseContspecType.B_OF_TAU), **disc_kw),
        1j * a / np.cosh(t), 6.3e-4))
    t_span = (-32.0, 32.0)
    cases.append(("multi-soliton CDT D=4096", (None, None, 4096, t_span),
                  dict(bound_states=np.array([0.5j, 1.5j, 2.5j, 3.5j, 4.5j]),
                       normconsts_or_residues=np.array([-1.0, 1, -1, 1, -1]
                                                       ) + 0j),
                  5.0 / np.cosh(np.linspace(*t_span, 4096)), 3.2e-10))
    t_span = (-20.0, 20.0)
    t = np.linspace(*t_span, 512)
    bs = np.array([2.5 + 0.9j, 2.5 + 1.9j, 2.5 + 2.9j])
    nc = np.array([-1.0, 1.0, -1.0]) + 0j
    res = nc * 2j * bs.imag / np.array([np.prod([
        (bs[i] - bs[j]) / (bs[i] - np.conj(bs[j])) for j in range(3)
        if j != i]) for i in range(3)])
    for dstype, vals in (("NORMING_CONSTANTS", nc), ("RESIDUES", res)):
        cases.append((f"add-soliton CDT {dstype} D=512",
                      (None, None, 512, t_span),
                      dict(bound_states=bs, normconsts_or_residues=vals,
                           seed_potential=torch.as_tensor(
                               -0.4 / np.cosh(t) * np.exp(-5j * t)).to(dev),
                           opts=ft.NsevInverseOpts(
                               contspec_method=ft.InverseCstMethod
                               .USE_SEED_POTENTIAL_INSTEAD,
                               discspec_type=ft.InverseDiscspecType[dstype])),
                      3.4 / np.cosh(t) * np.exp(-5j * t), 0.0029))
    d, m = 512, 1024
    t_span = (-32.0, 32.0)
    q_exact = 3.4 / np.cosh(np.linspace(*t_span, d)) * np.exp(
        -4j * np.linspace(*t_span, d))
    xi_span = ft.nsev_inverse_xi_grid(d, t_span, m)
    fwd = ft.nsev(torch.as_tensor(q_exact).to(dev), t_span, m=m,
                  xi_span=xi_span, opts=ft.NsevOpts(
                      discretization=ft.Discretization.SPLIT4B,
                      discspec_type=ft.DiscspecType.NORMING_CONSTANTS))
    check(fwd.bound_states.numel() == 3, "round trip D=512: bound states")
    spy.end()
    cases.append(("round trip with bound states D=512",
                  (fwd.reflection_coefficient, xi_span, d, t_span),
                  dict(bound_states=fwd.bound_states,
                       normconsts_or_residues=fwd.norming_constants),
                  q_exact, 0.014))
    for label, args, kw, exact, bound_ in cases:
        if isinstance(args[0], np.ndarray):
            args = (torch.as_tensor(args[0]).to(dev),) + args[1:]
        q, *run = drive(spy, torch, f"inverse {label}",
                        lambda: ft.nsev_inverse(*args, device=dev, **kw),
                        "inverse")
        err = float(rel_err(q, torch.as_tensor(exact + 0j).to(dev)))
        print(f"inverse {label}: error {err:.3e} <= {bound_}; "
              + timing(*run))
        check(q.device.type == dev.type and err <= bound_,
              f"inverse {label}: {err:.3e} on {q.device}")


def count_ops(torch, fn) -> int:
    """Operations the host dispatches during ``fn()`` (every aten call, on
    the card one kernel launch or a few, views none). A CUDA graph's
    replay is not dispatched: its kernels do not count here. (The profiler
    is no counter for this: it traces each kernel of each replay.)"""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    torch.cuda.synchronize()
    return Count.n


def inverse_full_width(ft, spy, torch, dev) -> None:
    """fscatter(normalize=False) -> finvscatter at D = 2^16 (2SPLIT2A) on
    1.1i sech(t), held to tests/test_finvscatter_staged.py's bounds; the
    peel graphed and eager; one nsev -> nsev_inverse round trip with bound
    states through the seeded CDT at D = 2^16."""
    from fnft_tpu_torch.ops import finvscatter as fi
    from fnft_tpu_torch.ops.fscatter import fscatter
    from fnft_tpu_torch.utils.misc import rel_err

    d = 1 << 16
    disc = ft.Discretization.SPLIT2A
    for t_span, bound_ in (((-20.0, 20.0), 2e-6), ((-8.0, 8.0), 1e-10)):
        eps_t = (t_span[1] - t_span[0]) / (d - 1)
        qt = torch.as_tensor(1.1j / np.cosh(np.linspace(*t_span, d))).to(dev)

        def call():
            tm, _ = fscatter(qt, -torch.conj(qt), eps_t, disc,
                             normalize=False)
            return fi.finvscatter(tm, eps_t, 1, disc)

        q, *run = drive(spy, torch, f"inverse fscatter+finvscatter D={d} "
                        f"T={t_span}", call, "inverse")
        err = float((q - qt).abs().max())
        print(f"fscatter -> finvscatter D=2^16 T={t_span}: max error "
              f"{err:.3e} < {bound_}; " + timing(*run))
        check(err < bound_, f"finvscatter T={t_span}: {err:.3e}")
        check(run[2]["fused_tree_levels"] > 0, "finvscatter: K1 not launched")
    # the peel, graphed (sub-blocks of degree <= 1024 replay CUDA graphs)
    # and eager (the same recursion, one launch an operation)
    spy.begin(f"inverse peel D={d}, graphed and eager", "inverse")
    tm, _ = fscatter(qt, -torch.conj(qt), eps_t, disc, normalize=False)
    t_col = (tm[0, 0], tm[1, 0])
    walls = {}
    for mode in ("graphed", "eager", "graphed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "graphed":
            q_g = fi.finvscatter(tm, eps_t, 1, disc)
        else:
            q_e, _ = fi._recurse_col(t_col, d, eps_t, 1, disc, False)
        torch.cuda.synchronize()
        walls.setdefault(mode, []).append(time.perf_counter() - t0)
    dev_rel = rel_dev(q_e, q_g)
    check(dev_rel <= 1e-12, f"peel: eager and graphed differ by {dev_rel:.3e}")
    graphed_ops = count_ops(torch, lambda: fi.finvscatter(tm, eps_t, 1, disc))
    leaf = fi._GRAPH_LEAF_DEG
    leaf_col = (t_col[0][:leaf + 1].clone(), t_col[1][:leaf + 1].clone())
    leaf_ops = count_ops(torch, lambda: fi._recurse_col(leaf_col, leaf, eps_t,
                                                        1, disc, True))
    n_leaves = d // leaf
    spy.end()
    print(f"  peel D=2^16: graphed {min(walls['graphed']):.4f} s, "
          f"{graphed_ops} dispatched operations and {n_leaves} graph "
          f"replays; eager {walls['eager'][0]:.4f} s, {leaf_ops} dispatched "
          f"operations in each of its {n_leaves} degree-{leaf} leaves, "
          f"~{n_leaves * leaf_ops} in all; eager vs graphed {dev_rel:.1e}")
    # round trip with bound states at D = 2^16 (tests/test_nsev_inverse.py's
    # D = 512 case, bound 0.014)
    m = 2 * d
    t_span = (-32.0, 32.0)
    t = np.linspace(*t_span, d)
    q_exact = torch.as_tensor(3.4 / np.cosh(t) * np.exp(-4j * t)).to(dev)
    xi_span = ft.nsev_inverse_xi_grid(d, t_span, m)
    fwd, fwd_wall, *_ = drive(
        spy, torch, f"inverse round trip D={d}: forward nsev",
        lambda: ft.nsev(q_exact, t_span, m=m, xi_span=xi_span,
                        opts=ft.NsevOpts(
                            discretization=ft.Discretization.SPLIT4B,
                            discspec_type=ft.DiscspecType.NORMING_CONSTANTS)),
        "inverse", warm=0)
    check(fwd.bound_states.numel() == 3,
          f"round trip D=2^16: {fwd.bound_states.numel()} bound states")
    q, *run = drive(spy, torch, "inverse round trip D=65536",
                    lambda: ft.nsev_inverse(
                        fwd.reflection_coefficient, xi_span, d, t_span,
                        bound_states=fwd.bound_states,
                        normconsts_or_residues=fwd.norming_constants),
                    "inverse")
    err = float(rel_err(q, q_exact))
    print(f"  nsev -> nsev_inverse D=2^16 M=2^17 with 3 bound states: error "
          f"{err:.3e} <= 0.014; forward {fwd_wall:.4f} s, inverse "
          + timing(*run))
    check(err <= 0.014, f"round trip D=2^16: {err:.3e}")


SECH_AMPS = (1.2, 2.3, 3.4, 4.45)   # 1, 2, 3 and 4 bound states


def batch_timing(b, run) -> str:
    """timing() of a batched run and its spectra per second (B over the
    least warm wall)."""
    cold, walls, launches, peak = run
    return (timing(cold, walls, launches, peak)
            + f", {b / min(walls):.1f} spectra/s")


def batched_contspec(ft, spy, torch, dev) -> None:
    """make_nsev_batch_fn (2SPLIT4B, D = M = 4096) on B = 64 and 1024
    chirped sechs in complex128 and B = 64 in complex64: every row against
    the per-signal nsev on the card (complex128: rtol 1e-10, atol 1e-12, as
    tests/test_parallel.py; complex64: 1e-4 of the row's largest value,
    float32 rounding through 13 tree levels and the chirp-Z FFTs), and a
    profile of one warm call at B = 64 and 1024 (device busy share)."""
    from fnft_tpu_torch.parallel import make_nsev_batch_fn
    from fnft_tpu_torch.testcases import NsevTestcase, nsev_testcase

    d = m = 4096
    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    t = np.linspace(*data.t_span, d)
    rng = np.random.default_rng(11)
    fn = make_nsev_batch_fn(d, data.t_span, m, data.xi_span)
    for b, dtype in ((64, torch.complex128), (1024, torch.complex128),
                     (64, torch.complex64)):
        amps, chirps = 0.5 + 3.0 * rng.random(b), rng.uniform(-2, 2, b)
        q = torch.as_tensor(1j * amps[:, None] / np.cosh(t)[None] * np.exp(
            1j * chirps[:, None] * t[None])).to(dtype).to(dev)
        path = f"batched contspec B={b} D=M={d} {str(dtype)[6:]}"
        res, *run = drive(spy, torch, path, lambda: fn(q),
                          "batch" if dtype == torch.complex128
                          else "batch c64")
        rho = res["rho"]
        check(rho.shape == (b, m) and rho.dtype == dtype
              and bool(torch.isfinite(rho).all()), f"{path}: {rho.shape}")
        t0 = time.perf_counter()
        worst = 0.0
        with spy.aside():
            for i in range(b):
                single = ft.nsev(q[i], data.t_span, m=m,
                                 xi_span=data.xi_span,
                                 want_bound_states=False
                                 ).reflection_coefficient
                if dtype == torch.complex128:
                    excess = ((rho[i] - single).abs()
                              / (1e-12 + 1e-10 * single.abs())).max()
                else:
                    excess = (rho[i] - single).abs().max() / (
                        1e-4 * single.abs().max())
                worst = max(worst, float(excess))
        print(f"{path}: {batch_timing(b, run)}; rows vs per-signal nsev: "
              f"worst {worst:.3e} of the tolerance "
              f"({time.perf_counter() - t0:.1f} s for {b} calls)")
        check(worst <= 1.0, f"{path}: a row is off the per-signal nsev")
        check(run[2]["fused_tree_levels"] == 1, f"{path}: K1 {run[2]}")
        if dtype == torch.complex128:
            prof = device_profile(torch, lambda: fn(q))
            print(f"  profiled B={b}: wall {prof['wall']:.4f} s, device "
                  f"{prof['device_ms']:.3f} ms (busy {prof['busy']:.2f}%), "
                  f"K1 {prof['k1_ms']:.3f} ms")


def batched_full_spectrum(ft, spy, torch, dev) -> None:
    """make_batched_full_nsev (k_max = 8, contspec BOTH) on sechs of
    amplitudes 1.2, 2.3, 3.4, 4.45 (cycled) and the SECH_FOCUSING test
    case: B = 16 x D = 4096 and B = 4 x D = 2^16 (K2 on [4, 8192] rows).
    Against the per-signal nsev on the card: bound states 5e-6, norming
    constants 5e-5, rho/a/b 1e-10 of max(1, |.|) (tests/test_parallel.py);
    the SECH_FOCUSING row's contspec, bound states and norming constants
    within BOUNDS_4096."""
    from fnft_tpu_torch.models.nsev import NsevResult
    from fnft_tpu_torch.parallel import make_batched_full_nsev
    from fnft_tpu_torch.testcases import (NsevTestcase, nsev_errors,
                                          nsev_testcase)

    opts = ft.NsevOpts(contspec_type=ft.ContspecType.BOTH,
                       discspec_type=ft.DiscspecType.BOTH)
    for b, d in ((16, 4096), (4, 1 << 16)):
        data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
        t = np.linspace(*data.t_span, d)
        amps = [SECH_AMPS[i % 4] for i in range(b - 1)]
        q = torch.as_tensor(np.stack([1j * a / np.cosh(t) for a in amps]
                                     + [data.q])).to(dev)
        fn = make_batched_full_nsev(d, data.t_span, data.m, data.xi_span,
                                    k_max=8)
        path = f"batched full spectrum B={b} D={d}"
        res, *run = drive(spy, torch, path, lambda: fn(q), "batch")
        print(f"{path}: {batch_timing(b, run)}")
        print(f"  K1 by shape {spy.by_shape('fused_tree_levels')}, K2 by "
              f"shape {spy.by_shape('repulsion_sum')}")
        if d > 4096:
            check(set(spy.by_shape("repulsion_sum")) == {(b, 8192, 8192)},
                  f"{path}: K2 {spy.by_shape('repulsion_sum')}")
        worst = {"bound_states": 0.0, "normconsts": 0.0, "contspec": 0.0}
        for i in range(b):
            with spy.aside():
                drv = ft.nsev(q[i], data.t_span, m=data.m,
                              xi_span=data.xi_span, opts=opts)
            mask = res.bound_state_mask[i]
            bs, nc = res.bound_states[i][mask], res.norming_constants[i][mask]
            order, order_d = (torch.argsort(x.imag) for x in
                              (bs, drv.bound_states))
            want = 3 if i == b - 1 else int(round(amps[i]))
            check(bs.numel() == drv.bound_states.numel() == want,
                  f"{path} row {i}: {bs.numel()} bound states, the "
                  f"per-signal nsev {drv.bound_states.numel()}, want {want}")
            worst["bound_states"] = max(worst["bound_states"], float(
                (bs[order] - drv.bound_states[order_d]).abs().max()))
            worst["normconsts"] = max(worst["normconsts"], float(
                (nc[order] - drv.norming_constants[order_d]).abs().max()))
            for key, field in (("rho", "reflection_coefficient"), ("a", "a"),
                               ("b", "b")):
                ref = getattr(drv, field)
                worst["contspec"] = max(worst["contspec"], float(
                    (getattr(res, key)[i] - ref).abs().max()
                    / max(1.0, float(ref.abs().max()))))
        print(f"  rows vs per-signal nsev: bound states "
              f"{worst['bound_states']:.3e} <= 5e-6, norming constants "
              f"{worst['normconsts']:.3e} <= 5e-5, rho/a/b "
              f"{worst['contspec']:.3e} <= 1e-10")
        check(worst["bound_states"] <= 5e-6 and worst["normconsts"] <= 5e-5
              and worst["contspec"] <= 1e-10, f"{path}: {worst}")
        row = b - 1
        mask = res.bound_state_mask[row]
        errs = nsev_errors(NsevResult(
            reflection_coefficient=res.rho[row],
            bound_states=res.bound_states[row][mask],
            norming_constants=res.norming_constants[row][mask]), data)
        check_bounds(f"{path}, SECH_FOCUSING row", errs,
                     (BOUNDS_4096[0], None, None) + BOUNDS_4096[3:5],
                     ("contspec", "bound_states", "normconsts"))


def nfdm_link_full_width(ft, spy, torch, dev) -> None:
    """examples/nfdm_modem.py's link at D = M = 4096: 64 bursts x 16 QPSK
    carriers through make_batched_inverse_fn (2SPLIT2A) and
    make_nsev_batch_fn; each burst's waveform against the per-signal
    nsev_inverse on the card (1e-10 relative), no symbol error, the EVM."""
    from fnft_tpu_torch.parallel import (make_batched_inverse_fn,
                                         make_nsev_batch_fn)

    d = m = 4096
    t_span, batch, carriers = (-16.0, 16.0), 64, 16
    rng = np.random.default_rng(1)
    symbols = (rng.integers(0, 2, size=(batch, carriers)) * 2 - 1
               + 1j * (rng.integers(0, 2, size=(batch, carriers)) * 2 - 1)
               ) / np.sqrt(2)
    inv, xi_span = make_batched_inverse_fn(d, t_span, m)
    fwd = make_nsev_batch_fn(d, t_span, m, xi_span)
    xi = np.linspace(*xi_span, m)
    centers = np.linspace(-3.0, 3.0, carriers)
    pulses = np.exp(-((xi[None, :] - centers[:, None]) / 0.12) ** 2)
    rho_tx = 0.25 * (symbols @ pulses)
    rho_t = torch.as_tensor(rho_tx).to(dev)

    def link():
        q = inv(rho_t)
        return q, fwd(q)["rho"]

    path = f"NFDM link B={batch} x {carriers} carriers D=M={d}"
    (q, rho_rx), *run = drive(spy, torch, path, link, "batch")
    print(f"{path}: {batch_timing(batch, run)}")
    t0 = time.perf_counter()
    with spy.aside():
        worst = max(rel_dev(q[i], ft.nsev_inverse(rho_t[i], xi_span, d,
                                                  t_span))
                    for i in range(batch))
    print(f"  bursts vs per-signal nsev_inverse: {worst:.3e} <= 1e-10 "
          f"({time.perf_counter() - t0:.1f} s for {batch} calls)")
    check(worst <= 1e-10, f"{path}: a burst is off nsev_inverse: {worst}")
    idx = np.argmin(np.abs(xi[None, :] - centers[:, None]), axis=1)
    tx, rx = rho_tx[:, idx], rho_rx.cpu().numpy()[:, idx]
    evm = float(np.sqrt(np.mean(np.abs(rx - tx) ** 2)
                        / np.mean(np.abs(tx) ** 2)))
    errors = int(np.sum(np.sign(rx.real) + 1j * np.sign(rx.imag)
                        != np.sign(tx.real) + 1j * np.sign(tx.imag)))
    print(f"  spectral EVM through the inverse -> forward link {evm:.3e}, "
          f"symbol errors {errors}")
    check(errors == 0 and evm < 0.05, f"{path}: EVM {evm}, {errors} errors")


def batched_nsep_full_width(ft, spy, torch, dev) -> None:
    """batched_nsep (2SPLIT4B, default options: AUTO box, 2 spine values)
    on plane waves at D = 2^16: K1 on the [B, 4096, 2, 2, 3] Dsub tree, K2
    on [3B, 8192] rows. B = 2 of the amplitudes 0.9, 1.0, 1.1, 1.2: a call
    takes ~7 s a signal (Newton on ~22k candidates a signal in the AUTO
    box, in lambda slices of 32), far beyond the other batched paths, so B
    is cut, never D. Each row's main and aux spectra against the
    per-signal nsep (S&R) on the card: equal counts, every per-signal
    point within 1e-8 of a batched one, but for double points of the aux
    spectrum (a per-signal neighbour within 1e-6: the amplitude-1 wave's b
    has a double root at 0), which Aberth splits by ~sqrt(eps) and the aux
    Newton, a plain one, leaves at once (|b| < sqrt(eps) there): held to
    1e-7. (The main Newton's line search takes double steps, so the main
    spectrum's double points converge and are held to 1e-8.)"""
    from fnft_tpu_torch.parallel import batched_nsep

    d, amps = 1 << 16, (0.9, 1.0, 1.1, 1.2)[:2]
    t_span = (0.0, 2 * np.pi)
    disc = ft.Discretization.SPLIT4B
    q = torch.as_tensor(np.stack([np.full(d, a, complex) for a in amps])
                        ).to(dev)
    b = len(amps)
    path = f"batched nsep B={b} D={d} SPLIT4B"
    res, *run = drive(spy, torch, path, lambda: batched_nsep(
        q, t_span, disc=disc), "batch nsep")
    by_k1, by_k2 = spy.by_shape("fused_tree_levels"), spy.by_shape(
        "repulsion_sum")
    print(f"{path}: {batch_timing(b, run)}")
    print(f"  K1 by shape {by_k1}, K2 by shape {by_k2}; main points "
          f"{res.main_mask.sum(dim=1).tolist()}, aux points "
          f"{res.aux_mask.sum(dim=1).tolist()}")
    check(set(by_k1) == {(b, 4096, 2, 2, 3)}
          and set(by_k2) == {(3 * b, 8192, 8192)}, f"{path}: K1 {by_k1}, "
          f"K2 {by_k2}")
    opts = ft.NsepOpts(localization=ft.Localization.SUBSAMPLE_AND_REFINE,
                       discretization=disc)
    worst = {"simple": 0.0, "double": 0.0}
    t0 = time.perf_counter()
    for i in range(b):
        with spy.aside():
            ref = ft.nsep(q[i], t_span, opts=opts)
        for key, want in (("main", ref.main_spectrum),
                          ("aux", ref.aux_spectrum)):
            got = getattr(res, f"{key}_spectrum")[i][
                getattr(res, f"{key}_mask")[i]]
            check(got.numel() == want.numel() > 0, f"{path} row {i} {key}: "
                  f"{got.numel()} points, per-signal {want.numel()}")
            dist = (got[:, None] - want[None, :]).abs().amin(dim=0)
            double = torch.zeros_like(dist, dtype=torch.bool)
            if key == "aux":
                near = (want[:, None] - want[None, :]).abs()
                near.fill_diagonal_(np.inf)
                double = near.amin(dim=1) < 1e-6
            for kind, sel in (("simple", ~double), ("double", double)):
                if bool(sel.any()):
                    worst[kind] = max(worst[kind], float(dist[sel].max()))
            print(f"  row {i} {key}: {int(double.sum())} double points, "
                  f"farthest per-signal point {float(dist.max()):.3e} away")
    print(f"  rows vs per-signal nsep: main and simple aux points "
          f"{worst['simple']:.3e} <= 1e-8, double aux points "
          f"{worst['double']:.3e} <= 1e-7 "
          f"({time.perf_counter() - t0:.1f} s for {b} calls)")
    check(worst["simple"] <= 1e-8 and worst["double"] <= 1e-7,
          f"{path}: {worst}")


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
    done = {(rec["name"], tuple(rec["shape"]), "") for rec in records}

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

    phase("15 nsep: the reference's tests on the card")
    nsep_reference_rows(ft, spy, torch, dev)

    phase("16 nsep at full width: D=2^16 (2SPLIT4B) and 2^18 (2SPLIT2A)")
    nsep_full_width(ft, spy, torch, dev)

    phase("17 nsev_inverse: the reference's tests on the card")
    inverse_reference_cases(ft, spy, torch, dev)

    phase("18 the inverse at full width: D=2^16")
    inverse_full_width(ft, spy, torch, dev)

    phase("19 batched contspec: B=64 and 1024 x D=M=4096")
    batched_contspec(ft, spy, torch, dev)

    phase("20 batched full spectrum: B=16 x D=4096, B=4 x D=2^16")
    batched_full_spectrum(ft, spy, torch, dev)

    phase("21 the NFDM link at full width: 64 bursts, D=M=4096")
    nfdm_link_full_width(ft, spy, torch, dev)

    phase("22 batched nsep: B=2 x D=2^16 (2SPLIT4B)")
    batched_nsep_full_width(ft, spy, torch, dev)
    spy.remove()

    phase("23 kernels at every shape the paths gave them")
    records += records_of_kept(spy, torch, done)
    for name, shape, tag in (
            (k1, (1 << 16, 2, 2, 2), ""), (k1, (1 << 16, 2, 2, 4), ""),
            (k1, (1 << 17, 2, 2, 3), ""), (k1, (1 << 18, 2, 2, 3), ""),
            (k2, (18724, 18724), ""), (k2, (1 << 14, 1 << 14), ""),
            # shapes of nsep's trees and batched rows, and of the inverse
            (k1, (1 << 18, 2, 2, 2), "nsep"), (k1, (1 << 14, 2, 2, 2), "nsep"),
            (k1, (1 << 16, 2, 2, 3), "nsep"), (k2, (3, 8192, 8192), "nsep"),
            (k2, (3, 1 << 14, 1 << 14), "nsep"),
            (k1, (1 << 16, 2, 2, 2), "inverse"),
            # the batched paths: K1 over the batch, K2 taking it in one launch
            (k1, (64, 4096, 2, 2, 3), "batch"),
            (k1, (1024, 4096, 2, 2, 3), "batch"),
            (k1, (64, 4096, 2, 2, 3), "batch c64"),
            (k1, (16, 4096, 2, 2, 3), "batch"),
            (k1, (16, 1024, 2, 2, 3), "batch"),
            (k1, (4, 1 << 16, 2, 2, 3), "batch"),
            (k1, (4, 4096, 2, 2, 3), "batch"),
            (k2, (4, 8192, 8192), "batch"),
            (k1, (2, 4096, 2, 2, 3), "batch nsep"),
            (k2, (6, 8192, 8192), "batch nsep")):
        check((name, shape, tag) in spy.kept,
              f"{name} never ran at {shape} on {tag or 'nsev/kdvv'}")
    check(any(name == k2 and len(shape) == 2 and shape[1] < shape[0]
              for name, shape, _ in spy.kept), "K2 never ran on an active set")

    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
