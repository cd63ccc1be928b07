#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fnft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from fnft_tpu_torch/csrc with nvcc (no instance
of K1T or of K1 at three levels may spill, by ptxas's report), holds each
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
each row against the per-signal transform on the card. Then the
gradients: ``fnft_tpu_torch.entry.rho_pipeline`` differentiated on the
card (K1 forward, its backward kernel K1T) against CPU tensors at
D = M = 4096, against a central difference at 2^16 and once at 2^20; the
inverse-design training step of B = 64 signals at D = M = 4096 (25 Adam
steps, two rows against B = 2 on CPU tensors); the C API
(``libfnft_tpu_torch.so`` built with gcc, the unchanged
examples/capi_example.c run with its arrays on the card, an in-process
ctypes nsev against the port's); and each example twin of
``fnft_tpu_torch/examples`` on the card; then K1T alone against its
plain version at the edges of its spans, with exponents near the ends of
the fp64 range, two launches bit for bit. Then the D-sharded transforms of
``fnft_tpu_torch.parallel``: the script spawns a world of 4 ranks that
share the card over gloo (every exchange staged through the host) and
runs an NCCL world of one rank in its own process; the contspec at
D = M = 2^20 (S = 4, S = 1 and the single-process replica at S = 8, each
against the unsharded contspec and the replica of its own S), 4SPLIT4B
and kdvv at D = 2^16, the bound states, nsep (plane wave, 2SPLIT4B) and
the inverse (distributed four-step FFT) at D = 2^16, and the sharded
training step at B = 64 x D = M = 4096 on a (data 2, seq 2) mesh (its
gradient against the single-rank one), each with its transport, walls,
peak memory a rank and the unsharded walls beside; each rank keeps its
kernel inputs and counts under a KernelSpy of its own, and the kernels
are held against their plain versions at those shapes too. Each run
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
fp64 and 67 TFLOP/s fp32, the larger); K1T's records name the kernel it
differentiates instead of a TPU kernel it replaces. The last line is
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


def k1_work(n_sub: int, c: int, itemsize: int,
            levels: int = 2) -> tuple[float, dict]:
    """Bytes and flops of K1 at L = ``levels`` on n_sub subtrees of c
    coefficients: each input read once, each output and exponent written
    once; 16 flops a coefficient pair of a 2x2 polynomial product (two
    complex products and two complex sums), 4 k^2 pairs in each of the
    2^(L - l) products of level l, whose factors have k coefficients (c at
    level 1, 2k - 1 at the next), one multiply a real output."""
    c_out = (c - 1) * (1 << levels) + 1
    nbytes = n_sub * (((4 << levels) * c + 4 * c_out) * 2 * itemsize + 4)
    pairs, k = 0, c
    for lv in range(1, levels + 1):
        pairs += (1 << (levels - lv)) * 4 * k * k
        k = 2 * k - 1
    flops = n_sub * (16 * pairs + 8 * c_out)
    return nbytes, {"fp64" if itemsize == 8 else "fp32": flops}


def k1_bwd_work(n_sub: int, c: int, itemsize: int) -> tuple[float, dict]:
    """Bytes and flops of K1T (K1's VJP) at L = 2 on n_sub subtrees of c
    coefficients: the 16 c input and 4 (4 c - 3) cotangent coefficients
    and the exponent read once, the 16 c gradient coefficients written
    once; 16 flops a coefficient pair (as k1_work) in the two recomputed
    level-1 products (4 c^2 pairs each), in the two correlations of the
    cotangent with them (4 (2 c - 1)^2 each) and in the four input
    gradients (4 c^2 each), and two multiplies a cotangent coefficient
    for its rescale."""
    c_out = 4 * c - 3
    nbytes = n_sub * ((32 * c + 4 * c_out) * 2 * itemsize + 4)
    flops = n_sub * (16 * (6 * 4 * c * c + 2 * 4 * (2 * c - 1) ** 2)
                     + 8 * c_out)
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
           work, **extra) -> dict:
    """One kernel's entry of the ``kernels`` line: ``launches`` is the
    count at ``shape`` in one run of ``path``."""
    bound_ms, bound_by = bound(*work)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, **extra, "shape": shape, "path": path,
            "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "pct_of_bound": 100.0 * bound_ms / ms, "library_ms": None}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check_k1(kernels, torch, dev) -> None:
    """At two levels (788, ...) gives 197 subtrees, not a multiple of a
    block's 64; at three (1576, ...) and (424, ...) give 197 and 53, not
    multiples of a span (16, or 12 at c = 4 in fp64). n = 1024, 4096, 2^20
    (c = 3) are the main path's shapes, at two levels as the gradients
    take them and at three as the rest of the tree does."""
    rng = np.random.default_rng(1)
    for shape, levels in (((1024, 2, 2, 3), 2), ((4096, 2, 2, 3), 2),
                          ((1024, 2, 2, 2), 2), ((3, 512, 2, 2, 2), 2),
                          ((1024, 2, 2, 4), 2), ((788, 2, 2, 3), 2),
                          ((2, 3, 196, 2, 2, 4), 2), ((1 << 20, 2, 2, 3), 2),
                          ((4096, 2, 2, 3), 3), ((1 << 20, 2, 2, 3), 3),
                          ((2, 3, 1024, 2, 2, 4), 3), ((1576, 2, 2, 3), 3),
                          ((424, 2, 2, 4), 3)):
        base = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        for dtype, tol in ((torch.complex128, 1e-12), (torch.complex64, 5e-6)):
            p = torch.as_tensor(base).to(dtype).to(dev)
            for normalize in (False, True):
                got, w = kernels.fused_tree_levels(p, levels,
                                                   normalize=normalize)
                ref, w_ref = kernels.fused_tree_levels_plain(
                    p, levels, normalize=normalize)
                torch.cuda.synchronize()
                dev_rel = rel_dev(got, ref)
                check(torch.equal(w, w_ref), f"K1 w differs {shape} {dtype}")
                check(dev_rel <= tol, f"K1 {shape} {dtype} norm={normalize}: "
                      f"{dev_rel:.3e} > {tol}")
                if normalize:
                    mx = torch.view_as_real(got).abs().amax(dim=(-4, -3, -2, -1))
                    check(bool(torch.all((mx >= 1) & (mx < 2))),
                          f"K1 {shape} {dtype}: max not in [1, 2)")
                print(f"K1 L={levels} {tuple(shape)} {str(dtype)[6:]} "
                      f"normalize={normalize}: max rel dev {dev_rel:.3e}, "
                      f"w equal")


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
        self.vjp = kernels.fused_tree_levels_vjp
        self.kept = {}     # key -> {"args", "kwargs", "path", "launches"}
        self.counts = {}   # key -> launches since begin()
        self.path = None
        self.tag = ""      # "" for nsev and kdvv, else the transform's name

    def install(self) -> None:
        self.poly.fused_tree_levels = self._spied(
            "fused_tree_levels", self.kernels.fused_tree_levels)
        self.roots.repulsion_sum = self._spied(
            "repulsion_sum", self.kernels.repulsion_sum)
        # K1's autograd backward looks its VJP up in the kernels module
        self.kernels.fused_tree_levels_vjp = self._spied(
            "fused_tree_levels_bwd", self.vjp)

    def remove(self) -> None:
        self.poly.fused_tree_levels = self.kernels.fused_tree_levels
        self.roots.repulsion_sum = self.kernels.repulsion_sum
        self.kernels.fused_tree_levels_vjp = self.vjp

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
            if name.startswith("fused_tree_levels"):
                shape = tuple(args[0].shape)
            else:   # ([B,] deg, m)
                shape = tuple(args[0].shape) + (args[1].shape[-1],)
            key = (name, shape, self.tag)
            self.counts[key] = self.counts.get(key, 0) + 1
            if name == "fused_tree_levels" and args[1] == 3:
                # the wrapper counts these under fused_tree_levels_l3 too
                l3 = ("fused_tree_levels_l3",) + key[1:]
                self.counts[l3] = self.counts.get(l3, 0) + 1
            if key not in self.kept:
                self.kept[key] = {
                    "args": tuple(a.detach().clone() if hasattr(a, "clone")
                                  else a for a in args),
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
            if key in self.kept and self.kept[key]["path"] == self.path:
                self.kept[key]["launches"] = n
        return dict(self.kernels.LAUNCHES)

    def by_shape(self, name: str) -> dict:
        """Launches of ``name`` in the last run, by shape."""
        return {key[1]: n for key, n in self.counts.items() if key[0] == name}

    def launches(self, name: str, shape, tag: str = "") -> int:
        return self.kept[(name, tuple(shape), tag)]["launches"]


def k1_record(kernels, torch, p, levels, normalize, launches, path,
              timed=True) -> dict | None:
    """K1 (``levels`` levels) on the stack ``p`` against its plain version:
    equal exponents, coefficients to 1e-12 in complex128 (5e-6 in
    complex64); with ``timed`` its record."""
    tol = {torch.complex128: 1e-12, torch.complex64: 5e-6}[p.dtype]
    got, w = kernels.fused_tree_levels(p, levels, normalize=normalize)
    ref, w_ref = kernels.fused_tree_levels_plain(p, levels,
                                                 normalize=normalize)
    torch.cuda.synchronize()
    check(torch.equal(w, w_ref), f"K1 {path} {list(p.shape)}: w differs")
    check(rel_dev(got, ref) <= tol, f"K1 {path} {list(p.shape)}: "
          f"{rel_dev(got, ref):.3e} > {tol}")
    if not timed:
        print(f"K1 L={levels} {list(p.shape)} ({path}): max rel dev "
              f"{rel_dev(got, ref):.3e}, w equal")
        return None
    ms = graph_ms(lambda: kernels.fused_tree_levels(p, levels,
                                                    normalize=normalize),
                  reps=50)
    plain_ms = graph_ms(lambda: kernels.fused_tree_levels_plain(
        p, levels, normalize=normalize), reps=5, replays=2)
    n_sub = p[..., 0, 0, 0].numel() >> levels
    rec = record("fused_tree_levels", "fnft_tpu_torch/csrc/tree_levels.cu",
                 "fnft_tpu/ops/pallas_kernels.py:113", list(p.shape), path,
                 launches, float((got - ref).abs().max()), ms, plain_ms,
                 k1_work(n_sub, p.shape[-1], p.element_size() // 2, levels),
                 levels=levels)
    print(f"K1 L={levels} {list(p.shape)} {str(p.dtype)[6:]} ({path}, "
          f"{launches} launches): kernel "
          f"{ms:.4f} ms ({rec['pct_of_bound']:.1f}% of its "
          f"{rec['bound_by']} bound {rec['bound_ms']:.4f} ms), plain "
          f"{plain_ms:.4f} ms")
    return rec


def k1t_record(kernels, torch, p, w, g_out, launches, path) -> dict:
    """K1T (K1's VJP) on a kept input against its plain version
    (complex128 to 1e-12, complex64 to 5e-6, relative to the largest
    gradient) and its record. It replaces no TPU kernel: the JAX package
    differentiates its plain levels; it differentiates K1's
    (``fnft_tpu/ops/pallas_kernels.py:113``). No single torch call
    computes the VJP of a fused two-level tree (``library_ms`` null)."""
    tol = {torch.complex128: 1e-12, torch.complex64: 5e-6}[p.dtype]
    got = kernels.fused_tree_levels_vjp(p, w, g_out, 2)
    ref = kernels.fused_tree_levels_vjp_plain(p, w, g_out, 2)
    torch.cuda.synchronize()
    dev_rel = rel_dev(got, ref)
    check(dev_rel <= tol, f"K1T {path} {list(p.shape)}: {dev_rel:.3e} > {tol}")
    ms = graph_ms(lambda: kernels.fused_tree_levels_vjp(p, w, g_out, 2),
                  reps=20)
    plain_ms = graph_ms(lambda: kernels.fused_tree_levels_vjp_plain(
        p, w, g_out, 2), reps=2, replays=2)
    n_sub = p[..., 0, 0, 0].numel() // 4
    rec = record("fused_tree_levels_bwd",
                 "fnft_tpu_torch/csrc/tree_levels_bwd.cu", None,
                 list(p.shape), path, launches,
                 float((got - ref).abs().max()), ms, plain_ms,
                 k1_bwd_work(n_sub, p.shape[-1], p.element_size() // 2),
                 differentiates="fnft_tpu/ops/pallas_kernels.py:113")
    print(f"K1T {list(p.shape)} {str(p.dtype)[6:]} ({path}, {launches} "
          f"launches): kernel {ms:.4f} ms ({rec['pct_of_bound']:.1f}% of "
          f"its {rec['bound_by']} bound {rec['bound_ms']:.4f} ms), plain "
          f"{plain_ms:.4f} ms, max rel dev {dev_rel:.3e}")
    return rec


def check_k1_instances(kernels) -> None:
    """K1's ten instances as ptxas built them (from the build log): no
    three-level instance may spill, and two of its blocks fit on an SM
    (the two-level design spills in fp64 at c = 3 and 4); with each its
    launch configuration."""
    for inst in kernels.fused_tree_levels_instances():
        what = f"K1 L={inst['levels']} {inst['dtype']} c={inst['c']}"
        print(f"{what}: {inst['registers']} registers, "
              f"{inst['spill_stores']} B spill stores, {inst['spill_loads']} "
              f"B spill loads, {inst['stack']} B stack; {inst['span']} "
              f"subtrees a span, {inst['threads']} threads and "
              f"{inst['smem']} B of shared memory a block, "
              f"{inst['blocks_per_sm']} blocks an SM")
        check(inst["levels"] == 2 or (inst["spill_stores"] == 0
                                      and inst["spill_loads"] == 0
                                      and inst["blocks_per_sm"] >= 2),
              f"{what}: spills or {inst['blocks_per_sm']} blocks an SM")


def check_k1t_instances(kernels) -> None:
    """K1T's six instances as ptxas built them (from the build log): no
    instance may spill; with each its launch configuration."""
    for inst in kernels.fused_tree_levels_vjp_instances():
        print(f"K1T {inst['dtype']} c={inst['c']}: {inst['registers']} "
              f"registers, {inst['spill_stores']} B spill stores, "
              f"{inst['spill_loads']} B spill loads, {inst['stack']} B "
              f"stack; {inst['span']} subtrees a span, {inst['threads']} "
              f"threads and {inst['smem']} B of shared memory a block, "
              f"{inst['blocks_per_sm']} blocks an SM")
        check(inst["spill_stores"] == 0 and inst["spill_loads"] == 0,
              f"K1T {inst['dtype']} c={inst['c']} spills")


def k1t_case(kernels, torch, p, g, normalize, what) -> None:
    """K1T on ``p`` at the cotangent ``g`` (with the forward's exponents
    when ``normalize``) against its plain version, to 1e-12 relative in
    complex128 and 5e-6 in complex64; a second launch equal bit for bit."""
    tol = {torch.complex128: 1e-12, torch.complex64: 5e-6}[p.dtype]
    _, w = kernels.fused_tree_levels(p, 2, normalize=normalize)
    w = w if normalize else None
    got = kernels.fused_tree_levels_vjp(p, w, g, 2)
    again = kernels.fused_tree_levels_vjp(p, w, g, 2)
    ref = kernels.fused_tree_levels_vjp_plain(p, w, g, 2)
    torch.cuda.synchronize()
    dev_rel = rel_dev(got, ref)
    check(dev_rel <= tol, f"K1T {what}: {dev_rel:.3e} > {tol}")
    check(torch.equal(torch.view_as_real(got), torch.view_as_real(again)),
          f"K1T {what}: two launches differ")
    w_range = "" if w is None else f", w in [{int(w.min())}, {int(w.max())}]"
    print(f"K1T {what}{w_range}: max rel dev {dev_rel:.3e}, two launches "
          f"bitwise equal")


def check_k1t(kernels, torch, dev) -> None:
    """K1T against its plain version at [65536, 2, 2, c], c = 2, 3, 4, with
    lead axes, and at the edges of its spans of 16 (fp64) or 32 (fp32)
    subtrees: 197 subtrees (no multiple of either), 10 (less than one span)
    and one; complex128 and complex64, with and without the forward's
    exponents; then exponents near the ends of the fp64 range (|w| ~ 1000,
    complex128). Every launch twice, bitwise equal."""
    rng = np.random.default_rng(6)

    def inputs(shape, scale=1.0):
        base = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * scale
        n_out = shape[:-4] + (shape[-4] // 4, 2, 2, 4 * shape[-1] - 3)
        return base, rng.normal(size=n_out) + 1j * rng.normal(size=n_out)

    for shape in ((65536, 2, 2, 2), (65536, 2, 2, 3), (65536, 2, 2, 4),
                  (2, 3, 196, 2, 2, 4), (788, 2, 2, 3), (40, 2, 2, 3),
                  (4, 2, 2, 4)):
        base, g_base = inputs(shape)
        for dtype in (torch.complex128, torch.complex64):
            p = torch.as_tensor(base).to(dtype).to(dev)
            g = torch.as_tensor(g_base).to(dtype).to(dev)
            for normalize in (False, True):
                k1t_case(kernels, torch, p, g, normalize,
                         f"{shape} {str(dtype)[6:]} normalize={normalize}")
    for scale in (2.0 ** 250, 2.0 ** -250):
        for shape in ((788, 2, 2, 3), (4096, 2, 2, 4), (1024, 2, 2, 2)):
            base, g_base = inputs(shape, scale)
            p = torch.as_tensor(base).to(dev)
            _, w = kernels.fused_tree_levels(p, 2, normalize=True)
            check(int(w.abs().min()) >= 980, f"K1T {shape}: |w| < 980")
            k1t_case(kernels, torch, p, torch.as_tensor(g_base).to(dev), True,
                     f"{shape} complex128, inputs x 2^{round(np.log2(scale))}")


def k1_main_path_record(kernels, torch, dev, d, levels, launches) -> dict:
    """K1 at the full pass of D (``levels`` levels, as the tree took it):
    the D transfer matrices of 2SPLIT4B on the sech (3 coefficients),
    complex128."""
    from fnft_tpu_torch.ops import fscatter as fs
    from fnft_tpu_torch.testcases import NsevTestcase, nsev_testcase

    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    q = torch.as_tensor(data.q).to(dev)
    eps_t = (data.t_span[1] - data.t_span[0]) / (q.shape[0] - 1)
    p = fs.transfer_matrix_coeffs(q, -torch.conj(q), eps_t,
                                  fs.Discretization.SPLIT4B).contiguous()
    return k1_record(kernels, torch, p, levels, True, launches,
                     f"SPLIT4B D={d}")


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


def records_of_kept(spy, torch, done, tags=None) -> list:
    """Every shape a driven path gave a kernel (of the paths tagged
    ``tags``, default all), on the inputs of its first launch there:
    kernel against plain version, and a record with that shape's launches
    in the run of the path where it was first seen. Shapes in ``done`` have
    their record already and are compared only."""
    recs = []
    for key, kept in spy.kept.items():
        name, shape, tag = key
        if tags is not None and (tag not in tags or key in done):
            continue
        timed = key not in done
        if name == "fused_tree_levels":
            p, levels = kept["args"]
            check(levels in (2, 3), f"K1 {kept['path']}: {levels} levels")
            rec = k1_record(spy.kernels, torch, p, levels,
                            kept["kwargs"]["normalize"], kept["launches"],
                            kept["path"], timed)
        elif name == "fused_tree_levels_bwd":
            p, w, g_out, levels = kept["args"]
            check(levels == 2, f"K1T {kept['path']}: {levels} levels")
            rec = k1t_record(spy.kernels, torch, p, w, g_out,
                             kept["launches"], kept["path"])
        else:
            z_all, z_t, idx = kept["args"]
            check(kept["kwargs"].get("lowprec", True),
                  f"K2 {kept['path']}: full precision on the path")
            rec = k2_record(spy.kernels, torch, z_all, z_t, idx,
                            kept["launches"], kept["path"], timed)
        if rec is not None:
            rec["tag"] = tag     # the transform ("dshard": a sharded path)
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
    device time of all device activity (kernels, copies), of K1's, K1T's
    and K2's kernels (ms), and the device's busy share of the wall (%)."""
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
    total = k1 = k1t = k2 = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue  # a host op's device time is its kernels', counted here
        total += evt.self_device_time_total
        if "repulsion" in evt.key or "sum_splits" in evt.key:
            k2 += evt.self_device_time_total
        elif "fused_levels_bwd" in evt.key:
            k1t += evt.self_device_time_total
        elif "fused_levels" in evt.key:
            k1 += evt.self_device_time_total
    check(total > 0, "profile: no device time seen")
    return {"wall": wall, "device_ms": total / 1e3, "k1_ms": k1 / 1e3,
            "k1t_ms": k1t / 1e3, "k2_ms": k2 / 1e3,
            "busy": total / 1e4 / wall}


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


def rho_loss(torch, rho, p):
    """Sum of |rho|^2 of the signal (Re q, Im q) = (p[0], p[1])."""
    return torch.sum(torch.abs(rho(p[0] + 1j * p[1])) ** 2)


def grad_of(torch, fn, p0):
    """(loss, gradient) of ``fn`` at the real parameters ``p0``."""
    p = p0.clone().requires_grad_(True)
    loss = fn(p)
    loss.backward()
    return float(loss.detach()), p.grad


def gradients_on_card(ft, spy, torch, dev) -> None:
    """The port's rho_pipeline (2SPLIT4B) on SECH_FOCUSING: the gradient of
    sum |rho|^2 in (Re q, Im q) on the card (K1, then K1T) against CPU
    tensors at D = M = 4096 (1e-10 relative to the largest component: one
    rounding order apart through 12 tree levels and three FFTs); a
    central difference (h = 1e-6) along one seeded random direction, low-
    passed and under the pulse's envelope so that the difference is not
    lost in rounding, against the directional derivative at D = M = 2^16
    (1e-6 relative); one gradient at D = M = 2^20 (phase 7's signal and
    grids): wall time and peak device memory."""
    from fnft_tpu_torch.entry import rho_pipeline
    from fnft_tpu_torch.testcases import NsevTestcase, nsev_testcase

    def setup(d, device):
        data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
        rho = rho_pipeline(d, d, data.t_span, data.xi_span, device=device)
        p0 = torch.as_tensor(np.stack([data.q.real, data.q.imag]))
        return data, rho, p0

    d = 4096
    _, rho_c, p0 = setup(d, "cpu")
    _, rho_g, _ = setup(d, dev)
    with spy.aside():
        loss_c, g_c = grad_of(torch, lambda p: rho_loss(torch, rho_c, p), p0)
    res, *run = drive(spy, torch, f"gradient D=M={d}", lambda: grad_of(
        torch, lambda p: rho_loss(torch, rho_g, p), p0.to(dev)), "grad")
    loss_g, g_g = res
    dev_rel = rel_dev(g_g.cpu(), g_c)
    print(f"gradient of sum |rho|^2, D=M={d}: card vs CPU tensors "
          f"{dev_rel:.3e} <= 1e-10 (loss {loss_g:.10e} / {loss_c:.10e}); "
          + timing(*run))
    check(dev_rel <= 1e-10, f"gradient D={d}: card vs CPU {dev_rel:.3e}")
    check(run[2]["fused_tree_levels"] == 1
          and run[2]["fused_tree_levels_bwd"] == 1,
          f"gradient D={d}: launches {run[2]}")

    d = 1 << 16
    data, rho_g, p0 = setup(d, dev)
    p0 = p0.to(dev)
    rng = np.random.default_rng(16)
    win = np.exp(-0.5 * (np.arange(-512, 513) / 128.0) ** 2)
    v = np.stack([np.convolve(rng.normal(size=d), win, "same")
                  for _ in range(2)]) * np.abs(data.q)
    v = torch.as_tensor(v / np.linalg.norm(v)).to(dev)
    res, *run = drive(spy, torch, f"gradient D=M={d}", lambda: grad_of(
        torch, lambda p: rho_loss(torch, rho_g, p), p0), "grad", warm=1)
    _, g = res
    h = 1e-6
    with torch.no_grad(), spy.aside():
        fd = (float(rho_loss(torch, rho_g, p0 + h * v))
              - float(rho_loss(torch, rho_g, p0 - h * v))) / (2 * h)
    dd = float(torch.sum(g * v))
    fd_rel = abs(fd - dd) / abs(fd)
    print(f"gradient D=M=2^16: directional derivative {dd:.12e}, central "
          f"difference {fd:.12e}, rel {fd_rel:.3e} <= 1e-6; "
          + timing(*run))
    check(fd_rel <= 1e-6, f"gradient D=2^16: difference {fd_rel:.3e}")

    d = 1 << 20
    data, rho_g, p0 = setup(d, dev)
    res, *run = drive(spy, torch, f"gradient D=M={d}", lambda: grad_of(
        torch, lambda p: rho_loss(torch, rho_g, p), p0.to(dev)), "grad",
        warm=1)
    check(np.isfinite(res[0]) and bool(torch.isfinite(res[1]).all()),
          "gradient D=2^20: not finite")
    print(f"gradient D=M=2^20: " + timing(*run))


def training_batch(b: int, d: int) -> np.ndarray:
    """The training steps' batch ``[b, d]`` on T = (-8, 8): dryrun_multichip's
    sechs i (0.8 + 0.1 k) / cosh(t), k cycled over its 4 amplitudes, each
    row with its own frequency shift exp(i (0.1 + 0.025 k) t)."""
    t = np.linspace(-8.0, 8.0, d)
    return np.stack([1j * (0.8 + 0.1 * (k % 4)) * np.exp(
        1j * (0.1 + 0.025 * k) * t) / np.cosh(t) for k in range(b)])


def training_step_full_width(ft, spy, torch, dev) -> None:
    """The NFDM inverse-design training step of __graft_entry__'s
    dryrun_multichip at full width on one card: make_nsev_batch_fn
    (2SPLIT4B) at B = 64 x D = M = 4096 on T = (-8, 8), XI = (-2, 2). The
    batch is dryrun_multichip's sechs i (0.8 + 0.1 k) / cosh(t), k cycled
    over its 4 amplitudes, each row with its own frequency shift
    exp(i (0.1 + 0.025 k) t); the target is the spectra of the batch
    shifted by 3 samples, as there. The parameters, real [2, B, D]
    float64, start from 0.7 times the batch. (From the batch itself the
    loss starts next to its floor and Adam's first steps, lr in every
    sample, raise it: tools/train_start_witness.py shows the JAX package's
    own step doing so on the CPU, 1.754e-6 -> 4.6e-5 in 25 steps at B = 2,
    the port's loss equal for four steps; an amplitude of 0.5 + n puts a
    spectral singularity on the grid; and without the shifts half the
    gradient is zero by symmetry, rounding noise that Adam's normalization
    amplifies ~1e5 a step, so that rows would not repeat from one batch
    size to another, nor the port's from the JAX package's. From this
    start the witness's JAX and port parameters agree to 5e-15.)
    25 steps of torch.optim.Adam(lr=1e-2) on the sum over signals of the
    mean |rho - target|^2 (each signal's loss its own, so that a signal's
    steps do not depend on the batch). The last loss must be below the
    first, every loss finite; three steps at B = 2 on CPU tensors from the
    first two rows must give the card's first two rows after its third
    step (1e-9 relative to the largest parameter)."""
    from fnft_tpu_torch.parallel import make_nsev_batch_fn

    d = m = 4096
    b, steps = 64, 25
    t_span, xi_span = (-8.0, 8.0), (-2.0, 2.0)
    q0 = training_batch(b, d)
    p_start = 0.7 * torch.as_tensor(np.stack([q0.real, q0.imag]))

    def trainer(device, rows):
        fn = make_nsev_batch_fn(d, t_span, m, xi_span, device=device)
        target = fn(torch.as_tensor(np.roll(q0[:rows], 3, axis=-1)
                                    ).to(device))["rho"]
        p = p_start[:, :rows].clone().to(device).requires_grad_(True)
        opt = torch.optim.Adam([p], lr=1e-2)

        def step():
            opt.zero_grad()
            rho = fn(p[0] + 1j * p[1])["rho"]
            loss = torch.sum(torch.mean(torch.abs(rho - target) ** 2, dim=-1))
            loss.backward()
            opt.step()
            return float(loss.detach())

        def forward():
            with torch.no_grad():
                return fn(p[0] + 1j * p[1])
        return p, step, forward

    with spy.aside():
        p_cpu, step_cpu, _ = trainer("cpu", 2)
        for _ in range(3):
            step_cpu()
    with spy.aside():   # the target's forward is not the step's
        p, step, forward = trainer(dev, b)
    losses, walls, after3 = [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        spy.begin(f"training step B={b} D=M={d}", "batch grad")
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = spy.end()
        if i == 2:
            after3 = p.detach()[:, :2].cpu().clone()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"training step: losses {losses[0]} -> {losses[-1]}")
    check(launches["fused_tree_levels"] == 1
          and launches["fused_tree_levels_bwd"] == 1,
          f"training step: launches {launches}")
    rows_rel = rel_dev(after3, p_cpu.detach())
    warm = sorted(walls[1:])
    print(f"training step B={b} x D=M={d}: loss {losses[0]:.6e} -> "
          f"{losses[-1]:.6e} (ratio {losses[-1] / losses[0]:.4f}) in "
          f"{steps} Adam steps; warm step {warm[0]:.4f}-{warm[-1]:.4f} s "
          f"(median {warm[len(warm) // 2]:.4f}), first {walls[0]:.4f} s, "
          f"peak {peak:.1f} MiB, launches a step {launches}; rows 0-1 after "
          f"3 steps vs B=2 on CPU tensors {rows_rel:.3e} <= 1e-9")
    check(rows_rel <= 1e-9, f"training step: rows vs CPU {rows_rel:.3e}")

    prof, fwd = device_profile(torch, step), device_profile(torch, forward)
    check(prof["k1t_ms"] > 0, "profiled step: no K1T time seen")
    print(f"  profiled step: wall {prof['wall']:.4f} s, device "
          f"{prof['device_ms']:.3f} ms (busy {prof['busy']:.2f}%), K1 "
          f"{prof['k1_ms']:.3f} ms, K1T {prof['k1t_ms']:.3f} ms "
          f"({100 * prof['k1t_ms'] / prof['device_ms']:.2f}% of the step's "
          f"device time); the "
          f"forward alone (no graph): device {fwd['device_ms']:.3f} ms of "
          f"{fwd['wall']:.4f} s (busy {fwd['busy']:.2f}%), so backward and "
          f"update {prof['device_ms'] - fwd['device_ms']:.3f} ms")


def capi_on_card(ft, torch, dev) -> None:
    """The port's C API on the card: libfnft_tpu_torch.so built here, the
    unchanged examples/capi_example.c compiled against it and run with
    FNFT_TPU_TORCH_DEVICE unset (its arrays go to the card), checked for
    the lines tests/test_capi.py checks; then one in-process ctypes
    fnft_tpu_nsev at D = 4096, bit for bit the port's nsev on the card,
    through the kernels."""
    import ctypes
    import os
    import pathlib
    import tempfile

    from fnft_tpu_torch import capi
    from fnft_tpu_torch.capi import build
    from fnft_tpu_torch.ops import kernels
    from fnft_tpu_torch.testcases import NsevTestcase, nsev_testcase

    t0 = time.perf_counter()
    so = build.build(verbose=False)
    repo = pathlib.Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if k != "FNFT_TPU_TORCH_DEVICE"}
    with tempfile.TemporaryDirectory() as tmp:
        exe = pathlib.Path(tmp) / "capi_example"
        subprocess.run(["gcc", str(repo / "examples" / "capi_example.c"),
                        f"-I{capi.HERE}", f"-L{so.parent}", "-lfnft_tpu_torch",
                        f"-Wl,-rpath,{so.parent}", "-o", str(exe)],
                       check=True, capture_output=True, timeout=120)
        built = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = subprocess.run([str(exe)], env=env, capture_output=True,
                           text=True, timeout=300)
    ran = time.perf_counter() - t0
    check(r.returncode == 0, f"capi_example: rc {r.returncode}: "
          f"{r.stderr[-800:]}")
    for line in ("fnft_tpu 0.4.1-cuda", "discrete spectrum (K = 1)",
                 "+1.574226I"):
        check(line in r.stdout, f"capi_example: {line!r} missing")
    print(f"C API: libfnft_tpu_torch.so and capi_example built in "
          f"{built:.1f} s; the example (its own interpreter, arrays on the "
          f"card) ran in {ran:.1f} s and printed:")
    for line in r.stdout.splitlines():
        print("  | " + line)

    lib = ctypes.CDLL(str(so))
    lib.fnft_tpu_last_error.restype = ctypes.c_char_p
    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, 4096)
    q = np.ascontiguousarray(data.q, np.complex128)
    m, kcap = data.m, 8
    cs = np.zeros(m, np.complex128)
    bs, nc = np.zeros(kcap, np.complex128), np.zeros(kcap, np.complex128)
    k = ctypes.c_size_t(kcap)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = lib.fnft_tpu_nsev(
        ctypes.c_size_t(4096), ptr(q), (ctypes.c_double * 2)(*data.t_span),
        ctypes.c_size_t(m), ptr(cs), (ctypes.c_double * 2)(*data.xi_span),
        ctypes.byref(k), ptr(bs), ptr(nc), ctypes.c_int32(1), None)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check(rc == 0, f"ctypes nsev: rc {rc}: {lib.fnft_tpu_last_error()}")
    ref = ft.nsev(data.q, data.t_span, m=m, xi_span=data.xi_span)
    check(ref.bound_states.device.type == "cuda", "nsev default device")
    same = (k.value == ref.bound_states.numel() == 3
            and np.array_equal(cs, ref.reflection_coefficient.cpu().numpy())
            and np.array_equal(bs[:3], ref.bound_states.cpu().numpy())
            and np.array_equal(nc[:3], ref.norming_constants.cpu().numpy()))
    print(f"  in-process ctypes fnft_tpu_nsev D=4096: {wall:.3f} s, "
          f"launches {launches}, K = {k.value}, bit for bit the port's "
          f"nsev on the card: {same}")
    check(same and launches["fused_tree_levels"] > 0,
          f"ctypes nsev vs the port's nsev: {same}, launches {launches}")


def examples_on_card(torch) -> None:
    """Each example twin's main() in this process on the card, its output
    checked for the values its JAX twin prints (on the CPU,
    tests/test_torch_examples*.py hold the twins' results against the JAX
    examples' on the same inputs)."""
    import contextlib
    import importlib
    import io

    from fnft_tpu_torch.examples import EXAMPLES

    printed = {
        # the sign of a zero real part is the card's rounding
        "nsev_example": ["+1.574226j   b = -1.000000"],
        "nsev_example_2": ["+0.918395j", "+1.8j"],
        "kdvv_example": ["rho[7] = -0.966286-0.191267j"],
        "nsep_example": ["-1.500000+1.999548j", "auxiliary spectrum points"],
        "nsev_inverse_example": ["Below a few of the 1024 computed samples"],
        "nfdm_modem": ["symbol errors: 0"],
        "nfdm_streaming": ["processed 64 symbols of D=1024",
                           "'rho': (16, 1024)"],
        "batched_nsep_serving": ["signal 3:"],
    }
    for name in EXAMPLES:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            importlib.import_module(f"fnft_tpu_torch.examples.{name}").main()
        torch.cuda.synchronize()
        text = out.getvalue()
        missing = [x for x in printed[name] if x not in text]
        print(f"example {name}: {time.perf_counter() - t0:.2f} s, "
              f"{len(text.splitlines())} lines; last: "
              f"{text.strip().splitlines()[-1][:90]}")
        check(not missing, f"example {name}: {missing} not printed:\n{text}")


# ---------------------------------------------------------------------------
# Phases 29-35: the D-sharded transforms of fnft_tpu_torch.parallel
# ---------------------------------------------------------------------------

DSHARD_RANKS = 4
GLOO = f"gloo, host-staged, {DSHARD_RANKS} ranks on one H100"
NCCL = "nccl, 1 rank"


def dshard_inputs(torch, dev) -> dict:
    """The sharded phases' inputs, built the same way in every process:
    the sech at D = M = 2^20 (phase 7's signal and XI), the sech at 2^16
    (4SPLIT4B, bound states), kdvv's squared sech at 2^16 (m = 2^12),
    the plane wave at 2^16 and the inverse's 1.1 i sech at 2^16 on
    T = (-20, 20) and (-8, 8), and the training step's batch B = 64 x
    D = M = 4096 (phase 24's: amplitudes 0.8-1.1; dryrun_multichip's own
    batch, i (0.8 + 0.1 k) sech, grows to amplitude 7.1 at k = 63)."""
    from fnft_tpu_torch.testcases import (NsevTestcase, kdvv_sech_case,
                                          nsep_plane_wave_case, nsev_testcase)

    big = nsev_testcase(NsevTestcase.SECH_FOCUSING, 1 << 20)
    mid = nsev_testcase(NsevTestcase.SECH_FOCUSING, 1 << 16)
    u, kdv_t, kdv_xi, kdv_rho = kdvv_sech_case(1 << 16, 1 << 12)
    pw, pw_t, *_ = nsep_plane_wave_case(1 << 16)
    inv = {t_span: 1.1j / np.cosh(np.linspace(*t_span, 1 << 16))
           for t_span in ((-20.0, 20.0), (-8.0, 8.0))}
    on = lambda x: torch.as_tensor(x).to(dev)   # noqa: E731
    return {"big": (on(big.q), big.t_span, big.xi_span),
            "mid": (on(mid.q), mid.t_span, mid.xi_span),
            "kdvv": (on(u), kdv_t, kdv_xi, kdv_rho),
            "nsep": (on(pw), pw_t),
            "inverse": {t: on(q) for t, q in inv.items()},
            "train": on(training_batch(64, 4096))}


def dshard_nsep_opts(ft):
    """tests/test_dshard_nsep.py's at-scale options, with 2SPLIT4B."""
    return ft.NsepOpts(localization=ft.Localization.SUBSAMPLE_AND_REFINE,
                       filtering=ft.PointFilter.MANUAL,
                       bounding_box=(-5.0, 5.0, -5.0, 5.0),
                       discretization=ft.Discretization.SPLIT4B)


def dshard_paths(ft, spy, torch, dev, seq, grid=None) -> dict:
    """Drive the sharded transforms in this rank (:func:`drive`, tag
    "dshard"; each call starts with a barrier, so that the ranks start
    together); with ``grid`` only the contspec at 2^20 (the NCCL world of
    one). Returns, by path, (this rank's result, cold, walls, launches,
    peak MiB)."""
    import torch.distributed as dist
    from fnft_tpu_torch import parallel as par
    from fnft_tpu_torch.entry import dryrun_rank, sharded_train_step
    from fnft_tpu_torch.ops.fscatter import fscatter

    inp = dshard_inputs(torch, dev)
    s = seq.size()
    out = {}

    def run(key, path, call, warm_=3):
        out[key] = drive(spy, torch, path, lambda: (dist.barrier(), call())[1],
                         "dshard", warm_)

    q, t_span, xi_span = inp["big"]
    fn = par.make_dshard_contspec(1 << 20, t_span, 1 << 20, xi_span, seq)
    run("contspec", f"dshard contspec SPLIT4B D=M=2^20, S={s}",
        lambda: fn(q)["rho"])
    if grid is None:
        return out
    q, t_span, xi_span = inp["mid"]
    fn4 = par.make_dshard_contspec(1 << 16, t_span, 1 << 16, xi_span, seq,
                                   disc=ft.Discretization.SPLIT4B4)
    run("4split4b", f"dshard contspec 4SPLIT4B D=M=2^16, S={s}",
        lambda: fn4(q)["rho"])
    u, kt, kxi, _ = inp["kdvv"]
    fk = par.make_dshard_kdvv_contspec(1 << 16, kt, 1 << 12, kxi, seq)
    run("kdvv", f"dshard kdvv SPLIT8B D=2^16 m=2^12, S={s}",
        lambda: fk(u)["rho"])
    run("boundstates", f"dshard bound states SPLIT4B D=2^16, S={s}",
        lambda: par.dshard_boundstates_reference(q, t_span, seq))
    pw, pw_t = inp["nsep"]
    run("nsep", f"dshard nsep SPLIT4B D=2^16, S={s}",
        lambda: par.dshard_nsep_reference(pw, pw_t, seq,
                                          opts=dshard_nsep_opts(ft)))
    # every rank peels the sub-threshold blocks itself (replicated, as in
    # the JAX package), so four ranks on one card take ~17 s a call: one
    # warm call for the second grid only
    for warm_, (t_inv, qi) in zip((0, 1), inp["inverse"].items()):
        eps_t = (t_inv[1] - t_inv[0]) / ((1 << 16) - 1)
        with spy.aside():   # the input's transfer matrix is not the path's
            tm, _ = fscatter(qi, -torch.conj(qi), eps_t,
                             ft.Discretization.SPLIT2A, normalize=False)
        run(f"inverse {t_inv}", f"dshard finvscatter D=2^16 T={t_inv}, S={s}",
            lambda: par.dshard_finvscatter(tm, eps_t, 1, seq), warm_)
    q0 = inp["train"]
    run("train", "dshard training step B=64 D=M=4096, (data 2, seq 2)",
        lambda: sharded_train_step(q0, grid, 4096)["grad"])
    run("dryrun", "dshard dryrun_multichip's rank, B=64 D=M=4096",
        lambda: dryrun_rank(dist.get_rank(), dist.get_world_size(), "cuda",
                            64, 4096), 0)
    return out


def dshard_rank(rank, world) -> dict:
    """One rank of the gloo world on the card: the sharded paths under a
    KernelSpy of its own; rank 0 also hands back the inputs it kept."""
    import torch

    from fnft_tpu_torch import parallel as par
    from fnft_tpu_torch.ops import _build, kernels, poly, roots
    import fnft_tpu_torch as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    dev = torch.device("cuda", 0)
    spy = KernelSpy(kernels, poly, roots)
    spy.install()
    out = dshard_paths(ft, spy, torch, dev, par.make_mesh(("seq",)),
                       par.make_mesh(("data", "seq")))
    spy.remove()
    out["counts"] = {key: kept["launches"] for key, kept in spy.kept.items()}
    if rank == 0:
        out["kept"] = {key: dict(kept) for key, kept in spy.kept.items()}
    return out


def plain_walls(spy, torch, call, warm=3):
    """(result, cold, warm walls, peak MiB) of an unsharded call, with the
    spy aside (the sharded path's reference is not the path)."""
    with spy.aside():
        return _walls(torch, call, warm)


def _walls(torch, call, warm):
    t0 = time.perf_counter()
    res = call()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(warm):
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return res, cold, walls, torch.cuda.max_memory_allocated() / 2 ** 20


def sharded_timing(transport, runs, unsharded) -> str:
    """One line for a sharded path: transport, the slowest rank's cold and
    warm walls, launches of one run (summed over the ranks), peak MiB per
    rank, and the unsharded walls beside."""
    cold = max(r[1] for r in runs)
    walls = [max(r[2][i] for r in runs) for i in range(len(runs[0][2]))]
    launches = {k: sum(r[3][k] for r in runs) for k in runs[0][3]}
    peak = max(r[4] for r in runs)

    def warm(ts):
        return (" ".join(f"{t:.4f}" for t in ts) + " s") if ts else "none"

    return (f"[{transport}] cold {cold:.4f} s, warm {warm(walls)}, "
            f"launches {launches}, peak {peak:.1f} MiB a rank; unsharded: "
            f"cold {unsharded[1]:.4f} s, warm {warm(unsharded[2])}, peak "
            f"{unsharded[3]:.1f} MiB")


def merge_kept(spy, torch, dev, world) -> None:
    """The world's kept kernel inputs (rank 0's, on the card) into the
    parent's spy, each with its launches summed over the ranks."""
    for key, kept in world[0]["kept"].items():
        if key in spy.kept:
            continue
        args = tuple(torch.as_tensor(a).to(dev) if isinstance(a, np.ndarray)
                     else a for a in kept["args"])
        spy.kept[key] = {"args": args, "kwargs": kept["kwargs"],
                         "path": kept["path"] + f", {DSHARD_RANKS} ranks",
                         "launches": sum(r["counts"][key] for r in world)}


def check_launched(runs, path, names) -> None:
    for name in names:
        check(all(r[3][name] > 0 for r in runs),
              f"{path}: {name} not launched in every rank: "
              f"{[r[3] for r in runs]}")


def dshard_contspec_phase(ft, spy, torch, dev, world) -> None:
    """Phase 29: the gloo world's contspec at D = M = 2^20 and the NCCL
    world of one (this process), against the unsharded nsev contspec on
    the card (1e-11, the JAX tests' bound), each against the replica of
    its own S (1e-13), and the replicas at S = 1, 4, 8 to each other."""
    import torch.distributed as dist
    from fnft_tpu_torch import parallel as par
    from fnft_tpu_torch.parallel.mesh import _free_port

    q, t_span, xi_span = dshard_inputs(torch, dev)["big"]
    d = m = 1 << 20
    unsharded = plain_walls(spy, torch, lambda: ft.nsev(
        q, t_span, m=m, xi_span=xi_span,
        want_bound_states=False).reflection_coefficient)
    un = unsharded[0]
    replicas = {}
    for s in (1, 4):
        with spy.aside():
            replicas[s] = par.dshard_contspec_reference(q, d, t_span, m,
                                                        xi_span, s=s)["rho"]
    replicas[8], *rep8 = drive(
        spy, torch, "dshard replica S=8 D=M=2^20",
        lambda: par.dshard_contspec_reference(q, d, t_span, m, xi_span,
                                              s=8)["rho"], "dshard")
    check(rep8[2]["fused_tree_levels"] == 1, f"replica S=8: {rep8[2]}")
    runs = [r["contspec"] for r in world]
    rho4 = torch.as_tensor(np.concatenate([r[0] for r in runs])).to(dev)
    check_launched(runs, "contspec S=4", ("fused_tree_levels",))
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        nccl = dshard_paths(ft, spy, torch, dev, par.make_mesh(("seq",)))
    finally:
        dist.destroy_process_group()
    rho1 = nccl["contspec"][0]
    check_launched([nccl["contspec"]], "contspec S=1 nccl",
                   ("fused_tree_levels",))
    errs = {"S=4 vs unsharded": rel_abs(rho4, un),
            "S=1 vs unsharded": rel_abs(rho1, un),
            "S=4 vs replica S=4": rel_abs(rho4, replicas[4]),
            "S=1 vs replica S=1": rel_abs(rho1, replicas[1]),
            "replica S=8 vs unsharded": rel_abs(replicas[8], un),
            "replica S=8 vs S=4": rel_abs(replicas[8], replicas[4])}
    print("  max |difference|: " + ", ".join(f"{k} {v:.3e}"
                                              for k, v in errs.items()))
    for key, err in errs.items():
        bound_ = 1e-13 if "vs replica" in key else 1e-11
        check(err <= bound_, f"contspec 2^20 {key}: {err:.3e} > {bound_}")
    print(f"  S=4: " + sharded_timing(GLOO, runs, unsharded))
    print(f"  S=1: " + sharded_timing(NCCL, [nccl["contspec"]], unsharded))
    print(f"  replica S=8 in one process: " + timing(*rep8))


def rel_abs(got, ref) -> float:
    """Max absolute difference of two spectra (numpy or tensors)."""
    got = torch_np(got)
    return float(np.max(np.abs(got - torch_np(ref))))


def torch_np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def dshard_world_phases(ft, spy, torch, dev, world) -> None:
    """Phases 30-34: the gloo world's other paths against the same
    transforms unsharded on the card."""
    from fnft_tpu_torch.entry import rho_pipeline
    from fnft_tpu_torch.ops import finvscatter as fi
    from fnft_tpu_torch.ops.fscatter import fscatter

    inp = dshard_inputs(torch, dev)
    blocks = lambda key: np.concatenate([r[key][0] for r in world])  # noqa

    phase("30 4SPLIT4B and kdvv (SPLIT8B) D-sharded at D=2^16, S=4")
    q, t_span, xi_span = inp["mid"]
    un = plain_walls(spy, torch, lambda: ft.nsev(
        q, t_span, m=1 << 16, xi_span=xi_span, want_bound_states=False,
        opts=ft.NsevOpts(discretization=ft.Discretization.SPLIT4B4)
    ).reflection_coefficient)
    err = rel_abs(blocks("4split4b"), un[0])
    runs = [r["4split4b"] for r in world]
    check_launched(runs, "4SPLIT4B", ("fused_tree_levels",))
    print(f"  4SPLIT4B D=M=2^16: vs unsharded {err:.3e} <= 1e-11; "
          + sharded_timing(GLOO, runs, un))
    check(err <= 1e-11, f"4SPLIT4B sharded: {err:.3e}")
    u, kt, kxi, exact = inp["kdvv"]
    un = plain_walls(spy, torch, lambda: ft.kdvv(
        u, kt, m=1 << 12, xi_span=kxi).reflection_coefficient)
    rho = blocks("kdvv")
    err = rel_abs(rho, un[0]) / float(un[0].abs().max())
    exact_err = float(np.linalg.norm(rho - exact) / np.linalg.norm(exact))
    # 1e-10, not the JAX tests' 1e-11 at D = 1024: sixteen more tree levels
    # of non-unitary real products (kdvv's two routes differ by 1.3e-10
    # on the card, ROADMAP)
    print(f"  kdvv 2SPLIT8B D=2^16: vs unsharded {err:.3e} <= 1e-10 of "
          f"max |rho|, error {exact_err:.3e} <= {BOUND_KDVV_SPLIT8B}; "
          + sharded_timing(GLOO, [r["kdvv"] for r in world], un))
    check(err <= 1e-10 and exact_err <= BOUND_KDVV_SPLIT8B,
          f"kdvv sharded: {err:.3e}, {exact_err:.3e}")

    phase("31 D-sharded bound states at D=2^16, S=4")
    un = plain_walls(spy, torch, lambda: ft.nsev(q, t_span, m=0))
    ref_bs, ref_nc = (torch_np(x) for x in (un[0].bound_states,
                                           un[0].norming_constants))
    bs, nc = world[0]["boundstates"][0]
    for r in world[1:]:
        check(np.array_equal(r["boundstates"][0][0], bs),
              "bound states differ between ranks")
    o, o_ref = np.argsort(bs.imag), np.argsort(ref_bs.imag)
    check(bs.size == ref_bs.size == 3, f"bound states {bs} vs {ref_bs}")
    e_bs = float(np.max(np.abs(bs[o] - ref_bs[o_ref])))
    e_nc = float(np.max(np.abs(nc[o] - ref_nc[o_ref])
                        / np.maximum(np.abs(ref_nc[o_ref]), 1e-2)))
    runs = [r["boundstates"] for r in world]
    check_launched(runs, "bound states", ("fused_tree_levels",
                                          "repulsion_sum"))
    print(f"  bound states vs nsev's: {e_bs:.3e} <= 1e-9, norming constants "
          f"{e_nc:.3e} <= 1e-7 relative; " + sharded_timing(GLOO, runs, un))
    check(e_bs <= 1e-9 and e_nc <= 1e-7, f"bound states: {e_bs}, {e_nc}")

    phase("32 D-sharded nsep (plane wave, 2SPLIT4B) at D=2^16, S=4")
    pw, pw_t = inp["nsep"]
    un = plain_walls(spy, torch, lambda: ft.nsep(pw, pw_t,
                                            opts=dshard_nsep_opts(ft)))
    main, aux = world[0]["nsep"][0]
    for r in world[1:]:
        check(np.array_equal(r["nsep"][0][0], main), "nsep ranks differ")
    from fnft_tpu_torch.testcases import nsep_plane_wave_case
    _, _, _, exact_m, exact_a, box = nsep_plane_wave_case(1 << 16)

    def outside(v):
        return v[~((v.real > box[0]) & (v.real < box[1]) & (v.imag > box[2])
                   & (v.imag < box[3]))]

    def hausdorff(a, b):
        dd = np.abs(a[:, None] - b[None, :])
        return float(max(dd.min(axis=1).max(), dd.min(axis=0).max()))

    d_m = hausdorff(outside(main), outside(torch_np(un[0].main_spectrum)))
    d_a = hausdorff(aux, torch_np(un[0].aux_spectrum))
    in_box = lambda v: v[(np.abs(v.real) < 5) & (np.abs(v.imag) < 5)]  # noqa
    err_m = max(float(np.min(np.abs(main - e))) for e in in_box(exact_m)
                if abs(e.real + 1.5) > 0.2 or abs(e.imag) > 0.2)
    err_a = max(float(np.min(np.abs(aux - e))) for e in in_box(exact_a)
                if abs(e.imag) > 0.2)
    runs = [r["nsep"] for r in world]
    check_launched(runs, "nsep", ("fused_tree_levels", "repulsion_sum"))
    print(f"  vs the card's nsep: main {d_m:.3e} <= 1e-5, aux {d_a:.3e} <= "
          f"1e-10 (Hausdorff); vs the closed form: main {err_m:.3e}, aux "
          f"{err_a:.3e} <= 2e-3; " + sharded_timing(GLOO, runs, un))
    check(d_m <= 1e-5 and d_a <= 1e-10 and err_m < 2e-3 and err_a < 2e-3,
          f"nsep sharded: {d_m}, {d_a}, {err_m}, {err_a}")

    phase("33 D-sharded inverse (distributed four-step FFT) at D=2^16, S=4")
    for (t_inv, qi), bound_ in zip(inp["inverse"].items(), (2e-6, 1e-10)):
        eps_t = (t_inv[1] - t_inv[0]) / ((1 << 16) - 1)
        with spy.aside():
            tm, _ = fscatter(qi, -torch.conj(qi), eps_t,
                             ft.Discretization.SPLIT2A, normalize=False)
        un = plain_walls(spy, torch, lambda: fi.finvscatter(tm, eps_t, 1),
                         warm=0)
        got = blocks_replicated(world, f"inverse {t_inv}")
        err, err_un = rel_abs(got, qi), rel_abs(un[0], qi)
        dev_ = rel_abs(got, un[0])
        runs = [r[f"inverse {t_inv}"] for r in world]
        # on T = (-20, 20) the peel loses ~1e-6 in either driver, and their
        # products' rounding orders part them by ~1e-9: each is held to
        # phase 18's bound, and so is their difference
        print(f"  T={t_inv}: max error {err:.3e} < {bound_} (the card's "
              f"finvscatter {err_un:.3e}), max |difference| {dev_:.3e} < "
              f"{bound_}; " + sharded_timing(GLOO, runs, un))
        check(err < bound_ and dev_ < bound_,
              f"inverse sharded T={t_inv}: {err}, {dev_}")

    phase("34 the sharded training step: B=64 x D=M=4096 on (data 2, seq 2)")
    q0 = inp["train"]
    rho = rho_pipeline(4096, 4096, (-8.0, 8.0), (-2.0, 2.0))
    with torch.no_grad(), spy.aside():
        tgt = rho(torch.roll(q0, 3, -1))
    p0 = torch.stack([q0.real, q0.imag])

    def step():
        p = p0.clone().requires_grad_(True)
        loss = torch.sum(torch.abs(rho(p[0] + 1j * p[1]) - tgt) ** 2) / (
            64 * 4096)
        loss.backward()
        return p.grad

    un = plain_walls(spy, torch, step)
    rows = [np.concatenate([world[2 * i + j]["train"][0] for j in range(2)],
                           axis=-1) for i in range(2)]
    grad = np.concatenate(rows, axis=1)
    g_rel = rel_abs(grad, un[0]) / float(un[0].abs().max())
    runs = [r["train"] for r in world]
    check_launched(runs, "training step", ("fused_tree_levels",
                                           "fused_tree_levels_bwd"))
    losses = [r["dryrun"][0]["train"]["loss"] for r in world]
    print(f"  gradient vs the single-rank gradient: {g_rel:.3e} <= 1e-10 "
          f"relative; loss {losses[0]:.10e} (the same in every rank); "
          + sharded_timing(GLOO, runs, un))
    check(g_rel <= 1e-10 and len(set(losses)) == 1,
          f"training step: gradient {g_rel:.3e}, losses {losses}")
    dry = world[0]["dryrun"][0]
    print(f"  dryrun_multichip's other transforms: bound states "
          f"{dry['bound_states'][0]}, nsep main {dry['nsep_main']}, aux "
          f"{dry['nsep_aux']}, inverse error {dry['inverse_err']:.3e}")
    check(dry["inverse_err"] < 1e-3, "dry run inverse")


def blocks_replicated(world, key):
    """A replicated result: the same in every rank; rank 0's."""
    got = world[0][key][0]
    for r in world[1:]:
        check(np.array_equal(r[key][0], got), f"{key}: ranks differ")
    return got


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
    check_k1_instances(kernels)
    check_k1t_instances(kernels)

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
    k1, k2, k1t = ("fused_tree_levels", "repulsion_sum",
                   "fused_tree_levels_bwd")
    records = [
        k1_main_path_record(kernels, torch, dev, d,
                            spy.kept[(k1, (d, 2, 2, 3), "")]["args"][1],
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

    phase("23 gradients on the card: D=M=4096 vs CPU, 2^16 vs differences, "
          "2^20")
    gradients_on_card(ft, spy, torch, dev)

    phase("24 the inverse-design training step: B=64 x D=M=4096, 25 Adam "
          "steps")
    training_step_full_width(ft, spy, torch, dev)
    spy.remove()

    phase("25 the C API on the card: capi_example.c, ctypes nsev D=4096")
    capi_on_card(ft, torch, dev)

    phase("26 the examples on the card")
    examples_on_card(torch)

    phase("27 K1T kernel vs plain: span edges, |w| ~ 1000, bitwise")
    check_k1t(kernels, torch, dev)

    phase("28 kernels at every shape the paths gave them")
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
            (k2, (6, 8192, 8192), "batch nsep"),
            # the gradients and the training step: K1 and its backward K1T
            (k1t, (4096, 2, 2, 3), "grad"), (k1t, (1 << 16, 2, 2, 3), "grad"),
            (k1t, (1 << 20, 2, 2, 3), "grad"),
            (k1, (64, 4096, 2, 2, 3), "batch grad"),
            (k1t, (64, 4096, 2, 2, 3), "batch grad")):
        check((name, shape, tag) in spy.kept,
              f"{name} never ran at {shape} on {tag or 'nsev/kdvv'}")
    check(any(name == k2 and len(shape) == 2 and shape[1] < shape[0]
              for name, shape, _ in spy.kept), "K2 never ran on an active set")

    phase("29 D-sharded contspec at D=M=2^20: S=4 ranks (gloo), S=1 "
          "(nccl), the replica at S=8")
    from fnft_tpu_torch.parallel import spawn

    spy.install()
    t0 = time.perf_counter()
    world = spawn(dshard_rank, DSHARD_RANKS, threads=None)
    print(f"  the world of {DSHARD_RANKS} ranks ({GLOO}): "
          f"{time.perf_counter() - t0:.1f} s, spawn and every sharded path")
    merge_kept(spy, torch, dev, world)
    dshard_contspec_phase(ft, spy, torch, dev, world)
    dshard_world_phases(ft, spy, torch, dev, world)
    spy.remove()

    phase("35 kernels at the sharded paths' shapes")
    records += records_of_kept(spy, torch, done, tags={"dshard"})
    for name, shape in ((k1, (1 << 18, 2, 2, 3)), (k1, (1 << 20, 2, 2, 3)),
                        (k1, (8, 1 << 17, 2, 2, 3)),
                        (k1, (32, 2048, 2, 2, 3)),
                        (k1t, (32, 2048, 2, 2, 3)),
                        (k2, (8192, 8192)), (k2, (3, 8192, 8192))):
        check((name, shape, "dshard") in spy.kept,
              f"{name} never ran at {shape} on the sharded paths")

    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
