"""The port's two hand-written CUDA kernels, each beside its plain version.

Port of ``fnft_tpu/ops/pallas_kernels.py``. Every wrapper routes by the
device of its input: a CPU tensor goes to the plain PyTorch version, a
CUDA tensor to the kernel (built from ``csrc/`` at first use, see
``_build``), and anything else raises. There is no fallback: a kernel
that fails to build or launch raises.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that the
main path went through the kernels; plain-version calls do not count.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"fused_tree_levels": 0, "repulsion_sum": 0}

# (levels, c_in) pairs instantiated in csrc/tree_levels.cu
K1_SHAPES = frozenset((2, c) for c in (2, 3, 4))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _route(x: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


# ---------------------------------------------------------------------------
# K1: fused early tree levels
# ---------------------------------------------------------------------------

def fused_tree_levels_plain(p: torch.Tensor, levels: int, *,
                            normalize: bool = False):
    """Plain version of :func:`fused_tree_levels`: ``levels`` rounds of the
    tree's direct-convolution level, then one rescale of each subtree so
    max(|re|, |im|) lies in [1, 2) (exponent from frexp, exact 2^-w)."""
    from fnft_tpu_torch.ops.poly import _floor_log2, _pow2, _tree_level_2x2

    if p.shape[-4] % (1 << levels):
        raise ValueError(f"n={p.shape[-4]} must be divisible by 2^{levels}")
    x = p
    for _ in range(levels):
        x, _ = _tree_level_2x2(x, None, False)
    if not normalize:
        return x, torch.zeros(x.shape[:-3], dtype=torch.int32,
                              device=p.device)
    mx = torch.view_as_real(x).abs().amax(dim=(-4, -3, -2, -1))
    w = _floor_log2(mx)
    return x * _pow2(-w, mx.dtype)[..., None, None, None], w


def fused_tree_levels(p: torch.Tensor, levels: int, *,
                      normalize: bool = False):
    """The first ``levels`` fmult-tree levels in one pass:
    ``[..., n, 2, 2, c] -> [..., n/2^L, 2, 2, (c-1) 2^L + 1]`` and int32
    exponents ``w [..., n/2^L]`` with true = out * 2**w (w = 0 unless
    ``normalize``).

    Replaces the Pallas kernel ``fnft_tpu/ops/pallas_kernels.py:113``.
    On the H100 (``csrc/tree_levels.cu``) one thread owns one subtree of
    2^L matrices in registers, so each matrix is read from device memory
    once and each product written once: the kernel is bound by those
    bytes, where the plain version makes ~L x 20 passes over them. A
    persistent block stages spans of 64 subtrees through shared memory
    (coalesced, double-buffered copies in, coalesced stores out).
    """
    if not _route(p):
        return fused_tree_levels_plain(p, levels, normalize=normalize)
    *lead, n, r, c, c_in = p.shape
    if p.dtype not in (torch.complex128, torch.complex64):
        raise TypeError(f"fused_tree_levels: complex input required, "
                        f"got {p.dtype}")
    if (r, c) != (2, 2) or n % (1 << levels):
        raise ValueError(f"fused_tree_levels: shape {tuple(p.shape)} is not "
                         f"[..., n, 2, 2, c] with n divisible by 2^{levels}")
    if (levels, c_in) not in K1_SHAPES:
        raise ValueError(f"fused_tree_levels: (levels, c) = {(levels, c_in)}"
                         f" not instantiated; have {sorted(K1_SHAPES)}")
    if not p.is_contiguous():
        raise ValueError("fused_tree_levels: input must be contiguous")
    from fnft_tpu_torch.ops import _build

    lib = _build.library()
    c_out = (c_in - 1) * (1 << levels) + 1
    n_out = n >> levels
    out = torch.empty(*lead, n_out, 2, 2, c_out, dtype=p.dtype,
                      device=p.device)
    w = torch.empty(*lead, n_out, dtype=torch.int32, device=p.device)
    with torch.cuda.device(p.device):
        err = lib.fnft_fused_tree_levels(
            p.data_ptr(), out.data_ptr(), w.data_ptr(), w.numel(), levels,
            c_in, int(p.dtype == torch.complex128), int(normalize),
            torch.cuda.current_stream().cuda_stream)
    _check_launch("fused_tree_levels", err)
    LAUNCHES["fused_tree_levels"] += 1
    return out, w


# ---------------------------------------------------------------------------
# K2: Aberth repulsion sum
# ---------------------------------------------------------------------------

def repulsion_sum_plain(z_all: torch.Tensor, z_t: torch.Tensor,
                        t_idx: torch.Tensor, *, lowprec: bool = True):
    """Plain version of :func:`repulsion_sum`, chunked over j as
    ``fnft_tpu/ops/roots.py:92-105``: each ``[m, chunk]`` block of
    differences is formed in the input precision; with ``lowprec`` its
    reciprocals and row sums run in complex64."""
    deg = z_all.shape[0]
    m = z_t.shape[0]
    chunk = max(512, min(1 << 16, (1 << 26) // max(m, 1)))
    lo = torch.complex64 if lowprec else z_all.dtype
    acc = torch.zeros_like(z_t)
    for c0 in range(0, deg, chunk):
        zc = z_all[c0:c0 + chunk]
        jc = torch.arange(c0, c0 + zc.shape[0], dtype=torch.int64,
                          device=z_all.device)
        diff = (z_t[:, None] - zc[None, :]).to(lo)
        bad = t_idx[:, None].to(torch.int64) == jc[None, :]
        inv = torch.where(bad, 0.0, 1.0 / torch.where(bad, 1.0, diff))
        acc = acc + torch.sum(inv, dim=1).to(z_all.dtype)
    return acc


def repulsion_sum(z_all: torch.Tensor, z_t: torch.Tensor,
                  t_idx: torch.Tensor, *, lowprec: bool = True):
    """Aberth repulsion ``s_i = sum_{j != t_idx_i} 1/(z_t_i - z_all_j)``.

    Replaces the Pallas kernel ``fnft_tpu/ops/pallas_kernels.py:254``.
    On the H100 (``csrc/repulsion.cu``) the grid is row blocks (256
    active roots, two per thread) x splits of the j range, chosen there
    from deg, m and the SM count; each block streams its split of ``z_all``
    through shared memory in tiles of 512, and a second kernel adds the
    splits' partial sums in a fixed order, so the result has the same bits
    on every launch. The O(m deg) reciprocals bound it, so the
    low-precision contract (reciprocals and tile sums in fp32) is what buys
    its speed.
    """
    if not _route(z_t):
        return repulsion_sum_plain(z_all, z_t, t_idx, lowprec=lowprec)
    if z_all.dtype != z_t.dtype or z_t.dtype not in (torch.complex128,
                                                      torch.complex64):
        raise TypeError(f"repulsion_sum: z_all {z_all.dtype} and z_t "
                        f"{z_t.dtype} must share a complex dtype")
    if t_idx.dtype != torch.int32:
        raise TypeError(f"repulsion_sum: t_idx must be int32, got {t_idx.dtype}")
    if z_all.dim() != 1 or z_t.dim() != 1 or t_idx.shape != z_t.shape:
        raise ValueError("repulsion_sum: z_all [deg], z_t [m], t_idx [m]")
    if not all(x.is_contiguous() and x.device == z_t.device
               for x in (z_all, t_idx)) or not z_t.is_contiguous():
        raise ValueError("repulsion_sum: inputs must be contiguous, on one "
                         "device")
    from fnft_tpu_torch.ops import _build

    lib = _build.library()
    deg, m = z_all.shape[0], z_t.shape[0]
    out = torch.empty_like(z_t)
    with torch.cuda.device(z_t.device):
        rows = ctypes.c_int(0)
        _check_launch("repulsion_sum", lib.fnft_repulsion_scratch_rows(
            deg, m, ctypes.byref(rows)))
        part = (torch.empty((rows.value, m), dtype=z_t.dtype,
                            device=z_t.device) if rows.value > 1 else out)
        err = lib.fnft_repulsion_sum(
            z_all.data_ptr(), z_t.data_ptr(), t_idx.data_ptr(),
            out.data_ptr(), part.data_ptr(), rows.value, deg, m,
            int(z_t.dtype == torch.complex128), int(lowprec),
            torch.cuda.current_stream().cuda_stream)
    _check_launch("repulsion_sum", err)
    LAUNCHES["repulsion_sum"] += 1
    return out
