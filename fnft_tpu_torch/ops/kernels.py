"""The port's hand-written CUDA kernels, each beside its plain version.

Port of ``fnft_tpu/ops/pallas_kernels.py`` (K1, K2), and K1's backward
(K1T), which the JAX package leaves to autodiff of its plain levels.
Every wrapper routes by the device of its input: a CPU tensor goes to
the plain PyTorch version, a CUDA tensor to the kernel (built from
``csrc/`` at first use, see ``_build``), and anything else raises. There
is no fallback: a kernel that fails to build or launch raises.

``LAUNCHES`` counts kernel launches per wrapper, so a run can show that the
main path went through the kernels; plain-version calls do not count.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"fused_tree_levels": 0, "fused_tree_levels_l3": 0,
            "fused_tree_levels_bwd": 0, "repulsion_sum": 0}

# (levels, c_in) pairs instantiated in csrc/tree_levels.cu (K1) and
# csrc/tree_levels_bwd.cu (K1T)
K1_SHAPES = frozenset([(2, 2), (2, 3), (2, 4), (3, 3), (3, 4)])
K1T_SHAPES = frozenset((2, c) for c in (2, 3, 4))


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
    On the H100 (``csrc/tree_levels.cu``) each matrix is read from device
    memory once and each product written once: the kernel is bound by
    those bytes, where the plain version makes ~L x 20 passes over them.
    Persistent blocks stage spans of subtrees through shared memory
    (coalesced, double-buffered copies in, coalesced stores out). At
    L = 2 one thread owns a subtree of 4 matrices in registers; at L = 3
    (c = 3, 4) a team of eight threads takes a subtree of 8, exchanging
    each level's products through shared memory. ``LAUNCHES`` counts
    every launch under ``fused_tree_levels`` and the three-level ones
    under ``fused_tree_levels_l3`` too.

    On a CUDA tensor the call is differentiable in ``p``
    (:class:`_FusedTreeLevels`: the backward is the kernel K1T); on a CPU
    tensor autograd runs through the plain version itself.
    """
    if not _route(p):
        return fused_tree_levels_plain(p, levels, normalize=normalize)
    return _FusedTreeLevels.apply(p, levels, normalize)


class _FusedTreeLevels(torch.autograd.Function):
    """K1 with its VJP. The exponents ``w`` are integers taken from the
    forward's result, so the rescale 2^-w is a constant of the derivative
    (as ``floor(log2)`` is in the JAX package). Saves ``p`` and ``w``,
    never the output. :func:`fused_tree_levels` applies it to CUDA tensors
    only; its CPU branch (plain forward, plain VJP) serves the tests alone,
    which check the plain VJP with ``gradcheck`` through it. K1T has no
    derivative of its own: a second backward through it raises."""

    @staticmethod
    def forward(ctx, p, levels, normalize):
        if _route(p):
            out, w = _fused_tree_levels_kernel(p, levels, normalize)
        else:
            out, w = fused_tree_levels_plain(p, levels, normalize=normalize)
        ctx.levels, ctx.normalize = levels, normalize
        ctx.save_for_backward(p, w)
        ctx.mark_non_differentiable(w)
        return out, w

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out, _g_w):
        p, w = ctx.saved_tensors
        g_in = fused_tree_levels_vjp(p, w if ctx.normalize else None,
                                     g_out.contiguous(), ctx.levels)
        return g_in, None, None


def _check_k1_input(name: str, p: torch.Tensor, levels: int,
                    shapes: frozenset) -> None:
    """What K1 and K1T both require of ``p`` on the card; ``shapes`` are
    the kernel's instantiated (levels, c) pairs."""
    *_, n, r, c, c_in = p.shape
    if p.dtype not in (torch.complex128, torch.complex64):
        raise TypeError(f"{name}: complex input required, got {p.dtype}")
    if (r, c) != (2, 2) or n % (1 << levels):
        raise ValueError(f"{name}: shape {tuple(p.shape)} is not "
                         f"[..., n, 2, 2, c] with n divisible by 2^{levels}")
    if (levels, c_in) not in shapes:
        raise ValueError(f"{name}: (levels, c) = {(levels, c_in)} not "
                         f"instantiated; have {sorted(shapes)}")
    if not p.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _fused_tree_levels_kernel(p, levels, normalize):
    _check_k1_input("fused_tree_levels", p, levels, K1_SHAPES)
    *lead, n, _, _, c_in = p.shape
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
    if levels == 3:
        LAUNCHES["fused_tree_levels_l3"] += 1
    return out, w


def _matpoly_vjp(b, a, g):
    """VJP of the 2x2 polynomial-matrix product ``c = b @ a`` (``[..., 2,
    2, cb]``, ``[..., 2, 2, ca]``; c[i, j, s + t] += b[i, k, s] a[k, j, t])
    at the cotangent ``g [..., 2, 2, cb + ca - 1]``. The product is
    holomorphic, so torch's gradients are the cotangent against the
    conjugate Jacobian, correlations of ``g`` with the other factor:
    g_b[i, k, s] = sum_{j, t} g[i, j, s + t] conj(a[k, j, t]) and
    g_a[k, j, t] = sum_{i, s} conj(b[i, k, s]) g[i, j, s + t]."""
    from fnft_tpu_torch.ops.poly import _mat2x2_mul

    cb, ca = b.shape[-1], a.shape[-1]
    a_h = a.conj().transpose(-3, -2)
    b_h = b.conj().transpose(-3, -2)
    g_b = sum(_mat2x2_mul(g[..., t: t + cb], a_h[..., t: t + 1])
              for t in range(ca))
    g_a = sum(_mat2x2_mul(b_h[..., s: s + 1], g[..., s: s + ca])
              for s in range(cb))
    return g_b, g_a


def fused_tree_levels_vjp_plain(p: torch.Tensor, w, g_out: torch.Tensor,
                                levels: int) -> torch.Tensor:
    """Plain version of :func:`fused_tree_levels_vjp`, step by step: with
    the subtree A0..A3 (time order), P = A1 A0, Q = A3 A2, R = Q P and
    G = g_out 2^-w, g_Q and g_P are G's correlations with P and Q, then
    each A's gradient its half's correlation with its partner (see
    :func:`_matpoly_vjp`)."""
    from fnft_tpu_torch.ops.poly import _matpoly_product, _pow2

    if levels != 2:
        raise ValueError(f"fused_tree_levels_vjp: levels={levels}, only 2")
    *lead, n, _, _, c = p.shape
    a = p.reshape(*lead, n // 4, 4, 2, 2, c)
    g = g_out
    if w is not None:
        g = g * _pow2(-w, g.real.dtype)[..., None, None, None]
    pp = _matpoly_product(a[..., 1, :, :, :], a[..., 0, :, :, :])
    qq = _matpoly_product(a[..., 3, :, :, :], a[..., 2, :, :, :])
    g_q, g_p = _matpoly_vjp(qq, pp, g)
    g_a1, g_a0 = _matpoly_vjp(a[..., 1, :, :, :], a[..., 0, :, :, :], g_p)
    g_a3, g_a2 = _matpoly_vjp(a[..., 3, :, :, :], a[..., 2, :, :, :], g_q)
    return torch.stack([g_a0, g_a1, g_a2, g_a3], dim=-4).reshape(p.shape)


def fused_tree_levels_vjp(p: torch.Tensor, w, g_out: torch.Tensor,
                          levels: int) -> torch.Tensor:
    """The gradient of :func:`fused_tree_levels` in ``p`` at the cotangent
    ``g_out`` of its output, with the forward's exponents ``w`` (None when
    the forward did not normalize): ``[..., n, 2, 2, c]``.

    K1 has no backward kernel on the TPU (the JAX package differentiates
    its plain levels). On the H100 (``csrc/tree_levels_bwd.cu``, K1T)
    persistent blocks walk over spans of 16 subtrees (fp64; 32 in fp32),
    copied with their cotangent rows and exponents into shared memory by
    coalesced, double-buffered copies. A team of eight threads takes a
    subtree in three steps, its intermediates in shared memory: the two
    level-1 products, their gradients, then the four input gradients,
    which leave through shared memory in coalesced stores. Each input is
    read from device memory once and each gradient written once, so it is
    bound by those bytes; no atomics, so every launch has the same bits.
    A CPU tensor goes to :func:`fused_tree_levels_vjp_plain`.
    """
    if not _route(p):
        return fused_tree_levels_vjp_plain(p, w, g_out, levels)
    _check_k1_input("fused_tree_levels_vjp", p, levels, K1T_SHAPES)
    *lead, n, _, _, c_in = p.shape
    n_out, c_out = n >> levels, (c_in - 1) * (1 << levels) + 1
    if g_out.dtype != p.dtype or (w is not None and w.dtype != torch.int32):
        raise TypeError(f"fused_tree_levels_vjp: g_out {g_out.dtype} must be "
                        f"p's {p.dtype}, w int32")
    if (tuple(g_out.shape) != (*lead, n_out, 2, 2, c_out)
            or (w is not None and tuple(w.shape) != (*lead, n_out))):
        raise ValueError(f"fused_tree_levels_vjp: p {tuple(p.shape)}, g_out "
                         f"{tuple(g_out.shape)} do not match")
    if not all(x.is_contiguous() and x.device == p.device
               for x in (g_out,) + ((w,) if w is not None else ())):
        raise ValueError("fused_tree_levels_vjp: inputs must be contiguous, "
                         "on one device")
    from fnft_tpu_torch.ops import _build

    lib = _build.library()
    g_in = torch.empty_like(p)
    with torch.cuda.device(p.device):
        err = lib.fnft_fused_tree_levels_bwd(
            p.data_ptr(), w.data_ptr() if w is not None else None,
            g_out.data_ptr(), g_in.data_ptr(), g_out[..., 0, 0, 0].numel(),
            levels, c_in, int(p.dtype == torch.complex128),
            int(w is not None), torch.cuda.current_stream().cuda_stream)
    _check_launch("fused_tree_levels_bwd", err)
    LAUNCHES["fused_tree_levels_bwd"] += 1
    return g_in


def _instances(kernel: str, config: str, keys: tuple, shapes) -> list[dict]:
    """Each instance of ``kernel`` (complex128 and complex64 at each tuple
    of ``shapes``, its template's integers, named by ``keys``) as built for
    the current CUDA device: what ptxas reported (registers, bytes of stack
    frame and spill stores and loads, from the build log) and the launch
    configuration that the C function ``config`` gives (subtrees a span,
    threads and dynamic shared memory a block, blocks an SM)."""
    import re

    from fnft_tpu_torch.ops import _build

    lib = _build.library()
    mangled = re.compile(kernel + r"I([df])" + r"Li(\d+)E" * len(keys))
    ptxas = {}
    for rep in _build.ptxas_report(kernel):
        m = mangled.search(rep["kernel"])
        ptxas[(m.group(1) == "d", *map(int, m.groups()[1:]))] = rep
    out = []
    for is_double in (True, False):
        for shape in shapes:
            cfg = (ctypes.c_int * 4)()
            _check_launch(config, getattr(lib, config)(*shape, int(is_double),
                                                       cfg))
            rep = ptxas[(is_double, *shape)]
            out.append({
                "dtype": "complex128" if is_double else "complex64",
                **dict(zip(keys, shape)),
                "registers": rep["registers"], "stack": rep["stack"],
                "spill_stores": rep["spill_stores"],
                "spill_loads": rep["spill_loads"], "span": cfg[0],
                "threads": cfg[1], "smem": cfg[2], "blocks_per_sm": cfg[3]})
    return out


def fused_tree_levels_instances() -> list[dict]:
    """K1's ten instances (complex128 and complex64 at each (levels, c) of
    ``K1_SHAPES``): ptxas's registers and spills and the launch
    configuration on the current CUDA device (see :func:`_instances`)."""
    return _instances("fused_levels_kernel", "fnft_fused_tree_levels_config",
                      ("levels", "c"), sorted(K1_SHAPES))


def fused_tree_levels_vjp_instances() -> list[dict]:
    """K1T's six instances (complex128 and complex64, c = 2, 3, 4):
    ptxas's registers and spills and the launch configuration on the
    current CUDA device (see :func:`_instances`)."""
    return _instances("fused_levels_bwd_kernel",
                      "fnft_fused_tree_levels_bwd_config", ("c",),
                      [(c,) for _, c in sorted(K1T_SHAPES)])


# ---------------------------------------------------------------------------
# K2: Aberth repulsion sum
# ---------------------------------------------------------------------------

def repulsion_sum_plain(z_all: torch.Tensor, z_t: torch.Tensor,
                        t_idx: torch.Tensor, *, lowprec: bool = True):
    """Plain version of :func:`repulsion_sum`, chunked over j as
    ``fnft_tpu/ops/roots.py:92-105``: each ``[m, chunk]`` block of
    differences is formed in the input precision; with ``lowprec`` its
    reciprocals and row sums run in complex64. Under a batch axis
    (``z_all [B, deg]``, ``z_t [B, m]``) it takes the rows one by one, so
    each row has the bits of its own call."""
    if z_all.dim() == 2:
        return torch.stack([repulsion_sum_plain(za, zt, t_idx,
                                                lowprec=lowprec)
                            for za, zt in zip(z_all, z_t)])
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
    """Aberth repulsion ``s_i = sum_{j != t_idx_i} 1/(z_t_i - z_all_j)``:
    ``z_all [deg]``, ``z_t [m]``, ``t_idx [m]``, or a batch of rows
    ``z_all [B, deg]``, ``z_t [B, m]`` with one ``t_idx [m]`` for all.

    Replaces the Pallas kernel ``fnft_tpu/ops/pallas_kernels.py:254`` (and
    its vmapped form). On the H100 (``csrc/repulsion.cu``) the grid is row
    blocks (256 active roots, two per thread) x splits of the j range,
    chosen there from deg, m and the SM count, x the batch rows; each block
    streams its split of ``z_all`` through shared memory in tiles of 512,
    and a second kernel adds the splits' partial sums in a fixed order, so
    the result has the same bits on every launch, and each row those of a
    launch of that row alone. The O(m deg) reciprocals bound it, so the
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
    if (z_all.dim() not in (1, 2) or z_t.dim() != z_all.dim()
            or z_t.shape[:-1] != z_all.shape[:-1] or t_idx.dim() != 1
            or t_idx.shape[0] != z_t.shape[-1]):
        raise ValueError("repulsion_sum: z_all [deg], z_t [m], t_idx [m], "
                         "or z_all [B, deg], z_t [B, m], t_idx [m]")
    if not all(x.is_contiguous() and x.device == z_t.device
               for x in (z_all, t_idx)) or not z_t.is_contiguous():
        raise ValueError("repulsion_sum: inputs must be contiguous, on one "
                         "device")
    from fnft_tpu_torch.ops import _build

    lib = _build.library()
    deg, m = z_all.shape[-1], z_t.shape[-1]
    batch = z_t[..., 0].numel() if m else 0
    out = torch.empty_like(z_t)
    with torch.cuda.device(z_t.device):
        rows = ctypes.c_int(0)
        _check_launch("repulsion_sum", lib.fnft_repulsion_scratch_rows(
            deg, m, ctypes.byref(rows)))
        part = (torch.empty((batch, rows.value, m), dtype=z_t.dtype,
                            device=z_t.device) if rows.value > 1 else out)
        err = lib.fnft_repulsion_sum(
            z_all.data_ptr(), z_t.data_ptr(), t_idx.data_ptr(),
            out.data_ptr(), part.data_ptr(), rows.value, batch, deg, m,
            int(z_t.dtype == torch.complex128), int(lowprec),
            torch.cuda.current_stream().cuda_stream)
    _check_launch("repulsion_sum", err)
    LAUNCHES["repulsion_sum"] += 1
    return out
