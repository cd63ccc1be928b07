"""Fast inverse scattering: recover q from a transfer-matrix polynomial.

Port of ``fnft_tpu/ops/finvscatter.py`` (reference fnft__nse_finvscatter.c:
29-366). The divide-and-conquer layer peeling works on ascending
coefficients:

  T(z) covers samples [0, D). Its low-order half (coefficients z^0..z^{d/2})
  approximates T2(z), the transfer matrix of the *later* samples [D/2, D).
  Recursing on it yields those samples and T2^{-1}(z) (up to a power of z);
  T1 = T2^{-1} T (middle coefficient window) covers the earlier samples.

Every block inverse Ti is J-symmetric — Ti22 = rev(conj(Ti11)),
Ti12 = -kappa rev(conj(Ti21)) — by construction, and left-multiplication
acts on rows, so the recursion carries the first matrix column only
(``*_col``): products against a Ti factor FFT its first column and derive
the other's bins as w^n conj(.). Blocks of degree <= ``_SCAN_CUTOFF``
peel one sample at a time.

The JAX package has a traced and a staged recursion; the split exists only
to bound XLA's compile time. Here it is one recursion (:func:`_recurse_col`)
with the same arithmetic and the same block order. On the CUDA device
every sub-block of degree <= ``_GRAPH_LEAF_DEG`` — whose recursion and
sequential peel are ~5*10^4 small launches — is one CUDA graph, captured
once per shape and replayed for every block of that shape
(:func:`_leaf_graph`); a failed capture raises. On the CPU the same
recursion runs eagerly.

The full-matrix recursion of the JAX package (``_base_case``,
``_peel_scan``, ``_recurse``, ``_t1_stage``, ``_merge_stage``,
``_recurse_staged``) carries whole 2x2 matrices with the same arithmetic;
only the D-sharded inverse (``parallel/dshard_inverse.py``) calls it, and
on the CUDA device its sub-blocks of degree <= ``_GRAPH_LEAF_DEG`` replay
CUDA graphs too.
"""

from __future__ import annotations

import functools
import math

import torch

from fnft_tpu_torch.config import complex_dtype_of, real_dtype_of
from fnft_tpu_torch.models.discretization import Discretization, degree
from fnft_tpu_torch.ops.poly import _mat2x2_mul
from fnft_tpu_torch.utils.misc import next_fft_length

_FFT_THRESHOLD = 32  # below this degree, direct convolution
_SCAN_CUTOFF = 32    # blocks at or below this degree peel sequentially
# on the CUDA device, sub-blocks of this degree and below are one CUDA
# graph each (the JAX package's staged leaf, _STAGED_LEAF_DEG)
_GRAPH_LEAF_DEG = 1024


def _jsym_complete(col11, col21, kappa: int):
    """Assemble a J-symmetric [..., 2, 2, c] matrix from its first column.

    T22 = rev(conj(T11)), T12 = -kappa rev(conj(T21)) at the nominal
    degree c - 1."""
    t12 = -kappa * torch.conj(col21.flip(-1))
    t22 = torch.conj(col11.flip(-1))
    return torch.stack([torch.stack([col11, t12], dim=-2),
                        torch.stack([col21, t22], dim=-2)], dim=-3)


def _jsym_twiddle(n: int, length: int, x: torch.Tensor) -> torch.Tensor:
    """w_k = exp(-2i pi n k / length): on the FFT's evaluation points
    rev(conj(p))(z_k) = w_k conj(p(z_k)) for p of nominal degree n."""
    k = torch.arange(length, dtype=real_dtype_of(x.dtype), device=x.device)
    return torch.exp((-2j * math.pi * n / length) * k).to(x.dtype)


def _fft_jsym(x, length: int, kappa: int):
    """FFT bins of a J-symmetric matrix from 2 transforms (not 4)."""
    f11 = torch.fft.fft(x[..., 0, 0, :], n=length, dim=-1)
    f21 = torch.fft.fft(x[..., 1, 0, :], n=length, dim=-1)
    w = _jsym_twiddle(x.shape[-1] - 1, length, x)
    return f11, (-kappa) * (w * torch.conj(f21)), f21, w * torch.conj(f11)


def _polymatmul(a, b, out_len=None, a_jsym: int | None = None,
                jsym: int | None = None, safe_from: int = 0):
    """(a @ b)(z) for [..., 2, 2, ca] x [..., 2, 2, cb] ascending coeffs.

    ``a_jsym``: kappa sign when ``a`` alone is J-symmetric (its FFT runs
    on the first column only). ``jsym``: kappa sign when *both* factors
    and hence the product are J-symmetric (2 output inverse transforms
    instead of 4, second column reconstructed in coefficient space).
    Symmetry is trusted, not checked.

    ``safe_from``: the caller only reads coefficients at indices
    >= safe_from, so the FFT length covers just n_out - safe_from bins:
    circular aliasing folds the tail onto positions the caller never
    reads (see ``fnft_tpu/ops/finvscatter.py:_polymatmul``)."""
    ca, cb = a.shape[-1], b.shape[-1]
    n_out = ca + cb - 1
    if min(ca, cb) <= _FFT_THRESHOLD:
        out = torch.zeros(a.shape[:-1] + (n_out,), dtype=a.dtype,
                          device=a.device)
        for s in range(ca):
            out[..., s:s + cb] += _mat2x2_mul(a[..., s:s + 1], b)
    else:
        length = next_fft_length(max(n_out - safe_from,
                                     (out_len or n_out) - safe_from))
        if jsym is not None or a_jsym is not None:
            fa11, fa12, fa21, fa22 = _fft_jsym(
                a, length, jsym if jsym is not None else a_jsym)
        else:
            fa = torch.fft.fft(a, n=length, dim=-1)
            fa11, fa12 = fa[..., 0, 0, :], fa[..., 0, 1, :]
            fa21, fa22 = fa[..., 1, 0, :], fa[..., 1, 1, :]
        if jsym is not None:
            fb11, _, fb21, _ = _fft_jsym(b, length, jsym)
            c11 = torch.fft.ifft(fa11 * fb11 + fa12 * fb21, dim=-1)
            c21 = torch.fft.ifft(fa21 * fb11 + fa22 * fb21, dim=-1)
            out = _jsym_complete(c11[..., :n_out], c21[..., :n_out], jsym)
        else:
            fb = torch.fft.fft(b, n=length, dim=-1)
            fb11, fb12 = fb[..., 0, 0, :], fb[..., 0, 1, :]
            fb21, fb22 = fb[..., 1, 0, :], fb[..., 1, 1, :]
            rows = [fa11 * fb11 + fa12 * fb21, fa11 * fb12 + fa12 * fb22,
                    fa21 * fb11 + fa22 * fb21, fa21 * fb12 + fa22 * fb22]
            c_out = torch.fft.ifft(torch.stack(rows, dim=-2), dim=-1)
            keep = min(n_out, c_out.shape[-1])   # < n_out when safe_from
            out = c_out[..., :keep].reshape(c_out.shape[:-2] + (2, 2, keep))
        out = out.to(a.dtype)
    if out_len is not None:
        out = out[..., :out_len]
    return out


# ---------------------------------------------------------------------------
# column-only carry: J-symmetry + row-action structure make the whole
# recursion a function of the FIRST matrix column alone
# ---------------------------------------------------------------------------

def _fft_jsym_col(c11, c21, length: int, kappa: int):
    """J-symmetric FFT bins from first-column coefficient arrays."""
    f11 = torch.fft.fft(c11, n=length, dim=-1)
    f21 = torch.fft.fft(c21, n=length, dim=-1)
    w = _jsym_twiddle(c11.shape[-1] - 1, length, c11)
    return f11, (-kappa) * (w * torch.conj(f21)), f21, w * torch.conj(f11)


def _polymatmul_col(a_col, b_col, kappa: int, out_len=None,
                    safe_from: int = 0):
    """First column of (A @ B) for J-symmetric A given B's first column.

    a_col, b_col: (c11, c21) ascending-coefficient pairs. Output column
    (o11, o21) of length out_len (or full). ``safe_from`` as in
    :func:`_polymatmul` (alias-shortened circular transforms).
    """
    a11, a21 = a_col
    b11, b21 = b_col
    ca, cb = a11.shape[-1], b11.shape[-1]
    n_out = ca + cb - 1
    if min(ca, cb) <= _FFT_THRESHOLD:
        # direct: materialize A's second-column coefficients (cheap) and
        # convolve four column pairs
        a12 = -kappa * torch.conj(a21.flip(-1))
        a22 = torch.conj(a11.flip(-1))
        o11 = torch.zeros(b11.shape[:-1] + (n_out,), dtype=b11.dtype,
                          device=b11.device)
        o21 = torch.zeros_like(o11)
        for s in range(ca):
            o11[..., s:s + cb] += a11[..., s:s + 1] * b11 + a12[..., s:s + 1] * b21
            o21[..., s:s + cb] += a21[..., s:s + 1] * b11 + a22[..., s:s + 1] * b21
    else:
        length = next_fft_length(max(n_out - safe_from,
                                     (out_len or n_out) - safe_from))
        fa11, fa12, fa21, fa22 = _fft_jsym_col(a11, a21, length, kappa)
        fb11 = torch.fft.fft(b11, n=length, dim=-1)
        fb21 = torch.fft.fft(b21, n=length, dim=-1)
        keep = min(n_out, length)
        o11 = torch.fft.ifft(fa11 * fb11 + fa12 * fb21, dim=-1)[..., :keep]
        o21 = torch.fft.ifft(fa21 * fb11 + fa22 * fb21, dim=-1)[..., :keep]
    if out_len is not None:
        o11, o21 = o11[..., :out_len], o21[..., :out_len]
    return o11, o21


def _base_case_col(c11_0, c21_0, eps_t, kappa: int, disc: Discretization):
    """One-sample inversion from the two lowest first-column coefficients
    (reference :167-227). ``eps_t`` is a float or a 0-d real tensor.

    Returns (q_sample, scl, qq): Ti's nonzero entries are
    z [[scl, -scl qq], [0, 0]] + [[0, 0], [scl kappa conj(qq), scl]].
    """
    qq = -kappa * torch.conj(c21_0 / c11_0)
    abs_q = torch.abs(qq)
    scl = 1.0 / torch.sqrt((1.0 + kappa * abs_q * abs_q).to(c11_0.dtype))
    if disc is Discretization.SPLIT2A:
        q_sample = torch.arctan(abs_q) * torch.exp(1j * torch.angle(qq)) / eps_t
    elif disc is Discretization.SPLIT2_MODAL:
        q_sample = qq / eps_t
    else:
        raise ValueError(
            f"finvscatter supports 2SPLIT2A/2SPLIT2_MODAL, got {disc}")
    return q_sample, scl, qq


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """x[..., 1:] followed by one zero coefficient."""
    return torch.cat([x[..., 1:], torch.zeros_like(x[..., :1])], dim=-1)


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """One zero coefficient followed by x[..., :-1] (times z)."""
    return torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)


def _peel_scan_col(t_col, deg: int, eps_t, kappa: int,
                   disc: Discretization):
    """Column-only sequential peel of a whole block, one sample a step
    (the JAX package's ``lax.scan``). Returns (q [..., deg] natural order,
    first column of the block inverse)."""
    c11, c21 = t_col
    u = torch.zeros_like(c11)
    u[..., 0].fill_(1.0)    # a fill, not a copy from the host: capturable
    v = torch.zeros_like(c11)
    q_rev = []
    for _ in range(deg):
        q_s, scl, qq = _base_case_col(c11[..., 0], c21[..., 0], eps_t,
                                      kappa, disc)
        s_, q_ = scl[..., None], qq[..., None]
        kq = (kappa * scl * torch.conj(qq))[..., None]
        c11, c21 = s_ * c11 - s_ * q_ * c21, _shift_down(kq * c11 + s_ * c21)
        u, v = _shift_up(s_ * u - s_ * q_ * v), kq * u + s_ * v
        q_rev.append(q_s)
    return torch.stack(q_rev, dim=-1).flip(-1), (u, v)


def _recurse_col(t_col, deg: int, eps_t, kappa: int,
                 disc: Discretization, need_inverse: bool, leaf=None):
    """Column-carry recursion: (q [..., deg], ti_col or None).

    ``leaf(t_col, deg, need_inverse)``, when given, takes every sub-block
    of degree <= ``_GRAPH_LEAF_DEG`` in place of this recursion."""
    if leaf is not None and deg <= _GRAPH_LEAF_DEG:
        return leaf(t_col, deg, need_inverse)
    if 1 < deg <= _SCAN_CUTOFF:
        q, ti_col = _peel_scan_col(t_col, deg, eps_t, kappa, disc)
        return q, (ti_col if need_inverse else None)
    if deg == 1:
        q_s, scl, qq = _base_case_col(t_col[0][..., 0], t_col[1][..., 0],
                                      eps_t, kappa, disc)
        z = torch.zeros_like(scl)
        ti = (torch.stack([z, scl], dim=-1),
              torch.stack([kappa * scl * torch.conj(qq), z], dim=-1))
        return q_s[..., None], (ti if need_inverse else None)
    d2 = deg // 2
    t2_col = (t_col[0][..., :d2 + 1], t_col[1][..., :d2 + 1])
    q_hi, t2i = _recurse_col(t2_col, d2, eps_t, kappa, disc, True, leaf)
    prod = _polymatmul_col(t2i, t_col, kappa, out_len=deg + 1, safe_from=d2)
    t1_col = (prod[0][..., d2: deg + 1], prod[1][..., d2: deg + 1])
    q_lo, t1i = _recurse_col(t1_col, d2, eps_t, kappa, disc, need_inverse,
                             leaf)
    ti = _polymatmul_col(t1i, t2i, kappa) if need_inverse else None
    return torch.cat([q_lo, q_hi], dim=-1), ti


class _LeafGraph:
    """The recursion of one sub-block shape captured in a CUDA graph:
    static inputs and time step, one replay a block, outputs copied out.
    The time step is an input, so one capture serves every grid. The
    column-carry recursion takes the two first-column arrays, the
    full-matrix one (``full``) the ``[..., 2, 2, deg+1]`` block."""

    def __init__(self, lead, deg, kappa, disc, need_inverse, dtype, device,
                 full=False):
        shapes = ([lead + (2, 2, deg + 1)] if full
                  else [lead + (deg + 1,)] * 2)
        self.inputs = tuple(torch.zeros(shape, dtype=dtype, device=device)
                            for shape in shapes)
        self.eps_t = torch.ones((), dtype=real_dtype_of(dtype), device=device)

        def body():
            if full:
                return _recurse(self.inputs[0], deg, self.eps_t, kappa, disc,
                                need_inverse)
            return _recurse_col(self.inputs, deg, self.eps_t, kappa, disc,
                                need_inverse)

        # warm up on a side stream (FFT plans, allocator), then capture
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                body()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.q, self.ti = body()

    def __call__(self, t_in, eps_t: float):
        for dst, src in zip(self.inputs, t_in):
            dst.copy_(src)
        self.eps_t.fill_(eps_t)
        self.graph.replay()
        if self.ti is None:
            ti = None
        elif isinstance(self.ti, torch.Tensor):
            ti = self.ti.clone()
        else:
            ti = tuple(x.clone() for x in self.ti)
        return self.q.clone(), ti


# one finvscatter call replays at most two leaf shapes (with and without
# the block inverse); each graph held keeps its own memory pool
@functools.lru_cache(maxsize=8)
def _leaf_graph(lead, deg, kappa, disc, need_inverse, dtype, device,
                full=False):
    return _LeafGraph(lead, deg, kappa, disc, need_inverse, dtype, device,
                      full)


# ---------------------------------------------------------------------------
# full-matrix recursion (the JAX package's _recurse / _recurse_staged)
# ---------------------------------------------------------------------------

def _base_case(t, eps_t, kappa: int, disc: Discretization):
    """One-sample inversion (reference :167-227): (q_sample, Ti
    ``[..., 2, 2, 2]``), Ti the inverse one-step matrix up to a factor z."""
    q_s, scl, qq = _base_case_col(t[..., 0, 0, 0], t[..., 1, 0, 0], eps_t,
                                  kappa, disc)
    z = torch.zeros_like(scl)
    ti = torch.stack([
        torch.stack([torch.stack([z, scl], dim=-1),
                     torch.stack([z, -scl * qq], dim=-1)], dim=-2),
        torch.stack([torch.stack([scl * kappa * torch.conj(qq), z], dim=-1),
                     torch.stack([scl, z], dim=-1)], dim=-2),
    ], dim=-3)
    return q_s, ti


def _peel_scan(t, deg: int, eps_t, kappa: int, disc: Discretization):
    """Sequential one-sample peel of a whole block, carrying both rows of
    T and the first column of the accumulated inverse (the JAX package's
    ``lax.scan``). Returns (q [..., deg] natural order, Ti
    ``[..., 2, 2, deg+1]``)."""
    u = torch.zeros_like(t[..., 0, 0, :])
    u[..., 0].fill_(1.0)    # a fill, not a copy from the host: capturable
    v = torch.zeros_like(u)
    q_rev = []
    for _ in range(deg):
        q_s, scl, qq = _base_case_col(t[..., 0, 0, 0], t[..., 1, 0, 0],
                                      eps_t, kappa, disc)
        mq = -scl * qq
        kq = scl * kappa * torch.conj(qq)
        s_, m_ = scl[..., None, None], mq[..., None, None]
        k_ = kq[..., None, None]
        row0, row1 = t[..., 0, :, :], t[..., 1, :, :]
        t = torch.stack([s_ * row0 + m_ * row1,
                         _shift_down(k_ * row0 + s_ * row1)], dim=-3)
        sa, ma, ka = scl[..., None], mq[..., None], kq[..., None]
        u, v = _shift_up(sa * u + ma * v), ka * u + sa * v
        q_rev.append(q_s)
    return torch.stack(q_rev, dim=-1).flip(-1), _jsym_complete(u, v, kappa)


def _t1_stage(t2i, t, d2: int, deg: int, kappa: int):
    """T1 window: (T2i @ T)[d2 : deg+1], T2i J-symmetric."""
    prod = _polymatmul(t2i, t, out_len=deg + 1, a_jsym=kappa, safe_from=d2)
    return prod[..., d2: deg + 1]


def _merge_stage(t1i, t2i, kappa: int):
    """Block-inverse merge Ti = T1i @ T2i of two J-symmetric factors."""
    return _polymatmul(t1i, t2i, jsym=kappa)


def _recurse(t, deg: int, eps_t, kappa: int, disc: Discretization,
             need_inverse: bool):
    """Full-matrix recursion: (q [..., deg] natural order, Ti or None)."""
    if 1 < deg <= _SCAN_CUTOFF:
        q, ti = _peel_scan(t, deg, eps_t, kappa, disc)
        return q, (ti if need_inverse else None)
    if deg == 1:
        q_s, ti = _base_case(t, eps_t, kappa, disc)
        return q_s[..., None], (ti if need_inverse else None)
    d2 = deg // 2
    # later samples: the low-order coefficient half approximates T2
    q_hi, t2i = _recurse(t[..., :d2 + 1], d2, eps_t, kappa, disc, True)
    q_lo, t1i = _recurse(_t1_stage(t2i, t, d2, deg, kappa), d2, eps_t,
                         kappa, disc, need_inverse)
    ti = _merge_stage(t1i, t2i, kappa) if need_inverse else None
    return torch.cat([q_lo, q_hi], dim=-1), ti


def _full_leaf(t: torch.Tensor, eps_t: float, kappa: int,
               disc: Discretization):
    """The leaf of :func:`_recurse_staged` for ``t``'s device: CUDA graphs
    of :func:`_recurse` on the card, None (the eager recursion) on the
    CPU."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"finvscatter: no route for device {t.device}")

    def leaf(tt, deg, need_inverse):
        return _leaf_graph(tuple(tt.shape[:-3]), deg, kappa, disc,
                           need_inverse, tt.dtype, tt.device, True)(
                               (tt,), eps_t)
    return leaf


def _recurse_staged(t, deg: int, eps_t: float, kappa: int,
                    disc: Discretization, need_inverse: bool, out: list,
                    offset: int, leaf=None):
    """Host-level recursion above ``_GRAPH_LEAF_DEG`` (the JAX package's
    staged driver, its leaf degree): leaf q blocks land in ``out`` as
    (sample offset, block), the caller concatenates them in time order.
    ``leaf(t, deg, need_inverse)`` takes the blocks of degree <=
    ``_GRAPH_LEAF_DEG`` (default: :func:`_recurse`). Returns the block
    inverse or None."""
    if deg <= _GRAPH_LEAF_DEG:
        if leaf is None:
            q, ti = _recurse(t, deg, eps_t, kappa, disc, need_inverse)
        else:
            q, ti = leaf(t, deg, need_inverse)
        out.append((offset, q))
        return ti
    d2 = deg // 2
    t2i = _recurse_staged(t[..., :d2 + 1], d2, eps_t, kappa, disc, True,
                          out, offset + d2, leaf)
    t1i = _recurse_staged(_t1_stage(t2i, t, d2, deg, kappa), d2, eps_t,
                          kappa, disc, need_inverse, out, offset, leaf)
    return _merge_stage(t1i, t2i, kappa) if need_inverse else None


def finvscatter(transfer_matrix: torch.Tensor, eps_t: float, kappa: int,
                disc: Discretization = Discretization.SPLIT2A):
    """Recover D = deg/deg1 samples from T ``[..., 2, 2, deg+1]`` (ascending).

    D must be a power of two (reference :265-267). On the CUDA device the
    sub-blocks of degree <= ``_GRAPH_LEAF_DEG`` replay CUDA graphs.
    """
    t = transfer_matrix.to(complex_dtype_of(transfer_matrix))
    deg = t.shape[-1] - 1
    d = deg // max(degree(disc), 1)
    if d < 2 or d & (d - 1):
        raise ValueError("D must be a positive power of two")
    t_col = (t[..., 0, 0, :], t[..., 1, 0, :])
    leaf = None
    if t.device.type == "cuda":
        def leaf(col, n, need_inverse):
            return _leaf_graph(tuple(col[0].shape[:-1]), n, kappa, disc,
                               need_inverse, t.dtype, t.device)(col, eps_t)
    elif t.device.type != "cpu":
        raise ValueError(f"finvscatter: no route for device {t.device}")
    q, _ = _recurse_col(t_col, deg, eps_t, kappa, disc, need_inverse=False,
                        leaf=leaf)
    return q
