"""D-sharded inverse scattering: distributed FFTs over the seq mesh axis.

Port of ``fnft_tpu/parallel/dshard_inverse.py``. The inverse NFT's layer
peel (``ops/finvscatter.py``, reference fnft__nse_finvscatter.c:243-366)
is sequential across its two half-blocks (T1 needs T2's inverse), so the
parallel resource is *within* a level: the T1-window and merge products
are FFT convolutions of length ~2 deg, size-2D transforms at the top.

* a **distributed four-step FFT** (Bailey's transpose algorithm): x[n],
  n = r + R c, viewed as A[r, c] with L = R C; X[k2 + C k1] =
  FFT_r(w_L^{r k2} FFT_c(A)): a local FFT over c, the twiddle, an
  all-to-all transpose, a local FFT over r. The outputs stay in the
  permuted (k2, k1) layout, which pointwise products and the inverse
  transform both keep: the permutation cancels inside a convolution;
* a **sharded 2x2 polynomial matrix product** on that pair (each rank
  transforms C/P of the spectral columns);
* :func:`dshard_finvscatter`: the staged peel with every product of degree
  >= ``min_sharded_deg`` through the sharded convolution, the smaller
  blocks through the full-matrix recursion of ``ops/finvscatter.py`` (its
  leaves CUDA graphs on the card).

The coefficient arrays are replicated between stages; only the transforms
inside a product are divided. A product costs two all-to-all transposes
and one gather a transform pair.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from fnft_tpu_torch.config import complex_dtype_of
from fnft_tpu_torch.models.discretization import Discretization, degree
from fnft_tpu_torch.ops import finvscatter as _fi
from fnft_tpu_torch.ops.poly import _mat2x2_mul
from fnft_tpu_torch.parallel.mesh import MeshAxis, as_auto_mesh
from fnft_tpu_torch.utils.misc import next_power_of_2


def _factor(length: int, p: int) -> tuple[int, int]:
    """length = R * C with R and C divisible by the axis size p (powers of
    two)."""
    if length & (length - 1) or p & (p - 1):
        raise ValueError(f"sharded FFT needs powers of two, got L={length}, "
                         f"P={p}")
    logl, logp = int(math.log2(length)), int(math.log2(p))
    if logl < 2 * logp:
        raise ValueError(f"length {length} too small for a {p}-way sharded "
                         f"FFT")
    logr = max(logp, (logl + 1) // 2)
    return 1 << logr, 1 << (logl - logr)


def _fft_last(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """(I)FFT over the last dim."""
    return torch.fft.ifft(x, dim=-1) if inverse else torch.fft.fft(x, dim=-1)


def _fft_axis2(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """(I)FFT over dim -2."""
    return torch.fft.ifft(x, dim=-2) if inverse else torch.fft.fft(x, dim=-2)


def _twiddle(r: int, c: int, axis: MeshAxis, sign: float, like):
    """w_L^{sign * r k2} on this rank's [C, R/P] block (r global), the
    angles in float64 (the products r k2 are exact there)."""
    r_glob = axis.index * (r // axis.size) + torch.arange(
        r // axis.size, dtype=torch.float64, device=like.device)
    k2 = torch.arange(c, dtype=torch.float64, device=like.device)
    ang = (sign * 2.0 * math.pi / (r * c)) * (k2[:, None] * r_glob[None, :])
    return torch.exp(1j * ang).to(like.dtype)


def _fwd_local(x: torch.Tensor, *, r: int, c: int, axis: MeshAxis):
    """Replicated ``[..., L]`` -> this rank's ``[..., C/P, R]`` block of the
    permuted spectrum X[k2 + C k1] (k2 sharded)."""
    p = axis.size
    a = x.reshape(x.shape[:-1] + (c, r))     # A[c_slow, r_fast]: n = r + R c
    a_loc = a.narrow(-2, axis.index * (c // p), c // p)
    b = axis.all_to_all(a_loc, -1, -2)       # [..., C, R/P]: r sharded
    f1 = _fft_axis2(b) * _twiddle(r, c, axis, -1.0, b)
    g = axis.all_to_all(f1, -2, -1)          # [..., C/P, R]: k2 sharded
    return _fft_last(g)                      # over r -> X[k2_loc, k1]


def _inv_local(x_loc: torch.Tensor, *, r: int, c: int, axis: MeshAxis):
    """Inverse of :func:`_fwd_local`: the replicated ``[..., L]``."""
    y = _fft_last(x_loc, inverse=True)       # undo the FFT over r
    h = axis.all_to_all(y, -1, -2)           # [..., C, R/P]
    h = _fft_axis2(h * _twiddle(r, c, axis, 1.0, h), inverse=True)
    a_loc = axis.all_to_all(h, -2, -1)       # [..., C/P, R]
    a = axis.all_gather(a_loc, dim=-2, tiled=True)
    return a.reshape(a.shape[:-2] + (r * c,))


def make_sharded_polymatmul(ca: int, cb: int, mesh, *, seq_axis: str = "seq",
                            dtype=torch.complex128):
    """``(a [..., 2, 2, ca], b [..., 2, 2, cb]) -> a @ b [..., 2, 2,
    ca+cb-1]`` with the convolution's transforms divided over
    ``mesh[seq_axis]``; inputs and output replicated."""
    axis = MeshAxis(as_auto_mesh(mesh), seq_axis)
    n_out = ca + cb - 1
    length = next_power_of_2(n_out)
    r, c = _factor(length, axis.size)

    def mm(a, b):
        fa = _fwd_local(F.pad(a, (0, length - ca)), r=r, c=c, axis=axis)
        fb = _fwd_local(F.pad(b, (0, length - cb)), r=r, c=c, axis=axis)
        o = _mat2x2_mul(fa.flatten(-2), fb.flatten(-2)).unflatten(
            -1, fa.shape[-2:])                               # a @ b per bin
        out = _inv_local(o, r=r, c=c, axis=axis)
        return out[..., :n_out].to(dtype)

    return mm


def sharded_fft_reference(x: torch.Tensor, mesh, *, seq_axis: str = "seq"):
    """The distributed FFT of a replicated ``[..., L]``, the permuted
    layout undone and the spectrum gathered on every rank (the four-step
    transform's test surface)."""
    axis = MeshAxis(as_auto_mesh(mesh), seq_axis)
    length = x.shape[-1]
    r, c = _factor(length, axis.size)
    f = _fwd_local(x, r=r, c=c, axis=axis)                # [..., C/P, R]
    f = axis.all_gather(f, dim=-2, tiled=True)            # X[k2 + C k1]
    # k = k2 + C k1: k1 is the slow digit, so [k1, k2] row-major is k
    return f.transpose(-1, -2).reshape(x.shape[:-1] + (length,))


def dshard_finvscatter(transfer_matrix: torch.Tensor, eps_t: float,
                       kappa: int, mesh, *,
                       disc: Discretization = Discretization.SPLIT2A,
                       seq_axis: str = "seq", min_sharded_deg: int = 2048):
    """``ops/finvscatter.finvscatter`` with its top-level products sharded:
    every T1-window and merge product whose larger factor has degree >=
    ``min_sharded_deg`` runs its transforms divided over the mesh axis;
    the smaller blocks run the full-matrix staged recursion locally.
    ``transfer_matrix [..., 2, 2, deg+1]`` is replicated, and so is the
    result ``q [..., D]``."""
    t = transfer_matrix.to(complex_dtype_of(transfer_matrix))
    deg = t.shape[-1] - 1
    d = deg // max(degree(disc), 1)
    if d < 2 or d & (d - 1):
        raise ValueError("D must be a positive power of two")
    leaf = _fi._full_leaf(t, eps_t, kappa, disc)
    mm_cache: dict = {}

    def _mm(a, b, out_len=None):
        key = (a.shape[-1], b.shape[-1])
        if key not in mm_cache:
            mm_cache[key] = make_sharded_polymatmul(
                key[0], key[1], mesh, seq_axis=seq_axis, dtype=t.dtype)
        out = mm_cache[key](a, b)
        return out if out_len is None else out[..., :out_len]

    out: list = []

    def _recurse(tt, dg, need_inverse, offset):
        if dg < min_sharded_deg:
            return _fi._recurse_staged(tt, dg, eps_t, kappa, disc,
                                       need_inverse, out, offset, leaf)
        d2 = dg // 2
        t2i = _recurse(tt[..., :d2 + 1], d2, True, offset + d2)
        t1 = _mm(t2i, tt, out_len=dg + 1)[..., d2: dg + 1]
        t1i = _recurse(t1, d2, need_inverse, offset)
        return _mm(t1i, t2i) if need_inverse else None

    _recurse(t, deg, False, 0)
    out.sort(key=lambda kv: kv[0])
    return torch.cat([blk for _, blk in out], dim=-1)
