"""Polynomial kernels: FFT-tree products and chirp-Z evaluation.

Port of ``fnft_tpu/ops/poly.py`` (reference fnft__poly_fmult.c,
fnft__poly_chirpz.c). Conventions are the JAX package's:

* coefficients in **ascending** order along the last axis;
* a stack of 2x2 polynomial matrices is ``[..., n, 2, 2, deg+1]`` in natural
  time order, and the tree computes ``M[n-1] @ ... @ M[0]``;
* with ``normalize=True`` intermediate products are rescaled by exact powers
  of two and ``w`` satisfies ``true = stored * 2**w``.

FFTs are ``torch.fft`` (pocketfft on the CPU, cuFFT on the GPU).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from fnft_tpu_torch.config import complex_dtype_of, real_dtype_of
from fnft_tpu_torch.ops.kernels import fused_tree_levels
from fnft_tpu_torch.utils.misc import next_fft_length, next_power_of_2

_CONV_CUTOFF = 16   # coefficient length below which direct convolution wins


# ---------------------------------------------------------------------------
# Exact power-of-two scaling
# ---------------------------------------------------------------------------

def _floor_log2(max_abs: torch.Tensor) -> torch.Tensor:
    """int32 exponents a = floor(log2(max_abs)) taken exactly (frexp), 0
    where max_abs == 0."""
    _, e = torch.frexp(max_abs)
    return torch.where(max_abs > 0, e - 1, 0).to(torch.int32)


def _pow2(e: torch.Tensor, rdt: torch.dtype) -> torch.Tensor:
    """Exact 2**e (integer tensor e) in the real dtype ``rdt``, built from
    the exponent bits. (``torch.ldexp`` goes through ``pow`` and is not
    exact for complex operands.)"""
    if rdt == torch.float64:
        bits = (e.to(torch.int64).clamp(-1022, 1023) + 1023) << 52
        return bits.view(torch.float64)
    bits = (e.to(torch.int32).clamp(-126, 127) + 127) << 23
    return bits.view(torch.float32)


# ---------------------------------------------------------------------------
# Direct-convolution tree levels
# ---------------------------------------------------------------------------

def _mat2x2_mul(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Explicit (b @ a) over [..., 2, 2, L] stacks, elementwise on L."""
    b00, b01 = b[..., 0, 0, :], b[..., 0, 1, :]
    b10, b11 = b[..., 1, 0, :], b[..., 1, 1, :]
    a00, a01 = a[..., 0, 0, :], a[..., 0, 1, :]
    a10, a11 = a[..., 1, 0, :], a[..., 1, 1, :]
    return torch.stack([
        torch.stack([b00 * a00 + b01 * a10, b00 * a01 + b01 * a11], dim=-2),
        torch.stack([b10 * a00 + b11 * a10, b10 * a01 + b11 * a11], dim=-2),
    ], dim=-3)


def _matpoly_product(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(b @ a)(z) for two [..., 2, 2, c] stacks -> [..., 2, 2, 2c-1]."""
    c = a.shape[-1]
    if c <= _CONV_CUTOFF:
        out = torch.zeros(a.shape[:-1] + (2 * c - 1,), dtype=a.dtype,
                          device=a.device)
        for s in range(c):
            out[..., s: s + c] += _mat2x2_mul(b[..., s: s + 1], a)
        return out
    length = next_fft_length(2 * c - 1)
    fa = torch.fft.fft(a, n=length, dim=-1)
    fb = torch.fft.fft(b, n=length, dim=-1)
    out = torch.fft.ifft(_mat2x2_mul(fb, fa), dim=-1)[..., : 2 * c - 1]
    return out if a.is_complex() else out.real


def _tree_level_2x2(p: torch.Tensor, w, normalize: bool):
    """One tree level: [..., n, 2, 2, c] -> [..., n//2, 2, 2, 2c-1]."""
    a = p[..., 0::2, :, :, :]   # earlier samples
    b = p[..., 1::2, :, :, :]   # later samples
    prod = _matpoly_product(b, a)
    if w is not None:
        w = w[..., 0::2] + w[..., 1::2]
    if normalize:
        mx = torch.abs(prod).amax(dim=(-3, -2, -1))
        a_exp = _floor_log2(mx)
        prod = prod * _pow2(-a_exp, mx.dtype)[..., None, None, None]
        w = w + a_exp if w is not None else a_exp
    return prod, w


# ---------------------------------------------------------------------------
# Value-space tree levels (see fnft_tpu/ops/poly.py:114-130): each node is
# (V, t), V its values at the N-th roots of unity and t its z^N coefficient.
# ---------------------------------------------------------------------------

def _value_enter(p: torch.Tensor):
    """Coefficients ``[..., n, 2, 2, N+1]`` -> values ``(V, t)``."""
    t = p[..., -1]
    V = torch.fft.fft(p[..., :-1], dim=-1) + t[..., None]
    return V, t


def _half_twiddle(n: int, cdt: torch.dtype, device) -> torch.Tensor:
    """w_{2N}^j = exp(-i pi j / N) for j = 0..N-1."""
    ang = torch.arange(n, dtype=real_dtype_of(cdt), device=device) * (
        math.pi / n)
    return torch.complex(torch.cos(ang), -torch.sin(ang))


def _value_odd_bins(V: torch.Tensor, t: torch.Tensor, tw: torch.Tensor):
    """Evaluations at the odd points of the 2N grid (fnft_tpu poly.py:165)."""
    q = torch.fft.ifft(V, dim=-1)
    return torch.fft.fft(q * tw, dim=-1) - (2.0 * t)[..., None]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """out[..., 2k] = even[..., k], out[..., 2k+1] = odd[..., k]."""
    return torch.stack([even, odd], dim=-1).reshape(
        even.shape[:-1] + (2 * even.shape[-1],))


def _value_level(V, t, w, do_norm: bool):
    """One tree level in value space: N-grid pairs -> 2N-grid products."""
    Va, Vb = V[..., 0::2, :, :, :], V[..., 1::2, :, :, :]
    ta, tb = t[..., 0::2, :, :], t[..., 1::2, :, :]
    tw = _half_twiddle(V.shape[-1], V.dtype, V.device)
    even = _mat2x2_mul(Vb, Va)
    odd = _mat2x2_mul(_value_odd_bins(Vb, tb, tw),
                      _value_odd_bins(Va, ta, tw))
    V_out = _interleave(even, odd)
    t_out = _mat2x2_mul(tb[..., None], ta[..., None])[..., 0]
    if w is not None:
        w = w[..., 0::2] + w[..., 1::2]
    if do_norm:
        max_abs = torch.maximum(torch.abs(V_out).amax(dim=(-3, -2, -1)),
                                torch.abs(t_out).amax(dim=(-2, -1)))
        a_exp = _floor_log2(max_abs)
        scale = _pow2(-a_exp, max_abs.dtype)
        V_out = V_out * scale[..., None, None, None]
        t_out = t_out * scale[..., None, None]
        w = w + a_exp if w is not None else a_exp
    return V_out, t_out, w


def _coeffs_from_values(entries, out_shape, dtype, device, want):
    """Inverse-transform the ``want`` entries (V, t) into a zero-filled
    coefficient stack ``out_shape``."""
    Vs = torch.stack([entries[ij][0] for ij in want], dim=-2)
    ts = torch.stack([entries[ij][1] for ij in want], dim=-1)
    qs = torch.fft.ifft(Vs, dim=-1)
    qs[..., 0] -= ts
    qs = torch.cat([qs, ts[..., None]], dim=-1)
    out = torch.zeros(out_shape, dtype=dtype, device=device)
    for k, (i, j) in enumerate(want):
        out[..., i, j, :] = qs[..., k, :]
    return out


_ALL_ENTRIES = ((0, 0), (0, 1), (1, 0), (1, 1))


def _value_exit(V, t, want=None):
    """Values ``(V, t)`` on the N grid -> coefficients ``[..., N+1]``;
    entries outside ``want`` are zero."""
    want = want or _ALL_ENTRIES
    entries = {(i, j): (V[..., i, j, :], t[..., i, j]) for i, j in want}
    return _coeffs_from_values(entries, V.shape[:-1] + (V.shape[-1] + 1,),
                               V.dtype, V.device, want)


# ---------------------------------------------------------------------------
# J-symmetric value-space levels (fnft_tpu poly.py:227-333): NSE transfer
# matrices satisfy P22 = rev(conj(P11)), P12 = -kappa rev(conj(P21)), so the
# tree carries only the first column (Vc, tc, cc) of every node.
# ---------------------------------------------------------------------------

def _value_enter_sym(p: torch.Tensor):
    """Coefficients ``[..., n, 2, 2, N+1]`` -> column state (Vc, tc, cc)."""
    col = p[..., :, 0, :]                      # [..., n, 2(row), N+1]
    tc = col[..., -1]
    cc = col[..., 0]
    Vc = torch.fft.fft(col[..., :-1], dim=-1) + tc[..., None]
    return Vc, tc, cc


def _value_level_sym(Vc, tc, cc, w, kappa: int, do_norm: bool):
    """One J-symmetric tree level: N-grid column pairs -> 2N-grid products."""
    Va, Vb = Vc[..., 0::2, :, :], Vc[..., 1::2, :, :]
    ta, tb = tc[..., 0::2, :], tc[..., 1::2, :]
    ca, cb = cc[..., 0::2, :], cc[..., 1::2, :]
    tw = _half_twiddle(Vc.shape[-1], Vc.dtype, Vc.device)
    a11, a21 = Va[..., 0, :], Va[..., 1, :]
    b11, b21 = Vb[..., 0, :], Vb[..., 1, :]
    # even bins (z^N == 1): B12 = -kappa conj(B21), B22 = conj(B11)
    even11 = b11 * a11 - kappa * (torch.conj(b21) * a21)
    even21 = b21 * a11 + torch.conj(b11) * a21
    # odd bins (z^N == -1): B12 = +kappa conj(B21), B22 = -conj(B11)
    Bo = _value_odd_bins(Vb, tb, tw)
    Ao = _value_odd_bins(Va, ta, tw)
    a11o, a21o = Ao[..., 0, :], Ao[..., 1, :]
    b11o, b21o = Bo[..., 0, :], Bo[..., 1, :]
    odd11 = b11o * a11o + kappa * (torch.conj(b21o) * a21o)
    odd21 = b21o * a11o - torch.conj(b11o) * a21o
    V_out = torch.stack([_interleave(even11, odd11),
                         _interleave(even21, odd21)], dim=-2)
    t11 = tb[..., 0] * ta[..., 0] - kappa * (torch.conj(cb[..., 1]) * ta[..., 1])
    t21 = tb[..., 1] * ta[..., 0] + torch.conj(cb[..., 0]) * ta[..., 1]
    c11 = cb[..., 0] * ca[..., 0] - kappa * (torch.conj(tb[..., 1]) * ca[..., 1])
    c21 = cb[..., 1] * ca[..., 0] + torch.conj(tb[..., 0]) * ca[..., 1]
    t_out = torch.stack([t11, t21], dim=-1)
    c_out = torch.stack([c11, c21], dim=-1)
    if w is not None:
        w = w[..., 0::2] + w[..., 1::2]
    if do_norm:
        max_abs = torch.maximum(
            torch.abs(V_out).amax(dim=(-2, -1)),
            torch.maximum(torch.abs(t_out).amax(dim=-1),
                          torch.abs(c_out).amax(dim=-1)))
        a_exp = _floor_log2(max_abs)
        scale = _pow2(-a_exp, max_abs.dtype)
        V_out = V_out * scale[..., None, None]
        t_out = t_out * scale[..., None]
        c_out = c_out * scale[..., None]
        w = w + a_exp if w is not None else a_exp
    return V_out, t_out, c_out, w


def _value_exit_sym(Vc, tc, cc, kappa: int, want=None):
    """Column state on the N grid -> coefficients ``[..., 2, 2, N+1]``;
    entries outside ``want`` are zero."""
    want = want or _ALL_ENTRIES
    entries = {
        (0, 0): (Vc[..., 0, :], tc[..., 0]),
        (1, 0): (Vc[..., 1, :], tc[..., 1]),
        (1, 1): (torch.conj(Vc[..., 0, :]), torch.conj(cc[..., 0])),
        (0, 1): (-kappa * torch.conj(Vc[..., 1, :]),
                 -kappa * torch.conj(cc[..., 1])),
    }
    n_grid = Vc.shape[-1]
    return _coeffs_from_values(entries, Vc.shape[:-2] + (2, 2, n_grid + 1),
                               Vc.dtype, Vc.device, want)


# ---------------------------------------------------------------------------
# Real-coefficient value-space levels (fnft_tpu poly.py:337-431). KdV: r = -1
# and a real potential give transfer matrices with all-real coefficients,
# closed under products, so every value grid is conjugate-symmetric and the
# tree carries only bins 0..N/2 (rfft layout). The even bins of the doubled
# grid are pointwise products of the carried halves; the odd bins cost one
# irfft and two rffts per factor (x * w_{2N}^j splits into the two real
# sequences x cos and x sin).
# ---------------------------------------------------------------------------

def _value_enter_real(p: torch.Tensor):
    """Real coefficients ``[..., n, 2, 2, N+1]`` -> half-grid values
    ``(V [..., N/2+1], t)``, t the (real) z^N coefficient."""
    t = p[..., -1]
    V = torch.fft.rfft(p[..., :-1], dim=-1) + t[..., None]
    return V, t


def _value_odd_bins_real(V, t, tw_cos, tw_sin):
    """Odd-bin evaluations o[k] = p(w_{2N}^{2k+1}) for k = 0..N/2-1; the
    other half follows from o[N-1-k] = conj(o[k])."""
    n = 2 * (V.shape[-1] - 1)
    x = torch.fft.irfft(V, n=n, dim=-1)
    oc = torch.fft.rfft(x * tw_cos, dim=-1)[..., :-1]
    osn = torch.fft.rfft(x * tw_sin, dim=-1)[..., :-1]
    return torch.complex(oc.real + osn.imag, oc.imag - osn.real) - (
        2.0 * t)[..., None]


def _value_level_real(V, t, w, do_norm: bool):
    """One real-symmetric tree level: N/2+1 half grids -> N+1 half grids."""
    Va, Vb = V[..., 0::2, :, :, :], V[..., 1::2, :, :, :]
    ta, tb = t[..., 0::2, :, :], t[..., 1::2, :, :]
    n = 2 * (V.shape[-1] - 1)
    ang = torch.arange(n, dtype=t.dtype, device=t.device) * (math.pi / n)
    tw_cos, tw_sin = torch.cos(ang), torch.sin(ang)
    even = _mat2x2_mul(Vb, Va)                       # bins 0, 2, .., N
    odd = _mat2x2_mul(_value_odd_bins_real(Vb, tb, tw_cos, tw_sin),
                      _value_odd_bins_real(Va, ta, tw_cos, tw_sin))
    # out[2m] = even[m] (m <= N/2), out[2m+1] = odd[m] (m < N/2)
    odd = torch.cat([odd, torch.zeros_like(odd[..., :1])], dim=-1)
    V_out = _interleave(even, odd)[..., : n + 1]
    t_out = _mat2x2_mul(tb[..., None], ta[..., None])[..., 0]
    if w is not None:
        w = w[..., 0::2] + w[..., 1::2]
    if do_norm:
        # the bins not carried are conjugates of carried ones: same maximum
        max_abs = torch.maximum(torch.abs(V_out).amax(dim=(-3, -2, -1)),
                                torch.abs(t_out).amax(dim=(-2, -1)))
        a_exp = _floor_log2(max_abs)
        scale = _pow2(-a_exp, max_abs.dtype)
        V_out = V_out * scale[..., None, None, None]
        t_out = t_out * scale[..., None, None]
        w = w + a_exp if w is not None else a_exp
    return V_out, t_out, w


def _value_exit_real(V, t, cdt, want=None):
    """Half-grid values -> complex-typed coefficients ``[..., 2, 2, N+1]``
    (mathematically real); entries outside ``want`` are zero."""
    n = 2 * (V.shape[-1] - 1)
    want = want or _ALL_ENTRIES
    Vs = torch.stack([V[..., i, j, :] for i, j in want], dim=-2)
    ts = torch.stack([t[..., i, j] for i, j in want], dim=-1)
    qs = torch.fft.irfft(Vs, n=n, dim=-1)
    qs[..., 0] -= ts
    qs = torch.cat([qs, ts[..., None]], dim=-1)
    out = torch.zeros(V.shape[:-3] + (2, 2, n + 1), dtype=cdt, device=V.device)
    for k, (i, j) in enumerate(want):
        out[..., i, j, :] = qs[..., k, :]
    return out


def _pad_to_power_of_2_2x2(p: torch.Tensor):
    """Pad a matrix stack with identity (constant-1 polynomial) matrices."""
    n = p.shape[-4]
    n_pad = next_power_of_2(n)
    if n_pad == n:
        return p, 0
    eye = torch.zeros(p.shape[:-4] + (n_pad - n, 2, 2, p.shape[-1]),
                      dtype=p.dtype, device=p.device)
    eye[..., 0, 0, 0] = 1.0
    eye[..., 1, 1, 0] = 1.0
    return torch.cat([p, eye], dim=-4), n_pad - n


def _k1_levels(p: torch.Tensor, levels: int) -> int:
    """Tree levels of the padded stack ``p [..., n_pad, 2, 2, c]`` (``levels``
    in all) to hand the fused kernel K1, 0 for none. Three where c = 3 or 4,
    which then leaves no direct-convolution level (8 (c - 1) + 1 >
    ``_CONV_CUTOFF``), n_pad is a multiple of 2^3 * 128 and no gradient
    flows through ``p`` (K1's backward, K1T, takes two levels). Else two
    under the JAX package's shape test: c <= 4, n_pad a multiple of
    2^2 * 128."""
    c, n_pad = p.shape[-1], p.shape[-4]
    grad = torch.is_grad_enabled() and p.requires_grad
    if c in (3, 4) and not grad and levels > 3 and n_pad % (8 * 128) == 0:
        return 3
    if c <= 4 and levels > 2 and n_pad % (4 * 128) == 0:
        return 2
    return 0


def fmult2x2_tree(p: torch.Tensor, *, normalize: bool = True, want=None,
                  jsym: int | None = None, rsym: bool = False):
    """Multiply a stack of 2x2 polynomial matrices via a log-depth FFT tree.

    Args:
      p: ``[..., n, 2, 2, deg+1]`` ascending coefficients, natural time order.
      normalize: per-product power-of-two rescaling (returns exponent ``w``).
      want: optional tuple of (row, col) entries of the final matrix the
        caller will read; the remaining entries of the result are zero.
      jsym: +1/-1 asserts the J-involution symmetry of every input matrix
        (NSE with r = -jsym conj(q)); with n a power of two the value-space
        levels then carry only the first matrix column.
      rsym: asserts every input coefficient is real (KdV: r = -1 with a
        real potential). The direct levels then run in real arithmetic and
        the value-space levels carry conjugate-symmetric half grids; the
        result still comes back in the complex dtype of ``p``. Takes
        precedence over ``jsym`` and skips the fused kernel.

    The first levels go to the fused kernel
    (:func:`fnft_tpu_torch.ops.kernels.fused_tree_levels`, plain version on
    the CPU): three for deg+1 = 3 or 4, every level direct convolution
    would take, else two (see :func:`_k1_levels`).

    Returns ``(result [..., 2, 2, n*deg+1], w)`` with int32 ``w`` and
    ``true_result = result * 2**w`` (w == 0 when normalize=False).
    """
    n = p.shape[-4]
    deg_in = p.shape[-1] - 1
    cdt_in = complex_dtype_of(p)
    p, _ = _pad_to_power_of_2_2x2(p)
    if rsym:
        p = p.real
    n_pad = p.shape[-4]
    levels = int(math.log2(n_pad)) if n_pad > 1 else 0

    fuse = 0 if rsym else _k1_levels(p, levels)
    if fuse:
        p, w = fused_tree_levels(p.contiguous(), fuse, normalize=normalize)
        levels -= fuse
        if not normalize:
            w = None
    else:
        w = torch.zeros(p.shape[:-4] + (n_pad,), dtype=torch.int32,
                        device=p.device) if normalize else None

    def _do_norm(lv):
        # rescale every other level (and always the last): two levels of
        # near-unitary products cannot overflow
        return normalize and (lv % 2 == 1 or lv == levels - 1)

    lv = 0
    # tiny degrees: direct convolution beats any FFT
    while lv < levels and p.shape[-1] <= _CONV_CUTOFF:
        p, w = _tree_level_2x2(p, w, _do_norm(lv))
        lv += 1
    if levels - lv >= 2:
        if rsym and (p.shape[-1] - 1) % 2 == 0:
            V, t = _value_enter_real(p)
            while lv < levels:
                V, t, w = _value_level_real(V, t, w, _do_norm(lv))
                lv += 1
            p = _value_exit_real(V, t, cdt_in, want=want)
        elif jsym in (1, -1) and n == n_pad and not rsym:
            Vc, tc, cc = _value_enter_sym(p)
            while lv < levels:
                Vc, tc, cc, w = _value_level_sym(Vc, tc, cc, w, jsym,
                                                 _do_norm(lv))
                lv += 1
            p = _value_exit_sym(Vc, tc, cc, jsym, want=want)
        else:
            V, t = _value_enter(p)
            while lv < levels:
                V, t, w = _value_level(V, t, w, _do_norm(lv))
                lv += 1
            p = _value_exit(V, t, want=want)
    else:
        while lv < levels:
            p, w = _tree_level_2x2(p, w, _do_norm(lv))
            lv += 1
        if want is not None:
            mask = torch.zeros((2, 2, 1), dtype=torch.bool, device=p.device)
            for i, j in want:
                mask[i, j, 0] = True
            p = torch.where(mask, p, 0.0)
    # identity padding contributes degree 0; true degree is n*deg_in
    result = p[..., 0, :, :, : n * deg_in + 1].to(cdt_in)
    if w is None:
        w_out = torch.zeros(result.shape[:-3], dtype=torch.int32,
                            device=p.device)
    else:
        w_out = w[..., 0]
    return result, w_out


def fmult2x2(p: torch.Tensor, *, normalize: bool = True):
    """Alias of :func:`fmult2x2_tree` (reference name: poly_fmult2x2)."""
    return fmult2x2_tree(p, normalize=normalize)


def fmult(p: torch.Tensor, *, normalize: bool = True):
    """Scalar version: multiply ``[..., n, deg+1]`` polynomials.

    Returns (result ``[..., n*deg+1]``, w) with the normalization semantics
    of :func:`fmult2x2_tree` (reference: poly_fmult).
    """
    n = p.shape[-2]
    deg_in = p.shape[-1] - 1
    n_pad = next_power_of_2(n)
    if n_pad != n:
        ones = torch.zeros(p.shape[:-2] + (n_pad - n, p.shape[-1]),
                           dtype=p.dtype, device=p.device)
        ones[..., 0] = 1.0
        p = torch.cat([p, ones], dim=-2)
    w = torch.zeros(p.shape[:-1], dtype=torch.int32,
                    device=p.device) if normalize else None
    while p.shape[-2] > 1:
        c = p.shape[-1]
        length = next_fft_length(2 * c - 1)
        fa = torch.fft.fft(p[..., 0::2, :], n=length, dim=-1)
        fb = torch.fft.fft(p[..., 1::2, :], n=length, dim=-1)
        prod = torch.fft.ifft(fa * fb, dim=-1)[..., : 2 * c - 1]
        if not p.is_complex():
            prod = prod.real
        if w is not None:
            mx = torch.abs(prod).amax(dim=-1)
            a_exp = _floor_log2(mx)
            prod = prod * _pow2(-a_exp, mx.dtype)[..., None]
            w = w[..., 0::2] + w[..., 1::2] + a_exp
        p = prod
    result = p[..., 0, : n * deg_in + 1]
    if w is None:
        return result, torch.zeros(result.shape[:-1], dtype=torch.int32,
                                   device=p.device)
    return result, w[..., 0]


# ---------------------------------------------------------------------------
# Chirp-Z transform
# ---------------------------------------------------------------------------

def _spiral_table(base: complex, exponents: np.ndarray) -> np.ndarray:
    """base**exponents computed in extended precision on the host
    (exponents grow like deg^2/2; fnft_tpu poly.py:642)."""
    log_mag = np.log(np.abs(base)) if abs(base) != 1.0 else 0.0
    theta = np.longdouble(math.atan2(base.imag, base.real))
    e = exponents.astype(np.longdouble)
    phase = np.mod(e * theta, np.longdouble(2 * math.pi))
    mag = np.exp(e * np.longdouble(log_mag)) if log_mag != 0.0 else 1.0
    return (mag * (np.cos(phase.astype(np.float64))
                   + 1j * np.sin(phase.astype(np.float64)))).astype(np.complex128)


@functools.lru_cache(maxsize=4)
def _chirpz_tables(a: complex, w: complex, n: int, m: int,
                   cdt: torch.dtype, device: torch.device):
    """(input weights [n], FFT of the chirp filter [length], output weights
    [m]) on ``device``; the tables depend only on the grid geometry."""
    length = next_fft_length(n + m - 1)
    ks = np.arange(max(n, m), dtype=np.float64)
    w_half_sq = _spiral_table(w, 0.5 * ks * ks)            # w^{k^2/2}
    a_pow = _spiral_table(a, ks[:n])                       # a^n
    # v_j = w^{-j^2/2} for j = -(n-1) .. (m-1), laid out circularly
    v = np.zeros(length, dtype=np.complex128)
    v[:m] = 1.0 / w_half_sq[:m]
    neg = _spiral_table(w, 0.5 * ks[1:n] * ks[1:n])
    v[length - n + 1:] = (1.0 / neg)[::-1]
    return tuple(torch.as_tensor(x, device=device).to(cdt) for x in
                 (a_pow * w_half_sq[:n], np.fft.fft(v), w_half_sq[:m]))


def chirpz(coeffs: torch.Tensor, a: complex, w: complex, m: int,
           tables=None):
    """Evaluate p(z) at the spiral points ``z_k = a * w**k``, k = 0..m-1.

    Bluestein factorization (3 FFTs); ``coeffs`` may carry leading batch
    dimensions. ``tables`` are :func:`_chirpz_tables` of this geometry,
    held by a caller that evaluates it again and again (else taken from
    the cache). Reference: fnft__poly_chirpz.c:33-105, ascending order.
    """
    cdt = complex_dtype_of(coeffs)
    n = coeffs.shape[-1]
    x_weight, v_f, out_weight = tables or _chirpz_tables(
        complex(a), complex(w), n, m, cdt, coeffs.device)
    length = v_f.shape[0]
    x = coeffs.to(cdt) * x_weight
    conv = torch.fft.ifft(torch.fft.fft(x, n=length, dim=-1) * v_f, dim=-1)
    return conv[..., :m] * out_weight


# ---------------------------------------------------------------------------
# Horner evaluation
# ---------------------------------------------------------------------------

def poly_eval(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Evaluate p at points z (ascending coefficients, Horner).

    For |z| > 1 the reversed form p(z) = z^deg q(1/z) is used for
    stability (reference: fnft__poly_eval.c:25-91).
    """
    return poly_evalderiv(coeffs, z, with_derivative=False)[0]


def poly_evalderiv(coeffs: torch.Tensor, z: torch.Tensor, *,
                   with_derivative: bool = True):
    """Evaluate (p(z), p'(z)) at a vector of points (p' is None without
    ``with_derivative``)."""
    cdt = torch.promote_types(complex_dtype_of(coeffs), complex_dtype_of(z))
    coeffs, z = coeffs.to(cdt), z.to(cdt)
    deg = coeffs.shape[-1] - 1
    inside = torch.abs(z) <= 1.0
    x = torch.where(inside, z, 1.0 / torch.where(z == 0, 1.0, z))

    def horner(cs):
        # from the highest coefficient downward, tracking p and p'
        pv, dv = torch.zeros_like(x), torch.zeros_like(x)
        for ck in cs.flip(-1):
            dv = dv * x + pv
            pv = pv * x + ck
        return pv, dv

    p_in, dp_in = horner(coeffs)            # valid when |z| <= 1
    p_rev, dp_rev = horner(coeffs.flip(-1))  # q(1/z), q'(1/z)
    zo = torch.where(inside, 1.0, z)
    p = torch.where(inside, p_in, zo ** deg * p_rev)
    if not with_derivative:
        return p, None
    # p'(z) = deg z^{deg-1} q(1/z) - z^{deg-2} q'(1/z) for the reversed form
    dp_out = deg * zo ** (deg - 1) * p_rev - zo ** (deg - 2) * dp_rev
    return p, torch.where(inside, dp_in, dp_out)
