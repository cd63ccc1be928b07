"""Plain scattering of a sampled AKNS potential, written from the schemes'
definitions: per-sample 2x2 step matrices at each spectral point and
their ordered product, in chunks of steps reduced by pairwise products.

Nothing here uses a polynomial transfer matrix, an FFT or a chirp-Z
transform, and nothing imports the program under test. A step matrix
advances v' = (A + B) v, A = -i lam sigma_3, B = [[0, q], [r, 0]],
r = -kappa conj(q), over one sample of width h; the product of a signal's
D steps is T = U_{D-1} ... U_0, and with the boundary times
t_b = t0 - h/2, t_e = t1 + h/2 the scattering data are
a = T_00 exp(i lam (t_e - t_b)) and b = T_10 exp(-i lam (t_e + t_b)).

Two schemes:

* ``2split4b``: the fourth-order splitting of Prins and Wahls
  (arXiv:1712.06647), -1/3 E(1) Z(2) E(1) + 4/3 E(1/2) Z(1) E(1) Z(1)
  E(1/2), with E(a) = expm(B a h / 2) and Z(a) = expm(A a h / 2).
* ``bo``: the exact step of a piecewise-constant potential,
  expm((A + B) h) (Boffetta and Osborne, J. Comput. Phys. 102, 1992).

Matrices are kept as four tensors (entries 00, 01, 10, 11). A product may
be kept normalized: each matrix then carries an int64 exponent w with
true = stored * 2**w, which keeps growing products (complex lam) in range
in either precision.
"""

from __future__ import annotations

import math

import torch

# elements of one entry tensor in a chunk of steps (4 entries of complex128
# at 2^23 elements: 512 MiB, a few times that in temporaries)
CHUNK_ELEMENTS = 1 << 23


def _sinc(x: torch.Tensor) -> torch.Tensor:
    """sin(x)/x for complex x, its series near 0."""
    small = torch.abs(x) < 1e-4
    safe = torch.where(small, torch.ones_like(x), x)
    x2 = x * x
    return torch.where(small, 1.0 - x2 / 6.0 + x2 * x2 / 120.0,
                       torch.sin(safe) / safe)


def _expm_b(q, r, tau):
    """expm([[0, q], [r, 0]] tau) as (diagonal, 01, 10)."""
    d = tau * torch.sqrt(-q * r)
    s = tau * _sinc(d)
    return torch.cos(d), q * s, r * s


def _mul(a, b):
    """The 2x2 product a @ b of entry tuples."""
    a00, a01, a10, a11 = a
    b00, b01, b10, b11 = b
    return (a00 * b00 + a01 * b10, a00 * b01 + a01 * b11,
            a10 * b00 + a11 * b10, a10 * b01 + a11 * b11)


def _normalize(m, w):
    """Rescale each matrix by an exact power of two so its largest real or
    imaginary part lies in [0.5, 1); returns (entries, exponents)."""
    big = torch.stack([torch.view_as_real(x).abs().amax(dim=-1) for x in m]
                      ).amax(dim=0)
    _, e = torch.frexp(torch.where(big > 0, big, torch.ones_like(big)))
    scale = torch.ldexp(torch.ones_like(big), -e)
    return tuple(x * scale for x in m), w + e.to(torch.int64)


def _tree(m, w):
    """Ordered product over the last axis (later steps on the left) by
    pairwise products; ``w`` None for an unnormalized product."""
    while m[0].shape[-1] > 1:
        n = m[0].shape[-1]
        odd = n % 2
        lo = tuple(x[..., 0:n - odd:2] for x in m)
        hi = tuple(x[..., 1:n:2] for x in m)
        p = _mul(hi, lo)
        if w is not None:
            pw = w[..., 0:n - odd:2] + w[..., 1:n:2]
        if odd:
            p = tuple(torch.cat([x, y[..., -1:]], dim=-1)
                      for x, y in zip(p, m))
            if w is not None:
                pw = torch.cat([pw, w[..., -1:]], dim=-1)
        m = p
        if w is not None:
            m, w = _normalize(m, pw)
    return tuple(x[..., 0] for x in m), (w[..., 0] if w is not None else None)


def ordered_product(step, n_steps: int, points: int, *, normalize: bool):
    """T = U_{n-1} ... U_0 for ``step(i0, i1) -> (U00, U01, U10, U11)``,
    each ``[..., i1 - i0]`` with ``points`` spectral points in front of the
    step axis. Returns (entries, exponents or None)."""
    chunk = max(1, min(n_steps, CHUNK_ELEMENTS // max(points, 1)))
    total, wt = None, None
    for i0 in range(0, n_steps, chunk):
        m = step(i0, min(n_steps, i0 + chunk))
        w = None
        if normalize:
            w = torch.zeros(m[0].shape, dtype=torch.int64, device=m[0].device)
        m, w = _tree(m, w)
        if total is None:
            total, wt = m, w
        else:
            total = _mul(m, total)
            if normalize:
                total, wt = _normalize(total, w + wt)
    return total, wt


def split4b_coefficients(q: torch.Tensor, r: torch.Tensor, h: float):
    """The 2SPLIT4B step as U_ij = alpha_ij e + beta_ij + gamma_ij / e,
    e = exp(-i lam h): twelve tensors shaped like ``q``, in the order
    (alpha, beta, gamma) of entries 00, 01, 10, 11."""
    c, p, s = _expm_b(q, r, h / 2)         # E(1)
    ch, ph, sh = _expm_b(q, r, h / 4)      # E(1/2)
    third = 1.0 / 3.0
    zero = torch.zeros_like(c)
    # -1/3 E(1) Z(2) E(1)
    t = ((c * c, zero, p * s), (c * p, zero, c * p),
         (s * c, zero, c * s), (s * p, zero, c * c))
    # 4/3 E(1/2) Z(1) E(1) Z(1) E(1/2)
    y = ((ch * ch * c, ch * (ph * s + p * sh), ph * sh * c),
         (ch * c * ph, ph * ph * s + ch * ch * p, ph * c * ch),
         (sh * c * ch, ch * ch * s + sh * sh * p, ch * c * sh),
         (sh * c * ph, ch * (s * ph + p * sh), ch * ch * c))
    return tuple(tuple(4.0 * third * yk - third * tk for tk, yk in zip(te, ye))
                 for te, ye in zip(t, y))


def split4b_product(q: torch.Tensor, lam: torch.Tensor, h: float,
                    kappa: int = 1):
    """T at every ``lam [..., X]`` (real or complex) for the rows
    ``q [..., D]`` (same leading axes, or broadcasting), unnormalized."""
    r = -kappa * torch.conj(q)
    e = torch.exp(-1j * h * lam)[..., :, None]
    ei = torch.exp(1j * h * lam)[..., :, None]
    n_steps = q.shape[-1]
    points = max(q[..., 0].numel(), lam[..., 0].numel()) * lam.shape[-1]

    def step(i0, i1):
        coef = split4b_coefficients(q[..., None, i0:i1], r[..., None, i0:i1],
                                    h)
        return tuple(al * e + be + ga * ei for al, be, ga in coef)

    return ordered_product(step, n_steps, points, normalize=False)[0]


def _bo_cs(x: torch.Tensor, h: float):
    """cosh(k h) and sinh(k h) / k as entire functions of x = k^2 h^2:
    their series for |x| <= 1, closed forms beyond."""
    c = torch.zeros_like(x)
    s = torch.zeros_like(x)
    for j in range(9, -1, -1):     # Horner, x^j / (2j)! and x^j / (2j+1)!
        c = c * x / ((2 * j + 1) * (2 * j + 2)) + 1.0
        s = s * x / ((2 * j + 2) * (2 * j + 3)) + 1.0
    kh = torch.sqrt(x)
    safe = torch.where(kh == 0, torch.ones_like(kh), kh)
    big = torch.abs(x) > 1.0
    return (torch.where(big, torch.cosh(kh), c),
            h * torch.where(big, torch.sinh(safe) / safe, s))


def bo_product(q: torch.Tensor, lam: torch.Tensor, h: float, i0: int,
               i1: int, kappa: int = 1):
    """Normalized BO product of the steps i0 .. i1-1 of ``q [R, D]`` at
    ``lam [R, K]``: ((T00, T01, T10, T11) each [R, K], w [R, K])."""
    r = -kappa * torch.conj(q)
    lam_ = lam[..., :, None]

    def step(j0, j1):
        qs = q[..., None, i0 + j0:i0 + j1]
        rs = r[..., None, i0 + j0:i0 + j1]
        c, s = _bo_cs((qs * rs - lam_ * lam_) * (h * h), h)
        return (c - 1j * lam_ * s, qs * s, rs * s, c + 1j * lam_ * s)

    return ordered_product(step, i1 - i0, lam.numel(), normalize=True)


def bo_a(q, lam, h, t_b, t_e, kappa=1):
    """a(lam) of the BO scheme at ``lam [R, K]``."""
    (t00, _, _, _), w = bo_product(q, lam, h, 0, q.shape[-1], kappa)
    rdt = lam.real.dtype
    return t00 * torch.exp(w.to(rdt) * math.log(2.0)
                           + 1j * lam * (t_e - t_b))


def bo_b(q, lam, h, t_b, t_e, kappa=1):
    """b at bound states ``lam [R, K]`` of the BO scheme: phi, swept from
    t_b to the middle sample, is b times psi, swept back from t_e, at
    every sample of an exact zero of a; b is their least-squares ratio at
    the middle sample."""
    d = q.shape[-1]
    mid = d // 2
    (l00, _, l10, _), wl = bo_product(q, lam, h, 0, mid, kappa)
    (r00, r01, _, _), wr = bo_product(q, lam, h, mid, d, kappa)
    # phi = 2^wl e^{-i lam t_b} L e_1; psi = 2^wr e^{i lam t_e} adj(R) e_2
    p1, p2 = -r01, r00
    ratio = ((l00 * torch.conj(p1) + l10 * torch.conj(p2))
             / (torch.abs(p1) ** 2 + torch.abs(p2) ** 2))
    rdt = lam.real.dtype
    return ratio * torch.exp((wl - wr).to(rdt) * math.log(2.0)
                             - 1j * lam * (t_b + t_e))


def bo_newton(q, lam0, h, t_b, t_e, kappa=1, iters: int = 6):
    """Zeros of a(lam) of the BO scheme by Newton's method from ``lam0
    [R, K]``; the derivative by a central difference of step eps^(1/3)
    max(1, |lam|) in the working precision, whose error only slows the
    last steps."""
    lam = lam0
    step = torch.finfo(lam.real.dtype).eps ** (1.0 / 3.0)
    for _ in range(iters):
        dl = step * torch.clamp(torch.abs(lam), min=1.0)
        a = bo_a(q, lam, h, t_b, t_e, kappa)
        ap = (bo_a(q, lam + dl, h, t_b, t_e, kappa)
              - bo_a(q, lam - dl, h, t_b, t_e, kappa)) / (2 * dl)
        lam = lam - a / ap
    return lam
