"""AKNS discretization metadata and exponential-splitting specifications.

A copy of ``fnft_tpu/models/discretization.py`` (numpy-only), with the
lambda <-> z maps on torch tensors.

Rebuild of fnft__akns_discretization.c (metadata, lambda<->z maps, CF
weights) plus a *generative* replacement for the hard-coded per-scheme
polynomial coefficient tables in fnft__akns_fscatter.c:116-917.

Every fast 2SPLIT / 4SPLIT scheme approximates the one-step transfer matrix
exp((A + B) h), A = -i lam sigma_3, B = [[0, q], [r, 0]], by a linear
combination of alternating products of

  * ``Z(a)`` = diag(1, z^a)  — the normalized free propagator
    exp(A a h/deg) * z^{a/2}, with z = exp(2 i lam h / deg), and
  * ``E(a)`` = expm(B a h/deg) — a constant 2x2 matrix with the closed form
    [[cos(D), q d sinc], [r d sinc, cos(D)]], D = (a h/deg) sqrt(-q r).

The combinations are Richardson extrapolations of Strang / Lie compositions
(Prins & Wahls, "Higher order convergent fast nonlinear Fourier transform",
IEEE PTL 2018; arXiv:1712.06647):

  even order 2K:  sum_m gamma_m S2(h/m)^m,          m = 1..K,
                  gamma_m = m^{2(K-1)} / prod_{j != m} (m^2 - j^2)
  odd order 2K-1: sum_m gamma_m L_m(h),              m = 1..K,
                  L_m = A(s) B(2s) [A(2s) B(2s)]^{m-2} A(2s) B(s),
                  s = h/(2m-1),
                  gamma_m = (2m-1)^{2(K-1)} / prod_{j != m} ((2m-1)^2-(2j-1)^2)

"A" variants start with the free propagator, "B" variants with the
potential. These tables were verified against the reference's emitted
polynomial coefficients (fnft__akns_fscatter.c cases 2SPLIT1A..2SPLIT8B).
"""

from __future__ import annotations

import enum
import math
from fractions import Fraction
from functools import lru_cache

import numpy as np


class Discretization(enum.Enum):
    """NSE/KdV/AKNS discretization schemes (fnft_nse_discretization_t.h:37-66)."""

    # fast, polynomial transfer matrix
    SPLIT2_MODAL = "2split2_modal"
    SPLIT1A = "2split1a"
    SPLIT1B = "2split1b"
    SPLIT2A = "2split2a"
    SPLIT2B = "2split2b"
    SPLIT2S = "2split2s"
    SPLIT3A = "2split3a"
    SPLIT3B = "2split3b"
    SPLIT3S = "2split3s"
    SPLIT4A = "2split4a"
    SPLIT4B = "2split4b"
    SPLIT5A = "2split5a"
    SPLIT5B = "2split5b"
    SPLIT6A = "2split6a"
    SPLIT6B = "2split6b"
    SPLIT7A = "2split7a"
    SPLIT7B = "2split7b"
    SPLIT8A = "2split8a"
    SPLIT8B = "2split8b"
    SPLIT4A4 = "4split4a"
    SPLIT4B4 = "4split4b"
    # slow, ODE-style schemes
    BO = "bo"
    CF4_2 = "cf4_2"
    CF4_3 = "cf4_3"
    CF5_3 = "cf5_3"
    CF6_4 = "cf6_4"
    ES4 = "es4"
    TES4 = "tes4"


_FAST = {
    Discretization.SPLIT2_MODAL, Discretization.SPLIT1A, Discretization.SPLIT1B,
    Discretization.SPLIT2A, Discretization.SPLIT2B, Discretization.SPLIT2S,
    Discretization.SPLIT3A, Discretization.SPLIT3B, Discretization.SPLIT3S,
    Discretization.SPLIT4A, Discretization.SPLIT4B, Discretization.SPLIT5A,
    Discretization.SPLIT5B, Discretization.SPLIT6A, Discretization.SPLIT6B,
    Discretization.SPLIT7A, Discretization.SPLIT7B, Discretization.SPLIT8A,
    Discretization.SPLIT8B, Discretization.SPLIT4A4, Discretization.SPLIT4B4,
}

# polynomial degree of one scattering-matrix step (akns_discretization.c:29-67)
_DEGREE = {
    Discretization.SPLIT1A: 1, Discretization.SPLIT1B: 1,
    Discretization.SPLIT2A: 1, Discretization.SPLIT2B: 1,
    Discretization.SPLIT2S: 1, Discretization.SPLIT2_MODAL: 1,
    Discretization.SPLIT3S: 2, Discretization.SPLIT4B: 2,
    Discretization.SPLIT4B4: 2,
    Discretization.SPLIT3A: 3, Discretization.SPLIT3B: 3,
    Discretization.SPLIT4A: 4, Discretization.SPLIT4A4: 4,
    Discretization.SPLIT6B: 6,
    Discretization.SPLIT6A: 12, Discretization.SPLIT8B: 12,
    Discretization.SPLIT5A: 15, Discretization.SPLIT5B: 15,
    Discretization.SPLIT8A: 24,
    Discretization.SPLIT7A: 105, Discretization.SPLIT7B: 105,
}

# samples consumed per time step (akns_discretization.c:114-154)
_UPSAMPLING = {
    Discretization.SPLIT4A4: 2, Discretization.SPLIT4B4: 2,
    Discretization.CF4_2: 2,
    Discretization.CF4_3: 3, Discretization.CF5_3: 3,
    Discretization.ES4: 3, Discretization.TES4: 3,
    Discretization.CF6_4: 4,
}

# convergence order (akns_discretization.c:158-198)
_ORDER = {
    Discretization.SPLIT4A4: 4, Discretization.SPLIT4B4: 4,
    Discretization.CF4_2: 4, Discretization.CF4_3: 4,
    Discretization.ES4: 4, Discretization.TES4: 4,
    Discretization.CF5_3: 5, Discretization.CF6_4: 6,
}

BOUNDARY_COEFF = 0.5  # identical for every scheme (akns_discretization.c:72-109)


def is_fast(d: Discretization) -> bool:
    return d in _FAST


def degree(d: Discretization) -> int:
    """Per-step polynomial degree (0 for slow schemes)."""
    return _DEGREE.get(d, 0)


def upsampling_factor(d: Discretization) -> int:
    return _UPSAMPLING.get(d, 1)


def method_order(d: Discretization) -> int:
    return _ORDER.get(d, 2)


def degree1step_total(d: Discretization) -> int:
    """degree * upsampling factor — the z-map denominator."""
    return max(degree(d), 1) * upsampling_factor(d)


def lambda_to_z(lam, eps_t: float, d: Discretization):
    """z = exp(2 i lam eps_t / (degree*upsampling)) for a complex tensor."""
    import torch

    return torch.exp(2j * lam * (eps_t / degree1step_total(d)))


def z_to_lambda(z, eps_t: float, d: Discretization):
    import torch

    return torch.log(z) * (degree1step_total(d) / (2j * eps_t))


# ---------------------------------------------------------------------------
# CF method weights (akns_discretization.c:246-381)
# ---------------------------------------------------------------------------

def _legendre(n: int, x: float) -> float:
    if n == 0:
        return 1.0
    if n == 1:
        return x
    p0, p1 = 1.0, x
    for k in range(2, n + 1):
        p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
    return p1


@lru_cache(maxsize=None)
def method_weights(d: Discretization) -> np.ndarray:
    """Commutator-free scheme weights, shape [stages, nodes] flattened."""
    if d in (Discretization.CF4_2, Discretization.SPLIT4A4,
             Discretization.SPLIT4B4):
        s = math.sqrt(3.0) / 6.0
        return np.array([0.25 + s, 0.25 - s, 0.25 - s, 0.25 + s],
                        dtype=np.complex128)
    if d is Discretization.CF4_3:
        f = np.array([[11 / 40, 20 / 87, 7 / 50],
                      [9 / 20, 0.0, -7 / 25],
                      [11 / 40, -20 / 87, 7 / 50]])
        wm = np.array([5 / 18, 4 / 9, 5 / 18])
        xm = np.array([2 * math.sqrt(3 / 20), 0.0, -2 * math.sqrt(3 / 20)])
        w = np.zeros((3, 3), dtype=np.complex128)
        for i in range(3):
            for m in range(3):
                w[i, m] = sum((2 * n + 1) * _legendre(n, xm[m]) * f[i, n]
                              for n in range(3)) * wm[m]
        return w.reshape(-1)
    if d is Discretization.CF5_3:
        r15 = math.sqrt(15.0)
        w = np.zeros(9, dtype=np.complex128)
        w[0] = (145 + 37 * r15) / 900 + 1j * (5 + 3 * r15) / 300
        w[1] = -1 / 45 + 1j / 15
        w[2] = (145 - 37 * r15) / 900 + 1j * (5 - 3 * r15) / 300
        w[3] = -2 / 45 - 1j * r15 / 50
        w[4] = 22 / 45
        w[5] = np.conj(w[3])
        w[6] = np.conj(w[2])
        w[7] = np.conj(w[1])
        w[8] = np.conj(w[0])
        return w
    if d is Discretization.CF6_4:
        w = np.array([
            0.245985577298764 + 0.038734389227165j,
            -0.046806149832549 + 0.012442141491185j,
            0.010894359342569 - 0.004575808769067j,
            0.062868370946917 - 0.048761268117765j,
            0.269028372054771 - 0.012442141491185j,
            -0.041970529810473 + 0.014602687659668j,
            -0.041970529810473 + 0.014602687659668j,
            0.269028372054771 - 0.012442141491185j,
            0.062868370946917 - 0.048761268117765j,
            0.010894359342569 - 0.004575808769067j,
            -0.046806149832549 + 0.012442141491185j,
            0.245985577298764 + 0.038734389227165j,
        ], dtype=np.complex128)
        return w
    return np.array([1.0], dtype=np.complex128)


def cf_stages_nodes(d: Discretization) -> tuple[int, int]:
    """(stages M, quadrature nodes N) of a CF scheme (scatter_matrix.c:78-99)."""
    return {
        Discretization.BO: (1, 1),
        Discretization.CF4_2: (2, 2),
        Discretization.SPLIT4A4: (2, 2),
        Discretization.SPLIT4B4: (2, 2),
        Discretization.CF4_3: (3, 3),
        Discretization.CF5_3: (3, 3),
        Discretization.CF6_4: (4, 3),
    }.get(d, (1, 1))


def lambda_stage_weights(d: Discretization) -> np.ndarray:
    """Per-stage lambda scalings: row sums of the CF weights."""
    m, n = cf_stages_nodes(d)
    w = method_weights(d).reshape(m, n) if m * n > 1 else np.ones((1, 1))
    return np.sum(w, axis=1)


# ---------------------------------------------------------------------------
# Splitting specifications for the fast schemes
# ---------------------------------------------------------------------------
# A term is (coefficient, factors); a factor is ("Z", a) or ("E", a) with
# "a" in units of h/deg (Z powers are integers, E weights may be half-integer).

def _gamma_even(K: int) -> list[float]:
    out = []
    for m in range(1, K + 1):
        num = Fraction(m ** (2 * (K - 1)))
        den = Fraction(1)
        for j in range(1, K + 1):
            if j != m:
                den *= Fraction(m * m - j * j)
        out.append(float(num / den))
    return out


def _gamma_odd(K: int) -> list[float]:
    out = []
    for m in range(1, K + 1):
        nm = 2 * m - 1
        num = Fraction(nm ** (2 * (K - 1)))
        den = Fraction(1)
        for j in range(1, K + 1):
            if j != m:
                den *= Fraction(nm * nm - (2 * j - 1) ** 2)
        out.append(float(num / den))
    return out


def _strang_power(deg: int, m: int, variant: str):
    """S2(h/m)^m in Z/E factors; 'A' = free propagator outside."""
    outer, inner = (("Z", "E") if variant == "A" else ("E", "Z"))
    half = deg / (2 * m)
    full = deg / m
    fs = [(outer, half), (inner, full)]
    for _ in range(m - 1):
        fs += [(outer, full), (inner, full)]
    fs += [(outer, half)]
    return fs


def _lie_composition(deg: int, m: int, variant: str):
    """Odd-order building block L_m (see module docstring)."""
    first, second = (("Z", "E") if variant == "A" else ("E", "Z"))
    s = deg / (2 * m - 1)
    if m == 1:
        return [(first, float(deg)), (second, float(deg))]
    fs = [(first, s), (second, 2 * s)]
    for _ in range(m - 2):
        fs += [(first, 2 * s), (second, 2 * s)]
    fs += [(first, 2 * s), (second, s)]
    return fs


def _check_integer_z(factors) -> None:
    for kind, a in factors:
        if kind == "Z" and abs(a - round(a)) > 1e-12:
            raise AssertionError(f"non-integer Z power {a}")


@lru_cache(maxsize=None)
def splitting_spec(d: Discretization):
    """List of (coefficient, factors) terms; factors are (('Z'|'E'), a)."""
    deg = degree(d)
    if deg == 0:
        raise ValueError(f"{d} is a slow discretization without a splitting spec")
    if d is Discretization.SPLIT2_MODAL:
        raise ValueError("2SPLIT2_MODAL uses a direct construction, "
                         "not a splitting spec (see ops.fscatter).")
    if d is Discretization.SPLIT1A:
        terms = [(1.0, [("Z", 1.0), ("E", 1.0)])]
    elif d in (Discretization.SPLIT1B, Discretization.SPLIT2A):
        terms = [(1.0, [("E", 1.0), ("Z", 1.0)])]
    elif d is Discretization.SPLIT2B:
        terms = [(1.0, [("E", 0.5), ("Z", 1.0), ("E", 0.5)])]
    elif d is Discretization.SPLIT2S:
        terms = [(0.5, [("Z", 1.0), ("E", 1.0)]),
                 (0.5, [("E", 1.0), ("Z", 1.0)])]
    elif d is Discretization.SPLIT3S:
        # symmetrized weighted-average third-order scheme (deg 2):
        # verified against fnft__akns_fscatter.c:331-361
        terms = [
            (2.0 / 3.0, [("E", 1.0), ("Z", 2.0), ("E", 1.0)]),
            (2.0 / 3.0, [("Z", 1.0), ("E", 2.0), ("Z", 1.0)]),
            (-1.0 / 6.0, [("E", 2.0), ("Z", 2.0)]),
            (-1.0 / 6.0, [("Z", 2.0), ("E", 2.0)]),
        ]
    else:
        name = d.value
        variant = "A" if name.endswith("a") else "B"
        order = int(name[6]) if name.startswith("2split") else 4
        if order % 2 == 0:
            K = order // 2
            gammas = _gamma_even(K)
            terms = [(g, _strang_power(deg, m, variant))
                     for m, g in zip(range(1, K + 1), gammas)]
        else:
            K = (order + 1) // 2
            gammas = _gamma_odd(K)
            terms = [(g, _lie_composition(deg, m, variant))
                     for m, g in zip(range(1, K + 1), gammas)]
    for _, fs in terms:
        _check_integer_z(fs)
        z_total = sum(a for kind, a in fs if kind == "Z")
        e_total = sum(a for kind, a in fs if kind == "E")
        assert abs(z_total - deg) < 1e-9, (d, z_total, deg)
        assert abs(e_total - deg) < 1e-9, (d, e_total, deg)
    return tuple((c, tuple(fs)) for c, fs in terms)
