"""Fast-scheme building blocks of the PyTorch port against the JAX package:
per-sample transfer matrices of all 21 fast schemes, the tree with real
coefficients, scalar products and Horner evaluation. Same numpy inputs to
both (complex128, CPU).

On the CPU the JAX package builds the generic schemes by its symbolic
fold, the port by values at the roots of unity plus one inverse FFT, so
port-vs-JAX compares two constructions; the port's own symbolic fold is
the third. Their difference grows with the degree (an n-point FFT of
chains of up to ~2 deg factors): 1e-14 up to degree 4, 1e-13 up to
degree 24, 1e-11 at degree 105 (a 128-point FFT).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fnft_tpu.models.discretization as jdisc
import fnft_tpu.ops.fscatter as jfs
import fnft_tpu.ops.poly as jpoly
import fnft_tpu_torch.models.discretization as tdisc
from fnft_tpu_torch.ops import fscatter as tfs
from fnft_tpu_torch.ops import poly as tpoly

torch.set_num_threads(1)

FAST = [d for d in tdisc.Discretization if tdisc.is_fast(d)]


def _rel(got, ref):
    got, ref = (x.resolve_conj().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x) for x in (got, ref))
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _jd(disc):
    return jdisc.Discretization(disc.value)


def _potential(d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=d) + 1j * rng.normal(size=d)
    return q, -np.conj(q)


def _coeff_tol(disc):
    deg = tdisc.degree(disc)
    return 1e-14 if deg <= 4 else 1e-13 if deg <= 24 else 1e-11


@pytest.mark.parametrize("disc", FAST, ids=lambda d: d.value)
def test_transfer_matrix_coeffs_match_jax_and_symbolic(disc):
    q, r = _potential(32)
    eps_t = 0.05
    got = tfs.transfer_matrix_coeffs(torch.as_tensor(q), torch.as_tensor(r),
                                     eps_t, disc)
    ref = jfs.transfer_matrix_coeffs(jnp.asarray(q), jnp.asarray(r), eps_t,
                                     _jd(disc))
    assert tuple(got.shape) == ref.shape == (32, 2, 2, tdisc.degree(disc) + 1)
    assert _rel(got, ref) <= _coeff_tol(disc)
    if disc is not tdisc.Discretization.SPLIT2_MODAL:   # has no spec
        sym = tfs._coeffs_symbolic(torch.as_tensor(q), torch.as_tensor(r),
                                   eps_t, disc)
        assert _rel(got, sym) <= _coeff_tol(disc)


@pytest.mark.parametrize("disc", [tdisc.Discretization.SPLIT3A,
                                  tdisc.Discretization.SPLIT6B,
                                  tdisc.Discretization.SPLIT8B],
                         ids=lambda d: d.value)
def test_value_route_takes_the_half_grid_for_real_potentials(disc):
    """``real_coeffs`` (irfft of the Hermitian half grid) gives the full
    grid's coefficients, real to rounding (1e-13: degree <= 12)."""
    u = np.random.default_rng(3).normal(size=24)
    ut, rt = torch.as_tensor(u + 0j), -torch.ones(24, dtype=torch.complex128)
    full = tfs._coeffs_via_values(ut, rt, 0.07, disc)
    half = tfs._coeffs_via_values(ut, rt, 0.07, disc, real_coeffs=True)
    assert half.dtype == torch.complex128 and torch.all(half.imag == 0)
    assert _rel(half, full) <= 1e-13


def test_slow_scheme_has_no_transfer_polynomial():
    q, r = _potential(8)
    with pytest.raises(ValueError, match="not a fast"):
        tfs.transfer_matrix_coeffs(torch.as_tensor(q), torch.as_tensor(r),
                                   0.1, tdisc.Discretization.CF4_2)


@pytest.mark.parametrize("disc,d,jsym,rsym", [
    (tdisc.Discretization.SPLIT2A, 64, +1, False),
    (tdisc.Discretization.SPLIT3A, 48, -1, False),   # identity padding
    (tdisc.Discretization.SPLIT8B, 32, None, False),
    (tdisc.Discretization.SPLIT4B, 64, None, True),  # real value tree
    (tdisc.Discretization.SPLIT8B, 32, None, True),
    (tdisc.Discretization.SPLIT2A, 64, None, True),  # odd degree: generic
], ids=lambda v: str(getattr(v, "value", v)))
def test_fscatter_matches_jax(disc, d, jsym, rsym):
    """Tolerance 1e-10: equal algorithms, another FFT library, and a tree
    whose growth amplifies the difference (as in test_torch_poly.py)."""
    rng = np.random.default_rng(d)
    if rsym:
        q = rng.normal(size=d) + 0j
        r = -np.ones(d) + 0j
    else:
        q = 0.7 * (rng.normal(size=d) + 1j * rng.normal(size=d))
        r = -(jsym or 1) * np.conj(q)
    got, w = tfs.fscatter(torch.as_tensor(q), torch.as_tensor(r), 0.05, disc,
                          jsym=jsym, rsym=rsym)
    ref, w_ref = jfs.fscatter(jnp.asarray(q), jnp.asarray(r), 0.05, _jd(disc),
                              jsym=jsym, rsym=rsym)
    assert tuple(got.shape) == ref.shape
    assert got.dtype == torch.complex128
    assert int(w) == int(w_ref)
    assert _rel(got, ref) <= 1e-10
    if rsym:
        plain, w_plain = tfs.fscatter(torch.as_tensor(q), torch.as_tensor(r),
                                      0.05, disc)
        assert _rel(got * 2.0 ** int(w), plain * 2.0 ** int(w_plain)) <= 1e-10


def test_rsym_skips_the_fused_kernel_and_wins_over_jsym(monkeypatch):
    """n = 1024 degree-1 matrices would go to K1; ``rsym`` keeps them out
    (real arithmetic) and takes precedence over ``jsym``."""
    calls = []
    monkeypatch.setattr(tpoly, "fused_tree_levels",
                        lambda *a, **k: calls.append(1))
    u = np.random.default_rng(1).normal(size=1024) * 0.3
    ut = torch.as_tensor(u + 0j)
    got, w = tfs.fscatter(ut, -torch.ones_like(ut), 0.01,
                          tdisc.Discretization.SPLIT2B, rsym=True, jsym=+1)
    assert calls == []
    monkeypatch.undo()
    ref, w_ref = tfs.fscatter(ut, -torch.ones_like(ut), 0.01,
                              tdisc.Discretization.SPLIT2B)
    assert _rel(got * 2.0 ** int(w), ref * 2.0 ** int(w_ref)) <= 1e-9


@pytest.mark.parametrize("n,deg,normalize", [(4, 3, True), (3, 2, False)])
def test_fmult_matches_jax(n, deg, normalize):
    rng = np.random.default_rng(n)
    p = rng.normal(size=(2, n, deg + 1)) + 1j * rng.normal(size=(2, n, deg + 1))
    got, w = tpoly.fmult(torch.as_tensor(p), normalize=normalize)
    assert tuple(got.shape) == (2, n * deg + 1)
    if normalize:   # the JAX package compiles each level: one case of it
        ref, w_ref = jpoly.fmult(jnp.asarray(p), normalize=normalize)
        np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))
        assert _rel(got, ref) <= 1e-12
    else:
        assert torch.all(w == 0)
    # against numpy's own product of the first batch row
    full = np.array([1.0 + 0j])
    for row in p[0]:
        full = np.convolve(full, row)
    assert _rel(got[0] * 2.0 ** int(w[0]), full) <= 1e-12


def test_fmult2x2_is_the_tree():
    rng = np.random.default_rng(2)
    p = torch.as_tensor(rng.normal(size=(6, 2, 2, 3))
                        + 1j * rng.normal(size=(6, 2, 2, 3)))
    a, wa = tpoly.fmult2x2(p)
    b, wb = tpoly.fmult2x2_tree(p, normalize=True)
    assert torch.equal(a, b) and torch.equal(wa, wb)


def test_poly_eval_and_derivative_match_jax():
    rng = np.random.default_rng(4)
    c = rng.normal(size=40) + 1j * rng.normal(size=40)
    z = np.concatenate([0.9 * np.exp(2j * np.pi * rng.random(5)),
                        1.3 * np.exp(2j * np.pi * rng.random(5)), [0.0]])
    p, dp = tpoly.poly_evalderiv(torch.as_tensor(c), torch.as_tensor(z))
    p_ref, dp_ref = jpoly.poly_evalderiv(jnp.asarray(c), jnp.asarray(z))
    assert _rel(p, p_ref) <= 1e-13 and _rel(dp, dp_ref) <= 1e-13
    assert _rel(tpoly.poly_eval(torch.as_tensor(c), torch.as_tensor(z)),
                np.polyval(c[::-1], z)) <= 1e-12
    assert tpoly.poly_evalderiv(torch.as_tensor(c), torch.as_tensor(z),
                                with_derivative=False)[1] is None
