"""Rootfinding of the PyTorch port against the JAX package: deflated
Ehrlich-Aberth against the undeflated sweeps, backward-error certificates,
the degree switch of ``poly_roots`` and batched polynomials. Same numpy
inputs to both (complex128, CPU, where K2 runs as its plain version).

Roots are compared as sets: 1e-10 (each is converged to ~100 eps relative;
random-coefficient polynomials of degree 600 are conditioned well enough).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fnft_tpu.ops.roots as jroots
from fnft_tpu_torch.ops import kernels
from fnft_tpu_torch.ops import roots as troots

torch.set_num_threads(1)


def _set_dist(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    d = np.abs(a[:, None] - b[None, :])
    return max(d.min(axis=1).max(), d.min(axis=0).max())


@pytest.fixture(scope="module")
def poly600():
    rng = np.random.default_rng(0)
    c = rng.normal(size=601) + 1j * rng.normal(size=601)
    ct = torch.as_tensor(c)
    z0 = troots._initial_guesses(ct)
    return c, ct, z0, troots.aberth_roots(ct, z0)


def _spy_k2(monkeypatch):
    shapes = []
    orig = kernels.repulsion_sum_plain
    monkeypatch.setattr(
        kernels, "repulsion_sum_plain",
        lambda z_all, z_t, idx, **k: shapes.append(
            (z_all.shape[0], z_t.shape[0])) or orig(z_all, z_t, idx, **k))
    return shapes


def test_deflated_matches_undeflated_and_jax(poly600, monkeypatch):
    """With ``min_cap`` lowered the active set shrinks in stages; the
    roots equal the undeflated ones and the JAX package's as sets, in the
    JAX package's number of sweeps (its deflated sweeps always take the
    low-precision repulsion, so ``DENSE_REPULSION_MAX`` is patched down
    for the port to take it too)."""
    c, ct, z0, plain = poly600
    monkeypatch.setattr(troots, "DENSE_REPULSION_MAX", 100)
    got, sweeps = troots.aberth_roots_deflated(ct, z0, min_cap=16,
                                               return_iters=True)
    assert _set_dist(got, plain) <= 1e-10
    ref, sweeps_ref = jroots.aberth_roots_deflated(
        jnp.asarray(c), jnp.asarray(z0.numpy()), min_cap=16,
        return_iters=True)
    assert sweeps == int(sweeps_ref)
    assert _set_dist(got, ref) <= 1e-10
    assert z0.data_ptr() != got.data_ptr()      # the guesses are not reused


def test_deflated_runs_k2_on_the_active_set(poly600, monkeypatch):
    """Above ``DENSE_REPULSION_MAX`` (patched down) every sweep's repulsion
    goes to K2, at [deg, deg] in the full sweeps and [deg, m] with m < deg
    once only the unfrozen roots iterate."""
    _, ct, z0, plain = poly600
    monkeypatch.setattr(troots, "DENSE_REPULSION_MAX", 100)
    shapes = _spy_k2(monkeypatch)
    got = troots.aberth_roots_deflated(ct, z0, min_cap=16)
    assert _set_dist(got, plain) <= 1e-10
    assert (600, 600) in shapes
    active = sorted({m for deg, m in shapes if m < deg})
    assert all(deg == 600 for deg, _ in shapes)
    assert len(active) >= 2 and active[0] < 64


def test_deflated_with_default_cap_falls_back_to_full_sweeps(poly600,
                                                             monkeypatch):
    """256 <= tail < deg = 600 rounds up to cap = 1024 >= deg: the stage
    stays with full sweeps (the JAX package's rule), never an active set
    between 257 and 599 roots."""
    _, ct, z0, plain = poly600
    monkeypatch.setattr(troots, "DENSE_REPULSION_MAX", 100)
    shapes = _spy_k2(monkeypatch)
    got = troots.aberth_roots_deflated(ct, z0)
    assert _set_dist(got, plain) <= 1e-10
    assert not [m for _, m in shapes if 256 < m < 600]


def test_undeflated_takes_k2_above_dense_max(poly600, monkeypatch):
    _, ct, z0, plain = poly600
    monkeypatch.setattr(troots, "DENSE_REPULSION_MAX", 100)
    shapes = _spy_k2(monkeypatch)
    got = troots.aberth_roots(ct, z0)
    assert set(shapes) == {(600, 600)}
    assert _set_dist(got, plain) <= 1e-10


def test_stagnation_kick_in_deflated_route(poly600):
    """A budget too small to converge leaves roots moving; the kick and its
    extra sweeps still bring every root home."""
    _, ct, z0, plain = poly600
    got, sweeps = troots.aberth_roots_deflated(ct, z0, num_iters=9,
                                               min_cap=16, return_iters=True)
    assert sweeps > 9
    assert _set_dist(got, plain) <= 1e-10


def test_root_residuals_match_jax_and_certify(poly600):
    c, ct, _, plain = poly600
    eta = troots.root_residuals(ct, plain)
    ref = jroots.root_residuals(jnp.asarray(c), jnp.asarray(plain.numpy()))
    assert eta.dtype == torch.float64 and eta.shape == plain.shape
    # eta is itself rounding noise of size ~1e-15 at a converged root
    np.testing.assert_allclose(eta.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-14)
    tol = troots.certified_tol(600)
    assert tol == jroots.certified_tol(600) == 64 * 600 * 2.0 ** -52
    assert float(eta.max()) <= tol
    # a point that is no root is not certified
    off = plain.clone()
    off[0] += 1e-3
    assert float(troots.root_residuals(ct, off)[0]) > tol
    assert troots.certified_tol(600, torch.complex64) == \
        pytest.approx(jroots.certified_tol(600, np.complex64))


def test_root_residuals_outside_the_disk_and_at_zero():
    """Roots far outside the unit disk (reversed polynomial) and an exact
    root at 0 with zero constant coefficient (0/0 guarded)."""
    roots = np.array([0.0, 0.5, 3.0 + 4.0j, -20.0, 1e3j])
    c = np.poly(roots)[::-1].astype(np.complex128)
    eta = troots.root_residuals(torch.as_tensor(c), torch.as_tensor(roots))
    ref = jroots.root_residuals(jnp.asarray(c), jnp.asarray(roots))
    assert torch.all(torch.isfinite(eta)) and float(eta.max()) <= 1e-12
    np.testing.assert_allclose(eta.numpy(), np.asarray(ref), atol=1e-15)


def test_poly_roots_returns_residuals_and_matches_jax():
    rng = np.random.default_rng(3)
    c = rng.normal(size=81) + 1j * rng.normal(size=81)
    roots, eta = troots.poly_roots(torch.as_tensor(c), return_residuals=True)
    assert roots.shape == eta.shape == (80,)
    assert float(eta.max()) <= troots.certified_tol(80)
    ref = jroots.poly_roots(jnp.asarray(c))
    assert _set_dist(roots, ref) <= 1e-10
    assert _set_dist(roots, np.roots(c[::-1])) <= 1e-9


def test_poly_roots_switches_to_deflation_above_max_degree(monkeypatch):
    assert troots.MAX_UNDEFLATED_DEG == 16384
    seen = []
    orig = troots.aberth_roots_deflated
    monkeypatch.setattr(
        troots, "aberth_roots_deflated",
        lambda c, z0, **k: seen.append(c.shape[-1] - 1) or orig(c, z0, **k))
    monkeypatch.setattr(troots, "MAX_UNDEFLATED_DEG", 100)
    rng = np.random.default_rng(5)
    for deg in (100, 101):
        c = rng.normal(size=deg + 1) + 1j * rng.normal(size=deg + 1)
        roots = troots.poly_roots(torch.as_tensor(c))
        assert _set_dist(roots, np.roots(c[::-1])) <= 1e-9
    assert seen == [101]


def test_poly_roots_batched_matches_jax_and_single():
    rng = np.random.default_rng(7)
    cb = rng.normal(size=(3, 41)) + 1j * rng.normal(size=(3, 41))
    got = troots.poly_roots_batched(torch.as_tensor(cb))
    ref = jroots.poly_roots_batched(jnp.asarray(cb))
    assert tuple(got.shape) == ref.shape == (3, 40)
    for i in range(3):
        single = troots.poly_roots(torch.as_tensor(cb[i]))
        assert torch.equal(got[i], single)
        assert _set_dist(got[i], ref[i]) <= 1e-10


@pytest.mark.parametrize("dtype,tol", [(torch.complex128, 1e-10),
                                       (torch.complex64, 1e-3)])
def test_deflated_keeps_the_input_precision(dtype, tol):
    rng = np.random.default_rng(9)
    c = (rng.normal(size=201) + 1j * rng.normal(size=201))
    ct = torch.as_tensor(c).to(dtype)
    z0 = troots._initial_guesses(ct).to(dtype)
    got = troots.aberth_roots_deflated(ct, z0, min_cap=8)
    assert got.dtype == dtype
    assert _set_dist(got.to(torch.complex128), np.roots(c[::-1])) <= tol
