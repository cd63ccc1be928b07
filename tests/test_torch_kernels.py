"""K1 (fused tree levels) and K2 (Aberth repulsion) of the PyTorch port.

On the CPU the wrappers run their plain versions, which are held here
against the JAX package's references on the same numpy inputs: K1 against
rounds of ``_matpoly_product`` / ``_tree_level_2x2``, K2 against
``_repulsion_chunked`` (Pallas switch off) and a brute-force oracle
(tests/test_torch_cuda.py holds the CUDA kernels against the plain
versions on the card). Tolerances: the same algorithm in the same
precision, differing only in summation order.
"""

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fnft_tpu.ops.poly as jpoly
import fnft_tpu.ops.roots as jroots
from fnft_tpu_torch.ops import kernels, poly, roots

torch.set_num_threads(1)


def _cplx(rng, shape, dtype=np.complex128):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(dtype)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


# ---------------------------------------------------------------------------
# K1 plain version vs JAX
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnums=1)
def _jax_levels(x, levels):
    """``levels`` rounds of the JAX package's direct-convolution level."""
    for _ in range(levels):
        x = jpoly._matpoly_product(x[..., 1::2, :, :, :], x[..., 0::2, :, :, :])
    return x


@pytest.mark.parametrize("n,c,levels,dtype,tol", [
    (1024, 3, 2, np.complex128, 1e-13),
    (1024, 2, 3, np.complex128, 1e-13),
    (1024, 3, 2, np.complex64, 5e-6),
    (1024, 3, 3, np.complex128, 1e-13),
    (1024, 4, 3, np.complex128, 1e-13),
    (1024, 3, 3, np.complex64, 5e-6),
    (1024, 4, 3, np.complex64, 5e-6),
])
def test_fused_levels_plain_matches_jax(n, c, levels, dtype, tol):
    rng = np.random.default_rng(n + c)
    p = _cplx(rng, (n, 2, 2, c), dtype)
    got, w = kernels.fused_tree_levels(torch.as_tensor(p), levels)
    x = _jax_levels(jnp.asarray(p), levels)
    assert got.dtype == torch.as_tensor(p).dtype
    assert tuple(got.shape) == x.shape and torch.all(w == 0)
    assert _rel(got.numpy(), x) < tol


def _check_batched_and_normalized(b, n, c, levels, seed):
    rng = np.random.default_rng(seed)
    p = torch.as_tensor(_cplx(rng, (b, n, 2, 2, c)))
    got, w = kernels.fused_tree_levels(p, levels, normalize=True)
    raw, _ = kernels.fused_tree_levels(p, levels)
    assert tuple(got.shape[:2]) == (b, n >> levels)
    assert tuple(w.shape) == (b, n >> levels) and w.dtype == torch.int32
    restored = got.numpy() * np.exp2(w.numpy())[..., None, None, None]
    assert np.array_equal(restored, raw.numpy())   # power-of-two scaling is exact
    mx = np.max(np.abs(np.stack([got.numpy().real, got.numpy().imag])),
                axis=(0, -3, -2, -1))
    assert np.all((mx >= 1.0) & (mx < 2.0))
    raw_mx = np.max(np.abs(np.stack([raw.numpy().real, raw.numpy().imag])),
                    axis=(0, -3, -2, -1))
    assert np.array_equal(w.numpy(), np.floor(np.log2(raw_mx)).astype(np.int32))


def test_fused_levels_plain_batched_and_normalized():
    """stored * 2**w reproduces the unnormalized product; max(|re|,|im|) of
    each subtree lies in [1, 2); the exponent equals the JAX rule
    floor(log2(max)) on this seed."""
    _check_batched_and_normalized(3, 512, 2, 2, seed=3)


@pytest.mark.parametrize("c", [3, 4])
def test_fused_levels_plain_three_levels_normalized(c):
    """The same at three levels, K1's count for c = 3 and 4 (one rescale of
    each subtree of 8 matrices)."""
    _check_batched_and_normalized(2, 1024, c, 3, seed=c)


def test_pow2_exact_and_scaling_exact():
    e = torch.arange(-1022, 1024, dtype=torch.int32)
    assert torch.equal(poly._pow2(e, torch.float64),
                       torch.tensor(2.0, dtype=torch.float64) ** e.double())
    e32 = torch.arange(-126, 128, dtype=torch.int32)
    assert torch.equal(poly._pow2(e32, torch.float32),
                       torch.tensor(2.0, dtype=torch.float64).pow(e32.double()).float())
    rng = np.random.default_rng(0)
    z = torch.as_tensor(_cplx(rng, 1000))
    s = poly._pow2(torch.full((1000,), -7, dtype=torch.int32), torch.float64)
    assert np.array_equal((z * s).numpy(), z.numpy() / 128.0)
    # exact floor(log2) even where log2 rounds up to the next integer
    mx = torch.tensor([1.0, 2.0 - 2.0 ** -52, 2.0, 0.75, 0.0, 2.0 ** -997],
                      dtype=torch.float64)
    assert poly._floor_log2(mx).tolist() == [0, 0, 1, -1, 0, -997]


def test_kernel_wrappers_route_by_device():
    p = torch.zeros((512, 2, 2, 3), dtype=torch.complex128, device="meta")
    with pytest.raises(ValueError, match="device"):
        kernels.fused_tree_levels(p, 2)
    g = torch.zeros((128, 2, 2, 9), dtype=torch.complex128, device="meta")
    with pytest.raises(ValueError, match="device"):
        kernels.fused_tree_levels_vjp(p, None, g, 2)
    z = torch.zeros(8, dtype=torch.complex128, device="meta")
    with pytest.raises(ValueError, match="device"):
        kernels.repulsion_sum(z, z, torch.zeros(8, dtype=torch.int32,
                                                device="meta"))
    kernels.reset_launches()
    ones = torch.ones((8, 2, 2, 3), dtype=torch.complex128)
    kernels.fused_tree_levels(ones, 2)
    kernels.fused_tree_levels(ones, 3)
    kernels.fused_tree_levels_vjp(ones, None, torch.ones((2, 2, 2, 9),
                                                         dtype=ones.dtype), 2)
    assert kernels.LAUNCHES == {"fused_tree_levels": 0,
                                "fused_tree_levels_l3": 0,
                                "fused_tree_levels_bwd": 0,
                                "repulsion_sum": 0}


# ---------------------------------------------------------------------------
# K2 plain version vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deg,m", [(700, 700), (1500, 300), (300, 40)])
def test_repulsion_plain_matches_jax(deg, m):
    rng = np.random.default_rng(deg + m)
    z_all = _cplx(rng, deg)
    idx = np.sort(rng.choice(deg, size=m, replace=False)).astype(np.int32)
    z_t = z_all[idx]
    for lowprec, tol in ((False, 1e-12), (True, 1e-5)):
        got = kernels.repulsion_sum(torch.as_tensor(z_all),
                                    torch.as_tensor(z_t),
                                    torch.as_tensor(idx), lowprec=lowprec)
        ref = jroots._repulsion_chunked(jnp.asarray(z_all), jnp.asarray(z_t),
                                        jnp.asarray(idx), lowprec=lowprec)
        assert got.dtype == torch.complex128
        assert _rel(got.numpy(), ref) < tol, lowprec


def test_repulsion_plain_complex64_matches_jax():
    rng = np.random.default_rng(5)
    deg = 900
    z_all = _cplx(rng, deg, np.complex64)
    idx = np.arange(deg, dtype=np.int32)
    got = kernels.repulsion_sum(torch.as_tensor(z_all), torch.as_tensor(z_all),
                                torch.as_tensor(idx))
    ref = jroots._repulsion_chunked(jnp.asarray(z_all), jnp.asarray(z_all),
                                    jnp.asarray(idx))
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), ref) < 1e-5


def test_repulsion_plain_brute_force_oracle():
    rng = np.random.default_rng(9)
    deg, m = 97, 23  # deliberately not multiples of the tile sizes
    z_all = _cplx(rng, deg)
    idx = rng.choice(deg, size=m, replace=False).astype(np.int32)
    z_t = z_all[idx]
    ref = np.array([np.sum(1.0 / (z_t[i] - np.delete(z_all, idx[i])))
                    for i in range(m)])
    got = kernels.repulsion_sum(torch.as_tensor(z_all), torch.as_tensor(z_t),
                                torch.as_tensor(idx), lowprec=False)
    assert _rel(got.numpy(), ref) < 1e-12


def test_aberth_forced_through_chunked_repulsion(monkeypatch):
    """With the dense threshold lowered, every sweep takes the K2 path
    (low-precision repulsion); the roots still agree with the true roots
    and with the JAX package's dense run."""
    rng = np.random.default_rng(13)
    true = _cplx(rng, 24)
    coeffs = np.poly(true)[::-1].copy()  # ascending
    monkeypatch.setattr(roots, "DENSE_REPULSION_MAX", 0)
    calls = []
    orig = roots._repulsion_chunked
    monkeypatch.setattr(roots, "_repulsion_chunked",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    got = roots.poly_roots(torch.as_tensor(coeffs)).numpy()
    assert calls
    ref = np.asarray(jroots.poly_roots(jnp.asarray(coeffs)))
    for other in (true, ref):
        dist = np.abs(got[:, None] - other[None, :])
        assert np.max(np.min(dist, axis=1)) < 1e-8
        assert np.max(np.min(dist, axis=0)) < 1e-8
