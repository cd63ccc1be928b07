"""Tree, chirp-Z, transfer matrices and metadata of the PyTorch port,
held against the JAX package on the same numpy inputs (complex128, CPU).

Tolerances: same algorithm and precision, differing only in FFT library
and reduction order; the tree's growth amplifies that difference
(see tests/test_pallas_kernels.py:62).
"""

from functools import partial

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fnft_tpu.models.discretization as jdisc
import fnft_tpu.ops.fscatter as jfs
import fnft_tpu.ops.poly as jpoly
import fnft_tpu.utils.misc as jmisc
import fnft_tpu_torch.models.discretization as tdisc
from fnft_tpu_torch.ops import fscatter as tfs
from fnft_tpu_torch.ops import poly as tpoly
from fnft_tpu_torch.utils import misc as tmisc

torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _sech_step_matrices(d):
    """2SPLIT4B transfer matrices of the Satsuma-Yajima sech on D samples."""
    t = np.linspace(-25.0, 25.0, d)
    q = 3.2j / np.cosh(t)
    return q, -np.conj(q), 50.0 / (d - 1)


def test_discretization_tables_equal():
    for jd in jdisc.Discretization:
        td = tdisc.Discretization(jd.value)
        assert tdisc.is_fast(td) == jdisc.is_fast(jd)
        assert tdisc.degree(td) == jdisc.degree(jd)
        assert tdisc.upsampling_factor(td) == jdisc.upsampling_factor(jd)
        assert tdisc.method_order(td) == jdisc.method_order(jd)
        assert tdisc.degree1step_total(td) == jdisc.degree1step_total(jd)
        np.testing.assert_array_equal(tdisc.method_weights(td),
                                      jdisc.method_weights(jd))
        np.testing.assert_array_equal(tdisc.lambda_stage_weights(td),
                                      jdisc.lambda_stage_weights(jd))
        assert tdisc.cf_stages_nodes(td) == jdisc.cf_stages_nodes(jd)
        if jdisc.is_fast(jd) and jd is not jdisc.Discretization.SPLIT2_MODAL:
            assert tdisc.splitting_spec(td) == jdisc.splitting_spec(jd)
    assert tdisc.BOUNDARY_COEFF == jdisc.BOUNDARY_COEFF
    lam = np.array([0.3 + 0.7j, -1.1 + 2.0j])
    z = tdisc.lambda_to_z(torch.as_tensor(lam), 0.01, tdisc.Discretization.SPLIT4B)
    np.testing.assert_allclose(z.numpy(), np.asarray(jdisc.lambda_to_z(
        jnp.asarray(lam), 0.01, jdisc.Discretization.SPLIT4B)), rtol=1e-15)
    back = tdisc.z_to_lambda(z, 0.01, tdisc.Discretization.SPLIT4B)
    np.testing.assert_allclose(back.numpy(), lam, rtol=1e-12)


def test_misc_helpers_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=50) + 1j * rng.normal(size=50)
    x[:3] = [0.0, 1e-9, -3e-9j]
    np.testing.assert_allclose(tmisc.csinc(torch.as_tensor(x)).numpy(),
                               np.asarray(jmisc.csinc(jnp.asarray(x))),
                               rtol=1e-15)
    assert float(tmisc.l2norm2(torch.as_tensor(x), -2.0, 3.0)) == \
        pytest.approx(float(jmisc.l2norm2(jnp.asarray(x), -2.0, 3.0)),
                      rel=1e-14)
    for n in (1, 7, 97, 1000, 4097):
        assert tmisc.next_fft_length(n) == jmisc._next_fast_size(n)
        assert tmisc.next_power_of_2(n) == jmisc.next_power_of_2(n)
        assert tmisc.downsample_indices(4096, n) == \
            jmisc.downsample_indices(4096, n)
    vals = np.array([0.1 + 1j, 0.1 + 1j + 1e-9, 5 + 1j, -0.3 + 0.2j,
                     np.nan + 0j, 0.2 - 0.1j])
    box = (-1.0, 1.0, 0.0, 2.0)
    for k in (6, 3000):  # dense and column-chunked merge
        v = np.resize(vals, k)
        tm = tmisc.filter_mask(torch.as_tensor(v), box)
        jm = jmisc.filter_mask(jnp.asarray(v), box)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(
            tmisc.merge_mask(torch.as_tensor(v), 1e-6, tm).numpy(),
            np.asarray(jmisc.merge_mask(jnp.asarray(v), 1e-6, jm)))


def test_split4b_transfer_matrices_match_jax():
    q, r, eps_t = _sech_step_matrices(777)
    got = tfs.transfer_matrix_coeffs(torch.as_tensor(q), torch.as_tensor(r),
                                     eps_t, tdisc.Discretization.SPLIT4B)
    ref = jfs.transfer_matrix_coeffs(jnp.asarray(q), jnp.asarray(r), eps_t,
                                     jdisc.Discretization.SPLIT4B)
    assert tuple(got.shape) == ref.shape == (777, 2, 2, 3)
    assert _rel(got.numpy(), ref) <= 1e-14
    e_t = tfs._zero_freq_matrix(torch.as_tensor(q), torch.as_tensor(r), 0.1)
    e_j = jfs._zero_freq_matrix(jnp.asarray(q), jnp.asarray(r), 0.1)
    assert _rel(e_t.numpy(), e_j) <= 1e-14


@pytest.mark.parametrize("n,want", [(1024, None), (1024, ((0, 0), (1, 0))),
                                    (768, ((0, 0), (1, 0))),
                                    (1023, ((0, 0), (1, 0)))])
def test_fmult2x2_tree_matches_jax(n, want, monkeypatch):
    """n = 1024 takes the J-symmetric value tree, 768 and 1023 the generic
    one after identity padding; all three hand two levels to K1."""
    q, r, eps_t = _sech_step_matrices(n)
    p = np.array(jfs.transfer_matrix_coeffs(
        jnp.asarray(q), jnp.asarray(r), eps_t, jdisc.Discretization.SPLIT4B))
    calls = []
    orig = tpoly.fused_tree_levels
    monkeypatch.setattr(tpoly, "fused_tree_levels",
                        lambda p_, lv, **k: calls.append(lv) or orig(p_, lv, **k))
    got, w = tpoly.fmult2x2_tree(torch.as_tensor(p), want=want, jsym=+1)
    assert calls == [2]
    # the JAX package's jitted fscatter: same matrices, same tree
    ref, w_ref = jfs.fscatter(jnp.asarray(q), jnp.asarray(r), eps_t,
                              jdisc.Discretization.SPLIT4B, want=want, jsym=+1)
    assert int(w) == int(w_ref)
    assert tuple(got.shape) == ref.shape == (2, 2, 2 * n + 1)
    assert _rel(got.numpy(), ref) <= 1e-8
    if want is not None:
        assert torch.all(got[0, 1] == 0) and torch.all(got[1, 1] == 0)


def test_fmult2x2_tree_small_and_unnormalized_match_jax():
    """Shapes below K1's threshold (direct levels only, and the generic
    value tree without normalization) on random matrices."""
    rng = np.random.default_rng(5)
    for n, deg, normalize in ((6, 2, True), (200, 2, False), (64, 3, True)):
        p = 0.5 * (rng.normal(size=(n, 2, 2, deg + 1))
                   + 1j * rng.normal(size=(n, 2, 2, deg + 1)))
        got, w = tpoly.fmult2x2_tree(torch.as_tensor(p), normalize=normalize)
        ref, w_ref = jax.jit(partial(jpoly.fmult2x2_tree,
                                     normalize=normalize))(jnp.asarray(p))
        assert int(w) == int(w_ref)
        assert _rel(got.numpy(), ref) <= 1e-10


@pytest.mark.parametrize("n,m", [(2049, 16), (300, 64)])
def test_chirpz_matches_jax(n, m):
    rng = np.random.default_rng(n)
    c = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    a = np.exp(-0.7j)
    w = np.exp(0.013j)
    got = tpoly.chirpz(torch.as_tensor(c), complex(a), complex(w), m)
    ref = jpoly.chirpz(jnp.asarray(c), complex(a), complex(w), m)
    assert tuple(got.shape) == ref.shape == (2, m)
    assert _rel(got.numpy(), ref) <= 1e-12
