"""The port's D-sharded inverse scattering
(``fnft_tpu_torch.parallel.dshard_inverse``) in a gloo world of 4 CPU
ranks, and the full-matrix layer-peel recursion it calls
(``ops/finvscatter.py``: ``_base_case``, ``_peel_scan``, ``_recurse``,
``_t1_stage``, ``_merge_stage``, ``_recurse_staged``).

The twin of ``tests/test_dshard_inverse.py``. One world (module fixture)
runs every sharded case. Tolerances are the JAX tests': the four-step FFT
exact against ``np.fft`` to 1e-12 of the largest bin; the sharded 2x2
polynomial product against the local one (both packages') to 1e-12 of the
largest coefficient; the sharded peel against the local drivers to 1e-11
of the largest sample (the transpose algorithm reassociates the
butterflies), and recovering the samples as well as the local driver. The
full-matrix recursion against the JAX package's on the same block (the
samples and the block inverse, 1e-12 of the largest) and against the
port's column-carry ``finvscatter`` (1e-11).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fnft_tpu.models.discretization import Discretization as JD
from fnft_tpu.ops import finvscatter as jfi
from fnft_tpu_torch.models.discretization import Discretization as TD
from fnft_tpu_torch.ops import finvscatter as tfi
from fnft_tpu_torch.ops.fscatter import fscatter
from fnft_tpu_torch.parallel.mesh import spawn

import torch_dshard_worlds as w

torch.set_num_threads(1)

REC_DEG = 64   # a block of the full-matrix recursion: two peels and a merge


@pytest.fixture(scope="module")
def case():
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, w.inverse_world, w.WORLD)
        ref = {}
        for (ca, cb), (a, b) in w.polymatmul_inputs().items():
            ref[(ca, cb)] = np.asarray(jfi._polymatmul(jnp.asarray(a),
                                                       jnp.asarray(b)))
        _, eps_t = w.inverse_signal()
        for kappa in (+1, -1):
            tm = w.inverse_transfer_matrix(kappa).numpy()
            ref[kappa] = np.asarray(jfi.finvscatter(
                jnp.asarray(tm), eps_t, kappa, JD.SPLIT2A))
        for kappa in (+1, -1):
            blk = _block(kappa).numpy()
            ref["rec", kappa] = [np.asarray(x) for x in jax.jit(
                jfi._recurse, static_argnums=(1, 2, 3, 4, 5))(
                    jnp.asarray(blk), REC_DEG, float(eps_t), kappa,
                    JD.SPLIT2A, True)]
        return world.result(), ref


def _block(kappa):
    """The transfer matrix of the first REC_DEG samples of the inverse
    signal."""
    q, eps_t = w.inverse_signal()
    qt = torch.as_tensor(q[:REC_DEG])
    return fscatter(qt, -kappa * torch.conj(qt), eps_t, TD.SPLIT2A,
                    normalize=False)[0]


def _rel(got, ref) -> float:
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("length", w.FFT_LENGTHS)
def test_sharded_fft_exact(case, length):
    x = w.fft_inputs()[length]
    for r in case[0]:
        assert _rel(r[f"fft_{length}"], np.fft.fft(x)) < 1e-12


def test_sharded_fft_batched(case):
    x = w.fft_inputs()["batched"]
    for r in case[0]:
        assert _rel(r["fft_batched"], np.fft.fft(x, axis=-1)) < 1e-12


@pytest.mark.parametrize("ca,cb", w.MM_SHAPES)
def test_sharded_polymatmul_matches_local(case, ca, cb):
    world, ref = case
    a, b = w.polymatmul_inputs()[(ca, cb)]
    mine = tfi._polymatmul(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    for r in world:
        got = r[f"mm_{ca}_{cb}"]
        assert _rel(got, mine) < 1e-12
        assert _rel(got, ref[(ca, cb)]) < 1e-12


@pytest.mark.parametrize("kappa", [+1, -1])
def test_dshard_finvscatter_matches_local(case, kappa):
    world, ref = case
    q, eps_t = w.inverse_signal()
    mine = tfi.finvscatter(w.inverse_transfer_matrix(kappa), eps_t, kappa,
                           TD.SPLIT2A).numpy()
    scale = np.max(np.abs(ref[kappa]))
    for r in world:
        got = r[f"finv_{kappa}"]
        assert np.max(np.abs(got - ref[kappa])) < 1e-11 * scale
        assert np.max(np.abs(got - mine)) < 1e-11 * scale
        # the samples come back as well as with the local driver (exact to
        # rounding when focusing; ~1e-4 for a defocusing random q, a
        # property of the 2SPLIT2A base case in both)
        err_local = np.max(np.abs(ref[kappa] - q))
        assert np.max(np.abs(got - q)) < err_local + 1e-11 * np.max(np.abs(q))


@pytest.mark.parametrize("kappa", [+1, -1])
def test_full_matrix_recursion_matches_jax(case, kappa):
    """``_recurse`` on one block: the samples and the block inverse (two
    peels of 32 samples, the T1 window and the merge product)."""
    _, ref = case
    _, eps_t = w.inverse_signal()
    q, ti = tfi._recurse(_block(kappa), REC_DEG, eps_t, kappa, TD.SPLIT2A,
                         True)
    assert _rel(q.numpy(), ref["rec", kappa][0]) < 1e-12
    assert _rel(ti.numpy(), ref["rec", kappa][1]) < 1e-12


def test_staged_full_matrix_recursion_matches_column_carry():
    """``_recurse_staged`` (full matrices, leaves of degree 1024) gives the
    column-carry ``finvscatter``'s samples at D = 2048."""
    q, eps_t = w.inverse_signal()
    qt = torch.as_tensor(q[:2048])
    tm, _ = fscatter(qt, -torch.conj(qt), eps_t, TD.SPLIT2A, normalize=False)
    out = []
    tfi._recurse_staged(tm, 2048, eps_t, +1, TD.SPLIT2A, False, out, 0)
    got = torch.cat([blk for _, blk in sorted(out, key=lambda kv: kv[0])])
    want = tfi.finvscatter(tm, eps_t, +1, TD.SPLIT2A)
    assert [off for off, _ in sorted(out, key=lambda kv: kv[0])] == [0, 1024]
    assert _rel(got.numpy(), want.numpy()) < 1e-11
    assert _rel(got.numpy(), q[:2048]) < 1e-11
