"""Signal preprocessing of the PyTorch port against the JAX package:
band-limited resampling, the band-limit warning, the stage samples of every
discretization with resampling or derivative slots, and the error metrics.
Same numpy inputs to both (complex128, CPU).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fnft_tpu.models.discretization as jdisc
import fnft_tpu.models.nse as jnse
import fnft_tpu.utils.misc as jmisc
import fnft_tpu_torch.models.discretization as tdisc
from fnft_tpu_torch.models import nse as tnse
from fnft_tpu_torch.utils import misc as tmisc

torch.set_num_threads(1)

RESAMPLED = [d for d in tdisc.Discretization
             if tdisc.upsampling_factor(d) > 1]


def _rel(got, ref):
    got, ref = (x.resolve_conj().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x) for x in (got, ref))
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _jd(disc):
    return jdisc.Discretization(disc.value)


@pytest.mark.parametrize("delta", [0.37, [-0.11, 0.0, 0.25]],
                         ids=["scalar", "vector"])
def test_resample_matches_jax(delta):
    t = np.linspace(-6.0, 6.0, 96)
    q = np.exp(-t ** 2) * np.exp(1.5j * t)
    eps_t = 12.0 / 95
    got = tmisc.resample(torch.as_tensor(q), eps_t, delta)
    ref = jmisc.resample(jnp.asarray(q), eps_t, np.asarray(delta))
    assert tuple(got.shape) == ref.shape
    assert _rel(got, ref) <= 1e-14
    # a band-limited signal is moved, not distorted
    d0 = np.atleast_1d(delta)[0]
    moved = np.exp(-(t + d0) ** 2) * np.exp(1.5j * (t + d0))
    assert _rel(got.reshape(-1, 96)[0], moved) <= 1e-9


def test_bandlimit_violation_matches_jax_and_warns():
    rng = np.random.default_rng(6)
    smooth = np.exp(-np.linspace(-6, 6, 128) ** 2) + 0j
    rough = rng.normal(size=128) + 1j * rng.normal(size=128)
    for q in (smooth, rough):
        got = float(tmisc.bandlimit_violation(torch.as_tensor(q), 0.1))
        ref = float(jmisc.bandlimit_violation(jnp.asarray(q), 0.1))
        assert got == pytest.approx(ref, rel=1e-10, abs=1e-15)
    with pytest.warns(RuntimeWarning, match="bandlimited"):
        tnse.preprocess_signal(torch.as_tensor(rough), 0.1, +1,
                               tdisc.Discretization.CF4_2)
    assert float(tmisc.bandlimit_violation(torch.as_tensor(rough[:10]),
                                           0.1)) == 0.0


@pytest.mark.filterwarnings("ignore:Signal does not appear")
@pytest.mark.parametrize("dsub", [None, 21], ids=["full", "dsub21"])
@pytest.mark.parametrize("disc", RESAMPLED + [tdisc.Discretization.BO],
                         ids=lambda d: d.value)
def test_preprocess_signal_matches_jax(disc, dsub):
    """Every scheme with resampling or derivative slots (and BO, plain
    decimation), kappa = -1 so a sign error in r shows; 1e-14: the same
    FFT phase shift and weighted sums in another library."""
    t = np.linspace(-8.0, 8.0, 64)
    q = 1.7 / np.cosh(t) * np.exp(0.3j * t)
    eps_t = 16.0 / 63
    q_t, r_t, dsub_t, span_t = tnse.preprocess_signal(
        torch.as_tensor(q), eps_t, -1, disc, dsub)
    q_j, r_j, dsub_j, span_j = jnse.preprocess_signal(
        jnp.asarray(q), eps_t, -1, _jd(disc), dsub)
    assert (dsub_t, tuple(span_t)) == (dsub_j, tuple(span_j))
    assert q_t.shape[-1] == dsub_t * tdisc.upsampling_factor(disc)
    assert _rel(q_t, q_j) <= 1e-14 and _rel(r_t, r_j) <= 1e-14
    if disc in (tdisc.Discretization.CF5_3, tdisc.Discretization.CF6_4):
        # complex weights: r is built from the conjugated nodes
        assert _rel(r_t, torch.conj(q_t)) > 1e-3


def test_misc_metrics_match_jax():
    rng = np.random.default_rng(8)
    a = rng.normal(size=7) + 1j * rng.normal(size=7)
    b = a[:5] + 1e-3 * (rng.normal(size=5) + 1j * rng.normal(size=5))
    assert float(tmisc.rel_err(torch.as_tensor(a[:5]), torch.as_tensor(b))) \
        == pytest.approx(float(jmisc.rel_err(jnp.asarray(a[:5]),
                                             jnp.asarray(b))), rel=1e-13)
    assert float(tmisc.hausdorff_dist(torch.as_tensor(a), torch.as_tensor(b))) \
        == pytest.approx(float(jmisc.hausdorff_dist(jnp.asarray(a),
                                                    jnp.asarray(b))), rel=1e-13)
    pts = np.array([0.1 + 1j, 0.1 + 1j + 1e-9, 5 + 1j, 0.1 + 1j - 1e-9j, 2j])
    np.testing.assert_array_equal(tmisc.merge_points_host(pts, 1e-6),
                                  jmisc.merge_points_host(pts, 1e-6))
    assert tmisc.merge_points_host(pts[:1], 1e-6).shape == (1,)
