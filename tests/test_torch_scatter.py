"""Slow (ODE-style) scattering of the PyTorch port against the JAX package:
the monodromy matrix with its lambda-derivative and the phi/psi sweeps for
all seven slow schemes, the chunked two-pass route against the one-shot
route, and nsev with each slow scheme end to end. Same numpy inputs to
both (complex128, CPU).

Tolerances: the same step formulas in another library, multiplied up in
another order (the JAX package scans sequentially on the CPU, the port
multiplies pairwise): 1e-12 on the matrices at D = 64, 1e-10 on a, a', b,
1e-8 on whole spectra.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fnft_tpu as jft
import fnft_tpu.models.discretization as jdisc
import fnft_tpu.models.nse as jnse
import fnft_tpu.ops.scatter as jscatter
import fnft_tpu_torch as tft
from fnft_tpu_torch import compat
from fnft_tpu_torch.models import nse as tnse
from fnft_tpu_torch.models.discretization import Discretization, is_fast
from fnft_tpu_torch.ops import scatter as tscatter
from fnft_tpu_torch.testcases import NsevTestcase, nsev_testcase

torch.set_num_threads(1)

SLOW = [d for d in Discretization if not is_fast(d)]
LAM = np.array([0.05 + 1.1j, -0.2 + 0.6j, 0.3 + 0.2j, 1.5 + 0.0j])


def _rel(got, ref):
    got, ref = (x.resolve_conj().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x) for x in (got, ref))
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _inputs(disc, d=64):
    """The chirped sech through each package's own preprocessing."""
    t = np.linspace(-8.0, 8.0, d)
    q = 1.7j / np.cosh(t) * np.exp(0.3j * t)
    eps_t = 16.0 / (d - 1)
    q_j, r_j, _, _ = jnse.preprocess_signal(
        jnp.asarray(q), eps_t, +1, jdisc.Discretization(disc.value))
    q_t, r_t, _, _ = tnse.preprocess_signal(torch.as_tensor(q), eps_t, +1,
                                            disc)
    return (q_t, r_t), (q_j, r_j), eps_t


@pytest.mark.filterwarnings("ignore:Signal does not appear")
@pytest.mark.parametrize("disc", SLOW, ids=lambda d: d.value)
def test_scatter_matrix_and_derivative_match_jax(disc):
    (q_t, r_t), (q_j, r_j), eps_t = _inputs(disc)
    t, dt = tscatter.scatter_matrix(q_t, r_t, torch.as_tensor(LAM), eps_t,
                                    disc, derivative=True)
    t_ref, dt_ref = jscatter.scatter_matrix(
        q_j, r_j, jnp.asarray(LAM), eps_t, jdisc.Discretization(disc.value),
        derivative=True)
    assert tuple(t.shape) == t_ref.shape == (4, 2, 2)
    assert _rel(t, t_ref) <= 1e-12 and _rel(dt, dt_ref) <= 1e-12
    only_t = tscatter.scatter_matrix(q_t, r_t, torch.as_tensor(LAM), eps_t,
                                     disc)
    assert _rel(only_t, t_ref) <= 1e-12
    # dT/dlam against a central difference of T (step 1e-6: ~1e-9 error)
    h = 1e-6
    fd = (tscatter.scatter_matrix(q_t, r_t, torch.as_tensor(LAM + h), eps_t,
                                  disc)
          - tscatter.scatter_matrix(q_t, r_t, torch.as_tensor(LAM - h), eps_t,
                                    disc)) / (2 * h)
    if disc in (Discretization.BO, Discretization.CF4_2, Discretization.ES4):
        # the schemes whose stored derivative is the exact one
        assert _rel(dt, fd) <= 1e-6


@pytest.mark.filterwarnings("ignore:Signal does not appear")
@pytest.mark.parametrize("skip_b", [False, True], ids=["b", "skip_b"])
@pytest.mark.parametrize("disc", SLOW, ids=lambda d: d.value)
def test_scatter_bound_states_match_jax(disc, skip_b):
    (q_t, r_t), (q_j, r_j), eps_t = _inputs(disc)
    lam = LAM[:3]
    got = tscatter.scatter_bound_states(q_t, r_t, torch.as_tensor(lam), eps_t,
                                        -8.0, 8.0, disc, skip_b=skip_b)
    ref = jscatter.scatter_bound_states(
        q_j, r_j, jnp.asarray(lam), eps_t, -8.0, 8.0,
        jdisc.Discretization(disc.value), skip_b=skip_b)
    for name, g, rf in zip(("a", "a'", "b"), got, ref):
        if skip_b and name == "b":
            assert torch.all(g == 0)
            continue
        assert _rel(g, rf) <= 1e-10, name


def test_scatter_matrix_rejects_fast_scheme():
    q = torch.ones(8, dtype=torch.complex128)
    with pytest.raises(ValueError, match="not a slow"):
        tscatter.scatter_matrix(q, -q, torch.as_tensor(LAM), 0.1,
                                Discretization.SPLIT4B)


@pytest.mark.parametrize("disc,skip_b,batch", [
    (Discretization.BO, False, 1 << 21),
    (Discretization.BO, True, 1 << 21),
    (Discretization.BO, False, 1),        # one chunk at a time
    (Discretization.CF4_2, False, 1 << 21),
    (Discretization.CF4_3, False, 7000),  # three chunks a batch, then one
    (Discretization.CF6_4, False, 1),
    (Discretization.ES4, False, 1 << 21),
    (Discretization.TES4, False, 1),
], ids=lambda v: str(getattr(v, "value", v)))
def test_chunked_route_matches_one_shot(monkeypatch, disc, skip_b, batch):
    """The two-pass chunked sweeps against the one-shot trajectory at
    D = 1024, with the threshold patched down and chunks of 256 samples
    (the shortest the rule takes: 4 chunks), worked in batches of every
    size down to one."""
    d = 1024
    t = np.linspace(-12.0, 12.0, d)
    eps_t = 24.0 / (d - 1)
    q_eff, r_eff, _, _ = tnse.preprocess_signal(
        torch.as_tensor(3.2j / np.cosh(t - 1.3)), eps_t, +1, disc)
    # the pulse is off centre: on a symmetric one the b metric has two
    # equal minima away from an eigenvalue, and rounding picks between them
    lam = torch.as_tensor(np.array([0.7j, 1.7j, 2.7j, 0.3 + 1.0j]))
    one_shot = tscatter.scatter_bound_states(q_eff, r_eff, lam, eps_t, -12.0,
                                             12.0, disc, skip_b=skip_b)
    calls = []
    orig = tscatter._bound_states_chunked
    monkeypatch.setattr(tscatter, "_bound_states_chunked",
                        lambda *a, **k: calls.append(a[-2]) or orig(*a, **k))
    monkeypatch.setattr(tscatter, "_CHUNK_THRESHOLD", 1)
    monkeypatch.setattr(tscatter, "_pick_chunk_len", lambda s, se: 256 * se)
    monkeypatch.setattr(tscatter, "_CHUNK_BATCH_MATRICES", batch)
    chunked = tscatter.scatter_bound_states(q_eff, r_eff, lam, eps_t, -12.0,
                                            12.0, disc, skip_b=skip_b)
    assert len(calls) == 1
    for name, g, rf in zip(("a", "a'", "b"), chunked, one_shot):
        np.testing.assert_allclose(g.numpy(), rf.numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=name)


def test_chunk_rule_is_the_jax_packages():
    for s, se in ((1 << 20, 1), (2 << 20, 2), (3 * 4096, 3), (15, 3),
                  (4 * 1000, 4), (1 << 15, 1)):
        assert tscatter._pick_chunk_len(s, se) == \
            jscatter._pick_chunk_len(s, se)
    assert tscatter._CHUNK_THRESHOLD == jscatter._CHUNK_THRESHOLD


def test_chunked_route_is_taken_from_the_threshold_on(monkeypatch):
    """S = 2^15 steps go the chunked way, S = 2^15 - 1 (odd: chunks of one
    step) and anything shorter the one-shot way."""
    seen = []
    monkeypatch.setattr(tscatter, "_bound_states_chunked",
                        lambda *a, **k: seen.append(a[-2]) or (None,) * 3)
    lam = torch.as_tensor(np.array([1.0j]))
    for d in (1 << 15, (1 << 15) - 1):
        q = torch.zeros(d, dtype=torch.complex128)
        tscatter.scatter_bound_states(q, q, lam, 1e-3, 0.0, 1.0,
                                      Discretization.BO, skip_b=True)
    assert seen == [4096]


# (testcase, discretization, D, Newton seeded by the exact states, Richardson)
NSEV_ROWS = [
    (NsevTestcase.SECH_FOCUSING2, Discretization.BO, 256, True, False),
    (NsevTestcase.SECH_FOCUSING2, Discretization.CF4_2, 256, True, True),
    (NsevTestcase.SECH_FOCUSING2, Discretization.CF4_3, 255, True, False),
    (NsevTestcase.SECH_FOCUSING2, Discretization.CF5_3, 255, True, False),
    (NsevTestcase.SECH_FOCUSING2, Discretization.ES4, 256, True, False),
    (NsevTestcase.SECH_FOCUSING2, Discretization.TES4, 256, True, False),
    (NsevTestcase.SECH_DEFOCUSING, Discretization.CF6_4, 256, False, False),
]


@pytest.mark.filterwarnings("ignore:Signal does not appear")
@pytest.mark.parametrize("tc,disc,d,seeded,rich", NSEV_ROWS,
                         ids=[f"{r[0].value}-{r[1].value}" for r in NSEV_ROWS])
def test_nsev_slow_scheme_matches_jax(tc, disc, d, seeded, rich):
    """One row of each slow scheme of the reference's table, at D <= 256,
    through both packages: spectra to 1e-8, bound states to 1e-9."""
    data = nsev_testcase(tc, d)
    jopts = jft.NsevOpts(contspec_type=jft.ContspecType.BOTH,
                         discspec_type=jft.DiscspecType.BOTH,
                         discretization=jft.Discretization(disc.value),
                         richardson_extrapolation=rich)
    topts = compat.opts_from_reference(jopts)
    kw = dict(m=data.m, xi_span=data.xi_span, kappa=data.kappa)
    if seeded:
        ref = jft.models.nsev.nsev_with_initial_states(
            jnp.asarray(data.q), data.t_span, data.bound_states, opts=jopts,
            **kw)
        got = tft.nsev_with_initial_states(
            torch.as_tensor(data.q), data.t_span, data.bound_states,
            opts=topts, **kw)
    else:
        ref = jft.nsev(jnp.asarray(data.q), data.t_span, opts=jopts,
                       want_bound_states=False, **kw)
        got = tft.nsev(torch.as_tensor(data.q), data.t_span, opts=topts,
                       want_bound_states=False, **kw)
    for field in ("reflection_coefficient", "a", "b"):
        assert _rel(getattr(got, field), getattr(ref, field)) <= 1e-8, field
    if not seeded:
        assert got.bound_states is None
        return
    bs_ref = np.asarray(ref.bound_states)
    assert tuple(got.bound_states.shape) == bs_ref.shape
    order = np.argmin(np.abs(got.bound_states.numpy()[None, :]
                             - bs_ref[:, None]), axis=1)
    np.testing.assert_allclose(got.bound_states.numpy()[order], bs_ref,
                               rtol=0, atol=1e-9)
    for field in ("norming_constants", "residues"):
        assert _rel(getattr(got, field).numpy()[order],
                    getattr(ref, field)) <= 1e-8, field


def test_slow_scheme_needs_newton_localization():
    data = nsev_testcase(NsevTestcase.SECH_FOCUSING2, 64)
    with pytest.raises(ValueError, match="only NEWTON"):
        tft.nsev(torch.as_tensor(data.q), data.t_span,
                 opts=tft.NsevOpts(discretization=Discretization.CF4_2))
