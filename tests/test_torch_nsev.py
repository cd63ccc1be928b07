"""The nsev slice of the PyTorch port against the JAX package: phi/psi
sweeps, the whole default-options nsev, option carry-over, and the
port's independence from jax. Same numpy inputs to both (complex128, CPU).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fnft_tpu as jft
import fnft_tpu.models.discretization as jdisc
import fnft_tpu.ops.scatter as jscatter
import fnft_tpu_torch as tft
from fnft_tpu_torch import compat
from fnft_tpu_torch.models.discretization import Discretization
from fnft_tpu_torch.ops import kernels
from fnft_tpu_torch.ops import roots as troots
from fnft_tpu_torch.ops import scatter as tscatter
from fnft_tpu_torch.testcases import NsevTestcase, nsev_errors, nsev_testcase

torch.set_num_threads(1)

REFERENCE_BOUNDS_4096 = (3.9e-6, 6.3e-6, 2.0e-6, 1.6e-5, 5e-14, 2.1e-6)


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _matched(got, ref):
    """Reorder ``got`` to the nearest entries of ``ref`` (same length)."""
    got = np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return got[np.argmin(np.abs(got[None, :] - ref[:, None]), axis=1)]


@pytest.mark.parametrize("skip_b", [True, False])
def test_scatter_bound_states_bo_matches_jax(skip_b):
    d = 512
    t = np.linspace(-10.0, 10.0, d)
    q = 1.7j / np.cosh(t) * np.exp(0.3j * t)
    r = -np.conj(q)
    eps_t = 20.0 / (d - 1)
    lam = np.array([0.05 + 1.1j, -0.2 + 0.6j, 0.3 + 0.2j])
    got = tscatter.scatter_bound_states(
        torch.as_tensor(q), torch.as_tensor(r), torch.as_tensor(lam), eps_t,
        -10.0, 10.0, Discretization.BO, skip_b=skip_b)
    ref = jscatter.scatter_bound_states(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(lam), eps_t, -10.0, 10.0,
        jdisc.Discretization.BO, skip_b=skip_b)
    for name, g, rf in zip(("a", "a'", "b"), got, ref):
        if skip_b and name == "b":
            assert torch.all(g == 0)
            continue
        assert _rel(g, rf) <= 1e-10, name


def test_nsev_slice_matches_jax(monkeypatch):
    """Default options plus BOTH/BOTH on the sech at D = 1024: both passes
    (Dsub = 341 -> 512 padded) hand two tree levels to K1's plain version."""
    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, 1024)
    jopts = jft.NsevOpts(contspec_type=jft.ContspecType.BOTH,
                         discspec_type=jft.DiscspecType.BOTH)
    ref = jft.nsev(jnp.asarray(data.q), data.t_span, m=data.m,
                   xi_span=data.xi_span, opts=jopts)
    calls = []
    orig = kernels.fused_tree_levels_plain
    monkeypatch.setattr(
        kernels, "fused_tree_levels_plain",
        lambda p, lv, **k: calls.append(p.shape[0]) or orig(p, lv, **k))
    got = tft.nsev(torch.as_tensor(data.q), data.t_span, m=data.m,
                   xi_span=data.xi_span,
                   opts=compat.opts_from_reference(jopts))
    assert calls == [512, 1024]
    for field in ("reflection_coefficient", "a", "b"):
        assert _rel(getattr(got, field), getattr(ref, field)) <= 1e-8, field
    bs_ref = np.asarray(ref.bound_states)
    assert got.bound_states.shape == bs_ref.shape == (3,)
    order = np.argmin(np.abs(got.bound_states.numpy()[None, :]
                             - bs_ref[:, None]), axis=1)
    np.testing.assert_allclose(got.bound_states.numpy()[order], bs_ref,
                               rtol=0, atol=1e-9)
    for field in ("norming_constants", "residues"):
        g = getattr(got, field).numpy()[order]
        assert _rel(g, getattr(ref, field)) <= 1e-8, field


def test_nsev_with_initial_states_matches_jax():
    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, 512)
    init = data.bound_states + np.array([1e-3, -2e-3j, 1e-3 + 1e-3j])
    ref = jft.models.nsev.nsev_with_initial_states(
        jnp.asarray(data.q), data.t_span, init, m=0)
    got = tft.nsev_with_initial_states(torch.as_tensor(data.q), data.t_span,
                                       init, m=0)
    np.testing.assert_allclose(_matched(got.bound_states, ref.bound_states),
                               np.asarray(ref.bound_states), rtol=0, atol=1e-9)
    assert got.reflection_coefficient is None


def test_nsev_reference_bounds_contspec_only_and_complex64():
    """Meets the reference's contspec bound without bound states; complex64
    input stays complex64 within its accuracy budget."""
    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, 2048)
    res = tft.nsev(torch.as_tensor(data.q), data.t_span, m=data.m,
                   xi_span=data.xi_span, want_bound_states=False)
    assert res.bound_states is None
    errs = nsev_errors(res, data)
    assert errs["contspec"] <= 4 * REFERENCE_BOUNDS_4096[0]
    res32 = tft.nsev(torch.as_tensor(data.q.astype(np.complex64)),
                     data.t_span, m=data.m, xi_span=data.xi_span,
                     want_bound_states=False)
    assert res32.reflection_coefficient.dtype == torch.complex64
    assert nsev_errors(res32, data)["contspec"] <= 5e-4


def test_nsev_unported_paths_raise():
    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, 64)
    q = torch.as_tensor(data.q)
    for opts in (tft.NsevOpts(richardson_extrapolation=True),
                 tft.NsevOpts(discretization=Discretization.SPLIT2A),
                 tft.NsevOpts(discretization=Discretization.BO)):
        with pytest.raises(NotImplementedError):
            tft.nsev(q, data.t_span, m=4, xi_span=data.xi_span, opts=opts)
    with pytest.raises(ValueError, match="initial bound states"):
        tft.nsev(q, data.t_span, opts=tft.NsevOpts(
            bound_state_localization=tft.BoundStateLocalization.NEWTON))
    with pytest.raises(ValueError, match="D must be"):
        tft.nsev(q[:1], data.t_span)
    with pytest.raises(NotImplementedError, match="deflated"):
        troots.poly_roots(torch.ones(16386, dtype=torch.complex128))


def test_opts_from_reference_round_trips_every_field():
    jopts = jft.NsevOpts(
        bound_state_filtering=jft.BoundStateFilter.BASIC,
        bound_state_localization=jft.BoundStateLocalization.FAST_EIGENVALUE,
        niter=7, dsub=333, discspec_type=jft.DiscspecType.RESIDUES,
        contspec_type=jft.ContspecType.AB, normalization_flag=False,
        discretization=jft.Discretization.SPLIT2A,
        richardson_extrapolation=True)
    topts = compat.opts_from_reference(jopts)
    assert isinstance(topts, tft.NsevOpts)
    for field in ("bound_state_filtering", "bound_state_localization",
                  "niter", "dsub", "discspec_type", "contspec_type",
                  "normalization_flag", "discretization",
                  "richardson_extrapolation"):
        j, t = getattr(jopts, field), getattr(topts, field)
        assert getattr(j, "value", j) == getattr(t, "value", t), field
        assert type(t).__module__.startswith(("fnft_tpu_torch", "builtins"))
    assert compat.opts_from_reference(jft.NsevOpts()) == tft.NsevOpts()


def test_import_leaves_jax_out():
    code = ("import sys, fnft_tpu_torch, fnft_tpu_torch.compat, "
            "fnft_tpu_torch.testcases, fnft_tpu_torch.ops.kernels; "
            "print(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'fnft_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "[]", out.stdout
