"""kdvv of the PyTorch port against the JAX package and the reference's
bounds, the rule that decides the real-coefficient route, and the carrying
of options from the JAX package for both transforms. Same numpy inputs to
both (complex128, CPU).

Tolerances: 1e-11 on rho at D = 256 (equal algorithms, another FFT
library; degree 12 x 256 coefficients through the tree and the chirp-Z).
"""

import dataclasses
import enum

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fnft_tpu as jft
from fnft_tpu.models import kdvv as jkdvv
import fnft_tpu_torch as tft
from fnft_tpu_torch import compat
from fnft_tpu_torch.models import kdvv as tkdvv
from fnft_tpu_torch.models.discretization import Discretization
from fnft_tpu_torch.testcases import (
    kdvv_poschl_teller_case,
    kdvv_rect_case,
    kdvv_sech_case,
)
from fnft_tpu_torch.utils.misc import rel_err

torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = (x.resolve_conj().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x) for x in (got, ref))
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("disc", [Discretization.SPLIT2A,
                                  Discretization.SPLIT3A,
                                  Discretization.SPLIT4B,
                                  Discretization.SPLIT8B],
                         ids=lambda d: d.value)
def test_kdvv_matches_jax(disc):
    """A real tensor takes the real-coefficient route (``rsym``), a complex
    one the generic route; both agree with the JAX package."""
    u, t_span, xi_span, _ = kdvv_sech_case(256)
    jopts = jft.KdvvOpts(discretization=jft.Discretization(disc.value))
    topts = compat.kdvv_opts_from_reference(jopts)
    ref = jft.kdvv(jnp.asarray(u + 0j), t_span, m=16, xi_span=xi_span,
                   opts=jopts).reflection_coefficient
    real = tft.kdvv(torch.as_tensor(u), t_span, m=16, xi_span=xi_span,
                    opts=topts).reflection_coefficient
    cplx = tft.kdvv(torch.as_tensor(u + 0j), t_span, m=16, xi_span=xi_span,
                    opts=topts).reflection_coefficient
    assert real.dtype == cplx.dtype == torch.complex128
    assert tuple(real.shape) == ref.shape == (16,)
    assert _rel(real, ref) <= 1e-11 and _rel(cplx, ref) <= 1e-11
    assert _rel(real, cplx) <= 1e-10


@pytest.mark.parametrize("disc,bound", [(Discretization.SPLIT8B, 5.78e-5),
                                        (Discretization.SPLIT2A, 1.37e-4),
                                        (Discretization.SPLIT3S, 5.77e-5)],
                         ids=lambda v: str(getattr(v, "value", v)))
def test_kdvv_sech_reference_bound(disc, bound):
    """The reference's own bounds at D = 1024
    (test/fnft_kdvv/fnft_kdvv_test_sech_2splitXY.c)."""
    u, t_span, xi_span, rho = kdvv_sech_case(1024)
    res = tft.kdvv(u, t_span, m=16, xi_span=xi_span, device="cpu",
                   opts=tft.KdvvOpts(discretization=disc))
    assert float(rel_err(res.reflection_coefficient,
                         torch.as_tensor(rho))) <= bound


@pytest.mark.parametrize("ampl,bound", [(1.0, 1.5e-1), (-1.0, 1.797e-1)])
def test_kdvv_rect_reference_bound(ampl, bound):
    u, t_span, xi_span, rho = kdvv_rect_case(4, ampl)
    res = tft.kdvv(u, t_span, m=16, xi_span=xi_span, device="cpu",
                   opts=tft.KdvvOpts(discretization=Discretization.SPLIT2A))
    assert float(rel_err(res.reflection_coefficient,
                         torch.as_tensor(rho))) <= bound


def test_kdvv_rejects_slow_schemes_and_bad_grids():
    u, t_span, xi_span, _ = kdvv_sech_case(32)
    ut = torch.as_tensor(u)
    with pytest.raises(ValueError, match="fast"):
        tft.kdvv(ut, t_span, m=16, xi_span=xi_span,
                 opts=tft.KdvvOpts(discretization=Discretization.BO))
    with pytest.raises(ValueError, match="invalid grids"):
        tft.kdvv(ut, t_span, m=1, xi_span=xi_span)
    with pytest.raises(ValueError, match="invalid grids"):
        tft.kdvv(ut, (1.0, -1.0), m=16, xi_span=xi_span)


def test_kdvv_array_goes_to_the_card_by_default():
    """As nsev: an array runs on the CUDA device unless ``device`` says
    otherwise, and without one that default raises."""
    u, t_span, xi_span, _ = kdvv_sech_case(32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tft.kdvv(u, t_span, m=16, xi_span=xi_span)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tft.kdvv_bound_states(u, t_span)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tft.kdv_scatter_matrix(u, [0.5], 0.1)
    res = tft.kdvv(u, t_span, m=16, xi_span=xi_span, device="cpu")
    assert res.reflection_coefficient.device.type == "cpu"


def test_is_real_valued_rule(monkeypatch):
    """Real dtype -> true; complex host array -> inspected; complex tensor
    -> false (never inspected) unless ``opts.rsym`` says otherwise."""
    u = np.linspace(0.0, 1.0, 8)
    assert tkdvv._is_real_valued(u)
    assert tkdvv._is_real_valued(u + 0j)
    assert tkdvv._is_real_valued(list(u))
    assert not tkdvv._is_real_valued(u + 1e-3j)
    assert tkdvv._is_real_valued(torch.as_tensor(u))
    assert tkdvv._is_real_valued(torch.as_tensor(u).float())
    assert not tkdvv._is_real_valued(torch.as_tensor(u + 0j))
    for val in (u, u + 0j, u + 1e-3j):
        assert tkdvv._is_real_valued(val) == jkdvv._is_real_valued(val)
    seen = []
    orig = tkdvv.fscatter
    monkeypatch.setattr(tkdvv, "fscatter", lambda *a, **k: seen.append(
        k["rsym"]) or orig(*a, **k))
    data, t_span, xi_span, _ = kdvv_sech_case(32)
    for val, rsym in ((torch.as_tensor(data), None),
                      (torch.as_tensor(data + 0j), None),
                      (torch.as_tensor(data + 0j), True),
                      (torch.as_tensor(data), False)):
        tft.kdvv(val, t_span, m=4, xi_span=xi_span,
                 opts=tft.KdvvOpts(rsym=rsym))
    assert seen == [True, False, True, False]


@pytest.mark.parametrize("disc", [Discretization.BO, Discretization.CF4_2],
                         ids=lambda d: d.value)
def test_kdv_scatter_matrix_matches_jax(disc):
    rng = np.random.default_rng(2)
    q = rng.normal(size=48)
    lam = np.array([0.3, 1.0 + 0.2j, -0.7j])
    t, dt = tft.kdv_scatter_matrix(q, lam, 0.1, disc, derivative=True,
                                   device="cpu")
    t_ref, dt_ref = jkdvv.kdv_scatter_matrix(
        jnp.asarray(q), jnp.asarray(lam), 0.1,
        jft.Discretization(disc.value), derivative=True)
    assert _rel(t, t_ref) <= 1e-12 and _rel(dt, dt_ref) <= 1e-12
    only = tft.kdv_scatter_matrix(torch.as_tensor(q), torch.as_tensor(lam),
                                  0.1, disc)
    assert _rel(only, t_ref) <= 1e-12


def test_kdvv_bound_states_poschl_teller():
    """s(s+1) sech^2 has kappa_n = s - n exactly; D = 256 keeps the Aberth
    run short on the CPU (the reference-sized D = 1024 runs on the GPU in
    chip_smoke.py), so the discretization error allows 5e-3."""
    opts = tft.KdvvOpts(discretization=Discretization.SPLIT4B)
    for s in (1.3, 2.0):
        u, t_span, kappa = kdvv_poschl_teller_case(256, s)
        got = tft.kdvv_bound_states(torch.as_tensor(u), t_span, opts=opts)
        assert got.dtype == torch.complex128 and torch.all(got.real == 0)
        np.testing.assert_allclose(np.sort(got.imag.numpy()), np.sort(kappa),
                                   atol=5e-3)


def _enum_fields(cls):
    return [(f.name, type(f.default)) for f in dataclasses.fields(cls)
            if isinstance(f.default, enum.Enum)]


NSEV_ENUM_VALUES = [(name, member.value)
                    for name, etype in _enum_fields(tft.NsevOpts)
                    for member in etype]


@pytest.mark.parametrize("field,value", NSEV_ENUM_VALUES,
                         ids=[f"{n}-{v}" for n, v in NSEV_ENUM_VALUES])
def test_opts_from_reference_carries_every_enum_value(field, value):
    jtype = type(getattr(jft.NsevOpts(), field))
    jopts = jft.NsevOpts(**{field: jtype(value)}, niter=3, dsub=77,
                         normalization_flag=False,
                         richardson_extrapolation=True)
    topts = compat.opts_from_reference(jopts)
    assert getattr(topts, field).value == value
    assert type(getattr(topts, field)).__module__.startswith("fnft_tpu_torch")
    assert (topts.niter, topts.dsub, topts.normalization_flag,
            topts.richardson_extrapolation) == (3, 77, False, True)
    for f in dataclasses.fields(tft.NsevOpts):
        j, t = getattr(jopts, f.name), getattr(topts, f.name)
        assert getattr(j, "value", j) == getattr(t, "value", t), f.name


@pytest.mark.parametrize("rsym", [None, True, False])
def test_kdvv_opts_from_reference_carries_every_field(rsym):
    assert [f.name for f in dataclasses.fields(tft.KdvvOpts)] == \
        [f.name for f in dataclasses.fields(jft.KdvvOpts)]
    for member in jft.Discretization:
        topts = compat.kdvv_opts_from_reference(
            jft.KdvvOpts(discretization=member, rsym=rsym))
        assert isinstance(topts, tft.KdvvOpts)
        assert topts.discretization is Discretization(member.value)
        assert topts.rsym is rsym
    assert compat.kdvv_opts_from_reference(jft.KdvvOpts()) == tft.KdvvOpts()
