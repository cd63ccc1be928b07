"""nsev of the PyTorch port with every fast discretization family, and the
reference's own error bounds for each row of its table with D <= 1024
(``tests/test_nsev.py``), on the CPU in complex128.

Port against JAX package: one row of each fast family at D <= 256, the same
numpy samples to both; spectra to 1e-8 and bound states to 1e-9 (equal
algorithms, another FFT library and product order; the slow families are
in test_torch_scatter.py). Larger sizes run on the GPU in chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fnft_tpu as jft
import fnft_tpu_torch as tft
from fnft_tpu_torch import compat
from fnft_tpu_torch.models.discretization import Discretization
from fnft_tpu_torch.testcases import NsevTestcase, nsev_errors, nsev_testcase

torch.set_num_threads(1)

D_ = Discretization
TC = NsevTestcase
KEYS = ("contspec", "a", "b", "bound_states", "normconsts", "residues")


def _rel(got, ref):
    got, ref = (x.resolve_conj().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x) for x in (got, ref))
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _opts(disc, rich=False):
    return tft.NsevOpts(contspec_type=tft.ContspecType.BOTH,
                        discspec_type=tft.DiscspecType.BOTH,
                        discretization=disc, richardson_extrapolation=rich)


def _run(pkg, with_initial, as_array, opts, data, mode):
    """nsev of one package in one of three modes: "full" (default
    subsample-and-refine localization), "seeded" (Newton from the exact
    bound states), "contspec" (no bound states)."""
    kw = dict(m=data.m, xi_span=data.xi_span, kappa=data.kappa, opts=opts)
    if mode == "seeded":
        return with_initial(as_array(data.q), data.t_span, data.bound_states,
                            **kw)
    return pkg.nsev(as_array(data.q), data.t_span,
                    want_bound_states=mode == "full", **kw)


# (testcase, discretization, D, mode, Richardson): the degree-1 closed
# forms, the generic value route at low and high degree, the resampled
# 4SPLIT4 family, and Richardson. The default subsample-and-refine
# localization against the JAX package is test_torch_nsev.py's; the CF4_2
# Newton base of 4SPLIT4 is in test_torch_scatter.py
JAX_ROWS = [
    (TC.SECH_FOCUSING, D_.SPLIT2A, 256, "seeded", False),
    (TC.SECH_FOCUSING, D_.SPLIT2_MODAL, 256, "seeded", False),
    (TC.SECH_FOCUSING, D_.SPLIT3A, 256, "contspec", False),
    (TC.SECH_FOCUSING, D_.SPLIT8B, 128, "contspec", False),
    (TC.SECH_FOCUSING, D_.SPLIT4A4, 256, "contspec", False),
    (TC.SECH_FOCUSING, D_.SPLIT4A, 256, "seeded", True),
]


@pytest.mark.parametrize("tc,disc,d,mode,rich", JAX_ROWS,
                         ids=[f"{r[0].value}-{r[1].value}" for r in JAX_ROWS])
def test_nsev_fast_scheme_matches_jax(tc, disc, d, mode, rich):
    data = nsev_testcase(tc, d)
    topts = _opts(disc, rich)
    jopts = jft.NsevOpts(contspec_type=jft.ContspecType.BOTH,
                         discspec_type=jft.DiscspecType.BOTH,
                         discretization=jft.Discretization(disc.value),
                         richardson_extrapolation=rich)
    assert compat.opts_from_reference(jopts) == topts
    ref = _run(jft, jft.models.nsev.nsev_with_initial_states, jnp.asarray,
               jopts, data, mode)
    got = _run(tft, tft.nsev_with_initial_states, torch.as_tensor, topts,
               data, mode)
    for field in ("reflection_coefficient", "a", "b"):
        assert _rel(getattr(got, field), getattr(ref, field)) <= 1e-8, field
    if mode == "contspec":
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


# The rows of the reference's table with D <= 1024, each with its six
# bounds (test/fnft_nsev/fnft_nsev_test_<case>_<disc>.c). "seeded*": the
# row localizes by subsample-and-refine, whose Aberth run on 3840 and 13440
# roots takes most of a minute on one CPU core, so here Newton starts from
# the exact states instead and ends at the same zeros of the discrete
# a(lambda); chip_smoke.py runs these rows as the table has them.
BOUND_ROWS = [
    (TC.SECH_FOCUSING, D_.SPLIT8B, 1024,
     (6.2e-5, 1.0e-4, 3.1e-5, 2.4e-4, 5e-14, 3.3e-5), "seeded*", False),
    (TC.SECH_FOCUSING, D_.SPLIT7A, 256,
     (9.9e-4, 1.7e-3, 4.9e-4, 3.9e-3, 5e-14, 6.0e-4), "seeded*", False),
    (TC.SECH_FOCUSING, D_.SPLIT4A4, 512,
     (1.6e-6, 4.3e-6, 1.5e-6, 2.2e-7, 6e-15, 1.1e-6), "full", False),
    (TC.SECH_FOCUSING, D_.SPLIT4B4, 1024,
     (5.2e-8, 1.6e-7, 4.5e-8, 1.4e-8, 5e-15, 6.3e-8), "full", False),
    (TC.SECH_FOCUSING2, D_.CF4_2, 512,
     (7.1e-3, 3.5e-3, 1.2e-3, 1.2e-3, 3.2e-11, 1.6e-3), "seeded", False),
    (TC.SECH_FOCUSING2, D_.CF4_3, 513,
     (2.8e-4, 1.5e-4, 4.1e-5, 1.6e-4, 4.0e-14, 6.2e-4), "seeded", False),
    (TC.SECH_FOCUSING2, D_.CF5_3, 399,
     (7.5e-5, 4.2e-5, 4.2e-5, 4.1e-5, 2.8e-4, 2.7e-4), "seeded", False),
    (TC.SECH_FOCUSING2, D_.CF6_4, 400,
     (1.7e-4, 7.9e-5, 2.4e-5, 4.3e-5, 5.0e-14, 7.7e-5), "seeded", False),
    (TC.SECH_FOCUSING2, D_.ES4, 512,
     (9.7e-2, 4.8e-2, 1.7e-2, 2.5e-2, 3.2e-11, 4.7e-2), "seeded", False),
    (TC.SECH_FOCUSING2, D_.TES4, 1024,
     (7.7e-3, 3.8e-3, 1.2e-3, 1.2e-3, 3.2e-11, 4.8e-2), "seeded", False),
    (TC.SECH_FOCUSING2, D_.CF4_2, 512,
     (8.8e-4, 1.2e-4, 5.6e-5, 8.8e-5, 5e-14, 9.8e-5), "seeded", True),
    (TC.SECH_FOCUSING2, D_.CF5_3, 701,
     (3e-6, 1.5e-6, 4.5e-7, 1.6e-6, 1.8e-5, 1.7e-5), "seeded", True),
    (TC.SECH_FOCUSING2, D_.TES4, 1024,
     (1.1e-3, 1.6e-4, 5.6e-5, 5.5e-5, 5e-14, 3.9e-2), "seeded", True),
    (TC.SECH_DEFOCUSING, D_.SPLIT4B4, 1024,
     (1.5e-6, None, None, None, None, None), "contspec", False),
    (TC.SECH_DEFOCUSING, D_.CF4_2, 512,
     (2.7e-5, None, None, None, None, None), "contspec", False),
    (TC.SECH_DEFOCUSING, D_.CF5_3, 513,
     (2.02e-6, None, None, None, None, None), "contspec", False),
    (TC.SECH_DEFOCUSING, D_.ES4, 513,
     (6.6e-4, None, None, None, None, None), "contspec", False),
    (TC.SECH_DEFOCUSING, D_.TES4, 513,
     (5e-4, None, None, None, None, None), "contspec", False),
    (TC.TRUNCATED_SOLITON, D_.SPLIT2A, 1024,
     (1.8e-4, None, None, None, None, None), "contspec", False),
    (TC.TRUNCATED_SOLITON, D_.SPLIT2_MODAL, 1024,
     (2.9e-4, None, None, None, None, None), "contspec", False),
]


@pytest.mark.filterwarnings("ignore:Signal does not appear")
@pytest.mark.parametrize(
    "tc,disc,d,bounds,mode,rich", BOUND_ROWS,
    ids=[f"{r[0].value}-{r[1].value}-{r[2]}{'-re' if r[5] else ''}"
         for r in BOUND_ROWS])
def test_nsev_reference_bounds(tc, disc, d, bounds, mode, rich):
    data = nsev_testcase(tc, d)
    res = _run(tft, tft.nsev_with_initial_states, torch.as_tensor,
               _opts(disc, rich), data, mode.rstrip("*"))
    errs = nsev_errors(res, data)
    for key, bound in zip(KEYS, bounds):
        if bound is not None:
            assert errs[key] is not None and errs[key] <= bound, \
                (key, errs[key], bound)


def test_richardson_improves_bo():
    """Richardson extrapolation against the half-resolution pass lowers
    every error of the second-order BO scheme that is not at rounding
    level already, by 40% or more at D = 1024."""
    data = nsev_testcase(TC.SECH_FOCUSING2, 1024)
    errs = [nsev_errors(_run(tft, tft.nsev_with_initial_states,
                             torch.as_tensor, _opts(D_.BO, rich), data,
                             "seeded"), data) for rich in (False, True)]
    for key in ("contspec", "a", "b", "bound_states", "residues"):
        assert errs[1][key] < 0.6 * errs[0][key], (key, errs)


@pytest.mark.filterwarnings("ignore:Signal does not appear")
@pytest.mark.parametrize("disc", list(Discretization), ids=lambda d: d.value)
def test_nsev_accepts_every_discretization(disc):
    """Every member of ``Discretization`` runs, with and without
    Richardson, and returns finite spectra of the asked shape (D = 64:
    accuracy is the other tests' matter)."""
    data = nsev_testcase(TC.SECH_FOCUSING, 64)
    for rich in (False, True):
        res = tft.nsev(torch.as_tensor(data.q), data.t_span, m=8,
                       xi_span=data.xi_span, opts=_opts(disc, rich),
                       want_bound_states=False)
        for field in ("reflection_coefficient", "a", "b"):
            val = getattr(res, field)
            assert val.shape == (8,) and val.dtype == torch.complex128
            assert bool(torch.all(torch.isfinite(val.real)
                                  & torch.isfinite(val.imag))), (field, rich)
    assert tft.nsev_max_k(64, _opts(disc)) == \
        jft.models.nsev.nsev_max_k(64, jft.NsevOpts(
            discretization=jft.Discretization(disc.value)))
