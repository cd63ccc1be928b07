"""nsep of the PyTorch port against the JAX package and the reference's
bounds. Same numpy inputs to both (complex128, CPU).

Tolerances:
- grid search: equal masks, roots to 1e-12 (the least-squares root divides
  by a local slope, so 1e-16 differences of the chirp-Z values move it by
  ~1e-15 on these well-separated roots, which lie 0.05 rad apart or more);
- whole transform at D = 256: equal point counts; aux spectra to 1e-9
  (simple roots, Newton to sqrt(eps)); main spectra to 1e-5 from the grid
  search (least-squares roots of equal chirp-Z values; the plane wave's
  double point at -1.5 moves them by ~1e-6) and to 5e-4 from
  subsample-and-refine. Both test signals have main spectra made of double
  points (closed gaps), where Newton converges linearly and stops once
  |Delta -+ 2| < sqrt(eps), ~1e-4 from the exact point at this D: two
  implementations that round differently stop at different such points,
  each as far from the exact one as the other;
- a main-spectrum Newton sweep that does not converge ends at its
  least-residual iterate in the port and at its last one in the JAX
  package; at D = 256 no point above differs by more than its tolerance;
- the analytic bounds are those of ``tests/test_nsep.py``. Its three rows
  that need a dense Aberth run at degree 1024-2048 (2SPLIT4B and 2SPLIT4A
  at D = 1024, 4SPLIT4B at D = 512: 120 sweeps of a [3, deg, deg]
  repulsion, beyond this file's time on one CPU core) are held to the
  same bounds on the card by ``chip_smoke.py``; every other row runs here.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fnft_tpu as jft
from fnft_tpu.ops import gridsearch as jgs
import fnft_tpu_torch as tft
from fnft_tpu_torch import compat
from fnft_tpu_torch.models import nsep as tnsep
from fnft_tpu_torch.models.discretization import Discretization
from fnft_tpu_torch.ops import gridsearch as tgs
from fnft_tpu_torch.testcases import (
    nsep_constant_defocusing_case,
    nsep_errors,
    nsep_plane_wave_case,
)

torch.set_num_threads(1)

BOX = (-10.0, 10.0, -10.0, 10.0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _hausdorff(a, b) -> float:
    a, b = _np(a).ravel(), _np(b).ravel()
    d = np.abs(a[:, None] - b[None, :])
    return float(max(d.min(axis=1).max(), d.min(axis=0).max()))


def _opts(pkg, loc, disc="SPLIT2A", box=BOX, **kw):
    return pkg.NsepOpts(filtering=pkg.PointFilter.MANUAL, bounding_box=box,
                        localization=pkg.Localization[loc],
                        discretization=pkg.Discretization[disc], **kw)


def _paraherm_poly(deg, rng):
    """p(z) z^(-deg/2) real on the unit circle: c[deg-k] = conj(c[k])."""
    c = rng.normal(size=deg + 1) + 1j * rng.normal(size=deg + 1)
    c = c + np.conj(c[::-1])
    return c


@pytest.mark.parametrize("paraherm", [False, True], ids=["3x3", "paraherm"])
def test_gridsearch_matches_jax(paraherm):
    rng = np.random.default_rng(11)
    deg = 64
    if paraherm:
        coeffs = _paraherm_poly(deg, rng)
        jfn, tfn = (jgs.roots_fftgridsearch_paraherm,
                    tgs.roots_fftgridsearch_paraherm)
    else:
        # roots on and near the unit circle, at least 0.05 rad apart (a
        # closer pair can tie in the minimum-modulus test)
        ang = 2 * np.pi * (np.arange(deg) + rng.uniform(-0.25, 0.25, deg))
        roots = np.exp(1j * ang / deg) * (1 + 1e-3 * rng.normal(size=deg))
        coeffs = np.poly(roots)[::-1].copy()
        jfn, tfn = jgs.roots_fftgridsearch, tgs.roots_fftgridsearch
    kw = dict(phi0=0.1, phi1=2 * np.pi - 0.1, m=32 * deg)
    zj, mj = (np.asarray(x) for x in jfn(jnp.asarray(coeffs), **kw))
    zt, mt = tfn(torch.as_tensor(coeffs), **kw)
    assert zt.dtype == torch.complex128 and tuple(zt.shape) == (32 * deg,)
    assert np.array_equal(mt.numpy(), mj) and mj.sum() >= deg // 4
    assert np.max(np.abs(zt.numpy() - zj)) <= 1e-12
    if not paraherm:
        # every root found lies within a few grid steps (3e-3) of a true one
        assert max(np.min(np.abs(roots - z)) for z in zj[mj]) < 1e-2


# the constant case's grid search is the main-spectrum half of its MIXED run
CASES = [("plane_wave", "GRIDSEARCH"), ("plane_wave", "SUBSAMPLE_AND_REFINE"),
         ("plane_wave", "MIXED"), ("constant", "SUBSAMPLE_AND_REFINE"),
         ("constant", "MIXED")]


def _case(name, d):
    return (nsep_plane_wave_case if name == "plane_wave" else
            nsep_constant_defocusing_case)(d)


@pytest.fixture(scope="module")
def jax_spectra():
    """The JAX package's spectra at D = 256, by (case, localization)."""
    out = {}
    for name, loc in CASES:
        q, t_span, kappa, *_ = _case(name, 256)
        res = jft.nsep(jnp.asarray(q), t_span, kappa=kappa,
                       opts=_opts(jft, loc))
        out[name, loc] = (np.asarray(res.main_spectrum),
                          np.asarray(res.aux_spectrum))
    return out


@pytest.mark.parametrize("name,loc", CASES)
def test_nsep_matches_jax(jax_spectra, name, loc):
    q, t_span, kappa, *_ = _case(name, 256)
    res = tft.nsep(torch.as_tensor(q), t_span, kappa=kappa,
                   opts=_opts(tft, loc))
    main_j, aux_j = jax_spectra[name, loc]
    for got in (res.main_spectrum, res.aux_spectrum):
        assert got.dtype == torch.complex128 and got.device.type == "cpu"
    assert res.main_spectrum.numel() == main_j.size > 0
    assert res.aux_spectrum.numel() == aux_j.size > 0
    main_tol = 5e-4 if loc == "SUBSAMPLE_AND_REFINE" else 1e-5
    assert _hausdorff(res.main_spectrum, main_j) <= main_tol
    assert _hausdorff(res.aux_spectrum, aux_j) <= 1e-9


def _run(case_fn, d, disc, main_bound, aux_bound, box=BOX):
    q, t_span, kappa, main, aux, remove_box = case_fn(d)
    res = tft.nsep(torch.as_tensor(q), t_span, kappa=kappa,
                   opts=_opts(tft, "MIXED", disc, box))
    em, ea = nsep_errors(res, main, aux, box, remove_box)
    assert em <= main_bound, ("main", em, main_bound)
    assert ea <= aux_bound, ("aux", ea, aux_bound)


# bounds from test/fnft_nsep/fnft_nsep_test_{plane_wave_focusing,
# constant_defocusing}_*.c, as tests/test_nsep.py has them
@pytest.mark.parametrize("disc,d,mb,ab,box", [
    ("SPLIT2A", 1024, 3.2e-4, 2.9e-4, BOX),
    ("SPLIT2_MODAL", 1024, 3.5e-4, 3.1e-4, BOX),
    ("SPLIT2A", 1024, 4.5e-5, 4.4e-5, (-10.0, 10.0, 0.1, 10.0)),
], ids=["2split2A", "2split2_modal", "2split2A-nonreal"])
def test_nsep_plane_wave_bounds(disc, d, mb, ab, box):
    _run(nsep_plane_wave_case, d, disc, mb, ab, box)


@pytest.mark.parametrize("disc,d,mb,ab", [
    ("SPLIT2A", 2048, 7.6e-5, 7.6e-8),
    ("SPLIT2_MODAL", 2048, 7.6e-5, 7.6e-8),
    ("SPLIT4B", 1024, 7.6e-5, 2.5e-8),
    ("SPLIT4A", 512, 7.6e-5, 2.5e-8),
    ("SPLIT4A4", 64, 6.8e-4, 1.3e-6),
], ids=lambda v: str(v))
def test_nsep_constant_defocusing_bounds(disc, d, mb, ab):
    _run(nsep_constant_defocusing_case, d, disc, mb, ab)


def test_nsep_spines():
    """points_per_spine > 2 samples the spines between the band edges,
    which lie on Re = -1.5 off the real axis (tests/test_nsep.py, at its
    D = 512), for the points with |Im| > 0.05."""
    q, t_span, *_ = nsep_plane_wave_case(512)
    r2, r5 = (tft.nsep(torch.as_tensor(q), t_span, kappa=+1, want_aux=False,
                       opts=_opts(tft, "SUBSAMPLE_AND_REFINE",
                                  points_per_spine=n)) for n in (2, 5))
    assert r2.aux_spectrum is None
    assert r5.main_spectrum.numel() > 1.5 * r2.main_spectrum.numel()
    sp = r5.main_spectrum.numpy()
    off_axis = sp[np.abs(sp.imag) > 0.05]
    assert np.max(np.abs(off_axis.real + 1.5)) < 1e-3


def test_newton_unconverged_keeps_least_residual():
    """At the spines' fourfold crossing -1.5 the full-D discriminant of the
    plane wave (D = 512) has no root within the Newton sweep's reach. From
    this start, one of the fourfold root cluster's Aberth roots as an H100
    rounds it (the CPU gives -1.5000025 - 0.000225i), the JAX package's
    sweep ends at its last iterate, off the spines near -1.70 - 0.17i; the
    port's ends at its iterate of least residual, at the crossing."""
    from fnft_tpu.models import nse as jnse, nsep as jnsep
    from fnft_tpu_torch.models import nse as tnse

    q, t_span, *_ = nsep_plane_wave_case(512)
    eps_t = (t_span[1] - t_span[0]) / 512
    lam0 = np.array([-1.5000003934493888 - 0.00022699368852324922j])
    rhs = np.array([2.0])
    tol = float(np.sqrt(np.finfo(float).eps))
    jq, jr, _, _ = jnse.preprocess_signal(jnp.asarray(q), eps_t, 1,
                                          jft.Discretization.SPLIT2A)
    ref = jnsep._refine_mainspec(jq, jr, lam0, eps_t, rhs, tol, 20,
                                 jft.Discretization.BO)
    assert abs(ref[0] + 1.5) > 0.1 and abs(ref[0].imag) > 0.05
    tq, tr, _, _ = tnse.preprocess_signal(torch.as_tensor(q), eps_t, 1,
                                          Discretization.SPLIT2A)
    got = tnsep._refine_mainspec(tq, tr, torch.as_tensor(lam0), eps_t,
                                 torch.as_tensor(rhs), tol, 20,
                                 Discretization.BO)
    assert abs(complex(got[0]) + 1.5) < 1e-3

    def residual(lam):
        f, _ = tnsep._eval_floquet(tq, tr, lam, eps_t, Discretization.BO)
        return float(torch.abs(f + 2.0)[0])

    assert residual(got) <= residual(torch.as_tensor(lam0))


def test_nsep_quasiperiodic_phase_shift():
    """2 exp(3.5 i t) with phase_shift pi has the spectrum of 2 exp(3 i t)
    shifted by -0.25 (tests/test_nsep.py bound 5e-4 on the main spectrum)."""
    q, t_span, kappa, main, aux, remove_box = nsep_plane_wave_case(1024,
                                                                   nu=3.5)
    res = tft.nsep(torch.as_tensor(q), t_span, kappa=kappa,
                   phase_shift=0.5 * 2 * np.pi, opts=_opts(tft, "MIXED"))
    em, _ = nsep_errors(res, main, aux, BOX, remove_box)
    assert em <= 5e-4, em


def test_nsep_complex64_in_complex64_out():
    """complex64 pipeline: the aux certificate takes complex64's eps, so
    the aux roots survive (tests/test_nsep.py:177), and both spectra come
    back in complex64."""
    q, t_span, *_ = nsep_plane_wave_case(256)
    res = tft.nsep(torch.as_tensor(q.astype(np.complex64)), t_span,
                   kappa=+1, opts=_opts(tft, "SUBSAMPLE_AND_REFINE",
                                        box=(-5.0, 5.0, -5.0, 5.0)))
    assert res.main_spectrum.dtype == res.aux_spectrum.dtype == torch.complex64
    assert res.aux_spectrum.numel() > 0
    j = np.arange(1, 50)
    sq = np.sqrt(4 - j * j / 4.0 + 0j)
    aux_e = np.concatenate([-1.5 + 1j * sq, -1.5 - 1j * sq])
    aux_e = aux_e[(np.abs(aux_e.real) < 5) & (np.abs(aux_e.imag) < 5)]
    aux = res.aux_spectrum.numpy()
    err = max(float(np.min(np.abs(aux - e))) for e in aux_e
              if abs(e.imag) > 0.3)
    assert err < 5e-3, err


def test_nsep_defocusing_main_only():
    """MIXED with kappa = -1 and want_aux=False leaves S&R no polynomial
    to solve; the grid search's main spectrum comes back
    (tests/test_nsep.py:167)."""
    res = tft.nsep(torch.ones(64, dtype=torch.complex128), (0.0, 2 * np.pi),
                   kappa=-1, want_aux=False)
    assert res.aux_spectrum is None
    assert res.main_spectrum is not None and res.main_spectrum.numel() > 0


def test_newton_evaluators_sliced_equal_unsliced(monkeypatch):
    """The Newton evaluators take lambda in slices of at most
    _LAM_BATCH_MATRICES step matrices; each lambda is independent, so the
    sliced result is bitwise the one-slice result."""
    rng = np.random.default_rng(5)
    d = 256
    q = torch.as_tensor(2.0 * np.exp(3j * (2 * np.pi / d) * np.arange(d)))
    lam = torch.as_tensor(rng.normal(size=37) + 1j * rng.normal(size=37))
    args = (q, -torch.conj(q), lam, 2 * np.pi / d, Discretization.BO)
    whole = [tnsep._eval_floquet(*args), tnsep._eval_b(*args)]
    calls = []
    orig = tnsep.scatter_matrix

    def counting(*a, **kw):
        calls.append(a[2].shape[0])
        return orig(*a, **kw)

    monkeypatch.setattr(tnsep, "scatter_matrix", counting)
    monkeypatch.setattr(tnsep, "_LAM_BATCH_MATRICES", 8 * d)
    sliced = [tnsep._eval_floquet(*args), tnsep._eval_b(*args)]
    assert calls == [8, 8, 8, 8, 5] * 2
    for got, ref in zip(sliced, whole):
        for g, r in zip(got, ref):
            assert torch.equal(torch.view_as_real(g), torch.view_as_real(r))


def test_nsep_opts_carried_over():
    ref = jft.NsepOpts(localization=jft.Localization.GRIDSEARCH,
                       filtering=jft.PointFilter.MANUAL,
                       bounding_box=(-3.0, 4.0, -1.0, 2.0), max_evals=7,
                       discretization=jft.Discretization.SPLIT4B,
                       floquet_range=(-0.5, 0.5), points_per_spine=4,
                       normalization_flag=False, dsub=256, tol=1e-9)
    got = compat.nsep_opts_from_reference(ref)
    assert isinstance(got, tft.NsepOpts)
    for field in dataclasses.fields(got):
        g, r = getattr(got, field.name), getattr(ref, field.name)
        if isinstance(g, tuple):
            assert g == tuple(r), field.name
        elif hasattr(g, "value"):
            assert type(g).__module__.startswith("fnft_tpu_torch")
            assert g.value == r.value, field.name
        else:
            assert g == r, field.name
    assert compat.nsep_opts_from_reference(jft.NsepOpts()) == tft.NsepOpts()


def test_nsep_array_on_cpu_by_request_and_no_cuda_default():
    q, t_span, *_ = nsep_plane_wave_case(64)
    opts = _opts(tft, "GRIDSEARCH")
    got = tft.nsep(q, t_span, opts=opts, device="cpu")
    ref = tft.nsep(torch.as_tensor(q), t_span, opts=opts)
    assert got.main_spectrum.device.type == "cpu"
    assert torch.equal(got.main_spectrum, ref.main_spectrum)
    assert torch.equal(got.aux_spectrum, ref.aux_spectrum)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tft.nsep(q, t_span, opts=opts)
