"""The port's D-sharded nsep refinement
(``fnft_tpu_torch.parallel.dshard_nsep``) and the ``mesh=`` route of the
batched nsep, in a gloo world of 4 CPU ranks.

The twin of ``tests/test_dshard_nsep.py`` (its D = 2^16 case is gated
there as minutes long; ``chip_smoke.py`` runs it on the card). One world
(module fixture) runs every case on the plane wave (closed-form spectrum,
fnft__nsep_testcases.c:118-151). Tolerances:

- the sharded Newton against the single-process sweeps of both packages
  on the same perturbed candidates: 2e-6 for the main spectrum (band
  edges are double roots of Delta +- 2, so fixed points agree to the
  square root of the chunk products' reassociation noise, as the JAX test
  says), 1e-8 for the aux spectrum (simple roots), and a residual
  |Delta + rhs| < 1e-10;
- the sharded S&R driver against the port's own ``nsep``: the JAX test's
  1e-5 (main, Hausdorff, the slow cluster at -1.5 left out as there) and
  1e-12 (aux); against ``fnft_tpu.nsep``: 5e-4 main and 1e-7 aux, the
  tolerances of tests/test_torch_batch_nsep.py, because an unconverged
  main-spectrum point ends at its least-residual iterate in the port and
  at its last one in the JAX package (ROADMAP, known differences);
- without refinement (max_evals = 0) the candidates are the replicated
  localization's: equal to the port's driver's to 1e-13, and as many as
  the JAX package's, within 1e-6 of them outside the slow cluster (the
  unrefined band edges are double roots, split by ~sqrt(eps), which the
  two packages' Aberth runs round differently; in the cluster, a fourfold
  point, they part by 1.4e-5);
- the batched nsep with a mesh (each rank one signal) against the port's
  batched nsep of the whole batch on one process: masks equal, points to
  1e-8 (as the batched nsep is held to the per-signal driver).
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fnft_tpu as ft
import fnft_tpu_torch as tft
from fnft_tpu.models import nse as jnse
from fnft_tpu.models import nsep as jm
from fnft_tpu_torch.models import nse
from fnft_tpu_torch.models import nsep as tm
from fnft_tpu_torch.parallel import batched_nsep
from fnft_tpu_torch.parallel.mesh import spawn

import torch_dshard_worlds as w

torch.set_num_threads(1)

D = 1 << 10


def _setup(d):
    q, t_span, ms, aux = w.plane_wave(d)
    eps_t = (t_span[1] - t_span[0]) / d
    return q, t_span, ms, aux, eps_t


def _refine_inputs():
    """Exact spectrum points perturbed off the fixed point, each main one
    with its spine value (Delta(lam) = +-2 at a main-spectrum point)."""
    q, _, ms, aux, eps_t = _setup(D)
    q_eff, r_eff, _, _ = nse.preprocess_signal(
        torch.as_tensor(q), eps_t, +1, tft.Discretization.SPLIT2A)
    base = nse.newton_base_discretization(tft.Discretization.SPLIT2A)
    rng = np.random.default_rng(7)
    lam_m = ms[np.abs(ms.imag) > 0.3][:6]
    delta, _ = tm._eval_floquet(q_eff, r_eff, torch.as_tensor(lam_m), eps_t,
                                base)
    rhs = -np.where(delta.real.numpy() > 0, 2.0, -2.0)
    lam0 = lam_m + 1e-3 * (rng.standard_normal(6)
                           + 1j * rng.standard_normal(6))
    lam0a = aux[np.abs(aux.imag) > 0.3][:4] + 0.01 * (
        rng.standard_normal(4) + 1j * rng.standard_normal(4))
    return lam0, rhs, lam0a


def _jax_opts(max_evals=20):
    return ft.NsepOpts(localization=ft.Localization.SUBSAMPLE_AND_REFINE,
                       filtering=ft.PointFilter.MANUAL,
                       bounding_box=w.NSEP_BOX,
                       discretization=ft.Discretization.SPLIT2A,
                       max_evals=max_evals)


@pytest.fixture(scope="module")
def case():
    inputs = _refine_inputs()
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, w.nsep_world, w.WORLD, inputs)
        ref = {"inputs": inputs}
        q, t_span, _, _, eps_t = _setup(D)
        q_eff, r_eff, _, _ = jnse.preprocess_signal(
            jnp.asarray(q), eps_t, +1, ft.Discretization.SPLIT2A)
        base = jnse.newton_base_discretization(ft.Discretization.SPLIT2A)
        lam0, rhs, lam0a = inputs
        ref["jax_main"] = np.asarray(jm._refine_mainspec_loop(
            q_eff, r_eff, jnp.asarray(lam0), jnp.asarray(rhs),
            jnp.asarray(1e-14), float(eps_t), 9, base))
        ref["jax_aux"] = np.asarray(jm._refine_auxspec_loop(
            q_eff, r_eff, jnp.asarray(lam0a), jnp.asarray(1e-14),
            float(eps_t), 20, base))
        res = ft.nsep(jnp.asarray(q), t_span, kappa=+1, opts=_jax_opts())
        ref["jax_driver"] = (np.asarray(res.main_spectrum),
                             np.asarray(res.aux_spectrum))
        q9, t9, _, _, _ = _setup(1 << 9)
        res = ft.nsep(jnp.asarray(q9), t9, kappa=+1, opts=_jax_opts(0))
        ref["jax_no_refine"] = (np.asarray(res.main_spectrum),
                                np.asarray(res.aux_spectrum))
        return world.result(), ref


def _hausdorff(a, b) -> float:
    d = np.abs(a[:, None] - b[None, :])
    return float(max(d.min(axis=1).max(), d.min(axis=0).max()))


def _rm_cluster(v):
    """The reference's remove box around the slow cluster at -1.5
    (test_fnft_nsep.c), as the JAX test has it."""
    mask = ((np.real(v) > -1.6) & (np.real(v) < -1.4)
            & (np.imag(v) > -0.1) & (np.imag(v) < 0.1))
    return v[~mask]


def test_sharded_refine_matches_single_device(case):
    world, ref = case
    q, _, _, _, eps_t = _setup(D)
    q_eff, r_eff, _, _ = nse.preprocess_signal(
        torch.as_tensor(q), eps_t, +1, tft.Discretization.SPLIT2A)
    base = nse.newton_base_discretization(tft.Discretization.SPLIT2A)
    lam0, rhs, lam0a = (torch.as_tensor(x) for x in ref["inputs"])
    mine_m = tm._mainspec_newton_sweep(
        lambda lam, _: tm._eval_floquet(q_eff, r_eff, lam, eps_t, base),
        lam0, rhs, 1e-14, 9).numpy()
    mine_a = tm._auxspec_newton_sweep(
        lambda lam, _: tm._eval_b(q_eff, r_eff, lam, eps_t, base),
        lam0a, 1e-14, 20).numpy()
    for r in world:
        got_m, got_a = r["refine_main"], r["refine_aux"]
        assert np.max(np.abs(got_m - mine_m)) < 2e-6, (got_m, mine_m)
        assert np.max(np.abs(got_m - ref["jax_main"])) < 2e-6
        resid, _ = tm._eval_floquet(q_eff, r_eff, torch.as_tensor(got_m),
                                    eps_t, base)
        assert np.max(np.abs(resid.numpy() + ref["inputs"][1])) < 1e-10
        assert np.max(np.abs(got_a - mine_a)) < 1e-8, (got_a, mine_a)
        assert np.max(np.abs(got_a - ref["jax_aux"])) < 1e-8


def test_dshard_nsep_driver_equivalence(case):
    """The sharded S&R driver against both packages' nsep and the closed
    form."""
    world, ref = case
    q, t_span, ms_exact, _, _ = _setup(D)
    port = tft.nsep(torch.as_tensor(q), t_span, opts=w.nsep_opts())
    port_m, port_a = port.main_spectrum.numpy(), port.aux_spectrum.numpy()
    for r in world:
        main, aux = r["driver"]
        assert main.size and aux.size
        assert _hausdorff(_rm_cluster(main), _rm_cluster(port_m)) < 1e-5
        assert _hausdorff(aux, port_a) < 1e-12
        assert _hausdorff(_rm_cluster(main),
                          _rm_cluster(ref["jax_driver"][0])) < 5e-4
        assert _hausdorff(aux, ref["jax_driver"][1]) < 1e-7
    main = world[0]["driver"][0]
    exact = ms_exact[(np.abs(ms_exact.real) < 5) & (np.abs(ms_exact.imag) < 5)]
    err = max(float(np.min(np.abs(main - e))) for e in exact
              if np.abs(e.real + 1.5) > 0.2 or np.abs(e.imag) > 0.2)
    assert err < 5e-2, err


def test_dshard_nsep_max_evals_zero_matches_driver(case):
    """max_evals == 0 turns the refinement off on both paths: the
    unrefined candidates of the replicated localization."""
    world, ref = case
    q, t_span, _, _, _ = _setup(1 << 9)
    port = tft.nsep(torch.as_tensor(q), t_span,
                    opts=w.nsep_opts(max_evals=0))
    for r in world:
        for got, mine, jax_ in zip(r["no_refine"],
                                   (port.main_spectrum, port.aux_spectrum),
                                   ref["jax_no_refine"]):
            np.testing.assert_allclose(got, mine.numpy(), rtol=0, atol=1e-13)
            assert got.size == jax_.size
            assert _hausdorff(_rm_cluster(got), _rm_cluster(jax_)) < 1e-6


def test_dshard_nsep_rejects_indivisible(case):
    for r in case[0]:
        assert "must split into 4 whole-sample chunks" in r["indivisible"]


def test_batched_nsep_mesh_route(case):
    """``batched_nsep`` with a "batch" mesh: every rank gets the full
    batch, equal to the single-process batch."""
    world, _ = case
    res = batched_nsep(torch.as_tensor(w.nsep_batch()), (0.0, 2 * np.pi))
    want = [x.numpy() for x in (res.main_spectrum, res.main_mask,
                                res.aux_spectrum, res.aux_mask)]
    for r in world:
        main, mmask, aux, amask = r["mesh_nsep"]
        np.testing.assert_array_equal(mmask, want[1])
        np.testing.assert_array_equal(amask, want[3])
        np.testing.assert_allclose(main[mmask], want[0][want[1]], rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(aux[amask], want[2][want[3]], rtol=0,
                                   atol=1e-8)
