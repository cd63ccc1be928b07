"""The port's D-sharded discrete spectrum
(``fnft_tpu_torch.parallel.dshard_boundstates``) in a gloo world of 4 CPU
ranks, against the JAX package and the port's single-process driver.

The twin of ``tests/test_dshard_boundstates.py``, at its D = 4096 (its
D = 2^16 case is gated there as minutes long; ``chip_smoke.py`` runs it on
the card). One world (module fixture) runs every case. Tolerances are the
JAX tests': the chunk products reassociate the floating-point products,
so a, a' agree to 1e-10 relative (1e-12 absolute) and b to 1e-9 (1e-11);
refined bound states, Newton fixed points, to 1e-10; the full pipeline's
bound states to 1e-9 and norming constants to 1e-7 relative (1e-9
absolute) of the reference driver. Besides the JAX tests' sech, the
pipeline runs on a frequency-shifted sech with a bump on one side, so that
the chunks' order shows.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fnft_tpu as ft
import fnft_tpu_torch as tft
from fnft_tpu.models import nse as jnse
from fnft_tpu.models.discretization import Discretization as JD
from fnft_tpu.models.nsev import _newton_refine as jnewton
from fnft_tpu.ops.scatter import scatter_bound_states as jscatter
from fnft_tpu_torch.models import nse
from fnft_tpu_torch.models.discretization import Discretization as TD
from fnft_tpu_torch.models.nsev import _newton_refine
from fnft_tpu_torch.ops.scatter import scatter_bound_states
from fnft_tpu_torch.parallel.mesh import spawn

import torch_dshard_worlds as w

torch.set_num_threads(1)

EPS_T = (w.BS_T[1] - w.BS_T[0]) / (w.BS_D - 1)


def _port_driver(q):
    res = tft.nsev(torch.as_tensor(q), w.BS_T, m=0, opts=tft.NsevOpts(
        discspec_type=tft.DiscspecType.NORMING_CONSTANTS))
    return res.bound_states.numpy(), res.norming_constants.numpy()


@pytest.fixture(scope="module")
def case():
    """(world results, oracles): the world runs while the JAX package
    computes its references."""
    lam_driver = _port_driver(w.sech(w.BS_D, 3.2, w.BS_T))[0]
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, w.boundstates_world, w.WORLD, lam_driver)
        ref = {"lam_driver": lam_driver}
        q = jnp.asarray(w.sech(w.BS_D, 3.2, w.BS_T))
        q_eff, r_eff, _, _ = jnse.preprocess_signal(q, EPS_T, +1, JD.BO)
        ref["scatter"] = [np.asarray(x) for x in jscatter(
            q_eff, r_eff, jnp.asarray(lam_driver), EPS_T, w.BS_T[0],
            w.BS_T[1], JD.BO, skip_b=False)]
        ref["newton"] = np.asarray(jnewton(
            q_eff, r_eff, jnp.asarray(w.BS_LAM0), EPS_T, w.BS_T[0],
            w.BS_T[1], JD.BO, 10, w.BS_BOX))
        for name, sig in w.boundstate_signals().items():
            res = ft.nsev(jnp.asarray(sig), w.BS_T, m=0, kappa=+1,
                          opts=ft.NsevOpts(
                              discspec_type=ft.DiscspecType.NORMING_CONSTANTS))
            ref["jax_" + name] = (np.asarray(res.bound_states),
                                  np.asarray(res.norming_constants))
            ref["port_" + name] = _port_driver(sig)
        return world.result(), ref


def _by_imag(lam, nc):
    order = np.argsort(lam.imag)
    return lam[order], nc[order]


def test_sharded_scatter_matches_single_device(case):
    """a, a' and b from the sharded pass with niter = 0 (no Newton step) at
    the driver's bound states, against ``scatter_bound_states`` of both
    packages on the same lambdas (b is well defined only where phi and psi
    are proportional: at refined bound states)."""
    world, ref = case
    q = torch.as_tensor(w.sech(w.BS_D, 3.2, w.BS_T))
    q_eff, r_eff, _, _ = nse.preprocess_signal(q, EPS_T, +1, TD.BO)
    lam = torch.as_tensor(ref["lam_driver"])
    mine = [x.numpy() for x in scatter_bound_states(
        q_eff, r_eff, lam, EPS_T, w.BS_T[0], w.BS_T[1], TD.BO, skip_b=False)]
    for r in world:
        lam2, a2, ap2, b2 = r["scatter"]
        np.testing.assert_array_equal(lam2, ref["lam_driver"])
        for got, port, jax_, rtol, atol in (
                (a2, mine[0], ref["scatter"][0], 1e-10, 1e-12),
                (ap2, mine[1], ref["scatter"][1], 1e-10, 1e-12),
                (b2, mine[2], ref["scatter"][2], 1e-9, 1e-11)):
            np.testing.assert_allclose(got, port, rtol=rtol, atol=atol)
            np.testing.assert_allclose(got, jax_, rtol=rtol, atol=atol)


def test_sharded_newton_refines_like_driver(case):
    """The sharded Newton sweeps from perturbed starts land on the bound
    states of the single-process Newton of both packages."""
    world, ref = case
    q = torch.as_tensor(w.sech(w.BS_D, 3.2, w.BS_T))
    q_eff, r_eff, _, _ = nse.preprocess_signal(q, EPS_T, +1, TD.BO)
    mine = _newton_refine(q_eff, r_eff, torch.as_tensor(w.BS_LAM0), EPS_T,
                          w.BS_T[0], w.BS_T[1], TD.BO, 10, w.BS_BOX).numpy()
    for r in world:
        np.testing.assert_allclose(r["newton"], ref["newton"], rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(r["newton"], mine, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", ["sech", "asym"])
def test_full_pipeline_matches_driver(case, name):
    """dshard_boundstates_reference against the nsev discrete spectrum of
    both packages (SUBSAMPLE_AND_REFINE, norming constants); every rank
    returns the same spectrum."""
    world, ref = case
    bs, nc = _by_imag(*world[0]["pipeline_" + name])
    for r in world[1:]:
        np.testing.assert_array_equal(r["pipeline_" + name][0],
                                      world[0]["pipeline_" + name][0])
    for oracle in ("jax_", "port_"):
        ref_bs, ref_nc = _by_imag(*ref[oracle + name])
        assert bs.size == ref_bs.size >= 2, (oracle, bs, ref_bs)
        np.testing.assert_allclose(bs, ref_bs, rtol=0, atol=1e-9)
        np.testing.assert_allclose(nc, ref_nc, rtol=1e-7, atol=1e-9)
    if name == "sech":
        assert bs.size == 3
