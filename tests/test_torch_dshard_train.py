"""The port's sharded NFDM inverse-design training step and dry run
(``fnft_tpu_torch.entry.dryrun_multichip``) in a gloo world of 4 CPU
ranks, against the unsharded gradient of both packages and the JAX
package's sharded transforms.

The twin of ``__graft_entry__.dryrun_multichip``: B = 4 signals at
D = M = 256 on a (data 2, seq 2) mesh, then the bound-state refinement, the
nsep refinement, the 4SPLIT4B and kdvv contspecs and the inverse on a seq
mesh of the 4 ranks. One world (module fixture) runs it all:
``dryrun_multichip(4, device="cpu")``, ``entry.dryrun_rank`` in every
rank. Tolerances: the gradient of the
first step to 1e-9 of its largest component against the port's unsharded
gradient (``entry.rho_pipeline``) and against ``jax.grad`` of
``__graft_entry__._rho_pipeline``, as tests/test_torch_grad.py holds the
unsharded ones (the butterfly's exchanges carry the cotangents of every
chunk but the rank's own: without them the gradient would be zero there);
the loss to 1e-12 relative; the other transforms at the JAX dshard tests'
bounds (bound states 1e-10, a and a' 1e-10 relative, b 1e-9; the aux
Newton 1e-8; contspecs 1e-11).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import fnft_tpu as ft
from __graft_entry__ import _rho_pipeline
from fnft_tpu.models import nse as jnse
from fnft_tpu.models.discretization import Discretization as JD
from fnft_tpu.parallel.dshard_boundstates import make_dshard_boundstates
from fnft_tpu.parallel.dshard_nsep import make_dshard_nsep_refine
from fnft_tpu.parallel.sharding import batched_nsev_contspec
from fnft_tpu_torch.entry import (dryrun_batch, dryrun_multichip,
                                  rho_pipeline)
from fnft_tpu_torch.models import nse
from fnft_tpu_torch.models import nsep as tm
from fnft_tpu_torch.models.discretization import Discretization as TD

import torch_dshard_worlds as w

torch.set_num_threads(1)

B, D = 4, 256   # the dry run's batch and size on 4 ranks, (data 2, seq 2)
T_SPAN, XI_SPAN = (-8.0, 8.0), (-2.0, 2.0)


def _loss_terms(q0):
    """(params [2, B, D], target [B, M]) of the step: the target the
    spectra of the batch rolled by 3 samples."""
    return np.stack([q0.real, q0.imag]), np.roll(q0, 3, axis=-1)


@pytest.fixture(scope="module")
def case():
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(dryrun_multichip, w.WORLD, device="cpu")
        ref = {}
        q0 = dryrun_batch(B, D)
        p0, rolled = _loss_terms(q0)
        rho = _rho_pipeline(D, D, T_SPAN, XI_SPAN)
        tgt = jax.jit(rho)(jnp.asarray(rolled))

        def loss(p):
            return jnp.sum(jnp.abs(rho(p[0] + 1j * p[1]) - tgt) ** 2) / (B * D)

        val, grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(p0))
        ref["loss"], ref["grad"] = float(val), np.asarray(grad)

        mesh = Mesh(np.array(jax.devices()[:w.WORLD]), ("seq",))
        d_bs, t_bs = 512, (-12.0, 12.0)
        q_bs = jnp.asarray(1.7j / np.cosh(np.linspace(*t_bs, d_bs)))
        q_eff, r_eff, _, _ = jnse.preprocess_signal(q_bs, 24.0 / (d_bs - 1),
                                                    +1, JD.BO)
        fn = make_dshard_boundstates(d_bs, t_bs, mesh, disc=JD.BO, niter=3)
        ref["bound_states"] = [np.asarray(x) for x in fn(
            q_eff, r_eff, jnp.asarray([0.01 + 0.68j, -0.01 + 1.72j]),
            np.array([-5.0, 5.0, 0.0, 10.0]))]
        qp_eff, rp_eff, eps_p, base_p = _plane_wave_512(jnse, JD, jnp)
        _, raux = make_dshard_nsep_refine(512, mesh, eps_t=eps_p,
                                          base_disc=base_p, iters_main=2,
                                          iters_aux=3)
        ref["nsep_aux"] = np.asarray(raux(
            qp_eff, rp_eff, jnp.asarray([-1.5 + 1.93j, -1.5 + 1.73j]), 1e-6))
        t = np.linspace(*T_SPAN, D)
        ref["rho_4split4b"] = np.asarray(batched_nsev_contspec(
            (1.1j / np.cosh(t))[None], T_SPAN, D, XI_SPAN,
            disc=JD.SPLIT4B4))[0]
        ref["rho_kdvv"] = np.asarray(ft.kdvv(
            jnp.asarray(2.0 / np.cosh(t) ** 2), T_SPAN, m=D,
            xi_span=(-1.5, 1.5)).reflection_coefficient)
        return world.result(), ref


def _plane_wave_512(nse_mod, disc, xnp):
    """The dry run's nsep case in either package: (q_eff, r_eff, eps_t,
    the Newton base of 2SPLIT2A)."""
    d, t_span = 512, (0.0, 2 * np.pi)
    eps = (t_span[1] - t_span[0]) / d
    q = xnp.asarray(2.0 * np.exp(3j * eps * np.arange(d)))
    base = nse_mod.newton_base_discretization(disc.SPLIT2A)
    q_eff, r_eff, _, _ = nse_mod.preprocess_signal(q, eps, +1, base)
    return q_eff, r_eff, eps, base


def _grid_blocks(world, key):
    """The full [2, B, D] parameters (or gradient) from the blocks of the
    (data, seq) = (2, 2) mesh, rank = 2 data + seq."""
    rows = [np.concatenate([world[2 * i + j]["train"][key] for j in range(2)],
                           axis=-1) for i in range(2)]
    return np.concatenate(rows, axis=1)


def _rel(got, ref) -> float:
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def test_sharded_gradient_matches_unsharded(case):
    world, ref = case
    q0 = dryrun_batch(B, D)
    p0, rolled = _loss_terms(q0)
    rho = rho_pipeline(D, D, T_SPAN, XI_SPAN, device="cpu")
    with torch.no_grad():
        tgt = rho(torch.as_tensor(rolled))
    p = torch.tensor(p0, requires_grad=True)
    loss = torch.sum(torch.abs(rho(p[0] + 1j * p[1]) - tgt) ** 2) / (B * D)
    loss.backward()
    loss = float(loss.detach())
    grad = _grid_blocks(world, "grad")
    assert grad.shape == (2, B, D)
    assert _rel(grad, p.grad.numpy()) <= 1e-9
    assert _rel(grad, ref["grad"]) <= 1e-9
    # every rank's block carries gradient (the exchanges' backward)
    for r in world:
        assert np.max(np.abs(r["train"]["grad"])) > 1e-3 * np.max(
            np.abs(grad))
    for r in world:
        assert abs(r["train"]["loss"] - loss) <= 1e-12 * loss
        assert abs(r["train"]["loss"] - ref["loss"]) <= 1e-12 * ref["loss"]


def test_adam_step_moves_each_block(case):
    """Adam (lr 1e-2) moved every rank's block, by at most lr a component
    (Adam's first step is lr times the sign of the gradient)."""
    world, _ = case
    p0, _ = _loss_terms(dryrun_batch(B, D))
    moved = _grid_blocks(world, "params") - p0
    assert np.max(np.abs(moved)) <= 1e-2 * (1 + 1e-12)
    for i in range(2):
        for j in range(2):
            blk = moved[:, 2 * i:2 * i + 2, j * D // 2:(j + 1) * D // 2]
            assert np.max(np.abs(blk)) > 0


def test_dryrun_bound_states_match_jax(case):
    world, ref = case
    for r in world:
        for got, want, rtol in zip(r["bound_states"], ref["bound_states"],
                                   (0, 1e-10, 1e-10, 1e-9)):
            np.testing.assert_allclose(got, want, rtol=rtol,
                                       atol=1e-10 if rtol == 0 else 1e-12)


def test_dryrun_nsep_refine(case):
    """The aux Newton against the JAX package's sharded one; the main
    Newton (two sweeps from points that do not converge in them) against
    the port's single-process sweep, as the two packages return an
    unconverged point's least-residual iterate and its last one."""
    world, ref = case
    qp_eff, rp_eff, eps_p, base_p = _plane_wave_512(nse, TD, torch)
    lam = torch.tensor([-1.5 + 1.93j, -1.5 + 1.73j], dtype=torch.complex128)
    want_m = tm._mainspec_newton_sweep(
        lambda x, _: tm._eval_floquet(qp_eff, rp_eff, x, eps_p, base_p),
        lam, torch.tensor([2.0, -2.0], dtype=torch.float64), 1e-6, 2).numpy()
    for r in world:
        np.testing.assert_allclose(r["nsep_aux"], ref["nsep_aux"], rtol=0,
                                   atol=1e-8)
        np.testing.assert_allclose(r["nsep_main"], want_m, rtol=0, atol=1e-8)


def test_dryrun_contspecs_and_inverse(case):
    world, ref = case
    rho_u = np.concatenate([r["rho_4split4b"] for r in world])
    np.testing.assert_allclose(rho_u, ref["rho_4split4b"], rtol=0, atol=1e-11)
    rho_k = np.concatenate([r["rho_kdvv"] for r in world])
    np.testing.assert_allclose(rho_k, ref["rho_kdvv"], rtol=0,
                               atol=1e-11 * np.max(np.abs(ref["rho_kdvv"])))
    for r in world:
        assert r["inverse_err"] < 1e-12
