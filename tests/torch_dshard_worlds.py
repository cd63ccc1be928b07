"""Rank programs of the port's D-sharded tests (``tests/test_torch_dshard*``).

Each test file spawns one gloo world of 4 CPU ranks (one intra-op thread
each) in a module-scoped fixture, runs its program below in every rank
(``test_torch_dshard_train.py``: ``entry.dryrun_multichip``'s own) and
hands the per-rank results to its tests, which hold them against the JAX
package on the same numpy inputs. This module imports no JAX: the ranks
start from a fresh interpreter and import only torch and the port. The
inputs are made here from numpy (and seeds), so the tests and the ranks
build the same arrays.
"""

import numpy as np
import torch

import fnft_tpu_torch as tft
from fnft_tpu_torch.models import nse
from fnft_tpu_torch.models.discretization import Discretization
from fnft_tpu_torch.models.nsev import ContspecType
from fnft_tpu_torch.ops.fscatter import fscatter
from fnft_tpu_torch.parallel import (
    batched_nsep,
    batched_nsev_contspec,
    dshard,
    dshard_boundstates_reference,
    dshard_finvscatter,
    dshard_nsep_reference,
    make_dshard_boundstates,
    make_dshard_contspec,
    make_dshard_kdvv_contspec,
    make_dshard_nsep_refine,
    make_gridsharded_chirpz,
    make_mesh,
    make_nsev_batch_fn,
    make_sharded_polymatmul,
    MeshAxis,
    sharded_fft_reference,
)

WORLD = 4

# ---- test_torch_dshard.py: contspec, kdvv, grid chirp-Z, mesh= route ------

CS_D, CS_M = 2048, 512
CS_T, CS_XI = (-16.0, 16.0), (-1.5, 1.5)
KDV_D, KDV_M, KDV_T, KDV_XI = 1024, 256, (-16.0, 15.0), (-2.05, 2.15)
KDVB_D, KDVB_M, KDVB_T, KDVB_XI = 512, 128, (-12.0, 12.0), (-1.5, 1.5)


def sech(d, amp=3.2, t_span=CS_T):
    t = np.linspace(*t_span, d)
    return (1j * amp / np.cosh(t)).astype(np.complex128)


def contspec_signals() -> dict:
    """The sech of the JAX tests, a chirped sech and a seeded random complex
    signal under a Gaussian envelope: the last two are not symmetric in
    time, so a butterfly that swapped a left and a right product would
    show."""
    t = np.linspace(*CS_T, CS_D)
    rng = np.random.default_rng(8)
    noise = np.array([1.0, 1j]) @ rng.normal(size=(2, CS_D))
    return {"sech": sech(CS_D),
            "chirp": sech(CS_D, 2.1) * np.exp(0.15j * t * t),
            "random": (0.8 * noise * np.exp(-(t / 4) ** 2)).astype(
                np.complex128)}


CS_AMPS = (1.0, 2.0, 3.2, 4.1)
KDVB_AMPS = (1.1, 2.3, 0.7, 3.0)


def chirpz_inputs():
    rng = np.random.default_rng(7)
    single = rng.standard_normal(64) + 1j * rng.standard_normal(64)
    rng = np.random.default_rng(11)
    batched = rng.standard_normal((3, 48)) + 1j * rng.standard_normal((3, 48))
    return ((single, complex(np.exp(0.3j)),
             complex(np.exp(2j * np.pi / 512 * 0.9)), 512),
            (batched, complex(np.exp(-0.1j)),
             complex(np.exp(2j * np.pi / 256)), 256))


def contspec_world(rank, world):
    seq_mesh = make_mesh(("seq",))
    grid_mesh = make_mesh(("data", "seq"))            # (2, 2)
    batch_mesh = make_mesh(("batch",))
    out = {}
    # the chunk trees each rank runs, by the shape of their inputs
    trees = []
    tree = dshard.fmult2x2_tree

    def spied(p, **kw):
        trees.append(tuple(p.shape))
        return tree(p, **kw)

    dshard.fmult2x2_tree = spied
    try:
        for name, q in contspec_signals().items():
            out[name] = make_dshard_contspec(
                CS_D, CS_T, CS_M, CS_XI, seq_mesh,
                contspec_type=ContspecType.BOTH)(torch.as_tensor(q))
    finally:
        dshard.fmult2x2_tree = tree
    out["trees"] = np.array(trees)
    for disc in (Discretization.SPLIT4A4, Discretization.SPLIT4B4):
        out[disc.name] = make_dshard_contspec(
            CS_D, CS_T, CS_M, CS_XI, seq_mesh, disc=disc)(
                torch.as_tensor(sech(CS_D)))["rho"]
    qb = torch.as_tensor(np.stack([sech(CS_D, a) for a in CS_AMPS]))
    out["batched"] = make_dshard_contspec(CS_D, CS_T, CS_M, CS_XI, grid_mesh,
                                          batch_axis="data")(qb)["rho"]
    for key, (coeffs, a, w, m) in zip(("chirpz", "chirpz_batched"),
                                      chirpz_inputs()):
        out[key] = make_gridsharded_chirpz(coeffs.shape[-1], a, w, m,
                                           seq_mesh)(torch.as_tensor(coeffs))
    u = 3.2 / np.cosh(np.linspace(*KDV_T, KDV_D)) ** 2
    for disc in (Discretization.SPLIT8B, Discretization.SPLIT2A):
        out["kdvv_" + disc.name] = make_dshard_kdvv_contspec(
            KDV_D, KDV_T, KDV_M, KDV_XI, seq_mesh, disc=disc)(
                torch.as_tensor(u))["rho"]
    t = np.linspace(*KDVB_T, KDVB_D)
    us = np.stack([a / np.cosh(t) ** 2 for a in KDVB_AMPS])
    out["kdvv_batched"] = make_dshard_kdvv_contspec(
        KDVB_D, KDVB_T, KDVB_M, KDVB_XI, grid_mesh, batch_axis="data")(
            torch.as_tensor(us))["rho"]
    # the mesh= route: each rank its row of the batch, the full batch back
    out["mesh_fn"] = make_nsev_batch_fn(
        CS_D, CS_T, CS_M, CS_XI, contspec_type=ContspecType.BOTH,
        mesh=batch_mesh, device="cpu")(qb)
    out["mesh_rho"] = batched_nsev_contspec(qb, CS_T, CS_M, CS_XI,
                                            mesh=batch_mesh)
    out["collective_grads"] = collective_grads(MeshAxis(seq_mesh, "seq"))
    return out


def collective_grads(axis):
    """Gradients through the gather and the all-to-all: every rank's loss
    sum(wg * all_gather(x)) has the same weights, so x's gradient is the
    world size times its rows of wg; rank r's loss sum(wa_r * all_to_all(y))
    with wa_r = (r + 1) [0, 1, .., 2 S - 1] gives row r of rank j's y the
    gradient (r + 1) [2 j, 2 j + 1]."""
    x = torch.full((2, 3), float(axis.index), dtype=torch.float64,
                   requires_grad=True)
    y = torch.ones((axis.size, 2), dtype=torch.float64, requires_grad=True)
    wg = torch.arange(6.0 * axis.size, dtype=torch.float64).reshape(-1, 3)
    wa = (axis.index + 1) * torch.arange(2.0 * axis.size,
                                         dtype=torch.float64)[None]
    loss = ((wg * axis.all_gather(x, dim=0, tiled=True)).sum()
            + (wa * axis.all_to_all(y, 0, 1)).sum())
    loss.backward()
    return x.grad, y.grad


# ---- test_torch_dshard_boundstates.py --------------------------------------

BS_D, BS_T = 1 << 12, (-25.0, 25.0)
BS_LAM0 = np.array([0.03 + 0.65j, -0.04 + 1.66j, 0.02 + 2.75j])
BS_BOX = (-5.0, 5.0, 0.0, 10.0)


def boundstate_signals() -> dict:
    """The sech of the JAX tests and an asymmetric one: a frequency-shifted
    sech with a bump on one side, whose chunks are not mirror images."""
    t = np.linspace(*BS_T, BS_D)
    return {"sech": sech(BS_D, 3.2, BS_T),
            "asym": (3.2j * np.exp(0.4j * t) / np.cosh(t)
                     + 0.5 / np.cosh(2 * (t - 3))).astype(np.complex128)}


def boundstates_world(rank, world, lam_driver):
    """``lam_driver``: the port's nsev bound states of the sech (the
    single-process oracle of the niter = 0 pass)."""
    mesh = make_mesh(("seq",))
    eps_t = (BS_T[1] - BS_T[0]) / (BS_D - 1)
    base = Discretization.BO
    q = torch.as_tensor(sech(BS_D, 3.2, BS_T))
    q_eff, r_eff, _, _ = nse.preprocess_signal(q, eps_t, +1, base)
    out = {}
    fn0 = make_dshard_boundstates(BS_D, BS_T, mesh, disc=base, niter=0)
    out["scatter"] = fn0(q_eff, r_eff, torch.as_tensor(lam_driver),
                         (-np.inf, np.inf, -np.inf, np.inf))
    fn = make_dshard_boundstates(BS_D, BS_T, mesh, disc=base, niter=10)
    out["newton"] = fn(q_eff, r_eff, torch.as_tensor(BS_LAM0), BS_BOX)[0]
    for name, sig in boundstate_signals().items():
        out["pipeline_" + name] = dshard_boundstates_reference(
            torch.as_tensor(sig), BS_T, mesh)
    return out


# ---- test_torch_dshard_nsep.py ---------------------------------------------

NSEP_BOX = (-5.0, 5.0, -5.0, 5.0)
NSEP_AMPS = (1.0, 0.8, 1.2, 0.9)
NSEP_BATCH_D = 256


def plane_wave(d):
    t_span = (0.0, 2 * np.pi)
    t = (t_span[1] - t_span[0]) / d * np.arange(d)
    q = 2.0 * np.exp(3j * t)
    j = np.arange(50)
    sq = np.sqrt(4 - j * j / 4.0 + 0j)
    ms = np.concatenate([-1.5 + 1j * sq, -1.5 - 1j * sq])
    ja = np.arange(1, 50)
    sqa = np.sqrt(4 - ja * ja / 4.0 + 0j)
    aux = np.concatenate([-1.5 + 1j * sqa, -1.5 - 1j * sqa])
    return q, t_span, ms, aux


def nsep_opts(max_evals=20):
    return tft.NsepOpts(localization=tft.Localization.SUBSAMPLE_AND_REFINE,
                        filtering=tft.PointFilter.MANUAL,
                        bounding_box=NSEP_BOX,
                        discretization=Discretization.SPLIT2A,
                        max_evals=max_evals)


def nsep_batch():
    t = 2 * np.pi / NSEP_BATCH_D * np.arange(NSEP_BATCH_D)
    return np.stack([a * np.exp(2j * t) for a in NSEP_AMPS])


def nsep_world(rank, world, refine_inputs):
    """``refine_inputs``: (lam0 main, rhs, lam0 aux) of the refinement
    case at D = 1024, made by the test."""
    mesh = make_mesh(("seq",))
    batch_mesh = make_mesh(("batch",))
    out = {}
    d = 1 << 10
    q, t_span, _, _ = plane_wave(d)
    eps_t = (t_span[1] - t_span[0]) / d
    base = nse.newton_base_discretization(Discretization.SPLIT2A)
    q_eff, r_eff, _, _ = nse.preprocess_signal(
        torch.as_tensor(q), eps_t, +1, Discretization.SPLIT2A)
    refine_main, refine_aux = make_dshard_nsep_refine(
        d, mesh, eps_t=eps_t, base_disc=base, iters_main=9, iters_aux=20)
    lam0, rhs, lam0a = (torch.as_tensor(x) for x in refine_inputs)
    out["refine_main"] = refine_main(q_eff, r_eff, lam0, rhs, 1e-14)
    out["refine_aux"] = refine_aux(q_eff, r_eff, lam0a, 1e-14)
    out["driver"] = dshard_nsep_reference(torch.as_tensor(q), t_span, mesh,
                                          opts=nsep_opts())
    q9, t9, _, _ = plane_wave(1 << 9)
    out["no_refine"] = dshard_nsep_reference(torch.as_tensor(q9), t9, mesh,
                                             opts=nsep_opts(max_evals=0))
    try:
        make_dshard_nsep_refine(10, mesh, eps_t=0.1, base_disc=base,
                                iters_main=1, iters_aux=1)
        out["indivisible"] = "accepted"
    except ValueError as err:
        out["indivisible"] = str(err)
    res = batched_nsep(torch.as_tensor(nsep_batch()), (0.0, 2 * np.pi),
                       mesh=batch_mesh)
    out["mesh_nsep"] = (res.main_spectrum, res.main_mask, res.aux_spectrum,
                        res.aux_mask)
    return out


# ---- test_torch_dshard_inverse.py ------------------------------------------

FFT_LENGTHS = (256, 1024, 4096)
MM_SHAPES = ((513, 1025), (257, 257))
INV_D = 1 << 12


def fft_inputs():
    out = {}
    for length in FFT_LENGTHS:
        rng = np.random.default_rng(0)
        out[length] = rng.normal(size=length) + 1j * rng.normal(size=length)
    rng = np.random.default_rng(1)
    out["batched"] = (rng.normal(size=(3, 2, 512))
                      + 1j * rng.normal(size=(3, 2, 512)))
    return out


def polymatmul_inputs():
    rng = np.random.default_rng(2)
    return {(ca, cb): (rng.normal(size=(2, 2, ca)) + 1j * rng.normal(
        size=(2, 2, ca)), rng.normal(size=(2, 2, cb)) + 1j * rng.normal(
        size=(2, 2, cb))) for ca, cb in MM_SHAPES}


def inverse_signal():
    rng = np.random.default_rng(3)
    q = (rng.normal(size=INV_D) + 1j * rng.normal(size=INV_D)) * 0.25
    return q, 50.0 / (INV_D - 1)


def inverse_transfer_matrix(kappa):
    q, eps_t = inverse_signal()
    qt = torch.as_tensor(q)
    tm, _ = fscatter(qt, -kappa * torch.conj(qt), eps_t,
                     Discretization.SPLIT2A, normalize=False)
    return tm


def inverse_world(rank, world):
    mesh = make_mesh(("seq",))
    out = {}
    for key, x in fft_inputs().items():
        out[f"fft_{key}"] = sharded_fft_reference(torch.as_tensor(x), mesh)
    for (ca, cb), (a, b) in polymatmul_inputs().items():
        out[f"mm_{ca}_{cb}"] = make_sharded_polymatmul(ca, cb, mesh)(
            torch.as_tensor(a), torch.as_tensor(b))
    _, eps_t = inverse_signal()
    for kappa in (+1, -1):
        out[f"finv_{kappa}"] = dshard_finvscatter(
            inverse_transfer_matrix(kappa), eps_t, kappa, mesh,
            min_sharded_deg=1024)
    return out


# ---- test_torch_cuda.py: the sharded contspec on the card ------------------

CUDA_D = 4096


def cuda_world(rank, world):
    """The sharded contspec (rho, a, b) at D = M = 4096 on CUDA tensors and
    on CPU tensors in the same ranks: gloo stages the CUDA blocks through
    the host, the CPU ones travel as they are."""
    mesh = make_mesh(("seq",))
    fn = make_dshard_contspec(CUDA_D, CS_T, CUDA_D, CS_XI, mesh,
                              contspec_type=ContspecType.BOTH)
    q = sech(CUDA_D)
    return {dev: fn(torch.as_tensor(q, device=dev)) for dev in ("cuda", "cpu")}
