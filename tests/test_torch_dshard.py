"""The port's D-sharded fast NFT (``fnft_tpu_torch.parallel.dshard``) in a
gloo world of 4 CPU ranks, against the JAX package on the same inputs.

The twin of ``tests/test_dshard.py``. One world (module fixture,
``torch_dshard_worlds.contspec_world``) runs every case: the contspec of
the JAX tests' sech, a chirped sech and a seeded random signal (rho, a, b),
the 4SPLIT4A/B schemes, a (data, seq) batch, the grid-sharded chirp-Z,
kdvv, and the ``mesh=`` route of the batched contspec. Tolerances are the
JAX tests': 1e-11 against the unsharded transform (the butterfly
reassociates the chunk products), 1e-13 between a sharded run and a
replica of its own arithmetic (the port's replica, and the JAX package's
sharded program at the same S = 4 and its replica at S = 8), 1e-10
for the chirp-Z blocks, 1e-11 of the largest |rho| for kdvv.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import fnft_tpu
import fnft_tpu_torch
import fnft_tpu.parallel as jpar
import fnft_tpu_torch.parallel as tpar
from fnft_tpu.models.discretization import Discretization as JD
from fnft_tpu.models.kdvv import KdvvOpts
from fnft_tpu.models.nsev import ContspecType as JC
from fnft_tpu.ops.poly import chirpz as jchirpz
from fnft_tpu.parallel.dshard import dshard_contspec_reference as jreplica
from fnft_tpu_torch.models.discretization import Discretization as TD
from fnft_tpu_torch.models.nsev import ContspecType as TC
from fnft_tpu_torch.parallel.dshard import dshard_contspec_reference
from fnft_tpu_torch.parallel.mesh import mesh_shape, spawn

import torch_dshard_worlds as w

torch.set_num_threads(1)

SIGNALS = tuple(w.contspec_signals())


@pytest.fixture(scope="module")
def case():
    """(the world's per-rank results, the JAX oracles): the world runs in
    its own processes while this one computes the oracles."""
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn, w.contspec_world, w.WORLD)
        sigs = list(w.contspec_signals().values())
        ref = {}
        # the batched contspec (rho, a, b) of the three signals and the
        # four amplitudes' sechs in one call
        fn = jpar.make_nsev_batch_fn(w.CS_D, w.CS_T, w.CS_M, w.CS_XI,
                                     contspec_type=JC.BOTH)
        ref["unsharded"] = {k: np.asarray(v) for k, v in fn(jnp.asarray(
            np.stack(sigs + [w.sech(w.CS_D, a) for a in w.CS_AMPS]))).items()}
        replica = jax.jit(jax.vmap(lambda x: jreplica(
            x, w.CS_D, w.CS_T, w.CS_M, w.CS_XI, s=8, contspec_type=JC.BOTH)))
        ref["replica8"] = {k: np.asarray(v) for k, v in
                           replica(jnp.asarray(np.stack(sigs))).items()}
        mesh = Mesh(np.array(jax.devices()[:w.WORLD]), ("seq",))
        sharded = jpar.make_dshard_contspec(w.CS_D, w.CS_T, w.CS_M, w.CS_XI,
                                            mesh, contspec_type=JC.BOTH)
        ref["mesh"] = [{k: np.asarray(v) for k, v in sharded(q).items()}
                       for q in sigs]
        # one upsampled scheme and one kdvv scheme against the JAX package
        # (each of its programs takes ~4 s to compile here); the other
        # against the port's unsharded transform, which
        # tests/test_torch_nsev_schemes.py and test_torch_kdvv.py hold to it
        ref["SPLIT4B4"] = np.asarray(jpar.batched_nsev_contspec(
            w.sech(w.CS_D)[None], w.CS_T, w.CS_M, w.CS_XI,
            disc=JD.SPLIT4B4))[0]
        ref["SPLIT4A4"] = tpar.batched_nsev_contspec(
            torch.as_tensor(w.sech(w.CS_D)[None]), w.CS_T, w.CS_M, w.CS_XI,
            disc=TD.SPLIT4A4)[0].numpy()
        u = 3.2 / np.cosh(np.linspace(*w.KDV_T, w.KDV_D)) ** 2
        ref["kdvv_SPLIT8B"] = np.asarray(fnft_tpu.kdvv(
            jnp.asarray(u), w.KDV_T, m=w.KDV_M, xi_span=w.KDV_XI,
            opts=KdvvOpts(discretization=JD.SPLIT8B)).reflection_coefficient)
        ref["kdvv_SPLIT2A"] = fnft_tpu_torch.kdvv(
            torch.as_tensor(u), w.KDV_T, m=w.KDV_M, xi_span=w.KDV_XI,
            opts=fnft_tpu_torch.KdvvOpts(discretization=TD.SPLIT2A)
        ).reflection_coefficient.numpy()
        for i, (coeffs, a, wp, m) in enumerate(w.chirpz_inputs()):
            ref[("chirpz", "chirpz_batched")[i]] = np.asarray(
                jchirpz(jnp.asarray(coeffs), a, wp, m))
        return world.result(), ref


def _seq(world, key, field=None):
    """The full spectrum from the ranks' M/S blocks (seq mesh: rank =
    axis index)."""
    return np.concatenate([r[key] if field is None else r[key][field]
                           for r in world], axis=-1)


def _grid(world, key):
    """The full [B, M] from the (data, seq) = (2, 2) mesh's blocks."""
    rows = [np.concatenate([world[2 * i + j][key] for j in range(2)], -1)
            for i in range(2)]
    return np.concatenate(rows, axis=0)


def _replica(q, s, disc=TD.SPLIT4B, ct=TC.BOTH):
    """The port's single-process replica at S = ``s``."""
    return {k: v.numpy() for k, v in dshard_contspec_reference(
        torch.as_tensor(q), w.CS_D, w.CS_T, w.CS_M, w.CS_XI, s=s, disc=disc,
        contspec_type=ct).items()}


def test_mesh_shape_is_the_jax_packages():
    assert mesh_shape(8, 2) == (4, 2)
    assert mesh_shape(4, 2) == (2, 2)
    assert mesh_shape(6, 2) == (3, 2)
    assert mesh_shape(8, 1) == (8,)
    assert jpar.make_mesh(jax.devices()[:8], ("a", "b")).devices.shape \
        == mesh_shape(8, 2)


def test_all_names_ported():
    """Of ``fnft_tpu.__all__`` only the two names ROADMAP excludes by design
    are missing, and every public name of ``fnft_tpu.parallel`` exists."""
    missing = set(fnft_tpu.__all__) - set(fnft_tpu_torch.__all__)
    assert missing == {"nsev_fullspec_tpu", "use_x64"}
    public = {n for n in dir(jpar) if not n.startswith("_")}
    assert public - set(dir(tpar)) == set()


@pytest.mark.parametrize("name", SIGNALS)
def test_dshard_matches_unsharded(case, name):
    world, ref = case
    row = SIGNALS.index(name)
    rho = _seq(world, name, "rho")
    assert rho.shape == (w.CS_M,)
    np.testing.assert_allclose(rho, ref["unsharded"]["rho"][row], rtol=0,
                               atol=1e-11)


@pytest.mark.parametrize("name", SIGNALS)
def test_dshard_matches_singledevice_replica(case, name):
    """The world does the replica's floating-point work (port, S = 4);
    the port's replica at S = 8 is the JAX package's replica."""
    world, ref = case
    q = w.contspec_signals()[name]
    mine = _replica(q, 4)
    for key in ("rho", "a", "b"):
        np.testing.assert_allclose(_seq(world, name, key), mine[key],
                                   rtol=0, atol=1e-13)
    got, row = _replica(q, 8), SIGNALS.index(name)
    np.testing.assert_allclose(got["rho"], ref["replica8"]["rho"][row],
                               rtol=0, atol=1e-13)
    for key in ("a", "b"):
        np.testing.assert_allclose(got[key], ref["replica8"][key][row],
                                   rtol=0, atol=1e-11)


@pytest.mark.parametrize("name", SIGNALS)
def test_dshard_matches_jax_mesh(case, name):
    """The JAX package's sharded program on a 4-device mesh: the same chunk
    trees and butterfly at the same S."""
    world, ref = case
    jm = ref["mesh"][SIGNALS.index(name)]
    np.testing.assert_allclose(_seq(world, name, "rho"), jm["rho"], rtol=0,
                               atol=1e-13)
    for key in ("a", "b"):
        np.testing.assert_allclose(_seq(world, name, key), jm[key], rtol=0,
                                   atol=1e-11)


@pytest.mark.parametrize("name", SIGNALS)
def test_dshard_ab_normalization(case, name):
    """a and b need the exponent summed over the ranks: held to the
    unsharded a, b, and |a|^2 + |b|^2 = 1 (focusing)."""
    world, ref = case
    row = SIGNALS.index(name)
    a, b = _seq(world, name, "a"), _seq(world, name, "b")
    np.testing.assert_allclose(a, ref["unsharded"]["a"][row], rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(b, ref["unsharded"]["b"][row], rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(np.abs(a) ** 2 + np.abs(b) ** 2, 1.0,
                               atol=1e-6)


@pytest.mark.parametrize("disc", ["SPLIT4A4", "SPLIT4B4"])
def test_dshard_upsampled_schemes(case, disc):
    """4SPLIT4A/B: q gathered once for the stage resample, then sharded;
    4SPLIT4B against the JAX package's unsharded transform, 4SPLIT4A
    against the port's."""
    world, ref = case
    rho = _seq(world, disc)
    assert rho.shape == (w.CS_M,)
    np.testing.assert_allclose(rho, ref[disc], rtol=0, atol=1e-11)
    np.testing.assert_allclose(
        rho, _replica(w.sech(w.CS_D), 4, TD[disc],
                      TC.REFLECTION_COEFFICIENT)["rho"], rtol=0, atol=1e-13)


def test_dshard_batched(case):
    """(data, seq) mesh: the batch and the time axis sharded together."""
    world, ref = case
    rho = _grid(world, "batched")
    assert rho.shape == (4, w.CS_M)
    np.testing.assert_allclose(rho, ref["unsharded"]["rho"][len(SIGNALS):],
                               rtol=0, atol=1e-11)


def test_dshard_per_rank_tree_is_one_chunk(case):
    """Each rank's tree takes its own D/S samples only (the work drop the
    JAX test reads from XLA's cost analysis): three [D/4, 2, 2, 3] trees
    (2SPLIT4B, one a signal) in every rank."""
    for r in case[0]:
        assert r["trees"].tolist() == [[w.CS_D // w.WORLD, 2, 2, 3]] * 3


@pytest.mark.parametrize("key", ["chirpz", "chirpz_batched"])
def test_gridsharded_chirpz(case, key):
    world, ref = case
    got = _seq(world, key)
    assert got.shape == ref[key].shape
    np.testing.assert_allclose(got, ref[key], rtol=0, atol=1e-10)


@pytest.mark.parametrize("disc", ["SPLIT8B", "SPLIT2A"])
def test_dshard_kdvv_matches_driver(case, disc):
    """kdvv sharded: real-coefficient chunk trees, the negated grid (and
    2SPLIT2A's sqrt-z correction); 2SPLIT8B against the JAX kdvv driver,
    2SPLIT2A against the port's."""
    world, ref = case
    rho, want = _seq(world, "kdvv_" + disc), ref["kdvv_" + disc]
    assert rho.shape == (w.KDV_M,)
    np.testing.assert_allclose(rho, want, rtol=0,
                               atol=1e-11 * np.max(np.abs(want)))


def test_dshard_kdvv_batched(case):
    """(data, seq) mesh, each row against the port's kdvv driver (which
    tests/test_torch_kdvv.py holds to the JAX package's)."""
    rho = _grid(case[0], "kdvv_batched")
    assert rho.shape == (4, w.KDVB_M)
    t = np.linspace(*w.KDVB_T, w.KDVB_D)
    for i, amp in enumerate(w.KDVB_AMPS):
        want = fnft_tpu_torch.kdvv(
            amp / np.cosh(t) ** 2, w.KDVB_T, m=w.KDVB_M, xi_span=w.KDVB_XI,
            device="cpu").reflection_coefficient.numpy()
        np.testing.assert_allclose(rho[i], want, rtol=0,
                                   atol=1e-11 * np.max(np.abs(want)))


def test_mesh_route_returns_the_full_batch(case):
    """``make_nsev_batch_fn`` and ``batched_nsev_contspec`` with a mesh:
    each rank one row of the "batch" axis, every rank the full batch,
    held to the JAX package's batched contspec (as tests/test_parallel.py
    holds its own: rtol 1e-10)."""
    world, oracles = case
    ref = {k: v[len(SIGNALS):] for k, v in oracles["unsharded"].items()}
    for r in world:
        assert set(r["mesh_fn"]) == {"rho", "a", "b"}
        for key in ("rho", "a", "b"):
            assert r["mesh_fn"][key].shape == (4, w.CS_M)
            np.testing.assert_allclose(r["mesh_fn"][key], ref[key],
                                       rtol=1e-10, atol=1e-12)
        np.testing.assert_array_equal(r["mesh_rho"], r["mesh_fn"]["rho"])
        np.testing.assert_array_equal(r["mesh_fn"]["rho"],
                                      world[0]["mesh_fn"]["rho"])


def test_collectives_carry_gradients(case):
    """The gather's and the all-to-all's backward (``MeshAxis``): the
    cotangent summed over the axis and this rank's block kept; the
    transposed exchange (see ``torch_dshard_worlds.collective_grads``)."""
    n = w.WORLD
    wg = np.arange(6.0 * n).reshape(-1, 3)
    for j, r in enumerate(case[0]):
        gx, gy = r["collective_grads"]
        np.testing.assert_array_equal(gx, n * wg[2 * j:2 * j + 2])
        want = np.array([[(i + 1) * 2 * j, (i + 1) * (2 * j + 1)]
                         for i in range(n)])
        np.testing.assert_array_equal(gy, want)
