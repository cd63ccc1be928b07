"""The batched transforms of the PyTorch port (``fnft_tpu_torch.parallel``:
contspec, full spectrum, inverse) and the batch axis of the layers below
them, against the JAX package's batched functions and the port's
per-signal drivers. Same numpy inputs to both (complex128, CPU). Each JAX
oracle runs once, in a module-scoped fixture.

Tolerances:
- Newton-polygon starts: 1e-12 relative (the same hull; angles up to
  ~0.7 deg rounded in another order);
- the batch axis of merge_mask and of K2's plain version: equal to the
  rows one by one, bit for bit (the plain version takes the rows one by
  one); K2's plain version within 1e-5 of ``jax.vmap(_repulsion_chunked)``
  (fp32 reciprocals and sums, as its low-precision contract);
- contspec: rtol 1e-10 (``tests/test_parallel.py:29-31``);
- full spectrum: masks equal; bound states 5e-6, norming constants 5e-5,
  rho 1e-10 relative to its largest value (``tests/test_parallel.py:104-
  113``), against the JAX package's batched function and the port's
  per-signal ``nsev`` alike;
- NFDM link (``examples/nfdm_modem.py``, B = 8, D = M = 256): waveforms
  1e-10 relative to the JAX package's; the EVM within 1e-6 relative of
  the JAX package's, which is 1.21e-2 to its printed digits; no symbol
  error.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import fnft_tpu as jft
from fnft_tpu.ops import roots as jroots
from fnft_tpu.parallel import batch_full as jbf, sharding as jsh
from fnft_tpu.utils import misc as jmisc
import fnft_tpu_torch as tft
from fnft_tpu_torch.ops import kernels, roots
from fnft_tpu_torch.parallel import batch_full as tbf, sharding as tsh
from fnft_tpu_torch.utils import misc as tmisc

torch.set_num_threads(1)


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(got, ref) -> float:
    got, ref = _np(got), _np(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


# ---------------------------------------------------------------------------
# the batch axis below the batched functions
# ---------------------------------------------------------------------------

def _poly_rows(case: str, rng) -> np.ndarray:
    c = rng.normal(size=(3, 41)) + 1j * rng.normal(size=(3, 41))
    c *= np.exp(rng.normal(scale=4.0, size=(3, 41)))  # a rugged hull
    if case == "leading_zeros":
        c[:, -5:] = 0
    elif case == "trailing_zeros":
        c[:, :4] = 0
    elif case == "both_zero_ends":
        c[:, :2] = 0
        c[:, -3:] = 0
    elif case == "degenerate":   # all zero / one coefficient / two
        c[0] = 0
        c[1, 1:] = 0
        c[2, 1:-1] = 0
    return c


@pytest.mark.parametrize("case", ["random", "leading_zeros",
                                  "trailing_zeros", "both_zero_ends",
                                  "degenerate"])
def test_newton_polygon_init_matches_traced_jax(case):
    """The batched pipelines' starts are the JAX package's traced ones (no
    1e6 / 1e-6 circles for zero end coefficients, radii clipped)."""
    c = _poly_rows(case, np.random.default_rng(3))
    got = roots.newton_polygon_init(torch.as_tensor(c)).numpy()
    ref = np.asarray(jax.vmap(jroots.newton_polygon_init_jax)(jnp.asarray(c)))
    assert got.shape == ref.shape == (3, 40)
    assert np.max(np.abs(got - ref) / np.abs(ref)) <= 1e-12


def test_merge_mask_batched_equals_rows():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(5, 37)) + 1j * rng.normal(size=(5, 37))
    v[:, 9] = v[:, 4] + 1e-9          # a cluster in every row
    v[2, 20] = v[2, 3] + 2e-9
    mask = rng.random((5, 37)) > 0.2
    got = tmisc.merge_mask(torch.as_tensor(v), 1e-6, torch.as_tensor(mask))
    for b in range(5):
        row = tmisc.merge_mask(torch.as_tensor(v[b]), 1e-6,
                               torch.as_tensor(mask[b]))
        assert torch.equal(got[b], row)
        assert np.array_equal(got[b].numpy(), np.asarray(jmisc.merge_mask(
            jnp.asarray(v[b]), 1e-6, jnp.asarray(mask[b]))))
    assert not got[:, 9].any()


def test_repulsion_plain_batched_rows_and_jax():
    """K2's plain version over a batch: each row has the bits of its own
    call, and the batch is within 1e-5 of the JAX package's vmapped
    chunked repulsion (the shared root indices of an Aberth sweep)."""
    rng = np.random.default_rng(5)
    b, deg = 4, 600
    z_all = rng.normal(size=(b, deg)) + 1j * rng.normal(size=(b, deg))
    idx = np.sort(rng.choice(deg, size=150, replace=False)).astype(np.int32)
    z_t = z_all[:, idx]
    got = kernels.repulsion_sum_plain(torch.as_tensor(z_all),
                                      torch.as_tensor(z_t),
                                      torch.as_tensor(idx))
    for r in range(b):
        row = kernels.repulsion_sum_plain(torch.as_tensor(z_all[r]),
                                          torch.as_tensor(z_t[r]),
                                          torch.as_tensor(idx))
        assert torch.equal(torch.view_as_real(got[r]),
                           torch.view_as_real(row))
    ref = jax.vmap(jroots._repulsion_chunked, in_axes=(0, 0, None))(
        jnp.asarray(z_all), jnp.asarray(z_t), jnp.asarray(idx))
    assert _rel(got, ref) <= 1e-5
    # the wrapper takes the same batch on the CPU (its plain version)
    again = kernels.repulsion_sum(torch.as_tensor(z_all),
                                  torch.as_tensor(z_t), torch.as_tensor(idx))
    assert torch.equal(torch.view_as_real(again), torch.view_as_real(got))


def test_aberth_batched_rows_through_k2_route(monkeypatch):
    """With the dense threshold lowered, the batched Aberth run takes the
    K2 route with the whole batch in each call, and finds each row's
    roots."""
    rng = np.random.default_rng(6)
    true = rng.normal(size=(3, 30)) + 1j * rng.normal(size=(3, 30))
    coeffs = np.stack([np.poly(t)[::-1] for t in true])
    calls = []
    orig = roots._repulsion_chunked
    monkeypatch.setattr(roots, "DENSE_REPULSION_MAX", 0)
    monkeypatch.setattr(roots, "_repulsion_chunked", lambda za, *a, **k: (
        calls.append(tuple(za.shape)), orig(za, *a, **k))[1])
    c = torch.as_tensor(coeffs)
    got = roots.aberth_roots(c, roots.newton_polygon_init(c)).numpy()
    assert calls and set(calls) == {(3, 30)}
    for g, t in zip(got, true):
        dist = np.abs(g[:, None] - t[None, :])
        assert max(dist.min(axis=0).max(), dist.min(axis=1).max()) < 1e-8


# ---------------------------------------------------------------------------
# batched contspec
# ---------------------------------------------------------------------------

CS_D, CS_M, CS_T, CS_XI = 512, 64, (-10.0, 10.0), (-2.0, 2.0)


@pytest.fixture(scope="module")
def contspec_case():
    t = np.linspace(*CS_T, CS_D)
    amps = 0.5 + np.random.default_rng(0).uniform(size=4)
    q = np.stack([1j * a / np.cosh(t) * np.exp(0.3j * k * t)
                  for k, a in enumerate(amps)])
    both = jsh.make_nsev_batch_fn(CS_D, CS_T, CS_M, CS_XI,
                                  contspec_type=jft.ContspecType.BOTH)(
        jnp.asarray(q))
    return q, {k: np.asarray(v) for k, v in both.items()}


def test_make_nsev_batch_fn_matches_jax(contspec_case):
    q, ref = contspec_case
    fn = tsh.make_nsev_batch_fn(CS_D, CS_T, CS_M, CS_XI,
                                contspec_type=tft.ContspecType.BOTH,
                                device="cpu")
    got = fn(q)
    assert set(got) == {"rho", "a", "b"}
    for key in ("rho", "a", "b"):
        assert got[key].shape == (4, CS_M) and got[key].device.type == "cpu"
        np.testing.assert_allclose(_np(got[key]), ref[key], rtol=1e-10,
                                   atol=1e-12)


def test_batched_nsev_contspec_matches_jax_and_driver(contspec_case):
    q, ref = contspec_case
    rho = tsh.batched_nsev_contspec(torch.as_tensor(q), CS_T, CS_M, CS_XI)
    np.testing.assert_allclose(_np(rho), ref["rho"], rtol=1e-10, atol=1e-12)
    for i in range(4):
        single = tft.nsev(torch.as_tensor(q[i]), CS_T, m=CS_M,
                          xi_span=CS_XI, want_bound_states=False)
        np.testing.assert_allclose(_np(rho[i]),
                                   _np(single.reflection_coefficient),
                                   rtol=1e-10, atol=1e-12)


def test_batch_entry_points_send_arrays_to_cuda():
    """Arrays go to the CUDA device by default; without one the make_*
    functions raise (a tensor stays where it is)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is taken")
    for make in (lambda: tsh.make_nsev_batch_fn(CS_D, CS_T, CS_M, CS_XI),
                 lambda: tbf.make_batched_full_nsev(CS_D, CS_T, CS_M, CS_XI),
                 lambda: tbf.make_batched_inverse_fn(256, CS_T, 256),
                 lambda: tft.parallel.make_batched_nsep_fn(256, (0.0, 1.0))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="CUDA"):
        tsh.batched_nsev_contspec(np.zeros((2, 64), complex), CS_T, 8, CS_XI)


# ---------------------------------------------------------------------------
# batched full spectrum
# ---------------------------------------------------------------------------

FS_D, FS_M, FS_T, FS_XI = 1024, 256, (-16.0, 16.0), (-2.0, 2.0)
FS_AMPS = (1.2, 2.3, 3.4, 4.45)


@pytest.fixture(scope="module")
def full_case():
    t = np.linspace(*FS_T, FS_D)
    q = np.stack([(1j * a / np.cosh(t)).astype(complex) for a in FS_AMPS])
    res = jbf.make_batched_full_nsev(FS_D, FS_T, FS_M, FS_XI, k_max=6)(q)
    ref = {k: np.asarray(getattr(res, k)) for k in (
        "rho", "a", "b", "bound_states", "bound_state_mask",
        "norming_constants")}
    got = tbf.make_batched_full_nsev(FS_D, FS_T, FS_M, FS_XI, k_max=6,
                                     device="cpu")(torch.as_tensor(q))
    return q, ref, got


def _sorted_states(bs, nc, mask):
    bs, nc = np.asarray(bs)[mask], np.asarray(nc)[mask]
    order = np.argsort(bs.imag)   # real parts are ~1e-16 noise
    return bs[order], nc[order]


def test_batched_full_matches_jax(full_case):
    q, ref, got = full_case
    assert isinstance(got, tbf.BatchedNsevResult)
    assert got.bound_states.shape == got.bound_state_mask.shape == (4, 6)
    assert np.array_equal(_np(got.bound_state_mask), ref["bound_state_mask"])
    assert _np(got.bound_state_mask).sum(axis=1).tolist() == [1, 2, 3, 4]
    for i in range(4):
        mask = ref["bound_state_mask"][i]
        bs, nc = _sorted_states(_np(got.bound_states[i]),
                                _np(got.norming_constants[i]), mask)
        bs_r, nc_r = _sorted_states(ref["bound_states"][i],
                                    ref["norming_constants"][i], mask)
        np.testing.assert_allclose(bs, bs_r, atol=5e-6)
        np.testing.assert_allclose(nc, nc_r, atol=5e-5)
    for key in ("rho", "a", "b"):
        np.testing.assert_allclose(_np(getattr(got, key)), ref[key],
                                   atol=1e-10 * np.max(np.abs(ref[key])))
    # unmasked slots hold zeros, as the JAX package's
    off = ~ref["bound_state_mask"]
    assert np.all(_np(got.bound_states)[off] == 0)
    assert np.all(_np(got.norming_constants)[off] == 0)


@pytest.mark.parametrize("row", range(len(FS_AMPS)))
def test_batched_full_row_matches_driver(full_case, row):
    """Each row against the port's per-signal nsev with the same options
    (the host-loop filter/merge against the masked top-k selection)."""
    q, _, got = full_case
    drv = tft.nsev(torch.as_tensor(q[row]), FS_T, m=FS_M, xi_span=FS_XI,
                   opts=tft.NsevOpts(discspec_type=tft.DiscspecType.BOTH,
                                     contspec_type=tft.ContspecType.BOTH))
    mask = _np(got.bound_state_mask[row])
    bs, nc = _sorted_states(_np(got.bound_states[row]),
                            _np(got.norming_constants[row]), mask)
    bs_d, nc_d = _sorted_states(_np(drv.bound_states),
                                _np(drv.norming_constants),
                                np.ones(drv.bound_states.shape[0], bool))
    assert len(bs) == len(bs_d) == row + 1
    np.testing.assert_allclose(bs, bs_d, atol=5e-6)
    np.testing.assert_allclose(nc, nc_d, atol=5e-5)
    for key, field in (("rho", "reflection_coefficient"), ("a", "a"),
                       ("b", "b")):
        want = _np(getattr(drv, field))
        np.testing.assert_allclose(_np(getattr(got, key)[row]), want,
                                   atol=1e-10 * max(1.0, np.max(np.abs(want))))


# ---------------------------------------------------------------------------
# batched inverse: the NFDM link of examples/nfdm_modem.py
# ---------------------------------------------------------------------------

def _nfdm_symbols(batch, carriers, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2, size=(batch, carriers)) * 2 - 1
            + 1j * (rng.integers(0, 2, size=(batch, carriers)) * 2 - 1)
            ) / np.sqrt(2)


def _nfdm_link(inverse, forward, d, m, t_span, batch=8, carriers=16):
    """examples/nfdm_modem.py's link with the given batched functions
    (``inverse(d, t_span, m) -> (fn, xi_span)``, ``forward(d, t_span, m,
    xi_span) -> fn``): (waveforms, EVM, symbol errors)."""
    symbols = _nfdm_symbols(batch, carriers)
    inv, xi_span = inverse(d, t_span, m)
    xi = np.linspace(*xi_span, m)
    centers = np.linspace(-3.0, 3.0, carriers)
    pulses = np.exp(-((xi[None, :] - centers[:, None]) / 0.12) ** 2)
    rho_tx = 0.25 * (symbols @ pulses)
    q = _np(inv(rho_tx.astype(complex)))
    rho_rx = _np(forward(d, t_span, m, xi_span)(q)["rho"])
    idx = np.argmin(np.abs(xi[None, :] - centers[:, None]), axis=1)
    tx, rx = rho_tx[:, idx], rho_rx[:, idx]
    evm = float(np.sqrt(np.mean(np.abs(rx - tx) ** 2)
                        / np.mean(np.abs(tx) ** 2)))
    errors = int(np.sum(np.sign(rx.real) + 1j * np.sign(rx.imag)
                        != np.sign(tx.real) + 1j * np.sign(tx.imag)))
    return q, evm, errors


NFDM = dict(d=256, m=256, t_span=(-16.0, 16.0))


@pytest.fixture(scope="module")
def nfdm_jax():
    return _nfdm_link(
        lambda d, t, m: jbf.make_batched_inverse_fn(d, t, m),
        lambda d, t, m, xi: jsh.make_nsev_batch_fn(d, t, m, xi), **NFDM)


def test_nfdm_link_matches_jax(nfdm_jax):
    q_ref, evm_ref, err_ref = nfdm_jax
    q, evm, errors = _nfdm_link(
        lambda d, t, m: tbf.make_batched_inverse_fn(d, t, m, device="cpu"),
        lambda d, t, m, xi: tsh.make_nsev_batch_fn(d, t, m, xi,
                                                   device="cpu"), **NFDM)
    assert q.shape == (8, NFDM["d"])
    assert _rel(q, q_ref) <= 1e-10
    assert f"{evm_ref:.2e}" == "1.21e-02" and err_ref == 0
    assert abs(evm - evm_ref) <= 1e-6 * evm_ref
    assert errors == 0


def test_batched_inverse_rows_match_nsev_inverse():
    """Each burst's waveform equals the per-signal nsev_inverse (and the
    b(xi) representation goes through the batch too)."""
    d, m, t_span = 256, 512, (-16.0, 16.0)
    rng = np.random.default_rng(7)
    for ctype in (tft.InverseContspecType.REFLECTION_COEFFICIENT,
                  tft.InverseContspecType.B_OF_XI):
        fn, xi_span = tbf.make_batched_inverse_fn(d, t_span, m,
                                                  contspec_type=ctype,
                                                  device="cpu")
        xi = np.linspace(*xi_span, m)
        cs = np.stack([0.2 * np.exp(-((xi - c) / 0.5) ** 2) * np.exp(1j * c)
                       for c in rng.uniform(-2, 2, size=3)])
        q = fn(torch.as_tensor(cs))
        for i in range(3):
            single = tft.nsev_inverse(torch.as_tensor(cs[i]), xi_span, d,
                                      t_span, opts=tft.NsevInverseOpts(
                                          contspec_type=ctype))
            assert _rel(q[i], single) <= 1e-10
