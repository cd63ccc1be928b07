"""The inverse NFT of the PyTorch port (nsev_inverse, spectral
factorization, fast inverse scattering, Darboux) against the JAX package
and the reference's bounds. Same numpy inputs to both (complex128, CPU);
the round trips take their spectra from the port's own forward transform,
as the reference's tests take them from fnft_nsev.

Tolerances:
- spectral factorization and polynomial products: 1e-12 relative (equal
  arithmetic, another FFT library);
- finvscatter at D = 256: 1e-12 relative to the JAX package, and the
  signal back to 1e-12 where the JAX package gets it back (with
  kappa = -1 the 2SPLIT2A base case maps a sample through arctan, the
  focusing map, and both packages return the signal to ~2e-4 only);
- nsev_inverse: 1e-12 relative to the JAX package (the Darboux routes
  5e-14: K products of D-sample eigenfunction trajectories), and the
  reference's own bound on the error to the signal, as
  ``tests/test_nsev_inverse.py`` has them, at its sizes (D <= 4096).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fnft_tpu as jft
from fnft_tpu.models import nsev_inverse as jinv
from fnft_tpu.ops import finvscatter as jfi
from fnft_tpu.ops import specfact as jsf
import fnft_tpu_torch as tft
from fnft_tpu_torch import compat, errors
from fnft_tpu_torch.models.discretization import Discretization
from fnft_tpu_torch.ops import finvscatter as tfi
from fnft_tpu_torch.ops import specfact as tsf
from fnft_tpu_torch.ops.fscatter import fscatter

torch.set_num_threads(1)

Q8 = np.array([0.1, 0.1j, 0.2, -0.2, 0.0, 0.05 + 0.05j, -0.03j, 0.06],
              dtype=complex)
T8 = (0.0, 7.0)


def _np(x):
    return x.resolve_conj().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel(got, ref) -> float:
    got, ref = _np(got), _np(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _rel_err(got, exact) -> float:
    """The reference's error: sum-of-abs relative (utils/misc.rel_err)."""
    got, exact = _np(got), _np(exact)
    return float(np.sum(np.abs(got - exact)) / np.sum(np.abs(exact)))


def _both(contspec, xi_span, d, t_span, opts_j, tol=1e-12, **kw):
    """nsev_inverse of both packages on the same numpy inputs; returns the
    port's q (a CPU tensor) after holding it to the JAX package's."""
    np_kw = {k: (np.asarray(v) if v is not None else None)
             for k, v in kw.items() if k != "kappa"}
    ref = jinv.nsev_inverse(None if contspec is None else jnp.asarray(contspec),
                            xi_span, d, t_span, kappa=kw.get("kappa", 1),
                            opts=opts_j, **np_kw)
    t_kw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
            for k, v in np_kw.items()}
    got = tft.nsev_inverse(
        None if contspec is None else torch.as_tensor(contspec), xi_span, d,
        t_span, kappa=kw.get("kappa", 1),
        opts=compat.nsev_inverse_opts_from_reference(opts_j), **t_kw)
    assert got.dtype == torch.complex128 and got.device.type == "cpu"
    assert tuple(got.shape) == (d,)
    assert _rel(got, ref) <= tol
    return got


def _rand(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.mark.parametrize("kappa", [-1, 0, 1])
def test_specfact_matches_jax(kappa):
    rng = np.random.default_rng(3 + kappa)
    # |B| < 1 on the circle for kappa = +1 (well-posed)
    c = _rand(rng, 65) * (0.01 if kappa == 1 else 1.0)
    got = tsf.poly_specfact(torch.as_tensor(c), kappa=kappa)
    ref = jsf.poly_specfact(jnp.asarray(c), kappa=kappa)
    assert got.dtype == torch.complex128 and tuple(got.shape) == (65,)
    assert _rel(got, ref) <= 1e-12


def test_specfact_ill_posed_warns():
    """kappa = +1 with |B| reaching 1 on the circle: one warning through
    the sink, as the reference's FNFT__WARN (none when well-posed)."""
    seen = []
    errors.set_warn_handler(seen.append)
    try:
        tsf.poly_specfact(torch.tensor([0.3, 0.2 + 0j]), kappa=1)
        assert seen == []
        out = tsf.poly_specfact(torch.tensor([0.9, 0.5 + 0j]), kappa=1)
    finally:
        errors.set_warn_handler(None)
    assert seen == ["Ill-posed spectral factorization problem."]
    assert bool(torch.isfinite(out).all())


def _rand_jsym(n, kappa, rng, batch=()):
    """[..., 2, 2, n+1] with T22 = rev(conj(T11)), T12 = -kappa rev(conj(T21))."""
    a, c = _rand(rng, *batch, n + 1), _rand(rng, *batch, n + 1)
    t = np.zeros(batch + (2, 2, n + 1), complex)
    t[..., 0, 0, :], t[..., 1, 0, :] = a, c
    t[..., 1, 1, :] = np.conj(a[..., ::-1])
    t[..., 0, 1, :] = -kappa * np.conj(c[..., ::-1])
    return t


@pytest.mark.parametrize("kappa", [+1, -1])
@pytest.mark.parametrize("na,nb", [(40, 56), (16, 56)], ids=["fft", "direct"])
def test_polymatmul_col_matches_generic(kappa, na, nb):
    """The column product against the generic product of the port and of
    the JAX package, whole and in the recursion's alias-shortened window
    [safe_from, out_len) (finvscatter_staged's check, one batch axis)."""
    rng = np.random.default_rng(5)
    a_np, b_np = _rand_jsym(na, kappa, rng, (3,)), _rand_jsym(nb, kappa, rng, (3,))
    a, b = torch.as_tensor(a_np), torch.as_tensor(b_np)
    ref = tfi._polymatmul(a, b)
    assert _rel(ref, jfi._polymatmul(jnp.asarray(a_np), jnp.asarray(b_np))) <= 1e-12
    assert _rel(tfi._polymatmul(a, b, jsym=kappa), ref) <= 1e-12
    assert _rel(tfi._polymatmul(a, b, a_jsym=kappa), ref) <= 1e-12
    col = lambda x: (x[..., 0, 0, :], x[..., 1, 0, :])  # noqa: E731
    o11, o21 = tfi._polymatmul_col(col(a), col(b), kappa)
    assert _rel(o11, ref[..., 0, 0, :]) <= 1e-12
    assert _rel(o21, ref[..., 1, 0, :]) <= 1e-12
    d2, out_len = nb // 2, nb + 1
    w11, w21 = tfi._polymatmul_col(col(a), col(b), kappa, out_len=out_len,
                                   safe_from=d2)
    assert w11.shape[-1] == out_len
    assert _rel(w11[..., d2:], ref[..., 0, 0, d2:out_len]) <= 1e-12
    assert _rel(w21[..., d2:], ref[..., 1, 0, d2:out_len]) <= 1e-12
    full = tfi._jsym_complete(o11, o21, kappa)
    assert _rel(full, ref) <= 1e-12


@pytest.mark.parametrize("disc", ["SPLIT2A", "SPLIT2_MODAL"])
@pytest.mark.parametrize("kappa", [+1, -1])
def test_finvscatter_matches_jax(kappa, disc):
    d, t_span = 256, (-8.0, 8.0)
    eps_t = (t_span[1] - t_span[0]) / (d - 1)
    q = 0.6j / np.cosh(np.linspace(*t_span, d))
    qt = torch.as_tensor(q)
    tm, w = fscatter(qt, -kappa * torch.conj(qt), eps_t,
                     Discretization[disc], normalize=False)
    assert int(w) == 0
    got = tfi.finvscatter(tm, eps_t, kappa, Discretization[disc])
    ref = jfi.finvscatter(jnp.asarray(_np(tm)), eps_t, kappa,
                          jft.Discretization[disc])
    assert got.dtype == torch.complex128 and tuple(got.shape) == (d,)
    assert _rel(got, ref) <= 1e-12
    if (kappa, disc) != (-1, "SPLIT2A"):
        assert _rel(got, q) <= 1e-12
        assert _rel(ref, q) <= 1e-12


def _forward_rho(m, kappa, disc):
    xi = tft.nsev_inverse_xi_grid(8, T8, m, Discretization[disc])
    fwd = tft.nsev(torch.as_tensor(Q8), T8, m=m, xi_span=xi, kappa=kappa,
                   opts=tft.NsevOpts(discretization=Discretization[disc]),
                   want_bound_states=False)
    return _np(fwd.reflection_coefficient), xi


# bounds: fnft_nsev_inverse_test_against_forward_{focusing,defocusing}_*.c
@pytest.mark.parametrize("m,kappa,method,disc,bound", [
    (10, +1, "DEFAULT", "SPLIT2A", 0.022),
    (32, +1, "DEFAULT", "SPLIT2A", 5.3e-8),
    (10, -1, "DEFAULT", "SPLIT2A", 0.03),
    (32, -1, "DEFAULT", "SPLIT2A", 0.016),
    (32, +1, "DEFAULT", "SPLIT2_MODAL", 1e-7),
    (8, -1, "TFMATRIX_CONTAINS_AB_FROM_ITER", "SPLIT2A", 0.016),
], ids=["m10+", "m32+", "m10-", "m32-", "modal", "ab_from_iter"])
def test_roundtrip_against_forward(m, kappa, method, disc, bound):
    rho, xi = _forward_rho(m, kappa, disc)
    opts = jinv.NsevInverseOpts(discretization=jft.Discretization[disc],
                                contspec_method=jinv.InverseCstMethod[method])
    q = _both(rho, xi, 8, T8, opts, kappa=kappa)
    assert _rel_err(q, Q8) <= bound


def _sech_b(d, a=0.45, t0=1.2):
    t_span = (-25.0, 25.0)
    t = np.linspace(*t_span, d)
    return t_span, t, 1j * a / np.cosh(t - t0)


@pytest.mark.parametrize("ctype", ["B_OF_TAU", "B_OF_XI"])
def test_b_representations(ctype):
    """B(tau) and b(xi) of 0.45 sech(t - 1.2) at D = 256 (bound 0.0009)."""
    d, a, t0 = 256, 0.45, 1.2
    t_span, t, q_exact = _sech_b(d, a, t0)
    if ctype == "B_OF_TAU":
        xi_span = None
        cs = 1j / (2 * np.pi) * np.sin(np.pi * a) / np.cosh(t - t0)
    else:
        xi_span = tft.nsev_inverse_xi_grid(d, t_span, d)
        xi = np.linspace(*xi_span, d)
        cs = 1j * np.exp(-2j * xi * t0) * np.sin(np.pi * a) / np.cosh(np.pi * xi)
    opts = jinv.NsevInverseOpts(
        contspec_type=jinv.InverseContspecType[ctype])
    q = _both(cs, xi_span, d, t_span, opts)
    assert _rel_err(q, q_exact) <= 0.0009


def test_multisoliton_cdt():
    """5-soliton with Satsuma-Yajima data is 5 sech(t) (multisoliton_cdt,
    bound 3.2e-10 at D = 4096)."""
    d, t_span = 4096, (-32.0, 32.0)
    q = _both(None, None, d, t_span, jinv.NsevInverseOpts(), tol=5e-14,
              bound_states=np.array([0.5j, 1.5j, 2.5j, 3.5j, 4.5j]),
              normconsts_or_residues=np.array([-1.0, 1, -1, 1, -1], complex))
    assert _rel_err(q, 5.0 / np.cosh(np.linspace(*t_span, d))) <= 3.2e-10


@pytest.mark.parametrize("dstype", ["NORMING_CONSTANTS", "RESIDUES"])
def test_addsoliton_cdt(dstype):
    """Three solitons added to a seed (addsoliton_cdt, bound 0.0029 at
    D = 512), norming constants or residues."""
    d, t_span = 512, (-20.0, 20.0)
    t = np.linspace(*t_span, d)
    bs = np.array([2.5 + 0.9j, 2.5 + 1.9j, 2.5 + 2.9j])
    vals = np.array([-1.0, 1.0, -1.0], dtype=complex)
    if dstype == "RESIDUES":
        for i in range(3):
            blaschke = np.prod([(bs[i] - bs[j]) / (bs[i] - np.conj(bs[j]))
                                for j in range(3) if j != i])
            vals[i] = vals[i] * (2j * bs[i].imag) / blaschke
    opts = jinv.NsevInverseOpts(
        contspec_method=jinv.InverseCstMethod.USE_SEED_POTENTIAL_INSTEAD,
        discspec_type=jinv.InverseDiscspecType[dstype])
    q = _both(None, None, d, t_span, opts, tol=5e-14, bound_states=bs,
              normconsts_or_residues=vals,
              seed_potential=-0.4 / np.cosh(t) * np.exp(-5j * t))
    assert _rel_err(q, 3.4 / np.cosh(t) * np.exp(-5j * t)) <= 0.0029


@pytest.mark.parametrize("ctype", ["B_OF_XI", "B_OF_TAU"])
def test_b_representation_with_discrete_spectrum(ctype):
    """2.45 sech: b(xi) or B(tau) plus its two bound states
    (b_of_xi_w_discrete / B_of_tau_w_discrete, bound 6.3e-4 at D = 512)."""
    d = 512
    t_span = (-25.0, 25.0)
    a_amp = 2.45
    t = np.linspace(*t_span, d)
    if ctype == "B_OF_XI":
        xi_span = tft.nsev_inverse_xi_grid(d, t_span, d)
        xi = np.linspace(*xi_span, d)
        cs = 1j * np.sin(np.pi * a_amp) / np.cosh(np.pi * xi)
    else:
        xi_span = None
        cs = 1j / (2 * np.pi) * np.sin(np.pi * a_amp) / np.cosh(t)
    opts = jinv.NsevInverseOpts(
        contspec_type=jinv.InverseContspecType[ctype])
    q = _both(cs, xi_span, d, t_span, opts, tol=5e-14,
              bound_states=1j * (a_amp - np.arange(2) - 0.5),
              normconsts_or_residues=np.array([1j, -1j]))
    assert _rel_err(q, 1j * a_amp / np.cosh(t)) <= 6.3e-4


def test_roundtrip_with_discrete_spectrum():
    """Contspec and three bound states of 3.4 sech(t) e^{-4it} from the
    port's forward transform (against_forward_w_discrete, bound 0.014 at
    D = 512, M = 1024)."""
    d, m = 512, 1024
    t_span = (-32.0, 32.0)
    t = np.linspace(*t_span, d)
    q_exact = 3.4 / np.cosh(t) * np.exp(-4j * t)
    xi_span = tft.nsev_inverse_xi_grid(d, t_span, m)
    fwd = tft.nsev(torch.as_tensor(q_exact), t_span, m=m, xi_span=xi_span,
                   opts=tft.NsevOpts(
                       discretization=Discretization.SPLIT4B,
                       discspec_type=tft.DiscspecType.NORMING_CONSTANTS))
    assert fwd.bound_states.numel() == 3
    q = _both(_np(fwd.reflection_coefficient), xi_span, d, t_span,
              jinv.NsevInverseOpts(), bound_states=_np(fwd.bound_states),
              normconsts_or_residues=_np(fwd.norming_constants))
    assert _rel_err(q, q_exact) <= 0.014


def test_nsev_inverse_opts_carried_over():
    ref = jinv.NsevInverseOpts(
        discretization=jft.Discretization.SPLIT2_MODAL,
        contspec_type=jinv.InverseContspecType.B_OF_TAU,
        contspec_method=jinv.InverseCstMethod.TFMATRIX_CONTAINS_AB_FROM_ITER,
        discspec_type=jinv.InverseDiscspecType.RESIDUES, max_iter=17,
        oversampling_factor=4)
    got = compat.nsev_inverse_opts_from_reference(ref)
    assert isinstance(got, tft.NsevInverseOpts)
    for field in dataclasses.fields(got):
        g, r = getattr(got, field.name), getattr(ref, field.name)
        if hasattr(g, "value"):
            assert type(g).__module__.startswith("fnft_tpu_torch")
            assert g.value == r.value, field.name
        else:
            assert g == r, field.name
    assert (compat.nsev_inverse_opts_from_reference(jinv.NsevInverseOpts())
            == tft.NsevInverseOpts())


def test_nsev_inverse_array_on_cpu_by_request_and_no_cuda_default():
    """An array goes where ``device=`` says; tensors keep their device;
    with neither, the default is CUDA, which raises here."""
    rho, xi = _forward_rho(32, +1, "SPLIT2A")
    got = tft.nsev_inverse(rho, xi, 8, T8, device="cpu")
    ref = tft.nsev_inverse(torch.as_tensor(rho), xi, 8, T8)
    assert got.device.type == "cpu" and torch.equal(got, ref)
    bs = np.array([0.5j, 1.5j])
    nc = np.array([-1.0, 1.0], complex)
    seeded = tft.nsev_inverse(None, None, 64, (-8.0, 8.0),
                              bound_states=torch.as_tensor(bs),
                              normconsts_or_residues=nc)
    assert seeded.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for args, kw in (((rho, xi, 8, T8), {}),
                     ((None, None, 64, (-8.0, 8.0)),
                      dict(bound_states=bs, normconsts_or_residues=nc))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tft.nsev_inverse(*args, **kw)
