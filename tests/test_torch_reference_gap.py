"""Where the PyTorch port leaves a margin that the reference's tables do
not name, the JAX package's own reading at the same size: the gap between
kdvv's real-coefficient and generic routes, and the norming constants of
4SPLIT4B. Both at D = 4096, the largest size these tests run, on the CPU in
complex128; chip_smoke.py holds the port to limits derived from these at
D = 2^16 on the GPU.
"""

import numpy as np
import jax.numpy as jnp
import torch

import fnft_tpu as jft
import fnft_tpu_torch as tft
from fnft_tpu_torch.testcases import (
    NsevTestcase,
    kdvv_sech_case,
    nsev_errors,
    nsev_testcase,
)

torch.set_num_threads(1)


def _rel(got, ref):
    got, ref = (x.resolve_conj().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x) for x in (got, ref))
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def test_kdvv_route_gap_is_the_jax_packages_own(monkeypatch):
    """The generic route keeps the ~1e-15 imaginary rounding of its transfer
    matrices, which the real-coefficient route drops; D non-unitary
    products carry it to ~1e-15 D on rho (4.5e-12 at D = 4096). That gap
    belongs to the value-space construction of the coefficients, not to
    the port: with the JAX package on the same construction (its choice on
    an accelerator; on the CPU it builds them symbolically) its two routes
    differ as much, and each agrees with the port's to 1e-12. D = 4096 is
    the largest size these tests run; m = 24 keeps the JAX trace apart from
    every other test's."""
    from fnft_tpu.ops import fscatter as jfs

    monkeypatch.setattr(jfs, "_VALUE_COEFFS", True)
    u, t_span, xi_span, _ = kdvv_sech_case(4096, 24)
    kw = dict(m=24, xi_span=xi_span)
    jreal = jft.kdvv(jnp.asarray(u), t_span, **kw).reflection_coefficient
    jcplx = jft.kdvv(jnp.asarray(u + 0j), t_span, **kw).reflection_coefficient
    treal = tft.kdvv(torch.as_tensor(u), t_span, **kw).reflection_coefficient
    tcplx = tft.kdvv(torch.as_tensor(u + 0j), t_span,
                     **kw).reflection_coefficient
    assert _rel(treal, jreal) <= 1e-12 and _rel(tcplx, jcplx) <= 1e-12
    jgap, tgap = _rel(jcplx, jreal), _rel(tcplx, treal)
    assert 1e-13 < jgap < 2e-11
    assert tgap <= 1.5 * jgap and jgap <= 1.5 * tgap


def test_4split4b_normconsts_at_4096_are_at_the_jax_packages_level():
    """The 4SPLIT4B row's norming-constant bound, 5e-15, is 22 eps and was
    set at D = 1024. At D = 4096, the largest size these tests run, port
    and JAX package both still meet it, and the port's error is no more
    than twice the JAX package's (plus 4 eps): the rounding of 2 D base
    steps, which grows past the bound at D = 2^16 (chip_smoke.py), is not
    a deficit of the port."""
    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, 4096)
    kw = dict(m=data.m, xi_span=data.xi_span, kappa=data.kappa)
    ref = jft.models.nsev.nsev_with_initial_states(
        jnp.asarray(data.q), data.t_span, data.bound_states,
        opts=jft.NsevOpts(contspec_type=jft.ContspecType.BOTH,
                          discspec_type=jft.DiscspecType.BOTH,
                          discretization=jft.Discretization.SPLIT4B4), **kw)
    got = tft.nsev_with_initial_states(
        torch.as_tensor(data.q), data.t_span, data.bound_states,
        opts=tft.NsevOpts(contspec_type=tft.ContspecType.BOTH,
                          discspec_type=tft.DiscspecType.BOTH,
                          discretization=tft.Discretization.SPLIT4B4), **kw)
    ref_t = tft.NsevResult(**{
        key: None if val is None else torch.as_tensor(np.array(val))
        for key, val in vars(ref).items()})
    err_ref = nsev_errors(ref_t, data)["normconsts"]
    err = nsev_errors(got, data)["normconsts"]
    assert err_ref <= 5e-15 and err <= 5e-15
    assert err <= 2 * err_ref + 4 * np.finfo(float).eps
