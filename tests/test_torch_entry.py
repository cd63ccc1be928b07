"""Where the PyTorch port's entry points run: a tensor stays on its device,
an array goes to the CUDA device unless ``device=`` asks for another, and
without CUDA that default raises instead of running on the CPU. No jax."""

import numpy as np
import pytest
import torch

import fnft_tpu_torch as tft
from fnft_tpu_torch.testcases import NsevTestcase, nsev_testcase

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sech():
    return nsev_testcase(NsevTestcase.SECH_FOCUSING, 256)


def _fields(res):
    return {k: v for k, v in vars(res).items() if v is not None}


def test_array_on_cpu_by_request_equals_cpu_tensor(sech):
    kw = dict(m=sech.m, xi_span=sech.xi_span)
    got = tft.nsev(sech.q, sech.t_span, device="cpu", **kw)
    ref = tft.nsev(torch.as_tensor(sech.q), sech.t_span, **kw)
    g, r = _fields(got), _fields(ref)
    assert g.keys() == r.keys() and "bound_states" in g
    for key in r:
        assert g[key].device.type == "cpu", key
        assert torch.equal(g[key], r[key]), key


def test_initial_states_follow_q_on_cpu_by_request(sech):
    init = sech.bound_states + np.array([1e-3, -2e-3j, 1e-3 + 1e-3j])
    got = tft.nsev_with_initial_states(list(sech.q), sech.t_span, init,
                                       device=torch.device("cpu"))
    ref = tft.nsev_with_initial_states(torch.as_tensor(sech.q), sech.t_span,
                                       init)
    assert got.bound_states.device.type == "cpu"
    assert torch.equal(got.bound_states, ref.bound_states)


@pytest.mark.parametrize("entry", ["nsev", "nsev_with_initial_states"])
def test_array_without_cuda_raises(sech, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    args = (sech.bound_states,) if entry == "nsev_with_initial_states" else ()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(tft, entry)(sech.q, sech.t_span, *args)
