"""The CUDA kernels of the PyTorch port against their plain versions, on
the card. These tests import no jax, so they run where the port runs:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures jax). Without a CUDA
device they skip. Tolerances: same arithmetic in another summation order
(K1: 1e-12 in complex128, 5e-6 in complex64); K2 low precision keeps
reciprocals and partial sums in fp32 (1e-5).
"""

import numpy as np
import pytest
import torch

from fnft_tpu_torch.ops import kernels

torch.set_num_threads(1)


def _cplx(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,levels", [((1024, 2, 2, 3), 2),
                                          ((1024, 2, 2, 2), 2),
                                          ((3, 512, 2, 2, 2), 2),
                                          ((1024, 2, 2, 4), 2)])
@pytest.mark.parametrize("dtype,tol", [(torch.complex128, 1e-12),
                                       (torch.complex64, 5e-6)])
@pytest.mark.parametrize("normalize", [False, True])
def test_fused_levels_kernel_matches_plain(cuda_device, shape, levels, dtype,
                                           tol, normalize):
    rng = np.random.default_rng(sum(shape))
    p = torch.as_tensor(_cplx(rng, shape)).to(dtype).to(cuda_device)
    got, w = kernels.fused_tree_levels(p, levels, normalize=normalize)
    ref, w_ref = kernels.fused_tree_levels_plain(p, levels,
                                                 normalize=normalize)
    torch.cuda.synchronize()
    assert torch.equal(w, w_ref)
    assert _rel(got, ref) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("deg,m", [(97, 23), (700, 700), (1500, 300),
                                   (8192, 8192)])
def test_repulsion_kernel_matches_plain(cuda_device, deg, m):
    rng = np.random.default_rng(deg + m)
    z_all = torch.as_tensor(_cplx(rng, deg)).to(cuda_device)
    idx = torch.as_tensor(np.sort(rng.choice(deg, size=m, replace=False))
                          .astype(np.int32)).to(cuda_device)
    z_t = z_all[idx.long()]
    for lowprec, tol in ((False, 1e-12), (True, 1e-5)):
        got = kernels.repulsion_sum(z_all, z_t, idx, lowprec=lowprec)
        ref = kernels.repulsion_sum_plain(z_all, z_t, idx, lowprec=lowprec)
        torch.cuda.synchronize()
        assert _rel(got, ref) < tol
