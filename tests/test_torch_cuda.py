"""The CUDA kernels of the PyTorch port against their plain versions, on
the card. These tests import no jax, so they run where the port runs:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures jax). Without a CUDA
device they skip. Tolerances: same arithmetic in another summation order
(K1: 1e-12 in complex128, 5e-6 in complex64); K2 low precision keeps
reciprocals and partial sums in fp32 (1e-5), the complex64 path too.
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


def _oracle(z_all, z_t, idx):
    """Brute-force repulsion sum in complex128 (the fp64 oracle)."""
    z_all, z_t = z_all.to(torch.complex128), z_t.to(torch.complex128)
    out = torch.zeros_like(z_t)
    ar = torch.arange(z_all.shape[0], device=z_all.device)
    for r0 in range(0, z_t.shape[0], 2048):
        zt, it = z_t[r0:r0 + 2048], idx[r0:r0 + 2048].long()
        self_mask = it[:, None] == ar[None]
        out[r0:r0 + 2048] = torch.where(self_mask, 0.0, 1.0 / torch.where(
            self_mask, 1.0, zt[:, None] - z_all[None, :])).sum(dim=1)
    return out


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,levels", [((1024, 2, 2, 3), 2),
                                          ((4096, 2, 2, 3), 2),
                                          ((1024, 2, 2, 2), 2),
                                          ((3, 512, 2, 2, 2), 2),
                                          ((1024, 2, 2, 4), 2),
                                          ((788, 2, 2, 3), 2),
                                          ((2, 3, 196, 2, 2, 4), 2),
                                          ((1 << 20, 2, 2, 3), 2)])
@pytest.mark.parametrize("dtype,tol", [(torch.complex128, 1e-12),
                                       (torch.complex64, 5e-6)])
@pytest.mark.parametrize("normalize", [False, True])
def test_fused_levels_kernel_matches_plain(cuda_device, shape, levels, dtype,
                                           tol, normalize):
    """(788, ...) gives 197 subtrees, not a multiple of a block's 64;
    n = 1024, 4096, 2^20 (c = 3) are the nsev main path's shapes."""
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
                                   (8192, 8192), (8191, 8191), (5000, 1237),
                                   (16384, 16384)])
def test_repulsion_kernel_matches_plain(cuda_device, deg, m):
    rng = np.random.default_rng(deg + m)
    z_all = torch.as_tensor(_cplx(rng, deg)).to(cuda_device)
    idx = torch.as_tensor(np.sort(rng.choice(deg, size=m, replace=False))
                          .astype(np.int32)).to(cuda_device)
    z_t = z_all[idx.long()]
    oracle = _oracle(z_all, z_t, idx)
    for lowprec, tol in ((False, 1e-12), (True, 1e-5)):
        got = kernels.repulsion_sum(z_all, z_t, idx, lowprec=lowprec)
        ref = kernels.repulsion_sum_plain(z_all, z_t, idx, lowprec=lowprec)
        torch.cuda.synchronize()
        assert _rel(got, ref) < tol
        assert _rel(got, oracle) < tol
    z64, t64 = z_all.to(torch.complex64), z_t.to(torch.complex64)
    got = kernels.repulsion_sum(z64, t64, idx)
    ref = kernels.repulsion_sum_plain(z64, t64, idx)
    torch.cuda.synchronize()
    assert got.dtype == torch.complex64
    assert _rel(got, ref) < 1e-5


@pytest.mark.cuda
def test_repulsion_kernel_clustered_roots(cuda_device):
    """Pairs of roots 1e-9 apart: the differences must not cancel."""
    rng = np.random.default_rng(11)
    base = np.exp(2j * np.pi * rng.random(4096)) * (1 + 0.01 * rng.normal(
        size=4096))
    z = np.concatenate([base, base + 1e-9 * np.exp(2j * np.pi * rng.random(
        4096))])
    z_all = torch.as_tensor(z).to(cuda_device)
    idx = torch.arange(z.size, dtype=torch.int32, device=cuda_device)
    got = kernels.repulsion_sum(z_all, z_all, idx)
    torch.cuda.synchronize()
    assert _rel(got, _oracle(z_all, z_all, idx)) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("deg,m", [(8192, 8192), (5000, 1237)])
def test_repulsion_kernel_bitwise_reproducible(cuda_device, deg, m):
    rng = np.random.default_rng(deg)
    z_all = torch.as_tensor(_cplx(rng, deg)).to(cuda_device)
    idx = torch.as_tensor(np.sort(rng.choice(deg, size=m, replace=False))
                          .astype(np.int32)).to(cuda_device)
    z_t = z_all[idx.long()]
    first = kernels.repulsion_sum(z_all, z_t, idx)
    second = kernels.repulsion_sum(z_all, z_t, idx)
    torch.cuda.synchronize()
    assert torch.equal(torch.view_as_real(first), torch.view_as_real(second))
