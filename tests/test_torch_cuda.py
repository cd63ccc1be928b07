"""The CUDA kernels of the PyTorch port against their plain versions, and
the port on the card against the port on the CPU. These tests import no jax, so they run where the port runs:

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


def _sech_coeffs(scheme, d, device):
    """Transfer matrices of the Satsuma-Yajima sech on D samples."""
    from fnft_tpu_torch.ops import fscatter as fs
    from fnft_tpu_torch.testcases import NsevTestcase, nsev_testcase

    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    q = torch.as_tensor(data.q).to(device)
    eps_t = (data.t_span[1] - data.t_span[0]) / (d - 1)
    return fs.transfer_matrix_coeffs(q, -torch.conj(q), eps_t,
                                     fs.Discretization[scheme]).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,c", [("SPLIT2A", 2), ("SPLIT3A", 4)])
def test_fused_levels_kernel_on_real_coefficient_stacks(cuda_device, scheme,
                                                        c):
    """K1 at 2 and 4 coefficients on what nsev feeds it at D = 2^16 (half
    the entries of a degree-1 stack are exact zeros)."""
    p = _sech_coeffs(scheme, 1 << 16, cuda_device)
    assert tuple(p.shape) == (1 << 16, 2, 2, c)
    got, w = kernels.fused_tree_levels(p, 2, normalize=True)
    ref, w_ref = kernels.fused_tree_levels_plain(p, 2, normalize=True)
    torch.cuda.synchronize()
    assert torch.equal(w, w_ref)
    assert _rel(got, ref) < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("m", [9000, 173])
def test_repulsion_kernel_on_an_active_set(cuda_device, m):
    """K2 at [deg, m] with m < deg, deg = 18724 (the sub pass of D = 2^18):
    the shape of the deflated Aberth sweeps."""
    deg = 18724
    rng = np.random.default_rng(m)
    z_all = torch.as_tensor(np.exp(2j * np.pi * rng.random(deg)) * (
        1 + 0.01 * rng.normal(size=deg))).to(cuda_device)
    idx = torch.as_tensor(np.sort(rng.choice(deg, size=m, replace=False))
                          .astype(np.int32)).to(cuda_device)
    z_t = z_all[idx.long()]
    got = kernels.repulsion_sum(z_all, z_t, idx)
    torch.cuda.synchronize()
    assert _rel(got, kernels.repulsion_sum_plain(z_all, z_t, idx)) < 1e-5
    assert _rel(got, _oracle(z_all, z_t, idx)) < 1e-5


@pytest.mark.cuda
def test_kdvv_equal_on_card_and_cpu(cuda_device):
    import fnft_tpu_torch as ft
    from fnft_tpu_torch.testcases import kdvv_sech_case

    u, t_span, xi_span, _ = kdvv_sech_case(4096, 64)
    for arg in (u, u + 0j):     # real-coefficient and generic tree
        on_card = ft.kdvv(arg, t_span, m=64, xi_span=xi_span)
        on_cpu = ft.kdvv(arg, t_span, m=64, xi_span=xi_span, device="cpu")
        assert on_card.reflection_coefficient.device.type == "cuda"
        assert _rel(on_card.reflection_coefficient.cpu(),
                    on_cpu.reflection_coefficient) < 1e-10


@pytest.mark.cuda
def test_slow_scheme_nsev_equal_on_card_and_cpu(cuda_device):
    import fnft_tpu_torch as ft
    from fnft_tpu_torch.testcases import NsevTestcase, nsev_testcase

    data = nsev_testcase(NsevTestcase.SECH_FOCUSING2, 512)
    opts = ft.NsevOpts(discretization=ft.Discretization.CF4_2,
                       contspec_type=ft.ContspecType.BOTH,
                       discspec_type=ft.DiscspecType.BOTH)
    res = [ft.nsev_with_initial_states(
        data.q, data.t_span, data.bound_states, m=data.m,
        xi_span=data.xi_span, opts=opts, device=device)
        for device in ("cuda", "cpu")]
    for field, val in vars(res[0]).items():
        assert val.device.type == "cuda"
        assert _rel(val.cpu(), getattr(res[1], field)) < 1e-10, field
