"""The flagship differentiable pipeline: q[B, D] -> rho[B, M].

Port of ``__graft_entry__.py:15-53`` (``_rho_pipeline``, ``entry``): the
batched fast NFT of the NFDM inverse-design training step, per-sample
2SPLIT4B transfer-matrix polynomials -> FFT-tree product -> chirp-Z
spectral evaluation -> phase factor. Every step is differentiable in
``q``: on a CUDA tensor the tree's first two levels run K1 and its
gradient K1T (``ops/kernels.py``), on a CPU tensor autograd runs through
the plain versions.

:func:`dryrun_multichip` is the twin of ``__graft_entry__.py:56-241``: one
NFDM inverse-design training step sharded over a (data, seq) mesh of ranks
(:func:`sharded_train_step`: the D-sharded contspec, the spectral L2 loss,
the backward through the butterfly's exchanges and K1T, an Adam update),
then the sharded bound-state refinement, nsep Newton, 4SPLIT4B and kdvv
contspecs and the inverse with distributed FFTs. The parameters are the
signal, so there are no weights to carry over.
"""

from __future__ import annotations

import numpy as np
import torch

from fnft_tpu_torch.models import nse
from fnft_tpu_torch.models.discretization import Discretization
from fnft_tpu_torch.models.nsev import (_array_device, _as_signal,
                                        _chirpz_points)
from fnft_tpu_torch.ops.fscatter import fscatter, transfer_matrix_coeffs
from fnft_tpu_torch.ops.poly import chirpz, fmult2x2_tree
from fnft_tpu_torch.parallel import dshard
from fnft_tpu_torch.parallel.dshard_boundstates import make_dshard_boundstates
from fnft_tpu_torch.parallel.dshard_inverse import dshard_finvscatter
from fnft_tpu_torch.parallel.dshard_nsep import make_dshard_nsep_refine
from fnft_tpu_torch.parallel.mesh import MeshAxis, make_mesh, spawn


def rho_pipeline(d: int, m: int, t_span, xi_span, *, device=None):
    """A ``q[B, D] -> rho[B, M]`` closure of a fixed geometry (2SPLIT4B,
    focusing). A tensor stays on its device and in its precision; an array
    goes to ``device`` (default: the CUDA device; raises without one)."""
    dev = _array_device(device)
    disc = Discretization.SPLIT4B
    t0, t1 = t_span
    xi0, xi1 = xi_span
    eps_t = (t1 - t0) / (d - 1)
    a_pt, w_pt = _chirpz_points(eps_t, xi0, xi1, m, disc)
    pf_rho = nse.phase_factor_rho(eps_t, t1, disc)

    def rho(q):
        q = _as_signal(q, dev)
        r = -torch.conj(q)
        p = transfer_matrix_coeffs(q, r, eps_t, disc)
        tm, _ = fmult2x2_tree(p, normalize=True, want=((0, 0), (1, 0)),
                              jsym=+1)
        h11 = chirpz(tm[..., 0, 0, :], a_pt, w_pt, m)
        h21 = chirpz(tm[..., 1, 0, :], a_pt, w_pt, m)
        xi = torch.linspace(xi0, xi1, m, dtype=q.real.dtype, device=q.device)
        return h21 * torch.exp(1j * xi * pf_rho) / h11

    return rho


def entry(device=None):
    """(fn, example_args): the JAX package's compile-check example (D = M =
    1024, a batch of 4 sechs in complex64)."""
    d, m, batch = 1024, 1024, 4
    t = np.linspace(-25.0, 25.0, d)
    q = np.stack([1j * (1.0 + 0.5 * k) / np.cosh(t) for k in range(batch)])
    rho = rho_pipeline(d, m, (-25.0, 25.0), (-2.0, 2.0), device=device)
    return rho, (q.astype(np.complex64),)


DRYRUN_T, DRYRUN_XI = (-8.0, 8.0), (-2.0, 2.0)


def dryrun_batch(batch: int, d: int) -> np.ndarray:
    """The dry run's signals ``[batch, D]`` on T = (-8, 8):
    i (0.8 + 0.1 k) / cosh(t)."""
    t = np.linspace(*DRYRUN_T, d)
    return np.stack([(0.8 + 0.1 * k) / np.cosh(t) * 1j
                     for k in range(batch)]).astype(np.complex128)


def sharded_train_step(q0: torch.Tensor, mesh, m: int) -> dict:
    """The dry run's training step, called in every rank of a ("data",
    "seq") mesh with the full batch ``q0 [B, D]`` (on T = (-8, 8), on the
    compute device) and M spectral points on XI = (-2, 2).

    The target is the D-sharded spectrum of the batch rolled by 3 samples;
    the parameters, real ``[2, B, D]`` (Re q, Im q), are sharded as
    ``(None, data, seq)``: each rank holds its ``[2, B/data, D/seq]``
    block and its ``[B/data, M/seq]`` block of the spectra. The loss is
    sum |rho - target|^2 / (B M), summed over the ranks; each rank's
    backward runs through the butterfly's exchanges (whose backward sends
    the cotangents back) and K1's backward K1T, then Adam (lr 1e-2)
    updates its block. Returns the (global) loss, this rank's gradient
    block and its parameter block after the update."""
    b, d = q0.shape
    fn = dshard.make_dshard_contspec(d, DRYRUN_T, m, DRYRUN_XI, mesh,
                                     batch_axis="data")
    seq, data = MeshAxis(mesh, "seq"), MeshAxis(mesh, "data")
    with torch.no_grad():
        target = fn(torch.roll(q0, 3, -1))["rho"]
    p = seq.block(data.block(torch.stack([q0.real, q0.imag]), 1)).clone()
    p.requires_grad_(True)
    opt = torch.optim.Adam([p], lr=1e-2)
    rho = fn.local(p[0] + 1j * p[1])["rho"]
    loss = torch.sum(torch.abs(rho - target) ** 2) / (b * m)
    loss.backward()
    grad = p.grad.detach().clone()
    opt.step()
    return {"loss": float(data.psum(seq.psum(loss.detach()))),
            "grad": grad, "params": p.detach()}


def dryrun_rank(rank: int, world_size: int, device: str = "cuda",
                batch: int | None = None, d: int = 256,
                m: int | None = None) -> dict:
    """One rank of :func:`dryrun_multichip` in an initialized world of
    ``world_size`` ranks, its tensors on ``device``: the sharded training
    step on a (data, seq) mesh (seq = 2 for an even world), then, on a
    ``seq`` mesh over the world, the bound-state refinement (D = 512, BO,
    3 sweeps), the nsep refinement (D = 512, the 2SPLIT2A Newton base),
    the 4SPLIT4B and kdvv contspecs and the inverse with distributed FFTs
    (D = 512). Raises on a non-finite result; returns this rank's
    results."""
    dev = torch.device(device)
    seq_n = 2 if world_size % 2 == 0 else 1
    mesh = make_mesh(("data", "seq"), shape=(world_size // seq_n, seq_n))
    m = m or d
    batch = batch or 2 * (world_size // seq_n)
    q0 = torch.as_tensor(dryrun_batch(batch, d), device=dev)
    out = {"train": sharded_train_step(q0, mesh, m)}
    if not np.isfinite(out["train"]["loss"]):
        raise FloatingPointError("training step produced a non-finite loss")

    # the D-sharded discrete spectrum: one bound-state refinement
    seq_mesh = make_mesh(("seq",))
    d_bs, t_bs = 512, (-12.0, 12.0)
    eps_bs = 24.0 / (d_bs - 1)
    q_bs = torch.as_tensor(1.7j / np.cosh(np.linspace(*t_bs, d_bs)),
                           device=dev)
    q_eff, r_eff, _, _ = nse.preprocess_signal(q_bs, eps_bs, +1,
                                               Discretization.BO)
    bs_fn = make_dshard_boundstates(d_bs, t_bs, seq_mesh,
                                    disc=Discretization.BO, niter=3)
    lam0 = torch.tensor([0.01 + 0.68j, -0.01 + 1.72j], dtype=torch.complex128,
                        device=dev)
    out["bound_states"] = bs_fn(q_eff, r_eff, lam0, (-5.0, 5.0, 0.0, 10.0))

    # the D-sharded periodic (nsep) Newton refinement
    d_p, t_p = 512, (0.0, 2 * np.pi)
    eps_p = (t_p[1] - t_p[0]) / d_p
    q_p = torch.as_tensor(2.0 * np.exp(3j * eps_p * np.arange(d_p)),
                          device=dev)
    base_p = nse.newton_base_discretization(Discretization.SPLIT2A)
    qp_eff, rp_eff, _, _ = nse.preprocess_signal(q_p, eps_p, +1, base_p)
    rmain, raux = make_dshard_nsep_refine(d_p, seq_mesh, eps_t=eps_p,
                                          base_disc=base_p, iters_main=2,
                                          iters_aux=3)
    lam_m = torch.tensor([-1.5 + 1.93j, -1.5 + 1.73j], dtype=torch.complex128,
                         device=dev)
    out["nsep_main"] = rmain(qp_eff, rp_eff, lam_m,
                             torch.tensor([2.0, -2.0], dtype=torch.float64,
                                          device=dev), 1e-6)
    out["nsep_aux"] = raux(qp_eff, rp_eff, lam_m, 1e-6)

    # the upsampled scheme (4SPLIT4B: q gathered once for the stages)
    t = np.linspace(*DRYRUN_T, d)
    out["rho_4split4b"] = dshard.make_dshard_contspec(
        d, DRYRUN_T, m, DRYRUN_XI, seq_mesh, disc=Discretization.SPLIT4B4)(
            torch.as_tensor(1.1j / np.cosh(t), device=dev))["rho"]

    # the KdV contspec (real-coefficient chunk trees, negated grid)
    out["rho_kdvv"] = dshard.make_dshard_kdvv_contspec(
        d, DRYRUN_T, m, (-1.5, 1.5), seq_mesh)(
            torch.as_tensor(2.0 / np.cosh(t) ** 2, device=dev))["rho"]

    # the inverse: the top products' FFTs divided over the seq axis
    d_inv = 512
    rng = np.random.default_rng(11)
    q_i = torch.as_tensor((rng.normal(size=d_inv)
                           + 1j * rng.normal(size=d_inv)) * 0.2, device=dev)
    eps_i = 16.0 / (d_inv - 1)
    tm_i, _ = fscatter(q_i, -torch.conj(q_i), eps_i, Discretization.SPLIT2A,
                       normalize=False)
    q_rec = dshard_finvscatter(tm_i, eps_i, +1, seq_mesh,
                               min_sharded_deg=128)
    out["inverse_err"] = float((q_rec - q_i).abs().max()
                               / q_i.abs().max())
    for key in ("bound_states", "nsep_main", "nsep_aux", "rho_4split4b",
                "rho_kdvv"):
        vals = out[key][0] if key == "bound_states" else out[key]
        if not bool(torch.isfinite(torch.view_as_real(vals)).all()):
            raise FloatingPointError(f"dry run: {key} not finite")
    if not out["inverse_err"] < 1e-3:
        raise FloatingPointError(f"inverse dry run mismatch: "
                                 f"{out['inverse_err']}")
    return out


def dryrun_multichip(n_devices: int, *, device=None) -> list:
    """One sharded NFDM inverse-design training step, and the other
    D-sharded transforms, on ``n_devices`` ranks (:func:`dryrun_rank` at
    the JAX dry run's sizes, complex128). The ranks are spawned
    (``parallel.spawn``) on ``device`` (default: the CUDA device; raises
    without one): over NCCL when each rank has a card of its own, else
    over gloo, whose exchanges go through the host. Returns each rank's
    results, in rank order."""
    dev = _array_device(device)
    backend = ("nccl" if dev.type == "cuda"
               and torch.cuda.device_count() >= n_devices else "gloo")
    return spawn(dryrun_rank, n_devices, dev.type, backend=backend)
