"""Batched forward NFT on one device: the continuous spectrum of q[B, D].

Port of the batched functions of ``fnft_tpu/parallel/sharding.py``. The
JAX package vmaps a per-signal program and jits it once per geometry; here
the batch is the leading tensor axis and every layer takes it: the
preprocessing indexes ``[..., idx]``, the fmult tree (and K1 in its first
levels, which folds the batch into its subtree count) works on
``[B, n, 2, 2, c]``, the chirp-Z transform on ``[B, 2, deg+1]`` rows. A
``make_*`` function fixes the geometry and returns a plain callable on
tensors, which holds the geometry's chirp-Z tables on the device.

Inputs follow the other entry points: a tensor stays on its device (and
in its precision), an array goes to ``device`` (default: the CUDA device;
without one the call raises). With ``mesh`` (a ``DeviceMesh`` over an
initialized world, see ``parallel/mesh.py``) every rank passes the full
batch, takes its B/size rows of the mesh's ``"batch"`` axis, and gets the
full batch of spectra back (an ``all_gather`` over that axis), as the JAX
package's ``mesh=`` route returns the global array.
"""

from __future__ import annotations

import torch

from fnft_tpu_torch.config import complex_dtype_of, default_complex_dtype
from fnft_tpu_torch.errors import check_arg
from fnft_tpu_torch.models import nse
from fnft_tpu_torch.models.discretization import (
    Discretization,
    degree,
    upsampling_factor,
)
from fnft_tpu_torch.models.nsev import (
    ContspecType,
    _apply_phase_factors,
    _array_device,
    _as_signal,
    _chirpz_points,
    _contspec_eval,
)
from fnft_tpu_torch.ops.fscatter import fscatter
from fnft_tpu_torch.ops.poly import _chirpz_tables
from fnft_tpu_torch.parallel.mesh import MeshAxis, as_auto_mesh


def _as_batch(q_batch, device) -> torch.Tensor:
    """``q [B, D]``: a tensor stays on its device, an array goes to
    ``device`` (see :func:`_array_device`)."""
    q = _as_signal(q_batch, device)
    check_arg(q.dim() == 2, f"a batch [B, D] is required, got "
              f"{tuple(q.shape)}")
    return q


def _batch_sharded(fn, mesh):
    """``fn`` on this rank's rows of the mesh's ``"batch"`` axis, the
    results (a tensor, or a tuple or dict of them, batch first) gathered
    back over that axis; ``fn`` itself without a mesh."""
    if as_auto_mesh(mesh) is None:
        return fn
    axis = MeshAxis(mesh, "batch")

    def gather(x):
        if isinstance(x, dict):
            return {k: gather(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(gather(v) for v in x)
        return axis.all_gather(x, dim=0, tiled=True)

    def run(*batches):
        return gather(fn(*(axis.block(b, 0) for b in batches)))

    return run


class _ContspecPass:
    """The contspec pass of one geometry over a batch, kept by the
    ``make_*`` functions: preprocessing, fscatter, chirp-Z (its tables
    held per dtype and device, built for ``device`` in the default dtype
    at once) and the phase factors."""

    def __init__(self, d, t_span, m, xi_span, kappa, disc, contspec_type,
                 device):
        check_arg(d >= 2, "D must be >= 2")
        self.t0, self.t1 = float(t_span[0]), float(t_span[1])
        check_arg(self.t0 < self.t1, "T[0] < T[1] required")
        check_arg(m >= 2, "M must be >= 2")
        self.xi0, self.xi1 = float(xi_span[0]), float(xi_span[1])
        check_arg(self.xi0 < self.xi1, "XI[0] < XI[1] required")
        check_arg(kappa in (-1, 1), "kappa must be +-1")
        self.d, self.m, self.kappa, self.disc = d, m, kappa, disc
        self.contspec_type = contspec_type
        self.eps_t = (self.t1 - self.t0) / (d - 1)
        self._tables = {}
        device = torch.empty(0, device=device).device   # cuda -> cuda:0
        if degree(disc) > 0:
            n = d * upsampling_factor(disc) * degree(disc) + 1
            self.tables(n, default_complex_dtype(), device)

    def tables(self, n, cdt, device):
        key = (n, cdt, device)
        if key not in self._tables:
            a, w = _chirpz_points(self.eps_t, self.xi0, self.xi1, self.m,
                                  self.disc)
            self._tables[key] = _chirpz_tables(a, w, n, self.m, cdt, device)
        return self._tables[key]

    def __call__(self, q: torch.Tensor):
        """(contspec dict of ``[B, M]`` tensors, q_eff, r_eff)."""
        check_arg(q.shape[-1] == self.d,
                  f"the geometry has D={self.d}, got {q.shape[-1]} samples")
        q_eff, r_eff, _, _ = nse.preprocess_signal(q, self.eps_t, self.kappa,
                                                   self.disc)
        tm, w = fscatter(q_eff, r_eff, self.eps_t, self.disc,
                         want=((0, 0), (1, 0)), jsym=self.kappa)
        tables = None
        if degree(self.disc) > 0:
            tables = self.tables(tm.shape[-1], complex_dtype_of(q), q.device)
        h11, h21 = _contspec_eval(tm, q_eff, r_eff, self.eps_t, self.xi0,
                                  self.xi1, self.m, self.disc, tables)
        cs = _apply_phase_factors(h11, h21, w, self.eps_t, self.t0, self.t1,
                                  self.d, self.xi0, self.xi1, self.m,
                                  self.disc, self.contspec_type)
        return cs, q_eff, r_eff


def make_nsev_batch_fn(d: int, t_span, m: int, xi_span, *, kappa: int = +1,
                       disc: Discretization = Discretization.SPLIT4B,
                       contspec_type=None, mesh=None, device=None):
    """A reusable batched forward NFT ``q[B, D] -> spectra``.

    The returned callable keeps the (D, M, grid) geometry and returns a
    dict with 'rho' (and 'a', 'b' when contspec_type is AB/BOTH), each
    ``[B, M]`` on the input's device. This is the serving entry point:
    feed it batches and keep the device busy. ``device`` is where array
    inputs go and where the tables are built (default: the CUDA device;
    raises without one). With ``mesh`` each rank computes its rows of the
    ``"batch"`` axis and returns the full batch.
    """
    dev = _array_device(device)
    run = _ContspecPass(d, t_span, m, xi_span, kappa, disc,
                        contspec_type or ContspecType.REFLECTION_COEFFICIENT,
                        dev)
    sharded = _batch_sharded(lambda q: run(q)[0], mesh)

    def fn(q_batch):
        return sharded(_as_batch(q_batch, dev))

    return fn


def batched_nsev_contspec(q_batch, t_span, m: int, xi_span, *,
                          kappa: int = +1,
                          disc: Discretization = Discretization.SPLIT4B,
                          mesh=None, device=None):
    """Reflection coefficients ``rho [B, M]`` of a batch of signals
    ``q_batch [B, D]`` (``device`` as in :func:`make_nsev_batch_fn`, for an
    array input; ``mesh`` shards the batch over its ``"batch"`` axis)."""
    q = _as_batch(q_batch, device)
    run = _ContspecPass(q.shape[-1], t_span, m, xi_span, kappa, disc,
                        ContspecType.REFLECTION_COEFFICIENT, q.device)
    return _batch_sharded(lambda qb: run(qb)[0]["rho"], mesh)(q)
