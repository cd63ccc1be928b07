"""Device meshes, the collectives of the sharded transforms, and worlds of
ranks.

Port of the mesh layer of ``fnft_tpu/parallel/sharding.py`` (``make_mesh``,
``as_auto_mesh``) and of the collectives that the JAX package's
``shard_map`` bodies call (``lax.axis_index``, ``all_gather``,
``ppermute``, ``all_to_all``). A JAX mesh is one program over many
devices; here every rank is a process of an initialized
``torch.distributed`` world, the mesh a ``DeviceMesh`` over that world, and
each body runs in every rank on its own block with explicit collectives
along one named axis (:class:`MeshAxis`).

Transport follows the axis group's backend, decided once:

* NCCL takes the tensors as they are, on their device;
* gloo exchanges host tensors only. A CUDA tensor is copied to the host,
  exchanged and copied back to its device; the compute stays on the card.
  (Several ranks sharing one card need gloo: NCCL refuses two ranks on one
  GPU.)

Nothing falls back from one to the other. Complex tensors travel as their
real views, booleans as bytes.

The three collectives are differentiable: ``ppermute_xor`` sends the
cotangent back along the same pairs (an XOR permutation is its own
inverse), ``all_gather``'s backward sums the cotangent over the axis and
keeps this rank's block, and ``all_to_all``'s is the transpose exchange.

:func:`spawn` starts a world of ranks as processes (the ``spawn`` start
method, which CUDA in a child process needs), runs one function in each
and returns their results: the tests' gloo worlds on the CPU, the chip
run's worlds on the card, and :func:`fnft_tpu_torch.entry.dryrun_multichip`.
"""

from __future__ import annotations

import datetime
import math
import multiprocessing as mp
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def mesh_shape(n: int, n_axes: int) -> tuple[int, ...]:
    """The JAX package's factoring of ``n`` devices over ``n_axes`` axes:
    the largest divisor <= sqrt(remaining) goes to the later axes, so 8 on
    two axes gives (4, 2) (``fnft_tpu/parallel/sharding.py:48-72``)."""
    shape = []
    remaining = n
    for _ in range(n_axes - 1):
        s = 1
        for cand in range(1, math.isqrt(remaining) + 1):
            if remaining % cand == 0:
                s = cand
        shape.append(remaining // s)
        remaining = s
    shape.append(remaining)
    return tuple(shape)


def make_mesh(axis_names=("batch",), shape=None) -> DeviceMesh:
    """A ``DeviceMesh`` over the initialized world, ``shape`` (default:
    :func:`mesh_shape` of the world size) over ``axis_names``. The mesh's
    device type follows the world's backend (``cuda`` for NCCL, ``cpu``
    for gloo); the tensors' own device is where the work runs."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "world (see fnft_tpu_torch.parallel.spawn)")
    axis_names = tuple(axis_names)
    shape = tuple(shape or mesh_shape(dist.get_world_size(), len(axis_names)))
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)


def as_auto_mesh(mesh):
    """The mesh itself: a ``DeviceMesh`` has no sharding-axis types to
    normalize (the JAX package's ``as_auto_mesh`` rebuilds an Explicit
    mesh with Auto axes)."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a torch DeviceMesh is required, got {type(mesh)}")
    return mesh


class MeshAxis:
    """This rank's place on one named axis of a mesh, and the collectives
    along it: ``index`` and ``size`` (``lax.axis_index``, the axis'
    size), :meth:`all_gather`, :meth:`ppermute_xor` and
    :meth:`all_to_all`."""

    def __init__(self, mesh: DeviceMesh, name: str):
        self.name = name
        self.group = mesh.get_group(name)
        self.size = mesh.size(mesh.mesh_dim_names.index(name))
        self.index = mesh.get_local_rank(name)
        self.ranks = dist.get_process_group_ranks(self.group)
        self.staged = dist.get_backend(self.group) == "gloo"

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as it travels: real view, bytes for booleans, a host copy
        on a gloo group."""
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        if x.is_complex():
            x = torch.view_as_real(x)
        if self.staged:
            x = x.cpu()
        return x.contiguous()

    @staticmethod
    def _unwire(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        buf = buf.to(like.device)
        if like.is_complex():
            buf = torch.view_as_complex(buf)
        return buf.to(like.dtype)

    def block(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's contiguous block of ``x`` along ``dim`` (whose
        length the axis size must divide)."""
        n, rest = divmod(x.shape[dim], self.size)
        if rest:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"{self.size} ways over '{self.name}'")
        return x.narrow(dim, self.index * n, n)

    def all_gather(self, x: torch.Tensor, dim: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        """The blocks of every rank of the axis, in axis order: stacked
        along a new ``dim``, or concatenated along ``dim`` with
        ``tiled``."""
        return _AllGather.apply(x, self, dim, tiled)

    def ppermute_xor(self, x: torch.Tensor, bit: int) -> torch.Tensor:
        """The block of the rank at axis index ``index ^ bit``, which
        receives this rank's block in exchange."""
        return _PpermuteXor.apply(x, self, bit)

    def all_to_all(self, x: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """Tiled all-to-all: ``x`` cut into ``size`` blocks along
        ``split_dim``, block j to the rank of index j; the blocks received
        concatenated along ``concat_dim`` in axis order."""
        return _AllToAll.apply(x, self, split_dim, concat_dim)

    # -- the exchanges themselves, without autograd -------------------------

    def _gather(self, x, dim, tiled):
        wire = self._wire(x)
        bufs = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(bufs, wire, group=self.group)
        parts = [self._unwire(b, x) for b in bufs]
        dim = dim % (x.dim() + (0 if tiled else 1))
        return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the axis (not differentiated)."""
        wire = self._wire(x)
        dist.all_reduce(wire, group=self.group)
        return self._unwire(wire, x)

    def _exchange(self, x, bit):
        partner = self.ranks[self.index ^ bit]
        send = self._wire(x)
        recv = torch.empty_like(send)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, partner, self.group),
            dist.P2POp(dist.irecv, recv, partner, self.group)])
        for req in reqs:
            req.wait()
        return self._unwire(recv, x)

    def _transpose(self, x, split_dim, concat_dim):
        split_dim %= x.dim()
        concat_dim %= x.dim()
        n = self.size
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)}"
                             f" does not split {n} ways")
        blocks = x.unflatten(split_dim, (n, x.shape[split_dim] // n))
        blocks = blocks.movedim(split_dim, 0)
        send = self._wire(blocks)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        got = self._unwire(recv, blocks)     # [n, ...block], sender order
        got = got.movedim(0, concat_dim)
        return got.flatten(concat_dim, concat_dim + 1)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, tiled):
        ctx.axis, ctx.tiled = axis, tiled
        ctx.dim = dim % (x.dim() + (not tiled))
        ctx.n = x.shape[ctx.dim] if tiled else 1
        return axis._gather(x, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        g = ctx.axis.psum(g.contiguous())
        i = ctx.axis.index
        if ctx.tiled:
            g = g.narrow(ctx.dim, i * ctx.n, ctx.n)
        else:
            g = g.select(ctx.dim, i)
        return g, None, None, None


class _PpermuteXor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, bit):
        ctx.axis, ctx.bit = axis, bit
        return axis._exchange(x, bit)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._exchange(g, ctx.bit), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.axis, ctx.split_dim, ctx.concat_dim = axis, split_dim, concat_dim
        return axis._transpose(x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.axis._transpose(g, ctx.concat_dim, ctx.split_dim),
                None, None, None)


# ---------------------------------------------------------------------------
# worlds of ranks as processes
# ---------------------------------------------------------------------------

# the longest a world may take (chip_smoke.py's world takes ~90 s)
WORLD_TIMEOUT = 900.0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(obj):
    """Tensors (nested in tuples, lists and dicts) as numpy arrays, so that
    a result pickles by value."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(fn, rank, world_size, backend, port, threads, args, out):
    try:
        if threads:
            torch.set_num_threads(threads)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=WORLD_TIMEOUT))
        try:
            result = _to_host(fn(rank, world_size, *args))
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except Exception:   # reported to the parent, which raises it
        out.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, *args, backend: str = "gloo",
          threads: int | None = 1) -> list:
    """Run ``fn(rank, world_size, *args)`` in each of ``world_size`` new
    processes joined in a ``torch.distributed`` world on ``backend``
    (``tcp://127.0.0.1``, a free port), and return the results in rank
    order, tensors as numpy arrays.

    ``fn`` and ``args`` are pickled (``fn`` by its import path). Each rank
    runs with ``threads`` intra-op threads (None: torch's default); an
    NCCL rank sets its card to ``rank % device_count``. If a rank raises,
    dies or the world outlasts ``WORLD_TIMEOUT`` seconds, every rank is
    stopped and this raises with the rank's traceback."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world_size, backend, port, threads,
                               args, out), daemon=True)
             for rank in range(world_size)]
    for p in procs:
        p.start()
    results, failure = {}, None
    deadline = time.monotonic() + WORLD_TIMEOUT
    try:
        while len(results) < world_size and failure is None:
            try:
                rank, ok, payload = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    failure = (f"rank {dead[0]} died with exit code "
                               f"{procs[dead[0]].exitcode}")
                elif time.monotonic() > deadline:
                    failure = (f"the world of {world_size} outlasted "
                               f"{WORLD_TIMEOUT} s")
                continue
            if ok:
                results[rank] = payload
            else:
                failure = f"rank {rank} raised:\n{payload}"
    finally:
        for p in procs:
            p.join(timeout=5.0 if failure is None else 0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
    if failure is not None:
        raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}): {failure}")
    return [results[r] for r in range(world_size)]
