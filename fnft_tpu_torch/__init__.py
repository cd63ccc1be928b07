"""fnft_tpu_torch: the PyTorch + CUDA port of fnft_tpu, for NVIDIA Hopper.

The public names are those of :mod:`fnft_tpu` for what is ported so far:
:func:`nsev` (forward NFT, nonlinear Schroedinger, vanishing BC) with every
discretization (the 21 fast splitting schemes and the slow BO, CF4_2,
CF4_3, CF5_3, CF6_4, ES4, TES4), all its options and Richardson
extrapolation; :func:`nsep` (periodic and quasi-periodic NSE: main and
auxiliary spectra by grid search, subsample-and-refine or both);
:func:`nsev_inverse` (inverse NFT, vanishing BC: the three continuous-
spectrum representations, fast inverse scattering, Darboux transforms for
the discrete spectrum); and :func:`kdvv` (Korteweg-de Vries, vanishing BC)
with :func:`kdvv_bound_states` and :func:`kdv_scatter_matrix`. Work runs on
the device of the input tensor, in its precision (complex128 by default);
an input that is not a tensor goes to the CUDA device unless ``device=``
names another, and without CUDA that default raises. On a CUDA tensor the
two hot kernels run as hand-written sm_90a CUDA (``csrc/``, built with nvcc
at first use); on a CPU tensor their plain PyTorch versions run.
:mod:`fnft_tpu_torch.parallel` holds the batched transforms (a batch of
signals as the leading tensor axis): the continuous spectrum, the full
spectrum, the inverse and nsep, and the D-axis (time) sharded transforms
over a ``torch.distributed`` world (a ``DeviceMesh`` and explicit
collectives; :func:`fnft_tpu_torch.entry.dryrun_multichip` is the sharded
training step). The fast continuous spectrum is
differentiable on the card too (K1's backward is a third kernel; the
inverse-design pipeline is :func:`fnft_tpu_torch.entry.rho_pipeline`).
:mod:`fnft_tpu_torch.capi` is the C API of ``fnft_tpu.h`` over the port,
:mod:`fnft_tpu_torch.examples` the twins of the JAX package's examples.

This package never imports jax; :mod:`fnft_tpu` is its reference in the
tests only.
"""

from fnft_tpu_torch.config import default_complex_dtype
from fnft_tpu_torch.models.discretization import Discretization
from fnft_tpu_torch.models.kdvv import (
    KdvvOpts,
    KdvvResult,
    kdv_fscatter,
    kdv_scatter_matrix,
    kdvv,
    kdvv_bound_states,
)
from fnft_tpu_torch.models.nsep import (
    Localization,
    NsepOpts,
    NsepResult,
    PointFilter,
    nsep,
)
from fnft_tpu_torch.models.nsev import (
    BoundStateFilter,
    BoundStateLocalization,
    ContspecType,
    DiscspecType,
    NsevOpts,
    NsevResult,
    nsev,
    nsev_max_k,
    nsev_with_initial_states,
)
from fnft_tpu_torch.models.nsev_inverse import (
    InverseContspecType,
    InverseCstMethod,
    InverseDiscspecType,
    NsevInverseOpts,
    nsev_inverse,
    nsev_inverse_xi_grid,
)

from fnft_tpu_torch import parallel  # noqa: F401,E402

__version__ = "0.1.0"
FNFT_REFERENCE_VERSION = (0, 4, 1, "")  # parity target: fnft_version.c:26-45


def fnft_version():
    """(major, minor, patch, suffix), as ``fnft_tpu.fnft_version``; the
    suffix marks the CUDA port."""
    major, minor, patch = (int(x) for x in __version__.split("."))
    return (major, minor, patch, "-cuda")


__all__ = [
    "nsev", "nsev_with_initial_states", "nsev_max_k", "NsevOpts",
    "NsevResult", "kdvv", "kdvv_bound_states", "kdv_scatter_matrix",
    "kdv_fscatter", "KdvvOpts", "KdvvResult",
    "fnft_version", "Discretization", "BoundStateFilter",
    "BoundStateLocalization", "DiscspecType", "ContspecType",
    "default_complex_dtype", "nsep", "NsepOpts", "NsepResult",
    "Localization", "PointFilter", "nsev_inverse", "nsev_inverse_xi_grid",
    "NsevInverseOpts", "InverseContspecType", "InverseCstMethod",
    "InverseDiscspecType",
]
