"""fnft_tpu_torch: the PyTorch + CUDA port of fnft_tpu, for NVIDIA Hopper.

The public names are those of :mod:`fnft_tpu` for what is ported so far:
:func:`nsev` (forward NFT, nonlinear Schroedinger, vanishing BC) with the
2SPLIT4B discretization and its options. Work runs on the device of the
input tensor, in its precision (complex128 by default); an input that is
not a tensor goes to the CUDA device unless ``device=`` names another, and
without CUDA that default raises. On a CUDA tensor the
two hot kernels run as hand-written sm_90a CUDA (``csrc/``, built with nvcc
at first use); on a CPU tensor their plain PyTorch versions run.

This package never imports jax; :mod:`fnft_tpu` is its reference in the
tests only.
"""

from fnft_tpu_torch.config import default_complex_dtype
from fnft_tpu_torch.models.discretization import Discretization
from fnft_tpu_torch.models.nsev import (
    BoundStateFilter,
    BoundStateLocalization,
    ContspecType,
    DiscspecType,
    NsevOpts,
    NsevResult,
    nsev,
    nsev_with_initial_states,
)

__version__ = "0.1.0"
FNFT_REFERENCE_VERSION = (0, 4, 1, "")  # parity target: fnft_version.c:26-45


def fnft_version():
    """(major, minor, patch, suffix), as ``fnft_tpu.fnft_version``; the
    suffix marks the CUDA port."""
    major, minor, patch = (int(x) for x in __version__.split("."))
    return (major, minor, patch, "-cuda")


__all__ = [
    "nsev", "nsev_with_initial_states", "NsevOpts", "NsevResult",
    "fnft_version", "Discretization", "BoundStateFilter",
    "BoundStateLocalization", "DiscspecType", "ContspecType",
    "default_complex_dtype",
]
