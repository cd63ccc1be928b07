"""Operators of the PyTorch port: tree, chirp-Z, scattering sweeps, roots,
and the hand-written CUDA kernels (``kernels``, built by ``_build``)."""

from fnft_tpu_torch.ops.poly import chirpz, fmult2x2_tree  # noqa: F401
from fnft_tpu_torch.ops.roots import aberth_roots, poly_roots  # noqa: F401
