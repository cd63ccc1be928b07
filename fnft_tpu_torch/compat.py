"""Carrying options across from the JAX package.

The system has no weights; what a user carries from ``fnft_tpu`` to the
port is an options object and a signal. Signals go across as numpy arrays
(``torch.as_tensor(np.asarray(q))``); options through
:func:`opts_from_reference` (``NsevOpts``), :func:`kdvv_opts_from_reference`
(``KdvvOpts``), :func:`nsep_opts_from_reference` (``NsepOpts``) and
:func:`nsev_inverse_opts_from_reference` (``NsevInverseOpts``). Nothing
here imports jax.
"""

from __future__ import annotations

import dataclasses
import enum

from fnft_tpu_torch.models.kdvv import KdvvOpts
from fnft_tpu_torch.models.nsep import NsepOpts
from fnft_tpu_torch.models.nsev import NsevOpts
from fnft_tpu_torch.models.nsev_inverse import NsevInverseOpts


def _carry(cls, ref_opts):
    """An instance of the port's options dataclass ``cls`` with every
    field read by name from ``ref_opts``; enum members map by ``.value``
    onto the port's enums (the field's default names the enum), and tuple
    fields (``bounding_box``, ``floquet_range``) are copied."""
    kwargs = {}
    for field in dataclasses.fields(cls):
        value = getattr(ref_opts, field.name)
        if isinstance(field.default, enum.Enum):
            value = type(field.default)(value.value)
        elif isinstance(field.default, tuple):
            value = tuple(value)
        kwargs[field.name] = value
    return cls(**kwargs)


def opts_from_reference(ref_opts) -> NsevOpts:
    """The port's :class:`NsevOpts` equal to an ``fnft_tpu.NsevOpts``
    (duck-typed: any object with the same field names)."""
    return _carry(NsevOpts, ref_opts)


def kdvv_opts_from_reference(ref_opts) -> KdvvOpts:
    """The port's :class:`KdvvOpts` equal to an ``fnft_tpu.KdvvOpts``."""
    return _carry(KdvvOpts, ref_opts)


def nsep_opts_from_reference(ref_opts) -> NsepOpts:
    """The port's :class:`NsepOpts` equal to an ``fnft_tpu.NsepOpts``."""
    return _carry(NsepOpts, ref_opts)


def nsev_inverse_opts_from_reference(ref_opts) -> NsevInverseOpts:
    """The port's :class:`NsevInverseOpts` equal to an
    ``fnft_tpu.NsevInverseOpts``."""
    return _carry(NsevInverseOpts, ref_opts)
