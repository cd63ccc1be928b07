"""Carrying options across from the JAX package.

The system has no weights; what a user carries from ``fnft_tpu`` to the
port is an options object and a signal. Signals go across as numpy arrays
(``torch.as_tensor(np.asarray(q))``); options through
:func:`opts_from_reference` (``NsevOpts``) and
:func:`kdvv_opts_from_reference` (``KdvvOpts``). Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses
import enum

from fnft_tpu_torch.models.kdvv import KdvvOpts
from fnft_tpu_torch.models.nsev import NsevOpts


def _carry(cls, ref_opts):
    """An instance of the port's options dataclass ``cls`` with every
    field read by name from ``ref_opts``; enum members map by ``.value``
    onto the port's enums (the field's default names the enum)."""
    kwargs = {}
    for field in dataclasses.fields(cls):
        value = getattr(ref_opts, field.name)
        if isinstance(field.default, enum.Enum):
            value = type(field.default)(value.value)
        kwargs[field.name] = value
    return cls(**kwargs)


def opts_from_reference(ref_opts) -> NsevOpts:
    """The port's :class:`NsevOpts` equal to an ``fnft_tpu.NsevOpts``
    (duck-typed: any object with the same field names)."""
    return _carry(NsevOpts, ref_opts)


def kdvv_opts_from_reference(ref_opts) -> KdvvOpts:
    """The port's :class:`KdvvOpts` equal to an ``fnft_tpu.KdvvOpts``."""
    return _carry(KdvvOpts, ref_opts)
