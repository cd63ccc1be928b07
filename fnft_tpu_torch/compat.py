"""Carrying options across from the JAX package.

The system has no weights; what a user carries from ``fnft_tpu`` to the
port is an options object and a signal. Signals go across as numpy arrays
(``torch.as_tensor(np.asarray(q))``); options through
:func:`opts_from_reference`. Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses
import enum

from fnft_tpu_torch.models.nsev import NsevOpts


def opts_from_reference(ref_opts) -> NsevOpts:
    """The port's :class:`NsevOpts` equal to an ``fnft_tpu.NsevOpts``.

    Duck-typed: every field of the port's options is read by name from
    ``ref_opts``; enum members map by ``.value`` onto the port's enums.
    """
    kwargs = {}
    for field in dataclasses.fields(NsevOpts):
        value = getattr(ref_opts, field.name)
        default = getattr(NsevOpts, field.name)
        if isinstance(default, enum.Enum):
            value = type(default)(value.value)
        kwargs[field.name] = value
    return NsevOpts(**kwargs)
