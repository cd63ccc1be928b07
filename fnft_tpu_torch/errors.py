"""Error model.

A copy of ``fnft_tpu/errors.py``. The reference uses errno-style integer
codes with goto-cleanup (fnft__errwarn.h:36-114). Here:

* static / shape / argument errors -> raise Python exceptions on the host,
* data-dependent numerical failures on the device -> NaN propagation,
  surfaced by the public transforms (``nsev``).

Warnings go through the ``warnings`` module (the analogue of the reference's
pluggable printf, fnft_errwarn.c:42-60).
"""

from __future__ import annotations

import threading
import warnings


class FnftError(Exception):
    """Base class for fnft-tpu errors."""


class InvalidArgumentError(FnftError, ValueError):
    """Mirrors FNFT_EC_INVALID_ARGUMENT."""


class NotYetImplementedError(FnftError, NotImplementedError):
    """Mirrors FNFT_EC_NOT_YET_IMPLEMENTED."""


def check_arg(cond: bool, message: str) -> None:
    if not cond:
        raise InvalidArgumentError(message)


_warn_handler = None
_tls = threading.local()


def set_warn_handler(handler, *, thread_local: bool = False) -> None:
    """Install a custom warning sink, or None to restore the default.

    Mirrors the reference's pluggable printf (fnft_errwarn_setprintf,
    src/fnft_errwarn.c:52-60). The reference's function pointer is
    thread-local (fnft_errwarn.c:42-50); pass ``thread_local=True`` for the
    same isolation (the embedded C API used from threaded hosts installs
    per-thread sinks this way). The process-global sink remains the
    fallback for threads without one.
    """
    if thread_local:
        _tls.handler = handler
        return
    global _warn_handler
    _warn_handler = handler


def get_warn_handler():
    """Active sink for the calling thread (thread-local wins, then global)."""
    h = getattr(_tls, "handler", None)
    return h if h is not None else _warn_handler


def warn(message: str) -> None:
    """Soft condition reporting (reference: FNFT__WARN)."""
    handler = get_warn_handler()
    if handler is not None:
        handler(message)
        return
    warnings.warn(message, RuntimeWarning, stacklevel=2)
