"""Batched transforms on one device (port of ``fnft_tpu.parallel``'s
batched functions): a batch of signals is the leading tensor axis.

The D-axis sharded transforms (``make_dshard_*``, ``dshard_*``) and the
``mesh=`` route of the batched ones wait for the port's
``torch.distributed`` slice (``ROADMAP.md`` Queue 1 item 15).
"""

from fnft_tpu_torch.parallel.sharding import (  # noqa: F401
    batched_nsev_contspec,
    make_nsev_batch_fn,
)
from fnft_tpu_torch.parallel.batch_full import (  # noqa: F401
    BatchedNsevResult,
    make_batched_full_nsev,
    make_batched_inverse_fn,
)
from fnft_tpu_torch.parallel.batch_nsep import (  # noqa: F401
    BatchedNsepResult,
    batched_nsep,
    make_batched_nsep_fn,
)
