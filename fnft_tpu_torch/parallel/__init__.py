"""Batched and D-sharded transforms (port of ``fnft_tpu.parallel``).

A batch of signals is the leading tensor axis on one device. The D-axis
(time) sharded transforms and the ``mesh=`` route of the batched ones run
in every rank of an initialized ``torch.distributed`` world over a
``DeviceMesh`` (:func:`make_mesh`), with explicit collectives along one
mesh axis (:class:`MeshAxis`); :func:`spawn` starts such a world.
"""

from fnft_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshAxis,
    as_auto_mesh,
    make_mesh,
    spawn,
)
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
from fnft_tpu_torch.parallel.dshard import (  # noqa: F401
    dshard_contspec_reference,
    make_dshard_contspec,
    make_dshard_kdvv_contspec,
    make_gridsharded_chirpz,
)
from fnft_tpu_torch.parallel.dshard_boundstates import (  # noqa: F401
    dshard_boundstates_reference,
    make_dshard_boundstates,
)
from fnft_tpu_torch.parallel.dshard_inverse import (  # noqa: F401
    dshard_finvscatter,
    make_sharded_polymatmul,
    sharded_fft_reference,
)
from fnft_tpu_torch.parallel.dshard_nsep import (  # noqa: F401
    dshard_nsep_reference,
    make_dshard_nsep_refine,
)
