"""Data, tensor and sequence parallelism over processes.

Counterpart of ``diffma_tpu/parallel/``: ``mesh.py`` (the process groups of
a ``(dp, tp, sp)`` layout of ranks, the launch, replicated parameters and the
dp rank's rows), ``collectives.py`` (the sums of the sharded mixers, each
with its backward) and ``sequence.py`` (the sequence-parallel scans).
"""

from diffma_tpu_torch.parallel.mesh import (  # noqa: F401
    BACKEND_ENV,
    Mesh,
    init_distributed,
    make_mesh,
    shard_batch,
    shard_params,
)
from diffma_tpu_torch.parallel.sequence import (  # noqa: F401
    selective_scan_sequence_parallel,
    ssd_sequence_parallel,
)
