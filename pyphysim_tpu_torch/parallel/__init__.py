"""Device meshes over ``torch.distributed``: the port's data-parallel
layer (the counterpart of ``pyphysim_tpu/parallel/``, which the reference's
ipyparallel task farm became). One process per device; a repetition batch
is split in contiguous shards over a mesh axis and the shards are
all-gathered so that every rank holds the whole result."""

from .mesh import (gather_rows, init_multihost,  # noqa: F401
                   make_host_chip_mesh, make_mesh, shard_batch, shard_rows)
from .timeshard import corrupt_data_time_sharded  # noqa: F401
