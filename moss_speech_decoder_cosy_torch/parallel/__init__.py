"""Multi-device fan-out over ``torch.distributed`` (the JAX package's
``parallel/``): process groups and host sharding (``distributed``), devices
and data-parallel / ZeRO sharding (``mesh``), tensor parallelism for the
speech LMs (``tp``)."""

from .distributed import (host_shard, initialize, local_rows, rank,  # noqa
                          world_size)
from .mesh import DataGroup, data_group, make_mesh, zero_sharding  # noqa
from .tp import (tensor_parallel, tp_global_norm, tp_shard_params,  # noqa
                 tp_specs)
