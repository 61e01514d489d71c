"""Multi-process data parallelism and the sharded forwards (port of
nl_vsgg_tpu/parallel)."""

from .distributed import (DistributedBatcher, allgather_obj, init_distributed, is_primary,
                          merge_evaluators)
from .mesh import Mesh, data_parallel, make_mesh

__all__ = ["DistributedBatcher", "Mesh", "allgather_obj", "data_parallel", "init_distributed",
           "is_primary", "make_mesh", "merge_evaluators"]
