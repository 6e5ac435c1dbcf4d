"""Data- and tensor-parallel training over ``torch.distributed``
(counterpart of ``pydreamer_tpu/parallel``, with the same names)."""

from .mesh import (DistributedContext, batch_sharding, make_mesh, param_shardings, replicated,
                   state_sharding)

__all__ = ["DistributedContext", "make_mesh", "param_shardings",
           "batch_sharding", "state_sharding", "replicated"]
