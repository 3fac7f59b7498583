"""Several ranks over torch.distributed: the ('dp', 'k') mesh, the
sharded trainer and its collectives (port of dgps_with_iwvi_tpu/parallel).

Minibatch rows go over 'dp', importance samples over 'k'; gradients are
summed over every rank and the state stays replicated. Sharded
evaluation and serving split test rows over every rank
(``evaluation.evaluate(mesh=)``, ``dgp-serve-torch --shard``). A program
that is one process starts its ranks with ``launch.spawn_ranks``.
"""

from . import distributed, launch
from .mesh import make_mesh
from .sharding import make_parallel_trainer, replicate, shard_arrays

__all__ = ["distributed", "launch", "make_mesh", "make_parallel_trainer",
           "replicate", "shard_arrays"]
