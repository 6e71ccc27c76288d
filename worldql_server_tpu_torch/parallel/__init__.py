"""Multi-device scale-out: mesh construction and the sharded spatial
backend (``--spatial-backend sharded``).

Port of the JAX package's ``parallel/``. The scale axis is a
:class:`~.mesh.FanoutMesh`: subscriptions shard across the ``space``
axis (sharding space, not sequence), query batches across the ``batch``
axis (data parallelism), and per-query partial results combine with one
elementwise max over ``space`` — in one process a max over the shards'
tensors, across processes one ``torch.distributed`` all-reduce.
"""

from .mesh import FanoutMesh, make_fanout_mesh, maybe_initialize_distributed
from .sharded_backend import ShardedCudaSpatialBackend

__all__ = [
    "FanoutMesh",
    "make_fanout_mesh",
    "maybe_initialize_distributed",
    "ShardedCudaSpatialBackend",
]
