"""Horizontal serving: world-sharded multi-process scale-out (ROADMAP 3).

``--cluster-shards N`` turns the single-process server into a serving
CLUSTER: a thin router tier owning the public ZMQ listener
(:mod:`.router`), N shard server processes each running the existing
engine end to end — own device backend, own WAL + recovery, own
entity plane, own overload governor (:mod:`.shard`, spawned and
supervised by :mod:`.supervisor`) — a stable world/peer placement
contract every process derives independently (:mod:`.world_map`), and
a full mesh of shared-memory rings carrying cross-shard delivery
frames (:mod:`.bus`, the delivery ring reused process-to-process).

``--cluster-shards 0`` (the default) never imports this package: the
single-process server stays byte for byte what it was.
"""

from .bus import InterShardBus, create_ring_mesh
from .router import ClusterRouter, ClusterRuntime, ShedMirror
from .shard import ClusterShardExtension
from .supervisor import (
    ClusterSupervisor,
    shard_argv,
    shard_http_port,
    shard_store_url,
    shard_wal_dir,
    shard_zmq_port,
)
from .world_map import WorldMap

__all__ = [
    "ClusterRouter",
    "ClusterRuntime",
    "ClusterShardExtension",
    "ClusterSupervisor",
    "InterShardBus",
    "ShedMirror",
    "WorldMap",
    "create_ring_mesh",
    "shard_argv",
    "shard_http_port",
    "shard_store_url",
    "shard_wal_dir",
    "shard_zmq_port",
]
