"""Live resharding: epoch-versioned placement + zero-loss
online world migration + the autoshard loop.

* :mod:`.placement` — :class:`PlacementMap`: the stable hash plus
  monotone-epoch world/peer overrides, converged over the control
  channel with no external coordinator.
* :mod:`.transfer` — the bounded transfer buffer (counted shed, never
  silent loss) and the CRC-framed chunk codec the capsule streams
  over.
* :mod:`.worldstate` — the shard-side capsule: export / import /
  tombstone of one world's records, index rows, entity rows and
  parked sessions, always THROUGH the durability pipeline.
* :mod:`.migration` — :class:`MigrationCoordinator`: the router-side
  protocol state machine (freeze → stream → import → flip → replay →
  tombstone) with exactly-one-WAL-owner crash safety at every state.
* :mod:`.controller` — :class:`AutoshardController`: sustained-hot
  shard detection → hottest-world migration (``--autoshard on``,
  default off).
"""

from .controller import AutoshardController
from .migration import (
    FENCE_MAGIC,
    MigrationCoordinator,
    MigrationError,
    fence_payload,
    parse_fence,
)
from .placement import PlacementMap
from .transfer import ChunkAssembler, TransferBuffer, encode_chunks
from .worldstate import export_world, import_world, tombstone_world

__all__ = [
    "AutoshardController",
    "ChunkAssembler",
    "FENCE_MAGIC",
    "MigrationCoordinator",
    "MigrationError",
    "PlacementMap",
    "TransferBuffer",
    "encode_chunks",
    "export_world",
    "fence_payload",
    "import_world",
    "parse_fence",
    "tombstone_world",
]
