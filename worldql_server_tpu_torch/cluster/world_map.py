"""World→shard and peer→shard placement (the cluster's one contract).

Every process in a cluster — the router and all N shards — must agree
on two pure functions, with NO coordination traffic:

* ``shard_of_world(world)``: which shard owns a world's spatial index,
  record store and WAL. Every world-scoped instruction (Area
  Subscribe/Unsubscribe, Local/GlobalMessage, Record*) routes here, so
  a world's subscriptions, records and fan-out resolution are always
  colocated on one shard — the property that lets each shard run the
  existing single-process engine end to end, unchanged.
* ``shard_of_peer(uuid)``: which shard HOMES a peer — owns its
  connect-back socket, heartbeat liveness, session parking and
  delivery-plane slot. Handshakes and heartbeats route here; every
  other shard holds a remote proxy whose writes ride the inter-shard
  ring to this home.

Both are stable hashes of wire-visible identity (blake2b — NEVER
Python's ``hash``, which is salted per process), so the mapping is
identical across processes and across restarts: a shard that comes
back after a SIGKILL recovers exactly the worlds it owned, and its WAL
replay re-covers exactly the records routed to it.

``WorldMap`` is deliberately pluggable: subclass and override
``shard_of_world`` for locality-aware placement (e.g. splitting one
hot world's regions across shards — the region key is already part of
the spatial key, so a future RegionMap can route by
``(world, region)`` without touching the router's forwarding loop).
Live resharding (``resharding/placement.py``) takes exactly this seam:
:class:`~.resharding.placement.PlacementMap` layers epoch-versioned
per-world/per-peer overrides on top of the stable hash, so a migrated
world routes to its NEW owner while everything else stays on the pure
hash below.
"""

from __future__ import annotations

import hashlib
import uuid as uuid_mod

#: domain-separation prefixes: a world named like a uuid hex string
#: must not collide with peer placement
_WORLD_TAG = b"wql.world\x00"
_PEER_TAG = b"wql.peer\x00"


def _stable_hash(tag: bytes, payload: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(tag + payload, digest_size=8).digest(), "big"
    )


class WorldMap:
    """Consistent world/peer → shard placement for an ``n_shards``
    cluster. Pure and process-independent — construct freely anywhere."""

    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = int(n_shards)

    def shard_of_world(self, world: str) -> int:
        """Owner shard of a world's index + records. The GLOBAL world
        ("@global") maps like any other name — exactly one shard owns
        the all-peers broadcast resolution."""
        return _stable_hash(_WORLD_TAG, world.encode()) % self.n_shards

    def shard_of_peer(self, peer: uuid_mod.UUID) -> int:
        """Home shard of a peer's transport + session state."""
        return _stable_hash(_PEER_TAG, peer.bytes) % self.n_shards

    def describe(self) -> dict:
        return {"kind": type(self).__name__, "n_shards": self.n_shards}
