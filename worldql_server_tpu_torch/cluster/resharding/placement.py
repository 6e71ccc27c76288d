"""Epoch-versioned placement: the resharding layer's one contract.

:class:`~..world_map.WorldMap` is a pure hash — identical in every
process, but immutable: one hot world pins one shard forever. This
module makes placement a VERSIONED document instead:

* ``PlacementMap`` extends the stable hash with per-world and per-peer
  OVERRIDES (world W now lives on shard B; a peer whose parked session
  migrated with W now homes on B — the cross-shard resume fix).
* Every change bumps a MONOTONE ``epoch``. The router stamps the epoch
  on every forward (``tracectx.wrap_epoch``); a shard holding a newer
  map rejects a stale-epoch frame for a world it no longer owns with a
  re-route hint instead of misapplying it.
* ``to_spec``/``apply_spec`` serialize the whole map as one JSON
  document. The router broadcasts it over the control channel at every
  flip and piggybacks the epoch on the ~1s state exchange, so every
  process converges with NO external coordinator: ``apply_spec`` is
  last-writer-wins on the epoch and a no-op for stale or same-epoch
  specs — applying specs in any order converges on the newest one.

The base hash stays authoritative for everything without an override,
so an empty ``PlacementMap`` at epoch 0 is behavior-identical to the
``WorldMap`` it replaces — ``--cluster-shards N`` without a migration
is byte for byte what it was.
"""

from __future__ import annotations

import uuid as uuid_mod

from ..world_map import WorldMap


class PlacementMap(WorldMap):
    """``WorldMap`` + monotone epoch + world/peer overrides."""

    def __init__(self, n_shards: int, epoch: int = 0):
        super().__init__(n_shards)
        if epoch < 0:
            raise ValueError("placement epoch must be >= 0")
        self.epoch = int(epoch)
        #: world name → owner shard (set by a completed migration)
        self.world_overrides: dict[str, int] = {}
        #: peer uuid hex → home shard (parked sessions that migrated
        #: with their world resume on the NEW owner with their token)
        self.peer_overrides: dict[str, int] = {}

    # region: placement

    def shard_of_world(self, world: str) -> int:
        override = self.world_overrides.get(world)
        if override is not None:
            return override
        return super().shard_of_world(world)

    def shard_of_peer(self, peer: uuid_mod.UUID) -> int:
        override = self.peer_overrides.get(peer.hex)
        if override is not None:
            return override
        return super().shard_of_peer(peer)

    def base_shard_of_world(self, world: str) -> int:
        """The hash placement, ignoring overrides (migration targets
        report "returned home" by clearing the override instead of
        carrying a redundant one forever)."""
        return super().shard_of_world(world)

    # endregion

    # region: mutation (router-side only; shards apply specs)

    def bump(self) -> int:
        """Advance the epoch (every placement change is versioned)."""
        self.epoch += 1
        return self.epoch

    def move_world(
        self, world: str, shard: int,
        peers: list[uuid_mod.UUID] | None = None,
    ) -> int:
        """Install a world override (plus the peer overrides for its
        migrated parked sessions) and bump the epoch — the migration
        coordinator's FLIP step. Returns the new epoch."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range")
        if self.base_shard_of_world(world) == shard:
            self.world_overrides.pop(world, None)
        else:
            self.world_overrides[world] = shard
        for peer in peers or ():
            if super().shard_of_peer(peer) == shard:
                self.peer_overrides.pop(peer.hex, None)
            else:
                self.peer_overrides[peer.hex] = shard
        return self.bump()

    def clear_peer(self, peer: uuid_mod.UUID) -> None:
        """A migrated peer fully tore down — its override has nothing
        left to route. No epoch bump: routing by the base hash for a
        DEAD peer is indistinguishable from the override."""
        self.peer_overrides.pop(peer.hex, None)

    # endregion

    # region: serialization (control-channel convergence)

    def to_spec(self) -> dict:
        """One JSON-safe document carrying the whole placement state —
        broadcast over control at every flip; ``apply_spec`` on any
        process converges it."""
        return {
            "epoch": self.epoch,
            "n_shards": self.n_shards,
            "worlds": dict(self.world_overrides),
            "peers": dict(self.peer_overrides),
        }

    def apply_spec(self, spec: dict) -> bool:
        """Adopt a newer placement document; stale/same-epoch specs are
        REJECTED (monotone convergence: specs applied in any arrival
        order end on the newest). True = adopted."""
        try:
            epoch = int(spec["epoch"])
            worlds = {
                str(w): int(s) for w, s in (spec.get("worlds") or {}).items()
            }
            peers = {
                str(p): int(s) for p, s in (spec.get("peers") or {}).items()
            }
        except (KeyError, TypeError, ValueError):
            return False
        if epoch <= self.epoch:
            return False
        self.epoch = epoch
        self.world_overrides = worlds
        self.peer_overrides = peers
        return True

    @classmethod
    def from_spec(cls, n_shards: int, spec: dict) -> "PlacementMap":
        pm = cls(n_shards)
        pm.epoch = -1  # any well-formed spec (epoch >= 0) applies
        if not pm.apply_spec(spec):
            pm.epoch = 0
        return pm

    # endregion

    def describe(self) -> dict:
        return {
            **super().describe(),
            "epoch": self.epoch,
            "world_overrides": len(self.world_overrides),
            "peer_overrides": len(self.peer_overrides),
        }
