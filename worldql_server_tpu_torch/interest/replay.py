"""Wire-level replay clients: the eventual-state parity oracles.

:class:`ReplayClient` consumes an interest-managed stream
(``entity.frame.full`` / ``fullc`` / ``delta`` with epoch:seq stamps)
and maintains the neighbor state a real client would hold. It enforces
the contract the server claims to provide: a delta only ever applies
on a contiguous same-epoch sequence; any gap flips the client into
desync, where every frame is DISCARDED until a new epoch opens with a
keyframe. If the server were to leak a delta past a loss, the oracle
counts it in ``deltas_refused`` instead of silently corrupting state —
that counter staying at zero across the churn property is the proof.

:class:`LegacyClient` consumes the pre-interest stream (one
``entity.frame`` per entity plus ``entity.remove``) into the same
snapshot shape, so tests and the bench can assert byte-for-byte state
parity between ``--interest on`` and ``off``.
"""

from __future__ import annotations

import uuid as uuid_mod

from ..protocol import Message, deserialize_message
from .manager import PARAM_DELTA, PARAM_FULL, PARAM_FULL_CONT, parse_stamp

__all__ = ["ReplayClient", "LegacyClient"]


def _tombstone(entity) -> bool:
    return entity.flex is not None and len(entity.flex) < 12


def _as_message(frame) -> Message:
    if isinstance(frame, Message):
        return frame
    wire = getattr(frame, "wire", frame)
    return deserialize_message(bytes(wire))


class ReplayClient:
    """State a compliant client holds after replaying an interest
    stream. Feed every delivered frame (bytes, Message, or anything
    with ``.wire``) to :meth:`apply` in delivery order."""

    def __init__(self):
        #: world -> {uuid -> (x, y, z)}
        self.worlds: dict[str, dict[uuid_mod.UUID, tuple]] = {}
        self.epoch = -1
        self.next_seq = 0
        self.desync = True        # nothing applies before the first epoch
        self.frames_applied = 0
        self.fulls_applied = 0
        self.deltas_applied = 0
        self.gaps_seen = 0
        self.epochs_seen = 0
        self.deltas_refused = 0   # MUST stay 0: delta past a gap
        self.discarded = 0
        self.last_was_full = False

    def apply(self, frame) -> bool:
        """Apply one delivered frame; returns True if it mutated
        state, False if it was discarded (desync) or not an interest
        frame at all."""
        msg = _as_message(frame)
        stamped = parse_stamp(msg.parameter)
        if stamped is None:
            return False
        kind, epoch, seq = stamped

        if epoch > self.epoch:
            # a new epoch must open with its first keyframe; anything
            # else means we missed the head of the resync burst — stay
            # desynced until the next one
            if kind == PARAM_FULL and seq == 0:
                self.worlds.clear()
                self.epoch = epoch
                self.next_seq = 0
                self.desync = False
                self.epochs_seen += 1
            else:
                if kind == PARAM_DELTA:
                    self.deltas_refused += 1
                self.desync = True
                self.discarded += 1
                return False
        elif epoch < self.epoch:
            self.discarded += 1   # stale straggler from a closed epoch
            return False

        if seq != self.next_seq:
            self.gaps_seen += 1
            self.desync = True
        if self.desync:
            if kind == PARAM_DELTA:
                self.deltas_refused += 1
            self.discarded += 1
            return False
        self.next_seq = seq + 1

        world = self.worlds.setdefault(msg.world_name, {})
        if kind == PARAM_FULL:
            world.clear()
        for ent in msg.entities:
            if _tombstone(ent):
                world.pop(ent.uuid, None)
            else:
                p = ent.position
                world[ent.uuid] = (p.x, p.y, p.z)
        if not world:
            self.worlds.pop(msg.world_name, None)
        self.frames_applied += 1
        self.last_was_full = kind in (PARAM_FULL, PARAM_FULL_CONT)
        if self.last_was_full:
            self.fulls_applied += 1
        else:
            self.deltas_applied += 1
        return True

    def snapshot(self) -> dict:
        """``{world: {uuid: (x, y, z)}}`` — compare against another
        client's snapshot for eventual-state parity."""
        return {w: dict(m) for w, m in self.worlds.items() if m}

    def stats(self) -> dict:
        return {
            "epoch": self.epoch,
            "frames_applied": self.frames_applied,
            "fulls_applied": self.fulls_applied,
            "deltas_applied": self.deltas_applied,
            "epochs_seen": self.epochs_seen,
            "gaps_seen": self.gaps_seen,
            "deltas_refused": self.deltas_refused,
            "discarded": self.discarded,
            "entities": sum(len(m) for m in self.worlds.values()),
        }


class LegacyClient:
    """The pre-interest stream folded into the same snapshot shape:
    every ``entity.frame`` upserts its entities, every
    ``entity.remove`` deletes them."""

    def __init__(self):
        self.worlds: dict[str, dict[uuid_mod.UUID, tuple]] = {}
        self.frames_applied = 0

    def apply(self, frame) -> bool:
        msg = _as_message(frame)
        if msg.parameter == "entity.frame":
            world = self.worlds.setdefault(msg.world_name, {})
            for ent in msg.entities:
                p = ent.position
                world[ent.uuid] = (p.x, p.y, p.z)
        elif msg.parameter == "entity.remove":
            world = self.worlds.get(msg.world_name)
            if world:
                for ent in msg.entities:
                    world.pop(ent.uuid, None)
                if not world:
                    self.worlds.pop(msg.world_name, None)
        else:
            return False
        self.frames_applied += 1
        return True

    def snapshot(self) -> dict:
        return {w: dict(m) for w, m in self.worlds.items() if m}
