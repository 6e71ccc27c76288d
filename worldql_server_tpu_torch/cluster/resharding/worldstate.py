"""Shard-side world-state capsule: export, import, tombstone.

A migration moves ONE world between two full-engine shard processes.
This module is the shard half of the protocol — three idempotent
operations the control handlers call:

* :func:`export_world` (source, STREAMING) — drain the durability
  pipeline (the capsule must contain every ACKED record), then capture
  everything shard-local about world W into one JSON-safe document:
  record rows (the WAL-backed state), subscription index rows, entity
  SoA rows, and the PARKED sessions of W's peers with their tokens
  intact. Pure read: the source keeps serving its other worlds and
  still owns W until the router flips.
* :func:`import_world` (destination, REPLAY) — apply the capsule.
  Records go THROUGH the destination's durability pipeline and a
  drain barrier, so by the time the ack leaves, W is recoverable from
  the DESTINATION's WAL — the property that makes "exactly one owner
  can recover" true at every crash point. Imported parked sessions
  funnel through ``mark_resync`` (interest's one loss hook): the first
  frame a migrated peer sees after resume is a forced full keyframe,
  never a delta against state the new owner never held.
* :func:`tombstone_world` (source, AFTER the ack is durable) — delete
  W's records through the source's OWN durability pipeline (the
  deletes append to its WAL, so a post-tombstone crash + replay does
  not resurrect a world the placement map routed away), drop the
  index/entity rows, and discard the migrated sessions WITHOUT the
  ``peer_gone`` teardown broadcast — those peers moved, they did not
  die.
"""

from __future__ import annotations

import base64
import logging
import uuid as uuid_mod

from ...protocol.types import Record, Vector3

logger = logging.getLogger(__name__)


def _encode_record(stored) -> dict:
    record = stored.record
    return {
        "uuid": record.uuid.hex,
        "pos": [record.position.x, record.position.y, record.position.z],
        "data": record.data,
        "flex": (
            base64.b64encode(record.flex).decode()
            if record.flex is not None else None
        ),
    }


def _decode_record(row: dict, world: str) -> Record:
    return Record(
        uuid=uuid_mod.UUID(hex=row["uuid"]),
        position=Vector3(*(float(v) for v in row["pos"])),
        world_name=world,
        data=row.get("data"),
        flex=(
            base64.b64decode(row["flex"])
            if row.get("flex") is not None else None
        ),
    )


def _subscription_rows(backend, world: str) -> list[list]:
    """World W's index rows as ``[peer_hex, cx, cy, cz]`` — built from
    the backend's generic snapshot export so every SpatialBackend
    (cpu, tpu, sharded) exports the same way."""
    worlds, peers, wid_col, cube_rows, pid_col = backend.export_rows()
    try:
        wid = worlds.index(world)
    except ValueError:
        return []
    out = []
    for row in range(len(wid_col)):
        if int(wid_col[row]) != wid:
            continue
        cube = cube_rows[row]
        out.append([
            peers[int(pid_col[row])].hex,
            int(cube[0]), int(cube[1]), int(cube[2]),
        ])
    return out


async def export_world(server, world: str) -> dict:
    """Capture world ``world``'s full shard-local state (records,
    subscription rows, entity rows, parked sessions of its peers)."""
    if server.durability is not None:
        # every acked-but-unapplied record reaches the store first —
        # the capsule must be a superset of everything acknowledged
        await server.durability.drain()
    stored = await server.store.export_world_records(world)
    records = [_encode_record(s) for s in (stored or [])]
    subs = _subscription_rows(server.backend, world)
    entities = []
    if server.entity_plane is not None:
        entities = server.entity_plane.export_world(world)
    peer_hexes = {row[0] for row in subs}
    peer_hexes.update(e["owner"] for e in entities)
    sessions = []
    if server.sessions is not None:
        sessions = server.sessions.export_parked(
            uuid_mod.UUID(hex=h) for h in peer_hexes
        )
    return {
        "world": world,
        "records": records,
        "subs": subs,
        "entities": entities,
        "sessions": sessions,
    }


async def import_world(server, payload: dict) -> dict:
    """Replay a capsule into THIS shard; returns the applied counts
    (the ack body). Records land through the durability pipeline + a
    drain barrier so the ack implies WAL-durable ownership."""
    world = payload["world"]
    records = [_decode_record(r, world) for r in payload.get("records", ())]
    if records:
        sink = server.durability if server.durability is not None \
            else server.store
        await sink.insert_records(records)
    if server.durability is not None:
        await server.durability.drain()  # the DURABLE in "durable ack"
    subs_added = 0
    for peer_hex, cx, cy, cz in payload.get("subs", ()):
        if server.backend.add_subscription(
            world, uuid_mod.UUID(hex=peer_hex),
            (int(cx), int(cy), int(cz)),
        ):
            subs_added += 1
    entities_added = 0
    if payload.get("entities") and server.entity_plane is not None:
        entities_added = server.entity_plane.import_world(
            world, payload["entities"]
        )
    sessions_added = 0
    if payload.get("sessions") and server.sessions is not None:
        imported = server.sessions.import_parked(payload["sessions"])
        sessions_added = len(imported)
        for peer in imported:
            # the one loss hook (interest): a migrated peer's first
            # post-resume frame must be a full keyframe — the ledger
            # state it accumulated lived on the OLD owner
            if server.interest is not None:
                server.interest.mark_resync(peer)
    counts = {
        "records": len(records),
        "subs": subs_added,
        "entities": entities_added,
        "sessions": sessions_added,
    }
    logger.info("imported world %r: %s", world, counts)
    return counts


async def tombstone_world(server, world: str) -> dict:
    """Delete world ``world`` from THIS shard after the destination's
    ack is durable. Deletions ride the durability pipeline so they
    append to the WAL: a crash after the tombstone replays the deletes
    too, and the world stays gone."""
    stored = await server.store.export_world_records(world)
    records = [s.record for s in (stored or [])]
    if records:
        sink = server.durability if server.durability is not None \
            else server.store
        await sink.delete_records(records)
    if server.durability is not None:
        await server.durability.drain()
    subs = _subscription_rows(server.backend, world)
    for peer_hex, cx, cy, cz in subs:
        server.backend.remove_subscription(
            world, uuid_mod.UUID(hex=peer_hex), (int(cx), int(cy), int(cz))
        )
    entities_removed = 0
    if server.entity_plane is not None:
        entities_removed = server.entity_plane.remove_world(world)
    sessions_dropped = 0
    if server.sessions is not None:
        peer_hexes = {row[0] for row in subs}
        for peer_hex in peer_hexes:
            peer = uuid_mod.UUID(hex=peer_hex)
            session = server.sessions.get(peer)
            if session is not None and session.parked:
                # migrated, not dead: discard WITHOUT the peer_gone
                # broadcast — the new owner holds the live session
                server.sessions.discard(peer)
                sessions_dropped += 1
    counts = {
        "records": len(records),
        "subs": len(subs),
        "entities": entities_removed,
        "sessions": sessions_dropped,
    }
    logger.info("tombstoned world %r: %s", world, counts)
    return counts
