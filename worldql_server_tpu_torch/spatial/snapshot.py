"""Subscription-index snapshot/restore.

The reference keeps subscriptions in memory only — a restart loses
every AreaMap and clients must re-subscribe (SURVEY §5
checkpoint/resume: "WorldMap/PeerMap are ephemeral"). That is the
floor, not the ceiling: a server hosting a million device-resident
subscriptions should not need a million re-subscribe round trips after
a rolling restart. This module checkpoints any SpatialBackend's live
rows to one compressed ``.npz`` and restores them through the normal
bulk-load path, so the restored index is indistinguishable from one
built by live traffic (same dedupe, same device layout rules).

The format is backend-agnostic and versioned: world names (json),
peer UUIDs as two u64 columns, and (world_id, cube, peer_id) rows.
Restore validates the version and cube size — a snapshot from a
different grid must never silently load into the wrong geometry.
"""

from __future__ import annotations

import json
import logging
import os
import uuid as uuid_mod

import numpy as np

logger = logging.getLogger(__name__)

_VERSION = 1


def export_rows(backend):
    """→ (worlds, peer_hi, peer_lo, row_wid, row_cube, row_pid): the
    backend's live subscription rows in the portable snapshot layout.
    Each backend implements :meth:`SpatialBackend.export_rows` against
    its own internals; this packs the peer UUIDs into two u64
    columns."""
    worlds, peers, wid, cube, pid = backend.export_rows()

    ints = np.fromiter(
        (p.int for p in peers), dtype=object, count=len(peers)
    ) if peers else np.empty(0, object)
    peer_hi = np.fromiter(
        (int(i) >> 64 for i in ints), np.uint64, count=len(peers)
    )
    peer_lo = np.fromiter(
        (int(i) & ((1 << 64) - 1) for i in ints), np.uint64,
        count=len(peers),
    )
    return worlds, peer_hi, peer_lo, wid, cube, pid


def save_snapshot(backend, path: str) -> int:
    """Write the backend's live subscriptions to ``path`` atomically
    (tmp + rename). Returns the number of rows saved."""
    worlds, peer_hi, peer_lo, wid, cube, pid = export_rows(backend)
    # a path (not a handle) so numpy fully finalizes the zip before
    # returning; the .npz suffix keeps savez from appending its own
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    try:
        np.savez_compressed(
            tmp,
            version=np.int64(_VERSION),
            cube_size=np.int64(backend.cube_size),
            worlds=np.frombuffer(
                json.dumps(worlds).encode(), dtype=np.uint8
            ),
            peer_hi=peer_hi,
            peer_lo=peer_lo,
            row_wid=wid,
            row_cube=cube,
            row_pid=pid,
        )
        os.replace(tmp, path)
    except BaseException:
        # a failed save (disk full, kill) must not litter orphan temps
        # next to the snapshot on every crashing shutdown
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    logger.info(
        "index snapshot: %d rows, %d worlds, %d peers -> %s",
        len(pid), len(worlds), len(peer_hi), path,
    )
    return int(len(pid))


class SnapshotError(ValueError):
    """The snapshot cannot be loaded into this backend (wrong version
    or grid geometry) — callers must not silently serve an empty or
    mis-quantized index."""


def load_snapshot(backend, path: str) -> tuple[int, list[uuid_mod.UUID]]:
    """Restore a snapshot into ``backend`` via its bulk-load path.
    Returns ``(rows restored, peers with restored rows)`` — the caller
    needs the peer set to sweep restored subscriptions whose owners
    never reconnect."""
    with np.load(path) as z:
        version = int(z["version"])
        if version != _VERSION:
            raise SnapshotError(
                f"snapshot version {version}, expected {_VERSION}"
            )
        cube_size = int(z["cube_size"])
        if cube_size != backend.cube_size:
            raise SnapshotError(
                f"snapshot cube_size {cube_size} != backend "
                f"{backend.cube_size} — refusing to load into the "
                "wrong grid"
            )
        worlds = json.loads(bytes(z["worlds"]).decode())
        peer_hi, peer_lo = z["peer_hi"], z["peer_lo"]
        wid, cube, pid = z["row_wid"], z["row_cube"], z["row_pid"]
        # validate shape consistency and every index BEFORE mutating
        # the backend: a malformed row must never restore under the
        # wrong peer (negative pids would silently wrap) or leave a
        # half-loaded index
        if (
            len(peer_hi) != len(peer_lo)
            or not (len(wid) == len(pid) == len(cube))
            or (len(cube) and cube.shape[1:] != (3,))
        ):
            raise SnapshotError("column lengths disagree")
        if len(pid) and (
            int(pid.min()) < 0 or int(pid.max()) >= len(peer_hi)
            or int(wid.min()) < 0 or int(wid.max()) >= len(worlds)
        ):
            raise SnapshotError("row peer/world ids out of range")

    peers = [
        uuid_mod.UUID(int=(int(hi) << 64) | int(lo))
        for hi, lo in zip(peer_hi, peer_lo)
    ]
    restored = 0
    for wid_i, world in enumerate(worlds):
        sel = wid == wid_i
        if not sel.any():
            continue
        restored += backend.bulk_add_subscriptions(
            world, [peers[i] for i in pid[sel]], cube[sel]
        )
    backend.flush()
    logger.info("index snapshot: restored %d rows from %s", restored, path)
    used = sorted(set(int(p) for p in pid))
    return restored, [peers[i] for i in used]
