"""Index snapshots across the two packages (``spatial/snapshot.py``).

The ``.npz`` format is backend-agnostic and versioned, with the cube
size: a snapshot the JAX package's ``TpuSpatialBackend`` (on JAX's CPU
backend) writes must load into the port's ``CudaSpatialBackend``
(``device='cpu'``) through its bulk-load path, and the other way round,
with equal exported rows and equal fan-out. Both packages refuse a
cube-size mismatch and malformed columns, and leave the index empty.
A snapshot taken while a background compaction folds base and delta is
one consistent set of rows (no row twice, none lost at the swap). The
port's server restores ``--index-snapshot`` at boot and saves it at
stop. Tolerance: exact (row sets and fan-out UUID sets).
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import uuid

import numpy as np
import pytest

from worldql_server_tpu.protocol.types import Replication as JRepl
from worldql_server_tpu.protocol.types import Vector3 as JVec
from worldql_server_tpu.spatial import snapshot as j_snap
from worldql_server_tpu.spatial.backend import LocalQuery as JQuery
from worldql_server_tpu.spatial.tpu_backend import TpuSpatialBackend
from worldql_server_tpu_torch.protocol.types import Replication as TRepl
from worldql_server_tpu_torch.protocol.types import Vector3 as TVec
from worldql_server_tpu_torch.spatial import snapshot as t_snap
from worldql_server_tpu_torch.spatial.backend import LocalQuery as TQuery
from worldql_server_tpu_torch.spatial.cuda_backend import CudaSpatialBackend

CUBE = 16
WORLDS = ("alpha", "beta", "gamma")
N = 3000


def _jax():
    return TpuSpatialBackend(CUBE)


def _port(**kw):
    return CudaSpatialBackend(CUBE, device="cpu", **kw)


def _populate(b, vec):
    """Seeded subscriptions in three worlds, then removals and a
    disconnect so tombstones are live in base and delta."""
    rng = np.random.default_rng(11)
    peers = [uuid.UUID(int=0x5000 + i) for i in range(N // 3)]
    cubes = rng.integers(-40, 40, (N, 3)).astype(np.int64) * CUBE
    owner = rng.integers(0, len(peers), N)
    for w, world in enumerate(WORLDS):
        sel = np.flatnonzero(np.arange(N) % len(WORLDS) == w)
        b.bulk_add_subscriptions(world, [peers[i] for i in owner[sel]],
                                 cubes[sel])
    b.flush()
    for i in range(0, N, 9):
        p = cubes[i] + 1.0
        b.remove_subscription(WORLDS[i % len(WORLDS)], peers[owner[i]],
                              vec(*map(float, p)))
    b.remove_peer(peers[7])
    b.flush()
    return peers, cubes


def _rows(b):
    worlds, peers, wid, cube, pid = b.export_rows()
    return sorted((worlds[w], str(peers[p]), tuple(map(int, c)))
                  for w, c, p in zip(wid.tolist(), cube, pid.tolist()))


def _fanout(b, query, vec, repl, cubes, peers):
    qs = [query(WORLDS[i % len(WORLDS)], vec(*map(float, cubes[i] + 3.0)),
                peers[i % len(peers)], repl.EXCEPT_SELF)
          for i in range(0, N, 7)]
    return [sorted(map(str, out)) for out in b.match_local_batch(qs)]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_crosses_packages(tmp_path, direction):
    path = str(tmp_path / "index.npz")
    if direction == "jax_to_port":
        src, src_mod, src_vec = _jax(), j_snap, JVec
        dst, dst_mod = _port(), t_snap
    else:
        src, src_mod, src_vec = _port(), t_snap, TVec
        dst, dst_mod = _jax(), j_snap
    peers, cubes = _populate(src, src_vec)
    saved = src_mod.save_snapshot(src, path)
    assert saved == src.subscription_count() > 0
    restored, restored_peers = dst_mod.load_snapshot(dst, path)
    assert restored == saved
    assert set(restored_peers) <= set(peers)
    assert _rows(dst) == _rows(src)
    jb, tb = (src, dst) if direction == "jax_to_port" else (dst, src)
    assert _fanout(tb, TQuery, TVec, TRepl, cubes, peers) == \
        _fanout(jb, JQuery, JVec, JRepl, cubes, peers)


def _malformed(path, **override):
    with np.load(path) as z:
        cols = {k: z[k] for k in z.files}
    cols.update(override)
    np.savez_compressed(path, **cols)


@pytest.mark.parametrize("fault,match", [
    ("cube_size", "cube_size"),
    ("lengths", "column lengths"),
    ("peer_range", "out of range"),
    ("world_range", "out of range"),
    ("version", "version"),
])
def test_both_packages_refuse_bad_snapshots(tmp_path, fault, match):
    src = _port()
    _populate(src, TVec)
    path = str(tmp_path / "bad.npz")
    t_snap.save_snapshot(src, path)
    with np.load(path) as z:
        pid, wid = z["row_pid"], z["row_wid"]
    if fault == "cube_size":
        _malformed(path, cube_size=np.int64(2 * CUBE))
    elif fault == "lengths":
        _malformed(path, row_pid=pid[:-1])
    elif fault == "peer_range":
        _malformed(path, row_pid=np.where(pid == pid[0], -1, pid))
    elif fault == "world_range":
        _malformed(path, row_wid=np.full_like(wid, len(WORLDS)))
    else:
        _malformed(path, version=np.int64(99))
    for mod, make in ((t_snap, _port), (j_snap, _jax)):
        dst = make()
        with pytest.raises(mod.SnapshotError, match=match):
            mod.load_snapshot(dst, path)
        assert dst.subscription_count() == 0  # never half-loaded


def test_snapshot_during_compaction_is_one_consistent_set(tmp_path):
    """``export_rows`` reads the host authority on the owning thread;
    a compaction in flight (held here at a gate) only reads its own
    snapshot, and the swap replays removals made meanwhile. A snapshot
    taken mid-compaction, after removals and appends, equals the rows
    after the swap: no row twice, none lost."""
    b = _port(compact_threshold=64)
    peers, _ = _populate(b, TVec)
    rng = np.random.default_rng(5)

    def add(n):
        cubes = rng.integers(-40, 40, (n, 3)).astype(np.int64) * CUBE
        b.bulk_add_subscriptions("alpha", [peers[i % len(peers)]
                                           for i in range(n)], cubes)

    add(150)  # a delta log past the threshold, under the fold limit
    gate = threading.Event()
    work = b._compact_work
    b._compact_work = lambda snap: gate.wait(30) and work(snap)
    b.flush()
    assert b._compaction is not None          # in flight, at the gate
    b.remove_peer(peers[11])                  # lands on the replay list
    add(40)
    b.flush()
    mid = str(tmp_path / "mid.npz")
    t_snap.save_snapshot(b, mid)
    gate.set()
    b.wait_compaction()
    assert b._compaction is None and b.compactions >= 1
    after = _rows(b)
    assert len(after) == len(set(after)) == b.subscription_count()
    dst = _port()
    t_snap.load_snapshot(dst, mid)
    assert _rows(dst) == after


def _server(path, **extra):
    from worldql_server_tpu_torch.engine.config import Config
    from worldql_server_tpu_torch.engine.server import WorldQLServer

    config = Config(store_url="memory://", http_enabled=False,
                    ws_enabled=False, zmq_enabled=False,
                    spatial_backend="cuda", tick_interval=0.05,
                    index_snapshot=path, precompile_tiers=False, **extra)
    return WorldQLServer(config, device="cpu")


def test_server_restores_at_boot_and_saves_at_stop(tmp_path):
    from worldql_server_tpu_torch.protocol import Instruction, Message

    path = str(tmp_path / "server-index.npz")
    subs = [(uuid.UUID(int=0x77 + i), TVec(5.0 + 20 * i, 5.0, 5.0))
            for i in range(4)]

    async def scenario():
        first = _server(path)
        await first.start()
        for peer, pos in subs:
            await first.router.handle_message(Message(
                instruction=Instruction.AREA_SUBSCRIBE, sender_uuid=peer,
                world_name="w", position=pos))
        rows = _rows(first.backend)
        await first.stop()                 # saves before teardown
        assert os.path.exists(path)
        second = _server(path)
        await second.start()               # restores before serving
        try:
            assert _rows(second.backend) == rows
            assert set(second._restored_peers) == {p for p, _ in subs}
            got = second.backend.match_local_batch([TQuery(
                "w", subs[0][1], uuid.uuid4(), TRepl.EXCEPT_SELF)])
            assert got == [[subs[0][0]]]
        finally:
            await second.stop()
        return rows

    rows = asyncio.run(asyncio.wait_for(scenario(), 60))
    assert len(rows) == len(subs)
    # the stop of a server whose owners never came back sweeps them
    with np.load(path) as z:
        assert len(z["row_pid"]) == 0
        assert json.loads(bytes(z["worlds"]).decode()) == ["w"]
