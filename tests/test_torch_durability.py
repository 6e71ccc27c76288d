"""Durability and the record path: the port against the JAX package.

* A write-ahead log written by one package's ``WriteAheadLog`` (inserts
  and deletes over several segments) is replayed by the other package's
  ``durability/recovery.py`` into its memory store: the replayed
  entries and the records the store then holds equal what the writing
  package's own recovery gives. Both directions.
* RecordCreate / RecordRead / RecordDelete over real ZeroMQ, with
  ``--durability off``, ``sync`` and ``wal``: the port's server and the
  JAX server send one client the same ``RecordReply`` bytes, in the same
  order, both encoding with the native codec (``bind_one_serializer``:
  on a tree without ``native/libwqlcodec.so`` the JAX package would
  otherwise keep the Python flatbuffers builder, whose bytes differ).

Tolerance: exact (record fields, wire bytes).
"""

from __future__ import annotations

import asyncio
import uuid as uuid_mod

import numpy as np
import pytest

from tests.client_util import ZmqClient, free_port
from tests.test_torch_entity_plane import bind_one_serializer
from worldql_server_tpu.durability import recovery as j_recovery
from worldql_server_tpu.durability import wal as j_wal
from worldql_server_tpu.engine.config import Config as JConfig
from worldql_server_tpu.engine.server import WorldQLServer as JServer
from worldql_server_tpu.protocol import (
    Instruction, Message, deserialize_message)
from worldql_server_tpu.protocol.types import Record as JRecord
from worldql_server_tpu.protocol.types import Vector3 as JVector3
from worldql_server_tpu.storage.memory_store import (
    MemoryRecordStore as JStore)
from worldql_server_tpu_torch.durability import recovery as t_recovery
from worldql_server_tpu_torch.durability import wal as t_wal
from worldql_server_tpu_torch.engine.config import Config as TConfig
from worldql_server_tpu_torch.engine.server import WorldQLServer as TServer
from worldql_server_tpu_torch.protocol.types import Record as TRecord
from worldql_server_tpu_torch.protocol.types import Vector3 as TVector3
from worldql_server_tpu_torch.storage.memory_store import (
    MemoryRecordStore as TStore)

PACKAGES = {
    "jax": (j_wal, j_recovery, JRecord, JVector3, JStore, JConfig),
    "torch": (t_wal, t_recovery, TRecord, TVector3, TStore, TConfig),
}
WORLDS = ("alpha", "beta")


def _records(pkg, rng, n):
    _, _, record, vector3, _, _ = PACKAGES[pkg]
    out = []
    for _ in range(n):
        pos = rng.uniform(-200, 200, 3)
        out.append(record(
            uuid=uuid_mod.UUID(int=int(rng.integers(1, 1 << 62))),
            position=vector3(*map(float, pos)),
            world_name=WORLDS[int(rng.integers(0, 2))],
            data=f"d{int(rng.integers(0, 1000))}",
            flex=bytes(rng.integers(0, 256, 4).astype(np.uint8))
            if rng.random() < 0.5 else None,
        ))
    return out


def _plain(records):
    return sorted(
        (r.uuid.hex, r.world_name, (r.position.x, r.position.y,
                                    r.position.z), r.data, r.flex)
        for r in records)


async def _write_wal(pkg, wal_dir):
    """Three batches of inserts and one of deletes, in small segments."""
    wal_mod = PACKAGES[pkg][0]
    rng = np.random.default_rng(6)
    log = wal_mod.WriteAheadLog(wal_dir, segment_bytes=2048)
    log.start()
    batches = [_records(pkg, rng, 12) for _ in range(3)]
    for batch in batches:
        await log.append(wal_mod.encode_insert(batch))
    await log.append(wal_mod.encode_delete(batches[1][::3]))
    await log.close()


async def _replay(pkg, wal_dir):
    _, recovery, _, _, store_cls, config_cls = PACKAGES[pkg]
    ops, _ = recovery.scan_wal(wal_dir)
    store = store_cls(config_cls(store_url="memory://"))
    await store.init()
    stats = await recovery.recover(store, wal_dir, purge=False)
    held = []
    for world in WORLDS:
        held += [s.record for s in await store.export_world_records(world)]
    return ([(op, _plain(records)) for op, records in ops],
            stats.entries, stats.records, _plain(held))


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_wal_replays_across_packages(tmp_path, writer, reader):
    wal_dir = str(tmp_path / "wal")

    async def scenario():
        await _write_wal(writer, wal_dir)
        assert len(j_wal.list_segments(wal_dir)) > 1
        return await _replay(writer, wal_dir), await _replay(reader, wal_dir)

    own, other = asyncio.run(asyncio.wait_for(scenario(), 60))
    assert other == own
    assert own[1] == 4 and len(own[3]) == 32


async def _record_session(server, config):
    """One client: create records in two worlds, read a region, delete
    some, read again; every RecordReply's bytes in arrival order."""
    await server.start()
    client = None
    try:
        client = await ZmqClient.connect(
            config.zmq_server_port, peer_uuid=uuid_mod.UUID(int=0x5E55))
        rng = np.random.default_rng(11)
        created = []
        for world in WORLDS:
            recs = []
            for i in range(6):
                p = rng.uniform(1, 15, 3)   # the region read below
                recs.append(JRecord(
                    uuid=uuid_mod.UUID(int=0xAB00 + 16 * len(created) + i),
                    position=JVector3(*map(float, p)), world_name=world,
                    data=f"{world}-{i}"))
            await client.send(Message(
                instruction=Instruction.RECORD_CREATE, world_name=world,
                records=recs))
            created.append(recs)
        replies = []

        async def read(world):
            await client.send(Message(
                instruction=Instruction.RECORD_READ, world_name=world,
                position=JVector3(5.0, 5.0, 5.0)))
            while True:
                data = await asyncio.wait_for(client.pull.recv(), 30)
                msg = deserialize_message(data)
                if msg.instruction == Instruction.RECORD_REPLY:
                    replies.append(bytes(data))
                    return msg

        # a create is asynchronous with respect to a read: read until
        # the first world's records are all there
        for _ in range(200):
            replies.clear()
            got = await read(WORLDS[0])
            if len(got.records) == len(created[0]):
                break
            await asyncio.sleep(0.02)
        await read(WORLDS[1])
        await client.send(Message(
            instruction=Instruction.RECORD_DELETE, world_name=WORLDS[0],
            records=created[0][::2]))
        for _ in range(200):
            before = len(replies)
            got = await read(WORLDS[0])
            if not {r.uuid for r in got.records} & {
                    r.uuid for r in created[0][::2]}:
                break
            del replies[before:]
            await asyncio.sleep(0.02)
        return replies
    finally:
        if client is not None:
            await client.close()
        await server.stop()


@pytest.mark.parametrize("durability", ["off", "sync", "wal"])
def test_record_replies_equal_the_jax_server(tmp_path, durability,
                                             monkeypatch):
    # reply bytes are comparable only from one encoder: the JAX package
    # gets the native one the port bound (tests/test_torch_entity_plane.py)
    bind_one_serializer(monkeypatch)

    def config(cls, name):
        return cls(store_url="memory://", ws_enabled=False,
                   http_enabled=False, zmq_server_host="127.0.0.1",
                   zmq_server_port=free_port(), spatial_backend="cpu",
                   durability=durability,
                   wal_dir=str(tmp_path / name / "wal"))

    async def both():
        tc, jc = config(TConfig, "port"), config(JConfig, "jax")
        port = await _record_session(TServer(tc, device="cpu"), tc)
        jax = await _record_session(JServer(jc), jc)
        return port, jax

    port, jax = asyncio.run(asyncio.wait_for(both(), 120))
    assert len(port) == 3
    assert port == jax
