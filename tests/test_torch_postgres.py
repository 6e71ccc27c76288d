"""The port's PostgreSQL record store against the JAX package's.

``--store-url postgres://…`` opens ``storage/postgres_store.py`` in
both packages; the port's copy (with its pure-Python wire driver
``storage/pgwire.py``) must answer record operations as the JAX one
does. Both stores run the same script of record operations — inserts
into lazily created tables, region reads with and without a timestamp
filter, dedupe deletes and deletes — twice: against the
repo's fake asyncpg driver (tests/test_postgres_store.py), one fake
server each, and over a real TCP socket against the in-process wire
server (tests/pg_wire_server.py). Tolerance: exact — every read equal
as (uuid, world, position, data, flex) rows, and on the fake driver the
statements each store issued equal too.
"""

from __future__ import annotations

import asyncio
import uuid
from datetime import datetime, timedelta, timezone

import pytest

from pg_wire_server import WirePgServer
from tests.test_postgres_store import FakeAsyncpg
from worldql_server_tpu.engine.config import Config as JConfig
from worldql_server_tpu.protocol.types import Record as JRecord
from worldql_server_tpu.protocol.types import Vector3 as JVector3
from worldql_server_tpu.storage import postgres_store as j_pg
from worldql_server_tpu_torch.engine.config import Config as TConfig
from worldql_server_tpu_torch.protocol.types import Record as TRecord
from worldql_server_tpu_torch.protocol.types import Vector3 as TVector3
from worldql_server_tpu_torch.storage import postgres_store as t_pg
from worldql_server_tpu_torch.storage.store import open_store

SIDES = {
    "jax": (j_pg, JConfig, JRecord, JVector3),
    "port": (t_pg, TConfig, TRecord, TVector3),
}
#: (world, position, data, flex) of the script's records; the ids are
#: fixed so both stores hold the same rows
ROWS = [
    ("arena", (1.0, 2.0, 3.0), "a0", None),
    ("arena", (4.0, 2.0, 3.0), "a1", b"\x00\x01\xff"),
    ("arena", (-700.0, 5.0, 9.0), "far", None),
    ("lobby", (1.0, 2.0, 3.0), "l0", b"flex"),
    ("arena", (1.5, 2.5, 3.5), "a0-again", None),
]


def _row(sr):
    r = sr.record
    p = r.position
    return (str(r.uuid), r.world_name, (p.x, p.y, p.z), r.data,
            None if r.flex is None else bytes(r.flex))


async def _script(mod, config_cls, record, vec, url):
    """The record operations, the reads they give, and the store's
    driver name."""
    store = mod.PostgresRecordStore(url, config_cls(store_url="memory://"))
    await store.init()
    recs = [record(uuid=uuid.UUID(int=0xA000 + i), world_name=w,
                   position=vec(*p), data=d, flex=f)
            for i, (w, p, d, f) in enumerate(ROWS)]
    reads = []

    async def read(world, pos, after=None):
        got = await store.get_records_in_region(world, vec(*pos), after=after)
        reads.append(sorted(map(_row, got)))

    reads.append(await store.insert_records(recs[:4]))
    await read("arena", (1.0, 2.0, 3.0))
    await read("arena", (-700.0, 5.0, 9.0))
    await read("lobby", (1.0, 2.0, 3.0))
    await read("ghost", (0.0, 0.0, 0.0))        # a world with no tables
    future = datetime.now(timezone.utc) + timedelta(seconds=30)
    await read("arena", (1.0, 2.0, 3.0), after=future)
    # a second copy of a0's uuid, then the dedupe keeps only the newer
    dup = record(uuid=recs[0].uuid, world_name="arena",
                 position=vec(1.0, 2.0, 3.0), data="a0-new")
    reads.append(await store.insert_records([dup, recs[4]]))
    await read("arena", (1.0, 2.0, 3.0))
    kept = [sr for sr in await store.get_records_in_region(
        "arena", vec(1.0, 2.0, 3.0)) if sr.record.data == "a0-new"]
    reads.append(await store.dedupe_records([
        (recs[0].uuid, kept[0].timestamp, "arena", vec(1.0, 2.0, 3.0))]))
    await read("arena", (1.0, 2.0, 3.0))
    reads.append(await store.delete_records([recs[1], recs[3]]))
    await read("arena", (1.0, 2.0, 3.0))
    await read("lobby", (1.0, 2.0, 3.0))
    driver = store._driver_name
    await store.close()
    return reads, driver


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


def test_record_operations_equal_on_the_fake_driver(monkeypatch):
    servers = {}
    out = {}
    for side, (mod, config_cls, record, vec) in SIDES.items():
        server = servers[side] = FakeAsyncpg()
        monkeypatch.setattr(mod, "_load_driver",
                            lambda server=server: ("asyncpg", server))
        out[side] = _run(_script(mod, config_cls, record, vec,
                                 "postgres://u@h/db"))
    assert out["port"] == out["jax"]
    reads = out["port"][0]
    assert reads[0] == 4 and len(reads[1]) == 2 and reads[4] == []
    assert any(row[3] == "a0-new" for row in reads[7])
    # the same SQL, statement for statement
    assert servers["port"].statements == servers["jax"].statements


@pytest.mark.parametrize("auth", ["trust", "scram"])
def test_record_operations_equal_over_the_wire(auth):
    async def both():
        out = {}
        for side, (mod, config_cls, record, vec) in SIDES.items():
            server = WirePgServer(auth=auth)
            await server.start()
            try:
                out[side] = await _script(mod, config_cls, record, vec,
                                          server.url())
            finally:
                await server.stop()
        return out

    out = _run(both())
    assert out["port"] == out["jax"]
    assert out["port"][1] == "pgwire"  # the port's own wire driver


@pytest.mark.parametrize("scheme", ["postgres", "postgresql"])
def test_open_store_opens_the_ports_postgres_store(scheme):
    """A ``postgres://`` URL opened a module the port did not have
    (``ModuleNotFoundError``); it now opens the port's store, on the
    port's wire driver when no external one is installed."""
    store = open_store(f"{scheme}://u:p@127.0.0.1:1/db",
                       TConfig(store_url="memory://"))
    assert isinstance(store, t_pg.PostgresRecordStore)
    assert type(store).__module__ == \
        "worldql_server_tpu_torch.storage.postgres_store"
    assert t_pg._load_driver()[0] == j_pg._load_driver()[0]
