"""PostgreSQL RecordStore — the reference's native dialect.

Faithful rebuild of DatabaseClient (worldql_server/src/database/):
schema ``w_<world>`` per world, data table ``t_<suffix>`` per table
cell with a btree index on region_id (query_constants.rs:84-121),
``navigation.tables``/``navigation.regions`` mapping bounds to serial
ids (query_constants.rs:2-38), lazy DDL on UNDEFINED_TABLE with retry
(client.rs:178-225), and idempotent ``init_database`` (init.rs:10-26).

Drivers: prefers ``asyncpg`` then ``psycopg`` when installed (binary
protocol); otherwise falls back to the built-in pure-Python v3 wire
client (``storage/pgwire.py``) so ``postgres://`` works with zero
dependencies. The logic is kept driver-thin behind ``_exec``/``_fetch``
so all three slot in identically.
"""

from __future__ import annotations

import logging
import re
import uuid as uuid_mod
from datetime import datetime, timezone

from ..protocol.types import Record, Vector3
from .sql_common import LruCache, RegionMath, world_key
from .store import DedupeOp, RecordStore, StoredRecord

logger = logging.getLogger(__name__)


def _load_driver():
    try:
        import asyncpg  # type: ignore

        return "asyncpg", asyncpg
    except ImportError:
        pass
    try:
        import psycopg  # type: ignore

        return "psycopg", psycopg
    except ImportError:
        pass
    # Built-in pure-Python v3 wire driver (storage/pgwire.py): always
    # available, asyncpg-shaped surface, text protocol. The external
    # drivers stay preferred for their binary-protocol performance.
    from . import pgwire

    return "pgwire", pgwire


_NAV_DDL = (
    "CREATE SCHEMA IF NOT EXISTS navigation",
    """CREATE TABLE IF NOT EXISTS navigation.tables (
        world_name varchar NOT NULL,
        tx bigint NOT NULL, ty bigint NOT NULL, tz bigint NOT NULL,
        table_suffix serial NOT NULL,
        UNIQUE (world_name, tx, ty, tz)
    )""",
    """CREATE TABLE IF NOT EXISTS navigation.regions (
        world_name varchar NOT NULL,
        rx bigint NOT NULL, ry bigint NOT NULL, rz bigint NOT NULL,
        region_id serial NOT NULL,
        UNIQUE (world_name, rx, ry, rz)
    )""",
)

UNDEFINED_TABLE = "42P01"

# 7 bind params per row; stay well under the wire protocol's 32767
# int16 parameter-count limit per statement.
_INSERT_CHUNK_ROWS = 4000

_PLACEHOLDER = re.compile(r"\$\d+")


def _psycopg_placeholders(sql: str) -> str:
    """asyncpg-style $N params → psycopg %s (positional order matches)."""
    return _PLACEHOLDER.sub("%s", sql)


class PostgresRecordStore(RecordStore):
    def __init__(self, url: str, config):
        self._driver_name, self._driver = _load_driver()
        self._url = url
        self._math = RegionMath(config)
        cache = config.db_cache_size
        self._table_cache = LruCache(cache)
        self._region_cache = LruCache(cache)
        self._conn = None

    # region: lifecycle

    async def init(self) -> None:
        if self._driver_name in ("asyncpg", "pgwire"):
            self._conn = await self._driver.connect(self._url)
        else:  # psycopg (async API)
            self._conn = await self._driver.AsyncConnection.connect(
                self._url, autocommit=True
            )
        for ddl in _NAV_DDL:
            await self._exec(ddl)

    async def close(self) -> None:
        if self._conn is not None:
            conn, self._conn = self._conn, None
            await conn.close()

    # endregion

    # region: driver shims

    async def _exec(self, sql: str, *params) -> str:
        if self._driver_name in ("asyncpg", "pgwire"):
            return await self._conn.execute(sql, *params)
        async with self._conn.cursor() as cur:
            await cur.execute(_psycopg_placeholders(sql), params)
            return str(cur.rowcount)

    async def _fetch(self, sql: str, *params) -> list:
        if self._driver_name in ("asyncpg", "pgwire"):
            return await self._conn.fetch(sql, *params)
        async with self._conn.cursor() as cur:
            await cur.execute(_psycopg_placeholders(sql), params)
            return await cur.fetchall()

    def _is_undefined_table(self, exc: Exception) -> bool:
        code = getattr(exc, "sqlstate", None) or getattr(exc, "pgcode", None)
        return code == UNDEFINED_TABLE or "does not exist" in str(exc)

    # endregion

    # region: navigation

    async def _lookup_table_suffix(self, world: str, table: tuple) -> int:
        key = (world, table)
        hit = self._table_cache.get(key)
        if hit is not None:
            return hit
        rows = await self._fetch(
            "SELECT table_suffix FROM navigation.tables "
            "WHERE world_name=$1 AND tx=$2 AND ty=$3 AND tz=$4",
            world, *table,
        )
        if rows:
            suffix = rows[0][0]
        else:
            # Race-safe lookup-or-insert: a concurrent writer may have
            # claimed the cell between SELECT and INSERT.
            rows = await self._fetch(
                "INSERT INTO navigation.tables (world_name, tx, ty, tz) "
                "VALUES ($1,$2,$3,$4) "
                "ON CONFLICT (world_name, tx, ty, tz) DO NOTHING "
                "RETURNING table_suffix",
                world, *table,
            )
            if not rows:
                rows = await self._fetch(
                    "SELECT table_suffix FROM navigation.tables "
                    "WHERE world_name=$1 AND tx=$2 AND ty=$3 AND tz=$4",
                    world, *table,
                )
            suffix = rows[0][0]
        self._table_cache.put(key, suffix)
        return suffix

    async def _lookup_region_id(self, world: str, region: tuple) -> int:
        key = (world, region)
        hit = self._region_cache.get(key)
        if hit is not None:
            return hit
        rows = await self._fetch(
            "SELECT region_id FROM navigation.regions "
            "WHERE world_name=$1 AND rx=$2 AND ry=$3 AND rz=$4",
            world, *region,
        )
        if rows:
            region_id = rows[0][0]
        else:
            rows = await self._fetch(
                "INSERT INTO navigation.regions (world_name, rx, ry, rz) "
                "VALUES ($1,$2,$3,$4) "
                "ON CONFLICT (world_name, rx, ry, rz) DO NOTHING "
                "RETURNING region_id",
                world, *region,
            )
            if not rows:
                rows = await self._fetch(
                    "SELECT region_id FROM navigation.regions "
                    "WHERE world_name=$1 AND rx=$2 AND ry=$3 AND rz=$4",
                    world, *region,
                )
            region_id = rows[0][0]
        self._region_cache.put(key, region_id)
        return region_id

    async def _lookup_ids(self, world: str, position: Vector3) -> tuple[int, int]:
        region = self._math.region_of(position)
        suffix = await self._lookup_table_suffix(world, self._math.table_of(region))
        region_id = await self._lookup_region_id(world, region)
        return suffix, region_id

    # endregion

    # region: data tables

    async def _create_data_table(self, world: str, suffix: int) -> None:
        await self._exec(f'CREATE SCHEMA IF NOT EXISTS "w_{world}"')
        await self._exec(
            f'''CREATE TABLE IF NOT EXISTS "w_{world}".t_{suffix} (
                last_modified timestamptz NOT NULL DEFAULT NOW(),
                region_id int NOT NULL,
                x double precision NOT NULL,
                y double precision NOT NULL,
                z double precision NOT NULL,
                uuid varchar NOT NULL,
                data varchar,
                flex bytea
            )'''
        )
        await self._exec(
            f'CREATE INDEX IF NOT EXISTS t_{suffix}_region '
            f'ON "w_{world}".t_{suffix} (region_id)'
        )

    # endregion

    # region: record ops

    async def insert_records(self, records: list[Record]) -> int:
        table_map: dict[tuple[str, int], list[tuple]] = {}
        for record in records:
            if record.position is None:
                logger.warning("record %s has no position, skipping", record.uuid)
                continue
            try:
                world = world_key(record.world_name)
            except Exception as exc:
                logger.warning("record %s bad world name: %s", record.uuid, exc)
                continue
            suffix, region_id = await self._lookup_ids(world, record.position)
            table_map.setdefault((world, suffix), []).append((
                region_id,
                record.position.x, record.position.y, record.position.z,
                str(record.uuid), record.data, record.flex,
            ))

        written = 0
        for (world, suffix), rows in table_map.items():
            # One multi-row INSERT per table (client.rs:119-162), chunked
            # below PostgreSQL's 32767 bind-parameter ceiling (int16 in
            # the extended protocol): 4000 rows × 7 params = 28000.
            for start in range(0, len(rows), _INSERT_CHUNK_ROWS):
                chunk = rows[start:start + _INSERT_CHUNK_ROWS]
                placeholders = ",".join(
                    "(" + ",".join(f"${i * 7 + j + 1}" for j in range(7)) + ")"
                    for i in range(len(chunk))
                )
                sql = (f'INSERT INTO "w_{world}".t_{suffix} '
                       "(region_id, x, y, z, uuid, data, flex) "
                       f"VALUES {placeholders}")
                params = [v for row in chunk for v in row]
                try:
                    await self._exec(sql, *params)
                except Exception as exc:
                    if not self._is_undefined_table(exc):
                        raise
                    await self._create_data_table(world, suffix)
                    await self._exec(sql, *params)
                written += len(chunk)
        return written

    async def get_records_in_region(
        self, world_name: str, position: Vector3, after: datetime | None = None
    ) -> list[StoredRecord]:
        world = world_key(world_name)
        suffix, region_id = await self._lookup_ids(world, position)
        sql = (f'SELECT last_modified, x, y, z, uuid, data, flex '
               f'FROM "w_{world}".t_{suffix} WHERE region_id=$1')
        params: list = [region_id]
        if after is not None:
            sql += " AND last_modified > $2"
            params.append(after)
        try:
            rows = await self._fetch(sql, *params)
        except Exception as exc:
            if self._is_undefined_table(exc):
                return []
            raise
        out = []
        for ts, x, y, z, u, data, flex in rows:
            if ts.tzinfo is None:
                ts = ts.replace(tzinfo=timezone.utc)
            out.append(StoredRecord(
                timestamp=ts,
                record=Record(
                    uuid=uuid_mod.UUID(u),
                    position=Vector3(x, y, z),
                    world_name=world_name,
                    data=data,
                    flex=bytes(flex) if flex is not None else None,
                ),
            ))
        return out

    async def export_world_records(self, world_name: str) -> list[StoredRecord]:
        world = world_key(world_name)
        suffix_rows = await self._fetch(
            "SELECT table_suffix FROM navigation.tables WHERE world_name=$1",
            world,
        )
        out: list[StoredRecord] = []
        for (suffix,) in suffix_rows:
            try:
                rows = await self._fetch(
                    f'SELECT last_modified, x, y, z, uuid, data, flex '
                    f'FROM "w_{world}".t_{suffix}'
                )
            except Exception as exc:
                if self._is_undefined_table(exc):
                    continue
                raise
            for ts, x, y, z, u, data, flex in rows:
                if ts.tzinfo is None:
                    ts = ts.replace(tzinfo=timezone.utc)
                out.append(StoredRecord(
                    timestamp=ts,
                    record=Record(
                        uuid=uuid_mod.UUID(u),
                        position=Vector3(x, y, z),
                        world_name=world_name,
                        data=data,
                        flex=bytes(flex) if flex is not None else None,
                    ),
                ))
        return out

    async def delete_records(self, records: list[Record]) -> int:
        deleted = 0
        for record in records:
            if record.position is None:
                continue
            try:
                world = world_key(record.world_name)
            except Exception as exc:
                logger.warning("record %s bad world name: %s", record.uuid, exc)
                continue
            suffix, region_id = await self._lookup_ids(world, record.position)
            try:
                status = await self._exec(
                    f'DELETE FROM "w_{world}".t_{suffix} '
                    "WHERE uuid=$1 AND region_id=$2",
                    str(record.uuid), region_id,
                )
                deleted += _rowcount(status)
            except Exception as exc:
                if not self._is_undefined_table(exc):
                    raise
        return deleted

    async def dedupe_records(self, ops: list[DedupeOp]) -> int:
        deleted = 0
        for rec_uuid, keep_ts, world_name, position in ops:
            world = world_key(world_name)
            suffix, region_id = await self._lookup_ids(world, position)
            try:
                status = await self._exec(
                    f'DELETE FROM "w_{world}".t_{suffix} '
                    "WHERE uuid=$1 AND region_id=$2 AND last_modified < $3",
                    str(rec_uuid), region_id, keep_ts,
                )
                deleted += _rowcount(status)
            except Exception as exc:
                if not self._is_undefined_table(exc):
                    raise
        return deleted

    # endregion


def _rowcount(status: str) -> int:
    """asyncpg returns e.g. 'DELETE 3'; psycopg shim returns an int
    string."""
    try:
        return int(str(status).rsplit(" ", 1)[-1])
    except ValueError:
        return 0
