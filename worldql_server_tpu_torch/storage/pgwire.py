"""Dependency-free PostgreSQL client: frontend/backend protocol v3.

The reference persists through ``tokio-postgres``
(worldql_server/src/database/client.rs); this image ships neither
asyncpg nor psycopg, so this module implements the slice of the v3
wire protocol `PostgresRecordStore` needs directly on ``asyncio``
sockets — making ``postgres://`` URLs work out of the box while still
deferring to asyncpg/psycopg when installed (they keep binary-protocol
performance).

Scope (deliberately minimal, fully standard):
* startup + authentication: trust, cleartext, md5, SCRAM-SHA-256
  (RFC 5802/7677, the default for PostgreSQL >= 14);
* optional TLS via the SSLRequest dance (``?sslmode=require``);
* the SIMPLE QUERY protocol ('Q' → RowDescription/DataRow/
  CommandComplete/ErrorResponse/ReadyForQuery) with text-format
  result decoding by type OID — used for statements without
  parameters (DDL), like tokio-postgres's ``batch_execute``;
* the EXTENDED QUERY protocol (Parse/Bind/Describe/Execute/Sync)
  for every parameterized statement: ``$N`` values travel as typed
  protocol-level parameters — they never enter SQL text, matching
  the reference's injection-safety posture (client.rs:161-162,
  navigation.rs:56-64) — with an LRU-bounded named-statement cache
  so hot statements parse once per connection;
* errors surface as :class:`PgWireError` with ``.sqlstate``, which is
  what the store's UNDEFINED_TABLE lazy-DDL retry path keys on
  (client.rs:178-225).

The surface mirrors asyncpg (``connect`` / ``execute`` / ``fetch`` /
``close``) so `postgres_store` drives all three drivers identically.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import os
import re
import ssl as ssl_mod
import struct
from datetime import date, datetime, timedelta, timezone
from urllib.parse import parse_qs, unquote, urlparse

PROTOCOL_V3 = 196608       # 3 << 16
SSL_REQUEST = 80877103

_TS_RE = re.compile(
    r"(\d{4})-(\d{2})-(\d{2})[ T](\d{2}):(\d{2}):(\d{2})"
    r"(?:\.(\d{1,6}))?(?:([+-])(\d{2})(?::?(\d{2}))?)?$"
)


class PgWireError(Exception):
    """Server ErrorResponse. ``fields`` holds the single-letter keyed
    error fields; ``sqlstate`` is field 'C' (e.g. 42P01)."""

    def __init__(self, fields: dict[str, str]):
        self.fields = fields
        super().__init__(
            f"{fields.get('S', 'ERROR')} {fields.get('C', '?????')}: "
            f"{fields.get('M', 'unknown error')}"
        )

    @property
    def sqlstate(self) -> str | None:
        return self.fields.get("C")


# region: literal binding


def quote_literal(value) -> str:
    """One Python value → SQL literal. Standard-conforming quoting:
    only ``'`` doubles; backslashes are plain characters."""
    if value is None:
        return "NULL"
    if isinstance(value, bool):
        return "TRUE" if value else "FALSE"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return "'NaN'::float8"
        if value in (float("inf"), float("-inf")):
            return f"'{'-' if value < 0 else ''}Infinity'::float8"
        return repr(value)
    if isinstance(value, (bytes, bytearray, memoryview)):
        return f"'\\x{bytes(value).hex()}'::bytea"
    if isinstance(value, datetime):
        return f"'{value.isoformat()}'::timestamptz"
    if isinstance(value, date):
        return f"'{value.isoformat()}'::date"
    if isinstance(value, str):
        return "'" + value.replace("'", "''") + "'"
    raise TypeError(f"cannot bind {type(value).__name__} as SQL literal")


def bind_params(sql: str, params: tuple) -> str:
    """Substitute ``$N`` placeholders with quoted literals. ``$N``
    inside string literals is left alone (the store's SQL never puts
    placeholders in literals, but correctness is cheap: split on
    quotes first)."""
    if not params:
        return sql
    lits = [quote_literal(p) for p in params]

    def sub(m: re.Match) -> str:
        n = int(m.group(1))
        if not 1 <= n <= len(lits):
            raise IndexError(f"${n} out of range for {len(lits)} params")
        return lits[n - 1]

    parts = sql.split("'")
    for i in range(0, len(parts), 2):  # even chunks are outside quotes
        parts[i] = re.sub(r"\$(\d+)", sub, parts[i])
    return "'".join(parts)


# endregion

# region: extended-protocol parameter encoding


def param_oid(value) -> int:
    """Declared parameter type for Parse. Explicit OIDs (rather than 0
    = infer) let the server type-check the Bind values and keep the
    in-process test double's decoding honest. bool must precede int
    (bool is an int subclass)."""
    if value is None:
        return 0                      # NULL carries no type
    if isinstance(value, bool):
        return _OID_BOOL
    if isinstance(value, int):
        return _OID_INT8
    if isinstance(value, float):
        return _OID_FLOAT8
    if isinstance(value, (bytes, bytearray, memoryview)):
        return _OID_BYTEA
    if isinstance(value, datetime):
        return _OID_TIMESTAMPTZ
    if isinstance(value, date):
        return _OID_DATE
    if isinstance(value, str):
        return _OID_TEXT
    raise TypeError(f"cannot bind {type(value).__name__} as parameter")


def param_text(value) -> str | None:
    """One Python value → text-format Bind value (None = SQL NULL)."""
    if value is None:
        return None
    if isinstance(value, bool):
        return "t" if value else "f"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return "NaN"
        if value in (float("inf"), float("-inf")):
            return ("-" if value < 0 else "") + "Infinity"
        return repr(value)
    if isinstance(value, (bytes, bytearray, memoryview)):
        return "\\x" + bytes(value).hex()
    if isinstance(value, (datetime, date)):
        return value.isoformat()
    if isinstance(value, str):
        return value
    raise TypeError(f"cannot bind {type(value).__name__} as parameter")


# endregion

# region: text-format decoding

_OID_BOOL = 16
_OID_BYTEA = 17
_OID_INT8 = 20
_OID_INT2 = 21
_OID_INT4 = 23
_OID_TEXT = 25
_OID_OID = 26
_OID_FLOAT4 = 700
_OID_FLOAT8 = 701
_OID_NUMERIC = 1700
_OID_DATE = 1082
_OID_TIMESTAMP = 1114
_OID_TIMESTAMPTZ = 1184


def _parse_timestamp(text: str):
    m = _TS_RE.match(text)
    if m is None:
        return text  # e.g. 'infinity'
    y, mo, d, h, mi, s = (int(m.group(i)) for i in range(1, 7))
    us = int((m.group(7) or "0").ljust(6, "0"))
    tz = None
    if m.group(8):
        offset = int(m.group(9)) * 3600 + int(m.group(10) or "0") * 60
        tz = timezone.utc if offset == 0 else timezone(
            timedelta(seconds=offset * (-1 if m.group(8) == "-" else 1))
        )
    return datetime(y, mo, d, h, mi, s, us, tz)


def decode_text(oid: int, text: str):
    if oid in (_OID_INT2, _OID_INT4, _OID_INT8, _OID_OID):
        return int(text)
    if oid in (_OID_FLOAT4, _OID_FLOAT8, _OID_NUMERIC):
        return float(text)
    if oid == _OID_BOOL:
        return text == "t"
    if oid == _OID_BYTEA:
        if text.startswith("\\x"):
            return bytes.fromhex(text[2:])
        return text.encode("latin-1")  # legacy escape format
    if oid in (_OID_TIMESTAMP, _OID_TIMESTAMPTZ):
        return _parse_timestamp(text)
    if oid == _OID_DATE:
        y, mo, d = text.split("-")
        return date(int(y), int(mo), int(d))
    return text


# endregion

# region: SCRAM-SHA-256 (RFC 5802 / RFC 7677)


class _Scram:
    def __init__(self, user: str, password: str):
        self._password = password.encode()
        self._nonce = base64.b64encode(os.urandom(18)).decode()
        self.client_first_bare = f"n={user},r={self._nonce}"

    def client_first(self) -> bytes:
        return f"n,,{self.client_first_bare}".encode()

    def client_final(self, server_first: bytes) -> bytes:
        attrs = dict(
            kv.split("=", 1) for kv in server_first.decode().split(",")
        )
        r, salt, i = attrs["r"], base64.b64decode(attrs["s"]), int(attrs["i"])
        if not r.startswith(self._nonce):
            raise PgWireError({"C": "28000", "M": "SCRAM nonce mismatch"})
        salted = hashlib.pbkdf2_hmac("sha256", self._password, salt, i)
        client_key = hmac.digest(salted, b"Client Key", "sha256")
        stored_key = hashlib.sha256(client_key).digest()
        without_proof = f"c={base64.b64encode(b'n,,').decode()},r={r}"
        auth_message = (
            f"{self.client_first_bare},{server_first.decode()},"
            f"{without_proof}"
        ).encode()
        signature = hmac.digest(stored_key, auth_message, "sha256")
        proof = bytes(a ^ b for a, b in zip(client_key, signature))
        self._server_key = hmac.digest(salted, b"Server Key", "sha256")
        self._auth_message = auth_message
        return (
            f"{without_proof},p={base64.b64encode(proof).decode()}"
        ).encode()

    def verify_server_final(self, server_final: bytes) -> None:
        attrs = dict(
            kv.split("=", 1) for kv in server_final.decode().split(",")
        )
        expect = hmac.digest(self._server_key, self._auth_message, "sha256")
        if base64.b64decode(attrs.get("v", "")) != expect:
            raise PgWireError({"C": "28000", "M": "bad server signature"})


# endregion


class PgWireConnection:
    """One server connection: simple-query protocol for parameterless
    statements, extended-query protocol (with a named-statement cache)
    for everything with ``$N`` parameters."""

    #: named-statement cache bound (per connection). The store's hot
    #: statements (navigation lookup/insert, region read, dedupe
    #: delete) are a handful of shapes; multi-row INSERT shapes vary by
    #: row count, so the cache is LRU-bounded rather than unbounded.
    STMT_CACHE_MAX = 64

    def __init__(self, reader, writer, params: dict):
        self._reader = reader
        self._writer = writer
        self._params = params
        self._closed = False
        # one in-flight query cycle per connection: concurrent tasks
        # sharing the connection must serialize, or they interleave
        # reads on the shared stream and cross-wire each other's rows
        # (asyncpg raises InterfaceError here; we just queue)
        self._lock = asyncio.Lock()
        # keyed by (sql, declared param OIDs): Parse freezes the types,
        # so the same SQL bound with different Python types is a
        # different server-side statement
        self._stmts: dict[tuple, str] = {}
        self._stmt_seq = 0
        self._dead_stmts: list[str] = []   # to Close on the next cycle

    # -- connection establishment --

    @classmethod
    async def connect(cls, url: str) -> "PgWireConnection":
        u = urlparse(url)
        if u.scheme not in ("postgres", "postgresql"):
            raise ValueError(f"not a postgres url: {url}")
        host = u.hostname or "localhost"
        port = u.port or 5432
        user = unquote(u.username) if u.username else os.environ.get(
            "PGUSER", "postgres"
        )
        password = unquote(u.password) if u.password else os.environ.get(
            "PGPASSWORD", ""
        )
        database = (u.path or "/").lstrip("/") or user
        q = parse_qs(u.query)
        sslmode = q.get("sslmode", ["prefer"])[0]

        reader, writer = await asyncio.open_connection(host, port)
        try:
            if sslmode in ("require", "verify-ca", "verify-full"):
                writer.write(struct.pack(">ii", 8, SSL_REQUEST))
                await writer.drain()
                answer = await reader.readexactly(1)
                if answer != b"S":
                    raise PgWireError(
                        {"C": "08001", "M": "server refused TLS"}
                    )
                ctx = ssl_mod.create_default_context()
                if sslmode == "require":  # libpq parity: no cert check
                    ctx.check_hostname = False
                    ctx.verify_mode = ssl_mod.CERT_NONE
                elif sslmode == "verify-ca":  # CA yes, hostname no
                    ctx.check_hostname = False
                    ctx.verify_mode = ssl_mod.CERT_REQUIRED
                await writer.start_tls(ctx, server_hostname=host)

            conn = cls(reader, writer, {"user": user, "database": database})
            await conn._startup(user, password, database)
            return conn
        except BaseException:
            # a failed startup/auth must not leak the socket (stores
            # retry connects in a loop — one fd per attempt adds up)
            writer.close()
            raise

    async def _startup(self, user: str, password: str, database: str) -> None:
        body = b""
        for k, v in (("user", user), ("database", database),
                     ("client_encoding", "UTF8")):
            body += k.encode() + b"\0" + v.encode() + b"\0"
        body += b"\0"
        self._writer.write(
            struct.pack(">ii", len(body) + 8, PROTOCOL_V3) + body
        )
        await self._writer.drain()

        scram = None
        while True:
            tag, payload = await self._recv()
            if tag == b"R":
                (code,) = struct.unpack(">i", payload[:4])
                if code == 0:           # AuthenticationOk
                    continue
                if code == 3:           # cleartext
                    self._send(b"p", password.encode() + b"\0")
                elif code == 5:         # md5
                    salt = payload[4:8]
                    inner = hashlib.md5(
                        password.encode() + user.encode()
                    ).hexdigest()
                    digest = hashlib.md5(
                        inner.encode() + salt
                    ).hexdigest()
                    self._send(b"p", b"md5" + digest.encode() + b"\0")
                elif code == 10:        # SASL mechanisms
                    mechs = payload[4:].split(b"\0")
                    if b"SCRAM-SHA-256" not in mechs:
                        raise PgWireError(
                            {"C": "28000",
                             "M": f"unsupported SASL mechanisms {mechs}"}
                        )
                    scram = _Scram(user, password)
                    first = scram.client_first()
                    self._send(
                        b"p",
                        b"SCRAM-SHA-256\0"
                        + struct.pack(">i", len(first)) + first,
                    )
                elif code == 11:        # SASL continue
                    self._send(b"p", scram.client_final(payload[4:]))
                elif code == 12:        # SASL final
                    scram.verify_server_final(payload[4:])
                else:
                    raise PgWireError(
                        {"C": "28000",
                         "M": f"unsupported auth method {code}"}
                    )
                await self._writer.drain()
            elif tag == b"K":           # BackendKeyData
                continue
            elif tag == b"S":           # ParameterStatus
                continue
            elif tag == b"Z":           # ReadyForQuery
                return
            elif tag == b"E":
                raise PgWireError(self._error_fields(payload))
            # NoticeResponse and anything else: ignore

    # -- framing --

    def _send(self, tag: bytes, body: bytes) -> None:
        self._writer.write(tag + struct.pack(">i", len(body) + 4) + body)

    async def _recv(self) -> tuple[bytes, bytes]:
        head = await self._reader.readexactly(5)
        tag = head[:1]
        (length,) = struct.unpack(">i", head[1:5])
        payload = await self._reader.readexactly(length - 4)
        return tag, payload

    @staticmethod
    def _error_fields(payload: bytes) -> dict[str, str]:
        fields: dict[str, str] = {}
        for chunk in payload.split(b"\0"):
            if chunk:
                fields[chr(chunk[0])] = chunk[1:].decode(
                    "utf-8", "replace"
                )
        return fields

    @staticmethod
    def _parse_row_desc(payload: bytes) -> list[int]:
        (ncols,) = struct.unpack(">h", payload[:2])
        oids, off = [], 2
        for _ in range(ncols):
            end = payload.index(b"\0", off)
            oid = struct.unpack(">i", payload[end + 7:end + 11])[0]
            oids.append(oid)
            off = end + 19
        return oids

    @staticmethod
    def _parse_data_row(payload: bytes, oids: list[int]) -> tuple:
        (ncols,) = struct.unpack(">h", payload[:2])
        off, row = 2, []
        for c in range(ncols):
            (ln,) = struct.unpack(">i", payload[off:off + 4])
            off += 4
            if ln == -1:
                row.append(None)
            else:
                text = payload[off:off + ln].decode()
                off += ln
                row.append(decode_text(oids[c], text))
        return tuple(row)

    async def _read_cycle(self) -> tuple[list, str]:
        """Drain one query cycle (either protocol) to ReadyForQuery."""
        rows: list[tuple] = []
        oids: list[int] = []
        tag_line = ""
        error: PgWireError | None = None
        while True:
            tag, payload = await self._recv()
            if tag == b"T":             # RowDescription
                oids = self._parse_row_desc(payload)
            elif tag == b"D":           # DataRow
                rows.append(self._parse_data_row(payload, oids))
            elif tag == b"C":           # CommandComplete
                tag_line = payload.rstrip(b"\0").decode()
            elif tag == b"E":
                error = PgWireError(self._error_fields(payload))
            elif tag == b"Z":           # ReadyForQuery — end of cycle
                if error is not None:
                    raise error
                return rows, tag_line
            # '1' parse / '2' bind / '3' close complete, 'n' no data,
            # 's' portal suspended, 'N' notices, 'I' empty query,
            # 'S' params: ignored

    # -- queries (asyncpg-compatible surface) --

    async def _query(self, sql: str) -> tuple[list, str]:
        """Simple-query protocol: parameterless statements (DDL and
        navigation schema setup — tokio-postgres's batch_execute
        equivalent, client.rs:178-225)."""
        if self._closed:
            raise PgWireError({"C": "08003", "M": "connection is closed"})
        async with self._lock:
            self._send(b"Q", sql.encode() + b"\0")
            await self._writer.drain()
            return await self._read_cycle()

    async def _query_ext(self, sql: str, params: tuple) -> tuple[list, str]:
        """Extended-query protocol: Parse (cached per connection) →
        Bind (typed text-format parameters — values NEVER enter SQL
        text) → Describe → Execute → Sync, pipelined in one flush."""
        if self._closed:
            raise PgWireError({"C": "08003", "M": "connection is closed"})
        oids = tuple(param_oid(p) for p in params)
        key = (sql, oids)
        async with self._lock:
            # names orphaned by an earlier error cycle: Close them on
            # this pipeline (they no longer back any cache entry)
            for dead in self._dead_stmts:
                self._send(b"C", b"S" + dead.encode() + b"\0")
            self._dead_stmts.clear()
            name = self._stmts.pop(key, None)
            new_parse = name is None
            if new_parse:
                # evict LRU entries past the bound; Close rides the
                # same pipeline ahead of the Parse
                while len(self._stmts) >= self.STMT_CACHE_MAX:
                    old_key, old_name = next(iter(self._stmts.items()))
                    del self._stmts[old_key]
                    self._send(b"C", b"S" + old_name.encode() + b"\0")
                self._stmt_seq += 1
                name = f"_wql{self._stmt_seq}"
                body = name.encode() + b"\0" + sql.encode() + b"\0"
                body += struct.pack(">h", len(oids))
                for oid in oids:
                    body += struct.pack(">i", oid)
                self._send(b"P", body)

            bind = b"\0" + name.encode() + b"\0"
            bind += struct.pack(">hh", 1, 0)        # all params text
            bind += struct.pack(">h", len(params))
            for p in params:
                text = param_text(p)
                if text is None:
                    bind += struct.pack(">i", -1)
                else:
                    raw = text.encode()
                    bind += struct.pack(">i", len(raw)) + raw
            bind += struct.pack(">hh", 1, 0)        # all results text
            self._send(b"B", bind)
            self._send(b"D", b"P\0")                # describe portal
            self._send(b"E", b"\0" + struct.pack(">i", 0))
            self._send(b"S", b"")
            await self._writer.drain()
            try:
                result = await self._read_cycle()
            except PgWireError:
                # not re-cached: if the Parse failed the name does not
                # exist server-side; if it parsed but Bind/Execute
                # errored (or a cached statement went bad — 26000
                # after a pooler swap) re-parsing next call is the
                # safe recovery either way. The name may still exist
                # server-side — Close it on the next cycle (Close on
                # a nonexistent statement is a no-op by protocol).
                self._dead_stmts.append(name)
                raise
            self._stmts[key] = name     # (re-)insert at LRU tail
            return result

    async def execute(self, sql: str, *params) -> str:
        if params:
            _, tag_line = await self._query_ext(sql, params)
        else:
            _, tag_line = await self._query(sql)
        return tag_line

    async def fetch(self, sql: str, *params) -> list:
        if params:
            rows, _ = await self._query_ext(sql, params)
        else:
            rows, _ = await self._query(sql)
        return rows

    async def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self._send(b"X", b"")
                await self._writer.drain()
            except Exception:
                pass
            self._writer.close()


async def connect(url: str) -> PgWireConnection:
    """asyncpg-style module-level entry point."""
    return await PgWireConnection.connect(url)
