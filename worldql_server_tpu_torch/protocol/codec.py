"""FlatBuffers wire codec for the WorldQL ``Message`` envelope.

Wire-compatible with the reference's generated codec
(worldql_server/src/flatbuffers/WorldQLFB_generated.rs; schema
reconstructed in ``worldql.fbs``). Buffers are finished without a file
identifier or size prefix (structures/message.rs:120-134).

Unlike the reference — which funnels every serialization through one
global ``Lazy<Mutex<FlatBufferBuilder>>`` (message.rs:116-117, a
deliberate single-builder bottleneck) — serialization here is
re-entrant: each call uses its own builder, so per-peer sends can
serialize concurrently.

The Python FlatBuffers runtime has no verifier; the reader below is
pure Python with bounds-checked slicing, so malformed buffers raise
``DeserializeError`` rather than reading out of bounds. Transports
additionally cap frame size.

The ``flatbuffers`` runtime is imported inside the pure-Python codec
functions, not at module top: with the native library
(``build/native/libwqlcodec.so``, protocol/native_codec.py) built,
encode and decode never reach them, and the port then needs no
``flatbuffers`` package at all.
"""

from __future__ import annotations

import uuid as uuid_mod

from .types import Entity, Instruction, Message, Record, Replication, Vector3

# Message table vtable slots (WorldQLFB_generated.rs:939-947)
_MSG_INSTRUCTION = 0
_MSG_PARAMETER = 1
_MSG_SENDER_UUID = 2
_MSG_WORLD_NAME = 3
_MSG_REPLICATION = 4
_MSG_RECORDS = 5
_MSG_ENTITIES = 6
_MSG_POSITION = 7
_MSG_FLEX = 8

# Record/Entity table vtable slots (WorldQLFB_generated.rs:485-489)
_OBJ_UUID = 0
_OBJ_POSITION = 1
_OBJ_WORLD_NAME = 2
_OBJ_DATA = 3
_OBJ_FLEX = 4


class DeserializeError(ValueError):
    """Invalid flatbuffer or missing required fields
    (message.rs:145-152)."""


# region: writing


def _create_vec3d(builder: flatbuffers.Builder, v: Vector3) -> int:
    """Write the 24-byte Vec3d struct inline (x, y, z f64)."""
    builder.Prep(8, 24)
    builder.PrependFloat64(v.z)
    builder.PrependFloat64(v.y)
    builder.PrependFloat64(v.x)
    return builder.Offset()


def _write_obj(builder: flatbuffers.Builder, obj: Record | Entity) -> int:
    """Write one Record/Entity table; both share the same layout."""
    uuid_off = builder.CreateString(str(obj.uuid))
    world_off = builder.CreateString(obj.world_name)
    data_off = builder.CreateString(obj.data) if obj.data is not None else None
    flex_off = builder.CreateByteVector(obj.flex) if obj.flex is not None else None

    builder.StartObject(5)
    builder.PrependUOffsetTRelativeSlot(_OBJ_UUID, uuid_off, 0)
    if obj.position is not None:
        pos_off = _create_vec3d(builder, obj.position)
        builder.PrependStructSlot(_OBJ_POSITION, pos_off, 0)
    builder.PrependUOffsetTRelativeSlot(_OBJ_WORLD_NAME, world_off, 0)
    if data_off is not None:
        builder.PrependUOffsetTRelativeSlot(_OBJ_DATA, data_off, 0)
    if flex_off is not None:
        builder.PrependUOffsetTRelativeSlot(_OBJ_FLEX, flex_off, 0)
    return builder.EndObject()


def _write_obj_vector(builder: flatbuffers.Builder, offsets: list[int]) -> int:
    builder.StartVector(4, len(offsets), 4)
    for off in reversed(offsets):
        builder.PrependUOffsetTRelative(off)
    return builder.EndVector()


def serialize_message(message: Message) -> bytes:
    """Message → wire bytes. Always writes sender_uuid and world_name,
    like the reference encoder (message.rs:41-52)."""
    import flatbuffers

    builder = flatbuffers.Builder(256)

    record_offs = [_write_obj(builder, r) for r in message.records]
    entity_offs = [_write_obj(builder, e) for e in message.entities]

    records_vec = _write_obj_vector(builder, record_offs) if record_offs else None
    entities_vec = _write_obj_vector(builder, entity_offs) if entity_offs else None

    param_off = (
        builder.CreateString(message.parameter)
        if message.parameter is not None
        else None
    )
    sender_off = builder.CreateString(str(message.sender_uuid))
    world_off = builder.CreateString(message.world_name)
    flex_off = (
        builder.CreateByteVector(message.flex) if message.flex is not None else None
    )

    builder.StartObject(9)
    builder.PrependUint8Slot(_MSG_INSTRUCTION, int(message.instruction), 0)
    if param_off is not None:
        builder.PrependUOffsetTRelativeSlot(_MSG_PARAMETER, param_off, 0)
    builder.PrependUOffsetTRelativeSlot(_MSG_SENDER_UUID, sender_off, 0)
    builder.PrependUOffsetTRelativeSlot(_MSG_WORLD_NAME, world_off, 0)
    builder.PrependUint8Slot(_MSG_REPLICATION, int(message.replication), 0)
    if records_vec is not None:
        builder.PrependUOffsetTRelativeSlot(_MSG_RECORDS, records_vec, 0)
    if entities_vec is not None:
        builder.PrependUOffsetTRelativeSlot(_MSG_ENTITIES, entities_vec, 0)
    if message.position is not None:
        pos_off = _create_vec3d(builder, message.position)
        builder.PrependStructSlot(_MSG_POSITION, pos_off, 0)
    if flex_off is not None:
        builder.PrependUOffsetTRelativeSlot(_MSG_FLEX, flex_off, 0)
    root = builder.EndObject()

    builder.Finish(root)
    return bytes(builder.Output())


# endregion

# region: reading


def _slot(table: Table, slot: int) -> int:
    """Field offset for vtable slot N, or 0 if absent."""
    return table.Offset(4 + 2 * slot)


def _read_string(table: Table, slot: int) -> str | None:
    o = _slot(table, slot)
    if o == 0:
        return None
    raw = table.String(o + table.Pos)
    return raw.decode("utf-8")


def _read_bytes(table: Table, slot: int) -> bytes | None:
    o = _slot(table, slot)
    if o == 0:
        return None
    start = table.Vector(o)
    length = table.VectorLen(o)
    return bytes(table.Bytes[start : start + length])


def _read_u8(table: Table, slot: int, default: int) -> int:
    from flatbuffers import number_types as N

    o = _slot(table, slot)
    if o == 0:
        return default
    return table.Get(N.Uint8Flags, o + table.Pos)


def _read_vec3d(table: Table, slot: int) -> Vector3 | None:
    from flatbuffers import number_types as N

    o = _slot(table, slot)
    if o == 0:
        return None
    base = o + table.Pos
    return Vector3(
        table.Get(N.Float64Flags, base),
        table.Get(N.Float64Flags, base + 8),
        table.Get(N.Float64Flags, base + 16),
    )


def _read_obj(table: Table, cls: type) -> Record | Entity:
    uuid_str = _read_string(table, _OBJ_UUID)
    if uuid_str is None:
        raise DeserializeError("missing required field: uuid")
    position = _read_vec3d(table, _OBJ_POSITION)
    world_name = _read_string(table, _OBJ_WORLD_NAME)
    if world_name is None:
        raise DeserializeError("missing required field: world_name")

    if cls is Entity and position is None:
        raise DeserializeError("missing required field: position")

    return cls(
        uuid=uuid_mod.UUID(uuid_str),
        position=position,
        world_name=world_name,
        data=_read_string(table, _OBJ_DATA),
        flex=_read_bytes(table, _OBJ_FLEX),
    )


def _read_obj_vector(table: Table, slot: int, cls: type) -> list:
    from flatbuffers.table import Table

    o = _slot(table, slot)
    if o == 0:
        return []
    length = table.VectorLen(o)
    out = []
    for i in range(length):
        x = table.Vector(o) + i * 4
        x = table.Indirect(x)
        out.append(_read_obj(Table(table.Bytes, x), cls))
    return out


def deserialize_message(buf: bytes | bytearray | memoryview) -> Message:
    """Wire bytes → Message.

    Required-field semantics match the reference decoder
    (message.rs:56-111): world_name and sender_uuid must be present and
    the uuid must parse; unknown instruction values map to
    ``Instruction.UNKNOWN``; unknown replication values map to the
    default ``EXCEPT_SELF``.
    """
    from flatbuffers import encode as fb_encode
    from flatbuffers import number_types as N
    from flatbuffers.table import Table

    try:
        # Snapshot mutable receive buffers FIRST: ``Message.wire`` is
        # the serialize-once broadcast cache, shared and concatenated
        # into frames that outlive this call — a reused bytearray would
        # corrupt re-broadcasts and a memoryview breaks frame concat
        # (ADVICE r5). ``bytes(bytes)`` is a no-copy identity.
        buf = bytes(buf)
        if len(buf) < 8:
            raise DeserializeError("buffer too small")
        root = fb_encode.Get(N.UOffsetTFlags.packer_type, buf, 0)
        if root + 4 > len(buf):
            raise DeserializeError("root offset out of bounds")
        table = Table(buf, root)

        sender_str = _read_string(table, _MSG_SENDER_UUID)
        if sender_str is None:
            raise DeserializeError("missing required field: sender_uuid")
        world_name = _read_string(table, _MSG_WORLD_NAME)
        if world_name is None:
            raise DeserializeError("missing required field: world_name")

        return Message(
            instruction=Instruction.from_wire(
                _read_u8(table, _MSG_INSTRUCTION, 0)
            ),
            parameter=_read_string(table, _MSG_PARAMETER),
            sender_uuid=uuid_mod.UUID(sender_str),
            world_name=world_name,
            replication=Replication.from_wire(
                _read_u8(table, _MSG_REPLICATION, 0)
            ),
            records=_read_obj_vector(table, _MSG_RECORDS, Record),
            entities=_read_obj_vector(table, _MSG_ENTITIES, Entity),
            position=_read_vec3d(table, _MSG_POSITION),
            flex=_read_bytes(table, _MSG_FLEX),
            wire=buf,
        )
    except DeserializeError:
        raise
    except Exception as exc:  # malformed buffer → typed error, never OOB
        raise DeserializeError(f"invalid flatbuffer: {exc}") from exc


# endregion

# region: native dispatch

# Pure-Python implementations stay importable for tests and fallback.
py_serialize_message = serialize_message
py_deserialize_message = deserialize_message

from . import native_codec as _native_codec  # noqa: E402

_native = _native_codec.load()

#: codec health counters, exported as the `codec` gauge by the server.
#: obj_overflow: messages whose records/entities exceeded WQL_MAX_OBJS
#: and silently took the ~10x-slower Python codec — before this counter
#: that cliff was invisible. Plain int increments:
#: the codec runs on the event loop and in sender workers, each process
#: counting its own.
codec_stats = {"obj_overflow": 0}

if _native is not None:

    def serialize_message(message: Message) -> bytes:  # noqa: F811
        try:
            return _native.encode(message)
        except _native_codec._TooManyObjects:
            codec_stats["obj_overflow"] += 1
            return py_serialize_message(message)

    def deserialize_message(buf: bytes | bytearray | memoryview) -> Message:  # noqa: F811
        try:
            return _native.decode(bytes(buf), DeserializeError)
        except _native_codec._TooManyObjects:
            codec_stats["obj_overflow"] += 1
            return py_deserialize_message(bytes(buf))

# endregion
