"""ctypes bridge to the native C++ wire codec (native/codec.cpp).

Loads the port's own build of the native library,
``build/native/libwqlcodec.so``, compiling it first from the
``native/`` sources with ``native/Makefile``'s compiler and flags when
it is missing (:func:`ensure_built`; ``build/`` is gitignored, so a
fresh checkout has none). The port never writes
``native/libwqlcodec.so``: that file is the JAX package's, which binds
its codec by whether the file exists when it is imported, so a library
that appeared there mid-session would hand one test session two
codecs. Without it
— no compiler, or ``WQL_NATIVE_CODEC=0`` — ``load()`` returns None and
the protocol package stays on the pure-Python codec: same semantics,
slower. The reference
pays this cost differently: its codec is compiled Rust behind a global
serializer mutex (structures/message.rs:116-134); here the native path
is re-entrant and per-call.

Message-level semantics (missing-field errors, Instruction/Replication
catch-alls, UUID parsing) stay in Python — the C layer only moves
bytes. Messages with more than ``WQL_MAX_OBJS`` records/entities fall
back to the Python codec transparently.
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import subprocess
import threading
import uuid as uuid_mod
from pathlib import Path

from .types import Entity, Instruction, Message, Record, Replication, Vector3

logger = logging.getLogger(__name__)

_REPO = Path(__file__).resolve().parent.parent.parent
#: the shared C++ sources and their Makefile
_NATIVE_DIR = _REPO / "native"
#: the port's build of them (gitignored ``build/``)
_LIB_PATH = _REPO / "build" / "native" / "libwqlcodec.so"
#: lock serialising the build across processes
_BUILD_LOCK = _REPO / "build" / "native.lock"

MAX_OBJS = 1024


class _WqlObj(ctypes.Structure):
    _fields_ = [
        ("uuid", ctypes.c_void_p), ("uuid_len", ctypes.c_int32),
        ("world", ctypes.c_void_p), ("world_len", ctypes.c_int32),
        ("data", ctypes.c_void_p), ("data_len", ctypes.c_int32),
        ("flex", ctypes.c_void_p), ("flex_len", ctypes.c_int32),
        ("x", ctypes.c_double), ("y", ctypes.c_double), ("z", ctypes.c_double),
        ("has_pos", ctypes.c_uint8),
    ]


class _WqlMsg(ctypes.Structure):
    _fields_ = [
        ("instruction", ctypes.c_uint8),
        ("replication", ctypes.c_uint8),
        ("has_pos", ctypes.c_uint8),
        ("x", ctypes.c_double), ("y", ctypes.c_double), ("z", ctypes.c_double),
        ("parameter", ctypes.c_void_p), ("parameter_len", ctypes.c_int32),
        ("sender", ctypes.c_void_p), ("sender_len", ctypes.c_int32),
        ("world", ctypes.c_void_p), ("world_len", ctypes.c_int32),
        ("flex", ctypes.c_void_p), ("flex_len", ctypes.c_int32),
        ("n_records", ctypes.c_int32),
        ("n_entities", ctypes.c_int32),
        ("records", _WqlObj * MAX_OBJS),
        ("entities", _WqlObj * MAX_OBJS),
    ]


def _view(ptr, length: int) -> bytes | None:
    if not ptr:
        return None
    return ctypes.string_at(ptr, length)


def _text(ptr, length: int) -> str | None:
    raw = _view(ptr, length)
    return None if raw is None else raw.decode("utf-8")


class NativeCodec:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.wql_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_WqlMsg)
        ]
        lib.wql_decode.restype = ctypes.c_int
        lib.wql_encode.argtypes = [
            ctypes.POINTER(_WqlMsg),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.wql_encode.restype = ctypes.c_int
        lib.wql_buffer_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.wql_buffer_free.restype = None
        lib.wql_max_objs.argtypes = []
        lib.wql_max_objs.restype = ctypes.c_int
        # Reusable scratch, one per thread: the ~128 KB _WqlMsg would be
        # wasteful to allocate per call, and sharing one across threads
        # would interleave half-populated messages.
        self._tls = threading.local()

    @property
    def _scratch(self) -> _WqlMsg:
        scratch = getattr(self._tls, "msg", None)
        if scratch is None:
            scratch = self._tls.msg = _WqlMsg()
        return scratch

    # region: decode

    def decode(self, data: bytes, errcls: type[Exception]) -> Message:
        try:
            return self._decode(data, errcls)
        except (errcls, _TooManyObjects):
            raise
        except Exception as exc:  # e.g. invalid UTF-8 → typed error
            raise errcls(f"invalid flatbuffer: {exc}") from exc

    def _decode(self, data: bytes, errcls: type[Exception]) -> Message:
        msg = self._scratch
        rc = self._lib.wql_decode(data, len(data), ctypes.byref(msg))
        if rc == -2:  # WQL_E_TOO_MANY → caller falls back to Python codec
            raise _TooManyObjects()
        if rc != 0:
            raise errcls(f"invalid flatbuffer (native rc {rc})")

        sender = _text(msg.sender, msg.sender_len)
        if sender is None:
            raise errcls("missing required field: sender_uuid")
        world = _text(msg.world, msg.world_len)
        if world is None:
            raise errcls("missing required field: world_name")
        try:
            sender_uuid = uuid_mod.UUID(sender)
        except ValueError as exc:
            raise errcls(f"invalid sender uuid: {exc}") from exc

        return Message(
            instruction=Instruction.from_wire(msg.instruction),
            parameter=_text(msg.parameter, msg.parameter_len),
            sender_uuid=sender_uuid,
            world_name=world,
            replication=Replication.from_wire(msg.replication),
            records=[
                self._decode_obj(msg.records[i], Record, errcls)
                for i in range(msg.n_records)
            ],
            entities=[
                self._decode_obj(msg.entities[i], Entity, errcls)
                for i in range(msg.n_entities)
            ],
            position=(
                Vector3(msg.x, msg.y, msg.z) if msg.has_pos else None
            ),
            flex=_view(msg.flex, msg.flex_len),
            wire=data,
        )

    @staticmethod
    def _decode_obj(o: _WqlObj, cls, errcls: type[Exception]):
        uuid_str = _text(o.uuid, o.uuid_len)
        if uuid_str is None:
            raise errcls("missing required field: uuid")
        world = _text(o.world, o.world_len)
        if world is None:
            raise errcls("missing required field: world_name")
        position = Vector3(o.x, o.y, o.z) if o.has_pos else None
        if cls is Entity and position is None:
            raise errcls("missing required field: position")
        try:
            obj_uuid = uuid_mod.UUID(uuid_str)
        except ValueError as exc:
            raise errcls(f"invalid uuid: {exc}") from exc
        kwargs = dict(
            uuid=obj_uuid,
            world_name=world,
            data=_text(o.data, o.data_len),
            flex=_view(o.flex, o.flex_len),
        )
        if cls is Entity:
            return Entity(position=position, **kwargs)
        return Record(position=position, **kwargs)

    # endregion

    # region: encode

    def encode(self, message: Message) -> bytes:
        if len(message.records) > MAX_OBJS or len(message.entities) > MAX_OBJS:
            raise _TooManyObjects()
        msg = self._scratch
        keep = []  # keep encoded bytes alive across the call

        def blob(value: bytes | None):
            if value is None:
                return None, 0
            keep.append(value)
            return ctypes.cast(ctypes.c_char_p(value), ctypes.c_void_p), len(value)

        msg.instruction = int(message.instruction)
        msg.replication = int(message.replication)
        if message.position is not None:
            msg.has_pos = 1
            msg.x, msg.y, msg.z = (
                message.position.x, message.position.y, message.position.z
            )
        else:
            msg.has_pos = 0
        msg.parameter, msg.parameter_len = blob(
            message.parameter.encode() if message.parameter is not None else None
        )
        msg.sender, msg.sender_len = blob(str(message.sender_uuid).encode())
        msg.world, msg.world_len = blob(message.world_name.encode())
        msg.flex, msg.flex_len = blob(message.flex)
        msg.n_records = len(message.records)
        msg.n_entities = len(message.entities)
        for i, rec in enumerate(message.records):
            self._encode_obj(msg.records[i], rec, blob)
        for i, ent in enumerate(message.entities):
            self._encode_obj(msg.entities[i], ent, blob)

        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = self._lib.wql_encode(
            ctypes.byref(msg), ctypes.byref(out), ctypes.byref(out_len)
        )
        if rc != 0:
            raise RuntimeError(f"native encode failed (rc {rc})")
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            self._lib.wql_buffer_free(out)

    @staticmethod
    def _encode_obj(slot: _WqlObj, obj, blob) -> None:
        slot.uuid, slot.uuid_len = blob(str(obj.uuid).encode())
        slot.world, slot.world_len = blob(obj.world_name.encode())
        slot.data, slot.data_len = blob(
            obj.data.encode() if obj.data is not None else None
        )
        slot.flex, slot.flex_len = blob(obj.flex)
        if obj.position is not None:
            slot.has_pos = 1
            slot.x, slot.y, slot.z = obj.position.x, obj.position.y, obj.position.z
        else:
            slot.has_pos = 0

    # endregion


class _TooManyObjects(Exception):
    """Internal: exceeds the native object cap; use the Python codec."""


def resolve_lib_path() -> Path | None:
    """Where the native shared library lives, honoring WQL_NATIVE_CODEC
    ('0' disables, '1'/unset = the port's build, else a path). Shared by
    every native binding (codec, spatial keys) so the policy cannot
    diverge."""
    env = os.environ.get("WQL_NATIVE_CODEC", "1")
    if env == "0":
        return None
    return _LIB_PATH if env == "1" else Path(env)


def ensure_built() -> None:
    """Build the port's library from ``native/`` (``make -C native``
    with a rule for the port's output path that reuses the Makefile's
    ``$(CXX) $(CXXFLAGS)``) when it is the one configured
    (WQL_NATIVE_CODEC unset or '1') and missing. Called by
    :func:`load`, which the ``protocol`` package runs at its import.
    Several processes may start at once (test workers, a server and
    its tools): the check and the build happen under an exclusive
    ``fcntl`` lock, so one builds and the others then find the finished
    library, never a half-written one. A failed build is logged and
    leaves the Python fallback."""
    if os.environ.get("WQL_NATIVE_CODEC", "1") != "1":
        return
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _LIB_PATH.exists():
            return
        rule = (f"{_LIB_PATH}: codec.cpp spatial.cpp\n"
                "\t$(CXX) $(CXXFLAGS) -shared -o $@ codec.cpp spatial.cpp")
        try:
            proc = subprocess.run(
                ["make", "-C", str(_NATIVE_DIR), "--no-print-directory",
                 f"--eval={rule}", str(_LIB_PATH)],
                capture_output=True, text=True, check=False,
            )
        except OSError as exc:  # no make on this host
            logger.warning("cannot build %s: %s", _LIB_PATH, exc)
            return
        if proc.returncode != 0:
            logger.warning("building %s failed (%s): %s", _LIB_PATH,
                           proc.returncode, proc.stderr[-2000:])


def load() -> NativeCodec | None:
    """Load the native codec, or None (pure-Python fallback).
    WQL_NATIVE_CODEC: '0' forces the fallback, '1'/unset uses the
    port's build (built here when missing), any other value is a path
    to the shared library (containers install it outside the source
    tree)."""
    env = os.environ.get("WQL_NATIVE_CODEC", "1")
    ensure_built()
    lib_path = resolve_lib_path()
    if lib_path is None:
        return None
    if not lib_path.exists():
        if env != "1":
            # An explicitly configured path that is missing is a
            # misconfiguration — don't fall back silently.
            logger.warning(
                "WQL_NATIVE_CODEC=%s does not exist; using Python codec",
                env,
            )
        return None
    try:
        codec = NativeCodec(ctypes.CDLL(str(lib_path)))
    except (OSError, AttributeError) as exc:
        # AttributeError: a stale .so missing a symbol — fall back, the
        # server must not die on a leftover build artifact.
        logger.warning("native codec failed to load: %s", exc)
        return None
    # The ctypes struct layout bakes in MAX_OBJS; a library built with a
    # different cap would corrupt memory, so verify instead of trusting.
    lib_cap = codec._lib.wql_max_objs()
    if lib_cap != MAX_OBJS:
        logger.warning(
            "native codec cap mismatch (lib %d != %d) — rebuild "
            "%s; falling back to Python codec",
            lib_cap, MAX_OBJS, lib_path,
        )
        return None
    return codec
