"""Cluster trace context: the cross-process frame clock + trace id.

The delivery plane gave a single process one honest frame clock (CLOCK_MONOTONIC ns
stamped at dispatch, closed at socket-write-complete). A cluster frame
crosses up to three processes — router → home shard → remote shard —
and every hop is on ONE host (the router supervises its shard
subprocesses), so the same clock domain spans the whole path. This
module defines the compact context that rides every router→shard
forward as a small framed prefix:

    [4B magic "WQTX"][u64 trace_id][u64 t_ingress_ns]      (20 bytes)

* ``trace_id`` — a random nonzero 64-bit id minted by the router per
  inbound message. Every span/segment any process records for this
  message carries it (hex-tagged), so ``GET /debug/cluster`` can
  stitch one frame's router→home→remote chain across pid lanes.
* ``t_ingress_ns`` — ``time.monotonic_ns()`` at router ingress. Shards
  close it at socket-write-complete into the live ``cluster.e2e_ms``
  histogram (the delivery ring-stamp precedent, stretched across the
  process boundary; comparable across processes on one host).

``unwrap`` is safe on unprefixed bytes: anything not starting with the
magic passes through untouched ``(0, 0, data)``, so a shard reached
directly (tests, a misconfigured client) still decodes. The magic can
never be a valid FlatBuffers message start: read as the root offset it
is ~1.1 GB, which the codec's bounds validation rejects.

The prefix rides ONLY the router→shard leg. Fan-out re-broadcasts the
UNWRAPPED wire bytes (``Message.wire`` is set after stripping), and
inter-shard ring frames carry the context in their own fixed header
(``cluster/bus.py``) — the delivery ring record layout itself is
untouched, so ``--cluster-shards 0`` stays byte-for-byte.

Live resharding extends the prefix with the PLACEMENT
EPOCH the router stamped the forward under:

    [4B magic "WQT2"][u64 trace_id][u64 t_ingress_ns][u64 epoch]  (28B)

A shard compares the frame's epoch against its control-synced
:class:`~.resharding.placement.PlacementMap`: a frame stamped under an
OLDER epoch whose world the shard no longer owns is rejected with a
re-route hint instead of misapplied (router push backlogs drain across
a migration flip). ``unwrap_epoch`` decodes BOTH magics — v1 frames
carry epoch 0, which never fails the staleness check — so mixed
fleets and pre-cluster tests keep decoding.
"""

from __future__ import annotations

import random
import struct

MAGIC = b"WQTX"
_PREFIX = struct.Struct("<4sQQ")
PREFIX_LEN = _PREFIX.size  # 20

#: epoch-stamped v2 prefix (live resharding)
MAGIC2 = b"WQT2"
_PREFIX2 = struct.Struct("<4sQQQ")
PREFIX2_LEN = _PREFIX2.size  # 28

#: module-owned RNG for trace-id minting (seedable in tests)
_rng = random.Random()


def new_trace_id(rng: random.Random | None = None) -> int:
    """A random NONZERO 64-bit trace id (0 means "no context" on the
    wire, so it is never minted)."""
    r = rng if rng is not None else _rng
    while True:
        tid = r.getrandbits(64)
        if tid:
            return tid


def wrap(data: bytes, trace_id: int, t_ingress_ns: int) -> bytes:
    """Prefix one wire message with its trace context (router side)."""
    return _PREFIX.pack(MAGIC, trace_id, t_ingress_ns) + data


def unwrap(data: bytes) -> tuple[int, int, bytes]:
    """Strip a trace-context prefix → ``(trace_id, t_ingress_ns,
    payload)``; unprefixed bytes pass through as ``(0, 0, data)``."""
    if len(data) >= PREFIX_LEN and data[:4] == MAGIC:
        _, trace_id, t_ingress = _PREFIX.unpack_from(data)
        return trace_id, t_ingress, data[PREFIX_LEN:]
    return 0, 0, data


def wrap_epoch(
    data: bytes, trace_id: int, t_ingress_ns: int, epoch: int
) -> bytes:
    """Prefix one wire message with trace context + the placement
    epoch it was routed under (the resharding router's forward path —
    the ``epochless-forward`` lint rule keeps every forwarding site on
    this wrapper)."""
    return _PREFIX2.pack(MAGIC2, trace_id, t_ingress_ns, epoch) + data


def unwrap_epoch(data: bytes) -> tuple[int, int, int, bytes]:
    """Strip either prefix generation → ``(trace_id, t_ingress_ns,
    epoch, payload)``. v1 ("WQTX") frames and unprefixed bytes carry
    epoch 0 — "no placement claim", never stale."""
    if len(data) >= PREFIX2_LEN and data[:4] == MAGIC2:
        _, trace_id, t_ingress, epoch = _PREFIX2.unpack_from(data)
        return trace_id, t_ingress, epoch, data[PREFIX2_LEN:]
    if len(data) >= PREFIX_LEN and data[:4] == MAGIC:
        _, trace_id, t_ingress = _PREFIX.unpack_from(data)
        return trace_id, t_ingress, 0, data[PREFIX_LEN:]
    return 0, 0, 0, data


def trace_id_hex(trace_id: int) -> str:
    """The canonical span-tag form of a trace id."""
    return format(trace_id, "016x")
