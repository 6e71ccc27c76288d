"""Inter-shard frame bus: the cluster's data plane.

The delivery ring (:class:`~..delivery.ring.Ring`) was built as a
parent→sender-worker conduit; here the SAME shared-memory SPSC ring is
reused between two UNRELATED server processes — one ring per ordered
shard pair (i→j), created by the router-tier supervisor and attached
by name from the ``WQL_CLUSTER_SPEC`` topology, so an N-shard cluster
carries a full N×(N−1) mesh of lock-free byte conduits with no broker
in the middle.

Bus records are delivery frames for peers homed on the consuming
shard: ``[u64 trace_id][u64 t_router_ingress_ns][16-byte target uuid]
[wire bytes]`` in the ring's frame slot (the slot list stays empty —
slot ids are a delivery-plane concept; here the target is a wire-level
uuid). The leading 16 bytes are the CLUSTER TRACE CONTEXT
(cluster/tracectx.py — zeros when the frame was never router-stamped),
carried INSIDE the frame so the delivery ring's own record layout is
untouched. The ring's two monotonic-ns stamps ride along unchanged:
``t_ingress`` is the SENDING shard's enqueue clock and
``t_ring_write`` the ring's own write stamp, so the consuming shard
closes two honest clocks at socket-write-complete:
``cluster.xshard_ms`` (home-shard-enqueue→remote-shard-write) and —
when the context is present — ``cluster.e2e_ms``
(router-ingress→remote-shard-write).

The cardinal rule (enforced by the ``blocking-cross-shard`` lint
rule): tick-path code never awaits an inter-shard ROUND TRIP. Sends
are fire-and-forget ``try_write`` (a full ring drops + counts — the
delivery plane's bounded-degradation discipline; a wedged peer shard can never
stall this shard's tick), and receives happen in the tick's own
``cluster.drain`` leg, overlapped with the in-flight local dispatch.

Rings are created (and unlinked) ONLY by the supervisor: a shard
SIGKILL leaves its rings intact, the restarted process re-attaches by
name and drains whatever queued while it was down — cross-shard
frames for its reconnecting peers degrade to undelivered counts, not
to a torn conduit.
"""

from __future__ import annotations

import logging
import struct
import uuid as uuid_mod

from ..delivery.ring import Ring

logger = logging.getLogger(__name__)

UUID_LEN = 16

#: per-frame cluster trace context: [u64 trace_id][u64 t_router_ingress]
_CTX = struct.Struct("<QQ")
CTX_LEN = _CTX.size
HEADER_LEN = CTX_LEN + UUID_LEN


class InterShardBus:
    """One shard's view of the ring mesh: producer on every outbound
    ring (this shard → peer), consumer on every inbound ring (peer →
    this shard). Attach-by-name from the supervisor's topology spec."""

    def __init__(self, shard_id: int):
        self.shard_id = shard_id
        self._tx: dict[int, Ring] = {}
        self._rx: dict[int, Ring] = {}
        # accounting — nothing the bus drops is ever silent
        self.sent = 0
        self.dropped = 0
        self.drained = 0

    # region: topology

    def attach(self, rings_out: dict, rings_in: dict) -> None:
        """Attach the shard to its ring mesh. Keys are PEER shard ids
        (as int or str — JSON round-trips them as str), values are
        shared-memory names minted by the supervisor."""
        for peer, name in rings_out.items():
            self._tx[int(peer)] = Ring.attach(name)
        for peer, name in rings_in.items():
            self._rx[int(peer)] = Ring.attach(name)

    def close(self) -> None:
        """Detach (attachers never unlink — the supervisor owns the
        shared memory's lifetime)."""
        for ring in (*self._tx.values(), *self._rx.values()):
            ring.close()
        self._tx.clear()
        self._rx.clear()

    def peers(self) -> list[int]:
        return sorted(self._rx)

    # endregion

    # region: data plane

    def send_frame(
        self, target_shard: int, peer: uuid_mod.UUID, data: bytes,
        t_ingress_ns: int = 0, ctx: tuple | None = None,
    ) -> bool:
        """Enqueue one delivery frame toward ``peer``'s home shard.
        Fire-and-forget: a full ring (peer shard down or drowning)
        DROPS the frame — counted, never blocking the caller's tick.
        Record ops never ride this path (they route to the owner shard
        at the router), so a bus drop can only cost pub/sub frames,
        exactly like the delivery plane's ring_full_drops. ``ctx`` is
        the frame's cluster trace context ``(trace_id,
        t_router_ingress_ns)`` — it rides the frame header so the
        remote shard closes the router-ingress clock and stitches the
        frame into its tick trace; None writes a zeroed header."""
        ring = self._tx.get(target_shard)
        if ring is None:
            self.dropped += 1
            return False
        trace_id, t_ctx = ctx if ctx is not None else (0, 0)
        ctx_header = _CTX.pack(trace_id, t_ctx) + peer.bytes
        if ring.try_write(ctx_header + data, b"", t_ingress_ns):
            self.sent += 1
            return True
        self.dropped += 1
        return False

    def drain(self, max_records: int = 4096) -> list:
        """Consume up to ``max_records`` inbound frames across all
        peer rings (round-robin by ring, bounded so one chatty peer
        shard cannot monopolize a tick) →
        ``[(peer_uuid, wire_bytes, t_enqueue_ns, t_ring_write_ns,
        trace_id, t_router_ingress_ns), ...]`` — the two ring stamps
        plus the frame-header trace context, everything the consuming
        shard needs to close both cross-process clocks at
        socket-write-complete."""
        out: list = []
        budget = max_records
        for ring in self._rx.values():
            while budget > 0:
                rec = ring.read_record()
                if rec is None:
                    break
                frame, _slots, t_ingress, t_write = rec
                if len(frame) <= HEADER_LEN:
                    logger.warning("runt inter-shard record dropped")
                    continue
                trace_id, t_ctx = _CTX.unpack_from(frame)
                out.append((
                    uuid_mod.UUID(bytes=frame[CTX_LEN:HEADER_LEN]),
                    frame[HEADER_LEN:],
                    t_ingress,
                    t_write,
                    trace_id,
                    t_ctx,
                ))
                budget -= 1
        self.drained += len(out)
        return out

    def pending(self) -> bool:
        """Whether any inbound ring holds unread records (cheap cursor
        peek — the drain pump's idle test)."""
        return any(r.pending_bytes() > 0 for r in self._rx.values())

    # endregion

    def stats(self) -> dict:
        return {
            "sent": self.sent,
            "dropped": self.dropped,
            "drained": self.drained,
        }


def create_ring_mesh(n_shards: int, ring_bytes: int) -> dict:
    """Supervisor-side: create the full N×(N−1) ring mesh. Returns
    ``{"rings": {(i, j): Ring}, "names": {i: {"out": {j: name},
    "in": {j: name}}}}`` — ``names[i]`` is shard i's attach spec."""
    rings: dict[tuple, Ring] = {}
    for i in range(n_shards):
        for j in range(n_shards):
            if i != j:
                rings[(i, j)] = Ring.create(ring_bytes)
    names = {
        i: {
            "out": {
                j: rings[(i, j)].name for j in range(n_shards) if j != i
            },
            "in": {
                j: rings[(j, i)].name for j in range(n_shards) if j != i
            },
        }
        for i in range(n_shards)
    }
    return {"rings": rings, "names": names}
