"""Multi-core delivery plane.

Breaks the GIL ceiling on fan-out delivery: after the ticker's collect
stage, the serialize-once frame pump writes ``(frame_bytes, slot_list)``
batches into per-worker shared-memory rings (:mod:`.ring` — struct
framing, no per-frame pickling), drained by N sender worker processes
(:mod:`.worker`) that own disjoint shards of the live sockets. The
parent keeps authoritative PeerMap membership (:mod:`.plane`) and
routes each delivery batch to the owning shard; workers report
send-failures/evictions back over a control channel so staleness
sweeping and ``on_peer_removed`` semantics are unchanged.

``--delivery-workers 0`` (the default) constructs none of this and the
sequential in-process pump stays byte-for-byte.
"""

from .plane import DeliveryPlane
from .ring import Ring, RING_MIN_BYTES

__all__ = ["DeliveryPlane", "Ring", "RING_MIN_BYTES"]
