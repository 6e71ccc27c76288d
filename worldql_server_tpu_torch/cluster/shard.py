"""Shard-side cluster extension: remote peers, ring drain, control.

A cluster shard IS the existing single-process server — same router,
ticker, WAL, governor, entity plane — plus this extension, attached
when ``--cluster-role shard`` boots with a ``WQL_CLUSTER_SPEC``
topology. It adds exactly three things:

* **Remote peer proxies.** Every peer is HOMED on one shard (stable
  uuid hash — world_map.py); the home shard owns the real connect-back
  socket. When the router announces a peer homed elsewhere (control
  ``adopt``), this shard registers a :class:`~..engine.peers.Peer`
  whose write paths enqueue the frame onto the inter-shard ring toward
  the home shard — so the UNCHANGED fan-out code (``PeerMap.
  deliver_batch``, broadcasts, record replies) transparently reaches
  peers connected anywhere in the cluster. Proxies register/deregister
  through the SILENT map paths (``rebind``/``detach``): peer lifecycle
  broadcasts (PeerConnect/Disconnect) are emitted once, by the home
  shard, and reach every client exactly once — local peers directly,
  remote ones through the proxies of THAT broadcast.
* **The cross-shard drain.** Frames arriving on the inbound rings are
  delivered to local sockets inside the tick, between the local
  batch's device dispatch and its collect (``cluster.drain`` span) —
  the TileLoom overlap discipline: the inter-shard leg hides behind
  the in-flight device window instead of serializing in front of it.
  Tickerless (immediate-mode) shards run a supervised drain pump
  instead. The cross-shard leg is enqueue-and-drain ONLY (lint:
  ``blocking-cross-shard``) — nothing on the tick path ever awaits a
  remote shard.
* **The control channel.** AF_UNIX SEQPACKET to the router-tier
  supervisor: inbound ``adopt``/``drop`` maintain the proxy plane;
  outbound ``state`` exports the shard's overload-governor level (the
  router's shed mirror REJECTs at the router before this shard ever
  sees the bytes) and ``peer_gone`` reports a homed peer's teardown so
  the router reaps its proxies cluster-wide. Control-channel EOF means
  the router died: the shard requests its own clean shutdown rather
  than serving unreachable.

Cluster observability rides the same three surfaces:

* Every router-forwarded message carries a trace context
  (``tracectx.py``: 64-bit trace id + router-ingress monotonic-ns
  stamp). The shard closes that clock at socket-write-complete —
  locally delivered frames through the ticker's post-delivery
  :meth:`close_frames`, ring-drained frames inside :meth:`drain` —
  into the live ``cluster.e2e_ms`` histogram, and closes
  ``cluster.xshard_ms`` (home-shard-enqueue → remote-shard-write)
  for every drained frame. A frame slower than ``--slow-frame-ms``
  auto-dumps its stitched router→home→remote stage chain as one JSON
  line (the slow-tick discipline, per cross-shard frame).
* ``state`` packets piggyback cumulative histogram/counter snapshots
  (``Metrics.export_histograms``); the router diffs consecutive
  packets and merges them restart-monotone into ONE federated
  /metrics (cluster/federation.py).
* A control ``dump`` request chunks the shard's FlightRecorder
  snapshot back to the router, which splices every process's spans
  into one Chrome trace at ``GET /debug/cluster``. Drained-frame
  segments are stitched as ``router.forward`` / ``cluster.ring_dwell``
  spans under the receiving shard's tick trace at export time (the
  delivery-plane stitcher idiom).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import socket
import time
import uuid as uuid_mod
from collections import deque

from ..engine.peers import Peer
from ..protocol import Instruction
from ..robustness import failpoints
from . import tracectx
from .bus import InterShardBus
from .resharding import (
    FENCE_MAGIC,
    ChunkAssembler,
    PlacementMap,
    encode_chunks,
    export_world,
    import_world,
    parse_fence,
    tombstone_world,
)

logger = logging.getLogger(__name__)

from .supervisor import CLUSTER_SPEC_ENV  # noqa: E402  (shared env name)

#: inbound ring records consumed per drain call — bounds one tick's
#: drain leg; the remainder stays queued for the next tick (or the
#: immediate re-drain when the pump sees pending bytes)
DRAIN_MAX = 4096

#: governor state export cadence: immediate on a level change, plus a
#: heartbeat so the router can age out a wedged shard's state
STATE_INTERVAL_S = 1.0
STATE_POLL_S = 0.1

#: histogram series piggybacked on state packets for the router-side
#: metrics federation — bounded by prefix so a packet stays well under
#: the control channel's 64 KiB datagram read
FED_HIST_PREFIXES = (
    "cluster.", "frame.", "tick.", "delivery.", "broadcast.",
)

#: drained-frame segments retained for flight-recorder stitching and
#: counter packets kept per state push (the delivery plane's ≤128-segment bound)
SEGMENT_DEPTH = 512

#: slow-frame dumps are the pathological path, but a drain can carry
#: thousands of frames — bound the per-drain dump burst (the rest are
#: counted, never silent)
SLOW_FRAME_DUMPS_PER_DRAIN = 8

SLOW_FRAME_FILENAME = "slow-frames.jsonl"

#: control-channel dump chunking: JSON-escaped chunk + envelope must
#: stay under the supervisor's 64 KiB sock_recv
DUMP_CHUNK_CHARS = 24_000


class _BusFrame:
    """Ready wire bytes off the inter-shard ring — deliver_batch
    consumes ``.wire`` and never re-serializes."""

    __slots__ = ("wire",)

    def __init__(self, wire: bytes):
        self.wire = wire


def load_spec(env: dict | None = None) -> dict:
    raw = (env or os.environ).get(CLUSTER_SPEC_ENV)
    if not raw:
        raise RuntimeError(
            "--cluster-role shard requires the WQL_CLUSTER_SPEC "
            "topology (set by the router-tier supervisor)"
        )
    return json.loads(raw)


class ClusterShardExtension:
    #: re-exported for the transports (which check the fence payload
    #: prefix via this attribute, never importing the cluster package)
    FENCE_MAGIC = FENCE_MAGIC

    def __init__(self, server, spec: dict | None = None):
        self.server = server
        spec = spec if spec is not None else load_spec()
        self.shard_id = int(spec["shard_id"])
        self.n_shards = int(spec["n_shards"])
        # epoch-versioned placement (live resharding): converged from
        # router broadcasts + the epoch check on the ~1s state exchange
        self.placement = PlacementMap(self.n_shards)
        self.world_map = self.placement  # compatibility alias
        self.bus = InterShardBus(self.shard_id)
        rings = spec.get("rings") or {"out": {}, "in": {}}
        self.bus.attach(rings.get("out", {}), rings.get("in", {}))
        self._ctl_path = spec["ctl_path"]
        self._ctl: socket.socket | None = None
        #: uuid → home shard for every remote proxy this shard holds
        self._remote: dict[uuid_mod.UUID, int] = {}
        self._last_level_sent: int | None = None
        self._last_state_push = 0.0
        self.xshard_frames = 0
        #: drained-frame telemetry segments for trace stitching:
        #: (trace_id, t_router_ingress, t_enqueue, t_ring_write,
        #: t_read, t_done) — monotonic ns, zeros where unknown
        self._segments: deque = deque(maxlen=SEGMENT_DEPTH)
        self.slow_frame_ms = getattr(server.config, "slow_frame_ms", None)
        self.slow_frames_dumped = 0
        self.slow_frames_skipped = 0
        # live resharding (destination side): one capsule stream at a
        # time, resumable from chunk 0 after a restart re-stream
        self._import_xfer: int | None = None
        self._import_assembler = ChunkAssembler()
        #: completed imports: xfer → counts — a re-streamed capsule
        #: after a lost ack is RE-ACKED, never re-applied
        self._import_counts: dict[int, dict] = {}
        self._reshard_tasks: set = set()
        self.rerouted = 0

    # region: lifecycle

    async def start(self) -> None:
        """Connect the control channel and announce readiness — called
        at the END of server.start(), once the ZMQ listener is bound,
        so the router never forwards into an unbound socket."""
        ctl = socket.socket(socket.AF_UNIX, socket.SOCK_SEQPACKET)
        ctl.settimeout(10.0)
        ctl.connect(self._ctl_path)
        ctl.setblocking(False)
        self._ctl = ctl
        self._ctl_send({"op": "ready", "shard": self.shard_id})
        self.server.supervisor.spawn(
            "cluster-control", self._control_loop, critical=True
        )
        if self.server.ticker is None:
            # immediate-mode shard: no tick clock to ride — a
            # supervised pump drains the inbound rings instead
            self.server.supervisor.spawn("cluster-drain", self._drain_pump)
        logger.info(
            "cluster shard %d/%d attached (%d peer rings)",
            self.shard_id, self.n_shards, len(self.bus.peers()),
        )

    async def stop(self) -> None:
        for task in list(self._reshard_tasks):
            task.cancel()
        if self._ctl is not None:
            self._ctl.close()
            self._ctl = None
        self.bus.close()

    # endregion

    # region: remote peer proxies

    def _make_proxy(self, peer_uuid: uuid_mod.UUID, home: int) -> Peer:
        bus = self.bus
        metrics = self.server.metrics

        def try_write(framed, _u=peer_uuid, _h=home) -> bool:
            # fire-and-forget onto the home shard's ring; a full ring
            # drops (counted) — bounded degradation, never a stalled
            # tick. Returning True keeps deliver_batch off the awaited
            # slow path: there is nothing more awaiting could do. The
            # framed payload's trace context rides the frame header so
            # the REMOTE shard closes the router-ingress clock.
            if not bus.send_frame(_h, _u, framed.payload,
                                  time.monotonic_ns(), ctx=framed.ctx):
                metrics.inc("cluster.ring_full_drops")
            return True

        def try_write_many(framed_list, _u=peer_uuid, _h=home) -> bool:
            now = time.monotonic_ns()
            for framed in framed_list:
                if not bus.send_frame(_h, _u, framed.payload, now,
                                      ctx=framed.ctx):
                    metrics.inc("cluster.ring_full_drops")
            return True

        async def send_raw(data: bytes, _u=peer_uuid, _h=home) -> None:
            if not bus.send_frame(_h, _u, data, time.monotonic_ns()):
                metrics.inc("cluster.ring_full_drops")

        return Peer(
            uuid=peer_uuid,
            addr=f"shard-{home}",
            send_raw=send_raw,
            kind="cluster-remote",
            tracks_heartbeat=False,
            try_write=try_write,
            try_write_many=try_write_many,
        )

    def adopt_remote(self, peer_uuid: uuid_mod.UUID, home: int) -> None:
        """Router announced a peer homed on another shard: register the
        ring-backed proxy (silently — the home shard owns the lifecycle
        broadcasts). Re-adoption after a shard restart just replaces
        the proxy; a peer homed HERE is never proxied."""
        if home == self.shard_id:
            return
        existing = self.server.peer_map.get(peer_uuid)
        if existing is not None and existing.kind != "cluster-remote":
            # a real local binding outranks a proxy announcement
            return
        self.server.peer_map.rebind(self._make_proxy(peer_uuid, home))
        self._remote[peer_uuid] = home

    def drop_remote(self, peer_uuid: uuid_mod.UUID) -> None:
        if self._remote.pop(peer_uuid, None) is None:
            return
        existing = self.server.peer_map.get(peer_uuid)
        if existing is not None and existing.kind == "cluster-remote":
            self.server.peer_map.detach(peer_uuid)

    def on_peer_torn_down(self, peer_uuid: uuid_mod.UUID) -> None:
        """Server hook: a peer HOMED here fully tore down (session
        expiry, eviction, clean disconnect past the TTL) — tell the
        router so every other shard reaps its proxy."""
        if peer_uuid in self._remote or self._ctl is None:
            return
        self._ctl_send({"op": "peer_gone", "uuid": peer_uuid.hex})

    # endregion

    # region: trace context (the router-stamped frame clock)

    @staticmethod
    def unwrap(data: bytes) -> tuple[int, int, int, bytes]:
        """Strip the router's trace+epoch prefix (transport hook — the
        transports never import the cluster package directly). Returns
        ``(trace_id, t_ingress_ns, epoch, payload)``; v1/unprefixed
        frames decode as epoch 0, which is never stale."""
        return tracectx.unwrap_epoch(data)

    def close_frames(self, messages) -> None:
        """Close the router-ingress clock for locally-delivered frames
        — called by the ticker AFTER a tick's batched delivery
        completes (socket-write-complete, the conservative delivery-plane
        close). Messages without a context (entity frames, locally
        injected traffic) cost one attribute read each."""
        now_ns = time.monotonic_ns()
        metrics = self.server.metrics
        for message in messages:
            ctx = getattr(message, "trace_ctx", None)
            if ctx is not None and ctx[1]:
                metrics.observe_ms(
                    "cluster.e2e_ms", (now_ns - ctx[1]) / 1e6
                )

    # endregion

    # region: drain (the tick's cross-shard leg)

    async def drain(self) -> int:
        """Deliver everything queued on the inbound rings to LOCAL
        sockets. Called by the ticker between the local batch's device
        dispatch and collect (the ``cluster.drain`` span), or by the
        standalone pump on tickerless shards. Returns frames drained.

        Both cross-process clocks close HERE, after the delivery
        completes (socket-write-complete): ``cluster.xshard_ms`` from
        the home shard's enqueue stamp and ``cluster.e2e_ms`` from the
        router-ingress stamp in the frame's trace context. Per-frame
        segments feed the flight-recorder stitcher, and a frame whose
        e2e wall blows ``--slow-frame-ms`` dumps its stitched
        router→home→remote stage chain as one JSON line."""
        t0_ns = time.monotonic_ns()
        # chaos site: a delay stretches the remote leg (ring dwell) —
        # the slow-frame acceptance drives its dump deterministically
        await failpoints.afire("cluster.ring_deliver")
        records = self.bus.drain(DRAIN_MAX)
        if not records:
            return 0
        t_read_ns = time.monotonic_ns()
        metrics = self.server.metrics
        pairs = [
            (_BusFrame(data), (peer_uuid,))
            for peer_uuid, data, _te, _tw, _tid, _tc in records
        ]
        self.xshard_frames += len(records)
        metrics.inc("cluster.frames_drained", len(records))
        await self.server.peer_map.deliver_batch(pairs)
        t_done_ns = time.monotonic_ns()
        tracing = self.server.tracer.enabled
        slow_ms = self.slow_frame_ms
        dumps_left = SLOW_FRAME_DUMPS_PER_DRAIN
        for _peer, _data, t_enqueue, t_write, trace_id, t_ctx in records:
            if t_enqueue:
                metrics.observe_ms(
                    "cluster.xshard_ms", (t_done_ns - t_enqueue) / 1e6
                )
            if t_ctx:
                total_ms = (t_done_ns - t_ctx) / 1e6
                metrics.observe_ms("cluster.e2e_ms", total_ms)
                if slow_ms is not None and total_ms >= slow_ms:
                    if dumps_left > 0:
                        dumps_left -= 1
                        self._dump_slow_frame(
                            trace_id, t_ctx, t_enqueue, t_write,
                            t_read_ns, t_done_ns, total_ms,
                        )
                    else:
                        self.slow_frames_skipped += 1
            if tracing:
                self._segments.append((
                    trace_id, t_ctx, t_enqueue, t_write, t_read_ns,
                    t_done_ns,
                ))
        return len(records)

    async def _drain_pump(self) -> None:
        interval = max(self.server.config.tick_interval, 0.005)
        while True:
            await asyncio.sleep(interval)
            await self.drain()

    def _frame_stages(
        self, t_ctx: int, t_enqueue: int, t_write: int, t_read: int,
        t_done: int,
    ) -> dict[str, float]:
        """One cross-shard frame's wall, attributed to named stages:
        ``router.forward`` (router ingress → home-shard ring enqueue —
        the forward hop plus the home shard's decode/queue/resolve),
        ``cluster.ring_dwell`` (ring write → remote drain read) and
        ``cluster.deliver`` (drain read → socket-write-complete). The
        only unattributed sliver is the enqueue→ring-write gap, a few
        µs of struct packing — ≥90% attribution by construction."""
        stages = {}
        if t_ctx and t_enqueue:
            stages["router.forward"] = (t_enqueue - t_ctx) / 1e6
        if t_write:
            stages["cluster.ring_dwell"] = (t_read - t_write) / 1e6
        stages["cluster.deliver"] = (t_done - t_read) / 1e6
        return stages

    def _dump_slow_frame(
        self, trace_id: int, t_ctx: int, t_enqueue: int, t_write: int,
        t_read: int, t_done: int, total_ms: float,
    ) -> None:
        """The slow-tick auto-dump, per cross-shard frame: one
        JSON line with the stitched stage chain + a CRITICAL log."""
        self.slow_frames_dumped += 1
        metrics = self.server.metrics
        metrics.inc("cluster.slow_frame_dumps")
        stages = self._frame_stages(
            t_ctx, t_enqueue, t_write, t_read, t_done
        )
        record = {
            "dumped_at_unix_s": round(time.time(), 6),
            "slow_frame_ms_threshold": self.slow_frame_ms,
            "shard": self.shard_id,
            "trace_id": tracectx.trace_id_hex(trace_id),
            "total_ms": round(total_ms, 3),
            "stages": {k: round(v, 3) for k, v in stages.items()},
        }
        dump_dir = self.server.config.slow_tick_dir
        path = os.path.join(dump_dir, SLOW_FRAME_FILENAME)
        try:
            os.makedirs(dump_dir, exist_ok=True)
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(record) + "\n")
            where = path
        except Exception:
            logger.exception("slow-frame dump write failed")
            where = "<dump write failed>"
        attributed = sum(stages.values())
        logger.critical(
            "SLOW CLUSTER FRAME: %.1f ms (threshold %.1f ms) trace %s — "
            "stages %s attribute %.1f ms (%.0f%%); dumped to %s",
            total_ms, self.slow_frame_ms, record["trace_id"],
            {k: round(v, 1) for k, v in sorted(stages.items())},
            attributed,
            100.0 * attributed / total_ms if total_ms else 0.0,
            where,
        )

    # endregion

    # region: trace stitching (flight-recorder export hook)

    def chain_stitcher(self, prev):
        """Compose this extension's stitcher with whatever the
        recorder already has (the delivery plane claims the slot when
        ``--delivery-workers`` > 0)."""
        if prev is None:
            return self.stitch

        def chained(trace):
            out = list(prev(trace) or [])
            out.extend(self.stitch(trace) or [])
            return out

        return chained

    def stitch(self, trace) -> list[dict]:
        """Graft ``router.forward`` + ``cluster.ring_dwell`` spans for
        every drained frame whose read stamp falls inside this tick's
        ``cluster.drain`` window — the cross-shard legs of the frame,
        reconstructed from the trace-context and ring stamps (all
        CLOCK_MONOTONIC on one host, the delivery-plane stitching precedent).
        Bounded per trace; a miss degrades to local spans only."""
        with trace._lock:
            drains = [s for s in trace.spans if s.name == "cluster.drain"]
        if not drains or not self._segments:
            return []
        out: list[dict] = []
        base = trace.perf_start
        for ds in drains:
            w0 = ds.t0 - 1e-4
            w1 = ds.t0 + ds.dur_ms / 1e3 + 1e-4
            for (trace_id, t_ctx, t_enqueue, t_write, t_read,
                 t_done) in self._segments:
                t_read_s = t_read / 1e9
                if not (w0 <= t_read_s <= w1):
                    continue
                tid_hex = tracectx.trace_id_hex(trace_id)
                if t_ctx and t_enqueue:
                    out.append({
                        # negative ids offset past the delivery plane's
                        # synthetic range: stitched spans never collide
                        # with the trace's own positive ids
                        "id": -(1000 + len(out) + 1),
                        "parent": ds.id,
                        "name": "router.forward",
                        "t0_ms": round((t_ctx / 1e9 - base) * 1e3, 3),
                        "dur_ms": round((t_enqueue - t_ctx) / 1e6, 3),
                        "tags": {"trace_id": tid_hex},
                        "thread": "cluster",
                    })
                if t_write:
                    out.append({
                        "id": -(1000 + len(out) + 1),
                        "parent": ds.id,
                        "name": "cluster.ring_dwell",
                        "t0_ms": round((t_write / 1e9 - base) * 1e3, 3),
                        "dur_ms": round((t_read - t_write) / 1e6, 3),
                        "tags": {
                            "trace_id": tid_hex,
                            "deliver_ms": round((t_done - t_read) / 1e6, 3),
                        },
                        "thread": "cluster",
                    })
                if len(out) >= 64:
                    return out
        return out

    # endregion

    # region: live resharding (the shard half of the protocol)

    def frame_stale(self, epoch: int) -> bool:
        """True when the frame was stamped under an OLDER placement
        than this shard holds: the transport diverts it off the fast
        path into the full decode + ownership check — a stale entity
        frame must never touch the SoA columns directly. Epoch 0
        (pre-resharding router, replayed WAL, direct client) is never
        stale."""
        return epoch != 0 and epoch < self.placement.epoch

    def frame_misrouted(self, message, epoch: int) -> bool:
        """Post-decode ownership check for a stale-epoch frame: a frame
        for a world (or peer) this shard no longer owns under the
        CURRENT placement bounces back to the router over control as a
        re-route hint — applied here it would mutate state the
        placement already moved away. True = bounced, caller drops."""
        if message.instruction in (
            Instruction.HANDSHAKE, Instruction.HEARTBEAT
        ):
            if message.sender_uuid is None:
                return False
            owner = self.placement.shard_of_peer(message.sender_uuid)
        else:
            owner = self.placement.shard_of_world(message.world_name)
        if owner == self.shard_id:
            return False  # stale stamp, still the right owner: process
        wire = message.wire
        if wire is None:
            return False
        import base64

        self.rerouted += 1
        self.server.metrics.inc("cluster.shard_rerouted")
        self._spawn_reshard(self._ctl_send_retry({
            "op": "reroute",
            "data": base64.b64encode(wire).decode(),
        }, deadline_s=2.0))
        return True

    def on_fence(self, payload: bytes) -> None:
        """A freeze fence arrived on the DATA path: the PULL socket is
        FIFO and processing is in-order, so every frame the router
        forwarded before the fence has already been handled — the
        control ack is the drain proof the migration coordinator waits
        on before exporting."""
        xfer = parse_fence(payload)
        if xfer is None:
            return
        self.server.metrics.inc("cluster.fence_seen")
        self._spawn_reshard(self._ack_fence(xfer))

    async def _ack_fence(self, xfer: int) -> None:
        """Handled is not yet delivered: a LocalMessage of the frozen
        world may still wait in the ticker's queue, and once the world
        is tombstoned here it would reach no one. Flush the ticker
        (resolve and deliver what is queued, with no sim tick) before
        the ack."""
        ticker = getattr(self.server, "ticker", None)
        if ticker is not None:
            await ticker.flush(sim=False)
        await self._ctl_send_retry({"op": "fence_ack", "xfer": xfer})

    def _spawn_reshard(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)  # wql: allow(unsupervised-task) — one-shot, retained below, cancelled in stop()
        self._reshard_tasks.add(task)
        task.add_done_callback(self._reshard_tasks.discard)

    async def _ctl_send_retry(self, packet: dict,
                              deadline_s: float = 5.0) -> bool:
        """The dump-chunk deadline-retry idiom for migration control
        packets: a momentarily full control socket retries briefly
        instead of silently dropping a protocol step (the coordinator's
        timeouts catch a genuinely dead channel)."""
        deadline = time.monotonic() + deadline_s
        while not self._ctl_send(packet):
            if time.monotonic() >= deadline:
                return False
            await asyncio.sleep(0.01)
        return True

    async def _do_export(self, xfer: int, world: str) -> None:
        """Source side, STREAMING: capture the capsule (behind a
        durability drain) and chunk it to the router CRC-framed."""
        try:
            payload = await export_world(self.server, world)
        except Exception:
            logger.exception(
                "reshard %d: export of %r failed", xfer, world
            )
            return
        for chunk in encode_chunks(payload):
            if not await self._ctl_send_retry({
                "op": "reshard_chunk", "xfer": xfer, "chunk": chunk,
            }):
                logger.warning(
                    "reshard %d: capsule chunk send timed out", xfer
                )
                return

    def _on_import_chunk(self, msg: dict) -> None:
        """Destination side: feed one retained chunk. A transfer id
        change (new migration, or the router re-streaming from zero
        after this shard restarted) resets assembly; corruption resets
        and waits — the coordinator's CRC check aborts its side."""
        try:
            xfer = int(msg["xfer"])
            chunk = msg["chunk"]
        except (KeyError, TypeError, ValueError):
            return
        if xfer != self._import_xfer:
            self._import_xfer = xfer
            self._import_assembler.reset()
        doc = self._import_assembler.feed(chunk)
        if self._import_assembler.corrupt:
            logger.warning(
                "reshard %d: corrupt capsule chunk — assembly reset, "
                "awaiting re-stream", xfer,
            )
            self._import_assembler.reset()
            return
        if doc is not None:
            self._spawn_reshard(self._do_import(xfer, doc))

    async def _do_import(self, xfer: int, doc: dict) -> None:
        """Apply the capsule THROUGH the durability pipeline (+ drain
        barrier), then ack with the counts: from the ack on, this shard
        can recover the world from its OWN WAL. Idempotent: a re-stream
        after a lost ack re-acks the cached counts."""
        if xfer not in self._import_counts:
            try:
                counts = await import_world(self.server, doc)
            except Exception:
                logger.exception("reshard %d: capsule import failed", xfer)
                return
            self._import_counts[xfer] = counts
            while len(self._import_counts) > 8:
                self._import_counts.pop(next(iter(self._import_counts)))
        await self._ctl_send_retry({
            "op": "reshard_imported", "xfer": xfer,
            "counts": self._import_counts[xfer],
        })

    async def _do_tombstone(self, xfer: int, world: str) -> None:
        """Source side, AFTER the destination's ack is durable: delete
        the moved world through this shard's own WAL. Idempotent — the
        router re-issues on every ready until the ack lands."""
        try:
            counts = await tombstone_world(self.server, world)
        except Exception:
            logger.exception(
                "reshard %d: tombstone of %r failed", xfer, world
            )
            return
        await self._ctl_send_retry({
            "op": "reshard_tombstoned", "xfer": xfer, "counts": counts,
        })

    def _on_reshard_abort(self, msg: dict) -> None:
        """The coordinator aborted: ownership stays with the source.
        Drop any partial assembly and scrub whatever this shard already
        applied (tombstone_world is idempotent; a no-op for nothing)."""
        try:
            xfer = int(msg["xfer"])
        except (KeyError, TypeError, ValueError):
            return
        if xfer == self._import_xfer:
            self._import_xfer = None
            self._import_assembler.reset()
        world = msg.get("world")
        if isinstance(world, str) and world:
            self._import_counts.pop(xfer, None)
            self._spawn_reshard(self._scrub_aborted(xfer, world))

    async def _scrub_aborted(self, xfer: int, world: str) -> None:
        try:
            counts = await tombstone_world(self.server, world)
            logger.warning(
                "reshard %d aborted: scrubbed partial import of %r: %s",
                xfer, world, counts,
            )
        except Exception:
            logger.exception("reshard %d: abort scrub failed", xfer)

    # endregion

    # region: control channel

    def _ctl_send(self, msg: dict) -> bool:
        if self._ctl is None:
            return False
        try:
            self._ctl.send(json.dumps(msg).encode())
            return True
        except (BlockingIOError, InterruptedError):
            return False  # control is best-effort; state re-pushes
        except OSError:
            return False

    def _state_packet(self) -> dict:
        gov = self.server.governor
        metrics = self.server.metrics
        counters = metrics.snapshot()["counters"]
        packet = {
            "op": "state",
            "shard": self.shard_id,
            "level": 0,
            "state": "ok",
            "peers": self.server.peer_map.size(),
            # the router re-pushes the placement spec when this lags
            # its epoch — restart convergence with no coordinator
            "placement_epoch": self.placement.epoch,
            "bus": self.bus.stats(),
            "counters": {
                k: v for k, v in counters.items()
                if k.startswith(("messages.", "overload.", "tick.",
                                 "cluster.", "broadcast."))
            },
            # cumulative histogram snapshots for the router's metrics
            # federation — diffed packet-to-packet into merge_histogram
            # deltas there, so the federated series stay monotone
            # across shard restarts (a fresh shard re-baselines)
            "hist": metrics.export_histograms(FED_HIST_PREFIXES),
        }
        if gov is not None:
            packet.update(gov.export_state())
            packet["op"] = "state"  # export_state must not shadow it
        if self.server.slo is not None:
            # local compliance piggybacks the ~1s state clock — the
            # router's fleet SLO report names the burning process
            packet["slo"] = self.server.slo.compliance()
        return packet

    def _maybe_push_state(self) -> None:
        gov = self.server.governor
        level = gov.level if gov is not None else 0
        now = time.monotonic()
        if (
            level == self._last_level_sent
            and now - self._last_state_push < STATE_INTERVAL_S
        ):
            return
        try:
            # chaos site: an armed error silences this shard's
            # telemetry exports while the process stays alive — the
            # router's telemetry_stale freshness probe must see it
            failpoints.fire("cluster.state_push")
        except failpoints.FailpointError:
            return
        if self._ctl_send(self._state_packet()):
            self._last_level_sent = level
            self._last_state_push = now

    async def _control_loop(self) -> None:
        """Supervised: inbound adopt/drop + the state export clock.
        Control EOF == the router (and its supervisor) is gone — a
        shard nobody can reach must hand control back cleanly."""
        loop = asyncio.get_running_loop()
        # One receive stays pending across poll timeouts. Cancelling it
        # on every timeout (``wait_for``) loses a datagram whenever it
        # arrives in the loop iteration the timer fires in — certain
        # after a tick that held the loop past STATE_POLL_S.
        recv = None
        try:
            while True:
                if recv is None:
                    recv = asyncio.ensure_future(  # wql: allow(unsupervised-task) — awaited below, cancelled on exit
                        loop.sock_recv(self._ctl, 65536)
                    )
                done, _ = await asyncio.wait({recv}, timeout=STATE_POLL_S)
                try:
                    if done:
                        data, recv = recv.result(), None
                        if not data:
                            raise ConnectionResetError("router control EOF")
                        await self._handle_control(data)
                except (ConnectionResetError, BrokenPipeError, OSError):
                    logger.critical(
                        "cluster control channel lost — router is gone; "
                        "requesting clean shard shutdown"
                    )
                    self.server.shutdown_requested.set()
                    return
                self._maybe_push_state()
        finally:
            if recv is not None:
                recv.cancel()

    async def _handle_control(self, data: bytes) -> None:
        try:
            msg = json.loads(data)
        except ValueError:
            return
        op = msg.get("op")
        if op == "adopt":
            self.adopt_remote(
                uuid_mod.UUID(hex=msg["uuid"]), int(msg["home"])
            )
        elif op == "drop":
            self.drop_remote(uuid_mod.UUID(hex=msg["uuid"]))
        elif op == "dump":
            # router-side GET /debug/cluster: chunk this shard's
            # flight-recorder snapshot back over the control channel
            await self._send_dump(int(msg.get("req_id", 0)))
        elif op == "placement":
            spec = msg.get("spec")
            if isinstance(spec, dict) and self.placement.apply_spec(spec):
                self.server.metrics.inc("cluster.placement_applied")
        elif op == "reshard_export":
            self._spawn_reshard(self._do_export(
                int(msg.get("xfer", 0)), str(msg.get("world", ""))
            ))
        elif op == "reshard_import_chunk":
            self._on_import_chunk(msg)
        elif op == "reshard_tombstone":
            self._spawn_reshard(self._do_tombstone(
                int(msg.get("xfer", 0)), str(msg.get("world", ""))
            ))
        elif op == "reshard_abort":
            self._on_reshard_abort(msg)
        elif op == "inject":
            # router-side HTTP /global_message: a trusted in-process
            # injection stretched across the process boundary — the
            # public PULL would (rightly) drop its nil sender
            import base64

            from ..protocol import deserialize_message

            try:
                message = deserialize_message(
                    base64.b64decode(msg["data"])
                )
            except Exception:
                logger.warning("undecodable control injection dropped")
                return
            await self.server.router.handle_message(message)

    async def _send_dump(self, req_id: int) -> None:
        """Chunk the flight-recorder snapshot + this process's
        subsystem sections to the router (the control channel's 64 KiB
        datagrams can't carry a whole Chrome-trace worth of spans in
        one packet). The SAME dump serves ``GET /debug/cluster`` (which
        reads ticks/loose) and the router's incident capture (which
        additionally embeds the sections), so the capsule can never see
        a different shard state than the debug endpoint. Tracing off
        sends an empty-but-well-formed dump so the router never times
        out on a healthy shard."""
        from ..observability.incidents import capsule_sections

        recorder = getattr(self.server, "recorder", None)
        payload = {
            "shard": self.shard_id,
            "pid": os.getpid(),
            "ticks": recorder.snapshot() if recorder is not None else [],
            "loose": (
                recorder.loose_snapshot() if recorder is not None else []
            ),
            "sections": capsule_sections(self.server),
        }
        try:
            blob = json.dumps(payload)
        except (TypeError, ValueError):
            logger.exception("flight-recorder dump not serializable")
            blob = json.dumps({
                "shard": self.shard_id, "pid": os.getpid(),
                "ticks": [], "loose": [],
            })
        chunks = [
            blob[i:i + DUMP_CHUNK_CHARS]
            for i in range(0, len(blob), DUMP_CHUNK_CHARS)
        ] or [""]
        for seq, chunk in enumerate(chunks):
            packet = {
                "op": "dump_chunk", "req_id": req_id, "seq": seq,
                "n": len(chunks), "data": chunk,
            }
            deadline = time.monotonic() + 2.0
            while not self._ctl_send(packet):
                if time.monotonic() >= deadline:
                    logger.warning(
                        "dump chunk %d/%d to router timed out",
                        seq + 1, len(chunks),
                    )
                    return
                await asyncio.sleep(0.01)

    # endregion

    def stats(self) -> dict:
        return {
            "shard_id": self.shard_id,
            "n_shards": self.n_shards,
            "remote_peers": len(self._remote),
            "placement_epoch": self.placement.epoch,
            "rerouted": self.rerouted,
            "xshard_frames": self.xshard_frames,
            "slow_frames_dumped": self.slow_frames_dumped,
            "slow_frames_skipped": self.slow_frames_skipped,
            **self.bus.stats(),
        }
