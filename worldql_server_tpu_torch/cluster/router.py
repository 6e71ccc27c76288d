"""Router tier: the cluster's client-facing front door.

One thin process owns the PUBLIC ZMQ listener and forwards every
inbound message to the shard that owns it — world-scoped instructions
(subscriptions, Local/GlobalMessages, record ops) to
``WorldMap.shard_of_world``, peer-scoped instructions (handshakes,
heartbeats) to ``WorldMap.shard_of_peer`` — as the ORIGINAL wire
bytes (``Message.wire``): the router decodes for routing, never
re-encodes. Return traffic never touches the router at all: each
shard's connect-back PUSH goes straight to the client (the reference's
asymmetric ZMQ pattern scales to N servers for free), and cross-shard
fan-out rides the inter-shard rings.

The router is also where overload becomes a CLUSTER property. Every
shard exports its governor level over the control channel (shard.py
``state`` packets) into the :class:`ShedMirror`; a message bound for a
shard in REJECT is shed AT THE ROUTER — same admission classes as the
shard's own governor (records/entity/control never shed; locals and
globals shed in REJECT; new handshakes shed at SHED_HIGH+ with a
budgeted jittered retry-after hint, resumes ride through below
REJECT) — so a drowning shard's refusals cost one decode here instead
of a socket write, a queue slot and a decode there. Every router-side
shed is counted per class (``cluster.router_shed_*``): offered ==
forwarded + shed-at-router, and forwarded == admitted + shed-at-shard,
the exact-accounting invariant bench config 11 gates.

The router is also the cluster's observability front door:
every forward is stamped with a trace context (``tracectx.py`` —
64-bit trace id + router-ingress monotonic-ns clock the shards close
at socket-write-complete), shard telemetry folds restart-monotone into
ONE federated ``/metrics`` (``federation.py``: per-shard
``cluster.shard.<i>.*`` series + cluster aggregates + the live
``deliveries_per_s_per_core`` gauge), ``/healthz`` carries per-shard
telemetry freshness, and ``GET /debug/cluster`` splices every
process's flight-recorder snapshot into one Chrome trace with named
pid lanes.

``ClusterRuntime`` composes the router with the shard-process
supervisor — ``python -m worldql_server_tpu_torch --cluster-shards N`` boots
it; scenarios, bench config 11 and the e2e suite embed it.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
import uuid as uuid_mod

import zmq
import zmq.asyncio

from ..engine.metrics import Metrics
from ..observability import FlightRecorder, Tracer
from ..protocol import (
    DeserializeError,
    Instruction,
    Message,
    deserialize_message,
    serialize_message,
)
from ..utils.names import GLOBAL_WORLD  # noqa: F401  (routing contract doc)
from . import tracectx
from .dump_client import ChunkedDumpClient
from .federation import MetricsFederation
from .resharding import (
    AutoshardController,
    MigrationCoordinator,
    PlacementMap,
    fence_payload,
)
from .supervisor import ClusterSupervisor, shard_zmq_port

logger = logging.getLogger(__name__)

#: governor levels mirrored from shard state packets
_SHED_HIGH = 2
_REJECT = 3

#: instructions routed by WORLD (owner shard) vs by SENDER (home shard)
_WORLD_ROUTED = frozenset((
    Instruction.AREA_SUBSCRIBE, Instruction.AREA_UNSUBSCRIBE,
    Instruction.LOCAL_MESSAGE, Instruction.GLOBAL_MESSAGE,
    Instruction.RECORD_CREATE, Instruction.RECORD_READ,
    Instruction.RECORD_UPDATE, Instruction.RECORD_DELETE,
))


def _connect_host(bind_host: str) -> str:
    return "127.0.0.1" if bind_host in ("0.0.0.0", "::", "*", "") else bind_host


class ShedMirror:
    """Router-side view of every shard's governor level, fed by the
    control channel. Stale state degrades to level 0 on a shard
    restart (the fresh shard re-reports within its first state tick)."""

    def __init__(self, n_shards: int):
        self.levels = [0] * n_shards

    def note_state(self, shard: int, msg: dict) -> None:
        self.levels[shard] = int(msg.get("level", 0))

    def reset(self, shard: int) -> None:
        self.levels[shard] = 0

    def level(self, shard: int) -> int:
        return self.levels[shard]


class ClusterRouter:
    """The forwarding loop + shed mirror + admin surface. Owns no
    world state — restartable at any time without data loss."""

    def __init__(self, config, supervisor: ClusterSupervisor,
                 metrics: Metrics | None = None):
        self.config = config
        self.supervisor = supervisor
        self.n_shards = supervisor.n_shards
        # the epoch-versioned placement document (live resharding):
        # at epoch 0 with no overrides it IS the stable WorldMap hash
        self.world_map = PlacementMap(self.n_shards)
        self.metrics = metrics if metrics is not None else Metrics()
        self.mirror = ShedMirror(self.n_shards)
        self.ctx = zmq.asyncio.Context()
        self._pull: zmq.asyncio.Socket | None = None
        self._push: list[zmq.asyncio.Socket] = []
        self._recv_task: asyncio.Task | None = None
        self._http_runner = None
        #: uuid → home shard for every handshaked peer (adoption replay
        #: state for shard restarts; reaped on peer_gone notices)
        self._peers: dict[uuid_mod.UUID, int] = {}
        self._hint_bucket = [50.0, time.monotonic()]
        self._jitter = random.Random()
        self.forwarded = 0
        self._refusals: set[asyncio.Task] = set()
        # Cluster observability: trace ids minted per
        # inbound message ride every forward as a framed prefix; with
        # tracing on the forwards also record router.forward spans
        # into this process's own flight recorder (loose ring — the
        # router has no tick clock), served at /debug/cluster.
        self._trace_rng = random.Random()
        self.tracer = Tracer(enabled=config.trace_enabled)
        self.recorder = None
        if config.trace_enabled:
            self.recorder = FlightRecorder(
                depth=config.flight_recorder_depth,
                metrics=self.metrics,
            )
            self.tracer.on_trace = self.recorder.record
        # metrics federation: shard state packets fold into THIS
        # registry (aggregates + cluster.shard.<i>.* series), so the
        # router's /metrics is the one scrape for the whole fleet
        self.federation = MetricsFederation(self.metrics, self.n_shards)
        # ONE chunked-dump pull path for /debug/cluster AND incident
        # capture — shared slots, reassembly and timeout-degrade
        # semantics, so a capsule can't drift from the debug endpoint
        self.dumps = ChunkedDumpClient(supervisor)
        # Live resharding: at most one migration in flight;
        # its coordinator intercepts the moving world's traffic into a
        # bounded transfer buffer until the epoch flips.
        self.migration: MigrationCoordinator | None = None
        self._migration_task: asyncio.Task | None = None
        self._xfer_seq = 0
        self.resharded = 0
        #: tombstones owed to a shard that was down when its migration
        #: completed: shard → {xfer: world}, re-issued on every ready
        self._pending_tombstones: dict[int, dict[int, str]] = {}
        #: decayed per-world forward counts — the autoshard
        #: controller's hottest-world signal
        self._world_load: dict[str, float] = {}
        self.autoshard = AutoshardController(self)
        self._autoshard_task: asyncio.Task | None = None
        self.metrics.gauge("cluster", self.status)
        self.metrics.gauge("cluster_federation", self.federation.stats)
        self.metrics.gauge(
            "deliveries_per_s_per_core",
            self.federation.deliveries_per_s_per_core,
        )
        # Fleet SLO state: the router's engine judges THIS registry —
        # federation already folds every shard's series in — and the
        # shards additionally piggyback their local compliance on the
        # ~1s state packets (note_remote below). Incidents captured
        # here pull every process's sections over the shared dump
        # client, so one capsule holds the whole fleet's causal state.
        self.slo = None
        self.incidents = None
        self._slo_task: asyncio.Task | None = None
        if config.slo_enabled:
            from ..observability.slo import SloEngine, load_objectives

            interval, objectives = load_objectives(config.slo_file)
            self.slo = SloEngine(
                self.metrics, objectives, eval_interval_s=interval
            )
            self.metrics.gauge("slo", self.slo.gauge)
            if config.incident_dir is not None:
                from ..observability.incidents import IncidentRecorder

                self.incidents = IncidentRecorder(
                    config.incident_dir,
                    cooldown_s=config.incident_cooldown,
                    keep=config.incident_keep,
                    metrics=self.metrics,
                )
                self.incidents.collect = self._collect_incident_body
                self.slo.on_burning = self._on_slo_burning
                self.metrics.gauge("incidents", self.incidents.stats)

    # region: lifecycle

    async def start(self) -> None:
        config = self.config
        self._pull = self.ctx.socket(zmq.PULL)
        self._pull.setsockopt(zmq.MAXMSGSIZE, config.max_message_size)
        self._pull.bind(
            f"tcp://{config.zmq_server_host}:{config.zmq_server_port}"
        )
        host = _connect_host(config.zmq_server_host)
        for i in range(self.n_shards):
            push = self.ctx.socket(zmq.PUSH)
            push.setsockopt(zmq.LINGER, 0)
            # deep enough to ride out a shard restart window at storm
            # rates; past it the router degrades to counted drops
            # rather than a wedged recv loop
            push.setsockopt(zmq.SNDHWM, 100_000)
            push.connect(f"tcp://{host}:{shard_zmq_port(config, i)}")
            self._push.append(push)
        self._recv_task = asyncio.create_task(  # wql: allow(unsupervised-task) — the runtime's run loop awaits/aborts on this task
            self._recv_loop(), name="cluster-router-recv"
        )
        if config.http_enabled:
            await self._start_http()
        if getattr(config, "cluster_autoshard", "off") == "on":
            self._autoshard_task = asyncio.create_task(  # wql: allow(unsupervised-task) — poll loop contains its own errors; cancelled in stop()
                self.autoshard.run(), name="cluster-autoshard"
            )
        if self.slo is not None:
            self._slo_task = asyncio.create_task(  # wql: allow(unsupervised-task) — eval loop contains its own errors; cancelled in stop()
                self.slo.run(), name="cluster-slo-eval"
            )
        logger.info(
            "cluster router listening on %s:%s, %d shards behind it",
            config.zmq_server_host, config.zmq_server_port, self.n_shards,
        )

    async def stop(self) -> None:
        for task in (
            self._slo_task, self._autoshard_task, self._migration_task
        ):
            if task is not None:
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):
                    pass
        self._slo_task = self._autoshard_task = self._migration_task = None
        if self.incidents is not None:
            # after slo-eval stops (no new triggers) — let any
            # in-flight fleet capsule finish before the sockets close
            await self.incidents.drain()
        if self._recv_task is not None:
            self._recv_task.cancel()
            try:
                await self._recv_task
            except (asyncio.CancelledError, Exception):
                pass
            self._recv_task = None
        for task in list(self._refusals):
            task.cancel()
        if self._http_runner is not None:
            await self._http_runner.cleanup()
            self._http_runner = None
        for push in self._push:
            push.close(linger=0)
        self._push.clear()
        if self._pull is not None:
            self._pull.close(linger=0)
            self._pull = None
        self.ctx.term()

    # endregion

    # region: control-plane hooks (wired by ClusterRuntime)

    def on_shard_message(self, shard: int, msg: dict) -> None:
        op = msg.get("op")
        if op == "state":
            self.mirror.note_state(shard, msg)
            self.federation.ingest(shard, msg)
            if self.slo is not None:
                # shard-local compliance piggybacks the state packet —
                # the fleet report shows WHICH process burns, not just
                # that the aggregate does
                self.slo.note_remote(shard, msg.get("slo"))
            # placement convergence via the ~1s state packets: a shard
            # reporting an older epoch (missed a flip broadcast, or
            # restarted) gets the current document re-pushed — every
            # process converges with no external coordinator
            try:
                reported = int(msg.get("placement_epoch", 0))
            except (TypeError, ValueError):
                reported = 0
            if reported < self.world_map.epoch:
                self.supervisor.ctl_send(shard, {
                    "op": "placement", "spec": self.world_map.to_spec(),
                })
        elif op == "dump_chunk":
            self.dumps.note_chunk(msg)
        elif op == "reroute":
            self._note_reroute(shard, msg)
        elif op == "fence_ack":
            if self.migration is not None:
                self.migration.on_fence_ack(shard, msg)
        elif op == "reshard_chunk":
            if self.migration is not None:
                self.migration.on_chunk(shard, msg)
        elif op == "reshard_imported":
            if self.migration is not None:
                self.migration.on_import_ack(shard, msg)
        elif op == "reshard_tombstoned":
            try:
                xfer = int(msg.get("xfer", -1))
            except (TypeError, ValueError):
                xfer = -1
            self._pending_tombstones.get(shard, {}).pop(xfer, None)
            if self.migration is not None:
                self.migration.on_tombstone_ack(shard, msg)
        elif op == "peer_gone":
            try:
                peer = uuid_mod.UUID(hex=msg["uuid"])
            except (KeyError, ValueError):
                return
            self.world_map.clear_peer(peer)
            if self._peers.pop(peer, None) is not None:
                for i in range(self.n_shards):
                    if i != shard:
                        self.supervisor.ctl_send(
                            i, {"op": "drop", "uuid": peer.hex}
                        )

    def on_shard_ready(self, shard: int) -> None:
        """(Re)boot adoption replay: the fresh shard learns every
        living peer homed elsewhere, so its fan-out reaches the whole
        cluster from its first tick."""
        self.mirror.reset(shard)
        # restart-monotone federation: the fresh shard's cumulatives
        # re-baseline from zero, so merged series only ever grow
        self.federation.reset(shard)
        if self.slo is not None:
            # stale pre-restart compliance must not hold the fleet
            # report degraded — the fresh shard re-reports within ~1s
            self.slo.drop_remote(shard)
        self.federation.note_pid(shard, self.supervisor.shard_pid(shard))
        # placement replay: a restarted shard boots at epoch 0 — it
        # must learn every override BEFORE serving, or it would apply
        # frames for worlds it no longer owns
        if self.world_map.epoch > 0:
            self.supervisor.ctl_send(shard, {
                "op": "placement", "spec": self.world_map.to_spec(),
            })
        # a source shard that died before acking its tombstone comes
        # back holding a WAL copy of a world it no longer owns: the
        # re-issued tombstone deletes it through that same WAL
        for xfer, world in list(
            self._pending_tombstones.get(shard, {}).items()
        ):
            self.supervisor.ctl_send(shard, {
                "op": "reshard_tombstone", "xfer": xfer, "world": world,
            })
        if self.migration is not None:
            self.migration.on_shard_ready(shard)
        for peer, home in self._peers.items():
            if home != shard:
                self.supervisor.ctl_send(
                    shard, {"op": "adopt", "uuid": peer.hex, "home": home}
                )

    def on_shard_down(self, shard: int) -> None:
        """A dead shard's homed peers lost their sockets with it:
        drop their proxies cluster-wide and forget them — the clients
        reconnect through the router and re-adopt."""
        self.mirror.reset(shard)
        if self.migration is not None:
            self.migration.on_shard_down(shard)
        gone = [u for u, h in self._peers.items() if h == shard]
        for peer in gone:
            del self._peers[peer]
            for i in range(self.n_shards):
                if i != shard:
                    self.supervisor.ctl_send(
                        i, {"op": "drop", "uuid": peer.hex}
                    )
        if gone:
            logger.warning(
                "shard %d down: forgot %d homed peers (clients must "
                "re-handshake)", shard, len(gone),
            )

    # endregion

    # region: forwarding

    async def _recv_loop(self) -> None:
        assert self._pull is not None
        limit = self.config.max_message_size
        while True:
            parts = await self._pull.recv_multipart()
            try:
                if sum(len(p) for p in parts) > limit:
                    self.metrics.inc("cluster.router_oversized")
                    continue
                data = parts[0] if len(parts) == 1 else b"".join(parts)
                self._route(data)
            except Exception:
                self.metrics.inc("cluster.router_recv_errors")
                logger.exception(
                    "error routing inbound message — dropped"
                )

    def _route(self, data: bytes) -> None:
        # the frame clock opens at ROUTER ingress — every shard-side
        # close (home delivery, remote ring drain) measures the same
        # router-ingress→socket-write window, cluster.e2e_ms
        t_ingress_ns = time.monotonic_ns()
        try:
            message = deserialize_message(data)
        except DeserializeError:
            self.metrics.inc("cluster.router_decode_errors")
            return
        instruction = message.instruction
        if instruction in _WORLD_ROUTED:
            shard = self.world_map.shard_of_world(message.world_name)
            self._world_load[message.world_name] = (
                self._world_load.get(message.world_name, 0.0) + 1.0
            )
        elif instruction in (Instruction.HANDSHAKE, Instruction.HEARTBEAT):
            shard = self.world_map.shard_of_peer(message.sender_uuid)
        else:
            # client-bound / unknown instructions die here — the shard
            # would only log-and-drop them anyway
            self.metrics.inc("cluster.router_dropped_unroutable")
            return
        # Live resharding interception: a migrating world's traffic
        # (and its migrated parked peers' resume handshakes) parks in
        # the bounded transfer buffer for post-flip replay in arrival
        # order — overflow is shed AND counted, never silently lost.
        mig = self.migration
        if mig is not None and mig.should_park(
            instruction, message.world_name, message.sender_uuid
        ):
            if mig.buffer.park(data):
                self.metrics.inc("cluster.reshard_parked")
            else:
                self.metrics.inc("cluster.reshard_buffer_shed")
            return
        if not self._admit(message, instruction, shard):
            return
        if instruction == Instruction.HANDSHAKE:
            self._note_handshake(message.sender_uuid, shard)
        ctx = (
            tracectx.new_trace_id(self._trace_rng), t_ingress_ns,
            self.world_map.epoch,
        )
        payload = message.wire if message.wire is not None else data
        if self.tracer.enabled:
            with self.tracer.span(
                "router.forward",
                trace_id=tracectx.trace_id_hex(ctx[0]),
                shard=shard,
                instruction=instruction.name,
            ):
                self._forward(shard, payload, ctx)
        else:
            self._forward(shard, payload, ctx)

    def _admit(self, message: Message, instruction, shard: int) -> bool:
        """The shed mirror: REJECT a drowning shard's sheddable load at
        the router, before the shard pays a socket read for it. Same
        class semantics as OverloadGovernor.admit — records, entity
        updates, subscriptions and heartbeats always pass."""
        level = self.mirror.level(shard)
        if level < _SHED_HIGH:
            return True
        if instruction == Instruction.HANDSHAKE:
            resume = message.flex is not None
            if resume and level < _REJECT:
                return True
            if resume:
                return True  # REJECT resumes: the shard's token bucket decides
            self.metrics.inc("cluster.router_shed_handshake_new")
            self._send_refusal(message)
            return False
        if level < _REJECT:
            return True
        if instruction == Instruction.LOCAL_MESSAGE:
            if message.entities:
                return True  # entity updates coalesce at the shard, never shed
            self.metrics.inc("cluster.router_shed_local")
            return False
        if instruction == Instruction.GLOBAL_MESSAGE:
            if message.entities:
                return True
            self.metrics.inc("cluster.router_shed_global")
            return False
        return True

    def _forward(self, shard: int, data: bytes, ctx: tuple) -> None:
        """Non-blocking forward, trace context + placement epoch
        framed on (``ctx`` is ``(trace_id, t_ingress_ns, epoch)`` —
        the ``untraced-forward`` and ``epochless-forward`` lint rules
        keep every forwarding site threading both). A full push queue
        (shard mid-restart past the 100K backlog) drops + counts —
        the router's recv loop must never wedge on one dead shard
        while the others serve."""
        try:
            self._push[shard].send(
                tracectx.wrap_epoch(data, ctx[0], ctx[1], ctx[2]),
                flags=zmq.NOBLOCK,
            )
            self.forwarded += 1
            self.metrics.inc("cluster.router_forwarded")
        except zmq.Again:
            self.metrics.inc("cluster.router_queue_drops")

    def _note_handshake(self, peer: uuid_mod.UUID, home: int) -> None:
        known = self._peers.get(peer)
        self._peers[peer] = home
        if known == home:
            return
        for i in range(self.n_shards):
            if i != home:
                self.supervisor.ctl_send(
                    i, {"op": "adopt", "uuid": peer.hex, "home": home}
                )

    # region: live resharding (cluster/resharding)

    def route_replay(self, data: bytes) -> None:
        """Post-flip transfer-buffer replay: each parked frame
        re-enters ``_route`` — re-decoded, re-admitted, stamped with
        the NEW epoch, landing on the new owner in arrival order."""
        try:
            self._route(data)
        except Exception:
            self.metrics.inc("cluster.router_recv_errors")
            logger.exception("error replaying parked frame — dropped")

    def send_fence(self, shard: int, xfer_id: int) -> bool:
        """Push the freeze fence through the DATA path: the shard's
        PULL is FIFO and processing is in-order, so the fence's
        control ack proves every earlier frame for the frozen world
        was already processed (and is therefore in the capsule)."""
        ctx = (
            tracectx.new_trace_id(self._trace_rng), time.monotonic_ns(),
            self.world_map.epoch,
        )
        try:
            self._push[shard].send(
                tracectx.wrap_epoch(
                    fence_payload(xfer_id), ctx[0], ctx[1], ctx[2]
                ),
                flags=zmq.NOBLOCK,
            )
            return True
        except zmq.Again:
            return False

    def _note_reroute(self, shard: int, msg: dict) -> None:
        """A shard rejected a stale-epoch frame for a world it no
        longer owns and bounced the wire bytes back: re-route under
        the CURRENT placement (one hop, re-stamped epoch) instead of
        misapplying or dropping."""
        import base64

        try:
            data = base64.b64decode(msg["data"])
        except (KeyError, TypeError, ValueError):
            return
        self.metrics.inc("cluster.router_reroutes")
        self.route_replay(data)

    def broadcast_placement(self) -> None:
        """Push the placement document to every live shard (the flip
        path); stragglers converge via the epoch check on their ~1s
        state packets."""
        spec = self.world_map.to_spec()
        for i in range(self.n_shards):
            self.supervisor.ctl_send(i, {"op": "placement", "spec": spec})

    def queue_tombstone(self, shard: int, world: str, xfer: int) -> None:
        """Issue (and remember) a tombstone: re-sent on every ready of
        ``shard`` until its ack arrives, so a source SIGKILLed at any
        point after the flip still deletes its stale WAL copy."""
        self._pending_tombstones.setdefault(shard, {})[xfer] = world
        self.supervisor.ctl_send(shard, {
            "op": "reshard_tombstone", "xfer": xfer, "world": world,
        })

    def start_reshard(self, world: str, target: int,
                      reason: str = "manual") -> int | None:
        """Begin migrating ``world`` to ``target``. Returns the xfer
        id, or None when refused (already where it belongs, shard out
        of range, or a migration is already in flight)."""
        if not 0 <= target < self.n_shards:
            return None
        if self.migration is not None and self.migration.active:
            return None
        source = self.world_map.shard_of_world(world)
        if source == target:
            return None
        self._xfer_seq += 1
        self._xfer_seq %= 1 << 31
        xfer = self._xfer_seq
        coordinator = MigrationCoordinator(
            self, world, source, target, xfer,
            getattr(self.config, "reshard_buffer_bytes", 8 << 20),
        )
        # interception must be live BEFORE the fence goes out: every
        # frame between now and the flip parks (or sheds, counted)
        self.migration = coordinator
        coordinator.state = "freeze"
        logger.warning(
            "reshard %d (%s): migrating world %r from shard %d to %d",
            xfer, reason, world, source, target,
        )
        self.metrics.inc("cluster.reshard_started")
        self._migration_task = asyncio.get_running_loop().create_task(  # wql: allow(unsupervised-task) — run() contains its own abort path; cancelled in stop()
            self._run_migration(coordinator),
            name=f"cluster-reshard-{xfer}",
        )
        return xfer

    async def _run_migration(self, coordinator: MigrationCoordinator
                             ) -> None:
        try:
            if await coordinator.run():
                self.resharded += 1
        finally:
            if self.migration is coordinator:
                # keep the coordinator for describe(); interception is
                # off (state done/aborted → should_park False)
                self._migration_task = None

    def hottest_world(self, shard: int) -> str | None:
        """The decayed-forward-count argmax among worlds the placement
        currently puts on ``shard`` — the autoshard pick."""
        best, best_load = None, 0.0
        for world, load in self._world_load.items():
            if load > best_load and \
                    self.world_map.shard_of_world(world) == shard:
                best, best_load = world, load
        return best

    def shard_forward_load(self, shard: int) -> float:
        return sum(
            load for world, load in self._world_load.items()
            if self.world_map.shard_of_world(world) == shard
        )

    def decay_world_load(self, factor: float = 0.5) -> None:
        """Exponential decay of the per-world forward window (called
        each autoshard poll) — the hottest-world signal tracks RECENT
        load, not lifetime totals."""
        drop = [w for w, v in self._world_load.items() if v * factor < 1.0]
        for world in drop:
            del self._world_load[world]
        for world in self._world_load:
            self._world_load[world] *= factor

    # endregion

    def _send_refusal(self, message: Message) -> None:
        """Budgeted jittered retry-after hint for a router-shed NEW
        handshake, pushed to the connect-back address the client just
        supplied — the ZmqTransport refusal contract, moved to the
        tier that shed it."""
        self.metrics.inc("cluster.router_handshakes_refused")
        now = time.monotonic()
        bucket = self._hint_bucket
        bucket[0] = min(bucket[0] + (now - bucket[1]) * 50.0, 50.0)
        bucket[1] = now
        if bucket[0] < 1.0 or not message.parameter:
            return
        bucket[0] -= 1.0
        retry_ms = max(1, int(500 * (0.5 + self._jitter.random())))
        task = asyncio.get_running_loop().create_task(  # wql: allow(unsupervised-task) — one-shot, retained below
            self._push_refusal(message.parameter, retry_ms)
        )
        self._refusals.add(task)
        task.add_done_callback(self._refusals.discard)

    async def _push_refusal(self, parameter: str, retry_ms: int) -> None:
        push = self.ctx.socket(zmq.PUSH)
        push.setsockopt(zmq.LINGER, 200)
        try:
            push.connect(f"tcp://{parameter}")
            await push.send(serialize_message(Message(  # wql: allow(untraced-forward) — client-bound refusal hint, not a shard forward
                instruction=Instruction.HANDSHAKE,
                parameter=f"retry-after:{retry_ms}",
            )))
            self.metrics.inc("cluster.router_refusal_hints")
        except Exception:
            logger.debug("router refusal hint to %s failed", parameter)
        finally:
            push.close(linger=200)

    # endregion

    # region: admin surface

    def status(self) -> dict:
        """The ``cluster`` gauge + the /healthz aggregation body."""
        now = time.monotonic()
        shard_states = {}
        stale = 0
        for i in range(self.n_shards):
            state = self.supervisor.shard_state(i)
            slot = self.supervisor._shards[i]
            alive = self.supervisor.shard_alive(i)
            age = self.federation.telemetry_age_s(i)
            # telemetry freshness (the delivery plane's stats_stale idiom): a
            # wedged-but-alive shard whose metrics exports went silent
            # must not look healthy. A shard that never reported this
            # incarnation counts from its boot.
            is_stale = alive and self.federation.telemetry_stale(
                i,
                alive_for_s=(now - slot.born) if slot.born else None,
            )
            if is_stale:
                stale += 1
            shard_states[str(i)] = {
                "alive": alive,
                "level": self.mirror.level(i),
                "state": state.get("state", "unknown"),
                "peers": state.get("peers", 0),
                "state_age_s": (
                    round(now - slot.state_at, 2)
                    if slot.state_at else None
                ),
                "telemetry_age_s": (
                    round(age, 3) if age is not None else None
                ),
                "telemetry_stale": is_stale,
            }
        body = {
            "shards": self.n_shards,
            "alive": self.supervisor.alive_count(),
            "restarts": self.supervisor.stats()["restarts"],
            "known_peers": len(self._peers),
            "forwarded": self.forwarded,
            "telemetry_stale": stale,
            "shard_states": shard_states,
            "placement": {
                "epoch": self.world_map.epoch,
                "world_overrides": len(self.world_map.world_overrides),
            },
            "resharded": self.resharded,
            "autoshard": self.autoshard.stats(),
        }
        if self.migration is not None:
            body["migration"] = self.migration.describe()
        return body

    async def _start_http(self) -> None:
        from aiohttp import web

        app = web.Application()
        app.router.add_get("/healthz", self._get_healthz)
        app.router.add_get("/metrics", self._get_metrics)
        app.router.add_get("/debug/cluster", self._get_debug_cluster)
        if self.slo is not None:
            app.router.add_get("/debug/slo", self._get_debug_slo)
        if self.incidents is not None:
            app.router.add_get("/debug/incidents", self._get_debug_incidents)
        app.router.add_post("/global_message", self._post_global_message)
        app.router.add_post("/reshard", self._post_reshard)
        self._http_runner = web.AppRunner(app)
        await self._http_runner.setup()
        site = web.TCPSite(
            self._http_runner, self.config.http_host, self.config.http_port
        )
        await site.start()

    async def _get_healthz(self, request):
        from aiohttp import web

        cluster = self.status()
        body = {"status": "ok", "role": "router", "cluster": cluster}
        if (
            self.supervisor.alive_count() < self.n_shards
            or cluster["telemetry_stale"]
            or any(
                self.mirror.level(i) >= _SHED_HIGH
                for i in range(self.n_shards)
            )
        ):
            body["status"] = "degraded"
        if self.slo is not None:
            # fleet burn state: the router's own engine (judging the
            # federated registry) plus every shard's piggybacked worst
            slo = self.slo.healthz()
            body["slo"] = slo
            if slo["state"] == "burning":
                body["status"] = "degraded"
        return web.json_response(body)

    async def _get_metrics(self, request):
        from aiohttp import web

        if "application/json" in request.headers.get("Accept", ""):
            return web.json_response(self.metrics.snapshot())
        return web.Response(
            text=self.metrics.render_prometheus(),
            content_type="text/plain", charset="utf-8",
        )

    # region: cluster flight recorder (GET /debug/cluster)

    async def collect_shard_dump(
        self, shard: int, timeout: float = 8.0
    ) -> dict | None:
        """Pull one shard's flight-recorder + subsystem-section dump
        over the shared :class:`ChunkedDumpClient` (request → chunked
        response). None on a dead shard or a timeout — the caller
        degrades to the processes that answered, never errors."""
        return await self.dumps.collect(shard, timeout)

    async def _get_debug_cluster(self, request):
        """ONE flight recorder for the fleet: every shard's snapshot
        pulled over the control channel and spliced with the router's
        own spans. ``?format=chrome`` renders Trace Event Format with
        one NAMED pid lane per process (router / shard-N), so a
        cross-shard frame's router→home→remote chain reads off one
        timeline — the spans share its trace id."""
        from aiohttp import web

        dumps = await asyncio.gather(
            *(self.collect_shard_dump(i) for i in range(self.n_shards))
        )
        own: list[dict] = []
        if self.recorder is not None:
            own = self.recorder.snapshot() + self.recorder.loose_snapshot()
        if request.query.get("format") == "chrome":
            from ..observability.export import chrome_trace

            events = chrome_trace(
                own, pid=os.getpid(), process_name="router"
            )["traceEvents"]
            for i, dump in enumerate(dumps):
                if not dump:
                    continue
                events.extend(chrome_trace(
                    list(dump.get("ticks") or [])
                    + list(dump.get("loose") or []),
                    pid=int(dump.get("pid") or (1_000_000 + i)),
                    process_name=f"shard-{i}",
                )["traceEvents"])
            return web.json_response(
                {"traceEvents": events, "displayTimeUnit": "ms"}
            )
        return web.json_response({
            "router": {"pid": os.getpid(), "traces": own},
            "shards": {
                str(i): dump for i, dump in enumerate(dumps)
                if dump is not None
            },
        })

    # endregion

    # region: fleet SLO surface (GET /debug/slo, /debug/incidents)

    async def _get_debug_slo(self, request):
        from aiohttp import web

        return web.json_response(self.slo.status())

    async def _get_debug_incidents(self, request):
        from aiohttp import web

        incident_id = request.query.get("id")
        if incident_id is None:
            return web.json_response({
                "incidents": self.incidents.list(),
                "stats": self.incidents.stats(),
            })
        capsule = self.incidents.load(incident_id)
        if capsule is None:
            return web.Response(status=404)
        return web.json_response(capsule)

    def _on_slo_burning(self, objective) -> None:
        """SLO eval hook: a fleet objective transitioned into BURNING.
        The recorder debounces and pulls the capsule asynchronously."""
        if self.incidents is not None:
            self.incidents.trigger(objective, self.slo.status())

    def _router_sections(self) -> dict:
        """The router process's own capsule sections (its subsystems
        differ from an engine process: no governor/interest/device —
        instead placement, federation and the shed mirror)."""
        from ..observability.incidents import top_stage_attribution
        from ..robustness import failpoints

        sections: dict = {
            "placement": {
                "epoch": self.world_map.epoch,
                "world_overrides": len(self.world_map.world_overrides),
                "migration": (
                    self.migration.describe()
                    if self.migration is not None else None
                ),
            },
            "federation": self.federation.stats(),
            "shed_mirror": {
                str(i): self.mirror.level(i) for i in range(self.n_shards)
            },
            "cluster": self.status(),
            "failpoints": dict(failpoints.registry.fired_counts()),
        }
        if self.recorder is not None:
            sections["flight_recorder"] = {
                "stats": self.recorder.stats(),
                "ticks": self.recorder.snapshot(),
                "loose": self.recorder.loose_snapshot(),
                "top_stages": top_stage_attribution(self.recorder),
            }
        else:
            sections["flight_recorder"] = {"enabled": False}
        return sections

    async def _collect_incident_body(self) -> dict:
        """Fleet capsule body: the router's sections plus EVERY shard's
        dump (flight recorder + its subsystem sections) pulled over the
        same chunked control path /debug/cluster uses."""
        dumps = await asyncio.gather(
            *(self.collect_shard_dump(i) for i in range(self.n_shards))
        )
        return {
            "pid": os.getpid(),
            "sections": self._router_sections(),
            "shards": {
                str(i): dump for i, dump in enumerate(dumps)
                if dump is not None
            },
        }

    # endregion

    async def _post_reshard(self, request):
        """Manual migration trigger: ``{"world": ..., "target": N}``.
        202 with the xfer id when accepted; 409 while another migration
        is in flight; 400 on a bad body or a no-op placement."""
        from aiohttp import web

        try:
            body = await request.json()
            world = body["world"]
            target = int(body["target"])
            if not isinstance(world, str) or not world:
                raise ValueError("world must be a non-empty string")
        except Exception:
            return web.Response(status=400)
        if self.migration is not None and self.migration.active:
            return web.json_response(
                {"error": "migration in flight",
                 "migration": self.migration.describe()},
                status=409,
            )
        xfer = self.start_reshard(world, target, reason="manual")
        if xfer is None:
            return web.json_response(
                {"error": "refused (bad target or world already there)"},
                status=400,
            )
        return web.json_response(
            {"xfer": xfer, "world": world, "target": target}, status=202
        )

    async def _post_global_message(self, request):
        from aiohttp import web

        try:
            body = await request.json()
            world_name = body["world_name"]
            parameter = body.get("parameter")
            if not isinstance(world_name, str) or not (
                parameter is None or isinstance(parameter, str)
            ):
                raise ValueError("wrong field types")
        except Exception:
            return web.Response(status=400)
        message = Message(
            instruction=Instruction.GLOBAL_MESSAGE,
            parameter=parameter,
            world_name=world_name,
        )
        # rides the PRIVATE control channel, not the shard's public
        # PULL: the transport there drops nil-sender wire messages
        # (anti-spoofing — only the in-process HTTP surface may inject),
        # and the control channel is exactly that trusted in-process
        # surface stretched across the process boundary
        import base64

        self.supervisor.ctl_send(
            self.world_map.shard_of_world(world_name),
            {
                "op": "inject",
                "data": base64.b64encode(
                    serialize_message(message)
                ).decode(),
            },
        )
        return web.Response(status=204)

    # endregion


class ClusterRuntime:
    """Supervisor + router composition: the thing ``--cluster-shards
    N`` boots. Also embedded by the scenario engine, bench config 11
    and the e2e suite (the router runs in the embedding process; the
    shards are always real subprocesses)."""

    def __init__(self, config, metrics: Metrics | None = None):
        config.validate()
        self.config = config
        self.metrics = metrics if metrics is not None else Metrics()
        self.supervisor = ClusterSupervisor(
            config, config.cluster_shards, metrics=self.metrics,
        )
        self.router = ClusterRouter(
            config, self.supervisor, metrics=self.metrics
        )
        self.supervisor.on_shard_ready = self.router.on_shard_ready
        self.supervisor.on_shard_down = self.router.on_shard_down
        self.supervisor.on_shard_message = self.router.on_shard_message
        self.shutdown_requested = asyncio.Event()
        # scenario-engine compatibility surface
        self.governor = None
        self.ticker = None

    async def start(self) -> None:
        await self.supervisor.start()
        await self.router.start()

    async def stop(self) -> None:
        await self.router.stop()
        await self.supervisor.stop()

    async def run_forever(self) -> None:
        import signal as signal_mod

        await self.start()
        stop_requested = asyncio.Event()
        loop = asyncio.get_running_loop()
        hooked = []
        for sig in (signal_mod.SIGINT, signal_mod.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop_requested.set)
                hooked.append(sig)
            except (NotImplementedError, RuntimeError):
                pass
        waiters = [
            asyncio.ensure_future(stop_requested.wait()),  # wql: allow(unsupervised-task)
            asyncio.ensure_future(self.shutdown_requested.wait()),  # wql: allow(unsupervised-task)
        ]
        try:
            await asyncio.wait(
                waiters, return_when=asyncio.FIRST_COMPLETED
            )
            logger.info("cluster router shutting down")
        finally:
            for waiter in waiters:
                waiter.cancel()
            for sig in hooked:
                loop.remove_signal_handler(sig)
            await self.stop()
