"""ZeroMQ transport.

Rebuild of the reference's asymmetric socket pattern
(worldql_server/src/transport/zeromq/): the server binds one PULL
socket for all inbound traffic (incoming.rs:19-24); each client runs
its own PULL and the server connects a dedicated PUSH socket *back* to
an address the client supplies as the Handshake ``parameter``
(outgoing.rs:95-118).

Handshake flow: a message from an unknown sender UUID is dropped unless
it is a Handshake carrying an address parameter; the server then
connects a PUSH socket to ``tcp://<parameter>``, echoes a bare
Handshake (nil sender, no parameter — outgoing.rs:108-118), and
registers the peer. Known senders' Handshakes are swallowed
(incoming.rs:56-61); UUID clashes drop the handshake
(outgoing.rs:88-94). ZMQ peers are heartbeat-tracked: the engine's
staleness sweeper evicts them (outgoing.rs:28-47,132-150), and a failed
send evicts immediately (outgoing.rs:66-76).

Session continuity (``--session-ttl``, robustness/sessions.py): the
handshake echo's ``parameter`` carries a minted session token; a
reconnecting client presents it as ``flex`` on its Handshake and the
server rebinds the new connect-back to the parked state — valid even
while the stale old binding is still registered (the server has not
yet noticed the drop). Handshakes are also a governor admission class
(``--overload on``): a refused handshake gets a one-shot jittered
``retry-after:<ms>`` Handshake on its connect-back address (budgeted —
the refusal path must not become a reflector) and no registration
work happens at all.
"""

from __future__ import annotations

import asyncio
import logging
import uuid as uuid_mod

import zmq
import zmq.asyncio

from ..engine.peers import Peer
from ..protocol.entity_wire import RECV_DRAIN_MAX
from ..protocol import (
    DeserializeError,
    Instruction,
    Message,
    deserialize_message,
    serialize_message,
)
from ..robustness import failpoints

logger = logging.getLogger(__name__)


def _valid_socket_addr(parameter: str) -> bool:
    """The reference parses the parameter as a SocketAddr
    (outgoing.rs:97-103): ``ip:port`` (IPv4 or bracketed IPv6)."""
    import ipaddress

    host, sep, port = parameter.rpartition(":")
    if not sep or not host:
        return False
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    try:
        ipaddress.ip_address(host)
    except ValueError:
        return False
    return port.isdigit() and 0 < int(port) < 65536


class ZmqTransport:
    def __init__(self, server):
        self.server = server
        self.ctx = zmq.asyncio.Context()
        self._pull: zmq.asyncio.Socket | None = None
        self._push_sockets: dict[uuid_mod.UUID, zmq.asyncio.Socket] = {}
        self._recv_task: asyncio.Task | None = None
        self._recv_handle = None  # SupervisedTask under a supervisor
        # Failed-send evictions run as tasks; the loop only weak-refs
        # running tasks, so retain them or a GC pass could drop an
        # eviction mid-flight and leak the dead peer from the map.
        self._evictions: set[asyncio.Task] = set()

    async def start(self) -> None:
        config = self.server.config
        self._pull = self.ctx.socket(zmq.PULL)
        # Bound inbound frames BEFORE bind: without MAXMSGSIZE a single
        # hostile peer can stream an arbitrarily large message into
        # server memory (libzmq buffers the whole frame). Oversized
        # senders are disconnected by libzmq; the PULL socket and every
        # other peer keep working.
        self._pull.setsockopt(zmq.MAXMSGSIZE, config.max_message_size)
        self._pull.bind(f"tcp://{config.zmq_server_host}:{config.zmq_server_port}")
        logger.info(
            "ZeroMQ PULL server listening on %s:%s",
            config.zmq_server_host,
            config.zmq_server_port,
        )
        supervisor = getattr(self.server, "supervisor", None)
        if supervisor is not None:
            # CRITICAL: a permanently dead recv loop is a silently deaf
            # transport — restart within budget, then escalate
            self._recv_handle = supervisor.spawn(
                "zmq-recv", self._recv_loop, critical=True
            )
        else:
            self._recv_task = asyncio.create_task(self._recv_loop(), name="zmq-pull")  # wql: allow(unsupervised-task)

    async def stop(self) -> None:
        if self._recv_handle is not None:
            await self._recv_handle.stop()
            self._recv_handle = None
        if self._recv_task is not None:
            self._recv_task.cancel()
            try:
                await self._recv_task
            except (asyncio.CancelledError, Exception):
                pass
            self._recv_task = None
        for sock in self._push_sockets.values():
            sock.close(linger=0)
        self._push_sockets.clear()
        if self._pull is not None:
            self._pull.close(linger=0)
            self._pull = None
        self.ctx.term()

    async def _recv_loop(self) -> None:
        """PULL loop (incoming.rs:26-75): multipart frames are
        concatenated, deserialized-or-dropped, then routed.

        Columnar drain (--entity-sim + native codec): everything the
        socket already holds — bounded by ``RECV_DRAIN_MAX`` — drains
        into ONE recv batch handed to ``ColumnarIngest.process_batch``,
        which batch-decodes every entity-update message straight into
        the plane's SoA columns and routes the rest through
        ``_route_data`` in arrival order. Without the fast path the
        loop is the per-message path it always was.

        Per-message crash containment: ANY exception escaping the
        processing of one message (a router bug a hostile payload
        tickles, a handshake connect error) drops THAT message —
        logged and counted in ``zmq.recv_errors`` — and the loop keeps
        receiving. Before this, one poison message permanently deafened
        the transport while the process kept running. Faults in the
        receive machinery itself (socket teardown, the `zmq.recv`
        failpoint) still escape and are the supervisor's job."""
        assert self._pull is not None
        limit = self.server.config.max_message_size
        while True:
            # outside the containment: kills the LOOP, exercising the
            # supervisor's restart/escalate policy in the chaos suite
            failpoints.fire("zmq.recv")
            parts = await self._pull.recv_multipart()
            fast = getattr(self.server, "entity_ingest", None)
            if fast is None or not fast.active:
                try:
                    await self._process_inbound(parts, limit)
                except Exception:
                    self.server.metrics.inc("zmq.recv_errors")
                    logger.exception(
                        "error processing inbound zmq message — dropped"
                    )
                continue
            # Clustered shards receive router-framed bytes (the WQTX
            # trace prefix, cluster/tracectx.py). Strip it BEFORE the
            # native entity classifier — a prefixed buffer fails
            # classification and the whole batch degrades to the
            # object path (a known gap, closed here) — and
            # carry the ctx alongside so slow-routed messages still
            # thread trace_ctx onto their Message.
            cluster = getattr(self.server, "cluster", None)
            datas = []
            ctxs: list[tuple[int, int]] | None = \
                [] if cluster is not None else None
            unwrapped = 0
            data = self._flatten(parts, limit)
            if data is not None:
                unwrapped += await self._absorb_inbound(
                    cluster, data, datas, ctxs, fast
                )
            while len(datas) < RECV_DRAIN_MAX:
                try:
                    parts = await self._pull.recv_multipart(zmq.NOBLOCK)
                except zmq.Again:
                    break
                data = self._flatten(parts, limit)
                if data is not None:
                    unwrapped += await self._absorb_inbound(
                        cluster, data, datas, ctxs, fast
                    )
            if unwrapped:
                # the fast-path-through-router proof: router-framed
                # messages reaching the columnar batch pre-unwrapped
                self.server.metrics.inc("zmq.ctx_unwrapped", unwrapped)
            if datas:
                # contains per message internally; never raises
                await fast.process_batch(datas, self._route_data,
                                         ctxs=ctxs)

    async def _absorb_inbound(self, cluster, data: bytes, datas: list,
                              ctxs: list | None, fast) -> int:
        """Classify one inbound frame for the columnar batch. Live
        resharding (cluster/resharding) adds two diverts ahead of the
        fast path: freeze FENCE frames ack over control instead of
        decoding, and STALE-EPOCH frames (stamped under an older
        placement than this shard holds) take the full decode +
        ownership check — a stale entity frame must never reach the
        SoA columns directly, it may belong to a world this shard just
        lost. Both first hand ``fast`` the frames batched before them,
        in order: the router exports the frozen world once the fence is
        acked, so every frame forwarded before the freeze must be
        applied by then. Everything else joins the batch with its trace
        ctx in lockstep. Returns 1 when a live trace ctx was stripped."""
        if cluster is None:
            datas.append(data)  # wql: allow(unbounded-ingest) — bounded by RECV_DRAIN_MAX in the caller
            return 0
        trace_id, t_ctx, epoch, data = cluster.unwrap(data)
        fence = data[:4] == cluster.FENCE_MAGIC
        if (fence or cluster.frame_stale(epoch)) and datas:
            await fast.process_batch(list(datas), self._route_data,
                                     ctxs=list(ctxs))
            datas.clear()
            ctxs.clear()
        if fence:
            cluster.on_fence(data)
            return 0
        if cluster.frame_stale(epoch):
            await self._route_data(
                data, ctx=(trace_id, t_ctx), epoch=epoch
            )
            return 0
        ctxs.append((trace_id, t_ctx))  # wql: allow(unbounded-ingest) — lockstep with datas, same RECV_DRAIN_MAX bound
        datas.append(data)  # wql: allow(unbounded-ingest) — bounded by RECV_DRAIN_MAX; admission happens in ColumnarIngest/router
        return 1 if trace_id else 0

    def _flatten(self, parts: list[bytes], limit: int) -> bytes | None:
        """Bound + join one multipart message (None = dropped).
        MAXMSGSIZE bounds each PART; bound the flattened total before
        the join materializes it a second time. (libzmq assembles
        multipart atomically before delivery, so its own buffering of
        many under-cap parts cannot be bounded by any socket option —
        see Config.max_message_size.)"""
        if sum(len(p) for p in parts) > limit:
            logger.warning(
                "dropping oversized multipart zmq message (%d parts)",
                len(parts),
            )
            return None
        return b"".join(parts)

    async def _process_inbound(self, parts: list[bytes], limit: int) -> None:
        """One inbound multipart message: bound, decode, route."""
        data = self._flatten(parts, limit)
        if data is not None:
            await self._route_data(data)

    async def _route_data(self, data: bytes,
                          ctx: tuple[int, int] | None = None,
                          epoch: int = 0) -> None:
        tracer = getattr(self.server, "tracer", None)
        if tracer is not None and tracer.enabled:
            # recv→decode→route under one span tree: the decode and the
            # router's handle span nest inside "zmq.recv", so a slow
            # inbound message shows WHERE it spent its wall time
            with tracer.span("zmq.recv", bytes=len(data)) as rspan:
                await self._decode_route(data, tracer, rspan, ctx=ctx,
                                         epoch=epoch)
        else:
            await self._decode_route(data, None, ctx=ctx, epoch=epoch)

    async def _decode_route(self, data: bytes, tracer, rspan=None,
                            ctx: tuple[int, int] | None = None,
                            epoch: int = 0) -> None:
        # Cluster shards receive every message through the router,
        # which frames a trace context on (cluster/tracectx.py):
        # strip it BEFORE the codec (fan-out re-broadcasts the
        # unwrapped bytes) and thread it onto the Message so delivery
        # closes the router-ingress clock at socket-write-complete.
        # The columnar recv loop unwraps pre-batch (the native
        # classifier needs bare wire bytes) and passes the ctx in;
        # the per-message path unwraps here. Non-cluster servers pay
        # one attribute test.
        if ctx is not None:
            trace_id, t_ctx = ctx
        else:
            cluster = getattr(self.server, "cluster", None)
            trace_id = t_ctx = 0
            if cluster is not None:
                trace_id, t_ctx, epoch, data = cluster.unwrap(data)
                if data[:4] == cluster.FENCE_MAGIC:
                    # freeze fence on the per-message path (no columnar
                    # fast path armed): ack over control, never decode
                    cluster.on_fence(data)
                    return
        try:
            failpoints.fire("codec.decode")
            if tracer is not None:
                with tracer.span("codec.decode"):
                    message = deserialize_message(data)
            else:
                message = deserialize_message(data)
        except DeserializeError:
            logger.debug("dropping invalid zmq message: deserialize error")
            return
        if epoch:
            # live resharding: a frame stamped under an older placement
            # epoch, for a world/peer this shard no longer owns, bounces
            # back to the router as a re-route hint instead of mutating
            # state the placement already moved away
            cluster = getattr(self.server, "cluster", None)
            if (
                cluster is not None
                and cluster.frame_stale(epoch)
                and cluster.frame_misrouted(message, epoch)
            ):
                return
        if trace_id:
            message.trace_ctx = (trace_id, t_ctx)
            if rspan is not None:
                # the cross-process chain key: this span tree carries
                # the same trace id the router's forward span and the
                # remote shard's stitched ring spans carry
                rspan.tag(trace_id=format(trace_id, "016x"))

        if message.sender_uuid in self.server.peer_map:
            if message.instruction != Instruction.HANDSHAKE:
                await self.server.router.handle_message(message)
                return
            # known-sender handshakes are swallowed (incoming.rs:56-61)
            # UNLESS a valid session token rides along: the client is
            # resuming over a stale binding the server has not yet
            # noticed dropping — rebind instead of ignoring
            sessions = getattr(self.server, "sessions", None)
            if sessions is None or sessions.peek(
                message.flex, message.sender_uuid
            ) is None:
                return
            await self._handle_handshake(message)
            return

        if (
            message.instruction != Instruction.HANDSHAKE
            or message.parameter is None
        ):
            return  # unknown sender, not a handshake → ignore

        await self._handle_handshake(message)

    async def _handle_handshake(self, message: Message) -> None:
        """Connect-back PUSH + handshake echo + registration or
        session resume (outgoing.rs:81-130). Admission runs BEFORE any
        connect-back/socket work — a shed handshake costs one decode."""
        sessions = getattr(self.server, "sessions", None)
        session = None
        if sessions is not None:
            session = sessions.peek(message.flex, message.sender_uuid)
        if message.sender_uuid in self.server.peer_map and session is None:
            return  # clashing UUID → drop

        parameter = message.parameter
        if parameter is None or not _valid_socket_addr(parameter):
            return  # invalid socket address → drop
        endpoint = f"tcp://{parameter}"

        # Storm-safe admission: new connects shed before
        # resumes; REJECT still admits resumes up to the governor's
        # token bucket. Refusals get a budgeted jittered retry-after
        # hint on the address the client just supplied.
        governor = getattr(self.server, "governor", None)
        if governor is not None:
            admitted, retry_ms = governor.admit_handshake(
                resume=session is not None
            )
            if not admitted:
                await self._send_refusal(endpoint, retry_ms, governor)
                return

        logger.debug("zeromq peer address: %s", endpoint)
        peer_uuid = message.sender_uuid

        token = None
        if sessions is not None:
            if session is not None:
                token = session.token
            else:
                if sessions.get(peer_uuid) is not None:
                    # tokenless handshake for a UUID with held state:
                    # that state belongs to the TOKEN holder — tear it
                    # down first; this is a brand-new peer
                    self.server._teardown_peer_state(peer_uuid)
                token = sessions.mint(peer_uuid, "zeromq").token

        push = self.ctx.socket(zmq.PUSH)
        push.setsockopt(zmq.LINGER, 0)
        push.connect(endpoint)

        # Handshake echo: nil sender (outgoing.rs:108-118); with
        # sessions enabled the parameter carries the resume token
        # (``--session-ttl 0`` keeps the bare no-parameter echo).
        await push.send(
            serialize_message(
                Message(instruction=Instruction.HANDSHAKE, parameter=token)
            )
        )

        async def send_raw(data: bytes) -> None:
            sock = self._push_sockets.get(peer_uuid)
            if sock is None:
                raise ConnectionError("push socket gone")
            try:
                failpoints.fire("transport.send")
                await sock.send(data)
            except Exception:
                # Failed send ⇒ evict peer (outgoing.rs:66-76) — but
                # only while THIS binding is still current: a stale
                # binding's dying send must not evict a resumed one.
                self.server.metrics.inc("peers.evicted_send_failed")
                self._drop_socket(peer_uuid)
                task = asyncio.get_running_loop().create_task(  # wql: allow(unsupervised-task)
                    self.server.peer_map.remove_if(peer_uuid, peer)
                )
                self._evictions.add(task)
                task.add_done_callback(self._evictions.discard)
                raise

        old = None
        if session is not None:
            # Resume: silently drop the stale old binding (connect-back
            # socket, delivery shard slot) — parked state untouched —
            # so the fresh binding below can take its place, possibly
            # on a different shard.
            old = self.server.prepare_rebind(peer_uuid)

        peer = Peer(
            uuid=peer_uuid,
            addr=parameter,
            send_raw=send_raw,
            kind="zeromq",
            tracks_heartbeat=True,
        )
        plane = getattr(self.server, "delivery_plane", None)
        adopted = plane is not None and plane.adopt(peer, endpoint=endpoint)
        if adopted:
            # the owning sender worker connects its OWN PUSH to the
            # peer's PULL; the parent's echo socket closes once the
            # handshake echo flushes (bounded linger) — from here on
            # every frame for this peer rides the worker's shard
            push.close(linger=2000)
        else:
            # single-process mode (or degraded plane): the parent owns
            # the socket, reference semantics unchanged
            self._push_sockets[peer_uuid] = push
        if session is not None:
            sessions.resume(session)
            if old is not None:
                # resume over a still-registered stale binding: the
                # swap is survivor-invisible (no Disconnect/Connect)
                self.server.peer_map.rebind(peer)
            else:
                # parked resume: PeerDisconnect was broadcast at park
                # time, so the rebind announces like a connect
                await self.server.peer_map.insert(peer)
            logger.info(
                "[%s] zeromq session resumed for %s", parameter, peer_uuid
            )
        else:
            await self.server.peer_map.insert(peer)

    async def _send_refusal(self, endpoint: str, retry_ms: int,
                            governor) -> None:
        """One-shot refusal hint: a Handshake whose parameter is
        ``retry-after:<ms>`` pushed to the refused client's own
        connect-back address, within the governor's hint budget —
        beyond it the refusal is silent (cheapest possible shed)."""
        self.server.metrics.inc("zmq.handshakes_refused")
        if not governor.take_refusal_hint():
            return
        push = self.ctx.socket(zmq.PUSH)
        push.setsockopt(zmq.LINGER, 200)
        try:
            push.connect(endpoint)
            await push.send(serialize_message(Message(
                instruction=Instruction.HANDSHAKE,
                parameter=f"retry-after:{retry_ms}",
            )))
            self.server.metrics.inc("zmq.refusal_hints")
        except Exception:
            logger.debug("refusal hint to %s failed", endpoint)
        finally:
            push.close(linger=200)

    def _drop_socket(self, peer_uuid: uuid_mod.UUID) -> None:
        sock = self._push_sockets.pop(peer_uuid, None)
        if sock is not None:
            sock.close(linger=0)

    def on_peer_removed(self, peer_uuid: uuid_mod.UUID) -> None:
        """PeerMap removal hook: close the connect-back PUSH socket."""
        self._drop_socket(peer_uuid)
