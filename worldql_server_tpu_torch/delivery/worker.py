"""Sender worker process: one shard of the delivery plane.

Each worker is a plain SYNCHRONOUS process — no asyncio, no event
loop, no Peer objects (the ``worker-unsafe-delivery`` lint rule keeps
it that way): it drains its shared-memory ring of
``(frame_bytes, slot_ids)`` records and pushes frames out of the
sockets it OWNS —

* WebSocket peers arrive as raw TCP fds passed over the control
  channel at handshake (``socket.recv_fds``); the worker writes
  complete server→client frames (``ws_framing``) non-blocking with a
  bounded per-socket backlog, mirroring the parent's
  ``_WRITE_HARD_LIMIT`` eviction semantics.
* ZeroMQ peers arrive as connect-back endpoints; the worker connects
  its OWN ``PUSH`` socket (sends never touch the parent's context).

The worker never decides membership: a failed/overflowing peer is
closed locally and REPORTED (``{"op": "fail"}``) — the parent's
authoritative PeerMap performs the eviction, so ``on_peer_removed``
and staleness semantics are identical to single-process mode.

Control channel: one ``AF_UNIX`` ``SOCK_SEQPACKET`` connection (packet
boundaries preserved, fd passing supported). JSON packets both ways —
control is not the hot path; the hot path is the pickle-free ring.

Telemetry: each ring record carries two CLOCK_MONOTONIC
stamps (frame-clock ingress + ring write, see delivery/ring.py); the
worker closes them at socket-write-complete into two cumulative local
histograms — ``e2e`` (ring write → write complete: ring dwell + write
time, the per-worker ``delivery.worker.<i>.e2e_ms`` series) and
``frame_e2e`` (router-dispatch/flush-start → write complete: the
honest fan-out frame clock) — plus a bounded buffer of per-record span
SEGMENTS the parent stitches under ``tick.deliver`` in the flight
recorder. Both ride the periodic stats packet; the parent diffs the
cumulative counts into its registry, so worker restarts never reset a
merged series. Caveat: a frame parked in a WS backlog closes its clock
when the flushed tail finally drains (tracked per pending buffer), so
slow-consumer tails land in the histograms instead of hiding behind
the non-blocking send's immediate return.
"""

from __future__ import annotations

import json
import os
import select
import signal
import socket
import time

from .ring import Ring
from ..robustness import failpoints
from ..robustness.failpoints import FailpointError
from ..transports.ws_framing import ws_binary_frame

#: per-socket outbound backlog bound — a consumer that lets this much
#: buffer is dead-or-pathological and is evicted (same constant and
#: rationale as transports/websocket.py _WRITE_HARD_LIMIT)
PENDING_HARD_LIMIT = 8 << 20

#: worker→parent cumulative-stats cadence (seconds)
STATS_INTERVAL = 0.25

#: span segments buffered per stats interval — the stitching detail
#: cap; past it records skip per-slot timing too (the hot path stays
#: two clock reads per record, not two per send)
SEGMENT_CAP = 128

#: histogram bucket upper bounds in ms — MUST mirror
#: engine/metrics.py LATENCY_BUCKETS_MS (pinned by
#: tests/test_worker_telemetry.py) so the parent can merge cumulative
#: bucket counts straight into its registry. Duplicated rather than
#: imported: pulling engine/* into the worker process would drag the
#: whole server object graph through every spawn.
BUCKETS_MS = (
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 25000.0, 50000.0, 100000.0,
    250000.0,
)


class _Hist:
    """Cumulative fixed-bucket latency histogram (worker-local, no
    locks — the worker is single-threaded by design)."""

    __slots__ = ("counts", "total", "sum_ms", "max_ms")

    def __init__(self):
        self.counts = [0] * (len(BUCKETS_MS) + 1)
        self.total = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0

    def observe(self, value_ms: float) -> None:
        i = 0
        for i, bound in enumerate(BUCKETS_MS):  # noqa: B007
            if value_ms <= bound:
                break
        else:
            i = len(BUCKETS_MS)
        self.counts[i] += 1
        self.total += 1
        self.sum_ms += value_ms
        if value_ms > self.max_ms:
            self.max_ms = value_ms

    def packet(self) -> dict:
        """Cumulative snapshot for the stats packet (the parent diffs
        against the previous packet, so restarts re-zero cleanly)."""
        return {
            "counts": self.counts, "total": self.total,
            "sum_ms": round(self.sum_ms, 3),
            "max_ms": round(self.max_ms, 3),
        }


class _FrameClock:
    """Shared completion state for one ring record's backlogged tail:
    observed ONCE, at the first flush that fully drains a sink this
    record pended on (typically the one slow consumer the tail
    exists for)."""

    __slots__ = ("t_ingress", "t_write", "done")

    def __init__(self, t_ingress: int, t_write: int):
        self.t_ingress = t_ingress
        self.t_write = t_write
        self.done = False


class _WsSink:
    """One handed-off WebSocket TCP socket: non-blocking whole-frame
    writes with an ordered backlog for partial sends. Backlogged frames
    carry their record's :class:`_FrameClock` so the e2e close happens
    when the bytes actually drain, not when they were parked."""

    kind = "ws"
    __slots__ = ("sock", "pending", "pending_bytes")

    def __init__(self, fd: int):
        self.sock = socket.socket(fileno=fd)
        self.sock.setblocking(False)
        self.pending: list[list] = []   # [memoryview, _FrameClock | None]
        self.pending_bytes = 0

    def send(self, frame: bytes, clock=None) -> str:
        if self.pending:
            # order over speed: never bypass the backlog
            self.pending.append([memoryview(frame), clock])
            self.pending_bytes += len(frame)
            if self.pending_bytes > PENDING_HARD_LIMIT:
                return "overflow"
            return "ok"
        try:
            n = self.sock.send(frame)
        except (BlockingIOError, InterruptedError):
            n = 0
        except OSError:
            return "fail"
        if n < len(frame):
            self.pending.append([memoryview(frame)[n:], clock])
            self.pending_bytes += len(frame) - n
        return "ok"

    def flush(self, on_done=None) -> str:
        while self.pending:
            mv, clock = self.pending[0]
            try:
                n = self.sock.send(mv)
            except (BlockingIOError, InterruptedError):
                return "ok"
            except OSError:
                return "fail"
            self.pending_bytes -= n
            if n == len(mv):
                self.pending.pop(0)
                if clock is not None and on_done is not None:
                    on_done(clock)
            else:
                self.pending[0][0] = mv[n:]
                return "ok"
        return "ok"

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class _ZmqSink:
    """One worker-owned connect-back PUSH socket (outgoing.rs:95-118
    ownership moved into the shard)."""

    kind = "zmq"
    __slots__ = ("sock",)

    def __init__(self, ctx, endpoint: str):
        import zmq

        self.sock = ctx.socket(zmq.PUSH)
        self.sock.setsockopt(zmq.LINGER, 0)
        # deep HWM: the reference's relay channel is unbounded below
        # failure; hitting this is treated as a failed send (evict)
        self.sock.setsockopt(zmq.SNDHWM, 65536)
        self.sock.connect(endpoint)

    def send(self, payload: bytes) -> str:
        import zmq

        try:
            self.sock.send(payload, zmq.NOBLOCK)
        except zmq.Again:
            return "overflow"
        except Exception:
            return "fail"
        return "ok"

    def flush(self) -> str:
        return "ok"

    def close(self) -> None:
        try:
            self.sock.close(linger=0)
        except Exception:
            pass


def _ctl_send(ctl: socket.socket, msg: dict, critical: bool = True) -> None:
    """One control packet to the parent. Stats packets are best-effort
    (a full buffer drops the sample); fail/ready packets retry briefly
    — losing one would leak a dead peer from the map until the
    staleness sweep."""
    data = json.dumps(msg).encode()
    deadline = time.monotonic() + (1.0 if critical else 0.0)
    while True:
        try:
            ctl.send(data)
            return
        except (BlockingIOError, InterruptedError):
            if time.monotonic() >= deadline:
                return
            select.select([], [ctl], [], 0.01)
        except OSError:
            return


def worker_main(worker_id: int, control_path: str, ring_name: str,
                failpoints_spec: str = "",
                failpoints_seed: int | None = None) -> None:
    """Process entry (multiprocessing spawn target)."""
    # the parent owns lifecycle: SIGINT storms (Ctrl-C to the group)
    # must not kill a worker mid-drain; SIGTERM requests a clean stop
    stopping = {"flag": False}
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, lambda *_: stopping.__setitem__("flag", True))

    if failpoints_spec:
        # the parent's spec rides the spawn args (the registry is
        # per-process): chaos runs exercise worker-side sites like
        # `delivery.worker_send` deterministically, and the fired
        # counts report back via the stats packet so the parent's
        # failpoints gauge audits the WHOLE plane
        try:
            failpoints.registry.configure(
                failpoints_spec, seed=failpoints_seed
            )
        except Exception:
            pass  # a bad spec must not kill the shard

    ctl = socket.socket(socket.AF_UNIX, socket.SOCK_SEQPACKET)
    ctl.connect(control_path)
    ctl.setblocking(False)
    ring = Ring.attach(ring_name)
    sinks: dict[int, object] = {}
    zmq_ctx = None
    stats = {
        "records": 0,      # ring records consumed
        "deliveries": 0,   # frame×peer sends attempted
        "sends_ok": 0,
        "send_errors": 0,
        "bytes": 0,
        "evictions": 0,    # peers this worker reported as failed
        "drain_ms": 0.0,   # wall of the last non-empty drain burst
    }
    e2e_hist = _Hist()        # ring write → socket-write-complete
    frame_hist = _Hist()      # frame-clock ingress → write-complete
    segments: list[list] = []  # span segments for parent-side stitching

    def tail_done(clock: _FrameClock) -> None:
        """A backlogged frame's bytes fully drained — close its clocks
        (once per record; the first draining sink wins)."""
        if clock.done:
            return
        clock.done = True
        now = time.monotonic_ns()
        e2e_hist.observe((now - clock.t_write) / 1e6)
        if clock.t_ingress:
            frame_hist.observe((now - clock.t_ingress) / 1e6)

    _ctl_send(ctl, {"op": "ready", "pid": os.getpid(), "worker": worker_id})
    last_stats = time.monotonic()

    def drop_sink(slot: int, reason: str) -> None:
        sink = sinks.pop(slot, None)
        if sink is not None:
            sink.close()
        stats["evictions"] += 1
        _ctl_send(ctl, {"op": "fail", "slot": slot, "reason": reason})

    def handle_control(data: bytes, fds: list[int]) -> bool:
        """One parent packet; False = stop requested."""
        nonlocal zmq_ctx
        try:
            msg = json.loads(data)
        except ValueError:
            return True
        op = msg.get("op")
        if op == "add":
            slot = msg["slot"]
            try:
                if msg["kind"] == "ws" and fds:
                    sinks[slot] = _WsSink(fds[0])
                    fds.clear()  # consumed
                elif msg["kind"] == "zmq":
                    if zmq_ctx is None:
                        import zmq

                        zmq_ctx = zmq.Context()
                    sinks[slot] = _ZmqSink(zmq_ctx, msg["endpoint"])
            except Exception:
                # an unconnectable sink is a failed peer, not a dead
                # worker: report it and keep the shard serving
                stats["evictions"] += 1
                _ctl_send(
                    ctl, {"op": "fail", "slot": slot,
                          "reason": "send_failed"},
                )
        elif op == "remove":
            sink = sinks.pop(msg["slot"], None)
            if sink is not None:
                sink.close()
        elif op == "stop":
            return False
        return True

    try:
        while True:
            progressed = False
            # 1. drain the ring (bounded burst keeps control responsive)
            t0 = time.perf_counter()
            for _ in range(512):
                rec = ring.read_record()
                if rec is None:
                    break
                progressed = True
                frame, slots, t_ingress, t_write = rec
                t_deq = time.monotonic_ns()
                try:
                    # slow-consumer-tail chaos site (delay): wedges the
                    # shard's drain so stats_age/degraded detection and
                    # ring-full backpressure are testable
                    failpoints.fire("delivery.worker_send")
                except FailpointError:
                    pass  # only delay is meaningful at this site
                stats["records"] += 1
                ws_frame = None
                clock = None
                # per-slot timing only while a stitch segment is still
                # wanted this interval — past the cap the hot path pays
                # two clock reads per RECORD, not two per send
                want_detail = len(segments) < SEGMENT_CAP
                slow_slot, slow_ms = -1, 0.0
                for slot in slots:
                    sink = sinks.get(slot)
                    if sink is None:
                        continue  # removed while the record was in flight
                    stats["deliveries"] += 1
                    ts = time.monotonic_ns() if want_detail else 0
                    if sink.kind == "ws":
                        if ws_frame is None:
                            # framed ONCE per record, shared by every
                            # WS recipient in the slot list
                            ws_frame = ws_binary_frame(frame)
                        if sink.pending and clock is None:
                            clock = _FrameClock(t_ingress, t_write)
                        status = sink.send(ws_frame, clock)
                        stats["bytes"] += len(ws_frame)
                        if sink.pending and clock is None:
                            # pended on THIS send: re-tag the entry so
                            # the flush closes the record's clock
                            clock = _FrameClock(t_ingress, t_write)
                            sink.pending[-1][1] = clock
                    else:
                        status = sink.send(frame)
                        stats["bytes"] += len(frame)
                    if want_detail:
                        dt = (time.monotonic_ns() - ts) / 1e6
                        if dt >= slow_ms:
                            slow_slot, slow_ms = slot, dt
                    if status == "ok":
                        stats["sends_ok"] += 1
                    else:
                        stats["send_errors"] += 1
                        drop_sink(
                            slot,
                            "overflow" if status == "overflow"
                            else "send_failed",
                        )
                t_done = time.monotonic_ns()
                if clock is None:
                    # every sink took the bytes now — close the clocks
                    e2e_hist.observe((t_done - t_write) / 1e6)
                    if t_ingress:
                        frame_hist.observe((t_done - t_ingress) / 1e6)
                # else: a WS backlog holds the tail; flush closes it
                if want_detail:
                    segments.append([
                        t_write,
                        round((t_deq - t_write) / 1e6, 3),   # ring dwell
                        round((t_done - t_deq) / 1e6, 3),    # write time
                        len(slots), slow_slot, round(slow_ms, 3),
                    ])
            if progressed:
                stats["drain_ms"] = (time.perf_counter() - t0) * 1e3
            # 2. flush partial-write backlogs
            for slot, sink in list(sinks.items()):
                if sink.kind == "ws" and sink.pending:
                    if sink.flush(tail_done) == "fail":
                        stats["send_errors"] += 1
                        drop_sink(slot, "send_failed")
            # 3. control packets
            stop_req = stopping["flag"]
            while True:
                try:
                    data, fds, _flags, _addr = socket.recv_fds(ctl, 65536, 8)
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    data, fds = b"", []
                if not data:
                    return  # parent gone — nothing left to serve
                if not handle_control(data, list(fds)):
                    stop_req = True
            # 4. periodic cumulative stats (+ telemetry: cumulative
            # e2e histograms the parent diffs into /metrics, drained
            # span segments for flight-recorder stitching, and this
            # process's failpoint fire counts for the plane-wide audit)
            now = time.monotonic()
            if now - last_stats >= STATS_INTERVAL:
                last_stats = now
                packet = {
                    "op": "stats", "worker": worker_id,
                    "peers": len(sinks),
                    "ring_pending": ring.pending_bytes(), **stats,
                    "e2e": e2e_hist.packet(),
                    "frame_e2e": frame_hist.packet(),
                }
                if segments:
                    packet["segments"] = segments
                    segments = []
                fired = failpoints.registry.fired_counts()
                if fired:
                    packet["fp"] = fired
                _ctl_send(ctl, packet, critical=False)
            if stop_req:
                stopping["flag"] = True
                # stop once the ring is drained and backlogs flushed
                # (bounded below by the parent's join timeout)
                if ring.pending_bytes() == 0 and not any(
                    s.kind == "ws" and s.pending for s in sinks.values()
                ):
                    break
                continue
            # 5. idle wait: the ring is empty — sleep on control
            # traffic / writability instead of spinning
            if not progressed:
                wlist = [
                    s.sock for s in sinks.values()
                    if s.kind == "ws" and s.pending
                ]
                try:
                    select.select([ctl], wlist, [], 0.002)
                except OSError:
                    pass
    finally:
        final = {
            "op": "stats", "worker": worker_id, "peers": len(sinks),
            "ring_pending": ring.pending_bytes(), **stats,
            "e2e": e2e_hist.packet(), "frame_e2e": frame_hist.packet(),
        }
        if segments:
            final["segments"] = segments
        fired = failpoints.registry.fired_counts()
        if fired:
            final["fp"] = fired
        _ctl_send(ctl, final, critical=False)
        for sink in sinks.values():
            sink.close()
        if zmq_ctx is not None:
            zmq_ctx.term()
        ring.close()
        ctl.close()
