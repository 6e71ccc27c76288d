"""Parent-side delivery plane: shard bookkeeping, worker lifecycle,
frame routing.

The parent stays authoritative for membership: transports register a
peer here at handshake (:meth:`DeliveryPlane.adopt`) and the plane
rebinds the peer's write paths so EVERY outbound frame — tick fan-out,
PeerConnect/Disconnect broadcasts, router replies — rides the owning
shard's ring. Workers never mutate the PeerMap; they report failures
over the control channel and the parent evicts through the normal
``PeerMap.remove`` path (``on_peer_removed`` + staleness semantics
unchanged).

Supervision mirrors robustness/supervisor.py discipline for processes:
a dead worker's peers are evicted with reason ``worker_lost``, its ring
lane is reclaimed, and the worker restarts with exponential backoff
within a budget (healthy-run refund). Budget exhaustion DEGRADES — the
shard is retired, new peers adopt onto surviving shards (or fall back
to the in-process pump when none survive) — it never wedges the tick
pipeline.
"""

from __future__ import annotations

import asyncio
import json
import logging
import multiprocessing
import os
import socket
import struct
import tempfile
import time
import uuid as uuid_mod
from array import array
from collections import deque
from typing import Callable

from ..observability.spans import Tracer
from ..robustness import failpoints
from ..robustness.failpoints import FailpointError
from .ring import Ring
from .worker import STATS_INTERVAL, worker_main

logger = logging.getLogger(__name__)

OnPeerLost = Callable[[uuid_mod.UUID, str], None]

#: a worker whose stats push is older than this many control-channel
#: intervals is wedged-but-alive: the process exists, the drain loop
#: does not — the delivery /healthz block marks it degraded (before
#: this, only a DEAD worker looked unhealthy)
STATS_STALE_INTERVALS = 3

#: worker span segments retained for flight-recorder stitching —
#: enough for several ticks of fan-out detail at the segment cap,
#: bounded so an idle /debug/ticks ring never pins stale history
SEGMENT_RETENTION = 2048

#: bounded waits before a frame is DROPPED (and counted) rather than
#: wedging the caller: the sync fast path (event loop, per-broadcast)
#: spins briefly; the async batch path yields to the loop for longer.
SYNC_WAIT_S = 0.002
ASYNC_WAIT_S = 0.25
#: a worker alive this long refunds its restart budget (supervisor.py
#: healthy-run discipline)
HEALTHY_RUN_S = 60.0


class _Shard:
    __slots__ = (
        "idx", "gen", "ring", "proc", "ctl", "alive", "retired",
        "restarts", "born", "peers", "slots", "next_slot", "reader",
        "stats", "stats_at",
    )

    def __init__(self, idx: int):
        self.idx = idx
        self.gen = 0
        self.ring: Ring | None = None
        self.proc = None
        self.ctl: socket.socket | None = None
        self.alive = False
        self.retired = False          # budget exhausted — never restarts
        self.restarts = 0
        self.born = 0.0
        self.peers: dict[uuid_mod.UUID, int] = {}
        self.slots: dict[int, uuid_mod.UUID] = {}
        self.next_slot = 0
        self.reader: asyncio.Task | None = None
        self.stats: dict = {}
        self.stats_at = 0.0           # monotonic time of the last push


class DeliveryPlane:
    def __init__(
        self,
        config,
        metrics=None,
        tracer: Tracer | None = None,
        on_peer_lost: OnPeerLost | None = None,
    ):
        self.n_workers = config.delivery_workers
        self.ring_bytes = config.delivery_ring_bytes
        self.metrics = metrics
        self.tracer = tracer if tracer is not None else Tracer()
        self.on_peer_lost = on_peer_lost
        # Optional drop hook (--interest on): called with the affected
        # peer UUIDs whenever deliver() sheds a frame on a full/dead
        # ring. The ONE observability point the in-process pump and the
        # worker plane share — the server wires both it and the
        # PeerMap's on_frame_loss to InterestManager.mark_resync, so a
        # ring drop forces the peer's next frame full exactly like a
        # local send error does.
        self.on_frame_drop = None
        self._budget = config.supervisor_budget
        self._backoff = config.supervisor_backoff
        # worker processes arm their own failpoint registry from the
        # same spec (spawn args) — worker-side sites fire there and
        # report back for the plane-wide audit
        self._failpoints_spec = getattr(config, "failpoints", "")
        self._failpoints_seed = getattr(config, "failpoints_seed", None)
        self._shards: list[_Shard] = []
        self._dir: str | None = None
        self._ctx = multiprocessing.get_context("spawn")
        self._stopping = False
        self.ring_drops = 0
        self.frames_submitted = 0
        #: worker-reported span segments awaiting flight-recorder
        #: stitching: (worker, t_write_ns, dwell_ms, write_ms, slots,
        #: slow_slot, slow_ms)
        self._segments: deque = deque(maxlen=SEGMENT_RETENTION)

    # region: lifecycle

    async def start(self) -> None:
        self._dir = tempfile.mkdtemp(prefix="wql-dp-")
        self._shards = [_Shard(i) for i in range(self.n_workers)]
        await asyncio.gather(*(self._bring_up(s) for s in self._shards))
        logger.info(
            "delivery plane up: %d sender workers, %d B ring each",
            self.n_workers, self.ring_bytes,
        )

    async def _bring_up(self, shard: _Shard) -> None:
        ring = Ring.create(self.ring_bytes)
        path = os.path.join(self._dir, f"w{shard.idx}-{shard.gen}.sock")
        lsock = socket.socket(socket.AF_UNIX, socket.SOCK_SEQPACKET)
        lsock.bind(path)
        lsock.listen(1)
        lsock.setblocking(False)
        proc = self._ctx.Process(
            target=worker_main,
            args=(shard.idx, path, ring.name,
                  self._failpoints_spec, self._failpoints_seed),
            name=f"wql-delivery-{shard.idx}",
            daemon=True,
        )
        proc.start()
        loop = asyncio.get_running_loop()
        try:
            ctl, _ = await asyncio.wait_for(loop.sock_accept(lsock), 30)
            ctl.setblocking(False)
            ready = json.loads(await asyncio.wait_for(
                loop.sock_recv(ctl, 65536), 30,
            ))
            if ready.get("op") != "ready":
                raise RuntimeError(f"unexpected first packet: {ready}")
        except Exception:
            ring.close()
            ring.unlink()
            if proc.is_alive():
                proc.kill()
            raise
        finally:
            lsock.close()
            try:
                os.unlink(path)
            except OSError:
                pass
        shard.ring, shard.proc, shard.ctl = ring, proc, ctl
        shard.alive = True
        shard.born = time.monotonic()
        shard.stats = {}
        shard.stats_at = shard.born   # freshness clock starts at birth
        # the reader IS the shard's monitor: its EOF-triggered exit path
        # performs eviction + restart, so it does not ride the
        # restart-the-task supervisor
        shard.reader = asyncio.create_task(  # wql: allow(unsupervised-task)
            self._reader(shard), name=f"delivery-reader-{shard.idx}"
        )

    async def stop(self) -> None:
        self._stopping = True
        for shard in self._shards:
            if shard.alive and shard.ctl is not None:
                await self._actl_send(shard, {"op": "stop"})
        for shard in self._shards:
            proc = shard.proc
            if proc is not None:
                await asyncio.to_thread(proc.join, 5)
                if proc.is_alive():
                    logger.warning(
                        "delivery worker %d did not stop — killing",
                        shard.idx,
                    )
                    proc.kill()
                    await asyncio.to_thread(proc.join, 5)
            if shard.reader is not None:
                shard.reader.cancel()
                try:
                    await shard.reader
                except (asyncio.CancelledError, Exception):
                    pass
                shard.reader = None
            self._teardown(shard)
        if self._dir is not None:
            try:
                os.rmdir(self._dir)
            except OSError:
                pass

    def _teardown(self, shard: _Shard) -> None:
        shard.alive = False
        if shard.ctl is not None:
            shard.ctl.close()
            shard.ctl = None
        if shard.ring is not None:
            shard.ring.close()
            shard.ring.unlink()
            shard.ring = None
        shard.proc = None

    # endregion

    # region: control channel

    def _ctl_try(self, shard: _Shard, data: bytes, fds=None) -> str:
        """One non-blocking send attempt: ``ok`` / ``again`` (buffer
        full — worker wedged or slow) / ``err`` (socket dead)."""
        try:
            if fds:
                socket.send_fds(shard.ctl, [data], fds)
            else:
                shard.ctl.send(data)
            return "ok"
        except (BlockingIOError, InterruptedError):
            return "again"
        except OSError:
            return "err"

    def _ctl_send(self, shard: _Shard, msg: dict, fds=None) -> bool:
        """Single-shot control send. Every caller runs on the event
        loop, so this must never wait for the worker: EAGAIN (the
        worker's control buffer is full — it is wedged or far behind)
        counts as failure and the caller's degraded path takes over
        (adopt: the peer stays on the in-process write path; release:
        the worker's end closes when the slot is reused or the worker
        dies). ``_actl_send`` is the retrying variant for coroutines."""
        if shard.ctl is None:
            return False
        return self._ctl_try(shard, json.dumps(msg).encode(), fds) == "ok"

    async def _actl_send(self, shard: _Shard, msg: dict, fds=None) -> bool:
        """Bounded-retry control send for coroutine callers (stop):
        yields to the loop between attempts instead of blocking it."""
        if shard.ctl is None:
            return False
        data = json.dumps(msg).encode()
        deadline = time.monotonic() + 1.0
        while True:
            status = self._ctl_try(shard, data, fds)
            if status != "again" or time.monotonic() >= deadline:
                return status == "ok"
            await asyncio.sleep(0.005)

    async def _reader(self, shard: _Shard) -> None:
        """Drain worker→parent packets; exit means the worker is gone
        (EOF on SIGKILL/crash) and triggers the eviction/restart path."""
        loop = asyncio.get_running_loop()
        try:
            while True:
                data = await loop.sock_recv(shard.ctl, 65536)
                if not data:
                    break
                try:
                    msg = json.loads(data)
                except ValueError:
                    continue
                op = msg.get("op")
                if op == "fail":
                    self._peer_failed(
                        shard, msg.get("slot"),
                        msg.get("reason", "send_failed"),
                    )
                elif op == "stats":
                    self._note_stats(shard, msg)
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
        except asyncio.CancelledError:
            raise
        if not self._stopping and shard.alive:
            await self._worker_down(shard)

    def _peer_failed(self, shard: _Shard, slot, reason: str) -> None:
        uuid = shard.slots.pop(slot, None)
        if uuid is None:
            return
        shard.peers.pop(uuid, None)
        if self.metrics is not None:
            self.metrics.inc("delivery.peer_failures")
        if self.on_peer_lost is not None:
            self.on_peer_lost(uuid, reason)

    def _note_stats(self, shard: _Shard, msg: dict) -> None:
        prev = shard.stats
        shard.stats_at = time.monotonic()
        if self.metrics is not None:
            for key in ("deliveries", "sends_ok", "send_errors", "bytes"):
                delta = int(msg.get(key, 0)) - int(prev.get(key, 0))
                if delta > 0:
                    self.metrics.inc(f"delivery.{key}", delta)
            if msg.get("drain_ms") and msg.get("drain_ms") != prev.get(
                "drain_ms"
            ):
                self.metrics.observe_ms(
                    "delivery.worker_drain_ms", float(msg["drain_ms"])
                )
            # cumulative worker histograms → registry deltas: the
            # per-worker series (delivery.worker.<i>.e2e_ms) plus the
            # aggregates the SLO reads (delivery.e2e_ms, frame.e2e_ms).
            # Restarted workers re-zero their cumulatives AND their
            # prev packet (stats reset in _bring_up), so merged counts
            # only ever grow — no counter-reset sawtooth in /metrics.
            self._merge_hist(
                msg.get("e2e"), prev.get("e2e"),
                (f"delivery.worker.{shard.idx}.e2e_ms", "delivery.e2e_ms"),
            )
            self._merge_hist(
                msg.get("frame_e2e"), prev.get("frame_e2e"),
                ("frame.e2e_ms",),
            )
        for seg in msg.get("segments", ()):
            try:
                t_write, dwell_ms, write_ms, n_slots, slow_slot, slow_ms = seg
            except (TypeError, ValueError):
                continue
            self._segments.append((
                shard.idx, int(t_write), float(dwell_ms), float(write_ms),
                int(n_slots), int(slow_slot), float(slow_ms),
            ))
        fp = msg.get("fp")
        if fp:
            prev_fp = prev.get("fp") or {}
            deltas = {
                name: int(n) - int(prev_fp.get(name, 0))
                for name, n in fp.items()
            }
            failpoints.registry.note_remote_fires(deltas)
        shard.stats = msg

    def _merge_hist(self, cur, prev, names: tuple) -> None:
        """Diff one cumulative worker histogram against the previous
        packet and merge the delta under every name in ``names``."""
        if not isinstance(cur, dict) or "counts" not in cur:
            return
        prev_counts = (prev or {}).get("counts") or []
        counts = cur["counts"]
        deltas = [
            int(c) - int(prev_counts[i]) if i < len(prev_counts) else int(c)
            for i, c in enumerate(counts)
        ]
        if any(d < 0 for d in deltas):
            # torn/restarted baseline — treat the packet as a fresh
            # start rather than subtracting into negatives
            deltas = [int(c) for c in counts]
            prev = None
        d_total = sum(deltas)
        d_sum = float(cur.get("sum_ms", 0.0)) - float(
            (prev or {}).get("sum_ms", 0.0)
        )
        max_ms = float(cur.get("max_ms", 0.0))
        for name in names:
            self.metrics.merge_histogram(
                name, deltas, d_total, max(d_sum, 0.0), max_ms
            )

    async def _worker_down(self, shard: _Shard) -> None:
        """Crash containment: evict the shard's peers (authoritative
        map stays consistent), reclaim the ring lane, then restart with
        backoff within budget — or retire the shard (degrade)."""
        logger.critical(
            "delivery worker %d died (restarts so far: %d)",
            shard.idx, shard.restarts,
        )
        if self.metrics is not None:
            self.metrics.inc("delivery.worker_deaths")
        # healthy-run refund BEFORE charging this death
        if shard.born and time.monotonic() - shard.born >= HEALTHY_RUN_S:
            shard.restarts = 0
        lost = list(shard.peers)
        shard.peers.clear()
        shard.slots.clear()
        self._teardown(shard)
        if self.on_peer_lost is not None:
            for uuid in lost:
                self.on_peer_lost(uuid, "worker_lost")
        if self._stopping:
            return
        if shard.restarts >= self._budget:
            shard.retired = True
            logger.critical(
                "delivery worker %d exhausted its restart budget (%d) — "
                "shard retired; new peers adopt onto surviving shards "
                "or fall back to the in-process pump", shard.idx,
                self._budget,
            )
            if self.metrics is not None:
                self.metrics.inc("delivery.workers_retired")
            return
        shard.restarts += 1
        shard.gen += 1
        delay = min(self._backoff * (2 ** (shard.restarts - 1)), 30.0)
        logger.warning(
            "restarting delivery worker %d in %.2fs (attempt %d/%d)",
            shard.idx, delay, shard.restarts, self._budget,
        )
        await asyncio.sleep(delay)
        if self._stopping:
            return
        try:
            await self._bring_up(shard)
            logger.info("delivery worker %d restarted", shard.idx)
        except Exception:
            logger.exception(
                "delivery worker %d failed to restart — retrying the "
                "death path", shard.idx,
            )
            await self._worker_down(shard)

    # endregion

    # region: peer adoption / release

    def _pick_shard(self) -> _Shard | None:
        live = [s for s in self._shards if s.alive]
        if not live:
            return None
        return min(live, key=lambda s: len(s.peers))

    def adopt(self, peer, *, fd: int | None = None,
              endpoint: str | None = None) -> bool:
        """Hand a freshly-handshaken peer to a sender worker and rebind
        its write paths onto the owning ring. ``fd`` (WS: the raw TCP
        socket, dup'd by the kernel on passing) XOR ``endpoint`` (ZMQ:
        the connect-back address). False = no live worker (degraded) —
        the caller keeps the peer on the in-process path."""
        shard = self._pick_shard()
        if shard is None:
            return False
        slot = shard.next_slot
        shard.next_slot += 1
        msg = {"op": "add", "slot": slot,
               "kind": "ws" if fd is not None else "zmq"}
        if endpoint is not None:
            msg["endpoint"] = endpoint
        if not self._ctl_send(shard, msg, fds=[fd] if fd is not None else None):
            return False
        shard.peers[peer.uuid] = slot
        shard.slots[slot] = peer.uuid
        peer.shard, peer.slot = shard.idx, slot
        slot_le = struct.pack("<I", slot)

        def try_write(framed, _s=shard, _slot=slot_le):
            return self._submit(_s, framed.payload, _slot)

        def try_write_many(framed_list, _s=shard, _slot=slot_le):
            # not all-or-nothing like a transport buffer: each frame
            # commits independently, so a mid-list ring-full DROPS the
            # remainder (counted) instead of returning False — a
            # False here would make the caller re-send the whole list
            # and duplicate the committed prefix
            for framed in framed_list:
                self._submit(_s, framed.payload, _slot)
            return True

        async def send_raw(data, _s=shard, _slot=slot_le):
            if not await self._asubmit(_s, data, _slot):
                raise ConnectionError(
                    "delivery shard unavailable (worker down or ring "
                    "saturated)"
                )

        peer._try_write = try_write
        peer._try_write_many = try_write_many
        peer._send_raw = send_raw
        if self.metrics is not None:
            self.metrics.inc("delivery.peers_adopted")
        return True

    def release(self, uuid: uuid_mod.UUID) -> None:
        """PeerMap removal hook: the worker closes its end."""
        for shard in self._shards:
            slot = shard.peers.pop(uuid, None)
            if slot is not None:
                shard.slots.pop(slot, None)
                if shard.alive:
                    self._ctl_send(shard, {"op": "remove", "slot": slot})
                return

    # endregion

    # region: frame submission

    def _count_drop(self, n: int = 1) -> None:
        self.ring_drops += n
        if self.metrics is not None:
            self.metrics.inc("delivery.ring_full_drops", n)

    def _submit(self, shard: _Shard, frame, slots_le: bytes,
                t_ingress_ns: int = 0) -> bool:
        """Sync fast path (PeerMap broadcast try_write): bounded spin
        then drop — the event loop must never wedge on a slow shard."""
        if not shard.alive or shard.ring is None:
            return False
        try:
            # chaos site: `error` behaves as an instantly-full ring
            # (caller falls back / drops, counted), `delay` models a
            # congested producer
            failpoints.fire("delivery.ring_write")
        except FailpointError:
            return False
        ring = shard.ring
        if Ring.record_size(len(frame), len(slots_le) // 4) > ring.cap:
            self._count_drop()
            return True  # oversized for any retry — swallow, counted
        if ring.try_write(frame, slots_le, t_ingress_ns):
            self.frames_submitted += 1
            return True
        deadline = time.perf_counter() + SYNC_WAIT_S
        while time.perf_counter() < deadline:
            time.sleep(0.0002)
            if ring.try_write(frame, slots_le, t_ingress_ns):
                self.frames_submitted += 1
                return True
        return False  # caller falls back to the awaited path

    async def _asubmit(self, shard: _Shard, frame, slots_le: bytes,
                       t_ingress_ns: int = 0) -> bool:
        """Async batch path: yields to the loop while the ring drains;
        bounded so a wedged worker degrades (drop + count) instead of
        stalling the tick pipeline."""
        if not shard.alive or shard.ring is None:
            return False
        try:
            await failpoints.afire("delivery.ring_write")
        except FailpointError:
            self._count_drop()
            return False
        ring = shard.ring
        if Ring.record_size(len(frame), len(slots_le) // 4) > ring.cap:
            self._count_drop()
            return True
        if ring.try_write(frame, slots_le, t_ingress_ns):
            self.frames_submitted += 1
            return True
        deadline = time.perf_counter() + ASYNC_WAIT_S
        while time.perf_counter() < deadline:
            await asyncio.sleep(0.001)
            if not shard.alive or shard.ring is not ring:
                # the worker died (or restarted onto a fresh ring)
                # while we waited — the captured ring is torn down
                return False
            if ring.try_write(frame, slots_le, t_ingress_ns):
                self.frames_submitted += 1
                return True
        self._count_drop()
        return False

    async def deliver(
        self, groups: dict[int, tuple[bytes, array]],
        t_ingress_ns: int = 0,
    ) -> int:
        """One message's fan-out: ``{shard_idx: (frame, slot_array)}``
        — the frame is written ONCE per shard regardless of the slot
        count (the serialize-once discipline extended across the
        process boundary). ``t_ingress_ns`` is the frame clock the
        owning worker closes at socket-write-complete. Returns sends
        attempted."""
        n = 0
        for shard_idx, (frame, slots) in groups.items():
            shard = self._shards[shard_idx]
            n += len(slots)
            if not await self._asubmit(
                shard, frame, slots.tobytes(), t_ingress_ns
            ):
                self._count_drop(len(slots))
                if self.on_frame_drop is not None:
                    for slot in slots:
                        u = shard.slots.get(slot)
                        if u is not None:
                            self.on_frame_drop(u)
        return n

    # endregion

    # region: introspection

    def stats_age_s(self, idx: int) -> float | None:
        """Seconds since the worker's last stats push (None when the
        shard is down/retired — deadness is its own signal)."""
        shard = self._shards[idx] if idx < len(self._shards) else None
        if shard is None or not shard.alive:
            return None
        return max(0.0, time.monotonic() - shard.stats_at)

    def _stale_workers(self) -> int:
        """Alive-but-silent workers: the control-channel stats push
        stopped for > STATS_STALE_INTERVALS intervals. A wedged drain
        loop (e.g. a multi-second blocking send) looks exactly like
        this — alive process, no progress."""
        horizon = STATS_STALE_INTERVALS * STATS_INTERVAL
        return sum(
            1 for s in self._shards
            if s.alive and time.monotonic() - s.stats_at > horizon
        )

    def degraded(self) -> bool:
        return (
            any(s.retired or not s.alive for s in self._shards)
            or self._stale_workers() > 0
        )

    def alive_workers(self) -> int:
        return sum(1 for s in self._shards if s.alive)

    def stats(self) -> dict:
        return {
            "workers": self.n_workers,
            "alive": self.alive_workers(),
            "retired": sum(1 for s in self._shards if s.retired),
            "restarts": sum(s.restarts for s in self._shards),
            "peers": sum(len(s.peers) for s in self._shards),
            "frames_submitted": self.frames_submitted,
            "ring_full_drops": self.ring_drops,
            "stats_stale": self._stale_workers(),
        }

    def worker_stats(self, idx: int) -> dict:
        """Per-worker numeric leaves for the ``delivery.worker.<i>``
        gauge (flattened into /metrics by render_prometheus)."""
        shard = self._shards[idx] if idx < len(self._shards) else None
        if shard is None:
            return {}
        age = self.stats_age_s(idx)
        out = {
            "alive": int(shard.alive),
            "retired": int(shard.retired),
            "restarts": shard.restarts,
            "peers": len(shard.peers),
            "ring_pending_bytes": (
                shard.ring.pending_bytes()
                if shard.alive and shard.ring is not None else 0
            ),
            "stats_age_s": round(age, 3) if age is not None else -1.0,
        }
        for key in ("records", "deliveries", "sends_ok", "send_errors",
                    "bytes", "evictions"):
            if key in shard.stats:
                out[key] = int(shard.stats[key])
        return out

    def stitch(self, trace) -> list[dict]:
        """Flight-recorder stitcher: synthesize ``delivery.worker_flush``
        child spans under a tick trace's ``tick.deliver`` from the
        worker-reported segments whose ring-write stamp falls inside
        the deliver window. Ring-write stamps are CLOCK_MONOTONIC ns
        and trace span clocks are ``perf_counter`` seconds — the same
        clock on Linux, so the windows align without translation (on a
        platform where they differ, segments simply fail to match and
        the trace degrades to parent-side spans only)."""
        with trace._lock:
            deliver = [s for s in trace.spans if s.name == "tick.deliver"]
        if not deliver or not self._segments:
            return []
        out: list[dict] = []
        base = trace.perf_start
        for ds in deliver:
            w0 = ds.t0 - 1e-4
            w1 = ds.t0 + ds.dur_ms / 1e3 + 1e-4
            for (worker, t_write, dwell_ms, write_ms, n_slots,
                 slow_slot, slow_ms) in self._segments:
                t_write_s = t_write / 1e9
                if not (w0 <= t_write_s <= w1):
                    continue
                tags = {
                    "worker": worker,
                    "ring_dwell_ms": dwell_ms,
                    "write_ms": write_ms,
                    "slots": n_slots,
                }
                if slow_slot >= 0:
                    tags["slowest_slot"] = slow_slot
                    tags["slowest_send_ms"] = slow_ms
                out.append({
                    # negative ids: synthetic spans can never collide
                    # with the trace's own monotonically-positive ids
                    "id": -(len(out) + 1),
                    "parent": ds.id,
                    "name": "delivery.worker_flush",
                    "t0_ms": round((t_write_s - base) * 1e3, 3),
                    "dur_ms": round(dwell_ms + write_ms, 3),
                    "tags": tags,
                    "thread": f"delivery-worker-{worker}",
                })
        return out

    # endregion
