"""Tick batcher: the per-tick device batch at the heart of the rebuild.

The reference resolves every LocalMessage the moment it arrives — one
HashMap probe and one broadcast per message under a global lock
(SURVEY §3.2). With ``tick_interval > 0`` this module instead collects
a tick's worth of LocalMessages and resolves them as ONE device batch
(SpatialBackend.dispatch/collect), then delivers each message's fan-out
in arrival order. Trade: up to one tick of added latency buys
per-batch instead of per-message device cost — the design the
1M-entity target requires (BASELINE.json north star).

Overlap: the dispatch (which reads loop-owned state) runs on the event
loop; the device wait + UUID decode run on a worker thread, so the loop
keeps serving transports while the device crunches. A full queue
(``max_batch``) flushes early. ``tick_interval == 0`` keeps the
reference-equivalent immediate path and never constructs this class.

Pipelining (``pipeline`` > 1): ``flush`` splits into a
dispatch stage (on the loop, launches the device batch) and a
collect+deliver stage (a background task: device wait on a worker
thread, then the batched delivery). With the default depth 2 at most
ONE tick is in flight while the next accumulates and dispatches — tick
N+1's device work overlaps tick N's D2H fetch and delivery drain. The
stage tasks CHAIN (each awaits its predecessor before delivering), so
per-peer arrival order is exactly the sequential path's, and ``stop``
awaits the chain instead of cancelling it — the shield/re-queue
guarantees of the sequential flush carry over unchanged.
``pipeline == 1`` (the default) keeps the sequential flush byte for
byte.

Overload governance (``--overload on``): with a governor
attached, ``enqueue`` never awaits — a full queue signals the pump
(``_flush_request``) instead of flushing inline, so a slow device
collect cannot head-of-line-block the transport recv loop; admission
(drop-oldest past ``local_queue_cap``) is the only shedding on that
path. Flushes take at most the governor's admitted batch tier, tick
walls feed its deadline-degradation counters, and the entity
neighbor-frame leg skips every other tick while degraded. Without a
governor (the default) every one of those paths is byte-for-byte
today's behavior.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque

from ..observability.spans import NULL_TRACE, Tracer
from ..queries.kinds import KIND_DENSITY, kind_by_id
from ..queries.results import KindResult
from ..queries.wire import build_reply
from ..robustness import failpoints
from ..spatial.backend import LocalQuery, SpatialBackend
from ..protocol.types import Message
from .peers import PeerMap

logger = logging.getLogger(__name__)


class TickBatcher:
    def __init__(
        self,
        backend: SpatialBackend,
        peer_map: PeerMap,
        interval: float,
        max_batch: int = 16_384,
        metrics=None,
        pipeline: int = 1,
        supervisor=None,
        tracer: Tracer | None = None,
        device_telemetry=None,
        staging=None,
        entity_plane=None,
        governor=None,
        cluster=None,
        heatmap=None,
    ):
        self.backend = backend
        # Optional queries.heatmap.RegionHeatmap: density-query results
        # feed it as they fold out of each tick (the wql_region_density
        # gauge and GET /debug/heatmap read it)
        self._heatmap = heatmap
        self.peer_map = peer_map
        self.interval = interval
        self.max_batch = max_batch
        self.metrics = metrics
        # Optional entities.EntityPlane (--entity-sim): every flush
        # ALSO advances the simulation one tick — dispatch on the loop
        # (tick.sim.integrate), device wait + fetch on the worker
        # thread (tick.sim.knn), index churn + frame assembly back on
        # the loop (tick.sim.apply) — and the neighbor frames join the
        # tick's batched delivery. A flush with an empty query batch
        # still ticks the simulation. Sim failures drop only that sim
        # tick, never the flush.
        self._entity_plane = entity_plane
        # Optional engine.staging.QueryStaging: enqueue writes each
        # query into preallocated columnar arrays (interned at arrival
        # time), and flush dispatches the flipped buffer through
        # backend.dispatch_staged_batch with ZERO per-query Python —
        # the encode leg moves off the tick's critical path. None (the
        # default, and always for backends without staged dispatch)
        # keeps the object-list path byte for byte.
        self._staging = staging
        self.staged_flushes = 0
        self.staging_fallbacks = 0
        # Optional robustness.overload.OverloadGovernor (--overload on):
        # enqueue becomes NONBLOCKING (signal the pump instead of
        # awaiting a flush — the admission decision, drop-oldest past
        # local_queue_cap, is the only thing that can shed work on the
        # recv path), flushes take at most the admitted batch tier,
        # each tick wall feeds the deadline-degradation counters, and
        # entity neighbor-frame fan-out skips every other tick while
        # the tier is degraded. None (the default) keeps today's
        # behavior byte for byte, including the size-triggered inline
        # flush and its backpressure.
        self._governor = governor
        # staged columns go stale the moment admission drops or splits
        # the queue (rows no longer line up with queued messages);
        # the flag stops further appends until the next resync/swap
        self._staging_desynced = False
        # Optional cluster.shard.ClusterShardExtension (--cluster-role
        # shard): every flush drains the inter-shard rings BETWEEN the
        # local batch's device dispatch and its collect — the
        # cross-shard collective hides behind the in-flight device
        # window (``cluster.drain`` span) instead of serializing in
        # front of it. None (the default) costs one attribute test per
        # flush.
        self._cluster = cluster
        # Optional observability.device.DeviceTelemetry: after each
        # collect it tags the tick trace with the device timing split
        # (encode/h2d/compute/d2h) and polls the retrace GUARD so a
        # capacity-tier first hit surfaces as a counter + loose span
        # the same tick it happened.
        self._device_telemetry = device_telemetry
        # Span tracing (observability/): every flush opens a "tick"
        # trace whose stage spans the flight recorder ring-buffers.
        # A disabled (or absent) tracer hands back shared null objects
        # — the overhead is one branch per FLUSH, never per message.
        self._tracer = tracer if tracer is not None else Tracer()
        self._tick_seq = 0
        # Optional robustness.Supervisor: the pump runs as a CRITICAL
        # supervised task (restart with backoff; escalate to clean
        # shutdown on budget exhaustion — a server that stopped ticking
        # is deaf to its whole LocalMessage workload), and pipeline
        # stages spawn crash-contained.
        self._sup = supervisor
        self._handle = None
        self.pipeline = max(1, int(pipeline))
        self._queue: deque[tuple[Message, LocalQuery]] = deque()
        self._task: asyncio.Task | None = None
        self._flushing = asyncio.Lock()
        # size-triggered flush request: enqueue SETS it at max_batch
        # and the pump wakes immediately — hitting the cap mid-message
        # must never await a full device flush from inside the recv
        # path (head-of-line blocking)
        self._flush_request = asyncio.Event()
        # pipelined collect+deliver stages: _inflight caps the depth,
        # _tail is the chain head the NEXT stage must wait out before
        # delivering (arrival-order guarantee across ticks)
        self._inflight: deque[asyncio.Task] = deque()
        self._tail: asyncio.Task | None = None
        # stats (exposed via metrics)
        self.ticks = 0
        self.messages = 0
        self.last_batch = 0
        self.last_tick_ms = 0.0
        self.last_resolve_ms = 0.0   # dispatch + device/backend collect
        self.last_deliver_ms = 0.0   # PeerMap.deliver_batch
        self.last_dispatch_ms = 0.0  # host encode + device launch
        self.last_collect_ms = 0.0   # device wait + UUID decode
        self.last_compaction_bucket = 0
        # PeerMap.bytes_delivered high-water at the last _account —
        # diffed into the delivery.bytes_per_tick gauge
        self._bytes_mark = 0

    def start(self) -> None:
        if self._sup is not None:
            self._handle = self._sup.spawn(
                "tick-batcher", self._run, critical=True
            )
            return
        self._task = asyncio.create_task(self._run(), name="tick-batcher")  # wql: allow(unsupervised-task)

    async def stop(self) -> None:
        if self._handle is not None:
            await self._handle.stop()
            self._handle = None
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        await self.flush()  # drain in-flight stages + whatever is left
        while self._queue:
            # governed flushes take at most the admitted tier — keep
            # draining until the queue is empty (progress guaranteed:
            # every flush takes >= min_batch >= 1)
            await self.flush()

    def inflight(self) -> int:
        """Dispatched-but-undelivered ticks right now (gauge)."""
        return len(self._inflight)

    async def enqueue(self, message: Message, query: LocalQuery) -> None:
        gov = self._governor
        if gov is not None:
            # Governed ingest (--overload on): NEVER await a flush
            # here — signal the pump and return, so a slow device
            # collect cannot head-of-line-block the transport recv
            # loop. The admission decision is the only shedding:
            # past local_queue_cap the OLDEST queued query drops
            # (the newest position is the freshest work).
            if len(self._queue) >= gov.local_queue_cap():
                self._queue.popleft()
                gov.note_drop_oldest()
                self._staging_desynced = True
            self._queue.append((message, query))  # wql: allow(unbounded-ingest) — capped by local_queue_cap above
            if self._staging is not None and not self._staging_desynced:
                self._staging.append(query)
            gov.note_queue_depth(len(self._queue))
            if len(self._queue) >= self.max_batch:
                self._flush_request.set()
            return
        self._queue.append((message, query))  # wql: allow(unbounded-ingest) — legacy ungoverned path: size cap flushes inline below
        if self._staging is not None:
            # enqueue-time encode: intern + write one staging row NOW,
            # amortized across the tick window; the query object rides
            # the queue purely as the fallback/requeue safety net
            self._staging.append(query)
        if len(self._queue) >= self.max_batch:
            if self.pipeline > 1:
                await self.flush_pipelined()
            else:
                await self.flush()

    async def _run(self) -> None:
        while True:
            # the timer OR a size-triggered flush request, whichever
            # lands first — a full queue flushes immediately without
            # the recv path ever blocking on it
            try:
                await asyncio.wait_for(
                    self._flush_request.wait(), timeout=self.interval
                )
            except asyncio.TimeoutError:
                pass
            self._flush_request.clear()
            # deliberately OUTSIDE the containment below: an armed
            # `ticker.pump` failpoint kills the pump itself, which is
            # how the chaos suite drives supervisor restart/escalation
            failpoints.fire("ticker.pump")
            try:
                if self.pipeline > 1:
                    await self.flush_pipelined()
                else:
                    await self.flush()
            except Exception:
                logger.exception("tick flush failed — batch dropped")

    # region: entity-sim stages (--entity-sim)

    def _sim_dispatch(self, trace):
        """Launch the simulation tick (event-loop thread). Returns the
        collect handle, or None when the plane is idle, a previous sim
        tick is still in flight (pipelined flushes never stack sim
        ticks), or the dispatch failed (logged; the flush proceeds)."""
        plane = self._entity_plane
        if plane is None or not plane.active():
            return None
        try:
            with trace.span("tick.sim.integrate"):
                return plane.dispatch_tick()
        except Exception:
            logger.exception("entity sim dispatch failed — sim tick skipped")
            return None

    def _frame_skip(self, sim_handle) -> bool:
        """The governed frame-leg degradation decision for this tick.
        An interest-managed plane NEVER blind-skips: the governor's
        shed level widens the far-tier cadence (lossless deferral) via
        ``note_governor`` instead — the earlier alternate-tick drop
        generalized into a cadence policy. Ungoverned or
        interest-off paths keep ``take_frame_skip`` byte for byte."""
        gov = self._governor
        if gov is None or sim_handle is None:
            return False
        plane = self._entity_plane
        interest = getattr(plane, "interest", None)
        if interest is not None:
            interest.note_governor(gov.level, gov.degraded())
            return False
        return gov.take_frame_skip()

    async def _sim_collect_apply(self, sim_handle, trace,
                                 skip_frames: bool = False) -> list:
        """Wait out the sim tick on a worker thread, then integrate it
        back into the host authority on the loop. Returns the tick's
        neighbor-frame delivery pairs; a failed sim tick aborts cleanly
        (host columns stay authoritative) and returns [].
        ``skip_frames`` (deadline degradation) applies the tick —
        positions and index churn always advance — but sheds the
        neighbor-frame fan-out leg."""
        plane = self._entity_plane
        try:
            with trace.span("tick.sim.knn"):
                result = await asyncio.to_thread(
                    plane.collect_tick, sim_handle
                )
            with trace.span("tick.sim.apply"):
                pairs = plane.apply(result, trace, skip_frames=skip_frames)
            interest = plane.interest
            if interest is not None and self.metrics is not None:
                st = interest.stats()
                self.metrics.set_gauge(
                    "frame.delta_ratio", st["delta_ratio"]
                )
                self.metrics.set_gauge("lod", {
                    "near": st["near"], "far": st["far"],
                    "demoted": st["demoted"],
                    "far_every_k": st["far_every_k"],
                })
            return pairs
        except asyncio.CancelledError:
            plane.abort_tick()
            raise
        except Exception:
            plane.abort_tick()
            logger.exception("entity sim tick failed — sim frames dropped")
            return []

    def _take_batch(self) -> list:
        """Drain the pending queue for one flush. Ungoverned: the
        whole queue, exactly as before. Governed: at most the admitted
        batch tier — the remainder stays queued and the pump is
        re-signalled, so a degraded tier serves smaller, deadline-
        fitting ticks instead of one giant bust."""
        queue = self._queue
        gov = self._governor
        if gov is not None:
            admitted = gov.admitted_batch
            if admitted < len(queue):
                batch = [queue.popleft() for _ in range(admitted)]
                self._flush_request.set()  # backlog remains
                return batch
        batch = list(queue)
        queue.clear()
        return batch

    # endregion

    # region: pipelined flush (pipeline > 1)

    async def flush_pipelined(self) -> None:
        """Dispatch everything queued and hand collect+delivery to a
        chained background stage, keeping at most ``pipeline`` ticks
        dispatched-but-undelivered: tick N+1 accumulates and launches
        while tick N's collect runs on the worker thread and its
        delivery drains. A dispatch failure drops the batch (same
        contract as the sequential path's _run handler)."""
        self._reap()
        async with self._flushing:
            batch = self._take_batch()
            plane = self._entity_plane
            sim_on = plane is not None and plane.active()
            if not batch and not sim_on:
                if self._cluster is not None:
                    await self._cluster.drain()
                if self._governor is not None:
                    # idle windows are healthy samples — the governor's
                    # road back to OK once load drops
                    self._governor.note_idle(len(self._queue))
            if batch or sim_on:
                trace = self._begin_trace(len(batch))
                t0 = time.perf_counter()
                # frame clock: opened at flush start (the accumulation
                # window is a config choice, not pipeline latency),
                # closed at delivery completion on whichever path
                t_ingress_ns = time.monotonic_ns()
                sim_handle = self._sim_dispatch(trace)
                skip_frames = self._frame_skip(sim_handle)
                handle = None
                if batch:
                    try:
                        with trace.span("tick.dispatch"):
                            handle = self._dispatch_batch(batch)
                            self.last_dispatch_ms = (
                                time.perf_counter() - t0
                            ) * 1e3
                            if self.metrics is not None:
                                self.metrics.observe_ms(
                                    "tick.dispatch_ms",
                                    self.last_dispatch_ms,
                                )
                    except BaseException:
                        if sim_handle is not None:
                            # the stage task never spawns — release
                            # the un-applied sim tick
                            plane.abort_tick()
                        raise
                if self._cluster is not None:
                    # between dispatch and the stage's collect — the
                    # device window — serialized under the flushing
                    # lock so pipelined stages never interleave drains
                    with trace.span("cluster.drain") as dspan:
                        dspan.tag(frames=await self._cluster.drain())
                stage = self._collect_deliver(
                    batch, handle, self._tail, t0, trace, t_ingress_ns,
                    sim_handle, skip_frames,
                )
                if self._sup is not None:
                    task = self._sup.spawn_transient("tick-collect", stage)
                else:
                    task = asyncio.create_task(stage, name="tick-collect")  # wql: allow(unsupervised-task)
                self._tail = task
                self._inflight.append(task)
        if self.metrics is not None:
            self.metrics.set_gauge(
                "tick.pipeline_inflight", len(self._inflight)
            )
        # backpressure: wait out the oldest stage once the pipeline is
        # full — after this, at most pipeline-1 ticks remain in flight
        # (pipeline=2: one tick overlaps the next accumulation window)
        while len(self._inflight) >= 1 + self.pipeline:
            await self._await_quiet(self._inflight[0])
            self._reap()

    async def _collect_deliver(self, batch, handle, prev, t0, trace,
                               t_ingress_ns: int = 0,
                               sim_handle=None,
                               skip_frames: bool = False) -> None:
        """Stage 2 of a pipelined tick: device collect (worker thread),
        then — strictly after tick N-1's stage finished — the batched
        delivery. Handles its own errors (a failed collect drops only
        ITS batch; the next tick's stage runs untouched) and is never
        cancelled by stop(), which awaits the chain instead."""
        try:
            await self._collect_deliver_inner(
                batch, handle, prev, t0, trace, t_ingress_ns, sim_handle,
                skip_frames,
            )
        finally:
            trace.finish()  # idempotent; seals drop/error paths too

    async def _collect_deliver_inner(
        self, batch, handle, prev, t0, trace, t_ingress_ns: int = 0,
        sim_handle=None, skip_frames: bool = False,
    ) -> None:
        targets = None
        if handle is not None:
            try:
                tc = time.perf_counter()
                with trace.span("tick.collect"):
                    targets = await asyncio.to_thread(
                        self.backend.collect_local_batch, handle
                    )
                    self.last_collect_ms = (time.perf_counter() - tc) * 1e3
                    if self.metrics is not None:
                        self.metrics.observe_ms(
                            "tick.collect_ms", self.last_collect_ms
                        )
                self._note_collect_stats(trace)
            except Exception:
                logger.exception("tick collect failed — batch dropped")
        # entity-sim stage: wait out the sim tick and fold it back into
        # the host authority; its neighbor frames join this tick's
        # batched delivery below. Runs before wait_prev so sim work
        # overlaps the predecessor's delivery drain.
        sim_pairs = []
        if sim_handle is not None:
            sim_pairs = await self._sim_collect_apply(
                sim_handle, trace, skip_frames
            )
        # Arrival order across ticks: tick N-1's deliveries must all
        # complete before ours start — even when our collect finished
        # first (worker threads overlap). Ride out cancellation: the
        # predecessor's delivery is owed regardless.
        if prev is not None:
            with trace.span("tick.wait_prev"):
                while not prev.done():
                    try:
                        await asyncio.shield(prev)
                    except (asyncio.CancelledError, Exception):
                        continue
        if targets is None and not sim_pairs:
            return
        try:
            pairs = self._build_pairs(batch, targets or [])
            pairs.extend(sim_pairs)
            # awaited in place below (shield loop) — not a dangling
            # loop, so it rides outside the supervisor
            deliver_task = asyncio.ensure_future(  # wql: allow(unsupervised-task)
                self.peer_map.deliver_batch(pairs, t_ingress_ns)
            )
            td = time.perf_counter()
            # same shield-and-re-await discipline as the sequential
            # flush: a cancellation must not abort the delivery tail
            # half-sent (fast-path frames are already in transport
            # buffers; re-sending would duplicate)
            with trace.span("tick.deliver"):
                while not deliver_task.done():
                    try:
                        await asyncio.shield(deliver_task)
                    except asyncio.CancelledError:
                        continue
                    except Exception:
                        logger.exception("tick delivery failed")
                        break
            if self._cluster is not None and pairs:
                # close the router-ingress clock (cluster.e2e_ms) for
                # every delivered frame carrying a trace context —
                # socket-write-complete, the conservative close
                self._cluster.close_frames(m for m, _ in pairs)
            self._account(
                batch, t0, deliver_ms=(time.perf_counter() - td) * 1e3,
                trace=trace,
            )
        except Exception:
            logger.exception("tick delivery failed — batch dropped")

    def _build_pairs(self, batch, targets) -> list:
        """One tick's delivery pairs. Radius rows pair the original
        message with its fan-out list, exactly as before. Kind rows
        (query library) come back as :class:`KindResult` — each pairs a
        freshly built reply frame (queries/wire.py) with the REQUESTING
        peer, an empty result included (the sender is owed an answer
        either way) — and density rows additionally feed the region
        heatmap. Collect-side per-query list assembly is the existing
        contract; the dispatch path stays loop-free."""
        heatmap = self._heatmap
        pairs = []
        for (message, query), tgts in zip(batch, targets):
            if isinstance(tgts, KindResult):
                kind = kind_by_id(tgts.kind)
                if kind is None:  # unregistered kind staged: reply owed
                    continue  # to nobody — drop, the lint rule guards this
                pairs.append(
                    (build_reply(message, kind, tgts), [query.sender])
                )
                if self.metrics is not None:
                    self.metrics.inc("queries.kind_replies")
                if heatmap is not None and tgts.kind == KIND_DENSITY:
                    heatmap.record(
                        query.world, tgts.extra.get("cubes", ())
                    )
            elif tgts:
                pairs.append((message, tgts))
        return pairs

    def _dispatch_batch(self, batch):
        """Launch one tick's batch: the staged columnar path when the
        staging window is intact (zero per-query Python at flush —
        interning already happened at enqueue), the object-list path
        otherwise. A desynced window (a cancelled flush re-queued its
        batch, so queue and columns disagree) or a stale interning
        epoch (a resilience rebuild swapped the backend's dicts
        mid-window) takes ONE list-path dispatch from the retained
        query objects and resyncs — staging is an optimization, never
        a correctness dependency."""
        st = self._staging
        if st is not None:
            if (
                not self._staging_desynced
                and st.count == len(batch)
                and st.epoch_ok()
            ):
                cols = st.swap()
                self.staged_flushes += 1
                if self.metrics is not None:
                    self.metrics.inc("tick.staged_flushes")
                return self.backend.dispatch_staged_batch(
                    *cols, fallback=batch
                )
            st.resync()
            self._staging_desynced = False
            self.staging_fallbacks += 1
            if self.metrics is not None:
                self.metrics.inc("tick.staging_fallbacks")
        return self.backend.dispatch_local_batch(
            [query for _, query in batch]
        )

    def _reap(self) -> None:
        while self._inflight and self._inflight[0].done():
            self._inflight.popleft()

    @staticmethod
    async def _await_quiet(task: asyncio.Task) -> None:
        """Wait for a stage task without cancelling it and without
        letting its (already-logged) errors escape. Our own
        cancellation propagates once the task is done — the in-flight
        batch is owed its delivery first."""
        cancelled = False
        while not task.done():
            try:
                await asyncio.shield(task)
            except asyncio.CancelledError:
                cancelled = True
            except Exception:
                break
        if cancelled:
            raise asyncio.CancelledError

    async def _drain_inflight(self) -> None:
        while self._inflight:
            await self._await_quiet(self._inflight[0])
            self._reap()

    # endregion

    async def flush(self, *, sim: bool = True) -> None:
        """Resolve and deliver everything queued so far. Serialized so a
        size-triggered flush can't interleave with the timer's. In
        pipelined mode any in-flight stage is waited out FIRST, so the
        drained queue delivers after it (stop()'s exactly-once drain
        keeps cross-tick arrival order). ``sim=False`` runs no
        simulation tick: a cluster shard's freeze fence owes the queued
        messages their delivery, not a sim step off the timer's
        cadence."""
        await self._drain_inflight()
        async with self._flushing:
            batch = self._take_batch()
            plane = self._entity_plane
            sim_on = sim and plane is not None and plane.active()
            if not batch and not sim_on:
                if not sim:
                    return  # nothing queued, and no tick window
                if self._cluster is not None:
                    # no local work this window — the inter-shard
                    # rings still owe their drain on the tick clock
                    await self._cluster.drain()
                if self._governor is not None:
                    self._governor.note_idle(len(self._queue))
                return
            trace = self._begin_trace(len(batch))
            t0 = time.perf_counter()
            t_ingress_ns = time.monotonic_ns()  # frame clock (see above)

            dispatched = not batch
            deliver_task = None
            sim_handle = self._sim_dispatch(trace) if sim_on else None
            skip_frames = self._frame_skip(sim_handle)
            try:
                targets = []
                if batch:
                    td = time.perf_counter()
                    with trace.span("tick.dispatch"):
                        handle = self._dispatch_batch(batch)
                        self.last_dispatch_ms = (
                            time.perf_counter() - td
                        ) * 1e3
                        if self.metrics is not None:
                            self.metrics.observe_ms(
                                "tick.dispatch_ms", self.last_dispatch_ms
                            )
                if self._cluster is not None:
                    # cross-shard leg INSIDE the device window: the
                    # local batch (and sim tick) are already in flight
                    # on device while the inter-shard rings drain —
                    # the collective hides behind per-shard compute
                    with trace.span("cluster.drain") as dspan:
                        dspan.tag(frames=await self._cluster.drain())
                if batch:
                    tc = time.perf_counter()
                    with trace.span("tick.collect"):
                        targets = await asyncio.to_thread(
                            self.backend.collect_local_batch, handle
                        )
                        dispatched = True
                        self.last_collect_ms = (
                            time.perf_counter() - tc
                        ) * 1e3
                        self.last_resolve_ms = (
                            time.perf_counter() - t0
                        ) * 1e3
                        if self.metrics is not None:
                            self.metrics.observe_ms(
                                "tick.collect_ms", self.last_collect_ms
                            )
                    self._note_collect_stats(trace)
                pairs = self._build_pairs(batch, targets)
                if sim_handle is not None:
                    pairs.extend(
                        await self._sim_collect_apply(
                            sim_handle, trace, skip_frames
                        )
                    )
                # One batched delivery: every message's frame goes to
                # its targets' transport buffers synchronously; only
                # saturated/fast-path-less peers cost an await at the
                # end (engine/peers.py deliver_batch). Shielded: a
                # cancel must not abort the awaited (slow-path) tail
                # half-sent — fast-path frames are already in
                # transport buffers and re-sending would duplicate.
                deliver_task = asyncio.ensure_future(  # wql: allow(unsupervised-task)
                    self.peer_map.deliver_batch(pairs, t_ingress_ns)
                )
                with trace.span("tick.deliver"):
                    await asyncio.shield(deliver_task)
                if self._cluster is not None and pairs:
                    # cluster.e2e_ms close at socket-write-complete
                    # (see _collect_deliver_inner)
                    self._cluster.close_frames(m for m, _ in pairs)
            except asyncio.CancelledError:
                if sim_handle is not None:
                    # un-applied sim tick (cancel landed before or
                    # inside the sim stage): drop it cleanly — the
                    # host columns stay authoritative. Idempotent if
                    # the sim stage already applied or aborted.
                    plane.abort_tick()
                if not dispatched:
                    # stop() landed before the device collect: the
                    # whole batch is still owed — re-queue it for the
                    # drain flush.
                    self._queue.extendleft(reversed(batch))
                elif deliver_task is not None:
                    # delivery already in flight: let it finish (peers
                    # without a sync fast path — e.g. ZMQ — are only
                    # served by this awaited tail; abandoning it would
                    # silently drop their frames). Shield and re-await
                    # in a loop: a bare `await deliver_task` here would
                    # let a SECOND cancellation cancel the delivery
                    # itself, and suppress(Exception) would abandon the
                    # wait this branch exists to guarantee (ADVICE r5).
                    while not deliver_task.done():
                        try:
                            await asyncio.shield(deliver_task)
                        except asyncio.CancelledError:
                            continue  # repeated cancel — keep waiting
                        except Exception:
                            break  # delivery errors handled by _run
                raise
            except Exception:
                if sim_handle is not None:
                    # a dispatch/collect error escapes to _run's
                    # containment; the un-applied sim tick must not
                    # stay "in flight" forever (idempotent)
                    plane.abort_tick()
                raise

            self._account(batch, t0, trace=trace)

    def _begin_trace(self, batch_size: int):
        """Open this flush's "tick" trace (the shared null trace when
        tracing is off — one branch inside Tracer.begin, per flush)."""
        self._tick_seq += 1
        trace = self._tracer.begin(
            "tick", tick=self._tick_seq, batch=batch_size,
            inflight=len(self._inflight), pipeline=self.pipeline,
        )
        if self._governor is not None:
            # overload state rides every tick trace: a slow-tick dump
            # answers "was the governor shedding?" without a scrape
            trace.tag(overload=self._governor.state)
        if trace is not NULL_TRACE:
            stats_fn = getattr(self.backend, "device_stats", None)
            if stats_fn is not None:
                try:
                    trace.tags["device_stats_at_dispatch"] = {
                        k: v for k, v in stats_fn().items()
                        if isinstance(v, (int, float))
                    }
                except Exception:
                    pass  # diagnostics must never cost the tick
        return trace

    def _account(
        self, batch, t0, deliver_ms: float | None = None, trace=NULL_TRACE,
    ) -> None:
        self.ticks += 1
        self.messages += len(batch)
        self.last_batch = len(batch)
        self.last_tick_ms = (time.perf_counter() - t0) * 1e3
        self.last_deliver_ms = (
            deliver_ms if deliver_ms is not None
            else self.last_tick_ms - self.last_resolve_ms
        )
        if self.metrics is not None:
            # whole-tick accounting: the enclosing "tick" root trace IS
            # the span for these two series
            self.metrics.observe_ms("tick.flush_ms", self.last_tick_ms)  # wql: allow(unspanned-stage)
            self.metrics.observe_ms("tick.deliver_ms", self.last_deliver_ms)  # wql: allow(unspanned-stage)
            self.metrics.inc("tick.flushes")
            self.metrics.inc("tick.messages", len(batch))
            # delivered wire bytes attributable to THIS flush: the
            # PeerMap counter diffed across consecutive accounts (both
            # flush variants route here after their delivery settles)
            bd = getattr(self.peer_map, "bytes_delivered", 0)
            self.metrics.set_gauge(
                "delivery.bytes_per_tick", bd - self._bytes_mark
            )
            self._bytes_mark = bd
        if self._governor is not None:
            self._governor.note_tick(self.last_tick_ms, len(self._queue))
        trace.tag(tick_ms=round(self.last_tick_ms, 3))
        trace.finish()

    def _note_collect_stats(self, trace=NULL_TRACE) -> None:
        """Pull the backend's per-collect transfer stats (what the D2H
        fetch actually shipped, and whether the on-device compaction
        packed it) into the metrics registry and the tick trace.
        Backends without the stats (CPU reference) are silently
        skipped."""
        stats = getattr(self.backend, "last_collect_stats", None)
        if stats:
            self.last_compaction_bucket = int(
                stats.get("compaction_bucket", 0)
            )
            if self.metrics is not None:
                self.metrics.inc(
                    "tick.fetch_bytes", int(stats.get("fetch_bytes", 0))
                )
                # NOT also pushed as a set_gauge here: the server's
                # registered ``tick`` gauge dict already exports
                # ``last_compaction_bucket`` under the SAME flattened
                # name, and two exporters made /metrics emit a
                # duplicate # TYPE the strict parser rejects
            trace.tag(
                fetch_bytes=int(stats.get("fetch_bytes", 0)),
                compaction_bucket=self.last_compaction_bucket,
            )
        # delta ticks (spatial/delta_ticks.py): the dispatch's reuse
        # partition rides the tick trace as `tick.delta` tags and the
        # delta.* counter series — reused/recomputed query counts,
        # churn rows consumed, and the fallback reason when the batch
        # bypassed reuse entirely
        delta = getattr(self.backend, "last_delta_stats", None)
        if delta:
            trace.tag(delta=dict(delta))
            if self.metrics is not None:
                self.metrics.inc(
                    "delta.query_reused", int(delta.get("reused", 0))
                )
                self.metrics.inc(
                    "delta.query_recomputed",
                    int(delta.get("recomputed", 0)),
                )
                if delta.get("fallback"):
                    self.metrics.inc("delta.query_fallbacks")
        if self._device_telemetry is not None:
            # device timing split onto the tick root + retrace poll;
            # diagnostics must never cost the tick
            try:
                self._device_telemetry.on_tick(trace)
            except Exception:
                logger.exception("device telemetry tick hook failed")
