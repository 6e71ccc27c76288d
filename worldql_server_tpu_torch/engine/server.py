"""Server bootstrap and wiring.

Port of the JAX package's ``engine/server.py`` (itself the Python
rebuild of the reference's main.rs): builds the peer map, spatial
backend, record store and router, starts the enabled transports, and
runs the ZeroMQ-style staleness sweeper (outgoing.rs:28-47,132-150).
One asyncio event loop carries the reference's task/channel mesh.

What the port wires today (ROADMAP.md lists the rest): the
subscription index — the device ``cuda`` index (spatial/cuda_backend.py,
with delta ticks, staged dispatch, the boot tier walk and device
telemetry) or the host ``cpu`` AreaMap, optionally inside the
``--resilience on`` wrapper (robustness/resilient.py) — with its
``--index-snapshot`` restore at boot and save at stop
(spatial/snapshot.py), the spatial query library (``--query-kinds``, on
by default), the entity simulation plane (``--entity-sim``:
``entities/`` + ``ops/tick.py`` + the CUDA kNN kernel) on the same
device as the index with interest-managed fan-out (``--interest on``,
interest/), the delivery plane's sender workers (``--delivery-workers
N``, delivery/), session continuity (``--session-ttl``,
robustness/sessions.py), the overload governor (``--overload on``,
robustness/overload.py), the SLO engine and incident capsules
(``--slo``, observability/), the cluster shard extension
(``--cluster-role shard``, cluster/shard.py: a shard behind the router
of ``--cluster-shards N``), the ticker, router, transports, durability
and the flight recorder; and the ``sharded`` mesh index (parallel/),
whose entity plane, boot walk and telemetry run on the mesh's first
device.
"""

from __future__ import annotations

import asyncio
import logging
import os

from ..robustness import failpoints
from ..robustness.supervisor import Supervisor
from ..spatial.backend import SpatialBackend
from ..spatial.cpu_backend import CpuSpatialBackend
from ..storage.store import RecordStore, open_store
from .config import Config
from .metrics import Metrics
from .peers import PeerMap
from .router import Router

logger = logging.getLogger(__name__)


def build_backend(config: Config, device=None,
                  mesh_devices=None) -> SpatialBackend:
    """The subscription index: the device index on ``device`` (the card
    unless the caller asks for the CPU) for ``cuda``; for ``sharded``
    the mesh index over ``mesh_batch`` x ``mesh_space`` of
    ``mesh_devices`` (a device may repeat: virtual shards), or of the
    visible cards (the CPU when ``device`` or ``WQL_TORCH_DEVICE`` asks
    for it) when None; else the host AreaMap."""
    if config.spatial_backend == "cuda":
        from ..spatial.cuda_backend import CudaSpatialBackend

        backend = CudaSpatialBackend(config.sub_region_size, device=device)
    elif config.spatial_backend == "sharded":
        from ..parallel import (
            ShardedCudaSpatialBackend,
            make_fanout_mesh,
            maybe_initialize_distributed,
        )
        from ..spatial.torchconf import resolve_device

        maybe_initialize_distributed()
        if mesh_devices is None and device is not None \
                and resolve_device(device).type == "cpu":
            mesh_devices = ["cpu"]
        mesh = make_fanout_mesh(
            config.mesh_batch, config.mesh_space or None,
            devices=mesh_devices,
        )
        logger.info(
            "sharded spatial backend on mesh batch=%d space=%d",
            mesh.shape["batch"], mesh.shape["space"],
        )
        backend = ShardedCudaSpatialBackend(config.sub_region_size, mesh)
    else:
        return CpuSpatialBackend(config.sub_region_size)
    # delta ticks configure HERE so a resilience rebuild's factory
    # (which calls build_backend again) re-arms the fresh instance —
    # its cache starts cold, never stale; on the mesh, result reuse is
    # per-shard flat-region replay, armed like the single-device path
    if config.delta_ticks != "off":
        backend.configure_delta_ticks(config.delta_ticks)
        backend.delta_rebuild_threshold = config.delta_rebuild_threshold
    return backend


class WorldQLServer:
    def __init__(
        self,
        config: Config,
        backend: SpatialBackend | None = None,
        store: RecordStore | None = None,
        device=None,
        mesh_devices=None,
    ):
        config.validate()
        self.config = config
        # Arm fault-injection failpoints BEFORE any subsystem that
        # hosts an injection site comes up. The registry is
        # process-global (like logging); only a non-empty spec touches
        # it, so constructing a second server never disarms points a
        # test configured directly.
        if config.failpoints:
            failpoints.registry.configure(
                config.failpoints, seed=config.failpoints_seed
            )
        elif config.failpoints_seed is not None:
            failpoints.registry.seed(config.failpoints_seed)
        self.backend = (
            backend if backend is not None
            else build_backend(config, device=device,
                               mesh_devices=mesh_devices))
        if config.spatial_backend == "sharded":
            # the entity plane shares the index's device: the mesh's
            # first (build_backend above made it from the same ask)
            device = getattr(self.backend, "device", device)
        if config.resilience == "on":
            from ..robustness.resilient import ResilientBackend

            if not isinstance(self.backend, ResilientBackend):
                self.backend = ResilientBackend(
                    self.backend,
                    # rebuilds get a fresh backend of the configured
                    # kind on the same device; injected test backends
                    # can't be re-made
                    factory=(
                        (lambda: self._trace_index(build_backend(
                            config, device=device,
                            mesh_devices=mesh_devices)))
                        if backend is None else None
                    ),
                    failover_after=config.failover_after,
                )
        self.store = store if store is not None else open_store(
            config.store_url, config
        )
        self.metrics = Metrics()
        # Observability: the tracer ALWAYS exists (router/transports
        # test one `enabled` flag, no None checks on the hot path);
        # the flight recorder + loop monitor only when tracing is on.
        from ..observability import FlightRecorder, LoopMonitor, Tracer
        from ..observability.export import ProfilerHook

        self.tracer = Tracer(enabled=config.trace_enabled)
        self.recorder = None
        self.loop_monitor = None
        self.profiler = ProfilerHook()
        if config.trace_enabled:
            self.loop_monitor = LoopMonitor(metrics=self.metrics)
            self.recorder = FlightRecorder(
                depth=config.flight_recorder_depth,
                slow_tick_ms=config.slow_tick_ms,
                dump_dir=config.slow_tick_dir,
                metrics=self.metrics,
                context=self.loop_monitor.snapshot,
            )
            self.tracer.on_trace = self.recorder.record
        # the index's fan-out spans (index.*) nest under the ticker's
        # tick.dispatch / tick.collect in the same traces
        self._trace_index(getattr(self.backend, "inner", self.backend))
        if hasattr(self.backend, "_note_failure"):  # ResilientBackend
            self.backend.metrics = self.metrics
        # Device telemetry (observability/device.py): the per-tick
        # encode/h2d/compute/d2h split and the live-memory gauge, for
        # backends with a device side (device_stats)
        self.device_telemetry = None
        if config.device_telemetry and hasattr(self.backend, "device_stats"):
            from ..observability.device import DeviceTelemetry

            self.device_telemetry = DeviceTelemetry(
                metrics=self.metrics, backend=self.backend,
            )
        # Escalation contract: when a CRITICAL supervised task (ticker
        # pump, ZMQ recv loop, durability applier) exhausts its restart
        # budget the server requests its own clean shutdown.
        self.shutdown_requested = asyncio.Event()
        self.supervisor = Supervisor(
            metrics=self.metrics,
            on_escalate=self._escalate,
            backoff_base=config.supervisor_backoff,
            budget=config.supervisor_budget,
        )
        # Multi-core delivery plane (delivery/plane.py): sender worker
        # processes owning disjoint socket shards, fed by per-worker
        # shared-memory rings. The workers are spawned processes that
        # import neither torch nor the device code. None with
        # --delivery-workers 0 (the default) — the PeerMap then takes
        # its unchanged in-process path.
        self.delivery_plane = None
        if config.delivery_workers > 0:
            from ..delivery import DeliveryPlane

            self.delivery_plane = DeliveryPlane(
                config,
                metrics=self.metrics,
                tracer=self.tracer,
                on_peer_lost=self._on_delivery_peer_lost,
            )
            if self.recorder is not None:
                # worker-plane trace stitching: /debug/ticks grafts the
                # workers' ring-dwell + write-time spans under
                # tick.deliver
                self.recorder.stitcher = self.delivery_plane.stitch
        self._delivery_evictions: set = set()
        # Session continuity (robustness/sessions.py): with
        # --session-ttl > 0 a dropped peer's logical state parks for
        # the TTL instead of tearing down, and a reconnect presenting
        # the handshake-minted token rebinds to it. None with TTL 0
        # (the default).
        self.sessions = None
        if config.session_ttl > 0:
            from ..robustness.sessions import SessionStore

            self.sessions = SessionStore(
                config.session_ttl,
                metrics=self.metrics,
                on_expire=self._expire_session,
            )
        self.peer_map = PeerMap(
            on_remove=self._on_peer_remove, metrics=self.metrics,
            plane=self.delivery_plane, sessions=self.sessions,
        )
        # Overload control plane (robustness/overload.py): admission
        # governor for router, ticker and entity plane. None with
        # --overload off (the default).
        self.governor = None
        if config.overload == "on":
            from ..robustness.overload import OverloadGovernor

            budget_ms = config.overload_tick_budget_ms
            if not budget_ms and config.tick_interval > 0:
                # the deadline IS the tick window: slower can't hold rate
                budget_ms = config.tick_interval * 1e3
            self.governor = OverloadGovernor(
                max_batch=config.max_batch,
                tick_budget_ms=budget_ms,
                deadline_k=config.overload_deadline_k,
                recover_ticks=config.overload_recover_ticks,
                min_batch=min(config.overload_min_batch, config.max_batch),
                peer_rate=config.overload_peer_rate,
                peer_burst=config.overload_peer_burst,
                evict_after=config.overload_evict_after,
                rss_limit_mb=config.overload_rss_limit_mb,
                resume_rate=config.session_resume_rate,
                metrics=self.metrics,
                loop_monitor=self.loop_monitor,
                on_evict=self._on_rate_limit_evict,
            )
        # Spatial query library (queries/): wire-level cone / raycast /
        # kNN / density queries riding the staged columns. 'off' (or an
        # unregistered parameter) keeps every query a plain radius
        # match byte for byte — router parse and backend dispatch both
        # gate on these being None.
        self.query_limits = None
        self.heatmap = None
        if config.query_kinds == "on":
            from ..queries import QueryLimits
            from ..queries.heatmap import RegionHeatmap

            self.query_limits = QueryLimits(
                cube_size=config.sub_region_size,
                stencil_max=config.query_stencil_max,
                ray_steps_max=config.query_ray_steps,
                density_top_n=config.query_density_top_n,
            )
            self.heatmap = RegionHeatmap(top_n=config.query_density_top_n)
            # expansion clamps live on the backend(s): the Resilient
            # wrapper delegates dispatch to .inner and degradation to
            # .mirror, so all three must agree with the parse clamps
            for b in (self.backend, getattr(self.backend, "inner", None),
                      getattr(self.backend, "mirror", None)):
                if b is not None:
                    b.query_stencil_max = config.query_stencil_max
                    b.query_ray_steps = config.query_ray_steps
        # Entity simulation plane (entities/): the device-resident
        # moving-object workload, on the card unless ``device`` (or
        # WQL_TORCH_DEVICE) asks for the CPU — the same device as the
        # index, which the plane checks. Constructed only in
        # --entity-sim mode (validate() guarantees a ticker for it).
        self.entity_plane = None
        self.entity_ingest = None
        # Interest-managed fan-out (--interest on): built below only
        # alongside the entity plane (validate() enforces the pairing)
        self.interest = None
        if config.entity_sim:
            from ..entities import ColumnarIngest, EntityPlane

            self.entity_plane = EntityPlane(
                self.backend, self.peer_map,
                cube_size=config.sub_region_size,
                k=config.entity_k,
                dt=config.tick_interval,
                bounds=config.entity_bounds,
                max_entities=config.entity_max,
                metrics=self.metrics,
                tracer=self.tracer,
                governor=self.governor,
                delta_ticks=config.delta_ticks,
                delta_rebuild_threshold=config.delta_rebuild_threshold,
                device=device,
            )
            # wire→SoA columnar fast path: transports hand whole recv
            # batches here; entity-update messages batch-decode
            # natively into the plane's columns, everything else routes
            # through the ordinary codec. Inert when the native library
            # predates the entity codec (active == False).
            self.entity_ingest = ColumnarIngest(
                self.entity_plane,
                sender_known=self.peer_map.__contains__,
                governor=self.governor,
                metrics=self.metrics,
                on_error=lambda: self.metrics.inc("zmq.recv_errors"),
            )
            if config.interest == "on":
                from ..interest import InterestManager

                self.interest = InterestManager(
                    near_radius=config.lod_near_radius,
                    far_every_k=config.lod_far_every_k,
                    bandwidth_bytes=config.peer_bandwidth_bytes,
                    metrics=self.metrics,
                )
                self.entity_plane.interest = self.interest
                # every loss path funnels into ONE resync hook: local
                # map-miss/send-error, worker-plane ring drops, and
                # frames that landed on a parked session
                self.peer_map.on_frame_loss = self.interest.mark_resync
                if self.delivery_plane is not None:
                    self.delivery_plane.on_frame_drop = (
                        self.interest.mark_resync
                    )
                if self.sessions is not None:
                    self.sessions.on_undelivered = (
                        self.interest.mark_resync
                    )
            if hasattr(self.backend, "_note_failure"):
                # a ResilientBackend rebuild/failover swaps the inner
                # index out from under an in-flight sim tick: the
                # plane's device twin (and its dirty bitmap) must be
                # invalidated BEFORE the restore so the next dispatch
                # re-ships the host authority
                self.backend.on_rebuild = self.entity_plane.abort_tick
        # Cluster shard extension (cluster/): remote peer proxies, the
        # inter-shard ring drain and the control channel to the router
        # tier. Only with --cluster-role shard (spawned by the router's
        # supervisor, which provides the WQL_CLUSTER_SPEC topology);
        # standalone servers never import the cluster package.
        self.cluster = None
        if config.cluster_role == "shard":
            from ..cluster.shard import ClusterShardExtension

            self.cluster = ClusterShardExtension(self)
            if self.recorder is not None:
                # graft router.forward/cluster.ring_dwell spans for
                # drained cross-shard frames under the tick trace at
                # export time, composed with the delivery plane's
                # stitcher when both are built
                self.recorder.stitcher = self.cluster.chain_stitcher(
                    self.recorder.stitcher
                )
        self.ticker = None
        self.staging = None
        if config.tick_interval > 0:
            from .ticker import TickBatcher

            # Columnar query staging binds exactly when the backend can
            # stage ('auto'): the cuda index can, the cpu one cannot
            if (
                config.query_staging != "off"
                and self.backend.supports_staged_dispatch()
            ):
                from .staging import QueryStaging

                self.staging = QueryStaging(self.backend)
            self.ticker = TickBatcher(
                self.backend, self.peer_map, config.tick_interval,
                max_batch=config.max_batch,
                metrics=self.metrics, pipeline=config.tick_pipeline,
                supervisor=self.supervisor, tracer=self.tracer,
                device_telemetry=self.device_telemetry,
                staging=self.staging,
                entity_plane=self.entity_plane,
                governor=self.governor,
                cluster=self.cluster,
                heatmap=self.heatmap,
            )
        self.precompile_stats: dict | None = None
        # Durability engine: WAL + write-behind pipeline. With
        # durability='off' (default) both stay None and the Router's
        # internal pass-through keeps reference-equivalent inline-store
        # behavior.
        self.wal = None
        self.durability = None
        self.last_recovery = None
        if config.durability != "off":
            from ..durability import DurabilityPipeline, WriteAheadLog

            self.wal = WriteAheadLog(
                config.wal_dir,
                # sync mode = fsync per batch, no coalescing wait
                fsync_ms=(
                    0.0 if config.durability == "sync"
                    else config.wal_fsync_ms
                ),
                segment_bytes=config.wal_segment_bytes,
                metrics=self.metrics,
                tracer=self.tracer,
            )
            self.durability = DurabilityPipeline(
                self.store, mode=config.durability, wal=self.wal,
                config=config, metrics=self.metrics, tracer=self.tracer,
            )
        self.router = Router(
            self.peer_map, self.backend, self.store,
            ticker=self.ticker, metrics=self.metrics,
            durability=self.durability, tracer=self.tracer,
            entity_plane=self.entity_plane,
            governor=self.governor,
            query_limits=self.query_limits,
            heatmap=self.heatmap,
        )
        # SLO engine + incident recorder (observability/slo.py,
        # incidents.py): declared objectives over the series this
        # registry already records, judged by a supervised slo-eval
        # task with fast/slow burn windows. Off (default) constructs
        # nothing — no gauge, no routes, no healthz block.
        self.slo = None
        self.incidents = None
        if config.slo_enabled:
            from ..observability.slo import SloEngine, load_objectives

            interval, objectives = load_objectives(config.slo_file)
            self.slo = SloEngine(
                self.metrics, objectives, eval_interval_s=interval
            )
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
        self._register_gauges()
        self._transports: list = []
        self._started = asyncio.Event()
        self._restored_peers: list = []
        self._snapshot_save_disabled = False

    def _register_gauges(self) -> None:
        self.metrics.gauge("peers", self.peer_map.size)
        self.metrics.gauge(
            "subscriptions", self.backend.subscription_count
            if hasattr(self.backend, "subscription_count") else lambda: None
        )
        if self.heatmap is not None:
            # per-region density aggregates (queries/heatmap.py)
            self.metrics.gauge("region_density", self.heatmap.gauge)
        if self.config.delta_ticks != "off":
            # flattened into delta.* series by render_prometheus
            self.metrics.gauge("delta", self._delta_status)
        if self.ticker is not None:
            self.metrics.gauge(
                "tick",
                lambda: {
                    "interval_s": self.ticker.interval,
                    "pipeline": self.ticker.pipeline,
                    "inflight": self.ticker.inflight(),
                    "last_batch": self.ticker.last_batch,
                    "last_tick_ms": round(self.ticker.last_tick_ms, 3),
                    "last_dispatch_ms":
                        round(self.ticker.last_dispatch_ms, 3),
                    "last_collect_ms":
                        round(self.ticker.last_collect_ms, 3),
                    "compaction_bucket":
                        self.ticker.last_compaction_bucket,
                    "staged_flushes": self.ticker.staged_flushes,
                    "staging_fallbacks": self.ticker.staging_fallbacks,
                    **(
                        {"staging": self.staging.stats()}
                        if self.staging is not None else {}
                    ),
                },
            )
        if self.config.precompile_tiers and (
            self.entity_plane is not None
            or hasattr(self.backend, "_segments")
        ):
            self.metrics.gauge("precompile", lambda: self.precompile_stats)
        if self.durability is not None:
            self.metrics.gauge("durability", self.durability_status)
        if self.device_telemetry is not None:
            self.metrics.gauge("device", self.device_telemetry.stats)
        # Supervision + fault-injection accounting: restart/crash
        # counters and the tasks_unhealthy gauge; per-failpoint fire
        # counts so no injected fault is ever invisible in /metrics.
        self.metrics.gauge("supervisor", self.supervisor.stats)
        self.metrics.gauge(
            "failpoints", failpoints.registry.fired_counts
        )
        if self.delivery_plane is not None:
            # aggregate + per-worker delivery counters: the workers'
            # cumulative stats ride the control channel into these
            # gauges (and diff into delivery.* counters)
            self.metrics.gauge("delivery", self.delivery_plane.stats)
            for i in range(self.config.delivery_workers):
                self.metrics.gauge(
                    f"delivery.worker.{i}",
                    lambda i=i: self.delivery_plane.worker_stats(i),
                )
        if self.sessions is not None:
            # minted/parked/resumed/expired and undelivered frames
            self.metrics.gauge("sessions", self.sessions.stats)
        if self.entity_plane is not None:
            self.metrics.gauge("entity_sim", self.entity_plane.stats)
        if self.interest is not None:
            # per-recipient fan-out accounting: resyncs, delta ratio,
            # LOD tier sizes, bandwidth deferrals/shed
            self.metrics.gauge("interest", self.interest.stats)
        if self.entity_ingest is not None:
            self.metrics.gauge("entity_ingest", self.entity_ingest.stats)
        # codec health: the WQL_MAX_OBJS overflow fallback is counted,
        # never silent
        from ..protocol import codec_stats

        self.metrics.gauge("codec", lambda: dict(codec_stats))
        if self.governor is not None:
            # governor state + shed/coalesce/rate-limit accounting
            self.metrics.gauge("overload", self.governor.status)
        if self.cluster is not None:
            # shard-side cluster accounting: remote proxies held,
            # ring send/drop/drain counts, cross-shard frames
            self.metrics.gauge("cluster_shard", self.cluster.stats)
        if self.recorder is not None:
            self.metrics.gauge("flight_recorder", self.recorder.stats)
        if self.slo is not None:
            # per-objective burn state: numeric levels flatten to
            # wql_slo_<objective> (0 ok / 1 warn / 2 burning) + worst
            self.metrics.gauge("slo", self.slo.gauge)
        if self.incidents is not None:
            self.metrics.gauge("incidents", self.incidents.stats)
        if self.loop_monitor is not None:
            self.metrics.gauge("loop_health", self.loop_monitor.snapshot)
        if self.resilience_status() is not None:
            # containments, rebuilds and failovers: never silent
            self.metrics.gauge("resilience", self.backend.status)

    def _trace_index(self, index):
        """Hands the server's tracer to a device index (the ``index.*``
        spans of its fan-out path); a host index has none. Returns the
        index, so a ResilientBackend's rebuild factory can wrap it."""
        if hasattr(index, "tracer"):
            index.tracer = self.tracer
        return index

    def resilience_status(self) -> dict | None:
        """Degraded-mode state for /healthz; None without a
        ResilientBackend wrapper."""
        if hasattr(self.backend, "status") and hasattr(
            self.backend, "failed_over"
        ):
            return self.backend.status()
        return None

    def _escalate(self, task_name: str) -> None:
        """Supervisor escalation hook: a critical task is permanently
        dead — request a clean shutdown (run_forever exits its serve
        loop; embedded callers watch ``shutdown_requested``)."""
        logger.critical(
            "critical task %r failed permanently — requesting clean "
            "server shutdown", task_name,
        )
        self.metrics.inc("server.escalations")
        self.shutdown_requested.set()

    def delivery_status(self) -> dict | None:
        """Delivery-plane state for /healthz (worker liveness, restart
        and drop counts, per-worker stats freshness); None with
        --delivery-workers 0. A worker whose stats push went silent
        for 3 control-channel intervals counts as degraded."""
        if self.delivery_plane is None:
            return None
        status = self.delivery_plane.stats()
        status["degraded"] = self.delivery_plane.degraded()
        status["stats_age_s"] = {
            str(i): (
                round(age, 3)
                if (age := self.delivery_plane.stats_age_s(i)) is not None
                else None
            )
            for i in range(self.config.delivery_workers)
        }
        return status

    def sessions_status(self) -> dict | None:
        """Session-continuity state for /healthz; None with
        --session-ttl 0."""
        if self.sessions is None:
            return None
        return self.sessions.stats()

    def overload_status(self) -> dict | None:
        """Governor state + shed accounting for /healthz; None with
        --overload off."""
        if self.governor is None:
            return None
        return self.governor.status()

    def device_status(self) -> dict | None:
        """Where the device work runs, for /healthz: the index's device
        and the entity plane's, with the kNN kernel's launches in this
        process, in all and by ``[N, K, launches]``. A cluster's shards
        are separate processes, and this is how each tells which card
        (or the CPU) serves it. None for a host index without an entity
        plane."""
        index = getattr(self.backend, "device", None)
        if index is None and self.entity_plane is None:
            return None
        body = {"index": None if index is None else str(index)}
        if self.entity_plane is not None:
            from ..ops.knn import knn_select

            body["entity_plane"] = str(self.entity_plane.device)
            body["knn_launches"] = knn_select.launches
            body["knn_shapes"] = [[n, k, c] for (n, k), c in
                                  sorted(knn_select.shapes.items())]
        return body

    def slo_status(self) -> dict | None:
        """Compact burn-state block for /healthz; None with --slo off."""
        if self.slo is None:
            return None
        return self.slo.healthz()

    def _on_slo_burning(self, objective) -> None:
        """SLO eval hook: an objective just transitioned into BURNING.
        Hand it to the incident recorder (debounce lives there)."""
        if self.incidents is not None:
            self.incidents.trigger(objective, self.slo.status())

    async def _collect_incident_body(self) -> dict:
        """Capsule body for a standalone/shard process: this process's
        subsystem sections (the router overrides this with the fleet
        pull over the shared chunked-dump client)."""
        from ..observability.incidents import capsule_sections

        return {"pid": os.getpid(), "sections": capsule_sections(self)}

    def _delta_status(self) -> dict:
        """Temporal-coherence accounting (the ``delta`` gauge):
        query-path + sim-path reuse counters and the cumulative reuse
        fraction — how much of the world the engine did NOT recompute
        since boot (the cpu index has no query-path delta ticks)."""
        q_r = int(getattr(self.backend, "delta_reused", 0))
        q_c = int(getattr(self.backend, "delta_recomputed", 0))
        q_f = int(getattr(self.backend, "delta_fallbacks", 0))
        s_r = s_c = s_f = f_r = 0
        if self.entity_plane is not None:
            s_r = self.entity_plane.delta_reused
            s_c = self.entity_plane.delta_recomputed
            s_f = self.entity_plane.delta_fallbacks
            f_r = self.entity_plane.frames_reused
        total = q_r + q_c + s_r + s_c
        return {
            "query_reused": q_r,
            "query_recomputed": q_c,
            "query_fallbacks": q_f,
            "sim_reused": s_r,
            "sim_recomputed": s_c,
            "sim_fallbacks": s_f,
            "frames_reused": f_r,
            "reuse_fraction": (
                round((q_r + s_r) / total, 4) if total else 0.0
            ),
        }

    def durability_status(self) -> dict | None:
        """Queue depth, WAL state, and last recovery for /healthz and
        the ``durability`` gauge; None when durability is off."""
        if self.durability is None:
            return None
        status = self.durability.stats()
        if self.last_recovery is not None:
            status["recovery"] = self.last_recovery.as_dict()
        return status

    def _on_rate_limit_evict(self, uuid) -> None:
        """Overload-governor eviction hook: a peer exhausted its abuse
        budget (``overload_evict_after`` consecutive rate-limited
        messages). Leaves through the normal ``PeerMap.remove`` path,
        like the failed-send and worker-lost evictions."""
        self.metrics.inc("peers.evicted_rate_limited")
        task = asyncio.get_running_loop().create_task(  # wql: allow(unsupervised-task)
            self.peer_map.remove(uuid)
        )
        self._delivery_evictions.add(task)
        task.add_done_callback(self._delivery_evictions.discard)

    def _on_peer_remove(self, uuid) -> None:
        """Disconnect cleanup. With sessions enabled and a session
        minted for this peer, the TRANSPORT state is released (delivery
        shard slot, connect-back sockets) but the logical state —
        subscription index rows, entity slots, governor bucket — PARKS
        for the TTL; otherwise the full teardown runs."""
        if self.sessions is not None and self.sessions.park(uuid):
            if self.interest is not None:
                # the transport died with frames possibly in flight —
                # whatever resumes this session must start from a full
                self.interest.mark_resync(uuid)
            self._release_transport_state(uuid)
            return
        self._teardown_peer_state(uuid)

    def _release_transport_state(self, uuid) -> None:
        """Drop everything bound to the peer's (dead or superseded)
        transport: the delivery-plane shard slot and per-transport
        socket state. Logical state untouched."""
        if self.delivery_plane is not None:
            # worker-owned socket: the owning shard closes its end
            self.delivery_plane.release(uuid)
        for transport in self._transports:
            hook = getattr(transport, "on_peer_removed", None)
            if hook is not None:
                hook(uuid)

    def _teardown_peer_state(self, uuid) -> None:
        """The normal removal path's state teardown: purge the spatial
        index (the remove_rx path, thread.rs:124-126), entity slots,
        governor bookkeeping, and transport/delivery socket state.
        Session expiry funnels through here too."""
        if self.sessions is not None:
            # a torn-down peer's token must never resume
            self.sessions.discard(uuid)
        if self.cluster is not None:
            # a homed peer's full teardown must reap its remote
            # proxies cluster-wide (the router re-broadcasts the drop)
            self.cluster.on_peer_torn_down(uuid)
        self.backend.remove_peer(uuid)
        if self.governor is not None:
            # token bucket bookkeeping stays bounded by live peers
            self.governor.forget_peer(uuid)
        if self.entity_plane is not None:
            # entity slots + refcounts of the departed peer; its index
            # rows (entity-derived included) are already purged above
            self.entity_plane.on_peer_removed(uuid)
        self._release_transport_state(uuid)

    def _expire_session(self, uuid) -> None:
        """Session-sweeper expiry hook: the parked state's TTL ran out
        — reclaim through the normal teardown."""
        self._teardown_peer_state(uuid)

    def prepare_rebind(self, uuid):
        """First half of a session resume: silently detach the stale
        old transport binding (no PeerDisconnect broadcast, no state
        teardown) and release its shard slot + sockets, so the caller
        can adopt + rebind the fresh binding — possibly onto a
        different delivery-plane shard. Returns the detached Peer, or
        None when the peer was already out of the map (parked)."""
        old = self.peer_map.detach(uuid)
        self._release_transport_state(uuid)
        if self.interest is not None:
            # resume contract: the rebound binding's first frame is a
            # forced full regardless of what the old transport saw
            self.interest.mark_resync(uuid)
        return old

    def _on_delivery_peer_lost(self, uuid, reason: str) -> None:
        """Delivery-plane eviction hook: a sender worker reported a
        failed/overflowing peer, or died with peers on its shard. The
        parent stays authoritative — eviction goes through the normal
        ``PeerMap.remove``, exactly like the in-process failed-send
        path."""
        self.metrics.inc(f"peers.evicted_{reason}")
        if self.interest is not None:
            # worker loss / ring eviction: a parked-then-resumed
            # session's next frame must be full
            self.interest.mark_resync(uuid)
        task = asyncio.get_running_loop().create_task(  # wql: allow(unsupervised-task)
            self.peer_map.remove(uuid)
        )
        self._delivery_evictions.add(task)
        task.add_done_callback(self._delivery_evictions.discard)

    async def start(self) -> None:
        """Bring up the store and all enabled transports (main.rs:106-207)."""
        failpoints.fire("store.init")
        await self.store.init()
        if self.wal is not None:
            # Replay whatever the last process acked but never applied,
            # THEN open a fresh segment for this process's appends.
            from ..durability.recovery import recover

            self.last_recovery = await recover(
                self.store, self.config.wal_dir, metrics=self.metrics
            )
            self.wal.start()
            self.durability.start(supervisor=self.supervisor)
            if self.config.checkpoint_interval > 0:
                self.supervisor.spawn("checkpoint", self._checkpoint_loop)
        self._restore_index_snapshot()
        self._precompile_tiers()

        if self.loop_monitor is not None:
            # loop-health probe: supervised but not critical
            self.loop_monitor.install()
            self.supervisor.spawn("loop-monitor", self.loop_monitor.run)

        if self.delivery_plane is not None:
            # before any transport: workers must be ready to adopt the
            # first handshake
            await self.delivery_plane.start()

        if self.config.ws_enabled:
            from ..transports.websocket import WebSocketTransport

            ws = WebSocketTransport(self)
            self._transports.append(ws)
            await ws.start()

        if self.config.http_enabled:
            from ..transports.http import HttpTransport

            http = HttpTransport(self)
            self._transports.append(http)
            await http.start()

        if self.config.zmq_enabled:
            from ..transports.zeromq import ZmqTransport

            zmq_t = ZmqTransport(self)
            self._transports.append(zmq_t)
            await zmq_t.start()
            self.supervisor.spawn("stale-sweep", self._staleness_sweeper)

        if self.sessions is not None:
            # supervised reclamation: expired parked sessions leave
            # through the normal teardown even if a sweep pass raises
            self.supervisor.spawn("session-sweep", self.sessions.sweep)

        if self.ticker is not None:
            self.ticker.start()

        if self.slo is not None:
            # SLO sentinel: judges the burn windows every eval tick
            # after the transports are up (so /metrics and the slo
            # gauge agree on what it sees). Supervised — a crashed
            # evaluator restarts and its absence shows in /healthz.
            self.supervisor.spawn("slo-eval", self.slo.run)

        if self.governor is not None and self.ticker is None:
            # immediate-mode servers have no tick clock — a supervised
            # sampler keeps the lag/RSS signals evaluating; with a
            # ticker, note_tick drives everything
            self.supervisor.spawn("overload-governor", self.governor.run)

        if self._restored_peers:
            self.supervisor.spawn(
                "restored-peer-sweep", self._sweep_restored_peers
            )

        if self.cluster is not None:
            # LAST: the ZMQ listener is bound, so announcing ready to
            # the router can never race a forward into a closed socket
            await self.cluster.start()

        self._started.set()
        logger.info("worldql-server-tpu-torch started")

    def _precompile_tiers(self) -> None:
        """Boot-time tier walk before any transport accepts traffic:
        the index's capacity tiers (spatial/precompile.py) against the
        boot index, then the entity plane's — build and load the CUDA
        kernel, run the tick at the capacity tier and the delta ladder
        — so no tick pays a build or a first allocation. A failure here
        fails the boot: a server whose device path does not run must
        not serve."""
        if not self.config.precompile_tiers:
            return
        if hasattr(self.backend, "_segments"):
            from ..spatial.precompile import precompile_tiers

            max_batch = (
                self.ticker.max_batch if self.ticker is not None
                else 16_384
            )
            self.precompile_stats = precompile_tiers(
                self.backend, max_batch=max_batch
            )
        if self.entity_plane is not None:
            stats = self.entity_plane.precompile()
            if self.precompile_stats is None:
                self.precompile_stats = {"entities": stats}
            else:
                self.precompile_stats["entities"] = stats

    async def _sweep_stale_once(self) -> int:
        """One staleness pass: evict every silent heartbeat-tracked
        peer. One peer's failing removal hook must not abort the sweep
        over the REST of the stale set (or kill the sweeper task).
        Returns peers evicted."""
        timeout = self.config.zmq_timeout_secs
        removed = 0
        for uuid in self.peer_map.stale_peers(timeout):
            logger.info("removing stale peer: %s", uuid)
            try:
                await self.peer_map.remove(uuid)
                removed += 1
                self.metrics.inc("peers.evicted_stale")
            except Exception:
                self.metrics.inc("sweeper.remove_errors")
                logger.exception(
                    "stale-peer removal hook failed for %s — continuing "
                    "the sweep", uuid,
                )
        return removed

    async def _staleness_sweeper(self) -> None:
        """Evict heartbeat-tracked peers that went silent
        (outgoing.rs:132-150)."""
        while True:
            await asyncio.sleep(self.config.zmq_timeout_secs)
            await self._sweep_stale_once()

    def _restore_index_snapshot(self) -> None:
        """Reload the subscription index saved by the last shutdown
        through the index's bulk-load path (onto the card for the cuda
        index) — clients that reconnect under the SAME UUID keep their
        area subscriptions across a restart. Restored rows whose owner
        has not reconnected within the staleness window are swept. A
        missing file is a fresh start; a bad one is loudly skipped — and
        the shutdown save is then disabled so the failing-but-intact
        file is never clobbered with an empty index."""
        path = self.config.index_snapshot
        if not path:
            return
        import os

        from ..spatial.snapshot import load_snapshot

        if not os.path.exists(path):
            logger.info("index snapshot %s not found — starting empty", path)
            return
        try:
            _, self._restored_peers = load_snapshot(self.backend, path)
        except Exception:
            logger.exception(
                "index snapshot %s failed to load — starting empty; the "
                "file is preserved (shutdown will not overwrite it)", path
            )
            self._snapshot_save_disabled = True

    def _save_index_snapshot(self, sweep_restored: bool = True) -> None:
        path = self.config.index_snapshot
        if not path:
            return
        # Complete any pending restored-peer sweep synchronously first:
        # a restart shorter than the staleness window must not
        # re-persist ghost rows forever. Periodic checkpoints pass
        # sweep_restored=False — mid-serving, restored peers may still
        # be inside their reconnect grace window.
        if sweep_restored:
            for peer in self._restored_peers:
                if self.peer_map.get(peer) is None:
                    self.backend.remove_peer(peer)
            self._restored_peers = []
        if self._snapshot_save_disabled:
            logger.warning(
                "index snapshot %s NOT saved: the boot-time load failed "
                "and overwriting would destroy the previous state", path
            )
            return
        from ..spatial.snapshot import save_snapshot

        try:
            save_snapshot(self.backend, path)
        except Exception:
            logger.exception("index snapshot %s failed to save", path)

    async def _sweep_restored_peers(self) -> None:
        """Evict restored subscriptions whose owners never came back:
        one staleness window after boot, any restored peer absent from
        the peer map loses its rows."""
        await asyncio.sleep(self.config.zmq_timeout_secs)
        swept = 0
        for peer in self._restored_peers:
            if self.peer_map.get(peer) is None:
                if self.backend.remove_peer(peer):
                    swept += 1
        self._restored_peers = []
        if swept:
            logger.info(
                "swept restored subscriptions of %d peers that did not "
                "reconnect", swept,
            )

    async def _checkpoint_loop(self) -> None:
        """Periodic checkpoint timer — bounds the WAL (and therefore
        crash-recovery time) while serving."""
        interval = self.config.checkpoint_interval
        while True:
            await asyncio.sleep(interval)
            try:
                await self.checkpoint()
            except Exception:
                logger.exception("checkpoint failed — will retry")

    async def checkpoint(self) -> bool:
        """Store flush → index snapshot → WAL segment truncation. Returns True when the
        WAL was actually truncated (every pending write-behind op
        reached the store first). Rotates FIRST so every entry in the
        sealed segments belongs to an op the drain below covers;
        truncation is skipped once any write-behind batch was dropped
        on a store error (those entries exist only in the WAL)."""
        if self.wal is None:
            return False
        boundary = await self.wal.rotate()
        await self.durability.drain()
        self._save_index_snapshot(sweep_restored=False)
        self.metrics.inc("durability.checkpoints")
        if self.durability.dropped_batches:
            logger.warning(
                "checkpoint: %d write-behind batches were dropped on "
                "store errors — WAL truncation skipped; segments are "
                "kept for boot-time replay",
                self.durability.dropped_batches,
            )
            return False
        purged = await self.wal.purge_upto(boundary)
        logger.debug("checkpoint complete: %d WAL segments purged", purged)
        return True

    async def stop(self) -> None:
        # Snapshot FIRST, synchronously: closing transports evicts the
        # still-connected peers (disconnect cleanup would empty the
        # index before a later save), and a cancellation-driven
        # shutdown can interrupt any await below.
        self._save_index_snapshot()
        if self.ticker is not None:
            await self.ticker.stop()
        # Ordered teardown of supervised loops: the periodic loops stop
        # FIRST (a checkpoint must not race the shutdown drain below),
        # transports stop their own recv tasks, and the durability
        # applier stays ALIVE until durability.stop() has drained the
        # write-behind queue.
        for name in (
            "checkpoint", "stale-sweep", "restored-peer-sweep",
            "session-sweep", "loop-monitor", "overload-governor",
            "slo-eval", "cluster-control", "cluster-drain",
        ):
            handle = self.supervisor.get(name)
            if handle is not None:
                await handle.stop()
        if self.incidents is not None:
            # after slo-eval stops (no new triggers) — let any
            # in-flight capsule finish writing
            await self.incidents.drain()
        if self.loop_monitor is not None:
            self.loop_monitor.uninstall()
        for transport in reversed(self._transports):
            await transport.stop()
        self._transports.clear()
        if self.cluster is not None:
            # after the ticker drain (its last flush consumed the
            # final ring records) and transport teardown
            await self.cluster.stop()
        if self.delivery_plane is not None:
            # after the ticker drain (frames are already in the rings)
            # and transport teardown: workers own their sockets, so
            # they flush their rings to the clients and exit clean
            await self.delivery_plane.stop()
        if self.durability is not None:
            # Drain the write-behind queue, then truncate the WAL only
            # on a CLEAN drain with no batch ever dropped.
            drained = await self.durability.stop()
            if drained and self.durability.dropped_batches == 0:
                try:
                    await self.wal.checkpoint()
                except Exception:
                    logger.exception("shutdown WAL checkpoint failed")
            else:
                logger.warning(
                    "shutdown without WAL truncation (%s) — segments "
                    "kept for boot-time replay",
                    "drain timed out" if not drained else
                    f"{self.durability.dropped_batches} dropped batches",
                )
            await self.wal.close()
        await self.supervisor.stop()
        await self.store.close()

    async def run_forever(self) -> None:
        """Serve until SIGINT/SIGTERM — or a supervisor escalation —
        then shut down gracefully."""
        import signal

        await self.start()
        stop_requested = asyncio.Event()
        loop = asyncio.get_running_loop()
        hooked = []
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop_requested.set)
                hooked.append(sig)
            except (NotImplementedError, RuntimeError):
                pass  # non-unix / nested loop: fall back to default
        waiters = [
            asyncio.ensure_future(stop_requested.wait()),
            asyncio.ensure_future(self.shutdown_requested.wait()),
        ]
        try:
            await asyncio.wait(waiters, return_when=asyncio.FIRST_COMPLETED)
            if self.shutdown_requested.is_set():
                logger.critical("shutting down on supervisor escalation")
            else:
                logger.info("shutdown signal received")
        finally:
            for waiter in waiters:
                waiter.cancel()
            for sig in hooked:
                loop.remove_signal_handler(sig)
            await self.stop()
