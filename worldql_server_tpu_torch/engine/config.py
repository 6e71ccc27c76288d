"""Server configuration.

Mirrors the reference's CLI/config surface (worldql_server/src/args.rs):
every flag has an environment-variable fallback, non-zero constraints
are enforced, the ZeroMQ timeout has a 10-second floor
(args.rs:172-182), the DB table size must divide evenly by each region
axis (args.rs:186-226), listening ports must be distinct
(main.rs:73-98), and a sub-region size under 10 logs a performance
warning (args.rs:189-191).

New knobs beyond the reference are grouped at the bottom: spatial
backend selection, the batched tick interval, and store URL (the
reference is Postgres-only; we default to SQLite so the server runs
self-contained).

Port status (ROADMAP.md): the fields are the JAX package's, so the
flag surface is the same. The device index is ``cuda``
(spatial/cuda_backend.py, the port of the JAX package's ``tpu``
backend); ``tpu`` is refused with a pointer to it. The ``sharded`` mesh
index (parallel/, over ``mesh_batch`` x ``mesh_space``) is served as in
the JAX package. The query library (``query_kinds``, on by default as in the JAX
package), the resilient backend (``resilience``), the delivery plane
(``delivery_workers``), sessions (``session_ttl``), the overload
governor (``overload``), interest management (``interest``), index
snapshots (``index_snapshot``), the SLO engine and incident capsules
(``slo``, ``slo_file``, ``incident_*``) and the cluster tier
(``cluster_shards``, ``cluster_role`` and live resharding) are ported,
off by default as in the JAX package. As in the JAX package,
``entity_sim`` and ``delta_ticks='on'`` require a device index
(``cuda`` or ``sharded``).
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclass
class Config:
    # Record store (reference: --psql, args.rs:24-25)
    store_url: str = field(
        default_factory=lambda: _env("WQL_STORE_URL", "sqlite://worldql.db")
    )

    # Subscription cube size (args.rs:30-31)
    sub_region_size: int = field(
        default_factory=lambda: int(_env("WQL_SUBSCRIPTION_REGION_CUBE_SIZE", "16"))
    )

    # DB region/table sharding (args.rs:36-61)
    db_region_x_size: int = field(
        default_factory=lambda: int(_env("WQL_DB_REGION_X_SIZE", "16"))
    )
    db_region_y_size: int = field(
        default_factory=lambda: int(_env("WQL_DB_REGION_Y_SIZE", "256"))
    )
    db_region_z_size: int = field(
        default_factory=lambda: int(_env("WQL_DB_REGION_Z_SIZE", "16"))
    )
    db_table_size: int = field(
        default_factory=lambda: int(_env("WQL_DB_TABLE_SIZE", "1024"))
    )
    db_cache_size: int = field(
        default_factory=lambda: int(_env("WQL_DB_CACHE_SIZE", "1024"))
    )

    # HTTP (args.rs:66-78)
    http_enabled: bool = True
    http_host: str = field(default_factory=lambda: _env("WQL_HTTP_HOST", "0.0.0.0"))
    http_port: int = field(default_factory=lambda: int(_env("WQL_HTTP_PORT", "8080")))
    http_auth_token: str | None = field(
        default_factory=lambda: os.environ.get("WQL_HTTP_AUTH_TOKEN")
    )

    # WebSocket (args.rs:83-95)
    ws_enabled: bool = True
    ws_host: str = field(default_factory=lambda: _env("WQL_WS_HOST", "0.0.0.0"))
    ws_port: int = field(default_factory=lambda: int(_env("WQL_WS_PORT", "8081")))

    # ZeroMQ (args.rs:99-119)
    zmq_enabled: bool = True
    zmq_server_host: str = field(
        default_factory=lambda: _env("WQL_ZMQ_SERVER_HOST", "0.0.0.0")
    )
    zmq_server_port: int = field(
        default_factory=lambda: int(_env("WQL_ZMQ_SERVER_PORT", "5555"))
    )
    zmq_timeout_secs: int = field(
        default_factory=lambda: int(_env("WQL_ZMQ_TIMEOUT_SECS", "25"))
    )

    # Upper bound on one inbound wire message — an unbounded frame is
    # an easy memory-exhaustion vector. WS enforces it on the whole
    # (reassembled) message; ZMQ enforces it per frame at the socket
    # (MAXMSGSIZE) plus on the flattened multipart total. Caveat:
    # libzmq assembles a multipart message atomically before delivery
    # and no socket option bounds that sum, so a peer splitting one
    # logical message into many under-cap frames can still make libzmq
    # buffer up to parts x cap before the drop — the protocol's own
    # clients are single-part, so cap accordingly.
    max_message_size: int = field(
        default_factory=lambda: int(
            _env("WQL_MAX_MESSAGE_SIZE", str(8 * 1024 * 1024))
        )
    )

    verbose: int = 0

    # --- rebuild-specific knobs ------------------------------------
    # Which SpatialBackend answers proximity queries: 'cpu' (the host
    # AreaMap), 'cuda' (the device index) or 'sharded' (the device
    # index over a mesh, parallel/). 'tpu' names the JAX package's and
    # is refused with a pointer to 'cuda'.
    spatial_backend: str = field(
        default_factory=lambda: _env("WQL_SPATIAL_BACKEND", "cpu")
    )
    # Batched-tick window in seconds for the TPU backend; 0 = flush
    # per message (reference-equivalent immediate semantics).
    tick_interval: float = field(
        default_factory=lambda: float(_env("WQL_TICK_INTERVAL", "0"))
    )
    # Tick pipeline depth: maximum dispatched-but-undelivered ticks.
    # 1 (default) keeps the sequential flush — dispatch, collect and
    # deliver before the next tick starts. 2 overlaps tick N's device
    # collect + delivery drain with tick N+1's accumulation and
    # dispatch (engine/ticker.py; arrival order is preserved — the
    # collect/deliver stages chain).
    tick_pipeline: int = field(
        default_factory=lambda: int(_env("WQL_TICK_PIPELINE", "1"))
    )
    # Device-mesh shape for spatial_backend='sharded': data-parallel
    # query batch axis × space-sharded index axis. mesh_space=0 means
    # "all remaining devices" (parallel/mesh.py).
    mesh_batch: int = field(
        default_factory=lambda: int(_env("WQL_MESH_BATCH", "1"))
    )
    mesh_space: int = field(
        default_factory=lambda: int(_env("WQL_MESH_SPACE", "0"))
    )
    # Subscription-index snapshot file: loaded at boot if present,
    # saved at shutdown. Empty/None disables (reference semantics:
    # subscriptions are lost on restart).
    index_snapshot: str | None = field(
        default_factory=lambda: os.environ.get("WQL_INDEX_SNAPSHOT")
    )
    # Record durability engine (worldql_server_tpu/durability):
    # 'off'  = reference-equivalent — handlers await the store inline,
    #          no WAL (the default, so tier-1 behavior is unchanged);
    # 'wal'  = handlers ack after the WAL group-commit fsync, store
    #          commits happen write-behind off the event loop;
    # 'sync' = WAL with immediate fsync + inline store commit.
    durability: str = field(
        default_factory=lambda: _env("WQL_DURABILITY", "off")
    )
    # WAL segment directory (created on demand; only used when
    # durability != 'off').
    wal_dir: str = field(default_factory=lambda: _env("WQL_WAL_DIR", "wal"))
    # Group-commit window: appends arriving within this many ms of the
    # first in a batch share one fsync. The default 0 adds NO wait —
    # each drained batch fsyncs immediately, and concurrent appends
    # still coalesce naturally while a sync is in flight (same
    # rationale as Postgres commit_delay=0). Raise it to trade handler
    # latency for fewer syncs under sustained load.
    wal_fsync_ms: float = field(
        default_factory=lambda: float(_env("WQL_WAL_FSYNC_MS", "0"))
    )
    # Segment rotation threshold; sealed segments are deleted at each
    # checkpoint once their entries reached the store.
    wal_segment_bytes: int = field(
        default_factory=lambda: int(
            _env("WQL_WAL_SEGMENT_BYTES", str(64 * 1024 * 1024))
        )
    )
    # Seconds between checkpoints (queue drain → index snapshot → WAL
    # truncation); 0 disables the timer (still checkpoints at
    # shutdown). Bounds crash-recovery time.
    checkpoint_interval: float = field(
        default_factory=lambda: float(_env("WQL_CHECKPOINT_INTERVAL", "60"))
    )
    # Multi-core delivery plane (worldql_server_tpu/delivery): shard
    # outbound fan-out across this many sender WORKER PROCESSES, each
    # draining a shared-memory ring of serialized frames and owning a
    # disjoint slice of the live sockets (WS via fd handoff at
    # handshake, ZMQ via worker-connected PUSH). 0 (the default) keeps
    # the single-process in-process pump byte-for-byte.
    delivery_workers: int = field(
        default_factory=lambda: int(_env("WQL_DELIVERY_WORKERS", "0"))
    )
    # Per-worker fan-out ring capacity in bytes (rounded up to a power
    # of two). Sizing rule of thumb: >= one tick's worth of frames per
    # shard at peak — a full ring degrades (bounded wait then drop,
    # counted in delivery.ring_full_drops), it never wedges the tick.
    delivery_ring_bytes: int = field(
        default_factory=lambda: int(
            _env("WQL_DELIVERY_RING_BYTES", str(4 * 1024 * 1024))
        )
    )
    # Fault-injection failpoints (robustness/failpoints.py): a spec
    # like "store.insert=error:0.2,wal.fsync=delay:5ms" arms named
    # failure sites process-wide. Empty (the default) arms nothing and
    # costs one dict-truthiness check per site.
    failpoints: str = field(
        default_factory=lambda: _env("WQL_FAILPOINTS", "")
    )
    # Deterministic RNG seed for probabilistic failpoints (chaos runs).
    failpoints_seed: int | None = field(
        default_factory=lambda: (
            int(os.environ["WQL_FAILPOINTS_SEED"])
            if os.environ.get("WQL_FAILPOINTS_SEED") else None
        )
    )
    # Expose GET/POST /failpoints on the HTTP admin surface (gated:
    # fault injection must be an explicit operator decision).
    failpoints_admin: bool = field(
        default_factory=lambda: _env("WQL_FAILPOINTS_ADMIN", "0") == "1"
    )
    # Degraded-mode spatial backend (robustness/resilient.py): 'on'
    # wraps the spatial backend in ResilientBackend — contain device
    # failures, rebuild from the authoritative CPU mirror, fail over
    # card→CPU after `failover_after` consecutive failures. 'off' (the
    # default) keeps the raw backend, reference-equivalent.
    resilience: str = field(
        default_factory=lambda: _env("WQL_RESILIENCE", "off")
    )
    failover_after: int = field(
        default_factory=lambda: int(_env("WQL_FAILOVER_AFTER", "3"))
    )
    # Supervisor defaults (robustness/supervisor.py): restarts allowed
    # per unhealthy streak and the first-restart backoff in seconds
    # (doubles up to 30 s; a 60 s healthy run refunds the budget).
    supervisor_budget: int = field(
        default_factory=lambda: int(_env("WQL_SUPERVISOR_BUDGET", "5"))
    )
    supervisor_backoff: float = field(
        default_factory=lambda: float(_env("WQL_SUPERVISOR_BACKOFF", "0.5"))
    )
    # Tick flight recorder (worldql_server_tpu/observability): span
    # tracing of every tick/message stage, a ring buffer of the last
    # N tick traces served at GET /debug/ticks, and the event-loop/GC
    # health probes. Off by default — the disabled hot path pays one
    # branch per flush/message (trace.py discipline).
    trace: bool = field(
        default_factory=lambda: _env("WQL_TRACE", "0") == "1"
    )
    # Auto-dump threshold: a tick slower than this many ms dumps its
    # full span tree + loop-health context to
    # <slow_tick_dir>/slow-ticks.jsonl with a CRITICAL log line.
    # 0 dumps EVERY tick (CI smoke); unset/None disables dumping.
    # Setting it implies tracing on (the dump needs the spans).
    slow_tick_ms: float | None = field(
        default_factory=lambda: (
            float(os.environ["WQL_SLOW_TICK_MS"])
            if os.environ.get("WQL_SLOW_TICK_MS") else None
        )
    )
    # Cluster slow-frame auto-dump (cluster/shard.py): a
    # cross-shard frame whose router-ingress→socket-write wall exceeds
    # this many ms dumps its stitched router→home→remote stage chain
    # as one JSON line to <slow_tick_dir>/slow-frames.jsonl with a
    # CRITICAL log. Only meaningful on cluster shards (forwarded from
    # the router's config); unset/None disables dumping. Unlike
    # slow_tick_ms it does NOT imply tracing — the frame clocks are
    # always live in cluster mode.
    slow_frame_ms: float | None = field(
        default_factory=lambda: (
            float(os.environ["WQL_SLOW_FRAME_MS"])
            if os.environ.get("WQL_SLOW_FRAME_MS") else None
        )
    )
    flight_recorder_depth: int = field(
        default_factory=lambda: int(_env("WQL_FLIGHT_RECORDER_DEPTH", "64"))
    )
    slow_tick_dir: str = field(
        default_factory=lambda: _env("WQL_SLOW_TICK_DIR", "slow_ticks")
    )
    # Columnar query staging (engine/staging.py): enqueue-time encode
    # of the tick batch into double-buffered columnar arrays, so flush
    # dispatches with zero per-query Python. 'auto' (default) enables
    # it exactly when the spatial backend supports staged dispatch
    # (cuda); 'off' forces the object-list path everywhere
    # (reference-equivalent); 'on' is auto plus a config error if the
    # backend can't stage (a silent fallback would hide a perf cliff).
    query_staging: str = field(
        default_factory=lambda: _env("WQL_QUERY_STAGING", "auto")
    )
    # Boot-time tier walk (spatial/precompile.py): dispatch every
    # reachable CSR capacity tier, pack bucket and query-cap shape
    # against the boot index BEFORE serving, so no first-occurrence
    # tier pays its allocations mid-serving; the entity plane builds
    # its CUDA kernel here too. On by default; only the device backend
    # (cuda) and the entity plane act on it.
    precompile_tiers: bool = field(
        default_factory=lambda: _env("WQL_PRECOMPILE_TIERS", "1") == "1"
    )
    # Entity simulation plane (worldql_server_tpu/entities): clients
    # register/update entities over the wire (the `entities` list on
    # Local/GlobalMessage), and every ticker flush integrates positions
    # + resolves per-entity kNN neighborhoods on device (ops/tick.py),
    # delivering neighbor frames through the normal fan-out path. Off
    # by default — the broker then never constructs the plane. Requires
    # the device backend ('cuda') and tick_interval > 0.
    entity_sim: bool = field(
        default_factory=lambda: _env("WQL_ENTITY_SIM", "0") == "1"
    )
    # Neighbors resolved per entity per tick (the kNN degree; the
    # stencil window is exact while cube occupancy <= k).
    entity_k: int = field(
        default_factory=lambda: int(_env("WQL_ENTITY_K", "8"))
    )
    # World half-extent: integrated positions reflect at ±bounds.
    entity_bounds: float = field(
        default_factory=lambda: float(_env("WQL_ENTITY_BOUNDS", "1000"))
    )
    # Hard cap on live entities (registrations beyond it are rejected
    # with a warning — one peer must not be able to grow device state
    # without bound).
    entity_max: int = field(
        default_factory=lambda: int(_env("WQL_ENTITY_MAX", str(1 << 16)))
    )
    # Tick batch cap: a full queue flushes early (engine/ticker.py).
    # Also the overload governor's full-service admitted tier and the
    # denominator of its queue-pressure signal.
    max_batch: int = field(
        default_factory=lambda: int(_env("WQL_MAX_BATCH", "16384"))
    )
    # Overload control plane (robustness/overload.py): 'on' builds the
    # OverloadGovernor — hysteretic OK→SHED_LOW→SHED_HIGH→REJECT state
    # machine driven by tick wall / queue depth / loop lag / RSS,
    # priority-classed admission at the router (record ops never shed,
    # globals shed last, locals drop-oldest, entity updates coalesce
    # LWW per uuid), per-peer token buckets, and tick-deadline
    # degradation. 'off' (the default) constructs nothing: every
    # ingest path keeps today's behavior byte for byte.
    overload: str = field(
        default_factory=lambda: _env("WQL_OVERLOAD", "off")
    )
    # Tick wall budget in ms for deadline degradation; 0 derives it
    # from tick_interval (the deadline IS the interval — a tick slower
    # than its window can't hold rate).
    overload_tick_budget_ms: float = field(
        default_factory=lambda: float(_env("WQL_OVERLOAD_TICK_BUDGET_MS", "0"))
    )
    # Consecutive over-budget ticks before the admitted batch tier
    # halves (and the governor's tick signal starts voting).
    overload_deadline_k: int = field(
        default_factory=lambda: int(_env("WQL_OVERLOAD_DEADLINE_K", "3"))
    )
    # Consecutive healthy samples before de-escalating ONE state (and
    # before a degraded tier doubles back). Full recovery from REJECT
    # therefore takes at most 3 × this many ticks.
    overload_recover_ticks: int = field(
        default_factory=lambda: int(_env("WQL_OVERLOAD_RECOVER_TICKS", "5"))
    )
    # Floor of the degraded admitted batch tier.
    overload_min_batch: int = field(
        default_factory=lambda: int(_env("WQL_OVERLOAD_MIN_BATCH", "256"))
    )
    # Per-peer token bucket: sustained messages/s per peer (0 = no
    # bucket). Record ops consume tokens but are never dropped.
    overload_peer_rate: float = field(
        default_factory=lambda: float(_env("WQL_OVERLOAD_PEER_RATE", "0"))
    )
    # Bucket burst capacity (0 = 2 × rate).
    overload_peer_burst: int = field(
        default_factory=lambda: int(_env("WQL_OVERLOAD_PEER_BURST", "0"))
    )
    # Evict a peer after this many CONSECUTIVE rate-limited messages
    # (sustained abuse); 0 = never evict, just drop.
    overload_evict_after: int = field(
        default_factory=lambda: int(_env("WQL_OVERLOAD_EVICT_AFTER", "0"))
    )
    # RSS ceiling in MiB for the governor's memory signal (0 = off).
    overload_rss_limit_mb: int = field(
        default_factory=lambda: int(_env("WQL_OVERLOAD_RSS_LIMIT_MB", "0"))
    )
    # Session continuity (robustness/sessions.py): with a TTL > 0 every
    # handshake mints a resumable session token; a dropped peer's
    # subscriptions / owned entities / undelivered-frame accounting are
    # PARKED for this many seconds instead of torn down, and a
    # reconnect presenting the token rebinds the new transport to the
    # parked state with zero index churn. 0 (the default) keeps the
    # pre-session disconnect path byte for byte.
    session_ttl: float = field(
        default_factory=lambda: float(_env("WQL_SESSION_TTL", "0"))
    )
    # Token bucket for resumes the governor still admits in REJECT
    # (resumes/s; handshake admission is only active with --overload
    # on). New connects shed at SHED_HIGH+; resumes shed only beyond
    # this trickle in REJECT.
    session_resume_rate: float = field(
        default_factory=lambda: float(_env("WQL_SESSION_RESUME_RATE", "200"))
    )
    # Delta ticks (spatial/delta_ticks.py, ROADMAP 2): temporal
    # coherence for the tick engine — per-cube dirty bits from the
    # churn stream, a persistent incrementally-updated device hash,
    # and result reuse (a query/entity whose neighborhood is clean
    # replays last tick instead of recomputing). 'auto' (default)
    # enables it exactly where it is proven: the device backend
    # (cuda) and pow2-cube entity planes; 'off' pins the full
    # recompute pipeline byte for byte; 'on' is auto plus a config
    # error where delta ticks cannot run (the cpu backend).
    delta_ticks: str = field(
        default_factory=lambda: _env("WQL_DELTA_TICKS", "auto")
    )
    # Churn fraction above which a delta structure falls back to the
    # full rebuild path: the entity plane's dirty-closure sub-tick and
    # the index's tombstone-scatter delta sync both revert past it.
    delta_rebuild_threshold: float = field(
        default_factory=lambda: float(
            _env("WQL_DELTA_REBUILD_THRESHOLD", "0.5")
        )
    )
    # Horizontal serving (worldql_server_tpu/cluster, ROADMAP 3):
    # with cluster_shards > 0 this process boots the ROUTER TIER — the
    # public ZMQ listener plus N supervised shard server processes,
    # each running the full engine (own device backend, WAL, entity
    # plane, governor) over a stable world→shard map, with cross-shard
    # delivery riding inter-shard shared-memory rings. 0 (the default)
    # never imports the cluster package: the single-process server is
    # byte for byte what it always was.
    cluster_shards: int = field(
        default_factory=lambda: int(_env("WQL_CLUSTER_SHARDS", "0"))
    )
    # Process role inside a cluster: '' (standalone / implied router
    # when cluster_shards > 0), 'router', or 'shard' (spawned by the
    # router-tier supervisor with a WQL_CLUSTER_SPEC topology; attaches
    # the ClusterShardExtension to an otherwise-normal server).
    cluster_role: str = field(
        default_factory=lambda: _env("WQL_CLUSTER_ROLE", "")
    )
    # Live resharding (cluster/resharding): 'on' arms the
    # router-side autoshard controller — it watches the federated
    # per-shard overload state and migrates the hottest world off a
    # sustained-hot shard automatically. 'off' (the default) never
    # self-triggers; manual POST /reshard is always available on the
    # router's HTTP surface either way.
    cluster_autoshard: str = field(
        default_factory=lambda: _env("WQL_CLUSTER_AUTOSHARD", "off")
    )
    # Byte budget for the per-migration transfer buffer: while a world
    # migrates, the router PARKS its inbound traffic here for post-flip
    # replay; past the budget frames are shed AND COUNTED
    # (cluster.reshard_buffer_shed) — bounded memory, never silent loss.
    reshard_buffer_bytes: int = field(
        default_factory=lambda: int(
            _env("WQL_RESHARD_BUFFER_BYTES", str(8 * 1024 * 1024))
        )
    )
    # Spatial query library (worldql_server_tpu/queries):
    # 'on' (the default) routes LocalMessages whose parameter names a
    # registered query kind (query.cone / query.raycast / query.knn /
    # query.density) through kind-dispatched resolution — staged kind
    # lanes, probe expansion on device backends, CPU oracles elsewhere
    # — and answers each with a reply frame. 'off' pins the
    # pre-library pipeline byte for byte: those parameters ride as
    # plain radius messages.
    query_kinds: str = field(
        default_factory=lambda: _env("WQL_QUERY_KINDS", "on")
    )
    # Stencil clamp: max probe radius in cubes a kind expansion may
    # walk (cone range / knn max-range reaches clamp to it). Part of
    # the query SEMANTICS — oracles and kernels read the same value.
    query_stencil_max: int = field(
        default_factory=lambda: int(_env("WQL_QUERY_STENCIL_MAX", "3"))
    )
    # Raycast march clamp: max half-cube steps along the segment.
    query_ray_steps: int = field(
        default_factory=lambda: int(_env("WQL_QUERY_RAY_STEPS", "64"))
    )
    # Density result clamp: top-N cubes per query.density reply (also
    # the region heatmap's gauge depth).
    query_density_top_n: int = field(
        default_factory=lambda: int(_env("WQL_QUERY_DENSITY_TOP_N", "16"))
    )
    # Device telemetry (observability/device.py): the per-tick
    # encode/h2d/compute/d2h timing split and the live
    # device-memory gauge (compile counters read 0: no jit). On by default — it only activates
    # when the spatial backend exposes device stats (cuda), and
    # its tick-path cost is one small dict diff per collect.
    device_telemetry: bool = field(
        default_factory=lambda: _env("WQL_DEVICE_TELEMETRY", "1") == "1"
    )
    # Interest-managed fan-out (worldql_server_tpu/interest, ROADMAP
    # item 3): 'on' replaces the per-entity neighbor-frame broadcast
    # with per-recipient delta frames — each peer receives a diff
    # (entered/left/moved) against its last delivered state under an
    # epoch:seq stamped wire contract (`entity.frame.full` /
    # `entity.frame.delta`), with a forced full-frame resync on every
    # loss path (reconnect, session resume, ring drop, worker loss,
    # overload shed). 'off' (the default) never constructs the
    # manager: the delivery path — frame bytes, parameter strings,
    # sequence-field absence — is byte for byte the pre-interest
    # pipeline.
    interest: str = field(
        default_factory=lambda: _env("WQL_INTEREST", "off")
    )
    # LOD cadence partition: recipients within `lod_near_radius` of a
    # neighbor entity (distance to the recipient's own entity
    # centroid) deliver every tick; farther rows deliver every
    # `lod_far_every_k` ticks (lossless deferral — the diff
    # accumulates, never drops). near_radius 0 puts every row in the
    # near cohort.
    lod_near_radius: float = field(
        default_factory=lambda: float(_env("WQL_LOD_NEAR_RADIUS", "0"))
    )
    lod_far_every_k: int = field(
        default_factory=lambda: int(_env("WQL_LOD_FAR_EVERY_K", "4"))
    )
    # Per-peer bandwidth budget (bytes/s, token bucket, 0 = off): an
    # over-budget peer degrades CADENCE first (forced far tier), then
    # coalesces to keyframe-only, and only then sheds whole keyframes
    # (`delivery.bytes_shed`) — a delta is never silently truncated,
    # so eventual-state parity holds under any budget.
    peer_bandwidth_bytes: int = field(
        default_factory=lambda: int(_env("WQL_PEER_BANDWIDTH_BYTES", "0"))
    )
    # SLO engine: 'off' (default) constructs nothing — no slo gauge,
    # no /debug/slo route, no healthz block, no slo-eval task; the
    # observable surface is byte for byte the pre-SLO server. 'on'
    # evaluates the built-in objective registry; --slo-file (JSON)
    # replaces the registry with per-objective targets/windows and
    # implies 'on'.
    slo: str = field(default_factory=lambda: _env("WQL_SLO", "off"))
    slo_file: str | None = field(
        default_factory=lambda: os.environ.get("WQL_SLO_FILE") or None
    )
    # Incident capsules: written only when incident_dir is set (and the
    # SLO engine is on). One correlated JSON bundle per BURNING
    # transition, debounced by incident_cooldown seconds, newest
    # incident_keep capsules retained.
    incident_dir: str | None = field(
        default_factory=lambda: os.environ.get("WQL_INCIDENT_DIR") or None
    )
    incident_cooldown: float = field(
        default_factory=lambda: float(_env("WQL_INCIDENT_COOLDOWN", "60"))
    )
    incident_keep: int = field(
        default_factory=lambda: int(_env("WQL_INCIDENT_KEEP", "16"))
    )

    def validate(self) -> None:
        """Cross-field validation; raises ValueError on any violation
        (args.rs:145-226, main.rs:73-98)."""
        errors: list[str] = []

        for name in (
            "sub_region_size",
            "db_region_x_size",
            "db_region_y_size",
            "db_region_z_size",
            "db_table_size",
        ):
            if getattr(self, name) <= 0:
                errors.append(f"{name} must be greater than 0")
        if self.db_cache_size < 0:
            errors.append("db_cache_size must be >= 0")

        if self.sub_region_size < 10:
            logger.warning(
                "sub-region sizes less than 10 might impact lookup performance"
            )

        if self.zmq_enabled and self.zmq_timeout_secs < 10:
            errors.append("zmq_timeout_secs must be at least 10 seconds")
        if self.max_message_size <= 0:
            errors.append("max_message_size must be greater than 0")

        for axis in ("x", "y", "z"):
            region = getattr(self, f"db_region_{axis}_size")
            if region > 0 and self.db_table_size % region != 0:
                errors.append(
                    f"db_table_size must be evenly divisible by db_region_{axis}_size"
                )

        ports = []
        if self.http_enabled:
            ports.append(("http_port", self.http_port))
        if self.ws_enabled:
            ports.append(("ws_port", self.ws_port))
        if self.zmq_enabled:
            ports.append(("zmq_server_port", self.zmq_server_port))
        seen: dict[int, str] = {}
        for name, port in ports:
            if port in seen:
                errors.append(f"{name} clashes with {seen[port]} (both {port})")
            else:
                seen[port] = name

        if self.spatial_backend == "tpu":
            errors.append(
                "spatial_backend 'tpu' is the JAX package's device index "
                "— worldql_server_tpu_torch serves it as 'cuda'"
            )
        elif self.spatial_backend not in ("cpu", "cuda", "sharded"):
            errors.append(
                "spatial_backend must be 'cpu' or 'cuda', or 'sharded' "
                "for the mesh index")
        if (
            os.environ.get("WQL_DIST_COORDINATOR")
            and self.spatial_backend != "sharded"
        ):
            # only the sharded backend joins the distributed runtime —
            # ignoring the multi-host config would silently run every
            # process single-host
            errors.append(
                "WQL_DIST_COORDINATOR is set but spatial_backend is "
                f"'{self.spatial_backend}' — multi-host requires "
                "'sharded'"
            )
        if self.tick_interval < 0:
            errors.append("tick_interval must be >= 0")
        if self.query_staging not in ("auto", "on", "off"):
            errors.append("query_staging must be 'auto', 'on' or 'off'")
        if self.query_staging == "on" and self.spatial_backend == "cpu":
            errors.append(
                "query_staging='on' requires a staging-capable spatial "
                "backend ('cuda' or 'sharded'); the CPU backend resolves "
                "per query — use 'auto' to enable staging only when "
                "supported"
            )
        if self.tick_pipeline < 1:
            errors.append("tick_pipeline must be >= 1 (1 = no overlap)")
        if self.delivery_workers < 0:
            errors.append("delivery_workers must be >= 0 (0 = in-process)")
        if self.delivery_workers:
            from ..delivery.ring import RING_MIN_BYTES

            if self.delivery_ring_bytes < RING_MIN_BYTES:
                errors.append(
                    f"delivery_ring_bytes must be >= {RING_MIN_BYTES}"
                )
        if self.durability not in ("off", "wal", "sync"):
            errors.append("durability must be 'off', 'wal' or 'sync'")
        elif self.durability != "off" and not self.wal_dir:
            errors.append(f"durability='{self.durability}' requires wal_dir")
        if self.wal_fsync_ms < 0:
            errors.append("wal_fsync_ms must be >= 0")
        if self.wal_segment_bytes <= 0:
            errors.append("wal_segment_bytes must be greater than 0")
        if self.checkpoint_interval < 0:
            errors.append("checkpoint_interval must be >= 0 (0 = no timer)")
        if self.resilience not in ("off", "on"):
            errors.append("resilience must be 'off' or 'on'")
        if self.failover_after < 1:
            errors.append("failover_after must be >= 1")
        if self.supervisor_budget < 0:
            errors.append("supervisor_budget must be >= 0")
        if self.supervisor_backoff < 0:
            errors.append("supervisor_backoff must be >= 0")
        if self.slow_tick_ms is not None and self.slow_tick_ms < 0:
            errors.append("slow_tick_ms must be >= 0 (0 = dump every tick)")
        if self.flight_recorder_depth < 1:
            errors.append("flight_recorder_depth must be >= 1")
        if self.slow_tick_ms is not None and not self.slow_tick_dir:
            errors.append("slow_tick_ms requires slow_tick_dir")
        if self.slow_frame_ms is not None and self.slow_frame_ms < 0:
            errors.append(
                "slow_frame_ms must be >= 0 (0 = dump every frame)"
            )
        if self.slow_frame_ms is not None and not self.slow_tick_dir:
            errors.append("slow_frame_ms requires slow_tick_dir")
        if self.failpoints:
            # fail at config time, not at the first armed boundary
            from ..robustness.failpoints import FailpointSpecError, parse_spec

            try:
                parse_spec(self.failpoints)
            except FailpointSpecError as exc:
                errors.append(f"failpoints: {exc}")
        if self.mesh_batch <= 0:
            errors.append("mesh_batch must be greater than 0")
        if self.mesh_space < 0:
            errors.append("mesh_space must be >= 0 (0 = all remaining devices)")
        if self.query_kinds not in ("on", "off"):
            errors.append("query_kinds must be 'on' or 'off'")
        if self.query_stencil_max < 1:
            errors.append("query_stencil_max must be >= 1")
        if self.query_ray_steps < 1:
            errors.append("query_ray_steps must be >= 1")
        if self.query_density_top_n < 1:
            errors.append("query_density_top_n must be >= 1")
        if self.entity_sim:
            if self.spatial_backend == "cpu":
                errors.append(
                    "entity_sim requires a device spatial backend "
                    "('cuda' or 'sharded') — the simulation tick "
                    "integrates and "
                    "resolves kNN on device"
                )
            if self.tick_interval <= 0:
                errors.append(
                    "entity_sim requires tick_interval > 0 — the "
                    "simulation advances once per ticker flush"
                )
        if self.max_batch < 1:
            errors.append("max_batch must be >= 1")
        if self.overload not in ("off", "on"):
            errors.append("overload must be 'off' or 'on'")
        if self.overload_tick_budget_ms < 0:
            errors.append(
                "overload_tick_budget_ms must be >= 0 (0 = derive "
                "from tick_interval)"
            )
        if self.overload_deadline_k < 1:
            errors.append("overload_deadline_k must be >= 1")
        if self.overload_recover_ticks < 1:
            errors.append("overload_recover_ticks must be >= 1")
        if self.overload_min_batch < 1:
            errors.append("overload_min_batch must be >= 1")
        if self.overload_peer_rate < 0:
            errors.append("overload_peer_rate must be >= 0 (0 = no bucket)")
        if self.overload_peer_burst < 0:
            errors.append("overload_peer_burst must be >= 0 (0 = 2x rate)")
        if self.overload_evict_after < 0:
            errors.append("overload_evict_after must be >= 0 (0 = never)")
        if self.overload_rss_limit_mb < 0:
            errors.append("overload_rss_limit_mb must be >= 0 (0 = off)")
        if self.overload_evict_after and not self.overload_peer_rate:
            errors.append(
                "overload_evict_after requires overload_peer_rate > 0 "
                "(eviction is driven by the token bucket)"
            )
        if self.session_ttl < 0:
            errors.append("session_ttl must be >= 0 (0 = sessions off)")
        if self.session_resume_rate < 0:
            errors.append(
                "session_resume_rate must be >= 0 (0 = no resumes "
                "admitted in REJECT)"
            )
        if self.delta_ticks not in ("auto", "on", "off"):
            errors.append("delta_ticks must be 'auto', 'on' or 'off'")
        if self.interest not in ("on", "off"):
            errors.append("interest must be 'on' or 'off'")
        if self.interest == "on" and not self.entity_sim:
            errors.append(
                "interest requires entity_sim — the manager diffs the "
                "entity plane's per-tick neighbor frames"
            )
        if self.lod_near_radius < 0:
            errors.append("lod_near_radius must be >= 0 (0 = all near)")
        if self.lod_far_every_k < 1:
            errors.append("lod_far_every_k must be >= 1")
        if self.peer_bandwidth_bytes < 0:
            errors.append("peer_bandwidth_bytes must be >= 0 (0 = off)")
        if self.delta_ticks == "on" and self.spatial_backend == "cpu":
            errors.append(
                "delta_ticks='on' requires a device spatial backend "
                "('cuda' or 'sharded') — the cpu backend resolves per "
                "query; use "
                "'auto' to enable delta ticks only where supported"
            )
        if not 0 < self.delta_rebuild_threshold <= 1:
            errors.append(
                "delta_rebuild_threshold must be in (0, 1]"
            )
        if self.cluster_shards < 0:
            errors.append("cluster_shards must be >= 0 (0 = no cluster)")
        if self.cluster_role not in ("", "router", "shard"):
            errors.append("cluster_role must be '', 'router' or 'shard'")
        if self.cluster_shards > 0:
            if self.cluster_role == "shard":
                errors.append(
                    "cluster_role='shard' cannot itself spawn a cluster "
                    "— cluster_shards belongs to the router tier"
                )
            if not self.zmq_enabled:
                errors.append(
                    "cluster serving requires the ZMQ listener — the "
                    "router tier owns no other client transport"
                )
            if self.ws_enabled:
                errors.append(
                    "cluster serving is ZMQ-only for now — pass --no-ws "
                    "(the router tier has no WebSocket listener; shards "
                    "boot with WS off)"
                )
        if self.cluster_role == "router" and self.cluster_shards < 1:
            errors.append("cluster_role='router' requires cluster_shards >= 1")
        if self.cluster_autoshard not in ("off", "on"):
            errors.append("cluster_autoshard must be 'off' or 'on'")
        if self.reshard_buffer_bytes < 1:
            errors.append("reshard_buffer_bytes must be >= 1")
        if self.cluster_role == "shard" and not os.environ.get(
            "WQL_CLUSTER_SPEC"
        ):
            errors.append(
                "cluster_role='shard' requires the WQL_CLUSTER_SPEC "
                "topology (set by the router-tier supervisor)"
            )
        if self.entity_k < 1:
            errors.append("entity_k must be >= 1")
        if self.entity_bounds <= 0:
            errors.append("entity_bounds must be > 0")
        if self.entity_max < 1:
            errors.append("entity_max must be >= 1")

        if self.slo not in ("off", "on"):
            errors.append("slo must be 'off' or 'on'")
        if self.slo_file is not None:
            try:
                from ..observability.slo import load_objectives

                load_objectives(self.slo_file)
            except (OSError, ValueError, json.JSONDecodeError) as exc:
                errors.append(f"slo_file: {exc}")
        if self.incident_cooldown < 0:
            errors.append("incident_cooldown must be >= 0")
        if self.incident_keep < 1:
            errors.append("incident_keep must be >= 1")
        if self.incident_dir is not None and not self.slo_enabled:
            errors.append(
                "incident_dir requires the SLO engine (--slo on or "
                "--slo-file) — capsules trigger off burn transitions"
            )

        if errors:
            raise ValueError("; ".join(errors))

    @property
    def trace_enabled(self) -> bool:
        """Tracing is on when asked for explicitly OR implied by a
        slow-tick threshold — an auto-dump without spans would be an
        empty tree."""
        return self.trace or self.slow_tick_ms is not None

    @property
    def slo_enabled(self) -> bool:
        """The SLO engine runs when asked for explicitly OR implied by
        an objective file — a registry override with the engine off
        would be dead config."""
        return self.slo == "on" or self.slo_file is not None


#: device nodes whose presence means an NVIDIA card is attached. A
#: filesystem probe instead of initializing CUDA: on a card-less host the
#: CPU boot path must not pay for driver discovery just to learn there
#: is nothing to discover.
_DEVICE_NODES = ("/dev/nvidia0",)


def accelerator_present(probe_paths=_DEVICE_NODES) -> bool:
    """True when an NVIDIA card is visibly attached. Honors the
    opt-outs: WQL_DEVICE_DEFAULTS=0 disables the probe outright, and
    WQL_TORCH_DEVICE=cpu means the operator already decided."""
    if os.environ.get("WQL_DEVICE_DEFAULTS", "1") == "0":
        return False
    if os.environ.get("WQL_TORCH_DEVICE", "").startswith("cpu"):
        return False
    return any(os.path.exists(p) for p in probe_paths)


def apply_device_boot_defaults(
    config: Config,
    *,
    backend_explicit: bool,
    interval_explicit: bool,
    present: bool | None = None,
) -> bool:
    """Default device boot of the port: with a card attached and no
    index backend expressed (no flag, no env var), a bare ``python -m
    worldql_server_tpu_torch`` serves the batched device engine —
    ``spatial_backend='cuda'`` and, unless an interval was expressed,
    ``tick_interval=0.05``. Explicit settings always win, field by
    field; on a host without a card the config is returned untouched.
    Returns whether the defaults were applied."""
    if backend_explicit or os.environ.get("WQL_SPATIAL_BACKEND"):
        return False
    if present is None:
        present = accelerator_present()
    if not present:
        return False
    config.spatial_backend = "cuda"
    if not interval_explicit and not os.environ.get("WQL_TICK_INTERVAL"):
        config.tick_interval = 0.05
    logger.info(
        "CUDA card detected — defaulting to the batched device engine "
        "(--spatial-backend cuda --tick-interval %g)",
        config.tick_interval,
    )
    return True
