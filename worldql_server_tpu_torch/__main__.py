"""CLI entry point of the PyTorch/CUDA port
(``python -m worldql_server_tpu_torch``).

The flag surface is the JAX package's. Ported: the cuda and cpu
indexes, the entity simulation, the query library, resilience, the
delivery plane (``--delivery-workers``), sessions (``--session-ttl``),
the overload governor (``--overload``), interest-managed fan-out
(``--interest``), index snapshots (``--index-snapshot``), the SLO engine
and incident capsules (``--slo``, ``--incident-dir``) and the cluster
tier (``--cluster-shards N`` boots the router and N shard servers of
this package) and the ``sharded`` mesh index (``--mesh-batch``,
``--mesh-space``; a mesh larger than the visible cards is a config
error, as in the JAX package). The device work runs on the card unless
``WQL_TORCH_DEVICE=cpu`` asks for the CPU.

Flag surface mirrors the reference's clap Args (worldql_server/src/
args.rs:21-129): every flag falls back to a ``WQL_*`` environment
variable (handled in Config), a ``.env`` file loads before anything
reads the environment (main.rs:51), ``-v`` stacks verbosity
(main.rs:54-65), validation failures exit 1 (main.rs:101-104), and
each configured listening port is probed before bring-up so a busy
port dies with a named error instead of a bind traceback
(main.rs:73-98).
"""

from __future__ import annotations

import argparse
import asyncio
import errno
import logging
import os
import socket
import sys

from .engine.config import Config
from .engine.server import WorldQLServer
from .utils import trace
from .utils.dotenv import load_dotenv
from .utils.version import full_version
from . import __version__


class _VersionAction(argparse.Action):
    """Resolve the git hash only when --version is actually requested —
    the subprocess probe must not tax every server startup."""

    def __call__(self, parser, namespace, values, option_string=None):
        print(full_version(__version__))
        parser.exit(0)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="worldql-server-tpu-torch",
        description="real-time spatial message broker — PyTorch/CUDA port",
    )
    p.add_argument("--version", action=_VersionAction, nargs=0)
    p.add_argument("--store-url", help="record store url (sqlite://PATH, memory://, postgres://…)")
    p.add_argument("--sub-region-size", type=int, help="subscription cube size (default 16)")
    p.add_argument("--db-region-x-size", type=int)
    p.add_argument("--db-region-y-size", type=int)
    p.add_argument("--db-region-z-size", type=int)
    p.add_argument("--db-table-size", type=int)
    p.add_argument("--db-cache-size", type=int)
    p.add_argument("--http-host")
    p.add_argument("--http-port", type=int)
    p.add_argument("--http-auth-token")
    p.add_argument("--no-http", action="store_true")
    p.add_argument("--ws-host")
    p.add_argument("--ws-port", type=int)
    p.add_argument("--no-ws", action="store_true")
    p.add_argument("--zmq-server-host")
    p.add_argument("--zmq-server-port", type=int)
    p.add_argument("--zmq-timeout-secs", type=int)
    p.add_argument("--no-zmq", action="store_true")
    p.add_argument("--spatial-backend",
                   choices=["cpu", "tpu", "sharded", "cuda"],
                   help="subscription index: 'cpu' (host AreaMap), "
                        "'cuda' (the device index; default on a card) or "
                        "'sharded' (the device index over a "
                        "--mesh-batch x --mesh-space mesh of cards); "
                        "'tpu' fails validation")
    p.add_argument("--tick-interval", type=float)
    p.add_argument("--tick-pipeline", type=int,
                   help="max dispatched-but-undelivered ticks: 1 "
                        "(default) = sequential flush; 2 overlaps tick "
                        "N's collect+delivery with tick N+1's "
                        "accumulation and dispatch")
    p.add_argument("--query-staging", choices=["auto", "on", "off"],
                   dest="query_staging",
                   help="columnar query staging: enqueue-time encode "
                        "into double-buffered arrays so the tick flush "
                        "dispatches with zero per-query Python (auto = "
                        "on for staging-capable backends, the default; "
                        "off = object-list path everywhere)")
    p.add_argument("--query-kinds", choices=["on", "off"],
                   dest="query_kinds",
                   help="batched spatial query library: cone / raycast "
                        "/ filtered-kNN / region-density wire queries "
                        "(query.cone, query.raycast, query.knn, "
                        "query.density) expanded on the staged "
                        "columns; 'off' routes every parameter as a "
                        "plain radius match byte for byte (default on)")
    p.add_argument("--query-stencil-max", type=int,
                   dest="query_stencil_max",
                   help="cube-stencil radius cap for kind expansion, "
                        "applied at parse AND expansion (default 3)")
    p.add_argument("--query-ray-steps", type=int, dest="query_ray_steps",
                   help="max raycast march samples per query "
                        "(default 64)")
    p.add_argument("--query-density-top-n", type=int,
                   dest="query_density_top_n",
                   help="cubes kept per query.density reply and on "
                        "the wql_region_density gauge (default 16)")
    p.add_argument("--precompile-tiers", action="store_true",
                   default=None, dest="precompile_tiers_flag",
                   help="warm the entity plane at boot: build the CUDA "
                        "kernel and run the tick at the capacity tier "
                        "and delta ladder before serving (default on)")
    p.add_argument("--no-precompile-tiers", action="store_true",
                   help="skip the boot-time warm-up")
    p.add_argument("--mesh-batch", type=int,
                   help="sharded backend: data-parallel query axis size")
    p.add_argument("--mesh-space", type=int,
                   help="sharded backend: space-shard axis size (0 = rest)")
    p.add_argument("--index-snapshot",
                   help="subscription-index snapshot file: loaded at "
                        "boot if present, saved at shutdown")
    p.add_argument("--durability", choices=["off", "wal", "sync"],
                   help="record durability: off = inline store "
                        "(reference-equivalent), wal = group-committed "
                        "WAL + write-behind store, sync = WAL + inline "
                        "store (default off)")
    p.add_argument("--wal-dir",
                   help="WAL segment directory (default ./wal)")
    p.add_argument("--wal-fsync-ms", type=float,
                   help="group-commit batching window in ms; 0 (the "
                        "default) adds no wait — batches still form "
                        "naturally while an fsync is in flight")
    p.add_argument("--wal-segment-bytes", type=int,
                   help="WAL segment rotation threshold (default 64 MiB)")
    p.add_argument("--checkpoint-interval", type=float,
                   help="seconds between store-flush/snapshot/WAL-"
                        "truncate checkpoints; 0 = shutdown-only "
                        "(default 60)")
    p.add_argument("--max-message-size", type=int,
                   help="inbound wire-message byte cap, both transports "
                        "(default 8 MiB)")
    p.add_argument("--delivery-workers", type=int, dest="delivery_workers",
                   help="sender worker processes for the sharded "
                        "delivery plane: frames pump through per-worker "
                        "shared-memory rings to processes owning "
                        "disjoint socket shards; 0 (default) = the "
                        "single-process in-process pump")
    p.add_argument("--delivery-ring-bytes", type=int,
                   dest="delivery_ring_bytes",
                   help="per-worker fan-out ring capacity in bytes "
                        "(default 4 MiB; rounded up to a power of two)")
    p.add_argument("--failpoints",
                   help="arm fault-injection failpoints, e.g. "
                        "'store.insert=error:0.2,wal.fsync=delay:5ms' "
                        "(robustness/failpoints.py; default none)")
    p.add_argument("--failpoints-seed", type=int, dest="failpoints_seed",
                   help="deterministic RNG seed for probabilistic "
                        "failpoints (chaos runs)")
    p.add_argument("--failpoints-admin", action="store_true",
                   help="expose GET/POST /failpoints on the HTTP admin "
                        "surface (gated off by default)")
    p.add_argument("--resilience", choices=["off", "on"],
                   help="wrap the spatial backend in the degraded-mode "
                        "ResilientBackend: contain device failures, "
                        "rebuild from the CPU mirror, fail over "
                        "card->CPU after --failover-after consecutive "
                        "failures (default off)")
    p.add_argument("--failover-after", type=int, dest="failover_after",
                   help="consecutive backend failures before the "
                        "card->CPU failover (default 3)")
    p.add_argument("--supervisor-budget", type=int, dest="supervisor_budget",
                   help="restarts a supervised task gets per unhealthy "
                        "streak before it is marked failed (default 5)")
    p.add_argument("--supervisor-backoff", type=float,
                   dest="supervisor_backoff",
                   help="first restart backoff in seconds, doubling to "
                        "30s (default 0.5)")
    p.add_argument("--trace", action="store_true",
                   help="enable span tracing + the tick flight "
                        "recorder (observability/): per-stage tick "
                        "traces at GET /debug/ticks, loop-lag and "
                        "GC-pause histograms (default off)")
    p.add_argument("--slow-tick-ms", type=float, dest="slow_tick_ms",
                   help="auto-dump any tick slower than this many ms "
                        "(full span tree + loop health to "
                        "<slow-tick-dir>/slow-ticks.jsonl, CRITICAL "
                        "log); 0 dumps every tick; implies --trace "
                        "(default: no dumping)")
    p.add_argument("--slow-frame-ms", type=float, dest="slow_frame_ms",
                   help="cluster shards: auto-dump any cross-shard "
                        "frame whose router-ingress→socket-write wall "
                        "exceeds this many ms (stitched stage chain to "
                        "<slow-tick-dir>/slow-frames.jsonl, CRITICAL "
                        "log); 0 dumps every frame (default: no "
                        "dumping)")
    p.add_argument("--flight-recorder-depth", type=int,
                   dest="flight_recorder_depth",
                   help="tick traces kept in the flight-recorder ring "
                        "(default 64)")
    p.add_argument("--slow-tick-dir", dest="slow_tick_dir",
                   help="directory for slow-tick dump files "
                        "(default ./slow_ticks)")
    p.add_argument("--entity-sim", action="store_true",
                   help="entity simulation plane: clients register/"
                        "update entities over the wire (the entities "
                        "list on Local/GlobalMessage) and every ticker "
                        "flush integrates + resolves per-entity kNN on "
                        "the card, delivering neighbor frames through "
                        "the fan-out path (requires --tick-interval > "
                        "0, the default when a card is attached; "
                        "default off)")
    p.add_argument("--entity-k", type=int, dest="entity_k",
                   help="neighbors resolved per entity per tick "
                        "(default 8)")
    p.add_argument("--entity-bounds", type=float, dest="entity_bounds",
                   help="world half-extent; positions reflect at "
                        "±bounds (default 1000)")
    p.add_argument("--entity-max", type=int, dest="entity_max",
                   help="live-entity hard cap (default 65536)")
    p.add_argument("--max-batch", type=int, dest="max_batch",
                   help="tick batch cap: a full queue flushes early; "
                        "also the overload governor's full-service "
                        "admitted tier (default 16384)")
    p.add_argument("--overload", choices=["off", "on"],
                   help="overload control plane: hysteretic OK/"
                        "SHED_LOW/SHED_HIGH/REJECT admission governor "
                        "— record ops never shed, globals shed last, "
                        "locals drop-oldest, entity updates coalesce "
                        "last-write-wins; per-peer token buckets; "
                        "tick-deadline degradation (default off = "
                        "today's behavior byte for byte)")
    p.add_argument("--overload-tick-budget-ms", type=float,
                   dest="overload_tick_budget_ms",
                   help="tick wall budget for deadline degradation in "
                        "ms (default 0 = derive from --tick-interval)")
    p.add_argument("--overload-deadline-k", type=int,
                   dest="overload_deadline_k",
                   help="consecutive budget busts before the admitted "
                        "batch tier halves (default 3)")
    p.add_argument("--overload-recover-ticks", type=int,
                   dest="overload_recover_ticks",
                   help="consecutive healthy samples per one-state "
                        "de-escalation / tier restore step (default 5)")
    p.add_argument("--overload-min-batch", type=int,
                   dest="overload_min_batch",
                   help="floor of the degraded admitted batch tier "
                        "(default 256)")
    p.add_argument("--overload-peer-rate", type=float,
                   dest="overload_peer_rate",
                   help="per-peer token bucket rate in msgs/s; record "
                        "ops are never dropped by it (default 0 = no "
                        "bucket)")
    p.add_argument("--overload-peer-burst", type=int,
                   dest="overload_peer_burst",
                   help="token bucket burst capacity (default 0 = "
                        "2x rate)")
    p.add_argument("--overload-evict-after", type=int,
                   dest="overload_evict_after",
                   help="evict a peer after this many consecutive "
                        "rate-limited messages (default 0 = never)")
    p.add_argument("--overload-rss-limit-mb", type=int,
                   dest="overload_rss_limit_mb",
                   help="RSS ceiling in MiB for the governor's memory "
                        "signal (default 0 = off)")
    p.add_argument("--session-ttl", type=float, dest="session_ttl",
                   help="park a dropped peer's subscriptions/entities "
                        "for this many seconds and let a reconnect "
                        "presenting its session token resume them with "
                        "zero index churn; 0 (default) = sessions off, "
                        "pre-session disconnect semantics byte for byte")
    p.add_argument("--delta-ticks", choices=["auto", "on", "off"],
                   dest="delta_ticks",
                   help="temporal-coherence delta ticks: per-cube "
                        "dirty bits, a persistent incrementally-"
                        "updated device hash, and result reuse for "
                        "clean queries/entities; 'auto' (default) "
                        "enables where supported (the cuda index), "
                        "'off' pins full recompute byte for byte")
    p.add_argument("--delta-rebuild-threshold", type=float,
                   dest="delta_rebuild_threshold",
                   help="churn fraction above which a delta structure "
                        "falls back to the full rebuild path "
                        "(default 0.5)")
    p.add_argument("--session-resume-rate", type=float,
                   dest="session_resume_rate",
                   help="resumes/s the overload governor still admits "
                        "in REJECT (new connects shed at SHED_HIGH+; "
                        "default 200)")
    p.add_argument("--cluster-shards", type=int, dest="cluster_shards",
                   help="horizontal serving: boot the router tier plus "
                        "this many supervised shard server processes "
                        "(world-sharded engines with per-shard WALs; "
                        "cross-shard delivery over inter-shard "
                        "shared-memory rings); 0 (default) = the "
                        "single-process server, byte for byte)")
    p.add_argument("--cluster-role", choices=["router", "shard"],
                   dest="cluster_role",
                   help="cluster process role: 'router' (implied by "
                        "--cluster-shards N) or 'shard' (spawned by the "
                        "router-tier supervisor; requires the "
                        "WQL_CLUSTER_SPEC topology env)")
    p.add_argument("--autoshard", choices=["off", "on"],
                   dest="cluster_autoshard",
                   help="live resharding: 'on' arms the router-side "
                        "autoshard controller (watches federated "
                        "per-shard overload state, migrates the "
                        "hottest world off a sustained-hot shard); "
                        "'off' (default) keeps migrations manual via "
                        "POST /reshard")
    p.add_argument("--reshard-buffer-bytes", type=int,
                   dest="reshard_buffer_bytes",
                   help="byte budget for a migrating world's router-"
                        "side transfer buffer; overflow frames are "
                        "shed and counted, never silently lost "
                        "(default 8 MiB)")
    p.add_argument("--interest", choices=["off", "on"],
                   help="interest-managed fan-out: per-recipient "
                        "delta frames under a stamped epoch:seq wire "
                        "contract (entity.frame.full/fullc/delta) "
                        "with forced full-frame resync on every loss "
                        "path, LOD cadence tiers and per-peer "
                        "bandwidth budgets (requires --entity-sim; "
                        "default off = the broadcast delivery path "
                        "byte for byte)")
    p.add_argument("--lod-near-radius", type=float,
                   dest="lod_near_radius",
                   help="LOD cadence partition radius: neighbors "
                        "within this distance of the recipient's own "
                        "entity centroid deliver every tick, farther "
                        "ones every --lod-far-every-k ticks as "
                        "accumulated (lossless) diffs; 0 (default) "
                        "puts every neighbor in the near cohort")
    p.add_argument("--lod-far-every-k", type=int,
                   dest="lod_far_every_k",
                   help="far-cohort delivery cadence in ticks; the "
                        "overload governor's SHED tiers widen it "
                        "(k << level) instead of skipping frames "
                        "(default 4)")
    p.add_argument("--peer-bandwidth-bytes", type=int,
                   dest="peer_bandwidth_bytes",
                   help="per-peer delivery budget in bytes/s (token "
                        "bucket): an over-budget peer degrades "
                        "cadence first, then keyframe-only, and only "
                        "then sheds whole keyframes "
                        "(delivery.bytes_shed) — deltas are never "
                        "truncated (default 0 = off)")
    p.add_argument("--slo", choices=["off", "on"],
                   help="SLO engine: evaluate the objective registry "
                        "(frame/cluster e2e p99, drop/resync rates, "
                        "per-core delivery floor, WAL fsync p99) with "
                        "fast/slow-window burn-rate alerting — the slo "
                        "gauge, a /healthz block, and GET /debug/slo "
                        "(default off = no SLO surface at all)")
    p.add_argument("--slo-file", dest="slo_file",
                   help="JSON objective registry replacing the "
                        "built-in defaults (per-objective targets and "
                        "burn windows); implies --slo on")
    p.add_argument("--incident-dir", dest="incident_dir",
                   help="write one correlated incident capsule (JSON) "
                        "here on each SLO BURNING transition; bounded "
                        "ring of --incident-keep files, listed at "
                        "GET /debug/incidents (requires the SLO "
                        "engine)")
    p.add_argument("--incident-cooldown", type=float,
                   dest="incident_cooldown",
                   help="minimum seconds between incident capsules — "
                        "a flapping objective yields exactly one "
                        "capsule per window (default 60)")
    p.add_argument("--incident-keep", type=int, dest="incident_keep",
                   help="newest N incident capsules retained on disk "
                        "(default 16)")
    p.add_argument("--no-device-telemetry", action="store_true",
                   help="disable device telemetry (jit compile/retrace "
                        "counters + loose spans, per-tick encode/h2d/"
                        "compute/d2h split, live device-buffer gauge; "
                        "default on for device backends)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


_OVERRIDES = [
    "store_url", "sub_region_size", "db_region_x_size", "db_region_y_size",
    "db_region_z_size", "db_table_size", "db_cache_size", "http_host",
    "http_port", "http_auth_token", "ws_host", "ws_port", "zmq_server_host",
    "zmq_server_port", "zmq_timeout_secs", "spatial_backend", "tick_interval",
    "tick_pipeline", "query_staging", "query_kinds", "query_stencil_max",
    "query_ray_steps", "query_density_top_n", "mesh_batch", "mesh_space",
    "index_snapshot", "max_message_size",
    "durability", "wal_dir", "wal_fsync_ms", "wal_segment_bytes",
    "checkpoint_interval", "delivery_workers", "delivery_ring_bytes",
    "failpoints", "failpoints_seed", "resilience", "failover_after",
    "supervisor_budget", "supervisor_backoff",
    "slow_tick_ms", "slow_frame_ms", "flight_recorder_depth",
    "slow_tick_dir",
    "entity_k", "entity_bounds", "entity_max",
    "max_batch", "overload", "overload_tick_budget_ms",
    "overload_deadline_k", "overload_recover_ticks",
    "overload_min_batch", "overload_peer_rate", "overload_peer_burst",
    "overload_evict_after", "overload_rss_limit_mb",
    "session_ttl", "session_resume_rate",
    "delta_ticks", "delta_rebuild_threshold",
    "cluster_shards", "cluster_role", "cluster_autoshard",
    "reshard_buffer_bytes",
    "interest", "lod_near_radius", "lod_far_every_k",
    "peer_bandwidth_bytes",
    "slo", "slo_file", "incident_dir", "incident_cooldown", "incident_keep",
]


def config_from_args(args: argparse.Namespace) -> Config:
    config = Config()
    for name in _OVERRIDES:
        value = getattr(args, name, None)
        if value is not None:
            setattr(config, name, value)
    config.http_enabled = not args.no_http
    config.ws_enabled = not args.no_ws
    config.zmq_enabled = not args.no_zmq
    if args.failpoints_admin:
        config.failpoints_admin = True
    if args.trace:
        config.trace = True
    if args.no_device_telemetry:
        config.device_telemetry = False
    if args.entity_sim:
        config.entity_sim = True
    if args.precompile_tiers_flag:
        config.precompile_tiers = True
    if args.no_precompile_tiers:
        config.precompile_tiers = False
    config.verbose = args.verbose
    return config


def _port_is_free(host: str, port: int) -> bool:
    """True unless the port is definitely taken. Resolves the address
    family (IPv6 hosts probe as IPv6), and treats only EADDRINUSE as
    busy — any other failure (unresolvable host, privileged port) is
    deferred to the real bind, which reports it accurately."""
    try:
        infos = socket.getaddrinfo(
            host or None, port, type=socket.SOCK_STREAM,
            flags=socket.AI_PASSIVE,
        )
    except socket.gaierror:
        return True
    family, type_, proto, _, addr = infos[0]
    try:
        with socket.socket(family, type_, proto) as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(addr)
    except OSError as exc:
        return exc.errno != errno.EADDRINUSE
    return True


def check_ports(config: Config) -> str | None:
    """Probe each enabled listening port; returns an error naming the
    offending flag, or None (main.rs:73-98 portpicker parity)."""
    probes = []
    if config.ws_enabled:
        probes.append(("WebSocket server", "--ws-port",
                       config.ws_host, config.ws_port))
    if config.http_enabled:
        probes.append(("HTTP server", "--http-port",
                       config.http_host, config.http_port))
    if config.zmq_enabled:
        probes.append(("ZeroMQ server", "--zmq-server-port",
                       config.zmq_server_host, config.zmq_server_port))
    for what, flag, host, port in probes:
        if not _port_is_free(host, port):
            return f"{what} port {port} ({flag}) is already in use"
    return None


def main(argv: list[str] | None = None) -> int:
    load_dotenv()
    args = build_parser().parse_args(argv)

    # -v stacks: warning → info → debug → trace-with-packet-dumps
    # (main.rs:54-65: verbosity 3 turns on the per-packet channel)
    levels = [logging.WARNING, logging.INFO, logging.DEBUG, trace.TRACE_LEVEL]
    logging.basicConfig(
        level=levels[min(args.verbose, 3)],
        format="%(asctime)s %(levelname)-7s %(name)s: %(message)s",
    )
    # re-check after load_dotenv(): the env var may have come from the
    # .env file, which loads after trace.py's import-time read
    if args.verbose >= 3 or os.environ.get("WQL_TRACE_PACKETS") == "1":
        trace.enable()

    config = config_from_args(args)
    # Default device boot: with a card attached and no index backend
    # expressed, a bare invocation serves the cuda index on a 0.05 s
    # tick; a host without a card keeps the config untouched.
    from .engine.config import apply_device_boot_defaults

    apply_device_boot_defaults(
        config,
        backend_explicit=args.spatial_backend is not None,
        interval_explicit=args.tick_interval is not None,
    )
    try:
        config.validate()
    except ValueError as exc:
        print(f"config error: {exc}", file=sys.stderr)
        return 1

    port_error = check_ports(config)
    if port_error is not None:
        print(f"config error: {port_error}", file=sys.stderr)
        return 1

    if config.spatial_backend == "sharded":
        # Mesh construction can reject shapes validate() can't see
        # (device count not divisible by mesh_batch, a mesh larger than
        # the visible cards); fail it as a config error rather than a
        # traceback from server bring-up. A multi-process mesh spans
        # every rank's cards, so the process group is joined first.
        from .parallel.mesh import (
            make_fanout_mesh, maybe_initialize_distributed)

        try:
            maybe_initialize_distributed()
            make_fanout_mesh(config.mesh_batch, config.mesh_space or None)
        except ValueError as exc:
            print(f"config error: {exc}", file=sys.stderr)
            return 1
        except RuntimeError as exc:  # the card asked for is missing
            print(f"error: {exc}", file=sys.stderr)
            return 1

    if config.cluster_shards > 0:
        # Router tier: the public listener + the supervised shard
        # processes. Never constructs a WorldQLServer of its own —
        # every world lives in exactly one shard.
        from .cluster import ClusterRuntime

        runtime = ClusterRuntime(config)
        try:
            asyncio.run(runtime.run_forever())
        except KeyboardInterrupt:
            pass
        return 0

    try:
        server = WorldQLServer(config)
    except RuntimeError as exc:  # e.g. the card asked for is missing
        print(f"error: {exc}", file=sys.stderr)
        return 1
    try:
        asyncio.run(server.run_forever())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
