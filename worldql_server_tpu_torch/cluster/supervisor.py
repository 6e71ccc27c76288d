"""Shard process supervision: boot, monitor, restart the shard tier.

The router process owns N shard SERVER processes (each a full
``python -m worldql_server_tpu_torch --cluster-role shard`` boot: its own
event loop, spatial backend, WAL + recovery, entity plane, governor).
This module is the part of the router that keeps them alive:

* creates the inter-shard ring mesh (``bus.create_ring_mesh``) ONCE —
  ring shared-memory outlives any single shard process, so a SIGKILLed
  shard re-attaches the same conduits on restart and drains what
  queued while it was down;
* spawns each shard with its topology in ``WQL_CLUSTER_SPEC`` (shard
  id, ring names, control-socket path, router port) and a derived
  argv (:func:`shard_argv`) that gives every shard its OWN zmq port,
  OWN wal dir, OWN store and OWN /healthz port while inheriting every
  engine knob from the router's config;
* runs one control-channel reader per shard (the delivery-plane
  idiom: AF_UNIX SOCK_SEQPACKET, JSON datagrams, EOF == death):
  shard→router packets carry governor state for the router's shed
  mirror and peer-teardown notices for proxy reaping; router→shard
  packets carry peer adoption/drop for the remote-proxy plane;
* restarts a dead shard with exponential backoff (counted in
  ``cluster.shard_restarts``) and replays the adoption state through
  ``on_shard_ready`` — the shard comes back owning exactly the same
  worlds (stable WorldMap hash) and replays its own WAL, so records
  survive the kill with no cross-shard coordination.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import shlex
import signal
import socket
import subprocess
import sys
import tempfile
import time

from .bus import create_ring_mesh

logger = logging.getLogger(__name__)

#: env var carrying the shard's topology (JSON; see shard spec below)
CLUSTER_SPEC_ENV = "WQL_CLUSTER_SPEC"

#: flags forwarded verbatim from the router's Config to every shard —
#: the shard tier IS the existing engine, so every engine knob applies
_PASSTHROUGH_FLAGS = (
    ("sub_region_size", "--sub-region-size"),
    ("spatial_backend", "--spatial-backend"),
    ("tick_interval", "--tick-interval"),
    ("tick_pipeline", "--tick-pipeline"),
    ("query_staging", "--query-staging"),
    ("mesh_batch", "--mesh-batch"),
    ("mesh_space", "--mesh-space"),
    ("durability", "--durability"),
    ("wal_fsync_ms", "--wal-fsync-ms"),
    ("wal_segment_bytes", "--wal-segment-bytes"),
    ("checkpoint_interval", "--checkpoint-interval"),
    ("max_message_size", "--max-message-size"),
    ("delivery_workers", "--delivery-workers"),
    ("delivery_ring_bytes", "--delivery-ring-bytes"),
    ("resilience", "--resilience"),
    ("failover_after", "--failover-after"),
    ("supervisor_budget", "--supervisor-budget"),
    ("supervisor_backoff", "--supervisor-backoff"),
    ("max_batch", "--max-batch"),
    ("overload", "--overload"),
    ("overload_tick_budget_ms", "--overload-tick-budget-ms"),
    ("overload_deadline_k", "--overload-deadline-k"),
    ("overload_recover_ticks", "--overload-recover-ticks"),
    ("overload_min_batch", "--overload-min-batch"),
    ("overload_peer_rate", "--overload-peer-rate"),
    ("overload_peer_burst", "--overload-peer-burst"),
    ("overload_evict_after", "--overload-evict-after"),
    ("overload_rss_limit_mb", "--overload-rss-limit-mb"),
    ("session_ttl", "--session-ttl"),
    ("session_resume_rate", "--session-resume-rate"),
    ("delta_ticks", "--delta-ticks"),
    ("delta_rebuild_threshold", "--delta-rebuild-threshold"),
    ("entity_k", "--entity-k"),
    ("entity_bounds", "--entity-bounds"),
    ("entity_max", "--entity-max"),
    ("zmq_timeout_secs", "--zmq-timeout-secs"),
)


def shard_zmq_port(config, shard_id: int) -> int:
    """Shard i's inbound ZMQ port: public port + 1 + i (the router owns
    the public port; shards sit behind it on the next N)."""
    return config.zmq_server_port + 1 + shard_id


def shard_http_port(config, shard_id: int) -> int:
    """Shard i's /healthz + /metrics port (router http port + 1 + i);
    only bound when the router's HTTP surface is enabled."""
    return config.http_port + 1 + shard_id


def shard_store_url(config, shard_id: int) -> str:
    """Per-shard record store. SQLite paths get a ``.shard<i>`` suffix
    (one file per shard — the per-shard durability unit); ``memory://``
    is inherently per-process; anything else (postgres) is shared —
    worlds are disjoint across shards, so shards never contend on the
    same rows."""
    url = config.store_url
    if url.startswith("sqlite://"):
        return f"{url}.shard{shard_id}"
    return url


def shard_wal_dir(config, shard_id: int) -> str:
    return os.path.join(config.wal_dir, f"shard-{shard_id}")


def shard_argv(config, shard_id: int) -> list[str]:
    """The shard process's full command line, derived from the router's
    config: same engine knobs, per-shard ports/store/WAL, WS off (the
    cluster's client surface is the router's ZMQ listener)."""
    argv = [
        sys.executable, "-m", "worldql_server_tpu_torch",
        "--cluster-role", "shard",
        "--no-ws",
        "--zmq-server-host", config.zmq_server_host,
        "--zmq-server-port", str(shard_zmq_port(config, shard_id)),
        "--store-url", shard_store_url(config, shard_id),
        "--wal-dir", shard_wal_dir(config, shard_id),
    ]
    if config.http_enabled:
        argv += [
            "--http-host", config.http_host,
            "--http-port", str(shard_http_port(config, shard_id)),
        ]
    else:
        argv.append("--no-http")
    for field, flag in _PASSTHROUGH_FLAGS:
        argv += [flag, str(getattr(config, field))]
    if not config.precompile_tiers:
        argv.append("--no-precompile-tiers")
    if config.entity_sim:
        argv.append("--entity-sim")
    if config.trace:
        argv.append("--trace")
    if config.slow_tick_ms is not None:
        argv += ["--slow-tick-ms", str(config.slow_tick_ms)]
    if config.slow_frame_ms is not None:
        argv += ["--slow-frame-ms", str(config.slow_frame_ms)]
    if config.slow_tick_ms is not None or config.slow_frame_ms is not None:
        argv += ["--slow-tick-dir",
                 os.path.join(config.slow_tick_dir, f"shard-{shard_id}")]
    if config.index_snapshot:
        argv += ["--index-snapshot",
                 f"{config.index_snapshot}.shard{shard_id}"]
    if config.slo_enabled:
        # shards judge their LOCAL objectives and piggyback compliance
        # on the state packets; incidents stay router-side (the fleet
        # capsule pulls every shard's sections over the dump channel),
        # so --incident-dir deliberately does NOT propagate
        argv += ["--slo", "on"]
        if config.slo_file:
            argv += ["--slo-file", config.slo_file]
    if config.failpoints:
        argv += ["--failpoints", config.failpoints]
    if config.failpoints_seed is not None:
        argv += ["--failpoints-seed", str(config.failpoints_seed)]
    if config.verbose:
        argv.append("-" + "v" * min(config.verbose, 3))
    return argv


class _ShardProc:
    """One shard slot: the current process generation plus its control
    channel and last-reported state."""

    def __init__(self, idx: int):
        self.idx = idx
        self.gen = 0
        self.proc: subprocess.Popen | None = None
        self.ctl: socket.socket | None = None
        self.reader: asyncio.Task | None = None
        self.alive = False
        self.ready = asyncio.Event()
        self.state: dict = {}        # last {"op": "state"} payload
        self.state_at = 0.0
        self.restarts = 0
        self.born = 0.0


class ClusterSupervisor:
    """Owns the shard processes + ring mesh + control channels for one
    router. ``on_shard_ready(idx)`` fires after every (re)boot once the
    shard's control channel is up — the router replays peer adoptions
    there; ``on_shard_down(idx)`` fires when a shard dies;
    ``on_shard_message(idx, msg)`` receives every shard→router control
    packet (state reports, peer teardown notices)."""

    def __init__(
        self, config, n_shards: int, *, metrics=None,
        on_shard_ready=None, on_shard_down=None, on_shard_message=None,
        spawn_timeout: float = 60.0,
    ):
        self.config = config
        self.n_shards = n_shards
        self.metrics = metrics
        self.on_shard_ready = on_shard_ready
        self.on_shard_down = on_shard_down
        self.on_shard_message = on_shard_message
        self.spawn_timeout = spawn_timeout
        self._mesh: dict | None = None
        self._dir: str | None = None
        self._shards = [_ShardProc(i) for i in range(n_shards)]
        self._stopping = False
        self._restarters: set[asyncio.Task] = set()

    # region: lifecycle

    async def start(self) -> None:
        self._dir = tempfile.mkdtemp(prefix="wql-cluster-")
        self._mesh = create_ring_mesh(
            self.n_shards, self.config.delivery_ring_bytes
        )
        await asyncio.gather(
            *(self._bring_up(s) for s in self._shards)
        )
        logger.info(
            "cluster shard tier up: %d shard processes behind the "
            "router", self.n_shards,
        )

    async def _bring_up(self, shard: _ShardProc) -> None:
        path = os.path.join(self._dir, f"s{shard.idx}-{shard.gen}.sock")
        lsock = socket.socket(socket.AF_UNIX, socket.SOCK_SEQPACKET)
        lsock.bind(path)
        lsock.listen(1)
        lsock.setblocking(False)
        spec = {
            "shard_id": shard.idx,
            "n_shards": self.n_shards,
            "ctl_path": path,
            "rings": self._mesh["names"][shard.idx],
            "router_zmq_port": self.config.zmq_server_port,
        }
        env = dict(os.environ)
        env[CLUSTER_SPEC_ENV] = json.dumps(spec)
        # the shard must import THIS package even when the router was
        # launched from an unrelated cwd with no installed dist — the
        # parent provably imported it, so export its root
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        ))
        env["PYTHONPATH"] = (
            pkg_root + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else pkg_root
        )
        argv = shard_argv(self.config, shard.idx)
        logger.info(
            "spawning shard %d (gen %d): %s",
            shard.idx, shard.gen, shlex.join(argv[2:]),
        )
        proc = await asyncio.to_thread(subprocess.Popen, argv, env=env)
        loop = asyncio.get_running_loop()
        try:
            ctl, _ = await asyncio.wait_for(
                loop.sock_accept(lsock), self.spawn_timeout
            )
            ctl.setblocking(False)
            ready = json.loads(await asyncio.wait_for(
                loop.sock_recv(ctl, 65536), self.spawn_timeout
            ))
            if ready.get("op") != "ready":
                raise RuntimeError(
                    f"unexpected first shard packet: {ready}"
                )
        except Exception:
            if proc.poll() is None:
                proc.kill()
            raise
        finally:
            lsock.close()
            try:
                os.unlink(path)
            except OSError:
                pass
        shard.proc, shard.ctl = proc, ctl
        shard.alive = True
        shard.born = time.monotonic()
        shard.ready.set()
        shard.reader = asyncio.create_task(  # wql: allow(unsupervised-task) — the reader IS the shard monitor; its EOF path drives restart
            self._reader(shard), name=f"cluster-shard-{shard.idx}"
        )
        if self.on_shard_ready is not None:
            self.on_shard_ready(shard.idx)

    async def stop(self) -> None:
        self._stopping = True
        for task in list(self._restarters):
            task.cancel()
        for shard in self._shards:
            if shard.proc is not None and shard.proc.poll() is None:
                shard.proc.send_signal(signal.SIGTERM)
        for shard in self._shards:
            if shard.proc is not None:
                try:
                    await asyncio.to_thread(shard.proc.wait, 10)
                except subprocess.TimeoutExpired:
                    logger.warning(
                        "shard %d did not stop — killing", shard.idx
                    )
                    shard.proc.kill()
                    await asyncio.to_thread(shard.proc.wait, 10)
            if shard.reader is not None:
                shard.reader.cancel()
                try:
                    await shard.reader
                except (asyncio.CancelledError, Exception):
                    pass
                shard.reader = None
            if shard.ctl is not None:
                shard.ctl.close()
                shard.ctl = None
            shard.alive = False
        if self._mesh is not None:
            for ring in self._mesh["rings"].values():
                ring.close()
                ring.unlink()
            self._mesh = None
        if self._dir is not None:
            try:
                os.rmdir(self._dir)
            except OSError:
                pass

    # endregion

    # region: control channel

    def ctl_send(self, idx: int, msg: dict) -> bool:
        """Bounded-retry control send to shard ``idx`` (non-blocking
        socket; control volume is handshake-rate)."""
        shard = self._shards[idx]
        if not shard.alive or shard.ctl is None:
            return False
        data = json.dumps(msg).encode()
        deadline = time.monotonic() + 1.0
        while True:
            try:
                shard.ctl.send(data)
                return True
            except (BlockingIOError, InterruptedError):
                if time.monotonic() >= deadline:
                    return False
                time.sleep(0.005)
            except OSError:
                return False

    async def _reader(self, shard: _ShardProc) -> None:
        """Drain shard→router packets; EOF means the shard died and
        triggers the restart path."""
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
                if msg.get("op") == "state":
                    shard.state = msg
                    shard.state_at = time.monotonic()
                if self.on_shard_message is not None:
                    try:
                        self.on_shard_message(shard.idx, msg)
                    except Exception:
                        logger.exception(
                            "shard %d control handler failed", shard.idx
                        )
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
        except asyncio.CancelledError:
            raise
        if not self._stopping and shard.alive:
            await self._shard_down(shard)

    async def _shard_down(self, shard: _ShardProc) -> None:
        shard.alive = False
        shard.ready.clear()
        if shard.ctl is not None:
            shard.ctl.close()
            shard.ctl = None
        rc = None
        if shard.proc is not None:
            try:
                rc = await asyncio.to_thread(shard.proc.wait, 10)
            except subprocess.TimeoutExpired:
                shard.proc.kill()
        logger.warning(
            "cluster shard %d died (exit %s) — restarting", shard.idx, rc,
        )
        if self.metrics is not None:
            self.metrics.inc("cluster.shard_deaths")
        if self.on_shard_down is not None:
            try:
                self.on_shard_down(shard.idx)
            except Exception:
                logger.exception("shard-down handler failed")
        task = asyncio.create_task(  # wql: allow(unsupervised-task) — restart driver; retained below
            self._restart(shard), name=f"cluster-restart-{shard.idx}"
        )
        self._restarters.add(task)
        task.add_done_callback(self._restarters.discard)

    async def _restart(self, shard: _ShardProc) -> None:
        """Respawn with exponential backoff. Unlimited attempts by
        design: the shard owns worlds no other process can serve, so
        the router keeps trying until its orchestrator intervenes —
        every attempt is counted and visible in /healthz."""
        backoff = 0.2
        while not self._stopping:
            shard.gen += 1
            shard.restarts += 1
            if self.metrics is not None:
                self.metrics.inc("cluster.shard_restarts")
            try:
                await self._bring_up(shard)
                return
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception(
                    "shard %d restart failed — retrying in %.1fs",
                    shard.idx, backoff,
                )
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 5.0)

    # endregion

    # region: state for the router

    def shard_state(self, idx: int) -> dict:
        return self._shards[idx].state

    def shard_alive(self, idx: int) -> bool:
        return self._shards[idx].alive

    def shard_pid(self, idx: int) -> int | None:
        """The current incarnation's pid (None before first boot) —
        the federation's /proc CPU accounting reads it."""
        proc = self._shards[idx].proc
        return proc.pid if proc is not None else None

    def kill_shard(self, idx: int, sig: int = 9) -> bool:
        """Chaos helper: signal shard ``idx``'s current incarnation
        (default SIGKILL — no cleanup handlers run). The normal
        death→restart machinery takes it from there; the resharding
        kill-at-every-protocol-state suite drives this at each step.
        True when a signal was delivered."""
        proc = self._shards[idx].proc
        if proc is None or proc.returncode is not None:
            return False
        try:
            proc.send_signal(sig)
            return True
        except ProcessLookupError:
            return False

    def alive_count(self) -> int:
        return sum(1 for s in self._shards if s.alive)

    def stats(self) -> dict:
        return {
            "shards": self.n_shards,
            "alive": self.alive_count(),
            "restarts": sum(s.restarts for s in self._shards),
        }

    # endregion
