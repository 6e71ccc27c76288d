"""HTTP REST ingest transport.

Rebuild of the reference's axum server
(worldql_server/src/transport/http/http_rest.rs): a single route
``POST /global_message`` taking JSON ``{parameter?, world_name}``,
injected as a GlobalMessage with nil sender and ExceptSelf replication
(http_rest.rs:40-60). Optional static bearer-token auth
(http_rest.rs:85-98); success replies 204 No Content (http_rest.rs:104).
HTTP callers are never peers — this is a fire-and-forget
server→clients bridge (e.g. webhooks).
"""

from __future__ import annotations

import logging

from aiohttp import web

from ..protocol import Instruction, Message, Replication
from ..protocol.types import NIL_UUID
from ..robustness import failpoints

logger = logging.getLogger(__name__)


class HttpTransport:
    def __init__(self, server):
        self.server = server
        self._runner: web.AppRunner | None = None

    async def start(self) -> None:
        config = self.server.config
        app = web.Application()
        app.router.add_post("/global_message", self._post_global_message)
        # Observability beyond the reference (SURVEY §5: it has neither
        # a health endpoint nor metrics).
        app.router.add_get("/healthz", self._get_healthz)
        app.router.add_get("/metrics", self._get_metrics)
        if config.failpoints_admin:
            # fault-injection toggle — an explicit operator opt-in
            # (WQL_FAILPOINTS_ADMIN=1 / --failpoints-admin); absent
            # otherwise, so the route 404s like any unknown path
            app.router.add_get("/failpoints", self._get_failpoints)
            app.router.add_post("/failpoints", self._post_failpoints)
        if getattr(self.server, "heatmap", None) is not None:
            # region-density heatmap feed (queries/heatmap.py) — exists
            # only with the query library on, 404s otherwise
            app.router.add_get("/debug/heatmap", self._get_debug_heatmap)
        if getattr(self.server, "recorder", None) is not None:
            # flight recorder debug surface — exists only when tracing
            # is on (--trace / --slow-tick-ms), 404s otherwise
            app.router.add_get("/debug/ticks", self._get_debug_ticks)
            app.router.add_post("/debug/profile", self._post_debug_profile)
            app.router.add_get("/debug/profile", self._get_debug_profile)
        if getattr(self.server, "slo", None) is not None:
            # SLO burn-state report — exists only with --slo on /
            # --slo-file, 404s otherwise
            app.router.add_get("/debug/slo", self._get_debug_slo)
        if getattr(self.server, "incidents", None) is not None:
            # incident capsule ring — exists only with --incident-dir
            app.router.add_get("/debug/incidents", self._get_debug_incidents)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, config.http_host, config.http_port)
        await site.start()
        logger.info(
            "HTTP server listening on %s:%s", config.http_host, config.http_port
        )

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    def _authorized(self, request: web.Request) -> bool:
        token = self.server.config.http_auth_token
        if token is None:
            return True
        auth = request.headers.get("Authorization", "")
        return auth.startswith("Bearer ") and auth[len("Bearer "):] == token

    async def _get_healthz(self, request: web.Request) -> web.Response:
        body = {"status": "ok"}
        # Durability state rides health (queue depth, WAL segments,
        # last recovery) — an operator probing a draining/replaying
        # node needs this before scraping full metrics. Omitted when
        # durability is off so the reference-equivalent body stays
        # byte-for-byte identical.
        status_fn = getattr(self.server, "durability_status", None)
        status = status_fn() if status_fn is not None else None
        if status is not None:
            body["durability"] = status
        # Supervision state: per-task health plus the tasks_unhealthy
        # gauge. Only present once something is actually supervised,
        # so minimal servers keep the reference-shaped body.
        supervisor = getattr(self.server, "supervisor", None)
        if supervisor is not None and supervisor.task_count():
            stats = supervisor.stats()
            body["tasks_unhealthy"] = stats["tasks_unhealthy"]
            body["supervisor"] = stats
            if stats["tasks_unhealthy"]:
                body["status"] = "degraded"
        # Degraded-mode spatial backend (ResilientBackend): failover is
        # THE signal an orchestrator restarts a node on.
        res_fn = getattr(self.server, "resilience_status", None)
        resilience = res_fn() if res_fn is not None else None
        if resilience is not None:
            body["resilience"] = resilience
            if resilience["degraded"]:
                body["status"] = "degraded"
        # Delivery-plane state (worker liveness + drop counters): a
        # retired or dead sender worker is a capacity loss the
        # orchestrator should see without scraping /metrics. Absent
        # with --delivery-workers 0 (reference-shaped body).
        dlv_fn = getattr(self.server, "delivery_status", None)
        delivery = dlv_fn() if dlv_fn is not None else None
        if delivery is not None:
            body["delivery"] = delivery
            if delivery["degraded"]:
                body["status"] = "degraded"
        # Session continuity (parked/resumed/expired accounting): a
        # reconnect storm's progress — how many peers are parked and
        # how fast resumes are landing — is the first thing an
        # operator needs mid-blip. Absent with --session-ttl 0
        # (reference-shaped body).
        ses_fn = getattr(self.server, "sessions_status", None)
        sessions = ses_fn() if ses_fn is not None else None
        if sessions is not None:
            body["sessions"] = sessions
        # Overload governor (admission state + shed accounting): an
        # orchestrator deciding whether to scale out needs the
        # governor's state before anything else. SHED_HIGH/REJECT
        # report degraded — the node is up but refusing work. Absent
        # with --overload off (reference-shaped body).
        ovl_fn = getattr(self.server, "overload_status", None)
        overload = ovl_fn() if ovl_fn is not None else None
        if overload is not None:
            body["overload"] = overload
            if overload["state_level"] >= 2:
                body["status"] = "degraded"
        # SLO burn state (worst objective + who is burning): BURNING
        # means the node is violating a declared objective RIGHT NOW —
        # degraded, even though it is serving. Absent with --slo off
        # (reference-shaped body).
        slo_fn = getattr(self.server, "slo_status", None)
        slo = slo_fn() if slo_fn is not None else None
        if slo is not None:
            body["slo"] = slo
            if slo["burning"]:
                body["status"] = "degraded"
        # Which device serves the index and the entity plane: the port
        # runs on the card unless asked for the CPU, and a cluster
        # shard is a process of its own. Absent on a host index without
        # an entity plane.
        dev_fn = getattr(self.server, "device_status", None)
        devices = dev_fn() if dev_fn is not None else None
        if devices is not None:
            body["device"] = devices
        # Flight-recorder state (slow-tick count front and center): an
        # operator probing a limping node sees HOW MANY ticks blew the
        # threshold before scraping anything. Absent when tracing is
        # off so the minimal body stays reference-shaped.
        recorder = getattr(self.server, "recorder", None)
        if recorder is not None:
            body["flight_recorder"] = recorder.stats()
        return web.json_response(body)

    async def _get_debug_ticks(self, request: web.Request) -> web.Response:
        """Flight-recorder dump: the last N tick traces (plus the loose
        message/WAL spans). ``?format=chrome`` renders Trace Event
        Format JSON loadable in chrome://tracing / ui.perfetto.dev."""
        if not self._authorized(request):
            return web.Response(status=401)
        recorder = self.server.recorder
        ticks = recorder.snapshot()
        if request.query.get("format") == "chrome":
            from ..observability.export import chrome_trace

            # named pid lane: a shard's dump
            # says which shard it is, a standalone server says so too
            cluster = getattr(self.server, "cluster", None)
            process_name = (
                f"shard-{cluster.shard_id}" if cluster is not None
                else "worldql-server"
            )
            return web.json_response(
                chrome_trace(
                    ticks + recorder.loose_snapshot(),
                    process_name=process_name,
                )
            )
        return web.json_response({
            "recorder": recorder.stats(),
            "ticks": ticks,
            "loose": recorder.loose_snapshot(),
        })

    async def _get_debug_slo(self, request: web.Request) -> web.Response:
        """Full SLO report: per-objective state, fast/slow burn rates,
        budget-remaining, transition counts, and (on a router) every
        shard's piggybacked compliance summary."""
        if not self._authorized(request):
            return web.Response(status=401)
        return web.json_response(self.server.slo.status())

    async def _get_debug_incidents(self, request: web.Request) -> web.Response:
        """Incident capsule ring: no query = the index (id, seq,
        objective, size); ``?id=incident-NNNN-<objective>`` = the full
        capsule JSON."""
        if not self._authorized(request):
            return web.Response(status=401)
        incidents = self.server.incidents
        incident_id = request.query.get("id")
        if incident_id is None:
            return web.json_response({
                "incidents": incidents.list(),
                "stats": incidents.stats(),
            })
        capsule = incidents.load(incident_id)
        if capsule is None:
            return web.Response(status=404)
        return web.json_response(capsule)

    async def _get_debug_heatmap(self, request: web.Request) -> web.Response:
        """Region-density snapshot: the decayed per-cube counts feeding
        the ``wql_region_density`` gauge, grouped by world — the raw
        heatmap a dashboard tiles. ``?n=`` caps the per-world rows."""
        if not self._authorized(request):
            return web.Response(status=401)
        try:
            n = int(request.query.get("n", 0)) or None
        except ValueError:
            return web.Response(status=400)
        return web.json_response(self.server.heatmap.snapshot(n=n))

    async def _get_debug_profile(self, request: web.Request) -> web.Response:
        if not self._authorized(request):
            return web.Response(status=401)
        return web.json_response(self.server.profiler.status())

    async def _post_debug_profile(self, request: web.Request) -> web.Response:
        """Device-level escalation: JSON ``{"action": "start", "dir":
        PATH}`` begins a torch.profiler capture, ``{"action": "stop"}``
        ends it (the Chrome-trace JSON lands in the start dir)."""
        if not self._authorized(request):
            return web.Response(status=401)
        try:
            body = await request.json()
            action = body.get("action")
        except Exception:
            return web.Response(status=400)
        profiler = self.server.profiler
        try:
            if action == "start":
                log_dir = body.get("dir")
                if not isinstance(log_dir, str) or not log_dir:
                    return web.json_response(
                        {"error": "start requires a 'dir' string"},
                        status=400,
                    )
                profiler.start(log_dir)
            elif action == "stop":
                profiler.stop()
            else:
                return web.json_response(
                    {"error": "action must be 'start' or 'stop'"},
                    status=400,
                )
        except RuntimeError as exc:  # double start / stop without start
            return web.json_response({"error": str(exc)}, status=409)
        except Exception as exc:  # profiler backend error
            logger.exception("torch profiler hook failed")
            return web.json_response({"error": str(exc)}, status=500)
        return web.json_response(profiler.status())

    async def _get_failpoints(self, request: web.Request) -> web.Response:
        if not self._authorized(request):
            return web.Response(status=401)
        return web.json_response({
            "active": failpoints.registry.active(),
            "points": failpoints.registry.stats(),
        })

    async def _post_failpoints(self, request: web.Request) -> web.Response:
        """Replace the armed failpoint set: JSON ``{"spec": "...",
        "seed": N?}`` or a raw text spec body. An empty spec disarms
        everything."""
        if not self._authorized(request):
            return web.Response(status=401)
        try:
            if "application/json" in request.headers.get("Content-Type", ""):
                body = await request.json()
                spec = body.get("spec", "")
                seed = body.get("seed")
            else:
                spec = (await request.text()).strip()
                seed = None
            if not isinstance(spec, str) or not (
                seed is None or isinstance(seed, int)
            ):
                raise ValueError("wrong field types")
            failpoints.registry.configure(spec, seed=seed)
        except failpoints.FailpointSpecError as exc:
            return web.json_response({"error": str(exc)}, status=400)
        except Exception:
            return web.Response(status=400)
        return web.json_response({
            "active": failpoints.registry.active(),
            "points": failpoints.registry.stats(),
        })

    async def _get_metrics(self, request: web.Request) -> web.Response:
        if not self._authorized(request):
            return web.Response(status=401)
        # Content negotiation: callers that ask for JSON (dashboards,
        # the test suite) get the structured snapshot; everything else
        # — Prometheus scrapers send Accept: text/plain /
        # openmetrics-text — gets the standard exposition format.
        if "application/json" in request.headers.get("Accept", ""):
            return web.json_response(self.server.metrics.snapshot())
        return web.Response(
            text=self.server.metrics.render_prometheus(),
            content_type="text/plain",
            charset="utf-8",
        )

    async def _post_global_message(self, request: web.Request) -> web.Response:
        if not self._authorized(request):
            return web.Response(status=401)

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
            sender_uuid=NIL_UUID,
            world_name=world_name,
            replication=Replication.EXCEPT_SELF,
        )
        await self.server.router.handle_message(message)
        return web.Response(status=204)
