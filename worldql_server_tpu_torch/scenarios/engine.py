"""Adversarial scenario engine.

Benchmarks drive well-behaved synthetic load; here the governor,
durability, session and entity planes meet an adversary. A
:class:`Scenario` here is a first-class, declarative
hostile workload: it boots a REAL :class:`WorldQLServer` over real
ZeroMQ sockets, drives a shaped storm against it, and then evaluates
a declared list of survival + SLO :class:`Check` s — no lost resumed
state, bounded handshake p99, governor back to OK, exact shed
accounting — producing one structured report.

The same library serves three masters:

* ``python -m worldql_server_tpu_torch.scenarios`` — operator/CI CLI
  (``--check`` exits non-zero on any failed check);
* ``chip_smoke.py`` — every scenario at ``--shape full`` on the card,
  any failed check failing the run;
* pytest — tests/test_torch_scenarios.py runs the smoke shapes
  directly.

Shapes: every scenario sizes itself from ``shape`` ∈ {"smoke",
"full"} — smoke is tuned for a 1-core CI container (seconds, tiny
tick budgets so storms bite), full for a real box.
"""

from __future__ import annotations

import asyncio
import logging
import time
import traceback
from dataclasses import dataclass

from ..engine.config import Config
from ..engine.server import WorldQLServer
from ..protocol.types import Instruction, Message
from ..robustness import failpoints
from .client import ZmqPeer

logger = logging.getLogger(__name__)


def pctl(samples: list[float], q: float) -> float | None:
    if not samples:
        return None
    ordered = sorted(samples)
    return ordered[min(len(ordered) - 1, max(0, int(len(ordered) * q) - 1))]


@dataclass
class Check:
    """One declared survival/SLO assertion, evaluated post-drive."""

    name: str
    ok: bool
    value: object
    limit: object
    detail: str = ""

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "ok": self.ok,
            "value": self.value,
            "limit": self.limit,
            "detail": self.detail,
        }


class ScenarioContext:
    """What a scenario's ``drive``/``checks`` get to work with: the
    live server plus wire-client and drain/recovery helpers."""

    def __init__(self, server: WorldQLServer, config: Config, shape: str):
        self.server = server
        self.config = config
        self.shape = shape
        self.smoke = shape == "smoke"
        self.clients: list[ZmqPeer] = []

    async def connect(self, attempts: int = 100,
                      opened: ZmqPeer | None = None, **kwargs) -> ZmqPeer:
        """A handshaken client (its shed handshakes retried). With
        ``opened`` (``ZmqPeer.open``), the first attempt is that client's
        handshake alone."""
        last: Exception | str | None = None
        for _ in range(attempts):
            try:
                if opened is not None:
                    first, opened = opened, None
                    peer = await first.handshake(
                        kwargs.get("token"), kwargs.get("timeout", 5.0)
                    )
                else:
                    peer = await ZmqPeer.connect(
                        self.config.zmq_server_port, **kwargs
                    )
            except Exception as exc:
                last = exc
                await asyncio.sleep(0.02)
                continue
            if peer.refused:
                # A shed handshake is NOT a connection: the server
                # never registered the peer, so every message it sends
                # from here on is dropped as unknown-sender. Honor the
                # retry-after hint and try again. (Scenarios probing
                # refusal semantics use ZmqPeer.connect directly.)
                last = f"handshake shed, retry-after {peer.retry_after_ms} ms"
                hint_s = (peer.retry_after_ms or 20) / 1000.0
                peer.close()
                await asyncio.sleep(min(hint_s, 0.5))
                continue
            self.clients.append(peer)
            return peer
        raise AssertionError(f"scenario client could not connect: {last!r}")

    def counters(self) -> dict:
        return self.server.metrics.snapshot()["counters"]

    async def drain_ticker(self, timeout_s: float = 10.0) -> bool:
        ticker = self.server.ticker
        if ticker is None:
            return True
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            if not ticker._queue and not ticker.inflight():
                return True
            await asyncio.sleep(0.01)
        return False

    async def wait_governor_ok(self, timeout_s: float = 15.0) -> bool:
        gov = self.server.governor
        if gov is None:
            return True
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            if gov.state == "ok" and not gov.degraded():
                return True
            await asyncio.sleep(0.02)
        return False

    async def heartbeat_ok(self, peer: ZmqPeer,
                           timeout_s: float = 5.0) -> bool:
        """Survival probe: the broker still answers on the wire."""
        try:
            await peer.send(Message(instruction=Instruction.HEARTBEAT))
            await peer.recv_until(Instruction.HEARTBEAT, timeout_s)
            return True
        except Exception:
            return False


class Scenario:
    """Base: subclasses declare a config, a drive and their checks."""

    name = "scenario"
    description = ""
    #: whether the scenario belongs in the DEFAULT CLI set — the
    #: CI-blocking "Scenario smoke" step runs exactly these; slow or
    #: special-lifecycle scenarios opt out and run by explicit name
    ci_smoke = True
    #: boot the server AS A TASK and hand ``drive`` the in-flight
    #: start (``ctx.start_task``) — for storms that must land
    #: mid-boot, e.g. during WAL replay. The drive owns awaiting it.
    concurrent_boot = False

    def build_config(self, shape: str) -> Config:
        raise NotImplementedError

    def build_backend(self):
        """Optional explicit spatial backend (e.g. a tiny compaction
        threshold so the delta path's full fold is reachable at smoke
        churn volumes); None = the config-built default."""
        return None

    async def drive(self, ctx: ScenarioContext) -> dict:
        """Run the hostile workload; returns the SLO value dict the
        checks (and the bench record) are computed from."""
        raise NotImplementedError

    def checks(self, ctx: ScenarioContext, slo: dict) -> list[Check]:
        raise NotImplementedError


async def _run_async(scenario: Scenario, shape: str) -> dict:
    # scenarios may arm failpoints (deterministic phases); never leak
    # them into the next scenario or the embedding process
    failpoints.registry.reset()
    config = scenario.build_config(shape)
    if getattr(config, "cluster_shards", 0) > 0:
        # cluster scenarios drive the ROUTER TIER — shard server
        # subprocesses plus the in-process router — through the same
        # Scenario surface (the runtime mirrors the server's
        # metrics/shutdown contract; ticker/governor are per shard)
        from ..cluster import ClusterRuntime

        server = ClusterRuntime(config)
    else:
        server = WorldQLServer(config, backend=scenario.build_backend())
    start_task = None
    if scenario.concurrent_boot:
        start_task = asyncio.ensure_future(server.start())
    else:
        await server.start()
    ctx = ScenarioContext(server, config, shape)
    ctx.start_task = start_task
    t0 = time.perf_counter()
    error = None
    slo: dict = {}
    checks: list[Check] = []
    try:
        slo = await scenario.drive(ctx)
        # evaluated BEFORE teardown: checks read live server state
        checks = list(scenario.checks(ctx, slo))
    except Exception as exc:
        error = f"{type(exc).__name__}: {exc}"
        logger.error(
            "scenario %s crashed:\n%s", scenario.name,
            traceback.format_exc(),
        )
    finally:
        for peer in ctx.clients:
            try:
                peer.close()
            except Exception:
                pass
        failpoints.registry.reset()
        if start_task is not None:
            # a concurrent boot must complete (or surface its error)
            # before teardown — stopping a half-started server leaks
            try:
                await start_task
            except Exception as exc:
                error = error or f"boot: {type(exc).__name__}: {exc}"
        # where the device work ran (the index's and the entity plane's
        # device, K7's launches in this process); None for a host
        # index or the router tier, whose shards report their own
        device_status = getattr(server, "device_status", None)
        device = device_status() if device_status is not None else None
        await server.stop()
    survived = error is None and not server.shutdown_requested.is_set()
    checks.insert(0, Check(
        "survived", survived, bool(survived), True, error or "",
    ))
    failed = sum(1 for c in checks if not c.ok)
    return {
        "scenario": scenario.name,
        "shape": shape,
        "survived": survived,
        "wall_s": round(time.perf_counter() - t0, 2),
        "slo": slo,
        "checks": [c.as_dict() for c in checks],
        "checks_failed": failed,
        "error": error,
        "device": device,
    }


def run_scenario(name: str, shape: str = "smoke") -> dict:
    """Run one catalog scenario to a report dict (new event loop)."""
    from . import CATALOG

    scenario = CATALOG[name]()
    return asyncio.run(_run_async(scenario, shape))


def format_report(report: dict) -> str:
    lines = [
        f"scenario {report['scenario']} ({report['shape']}): "
        f"{'PASS' if report['checks_failed'] == 0 else 'FAIL'} "
        f"in {report['wall_s']}s — "
        f"{report['checks_failed']} failed check(s)"
    ]
    for check in report["checks"]:
        mark = "ok " if check["ok"] else "FAIL"
        lines.append(
            f"  [{mark}] {check['name']}: {check['value']!r}"
            f" (limit {check['limit']!r})"
            + (f" — {check['detail']}" if check["detail"] else "")
        )
    return "\n".join(lines)
