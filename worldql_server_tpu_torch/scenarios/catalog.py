"""The adversarial scenario catalog.

Four hostile workloads, each giving a different plane its adversary:

* :class:`FlashCrowd` — the whole population converges on ONE cube:
  Zipf hotspot fan-out + overload shedding together.
* :class:`BattleRoyale` — shrinking world bounds force sustained
  position churn through the spatial index's base+delta path.
* :class:`ReconnectStorm` — mass hard-drop then simultaneous resume
  under load, spiked with a 10x new-connect storm: the session plane's
  zero-loss guarantee and the handshake admission class under fire.
* :class:`GameTick` — a mixed record/query/entity-shaped game tick:
  the "boring" workload that must stay boring while governed.

Every scenario sizes itself per shape ("smoke" = 1-core CI seconds,
"full" = a real box) and declares its survival + SLO checks; the
runner (engine.py) turns them into one structured report consumed by
the CLI, chip_smoke.py and the test suite.
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid as uuid_mod

import numpy as np

from ..engine.config import Config
from ..protocol.types import Entity, Instruction, Message, Record, Vector3
from ..robustness import failpoints
from .client import ZmqPeer, free_port, free_port_block
from .engine import Check, Scenario, ScenarioContext, pctl


def _storm_config(**overrides) -> Config:
    """The deliberately throttled shape every storm scenario starts
    from: a tiny tick budget + tiny admitted floor means ANY sustained
    flood busts the deadline and engages the governor, even on a
    1-core container (the test_overload_storm calibration)."""
    config = Config(
        store_url="memory://",
        http_enabled=False, ws_enabled=False,
        zmq_server_host="127.0.0.1", zmq_server_port=free_port(),
        spatial_backend="cpu", tick_interval=0.02,
        max_batch=64, overload="on",
        overload_tick_budget_ms=0.5, overload_min_batch=8,
        overload_deadline_k=2, overload_recover_ticks=5,
        trace=True,
        supervisor_backoff=0.005,
    )
    for key, value in overrides.items():
        setattr(config, key, value)
    return config


class FlashCrowd(Scenario):
    """Flash-crowd migration: a spread population (one cube each)
    suddenly converges on a single cube and floods it — every local
    fans to everyone, the hotspot stresses fan-out and admission at
    once. Survival means: queue bounded by the admission cap, every
    shed message accounted exactly, governor back to OK after."""

    name = "flash_crowd"
    description = "whole population converges on one cube"

    def build_config(self, shape: str) -> Config:
        return _storm_config()

    async def drive(self, ctx: ScenarioContext) -> dict:
        n_clients = 6 if ctx.smoke else 16
        spread_s = 0.4 if ctx.smoke else 2.0
        converge_s = 1.2 if ctx.smoke else 6.0
        hot = Vector3(5.0, 5.0, 5.0)

        clients = [await ctx.connect() for _ in range(n_clients)]
        # spread phase: everyone in their OWN cube, light paced chat
        for i, c in enumerate(clients):
            await c.send(Message(
                instruction=Instruction.AREA_SUBSCRIBE,
                world_name="arena", position=Vector3(i * 160.0, 0.0, 0.0),
            ))
        end = time.perf_counter() + spread_s
        while time.perf_counter() < end:
            for i, c in enumerate(clients):
                await c.send(Message(
                    instruction=Instruction.LOCAL_MESSAGE,
                    world_name="arena",
                    position=Vector3(i * 160.0, 0.0, 0.0),
                    parameter="spread",
                ))
            await asyncio.sleep(0.02)

        # convergence: everyone subscribes the hot cube, then floods it
        for c in clients:
            await c.send(Message(
                instruction=Instruction.AREA_SUBSCRIBE,
                world_name="arena", position=hot,
            ))
        gov = ctx.server.governor
        offered = 0

        async def flood(client: ZmqPeer) -> int:
            sent = 0
            end = time.perf_counter() + converge_s
            while time.perf_counter() < end:
                await client.send(Message(
                    instruction=Instruction.LOCAL_MESSAGE,
                    world_name="arena", position=hot, parameter="crowd",
                ))
                sent += 1
                # a send the socket takes at once does not yield, and
                # the server runs on this event loop: without a yield
                # each flood runs its whole window alone, the floods
                # one after another (16 x 6 s at full shape), while the
                # broker's loop starves — its stale-peer sweep then
                # evicts the silent flooders (no heartbeat for
                # zmq_timeout_secs) and the probe below is dropped
                await asyncio.sleep(0)
            return sent

        offered = sum(await asyncio.gather(*(flood(c) for c in clients)))
        queue_peak_bounded = (
            len(ctx.server.ticker._queue) <= gov.local_queue_cap()
        )
        drained = await ctx.drain_ticker()
        recovered = await ctx.wait_governor_ok()
        counters = ctx.counters()
        seen = counters.get("messages.local_message", 0)
        flushed = counters.get("tick.messages", 0)
        alive = await ctx.heartbeat_ok(clients[0])
        return {
            "clients": n_clients,
            "offered": offered,
            "seen": seen,
            "flushed": flushed,
            "drop_oldest": gov.drop_oldest,
            "shed_local": gov.shed["local"],
            "governor_peak_level": gov.peak_level,
            "queue_bounded": queue_peak_bounded,
            "drained": drained,
            "recovered_to_ok": recovered,
            "broker_answers": alive,
        }

    def checks(self, ctx: ScenarioContext, slo: dict) -> list[Check]:
        gov = ctx.server.governor
        shed_total = slo["drop_oldest"] + slo["shed_local"]
        return [
            Check("hotspot_escalated_governor",
                  slo["governor_peak_level"] >= 1,
                  slo["governor_peak_level"], ">= 1"),
            Check("queue_bounded_by_admission_cap", slo["queue_bounded"],
                  slo["queue_bounded"], True),
            Check("shed_accounting_exact",
                  slo["seen"] == slo["flushed"] + shed_total,
                  slo["seen"], slo["flushed"] + shed_total,
                  "seen == flushed + drop_oldest + shed_local"),
            Check("governor_recovered_to_ok", slo["recovered_to_ok"],
                  gov.state, "ok"),
            Check("broker_answers_after_storm", slo["broker_answers"],
                  slo["broker_answers"], True),
        ]


class BattleRoyale(Scenario):
    """Battle-royale shrinking bounds: the play area halves phase
    after phase and every entity's owner streams it toward the center
    — sustained cube churn through the index's base+delta path (fold,
    tombstones, compaction) while the sim tick keeps running."""

    name = "battle_royale"
    description = "shrinking bounds drive sustained base+delta churn"

    def build_config(self, shape: str) -> Config:
        return Config(
            store_url="memory://",
            http_enabled=False, ws_enabled=False,
            zmq_server_host="127.0.0.1", zmq_server_port=free_port(),
            spatial_backend="cuda", tick_interval=0.02,
            entity_sim=True, precompile_tiers=False,
            sub_region_size=16,
        )

    def build_backend(self):
        # a tiny compaction threshold makes the delta path's full
        # base+delta fold reachable at smoke churn volumes (the
        # bench config 8 calibration); the index takes the device
        # resolve_device gives, as the server's entity plane does
        from ..spatial.cuda_backend import CudaSpatialBackend

        return CudaSpatialBackend(16, compact_threshold=8)

    async def drive(self, ctx: ScenarioContext) -> dict:
        n_entities = 48 if ctx.smoke else 512
        phases = 4 if ctx.smoke else 8
        rng = np.random.default_rng(7)
        owner = await ctx.connect()
        ids = [uuid_mod.uuid4() for _ in range(n_entities)]
        pos = rng.uniform(-600.0, 600.0, size=(n_entities, 3))

        def batch(positions) -> Message:
            return Message(
                instruction=Instruction.LOCAL_MESSAGE,
                world_name="royale",
                entities=[
                    Entity(uuid=ids[i], world_name="royale",
                           position=Vector3(*positions[i]))
                    for i in range(n_entities)
                ],
            )

        await owner.send(batch(pos))
        plane = ctx.server.entity_plane
        deadline = time.perf_counter() + 10.0
        while plane.entity_count < n_entities:
            if time.perf_counter() > deadline:
                raise AssertionError("entity registration never landed")
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.1)  # a few applied ticks at full spread

        backend = ctx.server.backend
        moves0 = plane.index_moves
        for _ in range(phases):
            # the circle shrinks: every entity's owner streams it
            # toward the center — cube crossings ride the delta path
            pos = pos * 0.45
            await owner.send(batch(pos))
            await asyncio.sleep(0.12)  # several applied ticks
        drained = await ctx.drain_ticker()
        # compactions COUNT at the swap-in flush after the background
        # fold completes — drain the worker, then flush once more (the
        # test_entity_sim idiom), so the SLO reads the settled value
        wait = getattr(backend, "wait_compaction", None)
        if wait is not None:
            wait()
            backend.flush()
        alive = await ctx.heartbeat_ok(owner)
        final = plane._pos[: plane._cap][plane._live[: plane._cap]]
        return {
            "entities": plane.entity_count,
            "registered": n_entities,
            "applied_ticks": plane.applied_ticks,
            "dropped_ticks": plane.dropped_ticks,
            "index_moves": plane.index_moves - moves0,
            "compactions": int(getattr(backend, "compactions", 0)),
            "index_rows": len(plane._sub_refs),
            "final_spread": float(np.abs(final).max()) if final.size else 0.0,
            "drained": drained,
            "broker_answers": alive,
        }

    def checks(self, ctx: ScenarioContext, slo: dict) -> list[Check]:
        return [
            Check("population_intact",
                  slo["entities"] == slo["registered"],
                  slo["entities"], slo["registered"]),
            Check("sim_kept_ticking", slo["applied_ticks"] > 0,
                  slo["applied_ticks"], "> 0"),
            Check("no_dropped_ticks", slo["dropped_ticks"] == 0,
                  slo["dropped_ticks"], 0),
            Check("churn_rode_delta_path", slo["index_moves"] > 0,
                  slo["index_moves"], "> 0"),
            Check("delta_churn_compacted", slo["compactions"] >= 1,
                  slo["compactions"], ">= 1"),
            Check("index_rows_bounded",
                  slo["index_rows"] <= slo["registered"],
                  slo["index_rows"], f"<= {slo['registered']}",
                  "refcounted (world,cube,peer) rows never exceed "
                  "the population"),
            Check("broker_answers_after_churn", slo["broker_answers"],
                  slo["broker_answers"], True),
        ]


class ReconnectStorm(Scenario):
    """Hostile-swarm reconnect storm: every client hard-drops at once,
    then resumes simultaneously — under background flood, spiked with
    a 10x new-connect storm — and a deterministic forced-REJECT phase
    proves the admission asymmetry (new sheds with a retry-after hint;
    resume still admitted). The tentpole guarantee under test: zero
    subscription/entity loss for sessions resumed within TTL."""

    name = "reconnect_storm"
    description = "mass drop + simultaneous resume + 10x connect storm"

    def build_config(self, shape: str) -> Config:
        return _storm_config(
            spatial_backend="cuda", entity_sim=True,
            precompile_tiers=False,
            session_ttl=30.0, session_resume_rate=500.0,
            # the adversary here is the CONNECT storm, not the tick
            # budget: the budget must be meetable by an idle device
            # tick on a 1-core container or the governor can never
            # de-escalate after the storm passes
            overload_tick_budget_ms=50.0,
        )

    def build_backend(self):
        from ..spatial.cuda_backend import CudaSpatialBackend

        return CudaSpatialBackend(16)

    async def drive(self, ctx: ScenarioContext) -> dict:
        n = 6 if ctx.smoke else 24
        ents_per = 4
        storm_factor = 10
        server = ctx.server
        plane = server.entity_plane
        sessions = server.sessions

        # population: subscriptions + owned entities per client
        swarm: list[ZmqPeer] = []
        ent_ids: list[list[uuid_mod.UUID]] = []

        async def register(i: int) -> None:
            await swarm[i].send(Message(
                instruction=Instruction.LOCAL_MESSAGE,
                world_name="arena",
                entities=[
                    Entity(uuid=ent_ids[i][j], world_name="arena",
                           position=Vector3(i * 40.0, float(j), 0.0))
                    for j in range(ents_per)
                ],
            ))

        # COLD FIRST-TICK WARM-UP. With precompile_tiers=False the
        # first device tick with entities staged pays the cold costs
        # the boot tier walk would have paid: loading the kNN kernel
        # (building it when the kernel cache lacks it) and the tier's
        # first allocations — many times the 50 ms tick budget, so the
        # governor can escalate straight to REJECT off that single
        # bust and shed one-shot registrations ("entity registration
        # never landed"). Pay it ONCE with a throwaway entity — resent
        # until it lands, since the very updates that trigger the cold
        # tick are also the ones REJECT sheds — then let the governor
        # walk back to OK before the measured population begins.
        warm = await ctx.connect()
        warm_ent = uuid_mod.uuid4()
        deadline = time.perf_counter() + 45.0
        while plane.entity_count < 1:
            if time.perf_counter() > deadline:
                raise AssertionError("warm-up registration never landed")
            await warm.send(Message(
                instruction=Instruction.LOCAL_MESSAGE,
                world_name="arena",
                entities=[Entity(uuid=warm_ent, world_name="arena",
                                 position=Vector3(-40.0, 0.0, 0.0))],
            ))
            await asyncio.sleep(0.25)
        # entity_count advances at STAGING time — before the cold
        # tick even starts — so drain the ticker (the cold tick runs
        # inside a tick; inflight() covers it) before sampling the
        # governor, or the bust lands right after this wait and the
        # swarm's handshakes walk into the shed window.
        await ctx.drain_ticker(30.0)
        await ctx.wait_governor_ok(30.0)
        base = plane.entity_count

        for i in range(n):
            c = await ctx.connect()
            swarm.append(c)
            ent_ids.append([uuid_mod.uuid4() for _ in range(ents_per)])
            await c.send(Message(
                instruction=Instruction.AREA_SUBSCRIBE,
                world_name="arena", position=Vector3(i * 40.0, 0.0, 0.0),
            ))
            await register(i)
        # Residual shed risk: the population itself can cross a tier
        # boundary and pay a cold tier AGAIN. Registrations are idempotent LWW
        # upserts keyed by entity uuid, so RESEND until they admit;
        # the deadline still bounds the wait.
        deadline = time.perf_counter() + 45.0
        last_resend = time.perf_counter()
        while plane.entity_count - base < n * ents_per:
            if time.perf_counter() > deadline:
                gov = server.governor
                raise AssertionError(
                    "entity registration never landed: "
                    f"entity_count={plane.entity_count} base={base} "
                    f"target={n * ents_per} "
                    f"governor={gov.state if gov else None} "
                    f"shed={dict(gov.shed) if gov else None} "
                    f"ingest={server.entity_ingest.stats() if server.entity_ingest else None}"
                )
            if time.perf_counter() - last_resend > 1.0:
                last_resend = time.perf_counter()
                for i in range(n):
                    await register(i)
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.1)
        subs0 = server.backend.subscription_count()
        ents0 = plane.entity_count
        tokens = [(c.token, c.uuid) for c in swarm]
        assert all(t for t, _ in tokens), "sessions were not minted"

        # MASS DROP: every socket dies with no goodbye; the server
        # notices through its normal eviction path (the staleness
        # sweep's removal call) and parks each session
        for c in swarm:
            c.close()
        for _, u in tokens:
            await server.peer_map.remove(u)
        parked = sessions.parked_count()

        # RECONNECT STORM: all resumes at once + a 10x new-connect
        # storm + background flood on the hot path
        flooder = await ctx.connect()
        await flooder.send(Message(
            instruction=Instruction.AREA_SUBSCRIBE,
            world_name="arena", position=Vector3(5.0, 5.0, 5.0),
        ))
        stop_flood = False

        async def flood():
            while not stop_flood:
                await flooder.send(Message(
                    instruction=Instruction.LOCAL_MESSAGE,
                    world_name="arena", position=Vector3(5.0, 5.0, 5.0),
                    parameter="bg",
                ))
                # the server shares this event loop: yield after every
                # send, or a send the socket takes at once starves the
                # storm's handshakes and the broker (FlashCrowd's flood)
                await asyncio.sleep(0)

        resume_walls: list[float] = []
        resumed: dict[int, ZmqPeer] = {}

        async def resume_one(i: int, token: str, opened: ZmqPeer) -> None:
            t0 = time.perf_counter()
            peer = await ctx.connect(token=token, peer_uuid=opened.uuid,
                                     opened=opened)
            resume_walls.append((time.perf_counter() - t0) * 1e3)
            resumed[i] = peer

        refused_or_timeout = 0

        async def new_connect(opened: ZmqPeer) -> None:
            nonlocal refused_or_timeout
            try:
                peer = await opened.handshake(timeout=2.0)
                if peer.refused:
                    refused_or_timeout += 1
                    peer.close()
                else:
                    ctx.clients.append(peer)
            except Exception:
                refused_or_timeout += 1  # silent shed (hint budget)

        # every storm client opens its sockets before the storm: each
        # owns a zmq context (an I/O thread) and binds a port, and the
        # broker shares this event loop — opened inside the storm, the
        # 11n clients' set-up (a millisecond or more each) runs
        # before the broker reads the first handshake and lands in
        # every resume's wall
        port = ctx.config.zmq_server_port
        resumers = [ZmqPeer.open(port, peer_uuid=u) for _, u in tokens]
        newcomers = [ZmqPeer.open(port) for _ in range(storm_factor * n)]
        flood_task = asyncio.ensure_future(flood())
        try:
            await asyncio.gather(
                *(resume_one(i, t, peer) for i, ((t, _), peer)
                  in enumerate(zip(tokens, resumers))),
                *(new_connect(peer) for peer in newcomers),
            )
        finally:
            stop_flood = True
            await flood_task
        subs1 = server.backend.subscription_count()
        ents1 = plane.entity_count

        # resumed peers still OWN their parked entities: a post-resume
        # update from every client must apply (ownership is enforced
        # server-side, so this also proves the rebind kept identity)
        updates0 = plane.updates
        for i, peer in resumed.items():
            await peer.send(Message(
                instruction=Instruction.LOCAL_MESSAGE,
                world_name="arena",
                entities=[Entity(
                    uuid=ent_ids[i][0], world_name="arena",
                    position=Vector3(i * 40.0 + 1.0, 0.0, 0.0),
                )],
            ))
        deadline = time.perf_counter() + 5.0
        while plane.updates < updates0 + len(resumed):
            if time.perf_counter() > deadline:
                break
            await asyncio.sleep(0.02)

        # DETERMINISTIC REJECT PHASE: force the state machine to
        # REJECT and pin the admission asymmetry — new connect refused
        # with a retry-after hint, resume still admitted
        failpoints.registry.set("overload.force_state", "state:reject")
        await asyncio.sleep(0.1)  # ticker evaluates → forced state
        probe_new = await ZmqPeer.connect(
            ctx.config.zmq_server_port, timeout=2.0
        )
        ctx.clients.append(probe_new)
        reject_refused = probe_new.refused
        retry_hint = probe_new.retry_after_ms
        victim = resumed[0]
        ownership_held = plane.updates - updates0
        victim_token, victim_uuid = victim.token, victim.uuid
        victim.close()
        await server.peer_map.remove(victim_uuid)
        reresumed = await ctx.connect(
            token=victim_token, peer_uuid=victim_uuid
        )
        reject_resume_ok = reresumed.token == victim_token
        failpoints.registry.clear()

        drained = await ctx.drain_ticker()
        recovered = await ctx.wait_governor_ok()
        gov = server.governor
        alive = await ctx.heartbeat_ok(reresumed)
        return {
            "swarm": n,
            "parked": parked,
            "resumed": len(resume_walls),
            "resume_p99_ms": round(pctl(resume_walls, 0.99) or 0.0, 1),
            "resume_p50_ms": round(pctl(resume_walls, 0.50) or 0.0, 1),
            "new_connect_attempts": storm_factor * n,
            "new_refused_or_shed": refused_or_timeout,
            "subscriptions_before": subs0,
            "subscriptions_after": subs1,
            "entities_before": ents0,
            "entities_after": ents1,
            "post_resume_updates_applied": ownership_held,
            "reject_new_refused": reject_refused,
            "reject_retry_after_ms": retry_hint,
            "reject_resume_admitted": reject_resume_ok,
            "shed_handshake_new": gov.shed["handshake_new"],
            "shed_handshake_resume": gov.shed["handshake_resume"],
            "sessions": sessions.stats(),
            "governor_peak_level": gov.peak_level,
            "drained": drained,
            "recovered_to_ok": recovered,
            "broker_answers": alive,
        }

    def checks(self, ctx: ScenarioContext, slo: dict) -> list[Check]:
        gov = ctx.server.governor
        # "bounded", not "fast": smoke runs a saturating flood + the
        # whole connect storm time-shared on ONE CI core — the bound
        # catches a wedged/livelocked handshake path (tens of seconds
        # to never), not scheduler contention
        p99_limit = 5000.0 if ctx.smoke else 500.0
        return [
            Check("all_sessions_parked", slo["parked"] == slo["swarm"],
                  slo["parked"], slo["swarm"]),
            Check("all_resumes_landed", slo["resumed"] == slo["swarm"],
                  slo["resumed"], slo["swarm"]),
            Check("zero_subscription_loss",
                  slo["subscriptions_after"] >= slo["subscriptions_before"],
                  slo["subscriptions_after"],
                  f">= {slo['subscriptions_before']}",
                  "parked index rows survived the drop+resume cycle"),
            Check("zero_entity_loss",
                  slo["entities_after"] == slo["entities_before"],
                  slo["entities_after"], slo["entities_before"]),
            Check("resumed_peers_kept_ownership",
                  slo["post_resume_updates_applied"] >= slo["swarm"],
                  slo["post_resume_updates_applied"],
                  f">= {slo['swarm']}",
                  "an update per resumed client applied to its own "
                  "parked entity"),
            Check("resume_p99_bounded_under_storm",
                  slo["resume_p99_ms"] <= p99_limit,
                  slo["resume_p99_ms"], f"<= {p99_limit} ms"),
            Check("reject_sheds_new_with_retry_hint",
                  bool(slo["reject_new_refused"])
                  and (slo["reject_retry_after_ms"] or 0) > 0,
                  slo["reject_retry_after_ms"], "> 0 ms",
                  "forced REJECT refused the new connect and hinted"),
            Check("reject_still_admits_resume",
                  bool(slo["reject_resume_admitted"]),
                  slo["reject_resume_admitted"], True),
            Check("handshake_sheds_accounted",
                  gov.shed["handshake_new"] >= 1,
                  gov.shed["handshake_new"], ">= 1"),
            Check("governor_recovered_to_ok", slo["recovered_to_ok"],
                  gov.state, "ok"),
            Check("broker_answers_after_storm", slo["broker_answers"],
                  slo["broker_answers"], True),
        ]


class GameTick(Scenario):
    """Mixed record/query/entity-shaped game tick: every client, at a
    fixed cadence, sends a positioned local (the movement packet), an
    occasional durable record (the inventory write) and a global (the
    chat line). The boring workload that must STAY boring: every
    record lands, fan-out flows, the governor never has to leave OK."""

    name = "game_tick"
    description = "mixed record/query/pub-sub workload at game cadence"

    def build_config(self, shape: str) -> Config:
        return _storm_config(
            # realistic budget: the mixed load is sustainable by
            # design — this scenario proves the governed server at
            # normal load IS the ungoverned server
            overload_tick_budget_ms=50.0,
        )

    async def drive(self, ctx: ScenarioContext) -> dict:
        n_clients = 4 if ctx.smoke else 16
        ticks = 40 if ctx.smoke else 400
        cadence_s = 0.02
        hot = Vector3(3.0, 3.0, 3.0)
        region = Vector3(1.0, 2.0, 3.0)

        clients = [await ctx.connect() for _ in range(n_clients)]
        for c in clients:
            await c.send(Message(
                instruction=Instruction.AREA_SUBSCRIBE,
                world_name="match", position=hot,
            ))
        received = 0
        stop_count = False

        async def count_frames():
            nonlocal received
            while not stop_count:
                try:
                    m = await clients[0].recv(0.25)
                except asyncio.TimeoutError:
                    continue
                if m.instruction == Instruction.LOCAL_MESSAGE:
                    received += 1

        counter_task = asyncio.ensure_future(count_frames())
        hb_walls: list[float] = []
        records_sent = 0
        from ..protocol.types import Record

        try:
            for t in range(ticks):
                t0 = time.perf_counter()
                for i, c in enumerate(clients):
                    await c.send(Message(
                        instruction=Instruction.LOCAL_MESSAGE,
                        world_name="match", position=hot,
                        parameter=f"move{t}",
                    ))
                    if t % 5 == i % 5:
                        records_sent += 1
                        await c.send(Message(
                            instruction=Instruction.RECORD_CREATE,
                            world_name="match",
                            records=[Record(
                                uuid=uuid_mod.uuid4(), position=region,
                                world_name="match", data=f"inv{t}",
                            )],
                        ))
                    if t % 10 == 0 and i == 0:
                        await c.send(Message(
                            instruction=Instruction.GLOBAL_MESSAGE,
                            world_name="match", parameter=f"chat{t}",
                        ))
                if t % 8 == 0:
                    hb0 = time.perf_counter()
                    if await ctx.heartbeat_ok(clients[-1], 5.0):
                        hb_walls.append(
                            (time.perf_counter() - hb0) * 1e3
                        )
                pace = cadence_s - (time.perf_counter() - t0)
                if pace > 0:
                    await asyncio.sleep(pace)
            drained = await ctx.drain_ticker()
            await asyncio.sleep(0.1)
        finally:
            stop_count = True
            await counter_task
        rows = await ctx.server.router.durability.get_records_in_region(
            "match", region
        )
        gov = ctx.server.governor
        counters = ctx.counters()
        return {
            "clients": n_clients,
            "ticks": ticks,
            "records_sent": records_sent,
            "records_stored": len({sr.record.uuid for sr in rows}),
            "locals_seen": counters.get("messages.local_message", 0),
            "frames_received_probe": received,
            "heartbeat_p99_ms": round(pctl(hb_walls, 0.99) or 0.0, 1),
            "governor_peak_level": gov.peak_level,
            "shed_total": gov.drop_oldest + gov.shed["local"],
            "drained": drained,
        }

    def checks(self, ctx: ScenarioContext, slo: dict) -> list[Check]:
        hb_limit = 1000.0 if ctx.smoke else 100.0
        return [
            Check("every_record_landed",
                  slo["records_stored"] == slo["records_sent"],
                  slo["records_stored"], slo["records_sent"]),
            Check("fanout_flowed", slo["frames_received_probe"] > 0,
                  slo["frames_received_probe"], "> 0"),
            Check("nothing_shed_at_game_load", slo["shed_total"] == 0,
                  slo["shed_total"], 0,
                  "a sustainable mixed workload must not be degraded "
                  "by the governor's presence"),
            Check("heartbeat_p99_bounded",
                  slo["heartbeat_p99_ms"] <= hb_limit,
                  slo["heartbeat_p99_ms"], f"<= {hb_limit} ms"),
            Check("queue_drained", slo["drained"], slo["drained"], True),
        ]


def _cube_of(x: float, y: float, z: float, size: int) -> tuple[int, int, int]:
    """The subscription-cube label of a position — computed through the
    REAL quantizer, so scenario expectations can never drift from the
    max-corner grid convention."""
    from ..spatial.quantize import cube_coords_batch

    row = cube_coords_batch(np.array([[x, y, z]], np.float64), size)[0]
    return tuple(int(c) for c in row)


async def _query_roundtrip(peer: ZmqPeer, world: str, position: Vector3,
                           wire: str, payload: dict,
                           timeout: float = 10.0) -> dict:
    """Send one kind query over the wire and await ITS reply frame
    (``<wire>.result``), decoded from the JSON flex body."""
    await peer.send(Message(
        instruction=Instruction.LOCAL_MESSAGE, world_name=world,
        position=position, parameter=wire,
        flex=json.dumps(payload).encode("utf-8"),
    ))
    deadline = time.perf_counter() + timeout
    while True:
        left = deadline - time.perf_counter()
        if left <= 0:
            raise asyncio.TimeoutError(f"no {wire}.result within {timeout}s")
        reply = await peer.recv(left)
        if (
            reply.instruction == Instruction.LOCAL_MESSAGE
            and reply.parameter == f"{wire}.result"
            and reply.flex
        ):
            return json.loads(reply.flex.decode("utf-8"))


class SniperScope(Scenario):
    """Cone-of-sight + raycast over the real wire: a sniper
    peer interrogates a laid-out world through ``query.cone`` and
    ``query.raycast`` LocalMessages and every reply frame is checked
    against the EXACT geometric expectation — narrow cone sees only the
    on-axis targets, widening past 90° admits the flanker but never the
    peer behind, first-hit returns the nearest occupied cube before the
    farther one, an empty ray is still answered, the sender never
    appears in its own results, and a hostile malformed payload is
    dropped with a counter while the session survives."""

    name = "sniper_scope"
    description = "cone + raycast queries with exact geometric answers"

    def build_config(self, shape: str) -> Config:
        return Config(
            store_url="memory://",
            http_enabled=False, ws_enabled=False,
            zmq_server_host="127.0.0.1", zmq_server_port=free_port(),
            spatial_backend="cuda", tick_interval=0.02,
            precompile_tiers=False,
            sub_region_size=16,
        )

    async def drive(self, ctx: ScenarioContext) -> dict:
        world = "scope"
        sniper = await ctx.connect()
        # the range: one cube-spaced lane along +x from the sniper, a
        # flanker 90° off-axis, a target square behind the scope
        layout = {
            "near": Vector3(24.0, 8.0, 8.0),
            "far": Vector3(40.0, 8.0, 8.0),
            "flank": Vector3(8.0, 40.0, 8.0),
            "behind": Vector3(-24.0, 8.0, 8.0),
        }
        targets = {name: await ctx.connect() for name in layout}
        apex = Vector3(8.0, 8.0, 8.0)
        await sniper.send(Message(
            instruction=Instruction.AREA_SUBSCRIBE,
            world_name=world, position=apex,
        ))
        for name, peer in targets.items():
            await peer.send(Message(
                instruction=Instruction.AREA_SUBSCRIBE,
                world_name=world, position=layout[name],
            ))
        deadline = time.perf_counter() + 10.0
        while ctx.server.backend.subscription_count() < 5:
            if time.perf_counter() > deadline:
                raise AssertionError("subscriptions never landed")
            await asyncio.sleep(0.02)

        hexes = {name: peer.uuid.hex for name, peer in targets.items()}
        replies: dict[str, dict] = {}
        # first reply pays the kind expansion's cold first batch
        replies["narrow"] = await _query_roundtrip(
            sniper, world, apex, "query.cone",
            {"dir": [1, 0, 0], "half_angle_deg": 30, "range": 48},
            timeout=90.0,
        )
        replies["wide"] = await _query_roundtrip(
            sniper, world, apex, "query.cone",
            {"dir": [1, 0, 0], "half_angle_deg": 95, "range": 48},
        )
        replies["first_hit"] = await _query_roundtrip(
            sniper, world, apex, "query.raycast",
            {"dir": [1, 0, 0], "max_t": 48},
        )
        replies["all_hits"] = await _query_roundtrip(
            sniper, world, apex, "query.raycast",
            {"dir": [1, 0, 0], "max_t": 48, "mode": "all_hits"},
        )
        replies["empty_ray"] = await _query_roundtrip(
            sniper, world, apex, "query.raycast",
            {"dir": [0, 0, 1], "max_t": 48},
        )

        # hostile payload: not even JSON — dropped at the router with a
        # counter, never a tick or the session
        malformed0 = ctx.counters().get("queries.malformed", 0)
        await sniper.send(Message(
            instruction=Instruction.LOCAL_MESSAGE, world_name=world,
            position=apex, parameter="query.cone", flex=b"{broken",
        ))
        deadline = time.perf_counter() + 5.0
        while ctx.counters().get("queries.malformed", 0) <= malformed0:
            if time.perf_counter() > deadline:
                break
            await asyncio.sleep(0.02)

        drained = await ctx.drain_ticker()
        counters = ctx.counters()
        all_hit_t = dict(zip(
            replies["all_hits"]["peers"], replies["all_hits"]["ts"]
        ))
        sniper_leaked = any(
            sniper.uuid.hex in r.get("peers", ()) for r in replies.values()
        )
        return {
            "hexes": hexes,
            "narrow_peers": sorted(replies["narrow"]["peers"]),
            "wide_peers": sorted(replies["wide"]["peers"]),
            "first_hit_peers": replies["first_hit"]["peers"],
            "first_hit_t": replies["first_hit"]["t"],
            "all_hits_t_by_peer": all_hit_t,
            "empty_ray_peers": replies["empty_ray"]["peers"],
            "empty_ray_t": replies["empty_ray"]["t"],
            "sniper_in_own_results": sniper_leaked,
            "malformed_dropped":
                counters.get("queries.malformed", 0) - malformed0,
            "kind_replies": counters.get("queries.kind_replies", 0),
            "drained": drained,
            "broker_answers": await ctx.heartbeat_ok(sniper),
        }

    def checks(self, ctx: ScenarioContext, slo: dict) -> list[Check]:
        hexes = slo["hexes"]
        lane = sorted([hexes["near"], hexes["far"]])
        wide = sorted([hexes["near"], hexes["far"], hexes["flank"]])
        t_near = slo["all_hits_t_by_peer"].get(hexes["near"])
        t_far = slo["all_hits_t_by_peer"].get(hexes["far"])
        ladder_ok = (
            set(slo["all_hits_t_by_peer"]) == {hexes["near"], hexes["far"]}
            and t_near is not None and t_far is not None
            and 0.0 < t_near < t_far <= 48.0
        )
        return [
            Check("narrow_cone_sees_exactly_the_lane",
                  slo["narrow_peers"] == lane,
                  slo["narrow_peers"], lane),
            Check("wide_cone_admits_flanker_never_behind",
                  slo["wide_peers"] == wide,
                  slo["wide_peers"], wide,
                  "95° half-angle: flanker in, the peer behind out"),
            Check("first_hit_is_the_nearest_cube",
                  slo["first_hit_peers"] == [hexes["near"]]
                  and slo["first_hit_t"] is not None,
                  slo["first_hit_peers"], [hexes["near"]]),
            Check("all_hits_ladder_ordered", ladder_ok,
                  slo["all_hits_t_by_peer"],
                  "near strictly before far, both within max_t"),
            Check("empty_ray_still_answered",
                  slo["empty_ray_peers"] == []
                  and slo["empty_ray_t"] is None,
                  slo["empty_ray_peers"], [],
                  "the sender is owed a reply frame either way"),
            Check("sender_never_in_own_results",
                  not slo["sniper_in_own_results"],
                  slo["sniper_in_own_results"], False),
            Check("malformed_payload_dropped_with_counter",
                  slo["malformed_dropped"] >= 1,
                  slo["malformed_dropped"], ">= 1"),
            Check("kind_replies_accounted",
                  slo["kind_replies"] >= 5,
                  slo["kind_replies"], ">= 5"),
            Check("broker_answers_after_malformed_probe",
                  slo["broker_answers"], slo["broker_answers"], True),
        ]


class ProjectileStorm(Scenario):
    """A sustained mixed kind-query storm: a firing line
    with a 3-peer hotspot cube drives ``query.knn`` +
    ``query.raycast`` + ``query.density`` rounds concurrently through
    the batched tick path, request-response paced so every reply is
    accounted. The last round's replies are checked EXACTLY — the kNN
    neighbor ladder (nearest cube first, then the hotspot pair in uuid
    order), the raycast peer→t hit map, the density survey with the
    hotspot count on top — and the density results must have fed the
    live region heatmap the /metrics gauge and /debug/heatmap read."""

    name = "projectile_storm"
    description = "mixed knn/raycast/density storm feeding the heatmap"

    def build_config(self, shape: str) -> Config:
        return Config(
            store_url="memory://",
            http_enabled=False, ws_enabled=False,
            zmq_server_host="127.0.0.1", zmq_server_port=free_port(),
            spatial_backend="cuda", tick_interval=0.02,
            precompile_tiers=False,
            sub_region_size=16,
        )

    async def drive(self, ctx: ScenarioContext) -> dict:
        world = "warzone"
        rounds = 8 if ctx.smoke else 30
        size = ctx.config.sub_region_size
        # three shooters share ONE cube (the hotspot the density query
        # must rank first); two more hold the lane cubes along +x
        spots = [
            Vector3(4.0, 8.0, 8.0), Vector3(8.0, 8.0, 8.0),
            Vector3(12.0, 8.0, 8.0),                       # hotspot cube
            Vector3(24.0, 8.0, 8.0), Vector3(40.0, 8.0, 8.0),
        ]
        shooters = [await ctx.connect() for _ in spots]
        observer = await ctx.connect()
        obs_spot = Vector3(8.0, 40.0, 8.0)
        for peer, spot in zip(shooters, spots):
            await peer.send(Message(
                instruction=Instruction.AREA_SUBSCRIBE,
                world_name=world, position=spot,
            ))
        await observer.send(Message(
            instruction=Instruction.AREA_SUBSCRIBE,
            world_name=world, position=obs_spot,
        ))
        deadline = time.perf_counter() + 10.0
        while ctx.server.backend.subscription_count() < len(spots) + 1:
            if time.perf_counter() > deadline:
                raise AssertionError("subscriptions never landed")
            await asyncio.sleep(0.02)

        requests0 = ctx.counters().get("queries.kind_requests", 0)
        replies0 = ctx.counters().get("queries.kind_replies", 0)
        heatmap = ctx.server.heatmap
        updates0 = heatmap.updates if heatmap is not None else 0
        survey_apex = Vector3(8.0, 8.0, 8.0)
        last: dict[str, dict] = {}
        for i in range(rounds):
            # first round pays the kind expansion's cold first batch
            timeout = 90.0 if i == 0 else 15.0
            knn, ray, density = await asyncio.gather(
                _query_roundtrip(
                    shooters[4], world, spots[4], "query.knn",
                    {"k": 3, "max_range": 48}, timeout,
                ),
                _query_roundtrip(
                    shooters[0], world, spots[0], "query.raycast",
                    {"dir": [1, 0, 0], "max_t": 64, "mode": "all_hits"},
                    timeout,
                ),
                _query_roundtrip(
                    observer, world, survey_apex, "query.density",
                    {"extent": 2, "top_n": 8}, timeout,
                ),
            )
            last = {"knn": knn, "ray": ray, "density": density}

        drained = await ctx.drain_ticker()
        counters = ctx.counters()
        hot = [s.uuid for s in shooters[:3]]
        from ..queries.results import _uuid_key

        hot_sorted = [u.hex for u in sorted(hot, key=_uuid_key)]
        ray_t = dict(zip(last["ray"]["peers"], last["ray"]["ts"]))
        expected_survey = sorted(
            [
                [*_cube_of(8.0, 8.0, 8.0, size), 3],     # the hotspot
                [*_cube_of(24.0, 8.0, 8.0, size), 1],
                [*_cube_of(40.0, 8.0, 8.0, size), 1],
                [*_cube_of(8.0, 40.0, 8.0, size), 1],    # the observer
            ],
            key=lambda r: (-r[3], r[0], r[1], r[2]),
        )
        return {
            "rounds": rounds,
            "knn_k": last["knn"]["k"],
            "knn_peers": last["knn"]["peers"],
            "knn_expected": [shooters[3].uuid.hex, *hot_sorted[:2]],
            "ray_t_by_peer": ray_t,
            # the shooter's own hotspot cube answers at t=0 (minus the
            # sender), the lane cubes at the first in-cube sample
            "ray_expected": {
                **{h: 0.0 for h in hot_sorted
                   if h != shooters[0].uuid.hex},
                shooters[3].uuid.hex: 16.0,
                shooters[4].uuid.hex: 32.0,
            },
            "density_cubes": last["density"]["cubes"],
            "density_expected": expected_survey,
            "heatmap_top": heatmap.top() if heatmap is not None else [],
            "heatmap_updates":
                (heatmap.updates - updates0) if heatmap is not None else 0,
            "kind_requests":
                counters.get("queries.kind_requests", 0) - requests0,
            "kind_replies":
                counters.get("queries.kind_replies", 0) - replies0,
            "drained": drained,
            "broker_answers": await ctx.heartbeat_ok(observer),
        }

    def checks(self, ctx: ScenarioContext, slo: dict) -> list[Check]:
        n = slo["rounds"] * 3
        top = slo["heatmap_top"]
        hot_cube = slo["density_expected"][0]
        heatmap_hot = (
            bool(top)
            and top[0][0] == "warzone"
            and top[0][1:4] == hot_cube[:3]
            and top[0][4] == 3
        )
        return [
            Check("knn_ladder_exact",
                  slo["knn_k"] == 3
                  and slo["knn_peers"] == slo["knn_expected"],
                  slo["knn_peers"], slo["knn_expected"],
                  "nearest lane cube first, then the hotspot pair in "
                  "uuid order"),
            Check("raycast_hit_map_exact",
                  slo["ray_t_by_peer"] == slo["ray_expected"],
                  slo["ray_t_by_peer"], slo["ray_expected"]),
            Check("density_survey_exact",
                  slo["density_cubes"] == slo["density_expected"],
                  slo["density_cubes"], slo["density_expected"],
                  "hotspot count 3 ranked first, full extent surveyed"),
            Check("heatmap_tracked_the_hotspot", heatmap_hot,
                  top[:1], f"['warzone', *{hot_cube[:3]}, 3]"),
            Check("heatmap_updates_advanced",
                  slo["heatmap_updates"] >= slo["rounds"],
                  slo["heatmap_updates"], f">= {slo['rounds']}"),
            Check("every_query_answered",
                  slo["kind_requests"] >= n and slo["kind_replies"] >= n,
                  (slo["kind_requests"], slo["kind_replies"]),
                  f">= {n} each",
                  "request-response paced: replies never lag requests"),
            Check("queue_drained", slo["drained"], slo["drained"], True),
            Check("broker_answers_after_storm", slo["broker_answers"],
                  slo["broker_answers"], True),
        ]


class ReconnectStormReplay(Scenario):
    """Reconnect storm landing mid-WAL-replay (the session plane's
    open case): the broker boots with a FAT WAL — acked records from a
    previous life that crashed before its checkpoint — while the
    ``recovery.apply`` failpoint stretches replay, and a connect storm
    hammers the wire from the FIRST instant of boot (``concurrent_boot``:
    the server starts as a task; connects fail-and-retry until the
    transports open, exactly a client fleet reconnecting into a
    recovering broker). Survival means: recovery applies every acked
    entry (ZERO acked-record loss, read back from the store), the
    storm's handshakes land with bounded p99 once serving opens, and
    the broker answers afterwards. Slow-marked: in the catalog for
    operators and the nightly suite, NOT in the CI-blocking smoke set.
    """

    name = "reconnect_storm_replay"
    description = "connect storm during boot-time WAL replay"
    ci_smoke = False
    concurrent_boot = True

    def build_config(self, shape: str) -> Config:
        import tempfile

        from ..durability.wal import MAGIC, encode_insert, frame_entry

        self._wal_dir = tempfile.mkdtemp(prefix="wql-replay-wal-")
        self._n_records = 300 if shape == "smoke" else 3000
        # fabricate the fat WAL directly in the segment format: these
        # entries were ACKED in the previous life — recovery owes the
        # store every one of them
        frames = [MAGIC]
        for i in range(self._n_records):
            frames.append(frame_entry(encode_insert([Record(
                uuid=uuid_mod.UUID(int=i + 1),
                position=Vector3(1.0, 2.0, 3.0),
                world_name="arena",
                data=f"acked-{i}",
            )])))
        import os

        with open(os.path.join(self._wal_dir, "wal-00000000.log"),
                  "wb") as f:
            f.write(b"".join(frames))
        return _storm_config(
            durability="wal",
            wal_dir=self._wal_dir,
            session_ttl=30.0,
            # one failpoint delay per replayed batch: recovery takes
            # ~n_records * delay — long enough that the whole storm
            # provably lands inside it (asserted via the fired count)
            failpoints="recovery.apply=delay:5ms",
            overload_tick_budget_ms=50.0,
        )

    async def drive(self, ctx: ScenarioContext) -> dict:
        n = 8 if ctx.smoke else 32
        handshake_walls: list[float] = []
        refused = 0
        attempts_during_replay = 0
        # serving opens when recovery returns (the transports start
        # right after it): a handshake's wall runs from then, or from
        # the client's first attempt if that is later, so the p99
        # bounds the handshake path and not the replay's length, which
        # the failpoint sets (n_records x 5 ms: 15 s at full shape)
        opened: list[float] = []

        async def watch_recovery() -> None:
            while ctx.server.last_recovery is None:
                await asyncio.sleep(0.001)
            opened.append(time.perf_counter())

        async def storm_one() -> None:
            nonlocal refused, attempts_during_replay
            t0 = time.perf_counter()
            deadline = t0 + 30.0
            while True:
                if not ctx.start_task.done():
                    attempts_during_replay += 1
                try:
                    peer = await ZmqPeer.connect(
                        ctx.config.zmq_server_port, timeout=0.5,
                    )
                    if peer.refused:
                        refused += 1
                        peer.close()
                    else:
                        ctx.clients.append(peer)
                        now = time.perf_counter()
                        handshake_walls.append(
                            (now - max(t0, opened[0] if opened else now))
                            * 1e3
                        )
                        return
                except Exception:
                    pass  # transports not up yet (mid-replay) — retry
                if time.perf_counter() > deadline:
                    raise AssertionError("storm client never connected")
                await asyncio.sleep(0.01)

        # the storm starts NOW — the server is still replaying its WAL
        t_storm = time.perf_counter()
        watcher = asyncio.ensure_future(watch_recovery())
        storm = [asyncio.ensure_future(storm_one()) for _ in range(n)]
        try:
            await asyncio.gather(*storm)
        finally:
            for task in (*storm, watcher):
                task.cancel()
        await ctx.start_task  # boot must have completed under fire
        replay_fires = failpoints.registry.fired("recovery.apply")

        # zero acked-record loss: every fabricated WAL entry reads
        # back from the store after recovery
        stored = await ctx.server.store.get_records_in_region(
            "arena", Vector3(1.0, 2.0, 3.0)
        )
        recovered = len({sr.record.uuid for sr in stored})

        probe = ctx.clients[-1]
        alive = await ctx.heartbeat_ok(probe)
        recovery = ctx.server.last_recovery
        return {
            "wal_records": self._n_records,
            "records_recovered": recovered,
            "replay_batches_fired": replay_fires,
            "storm_clients": n,
            "attempts_during_replay": attempts_during_replay,
            "refused": refused,
            "handshake_p99_ms": round(
                pctl(handshake_walls, 0.99) or 0.0, 1
            ),
            "serving_opened_after_ms": (
                round((opened[0] - t_storm) * 1e3, 1) if opened else None
            ),
            "recovery_errors": len(recovery.errors) if recovery else -1,
            "broker_answers": alive,
        }

    def checks(self, ctx: ScenarioContext, slo: dict) -> list[Check]:
        # bounded, not fast: one CI core time-shares the replay, the
        # storm AND the broker — the bound catches a wedged handshake
        # path, not scheduler contention
        p99_limit = 20000.0 if ctx.smoke else 5000.0
        return [
            Check("zero_acked_record_loss",
                  slo["records_recovered"] == slo["wal_records"],
                  slo["records_recovered"], slo["wal_records"],
                  "every WAL-acked record readable after recovery"),
            Check("storm_landed_mid_replay",
                  slo["attempts_during_replay"] > 0,
                  slo["attempts_during_replay"], "> 0",
                  "connect attempts provably hit the recovering boot"),
            Check("replay_ran", slo["replay_batches_fired"] > 0,
                  slo["replay_batches_fired"], "> 0"),
            Check("all_storm_clients_connected",
                  len(ctx.clients) >= slo["storm_clients"],
                  len(ctx.clients), f">= {slo['storm_clients']}"),
            Check("resume_p99_bounded",
                  slo["handshake_p99_ms"] <= p99_limit,
                  slo["handshake_p99_ms"], f"<= {p99_limit} ms"),
            Check("recovery_clean", slo["recovery_errors"] == 0,
                  slo["recovery_errors"], 0),
            Check("broker_answers_after_replay_storm",
                  slo["broker_answers"], slo["broker_answers"], True),
        ]


class ClusterFlashCrowd(Scenario):
    """Cluster hotspot: a flash crowd drowns ONE shard's world behind
    the router tier.
    Survival means the overload stays CONTAINED — the hot shard
    escalates and its refusals move to the ROUTER (shed before the
    shard ever sees the bytes), the cold shard keeps serving at OK the
    whole time, every record offered during the storm lands (records
    are never shed at either tier), cross-shard delivery keeps a
    bounded p99 under the storm, and the hot shard walks back to OK
    once the crowd disperses."""

    name = "cluster_flash_crowd"
    description = "hotspot world drowns one shard; router sheds for it"
    #: spawns shard subprocesses — runs in the dedicated "Cluster
    #: smoke" CI step (and by explicit name), not the default set
    ci_smoke = False

    def build_config(self, shape: str) -> Config:
        return Config(
            store_url="memory://",
            http_enabled=False, ws_enabled=False,
            zmq_server_host="127.0.0.1",
            zmq_server_port=free_port_block(3),
            spatial_backend="cpu", tick_interval=0.02,
            max_batch=32, overload="on",
            overload_recover_ticks=5,
            supervisor_backoff=0.005,
            cluster_shards=2,
        )

    async def drive(self, ctx: ScenarioContext) -> dict:
        import uuid as uuid_mod

        runtime = ctx.server
        world_map = runtime.router.world_map
        n_flood = 6 if ctx.smoke else 16
        storm_s = 1.5 if ctx.smoke else 6.0
        n_records = 12 if ctx.smoke else 60

        def world_for(shard: int, stem: str) -> str:
            for i in range(10_000):
                name = f"{stem}{i}"
                if world_map.shard_of_world(name) == shard:
                    return name
            raise AssertionError("no world for shard")

        def uuid_for(shard: int) -> uuid_mod.UUID:
            while True:
                u = uuid_mod.uuid4()
                if world_map.shard_of_peer(u) == shard:
                    return u

        hot = world_for(0, "hotspot")      # owned by shard 0
        cold = world_for(1, "steady")      # owned by shard 1
        hot_pos = Vector3(5.0, 5.0, 5.0)
        cold_pos = Vector3(900.0, 5.0, 5.0)

        flooders = [await ctx.connect() for _ in range(n_flood)]
        # the cold pair: receiver homed on shard 0, so every cold-world
        # frame (resolved on shard 1, the owner) crosses the 1→0 ring
        rx = await ctx.connect(peer_uuid=uuid_for(0))
        tx = await ctx.connect(peer_uuid=uuid_for(1))
        for c in flooders:
            await c.send(Message(
                instruction=Instruction.AREA_SUBSCRIBE,
                world_name=hot, position=hot_pos,
            ))
        for c in (rx, tx):
            await c.send(Message(
                instruction=Instruction.AREA_SUBSCRIBE,
                world_name=cold, position=cold_pos,
            ))
        await asyncio.sleep(0.3)

        counters = runtime.metrics.snapshot()["counters"]
        shed_before = counters.get("cluster.router_shed_local", 0)
        levels = {"hot": 0, "cold": 0}
        xshard_ms: list[float] = []
        stop = asyncio.Event()

        async def flood(client: ZmqPeer) -> int:
            # paced: far beyond the hot shard's 2×max_batch admission
            # cap (REJECT holds for the whole storm) without starving
            # the 1-core router's event loop of the cold traffic this
            # scenario measures against it
            sent = 0
            while not stop.is_set():
                for _ in range(16):
                    await client.send(Message(
                        instruction=Instruction.LOCAL_MESSAGE,
                        world_name=hot, position=hot_pos,
                        parameter="crowd",
                    ))
                    sent += 1
                await asyncio.sleep(0.002)
            return sent

        async def cold_traffic() -> int:
            sent = 0
            while not stop.is_set():
                await tx.send(Message(
                    instruction=Instruction.LOCAL_MESSAGE,
                    world_name=cold, position=cold_pos,
                    parameter=f"x:{time.monotonic_ns()}",
                ))
                sent += 1
                await asyncio.sleep(0.05)
            return sent

        async def cold_receiver() -> None:
            while True:
                got = await rx.recv(30)
                if (
                    got.instruction == Instruction.LOCAL_MESSAGE
                    and got.parameter
                    and got.parameter.startswith("x:")
                ):
                    t_sent = int(got.parameter.split(":", 1)[1])
                    xshard_ms.append(
                        (time.monotonic_ns() - t_sent) / 1e6
                    )

        async def sampler() -> None:
            while not stop.is_set():
                levels["hot"] = max(
                    levels["hot"], runtime.router.mirror.level(0)
                )
                levels["cold"] = max(
                    levels["cold"], runtime.router.mirror.level(1)
                )
                await asyncio.sleep(0.02)

        async def record_stream() -> list:
            created = []
            for i in range(n_records):
                world, pos = ((hot, hot_pos) if i % 2 == 0
                              else (cold, cold_pos))
                rec = uuid_mod.uuid4()
                await tx.send(Message(
                    instruction=Instruction.RECORD_CREATE,
                    world_name=world,
                    records=[Record(uuid=rec, position=pos,
                                    world_name=world, data=f"r{i}")],
                ))
                created.append((world, rec))
                await asyncio.sleep(storm_s / n_records)
            return created

        receiver = asyncio.ensure_future(cold_receiver())
        try:
            async def stopper():
                await asyncio.sleep(storm_s)
                stop.set()

            results = await asyncio.gather(
                *(flood(c) for c in flooders), cold_traffic(),
                record_stream(), sampler(), stopper(),
            )
            offered = sum(results[:n_flood])
            cold_sent = results[n_flood]
            created = results[n_flood + 1]
            # let in-flight cold frames land before closing the books
            await asyncio.sleep(1.0)
        finally:
            receiver.cancel()
            try:
                await receiver
            except (asyncio.CancelledError, Exception):
                pass

        # recovery: the hot shard must walk back to OK and re-report
        recovered = False
        deadline = time.perf_counter() + (15 if ctx.smoke else 30)
        while time.perf_counter() < deadline:
            if runtime.router.mirror.level(0) == 0:
                recovered = True
                break
            await asyncio.sleep(0.1)

        # zero record loss: every record offered during the storm is
        # readable back through the router (records are never shed)
        async def readable(world, pos, want: set) -> int:
            deadline = time.perf_counter() + 20
            seen: set = set()
            while time.perf_counter() < deadline and not want <= seen:
                await rx.send(Message(
                    instruction=Instruction.RECORD_READ,
                    world_name=world, position=pos,
                ))
                try:
                    reply = await rx.recv_until(
                        Instruction.RECORD_REPLY, 5
                    )
                except asyncio.TimeoutError:
                    continue
                seen |= {r.uuid for r in reply.records}
            return len(want & seen)

        hot_want = {r for w, r in created if w == hot}
        cold_want = {r for w, r in created if w == cold}
        hot_found = await readable(hot, hot_pos, hot_want)
        cold_found = await readable(cold, cold_pos, cold_want)

        counters = runtime.metrics.snapshot()["counters"]
        return {
            "offered": offered,
            "cold_sent": cold_sent,
            "cold_received": len(xshard_ms),
            "router_shed_local":
                counters.get("cluster.router_shed_local", 0) - shed_before,
            "router_forwarded":
                counters.get("cluster.router_forwarded", 0),
            "hot_peak_level": levels["hot"],
            "cold_peak_level": levels["cold"],
            "records_offered": len(created),
            "records_found": hot_found + cold_found,
            "xshard_p99_ms": round(pctl(xshard_ms, 0.99) or 0.0, 2),
            "hot_recovered": recovered,
            "broker_answers": await ctx.heartbeat_ok(tx),
        }

    def checks(self, ctx: ScenarioContext, slo: dict) -> list[Check]:
        p99_limit = 2_000 if ctx.smoke else 500
        return [
            Check("hot_shard_escalated", slo["hot_peak_level"] >= 2,
                  slo["hot_peak_level"], ">= 2 (shed_high)"),
            Check("router_shed_for_hot_shard",
                  slo["router_shed_local"] > 0,
                  slo["router_shed_local"], "> 0",
                  "REJECT moved to the router tier"),
            Check("cold_shard_stayed_ok", slo["cold_peak_level"] == 0,
                  slo["cold_peak_level"], 0),
            Check("zero_record_loss",
                  slo["records_found"] == slo["records_offered"],
                  slo["records_found"], slo["records_offered"],
                  "records are never shed at either tier"),
            Check("xshard_delivery_flowed", slo["cold_received"] > 0,
                  slo["cold_received"], "> 0"),
            Check("xshard_p99_bounded",
                  slo["xshard_p99_ms"] <= p99_limit,
                  slo["xshard_p99_ms"], f"<= {p99_limit} ms"),
            Check("hot_shard_recovered_to_ok", slo["hot_recovered"],
                  slo["hot_recovered"], True),
            Check("broker_answers_after_storm", slo["broker_answers"],
                  slo["broker_answers"], True),
        ]


class BandwidthCap(Scenario):
    """Per-peer bandwidth budgets under asymmetric demand:
    a victim peer whose interest set is a dense mover swarm outruns
    the per-peer byte budget while two bystanders in quiet pockets
    stay far under it. Survival means the budget degrades the victim's
    CADENCE, never its state: the victim racks up lossless deferrals
    and walks the demote ladder, its replay oracle never refuses a
    delta or sees a gap, and after the swarm quiesces it converges to
    the server's own ledger; the bystanders never defer, never demote,
    and stream at full rate throughout. The accounting is exact — the
    bytes actually put on the victim's wire respect the token-bucket
    bound (burst + rate x elapsed), and ``delivery.bytes_shed`` may
    count only once some peer has bottomed out at keyframe-only."""

    name = "bandwidth_cap"
    description = "over-budget peer degrades cadence, never state"

    def build_config(self, shape: str) -> Config:
        return Config(
            store_url="memory://",
            http_enabled=False, ws_enabled=False,
            zmq_server_host="127.0.0.1", zmq_server_port=free_port(),
            spatial_backend="cuda", tick_interval=0.02,
            entity_sim=True, entity_k=12, interest="on",
            peer_bandwidth_bytes=16384,
            precompile_tiers=False,
            supervisor_backoff=0.005,
        )

    async def drive(self, ctx: ScenarioContext) -> dict:
        import struct

        from ..interest import ReplayClient, parse_stamp
        from ..protocol import deserialize_message

        world = "cap"
        n_movers = 48 if ctx.smoke else 96
        n_victim = 8 if ctx.smoke else 12
        load_s = 3.5 if ctx.smoke else 10.0
        rng = np.random.default_rng(18)

        hub = await ctx.connect()
        victim = await ctx.connect()
        bystanders = [await ctx.connect() for _ in range(2)]

        # the swarm: a co-located mover cluster, velocity-integrated
        # by the device tick — sustained per-tick deltas far beyond
        # the per-peer budget for anyone whose interest set is ALL of
        # it (the hub owns the swarm, so it is over budget too; the
        # victim's checks below are keyed per peer, not globally)
        movers = [uuid_mod.uuid4() for _ in range(n_movers)]
        await hub.send(Message(
            instruction=Instruction.LOCAL_MESSAGE, world_name=world,
            entities=[Entity(
                uuid=m, position=Vector3(*rng.uniform(6.0, 10.0, 3)),
                world_name=world,
                flex=struct.pack("<3f", 2.0, 0.0, 0.0),
            ) for m in movers],
        ))
        # the victim parks its own entities INSIDE the swarm: its kNN
        # interest set is the whole mover cluster
        await victim.send(Message(
            instruction=Instruction.LOCAL_MESSAGE, world_name=world,
            entities=[Entity(
                uuid=uuid_mod.uuid4(),
                position=Vector3(*rng.uniform(6.0, 10.0, 3)),
                world_name=world,
            ) for _ in range(n_victim)],
        ))
        # each bystander lives in a distant pocket of statics plus ONE
        # slow drifter: a small per-tick delta stream that stays well
        # inside the budget for the whole scenario
        drifters: list[tuple[uuid_mod.UUID, float]] = []
        for i, b in enumerate(bystanders):
            base = 300.0 * (i + 1)
            await b.send(Message(
                instruction=Instruction.LOCAL_MESSAGE, world_name=world,
                entities=[Entity(
                    uuid=uuid_mod.uuid4(),
                    position=Vector3(base, 6.0, 6.0),
                    world_name=world,
                )],
            ))
            drifter = uuid_mod.uuid4()
            drifters.append((drifter, base))
            await hub.send(Message(
                instruction=Instruction.LOCAL_MESSAGE, world_name=world,
                entities=[Entity(
                    uuid=drifter if j == 0 else uuid_mod.uuid4(),
                    position=Vector3(
                        base + float(j % 4), 6.0 + float(j // 4), 6.0
                    ),
                    world_name=world,
                    flex=(struct.pack("<3f", 0.3, 0.0, 0.0)
                          if j == 0 else None),
                ) for j in range(13)],
            ))

        oracle_v = ReplayClient()
        oracles_b = [ReplayClient() for _ in bystanders]
        victim_bytes = [0]
        stop = asyncio.Event()

        async def pump(peer, oracle, byte_sink=None):
            # raw socket reads: the byte count must be the exact wire
            # length the budget was charged for, not a re-serialize
            while not stop.is_set():
                try:
                    data = await asyncio.wait_for(peer.pull.recv(), 0.25)
                except asyncio.TimeoutError:
                    continue
                m = deserialize_message(data)
                if (m.instruction == Instruction.LOCAL_MESSAGE
                        and m.parameter
                        and parse_stamp(m.parameter) is not None):
                    if byte_sink is not None:
                        byte_sink[0] += len(data)
                    oracle.apply(m)

        pumps = [asyncio.ensure_future(pump(victim, oracle_v, victim_bytes))]
        for b, o in zip(bystanders, oracles_b):
            pumps.append(asyncio.ensure_future(pump(b, o)))

        mgr = ctx.server.interest
        plane = ctx.server.entity_plane
        try:
            # first keyframes mark the stream (and the buckets) live
            t_start = time.perf_counter()
            deadline = t_start + 90.0
            while (oracle_v.frames_applied < 1
                   or any(o.frames_applied < 1 for o in oracles_b)):
                if time.perf_counter() > deadline:
                    raise AssertionError("first interest frames never landed")
                await asyncio.sleep(0.05)

            # the loaded window, sampling the demote ladder as it moves
            ticks0 = plane.applied_ticks
            max_demote = {"victim": 0, "bystander": 0, "any": 0}

            def sample():
                st_v = mgr._peers.get(victim.uuid)
                if st_v is not None:
                    max_demote["victim"] = max(
                        max_demote["victim"], st_v.demote
                    )
                for b in bystanders:
                    st_b = mgr._peers.get(b.uuid)
                    if st_b is not None:
                        max_demote["bystander"] = max(
                            max_demote["bystander"], st_b.demote
                        )
                for st in mgr._peers.values():
                    max_demote["any"] = max(max_demote["any"], st.demote)

            end = time.perf_counter() + load_s
            while time.perf_counter() < end:
                sample()
                await asyncio.sleep(0.02)
            ticks_loaded = plane.applied_ticks - ticks0
            st_v = mgr._peers.get(victim.uuid)
            victim_deferrals = st_v.deferrals if st_v is not None else 0
            bystander_deferrals = sum(
                mgr._peers[b.uuid].deferrals
                for b in bystanders if b.uuid in mgr._peers
            )

            # quiesce the swarm and the drifters; the victim's pending
            # (deferred) diff must still land — losslessly, on cadence
            await hub.send(Message(
                instruction=Instruction.LOCAL_MESSAGE, world_name=world,
                entities=[Entity(
                    uuid=m, position=Vector3(*rng.uniform(6.0, 10.0, 3)),
                    world_name=world,
                    flex=struct.pack("<3f", 0.0, 0.0, 0.0),
                ) for m in movers] + [Entity(
                    uuid=d, position=Vector3(base, 7.0, 6.0),
                    world_name=world,
                    flex=struct.pack("<3f", 0.0, 0.0, 0.0),
                ) for d, base in drifters],
            ))

            def ledger_of(peer):
                st = mgr._peers.get(peer.uuid)
                if st is None:
                    return None
                out = {}
                for key, (_wid, pos_b) in st.state.items():
                    x, y, z = np.frombuffer(pos_b, np.float32)
                    out[uuid_mod.UUID(bytes=key)] = (
                        float(x), float(y), float(z)
                    )
                return out

            def converged(oracle, peer) -> bool:
                ledger = ledger_of(peer)
                return (ledger is not None
                        and oracle.snapshot().get(world, {}) == ledger)

            deadline = time.perf_counter() + (25.0 if ctx.smoke else 40.0)
            while not (converged(oracle_v, victim) and all(
                converged(o, b) for o, b in zip(oracles_b, bystanders)
            )):
                if time.perf_counter() > deadline:
                    break
                await asyncio.sleep(0.1)
            sample()
            victim_converged = converged(oracle_v, victim)
            bystanders_converged = all(
                converged(o, b) for o, b in zip(oracles_b, bystanders)
            )
            elapsed = time.perf_counter() - t_start
        finally:
            stop.set()
            await asyncio.gather(*pumps, return_exceptions=True)

        drained = await ctx.drain_ticker()
        sv = oracle_v.stats()
        sb = [o.stats() for o in oracles_b]
        # token-bucket conservation: what actually hit the victim's
        # wire can never exceed burst + rate x elapsed (one frame of
        # slack for the read race at the window edge)
        budget_cap = round(
            mgr.bandwidth_burst + mgr.bandwidth_bytes * elapsed + 4096.0
        )
        return {
            "movers": n_movers,
            "ticks_loaded": ticks_loaded,
            "victim_deferrals": victim_deferrals,
            "victim_max_demote": max_demote["victim"],
            "victim_refused": sv["deltas_refused"],
            "victim_gaps": sv["gaps_seen"],
            "victim_deltas": sv["deltas_applied"],
            "victim_fulls": sv["fulls_applied"],
            "victim_converged": victim_converged,
            "victim_bytes": victim_bytes[0],
            "victim_budget_cap": budget_cap,
            "bystander_deferrals": bystander_deferrals,
            "bystander_max_demote": max_demote["bystander"],
            "bystander_refused": sum(s["deltas_refused"] for s in sb),
            "bystander_gaps": sum(s["gaps_seen"] for s in sb),
            "bystander_deltas": sum(s["deltas_applied"] for s in sb),
            "bystanders_converged": bystanders_converged,
            "any_max_demote": max_demote["any"],
            "bytes_shed": mgr.bytes_shed,
            "drained": drained,
            "broker_answers": await ctx.heartbeat_ok(victim),
        }

    def checks(self, ctx: ScenarioContext, slo: dict) -> list[Check]:
        return [
            Check("victim_cadence_degraded",
                  slo["victim_deferrals"] > 0,
                  slo["victim_deferrals"], "> 0",
                  "over-budget ticks became lossless deferrals, "
                  "not truncated sends"),
            Check("victim_walked_the_demote_ladder",
                  slo["victim_max_demote"] >= 1,
                  slo["victim_max_demote"], ">= 1 (far-tier demotion)"),
            Check("victim_correctness_intact",
                  slo["victim_refused"] == 0 and slo["victim_gaps"] == 0,
                  (slo["victim_refused"], slo["victim_gaps"]), (0, 0),
                  "throttling never produced an unappliable delta or "
                  "a sequence gap"),
            Check("victim_converged_to_server_ledger",
                  slo["victim_converged"],
                  slo["victim_converged"], True,
                  "after quiesce the oracle equals the server's own "
                  "per-peer ledger"),
            Check("victim_bytes_within_budget",
                  slo["victim_bytes"] <= slo["victim_budget_cap"],
                  slo["victim_bytes"], f"<= {slo['victim_budget_cap']}",
                  "token-bucket conservation on the actual wire bytes"),
            Check("bystanders_never_deferred",
                  slo["bystander_deferrals"] == 0
                  and slo["bystander_max_demote"] == 0,
                  (slo["bystander_deferrals"], slo["bystander_max_demote"]),
                  (0, 0)),
            Check("bystander_stream_full_rate",
                  slo["bystander_deltas"] > 0
                  and slo["bystander_refused"] == 0
                  and slo["bystander_gaps"] == 0,
                  (slo["bystander_deltas"], slo["bystander_refused"],
                   slo["bystander_gaps"]),
                  ("> 0", 0, 0)),
            Check("bystanders_converged_to_server_ledger",
                  slo["bystanders_converged"],
                  slo["bystanders_converged"], True),
            Check("shed_only_at_ladder_bottom",
                  slo["bytes_shed"] == 0 or slo["any_max_demote"] == 2,
                  (slo["bytes_shed"], slo["any_max_demote"]),
                  "shed 0, or some peer at keyframe-only first",
                  "bytes_shed counts ONLY once cadence demotion is "
                  "exhausted"),
            Check("queue_drained", slo["drained"], slo["drained"], True),
            Check("broker_answers_after_throttle",
                  slo["broker_answers"], slo["broker_answers"], True),
        ]


class MegaCity(Scenario):
    """Live resharding under fire: a mega-city world keeps
    one shard hot while district traffic spreads across the cluster,
    and mid-traffic the city is live-resharded to the other shard.
    Survival means the migration is INVISIBLE to the workload: the
    protocol runs to ``done``, the placement epoch advances and the
    city routes to its new owner, every record offered before, during
    and after the move reads back (the freeze window parks frames in
    the bounded transfer buffer and replays them — counted, never
    shed), the pre-move subscription keeps delivering THROUGH the flip
    (subscription rows rode the capsule), and the broker answers
    after."""

    name = "mega_city"
    description = "hot world live-resharded mid-traffic, zero loss"
    #: spawns shard subprocesses — runs in the dedicated "Cluster
    #: smoke" CI step (and by explicit name), not the default set
    ci_smoke = False

    def build_config(self, shape: str) -> Config:
        return Config(
            store_url="memory://",
            http_enabled=False, ws_enabled=False,
            zmq_server_host="127.0.0.1",
            zmq_server_port=free_port_block(3),
            spatial_backend="cpu", tick_interval=0.02,
            max_batch=64, overload="on",
            supervisor_backoff=0.005,
            cluster_shards=2,
        )

    async def drive(self, ctx: ScenarioContext) -> dict:
        runtime = ctx.server
        router = runtime.router
        placement = router.world_map
        n_pre = 10 if ctx.smoke else 40
        n_post = 6 if ctx.smoke else 20
        post_flip_s = 0.8 if ctx.smoke else 2.0

        def world_for(shard: int, stem: str) -> str:
            for i in range(10_000):
                name = f"{stem}{i}"
                if placement.shard_of_world(name) == shard:
                    return name
            raise AssertionError("no world for shard")

        def uuid_for(shard: int) -> uuid_mod.UUID:
            while True:
                u = uuid_mod.uuid4()
                if placement.shard_of_peer(u) == shard:
                    return u

        city = world_for(0, "megacity")        # starts on shard 0
        districts = [world_for(i, "district") for i in (0, 1)]
        pos = Vector3(5.0, 5.0, 5.0)

        # receiver homed on the DESTINATION shard, sender on the
        # source: city delivery crosses the ring before the flip and
        # stays local after — both legs exercised by one subscription
        rx = await ctx.connect(peer_uuid=uuid_for(1))
        tx = await ctx.connect(peer_uuid=uuid_for(0))
        await rx.send(Message(
            instruction=Instruction.AREA_SUBSCRIBE,
            world_name=city, position=pos,
        ))
        await asyncio.sleep(0.3)

        created: list[tuple[str, uuid_mod.UUID]] = []

        async def put(world: str, tag: str) -> None:
            rec = uuid_mod.uuid4()
            await tx.send(Message(
                instruction=Instruction.RECORD_CREATE,
                world_name=world,
                records=[Record(uuid=rec, position=pos,
                                world_name=world, data=tag)],
            ))
            created.append((world, rec))

        for i in range(n_pre):
            await put(city, f"pre{i}")
            await put(districts[i % 2], f"d{i}")
            await asyncio.sleep(0.005)
        await asyncio.sleep(0.2)

        received = {"during": 0, "post": 0}
        phase = {"v": "during"}
        stop = asyncio.Event()

        async def receiver() -> None:
            while True:
                got = await rx.recv(30)
                if (
                    got.instruction == Instruction.LOCAL_MESSAGE
                    and got.parameter
                    and got.parameter.startswith("city:")
                ):
                    received[phase["v"]] += 1

        async def city_traffic() -> int:
            # live locals + mid-flight record creates: the freeze
            # window MUST catch some of these in the transfer buffer
            sent = 0
            while not stop.is_set():
                await tx.send(Message(
                    instruction=Instruction.LOCAL_MESSAGE,
                    world_name=city, position=pos,
                    parameter=f"city:{sent}",
                ))
                sent += 1
                if sent % 4 == 0:
                    await put(city, f"mid{sent}")
                await asyncio.sleep(0.01)
            return sent

        async def reshard():
            await asyncio.sleep(0.4)     # traffic provably flowing
            xfer = router.start_reshard(city, 1, reason="scenario")
            # one city frame in the freeze's own loop step: the window
            # (fence, export, import, flip) closes in ~5 ms on a fast
            # host, under city_traffic's 10 ms cadence, so the freeze
            # could otherwise fall between two frames and park none
            await tx.send(Message(
                instruction=Instruction.LOCAL_MESSAGE,
                world_name=city, position=pos, parameter="city:freeze",
            ))
            deadline = time.perf_counter() + (30 if ctx.smoke else 60)
            while time.perf_counter() < deadline:
                mig = router.migration
                if mig is not None and mig.state in ("done", "aborted"):
                    return (xfer, mig)
                await asyncio.sleep(0.05)
            return (xfer, router.migration)

        receiver_task = asyncio.ensure_future(receiver())
        try:
            traffic = asyncio.ensure_future(city_traffic())
            xfer, mig = await reshard()
            phase["v"] = "post"
            await asyncio.sleep(post_flip_s)   # post-flip delivery leg
            stop.set()
            sent = await traffic
            for i in range(n_post):
                await put(city, f"post{i}")
            await asyncio.sleep(0.3)
        finally:
            # the receiver must be gone BEFORE the read-back phase —
            # it would steal the RECORD_REPLYs off rx's pull socket
            receiver_task.cancel()
            try:
                await receiver_task
            except (asyncio.CancelledError, Exception):
                pass

        # zero record loss: every record offered around the move is
        # readable back through the router (now via the new owner)
        async def readable(world: str, want: set) -> int:
            deadline = time.perf_counter() + 20
            seen: set = set()
            while time.perf_counter() < deadline and not want <= seen:
                await rx.send(Message(
                    instruction=Instruction.RECORD_READ,
                    world_name=world, position=pos,
                ))
                try:
                    reply = await rx.recv_until(
                        Instruction.RECORD_REPLY, 5
                    )
                except asyncio.TimeoutError:
                    continue
                seen |= {r.uuid for r in reply.records}
            return len(want & seen)

        want_by_world: dict[str, set] = {}
        for world, rec in created:
            want_by_world.setdefault(world, set()).add(rec)
        found = 0
        for world, want in want_by_world.items():
            found += await readable(world, want)

        desc = mig.describe() if mig is not None else {}
        return {
            "xfer": xfer,
            "migration_state": desc.get("state", "missing"),
            "placement_epoch": placement.epoch,
            "owner_after": placement.shard_of_world(city),
            "records_offered": len(created),
            "records_found": found,
            "parked_replayed": desc.get("replayed", 0),
            "buffer_shed": (desc.get("buffer") or {}).get("shed", 0),
            "city_sent": sent + 1,       # + the freeze frame
            "delivered_during": received["during"],
            "delivered_post": received["post"],
            "broker_answers": await ctx.heartbeat_ok(tx),
        }

    def checks(self, ctx: ScenarioContext, slo: dict) -> list[Check]:
        return [
            Check("reshard_completed", slo["migration_state"] == "done",
                  slo["migration_state"], "done"),
            Check("placement_epoch_advanced",
                  slo["placement_epoch"] >= 1,
                  slo["placement_epoch"], ">= 1"),
            Check("ownership_flipped", slo["owner_after"] == 1,
                  slo["owner_after"], 1,
                  "the city routes to its NEW owner"),
            Check("zero_record_loss",
                  slo["records_found"] == slo["records_offered"],
                  slo["records_found"], slo["records_offered"],
                  "records offered before, during and after the move "
                  "all read back"),
            Check("freeze_window_parked_and_replayed",
                  slo["parked_replayed"] > 0,
                  slo["parked_replayed"], "> 0",
                  "live traffic provably crossed the freeze window"),
            Check("transfer_buffer_never_shed",
                  slo["buffer_shed"] == 0, slo["buffer_shed"], 0),
            Check("delivery_through_the_flip",
                  slo["delivered_during"] > 0
                  and slo["delivered_post"] > 0,
                  (slo["delivered_during"], slo["delivered_post"]),
                  ("> 0", "> 0"),
                  "the pre-move subscription rode the capsule"),
            Check("broker_answers_after_reshard",
                  slo["broker_answers"], slo["broker_answers"], True),
        ]


class RollingRestart(Scenario):
    """Rolling cluster restart: after a live reshard moved
    a world off its hash-home, SIGKILL every shard in sequence under
    traffic. Survival means the control plane heals itself: the
    supervisor restarts each shard, the placement map (epoch +
    override) replays to every restarted shard so the migrated world
    still routes to its NEW owner, WAL replay recovers every record —
    including the migrated capsule through the destination's OWN WAL
    (the exactly-one-owner invariant) — fresh sessions land and
    subscribe after the roll, and the broker answers."""

    name = "rolling_restart"
    description = "SIGKILL each shard in turn; placement + WAL recover"
    #: spawns shard subprocesses — runs in the dedicated "Cluster
    #: smoke" CI step (and by explicit name), not the default set
    ci_smoke = False

    def build_config(self, shape: str) -> Config:
        import tempfile

        return Config(
            store_url="memory://",
            durability="wal",
            wal_dir=tempfile.mkdtemp(prefix="wql-rolling-"),
            checkpoint_interval=0,  # SIGKILL must find the WAL whole
            http_enabled=False, ws_enabled=False,
            zmq_server_host="127.0.0.1",
            zmq_server_port=free_port_block(3),
            spatial_backend="cpu", tick_interval=0.02,
            max_batch=64,
            supervisor_backoff=0.005,
            cluster_shards=2,
        )

    async def drive(self, ctx: ScenarioContext) -> dict:
        runtime = ctx.server
        router = runtime.router
        placement = router.world_map
        supervisor = runtime.supervisor
        n_records = 8 if ctx.smoke else 30

        def world_for(shard: int, stem: str) -> str:
            for i in range(10_000):
                name = f"{stem}{i}"
                if placement.shard_of_world(name) == shard:
                    return name
            raise AssertionError("no world for shard")

        async def wait_for(predicate, timeout_s: float,
                           what: str) -> bool:
            deadline = time.perf_counter() + timeout_s
            while time.perf_counter() < deadline:
                if predicate():
                    return True
                await asyncio.sleep(0.05)
            return False

        moved = world_for(0, "moved")      # migrates 0 → 1 pre-roll
        steady = world_for(1, "steady")
        pos = Vector3(5.0, 5.0, 5.0)

        tx = await ctx.connect()
        created: dict[str, set] = {moved: set(), steady: set()}
        for i in range(n_records):
            for world in (moved, steady):
                rec = uuid_mod.uuid4()
                await tx.send(Message(
                    instruction=Instruction.RECORD_CREATE,
                    world_name=world,
                    records=[Record(uuid=rec, position=pos,
                                    world_name=world, data=f"r{i}")],
                ))
                created[world].add(rec)
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.3)

        # live reshard FIRST: the roll must not undo the move
        xfer = router.start_reshard(moved, 1, reason="scenario")
        moved_ok = await wait_for(
            lambda: router.migration is not None
            and router.migration.state in ("done", "aborted"),
            30 if ctx.smoke else 60, "reshard",
        )
        migration_state = (
            router.migration.state if router.migration else "missing"
        )
        epoch = placement.epoch

        # the roll: SIGKILL each shard in turn, wait for the
        # supervised restart AND placement re-convergence (the ~1s
        # control-state packets carry the shard's epoch back)
        attempts_during_roll = 0
        roll = {"deaths": 0, "revivals": 0, "converged": 0}
        for idx in range(supervisor.n_shards):
            supervisor.kill_shard(idx)
            if await wait_for(
                lambda: not supervisor.shard_alive(idx), 30, "death"
            ):
                roll["deaths"] += 1
            # traffic provably hits the half-dead cluster (best
            # effort — the point is the cluster survives it)
            for i in range(10):
                try:
                    await tx.send(Message(
                        instruction=Instruction.LOCAL_MESSAGE,
                        world_name=moved if i % 2 else steady,
                        position=pos, parameter="roll",
                    ))
                    attempts_during_roll += 1
                except Exception:
                    pass
            if await wait_for(
                lambda: supervisor.shard_alive(idx), 90, "revival"
            ):
                roll["revivals"] += 1
            if await wait_for(
                lambda: supervisor.shard_state(idx).get(
                    "placement_epoch", -1) >= epoch,
                30, "placement convergence",
            ):
                roll["converged"] += 1

        # post-roll verification rides FRESH sessions (each peer's
        # home shard died at some point in the roll)
        probe = await ctx.connect()
        await probe.send(Message(
            instruction=Instruction.AREA_SUBSCRIBE,
            world_name=moved, position=pos,
        ))
        await asyncio.sleep(0.3)

        post_rec = uuid_mod.uuid4()
        await probe.send(Message(
            instruction=Instruction.RECORD_CREATE, world_name=moved,
            records=[Record(uuid=post_rec, position=pos,
                            world_name=moved, data="post-roll")],
        ))
        created[moved].add(post_rec)

        sender = await ctx.connect()
        await sender.send(Message(
            instruction=Instruction.LOCAL_MESSAGE, world_name=moved,
            position=pos, parameter="after-roll",
        ))
        delivered_after = False
        try:
            while True:
                got = await probe.recv(10)
                if (got.instruction == Instruction.LOCAL_MESSAGE
                        and got.parameter == "after-roll"):
                    delivered_after = True
                    break
        except asyncio.TimeoutError:
            pass

        async def readable(world: str, want: set) -> int:
            deadline = time.perf_counter() + 30
            seen: set = set()
            while time.perf_counter() < deadline and not want <= seen:
                await probe.send(Message(
                    instruction=Instruction.RECORD_READ,
                    world_name=world, position=pos,
                ))
                try:
                    reply = await probe.recv_until(
                        Instruction.RECORD_REPLY, 5
                    )
                except asyncio.TimeoutError:
                    continue
                seen |= {r.uuid for r in reply.records}
            return len(want & seen)

        found = 0
        for world, want in created.items():
            found += await readable(world, want)
        offered = sum(len(want) for want in created.values())

        return {
            "xfer": xfer,
            "reshard_done": moved_ok and migration_state == "done",
            "placement_epoch": epoch,
            "owner_after_roll": placement.shard_of_world(moved),
            "shard_deaths": roll["deaths"],
            "shard_revivals": roll["revivals"],
            "placement_reconverged": roll["converged"],
            "restarts": supervisor.stats()["restarts"],
            "attempts_during_roll": attempts_during_roll,
            "records_offered": offered,
            "records_found": found,
            "delivered_after_roll": delivered_after,
            "broker_answers": await ctx.heartbeat_ok(probe),
        }

    def checks(self, ctx: ScenarioContext, slo: dict) -> list[Check]:
        n = 2
        return [
            Check("reshard_done_before_roll", slo["reshard_done"],
                  slo["reshard_done"], True),
            Check("every_shard_died_and_revived",
                  slo["shard_deaths"] == n
                  and slo["shard_revivals"] == n,
                  (slo["shard_deaths"], slo["shard_revivals"]), (n, n)),
            Check("supervised_restarts_counted",
                  slo["restarts"] >= n, slo["restarts"], f">= {n}"),
            Check("placement_replayed_to_every_restart",
                  slo["placement_reconverged"] == n,
                  slo["placement_reconverged"], n,
                  "each restarted shard re-reported the post-move "
                  "epoch via its control-state packets"),
            Check("migrated_world_stays_moved",
                  slo["owner_after_roll"] == 1,
                  slo["owner_after_roll"], 1,
                  "the roll did not undo the live reshard"),
            Check("traffic_hit_the_roll",
                  slo["attempts_during_roll"] > 0,
                  slo["attempts_during_roll"], "> 0"),
            Check("zero_record_loss_through_roll",
                  slo["records_found"] == slo["records_offered"],
                  slo["records_found"], slo["records_offered"],
                  "WAL replay recovered every record, the migrated "
                  "capsule from the destination's OWN WAL"),
            Check("delivery_after_roll", slo["delivered_after_roll"],
                  slo["delivered_after_roll"], True),
            Check("broker_answers_after_roll", slo["broker_answers"],
                  slo["broker_answers"], True),
        ]
