"""Sessions and the overload governor: the port against the JAX package.

* Transcripts: the same scripted event sequence drives both packages'
  ``SessionStore`` (mint, peek, park, undelivered frames, resume,
  expire, discard) and ``OverloadGovernor`` (a synthetic trace of tick
  walls, queue depths, per-peer message streams and handshakes), each
  on an injected clock. Every step's answer and the stats after it form
  the transcript; the two transcripts must be equal. Session tokens are
  random, so the transcript names each token by the order it was
  minted; the governor's retry-after hint is jittered on purpose
  (unseeded), so the transcript keeps whether a hint was given.
* The port's server (cuda index on the CPU): a WebSocket peer that
  drops and resumes with its minted token keeps its subscription and
  receives fan-out on the new connection; an overload storm of
  LocalMessages escalates the governor, sheds, and the state walks
  back to ``ok`` with the full batch tier once the storm stops.

Tolerance: exact.
"""

from __future__ import annotations

import asyncio
import uuid

import pytest

from tests.client_util import WsClient, free_port
from worldql_server_tpu.protocol.types import Instruction as JInstruction
from worldql_server_tpu.robustness import overload as j_overload
from worldql_server_tpu.robustness import sessions as j_sessions
from worldql_server_tpu_torch.engine.config import Config
from worldql_server_tpu_torch.engine.server import WorldQLServer
from worldql_server_tpu_torch.protocol import Instruction, Message, Vector3
from worldql_server_tpu_torch.protocol.types import Replication
from worldql_server_tpu_torch.robustness import failpoints
from worldql_server_tpu_torch.robustness import overload as t_overload
from worldql_server_tpu_torch.robustness import sessions as t_sessions
from worldql_server_tpu_torch.spatial.backend import LocalQuery

PEERS = [uuid.UUID(int=0xC000 + i) for i in range(4)]


@pytest.fixture(autouse=True)
def clean_failpoints():
    failpoints.registry.reset()
    yield
    failpoints.registry.reset()


def _session_transcript(mod):
    now = [100.0]
    expired = []
    resyncs = []
    store = mod.SessionStore(ttl=5.0, clock=lambda: now[0],
                             on_expire=expired.append,
                             on_undelivered=resyncs.append)
    names: dict[str, int] = {}

    def name(session):
        if session is None:
            return None
        return names.setdefault(session.token, len(names))

    out = []

    def step(what, value):
        out.append((what, value, store.stats(), list(expired),
                    list(resyncs)))

    a, b, c = PEERS[:3]
    sa = store.mint(a, "websocket")
    sb = store.mint(b, "zeromq")
    step("mint", (name(sa), name(sb)))
    step("peek", name(store.peek(sa.token, a)))
    step("peek-bytes", name(store.peek(sa.token.encode(), a)))
    step("peek-wrong-uuid", name(store.peek(sa.token, b)))
    step("peek-unknown", name(store.peek("deadbeef")))
    step("peek-bad-bytes", name(store.peek(b"\xff\xfe")))
    store.note_undelivered(a)                 # live: not counted
    step("park-a", store.park(a))
    for _ in range(3):
        store.note_undelivered(a)             # parked: counted, hooked
    now[0] += 4.0
    step("peek-in-ttl", name(store.peek(sa.token, a)))
    step("resume-a", name(store.resume(sa)))
    step("park-c-no-session", store.park(c))
    step("park-b", store.park(b))
    now[0] += 2.0
    step("expire-early", store.expire_due())
    now[0] += 4.0
    step("peek-expired", name(store.peek(sb.token, b)))
    step("expire", store.expire_due())
    step("peek-dead", name(store.peek(sb.token, b)))
    sa2 = store.mint(a, "websocket")          # replaces a's session
    step("remint", (name(sa2), name(store.peek(sa.token))))
    step("discard", name(store.discard(a)))
    step("peek-discarded", name(store.peek(sa2.token)))
    step("parked", store.parked_count())
    return out


def test_session_store_transcripts_equal():
    port = _session_transcript(t_sessions)
    ref = _session_transcript(j_sessions)
    assert port == ref
    assert port[-1][2]["expired"] == 1 and port[-1][2]["resumed"] == 1


def _governor_transcript(mod, instruction, registry):
    now = [50.0]
    evicted = []
    gov = mod.OverloadGovernor(
        max_batch=64, tick_budget_ms=10.0, deadline_k=3,
        recover_ticks=4, min_batch=8, peer_rate=20.0, peer_burst=5,
        evict_after=12, resume_rate=2.0, on_evict=evicted.append,
        clock=lambda: now[0],
    )
    out = []

    def step(what, value):
        status = gov.status()
        status.pop("rss_mb")
        out.append((what, value, status, list(evicted)))

    # a tick-wall and queue-depth trace: quiet, K busts, a deep queue,
    # then the long walk back
    trace = ([(4.0, 0)] * 3 + [(15.0, 10)] * 4 + [(45.0, 70)] * 2
             + [(8.0, 140)] * 2 + [(2.0, 0)] * 30)
    for tick_ms, depth in trace:
        now[0] += 0.05
        gov.note_tick(tick_ms, depth)
        step("tick", (tick_ms, depth, gov.state, gov.admitted_batch,
                      gov.take_frame_skip(), gov.coalesce_entities()))
    # mid-window queue signal
    for depth in (10, 40, 70, 130, 200, 20, 0):
        gov.note_queue_depth(depth)
        step("depth", (depth, gov.state))
    # per-peer streams: a hostile peer (evicted once), a polite one,
    # records that consume but never drop, control that always passes
    hostile, polite = PEERS[0], PEERS[1]
    for _ in range(30):
        now[0] += 0.001
        step("hostile", gov.admit(instruction.LOCAL_MESSAGE, hostile))
    for _ in range(6):
        now[0] += 0.2
        step("polite", gov.admit(instruction.LOCAL_MESSAGE, polite))
    step("record", gov.admit(instruction.RECORD_CREATE, hostile))
    step("heartbeat", gov.admit(instruction.HEARTBEAT, hostile))
    step("entity", gov.admit(instruction.LOCAL_MESSAGE, polite,
                             is_entity=True))
    gov.forget_peer(hostile)
    step("forgotten", gov.admit(instruction.LOCAL_MESSAGE, hostile))
    # forced REJECT: handshakes (new shed, resumes through the bucket)
    # and the admission classes
    registry.set("overload.force_state", "state:reject")
    gov.note_idle(0)
    for i in range(6):
        now[0] += 0.1
        ok, hint = gov.admit_handshake(resume=bool(i % 2))
        step("handshake", (bool(i % 2), ok, hint > 0))
    for inst in (instruction.LOCAL_MESSAGE, instruction.GLOBAL_MESSAGE,
                 instruction.AREA_SUBSCRIBE, instruction.RECORD_READ):
        step("reject-admit", (inst.name, gov.admit(inst, PEERS[2])))
    step("hints", [gov.take_refusal_hint() for _ in range(3)])
    registry.reset()
    for _ in range(20):
        gov.note_idle(0)
    step("recovered", gov.state)
    return out


def test_overload_governor_transcripts_equal():
    from worldql_server_tpu.robustness import failpoints as j_failpoints

    # each governor reads its own package's failpoint registry
    port = _governor_transcript(t_overload, Instruction, failpoints.registry)
    ref = _governor_transcript(j_overload, JInstruction,
                               j_failpoints.registry)
    assert port == ref
    states = {row[2]["state"] for row in port}
    assert states == {"ok", "shed_low", "shed_high", "reject"}
    assert port[-1][3] == [PEERS[0]]          # evicted exactly once
    assert port[-1][2]["state"] == "ok"


def _server(**extra):
    config = Config(store_url="memory://", http_enabled=False,
                    zmq_server_host="127.0.0.1", zmq_server_port=free_port(),
                    spatial_backend="cuda", tick_interval=0.02,
                    precompile_tiers=False, query_kinds="off", **extra)
    return WorldQLServer(config, device="cpu")


def _run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _until(cond, what, timeout=10.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, what
        await asyncio.sleep(0.01)


def test_ws_resume_keeps_subscriptions_on_the_port_server():
    async def scenario():
        server = _server(session_ttl=10.0, ws_enabled=True,
                         ws_host="127.0.0.1", ws_port=free_port())
        await server.start()
        try:
            port = server.config.ws_port
            ws = await WsClient.connect(port)
            assert ws.token is not None          # minted at handshake
            pos = Vector3(3.0, 3.0, 3.0)
            await ws.send(Message(instruction=Instruction.AREA_SUBSCRIBE,
                                  world_name="w", position=pos))
            await _until(lambda: server.backend.subscription_count() == 1,
                         "subscription never landed")
            token, u = ws.token, ws.uuid
            await ws.drop()                      # hard TCP abort: parks
            await _until(lambda: server.sessions.parked_count() == 1,
                         "session never parked")
            assert server.backend.subscription_count() == 1
            resumed = await WsClient.resume(port, token, u)
            await _until(lambda: server.sessions.resumed == 1,
                         "session never resumed")
            assert u in server.peer_map
            assert server.backend.match_local_batch([LocalQuery(
                "w", pos, uuid.uuid4(), Replication.EXCEPT_SELF)]) == [[u]]
            # the resumed binding receives fan-out through the ticker
            await server.router.handle_message(Message(
                instruction=Instruction.LOCAL_MESSAGE,
                sender_uuid=uuid.uuid4(), world_name="w", position=pos,
                parameter="after-resume"))
            got = await resumed.recv_until(Instruction.LOCAL_MESSAGE, 10)
            assert got.parameter == "after-resume"
            assert server.sessions_status()["resumed"] == 1
            await resumed.close()
        finally:
            await server.stop()

    _run(scenario())


def test_overload_storm_escalates_and_walks_back_to_ok():
    async def scenario():
        server = _server(overload="on", max_batch=64, ws_enabled=False,
                         zmq_enabled=False)
        await server.start()
        try:
            gov = server.governor
            assert server.router.governor is gov
            assert server.ticker._governor is gov
            assert gov.tick_budget_ms == pytest.approx(20.0)
            sender = uuid.uuid4()
            # the storm: 600 LocalMessages in one event-loop turn, far
            # past 2 x max_batch before the ticker can flush
            for i in range(600):
                await server.router.handle_message(Message(
                    instruction=Instruction.LOCAL_MESSAGE,
                    sender_uuid=sender, world_name="w",
                    position=Vector3(1.0, 1.0, 1.0), parameter=f"s{i}"))
            status = server.overload_status()
            assert status["peak_level"] == 3       # reached REJECT
            assert status["shed_local"] + status["drop_oldest"] > 0
            await _until(lambda: gov.state == "ok", "never recovered")
            assert gov.admitted_batch == 64
            assert server.overload_status()["transitions"] >= 2
        finally:
            await server.stop()

    _run(scenario())
