"""The port's server end to end over real ZeroMQ, against the JAX
package's server running the same script.

Both servers boot in-process on the CPU: the port with ``device='cpu'``
over its ``cuda`` device index, the JAX package with
``--spatial-backend tpu`` on JAX's CPU backend. Tolerance everywhere:
exact (wire bytes).

* Entity frames: two ZMQ peers with fixed UUIDs register static
  (zero-velocity) entities with fixed UUIDs (``--entity-sim``); once
  every entity is registered the world is static, so every tick emits
  the same frames. The set of distinct ``entity.frame`` wire frames each
  peer receives in the steady state must be equal between the servers.
* AreaSubscribe → LocalMessage: three peers subscribe to cubes and each
  sends LocalMessages in one replication mode; the frames each peer
  receives must be equal, as a multiset, between the servers.

The entity peers register one after the other. The plane assigns slots
in arrival order and the stencil kNN breaks ties inside a shared cube
by slot, so when the two registrations raced over two sockets each
server could see them in its own order and resolve other neighbours —
the cause of this test's earlier intermittent failure.

Every compared window is closed by a heartbeat barrier: a peer sends a
heartbeat and reads until its echo. The server sends one peer's frames
and the echo down one PUSH socket, which delivers in order, so every
frame the server sent before the echo has been read — however far the
transport lags behind the ticks.

* Query library: a client at a fixed UUID asks one ``query.cone``,
  ``query.raycast``, ``query.knn`` and ``query.density`` each; the
  ``.result`` reply frame it receives must be equal, byte for byte,
  between the port (its cuda index on the CPU) and the JAX server (its
  cpu index, the oracle). The default servers of both packages answer
  ``query.cone`` with the same frame, and the port's server with
  ``--resilience on`` boots and serves.

Also: ``python -m worldql_server_tpu_torch --help`` boots, and the
port's config accepts ``cuda``, the query library, resilience, the
delivery plane, sessions, the overload governor, interest management,
index snapshots, the cluster tier, the SLO engine and the ``sharded``
mesh index (its server builds one), and rejects ``tpu``. A boot
warm-up that fails fails the port's boot, where the JAX server logs it
and serves with cold caches.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import uuid

import pytest
import zmq

from tests.client_util import ZmqClient, free_port
from worldql_server_tpu.engine.config import Config as JConfig
from worldql_server_tpu.engine.server import WorldQLServer as JServer
from worldql_server_tpu.protocol import Instruction, Message
from worldql_server_tpu.protocol import deserialize_message
from worldql_server_tpu.protocol.types import Entity, Replication, Vector3
from worldql_server_tpu_torch.engine.config import (
    Config as TConfig, apply_device_boot_defaults)
from worldql_server_tpu_torch.engine.server import WorldQLServer as TServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEERS = (uuid.UUID(int=0x1111), uuid.UUID(int=0x2222))
AREA_PEERS = (uuid.UUID(int=0x3331), uuid.UUID(int=0x3332),
              uuid.UUID(int=0x3333))
#: each server's device index: the port's cuda, the JAX package's tpu
BACKEND = {TConfig: "cuda", JConfig: "tpu"}


def _config(cls, **extra):
    config = cls()
    config.store_url = "memory://"
    config.http_enabled = False
    config.ws_enabled = False
    config.zmq_server_host = "127.0.0.1"
    config.zmq_server_port = free_port()
    config.tick_interval = 0.03
    config.spatial_backend = BACKEND[cls]
    # neither frame scenario sends a query kind; 'off' spares the JAX
    # server the boot walk of the kind kernels (jit compiles)
    config.query_kinds = "off"
    config.entity_sim = True
    config.entity_k = 4
    for key, value in extra.items():
        setattr(config, key, value)
    return config


def _server(cls, **extra):
    config = _config(cls, **extra)
    return TServer(config, device="cpu") if cls is TConfig else \
        JServer(config)


def _entities(peer_index):
    """Static entities of one peer: two clusters shared with the other
    peer (so frames cross peers) and a lone one far away."""
    out = []
    for i in range(6):
        x = 1.0 + i + 0.25 * peer_index
        out.append(Entity(uuid=uuid.UUID(int=0x9000 + 16 * peer_index + i),
                          position=Vector3(x, 2.0, 3.0 + 0.5 * i),
                          world_name="w"))
    out.append(Entity(uuid=uuid.UUID(int=0x9900 + peer_index),
                      position=Vector3(500.0 + 100 * peer_index, 0.0, 0.0),
                      world_name="w"))
    return out


async def _barrier(client, keep=None):
    """Heartbeat, then read until its echo: on return every frame the
    server sent this peer before the echo has been read (and passed to
    ``keep``)."""
    await client.send(Message(instruction=Instruction.HEARTBEAT))
    while True:
        data = await asyncio.wait_for(client.pull.recv(), 60)
        msg = deserialize_message(data)
        if msg.instruction == Instruction.HEARTBEAT:
            return
        if keep is not None:
            keep(msg, bytes(data))


async def _wait(counter, ticks):
    """Wait until ``counter()`` has advanced by ``ticks``."""
    target = counter() + ticks
    while counter() < target:
        await asyncio.sleep(0.005)


async def _steady_frames(clients, plane, ticks):
    """Distinct entity.frame wire frames each client receives over
    ``ticks`` applied ticks, between two heartbeat barriers."""
    for client in clients:
        await _barrier(client)  # drop whatever came before
    frames = [set() for _ in clients]
    await _wait(lambda: plane.applied_ticks, ticks)
    for seen, client in zip(frames, clients):
        await _barrier(client, lambda msg, data, seen=seen: (
            msg.instruction == Instruction.LOCAL_MESSAGE
            and msg.parameter == "entity.frame" and seen.add(data)))
    return frames


async def _entity_scenario(server):
    await server.start()
    try:
        port = server.config.zmq_server_port
        plane = server.entity_plane
        clients = [await ZmqClient.connect(port, peer_uuid=p) for p in PEERS]
        # one peer after the other: the plane assigns slots in arrival
        # order, and the stencil kNN breaks ties in a shared cube by
        # slot, so two registrations racing over two sockets would
        # give each server its own neighbour sets
        for i, client in enumerate(clients):
            await client.send(Message(
                instruction=Instruction.LOCAL_MESSAGE, world_name="w",
                entities=_entities(i),
            ))
            while plane.entity_count < (i + 1) * len(_entities(0)):
                await asyncio.sleep(0.01)
        # every registration has ticked once two ticks have applied
        await _wait(lambda: plane.applied_ticks, 2)
        got = await _steady_frames(clients, plane, 3)
        for client in clients:
            await client.close()
        return got
    finally:
        await server.stop()


def test_zmq_frames_equal_the_jax_server():
    async def both():
        port = await _entity_scenario(_server(TConfig))
        ref = await _entity_scenario(_server(JConfig))
        return port, ref

    port, ref = asyncio.run(asyncio.wait_for(both(), 240))
    assert all(port) and all(ref)  # both peers received frames
    assert port == ref


#: (peer index, cube position) subscriptions: peers 0 and 1 share cube A,
#: peer 2 holds cube A and cube B
_SUBS = ((0, (1.0, 2.0, 3.0)), (1, (5.0, 6.0, 7.0)), (2, (9.0, 2.0, 3.0)),
         (2, (40.0, 2.0, 3.0)))
#: LocalMessage positions: cube A, cube B, and a cube nobody holds
_SPOTS = ((2.0, 3.0, 4.0), (41.0, 3.0, 4.0), (-300.0, 0.0, 0.0))


async def _area_scenario(server, replication):
    await server.start()
    try:
        port = server.config.zmq_server_port
        clients = [await ZmqClient.connect(port, peer_uuid=p)
                   for p in AREA_PEERS]
        for i, pos in _SUBS:
            await clients[i].send(Message(
                instruction=Instruction.AREA_SUBSCRIBE, world_name="w",
                position=Vector3(*pos)))
        for client in clients:
            await _barrier(client)  # subscriptions applied, notices read
        sent = server.ticker.messages + len(clients) * len(_SPOTS)
        for i, client in enumerate(clients):
            for j, pos in enumerate(_SPOTS):
                await client.send(Message(
                    instruction=Instruction.LOCAL_MESSAGE, world_name="w",
                    position=Vector3(*pos), parameter=f"m{i}-{j}",
                    replication=replication, flex=bytes([i, j])))
        while server.ticker.messages < sent:  # every one flushed
            await asyncio.sleep(0.005)
        got = []
        for client in clients:
            frames = []
            await _barrier(client, lambda msg, data, frames=frames: (
                msg.instruction == Instruction.LOCAL_MESSAGE
                and frames.append(data)))
            got.append(sorted(frames))
        for client in clients:
            await client.close()
        return got
    finally:
        await server.stop()


@pytest.mark.parametrize("replication", list(Replication),
                         ids=lambda r: r.name.lower())
def test_zmq_area_local_messages_equal_the_jax_server(replication):
    async def both():
        port = await _area_scenario(
            _server(TConfig, entity_sim=False), replication)
        ref = await _area_scenario(
            _server(JConfig, entity_sim=False), replication)
        return port, ref

    port, ref = asyncio.run(asyncio.wait_for(both(), 240))
    assert any(port)  # some peer received a LocalMessage
    assert port == ref
    if replication == Replication.ONLY_SELF:
        # a sender subscribed to the cube hears only itself
        assert [len(f) for f in port] == [1, 1, 2]


#: the query stage: an asker at (8, 8, 8), a lane target at (24, 8, 8)
#: and a flank target at (8, 40, 8) — cubes (16, 16, 16), (32, 16, 16)
#: and (16, 48, 16) at size 16
_STAGE = ((8, 8, 8), (24, 8, 8), (8, 40, 8))
#: one query of each kind, asked from the asker's position
_QUERIES = (
    ("query.cone", {"dir": [1, 0, 0], "half_angle_deg": 95, "range": 48}),
    ("query.raycast", {"dir": [1, 0, 0], "max_t": 48, "mode": "first_hit"}),
    ("query.raycast", {"dir": [0, 0, 1], "max_t": 48, "mode": "all_hits"}),
    ("query.knn", {"k": 2, "max_range": 48}),
    ("query.density", {"extent": 2, "top_n": 8}),
)


async def _query_scenario(server, queries=_QUERIES, resilient=False):
    """The reply frames the asker receives, one per query, as bytes;
    on the port's cuda index, every query went through its kind
    expansion."""
    await server.start()
    try:
        port = server.config.zmq_server_port
        clients = [await ZmqClient.connect(port, peer_uuid=p)
                   for p in AREA_PEERS]
        for client, pos in zip(clients, _STAGE):
            await client.send(Message(
                instruction=Instruction.AREA_SUBSCRIBE, world_name="w",
                position=Vector3(*map(float, pos))))
        for client in clients:
            await _barrier(client)  # subscriptions applied
        asker = clients[0]
        replies = []
        for wire, payload in queries:
            await asker.send(Message(
                instruction=Instruction.LOCAL_MESSAGE, world_name="w",
                position=Vector3(*map(float, _STAGE[0])), parameter=wire,
                flex=json.dumps(payload).encode()))
            while True:
                data = await asyncio.wait_for(asker.pull.recv(), 60)
                msg = deserialize_message(data)
                if msg.parameter == f"{wire}.result":
                    replies.append(bytes(data))
                    break
        if isinstance(server, TServer) and \
                server.config.spatial_backend == "cuda":
            assert server.backend.kind_expansions == len(queries)
        if resilient:
            status = server.resilience_status()
            assert status is not None and status["inner"] == \
                "CudaSpatialBackend"
            assert server.metrics.gauge_value("resilience")["failures"] == 0
        for client in clients:
            await client.close()
        return replies
    finally:
        await server.stop()


def test_zmq_query_replies_equal_the_jax_server():
    async def both():
        port = await _query_scenario(_server(
            TConfig, entity_sim=False, query_kinds="on"))
        ref = await _query_scenario(_server(
            JConfig, entity_sim=False, query_kinds="on",
            spatial_backend="cpu"))
        return port, ref

    port, ref = asyncio.run(asyncio.wait_for(both(), 240))
    assert port == ref
    bodies = [json.loads(bytes(deserialize_message(d).flex)) for d in port]
    lane, flank = (p.hex for p in AREA_PEERS[1:])
    assert sorted(bodies[0]["peers"]) == sorted([lane, flank])   # cone
    assert bodies[1]["peers"] == [lane] and bodies[1]["t"] == 16.0
    assert bodies[2]["peers"] == []                             # a miss
    assert bodies[3]["peers"] == [lane, flank]                  # knn order
    assert len(bodies[4]["cubes"]) == 3                         # density


def _default(cls):
    """A package's default server, with only its ports set."""
    config = cls()
    config.store_url = "memory://"
    config.http_enabled = False
    config.ws_enabled = False
    config.zmq_server_host = "127.0.0.1"
    config.zmq_server_port = free_port()
    return TServer(config, device="cpu") if cls is TConfig else \
        JServer(config)


def test_default_server_answers_query_cone_as_the_jax_one():
    async def both():
        cone = _QUERIES[:1]
        return (await _query_scenario(_default(TConfig), cone),
                await _query_scenario(_default(JConfig), cone))

    port, ref = asyncio.run(asyncio.wait_for(both(), 240))
    assert port == ref and len(port) == 1


def test_resilience_on_boots_and_serves():
    async def both():
        port = await _query_scenario(
            _server(TConfig, entity_sim=False, query_kinds="on",
                    resilience="on"), resilient=True)
        ref = await _query_scenario(_server(
            JConfig, entity_sim=False, query_kinds="on",
            spatial_backend="cpu"))
        return port, ref

    port, ref = asyncio.run(asyncio.wait_for(both(), 240))
    assert port == ref


def test_cli_help_boots():
    env = dict(os.environ, WQL_TORCH_DEVICE="cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "worldql_server_tpu_torch", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "--entity-sim" in proc.stdout
    assert "cuda" in proc.stdout


def test_cli_without_a_card_exits_with_an_error():
    """The default device is the card: without one the CLI names the
    problem and exits 1 instead of serving on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would serve on it")
    env = {k: v for k, v in os.environ.items() if k != "WQL_TORCH_DEVICE"}
    proc = subprocess.run(
        [sys.executable, "-m", "worldql_server_tpu_torch", "--entity-sim",
         "--spatial-backend", "cuda",
         "--tick-interval", "0.05", "--store-url", "memory://",
         "--no-ws", "--no-http", "--no-zmq"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1
    assert "no CUDA card" in proc.stderr


@pytest.mark.parametrize("field,value", [
    ("spatial_backend", "tpu"), ("spatial_backend", "sharded"),
])
def test_config_rejects_unported(field, value):
    """'tpu' names the JAX package's index, which the port serves as
    cuda, and is refused; 'sharded', the mesh index, is ported: it
    validates and its server builds a ``ShardedCudaSpatialBackend`` on
    a mesh of the CPU here."""
    config = _config(TConfig, **{field: value})
    if value == "tpu":
        with pytest.raises(ValueError, match="serves it as 'cuda'"):
            config.validate()
        return
    from worldql_server_tpu_torch.parallel import ShardedCudaSpatialBackend

    config.validate()
    server = TServer(config, device="cpu")
    assert isinstance(server.backend, ShardedCudaSpatialBackend)
    assert server.backend.mesh.shape == {"batch": 1, "space": 1}
    assert server.entity_plane.device == server.backend.device


@pytest.mark.parametrize("field,value", [
    ("query_kinds", "on"), ("resilience", "on"),
    ("delivery_workers", 1), ("session_ttl", 5.0), ("overload", "on"),
    ("interest", "on"), ("index_snapshot", "idx.snap"),
    ("cluster_shards", 2), ("slo", "on"),
])
def test_config_accepts_ported(field, value):
    """The query library, the resilient backend, the delivery plane,
    sessions, the overload governor, interest management, index
    snapshots, the cluster tier and the SLO engine are ported: they
    validate over the cuda index and over the cpu one — but interest,
    which rides the entity plane, and so the device index, is refused
    over the cpu index as the JAX package refuses it."""
    _config(TConfig, **{field: value}).validate()
    cpu = _config(TConfig, entity_sim=False, spatial_backend="cpu",
                  **{field: value})
    if field != "interest":
        cpu.validate()
        return
    ref = _config(JConfig, entity_sim=False, spatial_backend="cpu",
                  interest="on")
    for config in (cpu, ref):
        with pytest.raises(ValueError, match="interest requires entity_sim"):
            config.validate()


def test_config_accepts_cuda():
    """The device index validates, with and without the entity plane,
    with delta ticks on and staging on."""
    _config(TConfig).validate()
    _config(TConfig, entity_sim=False).validate()
    _config(TConfig, delta_ticks="on", query_staging="on").validate()
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        _config(TConfig, spatial_backend="gpu").validate()


def test_default_boots_validate():
    """Every default boot works: the bare config, and --entity-sim with
    a tick interval over the cuda index. As in the JAX package, the
    entity plane and delta_ticks='on' refuse the cpu index, and a card
    boots the cuda index on a 0.05 s tick."""
    TConfig().validate()
    _config(TConfig).validate()
    assert TConfig().query_kinds == "on"  # as in the JAX package
    assert TConfig().resilience == "off"
    with pytest.raises(ValueError, match="entity_sim requires a device"):
        _config(TConfig, spatial_backend="cpu").validate()
    with pytest.raises(ValueError, match="delta_ticks='on' requires"):
        _config(TConfig, spatial_backend="cpu", entity_sim=False,
                delta_ticks="on").validate()
    card = TConfig()
    assert apply_device_boot_defaults(
        card, backend_explicit=False, interval_explicit=False, present=True)
    assert (card.spatial_backend, card.tick_interval) == ("cuda", 0.05)
    card.entity_sim = True
    card.validate()
    # explicit settings win, field by field; no card leaves it untouched
    kept = TConfig()
    assert not apply_device_boot_defaults(
        kept, backend_explicit=True, interval_explicit=False, present=True)
    assert not apply_device_boot_defaults(
        kept, backend_explicit=False, interval_explicit=False,
        present=False)
    assert kept.spatial_backend == TConfig().spatial_backend
    # the server is constructible without touching a transport, with
    # the plane and the index on one device
    server = TServer(_config(TConfig), device="cpu")
    assert server.entity_plane.device.type == "cpu"
    assert server.backend.device == server.entity_plane.device
    assert server.staging is not None  # the cuda index stages
    assert zmq.zmq_version()  # the ZMQ legs above ran on a real libzmq


@pytest.mark.parametrize("warmup", ["index", "entities"])
def test_failed_warmup_fails_the_boot(warmup, monkeypatch):
    """A deliberate deviation from the JAX server: the port's boot
    warm-up (the index's tier walk, the entity plane's kernel build and
    tick ladder) raising fails ``start()``, where the JAX server logs
    the error and serves with cold caches. A card whose device path
    does not run must not serve; in a cluster such a shard exits and
    the supervisor's restart budget takes over."""
    import worldql_server_tpu.spatial.precompile as j_pre
    import worldql_server_tpu_torch.spatial.precompile as t_pre

    def boom(*args, **kwargs):
        raise RuntimeError("injected warm-up failure")

    async def boot(cls):
        server = _server(cls, precompile_tiers=True)
        if cls is JConfig:
            # the JAX server with the same failure: it must still serve
            # (both legs fail here, so neither jits a tier on the CPU)
            monkeypatch.setattr(j_pre, "precompile_tiers", boom)
            monkeypatch.setattr(server.entity_plane, "precompile", boom)
        elif warmup == "index":
            monkeypatch.setattr(t_pre, "precompile_tiers", boom)
        else:
            monkeypatch.setattr(server.entity_plane, "precompile", boom)
        try:
            await server.start()
        finally:
            await server.stop()
        return server

    with pytest.raises(RuntimeError, match="injected warm-up failure"):
        asyncio.run(asyncio.wait_for(boot(TConfig), 60))
    jax = asyncio.run(asyncio.wait_for(boot(JConfig), 120))
    assert jax.precompile_stats is None
