"""The port's SERVER on the sharded mesh index (``spatial_backend=
'sharded'``, mesh built by ``build_backend``), against the JAX
package's ``tests/test_sharded_server.py`` and its sharded server.

The reference drives its server over WebSocket; the card host has no
``websockets``, so these twins drive the port's over ZeroMQ, through
the tick batcher, in process. The mesh is 2 x 4 virtual CPU shards
(``mesh_devices=["cpu"] * 8``), the JAX server's its 8 virtual CPU
devices. A peer's disconnect is the transport's cleanup call,
``peer_map.remove`` (the WS close in the reference).

Also: entity frames of an ``--entity-sim`` server on a 2 x 2 mesh equal
the JAX sharded server's, byte for byte, and ``sharded`` validates and
builds a ``ShardedCudaSpatialBackend`` from the port's config.

Tolerance: exact (wire frames, fan-out sets).
"""

from __future__ import annotations

import asyncio

import pytest

from tests.client_util import ZmqClient, free_port
from tests.test_torch_server import _config, _entity_scenario
from worldql_server_tpu.engine.config import Config as JConfig
from worldql_server_tpu.engine.server import WorldQLServer as JServer
from worldql_server_tpu.protocol import (
    Instruction, Message, Replication, Vector3)
from worldql_server_tpu_torch.engine.config import Config
from worldql_server_tpu_torch.engine.server import (
    WorldQLServer, build_backend)
from worldql_server_tpu_torch.parallel import ShardedCudaSpatialBackend

CPU8 = ["cpu"] * 8


def run(coro, timeout=180):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def make_sharded_server(**overrides) -> WorldQLServer:
    config = Config()
    config.store_url = "memory://"
    config.http_enabled = False
    config.ws_enabled = False
    config.zmq_server_host = "127.0.0.1"
    config.zmq_server_port = free_port()
    config.spatial_backend = "sharded"
    config.mesh_batch = 2
    config.mesh_space = 4
    config.tick_interval = 0.02
    for key, value in overrides.items():
        setattr(config, key, value)
    return WorldQLServer(config, mesh_devices=CPU8)


@pytest.fixture(autouse=True)
def port_on_the_cpu(monkeypatch):
    monkeypatch.setenv("WQL_TORCH_DEVICE", "cpu")


def test_build_backend_sharded_from_config():
    config = Config()
    config.spatial_backend = "sharded"
    config.mesh_batch = 2
    config.mesh_space = 0  # auto: all remaining devices
    config.validate()
    backend = build_backend(config, mesh_devices=CPU8)
    assert isinstance(backend, ShardedCudaSpatialBackend)
    assert backend.n_batch == 2 and backend.n_space == 4
    # without mesh_devices: this host's devices, the CPU alone here
    config.mesh_batch = 1
    backend = build_backend(config)
    assert (backend.n_batch, backend.n_space) == (1, 1)
    config.mesh_space = 4
    with pytest.raises(ValueError, match="exceeds 1 available devices"):
        build_backend(config)


def test_config_rejects_bad_mesh():
    config = Config()
    config.spatial_backend = "sharded"
    config.mesh_batch = 0
    with pytest.raises(ValueError):
        config.validate()
    config.mesh_batch = 1
    config.mesh_space = -1
    with pytest.raises(ValueError):
        config.validate()


def test_sharded_server_zmq_fanout_through_ticker():
    """Multi-world fan-out through the full product stack: ZMQ
    transport → router → tick batcher → sharded mesh backend →
    delivery."""

    async def scenario():
        server = make_sharded_server()
        assert isinstance(server.backend, ShardedCudaSpatialBackend)
        assert server.ticker is not None
        await server.start()
        try:
            port = server.config.zmq_server_port
            sender = await ZmqClient.connect(port)
            subs = [await ZmqClient.connect(port) for _ in range(4)]
            worlds = ["alpha", "alpha", "beta", "beta"]
            pos = Vector3(8.0, 8.0, 8.0)
            for client, world in zip(subs, worlds):
                await client.send(Message(
                    instruction=Instruction.AREA_SUBSCRIBE,
                    world_name=world, position=pos,
                ))
            await asyncio.sleep(0.2)

            for world in ("alpha", "beta"):
                await sender.send(Message(
                    instruction=Instruction.LOCAL_MESSAGE,
                    world_name=world, position=pos,
                    parameter=f"msg-{world}",
                    replication=Replication.EXCEPT_SELF,
                ))
            for client, world in zip(subs, worlds):
                got = await client.recv_until(
                    Instruction.LOCAL_MESSAGE, timeout=30
                )
                assert got.parameter == f"msg-{world}"
                assert got.world_name == world

            # disconnect cleanup flows into the mesh index
            await server.peer_map.remove(subs[0].uuid)
            await subs[0].close()
            await asyncio.sleep(0.3)
            await sender.send(Message(
                instruction=Instruction.LOCAL_MESSAGE,
                world_name="alpha", position=pos, parameter="after-drop",
            ))
            got = await subs[1].recv_until(Instruction.LOCAL_MESSAGE,
                                           timeout=30)
            assert got.parameter == "after-drop"
            assert server.backend.query_world("alpha") == {subs[1].uuid}
            for client in (sender, *subs[1:]):
                await client.close()
        finally:
            await server.stop()
        return True

    assert run(scenario())


def test_sharded_server_survives_churn_with_compaction():
    """Server-mode churn: enough subscribe traffic to force background
    compactions of the mesh index while the server keeps serving."""

    async def scenario():
        server = make_sharded_server()
        server.backend._compact_threshold_override = 64
        await server.start()
        try:
            port = server.config.zmq_server_port
            client = await ZmqClient.connect(port)
            listener = await ZmqClient.connect(port)
            probe = Vector3(4.0, 4.0, 4.0)
            await listener.send(Message(
                instruction=Instruction.AREA_SUBSCRIBE,
                world_name="hot", position=probe,
            ))
            # Interleave probes with the churn: each probe rides a
            # ticker flush, which is what arms/swaps compactions.
            for i in range(300):
                await client.send(Message(
                    instruction=Instruction.AREA_SUBSCRIBE,
                    world_name=f"w{i % 5}",
                    position=Vector3(
                        float((i * 37) % 500), 0.0, float((i * 91) % 500)
                    ),
                ))
                if i % 50 == 49:
                    await client.send(Message(
                        instruction=Instruction.LOCAL_MESSAGE,
                        world_name="hot", position=probe,
                        parameter=f"probe-{i}",
                    ))
                    got = await listener.recv_until(
                        Instruction.LOCAL_MESSAGE, timeout=30
                    )
                    assert got.parameter == f"probe-{i}"
            server.backend.wait_compaction()
            assert server.backend.compactions >= 1
            assert server.backend.compaction_failures == 0

            await client.send(Message(
                instruction=Instruction.LOCAL_MESSAGE,
                world_name="hot", position=probe, parameter="still-alive",
            ))
            got = await listener.recv_until(Instruction.LOCAL_MESSAGE,
                                            timeout=30)
            assert got.parameter == "still-alive"
            for c in (client, listener):
                await c.close()
        finally:
            await server.stop()
        return True

    assert run(scenario())


def test_entity_frames_on_a_mesh_equal_the_jax_sharded_server():
    """``--entity-sim`` over the sharded index: the plane runs on the
    mesh's first device, and the entity frames each peer receives in
    the steady state equal the JAX sharded server's, byte for byte."""
    mesh = dict(spatial_backend="sharded", mesh_batch=2, mesh_space=2)
    port_server = WorldQLServer(_config(Config, **mesh),
                                mesh_devices=["cpu"] * 4)
    assert isinstance(port_server.backend, ShardedCudaSpatialBackend)
    assert port_server.entity_plane.device == port_server.backend.device
    assert port_server.device_status()["index"] == "cpu"
    jax_server = JServer(_config(JConfig, **mesh))

    async def both():
        return (await _entity_scenario(port_server),
                await _entity_scenario(jax_server))

    port, ref = run(both(), 240)
    assert all(port) and all(ref)  # both peers received frames
    assert port == ref
