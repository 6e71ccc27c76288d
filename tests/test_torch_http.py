"""The HTTP surface: the port's server against the JAX server.

Both boot alike on the host index with ``--slo on --incident-dir``,
``--trace`` and a ticker, serve one subscription and a few LocalMessages
over ZeroMQ, and then answer ``/healthz``, ``/metrics`` (strict-parsed
by tests/prom_parser.py), ``/debug/ticks``, ``/debug/slo`` and
``/debug/incidents`` with the same keys at every level and the same
series names (but ``wql_gc_pause_*``, which a garbage collection of
the interpreter registers whenever it first happens). Values are not
compared: they carry clocks and latencies.

The port adds one block the JAX server lacks, ``device`` in ``/healthz``
(the index's and the entity plane's device): it is there only with a
device index or an entity plane, so the host-index boot here has none,
and the test checks it on a port server of the ``cuda`` index on the
CPU.
"""

from __future__ import annotations

import asyncio
import json
import urllib.request
import uuid as uuid_mod

from tests.client_util import ZmqClient, free_port
from tests.prom_parser import validate_exposition
from worldql_server_tpu.engine.config import Config as JConfig
from worldql_server_tpu.engine.server import WorldQLServer as JServer
from worldql_server_tpu.protocol import Instruction, Message
from worldql_server_tpu.protocol.types import Vector3
from worldql_server_tpu_torch.engine.config import Config as TConfig
from worldql_server_tpu_torch.engine.server import WorldQLServer as TServer

PATHS = ("/healthz", "/metrics", "/debug/ticks", "/debug/slo",
         "/debug/incidents")


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        return resp.read().decode()


def _keys(value):
    """Every key path of a JSON document (list items merged). A span's
    ``tags`` hold what that span saw, so only their presence counts."""
    out = set()

    def walk(v, prefix):
        if isinstance(v, dict):
            for k, item in v.items():
                out.add(prefix + (k,))
                if k != "tags":
                    walk(item, prefix + (k,))
        elif isinstance(v, list):
            for item in v:
                walk(item, prefix + ("[]",))

    walk(value, ())
    return out


async def _surface(server, config, tmp_path):
    await server.start()
    clients = []
    try:
        port = config.zmq_server_port
        rx = await ZmqClient.connect(port, peer_uuid=uuid_mod.UUID(int=1))
        tx = await ZmqClient.connect(port, peer_uuid=uuid_mod.UUID(int=2))
        clients += [rx, tx]
        pos = Vector3(1.0, 2.0, 3.0)
        await rx.send(Message(instruction=Instruction.AREA_SUBSCRIBE,
                              world_name="w", position=pos))
        await asyncio.sleep(0.1)
        for i in range(3):
            await tx.send(Message(instruction=Instruction.LOCAL_MESSAGE,
                                  world_name="w", position=pos,
                                  parameter=f"m-{i}"))
            await rx.recv_until(Instruction.LOCAL_MESSAGE, 30)
        # two evaluations of the SLO engine after the traffic
        await asyncio.sleep(2.5)
        out = {}
        for path in PATHS:
            text = await asyncio.to_thread(_get, config.http_port, path)
            if path == "/metrics":
                _, samples = validate_exposition(text)
                # the collector-pause histogram appears at the first
                # collection the interpreter happens to run, in either
                # server or neither
                out[path] = {name for name, _, _ in samples
                             if not name.startswith("wql_gc_pause")}
            else:
                out[path] = _keys(json.loads(text))
        return out
    finally:
        for c in clients:
            await c.close()
        await server.stop()


def _config(cls, tmp_path, name, **extra):
    return cls(store_url="memory://", ws_enabled=False,
               http_host="127.0.0.1", http_port=free_port(),
               zmq_server_host="127.0.0.1", zmq_server_port=free_port(),
               spatial_backend="cpu", tick_interval=0.03, trace=True,
               slo="on", incident_dir=str(tmp_path / name), **extra)


def test_http_surface_equals_the_jax_server(tmp_path):
    async def both():
        tc = _config(TConfig, tmp_path, "port")
        jc = _config(JConfig, tmp_path, "jax")
        port = await _surface(TServer(tc, device="cpu"), tc, tmp_path)
        jax = await _surface(JServer(jc), jc, tmp_path)
        return port, jax

    port, jax = asyncio.run(asyncio.wait_for(both(), 120))
    for path in PATHS:
        assert port[path] == jax[path], path
    assert ("slo", "state") in port["/healthz"]
    assert "wql_slo_worst" in port["/metrics"]
    assert ("stats", "captured") in port["/debug/incidents"]


def test_healthz_names_the_device_of_the_index_and_the_plane(tmp_path):
    config = _config(TConfig, tmp_path, "dev", entity_sim=True,
                     precompile_tiers=False)
    config.spatial_backend = "cuda"

    async def scenario():
        server = TServer(config, device="cpu")
        await server.start()
        try:
            return json.loads(await asyncio.to_thread(
                _get, config.http_port, "/healthz"))
        finally:
            await server.stop()

    body = asyncio.run(asyncio.wait_for(scenario(), 60))
    assert body["device"]["index"] == "cpu"
    assert body["device"]["entity_plane"] == "cpu"
    assert body["device"]["knn_launches"] >= 0
    # launches by [N, K, count]; the CPU takes the plain version
    assert body["device"]["knn_shapes"] == []
