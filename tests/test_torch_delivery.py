"""The port's delivery plane against the JAX package's.

* Ring interoperability: a record the port's ``Ring`` writes is read by
  the JAX package's ``Ring`` attached to the same shared-memory block,
  and the other way round, round the ring many times through WRAP
  markers (the byte layout ``[kind][frame_len][n_slots]
  [t_ingress][t_write][frame][slots]`` is one contract).
* WebSocket fan-out through ``--delivery-workers 2``: three WS clients
  subscribe to one cube and each sends LocalMessages; the frames each
  client receives through the sender workers must equal, as a multiset,
  what the same clients receive from the JAX server with its own
  workers (UUIDs are assigned per connection, so every UUID is replaced
  by its client's index before the comparison). Every client is adopted
  by a worker, and no frame is dropped at a ring.
* The sender workers the port spawns load neither torch nor JAX: no
  library of either is mapped into a live worker, and the worker's
  import closure, imported alone in a fresh interpreter, holds neither
  in ``sys.modules``.

Tolerance: exact (bytes, records, frame multisets).
"""

from __future__ import annotations

import asyncio
import os
import struct
import subprocess
import sys

import pytest

from tests.client_util import WsClient, free_port
from worldql_server_tpu.delivery import ring as j_ring
from worldql_server_tpu.engine.config import Config as JConfig
from worldql_server_tpu.engine.server import WorldQLServer as JServer
from worldql_server_tpu.protocol import Instruction, Message, Vector3
from worldql_server_tpu_torch.delivery import ring as t_ring
from worldql_server_tpu_torch.engine.config import Config as TConfig
from worldql_server_tpu_torch.engine.server import WorldQLServer as TServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RINGS = {"port": t_ring, "jax": j_ring}


def _records(n, seed):
    """Frames of assorted lengths (a few near the ring's size, so the
    writer wraps) with their slot lists."""
    import random

    rng = random.Random(seed)
    out = []
    for i in range(n):
        size = rng.choice((1, 7, 64, 500, 3000, 9000, 20000))
        frame = bytes(rng.randrange(256) for _ in range(min(size, 64)))
        frame = (frame * (size // len(frame) + 1))[:size]
        slots = [rng.randrange(1 << 20) for _ in range(rng.randrange(5))]
        out.append((frame, slots, i + 1))
    return out


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port")])
def test_ring_records_cross_packages(writer, reader):
    w = RINGS[writer].Ring.create(RINGS[writer].RING_MIN_BYTES)
    r = RINGS[reader].Ring.attach(w.name)
    try:
        assert r.cap == w.cap == t_ring.RING_MIN_BYTES
        pending = list(_records(120, seed=len(writer)))
        got, sent = [], []
        wraps = 0
        while pending or len(got) < len(sent):
            # write until the ring refuses, then drain a few: the
            # cursor walks round the ring many times
            while pending:
                frame, slots, t_in = pending[0]
                head = w._head() % w.cap
                size = w.record_size(len(frame), len(slots))
                if not w.try_write(frame, struct.pack(
                        f"<{len(slots)}I", *slots), t_in):
                    break
                wraps += head + size > w.cap
                sent.append(pending.pop(0))
            for _ in range(3):
                rec = r.read_record()
                if rec is None:
                    break
                frame, slots, t_in, t_write = rec
                assert t_write > 0
                got.append((frame, slots, t_in))
        assert got == sent and len(got) == 120
        assert wraps > 0
        assert r.read_record() is None and w.pending_bytes() == 0
    finally:
        r.close()
        w.close()
        w.unlink()


def _server(cls, **extra):
    config = cls(store_url="memory://", http_enabled=False,
                 zmq_enabled=False, ws_enabled=True, ws_host="127.0.0.1",
                 ws_port=free_port(), delivery_workers=2,
                 tick_interval=0.02, query_kinds="off",
                 precompile_tiers=False, **extra)
    if cls is TConfig:
        config.spatial_backend = "cuda"
        return TServer(config, device="cpu")
    config.spatial_backend = "tpu"
    return JServer(config)


N_CLIENTS, ROUNDS = 3, 6
POS = Vector3(5.0, 5.0, 5.0)


def _mapped_libraries(pid):
    with open(f"/proc/{pid}/maps") as f:
        return {line.split()[-1] for line in f if "/" in line}


def _torch_or_jax(paths):
    return [p for p in paths if "/torch/" in p or "libtorch" in p
            or "jaxlib" in p or "/jax/" in p]


async def _fanout(server):
    """Frames each client receives, with every UUID replaced by its
    client's index; and, for the port, the workers' mapped libraries."""
    await server.start()
    try:
        port = server.config.ws_port
        clients = [await WsClient.connect(port) for _ in range(N_CLIENTS)]
        index = {c.uuid: i for i, c in enumerate(clients)}
        deadline = asyncio.get_running_loop().time() + 10
        while not all(c.uuid in server.peer_map for c in clients):
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.01)
        for c in clients:
            assert server.peer_map.get(c.uuid).shard is not None  # adopted
            await c.send(Message(instruction=Instruction.AREA_SUBSCRIBE,
                                 world_name="w", position=POS))
        while server.backend.subscription_count() < N_CLIENTS:
            await asyncio.sleep(0.01)
        for r in range(ROUNDS):
            for i, c in enumerate(clients):
                await c.send(Message(
                    instruction=Instruction.LOCAL_MESSAGE, world_name="w",
                    position=POS, parameter=f"m{i}-{r}",
                    flex=bytes([i, r])))
            await asyncio.sleep(0.02)
        got = []
        for c in clients:
            frames = []
            while len(frames) < (N_CLIENTS - 1) * ROUNDS:
                msg = await c.recv_until(Instruction.LOCAL_MESSAGE, 10)
                frames.append((index[msg.sender_uuid], msg.parameter,
                               msg.world_name, bytes(msg.flex),
                               (msg.position.x, msg.position.y,
                                msg.position.z)))
            got.append(sorted(frames))
        stats = server.delivery_plane.stats()
        assert stats["ring_full_drops"] == 0 and stats["alive"] == 2
        libs = [_mapped_libraries(s.proc.pid)
                for s in server.delivery_plane._shards]
        for c in clients:
            await c.close()
        return got, libs
    finally:
        await server.stop()


def test_ws_fanout_through_workers_equals_the_jax_server():
    async def both():
        return (await _fanout(_server(TConfig)),
                await _fanout(_server(JConfig)))

    (port, libs), (ref, _) = asyncio.run(asyncio.wait_for(both(), 120))
    assert port == ref
    assert all(len(f) == (N_CLIENTS - 1) * ROUNDS for f in port)
    # the port's live sender workers map no library of torch or JAX
    # (this test's own process, which imported both, maps both)
    assert _torch_or_jax(_mapped_libraries(os.getpid()))
    for mapped in libs:
        assert mapped, "no mapping read from the worker"
        assert _torch_or_jax(mapped) == []


def test_worker_import_closure_holds_neither_torch_nor_jax():
    """What a spawned worker imports — the worker module and its
    package — loads in a fresh interpreter without torch or JAX."""
    code = (
        "import sys\n"
        "import worldql_server_tpu_torch.delivery.worker as w\n"
        "assert callable(w.worker_main)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'worldql_server_tpu'))\n"
        "print(bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_delivery_workers_spawn_not_fork():
    """A fork after the parent holds a CUDA context is unsafe: the plane
    starts its workers with the spawn context."""
    config = TConfig(store_url="memory://", delivery_workers=1)
    from worldql_server_tpu_torch.delivery import DeliveryPlane

    plane = DeliveryPlane(config)
    assert plane._ctx.get_start_method() == "spawn"
