"""Interest-managed fan-out: the port against the JAX package.

* Twin planes: the JAX package's ``EntityPlane`` (its tick run eagerly,
  see tests/test_torch_entity_plane.py) and the port's
  (``device='cpu'``), each with an ``InterestManager`` of its package on
  one injected clock, are fed the same wire messages tick by tick. The
  frames ``apply()`` emits must be equal byte for byte, with equal
  recipients, over ticks that cover the keyframe, deltas, the LOD far
  cadence, bandwidth deferrals down the demotion ladder and back, and a
  ``mark_resync``; so must the arguments ``build_pairs`` receives from
  ``collect_tick`` (dtypes, shapes, ``-1`` pads), the plane attributes
  ``_center_of`` and ``_encode_template`` read, and every peer's ledger.
  The native template encode is taken in both packages whenever the
  port's build of the native library is there (the JAX package, if it
  found no ``native/libwqlcodec.so``, is handed its own entity codec
  over that build: ``jax_entity_wire``); the object encode is held to
  the same bytes, both packages serializing with the native encoder
  (see ``bind_one_serializer``). Each peer's frames, replayed through the port's
  ``ReplayClient``, refuse no delta, see no gap, and end equal to the
  ledger.
* Over real ZeroMQ, ``--entity-sim --interest on`` on the port (cuda
  index on the CPU) and on the JAX server run one script: two peers
  register static entities one after the other, then one entity moves
  by wire updates. Every peer's replayed stream is green (no refused
  delta, no gap) and equals its ledger, and the port's ledgers equal
  the JAX server's after quiescing.

Tolerance: exact (wire bytes, ledgers, replayed positions).
"""

from __future__ import annotations

import asyncio
import uuid

import numpy as np
import pytest

from tests.client_util import ZmqClient
from tests.test_torch_entity_plane import (
    Twin, _ent, _msg, bind_one_serializer)
from tests.test_torch_server import _barrier, _config, _wait
from worldql_server_tpu.engine.config import Config as JConfig
from worldql_server_tpu.engine.server import WorldQLServer as JServer
from worldql_server_tpu.interest import InterestManager as JManager
from worldql_server_tpu_torch.engine.config import Config as TConfig
from worldql_server_tpu_torch.engine.server import WorldQLServer as TServer
from worldql_server_tpu_torch.interest import (
    InterestManager as TManager, ReplayClient, parse_stamp)
from worldql_server_tpu_torch.interest.manager import PARAM_DELTA
from worldql_server_tpu_torch.protocol import native_codec as t_native_codec
from worldql_server_tpu_torch.protocol import (
    Instruction, Message, deserialize_message)

PEERS = [uuid.UUID(int=0xA100 + i) for i in range(5)]


def _ledger(mgr, peer):
    """A peer's ledger as ``{world: {uuid: (x, y, z)}}`` over the
    plane's world names."""
    st = mgr._peers.get(peer)
    out: dict = {}
    if st is None:
        return out
    for key, (wid, pos_b) in st.state.items():
        x, y, z = np.frombuffer(pos_b, np.float32)
        out.setdefault(wid, {})[uuid.UUID(bytes=key)] = (
            float(x), float(y), float(z))
    return out


def _named(plane, ledger):
    return {plane._world_names[w]: m for w, m in ledger.items() if m}


class Recorder:
    """Wraps a manager's ``build_pairs`` to keep what the plane hands
    it each tick."""

    def __init__(self, mgr):
        self.calls = []
        inner = mgr.build_pairs

        def build_pairs(plane, pos, targets, cap):
            self.calls.append((pos.dtype.str, pos.shape, targets.dtype.str,
                               targets.shape, cap, targets.copy(),
                               pos.copy()))
            return inner(plane, pos, targets, cap)

        mgr.build_pairs = build_pairs


@pytest.mark.parametrize("encode", ["native", "object"])
def test_twin_planes_emit_equal_interest_frames(encode, monkeypatch):
    rng = np.random.default_rng(18)
    # full ticks only: one tick shape, so the eager JAX tick compiles
    # its ops once
    twin = Twin("off", k=4)
    now = [1000.0]
    kw = dict(near_radius=24.0, far_every_k=3, bandwidth_bytes=400,
              clock=lambda: now[0])
    jm, tm = JManager(**kw), TManager(**kw)
    for mgr in (jm, tm):
        # a bucket of about one keyframe (the floor is 64 KiB), so the
        # deltas that follow run it dry within a few ticks
        mgr.bandwidth_burst = 700.0
    twin.jp.interest, twin.tp.interest = jm, tm
    port_lib = t_native_codec.resolve_lib_path()
    native = port_lib is not None and port_lib.exists()
    for plane in (twin.jp, twin.tp):
        assert bool(getattr(plane._wire, "can_encode_interest", False)) \
            == native
        if encode == "object":
            plane._wire = None
        elif not native:
            pytest.skip("the port's native library is not built")
    bind_one_serializer(monkeypatch)
    recs = [Recorder(jm), Recorder(tm)]
    ents = []
    for i in range(90):
        p = PEERS[i % len(PEERS)]
        eid = uuid.UUID(int=0xE100 + i)
        vel = rng.uniform(-25, 25, 3) if i % 4 == 0 else (0.0, 0.0, 0.0)
        ents.append((eid, p))
        twin.feed(_msg(p, [_ent(eid, rng.uniform(-45, 45, 3), "arena",
                                vel)], world="arena"))

    demoted = []

    def tick(dt):
        now[0] += dt
        twin.tick()  # equal frames, bytes and recipients, every tick
        demoted.append(tm.stats()["demoted"])
        for p in PEERS:
            assert _ledger(tm, p) == _ledger(jm, p)

    # keyframes, then deltas under the far cadence (20 bytes of refill
    # a tick cannot keep up: the bucket runs dry and peers defer)
    for _ in range(8):
        tick(0.05)
    tm.mark_resync(PEERS[1]), jm.mark_resync(PEERS[1])
    for _ in range(3):
        tick(0.05)
    # a few wire moves and a second world
    for eid, p in ents[1:30:6]:
        twin.feed(_msg(p, [_ent(eid, rng.uniform(-45, 45, 3), "arena")],
                       world="arena"))
    twin.feed(_msg(PEERS[2], [_ent(uuid.UUID(int=0xEF00), (1, 2, 3),
                                   "lobby")], world="lobby"))
    for _ in range(3):
        tick(0.05)
    # refill: the bucket recovers and the ladder walks back
    for _ in range(6):
        tick(5.0)

    # build_pairs saw the same arrays on both sides, -1 pads included
    for j, t in zip(*(r.calls for r in recs)):
        assert j[:5] == t[:5]
        np.testing.assert_array_equal(j[5], t[5])
        np.testing.assert_array_equal(j[6].view(np.uint8),
                                      t[6].view(np.uint8))
    assert recs[1].calls[0][2] == np.dtype(np.int32).str
    assert (recs[1].calls[0][5] == -1).any()
    # what _center_of and _encode_template read
    for name in ("_peer_slots", "_world_names", "_peer_uuids",
                 "_peer_ids"):
        assert getattr(twin.jp, name) == getattr(twin.tp, name), name
    assert jm.stats() == tm.stats()
    assert tm.deferrals > 0 and max(demoted) > 0 and tm.resyncs >= 1
    assert len(recs[1].calls) == len(demoted)


def test_replayed_port_streams_are_green():
    """The port's stamped stream, replayed per recipient: every delta
    applies on a contiguous same-epoch sequence, and each peer ends
    holding exactly its ledger."""
    rng = np.random.default_rng(7)
    twin = Twin("auto", k=4)
    plane = twin.tp                    # the port's plane alone here
    tm = TManager(near_radius=20.0, far_every_k=2, clock=lambda: 0.0)
    plane.interest = tm
    clients = {p: ReplayClient() for p in PEERS}
    for i in range(60):
        p = PEERS[i % len(PEERS)]
        twin.feed(_msg(p, [_ent(uuid.UUID(int=0xE200 + i),
                                rng.uniform(-30, 30, 3), "w",
                                rng.uniform(-20, 20, 3))]))
    kinds = set()
    for t in range(12):
        if t == 6:
            tm.mark_resync(PEERS[3])
        pairs = plane.apply(plane.collect_tick(plane.dispatch_tick()))
        for frame, targets in pairs:
            kinds.add(parse_stamp(deserialize_message(frame.wire)
                                  .parameter)[0])
            for p in targets:
                assert clients[p].apply(frame.wire)
    assert PARAM_DELTA in kinds and tm.resyncs == 1
    for p, rc in clients.items():
        s = rc.stats()
        assert s["deltas_refused"] == 0 and s["gaps_seen"] == 0, p
        assert rc.snapshot() == _named(plane, _ledger(tm, p))


async def _zmq_scenario(server):
    """Two peers register static entities one after the other, then one
    entity moves by wire updates; each peer's stream goes through a
    ReplayClient. Returns (per-peer replay stats, snapshots, ledgers)."""
    await server.start()
    try:
        port = server.config.zmq_server_port
        plane = server.entity_plane
        clients = [await ZmqClient.connect(port, peer_uuid=p)
                   for p in PEERS[:2]]
        oracles = [ReplayClient() for _ in clients]

        def keep(rc):
            def apply(msg, data):
                if msg.instruction == Instruction.LOCAL_MESSAGE:
                    rc.apply(data)
            return apply

        layout = [[(uuid.UUID(int=0x9100 + 16 * c + i),
                    (1.0 + i + 0.25 * c, 2.0, 3.0 + 0.5 * i))
                   for i in range(5)] for c in range(2)]
        for c, client in enumerate(clients):
            await client.send(Message(
                instruction=Instruction.LOCAL_MESSAGE, world_name="w",
                entities=[_ent(e, p, "w") for e, p in layout[c]]))
            while plane.entity_count < 5 * (c + 1):
                await asyncio.sleep(0.01)
        await _wait(lambda: plane.applied_ticks, 2)
        mover, home = layout[0][2]
        for step in range(4):
            await clients[0].send(Message(
                instruction=Instruction.LOCAL_MESSAGE, world_name="w",
                entities=[_ent(mover, (home[0] + 0.5 * step, home[1],
                                       home[2]), "w")]))
            await _wait(lambda: plane.applied_ticks, 1)
        await _wait(lambda: plane.applied_ticks, 3)   # quiesce
        for client, rc in zip(clients, oracles):
            await _barrier(client, keep(rc))
        mgr = server.interest
        ledgers = [_named(plane, _ledger(mgr, p)) for p in PEERS[:2]]
        for client in clients:
            await client.close()
        return ([rc.stats() for rc in oracles],
                [rc.snapshot() for rc in oracles], ledgers)
    finally:
        await server.stop()


def test_zmq_interest_stream_parity_with_the_jax_server():
    def server(cls):
        config = _config(cls, interest="on", precompile_tiers=False)
        return TServer(config, device="cpu") if cls is TConfig else \
            JServer(config)

    async def both():
        return (await _zmq_scenario(server(TConfig)),
                await _zmq_scenario(server(JConfig)))

    (stats, snaps, ledgers), (_, _, ref) = asyncio.run(
        asyncio.wait_for(both(), 240))
    for s, snap, ledger in zip(stats, snaps, ledgers):
        assert s["deltas_refused"] == 0 and s["gaps_seen"] == 0
        assert s["fulls_applied"] >= 1
        assert snap == ledger            # the eventual-state verdict
    assert any(s["deltas_applied"] for s in stats)
    assert all(ledgers) and ledgers == ref
