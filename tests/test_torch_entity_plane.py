"""Twin entity planes: the JAX package's ``EntityPlane`` against the
port's (``device='cpu'``), fed the same wire messages through each
package's ``ColumnarIngest`` and codec, each over its own host ``cpu``
index. After every tick the host columns, the index rows and their
refcounts, the tick's targets and counts, and the delivered frames
(wire bytes and recipients) must be equal.

The scenarios run with delta ticks on and off, through removals, slot
reuse, a capacity-tier growth, and both the incremental scatter and the
full re-upload of the device twin. Tolerance: exact (bytes and
integers; f32 columns compared bit for bit).

The JAX plane runs its tick eagerly (op by op) here. Jitted on XLA:CPU,
its integration ``pos + vel * dt`` is contracted into a fused
multiply-add, which rounds once where the numpy replay of delta ticks
(``_predict_cubes``) rounds twice — a 1-ulp drift pinned by
``test_jitted_jax_tick_contracts_the_integration``. The port keeps the
two rounded operations, which is what the replay assumes.
"""

from __future__ import annotations

import asyncio
import os
import struct
import uuid

import numpy as np
import pytest

from worldql_server_tpu.spatial import jaxconf  # noqa: F401

from worldql_server_tpu import entities as j_entities
from worldql_server_tpu.engine import peers as j_peers
from worldql_server_tpu.engine.peers import PeerMap as JPeerMap
from worldql_server_tpu.ops import tick as jt
import worldql_server_tpu.protocol as j_protocol
from worldql_server_tpu.protocol import Instruction, Message
from worldql_server_tpu.protocol import codec as j_codec
from worldql_server_tpu.protocol import entity_wire as j_entity_wire
from worldql_server_tpu.protocol import native_codec as j_native_codec
from worldql_server_tpu.protocol import deserialize_message as j_deser
from worldql_server_tpu.protocol import serialize_message as j_ser
from worldql_server_tpu.protocol.types import Entity, Vector3
from worldql_server_tpu.spatial.cpu_backend import CpuSpatialBackend as JCpu
from worldql_server_tpu_torch import entities as t_entities
from worldql_server_tpu_torch.engine.peers import PeerMap as TPeerMap
from worldql_server_tpu_torch.ops import tick as tt
from worldql_server_tpu_torch.protocol import codec as t_codec
from worldql_server_tpu_torch.protocol import entity_wire as t_entity_wire
from worldql_server_tpu_torch.protocol import native_codec as t_native_codec
from worldql_server_tpu_torch.protocol import deserialize_message as t_deser
from worldql_server_tpu_torch.protocol import serialize_message as t_ser
from worldql_server_tpu_torch.spatial.cpu_backend import (
    CpuSpatialBackend as TCpu,
)

CUBE = 16


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def vel_flex(v) -> bytes:
    return struct.pack("<3f", *v)


def jax_entity_wire():
    """The JAX package's native entity codec, over the library the port
    bound. The JAX package binds its own only if
    ``native/libwqlcodec.so`` exists at its first use; the port builds
    its copy of the library (``build/native/``, the same sources) at
    its import. Where only the port has one, the JAX package loads its
    codec from the port's build, as ``WQL_NATIVE_CODEC=<path>`` selects
    it, so both planes and both ingests take the same decode and
    encode paths."""
    wire = j_entity_wire.shared()
    if wire is not None or t_entity_wire.shared() is None:
        return wire
    old = os.environ.get("WQL_NATIVE_CODEC")
    os.environ["WQL_NATIVE_CODEC"] = str(t_native_codec.resolve_lib_path())
    try:
        return j_entity_wire.load()
    finally:
        if old is None:
            del os.environ["WQL_NATIVE_CODEC"]
        else:
            os.environ["WQL_NATIVE_CODEC"] = old


class Twin:
    """One JAX plane and one port plane, fed identical bytes."""

    def __init__(self, delta_ticks: str, k: int = 4):
        kw = dict(cube_size=CUBE, k=k, dt=0.05, bounds=1000.0,
                  delta_ticks=delta_ticks)
        self.jb, self.tb = JCpu(CUBE), TCpu(CUBE)
        j_wire = jax_entity_wire()
        self.jp = j_entities.EntityPlane(self.jb, JPeerMap(), wire=j_wire,
                                         **kw)
        self.jp._tick_fn = jt.make_tick_fn(cube_size=CUBE, k=k, dt=0.05,
                                           bounds=1000.0)
        self.tp = t_entities.EntityPlane(self.tb, TPeerMap(), device="cpu",
                                         **kw)
        self.sides = [
            (self.jp, j_entities.ColumnarIngest(
                self.jp, sender_known=lambda u: True, wire=j_wire),
             j_deser),
            (self.tp, t_entities.ColumnarIngest(
                self.tp, sender_known=lambda u: True), t_deser),
        ]

    def feed(self, *messages):
        datas = [j_ser(m) for m in messages]
        for plane, ingest, deser in self.sides:
            async def slow(data, plane=plane, deser=deser):
                plane.ingest(deser(data))

            run(ingest.process_batch(list(datas), slow))

    def tick(self):
        outs = []
        for plane in (self.jp, self.tp):
            handle = plane.dispatch_tick()
            assert handle is not None
            res = plane.collect_tick(handle)
            outs.append((res, plane.apply(res)))
        (jr, jpairs), (tr, tpairs) = outs
        assert jr["mode"] == tr["mode"]
        if jr["mode"] != "replay":
            for key in ("pos", "targets", "counts", "cubes"):
                a, b = np.asarray(jr[key]), np.asarray(tr[key])
                assert a.dtype == b.dtype and a.shape == b.shape, key
                np.testing.assert_array_equal(
                    a.view(np.uint8), b.view(np.uint8), err_msg=key)
        assert _frames(jpairs, j_ser) == _frames(tpairs, t_ser)
        self.assert_state()
        return jr["mode"], len(jpairs)

    def assert_state(self):
        j, t = self.jp, self.tp
        assert j._cap == t._cap
        for name in ("_pos", "_vel", "_wid", "_pid", "_cube", "_live",
                     "_uuid_bytes", "_device_dirty"):
            a, b = getattr(j, name), getattr(t, name)
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                          err_msg=name)
        if j._have_last:
            for name in ("_last_targets", "_last_counts", "_last_pos"):
                np.testing.assert_array_equal(getattr(j, name),
                                              getattr(t, name))
        assert j._slot_of == t._slot_of
        assert j._free == t._free
        assert j._sub_refs == t._sub_refs
        assert sorted(map(repr, self.jb.export_rows())) == \
            sorted(map(repr, self.tb.export_rows()))
        js, ts = j.stats(), t.stats()
        js.pop("last_integrate_ms"), ts.pop("last_integrate_ms")
        js.pop("last_knn_ms"), ts.pop("last_knn_ms")
        js.pop("last_apply_ms"), ts.pop("last_apply_ms")
        assert js == ts


def _frames(pairs, ser):
    out = []
    for msg, targets in pairs:
        wire = getattr(msg, "wire", None)
        out.append((wire if wire is not None else ser(msg),
                    tuple(str(t) for t in targets)))
    return out


def bind_one_serializer(monkeypatch):
    """Make the JAX package serialize with the encoder the port bound.

    The JAX package binds its native encoder only if
    ``native/libwqlcodec.so`` existed when its ``protocol`` package was
    imported; the port builds its own copy of the library
    (``build/native/libwqlcodec.so``, from the same sources) at that
    import. On a tree without ``native/libwqlcodec.so`` the JAX package
    keeps the Python flatbuffers builder, which lays out the same
    ``Message`` in other bytes (and other lengths: interest bandwidth
    admission charges a frame its length, so even which frames go out
    differs). Frames built as objects are comparable byte for byte only
    from one encoder, so the JAX package gets its own native encoder
    over the port's build, as ``WQL_NATIVE_CODEC=<path>`` selects it."""
    if (j_codec._native is None) == (t_codec._native is None):
        return
    assert j_codec._native is None, "the port is the side that built it"
    monkeypatch.setenv("WQL_NATIVE_CODEC",
                       str(t_native_codec.resolve_lib_path()))
    encode = j_native_codec.load().encode
    monkeypatch.setattr(j_protocol, "serialize_message", encode)
    monkeypatch.setattr(j_codec, "serialize_message", encode)
    # the JAX PeerMap bound the name at its import: replies go out here
    monkeypatch.setattr(j_peers, "serialize_message", encode)
    monkeypatch.setitem(globals(), "j_ser", encode)


def _msg(sender, ents, world="w", parameter=None):
    return Message(instruction=Instruction.LOCAL_MESSAGE,
                   sender_uuid=sender, world_name=world,
                   parameter=parameter, entities=ents)


def _ent(eid, pos, world="w", vel=None):
    return Entity(uuid=eid, position=Vector3(*map(float, pos)),
                  world_name=world,
                  flex=vel_flex(vel) if vel is not None else None)


@pytest.mark.parametrize("delta_ticks", ["auto", "off"])
def test_twin_planes_match_through_churn(delta_ticks):
    rng = np.random.default_rng(42)
    twin = Twin(delta_ticks)
    peers = [uuid.UUID(int=0xA000 + i) for i in range(6)]
    worlds = ["alpha", "beta"]
    ids = {}
    # registrations: clustered so cubes hold several peers' entities
    for i in range(120):
        p = peers[i % len(peers)]
        eid = uuid.UUID(int=0xE0000 + i)
        ids[eid] = p
        pos = rng.uniform(-40, 40, 3)
        vel = rng.uniform(-30, 30, 3) if i % 3 == 0 else (0.0, 0.0, 0.0)
        twin.feed(_msg(p, [_ent(eid, pos, worlds[i % 2], vel)],
                       world=worlds[i % 2]))
    modes = [twin.tick()[0] for _ in range(3)]
    assert sum(twin.tick()[1] for _ in range(2)) > 0  # frames flowed

    # batched updates (columnar path) of a few entities: incremental
    # scatter of the device twin
    for step in range(4):
        some = list(ids)[step * 7: step * 7 + 7]
        for w in worlds:
            batch = [_ent(e, rng.uniform(-40, 40, 3), w)
                     for e in some if worlds[list(ids).index(e) % 2] == w]
            by_peer: dict = {}
            for ent in batch:
                by_peer.setdefault(ids[ent.uuid], []).append(ent)
            twin.feed(*(_msg(p, es, world=w) for p, es in by_peer.items()))
        modes.append(twin.tick()[0])
    assert twin.tp.h2d_scatter == twin.jp.h2d_scatter
    if delta_ticks == "off":  # delta sub-ticks ship their closure whole
        assert twin.tp.h2d_scatter > 0

    # removals, then slot reuse by fresh registrations
    gone = list(ids)[:15]
    for eid in gone:
        twin.feed(_msg(ids[eid], [Entity(uuid=eid)], parameter="entity.remove"))
        del ids[eid]
    modes.append(twin.tick()[0])
    for i in range(10):
        p = peers[i % len(peers)]
        eid = uuid.UUID(int=0xF0000 + i)
        ids[eid] = p
        twin.feed(_msg(p, [_ent(eid, rng.uniform(-20, 20, 3), "alpha",
                                rng.uniform(-10, 10, 3))], world="alpha"))
    assert twin.tp._free == twin.jp._free
    modes.append(twin.tick()[0])

    # growth past the 256-slot floor: a new capacity tier, full upload
    for i in range(200):
        p = peers[i % len(peers)]
        eid = uuid.UUID(int=0xD0000 + i)
        ids[eid] = p
        twin.feed(_msg(p, [_ent(eid, rng.uniform(-60, 60, 3), "beta")],
                       world="beta"))
    modes += [twin.tick()[0] for _ in range(3)]
    assert twin.tp._cap == 512
    assert twin.tp.h2d_full >= 2 and twin.tp.scatter_fallbacks == 0

    # a peer leaves: its entities and index rows go
    for plane, backend in ((twin.jp, twin.jb), (twin.tp, twin.tb)):
        backend.remove_peer(peers[0])
        plane.on_peer_removed(peers[0])
    modes += [twin.tick()[0] for _ in range(2)]
    if delta_ticks == "auto":
        assert {"delta", "full"} <= set(modes)
    else:
        assert set(modes) == {"full"}


def test_replay_ticks_match_when_the_world_is_static():
    """Delta ticks on a static world: pure replay after the first full
    tick, and the replayed frame bytes stay equal."""
    twin = Twin("auto", k=8)
    peers = [uuid.UUID(int=0xB000 + i) for i in range(3)]
    for i in range(30):
        twin.feed(_msg(peers[i % 3], [_ent(uuid.UUID(int=0xC000 + i),
                                           (i % 5, 1 + i % 3, 2))]))
    modes = [twin.tick()[0] for _ in range(4)]
    assert modes[0] == "full" and set(modes[1:]) == {"replay"}


def test_jitted_jax_tick_contracts_the_integration():
    """Pinned divergence of the reference on XLA:CPU: the jitted JAX
    tick computes ``pos + vel * dt`` as one fused multiply-add, so it
    disagrees with the two-rounding numpy replay in the last ulp; the
    eager JAX tick and the port agree with the replay bit for bit."""
    import jax
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(0)
    n = 4096
    pos = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    vel = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    world = np.zeros(n, np.int32)
    peer = np.arange(n, dtype=np.int32)
    replay = pos + vel * np.float32(0.05)
    fused = (pos.astype(np.float64)
             + vel.astype(np.float64) * np.float64(np.float32(0.05))
             ).astype(np.float32)
    js = jt.EntityState(*(jnp.asarray(a) for a in (pos, vel, world, peer)))
    fn = jt.make_tick_fn(cube_size=CUBE, k=4, dt=0.05)
    jitted = np.asarray(jax.jit(fn)(js)[0].position)
    eager = np.asarray(fn(js)[0].position)
    ts = tt.state_from_numpy(pos, vel, world, peer, device="cpu")
    port = tt.simulation_tick(ts, cube_size=CUBE, k=4, dt=0.05)[0]
    assert isinstance(port.position, torch.Tensor)
    np.testing.assert_array_equal(port.position.numpy(), replay)
    np.testing.assert_array_equal(eager, replay)
    np.testing.assert_array_equal(jitted, fused)
    assert (jitted != replay).any()
