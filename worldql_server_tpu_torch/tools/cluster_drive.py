"""Drive a cluster of the port end to end over real ZeroMQ.

``drive_cluster`` boots the router tier as ``python -m
worldql_server_tpu_torch --cluster-shards 2 --entity-sim ...`` builds it
(the same argv through ``build_parser``/``config_from_args`` into a
``ClusterRuntime`` in this process; the shards are ``python -m
worldql_server_tpu_torch --cluster-role shard`` processes), then:

1. reads each shard's ``/healthz``: its ``device`` block must name the
   device asked for, for the index and for the entity plane;
2. connects ZMQ peers through the router's public port, each homed on
   the shard that owns its world, and registers the entities (each peer
   owns entities of one world; the worlds split evenly over the shards)
   uniform in a cube of half-width ``spread``, a fraction of them moving;
3. serves ``min_ticks`` sim ticks on every shard, checks that the peers
   of every world receive ``entity.frame`` frames (counted, not
   decoded), and sends one LocalMessage per world whose recipients must
   equal those a single-process port server with the host index gives
   for the same subscriptions;
4. moves the first world of shard 0, which holds ``moved_share`` of the
   entities (each shard starts with half of them), to shard 1 with
   ``POST /reshard``
   while its sender keeps sending LocalMessages and records: the
   migration must finish; the target's import counts must equal the
   capsule the source exported; every LocalMessage sent across the move
   reaches each of its recipients exactly once; the moved world's peers
   receive entity frames from the target (they are homed on the source,
   so these frames ride the inter-shard ring, which the source drains
   4,096 records a tick: a world much larger than that loses most of its
   frames there, counted as ring drops); every record reads back; then
   ``min_ticks`` more ticks on every shard;
5. with ``move_back``, moves the world back and holds the capsule the
   target exports to the one the source exported (index rows sorted,
   entity rows by uuid: equal when the world's entities are static);
6. with ``move_large``, then moves shard 1's first world, which holds
   an even share (a quarter) of the entities, to shard 0 and serves
   ``min_ticks`` ticks there: both shards stay busy, and the world's
   frames cross the ring to its peers on shard 1, which drains 4,096
   records a tick of its own. It reports the ring's records sent,
   drained and dropped over that move and the frames the world's peers
   got after the flip, and holds only the migration's counts (a world
   larger than one drain backs up on the ring and, once it is full,
   drops there: a known fault of the cluster path);
7. reads the router's ``/healthz``, ``/debug/slo`` and ``/metrics``.

The kNN kernel's launches in each shard are read from the ``device``
block of its ``/healthz`` before the peers register and after the last
tick. Every check raises ``AssertionError``; the report is a dict.
Used by chip_smoke.py's cluster phase (on the card, up to config 3's width)
and by the tests (a few hundred entities on the CPU).
"""

from __future__ import annotations

import asyncio
import json
import socket
import time
import urllib.request
import uuid as uuid_mod

import numpy as np

from ..protocol import Instruction, Message, deserialize_message
from ..protocol import serialize_message
from ..protocol.types import Entity, Record, Vector3

#: LocalMessage probes go to explicit subscriptions at this cube, out of
#: reach of every entity (the plane keeps them inside +-entity_bounds)
FAR = (4000.0, 4000.0, 4000.0)
#: a neighbouring cube with subscriptions of its own, which a probe at
#: FAR must not reach
NEAR_FAR = (4064.0, 4000.0, 4000.0)
REC_POS = (5.0, 5.0, 5.0)
#: worlds of the drive: two a shard
N_WORLDS = 4
SEED = 20261017


def port_block(n: int, attempts: int = 64) -> int:
    """A base port with ``base..base+n`` all free (shard ports are
    ``base + 1 + i``)."""
    for _ in range(attempts):
        socks = []
        try:
            first = socket.socket()
            first.bind(("127.0.0.1", 0))
            base = first.getsockname()[1]
            socks.append(first)
            for off in range(1, n + 1):
                s = socket.socket()
                s.bind(("127.0.0.1", base + off))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port block")


def _http(port: int, path: str, *, as_json=True, body=None,
          timeout=120.0):
    headers = {"Accept": "application/json"} if as_json else {}
    data = None
    if body is not None:
        data = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        raw = resp.read()
        return resp.status, (json.loads(raw) if as_json else raw.decode())


async def http(port, path, **kw):
    return (await asyncio.to_thread(_http, port, path, **kw))[1]


class Peer:
    """A ZMQ wire peer: handshake through the router, then its frames
    go to the :class:`Reader` thread."""

    def __init__(self, actx, ctx, uuid: uuid_mod.UUID):
        import zmq

        self.uuid = uuid
        self.pull = ctx.socket(zmq.PULL)
        self.port = self.pull.bind_to_random_port("tcp://127.0.0.1")
        self.push = actx.socket(zmq.PUSH)
        self.push.setsockopt(zmq.LINGER, 0)
        self.frames = 0
        self.bytes = 0
        self.probes: list[str] = []
        self.replies: list[Message] = []

    async def connect(self, router_port: int, timeout=60.0) -> None:
        self.push.connect(f"tcp://127.0.0.1:{router_port}")
        await self.send(Message(instruction=Instruction.HANDSHAKE,
                                parameter=f"127.0.0.1:{self.port}"))
        if not await asyncio.to_thread(self.pull.poll, timeout * 1e3):
            raise AssertionError(f"no handshake echo in {timeout} s")
        echo = deserialize_message(self.pull.recv())
        if echo.instruction != Instruction.HANDSHAKE:
            raise AssertionError(f"no handshake echo: {echo}")

    async def send(self, message: Message) -> None:
        message.sender_uuid = self.uuid
        await self.push.send(serialize_message(message))

    def take(self, data: bytes) -> None:
        if b"entity.frame" in data:   # the bulk: count it only
            self.frames += 1
            self.bytes += len(data)
            return
        msg = deserialize_message(data)
        if msg.instruction == Instruction.RECORD_REPLY:
            self.replies.append(msg)
        elif (msg.instruction == Instruction.LOCAL_MESSAGE
              and (msg.parameter or "").startswith("probe:")):
            self.probes.append(msg.parameter)

    def close(self):
        self.push.close(linger=0)
        self.pull.close(linger=0)


class Reader:
    """One thread drains every peer's socket: a frame costs a few
    microseconds there, where an asyncio receive per frame would keep
    the event loop (which also runs the router) busy at config 3's
    ~100,000 frames a tick."""

    def __init__(self, peers: list[Peer]):
        import threading

        self.peers = peers
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="cluster-drive-reader")
        self.thread.start()

    def _run(self):
        import zmq

        poller = zmq.Poller()
        by_sock = {}
        for peer in self.peers:
            poller.register(peer.pull, zmq.POLLIN)
            by_sock[peer.pull] = peer
        while not self.stop.is_set():
            for sock, _ in poller.poll(100):
                peer = by_sock[sock]
                for _ in range(256):
                    try:
                        peer.take(sock.recv(zmq.NOBLOCK))
                    except zmq.Again:
                        break

    def close(self):
        self.stop.set()
        self.thread.join(10)


def _shape_delta(before, after) -> list[list[int]]:
    """``[N, K, launches]`` lists read before and after a run → the
    shapes launched in between, with their launches in the run."""
    seen = {(n, k): c for n, k, c in before}
    return [[n, k, c - seen.get((n, k), 0)] for n, k, c in after
            if c > seen.get((n, k), 0)]


async def _until(pred, what: str, timeout_s: float, interval=0.05):
    deadline = time.monotonic() + timeout_s
    while True:
        got = pred()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out ({timeout_s} s): {what}")
        await asyncio.sleep(interval)


def _layout(n_peers, world_map):
    """World names split evenly over the shards, and peer uuids homed on
    the shard that owns their world (peer i's world is i % N_WORLDS)."""
    per = N_WORLDS // world_map.n_shards
    worlds, load = [], {s: 0 for s in range(world_map.n_shards)}
    j = 0
    while len(worlds) < N_WORLDS:
        name = f"world{j}"
        j += 1
        s = world_map.shard_of_world(name)
        if load[s] < per:
            worlds.append(name)
            load[s] += 1
    worlds.sort(key=world_map.shard_of_world)
    peers, k = [], 0
    for i in range(n_peers):
        home = world_map.shard_of_world(worlds[i % N_WORLDS])
        while True:
            u = uuid_mod.UUID(int=(SEED << 32) + k)
            k += 1
            if world_map.shard_of_peer(u) == home:
                peers.append(u)
                break
    return worlds, peers


def _subscriptions(n_peers):
    """``[(peer index, world index, position)]`` of the explicit
    subscriptions, and the probe sender of each world."""
    subs = []
    for w in range(N_WORLDS):
        for i in range(n_peers):
            if (7 * i + 3 * w) % 4 == 0:
                subs.append((i, w, FAR))
            if (5 * i + w) % 3 == 0:
                subs.append((i, w, NEAR_FAR))
    senders = [(5 * w + 1) % n_peers for w in range(N_WORLDS)]
    return subs, senders


async def reference_recipients(peers, worlds, subs, senders):
    """The peers a probe LocalMessage at FAR reaches, per world, on a
    single-process port server over the host index (the same
    subscriptions, memory peers)."""
    from ..engine.config import Config
    from ..engine.peers import Peer as MemPeer
    from ..engine.server import WorldQLServer

    server = WorldQLServer(Config(
        store_url="memory://", ws_enabled=False, http_enabled=False,
        zmq_enabled=False, spatial_backend="cpu", tick_interval=0.0),
        device="cpu")
    await server.start()
    got: dict[str, set] = {w: set() for w in worlds}
    try:
        for u in peers:
            async def send_raw(data, u=u):
                msg = deserialize_message(data)
                if (msg.parameter or "").startswith("probe:"):
                    got[msg.world_name].add(u)
            await server.peer_map.insert(MemPeer(u, f"mem:{u.hex[:8]}",
                                                 send_raw, kind="memory"))
        for i, w, pos in subs:
            await server.router.handle_message(Message(
                instruction=Instruction.AREA_SUBSCRIBE, sender_uuid=peers[i],
                world_name=worlds[w], position=Vector3(*pos)))
        for w, s in enumerate(senders):
            await server.router.handle_message(Message(
                instruction=Instruction.LOCAL_MESSAGE, sender_uuid=peers[s],
                world_name=worlds[w], position=Vector3(*FAR),
                parameter=f"probe:{w}:ref"))
    finally:
        await server.stop()
    return got


async def drive_cluster(*, n_entities, n_peers=64,
                        moving=0.01, k=32, min_ticks=3, device="cuda",
                        spread=120.0, moved_share=0.25,
                        move_back=False, move_large=False,
                        extra_args=(),
                        tick_timeout_s=400.0, probe_timeout_s=120.0,
                        log=None):
    from ..__main__ import build_parser, config_from_args
    from ..cluster import ClusterRuntime

    import zmq
    import zmq.asyncio

    t_leg = time.perf_counter()
    stages: dict[str, float] = {}
    samples: list[list[dict]] = [[], []]

    def stage(name):
        """Mark the end of a stage: seconds since the leg began, and
        each shard's last sample, to ``log`` as it happens."""
        stages[name] = round(time.perf_counter() - t_leg, 3)
        if log is not None:
            last = [s[-1] if s else None for s in samples]
            log(f"cluster stage {name} at {stages[name]} s: "
                f"{json.dumps(last)}")

    base = port_block(2 * 2 + 1)
    http_port = base + 3
    args = build_parser().parse_args([
        "--cluster-shards", "2", "--spatial-backend", "cuda",
        "--entity-sim", "--entity-k", str(k), "--tick-interval", "0.05",
        "--slo", "on", "--no-ws", "--store-url", "memory://",
        "--http-host", "127.0.0.1", "--http-port", str(http_port),
        "--zmq-server-host", "127.0.0.1", "--zmq-server-port", str(base),
        *extra_args,
    ])
    config = config_from_args(args)
    config.validate()
    runtime = ClusterRuntime(config)
    t0 = time.perf_counter()
    await runtime.start()
    boot_s = time.perf_counter() - t0
    stage("boot")
    router = runtime.router
    shard_http = [http_port + 1 + i for i in range(2)]
    actx, ctx = zmq.asyncio.Context(), zmq.Context()
    peers: list[Peer] = []
    sampler = beats = reader = None
    try:
        launches0, shapes0 = [], []
        for i, port in enumerate(shard_http):
            dev = (await http(port, "/healthz")).get("device") or {}
            for part in ("index", "entity_plane"):
                if not str(dev.get(part)).startswith(device):
                    raise AssertionError(
                        f"shard {i} {part} on {dev.get(part)}, not {device}")
            launches0.append(dev["knn_launches"])
            shapes0.append(dev["knn_shapes"])

        # per-shard tick samples, read off the shard's own gauges
        async def sample():
            while True:
                for i, port in enumerate(shard_http):
                    g = (await http(port, "/metrics"))["gauges"]
                    es, tick = g["entity_sim"], g["tick"]
                    if not samples[i] or samples[i][-1]["applied"] != \
                            es["applied_ticks"]:
                        samples[i].append({
                            "applied": es["applied_ticks"],
                            "dispatches": es["dispatches"],
                            "entities": es["entities"],
                            "tick_ms": tick["last_tick_ms"],
                            "apply_ms": es["last_apply_ms"],
                            "t": time.perf_counter()})
                await asyncio.sleep(0.25)

        sampler = asyncio.ensure_future(sample())

        async def heartbeat():
            # ZMQ peers that fall silent for --zmq-timeout-secs are
            # evicted as stale, entities and all
            while True:
                for peer in peers:
                    await peer.send(Message(
                        instruction=Instruction.HEARTBEAT))
                await asyncio.sleep(1.0)

        def applied(i):
            return samples[i][-1]["applied"] if samples[i] else -1

        worlds, uuids = _layout(n_peers, router.world_map)
        subs, senders = _subscriptions(n_peers)
        t0 = time.perf_counter()
        for u in uuids:
            peer = Peer(actx, ctx, u)
            peers.append(peer)
            await peer.connect(config.zmq_server_port)
        reader = Reader(peers)
        for i, w, pos in subs:
            await peers[i].send(Message(
                instruction=Instruction.AREA_SUBSCRIBE,
                world_name=worlds[w], position=Vector3(*pos)))
        connect_s = time.perf_counter() - t0
        stage("connect")
        beats = asyncio.ensure_future(heartbeat())

        # entities: `moved_share` of them in the world that moves; each
        # shard starts with half of them, its worlds sharing that half
        # evenly, and each entity is owned round-robin by its world's
        # peers; `moving` of them with a velocity
        rng = np.random.default_rng(SEED)
        pos = rng.uniform(-spread, spread, (n_entities, 3))
        vel = rng.uniform(-20, 20, (n_entities, 3)).astype(np.float32)
        vel[rng.random(n_entities) >= moving] = 0.0
        owned: dict[int, list[int]] = {i: [] for i in range(n_peers)}
        world_peers = [list(range(w, n_peers, N_WORLDS))
                       for w in range(N_WORLDS)]
        per = N_WORLDS // 2
        share = np.array([0.5 / per] * N_WORLDS)
        share[0] = moved_share
        share[1:per] = (0.5 - moved_share) / max(per - 1, 1)
        ends = np.round(np.cumsum(share) / share.sum() * n_entities)
        for e in range(n_entities):
            w = int(np.searchsorted(ends, e, side="right"))
            j = e - (int(ends[w - 1]) if w else 0)
            owned[world_peers[w][j % len(world_peers[w])]].append(e)
        t0 = time.perf_counter()
        for i, ents in owned.items():
            world = worlds[i % N_WORLDS]
            for c0 in range(0, len(ents), 1024):
                await peers[i].send(Message(
                    instruction=Instruction.LOCAL_MESSAGE, world_name=world,
                    entities=[Entity(
                        uuid=uuid_mod.UUID(int=(1 << 100) + e),
                        position=Vector3(*map(float, pos[e])),
                        world_name=world, flex=vel[e].tobytes(),
                    ) for e in ents[c0:c0 + 1024]]))
        await _until(lambda: all(samples) and sum(
            s[-1]["entities"] for s in samples) == n_entities,
            "every entity registered", tick_timeout_s)
        register_s = time.perf_counter() - t0
        stage("register")

        # serve, then the frames of every world and the probes
        start = [applied(i) for i in range(2)]
        await _until(lambda: all(applied(i) - start[i] >= min_ticks
                                 for i in range(2)),
                     f"{min_ticks} ticks on each shard", tick_timeout_s)
        stage("ticks")
        world_frames = [sum(peers[i].frames for i in world_peers[w])
                        for w in range(N_WORLDS)]
        # the moved world's peers that get frames before the move
        # (a peer whose entities have no neighbour gets none)
        framed = {i for i in world_peers[0] if peers[i].frames}
        if min(world_frames) == 0:
            raise AssertionError(f"a world's peers got no entity frame: "
                                 f"{dict(zip(worlds, world_frames))}")
        want = await reference_recipients(uuids, worlds, subs, senders)
        expected = {w: {i for i, u in enumerate(uuids) if u in want[name]}
                    for w, name in enumerate(worlds)}
        for w, s in enumerate(senders):
            await peers[s].send(Message(
                instruction=Instruction.LOCAL_MESSAGE, world_name=worlds[w],
                position=Vector3(*FAR), parameter=f"probe:{w}:pre"))

        def probed(tag):
            return {i for i, p in enumerate(peers) if tag in p.probes}

        for w in range(N_WORLDS):
            await _until(lambda w=w: expected[w] <= probed(f"probe:{w}:pre"),
                         f"probe of {worlds[w]}", 120)
        await asyncio.sleep(1.0)
        for w in range(N_WORLDS):
            got = probed(f"probe:{w}:pre")
            if got != expected[w] or not got:
                raise AssertionError(
                    f"{worlds[w]}: probe reached {sorted(got)}, the "
                    f"single-process server {sorted(expected[w])}")
        stage("probes")

        # the live move, with traffic in the moved world throughout
        moved = worlds[0]
        src = router.world_map.shard_of_world(moved)
        dst = 1 - src
        sender = peers[senders[0]]

        tags: dict[uuid_mod.UUID, str] = {}

        async def create_records(n, tag):
            made = set()
            for j in range(n):
                rec = uuid_mod.uuid4()
                await sender.send(Message(
                    instruction=Instruction.RECORD_CREATE, world_name=moved,
                    records=[Record(uuid=rec, position=Vector3(*REC_POS),
                                    world_name=moved, data=f"{tag}{j}")]))
                made.add(rec)
                tags[rec] = tag
            return made

        records = await create_records(10, "pre")
        sent: list[str] = []
        stop = asyncio.Event()

        async def traffic():
            while not stop.is_set():
                tag = f"probe:0:mid:{len(sent)}"
                await sender.send(Message(
                    instruction=Instruction.LOCAL_MESSAGE, world_name=moved,
                    position=Vector3(*FAR), parameter=tag))
                sent.append(tag)
                if len(sent) % 4 == 0:
                    records.update(await create_records(1, "mid"))
                await asyncio.sleep(0.05)

        async def move(world, target):
            t0 = time.perf_counter()
            status, body = await asyncio.to_thread(
                _http, http_port, "/reshard",
                body={"world": world, "target": target})
            if status != 202:
                raise AssertionError(f"/reshard answered {status}: {body}")
            await _until(lambda: router.migration is not None
                         and router.migration.state in ("done", "aborted"),
                         f"migration of {world}", 300, interval=0.1)
            mig = router.migration
            if mig.state != "done":
                raise AssertionError(f"migration: {mig.describe()}")
            counts = {key: len(mig.capsule[key]) for key in
                      ("records", "subs", "entities", "sessions")}
            for key in ("subs", "entities"):
                if mig.import_counts[key] != counts[key]:
                    raise AssertionError(
                        f"imported {mig.import_counts} of exported {counts}")
            return mig, {"wall_s": time.perf_counter() - t0,
                         "exported": counts, "imported": mig.import_counts,
                         **mig.describe()}

        async def ring_counts():
            return [(await http(port, "/metrics"))["gauges"]
                    ["cluster_shard"] for port in shard_http]

        async def move_world_larger_than_a_drain():
            world = worlds[per]
            at = router.world_map.shard_of_world(world)
            to = 1 - at
            ring0 = await ring_counts()
            marks = {i: peers[i].frames for i in world_peers[per]}
            _, report = await move(world, to)
            flip = applied(to)
            await _until(lambda: applied(to) > flip, "a target tick", 120)
            framed_at = {i: peers[i].frames for i in marks}
            first = applied(to)
            await _until(lambda: applied(to) - first >= min_ticks,
                         f"{min_ticks} ticks after the second move",
                         tick_timeout_s)
            stage("second move")
            ring1 = await ring_counts()
            return {
                "world": world, "source": at, "target": to,
                "entities": report["exported"]["entities"],
                "migration": report,
                "target_ticks": applied(to) - first,
                "frames_before_flip": sum(
                    framed_at[i] - marks[i] for i in marks),
                "frames_after_flip": sum(
                    peers[i].frames - framed_at[i] for i in marks),
                "ring": [{key: r1[key] - r0[key] for key in
                          ("sent", "dropped", "drained")}
                         for r0, r1 in zip(ring0, ring1)],
            }

        mover = asyncio.ensure_future(traffic())
        try:
            mig, migration = await move(moved, dst)
        finally:
            stop.set()
            await mover
        capsule = mig.capsule
        stage("migration")
        if router.world_map.shard_of_world(moved) != dst:
            raise AssertionError("placement did not flip")

        # frames from the target: count from its first tick after the
        # flip, then serve min_ticks more on every shard
        flip = applied(dst)
        await _until(lambda: applied(dst) > flip, "a target tick", 120)
        marks = {i: peers[i].frames for i in world_peers[0]}
        start = [applied(i) for i in range(2)]
        records |= await create_records(3, "post")
        for j in range(3):
            tag = f"probe:0:post:{j}"
            await sender.send(Message(
                instruction=Instruction.LOCAL_MESSAGE, world_name=moved,
                position=Vector3(*FAR), parameter=tag))
            sent.append(tag)
        await _until(lambda: all(applied(i) - start[i] >= min_ticks
                                 for i in range(2)),
                     f"{min_ticks} ticks after the move", tick_timeout_s)
        stage("ticks after the move")
        after = {i: peers[i].frames - marks[i] for i in world_peers[0]}
        if not framed or any(after[i] == 0 for i in framed):
            raise AssertionError(f"moved world's peers after the flip: "
                                 f"{after} (framed before: {framed})")
        try:
            await _until(lambda: all(set(sent) <= set(peers[i].probes)
                                     for i in expected[0]),
                         "every LocalMessage sent across the move",
                         probe_timeout_s)
        except AssertionError:
            pass   # reported with what is missing below
        lost = {}
        for i in expected[0]:
            got = sorted(p for p in peers[i].probes if p in set(sent))
            if got != sorted(sent):   # each exactly once
                lost[i] = sorted(set(sent) - set(got))[:8] + [
                    f"{len(got)} of {len(sent)}"]
        if lost:
            raise AssertionError(
                f"LocalMessages lost or doubled: {lost}; migration "
                f"{migration}")
        stage("LocalMessages across the move")
        seen: set = set()

        async def read_back():
            n = len(sender.replies)
            await sender.send(Message(
                instruction=Instruction.RECORD_READ, world_name=moved,
                position=Vector3(*REC_POS)))
            await _until(lambda: len(sender.replies) > n, "record reply", 60)
            for reply in sender.replies[n:]:
                seen.update(r.uuid for r in reply.records)
            return records <= seen

        for _ in range(5):   # a read waits out up to one tick
            if await read_back():
                break
        if not records <= seen:
            lost = {}
            for rec in records - seen:
                lost[tags[rec]] = lost.get(tags[rec], 0) + 1
            raise AssertionError(
                f"{len(records - seen)} of {len(records)} records lost "
                f"{lost}; migration {migration}")
        stage("records read back")

        back = None
        if move_back:
            mig2, back = await move(moved, src)
            key = (lambda row: row["uuid"])
            if sorted(mig2.capsule["subs"]) != sorted(capsule["subs"]):
                raise AssertionError("index rows changed across the move")
            if sorted(mig2.capsule["entities"], key=key) != \
                    sorted(capsule["entities"], key=key):
                raise AssertionError("entity rows changed across the move")

        large = None
        if move_large:
            large = await move_world_larger_than_a_drain()

        launches, shapes, rings = [], [], []
        for port in shard_http:
            dev = (await http(port, "/healthz"))["device"]
            launches.append(dev["knn_launches"])
            shapes.append(dev["knn_shapes"])
            rings.append((await http(port, "/metrics"))["gauges"]
                         ["cluster_shard"])
        router_health = await http(http_port, "/healthz")
        router_slo = await http(http_port, "/debug/slo")
        router_metrics = await http(http_port, "/metrics", as_json=False)
    finally:
        for task in (sampler, beats):
            if task is not None:
                task.cancel()
        if reader is not None:
            reader.close()
        for p in peers:
            p.close()
        actx.term()
        ctx.term()
        await runtime.stop()

    def pct(vals, q):
        vals = sorted(vals)
        return vals[min(len(vals) - 1, int(q * len(vals)))] if vals else None

    shards = []
    for i in range(2):
        ticks = [s for s in samples[i] if s["applied"] > 0]
        shards.append({
            "sim_ticks": samples[i][-1]["applied"] - samples[i][0]["applied"],
            "dispatched":
                samples[i][-1]["dispatches"] - samples[i][0]["dispatches"],
            # counted by the kernel's wrapper where it launches, so 0
            # when the shards serve on the CPU
            "knn_launches": launches[i] - launches0[i],
            # the same launches by [N, K, count]: the shapes to hold the
            # kernel to its plain version at
            "knn_shapes": _shape_delta(shapes0[i], shapes[i]),
            "tick_ms_p50": pct([s["tick_ms"] for s in ticks], 0.5),
            "tick_ms_p99": pct([s["tick_ms"] for s in ticks], 0.99),
            "apply_ms_p50": pct([s["apply_ms"] for s in ticks], 0.5),
            "entities_end": samples[i][-1]["entities"],
            # inter-shard ring records sent, dropped on a full ring, drained
            "ring": {key: rings[i][key] for key in
                     ("sent", "dropped", "drained", "xshard_frames")},
        })
        if device == "cuda" and shards[i]["knn_launches"] <= 0:
            raise AssertionError(f"shard {i} launched no kNN: {shards[i]}")
    return {
        "entities": n_entities, "peers": n_peers, "worlds": worlds,
        "moved": moved, "source": src, "target": dst,
        "boot_s": boot_s, "connect_s": connect_s, "register_s": register_s,
        "shards": shards, "migration": migration, "move_back": back,
        "move_large": large,
        "world_frames": dict(zip(worlds, world_frames)),
        "frames": sum(p.frames for p in peers),
        "bytes": sum(p.bytes for p in peers),
        "moved_world_frames_after_flip": sum(after.values()),
        "probes_across_move": len(sent), "records": len(records),
        "probe_recipients": {worlds[w]: len(expected[w])
                             for w in range(N_WORLDS)},
        "router_healthz": router_health, "router_slo": router_slo,
        "router_metrics": router_metrics,
        "stages": stages,
        "leg_s": time.perf_counter() - t_leg,
    }
