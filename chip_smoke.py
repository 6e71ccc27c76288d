#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``worldql_server_tpu_torch``).

Run from the repository root on a host with one NVIDIA card:

    python3 chip_smoke.py

The port builds its native codec library (``build/native/``, from the
``native/`` sources) with ``make`` when it is missing, at its first
import of ``protocol``; this script builds every
CUDA kernel of the port from ``worldql_server_tpu_torch/csrc/`` with
``nvcc``, then:

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the kernels, all sources in parallel, and prints ptxas's
   ``-Xptxas -v`` lines (registers, spills, shared memory) per kernel;
3. holds each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it — the stencil kNN at N=131,072,
   K=32 (BASELINE config 3 at the entity plane's pow2 tier) and at
   N=1,048,576, K=8 (config 5 at the server's default k) — bit for bit,
   names the kernel each K launches, and times kernel and plain version
   with CUDA events (cold, clean L2) beside the kernel's bound;
4. runs three chained ``simulation_tick``s on the card and on the CPU at
   the same sizes: positions, velocities, targets and counts bit-equal;
5. runs every op of the device subscription index (``ops/index.py``,
   K1–K6) on the card and on the CPU at the index's full width —
   1,048,576 rows of the BASELINE config-5 Zipf crowd, 16,384 queries —
   bit-equal, and times each on the card; then the query library's
   stencil kernels (K10 ``queries/knn.py``, K11 ``queries/geometry.py``)
   at 4,096 rows x the 343-cube stencil, card == CPU bit for bit;
6. fan-out at config 5 on ``CudaSpatialBackend``: bulk load, compaction
   drained, the boot tier walk, 24 pipelined ticks of 16,384 staged
   queries collected on a worker thread as the ticker collects them
   (sampled ticks equal to the port's cpu index), the tick p50/p99 and
   its encode/h2d/compute/d2h split; then ``save_snapshot`` of the live
   index (1,048,576 subscriptions) and ``load_snapshot`` into a fresh
   ``CudaSpatialBackend`` on the card — equal row sets and one staged
   batch's fan-out equal, save and restore seconds and the file's bytes;
   then 5 more ticks under ``torch.profiler``, printing the top device
   ops with their counts;
   then the mesh index (``parallel/``, ``--spatial-backend sharded``) at
   BASELINE config 4's full width: 640,000 subscriptions in 64 worlds,
   30 pipelined ticks of 16,384 staged queries on
   ``ShardedCudaSpatialBackend`` over the virtual meshes (1,4) and (2,2)
   of the card, every tick's fan-out equal lane for lane to the
   single-card index's (sampled ticks to the cpu index's), a churn
   folded on the device with no re-upload and a forced imbalance
   re-sharded through one, each K12 program timed beside the
   single-card index; an entity-sim server on a 2 x 2 mesh (10,000
   entities, k=32, K7 launched); the CLI's 1 x 1 mesh boot and its
   config error for a mesh larger than the card; two gloo ranks on the
   one card held to the one-process mesh;
   then the query library at BASELINE config 12: 1,000,000 subscriptions
   in 4 worlds, pure cone / raycast / knn / density batches of 4,096
   queries, the mixed batch and a pure-radius one, p50/p99 wall and
   probe rows per batch, sampled lanes equal to the cpu index;
7. config-2 churn: 10,000 random-walk clients, 50 ticks of bulk
   remove + add, flush and ``match_arrays_async`` — fan-out equal to the
   cpu index's every tick; then the same clients through
   ``ResilientBackend(CudaSpatialBackend)`` for 12 ticks with
   ``backend.dispatch`` and ``backend.collect`` failpoints fired:
   containment, rebuilds onto the card, then the failover to the CPU
   mirror, fan-out equal to the cpu index's every tick;
8. LocalMessage through the server as a bare ``python -m
   worldql_server_tpu_torch`` boots it on a card (cuda index, 0.05 s
   tick, staged dispatch): the 10,000 config-2 clients join with
   in-memory sinks, subscribe through the router and send one
   LocalMessage each a tick for 10 ticks; frames per peer per tick equal
   what the cpu index resolves; then one query of each kind, whose
   reply frames equal a cpu-index server's byte for byte; then a second
   pass of the same clients (5 ticks, joined without announcements)
   with ``--overload on --session-ttl 30`` and an explicit tick budget
   and batch tier: fan-out equal to the cpu index every tick through
   the governor's pump path, the governor ``ok`` with zero sheds, and
   ``overload_status()`` / ``sessions_status()`` printed;
9. drives the entity-sim main path: ``Config`` → ``WorldQLServer`` as
   ``python -m worldql_server_tpu_torch --entity-sim`` builds them on a
   card (the cuda index, the plane on the same card), 64 peers with
   in-memory sinks register 100,000 entities with velocities in 4
   worlds through the router / ``ColumnarIngest`` path, and the ticker
   serves sim ticks at k=32 with every kernel's launch counter reset
   just before and read just after each run — one boot and join serves
   at least 3 ticks with 1% moving (delta ticks at pow2 sub-tiers),
   then, once the other 99% are re-sent with their velocities, at least
   3 with every entity moving (full ticks); a second boot serves at
   least 5 with 1% moving through
   ``--interest on --delivery-workers 2``: the 64 peers are adopted by
   the sender workers over socketpairs (the card host has no
   ``websockets``), a reader thread splits the WebSocket
   frames, and every peer's frames replayed through ``ReplayClient``
   refuse no delta, see no gap and equal the server's ledger, with no
   frame dropped at a ring; sampled frames are decoded and checked, and
   bytes per tick are printed beside the interest-off 1%-moving run's;
10. drives the cluster tier (``tools/cluster_drive.py``): the router of
    ``python -m worldql_server_tpu_torch --cluster-shards 2
    --spatial-backend cuda --entity-sim --entity-k 32 --slo on --no-ws``
    with a ``memory://`` store, its two shard processes on the card
    (each shard's ``/healthz`` must name cuda for its index and its
    plane); 64 ZMQ peers through the router hold 60,000 entities (config
    3 cut from 100,000 for time) in 4 worlds, two worlds and 30,000
    entities a shard, 1% moving; at least 3 sim ticks a shard, entity
    frames to the peers of every world, and one LocalMessage a world
    whose recipients equal a single-process host index server's; then
    ``POST /reshard`` moves a world (3,000 entities) between the shards
    with LocalMessages and records in flight: the target imports what
    the source exported, every LocalMessage reaches each recipient
    once, every record reads back, the moved world's peers get frames
    from the target, then 3 more ticks a shard; then a world of shard 1
    (15,000 entities, config 3's even share at this depth, more than
    the inter-shard ring drains a tick) moves to shard 0: its import
    counts held, the ring's records sent, drained and dropped over that
    move printed; the router's ``/healthz``,
    ``/debug/slo`` and ``/metrics`` (strict-parsed) last. K7's launches
    in the shards, in all and by shape, are read off their ``/healthz``;
11. runs the eleven scenarios of the port's adversarial catalog
    (``worldql_server_tpu_torch/scenarios``) at ``--shape full`` through
    ``run_scenario``, each on a server of its own over real ZeroMQ: the
    five on the device index must name cuda for it (and the three with
    the entity plane, for the plane, with K7 launched), and every check
    of every scenario must hold; after ``battle_royale``'s churn
    (compaction threshold 8: folds and delta resorts on the card) the
    index's device segments must equal its host mirror; each scenario's
    wall, checks and SLO values are printed;
12. holds K7 to its plain version, bit for bit, at every ``(N, K)`` the
    driven paths of 6, 9, 10 and 11 launched it at (warm-up, capacity and
    delta sub-tiers, in this process and in the shards);
13. prints one ``{"kernels": [...]}`` JSON line, the card line, and as
    the last line ``{"ok": true, "device": {...}}``.

Every phase raises on failure; nothing is caught. Without a CUDA card,
or without the port beside this file, it exits non-zero and prints no
result. It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import asyncio
import json
import os
import statistics
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016


def phase(name):
    def wrap(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            print(f"== phase {name}", flush=True)
            out = fn(*args, **kwargs)
            print(f"== phase {name}: {time.perf_counter() - t0:.3f} s",
                  flush=True)
            return out
        return run
    return wrap


@phase("card")
def phase_card(torch):
    from worldql_server_tpu_torch.tools.knn_bench import card_line

    line = card_line()
    print(f"nvidia-smi: {line}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return line


def build_native_codec():
    """The wire codec's native library: the port builds it from
    ``native/`` into ``build/native/`` at its first import of
    ``protocol`` when it is missing
    (``protocol/native_codec.py::ensure_built``). Without it the codec
    would need the ``flatbuffers`` package, which the card host does
    not have, so a codec that did not load fails the run."""
    t0 = time.perf_counter()
    built = os.path.exists(os.path.join(REPO, "build", "native",
                                        "libwqlcodec.so"))
    from worldql_server_tpu_torch.protocol import codec

    if codec._native is None:
        raise AssertionError("the native codec library did not build or "
                             "load")
    if not built:
        print(f"native codec built in {time.perf_counter() - t0:.2f} s")


@phase("build")
def phase_build():
    from worldql_server_tpu_torch.ops import build

    sources = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                     if f.endswith(".cu"))
    # one nvcc per source, all started together (build() compiles
    # once per source hash; load() then finds the library)
    from concurrent.futures import ThreadPoolExecutor

    t1 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.build, sources))
    for name in sources:
        build.load(name)
    print(f"kernels {sources} built in {time.perf_counter() - t1:.2f} s "
          f"(per source: {build.build_seconds})")
    for name in sources:
        for fn, rep in build.ptxas_report(build.library_path(name)).items():
            print(f"ptxas {name} {fn}: " + " | ".join(rep["lines"]))
    return sources


def _knn_rows(torch, rates, shapes):
    """K7 against its plain version on the card at each ``(N, K)`` of
    ``shapes``, bit for bit, on Zipf-skewed runs made from the seed;
    then both timed beside the kernel's bound. One row a shape."""
    from worldql_server_tpu_torch.ops.knn import (
        kernel_info, knn_select, knn_select_plain)
    from worldql_server_tpu_torch.tools.knn_bench import (
        ITERS, cuda_time_ms, knn_bound, zipf_world)

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    rows = []
    for n, k in shapes:
        rid, peer, pos = (torch.from_numpy(a).cuda()
                          for a in zipf_world(n, k, SEED + n))
        got = knn_select(rid, peer, pos, k=k)
        want = knn_select_plain(rid, peer, pos, k=k)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64))
                  .abs().max())
        if not torch.equal(got, want):
            raise AssertionError(
                f"knn kernel != plain at N={n} K={k}: "
                f"{int((got != want).sum())} lanes differ")
        print(f"knn N={n} K={k}: kernel == plain version (tolerance: "
              "exact, every lane)")
        info = kernel_info(k)
        print(f"knn K={k} launches {info['kernel']}: {info['regs']} "
              f"registers, {info['spill_bytes']} bytes spilled, "
              f"{info['local_bytes']} bytes local, {info['smem_bytes']} "
              "bytes shared a block; ptxas: " + " | ".join(info["ptxas"]))
        ms = cuda_time_ms(lambda: knn_select(rid, peer, pos, k=k), ITERS,
                          flush)
        plain_ms = cuda_time_ms(
            lambda: knn_select_plain(rid, peer, pos, k=k), 5, flush)
        bound = knn_bound(rid, peer, k, rates)
        print(f"knn N={n} K={k} bound: bytes {bound['bytes_ms']:.5f} ms, "
              f"f32 {bound['f32_ms']:.5f} ms, integer compares "
              f"{bound['int_ms']:.5f} ms -> {bound['bound_by']}")
        row = {"n": n, "k": k, "ms": ms, "plain_ms": plain_ms, **bound,
               "max_abs_err": err, "targets_kept": int((got >= 0).sum()),
               **{key: info[key] for key in (
                   "kernel", "regs", "spill_bytes", "local_bytes",
                   "smem_bytes")}}
        print("knn", json.dumps(row), flush=True)
        rows.append(row)
    return rows


@phase("knn kernel vs plain")
def phase_knn(torch, rates):
    from worldql_server_tpu_torch.tools.knn_bench import SHAPES

    return _knn_rows(torch, rates, SHAPES)


@phase("knn kernel vs plain at the paths' shapes")
def phase_knn_paths(torch, rates, by_path):
    """K7 held to its plain version at every ``(N, K)`` the driven
    paths launched it at — warm-up tiers, capacity tiers and the delta
    sub-tiers, in this process and in the cluster's shards (each
    wrapper counts its launches by shape, read just after each path) —
    beyond the two shapes of ``phase_knn``. ``by_path`` maps a path to
    its ``[N, K, launches]`` lists."""
    launched: dict = {}
    for path, shapes in by_path.items():
        for n, k, c in shapes:
            launched.setdefault((n, k), {})[path] = c
    print("knn shapes launched by path: " + json.dumps(
        [[n, k, paths] for (n, k), paths in sorted(launched.items())]))
    if not launched:
        raise AssertionError(f"no kNN shape launched: {by_path}")
    rows = _knn_rows(torch, rates, sorted(launched))
    for row in rows:
        row["launches_by_path"] = launched[(row["n"], row["k"])]
    return rows


@phase("simulation_tick cuda vs cpu")
def phase_tick(torch):
    from worldql_server_tpu_torch.ops import tick as tt
    from worldql_server_tpu_torch.tools.knn_bench import SHAPES, cuda_time_ms

    out = []
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for n, k in SHAPES:
        rng = np.random.default_rng(SEED + 7 * n)
        pos = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
        pos[: n // 16] += np.float32(990.0)  # bounce off +bounds
        vel = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
        world = rng.integers(0, 4, n).astype(np.int32)
        peer = rng.integers(0, 4096, n).astype(np.int32)
        gs = tt.state_from_numpy(pos, vel, world, peer, "cuda")
        cs = tt.state_from_numpy(pos, vel, world, peer, "cpu")
        overfull = 0
        for step in range(3):
            gs, gt, gc = tt.simulation_tick(gs, cube_size=16, k=k)
            cs, ct, cc = tt.simulation_tick(cs, cube_size=16, k=k)
            for name, a, b in (("position", gs.position, cs.position),
                               ("velocity", gs.velocity, cs.velocity),
                               ("targets", gt, ct), ("counts", gc, cc)):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(
                        f"tick {step} {name} differs cuda vs cpu at "
                        f"N={n} K={k}")
            overfull += int((cc > max(k, 2)).sum())
        state = tt.state_from_numpy(pos, vel, world, peer, "cuda")
        tick_ms = cuda_time_ms(
            lambda: tt.simulation_tick(state, cube_size=16, k=k), 10, flush)
        row = {"n": n, "k": k, "tick_ms": tick_ms,
               "overfull_rows": overfull}
        print("tick", json.dumps(row), flush=True)
        out.append(row)
    return out


class AdoptedPeers:
    """In-memory peers whose frames go through the delivery plane's
    sender workers, as a WebSocket peer's do: each peer's write half is
    one end of a ``socket.socketpair()`` handed to a worker with
    ``DeliveryPlane.adopt(peer, fd=...)`` (the card host has neither
    ``websockets`` nor ``pyzmq``), and a reader thread drains the other
    ends and splits the WebSocket binary frames back into payloads."""

    def __init__(self):
        import selectors
        import threading

        self.frames: dict = {}
        self.bytes = 0
        self._bufs: dict = {}
        self._sel = selectors.DefaultSelector()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="adopted-peers-reader")

    async def insert(self, server, peer_uuid):
        import socket

        from worldql_server_tpu_torch.engine.peers import Peer

        async def unbound(data):
            raise AssertionError("an adopted peer wrote in-process")

        ours, theirs = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
        for sock in (ours, theirs):
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4 << 20)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
        peer = Peer(peer_uuid, f"pair:{peer_uuid.hex[:8]}", unbound,
                    kind="websocket")
        if not server.delivery_plane.adopt(peer, fd=theirs.fileno()):
            raise AssertionError("no live delivery worker adopted a peer")
        theirs.close()  # the worker holds its own copy of the fd
        ours.setblocking(False)
        with self._lock:
            self.frames[peer_uuid] = []
            self._bufs[peer_uuid] = bytearray()
            self._sel.register(ours, 1, peer_uuid)  # EVENT_READ
        await server.peer_map.insert(peer)

    def start(self):
        self._thread.start()

    def _split(self, peer):
        buf = self._bufs[peer]
        out = self.frames[peer]
        while len(buf) >= 2:
            n, head = buf[1] & 0x7F, 2
            if n == 126:
                if len(buf) < 4:
                    break
                n, head = int.from_bytes(buf[2:4], "big"), 4
            elif n == 127:
                if len(buf) < 10:
                    break
                n, head = int.from_bytes(buf[2:10], "big"), 10
            if buf[0] != 0x82:
                raise AssertionError(f"not a WS binary frame: {buf[0]:#x}")
            if len(buf) < head + n:
                break
            out.append(bytes(buf[head:head + n]))
            del buf[:head + n]

    def _run(self):
        while True:
            with self._lock:
                if not self._sel.get_map():
                    return
            events = self._sel.select(timeout=0.1)
            if not events and self._stop.is_set():
                return
            for key, _ in events:
                try:
                    data = key.fileobj.recv(1 << 20)
                except BlockingIOError:
                    continue
                with self._lock:
                    if not data:  # the worker closed its end
                        self._sel.unregister(key.fileobj)
                        key.fileobj.close()
                        continue
                    self.bytes += len(data)
                    self._bufs[key.data] += data
                    self._split(key.data)

    def join(self, timeout):
        """Wait until every worker end closed (the workers flush their
        rings and exit at the server's stop), then stop reading."""
        self._thread.join(timeout)
        self._stop.set()
        self._thread.join(5)
        if self._thread.is_alive():
            raise AssertionError("the adopted peers' reader did not end")
        leftover = {p: len(b) for p, b in self._bufs.items() if b}
        if leftover:
            raise AssertionError(f"torn WS frames left over: {leftover}")


def _replay_interest(server, adopted, peers):
    """Each adopted peer's frames through the port's ReplayClient,
    held against the server's ledger for that peer."""
    import uuid

    from worldql_server_tpu_torch.interest import ReplayClient

    mgr = server.interest
    plane = server.entity_plane
    totals = {"frames": 0, "fulls": 0, "deltas": 0, "entities": 0}
    for p in peers:
        rc = ReplayClient()
        for frame in adopted.frames[p]:
            rc.apply(frame)
        ledger: dict = {}
        st = mgr._peers.get(p)
        for key, (wid, pos_b) in (st.state.items() if st else ()):
            x, y, z = np.frombuffer(pos_b, np.float32)
            ledger.setdefault(plane._world_names[wid], {})[
                uuid.UUID(bytes=key)] = (float(x), float(y), float(z))
        s = rc.stats()
        if s["deltas_refused"] or s["gaps_seen"]:
            raise AssertionError(f"peer {p}: replay refused deltas or saw "
                                 f"gaps: {s}")
        if rc.snapshot() != ledger:
            raise AssertionError(
                f"peer {p}: replayed state ({s['entities']} entities) != "
                f"the server's ledger ({sum(map(len, ledger.values()))})")
        totals["frames"] += s["frames_applied"]
        totals["fulls"] += s["fulls_applied"]
        totals["deltas"] += s["deltas_applied"]
        totals["entities"] += s["entities"]
    return totals


async def drive_server(torch, n_entities=100_000, n_peers=64, n_worlds=4,
                       mixes=((1.0, 10),), device=None, extra_args=(),
                       adopt=False, mesh_devices=None):
    """The entity-sim server at config 3's width, serving each
    ``(moving, min_ticks)`` of ``mixes`` in turn from one boot and one
    join. The entities register with the first mix's velocities; each
    later mix re-sends, through the same ingest path, every entity
    whose velocity changes, at its join position (the movers of one
    mix stay movers in the next, so the mixes go from fewer movers to
    more, and a re-sent entity has not moved). K7's launch counts are
    set to 0 before the boot for the first mix and before the re-send
    for each later one, and read just after the mix's last tick. With
    ``adopt``, the peers' frames go through the delivery plane's sender
    workers over socketpairs (``extra_args`` must ask for
    ``--delivery-workers``). ``extra_args`` may name the index
    (``--spatial-backend sharded`` with ``--mesh-*``: then the mesh is
    built over ``mesh_devices``). Returns ``(report, launches)`` a
    mix."""
    import uuid

    from worldql_server_tpu_torch.__main__ import (
        build_parser, config_from_args)
    from worldql_server_tpu_torch.engine.config import (
        apply_device_boot_defaults)
    from worldql_server_tpu_torch.engine.peers import Peer
    from worldql_server_tpu_torch.engine.server import WorldQLServer
    from worldql_server_tpu_torch.ops.knn import knn_select
    from worldql_server_tpu_torch.protocol import (
        Instruction, Message, deserialize_message, serialize_message)
    from worldql_server_tpu_torch.protocol.types import Entity, Vector3

    movings = [m for m, _ in mixes]
    if movings != sorted(movings) or (adopt and len(mixes) > 1):
        raise ValueError(f"mixes go from fewer movers to more: {mixes}")
    args = build_parser().parse_args([
        "--entity-sim", "--entity-k", "32", "--entity-max", "131072",
        "--tick-interval", "0.05", "--store-url", "memory://",
        "--no-ws", "--no-http", "--no-zmq", *extra_args,
    ])
    config = config_from_args(args)
    apply_device_boot_defaults(
        config, backend_explicit="--spatial-backend" in extra_args,
        interval_explicit=True)
    config.validate()

    knn_select.launches = 0  # the first mix's run starts here
    knn_select.shapes = {}
    t_boot = time.perf_counter()
    server = WorldQLServer(config, device=device, mesh_devices=mesh_devices)
    plane = server.entity_plane
    if (config.spatial_backend not in ("cuda", "sharded")
            or server.backend.device != plane.device):
        raise AssertionError(
            f"entity sim over {config.spatial_backend} on "
            f"{getattr(server.backend, 'device', 'host')}, plane on "
            f"{plane.device}")
    await server.start()
    boot_s = time.perf_counter() - t_boot
    sunk = {"frames": 0, "bytes": 0}
    sample: list[bytes] = []

    def sink_many(framed):
        sunk["frames"] += len(framed)
        sunk["bytes"] += sum(len(f.payload) for f in framed)
        if len(sample) < 64:
            sample.extend(f.payload for f in framed[:4])
        return True

    async def send_raw(data):
        sunk["frames"] += 1
        sunk["bytes"] += len(data)

    peers = [uuid.UUID(int=(SEED << 32) + i) for i in range(n_peers)]
    adopted = None
    if adopt:
        adopted = AdoptedPeers()
        for p in peers:
            await adopted.insert(server, p)
        adopted.start()
    else:
        for p in peers:
            await server.peer_map.insert(Peer(
                p, f"mem:{p.hex[:8]}", send_raw, kind="memory",
                try_write=lambda f: sink_many([f]), try_write_many=sink_many,
            ))

    rng = np.random.default_rng(SEED)
    pos = rng.uniform(-120, 120, (n_entities, 3))
    vel_all = rng.uniform(-20, 20, (n_entities, 3)).astype(np.float32)
    draw = rng.random(n_entities)
    worlds = [f"world{w}" for w in range(n_worlds)]

    def messages(vel, which):
        """The entities of ``which`` at their join positions with
        velocities ``vel``, each peer's in each world in chunks of
        1,024."""
        datas = []
        for pi, p in enumerate(peers):
            for wi, w in enumerate(worlds):
                idx = np.arange(pi * n_worlds + wi, n_entities,
                                n_peers * n_worlds)
                idx = idx[which[idx]]
                for c0 in range(0, idx.size, 1024):
                    chunk = idx[c0:c0 + 1024]
                    datas.append(serialize_message(Message(
                        instruction=Instruction.LOCAL_MESSAGE,
                        sender_uuid=p, world_name=w,
                        entities=[Entity(
                            uuid=uuid.UUID(int=(1 << 100) + int(i)),
                            position=Vector3(*map(float, pos[i])),
                            world_name=w, flex=vel[i].tobytes(),
                        ) for i in chunk],
                    )))
        return datas

    async def slow_route(data):
        await server.router.handle_message(deserialize_message(data))

    async def ingest(datas):
        t0 = time.perf_counter()
        for c0 in range(0, len(datas), 64):
            await server.entity_ingest.process_batch(datas[c0:c0 + 64],
                                                     slow_route)
            await asyncio.sleep(0)
        return time.perf_counter() - t0

    registered = {(1 << 100) + i for i in range(n_entities)}
    out = []
    vel_prev = None
    for mi, (moving, min_ticks) in enumerate(mixes):
        vel = np.where((draw < moving)[:, None], vel_all,
                       np.float32(0.0)).astype(np.float32)
        if vel_prev is None:
            ingest_s = await ingest(messages(vel, np.ones(n_entities, bool)))
        else:
            knn_select.launches = 0  # this mix's run starts here
            knn_select.shapes = {}
            ingest_s = await ingest(messages(
                vel, (vel != vel_prev).any(axis=1)))
        vel_prev = vel
        if plane.entity_count != n_entities:
            raise AssertionError(
                f"{plane.entity_count} of {n_entities} entities registered")

        # serve: sample each applied tick's stage times until min_ticks
        t_serve = time.perf_counter()
        start_applied = plane.applied_ticks
        start_disp = plane.dispatches
        start_replay = plane.delta_sim_ticks
        start_stats = plane.stats()
        samples = []
        last = plane.applied_ticks
        frames_before = sunk["frames"]
        sample.clear()  # drop the peers' PeerConnect notices: frames only
        deadline = time.perf_counter() + 400
        while plane.applied_ticks - start_applied < min_ticks:
            if time.perf_counter() > deadline:
                raise AssertionError("server did not serve the ticks in time")
            await asyncio.sleep(0.002)
            if plane.applied_ticks != last:
                last = plane.applied_ticks
                samples.append({
                    "tick_ms": server.ticker.last_tick_ms,
                    "integrate_ms": plane.last_integrate_ms,
                    "collect_ms": plane.last_knn_ms,
                    "apply_ms": plane.last_apply_ms,
                    "frames": plane.frames,
                    # the wire bytes of the last tick whose delivery
                    # settled (the ticker's per-flush gauge)
                    "bytes": server.metrics.gauge_value(
                        "delivery.bytes_per_tick"),
                    "delta_ratio": (server.interest.stats()["delta_ratio"]
                                    if server.interest is not None
                                    else None),
                })
        serve_s = time.perf_counter() - t_serve
        delivery = server.delivery_status()
        interest = (server.interest.stats() if server.interest is not None
                    else None)
        last_mix = mi == len(mixes) - 1
        stop_s = None
        if last_mix:
            t_stop = time.perf_counter()
            await server.stop()
            stop_s = time.perf_counter() - t_stop
        launches = knn_select.launches  # read just after the mix's run
        shapes = [[n, k, c] for (n, k), c in
                  sorted(knn_select.shapes.items())]

        stats = plane.stats()
        ticks = plane.applied_ticks - start_applied
        dispatched = plane.dispatches - start_disp
        delta_ticks = plane.delta_sim_ticks - start_replay
        if stats["scatter_fallbacks"] != 0:
            raise AssertionError(f"scatter fell back: {stats}")
        if stats["dropped_ticks"] != 0:
            raise AssertionError(f"dropped ticks: {stats}")
        replay = None
        if adopted is not None:
            # the workers flushed their rings at the stop and closed
            # their ends: every frame has reached its reader
            adopted.join(300)
            if delivery["ring_full_drops"] or delivery["alive"] != \
                    config.delivery_workers or delivery["peers"] != n_peers:
                raise AssertionError(f"delivery plane: {delivery}")
            sample = [f for p in peers for f in adopted.frames[p][:4]]
            served = sum(len(adopted.frames[p]) for p in peers)
            if server.interest is not None:
                replay = _replay_interest(server, adopted, peers)
        else:
            served = sunk["frames"] - frames_before
        if served <= 0:
            raise AssertionError("no frame reached the sinks")
        # what came out is right in form: decoded neighbour frames of
        # registered entities, at finite positions inside the world bounds
        frames_seen = 0
        for data in sample:
            msg = deserialize_message(data)
            if not msg.parameter or not msg.parameter.startswith(
                    "entity.frame"):
                continue  # PeerConnect notices of the peer inserts
            frames_seen += 1
            interest_frame = msg.parameter != "entity.frame"
            for ent in msg.entities[:4]:
                p = (ent.position.x, ent.position.y, ent.position.z)
                if (ent.uuid.int not in registered
                        or not all(np.isfinite(p))
                        or max(map(abs, p)) > config.entity_bounds
                        or (not interest_frame
                            and msg.sender_uuid not in peers)):
                    raise AssertionError(f"malformed neighbour frame: {msg}")
        if frames_seen == 0:
            raise AssertionError("no entity.frame among the sampled frames")
        frames_per_tick = [b["frames"] - a["frames"]
                           for a, b in zip(samples, samples[1:])]
        bytes_per_tick = [s["bytes"] for s in samples[1:]]

        def pct(key, q):
            vals = sorted(s[key] for s in samples[1:])
            return vals[min(len(vals) - 1, int(q * len(vals)))]

        report = {
            "entities": plane.entity_count, "peers": n_peers,
            "worlds": n_worlds, "k": plane.k, "capacity": stats["capacity"],
            "mix": mi, "boot_s": boot_s if mi == 0 else None,
            "ingest_s": ingest_s, "serve_s": serve_s, "stop_s": stop_s,
            "ticks": ticks, "dispatched": dispatched,
            "delta_sim_ticks": delta_ticks, "full_sim_ticks":
                stats["full_sim_ticks"] - start_stats["full_sim_ticks"],
            "knn_launches": launches,
            "knn_shapes": shapes,
            "tick_ms_p50": pct("tick_ms", 0.5),
            "tick_ms_p99": pct("tick_ms", 0.99),
            "integrate_ms_p50": pct("integrate_ms", 0.5),
            "collect_ms_p50": pct("collect_ms", 0.5),
            "apply_ms_p50": pct("apply_ms", 0.5),
            "frames_per_tick": statistics.median(frames_per_tick)
            if frames_per_tick else 0,
            "frames_to_sinks": served,
            "bytes_to_sinks": (adopted.bytes if adopted is not None
                               else sunk["bytes"]),
            "bytes_per_tick": bytes_per_tick,
            "bytes_per_tick_p50": statistics.median(bytes_per_tick)
            if bytes_per_tick else 0,
            "delta_ratio": [s["delta_ratio"] for s in samples],
            "tick_ms": [s["tick_ms"] for s in samples],
            "apply_ms": [s["apply_ms"] for s in samples],
            "interest": interest, "delivery": delivery, "replay": replay,
            "ring_bytes": config.delivery_ring_bytes
            if config.delivery_workers else None,
            "scatter_fallbacks": stats["scatter_fallbacks"],
            "dropped_ticks": stats["dropped_ticks"],
            "warmup": server.precompile_stats,
            "device": str(plane.device),
            "index": {k: server.backend.device_stats()[k] for k in (
                "subscriptions", "base_rows", "delta_rows", "compactions",
                "delta_sync_sorts", "delta_sync_scatters")},
            "moving": moving, "frames_checked": frames_seen,
        }
        out.append((report, launches))
    return out


def _ms_stats(vals):
    vals = sorted(vals)
    return {"p50": vals[len(vals) // 2],
            "p99": vals[min(len(vals) - 1, int(0.99 * len(vals)))]}


@phase("index ops cuda vs cpu")
def phase_index_ops(torch, n_subs=1 << 20, n_q=16_384, device="cuda"):
    """Every K1–K6 op of ops/index.py on the card and on the CPU from the
    same seeded inputs at the index's full width (1,048,576 rows of the
    config-5 Zipf crowd in 8 worlds, 16,384 queries, a 65,536-row
    delta): bit-equal outputs, and each op's time on the card."""
    from worldql_server_tpu_torch.tools.index_bench import (
        op_calls, op_inputs)
    from worldql_server_tpu_torch.tools.knn_bench import cuda_time_ms

    gcalls = op_calls(op_inputs(n_subs, n_q, SEED, device))
    ccalls = op_calls(op_inputs(n_subs, n_q, SEED, "cpu"))
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    rows = []
    for (name, g), (_, c) in zip(gcalls, ccalls):
        got, want = g(), c()
        torch.cuda.synchronize()
        if len(got) != len(want) or not all(
                a.device.type == device and torch.equal(a.cpu(), b)
                for a, b in zip(got, want)):
            raise AssertionError(f"index op {name}: card != cpu")
        ms = cuda_time_ms(g, 10, flush)
        row = {"op": name, "ms": ms,
               "out_bytes": sum(a.numel() * a.element_size() for a in got)}
        print("index op", json.dumps(row), flush=True)
        rows.append(row)
    print(f"index ops: {len(rows)} ops, card == cpu bit for bit "
          f"(tolerance: exact) at {n_subs} rows x {n_q} queries")
    return rows


def _cpu_fanout(ref, worlds, peers, batch):
    from worldql_server_tpu_torch.protocol.types import Replication, Vector3
    from worldql_server_tpu_torch.spatial.backend import LocalQuery

    wid, pos, sid, repl = batch
    return ref.match_local_batch([
        LocalQuery(worlds[w], Vector3(*map(float, p)),
                   peers[s] if s >= 0 else None, Replication(int(r)))
        for w, p, s, r in zip(wid, pos, sid, repl)])


def _same_fanout(got, want, what):
    if [set(x) for x in got] != [set(x) for x in want] or \
            [len(x) for x in got] != [len(x) for x in want]:
        bad = sum(set(a) != set(b) for a, b in zip(got, want))
        raise AssertionError(f"{what}: {bad} queries differ from the "
                             "cpu index")


def _sorted_rows(backend, names):
    """The index's live rows as one lexsorted [n, 6] int64 matrix
    (world by name, peer uuid hi/lo, cube), independent of interning."""
    from worldql_server_tpu_torch.spatial.snapshot import export_rows

    worlds, hi, lo, wid, cube, pid = export_rows(backend)
    order = np.array([names.index(w) for w in worlds], np.int64)
    m = np.column_stack([order[wid], hi[pid].view(np.int64),
                         lo[pid].view(np.int64), cube.astype(np.int64)])
    return m[np.lexsort(m.T[::-1])]


def _snapshot_leg(torch, dev, worlds, peers, batch, device):
    """``save_snapshot`` of the live config-5 index, ``load_snapshot``
    into a fresh CudaSpatialBackend on the card (its bulk load, K1 on
    upload): equal row sets and one staged batch's fan-out equal."""
    import tempfile

    from worldql_server_tpu_torch.spatial.cuda_backend import (
        CudaSpatialBackend)
    from worldql_server_tpu_torch.spatial.snapshot import (
        load_snapshot, save_snapshot)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index.npz")
        t0 = time.perf_counter()
        saved = save_snapshot(dev, path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        fresh = CudaSpatialBackend(16, device=device)
        t0 = time.perf_counter()
        restored, _ = load_snapshot(fresh, path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    if fresh.device != dev.device or fresh._base_bundle is None:
        raise AssertionError(f"the restore did not reach {dev.device}")
    a, b = _sorted_rows(dev, worlds), _sorted_rows(fresh, worlds)
    if restored != saved or not np.array_equal(a, b):
        raise AssertionError(f"snapshot rows differ: saved {saved}, "
                             f"restored {restored}")
    wid, pos, sid, repl = batch
    fw, fp = fresh.interning_maps()
    moved = (np.array([fw[worlds[w]] for w in wid], np.int32), pos,
             np.array([fp[peers[x]] for x in sid], np.int32), repl)
    want = dev.collect_local_batch(dev.dispatch_staged_batch(*batch))
    got = fresh.collect_local_batch(fresh.dispatch_staged_batch(*moved))
    _same_fanout(got, want, "restored index")
    out = {"rows": saved, "file_bytes": size, "save_s": save_s,
           "restore_s": restore_s, "queries": len(wid),
           "fanout": sum(map(len, got)), "device": str(fresh.device)}
    print("snapshot", json.dumps(out), flush=True)
    return out


def _top_device_ops(prof, wall_ms):
    """The profile's top-10 device activities by self time and top-10
    aten ops by device time, with counts; None when the profiler saw no
    device time."""
    rows = []
    for e in prof.key_averages():
        self_us = getattr(e, "self_device_time_total", None)
        if self_us is None:
            self_us = getattr(e, "self_cuda_time_total", 0)
        total_us = getattr(e, "device_time_total", None)
        if total_us is None:
            total_us = getattr(e, "cuda_time_total", 0)
        rows.append((e.key, int(e.count), float(self_us), float(total_us)))
    busy_us = sum(r[2] for r in rows)
    if busy_us <= 0:
        return None
    kernels = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    ops = sorted((r for r in rows if r[0].startswith("aten::") and r[3] > 0),
                 key=lambda r: -r[3])
    return {
        "device_busy_ms": busy_us / 1e3, "wall_ms": wall_ms,
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "top_device": [{"name": k[:90], "count": c, "self_ms": su / 1e3}
                       for k, c, su, _ in kernels[:10]],
        "top_aten": [{"op": k, "count": c, "device_ms": tu / 1e3}
                     for k, c, _, tu in ops[:10]],
    }


@phase("fan-out config 5")
def phase_fanout(torch, n_ticks=24, profile_ticks=5, n_subs=1 << 20,
                 m=16_384, device=None):
    """BASELINE config 5 on the cuda index: 1,048,576 Zipf-crowd
    subscriptions in 8 worlds, bulk load, compaction drained, the boot
    tier walk, then ``n_ticks`` pipelined ticks of 16,384 staged queries
    (dispatch tick t+1, collect tick t on a worker thread, as the
    ticker does), sampled ticks held against the cpu index; then
    ``profile_ticks`` more under torch.profiler."""
    from concurrent.futures import ThreadPoolExecutor

    from torch.profiler import ProfilerActivity, profile

    from worldql_server_tpu_torch.spatial.cpu_backend import (
        CpuSpatialBackend)
    from worldql_server_tpu_torch.spatial.cuda_backend import (
        CudaSpatialBackend)
    from worldql_server_tpu_torch.spatial.precompile import precompile_tiers
    from worldql_server_tpu_torch.spatial.quantize import cube_coords_batch
    from worldql_server_tpu_torch.tools.index_bench import (
        build_index, make_query_batch)

    n_worlds = 8
    rng = np.random.default_rng(SEED + 5)
    dev = CudaSpatialBackend(16, device=device)  # default: the card
    dev.configure_delta_ticks("auto")       # as the server arms it
    crowd = {}
    t0 = time.perf_counter()
    peers, pos, wids = build_index(dev, rng, n_subs, n_worlds, crowd)
    dev.flush()
    dev.wait_compaction()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    worlds = [f"world_{w}" for w in range(n_worlds)]
    ref = CpuSpatialBackend(16)
    cubes = cube_coords_batch(pos, 16)
    for w in range(n_worlds):
        sel = np.flatnonzero(wids == w)
        ref.bulk_add_subscriptions(worlds[w], [peers[i] for i in sel],
                                   cubes[sel])
    t0 = time.perf_counter()
    walk = precompile_tiers(dev, max_batch=m)
    walk_s = time.perf_counter() - t0
    batches = [make_query_batch(rng, pos, wids, m)
               for _ in range(n_ticks + profile_ticks)]

    def collect(handle):
        out = dev.collect_local_batch(handle)
        return out, dict(dev.last_device_timing), dict(dev.last_collect_stats)

    sample = {1, n_ticks // 2, n_ticks - 1}
    ticks = []
    fetch0 = (dev.compact_fetches, dev.full_fetches)
    with ThreadPoolExecutor(1) as pool:
        pending = None

        def finish(item):
            t, t_d, fut = item
            out, timing, fetched = fut.result()
            ticks.append({"tick_ms": (time.perf_counter() - t_d) * 1e3,
                          "fanout": sum(map(len, out)), **timing,
                          **fetched})
            if t in sample:
                _same_fanout(out, _cpu_fanout(ref, worlds, peers,
                                              batches[t]),
                             f"config-5 tick {t}")

        for t in range(n_ticks):
            t_d = time.perf_counter()
            fut = pool.submit(collect, dev.dispatch_staged_batch(*batches[t]))
            if pending is not None:
                finish(pending)
            pending = (t, t_d, fut)
        finish(pending)
    steady = ticks[1:]
    report = {
        "subscriptions": dev.subscription_count(), "worlds": n_worlds,
        "queries": m, "ticks": len(ticks), "crowd": crowd,
        "load_s": load_s, "tier_walk_s": walk_s, "tier_walk": walk,
        "tick_ms": _ms_stats([r["tick_ms"] for r in steady]),
        "split_ms_p50": {
            leg: _ms_stats([r.get(leg, 0.0) for r in steady])["p50"]
            for leg in ("encode_ms", "h2d_ms", "d2h_enqueue_ms",
                        "compute_ms", "d2h_ms")},
        "paths": sorted({r.get("path", "?") for r in steady}),
        "compact_fetches": dev.compact_fetches - fetch0[0],
        "full_fetches": dev.full_fetches - fetch0[1],
        "fetch_bytes_p50": _ms_stats([r["fetch_bytes"] for r in steady])[
            "p50"],
        "fanout_per_tick": _ms_stats([r["fanout"] for r in steady])["p50"],
        "ticks_checked_against_cpu": sorted(sample),
        "device_stats": dev.device_stats(),
    }
    print("fanout", json.dumps(report), flush=True)
    report["snapshot"] = _snapshot_leg(torch, dev, worlds, peers,
                                       batches[0], device)

    # the profile: the same ticks, dispatch + collect, under the profiler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches[n_ticks:]:
            dev.collect_local_batch(dev.dispatch_staged_batch(*b))
        torch.cuda.synchronize()
    top = _top_device_ops(prof, (time.perf_counter() - t0) * 1e3)
    if top is None:
        print("profile: torch.profiler recorded no device time; the "
              "per-op CUDA-event times of the index-ops phase stand in")
    else:
        print(f"profile of {profile_ticks} fan-out ticks: device busy "
              f"{top['device_busy_ms']:.3f} ms of {top['wall_ms']:.3f} ms "
              f"wall ({100 * top['device_busy_share']:.2f}%)")
        for r in top["top_device"]:
            print(f"profile device {r['self_ms']:10.3f} ms  x{r['count']:<5}"
                  f" {r['name']}")
        for r in top["top_aten"]:
            print(f"profile aten   {r['device_ms']:10.3f} ms  x{r['count']:<5}"
                  f" {r['op']}")
        print("profile", json.dumps(top), flush=True)
    return report, top


@phase("churn config 2")
def phase_churn(torch, n_ticks=50, n=10_000, device=None):
    """BASELINE config 2 on the cuda index: 10,000 random-walk clients
    (cube 16, ±400, velocities ±30, dt 0.05); each tick bulk remove +
    add of the movers, flush, then match_arrays_async with csr_cap =
    n*8 for every client — fan-out equal to the cpu index's every
    tick."""
    from worldql_server_tpu_torch.spatial.cpu_backend import (
        CpuSpatialBackend)
    from worldql_server_tpu_torch.spatial.cuda_backend import (
        CudaSpatialBackend)
    from worldql_server_tpu_torch.tools.index_bench import RandomWalk

    walk = RandomWalk(np.random.default_rng(11), n)
    dev = CudaSpatialBackend(16, device=device)
    dev.configure_delta_ticks("auto")
    ref = CpuSpatialBackend(16)
    for b in (dev, ref):
        b.bulk_add_subscriptions("walk", walk.peers, walk.cubes)
    dev.flush()
    world_ids = np.zeros(n, np.int32)
    senders = np.arange(n, dtype=np.int32)
    repls = np.zeros(n, np.int8)
    rows = []
    for t in range(n_ticks):
        t0 = time.perf_counter()
        moved, old, new = walk.step()
        sel = [walk.peers[i] for i in moved]
        dev.bulk_remove_subscriptions("walk", sel, old)
        dev.bulk_add_subscriptions("walk", sel, new)
        dev.flush()
        m, (counts, flat, total) = dev.match_arrays_async(
            world_ids, walk.positions, senders, repls, csr_cap=n * 8)
        if int(total) > flat.shape[0]:
            raise AssertionError(f"churn tick {t}: csr_cap overflow")
        got = dev._decode_csr(counts.cpu().numpy(), flat.cpu().numpy(), m)
        rows.append({"tick_ms": (time.perf_counter() - t0) * 1e3,
                     "moved": int(moved.size),
                     "fanout": sum(map(len, got))})
        for i, o, c in zip(moved, old, new):
            ref.remove_subscription("walk", walk.peers[i],
                                    tuple(int(v) for v in o))
            ref.add_subscription("walk", walk.peers[i],
                                 tuple(int(v) for v in c))
        _same_fanout(got, _cpu_fanout(ref, ["walk"], walk.peers,
                                      (world_ids, walk.positions,
                                       senders, repls)),
                     f"config-2 tick {t}")
    dev.wait_compaction()
    report = {
        "clients": n, "ticks": n_ticks,
        "tick_ms": _ms_stats([r["tick_ms"] for r in rows[1:]]),
        "resubscriptions_per_tick": statistics.median(
            r["moved"] for r in rows),
        "fanout_per_tick": statistics.median(r["fanout"] for r in rows),
        "compactions": dev.compactions,
        "delta_sync": dict(dev.last_delta_sync),
        "device": str(dev.device),
    }
    print("churn", json.dumps(report), flush=True)
    return report


@phase("query kernels cuda vs cpu")
def phase_query_kernels(torch, m=4096, radius=3):
    """K10 and K11, the query library's stencil kernels (torch ops), on
    the card and on the CPU from the same seeded parameters at the
    serving width: 4,096 rows against the full r=3 stencil of 343 cubes
    (cube 16). Bit-equal outputs, on CUDA tensors; CUDA-event median of
    10 after an L2-evicting read."""
    from worldql_server_tpu_torch.queries import geometry, knn
    from worldql_server_tpu_torch.queries.stencil import stencil_offsets
    from worldql_server_tpu_torch.tools.index_bench import (
        KIND_IDS, kind_cols)
    from worldql_server_tpu_torch.tools.knn_bench import cuda_time_ms

    off = stencil_offsets(radius)
    host = {"geom": torch.from_numpy(geometry.stencil_geometry(off, 16)),
            "off": torch.from_numpy(off.astype(np.float64))}
    card = {key: t.cuda() for key, t in host.items()}
    calls = (
        ("_cone_mask_kernel (K11)", "cone",
         lambda p, s: (geometry._cone_mask_kernel(p, s["geom"]),)),
        ("_density_mask_kernel (K11)", "density",
         lambda p, s: (geometry._density_mask_kernel(p, s["off"]),)),
        ("_knn_order_kernel (K10)", "knn",
         lambda p, s: knn._knn_order_kernel(p, s["geom"])),
    )
    rng = np.random.default_rng(SEED + 12)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    rows = []
    for name, kind, fn in calls:
        params = torch.from_numpy(kind_cols(rng, m, KIND_IDS[kind])[1])
        p_card = params.cuda()
        got, want = fn(p_card, card), fn(params, host)
        torch.cuda.synchronize()
        if not all(a.device.type == "cuda" and torch.equal(a.cpu(), b)
                   for a, b in zip(got, want)):
            raise AssertionError(f"query kernel {name}: card != cpu")
        ms = cuda_time_ms(lambda: fn(p_card, card), 10, flush)
        t0 = time.perf_counter()
        fn(params, host)
        row = {"op": name, "rows": m, "stencil": int(off.shape[0]),
               "ms": ms, "cpu_ms": (time.perf_counter() - t0) * 1e3,
               "out_bytes": sum(a.numel() * a.element_size() for a in got)}
        print("query kernel", json.dumps(row), flush=True)
        rows.append(row)
    print(f"query kernels: card == cpu bit for bit (tolerance: exact) at "
          f"[{m}, {off.shape[0]}], outputs on the card")
    return rows


@phase("query library config 12")
def phase_queries(torch, n_subs=1_000_000, m=4096, reps=5, device=None):
    """BASELINE config 12 (``bench.py::bench_config12``) on the cuda
    index: 1,000,000 Zipf-crowd subscriptions in 4 worlds (seed 17), a
    staged batch of 4,096 queries from subscribers' positions — pure
    cone, raycast, knn and density batches, the mixed batch (radius and
    the four kinds interleaved) and a pure-radius batch of the same m —
    each dispatched and collected ``reps`` times after one warm run:
    p50/p99 wall and probe rows per batch, the host expansion's share
    (``expand_staged`` alone), and the mixed batch once under
    torch.profiler (device busy share). The K10/K11 calls of the timed
    runs are counted; 12 lanes of each kind of the mixed batch are held
    against the cpu index (the oracles)."""
    from torch.profiler import ProfilerActivity, profile

    from worldql_server_tpu_torch.protocol.types import Replication, Vector3
    from worldql_server_tpu_torch.queries import geometry, knn
    from worldql_server_tpu_torch.queries.expand import expand_staged
    from worldql_server_tpu_torch.spatial.backend import LocalQuery
    from worldql_server_tpu_torch.spatial.cpu_backend import (
        CpuSpatialBackend)
    from worldql_server_tpu_torch.spatial.cuda_backend import (
        CudaSpatialBackend)
    from worldql_server_tpu_torch.spatial.precompile import precompile_tiers
    from worldql_server_tpu_torch.tools.index_bench import (
        KIND_IDS, build_index, kind_cols, mixed_cols, query_results_match)

    n_worlds = 4
    rng = np.random.default_rng(17)
    dev = CudaSpatialBackend(16, device=device)
    t0 = time.perf_counter()
    peers, positions, world_ids = build_index(dev, rng, n_subs, n_worlds)
    dev.flush()
    dev.wait_compaction()
    load_s = time.perf_counter() - t0
    senders = rng.integers(0, len(peers), m)
    wid = np.array([dev._world_ids[f"world_{w}"]
                    for w in world_ids[senders]], np.int32)
    sid = np.array([dev._peer_ids[peers[s]] for s in senders], np.int32)
    pos = np.ascontiguousarray(positions[senders], np.float64)
    repl = np.full(m, int(Replication.EXCEPT_SELF), np.int8)
    batches = {name: kind_cols(rng, m, kid) for name, kid in KIND_IDS.items()}
    batches["mixed"] = mixed_cols(rng, m)
    batches["radius"] = (None, None)
    t0 = time.perf_counter()
    walk = precompile_tiers(dev, max_batch=m)
    walk_s = time.perf_counter() - t0

    def run(kinds, params):
        t0 = time.perf_counter()
        handle = dev.dispatch_staged_batch(wid, pos, sid, repl, kinds, params)
        out = dev.collect_local_batch(handle)
        probes = handle[1][1].probe_owner.shape[0] if kinds is not None else m
        return out, (time.perf_counter() - t0) * 1e3, int(probes)

    for kinds, params in batches.values():
        run(kinds, params)  # warm: first use of each probe tier
    expansions0 = dev.kind_expansions
    for fn in (geometry.cone_mask, geometry.density_mask, knn.knn_order):
        fn.launches = 0  # the timed runs start here
    report = {}
    outputs = {}
    for name, (kinds, params) in batches.items():
        walls = []
        for _ in range(reps):
            out, ms, probes = run(kinds, params)
            walls.append(ms)
        outputs[name] = out
        report[name] = {**_ms_stats(walls), "probe_rows": probes,
                        "lanes": sum(len(r.peers) if hasattr(r, "extra")
                                     else len(r) for r in out)}
        print(f"config 12 {name}: {json.dumps(report[name])}", flush=True)
    launches = {"cone_mask": geometry.cone_mask.launches,
                "density_mask": geometry.density_mask.launches,
                "knn_order": knn.knn_order.launches}
    expansions = dev.kind_expansions - expansions0
    if expansions <= 0 or min(launches.values()) <= 0:
        raise AssertionError(f"kind path not driven: {expansions} "
                             f"expansions, kernel calls {launches}")
    for name, (kinds, params) in batches.items():
        if kinds is not None:
            t0 = time.perf_counter()
            expand_staged(wid, pos, sid, repl, kinds, params, cube_size=16,
                          device=dev.device)
            report[name]["expand_ms"] = (time.perf_counter() - t0) * 1e3
    top = None
    if dev.device.type == "cuda":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(*batches["mixed"])
            torch.cuda.synchronize()
        top = _top_device_ops(prof, (time.perf_counter() - t0) * 1e3)
        if top is not None:
            print(f"profile of the mixed batch: device busy "
                  f"{top['device_busy_ms']:.3f} ms of {top['wall_ms']:.3f} "
                  f"ms wall ({100 * top['device_busy_share']:.2f}%)")
            for r in top["top_device"][:6]:
                print(f"profile device {r['self_ms']:10.3f} ms  "
                      f"x{r['count']:<5} {r['name']}")

    t0 = time.perf_counter()
    cpu = CpuSpatialBackend(16)
    build_index(cpu, np.random.default_rng(17), n_subs, n_worlds)
    cpu_load_s = time.perf_counter() - t0
    kinds, params = batches["mixed"]
    sample = [i for kid in (0, *KIND_IDS.values())
              for i in np.flatnonzero(kinds == kid)[:12]]
    for i in sample:
        want = cpu.match_local_batch([LocalQuery(
            f"world_{world_ids[senders[i]]}", Vector3(*map(float, pos[i])),
            peers[senders[i]], Replication.EXCEPT_SELF, kind=int(kinds[i]),
            params=tuple(params[i]))])[0]
        if not query_results_match(outputs["mixed"][i], want):
            raise AssertionError(
                f"config 12 mixed lane {i} (kind {kinds[i]}) differs from "
                f"the cpu index: {outputs['mixed'][i]!r} vs {want!r}")
    summary = {
        "subscriptions": dev.subscription_count(), "worlds": n_worlds,
        "queries": m, "reps": reps, "load_s": load_s,
        "tier_walk_s": walk_s, "tier_walk": walk,
        "kind_expansions": expansions, "kernel_calls": launches,
        "device": str(dev.device), "lanes_checked": len(sample),
        "cpu_index_load_s": cpu_load_s, "batches": report,
        "mixed_profile": top,
    }
    print("queries", json.dumps(summary), flush=True)
    print(f"config 12: {len(sample)} sampled lanes of the mixed batch "
          "equal the cpu index (tolerance: exact)")
    return summary


@phase("resilience on the cuda index")
def phase_resilience(torch, n=10_000, n_ticks=12, device=None):
    """``ResilientBackend(CudaSpatialBackend)`` under config 2's 10,000
    random-walk clients: each tick bulk remove + add of the movers,
    flush, and a staged batch of one LocalMessage query per client with
    the ticker's fallback pairs. ``backend.dispatch`` fires on tick 2
    and ``backend.collect`` on tick 5 (each contained through the CPU
    mirror and followed by a rebuild onto a fresh cuda index), then
    ``backend.collect`` on ticks 8-10, three in a row: the failover to
    the mirror. Fan-out equals the cpu index's on every tick."""
    from worldql_server_tpu_torch.engine.metrics import Metrics
    from worldql_server_tpu_torch.protocol.types import Replication, Vector3
    from worldql_server_tpu_torch.robustness import failpoints
    from worldql_server_tpu_torch.robustness.resilient import (
        ResilientBackend)
    from worldql_server_tpu_torch.spatial.backend import LocalQuery
    from worldql_server_tpu_torch.spatial.cpu_backend import (
        CpuSpatialBackend)
    from worldql_server_tpu_torch.spatial.cuda_backend import (
        CudaSpatialBackend)
    from worldql_server_tpu_torch.tools.index_bench import RandomWalk

    def fresh():
        b = CudaSpatialBackend(16, device=device)
        b.configure_delta_ticks("auto")  # as the server's factory arms it
        return b

    walk = RandomWalk(np.random.default_rng(SEED + 3), n)
    metrics = Metrics()
    first = fresh()
    backend = ResilientBackend(first, factory=fresh, failover_after=3,
                               metrics=metrics)
    ref = CpuSpatialBackend(16)
    for b in (backend, ref):
        b.bulk_add_subscriptions("walk", walk.peers, walk.cubes)
    backend.flush()
    faults = {2: "backend.dispatch=error:1:x1",
              5: "backend.collect=error:1:x1",
              8: "backend.collect=error:1:x3"}
    repl = np.zeros(n, np.int8)
    rows = []
    try:
        for t in range(n_ticks):
            moved, old, new = walk.step()
            sel = [walk.peers[i] for i in moved]
            backend.bulk_remove_subscriptions("walk", sel, old)
            backend.bulk_add_subscriptions("walk", sel, new)
            backend.flush()
            for i, o, c in zip(moved, old, new):
                ref.remove_subscription("walk", walk.peers[i],
                                        tuple(int(v) for v in o))
                ref.add_subscription("walk", walk.peers[i],
                                     tuple(int(v) for v in c))
            worlds, peer_ids = backend.interning_maps()
            wid = np.full(n, worlds["walk"], np.int32)
            sid = np.array([peer_ids[p] for p in walk.peers], np.int32)
            queries = [LocalQuery("walk", Vector3(*map(float, xyz)), p,
                                  Replication.EXCEPT_SELF)
                       for xyz, p in zip(walk.positions, walk.peers)]
            if t in faults:
                failpoints.registry.configure(faults[t])
            t0 = time.perf_counter()
            got = backend.collect_local_batch(backend.dispatch_staged_batch(
                wid, walk.positions, sid, repl,
                fallback=[(None, q) for q in queries]))
            tick_ms = (time.perf_counter() - t0) * 1e3
            _same_fanout(got, ref.match_local_batch(queries),
                         f"resilience tick {t}")
            st = backend.status()
            rows.append({"tick": t, "tick_ms": tick_ms,
                         "fanout": sum(map(len, got)),
                         "fault": faults.get(t, ""),
                         "inner_is_first": backend.inner is first, **st})
            print("resilience tick", json.dumps(rows[-1]), flush=True)
            if t == 7 and (st["rebuilds"] != 2 or st["failed_over"]
                           or backend.inner is first
                           or backend.inner.device.type != first.device.type
                           or st["inner"] != "CudaSpatialBackend"):
                raise AssertionError(f"no rebuild onto the card: {st}")
    finally:
        fired = dict(failpoints.registry.fired_counts())
        failpoints.registry.configure("")
    st = backend.status()
    if not (st["failed_over"] and st["degraded_batches"] == 5
            and st["failures"] == 5 and st["rebuilds"] == 4):
        raise AssertionError(f"resilience leg ended in {st}")
    report = {
        "clients": n, "ticks": n_ticks, "status": st, "fired": fired,
        "metrics": {k: v for k, v in metrics.counters.items()
                    if k.startswith("resilience")},
        "tick_ms": _ms_stats([r["tick_ms"] for r in rows]),
        "fault_tick_ms": {r["tick"]: r["tick_ms"] for r in rows
                          if r["fault"]},
        "device": str(first.device),
    }
    print("resilience", json.dumps(report), flush=True)
    print(f"resilience: fan-out equal to the cpu index on all {n_ticks} "
          f"ticks; {st['degraded_batches']} contained batches, "
          f"{st['rebuilds']} rebuilds, failed over: {st['failed_over']}")
    return report


#: one LocalMessage of each query kind, asked through the server
KIND_QUERIES = (
    ("query.cone", {"dir": [1, 0, 0], "half_angle_deg": 95, "range": 48}),
    ("query.raycast", {"dir": [0.6, 0.8, 0], "max_t": 48,
                       "mode": "all_hits"}),
    ("query.knn", {"k": 4, "max_range": 48}),
    ("query.density", {"extent": 3, "top_n": 8}),
)


async def _ask_kinds(server, askers, positions, inbox):
    """Send one query of each kind, asker i asking KIND_QUERIES[i], and
    wait for the ``.result`` reply frames; returns them as bytes."""
    from worldql_server_tpu_torch.protocol import (
        Instruction, Message, deserialize_message)
    from worldql_server_tpu_torch.protocol.types import Vector3

    for (wire, payload), p, pos in zip(KIND_QUERIES, askers, positions):
        await server.router.handle_message(Message(
            instruction=Instruction.LOCAL_MESSAGE, sender_uuid=p,
            world_name="walk", position=Vector3(*map(float, pos)),
            parameter=wire, flex=json.dumps(payload).encode()))
    replies = []
    deadline = time.perf_counter() + 60
    for (wire, _), p in zip(KIND_QUERIES, askers):
        while True:
            found = [d for d in inbox.get(p, ())
                     if deserialize_message(d).parameter == f"{wire}.result"]
            if found:
                replies.append(found[0])
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"no {wire}.result reply")
            await asyncio.sleep(0.005)
    return replies


async def drive_local_messages(torch, n_ticks=10, n=10_000, device=None,
                               extra_args=(), kinds=True,
                               silent_join=False):
    """LocalMessage fan-out through the server as ``python -m
    worldql_server_tpu_torch`` boots it on a card (the cuda index, a
    0.05 s tick, staged dispatch): the 10,000 config-2 clients join with
    in-memory sinks, AreaSubscribe their cube through the router, and
    each sends one LocalMessage a tick from its walking position. Frames
    each peer receives per tick must equal what the cpu index resolves
    for the same messages."""
    import collections

    from worldql_server_tpu_torch.__main__ import (
        build_parser, config_from_args)
    from worldql_server_tpu_torch.engine.config import (
        apply_device_boot_defaults)
    from worldql_server_tpu_torch.engine.peers import Peer
    from worldql_server_tpu_torch.engine.server import WorldQLServer
    from worldql_server_tpu_torch.protocol import Instruction, Message
    from worldql_server_tpu_torch.protocol.types import Replication, Vector3
    from worldql_server_tpu_torch.spatial.backend import LocalQuery
    from worldql_server_tpu_torch.spatial.cpu_backend import (
        CpuSpatialBackend)
    from worldql_server_tpu_torch.spatial.cuda_backend import (
        CudaSpatialBackend)
    from worldql_server_tpu_torch.tools.index_bench import RandomWalk

    config = config_from_args(build_parser().parse_args([
        "--store-url", "memory://", "--no-ws", "--no-http", "--no-zmq",
        *extra_args]))
    apply_device_boot_defaults(config, backend_explicit=False,
                               interval_explicit=False)
    config.validate()
    server = WorldQLServer(config, device=device)
    if not (isinstance(server.backend, CudaSpatialBackend)
            and server.backend.device.type == (device or "cuda")
            and config.tick_interval == 0.05 and server.staging is not None):
        raise AssertionError(f"server booted {config.spatial_backend} on "
                             f"{getattr(server.backend, 'device', 'host')}")
    await server.start()
    walk = RandomWalk(np.random.default_rng(SEED + 2), n)
    cubes0 = walk.cubes.copy()  # the subscriptions stay where they start
    frames = collections.Counter()
    # the query askers: walkers in the most crowded starting cubes
    crowd = collections.Counter(map(tuple, cubes0.tolist()))
    by_crowd = sorted(range(n), key=lambda i: -crowd[tuple(cubes0[i])])
    askers = [walk.peers[i] for i in by_crowd[:len(KIND_QUERIES)]]
    inbox: dict = {p: [] for p in askers}

    def sink(p, frames=frames, inbox=inbox):
        keep = inbox.get(p)

        def one(f):
            frames[p] += 1
            if keep is not None:
                keep.append(f.payload)
            return True

        def many(fs):
            frames[p] += len(fs)
            if keep is not None:
                keep.extend(f.payload for f in fs)
            return True

        async def raw(data):
            frames[p] += 1
            if keep is not None:
                keep.append(data)
        return raw, one, many

    t0 = time.perf_counter()
    for p in walk.peers:
        raw, one, many = sink(p)
        peer = Peer(p, f"mem:{p.hex[:8]}", raw, kind="memory",
                    try_write=one, try_write_many=many)
        if silent_join:
            # no PeerConnect to the peers already in: the O(n^2) join
            # announcements are the first pass's to measure
            server.peer_map.rebind(peer)
        else:
            await server.peer_map.insert(peer)
    join_s = time.perf_counter() - t0
    ref = CpuSpatialBackend(16)
    for i, p in enumerate(walk.peers):
        cube_pos = Vector3(*map(float, walk.positions[i]))
        await server.router.handle_message(Message(
            instruction=Instruction.AREA_SUBSCRIBE, sender_uuid=p,
            world_name="walk", position=cube_pos))
        ref.add_subscription("walk", p, cube_pos)
    if server.backend.subscription_count() != n:
        raise AssertionError("subscriptions missing from the cuda index")
    staged0 = server.backend.staged_dispatches
    rows = []
    for t in range(n_ticks):
        walk.step()
        before = collections.Counter(frames)
        sent = server.ticker.messages + n
        t_send = time.perf_counter()
        for i, p in enumerate(walk.peers):
            await server.router.handle_message(Message(
                instruction=Instruction.LOCAL_MESSAGE, sender_uuid=p,
                world_name="walk",
                position=Vector3(*map(float, walk.positions[i])),
                parameter="walk"))
        t_sent = time.perf_counter()
        while server.ticker.messages < sent:
            await asyncio.sleep(0.002)
        t_done = time.perf_counter()
        got = frames - before
        want = collections.Counter()
        for targets in ref.match_local_batch([
                LocalQuery("walk", Vector3(*map(float, walk.positions[i])),
                           p, Replication.EXCEPT_SELF)
                for i, p in enumerate(walk.peers)]):
            want.update(targets)
        if got != want:
            raise AssertionError(
                f"LocalMessage tick {t}: {sum(got.values())} frames "
                f"delivered, the cpu index resolves {sum(want.values())}")
        rows.append({"frames": sum(got.values()),
                     "send_ms": (t_sent - t_send) * 1e3,
                     "flush_wait_ms": (t_done - t_sent) * 1e3,
                     "tick_ms": server.ticker.last_tick_ms})
    staged = server.backend.staged_dispatches - staged0
    if not kinds:
        overload, sessions = server.overload_status(), \
            server.sessions_status()
        pumped = server.ticker.staged_flushes
        await server.stop()
        if staged == 0 or pumped == 0:
            raise AssertionError("no LocalMessage went through staged "
                                 "dispatch")
        return {
            "peers": n, "ticks": n_ticks, "join_s": join_s,
            "frames_per_tick": statistics.median(r["frames"] for r in rows),
            "tick_ms": _ms_stats([r["tick_ms"] for r in rows]),
            "staged_dispatches": staged, "staged_flushes": pumped,
            "overload": overload, "sessions": sessions,
            "max_batch": config.max_batch,
        }

    # one query of each kind through the same server, the reply frames
    # held against a cpu-index server holding the same subscriptions
    ask_pos = [walk.positions[walk.peers.index(p)] for p in askers]
    expansions0 = server.backend.kind_expansions
    replies = await _ask_kinds(server, askers, ask_pos, inbox)
    expansions = server.backend.kind_expansions - expansions0
    await server.stop()
    if staged == 0:
        raise AssertionError("no LocalMessage went through staged dispatch")
    if expansions == 0:
        raise AssertionError("the kind queries did not expand on the index")
    cpu_config = config_from_args(build_parser().parse_args([
        "--store-url", "memory://", "--no-ws", "--no-http", "--no-zmq",
        "--spatial-backend", "cpu", "--tick-interval", "0.05"]))
    cpu_server = WorldQLServer(cpu_config, device="cpu")
    await cpu_server.start()
    cpu_server.backend.bulk_add_subscriptions("walk", walk.peers, cubes0)
    cpu_inbox: dict = {p: [] for p in askers}
    for p in askers:
        raw, one, many = sink(p, collections.Counter(), cpu_inbox)
        await cpu_server.peer_map.insert(Peer(
            p, f"mem:{p.hex[:8]}", raw, kind="memory", try_write=one,
            try_write_many=many))
    cpu_replies = await _ask_kinds(cpu_server, askers, ask_pos, cpu_inbox)
    await cpu_server.stop()
    if replies != cpu_replies:
        raise AssertionError("query reply frames differ from the cpu-index "
                             "server's")
    from worldql_server_tpu_torch.protocol import deserialize_message

    bodies = [json.loads(bytes(deserialize_message(d).flex))
              for d in replies]
    print("query replies equal the cpu-index server's, byte for byte: "
          + json.dumps([{"kind": b["kind"], "peers": len(b.get("peers", ())),
                         "cubes": len(b.get("cubes", ()))} for b in bodies]),
          flush=True)
    return {
        "peers": n, "ticks": n_ticks, "join_s": join_s,
        "frames_per_tick": statistics.median(r["frames"] for r in rows),
        "tick_ms": _ms_stats([r["tick_ms"] for r in rows]),
        "send_ms_p50": _ms_stats([r["send_ms"] for r in rows])["p50"],
        "flush_wait_ms_p50": _ms_stats(
            [r["flush_wait_ms"] for r in rows])["p50"],
        "staged_dispatches": staged,
        "kind_queries": len(replies), "kind_expansions": expansions,
        "device_stats": server.backend.device_stats(),
    }


#: the overload/session pass's governor: a tick budget far above the
#: host-bound LocalMessage tick, and a batch tier twice the 10,000
#: messages a tick enqueues (the queue-depth signal escalates at half a
#: tier), so the governor stays ok while its pump path flushes
GOVERNED = ("--overload", "on", "--session-ttl", "30",
            "--overload-tick-budget-ms", "60000", "--max-batch", "32768")


@phase("LocalMessage through the server")
def phase_local_messages(torch):
    report = asyncio.run(drive_local_messages(torch))
    print("localmessage", json.dumps(report), flush=True)
    # the same clients again, with the overload governor (its pump path
    # replaces the inline flush) and sessions on
    print(f"governed pass flags: {' '.join(GOVERNED)}")
    governed = asyncio.run(drive_local_messages(
        torch, n_ticks=5, extra_args=GOVERNED, kinds=False,
        silent_join=True))
    print("localmessage governed", json.dumps(governed), flush=True)
    ovl = governed["overload"]
    sheds = {k: ovl[k] for k in ("shed_local", "shed_global",
                                 "shed_handshake_new",
                                 "shed_handshake_resume", "drop_oldest",
                                 "rate_limited")}
    if ovl["state"] != "ok" or ovl["peak_level"] != 0 or any(sheds.values()):
        raise AssertionError(f"the governor left ok or shed: {ovl}")
    print(f"overload_status: {json.dumps(ovl)}")
    print(f"sessions_status: {json.dumps(governed['sessions'])}")
    return report, governed


def interest_ring_bytes(want=64 << 20):
    """Ring bytes a delivery worker gets for the interest leg: room for
    the keyframe tick's frames, and at most an eighth of /dev/shm's free
    space (two rings, whatever else runs)."""
    import shutil

    free = shutil.disk_usage("/dev/shm").free
    size = want
    while size > (1 << 20) and size > free // 8:
        size //= 2
    print(f"/dev/shm free {free} bytes; delivery ring {size} bytes a worker")
    return size


@phase("server on the card")
def phase_server(torch):
    # one boot and join serves both interest-off mixes, 3 + 3 ticks —
    # 1% moving (delta ticks at pow2 sub-tiers), then every entity
    # moving (full ticks) — to leave the scenarios phase room in the
    # script's time limit
    (idle, idle_launches), (report, launches) = asyncio.run(
        drive_server(torch, mixes=((0.01, 3), (1.0, 3))))
    print("server", json.dumps(report), flush=True)
    print("server", json.dumps(idle), flush=True)
    # interest-managed fan-out through two sender workers, at the same
    # shape and the same 1% movers: the keyframe tick, then >= 4 ticks
    ring = interest_ring_bytes()
    ((lean, lean_launches),) = asyncio.run(drive_server(
        torch, mixes=((0.01, 5),), adopt=True, extra_args=(
            "--interest", "on", "--delivery-workers", "2",
            "--delivery-ring-bytes", str(ring))))
    print("server interest", json.dumps(lean), flush=True)
    for rep, n in ((report, launches), (idle, idle_launches),
                   (lean, lean_launches)):
        if rep["device"] != "cuda":
            raise AssertionError(f"entity plane on {rep['device']}")
        if n == 0 or n < rep["dispatched"]:
            raise AssertionError(
                f"knn launches {n} < ticks dispatched {rep['dispatched']}")
    if idle["delta_sim_ticks"] == 0:
        raise AssertionError("the 1%-moving run served no delta tick")
    replay = lean["replay"]
    print(f"interest leg: ring {lean['ring_bytes']} bytes a worker, "
          f"ring_full_drops {lean['delivery']['ring_full_drops']}; "
          f"replay of {lean['peers']} peers (no refused delta, no gap, "
          f"each equal to its ledger): {json.dumps(replay)}; "
          f"bytes a tick p50 {lean['bytes_per_tick_p50']} (interest on) vs "
          f"{idle['bytes_per_tick_p50']} (interest off, same 1% movers); "
          f"apply p50 {lean['apply_ms_p50']:.1f} vs "
          f"{idle['apply_ms_p50']:.1f} ms; tick p50/p99 "
          f"{lean['tick_ms_p50']:.1f}/{lean['tick_ms_p99']:.1f} ms; "
          f"delta_ratio {lean['delta_ratio']}", flush=True)
    print(f"knn launches: {launches} (all moving), {idle_launches} "
          f"(1% moving), {lean_launches} (interest + delivery workers)")
    print("server seconds (boot, ingest, serve, stop): " + json.dumps({
        name: [rep[k] for k in ("boot_s", "ingest_s", "serve_s", "stop_s")]
        for name, rep in (("1% moving", idle), ("all moving", report),
                          ("interest", lean))}))
    shapes = {"entity_sim": report["knn_shapes"],
              "entity_sim_1pct": idle["knn_shapes"],
              "entity_sim_interest_delivery": lean["knn_shapes"]}
    return report, launches, lean_launches, shapes


#: the cluster leg's entities: config 3's 100,000 cut to 60,000, since
#: at 100,000 the leg took 164-250 s on an NVIDIA H100 80GB HBM3 at
#: 700 W, over its ~180 s (PERF.md section 4)
CLUSTER_ENTITIES = 60_000


@phase("cluster on the card")
def phase_cluster(torch):
    """The cluster tier on the card: a router and two ``--entity-sim``
    shard processes on the cuda index (tools/cluster_drive.py), 64 ZMQ
    peers holding ``CLUSTER_ENTITIES`` in 4 worlds, 1% moving, a live
    move of one world between the shards, and the router's SLO surface.
    Each shard starts with half the entities; the world held to zero
    loss across its move holds 3,000 of them, since its peers stay homed
    on the source and its frames then ride the inter-shard ring, which
    the source drains 4,096 records a tick. Then a world of shard 1
    holding an even share (15,000), larger than one drain, moves to
    shard 0, and the ring's records sent, drained and dropped over that
    move are printed (a known fault, ROADMAP Queue C). K7 runs in
    the shard processes: its launches are read off each shard's
    /healthz before the peers register and after the last tick, in all
    and by shape."""
    import importlib.util

    from worldql_server_tpu_torch.tools.cluster_drive import drive_cluster

    # the repo's strict exposition parser, by path: the card host may
    # have another package named ``tests`` on its path
    spec = importlib.util.spec_from_file_location(
        "prom_parser", os.path.join(REPO, "tests", "prom_parser.py"))
    prom_parser = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prom_parser)

    torch.cuda.empty_cache()  # the shards open contexts of their own
    ring = interest_ring_bytes()
    report = asyncio.run(drive_cluster(
        n_entities=CLUSTER_ENTITIES, n_peers=64, moving=0.01, k=32,
        min_ticks=3, device="cuda", moved_share=3_000 / CLUSTER_ENTITIES,
        move_large=True,
        log=lambda line: print(line, flush=True), extra_args=(
            # the target's ring carries the moved world's frames to its
            # peers, homed on the source; a host-bound tick holds a
            # shard's event loop for seconds, so heartbeats are judged
            # over two minutes
            "--delivery-ring-bytes", str(ring),
            "--zmq-timeout-secs", "120")))
    types, samples = prom_parser.validate_exposition(
        report.pop("router_metrics"))
    flat = {n: v for n, labels, v in samples if not labels}
    health, slo = report["router_healthz"], report["router_slo"]
    if health["cluster"]["alive"] != 2 or "slo" not in health:
        raise AssertionError(f"router /healthz: {health}")
    if not slo.get("objectives") or "wql_slo_worst" not in flat:
        raise AssertionError(f"router SLO surface: {slo}")
    for i, shard in enumerate(report["shards"]):
        # 1% of the entities move, so no tick is a pure replay: every
        # dispatched tick launches K7
        if shard["knn_launches"] < shard["dispatched"]:
            raise AssertionError(f"shard {i}: knn launches {shard}")
        print(f"cluster shard {i}: {shard['sim_ticks']} sim ticks "
              f"({shard['dispatched']} dispatched, {shard['knn_launches']} "
              f"knn launches at [N, K, count] "
              f"{json.dumps(shard['knn_shapes'])}), tick p50/p99 "
              f"{shard['tick_ms_p50']}/"
              f"{shard['tick_ms_p99']} ms, apply p50 {shard['apply_ms_p50']}"
              f" ms, ring {json.dumps(shard['ring'])}", flush=True)
    mig = report["migration"]
    print(f"cluster migration of {report['moved']} shard "
          f"{report['source']} -> {report['target']}: {mig['wall_s']:.3f} s, "
          f"exported {json.dumps(mig['exported'])}, imported "
          f"{json.dumps(mig['imported'])}, {mig['replayed']} parked frames "
          f"replayed; {report['probes_across_move']} LocalMessages across "
          f"the move, each to {report['probe_recipients'][report['moved']]}"
          f" peers exactly once; {report['records']} records read back; "
          f"{report['moved_world_frames_after_flip']} entity frames from "
          "the target", flush=True)
    large = report["move_large"]
    print(f"cluster second move of {large['world']} ({large['entities']} "
          f"entities, more than a ring drain) shard {large['source']} -> "
          f"{large['target']}: {large['migration']['wall_s']:.3f} s, "
          f"exported {json.dumps(large['migration']['exported'])}, "
          f"imported {json.dumps(large['migration']['imported'])}; then "
          f"{large['target_ticks']} target ticks: the world's peers got "
          f"{large['frames_after_flip']} entity frames; inter-shard ring "
          f"over the move (shard 0, shard 1): "
          f"{json.dumps(large['ring'])}", flush=True)
    print(f"cluster router: /healthz {json.dumps(health['slo'])}, "
          f"/debug/slo state {slo['state']} over "
          f"{len(slo['objectives'])} objectives, /metrics "
          f"{len(samples)} samples strict-parsed", flush=True)
    print(f"cluster leg {report['leg_s']:.1f} s (boot {report['boot_s']:.1f}"
          f" s, register {report['register_s']:.1f} s), frames "
          f"{report['frames']}, bytes {report['bytes']}, per world "
          f"{json.dumps(report['world_frames'])}", flush=True)
    print("cluster", json.dumps({k: v for k, v in report.items() if k not in
                                 ("router_healthz", "router_slo")}),
          flush=True)
    return report


def index_matches_host(backend):
    """The cuda index's device segments against its host mirror, once
    the compaction in flight is swapped in and the host's changes are
    flushed: the base row for row (keys, second keys and peers, a
    tombstone a peer of -1 on both sides), the delta's live ``(key,
    peer)`` rows as a multiset (the device holds them sorted by key).
    Returns the live rows compared a segment; raises on a difference."""
    from worldql_server_tpu_torch.spatial.cuda_backend import PAD_KEY

    backend.wait_compaction()
    backend.flush()
    rows = {"base": 0, "delta": 0, "compactions": backend.compactions}
    if backend._base_bundle is not None:
        dev = backend._base_bundle["dev"]
        for i, (want, what) in enumerate(((backend._bk, "keys"),
                                          (backend._bk2, "second keys"),
                                          (backend._bp, "peers"))):
            got = dev[i].cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"device base {what} != host mirror")
        rows["base"] = int((backend._bp >= 0).sum())
    if backend._delta_bundle is not None:
        dev = backend._delta_bundle["dev"]
        dk, dp = dev[0].cpu().numpy(), dev[2].cpu().numpy()
        live = (dp >= 0) & (dk != int(PAD_KEY))
        got = sorted(zip(dk[live].tolist(), dp[live].tolist()))
        n = backend._dn
        hk, hp = backend._dk[:n], backend._dp[:n]
        want = sorted(zip(hk[hp >= 0].tolist(), hp[hp >= 0].tolist()))
        if got != want:
            raise AssertionError(
                f"device delta ({len(got)} live rows) != host mirror "
                f"({len(want)})")
        rows["delta"] = len(want)
    return rows


#: the catalog scenarios whose server runs on the device index (the
#: other six serve from the host index or spawn host-index shards); the
#: first three run the entity plane, whose ticks launch K7
DEVICE_SCENARIOS = ("battle_royale", "reconnect_storm", "sniper_scope",
                    "projectile_storm", "bandwidth_cap")
ENTITY_SCENARIOS = ("battle_royale", "reconnect_storm", "bandwidth_cap")


@phase("scenarios at full shape")
def phase_scenarios(torch):
    """Every scenario of the port's catalog, in its order, through
    ``run_scenario(name, shape="full")`` — the ``ci_smoke = False`` ones
    by name like the rest: a real server (or the router tier and its
    shard processes) over real ZeroMQ, each scenario's survival and SLO
    checks evaluated by the catalog itself. K7's counts are set to 0
    just before the first scenario and read just after the last. A
    scenario that does not survive, or any check that fails, fails the
    phase after all eleven have run and printed."""
    from worldql_server_tpu_torch.ops.knn import knn_select
    from worldql_server_tpu_torch.scenarios import CATALOG, run_scenario

    royale = CATALOG["battle_royale"]
    folded = {}

    class HeldToTheMirror(royale):
        """battle_royale (its compaction threshold of 8 runs the
        base+delta fold, K5 and the delta resort every few ticks), the
        index's device segments held to the host mirror after the
        drive."""

        def checks(self, ctx, slo):
            folded.update(index_matches_host(ctx.server.backend))
            return super().checks(ctx, slo)

    torch.cuda.empty_cache()  # the cluster scenarios' shards start too
    failed = []
    reports = {}
    knn_select.launches = 0  # the scenarios' run starts here
    knn_select.shapes = {}
    for name in list(CATALOG):
        before = knn_select.launches
        if name == "battle_royale":
            CATALOG[name] = HeldToTheMirror
        try:
            report = run_scenario(name, shape="full")
        finally:
            CATALOG["battle_royale"] = royale
        launched = knn_select.launches - before
        reports[name] = report
        dev = report["device"] or {}
        line = {
            "wall_s": report["wall_s"], "survived": report["survived"],
            "error": report["error"],
            "checks": [[c["name"], c["value"], c["limit"]] + (
                [] if c["ok"] else ["FAIL"]) for c in report["checks"]],
            "slo": report["slo"], "index": dev.get("index"),
            "entity_plane": dev.get("entity_plane"), "knn_launches": launched,
        }
        print(f"scenario {name}: " + json.dumps(line, default=str),
              flush=True)
        if name in DEVICE_SCENARIOS and dev.get("index") != "cuda":
            failed.append(f"{name}: index on {dev.get('index')}")
        if name in ENTITY_SCENARIOS and (
                dev.get("entity_plane") != "cuda" or launched == 0):
            failed.append(f"{name}: entity plane on "
                          f"{dev.get('entity_plane')}, {launched} K7 launches")
        if not report["survived"] or report["checks_failed"]:
            failed.append(f"{name}: " + ", ".join(
                c["name"] for c in report["checks"] if not c["ok"]))
    if not folded.get("compactions"):
        failed.append(f"battle_royale: no fold held to the mirror {folded}")
    print("battle_royale: device index == host mirror after the drive "
          f"(live rows base {folded.get('base')}, delta "
          f"{folded.get('delta')}; {folded.get('compactions')} "
          "compactions)", flush=True)
    launches = knn_select.launches  # read just after the last scenario
    shapes = [[n, k, c] for (n, k), c in sorted(knn_select.shapes.items())]
    print(f"scenarios: {len(reports)} run, walls "
          + json.dumps({n: r["wall_s"] for n, r in reports.items()})
          + f"; knn launches {launches} at [N, K, count] "
          + json.dumps(shapes), flush=True)
    if failed:
        raise AssertionError(f"scenarios failed at full shape: {failed}")
    return launches, shapes


#: BASELINE config 4 at full width (bench.py ``bench_config4``, not
#: ``--quick``): 64 worlds x 10,000 clients, 30 ticks of 16,384 queries
#: with the CSR capacity hint at 4 x queries
CONFIG4 = {"worlds": 64, "per_world": 10_000, "queries": 16_384,
           "ticks": 30}
#: the virtual meshes of the index leg, all on the one card
SHARDED_MESHES = ((1, 4), (2, 2))


def _index_ticks(backend, batches):
    """``batches`` through ``backend`` pipelined as the ticker runs them
    (dispatch tick t+1, then collect tick t on a worker thread), the
    capacity hint starting at 4 x queries. Returns the per-tick outputs
    (each query's fan-out, in lane order) and stats."""
    from concurrent.futures import ThreadPoolExecutor

    backend._delivery_cap = 4 * len(batches[0][0])
    outs, ticks = [], []

    def collect(handle):
        out = backend.collect_local_batch(handle)
        return out, dict(backend.last_collect_stats)

    with ThreadPoolExecutor(1) as pool:
        pending = None

        def finish(item):
            t_d, fut = item
            out, fetched = fut.result()
            ticks.append({"tick_ms": (time.perf_counter() - t_d) * 1e3,
                          **fetched})
            outs.append(out)

        for b in batches:
            t_d = time.perf_counter()
            fut = pool.submit(collect, backend.dispatch_staged_batch(*b))
            if pending is not None:
                finish(pending)
            pending = (t_d, fut)
        finish(pending)
    steady = ticks[1:]
    return outs, {
        "tick_ms": _ms_stats([r["tick_ms"] for r in steady]),
        "fetch_bytes_p50": _ms_stats([r["fetch_bytes"] for r in steady])[
            "p50"],
        "fanout_per_tick": _ms_stats([sum(map(len, o)) for o in outs])[
            "p50"],
    }


def _op_times(torch, single, mesh, batch, flush):
    """CUDA-event ms of each K12 program on ``mesh`` beside its
    single-card counterpart on ``single``, on the same index and one
    batch: the CSR match (all shards + merges), one shard's match, the
    merge of the flat partials, the pack, and the fold of base + delta."""
    from worldql_server_tpu_torch.ops.index import (
        CSR_ROW, _device_compact, pack_csr, run_bounds_all,
        run_csr_assemble)
    from worldql_server_tpu_torch.spatial.hashing import PAD_KEY, next_pow2
    from worldql_server_tpu_torch.tools.knn_bench import cuda_time_ms

    out = {}
    for name, b in (("single", single), ("mesh", mesh)):
        b.flush()
        segs, ks, kinds = b._segments()
        q = b._prepare_queries(*batch)
        cap = b._csr_effective_cap(next_pow2(max(
            4 * len(batch[0]), CSR_ROW * q[0].shape[0] * len(segs) + 64)),
            q, segs)
        counts, flat, total = b._dispatch_csr(q, segs, ks, kinds, cap)
        bucket = next_pow2(max(2 * int(total), 1024))
        row = {"t_cap": cap, "segments": list(kinds),
               "csr_ms": cuda_time_ms(
                   lambda: b._dispatch_csr(q, segs, ks, kinds, cap), 5,
                   flush)}
        if b is single:
            row["pack_ms"] = cuda_time_ms(
                lambda: pack_csr(counts, flat, bucket=bucket), 5, flush)
        else:
            row["pack_ms"] = cuda_time_ms(
                lambda: b._pack_rows(counts, flat, bucket // b.n_batch), 5,
                flush)
            lsegs = b._local_segs(segs, 0, 0)
            rq = b._row_queries(q, 0, 0)

            def shard_match():
                los, cnts = run_bounds_all(lsegs, rq)
                return run_csr_assemble(lsegs, los, cnts, cnts, rq,
                                        cap // b.n_batch)
            row["shard_match_ms"] = cuda_time_ms(shard_match, 5, flush)
            fl = cap // b.n_batch
            parts = {(r, s): flat[r * fl:(r + 1) * fl].clone()
                     for r in range(b.n_batch) for s in range(b.n_space)}
            row["merge_ms"] = cuda_time_ms(
                lambda: b._merge(parts, (fl,), -1), 5, flush)
            row["mesh"] = b.mesh.shape
        # the fold of base + delta into a fresh base, as a compaction
        # runs it (the mesh: per shard over the old key ranges), at the
        # base's current (shard) capacity
        if b._delta_buf is not None and b._base_bundle is not None:
            base = b._base_bundle
            if b is single:
                bk, bk2, bp = base["dev"][:3]
                row["fold_ms"] = cuda_time_ms(lambda: _device_compact(
                    bk, bk2, bp, *b._delta_buf, cap2=base["cap"],
                    n_buckets=base["dev"][4].shape[0]), 5, flush)
            else:
                splits = base["splits"]
                bounds = np.empty(b.n_space + 1, np.int64)
                bounds[0] = np.iinfo(np.int64).min
                bounds[-1] = np.int64(PAD_KEY)
                for s in range(1, b.n_space):
                    bounds[s] = b._bk[int(splits[s])]
                cap2 = base["shard_cap"]
                row["fold_ms"] = cuda_time_ms(lambda: b._fold_shards(
                    base["dev"][:3], b._delta_buf, bounds, cap2,
                    base["dev"][4].shape[1]), 5, flush)
        out[name] = row
    return out


@phase("sharded mesh")
def phase_sharded(torch, device="cuda", c4=None, n_two=262_144):
    """The mesh index (``parallel/``) on the card.

    Index leg: BASELINE config 4 at full width — 640,000 subscriptions
    in 64 worlds (``tools/index_bench.py::build_index``), 30 ticks of
    16,384 staged queries pipelined as the ticker runs them — on
    ``ShardedCudaSpatialBackend`` over the virtual meshes (1,4) and
    (2,2) of ``cuda:0``: every tick's fan-out equal, lane for lane, to
    the single-card ``CudaSpatialBackend``'s and sampled ticks to the
    cpu index's; then churn folded on the device with no re-upload, a
    forced imbalance that re-shards through one, and each K12 program's
    CUDA-event time beside the single-card index's. Served leg: an
    in-process entity-sim server on a 2 x 2 mesh (config 3's shape at
    10,000 entities), K7 launched. CLI leg: ``python -m
    worldql_server_tpu_torch --spatial-backend sharded --mesh-batch 1
    --mesh-space 1`` boots on the card and a mesh larger than the card
    is a config error. Two-process leg: two gloo ranks on the one card
    run one batch of one seeded index, held to the one-process mesh.
    ``device="cpu"`` with a small ``c4`` rehearses the phase on the
    CPU (no op timings there)."""
    import subprocess
    import urllib.request

    from worldql_server_tpu_torch.parallel import (
        ShardedCudaSpatialBackend, make_fanout_mesh)
    from worldql_server_tpu_torch.spatial.cpu_backend import (
        CpuSpatialBackend)
    from worldql_server_tpu_torch.spatial.cuda_backend import (
        CudaSpatialBackend)
    from worldql_server_tpu_torch.spatial.quantize import cube_coords_batch
    from worldql_server_tpu_torch.tools import mesh_drive
    from worldql_server_tpu_torch.tools.index_bench import (
        build_index, make_query_batch)

    c4 = c4 or CONFIG4
    n_subs = c4["worlds"] * c4["per_world"]
    worlds = [f"world_{w}" for w in range(c4["worlds"])]
    on_card = device == "cuda"
    grid = ["cuda:0" if on_card else "cpu"] * 4

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def load(backend):
        t0 = time.perf_counter()
        got = build_index(backend, np.random.default_rng(SEED + 4), n_subs,
                          c4["worlds"])
        backend.flush()
        backend.wait_compaction()
        sync()
        return got, time.perf_counter() - t0

    single = CudaSpatialBackend(16, device=device)
    (peers, pos, wids), load_s = load(single)
    qrng = np.random.default_rng(SEED + 44)
    batches = [make_query_batch(qrng, pos, wids, c4["queries"])
               for _ in range(c4["ticks"])]
    ref = CpuSpatialBackend(16)
    cubes = cube_coords_batch(pos, 16)
    for w in range(c4["worlds"]):
        sel = np.flatnonzero(wids == w)
        ref.bulk_add_subscriptions(worlds[w], [peers[i] for i in sel],
                                   cubes[sel])
    want, single_stats = _index_ticks(single, batches)
    sample = (1, c4["ticks"] // 2, c4["ticks"] - 1)
    oracle = {t: _cpu_fanout(ref, worlds, peers, batches[t]) for t in sample}
    del ref
    for t in sample:
        _same_fanout(want[t], oracle[t], f"config-4 single-card tick {t}")
    report = {"subscriptions": n_subs, "worlds": c4["worlds"],
              "queries": c4["queries"], "ticks": c4["ticks"],
              "single": {"load_s": load_s, **single_stats}}
    print("sharded index single-card", json.dumps(report["single"]),
          flush=True)

    meshes = {}
    for shape in SHARDED_MESHES:
        mesh = ShardedCudaSpatialBackend(
            16, make_fanout_mesh(*shape, devices=grid))
        meshes[shape] = mesh
        _, m_load = load(mesh)
        if mesh.subscription_count() != single.subscription_count():
            raise AssertionError(f"mesh {shape}: subscriptions differ")
        outs, stats = _index_ticks(mesh, batches)
        for t, (got, exp) in enumerate(zip(outs, want)):
            if got != exp:
                bad = sum(a != b for a, b in zip(got, exp))
                raise AssertionError(
                    f"mesh {shape} tick {t}: {bad} queries differ from the "
                    "single-card index (lane order included)")
        for t in sample:
            _same_fanout(outs[t], oracle[t], f"config-4 mesh {shape} tick {t}")
        if mesh._base_bundle is None:
            raise AssertionError(f"mesh {shape}: no base segment")
        row = {"mesh": shape, "load_s": m_load, **stats,
               "splits": mesh._base_bundle["splits"].tolist(),
               "shard_cap": mesh._base_bundle["shard_cap"],
               "ticks_equal_single_card": len(outs),
               "ticks_checked_against_cpu": list(sample)}
        print("sharded index mesh", json.dumps(row), flush=True)
        report[f"mesh_{shape[0]}x{shape[1]}"] = row
    del want, oracle, outs

    # churn on the (2,2) mesh and the single card alike: a fold on the
    # device (no upload), then a forced imbalance (one re-upload)
    mesh = meshes[(2, 2)]
    uploads = []
    real_upload = mesh._upload_base

    def counted(*a, **kw):
        uploads.append(len(a[0]))
        return real_upload(*a, **kw)

    mesh._upload_base = counted
    crng = np.random.default_rng(SEED + 45)

    def churn(n):
        idx = crng.choice(n_subs, n, replace=False)
        new = cubes[idx] + crng.integers(-1, 2, (n, 3)) * 16
        for w in range(c4["worlds"]):
            sel = idx[wids[idx] == w]
            if not sel.size:
                continue
            ps = [peers[i] for i in sel]
            old, nw = cubes[sel], new[wids[idx] == w]
            for b in (single, mesh):
                b.bulk_move_subscriptions(worlds[w], ps, old, ps, nw)
        cubes[idx] = new
        for b in (single, mesh):
            b._compact_threshold_override = n // 4
            b.flush()
            b.wait_compaction()
            b._compact_threshold_override = None
        check = batches[0]
        got = mesh.collect_local_batch(mesh.dispatch_staged_batch(*check))
        exp = single.collect_local_batch(
            single.dispatch_staged_batch(*check))
        if got != exp:
            raise AssertionError("mesh != single card after the fold")

    n_churn = min(20_000, n_subs // 4)
    before = mesh.compactions
    churn(n_churn)
    folds = mesh.compactions - before
    if folds < 1 or uploads:
        raise AssertionError(f"fold: {folds} compactions, uploads {uploads}")
    # an index holding a delta for the op timings below
    idx = crng.choice(n_subs, n_churn // 4, replace=False)
    for b in (single, mesh):
        for w in range(4):
            sel = idx[wids[idx] == w]
            b.bulk_add_subscriptions(worlds[w], [peers[i] for i in sel],
                                     cubes[sel] + 16 * 3)
        b.flush()
    ops = None
    if on_card:
        flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
        ops = _op_times(torch, single, mesh, batches[2], flush)
        del flush
    print("sharded ops ms", json.dumps(ops), flush=True)
    mesh.RESHARD_IMBALANCE = -1.0
    churn(n_churn)
    if not uploads:
        raise AssertionError("the forced imbalance did not re-shard")
    report["fold"] = {"device_folds": folds, "uploads_after_imbalance":
                      len(uploads), "compactions": mesh.compactions}
    report["ops_ms"] = ops
    print(f"sharded fold: {folds} compaction(s) folded on the device with "
          f"no upload; the forced imbalance re-uploaded {len(uploads)} "
          "time(s); fan-out equal to the single card after each",
          flush=True)
    del meshes, mesh, single
    if on_card:
        torch.cuda.empty_cache()

    # served: entity-sim on a 2 x 2 mesh of the card, 10,000 entities
    ((served, launches),) = asyncio.run(drive_server(
        torch, n_entities=10_000, mixes=((1.0, 3),), extra_args=(
            "--spatial-backend", "sharded", "--mesh-batch", "2",
            "--mesh-space", "2"), device=device, mesh_devices=grid))
    # K7 launches on the card only (the CPU runs its plain version)
    if not served["device"].startswith(device) or (on_card and (
            launches == 0 or launches < served["dispatched"])):
        raise AssertionError(f"sharded server: {served['device']}, knn "
                             f"launches {launches}")
    print("sharded server", json.dumps(served), flush=True)
    report["served"] = {k: served[k] for k in (
        "entities", "ticks", "dispatched", "tick_ms_p50", "tick_ms_p99",
        "apply_ms_p50", "knn_shapes", "device", "boot_s")}

    # the CLI: a 1 x 1 mesh boots on the card; 2 x 4 is a config error
    env = {k: v for k, v in os.environ.items() if k != "WQL_TORCH_DEVICE"}
    if not on_card:
        env["WQL_TORCH_DEVICE"] = "cpu"
    base = [sys.executable, "-m", "worldql_server_tpu_torch",
            "--spatial-backend", "sharded", "--no-ws", "--no-zmq",
            "--store-url", "memory://"]
    big = subprocess.run(base + ["--mesh-batch", "2", "--mesh-space", "4",
                                 "--no-http"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    if big.returncode != 1 or "exceeds" not in big.stderr:
        raise AssertionError(f"2 x 4 mesh on one card: rc {big.returncode}"
                             f" {big.stderr[-400:]}")
    import socket as _socket

    with _socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.Popen(base + ["--mesh-batch", "1", "--mesh-space",
                                    "1", "--http-port", str(port)],
                            cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    try:
        health = None
        while time.perf_counter() - t0 < 180 and proc.poll() is None:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                time.sleep(0.5)
        if health is None or not str(
                (health.get("device") or {}).get("index")).startswith(device):
            raise AssertionError(f"CLI sharded boot: {health}")
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    report["cli"] = {"boot_s": time.perf_counter() - t0,
                     "device": health["device"],
                     "oversized_mesh": big.stderr.strip().splitlines()[-1]}
    print("sharded cli", json.dumps(report["cli"]), flush=True)

    # two gloo ranks on the one card, one seeded index, one batch
    outs = mesh_drive.spawn(2, n_subs=n_two, m=c4["queries"], timeout=400,
                            device=None if on_card else "cpu")
    for out in outs:
        if not out.get("ok"):
            raise AssertionError(f"two-process leg: {out}")
    if not outs[0].get("checked") or outs[0]["digest"] != outs[1]["digest"]:
        raise AssertionError(f"two-process leg: {outs}")
    report["two_process"] = [{k: o.get(k) for k in (
        "rank", "mesh", "device", "shard_rows", "batch_ms", "fanout",
        "backend")} for o in outs]
    print("sharded two-process", json.dumps(report["two_process"]),
          flush=True)
    print("sharded", json.dumps(report), flush=True)
    return report, launches, served["knn_shapes"]


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "worldql_server_tpu_torch")):
        print("chip_smoke: worldql_server_tpu_torch/ not found beside this "
              "script — run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card — nothing to check",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    os.environ.pop("WQL_TORCH_DEVICE", None)  # the port's default: cuda
    t_all = time.perf_counter()
    build_native_codec()
    from worldql_server_tpu_torch.tools.knn_bench import card_rates

    line = phase_card(torch)
    name = torch.cuda.get_device_name(0)
    rates = card_rates()
    print(f"rates: {json.dumps(rates)}")
    phase_build()
    knn_rows = phase_knn(torch, rates)
    tick_rows = phase_tick(torch)
    phase_index_ops(torch)
    phase_query_kernels(torch)
    phase_fanout(torch)
    _, sharded_launches, sharded_shapes = phase_sharded(torch)
    phase_queries(torch)
    phase_churn(torch)
    phase_resilience(torch)
    phase_local_messages(torch)
    report, launches, lean_launches, shapes = phase_server(torch)
    cluster = phase_cluster(torch)
    cluster_launches = sum(s["knn_launches"] for s in cluster["shards"])
    scenario_launches, scenario_shapes = phase_scenarios(torch)
    path_rows = phase_knn_paths(torch, rates, {
        **shapes, **{f"cluster_shard{i}": s["knn_shapes"]
                     for i, s in enumerate(cluster["shards"])},
        "scenarios": scenario_shapes, "sharded": sharded_shapes})

    main_row = knn_rows[0]  # N=131,072, K=32: the server phase's shape
    kernels = {"kernels": [{
        "name": "knn_select",
        "route": "cuda",
        "source": "worldql_server_tpu_torch/csrc/knn_select.cu",
        "replaces": "worldql_server_tpu/ops/knn_pallas.py:174",
        # each path driven with the count set to 0 just before it and
        # read just after: the all-moving entity-sim server and the
        # interest + delivery-workers server; the cluster's shards are
        # processes of their own, so theirs is each shard's count
        # (/healthz) after the last tick less its count before the peers
        # registered; the scenarios' count spans the eleven scenarios;
        # the sharded path is the entity-sim server on the 2 x 2 mesh
        "launches": (launches + lean_launches + cluster_launches
                     + scenario_launches + sharded_launches),
        "launches_by_path": {"entity_sim": launches,
                             "entity_sim_interest_delivery": lean_launches,
                             "cluster": cluster_launches,
                             "scenarios": scenario_launches,
                             "sharded": sharded_launches},
        "max_abs_err": max(r["max_abs_err"] for r in knn_rows + path_rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "kernel": main_row["kernel"],
        "regs": main_row["regs"],
        "spill_bytes": main_row["spill_bytes"],
        "smem_bytes": main_row["smem_bytes"],
        "shapes": knn_rows,
        # every (N, K) the driven paths launched, held to the plain
        # version and timed, with its launches by path
        "path_shapes": path_rows,
        "tick": tick_rows,
    }]}
    print(f"total wall {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps(kernels))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
