#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``worldql_server_tpu_torch``).

Run from the repository root on a host with one NVIDIA card:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``worldql_server_tpu_torch/
csrc/`` with ``nvcc`` (and ``native/libwqlcodec.so`` with ``make`` when it
is missing), then:

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
5. drives the server's main path: ``Config`` → ``WorldQLServer`` as
   ``python -m worldql_server_tpu_torch --entity-sim`` builds them, 64
   peers with in-memory sinks register 100,000 entities with velocities
   in 4 worlds through the router / ``ColumnarIngest`` path, and the
   ticker serves sim ticks at k=32 with every kernel's launch counter
   reset just before and read just after — twice: at least 10 ticks
   with every entity moving (full ticks), then at least 5 with 1%
   moving (delta ticks at pow2 sub-tiers); sampled frames are decoded
   and checked;
6. prints one ``{"kernels": [...]}`` JSON line, the card line, and as
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
import subprocess
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


@phase("build")
def phase_build():
    from worldql_server_tpu_torch.ops import build

    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(REPO, "native", "libwqlcodec.so")):
        subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                       check=True, capture_output=True)
        print(f"native codec built in {time.perf_counter() - t0:.2f} s")
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


@phase("knn kernel vs plain")
def phase_knn(torch, rates):
    from worldql_server_tpu_torch.ops.knn import (
        kernel_info, knn_select, knn_select_plain)
    from worldql_server_tpu_torch.tools.knn_bench import (
        ITERS, SHAPES, cuda_time_ms, knn_bound, zipf_world)

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    rows = []
    for n, k in SHAPES:
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


async def drive_server(torch, n_entities=100_000, n_peers=64, n_worlds=4,
                       min_ticks=10, moving=1.0, device=None):
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

    args = build_parser().parse_args([
        "--entity-sim", "--entity-k", "32", "--entity-max", "131072",
        "--tick-interval", "0.05", "--store-url", "memory://",
        "--no-ws", "--no-http", "--no-zmq",
    ])
    config = config_from_args(args)
    apply_device_boot_defaults(config, interval_explicit=True)
    config.validate()

    knn_select.launches = 0  # the main path's run starts here
    server = WorldQLServer(config, device=device)
    plane = server.entity_plane
    await server.start()
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
    for p in peers:
        await server.peer_map.insert(Peer(
            p, f"mem:{p.hex[:8]}", send_raw, kind="memory",
            try_write=lambda f: sink_many([f]), try_write_many=sink_many,
        ))

    rng = np.random.default_rng(SEED)
    pos = rng.uniform(-120, 120, (n_entities, 3))
    vel = rng.uniform(-20, 20, (n_entities, 3)).astype(np.float32)
    vel[rng.random(n_entities) >= moving] = 0.0
    worlds = [f"world{w}" for w in range(n_worlds)]
    datas = []
    for pi, p in enumerate(peers):
        for wi, w in enumerate(worlds):
            idx = np.arange(pi * n_worlds + wi, n_entities,
                            n_peers * n_worlds)
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

    async def slow_route(data):
        await server.router.handle_message(deserialize_message(data))

    t0 = time.perf_counter()
    for c0 in range(0, len(datas), 64):
        await server.entity_ingest.process_batch(datas[c0:c0 + 64],
                                                 slow_route)
        await asyncio.sleep(0)
    ingest_s = time.perf_counter() - t0
    if plane.entity_count != n_entities:
        raise AssertionError(
            f"{plane.entity_count} of {n_entities} entities registered")

    # serve: sample each applied tick's stage times until min_ticks
    start_applied = plane.applied_ticks
    start_disp = plane.dispatches
    start_replay = plane.delta_sim_ticks
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
            })
    await server.stop()
    launches = knn_select.launches  # read just after the main path

    stats = plane.stats()
    ticks = plane.applied_ticks - start_applied
    dispatched = plane.dispatches - start_disp
    delta_ticks = plane.delta_sim_ticks - start_replay
    if stats["scatter_fallbacks"] != 0:
        raise AssertionError(f"scatter fell back: {stats}")
    if stats["dropped_ticks"] != 0:
        raise AssertionError(f"dropped ticks: {stats}")
    served = sunk["frames"] - frames_before
    if served <= 0:
        raise AssertionError("no frame reached the sinks")
    # what came out is right in form: decoded neighbour frames of
    # registered entities, at finite positions inside the world bounds
    registered = {(1 << 100) + i for i in range(n_entities)}
    frames_seen = 0
    for data in sample:
        msg = deserialize_message(data)
        if msg.parameter != "entity.frame":
            continue  # PeerConnect notices of the peer inserts
        frames_seen += 1
        ent = msg.entities[0]
        p = (ent.position.x, ent.position.y, ent.position.z)
        if (ent.uuid.int not in registered or msg.sender_uuid not in peers
                or not all(np.isfinite(p))
                or max(map(abs, p)) > config.entity_bounds):
            raise AssertionError(f"malformed neighbour frame: {msg}")
    if frames_seen == 0:
        raise AssertionError("no entity.frame among the sampled frames")
    frames_per_tick = [b["frames"] - a["frames"]
                       for a, b in zip(samples, samples[1:])]

    def pct(key, q):
        vals = sorted(s[key] for s in samples[1:])
        return vals[min(len(vals) - 1, int(q * len(vals)))]

    report = {
        "entities": plane.entity_count, "peers": n_peers,
        "worlds": n_worlds, "k": plane.k, "capacity": stats["capacity"],
        "ingest_s": ingest_s, "ticks": ticks, "dispatched": dispatched,
        "delta_sim_ticks": delta_ticks, "full_sim_ticks":
            stats["full_sim_ticks"], "knn_launches": launches,
        "tick_ms_p50": pct("tick_ms", 0.5),
        "tick_ms_p99": pct("tick_ms", 0.99),
        "integrate_ms_p50": pct("integrate_ms", 0.5),
        "collect_ms_p50": pct("collect_ms", 0.5),
        "apply_ms_p50": pct("apply_ms", 0.5),
        "frames_per_tick": statistics.median(frames_per_tick)
        if frames_per_tick else 0,
        "frames_to_sinks": served, "bytes_to_sinks": sunk["bytes"],
        "scatter_fallbacks": stats["scatter_fallbacks"],
        "dropped_ticks": stats["dropped_ticks"],
        "warmup": server.precompile_stats,
        "device": str(plane.device),
        "moving": moving, "frames_checked": frames_seen,
    }
    return report, launches


@phase("server on the card")
def phase_server(torch):
    report, launches = asyncio.run(drive_server(torch, moving=1.0))
    print("server", json.dumps(report), flush=True)
    idle, idle_launches = asyncio.run(
        drive_server(torch, moving=0.01, min_ticks=5))
    print("server", json.dumps(idle), flush=True)
    for rep, n in ((report, launches), (idle, idle_launches)):
        if rep["device"] != "cuda":
            raise AssertionError(f"entity plane on {rep['device']}")
        if n == 0 or n < rep["dispatched"]:
            raise AssertionError(
                f"knn launches {n} < ticks dispatched {rep['dispatched']}")
    if idle["delta_sim_ticks"] == 0:
        raise AssertionError("the 1%-moving run served no delta tick")
    print(f"knn launches: {launches} (all moving), {idle_launches} "
          "(1% moving)")
    try:
        import zmq  # noqa: F401
        have_zmq = True
    except ImportError:
        have_zmq = False
    print(f"zmq leg ran: false (pyzmq importable: {have_zmq}; the ZMQ "
          "transport is held to the JAX server by tests/test_torch_server.py)")
    return report, launches


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
    from worldql_server_tpu_torch.tools.knn_bench import card_rates

    line = phase_card(torch)
    name = torch.cuda.get_device_name(0)
    rates = card_rates()
    print(f"rates: {json.dumps(rates)}")
    phase_build()
    knn_rows = phase_knn(torch, rates)
    tick_rows = phase_tick(torch)
    report, launches = phase_server(torch)

    main_row = knn_rows[0]  # N=131,072, K=32: the server phase's shape
    kernels = {"kernels": [{
        "name": "knn_select",
        "route": "cuda",
        "source": "worldql_server_tpu_torch/csrc/knn_select.cu",
        "replaces": "worldql_server_tpu/ops/knn_pallas.py:174",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in knn_rows),
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
