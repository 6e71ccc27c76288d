"""Multi-process drive of the mesh index: N ranks, one process group.

Each rank joins the group through ``maybe_initialize_distributed()``
(the ``WQL_DIST_*`` contract a multi-process server uses), builds the
fan-out mesh over every rank's devices (``make_fanout_mesh(1, None)``:
the ``space`` axis split across the ranks), loads the same seeded index
into ``ShardedCudaSpatialBackend`` — a base segment folded on the
device, a delta segment, tombstones in both — and runs one batch of
queries through the dense and the CSR dispatch; the merge is one
``all_reduce(MAX)`` over the group. Rank 0 holds the result, exactly,
to the same mesh shape in one process (virtual shards on its own
device) and, as fan-out sets, to the port's ``CpuSpatialBackend``. Each
rank prints one JSON line.

    python -m worldql_server_tpu_torch.tools.mesh_drive --ranks 2 [--subs N] [--queries M]

spawns the ranks (gloo: it takes two ranks on one card, where NCCL
refuses them) and prints their verdicts; :func:`spawn` does the same
for a caller. The device is the port's
default (the card) unless ``WQL_TORCH_DEVICE`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
import traceback
import uuid

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build(backend, seed: int, n_subs: int):
    """The seeded index: ``n_subs`` subscriptions of 64 peers in one
    world, folded into the base on the device; 40 more in the delta;
    every 97th base row removed. Returns ``(peers, positions)``."""
    from ..spatial.quantize import cube_coords_batch

    rng = np.random.default_rng(seed)
    peers = [uuid.UUID(int=0xD000 + i) for i in range(64)]
    pos = rng.uniform(-400, 400, (n_subs, 3))
    backend.bulk_add_subscriptions(
        "w", [peers[i % 64] for i in range(n_subs)],
        cube_coords_batch(pos, 16))
    backend.flush()
    if hasattr(backend, "wait_compaction"):
        backend.wait_compaction()  # the load folds into the base
    for i in range(40):
        p = tuple(float(v) for v in rng.uniform(-400, 400, 3))
        backend.add_subscription("w", peers[i], p)
    for i in range(0, n_subs, 97):
        backend.remove_subscription(
            "w", peers[i % 64],
            tuple(int(c) for c in cube_coords_batch(pos[i:i + 1], 16)[0]))
    backend.flush()
    return peers, pos


def _query_batch(backend, peers, pos, m: int, seed: int):
    rng = np.random.default_rng(seed)
    qpos = pos[rng.integers(0, len(pos), m)]
    senders = rng.integers(-1, len(peers), m)
    sid = np.array([backend._peer_ids[peers[s]] if s >= 0 else -1
                    for s in senders], np.int32)
    return (np.zeros(m, np.int32), qpos, sid,
            rng.integers(0, 3, m).astype(np.int8)), senders


def _results(backend, batch, csr_cap):
    dense = backend.match_arrays(*batch)
    _, csr = backend.match_arrays_async(*batch, csr_cap=csr_cap)
    from ..spatial.cuda_backend import _to_host

    return dense, [_to_host(t) for t in csr]


def run_rank(n_subs: int = 3000, m: int = 300, seed: int = 7) -> dict:
    """One rank's drive (``WQL_DIST_*`` set). Returns its verdict."""
    out: dict = {"rank": int(os.environ["WQL_DIST_PROCESS_ID"])}
    try:
        import torch.distributed as dist

        from ..parallel import (
            ShardedCudaSpatialBackend, make_fanout_mesh,
            maybe_initialize_distributed)
        from ..protocol.types import Replication, Vector3
        from ..spatial.backend import LocalQuery
        from ..spatial.cpu_backend import CpuSpatialBackend

        if not maybe_initialize_distributed():
            raise RuntimeError("WQL_DIST_* env not honored")
        out["world_size"] = dist.get_world_size()
        out["backend"] = dist.get_backend()
        mesh = make_fanout_mesh(1, None)  # space = every rank's device
        out["mesh"] = mesh.shape
        out["ranks"] = mesh.ranks
        out["local"] = mesh.local_positions()
        threshold = max(256, n_subs // 16)
        dev = ShardedCudaSpatialBackend(16, mesh,
                                        compact_threshold=threshold)
        out["device"] = str(dev.device)
        peers, pos = build(dev, seed, n_subs)
        out["segments"] = list(dev._segments()[2])
        out["shard_rows"] = [int(c) for c in
                             np.diff(dev._base_bundle["splits"])]
        batch, senders = _query_batch(dev, peers, pos, m, seed + 1)
        csr_cap = 1 << max(16, (8 * m * 2).bit_length())
        t0 = time.perf_counter()
        dense, (counts, flat, total) = _results(dev, batch, csr_cap)
        out["batch_ms"] = (time.perf_counter() - t0) * 1e3
        out["fanout"] = int((dense >= 0).sum())
        out["digest"] = [int(dense.astype(np.int64).sum()),
                         int(counts.sum()), int(flat.astype(np.int64).sum()),
                         int(total)]
        if out["rank"] == 0:
            one = ShardedCudaSpatialBackend(
                16, make_fanout_mesh(
                    1, None, devices=[dev.device] * mesh.shape["space"]),
                compact_threshold=threshold)
            build(one, seed, n_subs)
            want_dense, want_csr = _results(one, batch, csr_cap)
            if not np.array_equal(dense, want_dense):
                raise AssertionError("dense != the one-process mesh")
            for a, b in zip((counts, flat, total), want_csr):
                if not np.array_equal(a, b):
                    raise AssertionError("csr != the one-process mesh")
            ref = CpuSpatialBackend(16)
            build(ref, seed, n_subs)
            got = dev._decode_csr(counts, flat, m)
            want = ref.match_local_batch([
                LocalQuery("w", Vector3(*map(float, p)),
                           peers[s] if s >= 0 else None, Replication(int(r)))
                for p, s, r in zip(batch[1], senders, batch[3])])
            if [set(g) for g in got] != [set(w) for w in want]:
                raise AssertionError("fan-out != the cpu index")
            out["checked"] = True
        dist.destroy_process_group()
        out["ok"] = True
    except Exception as exc:  # the verdict carries it to the spawner
        out["ok"] = False
        out["error"] = f"{type(exc).__name__}: {exc}"
        out["trace"] = traceback.format_exc()[-1500:]
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(ranks: int = 2, *, n_subs: int = 3000, m: int = 300,
          device: str | None = None, timeout: float = 180.0) -> list[dict]:
    """Run ``ranks`` rank processes of this module and return their
    verdicts (a rank that printed none gets ``{"ok": False, "error":
    ...}``). Every process is stopped before this returns."""
    port = _free_port()
    procs = []
    for rank in range(ranks):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("WQL_DIST_")}
        env.update({
            "WQL_DIST_COORDINATOR": f"127.0.0.1:{port}",
            "WQL_DIST_NUM_PROCESSES": str(ranks),
            "WQL_DIST_PROCESS_ID": str(rank),
            "PYTHONPATH": ROOT,
        })
        if device is not None:
            env["WQL_TORCH_DEVICE"] = device
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "worldql_server_tpu_torch.tools.mesh_drive",
             "--rank", "--subs", str(n_subs), "--queries", str(m)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=env))
    outs = []
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            stdout, stderr = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            return [{"ok": False, "error": f"timed out after {timeout} s"}]
        lines = [line for line in stdout.splitlines() if line.strip()]
        if p.returncode != 0 or not lines:
            outs.append({"ok": False, "error": (
                f"exited rc={p.returncode}: {stderr[-800:]}")})
        else:
            outs.append(json.loads(lines[-1]))
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", action="store_true",
                    help="run as one rank (WQL_DIST_* set by the spawner)")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--subs", type=int, default=3000)
    ap.add_argument("--queries", type=int, default=300)
    args = ap.parse_args(argv)
    if args.rank:
        print(json.dumps(run_rank(args.subs, args.queries)), flush=True)
        return 0
    outs = spawn(args.ranks, n_subs=args.subs, m=args.queries)
    for out in outs:
        print(json.dumps(out))
    return 0 if all(o.get("ok") for o in outs) else 1


if __name__ == "__main__":
    sys.exit(main())
