"""``CudaSpatialBackend(device="cpu")`` against the JAX package's
``TpuSpatialBackend`` (JAX on the CPU) and the port's
``CpuSpatialBackend``, on the same seeded mutations and query batches.

Tolerance: exact. Against the JAX backend every query's target list is
equal in order (both walk the same segments in the same layout); against
the CPU backend, whose AreaMap has no order, as a set. Background
compactions are drained before each dispatch where two backends are
compared lane for lane, so both serve the same segment layout; the
in-flight case has its own test, which holds the worker at a gate while
the serving side mutates.
"""

from __future__ import annotations

import threading
import uuid

import numpy as np
import pytest
import torch

from worldql_server_tpu.spatial.backend import LocalQuery as JQuery
from worldql_server_tpu.protocol.types import (
    Replication as JRepl, Vector3 as JVec)
from worldql_server_tpu.spatial.tpu_backend import TpuSpatialBackend
from worldql_server_tpu_torch.protocol.types import Replication, Vector3
from worldql_server_tpu_torch.spatial import cuda_backend as cb
from worldql_server_tpu_torch.spatial.backend import LocalQuery
from worldql_server_tpu_torch.spatial.cpu_backend import CpuSpatialBackend
from worldql_server_tpu_torch.spatial.cuda_backend import CudaSpatialBackend
from worldql_server_tpu_torch.spatial.precompile import precompile_tiers
from worldql_server_tpu_torch.spatial.quantize import cube_coords_batch
from worldql_server_tpu_torch.tools.index_bench import (
    mixed_cols, query_results_match)

CUBE = 16
WORLDS = ("w0", "w1")


def _peers(n):
    return [uuid.UUID(int=0xA000 + i) for i in range(n)]


class Trio:
    """The same mutations applied to the three backends."""

    def __init__(self, n_peers=600, threshold=256, delta_ticks=True):
        self.t = CudaSpatialBackend(CUBE, threshold, device="cpu")
        self.j = TpuSpatialBackend(CUBE, threshold)
        self.c = CpuSpatialBackend(CUBE)
        for b in (self.t, self.j):
            b.configure_delta_ticks("on" if delta_ticks else "off")
        self.peers = _peers(n_peers)
        self.rows: set[tuple] = set()  # (world, peer index, cube)

    def add(self, world, idx, cubes):
        peers = [self.peers[i] for i in idx]
        n = [b.bulk_add_subscriptions(world, peers, cubes)
             for b in (self.t, self.j, self.c)]
        assert n[0] == n[1]
        for i, cube in zip(idx, cubes):
            self.rows.add((world, int(i), tuple(int(c) for c in cube)))

    def move(self, world, idx, old, new):
        peers = [self.peers[i] for i in idx]
        moved = [b.bulk_move_subscriptions(world, peers, old, peers, new)
                 for b in (self.t, self.j)]
        assert moved[0] == moved[1]
        for i, o, c in zip(idx, old, new):
            self.c.remove_subscription(world, self.peers[i],
                                       tuple(int(v) for v in o))
            self.c.add_subscription(world, self.peers[i],
                                    tuple(int(v) for v in c))

    def remove_one(self, world, i, cube):
        got = [b.remove_subscription(world, self.peers[i], cube)
               for b in (self.t, self.j, self.c)]
        assert got[0] == got[1] == got[2]

    def remove_peer(self, i):
        got = [b.remove_peer(self.peers[i]) for b in (self.t, self.j, self.c)]
        assert got[0] == got[1] == got[2]

    def batch(self, rng, m, spots):
        """A staged query batch: from subscribed spots (hits) and random
        points (misses), every replication mode, known and unknown
        senders."""
        pick = rng.integers(0, len(spots), m)
        pos = np.asarray(spots, np.float64)[pick] + rng.uniform(0, 1, (m, 3))
        miss = rng.random(m) < 0.2
        pos[miss] = rng.uniform(-500, 500, (int(miss.sum()), 3))
        wid = rng.integers(0, len(WORLDS), m).astype(np.int32)
        sid = rng.integers(-1, len(self.peers), m).astype(np.int32)
        repl = rng.integers(0, 3, m).astype(np.int8)
        return wid, pos, sid, repl

    def check(self, batch, *, drain=True):
        """Dispatch on all three; the port equals JAX lane for lane and
        the CPU backend as sets. Returns the port's result."""
        if drain:
            self.t.wait_compaction()
            self.j.wait_compaction()
        wid, pos, sid, repl = batch
        got = self.t.collect_local_batch(
            self.t.dispatch_staged_batch(wid, pos, sid, repl))
        want = self.j.collect_local_batch(
            self.j.dispatch_staged_batch(wid, pos, sid, repl))
        assert got == want
        self.check_cpu(batch, got)
        return got

    def check_cpu(self, batch, got):
        wid, pos, sid, repl = batch
        queries = [
            LocalQuery(WORLDS[w], Vector3(*map(float, p)),
                       self.peers[s] if s >= 0 else None, Replication(int(r)))
            for w, p, s, r in zip(wid, pos, sid, repl)
        ]
        ref = self.c.match_local_batch(queries)
        assert [set(x) for x in got] == [set(x) for x in ref]
        assert [len(x) for x in got] == [len(x) for x in ref]


def _crowd(rng, n, n_cubes=40):
    centers = rng.integers(-6, 6, (n_cubes, 3)) * CUBE + CUBE / 2
    pos = centers[rng.integers(0, n_cubes, n)] + rng.uniform(-7, 7, (n, 3))
    return pos, centers


@pytest.mark.parametrize("delta_ticks", [True, False], ids=["delta", "full"])
def test_randomized_churn_matches_jax_and_cpu(delta_ticks):
    """Subscribe, unsubscribe, remove_peer and bulk moves, with
    background compactions (low threshold) — each step the port's fan-out
    equals the JAX backend's lane for lane and the CPU backend's as sets,
    in every replication mode."""
    rng = np.random.default_rng(21)
    trio = Trio(delta_ticks=delta_ticks)
    n = len(trio.peers)
    pos, spots = _crowd(rng, n)
    cubes = cube_coords_batch(pos, CUBE)
    half = n // 2
    trio.add("w0", np.arange(half), cubes[:half])
    trio.add("w1", np.arange(half, n), cubes[half:])
    batch = trio.batch(rng, 256, spots)
    for step in range(8):
        idx = rng.choice(half, 40, replace=False)
        new = cubes[idx] + rng.integers(-1, 2, (40, 3)) * CUBE
        trio.move("w0", idx, cubes[idx], new)
        cubes[idx] = new
        for i in rng.choice(np.arange(half, n), 5, replace=False):
            trio.remove_one("w1", int(i), tuple(int(c) for c in cubes[i]))
        trio.remove_peer(int(rng.integers(0, n)))
        extra = rng.choice(n, 20)
        trio.add("w1", extra, cube_coords_batch(
            rng.uniform(-90, 90, (20, 3)), CUBE))
        if step % 3 == 0:  # a repeated batch replays under delta ticks
            batch = trio.batch(rng, 256, spots)
        trio.check(batch)
    assert trio.t.compactions == trio.j.compactions > 0
    stats = trio.t.device_stats()
    assert stats["delta_ticks"] is delta_ticks
    if delta_ticks:
        assert stats["delta_reused"] > 0
        assert stats["delta_reused"] == trio.j.device_stats()["delta_reused"]
    assert trio.t.export_rows()[2:] and all(
        np.array_equal(a, b) for a, b in
        zip(trio.t.export_rows()[2:], trio.j.export_rows()[2:]))


def test_mutations_during_compaction_keep_device_and_host_aligned():
    """A compaction held in flight at a gate while the serving side
    tombstones snapshot rows (base and delta) and appends new rows, and
    flushes them to the device. After the swap, the device base and
    delta segments equal the host mirror row for row — the fold saw the
    snapshot, never the later updates (all device updates are out of
    place) — and fan-out equals JAX's and the CPU backend's."""
    rng = np.random.default_rng(5)
    trio = Trio(n_peers=400, threshold=64)
    n = len(trio.peers)
    pos, spots = _crowd(rng, n, n_cubes=20)
    cubes = cube_coords_batch(pos, CUBE)
    trio.add("w0", np.arange(n), cubes)
    trio.check(trio.batch(rng, 128, spots))
    # grow a delta log past the compaction threshold (64 rows), under
    # the fold-into-base limit (4 x 64)
    extra = cube_coords_batch(rng.uniform(-90, 90, (150, 3)), CUBE)
    trio.add("w1", np.arange(150), extra)

    gates = []
    for b in (trio.t, trio.j):
        gate = threading.Event()
        work = b._compact_work

        def held(snap, work=work, gate=gate):
            assert gate.wait(30)
            return work(snap)

        b._compact_work = held
        gates.append(gate)
    for b in (trio.t, trio.j):
        b.flush()
        assert b._compaction is not None  # in flight, held at the gate
    # mutate rows the snapshot holds, append new ones, flush to device
    for i in range(0, n, 7):
        trio.remove_one("w0", i, tuple(int(c) for c in cubes[i]))
    for i in range(1, 150, 11):
        trio.remove_one("w1", i, tuple(int(c) for c in extra[i]))
    trio.add("w0", np.arange(0, n, 8),
             cube_coords_batch(rng.uniform(-90, 90, (50, 3)), CUBE))
    batch = trio.batch(rng, 128, spots)
    got = trio.check(batch, drain=False)  # served mid-compaction
    for gate in gates:
        gate.set()
    trio.t.wait_compaction()
    trio.j.wait_compaction()
    t = trio.t
    assert t.compactions >= 1
    dev = t._base_bundle["dev"]
    np.testing.assert_array_equal(dev[0].numpy(), t._bk)
    np.testing.assert_array_equal(dev[1].numpy(), t._bk2)
    np.testing.assert_array_equal(dev[2].numpy(), t._bp)
    if t._delta_bundle is not None:
        d = t._delta_bundle["dev"]
        order = np.argsort(np.where(
            np.arange(t._delta_buf_cap) < t._dn,
            np.pad(t._dk[:t._dn], (0, t._delta_buf_cap - t._dn)),
            cb.PAD_KEY), kind="stable")
        keys = np.full(t._delta_buf_cap, cb.PAD_KEY, np.int64)
        keys[:t._dn] = t._dk[:t._dn]
        np.testing.assert_array_equal(d[0].numpy(), keys[order])
    after = trio.check(batch)
    assert len(after) == len(got)


def test_forced_probe_overflow_routes_to_binary_search(monkeypatch):
    """With 8-bucket probe tables every segment overflows (oflow > 0)
    and resolves by binary search on device — same fan-out."""
    monkeypatch.setattr(cb, "probe_buckets_for", lambda n: 8)
    rng = np.random.default_rng(8)
    trio = Trio(n_peers=300)
    pos, spots = _crowd(rng, 300, n_cubes=150)  # > 8 buckets x 8 slots
    trio.add("w0", np.arange(300), cube_coords_batch(pos, CUBE))
    batch = trio.batch(rng, 128, spots)
    got = trio.t.collect_local_batch(trio.t.dispatch_staged_batch(*batch))
    trio.check_cpu(batch, got)
    segs, _, _ = trio.t._segments()
    assert all(int(s[5][0]) > 0 for s in segs)


def test_csr_overflow_retry_and_pack_path():
    """A crowded cube overflows the CSR capacity hint: the collect
    re-resolves dense against the segments captured at dispatch and
    grows the hint (path 'overflow'); with the compaction gate opened
    the next ticks fetch through pack_csr. Both equal JAX and CPU."""
    rng = np.random.default_rng(13)
    trio = Trio(n_peers=900, delta_ticks=False)
    pos = np.tile([[8.0, 8.0, 8.0]], (900, 1)) + rng.uniform(-7, 7, (900, 3))
    trio.add("w0", np.arange(900), cube_coords_batch(pos, CUBE))
    for b in (trio.t, trio.j):
        b._delivery_cap = 64
        b.compact_fetch_min_cap = 0
        b.compact_min_bucket = 8
    batch = trio.batch(rng, 128, [[8.0, 8.0, 8.0]])
    trio.check(batch)
    assert trio.t.last_device_timing["path"] == "overflow"
    trio.check(batch)  # the grown hint serves the crowd

    rng = np.random.default_rng(13)
    trio = Trio(n_peers=600, delta_ticks=False)
    pos, spots = _crowd(rng, 600)
    trio.add("w0", np.arange(600), cube_coords_batch(pos, CUBE))
    for b in (trio.t, trio.j):
        b.compact_fetch_min_cap = 0
        b.compact_min_bucket = 8
    trio.check(trio.batch(rng, 128, spots))
    assert trio.t.compact_fetches > 0
    assert trio.t.compact_fetches == trio.j.compact_fetches
    assert trio.t.last_collect_stats == trio.j.last_collect_stats


def test_list_path_point_queries_and_stats():
    """The object-list dispatch, point queries, snapshot export and the
    device_stats keys (and the port's two collect counters) match the
    JAX backend; so does a query-kind batch
    (tests/test_torch_queries.py holds the kinds in full)."""
    rng = np.random.default_rng(2)
    trio = Trio(n_peers=200)
    pos, spots = _crowd(rng, 200, n_cubes=10)
    cubes = cube_coords_batch(pos, CUBE)
    trio.add("w0", np.arange(200), cubes)
    wid, qpos, sid, repl = trio.batch(rng, 64, spots)
    tq = [LocalQuery(WORLDS[w], Vector3(*map(float, p)),
                     trio.peers[s] if s >= 0 else None, Replication(int(r)))
          for w, p, s, r in zip(wid, qpos, sid, repl)]
    jq = [JQuery(WORLDS[w], JVec(*map(float, p)),
                 trio.peers[s] if s >= 0 else None, JRepl(int(r)))
          for w, p, s, r in zip(wid, qpos, sid, repl)]
    assert trio.t.match_local_batch(tq) == trio.j.match_local_batch(jq)
    for i in range(0, 200, 17):
        cube = tuple(int(c) for c in cubes[i])
        assert trio.t.query_cube("w0", cube) == trio.j.query_cube("w0", cube)
    assert trio.t.query_world("w0") == trio.j.query_world("w0")
    assert trio.t.cube_count("w0") == trio.j.cube_count("w0")
    # the port adds two counters of its collect (fetch_slots,
    # lanes_decoded) to the JAX backend's keys
    assert set(trio.t.device_stats()) == set(trio.j.device_stats()) | {
        "fetch_slots", "lanes_decoded"}
    dense = trio.t.match_arrays(wid, qpos, sid, repl)
    np.testing.assert_array_equal(dense, trio.j.match_arrays(
        wid, qpos, sid, repl))
    kinds, params = mixed_cols(rng, 64)
    got = trio.t.collect_local_batch(trio.t.dispatch_staged_batch(
        wid, qpos, sid, repl, kinds, params))
    want = trio.j.collect_local_batch(trio.j.dispatch_staged_batch(
        wid, qpos, sid, repl, kinds, params))
    assert all(query_results_match(g, w) for g, w in zip(got, want))
    assert trio.t.kind_expansions == trio.j.kind_expansions == 1


def test_precompile_walks_the_tiers_and_reads_like_jax():
    """The boot tier walk dispatches every reachable shape against the
    loaded index; its stats carry the JAX keys (jit counters at 0)."""
    rng = np.random.default_rng(4)
    b = CudaSpatialBackend(CUBE, device="cpu")
    b.configure_delta_ticks("auto")
    pos, _ = _crowd(rng, 500)
    b.bulk_add_subscriptions("w0", _peers(500), cube_coords_batch(pos, CUBE))
    stats = precompile_tiers(b, max_batch=256)
    assert stats["dispatches"] > 0 and stats["new_variants"] == 0
    assert {"dispatches", "pack_calls", "skipped_by_budget", "new_variants",
            "families", "wall_ms", "kind_dispatches"} <= set(stats)
    empty = precompile_tiers(CudaSpatialBackend(CUBE, device="cpu"),
                             max_batch=64)
    assert empty["skipped"] == "empty-index"


def test_device_telemetry_tags_the_split():
    from worldql_server_tpu_torch.engine.metrics import Metrics
    from worldql_server_tpu_torch.observability.device import (
        DeviceTelemetry)
    from worldql_server_tpu_torch.observability.spans import Tracer

    rng = np.random.default_rng(6)
    b = CudaSpatialBackend(CUBE, device="cpu")
    pos, spots = _crowd(rng, 100)
    b.bulk_add_subscriptions("w0", _peers(100), cube_coords_batch(pos, CUBE))
    tel = DeviceTelemetry(metrics=Metrics(), backend=b)
    b.collect_local_batch(b.dispatch_staged_batch(
        np.zeros(32, np.int32), np.asarray(spots, float)[:32],
        np.full(32, -1, np.int32), np.zeros(32, np.int8)))
    trace = Tracer(enabled=True).begin("tick")
    tel.on_tick(trace)
    split = trace.tags["device_timing"]
    assert {"encode_ms", "h2d_ms", "compute_ms", "d2h_ms"} <= set(split)
    assert tel.stats() == {"compiles": 0, "retraces": 0,
                           "compile_ms_total": 0.0, "buffer_bytes": 0}
    assert torch.device("cpu") == b.device
