"""Tests of the port that need the card: the CUDA kNN kernels (the
selection network for K <= 32, the insertion kernel above) against
their plain version on the same card, which kernel serves each K, the
wrapper's checks, the tick on the card against the tick on the CPU, and
the device subscription index — every K1–K6 op of ``ops/index.py`` on
the card against the same op on the CPU, and ``CudaSpatialBackend`` on
the card against the port's ``CpuSpatialBackend`` under churn — and the
query library: its stencil kernels (K10, K11) on the card against the
CPU, and a mixed kind batch through ``CudaSpatialBackend`` on the card
against the cpu index's oracles — and a cluster of two entity-sim shard
processes on the card with a live move of a world between them, the
``battle_royale`` scenario on the card, and the mesh index on a 2 x 2
virtual mesh of the card against the same mesh of the CPU.

Every test carries the ``cuda`` marker and skips (with a reason) on a
host without a card; whether there is one is decided inside each test.
This file imports neither JAX nor the JAX package, so on the card host
(which has no JAX) it runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerance: exact — kernel and plain version are compared lane for lane,
the tick's and the index ops' outputs bit for bit, fan-out as sets.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from worldql_server_tpu_torch.ops import tick as tt
from worldql_server_tpu_torch.ops.knn import (
    MAX_K,
    NETWORK_MAX_K,
    kernel_info,
    knn_select,
    knn_select_plain,
)

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _world(rng, n, n_runs):
    rid = np.sort(rng.integers(0, n_runs, n)).astype(np.int32)
    peer = rng.integers(0, max(n // 3, 1), n).astype(np.int32)
    pos = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (rid, peer, pos)]


@pytest.mark.parametrize("n,k", [
    (1000, 1), (4096, 4), (4096, 8), (4096, 16), (4096, 32), (2048, 64),
    (2048, 100), (1024, 128), (1024, MAX_K),
])
def test_kernel_matches_plain_on_card(n, k):
    """Network (K <= 32) and insertion kernels, masked rows, NaN
    distances and heavy ties: kernel == plain version, every lane."""
    _need_card()
    rng = np.random.default_rng(n + k)
    rid, peer, pos = _world(rng, n, max(1, n // (k + 1)))
    rid[::53] = -1
    pos[::97, 0] = float("nan")
    pos[1::5] = torch.round(pos[1::5])
    before = knn_select.launches
    got = knn_select(rid, peer, pos, k=k)
    want = knn_select_plain(rid, peer, pos, k=k)
    torch.cuda.synchronize()
    assert knn_select.launches == before + 1
    assert torch.equal(got, want)


#: both sides of the network/insertion boundary, every network width
_EDGE_KS = [1, 2, 4, 5, 8, 9, 16, 17, 32, 33, MAX_K]


def _shaped(case, n, k, seed):
    rng = np.random.default_rng(seed)
    rid = np.sort(rng.integers(0, max(1, n // (k + 1)), n)).astype(np.int32)
    peer = rng.permutation(n).astype(np.int32)
    pos = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    if case == "runs_longer_than_window":  # every slot of a row is kept
        rid = (np.arange(n) // (4 * k)).astype(np.int32)
    elif case == "one_run":
        rid[:] = 0
    elif case == "every_row_masked":
        rid[:] = -1
    elif case == "all_nan":
        pos[:] = np.nan
    elif case == "all_ones_nan":  # the NaN whose bits are 0xFFFFFFFF
        pos[:] = np.full((n, 3), 0xFFFFFFFF, np.uint32).view(np.float32)
    elif case == "one_peer_per_run":  # every candidate is same-peer
        rid = (np.arange(n) // (3 * k)).astype(np.int32)
        peer = rid.copy()
    return [torch.from_numpy(a).cuda() for a in (rid, peer, pos)]


def _same_as_plain(rid, peer, pos, k):
    before = knn_select.launches
    shape = (rid.shape[0], k)
    shape_before = knn_select.shapes.get(shape, 0)
    got = knn_select(rid, peer, pos, k=k)
    want = knn_select_plain(rid, peer, pos, k=k)
    torch.cuda.synchronize()
    assert knn_select.launches == before + 1
    assert knn_select.shapes[shape] == shape_before + 1
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("k", _EDGE_KS)
@pytest.mark.parametrize("case", [
    "runs_longer_than_window", "one_run", "every_row_masked", "all_nan",
    "all_ones_nan", "one_peer_per_run",
])
def test_kernel_edge_cases_match_plain(case, k):
    """all_ones_nan: the card's f32 arithmetic returns the canonical NaN
    0x7FFFFFFF whatever NaN comes in, so no kept key reaches the invalid
    key, which the network's FULL form keeps on top unsorted."""
    _need_card()
    got = _same_as_plain(*_shaped(case, 1000, k, k), k)
    if case in ("every_row_masked", "one_peer_per_run"):
        assert (got == -1).all()
    if case == "runs_longer_than_window" and k >= 2:
        # rows whose whole window lies in their run keep 2K-2 >= K
        at = np.arange(1000) % (4 * k)
        mid = (at >= k - 1) & (at <= 3 * k) & (np.arange(1000) + k <= 1000)
        assert (got[torch.from_numpy(mid).cuda()] >= 0).all()


@pytest.mark.parametrize("k", _EDGE_KS)
@pytest.mark.parametrize("n", [
    7,     # below one warp
    1000,  # not a multiple of the 128-row block: the ragged store
    1001,  # rows*K*4 of the last block not a multiple of 16 for odd K
])
def test_kernel_sizes_match_plain(n, k):
    _need_card()
    _same_as_plain(*_shaped("random", n, k, n + k), k)


@pytest.mark.parametrize("k,kernel", [
    (1, "knn_network_kernel<2, true>"), (2, "knn_network_kernel<4, true>"),
    (3, "knn_network_kernel<8, false>"), (4, "knn_network_kernel<8, true>"),
    (5, "knn_network_kernel<16, false>"),
    (8, "knn_network_kernel<16, true>"),
    (9, "knn_network_kernel<32, false>"),
    (16, "knn_network_kernel<32, true>"),
    (17, "knn_network_kernel<64, false>"),
    (32, "knn_network_kernel<64, true>"),
    (33, "knn_insert_kernel<64>"), (100, "knn_insert_kernel<128>"),
    (MAX_K, "knn_insert_kernel<256>"),
])
def test_each_k_has_one_kernel(k, kernel):
    """Dispatch by K: the network up to NETWORK_MAX_K (the main path's
    K=8 and K=32 among them), held in registers with no local memory;
    the insertion kernel above."""
    _need_card()
    info = kernel_info(k)
    assert info["kernel"] == kernel
    if k <= NETWORK_MAX_K:
        assert info["spill_bytes"] == 0 and info["local_bytes"] == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    rid, peer, pos = _world(np.random.default_rng(0), 256, 8)
    with pytest.raises(ValueError):
        knn_select(rid, peer, pos, k=MAX_K + 1)
    with pytest.raises(TypeError):
        knn_select(rid.long(), peer, pos, k=4)
    with pytest.raises(ValueError):
        knn_select(rid, peer, pos[:, :2].contiguous(), k=4)
    with pytest.raises(ValueError):
        knn_select(rid, peer, pos.t().contiguous().t(), k=4)


@pytest.mark.parametrize("k", [1, 8, 32])
def test_tick_on_card_equals_tick_on_cpu(k):
    _need_card()
    rng = np.random.default_rng(k)
    n = 20_000
    cols = (rng.uniform(-30, 30, (n, 3)).astype(np.float32),
            rng.uniform(-40, 40, (n, 3)).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32),
            rng.integers(0, 500, n).astype(np.int32))
    gs = tt.state_from_numpy(*cols, device="cuda")
    cs = tt.state_from_numpy(*cols, device="cpu")
    for _ in range(3):
        gs, gt, gc = tt.simulation_tick(gs, cube_size=16, k=k)
        cs, ct, cc = tt.simulation_tick(cs, cube_size=16, k=k)
        for a, b in ((gs.position, cs.position), (gs.velocity, cs.velocity),
                     (gt, ct), (gc, cc)):
            assert torch.equal(a.cpu(), b)


# --- the device subscription index (ops/index.py, spatial/cuda_backend.py)


@pytest.mark.parametrize("n_subs,n_queries", [(4096, 512), (65536, 4096)])
def test_index_ops_on_card_equal_cpu(n_subs, n_queries):
    """Every K1–K6 op on the card against the same op on the CPU, on the
    same seeded inputs: bit for bit, every output."""
    _need_card()
    from worldql_server_tpu_torch.tools.index_bench import (
        op_calls, op_inputs)

    gpu = op_calls(op_inputs(n_subs, n_queries, seed=n_subs, device="cuda"))
    cpu = op_calls(op_inputs(n_subs, n_queries, seed=n_subs, device="cpu"))
    for (name, g), (_, c) in zip(gpu, cpu):
        got, want = g(), c()
        torch.cuda.synchronize()
        assert len(got) == len(want), name
        for a, b in zip(got, want):
            assert a.device.type == "cuda", name
            assert torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("delta_ticks", ["auto", "off"])
def test_cuda_backend_on_card_matches_cpu_backend_under_churn(delta_ticks):
    """CudaSpatialBackend on the card against the port's CpuSpatialBackend
    under bulk moves, unsubscribes, peer removals and background
    compactions, with the pack path open: equal fan-out sets."""
    _need_card()
    import uuid

    from worldql_server_tpu_torch.protocol.types import Replication, Vector3
    from worldql_server_tpu_torch.spatial.backend import LocalQuery
    from worldql_server_tpu_torch.spatial.cpu_backend import (
        CpuSpatialBackend)
    from worldql_server_tpu_torch.spatial.cuda_backend import (
        CudaSpatialBackend)
    from worldql_server_tpu_torch.spatial.quantize import cube_coords_batch

    rng = np.random.default_rng(99)
    n = 3000
    dev = CudaSpatialBackend(16, 512, device="cuda")
    dev.configure_delta_ticks(delta_ticks)
    dev.compact_fetch_min_cap = 0
    dev.compact_min_bucket = 8
    ref = CpuSpatialBackend(16)
    peers = [uuid.UUID(int=0xC000 + i) for i in range(n)]
    spots = rng.integers(-8, 8, (60, 3)) * 16 + 8.0
    pos = spots[rng.integers(0, 60, n)] + rng.uniform(-7, 7, (n, 3))
    cubes = cube_coords_batch(pos, 16)
    for b in (dev, ref):
        b.bulk_add_subscriptions("w", peers, cubes)
    for step in range(10):
        idx = rng.choice(n, 200, replace=False)
        new = cubes[idx] + rng.integers(-1, 2, (200, 3)) * 16
        sel = [peers[i] for i in idx]
        dev.bulk_move_subscriptions("w", sel, cubes[idx], sel, new)
        for i, o, c in zip(idx, cubes[idx], new):
            ref.remove_subscription("w", peers[i], tuple(int(v) for v in o))
            ref.add_subscription("w", peers[i], tuple(int(v) for v in c))
        cubes[idx] = new
        gone = int(rng.integers(0, n))
        assert dev.remove_peer(peers[gone]) == ref.remove_peer(peers[gone])
        m = 1024
        qpos = spots[rng.integers(0, 60, m)] + rng.uniform(-7, 7, (m, 3))
        sid = rng.integers(-1, n, m).astype(np.int32)
        repl = rng.integers(0, 3, m).astype(np.int8)
        got = dev.collect_local_batch(dev.dispatch_staged_batch(
            np.zeros(m, np.int32), qpos, sid, repl))
        want = ref.match_local_batch([
            LocalQuery("w", Vector3(*map(float, p)),
                       peers[s] if s >= 0 else None, Replication(int(r)))
            for p, s, r in zip(qpos, sid, repl)])
        assert [set(x) for x in got] == [set(x) for x in want], step
        assert [len(x) for x in got] == [len(x) for x in want], step
    dev.wait_compaction()
    stats = dev.device_stats()
    assert stats["compactions"] > 0 and stats["compact_fetches"] > 0
    seg = dev._segments()[0][0]
    assert all(t.device.type == "cuda" for t in seg)


@pytest.mark.parametrize("m,radius", [(37, 1), (4096, 3)])
def test_query_kernels_on_card_equal_cpu(m, radius):
    """K10 and K11 (the query library's stencil kernels) on the card
    against the same functions on the CPU: bit for bit, on CUDA
    tensors."""
    _need_card()
    from worldql_server_tpu_torch.queries import geometry, knn
    from worldql_server_tpu_torch.queries.stencil import stencil_offsets
    from worldql_server_tpu_torch.tools.index_bench import (
        KIND_IDS, kind_cols)

    rng = np.random.default_rng(m + radius)
    geom = geometry.stencil_geometry(stencil_offsets(radius), 16)
    off = torch.from_numpy(stencil_offsets(radius).astype(np.float64))
    calls = {
        "cone": lambda p, g, o: (geometry._cone_mask_kernel(p, g),),
        "knn": lambda p, g, o: knn._knn_order_kernel(p, g),
        "density": lambda p, g, o: (geometry._density_mask_kernel(p, o),),
    }
    for name, fn in calls.items():
        params = torch.from_numpy(kind_cols(rng, m, KIND_IDS[name])[1])
        got = fn(params.cuda(), torch.from_numpy(geom).cuda(), off.cuda())
        want = fn(params, torch.from_numpy(geom), off)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.device.type == "cuda", name
            assert torch.equal(a.cpu(), b), name


def test_cuda_backend_kind_batch_on_card_matches_cpu_backend():
    """A mixed kind batch (radius, cone, raycast, knn, density) through
    CudaSpatialBackend on the card: every lane equal to the port's
    CpuSpatialBackend (the oracles)."""
    _need_card()
    import uuid

    from worldql_server_tpu_torch.protocol.types import Replication, Vector3
    from worldql_server_tpu_torch.spatial.backend import LocalQuery
    from worldql_server_tpu_torch.spatial.cpu_backend import (
        CpuSpatialBackend)
    from worldql_server_tpu_torch.spatial.cuda_backend import (
        CudaSpatialBackend)
    from worldql_server_tpu_torch.spatial.quantize import cube_coords_batch
    from worldql_server_tpu_torch.tools.index_bench import (
        mixed_cols, query_results_match)

    rng = np.random.default_rng(12)
    n, m = 3000, 512
    pos = rng.uniform(-56, 56, (n, 3))
    peers = [uuid.UUID(int=0xD000 + i) for i in range(n)]
    dev = CudaSpatialBackend(16, device="cuda")
    ref = CpuSpatialBackend(16)
    for b in (dev, ref):
        b.bulk_add_subscriptions("w", peers, cube_coords_batch(pos, 16))
    dev.flush()
    senders = rng.integers(0, n, m)
    kinds, params = mixed_cols(rng, m)
    repl = rng.integers(0, 3, m).astype(np.int8)
    qpos = pos[senders]
    sid = np.array([dev._peer_ids[peers[s]] for s in senders], np.int32)
    got = dev.collect_local_batch(dev.dispatch_staged_batch(
        np.zeros(m, np.int32), qpos, sid, repl, kinds, params))
    want = ref.match_local_batch([
        LocalQuery("w", Vector3(*map(float, qpos[i])), peers[s],
                   Replication(int(repl[i])), kind=int(kinds[i]),
                   params=tuple(params[i]))
        for i, s in enumerate(senders)])
    assert dev.kind_expansions == 1
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not query_results_match(g, w)]
    assert not bad, bad[:8]


def test_snapshot_round_trip_on_card(tmp_path):
    """An index snapshot of CudaSpatialBackend on the card, restored
    into a fresh one on the card (through its bulk load, K1 on upload)
    and into one on the CPU: equal rows and equal fan-out."""
    _need_card()
    import uuid

    from worldql_server_tpu_torch.protocol.types import Replication, Vector3
    from worldql_server_tpu_torch.spatial.backend import LocalQuery
    from worldql_server_tpu_torch.spatial.cuda_backend import (
        CudaSpatialBackend)
    from worldql_server_tpu_torch.spatial.snapshot import (
        load_snapshot, save_snapshot)

    rng = np.random.default_rng(31)
    n = 20_000
    peers = [uuid.UUID(int=0xE000 + i) for i in range(n // 4)]
    cubes = rng.integers(-60, 60, (n, 3)).astype(np.int64) * 16
    owner = rng.integers(0, len(peers), n)
    src = CudaSpatialBackend(16, device="cuda")
    for w in range(2):
        sel = np.flatnonzero(np.arange(n) % 2 == w)
        src.bulk_add_subscriptions(f"w{w}", [peers[i] for i in owner[sel]],
                                   cubes[sel])
    src.flush()
    for i in range(0, len(peers), 13):
        src.remove_peer(peers[i])
    src.flush()
    path = str(tmp_path / "card.npz")
    saved = save_snapshot(src, path)
    outs = []
    for device in ("cuda", "cpu"):
        dst = CudaSpatialBackend(16, device=device)
        assert load_snapshot(dst, path)[0] == saved
        outs.append(dst)
    queries = [LocalQuery(f"w{i % 2}", Vector3(*map(float, cubes[i] + 2)),
                          peers[owner[i]], Replication.EXCEPT_SELF)
               for i in range(0, n, 17)]

    def rows(b):
        worlds, ps, wid, cube, pid = b.export_rows()
        return sorted((worlds[w], ps[p], tuple(c)) for w, c, p in
                      zip(wid.tolist(), cube.tolist(), pid.tolist()))

    want = [set(t) for t in src.match_local_batch(queries)]
    for dst in outs:
        assert rows(dst) == rows(src)
        assert [set(t) for t in dst.match_local_batch(queries)] == want


def test_interest_tick_on_card_equals_cpu():
    """One entity plane with an InterestManager on the card and one on
    the CPU, fed the same messages: the keyframe tick and a delta tick
    emit the same frames, byte for byte, to the same recipients."""
    _need_card()
    import asyncio
    import uuid

    from worldql_server_tpu_torch.engine.peers import PeerMap
    from worldql_server_tpu_torch.entities import ColumnarIngest, EntityPlane
    from worldql_server_tpu_torch.interest import InterestManager
    from worldql_server_tpu_torch.protocol import (
        Instruction, Message, deserialize_message, serialize_message)
    from worldql_server_tpu_torch.protocol.types import Entity, Vector3
    from worldql_server_tpu_torch.spatial.cpu_backend import (
        CpuSpatialBackend)

    rng = np.random.default_rng(44)
    peers = [uuid.UUID(int=0xF100 + i) for i in range(8)]
    datas = []
    for i in range(2000):
        p = peers[i % len(peers)]
        vel = rng.uniform(-20, 20, 3).astype(np.float32)
        datas.append(serialize_message(Message(
            instruction=Instruction.LOCAL_MESSAGE, sender_uuid=p,
            world_name="w", entities=[Entity(
                uuid=uuid.UUID(int=(1 << 90) + i),
                position=Vector3(*map(float, rng.uniform(-60, 60, 3))),
                world_name="w",
                flex=vel.tobytes() if i % 3 == 0 else None)])))
    frames = []
    for device in ("cuda", "cpu"):
        plane = EntityPlane(CpuSpatialBackend(16), PeerMap(), cube_size=16,
                            k=8, dt=0.05, bounds=1000.0, device=device)
        plane.interest = InterestManager(near_radius=30.0,
                                         clock=lambda: 0.0)
        ingest = ColumnarIngest(plane, sender_known=lambda u: True)

        async def slow(data, plane=plane):
            plane.ingest(deserialize_message(data))

        asyncio.run(ingest.process_batch(list(datas), slow))
        ticks = []
        for _ in range(2):
            pairs = plane.apply(plane.collect_tick(plane.dispatch_tick()))
            ticks.append([(m.wire, [str(t) for t in ts]) for m, ts in pairs])
        frames.append(ticks)
    assert frames[0] == frames[1]
    assert frames[0][0] and frames[0][1]  # keyframes, then deltas


def test_cluster_of_entity_sim_shards_on_card(monkeypatch):
    """Two ``--entity-sim`` shard processes on the card behind the
    router (worldql_server_tpu_torch/tools/cluster_drive.py): each
    shard's /healthz names cuda for its index and its plane, the kNN
    kernel launches in the shards, a world moves to the other shard and
    back with its index rows and entity rows equal (static entities),
    and nothing sent across the move is lost."""
    _need_card()
    import asyncio

    from worldql_server_tpu_torch.tools.cluster_drive import drive_cluster

    monkeypatch.delenv("WQL_TORCH_DEVICE", raising=False)  # shards: cuda
    report = asyncio.run(asyncio.wait_for(drive_cluster(
        n_entities=2000, n_peers=8, moving=0.0, k=8,
        spread=40.0, device="cuda", move_back=True), 240))
    assert all(s["knn_launches"] > 0 for s in report["shards"])
    # the same launches by shape, each at K=8
    for shard in report["shards"]:
        assert sum(c for _, _, c in shard["knn_shapes"]) == \
            shard["knn_launches"]
        assert {k for _, k, _ in shard["knn_shapes"]} == {8}
    mig = report["migration"]
    assert mig["imported"]["entities"] == mig["exported"]["entities"] == 500


def test_battle_royale_scenario_on_card(monkeypatch):
    """The scenario library's ``battle_royale`` at smoke shape on the
    card: every check green, the index and the entity plane on cuda,
    and the sim ticks launch the kNN kernel."""
    _need_card()
    from worldql_server_tpu_torch.scenarios import run_scenario

    monkeypatch.delenv("WQL_TORCH_DEVICE", raising=False)  # the card
    knn_select.launches = 0
    report = run_scenario("battle_royale", shape="smoke")
    failed = [c["name"] for c in report["checks"] if not c["ok"]]
    assert not failed, (failed, report["error"], report["slo"])
    assert report["device"]["index"].startswith("cuda")
    assert report["device"]["entity_plane"].startswith("cuda")
    assert knn_select.launches > 0


def test_sharded_mesh_on_card_equals_cpu_mesh():
    """ShardedCudaSpatialBackend on a 2 x 2 virtual mesh of the card
    (``cuda:0`` four times) against the same mesh of the CPU, under bulk
    loads, moves, peer removals and drained device folds: the dense
    table, the raw CSR triple, the packed fetch and every shard's base
    arrays equal, lane for lane."""
    _need_card()
    import uuid

    from worldql_server_tpu_torch.parallel import (
        ShardedCudaSpatialBackend, make_fanout_mesh)
    from worldql_server_tpu_torch.spatial.quantize import cube_coords_batch

    rng = np.random.default_rng(2024)
    n = 4000
    pair = [ShardedCudaSpatialBackend(
        16, make_fanout_mesh(2, 2, devices=[dev] * 4), compact_threshold=512)
        for dev in ("cuda:0", "cpu")]
    for b in pair:
        b.compact_fetch_min_cap = 0
        b.compact_min_bucket = 8
    peers = [uuid.UUID(int=0xE000 + i) for i in range(n)]
    spots = rng.integers(-8, 8, (80, 3)) * 16 + 8.0
    pos = spots[rng.integers(0, 80, n)] + rng.uniform(-7, 7, (n, 3))
    cubes = cube_coords_batch(pos, 16)
    for b in pair:
        b.bulk_add_subscriptions("w", peers, cubes)
        b.flush()
        b.wait_compaction()
    for step in range(6):
        idx = rng.choice(n, 300, replace=False)
        new = cubes[idx] + rng.integers(-1, 2, (300, 3)) * 16
        sel = [peers[i] for i in idx]
        gone = peers[int(rng.integers(0, n))]
        for b in pair:
            b.bulk_move_subscriptions("w", sel, cubes[idx], sel, new)
            b.remove_peer(gone)
            b.flush()
            b.wait_compaction()
        cubes[idx] = new
        m = 1024
        qpos = spots[rng.integers(0, 80, m)] + rng.uniform(-7, 7, (m, 3))
        batch = (np.zeros(m, np.int32), qpos,
                 rng.integers(-1, n, m).astype(np.int32),
                 rng.integers(0, 3, m).astype(np.int8))
        dense = [b.match_arrays(*batch) for b in pair]
        assert np.array_equal(*dense), step
        csr = [b.match_arrays_async(*batch, csr_cap=1 << 18)[1]
               for b in pair]
        assert int(csr[1][2]) <= 1 << 18  # no overflow sentinel
        for a, c in zip(*csr):
            assert a.device.type == "cuda"
            assert torch.equal(a.cpu(), c), step
        total = int(csr[1][2])
        packed = [b._compact_fetch(r[0], r[1], total, r[1].shape[0])
                  for b, r in zip(pair, csr)]
        assert packed[0] is not None and np.array_equal(*packed), step
        gpu, cpu = (b._base_bundle for b in pair)
        assert np.array_equal(gpu["splits"], cpu["splits"])
        for ga, ca in zip(gpu["dev"], cpu["dev"]):
            for s in range(2):
                assert ga.shard(s).device.type == "cuda"
                assert torch.equal(ga.shard(s).cpu(), ca.shard(s)), step
    assert pair[0].compactions == pair[1].compactions > 0
