"""The device index's ops (``ops/index.py``, K1–K6) against their JAX
functions (``worldql_server_tpu/spatial/tpu_backend.py``) on the CPU.

The same seeded numpy inputs — a Zipf crowd of subscription rows with
tombstones, a smaller delta segment churned into the hot cubes, and a
query batch with misses in every replication mode — go through each
torch op and the JAX function of the same name. Tolerance: exact, every
output lane and its dtype (``_bucket_hash`` returns the u64 bits as
int64 in torch). ``_window_gather`` is compared on the lanes inside the
array: past its end JAX's TPU row rotation and the port's clamped gather
read different padding, which every caller masks.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from worldql_server_tpu.spatial import tpu_backend as jb
from worldql_server_tpu_torch.ops import index as ix
from worldql_server_tpu_torch.spatial.hashing import next_pow2
from worldql_server_tpu_torch.tools.index_bench import op_inputs

N_SUBS, N_QUERIES = 2048, 256


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def world():
    """Torch inputs on the CPU, their JAX twins, and the sorted
    segments both sides build from them (themselves held equal)."""
    t = op_inputs(N_SUBS, N_QUERIES, seed=11, device="cpu")
    j = {k: (tuple(jnp.asarray(a.numpy()) for a in v)
             if isinstance(v, tuple) else v) for k, v in t.items()}
    tseg = ix._sort_segment_dev(*t["base"], n_buckets=t["base_buckets"])
    jseg = jb._sort_segment_dev(*j["base"], n_buckets=j["base_buckets"])
    _same(tseg, jseg)
    tdseg = ix._sort_segment_dev(*t["delta"], n_buckets=t["delta_buckets"])
    jdseg = jb._sort_segment_dev(*j["delta"], n_buckets=j["delta_buckets"])
    _same(tdseg, jdseg)
    return {"t": t, "j": j, "tseg": tseg, "jseg": jseg,
            "tsegs": [tseg, tdseg], "jsegs": [jseg, jdseg]}


def _ks(w):
    return tuple(next_pow2(int(s[3].max()), 8) for s in w["tsegs"])


def test_bucket_hash(world):
    got = ix._bucket_hash(world["tseg"][0]).numpy()
    want = np.asarray(jb._bucket_hash(world["jseg"][0]))
    np.testing.assert_array_equal(got.view(np.uint64), want)


@pytest.mark.parametrize("n_buckets", [8, 64, 2048])
def test_probe_tables(world, n_buckets):
    """Small bucket counts overflow (oflow > 0); the table still
    matches lane for lane."""
    got = ix.probe_tables(world["tseg"][0], world["tseg"][1],
                          n_buckets=n_buckets)
    want = jb.probe_tables(world["jseg"][0], world["jseg"][1],
                           n_buckets=n_buckets)
    _same(got, want)
    if n_buckets == 8:
        assert int(got[1][0]) > 0


def test_run_remainders_and_probe_only(world):
    _same([ix.run_remainders(world["tseg"][0])],
          [jb.run_remainders(world["jseg"][0])])
    nb = world["t"]["base_buckets"]
    _same(ix._probe_only_dev(world["tseg"][0], world["tseg"][1],
                             n_buckets=nb),
          jb._probe_only_dev(world["jseg"][0], world["jseg"][1],
                             n_buckets=nb))


def test_run_bounds_probe_and_search(world):
    tq, jq = world["t"]["queries"], world["j"]["queries"]
    ts, js = world["tseg"], world["jseg"]
    _same(ix._probe_run_bounds(ts[4], ts[1], ts[3], tq[0], tq[1]),
          jb._probe_run_bounds(js[4], js[1], js[3], jq[0], jq[1]))
    _same(ix._run_bounds(ts[0], ts[1], ts[3], tq[0], tq[1]),
          jb._run_bounds(js[0], js[1], js[3], jq[0], jq[1]))


@pytest.mark.parametrize("oflow", [0, 3])
def test_seg_run_bounds_picks_the_branch_on_device(world, oflow):
    """``oflow > 0`` takes binary search (torch.where in the port,
    lax.cond in JAX); both branches agree on the counts."""
    ts = (*world["tseg"][:5], torch.tensor([oflow], dtype=torch.int32))
    js = (*world["jseg"][:5], jnp.asarray([oflow], jnp.int32))
    tq, jq = world["t"]["queries"], world["j"]["queries"]
    got = ix._seg_run_bounds(ts, tq[0], tq[1])
    _same(got, jb._seg_run_bounds(js, jq[0], jq[1]))
    assert int(got[1].sum()) > 0


def test_run_bounds_all_zone_b_and_layout(world):
    tq, jq = world["t"]["queries"], world["j"]["queries"]
    tl, tc = ix.run_bounds_all(world["tsegs"], tq)
    jl, jc = jb.run_bounds_all(world["jsegs"], jq)
    _same(tl + tc, jl + jc)
    tz, jz = ix.zone_b_cnts(tc), jb.zone_b_cnts(jc)
    _same(tz, jz)
    for rows_cap in (8, 64, 4096):  # an overflowing cap drops marks
        _same(ix.csr_layout(tz, rows_cap, ix.CSR_ROW_B),
              jb.csr_layout(jz, rows_cap, jb.CSR_ROW_B))


def test_repl_mask(world):
    rng = np.random.default_rng(3)
    vals = rng.integers(-1, 6, (64, 8)).astype(np.int32)
    sender = rng.integers(-1, 6, (64, 1)).astype(np.int32)
    repl = rng.integers(0, 3, (64, 1)).astype(np.int8)
    _same([ix._repl_mask(*(torch.from_numpy(a)
                           for a in (vals, sender, repl)))],
          [jb._repl_mask(*(jnp.asarray(a) for a in (vals, sender, repl)))])


@pytest.mark.parametrize("t_scale", [0, 1, 4])
def test_match_run_csr_and_pack(world, t_scale):
    """t_scale 0 sizes the capacity below the layout (the overflow
    sentinel t_cap + 1); 1 and 4 fit. Then pack_csr at the fitting
    bucket and at one too small."""
    tq, jq = world["t"]["queries"], world["j"]["queries"]
    targs = [*world["tsegs"][0], *world["tsegs"][1], *tq]
    jargs = [*world["jsegs"][0], *world["jsegs"][1], *jq]
    _, cnts = ix.run_bounds_all(world["tsegs"], tq)
    need = ix.padded_slots(torch.stack(cnts, 1).numpy())
    floor = ix.CSR_ROW * N_QUERIES * 2 + 64
    t_cap = next_pow2(max(need * t_scale, floor))
    got = ix.match_run_csr(targs, 2, t_cap)
    _same(got, jb.match_run_csr(jargs, 2, t_cap))
    if t_scale == 0:
        assert int(got[2]) == t_cap + 1
        return
    total = int(got[2])
    for bucket in (next_pow2(total), next_pow2(total) // 4):
        _same(ix.pack_csr(got[0], got[1], bucket=bucket),
              jb.pack_csr(jnp.asarray(got[0].numpy()),
                          jnp.asarray(got[1].numpy()), bucket=bucket))


def test_padded_slots_host_mirror(world):
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 300, (50, 2)).astype(np.int32)
    assert ix.padded_slots(counts) == jb.padded_slots(counts)


def test_delta_buffer_ops(world):
    """K4: alloc, grow, chunk write (start clamped like
    dynamic_update_slice), tombstone scatter with dropped padding."""
    _same(ix._alloc_buffers(64, "cpu"), jb._alloc_buffers(64))
    tdel, jdel = world["t"]["delta"], world["j"]["delta"]
    cap = tdel[0].shape[0]
    _same(ix._grow_buffers(tdel, 4 * cap), jb._grow_buffers(jdel, 4 * cap))
    chunk = tuple(a[:16].numpy() for a in world["t"]["base"])
    for start in (0, 40, cap - 3):
        _same(ix._write_chunk(tdel, chunk, start),
              jb._write_chunk(jdel, chunk, np.int32(start)))
    rows = np.array([0, 5, 5, cap - 1, cap, cap + 9], np.int32)
    _same([ix._scatter_dead(tdel[2], rows)],
          [jb._scatter_dead(jdel[2], rows)])


def test_updates_are_out_of_place(world):
    """A snapshot holding a tensor never sees a later update."""
    peers = world["tseg"][2].clone()
    before = peers.clone()
    ix._scatter_dead(peers, np.array([0, 1, 2], np.int32))
    bufs = tuple(a.clone() for a in world["t"]["delta"])
    ix._write_chunk(bufs, tuple(a[:4].numpy() for a in bufs), 2)
    assert torch.equal(peers, before)
    assert all(torch.equal(a, b) for a, b in zip(bufs, world["t"]["delta"]))


def test_device_compact(world):
    ts, js = world["tseg"], world["jseg"]
    tdel, jdel = world["t"]["delta"], world["j"]["delta"]
    live = int((ts[2] >= 0).sum()) + int((tdel[2] >= 0).sum())
    nb = world["t"]["base_buckets"]
    _same(ix._device_compact(*ts[:3], *tdel, cap2=next_pow2(live),
                             n_buckets=nb),
          jb._device_compact(*js[:3], *jdel, cap2=next_pow2(live),
                             n_buckets=nb))


def test_window_gather_inside_the_array(world):
    peer = world["tseg"][2]
    s = peer.shape[0]
    lo = np.concatenate([np.arange(0, s - 32, 7), [s - 32]]).astype(np.int32)
    for k in (8, 32):
        _same([ix._window_gather(peer, torch.from_numpy(lo), k)],
              [jb._window_gather(jnp.asarray(peer.numpy()),
                                 jnp.asarray(lo), k)])


def test_dense_match_and_sparse_compaction(world):
    tq, jq = world["t"]["queries"], world["j"]["queries"]
    ks = _ks(world)
    _same([ix.match_core(world["tseg"], *tq, k=ks[0])],
          [jb.match_core(world["jseg"], *jq, k=ks[0])])
    targs = [*world["tsegs"][0], *world["tsegs"][1], *tq]
    jargs = [*world["jsegs"][0], *world["jsegs"][1], *jq]
    dense = ix._multi_match(targs, ks)
    _same([dense], [jb._multi_match(jargs, ks)])
    lo, cnt = ix._seg_run_bounds(world["tseg"], tq[0], tq[1])
    jlo, jcnt = jb._seg_run_bounds(world["jseg"], jq[0], jq[1])
    _same([ix._gather_filtered(world["tseg"][2], lo, cnt, tq[2], tq[3],
                               k=ks[0])],
          [jb._gather_filtered(world["jseg"][2], jlo, jcnt, jq[2], jq[3],
                               k=ks[0])])
    for c in (8, N_QUERIES // 2, N_QUERIES):
        _same(ix.compact_sparse(dense, c=c),
              jb.compact_sparse(jnp.asarray(dense.numpy()), c=c))
