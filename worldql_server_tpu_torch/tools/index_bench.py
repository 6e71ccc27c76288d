"""Workload generators for the device subscription index, and the
inputs of its ops at full width.

The generators are copies of the JAX package's ``bench.py`` ones
(``bench.py`` imports JAX, so the port cannot import it):

* :func:`make_positions` — the BASELINE config-5 crowd: Zipf(s=1.0)
  cube popularity over a 100^3 grid of 16 m cubes, occupancy capped at
  256 per cube with the excess spilled down the ranking, positions
  uniform inside each cube (``bench.py::make_positions``);
* :func:`build_index` — 8 worlds of such subscribers, bulk-loaded;
* :func:`make_query_batch` — entities broadcasting from a random
  subscriber's cube, 20% from a fresh point (mostly misses);
* :class:`RandomWalk` — BASELINE config 2: 10,000 clients walking in
  ±400 bounds at velocities ±30, dt 0.05 (``bench.py::bench_config2``);
* :func:`kind_cols`, :func:`mixed_cols` and :func:`query_results_match`
  — the query-library batches of BASELINE config 12 and its parity
  test (``bench.py::_kind_cols``, ``_query_results_match`` and the mixed
  batch of ``bench_config12``).

:func:`op_inputs` turns a crowd into the segment and query tensors the
ops of ``ops/index.py`` take, on any device, and :func:`op_calls` runs
every op on them; ``chip_smoke.py`` runs each on the card and on the
CPU, compares them and times them.
"""

from __future__ import annotations

import uuid as uuid_mod

import numpy as np
import torch

from ..ops import index as ix
from ..queries.kinds import (
    KIND_CONE, KIND_DENSITY, KIND_KNN, KIND_RADIUS, KIND_RAYCAST,
    PARAM_LANES, RAY_ALL_HITS, RAY_FIRST_HIT)
from ..spatial.hashing import (
    PAD_KEY, next_pow2, pad_to, spatial_keys, spatial_keys2)
from ..spatial.native_keys import encode_queries
from ..spatial.quantize import cube_coords_batch

#: config-5 crowd model: cube popularity exponent and occupancy bound
ZIPF_S = 1.0
OCCUPANCY_CAP = 256
CUBE = 16


def make_positions(rng: np.random.Generator, n: int,
                   stats: dict | None = None) -> np.ndarray:
    """Zipf(s=ZIPF_S)-popularity crowd over subscription cubes,
    occupancy capped at OCCUPANCY_CAP with waterfill spill; positions
    uniform within each cube. Fills ``stats`` with the crowd's shape
    when given."""
    span, cube = 800.0, 16.0
    cells_axis = int(span * 2 / cube)              # 100 per axis
    n_ranked = min(max(n // 4, 1024), cells_axis ** 3)
    cell_ids = rng.permutation(cells_axis ** 3)[:n_ranked]
    p = 1.0 / np.arange(1, n_ranked + 1, dtype=np.float64) ** ZIPF_S
    counts = rng.multinomial(n, p / p.sum())
    excess = int(np.maximum(counts - OCCUPANCY_CAP, 0).sum())
    counts = np.minimum(counts, OCCUPANCY_CAP)
    if excess:
        free = OCCUPANCY_CAP - counts
        take = np.minimum(free, np.maximum(
            excess - (np.cumsum(free) - free), 0
        ))
        counts += take
        if int(counts.sum()) != n:
            raise AssertionError("waterfill must conserve entities")
    if stats is not None:
        stats.update(
            zipf_s=ZIPF_S, occupancy_cap=OCCUPANCY_CAP,
            max_cube_occupancy=int(counts.max()),
            occupied_cubes=int((counts > 0).sum()),
        )
    cid = np.repeat(cell_ids, counts)
    ix_ = cid % cells_axis
    iy = (cid // cells_axis) % cells_axis
    iz = cid // (cells_axis * cells_axis)
    corners = np.stack([ix_, iy, iz], axis=1) * cube - span
    return corners + rng.uniform(0.0, cube, (n, 3))


def build_index(backend, rng: np.random.Generator, n_subs: int,
                n_worlds: int, stats: dict | None = None):
    """Bulk-load ``n_subs`` Zipf-crowd subscribers in ``n_worlds``
    worlds (``world_{w}``). Returns ``(peers, positions, world_ids)``."""
    positions = make_positions(rng, n_subs, stats)
    cubes = cube_coords_batch(positions, backend.cube_size)
    peers = [uuid_mod.UUID(int=i + 1) for i in range(n_subs)]
    world_ids = np.arange(n_subs) * n_worlds // n_subs
    for w in range(n_worlds):
        sel = np.flatnonzero(world_ids == w)
        backend.bulk_add_subscriptions(
            f"world_{w}", [peers[i] for i in sel], cubes[sel])
    return peers, positions, world_ids


def make_query_batch(rng, sub_positions, sub_world_ids, m: int):
    """Queries from entities broadcasting at their own positions: each
    draws a random subscriber and speaks from its cube (20% from a
    fresh random point). → ``(world_ids, positions, senders, repls)``."""
    n_subs = len(sub_positions)
    senders = rng.integers(0, n_subs, m)
    world_ids = sub_world_ids[senders].astype(np.int32)
    positions = sub_positions[senders].copy()
    miss = rng.random(m) < 0.2
    positions[miss] = make_positions(rng, int(miss.sum()))
    return world_ids, positions, senders.astype(np.int32), \
        np.zeros(m, np.int8)


class RandomWalk:
    """BASELINE config 2: ``n`` clients in one world, uniform in ±400,
    velocities ±30, dt 0.05, reflecting at the bounds. ``step()``
    advances one tick and returns the indices whose cube changed with
    their old and new cubes."""

    def __init__(self, rng: np.random.Generator, n: int = 10_000,
                 bounds: float = 400.0, speed: float = 30.0,
                 dt: float = 0.05):
        self.bounds, self.dt = bounds, dt
        self.positions = rng.uniform(-bounds, bounds, (n, 3))
        self.velocities = rng.uniform(-speed, speed, (n, 3))
        self.peers = [uuid_mod.UUID(int=i + 1) for i in range(n)]
        self.cubes = cube_coords_batch(self.positions, CUBE)

    def step(self):
        self.positions += self.velocities * self.dt
        out = np.abs(self.positions) > self.bounds
        self.velocities[out] = -self.velocities[out]
        np.clip(self.positions, -self.bounds, self.bounds,
                out=self.positions)
        new = cube_coords_batch(self.positions, CUBE)
        moved = np.flatnonzero((new != self.cubes).any(axis=1))
        old = self.cubes[moved].copy()
        self.cubes[moved] = new[moved]
        return moved, old, new[moved]


#: the library's kinds by name, in bench_config12's order
KIND_IDS = {"cone": KIND_CONE, "raycast": KIND_RAYCAST, "knn": KIND_KNN,
            "density": KIND_DENSITY}


def kind_cols(rng: np.random.Generator, m: int, kind_id: int):
    """→ (kinds i8 [m], params f64 [m, PARAM_LANES]) staged columns for
    one kind, parameters drawn exactly as the wire parsers clamp them
    (cube 16, stencil 3, ray steps 64)."""
    kinds = np.full(m, kind_id, np.int8)
    params = np.zeros((m, PARAM_LANES), np.float64)
    if kind_id in (KIND_CONE, KIND_RAYCAST):
        d = rng.normal(size=(m, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        params[:, 0:3] = d
    if kind_id == KIND_CONE:
        params[:, 3] = np.cos(np.radians(rng.uniform(20.0, 80.0, m)))
        params[:, 4] = rng.uniform(12.0, 48.0, m)
    elif kind_id == KIND_RAYCAST:
        params[:, 3] = rng.uniform(16.0, 64.0, m)          # max_t
        params[:, 4] = np.where(
            rng.random(m) < 0.5, RAY_FIRST_HIT, RAY_ALL_HITS
        )
    elif kind_id == KIND_KNN:
        params[:, 0] = rng.integers(1, 12, m).astype(np.float64)
        params[:, 1] = rng.uniform(12.0, 48.0, m)          # max_range
    elif kind_id == KIND_DENSITY:
        params[:, 0] = rng.integers(1, 3, m).astype(np.float64)
        params[:, 1] = 8.0                                 # top_n
    return kinds, params


def mixed_cols(rng: np.random.Generator, m: int):
    """The mixed one-tick batch: radius rows and every kind,
    interleaved ``% 5``."""
    kinds = np.zeros(m, np.int8)
    params = np.zeros((m, PARAM_LANES), np.float64)
    lanes = [KIND_RADIUS, *KIND_IDS.values()]
    for j, kid in enumerate(lanes):
        sel = np.flatnonzero(np.arange(m) % len(lanes) == j)
        kinds[sel] = kid
        if kid != KIND_RADIUS:
            params[sel] = kind_cols(rng, sel.size, kid)[1]
    return kinds, params


def query_results_match(got, want) -> bool:
    """Lane-for-lane result equality across the two collect shapes:
    (kind, peers, extra) for library kinds — compared by field, so a
    result of either package matches — and peer sets for radius rows
    (radius peer ORDER is an index-layout artifact on both paths)."""
    kinds = [hasattr(r, "extra") for r in (got, want)]  # KindResult
    if any(kinds):
        return all(kinds) and (
            (int(got.kind), list(got.peers), got.extra)
            == (int(want.kind), list(want.peers), want.extra))
    return set(got) == set(want)


def op_inputs(n_subs: int, n_queries: int, seed: int, device,
              n_worlds: int = 8, delta_rows: int | None = None) -> dict:
    """The ops' inputs at a given width, from the config-5 crowd:
    ``base`` (an insertion-order segment of ``n_subs`` rows: keys,
    keys2, peers), ``delta`` (a second, smaller one), the encoded
    ``queries`` (keys, keys2, senders, repls; every replication mode),
    and the bucket counts the index would size for them. Tensors on
    ``device``; the numpy inputs come from ``seed`` alone."""
    rng = np.random.default_rng(seed)
    pos = make_positions(rng, n_subs)
    wid = (np.arange(n_subs) * n_worlds // n_subs).astype(np.int32)
    cubes = cube_coords_batch(pos, CUBE)
    keys = spatial_keys(wid, cubes, 0)
    keys2 = spatial_keys2(wid, cubes, 0)
    peers = rng.permutation(n_subs).astype(np.int32)
    peers[rng.random(n_subs) < 0.02] = -1           # tombstones
    d = delta_rows if delta_rows is not None else max(8, n_subs // 16)
    dsel = rng.integers(0, n_subs, d)               # churn into hot cubes
    dkeys, dkeys2 = keys[dsel], keys2[dsel]
    dpeers = rng.integers(0, n_subs, d).astype(np.int32)
    qw, qpos, qs, qr = make_query_batch(rng, pos, wid, n_queries)
    qr = rng.integers(0, 3, n_queries).astype(np.int8)
    q = encode_queries(qw, qpos, qs, qr, n_queries, CUBE, 0)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {
        "base": tuple(put(a) for a in (keys, keys2, peers)),
        "delta": tuple(put(a) for a in (
            pad_to(dkeys, next_pow2(d), PAD_KEY),
            pad_to(dkeys2, next_pow2(d), np.int64(0)),
            pad_to(dpeers, next_pow2(d), np.int32(-1)))),
        "queries": tuple(put(a) for a in q),
        "base_buckets": ix.probe_buckets_for(len(np.unique(keys))),
        "delta_buckets": ix.probe_buckets_for(len(np.unique(dkeys))),
    }


def _flat(out) -> list:
    """An op's outputs as a flat list of tensors."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for part in out for t in _flat(part)]


def op_calls(inp: dict) -> list:
    """``[(name, fn)]`` for every op of ``ops/index.py`` (K1–K6) on the
    tensors of :func:`op_inputs`; ``fn()`` returns the op's outputs as a
    flat list of tensors. Shared inputs (the sorted segments, run
    bounds, the CSR result) are built here once, with the ops
    themselves; ``_seg_run_bounds`` also runs with a forced ``oflow``
    (the binary-search branch)."""
    base, delta, q = inp["base"], inp["delta"], inp["queries"]
    nb, nbd = inp["base_buckets"], inp["delta_buckets"]
    dev = q[0].device
    seg = ix._sort_segment_dev(*base, n_buckets=nb)
    dseg = ix._sort_segment_dev(*delta, n_buckets=nbd)
    forced = (*seg[:5], torch.ones_like(seg[5]))
    segs = [seg, dseg]
    flat_args = [*seg, *dseg, *q]
    ks = tuple(next_pow2(int(s[3].max()), 8) for s in segs)
    los, cnts = ix.run_bounds_all(segs, q)
    counts_host = torch.stack(cnts, dim=1).cpu().numpy()
    t_cap = next_pow2(2 * ix.padded_slots(counts_host))
    counts, flat, total = ix.match_run_csr(flat_args, 2, t_cap)
    bucket = next_pow2(int(total))
    m = q[0].shape[0]
    rows_cap_b = (t_cap - m * ix.CSR_ROW * 2) // ix.CSR_ROW_B
    rng = np.random.default_rng(int(base[0].shape[0]))
    s_rows = seg[0].shape[0]
    dead = rng.integers(0, s_rows, max(8, s_rows // 64)).astype(np.int32)
    dead = pad_to(dead, next_pow2(dead.size), np.int32(s_rows))
    dcap = delta[0].shape[0]
    chunk = tuple(a[: dcap // 4].cpu().numpy() for a in base)
    live = int((base[2] >= 0).sum()) + int((delta[2] >= 0).sum())
    dense = ix._multi_match(flat_args, ks)
    vals = ix._window_gather(seg[2], los[0], ix.CSR_ROW)
    calls = [
        ("_bucket_hash", lambda: ix._bucket_hash(seg[0])),
        ("probe_tables",
         lambda: ix.probe_tables(seg[0], seg[1], n_buckets=nb)),
        ("run_remainders", lambda: ix.run_remainders(seg[0])),
        ("_sort_segment_dev",
         lambda: ix._sort_segment_dev(*base, n_buckets=nb)),
        ("_probe_run_bounds", lambda: ix._probe_run_bounds(
            seg[4], seg[1], seg[3], q[0], q[1])),
        ("_run_bounds", lambda: ix._run_bounds(
            seg[0], seg[1], seg[3], q[0], q[1])),
        ("_seg_run_bounds", lambda: ix._seg_run_bounds(seg, q[0], q[1])),
        ("_seg_run_bounds[oflow]",
         lambda: ix._seg_run_bounds(forced, q[0], q[1])),
        ("run_bounds_all", lambda: ix.run_bounds_all(segs, q)),
        ("zone_b_cnts", lambda: ix.zone_b_cnts(cnts)),
        ("csr_layout", lambda: ix.csr_layout(
            ix.zone_b_cnts(cnts), rows_cap_b, ix.CSR_ROW_B)),
        ("_repl_mask", lambda: ix._repl_mask(
            vals, q[2][:, None], q[3][:, None])),
        ("match_run_csr", lambda: ix.match_run_csr(flat_args, 2, t_cap)),
        ("run_csr_assemble", lambda: ix.run_csr_assemble(
            segs, los, cnts, cnts, q, t_cap)),
        ("pack_csr", lambda: ix.pack_csr(counts, flat, bucket=bucket)),
        ("_scatter_dead", lambda: ix._scatter_dead(seg[2], dead)),
        ("_write_chunk", lambda: ix._write_chunk(delta, chunk, dcap // 2)),
        ("_grow_buffers", lambda: ix._grow_buffers(delta, 2 * dcap)),
        ("_alloc_buffers", lambda: ix._alloc_buffers(dcap, dev)),
        ("_device_compact", lambda: ix._device_compact(
            *seg[:3], *delta, cap2=next_pow2(live), n_buckets=nb)),
        ("_probe_only_dev",
         lambda: ix._probe_only_dev(seg[0], seg[1], n_buckets=nb)),
        ("_window_gather",
         lambda: ix._window_gather(seg[2], los[0], ix.CSR_ROW_B)),
        ("_gather_filtered", lambda: ix._gather_filtered(
            seg[2], los[0], cnts[0], q[2], q[3], k=ks[0])),
        ("match_core", lambda: ix.match_core(seg, *q, k=ks[0])),
        ("_multi_match", lambda: ix._multi_match(flat_args, ks)),
        ("compact_sparse", lambda: ix.compact_sparse(dense, c=m // 2)),
    ]
    return [(name, (lambda fn=fn: _flat(fn()))) for name, fn in calls]
