"""The port's spatial query library against the JAX package's.

* K10 (``queries/knn.py::_knn_order_kernel``) and K11
  (``queries/geometry.py::_cone_mask_kernel``, ``_density_mask_kernel``)
  on the CPU against the JAX functions (jitted, JAX on the CPU) and
  against the numpy oracle's own expressions (``queries/oracle.py``):
  random parameters from ``kind_cols``, stencil radii 0–3, row counts
  that are not a multiple of the 64-row tier, a zero-length cone
  direction, the apex, and all-pad rows.
* ``expand_staged``: the plan and the probe arrays equal JAX's.
* ``CudaSpatialBackend(device="cpu")`` against ``TpuSpatialBackend`` and
  ``CpuSpatialBackend`` on one seeded index: per kind in each
  replication mode, the mixed batch, the all-zero kind column as the
  radius path, the object-list path, delta-tick reuse per kind, and the
  kind leg of the boot tier walk.

Tolerance: exact everywhere. Kind results compare by (kind, peers,
extra); radius rows equal JAX's in order and the cpu index's as sets.
"""

from __future__ import annotations

import uuid

import numpy as np
import pytest
import torch

from worldql_server_tpu.protocol.types import (
    Replication as JRepl, Vector3 as JVec)
from worldql_server_tpu.queries import expand as jexpand
from worldql_server_tpu.queries import geometry as jgeo
from worldql_server_tpu.queries import knn as jknn
from worldql_server_tpu.queries.oracle import _displacements
from worldql_server_tpu.spatial.backend import LocalQuery as JQuery
from worldql_server_tpu.spatial.precompile import (
    _precompile_kind_tiers as j_kind_tiers)
from worldql_server_tpu.spatial.tpu_backend import TpuSpatialBackend
from worldql_server_tpu_torch.protocol.types import Replication, Vector3
from worldql_server_tpu_torch.queries import expand, geometry, knn
from worldql_server_tpu_torch.queries.kinds import (
    KIND_CONE, KIND_DENSITY, KIND_KNN, PARAM_LANES)
from worldql_server_tpu_torch.queries.stencil import stencil_offsets
from worldql_server_tpu_torch.spatial.backend import LocalQuery
from worldql_server_tpu_torch.spatial.cpu_backend import CpuSpatialBackend
from worldql_server_tpu_torch.spatial.cuda_backend import CudaSpatialBackend
from worldql_server_tpu_torch.spatial.precompile import (
    _precompile_kind_tiers, precompile_tiers)
from worldql_server_tpu_torch.spatial.quantize import cube_coords_batch
from worldql_server_tpu_torch.tools.index_bench import (
    KIND_IDS, kind_cols, mixed_cols, query_results_match)

CUBE = 16
N_SUBS = 2000
N_WORLDS = 3
CPU = torch.device("cpu")


# ------------------------------------------------------------------
# K10 / K11 against JAX and the numpy oracle


def _edge_params(rng, m, kind_id):
    """``kind_cols`` rows, with the edge rows in front: a zero-length
    cone direction, a full-stencil reach, an all-zero (pad-like) row."""
    _, params = kind_cols(rng, m, kind_id)
    if kind_id == KIND_CONE:
        params[0, 0:3] = 0.0           # zero-length direction
        params[1, 4] = 3 * CUBE
        params[1, 3] = -1.0            # half angle 180 degrees
    elif kind_id == KIND_KNN:
        params[1, 1] = 4000.0          # every stencil slot in range
    elif kind_id == KIND_DENSITY:
        params[1, 0] = 3.0
    params[2] = 0.0                    # an all-pad row
    return params


def _oracle_cone(params, off):
    dx, dy, dz, d2 = _displacements(off, CUBE)
    dist = np.sqrt(d2)
    rows = []
    for p in params:
        dot = dx * p[0] + dy * p[1] + dz * p[2]
        rows.append((dist <= p[4]) & ((dot >= dist * p[3]) | (d2 == 0.0)))
    return np.stack(rows)


def _oracle_knn(params, off):
    """The oracle's walk order per row: in-range slots by (f32 d2,
    idx)."""
    _, _, _, d2 = _displacements(off, CUBE)
    dist = np.sqrt(d2)
    order = np.lexsort((np.arange(off.shape[0]), d2.astype(np.float32)))
    return [[int(s) for s in order if dist[s] <= p[1]] for p in params]


@pytest.mark.parametrize("radius", [0, 1, 2, 3])
@pytest.mark.parametrize("m", [3, 37, 64, 130])
def test_cone_and_density_masks_equal_jax_and_oracle(radius, m):
    rng = np.random.default_rng(100 * radius + m)
    off = stencil_offsets(radius).astype(np.float64)
    cone = _edge_params(rng, m, KIND_CONE)
    got = geometry.cone_mask(cone, off, CUBE, device=CPU)
    assert got.shape == (m, off.shape[0]) and got.dtype == np.bool_
    np.testing.assert_array_equal(got, jgeo.cone_mask(cone, off, CUBE))
    np.testing.assert_array_equal(got, _oracle_cone(cone, off))
    # the apex is always visible, whatever the direction
    apex = np.flatnonzero((off == 0).all(axis=1))[0]
    assert got[:, apex].all()

    dens = _edge_params(rng, m, KIND_DENSITY)
    got = geometry.density_mask(dens, off, device=CPU)
    want = np.max(np.abs(off), axis=1)[None, :] <= dens[:, 0:1]
    np.testing.assert_array_equal(got, jgeo.density_mask(dens, off))
    np.testing.assert_array_equal(got, want)


def test_cone_mask_on_lattice_edges():
    """Cones whose axis and edge both run through lattice points: many
    stencil points sit exactly on the edge (``dot == dist * cos``), where
    one ulp of ``dist`` decides. A stencil distance from torch's f64
    ``sqrt`` on the CPU (one ulp low at ``sqrt(4864.0)``) flipped 2,318
    of 4.7 million such lanes; the host stencil geometry keeps them
    equal to the oracle and to JAX."""
    off = stencil_offsets(3).astype(np.float64)
    nz = off[(off != 0).any(axis=1)]
    unit = nz / np.linalg.norm(nz, axis=1, keepdims=True)
    rng = np.random.default_rng(9)
    rows = [[*unit[i], float(unit[i] @ unit[j]), 3.0 * CUBE, 0.0]
            for i in range(len(unit))
            for j in rng.choice(len(unit), 24, replace=False)]
    params = np.asarray(rows)
    got = geometry.cone_mask(params, off, CUBE, device=CPU)
    np.testing.assert_array_equal(got, jgeo.cone_mask(params, off, CUBE))
    np.testing.assert_array_equal(got, _oracle_cone(params, off))


@pytest.mark.parametrize("radius", [0, 1, 2, 3])
@pytest.mark.parametrize("m", [3, 37, 64, 130])
def test_knn_order_equals_jax_and_oracle(radius, m):
    rng = np.random.default_rng(7 + 100 * radius + m)
    off = stencil_offsets(radius).astype(np.float64)
    params = _edge_params(rng, m, KIND_KNN)
    order, n_ok = knn.knn_order(params, off, CUBE, device=CPU)
    j_order, j_n_ok = jknn.knn_order(params, off, CUBE)
    assert order.dtype == np.int32 and n_ok.dtype == np.int32
    np.testing.assert_array_equal(order, np.asarray(j_order))
    np.testing.assert_array_equal(n_ok, np.asarray(j_n_ok))
    for row, cnt, want in zip(order, n_ok, _oracle_knn(params, off)):
        assert row[:cnt].tolist() == want
        assert (row[cnt:] == -1).all()  # pad slots read -1, as in JAX


def test_kernels_on_padded_tiers_equal_jax():
    """The device functions themselves on the padded tier, pad rows
    included (the wrappers slice them away)."""
    rng = np.random.default_rng(5)
    off = stencil_offsets(3).astype(np.float64)
    padded = {k: geometry._pad_rows(_edge_params(rng, 70, k))[0]
              for k in (KIND_CONE, KIND_KNN, KIND_DENSITY)}
    assert padded[KIND_CONE].shape[0] == 128
    t_off = torch.from_numpy(off)
    geom = torch.from_numpy(geometry.stencil_geometry(off, CUBE))
    import jax.numpy as jnp

    j_off = jnp.asarray(off)
    got = geometry._cone_mask_kernel(
        torch.from_numpy(padded[KIND_CONE]), geom)
    want = jgeo._cone_mask_kernel(
        jnp.asarray(padded[KIND_CONE]), j_off, jnp.float64(CUBE))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = geometry._density_mask_kernel(
        torch.from_numpy(padded[KIND_DENSITY]), t_off)
    want = jgeo._density_mask_kernel(jnp.asarray(padded[KIND_DENSITY]), j_off)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    order, n_ok = knn._knn_order_kernel(
        torch.from_numpy(padded[KIND_KNN]), geom)
    j_order, j_n_ok = jknn._knn_order_kernel(
        jnp.asarray(padded[KIND_KNN]), j_off, jnp.float64(CUBE))
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(n_ok.numpy(), np.asarray(j_n_ok))
    assert (n_ok[70:] == 1).all()  # all-pad rows: the apex alone


# ------------------------------------------------------------------
# the seeded index on the three backends


def _build(backend, rng):
    positions = rng.uniform(-56.0, 56.0, (N_SUBS, 3))
    cubes = cube_coords_batch(positions, CUBE)
    peers = [uuid.UUID(int=i + 1) for i in range(N_SUBS)]
    world_ids = np.arange(N_SUBS) * N_WORLDS // N_SUBS
    for w in range(N_WORLDS):
        sel = np.flatnonzero(world_ids == w)
        backend.bulk_add_subscriptions(
            f"world_{w}", [peers[i] for i in sel], cubes[sel])
    return peers, positions, world_ids


class Trio:
    """One seeded index on the port's cuda index (on the CPU), the JAX
    package's tpu index (JAX on the CPU) and the port's cpu index."""

    def __init__(self):
        self.t = CudaSpatialBackend(CUBE, device="cpu")
        self.j = TpuSpatialBackend(CUBE)
        self.c = CpuSpatialBackend(CUBE)
        for b in (self.t, self.j, self.c):
            self.peers, self.positions, self.world_ids = _build(
                b, np.random.default_rng(170))
        for b in (self.t, self.j):
            b.flush()
            b.wait_compaction()

    def staged(self, rng, m, repl=None, n_empty=4):
        """Staged columns as engine/staging.py interns them (equal ids
        on both device indexes), senders from the index, the last
        ``n_empty`` rows far outside it."""
        senders = rng.integers(0, N_SUBS, m)
        cols = []
        for b in (self.t, self.j):
            wid = np.array([b._world_ids[f"world_{w}"]
                            for w in self.world_ids[senders]], np.int32)
            sid = np.array([b._peer_ids[self.peers[s]] for s in senders],
                           np.int32)
            cols.append((wid, sid))
        assert all((a == b).all() for a, b in zip(*cols))
        pos = np.ascontiguousarray(self.positions[senders], np.float64)
        if n_empty:
            pos[-n_empty:] += 4000.0
        rp = (rng.integers(0, 3, m) if repl is None
              else np.full(m, int(repl))).astype(np.int8)
        return senders, (cols[0][0], pos, cols[0][1], rp)

    def queries(self, senders, cols, kinds, params, jax=False):
        Q, V, R = (JQuery, JVec, JRepl) if jax else (
            LocalQuery, Vector3, Replication)
        _, pos, _, rp = cols
        return [Q(f"world_{self.world_ids[s]}", V(*map(float, pos[i])),
                  self.peers[s], R(int(rp[i])), kind=int(kinds[i]),
                  params=tuple(params[i]))
                for i, s in enumerate(senders)]

    def check(self, senders, cols, kinds, params):
        """Dispatch on both device indexes (staged), resolve on the cpu
        index; every lane equal. Returns the port's result."""
        got = self.t.collect_local_batch(
            self.t.dispatch_staged_batch(*cols, kinds, params))
        want = self.j.collect_local_batch(
            self.j.dispatch_staged_batch(*cols, kinds, params))
        ref = self.c.match_local_batch(
            self.queries(senders, cols, kinds, params))
        assert len(got) == len(want) == len(ref) == len(senders)
        for i, (g, w, r) in enumerate(zip(got, want, ref)):
            assert query_results_match(g, w), f"row {i}: {g!r} vs jax {w!r}"
            assert query_results_match(g, r), f"row {i}: {g!r} vs cpu {r!r}"
            if kinds[i] == 0:
                assert g == w  # radius rows: JAX's order, lane for lane
        return got


@pytest.fixture(scope="module")
def trio():
    return Trio()


@pytest.mark.parametrize("repl", list(Replication),
                         ids=lambda r: r.name.lower())
@pytest.mark.parametrize("name", sorted(KIND_IDS))
def test_kind_parity_three_backends(trio, name, repl):
    rng = np.random.default_rng(10 * KIND_IDS[name] + int(repl))
    m = 64
    senders, cols = trio.staged(rng, m, repl)
    kinds, params = kind_cols(rng, m, KIND_IDS[name])
    params[: m // 2] = _edge_params(rng, m // 2, KIND_IDS[name])
    before = trio.t.kind_expansions
    out = trio.check(senders, cols, kinds, params)
    assert trio.t.kind_expansions == before + 1
    assert all(hasattr(r, "extra") for r in out)
    # the teleported tail really exercised the empty shape
    assert all(not r.peers and not r.extra.get("cubes") for r in out[-4:])
    assert any(r.peers or r.extra.get("cubes") for r in out)


def test_mixed_kind_batch_one_dispatch(trio):
    rng = np.random.default_rng(15)
    m = 200
    senders, cols = trio.staged(rng, m, n_empty=5)
    kinds, params = mixed_cols(rng, m)
    before = trio.t.kind_expansions
    out = trio.check(senders, cols, kinds, params)
    assert trio.t.kind_expansions == before + 1
    for i in range(m):
        assert hasattr(out[i], "extra") == (kinds[i] != 0)


def test_expand_staged_equals_jax(trio):
    rng = np.random.default_rng(22)
    m = 150
    _, cols = trio.staged(rng, m, n_empty=3)
    kinds, params = mixed_cols(rng, m)
    kw = dict(cube_size=CUBE, stencil_max=3, ray_steps_max=64)
    plan, *probes = expand.expand_staged(*cols, kinds, params, device=CPU,
                                         **kw)
    j_plan, *j_probes = jexpand.expand_staged(*cols, kinds, params, **kw)
    assert plan.m == j_plan.m == m
    for field in ("kinds", "params", "probe_owner", "probe_t",
                  "probe_cube"):
        a, b = getattr(plan, field), getattr(j_plan, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    for a, b in zip(probes, j_probes):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(probes[0]) > m  # the kinds expanded into many probes


def test_all_zero_kind_column_is_pure_radius(trio):
    rng = np.random.default_rng(16)
    m = 64
    senders, cols = trio.staged(rng, m, n_empty=0)
    before = trio.t.kind_expansions
    plain = trio.t.collect_local_batch(trio.t.dispatch_staged_batch(*cols))
    zeroed = trio.check(senders, cols, np.zeros(m, np.int8),
                        np.zeros((m, PARAM_LANES), np.float64))
    assert trio.t.kind_expansions == before
    assert zeroed == plain


def test_list_path_kind_dispatch(trio):
    rng = np.random.default_rng(17)
    m = 64
    senders, cols = trio.staged(rng, m, n_empty=2)
    kinds, params = mixed_cols(rng, m)
    got = trio.t.collect_local_batch(trio.t.dispatch_local_batch(
        trio.queries(senders, cols, kinds, params)))
    want = trio.j.collect_local_batch(trio.j.dispatch_local_batch(
        trio.queries(senders, cols, kinds, params, jax=True)))
    ref = trio.c.match_local_batch(trio.queries(senders, cols, kinds, params))
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        assert query_results_match(g, w) and query_results_match(g, r), i


def test_delta_tick_reuse_per_kind(trio):
    """Probes are content-addressed rows: a repeated kind batch replays
    every probe, and the replay equals the first answer and JAX's."""
    for b in (trio.t, trio.j):
        assert b.configure_delta_ticks("on")
    try:
        rng = np.random.default_rng(18)
        m = 64
        for name, kid in sorted(KIND_IDS.items()):
            senders, cols = trio.staged(rng, m, n_empty=2)
            kinds, params = kind_cols(rng, m, kid)
            first = trio.check(senders, cols, kinds, params)
            reused = trio.t.delta_reused
            second = trio.check(senders, cols, kinds, params)
            stats = trio.t.last_delta_stats
            assert trio.t.delta_reused > reused, (name, stats)
            assert stats["reused"] > 0 and stats["recomputed"] == 0, (
                name, stats)
            assert all(query_results_match(a, b)
                       for a, b in zip(first, second)), name
    finally:
        for b in (trio.t, trio.j):
            b.configure_delta_ticks("off")


def test_precompile_walks_the_kind_tiers(trio):
    """The kind leg of the boot walk makes the JAX walk's calls (same
    tiers × radii × registered kinds, same budget); the full walk
    reports them, on an empty index too."""
    for max_batch in (15, 700):
        got = _precompile_kind_tiers(trio.t, max_batch)
        assert got == j_kind_tiers(trio.j, max_batch)
        assert got["kind_dispatches"] > 0
    stats = precompile_tiers(trio.t, max_batch=64)
    assert stats["kind_dispatches"] == _precompile_kind_tiers(
        trio.t, 64)["kind_dispatches"]
    empty = precompile_tiers(CudaSpatialBackend(CUBE, device="cpu"),
                             max_batch=64)
    assert empty["skipped"] == "empty-index"
    assert empty["kind_dispatches"] == stats["kind_dispatches"]
