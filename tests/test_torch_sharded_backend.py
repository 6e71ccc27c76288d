"""The port's mesh index, ``ShardedCudaSpatialBackend`` on the CPU,
against the JAX package's ``ShardedTpuSpatialBackend`` on its 8 virtual
CPU devices (tests/conftest.py).

* Reference cases. Every JAX test of the sharded path —
  ``tests/test_sharded_backend.py`` whole, the sharded cases of
  ``tests/test_compact_fetch.py``, ``tests/test_csr_fanout.py`` and
  ``tests/test_delta_ticks.py`` — runs again on the port, its body the
  reference's line for line (``tests/torch_twin.py``), with the mesh
  built over ``devices=["cpu"] * 8``: virtual shards, the port's
  counterpart of the 8 virtual devices.
* Lane for lane. The same seeded adds, removes and moves go to both
  backends on the same mesh shape, for each of (1,8) (2,4) (4,2) (8,1)
  and the non-power-of-two (3,2); the dense ``match_arrays`` table, the
  sparse triple, the raw CSR triple (``csr_cap`` set), the packed fetch
  of ``_compact_fetch``, ``splits`` / ``shard_cap`` after the upload,
  and every shard's device arrays after a device-side fold and after an
  imbalance reshard must be equal.

Tolerance: exact (every output is an integer array).
"""

from __future__ import annotations

import inspect
import re
import uuid

import numpy as np
import pytest
import torch

import tests.test_compact_fetch as ref_compact
import tests.test_csr_fanout as ref_csr
import tests.test_delta_ticks as ref_delta
import tests.test_sharded_backend as ref_sharded
from tests.torch_twin import call, case_id, cases, port_module
from worldql_server_tpu.parallel import (
    ShardedTpuSpatialBackend, make_fanout_mesh as j_mesh)
from worldql_server_tpu.spatial.quantize import (
    cube_coords_batch as j_cubes)
from worldql_server_tpu_torch.parallel import (
    ShardedCudaSpatialBackend, make_fanout_mesh)
from worldql_server_tpu_torch.spatial.quantize import cube_coords_batch

CPU8 = ["cpu"] * 8

#: the reference's names for its device index, pointed at the port's
_RENAMES = [
    ("ShardedTpuSpatialBackend", "ShardedCudaSpatialBackend"),
    ("spatial.tpu_backend", "spatial.cuda_backend"),
    ("TpuSpatialBackend", "CudaSpatialBackend"),
]


def _port(ref, replace=()):
    """``ref`` bound to the port with ``devices=CPU8`` added to every
    ``make_fanout_mesh(...)`` call of its source."""
    src = inspect.getsource(ref)
    calls = sorted(set(re.findall(r"make_fanout_mesh\([^()]*\)", src)))
    mesh = [(c, c[:-1] + (", " if c[-2] != "(" else "") + "devices=CPU8)")
            for c in calls]
    renames = []
    for old, new in _RENAMES:
        if old in src:
            renames.append((old, new))
            src = src.replace(old, new)
    mod = port_module(ref, replace=[*renames, *mesh, *replace])
    mod.CPU8 = CPU8
    return mod


PORTS = {
    ref_sharded: _port(ref_sharded),
    ref_compact: _port(ref_compact, replace=[
        ("_, t_cap, (counts, flat, total), _ = payload",
         "_, t_cap, (counts, flat, total), *_ = payload"),
    ]),
    ref_csr: _port(ref_csr),
    ref_delta: _port(ref_delta),
}
CASES = [(ref, case) for ref, names in (
    (ref_sharded, [
        "test_split_at_run_boundaries",
        "test_split_single_giant_run",
        "test_sharded_matches_cpu",
        "test_sharded_mutation_then_requery",
        "test_non_pow2_batch_axis",
        "test_make_fanout_mesh_validation",
        "test_sharded_repeated_compaction_churn",
        "test_compaction_worker_failure_surfaces_and_recovers",
        "test_maybe_initialize_distributed_env_contract",
        "test_dist_env_with_wrong_backend_is_a_config_error",
        "test_sharded_compaction_folds_on_device_without_reupload",
        "test_sharded_reshard_on_imbalance_falls_back",
    ]),
    (ref_compact, [
        "test_sharded_compact_decode_matches_full_fetch",
        "test_sharded_imbalance_past_headroom_falls_back_full_fetch",
    ]),
    (ref_csr, [
        "test_sharded_csr_matches_dense",
        "test_sharded_capacity_overflow_signals_retry",
        "test_sharded_tiny_multiseg_tick_with_decayed_cap",
        "test_sharded_between_caps_total_decodes_without_dense_reresolve",
    ]),
    (ref_delta, [
        "test_sharded_backend_supports_delta_via_flat_region_replay",
    ]),
) for case in cases(ref, names)]


@pytest.fixture(autouse=True)
def port_on_the_cpu(monkeypatch):
    monkeypatch.setenv("WQL_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("ref,case", CASES,
                         ids=[case_id(c) for _, c in CASES])
def test_reference_case_on_port(ref, case, request):
    name, params = case
    call(getattr(PORTS[ref], name), params, request)


def test_mesh_devices_virtual_shards_and_defaults(monkeypatch):
    """``devices=`` may name one device more than once (virtual
    shards); without it the mesh takes this host's devices — the CPU
    alone here — so a mesh larger than the host is refused, as JAX
    refuses one larger than its devices."""
    mesh = make_fanout_mesh(2, 4, devices=CPU8)
    assert mesh.shape == {"batch": 2, "space": 4}
    assert mesh.axis_names == ("batch", "space")
    assert mesh.devices == [[torch.device("cpu")] * 4] * 2
    assert mesh.local_positions() == [(b, s) for b in range(2)
                                      for s in range(4)]
    assert mesh.group is None
    assert make_fanout_mesh().shape == {"batch": 1, "space": 1}
    with pytest.raises(ValueError, match="exceeds 1 available devices"):
        make_fanout_mesh(2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        make_fanout_mesh(3, devices=CPU8)


# --------------------------------------------------------------------
# lane for lane against the JAX mesh
# --------------------------------------------------------------------

SHAPES = [(1, 8), (2, 4), (4, 2), (8, 1), (3, 2)]
CUBE = 16


class Pair:
    """The JAX mesh index and the port's on the same mesh shape, fed
    the same mutations."""

    def __init__(self, nb, ns, threshold=1 << 20):
        self.j = ShardedTpuSpatialBackend(CUBE, j_mesh(nb, ns),
                                          compact_threshold=threshold)
        self.t = ShardedCudaSpatialBackend(
            CUBE, make_fanout_mesh(nb, ns, devices=CPU8),
            compact_threshold=threshold)
        self.both = (self.j, self.t)

    def call(self, name, *args):
        out = [getattr(b, name)(*args) for b in self.both]
        assert out[0] == out[1], name
        return out[0]

    def settle(self):
        for b in self.both:
            b.flush()
            b.wait_compaction()

    def fold(self):
        """One compaction on each, drained: the serving flushes in
        between start none (a background fold swaps in at whichever
        flush finds it done, so two backends would drift apart)."""
        for b in self.both:
            b._compact_threshold_override = 8
            b._dirty = True  # a flush runs its compaction policy
        self.settle()
        for b in self.both:
            b._compact_threshold_override = 1 << 20


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.shape,
                                                       b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _shard_stack(mesh_array):
    """A port MeshArray as the JAX stack: shards stacked on axis 0."""
    return torch.stack([mesh_array.shard(s)
                        for s in range(len(mesh_array.cols))])


def _same_base(p: Pair, what):
    jb, tb = p.j._base_bundle, p.t._base_bundle
    assert (jb is None) == (tb is None), what
    if jb is None:
        return
    _eq(jb["splits"], tb["splits"], f"{what}: splits")
    assert jb["shard_cap"] == tb["shard_cap"], what
    assert jb["cap"] == tb["cap"], what
    for i, (ja, ta) in enumerate(zip(jb["dev"], tb["dev"])):
        _eq(ja, _shard_stack(ta), f"{what}: base array {i}")


def _same_delta(p: Pair, what):
    jd, td = p.j._delta_bundle, p.t._delta_bundle
    assert (jd is None) == (td is None), what
    if jd is not None:
        for i, (ja, ta) in enumerate(zip(jd["dev"], td["dev"])):
            for s in range(len(ta.cols)):
                _eq(ja, ta.shard(s), f"{what}: delta array {i} col {s}")


def _churn(p: Pair, rng, peers, n_ops, worlds=("a", "b", "c")):
    """Seeded adds, removes and moves, each through the object API and
    the bulk paths, mirrored to both backends."""
    for _ in range(n_ops):
        op = rng.random()
        w = worlds[int(rng.integers(len(worlds)))]
        i = int(rng.integers(len(peers)))
        pos = tuple(float(v) for v in rng.uniform(-150, 150, 3))
        if op < 0.55:
            p.call("add_subscription", w, peers[i], pos)
        elif op < 0.75:
            p.call("remove_subscription", w, peers[i], pos)
        else:
            k = int(rng.integers(1, 6))
            idx = rng.integers(0, len(peers), k)
            old = rng.uniform(-150, 150, (k, 3))
            new = rng.uniform(-150, 150, (k, 3))
            ps = [peers[j] for j in idx]
            p.call("bulk_add_subscriptions", w, ps, j_cubes(old, CUBE))
            assert np.array_equal(j_cubes(old, CUBE),
                                  cube_coords_batch(old, CUBE))
            p.call("bulk_move_subscriptions", w, ps, j_cubes(old, CUBE),
                   ps, j_cubes(new, CUBE))


def _batch(p: Pair, rng, m):
    worlds = list(p.j._world_ids) + ["never"]
    peers = list(p.j._peer_ids)
    wid = np.array([p.j._world_ids.get(worlds[int(w)], -1)
                    for w in rng.integers(0, len(worlds), m)], np.int32)
    pos = rng.uniform(-150, 150, (m, 3))
    sid = np.array([p.j._peer_ids[peers[int(s)]]
                    for s in rng.integers(0, len(peers), m)], np.int32)
    sid[::7] = -1
    repl = rng.integers(0, 3, m).astype(np.int8)
    return wid, pos, sid, repl


def _same_results(p: Pair, rng, what, m=96):
    batch = _batch(p, rng, m)
    _eq(p.j.match_arrays(*batch), p.t.match_arrays(*batch),
        f"{what}: dense")
    _, js = p.j.match_arrays_async(*batch, max_hits=64)
    _, ts = p.t.match_arrays_async(*batch, max_hits=64)
    for i, (a, b) in enumerate(zip(js, ts)):
        _eq(a, b, f"{what}: sparse {i}")
    for b in p.both:
        b.compact_fetch_min_cap = 0
        b.compact_min_bucket = 8
    _, jc = p.j.match_arrays_async(*batch, csr_cap=8192)
    _, tc = p.t.match_arrays_async(*batch, csr_cap=8192)
    for i, (a, b) in enumerate(zip(jc, tc)):
        _eq(a, b, f"{what}: csr {i}")
    total = int(jc[2])
    jp = p.j._compact_fetch(jc[0], jc[1], total, jc[1].shape[0])
    tp = p.t._compact_fetch(tc[0], tc[1], total, tc[1].shape[0])
    assert (jp is None) == (tp is None), what
    if jp is not None:
        _eq(jp, tp, f"{what}: packed fetch")
    counts = np.asarray(jc[0])
    assert p.j._decode_csr(counts, np.asarray(jc[1]), m) == \
        p.t._decode_csr(counts, tc[1].numpy(), m)


@pytest.mark.parametrize("nb,ns", SHAPES)
def test_mesh_lane_for_lane_with_the_jax_mesh(nb, ns):
    rng = np.random.default_rng(0x5EED + 10 * nb + ns)
    p = Pair(nb, ns)
    peers = [uuid.UUID(int=0xB000 + i) for i in range(48)]
    # a bulk load: the base goes up through _upload_base at the flush
    load = rng.uniform(-150, 150, (400, 3))
    p.call("bulk_add_subscriptions", "a", [peers[i % 48] for i in
                                            range(400)], j_cubes(load, CUBE))
    p.settle()
    _same_base(p, "upload")
    _same_results(p, rng, "upload")

    # churn: delta rows, tombstones in base and delta, folds on device
    uploads = {"j": 0, "t": 0}
    for key, b in (("j", p.j), ("t", p.t)):
        real = b._upload_base

        def counted(*a, _real=real, _key=key, **kw):
            uploads[_key] += 1
            return _real(*a, **kw)

        b._upload_base = counted
    for step in range(2):
        _churn(p, rng, peers, 100)
        for b in p.both:
            b.flush()
        _same_delta(p, f"churn {step}")
        _same_results(p, rng, f"churn {step}")
        p.fold()
        _same_base(p, f"after fold {step}")
        _same_results(p, rng, f"after fold {step}")
    assert p.j.compactions == p.t.compactions >= 1
    assert uploads["j"] == uploads["t"]
    if ns > 1:
        # a multi-shard mesh folds on the device (a fold that finds the
        # shards out of balance re-uploads, on both sides alike)
        assert p.t.compactions > uploads["t"], uploads

    # a forced imbalance: every compaction re-shards through an upload
    for b in p.both:
        b.RESHARD_IMBALANCE = -1.0
    _churn(p, rng, peers, 150)
    p.fold()
    assert uploads["j"] == uploads["t"] >= 1
    _same_base(p, "reshard")
    _same_results(p, rng, "reshard")
