"""Kind expansion: mixed staged batches → probe rows on the radius path.

``expand_staged`` is the dispatch-side half of the library: it takes
the staged columns (now carrying ``kind``/``par`` lanes), partitions
the batch by kind, runs each kind's stencil kernel (:mod:`geometry`,
:mod:`knn`) on the backend's device and emits one flat *probe batch* —
(world, sample-position, sender, replication) rows in the exact layout
:func:`~worldql_server_tpu_torch.spatial.native_keys.encode_queries`
already consumes. The probe batch then rides the UNCHANGED dispatch/CSR
machinery (including delta-tick reuse: probes are content-addressed
rows, so a repeated cone replays its cached cubes), and
``fold_collected`` — the collect-side half — folds the per-probe
fan-out lists back into one result per original query.

Port of the JAX package's ``queries/expand.py``, host numpy copied as
it is; the one change is that the kernels run on the ``device`` the
caller (the index) passes down.

Everything here is vectorized numpy + device kernels over the whole
batch: no per-query Python on the dispatch path (the
``per-query-python-loop`` lint rule covers this module's dispatch
functions). The fold runs collect-side, where per-query list assembly
is already the contract.

Probe-batch layout (group-contiguous, order significant for the fold):
radius rows first (original relative order, one probe each), then
cone / raycast / kNN / density groups — within a group, probes are
owner-major in the order the kind's semantics walk them (stencil-lex
for cone and density, ascending ``t`` for raycast, kernel distance
order for kNN), deduplicated keep-first per (owner, cube).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..protocol.types import Replication
from ..spatial.quantize import cube_coords_batch
from .geometry import cone_mask, density_mask
from .kinds import (
    KIND_CONE,
    KIND_DENSITY,
    KIND_KNN,
    KIND_RADIUS,
    KIND_RAYCAST,
    RAY_ALL_HITS,
)
from .knn import knn_order
from .results import KindResult, _uuid_key  # noqa: F401  (re-export)
from .stencil import stencil_offsets, stencil_radius


@dataclass
class KindPlan:
    """Host-side fold plan built at expansion (owned copies — the
    staging views it was built from are recycled by the double
    buffer)."""

    m: int
    kinds: np.ndarray        # i8 [m]
    params: np.ndarray       # f64 [m, PARAM_LANES]
    probe_owner: np.ndarray  # i32 [P] original query index per probe
    probe_t: np.ndarray      # f64 [P] ray parameter (0 for other kinds)
    probe_cube: np.ndarray   # i64 [P, 3] cube label per probe


def _sample_probes(owner, positions, disp):
    """Owner rows + f64 displacements → probe sample positions."""
    return positions[owner] + disp


def _dedupe_keep_first(owner, pos, cube_size):
    """→ (keep_idx, cubes[keep]) deduplicated per (owner, cube),
    preserving first occurrence in the given order. Vectorized: one
    quantize + one lexicographic unique, no per-probe Python."""
    cubes = cube_coords_batch(pos, cube_size)
    key = np.concatenate(
        [owner[:, None].astype(np.int64), cubes], axis=1
    )
    _, first = np.unique(key, axis=0, return_index=True)
    keep = np.sort(first)
    return keep, cubes[keep]


def expand_staged(world_ids, positions, sender_ids, repls, kinds, params,
                  *, cube_size: int, device, stencil_max: int = 3,
                  ray_steps_max: int = 64):
    """Mixed staged columns → (plan, probe world_ids, probe positions,
    probe sender_ids, probe repls). The probe columns are dispatch-ready
    for the plain radius pipeline; ``plan`` drives the fold. The kind
    kernels run on ``device``."""
    kinds = np.ascontiguousarray(kinds, np.int8)
    params = np.ascontiguousarray(params, np.float64)
    positions = np.ascontiguousarray(positions, np.float64)
    world_ids = np.ascontiguousarray(world_ids, np.int32)
    sender_ids = np.ascontiguousarray(sender_ids, np.int32)
    repls = np.ascontiguousarray(repls, np.int8)
    m = int(kinds.shape[0])
    size = float(cube_size)

    owners: list[np.ndarray] = []
    probe_pos: list[np.ndarray] = []
    probe_t: list[np.ndarray] = []
    probe_cube: list[np.ndarray] = []
    repl_rows: list[np.ndarray] = []

    def _push(owner, pos, t=None, repl_override=None):
        if owner.size == 0:
            return
        owner = owner.astype(np.int32)
        keep, cubes = _dedupe_keep_first(owner, pos, cube_size)
        owners.append(owner[keep])
        probe_pos.append(pos[keep])
        probe_t.append(
            t[keep] if t is not None
            else np.zeros(keep.shape[0], np.float64)
        )
        probe_cube.append(cubes)
        if repl_override is None:
            repl_rows.append(repls[owner[keep]])
        else:
            repl_rows.append(
                np.full(keep.shape[0], repl_override, np.int8)
            )

    # radius rows pass through 1:1 in original order (no dedupe — the
    # pure-radius contract is byte-for-byte the existing path)
    radius_idx = np.flatnonzero(kinds == KIND_RADIUS).astype(np.int32)
    if radius_idx.size:
        owners.append(radius_idx)
        probe_pos.append(positions[radius_idx])
        probe_t.append(np.zeros(radius_idx.shape[0], np.float64))
        probe_cube.append(
            cube_coords_batch(positions[radius_idx], cube_size)
        )
        repl_rows.append(repls[radius_idx])

    ci = np.flatnonzero(kinds == KIND_CONE)
    if ci.size:
        pc = params[ci]
        off = stencil_offsets(
            stencil_radius(pc[:, 4], cube_size, stencil_max)
        ).astype(np.float64)
        mask = cone_mask(pc, off, cube_size, device=device)
        sel_q, sel_s = np.nonzero(mask)
        _push(ci[sel_q], _sample_probes(ci[sel_q], positions,
                                        off[sel_s] * size))

    ri = np.flatnonzero(kinds == KIND_RAYCAST)
    if ri.size:
        pr = params[ri]
        half = size / 2.0
        max_t = pr[:, 3]
        top = int(min(ray_steps_max, np.floor(np.max(max_t) / half)))
        t_axis = np.arange(top + 1, dtype=np.float64) * half
        valid = t_axis[None, :] <= max_t[:, None]
        sel_q, sel_s = np.nonzero(valid)
        tvals = t_axis[sel_s]
        pos = positions[ri[sel_q]] + pr[sel_q, 0:3] * tvals[:, None]
        _push(ri[sel_q], pos, t=tvals)

    ki = np.flatnonzero(kinds == KIND_KNN)
    if ki.size:
        pk = params[ki]
        off = stencil_offsets(
            stencil_radius(pk[:, 1], cube_size, stencil_max)
        ).astype(np.float64)
        order, n_ok = knn_order(pk, off, cube_size, device=device)
        valid = np.arange(order.shape[1])[None, :] < n_ok[:, None]
        sel_q, sel_s = np.nonzero(valid)          # row-major: rank order
        disp = off[order[sel_q, sel_s]] * size
        _push(ki[sel_q], _sample_probes(ki[sel_q], positions, disp))

    di = np.flatnonzero(kinds == KIND_DENSITY)
    if di.size:
        pd = params[di]
        off = stencil_offsets(
            max(1, min(stencil_max, int(np.max(pd[:, 0]))))
        ).astype(np.float64)
        mask = density_mask(pd, off, device=device)
        sel_q, sel_s = np.nonzero(mask)
        # density counts EVERY subscriber of a cube, the sender's own
        # subscription included
        _push(di[sel_q], _sample_probes(di[sel_q], positions,
                                        off[sel_s] * size),
              repl_override=np.int8(int(Replication.INCLUDING_SELF)))

    owner_all = np.concatenate(owners) if owners else np.empty(0, np.int32)
    pos_all = (
        np.concatenate(probe_pos)
        if probe_pos else np.empty((0, 3), np.float64)
    )
    plan = KindPlan(
        m=m,
        kinds=kinds.copy(),
        params=params.copy(),
        probe_owner=owner_all,
        probe_t=(
            np.concatenate(probe_t) if probe_t
            else np.empty(0, np.float64)
        ),
        probe_cube=(
            np.concatenate(probe_cube) if probe_cube
            else np.empty((0, 3), np.int64)
        ),
    )
    repl_all = (
        np.concatenate(repl_rows) if repl_rows else np.empty(0, np.int8)
    )
    return (
        plan,
        world_ids[owner_all],
        pos_all,
        sender_ids[owner_all],
        repl_all,
    )


def fold_collected(plan: KindPlan, probe_targets) -> list:
    """Collect-side fold: per-probe fan-out lists → one entry per
    original query. Radius rows get their plain peer list (identical
    to the unexpanded path); kind rows get a :class:`KindResult`."""
    out: list = [None] * plan.m
    groups: dict[int, list[int]] = {}
    for p in range(plan.probe_owner.shape[0]):
        qi = int(plan.probe_owner[p])
        if plan.kinds[qi] == KIND_RADIUS:
            out[qi] = probe_targets[p]
        else:
            groups.setdefault(qi, []).append(p)

    for qi, probes in groups.items():
        kind = int(plan.kinds[qi])
        if kind == KIND_CONE:
            seen: set = set()
            for p in probes:
                seen.update(probe_targets[p])
            out[qi] = KindResult(kind, sorted(seen, key=_uuid_key))
        elif kind == KIND_RAYCAST:
            out[qi] = _fold_raycast(plan, qi, probes, probe_targets)
        elif kind == KIND_KNN:
            out[qi] = _fold_knn(plan, qi, probes, probe_targets)
        elif kind == KIND_DENSITY:
            out[qi] = _fold_density(plan, qi, probes, probe_targets)
        else:  # unregistered kind staged somehow: reply empty, loudly
            out[qi] = KindResult(kind, [])
    return out


def _fold_raycast(plan, qi, probes, probe_targets) -> KindResult:
    all_hits = plan.params[qi, 4] == RAY_ALL_HITS
    peers: list = []
    ts: list = []
    seen: set = set()
    for p in probes:
        hit = sorted(set(probe_targets[p]), key=_uuid_key)
        if not hit:
            continue
        t = float(plan.probe_t[p])
        if not all_hits:
            return KindResult(
                KIND_RAYCAST, hit, {"t": t, "mode": "first_hit"}
            )
        for u in hit:
            if u not in seen:
                seen.add(u)
                peers.append(u)
                ts.append(t)
    if not all_hits:
        return KindResult(KIND_RAYCAST, [], {"t": None, "mode": "first_hit"})
    return KindResult(KIND_RAYCAST, peers, {"ts": ts, "mode": "all_hits"})


def _fold_knn(plan, qi, probes, probe_targets) -> KindResult:
    k = int(plan.params[qi, 0])
    peers: list = []
    seen: set = set()
    for p in probes:
        if len(peers) >= k:
            break
        for u in sorted(set(probe_targets[p]), key=_uuid_key):
            if u not in seen:
                seen.add(u)
                peers.append(u)
                if len(peers) >= k:
                    break
    return KindResult(KIND_KNN, peers, {"k": k})


def _fold_density(plan, qi, probes, probe_targets) -> KindResult:
    entries = []
    for p in probes:
        count = len(set(probe_targets[p]))
        if count:
            cube = plan.probe_cube[p]
            entries.append(
                (int(cube[0]), int(cube[1]), int(cube[2]), count)
            )
    entries.sort(key=lambda e: (-e[3], e[0], e[1], e[2]))
    top_n = int(plan.params[qi, 1])
    return KindResult(
        KIND_DENSITY, [],
        {"cubes": [list(e) for e in entries[:top_n]]},
    )
