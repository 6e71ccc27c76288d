"""Reference fan-out and query answers over a plain subscription table.

A subscription is a row (world id, peer id, cube label). A LocalMessage
from ``sender`` at ``position`` in ``world`` goes to every peer
subscribed to the cube that holds the position, filtered by its
replication mode: 0 every peer but the sender, 1 every peer, 2 the
sender alone (upstream local_message.rs:60-86).

The query kinds follow the broker's cube-sampled contract: a query
samples lattice points around its position, each sampled cube answers
as a LocalMessage would, and the kind folds the per-cube answers:

* cone (1), params ``[ux, uy, uz, cos_half_angle, range]``: the union
  of the cubes whose lattice offset lies within ``range`` and inside
  the cone (the offset 0 always), peers in ascending id;
* raycast (2), params ``[ux, uy, uz, max_t, mode]``: samples at
  ``t = j * size / 2`` up to ``max_t`` (at most ``ray_steps + 1``), each
  new cube in ``t`` order; mode 0 answers the first cube with a peer,
  mode 1 every peer once, with the ``t`` of the cube it was first hit in;
* knn (3), params ``[k, max_range]``: offsets within ``max_range`` in
  order of float32 squared distance, ties by lattice order, peers of
  each new cube in ascending id, the first ``k`` distinct;
* density (4), params ``[extent, top_n]``: the cubes within Chebyshev
  ``extent`` (clamped to ``[1, stencil_max]``) with their subscriber
  counts, the sender included, largest first, ties by cube label,
  the first ``top_n``.

Stencils have radius ``min(stencil_max, ceil(reach / size))``, at
least 1, offsets in lexicographic order (x, then y, then z, each from
``-r`` to ``r``).
"""

from __future__ import annotations

import numpy as np

from .quantize import cube_labels

KIND_RADIUS, KIND_CONE, KIND_RAYCAST, KIND_KNN, KIND_DENSITY = range(5)
EXCEPT_SELF, INCLUDING_SELF, ONLY_SELF = 0, 1, 2

_AXIS_BITS = 18
_AXIS_BIAS = 1 << (_AXIS_BITS - 1)
_WORLD_BITS = 63 - 3 * _AXIS_BITS


def cube_keys(world_ids: np.ndarray, cubes: np.ndarray,
              size: int) -> np.ndarray:
    """(world, cube label) → one int64 key, order-free and exact."""
    cells = cubes // size + _AXIS_BIAS
    if cells.size and (cells.min() < 0 or cells.max() >= 1 << _AXIS_BITS):
        raise ValueError("cube label outside the reference's key range")
    w = np.asarray(world_ids, np.int64)
    if w.size and (w.min() < 0 or w.max() >= 1 << _WORLD_BITS):
        raise ValueError("world id outside the reference's key range")
    key = w
    for axis in range(3):
        key = (key << _AXIS_BITS) | cells[..., axis]
    return key


def stencil(radius: int) -> np.ndarray:
    """[(2r+1)^3, 3] int64 lattice offsets in lexicographic order."""
    axis = np.arange(-radius, radius + 1, dtype=np.int64)
    ux, uy, uz = np.meshgrid(axis, axis, axis, indexing="ij")
    return np.stack([ux.ravel(), uy.ravel(), uz.ravel()], axis=1)


def stencil_radius(reach: float, size: int, stencil_max: int) -> int:
    cubes = int(np.ceil(reach / float(size))) if reach > 0 else 1
    return max(1, min(int(stencil_max), cubes))


class SubscriptionTable:
    """Every live subscription, sorted by cube key."""

    def __init__(self, world_ids: np.ndarray, cubes: np.ndarray,
                 peers: np.ndarray, size: int):
        self.size = size
        keys = cube_keys(world_ids, cubes, size)
        order = np.lexsort((peers, keys))
        self.keys = keys[order]
        self.peers = np.asarray(peers, np.int64)[order]

    def runs(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        lo = np.searchsorted(self.keys, keys, "left")
        hi = np.searchsorted(self.keys, keys, "right")
        return lo, hi

    def probe(self, world_ids, cubes, senders, repls):
        """Probe rows → ``(row, peer)`` pairs, rows ascending and peers
        ascending within a row, after each row's replication filter."""
        lo, hi = self.runs(cube_keys(world_ids, cubes, self.size))
        n = hi - lo
        row = np.repeat(np.arange(lo.size), n)
        start = np.repeat(lo - (np.cumsum(n) - n), n)
        peer = self.peers[start + np.arange(row.size)]
        sender = np.asarray(senders, np.int64)[row]
        repl = np.asarray(repls)[row]
        keep = np.where(repl == EXCEPT_SELF, peer != sender,
                        np.where(repl == ONLY_SELF, peer == sender, True))
        return row[keep], peer[keep]

    def counts(self, world_ids, cubes) -> np.ndarray:
        lo, hi = self.runs(cube_keys(world_ids, cubes, self.size))
        return hi - lo


def fanout(table: SubscriptionTable, world_ids, positions, senders,
           repls) -> tuple[np.ndarray, np.ndarray]:
    """LocalMessages → ``(message, peer)`` recipient pairs, sorted."""
    return table.probe(world_ids, cube_labels(positions, table.size),
                       senders, repls)


def _split(rows: np.ndarray, vals: np.ndarray, n: int) -> list:
    """Pairs sorted by row → one array of values per row 0..n-1."""
    bounds = np.searchsorted(rows, np.arange(n + 1))
    return [vals[bounds[i]:bounds[i + 1]] for i in range(n)]


def _first_unique(owner: np.ndarray, cubes: np.ndarray) -> np.ndarray:
    """Indices of the first occurrence of each (owner, cube), in order."""
    key = np.concatenate([owner[:, None].astype(np.int64), cubes], axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    return np.sort(first)


def queries(table: SubscriptionTable, world_ids, positions, senders, repls,
            kinds, params, *, stencil_max: int, ray_steps: int) -> list:
    """A mixed query batch → one canonical answer per query:
    ``(0, sorted peer ids, None)`` for a radius row, and
    ``(kind, peer ids in answer order, extra)`` for the other kinds."""
    size = table.size
    sizef = float(size)
    positions = np.asarray(positions, np.float64)
    kinds = np.asarray(kinds)
    params = np.asarray(params, np.float64)
    out: list = [None] * len(kinds)

    def probes(owner, samples, override=None):
        """Sample points of owners → deduplicated probes and their
        filtered ``(probe, peer)`` pairs."""
        cubes = cube_labels(samples, size)
        keep = _first_unique(owner, cubes)
        owner, cubes = owner[keep], cubes[keep]
        repl = (np.full(owner.size, override) if override is not None
                else np.asarray(repls)[owner])
        row, peer = table.probe(np.asarray(world_ids)[owner], cubes,
                                np.asarray(senders)[owner], repl)
        return keep, owner, cubes, row, peer

    radius = np.flatnonzero(kinds == KIND_RADIUS)
    if radius.size:
        row, peer = table.probe(
            np.asarray(world_ids)[radius],
            cube_labels(positions[radius], size),
            np.asarray(senders)[radius], np.asarray(repls)[radius])
        for q, peers in zip(radius, _split(row, peer, radius.size)):
            out[q] = (KIND_RADIUS, tuple(peers.tolist()), None)

    sel = np.flatnonzero(kinds == KIND_CONE)
    if sel.size:
        p = params[sel]
        off = stencil(stencil_radius(p[:, 4].max(), size, stencil_max))
        d = off.astype(np.float64) * sizef
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        dist = np.sqrt(d2)
        dot = (d[None, :, 0] * p[:, 0, None] + d[None, :, 1] * p[:, 1, None]
               + d[None, :, 2] * p[:, 2, None])
        mask = (dist[None] <= p[:, 4, None]) & (
            (dot >= dist[None] * p[:, 3, None]) | (d2[None] == 0.0))
        qi, si = np.nonzero(mask)
        _, owner, _, row, peer = probes(sel[qi], positions[sel[qi]] + d[si])
        pairs = np.unique(owner[row] * (1 << 32) + peer)
        per = _split(pairs >> 32, pairs & ((1 << 32) - 1), len(kinds))
        for q in sel:
            out[q] = (KIND_CONE, tuple(per[q].tolist()), {})

    sel = np.flatnonzero(kinds == KIND_RAYCAST)
    if sel.size:
        p = params[sel]
        half = sizef / 2.0
        top = int(min(ray_steps, np.floor(p[:, 3].max() / half)))
        t_axis = np.arange(top + 1, dtype=np.float64) * half
        qi, ti = np.nonzero(t_axis[None, :] <= p[:, 3, None])
        t = t_axis[ti]
        samples = positions[sel[qi]] + p[qi, 0:3] * t[:, None]
        keep, owner, _, row, peer = probes(sel[qi], samples)
        probe_t = t[keep]
        first_probe = np.searchsorted(owner, np.append(sel, len(kinds)))
        first_pair = np.searchsorted(row, first_probe)
        for j, q in enumerate(sel):
            a, b = first_pair[j], first_pair[j + 1]
            r, pe = row[a:b], peer[a:b]
            if p[j, 4] == 1.0:
                seen, peers, ts = set(), [], []
                for rr, pp in zip(r.tolist(), pe.tolist()):
                    if pp not in seen:
                        seen.add(pp)
                        peers.append(pp)
                        ts.append(float(probe_t[rr]))
                out[q] = (KIND_RAYCAST, tuple(peers),
                          {"ts": ts, "mode": "all_hits"})
            elif r.size:
                hit = r == r[0]
                out[q] = (KIND_RAYCAST, tuple(pe[hit].tolist()),
                          {"t": float(probe_t[r[0]]), "mode": "first_hit"})
            else:
                out[q] = (KIND_RAYCAST, (), {"t": None, "mode": "first_hit"})

    sel = np.flatnonzero(kinds == KIND_KNN)
    if sel.size:
        p = params[sel]
        off = stencil(stencil_radius(p[:, 1].max(), size, stencil_max))
        d = off.astype(np.float64) * sizef
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        order = np.lexsort((np.arange(off.shape[0]), d2.astype(np.float32)))
        d, dist = d[order], np.sqrt(d2[order])
        qi, si = np.nonzero(dist[None] <= p[:, 1, None])
        _, owner, _, row, peer = probes(sel[qi], positions[sel[qi]] + d[si])
        per = _split(owner[row], peer, len(kinds))
        for j, q in enumerate(sel):
            k = int(p[j, 0])
            _, first = np.unique(per[q], return_index=True)
            peers = per[q][np.sort(first)][:k]
            out[q] = (KIND_KNN, tuple(peers.tolist()), {"k": k})

    sel = np.flatnonzero(kinds == KIND_DENSITY)
    if sel.size:
        p = params[sel]
        off = stencil(max(1, min(int(stencil_max), int(p[:, 0].max()))))
        cheb = np.abs(off).max(axis=1)
        qi, si = np.nonzero(cheb[None] <= p[:, 0, None])
        samples = positions[sel[qi]] + off[si].astype(np.float64) * sizef
        owner = sel[qi]
        cubes = cube_labels(samples, size)
        keep = _first_unique(owner, cubes)
        owner, cubes = owner[keep], cubes[keep]
        count = table.counts(np.asarray(world_ids)[owner], cubes)
        bounds = np.searchsorted(owner, np.append(sel, len(kinds)))
        for j, q in enumerate(sel):
            mine = np.arange(bounds[j], bounds[j + 1])
            mine = mine[count[mine] > 0]
            entries = sorted(
                ((*cubes[i].tolist(), int(count[i])) for i in mine),
                key=lambda e: (-e[3], e[0], e[1], e[2]))
            out[q] = (KIND_DENSITY, (),
                      {"cubes": [list(e) for e in entries[:int(p[j, 1])]]})
    return out
