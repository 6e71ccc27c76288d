"""Spatial fan-out sharded over a device mesh: ``--spatial-backend sharded``.

Port of the JAX package's ``parallel/sharded_backend.py``
(``ShardedTpuSpatialBackend``, its K12 programs) onto the port's cuda
index. The design is the JAX one: the sorted base segment is split into
per-shard contiguous key ranges — split points snapped to cube-run
boundaries so every cube's subscriber run lives wholly on one ``space``
shard — and queries split over the ``batch`` axis. Each shard resolves
its rows against its own range; exactly one ``space`` shard can match a
given cube, so the partial results (−1 = no match, 0 = no run) combine
with an elementwise max over ``space``. The small delta segment is
replicated on every device of the grid: every shard matches the whole
delta, the partials concatenate with the base partials before the max,
and the merge stays one per result.

Placement. A sharded array (:class:`MeshArray`) holds, for each space
shard, one copy on each distinct device of that shard's mesh column
(JAX's ``P("space", None)`` replicates over ``batch``); a replicated
array holds one copy on each distinct device of the grid. A copy to the
device a tensor is already on is no copy, so on one card (or the CPU
with ``devices=["cpu"] * 8``) the placement costs nothing and the code
path is the multi-device one. Every update is out of place, as in
``ops/index.py``: a background fold reads arrays the serving thread
keeps replacing.

The merge takes the place of ``jax.lax.pmax(…, "space")``: in one
process, per batch row the elementwise max of its shards' partials,
gathered to the row's first device, then the rows concatenated on the
mesh's first device (``self.device``). When the mesh spans processes
(parallel/mesh.py), each rank fills the rows it holds no shard of with
the max's identity and one ``all_reduce(MAX)`` over the group both
merges over ``space`` and gathers over ``batch``. A failed collective
raises: nothing stands in a local result for it.

The per-op programs are the torch ops of ``ops/index.py`` (K1–K6),
each run per (batch row, space shard) on that position's device, bit
for bit the JAX mesh's results (``tests/test_torch_sharded_backend.py``
holds the dense, sparse and raw CSR results, the packed fetch, the
splits and the folds to the JAX mesh, exactly).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.index import (
    CSR_ROW,
    CSR_ROW_B,
    _alloc_buffers,
    _grow_buffers,
    _scatter_dead,
    _sort_segment_dev,
    _write_chunk,
    compact_sparse,
    match_core,
    pack_csr,
    probe_buckets_for,
    probe_tables,
    run_bounds_all,
    run_csr_assemble,
    run_remainders,
)
from ..spatial.cuda_backend import (
    CudaSpatialBackend, _to_host, run_remainders_np,
)
from ..spatial.hashing import PAD_KEY, n_distinct, next_pow2, pad_to
from .mesh import FanoutMesh

_PAD = int(PAD_KEY)  # wql: allow(jax-host-sync) — a numpy host scalar, no tensor


def split_at_run_boundaries(keys: np.ndarray, n_shards: int) -> list[int]:
    """Split points for sorted ``keys`` into ``n_shards`` near-equal
    chunks, snapped left to run starts so equal keys never straddle a
    boundary. Returns n_shards+1 offsets."""
    n = len(keys)
    splits = [0]
    for i in range(1, n_shards):
        ideal = (n * i) // n_shards
        if ideal <= splits[-1]:
            splits.append(splits[-1])
            continue
        snapped = int(np.searchsorted(keys, keys[ideal], side="left"))
        splits.append(max(snapped, splits[-1]))
    splits.append(n)
    return splits


class MeshArray:
    """One logical array on the mesh. ``cols[s]`` maps each distinct
    device of space column ``s`` (this process's positions only) to the
    copy there. Sharded: each column holds its own shard. Replicated:
    every column holds the same tensor, copied once per distinct
    device."""

    __slots__ = ("cols", "sharded")

    def __init__(self, cols, sharded: bool):
        self.cols = cols
        self.sharded = sharded

    def at(self, mesh: FanoutMesh, b: int, s: int) -> torch.Tensor:
        return self.cols[s][mesh.devices[b][s]]

    def shard(self, s: int) -> torch.Tensor:
        """Shard ``s``'s tensor (any of its copies)."""
        return next(iter(self.cols[s].values()))

    @property
    def shape(self) -> tuple:
        for col in self.cols:
            if col:
                t = next(iter(col.values()))
                shape = tuple(t.shape)
                return (len(self.cols), *shape) if self.sharded else shape
        return ()


def _copies(t: torch.Tensor, devices) -> dict:
    """``t`` on each distinct device of ``devices``: itself where it
    already lies, an explicit (blocking) copy elsewhere."""
    out: dict = {}
    for dev in devices:
        if dev not in out:
            out[dev] = t if t.device == dev else t.to(dev)
    return out


class ShardedCudaSpatialBackend(CudaSpatialBackend):
    """Mesh backend: same host authority and observable semantics as
    the single-device index, base segment sharded over ``mesh``."""

    def __init__(
        self, cube_size: int, mesh: FanoutMesh,
        compact_threshold: int | None = None,
    ):
        if set(mesh.axis_names) != {"batch", "space"}:
            raise ValueError("mesh must have axes ('batch', 'space')")
        local = mesh.local_positions()
        first = (mesh.devices[local[0][0]][local[0][1]] if local
                 else None)
        super().__init__(cube_size, compact_threshold=compact_threshold,
                         device=first)
        self.mesh = mesh
        self.n_batch = mesh.shape["batch"]
        self.n_space = mesh.shape["space"]
        self._local = local

    def supports_delta_ticks(self) -> bool:
        """Result reuse runs on the mesh by per-shard flat-region
        replay, as in the JAX package: the reuse cache is host state
        shared with the single-device index; only the dirty partition
        dispatches, through the mesh programs, and its CSR regions are
        walked by this class's region-walk overrides."""
        return True

    def _delta_scatter_supported(self) -> bool:
        # the O(K) tombstone scatter targets the single-device sorted
        # DELTA segment; the mesh replicates that segment, so delta
        # sync keeps the full-sort path
        return False

    # region: placement

    def _column_devices(self, s: int) -> list:
        return [self.mesh.devices[b][s] for b in range(self.n_batch)
                if self.mesh.is_local(b, s)]

    def _grid_devices(self) -> list:
        return [self.mesh.devices[b][s] for b, s in self._local]

    def _sharded(self, per_shard: dict) -> MeshArray:
        """``{s: tensor}`` (one per local column, on its first device)
        → a sharded MeshArray with each column's copies."""
        return MeshArray(
            [_copies(per_shard[s], self._column_devices(s))
             if s in per_shard else {} for s in range(self.n_space)],
            sharded=True)

    def _replicated(self, t: torch.Tensor) -> MeshArray:
        copies = _copies(t, self._grid_devices())
        return MeshArray(
            [{d: copies[d] for d in self._column_devices(s)}
             for s in range(self.n_space)], sharded=False)

    def _local_columns(self) -> list[int]:
        return sorted({s for _, s in self._local})

    def _upload(self, arr: np.ndarray, s: int) -> torch.Tensor:
        """A host array onto column ``s``'s first device (a copy)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self._column_devices(s)[0], copy=True)

    # endregion

    # region: device upload seams

    def _upload_base(self, keys, keys2, pids, k) -> dict:
        splits = split_at_run_boundaries(keys, self.n_space)
        cap = next_pow2(max(b - a for a, b in zip(splits, splits[1:])))
        # runs never straddle a shard boundary (splits snap to run
        # starts), so each shard's run-remainder column (and its probe
        # table — shard-local run starts) derives from its own padded
        # key rows
        n_cubes = max(
            n_distinct(keys[a:b]) for a, b in zip(splits, splits[1:])
        )
        n_buckets = probe_buckets_for(n_cubes)
        cols = [{} for _ in range(6)]
        for s in self._local_columns():
            a, b = splits[s], splits[s + 1]
            pk = pad_to(keys[a:b], cap, PAD_KEY)
            sk = self._upload(pk, s)
            sk2 = self._upload(pad_to(keys2[a:b], cap, np.int64(0)), s)
            tbl, oflow = probe_tables(sk, sk2, n_buckets=n_buckets)
            for i, t in enumerate((
                sk, sk2,
                self._upload(pad_to(pids[a:b].astype(np.int32), cap,
                                    np.int32(-1)), s),
                self._upload(run_remainders_np(pk), s),
                tbl, oflow,
            )):
                cols[i][s] = t
        return {
            "dev": tuple(self._sharded(c) for c in cols),
            "cap": self.n_space * cap,
            "splits": np.asarray(splits, np.int64),
            "shard_cap": cap,
        }

    #: re-shard (full re-upload) only when the largest shard exceeds
    #: this multiple of the mean — keys are uniform hashes, so the old
    #: key-range boundaries stay balanced as the index grows and the
    #: bound ~never trips in practice
    RESHARD_IMBALANCE = 2.0

    def _compact_device(
        self, snap: dict, cap2: int, host_arrays, k, n_buckets: int
    ) -> dict:
        """Mesh-aware compaction in O(churn) transfer: every shard owns
        a contiguous KEY range (the old split boundaries), the delta is
        already device-resident and replicated, so each shard folds
        (its base rows ∪ the delta rows hashing into its range) on its
        own device — no transfer but the boundary keys. The old global
        sort restricted to a key range IS the new shard content, so the
        host mirror (folded by ``_compact_work``'s identical stable
        transform) and the device shards stay row-aligned via the
        re-derived splits.

        Falls back to a full host re-upload (fresh balanced splits)
        when there is no resident base/boundary state yet or when shard
        sizes drift past RESHARD_IMBALANCE. Runs on the compaction
        worker thread."""
        hk, hk2, hp = host_arrays
        base = snap.get("base_bundle")
        if (
            base is None
            or base.get("splits") is None
            or self.n_space == 1
            or snap.get("delta_buf") is None
        ):
            return self._upload_base(hk, hk2, hp, k)

        old_splits = base["splits"]
        old_bk = snap["bk"]
        # boundary KEYS from the old row splits (first key of each
        # shard after the first); the new fold re-derives row splits
        # from the same keys, so runs still never straddle shards
        bounds = np.empty(self.n_space + 1, np.int64)
        bounds[0] = np.iinfo(np.int64).min
        bounds[-1] = np.int64(PAD_KEY)  # live keys are always < PAD_KEY
        for s in range(1, self.n_space):
            row = int(old_splits[s])
            bounds[s] = old_bk[row] if row < old_bk.size else PAD_KEY

        new_splits = np.empty(self.n_space + 1, np.int64)
        new_splits[0] = 0
        new_splits[-1] = hk.size
        new_splits[1:-1] = np.searchsorted(
            hk, bounds[1:-1], side="left"
        )
        # live rows per shard: dead/pad rows were rewritten to PAD_KEY
        # before the host sort, so the live prefix ends at the first
        # PAD row and the pad tail must not skew balance accounting
        live_n = int(np.searchsorted(hk, PAD_KEY, side="left"))
        edges = np.minimum(new_splits, live_n)
        counts = np.diff(edges)
        mean = max(live_n / self.n_space, 1.0)
        if counts.max() > self.RESHARD_IMBALANCE * mean + 8:
            return self._upload_base(hk, hk2, hp, k)

        cap_shard = next_pow2(int(counts.max()))
        # probe tables sized for the busiest SHARD's cube count, not
        # the global one (global would allocate S× the needed rows)
        n_cubes = 1
        for s in range(self.n_space):
            a, b = int(edges[s]), int(edges[s + 1])
            if b > a:
                n_cubes = max(n_cubes, n_distinct(hk[a:b]))
        n_buckets = probe_buckets_for(n_cubes)
        if cap_shard > base["shard_cap"] + snap["delta_buf"][0].shape[0]:
            # cannot happen (new rows <= old rows + delta rows), but a
            # silent wrong-shape fold would corrupt the index — guard
            return self._upload_base(hk, hk2, hp, k)
        dev = self._fold_shards(
            base["dev"][:3], snap["delta_buf"], bounds, cap_shard,
            n_buckets,
        )
        return {
            "dev": dev,
            "cap": self.n_space * cap_shard,
            "splits": new_splits,
            "shard_cap": cap_shard,
        }

    def _fold_shards(self, base3, delta, bounds, cap2: int,
                     n_buckets: int):
        """Per-shard fold, each on its column's first device: local
        base rows + the delta rows in ``[bounds[s], bounds[s+1])`` →
        a fresh sorted shard with run-remainders and probe tables.
        Tombstones and out-of-range delta rows sink past the live rows
        as PAD_KEY (their peers are <0 or their keys padded, so no
        consumer can see them)."""
        cols = [{} for _ in range(6)]
        for s in self._local_columns():
            dev = self._column_devices(s)[0]
            bk, bk2, bp = (a.cols[s][dev] for a in base3)
            dk, dk2, dp = (a.cols[s][dev] for a in delta)
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            in_range = (dk >= lo) & (dk < hi) & (dp >= 0)
            dkm = torch.where(in_range, dk, torch.full_like(dk, _PAD))
            dpm = torch.where(in_range, dp, torch.full_like(dp, -1))
            keys = torch.cat(
                [torch.where(bp < 0, torch.full_like(bk, _PAD), bk), dkm])
            keys2 = torch.cat([bk2, dk2])
            peers = torch.cat([bp, dpm])
            sk, order = torch.sort(keys, stable=True)
            sk, order = sk[:cap2], order[:cap2]
            sk2 = keys2[order]
            tbl, oflow = probe_tables(sk, sk2, n_buckets=n_buckets)
            for i, t in enumerate((sk, sk2, peers[order],
                                   run_remainders(sk), tbl, oflow)):
                cols[i][s] = t
        return tuple(self._sharded(c) for c in cols)

    # -- delta seams: the delta segment is replicated on every device
    # of the grid; each op runs once on the first device and its result
    # is copied to the others --

    def _rep(self, tensors) -> tuple:
        return tuple(self._replicated(t) for t in tensors)

    def _first(self, arrays) -> tuple:
        return tuple(a.cols[self._local[0][1]][self.device]
                     for a in arrays)

    def _alloc_delta_buffer(self, cap: int) -> tuple:
        return self._rep(_alloc_buffers(cap, self.device))

    def _grow_delta_buffer(self, bufs: tuple, cap: int) -> tuple:
        return self._rep(_grow_buffers(self._first(bufs), cap))

    def _write_delta_chunk(self, bufs: tuple, chunk: tuple, start: int):
        return self._rep(_write_chunk(self._first(bufs), chunk, start))

    def _scatter_delta_dead(self, peer_buf, rows: np.ndarray):
        (peer,) = self._first((peer_buf,))
        return self._replicated(_scatter_dead(peer, rows))

    def _sort_delta(self, bufs: tuple, n_buckets: int) -> tuple:
        return self._rep(_sort_segment_dev(*self._first(bufs),
                                           n_buckets=n_buckets))

    def _scatter_base_dead(self, bundle: dict, rows: np.ndarray) -> dict:
        """Map global sorted-row indices → (shard, local) and tombstone
        each shard's peer column; rows past a shard's end (the pad
        lanes) are dropped."""
        splits = bundle["splits"]
        shard = np.searchsorted(splits, rows, side="right") - 1
        local = (rows - splits[shard]).astype(np.int32)
        peer = bundle["dev"][2]
        cols = {}
        for s in self._local_columns():
            mine = local[shard == s]
            t = peer.cols[s][self._column_devices(s)[0]]
            cols[s] = _scatter_dead(t, mine) if mine.size else t
        dev = bundle["dev"]
        return {**bundle,
                "dev": (*dev[:2], self._sharded(cols), *dev[3:])}

    # endregion

    # region: dispatch

    def _query_cap(self, m: int) -> int:
        # Batch capacity must split evenly over 'batch': power-of-two
        # tier, rounded up to a multiple of n_batch (which need not be
        # a power of two).
        cap = max(next_pow2(m), self.n_batch)
        return -(-cap // self.n_batch) * self.n_batch

    def _row_queries(self, queries: tuple, b: int, s: int) -> tuple:
        """Batch row ``b``'s slice of the padded query tensors, on grid
        position ``(b, s)``'s device."""
        ml = queries[0].shape[0] // self.n_batch
        dev = self.mesh.devices[b][s]
        return tuple(q[b * ml:(b + 1) * ml].to(dev) for q in queries)

    def _local_segs(self, segs, b: int, s: int) -> list[tuple]:
        return [tuple(a.at(self.mesh, b, s) for a in seg) for seg in segs]

    def _merge(self, parts: dict, shape: tuple, fill: int) -> torch.Tensor:
        """The max over ``space`` of per-position partials ``{(b, s):
        tensor of shape}``: per batch row, the elementwise max of its
        shards' partials gathered to the row's first device, the rows
        concatenated in batch order on ``self.device``. Across
        processes, one ``all_reduce(MAX)`` over the mesh's group of the
        whole result, the rows this rank holds no shard of filled with
        ``fill`` (the max's identity)."""
        rows = []
        for b in range(self.n_batch):
            acc = None
            for s in range(self.n_space):
                t = parts.get((b, s))
                if t is None:
                    continue
                acc = t if acc is None else torch.maximum(acc, t.to(acc.device))
            if acc is None:
                acc = torch.full(shape, fill, dtype=torch.int32,
                                 device=self.device)
            rows.append(acc.to(self.device))
        out = torch.cat(rows)
        if self.mesh.group is not None:
            import torch.distributed as dist

            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return out

    def _dense_parts(self, queries, segs, ks) -> dict:
        parts = {}
        for b, s in self._local:
            q = self._row_queries(queries, b, s)
            tgt = [match_core(seg, *q, k=k)
                   for seg, k in zip(self._local_segs(segs, b, s), ks)]
            parts[(b, s)] = tgt[0] if len(tgt) == 1 else torch.cat(tgt, 1)
        return parts

    def _dispatch(self, queries: tuple, segs, ks, kinds):
        ml = queries[0].shape[0] // self.n_batch
        return self._merge(self._dense_parts(queries, segs, ks),
                           (ml, sum(ks)), -1)

    def _dispatch_sparse(self, queries: tuple, segs, ks, kinds, c: int):
        return compact_sparse(self._dispatch(queries, segs, ks, kinds), c=c)

    def _dispatch_csr(self, queries: tuple, segs, ks, kinds, t_cap: int):
        """Per (batch row, space shard): run bounds, the global raw
        counts as the max over ``space`` (a run lives on exactly one
        shard), then the zoned assembly into the row's own flat region
        of ``t_cap // n_batch`` slots; owner shards wrote real lanes,
        the rest -1, so the max over ``space`` of flat and total is a
        lossless merge. Any row overflowing its region raises the
        global retry sentinel ``t_cap + 1``."""
        nseg = len(segs)
        ml = queries[0].shape[0] // self.n_batch
        t_cap_local = t_cap // self.n_batch
        local = {}
        cnt_parts = {}
        for b, s in self._local:
            q = self._row_queries(queries, b, s)
            lsegs = self._local_segs(segs, b, s)
            los, cnts_local = run_bounds_all(lsegs, q)
            local[(b, s)] = (q, lsegs, los, cnts_local)
            cnt_parts[(b, s)] = torch.stack(cnts_local, dim=1)
        cnts_all = self._merge(cnt_parts, (ml, nseg), 0)
        flat_parts, total_parts = {}, {}
        for (b, s), (q, lsegs, los, cnts_local) in local.items():
            row = cnts_all[b * ml:(b + 1) * ml].to(self.mesh.devices[b][s])
            _, flat, total = run_csr_assemble(
                lsegs, los, [row[:, i] for i in range(nseg)], cnts_local,
                q, t_cap_local)
            flat_parts[(b, s)] = flat
            total_parts[(b, s)] = total.reshape(1)
        flat = self._merge(flat_parts, (t_cap_local,), -1)
        totals = self._merge(total_parts, (1,), 0)
        total = torch.where(
            (totals > t_cap_local).any(),
            torch.tensor(t_cap + 1, dtype=torch.int32, device=self.device),
            totals.sum(dtype=torch.int32),
        )
        return cnts_all, flat, total

    def _csr_effective_cap(self, t_cap: int, queries: tuple, segs) -> int:
        # every batch row's local region must cover its own zone-A
        # identity rows PLUS at least one zone-B row — the base class's
        # global floor divided by n_batch can land exactly on the
        # zone-A size for small multi-segment ticks. Raised HERE (not
        # silently inside the dispatch) so dispatch_local_batch records
        # the same cap the kernel's overflow sentinel uses.
        m_local = queries[0].shape[0] // self.n_batch
        need_local = (CSR_ROW * m_local * len(segs)
                      + 2 * CSR_ROW_B)
        return max(t_cap, next_pow2(self.n_batch * need_local))

    def _pack_rows(self, counts, flat, bucket_local: int):
        """Per-batch-row pack_csr: each row compacts its own flat region
        into a local bucket (the merge already happened in the CSR
        dispatch). Returns ``(packed [n_batch * bucket], totals
        [n_batch])``."""
        nb = self.n_batch
        ml = counts.shape[0] // nb
        fl = flat.shape[0] // nb
        packed, totals = [], []
        for b in range(nb):
            p, t = pack_csr(counts[b * ml:(b + 1) * ml],
                            flat[b * fl:(b + 1) * fl], bucket=bucket_local)
            packed.append(p)
            totals.append(t.reshape(1))
        return torch.cat(packed), torch.cat(totals)

    def _compact_fetch(self, counts, flat, total: int, t_cap: int):
        """Mesh compaction: each batch row packs its own flat region
        into a local bucket sized for 2x imbalance headroom over a
        perfectly balanced split. Rows report their raw totals; any row
        overflowing its bucket (imbalance past the headroom) falls back
        to the full fetch — slower, never wrong."""
        nb = self.n_batch
        bucket_local = next_pow2(
            max(-(-2 * total // nb), self.compact_min_bucket)
        )
        if (
            not self._compact_applicable(t_cap)
            or bucket_local * nb * 2 > t_cap
        ):
            return None
        packed, totals = self._pack_rows(counts, flat, bucket_local)
        # fit check first — a tiny [n_batch] fetch, not the payload
        totals_np = _to_host(totals)
        if totals_np.size and int(totals_np.max()) > bucket_local:
            return None
        out = _to_host(packed)
        self._note_fetch(bucket_local * nb, bucket_local * nb)
        return out

    def _decode_packed(self, counts, packed, m: int):
        """The mesh packed result is per-batch-row buckets
        concatenated; walk each row's queries against its own bucket
        (mirrors the zoned-layout region walk below)."""
        nb = self.n_batch
        bucket_local = len(packed) // nb
        m_local = counts.shape[0] // nb
        out: list = []
        for b in range(nb):
            if len(out) >= m:
                break
            out.extend(super()._decode_packed(
                counts[b * m_local:(b + 1) * m_local],
                packed[b * bucket_local:(b + 1) * bucket_local],
                min(m_local, m - len(out)),
            ))
        return out

    def _decode_csr(self, counts, flat, m: int):
        """The mesh flat result is per-batch-row regions of ``t_cap //
        n_batch`` slots concatenated; walk each row's queries against
        its own region. The dense-fallback layout (counts.ndim == 1) is
        host-built and global — no regions."""
        if counts.ndim == 1:
            return super()._decode_csr(counts, flat, m)
        nb = self.n_batch
        t_cap_local = len(flat) // nb
        m_local = counts.shape[0] // nb
        out: list = []
        for b in range(nb):
            if len(out) >= m:
                break
            out.extend(super()._decode_csr(
                counts[b * m_local:(b + 1) * m_local],
                flat[b * t_cap_local:(b + 1) * t_cap_local],
                min(m_local, m - len(out)),
            ))
        return out

    # endregion

    def device_stats(self) -> dict:
        stats = super().device_stats()
        stats["mesh"] = {"batch": self.n_batch, "space": self.n_space}
        return stats

