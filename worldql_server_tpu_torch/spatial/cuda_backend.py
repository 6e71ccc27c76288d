"""Device-batched :class:`SpatialBackend` on the card: ``--spatial-backend cuda``.

Port of the JAX package's ``spatial/tpu_backend.py``
(``TpuSpatialBackend``) to PyTorch: the same two-segment LSM index —
a large sorted base with tombstones plus a small insertion-ordered
delta log, background compaction against a snapshot with removals
replayed at swap — the same staged and object-list dispatch paths,
delta ticks, zoned CSR delivery with on-device result compaction, and
the same host numpy mirror as the authority. The device functions it
launches (K1–K6) are ``ops/index.py``; they run on ``self.device``,
the card unless the caller asks for the CPU (``device=`` or
``WQL_TORCH_DEVICE=cpu``, ``spatial/torchconf.py``).

What differs from the JAX package:

* Every device update is out of place (``ops/index.py``), so the
  compaction snapshot and the CSR overflow retry's captured segments
  stay what they were when taken, as JAX's immutable arrays do.
* The D2H prefetch (``copy_to_host_async`` in JAX) is a non-blocking
  copy into pinned host memory plus a CUDA event; the collect waits on
  that event before it reads. On the CPU the result tensors are read
  in place.
* Query arrays go up with a non-blocking copy from pinned memory.
* The query-kind leg (``_dispatch_kind_batch``) runs the library's
  stencil kernels (``queries/geometry.py``, ``queries/knn.py``) on
  ``self.device``.
* There is no jit, so there is nothing to retrace; the tier walk in
  ``spatial/precompile.py`` warms the allocator and sort workspaces.

Quantization runs host-side in numpy f64 (golden semantics,
cube_area.rs:23-44); the device only compares integer labels.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid as uuid_mod
from collections import Counter
from typing import Sequence

import numpy as np
import torch

from ..observability.spans import Tracer
from ..ops.index import (
    CSR_ROW,
    CSR_ROW_B,
    _alloc_buffers,
    _device_compact,
    _grow_buffers,
    _multi_match,
    _probe_only_dev,
    _scatter_dead,
    _sort_segment_dev,
    _write_chunk,
    compact_sparse,
    match_run_csr,
    pack_csr,
    padded_slots,
    probe_buckets_for,
)
from ..protocol.types import Vector3
from ..queries.kinds import PARAM_LANES as _QUERY_PARAM_LANES
from .backend import Cube, LocalQuery, SpatialBackend, to_cube
from .delta_ticks import TemporalCoherence, row_signatures
from .hashing import (
    NO_WORLD, PAD_KEY, n_distinct, next_pow2, pad_to, spatial_keys,
    spatial_keys2,
)
from .native_keys import encode_queries, query_keys
from .torchconf import resolve_device

_log = logging.getLogger(__name__)

_XYZ_PAD = np.int64(-(2 ** 62))


class _HostCopy:
    """Host copies of result tensors, enqueued when the batch is
    launched so the collect reads them without a round trip. On the
    card: non-blocking copies into pinned host tensors and a CUDA event
    the reader waits on (the collect runs on the ticker's worker
    thread). On the CPU the tensors are read in place."""

    def __init__(self, tensors):
        self.event = None
        if tensors and tensors[0].device.type == "cuda":
            self.host = [
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors
            ]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = list(tensors)

    def get(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A device → host fetch that waits for ``t`` and nothing enqueued
    after it (the collect's sync points; a plain ``.cpu()`` would also
    wait for the next tick's dispatch)."""
    return _HostCopy([t]).get()[0]


class _CollisionError(Exception):
    """A new cube's key collided with a different stored cube (expected
    ~never at 2^-64 per pair); the caller reseeds and rebuilds."""


# --------------------------------------------------------------------
# Backend
# --------------------------------------------------------------------


class CudaSpatialBackend(SpatialBackend):
    """Device-batched backend. The host-side numpy SoA segments are the
    authority; point queries binary-search them, the batched hot path
    runs on ``self.device`` against their mirror."""

    #: delta rows (live) that trigger a background compaction, as a
    #: fraction of base size
    COMPACT_DELTA_FRACTION = 8
    #: dead base rows that trigger a background compaction (fraction)
    COMPACT_DEAD_FRACTION = 8
    #: delta overrun factor past which bulk loads fold straight into the
    #: base and a delta overrun falls back to a synchronous fold if the
    #: background worker keeps failing
    SYNC_COMPACT_FACTOR = 4
    #: consecutive background-compaction failures before a delta overrun
    #: is allowed to fold synchronously on the owning thread (last
    #: resort: the device is persistently failing, correctness over
    #: latency)
    SYNC_FALLBACK_FAILURES = 3
    #: seconds an in-flight compaction may run before an OVERRUN flush
    #: treats it as wedged and abandons it — a hung device call must not
    #: let the delta log grow without bound
    COMPACT_STALL_SECS = 120.0

    def __init__(self, cube_size: int, compact_threshold: int | None = None,
                 *, device=None):
        super().__init__(cube_size)
        self.device = resolve_device(device)
        self._world_ids: dict[str, int] = {}
        self._peer_ids: dict[uuid_mod.UUID, int] = {}
        self._peer_list: list[uuid_mod.UUID] = []
        # world id → live-row refcount per peer id (query_world /
        # is_subscribed_any in O(1), the AreaMap subscribed_peers view,
        # area_map.rs:10-17)
        self._world_peers: dict[int, Counter] = {}
        self._seed = 0
        self._dirty = True
        self._compact_threshold_override = compact_threshold

        # base segment (host authority, sorted by key). _bw/_bxyz are
        # the exact-identity authority (point queries, collision
        # checks); _bk2 mirrors the device's second-key column.
        self._bk = np.empty(0, np.int64)
        self._bk2 = np.empty(0, np.int64)
        self._bw = np.empty(0, np.int32)
        self._bxyz = np.empty((0, 3), np.int64)
        self._bp = np.empty(0, np.int32)
        self._base_live = 0
        self._base_dead = 0
        self._base_k = 1
        self._base_bundle: dict | None = None
        #: host base newer than the device twin (upload owed at flush)
        self._base_stale = False
        self._pending_dead: list[int] = []

        # delta log (host authority, insertion order, capacity doubling)
        self._dcap = 0
        self._dk = np.empty(0, np.int64)
        self._dk2 = np.empty(0, np.int64)
        self._dw = np.empty(0, np.int32)
        self._dxyz = np.empty((0, 3), np.int64)
        self._dp = np.empty(0, np.int32)
        self._dn = 0
        self._delta_live = 0
        self._delta_index: dict[tuple[int, int], int] = {}  # (key,pid)→row
        self._delta_keyrow: dict[int, int] = {}  # key → first row (cube id)
        self._delta_key_count: Counter = Counter()  # key → rows (incl. dead)
        self._delta_max_run = 1
        self._delta_stale = False
        # device twin of the log: persistent insertion-order buffer
        # (only new-row chunks ever transfer) + its key-sorted view
        self._delta_buf: tuple | None = None
        self._delta_buf_cap = 0
        self._delta_built_n = 0  # log rows present in the device buffer
        self._pending_delta_dead: list[int] = []
        self._delta_bundle: dict | None = None
        self._delta_k = 1

        # background compaction
        self._compaction: dict | None = None
        self._replay: list[tuple[int, int]] = []
        self._epoch = 0

        self.compactions = 0
        self.compaction_failures = 0
        self._failed_streak = 0
        # CSR result-capacity hint for the delivery path; grows on
        # overflow (collect_local_batch)
        self._delivery_cap = 4096
        # the DELTA sub-batch path sizes its CSR results off its own
        # hint: dirty partitions are orders of magnitude smaller than
        # full ticks, and letting them decay the main hint would both
        # thrash capacity tiers while it halves down and starve the
        # next full-recompute tick into an overflow retry
        self._delta_delivery_cap = 4096

        # On-device result compaction (pack_csr): pack the lanes the
        # decoder will read into a power-of-two bucket sized to the
        # tick's ACTUAL fan-out and fetch only that. Applies once the
        # capacity tier clears min_cap (below it the prefetched full
        # fetch wins — the pack dispatch costs a round trip) AND the
        # bucket saves at least 2x the bytes. min_bucket floors the
        # bucket ladder so steady traffic reuses a handful of pack
        # shapes (the boot tier walk warms each).
        self.compact_fetch = True
        self.compact_fetch_min_cap = 1 << 15
        self.compact_min_bucket = 1 << 10
        self.compact_fetches = 0
        self.full_fetches = 0
        #: result lanes shipped device → host, the prefetch included
        #: (t_cap on a full fetch, the bucket on a packed one, M x K
        #: dense), and the recipients the decode made of them
        self.fetch_slots = 0
        self.lanes_decoded = 0
        # the collect's counters: two pipelined collects may overlap
        self._counts_lock = threading.Lock()
        #: what the LAST collect shipped over the link (the tick
        #: batcher reports these as tick.fetch_bytes /
        #: tick.compaction_bucket)
        self.last_collect_stats = {
            "fetch_slots": 0, "fetch_bytes": 0, "compaction_bucket": 0,
        }
        #: spans at the boundaries of the fan-out path, one each per
        #: batch: ``index.partition`` / ``.encode`` / ``.launch`` on the
        #: dispatching thread, ``index.wait`` / ``.fetch`` / ``.decode``
        #: / ``.store`` on the collecting one, ``index.expand`` /
        #: ``.fold`` around a query-kind batch. Off by default; the
        #: server hands over its own (``--trace``).
        self.tracer = Tracer()
        # Per-tick device timing split, from the same clock reads as
        # the spans: the dispatch's legs (encode_ms from index.encode,
        # h2d_ms and d2h_enqueue_ms from index.launch) RIDE THE HANDLE,
        # so pairing with its collect is structural at any pipeline
        # depth; the collect that owns the handle adds compute_ms
        # (index.wait) and d2h_ms (index.fetch) and publishes the merged
        # dict as ``last_device_timing`` for DeviceTelemetry. These are
        # HOST-side walls, not profiler truth: compute_ms is the wait on
        # the prefetch's event, so it holds the prefetched copies.
        self.last_device_timing: dict = {}
        #: dispatches that arrived pre-encoded as staged columnar
        #: arrays (engine/staging.py) vs. as LocalQuery object lists —
        #: the bench smoke gate asserts the staged path actually fired
        self.staged_dispatches = 0
        self.list_dispatches = 0
        #: mixed-kind batches expanded by the query library
        #: (queries/expand.py) into probe rows on the radius pipeline
        self.kind_expansions = 0

        # Delta ticks (ROADMAP 2, spatial/delta_ticks.py): per-cube
        # dirty tracking from the churn stream + the result-reuse
        # cache. OFF by default — the dispatch/collect pipeline is
        # byte-for-byte the pre-delta path until configure_delta_ticks
        # enables it (server wiring / bench), and every mutation-path
        # mark is gated on the flag so the disabled overhead is one
        # branch per mutation batch.
        self._delta_ticks = False
        #: churn fraction above which a delta structure falls back to
        #: the full path: tombstone-scatter delta sync reverts to the
        #: device re-sort past this fraction of the built log, and the
        #: entity plane mirrors it for its dirty-closure sub-tick
        self.delta_rebuild_threshold = 0.5
        self._coherence = TemporalCoherence()
        #: host mirror of the device delta sort order ((built, cap),
        #: row → sorted position), backing the O(K) tombstone scatter
        #: into the persistent sorted segment
        self._delta_sort_pos: tuple | None = None
        self.delta_reused = 0
        self.delta_recomputed = 0
        self.delta_fallbacks = 0
        self.delta_sync_scatters = 0
        self.delta_sync_sorts = 0
        #: the LAST delta dispatch's partition (tick.delta span tags)
        self.last_delta_stats: dict = {}
        #: the LAST delta-twin sync's path + wall (bench attribution)
        self.last_delta_sync: dict = {}

        # pid → base rows: lazily built per base epoch (argsort of the
        # peer column, O(S log S) once), then each eviction is two
        # binary searches + a small gather instead of an O(S) scan.
        # Tombstones only ever rewrite peers to -1, so entries can go
        # stale-dead but never point at a *different* peer; lookups
        # re-check liveness against the current peer column.
        self._base_pid_order: tuple[np.ndarray, np.ndarray] | None = None
        # pid → delta rows, maintained incrementally on append.
        self._delta_pid_rows: dict[int, list[int]] = {}

    # region: interning

    def _world_id(self, world: str) -> int:
        wid = self._world_ids.get(world)
        if wid is None:
            wid = self._world_ids[world] = len(self._world_ids)
            self._world_peers[wid] = Counter()
        return wid

    def _peer_id(self, peer: uuid_mod.UUID) -> int:
        pid = self._peer_ids.get(peer)
        if pid is None:
            pid = self._peer_ids[peer] = len(self._peer_list)
            self._peer_list.append(peer)
        return pid

    def _key_of(self, wid: int, cube: Cube) -> int:
        return int(spatial_keys(
            np.array([wid], np.int32),
            np.array([cube], np.int64),
            self._seed,
        )[0])

    def supports_staged_dispatch(self) -> bool:
        return True

    def supports_delta_ticks(self) -> bool:
        """Whether this backend can serve delta ticks (result reuse +
        incremental delta sync)."""
        return True

    def configure_delta_ticks(self, mode: str) -> bool:
        """Arm/disarm delta ticks: ``on``/``auto`` enable when the
        backend supports them, ``off`` restores the pre-delta pipeline
        byte for byte. Enabling starts from a cold cache (mutations
        made while tracking was off were never marked). Returns the
        resulting state."""
        want = mode in ("on", "auto") and self.supports_delta_ticks()
        if want and not self._delta_ticks:
            self._coherence.invalidate_all()
        self._delta_ticks = want
        return want

    def interning_maps(self):
        """Enqueue-time interning contract (engine/staging.py): both
        dicts are owned by the event-loop thread — router enqueue,
        subscription mutations and dispatch all run there — and are
        append-only for the backend's lifetime, so ids interned at
        message arrival stay valid at flush time."""
        return self._world_ids, self._peer_ids

    # endregion

    # region: host search

    def _base_run(self, key: int) -> tuple[int, int]:
        lo = int(np.searchsorted(self._bk, key, side="left"))
        hi = int(np.searchsorted(self._bk, key, side="right"))
        return lo, hi

    def _find_live_row(self, key: int, wid: int, cube: Cube, pid: int):
        """→ ('base', row) | ('delta', row) | None. Raises
        :class:`_CollisionError` if ``key`` is held by a different
        cube."""
        lo, hi = self._base_run(key)
        if lo < hi:
            if self._bw[lo] != wid or (
                self._bxyz[lo, 0] != cube[0]
                or self._bxyz[lo, 1] != cube[1]
                or self._bxyz[lo, 2] != cube[2]
            ):
                raise _CollisionError
            j = np.flatnonzero(self._bp[lo:hi] == pid)
            if j.size:
                return ("base", lo + int(j[0]))
        drow = self._delta_keyrow.get(key)
        if drow is not None:
            if self._dw[drow] != wid or (
                self._dxyz[drow, 0] != cube[0]
                or self._dxyz[drow, 1] != cube[1]
                or self._dxyz[drow, 2] != cube[2]
            ):
                raise _CollisionError
            row = self._delta_index.get((key, pid))
            if row is not None:
                return ("delta", row)
        return None

    # endregion

    # region: mutations

    def add_subscription(
        self, world: str, peer: uuid_mod.UUID, pos: Vector3 | Cube
    ) -> bool:
        cube = to_cube(pos, self.cube_size)
        wid = self._world_id(world)
        pid = self._peer_id(peer)
        while True:
            key = self._key_of(wid, cube)
            try:
                if key == int(PAD_KEY):
                    raise _CollisionError
                if self._find_live_row(key, wid, cube, pid) is not None:
                    return False
            except _CollisionError:
                self._reseed_rebuild()
                continue
            break
        self._delta_append(key, wid, cube, pid)
        self._world_peers[wid][pid] += 1
        self._dirty = True
        return True

    def remove_subscription(
        self, world: str, peer: uuid_mod.UUID, pos: Vector3 | Cube
    ) -> bool:
        cube = to_cube(pos, self.cube_size)
        wid = self._world_ids.get(world)
        pid = self._peer_ids.get(peer)
        if wid is None or pid is None:
            return False
        key = self._key_of(wid, cube)
        try:
            found = self._find_live_row(key, wid, cube, pid)
        except _CollisionError:
            # The colliding cube is someone else's; ours isn't stored.
            return False
        if found is None:
            return False
        self._tombstone(found, key, pid)
        self._drop_world_peer(wid, pid, 1)
        self._dirty = True
        return True

    def _peer_base_rows(self, pid: int) -> np.ndarray:
        """Live base rows held by ``pid``: two binary searches + a small
        gather against a per-epoch pid-sorted view (built lazily, once
        per base install) instead of an O(S) column scan per eviction —
        a disconnect storm at 1M rows would otherwise stall the event
        loop scanning 4 MB per peer."""
        if self._bp.size == 0:
            return np.empty(0, np.intp)
        if self._base_pid_order is None:
            order = np.argsort(self._bp, kind="stable")
            self._base_pid_order = (order, self._bp[order])
        order, sorted_p = self._base_pid_order
        lo = int(np.searchsorted(sorted_p, pid, side="left"))
        hi = int(np.searchsorted(sorted_p, pid, side="right"))
        rows = order[lo:hi]
        # ``sorted_p`` is a build-time snapshot: rows tombstoned since
        # then still appear under their old pid — re-check liveness.
        return rows[self._bp[rows] == pid]

    def remove_peer(self, peer: uuid_mod.UUID) -> bool:
        pid = self._peer_ids.get(peer)
        if pid is None:
            return False
        rows_b = self._peer_base_rows(pid)
        drows = self._delta_pid_rows.pop(pid, None)
        if drows is not None:
            rows_d = np.asarray(drows, np.intp)
            rows_d = rows_d[self._dp[rows_d] == pid]
        else:
            rows_d = np.empty(0, np.intp)
        if rows_b.size == 0 and rows_d.size == 0:
            return False
        if self._delta_ticks:
            self._coherence.note_keys(np.concatenate([
                self._bk[rows_b], self._dk[rows_d]
            ]))

        in_flight = self._compaction is not None
        if rows_b.size:
            self._bp[rows_b] = -1
            self._pending_dead.extend(int(r) for r in rows_b)
            self._base_dead += int(rows_b.size)
            self._base_live -= int(rows_b.size)
            if in_flight:
                self._replay.extend(
                    (int(self._bk[r]), pid) for r in rows_b
                )
        if rows_d.size:
            consumed = self._compaction["consumed_dn"] if in_flight else 0
            for r in rows_d:
                r = int(r)
                self._dp[r] = -1
                self._delta_index.pop((int(self._dk[r]), pid), None)
                if r < self._delta_built_n:
                    self._pending_delta_dead.append(r)
                if in_flight and r < consumed:
                    self._replay.append((int(self._dk[r]), pid))
            self._delta_live -= int(rows_d.size)
            self._delta_stale = True

        # world-level refcounts: drop this peer from every touched world
        wids = np.unique(np.concatenate([
            self._bw[rows_b], self._dw[rows_d]
        ])) if rows_b.size or rows_d.size else ()
        for wid in wids:
            self._world_peers[int(wid)].pop(pid, None)

        self._dirty = True
        return True

    def _delta_append(self, key: int, wid: int, cube: Cube, pid: int) -> None:
        if self._dn == self._dcap:
            self._grow_delta(max(1024, self._dcap * 2))
        row = self._dn
        self._dk[row] = key
        self._dw[row] = wid
        self._dxyz[row] = cube
        self._dp[row] = pid
        self._dn += 1
        self._delta_live += 1
        if self._delta_ticks:
            self._coherence.note_key(key)
        self._delta_index[(key, pid)] = row
        self._delta_pid_rows.setdefault(pid, []).append(row)
        self._delta_keyrow.setdefault(key, row)
        run = self._delta_key_count[key] + 1
        self._delta_key_count[key] = run
        if run > self._delta_max_run:
            self._delta_max_run = run
        self._delta_stale = True

    def _grow_delta(self, cap: int) -> None:
        def grow(arr, shape, dtype):
            out = np.empty(shape, dtype)
            out[:self._dn] = arr[:self._dn]
            return out

        self._dk = grow(self._dk, cap, np.int64)
        self._dk2 = grow(self._dk2, cap, np.int64)
        self._dw = grow(self._dw, (cap,), np.int32)
        self._dxyz = grow(self._dxyz, (cap, 3), np.int64)
        self._dp = grow(self._dp, (cap,), np.int32)
        self._dcap = cap

    def _tombstone(self, found: tuple[str, int], key: int, pid: int) -> None:
        seg, row = found
        if self._delta_ticks:
            self._coherence.note_key(key)
        in_flight = self._compaction is not None
        if seg == "base":
            self._bp[row] = -1
            self._pending_dead.append(row)
            self._base_dead += 1
            self._base_live -= 1
            if in_flight:
                self._replay.append((key, pid))
        else:
            self._dp[row] = -1
            self._delta_live -= 1
            self._delta_index.pop((key, pid), None)
            if row < self._delta_built_n:
                self._pending_delta_dead.append(row)
            self._delta_stale = True
            if in_flight and row < self._compaction["consumed_dn"]:
                self._replay.append((key, pid))

    def _drop_world_peer(self, wid: int, pid: int, n: int) -> None:
        wp = self._world_peers[wid]
        wp[pid] -= n
        if wp[pid] <= 0:
            del wp[pid]

    # endregion

    # region: bulk mutations (vectorized loaders)

    def bulk_add_subscriptions(self, world, peers, cubes) -> int:
        """Bulk-load peers[i] → cube rows [N, 3] (already quantized).
        Vectorized: interning aside, no per-row Python. Loader for
        benchmarks, churn workloads and snapshot restore."""
        cubes = np.ascontiguousarray(cubes, dtype=np.int64)
        n = len(cubes)
        if n == 0:
            return 0
        wid = self._world_id(world)
        pids = self._intern_peers(peers)

        while True:
            keys = spatial_keys(
                np.full(n, wid, np.int32), cubes, self._seed
            )
            try:
                new_rows = self._bulk_dedupe(keys, pids, cubes, wid)
            except _CollisionError:
                self._reseed_rebuild()
                continue
            break

        if new_rows.size == 0:
            return 0
        if self._delta_ticks:
            self._coherence.note_keys(keys[new_rows])
        self._bulk_append(
            keys[new_rows], np.full(new_rows.size, wid, np.int32),
            cubes[new_rows], pids[new_rows],
        )
        # world-level refcounts, vectorized into the Counter
        u, c = np.unique(pids[new_rows], return_counts=True)
        counts = dict(zip(u.tolist(), c.tolist()))
        wp = self._world_peers[wid]
        if wp:
            wp.update(counts)
        else:
            self._world_peers[wid] = Counter(counts)
        self._dirty = True
        return int(new_rows.size)

    def bulk_remove_subscriptions(self, world, peers, cubes) -> int:
        """Vectorized unsubscribe of peers[i] from cube rows [N, 3].
        Returns the number of subscriptions actually removed."""
        cubes = np.ascontiguousarray(cubes, dtype=np.int64)
        n = len(cubes)
        wid = self._world_ids.get(world)
        if n == 0 or wid is None:
            return 0
        pids = np.fromiter(
            (self._peer_ids.get(p, -1) for p in peers), np.int64, count=n
        )
        keys = spatial_keys(np.full(n, wid, np.int32), cubes, self._seed)

        # intra-batch dedupe of (key, pid) pairs, drop unknown peers
        valid = pids >= 0
        if not valid.any():
            return 0
        k_, p_ = keys[valid], pids[valid]
        order = np.lexsort((p_, k_))
        ks_, ps_ = k_[order], p_[order]
        first = np.ones(ks_.size, bool)
        first[1:] = (ks_[1:] != ks_[:-1]) | (ps_[1:] != ps_[:-1])
        ks_, ps_ = ks_[first], ps_[first]

        in_flight = self._compaction is not None
        consumed = self._compaction["consumed_dn"] if in_flight else 0
        removed_pids: list[np.ndarray] = []

        # base rows: vectorized run-candidate join on (key, pid)
        bn = self._bk.size
        base_hit = np.zeros(ks_.size, bool)
        if bn:
            lo = np.searchsorted(self._bk, ks_, side="left")
            hi = np.searchsorted(self._bk, ks_, side="right")
            runs = hi - lo
            total = int(runs.sum())
            if total:
                qidx = np.repeat(np.arange(ks_.size), runs)
                rows = np.repeat(lo, runs) + (
                    np.arange(total) - np.repeat(np.cumsum(runs) - runs, runs)
                )
                match = self._bp[rows] == ps_[qidx]
                rows_found = rows[match]
                base_hit[qidx[match]] = True
                if rows_found.size:
                    if self._delta_ticks:
                        self._coherence.note_keys(self._bk[rows_found])
                    self._bp[rows_found] = -1
                    self._pending_dead.extend(rows_found.tolist())
                    self._base_dead += int(rows_found.size)
                    self._base_live -= int(rows_found.size)
                    removed_pids.append(ps_[qidx[match]])
                    if in_flight:
                        self._replay.extend(zip(
                            self._bk[rows_found].tolist(),
                            ps_[qidx[match]].tolist(),
                        ))

        # delta rows: dict lookups for the batch rows the base missed
        delta_removed = []
        delta_removed_keys: list[int] = []
        if self._delta_index:
            miss = np.flatnonzero(~base_hit)
            for i in miss:
                pair = (int(ks_[i]), int(ps_[i]))
                row = self._delta_index.pop(pair, None)
                if row is None:
                    continue
                self._dp[row] = -1
                delta_removed.append(pair[1])
                delta_removed_keys.append(pair[0])
                if row < self._delta_built_n:
                    self._pending_delta_dead.append(row)
                if in_flight and row < consumed:
                    self._replay.append(pair)
            if delta_removed:
                if self._delta_ticks:
                    self._coherence.note_keys(delta_removed_keys)
                self._delta_live -= len(delta_removed)
                self._delta_stale = True
                removed_pids.append(np.asarray(delta_removed, np.int64))

        if not removed_pids:
            return 0
        all_pids = np.concatenate(removed_pids)
        u, c = np.unique(all_pids, return_counts=True)
        for pid, cnt in zip(u.tolist(), c.tolist()):
            self._drop_world_peer(wid, int(pid), cnt)
        self._dirty = True
        return int(all_pids.size)

    def bulk_move_subscriptions(
        self, world, rem_peers, rem_cubes, add_peers, add_cubes,
    ) -> tuple[int, int]:
        """Moving-object churn ingest (entities/plane.py): retire
        ``rem_peers[i] → rem_cubes[i]`` rows and insert ``add_peers[i]
        → add_cubes[i]`` rows in one call, both through the base+delta
        path — tombstones into whichever segment holds each retired
        row, appends into the delta log (whose growth drives the normal
        compaction policy, so sustained churn exercises the LSM fold
        exactly like any other write stream). Removes run FIRST so a
        peer hopping cubes within one batch never momentarily holds
        two rows. Returns ``(removed, added)``."""
        removed = self.bulk_remove_subscriptions(world, rem_peers, rem_cubes)
        added = self.bulk_add_subscriptions(world, add_peers, add_cubes)
        return removed, added

    def _intern_peers(self, peers) -> np.ndarray:
        peer_ids = self._peer_ids
        peer_list = self._peer_list
        if not peer_ids:
            # Fresh-index fast path (1M-entity bulk load): one C-speed
            # dict build. Intra-batch duplicate peers map to their last
            # slot; earlier slots stay as unreferenced list entries.
            n0 = len(peer_list)
            peer_ids.update(zip(peers, range(n0, n0 + len(peers))))
            peer_list.extend(peers)
            if len(peer_ids) == len(peer_list):
                return np.arange(n0, n0 + len(peers), dtype=np.int64)
            return np.fromiter(
                (peer_ids[p] for p in peers), np.int64, count=len(peers)
            )
        out = np.empty(len(peers), np.int64)
        for i, p in enumerate(peers):
            pid = peer_ids.get(p)
            if pid is None:
                pid = peer_ids[p] = len(peer_list)
                peer_list.append(p)
            out[i] = pid
        return out

    def _bulk_dedupe(self, keys, pids, cubes, wid) -> np.ndarray:
        """Indices of rows that are new (not duplicates within the batch
        nor of existing live rows). Raises on any key collision."""
        n = len(keys)
        # intra-batch: keep the first row of each (key, pid) pair
        order = np.lexsort((pids, keys))
        ks, ps = keys[order], pids[order]
        first = np.ones(n, bool)
        first[1:] = (ks[1:] != ks[:-1]) | (ps[1:] != ps[:-1])
        # same key must mean same cube within the batch
        same_key = ks[1:] == ks[:-1]
        if same_key.any():
            a, b = order[1:][same_key], order[:-1][same_key]
            if (cubes[a] != cubes[b]).any():
                raise _CollisionError
        if (keys == int(PAD_KEY)).any():
            raise _CollisionError
        reps = order[first]

        # vs existing live rows: candidate extraction (only the base
        # runs + delta rows matching batch keys — O(hits), not O(S)),
        # then a union-rank merge join over (key, pid)
        self._check_batch_collisions(keys[reps], cubes[reps], wid)
        exist_k, exist_p = self._candidate_pairs(keys[reps])
        if exist_k.size:
            uniq = np.unique(np.concatenate([exist_k, keys[reps]]))
            ex_comb = (
                np.searchsorted(uniq, exist_k).astype(np.uint64) << np.uint64(32)
            ) | exist_p.astype(np.uint64)
            q_comb = (
                np.searchsorted(uniq, keys[reps]).astype(np.uint64) << np.uint64(32)
            ) | pids[reps].astype(np.uint64)
            ex_comb.sort()
            pos = np.searchsorted(ex_comb, q_comb)
            pos = np.minimum(pos, ex_comb.size - 1)
            member = ex_comb[pos] == q_comb
            reps = reps[~member]
        return reps

    def _candidate_pairs(self, qkeys) -> tuple[np.ndarray, np.ndarray]:
        """Live (key, pid) rows whose key appears in ``qkeys`` —
        the only rows a batch membership check can hit."""
        parts_k, parts_p = [], []
        bn = self._bk.size
        if bn:
            lo = np.searchsorted(self._bk, qkeys, side="left")
            hi = np.searchsorted(self._bk, qkeys, side="right")
            runs = hi - lo
            total = int(runs.sum())
            if total:
                # row indices of every run, concatenated
                starts = np.repeat(lo, runs)
                offs = np.arange(total) - np.repeat(
                    np.cumsum(runs) - runs, runs
                )
                rows = starts + offs
                live = self._bp[rows] >= 0
                parts_k.append(self._bk[rows[live]])
                parts_p.append(self._bp[rows[live]])
        dn = self._dn
        if dn:
            hit = np.isin(self._dk[:dn], qkeys) & (self._dp[:dn] >= 0)
            if hit.any():
                parts_k.append(self._dk[:dn][hit])
                parts_p.append(self._dp[:dn][hit])
        if not parts_k:
            return np.empty(0, np.int64), np.empty(0, np.int32)
        return np.concatenate(parts_k), np.concatenate(parts_p)

    def _check_batch_collisions(self, keys, cubes, wid) -> None:
        bn = self._bk.size
        if bn:
            lo = np.searchsorted(self._bk, keys, side="left")
            li = np.minimum(lo, bn - 1)
            hit = self._bk[li] == keys
            if hit.any():
                ok = (
                    (self._bw[li[hit]] == wid)
                    & (self._bxyz[li[hit]] == cubes[hit]).all(axis=1)
                )
                if not ok.all():
                    raise _CollisionError
        if self._delta_keyrow:
            # only batch keys actually present in the delta need a look
            dkeys = np.fromiter(
                self._delta_keyrow, np.int64, count=len(self._delta_keyrow)
            )
            for i in np.flatnonzero(np.isin(keys, dkeys)):
                drow = self._delta_keyrow[int(keys[i])]
                if self._dw[drow] != wid or (
                    self._dxyz[drow] != cubes[i]
                ).any():
                    raise _CollisionError

    def _live_pairs(self) -> tuple[np.ndarray, np.ndarray]:
        """All live (key, pid) rows across base + delta."""
        live_b = self._bp >= 0
        live_d = self._dp[:self._dn] >= 0
        return (
            np.concatenate([self._bk[live_b], self._dk[:self._dn][live_d]]),
            np.concatenate([self._bp[live_b], self._dp[:self._dn][live_d]]),
        )

    def _bulk_append(self, keys, wids, cubes, pids) -> None:
        n = len(keys)
        threshold = self._compact_threshold()
        total_live = self._base_live + self._delta_live
        if (
            n > self.SYNC_COMPACT_FACTOR * threshold
            or self._delta_live + n >= self.SYNC_COMPACT_FACTOR * threshold
            or (
                self._base_stale
                and self._delta_live + n >= max(total_live // 32, 1024)
            )
        ):
            # Fold straight into a new base when: the load is huge
            # (initial index build, snapshot restore); OR the delta
            # would overrun into sync-fallback territory anyway — e.g.
            # per-world bulk calls that are individually under the
            # limit but jointly a full rebuild; OR an upload is already
            # owed (mid-load-phase) and the pending rows are a real
            # fraction (>= 1/32) of the index, so folding costs one more
            # host sort but zero extra device traffic — the upload is
            # DEFERRED to the next flush either way, so a whole load
            # phase (even 64+ small per-world calls) ships ONE base and
            # ends fully compacted: no trailing delta segment slowing
            # every subsequent query batch, no delta-tier first
            # launch on the flush path. No delta dict fills, one
            # vectorized host sort.
            self._rebuild_base_with(keys, wids, cubes, pids)
            return
        if self._dn + n > self._dcap:
            self._grow_delta(next_pow2(self._dn + n, 1024))
        a, b = self._dn, self._dn + n
        self._dk[a:b] = keys
        self._dw[a:b] = wids
        self._dxyz[a:b] = cubes
        self._dp[a:b] = pids
        rows = range(a, b)
        idx = self._delta_index
        keyrow = self._delta_keyrow
        pid_rows = self._delta_pid_rows
        for row, key, pid in zip(rows, keys.tolist(), pids.tolist()):
            idx[(key, pid)] = row
            keyrow.setdefault(key, row)
            pid_rows.setdefault(pid, []).append(row)
        kc = self._delta_key_count
        u, c = np.unique(keys, return_counts=True)
        for key, cnt in zip(u.tolist(), c.tolist()):
            run = kc[key] + cnt
            kc[key] = run
            if run > self._delta_max_run:
                self._delta_max_run = run
        self._dn = b
        self._delta_live += n
        self._delta_stale = True

    def _rebuild_base_with(self, keys, wids, cubes, pids) -> None:
        """Synchronously fold (live base + live delta + new rows) into a
        fresh sorted base; clears the delta."""
        if self._compaction is not None:
            self._abandon_compaction()
        live_b = self._bp >= 0
        live_d = self._dp[:self._dn] >= 0
        all_k = np.concatenate([self._bk[live_b], self._dk[:self._dn][live_d], keys])
        all_w = np.concatenate([self._bw[live_b], self._dw[:self._dn][live_d], wids])
        all_x = np.concatenate(
            [self._bxyz[live_b], self._dxyz[:self._dn][live_d], cubes]
        )
        all_p = np.concatenate([
            self._bp[live_b], self._dp[:self._dn][live_d],
            pids.astype(np.int32),
        ])
        self._install_base(*_sort_segment(all_k, all_w, all_x, all_p))
        self._clear_delta()
        self._dirty = True

    # endregion

    # region: reseed (hash collision — expected ~never)

    def _reseed_rebuild(self) -> None:
        """A key collision was detected: bump the seed until every live
        cube gets a distinct non-sentinel key, then rebuild the base."""
        if self._compaction is not None:
            self._abandon_compaction()
        live_b = self._bp >= 0
        live_d = self._dp[:self._dn] >= 0
        w = np.concatenate([self._bw[live_b], self._dw[:self._dn][live_d]])
        x = np.concatenate([self._bxyz[live_b], self._dxyz[:self._dn][live_d]])
        p = np.concatenate([self._bp[live_b], self._dp[:self._dn][live_d]])
        while True:
            self._seed += 1
            keys = spatial_keys(w.astype(np.int32), x, self._seed)
            order = np.argsort(keys, kind="stable")
            ks = keys[order]
            same = ks[1:] == ks[:-1]
            bad = (ks == int(PAD_KEY)).any()
            if same.any():
                a, b = order[1:][same], order[:-1][same]
                bad = bad or (w[a] != w[b]).any() or (x[a] != x[b]).any()
            if not bad:
                break
        self._install_base(ks, w[order].astype(np.int32), x[order],
                           p[order].astype(np.int32))
        self._clear_delta()
        self._dirty = True

    # endregion

    # region: flush / compaction

    def _compact_threshold(self) -> int:
        if self._compact_threshold_override is not None:
            return self._compact_threshold_override
        return max(4096, self._bk.size // self.COMPACT_DELTA_FRACTION)

    def flush(self) -> None:
        """Make all prior mutations visible to device queries. Cost is
        O(churn since last flush) plus, rarely, a compaction."""
        if self._compaction is not None and self._compaction["done"].is_set():
            err = self._swap_compaction()
            if err is not None:
                _log.warning("background compaction failed, will retry: %s", err)

        # 0. deferred base upload (bulk load / restore / sync rebuild)
        # — designated full-path site: the base was rebuilt wholesale
        # off the tick path and owes the device exactly one ship
        self._upload_stale_base()  # wql: allow(full-rebuild-on-tick)

        if not self._dirty:
            return
        self._dirty = False

        # 1. tombstones → one device scatter
        if self._pending_dead and self._base_bundle is not None:
            rows = np.asarray(self._pending_dead, np.int32)
            self._base_bundle = self._scatter_base_dead(self._base_bundle, rows)
        self._pending_dead.clear()

        # 2. delta device twin: upload new rows, scatter tombstones,
        # re-sort on device — O(churn) transfer
        if self._delta_stale:
            self._delta_stale = False
            self._sync_delta()

        # 3. compaction policy. delta_dead matters too: under steady
        # resubscribe churn (move out of a cube, into another) the live
        # count stays flat while tombstoned log rows pile up — without
        # the delta_dead trigger the log, its device buffer and the
        # per-flush device sort grow without bound.
        threshold = self._compact_threshold()
        dead_threshold = max(
            4096, self._bk.size // self.COMPACT_DEAD_FRACTION
        )
        delta_dead = self._dn - self._delta_live
        # live OR tombstone-dominated overrun: under resubscribe churn
        # _delta_live stays flat while dead log rows pile up — the log
        # (_dn) must bound too
        overrun = (
            self._delta_live > self.SYNC_COMPACT_FACTOR * threshold
            or delta_dead > self.SYNC_COMPACT_FACTOR * dead_threshold
        )
        if overrun and self._compaction is not None:
            stalled = time.monotonic() - self._compaction["started"]
            if stalled > self.COMPACT_STALL_SECS:
                # A worker that hangs (device call never returns) would
                # otherwise block both policy branches forever while the
                # delta grows without bound. Orphan it: the epoch bump
                # means its eventual result can never swap in.
                _log.warning(
                    "abandoning wedged compaction after %.0fs", stalled
                )
                self._abandon_compaction()
                self.compaction_failures += 1
                self._failed_streak += 1
        if self._compaction is None:
            if overrun and self._failed_streak >= self.SYNC_FALLBACK_FAILURES:
                # Last resort: the delta overran AND the background
                # worker keeps failing or hanging — fold on the owning
                # thread so a persistent device fault surfaces
                # synchronously instead of the delta growing forever. A
                # healthy overrun (churn outpacing one compaction) stays
                # off the event loop: the oversized delta keeps serving
                # correctly while the next background fold catches up.
                self._compact_sync()  # wql: allow(full-rebuild-on-tick) — last-resort sync fold (persistent device failure)
            elif (
                (
                    self._delta_live > threshold
                    or self._base_dead > dead_threshold
                    or delta_dead > dead_threshold
                )
                and (self._base_dead or self._dn)
            ):
                self._start_compaction()

    def _sync_delta(self) -> None:
        """Bring the device delta twin up to date with the host log.
        Transfers only the NEW rows chunk + tombstone indices; the
        key-sort runs on device (one fused launch per flush).

        With delta ticks armed, a flush whose only changes are
        tombstones skips the re-sort entirely: the persistent SORTED
        segment takes one O(K) peer scatter at host-mapped sorted
        positions (keys never change, so the run structure and probe
        table stay valid — the same contract the base segment's
        tombstone scatter has always relied on). Past
        ``delta_rebuild_threshold`` of the built log the full re-sort
        path takes over (tombstone debt — one sort re-amortizes it)."""
        dn = self._dn
        if dn == 0:
            self._delta_buf = None
            self._delta_buf_cap = 0
            self._delta_built_n = 0
            self._delta_bundle = None
            self._delta_sort_pos = None
            self._pending_delta_dead.clear()
            return

        if self._delta_tombstones_only():
            self._scatter_sorted_tombstones()
            return

        built = self._delta_built_n
        chunk_n = next_pow2(dn - built, 8) if dn > built else 0
        cap_needed = next_pow2(max(dn, built + chunk_n), 1024)
        if self._delta_buf is None:
            self._delta_buf = self._alloc_delta_buffer(cap_needed)
            self._delta_buf_cap = cap_needed
        elif cap_needed > self._delta_buf_cap:
            self._delta_buf = self._grow_delta_buffer(
                self._delta_buf, cap_needed
            )
            self._delta_buf_cap = cap_needed

        if dn > built:
            # second keys are computed lazily here (vectorized over the
            # new chunk) rather than per-row on the append hot path
            self._dk2[built:dn] = spatial_keys2(
                self._dw[built:dn], self._dxyz[built:dn], self._seed
            )
            chunk = (
                pad_to(self._dk[built:dn], chunk_n, PAD_KEY),
                pad_to(self._dk2[built:dn], chunk_n, np.int64(0)),
                pad_to(self._dp[built:dn], chunk_n, np.int32(-1)),
            )
            self._delta_buf = self._write_delta_chunk(
                self._delta_buf, chunk, built
            )
            self._delta_built_n = dn

        if self._pending_delta_dead:
            rows = np.asarray(self._pending_delta_dead, np.int32)
            rows = pad_to(rows, next_pow2(rows.size),
                          np.int32(self._delta_buf_cap))
            self._delta_buf = (
                *self._delta_buf[:2],
                self._scatter_delta_dead(self._delta_buf[2], rows),
            )
            self._pending_delta_dead.clear()

        self._delta_k = next_pow2(self._delta_max_run, 8)
        t0 = time.perf_counter()
        self._delta_bundle = {
            # designated full-rebuild site: new rows were appended (or
            # tombstone debt crossed the threshold) — the sorted
            # segment must rebuild from the insertion-order buffer
            "dev": self._sort_delta(  # wql: allow(full-rebuild-on-tick)
                self._delta_buf,
                probe_buckets_for(len(self._delta_key_count)),
            ),
            "cap": self._delta_buf_cap,
        }
        self._delta_sort_pos = None  # mapping is for the OLD sort state
        self.delta_sync_sorts += 1
        self.last_delta_sync = {
            "path": "sort",
            "ms": round((time.perf_counter() - t0) * 1e3, 3),
            "rows": dn,
        }

    def _delta_tombstones_only(self) -> bool:
        """True when this flush can skip the delta re-sort: delta
        ticks armed, a sorted device segment exists and matches the
        log (no new rows since it was built), the only pending work is
        tombstones, and their volume is under the rebuild
        threshold."""
        pending = len(self._pending_delta_dead)
        return (
            self._delta_ticks
            and pending > 0
            and self._dn == self._delta_built_n
            and self._delta_buf is not None
            and self._delta_bundle is not None
            and self._delta_scatter_supported()
            and pending <= max(
                1, int(self.delta_rebuild_threshold * self._delta_built_n)
            )
        )

    def _delta_scatter_supported(self) -> bool:
        """Single-device segments take the in-place sorted scatter; the
        sharded backend overrides to False (its delta is replicated)."""
        return True

    def _scatter_sorted_tombstones(self) -> None:
        """O(K) incremental update of the persistent device hash: land
        pending tombstones in BOTH delta twins — the insertion-order
        buffer (so future sorts/compactions see them) and the sorted
        serving segment at host-mapped positions (so this flush ships
        K indices instead of re-sorting the whole log). Keys, run
        remainders and the probe table are untouched — tombstones
        rewrite peers only."""
        t0 = time.perf_counter()
        rows = np.asarray(self._pending_delta_dead, np.int32)
        padded = pad_to(rows, next_pow2(rows.size),
                        np.int32(self._delta_buf_cap))
        self._delta_buf = (
            *self._delta_buf[:2],
            self._scatter_delta_dead(self._delta_buf[2], padded),
        )
        pos = self._delta_sorted_positions()
        sorted_rows = pad_to(
            pos[rows].astype(np.int32), next_pow2(rows.size),
            np.int32(self._delta_buf_cap),
        )
        dev = self._delta_bundle["dev"]
        self._delta_bundle = {
            **self._delta_bundle,
            "dev": (*dev[:2], _scatter_dead(dev[2], sorted_rows), *dev[3:]),
        }
        self._pending_delta_dead.clear()
        self.delta_sync_scatters += 1
        self.last_delta_sync = {
            "path": "scatter",
            "ms": round((time.perf_counter() - t0) * 1e3, 3),
            "rows": int(rows.size),
        }

    def _delta_sorted_positions(self) -> np.ndarray:
        """Host mirror of the device delta sort: log row → position in
        the sorted segment. Both sides run a STABLE ascending sort of
        the identical padded key array (keys never change after
        append), so the permutations agree exactly. Cached per
        (built, cap) build state; any event that rewrites log rows
        (compaction tail shift, clear) resets the cache explicitly."""
        state = (self._delta_built_n, self._delta_buf_cap)
        if self._delta_sort_pos is None or self._delta_sort_pos[0] != state:
            keys = np.full(self._delta_buf_cap, PAD_KEY, np.int64)
            keys[: self._delta_built_n] = self._dk[: self._delta_built_n]
            order = np.argsort(keys, kind="stable")
            pos = np.empty(self._delta_buf_cap, np.int64)
            pos[order] = np.arange(self._delta_buf_cap)
            self._delta_sort_pos = (state, pos)
        return self._delta_sort_pos[1]

    # -- delta device-op seams --

    def _alloc_delta_buffer(self, cap: int) -> tuple:
        return _alloc_buffers(cap, self.device)

    def _grow_delta_buffer(self, bufs: tuple, cap: int) -> tuple:
        return _grow_buffers(bufs, cap)

    def _write_delta_chunk(self, bufs: tuple, chunk: tuple, start: int):
        return _write_chunk(bufs, chunk, start)

    def _scatter_delta_dead(self, peer_buf, rows: np.ndarray):
        return _scatter_dead(peer_buf, rows)

    def _sort_delta(self, bufs: tuple, n_buckets: int) -> tuple:
        return _sort_segment_dev(*bufs, n_buckets=n_buckets)

    def _upload_stale_base(self) -> None:
        """Ship a deferred (host-newer-than-device) base to the device.
        The host arrays already reflect every mutation up to now —
        including tombstones, so the pending scatter list is moot."""
        if not self._base_stale:
            return
        if self._dn:
            # a load phase is ending (stale base = no dispatch since
            # the rebuilds) with a delta tail the fraction threshold
            # didn't catch — live rows, or tombstone-only rows that
            # would still cost a device sort: fold it in now, so the
            # flush ships ONE fully-compacted base instead of also
            # sorting/uploading a delta segment (and compiling its
            # shape tier). The rebuild clears all delta state.
            self._rebuild_base_with(
                np.empty(0, np.int64), np.empty(0, np.int32),
                np.empty((0, 3), np.int64), np.empty(0, np.int64),
            )
        # flag cleared only AFTER the upload: a transient device/link
        # failure here must leave the flush retryable, not permanently
        # drop the base segment from device queries
        self._base_bundle = (
            self._upload_base(self._bk, self._bk2, self._bp, self._base_k)
            if self._bk.size else None
        )
        self._base_stale = False
        self._pending_dead = []

    def _compact_sync(self) -> None:
        if self._compaction is not None:
            self._abandon_compaction()
        self._rebuild_base_with(
            np.empty(0, np.int64), np.empty(0, np.int32),
            np.empty((0, 3), np.int64), np.empty(0, np.int64),
        )
        self.compactions += 1
        # the rebuild marked dirty (and _clear_delta reset all delta
        # state); complete the flush for the new state. This runs
        # INSIDE flush, after its own stale-upload step — the rebuilt
        # base must reach the device before this flush returns.
        self._upload_stale_base()
        self._dirty = False

    def _start_compaction(self) -> None:
        """Fold base + device-resident delta into a fresh base on a
        worker thread. The DEVICE side sorts its own resident arrays —
        zero host→device transfer; the host applies the identical
        stable transform to its numpy mirror so row indices stay
        aligned. Must run right after ``_sync_delta`` (flush order), so
        device state == host state up to ``_delta_built_n``."""
        consumed = self._delta_built_n
        snap = {
            "bk": self._bk, "bk2": self._bk2, "bw": self._bw,
            "bxyz": self._bxyz, "bp": self._bp.copy(),
            "dk": self._dk[:consumed].copy(),
            "dk2": self._dk2[:consumed].copy(),
            "dw": self._dw[:consumed].copy(),
            "dxyz": self._dxyz[:consumed].copy(),
            "dp": self._dp[:consumed].copy(),
            "delta_cap": self._delta_buf_cap,
            "base_bundle": self._base_bundle,
            "delta_buf": self._delta_buf,
        }
        state = {
            "done": threading.Event(),
            "epoch": self._epoch,
            "consumed_dn": consumed,
            "started": time.monotonic(),
            "result": None,
            "error": None,
        }

        def work():
            # done must be set on EVERY exit: an unset event would wedge
            # wait_compaction forever and block future compactions (the
            # guard requires _compaction is None).
            try:
                state["result"] = self._compact_work(snap)
            except BaseException as exc:  # noqa: BLE001 — surfaced at swap
                state["error"] = exc
            finally:
                state["done"].set()

        state["thread"] = threading.Thread(
            target=work, name="index-compaction", daemon=True
        )
        self._compaction = state
        self._replay = []
        state["thread"].start()

    def _compact_work(self, snap: dict) -> tuple:
        """Build the compacted base: host mirror (numpy) + device twin.
        Runs off the owning thread; touches only the snapshot."""
        # host mirror: full-capacity views matching the device layout
        dcap = snap["delta_cap"]
        dk = pad_to(snap["dk"], dcap, PAD_KEY)
        dk2 = pad_to(snap["dk2"], dcap, np.int64(0))
        dw = pad_to(snap["dw"], dcap, NO_WORLD)
        dxyz = pad_to(snap["dxyz"], dcap, _XYZ_PAD)
        dp = pad_to(snap["dp"], dcap, np.int32(-1))
        keys = np.concatenate([snap["bk"], dk])
        keys2 = np.concatenate([snap["bk2"], dk2])
        wids = np.concatenate([snap["bw"], dw])
        xyz = np.concatenate([snap["bxyz"], dxyz])
        peers = np.concatenate([snap["bp"], dp])
        keys = np.where(peers < 0, PAD_KEY, keys)
        live_total = int((peers >= 0).sum())
        if live_total == 0:
            return (np.empty(0, np.int64), np.empty(0, np.int64),
                    np.empty(0, np.int32), np.empty((0, 3), np.int64),
                    np.empty(0, np.int32), 1, None, 0)
        cap2 = next_pow2(live_total)
        order = np.argsort(keys, kind="stable")[:cap2]
        hk, hk2, hw, hx, hp = (keys[order], keys2[order], wids[order],
                               xyz[order], peers[order])
        k = next_pow2(_max_run(hk[:live_total]), 8)
        bundle = self._compact_device(
            snap, cap2, (hk, hk2, hp), k,
            probe_buckets_for(n_distinct(hk[:live_total])),
        )
        return (hk, hk2, hw, hx, hp, k, bundle, live_total)

    def _compact_device(
        self, snap: dict, cap2: int, host_arrays, k, n_buckets: int
    ) -> dict:
        """Device side of compaction: fold the resident tensors on the
        device (no transfer; they are the snapshot's, never written
        since — every device update is out of place). Uploads the host
        mirror when the base has no device twin yet."""
        base = snap["base_bundle"]
        dbuf = snap["delta_buf"]
        if base is not None:
            bk, bk2, bp = base["dev"][:3]
            delta = (dbuf if dbuf is not None
                     else _alloc_buffers(8, self.device))
            dev = _device_compact(
                bk, bk2, bp, *delta, cap2=cap2, n_buckets=n_buckets
            )
            return {"dev": dev, "cap": cap2}
        return self._upload_base(*host_arrays, k)

    def wait_compaction(self) -> None:
        """Block until no compaction is in flight (tests, benchmarks,
        shutdown). The post-swap flush may start a follow-up compaction
        over the delta tail; loop until quiescent. A failed compaction
        raises here (a silent retry could spin this loop forever), and
        so does a wedged one — an unbounded wait would hang shutdown."""
        while self._compaction is not None:
            if not self._compaction["done"].wait(self.COMPACT_STALL_SECS):
                self._abandon_compaction()
                self.compaction_failures += 1
                self._failed_streak += 1
                raise RuntimeError(
                    "compaction wedged: no progress within "
                    f"{self.COMPACT_STALL_SECS}s"
                )
            err = self._swap_compaction()
            if err is not None:
                raise RuntimeError("background compaction failed") from err
            self._dirty = True
            self.flush()

    def _swap_compaction(self) -> BaseException | None:
        """Install a finished compaction; returns the worker's error, if
        any. On failure the host authority is untouched (the worker only
        reads its snapshot), so recovery is: drop the attempt and let
        the flush policy retry in the background — a persistent failure
        eventually overruns the delta and surfaces synchronously on the
        owning thread via ``_compact_sync``."""
        state = self._compaction
        self._compaction = None
        if state["epoch"] != self._epoch:
            return None  # a reseed/sync rebuild superseded this run
        if state["error"] is not None:
            self._replay = []
            self.compaction_failures += 1
            self._failed_streak += 1
            # Re-arm the flush policy step: with no new mutations an
            # un-dirty flush would early-return and never retry.
            self._dirty = True
            return state["error"]
        keys, keys2, wids, xyz, pids, k, bundle, live_total = state["result"]
        self._failed_streak = 0
        self._bk, self._bk2 = keys, keys2
        self._bw, self._bxyz, self._bp = wids, xyz, pids
        self._base_pid_order = None
        self._base_k = k
        self._base_bundle = bundle
        self._base_live = live_total
        self._base_dead = 0
        self._pending_dead = []
        self.compactions += 1

        # replay removals that touched snapshot rows
        if self._replay:
            for key, pid in self._replay:
                lo, hi = self._base_run(key)
                j = np.flatnonzero(self._bp[lo:hi] == pid)
                if j.size:
                    row = lo + int(j[0])
                    self._bp[row] = -1
                    self._pending_dead.append(row)
                    self._base_dead += 1
                    self._base_live -= 1
            self._replay = []

        # shift the unconsumed delta tail to the front; the device
        # buffer starts over (the tail is small — rows added
        # while the compaction ran)
        consumed = state["consumed_dn"]
        rem = self._dn - consumed
        if rem:
            self._dk[:rem] = self._dk[consumed:self._dn]
            self._dw[:rem] = self._dw[consumed:self._dn]
            self._dxyz[:rem] = self._dxyz[consumed:self._dn]
            self._dp[:rem] = self._dp[consumed:self._dn]
        self._dn = rem
        self._delta_live = int((self._dp[:rem] >= 0).sum())
        self._delta_index = {
            (int(self._dk[r]), int(self._dp[r])): r
            for r in range(rem) if self._dp[r] >= 0
        }
        keyrow: dict[int, int] = {}
        kc: Counter = Counter()
        pid_rows: dict[int, list[int]] = {}
        for r in range(rem):
            key = int(self._dk[r])
            keyrow.setdefault(key, r)
            kc[key] += 1
            pid = int(self._dp[r])
            if pid >= 0:
                pid_rows.setdefault(pid, []).append(r)
        self._delta_keyrow = keyrow
        self._delta_key_count = kc
        self._delta_pid_rows = pid_rows
        self._delta_max_run = max(kc.values(), default=1)
        self._delta_buf = None
        self._delta_buf_cap = 0
        self._delta_built_n = 0
        self._pending_delta_dead = []
        self._delta_bundle = None
        self._delta_sort_pos = None  # log rows shifted — stale mapping
        self._delta_stale = True
        self._dirty = True

    def _abandon_compaction(self) -> None:
        """Invalidate an in-flight compaction (reseed/sync rebuild is
        about to replace the base wholesale)."""
        self._epoch += 1
        self._compaction = None
        self._replay = []

    def _install_base(self, keys, wids, xyz, pids) -> None:
        """Install a freshly sorted base from live rows (bulk load /
        reseed), padding host arrays to the device capacity so host row
        indices always mirror the device layout."""
        self._epoch += 1
        if self._delta_ticks:
            # wholesale membership/key rewrite: nothing cached before
            # this instant may ever replay (reseed changes every key;
            # a bulk fold can carry rows the churn stream never marked)
            self._coherence.invalidate_all()
        n = int(keys.size)
        self._base_pid_order = None
        # any successful base install (bulk fold, reseed, sync fold)
        # proves the path healthy again — a stale failure streak must
        # not force future overruns onto the owning thread
        self._failed_streak = 0
        self._base_live = n
        self._base_dead = 0
        self._base_k = next_pow2(_max_run(keys), 8) if n else 1
        if n:
            cap = next_pow2(n)
            self._bk = pad_to(keys, cap, PAD_KEY)
            self._bk2 = pad_to(
                spatial_keys2(
                    wids.astype(np.int32, copy=False), xyz, self._seed
                ),
                cap, np.int64(0),
            )
            self._bw = pad_to(wids.astype(np.int32, copy=False), cap, NO_WORLD)
            self._bxyz = pad_to(xyz, cap, _XYZ_PAD)
            self._bp = pad_to(pids.astype(np.int32, copy=False), cap,
                              np.int32(-1))
            # upload DEFERRED to the next flush: consecutive bulk loads
            # (per-world build calls, snapshot restore) re-install the
            # base once per call but ship it to the device once total
            self._base_bundle = None
            self._base_stale = True
        else:
            self._bk = np.empty(0, np.int64)
            self._bk2 = np.empty(0, np.int64)
            self._bw = np.empty(0, np.int32)
            self._bxyz = np.empty((0, 3), np.int64)
            self._bp = np.empty(0, np.int32)
            self._base_bundle = None
            self._base_stale = False
        self._pending_dead = []
        self._replay = []

    def _clear_delta(self) -> None:
        self._delta_sort_pos = None
        self._dn = 0
        self._delta_live = 0
        self._delta_index = {}
        self._delta_keyrow = {}
        self._delta_key_count = Counter()
        self._delta_max_run = 1
        self._delta_pid_rows = {}
        self._delta_buf = None
        self._delta_buf_cap = 0
        self._delta_built_n = 0
        self._pending_delta_dead = []
        self._delta_bundle = None
        self._delta_stale = False

    # endregion

    # region: device upload seams

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """One host array → a tensor on ``self.device`` (a copy)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device, copy=True)

    def _upload_base(self, keys, keys2, pids, k) -> dict:
        cap = next_pow2(keys.size)
        padded_keys = pad_to(keys, cap, PAD_KEY)
        sk = self._put(padded_keys)
        sk2 = self._put(pad_to(keys2, cap, np.int64(0)))
        rem = self._put(run_remainders_np(padded_keys))
        tbl, oflow = _probe_only_dev(
            sk, sk2, n_buckets=probe_buckets_for(n_distinct(keys))
        )
        return {
            "dev": (
                sk,
                sk2,
                self._put(pad_to(pids.astype(np.int32), cap, np.int32(-1))),
                rem, tbl, oflow,
            ),
            "cap": cap,
        }

    def _scatter_base_dead(self, bundle: dict, rows: np.ndarray) -> dict:
        # tombstones rewrite peers only — keys, runs and the probe
        # table stay valid for the segment's lifetime
        dev = bundle["dev"]
        cap = bundle["cap"]
        padded = pad_to(rows, next_pow2(rows.size), np.int32(cap))
        return {
            **bundle,
            "dev": (*dev[:2], _scatter_dead(dev[2], padded), *dev[3:]),
        }

    # endregion

    # region: batched hot path

    def _segments(self):
        """→ (device tensor tuples, K per segment, segment kinds)."""
        segs, ks, kinds = [], [], []
        if self._base_bundle is not None:
            segs.append(self._base_bundle["dev"])
            ks.append(self._base_k)
            kinds.append("base")
        if self._delta_bundle is not None:
            segs.append(self._delta_bundle["dev"])
            ks.append(self._delta_k)
            kinds.append("delta")
        return segs, tuple(ks), tuple(kinds)

    def match_arrays(
        self,
        world_ids: np.ndarray,
        positions: np.ndarray,
        sender_ids: np.ndarray,
        repls: np.ndarray,
    ) -> np.ndarray:
        """Array-native hot path: [M] int32 interned world ids, [M, 3]
        f64 positions, [M] int32 sender peer ids (-1 for none), [M] int8
        replication → [M, K] int32 peer ids, -1-padded.

        Quantizes host-side (golden f64 semantics), then one fused
        device batch. The object API wraps this; benchmarks call it
        directly.
        """
        m, result = self.match_arrays_async(
            world_ids, positions, sender_ids, repls
        )
        if result is None:
            return np.full((m, 1), -1, dtype=np.int32)
        # This sync IS the synchronous API's contract.
        return _to_host(result)[:m]

    def match_arrays_async(
        self,
        world_ids: np.ndarray,
        positions: np.ndarray,
        sender_ids: np.ndarray,
        repls: np.ndarray,
        max_hits: int | None = None,
        csr_cap: int | None = None,
    ):
        """Asynchronous hot path: dispatch without forcing the result.

        Returns ``(m, result)`` where ``result`` is the device value —
        dense ``targets``; with ``max_hits`` the sparse
        ``(rows, targets, n_hits)`` triple; with ``csr_cap`` the
        compacted ``(counts, flat_targets, total)`` triple. Callers
        overlap ticks by dispatching tick t+1 before reading tick t
        (double buffering: transfer and compute of adjacent ticks
        overlap)."""
        self.flush()
        m = len(world_ids)
        segs, ks, kinds = self._segments()
        if not segs or m == 0:
            return m, None

        t0 = time.perf_counter()
        queries = self._prepare_queries(
            world_ids, positions, sender_ids, repls
        )
        self._span("index.encode", t0)
        result, _, _ = self._launch(
            queries, segs, ks, kinds, csr_cap=csr_cap, max_hits=max_hits
        )
        return m, result[0] if max_hits is None and csr_cap is None else result

    def _launch(self, queries, segs, ks, kinds, *, csr_cap=None,
                max_hits=None):
        """Pick the result layout, dispatch, and enqueue the D2H
        prefetch (by the time a pipelined caller reads, the copy has
        landed — the read costs no round-trip): the ``index.launch``
        span. Returns ``(result, prefetch, legs)``: a tuple of device
        tensors, the :class:`_HostCopy` of the ones prefetched, and the
        span's timing legs (``h2d_ms``: the launch up to the prefetch,
        queue time on a card; ``d2h_enqueue_ms``: the prefetch's
        enqueue). Shared by the array API and the server delivery path
        so the dispatch pipeline cannot drift between them."""
        t0 = time.perf_counter()
        if csr_cap is not None:
            # zone A needs one identity row per (padded query, segment)
            csr_cap = max(
                csr_cap, CSR_ROW * queries[0].shape[0] * len(segs) + 64
            )
            result = self._dispatch_csr(
                queries, segs, ks, kinds,
                self._csr_effective_cap(next_pow2(csr_cap), queries, segs),
            )
        elif max_hits is not None:
            result = self._dispatch_sparse(
                queries, segs, ks, kinds, next_pow2(max_hits)
            )
        else:
            result = (self._dispatch(queries, segs, ks, kinds),)
        prefetch = result
        if csr_cap is not None and self._compact_applicable(csr_cap):
            # counts + total only: the cap-padded flat stays on device —
            # collect packs it into a bucket sized to the ACTUAL fan-out
            # and fetches that instead (prefetching the full array here
            # would ship the O(cap) bytes the compaction exists to
            # avoid)
            prefetch = (result[0], result[2])
        t_pf = time.perf_counter()
        host = _HostCopy(prefetch)
        t1 = self._span("index.launch", t0)
        return result, host, {"h2d_ms": (t_pf - t0) * 1e3,
                              "d2h_enqueue_ms": (t1 - t_pf) * 1e3}

    def _span(self, name: str, t0: float) -> float:
        """Ends the fan-out span ``name`` begun at ``t0``: one clock
        read, shared by the timing legs and, with tracing on, the
        span. Returns the read."""
        t1 = time.perf_counter()
        self.tracer.record(name, t0, t1)
        return t1

    def _query_cap(self, m: int) -> int:
        """Padded query-batch capacity tier."""
        return next_pow2(m)

    def _prepare_queries(self, world_ids, positions, sender_ids, repls):
        """Quantize + hash + pad one query batch into the device query
        tuple. 21 B/query on the wire (two keys + sender + replication)
        — the raw (world, cube) identity stays on the host. Quantize,
        both hashes AND the capacity-tier padding of all four columns
        run as one fused GIL-releasing native pass when the C++ kernel
        is built (spatial/native_keys.py wql_encode_queries; the
        composed query_keys + pad_to path otherwise, bit-identical)."""
        cap = self._query_cap(len(world_ids))
        arrays = encode_queries(
            world_ids, positions, sender_ids, repls, cap,
            self.cube_size, self._seed,
        )
        if self.device.type != "cuda":
            return tuple(torch.from_numpy(a) for a in arrays)
        # pinned staging, so the four copies enqueue without waiting
        return tuple(
            torch.from_numpy(a).pin_memory().to(self.device,
                                                non_blocking=True)
            for a in arrays
        )

    def _dispatch(self, queries: tuple, segs, ks, kinds):
        """Run the padded query tensors against the device segments:
        the dense [M, sum(ks)] target table."""
        flat = [a for seg in segs for a in seg]
        return _multi_match([*flat, *queries], ks)

    def _dispatch_sparse(self, queries: tuple, segs, ks, kinds, c: int):
        flat = [a for seg in segs for a in seg]
        return compact_sparse(_multi_match([*flat, *queries], ks), c=c)

    def _dispatch_csr(self, queries: tuple, segs, ks, kinds, t_cap: int):
        flat = [a for seg in segs for a in seg]
        return match_run_csr([*flat, *queries], len(segs), t_cap)

    def _csr_effective_cap(self, t_cap: int, queries: tuple, segs) -> int:
        """The slot capacity the CSR dispatch will REALLY run with at a
        requested ``t_cap``. Subclasses raise it (per-shard region
        floors); idempotent. Every caller that records a cap for the
        overflow-sentinel test (collect_local_batch) must record this
        value: if the dispatch's true cap were higher than the recorded
        one, totals between the two would look like overflow and take
        a spurious dense re-resolve every tick."""
        return t_cap

    def match_local_batch(
        self, queries: Sequence[LocalQuery]
    ) -> list[list[uuid_mod.UUID]]:
        return self.collect_local_batch(self.dispatch_local_batch(queries))

    def dispatch_local_batch(self, queries: Sequence[LocalQuery]):
        """Encode + launch a query batch without waiting for results.

        This is the OBJECT-LIST path: it re-walks every LocalQuery in
        Python (interning dict probes, row-by-row position fills) —
        the staged columnar path (:meth:`dispatch_staged_batch`) moves
        that work to message-arrival time and is what the ticker uses
        when staging is on; this path remains for the CPU-compat API,
        immediate mode, and staging-desync fallbacks.

        Runs on the owning (event-loop) thread — it reads the interning
        dicts, which mutate there. The returned handle goes to
        ``collect_local_batch``, which only blocks on the device and may
        safely run on a worker thread (tick batcher overlap).
        """
        m = len(queries)
        if m == 0:
            return (0, None, {})
        world_ids = np.fromiter(
            (self._world_ids.get(q.world, -1) for q in queries),  # wql: allow(per-query-python-loop) — the legacy list-path encode
            dtype=np.int32, count=m,
        )
        positions = np.empty((m, 3), dtype=np.float64)
        for i, q in enumerate(queries):  # wql: allow(per-query-python-loop) — the legacy list-path encode
            positions[i] = (q.position.x, q.position.y, q.position.z)
        sender_ids = np.fromiter(
            (self._peer_ids.get(q.sender, -1) for q in queries),  # wql: allow(per-query-python-loop) — the legacy list-path encode
            dtype=np.int32, count=m,
        )
        repls = np.fromiter(
            (int(q.replication) for q in queries), dtype=np.int8, count=m  # wql: allow(per-query-python-loop) — the legacy list-path encode
        )
        if any(q.kind for q in queries):  # wql: allow(per-query-python-loop) — the legacy list-path encode
            kind_col = np.fromiter(
                (q.kind for q in queries), dtype=np.int8, count=m  # wql: allow(per-query-python-loop) — the legacy list-path encode
            )
            par_col = np.zeros((m, _QUERY_PARAM_LANES), np.float64)
            for i, q in enumerate(queries):  # wql: allow(per-query-python-loop) — the legacy list-path encode
                if q.params:
                    par_col[i, : len(q.params)] = q.params
            self.list_dispatches += 1
            return self._dispatch_kind_batch(
                world_ids, positions, sender_ids, repls,
                kind_col, par_col, staged=False,
            )
        self.list_dispatches += 1
        if self._delta_ticks:
            # object-list dispatches (staging desync, CPU-compat API)
            # bypass the reuse cache: count the fallback so a serving
            # path stuck off staging is visible in the delta stats
            self.delta_fallbacks += 1
            self.last_delta_stats = {
                "batch": m, "reused": 0, "recomputed": m,
                "churn_rows": self._coherence.take_window_marks(),
                "dirty_cubes": len(self._coherence.dirty),
                "fallback": "list_path",
            }
        return self._dispatch_encoded(
            m, world_ids, positions, sender_ids, repls, staged=False,
        )

    def dispatch_staged_batch(
        self, world_ids, positions, sender_ids, repls,
        kinds=None, params=None, fallback=None,
    ):
        """Launch a batch straight from the ticker's staged columnar
        arrays — world/peer interning already happened at enqueue time
        (engine/staging.py), so this is zero per-query Python: one
        fused vectorized encode (native when built) and the launch.
        A batch carrying non-radius ``kinds`` lanes routes through the
        query-library probe expansion first; ``None`` or an all-zero
        kind column is the pure-radius pipeline, byte for byte.
        ``fallback`` is ignored here (see robustness/resilient.py)."""
        m = len(world_ids)
        if m == 0:
            return (0, None, {})
        if kinds is not None and np.any(kinds):
            return self._dispatch_kind_batch(
                world_ids, positions, sender_ids, repls,
                kinds, params, staged=True,
            )
        self.staged_dispatches += 1
        if self._delta_ticks:
            return self._dispatch_delta(
                m, world_ids, positions, sender_ids, repls
            )
        return self._dispatch_encoded(
            m, world_ids, positions, sender_ids, repls, staged=True,
        )

    def _dispatch_kind_batch(
        self, world_ids, positions, sender_ids, repls, kinds, params,
        *, staged: bool,
    ):
        """Kind-dispatched leg of both dispatch paths: expand the mixed
        batch into pure-radius probe rows (queries/expand.py) — the
        stencil kernels pick the candidate cubes per kind on
        ``self.device`` — then send the probes through the NORMAL
        staged pipeline against the same persistent index (same CSR
        delivery, same capacity tiers, and delta-tick reuse at probe
        granularity: probes are content-addressed rows, so a repeated
        cone replays its cached cubes). Collect sees a
        ``("qk", plan, inner)`` handle and folds the per-probe fan-outs
        back into one result per query."""
        from ..queries.expand import expand_staged

        m = len(world_ids)
        t0 = time.perf_counter()
        plan, p_wid, p_pos, p_sid, p_repl = expand_staged(
            world_ids, positions, sender_ids, repls, kinds, params,
            cube_size=self.cube_size,
            device=self.device,
            stencil_max=self.query_stencil_max,
            ray_steps_max=self.query_ray_steps,
        )
        self._span("index.expand", t0)
        self.kind_expansions += 1
        if staged:
            inner = self.dispatch_staged_batch(p_wid, p_pos, p_sid, p_repl)
        else:
            inner = self._dispatch_encoded(
                len(p_wid), p_wid, p_pos, p_sid, p_repl, staged=False,
            )
        return (m, ("qk", plan, inner), inner[2])

    def _dispatch_delta(self, m, world_ids, positions, sender_ids, repls):
        """Temporal-coherence dispatch (delta ticks armed): partition
        the staged batch by the reuse cache — rows whose content
        signature matches a cached entry with a clean cube replay that
        entry's fan-out; only the DIRTY rows enter the device batch,
        at their own (smaller) capacity tier. The handle carries the
        replayed rows and the compute sub-batch; collect merges them
        back in query order and refreshes the cache. The
        ``index.partition`` span holds the signatures, the partition
        and the dirty rows' gather and cache keys."""
        t0 = time.perf_counter()
        co = self._coherence
        h1, h2 = row_signatures(world_ids, positions, sender_ids, repls)
        h1_list = h1.tolist()
        h2_list = h2.tolist()
        reused, dirty_rows = co.partition(h1_list, h2_list)
        n_dirty = len(dirty_rows)
        self.delta_reused += m - n_dirty
        self.delta_recomputed += n_dirty
        self.last_delta_stats = {
            "batch": m,
            "reused": m - n_dirty,
            "recomputed": n_dirty,
            "churn_rows": co.take_window_marks(),
            "dirty_cubes": len(co.dirty),
            "fallback": "",
        }
        seq_now = co.seq
        if n_dirty == 0:
            # every row replayed: no device work at all this tick
            self._span("index.partition", t0)
            self.flush()  # index mutations still owe their device sync
            return (m, ("tc", reused, None, None, (), (), (), seq_now), {
                "encode_ms": 0.0, "h2d_ms": 0.0, "d2h_enqueue_ms": 0.0,
                "compute_ms": 0.0, "d2h_ms": 0.0,
                "path": "reuse", "staged": True, "query_cap": 0,
            })
        if n_dirty == m:
            # cold cache / all-dirty: dispatch the batch unsplit (no
            # gather cost) but still record results for future reuse
            idx = None
            sub = (world_ids, positions, sender_ids, repls)
            dh1, dh2 = h1_list, h2_list
        else:
            idx = np.asarray(dirty_rows, np.intp)
            sub = (world_ids[idx], np.ascontiguousarray(positions[idx]),
                   sender_ids[idx], repls[idx])
            dh1 = [h1_list[i] for i in dirty_rows]
            dh2 = [h2_list[i] for i in dirty_rows]
        dkeys, _ = query_keys(sub[0], sub[1], self.cube_size, self._seed)
        dkeys = dkeys.tolist()
        self._span("index.partition", t0)
        inner = self._dispatch_encoded(
            n_dirty, *sub, staged=True, delta_sub=idx is not None,
        )
        return (m, ("tc", reused, idx, inner, dh1, dh2, dkeys, seq_now),
                inner[2])

    def _collect_delta(self, payload, timing) -> list[list[uuid_mod.UUID]]:
        """Collect half of :meth:`_dispatch_delta`: wait out the dirty
        sub-batch (if any), splice replayed rows back in query order,
        and insert the recomputed fan-outs into the reuse cache under
        the dispatch-time sequence snapshot (the ``index.store`` span).
        Runs on the collect worker thread — cache inserts are single
        dict stores with immutable values (see delta_ticks.py threading
        note)."""
        _, reused, idx, inner, dh1, dh2, dkeys, seq_now = payload
        if inner is None:
            self.last_device_timing = dict(timing)
            return reused
        sub = self.collect_local_batch(inner)
        t0 = time.perf_counter()
        co = self._coherence
        if idx is None:  # all-dirty: sub IS the batch, in order
            out = sub
            for j, targets in enumerate(sub):
                co.store(dh1[j], dh2[j], dkeys[j], seq_now, targets)
        else:
            out = reused
            for j, i in enumerate(idx.tolist()):
                out[i] = sub[j]
                co.store(dh1[j], dh2[j], dkeys[j], seq_now, sub[j])
        self._span("index.store", t0)
        return out

    def _dispatch_encoded(
        self, m, world_ids, positions, sender_ids, repls,
        *, staged: bool, delta_sub: bool = False,
    ):
        """Shared launch tail of both dispatch paths: flush, quantize/
        hash/pad, pick the result layout, launch, enqueue the D2H
        prefetch. Returns the ``(m, payload, timing)`` handle.
        ``delta_sub`` marks a delta-tick dirty partition: it sizes the
        CSR result off (and adapts) the sub-path's own capacity hint
        instead of the full-tick one."""
        self.flush()
        segs, ks, kinds = self._segments()
        if not segs:
            return (m, None, {})
        t0 = time.perf_counter()
        qtuple = self._prepare_queries(
            world_ids, positions, sender_ids, repls
        )
        # host-encode wall: quantize/hash/pad and the H2D enqueue
        encode_ms = (self._span("index.encode", t0) - t0) * 1e3
        # CSR delivery: the result ships ~total ints instead of a dense
        # [M, K] table (K is set by the hottest cube). The capacity
        # hint adapts to the observed fan-out. m * sum(K) is the true
        # fan-out ceiling: once the hint reaches it, CSR saves nothing
        # over dense — and dispatching dense there also guarantees a
        # persistent overflow (e.g. overflow-tier exhaustion at a
        # clamped t_cap) always escapes instead of re-dispatching
        # forever.
        ceiling = next_pow2(m * sum(ks))
        hint = (
            self._delta_delivery_cap if delta_sub else self._delivery_cap
        )
        t_cap = self._csr_effective_cap(next_pow2(max(
            hint,
            # zone-A floor: one identity row per (padded query, segment)
            CSR_ROW * self._query_cap(m) * len(segs) + 64,
        )), qtuple, segs)
        dense = t_cap >= ceiling
        result, host, legs = self._launch(
            qtuple, segs, ks, kinds, csr_cap=None if dense else t_cap)
        # this dispatch's timing legs RIDE THE HANDLE to its own
        # collect — pairing is structural, so an errored/dropped
        # collect can never desync attribution at pipeline depth > 1;
        # ``delta_sub`` rides along so the collect adapts the right
        # capacity hint
        timing = {"encode_ms": encode_ms, **legs,
                  "path": "dense" if dense else "csr", "staged": staged,
                  "delta_sub": delta_sub, "query_cap": self._query_cap(m)}
        if dense:
            return (m, ("dense", host), timing)
        return (m, ("csr", t_cap, result, (qtuple, segs, ks, kinds), host),
                timing)

    def collect_local_batch(self, handle) -> list[list[uuid_mod.UUID]]:
        """Wait for a dispatched batch and decode fan-out UUID lists.
        Safe on a worker thread: peer ids are append-only (index reads
        stay valid), and the overflow fallback re-dispatches the device
        arrays CAPTURED at dispatch time — it never touches host state
        the owning thread could be mutating. Its spans: ``index.wait``
        (the prefetch's event), ``index.fetch`` (what the prefetch did
        not carry), ``index.decode``."""
        m, payload, timing = handle
        if payload is None:
            return [[] for _ in range(m)]
        if payload[0] == "qk":
            # kind-expanded batch: collect the probe fan-outs through
            # whatever path the inner dispatch took (CSR, dense, delta
            # replay), then fold them per original query
            from ..queries.expand import fold_collected

            probes = self.collect_local_batch(payload[2])
            t0 = time.perf_counter()
            out = fold_collected(payload[1], probes)
            self._span("index.fold", t0)
            return out
        if payload[0] == "tc":
            # delta-tick handle: replayed rows + dirty sub-batch; the
            # inner handle (when any) carries its own timing legs
            return self._collect_delta(payload, timing)
        # timing rides the handle: copy before merging so a re-collect
        # of the same handle (drain after a cancelled collect) starts
        # from the dispatch-side legs
        timing = dict(timing)
        delta_sub = bool(timing.get("delta_sub"))
        t0 = time.perf_counter()
        if payload[0] == "dense":
            # collect_local_batch IS the tick's designated sync point:
            # it runs on the worker thread while the loop keeps serving
            # transports, so these converts block nothing but the tick.
            # Dense fetch = one blocking convert: device wait and D2H
            # are indivisible here, so the whole wall lands in
            # compute_ms (tagged by path so readers know)
            tgt = payload[1].get()[0][:m]
            t1 = self._span("index.wait", t0)
            timing.update(compute_ms=(t1 - t0) * 1e3, d2h_ms=0.0)
            self.last_device_timing = timing
            self._note_fetch(int(tgt.size), 0)
            counts, flat = _dense_to_csr(tgt)
            # the hint must keep adapting here too, or a flash-crowd
            # inflation would park every batch on the dense ceiling
            # path forever
            self._adapt_delivery_cap(counts, grow=False, delta_sub=delta_sub)
            return self._decoded(self._decode_csr(counts, flat, m), t1)
        _, t_cap, (counts_dev, flat, _), ctx, host = payload
        fetched = host.get()
        total = int(fetched[-1])
        # the prefetch's event is the tick's designated device-wait
        # point: it fires once the batch and its D2H copies are done,
        # so this wall is the compute leg
        t1 = self._span("index.wait", t0)
        timing["compute_ms"] = (t1 - t0) * 1e3
        if total > t_cap:
            # Rare: the tick's fan-out outgrew the hint — re-resolve
            # dense against the same index snapshot and raise the hint
            # for future ticks. ``total`` is exact unless it is the
            # t_cap+1 layout-overflow sentinel, so convergence is one
            # tick, not log2 doubling steps.
            grown = max(
                t_cap * 2 if total == t_cap + 1
                else next_pow2(2 * total),
                self._delta_delivery_cap if delta_sub
                else self._delivery_cap,
            )
            if delta_sub:
                self._delta_delivery_cap = grown
            else:
                self._delivery_cap = grown
            qtuple, segs, ks, kinds = ctx
            tgt = _to_host(self._dispatch(qtuple, segs, ks, kinds))[:m]
            t2 = self._span("index.fetch", t1)
            timing.update(d2h_ms=(t2 - t1) * 1e3, path="overflow")
            self.last_device_timing = timing
            self._note_fetch(int(tgt.size), 0)
            return self._decoded(self._decode_csr(*_dense_to_csr(tgt), m),
                                 t2)
        # counts stays UNTRIMMED: padding queries resolve 0 rows
        counts = fetched[0]
        self._adapt_delivery_cap(counts, grow=True, delta_sub=delta_sub)
        packed = self._compact_fetch(counts_dev, flat, total, t_cap)
        if packed is None:
            self._note_fetch(t_cap, 0)
            # the prefetch carried the flat result unless the tier was
            # compaction-applicable (then only counts + total went down)
            flat_host = fetched[1] if len(fetched) == 3 else _to_host(flat)
        t2 = self._span("index.fetch", t1)
        timing["d2h_ms"] = (t2 - t1) * 1e3
        self.last_device_timing = timing
        if packed is not None:
            return self._decoded(self._decode_packed(counts, packed, m), t2)
        return self._decoded(self._decode_csr(counts, flat_host, m), t2)

    def _decoded(self, out: list, t0: float) -> list:
        """Ends the ``index.decode`` span begun at ``t0`` and counts the
        recipients the decode made."""
        lanes = sum(map(len, out))
        with self._counts_lock:
            self.lanes_decoded += lanes
        self._span("index.decode", t0)
        return out

    def _compact_applicable(self, t_cap: int) -> bool:
        """Whether a tick at this capacity tier is worth compacting:
        below min_cap the dispatch-time full-flat prefetch overlaps
        the link better than a collect-time pack dispatch could."""
        return self.compact_fetch and t_cap >= self.compact_fetch_min_cap

    def _compact_fetch(self, counts, flat, total: int, t_cap: int):
        """On-device compaction of the zoned CSR flat result: pack the
        lanes the decoder will actually read into a power-of-two bucket
        >= ``total`` and fetch ONLY that, so D2H bytes scale with the
        tick's real fan-out instead of the capacity tier. Returns the
        packed host array, or None when the full-fetch fallback applies
        (compaction disabled, small tick, or the bucket would not save
        at least 2x the bytes). ``counts``/``flat`` are the DEVICE
        arrays; ``total`` the already-fetched raw lane total."""
        bucket = next_pow2(max(total, self.compact_min_bucket))
        if not self._compact_applicable(t_cap) or bucket * 2 > t_cap:
            return None
        packed, _ = self._dispatch_pack(counts, flat, bucket)
        out = _to_host(packed)  # compacted collect point: O(fan-out) bytes
        self._note_fetch(bucket, bucket)
        return out

    def _dispatch_pack(self, counts, flat, bucket: int):
        return pack_csr(counts, flat, bucket=bucket)

    def _note_fetch(self, slots: int, bucket: int) -> None:
        """Record what a collect shipped over the link (``bucket`` 0 =
        full fetch). Worker-thread safe: the dict is replaced
        wholesale, never mutated in place."""
        with self._counts_lock:
            if bucket:
                self.compact_fetches += 1
            else:
                self.full_fetches += 1
            self.fetch_slots += int(slots)
        self.last_collect_stats = {
            "fetch_slots": int(slots),
            "fetch_bytes": int(slots) * 4,
            "compaction_bucket": int(bucket),
        }

    def _decode_packed(self, counts, packed, m: int) -> list[list[uuid_mod.UUID]]:
        """Walk a pack_csr result into per-query UUID lists: lanes for
        (q, s) start at the cumsum of the RAW [M, nseg] counts —
        bit-identical output to :meth:`_decode_csr` over the zoned
        layout (pack_csr emits exactly the lanes that walk reads, in
        the same order)."""
        peer_list = self._peer_list
        mq, nseg = counts.shape
        cnt = counts.reshape(-1).astype(np.int64)
        off = np.cumsum(cnt) - cnt
        out: list[list[uuid_mod.UUID]] = []
        for q in range(min(m, mq)):
            lst: list[uuid_mod.UUID] = []
            for s in range(nseg):
                slot = q * nseg + s
                c = int(cnt[slot])
                if c:
                    a = int(off[slot])
                    lst.extend(
                        peer_list[i] for i in packed[a:a + c] if i >= 0
                    )
            out.append(lst)
        return out

    def _adapt_delivery_cap(self, counts: np.ndarray, *, grow: bool,
                            delta_sub: bool = False) -> None:
        """Track the capacity the observed tick actually needed. Grows
        immediately, decays by halves (one flash-crowd tick must not
        inflate every future tick's D2H). Delta sub-batches adapt
        their OWN hint — a dirty partition's tiny footprint must not
        halve the full-tick hint into an overflow retry."""
        # the footprint is the ZONED layout (match_run_csr) for raw
        # [M, nseg] counts, or plain row padding for the dense
        # fallback's exact [M] counts
        if counts.ndim == 2:
            padded = padded_slots(counts)
        else:
            padded = int(
                ((counts + CSR_ROW - 1) // CSR_ROW).sum()
            ) * CSR_ROW
        needed = next_pow2(max(2 * padded, 64))
        attr = "_delta_delivery_cap" if delta_sub else "_delivery_cap"
        cap = getattr(self, attr)
        if needed >= cap:
            if grow:
                setattr(self, attr, needed)
        else:
            setattr(self, attr, max(needed, cap // 2))

    def _decode_csr(self, counts, flat, m: int) -> list[list[uuid_mod.UUID]]:
        """Walk the CSR layout into per-query UUID lists.

        Two layouts share the walk:
        * ``counts.ndim == 2`` — match_run_csr's ZONED layout: RAW
          [M, nseg] run lengths; each (query, segment)'s first
          up-to-8 lanes sit in its zone-A identity row at
          ``(q * nseg + s) * 8``, remainders past lane 8 in q-major
          seg-minor zone-B regions (CSR_ROW_B-lane rows) after
          ``M * 8 * nseg``. The device left ``-1`` holes for
          filtered lanes.
        * ``counts.ndim == 1`` — exact counts from the dense fallback
          (_dense_to_csr): hole-free, plain ``ceil(c/8)*8`` blocks.
        """
        peer_list = self._peer_list
        out: list[list[uuid_mod.UUID]] = []
        if counts.ndim == 1:
            pos = 0
            for c in counts[:m]:
                out.append([peer_list[i] for i in flat[pos:pos + c]])
                pos += (c + CSR_ROW - 1) // CSR_ROW * CSR_ROW
            return out
        mq, nseg = counts.shape
        base = mq * CSR_ROW * nseg
        pos_b = 0
        for q in range(min(m, mq)):
            lst: list[uuid_mod.UUID] = []
            for s in range(nseg):
                cs = int(counts[q, s])
                if not cs:
                    continue
                at = (q * nseg + s) * CSR_ROW
                lst.extend(
                    peer_list[i]
                    for i in flat[at:at + min(cs, CSR_ROW)]
                    if i >= 0
                )
                if cs > CSR_ROW:
                    r = cs - CSR_ROW
                    at = base + pos_b * CSR_ROW_B
                    lst.extend(
                        peer_list[i] for i in flat[at:at + r] if i >= 0
                    )
                    pos_b += (r + CSR_ROW_B - 1) // CSR_ROW_B
            out.append(lst)
        return out

    # endregion

    # region: point queries (host authority)

    def query_cube(self, world: str, pos: Vector3 | Cube) -> set[uuid_mod.UUID]:
        cube = to_cube(pos, self.cube_size)
        wid = self._world_ids.get(world)
        if wid is None:
            return set()
        key = self._key_of(wid, cube)
        out: set[uuid_mod.UUID] = set()
        try:
            lo, hi = self._base_run(key)
            if lo < hi and (
                self._bw[lo] == wid
                and self._bxyz[lo, 0] == cube[0]
                and self._bxyz[lo, 1] == cube[1]
                and self._bxyz[lo, 2] == cube[2]
            ):
                for pid in self._bp[lo:hi]:
                    if pid >= 0:
                        out.add(self._peer_list[pid])
            drow = self._delta_keyrow.get(key)
            if drow is not None and (
                self._dw[drow] == wid
                and not (self._dxyz[drow] != np.asarray(cube)).any()
            ):
                rows = np.flatnonzero(self._dk[:self._dn] == key)
                for r in rows:
                    pid = self._dp[r]
                    if pid >= 0:
                        out.add(self._peer_list[pid])
        except _CollisionError:  # pragma: no cover — defensive
            pass
        return out

    def query_world(self, world: str) -> set[uuid_mod.UUID]:
        wid = self._world_ids.get(world)
        if wid is None:
            return set()
        return {self._peer_list[pid] for pid in self._world_peers[wid]}

    # endregion

    # region: introspection (tests, metrics)

    def world_names(self) -> list[str]:
        return list(self._world_ids.keys())

    def cube_count(self, world: str) -> int:
        wid = self._world_ids.get(world)
        if wid is None:
            return 0
        live_b = (self._bp >= 0) & (self._bw == wid)
        live_d = (self._dp[:self._dn] >= 0) & (self._dw[:self._dn] == wid)
        return int(np.unique(np.concatenate([
            self._bk[live_b], self._dk[:self._dn][live_d]
        ])).size)

    def subscription_count(self) -> int:
        return self._base_live + self._delta_live

    def export_rows(self):
        """Snapshot export (spatial/snapshot.py): live rows, vectorized
        from the host-authority SoA columns."""
        live_b = self._bp >= 0
        dn = self._dn
        live_d = self._dp[:dn] >= 0
        wid = np.concatenate([
            self._bw[live_b], self._dw[:dn][live_d],
        ]).astype(np.int32)
        cube = np.concatenate([
            self._bxyz[live_b], self._dxyz[:dn][live_d],
        ]).astype(np.int64)
        pid = np.concatenate([
            self._bp[live_b], self._dp[:dn][live_d],
        ]).astype(np.int64)
        return list(self._world_ids), self._peer_list, wid, cube, pid

    def device_stats(self) -> dict:
        return {
            "subscriptions": self.subscription_count(),
            "capacity": (
                (0 if self._base_bundle is None else self._base_bundle["cap"])
                + (0 if self._delta_bundle is None
                   else self._delta_bundle["cap"])
            ),
            "max_fanout_k": self._base_k + (
                self._delta_k if self._delta_bundle is not None else 0
            ),
            "worlds": len(self._world_ids),
            "peers": len(self._peer_list),
            "hash_seed": self._seed,
            "dirty": self._dirty,
            "base_rows": int(self._bk.size),
            "base_dead": self._base_dead,
            "delta_rows": self._dn,
            "delta_live": self._delta_live,
            "compactions": self.compactions,
            "compaction_failures": self.compaction_failures,
            "compaction_in_flight": self._compaction is not None,
            "compact_fetches": self.compact_fetches,
            "full_fetches": self.full_fetches,
            "fetch_slots": self.fetch_slots,
            "lanes_decoded": self.lanes_decoded,
            "staged_dispatches": self.staged_dispatches,
            "list_dispatches": self.list_dispatches,
            "kind_expansions": self.kind_expansions,
            "last_fetch_bytes": self.last_collect_stats["fetch_bytes"],
            "last_compaction_bucket":
                self.last_collect_stats["compaction_bucket"],
            "delta_ticks": self._delta_ticks,
            "delta_reused": self.delta_reused,
            "delta_recomputed": self.delta_recomputed,
            "delta_fallbacks": self.delta_fallbacks,
            "delta_sync_scatters": self.delta_sync_scatters,
            "delta_sync_sorts": self.delta_sync_sorts,
            "delta_cache_entries": len(self._coherence.cache),
            "delta_cache_resets": self._coherence.cache_resets,
        }

    # endregion


# --------------------------------------------------------------------
# Host helpers
# --------------------------------------------------------------------


def _sort_segment(keys, wids, xyz, pids):
    """Stable key-sort of a row set → contiguous cube runs."""
    order = np.argsort(keys, kind="stable")
    return (
        np.ascontiguousarray(keys[order]),
        np.ascontiguousarray(wids[order].astype(np.int32, copy=False)),
        np.ascontiguousarray(xyz[order]),
        np.ascontiguousarray(pids[order].astype(np.int32, copy=False)),
    )


def _dense_to_csr(tgt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized compaction of a dense [M, K] host table to the
    row-padded CSR layout (_decode_csr's contract) — touches only the
    real hits, not M*K cells."""
    mask = tgt >= 0
    counts = mask.sum(axis=1).astype(np.int32)
    prows = (counts + CSR_ROW - 1) // CSR_ROW
    starts = (np.cumsum(prows) - prows) * CSR_ROW
    flat = np.full(int(prows.sum()) * CSR_ROW, -1, np.int32)
    rows = np.nonzero(mask)[0]
    within = (np.cumsum(mask, axis=1) - 1)[mask]
    flat[starts[rows] + within] = tgt[mask]
    return counts, flat


def run_remainders_np(sorted_keys: np.ndarray) -> np.ndarray:
    """Host twin of :func:`run_remainders` (same [S] i32 contract)."""
    s = sorted_keys.size
    if s == 0:
        return np.empty(0, np.int32)
    idx = np.arange(s, dtype=np.int32)
    last = np.empty(s, bool)
    last[:-1] = sorted_keys[1:] != sorted_keys[:-1]
    last[-1] = True
    ends = np.minimum.accumulate(
        np.where(last, idx, np.int32(s - 1))[::-1]
    )[::-1]
    return (ends + 1 - idx).astype(np.int32)


def _max_run(sorted_keys: np.ndarray) -> int:
    """Longest equal-key run in a sorted key array (max cube occupancy
    → the gather degree K)."""
    n = sorted_keys.size
    if n == 0:
        return 1
    starts = np.flatnonzero(np.diff(sorted_keys) != 0) + 1
    bounds = np.concatenate([[0], starts, [n]])
    return int(np.diff(bounds).max())
