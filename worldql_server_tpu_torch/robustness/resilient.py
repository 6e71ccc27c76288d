"""Degraded-mode spatial backend: contain, rebuild, fail over.

Port of the JAX package's ``robustness/resilient.py``, copied as it is
(it imports no JAX); on the port it wraps ``CudaSpatialBackend``.

Fixed-shape device kernels are all-or-nothing: a failed collect yields
NO partial results, and a device backend whose internal mirror desyncs
can poison every later tick. So the accelerated backend gets a
crash-containment wrapper with three escalating responses:

1. **Contain** — a failed dispatch/collect resolves that batch through
   the CPU mirror instead, so fan-out continues (degraded) rather than
   dropping the tick.
2. **Rebuild** — after each contained failure (below the failover
   threshold) the inner backend is rebuilt from scratch out of the
   authoritative mirror via the normal bulk-load path — the same
   discipline as snapshot restore, so the rebuilt index is
   indistinguishable from one built by live traffic.
3. **Fail over** — ``failover_after`` CONSECUTIVE failures flip the
   wrapper to the CPU mirror permanently (process lifetime): metric
   (``resilience.failovers``), CRITICAL log, and a ``degraded`` flag
   on ``/healthz``. A 20 Hz tick served at CPU speed beats a dead
   server; the orchestrator decides when to restart onto healthy
   hardware. On a card this is also the path out of a sticky CUDA
   error (a device-side assert or an illegal address poisons the
   context, so a rebuild on the same device fails too): the failed
   rebuild is logged and kept, and the failures count on to the
   failover.

The mirror is a :class:`CpuSpatialBackend` fed every mutation before
the inner backend sees it — authoritative by construction, and exactly
the engine queries fail over TO, so there is no translation step at
the worst possible moment. Mutation cost is a couple of dict ops per
subscription change, amortized noise next to the device work this
wrapper protects.

Thread note: ``collect_local_batch`` runs on the ticker's worker
thread. The mirror fallback there reads dicts the event loop may be
mutating; a torn iteration raises ``RuntimeError``, which the fallback
retries and then degrades to an empty fan-out for that batch — still
contained, never propagated.
"""

from __future__ import annotations

import logging
import uuid as uuid_mod
from typing import Callable, Sequence

from ..protocol.types import Vector3
from ..spatial.backend import Cube, LocalQuery, SpatialBackend
from ..spatial.cpu_backend import CpuSpatialBackend
from . import failpoints

logger = logging.getLogger(__name__)


def _fallback_queries(fallback) -> list[LocalQuery] | None:
    """Normalize a re-resolve source to LocalQuery objects: the list
    path stores the queries themselves, the staged path the ticker's
    retained ``(message, query)`` pairs. None when there is nothing to
    re-resolve from."""
    if fallback is None:
        return None
    return [
        pair[1] if isinstance(pair, tuple) else pair for pair in fallback
    ]


class _Resolved:
    """Dispatch handle for a batch already resolved by the mirror."""

    __slots__ = ("targets",)

    def __init__(self, targets):
        self.targets = targets


class _Inflight:
    """Dispatch handle wrapping the inner backend's own handle plus
    the queries needed to re-resolve through the mirror on failure."""

    __slots__ = ("handle", "queries")

    def __init__(self, handle, queries):
        self.handle = handle
        self.queries = queries


class ResilientBackend(SpatialBackend):
    def __init__(
        self,
        inner: SpatialBackend,
        *,
        factory: Callable[[], SpatialBackend] | None = None,
        failover_after: int = 3,
        metrics=None,
    ):
        super().__init__(inner.cube_size)
        self.inner = inner
        self._factory = factory
        self.mirror = CpuSpatialBackend(inner.cube_size)
        self.failover_after = max(1, int(failover_after))
        self.metrics = metrics
        self.failures = 0        # consecutive (reset by a healthy collect)
        self.total_failures = 0
        self.rebuilds = 0
        self.degraded_batches = 0
        self.failed_over = False
        #: invoked BEFORE every rebuild/failover restore: dependents
        #: holding device state derived from the inner backend (the
        #: entity plane's twin + dirty bitmap) must invalidate it —
        #: a rebuild mid-sim-tick would otherwise scatter dirty rows
        #: onto a twin the restore just made stale. The server wires
        #: EntityPlane.abort_tick here.
        self.on_rebuild: Callable[[], None] | None = None

    # region: failure machinery

    def _note_failure(self, stage: str) -> None:
        """Record one inner-backend failure (called from an except
        block). Escalates: rebuild below the threshold, fail over at
        it."""
        self.failures += 1
        self.total_failures += 1
        if self.metrics is not None:
            self.metrics.inc("resilience.failures")
            self.metrics.inc(f"resilience.failures.{stage}")
        logger.exception(
            "spatial backend %s failed (consecutive failure %d/%d) — "
            "resolved through the CPU mirror",
            stage, self.failures, self.failover_after,
        )
        if self.failed_over:
            return
        if self.failures >= self.failover_after:
            self._failover(stage)
        else:
            self._rebuild()

    def _notify_rebuild(self) -> None:
        """Tell dependents the inner backend (and anything derived
        from it) is about to be replaced. Must never block the
        containment path — a raising hook is logged and dropped.
        May fire from the collect worker thread (collect failures):
        the wired hook (abort_tick) is idempotent flag-flipping."""
        if self.on_rebuild is None:
            return
        try:
            self.on_rebuild()
        except Exception:
            logger.exception("on_rebuild hook failed — continuing")

    def _failover(self, stage: str) -> None:
        self._notify_rebuild()
        self.failed_over = True
        if self.metrics is not None:
            self.metrics.inc("resilience.failovers")
        logger.critical(
            "spatial backend failed %d consecutive times (last: %s) — "
            "FAILING OVER to the CPU mirror; the device backend is "
            "abandoned for the rest of this process (see /healthz)",
            self.failures, stage,
        )

    def _rebuild(self) -> None:
        """Reconstruct the inner backend from the authoritative mirror
        through the normal bulk-load path (same as snapshot restore).
        Without a factory the broken instance is kept and the next
        failure escalates toward failover."""
        if self._factory is None:
            return
        # invalidate dependent device state BEFORE the restore: an
        # in-flight sim tick's writeback/scatter must not land on a
        # twin whose backing index this rebuild is replacing
        self._notify_rebuild()
        try:
            fresh = self._factory()
            worlds, peers, wid, cube, pid = self.mirror.export_rows()
            for wid_i, world in enumerate(worlds):
                sel = wid == wid_i
                if sel.any():
                    fresh.bulk_add_subscriptions(
                        world, [peers[i] for i in pid[sel]], cube[sel]
                    )
            fresh.flush()
            self.inner = fresh
            self.rebuilds += 1
            if self.metrics is not None:
                self.metrics.inc("resilience.rebuilds")
            logger.warning(
                "spatial backend rebuilt from the authoritative mirror "
                "(%d rows, rebuild #%d)", len(pid), self.rebuilds,
            )
        except Exception:
            logger.exception(
                "spatial backend rebuild failed — keeping the broken "
                "instance; further failures will fail over to CPU"
            )

    def _mirror_match(
        self, queries: Sequence[LocalQuery]
    ) -> list[list[uuid_mod.UUID]]:
        """Mirror-resolve a batch, tolerating the worker-thread/-loop
        race documented in the module docstring."""
        for _ in range(3):
            try:
                return self.mirror.match_local_batch(queries)
            except RuntimeError:
                continue  # torn dict/set iteration under mutation
        return [[] for _ in queries]

    def status(self) -> dict:
        """State for /healthz and the ``resilience`` gauge."""
        return {
            "degraded": self.failed_over,
            "failed_over": self.failed_over,
            "consecutive_failures": self.failures,
            "failures": self.total_failures,
            "rebuilds": self.rebuilds,
            "degraded_batches": self.degraded_batches,
            "inner": type(self.inner).__name__,
        }

    # endregion

    # region: mutations (mirror first — it is the authority)

    def add_subscription(
        self, world: str, peer: uuid_mod.UUID, pos: Vector3 | Cube
    ) -> bool:
        out = self.mirror.add_subscription(world, peer, pos)
        if not self.failed_over:
            try:
                self.inner.add_subscription(world, peer, pos)
            except Exception:
                self._note_failure("mutate")
        return out

    def remove_subscription(
        self, world: str, peer: uuid_mod.UUID, pos: Vector3 | Cube
    ) -> bool:
        out = self.mirror.remove_subscription(world, peer, pos)
        if not self.failed_over:
            try:
                self.inner.remove_subscription(world, peer, pos)
            except Exception:
                self._note_failure("mutate")
        return out

    def remove_peer(self, peer: uuid_mod.UUID) -> bool:
        out = self.mirror.remove_peer(peer)
        if not self.failed_over:
            try:
                self.inner.remove_peer(peer)
            except Exception:
                self._note_failure("mutate")
        return out

    def bulk_add_subscriptions(self, world, peers, cubes) -> int:
        out = self.mirror.bulk_add_subscriptions(world, peers, cubes)
        if not self.failed_over:
            try:
                self.inner.bulk_add_subscriptions(world, peers, cubes)
            except Exception:
                self._note_failure("mutate")
        return out

    def bulk_remove_subscriptions(self, world, peers, cubes) -> int:
        """Explicit override: without it the call would fall through
        ``__getattr__`` straight to the inner backend, silently
        bypassing the mirror — a later rebuild would resurrect the
        removed rows. The CPU mirror has no bulk remove; per-row
        removal is its reference path anyway."""
        out = 0
        for peer, cube in zip(peers, cubes):
            if self.mirror.remove_subscription(
                world, peer, tuple(int(c) for c in cube)
            ):
                out += 1
        if not self.failed_over:
            try:
                self.inner.bulk_remove_subscriptions(world, peers, cubes)
            except Exception:
                self._note_failure("mutate")
        return out

    def bulk_move_subscriptions(
        self, world, rem_peers, rem_cubes, add_peers, add_cubes,
    ) -> tuple[int, int]:
        """Moving-object churn (entities/plane.py) with the mirror
        kept authoritative on both sides of the move."""
        removed = self.bulk_remove_subscriptions(world, rem_peers, rem_cubes)
        added = self.bulk_add_subscriptions(world, add_peers, add_cubes)
        return removed, added

    def flush(self) -> None:
        if not self.failed_over:
            try:
                self.inner.flush()
            except Exception:
                self._note_failure("flush")

    # endregion

    # region: queries

    def query_cube(self, world: str, pos) -> set[uuid_mod.UUID]:
        if not self.failed_over:
            try:
                return self.inner.query_cube(world, pos)
            except Exception:
                self._note_failure("query")
        return self.mirror.query_cube(world, pos)

    def query_world(self, world: str) -> set[uuid_mod.UUID]:
        if not self.failed_over:
            try:
                return self.inner.query_world(world)
            except Exception:
                self._note_failure("query")
        return self.mirror.query_world(world)

    def match_local_batch(
        self, queries: Sequence[LocalQuery]
    ) -> list[list[uuid_mod.UUID]]:
        if not self.failed_over:
            try:
                return self.inner.match_local_batch(queries)
            except Exception:
                self._note_failure("match")
                self.degraded_batches += 1
        return self._mirror_match(queries)

    # endregion

    # region: two-phase tick batch

    def dispatch_local_batch(self, queries: Sequence[LocalQuery]):
        if not self.failed_over:
            try:
                failpoints.fire("backend.dispatch")
                return _Inflight(
                    self.inner.dispatch_local_batch(queries), list(queries)
                )
            except Exception:
                self._note_failure("dispatch")
                self.degraded_batches += 1
        return _Resolved(self._mirror_match(queries))

    # region: staged columnar dispatch (engine/staging.py)

    def supports_staged_dispatch(self) -> bool:
        # even failed-over: the staged call degrades through the
        # fallback pairs below, so the ticker need not re-probe
        return self.inner.supports_staged_dispatch()

    def interning_maps(self):
        return self.inner.interning_maps()

    def staging_epoch(self) -> int:
        """Rebuilds replace ``inner`` (and its interning dicts)
        wholesale — ids staged before the swap are meaningless after
        it. Folding the rebuild/failover counters into the epoch makes
        the ticker fall back to the object-list path for exactly the
        windows that straddle a swap."""
        return (
            self.inner.staging_epoch()
            + 2 * self.rebuilds
            + int(self.failed_over)
        )

    def dispatch_staged_batch(
        self, world_ids, positions, sender_ids, repls,
        kinds=None, params=None, fallback=None,
    ):
        """Staged dispatch with the same containment as the list path.
        The mirror fallback needs LocalQuery objects — the staged
        columns carry interned ids that die with a failed inner
        backend — so the ticker's retained ``(message, query)`` pairs
        (``fallback``) are the re-resolve source; extracting them is
        O(m) Python paid ONLY on the failure path. The query-library
        ``kinds``/``params`` lanes pass straight through: on the
        degraded path the fallback LocalQuery rows still carry their
        kind, so the mirror answers them through the CPU oracles
        (``SpatialBackend.match_local_batch``) with identical
        semantics."""
        if not self.failed_over:
            try:
                failpoints.fire("backend.dispatch")
                return _Inflight(
                    self.inner.dispatch_staged_batch(
                        world_ids, positions, sender_ids, repls,
                        kinds, params,
                    ),
                    fallback,
                )
            except Exception:
                self._note_failure("dispatch")
                self.degraded_batches += 1
        queries = _fallback_queries(fallback)
        if queries is None:
            # no fallback pairs: still contained — an empty fan-out
            # per query beats a propagated dispatch error
            return _Resolved([[] for _ in range(len(world_ids))])
        return _Resolved(self._mirror_match(queries))

    # endregion

    def collect_local_batch(self, handle) -> list[list[uuid_mod.UUID]]:
        if isinstance(handle, _Resolved):
            return handle.targets
        try:
            failpoints.fire("backend.collect")
            out = self.inner.collect_local_batch(handle.handle)
        except Exception:
            self._note_failure("collect")
            self.degraded_batches += 1
            return self._mirror_match(_fallback_queries(handle.queries) or [])
        self.failures = 0  # a full dispatch→collect proves health
        return out

    # endregion

    # region: introspection (the mirror is the authority)

    def export_rows(self):
        return self.mirror.export_rows()

    def subscription_count(self) -> int:
        return self.mirror.subscription_count()

    def world_names(self) -> list[str]:
        return self.mirror.world_names()

    def cube_count(self, world: str) -> int:
        return self.mirror.cube_count(world)

    def __getattr__(self, name: str):
        # anything else (device_stats, wait_compaction, match_arrays…)
        # passes through to the inner backend
        inner = self.__dict__.get("inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

    # endregion
