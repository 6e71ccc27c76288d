"""Boot-time tier walk for the device fan-out engine.

Port of the JAX package's ``spatial/precompile.py``. There the walk
traces every reachable jit shape before serving; torch compiles
nothing, but the first launch at a new shape still pays for it — the
caching allocator grows its pools, and the sort and scan ops size their
workspaces. So the port keeps the same walk over the same power-of-two
tiers: every query-cap tier up to ``max_batch``, the CSR slot-capacity
ladder each can request (zone-A floor upward, below the dense ceiling),
and the pack-bucket tiers of the on-device result compaction, each
dispatched once against the backend's real device segments (dummy
queries that match nothing; results discarded) and synchronized, so
the boot ends with the pools warm.

The query-library leg runs the kind stencil kernels (K10, K11) over
the kind-row tier ladder × the reachable stencil radii on the index's
device; it needs no index, so an empty-index boot still walks it.

The stats keys are the JAX ones, so the ``precompile`` gauge reads the
same: ``new_variants`` and ``families`` count jit compiles there and
are 0 and ``{}`` here.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .hashing import next_pow2

logger = logging.getLogger(__name__)

#: zone-A identity-row width (ops/index.CSR_ROW)
_CSR_ROW = 8


def query_cap_ladder(backend, max_batch: int, min_batch: int | None):
    """Descending, deduped query-capacity tiers the ticker can reach:
    ``next_pow2(m)`` for every batch size up to ``max_batch`` collapses
    to a halving ladder; ``min_batch`` floors it."""
    if min_batch is None:
        min_batch = max(64, max_batch // 8)
    ms, m = [], max(1, int(max_batch))
    while m >= min_batch:
        ms.append(m)
        m //= 2
    if not ms:
        ms.append(max(1, int(max_batch)))
    seen, out = set(), []
    for m in ms:
        cap = backend._query_cap(m)
        if cap not in seen:
            seen.add(cap)
            out.append((m, cap))
    return out


def _sync(backend) -> None:
    if backend.device.type == "cuda":
        torch.cuda.synchronize(backend.device)


#: kernel calls the query-library leg may make (its own small budget:
#: the kernels are elementwise masks and one row sort)
MAX_KIND_CALLS = 96


def _precompile_kind_tiers(backend, max_batch: int) -> dict:
    """Query-library leg of the boot walk: run every REGISTERED kind's
    stencil kernel (queries/geometry.py, queries/knn.py) over the
    kind-row tier ladder × the reachable stencil radii, largest first.
    The row wrappers pad to pow2 tiers (geometry.KIND_ROW_FLOOR), so
    this ladder is exactly the shape set serving can hit."""
    from ..queries.geometry import KIND_ROW_FLOOR, precompile_kind_kernels

    calls = skipped = 0
    tier = next_pow2(max(1, int(max_batch)), floor=KIND_ROW_FLOOR)
    while tier >= KIND_ROW_FLOOR:
        for radius in range(1, backend.query_stencil_max + 1):
            if calls >= MAX_KIND_CALLS:
                skipped += 1
                continue
            calls += precompile_kind_kernels(
                tier, radius, backend.cube_size, device=backend.device)
        tier //= 2
    _sync(backend)
    return {"kind_dispatches": calls, "kind_skipped_by_budget": skipped}


#: CSR slot-capacity doublings walked above each query tier's zone-A
#: floor (the adaptive delivery cap climbs that ladder at runtime)
T_TIERS = 4
#: cap on the shapes walked, largest first
MAX_DISPATCHES = 64


def precompile_tiers(backend, *, max_batch: int) -> dict:
    """Dispatch every reachable hot-path shape once before serving.
    Returns a stats dict."""
    t0 = time.perf_counter()
    # delta ticks dispatch the DIRTY fraction of each batch at its own
    # (small) query tier — then the walk goes all the way down
    min_batch = 8 if backend._delta_ticks else None
    backend.flush()
    segs, ks, kinds = backend._segments()
    empty = {"new_variants": 0, "families": {}}
    if not segs:
        logger.info(
            "tier walk skipped: empty index (no device segments)"
        )
        # the kind stencil kernels take parameter shapes only — no
        # index needed, so an empty-index boot still warms them
        return {"skipped": "empty-index", "dispatches": 0,
                "pack_calls": 0, "wall_ms": 0.0, **empty,
                **_precompile_kind_tiers(backend, max_batch)}

    nseg = len(segs)
    base_cap = backend._delivery_cap
    min_bucket = backend.compact_min_bucket
    dispatches = pack_calls = skipped = 0
    budget = MAX_DISPATCHES
    #: dense [M, K] tables above this many lanes are a memory hazard to
    #: build speculatively — serving only reaches them through the rare
    #: overflow re-resolve
    dense_lane_budget = 1 << 24

    for m, qcap in query_cap_ladder(backend, max_batch, min_batch):
        if dispatches + pack_calls >= budget:
            skipped += 1
            continue
        qtuple = backend._prepare_queries(
            np.full(m, -1, np.int32),
            np.zeros((m, 3), np.float64),
            np.full(m, -1, np.int32),
            np.zeros(m, np.int8),
        )
        ceiling = next_pow2(m * sum(ks))
        zone_floor = next_pow2(_CSR_ROW * qcap * nseg + 64)
        current = next_pow2(max(base_cap, zone_floor))
        if qcap * sum(ks) <= dense_lane_budget:
            backend._dispatch(qtuple, segs, ks, kinds)
            _sync(backend)
            dispatches += 1
        top = max(current, zone_floor) << (T_TIERS - 1)
        seen_caps: set[int] = set()
        t_cap = zone_floor
        while t_cap < ceiling and t_cap <= top:
            # the cap the dispatch really runs with (a mesh raises it
            # to its per-row region floor), each walked once
            cap = backend._csr_effective_cap(t_cap, qtuple, segs)
            t_cap *= 2
            if cap in seen_caps:
                continue
            seen_caps.add(cap)
            if dispatches + pack_calls >= budget:
                skipped += 1
                break
            result = backend._dispatch_csr(qtuple, segs, ks, kinds, cap)
            int(result[2])  # synchronize: the boot ends warm
            dispatches += 1
            bucket = min_bucket
            while bucket * 2 <= cap:
                if dispatches + pack_calls >= budget:
                    skipped += 1
                    break
                backend._compact_fetch(result[0], result[1], bucket, cap)
                pack_calls += 1
                bucket *= 2

    kind_stats = _precompile_kind_tiers(backend, max_batch)
    stats = {
        "dispatches": dispatches,
        "pack_calls": pack_calls,
        "skipped_by_budget": skipped,
        "wall_ms": round((time.perf_counter() - t0) * 1e3, 1),
        **empty,
        **kind_stats,
    }
    logger.info(
        "tier walk: %d dispatch + %d pack shapes in %.0f ms%s",
        dispatches, pack_calls, stats["wall_ms"],
        f" ({skipped} skipped by budget)" if skipped else "",
    )
    return stats
