"""The fan-out path's spans and counters in ``CudaSpatialBackend``
(``device="cpu"``): ``index.*`` spans at each boundary of dispatch and
collect, nested under the ticker's ``tick.dispatch`` / ``tick.collect``
through the span context var (copied to the collect worker as
``asyncio.to_thread`` copies it), once each per batch; the
``fetch_slots`` / ``lanes_decoded`` counters; and the device-timing legs
read from the spans' own clock reads, written by the collect alone."""

from __future__ import annotations

import asyncio
import threading
import uuid
from collections import Counter

import numpy as np
import pytest

from worldql_server_tpu_torch.observability import spans as spans_mod
from worldql_server_tpu_torch.observability.spans import Tracer
from worldql_server_tpu_torch.spatial.cuda_backend import CudaSpatialBackend
from worldql_server_tpu_torch.spatial.quantize import cube_coords_batch
from worldql_server_tpu_torch.tools.index_bench import mixed_cols

CUBE = 16
DISPATCH = ("index.encode", "index.launch")
COLLECT = ("index.wait", "index.fetch", "index.decode")


def _backend(delta_ticks="off", n=400, seed=3):
    """An index whose hottest cube holds a third of the crowd, so a
    batch's CSR tier stays under its dense ceiling."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-5, 5, (30, 3)) * CUBE + CUBE / 2
    pick = rng.integers(0, 30, n)
    pick[: n // 3] = 0
    pos = centers[pick] + rng.uniform(-7, 7, (n, 3))
    b = CudaSpatialBackend(CUBE, device="cpu")
    b.configure_delta_ticks(delta_ticks)
    b.bulk_add_subscriptions(
        "w0", [uuid.UUID(int=i + 1) for i in range(n)],
        cube_coords_batch(pos, CUBE))
    b.flush()
    b.wait_compaction()
    return b, centers


def _batch(rng, centers, m=128):
    pos = centers[rng.integers(0, len(centers), m)] \
        + rng.uniform(-7, 7, (m, 3))
    return (np.zeros(m, np.int32), pos,
            rng.integers(-1, 400, m).astype(np.int32),
            rng.integers(0, 3, m).astype(np.int8))


def _tick(backend, cols, tracer):
    """One tick as the ticker runs it: dispatch on this thread inside
    ``tick.dispatch``, collect on a worker inside ``tick.collect`` via
    ``asyncio.to_thread``. Returns the answers, the trace and the
    worker's native id."""
    seen = {}

    def collect(handle):
        seen["tid"] = threading.get_native_id()
        return backend.collect_local_batch(handle)

    async def run():
        trace = tracer.begin("tick")
        with trace.span("tick.dispatch"):
            handle = backend.dispatch_staged_batch(*cols)
        with trace.span("tick.collect"):
            out = await asyncio.to_thread(collect, handle)
        trace.finish()
        return out, trace

    out, trace = asyncio.run(run())
    return out, trace, seen["tid"]


def _sink():
    got = []
    return Tracer(enabled=True, on_trace=got.append), got


def test_staged_tick_spans_nest_under_the_tickers_spans():
    b, centers = _backend()
    tracer, got = _sink()
    b.tracer = tracer
    out, trace, worker = _tick(b, _batch(np.random.default_rng(1), centers),
                               tracer)
    assert got == [trace]  # no loose traces beside the tick's
    names = Counter(s.name for s in trace.spans)
    assert names == Counter(
        ["tick.dispatch", "tick.collect", *DISPATCH, *COLLECT])
    by_name = {s.name: s for s in trace.spans}
    for name in DISPATCH:
        assert by_name[name].parent == by_name["tick.dispatch"].id
        assert by_name[name].tid == threading.get_native_id()
    for name in COLLECT:
        assert by_name[name].parent == by_name["tick.collect"].id
        assert by_name[name].tid == worker != threading.get_native_id()
    # the collect's spans tile it in order: wait, fetch, decode
    t = [by_name[n] for n in COLLECT]
    for a, c in zip(t, t[1:]):
        assert c.t0 == pytest.approx(a.t0 + a.dur_ms / 1e3, abs=1e-9)
    assert sum(map(len, out)) > 0


def test_delta_reuse_tick_and_kind_batch_spans():
    b, centers = _backend("on")
    tracer, _ = _sink()
    b.tracer = tracer
    rng = np.random.default_rng(2)
    first = _batch(rng, centers)
    _, cold, _ = _tick(b, first, tracer)
    assert Counter(s.name for s in cold.spans if s.name.startswith(
        "index.")) == Counter(["index.partition", "index.store", *DISPATCH,
                               *COLLECT])
    # half the rows repeat the cached ones: partition, a dirty
    # sub-batch, and the store of its rows only
    fresh = _batch(rng, centers)
    mixed = tuple(np.concatenate([a[:64], c[64:]])
                  for a, c in zip(first, fresh))
    _, warm, _ = _tick(b, mixed, tracer)
    assert 0 < b.last_delta_stats["reused"] < 128
    names = Counter(s.name for s in warm.spans)
    assert names["index.partition"] == names["index.store"] == 1
    assert all(n == 1 for n in names.values())
    # every row repeated: the partition alone, no device work
    _, reuse, _ = _tick(b, mixed, tracer)
    assert b.last_delta_stats["reused"] == 128
    assert [s.name for s in reuse.spans if s.name.startswith("index.")] \
        == ["index.partition"]

    kinds, params = mixed_cols(rng, 40)
    q = _batch(rng, centers, 40)
    kb, _ = _backend()
    kb.tracer = tracer
    trace = tracer.begin("tick")
    with trace.span("tick.dispatch"):
        handle = kb.dispatch_staged_batch(*q, kinds, params)
    with trace.span("tick.collect"):
        kb.collect_local_batch(handle)
    trace.finish()
    names = Counter(s.name for s in trace.spans)
    assert names["index.expand"] == names["index.fold"] == 1
    assert all(n == 1 for n in names.values()), names


def test_disabled_tracer_makes_no_trace_or_span(monkeypatch):
    made = Counter()

    class CountingTrace(spans_mod.Trace):
        def __init__(self, *a, **k):
            made["trace"] += 1
            super().__init__(*a, **k)

    class CountingSpan(spans_mod.Span):
        def __init__(self, *a, **k):
            made["span"] += 1
            super().__init__(*a, **k)

    monkeypatch.setattr(spans_mod, "Trace", CountingTrace)
    monkeypatch.setattr(spans_mod, "Span", CountingSpan)
    rng = np.random.default_rng(4)
    b_off, centers = _backend("on")
    b_on, _ = _backend("on")
    b_on.tracer = Tracer(enabled=True)
    for _ in range(3):
        cols = _batch(rng, centers)
        mark = Counter(made)
        off = b_off.collect_local_batch(b_off.dispatch_staged_batch(*cols))
        assert made == mark
        on = b_on.collect_local_batch(b_on.dispatch_staged_batch(*cols))
        assert off == on
    assert made["span"] > 0  # the enabled twin did record


def test_collect_counters_advance_by_the_ticks_values():
    rng = np.random.default_rng(5)
    b, centers = _backend()
    cols = _batch(rng, centers)
    before = b.device_stats()
    handle = b.dispatch_staged_batch(*cols)
    assert handle[1][0] == "csr"
    out = b.collect_local_batch(handle)
    after = b.device_stats()
    # a full fetch ships the whole capacity tier
    assert after["fetch_slots"] - before["fetch_slots"] == handle[1][1]
    assert after["lanes_decoded"] - before["lanes_decoded"] \
        == sum(map(len, out)) > 0

    # packed: the bucket
    b.compact_fetch_min_cap = 0
    b.compact_min_bucket = 8
    before = b.device_stats()
    out = b.collect_local_batch(b.dispatch_staged_batch(*cols))
    after = b.device_stats()
    assert after["compact_fetches"] == before["compact_fetches"] + 1
    bucket = b.last_collect_stats["compaction_bucket"]
    assert after["fetch_slots"] - before["fetch_slots"] == bucket > 0
    assert after["lanes_decoded"] - before["lanes_decoded"] \
        == sum(map(len, out))

    # dense: M x K
    b._delivery_cap = 1 << 30
    before = b.device_stats()
    handle = b.dispatch_staged_batch(*cols)
    assert handle[1][0] == "dense"
    out = b.collect_local_batch(handle)
    after = b.device_stats()
    k = sum(b._segments()[1])
    assert after["fetch_slots"] - before["fetch_slots"] == len(out) * k
    assert after["lanes_decoded"] - before["lanes_decoded"] \
        == sum(map(len, out))


def test_device_timing_is_the_collects_and_reads_the_spans():
    rng = np.random.default_rng(6)
    b, centers = _backend("on")
    tracer, _ = _sink()
    b.tracer = tracer
    cols = _batch(rng, centers)
    for path in ("csr", "reuse"):
        mark = b.last_device_timing
        trace = tracer.begin("tick")
        with trace.span("tick.dispatch"):
            handle = b.dispatch_staged_batch(*cols)
        assert b.last_device_timing is mark  # the dispatch wrote nothing
        writers = []

        def collect():
            writers.append(threading.get_native_id())
            with trace.span("tick.collect"):
                b.collect_local_batch(handle)

        t = threading.Thread(target=collect)
        t.start()
        t.join(30)
        assert not t.is_alive() and writers
        trace.finish()
        timing = b.last_device_timing
        assert timing is not mark and timing["path"] == path
    # a CSR tick's legs are its spans' walls
    trace = tracer.begin("tick")
    with trace.span("tick.dispatch"):
        handle = b.dispatch_staged_batch(*_batch(rng, centers))
    with trace.span("tick.collect"):
        b.collect_local_batch(handle)
    trace.finish()
    csr = b.last_device_timing
    assert csr["path"] == "csr"
    dur = {s.name: s.dur_ms for s in trace.spans}
    assert csr["encode_ms"] == dur["index.encode"]
    assert csr["h2d_ms"] + csr["d2h_enqueue_ms"] == pytest.approx(
        dur["index.launch"], rel=1e-9, abs=1e-9)
    assert csr["compute_ms"] == dur["index.wait"]
    assert csr["d2h_ms"] == dur["index.fetch"]
    assert not hasattr(b, "last_dispatch_tier")


def test_server_hands_its_tracer_to_the_index():
    from worldql_server_tpu_torch.engine.config import Config
    from worldql_server_tpu_torch.engine.server import WorldQLServer

    for resilience in ("off", "on"):
        config = Config(store_url="memory://", ws_enabled=False,
                        spatial_backend="cuda", trace=True,
                        resilience=resilience)
        server = WorldQLServer(config, device="cpu")
        index = getattr(server.backend, "inner", server.backend)
        assert isinstance(index, CudaSpatialBackend)
        assert index.tracer is server.tracer and server.tracer.enabled
        if resilience == "on":
            # a rebuild's fresh index follows the same tracer
            assert server.backend._factory().tracer is server.tracer
