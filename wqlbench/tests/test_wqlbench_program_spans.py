"""The program's spans on the card's clock (``program_spans``), on
synthetic input and in a CPU rehearsal."""

import json
import time

import pytest

from wqlbench import program_spans as ps
from wqlbench.harness import Run, Tick
from wqlbench.trace import ANCHOR_CLOSE, ANCHOR_OPEN, OUTSIDE, Span

MAIN, WORKER = 7, 8
#: the worker's pthread id, low 32 bits: the id a trace gave its calls
PTHREAD_ID = 0x1F7FE6C0


def _trace(tmp_path):
    """Two ticks' launches: the dispatch thread's kernel inside
    index.launch, its D2H prefetch too, a kernel launched in
    tick.dispatch outside every index.* span, and the worker's copy
    inside index.fetch."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": ANCHOR_OPEN,
         "ts": 1_000_000.0, "dur": 1},
        {"ph": "X", "cat": "user_annotation", "name": ANCHOR_CLOSE,
         "ts": 3_000_000.0, "dur": 1},
    ]
    launches = [(1, MAIN, 1_100_000.0), (2, MAIN, 1_120_000.0),
                (3, MAIN, 1_180_000.0), (4, PTHREAD_ID, 1_600_000.0)]
    for corr, tid, ts in launches:
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                   "ts": ts, "dur": 5, "tid": tid,
                   "args": {"correlation": corr}})
    ev += [
        {"ph": "X", "cat": "kernel", "name": "match", "ts": 1_200_000.0,
         "dur": 100_000.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
         "Pinned)", "ts": 1_300_000.0, "dur": 50_000.0,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "stray", "ts": 1_400_000.0,
         "dur": 10_000.0, "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
         "Pageable)", "ts": 1_700_000.0, "dur": 40_000.0,
         "args": {"correlation": 4}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


SPANS = [
    ps.ProgramSpan("tick.dispatch", 100.05, 100.2, MAIN, 0),
    ps.ProgramSpan("index.launch", 100.09, 100.15, MAIN, 0),
    ps.ProgramSpan("tick.collect", 100.5, 101.9, WORKER, 0),
    ps.ProgramSpan("index.wait", 100.5, 100.55, WORKER, 0),
    ps.ProgramSpan("index.fetch", 100.55, 100.65, WORKER, 0),
    ps.ProgramSpan("index.decode", 100.65, 101.9, WORKER, 0),
]
ANCHORS = {ANCHOR_OPEN: 100.0, ANCHOR_CLOSE: 102.0}


def test_launches_take_the_innermost_program_span_of_their_thread(tmp_path):
    ops = ps.read_launches(_trace(tmp_path), SPANS, ANCHORS, 100.0,
                            {PTHREAD_ID: WORKER})
    got = {o.name: (round(o.t0, 6), round(o.t1, 6), o.program_span)
           for o in ops}
    assert got == {
        "match": (100.2, 100.3, "index.launch"),
        "Memcpy DtoH (Device -> Pinned)": (100.3, 100.35, "index.launch"),
        "stray": (100.4, 100.41, "tick.dispatch"),
        "Memcpy DtoH (Device -> Pageable)": (100.7, 100.74, "index.fetch"),
    }
    # a thread's span never names another thread's launch
    assert ps.innermost(SPANS, WORKER, 100.12) is None
    assert ps.innermost(SPANS, MAIN, 100.12) == "index.launch"
    assert ps.innermost(SPANS, MAIN, 100.17) == "tick.dispatch"
    assert ps.innermost(SPANS, MAIN, 100.17, "index.") is None


def _traced(tmp_path, spans=SPANS, stats1=None):
    run = Run(["card_us_per_kmsg"])
    run.open, run.close = 100.0, 102.0
    run.ticks = [Tick(0, 1000, 100.05, 101.9, 5000),
                 Tick(1, 1000, 100.2, 101.95, 5000)]
    run.attempted = 2000
    run.spans = [Span("dispatch", 100.05, 100.2, MAIN),
                 Span("collect", 100.5, 101.95, WORKER)]
    tr = ps.TracedRun(run, spans, [(2, 101.0, 101.5)], WORKER,
                      {"fetch_slots": 0, "lanes_decoded": 0},
                      stats1 or {"fetch_slots": 8000, "lanes_decoded": 5000})
    tr.ops = ps.read_launches(_trace(tmp_path), spans, ANCHORS, run.open,
                              {PTHREAD_ID: WORKER})
    return tr


def test_readings_of_spans_counters_and_ops(tmp_path):
    r = ps.readings(_traced(tmp_path))
    assert r["launch_ms"] == pytest.approx(1e3 * 0.06 / 2)
    assert r["decode_ms"] == pytest.approx(1e3 * 1.25 / 2)
    assert r["partition_ms"] is None and r["store_ms"] is None
    # the collector's 0.5 s pause lies inside index.decode
    assert r["collect_gc_ms"] == pytest.approx(1e3 * 0.5 / 2)
    # 0.1 s of index.launch kernels over 2,000 messages; the stray
    # kernel launched outside index.launch is not counted
    assert r["kernel_us_per_kmsg"] == pytest.approx(1e9 * 0.1 / 2000)
    assert r["d2h_us_per_kmsg"] == pytest.approx(1e9 * 0.09 / 2000)
    assert r["fetch_useful_pct"] == pytest.approx(62.5)
    cov = ps.coverage(_traced(tmp_path))
    assert cov["dispatch_covered"] == pytest.approx(0.06 / 0.15)
    assert cov["collect_covered"] == pytest.approx(1.4 / 1.45)
    assert cov["card_busy_covered"] == pytest.approx(0.19 / 0.2)
    assert cov["card_busy_outside_s"][0][0] == "tick.dispatch: stray"
    split = ps.device_split(_traced(tmp_path), MAIN)
    assert split == {
        "dispatch:index.launch": {"kernel": pytest.approx(50.0),
                                  "Memcpy DtoH": pytest.approx(25.0)},
        "dispatch:tick.dispatch": {"kernel": pytest.approx(5.0)},
        "collect:index.fetch": {"Memcpy DtoH": pytest.approx(20.0)}}


def test_readers_find_nothing_without_program_spans(tmp_path):
    """As on a program without the tracer: the ticks' own spans, none of
    the index's, no counters."""
    ticks = [s for s in SPANS if s.name.startswith("tick.")]
    tr = _traced(tmp_path, spans=ticks, stats1={"compact_fetches": 0})
    tr.stats0 = {"compact_fetches": 0}
    assert all(v is None for v in ps.readings(tr).values())


def test_gaps_name_harness_span_program_span_and_collector(tmp_path):
    tr = _traced(tmp_path)
    gaps = ps.name_gaps(tr.ops, tr.run.spans, tr.spans, tr.gc_pauses,
                        MAIN, (100.0, 102.0))
    names = dict((round(b, 6), a) for a, b in gaps)
    # 100.74-102.0: its middle 101.37 is in the worker's decode, inside
    # the collection 101.0-101.5
    assert names[1.26] == "collect/index.decode/gc"
    # 100.41-100.7: its middle 100.555 in the worker's index.fetch
    assert names[0.29] == "collect/index.fetch"
    # 100.0-100.2: its middle 100.1 in the dispatch's index.launch
    assert names[0.2] == "dispatch/index.launch"
    gaps = ps.name_gaps([], [], [], [], MAIN, (0.0, 1.0))
    assert gaps == [[OUTSIDE, 1.0]]


def test_rehearsal_reads_every_program_metric():
    out = ps.run_traced("crowd1m.local", 2**31 + 11, 1.0,
                        t_process=time.perf_counter(), rehearse=256)
    assert out["correct"] is True
    r = out["readings"]
    for name in ("partition_ms", "encode_ms", "launch_ms", "wait_ms",
                 "fetch_ms", "decode_ms", "store_ms", "collect_gc_ms",
                 "fetch_useful_pct"):
        assert r[name], name
    # one span per boundary per tick, never per message or lane
    assert out["most_per_tick"] == dict.fromkeys(
        ["index.decode", "index.encode", "index.fetch", "index.launch",
         "index.partition", "index.store", "index.wait", "tick.collect",
         "tick.dispatch"], 1)


def test_span_cost_reads_the_three_walls():
    cost = ps.span_cost(200)
    assert set(cost) == {"clock_read_ns", "span_off_ns", "span_on_ns"}
    assert all(v > 0 for v in cost.values())
