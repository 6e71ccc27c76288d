"""The reduction of traces and spans to metrics, on synthetic input."""

import json

import pytest

from wqlbench import readers
from wqlbench.harness import Run, Tick
from wqlbench.roofline import LANE_BYTES, QUERY_ROW_BYTES, fanout_bytes
from wqlbench.trace import (
    ANCHOR_CLOSE, ANCHOR_OPEN, OUTSIDE, DeviceOp, DeviceTrace, Span,
    breakdown, card_busy_s, idle_gaps, merge, read_chrome_trace,
    union_length)


def test_fanout_bytes_counts_columns_and_lanes():
    assert QUERY_ROW_BYTES == 21 and LANE_BYTES == 8
    assert fanout_bytes(16_384, 2_200_000) == 16_384 * 21 + 2_200_000 * 8
    assert fanout_bytes(0, 0) == 0


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert merge(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert union_length(iv) == pytest.approx(3.0)
    assert idle_gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert idle_gaps([], 0.0, 2.0) == [(0.0, 2.0)]


def _run(ops, window=(10.0, 20.0), ticks=4, m=100, delivered=1000,
         e2e=("card_us_per_kmsg",), kind="NVIDIA H100 80GB HBM3"):
    run = Run(list(e2e))
    run.open, run.close = window
    run.ticks = [Tick(t, m, 10.0 + t, 11.0 + t, delivered)
                 for t in range(ticks)]
    run.trace = DeviceTrace(window=window, ops=ops, attributed=True)
    run.device_kind = kind
    return run


def test_idle_share_and_roofline():
    ops = [DeviceOp("k", 11.0, 11.5, "dispatch"),
           DeviceOp("k", 11.25, 12.0, "collect"),
           DeviceOp("sort", 15.0, 16.0, "mutate")]
    run = _run(ops)
    # busy 1.0 + 1.0 of a 10 s window
    assert readers.device_idle_pct(run) == pytest.approx(80.0)
    least = fanout_bytes(400, 4000) / 3.35e12
    # the fan-out's own launches cover 11.0-12.0; the mutation's sort
    # is not the fan-out's
    assert readers.fanout_roofline_pct(run) == pytest.approx(
        100.0 * least / 1.0)
    run.reused_share = 0.5
    assert readers.fanout_roofline_pct(run) == pytest.approx(
        100.0 * fanout_bytes(200, 2000) / 3.35e12)


def test_readers_find_nothing_to_read():
    run = _run([DeviceOp("k", 11.0, 12.0, None)])
    assert readers.fanout_roofline_pct(run) is None
    run.trace = None
    assert readers.device_idle_pct(run) is None
    run = _run([], kind="some other card")
    assert readers.fanout_roofline_pct(run) is None
    assert readers.rate(_run([], ticks=0)) is None


def test_rate_spans_and_tail():
    run = _run([], ticks=5, m=100)
    assert readers.rate(run) == pytest.approx(500 / 10.0)
    assert readers.tick_p95_ms(run) == pytest.approx(1000.0)
    run.spans = [Span("dispatch", 11.0, 11.02, 1),
                 Span("dispatch", 12.0, 12.04, 1),
                 Span("dispatch", 5.0, 6.0, 1)]      # before the window
    assert readers.span_mean_ms(run, "dispatch") == pytest.approx(
        1e3 * 0.06 / 5)
    assert readers.applies(run, "local")
    assert not readers.applies(run, "queries")
    run.kind = "queries"
    assert readers.applies(run, "queries")


def test_card_time_per_thousand():
    run = _run([])
    run.attempted, run.card_busy_s = 500, 0.002
    # 2 ms of card time over 500 messages: 4,000 us per 1,000
    assert readers.card_us_per_k(run) == pytest.approx(4000.0)
    run.card_busy_s = None
    assert readers.card_us_per_k(run) is None
    run.card_busy_s, run.attempted = 0.002, 0
    assert readers.card_us_per_k(run) is None


def test_card_busy_is_the_union_of_every_device_op(tmp_path):
    ev = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "b", "ts": 50.0,
         "dur": 100.0},
        {"ph": "X", "cat": "gpu_memset", "name": "c", "ts": 200.0,
         "dur": 10.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 0.0, "dur": 1000.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    assert card_busy_s(str(path)) == pytest.approx(160e-6)


def test_p95_is_nearest_rank():
    assert readers.p95(range(1, 21)) == 19
    assert readers.p95([7.0]) == 7.0


def test_chrome_trace_attribution(tmp_path):
    """Anchors map the trace clock onto perf_counter; each device op
    is named by the span of the thread that launched it."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": ANCHOR_OPEN,
         "ts": 1_000_000.0, "dur": 1},
        {"ph": "X", "cat": "user_annotation", "name": ANCHOR_CLOSE,
         "ts": 3_000_000.0, "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1_100_000.0, "dur": 5, "tid": 7, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1_600_000.0, "dur": 5, "tid": 8, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "match", "ts": 1_200_000.0,
         "dur": 100_000.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "DtoH", "ts": 1_700_000.0,
         "dur": 50_000.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 5_000_000.0,
         "dur": 10.0, "args": {"correlation": 3}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    spans = [Span("dispatch", 100.05, 100.15, 7),
             Span("collect", 100.5, 101.0, 8)]
    tr = read_chrome_trace(str(path), spans,
                           {ANCHOR_OPEN: 100.0, ANCHOR_CLOSE: 102.0},
                           (100.0, 102.0))
    assert tr.attributed
    got = {o.name: (round(o.t0, 6), round(o.t1, 6), o.span) for o in tr.ops}
    assert got == {"match": (100.2, 100.3, "dispatch"),
                   "DtoH": (100.7, 100.75, "collect")}
    bd = breakdown(tr, spans, main_tid=7, top=2)
    assert bd["device_ops"][0][0] == "match"
    assert bd["device_ops"][0][1] == pytest.approx(0.1)
    # the longest gap, 100.75-102.0, has its middle outside every span;
    # the next, 100.3-100.7, falls in the worker's collect
    assert [g[0] for g in bd["idle_gaps"]] == [OUTSIDE, "collect"]
    assert bd["idle_gaps"][0][1] == pytest.approx(1.25)
