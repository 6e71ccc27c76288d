"""Reduction of a ``torch.profiler`` trace and the harness's host spans.

The harness records its own spans (``generate``, ``mutate``,
``dispatch`` on the main thread, ``collect`` on the collect worker) with
``time.perf_counter`` and the thread's native id. The profiler's chrome
trace gives the device's activity (kernels, copies, sets) and the CUDA
runtime call that launched each, with the launching thread. Two
``record_function`` anchors on the main thread, at the window's open and
close, map the trace's clock onto ``perf_counter``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
ANCHOR_OPEN = "wqlbench.window.open"
ANCHOR_CLOSE = "wqlbench.window.close"
#: the name of a gap in which the host was in none of the spans
OUTSIDE = "outside_any_layer"


@dataclass
class Span:
    name: str
    t0: float
    t1: float
    tid: int


@dataclass
class DeviceOp:
    name: str
    t0: float
    t1: float
    #: the harness span the launching host call ran in, if known
    span: str | None = None


@dataclass
class DeviceTrace:
    """Device activity inside the window, in ``perf_counter`` seconds."""

    window: tuple[float, float]
    ops: list[DeviceOp] = field(default_factory=list)
    #: whether the trace tied device activity to launching threads
    attributed: bool = False


def union_length(intervals) -> float:
    """Total length covered by ``[(t0, t1), ...]``."""
    return sum(b - a for a, b in merge(intervals))


def merge(intervals) -> list[tuple[float, float]]:
    """Sorted, merged ``(t0, t1)`` intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def idle_gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no busy interval covers."""
    gaps, at = [], lo
    for a, b in merge(clip(busy, lo, hi)):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def span_at(spans: list[Span], t: float, main_tid: int) -> str:
    """What the host was doing at ``t``: the main thread's span if it
    was in one, else the collect worker's, else ``OUTSIDE``."""
    worker = None
    for s in spans:
        if s.t0 <= t < s.t1:
            if s.tid == main_tid:
                return s.name
            worker = s.name
    return worker or OUTSIDE


def span_of(spans_by_tid: dict, tid: int, t: float) -> str | None:
    """The span of thread ``tid`` that holds ``t``."""
    starts, ends, names = spans_by_tid.get(tid, ((), (), ()))
    i = int(np.searchsorted(starts, t, "right")) - 1
    if i >= 0 and t < ends[i]:
        return names[i]
    return None


def card_busy_s(path: str) -> float:
    """Seconds in which any device op of a chrome trace ran: the union
    of all its kernels, copies and sets."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return 1e-6 * union_length(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)


def read_chrome_trace(path: str, spans: list[Span], anchors: dict,
                      window: tuple[float, float]) -> DeviceTrace:
    """Device ops of a chrome trace inside ``window``, mapped onto
    ``perf_counter`` through the two anchors (name → perf_counter time
    taken just before the anchor's ``record_function``)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    marks = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") in anchors:
            marks[e["name"]] = float(e["ts"])
    if set(marks) != set(anchors):
        raise RuntimeError(
            f"trace anchors missing: {set(anchors) - set(marks)}")
    (n0, p0), (n1, p1) = sorted(anchors.items(), key=lambda kv: kv[1])
    scale = (p1 - p0) / ((marks[n1] - marks[n0]) * 1e-6)

    def to_perf(ts_us: float) -> float:
        return p0 + (ts_us - marks[n0]) * 1e-6 * scale

    launches = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (int(e.get("tid", -1)), to_perf(e["ts"]))
    by_tid: dict[int, tuple] = {}
    for tid in {s.tid for s in spans}:
        mine = sorted((s for s in spans if s.tid == tid), key=lambda s: s.t0)
        by_tid[tid] = (np.array([s.t0 for s in mine]),
                       np.array([s.t1 for s in mine]),
                       [s.name for s in mine])
    out = DeviceTrace(window=window, attributed=bool(launches))
    lo, hi = window
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t0 = to_perf(float(e["ts"]))
        t1 = t0 + float(e.get("dur", 0.0)) * 1e-6 * scale
        if t1 <= lo or t0 >= hi:
            continue
        corr = (e.get("args") or {}).get("correlation")
        span = None
        if corr in launches:
            tid, t_launch = launches[corr]
            span = span_of(by_tid, tid, t_launch)
        out.ops.append(DeviceOp(str(e.get("name", "?")), max(t0, lo),
                                min(t1, hi), span))
    return out


def breakdown(trace: DeviceTrace, spans: list[Span], main_tid: int,
              top: int = 10) -> dict:
    """The device ops that took most time and the longest idle gaps,
    each gap named by what the host was doing in its middle."""
    by_name: dict[str, float] = {}
    for op in trace.ops:
        by_name[op.name] = by_name.get(op.name, 0.0) + (op.t1 - op.t0)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = idle_gaps([(o.t0, o.t1) for o in trace.ops], *trace.window)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [[span_at(spans, (a + b) / 2, main_tid), b - a]
             for a, b in gaps[:top]]
    return {"device_ops": [[n[:96], s] for n, s in ops],
            "idle_gaps": named}
