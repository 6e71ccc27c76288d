"""The program's own spans on the card's clock: one traced run of a cell
with the port's fan-out tracer on.

    python3 -m wqlbench.program_spans --workload crowd1m.local \\
        --seed 7 --seconds 51

drives the cell as ``harness.run_cell`` does in a ``--trace 1`` run,
with ``CudaSpatialBackend.tracer`` enabled and each tick in a trace of
its own, as the server's ticker runs it: the dispatch inside
``tick.dispatch``, the collect inside ``tick.collect`` on the worker.
The backend's ``index.*`` spans nest under those two. The last line of
standard output is one JSON object:

* ``readings``: the per-layer numbers the program's spans, counters and
  the device ops they launched give (``READINGS``), each ``None`` where
  the program records nothing (a program without the tracer);
* ``coverage``: the share of the harness's ``dispatch`` and ``collect``
  span time that the program's ``index.*`` spans of the same thread
  cover, and the share of the card's busy time in ops launched inside
  one, with the names of the ops launched outside every one;
* ``idle_gaps``: the window's longest idle gaps of the card, each named
  ``<harness span>/<innermost program span>``, with ``/gc`` where a
  collection of the garbage collector covers its middle;
* ``harness``: the cell's accepted per-layer readings of the same run,
  ``correct``, and the run's device and card.

``--span-cost N`` prints instead what a span costs on this host, tracing
off and on. ``--rehearse K`` runs on the CPU with the crowd and the
batches divided by ``K`` (no device numbers).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import tempfile
import threading
import time
from collections import Counter
from dataclasses import dataclass

from .generator import Traffic
from .harness import (
    ROOT, Checked, GcPauses, Pipeline, Refused, Run, cell_plan, check,
    load_json, load_reader, power_limit)
from .trace import (
    ANCHOR_CLOSE, ANCHOR_OPEN, DEVICE_CATS, OUTSIDE, RUNTIME_CATS, Span,
    card_busy_s, clip, idle_gaps, merge, read_chrome_trace, union_length)

#: the index.* spans of a crowd1m.local tick: partition, encode,
#: launch, wait, fetch, decode, store
SPANS_PER_TICK = 7
#: per-layer readings of the program's spans and counters, in the order
#: the result prints them: name → (unit, what it reads)
READINGS = {
    "partition_ms": ("ms", "index.partition, mean per window tick"),
    "encode_ms": ("ms", "index.encode"),
    "launch_ms": ("ms", "index.launch"),
    "wait_ms": ("ms", "index.wait"),
    "fetch_ms": ("ms", "index.fetch"),
    "decode_ms": ("ms", "index.decode"),
    "store_ms": ("ms", "index.store"),
    "expand_ms": ("ms", "index.expand"),
    "fold_ms": ("ms", "index.fold"),
    "collect_gc_ms": ("ms", "collector pauses inside the collect "
                            "thread's index.* spans, per window tick"),
    "kernel_us_per_kmsg": ("us/kmsg", "kernels launched in index.launch"),
    "d2h_us_per_kmsg": ("us/kmsg", "device-to-host copies launched in "
                                   "index.launch or index.fetch"),
    "fetch_useful_pct": ("%", "100 x lanes_decoded / fetch_slots"),
}


@dataclass
class ProgramSpan:
    """A span the program recorded, on ``perf_counter`` seconds."""

    name: str
    t0: float
    t1: float
    tid: int
    #: index of the tick trace (or loose trace) it belongs to
    trace: int


@dataclass
class LaunchedOp:
    """A device op with the program span its launch ran in."""

    name: str
    cat: str
    t0: float
    t1: float
    #: innermost program span of the launching thread at the launch
    program_span: str | None
    #: native id of the launching thread (None: no launch found)
    tid: int | None = None
    #: when the launching call started, on ``perf_counter``
    t_launch: float | None = None


def flatten(traces) -> list[ProgramSpan]:
    """The spans of the program's finished traces (``Trace`` objects);
    a span of a program whose spans hold no native thread id gets -1."""
    return [ProgramSpan(s.name, s.t0, s.t0 + s.dur_ms / 1e3,
                        getattr(s, "tid", -1), i)
            for i, tr in enumerate(traces) for s in tr.spans]


def innermost(spans: list[ProgramSpan], tid: int, t: float,
              prefix: str = "") -> str | None:
    """Name of the latest-opened span of thread ``tid`` holding ``t``
    (spans nest, so that is the innermost), among names starting with
    ``prefix``."""
    best = None
    for s in spans:
        if s.tid == tid and s.t0 <= t < s.t1 and s.name.startswith(prefix) \
                and (best is None or s.t0 >= best.t0):
            best = s
    return None if best is None else best.name


def read_launches(path: str, spans: list[ProgramSpan], anchors: dict,
                  lo: float, aliases: dict | None = None) -> list[LaunchedOp]:
    """Device ops of a chrome trace that end after ``lo``, mapped onto
    ``perf_counter`` through the two anchors as
    ``trace.read_chrome_trace`` maps them, each with the innermost
    program span that its launching runtime call (same correlation id,
    thread by native id) ran in. ``aliases`` maps other ids a trace may
    give a thread (``TickTraced.aliases``) to its native id."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    marks = {e["name"]: float(e["ts"]) for e in events
             if e.get("ph") == "X" and e.get("name") in anchors}
    if set(marks) != set(anchors):
        raise RuntimeError(
            f"trace anchors missing: {set(anchors) - set(marks)}")
    (n0, p0), (n1, p1) = sorted(anchors.items(), key=lambda kv: kv[1])
    scale = (p1 - p0) / ((marks[n1] - marks[n0]) * 1e-6)

    def to_perf(ts_us: float) -> float:
        return p0 + (ts_us - marks[n0]) * 1e-6 * scale

    by_tid: dict[int, list[ProgramSpan]] = {}
    for s in spans:
        by_tid.setdefault(s.tid, []).append(s)
    aliases = aliases or {}
    launches = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in RUNTIME_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                tid = int(e.get("tid", -1))
                tid = tid if tid in by_tid else aliases.get(tid, tid)
                at = to_perf(float(e["ts"]))
                launches[corr] = (innermost(by_tid.get(tid, []), tid, at),
                                  tid, at)
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t0 = to_perf(float(e["ts"]))
        t1 = t0 + float(e.get("dur", 0.0)) * 1e-6 * scale
        if t1 <= lo:
            continue
        corr = (e.get("args") or {}).get("correlation")
        out.append(LaunchedOp(str(e.get("name", "?")), e["cat"], t0, t1,
                              *launches.get(corr, (None, None, None))))
    return out


def name_gaps(ops: list[LaunchedOp], harness_spans: list[Span],
              spans: list[ProgramSpan], gc_pauses, main_tid: int,
              window: tuple[float, float], top: int = 10) -> list:
    """The card's longest idle gaps in ``window``, each named by the
    harness span the host was in at its middle (the main thread's
    first, as ``trace.breakdown`` names them), then the innermost
    program span of that span's thread, then ``gc`` where a collection
    covers the middle."""
    gaps = idle_gaps([(o.t0, o.t1) for o in ops], *window)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        held = [s for s in harness_spans if s.t0 <= mid < s.t1]
        held.sort(key=lambda s: s.tid != main_tid)
        parts = [held[0].name] if held else [OUTSIDE]
        if held:
            inner = innermost(spans, held[0].tid, mid, "index.")
            if inner is not None:
                parts.append(inner)
        if any(g0 <= mid < g1 for _, g0, g1 in gc_pauses):
            parts.append("gc")
        named.append(["/".join(parts), b - a])
    return named


def covered(outer: list[tuple[float, float]],
            inner: list[tuple[float, float]]) -> float | None:
    """Share of the union of ``outer`` that ``inner`` covers."""
    total = union_length(outer)
    if total <= 0:
        return None
    return sum(union_length(clip(inner, a, b)) for a, b in merge(outer)) \
        / total


@dataclass
class TracedRun:
    """What the program recorded in a window, beside the harness's
    ``Run`` of it."""

    run: Run
    spans: list[ProgramSpan]
    gc_pauses: list[tuple[int, float, float]]
    collect_tid: int | None
    stats0: dict
    stats1: dict
    ops: list[LaunchedOp] | None = None


def span_ms(tr: TracedRun, name: str) -> float | None:
    """Mean wall of the program span ``name`` per window tick (ms)."""
    run = tr.run
    walls = [s.t1 - s.t0 for s in tr.spans
             if s.name == name and s.t0 >= run.open and s.t1 <= run.close]
    if not walls or not run.ticks:
        return None
    return 1e3 * sum(walls) / len(run.ticks)


def collect_gc_ms(tr: TracedRun) -> float | None:
    """Collector pause time inside the collect thread's ``index.*``
    spans, per window tick (ms): a collection stops every thread, so
    one the dispatch thread starts stalls the decode too."""
    run = tr.run
    mine = merge(clip([(s.t0, s.t1) for s in tr.spans
                       if s.tid == tr.collect_tid
                       and s.name.startswith("index.")],
                      run.open, run.close))
    if not mine or not run.ticks:
        return None
    pauses = [(a, b) for _, a, b in tr.gc_pauses]
    inside = sum(union_length(clip(pauses, a, b)) for a, b in mine)
    return 1e3 * inside / len(run.ticks)


def op_us_per_kmsg(tr: TracedRun, keep) -> float | None:
    """Device time of the ops ``keep`` selects, per 1,000 messages."""
    if tr.ops is None or not tr.run.attempted or not any(
            s.name.startswith("index.") for s in tr.spans):
        return None
    busy = union_length((o.t0, o.t1) for o in tr.ops if keep(o))
    return 1e9 * busy / tr.run.attempted


def fetch_useful_pct(tr: TracedRun) -> float | None:
    key = ("fetch_slots", "lanes_decoded")
    if not all(k in tr.stats1 for k in key):
        return None
    slots, lanes = (tr.stats1[k] - tr.stats0[k] for k in key)
    return 100.0 * lanes / slots if slots else None


def readings(tr: TracedRun) -> dict:
    """Every reading of ``READINGS``; ``None`` where nothing was read."""
    out = {n: span_ms(tr, "index." + n[:-3])
           for n in READINGS if n.endswith("_ms") and n != "collect_gc_ms"}
    out["collect_gc_ms"] = collect_gc_ms(tr)
    out["kernel_us_per_kmsg"] = op_us_per_kmsg(
        tr, lambda o: o.cat == "kernel" and o.program_span == "index.launch")
    out["d2h_us_per_kmsg"] = op_us_per_kmsg(
        tr, lambda o: o.cat == "gpu_memcpy" and "DtoH" in o.name
        and o.program_span in ("index.launch", "index.fetch"))
    out["fetch_useful_pct"] = fetch_useful_pct(tr)
    return {n: out[n] for n in READINGS}


def coverage(tr: TracedRun) -> dict:
    """How much of the harness's spans and of the card's busy time the
    program's ``index.*`` spans account for, in the window."""
    run = tr.run
    lo, hi = run.open, run.close
    out = {}
    for name in ("dispatch", "collect"):
        outer = [(s.t0, s.t1) for s in run.spans
                 if s.name == name and s.t0 >= lo and s.t1 <= hi]
        tids = {s.tid for s in run.spans if s.name == name}
        inner = [(s.t0, s.t1) for s in tr.spans
                 if s.tid in tids and s.name.startswith("index.")]
        out[f"{name}_covered"] = covered(outer, inner)
    if tr.ops is not None:
        ops = [o for o in tr.ops if o.t1 > lo and o.t0 < hi]
        busy = [(o.t0, o.t1) for o in ops]
        mine = [(o.t0, o.t1) for o in ops
                if (o.program_span or "").startswith("index.")]
        out["card_busy_covered"] = covered(busy, mine)
        outside: dict[str, float] = {}
        for o in ops:
            if not (o.program_span or "").startswith("index."):
                key = f"{o.program_span}: {o.name[:80]}"
                outside[key] = outside.get(key, 0.0) + (o.t1 - o.t0)
        out["card_busy_outside_s"] = sorted(
            outside.items(), key=lambda kv: -kv[1])[:10]
        # launches mapped just before an index.* span of their thread:
        # how far before, where a clock offset would put them
        starts = sorted((s.tid, s.t0) for s in tr.spans
                        if s.name.startswith("index."))
        early = []
        for o in ops:
            if o.t_launch is None or (o.program_span or "").startswith(
                    "index."):
                continue
            nxt = [t0 for tid, t0 in starts
                   if tid == o.tid and 0 <= t0 - o.t_launch < 1e-3]
            if nxt:
                early.append(1e6 * (min(nxt) - o.t_launch))
        if early:
            out["launch_before_span_us"] = {
                "count": len(early), "median": statistics.median(early),
                "max": max(early)}
    return out


def most_per_tick(spans: list[ProgramSpan]) -> dict:
    """The most spans of each name that one tick's trace holds."""
    per: dict[tuple[int, str], int] = {}
    for s in spans:
        per[s.trace, s.name] = per.get((s.trace, s.name), 0) + 1
    out: dict[str, int] = {}
    for (_, name), n in per.items():
        out[name] = max(out.get(name, 0), n)
    return dict(sorted(out.items()))


def device_split(tr: TracedRun, main_tid: int) -> dict:
    """Device ms per window tick of the ops launched in each program
    span, by launching thread (``dispatch``, ``collect`` or the native
    id) and by kind: kernels, each copy direction, sets."""
    out: dict[str, dict[str, float]] = {}
    names = {main_tid: "dispatch", tr.collect_tid: "collect"}
    for o in tr.ops:
        where = f"{names.get(o.tid, o.tid)}:{o.program_span}"
        kind = ("kernel" if o.cat == "kernel" else "set"
                if o.cat == "gpu_memset" else " ".join(o.name.split()[:2]))
        row = out.setdefault(where, {})
        row[kind] = row.get(kind, 0.0) + 1e3 * (o.t1 - o.t0) \
            / len(tr.run.ticks)
    return out


class TickTraced:
    """The backend as the server's ticker drives it with tracing on:
    each tick a trace of its own, the dispatch inside ``tick.dispatch``
    and the collect inside ``tick.collect`` of the same trace, on
    whichever thread collects it. Everything else passes through."""

    def __init__(self, backend, tracer):
        self.backend, self.tracer = backend, tracer
        #: pthread id (whole and its low 32 bits) → native id of each
        #: thread that dispatched or collected: the profiler names some
        #: threads' CUDA calls by the former (seen for the collect worker)
        self.aliases: dict[int, int] = {}
        #: collects by the path the backend's timing names (dense, csr,
        #: overflow, reuse)
        self.paths: Counter = Counter()

    def _note_thread(self) -> None:
        th = threading.current_thread()
        self.aliases[th.ident] = self.aliases[th.ident & 0xFFFFFFFF] = \
            th.native_id

    def dispatch_staged_batch(self, *cols):
        self._note_thread()
        trace = self.tracer.begin("tick")
        with trace.span("tick.dispatch"):
            return trace, self.backend.dispatch_staged_batch(*cols)

    def collect_local_batch(self, traced):
        self._note_thread()
        trace, handle = traced
        try:
            with trace.span("tick.collect"):
                out = self.backend.collect_local_batch(handle)
            timing = getattr(self.backend, "last_device_timing", {})
            self.paths[timing.get("path")] += 1
            return out
        finally:
            trace.finish()

    def __getattr__(self, name):
        return getattr(self.backend, name)


def run_traced(workload: str, seed: int, seconds: float, *,
               t_process: float, rehearse: int | None = None,
               bench: dict | None = None) -> dict:
    """One traced run of ``workload`` with the program's tracer on."""
    import torch

    from worldql_server_tpu_torch.observability.spans import Tracer
    from worldql_server_tpu_torch.spatial.cuda_backend import (
        CudaSpatialBackend)

    bench = bench or load_json(ROOT / "BENCHMARK.json")
    plan = cell_plan(bench, workload)
    if rehearse is None and not torch.cuda.is_available():
        raise Refused("torch sees no CUDA device")
    device = "cpu" if rehearse is not None else "cuda:0"
    config, mix = plan["config"], plan["mix"]
    traffic_args = (config, mix, seed, rehearse or 1)
    traffic = Traffic(*traffic_args)
    run = Run(plan["end_to_end"],
              kind="queries" if traffic.has_kinds else "local")
    backend = CudaSpatialBackend(traffic.cube, device=device)
    backend.configure_delta_ticks(config["delta_ticks"])
    backend.query_stencil_max = int(config["query_stencil_max"])
    backend.query_ray_steps = int(config["query_ray_steps"])
    traces: list = []
    tracer = Tracer(enabled=True, on_trace=traces.append)
    # by assignment: a program without the attribute records nothing
    backend.tracer = tracer
    traced = TickTraced(backend, tracer)
    pipe = Pipeline(traced, traffic, run.spans)
    run.main_tid = pipe.main_tid
    pipe.load()
    warm = int(mix["warmup_ticks"])
    pipe.run(0, count=warm)
    if device != "cpu":
        torch.cuda.synchronize()
    stats0 = backend.device_stats()
    prof = None
    if device != "cpu":
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    checked = Checked(traffic.words, warm, traffic.has_kinds)
    gc_pauses = GcPauses()
    traces.clear()
    traced.paths.clear()
    gc.callbacks.append(gc_pauses)
    anchors = {}

    def anchor(name: str) -> None:
        # the anchor's trace time is taken inside the enter: the middle
        # of the two reads, not the read before it (a bias of the
        # enter's cost would move every launch earlier)
        t0 = time.perf_counter()
        with record_function(name):
            anchors[name] = (t0 + time.perf_counter()) / 2

    run.open = time.perf_counter()
    if prof is not None:
        anchor(ANCHOR_OPEN)
    done, last = pipe.run(warm, deadline=run.open + seconds,
                          keep=checked.keep)
    run.ticks = done
    run.close = done[-1].c1
    gc.callbacks.remove(gc_pauses)
    run.attempted = sum(tk.m for tk in done) + last.m
    if prof is not None:
        anchor(ANCHOR_CLOSE)
        torch.cuda.synchronize()
        prof.stop()
    stats1 = backend.device_stats()
    spans = flatten(traces)
    collect_tids = {s.tid for s in spans if s.name == "tick.collect"}
    tr = TracedRun(run, spans, gc_pauses.pauses,
                   next(iter(collect_tids), None), stats0, stats1)
    device_info = None
    if prof is not None:
        run.device_kind = torch.cuda.get_device_name(0)
        device_info = {"kind": run.device_kind,
                       "memory_peak_bytes": int(
                           torch.cuda.max_memory_allocated(0))}
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            run.card_busy_s = card_busy_s(path)
            run.trace = read_chrome_trace(path, run.spans, anchors,
                                          (run.open, run.close))
            tr.ops = read_launches(path, spans, anchors, run.open,
                                   traced.aliases)
        del prof
    backend.wait_compaction()
    for tk in (done[-1], last):
        if tk.out is not None:
            checked.take(tk)
    failed = sum(tk.m for tk in [*done, last] if tk.answered != tk.m)
    del backend, pipe
    result_checks = check(traffic_args, checked.answers, None)
    correct = (result_checks["wrong_answers"] == 0 and failed == 0
               and result_checks["answers_checked"] > 0)
    out = {"correct": correct, "workload": workload, "seed": seed,
           "window_ticks": len(done), "attempted": run.attempted,
           "collect_paths": dict(traced.paths),
           "most_per_tick": most_per_tick(spans)}
    if rehearse is not None:
        out["readings"] = {n: v is not None
                           for n, v in readings(tr).items()}
        return out
    out["readings"] = readings(tr)
    out["coverage"] = coverage(tr)
    out["device_ms_per_tick"] = device_split(tr, run.main_tid)
    out["span_ms_per_tick"] = {
        name: {"median": statistics.median(w), "max": max(w)}
        for name in sorted({s.name for s in spans})
        if (w := [1e3 * (s.t1 - s.t0) for s in spans if s.name == name
                  and s.t0 >= run.open and s.t1 <= run.close])}
    out["idle_gaps"] = name_gaps(tr.ops, run.spans, spans, gc_pauses.pauses,
                                 run.main_tid, (run.open, run.close))
    out["harness"] = {n: load_reader(n)(run) for n in plan["per_layer"]}
    out["harness"]["card_us_per_kmsg"] = load_reader("card_us_per_kmsg")(run)
    device_info["card"] = power_limit()
    out["device"] = device_info
    return out


def span_cost(n: int) -> dict:
    """Nanoseconds per span site of the fan-out path on this host: a
    bare clock read (what a leg paid before), the site with tracing off,
    and with tracing on inside a tick trace's ``tick.collect``."""
    from worldql_server_tpu_torch.observability.spans import Tracer
    from worldql_server_tpu_torch.spatial.cuda_backend import (
        CudaSpatialBackend)

    b = CudaSpatialBackend(16, device="cpu")
    clock = time.perf_counter

    def per_call(fn, calls: int) -> float:
        best = float("inf")
        for _ in range(5):
            t0 = clock()
            for _ in range(calls):
                fn()
            best = min(best, (clock() - t0) / calls)
        return 1e9 * best

    out = {"clock_read_ns": per_call(clock, n),
           "span_off_ns": per_call(lambda: b._span("index.decode", 0.0), n)}
    b.tracer = tracer = Tracer(enabled=True, on_trace=lambda t: None)

    def tick():
        # a tick's trace holds a handful of spans, not n
        trace = tracer.begin("tick")
        with trace.span("tick.collect"):
            for _ in range(SPANS_PER_TICK):
                b._span("index.decode", 0.0)
        trace.finish()

    bare = per_call(lambda: tracer.begin("tick").finish(), n // 10)
    out["span_on_ns"] = (per_call(tick, n // 10) - bare) / SPANS_PER_TICK
    return out


def main(argv=None) -> int:
    t_process = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python3 -m wqlbench.program_spans")
    ap.add_argument("--workload", default="crowd1m.local")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--rehearse", type=int, default=None, metavar="K")
    ap.add_argument("--span-cost", type=int, default=None, metavar="N")
    args = ap.parse_args(argv)
    if args.span_cost is not None:
        print(json.dumps(span_cost(args.span_cost)), flush=True)
        return 0
    try:
        out = run_traced(args.workload, args.seed, args.seconds,
                         t_process=t_process, rehearse=args.rehearse)
    except Refused as exc:
        print(f"wqlbench: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
