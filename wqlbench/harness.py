"""One run of one cell: set-up, the measured window, the check, metrics.

The window drives the port's ``SpatialBackend`` boundary as the
server's ticker does: each tick's subscription moves (bulk remove, bulk
add, flush), then ``dispatch_staged_batch`` on the main thread, its
``collect_local_batch`` on one worker thread, and tick t+1 dispatched
before tick t's collect is awaited. The window opens once set-up has
warmed the cell's own batch shape and closes at the completion of the
first tick that completes after ``--seconds``; a rate is all the work
of the ticks completed in it over all its time.

After the window the program is freed and the plain reference
(``reference/``) works out, from the seed alone, the answers of a
seeded sample of the window's ticks and of the tick still in flight at
its close, and ``correct`` says whether every one of them agreed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .generator import Traffic
from .reference.index import SubscriptionTable, fanout, queries
from .trace import ANCHOR_CLOSE, ANCHOR_OPEN, DeviceTrace, Span

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
#: top-level modules that must not be loaded by the process that prints
#: a result: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "worldql_server_tpu")
#: early window ticks whose answers the reference checks, drawn from the
#: seed among the first EARLY_TICKS, beside the closing tick and the tick
#: in flight at the close
SAMPLED_TICKS = 2
EARLY_TICKS = 8
#: recipients a control answer keeps (``--control cap64``)
CONTROL_CAP = 64
_PRIORITY = 9


class Refused(Exception):
    """A run that must end without a result (exit code 2)."""


@dataclass
class Tick:
    t: int
    m: int
    d0: float
    c1: float = 0.0
    delivered: int = 0
    answered: int = 0
    out: list | None = None


@dataclass
class Run:
    """What a run measured: the readers of ``metrics/`` take it."""

    end_to_end: list[str]
    #: ``local`` for LocalMessage batches, ``queries`` for staged
    #: queries: the suffix of the per-layer metrics that read the run
    kind: str = "local"
    setup_s: float = 0.0
    open: float = 0.0
    close: float = 0.0
    ticks: list[Tick] = field(default_factory=list)
    spans: list[Span] = field(default_factory=list)
    main_tid: int = 0
    trace: DeviceTrace | None = None
    device_kind: str | None = None
    reused_share: float = 0.0
    #: messages or queries dispatched in the window, the tick in flight
    #: at its close included
    attempted: int = 0
    #: union of the card's activity over all that work, from the
    #: profiler (seconds)
    card_busy_s: float | None = None

    @property
    def window_s(self) -> float:
        return self.close - self.open

    def in_window(self, name: str) -> list[float]:
        """Durations (s) of the spans ``name`` inside the window."""
        return [s.t1 - s.t0 for s in self.spans
                if s.name == name and s.t0 >= self.open and s.t1 <= self.close]


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX
    package, compared whole (``worldql_server_tpu_torch`` passes)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "wqlbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or not path.exists():
        raise Refused(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_plan(bench: dict, workload: str) -> dict:
    """The cell, its configuration and mix files, and its metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = [m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    layer = [m["name"] for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e)]
    return {"cell": cell,
            "config": load_json(ROOT / configs[cell["config"]]["file"]),
            "mix": load_json(PKG / "traffic" / f"{cell['traffic']}.json"),
            "end_to_end": e2e, "per_layer": layer}


class Pipeline:
    """The cell's path through the port, with the harness's spans."""

    def __init__(self, backend, traffic: Traffic, spans: list[Span]):
        self.backend, self.traffic, self.spans = backend, traffic, spans
        self.worlds = [f"world_{w}" for w in range(traffic.n_worlds)]
        self.main_tid = threading.get_native_id()
        self.wid = self.pid = None
        self.interval = float(traffic.mix.get("tick_interval_s") or 0.0)
        #: (start, CPU seconds) of each collect on the worker thread
        self.collect_cpu: list[tuple[float, float]] = []

    def span(self, name: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.spans.append(Span(name, t0, t1, threading.get_native_id()))
        return t1

    def load(self) -> None:
        """Bulk-loads the crowd. The harness keeps no peer objects of
        its own afterwards: the program's are all that live."""
        tr, b = self.traffic, self.backend
        peers = peer_uuids(np.arange(tr.n))
        for w, world in enumerate(self.worlds):
            sel = np.flatnonzero(tr.world_of == w)
            b.bulk_add_subscriptions(world, [peers[i] for i in sel],
                                     tr.cubes[sel])
        b.flush()
        b.wait_compaction()
        world_ids, peer_ids = b.interning_maps()
        self.wid = np.array([world_ids[w] for w in self.worlds], np.int32)
        self.pid = np.fromiter((peer_ids[p] for p in peers), np.int32,
                               count=tr.n)

    def mutate(self, t: int) -> None:
        t0 = time.perf_counter()
        mv = self.traffic.moves(t)
        if mv is None:
            return
        b, wof = self.backend, self.traffic.world_of[mv.idx]
        for w in np.unique(wof):
            sel = np.flatnonzero(wof == w)
            who = peer_uuids(mv.idx[sel])
            b.bulk_remove_subscriptions(self.worlds[w], who, mv.old[sel])
            b.bulk_add_subscriptions(self.worlds[w], who, mv.new[sel])
        b.flush()
        self.span("mutate", t0)

    def generate(self, t: int):
        t0 = time.perf_counter()
        msg = self.traffic.messages(t)
        cols = (self.wid[msg.worlds], msg.positions, self.pid[msg.senders],
                msg.repls)
        if msg.kinds is not None:
            cols += (msg.kinds, msg.params)
        self.span("generate", t0)
        return cols

    def collect(self, handle):
        t0, c0 = time.perf_counter(), time.thread_time()
        out = self.backend.collect_local_batch(handle)
        self.collect_cpu.append((t0, time.thread_time() - c0))
        return out, self.span("collect", t0)

    def run(self, start: int, *, count: int | None = None,
            deadline: float | None = None, keep=None):
        """Ticks from ``start``: ``count`` of them, or until the first
        completion at or after ``deadline``. ``keep(tick)`` sees each
        completed tick's answers before they are dropped. Returns the
        completed ticks, the last with its ``out``, and the tick that was
        in flight, drained, with its ``out``."""
        done: list[Tick] = []
        pending = None
        t = start
        first = time.perf_counter()
        with ThreadPoolExecutor(1, thread_name_prefix="collect") as pool:
            while True:
                if self.interval:
                    wait = first + (t - start) * self.interval \
                        - time.perf_counter()
                    if wait > 0:
                        time.sleep(wait)
                self.mutate(t)
                cols = self.generate(t)
                tick = Tick(t, len(cols[0]), time.perf_counter())
                handle = self.backend.dispatch_staged_batch(*cols)
                self.span("dispatch", tick.d0)
                fut = pool.submit(self.collect, handle)
                closing = False
                if pending is not None:
                    prev = self._finish(*pending)
                    done.append(prev)
                    closing = deadline is not None and prev.c1 >= deadline
                    if keep is not None:
                        keep(prev)
                    if not closing:
                        prev.out = None
                pending = (tick, fut)
                t += 1
                if closing or (count is not None and t - start >= count):
                    break
            last = self._finish(*pending)
        return done, last

    @staticmethod
    def _finish(tick: Tick, fut) -> Tick:
        tick.out, tick.c1 = fut.result()
        tick.answered = len(tick.out)
        tick.delivered = sum(len(getattr(a, "peers", a)) for a in tick.out)
        return tick


def peer_uuids(idx: np.ndarray) -> list:
    """The peers' UUIDs, as a client's message carries them: subscriber
    ``i`` is ``UUID(int=i + 1)``."""
    return [uuid.UUID(int=i + 1) for i in idx.tolist()]


def peer_index(u) -> int:
    return u.int - 1


def host_cpu() -> dict:
    """This process's CPU seconds and context switches so far."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"user_s": ru.ru_utime, "sys_s": ru.ru_stime,
            "voluntary_switches": ru.ru_nvcsw,
            "involuntary_switches": ru.ru_nivcsw}


def collect_cpu_per_wall(run: Run, cpu: list) -> float | None:
    """The collect worker's CPU seconds over its wall seconds, in the
    window's collects: under 1 where it waited for the interpreter lock
    or for a core."""
    by_start = dict(cpu)
    spans = [s for s in run.spans if s.name == "collect"
             and s.t0 >= run.open and s.t1 <= run.close]
    wall = sum(s.t1 - s.t0 for s in spans)
    return sum(by_start[s.t0] for s in spans) / wall if wall > 0 else None


class GcPauses:
    """Collections of the cyclic garbage collector, as (generation,
    start, end): part of the program's host time that a window holds."""

    def __init__(self):
        self.pauses: list[tuple[int, float, float]] = []
        self._start = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self.pauses.append((info["generation"], self._start,
                                time.perf_counter()))

    def summary(self, lo: float, hi: float) -> dict:
        out = {}
        for gen, a, b in self.pauses:
            if a >= lo and b <= hi:
                n, s = out.get(gen, (0, 0.0))
                out[gen] = (n + 1, s + b - a)
        return {f"gen{g}": {"count": n, "s": s}
                for g, (n, s) in sorted(out.items())}


class Checked:
    """The window's ticks whose answers are checked: two drawn from the
    seed among the window's first ``EARLY_TICKS``, turned into plain
    arrays as they complete, and, after the close, the closing tick and
    the tick in flight at the close. Nothing else of the program's
    answers outlives its tick, so the harness adds no live objects for
    the program's garbage collector to walk."""

    def __init__(self, words: list[int], first: int, kinds: bool):
        pick = np.random.default_rng([*words, _PRIORITY]).choice(
            EARLY_TICKS, SAMPLED_TICKS, replace=False)
        self.early = {first + int(k) for k in pick}
        self.kinds = kinds
        self.answers: dict[int, object] = {}

    def keep(self, tick: Tick) -> None:
        if tick.t in self.early:
            self.take(tick)

    def take(self, tick: Tick) -> None:
        self.answers[tick.t] = compact(tick.out, self.kinds)
        tick.out = None


def compact(out: list, kinds: bool):
    """A tick's answers as the check reads them: for LocalMessages the
    recipient counts and the flat peer indices, for queries each answer
    in canonical form."""
    if kinds:
        return [canonical(a) for a in out]
    lens = np.fromiter(map(len, out), np.int64, count=len(out))
    flat = np.fromiter((peer_index(u) for lst in out for u in lst),
                       np.int64, count=int(lens.sum()))
    return lens, flat


def canonical(answer) -> tuple:
    """A program answer as the reference states it (``peer_index``)."""
    if hasattr(answer, "extra"):
        return (int(answer.kind), tuple(peer_index(u) for u in answer.peers),
                dict(answer.extra))
    return (0, tuple(sorted(peer_index(u) for u in answer)), None)


def wrong_fanout(lens: np.ndarray, flat: np.ndarray, rows: np.ndarray,
                 peers: np.ndarray, m: int, n: int) -> int:
    """Messages whose recipient multiset differs from the reference's:
    another count, or a (message, peer) pair on one side only."""
    got = np.repeat(np.arange(m), lens) * n + flat
    bad = lens != np.bincount(rows, minlength=m)
    bad[np.setxor1d(got, rows * n + peers) // n] = True
    return int(bad.sum())


def check(traffic_args: tuple, answers: dict,
          control: str | None) -> dict:
    """Replays the seed's traffic to the last sampled tick and compares
    each sampled tick's answers with the reference's. ``control``
    ``cap64`` puts the reference, kept to its first 64 recipients, in
    the program's place."""
    tr = Traffic(*traffic_args)
    by_t = answers
    wrong = checked = 0
    table = None
    for t in range(max(by_t) + 1 if by_t else 0):
        mv = tr.moves(t)
        if t not in by_t:
            continue
        msg = tr.messages(t)
        if table is None or mv is not None:
            table = SubscriptionTable(tr.world_of, tr.cubes,
                                      np.arange(tr.n), tr.cube)
        out = by_t[t]
        checked += tr.m
        if len(out[0] if msg.kinds is None else out) != tr.m:
            wrong += tr.m
        elif msg.kinds is None:
            rows, peers = fanout(table, msg.worlds, msg.positions,
                                 msg.senders, msg.repls)
            if control == "cap64":
                # the capped reference as a program answer: its counts
                # and its peers, message by message
                rank = np.arange(rows.size) - np.searchsorted(rows, rows)
                keep = rank < CONTROL_CAP
                out = (np.bincount(rows[keep], minlength=tr.m),
                       peers[keep])
            wrong += wrong_fanout(*out, rows, peers, tr.m, tr.n)
        else:
            want = queries(table, msg.worlds, msg.positions, msg.senders,
                           msg.repls, msg.kinds, msg.params,
                           stencil_max=tr.config["query_stencil_max"],
                           ray_steps=tr.config["query_ray_steps"])
            if control == "cap64":
                got = [(k, p[:CONTROL_CAP], e) for k, p, e in want]
            else:
                got = out
            wrong += sum(g != w for g, w in zip(got, want))
    return {"wrong_answers": wrong, "answers_checked": checked,
            "ticks_checked": sorted(by_t)}


def power_limit() -> str | None:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_process: float, rehearse: int | None = None,
             control: str | None = None, bench: dict | None = None) -> dict:
    """One run. ``rehearse`` runs on the CPU with the crowd and the
    batches divided by it, and reports no measurement. ``bench`` stands
    in for ``BENCHMARK.json`` (tests of cells it does not hold)."""
    import torch

    bench = bench or load_json(ROOT / "BENCHMARK.json")
    plan = cell_plan(bench, workload)
    chips = int(plan["cell"]["chips"])
    if rehearse is None:
        if not torch.cuda.is_available():
            raise Refused("torch sees no CUDA device")
        if torch.cuda.device_count() < chips:
            raise Refused(f"{workload} needs {chips} devices, torch sees "
                          f"{torch.cuda.device_count()}")
        device = "cuda:0"
    else:
        device = "cpu"
    t0 = time.perf_counter()
    # interpreter start, harness and torch imports, the device check
    split = {"start_s": t0 - t_process}
    if device != "cpu":
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    split["context_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from worldql_server_tpu_torch.spatial.cuda_backend import (
        CudaSpatialBackend)
    split["import_s"] = time.perf_counter() - t0

    config, mix = plan["config"], plan["mix"]
    t0 = time.perf_counter()
    traffic_args = (config, mix, seed, rehearse or 1)
    traffic = Traffic(*traffic_args)
    split["crowd_s"] = time.perf_counter() - t0
    run = Run(plan["end_to_end"],
              kind="queries" if traffic.has_kinds else "local")
    backend = CudaSpatialBackend(traffic.cube, device=device)
    backend.configure_delta_ticks(config["delta_ticks"])
    backend.query_stencil_max = int(config["query_stencil_max"])
    backend.query_ray_steps = int(config["query_ray_steps"])
    pipe = Pipeline(backend, traffic, run.spans)
    run.main_tid = pipe.main_tid
    t0 = time.perf_counter()
    pipe.load()
    split["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = int(mix["warmup_ticks"])
    pipe.run(0, count=warm)
    if device != "cpu":
        torch.cuda.synchronize()
    split["warm_s"] = time.perf_counter() - t0
    stats0 = backend.device_stats()

    prof = None
    t0 = time.perf_counter()
    if rehearse is None:
        # the card's activity in every measured run; the host's ops and
        # the anchors that tie them to the spans only in a traced one
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA] if trace
                       else [ProfilerActivity.CUDA])
        prof.start()
    split["profiler_s"] = time.perf_counter() - t0
    checked = Checked(traffic.words, warm, traffic.has_kinds)
    gc_pauses = GcPauses()
    gc.callbacks.append(gc_pauses)
    anchors = {}
    cpu0 = host_cpu()
    run.open = time.perf_counter()
    run.setup_s = run.open - t_process
    if prof is not None and trace:
        anchors[ANCHOR_OPEN] = time.perf_counter()
        with record_function(ANCHOR_OPEN):
            pass
    done, last = pipe.run(warm, deadline=run.open + seconds,
                          keep=checked.keep)
    run.ticks = done
    run.close = done[-1].c1
    cpu1 = host_cpu()
    gc.callbacks.remove(gc_pauses)
    run.attempted = sum(tk.m for tk in done) + last.m
    if prof is not None:
        if trace:
            anchors[ANCHOR_CLOSE] = time.perf_counter()
            with record_function(ANCHOR_CLOSE):
                pass
        torch.cuda.synchronize()
        prof.stop()
    stats1 = backend.device_stats()
    rows = stats1["delta_reused"] + stats1["delta_recomputed"] \
        - stats0["delta_reused"] - stats0["delta_recomputed"]
    run.reused_share = (stats1["delta_reused"] - stats0["delta_reused"]) \
        / rows if rows else 0.0
    device_info = None
    if rehearse is None:
        run.device_kind = torch.cuda.get_device_name(0)
        device_info = {"platform": "gpu", "kind": run.device_kind,
                       "count": chips,
                       "memory_peak_bytes": int(
                           torch.cuda.max_memory_allocated(0))}
    if prof is not None:
        from .trace import card_busy_s, read_chrome_trace

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            # every device op the profiler saw: it ran from the window's
            # open until the work dispatched in it had finished
            run.card_busy_s = card_busy_s(path)
            if trace:
                run.trace = read_chrome_trace(path, run.spans, anchors,
                                              (run.open, run.close))
        del prof
    failed = sum(tk.m for tk in [*done, last] if tk.answered != tk.m)
    info = {"workload": workload, "seed": seed, "setup_split_s": split,
            "crowd": traffic.stats, "subscriptions": traffic.n,
            "batch": traffic.m, "movers_per_tick": traffic.movers,
            "window_ticks": len(done),
            "card_busy_s": run.card_busy_s,
            "collect_ms_p50_max": [
                1e3 * statistics.median(run.in_window("collect")),
                1e3 * max(run.in_window("collect"))],
            "gc_in_window": gc_pauses.summary(run.open, run.close),
            # the window's host CPU: whether a slow run waited or ran slow
            "cpu_in_window": {k: cpu1[k] - cpu0[k] for k in cpu1},
            "collect_cpu_per_wall": collect_cpu_per_wall(run,
                                                         pipe.collect_cpu),
            "delivered_per_tick": statistics.median(
                tk.delivered for tk in done),
            "reused_share": run.reused_share,
            "device_stats": {k: stats1[k] for k in (
                "compactions", "compaction_failures", "base_rows",
                "delta_rows", "max_fanout_k", "last_fetch_bytes",
                "compact_fetches", "full_fetches", "delta_reused",
                "delta_recomputed", "delta_sync_scatters",
                "delta_sync_sorts")},
            "window_compactions": stats1["compactions"]
            - stats0["compactions"],
            "fetch_bytes_last": stats1["last_fetch_bytes"]}
    backend.wait_compaction()
    for tk in (done[-1], last):
        if tk.out is not None:
            checked.take(tk)
    del backend, pipe
    if device != "cpu":
        torch.cuda.empty_cache()
        info["card"] = power_limit()

    result_checks = check(traffic_args, checked.answers, control)
    info["ticks_checked"] = result_checks["ticks_checked"]
    info["answers_checked"] = result_checks["answers_checked"]
    names = plan["per_layer"] if trace else plan["end_to_end"]
    units = {m["name"]: m["unit"] for m in
             bench["end_to_end"] + bench["per_layer"]}
    values = {name: load_reader(name)(run) for name in names}
    correct = (result_checks["wrong_answers"] == 0 and failed == 0
               and result_checks["answers_checked"] > 0)
    checks = {"wrong_answers": {"value": result_checks["wrong_answers"],
                                "limit": 0}}
    if rehearse is not None:
        info["readers"] = {n: v is not None for n, v in values.items()}
        return result_line(correct, run.attempted, failed, None, None, None,
                           checks, info)
    metrics = {n: {"value": v, "unit": units[n]}
               for n, v in values.items() if v is not None}
    bd = None
    if run.trace is not None:
        from .trace import breakdown, union_length

        device_info.update(
            busy_s=union_length((o.t0, o.t1) for o in run.trace.ops),
            window_s=run.window_s)
        bd = breakdown(run.trace, run.spans, run.main_tid)
    return result_line(correct, run.attempted, failed, metrics, device_info,
                       bd, checks, info)


def result_line(correct: bool, attempted: int, failed: int,
                metrics: dict | None, device: dict | None,
                breakdown: dict | None, checks: dict, info: dict) -> dict:
    """The run's result, keys in the order the line prints them:
    ``checks`` last. A rehearsal (no ``device``) carries no metrics."""
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed}
    if device is None:
        out["rehearsal"] = True
    else:
        out["metrics"] = metrics
        out["device"] = device
        if breakdown is not None:
            out["breakdown"] = breakdown
    out["info"] = info
    out["checks"] = checks
    return out
