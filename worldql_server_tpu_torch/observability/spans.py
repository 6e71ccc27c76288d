"""Lightweight span tracing: the causal substrate of the flight recorder.

The aggregate histograms in ``engine/metrics.py`` can say a tick was
slow; they can never say *why* — BENCH_r05's 207 s ``p99_ms_depth2``
outlier could only be explained structurally because no record of that
one tick survived. This module records per-tick, per-stage wall time
the way TPU-KNN (arXiv:2206.14286) accounts a device query pipeline:
every stage of every tick is a :class:`Span` inside a causally-linked
:class:`Trace`, cheap enough to leave on in production and (following
``utils/trace.py``'s one-branch-when-off discipline) near-free when
off — ``Tracer.begin``/``Tracer.span`` cost one attribute check and
return shared null singletons that swallow everything.

Thread-safety: the ticker's collect stage runs on a worker thread and
the WAL writer thread emits fsync spans, so ``Trace.add`` takes a small
lock and parent links ride a :mod:`contextvars` var (copied into
``asyncio.to_thread`` and ``create_task``, so spans opened inside a
pipelined stage task still attach to their tick's trace).

Two entry points:

* ``tracer.begin(name, **tags)`` — an explicit trace object for flows
  that cross task boundaries (the pipelined tick: dispatch on the
  loop, collect+deliver in a chained stage task). The caller threads
  the ``Trace`` through and calls ``trace.span(...)`` / ``finish()``.
* ``tracer.span(name, **tags)`` — a context manager that attaches to
  the current trace if one is active, else records a single-span
  "loose" trace (per-message router handles, WAL fsyncs); finished
  root traces are handed to ``tracer.on_trace`` (the flight recorder).
"""

from __future__ import annotations

import contextvars
import threading
import time

#: (Trace, parent_span_id) of the innermost open span, per context
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "wql_current_span", default=None
)


class Span:
    """One completed (or open) stage: name + wall window + tags, and
    the thread it ran on: its name, and its native id (``tid``, the
    thread id of a ``torch.profiler`` chrome trace's host ops, so the
    device ops they launch can be tied to the span)."""

    __slots__ = ("id", "parent", "name", "t0", "dur_ms", "tags", "thread",
                 "tid")

    def __init__(self, id, parent, name, t0, tags, thread):
        self.id = id
        self.parent = parent
        self.name = name
        self.t0 = t0           # perf_counter seconds
        self.dur_ms = 0.0
        self.tags = tags
        # the Thread object's own copy: get_native_id() is a syscall
        self.thread = thread.name
        self.tid = thread.native_id

    def tag(self, **tags) -> None:
        """Late tags (values known only at stage end) — same surface
        as ``_NullSpan.tag`` so callers never branch on enablement."""
        self.tags.update(tags)

    def as_dict(self, perf_start: float) -> dict:
        return {
            "id": self.id,
            "parent": self.parent,
            "name": self.name,
            "t0_ms": round((self.t0 - perf_start) * 1e3, 3),
            "dur_ms": round(self.dur_ms, 3),
            "tags": self.tags,
            "thread": self.thread,
        }


class Trace:
    """A finished-or-in-flight span tree (one tick, or one loose op)."""

    __slots__ = (
        "name", "tags", "wall_start", "perf_start", "dur_ms", "spans",
        "_lock", "_next_id", "_on_finish", "_done",
    )

    def __init__(self, name: str, on_finish=None, **tags):
        self.name = name
        self.tags = tags
        self.wall_start = time.time()
        self.perf_start = time.perf_counter()
        self.dur_ms = 0.0
        self.spans: list[Span] = []
        self._lock = threading.Lock()
        self._next_id = 0
        self._on_finish = on_finish
        self._done = False

    def span(self, name: str, **tags) -> "_SpanCtx":
        """Open a child span in THIS trace (parented to the innermost
        open span of the calling context, or the trace root)."""
        return _SpanCtx(self, name, tags)

    def tag(self, **tags) -> None:
        self.tags.update(tags)

    def add(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def _new_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    def finish(self) -> None:
        """Seal the trace (idempotent) and hand it to the sink."""
        if self._done:
            return
        self._done = True
        self.dur_ms = (time.perf_counter() - self.perf_start) * 1e3
        if self._on_finish is not None:
            self._on_finish(self)

    def stage_ms(self) -> dict[str, float]:
        """Per-span-name wall-time totals — the breakdown a slow-tick
        dump leads with. Only TOP-LEVEL spans (parent is the trace
        root) are summed, so nested child spans don't double-count
        their parents' wall."""
        out: dict[str, float] = {}
        with self._lock:
            for s in self.spans:
                if s.parent is None:
                    out[s.name] = out.get(s.name, 0.0) + s.dur_ms
        return out

    def as_dict(self) -> dict:
        with self._lock:
            spans = [s.as_dict(self.perf_start) for s in self.spans]
        return {
            "name": self.name,
            "tags": self.tags,
            "start_unix_s": round(self.wall_start, 6),
            "dur_ms": round(self.dur_ms, 3),
            "spans": spans,
        }


class _SpanCtx:
    """Context manager recording one span into a known trace; sets the
    parent-link context var for the duration so nested ``tracer.span``
    calls attach underneath."""

    __slots__ = ("_trace", "_name", "_tags", "_span", "_token", "_root")

    def __init__(self, trace: Trace, name: str, tags: dict, root=False):
        self._trace = trace
        self._name = name
        self._tags = tags
        self._span = None
        self._token = None
        self._root = root

    def __enter__(self):
        trace = self._trace
        cur = _CURRENT.get()
        parent = cur[1] if cur is not None and cur[0] is trace else None
        self._span = Span(
            trace._new_id(), parent, self._name, time.perf_counter(),
            self._tags, threading.current_thread(),
        )
        self._token = _CURRENT.set((trace, self._span.id))
        return self._span

    def __exit__(self, *exc) -> bool:
        span = self._span
        span.dur_ms = (time.perf_counter() - span.t0) * 1e3
        _CURRENT.reset(self._token)
        self._trace.add(span)
        if self._root:
            self._trace.finish()
        return False


class _NullSpan:
    """Shared do-nothing span/context-manager for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def tag(self, **tags) -> None:
        pass


class _NullTrace:
    """Shared do-nothing trace for the disabled path."""

    __slots__ = ()
    dur_ms = 0.0

    def span(self, name: str, **tags) -> _NullSpan:
        return NOOP_SPAN

    def tag(self, **tags) -> None:
        pass

    def finish(self) -> None:
        pass

    def stage_ms(self) -> dict:
        return {}

    def as_dict(self) -> dict:
        return {}


NOOP_SPAN = _NullSpan()
NULL_TRACE = _NullTrace()


class Tracer:
    """Per-server tracing switchboard. ``enabled`` is THE one branch
    the disabled hot path pays; ``on_trace`` receives every finished
    root trace (the flight recorder's ``record``)."""

    __slots__ = ("enabled", "on_trace")

    def __init__(self, enabled: bool = False, on_trace=None):
        self.enabled = enabled
        self.on_trace = on_trace

    def begin(self, name: str, **tags):
        """Start an explicit trace (the tick root). Returns the shared
        null trace when disabled — callers never branch."""
        if not self.enabled:
            return NULL_TRACE
        return Trace(name, on_finish=self._emit, **tags)

    def span(self, name: str, **tags):
        """A span in the current context's trace; with no trace active
        it becomes its own single-span loose trace (per-message router
        handles, WAL fsyncs from the writer thread)."""
        if not self.enabled:
            return NOOP_SPAN
        cur = _CURRENT.get()
        if cur is not None:
            return _SpanCtx(cur[0], name, tags)
        trace = Trace(name, on_finish=self._emit, **tags)
        return _SpanCtx(trace, name, tags, root=True)

    def record(self, name: str, t0: float, t1: float, **tags) -> None:
        """A finished span from the caller's own ``perf_counter`` reads
        (a stage whose wall the caller also keeps, such as the index's
        device-timing legs): attached like :meth:`span`, to the current
        context's trace under its innermost open span, else loose."""
        if not self.enabled:
            return
        cur = _CURRENT.get()
        if cur is not None:
            trace, parent = cur
        else:
            trace, parent = Trace(name, on_finish=self._emit, **tags), None
            # a loose trace starts with its one span, not now
            trace.wall_start -= trace.perf_start - t0
            trace.perf_start = t0
        span = Span(trace._new_id(), parent, name, t0, tags,
                    threading.current_thread())
        span.dur_ms = (t1 - t0) * 1e3
        trace.add(span)
        if cur is None:
            trace.finish()

    def _emit(self, trace: Trace) -> None:
        if self.on_trace is not None:
            try:
                self.on_trace(trace)
            except Exception:  # a broken sink must never break a tick
                import logging

                logging.getLogger(__name__).exception(
                    "trace sink failed for %r", trace.name
                )
