"""Tick flight recorder: span tracing, slow-tick dumps, loop health.

The diagnostic substrate under every perf change: ``spans``
records per-stage wall time for every tick and message,
``flight_recorder`` keeps the last N tick traces and auto-dumps slow
ones, ``export`` renders Chrome-trace JSON for ``GET /debug/ticks``
and hosts the ``torch.profiler`` hook, ``loop_monitor`` separates a
blocked event loop from a slow device, and ``device`` tags each tick
with the index's encode/h2d/compute/d2h split.
"""

from .flight_recorder import FlightRecorder
from .loop_monitor import LoopMonitor
from .spans import NOOP_SPAN, NULL_TRACE, Trace, Tracer
from .export import ProfilerHook, chrome_trace

__all__ = [
    "FlightRecorder",
    "LoopMonitor",
    "NOOP_SPAN",
    "NULL_TRACE",
    "ProfilerHook",
    "Trace",
    "Tracer",
    "chrome_trace",
]
