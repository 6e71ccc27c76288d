"""Shared arithmetic of the metric readers in ``metrics/``.

Each reader is a file ``metrics/<name>.py`` with ``read(run)``, which
returns the metric's value or ``None`` when the run has nothing for it
to read; the harness then leaves the metric out. A reader of a metric
with the suffix ``.local`` reads runs of LocalMessage batches, one with
``.queries`` runs of staged queries (``Run.kind``).
"""

from __future__ import annotations

import math

from .roofline import PEAKS, fanout_bytes
from .trace import union_length


def applies(run, suffix: str) -> bool:
    return run.kind == suffix


def rate(run) -> float | None:
    """Work of the window's completed ticks over the window's length."""
    if not run.ticks or run.window_s <= 0:
        return None
    return sum(tk.m for tk in run.ticks) / run.window_s


def card_us_per_k(run) -> float | None:
    """Card time over all the window's work: microseconds of device
    activity per 1,000 messages or queries dispatched in it."""
    if not run.card_busy_s or not run.attempted:
        return None
    return 1e9 * run.card_busy_s / run.attempted


def span_mean_ms(run, name: str) -> float | None:
    """Mean wall of the span ``name`` per window tick, in ms."""
    spans = run.in_window(name)
    if not spans or not run.ticks:
        return None
    return 1e3 * sum(spans) / len(run.ticks)


def p95(values) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def tick_p95_ms(run) -> float | None:
    """Dispatch start to collected, per window tick, 95th percentile."""
    if not run.ticks:
        return None
    return 1e3 * p95(tk.c1 - tk.d0 for tk in run.ticks)


def device_idle_pct(run) -> float | None:
    if run.trace is None or not run.trace.ops or run.window_s <= 0:
        return None
    busy = union_length((o.t0, o.t1) for o in run.trace.ops)
    return 100.0 * (1.0 - busy / run.window_s)


def fanout_roofline_pct(run) -> float | None:
    """Share of the bandwidth roofline reached by the device work the
    window's fan-out launched (the harness's ``dispatch`` and ``collect``
    spans), against the bytes its batches need."""
    card = PEAKS.get(run.device_kind or "")
    if run.trace is None or not run.trace.attributed or card is None:
        return None
    busy = union_length(
        (o.t0, o.t1) for o in run.trace.ops
        if o.span in ("dispatch", "collect"))
    if busy <= 0:
        return None
    live = 1.0 - run.reused_share
    rows = live * sum(tk.m for tk in run.ticks)
    lanes = live * sum(tk.delivered for tk in run.ticks)
    least_s = fanout_bytes(int(rows), int(lanes)) / card["hbm_bytes_per_s"]
    return 100.0 * least_s / busy

