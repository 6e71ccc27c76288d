"""SLO registry + multi-window burn-rate sentinel.

Turns the telemetry the fleet already records into a *judgment* layer:
declarative objectives over existing metric series, evaluated every
``eval_interval_s`` by a supervised ``slo-eval`` task from the same
cumulative histogram/counter state that ``/metrics`` renders.  Each
objective carries a fast and a slow window (Google-SRE multi-window
burn-rate alerting): the fast window trips quickly on an acute breach,
the slow window confirms it is sustained, and the pair drives a
three-state machine per objective::

    OK(0) -> WARN(1) -> BURNING(2)

* ``burn >= 1`` on BOTH windows  => BURNING
* ``burn >= 1`` on either window => WARN
* otherwise                      => OK

so recovery drains back BURNING -> WARN -> OK as the windows clear.
A transition INTO ``BURNING`` fires :attr:`SloEngine.on_burning`
(wired to the incident recorder by the server; debounced there).

Objective kinds
---------------

``latency_p99``
    ``series`` is a histogram; the objective is "at most ``budget``
    (fraction) of observations in the window may exceed ``target_ms``".
    burn = bad_fraction / budget.  Default targets are aligned with
    :data:`~worldql_server_tpu_torch.engine.metrics.LATENCY_BUCKETS_MS` bucket
    edges so the over-target count is exact, not interpolated.
``rate``
    ``series`` is a counter; the objective is "at most ``max_per_s``
    events per second over the window".  burn = rate / max_per_s.
``gauge_floor``
    ``series`` is a pull gauge; the objective is "the gauge must stay
    at or above ``floor``".  burn per sample = floor / value when the
    value is positive and below the floor; a window's burn is the mean
    of its samples' burns.  A gauge that is absent or still warming up
    (``<= 0``) contributes no burn — floors only judge measured data.

``DEFAULT_OBJECTIVES`` below is a pure literal on purpose: the
``unexported-slo-series`` lint rule reads the ``series`` names straight
out of this tuple and fails the build if the repo has no call site that
can produce one of them (an SLO over a phantom series is dead config).

Overrides ride ``--slo-file`` (JSON): either a bare list of objective
dicts, or ``{"eval_interval_s": ..., "objectives": [...]}``.  A file
REPLACES the default registry so tests and operators can pin exactly
the objectives (and windows) they mean.
"""

from __future__ import annotations

import asyncio
import collections
import json
import logging
import time
from typing import Any, Callable

from ..engine.metrics import LATENCY_BUCKETS_MS, Metrics

log = logging.getLogger("worldql.slo")

OK = 0
WARN = 1
BURNING = 2

STATE_NAMES = {OK: "ok", WARN: "warn", BURNING: "burning"}

#: Default evaluation cadence, aligned with the shards' ~1s control
#: packets so fleet state federates at the same rhythm.
EVAL_INTERVAL_S = 1.0

#: How many recent evaluations each objective keeps for its burn
#: trajectory (what the incident capsule embeds).
TRAJECTORY_DEPTH = 120

_KINDS = ("latency_p99", "rate", "gauge_floor")

# Pure literal — read by tools/check rule `unexported-slo-series`.
DEFAULT_OBJECTIVES = (
    {
        "name": "frame_e2e_p99",
        "series": "frame.e2e_ms",
        "kind": "latency_p99",
        "target_ms": 5.0,
        "budget": 0.01,
        "fast_s": 10.0,
        "slow_s": 60.0,
    },
    {
        "name": "cluster_e2e_p99",
        "series": "cluster.e2e_ms",
        "kind": "latency_p99",
        "target_ms": 25.0,
        "budget": 0.01,
        "fast_s": 10.0,
        "slow_s": 60.0,
    },
    {
        "name": "ring_full_drops",
        "series": "delivery.ring_full_drops",
        "kind": "rate",
        "max_per_s": 1.0,
        "fast_s": 10.0,
        "slow_s": 60.0,
    },
    {
        "name": "interest_resyncs",
        "series": "interest.resyncs",
        "kind": "rate",
        "max_per_s": 5.0,
        "fast_s": 10.0,
        "slow_s": 60.0,
    },
    {
        "name": "per_core_floor",
        "series": "deliveries_per_s_per_core",
        "kind": "gauge_floor",
        "floor": 10000.0,
        "fast_s": 10.0,
        "slow_s": 60.0,
    },
    {
        "name": "wal_fsync_p99",
        "series": "durability.fsync_ms",
        "kind": "latency_p99",
        "target_ms": 25.0,
        "budget": 0.01,
        "fast_s": 10.0,
        "slow_s": 60.0,
    },
)


def validate_objective(obj: dict) -> None:
    """Raise ``ValueError`` on a malformed objective dict."""
    if not isinstance(obj, dict):
        raise ValueError(f"slo objective must be an object, got {type(obj).__name__}")
    name = obj.get("name")
    if not name or not isinstance(name, str):
        raise ValueError("slo objective missing 'name'")
    if not all(c.isalnum() or c == "_" for c in name):
        raise ValueError(f"slo objective name {name!r} must be [A-Za-z0-9_]")
    if not obj.get("series") or not isinstance(obj.get("series"), str):
        raise ValueError(f"slo objective {name!r} missing 'series'")
    kind = obj.get("kind")
    if kind not in _KINDS:
        raise ValueError(f"slo objective {name!r} kind {kind!r} not in {_KINDS}")
    if kind == "latency_p99":
        if float(obj.get("target_ms", 0)) <= 0:
            raise ValueError(f"slo objective {name!r} needs target_ms > 0")
        budget = float(obj.get("budget", 0.01))
        if not 0 < budget <= 1:
            raise ValueError(f"slo objective {name!r} budget must be in (0, 1]")
    elif kind == "rate":
        if float(obj.get("max_per_s", 0)) <= 0:
            raise ValueError(f"slo objective {name!r} needs max_per_s > 0")
    elif kind == "gauge_floor":
        if float(obj.get("floor", 0)) <= 0:
            raise ValueError(f"slo objective {name!r} needs floor > 0")
    for win in ("fast_s", "slow_s"):
        if float(obj.get(win, 1.0)) <= 0:
            raise ValueError(f"slo objective {name!r} needs {win} > 0")
    if float(obj.get("fast_s", 10.0)) > float(obj.get("slow_s", 60.0)):
        raise ValueError(f"slo objective {name!r} fast_s must be <= slow_s")


def load_objectives(path: str | None) -> tuple[float, list[dict]]:
    """Load ``(eval_interval_s, objectives)`` from a ``--slo-file`` JSON
    document, or the built-in defaults when ``path`` is ``None``.  The
    file replaces the default registry wholesale."""
    if path is None:
        return EVAL_INTERVAL_S, [dict(o) for o in DEFAULT_OBJECTIVES]
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if isinstance(doc, list):
        interval, objectives = EVAL_INTERVAL_S, doc
    elif isinstance(doc, dict):
        interval = float(doc.get("eval_interval_s", EVAL_INTERVAL_S))
        objectives = doc.get("objectives")
        if not isinstance(objectives, list):
            raise ValueError("slo file object needs an 'objectives' list")
    else:
        raise ValueError("slo file must be a JSON list or object")
    if interval <= 0:
        raise ValueError("slo file eval_interval_s must be > 0")
    if not objectives:
        raise ValueError("slo file declares no objectives")
    seen: set[str] = set()
    out = []
    for obj in objectives:
        validate_objective(obj)
        if obj["name"] in seen:
            raise ValueError(f"duplicate slo objective name {obj['name']!r}")
        seen.add(obj["name"])
        out.append(dict(obj))
    return interval, out


def _over_target_index(target_ms: float) -> int:
    """First bucket index whose upper bound exceeds ``target_ms`` —
    deltas from that index up (incl. overflow) count as over-target."""
    for i, bound in enumerate(LATENCY_BUCKETS_MS):
        if bound > target_ms:
            return i
    return len(LATENCY_BUCKETS_MS)


class _Objective:
    """One declared objective plus its live burn/state bookkeeping."""

    def __init__(self, spec: dict) -> None:
        validate_objective(spec)
        self.spec = dict(spec)
        self.name: str = spec["name"]
        self.series: str = spec["series"]
        self.kind: str = spec["kind"]
        self.fast_s = float(spec.get("fast_s", 10.0))
        self.slow_s = float(spec.get("slow_s", 60.0))
        self.level = OK
        self.burn_fast = 0.0
        self.burn_slow = 0.0
        self.value: float | None = None  # window p99 / rate / gauge value
        self.transitions = 0
        self.last_transition_t: float | None = None
        self.trajectory: collections.deque = collections.deque(
            maxlen=TRAJECTORY_DEPTH
        )
        if self.kind == "latency_p99":
            self._over_idx = _over_target_index(float(spec["target_ms"]))

    # -- window burn computation ------------------------------------

    def _window_burn(self, newest: "_Sample", oldest: "_Sample") -> float:
        if self.kind == "latency_p99":
            cur = newest.hists.get(self.series)
            old = oldest.hists.get(self.series)
            if cur is None:
                return 0.0
            if old is None:
                old_counts, old_total = None, 0
            else:
                old_counts, old_total = old
            counts, total = cur
            d_total = total - old_total
            if d_total <= 0:
                return 0.0
            bad = 0
            for i in range(self._over_idx, len(counts)):
                prev = old_counts[i] if old_counts is not None else 0
                bad += counts[i] - prev
            if bad < 0:  # counter reset (restart) — re-baseline quietly
                return 0.0
            frac = bad / d_total
            self.value = round(frac, 6)
            return frac / float(self.spec.get("budget", 0.01))
        if self.kind == "rate":
            cur = newest.counters.get(self.series, 0)
            old = oldest.counters.get(self.series, 0)
            span = max(newest.t - oldest.t, 1e-9)
            delta = cur - old
            if delta < 0:  # reset
                return 0.0
            rate = delta / span
            self.value = round(rate, 3)
            return rate / float(self.spec["max_per_s"])
        # gauge_floor: mean of per-sample burns across the window.
        floor = float(self.spec["floor"])
        burns = []
        for sample in (oldest, newest):
            val = sample.gauges.get(self.series)
            if val is None or val <= 0:
                continue
            self.value = val
            burns.append(floor / val if val < floor else 0.0)
        return sum(burns) / len(burns) if burns else 0.0

    def evaluate(self, now: float, newest, fast_old, slow_old) -> tuple[int, int]:
        """Recompute burns + state; returns ``(old_level, new_level)``."""
        self.value = None
        self.burn_fast = round(self._window_burn(newest, fast_old), 4)
        self.burn_slow = round(self._window_burn(newest, slow_old), 4)
        old = self.level
        if self.burn_fast >= 1.0 and self.burn_slow >= 1.0:
            new = BURNING
        elif self.burn_fast >= 1.0 or self.burn_slow >= 1.0:
            new = WARN
        else:
            new = OK
        if new != old:
            self.transitions += 1
            self.last_transition_t = now
            log.log(
                logging.WARNING if new > old else logging.INFO,
                "slo objective %s: %s -> %s (burn fast=%.2f slow=%.2f)",
                self.name, STATE_NAMES[old], STATE_NAMES[new],
                self.burn_fast, self.burn_slow,
            )
        self.level = new
        self.trajectory.append(
            {
                "t": round(now, 3),
                "burn_fast": self.burn_fast,
                "burn_slow": self.burn_slow,
                "level": new,
            }
        )
        return old, new

    @property
    def budget_remaining(self) -> float:
        """Fraction of the slow window's error budget still unspent."""
        return round(max(0.0, 1.0 - self.burn_slow), 4)

    def status(self) -> dict:
        out = {
            "series": self.series,
            "kind": self.kind,
            "state": STATE_NAMES[self.level],
            "level": self.level,
            "burn_fast": self.burn_fast,
            "burn_slow": self.burn_slow,
            "budget_remaining": self.budget_remaining,
            "transitions": self.transitions,
            "windows": {"fast_s": self.fast_s, "slow_s": self.slow_s},
        }
        if self.kind == "latency_p99":
            out["target_ms"] = float(self.spec["target_ms"])
            out["budget"] = float(self.spec.get("budget", 0.01))
            if self.value is not None:
                out["bad_fraction"] = self.value
        elif self.kind == "rate":
            out["max_per_s"] = float(self.spec["max_per_s"])
            if self.value is not None:
                out["rate_per_s"] = self.value
        else:
            out["floor"] = float(self.spec["floor"])
            if self.value is not None:
                out["value"] = self.value
        return out


class _Sample:
    """One timestamped cumulative snapshot of every referenced series."""

    __slots__ = ("t", "hists", "counters", "gauges")

    def __init__(self, t: float, hists: dict, counters: dict, gauges: dict):
        self.t = t
        self.hists = hists
        self.counters = counters
        self.gauges = gauges


class SloEngine:
    """Evaluates the objective registry against a :class:`Metrics`
    registry on a fixed cadence, keeping just enough cumulative history
    to diff the slow window.  One instance per process: shards and the
    single-process server judge their local registry; the router's
    instance judges the federated registry (which already folds every
    shard's series in) and additionally mirrors the per-shard compliance
    summaries that piggyback the ~1s control packets."""

    def __init__(
        self,
        metrics: Metrics,
        objectives: list[dict] | None = None,
        *,
        eval_interval_s: float = EVAL_INTERVAL_S,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if objectives is None:
            _, objectives = load_objectives(None)
        self.metrics = metrics
        self.clock = clock
        self.eval_interval_s = float(eval_interval_s)
        self.objectives = [_Objective(o) for o in objectives]
        #: Called with the objective on any transition INTO ``BURNING``
        #: (wired to the incident recorder; debounce lives there).
        self.on_burning: Callable[[_Objective], None] | None = None
        self._series_h = sorted(
            {o.series for o in self.objectives if o.kind == "latency_p99"}
        )
        self._series_c = sorted(
            {o.series for o in self.objectives if o.kind == "rate"}
        )
        self._series_g = sorted(
            {o.series for o in self.objectives if o.kind == "gauge_floor"}
        )
        slow_max = max(o.slow_s for o in self.objectives)
        depth = int(slow_max / self.eval_interval_s) + 3
        self._ring: collections.deque = collections.deque(maxlen=depth)
        self.evals = 0
        # Per-shard compliance mirrored off control packets (router only).
        self._remote: dict[int, dict] = {}

    # -- sampling ---------------------------------------------------

    def _snap(self, now: float) -> _Sample:
        hists = {}
        if self._series_h:
            raw = self.metrics.export_histograms(tuple(self._series_h))
            for name, h in raw.items():
                if name in self._series_h:
                    hists[name] = (h["counts"], h["total"])
        counters = {
            name: self.metrics.counters.get(name, 0) for name in self._series_c
        }
        gauges = {}
        for name in self._series_g:
            val = self.metrics.gauge_value(name)
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                gauges[name] = float(val)
        return _Sample(now, hists, counters, gauges)

    def _window_anchor(self, now: float, window_s: float) -> _Sample:
        """Newest sample at least ``window_s`` old; falls back to the
        oldest retained sample while history is still shorter than the
        window (partial-window evaluation, same as a cold SRE alert)."""
        anchor = self._ring[0]
        for sample in self._ring:
            if now - sample.t >= window_s:
                anchor = sample
            else:
                break
        return anchor

    # -- evaluation -------------------------------------------------

    def evaluate(self) -> None:
        now = self.clock()
        sample = self._snap(now)
        self._ring.append(sample)
        self.evals += 1
        for obj in self.objectives:
            fast_old = self._window_anchor(now, obj.fast_s)
            slow_old = self._window_anchor(now, obj.slow_s)
            old, new = obj.evaluate(now, sample, fast_old, slow_old)
            if new == BURNING and old != BURNING and self.on_burning:
                try:
                    self.on_burning(obj)
                except Exception:  # noqa: BLE001 — alerting must not kill eval
                    log.exception("slo on_burning hook failed for %s", obj.name)

    async def run(self) -> None:
        """Supervised ``slo-eval`` loop body."""
        while True:
            await asyncio.sleep(self.eval_interval_s)
            self.evaluate()

    # -- exports ----------------------------------------------------

    @property
    def worst_level(self) -> int:
        worst = max((o.level for o in self.objectives), default=OK)
        for remote in self._remote.values():
            worst = max(worst, int(remote.get("worst", OK)))
        return worst

    def gauge(self) -> dict:
        """Pull-gauge payload: numeric per-objective levels flatten to
        ``wql_slo_<name>`` in the Prometheus exposition."""
        out: dict[str, Any] = {o.name: o.level for o in self.objectives}
        out["worst"] = self.worst_level
        return out

    def compliance(self) -> dict:
        """Compact summary shards piggyback on control packets."""
        return {
            "levels": {o.name: o.level for o in self.objectives},
            "burns": {o.name: o.burn_slow for o in self.objectives},
            "worst": max((o.level for o in self.objectives), default=OK),
        }

    def note_remote(self, shard: int, compliance: dict | None) -> None:
        """Router side: fold one shard's piggybacked compliance in."""
        if isinstance(compliance, dict):
            self._remote[int(shard)] = compliance

    def drop_remote(self, shard: int) -> None:
        self._remote.pop(int(shard), None)

    def status(self) -> dict:
        """Full report for ``GET /debug/slo`` and the healthz block."""
        out: dict[str, Any] = {
            "state": STATE_NAMES[self.worst_level],
            "worst": self.worst_level,
            "evals": self.evals,
            "eval_interval_s": self.eval_interval_s,
            "objectives": {o.name: o.status() for o in self.objectives},
        }
        if self._remote:
            out["shards"] = {str(k): v for k, v in sorted(self._remote.items())}
        return out

    def healthz(self) -> dict:
        """Compact block for ``/healthz``."""
        return {
            "state": STATE_NAMES[self.worst_level],
            "burning": [o.name for o in self.objectives if o.level == BURNING],
        }

    def trajectory(self, name: str) -> list[dict]:
        for obj in self.objectives:
            if obj.name == name:
                return list(obj.trajectory)
        return []
