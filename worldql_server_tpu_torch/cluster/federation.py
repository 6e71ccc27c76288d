"""Metrics federation: one /metrics for the whole fleet.

Before this module, diagnosing a slow cluster meant hand-correlating
N+1 separate /metrics scrapes (router + every shard). Now each shard
piggybacks cumulative histogram/counter snapshots on the ~1s control
state packets it already sends (``shard.py _state_packet``), and the
router folds them into its OWN registry two ways:

* **Aggregates** under the shard's original series name — scraping the
  router answers cluster-wide questions (``cluster.e2e_ms`` p99 across
  every process, total ``messages.local_message``) with one request.
* **Per-shard series** under ``cluster.shard.<i>.*`` (a shard-reported
  ``cluster.``-prefixed name drops the redundant prefix:
  ``cluster.e2e_ms`` → ``cluster.shard.0.e2e_ms``) — so a drowning
  shard stands out without a second scrape.

Restart-monotone by the delivery-worker idiom: the router diffs
each packet against the shard's PREVIOUS packet and merges only the
DELTA (``Metrics.merge_histogram`` / counter increments). A restarted
shard re-zeroes its cumulatives AND its baseline here
(:meth:`reset`, fired from ``on_shard_ready``), so the federated
series only ever grow — no counter-reset sawtooth, pinned by test
across a shard SIGKILL→restart.

``deliveries_per_s_per_core`` is the ROADMAP item 4 number, live:
delivery throughput (the shards' ``broadcast.sends`` counters) over
actual CPU-seconds burned by the fleet (``/proc/<pid>/stat`` utime +
stime of the router and every live shard process). On a box where N
processes time-share one core the gauge stays honest — CPU-seconds,
not wall-seconds, is the denominator.

Freshness (the delivery plane's ``stats_stale`` idiom, process-to-process): the
router tracks each shard's last packet age; a wedged-but-alive shard
whose telemetry went silent surfaces as ``telemetry_stale`` in
/healthz instead of silently freezing its federated series.
"""

from __future__ import annotations

import logging
import os
import time

logger = logging.getLogger(__name__)

#: a shard pushes state at least every STATE_INTERVAL_S (shard.py);
#: > 3 missed intervals == stale (the delivery-plane horizon)
TELEMETRY_STALE_S = 3.5

#: minimum sampling window for the per-core rate gauge — scrapes more
#: frequent than this reuse the last computed rate
RATE_WINDOW_S = 1.0


def _proc_cpu_s(pid: int, clk_tck: float) -> float:
    """utime+stime of one process in seconds (0.0 when unreadable —
    a just-died shard must not break the gauge)."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            raw = f.read()
        # comm may contain spaces/parens: fields start after the last ')'
        fields = raw[raw.rindex(b")") + 2:].split()
        # fields[11]/[12] are utime/stime (stat fields 14/15, 1-based)
        return (int(fields[11]) + int(fields[12])) / clk_tck
    except Exception:
        return 0.0


class MetricsFederation:
    """Router-side fold of every shard's telemetry into one registry."""

    def __init__(self, metrics, n_shards: int):
        self.metrics = metrics
        self.n_shards = n_shards
        self._prev_counters: list[dict] = [{} for _ in range(n_shards)]
        self._prev_hists: list[dict] = [{} for _ in range(n_shards)]
        self._last_at = [0.0] * n_shards
        self._pids: dict[int, int] = {}
        self._router_pid = os.getpid()
        try:
            self._clk_tck = float(os.sysconf("SC_CLK_TCK")) or 100.0
        except (ValueError, OSError, AttributeError):
            self._clk_tck = 100.0
        self.packets = 0
        #: monotone cluster-wide delivery total (the rate numerator)
        self._sends_total = 0
        self._rate_prev: tuple[float, int, float] | None = None
        self._rate = 0.0

    # region: shard lifecycle

    def reset(self, shard: int) -> None:
        """A shard (re)booted: drop its diff baselines so its fresh
        cumulative state merges as a new delta, never a subtraction —
        the restart-monotone contract."""
        self._prev_counters[shard] = {}
        self._prev_hists[shard] = {}

    def note_pid(self, shard: int, pid: int | None) -> None:
        if pid:
            self._pids[shard] = pid

    # endregion

    # region: packet ingestion (router loop, one writer)

    @staticmethod
    def shard_series(shard: int, name: str) -> str:
        stem = name
        if stem.startswith("cluster.") and not stem.startswith(
            "cluster.shard."
        ):
            stem = stem[len("cluster."):]
        return f"cluster.shard.{shard}.{stem}"

    def ingest(self, shard: int, packet: dict) -> None:
        """Fold one state packet's counter/histogram snapshots into
        the router registry (aggregate + per-shard series). Never
        raises — a malformed packet degrades to freshness-only."""
        self._last_at[shard] = time.monotonic()
        self.packets += 1
        try:
            self._ingest_counters(shard, packet.get("counters") or {})
            self._ingest_hists(shard, packet.get("hist") or {})
        except Exception:
            logger.exception(
                "federation: bad telemetry packet from shard %d", shard
            )

    def _ingest_counters(self, shard: int, counters: dict) -> None:
        prev = self._prev_counters[shard]
        for name, cur in counters.items():
            if not isinstance(cur, (int, float)):
                continue
            cur = int(cur)
            last = prev.get(name, 0)
            # a cumulative that shrank means the shard re-zeroed
            # mid-baseline (torn restart): re-baseline from the full
            # value rather than subtracting into negatives
            delta = cur - last if cur >= last else cur
            prev[name] = cur
            if delta <= 0:
                continue
            self.metrics.inc(name, delta)
            self.metrics.inc(self.shard_series(shard, name), delta)
            if name == "broadcast.sends":
                self._sends_total += delta

    def _ingest_hists(self, shard: int, hists: dict) -> None:
        prev_all = self._prev_hists[shard]
        for name, cur in hists.items():
            if not isinstance(cur, dict) or "counts" not in cur:
                continue
            prev = prev_all.get(name)
            prev_counts = (prev or {}).get("counts") or []
            deltas = [
                int(c) - int(prev_counts[i])
                if i < len(prev_counts) else int(c)
                for i, c in enumerate(cur["counts"])
            ]
            if any(d < 0 for d in deltas):
                deltas = [int(c) for c in cur["counts"]]
                prev = None
            d_total = sum(deltas)
            d_sum = float(cur.get("sum_ms", 0.0)) - float(
                (prev or {}).get("sum_ms", 0.0)
            )
            max_ms = float(cur.get("max_ms", 0.0))
            prev_all[name] = cur
            # merge even a zero delta: the series appears in /metrics
            # from the shard's FIRST packet (the worker-plane contract)
            for series in (name, self.shard_series(shard, name)):
                self.metrics.merge_histogram(
                    series, deltas, d_total, max(d_sum, 0.0), max_ms
                )

    # endregion

    # region: freshness + the per-core efficiency gauge

    def telemetry_age_s(self, shard: int) -> float | None:
        """Seconds since the shard's last telemetry packet (None =
        never heard from this incarnation)."""
        at = self._last_at[shard]
        if not at:
            return None
        return max(0.0, time.monotonic() - at)

    def telemetry_stale(self, shard: int, alive_for_s: float | None = None
                        ) -> bool:
        """Silent-metrics-gap detection: stale once the last packet
        (or, before any packet, the shard's boot) is older than the
        3-interval horizon — a wedged-but-alive shard must not look
        healthy."""
        age = self.telemetry_age_s(shard)
        if age is None:
            return (
                alive_for_s is not None and alive_for_s > TELEMETRY_STALE_S
            )
        return age > TELEMETRY_STALE_S

    def fleet_cpu_s(self) -> float:
        """Cumulative CPU-seconds burned by the router + every shard
        process whose pid we know (dead pids read as 0)."""
        total = _proc_cpu_s(self._router_pid, self._clk_tck)
        for pid in self._pids.values():
            total += _proc_cpu_s(pid, self._clk_tck)
        return total

    def deliveries_per_s_per_core(self) -> float:
        """ROADMAP item 4's per-core efficiency number, live: delivery
        throughput per CPU-second across the whole fleet (Δ
        broadcast.sends ÷ Δ cpu-seconds over the sampling window).
        0.0 until two samples ≥ RATE_WINDOW_S apart exist."""
        now = time.monotonic()
        if self._rate_prev is None:
            self._rate_prev = (now, self._sends_total, self.fleet_cpu_s())
            return 0.0
        t0, sends0, cpu0 = self._rate_prev
        if now - t0 >= RATE_WINDOW_S:
            cpu = self.fleet_cpu_s()
            d_cpu = cpu - cpu0
            d_sends = self._sends_total - sends0
            if d_cpu > 0:
                self._rate = d_sends / d_cpu
            self._rate_prev = (now, self._sends_total, cpu)
        return round(self._rate, 1)

    # endregion

    def stats(self) -> dict:
        """The ``cluster_federation`` gauge body."""
        ages = [self.telemetry_age_s(i) for i in range(self.n_shards)]
        return {
            "packets": self.packets,
            "sends_total": self._sends_total,
            "stale_shards": sum(
                1 for i in range(self.n_shards) if self.telemetry_stale(i)
            ),
            "oldest_telemetry_s": round(
                max((a for a in ages if a is not None), default=-1.0), 3
            ),
        }
