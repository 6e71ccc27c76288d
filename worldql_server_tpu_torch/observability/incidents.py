"""Incident recorder: one correlated capsule per burn, debounced.

When an SLO objective transitions into ``BURNING`` the evidence for
*why* is scattered across subsystems — the flight recorder has the slow
spans, the governor knows what it shed, placement knows whether a
migration was in flight, the interest ledger knows who resynced, device
telemetry knows whether a retrace storm hit, and the failpoint registry
knows what chaos was armed.  This module captures all of it in ONE
JSON bundle the moment the burn starts (debounced by
``--incident-cooldown`` so a flapping objective yields exactly one
capsule per cooldown window), written into a bounded ring of files
under ``--incident-dir`` and listed/fetchable at ``GET
/debug/incidents``.

The capsule's shape::

    {
      "id": "incident-0001-frame_e2e_p99",
      "at_unix_s": ...,
      "objective": {<triggering objective status>},
      "trajectory": [{t, burn_fast, burn_slow, level}, ...],
      "slo": {<full /debug/slo report at capture time>},
      "sections": {<this process's subsystem sections>},
      "shards": {"0": {<shard dump incl. its sections>}, ...}  # router only
    }

:func:`capsule_sections` is the ONE place that knows how to pull a
process's subsystem state; the shard dump op embeds the same sections
so the router's fleet capsule (pulled over the chunked control
path — the same helper ``GET /debug/cluster`` uses) carries every
process's view without a second snapshot protocol.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import re
import time
from typing import Any, Awaitable, Callable

from ..robustness import failpoints

log = logging.getLogger("worldql.incidents")

#: Bounded ring: newest N capsules are kept on disk, older deleted.
DEFAULT_KEEP = 16

_FILE_RE = re.compile(r"^incident-(\d{4})-([A-Za-z0-9_]+)\.json$")


def top_stage_attribution(recorder, n: int = 3) -> list[tuple[str, float]]:
    """Top-``n`` (stage, ms) pairs from the flight recorder's worst
    tick — what the CRITICAL incident log names as the likely culprits.
    Degrades to ``[]`` when tracing is off or nothing is recorded."""
    if recorder is None:
        return []
    try:
        worst = recorder.worst_tick()
        if worst is None:
            return []
        stages = worst.stage_ms()
    except Exception:  # noqa: BLE001 — attribution is best-effort
        log.exception("incident stage attribution failed")
        return []
    ranked = sorted(stages.items(), key=lambda kv: kv[1], reverse=True)
    return [(name, round(ms, 2)) for name, ms in ranked[:n]]


def capsule_sections(server) -> dict:
    """Every subsystem section this process can contribute to a
    capsule.  Sections for disabled subsystems report ``enabled: False``
    instead of vanishing so a capsule's shape is stable and a reader
    can tell "off" from "lost".  Each probe is fenced: one broken
    subsystem must not cost the rest of the evidence."""
    sections: dict[str, Any] = {}

    def probe(name: str, fn: Callable[[], Any]) -> None:
        try:
            sections[name] = fn()
        except Exception:  # noqa: BLE001
            log.exception("incident section %r probe failed", name)
            sections[name] = {"error": "probe failed"}

    recorder = getattr(server, "recorder", None)
    if recorder is not None:
        probe("flight_recorder", lambda: {
            "stats": recorder.stats(),
            "ticks": recorder.snapshot(),
            "loose": recorder.loose_snapshot(),
            "top_stages": top_stage_attribution(recorder),
        })
    else:
        sections["flight_recorder"] = {"enabled": False}

    governor = getattr(server, "governor", None)
    if governor is not None:
        probe("governor", lambda: {
            "status": governor.status(),
            "export": governor.export_state(),
        })
    else:
        sections["governor"] = {"enabled": False}

    cluster = getattr(server, "cluster", None)
    if cluster is not None:
        probe("placement", lambda: {
            "epoch": cluster.placement.epoch,
            "stats": cluster.stats(),
        })
    else:
        sections["placement"] = {"enabled": False, "epoch": 0}

    interest = getattr(server, "interest", None)
    if interest is not None:
        probe("interest", interest.stats)
    else:
        sections["interest"] = {"enabled": False}

    telemetry = getattr(server, "device_telemetry", None)
    if telemetry is not None:
        probe("device", telemetry.stats)
    else:
        sections["device"] = {"enabled": False}

    monitor = getattr(server, "loop_monitor", None)
    if monitor is not None:
        probe("loop_health", monitor.snapshot)
    else:
        sections["loop_health"] = {"enabled": False}

    probe("failpoints", lambda: dict(failpoints.registry.fired_counts()))
    return sections


class IncidentRecorder:
    """Debounced capsule writer over a bounded on-disk ring.

    ``collect`` (set by the owning process) is an async callable
    returning the capsule body — everything beyond the id/timestamp/
    trigger envelope.  The single-process server collects locally; the
    router additionally pulls every shard's dump over the shared
    chunked-control client so the fleet capsule and ``/debug/cluster``
    cannot drift apart."""

    def __init__(
        self,
        incident_dir: str,
        *,
        cooldown_s: float = 60.0,
        keep: int = DEFAULT_KEEP,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.dir = incident_dir
        self.cooldown_s = float(cooldown_s)
        self.keep = int(keep)
        self.metrics = metrics
        self.clock = clock
        self.collect: Callable[[], Awaitable[dict]] | None = None
        self.captured = 0
        self.suppressed = 0
        self.errors = 0
        self._last_capture_t: float | None = None
        self._seq = self._scan_seq()
        self._tasks: set[asyncio.Task] = set()

    # -- trigger + debounce -----------------------------------------

    def trigger(self, objective, slo_status: dict) -> bool:
        """Called from the SLO eval loop on a transition into BURNING.
        Returns True when a capture task was actually started (one per
        cooldown window)."""
        now = self.clock()
        if (
            self._last_capture_t is not None
            and now - self._last_capture_t < self.cooldown_s
        ):
            self.suppressed += 1
            if self.metrics is not None:
                self.metrics.inc("incidents.suppressed")
            return False
        self._last_capture_t = now
        task = asyncio.get_running_loop().create_task(
            self._capture(objective, slo_status),
            name=f"incident-{objective.name}",
        )
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return True

    async def _capture(self, objective, slo_status: dict) -> None:
        self._seq += 1
        incident_id = f"incident-{self._seq:04d}-{objective.name}"
        capsule: dict[str, Any] = {
            "id": incident_id,
            "at_unix_s": round(time.time(), 6),
            "objective": {"name": objective.name, **objective.status()},
            "trajectory": list(objective.trajectory),
            "slo": slo_status,
        }
        top = []
        try:
            if self.collect is not None:
                body = await self.collect()
                if isinstance(body, dict):
                    capsule.update(body)
                    sec = body.get("sections")
                    if isinstance(sec, dict):
                        top = (sec.get("flight_recorder") or {}).get(
                            "top_stages") or []
        except Exception:  # noqa: BLE001
            self.errors += 1
            if self.metrics is not None:
                self.metrics.inc("incidents.errors")
            log.exception("incident %s: collect failed", incident_id)
            capsule["collect_error"] = True
        try:
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, f"{incident_id}.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(capsule, fh, default=repr)
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001
            self.errors += 1
            if self.metrics is not None:
                self.metrics.inc("incidents.errors")
            log.exception("incident %s: capsule write failed", incident_id)
            return
        self.captured += 1
        if self.metrics is not None:
            self.metrics.inc("incidents.captured")
        self._prune()
        log.critical(
            "SLO INCIDENT %s: objective %s BURNING "
            "(burn fast=%.2f slow=%.2f, budget_remaining=%.2f) — "
            "top stages %s — capsule %s",
            incident_id, objective.name,
            objective.burn_fast, objective.burn_slow,
            objective.budget_remaining,
            [f"{name}={ms}ms" for name, ms in top] or "<no trace>",
            path,
        )

    # -- ring maintenance -------------------------------------------

    def _scan_seq(self) -> int:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return 0
        seqs = [int(m.group(1)) for n in names if (m := _FILE_RE.match(n))]
        return max(seqs, default=0)

    def _entries(self) -> list[tuple[int, str, str]]:
        """(seq, objective, filename) for every capsule on disk."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        out = []
        for n in names:
            m = _FILE_RE.match(n)
            if m:
                out.append((int(m.group(1)), m.group(2), n))
        out.sort()
        return out

    def _prune(self) -> None:
        entries = self._entries()
        for seq, _obj, name in entries[: max(0, len(entries) - self.keep)]:
            try:
                os.unlink(os.path.join(self.dir, name))
            except OSError:
                log.warning("incident prune: could not delete %s", name)

    # -- introspection (HTTP surface) -------------------------------

    def list(self) -> list[dict]:
        out = []
        for seq, obj, name in self._entries():
            entry = {
                "id": name[: -len(".json")],
                "seq": seq,
                "objective": obj,
            }
            try:
                entry["bytes"] = os.path.getsize(os.path.join(self.dir, name))
            except OSError:
                pass
            out.append(entry)
        return out

    def load(self, incident_id: str) -> dict | None:
        if not _FILE_RE.match(incident_id + ".json"):
            return None
        path = os.path.join(self.dir, incident_id + ".json")
        try:
            with open(path, encoding="utf-8") as fh:
                return json.load(fh)
        except OSError:
            return None

    def stats(self) -> dict:
        return {
            "captured": self.captured,
            "suppressed": self.suppressed,
            "errors": self.errors,
            "cooldown_s": self.cooldown_s,
            "keep": self.keep,
            "on_disk": len(self._entries()),
        }

    async def drain(self) -> None:
        """Await in-flight capture tasks (teardown)."""
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
