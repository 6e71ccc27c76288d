"""Overload control plane: admission, priority shedding, degradation.

The resilient backend makes the server survive *faults*; this module
makes it survive *load*. Manycore range-query serving
(arXiv:1411.3212) and accelerator kNN (TPU-KNN, arXiv:2206.14286) both assume the batch fed to the device is bounded
and well-formed — the :class:`OverloadGovernor` is what guarantees
that invariant under hostile offered load, so the device pipeline
stays saturated instead of the event loop drowning.

One governor per server, driven by live signals the repo already
measures:

* **tick wall vs budget** — ``TickBatcher`` reports every flush wall
  (``note_tick``); K consecutive ticks over ``tick_budget_ms`` is the
  deadline-degradation trigger AND a state-machine signal;
* **queue depth** — the ticker's pending batch as a fraction of
  ``max_batch`` (``note_queue_depth`` fires from the enqueue path, so
  a storm escalates mid-window, not one tick late);
* **event-loop lag** — ``loop.lag_ms`` from the ``LoopMonitor``
  when tracing is on;
* **RSS** — ``/proc/self/statm`` against ``rss_limit_mb`` (0 = off).

The state machine is hysteretic — ``OK → SHED_LOW → SHED_HIGH →
REJECT``. Escalation is immediate (one sample over an enter
threshold); de-escalation steps DOWN one state only after
``recover_ticks`` consecutive samples below the exit thresholds,
which sit at ``hysteresis`` (default 0.8×) of the enter thresholds —
a signal parked exactly on a boundary cannot flap the state.

Priority classes at admission (``admit``), most-durable first:

=========  ====================================================
record     RecordCreate/Update/Delete/Read — durable, acked:
           NEVER shed, in any state (the token bucket counts
           them but never drops them).
entity     entity-update batches — never rejected; under
           ``SHED_LOW``+ the EntityPlane coalesces them
           last-write-wins per uuid (lossless for position
           streams — the newest position subsumes the ones it
           overwrote).
global     GlobalMessages — shed LAST: dropped only in REJECT.
local      LocalMessage fan-out queries — shed drop-OLDEST: the
           ticker queue is capped at ``2 × max_batch`` and evicts
           the stalest queued query when full; REJECT refuses
           them at ingest.
control    heartbeats — always admitted (liveness must survive
           overload; an evicted-for-silence peer helps nobody).
=========  ====================================================

Per-peer token buckets (``peer_rate`` msgs/s, ``peer_burst`` burst)
stop one chatty client from starving the rest: a limited message is
dropped (``peers.rate_limited``) unless it is a record op, and
``evict_after`` consecutive limited messages trigger the eviction
hook (``peers.evicted_rate_limited`` — configurable; 0 never evicts).

Tick-deadline degradation: ``deadline_k`` consecutive budget busts
halve the admitted batch tier (floor ``min_batch``) and skip the
entity neighbor-frame fan-out every other tick; ``recover_ticks``
consecutive in-budget ticks double the tier back (full service once
it reaches ``max_batch`` again).

Everything is observable, not silent: the ``overload`` gauge carries
state + counters into ``/metrics`` and ``/healthz``, the ticker tags
the governor state onto every tick trace, and the
``overload.force_state`` failpoint (``state:<name>`` action) lets
chaos drive every transition deterministically.

``--overload off`` (the default) never constructs this class — the
server's ingest paths keep today's behavior byte for byte.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
import uuid as uuid_mod

from ..protocol.types import Instruction
from . import failpoints

logger = logging.getLogger(__name__)

#: governor states, mildest first — list order IS escalation order
OK = "ok"
SHED_LOW = "shed_low"
SHED_HIGH = "shed_high"
REJECT = "reject"
STATES = (OK, SHED_LOW, SHED_HIGH, REJECT)
_LEVEL = {s: i for i, s in enumerate(STATES)}

#: admission classes (priority order documented in the module doc)
CLASS_RECORD = "record"
CLASS_ENTITY = "entity"
CLASS_GLOBAL = "global"
CLASS_LOCAL = "local"
CLASS_SUBSCRIBE = "subscribe"
CLASS_CONTROL = "control"
#: handshakes are an admission class too: a reconnect storm
#: must not be able to starve the tick with connect-back work. New
#: connects shed FIRST (SHED_HIGH+); resumes — peers with parked state
#: the server is already holding — shed LAST (REJECT only, and even
#: there a token bucket keeps admitting a bounded trickle so a mass
#: reconnect drains instead of livelocking).
CLASS_HS_NEW = "handshake_new"
CLASS_HS_RESUME = "handshake_resume"

_CLASS_OF = {
    Instruction.LOCAL_MESSAGE: CLASS_LOCAL,
    Instruction.GLOBAL_MESSAGE: CLASS_GLOBAL,
    Instruction.RECORD_CREATE: CLASS_RECORD,
    Instruction.RECORD_READ: CLASS_RECORD,
    Instruction.RECORD_UPDATE: CLASS_RECORD,
    Instruction.RECORD_DELETE: CLASS_RECORD,
    Instruction.AREA_SUBSCRIBE: CLASS_SUBSCRIBE,
    Instruction.AREA_UNSUBSCRIBE: CLASS_SUBSCRIBE,
}

#: enter thresholds per escalated level (SHED_LOW, SHED_HIGH, REJECT);
#: exit thresholds are ``hysteresis`` × these
_TICK_RATIO = (1.0, 2.0, 4.0)     # tick wall / tick budget
_QUEUE_FRAC = (0.5, 1.0, 2.0)     # queue depth / max_batch
_LAG_MS = (50.0, 250.0, 1000.0)   # event-loop scheduling lag
_RSS_FRAC = (0.85, 0.95, 1.05)    # RSS / rss_limit

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096

#: failpoint driving deterministic transitions (chaos):
#:   WQL_FAILPOINTS=overload.force_state=state:shed_high
FORCE_STATE_FAILPOINT = "overload.force_state"


def read_rss_bytes() -> int:
    """Current resident set from /proc (Linux); 0 when unreadable —
    an absent signal must disable itself, not crash the governor."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except Exception:
        return 0


class OverloadGovernor:
    """Hysteretic overload state machine + priority-classed admission
    for one server. Event-loop owned (like the router it gates)."""

    def __init__(
        self,
        *,
        max_batch: int = 16_384,
        tick_budget_ms: float = 0.0,
        deadline_k: int = 3,
        recover_ticks: int = 5,
        min_batch: int = 256,
        peer_rate: float = 0.0,
        peer_burst: int = 0,
        evict_after: int = 0,
        rss_limit_mb: int = 0,
        hysteresis: float = 0.8,
        sample_interval: float = 0.25,
        resume_rate: float = 200.0,
        resume_burst: int = 0,
        metrics=None,
        loop_monitor=None,
        on_evict=None,
        clock=time.monotonic,
    ):
        self.max_batch = int(max_batch)
        self.tick_budget_ms = float(tick_budget_ms)
        self.deadline_k = max(1, int(deadline_k))
        self.recover_ticks = max(1, int(recover_ticks))
        self.min_batch = max(1, min(int(min_batch), self.max_batch))
        self.hysteresis = float(hysteresis)
        self.sample_interval = float(sample_interval)
        self.metrics = metrics
        self.loop_monitor = loop_monitor
        self.on_evict = on_evict
        self._clock = clock

        # per-peer token buckets: uuid → [tokens, t_refill, limited_streak]
        self.peer_rate = float(peer_rate)
        self.peer_burst = int(peer_burst) if peer_burst else max(
            1, int(2 * peer_rate)
        )
        self.evict_after = int(evict_after)
        self._buckets: dict[uuid_mod.UUID, list] = {}
        self._evicting: set[uuid_mod.UUID] = set()

        # handshake admission (session continuity): the
        # resume bucket bounds how many parked-state rebinds REJECT
        # still admits; the hint bucket bounds refusal replies so the
        # retry-after path can't itself be driven as a reflector.
        self.resume_rate = float(resume_rate)
        self.resume_burst = int(resume_burst) if resume_burst else max(
            1, int(2 * self.resume_rate)
        )
        self._resume_bucket = [float(self.resume_burst), self._clock()]
        self._hint_bucket = [50.0, self._clock()]
        #: jittered retry-after hints: a storm told to retry at the
        #: same instant just re-synchronizes itself — the jitter source
        #: is deliberately unseeded (de-correlating peers is the point)
        self._jitter = random.Random()

        self._state = OK
        self._recover = 0          # consecutive below-state samples
        self._busts = 0            # consecutive over-budget ticks
        self._healthy_ticks = 0    # consecutive in-budget ticks (tier)
        self._admitted = self.max_batch
        self._frame_parity = False
        self._last_tick_ms = 0.0
        self._queue_depth = 0
        self._depth_bucket = 0
        self._rss_bytes = 0
        self._rss_read_at = 0.0
        self._rss_limit_bytes = int(rss_limit_mb) * (1 << 20)

        # counters (also pushed into the metrics registry so the audit
        # invariant "shed work is fully accounted" holds in /metrics)
        self.ticks = 0
        self.transitions = 0
        self.peak_level = 0
        self.shed = {
            CLASS_LOCAL: 0, CLASS_GLOBAL: 0,
            CLASS_HS_NEW: 0, CLASS_HS_RESUME: 0,
        }
        self.handshakes_admitted = 0
        self.drop_oldest = 0
        self.rate_limited = 0
        self.tier_degradations = 0

    # region: state machine

    @property
    def state(self) -> str:
        return self._state

    @property
    def level(self) -> int:
        return _LEVEL[self._state]

    @property
    def admitted_batch(self) -> int:
        """Current admitted batch tier: ``max_batch`` at full service,
        halved per deadline-degradation step down to ``min_batch``."""
        return self._admitted

    def degraded(self) -> bool:
        return self._admitted < self.max_batch

    def note_tick(self, tick_ms: float, queue_depth: int) -> None:
        """One completed ticker flush: feed the deadline-degradation
        counters and re-evaluate the state machine. The ticker calls
        this from ``_account`` (real ticks) and ``note_idle`` (empty
        windows), so recovery keeps sampling after load drops."""
        self.ticks += 1
        self._last_tick_ms = tick_ms
        self._queue_depth = queue_depth
        if self.tick_budget_ms and tick_ms > self.tick_budget_ms:
            self._busts += 1
            self._healthy_ticks = 0
            if (
                self._busts >= self.deadline_k
                and (self._busts - self.deadline_k) % self.deadline_k == 0
            ):
                self._degrade_tier()
        else:
            self._busts = 0
            if self.degraded():
                self._healthy_ticks += 1
                if self._healthy_ticks >= self.recover_ticks:
                    self._healthy_ticks = 0
                    self._restore_tier()
        self._evaluate()

    def note_idle(self, queue_depth: int = 0) -> None:
        """An empty flush window counts as an in-budget tick — the
        path back to OK once load drops."""
        self.note_tick(0.0, queue_depth)

    def note_queue_depth(self, depth: int) -> None:
        """Enqueue-path signal: escalate MID-window when a storm fills
        the queue, instead of one tick late. Cheap — the full
        evaluation runs only when the depth's pressure bucket changes
        (threshold crossings) or every 256 messages while it doesn't."""
        self._queue_depth = depth
        m = self.max_batch
        bucket = (depth >= m // 2) + (depth >= m) + (depth >= 2 * m)
        if bucket != self._depth_bucket or (depth & 0xFF) == 0:
            self._depth_bucket = bucket
            self._evaluate()

    async def run(self) -> None:
        """Sampler loop for tickerless (immediate-mode) servers — the
        lag/RSS signals still need a clock. Supervised by the server;
        never spawned when a ticker drives ``note_tick``."""
        while True:
            await asyncio.sleep(self.sample_interval)
            self.note_idle(self._queue_depth)

    def _signal_level(self, value: float, enters: tuple) -> int:
        """Level this signal votes for, with exit thresholds at
        ``hysteresis`` × enter for every level at/below the current
        state — the anti-flap asymmetry."""
        cur = _LEVEL[self._state]
        level = 0
        for i, enter in enumerate(enters, start=1):
            threshold = enter * self.hysteresis if i <= cur else enter
            if value >= threshold:
                level = i
        return level

    def _raw_level(self) -> int:
        level = self._signal_level(
            self._queue_depth / self.max_batch, _QUEUE_FRAC
        )
        if self.tick_budget_ms and self._busts >= self.deadline_k:
            # a single slow tick is noise; K consecutive busts are load
            level = max(level, self._signal_level(
                self._last_tick_ms / self.tick_budget_ms, _TICK_RATIO
            ))
        if self.loop_monitor is not None:
            level = max(level, self._signal_level(
                self.loop_monitor.last_lag_ms, _LAG_MS
            ))
        if self._rss_limit_bytes:
            now = self._clock()
            if now - self._rss_read_at > 0.2:  # bound the /proc reads
                self._rss_bytes = read_rss_bytes()
                self._rss_read_at = now
            level = max(level, self._signal_level(
                self._rss_bytes / self._rss_limit_bytes, _RSS_FRAC
            ))
        return level

    def _evaluate(self) -> None:
        forced = failpoints.forced(FORCE_STATE_FAILPOINT)
        if forced is not None:
            forced = forced.lower()
            if forced in _LEVEL:
                self._recover = 0
                self._transition(forced, "failpoint")
            else:
                logger.warning(
                    "overload.force_state failpoint carries unknown "
                    "state %r — ignored", forced,
                )
            return
        raw = self._raw_level()
        cur = _LEVEL[self._state]
        if raw > cur:
            self._recover = 0
            self._transition(STATES[raw], "signal")
        elif raw < cur:
            self._recover += 1
            if self._recover >= self.recover_ticks:
                self._recover = 0
                self._transition(STATES[cur - 1], "recovered")
        else:
            self._recover = 0

    def _transition(self, state: str, reason: str) -> None:
        if state == self._state:
            return
        old = self._state
        self._state = state
        self.transitions += 1
        if _LEVEL[state] > self.peak_level:
            self.peak_level = _LEVEL[state]
        if self.metrics is not None:
            self.metrics.inc("overload.transitions")
        log = (
            logger.warning if _LEVEL[state] > _LEVEL[old] else logger.info
        )
        log(
            "overload governor %s -> %s (%s; tick %.1f ms / budget "
            "%.1f ms, queue %d/%d, busts %d)",
            old, state, reason, self._last_tick_ms, self.tick_budget_ms,
            self._queue_depth, self.max_batch, self._busts,
        )

    def _degrade_tier(self) -> None:
        admitted = max(self.min_batch, self._admitted // 2)
        if admitted == self._admitted:
            return
        self._admitted = admitted
        self.tier_degradations += 1
        if self.metrics is not None:
            self.metrics.inc("overload.tier_degradations")
        logger.warning(
            "tick deadline busted %d consecutive times (budget %.1f ms)"
            " — admitted batch tier shrunk to %d",
            self._busts, self.tick_budget_ms, admitted,
        )

    def _restore_tier(self) -> None:
        self._admitted = min(self.max_batch, self._admitted * 2)
        if self._admitted == self.max_batch:
            self._frame_parity = False
            logger.info(
                "tick deadline recovered — admitted batch tier back to "
                "full service (%d)", self.max_batch,
            )

    # endregion

    # region: admission

    def classify(self, instruction, is_entity: bool) -> str:
        if is_entity:
            return CLASS_ENTITY
        return _CLASS_OF.get(instruction, CLASS_CONTROL)

    def admit(self, instruction, sender, is_entity: bool = False) -> bool:
        """One inbound message's admission decision (the router's
        choke point). False = shed, already counted — the caller just
        drops the message."""
        cls = self.classify(instruction, is_entity)
        if cls == CLASS_CONTROL:
            return True  # liveness survives overload
        if (
            self.peer_rate > 0
            and sender is not None
            and sender.int != 0  # NIL: server-internal injection (HTTP)
            and not self._take_token(sender)
            and cls != CLASS_RECORD  # records consume but never drop
        ):
            self._note_limited(sender, cls)
            return False
        if cls in (CLASS_RECORD, CLASS_ENTITY, CLASS_SUBSCRIBE):
            # records are durable+acked (never shed); entity updates
            # shed by COALESCING in the plane (lossless); subscription
            # ops are control-plane index mutations
            return True
        if self._state == REJECT:
            self.shed[cls] += 1
            if self.metrics is not None:
                self.metrics.inc(f"overload.shed_{cls}")
            return False
        # locals in SHED_* shed drop-oldest at the ticker queue, not
        # here — the newest query is the freshest work
        return True

    def admit_handshake(self, resume: bool = False) -> tuple[bool, int]:
        """One inbound handshake's admission decision (the transports'
        choke point, BEFORE any connect-back/socket work). Returns
        ``(admitted, retry_after_ms)`` — the hint is 0 when admitted,
        jittered when refused so a refused storm de-synchronizes
        instead of re-arriving as one wave.

        New connects shed before resumes: a fresh peer costs full
        registration (index rows, entity slots, connect-back socket)
        while a resume rebinds state the server is ALREADY paying for
        — refusing resumes leaks exactly the memory the TTL bounds.
        So new connects shed at SHED_HIGH and above; resumes pass in
        every state below REJECT, and in REJECT a token bucket
        (``resume_rate``/s) keeps admitting a bounded trickle so a
        mass reconnect drains rather than livelocking."""
        level = _LEVEL[self._state]
        if resume:
            if level < _LEVEL[REJECT] or self._take_resume_token():
                self.handshakes_admitted += 1
                return True, 0
            cls = CLASS_HS_RESUME
        else:
            if level < _LEVEL[SHED_HIGH]:
                self.handshakes_admitted += 1
                return True, 0
            cls = CLASS_HS_NEW
        self.shed[cls] += 1
        if self.metrics is not None:
            self.metrics.inc(f"overload.shed_{cls}")
        return False, self._retry_after_ms()

    def _take_resume_token(self) -> bool:
        if self.resume_rate <= 0:
            return False
        now = self._clock()
        bucket = self._resume_bucket
        tokens = bucket[0] + (now - bucket[1]) * self.resume_rate
        bucket[0] = min(tokens, float(self.resume_burst))
        bucket[1] = now
        if bucket[0] >= 1.0:
            bucket[0] -= 1.0
            return True
        return False

    def _retry_after_ms(self) -> int:
        """Jittered backoff hint scaled to the governor state: the
        deeper the overload, the longer the herd is told to stay
        away. Uniform jitter in [0.5x, 1.5x) of the base."""
        base = 250 * (1 << max(0, _LEVEL[self._state] - 1))
        return max(1, int(base * (0.5 + self._jitter.random())))

    def take_refusal_hint(self) -> bool:
        """Budget for SENDING a refusal hint where it costs a socket
        (the ZMQ connect-back): a bounded trickle of hints beats both
        silence (clients retry blind at full rate) and an unbounded
        reflector (the refusal path DoSing the refuser)."""
        now = self._clock()
        bucket = self._hint_bucket
        bucket[0] = min(bucket[0] + (now - bucket[1]) * 50.0, 50.0)
        bucket[1] = now
        if bucket[0] >= 1.0:
            bucket[0] -= 1.0
            return True
        return False

    def coalesce_entities(self) -> bool:
        """SHED_LOW and above: the EntityPlane stages updates of live
        entities last-write-wins per uuid and applies them once per
        tick (lossless for position streams)."""
        return self._state != OK

    def local_queue_cap(self) -> int:
        """Hard bound on the ticker's pending queue; beyond it the
        OLDEST queued LocalMessage is dropped (counted). 2 × max_batch:
        one full tick in flight plus one accumulating."""
        return 2 * self.max_batch

    def note_drop_oldest(self) -> None:
        self.drop_oldest += 1
        if self.metrics is not None:
            self.metrics.inc("overload.drop_oldest")

    def take_frame_skip(self) -> bool:
        """While the tier is degraded, skip the entity neighbor-frame
        fan-out every OTHER tick (positions/index still advance every
        tick — only the delivery leg halves)."""
        if not self.degraded():
            return False
        self._frame_parity = not self._frame_parity
        return self._frame_parity

    # endregion

    # region: per-peer token buckets

    def _take_token(self, sender) -> bool:
        now = self._clock()
        bucket = self._buckets.get(sender)
        if bucket is None:
            bucket = self._buckets[sender] = [float(self.peer_burst), now, 0]
        else:
            tokens = bucket[0] + (now - bucket[1]) * self.peer_rate
            bucket[0] = (
                float(self.peer_burst)
                if tokens > self.peer_burst else tokens
            )
            bucket[1] = now
        if bucket[0] >= 1.0:
            bucket[0] -= 1.0
            bucket[2] = 0
            return True
        bucket[2] += 1
        return False

    def _note_limited(self, sender, cls: str) -> None:
        self.rate_limited += 1
        if cls in self.shed:
            self.shed[cls] += 1
        if self.metrics is not None:
            self.metrics.inc("peers.rate_limited")
            if cls in self.shed:
                self.metrics.inc(f"overload.shed_{cls}")
        if not self.evict_after:
            return
        bucket = self._buckets.get(sender)
        if (
            bucket is not None
            and bucket[2] >= self.evict_after
            and sender not in self._evicting
            and self.on_evict is not None
        ):
            # sustained abuse: hand the uuid to the server's eviction
            # hook exactly once (the peer leaves through the normal
            # PeerMap.remove path, PeerDisconnect broadcast included)
            self._evicting.add(sender)
            logger.warning(
                "peer %s rate-limited %d consecutive messages — "
                "evicting", sender, bucket[2],
            )
            self.on_evict(sender)

    def forget_peer(self, sender) -> None:
        """Disconnect cleanup: drop the peer's bucket so the dict
        stays bounded by live peers."""
        self._buckets.pop(sender, None)
        self._evicting.discard(sender)

    # endregion

    def export_state(self) -> dict:
        """Cluster shed export (cluster/shard.py state packets): the
        compact view a router tier's :class:`~..cluster.router.
        ShedMirror` acts on — the level it mirrors for router-side
        admission plus the shed counters that close the cluster-wide
        exact-accounting audit (offered == admitted + shed-at-router +
        shed-at-shard, bench config 11)."""
        return {
            "level": self.level,
            "state": self._state,
            "admitted_batch": self._admitted,
            "shed": dict(self.shed),
            "drop_oldest": self.drop_oldest,
            "rate_limited": self.rate_limited,
        }

    def status(self) -> dict:
        """The ``overload`` gauge + the /healthz block. Numeric leaves
        flatten into Prometheus gauges."""
        return {
            "state": self._state,
            "state_level": _LEVEL[self._state],
            "peak_level": self.peak_level,
            "transitions": self.transitions,
            "admitted_batch": self._admitted,
            "tier_degraded": self.degraded(),
            "tier_degradations": self.tier_degradations,
            "consecutive_busts": self._busts,
            "tick_budget_ms": round(self.tick_budget_ms, 3),
            "last_tick_ms": round(self._last_tick_ms, 3),
            "queue_depth": self._queue_depth,
            "shed_local": self.shed[CLASS_LOCAL],
            "shed_global": self.shed[CLASS_GLOBAL],
            "shed_handshake_new": self.shed[CLASS_HS_NEW],
            "shed_handshake_resume": self.shed[CLASS_HS_RESUME],
            "handshakes_admitted": self.handshakes_admitted,
            "drop_oldest": self.drop_oldest,
            "rate_limited": self.rate_limited,
            "peers_tracked": len(self._buckets),
            "rss_mb": round(self._rss_bytes / (1 << 20), 1),
        }
