"""Autosharding: the router-side hot-shard watcher.

Zipfian traffic pins one hot world to one shard no matter how large
``--cluster-shards N`` is — bench's own zipf block lands ~60% of load
in a few capped cubes. This controller closes the loop the manual
``POST /reshard`` surface leaves open: it watches the per-shard
overload state the control channel already mirrors (the shard
governors fold tick-wall/queue/shed pressure into their exported
LEVEL — the same federated signal /metrics serves), and when one
shard stays hot while the fleet is not, it migrates that shard's
hottest world to the coldest shard.

Deliberately conservative:

* ``--autoshard on`` only (default off) — a migration freezes a
  world's traffic for its duration; nobody should get that surprise
  unarmed.
* A shard must hold SHED_HIGH+ for ``sustain_s`` continuously — a one
  tick spike or a restart blip never triggers.
* One migration at a time, ``cooldown_s`` between triggers — the
  controller must never thrash a world back and forth faster than the
  load signal settles.
* The hottest-world signal is the router's OWN forward accounting
  (per-world counters it increments on every world-routed forward,
  decayed each poll) — no extra control traffic, and it measures
  exactly what the router can act on: what it forwards.
"""

from __future__ import annotations

import asyncio
import logging
import time

logger = logging.getLogger(__name__)

#: governor level considered hot (shard.py exports it; router.py's
#: shed mirror holds it) — SHED_HIGH in the governor's ladder
HOT_LEVEL = 2


class AutoshardController:
    def __init__(self, router, *, interval_s: float = 2.0,
                 sustain_s: float = 6.0, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        self.router = router
        self.interval_s = interval_s
        self.sustain_s = sustain_s
        self.cooldown_s = cooldown_s
        self._clock = clock
        #: shard → monotonic stamp when it FIRST went hot (cleared on
        #: any non-hot observation)
        self._hot_since: dict[int, float] = {}
        self._last_trigger = 0.0
        self.triggered = 0

    async def run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                self.poll()
            except Exception:
                logger.exception("autoshard poll failed — continuing")

    def poll(self) -> int | None:
        """One observation: age the hot set, decay the world-load
        window, trigger at most one migration. Returns the migration's
        xfer id when one fired (test hook)."""
        router = self.router
        now = self._clock()
        hot = None
        for shard in range(router.n_shards):
            if (
                router.supervisor.shard_alive(shard)
                and router.mirror.level(shard) >= HOT_LEVEL
            ):
                since = self._hot_since.setdefault(shard, now)
                if hot is None and now - since >= self.sustain_s:
                    hot = shard
            else:
                self._hot_since.pop(shard, None)
        router.decay_world_load()
        if hot is None:
            return None
        if now - self._last_trigger < self.cooldown_s:
            return None
        if router.migration is not None and router.migration.active:
            return None
        world = router.hottest_world(hot)
        if world is None:
            return None  # hot shard with no world-routed traffic window
        target = self._coldest_other(hot)
        if target is None:
            return None  # fleet-wide heat: migration would just move pain
        self._last_trigger = now
        self.triggered += 1
        router.metrics.inc("cluster.autoshard_triggered")
        logger.warning(
            "autoshard: shard %d hot ≥%.0fs — migrating its hottest "
            "world %r to shard %d", hot, self.sustain_s, world, target,
        )
        return router.start_reshard(world, target, reason="autoshard")

    def _coldest_other(self, hot: int) -> int | None:
        """The migration target: the alive shard with the lowest
        governor level (ties: least world-routed forward load). None
        when every other shard is hot too."""
        router = self.router
        best = None
        best_key = None
        for shard in range(router.n_shards):
            if shard == hot or not router.supervisor.shard_alive(shard):
                continue
            level = router.mirror.level(shard)
            if level >= HOT_LEVEL:
                continue
            key = (level, router.shard_forward_load(shard), shard)
            if best_key is None or key < best_key:
                best, best_key = shard, key
        return best

    def stats(self) -> dict:
        return {
            "hot_shards": sorted(self._hot_since),
            "triggered": self.triggered,
        }
