"""Chunked control-channel dump client (the cluster pull protocol).

A shard's flight-recorder/subsystem dump does not fit one control
packet, so the shard answers a ``{"op": "dump", "req_id": N}`` request
with a series of ``{"op": "dump_chunk", "req_id", "seq", "n", "data"}``
pieces that this client reassembles.  Extracted from ``ClusterRouter``
so the TWO consumers — ``GET /debug/cluster`` and the SLO incident
capture — share ONE code path: the same req-id slots, the same chunk
reassembly, and the same timeout-degrading semantics (a dead or slow
shard yields ``None``, never an error), so a capsule can never drift
from what the debug endpoint would have shown.
"""

from __future__ import annotations

import asyncio
import json
import logging

logger = logging.getLogger(__name__)

#: Per-shard pull deadline — matches the shard's chunk retry window.
DUMP_TIMEOUT_S = 8.0


class ChunkedDumpClient:
    """Reassembles chunked control-channel dumps, one slot per
    in-flight request."""

    def __init__(self, supervisor) -> None:
        self.supervisor = supervisor
        #: in-flight collections: req_id → {"parts", "n", "event"}
        self._reqs: dict[int, dict] = {}
        self._seq = 0

    def note_chunk(self, msg: dict) -> None:
        """Control-channel reader hook: file one ``dump_chunk`` into
        its request slot (late chunks for timed-out requests drop)."""
        slot = self._reqs.get(msg.get("req_id"))
        if slot is None:
            return
        try:
            slot["parts"][int(msg["seq"])] = str(msg.get("data", ""))
            slot["n"] = int(msg["n"])
        except (KeyError, TypeError, ValueError):
            return
        if len(slot["parts"]) >= slot["n"]:
            slot["event"].set()

    async def collect(
        self, shard: int, timeout: float = DUMP_TIMEOUT_S
    ) -> dict | None:
        """Pull one shard's dump over the control channel (request →
        chunked response).  ``None`` on a dead shard or a timeout — the
        caller degrades to the processes that answered, never errors."""
        if not self.supervisor.shard_alive(shard):
            return None
        self._seq += 1
        req_id = self._seq
        slot = {"parts": {}, "n": 1 << 30, "event": asyncio.Event()}
        self._reqs[req_id] = slot
        try:
            if not self.supervisor.ctl_send(
                shard, {"op": "dump", "req_id": req_id}
            ):
                return None
            try:
                await asyncio.wait_for(slot["event"].wait(), timeout)
            except asyncio.TimeoutError:
                logger.warning("shard %d dump pull timed out", shard)
                return None
            blob = "".join(slot["parts"][i] for i in range(slot["n"]))
            return json.loads(blob)
        except Exception:
            logger.exception("shard %d dump collection failed", shard)
            return None
        finally:
            self._reqs.pop(req_id, None)
