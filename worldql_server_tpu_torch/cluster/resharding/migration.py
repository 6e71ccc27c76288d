"""Online world migration: the router-side protocol coordinator.

One :class:`MigrationCoordinator` drives one world W from shard A
(source) to shard B (destination) through a fixed state machine:

====================  ====================================================
state                 what is true when it completes
====================  ====================================================
``freeze``            W's inbound traffic parks in the transfer buffer
                      (bounded; overflow = counted shed) and A has
                      PROCESSED every pre-freeze W frame — proven by a
                      fence frame pushed through the same FIFO data path
                      and acked over control.
``streaming``         A exported W's full capsule (records, subscription
                      rows, entity rows, parked sessions) and the router
                      holds it, CRC-verified, chunk list RETAINED.
``importing``         B replayed the capsule THROUGH its durability
                      pipeline and acked — W is now recoverable from
                      B's WAL. B dying here is survivable: the router
                      re-streams the retained chunks from zero when B's
                      restart reports ready.
``flipping``          the placement map moved W (and its migrated parked
                      peers) to B under a NEW epoch, broadcast to every
                      shard.
``replaying``         every parked frame re-entered the normal routing
                      path in arrival order — stamped with the new
                      epoch, landing on B.
``tombstoning``       A deleted W through its OWN durability pipeline
                      (the deletes hit A's WAL — replay cannot resurrect
                      a moved world). A dying first is survivable: the
                      tombstone is queued and re-issued when A returns.
====================  ====================================================

Crash safety is the design invariant: at every state exactly one shard
can recover W from WAL. Before B's durable ack that shard is A (abort:
tell B to tombstone any partial state, replay the buffer back to A).
From the ack on it is B (continue: flip, replay, queue the tombstone).
The kill-at-every-protocol-state property test drives exactly this
case split.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import uuid as uuid_mod

from .transfer import ChunkAssembler, TransferBuffer, encode_chunks  # noqa: F401  (encode_chunks: shard-side counterpart, re-exported)

logger = logging.getLogger(__name__)

#: payload magic for the freeze fence frame — rides the router→shard
#: DATA path (TCP FIFO + in-order processing make its ack a proof that
#: every earlier frame for the frozen world was already processed)
FENCE_MAGIC = b"WQFN"

#: per-state deadlines; generous enough to ride one shard restart
#: (supervisor backoff caps at 5s + boot). The source acks the fence
#: after a ticker flush, which waits out the tick in flight and runs one
#: more: two ticks, ~20 s for an entity-sim shard at config 3's width
#: on the card
FENCE_TIMEOUT_S = 60.0
EXPORT_TIMEOUT_S = 60.0
IMPORT_TIMEOUT_S = 120.0
TOMBSTONE_TIMEOUT_S = 30.0


class MigrationError(Exception):
    """A protocol step failed or timed out — the migration aborts and
    ownership stays with the source."""


class MigrationCoordinator:
    """One in-flight migration. The router holds at most one (a second
    ``POST /reshard`` gets 409) and routes control packets + shard
    up/down events into it."""

    def __init__(self, router, world: str, source: int, target: int,
                 xfer_id: int, buffer_bytes: int):
        self.router = router
        self.world = world
        self.source = source
        self.target = target
        self.xfer = xfer_id
        self.state = "idle"
        self.buffer = TransferBuffer(buffer_bytes)
        self.capsule: dict | None = None
        self.chunks: list[dict] = []
        self.import_counts: dict | None = None
        self.replayed = 0
        self.error: str | None = None
        self.started = time.monotonic()
        self.finished: float | None = None
        #: uuid hexes of the parked sessions riding the capsule —
        #: their resume handshakes park too once known, so a resume
        #: racing the flip lands on the NEW owner, not a shard about
        #: to tombstone the state
        self.migrating_peers: set[str] = set()
        self._assembler = ChunkAssembler()
        self._fence_ack = asyncio.Event()
        self._export_done = asyncio.Event()
        self._import_ack = asyncio.Event()
        self._tombstone_ack = asyncio.Event()
        self._failed = asyncio.Event()
        self._restreams: set[asyncio.Task] = set()

    # region: router-facing surface

    @property
    def active(self) -> bool:
        return self.state not in ("idle", "done", "aborted")

    def should_park(self, instruction, world_name, sender) -> bool:
        """The router's interception predicate, checked per inbound
        message after decode: park W's world-routed traffic for the
        whole migration, plus — once the capsule names them — the
        resume handshakes of its migrating parked peers. Parking STOPS
        at the flip: from ``replaying`` on, the new placement routes
        W's frames to their owner — including the replayed frames
        themselves, which would otherwise re-park into the drained
        buffer and be lost."""
        if not self.active or self.state in ("replaying", "tombstoning"):
            return False
        from ...protocol import Instruction

        if instruction == Instruction.HANDSHAKE:
            return (
                sender is not None
                and sender.hex in self.migrating_peers
            )
        return world_name == self.world

    def describe(self) -> dict:
        return {
            "xfer": self.xfer,
            "world": self.world,
            "source": self.source,
            "target": self.target,
            "state": self.state,
            "buffer": self.buffer.stats(),
            "replayed": self.replayed,
            "chunks": len(self.chunks),
            "error": self.error,
            "elapsed_s": round(
                (self.finished or time.monotonic()) - self.started, 3
            ),
        }

    # endregion

    # region: control-packet hooks (router.on_shard_message)

    def on_fence_ack(self, shard: int, msg: dict) -> None:
        if shard == self.source and int(msg.get("xfer", -1)) == self.xfer:
            self._fence_ack.set()

    def on_chunk(self, shard: int, msg: dict) -> None:
        """One capsule chunk from the source: retained verbatim (the
        resume-from-zero re-stream source) and fed to the assembler."""
        if shard != self.source or int(msg.get("xfer", -1)) != self.xfer:
            return
        chunk = msg.get("chunk")
        if not isinstance(chunk, dict):
            return
        self.chunks.append(chunk)
        doc = self._assembler.feed(chunk)
        if self._assembler.corrupt:
            self._fail("capsule chunk stream failed CRC verification")
        elif doc is not None:
            self.capsule = doc
            self.migrating_peers = {
                str(row.get("uuid")) for row in doc.get("sessions", ())
            }
            self._export_done.set()

    def on_import_ack(self, shard: int, msg: dict) -> None:
        if shard == self.target and int(msg.get("xfer", -1)) == self.xfer:
            self.import_counts = msg.get("counts")
            self._import_ack.set()

    def on_tombstone_ack(self, shard: int, msg: dict) -> None:
        if shard == self.source and int(msg.get("xfer", -1)) == self.xfer:
            self._tombstone_ack.set()

    def on_shard_down(self, shard: int) -> None:
        """SIGKILL at any protocol state lands here. Source death
        before B's durable ack aborts (A's restart recovers W from its
        WAL). Source death after the ack continues — the tombstone
        queue catches A's restart. Destination death never aborts:
        the retained chunks re-stream from zero on its ready."""
        if shard == self.source and not self._import_ack.is_set():
            if self.state in ("freeze", "streaming", "importing"):
                self._fail(
                    f"source shard {shard} died before the durable "
                    "import ack"
                )

    def on_shard_ready(self, shard: int) -> None:
        """A restarted destination mid-import gets the whole retained
        chunk stream again from zero (its fresh assembler re-verifies
        every CRC)."""
        if (
            shard == self.target
            and self.state == "importing"
            and not self._import_ack.is_set()
            and self.chunks
        ):
            task = asyncio.get_running_loop().create_task(  # wql: allow(unsupervised-task) — one-shot re-stream, retained below
                self._stream_to_target()
            )
            self._restreams.add(task)
            task.add_done_callback(self._restreams.discard)

    # endregion

    # region: the protocol

    def _set_state(self, state: str) -> None:
        self.state = state
        self.router.metrics.inc(f"cluster.reshard_state_{state}")
        logger.info(
            "reshard %d: world %r %d→%d entered %s",
            self.xfer, self.world, self.source, self.target, state,
        )

    def _fail(self, reason: str) -> None:
        if self.error is None:
            self.error = reason
        self._failed.set()

    async def _wait(self, event: asyncio.Event, timeout: float,
                    what: str) -> None:
        waiters = [
            asyncio.ensure_future(event.wait()),  # wql: allow(unsupervised-task) — awaited + cancelled below
            asyncio.ensure_future(self._failed.wait()),  # wql: allow(unsupervised-task) — awaited + cancelled below
        ]
        try:
            done, _ = await asyncio.wait(
                waiters, timeout=timeout,
                return_when=asyncio.FIRST_COMPLETED,
            )
        finally:
            for w in waiters:
                w.cancel()
        if self._failed.is_set():
            raise MigrationError(self.error or f"{what} failed")
        if not event.is_set():
            raise MigrationError(f"timed out waiting for {what}")

    async def _ctl_send_retry(self, shard: int, msg: dict,
                              deadline_s: float = 5.0) -> None:
        """Control sends are best-effort non-blocking; a full socket
        retries until the deadline (the shard-side dump-chunk idiom)."""
        deadline = time.monotonic() + deadline_s
        while not self.router.supervisor.ctl_send(shard, msg):
            if self._failed.is_set():
                raise MigrationError(self.error or "migration failed")
            if time.monotonic() >= deadline:
                raise MigrationError(
                    f"control send to shard {shard} timed out"
                )
            await asyncio.sleep(0.01)

    async def _stream_to_target(self) -> None:
        # a shard reads its control socket between ticks: a chunk may
        # wait out several seconds of a busy tick, so the stream keeps
        # trying for as long as the import may take
        try:
            for chunk in list(self.chunks):
                await self._ctl_send_retry(self.target, {
                    "op": "reshard_import_chunk",
                    "xfer": self.xfer,
                    "world": self.world,
                    "chunk": chunk,
                }, deadline_s=IMPORT_TIMEOUT_S)
        except MigrationError as exc:
            logger.warning(
                "reshard %d: chunk stream to shard %d stalled: %s",
                self.xfer, self.target, exc,
            )

    async def run(self) -> bool:
        """Drive the protocol end to end. True = migrated; False =
        aborted with ownership intact on the source."""
        router = self.router
        try:
            # FREEZE — interception is already live (the router
            # installed this coordinator before spawning run()); the
            # fence rides the data path so its ack proves A drained
            # every W frame forwarded before the freeze.
            self._set_state("freeze")
            if not router.send_fence(self.source, self.xfer):
                raise MigrationError("fence send failed (push queue full)")
            await self._wait(self._fence_ack, FENCE_TIMEOUT_S, "fence ack")

            # STREAMING — A exports; chunks arrive over control.
            self._set_state("streaming")
            await self._ctl_send_retry(self.source, {
                "op": "reshard_export",
                "xfer": self.xfer,
                "world": self.world,
            }, deadline_s=EXPORT_TIMEOUT_S)
            await self._wait(
                self._export_done, EXPORT_TIMEOUT_S, "world export"
            )

            # IMPORTING — stream the retained chunks to B; its ack is
            # sent only after a durability drain (WAL-durable on B).
            self._set_state("importing")
            await self._stream_to_target()
            await self._wait(
                self._import_ack, IMPORT_TIMEOUT_S, "durable import ack"
            )

            # FLIP — one epoch bump moves the world and its migrated
            # parked peers; every shard converges via the broadcast
            # now and the ~1s state-packet epoch check later.
            self._set_state("flipping")
            peers = []
            for hexed in self.migrating_peers:
                try:
                    peers.append(uuid_mod.UUID(hex=hexed))
                except ValueError:
                    continue
            epoch = router.world_map.move_world(
                self.world, self.target, peers
            )
            router.broadcast_placement()
            logger.info(
                "reshard %d: world %r now owned by shard %d (epoch %d)",
                self.xfer, self.world, self.target, epoch,
            )

            # REPLAY — parked frames re-enter the normal route path in
            # arrival order; the new epoch stamps them onto B.
            self._set_state("replaying")
            for frame in self.buffer.replay():
                router.route_replay(frame)
                self.replayed += 1
            router.metrics.inc("cluster.reshard_replayed", self.replayed)

            # TOMBSTONE — queued first: if A is dead or dies mid-ack
            # the router re-issues on its ready and W stays gone.
            self._set_state("tombstoning")
            router.queue_tombstone(self.source, self.world, self.xfer)
            try:
                await self._wait(
                    self._tombstone_ack, TOMBSTONE_TIMEOUT_S,
                    "tombstone ack",
                )
            except MigrationError:
                # the flip is durable either way; the queued tombstone
                # fires when the source returns
                logger.warning(
                    "reshard %d: tombstone ack pending — queued for "
                    "shard %d's next ready", self.xfer, self.source,
                )
            self._set_state("done")
            router.metrics.inc("cluster.reshard_completed")
            return True
        except (MigrationError, Exception) as exc:
            await self._abort(str(exc))
            return False
        finally:
            self.finished = time.monotonic()

    async def _abort(self, reason: str) -> None:
        """Ownership stays with the source: tell the destination to
        tombstone any partial state, then replay the parked frames
        back through the unchanged placement."""
        self.error = self.error or reason
        logger.warning(
            "reshard %d: world %r %d→%d ABORTED in %s: %s",
            self.xfer, self.world, self.source, self.target,
            self.state, self.error,
        )
        self._set_state("aborted")
        self.router.metrics.inc("cluster.reshard_aborted")
        try:
            await self._ctl_send_retry(self.target, {
                "op": "reshard_abort",
                "xfer": self.xfer,
                "world": self.world,
            }, deadline_s=2.0)
        except MigrationError:
            pass  # a dead destination lost its partial state with it
        for frame in self.buffer.replay():
            self.router.route_replay(frame)
            self.replayed += 1

    # endregion


def fence_payload(xfer_id: int) -> bytes:
    """The freeze fence's wire payload: magic + JSON meta. Never a
    valid FlatBuffers message (same bounds-rejection argument as the
    trace-context magics)."""
    return FENCE_MAGIC + json.dumps({"xfer": xfer_id}).encode()


def parse_fence(payload: bytes) -> int | None:
    """Shard side: the fence's transfer id, or None for a frame that
    merely starts with the magic but carries no valid meta."""
    if not payload.startswith(FENCE_MAGIC):
        return None
    try:
        return int(json.loads(payload[len(FENCE_MAGIC):])["xfer"])
    except (KeyError, TypeError, ValueError):
        return None
