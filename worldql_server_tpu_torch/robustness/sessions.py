"""Session continuity: park peer state across a dropped transport.

The resilient backend makes the *server* survive faults and the
overload governor makes it survive load; this module makes the
*clients* survive both. Without it, a dropped
connection destroys the peer's area/world subscriptions and owned
entity slots, so the one failure mode real deployments hit constantly
— a mass reconnect after a network blip — turns into a full
re-handshake/re-subscribe/re-register stampede at exactly the moment
the server is least able to absorb it (the retry-storm / metastable-
failure regime of the overload literature).

The contract, end to end:

* **Mint** — with ``--session-ttl`` > 0 every successful handshake
  mints a resumable session token (128-bit, ``secrets``), delivered in
  the handshake echo: ZeroMQ carries it as the echo ``parameter``
  (previously always None), WebSocket as ``flex`` on the server's
  UUID-assigning handshake. The token — not the guessable peer UUID —
  is the resume capability.
* **Park** — when the peer's transport drops (hard close, staleness
  sweep, failed send, worker loss), ``PeerMap.remove`` still runs:
  PeerDisconnect still broadcasts and transport/delivery socket state
  is still released, but the peer's *logical* state — subscription
  index rows, owned entity slots, governor bucket — is parked here
  instead of torn down. Frames addressed to a parked peer are counted
  (``undelivered``), never buffered: buffering disconnected peers'
  fan-out is an unbounded-memory vector.
* **Resume** — a reconnect presenting the token (ZMQ: handshake
  ``flex``; WS: echo ``flex``) atomically rebinds the new transport
  to the parked state: no index churn, no entity re-registration, and
  the new binding may land on a different delivery-plane shard. A
  resume is also legal while the stale old binding is still in the
  map (the server has not yet noticed the drop) — the old transport
  is detached silently, with no PeerDisconnect/PeerConnect churn.
* **Expire** — a supervised sweeper reclaims sessions parked longer
  than the TTL through the normal removal path (``on_expire`` →
  ``WorldQLServer._teardown_peer_state``), counted as
  ``peers.evicted_session_expired``. A fresh tokenless handshake for
  a parked UUID also tears the old state down first: without the
  token, same-UUID is a new peer, not a resume (anything else would
  make the UUID a hijackable capability).

``--session-ttl 0`` (the default) never constructs this class — every
handshake/disconnect path keeps today's behavior byte for byte.
"""

from __future__ import annotations

import asyncio
import logging
import secrets
import time
import uuid as uuid_mod
from typing import Callable

logger = logging.getLogger(__name__)


class Session:
    """One peer's resumable continuity record."""

    __slots__ = (
        "token", "uuid", "kind", "minted_at", "parked_at", "deadline",
        "resumes", "undelivered",
    )

    def __init__(self, token: str, uuid: uuid_mod.UUID, kind: str,
                 now: float):
        self.token = token
        self.uuid = uuid
        self.kind = kind
        self.minted_at = now
        #: None while the transport is bound; set at park time
        self.parked_at: float | None = None
        self.deadline: float = 0.0
        self.resumes = 0
        #: frames addressed to this peer while parked (counted, never
        #: buffered — accounting, not replay)
        self.undelivered = 0

    @property
    def parked(self) -> bool:
        return self.parked_at is not None


class SessionStore:
    """Token → parked-peer-state registry for one server. Event-loop
    owned (mutations happen in handshake/removal handlers and the
    sweeper, all on the loop)."""

    def __init__(
        self,
        ttl: float,
        *,
        metrics=None,
        on_expire: Callable[[uuid_mod.UUID], None] | None = None,
        on_undelivered: Callable[[uuid_mod.UUID], None] | None = None,
        sweep_interval: float | None = None,
        clock=time.monotonic,
    ):
        self.ttl = float(ttl)
        self.metrics = metrics
        self.on_expire = on_expire
        # Loss hook (--interest on): every frame that lands on a
        # parked session is a GAP in that peer's stream — the server
        # wires this to InterestManager.mark_resync so the first frame
        # after resume is a forced full, never an unappliable delta.
        self.on_undelivered = on_undelivered
        # sweep often enough that reclamation lag is a fraction of the
        # TTL, but never busy-spin tiny TTLs
        self.sweep_interval = (
            sweep_interval if sweep_interval is not None
            else max(0.05, min(self.ttl / 4.0, 5.0))
        )
        self._clock = clock
        self._by_token: dict[str, Session] = {}
        self._by_uuid: dict[uuid_mod.UUID, Session] = {}
        # counters (sessions gauge + /healthz block)
        self.minted = 0
        self.parked_total = 0
        self.resumed = 0
        self.expired = 0
        self.discarded = 0
        self.rejected_tokens = 0
        self.undelivered_frames = 0

    # region: lifecycle

    def mint(self, uuid: uuid_mod.UUID, kind: str) -> Session:
        """New session for a freshly handshaken peer. Replaces (and
        invalidates the token of) any prior session under the same
        UUID — one live session per peer."""
        old = self._by_uuid.pop(uuid, None)
        if old is not None:
            self._by_token.pop(old.token, None)
        session = Session(secrets.token_hex(16), uuid, kind, self._clock())
        self._by_token[session.token] = session
        self._by_uuid[uuid] = session
        self.minted += 1
        return session

    def get(self, uuid: uuid_mod.UUID) -> Session | None:
        return self._by_uuid.get(uuid)

    def peek(self, token, uuid: uuid_mod.UUID | None = None
             ) -> Session | None:
        """Validate a presented token WITHOUT consuming anything: the
        admission decision (resume class) happens before the rebind.
        ``uuid``, when given, must match the session's (ZMQ clients
        sign their own sender UUID; a token stolen cross-UUID is
        refused). Expired-but-unswept sessions refuse too."""
        if not token:
            return None
        if isinstance(token, (bytes, bytearray, memoryview)):
            try:
                token = bytes(token).decode("ascii")
            except UnicodeDecodeError:
                self.rejected_tokens += 1
                return None
        session = self._by_token.get(token)
        if session is None:
            self.rejected_tokens += 1
            return None
        if uuid is not None and session.uuid != uuid:
            self.rejected_tokens += 1
            return None
        if session.parked and self._clock() >= session.deadline:
            # past TTL but the sweeper hasn't run yet: not resumable
            # (the state is already condemned)
            self.rejected_tokens += 1
            return None
        return session

    def park(self, uuid: uuid_mod.UUID) -> bool:
        """The peer's transport dropped. True = a live session exists
        and its logical state is now parked (the caller must SKIP the
        index/entity teardown); False = no session, tear down as
        always."""
        session = self._by_uuid.get(uuid)
        if session is None:
            return False
        session.parked_at = self._clock()
        session.deadline = session.parked_at + self.ttl
        self.parked_total += 1
        if self.metrics is not None:
            self.metrics.inc("sessions.parked")
        logger.info(
            "session for %s parked (ttl %.1fs) — subscriptions and "
            "entities held for resume", uuid, self.ttl,
        )
        return True

    def resume(self, session: Session) -> Session:
        """Consume a successful rebind: the session (validated via
        :meth:`peek`) is live again under its original token."""
        session.parked_at = None
        session.deadline = 0.0
        session.resumes += 1
        self.resumed += 1
        if self.metrics is not None:
            self.metrics.inc("sessions.resumed")
        return session

    def discard(self, uuid: uuid_mod.UUID) -> Session | None:
        """Drop the session outright (full teardown happened or is
        about to): its token can never resume again."""
        session = self._by_uuid.pop(uuid, None)
        if session is not None:
            self._by_token.pop(session.token, None)
            self.discarded += 1
        return session

    # endregion

    # region: migration (live resharding)

    def export_parked(self, uuids) -> list[dict]:
        """Serialize the PARKED sessions among ``uuids`` for a world
        migration. Tokens ride along verbatim — the resume capability
        must survive the move, or a mid-park migration silently
        orphans every affected client. Live (bound) sessions stay
        home: their transport is still attached to THIS process."""
        now = self._clock()
        rows = []
        for uuid in uuids:
            session = self._by_uuid.get(uuid)
            if session is None or not session.parked:
                continue
            rows.append({
                "token": session.token,
                "uuid": session.uuid.hex,
                "kind": session.kind,
                "remaining_s": max(0.0, session.deadline - now),
                "resumes": session.resumes,
                "undelivered": session.undelivered,
            })
        return rows

    def import_parked(self, rows: list[dict]) -> list[uuid_mod.UUID]:
        """Adopt migrated parked sessions under their ORIGINAL tokens.
        The TTL continues from where the source left it (remaining
        time, not a fresh ``self.ttl`` — migration must not extend the
        reclamation deadline). Returns the adopted UUIDs so the caller
        can funnel each through ``mark_resync``."""
        now = self._clock()
        adopted = []
        for row in rows:
            try:
                uuid = uuid_mod.UUID(hex=row["uuid"])
                token = str(row["token"])
                kind = str(row.get("kind", "unknown"))
                remaining = float(row.get("remaining_s", self.ttl))
            except (KeyError, TypeError, ValueError):
                continue
            old = self._by_uuid.pop(uuid, None)
            if old is not None:
                self._by_token.pop(old.token, None)
            session = Session(token, uuid, kind, now)
            session.parked_at = now
            session.deadline = now + max(0.0, remaining)
            session.resumes = int(row.get("resumes", 0))
            session.undelivered = int(row.get("undelivered", 0))
            self._by_token[token] = session
            self._by_uuid[uuid] = session
            self.parked_total += 1
            adopted.append(uuid)
        return adopted

    # endregion

    # region: accounting + sweep

    def note_undelivered(self, uuid: uuid_mod.UUID) -> None:
        """A fan-out frame addressed a parked peer: counted, never
        buffered (PeerMap delivery path)."""
        session = self._by_uuid.get(uuid)
        if session is not None and session.parked:
            session.undelivered += 1
            self.undelivered_frames += 1
            if self.on_undelivered is not None:
                self.on_undelivered(uuid)

    def expire_due(self) -> list[uuid_mod.UUID]:
        """One reclamation pass: every parked session past its
        deadline leaves through ``on_expire`` (the server's normal
        teardown). Returns the reclaimed UUIDs."""
        now = self._clock()
        due = [
            s for s in self._by_uuid.values()
            if s.parked and now >= s.deadline
        ]
        reclaimed = []
        for session in due:
            self.discard(session.uuid)
            self.expired += 1
            if self.metrics is not None:
                self.metrics.inc("peers.evicted_session_expired")
            logger.info(
                "session for %s expired after %.1fs parked — "
                "reclaiming subscriptions and entities",
                session.uuid, self.ttl,
            )
            if self.on_expire is not None:
                try:
                    self.on_expire(session.uuid)
                except Exception:
                    logger.exception(
                        "session-expiry teardown failed for %s — "
                        "continuing the sweep", session.uuid,
                    )
            reclaimed.append(session.uuid)
        return reclaimed

    async def sweep(self) -> None:
        """Supervised sweeper loop (``session-sweep``): reclamation
        must survive a raising teardown hook and keep sweeping."""
        while True:
            await asyncio.sleep(self.sweep_interval)
            self.expire_due()

    # endregion

    def parked_count(self) -> int:
        return sum(1 for s in self._by_uuid.values() if s.parked)

    def stats(self) -> dict:
        """The ``sessions`` gauge + the /healthz block."""
        return {
            "ttl_s": self.ttl,
            "live": len(self._by_uuid),
            "parked": self.parked_count(),
            "minted": self.minted,
            "parked_total": self.parked_total,
            "resumed": self.resumed,
            "expired": self.expired,
            "discarded": self.discarded,
            "rejected_tokens": self.rejected_tokens,
            "undelivered_frames": self.undelivered_frames,
        }
