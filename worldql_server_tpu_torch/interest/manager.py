"""Per-recipient interest management: delta frames, LOD cadence,
bandwidth budgets.

The entity plane's tick result says, for every entity row, which peers
should see it. The pre-interest pipeline ships that as one
``entity.frame`` LocalMessage per (entity, tick) to every recipient —
O(recipients × neighbors × tick-rate) wire bytes no matter how little
moved. The :class:`InterestManager` replaces that leg per recipient
with a DIFF against the last state the peer provably received:

* **wire contract** — every frame's parameter is stamped by
  :func:`stamp`: ``entity.frame.full:<epoch>:<seq>`` /
  ``entity.frame.fullc:<epoch>:<seq>`` (chunk continuation) /
  ``entity.frame.delta:<epoch>:<seq>`` with fixed-width hex fields.
  ``seq`` is monotone and contiguous per peer within an ``epoch``; any
  loss path bumps the epoch and forces the next frame full, so a
  client (and the parity oracle) can PROVE it never applied a delta
  against a frame it never got: a same-epoch gap is a server bug, an
  epoch bump is a declared resync. Entered/moved neighbors ride as
  normal positioned entities; departed neighbors ride the same frame
  as tombstones (1-byte ``flex`` marker — short flex is already
  ignored by the velocity decode, so old readers see a harmless
  entity).
* **resync contract** — :meth:`InterestManager.mark_resync` is the ONE
  hook every loss path calls: reconnect/session-resume, undelivered
  frames to a parked session, ring-full drops, worker loss, overload
  eviction. It is idempotent and cheap (a flag); the next built frame
  for that peer opens a new epoch with a complete keyframe.
* **LOD cadence** — recipients partition per tick into near/far by the
  distance of each neighbor row to the recipient's own entity centroid
  (``lod_near_radius``; 0 = all near). Near rows deliver every tick;
  far rows every ``lod_far_every_k`` ticks (per-peer phase, so far
  bursts de-synchronize). Deferral is LOSSLESS: an off-cadence far
  update is simply retained in the diff base and ships on the next due
  tick — never dropped. The overload governor widens k
  (:meth:`note_governor`) instead of skipping frames blindly.
* **bandwidth budgets** — a token bucket per peer
  (``peer_bandwidth_bytes``/s). An unaffordable tick is DEFERRED whole
  (no state commit, no seq consumed — the diff accumulates), and the
  peer walks a demotion ladder: normal → forced-far cadence →
  keyframe-only. Only an unaffordable *keyframe* at the bottom of the
  ladder counts ``delivery.bytes_shed``; a delta is never truncated,
  so eventual-state parity holds under any budget.
* **cohort dedup** — peers whose frame would carry identical content
  share ONE encode (native or object path); per-peer epoch:seq stamps
  are byte-patched into a copy. This generalizes the entity plane's
  ``delta.frames_reused`` from clean-cohort replay to dirty cohorts
  with identical diffs.

This module is also the sequence-stamp authority: the ``tools/check``
rule ``unsequenced-frame`` fails any stamped-frame parameter literal
built outside it.
"""

from __future__ import annotations

import logging
import time
import uuid as uuid_mod

import numpy as np

from ..protocol.types import NIL_UUID, Entity, Instruction, Message, Vector3

logger = logging.getLogger(__name__)

#: stamped-frame parameter bases (see :func:`stamp`) — the lint rule
#: `unsequenced-frame` pins construction of these to THIS module
PARAM_FULL = "entity.frame.full"
PARAM_FULL_CONT = "entity.frame.fullc"
PARAM_DELTA = "entity.frame.delta"

#: max entities per frame: chunked fulls stay under the native decode
#: object cap (WQL_MAX_OBJS = 1024) with headroom
FRAME_CHUNK = 512

#: 1-byte flex marking a departed neighbor (any flex < 12 bytes is
#: ignored by the entity velocity decode, so pre-interest readers see
#: a harmless entity at its last position)
TOMBSTONE_FLEX = b"\x00"

#: demotion ladder states (bandwidth pressure)
DEMOTE_NONE = 0      # normal near/far cadence
DEMOTE_FAR = 1       # every row on the far cadence
DEMOTE_KEYFRAME = 2  # full keyframes on the far cadence, nothing else

_NIL_KEY = NIL_UUID.bytes


def stamp(kind: str, epoch: int, seq: int) -> str:
    """The ONE constructor for stamped frame parameters:
    ``<kind>:<epoch hex8>:<seq hex8>``. Fixed-width fields make every
    stamp of a kind the same length, which is what lets a cohort
    template be byte-patched per peer."""
    return f"{kind}:{epoch & 0xFFFFFFFF:08x}:{seq & 0xFFFFFFFF:08x}"


def parse_stamp(parameter: str) -> tuple[str, int, int] | None:
    """``(kind, epoch, seq)`` from a stamped frame parameter, or None
    when the parameter is not a stamped frame (e.g. the legacy
    ``entity.frame``)."""
    if parameter is None or not parameter.startswith("entity.frame."):
        return None
    parts = parameter.rsplit(":", 2)
    if len(parts) != 3:
        return None
    kind = parts[0]
    if kind not in (PARAM_FULL, PARAM_FULL_CONT, PARAM_DELTA):
        return None
    try:
        return kind, int(parts[1], 16), int(parts[2], 16)
    except ValueError:
        return None


class _WireFrame:
    """Pre-encoded outbound frame (mirror of entities.plane.WireFrame,
    local so the manager has no import cycle with the plane)."""

    __slots__ = ("wire", "_msg")

    def __init__(self, wire: bytes):
        self.wire = wire
        self._msg = None

    def __getattr__(self, name):
        msg = object.__getattribute__(self, "_msg")
        if msg is None:
            from ..protocol import deserialize_message

            msg = deserialize_message(self.wire)
            object.__setattr__(self, "_msg", msg)
        return getattr(msg, name)


class _PeerState:
    """One recipient's delivery ledger: the diff base (what the peer
    holds if it applied every frame), the epoch:seq cursor, the resync
    flag, and the bandwidth bucket."""

    __slots__ = (
        "epoch", "seq", "state", "resync", "demote", "tokens",
        "refilled_at", "deferrals",
    )

    def __init__(self, now: float, burst: float):
        self.epoch = 0
        self.seq = 0
        #: uuid16 bytes -> (wid, pos_f32x3 bytes) the peer holds
        self.state: dict[bytes, tuple[int, bytes]] = {}
        self.resync = True          # first frame of a peer is a keyframe
        self.demote = DEMOTE_NONE
        self.tokens = burst
        self.refilled_at = now
        self.deferrals = 0


class InterestManager:
    def __init__(
        self,
        *,
        near_radius: float = 0.0,
        far_every_k: int = 4,
        bandwidth_bytes: int = 0,
        metrics=None,
        clock=time.monotonic,
    ):
        self.near_radius = float(near_radius)
        self.far_every_k = max(1, int(far_every_k))
        self.bandwidth_bytes = int(bandwidth_bytes)
        #: bucket capacity: one second of budget, floored so a single
        #: keyframe at game shapes is always affordable from idle
        self.bandwidth_burst = float(max(self.bandwidth_bytes, 65536)) \
            if self.bandwidth_bytes else 0.0
        self.metrics = metrics
        self._clock = clock
        self._peers: dict[uuid_mod.UUID, _PeerState] = {}
        self._ticks = 0
        self._shed_level = 0
        self._tier_degraded = False
        #: cohort template cache, swapped wholesale per tick like the
        #: plane's _frame_cache: content key -> (template, e_off, s_off)
        self._templates: dict = {}
        # counters / last-tick gauges
        self.resyncs = 0
        self.bytes_shed = 0
        self.deferrals = 0
        self.templates_reused = 0
        self.last_delta_frames = 0
        self.last_full_frames = 0
        self.last_near = 0
        self.last_far = 0
        self.last_demoted = 0
        self.last_bytes = 0

    # region: resync + lifecycle hooks

    def mark_resync(self, peer: uuid_mod.UUID) -> None:
        """THE loss-path hook (idempotent): the next frame built for
        this peer opens a new epoch with a full keyframe. Called on
        ring drops, worker loss, undelivered-to-parked frames, session
        resume, send errors and overload eviction — a delta can never
        leak past a gap because every gap lands here first."""
        st = self._peers.get(peer)
        if st is None or st.resync:
            return
        st.resync = True
        self.resyncs += 1
        if self.metrics is not None:
            self.metrics.inc("interest.resyncs")

    def forget_peer(self, peer: uuid_mod.UUID) -> None:
        self._peers.pop(peer, None)

    def note_governor(self, shed_level: int, tier_degraded: bool) -> None:
        """Overload coupling: SHED tiers widen the far cadence
        (k << level) and a degraded tick tier halves the near cadence —
        the lossless replacement for blind frame skipping."""
        self._shed_level = max(0, min(3, int(shed_level)))
        self._tier_degraded = bool(tier_degraded)

    # endregion

    # region: frame building

    def build_pairs(self, plane, pos, targets, cap: int) -> list:
        """Replace ``EntityPlane._build_frames`` for one applied tick:
        per-recipient delta/full frames instead of per-entity
        broadcast. Returns the same ``(message, [target_uuid])`` pair
        shape ``PeerMap.deliver_batch`` consumes."""
        self._ticks += 1
        live = plane._live[:cap]
        valid = targets >= 0
        rows = np.flatnonzero(live & valid.any(axis=1))

        # invert row->targets into per-recipient visible row lists
        by_pid: dict[int, np.ndarray] = {}
        if rows.size:
            tgt = targets[rows]
            mask = tgt >= 0
            r_idx = np.repeat(rows, tgt.shape[1])[mask.ravel()]
            p_idx = tgt.ravel()[mask.ravel()]
            order = np.argsort(p_idx, kind="stable")
            p_sorted, r_sorted = p_idx[order], r_idx[order]
            bounds = np.flatnonzero(np.diff(p_sorted)) + 1
            for chunk, pid_val in zip(
                np.split(r_sorted, bounds),
                p_sorted[np.concatenate(([0], bounds))],
            ):
                by_pid[int(pid_val)] = np.unique(chunk)

        # peers with retained state but nothing visible still need
        # their departures delivered
        peers = set(by_pid)
        for u, st in self._peers.items():
            if st.state:
                pid = plane._peer_ids.get(u)
                if pid is not None:
                    peers.add(pid)

        near_every = 2 if self._tier_degraded else 1
        far_every = self.far_every_k << self._shed_level
        specs = []      # (uuid, st, frames_spec, new_state, committed_ticks)
        self.last_near = self.last_far = self.last_demoted = 0
        for pid in sorted(peers):
            if pid >= len(plane._peer_uuids):
                continue
            u = plane._peer_uuids[pid]
            st = self._peers.get(u)
            if st is None:
                st = self._peers[u] = _PeerState(
                    self._clock(), self.bandwidth_burst
                )
            spec = self._peer_spec(
                plane, pos, pid, st, by_pid.get(pid),
                near_every, far_every,
            )
            if spec is not None:
                specs.append((u, st) + spec)

        pairs = self._encode_specs(plane, specs)
        self.last_bytes = sum(len(m.wire) for m, _ in pairs)
        return pairs

    def _center_of(self, plane, pid: int):
        """The recipient's subscription center: centroid of its own
        live entities (None = no entities, everything is near)."""
        slots = plane._peer_slots.get(pid)
        if not slots:
            return None
        idx = np.fromiter(slots, np.intp, count=len(slots))
        return plane._pos[idx].mean(axis=0)

    def _peer_spec(self, plane, pos, pid, st, vrows, near_every,
                   far_every):
        """One recipient's frame decision for this tick. Returns
        ``(frame_specs, new_state)`` or None (nothing due). A
        frame_spec is ``(kind, world, entries)`` with entries
        ``[(uuid16, wid, pos_f32_bytes, tombstone)]``; stamping and
        encoding happen later so identical content can share one
        template."""
        demote = st.demote
        if demote:
            self.last_demoted += 1
        phase = (self._ticks + pid) % far_every == 0
        near_due = (self._ticks + pid) % near_every == 0
        resync = st.resync

        center = None
        if self.near_radius > 0.0 and not resync:
            center = self._center_of(plane, pid)

        new_state: dict[bytes, tuple[int, bytes]] = {}
        n_near = n_far = 0
        if vrows is not None and vrows.size:
            vpos = pos[vrows].astype(np.float32, copy=False)
            if resync or (self.near_radius <= 0.0 and demote == DEMOTE_NONE):
                near_mask = np.ones(len(vrows), bool)
            elif demote != DEMOTE_NONE:
                near_mask = np.zeros(len(vrows), bool)
            elif center is None:
                near_mask = np.ones(len(vrows), bool)
            else:
                d2 = ((vpos - center.astype(np.float32)) ** 2).sum(axis=1)
                near_mask = d2 <= np.float32(self.near_radius) ** 2
            n_near = int(near_mask.sum())
            n_far = len(vrows) - n_near
            for i, row in enumerate(vrows.tolist()):
                key = plane._uuid_bytes[row].tobytes()
                wid = int(plane._wid[row])
                prev = st.state.get(key)
                due = near_mask[i] and near_due or (not near_mask[i]) and phase
                if resync or due or prev is None and near_mask[i] and near_due:
                    new_state[key] = (wid, vpos[i].tobytes())
                elif prev is not None:
                    new_state[key] = prev      # off-cadence: retain
                # else: off-cadence far ENTER — defer until due
        self.last_near += n_near
        self.last_far += n_far

        # departures: keys the peer holds that are no longer visible.
        # Far-tier departures (by retained position) defer to the far
        # cadence like every other far change; resync drops the ledger
        # wholesale via the epoch bump.
        if not resync:
            for key, (wid, pos_b) in st.state.items():
                if key in new_state:
                    continue
                is_far = False
                if self.near_radius > 0.0 and center is not None \
                        and st.demote == DEMOTE_NONE:
                    old = np.frombuffer(pos_b, np.float32)
                    d2 = float(((old - center.astype(np.float32)) ** 2).sum())
                    is_far = d2 > self.near_radius ** 2
                elif st.demote != DEMOTE_NONE:
                    is_far = True
                if is_far and not phase:
                    new_state[key] = (wid, pos_b)  # defer the leave

        if resync:
            if not new_state and not st.state:
                return None            # nothing to clear, nothing to send
            frames = self._full_specs(new_state, st.state)
            return frames, new_state, True
        if demote == DEMOTE_KEYFRAME:
            if not phase:
                return None
            frames = self._full_specs(new_state, st.state)
            return (frames, new_state, False) if frames else None

        # delta: entered/moved as positioned entities, left as
        # tombstones, grouped per world
        by_world: dict[int, list] = {}
        for key, (wid, pos_b) in new_state.items():
            prev = st.state.get(key)
            if prev is None or prev[1] != pos_b or prev[0] != wid:
                if prev is not None and prev[0] != wid:
                    # world hop = leave old world + enter new
                    by_world.setdefault(prev[0], []).append(
                        (key, prev[0], prev[1], True)
                    )
                by_world.setdefault(wid, []).append(
                    (key, wid, pos_b, False)
                )
        for key, (wid, pos_b) in st.state.items():
            if key not in new_state:
                by_world.setdefault(wid, []).append((key, wid, pos_b, True))
        if not by_world:
            return None
        total = sum(len(v) for v in by_world.values())
        if total > FRAME_CHUNK:
            # a delta this large beats no full frame — declare a
            # resync (epoch bump) and ship chunked keyframes instead
            frames = self._full_specs(new_state, st.state)
            return frames, new_state, True
        frames = [
            (PARAM_DELTA, wid, sorted(entries))
            for wid, entries in sorted(by_world.items())
        ]
        return frames, new_state, False

    def _full_specs(self, new_state, old_state):
        """Chunked keyframe specs covering every world in the new
        state — plus an EMPTY full for a world the peer still holds
        that vanished entirely (the clear marker)."""
        by_world: dict[int, list] = {}
        for key, (wid, pos_b) in new_state.items():
            by_world.setdefault(wid, []).append((key, wid, pos_b, False))
        for key, (wid, _pos) in old_state.items():
            if wid not in by_world and key not in new_state:
                by_world[wid] = []
        frames = []
        for wid, entries in sorted(by_world.items()):
            entries.sort()
            if not entries:
                frames.append((PARAM_FULL, wid, []))
                continue
            for c0 in range(0, len(entries), FRAME_CHUNK):
                kind = PARAM_FULL if c0 == 0 else PARAM_FULL_CONT
                frames.append((kind, wid, entries[c0:c0 + FRAME_CHUNK]))
        return frames

    def _encode_specs(self, plane, specs) -> list:
        """Encode every peer's frame specs with cross-peer cohort
        dedup, apply bandwidth admission, commit ledgers, and emit
        delivery pairs."""
        next_templates: dict = {}
        pairs = []
        now = self._clock()
        self.last_delta_frames = self.last_full_frames = 0
        for u, st, frames, new_state, is_resync in specs:
            encoded = []
            nbytes = 0
            for kind, wid, entries in frames:
                ckey = (kind, wid, b"".join(
                    e[0] + e[2] + (b"\x01" if e[3] else b"\x00")
                    for e in entries
                ))
                tpl = next_templates.get(ckey)
                if tpl is None:
                    tpl = self._templates.get(ckey)
                    if tpl is not None:
                        self.templates_reused += 1
                        if self.metrics is not None:
                            self.metrics.inc("delta.frames_reused")
                else:
                    self.templates_reused += 1
                    if self.metrics is not None:
                        self.metrics.inc("delta.frames_reused")
                if tpl is None:
                    tpl = self._encode_template(plane, kind, wid, entries)
                next_templates[ckey] = tpl
                encoded.append((kind, tpl))
                nbytes += len(tpl[0])

            if self.bandwidth_bytes and not self._afford(st, nbytes, now):
                # lossless deferral: nothing sent, nothing committed —
                # the diff simply accumulates into the next frame
                self.deferrals += 1
                st.deferrals += 1
                if st.demote < DEMOTE_KEYFRAME:
                    st.demote += 1
                    self.last_demoted += 1
                elif is_resync or st.resync or not any(
                    k == PARAM_DELTA for k, _ in encoded
                ):
                    # bottom of the ladder AND the keyframe itself is
                    # unaffordable: the ONLY shed point, counted
                    self.bytes_shed += nbytes
                    if self.metrics is not None:
                        self.metrics.inc("delivery.bytes_shed", nbytes)
                continue

            if is_resync:
                st.epoch += 1
                st.seq = 0
                st.resync = False
            for kind, (tpl, e_off, s_off) in encoded:
                buf = bytearray(tpl)
                buf[e_off:e_off + 8] = b"%08x" % (st.epoch & 0xFFFFFFFF)
                buf[s_off:s_off + 8] = b"%08x" % (st.seq & 0xFFFFFFFF)
                st.seq += 1
                pairs.append((_WireFrame(bytes(buf)), [u]))
                if kind == PARAM_DELTA:
                    self.last_delta_frames += 1
                else:
                    self.last_full_frames += 1
            st.state = new_state
        self._templates = next_templates
        return pairs

    def _afford(self, st, nbytes: int, now: float) -> bool:
        rate = float(self.bandwidth_bytes)
        st.tokens = min(
            self.bandwidth_burst,
            st.tokens + (now - st.refilled_at) * rate,
        )
        st.refilled_at = now
        if st.tokens >= nbytes:
            st.tokens -= nbytes
            if st.demote and st.tokens >= self.bandwidth_burst * 0.5:
                st.demote -= 1          # headroom: walk back up
            return True
        return False

    def _encode_template(self, plane, kind: str, wid: int, entries):
        """One cohort's wire bytes with a zeroed stamp, plus the byte
        offsets of the epoch/seq hex fields for per-peer patching.
        Native single-pass encode when the library has the symbol; the
        object path is byte-identical (pinned by test)."""
        world = plane._world_names[wid] if 0 <= wid < len(
            plane._world_names
        ) else ""
        placeholder = stamp(kind, 0, 0)
        n = len(entries)
        wire = getattr(plane, "_wire", None)
        if wire is not None and getattr(wire, "can_encode_interest", False):
            keys = np.empty((n, 16), np.uint8)
            pos = np.empty((n, 3), np.float64)
            tomb = np.zeros(n, np.uint8)
            for i, (key, _wid, pos_b, dead) in enumerate(entries):
                keys[i] = np.frombuffer(key, np.uint8)
                pos[i] = np.frombuffer(pos_b, np.float32).astype(np.float64)
                tomb[i] = 1 if dead else 0
            buf = wire.encode_interest_frame(
                placeholder.encode(), world.encode(), keys, pos, tomb
            )
        else:
            ents = []
            for key, _wid, pos_b, dead in entries:
                p = np.frombuffer(pos_b, np.float32)
                ents.append(Entity(
                    uuid=uuid_mod.UUID(bytes=key),
                    position=Vector3(float(p[0]), float(p[1]), float(p[2])),
                    world_name=world,
                    flex=TOMBSTONE_FLEX if dead else None,
                ))
            from ..protocol import serialize_message

            buf = serialize_message(Message(
                instruction=Instruction.LOCAL_MESSAGE,
                parameter=placeholder,
                sender_uuid=NIL_UUID,
                world_name=world,
                entities=ents,
            ))
        needle = placeholder.encode()
        idx = buf.find(needle)
        if idx < 0:  # unreachable: the stamp is always encoded
            raise RuntimeError("stamp placeholder missing from frame")
        e_off = idx + len(kind) + 1
        s_off = e_off + 9
        return bytes(buf), e_off, s_off

    # endregion

    def stats(self) -> dict:
        total = self.last_delta_frames + self.last_full_frames
        return {
            "peers": len(self._peers),
            "near": self.last_near,
            "far": self.last_far,
            "demoted": self.last_demoted,
            "delta_frames": self.last_delta_frames,
            "full_frames": self.last_full_frames,
            "delta_ratio": round(
                self.last_delta_frames / total, 4
            ) if total else 0.0,
            "resyncs": self.resyncs,
            "deferrals": self.deferrals,
            "bytes_shed": self.bytes_shed,
            "templates_reused": self.templates_reused,
            "last_bytes": self.last_bytes,
            "far_every_k": self.far_every_k << self._shed_level,
        }
