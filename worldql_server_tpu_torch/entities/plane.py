"""EntityPlane: the device-resident moving-object workload.

Port of the JAX package's ``entities/plane.py``. One plane owns every
live entity as a slot in preallocated host SoA columns (``pos f32[cap,3]
| vel f32[cap,3] | wid i32 | pid i32``) plus their device twin, an
:class:`~worldql_server_tpu_torch.ops.tick.EntityState` of torch
tensors on the plane's device (``spatial/torchconf.py``: the card
unless the caller asks for the CPU). The host columns are the
authority: wire ingest mutates them at message-arrival time, each
ticker flush runs ONE ``simulation_tick`` (integrate → re-quantize →
spatial-hash rebuild → stencil kNN kernel, ops/tick.py), and the
collect fetches back integrated positions + per-entity neighbor
targets.

Columnar ingest: updates of LIVE entities stage into fixed
preallocated double-buffered columns (``pos/vel/has_vel/touched`` per
slot) instead of writing per-entity — coalescing IS the column
overwrite (last write per slot wins, per field), and the pre-dispatch
drain is a buffer flip + one vectorized masked fold into the authority
columns. The wire fast path (``ingest_columns``, fed by
protocol/entity_wire.wql_decode_entities through entities/ingest.py)
maps a whole recv batch's uuid keys to slots in one C-level pass and
stages every owned row without constructing a single Entity object;
registrations, removals, and exotic messages keep the object path
(``ingest``) — identical semantics, per-entity cost, control-plane
rates. The device twin is maintained INCREMENTALLY: a dirty-slot
bitmap tracks rows whose host authority diverged from the twin
(client updates, registrations, removals), and each dispatch scatters
only those rows into the twin's tensors IN PLACE (``index_put_``)
instead of re-shipping whole columns. Exactly the dirty rows ship: the
JAX plane pads them to pow2 buckets (a fixed shape ladder for jit) and
drops the out-of-range pad lanes on device; eager torch needs no fixed
shapes, and an out-of-range ``index_put_`` would raise on the CPU and
trip a device assert on the card, so the port has no pad lanes.

Capacity is a power-of-two tier (``_MIN_CAP`` floor), so the tick sees
a handful of shapes over a process lifetime. ``precompile()`` is the
boot warm-up: it builds and loads the kNN kernel and runs the tick at
the capacity tier and the delta-tick ladder, so ``nvcc`` never runs
inside a tick.

Index coupling (the bounded-staleness contract): every entity also
owns ONE subscription row in the authoritative spatial index — its
owner peer subscribed at the entity's current cube — refcounted per
``(world, cube, peer)`` so co-located entities of one peer share a
row. Registration inserts the row IMMEDIATELY (a new entity is
queryable before its first tick); position churn flows through the
index's mutation path when the tick's integrated position crosses a
cube boundary. Subscription queries therefore observe an entity's
position with staleness bounded by ONE applied tick.

Tick-path discipline: ``dispatch_tick``/``collect_tick`` are the
sim-tick hot functions — no per-entity Python. Kernels launch on the
current stream of the dispatching (event-loop) thread and the host
waits for the device only at the designated collect points
(``collect_tick`` on the worker thread). Frame assembly and index
churn (``apply``) are host delivery/index work, O(fan-out) and
O(churn) respectively, and run on the event loop like the router's
per-message handling.
"""

from __future__ import annotations

import itertools
import logging
import time
import uuid as uuid_mod
from collections import Counter

import numpy as np

import torch

from ..ops import build as kernel_build
from ..ops.tick import EntityState, make_tick_fn, state_from_numpy
from ..protocol import entity_wire
from ..robustness import failpoints
from ..protocol.types import Entity, Instruction, Message, Vector3
from ..spatial.hashing import spatial_keys
from ..spatial.quantize import cube_coords_batch
from ..spatial.torchconf import resolve_device
from ..utils.names import SanitizeError, sanitize_world_name

logger = logging.getLogger(__name__)

#: Message.parameter marking an entity-removal batch (any other
#: parameter — usually None — upserts the carried entities)
PARAM_REMOVE = "entity.remove"
#: Message.parameter stamped on outbound neighbor frames
PARAM_FRAME = "entity.frame"

#: smallest capacity tier (pow2); arrays never shrink below it
_MIN_CAP = 256
#: parked coordinate for dead slots: quantizes to the saturated cube of
#: the dead world (wid -1), far outside any live neighborhood
_DEAD_POS = np.float32(1.0e30)
#: smallest delta-tick sub-batch tier (pow2 ladder floor): the dirty
#: closure pads up to this before the sub-kernel launches, so steady
#: low-churn serving reuses a handful of compiled shapes
_DELTA_MIN_TIER = 64
#: world-name fallback envelope for wire-path registrations (the world
#: is always resolved before this is consulted)
_WIRE_MSG = Message(instruction=Instruction.LOCAL_MESSAGE)


def _next_pow2(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


class WireFrame:
    """A pre-encoded outbound frame: ready wire bytes standing in for a
    Message in ``PeerMap.deliver_batch`` pairs (which reads ``.wire``
    and never re-serializes when it is set). The native per-cohort
    frame encode hands these out so the apply leg constructs no
    per-entity Message objects. Message attributes (``entities``,
    ``parameter``, …) resolve lazily by decoding the wire bytes —
    diagnostics-only; the delivery path never triggers it."""

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


class _StageBuf:
    """One side of the double-buffered update-staging columns: the LWW
    coalescing surface. ``touched[slot]`` marks a staged position;
    ``has_vel[slot]`` marks a staged velocity (fields coalesce
    independently, exactly like sequential application)."""

    __slots__ = ("pos", "vel", "has_vel", "touched", "dirty")

    def __init__(self, cap: int):
        self.pos = np.zeros((cap, 3), np.float32)
        self.vel = np.zeros((cap, 3), np.float32)
        self.has_vel = np.zeros(cap, bool)
        self.touched = np.zeros(cap, bool)
        self.dirty = False  # any touched bit set since the last flip

    def grow(self, cap: int) -> None:
        old = self.touched.shape[0]
        for name in ("pos", "vel"):
            out = np.zeros((cap, 3), np.float32)
            out[:old] = getattr(self, name)
            setattr(self, name, out)
        for name in ("has_vel", "touched"):
            out = np.zeros(cap, bool)
            out[:old] = getattr(self, name)
            setattr(self, name, out)


def _scatter_update(state: EntityState, idx, pos, vel, wid, pid) -> None:
    """Scatter dirty host rows (``idx``, all in range) into the device
    twin IN PLACE — the incremental H2D leg (only touched slots ship,
    never whole columns)."""
    dev = state.position.device
    rows = torch.from_numpy(idx.astype(np.int64)).to(dev)
    for col, vals in zip(state, (pos, vel, wid, pid)):
        col.index_put_((rows,), torch.from_numpy(vals).to(dev))


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Device → host copy as an independent, writable numpy array (on
    the CPU a plain ``.cpu()`` would alias the device twin)."""
    return t.to("cpu", copy=True).numpy()


class EntityPlane:
    """Device-resident entity population + its authoritative-index
    coupling for one server. Event-loop owned except where noted."""

    def __init__(
        self,
        backend,
        peer_map,
        *,
        cube_size: int,
        k: int = 8,
        dt: float = 0.05,
        bounds: float = 1000.0,
        max_entities: int = 1 << 16,
        metrics=None,
        tracer=None,
        governor=None,
        wire="auto",
        delta_ticks: str = "off",
        delta_rebuild_threshold: float = 0.5,
        device=None,
    ):
        self.device = resolve_device(device)
        index_device = getattr(backend, "device", None)
        if index_device is not None and index_device != self.device:
            # the plane's churn feeds the device index directly
            # (bulk_move_subscriptions): both live on one device
            raise ValueError(
                f"entity plane on {self.device} but its subscription "
                f"index on {index_device}: both must share one device"
            )
        self.backend = backend
        self.peer_map = peer_map
        self.cube_size = cube_size
        self.k = int(k)
        self.dt = float(dt)
        self.bounds = float(bounds)
        self.max_entities = int(max_entities)
        self.metrics = metrics
        self.tracer = tracer
        # Optional robustness.overload.OverloadGovernor: under
        # SHED_LOW+ updates of LIVE entities coalesce last-write-wins
        # per slot into the staging columns and apply once per tick —
        # lossless for position streams (the newest value per field
        # subsumes the ones it overwrote). Registrations and removals
        # always apply immediately (control plane).
        self._governor = governor
        self.coalesced = 0
        self.frames_skipped = 0

        # host SoA columns (authority; slot-indexed, pow2 capacity)
        self._cap = _MIN_CAP
        self._pos = np.full((self._cap, 3), _DEAD_POS, np.float32)
        self._vel = np.zeros((self._cap, 3), np.float32)
        self._wid = np.full(self._cap, -1, np.int32)
        self._pid = np.full(self._cap, -1, np.int32)
        #: cube currently registered in the authoritative index
        self._cube = np.zeros((self._cap, 3), np.int64)
        self._live = np.zeros(self._cap, bool)
        #: slots mutated by wire ingest since the LAST dispatch — the
        #: post-tick position writeback must not clobber them
        self._touched = np.zeros(self._cap, bool)
        #: binary uuid per slot (frame encode + wire-path slot map)
        self._uuid_bytes = np.zeros((self._cap, 16), np.uint8)
        #: double-buffered update-staging columns: ingest writes the
        #: active side; the pre-dispatch drain flips and folds the
        #: retired side in one vectorized pass (replaces the per-uuid
        #: earlier per-uuid _pending dict)
        self._stage = [_StageBuf(self._cap), _StageBuf(self._cap)]
        self._stage_active = 0
        #: slots whose host authority diverged from the device twin
        #: since its last upload — the incremental-H2D scatter set
        self._device_dirty = np.zeros(self._cap, bool)
        self._dev_state: EntityState | None = None
        self._dev_cap = 0

        # Delta sim ticks (ROADMAP 2): instead of re-running the full
        # integrate→sort→kNN kernel over every slot each tick, gather
        # the DIRTY-CUBE CLOSURE — all live entities in any cube a
        # dirty entity occupies now or can reach this tick — into a
        # pow2 sub-batch, run the SAME tick kernel at that (smaller)
        # tier, and splice the results over the retained last-tick
        # arrays; clean entities replay. Requires a pow2 cube size:
        # the host-side reach prediction replays the device's f32
        # integration bit-for-bit and quantizes with the golden host
        # quantizer, whose agreement with the device quantizer is
        # pinned EXACT for pow2 sizes (tests/test_quantizer_envelope).
        pow2_cube = cube_size == _next_pow2(cube_size)
        self._delta_ticks = delta_ticks in ("on", "auto") and pow2_cube
        if delta_ticks == "on" and not pow2_cube:
            logger.warning(
                "delta_ticks='on' needs a power-of-two cube size for "
                "the exact quantizer envelope (got %d) — running full "
                "recompute ticks", cube_size,
            )
        self.delta_rebuild_threshold = float(delta_rebuild_threshold)
        #: slots mutated since the last SUCCESSFUL dispatch (the delta
        #: dirty stream; _device_dirty can't serve — it clears on H2D)
        self._window_dirty = np.zeros(self._cap, bool)
        #: (wid, cx, cy, cz) cubes vacated by removals this window —
        #: the slot's wid/cube columns are wiped at release time
        self._window_dirty_cubes: list[tuple] = []
        #: retained last applied tick (the replay source)
        self._have_last = False
        self._last_cap = 0
        self._last_targets: np.ndarray | None = None
        self._last_counts: np.ndarray | None = None
        self._last_pos: np.ndarray | None = None
        self.delta_sim_ticks = 0
        self.full_sim_ticks = 0
        self.delta_reused = 0
        self.delta_recomputed = 0
        self.delta_fallbacks = 0
        self.delta_mispredicts = 0
        self.last_delta_stats: dict = {}

        self._n = 0                     # slot high-water mark
        self._free: list[int] = []      # recycled slots below _n
        self._slot_of: dict[uuid_mod.UUID, int] = {}
        #: 16-byte uuid key → slot (the wire path's C-level bulk map)
        self._slot_of_key: dict[bytes, int] = {}
        self._uuid_of: dict[int, uuid_mod.UUID] = {}

        # interning (plane-local dense ids; the INDEX interns its own)
        self._world_ids: dict[str, int] = {}
        self._world_names: list[str] = []
        self._peer_ids: dict[uuid_mod.UUID, int] = {}
        self._peer_uuids: list[uuid_mod.UUID] = []
        #: binary uuid per dense peer id (cohort frame senders)
        self._peer_key_arr = np.zeros((64, 16), np.uint8)
        #: per-peer entity slots (eviction sweep)
        self._peer_slots: dict[int, set[int]] = {}

        # native columnar wire codec: "auto" = the shared in-tree
        # library (symbol-probed; stale .so → None and every leg
        # degrades to the object path), None/instance for tests
        self._wire = entity_wire.shared() if wire == "auto" else wire

        #: interest manager (``--interest on``): when set, apply()
        #: routes the frame leg through per-recipient delta frames
        #: instead of _build_frames. None (the default) keeps the
        #: legacy broadcast path byte for byte — the manager is never
        #: consulted, constructed, or imported on that path.
        self.interest = None

        #: (wid, cx, cy, cz, pid) → live-entity refcount backing ONE
        #: index row; transitions through 0 mutate the index
        self._sub_refs: Counter = Counter()

        # one tick fn for every tier; on the card it launches the
        # hand-written kNN kernel (ops/knn.py)
        self._tick_fn = make_tick_fn(
            cube_size=cube_size, k=self.k, dt=self.dt, bounds=self.bounds,
        )
        self._tick_inflight = False

        # stats (exposed via the entity_sim gauge + bench config 8)
        self.entities_registered = 0
        self.entities_removed = 0
        self.updates = 0
        self.rejected = 0
        self.dispatches = 0
        self.applied_ticks = 0
        self.dropped_ticks = 0
        self.frames = 0
        self.index_moves = 0
        self.last_integrate_ms = 0.0
        self.last_knn_ms = 0.0
        self.last_apply_ms = 0.0
        self.last_churn = 0
        # columnar-path stats (wire rows staged with zero per-entity
        # Python; flips; H2D split; native cohort-encoded frames)
        self.wire_rows = 0
        self.wire_slow_rows = 0
        self.column_flips = 0
        self.h2d_full = 0
        self.h2d_scatter = 0
        self.scatter_fallbacks = 0  # scatter errors → full upload
        self.last_h2d_rows = 0
        self.frames_native = 0
        # Frame-level reuse:
        # a cohort whose membership AND member positions did not
        # change since last tick replays last tick's encoded wire
        # bytes instead of re-running wql_encode_entity_frames —
        # keyed by the cohort key, guarded by exact row/position
        # byte equality, invalidated wholesale by any slot identity
        # change (registration/removal clears it: uuid/pid bytes at a
        # reused slot would otherwise alias a stale frame).
        self._frame_cache: dict[bytes, tuple] = {}
        self.frames_reused = 0

    # region: wire ingest (router arrival path)

    @property
    def entity_count(self) -> int:
        return len(self._slot_of)

    def active(self) -> bool:
        return bool(self._slot_of)

    def ingest(self, message: Message) -> int:
        """Apply one inbound entity batch THE OBJECT WAY: upsert every
        carried Entity (or remove, when ``parameter ==
        'entity.remove'``) for the sending peer. This is the semantic
        reference and the fallback for everything the columnar wire
        path (``ingest_columns``) routes around — removals, exotic
        parameters/uuid formats, per-entity worlds, a stale native
        library. Returns entities applied."""
        sender = message.sender_uuid
        removing = message.parameter == PARAM_REMOVE
        governor = self._governor
        coalesce = (
            not removing
            and governor is not None
            and governor.coalesce_entities()
        )
        applied = 0
        for ent in message.entities:  # wql: allow(per-entity-python-ingest) — the object-path semantic reference; hot traffic rides ingest_columns
            try:
                if removing:
                    applied += self._remove_entity(ent.uuid, sender)
                elif coalesce and ent.uuid in self._slot_of:
                    applied += self._stage_update(ent, message, sender)
                else:
                    applied += self._upsert(ent, message, sender)
            except SanitizeError as exc:
                logger.warning(
                    "peer %s sent entity with invalid world %r (%s)",
                    sender, ent.world_name or message.world_name, exc,
                )
        if applied and self.metrics is not None:
            self.metrics.inc("sim.updates", applied)
        self.updates += applied
        return applied

    def _stage_update(self, ent: Entity, message: Message,
                      sender: uuid_mod.UUID) -> int:
        """Coalescing admission (governor SHED_LOW+), object-path leg:
        stage the update of a LIVE entity into the columnar staging
        buffer — coalescing IS the column overwrite (last write per
        slot wins, per field); ``_drain_pending`` folds the survivors
        in one vectorized pass at the next dispatch. Ownership and
        world sanitation are enforced HERE so a hostile update can't
        hide in the staging columns. An overwrite counts as
        ``overload.coalesced`` — shed-but-lossless work (the audit
        invariant: offered == applied + coalesced + dropped)."""
        sanitize_world_name(ent.world_name or message.world_name)
        slot = self._slot_of[ent.uuid]
        owner = self._peer_uuids[self._pid[slot]]
        if owner != sender:
            logger.warning(
                "peer %s sent update for entity %s owned by %s — "
                "dropped", sender, ent.uuid, owner,
            )
            return 0
        buf = self._stage[self._stage_active]
        first = not buf.touched[slot]
        p = ent.position
        buf.pos[slot, 0] = p.x
        buf.pos[slot, 1] = p.y
        buf.pos[slot, 2] = p.z
        vel = _decode_velocity(ent.flex)
        if vel is not None:
            buf.vel[slot] = vel
            buf.has_vel[slot] = True
        buf.touched[slot] = True
        buf.dirty = True
        if first:
            return 1
        self.coalesced += 1
        if self.metrics is not None:
            self.metrics.inc("overload.coalesced")
        return 0

    def _drain_pending(self) -> None:
        """Fold the staged update columns into the host authority —
        the buffer flip that replaced a per-uuid dict walk: flip
        the double buffer (ingest keeps writing the fresh side), then
        apply the retired side's touched rows as one masked copy per
        column. The coalescing staleness bound is the same one tick
        the plane already documents."""
        buf = self._stage[self._stage_active]
        if not buf.dirty:
            return
        self._stage_active ^= 1
        rows = np.flatnonzero(buf.touched)
        self._pos[rows] = buf.pos[rows]
        hv = rows[buf.has_vel[rows]]
        if hv.size:
            self._vel[hv] = buf.vel[hv]
        # a client update must win over the in-flight tick's writeback,
        # and its rows must ship to the device twin at this dispatch
        self._touched[rows] = True
        self._device_dirty[rows] = True
        self._window_dirty[rows] = True
        buf.touched[rows] = False
        buf.has_vel[rows] = False
        buf.dirty = False
        self.column_flips += 1

    def staged_count(self) -> int:
        """Touched rows awaiting the next flip (test/gauge probe)."""
        return int(np.count_nonzero(self._stage[self._stage_active].touched))

    def is_staged(self, eid: uuid_mod.UUID) -> bool:
        slot = self._slot_of.get(eid)
        if slot is None:
            return False
        return bool(self._stage[self._stage_active].touched[slot])

    def ingest_columns(
        self,
        senders: list,
        worlds: list,
        counts: np.ndarray,
        uuid_keys: np.ndarray,
        pos: np.ndarray,
        vel: np.ndarray,
        has_vel: np.ndarray,
    ) -> int:
        """Wire→SoA fast path: stage a whole recv batch's entity
        updates with zero per-entity Python. ``senders``/``worlds`` are
        per message; ``counts[i]`` rows of the shared columns belong to
        message i. uuid→slot mapping is one C-level bulk dict pass;
        ownership is enforced vectorized at stage time; position/
        velocity staging is a fancy-indexed column overwrite whose
        last-write-wins order is exactly arrival order. Only rows whose
        uuid is unknown (registrations — control-plane rates) take the
        per-entity object path. Returns entities applied, mirroring
        ``ingest``'s accounting."""
        n_bufs = len(senders)
        total = int(counts.sum())
        if total == 0:
            return 0
        pids = np.empty(n_bufs, np.int32)
        buf_ok = np.ones(n_bufs, bool)
        for b in range(n_bufs):
            try:
                worlds[b] = sanitize_world_name(worlds[b])
                pids[b] = self._peer_ids.get(senders[b], -1)
            except SanitizeError as exc:
                logger.warning(
                    "peer %s sent entity batch with invalid world %r "
                    "(%s)", senders[b], worlds[b], exc,
                )
                buf_ok[b] = False
                pids[b] = -1
        row_buf = np.repeat(np.arange(n_bufs), counts)
        row_ok = buf_ok[row_buf]
        exp_pid = pids[row_buf]

        # V16 (not S16): bytes_ views strip trailing NULs, void keeps
        # all 16 bytes — the keys must match uuid.bytes exactly
        keys = uuid_keys.reshape(total, 16).view("V16").ravel().tolist()
        slots = np.fromiter(
            map(self._slot_of_key.get, keys, itertools.repeat(-1)),
            np.int64, count=total,
        )
        hit = (slots >= 0) & row_ok
        safe = np.where(hit, slots, 0)
        owned = hit & (self._pid[safe] == exp_pid)
        stolen = int(hit.sum()) - int(owned.sum())
        if stolen:
            logger.warning(
                "%d entity updates for entities their senders do not "
                "own — dropped", stolen,
            )

        applied = 0
        orows = np.flatnonzero(owned)
        if orows.size:
            s = slots[orows]
            buf = self._stage[self._stage_active]
            governor = self._governor
            if governor is not None and governor.coalesce_entities():
                # dict-parity accounting: first stage per slot applies,
                # every overwrite (intra-batch duplicates included)
                # counts as coalesced — shed-but-lossless
                uniq = np.unique(s)
                fresh = int(np.count_nonzero(~buf.touched[uniq]))
                over = int(orows.size) - fresh
                if over:
                    self.coalesced += over
                    if self.metrics is not None:
                        self.metrics.inc("overload.coalesced", over)
                applied += fresh
            else:
                applied += int(orows.size)
            buf.pos[s] = pos[orows]
            hv = has_vel[orows].astype(bool)
            if hv.any():
                sv = s[hv]
                buf.vel[sv] = vel[orows][hv]
                buf.has_vel[sv] = True
            buf.touched[s] = True
            buf.dirty = True
            self.wire_rows += int(orows.size)

        # unknown uuids: registrations (or intra-batch updates of one
        # just registered) — the per-entity object path is the right
        # cost for this control-plane traffic, and re-probing the slot
        # map per row keeps intra-batch arrival order exact
        miss = row_ok & (slots < 0)
        for r in np.flatnonzero(miss).tolist():  # wql: allow(per-entity-python-ingest) — registrations only; update traffic stays columnar
            b = int(row_buf[r])
            applied += self._wire_slow_row(
                keys[r], worlds[b], pos[r], vel[r], bool(has_vel[r]),
                senders[b],
            )
            self.wire_slow_rows += 1

        if applied:
            self.updates += applied
            if self.metrics is not None:
                self.metrics.inc("sim.updates", applied)
        return applied

    def _wire_slow_row(self, key: bytes, world: str, p, v,
                       has_v: bool, sender: uuid_mod.UUID) -> int:
        """One columnar row routed through the object path (its uuid
        was unknown at batch start): registration — or, for a uuid
        registered earlier in the same batch, a normal owned update."""
        ent = Entity(
            uuid=uuid_mod.UUID(bytes=key),
            position=Vector3(float(p[0]), float(p[1]), float(p[2])),
            world_name=world,
            flex=v.tobytes() if has_v else None,
        )
        try:
            return self._upsert(ent, _WIRE_MSG, sender)
        except SanitizeError:
            return 0  # world sanitized upstream; belt and braces

    def _upsert(self, ent: Entity, message: Message,
                sender: uuid_mod.UUID) -> int:
        world = sanitize_world_name(ent.world_name or message.world_name)
        slot = self._slot_of.get(ent.uuid)
        new = slot is None
        if new:
            if len(self._slot_of) >= self.max_entities:
                self.rejected += 1
                if self.metrics is not None:
                    self.metrics.inc("sim.rejected")
                logger.warning(
                    "entity registration rejected: plane full "
                    "(%d >= max_entities %d)",
                    len(self._slot_of), self.max_entities,
                )
                return 0
            slot = self._alloc_slot(ent.uuid, sender, world)
            self.entities_registered += 1
        else:
            owner = self._peer_uuids[self._pid[slot]]
            if owner != sender:
                # an entity belongs to the peer that registered it;
                # a hijacking update is dropped, not transferred
                logger.warning(
                    "peer %s sent update for entity %s owned by %s — "
                    "dropped", sender, ent.uuid, owner,
                )
                return 0
        p = ent.position
        self._pos[slot, 0] = p.x
        self._pos[slot, 1] = p.y
        self._pos[slot, 2] = p.z
        vel = _decode_velocity(ent.flex)
        if vel is not None:
            self._vel[slot] = vel
        self._touched[slot] = True
        self._device_dirty[slot] = True
        self._window_dirty[slot] = True
        if new:
            # index coupling: queryable before the first tick
            self._register_cube(slot)
        return 1

    def _alloc_slot(self, uuid: uuid_mod.UUID, sender: uuid_mod.UUID,
                    world: str) -> int:
        if self._free:
            slot = self._free.pop()
        else:
            if self._n == self._cap:
                self._grow(self._cap * 2)
            slot = self._n
            self._n += 1
        wid = self._world_ids.get(world)
        if wid is None:
            wid = self._world_ids[world] = len(self._world_names)
            self._world_names.append(world)
        pid = self._peer_ids.get(sender)
        if pid is None:
            pid = self._peer_ids[sender] = len(self._peer_uuids)
            self._peer_uuids.append(sender)
            if pid >= self._peer_key_arr.shape[0]:
                out = np.zeros(
                    (self._peer_key_arr.shape[0] * 2, 16), np.uint8
                )
                out[: self._peer_key_arr.shape[0]] = self._peer_key_arr
                self._peer_key_arr = out
            self._peer_key_arr[pid] = np.frombuffer(sender.bytes, np.uint8)
        self._slot_of[uuid] = slot
        self._slot_of_key[uuid.bytes] = slot
        self._uuid_of[slot] = uuid
        self._uuid_bytes[slot] = np.frombuffer(uuid.bytes, np.uint8)
        self._wid[slot] = wid
        self._pid[slot] = pid
        self._vel[slot] = 0.0
        self._live[slot] = True
        # slot identity changed: cached frames keyed on row indices
        # could alias the new occupant — drop them all
        self._frame_cache.clear()
        self._peer_slots.setdefault(pid, set()).add(slot)
        # index coupling: a fresh entity is queryable IMMEDIATELY —
        # its row enters the index's delta path in this same turn.
        # The cube registers from the wire position below via the
        # same refcount transition churn uses.
        self._cube[slot] = 0  # filled by _register_cube after pos write
        return slot

    def _register_cube(self, slot: int) -> None:
        """Refcount-in the slot's CURRENT position cube (registration
        path; churn uses the vectorized transition in apply())."""
        cube = cube_coords_batch(
            self._pos[slot].astype(np.float64), self.cube_size
        )
        self._cube[slot] = cube
        self._ref_add(
            int(self._wid[slot]), cube, int(self._pid[slot]),
        )

    def _ref_key(self, wid: int, cube, pid: int) -> tuple:
        return (wid, int(cube[0]), int(cube[1]), int(cube[2]), pid)

    def _ref_add(self, wid: int, cube, pid: int) -> None:
        key = self._ref_key(wid, cube, pid)
        self._sub_refs[key] += 1
        if self._sub_refs[key] == 1:
            self.backend.add_subscription(
                self._world_names[wid], self._peer_uuids[pid],
                (int(cube[0]), int(cube[1]), int(cube[2])),
            )

    def _ref_drop(self, wid: int, cube, pid: int) -> None:
        key = self._ref_key(wid, cube, pid)
        self._sub_refs[key] -= 1
        if self._sub_refs[key] <= 0:
            del self._sub_refs[key]
            self.backend.remove_subscription(
                self._world_names[wid], self._peer_uuids[pid],
                (int(cube[0]), int(cube[1]), int(cube[2])),
            )

    def _remove_entity(self, uuid: uuid_mod.UUID,
                       sender: uuid_mod.UUID | None) -> int:
        slot = self._slot_of.get(uuid)
        if slot is None:
            return 0
        pid = int(self._pid[slot])
        if sender is not None and self._peer_uuids[pid] != sender:
            logger.warning(
                "peer %s sent remove for entity %s it does not own — "
                "dropped", sender, uuid,
            )
            return 0
        self._ref_drop(int(self._wid[slot]), self._cube[slot], pid)
        self._release_slot(slot, pid)
        return 1

    def _release_slot(self, slot: int, pid: int) -> None:
        if self._delta_ticks:
            # the vacated cube must dirty (its remaining residents'
            # neighborhoods change) and the slot's retained results
            # must blank — wid/cube wipe below loses both otherwise
            self._window_dirty_cubes.append((
                int(self._wid[slot]), int(self._cube[slot, 0]),
                int(self._cube[slot, 1]), int(self._cube[slot, 2]),
            ))
            self._window_dirty[slot] = False  # dead slots never compute
            if self._have_last:
                self._last_targets[slot] = -1
                self._last_counts[slot] = 0
        uuid = self._uuid_of.pop(slot)
        del self._slot_of[uuid]
        self._slot_of_key.pop(uuid.bytes, None)
        # a staged update must not resurrect a removed entity at the
        # flip: clear the slot's staging bits on both buffer sides
        for buf in self._stage:
            buf.touched[slot] = False
            buf.has_vel[slot] = False
        slots = self._peer_slots.get(pid)
        if slots is not None:
            slots.discard(slot)
            if not slots:
                del self._peer_slots[pid]
        self._live[slot] = False
        self._touched[slot] = False
        self._wid[slot] = -1
        self._pid[slot] = -1
        self._pos[slot] = _DEAD_POS
        self._vel[slot] = 0.0
        self._uuid_bytes[slot] = 0
        # the parked values must reach the device twin
        self._device_dirty[slot] = True
        self._free.append(slot)
        # slot identity changed (see _alloc_slot): cached frames over
        # this row are stale the moment the slot is reusable
        self._frame_cache.clear()
        self.entities_removed += 1

    def on_peer_removed(self, peer: uuid_mod.UUID) -> int:
        """Disconnect sweep: drop every entity the peer owned. The
        server purges the peer's index rows wholesale via
        ``backend.remove_peer`` BEFORE this hook runs, so only the
        plane-side bookkeeping (slots + refcounts) is released here."""
        pid = self._peer_ids.get(peer)
        if self.interest is not None:
            self.interest.forget_peer(peer)
        if pid is None:
            return 0
        removed = 0
        for slot in list(self._peer_slots.get(pid, ())):
            key = self._ref_key(
                int(self._wid[slot]), self._cube[slot], pid
            )
            self._sub_refs.pop(key, None)  # index row already purged
            self._release_slot(slot, pid)
            removed += 1
        return removed

    # region: world migration (live resharding)

    def export_world(self, world: str) -> list[dict]:
        """Snapshot every live entity of ``world`` as JSON-safe rows —
        the entity leg of a migration capsule. Ownership rides along
        (``owner`` hex): the new shard must enforce the same
        owner-only update rule the old one did."""
        wid = self._world_ids.get(world)
        if wid is None:
            return []
        rows = []
        for slot in np.flatnonzero(self._live & (self._wid == wid)):
            slot = int(slot)
            rows.append({
                "uuid": self._uuid_of[slot].hex,
                "owner": self._peer_uuids[int(self._pid[slot])].hex,
                "pos": [float(v) for v in self._pos[slot]],
                "vel": [float(v) for v in self._vel[slot]],
            })
        return rows

    def import_world(self, world: str, rows: list[dict]) -> int:
        """Replay exported entity rows into THIS plane through the
        normal registration path (``_upsert``), so index coupling,
        refcounts, and device-dirty tracking all engage exactly as a
        live registration would."""
        applied = 0
        for row in rows:
            try:
                ent = Entity(
                    uuid=uuid_mod.UUID(hex=row["uuid"]),
                    position=Vector3(*(float(v) for v in row["pos"])),
                    world_name=world,
                    flex=np.asarray(
                        row.get("vel") or (0.0, 0.0, 0.0), np.float32
                    ).tobytes(),
                )
                owner = uuid_mod.UUID(hex=row["owner"])
            except (KeyError, TypeError, ValueError):
                continue
            applied += self._upsert(ent, _WIRE_MSG, owner)
        return applied

    def remove_world(self, world: str) -> int:
        """Tombstone leg: drop every entity of ``world`` through the
        normal removal path (refcount transition included, so the
        backend index rows leave with the slots)."""
        wid = self._world_ids.get(world)
        if wid is None:
            return 0
        removed = 0
        for slot in np.flatnonzero(self._live & (self._wid == wid)):
            slot = int(slot)
            pid = int(self._pid[slot])
            self._ref_drop(wid, self._cube[slot], pid)
            self._release_slot(slot, pid)
            removed += 1
        return removed

    # endregion

    def _grow(self, cap: int) -> None:
        """Double the capacity tier (pow2): reallocate every column,
        preserving slots. The next dispatch compiles the new tier —
        visible in device.retraces as a tier first hit, exactly like
        the query engine's capacity ladder."""
        def grow2(arr, fill, dtype, width=None):
            shape = (cap,) if width is None else (cap, width)
            out = np.full(shape, fill, dtype)
            out[: self._cap] = arr
            return out

        self._pos = grow2(self._pos, _DEAD_POS, np.float32, 3)
        self._vel = grow2(self._vel, 0.0, np.float32, 3)
        self._wid = grow2(self._wid, -1, np.int32)
        self._pid = grow2(self._pid, -1, np.int32)
        self._cube = grow2(self._cube, 0, np.int64, 3)
        self._live = grow2(self._live, False, bool)
        self._touched = grow2(self._touched, False, bool)
        self._uuid_bytes = grow2(self._uuid_bytes, 0, np.uint8, 16)
        self._device_dirty = grow2(self._device_dirty, False, bool)
        self._window_dirty = grow2(self._window_dirty, False, bool)
        for buf in self._stage:
            buf.grow(cap)
        # shape change: the next dispatch re-ships the whole tier and
        # the retained last-tick arrays no longer fit — full recompute
        self._dev_state = None
        self._have_last = False
        self._cap = cap
        logger.info("entity plane grew to capacity tier %d", cap)

    # endregion

    # region: sim tick (ticker flush path)

    def _upload_state(self, cap: int) -> EntityState:
        """Device input for this tick: the persistent twin with only
        the DIRTY slots scattered in (incremental H2D), or a full-tier
        upload when there is no valid twin / the tier changed / the
        dirty set is dense enough that one straight re-ship wins."""
        dev = self._dev_state
        if dev is not None and self._dev_cap == cap:
            dirty = np.flatnonzero(self._device_dirty[:cap])
            if dirty.size == 0:
                self.last_h2d_rows = 0
                return dev
            if dirty.size <= cap // 2:
                try:
                    # entities.scatter: the incremental-H2D loss
                    # boundary — a scatter failure (or an armed chaos
                    # fault) degrades to one full-tier upload below,
                    # counted; the dirty bitmap is cleared only AFTER
                    # the scatter succeeds, so no row is ever lost to
                    # a failed partial transfer
                    failpoints.fire("entities.scatter")
                    _scatter_update(dev, dirty, self._pos[dirty],
                                    self._vel[dirty], self._wid[dirty],
                                    self._pid[dirty])
                    self._device_dirty[:cap] = False
                    self.h2d_scatter += 1
                    self.last_h2d_rows = int(dirty.size)
                    return dev
                except Exception:
                    self.scatter_fallbacks += 1
                    if self.metrics is not None:
                        self.metrics.inc("sim.scatter_fallbacks")
                    logger.exception(
                        "incremental H2D scatter failed (%d dirty "
                        "rows) — degrading to a full-tier upload",
                        int(dirty.size),
                    )
        self._device_dirty[:cap] = False
        self._dev_cap = cap
        self.h2d_full += 1
        self.last_h2d_rows = cap
        return state_from_numpy(
            self._pos, self._vel, self._wid, self._pid, self.device
        )

    def dispatch_tick(self):
        """Launch one simulation tick from the host columns (event-loop
        thread; tick.sim.integrate span): fold the staged update
        columns, pick the delta or full path, and launch the tick (when
        any device work is owed) without waiting for it; the D2H copy
        happens at ``collect_tick``. Returns an opaque handle for ``collect_tick`` or None when idle
        / a previous tick is still in flight (pipelined flushes never
        stack sim ticks — the writeback of tick N is input to tick
        N+1)."""
        self._drain_pending()  # staged updates fold tick-edge
        if not self._slot_of or self._tick_inflight:
            return None
        t0 = time.perf_counter()
        cap = self._cap
        handle = None
        if self._delta_ticks:
            handle = self._dispatch_tick_delta(cap, t0)
        if handle is None:
            # designated fallback: cold replay state, tier change, or
            # churn past the rebuild threshold — one full-tier tick
            # re-establishes the retained state delta ticks splice over
            handle = self._dispatch_tick_full(cap, t0)  # wql: allow(full-rebuild-on-tick)
        # window clearing happens only on a SUCCESSFUL launch: a
        # raising dispatch keeps every mark for the retry, and
        # abort_tick drops _have_last so dirt consumed by a tick that
        # never applied cannot leak a stale replay
        self._touched[:cap] = False
        self._window_dirty[:cap] = False
        self._window_dirty_cubes.clear()
        self._tick_inflight = True
        self.dispatches += 1
        self.last_integrate_ms = (time.perf_counter() - t0) * 1e3
        if self.metrics is not None:
            self.metrics.observe_ms("sim.integrate_ms", self.last_integrate_ms)
            self.metrics.inc("sim.h2d_rows", self.last_h2d_rows)
        return handle

    def _dispatch_tick_full(self, cap: int, t0: float) -> dict:
        """The pre-delta full path: ship dirty slots to the persistent
        twin, run the fused kernel over the WHOLE capacity tier."""
        state = self._upload_state(cap)
        new_state, targets, counts = self._tick_fn(state)
        # device twin for the NEXT tick: integrated positions; the
        # UPLOADED (host-authoritative) velocity — the in-tick bounce
        # reflection is per-tick, exactly as the full re-upload it
        # replaced behaved (apply() writes back positions only)
        self._dev_state = EntityState(
            position=new_state.position,
            velocity=state.velocity,
            world=state.world,
            peer=state.peer,
        )
        self.full_sim_ticks += 1
        return {
            "mode": "full",
            "pos": new_state.position,
            "targets": targets,
            "counts": counts,
            "cap": cap,
            "t0": t0,
        }

    def _note_delta_fallback(self, reason: str) -> None:
        self.delta_fallbacks += 1
        self.last_delta_stats = {
            "reused": 0, "recomputed": 0, "dirty_cubes": 0,
            "fallback": reason,
        }
        if self.metrics is not None:
            self.metrics.inc("delta.sim_fallbacks")

    def _predict_cubes(self, slots: np.ndarray) -> np.ndarray:
        """Post-integration cubes of ``slots``, predicted host-side by
        replaying the device's f32 integrate+reflect bit-for-bit
        (numpy f32 add/mul/compare are the same IEEE ops the torch
        tick runs) and quantizing with the golden host quantizer — EXACT against
        the device labels for pow2 cube sizes (the plane's delta gate;
        tests/test_quantizer_envelope pins the agreement)."""
        dt = np.float32(self.dt)
        tb = np.float32(2.0 * self.bounds)  # the kernel's weak-f32 2*b
        b = np.float32(self.bounds)
        p = self._pos[slots] + self._vel[slots] * dt
        p = np.where(p > b, tb - p, p)
        p = np.where(p < -b, -tb - p, p)
        return cube_coords_batch(p.astype(np.float64), self.cube_size)

    def _dispatch_tick_delta(self, cap: int, t0: float) -> dict | None:
        """Delta path: build the dirty-cube closure and launch the
        tick kernel over ONLY it, at a pow2 sub-tier. Returns None to
        fall back to the full path (cold cache, tier change, or churn
        past ``delta_rebuild_threshold`` — the rebuild threshold)."""
        if not self._have_last or self._last_cap != cap:
            self._note_delta_fallback("cold")
            return None
        live = self._live[:cap]
        n_live = int(np.count_nonzero(live))
        moving = live & (self._vel[:cap] != 0.0).any(axis=1)
        dirty = (self._window_dirty[:cap] & live) | moving
        dirty_slots = np.flatnonzero(dirty)
        if dirty_slots.size == 0 and not self._window_dirty_cubes:
            # the world did not change: zero device work, pure replay
            self.delta_sim_ticks += 1
            self.delta_reused += n_live
            self.last_h2d_rows = 0
            self.last_delta_stats = {
                "reused": n_live, "recomputed": 0, "dirty_cubes": 0,
                "fallback": "",
            }
            return {"mode": "replay", "cap": cap, "t0": t0}
        threshold = self.delta_rebuild_threshold * max(n_live, 1)
        if dirty_slots.size > threshold:
            self._note_delta_fallback("churn")
            return None
        # dirty cubes: every cube a dirty entity occupies now or can
        # reach this tick, plus cubes vacated by removals
        wid_col = self._wid[:cap]
        cube_col = self._cube[:cap]
        parts = [spatial_keys(wid_col[dirty_slots],
                              cube_col[dirty_slots], 0)]
        if dirty_slots.size:
            parts.append(spatial_keys(
                wid_col[dirty_slots], self._predict_cubes(dirty_slots), 0
            ))
        if self._window_dirty_cubes:
            arr = np.asarray(self._window_dirty_cubes, np.int64)  # wql: allow(host-sync-in-sim-tick) — host tuple list, not a device array
            parts.append(spatial_keys(
                arr[:, 0].astype(np.int32), arr[:, 1:], 0
            ))
        dirty_keys = np.unique(np.concatenate(parts))
        # closure: every live entity in a dirty cube (a same-hash
        # collision only ADDS members — conservative, never wrong)
        closure = live & np.isin(
            spatial_keys(wid_col, cube_col, 0), dirty_keys
        )
        rows = np.flatnonzero(closure)
        tier = max(_DELTA_MIN_TIER, _next_pow2(max(int(rows.size), 1)))
        if rows.size > threshold or tier >= cap:
            self._note_delta_fallback("closure")
            return None
        # gather the closure into the sub-tier; pad lanes are parked
        # dead rows (peer -1 → the kernel masks them out of every run)
        pos_sub = np.full((tier, 3), _DEAD_POS, np.float32)
        vel_sub = np.zeros((tier, 3), np.float32)
        wid_sub = np.full(tier, -1, np.int32)
        pid_sub = np.full(tier, -1, np.int32)
        n = int(rows.size)
        pos_sub[:n] = self._pos[rows]
        vel_sub[:n] = self._vel[rows]
        wid_sub[:n] = wid_col[rows]
        pid_sub[:n] = self._pid[rows]
        state = state_from_numpy(pos_sub, vel_sub, wid_sub, pid_sub,
                                 self.device)
        new_state, targets, counts = self._tick_fn(state)
        self.delta_sim_ticks += 1
        self.delta_reused += n_live - n
        self.delta_recomputed += n
        self.last_h2d_rows = n
        self.last_delta_stats = {
            "reused": n_live - n, "recomputed": n,
            "dirty_cubes": int(dirty_keys.size), "fallback": "",
        }
        return {
            "mode": "delta",
            "rows": rows,
            "dirty_keys": dirty_keys,
            "pos": new_state.position,
            "targets": targets,
            "counts": counts,
            "cap": cap,
            "tier": tier,
            "t0": t0,
        }

    def precompile(self, max_compiles: int = 32) -> dict:
        """Boot warm-up before serving: build and load the kNN kernel
        (on the card), then run the tick at the current capacity tier
        and, with delta ticks on, at every pow2 sub-tier of the delta
        ladder, so no tick pays a kernel build or a first-shape
        allocation mid-serving. ``max_compiles`` caps the shapes
        walked. Returns a stats dict in the spatial/precompile.py
        shape."""
        t0 = time.perf_counter()
        build_ms = 0.0
        if self.device.type == "cuda":
            kernel_build.load("knn_select")
            build_ms = kernel_build.build_seconds.get("knn_select", 0.0) * 1e3
        cap = self._cap
        tiers = [cap]
        if self._delta_ticks:
            tier = _DELTA_MIN_TIER
            while tier < cap:
                tiers.append(tier)
                tier *= 2
        budget = max(1, int(max_compiles))
        walked, skipped = tiers[:budget], max(0, len(tiers) - budget)
        for tier in walked:
            z3 = np.zeros((tier, 3), np.float32)
            neg = np.full(tier, -1, np.int32)
            self._tick_fn(state_from_numpy(z3, z3, neg, neg, self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        stats = {
            "dispatches": len(walked),
            "skipped_by_budget": skipped,
            "kernel_build_ms": round(build_ms, 1),
            "wall_ms": round((time.perf_counter() - t0) * 1e3, 1),
        }
        logger.info(
            "entity plane warm-up on %s: %d tick shapes in %.0f ms "
            "(kernel build %.0f ms)", self.device, len(walked),
            stats["wall_ms"], build_ms,
        )
        return stats

    def collect_tick(self, handle) -> dict:
        """Wait out the device and fetch results (worker thread;
        tick.sim.knn span). The three fetches below are the sim tick's
        designated device→host sync points; everything else stays
        vectorized. Also re-quantizes the integrated positions to
        cubes host-side in f64 — the AUTHORITATIVE quantizer, so the
        index coupling follows the golden grid, not the device's f32
        twin."""
        t0 = time.perf_counter()
        mode = handle.get("mode", "full")
        if mode == "replay":
            # nothing was dispatched: the retained tick IS the result
            return {"mode": "replay", "cap": handle["cap"], "knn_ms": 0.0}
        pos = _to_host(handle["pos"])  # designated collect point
        targets = _to_host(handle["targets"])  # designated collect point
        counts = _to_host(handle["counts"])  # designated collect point
        cubes = cube_coords_batch(pos.astype(np.float64), self.cube_size)
        knn_ms = (time.perf_counter() - t0) * 1e3
        out = {
            "mode": mode,
            "pos": pos, "targets": targets, "counts": counts,
            "cubes": cubes, "cap": handle["cap"], "knn_ms": knn_ms,
        }
        if mode == "delta":
            out["rows"] = handle["rows"]
            out["dirty_keys"] = handle["dirty_keys"]
        return out

    def abort_tick(self) -> None:
        """Drop an in-flight tick without applying it (cancelled or
        errored flush, or a resilience rebuild/failover swapping the
        backing index): host columns stay authoritative and unchanged,
        the next dispatch simply re-integrates from them. The device
        twin already holds the dropped tick's integration, so it is
        invalidated — the next dispatch re-ships the host tier. The
        delta-tick replay state drops with it: the aborted dispatch
        consumed the dirty window without ever applying, so the next
        tick must recompute the world in full."""
        self._have_last = False
        if self._tick_inflight:
            self._tick_inflight = False
            self._dev_state = None
            self.dropped_ticks += 1

    def apply(self, result: dict, trace=None,
              skip_frames: bool = False) -> list:
        """Integrate one collected tick back into the host authority
        (event-loop thread): position writeback, index churn through
        the base+delta path, neighbor-frame assembly. Returns
        ``(message, targets)`` delivery pairs for the tick's batched
        deliver. ``skip_frames`` (tick-deadline degradation) applies
        the writeback + churn but sheds the frame leg — counted, never
        silent."""
        self._tick_inflight = False
        t0 = time.perf_counter()
        cap = result["cap"]
        mode = result.get("mode", "full")
        if mode == "replay":
            # nothing changed since the retained tick: positions,
            # cubes and the index are already exactly what a full
            # recompute would produce — only the frame leg runs
            moved_slots = np.empty(0, np.intp)
            pos = self._last_pos
            targets, counts = self._last_targets, self._last_counts
        elif mode == "delta":
            pos, targets, counts, moved_slots = self._apply_delta(result)
        else:
            pos, cubes = result["pos"], result["cubes"]
            targets, counts = result["targets"], result["counts"]

            # 1. position writeback — every live slot that the wire
            # did NOT touch since dispatch (a client update must win
            # over the concurrent integration it never saw)
            wb = self._live[:cap] & ~self._touched[:cap]
            self._pos[:cap][wb] = pos[wb]

            # 2. index churn: slots whose authoritative cube moved.
            # Only written-back slots move here — touched slots
            # re-quantize at the NEXT applied tick from their
            # client-given position.
            moved = wb & np.any(cubes != self._cube[:cap], axis=1)
            moved_slots = np.flatnonzero(moved)
            if moved_slots.size:
                self._apply_churn(moved_slots, cubes[moved_slots])
            # retain this tick as the delta replay source — as
            # WRITABLE copies: np.asarray of a device buffer is a
            # read-only zero-copy view, and delta ticks splice their
            # sub-results into these in place
            if self._delta_ticks:
                self._last_pos = np.array(pos)
                self._last_targets = np.array(targets)
                self._last_counts = np.array(counts)
                self._have_last = True
                self._last_cap = cap
        self.last_churn = int(moved_slots.size)

        # 3. neighbor frames: one message per entity with >= 1 target,
        # fanned out to the owning peers of its k nearest co-cube
        # entities (the device already applied except-self per PEER)
        if skip_frames:
            pairs = []
            self.frames_skipped += 1
            if self.metrics is not None:
                self.metrics.inc("sim.frames_skipped")
        elif self.interest is not None:
            pairs = self.interest.build_pairs(self, pos, targets, cap)
        else:
            pairs = self._build_frames(pos, targets, counts, cap)

        self.applied_ticks += 1
        self.frames += len(pairs)
        self.last_apply_ms = (time.perf_counter() - t0) * 1e3
        self.last_knn_ms = result["knn_ms"]
        if self.metrics is not None:
            self.metrics.observe_ms("sim.knn_ms", result["knn_ms"])
            self.metrics.observe_ms("sim.apply_ms", self.last_apply_ms)
            if moved_slots.size:
                self.metrics.inc("sim.index_moves", int(moved_slots.size))
            if pairs:
                self.metrics.inc("sim.frames", len(pairs))
            if self._delta_ticks and self.last_delta_stats:
                self.metrics.inc(
                    "delta.sim_reused", self.last_delta_stats["reused"]
                )
                self.metrics.inc(
                    "delta.sim_recomputed",
                    self.last_delta_stats["recomputed"],
                )
        if trace is not None:
            tags = {
                "entities": len(self._slot_of),
                "frames": len(pairs),
                "index_moves": int(moved_slots.size),
                "integrate_ms": round(self.last_integrate_ms, 3),
                "knn_ms": round(result["knn_ms"], 3),
                "apply_ms": round(self.last_apply_ms, 3),
            }
            if self._delta_ticks:
                tags["delta"] = dict(self.last_delta_stats)
            trace.tag(sim=tags)
        return pairs

    def _apply_delta(self, result: dict):
        """Splice a delta sub-tick over the retained last-tick arrays:
        closure rows take the freshly computed values, clean rows keep
        (replay) theirs. Returns ``(pos, targets, counts,
        moved_slots)`` for the shared apply tail — ``pos`` is the
        device-integrated frame position column, exactly what the full
        path hands it."""
        rows = result["rows"]
        n = int(rows.size)
        pos_sub = result["pos"][:n]
        cubes_sub = result["cubes"][:n]
        self._last_targets[rows] = result["targets"][:n]
        self._last_counts[rows] = result["counts"][:n]
        self._last_pos[rows] = pos_sub

        # writeback + churn for closure rows the wire didn't touch
        # mid-flight (same mask the full path applies tier-wide);
        # rows removed mid-flight dropped out of `live` already
        wb = self._live[rows] & ~self._touched[rows]
        wrows = rows[wb]
        self._pos[wrows] = pos_sub[wb]
        moved = np.any(cubes_sub[wb] != self._cube[wrows], axis=1)
        moved_slots = wrows[moved]
        if moved_slots.size:
            self._apply_churn(moved_slots, cubes_sub[wb][moved])

        # defensive closure audit: every written-back row must land in
        # a cube the dispatch predicted dirty — unreachable inside the
        # pinned quantizer envelope, but a mispredict would mean some
        # clean cube replayed stale neighbors, so it forces the next
        # tick onto the full path instead of trusting the replay state
        if moved_slots.size:
            landed = spatial_keys(
                self._wid[moved_slots], cubes_sub[wb][moved], 0
            )
            bad = int(np.count_nonzero(
                ~np.isin(landed, result["dirty_keys"])
            ))
            if bad:
                self.delta_mispredicts += bad
                self._have_last = False
                logger.warning(
                    "delta tick mispredicted %d cube landings — "
                    "forcing a full recompute next tick", bad,
                )

        # the device twin never saw this sub-tick: closure rows are
        # stale there until the next full-path scatter re-ships them
        self._device_dirty[wrows] = True
        return self._last_pos, self._last_targets, self._last_counts, \
            moved_slots

    def _apply_churn(self, moved_slots: np.ndarray,
                     new_cubes: np.ndarray) -> None:
        """Move the index rows of slots whose cube changed, through the
        backend's delta path. ``new_cubes`` are the moved slots' fresh
        cubes, row-aligned with ``moved_slots``. Refcount transitions
        decide which moves actually touch the index (co-located
        entities of one peer share a row); the surviving adds/removes
        go down vectorized, grouped by world, via
        ``bulk_move_subscriptions`` when the backend has it (the cuda
        index) or per-row mutations otherwise."""
        old_cubes = self._cube[moved_slots].copy()
        wids = self._wid[moved_slots]
        pids = self._pid[moved_slots]
        self._cube[moved_slots] = new_cubes
        self.index_moves += int(moved_slots.size)

        # refcount transitions (O(churn) host work, like any index
        # mutation batch): rows crossing 0 materialize as index ops
        add_rows: list[int] = []
        rem_rows: list[int] = []
        refs = self._sub_refs
        for i in range(moved_slots.size):
            wid = int(wids[i])
            pid = int(pids[i])
            old_key = (wid, int(old_cubes[i, 0]), int(old_cubes[i, 1]),
                       int(old_cubes[i, 2]), pid)
            new_key = (wid, int(new_cubes[i, 0]), int(new_cubes[i, 1]),
                       int(new_cubes[i, 2]), pid)
            refs[old_key] -= 1
            if refs[old_key] <= 0:
                del refs[old_key]
                rem_rows.append(i)
            refs[new_key] += 1
            if refs[new_key] == 1:
                add_rows.append(i)

        bulk_move = getattr(self.backend, "bulk_move_subscriptions", None)
        for wid in np.unique(wids).tolist():
            world = self._world_names[wid]
            rem = [i for i in rem_rows if wids[i] == wid]
            add = [i for i in add_rows if wids[i] == wid]
            rem_peers = [self._peer_uuids[int(pids[i])] for i in rem]
            add_peers = [self._peer_uuids[int(pids[i])] for i in add]
            if bulk_move is not None:
                bulk_move(
                    world,
                    rem_peers, old_cubes[rem],
                    add_peers, new_cubes[add],
                )
            else:
                for peer, cube in zip(rem_peers, old_cubes[rem]):
                    self.backend.remove_subscription(
                        world, peer, tuple(int(c) for c in cube)
                    )
                for peer, cube in zip(add_peers, new_cubes[add]):
                    self.backend.add_subscription(
                        world, peer, tuple(int(c) for c in cube)
                    )
        # Make the churn visible to the device twin and run the LSM
        # compaction policy NOW: the query path calls flush() at every
        # dispatch, but an entity-sim-only server has no query
        # dispatches — without this the delta log (and its tombstones)
        # would grow without bound. No-op-cheap when nothing is dirty.
        self.backend.flush()

    def _build_frames(self, pos, targets, counts, cap: int) -> list:
        """Assemble per-entity neighbor frames: for every live entity
        with at least one resolved target, one ``entity.frame``
        LocalMessage carrying the entity's integrated position,
        addressed to the owning peers of its nearest neighbors.
        Entities sharing a (world, recipients) cohort encode in ONE
        native pass (serialize-once per cohort) and hand ready wire
        bytes to deliver_batch — zero per-entity Message objects; the
        object path below is the fallback for a stale native library.
        O(entities with neighbors) host work either way — the
        delivery-path analog of the query engine's decode."""
        live = self._live[:cap]
        valid = targets >= 0
        has_any = live & valid.any(axis=1)
        rows = np.flatnonzero(has_any)
        if rows.size == 0:
            return []
        wire = self._wire
        if wire is None or not wire.can_encode_frames:
            return self._build_frames_py(pos, targets, valid, rows)
        # cohort key = (world, sorted target lanes): rows agreeing on
        # both share one recipient list and one native encode pass
        tr = np.sort(targets[rows], axis=1)
        key = np.concatenate(
            [self._wid[rows][:, None], tr.astype(np.int32)], axis=1
        )
        cohorts, inverse = np.unique(key, axis=0, return_inverse=True)
        pairs = []
        peer_uuids = self._peer_uuids
        cache = self._frame_cache
        next_cache: dict[bytes, tuple] = {}
        reused = 0
        for c in range(cohorts.shape[0]):
            crows = rows[inverse == c]
            # frame-level reuse: the cohort key pins world + recipient
            # set; byte-identical member rows and positions pin the
            # encoded output exactly (sender keys and entity uuids are
            # per-slot constants within a roster epoch — any slot
            # alloc/release cleared the cache), so a clean cohort
            # replays last tick's wire bytes, parity byte for byte
            key_b = cohorts[c].tobytes()
            crows_b = crows.tobytes()
            sub_pos = pos[crows]
            pos_b = sub_pos.tobytes()
            cached = cache.get(key_b)
            if (
                cached is not None
                and cached[0] == crows_b
                and cached[1] == pos_b
            ):
                frames, targets_u = cached[2], cached[3]
                reused += len(frames)
            else:
                tgt = cohorts[c, 1:]
                tgt = np.unique(tgt[tgt >= 0])
                targets_u = [peer_uuids[int(p)] for p in tgt]
                world = self._world_names[int(cohorts[c, 0])]
                frames = wire.encode_frames(
                    self._peer_key_arr[self._pid[crows]],
                    self._uuid_bytes[crows],
                    sub_pos.astype(np.float64),
                    world.encode(),
                )
            next_cache[key_b] = (crows_b, pos_b, frames, targets_u)
            pairs.extend((WireFrame(f), targets_u) for f in frames)
        # cohorts absent this tick age out with the wholesale swap
        self._frame_cache = next_cache
        if reused:
            self.frames_reused += reused
            if self.metrics is not None:
                self.metrics.inc("delta.frames_reused", reused)
        self.frames_native += len(pairs)
        return pairs

    def _build_frames_py(self, pos, targets, valid, rows) -> list:
        """Object-path frame assembly (stale-native fallback): one
        Message per entity, serialized later by deliver_batch."""
        pairs = []
        peer_uuids = self._peer_uuids
        uuid_of = self._uuid_of
        world_names = self._world_names
        wid_col = self._wid
        pid_col = self._pid
        for row in rows.tolist():
            tgt_pids = np.unique(targets[row][valid[row]])
            targets_u = [peer_uuids[int(p)] for p in tgt_pids]
            position = Vector3(
                float(pos[row, 0]), float(pos[row, 1]), float(pos[row, 2])
            )
            world = world_names[int(wid_col[row])]
            msg = Message(
                instruction=Instruction.LOCAL_MESSAGE,
                parameter=PARAM_FRAME,
                sender_uuid=peer_uuids[int(pid_col[row])],
                world_name=world,
                position=position,
                entities=[Entity(
                    uuid=uuid_of[row], position=position,
                    world_name=world,
                )],
            )
            pairs.append((msg, targets_u))
        return pairs

    # endregion

    def stats(self) -> dict:
        return {
            "entities": len(self._slot_of),
            "capacity": self._cap,
            "peers": len(self._peer_slots),
            "worlds": len(self._world_names),
            "k": self.k,
            "registered": self.entities_registered,
            "removed": self.entities_removed,
            "updates": self.updates,
            "rejected": self.rejected,
            "dispatches": self.dispatches,
            "applied_ticks": self.applied_ticks,
            "dropped_ticks": self.dropped_ticks,
            "frames": self.frames,
            "frames_skipped": self.frames_skipped,
            "frames_native": self.frames_native,
            "frames_reused": self.frames_reused,
            "coalesced": self.coalesced,
            "pending": self.staged_count(),
            "wire_rows": self.wire_rows,
            "wire_slow_rows": self.wire_slow_rows,
            "column_flips": self.column_flips,
            "h2d_full": self.h2d_full,
            "h2d_scatter": self.h2d_scatter,
            "scatter_fallbacks": self.scatter_fallbacks,
            "last_h2d_rows": self.last_h2d_rows,
            "index_moves": self.index_moves,
            "index_rows": len(self._sub_refs),
            "delta_ticks": self._delta_ticks,
            "delta_sim_ticks": self.delta_sim_ticks,
            "full_sim_ticks": self.full_sim_ticks,
            "delta_reused": self.delta_reused,
            "delta_recomputed": self.delta_recomputed,
            "delta_fallbacks": self.delta_fallbacks,
            "delta_mispredicts": self.delta_mispredicts,
            "last_integrate_ms": round(self.last_integrate_ms, 3),
            "last_knn_ms": round(self.last_knn_ms, 3),
            "last_apply_ms": round(self.last_apply_ms, 3),
            "last_churn": self.last_churn,
        }


def _decode_velocity(flex: bytes | None):
    """Wire velocity: ``Entity.flex`` carries 12 little-endian f32
    bytes (vx, vy, vz). Absent/short flex = no velocity change (zero
    for a fresh registration)."""
    if flex is None or len(flex) < 12:
        return None
    return np.frombuffer(flex[:12], dtype="<f4").astype(np.float32)
