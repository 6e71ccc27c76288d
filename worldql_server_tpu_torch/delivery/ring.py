"""Shared-memory SPSC fan-out ring: the parent→worker frame conduit.

One ring per sender worker (single producer: the parent's frame pump;
single consumer: that worker), over one ``multiprocessing.
shared_memory`` block. Records are raw struct frames —

    [u32 kind][u32 frame_len][u32 n_slots]
    [u64 t_ingress_ns][u64 t_ring_write_ns]
    [frame bytes][n_slots × u32 slot ids]   (8-byte aligned)

The two stamps are CLOCK_MONOTONIC nanoseconds (``time.monotonic_ns``
— the same clock domain as ``time.perf_counter`` on Linux, so worker-
side completions stitch directly into parent-side span traces):
``t_ingress_ns`` is the frame clock opened at router dispatch / ticker
flush start (0 = not frame-clocked, e.g. broadcasts), and
``t_ring_write_ns`` is stamped by :meth:`Ring.try_write` itself — the
moment the frame entered the delivery plane. Workers subtract both
from their socket-write-complete time for the e2e histograms.

— written in place with ``pack_into``/buffer slicing: there is no
pickling and no intermediate frame copy on the write path (enforced by
the ``worker-unsafe-delivery`` lint rule). Cursors are MONOTONIC u64
byte counts in the block header (``head`` written only by the producer,
``tail`` only by the consumer), so the SPSC pair needs no lock: on
x86/ARM the interpreter's stores land in program order and each side
reads the other's cursor before touching data it guards. A record that
would straddle the block end burns the remainder with a WRAP marker
(or, when even a record header doesn't fit, the bare remainder — the
consumer mirrors the same arithmetic).

``try_write`` never blocks: a full ring returns False and the caller
owns the wait-or-drop policy (plane.py bounds the wait so a wedged
worker can never stall the tick pipeline).
"""

from __future__ import annotations

import struct
import time
from multiprocessing import shared_memory

#: header layout: head u64 @0 (producer), tail u64 @8 (consumer),
#: capacity u64 @16 (set once at create; SharedMemory rounds the block
#: to page size so the true cap must ride in-band)
_HDR = 64
_REC = struct.Struct("<IIIQQ")
_CUR = struct.Struct("<Q")

KIND_FRAME = 1
KIND_WRAP = 2

#: floor on a configured ring size — below this a single max-size
#: control batch could never fit and the writer would spin forever
RING_MIN_BYTES = 64 * 1024


def _pow2(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


class Ring:
    """SPSC byte ring over one shared-memory block. The parent calls
    :meth:`create` and writes; the worker calls :meth:`attach` (by
    name) and reads. Either side may close(); only the creator
    unlinks."""

    def __init__(self, shm: shared_memory.SharedMemory, cap: int):
        self.shm = shm
        self.buf = shm.buf
        self.cap = cap

    # region: lifecycle

    @classmethod
    def create(cls, capacity_bytes: int) -> "Ring":
        cap = _pow2(max(capacity_bytes, RING_MIN_BYTES))
        shm = shared_memory.SharedMemory(create=True, size=_HDR + cap)
        shm.buf[:_HDR] = b"\x00" * _HDR
        _CUR.pack_into(shm.buf, 16, cap)
        return cls(shm, cap)

    @classmethod
    def attach(cls, name: str) -> "Ring":
        shm = shared_memory.SharedMemory(name=name)
        # De-register from the ATTACHING process's resource tracker:
        # the creator owns the block's lifetime (unlink), and on
        # Python < 3.13 an attach silently registers too — so a dying
        # attacher's tracker would unlink a ring its peers still use
        # (cluster shards re-attach the same rings across restarts).
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass  # tracker internals shifted — worst case, a warning
        cap = _CUR.unpack_from(shm.buf, 16)[0]
        return cls(shm, int(cap))

    @property
    def name(self) -> str:
        return self.shm.name

    def close(self) -> None:
        self.buf = None  # release the exported memoryview first
        self.shm.close()

    def unlink(self) -> None:
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass

    # endregion

    # region: cursors

    def _head(self) -> int:
        return _CUR.unpack_from(self.buf, 0)[0]

    def _tail(self) -> int:
        return _CUR.unpack_from(self.buf, 8)[0]

    def pending_bytes(self) -> int:
        return self._head() - self._tail()

    # endregion

    @staticmethod
    def record_size(frame_len: int, n_slots: int) -> int:
        return (_REC.size + frame_len + 4 * n_slots + 7) & ~7

    def try_write(self, frame, slots_le: bytes, t_ingress_ns: int = 0) -> bool:
        """Append one delivery record (``slots_le`` is the target slot
        ids already packed little-endian u32, e.g. ``array('I')``
        bytes). ``t_ingress_ns`` is the frame clock opened at router
        dispatch / ticker flush start (0 = unclocked); the ring-write
        stamp is taken here. False when the ring lacks space — the
        caller decides whether to wait, drop, or spill."""
        n_slots = len(slots_le) // 4
        size = self.record_size(len(frame), n_slots)
        head, tail = self._head(), self._tail()
        free = self.cap - (head - tail)
        pos = head % self.cap
        rem = self.cap - pos
        if rem < size:
            # wrap: the record must be contiguous, so the remainder is
            # burned (marked when a header fits; the consumer derives
            # the skip either way)
            if free < rem + size:
                return False
            if rem >= _REC.size:
                _REC.pack_into(self.buf, _HDR + pos, KIND_WRAP, 0, 0, 0, 0)
            head += rem
            pos = 0
        elif free < size:
            return False
        off = _HDR + pos
        _REC.pack_into(
            self.buf, off, KIND_FRAME, len(frame), n_slots,
            t_ingress_ns, time.monotonic_ns(),
        )
        off += _REC.size
        self.buf[off:off + len(frame)] = frame
        off += len(frame)
        self.buf[off:off + len(slots_le)] = slots_le
        # publish LAST: the consumer sees the cursor only after the
        # record bytes are in place (x86/ARM store order + the
        # interpreter's per-bytecode sequencing)
        _CUR.pack_into(self.buf, 0, head + size)
        return True

    def read(self):
        """Consume one record → ``(frame_bytes, slot_ids: list[int])``
        or None when the ring is empty (timestamp-free compatibility
        surface; see :meth:`read_record`)."""
        rec = self.read_record()
        return None if rec is None else rec[:2]

    def read_record(self):
        """Consume one record → ``(frame_bytes, slot_ids, t_ingress_ns,
        t_ring_write_ns)`` or None when the ring is empty. The frame is
        COPIED out of the block before the tail advances — the consumer
        may buffer it past the slot's reuse."""
        while True:
            head, tail = self._head(), self._tail()
            if tail >= head:
                return None
            pos = tail % self.cap
            rem = self.cap - pos
            if rem < _REC.size:
                _CUR.pack_into(self.buf, 8, tail + rem)
                continue
            kind, frame_len, n_slots, t_ingress, t_write = _REC.unpack_from(
                self.buf, _HDR + pos
            )
            if kind == KIND_WRAP:
                _CUR.pack_into(self.buf, 8, tail + rem)
                continue
            size = self.record_size(frame_len, n_slots)
            off = _HDR + pos + _REC.size
            frame = bytes(self.buf[off:off + frame_len])
            off += frame_len
            slots = list(
                struct.unpack_from(f"<{n_slots}I", self.buf, off)
            ) if n_slots else []
            _CUR.pack_into(self.buf, 8, tail + size)
            return frame, slots, t_ingress, t_write
