"""Migration transport: bounded traffic parking + CRC-framed chunks.

Two small pieces the coordinator composes:

* :class:`TransferBuffer` — while world W is mid-migration the router
  PARKS W's inbound wire bytes here instead of forwarding them into a
  frozen (or half-transferred) owner. The buffer is bounded in BYTES:
  past the budget frames are SHED AND COUNTED (the overload plane's discipline —
  bounded degradation, never silent loss, never unbounded memory).
  After the flip the buffer replays in exact arrival order, stamped
  with the new epoch, so "offered == admitted + counted shed" keeps
  closing through a migration.

* Chunk framing — world state streams over the AF_UNIX control
  channel, whose datagrams are read 64 KiB at a time. ``encode_chunks``
  splits one JSON document into ≤``CHUNK_CHARS`` slices (the shard
  dump-chunk bound: JSON-escaped slice + envelope stays under one
  datagram), each carrying its CRC32 and the CRC32 of the WHOLE
  document; :class:`ChunkAssembler` reassembles and verifies both, so
  a torn/corrupt/cross-wired transfer fails loudly instead of
  replaying garbage into the destination's WAL. ``reset()`` restarts
  assembly from chunk 0 — the resume path when the destination shard
  is killed mid-transfer and the router re-streams from its retained
  copy.
"""

from __future__ import annotations

import json
import zlib

#: JSON-escaped chunk + envelope must stay under the control channel's
#: 64 KiB datagram read (the shard.py DUMP_CHUNK_CHARS precedent)
CHUNK_CHARS = 24_000


class TransferBuffer:
    """Arrival-ordered byte-bounded parking for one migrating world's
    inbound traffic."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._frames: list[bytes] = []
        self.parked_bytes = 0
        self.parked_frames = 0
        #: frames refused past the byte budget — a COUNTED shed class
        #: (cluster.reshard_buffer_shed), never silent loss
        self.shed = 0

    def park(self, data: bytes) -> bool:
        """True = parked for post-flip replay; False = over budget,
        the caller must count the shed."""
        if self.parked_bytes + len(data) > self.max_bytes:
            self.shed += 1
            return False
        self._frames.append(data)
        self.parked_bytes += len(data)
        self.parked_frames += 1
        return True

    def replay(self) -> list[bytes]:
        """Drain every parked frame in arrival order (the post-flip
        replay); the buffer is empty afterwards."""
        frames, self._frames = self._frames, []
        self.parked_bytes = 0
        return frames

    def stats(self) -> dict:
        return {
            "parked_frames": self.parked_frames,
            "parked_bytes": self.parked_bytes,
            "shed": self.shed,
        }


def encode_chunks(obj: dict) -> list[dict]:
    """One JSON document → ordered CRC-framed control-channel chunks.
    Every chunk is self-describing (``seq``/``n``/``crc``/``total_crc``)
    so the assembler can verify each slice on arrival and the whole
    document at completion."""
    blob = json.dumps(obj)
    total_crc = zlib.crc32(blob.encode())
    slices = [
        blob[i:i + CHUNK_CHARS] for i in range(0, len(blob), CHUNK_CHARS)
    ] or [""]
    return [
        {
            "seq": seq,
            "n": len(slices),
            "crc": zlib.crc32(chunk.encode()),
            "total_crc": total_crc,
            "data": chunk,
        }
        for seq, chunk in enumerate(slices)
    ]


class ChunkAssembler:
    """Reassemble + verify a chunk stream. Chunks may repeat (resume
    re-streams from 0) but never conflict: a CRC or shape mismatch
    poisons the assembly until ``reset()``."""

    def __init__(self):
        self._parts: dict[int, str] = {}
        self._n: int | None = None
        self._total_crc: int | None = None
        self.corrupt = False

    def reset(self) -> None:
        self._parts.clear()
        self._n = None
        self._total_crc = None
        self.corrupt = False

    def feed(self, chunk: dict) -> dict | None:
        """Absorb one chunk; returns the decoded document when the
        stream completes and verifies, else None. Sets ``corrupt`` on
        any CRC/shape violation (the caller aborts the transfer)."""
        if self.corrupt:
            return None
        try:
            seq = int(chunk["seq"])
            n = int(chunk["n"])
            crc = int(chunk["crc"])
            total_crc = int(chunk["total_crc"])
            data = str(chunk["data"])
        except (KeyError, TypeError, ValueError):
            self.corrupt = True
            return None
        if zlib.crc32(data.encode()) != crc:
            self.corrupt = True
            return None
        if self._n is None:
            self._n, self._total_crc = n, total_crc
        elif n != self._n or total_crc != self._total_crc:
            self.corrupt = True
            return None
        if not 0 <= seq < n:
            self.corrupt = True
            return None
        self._parts[seq] = data
        if len(self._parts) < self._n:
            return None
        blob = "".join(self._parts[i] for i in range(self._n))
        if zlib.crc32(blob.encode()) != self._total_crc:
            self.corrupt = True
            return None
        try:
            return json.loads(blob)
        except ValueError:
            self.corrupt = True
            return None
