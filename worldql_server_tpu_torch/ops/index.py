"""The device subscription index's ops (K1–K6) on torch tensors.

Port of the device functions of the JAX package's
``spatial/tpu_backend.py`` (its jitted XLA programs K1–K6), under the
same names and with the same outputs, bit for bit:

* K1 — segment build: ``_bucket_hash``, ``probe_tables``,
  ``run_remainders``, ``_sort_segment_dev``;
* K2 — run bounds and the zoned CSR fan-out: ``_probe_run_bounds``,
  ``_run_bounds``, ``_seg_run_bounds``, ``run_bounds_all``,
  ``csr_layout``, ``match_run_csr``, ``_repl_mask``, ``zone_b_cnts``,
  ``run_csr_assemble``;
* K3 — result compaction: ``pack_csr``, ``padded_slots`` (host);
* K4 — delta-buffer upkeep: ``_scatter_dead``, ``_write_chunk``,
  ``_grow_buffers``, ``_alloc_buffers``;
* K5 — compaction fold: ``_device_compact``, ``_probe_only_dev``;
* K6 — dense [M, K] match: ``_window_gather``, ``_gather_filtered``,
  ``match_core``, ``_multi_match``, ``compact_sparse``.

They are torch compositions, not hand-written kernels: the repo's rule
is that the XLA programs become torch ops and a kernel follows only
where a measured profile shows the composition is the cost
(``chip_smoke.py`` takes that profile). Every op runs on the device of
its input tensors. Where JAX and torch differ:

* Immutability. JAX arrays never change; the index relies on that (a
  background compaction folds arrays the serving thread keeps updating,
  and the CSR overflow retry re-dispatches the segment arrays captured
  at dispatch). So every update here is out of place — ``_scatter_dead``
  and ``_write_chunk`` return new tensors, never write their input.
* ``mode="drop"`` scatters. ``index_put_`` has no drop mode, so each
  scatter runs into a buffer one element longer than its target and
  sends the lanes JAX would drop to that last element, which is then
  cut off.
* ``lax.cond`` on a device scalar. ``_seg_run_bounds`` computes both
  run bounds and picks one with ``torch.where``: a host read of the
  overflow flag would be a device sync per tick.
* Unsigned 64-bit arithmetic. Torch has no logical right shift for
  int64: the bucket hash runs in int64 with the shifts masked and the
  constants written as their signed bit patterns; multiplication wraps.
* Layout. The TPU-shaped gathers (the ``[S/8, 8]`` row rotation of
  ``_window_gather``, the ``lax.map`` chunking of zone B) become one
  clamped gather and one pass, lane for lane the same results.

Every sort is stable, as in JAX: the host numpy mirror of the index
depends on it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..protocol.types import Replication
from ..spatial.hashing import MIX_M1, MIX_M2, PAD_KEY, next_pow2

_REPL_EXCEPT = int(Replication.EXCEPT_SELF)
_REPL_ONLY = int(Replication.ONLY_SELF)

_U64 = 2**64


def _signed(u: int) -> int:
    """The int64 with the same bits as the u64 ``u``."""
    u %= _U64
    return u - _U64 if u >= 2**63 else u


_M1 = _signed(int(MIX_M1))  # wql: allow(jax-host-sync) — a Python int constant, no tensor
_M2 = _signed(int(MIX_M2))  # wql: allow(jax-host-sync) — a Python int constant, no tensor
_PAD = int(PAD_KEY)  # wql: allow(jax-host-sync) — a numpy host scalar, no tensor

#: slots per probe-table bucket
PROBE_E = 8
#: bucket-count ceiling (2^21 buckets x 24 lanes x 4 B = 192 MB)
PROBE_MAX_BUCKETS = 1 << 21
#: seed folding the bucket hash away from both key hash families
_PROBE_SEED = _signed(0xA0761D6478BD642F)

SEG_ARRAYS = 6  # (key, key2, peer, run_rem, tbl, oflow)

#: CSR zone-A row width: one identity row of this many lanes per query
CSR_ROW = 8
#: CSR zone-B row width: hot-remainder regions pad to multiples of this
CSR_ROW_B = 32


def probe_buckets_for(n_cubes: int) -> int:
    """Bucket-count tier for a segment with ``n_cubes`` distinct cubes
    (load factor <= 0.5); an overflowing build falls back to binary
    search for the whole segment (``oflow``)."""
    return min(next_pow2(2 * max(n_cubes, 8)), PROBE_MAX_BUCKETS)


# --------------------------------------------------------------------
# K1: segment build
# --------------------------------------------------------------------


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _bucket_hash(keys: torch.Tensor, seed: int = _PROBE_SEED) -> torch.Tensor:
    """[..] i64 keys → the bucket hashes' u64 bits as i64 (splitmix64,
    distinct seed from both key families)."""
    x = keys ^ seed
    x = (x ^ _srl(x, 30)) * _M1
    x = (x ^ _srl(x, 27)) * _M2
    return x ^ _srl(x, 31)


def _drop_scatter(size: int, slots: torch.Tensor, vals: torch.Tensor,
                  init: torch.Tensor) -> torch.Tensor:
    """``init.at[slots].set(vals, mode="drop")`` for a 1-D ``init`` of
    ``size``: out-of-range slots land in one extra element, cut off."""
    buf = torch.cat([init, init[:1]])
    idx = torch.where((slots >= 0) & (slots < size), slots,
                      torch.full_like(slots, size)).long()
    buf.index_put_((idx,), vals)
    return buf[:size]


def _drop_max_owner(size: int, mark: torch.Tensor) -> torch.Tensor:
    """``cummax(zeros(size).at[mark].max(arange, mode="drop"))``: the
    owner map of a padded layout — slot ``i`` marks its start row
    ``mark[i]``; a running max fills the rows in between."""
    dev = mark.device
    slot = torch.arange(mark.shape[0], dtype=torch.int32, device=dev)
    buf = torch.zeros(size + 1, dtype=torch.int32, device=dev)
    idx = torch.where(mark < size, mark, torch.full_like(mark, size)).long()
    buf.scatter_reduce_(0, idx, slot, "amax", include_self=True)
    return torch.cummax(buf[:size], dim=0).values


def probe_tables(sorted_keys: torch.Tensor, sorted_keys2: torch.Tensor,
                 *, n_buckets: int):
    """Single-level packed bucket probe table for a sorted segment.

    ``tbl`` is [B, 3E] i32: per bucket E first-key tags (top 32 bits;
    pad 0), E second-family verify tags (top 32 bits of key2), and E
    run-start indices (pad -1). Returns ``(tbl, oflow [1] i32)``;
    ``oflow[0]`` counts cubes that overflowed their bucket or whose
    (bucket, tag) collided in-bucket — either routes the segment to the
    binary-search fallback (same exactness contract as the JAX
    package's ``probe_tables``)."""
    dev = sorted_keys.device
    s = sorted_keys.shape[0]
    e = PROBE_E
    idx = torch.arange(s, dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([one, sorted_keys[1:] != sorted_keys[:-1]]) \
        & (sorted_keys != _PAD)

    b = _bucket_hash(sorted_keys) & (n_buckets - 1)
    tag = (sorted_keys >> 32).to(torch.int32)
    tag2 = (sorted_keys2 >> 32).to(torch.int32)
    # run starts ordered by (bucket, tag): bucket runs give slot ranks,
    # duplicate (bucket, tag) pairs land adjacent
    sentinel = 1 << 62
    comp = torch.where(
        first, (b << 32) | (tag.to(torch.int64) & 0xFFFFFFFF),
        torch.full_like(sorted_keys, sentinel),
    )
    sc, order64 = torch.sort(comp, stable=True)
    order = order64.to(torch.int32)
    member = sc < sentinel
    dup = torch.cat([~one, sc[1:] == sc[:-1]]) & member
    sb = (sc >> 32).to(torch.int32)
    bstart = torch.cat([one, sb[1:] != sb[:-1]])
    rank = idx - torch.cummax(
        torch.where(bstart, idx, torch.zeros_like(idx)), dim=0).values
    fit = member & (rank < e) & ~dup
    oflow = (member & ~fit).sum(dtype=torch.int32).reshape(1)

    total = n_buckets * 3 * e
    row0 = sb * (3 * e)
    drop = torch.full_like(idx, -1)
    slots = torch.cat([
        torch.where(fit, row0 + rank, drop),
        torch.where(fit, row0 + e + rank, drop),
        torch.where(fit, row0 + 2 * e + rank, drop),
    ])
    vals = torch.cat([tag[order64], tag2[order64], order])
    # per bucket: E+E tag lanes of 0, E lo lanes of -1 (a pad-tag false
    # hit carries lo -1 and never wins the per-query max)
    init = torch.zeros((n_buckets, 3 * e), dtype=torch.int32, device=dev)
    init[:, 2 * e:] = -1
    tbl = _drop_scatter(total, slots, vals, init.reshape(-1))
    return tbl.reshape(n_buckets, 3 * e), oflow


def run_remainders(sorted_keys: torch.Tensor) -> torch.Tensor:
    """[S] i32: rows from each row to the end of its equal-key run."""
    dev = sorted_keys.device
    s = sorted_keys.shape[0]
    idx = torch.arange(s, dtype=torch.int32, device=dev)
    last = torch.cat([sorted_keys[1:] != sorted_keys[:-1],
                      torch.ones(1, dtype=torch.bool, device=dev)])
    ends = torch.flip(torch.cummin(torch.flip(
        torch.where(last, idx, torch.full_like(idx, s - 1)), [0]
    ), dim=0).values, [0])
    return ends + 1 - idx


def _sort_segment_dev(keys, keys2, peers, n_buckets: int):
    """Key-sort a segment on device (stable: ties keep insertion
    order, matching the host's numpy mirror), derive its run-remainder
    column and build its probe table."""
    sk, order = torch.sort(keys, stable=True)
    sk2 = keys2[order]
    rem = run_remainders(sk)
    tbl, oflow = probe_tables(sk, sk2, n_buckets=n_buckets)
    return sk, sk2, peers[order], rem, tbl, oflow


# --------------------------------------------------------------------
# K2: run bounds + zoned CSR fan-out
# --------------------------------------------------------------------


def _probe_run_bounds(tbl, sub_key2, sub_rem, q_key, q_key2):
    """Per-query (run start, run length) via one packed bucket-row
    gather plus two element gathers (run remainder, key2 backstop)."""
    s = sub_rem.shape[0]
    nb = tbl.shape[0]
    e = tbl.shape[1] // 3
    b = _bucket_hash(q_key) & (nb - 1)
    rows = tbl[b]                                  # [M, 3E] i32
    q_tag = (q_key >> 32).to(torch.int32)
    q_tag2 = (q_key2 >> 32).to(torch.int32)
    hit = (rows[:, :e] == q_tag[:, None]) \
        & (rows[:, e:2 * e] == q_tag2[:, None])
    lo = torch.where(hit, rows[:, 2 * e:],
                     torch.full_like(rows[:, 2 * e:], -1)).amax(dim=1)
    li = torch.clamp(lo, 0, s - 1)
    found = (lo >= 0) & (sub_key2[li] == q_key2)
    return li, torch.where(found, sub_rem[li], torch.zeros_like(li))


def _run_bounds(sub_key, sub_key2, sub_rem, q_key, q_key2):
    """Per-query (run start, run length) by one binary search
    (``side='left'``) plus the run-remainder column; exact against the
    second key family at the run's first row."""
    s = sub_key.shape[0]
    lo = torch.searchsorted(sub_key, q_key, side="left", out_int32=True)
    li = torch.clamp(lo, max=s - 1)
    found = (sub_key[li] == q_key) & (sub_key2[li] == q_key2)
    return lo, torch.where(found, sub_rem[li], torch.zeros_like(lo))


def _seg_run_bounds(seg, q_key, q_key2):
    """Run bounds for one 6-tensor segment: the bucket probe when the
    table built cleanly, binary search when ``oflow[0] > 0``. Both are
    computed and one is picked on device — no host read of the flag."""
    sub_key, sub_key2, _, sub_rem, tbl, oflow = seg
    lo_s, cnt_s = _run_bounds(sub_key, sub_key2, sub_rem, q_key, q_key2)
    lo_p, cnt_p = _probe_run_bounds(tbl, sub_key2, sub_rem, q_key, q_key2)
    use_search = oflow[0] > 0
    return (torch.where(use_search, lo_s, lo_p),
            torch.where(use_search, cnt_s, cnt_p))


def run_bounds_all(segs, queries):
    """Per-segment (run start, RAW run length) for every query."""
    q_key, q_key2 = queries[0], queries[1]
    los, cnts = [], []
    for seg in segs:
        lo, cnt = _seg_run_bounds(seg, q_key, q_key2)
        los.append(lo)
        cnts.append(cnt)
    return los, cnts


def csr_layout(cnts, rows_cap: int, row_lanes: int = CSR_ROW_B):
    """Row-padded zone-B layout from raw per-segment lengths → ``(counts
    [M, nseg], row_start [M*nseg], owner [rows_cap], total_rows)``;
    ``owner[j]`` is the flattened (q, s) slot output row j belongs to."""
    counts = torch.stack(cnts, dim=1)              # [M, nseg] raw
    prows = ((counts + (row_lanes - 1)) // row_lanes).reshape(-1)
    row_start = torch.cumsum(prows, 0, dtype=torch.int32) - prows
    total_rows = prows.sum(dtype=torch.int32)
    slot = torch.arange(prows.shape[0], dtype=torch.int32,
                        device=prows.device)
    mark = torch.where(prows > 0, row_start, rows_cap + 1 + slot)
    return counts, row_start, _drop_max_owner(rows_cap, mark), total_rows


def match_run_csr(flat_args, nseg: int, t_cap: int):
    """Fan-out CSR assembled straight from the index's run windows.
    ``flat_args`` is SEG_ARRAYS tensors per segment then the 4 query
    tensors; returns ``(counts [M, nseg] raw, flat [t_cap], total)``
    with ``total == t_cap + 1`` when the padded layout overflows."""
    na = SEG_ARRAYS
    segs = [tuple(flat_args[na * i:na * i + na]) for i in range(nseg)]
    queries = flat_args[na * nseg:]
    los, cnts = run_bounds_all(segs, queries)
    return run_csr_assemble(segs, los, cnts, cnts, queries, t_cap)


def _repl_mask(vals, sender_col, repl_col):
    """Replication filter lanes (local_message.rs:60-86)."""
    is_sender = vals == sender_col
    return torch.where(
        repl_col == _REPL_EXCEPT, ~is_sender,
        torch.where(repl_col == _REPL_ONLY, is_sender,
                    torch.ones_like(is_sender)),
    )


def zone_b_cnts(cnts):
    """Zone-B raw lengths: each segment's first CSR_ROW lanes ship in
    its zone-A identity row; only the remainders map into zone B."""
    return [torch.clamp(c - CSR_ROW, min=0) for c in cnts]


def run_csr_assemble(segs, los, cnts, cnts_local, queries, t_cap: int):
    """Assembly core of :func:`match_run_csr`: zone A is one identity
    row of CSR_ROW lanes per (query, segment); zone B holds owner-mapped
    CSR_ROW_B-lane rows for the remainders past lane CSR_ROW. The JAX
    package maps zone B in fixed-size chunks to pin one XLA gather
    codegen; here it is one pass over the rows, the same lanes."""
    nseg = len(segs)
    q_sender, q_repl = queries[2], queries[3]
    m = q_sender.shape[0]
    dev = q_sender.device
    rows_cap_b = (t_cap - m * CSR_ROW * nseg) // CSR_ROW_B
    if rows_cap_b < 1:
        raise ValueError("t_cap must cover the zone-A identity rows")
    counts = torch.stack(cnts, dim=1)              # [M, nseg] raw
    minus1 = torch.tensor(-1, dtype=torch.int32, device=dev)

    # zone A: one identity row per (query, segment)
    offs8 = torch.arange(CSR_ROW, dtype=torch.int32, device=dev)[None, :]
    sender_col = q_sender[:, None]
    repl_col = q_repl[:, None]
    zone_a_parts = []
    for s, seg in enumerate(segs):
        vals_a = _window_gather(seg[2], los[s], CSR_ROW)
        valid_a = (
            (offs8 < torch.clamp(cnts[s], max=CSR_ROW)[:, None])
            & (cnts_local[s] > 0)[:, None]
            & (vals_a >= 0)
            & _repl_mask(vals_a, sender_col, repl_col)
        )
        zone_a_parts.append(torch.where(valid_a, vals_a, minus1))
    zone_a = (zone_a_parts[0] if nseg == 1
              else torch.stack(zone_a_parts, dim=1).reshape(-1, CSR_ROW))

    # zone B: owner-mapped hot rows, CSR_ROW_B lanes each
    cnts_b = zone_b_cnts(cnts)
    _, row_start, owner, total_rows_b = csr_layout(
        cnts_b, rows_cap_b, CSR_ROW_B)

    def slotify(per_seg):
        return torch.stack(per_seg, dim=1).reshape(-1)

    own = slotify([(cl > 0).to(torch.int32) for cl in cnts_local])
    lo_row = slotify([lo + CSR_ROW for lo in los])[owner]
    cnt_row = slotify(cnts_b)[owner]
    own_row = own[owner] > 0
    rs = row_start[owner]
    sender_row = q_sender[owner // nseg][:, None]
    repl_row = q_repl[owner // nseg][:, None]
    s_of = owner % nseg
    j = torch.arange(rows_cap_b, dtype=torch.int32, device=dev)
    live_row = (j < total_rows_b)[:, None]
    block = j - rs
    lane = torch.arange(CSR_ROW_B, dtype=torch.int32, device=dev)[None, :]
    offs = block[:, None] * CSR_ROW_B + lane
    src = lo_row + block * CSR_ROW_B
    zb = torch.full((rows_cap_b, CSR_ROW_B), -1, dtype=torch.int32,
                    device=dev)
    for s, seg in enumerate(segs):
        vals = _window_gather(seg[2], src, CSR_ROW_B)
        valid = (
            (offs < cnt_row[:, None])
            & own_row[:, None]                 # this device owns it
            & (vals >= 0)                      # tombstones
            & (s_of == s)[:, None]
            & live_row
            & _repl_mask(vals, sender_row, repl_row)
        )
        zb = torch.where(valid, vals, zb)

    tail = t_cap - m * CSR_ROW * nseg - rows_cap_b * CSR_ROW_B
    flat = torch.cat([
        zone_a.reshape(-1), zb.reshape(-1),
        torch.full((tail,), -1, dtype=torch.int32, device=dev),
    ])
    total = counts.sum(dtype=torch.int32)
    total = torch.where(total_rows_b > rows_cap_b,
                        torch.tensor(t_cap + 1, dtype=torch.int32,
                                     device=dev), total)
    return counts, flat, total


# --------------------------------------------------------------------
# K3: result compaction
# --------------------------------------------------------------------


def pack_csr(counts, flat, *, bucket: int):
    """Pack the zoned CSR flat result into a dense ``[bucket]`` lane
    tensor on device, in the order the decoder reads them (q-major,
    segment-minor; lanes < CSR_ROW from zone A, later lanes from the
    slot's zone-B region), ``-1`` holes included. Returns ``(packed,
    total)``; ``total > bucket`` means the bucket was too small."""
    mq, nseg = counts.shape
    dev = counts.device
    cnt = counts.reshape(-1)                       # [M*nseg] raw
    off = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
    total = cnt.sum(dtype=torch.int32)
    cnt_b = torch.clamp(cnt - CSR_ROW, min=0)
    prow_b = (cnt_b + (CSR_ROW_B - 1)) // CSR_ROW_B
    rowstart_b = torch.cumsum(prow_b, 0, dtype=torch.int32) - prow_b
    base = mq * CSR_ROW * nseg
    slot_ids = torch.arange(cnt.shape[0], dtype=torch.int32, device=dev)
    mark = torch.where(cnt > 0, off, bucket + 1 + slot_ids)
    owner = _drop_max_owner(bucket, mark)
    j = torch.arange(bucket, dtype=torch.int32, device=dev)
    lane = j - off[owner]
    src = torch.where(
        lane < CSR_ROW, owner * CSR_ROW + lane,
        base + rowstart_b[owner] * CSR_ROW_B + (lane - CSR_ROW),
    )
    vals = flat[torch.clamp(src, 0, flat.shape[0] - 1)]
    return torch.where(j < total, vals, torch.full_like(vals, -1)), total


def padded_slots(counts: np.ndarray) -> int:
    """Host mirror of the zoned layout's flat-slot footprint for RAW
    [M, nseg] counts."""
    m, nseg = counts.shape
    rem = np.maximum(counts.astype(np.int64) - CSR_ROW, 0)
    rows = int(((rem + CSR_ROW_B - 1) // CSR_ROW_B).sum())
    return m * CSR_ROW * nseg + rows * CSR_ROW_B


# --------------------------------------------------------------------
# K4: delta-buffer upkeep (out of place — see the module docstring)
# --------------------------------------------------------------------


def _h2d(a, device) -> torch.Tensor:
    """A host array on ``device``, used at once and not kept (on the CPU
    it may share the array's memory). On the card it goes through
    pinned memory without blocking: a pageable copy would wait for
    every launch queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _scatter_dead(peer_arr: torch.Tensor, rows) -> torch.Tensor:
    """A copy of ``peer_arr`` with ``rows`` tombstoned (``-1``); rows
    past the end (the padding) are dropped."""
    n = peer_arr.shape[0]
    return _drop_scatter(
        n, _h2d(rows, peer_arr.device).to(torch.int64),
        torch.tensor(-1, dtype=peer_arr.dtype, device=peer_arr.device),
        peer_arr,
    )


def _write_chunk(bufs, chunks, start: int):
    """Copies of the insertion-order delta buffers with a host chunk
    written at ``start`` (clamped so the chunk fits, as
    ``dynamic_update_slice`` does)."""
    out = []
    for b, c in zip(bufs, chunks):
        c = _h2d(c, b.device)
        at = max(0, min(int(start), b.shape[0] - c.shape[0]))  # wql: allow(jax-host-sync) — start is the host's delta cursor
        nb = b.clone()
        nb[at:at + c.shape[0]] = c
        out.append(nb)
    return tuple(out)


def _grow_buffers(bufs, cap: int):
    """Grow the delta buffers to ``cap`` rows on device, padded."""
    pads = (_PAD, 0, -1)
    return tuple(
        torch.cat([b, torch.full((cap - b.shape[0],) + tuple(b.shape[1:]),
                                 fill, dtype=b.dtype, device=b.device)])
        for b, fill in zip(bufs, pads)
    )


def _alloc_buffers(cap: int, device):
    """Fresh all-padding delta buffers, allocated on ``device``."""
    return (
        torch.full((cap,), _PAD, dtype=torch.int64, device=device),
        torch.zeros((cap,), dtype=torch.int64, device=device),
        torch.full((cap,), -1, dtype=torch.int32, device=device),
    )


# --------------------------------------------------------------------
# K5: compaction fold
# --------------------------------------------------------------------


def _device_compact(bk, bk2, bp, dk, dk2, dp, cap2: int, n_buckets: int):
    """Fold base + delta into a fresh sorted base on device. Dead rows
    get the padding key so the stable sort sinks them past every live
    run; the leading ``cap2`` rows are the live index plus padding."""
    keys = torch.cat([bk, dk])
    keys2 = torch.cat([bk2, dk2])
    peers = torch.cat([bp, dp])
    keys = torch.where(peers < 0, torch.full_like(keys, _PAD), keys)
    sk, order = torch.sort(keys, stable=True)
    sk, order = sk[:cap2], order[:cap2]
    sk2 = keys2[order]
    rem = run_remainders(sk)
    tbl, oflow = probe_tables(sk, sk2, n_buckets=n_buckets)
    return sk, sk2, peers[order], rem, tbl, oflow


def _probe_only_dev(sk, sk2, n_buckets: int):
    """Probe table for an already-sorted uploaded segment."""
    return probe_tables(sk, sk2, n_buckets=n_buckets)


# --------------------------------------------------------------------
# K6: dense [M, K] match
# --------------------------------------------------------------------


def _window_gather(arr: torch.Tensor, lo: torch.Tensor, k: int):
    """[M] window starts → [M, k] contiguous windows of a 1-D tensor.
    Lanes past the end read a clamped row; every caller masks them
    (they lie beyond the run length)."""
    s = arr.shape[0]
    idx = lo.to(torch.int64)[:, None] + torch.arange(
        k, dtype=torch.int64, device=lo.device)
    return arr[torch.clamp(idx, 0, s - 1)]


def _gather_filtered(sub_peer, lo, cnt, q_sender, q_repl, *, k: int):
    """Up to ``k`` targets per run with the tombstone and replication
    filters applied (local_message.rs:60-86)."""
    offs = torch.arange(k, dtype=lo.dtype, device=lo.device)
    tgt = _window_gather(sub_peer, lo, k)
    valid = (offs[None, :] < cnt[:, None]) & (tgt >= 0) \
        & _repl_mask(tgt, q_sender[:, None], q_repl[:, None])
    return torch.where(valid, tgt, torch.full_like(tgt, -1))


def match_core(seg, q_key, q_key2, q_sender, q_repl, *, k: int):
    """[M] queries × one segment → [M, K] peer ids (-1 pad)."""
    lo, cnt = _seg_run_bounds(seg, q_key, q_key2)
    return _gather_filtered(seg[2], lo, cnt, q_sender, q_repl, k=k)


def _multi_match(flat_args, ks):
    """Match against ``len(ks)`` segments, concatenating the per-query
    target lists along the K axis."""
    nseg = len(ks)
    na = SEG_ARRAYS
    queries = flat_args[na * nseg:]
    parts = [
        match_core(flat_args[na * i:na * i + na], *queries, k=ks[i])
        for i in range(nseg)
    ]
    return parts[0] if nseg == 1 else torch.cat(parts, dim=1)


def compact_sparse(tgt, *, c: int):
    """Non-empty rows of a dense [M, K] target table first → ``(rows[c],
    targets[c, k], n_hits)``."""
    nz = (tgt >= 0).any(dim=1)
    order = torch.sort((~nz).to(torch.int8), stable=True).indices
    rows = order[:c]
    return rows.to(torch.int32), tgt[rows], nz.sum(dtype=torch.int32)
