"""The card's peaks and the bytes the fan-out needs, for roofline shares.

A roofline share is the least time the card could take for the work
(bytes over peak bandwidth, or operations over peak rate, whichever is
larger) divided by the time it took. The work is counted from the
inputs, whatever implements it, so a later change to the kernels is
measured against the same count.
"""

from __future__ import annotations

#: published peaks of one card, dense, at its full power limit (NVIDIA's
#: H100 SXM data sheet); a card set below 700 W runs slower under load,
#: so the result line's info states the limit beside the share
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12,
                              "power_limit_w": 700.0},
}

#: bytes of one encoded query row: two int64 cube keys, the int32
#: sender, the int8 replication mode
QUERY_ROW_BYTES = 8 + 8 + 4 + 1
#: bytes of one delivered lane: its int32 peer id read from the index
#: and written to the result
LANE_BYTES = 4 + 4


def fanout_bytes(rows: int, lanes: int) -> int:
    """Bytes a fan-out batch needs: each query's columns read once, and
    each delivered (message, subscriber) lane read once and written
    once. The sender's own lane, read and filtered out, is not counted,
    so the count is a lower bound."""
    return rows * QUERY_ROW_BYTES + lanes * LANE_BYTES
