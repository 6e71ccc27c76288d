"""Interest-managed fan-out (ROADMAP item 3).

Delta ticks stopped *recomputing* the world that didn't change; this
package stops *sending* it. :class:`~.manager.InterestManager` turns
the entity plane's per-tick neighbor results into per-recipient delta
frames (entered/left/moved vs the last state that peer provably
received) under an epoch:seq stamped wire contract, partitions
recipients into near/far LOD cadence tiers, and enforces per-peer
bandwidth budgets by lossless deferral — never by truncating a delta.

``--interest off`` (the default) never imports this package on the hot
path: the delivery pipeline stays byte for byte the pre-interest one.
"""

from .manager import (  # noqa: F401
    PARAM_FULL,
    PARAM_FULL_CONT,
    PARAM_DELTA,
    InterestManager,
    parse_stamp,
    stamp,
)
from .replay import ReplayClient  # noqa: F401
