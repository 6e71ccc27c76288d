"""Filtered k-nearest: distance-ordered stencil probes on device (K10).

Port of the JAX package's ``queries/knn.py``: its jitted
``_knn_order_kernel`` as torch ops on an explicit device (the card
unless the caller asks for the CPU), under the same rule as the index
ops — one composition, run where its tensors lie.

The index holds CUBES, not exact peer positions, so "k nearest" is
defined on the cube lattice: walk the stencil cubes in ascending
squared displacement ``|u·size|²`` and collect subscribed peers (the
replication predicate rides the probe rows' ``repl`` lanes through the
existing device filter) until ``k`` distinct peers are found. Within
one cube, peers tie-break by uuid; across cubes at equal distance, by
stencil index — fully deterministic, pinned lane-for-lane by the
oracle.

The ordering is one packed sort: the f32 image of the squared distance
(the f64 value rounded to f32, then its bits) goes in the high word
and the stencil index in the low word, so a single sort yields both
the order and the tie-break. f32 is exact enough here on purpose:
equal f64 distances that f32 merges fall to the index tie-break,
identically in kernel and oracle (both cast through f32).

Where torch differs from JAX: the stencil's own distances come from
the host (``geometry.stencil_geometry``: torch's f64 ``sqrt`` on the CPU
is not correctly rounded), and there is no unsigned 64-bit sort on the
card, so the key is int64. A non-negative finite (or infinite) f32 has
bits below 2^31, so ``(bits << 32) | idx`` is a non-negative int64 and
sorts as the u64 would. Out-of-range slots take ``INT64_MAX``, which
sorts after every valid key and whose low word reads -1 as an int32,
as JAX's all-ones pad does.
"""

from __future__ import annotations

import numpy as np
import torch

#: pad key of an out-of-range stencil slot (low 32 bits all ones)
_PAD = (1 << 63) - 1
_LOW = 0xFFFFFFFF


def _knn_order_kernel(params: torch.Tensor, geom: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[M, L]`` f64 knn params × ``[5, S]`` stencil geometry (dx, dy,
    dz, d2, dist) → (``order`` int32 ``[M, S]`` stencil indices
    ascending by (d2, idx), -1 past the in-range ones; ``n_ok`` int32
    ``[M]`` count of in-range probes per query)."""
    d2, dist = geom[3], geom[4]                            # [S]
    ok = dist[None, :] <= params[:, 1:2]                   # [M, S]
    d2_bits = d2.to(torch.float32).view(torch.int32).to(torch.int64)
    idx = torch.arange(d2.shape[0], dtype=torch.int64, device=d2.device)
    packed = torch.where(
        ok, ((d2_bits << 32) | idx)[None, :],
        torch.full((), _PAD, dtype=torch.int64, device=d2.device),
    )
    packed = torch.sort(packed, dim=1).values
    # the low word as a signed int32, sign-extended first so the cast
    # is exact (the pad's all-ones word becomes -1)
    low = packed & _LOW
    order = torch.where(low > 0x7FFFFFFF, low - (1 << 32), low)
    order = order.to(torch.int32)
    n_ok = ok.sum(dim=1, dtype=torch.int32)
    return order, n_ok


def knn_order(params: np.ndarray, offsets: np.ndarray, cube_size: int,
              *, device) -> tuple[np.ndarray, np.ndarray]:
    """Host wrapper: → (order int32 ``[M, S]``, n_ok int32 ``[M]``),
    computed on ``device``. Rows pad to a pow2 tier like the mask
    kernels (geometry._pad_rows) so the shapes stay enumerable for the
    boot tier walk."""
    from .geometry import _pad_rows, _put, stencil_geometry

    padded, m = _pad_rows(params)
    order, n_ok = _knn_order_kernel(
        _put(padded, device),
        _put(stencil_geometry(offsets, cube_size), device))
    knn_order.launches += 1
    return order.cpu().numpy()[:m], n_ok.cpu().numpy()[:m]


#: calls on the serving path since the last reset
knn_order.launches = 0
