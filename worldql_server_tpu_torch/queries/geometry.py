"""Per-kind geometric filter kernels over the stencil lattice (K11).

Port of the JAX package's ``queries/geometry.py``: its jitted XLA
programs ``_cone_mask_kernel`` and ``_density_mask_kernel`` as torch
ops on an explicit device, the card unless the caller asks for the CPU.
They are torch compositions, not hand-written kernels, under the same
rule as the index ops (``ops/index.py``): a CPU tensor runs the same
composition on the CPU, a CUDA tensor on the card.

The library's candidate-generation semantics (the *cube-sampled*
contract every oracle in :mod:`oracle` replicates): a kind's candidate
cubes are the cubes containing the sample points ``pos + u * size``
for stencil offsets ``u ∈ [-r, r]³`` that pass the kind's geometric
test on the displacement ``d = u * size``. Exactly one lattice point
per cube (the lattice spacing equals the cube size), so the stencil
mask IS the cube selection — no arithmetic in label space, ever
(adjacent cube labels are not uniform integers; sample points are
quantized by the same host-f64 ``cube_coords_batch`` as everything
else).

Each kernel is a batched device op: ``[M, PARAM_LANES]`` parameter rows
against one stencil, warmed by the boot tier walk
(spatial/precompile.py) over the kind-row tier ladder × stencil radii.
Geometry runs in f64 with the component sums written out as separate
multiplies and adds in the JAX source's order: each torch op rounds its
result, so nothing fuses into an FMA or reorders a sum, and the masks
equal the numpy oracles bit for bit on the card and on the CPU. (No
``sum``, ``linalg.norm``, ``addcmul``, ``einsum`` or ``torch.compile``
here: each of those may reorder or contract.)

One difference from the JAX kernels: the stencil's own geometry — the
``[S]`` displacements, squared distances and distances, which depend on
the offsets and the cube size alone — is computed on the host in numpy
(:func:`stencil_geometry`, the oracle's expressions) and uploaded with
the parameters. torch's f64 ``sqrt`` on the CPU is not correctly
rounded (``sqrt(4864.0)`` comes out one ulp low), and a distance one ulp
off flips ``dist <= range`` and ``dot >= dist * cos`` on the lattice
points that sit on a cone's edge. The ``[M, S]`` work, which is the
kernel's cost, runs on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..spatial.hashing import next_pow2
from .kinds import PARAM_LANES
from .stencil import stencil_offsets, stencil_radius  # noqa: F401  (re-export)

#: kind-parameter rows pad to power-of-two tiers (this floor) before
#: entering a kernel, so the row counts form the same small enumerable
#: ladder the dispatch capacities do — the boot tier walk
#: (spatial/precompile.py) covers it, and a mid-serving change in the
#: per-kind row count lands on shapes the allocator already holds
KIND_ROW_FLOOR = 64


def _pad_rows(params: np.ndarray) -> tuple[np.ndarray, int]:
    params = np.asarray(params, np.float64)
    m = params.shape[0]
    cap = next_pow2(m, floor=KIND_ROW_FLOOR)
    if cap == m:
        return params, m
    out = np.zeros((cap, params.shape[1]), np.float64)
    out[:m] = params
    return out, m


def stencil_geometry(offsets: np.ndarray, cube_size: int) -> np.ndarray:
    """``[S, 3]`` lattice offsets → ``[5, S]`` f64 rows (dx, dy, dz, d2,
    dist) of the displacements ``u * size``, in the oracle's expressions
    and order (``oracle._displacements``), with numpy's correctly
    rounded ``sqrt``."""
    off = np.asarray(offsets, np.float64)
    size = np.float64(cube_size)
    dx = off[:, 0] * size
    dy = off[:, 1] * size
    dz = off[:, 2] * size
    d2 = dx * dx + dy * dy + dz * dz
    return np.stack([dx, dy, dz, d2, np.sqrt(d2)])


def _cone_mask_kernel(params: torch.Tensor,
                      geom: torch.Tensor) -> torch.Tensor:
    """``[M, L]`` f64 cone params × ``[5, S]`` stencil geometry → bool
    ``[M, S]``: displacement within range AND inside the half-angle (the
    apex cube ``d == 0`` is always visible)."""
    dx, dy, dz, d2, dist = geom
    ax, ay, az = params[:, 0:1], params[:, 1:2], params[:, 2:3]
    dot = dx[None, :] * ax + dy[None, :] * ay + dz[None, :] * az
    cos_half = params[:, 3:4]
    within = dist[None, :] <= params[:, 4:5]
    inside = dot >= dist[None, :] * cos_half
    return within & (inside | (d2[None, :] == 0.0))


def _density_mask_kernel(params: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """``[M, L]`` density params × ``[S, 3]`` f64 offsets → bool
    ``[M, S]``: Chebyshev box of ``extent`` cubes (lane 0). Integer
    geometry — exact in f64 by construction."""
    cheb = offsets.abs().amax(dim=1)                      # [S]
    return cheb[None, :] <= params[:, 0:1]


def _put(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(device)


def cone_mask(params: np.ndarray, offsets: np.ndarray, cube_size: int,
              *, device) -> np.ndarray:
    """Host wrapper: f64 in, bool ``[M, S]`` out (one fetch at the
    dispatch boundary, like the staging encode), computed on
    ``device``. Rows pad to a pow2 tier (see ``KIND_ROW_FLOOR``); the
    pad rows are sliced away."""
    padded, m = _pad_rows(params)
    out = _cone_mask_kernel(_put(padded, device),
                            _put(stencil_geometry(offsets, cube_size), device))
    cone_mask.launches += 1
    return out.cpu().numpy()[:m]


def density_mask(params: np.ndarray, offsets: np.ndarray,
                 *, device) -> np.ndarray:
    padded, m = _pad_rows(params)
    out = _density_mask_kernel(_put(padded, device), _put(offsets, device))
    density_mask.launches += 1
    return out.cpu().numpy()[:m]


#: calls on the serving path since the last reset (chip_smoke.py zeroes
#: them before a phase and reads them after it)
cone_mask.launches = 0
density_mask.launches = 0


def precompile_kind_kernels(qcap: int, radius: int, cube_size: int,
                            *, device) -> int:
    """Run each REGISTERED kind's kernel once at one (row-tier, stencil-
    radius) shape on ``device`` — the per-kind leg of the boot tier walk.
    Iterating the registry (not a hardcoded list) keeps a newly
    registered kind from paying its first run mid-serving. Returns the
    number of kernel calls made."""
    from .kinds import registered_kinds
    from .knn import knn_order  # local: avoid import cycle at module load

    offsets = stencil_offsets(radius)
    params = np.zeros((qcap, PARAM_LANES), np.float64)
    params[:, 0] = 1.0  # a unit direction keeps the cone kernel honest
    calls = 0
    for kind in registered_kinds():
        if kind.name == "cone":
            cone_mask(params, offsets, cube_size, device=device)
        elif kind.name == "density":
            density_mask(params, offsets, device=device)
        elif kind.name == "knn":
            knn_order(params, offsets, cube_size, device=device)
        else:
            continue  # raycast: host-side f64 march, no kernel to warm
        calls += 1
    return calls
