"""The simulation tick on torch tensors — the entity plane's device step.

Port of the JAX package's ``ops/tick.py``. One call over SoA entity
tensors does, for every entity at once:

1. integrate positions (reflecting off the world bounds),
2. re-quantize every entity to its subscription cube,
3. rebuild the spatial hash for the tick (one stable device sort),
4. find each cube's run in the sort (run scan → exact counts),
5. select each entity's K nearest co-cube peers among its ±(K-1)
   sort-order neighbors (``ops/knn.py``: the hand-written CUDA kernel on
   the card, its plain version on the CPU).

Every output is bit-exact against the JAX package on the same inputs:
integers throughout, or f32 produced by the same IEEE operations. The
places where torch would otherwise differ are handled explicitly:

* 64-bit hashing: torch has no logical right shift for int64, so the
  mixer runs in int64 with the constants converted to their signed
  values and each ``x >> s`` emulated as ``(x >> s) & (2^(64-s) - 1)``;
  multiplication wraps.
* The hash sort is ``torch.sort(stable=True)`` — ``jnp.argsort`` is
  stable, and an unstable sort would change which members of an
  over-full cube fall inside the ±(K-1) window.
* Integration stays two rounded ops (``pos + vel * dt``), never a fused
  multiply-add: delta ticks replay it in numpy bit for bit
  (entities/plane.py ``_predict_cubes``).
* The quantizer divides by a full tensor of the cube size rather than
  a Python scalar: PyTorch computes ``tensor / scalar`` on CUDA as a
  multiplication by the reciprocal, which rounds differently.
* Float → int64 casts out of range are undefined in torch as in XLA;
  every saturation guard of the reference runs in its order.

Quantization envelope (pinned for the JAX package by
tests/test_quantizer_envelope.py, and for the port against it by
tests/test_torch_tick.py): exact against the golden host quantizer for
all normal finite inputs when the cube size is a power of two, and for
|x| <= size * 2^21 otherwise.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..spatial.hashing import MIX_GOLDEN, MIX_M1, MIX_M2
from .knn import knn_select

_I64_MAX = 2**63 - 1
_U64 = 2**64


def _signed(u: int) -> int:
    """The int64 with the same bits as the u64 ``u``."""
    u %= _U64
    return u - _U64 if u >= 2**63 else u


_M1 = _signed(MIX_M1)
_M2 = _signed(MIX_M2)


class EntityState(NamedTuple):
    """SoA device state for one entity population."""

    position: torch.Tensor  # [N, 3] f32
    velocity: torch.Tensor  # [N, 3] f32
    world: torch.Tensor     # [N] i32 interned world id
    peer: torch.Tensor      # [N] i32 dense peer id


def device_coord_clamp(x: torch.Tensor, size: int) -> torch.Tensor:
    """Subscription-cube quantizer on device (f32 → i64 labels).

    Mirrors the max-corner / sign-symmetric / 0→+size semantics of the
    golden host quantizer (cube_area.rs:23-44)."""
    size_f = torch.full_like(x, float(size))  # wql: allow(jax-host-sync, host-sync-in-sim-tick) — size is the host's cube size
    a = torch.abs(x)
    mult = torch.where(x < 0, -1, 1).to(torch.int64)
    rounded = torch.ceil(a / size_f) * size_f
    rounded = torch.where(a == 0.0, size_f, rounded)
    exact = (torch.remainder(a, size_f) == 0.0) & (x != 0.0)
    ri = rounded.to(torch.int64)
    # saturating +size like the host (_sat_add): past the int64 cast's
    # saturation point a plain add wraps negative
    big = torch.full_like(ri, _I64_MAX)
    bumped = torch.where(ri > _I64_MAX - size, big, ri + size)
    res = torch.where(rounded > a, ri, bumped)
    res = torch.where(exact, a.to(torch.int64), res)
    # NaN → +size, ±inf → ±i64::MAX, saturation-zone finites → ±i64::MAX
    # (the guard tests ROUNDED, the actual cast input: f32 round-up can
    # reach exactly 2^63 while `a` is still below it)
    res = torch.where(rounded >= 2.0**63, big, res)
    res = torch.where(torch.isinf(x), big, res)
    return torch.where(
        torch.isnan(x), torch.full_like(res, size), res * mult
    )


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ _srl(x, 30)) * _M1
    x = (x ^ _srl(x, 27)) * _M2
    return x ^ _srl(x, 31)


def _mix_int(x: int) -> int:
    """The same mixer on a Python int (u64 arithmetic)."""
    x %= _U64
    x = ((x ^ (x >> 30)) * MIX_M1) % _U64
    x = ((x ^ (x >> 27)) * MIX_M2) % _U64
    return x ^ (x >> 31)


def device_spatial_keys(world: torch.Tensor, cubes: torch.Tensor,
                        seed: int = 0) -> torch.Tensor:
    """Device twin of spatial/hashing.spatial_keys: [N] i32 world ids +
    [N, 3] i64 cubes → [N] i64 sort keys (the u64 hash's bits)."""
    h0 = _signed(_mix_int(seed + MIX_GOLDEN))
    h = _mix(world.to(torch.int64) ^ h0)
    h = _mix(h ^ cubes[..., 0])
    h = _mix(h ^ cubes[..., 1])
    return _mix(h ^ cubes[..., 2])


def simulation_tick(state: EntityState, *, cube_size: int, k: int,
                    dt: float = 0.05, bounds: float = 1000.0,
                    seed: int = 0):
    """One tick: integrate → quantize → rebuild hash → resolve fan-out.

    Returns ``(new_state, targets, counts)`` where ``targets`` is
    [N, k] i32 peer ids each entity broadcasts to this tick (-1 = none;
    except-self), and ``counts`` the exact co-cube population including
    self (callers detect K-overflow as counts > k)."""
    n = state.position.shape[0]
    dev = state.position.device

    # 1. integrate, reflecting at ±bounds (two rounded ops, no FMA)
    pos = state.position + state.velocity * dt
    over = pos > bounds
    under = pos < -bounds
    pos = torch.where(over, 2.0 * bounds - pos, pos)
    pos = torch.where(under, -2.0 * bounds - pos, pos)
    vel = torch.where(over | under, -state.velocity, state.velocity)

    # 2. quantize to subscription cubes
    cubes = device_coord_clamp(pos, cube_size)

    # 3. per-tick spatial-hash rebuild: one stable sort
    keys = device_spatial_keys(state.world, cubes, seed)
    sorted_keys, order = torch.sort(keys, stable=True)
    sorted_peer = state.peer[order]

    # 4. runs of equal keys: exact counts and the i32 run id
    p_idx = torch.arange(n, dtype=torch.int32, device=dev)
    boundary = sorted_keys[1:] != sorted_keys[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([one, boundary])
    last = torch.cat([boundary, one])
    run_start = torch.cummax(
        torch.where(first, p_idx, torch.zeros_like(p_idx)), dim=0
    ).values
    run_end = torch.flip(torch.cummin(torch.flip(
        torch.where(last, p_idx + 1, torch.full_like(p_idx, n)), [0]
    ), dim=0).values, [0])
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    counts[order] = run_end - run_start
    inv = torch.empty(n, dtype=torch.int64, device=dev)
    inv[order] = torch.arange(n, dtype=torch.int64, device=dev)
    rid = torch.cumsum(first.to(torch.int32), dim=0, dtype=torch.int32)

    # 5. k-nearest among the ±(K-1) stencil. k=1 rides the k=2 window,
    # truncated to one target: a ±0 stencil would find no neighbor.
    kw = max(k, 2)
    sorted_pos = pos[order].contiguous()
    tgt_sorted = knn_select(rid, sorted_peer.contiguous(), sorted_pos,
                            k=kw)[:, :k]
    targets = tgt_sorted[inv]
    return EntityState(pos, vel, state.world, state.peer), targets, counts


def make_tick_fn(cube_size: int = 16, k: int = 32, dt: float = 0.05,
                 bounds: float = 1000.0):
    """Close the static params; returns ``fn(state)``."""
    return partial(simulation_tick, cube_size=cube_size, k=k, dt=dt,
                   bounds=bounds)


def state_from_numpy(position, velocity, world, peer,
                     device) -> EntityState:
    """numpy SoA columns (the JAX package's EntityState as numpy, or the
    plane's host columns) → a port EntityState on ``device`` (copied)."""
    def put(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)  # wql: allow(jax-host-sync, host-sync-in-sim-tick) — host columns going up, not a read back

    return EntityState(
        position=put(position, torch.float32),
        velocity=put(velocity, torch.float32),
        world=put(world, torch.int32),
        peer=put(peer, torch.int32),
    )


def state_to_numpy(state: EntityState) -> tuple:
    """A port EntityState → ``(position, velocity, world, peer)`` numpy
    arrays (independent host copies)."""
    return tuple(
        t.detach().to("cpu", copy=True).numpy() for t in state  # wql: allow(host-sync-in-sim-tick) — the state's 4 columns; a deliberate read back outside the tick
    )


def example_state(n: int = 1024, n_worlds: int = 4, seed: int = 7,
                  device="cpu") -> EntityState:
    """Deterministic small entity population for warm-up checks
    (torch.Generator; not the JAX package's jax.random numbers)."""
    g = torch.Generator().manual_seed(seed)
    position = torch.rand((n, 3), generator=g) * 1800.0 - 900.0
    velocity = torch.rand((n, 3), generator=g) * 80.0 - 40.0
    return EntityState(
        position=position.to(device),
        velocity=velocity.to(device),
        world=(torch.arange(n, dtype=torch.int32) % n_worlds).to(device),
        peer=torch.arange(n, dtype=torch.int32).to(device),
    )
