"""Device-mesh construction for the fan-out engine.

Port of the JAX package's ``parallel/mesh.py``. Axes, as there:

* ``batch`` — data parallelism over the per-tick query batch; each
  device resolves M/b queries.
* ``space`` — the spatial index sharded by contiguous sorted-key
  ranges (sharding space, not sequence).

A :class:`FanoutMesh` is a ``[n_batch][n_space]`` grid of
``torch.device`` s. A device may appear more than once: virtual shards,
the counterpart of the JAX suite's 8 virtual CPU devices. Only callers
that pass ``devices=`` get them (tests name ``["cpu"] * 8``, the card
smoke ``["cuda:0"] * 4``); ``devices=None`` means the visible cards, or
``[cpu]`` when the resolved device is the CPU, so a mesh larger than
the host is a config error, as it is for JAX on a one-chip host.

**Multi-process:** where JAX joins one distributed runtime per process
(``jax.distributed.initialize``) and ``jax.devices()`` then spans every
process's chips, here every process joins one ``torch.distributed``
process group and the mesh's device list is every rank's visible
devices in rank order. Each grid position names the rank that holds it;
a process computes the shards of its own positions, and the backend's
merge is a collective over the group (parallel/sharded_backend.py).
:func:`maybe_initialize_distributed` wires that from the same
``WQL_DIST_*`` environment variables as the JAX package, so every
process of a multi-process deployment runs the identical server
command. The group's backend is gloo: it reduces CPU and CUDA tensors
alike (CUDA int32 max checked on an H100 by ``chip_smoke.py``'s
two-rank leg), and it takes two ranks on one card, which NCCL refuses.
"""

from __future__ import annotations

import logging
import os

import torch

from ..spatial.torchconf import resolve_device

logger = logging.getLogger(__name__)


def maybe_initialize_distributed() -> bool:
    """Join a multi-process ``torch.distributed`` group if
    ``WQL_DIST_COORDINATOR`` is set (``host:port`` of process 0), using
    ``WQL_DIST_NUM_PROCESSES`` and ``WQL_DIST_PROCESS_ID``. No-op
    (returns False) when unset — single-process runs need nothing. Must
    run before the mesh is built, which is why build_backend calls it
    ahead of mesh construction."""
    coordinator = os.environ.get("WQL_DIST_COORDINATOR")
    if not coordinator:
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        return True  # second build_backend in one process: no-op
    try:
        num = int(os.environ["WQL_DIST_NUM_PROCESSES"])
        pid = int(os.environ["WQL_DIST_PROCESS_ID"])
    except KeyError as exc:
        raise ValueError(
            "WQL_DIST_COORDINATOR is set but "
            f"{exc.args[0]} is not — a partial multi-host config "
            "would silently run single-host"
        ) from None
    except ValueError as exc:
        raise ValueError(
            "WQL_DIST_NUM_PROCESSES / WQL_DIST_PROCESS_ID must be "
            f"integers: {exc}"
        ) from None
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num, rank=pid,
    )
    logger.info(
        "joined distributed runtime: process %d/%d via %s",
        pid, num, coordinator,
    )
    return True


def _normalize(device) -> torch.device:
    """``torch.device`` with an explicit card index, so a tensor's
    ``.device`` compares equal to the grid entry it was placed on."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _visible_devices() -> list[torch.device]:
    """This process's devices: every visible card, or the CPU when the
    resolved device is the CPU (``WQL_TORCH_DEVICE=cpu``)."""
    if resolve_device().type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class FanoutMesh:
    """A ``('batch', 'space')`` grid of devices: ``devices[b][s]`` is
    the device of batch row ``b``, space shard ``s`` as its owning
    process names it, ``ranks[b][s]`` that process's rank (0 without a
    process group), ``group`` the process group or None."""

    axis_names = ("batch", "space")

    def __init__(self, devices, ranks, rank: int = 0, group=None):
        self.devices = [list(row) for row in devices]
        self.ranks = [list(row) for row in ranks]
        self.rank = rank
        self.group = group
        self.shape = {"batch": len(self.devices),
                      "space": len(self.devices[0])}

    def is_local(self, b: int, s: int) -> bool:
        """Whether this process holds grid position ``(b, s)``."""
        return self.ranks[b][s] == self.rank

    def local_positions(self) -> list[tuple[int, int]]:
        return [(b, s) for b in range(self.shape["batch"])
                for s in range(self.shape["space"]) if self.is_local(b, s)]


def make_fanout_mesh(
    n_batch: int = 1, n_space: int | None = None, devices=None
) -> FanoutMesh:
    """Build a ('batch', 'space') mesh. With only ``n_batch`` given,
    ``space`` takes all remaining devices. Inside a process group and
    with ``devices=None`` the device list spans every rank's visible
    devices, in rank order."""
    group = None
    rank = 0
    if devices is None:
        local = _visible_devices()
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            rank = dist.get_rank()
            group = dist.group.WORLD
            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, [str(d) for d in local])
            flat = [(r, torch.device(d)) for r, names in
                    enumerate(gathered) for d in names]
        else:
            flat = [(0, d) for d in local]
    else:
        flat = [(0, _normalize(d)) for d in devices]
    n = len(flat)
    if n_batch < 1 or (n_space is not None and n_space < 1):
        raise ValueError(f"mesh {n_batch}x{n_space} has an empty axis")
    if n_space is None:
        if n % n_batch:
            raise ValueError(f"{n} devices not divisible by batch={n_batch}")
        n_space = n // n_batch
    if n_batch * n_space > n:
        raise ValueError(
            f"mesh {n_batch}x{n_space} exceeds {n} available devices"
        )
    grid = [flat[b * n_space:(b + 1) * n_space] for b in range(n_batch)]
    return FanoutMesh(
        [[d for _, d in row] for row in grid],
        [[r for r, _ in row] for row in grid],
        rank=rank, group=group,
    )
