"""Device ops on torch tensors: the entity plane's tick (``tick``), its
hand-written CUDA kNN kernel (``knn``, built from ``csrc/`` by
``build``), and the device subscription index's ops K1–K6 (``index``,
torch compositions driven by ``spatial/cuda_backend.py``)."""

from .index import (
    CSR_ROW,
    CSR_ROW_B,
    compact_sparse,
    csr_layout,
    match_core,
    match_run_csr,
    pack_csr,
    padded_slots,
    probe_buckets_for,
    probe_tables,
    run_bounds_all,
    run_csr_assemble,
    run_remainders,
    zone_b_cnts,
)
from .knn import knn_select, knn_select_plain
from .tick import (
    EntityState,
    device_coord_clamp,
    device_spatial_keys,
    make_tick_fn,
    simulation_tick,
    state_from_numpy,
    state_to_numpy,
)

__all__ = [
    "CSR_ROW",
    "CSR_ROW_B",
    "EntityState",
    "compact_sparse",
    "csr_layout",
    "device_coord_clamp",
    "device_spatial_keys",
    "knn_select",
    "knn_select_plain",
    "make_tick_fn",
    "match_core",
    "match_run_csr",
    "pack_csr",
    "padded_slots",
    "probe_buckets_for",
    "probe_tables",
    "run_bounds_all",
    "run_csr_assemble",
    "run_remainders",
    "simulation_tick",
    "state_from_numpy",
    "state_to_numpy",
    "zone_b_cnts",
]
