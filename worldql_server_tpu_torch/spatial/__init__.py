from .quantize import (
    clamp_region_coord,
    clamp_region_coord_batch,
    clamp_table_size,
    coord_clamp,
    coord_clamp_batch,
    cube_coords,
    cube_coords_batch,
    region_coords,
    region_coords_batch,
    table_bounds,
)


def __getattr__(name):
    # the device index imports ops/, whose modules import this
    # package's hashing: resolved on first use to break the cycle
    if name == "CudaSpatialBackend":
        from .cuda_backend import CudaSpatialBackend

        return CudaSpatialBackend
    if name == "precompile_tiers":
        from .precompile import precompile_tiers

        return precompile_tiers
    raise AttributeError(name)


__all__ = [
    "CudaSpatialBackend",
    "coord_clamp",
    "coord_clamp_batch",
    "cube_coords",
    "cube_coords_batch",
    "clamp_region_coord",
    "clamp_region_coord_batch",
    "clamp_table_size",
    "region_coords",
    "region_coords_batch",
    "precompile_tiers",
    "table_bounds",
]
