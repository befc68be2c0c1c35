"""Device ops of the port: voxelization, the submanifold-conv rulebook and
its gather and z-pack engines, the band and z-band convs and the brick conv
(hand-written CUDA kernels) with the brick layout, the pencil and tile
engines, window attention, z-order and Hilbert codes, PointNet++'s
sampling and grouping, the cylinder
projection of labeling and the QSM stage, and the grid-bucketed neighbor
search and geometric features of labeling. The package exports the
labeling ops and the curve codes as the JAX package's ``ops`` does, but no
name of a submodule (``voxelize`` stays the module)."""

from .projection import (
    Cylinders,
    cylinders_from_table,
    closest_cylinder,
    generate_offset_cloud,
)
from .serialization import (
    decode,
    encode,
    hilbert_encode,
    serialized_order,
    z_order_encode,
)
from .neighbors import knn, radius_count
from .features import (
    add_features,
    compute_normals,
    compute_curvature,
    compute_density,
    compute_height,
    compute_verticality,
    compute_distance_to_center,
)

__all__ = [
    "Cylinders",
    "cylinders_from_table",
    "closest_cylinder",
    "generate_offset_cloud",
    "decode",
    "encode",
    "serialized_order",
    "z_order_encode",
    "hilbert_encode",
    "knn",
    "radius_count",
    "add_features",
    "compute_normals",
    "compute_curvature",
    "compute_density",
    "compute_height",
    "compute_verticality",
    "compute_distance_to_center",
]
