from avatarcraft_tpu_torch.ops.grid_encoder import (
    PyramidSpec,
    materialize_packed,
    pyramid_encode,
)
from avatarcraft_tpu_torch.ops.occupancy import (
    compact_indices,
    occupancy_lookup_bits,
    pack_occupancy_bits,
    scatter_to_flat,
    select_occupied_samples,
)
from avatarcraft_tpu_torch.ops.sampling import near_far_from_bound

__all__ = [
    "PyramidSpec",
    "materialize_packed",
    "pyramid_encode",
    "compact_indices",
    "occupancy_lookup_bits",
    "pack_occupancy_bits",
    "scatter_to_flat",
    "select_occupied_samples",
    "near_far_from_bound",
]
