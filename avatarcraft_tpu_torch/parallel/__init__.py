from avatarcraft_tpu_torch.parallel.ring import (
    all_gather_rows,
    all_gather_rows_plain,
    all_gather_table,
)
from avatarcraft_tpu_torch.parallel.table_mp import shard_grid_rows

__all__ = [
    "all_gather_rows",
    "all_gather_rows_plain",
    "all_gather_table",
    "shard_grid_rows",
]
