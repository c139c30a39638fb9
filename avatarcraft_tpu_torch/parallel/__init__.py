from avatarcraft_tpu_torch.parallel.ring import (
    all_gather_rows,
    all_gather_rows_plain,
    all_gather_table,
    reduce_scatter_rows,
    reduce_scatter_rows_plain,
)
from avatarcraft_tpu_torch.parallel.table_mp import TableMPTrainStep, shard_grid_rows, trainable_shards

__all__ = [
    "all_gather_rows",
    "all_gather_rows_plain",
    "all_gather_table",
    "reduce_scatter_rows",
    "reduce_scatter_rows_plain",
    "TableMPTrainStep",
    "shard_grid_rows",
    "trainable_shards",
]
