"""Row-sharded pyramid grid table: port of the split and ``splice`` of the
JAX package's parallel/table_mp.py:24 ``shard_grid_rows``. The JAX mesh
becomes a shard count; the table-parallel train step comes with the training
slice.

The fast render keeps this layout: every frame gathers the shards
(``parallel.ring.all_gather_table``) and splices the table back before it
renders, as the JAX package's table-parallel step does once per step
(table_mp.py:94-96).
"""

from __future__ import annotations

import torch


def default_shard_count(device) -> int:
    """One shard per card on CUDA, one on the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def shard_grid_rows(params: dict, n: int | None = None, leaf: int = -1):
    """Split ``params["grids"][leaf]`` ([R,R,R,C]) into ``n`` equal row
    shards of its [R^3, C] table, on the grid's device.

    Returns (params_rest, shards, splice): ``params_rest`` is a shallow
    copy of ``params`` with None in place of the leaf, ``shards`` is the
    list of n [R^3/n, C] tensors (views of the leaf when it is contiguous,
    so the table is not held twice), and ``splice(params_rest, table)``
    rebuilds the full tree from a gathered [R^3, C] table.
    """
    grid = params["grids"][leaf]
    if n is None:
        n = default_shard_count(grid.device)
    shape = tuple(grid.shape)
    table = grid.reshape(-1, shape[-1])
    if n < 1 or table.shape[0] % n:
        raise ValueError(f"table rows {table.shape[0]} not divisible into {n} shards")
    shards = list(table.chunk(n, dim=0))
    li = leaf % len(params["grids"])

    def splice(params_rest: dict, full_table: torch.Tensor) -> dict:
        grids = list(params_rest["grids"])
        grids[li] = full_table.reshape(shape)
        return {**params_rest, "grids": grids}

    params_rest = {**params, "grids": [None if i == li else g for i, g in enumerate(params["grids"])]}
    return params_rest, shards, splice
