"""Row-sharded pyramid grid table: port of the JAX package's
parallel/table_mp.py (``shard_grid_rows`` at :24, ``make_table_mp_train_step``
at :60-112, here the class ``TableMPTrainStep``). The JAX mesh becomes a
shard count.

The fast render keeps this layout: every frame gathers the shards
(``parallel.ring.all_gather_table``) and splices the table back before it
renders. A train step gathers them inside its loss, as the JAX package's
table-parallel step does (table_mp.py:94-96); the gather's backward
(the reduce-scatter kernel) hands each shard its block of the table's
gradient, so each shard keeps its own optimizer state.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from avatarcraft_tpu_torch.models.instant_nsr import render_rays
from avatarcraft_tpu_torch.parallel.ring import all_gather_table
from avatarcraft_tpu_torch.utils.checkpoint import leaves, map_leaves


def shard_grid_rows(params: dict, n: int = 1, leaf: int = -1):
    """Split ``params["grids"][leaf]`` ([R,R,R,C]) into ``n`` equal row
    shards of its [R^3, C] table, on the grid's device. The default is one
    shard per card in use: the port drives one card, and a larger ``n``
    splits the table on that card (the on-card checks compare the two).

    Returns (params_rest, shards, splice): ``params_rest`` is a shallow
    copy of ``params`` with None in place of the leaf, ``shards`` is the
    list of n [R^3/n, C] tensors (views of the leaf when it is contiguous,
    so the table is not held twice), and ``splice(params_rest, table)``
    rebuilds the full tree from a gathered [R^3, C] table.
    """
    grid = params["grids"][leaf]
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


def trainable_shards(params: dict, n: int = 1):
    """(rest, shards, splice) as ``shard_grid_rows`` gives them, but every
    tensor a fresh leaf of its own that requires grad: clones, which an
    optimizer can own, of the rest of the tree and of the n table shards."""
    params_rest, shards, splice = shard_grid_rows(params, n)
    own = lambda t: t.detach().clone().requires_grad_()  # noqa: E731
    return map_leaves(params_rest, own), [own(s) for s in shards], splice


@torch.no_grad()
def gathered_params(rest: dict, shards, splice) -> dict:
    """The full parameter tree of (rest, shards), detached, the table
    gathered."""
    return map_leaves(splice(rest, all_gather_table(shards)), torch.Tensor.detach)


W_EIKONAL = 0.1
BG_VALUE = 1.0


class TableMPTrainStep:
    """One photometric train step with the finest grid row-sharded: the loss
    gathers the shards (``all_gather_rows``), splices the table in, renders
    through ``render_rays`` on a white background and takes mse + 0.1 *
    gradient_error (the JAX package's defaults); the
    backward returns each shard its gradient block (``reduce_scatter_rows``);
    one optimizer steps the rest of the tree and one the shards, so the
    table's optimizer state lives per shard (the JAX package's
    parallel/table_mp.py:60-112).

    ``optimizer``: a function from a list of tensors to a
    ``torch.optim.Optimizer`` over them. The step owns its parameters: clones
    of ``params``, which it never modifies."""

    def __init__(self, params: dict, n_shards: int, fcfg, rcfg, optimizer):
        self.rest, self.shards, self.splice = trainable_shards(params, n_shards)
        self.opt_rest = optimizer(leaves(self.rest))
        self.opt_table = optimizer(self.shards)
        self.fcfg, self.rcfg = fcfg, rcfg

    def loss(self, rays_o, rays_d, gt, generator=None) -> torch.Tensor:
        params = self.splice(self.rest, all_gather_table(self.shards))
        out = render_rays(params, rays_o, rays_d, self.fcfg, self.rcfg, BG_VALUE, generator)
        return torch.mean((out["rgb"] - gt) ** 2) + W_EIKONAL * out["gradient_error"]

    def __call__(self, rays_o, rays_d, gt, generator=None) -> torch.Tensor:
        """One step on rays [N,3] against gt [N,3]; returns the loss
        (detached) computed before the update."""
        self.opt_rest.zero_grad(set_to_none=True)
        self.opt_table.zero_grad(set_to_none=True)
        with record_function("train.forward"):
            loss = self.loss(rays_o, rays_d, gt, generator)
        with record_function("train.backward"):
            loss.backward()
        with record_function("train.optimizer"):
            self.opt_rest.step()
            self.opt_table.step()
        return loss.detach()

    def params(self) -> dict:
        """The current full parameter tree (detached, the table gathered)."""
        return gathered_params(self.rest, self.shards, self.splice)
