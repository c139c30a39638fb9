"""Row-sharded pyramid grid table: port of the JAX package's
parallel/table_mp.py (``shard_grid_rows`` at :24, ``make_table_mp_train_step``
at :60-112, here the class ``TableMPTrainStep``). The JAX mesh becomes a
shard count n, all n shards in this process, or a ``parallel.mesh.Mesh``
of ranks: each rank then keeps only its own shard, renders its own rays,
and the loss gathers the table across the ranks
(``ring.ring_all_gather_grad``).

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
from avatarcraft_tpu_torch.parallel.mesh import Mesh, all_reduce_grads, global_mean, global_ratio, one_rank
from avatarcraft_tpu_torch.parallel.ring import all_gather_table
from avatarcraft_tpu_torch.utils.checkpoint import leaves, map_leaves


def shard_grid_rows(params: dict, n: int | Mesh = 1, leaf: int = -1):
    """Split ``params["grids"][leaf]`` ([R,R,R,C]) into ``n`` equal row
    shards of its [R^3, C] table, on the grid's device; a hash-grid tree
    (no "grids") splits its table ``params["table"]`` instead. The default
    is one shard per card in use: the port drives one card, and a larger
    ``n`` splits the table on that card (the on-card checks compare the
    two).

    Returns (params_rest, shards, splice): ``params_rest`` is a shallow
    copy of ``params`` with None in place of the leaf, ``shards`` is the
    list of n [rows/n, C] tensors (views of the leaf when it is contiguous,
    so the table is not held twice), and ``splice(params_rest, table)``
    rebuilds the full tree from a gathered [rows, C] table. With a ``Mesh``
    for n, the table splits into one shard a rank and ``shards`` holds this
    rank's alone.
    """
    if isinstance(n, Mesh):
        rest, shards, splice = shard_grid_rows(params, n.size, leaf)
        return rest, [shards[n.rank]], splice
    hashed = "grids" not in params
    leaf_tensor = params["table"] if hashed else params["grids"][leaf]
    shape = tuple(leaf_tensor.shape)
    table = leaf_tensor.reshape(-1, shape[-1])
    if n < 1 or table.shape[0] % n:
        raise ValueError(f"table rows {table.shape[0]} not divisible into {n} shards")
    shards = list(table.chunk(n, dim=0))
    if hashed:
        return {**params, "table": None}, shards, lambda rest, full: {**rest, "table": full.reshape(shape)}
    li = leaf % len(params["grids"])

    def splice(params_rest: dict, full_table: torch.Tensor) -> dict:
        grids = list(params_rest["grids"])
        grids[li] = full_table.reshape(shape)
        return {**params_rest, "grids": grids}

    params_rest = {**params, "grids": [None if i == li else g for i, g in enumerate(params["grids"])]}
    return params_rest, shards, splice


def trainable_shards(params: dict, n: int | Mesh = 1):
    """(rest, shards, splice) as ``shard_grid_rows`` gives them, but every
    tensor a fresh leaf of its own that requires grad: clones, which an
    optimizer can own, of the rest of the tree and of the table shards."""
    params_rest, shards, splice = shard_grid_rows(params, n)
    own = lambda t: t.detach().clone().requires_grad_()  # noqa: E731
    return map_leaves(params_rest, own), [own(s) for s in shards], splice


@torch.no_grad()
def gathered_params(rest: dict, shards, splice, mesh=None) -> dict:
    """The full parameter tree of (rest, shards), detached, the table
    gathered (across the ranks of ``mesh``: a collective)."""
    return map_leaves(splice(rest, all_gather_table(shards, mesh)), torch.Tensor.detach)


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

    ``shards``: n, the table split n ways in this process, or a ``Mesh``
    of ranks. ``optimizer``: a function from a list of tensors to a
    ``torch.optim.Optimizer`` over them. The step owns its parameters: clones
    of ``params``, which it never modifies.

    Over a ``Mesh`` (the JAX step over a mesh: rays data parallel, table
    rows model parallel) each rank holds its one shard and
    its shard's optimizer state, and is called with its own rows of the
    rays; the loss is the global batch's (the squared error's mean and the
    eikonal term's weighted mean summed over the ranks before they divide),
    the table's gradient arrives through the cross-rank reduce-scatter and
    the rest's is summed over the ranks, so the replicas of the rest take
    the same step."""

    def __init__(self, params: dict, shards: int | Mesh, fcfg, rcfg, optimizer):
        self.mesh = shards if isinstance(shards, Mesh) else one_rank()
        self.rest, self.shards, self.splice = trainable_shards(params, shards)
        self.opt_rest = optimizer(leaves(self.rest))
        self.opt_table = optimizer(self.shards)
        self.fcfg, self.rcfg = fcfg, rcfg

    def loss(self, rays_o, rays_d, gt, generator=None) -> torch.Tensor:
        params = self.splice(self.rest, all_gather_table(self.shards, self.mesh))
        out = render_rays(params, rays_o, rays_d, self.fcfg, self.rcfg, BG_VALUE, generator)
        mse = global_mean(torch.sum((out["rgb"] - gt) ** 2), gt.numel(), self.mesh)
        return mse + W_EIKONAL * global_ratio(out["gradient_error_sum"], out["gradient_relax_sum"], self.mesh)

    def __call__(self, rays_o, rays_d, gt, generator=None) -> torch.Tensor:
        """One step on rays [N,3] against gt [N,3]; returns the loss
        (detached) computed before the update."""
        self.opt_rest.zero_grad(set_to_none=True)
        self.opt_table.zero_grad(set_to_none=True)
        with record_function("train.forward"):
            loss = self.loss(rays_o, rays_d, gt, generator)
        with record_function("train.backward"):
            loss.backward()
            all_reduce_grads(leaves(self.rest), self.mesh)
        with record_function("train.optimizer"):
            self.opt_rest.step()
            self.opt_table.step()
        return loss.detach()

    def params(self) -> dict:
        """The current full parameter tree (detached, the table gathered)."""
        return gathered_params(self.rest, self.shards, self.splice, self.mesh)
