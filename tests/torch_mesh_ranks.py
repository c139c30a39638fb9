"""Rank functions of the mesh tests (tests/test_torch_mesh.py), run by
``parallel.mesh.launch`` in spawned processes. A module of its own that
imports no JAX, so that a rank imports only the port."""

import os

import numpy as np
import torch

from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.cli import render_canonical_cli as cli
from avatarcraft_tpu_torch.parallel import mesh as mesh_lib
from avatarcraft_tpu_torch.parallel import ring
from avatarcraft_tpu_torch.parallel.table_mp import TableMPTrainStep, shard_grid_rows
from avatarcraft_tpu_torch.utils.checkpoint import map_leaves


def four_ranks(mesh, batch: dict, table: np.ndarray, cts: np.ndarray, int_cts: np.ndarray, params: dict, fcfg,
               rcfg, rays: tuple, sums: np.ndarray) -> dict:
    """``mesh_and_ring``, ``table_mp_step`` and ``sum_checks`` in one
    launch."""
    return {**mesh_and_ring(mesh, batch, table, cts, int_cts), "table_mp": table_mp_step(mesh, params, fcfg, rcfg, rays),
            "sums": sum_checks(mesh, sums)}


def sum_checks(mesh, sums: np.ndarray) -> dict:
    """Rank r's row of ``sums`` [n, N] summed over the ranks four ways: the
    plain all-reduce, ``psum``, ``all_reduce_grads`` (the row cut into two
    gradients) and the plain reduce-scatter followed by the plain gather
    (the row as a [24, N / 24] table)."""
    row = torch.from_numpy(sums[mesh.rank])
    params = [torch.nn.Parameter(torch.zeros(7)), torch.nn.Parameter(torch.zeros(row.numel() - 7))]
    params[0].grad, params[1].grad = row[:7].clone(), row[7:].clone()
    mesh_lib.all_reduce_grads(params, mesh)
    table = row.reshape(24, -1)
    return {
        "all_reduce": ring.ring_all_reduce_plain(row, mesh),
        "psum": mesh_lib.psum(row, mesh),
        "grads": torch.cat([p.grad for p in params]),
        "rs_gather": ring.ring_all_gather_plain(ring.ring_reduce_scatter_plain(table, mesh), mesh).reshape(-1),
    }


def mesh_and_ring(mesh, batch: dict, table: np.ndarray, cts: np.ndarray, int_cts: np.ndarray) -> dict:
    """The mesh's own facts, a sharded and a replicated batch, the gather
    of rank r's row block of ``table``, and the gather's VJP of rank r's
    cotangent ``cts[r]`` (random, then small integers) through autograd."""
    n, r = mesh.size, mesh.rank
    shard = torch.from_numpy(table).chunk(n)[r].contiguous()
    out = {
        "size": mesh.size, "rank": r, "device": str(mesh.device), "axis": mesh.axis_name,
        "sharded": mesh_lib.shard_batch(mesh, batch),
        "rows": (mesh_lib.data_sharding(mesh, len(table)).start, mesh_lib.data_sharding(mesh, len(table)).stop),
        # rank r's own values replaced by r: replicate must hand every rank rank 0's
        "replicated": mesh_lib.replicate(mesh, {k: v + r for k, v in batch.items()}),
        "gathered": ring.ring_all_gather(shard, mesh),
        "psum": mesh_lib.psum(torch.tensor([float(r + 1)]), mesh),
    }
    for key, ct in (("vjp", cts), ("vjp_int", int_cts)):
        leaf = shard.clone().requires_grad_()
        ring.all_gather_table(leaf, mesh).backward(torch.from_numpy(ct[r]))
        out[key] = leaf.grad
    try:
        mesh_lib.shard_batch(mesh, {"odd": np.zeros((n + 1, 2), np.float32)})
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def table_mp_step(mesh, params: dict, fcfg, rcfg, rays: tuple) -> dict:
    """One table-parallel SGD(0.5) step over the mesh on rank r's rows of
    ``rays``: the loss, the updated tree (table gathered) and the rank's
    shard."""
    params = map_leaves(params, lambda a: torch.from_numpy(np.array(a, np.float32)))
    step = TableMPTrainStep(params, mesh, fcfg, rcfg, lambda ps: torch.optim.SGD(ps, lr=0.5))
    rows = mesh_lib.data_sharding(mesh, len(rays[0]))
    loss = step(*(torch.from_numpy(np.asarray(a))[rows] for a in rays))
    _, own, _ = shard_grid_rows(params, mesh)
    return {"loss": float(loss), "params": step.params(), "shard_rows": own[0].shape[0],
            "n_shards": len(step.shards)}


def trainer_losses(ds, fcfgs: dict, cfg, max_steps: int, mesh=None) -> dict:
    """The logged losses and final parameters of ``train`` (64+64, hash
    grid, jitter on), ``train_fast`` and ``train_fast`` at scan_steps 2,
    and ``train_fast`` on a hash grid, over the mesh (or in this
    process)."""
    from avatarcraft_tpu_torch.workloads import reconstruct

    out = {}
    params, stats = reconstruct.train(ds, fcfgs["hash"], fcfgs["rcfg"], cfg, max_steps=max_steps, log_every=1,
                                      device="cpu", mesh=mesh)
    out["train"] = ([loss for _, loss in stats["losses"]], params)
    for scan in (0, 2):
        params, _, stats = reconstruct.train_fast(ds, fcfgs["pyr"], fcfgs["fast"], cfg, max_steps=max_steps,
                                                  log_every=1, grid_update_every=0, scan_steps=scan, device="cpu",
                                                  mesh=mesh)
        out[f"train_fast_scan{scan}"] = ([loss for _, loss in stats["losses"]], params)
    # a hash table whose rows no rank count divides: replicated, as in JAX
    params, _, stats = reconstruct.train_fast(ds, fcfgs["hash_odd"], fcfgs["fast"], cfg, max_steps=max_steps,
                                              log_every=1, grid_update_every=0, device="cpu", mesh=mesh)
    out["train_fast_hash"] = ([loss for _, loss in stats["losses"]], params)
    return out


def two_ranks(mesh, params: dict, fcfg, rcfg, rays: tuple, ds, fcfgs: dict, cfg, max_steps: int,
              sums: np.ndarray) -> dict:
    """The table-parallel step, the three trainers and ``sum_checks`` over
    a 2-rank mesh."""
    return {"table_mp": table_mp_step(mesh, params, fcfg, rcfg, rays),
            "trainers": trainer_losses(ds, fcfgs, cfg, max_steps, mesh), "sums": sum_checks(mesh, sums)}


CLI_ARGS = ["--weights_path", bench.ARTIFACT_CKPT, "--grid_path", bench.ARTIFACT_GRID, "--use_cuda", "false",
            "--render_h", "8", "--render_w", "12", "--trajectory_resolution", "2", "--batch_size", "40"]


def cli_files_over_ranks(tmp_path, sampler):
    """Hold the canonical CLI's files at --mesh_devices 2 on the CPU to
    those of one process: the same names, the same bytes."""
    for n in (1, 2):
        cli.main(CLI_ARGS + ["--sampler", sampler, "--mesh_devices", str(n), "--out_dir", str(tmp_path / str(n)),
                             "--exp_name", "t"])
    one, two = tmp_path / "1" / "canonical_360" / "t", tmp_path / "2" / "canonical_360" / "t"
    names = sorted(os.listdir(one))
    assert sorted(os.listdir(two)) == names and len(names) == 6  # 4 PNGs, 2 GIFs
    for name in names:
        assert (one / name).read_bytes() == (two / name).read_bytes(), name
