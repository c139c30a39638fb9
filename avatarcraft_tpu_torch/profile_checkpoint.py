"""What a trainer's state save and restore cost on one card's host.

    python -m avatarcraft_tpu_torch.profile_checkpoint [--reps 3]

The state is the fast trainer's at the artifact's width: profile_train's
fast step on its image set, STEPS steps with the grid refreshed from
zeros half-way (as ``train_fast``'s first refresh), then the parameters
gathered and Adam's moments read as ``train_fast`` saves them (about
0.92 GB of f32 arrays). Each measurement REPS times, on the host clock,
the two writers in turn:

- ``orbax``: ``save_train_state`` to a directory, the JAX package's orbax
  train state (``utils/orbax.py::save``: the copies to the host, zstd
  level 1, the writes and their fsync, the rename);
- ``pt``: ``save_train_state`` to a ``.pt`` file, the port's ``torch.save``
  file (what the trainers wrote before they wrote orbax; no fsync);
- ``zstd``: zstd level 1 alone over the same arrays on the host, with one
  thread (``ZSTD_c_nbWorkers`` 0) and with zstd's worker threads, one a
  host core, each array a frame as the writer compresses it;
- ``copy``: the arrays copied to the host alone;
- the restores: ``load_train_state`` of each onto the card.

Prints one JSON line that names the card and the host's cores. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from avatarcraft_tpu_torch.models.instant_nsr import FastRenderConfig, init_field_params
from avatarcraft_tpu_torch.parallel.table_mp import gathered_params, trainable_shards
from avatarcraft_tpu_torch.profile_train import _batches, artifact_image_set
from avatarcraft_tpu_torch.utils import orbax
from avatarcraft_tpu_torch.utils.checkpoint import leaves, load_train_state, save_train_state
from avatarcraft_tpu_torch.utils.device import card_line
from avatarcraft_tpu_torch.workloads.reconstruct import (
    ReconstructConfig,
    adam_moments,
    make_batch_ray_fn,
    make_grid_update_fn,
    make_optimizer,
    make_train_step_fast,
)

STEPS, REPS = 40, 3


def trained_state(device="cuda") -> dict:
    """save_train_state's arguments after STEPS fast steps: params, mu, nu,
    count, step, grid."""
    ds, fcfg, normal_mode = artifact_image_set(device)
    fast_cfg = FastRenderConfig(normal_mode=normal_mode)
    cfg = ReconstructConfig()
    params = init_field_params(torch.Generator(device).manual_seed(cfg.seed), fcfg)
    rest, shards, splice = trainable_shards(params)
    del params
    opt, sched = make_optimizer(cfg, ds.n_images * ds.H * ds.W // cfg.batch_size, leaves(rest) + shards)
    step = make_train_step_fast(fcfg, fast_cfg, opt, make_batch_ray_fn(ds.K, ds.H, ds.W), cfg.eikonal_weight,
                                splice, sched)
    refresh = make_grid_update_fn(fcfg, fast_cfg.bound)
    grid = torch.full((129,) * 3, 100.0, device=device)
    poses = torch.as_tensor(ds.poses, device=device)
    batches = _batches(ds, cfg, device)
    for i in range(STEPS):
        if i == STEPS // 2:
            grid.copy_(refresh(gathered_params(rest, shards, splice), torch.zeros_like(grid)))
        step(rest, shards, poses, *next(batches), grid, 1.0)
    mu, nu, count = adam_moments(opt, rest, shards, splice)
    torch.cuda.synchronize()
    return {"params": gathered_params(rest, shards, splice), "mu": mu, "nu": nu, "count": count, "step": STEPS,
            "grid": grid}


def host_arrays(state: dict) -> list:
    """The state's arrays on the host, in the order the writer takes them."""
    return [t.detach().cpu().numpy() for key in ("grid", "mu", "nu", "params") for t in leaves(state[key])]


def zstd_seconds(arrays: list, workers: int) -> tuple[float, int]:
    """(seconds, bytes out) of zstd level 1 over ``arrays``, one frame each,
    with ``workers`` worker threads (0: the calling thread alone)."""
    lib = orbax.libzstd()
    seconds, out_bytes = 0.0, 0
    for a in arrays:
        src = a.reshape(-1).view(np.uint8)
        dst = np.empty(lib.ZSTD_compressBound(src.size), np.uint8)
        cctx = lib.ZSTD_createCCtx()
        try:
            for param, value in ((orbax._ZSTD_C_COMPRESSION_LEVEL, 1), (orbax._ZSTD_C_NB_WORKERS, workers)):
                ret = lib.ZSTD_CCtx_setParameter(cctx, param, value)
                if lib.ZSTD_isError(ret):
                    raise RuntimeError(f"zstd parameter {param} = {value}: {lib.ZSTD_getErrorName(ret).decode()}")
            t0 = time.perf_counter()
            ret = lib.ZSTD_compress2(cctx, dst.ctypes.data, dst.size, src.ctypes.data, src.size)
            seconds += time.perf_counter() - t0
        finally:
            lib.ZSTD_freeCCtx(cctx)
        if lib.ZSTD_isError(ret):
            raise RuntimeError(f"zstd: {lib.ZSTD_getErrorName(ret).decode()}")
        out_bytes += ret
    return seconds, out_bytes


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(reps: int = REPS) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_checkpoint measures a CUDA card; none is available")
    state = trained_state()
    args = [state[k] for k in ("params", "mu", "nu", "count", "step", "grid")]
    workers = os.cpu_count() or 1
    out = {k: [] for k in ("orbax_save_s", "pt_save_s", "copy_s", "zstd_1_thread_s", f"zstd_{workers}_workers_s",
                           "orbax_restore_s", "pt_restore_s")}
    work = tempfile.mkdtemp(prefix="profile_checkpoint_")
    try:
        dir_path, pt_path = os.path.join(work, "state"), os.path.join(work, "state.pt")
        for _ in range(reps):
            stats = {}
            out["orbax_save_s"].append(_timed(lambda: stats.update(save_train_state(dir_path, *args))))
            out["pt_save_s"].append(_timed(lambda: save_train_state(pt_path, *args)))
            arrays = []
            out["copy_s"].append(_timed(lambda: arrays.extend(host_arrays(state))))
            one, zbytes = zstd_seconds(arrays, 0)
            out["zstd_1_thread_s"].append(one)
            out[f"zstd_{workers}_workers_s"].append(zstd_seconds(arrays, workers)[0])
            del arrays
            out["orbax_restore_s"].append(_timed(lambda: load_train_state(dir_path, "cuda")))
            out["pt_restore_s"].append(_timed(lambda: load_train_state(pt_path, "cuda")))
        pt_bytes = os.path.getsize(pt_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result = {
        "device": torch.cuda.get_device_name(0),
        "card": card_line(),
        "host_cores": workers,
        "zstd": orbax.zstd_route(),
        "steps": STEPS,
        "array_bytes": stats["array_bytes"],
        "orbax_store_bytes": stats["store_bytes"],
        "zstd_level1_bytes": zbytes,
        "pt_bytes": pt_bytes,
        **out,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=REPS)
    main(ap.parse_args().reps)
