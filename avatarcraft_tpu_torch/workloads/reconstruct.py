"""Canonical NeuS reconstruction from multiview images: the fast
(occupancy-guided) trainer and its parts. Port of the JAX package's
workloads/reconstruct.py (ReconstructConfig, make_batch_ray_fn, smooth_l1,
make_optimizer, make_train_step, make_train_step_fast, make_grid_update_fn,
pixel_batches, train_fast; reference: reconstruct.py:29-165).

Loss and optimizer follow the reference: smooth-L1 photometric + 0.1 x
eikonal, Adam(5e-4, betas (0.9, 0.99), eps 1e-15) on a cosine decay to 0
(reconstruct.py:48-50,105-106). The fast step is table-sharded by design,
where the JAX package's replicates its parameters: it keeps the finest
grid as row shards, one per card in use (so one shard on the one card the
port drives), and gathers them inside its loss through the all-gather
kernel, whose backward is the reduce-scatter kernel (``parallel.ring``),
as the table-parallel step does. A trainer across cards then shards the
table and its Adam state instead of holding a copy on every card.

The trainer takes an in-memory image set (``ImageSet``); the dataset
loader, lax.scan-style multi-step calls and train-state save and resume are
not ported yet (ROADMAP item 12).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Iterator

import numpy as np
import torch
from torch.profiler import record_function

from avatarcraft_tpu_torch.models.instant_nsr import (
    FieldConfig,
    RenderConfig,
    forward_sdf,
    init_field_params,
    materialize_field_tables,
    network_field_fns,
    render_rays,
    render_rays_fast,
)
from avatarcraft_tpu_torch.ops.occupancy import update_density_grid
from avatarcraft_tpu_torch.ops.sampling import recip
from avatarcraft_tpu_torch.parallel.ring import all_gather_table
from avatarcraft_tpu_torch.parallel.table_mp import gathered_params, trainable_shards
from avatarcraft_tpu_torch.utils.checkpoint import leaves


@dataclasses.dataclass(frozen=True)
class ReconstructConfig:
    batch_size: int = 1600  # reference: reconstruct.py:74
    lr: float = 5e-4
    epochs: int = 2
    eikonal_weight: float = 0.1
    white_bkg: bool = True
    seed: int = 42
    # "raw": the stored images as they are against renders composited on the
    # white_bkg color (the reference); "composite": ground truth composited
    # on that color through the masks; "composite_random": on a random gray
    # level drawn per step
    bkg_mode: str = "raw"


@dataclasses.dataclass
class ImageSet:
    """An in-memory multiview image set, with the attributes the trainer
    reads: intrinsics ``K`` [3,3], camera-to-world ``poses`` [V,4,4]
    (OpenGL convention), ``images`` [V,H,W,3] and ``masks`` [V,H,W], f32."""

    K: np.ndarray
    poses: np.ndarray
    images: np.ndarray
    masks: np.ndarray

    @property
    def n_images(self) -> int:
        return self.images.shape[0]

    @property
    def H(self) -> int:
        return self.images.shape[1]

    @property
    def W(self) -> int:
        return self.images.shape[2]

    def gather_rgb(self, view_idx: np.ndarray, pix_idx: np.ndarray) -> np.ndarray:
        """Ground-truth rgb of a ray batch, [M,3]."""
        return self.images.reshape(self.n_images, -1, 3)[view_idx, pix_idx]

    def gather_mask(self, view_idx: np.ndarray, pix_idx: np.ndarray) -> np.ndarray:
        """Subject mask of a ray batch, [M]."""
        return self.masks.reshape(self.n_images, -1)[view_idx, pix_idx]


def make_batch_ray_fn(K: np.ndarray, H: int, W: int):
    """(poses [V,4,4], view_idx [B], pix_idx [B]) -> (rays_o, rays_d) [B,3],
    on the poses' device, in the dataset's OpenGL convention (reference:
    utils/SMPLDataset.py:86-103)."""
    fx, fy, cx, cy = float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])

    def ray_fn(poses, view_idx, pix_idx):
        pose = poses[view_idx]
        y = torch.div(pix_idx, W, rounding_mode="floor").float()
        x = (pix_idx % W).float()
        p = torch.stack([(x - cx) * recip(fx), -((y - cy) * recip(fy)), -torch.ones_like(x)], dim=-1)
        v = p / torch.linalg.norm(p, dim=-1, keepdim=True)
        rays_d = torch.einsum("bij,bj->bi", pose[:, :3, :3], v)
        return pose[:, :3, 3], rays_d

    return ray_fn


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch's F.smooth_l1_loss with beta 1, mean reduction, written out as
    the JAX package writes it."""
    d = pred - target
    ad = d.abs()
    return torch.mean(torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5))


def cosine_decay(decay_steps: int):
    """optax.cosine_decay_schedule's factor with alpha 0: step -> 0.5 (1 +
    cos(pi min(step, decay_steps) / decay_steps))."""

    def factor(step: int) -> float:
        return 0.5 * (1.0 + math.cos(math.pi * min(step, decay_steps) / decay_steps))

    return factor


def make_optimizer(cfg: ReconstructConfig, steps_per_epoch: int, params):
    """(Adam, LambdaLR) over the tensors ``params``: Adam(cfg.lr, betas
    (0.9, 0.99), eps 1e-15) with the learning rate on a cosine decay to 0
    over ``cfg.epochs * steps_per_epoch`` steps. Step the scheduler after
    each optimizer step: the first update uses lr(0), as optax's count does."""
    opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.99), eps=1e-15)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(max(cfg.epochs * steps_per_epoch, 1)))
    return opt, sched


def _update(optimizer, scheduler) -> None:
    with record_function("train.optimizer"):
        optimizer.step()
        if scheduler is not None:
            scheduler.step()


def make_train_step(fcfg: FieldConfig, rcfg: RenderConfig, optimizer, ray_fn, eikonal_weight: float,
                    bg_value: float, scheduler=None):
    """The importance-sampled train step: step(params, poses, view_idx,
    pix_idx, gt_rgb, generator=None) -> (loss, (photo, eikonal)), detached.
    ``params`` is the tree of the leaves ``optimizer`` owns; the step
    updates them in place."""

    def train_step(params, poses, view_idx, pix_idx, gt_rgb, generator=None):
        optimizer.zero_grad(set_to_none=True)
        rays_o, rays_d = ray_fn(poses, view_idx, pix_idx)
        out = render_rays(params, rays_o, rays_d, fcfg, rcfg, bg_value, generator)
        photo = smooth_l1(out["rgb"], gt_rgb)
        loss = photo + eikonal_weight * out["gradient_error"]
        loss.backward()
        _update(optimizer, scheduler)
        return loss.detach(), (photo.detach(), out["gradient_error"].detach())

    return train_step


def fast_loss(params: dict, rays_o, rays_d, gt_rgb, fcfg: FieldConfig, fast_cfg, grid, bg,
              eikonal_weight: float, packed: dict):
    """(loss, photo, eikonal) of the fast render: smooth-L1 photometric +
    eikonal_weight x eikonal. ``packed``: materialize_field_tables of
    ``params``, built by the caller."""
    field = network_field_fns(params, fcfg, fast_cfg.bound, packed)
    out = render_rays_fast(params, rays_o, rays_d, fcfg, fast_cfg, grid, bg, field)
    photo = smooth_l1(out["rgb"], gt_rgb)
    return photo + eikonal_weight * out["gradient_error"], photo, out["gradient_error"]


def make_train_step_fast(fcfg: FieldConfig, fast_cfg, optimizer, ray_fn, eikonal_weight: float, splice,
                         scheduler=None):
    """The occupancy-guided train step: step(rest, shards, poses, view_idx,
    pix_idx, gt_rgb, grid, bg) -> (loss, (photo, eikonal)), detached.
    ``rest`` and ``shards`` come from ``trainable_shards`` (their leaves
    are what ``optimizer`` owns); the loss gathers the shards and splices
    the table in with ``splice``, and the step updates the leaves in
    place."""

    def train_step(rest, shards, poses, view_idx, pix_idx, gt_rgb, grid, bg):
        optimizer.zero_grad(set_to_none=True)
        rays_o, rays_d = ray_fn(poses, view_idx, pix_idx)
        with record_function("train.gather"):  # all_gather_rows
            params = splice(rest, all_gather_table(shards))
        with record_function("train.materialize"):
            packed = materialize_field_tables(params, fcfg)
        with record_function("train.forward"):
            loss, photo, gerr = fast_loss(
                params, rays_o, rays_d, gt_rgb, fcfg, fast_cfg, grid, bg, eikonal_weight, packed
            )
        with record_function("train.backward"):  # ends in reduce_scatter_rows
            loss.backward()
        _update(optimizer, scheduler)
        return loss.detach(), (photo.detach(), gerr.detach())

    return train_step


def make_grid_update_fn(fcfg: FieldConfig, bound: float):
    """refresh(params, grid) -> the grid refreshed from the field's SDF
    (``update_density_grid``), in x-slabs of the largest height that
    divides the grid's resolution and keeps a slab under 1M points (43 at
    129^3: 3 slabs of ~715k)."""

    @torch.no_grad()
    def refresh(params: dict, grid: torch.Tensor) -> torch.Tensor:
        R = grid.shape[0]
        b = max((d for d in range(1, R + 1) if R % d == 0 and d * R * R <= 1_000_000), default=1)
        packed = materialize_field_tables(params, fcfg)
        return update_density_grid(
            lambda x: forward_sdf(params, x, fcfg, bound, packed)[:, 0], grid, bound, block=b
        )

    return refresh


def pixel_batches(n_views: int, n_pixels: int, batch: int,
                  rng: np.random.Generator) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """One epoch of (view_idx, pix_idx) batches over a shuffled permutation
    of every (view, pixel), the reference's per-epoch ray permutation
    (reconstruct.py:80-83); the last partial batch is dropped."""
    perm = rng.permutation(n_views * n_pixels).astype(np.int64)
    for i in range(0, n_views * n_pixels - batch + 1, batch):
        sel = perm[i : i + batch]
        yield (sel // n_pixels).astype(np.int32), (sel % n_pixels).astype(np.int32)


def train_fast(
    dataset,
    fcfg: FieldConfig,
    fast_cfg,
    cfg: ReconstructConfig,
    *,
    max_steps: int | None = None,
    grid_update_every: int = 200,
    grid_warmup_steps: int = 2000,
    grid_resolution: int = 129,
    log_every: int = 50,
    device="cuda",
) -> tuple[dict, torch.Tensor, dict]:
    """Occupancy-guided reconstruction on ``device``: the density grid
    starts fully occupied (uniform sampling) and sparsifies through periodic
    refreshes as the field converges. ``dataset``: an ``ImageSet`` or any
    object with its attributes. Returns (params, density grid, stats); stats
    holds the logged (step, loss) pairs, rays/s and steps/s (timed from the
    end of the first step) and the step count."""
    params = init_field_params(torch.Generator(device).manual_seed(cfg.seed), fcfg)
    rest, shards, splice = trainable_shards(params)
    del params
    steps_per_epoch = dataset.n_images * dataset.H * dataset.W // cfg.batch_size
    opt, sched = make_optimizer(cfg, steps_per_epoch, leaves(rest) + shards)
    ray_fn = make_batch_ray_fn(dataset.K, dataset.H, dataset.W)
    step_fn = make_train_step_fast(fcfg, fast_cfg, opt, ray_fn, cfg.eikonal_weight, splice, sched)
    refresh = make_grid_update_fn(fcfg, fast_cfg.bound)
    grid = torch.full((grid_resolution,) * 3, 100.0, device=device)  # fully occupied at start
    poses = torch.as_tensor(np.asarray(dataset.poses, np.float32), device=device)

    def maybe_refresh(prev_step: int, step: int) -> None:
        nonlocal grid
        if not grid_update_every or step // grid_update_every <= prev_step // grid_update_every:
            return
        if step < grid_warmup_steps:
            return  # warmup: keep the saturated grid (uniform sampling)
        if step < grid_warmup_steps + grid_update_every:
            # first real refresh: drop the saturated floor (an EMA-max from
            # 100 would take ~45 refreshes to fall below the threshold)
            grid = refresh(gathered_params(rest, shards, splice), torch.zeros_like(grid))
        else:
            grid = refresh(gathered_params(rest, shards, splice), grid)

    rng = np.random.default_rng(cfg.seed)
    n_pix = dataset.H * dataset.W
    logged, step, t_start, timed_from, done = [], 0, None, 0, False
    for _ in range(cfg.epochs):
        if done:
            break
        for view_idx, pix_idx in pixel_batches(dataset.n_images, n_pix, cfg.batch_size, rng):
            gt = dataset.gather_rgb(view_idx, pix_idx)
            bg = 1.0 if cfg.white_bkg else 0.0
            if cfg.bkg_mode.startswith("composite"):
                if cfg.bkg_mode == "composite_random":
                    bg = float(rng.uniform())
                m = dataset.gather_mask(view_idx, pix_idx)[:, None]
                gt = gt * m + (1.0 - m) * bg
            vi = torch.as_tensor(view_idx, dtype=torch.int64, device=device)
            pi = torch.as_tensor(pix_idx, dtype=torch.int64, device=device)
            gt_d = torch.as_tensor(np.asarray(gt, np.float32), device=device)
            loss, _ = step_fn(rest, shards, poses, vi, pi, gt_d, grid, bg)
            if t_start is None:  # time from the end of the first step
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize(device)
                t_start, timed_from = time.perf_counter(), step + 1
            if log_every and step % log_every == 0:
                logged.append((step, loss))  # read once, after the loop
            step += 1
            maybe_refresh(step - 1, step)
            if max_steps is not None and step >= max_steps:
                done = True
                break

    params = gathered_params(rest, shards, splice)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    stats = {"losses": [(s, float(l)) for s, l in logged], "rays_per_sec": 0.0, "steps": step}
    if t_start is not None and step > timed_from:
        dt = time.perf_counter() - t_start
        stats["rays_per_sec"] = (step - timed_from) * cfg.batch_size / dt
        stats["steps_per_sec"] = (step - timed_from) / dt
    return params, grid, stats
