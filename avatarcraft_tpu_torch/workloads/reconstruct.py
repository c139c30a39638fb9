"""Canonical NeuS reconstruction from multiview images: the 64+64
importance-sampled trainer (``setup``, ``train``), the fast
(occupancy-guided) trainer (``train_fast``) and their parts. Port of the
JAX package's workloads/reconstruct.py (ReconstructConfig,
make_batch_ray_fn(_ss), smooth_l1, make_optimizer, make_train_step(_fast),
make_grid_update_fn, pixel_batches, ReconstructState, setup, train,
train_fast, save_train_state, load_train_state; reference:
reconstruct.py:29-165).

Loss and optimizer follow the reference: smooth-L1 photometric + 0.1 x
eikonal, Adam(5e-4, betas (0.9, 0.99), eps 1e-15) on a cosine decay to 0
(reconstruct.py:48-50,105-106). The fast step keeps the finest grid as
one row shard and gathers it inside its loss through the all-gather
kernel, whose backward is the reduce-scatter kernel (``parallel.ring``),
as the table-parallel step does with n shards.

The 64+64 trainer replicates nothing and gathers nothing: as in the JAX
package, its step runs no table kernel.

Both trainers take a dataset (``data.SMPLMultiviewDataset`` or an
in-memory ``ImageSet``). The fast trainer's train state (parameters, Adam's
moments and step count, the grid, the step) is the JAX package's orbax
directory (``utils.checkpoint.save_train_state``), which either package
resumes from. A resume follows the JAX package:
it restores that state and restarts the epoch loop and the numpy pixel
order from the seed (reconstruct.py:423-443, 540-543), so a resumed run
is not the uninterrupted run.

Several steps per call (the JAX package's ``scan_steps``, a ``lax.scan``
over on-device batches; ``make_train_scan_fast``): on the card one train
step, from the batch's gathers to Adam's update, is captured into a CUDA
graph and replayed once a step; both table kernels run inside it. On the
CPU the same step runs eagerly.

Data parallel over a mesh of ranks (``parallel.mesh``; the JAX package's
``setup(mesh=...)``, ``_shard_batch_arrays`` and the sharded batches of
``train``/``train_fast``): each rank renders its rows of the global batch
(``_shard_batch_arrays``) and draws its rows of the global jitter; the
loss is the global batch's (smooth-L1's mean a sum over the global count,
the eikonal term's weighted mean from numerator and denominator summed
over the ranks); the gradients of the replicated parameters are summed
over the ranks and every replica takes the same Adam step. The fast step
replicates its table too, as the JAX package does, and gathers it with
the one-card kernel; the table row-sharded across ranks is
``table_mp.TableMPTrainStep``'s. One process is the mesh of one rank
(``parallel.mesh.one_rank``), over which the same code runs. On the card
the loss psums and the gradient all-reduce are the port's own cross-rank
kernel on peer memory (``parallel.ring.ring_all_reduce``), which takes no
host step, so the scan's CUDA graph holds a mesh's step too.
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
from avatarcraft_tpu_torch.ops.sampling import device_constant, recip
from avatarcraft_tpu_torch.parallel import ring
from avatarcraft_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    data_sharding,
    global_mean,
    global_ratio,
    one_rank,
    replicate,
    shard_batch,
    shard_draw,
)
from avatarcraft_tpu_torch.parallel.ring import all_gather_table
from avatarcraft_tpu_torch.parallel.table_mp import gathered_params, shard_grid_rows, trainable_shards
from avatarcraft_tpu_torch.utils.checkpoint import (
    adam_state_from_optax,
    leaves,
    load_train_state,
    map_leaves,
    save_train_state,
    set_lr,
    sorted_leaves,
)


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


def make_batch_ray_fn_ss(K: np.ndarray, H: int, W: int, ss: int):
    """The supersampled ray function: ss^2 sub-rays per pixel on a regular
    box pattern over its footprint, [B*ss^2, 3], sub-ray-major per pixel,
    so that ``rgb.reshape(B, ss*ss, 3).mean(1)`` is the pixel's box-filtered
    coverage (the JAX package's make_batch_ray_fn_ss)."""
    fx, fy, cx, cy = float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])
    off = (np.arange(ss) + 0.5) / ss - 0.5
    ox, oy = np.meshgrid(off, off, indexing="xy")
    ox = tuple(ox.reshape(-1).astype(np.float32).tolist())
    oy = tuple(oy.reshape(-1).astype(np.float32).tolist())

    def ray_fn(poses, view_idx, pix_idx):
        pose = poses[view_idx]
        dx = device_constant(ox, torch.float32, poses.device)
        dy = device_constant(oy, torch.float32, poses.device)
        y = torch.div(pix_idx, W, rounding_mode="floor").float()[:, None] + dy[None]
        x = (pix_idx % W).float()[:, None] + dx[None]
        p = torch.stack([(x - cx) * recip(fx), -((y - cy) * recip(fy)), -torch.ones_like(x)], dim=-1)
        v = p / torch.linalg.norm(p, dim=-1, keepdim=True)
        rays_d = torch.einsum("bij,bsj->bsi", pose[:, :3, :3], v)
        rays_o = pose[:, None, :3, 3].expand(rays_d.shape)
        return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)

    return ray_fn


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch's F.smooth_l1_loss with beta 1, mean reduction, written out as
    the JAX package writes it."""
    d = pred - target
    ad = d.abs()
    return torch.mean(torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5))


def smooth_l1_sum(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The sum of the terms whose mean ``smooth_l1`` takes."""
    d = pred - target
    ad = d.abs()
    return torch.sum(torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5))


def mesh_losses(out: dict, rgb: torch.Tensor, gt_rgb: torch.Tensor, mesh):
    """(photo, eikonal) of a rank's share of a global batch: smooth-L1's
    mean and the eikonal term's weighted mean over every rank's rays."""
    photo = global_mean(smooth_l1_sum(rgb, gt_rgb), gt_rgb.numel(), mesh)
    return photo, global_ratio(out["gradient_error_sum"], out["gradient_relax_sum"], mesh)


def cosine_decay(decay_steps: int):
    """optax.cosine_decay_schedule's factor with alpha 0: step -> 0.5 (1 +
    cos(pi min(step, decay_steps) / decay_steps))."""

    def factor(step: int) -> float:
        return 0.5 * (1.0 + math.cos(math.pi * min(step, decay_steps) / decay_steps))

    return factor


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule as a function of the step, in
    double: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine from ``peak_value`` to ``end_value``
    over the remaining ``decay_steps - warmup_steps`` (optax counts the
    warmup inside ``decay_steps``), ``end_value`` after it."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"warmup_cosine_decay: decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def lr(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - max(step, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        count = min(step - warmup_steps, cosine_steps)
        return peak_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * count / cosine_steps)) + alpha)

    return lr


class CosineSchedule:
    """The cosine learning rate of ``make_optimizer``'s Adam, stepped after
    each optimizer step as a ``LambdaLR`` is: after ``last_epoch`` steps the
    next update takes ``lr_at(last_epoch)``, so the first update uses
    lr(0), as optax's count does. A tensor learning rate (the card's
    capturable Adam) is written in place, so a captured step keeps reading
    the same tensor."""

    def __init__(self, optimizer, base_lr: float, decay_steps: int):
        self.optimizer, self.base_lr, self.factor = optimizer, base_lr, cosine_decay(decay_steps)
        self.last_epoch = 0
        set_lr(optimizer, self.lr_at(0))

    def lr_at(self, step: int) -> float:
        return self.base_lr * self.factor(step)

    def step(self) -> None:
        self.advance(1)

    def advance(self, n: int) -> list[float]:
        """The learning rates of the next n steps; the schedule moves past
        them."""
        lrs = [self.lr_at(self.last_epoch + i) for i in range(n)]
        self.last_epoch += n
        set_lr(self.optimizer, self.lr_at(self.last_epoch))
        return lrs


def make_optimizer(cfg: ReconstructConfig, steps_per_epoch: int, params):
    """(Adam, CosineSchedule) over the tensors ``params``: Adam(cfg.lr,
    betas (0.9, 0.99), eps 1e-15) with the learning rate on a cosine decay
    to 0 over ``cfg.epochs * steps_per_epoch`` steps. Step the schedule
    after each optimizer step. On the card Adam is capturable (its step
    count on the device) and its learning rate a device tensor, so that a
    CUDA graph can hold the update (``make_train_scan_fast``); its bias
    corrections are then f32 tensor math, where on the CPU they are Python
    floats."""
    params = list(params)
    on_card = params[0].device.type == "cuda"
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=params[0].device) if on_card else cfg.lr
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.99), eps=1e-15, capturable=on_card)
    return opt, CosineSchedule(opt, cfg.lr, max(cfg.epochs * steps_per_epoch, 1))


def _update(optimizer, scheduler) -> None:
    with record_function("train.optimizer"):
        optimizer.step()
        if scheduler is not None:
            scheduler.step()


def make_train_step(fcfg: FieldConfig, rcfg: RenderConfig, optimizer, ray_fn, eikonal_weight: float,
                    bg_value: float, scheduler=None, mesh=None):
    """The importance-sampled train step: step(params, poses, view_idx,
    pix_idx, gt_rgb, generator=None) -> (loss, (photo, eikonal)), detached.
    ``params`` is the tree of the leaves ``optimizer`` owns; the step
    updates them in place. With a ``mesh`` of ranks the batch is this
    rank's rows of the global one, the jitter its rows of one global draw
    from ``generator``, the loss the global batch's and the gradients
    summed over the ranks."""
    mesh = mesh if mesh is not None else one_rank()

    def train_step(params, poses, view_idx, pix_idx, gt_rgb, generator=None):
        optimizer.zero_grad(set_to_none=True)
        with record_function("train.forward"):
            rays_o, rays_d = ray_fn(poses, view_idx, pix_idx)
            jitter = (shard_draw(mesh, rays_o.shape[0], rcfg.num_steps, generator, rays_o.device)
                      if rcfg.perturb else None)
            out = render_rays(params, rays_o, rays_d, fcfg, rcfg, bg_value, generator, jitter=jitter)
            photo, eikonal = mesh_losses(out, out["rgb"], gt_rgb, mesh)
            loss = photo + eikonal_weight * eikonal
        with record_function("train.backward"):
            loss.backward()
            all_reduce_grads(leaves(params), mesh)
        _update(optimizer, scheduler)
        return loss.detach(), (photo.detach(), eikonal.detach())

    return train_step


def fast_loss(params: dict, rays_o, rays_d, gt_rgb, fcfg: FieldConfig, fast_cfg, grid, bg,
              eikonal_weight: float, packed: dict, mesh=None):
    """(loss, photo, eikonal) of the fast render: smooth-L1 photometric +
    eikonal_weight x eikonal, over the global batch of a ``mesh``'s ranks.
    ``packed``: materialize_field_tables of ``params``, built by the
    caller."""
    field = network_field_fns(params, fcfg, fast_cfg.bound, packed)
    out = render_rays_fast(params, rays_o, rays_d, fcfg, fast_cfg, grid, bg, field)
    photo, eikonal = mesh_losses(out, out["rgb"], gt_rgb, mesh if mesh is not None else one_rank())
    return photo + eikonal_weight * eikonal, photo, eikonal


def make_train_step_fast(fcfg: FieldConfig, fast_cfg, optimizer, ray_fn, eikonal_weight: float, splice,
                         scheduler=None, mesh=None):
    """The occupancy-guided train step: step(rest, shards, poses, view_idx,
    pix_idx, gt_rgb, grid, bg) -> (loss, (photo, eikonal)), detached.
    ``rest`` and ``shards`` come from ``trainable_shards`` (their leaves
    are what ``optimizer`` owns); the loss gathers the shards and splices
    the table in with ``splice``, and the step updates the leaves in
    place. With a ``mesh`` of ranks the batch is this rank's rows, the
    parameters (the table too) are replicated, as in the JAX package, and
    their gradients summed over the ranks."""
    mesh = mesh if mesh is not None else one_rank()

    def train_step(rest, shards, poses, view_idx, pix_idx, gt_rgb, grid, bg):
        optimizer.zero_grad(set_to_none=True)
        rays_o, rays_d = ray_fn(poses, view_idx, pix_idx)
        with record_function("train.gather"):
            params = splice(rest, all_gather_table(shards))
        with record_function("train.materialize"):
            packed = materialize_field_tables(params, fcfg)
        with record_function("train.forward"):
            loss, photo, gerr = fast_loss(
                params, rays_o, rays_d, gt_rgb, fcfg, fast_cfg, grid, bg, eikonal_weight, packed, mesh
            )
        with record_function("train.backward"):  # ends in reduce_scatter_rows
            loss.backward()
            all_reduce_grads(leaves(rest) + list(shards), mesh)
        _update(optimizer, scheduler)
        return loss.detach(), (photo.detach(), gerr.detach())

    return train_step


def draw_backgrounds(generator: torch.Generator | None, n: int, device) -> torch.Tensor:
    """The ``composite_random`` gray levels of n steps, one U(0, 1) per
    step, drawn on ``device`` from ``generator``: the numpy pixel order
    draws nothing for them, as in the JAX package's scan branch (its
    per-step branch draws one ``rng.uniform()`` a step)."""
    return torch.rand(n, generator=generator, device=device)


def graphed(device) -> bool:
    """Whether a scan on ``device`` replays a CUDA graph: on the card,
    always."""
    return torch.device(device).type == "cuda"


def capture_step(step, optimizer):
    """The card's CUDA graph of one train step: ``step()`` runs once eagerly
    on a side stream (a real step, which makes Adam's state, the BLAS
    handles and the cached constants that the capture reads) with every
    synchronising call an error (``torch.cuda.set_sync_debug_mode``), then
    is captured. Returns (graph, the K10 launches one replay makes). Raises
    if the step synchronises or the capture fails: nothing falls back to
    eager steps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    mode = torch.cuda.get_sync_debug_mode()
    with torch.cuda.stream(side):
        optimizer.zero_grad(set_to_none=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.current_stream().wait_stream(side)
    before = dict(ring.launches)
    graph = torch.cuda.CUDAGraph()
    optimizer.zero_grad(set_to_none=True)  # the capture's backward makes the static .grad tensors
    with torch.cuda.graph(graph):
        step()
    per_replay = {name: ring.launches[name] - before[name] for name in before}
    ring.launches.update(before)  # a capture records its launches and runs none
    return graph, per_replay


def _load_lr(optimizer, lrs: torch.Tensor, host_lrs: list, k: torch.Tensor) -> None:
    """The learning rate of step ``k`` (a [1] index) into every param
    group: copied on the device from ``lrs`` for a tensor learning rate
    (the card's, f32 as a filled one is), taken from ``host_lrs`` for a
    float one (the CPU's, in double as the schedule gives it)."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].copy_(lrs.index_select(0, k).reshape(()))
        else:
            group["lr"] = host_lrs[int(k)]


def make_train_scan_fast(fcfg: FieldConfig, fast_cfg, optimizer, ray_fn, eikonal_weight: float, bkg_mode: str,
                         white_bkg: bool, splice, ss: int = 1, graph: bool | None = None, mesh=None):
    """Several occupancy-guided train steps per call with the dataset on
    the device (the JAX package's make_train_scan_fast, a ``lax.scan``):
    scan(rest, shards, poses, images_flat, masks_flat, vis, pis, lrs, grid,
    generator) -> the n steps' losses [n]. ``vis``, ``pis``: the [n, B]
    (view, pixel) index blocks of n steps from the epoch's permutation;
    ``lrs``: their n learning rates; ``images_flat`` [V, H*W, 3] and
    ``masks_flat`` [V, H*W] (read in the ``composite*`` modes) on the
    device. Each step gathers its ground truth there, composited with the
    mask in the ``composite*`` modes on the white or black background, or on
    one gray level a step for ``composite_random`` (``draw_backgrounds``
    from ``generator``), renders through the gathered table (K10's
    all-gather; the backward ends in its reduce-scatter), box-filters the
    ss^2 sub-rays of a pixel (``make_batch_ray_fn_ss``) and takes Adam's
    step in place.

    On the card (``graph`` None or True) the first call runs its first
    step eagerly, then captures one step into a CUDA graph
    (``capture_step``), which every later step replays: the step reads its
    index blocks, learning rate and background from static buffers through
    a step counter on the device, and ``grid``, the parameters and the
    dataset from the tensors of the capture. A refresh therefore writes the
    grid in place, and a call with other tensors raises. Each replay adds
    the graph's launches to ``ring.launches``. ``graph=False``, and every
    call on the CPU, runs the same step eagerly (the plain version).

    With a ``mesh`` of ranks each rank takes its columns of the [n, B]
    index blocks and the step is ``make_train_step_fast``'s over the mesh;
    on the card its graph holds the loss psums and the gradient
    all-reduce (``ring.ring_all_reduce``: their buffers are made in the
    eager first step), and the cross-rank calls' error word is read after
    each call's replays."""
    mesh = mesh if mesh is not None else one_rank()
    composite = bkg_mode.startswith("composite")
    random_bg = bkg_mode == "composite_random"
    bg_value = 1.0 if white_bkg else 0.0
    st: dict = {}

    def step():
        k = st["k"]
        vi, pi = st["vis"].index_select(0, k)[0], st["pis"].index_select(0, k)[0]
        gt = st["images"][vi, pi]
        bg = st["bgs"].index_select(0, k).reshape(()) if random_bg else bg_value
        if composite:
            m = st["masks"][vi, pi][:, None]
            gt = gt * m + (1.0 - m) * bg
        rays_o, rays_d = ray_fn(st["poses"], vi, pi)
        params = splice(st["rest"], all_gather_table(st["shards"]))
        packed = materialize_field_tables(params, fcfg)
        field = network_field_fns(params, fcfg, fast_cfg.bound, packed)
        out = render_rays_fast(params, rays_o, rays_d, fcfg, fast_cfg, st["grid"], bg, field)
        rgb = out["rgb"]
        if ss > 1:
            rgb = rgb.reshape(-1, ss * ss, 3).mean(dim=1)
        photo, eikonal = mesh_losses(out, rgb, gt, mesh)
        loss = photo + eikonal_weight * eikonal
        loss.backward()
        all_reduce_grads(leaves(st["rest"]) + list(st["shards"]), mesh)
        _load_lr(optimizer, st["lrs"], st["host_lrs"], k)
        optimizer.step()
        st["losses"].index_copy_(0, k, loss.detach().reshape(1))
        k.add_(1)

    def scan(rest, shards, poses, images_flat, masks_flat, vis, pis, lrs, grid, generator=None):
        held = [poses, images_flat, masks_flat, grid, *shards, *leaves(rest)]
        n, device = len(vis), poses.device
        cols = data_sharding(mesh, np.shape(vis)[1])  # this rank's columns of the [n, B] blocks
        vis, pis = np.asarray(vis)[:, cols], np.asarray(pis)[:, cols]
        if not st:
            S, B = np.shape(vis)
            st.update(
                vis=torch.zeros((S, B), dtype=torch.int64, device=device),
                pis=torch.zeros((S, B), dtype=torch.int64, device=device),
                lrs=torch.zeros(S, dtype=torch.float32, device=device),
                bgs=torch.zeros(S, dtype=torch.float32, device=device),
                losses=torch.zeros(S, dtype=torch.float32, device=device),
                k=torch.zeros(1, dtype=torch.int64, device=device),
                rest=rest, shards=list(shards), poses=poses, images=images_flat, masks=masks_flat, grid=grid,
                held=[t.data_ptr() for t in held],
                graph=graphed(device) if graph is None else graph, replay=None,
            )
        elif [t.data_ptr() for t in held] != st["held"]:
            raise ValueError("make_train_scan_fast: a scan runs on the tensors of its first call (a CUDA graph "
                             "holds them); build a new scan for new parameters, grid or dataset")
        if n > st["vis"].shape[0]:
            raise ValueError(f"make_train_scan_fast: {n} steps in a call, at most {st['vis'].shape[0]}")
        st["vis"][:n].copy_(torch.as_tensor(np.asarray(vis)))
        st["pis"][:n].copy_(torch.as_tensor(np.asarray(pis)))
        st["lrs"][:n].copy_(torch.as_tensor(np.asarray(lrs, np.float32)))
        st["host_lrs"] = [float(v) for v in lrs]
        if random_bg:
            st["bgs"][:n].copy_(draw_backgrounds(generator, n, device))
        st["k"].zero_()
        first = 0
        if st["graph"] and st["replay"] is None:
            st["replay"] = capture_step(step, optimizer)
            first = 1  # capture_step took the call's first step
        for _ in range(first, n):
            if st["graph"]:
                cuda_graph, per_replay = st["replay"]
                cuda_graph.replay()
                ring.add_replayed(per_replay)
            else:
                optimizer.zero_grad(set_to_none=True)
                step()
        if mesh.distributed:
            ring.check_peer_error()
        return st["losses"][:n].clone()

    return scan


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


def adam_moments(optimizer, rest: dict, shards, splice) -> tuple[dict, dict, int]:
    """(mu, nu, count) of ``optimizer``'s Adam state over ``rest`` and the
    table ``shards`` (``trainable_shards``) in the parameters' layout, as
    ``save_train_state`` takes them: zeros for a tensor it has not stepped,
    the count that of the first stepped tensor (0 before any step)."""

    def moments(key):
        m = lambda p: optimizer.state[p][key] if p in optimizer.state else torch.zeros_like(p)  # noqa: E731
        with torch.no_grad():
            table = torch.cat([m(s) for s in shards])
        return splice(map_leaves(rest, m), table)

    stepped = [p for p in list(shards) + leaves(rest) if p in optimizer.state]
    count = int(optimizer.state[stepped[0]]["step"]) if stepped else 0
    return moments("exp_avg"), moments("exp_avg_sq"), count


def pixel_batches(n_views: int, n_pixels: int, batch: int, rng: np.random.Generator,
                  view_ids: np.ndarray | None = None) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """One epoch of (view_idx, pix_idx) batches over a shuffled permutation
    of every (view, pixel), the reference's per-epoch ray permutation
    (reconstruct.py:80-83); the last partial batch is dropped.
    ``view_ids``: the views to draw from (the others are held out)."""
    if view_ids is None:
        view_ids = np.arange(n_views, dtype=np.int32)
    view_ids = np.asarray(view_ids, np.int32)
    total = len(view_ids) * n_pixels
    perm = rng.permutation(total).astype(np.int64)
    for i in range(0, total - batch + 1, batch):
        sel = perm[i : i + batch]
        yield view_ids[sel // n_pixels], (sel % n_pixels).astype(np.int32)


@dataclasses.dataclass
class ReconstructState:
    """The 64+64 trainer's live state: the parameter tree (the leaves the
    optimizer owns), Adam with its cosine schedule, and the step."""

    params: dict
    optimizer: torch.optim.Optimizer
    scheduler: CosineSchedule
    step: int = 0


def _steps_per_epoch(dataset, cfg: ReconstructConfig) -> int:
    return dataset.n_images * dataset.H * dataset.W // cfg.batch_size


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _shard_batch_arrays(mesh, *arrays):
    """This rank's rows of each [B, ...] host array, on its device: integer
    arrays as int64 indices, the others as f32 (the JAX package's
    _shard_batch_arrays, a device_put of each with data_sharding)."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        a = a.astype(np.int64) if np.issubdtype(a.dtype, np.integer) else a.astype(np.float32)
        out.append(shard_batch(mesh, a))
    return tuple(out)


def setup(dataset, fcfg: FieldConfig, rcfg: RenderConfig, cfg: ReconstructConfig, device="cuda", mesh=None):
    """What the 64+64 loop needs, on ``device`` (``mesh.device`` with a
    mesh): (state, step_fn, poses, steps_per_epoch). The field starts from
    ``init_field_params`` seeded ``cfg.seed`` (broadcast from rank 0 over a
    mesh); Adam on the cosine over the epochs; the step renders on a white
    (``cfg.white_bkg``) or black background against the raw images, as the
    JAX package's step does, over ``mesh``'s ranks when given."""
    mesh = mesh if mesh is not None else one_rank(device)
    params = init_field_params(torch.Generator(mesh.device).manual_seed(cfg.seed), fcfg)
    params = map_leaves(replicate(mesh, params), lambda t: t.requires_grad_())
    steps_per_epoch = _steps_per_epoch(dataset, cfg)
    opt, sched = make_optimizer(cfg, steps_per_epoch, leaves(params))
    ray_fn = make_batch_ray_fn(dataset.K, dataset.H, dataset.W)
    step_fn = make_train_step(fcfg, rcfg, opt, ray_fn, cfg.eikonal_weight, 1.0 if cfg.white_bkg else 0.0, sched,
                              mesh)
    poses = torch.as_tensor(np.asarray(dataset.poses, np.float32), device=mesh.device)
    return ReconstructState(params, opt, sched), step_fn, poses, steps_per_epoch


def train(
    dataset,
    fcfg: FieldConfig,
    rcfg: RenderConfig,
    cfg: ReconstructConfig,
    *,
    max_steps: int | None = None,
    log_every: int = 20,
    callbacks: dict | None = None,
    resume_from: str | None = None,
    device="cuda",
    mesh=None,
) -> tuple[dict, dict]:
    """The 64+64 reconstruction loop on ``device``. Returns (params, stats):
    the logged (step, loss) pairs, rays/s and steps/s (timed from the end
    of step 0) and the step count.

    ``callbacks``: {"on_step": fn(step, params, loss)}, called after every
    step; ``params`` is a function returning the live parameter tree.
    ``resume_from``: a train-state file whose parameters and Adam state
    (moments and count, so the learning rate resumes on its cosine) replace
    the initial ones; the step count and the pixel order start again from
    0, as in the JAX package. The perturbed depths come from a
    ``torch.Generator`` seeded ``cfg.seed``, where the JAX package splits
    keys. ``mesh``: the ranks of a data-parallel run (each renders its rows
    of every batch; ``device`` is then the rank's)."""
    mesh = mesh if mesh is not None else one_rank(device)
    device = mesh.device
    state, step_fn, poses, _ = setup(dataset, fcfg, rcfg, cfg, device, mesh)
    params = state.params
    if resume_from is not None:
        saved = load_train_state(resume_from, device)
        # leaves paired in sorted-key order: a state carried from the JAX
        # package has its dicts' keys sorted
        with torch.no_grad():
            for p, v in zip(sorted_leaves(params), sorted_leaves(saved["params"])):
                p.copy_(v)
        adam_state_from_optax(state.optimizer, sorted_leaves(params), sorted_leaves(saved["mu"]),
                              sorted_leaves(saved["nu"]), saved["count"], state.scheduler)
    generator = torch.Generator(device).manual_seed(cfg.seed)
    rng = np.random.default_rng(cfg.seed)
    n_pix = dataset.H * dataset.W
    logged, step, t_start, done = [], 0, None, False
    for _ in range(cfg.epochs):
        if done:
            break
        for view_idx, pix_idx in pixel_batches(dataset.n_images, n_pix, cfg.batch_size, rng):
            gt = dataset.gather_rgb(view_idx, pix_idx)
            batch = _shard_batch_arrays(mesh, view_idx, pix_idx, gt)
            loss, _ = step_fn(params, poses, *batch, generator)
            if step == 0:  # time from the end of the first step
                _sync(device)
                t_start = time.perf_counter()
            if log_every and step % log_every == 0:
                logged.append((step, loss))  # read once, after the loop
            if callbacks and "on_step" in callbacks:
                callbacks["on_step"](step, lambda: params, loss)
            step += 1
            if max_steps is not None and step >= max_steps:
                done = True
                break
    _sync(device)
    stats = {"losses": [(s, float(l)) for s, l in logged], "rays_per_sec": 0.0, "steps": step}
    if t_start is not None and step > 1:
        dt = time.perf_counter() - t_start
        stats["rays_per_sec"] = (step - 1) * cfg.batch_size / dt
        stats["steps_per_sec"] = (step - 1) / dt
    return map_leaves(params, torch.Tensor.detach), stats


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
    callbacks: dict | None = None,
    view_ids: np.ndarray | None = None,
    state_dir: str | None = None,
    save_state_every: int = 0,
    resume_from: str | None = None,
    scan_steps: int = 0,
    device="cuda",
    mesh=None,
) -> tuple[dict, torch.Tensor, dict]:
    """Occupancy-guided reconstruction on ``device``: the density grid
    starts fully occupied (uniform sampling) and sparsifies through periodic
    refreshes as the field converges. ``dataset``: an ``SMPLMultiviewDataset``,
    an ``ImageSet`` or any object with their attributes. Returns (params,
    density grid, stats); stats holds the logged (step, loss) pairs, rays/s
    and steps/s (timed from the end of the first step) and the step count.

    ``callbacks``: {"on_step": fn(step, params, loss, grid)} after every
    step and its refresh, with the live grid; ``params`` is a function that
    gathers the live parameter tree when called (one gather launch).
    ``view_ids``: the views to train on. ``state_dir``: where the train
    state goes, as the orbax directories ``state_latest`` every
    ``save_state_every`` steps and ``state_final`` at the end, the JAX
    package's names and layout. ``resume_from``: a train state to continue
    from (such a directory, either package's, or a port ``.pt`` file:
    parameters, Adam's moments and count, grid, step); the
    epoch loop and the pixel order restart from the seed, as in the JAX
    package.

    ``scan_steps`` > 0 runs that many steps per call of
    ``make_train_scan_fast`` (the JAX package's scan branch,
    reconstruct.py:391-413, 480-546): the dataset lives on the device, the
    epoch's permutation is cut into [scan_steps, B] index blocks, and a
    last partial block runs when ``max_steps`` falls inside one. The grid
    refresh, state saves, logging and ``on_step`` happen at the end of a
    call, after the steps whose boundaries it crossed (pick divisors of
    ``grid_update_every`` and ``save_state_every``); ``on_step`` then gets
    the step count after the call, as the JAX package passes it; the
    logged loss is a call's last; the rates are timed from the end of the
    first call (it holds the capture of the card's CUDA graph). The
    ``composite_random`` backgrounds come from a ``torch.Generator`` seeded
    ``cfg.seed``, one a step, and the numpy pixel order draws nothing for
    them (its per-step branch draws one ``rng.uniform()`` a step).

    ``mesh``: the ranks of a data-parallel run (``device`` is then the
    rank's): each rank renders its rows of every batch and holds a replica
    of every parameter (the table too) and of Adam's state, as the JAX
    package's train_fast does; rank 0 alone writes the state files.
    ``scan_steps`` > 0 over a mesh replays each rank's graph of the step
    on the card, as in one process."""
    mesh = mesh if mesh is not None else one_rank(device)
    device = mesh.device
    saved = load_train_state(resume_from, device) if resume_from is not None else None
    if saved is not None:
        params = saved["params"]
    else:
        params = init_field_params(torch.Generator(device).manual_seed(cfg.seed), fcfg)
    rest, shards, splice = trainable_shards(replicate(mesh, params))
    del params
    opt, sched = make_optimizer(cfg, _steps_per_epoch(dataset, cfg), leaves(rest) + shards)
    ray_fn = make_batch_ray_fn(dataset.K, dataset.H, dataset.W)
    if scan_steps > 0:
        scan = make_train_scan_fast(fcfg, fast_cfg, opt, ray_fn, cfg.eikonal_weight, cfg.bkg_mode, cfg.white_bkg,
                                    splice, mesh=mesh)
        images_flat = torch.as_tensor(
            np.asarray(dataset.images, np.float32).reshape(dataset.n_images, -1, 3), device=device)
        if cfg.bkg_mode.startswith("composite"):
            masks_flat = torch.as_tensor(np.asarray(dataset.masks, np.float32).reshape(dataset.n_images, -1),
                                         device=device)
        else:  # never read
            masks_flat = torch.zeros((1, 1), device=device)
        generator = torch.Generator(device).manual_seed(cfg.seed)
    else:
        step_fn = make_train_step_fast(fcfg, fast_cfg, opt, ray_fn, cfg.eikonal_weight, splice, sched, mesh)
    refresh = make_grid_update_fn(fcfg, fast_cfg.bound)
    grid = torch.full((grid_resolution,) * 3, 100.0, device=device)  # fully occupied at start
    poses = torch.as_tensor(np.asarray(dataset.poses, np.float32), device=device)
    step = 0
    if saved is not None:
        moments = {}
        for key in ("mu", "nu"):
            m_rest, m_shards, _ = shard_grid_rows(saved[key])
            moments[key] = sorted_leaves(m_rest) + m_shards
        adam_state_from_optax(opt, sorted_leaves(rest) + shards, moments["mu"], moments["nu"], saved["count"], sched)
        grid, step = saved["grid"], int(saved["step"])

    def save_state(name: str, params: dict | None = None) -> None:
        if params is None:
            params = gathered_params(rest, shards, splice)
        mu, nu, count = adam_moments(opt, rest, shards, splice)
        if mesh.rank == 0:
            save_train_state(f"{state_dir}/{name}", params, mu, nu, count, step, grid)

    def maybe_refresh(prev_step: int) -> None:
        """The grid refreshed in place (a captured step reads it) when the
        steps (prev_step, step] crossed a refresh boundary."""
        if not grid_update_every or step // grid_update_every <= prev_step // grid_update_every or step <= 0:
            return
        if step < grid_warmup_steps:
            return  # warmup: keep the saturated grid (uniform sampling)
        if step < grid_warmup_steps + grid_update_every:
            # first real refresh: drop the saturated floor (an EMA-max from
            # 100 would take ~45 refreshes to fall below the threshold)
            grid.copy_(refresh(gathered_params(rest, shards, splice), torch.zeros_like(grid)))
        else:
            grid.copy_(refresh(gathered_params(rest, shards, splice), grid))

    rng = np.random.default_rng(cfg.seed)
    n_pix = dataset.H * dataset.W
    logged, t_start, timed_from, done = [], None, 0, False
    buf: list[tuple[np.ndarray, np.ndarray]] = []

    def flush() -> None:
        nonlocal step, t_start, timed_from
        if not buf:
            return
        vis, pis = np.stack([v for v, _ in buf]), np.stack([p for _, p in buf])
        n_chunk = len(buf)
        buf.clear()
        lrs = sched.advance(n_chunk) if sched is not None else [float(opt.param_groups[0]["lr"])] * n_chunk
        losses = scan(rest, shards, poses, images_flat, masks_flat, vis, pis, lrs, grid, generator)
        prev = step
        step += n_chunk
        if t_start is None:  # time from the end of the first call (it holds the capture)
            _sync(device)
            t_start, timed_from = time.perf_counter(), step
        if log_every:
            logged.append((step, losses[-1]))  # read once, after the loop
        maybe_refresh(prev)
        if callbacks and "on_step" in callbacks:
            callbacks["on_step"](step, lambda: gathered_params(rest, shards, splice), losses[-1], grid)
        if state_dir and save_state_every and step // save_state_every > prev // save_state_every:
            save_state("state_latest")

    for _ in range(cfg.epochs if scan_steps > 0 else 0):
        if done:
            break
        for view_idx, pix_idx in pixel_batches(dataset.n_images, n_pix, cfg.batch_size, rng, view_ids):
            buf.append((view_idx, pix_idx))
            if max_steps is not None and step + len(buf) >= max_steps:
                flush()  # the partial tail
                done = True
                break
            if len(buf) == scan_steps:
                flush()
    flush()

    for _ in range(cfg.epochs if scan_steps == 0 else 0):
        if done:
            break
        for view_idx, pix_idx in pixel_batches(dataset.n_images, n_pix, cfg.batch_size, rng, view_ids):
            gt = dataset.gather_rgb(view_idx, pix_idx)
            bg = 1.0 if cfg.white_bkg else 0.0
            if cfg.bkg_mode.startswith("composite"):
                if cfg.bkg_mode == "composite_random":
                    bg = float(rng.uniform())
                m = dataset.gather_mask(view_idx, pix_idx)[:, None]
                gt = gt * m + (1.0 - m) * bg
            batch = _shard_batch_arrays(mesh, view_idx, pix_idx, gt)
            loss, _ = step_fn(rest, shards, poses, *batch, grid, bg)
            if t_start is None:  # time from the end of the first step
                _sync(device)
                t_start, timed_from = time.perf_counter(), step + 1
            if log_every and step % log_every == 0:
                logged.append((step, loss))  # read once, after the loop
            step += 1
            maybe_refresh(step - 1)
            if callbacks and "on_step" in callbacks:
                callbacks["on_step"](step - 1, lambda: gathered_params(rest, shards, splice), loss, grid)
            if state_dir and save_state_every and step % save_state_every == 0:
                save_state("state_latest")
            if max_steps is not None and step >= max_steps:
                done = True
                break

    params = gathered_params(rest, shards, splice)
    if state_dir:
        save_state("state_final", params)
    _sync(device)
    stats = {"losses": [(s, float(l)) for s, l in logged], "rays_per_sec": 0.0, "steps": step}
    if t_start is not None and step > timed_from:
        dt = time.perf_counter() - t_start
        stats["rays_per_sec"] = (step - timed_from) * cfg.batch_size / dt
        stats["steps_per_sec"] = (step - timed_from) / dt
    return params, grid, stats
