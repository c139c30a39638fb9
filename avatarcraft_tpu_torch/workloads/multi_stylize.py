"""Multi-prompt avatar creation: P style fields trained against P prompts
in one run, on one shared view per step. Port of the JAX package's
workloads/multi_stylize.py (``stack_params``, ``unstack_params``,
``MultiPromptTrainer``, ``_phaseB_grads_fast``), both samplers; the
parity phase B of each prompt is the single-prompt trainer's
``make_phaseB_step`` (the JAX package's ``_phaseB_grads``).

The JAX package vmaps every phase over the stacked prompt axis. Here the
field phases loop over the prompts, each with the single-prompt trainer's
pieces (workloads/stylize.py): its own row-sharded table (gathered once per
step through ``all_gather_rows``, its lookup tables packed in f32), its own
density grid (fast), phase A, and phase B with one backward through the packing
(``reduce_scatter_rows``): P gathers and P reduce-scatters per step. The
table kernels are bound with ctypes, which ``torch.func.vmap`` cannot pass
through. Only the guidance is batched: one encode, one UNet call of 2P
latents and one pullback (``SDSGuidance.sds_image_grad_batch``). One Adam
over every prompt's leaves equals ``optax.adam`` on the stacked tree: its
update is elementwise and its step count shared.

The view schedule (poses, view order, stride offsets, background keys)
draws from one numpy generator in the JAX package's order; the noise
backgrounds, SDS's t and noise and the parity sampler's stratified jitter
(prompt by prompt: phase A's calls, then each prompt's patches) from one
torch generator.

Profiler ranges: ``multi.gather``, ``multi.phaseA``, ``multi.vae``,
``multi.sds``, ``multi.vae`` again (the pullback), ``multi.phaseB`` and
``multi.refresh`` (fast), as the single-prompt trainer names ``stylize.*``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from avatarcraft_tpu_torch.cameras import pose2rays, sparse_ray_sampling, style_360_path
from avatarcraft_tpu_torch.constants import (
    BLACK_BKG,
    CAN_HEAD_CAMERA_DIST,
    CAN_HEAD_OFFSET,
    CANONICAL_CAMERA_DIST_TRAIN,
    NOISE_BKG,
    NSR_BOUND,
    WHITE_BKG,
)
from avatarcraft_tpu_torch.models.diffusion import SDSGuidance
from avatarcraft_tpu_torch.models.instant_nsr import FastRenderConfig, FieldConfig, RenderConfig, table_dtype
from avatarcraft_tpu_torch.ops.occupancy import prune_grid_floaters
from avatarcraft_tpu_torch.parallel.table_mp import gathered_params, trainable_shards
from avatarcraft_tpu_torch.utils.background import select_background
from avatarcraft_tpu_torch.utils.checkpoint import leaves, map_leaves
from avatarcraft_tpu_torch.workloads.reconstruct import make_grid_update_fn
from avatarcraft_tpu_torch.workloads.stylize import (
    SAMPLERS,
    StylizeConfig,
    backward_through_packing,
    cast_tables,
    epoch_poses,
    frozen_ground_truth,
    gather_packed,
    make_optimizer,
    make_phaseA_render,
    make_phaseA_render_fast,
    make_phaseB_step,
    make_phaseB_step_fast,
    view_rays,
    worst_chunk_count,
)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(list(trees))


def stack_params(params_list: list[dict]) -> dict:
    """P parameter trees of one layout -> one tree of [P, ...] leaves."""
    return _stack(params_list)


def unstack_params(stacked: dict, n: int) -> list[dict]:
    """A tree of [n, ...] leaves -> n trees (views of its leaves)."""
    return [map_leaves(stacked, lambda x, i=i: x[i]) for i in range(n)]


def _phaseB_grads_fast(fcfg: FieldConfig, fast_cfg: FastRenderConfig, cfg: StylizeConfig):
    """step(params, tables, gt, rays_o, rays_d, g_rgb, bg, grid) -> one
    prompt's summed phase-B loss, its gradients added into the .grad of
    ``params``' MLP and variance leaves and of ``tables``: the
    single-prompt trainer's phase B with the config's weights (the JAX
    package's _phaseB_grads_fast, vmapped there over the prompts)."""
    return make_phaseB_step_fast(fcfg, fast_cfg, cfg.w_eikonal, cfg.use_opacity, cfg.batch_size, cfg.w_opacity)


@dataclasses.dataclass
class MultiPromptTrainer:
    """Train P style fields against P prompts together, on the device of
    ``params_style``.

    ``params_style``: the P fields stacked [P, ...] (``stack_params``);
    ``params_gt``: the shared frozen canonical field of the opacity loss.
    ``cfg.sampler`` "parity" renders through ``rcfg`` (64+64, stratified
    jitter, fd7), as the single-prompt trainer does. "fast": ``grids`` is
    each prompt's density grid [P, R, R, R] (a resumed run's saved grids;
    when None, each field's grid refreshed from zeros at 129^3), refreshed
    and pruned every ``cfg.grid_update_every`` steps; ``fast_cfg``: the
    fast render's settings (``derive_budget`` sizes its sample budget)."""

    cfg: StylizeConfig
    fcfg: FieldConfig
    guidance: SDSGuidance
    prompts: list[str]
    params_style: dict
    params_gt: dict
    grids: torch.Tensor | None = None
    fast_cfg: FastRenderConfig | None = None

    def __post_init__(self):
        c = self.cfg
        if c.sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {c.sampler!r} (one of {', '.join(SAMPLERS)})")
        self.fast = c.sampler == "fast"
        self.P = len(self.prompts)
        # per prompt (rest, shards, splice); the trainer's copy is these: params_list()
        self.fields = [trainable_shards(p) for p in unstack_params(self.params_style, self.P)]
        self.params_style = None
        self.device = self.fields[0][1][0].device
        self.opt = make_optimizer(c.lr, [t for rest, shards, _ in self.fields for t in leaves(rest) + shards])
        self.rng = np.random.default_rng(c.seed)
        self.generator = torch.Generator(self.device).manual_seed(c.seed)
        self.rcfg = RenderConfig(num_steps=64, upsample_steps=64, bound=NSR_BOUND, perturb=True)
        if self.fast and self.fast_cfg is None:
            self.fast_cfg = FastRenderConfig(bound=NSR_BOUND)
        self._phaseA = {}
        self._phaseB = self._make_phaseB()
        with record_function("multi.gather"):
            self.gt = frozen_ground_truth(self.params_gt, self.fcfg, NSR_BOUND)
        self.params_gt = self.gt[0]
        if self.fast:
            self._refresh_grid = make_grid_update_fn(self.fcfg, NSR_BOUND)
            if self.grids is None:
                # one grid per prompt field (geometry diverges under styling)
                zeros = torch.zeros((129,) * 3, device=self.device)
                self.grids = torch.stack([self._refresh_grid(p, zeros) for p in self.params_list()])
        self._step_count = 0
        # [P, 2, L, D] embeddings per view description
        self._text_cache: dict[str, torch.Tensor] = {}
        self.text_embs = self.text_embeddings("")
        self.stats = {"refreshes": 0, "clip_guard_trips": 0}

    def _make_phaseB(self):
        c = self.cfg
        if self.fast:
            return _phaseB_grads_fast(self.fcfg, self.fast_cfg, c)
        return make_phaseB_step(self.fcfg, self.rcfg, c.w_eikonal, c.use_opacity, c.batch_size, c.w_opacity,
                                self.generator)

    def _grid(self, p: int) -> tuple:
        """The fast phases' density grid argument of prompt p (the parity
        phases take none: their jitter generator is bound when they are
        built)."""
        return (self.grids[p],) if self.fast else ()

    def params_list(self) -> list[dict]:
        """The P current parameter trees (detached, each table gathered)."""
        return [gathered_params(rest, shards, splice) for rest, shards, splice in self.fields]

    def text_embeddings(self, desc: str) -> torch.Tensor:
        """[P, 2, L, D] CFG pairs of the (view-prefixed) prompts, the
        reference's view-dependent prompt augmentation (reference:
        stylize.py:84-91) applied to every prompt."""
        if desc not in self._text_cache:
            c = self.cfg
            self._text_cache[desc] = torch.stack([
                self.guidance.get_text_embeds([f"{desc} {p}" if (desc and c.augment_text) else p])
                for p in self.prompts
            ])
        return self._text_cache[desc]

    def epoch_poses(self, epoch: int):
        return epoch_poses(self.cfg, self.rng, epoch)

    # -- the sample budget ----------------------------------------------------
    def derive_budget(self, n_poses: int = 20, safety: float = 1.1) -> int:
        """The compaction budget from the schedule's own pose distribution
        against every prompt's grid: the worst probe-selected count per
        batch_size-ray chunk over both stride layouts (coarse and fine),
        times ``safety``. Sets it into ``fast_cfg`` and returns it. The
        poses' jitter keeps the JAX package's noise_scale of 1.0 (its
        ``train`` draws at 2.0)."""
        c = self.cfg
        rng = np.random.default_rng(c.seed + 1)
        poses, _ = style_360_path(
            np.zeros(3), np.array([0.0, 1.0, 0.0]), CANONICAL_CAMERA_DIST_TRAIN,
            n_poses, add_noise=c.augment_cam, style_head=c.stylize_head,
            head_offset=CAN_HEAD_OFFSET, head_rate=0.5,
            head_dist=CAN_HEAD_CAMERA_DIST, rng=rng,
        )
        worst = 0
        for pose in poses:
            # the JAX package's set, iterated in its order (the offsets draw from rng)
            for stride in {c.subsample_scale, 1}:
                ro, rd = pose2rays(c.H, c.W, pose, device=self.device)
                ro, rd = sparse_ray_sampling(ro.reshape(c.H, c.W, 3), rd.reshape(c.H, c.W, 3), stride, rng)
                worst = max(worst, self._worst_chunk_count(ro.reshape(-1, 3), rd.reshape(-1, 3)))
        budget = int(worst * safety)
        self.set_budget(budget)
        return budget

    def _worst_chunk_count(self, rays_o, rays_d) -> int:
        return worst_chunk_count(rays_o, rays_d, self.cfg.batch_size, self.fast_cfg, self.grids)

    def set_budget(self, budget: int) -> None:
        """Set the sample budget (0 = compaction off) and rebuild the
        phases that read it."""
        self.fast_cfg = dataclasses.replace(self.fast_cfg, sample_budget=budget)
        self._phaseA = {}
        self._phaseB = self._make_phaseB()

    def _budget_clip_guard(self, rays_o, rays_d):
        """After a grid refresh, count the current view against every
        prompt's live grid; if any chunk would clip, turn compaction off
        (the single-prompt trainer's rule)."""
        if not self.fast_cfg.sample_budget:
            return
        worst = self._worst_chunk_count(rays_o, rays_d)
        if worst > self.fast_cfg.sample_budget:
            print(
                f"[multi] CLIP GUARD: refresh at step {self._step_count} "
                f"selects {worst} > budget {self.fast_cfg.sample_budget}; "
                f"disabling compaction",
                flush=True,
            )
            self.set_budget(0)
            self.stats["clip_guard_trips"] += 1

    # -- one view = one optimizer step for every prompt -------------------------
    def train_view(self, pose: np.ndarray, desc: str, epoch: int) -> torch.Tensor:
        """One SDS step of every prompt's field on one shared view; returns
        the P summed phase-B losses [P] (detached, on the device)."""
        c = self.cfg
        rays_o, rays_d, th, tw = view_rays(c, self.rng, pose, epoch, self.device)
        n_rays = th * tw
        # background augmentation, one for every prompt (reference:
        # stylize.py:59-66 random white/black/noise backgrounds)
        bkg_key = (
            int(self.rng.integers(WHITE_BKG, NOISE_BKG + 1))
            if c.augment_bkg
            else (WHITE_BKG if c.white_bkg else BLACK_BKG)
        )
        bg = select_background(n_rays, bkg_key, self.generator, self.device)
        text_embs = self.text_embeddings(desc)
        chunk = min(c.batch_size, n_rays)
        if chunk != c.batch_size:
            raise ValueError(f"a {th}x{tw} frame is smaller than one {c.batch_size}-ray patch")
        if chunk not in self._phaseA:
            self._phaseA[chunk] = (make_phaseA_render_fast(self.fcfg, self.fast_cfg, chunk) if self.fast
                                   else make_phaseA_render(self.fcfg, self.rcfg, chunk, self.generator))
        dtype = table_dtype(self.fcfg)

        self.opt.zero_grad(set_to_none=True)
        steps, rgbs, depths = [], [], []
        for p, (rest, shards, splice) in enumerate(self.fields):
            with record_function("multi.gather"):  # all_gather_rows
                steps.append(gather_packed(rest, shards, splice, self.fcfg))
            params, _, tables = steps[-1]
            with record_function("multi.phaseA"), torch.no_grad():
                rgb, depth = self._phaseA[chunk](params, rays_o, rays_d, bg, *self._grid(p),
                                                 packed=cast_tables(tables, dtype))
            rgbs.append(rgb)
            depths.append(depth)
        imgs = torch.stack(rgbs).reshape(self.P, th, tw, 3).permute(0, 3, 1, 2)
        # SD 2.0-depth conditions the UNet on each frame's depth
        pred_depth = torch.stack(depths).reshape(self.P, 1, th, tw) if self.guidance.m.use_depth else None
        g_imgs = self.guidance.sds_image_grad_batch(text_embs, imgs, c.guidance_scale, pred_depth=pred_depth,
                                                    generator=self.generator,
                                                    scope=lambda part: record_function("multi." + part))
        g_rgb = g_imgs.permute(0, 2, 3, 1).reshape(self.P, -1, 3)

        losses = []
        with record_function("multi.phaseB"):
            for p in range(self.P):
                # each prompt's packed tables are let go after its backward
                params, packed32, tables = steps[p]
                steps[p] = None
                losses.append(self._phaseB(params, tables, self.gt, rays_o, rays_d, g_rgb[p], bg, *self._grid(p)))
                backward_through_packing(packed32, tables)
                del params, packed32, tables
            self.opt.step()
        self._step_count += 1
        if self.fast and c.grid_update_every and self._step_count % c.grid_update_every == 0:
            with record_function("multi.refresh"):
                self.refresh_grids()
                self._budget_clip_guard(rays_o, rays_d)
        return torch.stack(losses)

    def refresh_grids(self) -> None:
        """Each prompt's grid refreshed from its field and, with
        ``prune_floaters``, pruned against its previous grid."""
        new = []
        for p, params in enumerate(self.params_list()):
            grid = self._refresh_grid(params, self.grids[p])
            if self.cfg.prune_floaters:
                grid = prune_grid_floaters(grid, self.grids[p])
            new.append(grid)
        self.grids = torch.stack(new)
        self.stats["refreshes"] += 1

    def train(self, max_steps: int | None = None, on_step: Callable | None = None) -> int:
        """The coarse-to-fine schedule, one shared view per step.
        ``on_step(step, trainer)`` runs after each step with the 1-based
        count of steps taken (the JAX trainer counts before its call).
        Returns the number of steps."""
        c = self.cfg
        step = 0
        for epoch in range(c.coarse_epochs + c.fine_epochs):
            poses, descs = self.epoch_poses(epoch)
            for i in self.rng.permutation(len(poses)):
                self.train_view(poses[i], descs[i], epoch)
                step += 1
                if on_step is not None:
                    on_step(step, self)
                if max_steps is not None and step >= max_steps:
                    return step
        return step
