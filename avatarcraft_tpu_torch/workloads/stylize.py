"""SDS avatar stylization: port of the JAX package's workloads/stylize.py
(``StylizeConfig``, ``make_phaseA_render``, ``make_phaseB_step``,
``make_phaseA_render_fast``, ``make_phaseB_step_fast``, ``StylizeTrainer``;
reference: stylize.py:31-217). Two samplers: "parity" (the JAX package's
default: the 64+64 importance render with jittered stratified samples and
fd7 normals, ``rcfg``) and "fast" (the occupancy-guided K-sample render
against a density grid that the trainer refreshes, prunes and
clip-guards). The NeRF-Art two-phase structure stays:

* **Phase A** (no gradients): render the full (subsampled) frame through the
  style field, then the SDS image-space gradient (``SDSGuidance``).
* **Phase B**: re-render the frame in ``batch_size``-ray patches; each
  patch's loss is <rgb, g> (``rgb.backward(gradient=g)``, reference:
  stylize.py:163) + w_eikonal x eikonal + w_opacity x smooth_l1(opacity,
  opacity of the frozen ground-truth field), the regularizers scaled by
  chunk/4096 (the reference's 4096-ray patches). The patches' gradients
  accumulate into one Adam step.

The camera, background and prompt schedule draws from a
``numpy.random.Generator`` in the JAX package's order, so one seed gives the
same poses, head boxes, view order, backgrounds and stride offsets. SDS's t
and noise, the noise backgrounds and the parity sampler's stratified
jitter draw from a ``torch.Generator`` (``draw_jitter``: one draw per
render call of phase A and one per phase-B patch, which the patch's
styled render and its ground-truth render share, as the JAX package passes
one key to both).

The finest grid stays row-sharded (``parallel/table_mp.py``), as in the
fast reconstruction trainer: once per SDS step the shards are gathered
(``all_gather_rows``) and the field's lookup tables packed in f32; phase A
reads them detached, and every phase-B patch backpropagates into a detached
copy of them (cast to the field's table dtype per patch, so each patch's
table cotangent is rounded as the JAX package rounds it, and the patches add
in f32); a hash-grid field's detached copies include the table itself, which
its hashed levels read. One backward through the packing then carries the step's table
gradient to the rest of the tree and, through ``reduce_scatter_rows``, to
the shards: one gather and one reduce-scatter per step. The frozen
ground-truth field is gathered and packed once, at setup.

Profiler ranges: ``stylize.gather``, ``stylize.phaseA``, ``stylize.vae``
(the resize and the encode), ``stylize.sds`` (the UNet's classifier-free
pair and the guided gradient), ``stylize.vae`` again (the encode's
pullback), ``stylize.phaseB`` (the patches, the packing's backward and
Adam) and ``stylize.refresh`` (grid refresh, floater pruning, clip guard;
the fast sampler only).
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
from avatarcraft_tpu_torch.models.instant_nsr import (
    FastRenderConfig,
    FieldConfig,
    RenderConfig,
    count_fast_samples,
    materialize_field_tables,
    network_field_fns,
    render_rays,
    render_rays_fast,
    table_dtype,
)
from avatarcraft_tpu_torch.ops.occupancy import prune_grid_floaters
from avatarcraft_tpu_torch.parallel.ring import all_gather_table
from avatarcraft_tpu_torch.parallel.table_mp import gathered_params, shard_grid_rows, trainable_shards
from avatarcraft_tpu_torch.utils.background import select_background
from avatarcraft_tpu_torch.utils.checkpoint import leaves, map_leaves
from avatarcraft_tpu_torch.workloads.reconstruct import make_grid_update_fn, smooth_l1

SAMPLERS = ("parity", "fast")


@dataclasses.dataclass(frozen=True)
class StylizeConfig:
    tgt_text: str = "zombie"
    guidance_scale: float = 100.0
    coarse_epochs: int = 40
    fine_epochs: int = 20
    n_cap: int = 100  # views per epoch (reference: stylize.py:318)
    H: int = 256
    W: int = 256
    subsample_scale: int = 4  # coarse-stage stride (reference: stylize.py:98-106)
    batch_size: int = 4096  # rays per patch (reference: stylize.py:397)
    lr: float = 5e-3
    w_eikonal: float = 0.01
    w_opacity: float = 1e5  # reference: stylize.py:193 (smooth_l1 * 1e5)
    use_opacity: bool = True
    stylize_head: bool = True
    coarse_head: float = 0.2
    fine_head: float = 0.5
    augment_bkg: bool = True
    augment_cam: bool = True
    augment_text: bool = True
    white_bkg: bool = True
    seed: int = 42
    # "parity" = the reference 64+64 importance pipeline; "fast" =
    # occupancy-guided K-sample rendering against a density grid, refreshed
    # during training since SDS reshapes the geometry
    sampler: str = "parity"
    grid_update_every: int = 200  # fast sampler only
    # at every grid refresh keep only the occupied components connected to
    # the previous grid's occupancy (ops/occupancy.prune_grid_floaters)
    prune_floaters: bool = True


def cast_tables(packed: dict, dtype: torch.dtype) -> dict:
    """The packed lookup tables cast to ``dtype`` (the field's table dtype)."""
    return map_leaves(packed, lambda t: t.to(dtype))


def table_field(params: dict, tables: dict, fcfg: FieldConfig, bound: float):
    """(params, FieldFns) of a field that reads its lookup tables from
    ``tables`` (f32 leaves, cast here to the field's table dtype): a
    hash-grid field's table too, which ``params`` then carries."""
    tables = cast_tables(tables, table_dtype(fcfg))
    if "table" in tables:
        params = {**params, "table": tables["table"]}
    return params, network_field_fns(params, fcfg, bound, tables)


def draw_jitter(n: int, rcfg: RenderConfig, generator: torch.Generator | None, device) -> torch.Tensor | None:
    """The stratified jitter U(0, 1) [n, num_steps] of one ``n``-ray render
    call through ``rcfg`` (None without ``rcfg.perturb``)."""
    if not rcfg.perturb:
        return None
    return torch.rand((n, rcfg.num_steps), generator=generator, device=device)


def make_phaseA_render(fcfg: FieldConfig, rcfg: RenderConfig, chunk: int,
                       generator: torch.Generator | None = None):
    """phaseA(params, rays_o [N,3], rays_d [N,3], bg [N,3], packed=None) ->
    (rgb [N,3], depth [N]): the 64+64 full-frame render through ``rcfg`` in
    ``chunk``-ray calls, without gradients, each call's jitter drawn from
    ``generator`` (the JAX package's make_phaseA_render). ``packed``: the
    field's lookup tables in its table dtype (built from ``params`` when
    omitted)."""

    @torch.no_grad()
    def phaseA(params, rays_o, rays_d, bg, packed=None):
        n = rays_o.shape[0]
        if n % chunk:
            raise ValueError(f"{n} rays are not a whole number of {chunk}-ray chunks")
        field = network_field_fns(params, fcfg, rcfg.bound, packed)
        rgb, depth = [], []
        for i in range(0, n, chunk):
            out = render_rays(params, rays_o[i : i + chunk], rays_d[i : i + chunk], fcfg, rcfg, bg[i : i + chunk],
                              field=field, jitter=draw_jitter(chunk, rcfg, generator, rays_o.device))
            rgb.append(out["rgb"])
            depth.append(out["depth"])
        return torch.cat(rgb), torch.cat(depth)

    return phaseA


def clip01(x: torch.Tensor) -> torch.Tensor:
    """x clipped to [0, 1] with ``jnp.clip``'s gradient: half of it where x
    lies on a bound (torch.clamp passes all of it). A weight sum of exactly
    1.0 is common where a ray saturates."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _opacity_term(out, out_gt) -> torch.Tensor:
    return smooth_l1(clip01(out["weight_sum"]), clip01(out_gt["weight_sum"]))


def _accumulate_patches(patch_loss, chunk: int):
    """step(params, tables, gt, rays_o, rays_d, g_rgb, bg, *grid) over the
    ``chunk``-ray patches (``grid``: the fast sampler's density grid, none
    for parity): each patch's loss and its backward; returns the summed
    loss (detached)."""

    def step(params, tables, gt, rays_o, rays_d, g_rgb, bg, *grid):
        n = rays_o.shape[0]
        if n % chunk:
            raise ValueError(f"{n} rays are not a whole number of {chunk}-ray patches")
        total = torch.zeros((), device=rays_o.device)
        for i in range(0, n, chunk):
            sl = slice(i, i + chunk)
            loss = patch_loss(params, tables, gt, rays_o[sl], rays_d[sl], g_rgb[sl], bg[sl], *grid)
            loss.backward()
            total += loss.detach()
        return total

    return step


def make_phaseB_step(fcfg: FieldConfig, rcfg: RenderConfig, w_eikonal: float, use_opacity: bool, chunk: int,
                     w_opacity: float = 1e5, generator: torch.Generator | None = None):
    """step(params, tables, gt, rays_o, rays_d, g_rgb, bg) -> the
    summed patch loss (detached), the 64+64 render through ``rcfg`` in
    ``chunk``-ray patches (the JAX package's make_phaseB_step): for each,
    the loss <rgb, g> + reg_scale (w_eikonal eikonal + w_opacity smooth_l1(
    clip(opacity), clip(opacity of the ground truth))) and its backward,
    which adds into the .grad of ``params``' MLP and variance leaves and of
    ``tables`` (f32 leaves, cast to the field's table dtype per patch).
    ``gt``: (params, FieldFns) of the frozen ground truth, rendered with the
    patch's own jitter (one draw from ``generator`` per patch). reg_scale =
    chunk/4096 (make_phaseB_step_fast)."""
    reg_scale = chunk / 4096.0

    def patch_loss(params, tables, gt, ro, rd, g, bg):
        jitter = draw_jitter(ro.shape[0], rcfg, generator, ro.device)
        params, field = table_field(params, tables, fcfg, rcfg.bound)
        out = render_rays(params, ro, rd, fcfg, rcfg, bg, field=field, jitter=jitter)
        loss = torch.sum(out["rgb"] * g) + reg_scale * w_eikonal * out["gradient_error"]
        if use_opacity:
            with torch.no_grad():
                out_gt = render_rays(gt[0], ro, rd, fcfg, rcfg, bg, field=gt[1], jitter=jitter)
            loss = loss + reg_scale * w_opacity * _opacity_term(out, out_gt)
        return loss

    return _accumulate_patches(patch_loss, chunk)


def make_phaseA_render_fast(fcfg: FieldConfig, fast_cfg: FastRenderConfig, chunk: int):
    """phaseA(params, rays_o [N,3], rays_d [N,3], bg [N,3], grid, packed=None)
    -> (rgb [N,3], depth [N]): the occupancy-guided full-frame render in
    ``chunk``-ray calls, without gradients. ``packed``: the field's lookup
    tables in its table dtype (built from ``params`` when omitted)."""

    @torch.no_grad()
    def phaseA(params, rays_o, rays_d, bg, grid, packed=None):
        n = rays_o.shape[0]
        if n % chunk:
            raise ValueError(f"{n} rays are not a whole number of {chunk}-ray chunks")
        field = network_field_fns(params, fcfg, fast_cfg.bound, packed)
        rgb, depth = [], []
        for i in range(0, n, chunk):
            out = render_rays_fast(params, rays_o[i : i + chunk], rays_d[i : i + chunk], fcfg, fast_cfg, grid,
                                   bg[i : i + chunk], field)
            rgb.append(out["rgb"])
            depth.append(out["depth"])
        return torch.cat(rgb), torch.cat(depth)

    return phaseA


def make_phaseB_step_fast(fcfg: FieldConfig, fast_cfg: FastRenderConfig, w_eikonal: float, use_opacity: bool,
                          chunk: int, w_opacity: float = 1e5):
    """step(params, tables, gt, rays_o, rays_d, g_rgb, bg, grid) -> the
    summed patch loss (detached): for each ``chunk``-ray patch, the loss
    <rgb, g> + reg_scale (w_eikonal eikonal + w_opacity smooth_l1(clip(
    opacity), clip(opacity of the ground truth))) and its backward, which
    adds into the .grad of ``params``' MLP and variance leaves and of
    ``tables`` (f32 leaves, cast to the field's table dtype per patch).
    ``gt``: (params, FieldFns) of the frozen ground truth. reg_scale =
    chunk/4096 keeps the reference's SDS:regularizer balance at other patch
    sizes (the SDS term sums over rays, the regularizers are means)."""
    reg_scale = chunk / 4096.0

    def patch_loss(params, tables, gt, ro, rd, g, bg, grid):
        params, field = table_field(params, tables, fcfg, fast_cfg.bound)
        out = render_rays_fast(params, ro, rd, fcfg, fast_cfg, grid, bg, field)
        loss = torch.sum(out["rgb"] * g) + reg_scale * w_eikonal * out["gradient_error"]
        if use_opacity:
            with torch.no_grad():
                out_gt = render_rays_fast(gt[0], ro, rd, fcfg, fast_cfg, grid, bg, gt[1])
            loss = loss + reg_scale * w_opacity * _opacity_term(out, out_gt)
        return loss

    return _accumulate_patches(patch_loss, chunk)


def make_optimizer(lr: float, params) -> torch.optim.Adam:
    """optax.adam(lr): betas (0.9, 0.999), eps 1e-8, a constant rate."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def epoch_poses(cfg: StylizeConfig, rng: np.random.Generator, epoch: int):
    """(poses, descs) of an epoch of the coarse-to-fine schedule, drawn from
    ``rng``."""
    head_rate = cfg.coarse_head if epoch < cfg.coarse_epochs else cfg.fine_head
    center, up = np.zeros(3), np.array([0.0, 1.0, 0.0])
    return style_360_path(
        center, up, CANONICAL_CAMERA_DIST_TRAIN, cfg.n_cap,
        add_noise=cfg.augment_cam, noise_scale=2.0 if cfg.augment_cam else 1.0,
        style_head=cfg.stylize_head, head_offset=CAN_HEAD_OFFSET,
        head_rate=head_rate if cfg.stylize_head else 0.0,
        head_dist=CAN_HEAD_CAMERA_DIST, rng=rng,
    )


def view_rays(cfg: StylizeConfig, rng: np.random.Generator, pose: np.ndarray, epoch: int, device):
    """(rays_o [n,3], rays_d [n,3], th, tw): the view's rays at the stage's
    stride from a random offset drawn from ``rng`` (coarse:
    subsample_scale; fine: min(1, subsample_scale // 2), the JAX package's
    expression, which is 1 for every subsample_scale >= 2)."""
    stride = cfg.subsample_scale if epoch < cfg.coarse_epochs else min(1, cfg.subsample_scale // 2)
    rays_o, rays_d = pose2rays(cfg.H, cfg.W, pose, device=device)
    rays_o, rays_d = sparse_ray_sampling(rays_o.reshape(cfg.H, cfg.W, 3), rays_d.reshape(cfg.H, cfg.W, 3), stride,
                                         rng)
    th, tw = rays_o.shape[:2]
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), th, tw


def frozen_ground_truth(params_gt: dict, fcfg: FieldConfig, bound: float):
    """(params, FieldFns) of the frozen ground-truth field, its table
    gathered and its lookup tables packed once."""
    with torch.no_grad():
        rest, shards, splice = shard_grid_rows(params_gt)
        params = splice(rest, all_gather_table(shards))
        return params, network_field_fns(params, fcfg, bound, materialize_field_tables(params, fcfg))


def gather_packed(rest: dict, shards, splice, fcfg: FieldConfig):
    """(params, packed32, tables): a step's parameter tree with the table
    gathered (through autograd), its lookup tables packed in f32 (through
    autograd; a hash grid's table among them), and detached f32 copies of
    those tables that require grad, for the patches to backpropagate into."""
    params = splice(rest, all_gather_table(shards))
    packed32 = materialize_field_tables(params, dataclasses.replace(fcfg, packed_dtype="float32"))
    if "table" in params:
        packed32 = {**packed32, "table": params["table"]}
    tables = map_leaves(packed32, lambda t: t.detach().requires_grad_())
    return params, packed32, tables


def backward_through_packing(packed32: dict, tables: dict) -> None:
    """The tables' summed patch gradients through the packing's backward,
    then all_gather_rows' (reduce_scatter_rows), into the leaves."""
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves(tables)]
    torch.autograd.backward(leaves(packed32), grads)


def worst_chunk_count(rays_o, rays_d, chunk: int, fast_cfg: FastRenderConfig, grids) -> int:
    """The most probe-selected samples of any ``chunk``-ray slice of the
    rays against any of ``grids`` (one read of the device)."""
    n = rays_o.shape[0]
    chunk = min(chunk, n)
    counts = [count_fast_samples(rays_o[i : i + chunk], rays_d[i : i + chunk], fast_cfg, grid)
              for grid in grids for i in range(0, n - chunk + 1, chunk)]
    return int(torch.stack(counts).max())


@dataclasses.dataclass
class StylizeTrainer:
    """Orchestrates the per-view SDS update on the device of
    ``params_style`` (host-side schedule, device math).

    ``params_style`` / ``params_gt``: parameter trees of the canonical field
    (the trainer trains clones of ``params_style``; ``params_gt`` is the
    frozen reference of the opacity loss). ``cfg.sampler`` "parity" renders
    through ``rcfg``: 64+64 samples, stratified jitter, fd7 normals, even on
    an artifact trained with another estimator (the JAX package honours the
    provenance only for the fast sampler). "fast": ``grid`` is the density
    grid (refreshed from the field when None), re-refreshed every
    ``cfg.grid_update_every`` SDS steps because SDS reshapes the geometry;
    ``fast_cfg``: the fast render's settings (its ``sample_budget`` from
    ``cli.stylize_cli.derive_sample_budget``)."""

    cfg: StylizeConfig
    fcfg: FieldConfig
    guidance: SDSGuidance
    params_style: dict
    params_gt: dict
    grid: torch.Tensor | None = None
    fast_cfg: FastRenderConfig | None = None

    def __post_init__(self):
        c = self.cfg
        if c.sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {c.sampler!r} (one of {', '.join(SAMPLERS)})")
        self.fast = c.sampler == "fast"
        self.rest, self.shards, self.splice = trainable_shards(self.params_style)
        self.params_style = None  # the trainer's copy is (rest, shards): params()
        self.device = self.shards[0].device
        self.opt = make_optimizer(c.lr, leaves(self.rest) + self.shards)
        self.rng = np.random.default_rng(c.seed)
        self.generator = torch.Generator(self.device).manual_seed(c.seed)
        self.rcfg = RenderConfig(num_steps=64, upsample_steps=64, bound=NSR_BOUND, perturb=True)
        if self.fast and self.fast_cfg is None:
            self.fast_cfg = FastRenderConfig(bound=NSR_BOUND)
        self._phaseA = {}
        self._phaseB = self._make_phaseB()
        with record_function("stylize.gather"):
            self.gt = frozen_ground_truth(self.params_gt, self.fcfg, NSR_BOUND)
        self.params_gt = self.gt[0]
        if self.fast:
            self._refresh_grid = make_grid_update_fn(self.fcfg, NSR_BOUND)
            if self.grid is None:
                self.grid = self._refresh_grid(self.params(), torch.zeros((129,) * 3, device=self.device))
        self._step_count = 0
        self._text_cache: dict[str, torch.Tensor] = {}
        self.stats = {"refreshes": 0, "clip_guard_trips": 0}

    def _make_phaseA(self, chunk: int):
        if self.fast:
            return make_phaseA_render_fast(self.fcfg, self.fast_cfg, chunk)
        return make_phaseA_render(self.fcfg, self.rcfg, chunk, self.generator)

    def _make_phaseB(self):
        c = self.cfg
        if self.fast:
            return make_phaseB_step_fast(self.fcfg, self.fast_cfg, c.w_eikonal, c.use_opacity, c.batch_size,
                                         c.w_opacity)
        return make_phaseB_step(self.fcfg, self.rcfg, c.w_eikonal, c.use_opacity, c.batch_size, c.w_opacity,
                                self.generator)

    def _grid(self) -> tuple:
        """The fast phases' density grid argument (the parity phases take
        none: their jitter generator is bound when they are built)."""
        return (self.grid,) if self.fast else ()

    def params(self) -> dict:
        """The current full parameter tree (detached, the table gathered)."""
        return gathered_params(self.rest, self.shards, self.splice)

    # -- schedule -----------------------------------------------------------
    def epoch_poses(self, epoch: int):
        return epoch_poses(self.cfg, self.rng, epoch)

    def text_embedding(self, prompt: str) -> torch.Tensor:
        if prompt not in self._text_cache:
            self._text_cache[prompt] = self.guidance.get_text_embeds([prompt])
        return self._text_cache[prompt]

    def view_rays(self, pose: np.ndarray, epoch: int):
        return view_rays(self.cfg, self.rng, pose, epoch, self.device)

    # -- one view = one optimizer step ---------------------------------------

    def train_view(self, pose: np.ndarray, desc: str, epoch: int) -> torch.Tensor:
        """One SDS step on one view; returns the summed phase-B loss
        (detached, on the device)."""
        c = self.cfg
        rays_o, rays_d, th, tw = self.view_rays(pose, epoch)
        n_rays = th * tw
        bkg_key = (
            int(self.rng.integers(WHITE_BKG, NOISE_BKG + 1))
            if c.augment_bkg
            else (WHITE_BKG if c.white_bkg else BLACK_BKG)
        )
        bg = select_background(n_rays, bkg_key, self.generator, self.device)
        prompt = f"{desc} {c.tgt_text}" if c.augment_text else c.tgt_text
        text_emb = self.text_embedding(prompt)
        chunk = min(c.batch_size, n_rays)

        self.opt.zero_grad(set_to_none=True)
        with record_function("stylize.gather"):  # all_gather_rows
            params, packed32, tables = gather_packed(self.rest, self.shards, self.splice, self.fcfg)
        with record_function("stylize.phaseA"):
            if chunk not in self._phaseA:
                self._phaseA[chunk] = self._make_phaseA(chunk)
            with torch.no_grad():
                rgb_full, depth_full = self._phaseA[chunk](params, rays_o, rays_d, bg, *self._grid(),
                                                           packed=cast_tables(tables, table_dtype(self.fcfg)))
        img = rgb_full.reshape(1, th, tw, 3).permute(0, 3, 1, 2)
        # SD 2.0-depth conditions the UNet on the frame's depth
        pred_depth = depth_full.reshape(1, 1, th, tw) if self.guidance.m.use_depth else None
        g_img = self.guidance.sds_image_grad(text_emb, img, c.guidance_scale, pred_depth=pred_depth,
                                             generator=self.generator,
                                             scope=lambda part: record_function("stylize." + part))
        with record_function("stylize.phaseB"):
            g_rgb = g_img.permute(0, 2, 3, 1).reshape(-1, 3)
            if chunk != c.batch_size:
                raise ValueError(f"a {th}x{tw} frame is smaller than one {c.batch_size}-ray patch")
            loss = self._phaseB(params, tables, self.gt, rays_o, rays_d, g_rgb, bg, *self._grid())
            backward_through_packing(packed32, tables)
            self.opt.step()
        self._step_count += 1
        if self.fast and c.grid_update_every and self._step_count % c.grid_update_every == 0:
            with record_function("stylize.refresh"):
                new_grid = self._refresh_grid(self.params(), self.grid)
                if c.prune_floaters:
                    # seeded by the previous (already pruned) occupancy: each
                    # refresh keeps only components connected to it
                    new_grid = prune_grid_floaters(new_grid, self.grid)
                self.grid = new_grid
                self.stats["refreshes"] += 1
                self._budget_clip_guard(rays_o, rays_d)
        return loss

    def _budget_clip_guard(self, rays_o, rays_d):
        """Zero-clip invariant for the compaction budget: after each grid
        refresh, count the probe-selected samples of the current view
        against the live grid per phase-B chunk; if the budget would drop
        samples (SDS inflates occupancy over training), turn compaction off
        rather than silently zero trailing rays (compaction drops in flat
        order)."""
        if not self.fast_cfg.sample_budget:
            return
        worst = worst_chunk_count(rays_o, rays_d, self.cfg.batch_size, self.fast_cfg, [self.grid])
        if worst > self.fast_cfg.sample_budget:
            print(
                f"[stylize] CLIP GUARD: grid refresh at step {self._step_count} "
                f"selects {worst} samples/chunk > budget {self.fast_cfg.sample_budget}; "
                f"disabling compaction",
                flush=True,
            )
            self.fast_cfg = dataclasses.replace(self.fast_cfg, sample_budget=0)
            self._phaseA = {}
            self._phaseB = self._make_phaseB()
            self.stats["clip_guard_trips"] += 1

    def train(self, max_steps: int | None = None, on_step: Callable | None = None) -> int:
        """The coarse-to-fine schedule: per epoch a fresh pose set, visited in
        a random order, one SDS step per view. ``on_step(step, trainer)``
        runs after each step. Returns the number of steps."""
        c = self.cfg
        step = 0
        for epoch in range(c.coarse_epochs + c.fine_epochs):
            poses, descs = self.epoch_poses(epoch)
            order = self.rng.permutation(len(poses))
            for i in order:
                self.train_view(poses[i], descs[i], epoch)
                if on_step is not None:
                    on_step(step, self)
                step += 1
                if max_steps is not None and step >= max_steps:
                    return step
        return step
