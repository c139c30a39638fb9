"""Animation and shape interpolation: the warped renders of a canonical
field. Port of the JAX package's workloads/warp_render.py (``da_pose``,
``calc_local_trans``, ``WarpRenderSettings``, ``make_warp_frame_renderer``,
``derive_warp_budget``, ``make_warp_frame_renderer_fast``).

calc_local_trans (reference: render_warp.py:127-222) composes, per frame,
the canonical (rest pose, beta = 0) -> posed (target pose and shape) chain

    T_rest2pose = T_t2pose @ T_shape^-1 @ T_t2rest^-1
    Ts[i]       = T_rest2pose @ (I / SMPL_SCALE)

with T_shape a translation-only blend-shape displacement. It runs the SMPL
functions on the CPU and composes in numpy f32, where the JAX package uses
numpy. The parity frame renderer (the JAX package's default) bounds each
ray by the spheres around the posed vertices and renders 32+32 importance
samples, every one of them warped; the fast one voxelizes the posed body
into a density grid, and only the samples that grid selects pay the kNN
warp and the field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from avatarcraft_tpu_torch.constants import DEFAULT_GEO_THRESH, NSR_BOUND, SMPL_SCALE
from avatarcraft_tpu_torch.models.instant_nsr import (
    FastRenderConfig,
    FieldConfig,
    RenderConfig,
    count_fast_samples,
    render_rays,
    render_rays_fast,
)
from avatarcraft_tpu_torch.models.smpl import SMPLParams, smpl_forward, verts_transformations
from avatarcraft_tpu_torch.ops.occupancy import voxelize_verts
from avatarcraft_tpu_torch.parallel.table_mp import shard_grid_rows
from avatarcraft_tpu_torch.warp import WarpData, geometry_guided_near_far, make_warp_fn
from avatarcraft_tpu_torch.workloads.canonical_render import gathered_field

# the fast warp render's probe pass and posed-body grid (the JAX package's
# make_warp_frame_renderer_fast defaults, which its CLI and bench use)
N_PROBES = 128
K_SAMPLES = 32
GRID_RESOLUTION = 129
BUDGET_SAFETY = 1.02  # derived budget = worst probe-selected count x 1.02
N_INTERP = 10  # frames of a shape interpolation, the JAX package's default


def da_pose(n_pose: int = 72) -> np.ndarray:
    """The NeuMan 'da' pose: arms rotated by +-1 rad about z
    (reference: render_warp.py:163-168)."""
    p = np.zeros((n_pose // 3, 3), np.float32)
    p[1] = [0, 0, 1.0]
    p[2] = [0, 0, -1.0]
    return p.reshape(1, -1)


def _smpl_np(fn, model: SMPLParams, pose: np.ndarray, betas: np.ndarray, **kw):
    """An SMPL function on CPU tensors, its results as numpy arrays."""
    out = fn(model, torch.as_tensor(np.asarray(pose, np.float32)), torch.as_tensor(np.asarray(betas, np.float32)), **kw)
    return [o.numpy() for o in out]


def calc_local_trans(
    model: SMPLParams,
    render_type: str = "animate",
    poses: np.ndarray | None = None,
    shape_from: np.ndarray | None = None,
    shape_to: np.ndarray | None = None,
    max_frames: int = 100,
    rest_pose: str = "da",
):
    """Per frame (world_verts [V,3], Ts [V+J,4,4]) for animation or shape
    interpolation, and the frame count (reference: render_warp.py:127-222).

    ``rest_pose``: the pose the canonical field was trained in. "da" = the
    NeuMan da-pose (the reference's canonical SMPL field is da-posed,
    render_warp.py:163-168). "zero" = identity, for mesh-derived demo bodies
    whose template already is the da-posed avatar surface: their rest
    transform is the identity and animation poses are deltas about it."""
    n_betas = model.shapedirs.shape[-1]
    zero_shape = np.zeros((1, n_betas), np.float32)
    n_pose = model.n_joints * 3
    da = da_pose(n_pose) if rest_pose == "da" else np.zeros((1, n_pose), np.float32)

    if shape_from is None:
        shape_from = np.zeros((1, n_betas), np.float32)
        shape_from[0, 1] = 2.0
    if shape_to is None:
        shape_to = np.zeros((1, n_betas), np.float32)
        shape_to[0, 1] = -2.0
    target_shapes = np.linspace(shape_from, shape_to, N_INTERP)

    if render_type == "animate":
        if poses is None:
            raise ValueError("animate needs a pose sequence")
        n_frames = min(max_frames, poses.shape[0])
        target_shapes = np.zeros((n_frames, 1, n_betas), np.float32)
        poses = poses.reshape(poses.shape[0], -1)[:n_frames, :n_pose]
    elif render_type == "interp_shape":
        n_frames = min(max_frames, target_shapes.shape[0])
        poses = np.zeros((n_frames, n_pose), np.float32)
    else:
        raise NotImplementedError(render_type)

    # frame-independent pieces
    v0, T_t2rest, _ = _smpl_np(verts_transformations, model, da, zero_shape, concat_joints=True)
    v0, T_t2rest = v0[0], T_t2rest[0]
    T_t2rest_inv = np.linalg.inv(T_t2rest)

    rest_verts, rest_joints = _smpl_np(smpl_forward, model, da, zero_shape, return_joints=True)
    rest_all = np.concatenate([rest_verts[0], rest_joints[0]], axis=0)
    rest_all_h = np.concatenate([rest_all, np.ones_like(rest_all[:, :1])], axis=-1)

    T_scale = np.eye(4, dtype=np.float32) / SMPL_SCALE

    world_verts, Ts = [], []
    for i in range(n_frames):
        _, T_t2pose, _ = _smpl_np(verts_transformations, model, poses[i][None], zero_shape, concat_joints=True)
        T_t2pose = T_t2pose[0]

        vt, _, _ = _smpl_np(verts_transformations, model, da, target_shapes[i].astype(np.float32),
                            concat_joints=True)
        delta_v = v0 - vt[0]  # the beta-blendshape displacement

        # translation-only T_shape; its inverse translates by -delta_v
        T_shape_inv = np.broadcast_to(np.eye(4, dtype=np.float32), T_t2pose.shape).copy()
        T_shape_inv[:, :3, 3] = -delta_v

        T_rest2pose = T_t2pose @ T_shape_inv @ T_t2rest_inv
        Ts.append((T_rest2pose @ T_scale).astype(np.float32))

        wv = np.einsum("BNi,Bi->BN", T_rest2pose, rest_all_h)[:, :3]
        world_verts.append(wv[: model.n_verts].astype(np.float32))
    return world_verts, Ts, n_frames


@dataclasses.dataclass(frozen=True)
class WarpRenderSettings:
    """The warp renders' settings: the parity render's samples, and the
    fast render's normal estimator."""

    num_steps: int = 32  # reference: render_warp.py:104-105
    upsample_steps: int = 32
    bound: float = NSR_BOUND
    chunk: int = 8192  # rays per chunk (reference: render_warp.py:93, 64*128)
    geo_threshold: float = DEFAULT_GEO_THRESH
    normal_mode: str = "fd4"  # the fast render's (the JAX package's fast warp render: fd4)


def _fast_config(settings: WarpRenderSettings, sample_budget: int = 0) -> FastRenderConfig:
    return FastRenderConfig(n_probes=N_PROBES, k_samples=K_SAMPLES, bound=settings.bound,
                            sample_budget=sample_budget, normal_mode=settings.normal_mode)


def warp_worst_count(world_verts: list, rays_o: torch.Tensor, rays_d: torch.Tensor,
                     settings: WarpRenderSettings) -> int:
    """The most samples the fast warp render's probe pass selects in one
    chunk, over every chunk of every frame (the posed body of each frame
    voxelized as the renderer does it), on the rays' device."""
    n = rays_o.shape[0]
    chunk = min(settings.chunk, n)
    cfg = _fast_config(settings)
    worst = 0
    for verts in world_verts:
        grid = voxelize_verts(torch.as_tensor(verts, device=rays_o.device), settings.bound, GRID_RESOLUTION)
        for i in range(0, n - chunk + 1, chunk):
            worst = max(worst, int(count_fast_samples(rays_o[i : i + chunk], rays_d[i : i + chunk], cfg, grid)))
    return worst


def derive_warp_budget(world_verts: list, rays_o: torch.Tensor, rays_d: torch.Tensor,
                       settings: WarpRenderSettings) -> int:
    """The per-chunk sample budget of the fast warp render: the worst count
    x 1.02, so that no frame of the sequence is clipped (the reference
    sizes its packed buffers from measured counts the same way,
    raymarching/raymarching.py:21-114 mean_count)."""
    return int(warp_worst_count(world_verts, rays_o, rays_d, settings) * BUDGET_SAFETY)


def make_warp_frame_renderer(params: dict, fcfg: FieldConfig, settings: WarpRenderSettings, bg_value: float = 1.0):
    """render(rays_o [n,3], rays_d [n,3], warp_data) -> rgb [n,3] of one
    animation frame through the 64+64 pipeline's render at
    ``settings.num_steps`` + ``settings.upsample_steps`` samples (rounds of
    16, no jitter, fd7 normals), on the device of ``params`` and the rays
    (the JAX package's make_warp_frame_renderer).

    Per frame: gather the row-sharded table and build the lookup tables
    once; then, in chunks of ``settings.chunk`` rays, bound each ray by the
    spheres around the posed vertices (geometry_guided_near_far) and render
    it through render_rays with the kNN warp, which warps every sample.
    ``n`` must be a multiple of the chunk."""
    params_rest, shards, splice = shard_grid_rows(params)
    rcfg = RenderConfig(num_steps=settings.num_steps, upsample_steps=settings.upsample_steps, upsample_round=16,
                        bound=settings.bound, perturb=False)

    @torch.no_grad()
    def render(rays_o: torch.Tensor, rays_d: torch.Tensor, warp_data: WarpData) -> torch.Tensor:
        n = rays_o.shape[0]
        chunk = min(settings.chunk, n)
        if n % chunk:
            raise ValueError(f"{n} rays are not a whole number of {chunk}-ray chunks")
        full, field = gathered_field(params_rest, shards, splice, fcfg, settings.bound)
        warp_fn = make_warp_fn(warp_data, settings.geo_threshold)
        rgb = []
        for i in range(0, n, chunk):
            ro, rd = rays_o[i : i + chunk], rays_d[i : i + chunk]
            with record_function("render.near_far"):
                near_far = geometry_guided_near_far(ro, rd, warp_data.verts, settings.geo_threshold)
            rgb.append(render_rays(full, ro, rd, fcfg, rcfg, bg_value, near_far=near_far, warp_fn=warp_fn,
                                   field=field)["rgb"])
        return torch.cat(rgb)

    return render


def make_warp_frame_renderer_fast(params: dict, fcfg: FieldConfig, settings: WarpRenderSettings,
                                  sample_budget: int, bg_value: float = 1.0):
    """render(rays_o [n,3], rays_d [n,3], warp_data) -> rgb [n,3] of one
    animation frame, on the device of ``params`` and the rays.

    Per frame: gather the row-sharded finest grid (the all-gather kernel),
    splice it in and build the packed tables once; voxelize the frame's
    posed body into the density grid; then render the rays in chunks of
    ``settings.chunk`` through render_rays_fast with the kNN warp. The
    selection spends the samples only near the posed body, and only those
    samples pay the warp and the field. ``sample_budget``: samples per
    chunk (derive it with derive_warp_budget; 0 = no budget, every selected
    slot is evaluated). ``n`` must be a multiple of the chunk.
    """
    params_rest, shards, splice = shard_grid_rows(params)
    cfg = _fast_config(settings, sample_budget)

    @torch.no_grad()
    def render(rays_o: torch.Tensor, rays_d: torch.Tensor, warp_data: WarpData) -> torch.Tensor:
        n = rays_o.shape[0]
        chunk = min(settings.chunk, n)
        if n % chunk:
            raise ValueError(f"{n} rays are not a whole number of {chunk}-ray chunks")
        full, field = gathered_field(params_rest, shards, splice, fcfg, settings.bound)
        with record_function("render.voxelize"):  # K6
            grid = voxelize_verts(warp_data.verts, settings.bound, GRID_RESOLUTION)
        warp_fn = make_warp_fn(warp_data, settings.geo_threshold)
        rgb = [
            render_rays_fast(full, rays_o[i : i + chunk], rays_d[i : i + chunk], fcfg, cfg, grid, bg_value,
                             field, warp_fn=warp_fn)["rgb"]
            for i in range(0, n, chunk)
        ]
        return torch.cat(rgb)

    return render
