"""Hybrid rendering: an avatar (the instant-NSR field) over a background
NeRF, merged per pixel by depth. Port of the JAX package's
workloads/hybrid.py (reference: utils/render_utils.py:605-719
render_hybrid_avatar, :815-913 render_hybrid_nerf_multi_persons and
:1025-1038 composite_by_depth).

The avatar renders through ``render_rays`` (geometry-guided bounds and the
warp when it has ``warp_data``), the background through
``render_nerf_rays`` over the scene's range; both depths are in world
ray-t units before they are compared. The avatar's parameters are taken
whole, as the JAX package takes them (no row-sharded table).
"""

from __future__ import annotations

import numpy as np
import torch

from avatarcraft_tpu_torch.models.instant_nsr import FieldConfig, RenderConfig, render_rays
from avatarcraft_tpu_torch.models.nerf import NeRFConfig, render_nerf_rays
from avatarcraft_tpu_torch.ops.sampling import near_far_from_bound
from avatarcraft_tpu_torch.warp import WarpData, geometry_guided_near_far, make_warp_fn


def composite_by_depth(img_a, img_b, depth_a, depth_b):
    """Per-pixel nearest wins (reference: utils/render_utils.py:1025)."""
    return torch.where((depth_a < depth_b)[..., None], img_a, img_b)


def avatar_generator(seed: int, i: int, device) -> torch.Generator:
    """The random stream of avatar ``i`` in ``render_hybrid_multi_persons``
    (the JAX package's ``jax.random.fold_in(key, i)``): a
    ``torch.Generator`` on ``device`` seeded from numpy's
    ``SeedSequence([seed, i])``, so that every (seed, avatar) pair has a
    stream of its own."""
    state = int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0])
    return torch.Generator(device).manual_seed(state)


def render_hybrid_avatar(
    avatar_params: dict,
    fcfg: FieldConfig,
    rcfg: RenderConfig,
    bkg_params: dict,
    bkg_cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    warp_data: WarpData | None = None,
    generator: torch.Generator | None = None,
    bkg_near: float = 0.5,
    bkg_far: float = 6.0,
    geo_threshold: float = 0.05,
) -> dict:
    """The avatar and the NeRF background of rays [N,3], merged by depth:
    {"rgb" [N,3], "depth" [N], "avatar_mask" [N]}.

    With ``warp_data`` the avatar renders between the geometry-guided
    bounds through the warp, and its normalised depth is undone with the
    cube bounds for the rays that miss every vertex sphere (the fallback
    render_rays itself takes). The avatar counts where its weight sum
    exceeds 0.5, the background where its accumulated weight exceeds 0.05;
    elsewhere each depth is +inf. ``generator``: the render's jitter and
    curvature stream (unused at ``rcfg.perturb`` False)."""
    if warp_data is not None:
        near, far = geometry_guided_near_far(rays_o, rays_d, warp_data.verts, geo_threshold)
        out_a = render_rays(avatar_params, rays_o, rays_d, fcfg, rcfg, 0.0, generator, near_far=(near, far),
                            warp_fn=make_warp_fn(warp_data, geo_threshold))
        cnear, cfar = near_far_from_bound(rays_o, rays_d, rcfg.bound)
        near_w = torch.where(torch.isinf(near), cnear, near)
        far_w = torch.where(torch.isinf(far), cfar, far)
    else:
        out_a = render_rays(avatar_params, rays_o, rays_d, fcfg, rcfg, 0.0, generator)
        near_w, far_w = near_far_from_bound(rays_o, rays_d, rcfg.bound)

    # the avatar's depth is normalised, (z - near) / (far - near): undo it
    t_avatar = out_a["depth"][:, None] * (far_w - near_w) + near_w
    opaque = out_a["weight_sum"] > 0.5
    t_avatar = torch.where(opaque, t_avatar, torch.inf)

    out_b = render_nerf_rays(bkg_params, rays_o, rays_d, bkg_cfg, near=bkg_near, far=bkg_far, white_bkg=True)
    # rays that miss the background have no weight and a meaningless depth
    t_bkg = torch.where(out_b["acc"] > 0.05, out_b["depth"], torch.inf)[:, None]

    return {
        "rgb": composite_by_depth(out_a["rgb"], out_b["rgb"], t_avatar[:, 0], t_bkg[:, 0]),
        "depth": torch.minimum(t_avatar, t_bkg)[:, 0],
        "avatar_mask": opaque[:, 0],
    }


def render_hybrid_multi_persons(
    avatars: list,
    bkg_params: dict,
    bkg_cfg: NeRFConfig,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    seed: int = 0,
    bkg_near: float = 0.5,
    bkg_far: float = 6.0,
) -> dict:
    """Several warped avatars over one background, the nearest surface
    winning (reference: utils/render_utils.py:815-913): {"rgb" [N,3],
    "depth" [N]}. ``avatars``: dicts with the keys params, fcfg, rcfg and
    (optionally) warp_data. Avatar ``i`` renders with the stream
    ``avatar_generator(seed, i, ...)``. One (bkg_near, bkg_far) range
    serves the outer background and every avatar's pass, so their depths
    agree."""
    out_b = render_nerf_rays(bkg_params, rays_o, rays_d, bkg_cfg, near=bkg_near, far=bkg_far, white_bkg=True)
    rgb = out_b["rgb"]
    depth = torch.where(out_b["acc"] > 0.05, out_b["depth"], torch.inf)
    for i, av in enumerate(avatars):
        res = render_hybrid_avatar(
            av["params"], av["fcfg"], av["rcfg"], bkg_params, bkg_cfg, rays_o, rays_d,
            warp_data=av.get("warp_data"), generator=avatar_generator(seed, i, rays_o.device),
            bkg_near=bkg_near, bkg_far=bkg_far,
        )
        nearer = res["avatar_mask"] & (res["depth"] < depth)
        rgb = torch.where(nearer[:, None], res["rgb"], rgb)
        depth = torch.where(nearer, res["depth"], depth)
    return {"rgb": rgb, "depth": depth}
