"""An animation frame, written out plainly for the benchmark: the frame's
posed body (``body.frame``), its occupancy grid (the posed vertices
voxelized), and the canonical camera's rays rendered through the
occupancy-guided march (``march``) with the warp to the canonical field,
over ``bg``."""

from __future__ import annotations

import torch

from portbench.reference import body, march


@torch.no_grad()
def render(field, rig: dict, pose, rest: str, rays_o, rays_d, bg: float, *, n_probes: int, k: int,
           chunk: int, warp_dtype=torch.float64) -> torch.Tensor:
    """rgb [n,3] of one frame of ``pose``."""
    verts, Ts = body.frame(rig, pose, rest)
    grid = body.voxelize(torch.as_tensor(verts, device=rays_o.device), field.bound)
    warp = body.Warp(verts, rig["faces"], Ts, rays_o.device, dtype=warp_dtype)
    return torch.cat([
        march.render(field, rays_o[i:i + chunk], rays_d[i:i + chunk], grid, bg, n_probes=n_probes, k=k,
                     warp=warp)["rgb"]
        for i in range(0, rays_o.shape[0], chunk)
    ])
