"""The occupancy-guided NeuS render, written out plainly for the benchmark.

Per ray: the cube's near and far (near at least 0.05); M probes evenly
from near to far; a probe is occupied where the nearest cell of the density
grid is above min(grid mean, 10); K samples among the occupied probes,
spread evenly over them where there are more than K (the
floor((i + 1/2) n / K)-th), else all of them front to back with the rest
of the K slots empty. Each sample is evaluated through the field (fd4
normals), composited as NeuS does (the cosine annealed to the true cosine,
alpha from the SDF's logistic CDF, transmittance 1 - alpha + 1e-7), over
``bg``. The eikonal term is (|grad| - 1)^2 over the filled samples inside
the 1.2 ball.

An animation frame passes ``warp``: posed samples -> (canonical points,
mask). The filled samples are warped, clamped to the cube and evaluated in
canonical space with the posed ray's direction; those the mask drops are
empty.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

N_PROBES = 192
K_SAMPLES = 32
FD_EPSILON = 0.005
OCC_THRESHOLD = 10.0
EIKONAL_RADIUS = 1.2


def f32(c: float) -> float:
    return float(np.float32(c))


def near_far(rays_o: torch.Tensor, rays_d: torch.Tensor, bound: float):
    t0 = (-bound - rays_o) / (rays_d + 1e-15)
    t1 = (bound - rays_o) / (rays_d + 1e-15)
    near = torch.minimum(t0, t1).amax(dim=-1, keepdim=True).clamp_min(0.05)
    far = torch.maximum(t0, t1).amin(dim=-1, keepdim=True)
    return near, far


def probe_depths(near, far, m: int) -> torch.Tensor:
    """[N, m] probe depths near + (far - near) t_i, t_i = i / (m - 1) in
    f32, each depth rounded once."""
    t = torch.arange(m, dtype=torch.float32, device=near.device) * f32(1.0 / f32(m - 1))
    t[-1] = 1.0
    return (near.double() + (far - near).double() * t.double()).float()


def occupied(grid: torch.Tensor, pts: torch.Tensor, bound: float) -> torch.Tensor:
    """Whether the nearest cell of ``grid`` ([R,R,R]) to each point is above
    min(mean, 10)."""
    R = grid.shape[0]
    thresh = torch.clamp(grid.mean(), max=OCC_THRESHOLD)
    x01 = ((pts + bound) * f32(1.0 / f32(2.0 * bound))).clamp(0.0, 1.0)
    i = torch.round(x01 * (R - 1)).long().clamp(0, R - 1)
    return grid[i[..., 0], i[..., 1], i[..., 2]] > thresh


def select(z: torch.Tensor, occ: torch.Tensor, k: int):
    """(z_sel [N,k], filled [N,k]): see the module's docstring."""
    n, m = occ.shape
    n_occ = occ.sum(dim=1, keepdim=True)
    i = torch.arange(k, device=z.device)[None, :]
    spread = torch.floor((i + 0.5) * n_occ / k).long()
    rank = torch.where(n_occ > k, spread, torch.minimum(i, (n_occ - 1).clamp_min(0)))
    # the probe index of each occupied probe, in order; empty rays take probe 0
    order = torch.where(occ, torch.arange(m, device=z.device)[None, :], m)
    idx = torch.sort(order, dim=1).values.gather(1, rank).clamp(max=m - 1)
    return z.gather(1, idx), i < n_occ


def render(field, rays_o, rays_d, grid, bg, *, n_probes=N_PROBES, k=K_SAMPLES, warp=None,
           cos_anneal_ratio: float = 1.0) -> dict:
    """{"rgb" [N,3], "eikonal" scalar} of rays [N,3] through ``field``."""
    bound = field.bound
    near, far = near_far(rays_o, rays_d, bound)
    z = probe_depths(near, far, n_probes)
    occ = occupied(grid, rays_o[:, None, :] + rays_d[:, None, :] * z[..., None], bound)
    z_sel, filled = select(z, occ, k)
    pts = torch.clamp(rays_o[:, None, :] + rays_d[:, None, :] * z_sel[..., None], -bound, bound)
    n = rays_o.shape[0]
    dirs = rays_d[:, None, :].expand(n, k, 3)

    if warp is not None:  # only the filled samples are warped and evaluated
        sel = filled.reshape(-1).nonzero()[:, 0]
        can, mask = warp(pts.reshape(-1, 3)[sel])
        x = torch.clamp(can, -bound, bound)
        keep = torch.zeros(n * k, dtype=torch.bool, device=pts.device)
        keep[sel] = mask
        filled = keep.reshape(n, k)
    else:
        sel = torch.arange(n * k, device=pts.device)
        x = pts.reshape(-1, 3)
    sdf_s, feat_s, grad_s = field.fd4(x, FD_EPSILON)
    normal_s = grad_s / (1e-5 + torch.sqrt((grad_s * grad_s).sum(-1, keepdim=True) + 1e-12))
    color_s = field.color(x, normal_s, feat_s)

    def spread_out(v, width):  # evaluated samples back to their [N, k] slots (zeros elsewhere)
        full = torch.zeros((n * k, width), dtype=v.dtype, device=v.device)
        return full.index_copy(0, sel, v.reshape(-1, width)).reshape(n, k, width)

    sdf = spread_out(sdf_s, 1)[..., 0]
    grad = spread_out(grad_s, 3)
    normal = spread_out(normal_s, 3)
    color = spread_out(color_s, 3)
    radius = spread_out(x.norm(dim=-1), 1)[..., 0]

    step = (far - near) * f32(1.0 / n_probes)
    gaps = torch.where(filled[:, 1:], z_sel[:, 1:] - z_sel[:, :-1], step)
    delta = torch.cat([gaps, step], dim=1)
    cos = (dirs * normal).sum(-1)
    a = cos_anneal_ratio
    iter_cos = -(F.softplus(-cos * 0.5 + 0.5, beta=100.0) * (1.0 - a) + F.softplus(-cos, beta=100.0) * a)
    inv_s = field.inv_s()
    prev_cdf = torch.sigmoid((sdf - iter_cos * delta * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf + iter_cos * delta * 0.5) * inv_s)
    alpha = torch.clamp((prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0) * filled
    factors = 1.0 - alpha + 1e-7
    trans = torch.cat([torch.ones_like(factors[:, :1]), torch.cumprod(factors, dim=1)[:, :-1]], dim=1)
    w = alpha * trans
    rgb = (color * w[..., None]).sum(1) + (1.0 - w.sum(1, keepdim=True)) * bg

    inside = ((radius < EIKONAL_RADIUS) & filled).float()
    err = (torch.sqrt((grad * grad).sum(-1) + 1e-12) - 1.0) ** 2
    eikonal = (inside * err).sum() / (inside.sum() + 1e-5)
    return {"rgb": rgb, "eikonal": eikonal}
