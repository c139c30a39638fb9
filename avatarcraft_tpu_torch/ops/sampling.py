"""Cube AABB near/far (port of the JAX package's ops/sampling.py:66;
reference: models/instant_nsr.py:58-77)."""

from __future__ import annotations

import numpy as np
import torch


def recip(c: float) -> float:
    """The f32 reciprocal of a constant. Inside ``jit``, XLA rewrites
    ``x / c`` for a constant ``c`` as ``x * f32(1 / f32(c))``; the port
    multiplies by this value wherever the JAX package divides by a constant,
    so that its f32 results match the JAX package's bit for bit."""
    return float(np.float32(1.0) / np.float32(c))


def near_far_from_bound(rays_o: torch.Tensor, rays_d: torch.Tensor, bound: float):
    """Ray/[-bound,bound]^3 slab test. rays_o, rays_d: [N, 3] ->
    (near, far): [N, 1] each, with the reference's ``near >= 0.05`` clamp
    and its ``rd + 1e-15`` guard against axis-parallel rays."""
    tmin = (-bound - rays_o) / (rays_d + 1e-15)
    tmax = (bound - rays_o) / (rays_d + 1e-15)
    near = torch.minimum(tmin, tmax).amax(dim=-1, keepdim=True)
    far = torch.maximum(tmin, tmax).amin(dim=-1, keepdim=True)
    near = near.clamp_min(0.05)
    return near, far
