"""Ray sampling: cube AABB near/far, stratified z values and inverse-CDF
importance sampling. Port of the JAX package's ops/sampling.py (reference:
models/instant_nsr.py:21-77,155-162)."""

from __future__ import annotations

import numpy as np
import torch


def recip(c: float) -> float:
    """The f32 reciprocal of a constant. Inside ``jit``, XLA rewrites
    ``x / c`` for a constant ``c`` as ``x * f32(1 / f32(c))``; the port
    multiplies by this value wherever the JAX package divides by a constant,
    so that its f32 results match the JAX package's bit for bit."""
    return float(np.float32(1.0) / np.float32(c))


def linspace(start: float, stop: float, m: int, device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, m)`` in f32, computed as XLA computes it
    under ``jit``: step = iota * f32(1/(m-1)), start * (1 - step) + stop *
    step, the last value ``stop`` itself."""
    start, stop = float(np.float32(start)), float(np.float32(stop))
    step = torch.arange(m - 1, dtype=torch.float32, device=device) * recip(m - 1)
    out = start * (1.0 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


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


def stratified_z_vals(near: torch.Tensor, far: torch.Tensor, num_steps: int, *, perturb: bool = False,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """[N, T] z values spanning [near, far] per ray; with ``perturb`` each is
    jittered by U(-0.5, 0.5) * sample_dist, drawn from ``generator`` on the
    rays' device."""
    t = linspace(0.0, 1.0, num_steps, near.device)
    z_vals = near + (far - near) * t[None, :]
    if perturb:
        sample_dist = (far - near) * recip(num_steps)
        u = torch.rand(z_vals.shape, generator=generator, device=z_vals.device)
        z_vals = z_vals + (u - 0.5) * sample_dist
    return z_vals


def pdf_cdf(weights: torch.Tensor) -> torch.Tensor:
    """[B, T-1] bin weights -> the [B, T] CDF over the bin edges, from 0."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)


def pdf_bins(cdf: torch.Tensor, u: torch.Tensor):
    """(below, above) [B, n] edge indices around each u: the right-side
    search (the first edge whose CDF exceeds u), clamped to the edges."""
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(cdf.shape[-1] - 1)
    return below, above


def invert_cdf(bins: torch.Tensor, cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The z values [B, n] at quantiles u [B, n] of the piecewise-linear CDF
    [B, T] over the bin edges ``bins`` [B, T]."""
    below, above = pdf_bins(cdf, u)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int, *, det: bool = True,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverse-CDF sampling of ``n_samples`` new z values per ray.

    bins [B, T] z values (the bin edges), weights [B, T-1]. ``det``: the
    mid-bin quantiles linspace(0.5/n, 1 - 0.5/n, n) that the renderer's
    up-sampling uses; else U(0, 1) from ``generator``. Returns [B, n]."""
    B = bins.shape[0]
    if det:
        u = linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples, bins.device).expand(B, n_samples)
    else:
        u = torch.rand((B, n_samples), generator=generator, device=bins.device)
    return invert_cdf(bins, pdf_cdf(weights), u)
