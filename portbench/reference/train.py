"""Reconstruction steps of the fast sampler, written out plainly for the
benchmark: a batch of (view, pixel) pairs in the order of a permutation of
every pair drawn from the trainer's seed, the pixels' rays, the
occupancy-guided render (``march``) over ``bg``, the loss smooth-L1 (beta
1, the mean over the batch's channels) + 0.1 x eikonal, its gradient by
autograd, and Adam (betas 0.9 and 0.99, eps 1e-15, bias-corrected) at the
step's learning rate: base x (1 + cos(pi step / steps)) / 2 over the
schedule's steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import cameras, march
from portbench.reference.field import Field

BETAS = (0.9, 0.99)
EPS = 1e-15
EIKONAL_WEIGHT = 0.1


def pixel_batches(seed: int, n_views: int, n_pixels: int, batch: int, n: int):
    """The first ``n`` (views [B], pixels [B]) of the permutation of all
    n_views x n_pixels pairs that numpy's default_rng(seed) draws."""
    perm = np.random.default_rng(seed).permutation(n_views * n_pixels)
    return [(perm[s * batch:(s + 1) * batch] // n_pixels, perm[s * batch:(s + 1) * batch] % n_pixels)
            for s in range(n)]


def cosine_lr(base: float, step: int, steps: int) -> float:
    return base * 0.5 * (1.0 + math.cos(math.pi * min(step, steps) / steps))


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()


def fast_steps(params: dict, spec: dict, bound: float, K, poses, images, grid, batches, lrs, bg: float,
               n_probes: int, k: int, table_dtype=torch.bfloat16, batch_filter=None) -> dict:
    """The witness of ``len(batches)`` steps from ``params`` (flat, f32):
    each step's loss, Adam's first moment after the last step (its norm per
    parameter) and each parameter's change. ``images`` [V, H*W, 3];
    ``batch_filter``: a planted fault's rewrite of a batch."""
    start = {n: t.detach() for n, t in params.items()}
    p = {n: t.detach().clone().requires_grad_() for n, t in params.items()}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    width = int(math.isqrt(images.shape[1]))
    losses = []
    for step, ((view, pix), lr) in enumerate(zip(batches, lrs), start=1):
        if batch_filter is not None:
            view, pix = batch_filter(view, pix)
        view = torch.as_tensor(np.asarray(view), device=images.device)
        pix = torch.as_tensor(np.asarray(pix), device=images.device)
        rays_o, rays_d = cameras.gl_rays(K, poses, view, pix, width)
        out = march.render(Field(p, spec, bound, table_dtype), rays_o, rays_d, grid, bg, n_probes=n_probes, k=k)
        loss = smooth_l1(out["rgb"], images[view, pix]) + EIKONAL_WEIGHT * out["eikonal"]
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        b1, b2 = BETAS
        with torch.no_grad():
            for (name, t), g in zip(p.items(), grads):
                m[name] = b1 * m[name] + (1 - b1) * g
                v[name] = b2 * v[name] + (1 - b2) * g * g
                denom = (v[name] / (1 - b2**step)).sqrt() + EPS
                t -= lr * (m[name] / (1 - b1**step)) / denom
    return {"losses": losses,
            "grad": {n: float(t.double().norm()) for n, t in m.items()},
            "change": {n: float((t.detach() - start[n]).double().norm()) for n, t in p.items()}}
