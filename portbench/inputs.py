"""The inputs of a run, made by the benchmark from ``--seed`` (never by the
program): seeds for the parts of a run, the field's initial parameters and
the reconstruction targets (100 views at 512x512 of a seeded procedural
body on black, on the orbit of smpl_da_512's cameras). The program and the
reference are handed the same tensors, which neither writes."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import cameras


def sub_seed(seed: int, part: str) -> int:
    """A 63-bit seed for one part of a run, from the run's seed and the
    part's name (any whole number, also past 32 bits)."""
    ss = np.random.SeedSequence([seed % 2**64, *part.encode()])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def generator(seed: int, part: str, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(sub_seed(seed, part))


def field_init(seed: int, spec: dict, device) -> dict:
    """The field's initial parameters for the configuration's ``field``
    group, in the program's tree (``sdf`` and ``color`` lists of layers
    {"v", "g"[, "b"]}, ``variance``, the pyramid's ``grids`` and
    ``planes``), from two draws on ``device``: NeuS's geometric init of the
    SDF MLP (hidden rows N(0, 2/out), the first layer's encoding columns 0,
    the last layer sqrt(pi/in) + 1e-4 N(0, 1), g the rows' norms, b 0), the
    color MLP U(+-1/sqrt(in)) with g the rows' norms, the tables U(+-1e-4),
    the deviation ``variance_init``."""
    pyr = spec["pyramid"]
    enc = len(pyr["grid_resolutions"]) * pyr["grid_dim"] + len(pyr["plane_resolutions"]) * pyr["plane_dim"]
    sdf_dims = [(spec["hidden_dim"] if l < spec["num_layers"] - 1 else 1 + spec["geo_feat_dim"],
                 enc + 3 if l == 0 else spec["hidden_dim"]) for l in range(spec["num_layers"])]
    color_dims = [(spec["hidden_dim_color"] if l < spec["num_layers_color"] - 1 else 3,
                   spec["geo_feat_dim"] + 6 if l == 0 else spec["hidden_dim_color"])
                  for l in range(spec["num_layers_color"])]
    tables = [(r, r, r, pyr["grid_dim"]) for r in pyr["grid_resolutions"]] + \
             [(3, r, r, pyr["plane_dim"]) for r in pyr["plane_resolutions"]]
    g = generator(seed, "field", device)
    normal = torch.randn(sum(o * i for o, i in sdf_dims), generator=g, device=device)
    uniform = torch.rand(sum(o * i for o, i in color_dims) + sum(math.prod(s) for s in tables), generator=g,
                         device=device)
    at = [0, 0]

    def take(flat, k, shape):
        n = math.prod(shape)
        out = flat[at[k]: at[k] + n].view(shape)
        at[k] += n
        return out

    sdf = []
    for l, (o, i) in enumerate(sdf_dims):
        z = take(normal, 0, (o, i))
        if l == len(sdf_dims) - 1:
            v = math.sqrt(math.pi) / math.sqrt(i) + 1e-4 * z
        else:
            v = z * (math.sqrt(2.0) / math.sqrt(o))
            if l == 0:
                v = torch.cat([v[:, :3], torch.zeros_like(v[:, 3:])], dim=1)
        sdf.append({"v": v, "g": v.norm(dim=1).clamp_min(1e-8), "b": torch.zeros(o, device=device)})
    color = []
    for o, i in color_dims:
        v = take(uniform, 1, (o, i)) * (2.0 / math.sqrt(i)) - 1.0 / math.sqrt(i)
        color.append({"v": v, "g": v.norm(dim=1)})
    grids = [take(uniform, 1, s) * 2e-4 - 1e-4 for s in tables[: len(pyr["grid_resolutions"])]]
    planes = [take(uniform, 1, s) * 2e-4 - 1e-4 for s in tables[len(pyr["grid_resolutions"]):]]
    return {"sdf": sdf, "color": color,
            "variance": torch.tensor(spec["variance_init"], dtype=torch.float32, device=device),
            "grids": grids, "planes": planes}


def recon_targets(seed: int, n_views: int, res: int, device):
    """(K, poses, images [V,H,W,3] f32 on ``device``): the views of a
    seeded body stand-in, an ellipsoid of a person's proportions in the
    canonical box, colored by smooth seeded waves over its surface, on
    black. The reconstruction step's work does not depend on the pixels."""
    K, poses = cameras.orbit_cameras(n_views, res)
    g = generator(seed, "targets", "cpu")
    radii = torch.tensor([0.32, 0.85, 0.18]) * (0.9 + 0.2 * torch.rand(3, generator=g))
    freq = 2.0 + 6.0 * torch.rand((3, 3), generator=g)
    phase = 2 * math.pi * torch.rand(3, generator=g)
    radii, freq, phase = radii.to(device), freq.to(device), phase.to(device)
    poses_t = torch.as_tensor(poses, device=device)
    pix = torch.arange(res * res, device=device)
    images = torch.empty((n_views, res, res, 3), dtype=torch.float32, device=device)
    for v in range(n_views):
        ro, rd = cameras.gl_rays(K, poses_t, torch.full_like(pix, v), pix, res)
        o, d = ro / radii, rd / radii  # the ellipsoid as the unit sphere
        a, b, c = (d * d).sum(-1), 2 * (o * d).sum(-1), (o * o).sum(-1) - 1.0
        disc = b * b - 4 * a * c
        t = (-b - torch.sqrt(disc.clamp_min(0.0))) / (2 * a)
        hit = (disc > 0) & (t > 0)
        p = ro + t[:, None] * rd
        rgb = 0.5 + 0.4 * torch.sin(p @ freq.T + phase)
        images[v] = torch.where(hit[:, None], rgb, torch.zeros_like(rgb)).reshape(res, res, 3)
    return K, poses, images
