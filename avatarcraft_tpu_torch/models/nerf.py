"""The legacy vanilla NeRF. Port of the JAX package's models/nerf.py
(reference: models/nerf.py:18-261): an 8 x 256 density and color MLP over a
positional encoding (the identity frequency map, or the 45-degree rotated
Fourier basis of the reference's canonical space, models/nerf.py:45-59),
the classic ``raw2outputs`` compositing (reference:
utils/render_utils.py:213-250) and ``render_nerf_rays`` over evenly spaced
samples (reference: utils/render_utils.py:381-452).

The tree is the JAX package's: {"trunk": [{"w", "b"}, ...], "sigma",
"rgb"} and, with view directions, "feature" and "view"; weights [out, in].
The MLP products stay ``torch.matmul``: the JAX package computes them in
XLA, with no Pallas kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from avatarcraft_tpu_torch.ops.freq_encoder import freq_encode, freq_encode_dim, freq_encode_rotated
from avatarcraft_tpu_torch.ops.sampling import linspace


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    depth: int = 8
    width: int = 256
    skip_layer: int = 4
    multires: int = 10
    multires_view: int = 4
    use_viewdirs: bool = True
    mapping: str = "identity"  # or "rotate"

    @property
    def pos_dim(self) -> int:
        if self.mapping == "rotate":
            return 3 + 6 * self.multires  # reference: models/nerf.py:45-59
        return freq_encode_dim(self.multires)

    @property
    def view_dim(self) -> int:
        return freq_encode_dim(self.multires_view)


def _skip_after(l: int, cfg: NeRFConfig) -> bool:
    """Whether the encoding is concatenated after trunk layer ``l``: after
    ``skip_layer``, unless that is the last trunk layer (it would feed
    nothing)."""
    return l == cfg.skip_layer and l < cfg.depth - 1


def init_nerf_params(generator: torch.Generator, cfg: NeRFConfig) -> dict:
    """Every layer U(-1/sqrt(in), 1/sqrt(in)) with zero biases, drawn from
    ``generator`` on its device. The skip widens the layer after
    ``skip_layer`` by the encoding's width (the reference's skips=[4]
    concatenates after that layer). The tree, shapes and dtypes are the
    JAX package's; the random values are torch's."""
    dev = generator.device

    def linear(i, o):
        b = float(1.0 / np.sqrt(i))
        w = torch.rand((o, i), generator=generator, device=dev) * (2 * b) - b
        return {"w": w, "b": torch.zeros(o, device=dev)}

    trunk = []
    in_dim = cfg.pos_dim
    for l in range(cfg.depth):
        trunk.append(linear(in_dim, cfg.width))
        in_dim = cfg.pos_dim + cfg.width if _skip_after(l, cfg) else cfg.width
    params = {"trunk": trunk, "sigma": linear(cfg.width, 1)}
    if cfg.use_viewdirs:
        params["feature"] = linear(cfg.width, cfg.width)
        params["view"] = linear(cfg.width + cfg.view_dim, cfg.width // 2)
        params["rgb"] = linear(cfg.width // 2, 3)
    else:
        params["rgb"] = linear(cfg.width, 3)
    return params


def _encode(x: torch.Tensor, cfg: NeRFConfig) -> torch.Tensor:
    if cfg.mapping == "rotate":
        return freq_encode_rotated(x, cfg.multires)
    return freq_encode(x, cfg.multires)


def nerf_forward(params: dict, x: torch.Tensor, d: torch.Tensor | None, cfg: NeRFConfig) -> torch.Tensor:
    """[N,3] (and directions [N,3]) -> [N,4]: the rgb logits and the raw
    density."""
    enc = _encode(x, cfg)
    h = enc
    for l, layer in enumerate(params["trunk"]):
        h = torch.relu(h @ layer["w"].T + layer["b"])
        if _skip_after(l, cfg):
            h = torch.cat([enc, h], dim=-1)  # the reference's torch.cat([input_pts, h])
    sigma = h @ params["sigma"]["w"].T + params["sigma"]["b"]
    if cfg.use_viewdirs:
        if d is None:
            raise ValueError("use_viewdirs needs the view directions d")
        feat = h @ params["feature"]["w"].T + params["feature"]["b"]
        h = torch.cat([feat, freq_encode(d, cfg.multires_view)], dim=-1)
        h = torch.relu(h @ params["view"]["w"].T + params["view"]["b"])
    rgb = h @ params["rgb"]["w"].T + params["rgb"]["b"]
    return torch.cat([rgb, sigma], dim=-1)


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor, *, white_bkg: bool = True) -> dict:
    """Classic NeRF compositing of raw [N, T, 4] at depths z_vals [N, T]
    along rays_d [N, 3]: the last interval 1e10, every interval times
    |d|, the transmittance a cumprod of 1 - alpha + 1e-10, and with
    ``white_bkg`` the unfilled share added as white."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    rgb = torch.sigmoid(raw[..., :3])
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1), dim=-1)[..., :-1]
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10)
    if white_bkg:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return {"rgb": rgb_map, "disp": disp_map, "acc": acc_map, "weights": weights, "depth": depth_map}


def render_nerf_rays(
    params: dict,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    cfg: NeRFConfig,
    near: float = 1.0,
    far: float = 4.0,
    n_samples: int = 128,
    white_bkg: bool = True,
) -> dict:
    """``n_samples`` evenly spaced samples in [near, far] on every ray
    [N,3], through ``nerf_forward`` and ``raw2outputs`` (the reference's
    render_nerf_naive, utils/render_utils.py:381-452)."""
    N = rays_o.shape[0]
    t = linspace(0.0, 1.0, n_samples, rays_o.device)
    z_vals = (near * (1 - t) + far * t).expand(N, n_samples)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    dirs = rays_d[:, None, :].expand(pts.shape)
    raw = nerf_forward(params, pts.reshape(-1, 3), dirs.reshape(-1, 3), cfg).reshape(N, n_samples, 4)
    return raw2outputs(raw, z_vals, rays_d, white_bkg=white_bkg)
