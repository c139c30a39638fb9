"""The canonical NeuS field of AvatarCraft's fast configuration, written out
plainly for the benchmark: a pyramid of dense grids and triplanes read in
bfloat16, a weight-normalised SDF MLP with softplus (beta 100), a
bias-free ReLU color MLP and NeuS's deviation, the tetrahedral 4-tap
normals.

Parameters are one flat dict, name -> f32 tensor: ``grids.<i>``
[R,R,R,C], ``planes.<i>`` [3,R,R,C], ``sdf.<l>.v`` / ``.g`` / ``.b``,
``color.<l>.v`` / ``.g`` and ``variance``.

Precision as the configuration states it: the lookup tables hold bfloat16
values; each corner weight is a bfloat16 value, the products and the sum
over a cell's corners are f32, a level's feature is rounded to bfloat16 and
the three planes of a level add in bfloat16. Every rounding passes the
gradient through unrounded (``rounded``), so the backward is f32
throughout. The MLPs are f32.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

PLANE_AXES = ((0, 1), (0, 2), (1, 2))
TETRA = ((1.0, 1.0, 1.0), (1.0, -1.0, -1.0), (-1.0, 1.0, -1.0), (-1.0, -1.0, 1.0))


def rounded(x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """``x`` rounded to the values of ``dtype`` (None: unrounded), kept in
    f32; the gradient passes as if unrounded. ``r - x`` is exact for a
    rounding's neighbour, so the sum gives ``r`` itself."""
    if dtype is None:
        return x
    return x + (x.to(dtype).float() - x).detach()


def flat_params(tree, prefix: str = "") -> dict:
    """A nested parameter tree (dicts and lists, None skipped) as the flat
    dict of this module, names joined by dots."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {} if tree is None else {prefix[:-1]: tree}
    for k, v in items:
        out.update(flat_params(v, f"{prefix}{k}."))
    return out


def artifact_params(path: str, device) -> dict:
    """The flat parameters of an AvatarCraft field saved as a PyTorch state
    dict (``pyramid.*``, ``sdf_net.*``, ``color_net.*``,
    ``deviation_net.variance``), as f32 on ``device``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for key, t in state.items():
        parts = key.split(".")
        t = t.float()
        if parts[0] == "pyramid":
            name = f"{parts[1]}.{parts[2]}"
        elif parts[0] in ("sdf_net", "color_net"):
            kind = {"weight_v": "v", "weight_g": "g", "bias": "b"}[parts[2]]
            name = f"{parts[0][:-4]}.{parts[1]}.{kind}"
            t = t.reshape(-1) if kind == "g" else t
        elif key == "deviation_net.variance":
            name = "variance"
        else:
            raise ValueError(f"unknown key {key!r} in {path}")
        out[name] = t.to(device)
    return out


def count(params: dict, prefix: str) -> int:
    return len({k.split(".")[1] for k in params if k.startswith(prefix + ".")})


class Field:
    """The field of ``params`` (see the module's docstring); ``spec`` the
    configuration's ``field`` group; ``bound`` the half side of the cube.
    ``table_dtype``: the tables' stated precision (a control may lower it);
    ``matmul``: the MLPs' product."""

    def __init__(self, params: dict, spec: dict, bound: float, table_dtype=torch.bfloat16):
        if spec["encoder"] != "tpu_pyramid" or spec["use_viewdirs"] or not spec["include_input"]:
            raise ValueError("the plain field holds the pyramid encoder, xyz input and no view directions")
        self.p, self.spec, self.bound, self.dt = params, spec, bound, table_dtype
        self.n_grids = count(params, "grids")
        self.n_planes = count(params, "planes")
        self.n_sdf = count(params, "sdf")
        self.n_color = count(params, "color")
        self.scale = float(np.float32(1.0) / np.float32(2.0 * bound))

    def _cell(self, x01: torch.Tensor, R: int):
        pos = x01.clamp(0.0, 1.0) * (R - 1)
        lo = torch.floor(pos).clamp(0, R - 2)
        return lo.long(), pos - lo

    def _grid(self, g: torch.Tensor, x01: torch.Tensor) -> torch.Tensor:
        R = g.shape[0]
        i, f = self._cell(x01, R)
        acc = 0.0
        for bx, by, bz in itertools.product((0, 1), repeat=3):
            wx = f[:, 0:1] if bx else 1 - f[:, 0:1]
            wy = f[:, 1:2] if by else 1 - f[:, 1:2]
            wz = f[:, 2:3] if bz else 1 - f[:, 2:3]
            corner = g[i[:, 0] + bx, i[:, 1] + by, i[:, 2] + bz]
            acc = acc + rounded(wx * wy * wz, self.dt) * rounded(corner, self.dt)
        return rounded(acc, self.dt)

    def _plane(self, p: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
        R = p.shape[0]
        i, f = self._cell(uv, R)
        acc = 0.0
        for bu, bv in itertools.product((0, 1), repeat=2):
            wu = f[:, 0:1] if bu else 1 - f[:, 0:1]
            wv = f[:, 1:2] if bv else 1 - f[:, 1:2]
            acc = acc + rounded(wu * wv, self.dt) * rounded(p[i[:, 0] + bu, i[:, 1] + bv], self.dt)
        return rounded(acc, self.dt)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[N,3] in the cube -> [N, encoding] (f32 holding bfloat16 values)."""
        x01 = (x + self.bound) * self.scale
        feats = [self._grid(self.p[f"grids.{i}"], x01) for i in range(self.n_grids)]
        for i in range(self.n_planes):
            planes = self.p[f"planes.{i}"]
            level = None
            for k, (a, b) in enumerate(PLANE_AXES):
                f = self._plane(planes[k], torch.stack([x01[:, a], x01[:, b]], dim=1))
                level = f if level is None else rounded(level + f, self.dt)
            feats.append(level)
        return torch.cat(feats, dim=-1)

    def weight(self, kind: str, l: int) -> torch.Tensor:
        v, g = self.p[f"{kind}.{l}.v"], self.p[f"{kind}.{l}.g"]
        return v * (g[:, None] / v.norm(dim=1, keepdim=True))

    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        """[N,3] -> [N, 1 + features]."""
        h = torch.cat([x, self.encode(x)], dim=-1)
        for l in range(self.n_sdf):
            h = h @ self.weight("sdf", l).T + self.p[f"sdf.{l}.b"]
            if l < self.n_sdf - 1:
                h = F.softplus(h, beta=100.0)
        return h

    def color(self, x, normal, feat) -> torch.Tensor:
        h = torch.cat([x, normal, feat], dim=-1)
        for l in range(self.n_color):
            h = h @ self.weight("color", l).T
            if l < self.n_color - 1:
                h = torch.relu(h)
        return torch.sigmoid(h)

    def inv_s(self) -> torch.Tensor:
        return torch.clamp(torch.exp(self.p["variance"] * 10.0), 1e-6, 1e6)

    def fd4(self, x: torch.Tensor, eps: float):
        """(sdf [N], features [N,F], gradient [N,3]) by the tetrahedral
        stencil: the taps' mean and sum_i d_i f(x + eps d_i) / (4 eps), each
        tap clamped to the cube."""
        d = torch.tensor(TETRA, dtype=x.dtype, device=x.device)
        taps = [self.sdf(torch.clamp(x + eps * d[i], -self.bound, self.bound)) for i in range(4)]
        out = torch.stack(taps)  # [4, N, 1+F]
        grad = sum(d[i] * out[i, :, :1] for i in range(4)) / (4.0 * eps)
        return out[:, :, 0].mean(0), out[:, :, 1:].mean(0), grad
