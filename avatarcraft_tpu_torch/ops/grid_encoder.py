"""Multiscale spatial encoder: dense grid pyramid + triplanes, forward only.
Port of the JAX package's ops/grid_encoder.py:39-192.

Each (point, level) reads one cell-packed row holding the features of the
cell's corners (8 for a grid cell, 4 for a plane cell) and interpolates.
The tables are the bf16 packed tables of ``materialize_field_tables``.

bf16 semantics, matched bit for bit to the JAX package on the CPU: the
corner weights are rounded to bf16, each bf16 x bf16 product is exact in
f32, the corner sum runs in f32 and is rounded once to bf16; the three plane
orientations of a level are then summed in bf16, one rounding per add. The
features reach f32 only in ``forward_sdf``.

This is the plain version of the port's future kernel K3 (ROADMAP queue 2).
"""

from __future__ import annotations

import dataclasses

import torch

from avatarcraft_tpu_torch.ops.sampling import recip

_PLANE_AXES = ((0, 1), (0, 2), (1, 2))
_GRID_BITS = (
    [0, 1, 0, 1, 0, 1, 0, 1],
    [0, 0, 1, 1, 0, 0, 1, 1],
    [0, 0, 0, 0, 1, 1, 1, 1],
)


@dataclasses.dataclass(frozen=True)
class PyramidSpec:
    """Static configuration (defaults: the artifact's 32/64/128 grids and
    512/1024/2048 planes, 4 channels each: a 24-dim encoding)."""

    grid_resolutions: tuple[int, ...] = (32, 64, 128)
    grid_dim: int = 4
    plane_resolutions: tuple[int, ...] = (512, 1024, 2048)
    plane_dim: int = 4

    @property
    def output_dim(self) -> int:
        return (
            len(self.grid_resolutions) * self.grid_dim
            + len(self.plane_resolutions) * self.plane_dim
        )


def pack_grid(grid: torch.Tensor) -> torch.Tensor:
    """[R,R,R,C] -> [(R-1)^3, 8C]; row = the cell's 8 corners in corner-bit
    order (bit0=x, bit1=y, bit2=z)."""
    R, C = grid.shape[0], grid.shape[-1]
    corners = []
    for corner in range(8):
        bx, by, bz = corner & 1, (corner >> 1) & 1, (corner >> 2) & 1
        corners.append(grid[bx : bx + R - 1, by : by + R - 1, bz : bz + R - 1, :])
    return torch.cat(corners, dim=-1).reshape((R - 1) ** 3, 8 * C)


def pack_plane(plane: torch.Tensor) -> torch.Tensor:
    """[R,R,C] -> [(R-1)^2, 4C]; corner-bit order (bit0=u, bit1=v)."""
    R, C = plane.shape[0], plane.shape[-1]
    corners = []
    for corner in range(4):
        bu, bv = corner & 1, (corner >> 1) & 1
        corners.append(plane[bu : bu + R - 1, bv : bv + R - 1, :])
    return torch.cat(corners, dim=-1).reshape((R - 1) ** 2, 4 * C)


def materialize_packed(params: dict, spec: PyramidSpec, dtype=None) -> dict:
    """Cell-packed lookup tables, built once per frame and reused for every
    point batch. With ``dtype``, the tables are cast before packing, which
    gives the same values as packing then casting (packing only copies)."""

    def cast(t):
        return t if dtype is None else t.to(dtype)

    return {
        "grids": [pack_grid(cast(g)) for g in params["grids"]],
        "planes": [
            torch.stack([pack_plane(cast(p[i])) for i in range(3)]) for p in params["planes"]
        ],
    }


def _interp(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_c rows[:, c] * w[:, c] with the JAX package's bf16 rounding:
    weights cast to the table dtype, exact products, f32 sum, one rounding."""
    wt = w.to(rows.dtype).float()
    return (rows.float() * wt[:, :, None]).sum(dim=1).to(rows.dtype)


def _grid_lookup(packed: torch.Tensor, x01: torch.Tensor, R: int, C: int) -> torch.Tensor:
    """packed [(R-1)^3, 8C], x01 [N,3] in [0,1] -> [N,C] (trilinear)."""
    pos = x01.clamp(0.0, 1.0) * (R - 1)
    base = torch.floor(pos).clamp(0, R - 2)
    frac = pos - base
    b = base.to(torch.int64)
    idx = (b[:, 0] * (R - 1) + b[:, 1]) * (R - 1) + b[:, 2]
    rows = packed.index_select(0, idx).reshape(-1, 8, C)
    fx, fy, fz = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]
    wx = torch.cat([1 - fx, fx], dim=1)
    wy = torch.cat([1 - fy, fy], dim=1)
    wz = torch.cat([1 - fz, fz], dim=1)
    w = wx[:, _GRID_BITS[0]] * wy[:, _GRID_BITS[1]] * wz[:, _GRID_BITS[2]]
    return _interp(rows, w)


def _plane_lookup(packed3: torch.Tensor, uv: torch.Tensor, R: int, C: int, plane: int) -> torch.Tensor:
    """packed3 [3, (R-1)^2, 4C], uv [N,2] in [0,1] -> [N,C] (bilinear)."""
    pos = uv.clamp(0.0, 1.0) * (R - 1)
    base = torch.floor(pos).clamp(0, R - 2)
    frac = pos - base
    b = base.to(torch.int64)
    idx = b[:, 0] * (R - 1) + b[:, 1]
    rows = packed3[plane].index_select(0, idx).reshape(-1, 4, C)
    fu, fv = frac[:, 0:1], frac[:, 1:2]
    wu = torch.cat([1 - fu, fu], dim=1)
    wv = torch.cat([1 - fv, fv], dim=1)
    w = wu[:, [0, 1, 0, 1]] * wv[:, [0, 0, 1, 1]]
    return _interp(rows, w)


def pyramid_encode(packed: dict, x: torch.Tensor, spec: PyramidSpec, *, size: float = 1.0) -> torch.Tensor:
    """Encode positions ([..., 3] in [-size, size]) -> [..., output_dim] in
    the tables' dtype. The three plane orientations of a level are summed
    (K-planes additive variant)."""
    prefix = x.shape[:-1]
    x = x.reshape(-1, 3)
    x01 = (x + size) * recip(2.0 * size)
    feats = [
        _grid_lookup(g, x01, R, spec.grid_dim)
        for g, R in zip(packed["grids"], spec.grid_resolutions)
    ]
    for p3, R in zip(packed["planes"], spec.plane_resolutions):
        lvl = None
        for pi, axes in enumerate(_PLANE_AXES):
            f = _plane_lookup(p3, x01[:, list(axes)], R, spec.plane_dim, pi)
            lvl = f if lvl is None else lvl + f
        feats.append(lvl)
    return torch.cat(feats, dim=-1).reshape(*prefix, spec.output_dim)
