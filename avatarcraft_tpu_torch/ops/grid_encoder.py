"""Multiscale spatial encoder: dense grid pyramid + triplanes. Port of the
JAX package's ops/grid_encoder.py:39-192. Autograd runs through it: the
backward of a row lookup (``lookup_rows``) is a deterministic scatter-add
into the packed table, and the packing's backward adds each corner's
gradient back into the tables.

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


def init_pyramid_params(generator: torch.Generator, spec: PyramidSpec) -> dict:
    """U(-1e-4, 1e-4) tables (the NGP tables' scale), drawn from
    ``generator`` on its device: grids [R,R,R,C], planes [3,R,R,C]."""

    def uniform(shape):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return u * 2e-4 - 1e-4

    return {
        "grids": [uniform((r, r, r, spec.grid_dim)) for r in spec.grid_resolutions],
        "planes": [uniform((3, r, r, spec.plane_dim)) for r in spec.plane_resolutions],
    }


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
    """Cell-packed lookup tables, built once per frame or train step and
    reused for every point batch, cast to ``dtype`` when given.

    Packing only copies, so casting before or after packing gives the same
    values. Without autograd the tables are cast first (fewer bytes to
    pack). With autograd they are packed in f32 and then cast, as the JAX
    package does, so that the packing's backward adds the corners'
    gradients in f32 as JAX's does."""
    grad = torch.is_grad_enabled()

    def pack(fn, t):
        if dtype is None:
            return fn(t)
        return fn(t).to(dtype) if grad else fn(t.to(dtype))

    return {
        "grids": [pack(pack_grid, g) for g in params["grids"]],
        "planes": [
            torch.stack([pack(pack_plane, p[i]) for i in range(3)]) for p in params["planes"]
        ],
    }


def scatter_rows(idx: torch.Tensor, grad: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The transpose of ``table.index_select(0, idx)``: [n_rows, D] f32,
    row r the sum of the rows of ``grad`` ([M, D]) whose ``idx`` is r.

    Deterministic on every device, and the same on the card and the CPU:
    the sums are exact integer sums, which no order of the adds changes.
    Each cotangent is rounded to a multiple of 2^-k, k the largest that
    keeps M x max|grad| x 2^k within 2^62 (an error of at most M x
    max|grad| x 2^-63 per cotangent: 1e-12 x max|grad| at M = 2^23); the
    integers are added into int64 rows (``index_add_``, atomics on the
    card), and each row's exact sum is rounded once to f32 (then scaled by
    2^-k, exactly). Non-finite cotangents make the whole result
    non-finite. The JAX package's scatter-add is deterministic too
    (ops/hash_encoder.py:11-14); PyTorch's float index_add on a CUDA
    tensor adds with atomics, in another order every run."""
    out_shape = (n_rows,) + tuple(grad.shape[1:])
    if grad.shape[0] == 0:
        return torch.zeros(out_shape, dtype=torch.float32, device=grad.device)
    g = grad.double()
    top = g.abs().amax().clamp_min(1e-300) * grad.shape[0]
    k = 62.0 - torch.ceil(torch.log2(top))  # a device scalar: no read of the device
    q = torch.round(torch.ldexp(g, k)).to(torch.int64)
    acc = torch.zeros(out_shape, dtype=torch.int64, device=grad.device).index_add_(0, idx, q)
    return acc.to(torch.float32).mul_(torch.exp2(-k).to(torch.float32))


class _RowLookup(torch.autograd.Function):
    """``table.index_select(0, idx)`` whose backward is ``scatter_rows``,
    rounded once to the table's dtype. Forward-mode AD and vmap (the
    analytic normals) see a linear gather of the table's tangent."""

    generate_vmap_rule = True

    @staticmethod
    def forward(table, idx):
        return table.index_select(0, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, idx = inputs
        ctx.save_for_backward(idx)
        ctx.idx, ctx.n_rows, ctx.dtype = idx, table.shape[0], table.dtype

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return scatter_rows(idx, grad, ctx.n_rows).to(ctx.dtype), None

    @staticmethod
    def jvp(ctx, table_t, idx_t):
        return table_t.index_select(0, ctx.idx)


def lookup_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` ([M] int64) of ``table`` ([n_rows, D]), with the
    deterministic backward of ``_RowLookup``. The plain version of the
    port's future kernel K3's backward (ROADMAP queue 2)."""
    return _RowLookup.apply(table, idx)


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
    rows = lookup_rows(packed, idx).reshape(-1, 8, C)
    fx, fy, fz = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]
    wx = torch.cat([1 - fx, fx], dim=1)
    wy = torch.cat([1 - fy, fy], dim=1)
    wz = torch.cat([1 - fz, fz], dim=1)
    # corner c = bit0 x + 2 bit1 y + 4 bit2 z: broadcasts, not index lists
    # (a list index is a host-to-device copy, which a CUDA graph cannot hold)
    w = (wx[:, None, None, :] * wy[:, None, :, None] * wz[:, :, None, None]).reshape(-1, 8)
    return _interp(rows, w)


def _plane_lookup(packed3: torch.Tensor, uv: torch.Tensor, R: int, C: int, plane: int) -> torch.Tensor:
    """packed3 [3, (R-1)^2, 4C], uv [N,2] in [0,1] -> [N,C] (bilinear)."""
    pos = uv.clamp(0.0, 1.0) * (R - 1)
    base = torch.floor(pos).clamp(0, R - 2)
    frac = pos - base
    b = base.to(torch.int64)
    idx = b[:, 0] * (R - 1) + b[:, 1]
    rows = lookup_rows(packed3[plane], idx).reshape(-1, 4, C)
    fu, fv = frac[:, 0:1], frac[:, 1:2]
    wu = torch.cat([1 - fu, fu], dim=1)
    wv = torch.cat([1 - fv, fv], dim=1)
    w = (wu[:, None, :] * wv[:, :, None]).reshape(-1, 4)  # corner c = bit0 u + 2 bit1 v
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
            f = _plane_lookup(p3, torch.stack([x01[:, a] for a in axes], dim=1), R, spec.plane_dim, pi)
            lvl = f if lvl is None else lvl + f
        feats.append(lvl)
    return torch.cat(feats, dim=-1).reshape(*prefix, spec.output_dim)


def pyramid_encode_unpacked(params: dict, x: torch.Tensor, spec: PyramidSpec, *, size: float = 1.0) -> torch.Tensor:
    """``pyramid_encode`` of the tables packed on the fly, in their own
    dtype (the JAX package's convenience wrapper, ops/grid_encoder.py:188,
    for tests and small calls)."""
    return pyramid_encode(materialize_packed(params, spec), x, spec, size=size)
