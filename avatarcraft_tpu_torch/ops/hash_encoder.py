"""Multiresolution hash-grid encoder (instant-NGP): port of the JAX
package's ops/hash_encoder.py (``HashGridSpec``, ``init_hash_table``,
``_corner_indices``, ``pack_dense_cells``, ``hash_encode``; reference:
encoder/hashencoder/src/hashencoder.cu:36-219, hashgrid.py:80-143).

One flat table ``[total_params, level_dim]`` with per-level offsets: dense
indexing on the coarse levels, XOR-prime hashing on the fine ones,
trilinear interpolation over each cell's 8 corners, zero features for
points outside the cube. The backward is the deterministic scatter-add of
``ops.grid_encoder.lookup_rows``.

The port has one formulation, the JAX package's "leveled" one (a lookup
per level, with the dense levels' cell-packed tables when given); the JAX
"flat" layout is the same numbers gathered another way (a TPU speed choice).

Hashing runs in int64 where the JAX package wraps uint32 products: the
coordinates are at most 2049, so the products stay below 2^43, and only
the low bits survive ``% 2^log2_hashmap_size``, which are the same bits
the uint32 products keep. This is the plain version of the port's future
kernel K8 (ROADMAP queue 2).
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property

import numpy as np
import torch

from avatarcraft_tpu_torch.ops.grid_encoder import lookup_rows
from avatarcraft_tpu_torch.ops.sampling import device_constant, recip

# XOR-hash primes (reference: encoder/hashencoder/src/hashencoder.cu:43)
_PRIMES = (1, 2654435761, 805459861)
# corner c's offset along axis d is bit d of c (bit0 = x, bit1 = y, bit2 = z)
_CORNER_BITS = [[(c >> d) & 1 for d in range(3)] for c in range(8)]


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static configuration of the hash grid. Defaults follow the
    reference instant-NSR config (reference: models/instant_nsr.py:505-515):
    16 levels x 2 dims, base resolution 16, 2^19-entry tables, finest
    resolution 2048."""

    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: int | None = 2048
    per_level_scale: float = 2.0

    def __post_init__(self):
        if self.desired_resolution is not None:
            # desired_resolution overrides per_level_scale
            # (reference: encoder/hashencoder/hashgrid.py:84-85)
            scale = float(
                np.exp2(np.log2(self.desired_resolution / self.base_resolution) / (self.num_levels - 1))
            )
            object.__setattr__(self, "per_level_scale", scale)

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @cached_property
    def level_constants(self):
        """Per-level (scales, resolutions, offsets, sizes, use_hash): the
        table layout of hashgrid.py:99-112 and the index math of
        hashencoder.cu:121-123 and :54-70."""
        max_params = 2**self.log2_hashmap_size
        scales, resolutions, offsets, sizes, use_hash = [], [], [0], [], []
        s_log2 = math.log2(self.per_level_scale)
        for lvl in range(self.num_levels):
            scale = math.exp2(lvl * s_log2) * self.base_resolution - 1.0
            resolution = int(math.ceil(scale)) + 1
            params_in_level = min(max_params, (resolution + 1) ** self.input_dim)
            scales.append(scale)
            resolutions.append(resolution)
            sizes.append(params_in_level)
            use_hash.append((resolution + 1) ** self.input_dim > params_in_level)
            offsets.append(offsets[-1] + params_in_level)
        return tuple(scales), tuple(resolutions), tuple(offsets), tuple(sizes), tuple(use_hash)

    @property
    def total_params(self) -> int:
        return self.level_constants[2][-1]


def init_hash_table(generator: torch.Generator, spec: HashGridSpec) -> torch.Tensor:
    """U(-1e-4, 1e-4) f32 table drawn from ``generator`` on its device
    (reference: encoder/hashencoder/hashgrid.py:119-121)."""
    u = torch.rand((spec.total_params, spec.level_dim), generator=generator, device=generator.device)
    return u * 2e-4 - 1e-4


def _corner_indices(spec: HashGridSpec, lvl: int, corners: torch.Tensor) -> torch.Tensor:
    """Row indices into level ``lvl``'s slice of the table of integer grid
    coordinates ``corners`` [..., 3] int64: XOR-prime hash
    (hashencoder.cu:36-51) or dense x + y r1 + z r1^2 (:54-64), then
    ``% size`` (the JAX package adds the level's offset for its flat
    layout). Negative coordinates (points outside the cube, whose features
    are zeroed) still give indices in range: torch's ``%`` of an int64 by a
    positive size is non-negative."""
    _, resolutions, _, sizes, use_hash = spec.level_constants
    x, y, z = corners.unbind(-1)
    if use_hash[lvl]:
        idx = (x * _PRIMES[0]) ^ (y * _PRIMES[1]) ^ (z * _PRIMES[2])
    else:
        r1 = resolutions[lvl] + 1
        idx = x + y * r1 + z * (r1 * r1)
    return idx % sizes[lvl]


def pack_dense_cells(table: torch.Tensor, spec: HashGridSpec) -> dict:
    """{level: [R^3, 8C]} for the dense levels: row ``cell`` (x-major, cell
    = bx R^2 + by R + bz) holds the cell's 8 corner rows in corner-bit
    order, so the encoder reads one row per (point, dense level). A dense
    level's table slice is the [r1, r1, r1, C] lattice (z, y, x), so the
    packing is 8 shifted slices (the JAX package gathers them; the values
    are the same copies). Hashed levels cannot be packed: the XOR hash
    scatters a cell's corners."""
    _, resolutions, offsets, _, use_hash = spec.level_constants
    C = spec.level_dim
    packed = {}
    for lvl in range(spec.num_levels):
        if use_hash[lvl]:
            continue
        R = resolutions[lvl]
        lattice = table[offsets[lvl] : offsets[lvl + 1]].reshape(R + 1, R + 1, R + 1, C)
        corners = [lattice[dz : dz + R, dy : dy + R, dx : dx + R] for dx, dy, dz in _CORNER_BITS]
        packed[lvl] = torch.cat(corners, dim=-1).permute(2, 1, 0, 3).reshape(R**3, 8 * C)
    return packed


def _corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """[N, 8] trilinear weights, the product over x, y, z in that order."""
    fx, fy, fz = frac.unbind(-1)
    w = []
    for bx, by, bz in _CORNER_BITS:
        w.append((fx if bx else 1.0 - fx) * (fy if by else 1.0 - fy) * (fz if bz else 1.0 - fz))
    return torch.stack(w, dim=-1)


def hash_encode(
    table: torch.Tensor,
    x: torch.Tensor,
    spec: HashGridSpec,
    *,
    size: float = 1.0,
    packed_cells: dict | None = None,
) -> torch.Tensor:
    """Encode positions ``x`` [..., 3] in [-size, size] -> [...,
    num_levels * level_dim] in the table's dtype, zero where a coordinate
    falls outside the cube (hashencoder.cu:94-119). ``packed_cells``:
    ``pack_dense_cells`` of the table, read on the dense levels."""
    if spec.input_dim != 3:
        raise NotImplementedError("hash_encode supports 3-D inputs")
    prefix = x.shape[:-1]
    x = x.reshape(-1, 3)
    x01 = (x + size) * recip(2.0 * size)
    scales, resolutions, offsets, _, _ = spec.level_constants
    N, C = x01.shape[0], spec.level_dim
    oob = ((x01 < 0.0) | (x01 > 1.0)).any(dim=-1)
    bits = device_constant(tuple(map(tuple, _CORNER_BITS)), torch.int64, x.device)
    outs = []
    for lvl in range(spec.num_levels):
        # pos = x * scale + 0.5 (hashencoder.cu:127-131)
        pos = x01 * float(np.float32(scales[lvl])) + 0.5
        pos_floor = torch.floor(pos)
        w = _corner_weights(pos - pos_floor).to(table.dtype)
        base = pos_floor.to(torch.int64)
        if packed_cells is not None and lvl in packed_cells:
            R = resolutions[lvl]
            cell = (base[:, 0] * R + base[:, 1]) * R + base[:, 2]
            cell = torch.where(oob, 0, cell)  # outside the cube: any row, zeroed below
            rows = lookup_rows(packed_cells[lvl], cell).reshape(N, 8, C)
        else:
            # one lookup per level, into the level's slice: its backward
            # sorts this level's indices only
            idx = _corner_indices(spec, lvl, base[:, None, :] + bits)
            tbl = table[offsets[lvl] : offsets[lvl + 1]]
            rows = lookup_rows(tbl, idx.reshape(-1)).reshape(N, 8, C)
        outs.append((rows * w[:, :, None]).sum(dim=1))
    out = torch.stack(outs, dim=1)
    out = torch.where(oob[:, None, None], torch.zeros((), dtype=out.dtype, device=out.device), out)
    return out.reshape(*prefix, spec.output_dim)
