"""The density grid: its refresh from the SDF, bit-packed occupancy
probes, evenly spread sample selection and global compaction. Port of the
JAX package's ops/occupancy.py:23-72,192 and :206-319.

The probe, selection and compaction functions are the plain versions of the
port's future kernels K1 (probe + select) and K2 (compaction), ROADMAP
queue 2, and bit-exact against the JAX package
(tests/test_torch_occupancy.py). The refresh is K7's plain version.

The packed table is int32 (torch has no shift/and on uint32); the bit
pattern equals the JAX package's uint32 table word for word.
"""

from __future__ import annotations

import torch

from avatarcraft_tpu_torch.ops.sampling import linspace, recip


# the refresh's density sharpness and EMA-max decay (reference:
# models/instant_nsr.py:303-356)
INV_S = 512.0
DECAY = 0.95


def density_from_sdf(sdf: torch.Tensor) -> torch.Tensor:
    """The logistic density of NeuS, INV_S * sigmoid(-INV_S * sdf)
    (reference: models/instant_nsr.py:332-338)."""
    return INV_S * torch.sigmoid(-INV_S * sdf)


def init_density_grid(resolution: int = 129, device=None) -> torch.Tensor:
    """Zeros [R,R,R] (reference: models/instant_nsr.py:102)."""
    return torch.zeros((resolution,) * 3, dtype=torch.float32, device=device)


@torch.no_grad()
def update_density_grid(sdf_fn, grid: torch.Tensor, bound: float, *, block: int) -> torch.Tensor:
    """Refresh a [R,R,R] density grid from the SDF and EMA-max it with the
    old one: the density of every lattice point (``sdf_fn``: [N,3] -> [N],
    evaluated in x-slabs of ``block`` planes), a 2x max-pool with edge
    padding, then max(grid * DECAY, pooled) (reference:
    models/instant_nsr.py:303-356)."""
    R = grid.shape[0]
    if R % block:
        raise ValueError(f"slab height {block} does not divide the resolution {R}")
    xs = linspace(-bound, bound, R, grid.device)
    gy, gz = torch.meshgrid(xs, xs, indexing="ij")
    new = torch.empty_like(grid)
    for x0 in range(0, R, block):
        gx = xs[x0 : x0 + block][:, None, None].expand(block, R, R)
        pts = torch.stack([gx, gy.expand(block, R, R), gz.expand(block, R, R)], dim=-1)
        new[x0 : x0 + block] = density_from_sdf(sdf_fn(pts.reshape(-1, 3))).reshape(block, R, R)
    p = torch.cat([new, new[-1:]], dim=0)  # edge padding by one cell per axis
    p = torch.cat([p, p[:, -1:]], dim=1)
    p = torch.cat([p, p[:, :, -1:]], dim=2)
    pooled = torch.stack([
        p[dx : dx + R, dy : dy + R, dz : dz + R] for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)
    ]).amax(dim=0)
    return torch.maximum(grid * DECAY, pooled)


def pack_occupancy_bits(grid: torch.Tensor, threshold) -> torch.Tensor:
    """Pack ``grid > threshold`` of a [R,R,R] grid along z, 32 cells per
    word: [R*R*ceil(R/32)] int32, bit b of word (x, y, w) = cell
    (x, y, 32 w + b)."""
    R = grid.shape[0]
    z32 = (R + 31) // 32
    occ = (grid > threshold).to(torch.int64)
    occ = torch.nn.functional.pad(occ, (0, z32 * 32 - R))
    weights = torch.ones(32, dtype=torch.int64, device=grid.device) << torch.arange(
        32, dtype=torch.int64, device=grid.device
    )
    words = (occ.reshape(R, R, z32, 32) * weights).sum(dim=-1)
    # reinterpret the unsigned 32-bit word as int32 (two's complement)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).reshape(R * R * z32)


def occupancy_lookup_bits(packed: torch.Tensor, resolution: int, pts: torch.Tensor, bound: float) -> torch.Tensor:
    """Nearest-cell occupancy (bool, shape ``pts.shape[:-1]``) from a
    :func:`pack_occupancy_bits` table."""
    R = resolution
    z32 = (R + 31) // 32
    x01 = ((pts + bound) * recip(2 * bound)).clamp(0.0, 1.0)
    idx = torch.round(x01 * (R - 1)).to(torch.int64).clamp(0, R - 1)
    row = (idx[..., 0] * R + idx[..., 1]) * z32 + (idx[..., 2] >> 5)
    bit = idx[..., 2] & 31
    words = packed[row.reshape(-1)].reshape(row.shape)
    return ((words >> bit) & 1).bool()


def compact_indices(valid_flat: torch.Tensor, budget: int):
    """Deterministic stream compaction (the CUDA marcher's atomicAdd
    compaction, reference: raymarching.cu:156-221, as cumsum + scatter).

    Returns (sel [budget] int64 indices into the flat array, kept [T] bool).
    Entries beyond the budget are dropped in flat order; slots of ``sel``
    past the number of valid entries point at index 0.
    """
    T = valid_flat.shape[0]
    pos = torch.cumsum(valid_flat.to(torch.int64), dim=0) - 1
    kept = valid_flat & (pos < budget)
    write = torch.where(kept, pos, torch.full_like(pos, budget))  # sink slot
    idx = torch.arange(T, dtype=torch.int64, device=valid_flat.device)
    sel = torch.zeros(budget + 1, dtype=torch.int64, device=valid_flat.device)
    sel.index_put_((write,), idx)  # only the sink slot sees duplicates
    return sel[:budget], kept


def scatter_to_flat(vals: torch.Tensor, sel: torch.Tensor, total: int, n_valid_slots) -> torch.Tensor:
    """Inverse of the compaction gather: vals [budget, ...] back to their
    flat positions ([total, ...], zeros elsewhere). Slots at or past
    ``n_valid_slots`` go to a sink row that is dropped."""
    budget = sel.shape[0]
    slot_ok = torch.arange(budget, device=sel.device) < n_valid_slots
    dest = torch.where(slot_ok, sel, torch.full_like(sel, total))
    out = torch.zeros((total + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    out.index_put_((dest,), vals)
    return out[:total]


def select_occupied_samples(z_vals: torch.Tensor, occ: torch.Tensor, k: int, threshold):
    """k occupied probes per ray, evenly spaced across the occupied extent.

    z_vals [N, M] probe depths, occ [N, M] (bool, or densities compared with
    ``threshold``). Returns (z_sel [N, k], valid [N, k] bool), z-ordered.
    Rays with more than k occupied probes take the floor(f32((i+0.5) *
    n_occ / k))-th of them; rays with fewer use them all front to back and
    mask the remaining slots (the JAX package's ops/occupancy.py:286-319).
    """
    occupied = occ if occ.dtype == torch.bool else occ > threshold
    cum = torch.cumsum(occupied.to(torch.int64), dim=-1)  # [N, M]
    n_occ = cum[:, -1:]
    i = torch.arange(k, dtype=torch.int64, device=z_vals.device)[None, :]
    # the f32 product is truncated toward zero, as the JAX package does
    spread = ((i.float() + 0.5) * n_occ.float() * recip(k)).to(torch.int64)
    r = torch.where(n_occ > k, spread, torch.minimum(i, (n_occ - 1).clamp_min(0)))
    valid = i < n_occ
    # index of the (r+1)-th occupied probe = #{j : cum[j] < r+1}; cum is
    # non-decreasing, so a left binary search counts the same thing as the
    # JAX package's [N, M, k] comparison sum
    j = torch.searchsorted(cum, (r + 1).contiguous(), side="left").clamp(0, z_vals.shape[1] - 1)
    z_sel = torch.gather(z_vals, 1, j)
    return z_sel, valid
