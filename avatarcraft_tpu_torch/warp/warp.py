"""Posed-space -> canonical-space sample warping, on the samples' device.
Port of the JAX package's warp/warp.py (reference: utils/ray_utils.py:62-90,
which sends every batch to the CPU for libigl point-to-mesh queries):

1. **nearest vertices** -- a [block, V] squared-distance matrix
   ``|p|^2 + |v|^2 - 2 p.v`` (one matrix product against the posed
   vertices), top-k over the vertex axis;
2. **candidate faces** -- a per-topology vertex -> incident-face table
   (built once on the host) gathers k x max-valence candidate triangles;
3. **exact point-triangle closest point** (Ericson's region algorithm) over
   the candidates, the first minimum taken: closest face, closest point,
   barycentric coordinates;
4. **transform blend** -- the barycentric blend of the corners' 4x4
   canonical->posed transforms, inverted in closed form and applied
   (reference math: utils/ray_utils.py:76-82);
5. canonical ray directions by finite differences along the ray
   (reference: utils/ray_utils.py:86-88) and the ``dist^2 < threshold``
   alpha mask (reference: utils/ray_utils.py:74).

``geometry_guided_near_far`` bounds each ray of an animation frame by the
spheres around the posed vertices (reference: utils/ray_utils.py:277-294).

This is the plain version of the port's future warp kernel K6 (ROADMAP
queue 2). The point axis runs in blocks of ``block`` points, so one
[block, V] distance matrix (200 MB at 4096 x 12,256 in f32) is alive at a
time, never the [M, V] matrix of a whole chunk.

The distance cancels badly in low precision: under TF32 the top-k vertices
change. The warp therefore refuses to run while
``torch.backends.cuda.matmul.allow_tf32`` is on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from avatarcraft_tpu_torch.constants import DEFAULT_GEO_THRESH

# nearest vertices whose incident faces are the candidates: the true closest
# face can only be missed when all three of its corners are outside the k
# nearest, which k >= 4 rules out on meshes of well-shaped triangles
K_VERTS = 4


def build_vertex_face_table(faces: np.ndarray, n_verts: int) -> np.ndarray:
    """[V, K] face indices incident to each vertex, padded with the vertex's
    first face (so gathers stay in bounds and duplicates are harmless)."""
    faces = np.asarray(faces)
    incident: list[list[int]] = [[] for _ in range(n_verts)]
    for f_idx, tri in enumerate(faces[:, :3]):
        for v in tri:
            incident[int(v)].append(f_idx)
    K = max((len(l) for l in incident), default=1)
    table = np.zeros((n_verts, K), np.int32)
    for v, l in enumerate(incident):
        if not l:
            l = [0]
        table[v] = (l + [l[0]] * K)[:K]
    return table


@dataclasses.dataclass(frozen=True)
class WarpData:
    """One animation frame's warp inputs, on one device."""

    verts: torch.Tensor  # [V, 3] posed vertices (world space), f32
    faces: torch.Tensor  # [F, 3] int64
    Ts: torch.Tensor  # [V(+J), 4, 4] per-vertex canonical->posed transforms, f32
    vert2face: torch.Tensor  # [V, K] int64 incident-face table

    @classmethod
    def create(cls, verts, faces, Ts, device="cuda") -> "WarpData":
        """From host arrays (numpy): the posed vertices, the faces and the
        transforms of one frame."""
        verts = np.asarray(verts, np.float32)
        faces = np.asarray(faces)[:, :3].astype(np.int64)
        table = build_vertex_face_table(faces, verts.shape[0])
        return cls(
            verts=torch.as_tensor(verts, device=device),
            faces=torch.as_tensor(faces, device=device),
            Ts=torch.as_tensor(np.array(Ts, np.float32), device=device),
            vert2face=torch.as_tensor(table.astype(np.int64), device=device),
        )


def closest_point_on_triangles(p, a, b, c):
    """Exact closest point on triangle(s) (Ericson, RTCD 5.1.5).

    p, a, b, c: broadcastable [..., 3]. Returns (closest [..., 3],
    barycentric [..., 3] = (u, v, w) with closest = u*a + v*b + w*c).
    """
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = torch.sum(ab * ap, -1)
    d2 = torch.sum(ac * ap, -1)
    bp = p - b
    d3 = torch.sum(ab * bp, -1)
    d4 = torch.sum(ac * bp, -1)
    cp = p - c
    d5 = torch.sum(ab * cp, -1)
    d6 = torch.sum(ac * cp, -1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    eps = 1e-12

    def safe(x):
        return torch.where(torch.abs(x) < eps, 1.0, x)

    # interior (default)
    denom = va + vb + vc
    v = vb / safe(denom)
    w = vc / safe(denom)

    # edge BC region
    t_bc = (d4 - d3) / safe((d4 - d3) + (d5 - d6))
    in_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    v = torch.where(in_bc, 1.0 - t_bc, v)
    w = torch.where(in_bc, t_bc, w)

    # edge AC region
    t_ac = d2 / safe(d2 - d6)
    in_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    v = torch.where(in_ac, 0.0, v)
    w = torch.where(in_ac, t_ac, w)

    # edge AB region
    t_ab = d1 / safe(d1 - d3)
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    v = torch.where(in_ab, t_ab, v)
    w = torch.where(in_ab, 0.0, w)

    # vertex regions (highest priority)
    in_c = (d6 >= 0) & (d5 <= d6)
    v = torch.where(in_c, 0.0, v)
    w = torch.where(in_c, 1.0, w)
    in_b = (d3 >= 0) & (d4 <= d3)
    v = torch.where(in_b, 1.0, v)
    w = torch.where(in_b, 0.0, w)
    in_a = (d1 <= 0) & (d2 <= 0)
    v = torch.where(in_a, 0.0, v)
    w = torch.where(in_a, 0.0, w)

    u = 1.0 - v - w
    closest = u[..., None] * a + v[..., None] * b + w[..., None] * c
    return closest, torch.stack([u, v, w], dim=-1)


def _closest_face_block(pts: torch.Tensor, data: WarpData, tri_packed: torch.Tensor):
    """For a [B,3] block: (dist2 [B], f_id [B], closest [B,3], bary [B,3]).

    ``tri_packed``: [F, 9] per-face corner coordinates in one row, built
    once per call, so a candidate triangle is one 9-wide row gather."""
    verts = data.verts
    # [B, V] squared distances through one matrix product
    d2 = torch.sum(pts**2, -1, keepdim=True) - 2.0 * pts @ verts.T + torch.sum(verts**2, -1)[None, :]
    # the set of the k nearest matters, not their order among ties
    knn_idx = torch.topk(d2, K_VERTS, dim=-1, largest=False).indices  # [B, k]
    del d2

    B = pts.shape[0]
    cand = data.vert2face[knn_idx].reshape(B, -1)  # [B, k*K] candidate faces (duplicates harmless)
    tri = tri_packed[cand].reshape(B, cand.shape[1], 3, 3)  # [B, C, 3, 3]
    closest, bary = closest_point_on_triangles(pts[:, None, :], tri[:, :, 0], tri[:, :, 1], tri[:, :, 2])
    cd2 = torch.sum((closest - pts[:, None, :]) ** 2, -1)  # [B, C]
    best = torch.argmin(cd2, dim=-1, keepdim=True)  # the first minimum, as JAX takes it
    rows = torch.arange(B, device=pts.device)
    return (
        cd2.gather(1, best)[:, 0],
        cand.gather(1, best)[:, 0],
        closest[rows, best[:, 0]],
        bary[rows, best[:, 0]],
    )


def _require_full_f32() -> None:
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the warp's nearest-vertex search needs full f32 matrix products; "
            "torch.backends.cuda.matmul.allow_tf32 is on (TF32 changes the top-k vertices)"
        )


def warp_samples_to_canonical(
    pts: torch.Tensor,
    data: WarpData,
    threshold: float = DEFAULT_GEO_THRESH,
    *,
    block: int = 4096,
):
    """Warp posed-space samples into the canonical field.

    Args:
        pts: [num_rays, num_samples, 3] posed-space points.
        data: the frame's WarpData, on the points' device.
        threshold: squared-distance alpha-mask threshold (the reference
            compares dist^2 with DEFAULT_GEO_THRESH = 0.05 directly,
            reference: utils/ray_utils.py:74).

    Returns (can_pts [N,T,3], can_dirs [N,T,3], closest [N,T,3], mask [N,T]).
    """
    _require_full_f32()
    N, T, _ = pts.shape
    flat = pts.reshape(-1, 3)
    M = flat.shape[0]

    # per-call packed rows, one per face: one wide gather per candidate
    tri_packed = data.verts[data.faces.reshape(-1)].reshape(-1, 9)  # [F, 9]
    parts = [_closest_face_block(flat[i : i + block], data, tri_packed) for i in range(0, M, block)]
    d2, f_id, closest, bary = (torch.cat(p) for p in zip(*parts))

    mask = d2 < threshold

    # the barycentric blend of the corner transforms, then the inverse.
    # Every T has the bottom row [0, 0, 0, s] (rigid chains, possibly scaled
    # uniformly by SMPL_SCALE, reference: render_warp.py:200-204), so the
    # blend has it too and the homogeneous inverse-apply has the closed form
    #   (T^-1 [p;1])[:3] = A^-1 (p - t/s),  A = T[:3,:3], t = T[:3,3],
    # with A^-1 from the 3x3 cofactors
    T_packed = data.Ts[data.faces.reshape(-1)].reshape(-1, 48)  # [F, 48]
    corner_T = T_packed[f_id].reshape(M, 3, 4, 4)
    T_interp = torch.sum(corner_T * bary[:, :, None, None], dim=1)  # [M,4,4]
    A = T_interp[:, :3, :3]
    s = T_interp[:, 3:4, 3]
    t = T_interp[:, :3, 3] / torch.where(torch.abs(s) < 1e-20, 1.0, s)
    r0, r1, r2 = A[:, 0], A[:, 1], A[:, 2]
    c12, c20, c01 = torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0), torch.linalg.cross(r0, r1)
    det = torch.sum(r0 * c12, dim=-1, keepdim=True)
    inv_a = torch.stack([c12, c20, c01], dim=-1) / torch.where(torch.abs(det) < 1e-20, 1.0, det)[..., None]
    can = torch.einsum("mij,mj->mi", inv_a, flat - t)

    can_pts = can.reshape(N, T, 3)
    can_dirs = can_pts[:, 1:] - can_pts[:, :-1]
    can_dirs = torch.cat([can_dirs, can_dirs[:, -1:]], dim=1)
    # sqrt(sum + eps): finite where consecutive warped points coincide
    can_dirs = can_dirs / torch.sqrt(torch.sum(can_dirs * can_dirs, dim=2, keepdim=True) + 1e-12)
    return can_pts, can_dirs, closest.reshape(N, T, 3), mask.reshape(N, T)


def make_warp_fn(data: WarpData, threshold: float = DEFAULT_GEO_THRESH):
    """The ``warp_fn`` of render_rays and render_rays_fast: [N,T,3] ->
    (pts, dirs, mask)."""

    def warp_fn(pts):
        can_pts, can_dirs, _, mask = warp_samples_to_canonical(pts, data, threshold)
        return can_pts, can_dirs, mask

    return warp_fn


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in f32 with one rounding: the f32 product is exact in f64."""
    return (a.double() * b.double() + c.double()).float()


def geometry_guided_near_far(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    verts: torch.Tensor,
    geo_threshold: float = DEFAULT_GEO_THRESH,
    *,
    block: int = 1024,
):
    """The slab test of every ray against a sphere of radius
    ``geo_threshold`` around every vertex (reference:
    utils/ray_utils.py:277-294): (near [N,1], far [N,1]), the first entry
    and last exit over the spheres the ray hits; +inf and -inf where it
    hits none (render_rays falls back to the cube bounds there,
    models/instant_nsr.py:152-153).

    The discriminant r^2 - (|o - v|^2 - z0^2) cancels: its terms are the
    squared distance to the vertex (about 6 at the training distance), its
    result up to r^2 = 0.0025. Each of z0 = (v - o).d, |v - o|^2 and the
    difference is therefore a chain of fused multiply-adds, one rounding
    each, as XLA computes the JAX package's expression; plain f32 products
    and sums move a bound by up to 1e-4. The projection is an elementwise
    product and sum, never a matrix product that TF32 could round.

    The vertex axis runs in blocks of ``block``, so one [N, block] set of
    intermediates is alive at a time, never [N, V] (1.2 GB each at 8192 rays
    against 12,256 vertices); min and max are exact in any order, so the
    result is bitwise the unblocked one."""
    near = torch.full((rays_o.shape[0], 1), torch.inf, device=rays_o.device)
    far = torch.full((rays_o.shape[0], 1), -torch.inf, device=rays_o.device)
    d = rays_d[:, None, :]
    for v0 in range(0, verts.shape[0], block):
        ov = verts[None, v0 : v0 + block, :] - rays_o[:, None, :]  # [N, B, 3]
        z0 = _fma(ov[..., 2], d[..., 2], _fma(ov[..., 1], d[..., 1], ov[..., 0] * d[..., 0]))
        sq = _fma(ov[..., 2], ov[..., 2], _fma(ov[..., 1], ov[..., 1], ov[..., 0] * ov[..., 0]))
        disc = geo_threshold**2 - _fma(-z0, z0, sq)
        dz = torch.sqrt(torch.clamp_min(disc, 0.0))
        hit = disc >= 0.0
        near = torch.minimum(near, torch.where(hit, z0 - dz, torch.inf).amin(dim=1, keepdim=True))
        far = torch.maximum(far, torch.where(hit, z0 + dz, -torch.inf).amax(dim=1, keepdim=True))
    return near, far
