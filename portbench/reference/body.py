"""The posed body of an animation frame and the warp of its samples into
the canonical field, written out plainly for the benchmark (after
AvatarCraft's ``render_warp.py`` and ``utils/ray_utils.py``).

Linear blend skinning in f64: a joint's rotation by Rodrigues' formula,
the kinematic chain of rigid transforms about the rest joints (regressed
from the template), a vertex's transform the skinning-weight blend of its
joints'. A frame's transform of each vertex and joint is the pose's
composed with the inverse of the rest pose's, then scaled by 1/0.9 (the
reconstruction over the SMPL mesh); its posed vertices are that transform
of the rest vertices. Animation keeps the shape at zero, so no blend shape
enters.

The warp takes a posed point to the closest point of the posed mesh
(exact: every face that could be closer than the best found is tested),
blends the transforms of that face's corners by the closest point's
barycentric coordinates, and applies the blend's inverse; the point is
masked where its squared distance to the mesh is 0.05 or more.
"""

from __future__ import annotations

import numpy as np
import torch

SMPL_SCALE = 0.9
GEO_THRESHOLD = 0.05  # squared distance to the mesh below which a sample is on the body
CANDIDATES = 256  # faces tested exactly per point before the bound is checked


def load_rig(path: str) -> dict:
    data = np.load(path)
    return {k: data[k] for k in data.files}


def rodrigues(r: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(r))
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K


def joint_transforms(rig: dict, pose: np.ndarray):
    """(A [J,4,4], posed joints [J,3]) of ``pose`` [J,3] (axis-angle): A_j
    takes a rest-space point to where joint j's bone carries it."""
    joints = rig["J_regressor"].astype(np.float64) @ rig["v_template"].astype(np.float64)
    parents = rig["parents"]
    G = []
    for j in range(len(parents)):
        local = np.eye(4)
        local[:3, :3] = rodrigues(pose[j].astype(np.float64))
        local[:3, 3] = joints[j] - (joints[parents[j]] if parents[j] >= 0 else 0.0)
        G.append(local if parents[j] < 0 else G[parents[j]] @ local)
    G = np.stack(G)
    A = G.copy()
    A[:, :3, 3] -= np.einsum("jab,jb->ja", G[:, :3, :3], joints)
    return A, G[:, :3, 3]


def skinned(rig: dict, pose: np.ndarray):
    """(T [V+J,4,4]: the vertices' blended transforms then the joints',
    posed vertices [V,3], posed joints [J,3]) of ``pose``."""
    A, joints = joint_transforms(rig, pose)
    Tv = np.einsum("vj,jab->vab", rig["lbs_weights"].astype(np.float64), A)
    v = rig["v_template"].astype(np.float64)
    verts = np.einsum("vab,vb->va", Tv[:, :3, :3], v) + Tv[:, :3, 3]
    return np.concatenate([Tv, A]), verts, joints


def rest_pose(rig: dict, name: str) -> np.ndarray:
    """The pose the canonical field was made in: "zero", or "da" (the arms
    turned +-1 rad about z)."""
    pose = np.zeros((rig["J_regressor"].shape[0], 3))
    if name == "da":
        pose[1], pose[2] = [0, 0, 1.0], [0, 0, -1.0]
    elif name != "zero":
        raise ValueError(f"unknown rest pose {name!r}")
    return pose


def frame(rig: dict, pose: np.ndarray, rest: str):
    """(posed vertices [V,3] f32, transforms [V+J,4,4] f32) of one frame of
    ``pose`` ([>=J,3]; the first J joints are used)."""
    n_joints = rig["J_regressor"].shape[0]
    T_rest, v_rest, j_rest = skinned(rig, rest_pose(rig, rest))
    T_pose, _, _ = skinned(rig, np.asarray(pose, np.float64).reshape(-1, 3)[:n_joints])
    T = T_pose @ np.linalg.inv(T_rest)
    rest_all = np.concatenate([v_rest, j_rest])
    world = np.einsum("nab,nb->na", T[:, :3, :3], rest_all) + T[:, :3, 3]
    n_verts = rig["v_template"].shape[0]
    return world[:n_verts].astype(np.float32), (T / SMPL_SCALE).astype(np.float32)


def voxelize(verts: torch.Tensor, bound: float, R: int = 129, dilate: int = 2, value: float = 100.0):
    """[R,R,R] grid: ``value`` in the nearest cell of each vertex, grown by
    one cell in all 26 directions ``dilate`` times; 0 elsewhere."""
    scale = float(np.float32(1.0) / np.float32(2.0 * bound))
    i = torch.round((verts + bound) * scale * (R - 1)).long().clamp(0, R - 1)
    grid = torch.zeros((R, R, R), device=verts.device)
    grid[i[:, 0], i[:, 1], i[:, 2]] = value
    for _ in range(dilate):
        p = torch.nn.functional.pad(grid, (1, 1, 1, 1, 1, 1))
        grid = torch.stack([p[a:a + R, b:b + R, c:c + R] for a in range(3) for b in range(3) for c in range(3)]).amax(0)
    return grid


def closest_on_triangles(p, a, b, c):
    """(squared distance [...], barycentric [..., 3]) of the closest point
    of each triangle (a, b, c) to p: the plane's foot where it falls inside
    the triangle, else the nearest of the three edges' closest points."""
    tiny = torch.finfo(p.dtype).tiny
    n = torch.linalg.cross(b - a, c - a)
    nn = (n * n).sum(-1, keepdim=True)
    q = p - ((p - a) * n).sum(-1, keepdim=True) / nn.clamp_min(tiny) * n
    # barycentric coordinates of the foot from the sub-triangles' signed areas
    u = (torch.linalg.cross(b - q, c - q) * n).sum(-1) / nn[..., 0].clamp_min(tiny)
    v = (torch.linalg.cross(c - q, a - q) * n).sum(-1) / nn[..., 0].clamp_min(tiny)
    w = 1.0 - u - v
    inside = (u >= 0) & (v >= 0) & (w >= 0) & (nn[..., 0] > 0)
    best_d = torch.where(inside, ((p - q) ** 2).sum(-1), torch.inf)
    best = torch.stack([u, v, w], dim=-1)
    for (s, e), (i, j) in (((a, b), (0, 1)), ((b, c), (1, 2)), ((c, a), (2, 0))):
        se = e - s
        t = (((p - s) * se).sum(-1) / (se * se).sum(-1).clamp_min(tiny)).clamp(0.0, 1.0)
        d = ((s + t[..., None] * se - p) ** 2).sum(-1)
        bary = torch.zeros_like(best)
        bary[..., i], bary[..., j] = 1.0 - t, t
        better = d < best_d
        best_d = torch.where(better, d, best_d)
        best = torch.where(better[..., None], bary, best)
    return best_d, best


class Warp:
    """posed points [M,3] -> (canonical points [M,3] f32, mask [M]) for one
    frame's posed vertices, faces and vertex transforms. ``dtype``: the
    geometry's precision (f64; a control lowers it)."""

    def __init__(self, verts, faces, Ts, device, dtype=torch.float64, block: int = 2048):
        self.dtype, self.block = dtype, block
        self.verts = torch.as_tensor(verts, device=device).to(dtype)
        self.faces = torch.as_tensor(np.asarray(faces, np.int64), device=device)
        self.T = torch.as_tensor(Ts[: verts.shape[0]], device=device).to(torch.float64)
        tri = self.verts[self.faces]  # [F, 3, 3]
        self.tri = tri
        t64 = tri.double()
        self.centre = t64.mean(1)
        self.radius = (t64 - self.centre[:, None]).norm(dim=-1).amax(1)

    def _closest(self, p):
        """(squared distance [B], face [B], barycentric [B,3]) of the closest
        face of the mesh to each point; where that distance is the
        threshold or more (a masked point), of a face at least that far."""
        # no point of a face is nearer than its centre's distance less its radius
        dc = torch.cdist(p.double(), self.centre, compute_mode="donot_use_mm_for_euclid_dist")  # [B, F]
        lb = (dc - self.radius[None]).clamp_min(0.0)
        k = min(CANDIDATES, lb.shape[1] - 1)
        lbk, cand = torch.topk(lb, k + 1, dim=1, largest=False)
        best_d, face, best_b = self._among(p, cand[:, :k])
        # where an untested face could be nearer, and near enough to count, test them all
        unsure = (lbk[:, k] ** 2 < torch.clamp(best_d.double(), max=GEO_THRESHOLD)).nonzero()[:, 0]
        every = torch.arange(self.tri.shape[0], device=p.device)
        for s in range(0, unsure.shape[0], 64):
            rows = unsure[s:s + 64]
            d, f, b = self._among(p[rows], every.expand(rows.shape[0], -1))
            best_d[rows], face[rows], best_b[rows] = d, f, b
        return best_d, face, best_b

    def _among(self, p, cand):
        """The nearest of the faces ``cand`` [B, C] to each point."""
        tri = self.tri[cand]
        d, bary = closest_on_triangles(p[:, None], tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])
        i = d.argmin(1)
        rows = torch.arange(p.shape[0], device=p.device)
        return d[rows, i], cand[rows, i], bary[rows, i]

    def __call__(self, pts: torch.Tensor):
        out, mask = [], []
        for s in range(0, pts.shape[0], self.block):
            p = pts[s: s + self.block].to(self.dtype)
            d, face, bary = self._closest(p)
            T = (self.T[self.faces[face]] * bary.to(torch.float64)[:, :, None, None]).sum(1)  # [B,4,4]
            ph = torch.cat([p.to(torch.float64), torch.ones_like(p[:, :1], dtype=torch.float64)], dim=1)
            can = (torch.linalg.inv(T) @ ph[:, :, None])[:, :3, 0]
            out.append(can.to(self.dtype).float())
            mask.append(d < GEO_THRESHOLD)
        if not out:
            return pts.new_zeros((0, 3)), torch.zeros(0, dtype=torch.bool, device=pts.device)
        return torch.cat(out), torch.cat(mask)
