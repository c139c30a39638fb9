"""Ray generation under the capture convention: +z forward, pixel directions
from K^-1 [x, y, 1] transformed by c2w (reference:
utils/render_utils.py:323-376), and the dataset cameras' rays. Port of the
JAX package's cameras/rays.py (``canonical_camera``, ``camera_rays``,
``pose2rays``, ``dataset_rays``, ``sparse_ray_sampling``)."""

from __future__ import annotations

import numpy as np
import torch

from avatarcraft_tpu_torch.cameras.camera import PinholeCamera
from avatarcraft_tpu_torch.constants import CANONICAL_ZOOM_FACTOR
from avatarcraft_tpu_torch.ops.sampling import linspace


def canonical_camera(h: int, w: int) -> PinholeCamera:
    """The canonical render camera: f = CANONICAL_ZOOM_FACTOR * W
    (reference: utils/render_utils.py:323-337)."""
    return PinholeCamera(w, h, CANONICAL_ZOOM_FACTOR * w, CANONICAL_ZOOM_FACTOR * w, w / 2.0, h / 2.0)


def camera_rays(cam: PinholeCamera, c2w, stride: int = 1, device="cuda"):
    """Rays for every pixel, row-major: (rays_o [h*w, 3], rays_d [h*w, 3])
    as float32 tensors on ``device``.

    pcd_2d_to_pcd_3d at depth 1 through K^-1, the c2w transform, then
    normalize(pt - center) (reference: utils/render_utils.py:363-376).
    """
    h, w = cam.height, cam.width
    ys, xs = torch.meshgrid(
        torch.arange(h, device=device), torch.arange(w, device=device), indexing="ij"
    )
    xs, ys = xs.float(), ys.float()
    if stride > 1:
        xs, ys = xs[::stride, ::stride], ys[::stride, ::stride]
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    px = (xs - cam.cx) / cam.fx
    py = (ys - cam.cy) / cam.fy
    pts_cam = torch.stack([px, py, torch.ones_like(px)], dim=-1)
    pts_world = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    center = c2w[:3, 3]
    dirs = pts_world - center
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origins = center.expand(dirs.shape).contiguous()
    return origins, dirs


def pose2rays(h: int, w: int, c2w, device="cuda"):
    """pose2cap + cap2rays fused: canonical camera at the given pose."""
    return camera_rays(canonical_camera(h, w), c2w, device=device)


def dataset_rays(pose, K, h: int, w: int, resolution_level: int = 1, device="cuda", out_hw=None):
    """Rays of a dataset camera, SMPLDataset.gen_rays_pose's convention
    (reference: utils/SMPLDataset.py:86-103): the pixel grid sampled with
    linspace(0, W-1, W // l), directions normalize([(x-cx)/fx, -(y-cy)/fy,
    -1]) rotated by pose[:3,:3]; ``out_hw`` (h', w') sets the sample grid's
    size instead (the silhouette sampler's square). Returns (rays_o [hw, 3],
    rays_d [hw, 3]) on ``device``."""
    if out_hw is not None:
        lh, lw = out_hw
    else:
        lh, lw = int(h // resolution_level), int(w // resolution_level)
    tx = linspace(0.0, w - 1, lw, device)
    ty = linspace(0.0, h - 1, lh, device)
    px, py = torch.meshgrid(tx, ty, indexing="xy")  # [lh, lw]
    K = torch.as_tensor(np.asarray(K, np.float32), device=device)
    pose = torch.as_tensor(np.asarray(pose, np.float32), device=device)
    p = torch.stack([(px - K[0, 2]) / K[0, 0], -(py - K[1, 2]) / K[1, 1], -torch.ones_like(px)], dim=-1)
    v = p / torch.linalg.norm(p, dim=-1, keepdim=True)
    rays_d = v @ pose[:3, :3].T
    rays_o = pose[:3, 3].expand(rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)


def sparse_ray_sampling(rays_o, rays_d, stride: int, rng: np.random.Generator):
    """Stride-subsample a [H, W, 3] ray grid from a random top-left offset
    (reference: utils/render_utils.py:989-1011), drawing the offsets from
    ``rng`` as the JAX package does (none at stride 1)."""
    if stride == 1:
        return rays_o, rays_d
    x_off = int(rng.integers(0, stride))
    y_off = int(rng.integers(0, stride))
    return (
        rays_o[x_off::stride, y_off::stride],
        rays_d[x_off::stride, y_off::stride],
    )
