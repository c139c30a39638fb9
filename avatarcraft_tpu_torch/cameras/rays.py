"""Ray generation under the capture convention: +z forward, pixel directions
from K^-1 [x, y, 1] transformed by c2w (reference:
utils/render_utils.py:323-376). Port of the JAX package's cameras/rays.py
(``canonical_camera``, ``camera_rays``, ``pose2rays``)."""

from __future__ import annotations

import numpy as np
import torch

from avatarcraft_tpu_torch.cameras.camera import PinholeCamera
from avatarcraft_tpu_torch.constants import CANONICAL_ZOOM_FACTOR


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
