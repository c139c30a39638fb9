"""Cameras and rays, written out plainly for the benchmark: AvatarCraft's
orbit camera (NeRF's ``pose_spherical`` in its capture convention, +z
forward and y down), the canonical render camera (focal 1000/1280 of the
width, centred), and the dataset's OpenGL cameras (-z forward, y up),
whose pixel (x, y) looks along normalize([(x - cx)/fx, -(y - cy)/fy, -1])."""

from __future__ import annotations

import math

import numpy as np
import torch

ZOOM = 1000 / 1280  # the canonical camera's focal length over the image width
SMPL_SCALE = 0.9  # the reconstruction's size over the SMPL mesh's
TRAIN_DISTANCE = 2.0 * SMPL_SCALE  # the training views' camera distance
CAPTURE_TO_GL = np.diag([1.0, -1.0, -1.0, 1.0])


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Camera-to-world [4,4] (f64) of the orbit camera at azimuth
    ``theta`` and elevation ``phi`` degrees, ``radius`` from the origin,
    looking at it (capture convention)."""
    th, ph = math.radians(theta), math.radians(phi)
    trans = np.eye(4)
    trans[2, 3] = radius
    rot_phi = np.eye(4)
    rot_phi[1:3, 1:3] = [[math.cos(ph), -math.sin(ph)], [math.sin(ph), math.cos(ph)]]
    rot_theta = np.eye(4)
    rot_theta[[0, 0, 2, 2], [0, 2, 0, 2]] = [math.cos(th), -math.sin(th), math.sin(th), math.cos(th)]
    swap = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float64)
    return swap @ rot_theta @ rot_phi @ trans @ CAPTURE_TO_GL


def canonical_rays(h: int, w: int, c2w: np.ndarray, device):
    """(rays_o, rays_d) [h*w, 3] f32 of the canonical camera at ``c2w``,
    row-major: through pixel (x, y) the direction of c2w's rotation of
    [(x - w/2)/f, (y - h/2)/f, 1], normalized."""
    f = ZOOM * w
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    cam = torch.stack([(xs - w / 2.0) / f, (ys - h / 2.0) / f, torch.ones_like(xs)], dim=-1).reshape(-1, 3)
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    d = cam @ c2w[:3, :3].T
    d = d / d.norm(dim=-1, keepdim=True)
    return c2w[:3, 3].expand(d.shape), d


def gl_rays(K: np.ndarray, poses: torch.Tensor, view: torch.Tensor, pix: torch.Tensor, width: int):
    """(rays_o, rays_d) [B,3] of the dataset's pixels ``pix`` (row-major
    indices) in views ``view``."""
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))
    y = torch.div(pix, width, rounding_mode="floor").float()
    x = (pix % width).float()
    p = torch.stack([(x - cx) / fx, -(y - cy) / fy, -torch.ones_like(x)], dim=-1)
    p = p / p.norm(dim=-1, keepdim=True)
    pose = poses[view]
    return pose[:, :3, 3], (pose[:, :3, :3] @ p[:, :, None])[:, :, 0]


def orbit_cameras(n_views: int, res: int):
    """(K [3,3] f32, poses [n,4,4] f32) of the reconstruction's views: n
    around the body at the training distance, elevations between -20 and
    35 degrees, in the dataset's OpenGL convention."""
    f = ZOOM * res
    K = np.array([[f, 0, res / 2], [0, f, res / 2], [0, 0, 1]], np.float32)
    poses = np.stack([
        (pose_spherical(360.0 * i / n_views, 27.5 * np.sin(0.7 * i) + 7.5, TRAIN_DISTANCE) @ CAPTURE_TO_GL)
        for i in range(n_views)
    ]).astype(np.float32)
    return K, poses
