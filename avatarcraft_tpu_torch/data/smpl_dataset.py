"""Blender-format multiview dataset of bare-SMPL renders: port of the JAX
package's data/smpl_dataset.py (reference: utils/SMPLDataset.py:10-165). It reads transforms_train.json and its PNGs (with the port's
stdlib reader: the card's machine has no imageio), derives the focal length
from camera_angle_x, keeps the images in host memory as float32 and makes
the rays of a view in the dataset's (OpenGL) camera convention.

The reference flips every image horizontally on load (``images[:, :, ::-1]``
reverses the W axis, utils/SMPLDataset.py:32); so does this loader, so that
renders compare pixel for pixel.

The training side: per-view rays, every (view, pixel) pair, host gathers of
a ray batch's ground truth, random rays of one view from an explicit numpy
generator (the JAX package's draw for draw), rays inside a dilated
silhouette (scipy's ndimage) and the unit-sphere bounds.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from avatarcraft_tpu_torch.cameras.rays import dataset_rays
from avatarcraft_tpu_torch.utils.png import read_png


class SMPLMultiviewDataset:
    def __init__(self, path: str):
        self.data_dir = path
        with open(os.path.join(path, "transforms_train.json")) as fp:
            meta = json.load(fp)

        images, poses = [], []
        for frame in meta["frames"]:
            images.append(read_png(os.path.join(path, frame["file_path"] + ".png")))
            poses.append(np.array(frame["transform_matrix"], np.float32))

        self.images = (np.array(images) / 255.0).astype(np.float32)
        self.images = self.images[:, :, ::-1].copy()  # horizontal flip, see the module doc
        self.masks = (self.images != 0).any(axis=-1).astype(np.float32)
        self.poses = np.stack(poses)

        self.n_images = len(self.images)
        self.H, self.W = self.images.shape[1:3]
        camera_angle_x = float(meta["camera_angle_x"])
        self.focal = 0.5 * self.W / np.tan(0.5 * camera_angle_x)
        self.K = np.array(
            [[self.focal, 0, 0.5 * self.W], [0, self.focal, 0.5 * self.H], [0, 0, 1]], np.float32
        )

    def gen_rays_pose(self, pose: np.ndarray, resolution_level: int = 1, device="cuda"):
        """Rays of a full view at the c2w ``pose``: ([hw,3], [hw,3]) on ``device``."""
        return dataset_rays(pose, self.K, self.H, self.W, resolution_level, device=device)

    def gen_rays_at(self, idx: int, resolution_level: int = 1, device="cuda"):
        """Rays of view ``idx`` (``gen_rays_pose`` of its pose)."""
        return self.gen_rays_pose(self.poses[idx], resolution_level, device)

    def all_pixels(self) -> tuple[np.ndarray, np.ndarray]:
        """(view_idx [M], pixel_idx [M]) int32 over every pixel of every view."""
        view = np.repeat(np.arange(self.n_images, dtype=np.int32), self.H * self.W)
        pix = np.tile(np.arange(self.H * self.W, dtype=np.int32), self.n_images)
        return view, pix

    def gather_rgb(self, view_idx: np.ndarray, pix_idx: np.ndarray) -> np.ndarray:
        """Ground-truth rgb of a ray batch, [M,3] (host)."""
        return self.images.reshape(self.n_images, -1, 3)[view_idx, pix_idx]

    def gather_mask(self, view_idx: np.ndarray, pix_idx: np.ndarray) -> np.ndarray:
        """Subject mask of a ray batch, [M] (host)."""
        return self.masks.reshape(self.n_images, -1)[view_idx, pix_idx]

    def gen_random_rays_at(self, idx: int, batch_size: int, rng: np.random.Generator, device="cuda"):
        """``batch_size`` random pixels of view ``idx`` drawn from ``rng`` (x
        first, then y, as the JAX package draws them) -> (rays_o, rays_d,
        rgb, mask) on ``device`` (reference: utils/SMPLDataset.py:128-147)."""
        px = rng.integers(0, self.W, batch_size)
        py = rng.integers(0, self.H, batch_size)
        rgb = self.images[idx][py, px]
        mask = self.masks[idx][py, px]
        K, pose = self.K, self.poses[idx]
        p = np.stack(
            [(px - K[0, 2]) / K[0, 0], -(py - K[1, 2]) / K[1, 1], -np.ones_like(px, np.float32)], axis=-1
        ).astype(np.float32)
        v = p / np.linalg.norm(p, axis=-1, keepdims=True)
        rays_d = v @ pose[:3, :3].T
        rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)
        return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device) for a in (rays_o, rays_d, rgb, mask))

    def gen_rays_silhouettes(self, pose, max_ray_num: int, mask: np.ndarray, device="cuda"):
        """Rays inside the subject's silhouette ``mask`` [H,W] dilated by 10
        (8-connected), on a square grid sized so that about ``max_ray_num``
        rays fall inside (reference: utils/SMPLDataset.py:58-84). Returns
        (rays_o, rays_d, side, keep [side, side] bool); an empty mask gives
        every ray of the view at resolution level 4."""
        from scipy import ndimage

        if mask.sum() == 0:
            ro, rd = self.gen_rays_pose(pose, resolution_level=4, device=device)
            side = self.H // 4
            return ro, rd, side, np.ones((side, side), bool)
        struct = ndimage.generate_binary_structure(2, 2)
        dilated = ndimage.binary_dilation(mask, structure=struct, iterations=10)
        ratio = dilated.sum() / float(mask.shape[0] * mask.shape[1])
        side = min(self.H, int(np.sqrt(max_ray_num / max(ratio, 1e-6))))
        ro, rd = dataset_rays(pose, self.K, self.H, self.W, device=device, out_hw=(side, side))
        ys = np.linspace(0, mask.shape[0] - 1, side).astype(int)
        xs = np.linspace(0, mask.shape[1] - 1, side).astype(int)
        keep = dilated[np.ix_(ys, xs)] > 0
        flat = torch.as_tensor(keep.reshape(-1), device=ro.device)
        return ro[flat], rd[flat], side, keep

    @staticmethod
    def near_far_from_sphere(rays_o: torch.Tensor, rays_d: torch.Tensor):
        """Unit-sphere chord bounds ([N,1], [N,1]) (reference:
        utils/SMPLDataset.py:149-160)."""
        a = torch.sum(rays_d**2, dim=-1, keepdim=True)
        b = 2.0 * torch.sum(rays_o * rays_d, dim=-1, keepdim=True)
        mid = 0.5 * (-b) / a
        return torch.clamp(mid - 1.0, min=0.0), mid + 1.0
