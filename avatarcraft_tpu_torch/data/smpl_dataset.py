"""Blender-format multiview dataset of bare-SMPL renders: the loader part of
the JAX package's data/smpl_dataset.py (reference: utils/SMPLDataset.py:
10-165). It reads transforms_train.json and its PNGs (with the port's
stdlib reader: the card's machine has no imageio), derives the focal length
from camera_angle_x, keeps the images in host memory as float32 and makes
the rays of a view in the dataset's (OpenGL) camera convention.

The reference flips every image horizontally on load (``images[:, :, ::-1]``
reverses the W axis, utils/SMPLDataset.py:32); so does this loader, so that
renders compare pixel for pixel. The training-side samplers (random rays,
silhouettes, sphere bounds) come with the reconstruction CLI (ROADMAP item
12).
"""

from __future__ import annotations

import json
import os

import numpy as np

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
