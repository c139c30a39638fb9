"""AMASS (SMPL+H) pose-sequence conversion (reference:
utils/convert_amass.py:4-17): keep the first 63 body-pose values, take every
``stride``-th frame, zero the hand joints, reshape to (N, 24, 3). numpy only;
a copy of the JAX package's data/amass.py."""

from __future__ import annotations

import numpy as np


def convert_amass_poses(poses: np.ndarray, stride: int = 10) -> np.ndarray:
    """poses: [N, >=66] SMPL+H axis-angle rows -> [N//stride, 24, 3]."""
    poses = np.asarray(poses)[::stride, :63].astype(np.float32)
    n = poses.shape[0]
    out = np.concatenate([poses, np.zeros((n, 9), np.float32)], axis=1)
    return out.reshape(n, 24, 3)


def convert_amass_file(npz_path: str, out_path: str, stride: int = 10) -> np.ndarray:
    data = np.load(npz_path)
    seq = convert_amass_poses(data["poses"], stride)
    with open(out_path, "wb") as fh:
        np.save(fh, seq)
    return seq


def load_pose_sequence(path: str) -> np.ndarray:
    """Load a converted pose sequence (.npy/.pkl with an [N,24,3] array)."""
    with open(path, "rb") as fh:
        return np.load(fh, allow_pickle=True).astype(np.float32)
