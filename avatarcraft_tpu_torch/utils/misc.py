"""Small parity helpers (the reference's utils/utils.py and
utils/debug_utils.py), a port of the JAX package's utils/misc.py:13-66."""

from __future__ import annotations

import functools
import os
import pickle
import random
import time

import numpy as np
import torch


def fix_randomness(seed: int = 42) -> np.random.Generator:
    """Seed Python's, numpy's and torch's global generators (the
    reference: utils/utils.py:48-68) and return a numpy Generator seeded
    ``seed`` for the host-side schedule decisions to thread through. The
    port's own random draws take explicit generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)


def smpl_verts_to_center_and_up(verts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The scene's center and up axis from the SMPL vertices by SVD (the
    reference: utils/utils.py:327-346): the dominant direction of the
    centered point cloud, turned to +y (canonical humans stand along +y)."""
    verts = np.asarray(verts)
    center = verts.mean(axis=0)
    _, _, vt = np.linalg.svd(verts - center, full_matrices=False)
    up = vt[0]
    if up[1] < 0:
        up = -up
    return center.astype(np.float32), (up / np.linalg.norm(up)).astype(np.float32)


def print_notification(content, title: str = "NOTIFICATION") -> None:
    """Print ``content`` (a line or a list of lines) under a titled rule
    (the reference: utils/utils.py:32-41)."""
    if isinstance(content, str):
        content = [content]
    print("-" * 60)
    print(f"[{title}]")
    for line in content:
        print(line)
    print("-" * 60)


def dump_tensor(obj, path: str) -> None:
    """Pickle ``obj`` for debugging, an array or tensor as a numpy array
    (the reference: utils/debug_utils.py:34-41)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    elif hasattr(obj, "shape"):
        obj = np.asarray(obj)
    with open(path, "wb") as fh:
        pickle.dump(obj, fh)


def log_exec(fn):
    """Print the wall seconds of each call of ``fn`` (the reference:
    utils/debug_utils.py:53-58)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        print(f"[log_exec] {fn.__qualname__}: {time.perf_counter() - t0:.3f}s")
        return out

    return wrapper
