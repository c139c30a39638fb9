"""Mesh export without external packages: a copy of ``save_ply`` from the
JAX package's utils/mesh_export.py (the reference writes through trimesh,
utils/utils.py:418-426). Binary little-endian PLY."""

from __future__ import annotations

import os

import numpy as np


def save_ply(vertices: np.ndarray, faces: np.ndarray, path: str) -> None:
    """Write vertices [V,3] (f32) and triangles [F,3] (int32) to ``path``."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(vertices)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    rec = np.zeros(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
    rec["n"] = 3
    rec["idx"] = faces
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(vertices.astype("<f4").tobytes())
        fh.write(rec.tobytes())
