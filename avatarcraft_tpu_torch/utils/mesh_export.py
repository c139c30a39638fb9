"""Mesh export and import without external packages: copies of
``save_ply`` and ``load_obj`` from the JAX package's utils/mesh_export.py
(the reference goes through trimesh and its own OBJ reader,
utils/utils.py:229-281, 418-426). Binary little-endian PLY."""

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


def load_obj(path: str):
    """A minimal OBJ reader (v / vt / f lines): (verts [V,3] f32, uvs [T,2]
    f32 or None, faces [F,3] int32 vertex indices, 0-based; the first three
    of a face's vertices)."""
    verts, uvs, faces = [], [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(t) for t in line.split()[1:3]])
            elif line.startswith("f "):
                faces.append([int(tok.split("/")[0]) - 1 for tok in line.split()[1:4]])
    return (
        np.asarray(verts, np.float32),
        np.asarray(uvs, np.float32) if uvs else None,
        np.asarray(faces, np.int32),
    )
