"""Iso-surface extraction from a dense scalar field on the host: a copy of
the JAX package's utils/marching_cubes.py. ``marching_cubes`` takes the
native extractor (utils/native.py, csrc/mesh_extract.cpp) by default; its
numpy body is the plain version (``prefer_native=False``).

The reference uses the external ``mcubes`` C extension
(reference: models/instant_nsr.py:758). Here we provide a self-contained,
fully vectorized marching-tetrahedra implementation: each grid cube is split
into 6 tetrahedra; each tetrahedron crossing the iso-level emits 1-2
triangles with linearly interpolated edge vertices. Produces a watertight
triangulation of the same level set (slightly denser than classic marching
cubes, identical geometry up to within-cell interpolation).
"""

from __future__ import annotations

import numpy as np

# The 6-tetrahedra (Kuhn) decomposition of a cube around the body diagonal
# 0-7. Cube corners indexed by bit pattern (x + 2y + 4z); each tet is a
# monotone lattice path 0 -> e -> e+f -> 7. This split is face-consistent
# across neighboring cubes (each shared face is cut along the same diagonal
# from both sides), which makes the extracted surface watertight.
_TETS = np.array(
    [
        [0, 1, 3, 7],
        [0, 1, 5, 7],
        [0, 2, 3, 7],
        [0, 2, 6, 7],
        [0, 4, 5, 7],
        [0, 4, 6, 7],
    ],
    dtype=np.int32,
)

# corner id -> (dx, dy, dz)
_CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [0, 1, 0],
        [1, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [0, 1, 1],
        [1, 1, 1],
    ],
    dtype=np.int32,
)

# Tetrahedron triangulation table: for each of the 16 sign configurations
# (bit i set = vertex i above iso), the edges (pairs of local tet vertices)
# forming up to 2 triangles. -1 padded. Edge order chosen for consistent
# outward orientation w.r.t. "above" region.
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_TET_TRI_TABLE = {
    0b0000: [],
    0b1111: [],
    0b0001: [[0, 2, 1]],
    0b1110: [[0, 1, 2]],
    0b0010: [[0, 3, 4]],
    0b1101: [[0, 4, 3]],
    0b0100: [[1, 5, 3]],
    0b1011: [[1, 3, 5]],
    0b1000: [[2, 4, 5]],
    0b0111: [[2, 5, 4]],
    0b0011: [[1, 2, 4], [1, 4, 3]],
    0b1100: [[1, 4, 2], [1, 3, 4]],
    0b0101: [[0, 2, 5], [0, 5, 3]],
    0b1010: [[0, 5, 2], [0, 3, 5]],
    0b0110: [[0, 1, 5], [0, 5, 4]],
    0b1001: [[0, 5, 1], [0, 4, 5]],
}


def marching_cubes(field: np.ndarray, iso: float = 0.0, prefer_native: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of ``field`` (shape [X, Y, Z]).

    Returns (vertices [V,3] in index coordinates, triangles [F,3] int32).
    Surface normals point toward the region where field > iso (matching
    ``mcubes.marching_cubes(-sdf, 0)`` conventions used by the reference).

    ``prefer_native``: the multithreaded native extractor, which raises if
    it does not build or load (no fallback); else this numpy body, the
    semantic reference of both (the same geometry, vertices in another
    order).
    """
    if prefer_native:
        from avatarcraft_tpu_torch.utils.native import native_marching_cubes

        return native_marching_cubes(field, iso)
    f = np.asarray(field, np.float64)
    X, Y, Z = f.shape
    if min(X, Y, Z) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # corner values for every cube: [8, X-1, Y-1, Z-1]
    cx, cy, cz = X - 1, Y - 1, Z - 1
    corner_vals = np.empty((8, cx, cy, cz), np.float64)
    for ci, (dx, dy, dz) in enumerate(_CORNERS):
        corner_vals[ci] = f[dx : dx + cx, dy : dy + cy, dz : dz + cz]

    base = np.stack(
        np.meshgrid(np.arange(cx), np.arange(cy), np.arange(cz), indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)  # [C,3]
    corner_vals = corner_vals.reshape(8, -1).T  # [C, 8]

    verts_out = []
    tris_out = []
    v_count = 0

    for tet in _TETS:
        # Kuhn tets alternate chirality; flip winding on negative-volume tets
        # so triangle orientation stays globally consistent.
        p = _CORNERS[tet].astype(np.float64)
        parity = np.linalg.det(p[1:] - p[0]) > 0
        tv = corner_vals[:, tet]  # [C,4]
        above = tv > iso
        config = (
            above[:, 0].astype(np.int32)
            + 2 * above[:, 1]
            + 4 * above[:, 2]
            + 8 * above[:, 3]
        )
        for cfg, tris in _TET_TRI_TABLE.items():
            if not tris:
                continue
            sel = np.nonzero(config == cfg)[0]
            if sel.size == 0:
                continue
            # interpolated vertex per referenced edge
            edge_ids = sorted({e for tri in tris for e in tri})
            edge_pos = {}
            for e in edge_ids:
                a, b = _TET_EDGES[e]
                va, vb = tv[sel, a], tv[sel, b]
                t = (iso - va) / (vb - va)
                pa = base[sel] + _CORNERS[tet[a]]
                pb = base[sel] + _CORNERS[tet[b]]
                edge_pos[e] = pa + t[:, None] * (pb - pa)
            local_index = {e: i for i, e in enumerate(edge_ids)}
            vstack = np.concatenate([edge_pos[e] for e in edge_ids], axis=0)
            verts_out.append(vstack)
            n_sel = sel.size
            for tri in tris:
                order = tri if parity else tri[::-1]
                idx = np.stack(
                    [
                        v_count + local_index[order[0]] * n_sel + np.arange(n_sel),
                        v_count + local_index[order[1]] * n_sel + np.arange(n_sel),
                        v_count + local_index[order[2]] * n_sel + np.arange(n_sel),
                    ],
                    axis=-1,
                )
                tris_out.append(idx)
            v_count += len(edge_ids) * n_sel

    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    verts = np.concatenate(verts_out, axis=0).astype(np.float32)
    tris = np.concatenate(tris_out, axis=0).astype(np.int32)

    # weld duplicate vertices (edges shared between tets/cubes)
    key = np.round(verts * 1e5).astype(np.int64)
    _, uniq_idx, inverse = np.unique(
        key.view([("x", np.int64), ("y", np.int64), ("z", np.int64)]).reshape(-1),
        return_index=True,
        return_inverse=True,
    )
    verts = verts[uniq_idx]
    tris = inverse[tris].astype(np.int32)
    # drop degenerate triangles created by welding
    ok = (
        (tris[:, 0] != tris[:, 1])
        & (tris[:, 1] != tris[:, 2])
        & (tris[:, 0] != tris[:, 2])
    )
    return verts, tris[ok]
