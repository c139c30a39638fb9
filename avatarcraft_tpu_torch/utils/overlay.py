"""Phong mesh-overlay debug renderer: a copy of the JAX package's
utils/overlay.py, which is numpy only (the port imports nothing of that
package). The reference overlays a Phong-shaded SMPL mesh on rendered
images through PyTorch3D (utils/render_utils.py:914-951: PerspectiveCameras,
PointLights((2,2,-2)), HardPhongShader, white vertex colors, composited over
the image); this is a small software rasterizer: barycentric bounding-box
rasterization with a z-buffer, smooth vertex normals and Blinn-Phong
shading, in the framework's OpenGL camera (-Z forward).
"""

from __future__ import annotations

import numpy as np


def _vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    n = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(n, 1e-12)


def rasterize_mesh(
    verts_world: np.ndarray,  # [V, 3]
    faces: np.ndarray,  # [F, 3] int
    c2w: np.ndarray,  # [4, 4] camera-to-world (OpenGL, -Z forward)
    K: np.ndarray,  # [3, 3] intrinsics
    H: int,
    W: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Z-buffer rasterization. Returns (face_id [H,W] int32 (-1 = miss),
    bary [H,W,3] float32, depth [H,W] float32 (+inf = miss))."""
    R = c2w[:3, :3]
    C = c2w[:3, 3]
    p_cam = (verts_world - C) @ R  # world -> camera (R columns orthonormal)
    z = -p_cam[:, 2]  # depth along the viewing axis
    z_safe = np.maximum(z, 1e-6)
    px = K[0, 0] * (p_cam[:, 0] / z_safe) + K[0, 2]
    py = -K[1, 1] * (p_cam[:, 1] / z_safe) + K[1, 2]
    pix = np.stack([px, py], axis=1)

    face_id = np.full((H, W), -1, np.int32)
    bary_buf = np.zeros((H, W, 3), np.float32)
    zbuf = np.full((H, W), np.inf, np.float32)

    tri = pix[faces]  # [F, 3, 2]
    tz = z[faces]  # [F, 3]
    front = (tz > 1e-6).all(axis=1)

    for f in np.nonzero(front)[0]:
        (x0, y0), (x1, y1), (x2, y2) = tri[f]
        xmin = max(int(np.floor(min(x0, x1, x2))), 0)
        xmax = min(int(np.ceil(max(x0, x1, x2))), W - 1)
        ymin = max(int(np.floor(min(y0, y1, y2))), 0)
        ymax = min(int(np.ceil(max(y0, y1, y2))), H - 1)
        if xmin > xmax or ymin > ymax:
            continue
        xs = np.arange(xmin, xmax + 1) + 0.5
        ys = np.arange(ymin, ymax + 1) + 0.5
        gx, gy = np.meshgrid(xs, ys)
        d = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        if abs(d) < 1e-12:
            continue
        w0 = ((y1 - y2) * (gx - x2) + (x2 - x1) * (gy - y2)) / d
        w1 = ((y2 - y0) * (gx - x2) + (x0 - x2) * (gy - y2)) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        # perspective-correct depth: interpolate 1/z
        inv_z = w0 / tz[f, 0] + w1 / tz[f, 1] + w2 / tz[f, 2]
        depth = 1.0 / np.maximum(inv_z, 1e-12)
        sub = (slice(ymin, ymax + 1), slice(xmin, xmax + 1))
        win = inside & (depth < zbuf[sub])
        zbuf[sub][win] = depth[win]
        face_id[sub][win] = f
        bary_buf[sub][win] = np.stack([w0, w1, w2], axis=-1)[win]
    return face_id, bary_buf, zbuf


def phong_render_mesh(
    verts_world: np.ndarray,
    faces: np.ndarray,
    c2w: np.ndarray,
    K: np.ndarray,
    H: int,
    W: int,
    light_pos=(2.0, 2.0, -2.0),  # reference: utils/render_utils.py:919
    color=(1.0, 1.0, 1.0),  # white vertex colors (reference :940)
    ambient: float = 0.3,
    diffuse: float = 0.7,
    specular: float = 0.2,
    shininess: float = 32.0,
) -> np.ndarray:
    """Blinn-Phong shaded render, [H, W, 4] float in [0, 1] (alpha = hit)."""
    verts_world = np.asarray(verts_world, np.float64)
    faces = np.asarray(faces, np.int64)
    face_id, bary, _ = rasterize_mesh(verts_world, faces, c2w, K, H, W)
    vn = _vertex_normals(verts_world, faces)

    out = np.zeros((H, W, 4), np.float32)
    hit = face_id >= 0
    if not hit.any():
        return out
    f = face_id[hit]
    b = bary[hit]  # [M, 3]
    pts = np.einsum("mk,mkc->mc", b, verts_world[faces[f]])
    nrm = np.einsum("mk,mkc->mc", b, vn[faces[f]])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)

    lp = np.asarray(light_pos, np.float64)
    ldir = lp - pts
    ldir /= np.maximum(np.linalg.norm(ldir, axis=1, keepdims=True), 1e-12)
    vdir = c2w[:3, 3] - pts
    vdir /= np.maximum(np.linalg.norm(vdir, axis=1, keepdims=True), 1e-12)
    # flip normals toward the camera (the mesh may have arbitrary winding)
    flip = (nrm * vdir).sum(1, keepdims=True) < 0
    nrm = np.where(flip, -nrm, nrm)

    ndl = np.clip((nrm * ldir).sum(1), 0.0, None)
    hvec = ldir + vdir
    hvec /= np.maximum(np.linalg.norm(hvec, axis=1, keepdims=True), 1e-12)
    spec = np.clip((nrm * hvec).sum(1), 0.0, None) ** shininess

    col = np.asarray(color, np.float32)
    shade = (
        ambient + diffuse * ndl[:, None]
    ) * col[None] + specular * spec[:, None]
    out[hit, :3] = np.clip(shade, 0.0, 1.0)
    out[hit, 3] = 1.0
    return out


def overlay_mesh(
    img: np.ndarray,  # [H, W, 3] uint8 or float in [0,1]
    verts_world: np.ndarray,
    faces: np.ndarray,
    c2w: np.ndarray,
    K: np.ndarray,
) -> np.ndarray:
    """Alpha-composite a Phong-shaded mesh over an image
    (reference: utils/render_utils.py:935-951 overlay_smpl). Returns uint8."""
    H, W = img.shape[:2]
    base = img.astype(np.float32) / (255.0 if img.dtype == np.uint8 else 1.0)
    rgba = phong_render_mesh(verts_world, faces, c2w, K, H, W)
    a = rgba[..., 3:4]
    out = rgba[..., :3] * a + base * (1.0 - a)
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)
