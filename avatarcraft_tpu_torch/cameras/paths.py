"""Spherical orbit camera-path generators (host-side numpy), a copy of the
JAX package's cameras/paths.py.

Reproduces the reference path construction exactly (reference:
utils/render_utils.py:38-76 for pose_spherical, :137-154 default_360_path,
:157-209 style_360_path, :80-90 describe_view), returning plain 4x4
camera-to-world matrices. The noise draws come from a
``numpy.random.Generator`` in the JAX package's order, so one seed gives
the same poses in both packages.
"""

from __future__ import annotations

import numpy as np


def _trans_t(t: float) -> np.ndarray:
    m = np.eye(4)
    m[2, 3] = t
    return m


def _rot_phi(phi: float) -> np.ndarray:
    m = np.eye(4)
    c, s = np.cos(phi), np.sin(phi)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _rot_theta(th: float) -> np.ndarray:
    m = np.eye(4)
    c, s = np.cos(th), np.sin(th)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


def _rotation_matrix(angle: float, axis: np.ndarray) -> np.ndarray:
    """Homogeneous rotation about ``axis`` by ``angle`` (Rodrigues)."""
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.eye(4)
    a = axis / n
    c, s = np.cos(angle), np.sin(angle)
    K = np.array(
        [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]], dtype=np.float64
    )
    R = c * np.eye(3) + s * K + (1 - c) * np.outer(a, a)
    m = np.eye(4)
    m[:3, :3] = R
    return m


def _translation_matrix(v: np.ndarray) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = v
    return m


def _angle_between(v0: np.ndarray, v1: np.ndarray) -> float:
    dot = np.dot(v0, v1) / (np.linalg.norm(v0) * np.linalg.norm(v1))
    return float(np.arccos(np.clip(dot, -1.0, 1.0)))


def pose_spherical(
    theta: float,
    phi: float,
    radius: float,
    add_noise: bool = False,
    noise_scale: float = 1.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """One orbit camera-to-world matrix (reference: utils/render_utils.py:57-76).

    Noise augmentation: radius += U(-0.2, 0)*s, phi += U(-15, 15)*s,
    theta += N(0, 1)*s.
    """
    if add_noise:
        rng = rng or np.random.default_rng()
        radius = radius + rng.uniform(-0.2, 0.0) * noise_scale
        phi = phi + rng.uniform(-15.0, 15.0) * noise_scale
        theta = theta + rng.normal(0.0, 1.0) * noise_scale

    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = (
        np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.float64)
        @ c2w
    )
    transf = np.diag([1.0, -1.0, -1.0, 1.0])
    return (c2w @ transf).astype(np.float64)


def describe_view(angles: np.ndarray, body_part: str = "body") -> list[str]:
    """View-dependent prompt prefixes (reference: utils/render_utils.py:80-90)."""
    descs = []
    for angle in np.atleast_1d(angles):
        if -180 <= angle <= -150 or 150 <= angle <= 180:
            descs.append(f"front view of the {body_part} of the")
        elif -30 <= angle <= 30:
            descs.append(f"back view of the {body_part} of the")
        else:
            descs.append(f"side view of the {body_part} of the")
    return descs


def _orbit_frame(center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """trans(center) @ rot aligning +z to ``up`` (utils/render_utils.py:142-146)."""
    up2 = np.array([0.0, 0.0, 1.0])
    axis = np.cross(up, up2)
    angle = _angle_between(up, up2)
    rot = _rotation_matrix(-angle, axis)
    return _translation_matrix(np.asarray(center, np.float64)) @ rot


def default_360_path(
    center,
    up,
    dist: float,
    res: int = 40,
    rad: float = 360.0,
    add_noise: bool = False,
    rng: np.random.Generator | None = None,
):
    """Uniform orbit (reference: utils/render_utils.py:137-154).

    Returns (poses [res,4,4] c2w, view descriptions).
    """
    frame = _orbit_frame(np.asarray(center), np.asarray(up))
    angles = np.linspace(-rad / 2, rad / 2, res + 1)[:-1]
    poses = np.stack(
        [frame @ pose_spherical(a, 0.0, dist, add_noise, 1.0, rng) for a in angles]
    )
    return poses.astype(np.float32), describe_view(angles)


def style_360_path(
    center,
    up,
    dist: float,
    res: int = 40,
    rad: float = 360.0,
    add_noise: bool = False,
    noise_scale: float = 1.0,
    style_head: bool = False,
    head_offset: float = 0.0,
    body_part: str = "body",
    head_rate: float = 0.0,
    head_dist: float = 0.5,
    rng: np.random.Generator | None = None,
):
    """Front/back-biased orbit + optional head-box cameras
    (reference: utils/render_utils.py:157-209).

    Returns (poses [n,4,4], descs [n]) where the tail of the list holds the
    head cameras when ``style_head``.
    """
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    frame = _orbit_frame(center, up)

    style_angles = np.concatenate(
        [
            np.linspace(-180, -120, res // 4),
            np.linspace(120, 180, res // 4),
            np.linspace(-60, 60, res // 2),
        ]
    )
    poses = [
        frame @ pose_spherical(a, 0.0, dist, add_noise, noise_scale, rng)
        for a in style_angles
    ]
    descs = describe_view(style_angles, body_part)

    if style_head and head_rate > 0.0:
        n_head = int(res * head_rate)
        head_frame = _orbit_frame(center + up * head_offset, up)
        head_angles = np.concatenate(
            [
                np.linspace(-180, -120, n_head // 2),
                np.linspace(120, 180, n_head // 2),
            ]
        )
        # head cameras always carry noise (reference: render_utils.py:202)
        poses += [
            head_frame @ pose_spherical(a, 0.0, head_dist, True, 1.0, rng)
            for a in head_angles
        ]
        descs += describe_view(head_angles, "face")

    return np.stack(poses).astype(np.float32), descs
