"""Cameras and rays of the PyTorch port against the JAX package, on the CPU.

Tolerance: camera paths are the same numpy code, so equal exactly; rays are
float32 matmuls whose summation order may differ between XLA and PyTorch,
so within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.cameras import (
    camera_rays as jax_camera_rays,
    default_360_path as jax_default_360_path,
    pose2rays as jax_pose2rays,
    pose_spherical as jax_pose_spherical,
)
from avatarcraft_tpu.cameras.rays import canonical_camera as jax_canonical_camera
from avatarcraft_tpu_torch import constants
from avatarcraft_tpu_torch.cameras import (
    camera_rays,
    canonical_camera,
    default_360_path,
    pose2rays,
    pose_spherical,
)


def test_constants_match():
    import avatarcraft_tpu.constants as jc

    names = [n for n in dir(jc) if n.isupper()]
    assert names
    for n in names:
        assert getattr(constants, n) == getattr(jc, n), n


@pytest.mark.parametrize("theta,phi,radius", [(7.0, 0.0, 1.44), (98.0, -3.0, 1.44), (-150.0, 20.0, 0.45)])
def test_pose_spherical_exact(theta, phi, radius):
    np.testing.assert_array_equal(
        pose_spherical(theta, phi, radius), jax_pose_spherical(theta, phi, radius)
    )


def test_pose_spherical_noise_same_draws():
    a = pose_spherical(30.0, 5.0, 1.5, add_noise=True, rng=np.random.default_rng(3))
    b = jax_pose_spherical(30.0, 5.0, 1.5, add_noise=True, rng=np.random.default_rng(3))
    np.testing.assert_array_equal(a, b)


def test_default_360_path_exact():
    center, up = np.zeros(3), np.array([0.0, 1.0, 0.0])
    for c in (center, center + up * constants.CAN_HEAD_OFFSET):
        poses, descs = default_360_path(c, up, 1.7, 7)
        jposes, jdescs = jax_default_360_path(c, up, 1.7, 7)
        np.testing.assert_array_equal(poses, jposes)
        assert descs == jdescs


def test_canonical_camera_same():
    import dataclasses

    port, ref = canonical_camera(24, 40), jax_canonical_camera(24, 40)
    assert dataclasses.astuple(port) == dataclasses.astuple(ref)
    np.testing.assert_array_equal(port.intrinsic, ref.intrinsic)
    assert dataclasses.astuple(port.resized((12, 20))) == dataclasses.astuple(ref.resized((12, 20)))


@pytest.mark.parametrize("h,w", [(16, 16), (12, 20)])
@pytest.mark.parametrize("theta", [7.0, 143.0])
def test_pose2rays_match(h, w, theta):
    c2w = pose_spherical(theta, -3.0, constants.CANONICAL_CAMERA_DIST_VAL)
    ro, rd = pose2rays(h, w, c2w, device="cpu")
    jro, jrd = jax_pose2rays(h, w, c2w)
    assert ro.dtype == rd.dtype == torch.float32
    assert ro.shape == rd.shape == (h * w, 3)
    np.testing.assert_allclose(ro.numpy(), np.asarray(jro), atol=1e-6, rtol=0)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), atol=1e-6, rtol=0)


def test_camera_rays_stride_match():
    cam = canonical_camera(16, 24)
    c2w = pose_spherical(40.0, 10.0, 1.6)
    ro, rd = camera_rays(cam, c2w, stride=4, device="cpu")
    jro, jrd = jax_camera_rays(cam, jnp.asarray(c2w), stride=4)
    np.testing.assert_allclose(ro.numpy(), np.asarray(jro), atol=1e-6, rtol=0)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), atol=1e-6, rtol=0)
