"""The posed -> canonical warp of the PyTorch port against the JAX package,
on the CPU: closest points on triangles, the kNN closest-face search, the
vertex-face table, the posed-body density grid and the full warp on the
committed demo rig.

Tolerances:
- closest points and barycentrics: 1e-6 against JAX (the same f32
  arithmetic, sums of three in other orders); 5e-3 against a dense sampling
  of the triangle and 2e-4 against a brute-force search over all faces, as
  tests/test_warp.py holds JAX;
- the warp on the demo rig: ``can_pts`` within 5e-5 where both masks are
  in; ``can_dirs`` within the bound that the measured ``can_pts`` error
  gives them (2 x error / sample spacing, see the test). The mask
  ``d2 < 0.05`` is compared everywhere except where JAX's d2 lies within
  1e-5 of 0.05 (a rounding there may flip it). Where the nearest vertices
  tie, the two sides may pick different candidate faces with the same
  distance, so the closest points are compared by their squared distance
  (1e-6);
- ``build_vertex_face_table`` and ``voxelize_verts``: equal, bit for bit;
- the golden of tests/test_warp_render.py:82-131 at its own tolerances
  (2e-5 for transforms and vertices, 5e-5 for the warped points).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.models import smpl as jsmpl
from avatarcraft_tpu.ops.occupancy import voxelize_verts as jax_voxelize_verts
from avatarcraft_tpu.warp import WarpData as JaxWarpData
from avatarcraft_tpu.warp import build_vertex_face_table as jax_build_vertex_face_table
from avatarcraft_tpu.warp import closest_point_on_triangles as jax_closest_point_on_triangles
from avatarcraft_tpu.warp import warp_samples_to_canonical as jax_warp_samples_to_canonical
from avatarcraft_tpu.workloads.warp_render import calc_local_trans as jax_calc_local_trans
from avatarcraft_tpu_torch.models import smpl as tsmpl
from avatarcraft_tpu_torch.ops.occupancy import voxelize_verts
from avatarcraft_tpu_torch.warp import (
    WarpData,
    build_vertex_face_table,
    closest_point_on_triangles,
    make_warp_fn,
    warp_samples_to_canonical,
)
from avatarcraft_tpu_torch.workloads.warp_render import calc_local_trans
from test_warp import icosphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RIG = os.path.join(REPO, "artifacts", "canonical", "demo_body_rig.npz")
POSES = os.path.join(REPO, "artifacts", "canonical", "demo_poses.npy")
MASK_BAND = 1e-5

needs_rig = pytest.mark.skipif(not all(os.path.exists(p) for p in (RIG, POSES)), reason="demo rig not present")


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def test_closest_point_regions(rng):
    """Against JAX, and against a dense barycentric sampling of the
    triangle (every Voronoi region is hit by 200 points at scale 1.5)."""
    a, b, c = np.array([0.0, 0, 0]), np.array([1.0, 0, 0]), np.array([0.0, 1, 0])
    us = np.linspace(0, 1, 200)
    grid = np.array([[u, v] for u in us for v in us if u + v <= 1])
    tri_pts = grid[:, :1] * b + grid[:, 1:] * c + (1 - grid.sum(1, keepdims=True)) * a

    ps = rng.normal(size=(200, 3)).astype(np.float32) * 1.5
    closest, bary = closest_point_on_triangles(_t(ps), _t(a)[None], _t(b)[None], _t(c)[None])
    jc, jb = jax_closest_point_on_triangles(
        jnp.asarray(ps), jnp.asarray(a, jnp.float32)[None], jnp.asarray(b, jnp.float32)[None],
        jnp.asarray(c, jnp.float32)[None],
    )
    np.testing.assert_allclose(closest.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(bary.numpy(), np.asarray(jb), atol=1e-6)
    d_ours = np.linalg.norm(closest.numpy() - ps, axis=1)
    d_true = np.min(np.linalg.norm(ps[:, None, :] - tri_pts[None], axis=-1), axis=1)
    np.testing.assert_allclose(d_ours, d_true, atol=5e-3)
    np.testing.assert_allclose(bary.numpy() @ np.stack([a, b, c]), closest.numpy(), atol=1e-6)


def _brute_force_closest(p, verts, faces):
    tri = verts[faces]
    c, _ = closest_point_on_triangles(_t(p)[:, None, :], _t(tri[:, 0])[None], _t(tri[:, 1])[None], _t(tri[:, 2])[None])
    d2 = ((c - _t(p)[:, None, :]) ** 2).sum(-1).numpy()
    return d2.min(axis=1), c.numpy()[np.arange(len(p)), d2.argmin(axis=1)]


def test_knn_face_search_matches_brute_force(rng):
    verts, faces = icosphere(2)
    Ts = np.broadcast_to(np.eye(4, dtype=np.float32), (len(verts) + 4, 4, 4))
    data = WarpData.create(verts, faces, Ts, device="cpu")
    pts = rng.normal(size=(8, 16, 3)).astype(np.float32) * 1.2
    _, _, closest, mask = warp_samples_to_canonical(_t(pts), data, threshold=0.3, block=32)
    d2_bf, closest_bf = _brute_force_closest(pts.reshape(-1, 3), verts, faces)
    np.testing.assert_allclose(closest.numpy().reshape(-1, 3), closest_bf, atol=2e-4)
    np.testing.assert_array_equal(mask.numpy().reshape(-1), d2_bf < 0.3)


def test_identity_transform_warp_is_identity(rng):
    verts, faces = icosphere(1)
    data = WarpData.create(verts, faces, np.broadcast_to(np.eye(4, dtype=np.float32), (len(verts), 4, 4)), "cpu")
    pts = rng.normal(size=(4, 8, 3)).astype(np.float32)
    can_pts, _, _, _ = warp_samples_to_canonical(_t(pts), data, block=16)
    np.testing.assert_allclose(can_pts.numpy(), pts, atol=1e-5)


def test_rigid_transform_roundtrip(rng):
    from scipy.spatial.transform import Rotation as R

    verts, faces = icosphere(2)
    Rm = R.from_rotvec([0.4, -0.3, 0.2]).as_matrix().astype(np.float32)
    t = np.array([0.3, 0.1, -0.2], np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = Rm, t
    data = WarpData.create(verts @ Rm.T + t, faces, np.broadcast_to(T, (len(verts), 4, 4)), "cpu")
    can = verts[rng.integers(0, len(verts), 24)] * 1.02
    can_back, _, _, mask = warp_samples_to_canonical(_t((can @ Rm.T + t).reshape(4, 6, 3)), data, threshold=0.3, block=8)
    np.testing.assert_allclose(can_back.numpy().reshape(-1, 3), can, atol=1e-4)
    assert mask.numpy().all()


def test_can_dirs_unit_norm():
    verts, faces = icosphere(1)
    data = WarpData.create(verts, faces, np.broadcast_to(np.eye(4, dtype=np.float32), (len(verts), 4, 4)), "cpu")
    o, d = np.array([0, 0, -3.0], np.float32), np.array([0, 0, 1.0], np.float32)
    z = np.linspace(1, 5, 12, dtype=np.float32)
    _, can_dirs, _, _ = warp_samples_to_canonical(_t((o[None] + z[:, None] * d[None])[None]), data, block=4)
    np.testing.assert_allclose(np.linalg.norm(can_dirs.numpy(), axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(can_dirs.numpy()[0, 0], d, atol=1e-5)


@pytest.fixture(scope="module")
def rig_frame():
    """(JAX model, world_verts, Ts) of demo frame 10 on the demo rig."""
    if not all(os.path.exists(p) for p in (RIG, POSES)):
        pytest.skip("demo rig not present")
    model = jsmpl.load_smpl(RIG)
    wv, Ts, _ = jax_calc_local_trans(model, poses=np.load(POSES)[10:11], max_frames=1, rest_pose="zero")
    return model, wv[0], Ts[0]


def test_vertex_face_table_equal(rig_frame):
    verts, faces = icosphere(0)
    table = build_vertex_face_table(faces, len(verts))
    np.testing.assert_array_equal(table, jax_build_vertex_face_table(faces, len(verts)))
    assert table.shape == (12, 5)
    model, wv, Ts = rig_frame
    np.testing.assert_array_equal(build_vertex_face_table(model.faces, model.n_verts),
                                  jax_build_vertex_face_table(model.faces, model.n_verts))
    data, ref = WarpData.create(wv, model.faces, Ts, "cpu"), JaxWarpData.create(wv, model.faces, Ts)
    for f in ("verts", "faces", "Ts", "vert2face"):
        np.testing.assert_array_equal(getattr(data, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)


def test_voxelize_verts_bitwise(rig_frame):
    """The posed body's 129^3 grid as the JAX frame renderer makes it (under
    jit) and eagerly, and the marks-and-dilates case of
    tests/test_warp_render.py:185-194."""
    _, wv, _ = rig_frame
    got = voxelize_verts(_t(wv), 1.6, 129).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(lambda v: jax_voxelize_verts(v, 1.6, 129))(jnp.asarray(wv))))
    np.testing.assert_array_equal(got, np.asarray(jax_voxelize_verts(jnp.asarray(wv), 1.6, 129)))
    assert (got > 0).sum() > 1000
    pts = np.asarray([[0.0, 0.0, 0.0], [1.0, -1.0, 0.5]], np.float32)
    g = voxelize_verts(_t(pts), bound=1.6, resolution=33, dilate=1).numpy()
    np.testing.assert_array_equal(g, np.asarray(jax_voxelize_verts(jnp.asarray(pts), bound=1.6, resolution=33, dilate=1)))
    assert (g > 10).sum() == 2 * 27


def test_warp_on_demo_rig_matches_jax(rig_frame):
    """Samples along 128 rays through random body vertices (32 per ray
    over +-0.6, both sides of the 0.05 mask threshold), warped in blocks
    that do not divide the count. can_dirs are the normalised differences
    of consecutive can_pts, so an error e in can_pts moves them by up to
    2e / spacing: they are held to that bound of the measured can_pts
    error (JAX's own jit and eager runs differ by 1.8e-7 in can_pts and
    1.0e-5 in can_dirs on these samples)."""
    model, wv, Ts = rig_frame
    rng = np.random.default_rng(0)
    n, T, half = 128, 32, 0.6
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.linspace(-half, half, T)
    pts = (wv[rng.integers(0, len(wv), n)][:, None, :] + z[None, :, None] * d[:, None, :]).astype(np.float32)
    can, dirs, closest, mask = warp_samples_to_canonical(_t(pts), WarpData.create(wv, model.faces, Ts, "cpu"), block=1500)
    jdata = JaxWarpData.create(wv, model.faces, Ts)
    jcan, jdirs, jclosest, jmask = (np.asarray(x) for x in jax.jit(jax_warp_samples_to_canonical)(jnp.asarray(pts), jdata))
    jd2 = np.sum((jclosest - pts) ** 2, -1)
    decided = np.abs(jd2 - 0.05) >= MASK_BAND
    np.testing.assert_array_equal(mask.numpy()[decided], jmask[decided])
    assert 0.05 < jmask.mean() < 0.95  # both sides of the threshold are tested
    both = mask.numpy() & jmask
    can_err = float(np.abs(can.numpy() - jcan)[both].max())
    assert can_err <= 5e-5
    np.testing.assert_allclose(dirs.numpy()[both], jdirs[both], atol=2 * can_err / (z[1] - z[0]) + 1e-6)
    # ties among the nearest vertices may pick another face: the closest
    # point's distance is then the same up to rounding
    np.testing.assert_allclose(np.sum((closest.numpy() - pts) ** 2, -1), jd2, atol=1e-6)


def test_warp_refuses_tf32():
    verts, faces = icosphere(0)
    data = WarpData.create(verts, faces, np.broadcast_to(np.eye(4, dtype=np.float32), (len(verts), 4, 4)), "cpu")
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            warp_samples_to_canonical(torch.zeros(1, 2, 3), data)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_golden_frame_calc_local_trans_and_warp():
    """tests/test_warp_render.py:82-131 reproduced by the port: the same
    synthetic body and pose give the pinned T_rest2pose entries, posed
    vertices and warped points."""
    model = tsmpl.synthetic_smpl_params(0, n_verts=48, n_joints=24)
    pose = np.random.default_rng(7).normal(scale=0.3, size=(1, 24, 3)).astype(np.float32)
    world_verts, Ts, n = calc_local_trans(model, render_type="animate", poses=pose, max_frames=1)
    assert n == 1
    T = Ts[0]
    np.testing.assert_allclose(T[0, 0], [0.023374, 0.557706, 0.020922, -0.064532], atol=2e-5)
    np.testing.assert_allclose(T[10, 1], [-0.137501, -0.005743, -0.031638, 0.074049], atol=2e-5)
    np.testing.assert_allclose(world_verts[0][0], [-0.099688, 0.010991, 0.186265], atol=2e-5)
    np.testing.assert_allclose(world_verts[0][20], [-0.149553, 0.123837, 0.389621], atol=2e-5)

    faces = np.stack([np.arange(46), np.arange(1, 47), np.arange(2, 48)], 1).astype(np.int32)
    wf = make_warp_fn(WarpData.create(world_verts[0], faces, T[:48], "cpu"), 0.05)
    can_pts, can_dirs, mask = wf(_t(world_verts[0][:4] + 0.01)[None])
    np.testing.assert_allclose(
        can_pts.numpy()[0],
        [[0.054133, -0.066407, 0.198854], [0.038344, -0.168733, 0.105164],
         [0.295241, 0.271273, 0.055329], [-0.323089, -0.235368, 0.025179]],
        atol=5e-5,
    )
    np.testing.assert_allclose(can_dirs.numpy()[0, 0], [-0.113073, -0.732814, -0.670968], atol=5e-5)
    assert mask.numpy().all()
