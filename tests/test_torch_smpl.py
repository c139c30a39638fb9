"""The SMPL body model of the PyTorch port against the JAX package, on the
CPU, on a synthetic body and on the committed demo rig.

Tolerance: 2e-5 absolute on every output (rotations, transforms, vertices,
joints; values of order 1). Both sides compute in f32; einsum and matrix
products sum in other orders. The loaders and the synthetic body are
compared exactly."""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from avatarcraft_tpu.models import smpl as jsmpl
from avatarcraft_tpu_torch.models import smpl as tsmpl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RIG = os.path.join(REPO, "artifacts", "canonical", "demo_body_rig.npz")
ATOL = 2e-5
FIELDS = ("v_template", "shapedirs", "posedirs", "J_regressor", "parents", "lbs_weights", "faces")

needs_rig = pytest.mark.skipif(not os.path.exists(RIG), reason="demo rig not present")


def _same_model(port, ref):
    for f in FIELDS:
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.fixture(scope="module", params=["synthetic", "demo_rig"])
def model(request):
    """(port model, JAX model) of one body."""
    if request.param == "synthetic":
        return tsmpl.synthetic_smpl_params(0, n_verts=48, n_joints=24), jsmpl.synthetic_smpl_params(0, n_verts=48, n_joints=24)
    if not os.path.exists(RIG):
        pytest.skip("demo rig not present")
    return tsmpl.load_smpl(RIG), jsmpl.load_smpl(RIG)


def _inputs(model, seed=0):
    rng = np.random.default_rng(seed)
    J, B = model.n_joints, model.shapedirs.shape[-1]
    pose = rng.normal(scale=0.4, size=(1, 3 * J)).astype(np.float32)
    betas = rng.normal(size=(1, B)).astype(np.float32)
    transl = rng.normal(scale=0.2, size=(1, 3)).astype(np.float32)
    return pose, betas, transl


def test_synthetic_params_equal():
    _same_model(tsmpl.synthetic_smpl_params(3, n_verts=40, n_joints=7),
                jsmpl.synthetic_smpl_params(3, n_verts=40, n_joints=7))


@needs_rig
def test_load_smpl_npz_equal():
    _same_model(tsmpl.load_smpl(RIG), jsmpl.load_smpl(RIG))


def test_load_smpl_pickle_equal(tmp_path, rng):
    """A pickle with the reference's keys (sparse J_regressor, posedirs as
    [V, 3, P], kintree_table, weights, f), by file and by directory."""
    V, J = 30, 5
    data = {
        "v_template": rng.normal(size=(V, 3)),
        "shapedirs": rng.normal(size=(V, 3, 10)),
        "posedirs": rng.normal(size=(V, 3, 9 * (J - 1))),
        "J_regressor": scipy.sparse.csc_matrix(rng.random((J, V))),
        "kintree_table": np.stack([np.array([4294967295, 0, 1, 1, 0]), np.arange(J)]),
        "weights": rng.random((V, J)),
        "f": np.stack([np.arange(V - 2), np.arange(1, V - 1), np.arange(2, V)], 1).astype(np.uint32),
    }
    path = tmp_path / "SMPL_NEUTRAL.pkl"
    with open(path, "wb") as fh:
        pickle.dump(data, fh, protocol=2)
    for where in (str(path), str(tmp_path)):
        port, ref = tsmpl.load_smpl(where), jsmpl.load_smpl(where)
        _same_model(port, ref)
    assert port.posedirs.shape == (9 * (J - 1), 3 * V) and port.parents[0] == -1


def test_batch_rodrigues(rng):
    vecs = rng.normal(size=(64, 3)).astype(np.float32)
    vecs[0] = 0.0  # the zero rotation, through the 1e-8 guard
    _close(tsmpl.batch_rodrigues(torch.as_tensor(vecs)), jsmpl.batch_rodrigues(jnp.asarray(vecs)))


def test_transform_mat(rng):
    R = rng.normal(size=(2, 5, 3, 3)).astype(np.float32)
    t = rng.normal(size=(2, 5, 3)).astype(np.float32)
    got = tsmpl.transform_mat(torch.as_tensor(R), torch.as_tensor(t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsmpl.transform_mat(jnp.asarray(R), jnp.asarray(t))))


def test_kinematics(model):
    port, ref = model
    pose, betas, _ = _inputs(ref)
    B = pose.shape[0]
    rot = np.array(jsmpl.batch_rodrigues(jnp.asarray(pose.reshape(-1, 3)))).reshape(B, -1, 3, 3)
    joints = np.random.default_rng(1).normal(size=(B, ref.n_joints, 3)).astype(np.float32)
    got = tsmpl.batch_rigid_transform(torch.as_tensor(rot), torch.as_tensor(joints), port.parents)
    want = jsmpl.batch_rigid_transform(jnp.asarray(rot), jnp.asarray(joints), ref.parents)
    for g, w in zip(got, want):
        _close(g, w)
    _close(tsmpl.blend_shapes(torch.as_tensor(betas), port.shapedirs), jsmpl.blend_shapes(jnp.asarray(betas), ref.shapedirs))
    verts = ref.v_template[None]
    _close(tsmpl.vertices2joints(port.J_regressor, torch.as_tensor(verts)),
           jsmpl.vertices2joints(ref.J_regressor, jnp.asarray(verts)))


@pytest.mark.parametrize("return_T,concat_joints", [(False, False), (True, False), (True, True)])
def test_lbs(model, return_T, concat_joints):
    port, ref = model
    pose, betas, _ = _inputs(ref)
    got = tsmpl.lbs(port, torch.as_tensor(betas), torch.as_tensor(pose), return_T=return_T, concat_joints=concat_joints)
    want = jsmpl.lbs(ref, jnp.asarray(betas), jnp.asarray(pose), return_T=return_T, concat_joints=concat_joints)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("return_T,concat_joints", [(False, False), (True, False), (True, True)])
def test_my_lbs_applies_pose_offsets(model, return_T, concat_joints):
    port, ref = model
    pose, betas, _ = _inputs(ref, seed=2)
    v_shaped = (ref.v_template + np.einsum("vkl,l->vk", ref.shapedirs, betas[0]))[None].astype(np.float32)
    got = tsmpl.my_lbs(port, torch.as_tensor(v_shaped), torch.as_tensor(pose), return_T=return_T,
                       concat_joints=concat_joints)
    want = jsmpl.my_lbs(ref, jnp.asarray(v_shaped), jnp.asarray(pose), return_T=return_T,
                        concat_joints=concat_joints)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


def test_lbs_variants_differ_by_pose_offsets():
    """``lbs`` leaves the pose blendshapes out and ``my_lbs`` applies them:
    with posedirs zeroed the two agree, with them they do not."""
    port = tsmpl.synthetic_smpl_params(1, n_verts=40, n_joints=6)
    pose = torch.as_tensor(np.random.default_rng(4).normal(scale=0.5, size=(1, 18)).astype(np.float32))
    betas = torch.zeros((1, 10))
    v_shaped = torch.as_tensor(port.v_template)[None]
    plain, _ = tsmpl.lbs(port, betas, pose)
    offset, _ = tsmpl.my_lbs(port, v_shaped, pose)
    assert float((plain - offset).abs().max()) > 1e-4
    flat = tsmpl.SMPLParams(**{**port.__dict__, "posedirs": np.zeros_like(port.posedirs)})
    np.testing.assert_allclose(tsmpl.my_lbs(flat, v_shaped, pose)[0].numpy(), plain.numpy(), atol=1e-6)


@pytest.mark.parametrize("with_transl", [False, True])
def test_smpl_forward_and_verts_transformations(model, with_transl):
    port, ref = model
    pose, betas, transl = _inputs(ref, seed=3)
    tt = torch.as_tensor(transl) if with_transl else None
    jt = jnp.asarray(transl) if with_transl else None
    got = tsmpl.smpl_forward(port, torch.as_tensor(pose), torch.as_tensor(betas), tt, return_joints=True)
    want = jsmpl.smpl_forward(ref, jnp.asarray(pose), jnp.asarray(betas), jt, return_joints=True)
    for g, w in zip(got, want):
        _close(g, w)
    _close(tsmpl.smpl_forward(port, torch.as_tensor(pose), torch.as_tensor(betas), tt),
           jsmpl.smpl_forward(ref, jnp.asarray(pose), jnp.asarray(betas), jt))
    for concat in (False, True):
        got = tsmpl.verts_transformations(port, torch.as_tensor(pose), torch.as_tensor(betas), tt, concat)
        want = jsmpl.verts_transformations(ref, jnp.asarray(pose), jnp.asarray(betas), jt, concat)
        for g, w in zip(got, want):
            _close(g, w)
