"""The SMPL body model as plain PyTorch functions. Port of the JAX package's
models/smpl.py (reference: models/smpl.py:52-647): Rodrigues rotations, the
kinematic chain of rigid transforms (a Python loop over the joints), blend
shapes, joint regression and the skinning-weight blend of per-vertex 4x4
transforms.

The model data (``SMPLParams``) stays numpy, as loaded; every function takes
its pose and shape tensors on a device and moves the model arrays it needs
to that device. Results live where the inputs live.

Two LBS variants exist in the reference and both are kept:
* ``lbs``    -- the verts_transformations path; it leaves the pose
  blendshape offsets out of the returned vertices (v_posed = v_shaped,
  reference: models/smpl.py:420);
* ``my_lbs`` -- applies them (v_posed = pose_offsets + v_shaped,
  reference: models/smpl.py:478).

SMPL_NEUTRAL.pkl is supplied by the user (its licence forbids
redistribution); ``load_smpl`` also reads an ``.npz`` with the SMPLParams
fields, such as the committed demo rig, and ``synthetic_smpl_params`` makes
a random but valid body for tests.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SMPLParams:
    """Static model data (numpy arrays)."""

    v_template: np.ndarray  # [V, 3]
    shapedirs: np.ndarray  # [V, 3, n_betas]
    posedirs: np.ndarray  # [(J-1)*9, V*3]
    J_regressor: np.ndarray  # [J, V]
    parents: np.ndarray  # [J] int, parents[0] == -1
    lbs_weights: np.ndarray  # [V, J]
    faces: np.ndarray  # [F, 3] int

    @property
    def n_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def n_joints(self) -> int:
        return self.J_regressor.shape[0]


def load_smpl(model_path: str, gender: str = "neutral") -> SMPLParams:
    """Load SMPL_<GENDER>.pkl (a directory holding it, or the file; the
    reference's keys: v_template, shapedirs, posedirs, J_regressor,
    kintree_table, weights, f; reference: models/smpl.py:52-105), or an
    ``.npz`` with the SMPLParams fields."""
    if os.path.isdir(model_path):
        model_path = os.path.join(model_path, f"SMPL_{gender.upper()}.pkl")
    if model_path.endswith(".npz"):
        data = np.load(model_path)
        return SMPLParams(
            v_template=data["v_template"].astype(np.float32),
            shapedirs=data["shapedirs"].astype(np.float32),
            posedirs=data["posedirs"].astype(np.float32),
            J_regressor=data["J_regressor"].astype(np.float32),
            parents=data["parents"].astype(np.int32),
            lbs_weights=data["lbs_weights"].astype(np.float32),
            faces=data["faces"].astype(np.int32),
        )
    # the pickle is the user's own model file (as the reference loads it)
    with open(model_path, "rb") as fh:
        data = pickle.load(fh, encoding="latin1")

    def to_np(x):
        if "scipy.sparse" in str(type(x)):
            x = x.todense()
        return np.array(x, dtype=np.float32)

    posedirs = to_np(data["posedirs"])
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # [(J-1)*9, V*3]
    parents = np.array(data["kintree_table"][0], dtype=np.int32)
    parents[0] = -1
    return SMPLParams(
        v_template=to_np(data["v_template"]),
        shapedirs=to_np(data["shapedirs"]),
        posedirs=posedirs,
        J_regressor=to_np(data["J_regressor"]),
        parents=parents,
        lbs_weights=to_np(data["weights"]),
        faces=np.array(data["f"], dtype=np.int32),
    )


def synthetic_smpl_params(key=0, n_verts: int = 64, n_joints: int = 6, n_betas: int = 10) -> SMPLParams:
    """Random but valid SMPL-like model for tests (a chain of joints), the
    same numbers as the JAX package's for the same ``key``."""
    rng = np.random.default_rng(key)
    v_template = rng.normal(scale=0.3, size=(n_verts, 3)).astype(np.float32)
    shapedirs = rng.normal(scale=0.01, size=(n_verts, 3, n_betas)).astype(np.float32)
    posedirs = rng.normal(scale=0.001, size=((n_joints - 1) * 9, n_verts * 3)).astype(np.float32)
    J_regressor = rng.random((n_joints, n_verts)).astype(np.float32)
    J_regressor /= J_regressor.sum(axis=1, keepdims=True)
    parents = np.arange(-1, n_joints - 1, dtype=np.int32)  # a simple chain
    w = rng.random((n_verts, n_joints)).astype(np.float32) ** 4
    w /= w.sum(axis=1, keepdims=True)
    # triangles over consecutive vertices
    faces = np.stack(
        [np.arange(n_verts - 2), np.arange(1, n_verts - 1), np.arange(2, n_verts)], axis=-1
    ).astype(np.int32)
    return SMPLParams(v_template, shapedirs, posedirs, J_regressor, parents, w, faces)


def _on(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A model array as f32 on ``like``'s device."""
    return torch.as_tensor(np.asarray(x, np.float32), device=like.device)


# ---------------------------------------------------------------------------
# Kinematics
# ---------------------------------------------------------------------------


def batch_rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """[N,3] axis-angle -> [N,3,3] rotations (reference: models/smpl.py:549-580)."""
    angle = torch.linalg.norm(rot_vecs + 1e-8, dim=1, keepdim=True)  # [N,1]
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[:, None, :]
    sin = torch.sin(angle)[:, None, :]
    rx, ry, rz = rot_dir[:, 0], rot_dir[:, 1], rot_dir[:, 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=1).reshape(-1, 3, 3)
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)[None]
    return ident + sin * K + (1.0 - cos) * (K @ K)


def transform_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """([...,3,3], [...,3]) -> [...,4,4] homogeneous transforms."""
    pad = torch.zeros(R.shape[:-2] + (1, 3), dtype=R.dtype, device=R.device)
    one = torch.ones(R.shape[:-2] + (1, 1), dtype=R.dtype, device=R.device)
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, torch.cat([pad, one], dim=-1)], dim=-2)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor, parents: np.ndarray):
    """Kinematic-chain composition (reference: models/smpl.py:596-647).

    rot_mats: [B,J,3,3], joints: [B,J,3], parents: host int array.
    Returns (posed_joints [B,J,3], rel_transforms [B,J,4,4]).
    """
    B, J = joints.shape[:2]
    parents = np.asarray(parents)
    rel_joints = joints.clone()
    rel_joints[:, 1:] -= joints[:, torch.as_tensor(parents[1:], dtype=torch.long, device=joints.device)]

    local = transform_mat(rot_mats, rel_joints)  # [B,J,4,4]
    chain = [local[:, 0]]
    for i in range(1, J):
        chain.append(chain[parents[i]] @ local[:, i])
    transforms = torch.stack(chain, dim=1)  # [B,J,4,4]
    posed_joints = transforms[:, :, :3, 3]

    # rel_transforms = T - [0 | T @ [j;0]] (reference: models/smpl.py:642-645)
    joints_h = torch.cat([joints, joints.new_zeros((B, J, 1))], dim=-1)
    correction = torch.einsum("bjmn,bjn->bjm", transforms, joints_h)
    rel = transforms.clone()
    rel[:, :, :3, 3] -= correction[:, :, :3]
    return posed_joints, rel


def blend_shapes(betas: torch.Tensor, shape_disps) -> torch.Tensor:
    return torch.einsum("bl,mkl->bmk", betas, _on(shape_disps, betas))


def vertices2joints(J_regressor, vertices: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bik,ji->bjk", vertices, _on(J_regressor, vertices))


# ---------------------------------------------------------------------------
# LBS variants
# ---------------------------------------------------------------------------


def _skin(model: SMPLParams, A: torch.Tensor) -> torch.Tensor:
    """Per-vertex transforms [B,V,4,4]: the skinning-weight blend of the
    joints' [B,J,4,4]."""
    return torch.einsum("vj,bjmn->bvmn", _on(model.lbs_weights, A), A)


def _apply(T: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    v_h = torch.cat([v, v.new_ones(v.shape[:2] + (1,))], dim=-1)
    return torch.einsum("bvmn,bvn->bvm", T, v_h)[..., :3]


def lbs(model: SMPLParams, betas: torch.Tensor, pose: torch.Tensor, *, return_T: bool = False,
        concat_joints: bool = False):
    """verts_transformations-path LBS (reference: models/smpl.py:351-446).

    betas [B,n_betas], pose [B,3J] axis-angle.
    With return_T: (T [B,V(+J),4,4], verts [B,V(+J),3], v_delta [B,V,3]);
    else (verts [B,V,3], posed_joints [B,J,3]).
    """
    B = pose.shape[0]
    v_delta = blend_shapes(betas, model.shapedirs)
    v_shaped = _on(model.v_template, betas)[None] + v_delta
    J = vertices2joints(model.J_regressor, v_shaped)

    rot_mats = batch_rodrigues(pose.reshape(-1, 3)).reshape(B, -1, 3, 3)
    # this path leaves the pose blendshape offsets out on purpose
    # (v_posed = v_shaped, reference: models/smpl.py:420)
    v_posed = v_shaped

    J_transformed, A = batch_rigid_transform(rot_mats, J, model.parents)
    T = _skin(model, A)
    if return_T:
        if concat_joints:
            return torch.cat([T, A], dim=1), torch.cat([v_posed, J], dim=1), v_delta
        return T, v_posed, v_delta
    return _apply(T, v_posed), J_transformed


def my_lbs(model: SMPLParams, v_shaped: torch.Tensor, pose: torch.Tensor, *, return_T: bool = False,
           concat_joints: bool = False):
    """Shaped-vertex LBS with pose blendshapes (reference: models/smpl.py:448-503)."""
    B = pose.shape[0]
    J = vertices2joints(model.J_regressor, v_shaped)

    rot_mats = batch_rodrigues(pose.reshape(-1, 3)).reshape(B, -1, 3, 3)
    ident = torch.eye(3, dtype=pose.dtype, device=pose.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    pose_offsets = (pose_feature @ _on(model.posedirs, pose)).reshape(B, -1, 3)
    v_posed = pose_offsets + v_shaped

    J_transformed, A = batch_rigid_transform(rot_mats, J, model.parents)
    T = _skin(model, A)
    if return_T:
        if concat_joints:
            return torch.cat([T, A], dim=1), torch.cat([v_posed, J], dim=1)
        return T, v_posed
    return _apply(T, v_posed), J_transformed


# ---------------------------------------------------------------------------
# The reference SMPL module's entry points
# ---------------------------------------------------------------------------


def smpl_forward(model: SMPLParams, pose: torch.Tensor, betas: torch.Tensor, transl: torch.Tensor | None = None,
                 return_joints: bool = False):
    """SMPL.forward (reference: models/smpl.py:249-312): posed vertices."""
    verts, joints = lbs(model, betas, pose)
    if transl is not None:
        verts = verts + transl[:, None, :]
        joints = joints + transl[:, None, :]
    if return_joints:
        return verts, joints
    return verts


def verts_transformations(model: SMPLParams, pose: torch.Tensor, betas: torch.Tensor,
                          transl: torch.Tensor | None = None, concat_joints: bool = False):
    """SMPL.verts_transformations (reference: models/smpl.py:107-161).

    Returns (vertices [B,V(+J),3], T [B,V(+J),4,4], v_delta).
    """
    T, vertices, v_delta = lbs(model, betas, pose, return_T=True, concat_joints=concat_joints)
    if transl is not None:
        transl_mat = torch.eye(4, dtype=T.dtype, device=T.device)[None].repeat(transl.shape[0], 1, 1)
        transl_mat[:, :3, 3] = transl
        T = torch.einsum("bmn,bvnk->bvmk", transl_mat, T)
    return vertices, T, v_delta
