"""Build a mesh-derived demo body for render_warp without an SMPL model file:
port of the JAX package's tools/make_demo_body.py, with its flags, rig and
``.npz`` layout.

SMPL's model file is the user's own (reference: readme.md:40-47). This
tool extracts the avatar's surface from a baked field (``extract_geometry``:
the SDF lattice on the device, marching cubes on the host) and wraps it in
a trivial rig, in numpy as the JAX tool writes it:

  * v_template = the surface / SMPL_SCALE (field space is SMPL x 0.9);
  * shapedirs: beta_1 a vertical stretch, beta_2 a radial scale about the
    centroid, so ``render_warp --render_type interp_shape`` morphs the
    avatar;
  * ``--rig root``: every skinning weight on the root of ``--n_joints``;
    ``--rig articulated``: 7 joints (root, spine, head, arms, legs) with
    sigmoid region weights and joints regressed from vertices near anchor
    points, so ``--render_type animate`` moves the limbs;
  * zero posedirs, and ``rest_pose="zero"`` (the template is the da-posed
    surface), which render_warp_cli reads to pick ``--rest_pose``.

The field is read whole: no K10 kernel runs here. The SDF runs on the CUDA
card unless ``--platform cpu`` (the JAX tool's default is ``cpu``).

    python -m avatarcraft_tpu_torch.tools.make_demo_body [--ckpt artifacts/canonical/bare_smpl_tpu.pth.tar] \\
        [--out demo_body.npz] [--resolution 128] [--rig articulated] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from avatarcraft_tpu_torch.constants import NSR_BOUND, SMPL_SCALE
from avatarcraft_tpu_torch.models.instant_nsr import extract_geometry
from avatarcraft_tpu_torch.utils.checkpoint import load_params_with_config
from avatarcraft_tpu_torch.utils.device import tool_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="artifacts/canonical/bare_smpl_tpu.pth.tar")
    ap.add_argument("--out", default="artifacts/canonical/demo_body.npz")
    ap.add_argument("--resolution", default=128, type=int)
    ap.add_argument("--n_betas", default=10, type=int)
    ap.add_argument("--n_joints", default=4, type=int, help="--rig root only; the articulated rig is 7 joints")
    ap.add_argument("--rig", default="root", choices=["root", "articulated"],
                    help="root = rigid (interp_shape morphs); articulated = 7-joint body rig segmented from the "
                         "da-pose geometry (head/arms/legs animate; render_warp --render_type animate demos)")
    ap.add_argument("--platform", default="default", choices=["cpu", "default"],
                    help="default: the CUDA card; cpu: the CPU")
    return ap


def rig_body(verts: np.ndarray, faces: np.ndarray, rig: str, n_betas: int, n_joints: int) -> dict:
    """The .npz arrays of the demo body around the surface ``verts`` [V, 3]
    (field space) and ``faces`` [F, 3], in the JAX tool's layout, dtypes and
    arithmetic."""
    v_template = verts / SMPL_SCALE
    center = v_template.mean(axis=0, keepdims=True)
    V, B = len(v_template), n_betas

    shapedirs = np.zeros((V, 3, B), np.float32)
    shapedirs[:, 1, 0] = (v_template[:, 1] - center[0, 1]) * 0.05  # stretch
    shapedirs[:, :, 1] = (v_template - center) * 0.05  # radial scale

    if rig == "articulated":
        # root(pelvis), spine, head, L/R arm, L/R leg: sigmoid region weights
        # keep the skinning continuous where limbs meet the torso; joints
        # regress from vertices near hand-placed anchor points
        x, y = v_template[:, 0], v_template[:, 1]
        y0, y1 = float(y.min()), float(y.max())
        H = y1 - y0
        y_pelvis = y0 + 0.42 * H
        y_neck = y0 + 0.80 * H
        x_sh = 0.16 * float(np.abs(x).max())

        def smooth(t):
            return 1.0 / (1.0 + np.exp(-t))

        w_head = smooth((y - y_neck) / (0.04 * H))
        upper = smooth((y - y_pelvis) / (0.04 * H))
        w_larm = smooth((x - x_sh) / (0.03)) * upper * (1 - w_head)
        w_rarm = smooth((-x - x_sh) / (0.03)) * upper * (1 - w_head)
        lower = 1.0 - upper
        side = smooth(x / 0.02)
        w_lleg = lower * side
        w_rleg = lower * (1 - side)
        w_spine = smooth((y - (y0 + 0.62 * H)) / (0.06 * H)) * (1 - w_head) * (1 - np.clip(w_larm + w_rarm, 0, 1))
        w = np.stack([np.zeros(V), w_spine, w_head, w_larm, w_rarm, w_lleg, w_rleg], 1).astype(np.float32)
        w = np.clip(w, 0.0, 1.0)
        w[:, 0] = np.clip(1.0 - w[:, 1:].sum(1), 0.0, None)  # root remainder
        w /= w.sum(1, keepdims=True)

        anchors = np.array(
            [
                [0.0, y_pelvis, 0.0],  # root
                [0.0, y0 + 0.62 * H, 0.0],  # spine/chest
                [0.0, y_neck, 0.0],  # head (neck pivot)
                [x_sh, y0 + 0.72 * H, 0.0],  # L shoulder
                [-x_sh, y0 + 0.72 * H, 0.0],  # R shoulder
                [0.10 * H, y_pelvis, 0.0],  # L hip
                [-0.10 * H, y_pelvis, 0.0],  # R hip
            ],
            np.float32,
        )
        J = len(anchors)
        d2 = ((v_template[None] - anchors[:, None]) ** 2).sum(-1)  # [J, V]
        reg = np.exp(-d2 / (0.02 * H) ** 2)
        J_regressor = (reg / reg.sum(1, keepdims=True)).astype(np.float32)
        parents = np.array([-1, 0, 1, 1, 1, 0, 0], np.int32)
        lbs_weights = w
    else:
        J = n_joints
        J_regressor = np.full((J, V), 1.0 / V, np.float32)
        parents = np.arange(-1, J - 1, dtype=np.int32)
        lbs_weights = np.concatenate([np.ones((V, 1), np.float32), np.zeros((V, J - 1), np.float32)], axis=1)

    return {
        "v_template": v_template,
        "shapedirs": shapedirs,
        "posedirs": np.zeros(((J - 1) * 9, V * 3), np.float32),
        "J_regressor": J_regressor,
        "parents": parents,
        "lbs_weights": lbs_weights,
        "faces": faces,
        # the template is the da-posed surface: the warp's rest pose is zero
        "rest_pose": np.array("zero"),
    }


def main(argv=None) -> dict:
    """Run the tool; returns the JSON result it prints."""
    opt = build_parser().parse_args(argv)
    device = tool_device(opt.platform)

    params, fcfg = load_params_with_config(opt.ckpt, device)
    verts, faces = extract_geometry(params, fcfg, NSR_BOUND, opt.resolution)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    print(f"extracted {len(verts)} verts / {len(faces)} faces at {opt.resolution}^3", file=sys.stderr)

    body = rig_body(verts, faces, opt.rig, opt.n_betas, opt.n_joints)
    np.savez_compressed(opt.out, **body)
    J = len(body["parents"])
    mb = os.path.getsize(opt.out) / 2**20
    print(f"saved {opt.out} (rig={opt.rig}, J={J}, {mb:.1f} MB)", file=sys.stderr)
    result = {"out": opt.out, "rig": opt.rig, "joints": J, "vertices": len(verts), "faces": len(faces),
              "bytes": os.path.getsize(opt.out)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
