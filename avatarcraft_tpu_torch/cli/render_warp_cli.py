"""CLI: animation and shape-interpolation renders (port of the JAX
package's cli/render_warp_cli.py; reference: render_warp.py).

    python -m avatarcraft_tpu_torch.cli.render_warp_cli \\
        --weights_path artifacts/canonical/bare_smpl_tpu.pth.tar \\
        --smpl_path artifacts/canonical/demo_body_rig.npz \\
        --poseseq_path artifacts/canonical/demo_poses.npy \\
        --data_path data/smpl_dataset --render_view 58

The camera is view ``--render_view`` of the Blender-format dataset at
``--data_path``, sampled down to ``--resolution``. ``--sampler parity``
(the default, as in the JAX package) bounds each ray by the spheres around
the posed vertices and renders 32+32 importance samples with fd7 normals,
every sample warped into the canonical field by the kNN inverse-LBS warp.
``--sampler fast`` voxelizes the posed body per frame, and only the samples
near it are warped; ``--normal_mode`` (an option of the port) picks its
normal estimator, fd4 by default, as the JAX package renders. Writes one
PNG per frame and ``<exp_name>.gif`` at 10 fps (for ``interp_shape`` the
frames forward, then back) under ``<out_dir>/test_views/<exp_name>/``. The
flags are the JAX CLI's (its flag groups of the reference's options.py
included), so its command lines parse; ``--implicit_model`` is parsed and
not read, as in the JAX package (one line says so). ``--use_cuda false``
renders on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from avatarcraft_tpu_torch.cli import options
from avatarcraft_tpu_torch.data import SMPLMultiviewDataset
from avatarcraft_tpu_torch.data.amass import load_pose_sequence
from avatarcraft_tpu_torch.models.smpl import load_smpl, synthetic_smpl_params
from avatarcraft_tpu_torch.utils.checkpoint import load_params_with_config
from avatarcraft_tpu_torch.utils.gif import write_gif
from avatarcraft_tpu_torch.utils.metrics import integerify_img
from avatarcraft_tpu_torch.utils.png import write_png
from avatarcraft_tpu_torch.warp import WarpData
from avatarcraft_tpu_torch.workloads.warp_render import (
    WarpRenderSettings,
    calc_local_trans,
    derive_warp_budget,
    make_warp_frame_renderer,
    make_warp_frame_renderer_fast,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    options.set_general_option(parser)
    options.set_nerf_option(parser)
    options.set_pe_option(parser)
    options.set_render_option(parser)
    options.set_trajectory_option(parser)
    parser.add_argument("--exp_name", default="exp", type=str)
    parser.add_argument("--implicit_model", default="instant_nsr", choices=["neus", "nerf", "instant_nsr"])
    parser.add_argument("--poseseq_path", default=None, type=str)
    parser.add_argument("--render_type", default="animate", choices=["animate", "interp_shape"])
    parser.add_argument("--shape_from_path", type=str, default=None)
    parser.add_argument("--shape_to_path", type=str, default=None)
    parser.add_argument("--max_frames", default=20, type=int)
    parser.add_argument("--resolution", default=256, type=int, choices=[128, 256, 512])
    parser.add_argument("--render_view", default=58, type=int,
                        help="dataset camera index (the reference uses 58/33/...)")
    parser.add_argument("--smpl_path", default="data/smplx/smpl", type=str,
                        help="SMPL_NEUTRAL.pkl or its directory (supplied by the user, as for the "
                             "reference), an .npz body, or 'synthetic' for the test-fixture body")
    parser.add_argument("--data_path", default="data/smpl_da_512", type=str)
    parser.add_argument("--out_dir", default="./demo", type=str)
    parser.add_argument("--sampler", default="parity", choices=["parity", "fast"],
                        help="parity = geometry-guided bounds + 32+32 warped importance samples; fast = "
                             "per-frame voxelized posed-space occupancy + compacted kNN warp")
    parser.add_argument("--normal_mode", default="fd4", choices=["fd7", "fd4", "analytic"],
                        help="normal estimator of --sampler fast only (the JAX package's fast warp render "
                             "uses fd4; analytic = exact forward-mode gradient); parity renders fd7")
    parser.add_argument("--rest_pose", default=None, choices=["da", "zero"],
                        help="pose the canonical field was trained in. Default: 'da' (reference "
                             "parity) for SMPL bodies, the body's rest_pose marker for .npz bodies")
    return parser


def _rest_pose(opt) -> str:
    """--rest_pose, else from the body's provenance, not its file
    extension: a real SMPL body may also come as .npz, and those are
    da-pose-trained like the reference's pickle."""
    if opt.rest_pose is not None:
        return opt.rest_pose
    if opt.smpl_path.endswith(".npz"):
        with np.load(opt.smpl_path) as d:
            if "rest_pose" in d.files:
                return str(d["rest_pose"])
        print("[render_warp] WARNING: .npz body without a rest_pose marker; assuming 'da' (reference "
              "parity). Mesh-derived demo bodies carry rest_pose='zero'; pass --rest_pose to override.")
    return "da"


def main(argv=None):
    parser = build_parser()
    opt = parser.parse_args(argv)
    if opt.weights_path is None:
        parser.error("--weights_path is required")
    options.note_unread_implicit_model(opt, "render_warp")
    device = "cuda" if opt.use_cuda else "cpu"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --use_cuda false to render on the CPU")

    pose_seq = load_pose_sequence(opt.poseseq_path) if opt.poseseq_path is not None else None
    shape_from = np.load(opt.shape_from_path).astype(np.float32) if opt.shape_from_path else None
    shape_to = np.load(opt.shape_to_path).astype(np.float32) if opt.shape_to_path else None
    if opt.smpl_path == "synthetic":
        print("[render_warp] WARNING: synthetic SMPL body (demo mode; supply --smpl_path for real animation)")
        model = synthetic_smpl_params(0, n_verts=512, n_joints=24)
    else:
        model = load_smpl(opt.smpl_path)
    world_verts, Ts, n_frames = calc_local_trans(
        model, render_type=opt.render_type, poses=pose_seq, shape_from=shape_from, shape_to=shape_to,
        max_frames=opt.max_frames, rest_pose=_rest_pose(opt),
    )

    params, fcfg = load_params_with_config(opt.weights_path, device)
    print(f"[render_warp] field: encoder={fcfg.encoder} device={device}")
    ds = SMPLMultiviewDataset(opt.data_path)
    subsample = int(ds.H / opt.resolution)
    rays_o, rays_d = ds.gen_rays_pose(ds.poses[opt.render_view], subsample, device)

    settings = WarpRenderSettings(normal_mode=opt.normal_mode)
    bg = 1.0 if opt.white_bkg else 0.0
    if opt.sampler == "parity":
        render = make_warp_frame_renderer(params, fcfg, settings, bg)
    else:
        # the per-chunk budget from the pose sequence itself: no frame is clipped
        budget = derive_warp_budget(world_verts, rays_o, rays_d, settings)
        print(f"[render_warp] derived sample budget: {budget}/chunk (zero-clip over {n_frames} frames)")
        render = make_warp_frame_renderer_fast(params, fcfg, settings, budget, bg)

    exp_dir = os.path.join(opt.out_dir, "test_views", opt.exp_name)
    os.makedirs(exp_dir, exist_ok=True)
    preds = []
    for i in range(n_frames):
        rgb = render(rays_o, rays_d, WarpData.create(world_verts[i], model.faces, Ts[i], device))
        img = integerify_img(rgb.reshape(opt.resolution, opt.resolution, 3).cpu().numpy())
        path = os.path.join(exp_dir, f"{opt.exp_name}_{i:04d}.png")
        write_png(path, img)
        print(f"image saved: {path}")
        preds.append(img)
    if opt.render_type == "interp_shape":
        preds = preds + preds[::-1]  # a smoother loop (the reference's render_warp.py:118-120)
    gif = os.path.join(exp_dir, f"{opt.exp_name}.gif")
    write_gif(gif, preds, fps=10, loop=0)
    print(f"gif saved: {gif}")


if __name__ == "__main__":
    main()
