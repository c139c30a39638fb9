"""CLI: 360-degree canonical renders, body + head orbits, ``--sampler fast``
(port of the JAX package's cli/render_canonical_cli.py; reference:
render_canonical.py:37-137).

    python -m avatarcraft_tpu_torch.cli.render_canonical_cli \
        --weights_path artifacts/canonical/bare_smpl_tpu.pth.tar \
        --grid_path artifacts/canonical/grid.npy --sampler fast

Without ``--grid_path`` the density grid is refreshed from the field's SDF.

Writes one PNG per frame under ``<out_dir>/canonical_360/<exp_name>/``.
Flag names follow the reference; ``--use_cuda false`` renders on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from avatarcraft_tpu_torch.cameras import default_360_path, pose2rays
from avatarcraft_tpu_torch.constants import CAN_HEAD_CAMERA_DIST, CAN_HEAD_OFFSET, NSR_BOUND
from avatarcraft_tpu_torch.models.instant_nsr import FastRenderConfig
from avatarcraft_tpu_torch.ops.occupancy import init_density_grid
from avatarcraft_tpu_torch.utils.checkpoint import artifact_normal_mode, load_params_with_config
from avatarcraft_tpu_torch.utils.png import integerify_img, write_png
from avatarcraft_tpu_torch.workloads.canonical_render import make_fast_frame_renderer
from avatarcraft_tpu_torch.workloads.reconstruct import make_grid_update_fn

# the reference overrides the module constant for its video
# (render_canonical.py:34)
CANONICAL_CAMERA_DIST_VAL = 1.7


def str2bool(v: str) -> bool:
    return str(v).lower() in ("true", "1", "yes", "y", "t")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--use_cuda", type=str2bool, default=True,
                        help="render on the CUDA card; false = CPU")
    parser.add_argument("--render_h", default=None, type=int)
    parser.add_argument("--render_w", default=None, type=int)
    parser.add_argument("--weights_path", required=True, type=str)
    parser.add_argument("--white_bkg", type=str2bool, default=True)
    parser.add_argument("--trajectory_resolution", default=60, type=int)
    parser.add_argument("--exp_name", default="exp", type=str)
    parser.add_argument("--batch_size", type=int, default=4096)
    parser.add_argument("--out_dir", default="./demo", type=str)
    parser.add_argument("--sampler", default="fast", choices=["parity", "fast"],
                        help="fast = occupancy-guided K-sample rendering (the "
                             "only sampler ported so far)")
    parser.add_argument("--grid_path", default=None, type=str,
                        help="density grid .npy (from reconstruct); omit = "
                             "refresh a 129^3 grid from the SDF")
    parser.add_argument("--normal_mode", default=None, choices=["fd7", "fd4", "analytic"],
                        help="normal estimator (default: the artifact's "
                             "PROVENANCE.json, else fd4); only fd4 is ported")
    parser.add_argument("--mesh_devices", default=0, type=int,
                        help="ray-axis data parallelism; not ported yet")
    return parser


def main(argv=None):
    opt = build_parser().parse_args(argv)
    if opt.sampler != "fast":
        raise SystemExit(
            "--sampler parity is not ported yet (ROADMAP item 19, parity pipeline); "
            "use --sampler fast"
        )
    if opt.mesh_devices > 1:
        raise SystemExit(
            "--mesh_devices > 1 is not ported yet (ROADMAP item 22, parallel); "
            "render on one device"
        )
    device = "cuda" if opt.use_cuda else "cpu"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --use_cuda false to render on the CPU")

    h = opt.render_h or 256
    w = opt.render_w or 256
    params, fcfg = load_params_with_config(opt.weights_path, device)
    normal_mode = opt.normal_mode or artifact_normal_mode(opt.weights_path) or "fd4"
    print(f"[render] field: encoder={fcfg.encoder} normal_mode={normal_mode} device={device}")
    if opt.grid_path:
        grid = torch.as_tensor(np.load(opt.grid_path), dtype=torch.float32).to(device)
    else:
        print("[render] refreshing the density grid from the SDF ...")
        grid = make_grid_update_fn(fcfg, NSR_BOUND)(params, init_density_grid(129, device))
    cfg = FastRenderConfig(n_probes=192, k_samples=32, bound=NSR_BOUND, normal_mode=normal_mode)
    render = make_fast_frame_renderer(
        params, fcfg, cfg, grid, chunk=opt.batch_size * 4,
        bg_color=1.0 if opt.white_bkg else 0.0,
    )

    center, up = np.zeros(3), np.array([0.0, 1.0, 0.0])
    body_poses, _ = default_360_path(center, up, CANONICAL_CAMERA_DIST_VAL, opt.trajectory_resolution)
    head_poses, _ = default_360_path(
        center + up * CAN_HEAD_OFFSET, up, CAN_HEAD_CAMERA_DIST, opt.trajectory_resolution
    )
    exp_dir = os.path.join(opt.out_dir, "canonical_360", opt.exp_name)
    os.makedirs(exp_dir, exist_ok=True)
    for pose_name, poses in (("body", body_poses), ("head", head_poses)):
        for i, c2w in enumerate(poses):
            rays_o, rays_d = pose2rays(h, w, c2w, device=device)
            rgb = render(rays_o, rays_d)["rgb"]
            img = integerify_img(rgb.reshape(h, w, 3).cpu().numpy())
            path = os.path.join(exp_dir, f"{opt.exp_name}_{pose_name}_can_{i:04d}.png")
            write_png(path, img)
            print(f"image saved: {path}")


if __name__ == "__main__":
    main()
