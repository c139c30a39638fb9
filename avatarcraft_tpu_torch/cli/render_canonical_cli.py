"""CLI: 360-degree canonical renders, body + head orbits (port of the JAX
package's cli/render_canonical_cli.py; reference: render_canonical.py:37-137).

    python -m avatarcraft_tpu_torch.cli.render_canonical_cli \
        --weights_path artifacts/canonical/bare_smpl_tpu.pth.tar

``--sampler parity`` (the default, as in the JAX package) renders the
64+64 importance-sampled pipeline in ``--batch_size``-ray chunks without
jitter. ``--sampler fast`` renders the occupancy-guided K-sample pipeline
against the density grid of ``--grid_path``, refreshed from the field's SDF
when omitted. The normal estimator is ``--normal_mode``, else the
artifact's PROVENANCE.json, else fd7 (parity) or fd4 (fast).

Writes one PNG per frame and one GIF per orbit at 15 fps
(``<exp>_{body,head}_can.gif``, ``utils.gif``) under
``<out_dir>/canonical_360/<exp_name>/``. ``--log_extra true`` adds each
frame's depth as a JET PNG (``_depth.png``: the depth normalised over the
frame, the empty pixels black, cv2's BGR output written as RGB, as the JAX
package writes it) and each orbit's intrinsics and camera-to-world poses as
pickles. ``--encoder`` overrides the checkpoint's encoder. The flags are the
JAX CLI's (its flag groups of the reference's options.py included), so its
command lines parse; ``--implicit_model neus|nerf`` is refused (ROADMAP
item 20). ``--use_cuda false`` renders on the CPU.

``--mesh_devices N`` (N > 1) renders each frame data parallel over N ranks
(``parallel.mesh.launch``; gloo, one process a rank): rank r renders rows
[r hw/N, (r+1) hw/N) of the frame's rays through the same renderer as one
process, on card r % (the card count), several ranks sharing a card when
there are fewer cards, which the run prints; rank 0 gathers the frame and
writes the same PNGs and GIFs. It refuses an h*w that N does not divide.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle

import numpy as np
import torch

from avatarcraft_tpu_torch.cameras import canonical_camera, default_360_path, pose2rays
from avatarcraft_tpu_torch.cli import options
from avatarcraft_tpu_torch.constants import CAN_HEAD_CAMERA_DIST, CAN_HEAD_OFFSET, NSR_BOUND
from avatarcraft_tpu_torch.models.instant_nsr import FastRenderConfig, RenderConfig
from avatarcraft_tpu_torch.ops.occupancy import init_density_grid
from avatarcraft_tpu_torch.parallel.mesh import all_gather_rows_of, data_sharding, launch, one_rank
from avatarcraft_tpu_torch.utils.checkpoint import artifact_normal_mode, load_params_with_config
from avatarcraft_tpu_torch.utils.gif import jet_colormap, write_gif
from avatarcraft_tpu_torch.utils.metrics import integerify_img
from avatarcraft_tpu_torch.utils.png import write_png
from avatarcraft_tpu_torch.workloads.canonical_render import make_fast_frame_renderer, make_parity_frame_renderer
from avatarcraft_tpu_torch.workloads.reconstruct import make_grid_update_fn

# the reference overrides the module constant for its video
# (render_canonical.py:34)
CANONICAL_CAMERA_DIST_VAL = 1.7


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    options.set_general_option(parser)
    options.set_nerf_option(parser)
    options.set_pe_option(parser)
    options.set_render_option(parser)
    options.set_trajectory_option(parser)
    parser.add_argument("--exp_name", default="exp", type=str)
    parser.add_argument("--implicit_model", default="instant_nsr", choices=["neus", "nerf", "instant_nsr"],
                        help="instant_nsr; the legacy neus and nerf fields are not ported yet")
    parser.add_argument("--log_extra", default=False, type=options.str2bool,
                        help="also write each frame's JET depth PNG and each orbit's camera pickles")
    parser.add_argument("--batch_size", type=int, default=4096)
    parser.add_argument("--out_dir", default="./demo", type=str)
    parser.add_argument("--encoder", default=None, choices=["hashgrid", "tpu_pyramid"],
                        help="override the checkpoint's (inferred) encoder")
    parser.add_argument("--sampler", default="parity", choices=["parity", "fast"],
                        help="parity = the 64+64 importance-sampled render; fast = "
                             "occupancy-guided K-sample rendering")
    parser.add_argument("--grid_path", default=None, type=str,
                        help="density grid .npy for --sampler fast (from "
                             "reconstruct); omit = refresh a 129^3 grid from the SDF")
    parser.add_argument("--normal_mode", default=None, choices=["fd7", "fd4", "analytic"],
                        help="normal estimator (default: the artifact's "
                             "PROVENANCE.json, else fd7 for parity, fd4 for fast; "
                             "analytic = exact forward-mode gradient)")
    parser.add_argument("--mesh_devices", default=0, type=int,
                        help="ray-axis data parallelism over this many ranks (processes); 0 or 1: one process")
    return parser


def depth_image(depth: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 of a frame's depth [H, W, 1], as the JAX package
    writes it (cli/render_canonical_cli.py:234-248; the reference's
    render_canonical.py:85-109): depths under 0.4 (empty pixels) set to
    0.45, the frame normalised to [0, 1], its 8-bit levels through cv2's
    JET (BGR), the empty pixels black."""
    depth = depth.copy()
    mask = depth < 4e-1
    depth[mask] = 0.45
    depth = (depth - depth.min()) / max(depth.max() - depth.min(), 1e-8)
    img = jet_colormap((depth * 255).astype(np.uint8))
    img[mask.repeat(3, axis=2)] = 0
    return img


def main(argv=None):
    parser = build_parser()
    opt = parser.parse_args(argv)
    if opt.weights_path is None:
        parser.error("--weights_path is required")
    if opt.implicit_model != "instant_nsr":
        raise SystemExit(f"--implicit_model {opt.implicit_model} is not ported yet (ROADMAP item 20, legacy models); "
                         "use instant_nsr")
    device = "cuda" if opt.use_cuda else "cpu"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --use_cuda false to render on the CPU")
    if opt.mesh_devices > 1:
        h, w = opt.render_h or 256, opt.render_w or 256
        if (h * w) % opt.mesh_devices:
            raise SystemExit(f"--mesh_devices {opt.mesh_devices} does not divide a frame's {h}x{w} = {h * w} rays "
                             "into equal shards")
        launch(render_orbits, opt.mesh_devices, opt, device=device)
        return
    render_orbits(one_rank(device), opt)


def render_orbits(mesh, opt) -> None:
    """Render and write both orbits on ``mesh.device``: each rank of
    ``mesh`` renders its rows of every frame and rank 0 writes the gathered
    frame."""
    device = mesh.device
    writer = mesh.rank == 0
    say = print if writer else (lambda *a, **k: None)
    h = opt.render_h or 256
    w = opt.render_w or 256
    params, fcfg = load_params_with_config(opt.weights_path, device)
    if opt.encoder and opt.encoder != fcfg.encoder:
        fcfg = dataclasses.replace(fcfg, encoder=opt.encoder)
    bg = 1.0 if opt.white_bkg else 0.0
    # baked artifacts record the estimator their color net was trained
    # against (PROVENANCE.json); it holds for both samplers, as in the JAX package
    normal_mode = (opt.normal_mode or artifact_normal_mode(opt.weights_path)
                   or ("fd7" if opt.sampler == "parity" else "fd4"))
    say(f"[render] field: encoder={fcfg.encoder} sampler={opt.sampler} normal_mode={normal_mode} device={device}")
    if opt.sampler == "parity":
        rcfg = RenderConfig(num_steps=64, upsample_steps=64, bound=NSR_BOUND, perturb=False, normal_mode=normal_mode)
        render = make_parity_frame_renderer(params, fcfg, rcfg, chunk=opt.batch_size, bg_color=bg)
    else:
        if opt.grid_path:
            grid = torch.as_tensor(np.load(opt.grid_path), dtype=torch.float32).to(device)
        else:
            say("[render] refreshing the density grid from the SDF ...")
            grid = make_grid_update_fn(fcfg, NSR_BOUND)(params, init_density_grid(129, device))
        cfg = FastRenderConfig(n_probes=192, k_samples=32, bound=NSR_BOUND, normal_mode=normal_mode)
        render = make_fast_frame_renderer(params, fcfg, cfg, grid, chunk=opt.batch_size * 4, bg_color=bg)

    center, up = np.zeros(3), np.array([0.0, 1.0, 0.0])
    body_poses, _ = default_360_path(center, up, CANONICAL_CAMERA_DIST_VAL, opt.trajectory_resolution)
    head_poses, _ = default_360_path(
        center + up * CAN_HEAD_OFFSET, up, CAN_HEAD_CAMERA_DIST, opt.trajectory_resolution
    )
    exp_dir = os.path.join(opt.out_dir, "canonical_360", opt.exp_name)
    if writer:
        os.makedirs(exp_dir, exist_ok=True)
    if mesh.distributed:
        say(f"[render] ray axis sharded over {mesh.size} ranks")
    for pose_name, poses in (("body", body_poses), ("head", head_poses)):
        imgs = []
        for i, c2w in enumerate(poses):
            rays_o, rays_d = pose2rays(h, w, c2w, device=device)
            rows = data_sharding(mesh, h * w)
            part = render(rays_o[rows], rays_d[rows])
            out = {k: all_gather_rows_of(part[k], mesh) for k in ("rgb", "depth")}
            if not writer:
                continue
            img = integerify_img(out["rgb"].reshape(h, w, 3).cpu().numpy())
            imgs.append(img)
            path = os.path.join(exp_dir, f"{opt.exp_name}_{pose_name}_can_{i:04d}.png")
            write_png(path, img)
            say(f"image saved: {path}")
            if opt.log_extra:
                write_png(os.path.join(exp_dir, f"{opt.exp_name}_{pose_name}_can_{i:04d}_depth.png"),
                          depth_image(out["depth"].reshape(h, w, 1).cpu().numpy()))
        if not writer:
            continue
        gif = os.path.join(exp_dir, f"{opt.exp_name}_{pose_name}_can.gif")
        write_gif(gif, imgs, fps=15, loop=0)
        say(f"gif saved: {gif}")
        if opt.log_extra:
            with open(os.path.join(exp_dir, f"{opt.exp_name}_{pose_name}_intrinsic.pkl"), "wb") as f:
                pickle.dump(canonical_camera(h, w).intrinsic, f)
            with open(os.path.join(exp_dir, f"{opt.exp_name}_{pose_name}_extrinsic.pkl"), "wb") as f:
                pickle.dump(np.stack([np.asarray(c2w) for c2w in poses]), f)


if __name__ == "__main__":
    main()
