"""CLI: SDS avatar creation (port of the JAX package's cli/stylize_cli.py;
reference: stylize.py entry point). Flag names and defaults are the JAX
package's: ``--sampler parity`` (the default) trains through the 64+64
importance render with fd7 normals and validates on its unjittered frame;
``--sampler fast`` through the occupancy-guided render against a density
grid (``--grid_path``, else refreshed from the field) with a derived sample
budget. Both stylize pyramid and hash-grid checkpoints.

    python -m avatarcraft_tpu_torch.cli.stylize_cli \\
        --weights_path artifacts/canonical/bare_smpl_tpu.pth.tar \\
        --guidance_type toy --tgt_text lava --max_steps 200

``--guidance_type toy`` reads the trained toy denoiser from ``--toy_weights``
(config.json + params_torch.npz); ``diffusion`` with ``--sd_weights DIR``
loads Stable Diffusion (``--sd_version`` 1.5, or 2.0 for SD 2.0-depth, which
conditions on the frame's depth) from DIR's unet.pt, vae.pt,
text_encoder.pt and tokenizer/merges.txt (``models/sd.py::
load_stable_diffusion_modules``); ``diffusion`` without ``--sd_weights``
runs the deterministic stand-in guidance (a pipeline smoke run, no
meaningful styles). Validation renders are PNGs, checkpoints ``.pth.tar``
with their field-config sidecar, and every ``--i_mesh`` steps a mesh
``.ply`` of the style field at MESH_RESOLUTION^3 (the SDF lattice on the
device, the native extractor on the host). ``--use_cuda false`` runs on
the CPU.

``--implicit_model`` is parsed and not read, as in the JAX package (one
line says so). Refused before anything is written: ``--guidance_type
clip``, as the JAX package refuses it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from avatarcraft_tpu_torch.cameras import default_360_path, pose2rays, style_360_path
from avatarcraft_tpu_torch.cli import options
from avatarcraft_tpu_torch.constants import (
    CAN_HEAD_CAMERA_DIST,
    CAN_HEAD_OFFSET,
    CANONICAL_CAMERA_DIST_TRAIN,
    CANONICAL_CAMERA_DIST_VAL,
    NSR_BOUND,
)
from avatarcraft_tpu_torch.models.diffusion import SDSGuidance, make_dummy_modules
from avatarcraft_tpu_torch.models.instant_nsr import (
    FastRenderConfig,
    RenderConfig,
    count_fast_samples,
    extract_geometry,
    render_rays_chunked,
)
from avatarcraft_tpu_torch.models.sd import load_stable_diffusion_modules
from avatarcraft_tpu_torch.models.toy_guidance import STYLES, load_toy_guidance, make_toy_modules, style_index
from avatarcraft_tpu_torch.ops.occupancy import init_density_grid
from avatarcraft_tpu_torch.utils.checkpoint import (
    artifact_normal_mode,
    load_params_with_config,
    map_leaves,
    save_params_with_config,
)
from avatarcraft_tpu_torch.utils.mesh_export import save_ply
from avatarcraft_tpu_torch.utils.metrics import integerify_img
from avatarcraft_tpu_torch.utils.png import write_png
from avatarcraft_tpu_torch.workloads.reconstruct import make_grid_update_fn
from avatarcraft_tpu_torch.workloads.stylize import (
    StylizeConfig,
    StylizeTrainer,
    make_phaseA_render_fast,
)

MESH_RESOLUTION = 512  # the lattice of every --i_mesh export (the JAX CLI's constant)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    options.set_general_option(parser)
    options.set_nerf_option(parser)
    options.set_pe_option(parser)
    options.set_render_option(parser)
    options.set_trajectory_option(parser)
    parser.add_argument("--guidance_type", default="diffusion", choices=["clip", "diffusion", "toy"],
                        help="toy = the trained conditional denoiser (models/toy_guidance)")
    parser.add_argument("--toy_weights", default="artifacts/toy_guidance", type=str,
                        help="toy-guidance checkpoint dir (--guidance_type toy)")
    parser.add_argument("--tgt_text", default="zombie", type=str)
    parser.add_argument("--subsample_scale", default=4, type=int)
    parser.add_argument("--stylize_head", default=True, type=options.str2bool)
    parser.add_argument("--implicit_model", default="instant_nsr", choices=["neus", "instant_nsr"])
    parser.add_argument("--batch_size", type=int, default=4096)
    parser.add_argument("--guidance_scale", default=100, type=float)
    parser.add_argument("--sd_version", default="1.5", type=str, choices=["1.5", "2.0"])
    parser.add_argument("--sd_weights", default=None, type=str,
                        help="directory of Stable Diffusion state dicts: unet.pt, vae.pt, text_encoder.pt, "
                             "tokenizer/merges.txt")
    parser.add_argument("--use_opacity", default=True, type=options.str2bool)
    parser.add_argument("--w_opacity", default=1e5, type=float,
                        help="opacity-loss weight (reference: stylize.py:193)")
    parser.add_argument("--w_eikonal", default=0.01, type=float)
    parser.add_argument("--exp_name", type=str, default="zombie")
    parser.add_argument("--epochs", default=2, type=int)
    parser.add_argument("--coarse_epochs", default=40, type=int)
    parser.add_argument("--fine_epochs", default=20, type=int)
    parser.add_argument("--lr", default=5e-3, type=float)
    parser.add_argument("--i_val", default=100, type=int)
    parser.add_argument("--i_save", default=1000, type=int)
    parser.add_argument("--i_mesh", default=1000, type=int)
    parser.add_argument("--augment_bkg", default=True, type=options.str2bool)
    parser.add_argument("--augment_cam", default=True, type=options.str2bool)
    parser.add_argument("--augment_text", default=True, type=options.str2bool)
    parser.add_argument("--coarse_head", default=0.2, type=float)
    parser.add_argument("--fine_head", default=0.5, type=float)
    parser.add_argument("--max_steps", default=None, type=int)
    parser.add_argument("--out_dir", default="./style/canonical_360", type=str)
    parser.add_argument("--sampler", default="parity", choices=["parity", "fast"],
                        help="parity = the 64+64 importance-sampled SDS; fast = occupancy-guided K-sample SDS")
    parser.add_argument("--grid_path", default=None, type=str,
                        help="density grid .npy from reconstruct (fast sampler; refreshed from the field when "
                             "omitted)")
    parser.add_argument("--encoder", default=None, choices=["hashgrid", "tpu_pyramid"],
                        help="override the checkpoint's (inferred) encoder")
    parser.add_argument("--normal_mode", default=None, choices=["fd7", "fd4", "analytic"],
                        help="normal estimator of the fast sampler (default: the artifact's "
                             "PROVENANCE.json, else fd4; analytic = exact forward-mode gradient)")
    parser.add_argument("--sample_budget", default=-1, type=int,
                        help="fast sampler: per-call sample compaction budget. -1 = derive from the "
                             "schedule's own pose distribution against the current grid (+35%% margin); "
                             "0 = off (every ray pays k_samples)")
    return parser


def views_per_epoch(cfg: StylizeConfig, epoch: int) -> int:
    """The number of poses ``StylizeTrainer.epoch_poses`` gives an epoch:
    the n_cap body orbit plus the head boxes."""
    head_rate = cfg.coarse_head if epoch < cfg.coarse_epochs else cfg.fine_head
    n_body = 2 * (cfg.n_cap // 4) + cfg.n_cap // 2
    n_head = 2 * (int(cfg.n_cap * head_rate) // 2) if cfg.stylize_head and head_rate > 0.0 else 0
    return n_body + n_head


def refusal(opt) -> str | None:
    """Why this command line cannot run (None if it can)."""
    if opt.guidance_type == "clip":
        return "--guidance_type clip: CLIP guidance is dead in the reference too (the JAX package refuses it)"
    if opt.guidance_type == "toy" and style_index(opt.tgt_text) < 0:
        return f"--tgt_text must name a trained toy style ({', '.join(STYLES)})"
    if not opt.weights_path:
        return "--weights_path (the pretrained canonical field) is required"
    if opt.use_cuda and not torch.cuda.is_available():
        return "no CUDA card: pass --use_cuda false to run on the CPU"
    return None


def derive_sample_budget(cfg: StylizeConfig, grid: torch.Tensor, probe_cfg: FastRenderConfig, chunk: int) -> int:
    """Max probe-selected sample count over the stylize pose distribution,
    per ``chunk``-ray contiguous slice (the phase-A/B call unit), +35% margin
    for SDS geometry drift, rounded up to a multiple of 4096; 0 (no
    compaction) when that budget would drop nothing. The sweep includes the
    head-box close-ups (head rate at least 0.5), which select far more
    samples than the body views. Counted on the grid's device."""
    rng = np.random.default_rng(123)
    center, up = np.zeros(3), np.array([0.0, 1.0, 0.0])
    poses = []
    for head_rate in (cfg.coarse_head, cfg.fine_head):
        p, _ = style_360_path(
            center, up, CANONICAL_CAMERA_DIST_TRAIN, 24,
            add_noise=cfg.augment_cam, noise_scale=2.0 if cfg.augment_cam else 1.0,
            style_head=cfg.stylize_head, head_offset=CAN_HEAD_OFFSET,
            head_rate=max(head_rate, 0.5) if cfg.stylize_head else 0.0,
            head_dist=CAN_HEAD_CAMERA_DIST, rng=rng,
        )
        poses.extend(p)
    counts = []
    for pose in poses:
        ro, rd = pose2rays(cfg.H, cfg.W, pose, device=grid.device)
        n = ro.shape[0]
        c = min(chunk, n)
        counts += [count_fast_samples(ro[i : i + c], rd[i : i + c], probe_cfg, grid)
                   for i in range(0, n - c + 1, c)]
    worst = int(torch.stack(counts).max())  # one read of the device
    budget = -(-int(worst * 1.35) // 4096) * 4096
    if budget >= chunk * probe_cfg.k_samples:
        return 0  # compaction would not drop anything; run unbudgeted
    return budget


def build_guidance(opt, device) -> SDSGuidance:
    if opt.guidance_type == "toy":
        params, tcfg, embs = load_toy_guidance(opt.toy_weights, device)
        print(f"[stylize] toy guidance from {opt.toy_weights} (styles: {', '.join(tcfg.styles)})")
        return SDSGuidance(make_toy_modules(params, tcfg, embs))
    if opt.sd_weights:
        modules = load_stable_diffusion_modules(opt.sd_weights, version=opt.sd_version, device=device)
        print(f"[stylize] loaded Stable Diffusion {opt.sd_version} from {opt.sd_weights}")
        return SDSGuidance(modules)
    print("[stylize] WARNING: no --sd_weights given; using the deterministic stand-in guidance "
          "(pipeline smoke mode, no meaningful styles).")
    return SDSGuidance(make_dummy_modules(image_size=512, device=device))


def stylize_config(opt) -> StylizeConfig:
    return StylizeConfig(
        tgt_text=opt.tgt_text,
        guidance_scale=opt.guidance_scale,
        coarse_epochs=opt.coarse_epochs,
        fine_epochs=opt.fine_epochs,
        subsample_scale=opt.subsample_scale,
        batch_size=opt.batch_size,
        lr=opt.lr,
        w_eikonal=opt.w_eikonal,
        w_opacity=opt.w_opacity,
        use_opacity=opt.use_opacity,
        stylize_head=opt.stylize_head,
        coarse_head=opt.coarse_head,
        fine_head=opt.fine_head,
        augment_bkg=opt.augment_bkg,
        augment_cam=opt.augment_cam,
        augment_text=opt.augment_text,
        white_bkg=opt.white_bkg,
        sampler=opt.sampler,
    )


def setup(opt, grid_update_every: int | None = None):
    """(trainer, FieldConfig) of a parsed command line that ``refusal``
    passed, as the CLI builds them: the canonical field and the guidance,
    and for the fast sampler its density grid (``--grid_path``, else
    refreshed from the field), the normal estimator and the derived sample
    budget. ``grid_update_every`` overrides the config's refresh period (the
    CLI keeps 200). Writes nothing."""
    cfg = stylize_config(opt)
    if grid_update_every is not None:
        cfg = dataclasses.replace(cfg, grid_update_every=grid_update_every)
    device = "cuda" if opt.use_cuda else "cpu"
    params_gt, fcfg = load_params_with_config(opt.weights_path, device)
    if opt.encoder and opt.encoder != fcfg.encoder:
        fcfg = dataclasses.replace(fcfg, encoder=opt.encoder)
    print(f"[stylize] field: encoder={fcfg.encoder} sampler={opt.sampler} device={device}")
    params_style = map_leaves(params_gt, torch.Tensor.clone)
    if opt.sampler == "parity":
        return StylizeTrainer(cfg, fcfg, build_guidance(opt, device), params_style, params_gt), fcfg

    grid = None
    if opt.grid_path:
        grid = torch.as_tensor(np.load(opt.grid_path), dtype=torch.float32).to(device)
    normal_mode = opt.normal_mode
    if normal_mode is None:
        # honor the normal estimator the baked artifact was trained with
        normal_mode = artifact_normal_mode(opt.weights_path)
        if normal_mode:
            print(f"[stylize] normal_mode={normal_mode} (from artifact provenance)")
    fast_cfg = FastRenderConfig(bound=NSR_BOUND, normal_mode=normal_mode or "fd4")
    if grid is None:
        # the trainer would refresh it anyway; do it here so the budget
        # derivation below probes against the real occupancy
        grid = make_grid_update_fn(fcfg, NSR_BOUND)(params_style, init_density_grid(129, device))
    if opt.sample_budget < 0:
        budget = derive_sample_budget(cfg, grid, fast_cfg, opt.batch_size)
        print(f"[stylize] derived sample budget: {budget} (0 = compaction off)", flush=True)
    else:
        budget = opt.sample_budget
    fast_cfg = dataclasses.replace(fast_cfg, sample_budget=budget)
    trainer = StylizeTrainer(cfg, fcfg, build_guidance(opt, device), params_style, params_gt, grid=grid,
                             fast_cfg=fast_cfg)
    return trainer, fcfg


def main(argv=None) -> StylizeTrainer:
    """Run the CLI; returns the trainer after its last step."""
    opt = build_parser().parse_args(argv)
    why = refusal(opt)
    if why:
        raise SystemExit(why)
    options.note_unread_implicit_model(opt, "stylize")
    trainer, fcfg = setup(opt)
    cfg, device = trainer.cfg, trainer.device
    options.print_opt(opt, os.path.join(opt.out_dir, opt.exp_name))
    exp_dir = os.path.join(opt.out_dir, opt.exp_name)
    os.makedirs(exp_dir, exist_ok=True)

    rcfg_val = RenderConfig(num_steps=64, upsample_steps=64, bound=NSR_BOUND)

    def val_render(ro, rd):
        """The validation frame: parity, the 64+64 render without jitter on
        white, fd7; fast, the fast sampler against the live grid. Both in
        batch_size-ray calls (the fast budget is sized per call)."""
        if not trainer.fast:
            with torch.no_grad():
                return render_rays_chunked(trainer.params(), ro, rd, fcfg, rcfg_val, 1.0, chunk=opt.batch_size)["rgb"]
        n = ro.shape[0]
        pad = (-n) % opt.batch_size
        if pad:
            ro = torch.cat([ro, ro.new_zeros((pad, 3))])
            rd = torch.cat([rd, rd[-1:].expand(pad, 3)])
        render = make_phaseA_render_fast(fcfg, trainer.fast_cfg, opt.batch_size)
        rgb, _ = render(trainer.params(), ro, rd, torch.ones_like(ro), trainer.grid)
        return rgb[:n]

    def log_img(step):
        poses, _ = default_360_path(np.zeros(3), np.array([0.0, 1.0, 0.0]), CANONICAL_CAMERA_DIST_VAL, cfg.n_cap)
        rays_o, rays_d = pose2rays(cfg.H, cfg.W, poses[0], device=device)
        img = integerify_img(val_render(rays_o, rays_d).reshape(cfg.H, cfg.W, 3).cpu().numpy())
        path = os.path.join(exp_dir, f"{opt.exp_name}_{step + 1:04d}_body.png")
        write_png(path, img)
        print(f"image saved: {path}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # the rate is timed from the end of the first step (its kernels build
    # and its allocations would skew it)
    clock = {"t0": None, "step0": 0}

    def on_step(step, trainer):
        if clock["t0"] is None:
            sync()
            clock["t0"], clock["step0"] = time.perf_counter(), step + 1
        elif (step + 1) % 20 == 0:
            sync()
            rate = (step + 1 - clock["step0"]) / (time.perf_counter() - clock["t0"])
            print(f"[stylize] step {step + 1} ({rate:.2f} steps/s)", flush=True)
        if (step + 1) % opt.i_val == 0:
            log_img(step)
        if (step + 1) % opt.i_save == 0:
            path = os.path.join(exp_dir, f"{opt.exp_name}_{step + 1:04d}.pth.tar")
            save_params_with_config(trainer.params(), path, fcfg)
            print(f"weights saved: {path}")
        if (step + 1) % opt.i_mesh == 0:
            verts, faces = extract_geometry(trainer.params(), fcfg, NSR_BOUND, MESH_RESOLUTION)
            path = os.path.join(exp_dir, f"{opt.exp_name}_{step + 1:04d}.ply")
            save_ply(verts, faces, path)
            print(f"mesh saved: {path} ({len(verts)} vertices, {len(faces)} faces)")

    steps = trainer.train(max_steps=opt.max_steps, on_step=on_step)
    final = os.path.join(exp_dir, f"{opt.exp_name}_final.pth.tar")
    save_params_with_config(trainer.params(), final, fcfg)
    print(f"finished {steps} SDS steps; weights saved: {final}")
    return trainer


if __name__ == "__main__":
    main()
