"""CLI: pretrain the canonical bare-SMPL NeuS from multiview renders (the
reference's reconstruct.py). Port of the JAX package's
cli/reconstruct_cli.py, flag for flag:

    python -m avatarcraft_tpu_torch.cli.reconstruct_cli --data_path data/smpl_da_512 \
        --exp_name recon [--sampler parity|fast] [--use_cuda false]

``--sampler parity`` (the default): the hash grid and the 64+64
importance-sampled trainer with fd7 normals and perturbed depths
(``workloads.reconstruct.train``). ``--sampler fast``: the pyramid encoder
and the occupancy-guided trainer with fd4 normals (``train_fast``), its
train state under the experiment directory. Validation renders of view 62
(the last view of a smaller set) at resolution level 4 are PNGs written by
the port's stdlib writer; weights go through ``save_params_with_config``,
meshes through ``extract_geometry`` + ``save_ply``, the fast trainer's
grid to ``<exp>_grid.npy``. Runs on the CUDA card unless ``--use_cuda
false``.

``--scan_steps S`` (fast sampler) runs S steps per call with the dataset on
the device: on the card one step captured into a CUDA graph and replayed
(``workloads.reconstruct.make_train_scan_fast``).

``--resume_from`` takes an orbax train-state directory, as this CLI and the
JAX package's write them (``<exp>/state_latest``, ``<exp>/state_final``;
read and written without orbax, ``utils/checkpoint.py``), or a port
``.pt`` train-state file.
``--implicit_model`` is parsed and not read, as in the JAX package (one
line says so).

Refused as the JAX package refuses them: ``--data_format neuman`` and
``--normal_mode analytic`` for training.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from avatarcraft_tpu_torch.cli import options
from avatarcraft_tpu_torch.constants import NSR_BOUND

VAL_VIEW, VAL_LEVEL = 62, 4  # a 128x128 validation render of view 62 at 512x512
VAL_CHUNK = 8192


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    options.set_general_option(parser)
    options.set_nerf_option(parser)
    options.set_pe_option(parser)
    options.set_render_option(parser)
    options.set_trajectory_option(parser)
    parser.add_argument("--data_format", default="neus", choices=["neuman", "neus"])
    parser.add_argument("--data_path", default="data/smpl_da_512", type=str)
    parser.add_argument("--implicit_model", default="instant_nsr", choices=["neus", "instant_nsr"])
    parser.add_argument("--exp_name", type=str, default="recon")
    parser.add_argument("--epochs", default=2, type=int)
    parser.add_argument("--lr", default=5e-4, type=float)
    parser.add_argument("--batch_size", default=1600, type=int)
    parser.add_argument("--i_val", default=2000, type=int)
    parser.add_argument("--i_save", default=2000, type=int)
    parser.add_argument("--i_mesh", default=10000, type=int)
    parser.add_argument("--mesh_resolution", default=512, type=int)
    parser.add_argument("--out_dir", default="./style/canonical_360", type=str)
    parser.add_argument("--max_steps", default=None, type=int)
    parser.add_argument("--sampler", default="parity", choices=["parity", "fast"],
                        help="parity = the reference's 64+64 importance pipeline; fast = occupancy-guided "
                             "K-sample training")
    parser.add_argument("--encoder", default=None, choices=["hashgrid", "tpu_pyramid"],
                        help="spatial encoder (default: hashgrid for parity, tpu_pyramid for fast)")
    parser.add_argument("--resume_from", default=None, type=str,
                        help="orbax train-state dir (params + optimizer moments), such as <exp>/state_latest "
                             "of either package, or a port .pt train-state file, to continue from")
    parser.add_argument("--holdout_views", default="", type=str,
                        help="comma-separated view indices excluded from training (fast sampler)")
    parser.add_argument("--save_state_every", default=0, type=int,
                        help="write resumable train state every N steps (fast sampler only)")
    parser.add_argument("--n_probes", default=128, type=int, help="occupancy probes per ray (fast sampler)")
    parser.add_argument("--k_samples", default=32, type=int, help="field samples per ray (fast sampler)")
    parser.add_argument("--sample_budget", default=0, type=int,
                        help="global field-sample budget per batch (adaptive K compaction; 0 = off)")
    parser.add_argument("--scan_steps", default=0, type=int,
                        help="optimizer steps per jit call (lax.scan over on-device batches); 0 = one step per "
                             "call. Pick a divisor of the grid refresh interval.")
    parser.add_argument("--grid_warmup_steps", default=2000, type=int,
                        help="steps with a saturated grid before the first real occupancy refresh (fast sampler)")
    parser.add_argument("--normal_mode", default=None, choices=["fd7", "fd4", "analytic"],
                        help="normal estimator (default: fd7 for parity, fd4 for fast); 'analytic' is a "
                             "render-time option and is refused for training")
    parser.add_argument("--bkg_mode", default="raw", choices=["raw", "composite", "composite_random"],
                        help="GT background handling: raw = reference parity; composite = mask-composite GT "
                             "onto the training bg; composite_random = random gray bg per step")
    return parser


def refusal(opt) -> str | None:
    """Why this command line cannot run (None if it can)."""
    if opt.data_format == "neuman":
        return "--data_format neuman: the neuman data format is dead in the reference too"
    if opt.normal_mode == "analytic":
        # reconstruction always trains with the eikonal term (0.1, reference:
        # reconstruct.py:105-106); the analytic normal's exact cell-slope
        # |grad| is the wrong signal for it (the JAX package measured PSNR
        # 31 -> 1 dB in 1k steps)
        return ("--normal_mode analytic is a render-time option; training under the analytic eikonal "
                "destroys the field. Use fd7/fd4 for training and 'analytic' only in render/eval CLIs.")
    if opt.use_cuda and not torch.cuda.is_available():
        return "no CUDA card: pass --use_cuda false to run on the CPU"
    return None


def main(argv=None):
    """Run the CLI; returns (params, stats)."""
    opt = build_parser().parse_args(argv)
    why = refusal(opt)
    if why:
        raise SystemExit(why)
    options.note_unread_implicit_model(opt, "reconstruct")
    options.print_opt(opt, os.path.join(opt.out_dir, opt.exp_name))

    from avatarcraft_tpu_torch.data import SMPLMultiviewDataset
    from avatarcraft_tpu_torch.models.instant_nsr import (
        FastRenderConfig,
        FieldConfig,
        RenderConfig,
        extract_geometry,
        render_rays_chunked,
        render_rays_fast,
    )
    from avatarcraft_tpu_torch.utils.checkpoint import save_params_with_config
    from avatarcraft_tpu_torch.utils.mesh_export import save_ply
    from avatarcraft_tpu_torch.utils.metrics import integerify_img, psnr
    from avatarcraft_tpu_torch.utils.png import write_png
    from avatarcraft_tpu_torch.workloads.reconstruct import ReconstructConfig, train, train_fast

    device = "cuda" if opt.use_cuda else "cpu"
    ds = SMPLMultiviewDataset(opt.data_path)
    encoder = opt.encoder or ("tpu_pyramid" if opt.sampler == "fast" else "hashgrid")
    fcfg = FieldConfig(encoder=encoder)
    rcfg = RenderConfig(num_steps=64, upsample_steps=64, bound=NSR_BOUND, perturb=True,
                        normal_mode=opt.normal_mode or "fd7")
    rcfg_val = RenderConfig(num_steps=64, upsample_steps=64, bound=NSR_BOUND, perturb=False)
    cfg = ReconstructConfig(batch_size=opt.batch_size, lr=opt.lr, epochs=opt.epochs, white_bkg=opt.white_bkg,
                            bkg_mode=opt.bkg_mode)
    bgv = 1.0 if opt.white_bkg else 0.0
    exp_dir = os.path.join(opt.out_dir, opt.exp_name)
    os.makedirs(exp_dir, exist_ok=True)

    @torch.no_grad()
    def val_render(params, ro, rd, grid):
        if opt.sampler == "fast":
            # the live training grid: on a saturated grid the K nearest
            # probes never reach the subject
            if grid is None:
                grid = torch.full((129,) * 3, 100.0, device=device)
            val_cfg = FastRenderConfig(n_probes=192, k_samples=32, bound=NSR_BOUND)
            return render_rays_fast(params, ro, rd, fcfg, val_cfg, grid, bgv)["rgb"]
        # chunks of at most VAL_CHUNK rays; the JAX package pads the last to
        # VAL_CHUNK for its static shapes, which changes no rendered ray
        return render_rays_chunked(params, ro, rd, fcfg, rcfg_val, bgv, chunk=min(VAL_CHUNK, ro.shape[0]))["rgb"]

    vh, vw = ds.H // VAL_LEVEL, ds.W // VAL_LEVEL
    val_view = min(VAL_VIEW, ds.n_images - 1)

    def log_val(step, params, grid=None):
        rays_o, rays_d = ds.gen_rays_at(val_view, resolution_level=VAL_LEVEL, device=device)
        img = val_render(params, rays_o, rays_d, grid).reshape(vh, vw, 3).cpu().numpy()
        ys = np.round(np.linspace(0, ds.H - 1, vh)).astype(int)
        xs = np.round(np.linspace(0, ds.W - 1, vw)).astype(int)
        m = ds.masks[val_view][np.ix_(ys, xs)][..., None]
        gt = ds.images[val_view][np.ix_(ys, xs)] * m + (1.0 - m) * bgv
        path = os.path.join(exp_dir, f"{opt.exp_name}_{step + 1:04d}.png")
        write_png(path, integerify_img(img))
        print(f"val view {val_view} @{vh}x{vw}: PSNR {psnr(img, gt):.2f} dB | saved {path}", flush=True)

    def on_step(step, params, loss, grid=None):
        if step % 200 == 0:
            print(f"step {step}: loss {float(loss):.5f}", flush=True)
        if (step + 1) % opt.i_val == 0:
            log_val(step, params(), grid)
        if (step + 1) % opt.i_save == 0:
            path = os.path.join(exp_dir, f"{opt.exp_name}_{step + 1:04d}.pth.tar")
            save_params_with_config(params(), path, fcfg)
            print(f"weights saved: {path}", flush=True)
        if (step + 1) % opt.i_mesh == 0:
            verts, faces = extract_geometry(params(), fcfg, NSR_BOUND, opt.mesh_resolution)
            path = os.path.join(exp_dir, f"{opt.exp_name}_{step + 1:04d}.ply")
            save_ply(verts, faces, path)
            print(f"mesh saved: {path}", flush=True)

    if opt.sampler == "fast":
        holdout = {int(v) for v in opt.holdout_views.split(",") if v.strip()}
        view_ids = None
        if holdout:
            view_ids = np.array([v for v in range(ds.n_images) if v not in holdout], np.int32)
            print(f"holding out views {sorted(holdout)} ({len(view_ids)} train views)")
        fast_cfg = FastRenderConfig(n_probes=opt.n_probes, k_samples=opt.k_samples, bound=NSR_BOUND,
                                    sample_budget=opt.sample_budget, normal_mode=opt.normal_mode or "fd4")
        params, grid, stats = train_fast(
            ds, fcfg, fast_cfg, cfg, max_steps=opt.max_steps, callbacks={"on_step": on_step}, view_ids=view_ids,
            state_dir=exp_dir, save_state_every=opt.save_state_every, resume_from=opt.resume_from,
            grid_warmup_steps=opt.grid_warmup_steps, scan_steps=opt.scan_steps, device=device,
        )
        np.save(os.path.join(exp_dir, f"{opt.exp_name}_grid.npy"), grid.cpu().numpy())
    else:
        params, stats = train(ds, fcfg, rcfg, cfg, max_steps=opt.max_steps, callbacks={"on_step": on_step},
                              resume_from=opt.resume_from, device=device)

    final = os.path.join(exp_dir, f"{opt.exp_name}_final.pth.tar")
    save_params_with_config(params, final, fcfg)
    print(f"weights saved: {final}")
    print(f"done: {stats['steps']} steps, {stats.get('steps_per_sec', 0):.2f} steps/s, "
          f"{stats.get('rays_per_sec', 0):.0f} rays/s", flush=True)
    return params, stats


if __name__ == "__main__":
    main()
