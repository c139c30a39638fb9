"""PSNR of a reconstruction against its dataset: port of the JAX package's
tools/eval_psnr.py, with its flags, defaults and JSON line.

The field is a baked artifact (``--ckpt`` with ``--grid_path``: exactly
what bench.py and the render CLIs load, fp16 tables) or a train state
(``--state``: an orbax directory, either package's, or a port ``.pt``
train-state file, through ``utils/checkpoint.py::load_train_state``). Each of
``--views`` renders at ``H // --level`` through the canonical fast frame
renderer (``workloads/canonical_render.py::make_fast_frame_renderer``: the
table gathered by the all_gather_rows kernel once a view), optionally
supersampled and box-downsampled, against the mask-composited ground truth
(``--gt_mode composite``) or the raw images on black (``raw``).

Three choices differ from the JAX tool, and the CPU tests name them:
``--platform`` defaults to ``default``, the CUDA card (the JAX tool's
default is ``cpu``); ``--white_bkg`` is read as a boolean (the JAX tool's
has no type, so ``--white_bkg false`` is a non-empty string and renders on
white); ``--data_path`` defaults to reconstruct_cli's ``data/smpl_da_512``
(the JAX tool's to an absolute path of the machine it was written on).

    python -m avatarcraft_tpu_torch.tools.eval_psnr --state recon/state_latest \\
        --data_path <smpl_da_512> --views 13,62,95 --level 4 [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from avatarcraft_tpu_torch.cli.options import str2bool
from avatarcraft_tpu_torch.constants import NSR_BOUND
from avatarcraft_tpu_torch.data import SMPLMultiviewDataset
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.utils.checkpoint import artifact_normal_mode, load_params_with_config, load_train_state
from avatarcraft_tpu_torch.utils.device import tool_device
from avatarcraft_tpu_torch.utils.png import write_png
from avatarcraft_tpu_torch.workloads.canonical_render import make_fast_frame_renderer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", default=None, help="train state: an orbax directory or a port .pt file")
    ap.add_argument("--ckpt", default=None,
                    help="baked .pth.tar artifact (e.g. artifacts/canonical/bare_smpl_tpu.pth.tar): evaluates "
                         "exactly what bench.py and the render CLIs load (fp16 tables); requires --grid_path")
    ap.add_argument("--grid_path", default=None, help="density grid .npy for --ckpt")
    ap.add_argument("--data_path", default="data/smpl_da_512", help="a Blender-format set (reconstruct_cli's default)")
    ap.add_argument("--views", default="13,62,95")
    ap.add_argument("--level", default=4, type=int, help="resolution divisor")
    ap.add_argument("--platform", default="default", choices=["cpu", "default"],
                    help="default: the CUDA card; cpu: the CPU")
    ap.add_argument("--encoder", default="tpu_pyramid")
    ap.add_argument("--chunk", default=16384, type=int)
    ap.add_argument("--n_probes", default=192, type=int)
    ap.add_argument("--k_samples", default=32, type=int)
    ap.add_argument("--normal_mode", default=None, choices=["fd7", "fd4", "analytic"],
                    help="default: the artifact's PROVENANCE.json normal_mode when evaluating --ckpt, else fd4")
    ap.add_argument("--white_bkg", default=True, type=str2bool)
    ap.add_argument("--out_dir", default=None, help="save rendered PNGs here")
    ap.add_argument("--supersample", default=1, type=int,
                    help="render at Nx resolution and box-downsample: true partial edge coverage, matching the "
                         "dataset's antialiasing")
    ap.add_argument("--gt_box", action="store_true",
                    help="at level>1, box-downsample the GT (and cover each coarse pixel's footprint with the "
                         "supersamples) instead of point-sampling pixels")
    ap.add_argument("--band_stats", action="store_true",
                    help="also report the silhouette-band error decomposition per view: share of total MSE "
                         "inside the band (mask-boundary dilation +- band_px, plus fractional-coverage pixels) "
                         "and the interior-only PSNR")
    ap.add_argument("--band_px", default=2, type=int)
    ap.add_argument("--gt_mode", default="composite", choices=["composite", "raw"],
                    help="composite = GT mask-composited onto the render bg; raw = raw dataset image vs a "
                         "BLACK-background render (the dataset's own background)")
    return ap


def main(argv=None) -> dict:
    """Run the tool; returns the JSON result it prints."""
    ap = build_parser()
    opt = ap.parse_args(argv)
    device = tool_device(opt.platform)

    ds = SMPLMultiviewDataset(opt.data_path)
    if opt.ckpt:
        if not opt.grid_path:
            ap.error("--ckpt requires --grid_path")
        params, fcfg = load_params_with_config(opt.ckpt, device)
        grid = torch.as_tensor(np.load(opt.grid_path), dtype=torch.float32, device=device)
        step = -1
        if opt.normal_mode is None:
            opt.normal_mode = artifact_normal_mode(opt.ckpt)
        print(f"loaded baked artifact {opt.ckpt} (encoder={fcfg.encoder})", file=sys.stderr)
    elif opt.state:
        fcfg = nsr.FieldConfig(encoder=opt.encoder)
        state = load_train_state(opt.state, device)
        if state["grid"] is None:
            raise SystemExit(f"{opt.state} holds no density grid (not a fast trainer's state)")
        params, grid, step = state["params"], state["grid"], int(state["step"])
        print(f"loaded step {step} from {opt.state}", file=sys.stderr)
    else:
        ap.error("one of --state / --ckpt is required")

    opt.normal_mode = opt.normal_mode or "fd4"
    fast_cfg = nsr.FastRenderConfig(n_probes=opt.n_probes, k_samples=opt.k_samples, bound=NSR_BOUND,
                                    normal_mode=opt.normal_mode)
    bg = 0.0 if opt.gt_mode == "raw" else (1.0 if opt.white_bkg else 0.0)

    ss = max(1, opt.supersample)
    side = ds.H // opt.level
    rside = side * ss
    # a view in chunks of --chunk rays (the renderer pads only the last)
    render = make_fast_frame_renderer(params, fcfg, fast_cfg, grid, chunk=min(opt.chunk, rside * rside), bg_color=bg)
    ys = np.round(np.linspace(0, ds.H - 1, side)).astype(int)
    xs = np.round(np.linspace(0, ds.W - 1, side)).astype(int)

    def subpixel_rays(pose, centers, span=1.0):
        """Rays at pixel centers +- subpixel offsets covering a ``span``-pixel
        footprint (box coverage), computed in numpy as the JAX tool does."""
        offs = ((np.arange(ss) + 0.5) / ss - 0.5) * span
        coords = (centers[:, None] + offs[None, :]).reshape(-1)  # [side*ss]
        px, py = np.meshgrid(coords, coords, indexing="xy")
        K = ds.K
        p = np.stack([(px - K[0, 2]) / K[0, 0], -(py - K[1, 2]) / K[1, 1], -np.ones_like(px)],
                     axis=-1).astype(np.float32)
        vv = p / np.linalg.norm(p, axis=-1, keepdims=True)
        rd = vv @ pose[:3, :3].T
        ro = np.broadcast_to(pose[:3, 3], rd.shape)
        return (torch.as_tensor(np.ascontiguousarray(ro.reshape(-1, 3)), device=device),
                torch.as_tensor(np.ascontiguousarray(rd.reshape(-1, 3)), device=device))

    results = {}
    band_stats = {}
    for v in [int(x) for x in opt.views.split(",") if x.strip()]:
        if opt.level > 1 and opt.gt_box:
            L = opt.level
            centers = np.arange(side) * L + (L - 1) / 2.0
            rays_o, rays_d = subpixel_rays(ds.poses[v], centers, span=float(L))
        else:
            rays_o, rays_d = subpixel_rays(ds.poses[v], ys.astype(np.float64))
        img = render(rays_o, rays_d)["rgb"].cpu().numpy().reshape(rside, rside, 3)
        if ss > 1:  # box-downsample: true partial edge coverage
            img = img.reshape(side, ss, side, ss, 3).mean(axis=(1, 3))
        if opt.level > 1 and opt.gt_box:
            # box-downsample the GT too (consistent with the box render)
            L = opt.level
            gt_full = ds.images[v]
            gt = gt_full.reshape(side, L, side, L, 3).mean(axis=(1, 3))
            if opt.gt_mode != "raw":
                m_full = ds.masks[v][..., None]
                gt = (gt_full * m_full + (1 - m_full) * bg).reshape(side, L, side, L, 3).mean(axis=(1, 3))
        elif opt.gt_mode == "raw":
            gt = ds.images[v][np.ix_(ys, xs)]
        else:
            m = ds.masks[v][np.ix_(ys, xs)][..., None]
            gt = ds.images[v][np.ix_(ys, xs)] * m + (1.0 - m) * bg
        mse = float(np.mean((img - gt) ** 2))
        psnr = -10.0 * np.log10(max(mse, 1e-12))
        results[v] = psnr
        print(f"view {v} @{side}x{side} (ss={ss}, {opt.gt_mode}): PSNR {psnr:.2f} dB", file=sys.stderr)
        if opt.band_stats:
            m_full = ds.masks[v].astype(np.float32)
            if opt.level > 1 and opt.gt_box:
                mm = m_full.reshape(side, opt.level, side, opt.level).mean(axis=(1, 3))
            else:
                mm = m_full[np.ix_(ys, xs)]
            mb = mm > 0.5
            b = opt.band_px
            lo, hi = mb.copy(), mb.copy()
            for dy in range(-b, b + 1):
                for dx in range(-b, b + 1):
                    if dy == 0 and dx == 0:
                        continue
                    sh = np.roll(np.roll(mb, dy, axis=0), dx, axis=1)
                    lo &= sh
                    hi |= sh
            band = (hi & ~lo) | ((mm > 0.0) & (mm < 1.0))
            se = ((img - gt) ** 2).mean(axis=-1)
            share = float(se[band].sum() / max(se.sum(), 1e-12))
            mse_int = float(se[~band].mean()) if (~band).any() else 0.0
            band_stats[v] = {
                "band_frac": float(band.mean()),
                "band_mse_share": share,
                "interior_psnr": -10.0 * np.log10(max(mse_int, 1e-12)),
            }
            print(f"  band {100 * band.mean():.1f}% of px carries {100 * share:.0f}% of MSE; interior "
                  f"{band_stats[v]['interior_psnr']:.2f} dB", file=sys.stderr)
        if opt.out_dir:
            os.makedirs(opt.out_dir, exist_ok=True)
            write_png(os.path.join(opt.out_dir, f"eval_v{v}_s{step}.png"),
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))

    out = {
        "step": step,
        "level": opt.level,
        "supersample": ss,
        "gt_mode": opt.gt_mode,
        "normal_mode": opt.normal_mode,
        "psnr": results,
        "mean_psnr": sum(results.values()) / max(len(results), 1),
    }
    if band_stats:
        out["band_stats"] = band_stats
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
