"""Does compositing alone explain the native-512 PSNR plateau? Port of
the JAX package's tools/synth_gt_band_check.py, with its flags, defaults
and JSON.

The claim under test: the residual PSNR gap at native 512 lives in the
few-% silhouette band, because the dataset's ground truth composites edges
with a mesh rasterizer's fractional coverage of an opaque surface, which a
black-composited volumetric render (a ray's value w·c, w its opacity)
cannot reproduce even for the same geometry. So, with the committed field
as the only geometry:

* a synthetic mesh-like ground truth: the view rendered at ``--ss_gt``
  subsamples a pixel side with HARD coverage (a subsample is the surface
  colour where w > 0.5, else black), then box-downsampled;
* the eval protocol's render: soft w·c on black at ``--ss_eval``.

If the claim holds, the eval render against the synthetic ground truth
shows the real ground truth's error signature: the interior near
lossless, nearly all the MSE in the band of fractional-coverage pixels
(dilated by ``--band_px``).

The table is gathered once (the all_gather_rows kernel) and the lookup
tables built once for every chunk of both renders, each chunk through
``render_rays_fast`` with no sample budget. The rays are computed in
numpy (float64, cast to float32) as the JAX tool computes them. Only the
set's poses, intrinsics and height are read from ``--data_path``.

Where the port differs from the JAX tool, on purpose: ``--platform``
defaults to ``default``, the CUDA card (the JAX tool has no flag);
``--data_path`` defaults to reconstruct_cli's ``data/smpl_da_512`` (the
JAX tool's to an absolute path of the machine it was written on).

    python -m avatarcraft_tpu_torch.tools.synth_gt_band_check --data_path <smpl_da_512> [--view 13] [--ss_gt 4] \\
        [--out synth_band_view13.json] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
from scipy.ndimage import binary_dilation

from avatarcraft_tpu_torch.constants import NSR_BOUND
from avatarcraft_tpu_torch.data import SMPLMultiviewDataset
from avatarcraft_tpu_torch.models.instant_nsr import FastRenderConfig, render_rays_fast
from avatarcraft_tpu_torch.parallel.table_mp import shard_grid_rows
from avatarcraft_tpu_torch.utils.checkpoint import artifact_normal_mode, load_params_with_config
from avatarcraft_tpu_torch.utils.device import tool_device
from avatarcraft_tpu_torch.workloads.canonical_render import gathered_field

# the real ground truth's figure the JSON carries beside the synthetic one
OBSERVED_AGAINST_REAL_GT = {"psnr": 33.46, "note": "ftedge native-512 view 13 (ss=2, raw GT)"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="artifacts/canonical/bare_smpl_tpu.pth.tar")
    ap.add_argument("--grid_path", default="artifacts/canonical/grid.npy")
    ap.add_argument("--data_path", default="data/smpl_da_512", help="a Blender-format set (reconstruct_cli's default)")
    ap.add_argument("--view", default=13, type=int)
    ap.add_argument("--side", default=512, type=int)
    ap.add_argument("--ss_gt", default=4, type=int, help="GT supersampling")
    ap.add_argument("--ss_eval", default=2, type=int, help="eval-protocol ss")
    ap.add_argument("--band_px", default=2, type=int)
    ap.add_argument("--chunk", default=65536, type=int)
    ap.add_argument("--out", default="docs/eval/synth_band_view13.json")
    ap.add_argument("--platform", default="default", choices=["cpu", "default"],
                    help="default: the CUDA card; cpu: the CPU")
    return ap


def rays_at(ds, pose: np.ndarray, side: int, ss: int) -> tuple[np.ndarray, np.ndarray]:
    """Subpixel rays covering every one of side x side output pixels with an
    ss x ss box: (origins, directions) [side*ss*side*ss, 3] float32."""
    offs = (np.arange(ss) + 0.5) / ss - 0.5
    centers = np.round(np.linspace(0, ds.H - 1, side)).astype(float)
    coords = (centers[:, None] + offs[None, :]).reshape(-1)
    px, py = np.meshgrid(coords, coords, indexing="xy")
    K = ds.K
    p = np.stack([(px - K[0, 2]) / K[0, 0], -(py - K[1, 2]) / K[1, 1], -np.ones_like(px)],
                 axis=-1).astype(np.float32)
    vv = p / np.linalg.norm(p, axis=-1, keepdims=True)
    rd = vv @ pose[:3, :3].T
    ro = np.broadcast_to(pose[:3, 3], rd.shape)
    return ro.reshape(-1, 3).astype(np.float32), rd.reshape(-1, 3).astype(np.float32)


def band_check(hard: tuple, soft: tuple, side: int, ss_gt: int, ss_eval: int, band_px: int) -> dict:
    """The comparison from the two renders' (rgb [N,3], w [N]) in numpy:
    the numbers of the JSON, and the arrays behind them (``gt``, ``img``,
    ``covered``, ``band``)."""
    rgb, w = hard
    covered = w > 0.5
    # the covered subsamples' surface colour (un-premultiplied), black elsewhere
    surf = np.where(covered[:, None], rgb / np.maximum(w[:, None], 1e-6), 0.0)
    gt = surf.reshape(side, ss_gt, side, ss_gt, 3).mean(axis=(1, 3))
    gt_cov = covered.reshape(side, ss_gt, side, ss_gt).mean(axis=(1, 3))
    img = soft[0].reshape(side, ss_eval, side, ss_eval, 3).mean(axis=(1, 3))

    se = ((img - gt) ** 2).mean(axis=-1)
    mse = float(se.mean())
    frac = (gt_cov > 0.0) & (gt_cov < 1.0)
    band = binary_dilation(frac, iterations=band_px)
    share = float(se[band].sum() / max(se.sum(), 1e-12))
    interior_mse = float(se[~band].mean()) if (~band).any() else 0.0
    return {
        "psnr": float(-10 * np.log10(max(mse, 1e-12))),
        "band_frac": float(band.mean()),
        "band_mse_share": share,
        "interior_psnr": float(-10 * np.log10(max(interior_mse, 1e-12))),
        "gt": gt, "img": img, "covered": covered, "band": band,
    }


def main(argv=None) -> dict:
    """Run the tool; returns the JSON it prints and writes."""
    opt = build_parser().parse_args(argv)
    device = tool_device(opt.platform)

    params, fcfg = load_params_with_config(opt.ckpt, device)
    grid = torch.as_tensor(np.load(opt.grid_path), dtype=torch.float32, device=device)
    ds = SMPLMultiviewDataset(opt.data_path)
    pose = ds.poses[opt.view]
    try:
        nm = artifact_normal_mode(opt.ckpt)
    except Exception:
        nm = "fd4"
    fast_cfg = FastRenderConfig(n_probes=192, k_samples=32, bound=NSR_BOUND, normal_mode=nm or "fd4")
    params_rest, shards, splice = shard_grid_rows(params)
    with torch.no_grad():
        full, field = gathered_field(params_rest, shards, splice, fcfg, NSR_BOUND)

    @torch.no_grad()
    def render_all(ro: np.ndarray, rd: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(rgb [N,3], opacity [N]) in chunks of --chunk rays, on black."""
        rgbs, ws = [], []
        for i in range(0, ro.shape[0], opt.chunk):
            o = render_rays_fast(full, torch.from_numpy(ro[i:i + opt.chunk]).to(device),
                                 torch.from_numpy(rd[i:i + opt.chunk]).to(device), fcfg, fast_cfg, grid, 0.0, field)
            rgbs.append(o["rgb"])
            ws.append(o["weight_sum"].reshape(-1))
        return torch.cat(rgbs).cpu().numpy(), torch.cat(ws).cpu().numpy()

    hard = render_all(*rays_at(ds, pose, opt.side, opt.ss_gt))
    soft = render_all(*rays_at(ds, pose, opt.side, opt.ss_eval))
    res = band_check(hard, soft, opt.side, opt.ss_gt, opt.ss_eval, opt.band_px)
    out = {
        "view": opt.view,
        "side": opt.side,
        "ss_gt_hard": opt.ss_gt,
        "ss_eval_soft": opt.ss_eval,
        "psnr_vs_synthetic_gt": round(res["psnr"], 3),
        "band_frac_of_pixels": round(res["band_frac"], 5),
        "band_mse_share": round(res["band_mse_share"], 5),
        "interior_psnr": round(res["interior_psnr"], 3),
        "observed_against_real_gt": dict(OBSERVED_AGAINST_REAL_GT),
    }
    os.makedirs(os.path.dirname(opt.out), exist_ok=True)
    with open(opt.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
