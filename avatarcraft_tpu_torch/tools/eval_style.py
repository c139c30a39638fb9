"""How far a (stylized) field is from its style target: port of the JAX
package's tools/eval_style.py, with its flags, defaults and JSON line.

Three tiers of evidence, two of them independent of the palette map that
built the toy guidance's training targets:

1. **Palette distance**: per view, the target is the bare render's
   foreground remapped through the style's palette
   (``toy_guidance.apply_style``); also the distance to the nearest colour
   of the style's 64-step luminance ramp. Circular with respect to the toy
   guidance's targets, which use the same map.
2. **Foreground hue and saturation shift**: the styled render's
   saturation-weighted hue histogram, circular hue mean, mean saturation
   and chroma centroid against the bare render's.
3. **txt2img hue match** (``--guidance``): the circular earth-mover
   distance between the render's foreground hue histogram and that of the
   guidance's own txt2img samples for the style prompt, and the angle
   between their chroma centroids.

Both fields render through the canonical fast frame renderer
(``workloads/canonical_render.py::make_fast_frame_renderer``: the table
gathered by the all_gather_rows kernel once a frame) at a zero-clip budget
derived over the views and both grids. The tool runs on the CUDA card
unless ``--platform cpu``. Tier 3's initial latents come from a
``torch.Generator`` seeded 0 (``initial_latents``), where the JAX tool
draws them from ``jax.random.PRNGKey(0)``: its tier-3 numbers are this
stream's, not the JAX tool's.

    python -m avatarcraft_tpu_torch.tools.eval_style --ckpt lava.pth.tar --style lava \\
        [--grid_path lava_grid.npy] [--bare artifacts/canonical] [--guidance artifacts/toy_guidance] \\
        [--out eval_style.json] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from avatarcraft_tpu_torch.cameras import default_360_path, pose2rays
from avatarcraft_tpu_torch.constants import CANONICAL_CAMERA_DIST_VAL, NSR_BOUND
from avatarcraft_tpu_torch.models.diffusion import SDSGuidance
from avatarcraft_tpu_torch.models.instant_nsr import FastRenderConfig, count_fast_samples
from avatarcraft_tpu_torch.models.toy_guidance import (
    STYLES,
    apply_style,
    load_toy_guidance,
    make_toy_modules,
    style_map,
)
from avatarcraft_tpu_torch.ops.sampling import linspace
from avatarcraft_tpu_torch.utils.checkpoint import artifact_normal_mode, load_params_with_config
from avatarcraft_tpu_torch.utils.device import tool_device
from avatarcraft_tpu_torch.utils.png import write_png
from avatarcraft_tpu_torch.workloads.canonical_render import make_fast_frame_renderer

N_HUE_BINS = 16
# chroma weights (s * v) below this carry no hue: a near-gray pixel's hue is
# noise that ties toward red (h = 0)
HUE_WEIGHT_FLOOR = 0.05


def rgb_to_hsv(rgb):
    """[..., 3] in [0,1] -> (hue [0,1), sat [0,1], val [0,1]). numpy."""
    mx = rgb.max(axis=-1)
    mn = rgb.min(axis=-1)
    c = mx - mn
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(
            c == 0,
            0.0,
            np.where(
                mx == r,
                ((g - b) / c) % 6.0,
                np.where(mx == g, (b - r) / c + 2.0, (r - g) / c + 4.0),
            ),
        ) / 6.0
        s = np.where(mx == 0, 0.0, c / mx)
    return h, s, mx


def hue_stats(rgb, mask=None):
    """Saturation-weighted hue histogram, circular hue mean, mean saturation
    and chroma centroid over ``mask`` (or all pixels). Pixels whose chroma
    weight (s*v) is below ``HUE_WEIGHT_FLOOR`` are left out of the
    histogram and the mean hue; the centroid needs no floor (gray pixels
    add about 0 to it), so it is defined for any image."""
    h, s, v = rgb_to_hsv(rgb)
    if mask is not None:
        h, s, v = h[mask], s[mask], v[mask]
    w_raw = (s * v).ravel()
    w = np.where(w_raw < HUE_WEIGHT_FLOOR, 0.0, w_raw)
    h = h.ravel()
    ang_all = 2.0 * np.pi * h
    chroma_vec = (
        [float((np.cos(ang_all) * w_raw).mean()), float((np.sin(ang_all) * w_raw).mean())]
        if h.size else [0.0, 0.0]
    )
    hist = np.histogram(h, bins=N_HUE_BINS, range=(0.0, 1.0), weights=w)[0]
    tot = hist.sum()
    hist = hist / tot if tot > 0 else hist
    ang = 2.0 * np.pi * h
    cw = w.sum()
    if cw > 0:
        mean_vec = ((np.cos(ang) * w).sum() / cw, (np.sin(ang) * w).sum() / cw)
        mean_hue = float((np.arctan2(mean_vec[1], mean_vec[0]) / (2 * np.pi)) % 1.0)
    else:
        mean_hue = 0.0
    return {
        "hue_hist": [round(float(x), 4) for x in hist],
        "mean_hue": round(mean_hue, 4),
        "mean_sat": round(float(s.mean()), 4) if h.size else 0.0,
        "chroma_vec": [round(c, 5) for c in chroma_vec],
    }


def circular_emd(p, q):
    """Circular earth-mover distance between two hue histograms (the
    median-centred cumulative difference); None when either has (near-)zero
    mass: an achromatic image has no hue distribution."""
    p, q = np.asarray(p), np.asarray(q)
    if p.sum() < 1e-9 or q.sum() < 1e-9:
        return None
    d = np.cumsum(p - q)
    return float(np.abs(d - np.median(d)).sum() / len(d))


def chroma_dist(a, b):
    """Euclidean distance between two chroma centroids (``chroma_vec``)."""
    return float(np.hypot(a[0] - b[0], a[1] - b[1]))


def chroma_angle_deg(a, b):
    """Angle in degrees between two chroma centroids; None when either is
    shorter than 1e-3 (an achromatic image has no hue direction)."""
    ma = np.hypot(a[0], a[1])
    mb = np.hypot(b[0], b[1])
    if ma < 1e-3 or mb < 1e-3:
        return None
    cos = (a[0] * b[0] + a[1] * b[1]) / (ma * mb)
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def initial_latents(guidance: SDSGuidance, n: int, size: int, seed: int, device) -> torch.Tensor:
    """txt2img's initial latents [n, C, size/f, size/f], drawn from a
    torch.Generator seeded ``seed`` on ``device``."""
    f = guidance.m.latent_scale
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randn((n, guidance.m.latent_channels, size // f, size // f), generator=gen, device=device)


def guidance_txt2img_hue(guidance_dir, style, n=8, steps=25, seed=0, device="cuda"):
    """(hue_stats of the toy guidance's own txt2img samples for the style
    prompt, the samples as [n*H*W, 3] numpy): the target distribution
    without apply_style."""
    params, tcfg, embs = load_toy_guidance(guidance_dir, device)
    g = SDSGuidance(make_toy_modules(params, tcfg, embs))
    emb1 = g.get_text_embeds([style])
    # the prompt axis batched: each half of the CFG pair repeated n times
    emb = torch.cat([e.repeat_interleave(n, dim=0) for e in emb1.chunk(2)])
    lat = g.produce_latents(
        emb, height=tcfg.image_size, width=tcfg.image_size, num_inference_steps=steps, guidance_scale=4.0,
        latents=initial_latents(g, n, tcfg.image_size, seed, device),
    )
    imgs = g.m.vae_decode(lat).cpu().numpy()  # [n, 3, H, W] in [0,1]
    imgs = imgs.transpose(0, 2, 3, 1).reshape(-1, 3)
    return hue_stats(imgs.reshape(1, -1, 3)), imgs


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="field checkpoint to evaluate")
    ap.add_argument("--grid_path", default=None, help="density grid for --ckpt (default: the bare grid)")
    ap.add_argument("--bare", default="artifacts/canonical", help="bare canonical artifact dir (target source)")
    ap.add_argument("--style", required=True)
    ap.add_argument("--views", default=4, type=int)
    ap.add_argument("--res", default=128, type=int)
    ap.add_argument("--out", default=None)
    ap.add_argument("--save_pngs", default=None, help="dump renders here")
    ap.add_argument("--platform", default="default", choices=["cpu", "default"],
                    help="default: the CUDA card; cpu: the CPU")
    ap.add_argument("--guidance", default=None,
                    help="toy-guidance dir (e.g. artifacts/toy_guidance): also score hue-EMD against the "
                         "guidance's own txt2img samples")
    ap.add_argument("--txt2img_n", default=8, type=int)
    ap.add_argument("--txt2img_steps", default=25, type=int)
    return ap


def main(argv=None) -> dict:
    """Run the tool; returns the JSON result it prints."""
    opt = build_parser().parse_args(argv)
    device = tool_device(opt.platform)

    bare_ckpt = os.path.join(opt.bare, "bare_smpl_tpu.pth.tar")
    params_bare, fcfg_bare = load_params_with_config(bare_ckpt, device)
    params_eval, fcfg_eval = load_params_with_config(opt.ckpt, device)
    grid_bare = torch.as_tensor(np.load(os.path.join(opt.bare, "grid.npy")), device=device)
    grid_eval = torch.as_tensor(np.load(opt.grid_path), device=device) if opt.grid_path else grid_bare
    normal_mode = artifact_normal_mode(bare_ckpt) or "fd4"
    R = opt.res
    s_idx = STYLES.index(opt.style)

    # fixed holdout angles (no noise: never in the training distribution)
    poses, _ = default_360_path(np.zeros(3), np.array([0.0, 1.0, 0.0]), CANONICAL_CAMERA_DIST_VAL, opt.views)

    # a zero-clip budget over the views and both grids (SDS inflates
    # occupancy; a fixed cap could zero trailing rays)
    probe_cfg = FastRenderConfig(n_probes=192, k_samples=32, bound=NSR_BOUND)
    worst = max(
        int(count_fast_samples(*pose2rays(R, R, pose, device), probe_cfg, g))
        for pose in poses
        for g in (grid_bare, grid_eval)
    )
    fast_cfg = FastRenderConfig(n_probes=192, k_samples=32, bound=NSR_BOUND, sample_budget=int(worst * 1.02),
                                normal_mode=normal_mode)
    print(f"[eval_style] derived budget {fast_cfg.sample_budget} "
          f"(worst probe count {worst} over {len(poses)} views x 2 grids)", file=sys.stderr)

    renderers = [make_fast_frame_renderer(p, c, fast_cfg, g, chunk=R * R, bg_color=1.0)
                 for p, c, g in ((params_bare, fcfg_bare, grid_bare), (params_eval, fcfg_eval, grid_eval))]
    # the style's luminance ramp (jnp.linspace's values)
    ramp = style_map(linspace(0.0, 1.0, 64, "cpu")[:, None].repeat(1, 3), s_idx).numpy()  # [64, 3]

    rows = []
    for vi, c2w in enumerate(poses):
        ro, rd = pose2rays(R, R, c2w, device)
        (rgb_b, a_b), (rgb_e, _) = [(out["rgb"], out["weight_sum"]) for out in (r(ro, rd) for r in renderers)]
        rgb_b = rgb_b.cpu().numpy().reshape(R, R, 3).clip(0, 1)
        rgb_e = rgb_e.cpu().numpy().reshape(R, R, 3).clip(0, 1)
        a_b = a_b.cpu().numpy().reshape(R, R).clip(0, 1)
        target = apply_style(torch.from_numpy(rgb_b), torch.from_numpy(a_b), s_idx).numpy()
        fg = a_b > 0.5
        dist = float(np.abs(rgb_e - target)[fg].mean()) if fg.any() else 0.0
        bare_dist = float(np.abs(rgb_b - target)[fg].mean()) if fg.any() else 0.0

        # SDS pulls toward the guidance's mode, not a per-pixel remap: also
        # the distance to the nearest colour of the style's ramp
        def ramp_dist(img):
            d = np.abs(img[fg][:, None, :] - ramp[None, :, :]).mean(axis=2)
            return float(d.min(axis=1).mean()) if fg.any() else 0.0

        rows.append({"view": vi, "style_dist": dist, "bare_dist": bare_dist,
                     "palette_dist": ramp_dist(rgb_e),
                     "bare_palette_dist": ramp_dist(rgb_b),
                     "fg_frac": float(fg.mean()),
                     "hue_eval": hue_stats(rgb_e, fg),
                     "hue_bare": hue_stats(rgb_b, fg)})
        if opt.save_pngs:
            os.makedirs(opt.save_pngs, exist_ok=True)
            for tag, img in (("eval", rgb_e), ("bare", rgb_b), ("target", target)):
                write_png(os.path.join(opt.save_pngs, f"v{vi:02d}_{tag}.png"), (img * 255).round().astype(np.uint8))

    mean_dist = float(np.mean([r["style_dist"] for r in rows]))
    mean_bare = float(np.mean([r["bare_dist"] for r in rows]))
    mean_pal = float(np.mean([r["palette_dist"] for r in rows]))
    mean_pal_bare = float(np.mean([r["bare_palette_dist"] for r in rows]))
    result = {
        "ckpt": opt.ckpt, "style": opt.style, "res": R,
        "mean_style_dist": mean_dist, "mean_bare_dist": mean_bare,
        "improvement_factor": (mean_bare / mean_dist) if mean_dist > 0 else None,
        "mean_palette_dist": mean_pal, "mean_bare_palette_dist": mean_pal_bare,
        "palette_improvement_factor": (mean_pal_bare / mean_pal) if mean_pal > 0 else None,
        "views": rows,
    }

    # tier 2: the foreground hue histograms and saturations, aggregated
    agg_e = np.mean([r["hue_eval"]["hue_hist"] for r in rows], axis=0)
    agg_b = np.mean([r["hue_bare"]["hue_hist"] for r in rows], axis=0)
    cv_e = np.mean([r["hue_eval"]["chroma_vec"] for r in rows], axis=0)
    cv_b = np.mean([r["hue_bare"]["chroma_vec"] for r in rows], axis=0)
    result["fg_sat_eval"] = float(np.mean([r["hue_eval"]["mean_sat"] for r in rows]))
    result["fg_sat_bare"] = float(np.mean([r["hue_bare"]["mean_sat"] for r in rows]))
    result["fg_mean_hue_eval"] = rows[0]["hue_eval"]["mean_hue"]
    result["fg_mean_hue_bare"] = rows[0]["hue_bare"]["mean_hue"]
    # None when either render is achromatic; chroma_shift covers that case
    result["hue_hist_shift_emd"] = circular_emd(agg_e, agg_b)
    result["chroma_shift"] = chroma_dist(cv_e, cv_b)

    # tier 3: the distance to the guidance's own generated hue distribution
    if opt.guidance:
        g_stats, _ = guidance_txt2img_hue(opt.guidance, opt.style, n=opt.txt2img_n, steps=opt.txt2img_steps,
                                          device=device)
        result["txt2img_mean_hue"] = g_stats["mean_hue"]
        result["txt2img_hue_emd_eval"] = circular_emd(agg_e, g_stats["hue_hist"])
        result["txt2img_hue_emd_bare"] = circular_emd(agg_b, g_stats["hue_hist"])
        e = result["txt2img_hue_emd_eval"]
        b = result["txt2img_hue_emd_bare"]
        result["txt2img_hue_improvement_factor"] = b / e if e and b else None
        # the chroma plane split into direction (the angle to the txt2img
        # centroid, scale-invariant) and magnitude (how chromatic each
        # render is); the samples are mostly background, so their centroid
        # is short and a Euclidean distance would penalise a saturated render
        cv_t = g_stats["chroma_vec"]
        result["txt2img_chroma_vec"] = [round(float(c), 5) for c in cv_t]
        result["txt2img_chroma_mag"] = float(np.hypot(cv_t[0], cv_t[1]))
        result["chroma_mag_eval"] = float(np.hypot(cv_e[0], cv_e[1]))
        result["chroma_mag_bare"] = float(np.hypot(cv_b[0], cv_b[1]))
        result["txt2img_chroma_angle_eval_deg"] = chroma_angle_deg(cv_e, cv_t)
        result["txt2img_chroma_angle_bare_deg"] = chroma_angle_deg(cv_b, cv_t)
    if opt.out:
        with open(opt.out, "w") as fp:
            json.dump(result, fp, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
