"""Train the toy conditional diffusion guidance on procedural targets: port
of the JAX package's tools/train_toy_guidance.py, with its flags, defaults,
files and JSON line.

The dataset: the committed canonical artifact rendered from the stylize
camera distribution (``cameras/paths.py::style_360_path`` with noise 2.0
and the head boxes, drawn from ``np.random.default_rng(--seed)``: the JAX
tool's poses bit for bit) at ``--res`` through ``render_rays_fast`` (192
probes, a budget of res^2 x 5, the artifact's normal mode), on black, in
groups of 8 views, each group's table gathered once by K10's
``all_gather_rows`` kernel (``workloads/canonical_render.py::
gathered_field``); un-premultiplied, re-mapped through each style's
luminance palette (``models/toy_guidance.py::style_map``) and composited on
white, black or a gray-noise background per sample (``compose_batch``).

The training: the toy UNet from ``models/sd.py::init_unet_params`` seeded
``--seed + 1`` (torch's stream: not the JAX package's init), AdamW with
weight decay 1e-4 on optax's warmup-cosine schedule
(``workloads/reconstruct.py::warmup_cosine_decay``: 0 -> lr over
``--warmup`` steps, then a cosine to lr x 0.05), and the DDPM loss with
classifier-free dropout 0.1 (``make_ddpm_loss``). The steps run round up to
a multiple of ``--scan``, as in the JAX tool; every draw of a step
(``draw_step``) comes from a ``torch.Generator`` seeded ``--seed + 2``.

The style embeddings are the JAX package's ``style_embeddings(cfg)``,
drawn from ``jax.random.PRNGKey(cfg.seed)``, which the port cannot draw:
they come from the committed ``artifacts/toy_guidance/params_torch.npz``,
which holds them for seed 1234 and the styles lava, emerald and porcelain,
and any other seed or style list is refused.

``--out`` gets the JAX tool's orbax ``params/`` and ``config.json`` and
the port's ``params_torch.npz`` of the style embeddings
(``save_toy_guidance``), which either package's ``load_toy_guidance`` and
``stylize_cli --toy_weights`` read, and ``TRAIN_META.json`` with the JAX
tool's keys. Runs on the CUDA card unless ``--platform cpu``.

    python -m avatarcraft_tpu_torch.tools.train_toy_guidance --steps 4000 --out toy_out [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from avatarcraft_tpu_torch.cameras import pose2rays, style_360_path
from avatarcraft_tpu_torch.constants import (
    CAN_HEAD_CAMERA_DIST,
    CAN_HEAD_OFFSET,
    CANONICAL_CAMERA_DIST_TRAIN,
    NSR_BOUND,
)
from avatarcraft_tpu_torch.models.diffusion import DiffusionSchedule
from avatarcraft_tpu_torch.models.instant_nsr import FastRenderConfig, render_rays_fast
from avatarcraft_tpu_torch.models.sd import init_unet_params
from avatarcraft_tpu_torch.models.toy_guidance import (
    STYLES,
    WEIGHTS_FILE,
    ToyGuidanceConfig,
    make_toy_train_step,
    save_toy_guidance,
    style_map,
)
from avatarcraft_tpu_torch.parallel.table_mp import shard_grid_rows
from avatarcraft_tpu_torch.utils.checkpoint import (
    artifact_normal_mode,
    leaves,
    load_params_with_config,
    map_leaves,
    set_lr,
)
from avatarcraft_tpu_torch.utils.device import tool_device
from avatarcraft_tpu_torch.workloads.canonical_render import gathered_field
from avatarcraft_tpu_torch.workloads.reconstruct import warmup_cosine_decay

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the JAX package's style embeddings of seed EMBEDDINGS_SEED and the styles
# STYLES, carried in the committed toy guidance's weights file
EMBEDDINGS_FILE = os.path.join(REPO_ROOT, "artifacts", "toy_guidance", WEIGHTS_FILE)
EMBEDDINGS_SEED = 1234
RENDER_GROUP = 8  # views per gather of the table, as the JAX tool's jitted group
UNCOND_DROPOUT = 0.1
WEIGHT_DECAY = 1e-4


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", default="artifacts/canonical")
    ap.add_argument("--out", default="artifacts/toy_guidance")
    ap.add_argument("--views", default=192, type=int)
    ap.add_argument("--res", default=64, type=int)
    ap.add_argument("--steps", default=4000, type=int)
    ap.add_argument("--batch", default=32, type=int)
    ap.add_argument("--scan", default=50, type=int, help="steps per call: the steps run round up to a multiple")
    ap.add_argument("--lr", default=3e-4, type=float)
    ap.add_argument("--warmup", default=200, type=int)
    ap.add_argument("--head_rate", default=0.35, type=float)
    ap.add_argument("--seed", default=0, type=int)
    ap.add_argument("--platform", default="default", choices=["cpu", "default"],
                    help="default: the CUDA card; cpu: the CPU")
    return ap


def dataset_poses(views: int, head_rate: float, seed: int) -> np.ndarray:
    """The stylize camera distribution the dataset is rendered from: the
    front/back-biased orbit with noise 2.0 and the head boxes, drawn from
    ``np.random.default_rng(seed)`` ([n, 4, 4] f32)."""
    poses, _ = style_360_path(
        np.zeros(3), np.array([0.0, 1.0, 0.0]), CANONICAL_CAMERA_DIST_TRAIN, views, add_noise=True,
        noise_scale=2.0, style_head=True, head_offset=CAN_HEAD_OFFSET, head_rate=head_rate,
        head_dist=CAN_HEAD_CAMERA_DIST, rng=np.random.default_rng(seed),
    )
    return poses


@torch.no_grad()
def render_dataset(params: dict, fcfg, fast_cfg, grid: torch.Tensor, poses: np.ndarray, res: int):
    """(rgb [V, res, res, 3] premultiplied on black, alpha [V, res, res]
    clipped to [0, 1]) of every pose, one ``render_rays_fast`` call a view;
    the table gathered once per group of RENDER_GROUP views."""
    device = grid.device
    rest, shards, splice = shard_grid_rows(params)
    rgbs, alphas = [], []
    for i in range(0, len(poses), RENDER_GROUP):
        full, field = gathered_field(rest, shards, splice, fcfg, fast_cfg.bound)
        for c2w in poses[i : i + RENDER_GROUP]:
            ro, rd = pose2rays(res, res, c2w, device=device)
            out = render_rays_fast(full, ro, rd, fcfg, fast_cfg, grid, 0.0, field)
            rgbs.append(out["rgb"].reshape(res, res, 3))
            alphas.append(out["weight_sum"].reshape(res, res))
        print(f"  rendered {min(i + RENDER_GROUP, len(poses))}/{len(poses)} views", file=sys.stderr)
    return torch.stack(rgbs), torch.stack(alphas).clamp(0.0, 1.0)


def styled_targets(rgb_pre: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """[n_styles, V, H, W, 3]: each style's premultiplied foreground, from
    the renders un-premultiplied (alpha floored at 1e-3, clipped to [0, 1])."""
    unpremult = (rgb_pre / torch.clamp(alpha[..., None], min=1e-3)).clamp(0.0, 1.0)
    return torch.stack([style_map(unpremult, s) * alpha[..., None] for s in range(len(STYLES))])


def draw_step(generator: torch.Generator, batch: int, n_views: int, n_styles: int, res: int, device) -> dict:
    """Every draw of one train step, from ``generator`` in this order: the
    views ``vi``, styles ``si`` and backgrounds ``bi`` (0 white, 1 black, 2
    gray noise) [B], the background noise ``noise_b`` [B, res, res, 1] (a
    standard normal), then the DDPM loss's timesteps ``t`` [B], ``noise``
    [B, 3, res, res] and classifier-free ``drop`` [B]."""
    g = dict(generator=generator, device=device)
    return {
        "vi": torch.randint(0, n_views, (batch,), **g),
        "si": torch.randint(0, n_styles, (batch,), **g),
        "bi": torch.randint(0, 3, (batch,), **g),
        "noise_b": torch.randn((batch, res, res, 1), **g),
        "t": torch.randint(0, DiffusionSchedule().num_train_timesteps, (batch,), **g),
        "noise": torch.randn((batch, 3, res, res), **g),
        "drop": torch.rand((batch,), **g) < UNCOND_DROPOUT,
    }


def compose_batch(styled_fg: torch.Tensor, alpha: torch.Tensor, vi, si, bi, noise_b) -> torch.Tensor:
    """The training images [B, H, W, 3]: style ``si``'s foreground of view
    ``vi`` over a white (``bi`` 0), black (1) or clip(0.5 + 0.1 noise_b, 0,
    1) gray-noise (2) background."""
    fg = styled_fg[si, vi]
    al = alpha[vi][..., None]
    gray = torch.clamp(0.5 + 0.1 * noise_b, 0.0, 1.0)
    bsel = bi[:, None, None, None]
    bkg = torch.where(bsel == 0, 1.0, torch.where(bsel == 1, 0.0, gray))
    return fg + bkg * (1.0 - al)


def style_embeddings(cfg: ToyGuidanceConfig, device) -> torch.Tensor:
    """The JAX package's style embeddings of ``cfg`` [n_styles + 1, L, D],
    read from EMBEDDINGS_FILE; refused for another seed, style list or
    shape, which the file does not hold."""
    with np.load(EMBEDDINGS_FILE) as z:
        embs = np.array(z["style_embeddings"], np.float32)
    want = (len(cfg.styles) + 1, cfg.seq_len, cfg.emb_dim)
    if cfg.seed != EMBEDDINGS_SEED or tuple(cfg.styles) != STYLES or embs.shape != want:
        raise SystemExit(
            f"train_toy_guidance: the style embeddings are the JAX package's draw from PRNGKey({cfg.seed}) "
            f"(threefry), which this port does not draw; it carries only those of seed {EMBEDDINGS_SEED} and the "
            f"styles {', '.join(STYLES)} [{', '.join(map(str, embs.shape))}] in {EMBEDDINGS_FILE} (asked: seed "
            f"{cfg.seed}, styles {', '.join(cfg.styles)}, shape {want})")
    return torch.from_numpy(embs).to(device)


def main(argv=None) -> dict:
    """Run the tool; returns the JSON result it prints (TRAIN_META.json)."""
    opt = build_parser().parse_args(argv)
    device = tool_device(opt.platform)

    # ---- render the canonical avatar from the stylize camera distribution --
    ckpt = os.path.join(opt.artifact, "bare_smpl_tpu.pth.tar")
    params_field, fcfg = load_params_with_config(ckpt, device)
    grid = torch.as_tensor(np.load(os.path.join(opt.artifact, "grid.npy")), dtype=torch.float32, device=device)
    normal_mode = artifact_normal_mode(ckpt) or "fd4"
    R = opt.res
    fast_cfg = FastRenderConfig(n_probes=192, k_samples=32, bound=NSR_BOUND, sample_budget=R * R * 5,
                                normal_mode=normal_mode)
    poses = dataset_poses(opt.views, opt.head_rate, opt.seed)
    t0 = time.time()
    rgb_pre, alpha = render_dataset(params_field, fcfg, fast_cfg, grid, poses, R)
    del params_field
    print(f"dataset render: {len(poses)} views in {time.time() - t0:.1f}s", file=sys.stderr)

    cfg = ToyGuidanceConfig(image_size=R)
    embeddings = style_embeddings(cfg, device)
    styled_fg = styled_targets(rgb_pre, alpha)
    V = len(poses)

    # ---- DDPM training -------------------------------------------------------
    lr_at = warmup_cosine_decay(0.0, opt.lr, opt.warmup, max(opt.steps, opt.warmup + 1), opt.lr * 0.05)
    params = map_leaves(init_unet_params(torch.Generator(device).manual_seed(opt.seed + 1), cfg.unet),
                        lambda t: t.requires_grad_())
    optimizer = torch.optim.AdamW(leaves(params), lr=lr_at(0), betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=WEIGHT_DECAY)
    step_fn = make_toy_train_step(cfg, embeddings, optimizer, DiffusionSchedule(), UNCOND_DROPOUT)
    generator = torch.Generator(device).manual_seed(opt.seed + 2)

    B = opt.batch
    n_calls = (opt.steps + opt.scan - 1) // opt.scan
    t0 = time.time()
    k = 0
    for c in range(n_calls):
        losses = []
        for _ in range(opt.scan):
            d = draw_step(generator, B, V, len(STYLES), R, device)
            imgs = compose_batch(styled_fg, alpha, d["vi"], d["si"], d["bi"], d["noise_b"])
            set_lr(optimizer, lr_at(k))
            losses.append(step_fn(params, imgs, d["si"], t=d["t"], noise=d["noise"], drop=d["drop"]))
            k += 1
        lo = torch.stack(losses).cpu().numpy()
        if c == 0 or (c + 1) % 5 == 0 or c == n_calls - 1:
            dt = time.time() - t0
            print(f"step {(c + 1) * opt.scan}/{opt.steps} loss {lo[-10:].mean():.4f} "
                  f"({(c + 1) * opt.scan / dt:.1f} steps/s)", file=sys.stderr)
    losses_final = float(lo[-10:].mean())

    save_toy_guidance(opt.out, params, cfg, embeddings)
    meta = {
        "steps": opt.steps, "batch": B, "views": V, "res": R,
        "styles": list(STYLES), "final_loss": losses_final,
        "artifact": opt.artifact, "normal_mode": normal_mode,
        "lr": opt.lr, "seed": opt.seed,
    }
    with open(os.path.join(opt.out, "TRAIN_META.json"), "w") as fp:
        json.dump(meta, fp, indent=1)
    print(json.dumps(meta))
    return meta


if __name__ == "__main__":
    main()
