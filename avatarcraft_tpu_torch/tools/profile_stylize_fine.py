"""Fine-phase stylize throughput with the in-loop floater control: port of
the JAX package's tools/profile_stylize_fine.py, with its flags, defaults
and JSON.

SDS-grown floaters inflate the occupancy grid, and the clip guard then
(correctly) turns compaction off, so every ray pays the full K samples.
The trainer prunes floaters at each grid refresh
(``ops/occupancy.py::prune_grid_floaters``) and weighs the opacity term by
the reference's 1e5; this tool measures the fine phase as configured:
no coarse epoch, so every step renders the full 256x256 frame (phase A)
and then its patches (phase B). It reports steps/s over the steps after
the fifth, the grid's occupied share before and after (cells above
min(10, the grid's mean)), and whether compaction stayed on (the clip
guard prints when it trips).

The budget: with ``--budget_per_ray -1``, as the stylize CLI derives it:
the most probe-selected samples of any ``--batch``-ray chunk of the frame
over 20 noisy ``style_360_path`` poses drawn from ``default_rng(0)``,
against the loaded grid, times 1.1. K10: one gather when the trainer is
built, one gather and one reduce-scatter a step, one gather a refresh.

Where the port differs from the JAX tool, on purpose: ``--platform
default`` is the CUDA card (the JAX tool's is JAX's default device).

    python -m avatarcraft_tpu_torch.tools.profile_stylize_fine [--steps 40] [--batch 32768] [--no_prune] \\
        [--style lava] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
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
from avatarcraft_tpu_torch.models.diffusion import SDSGuidance
from avatarcraft_tpu_torch.models.instant_nsr import FastRenderConfig, count_fast_samples
from avatarcraft_tpu_torch.models.toy_guidance import load_toy_guidance, make_toy_modules
from avatarcraft_tpu_torch.utils.checkpoint import load_params_with_config, map_leaves
from avatarcraft_tpu_torch.utils.device import tool_device
from avatarcraft_tpu_torch.workloads.stylize import StylizeConfig, StylizeTrainer

BUDGET_POSES = 20
BUDGET_MARGIN = 1.1
STEADY_AFTER = 5  # steps/s over the steps after these


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights_path", default="artifacts/canonical/bare_smpl_tpu.pth.tar")
    ap.add_argument("--grid_path", default="artifacts/canonical/grid.npy")
    ap.add_argument("--toy_weights", default="artifacts/toy_guidance")
    ap.add_argument("--style", default="lava")
    ap.add_argument("--steps", default=40, type=int)
    ap.add_argument("--batch", default=32768, type=int)
    ap.add_argument("--grid_update_every", default=10, type=int,
                    help="refresh cadence, scaled down so a short profile crosses several refreshes "
                         "(production: 200)")
    ap.add_argument("--no_prune", action="store_true")
    ap.add_argument("--normal_mode", default="fd4", choices=["fd7", "fd4", "analytic"],
                    help="normal estimator for the fast sampler; analytic (exact autograd gradient) is the "
                         "cheapest and is a legitimate SDS-training lever (the style field retrains its color "
                         "net against it)")
    ap.add_argument("--budget_per_ray", default=-1, type=int,
                    help="-1 = auto-derive from the live grid over the first epoch's poses (the stylize CLI "
                         "default)")
    ap.add_argument("--platform", default="default", choices=["cpu", "default"],
                    help="default: the CUDA card; cpu: the CPU")
    return ap


def derive_budget(H: int, W: int, batch: int, grid: torch.Tensor) -> tuple[int, int]:
    """(budget, worst): the worst probe-selected count of any ``batch``-ray
    chunk of an H x W frame over BUDGET_POSES noisy orbit poses from
    ``default_rng(0)`` against ``grid``, and int(worst * BUDGET_MARGIN)."""
    rng = np.random.default_rng(0)
    poses, _ = style_360_path(
        np.zeros(3), np.array([0.0, 1.0, 0.0]), CANONICAL_CAMERA_DIST_TRAIN, BUDGET_POSES, add_noise=True,
        style_head=True, head_offset=CAN_HEAD_OFFSET, head_rate=0.5, head_dist=CAN_HEAD_CAMERA_DIST, rng=rng,
    )
    probe_cfg = FastRenderConfig(n_probes=192, k_samples=32, bound=NSR_BOUND)
    counts = []
    for pose in poses:
        ro, rd = pose2rays(H, W, pose, device=grid.device)
        counts += [count_fast_samples(ro[i:i + batch], rd[i:i + batch], probe_cfg, grid)
                   for i in range(0, H * W - batch + 1, batch)]
    worst = int(torch.stack(counts).max()) if counts else 0
    return int(worst * BUDGET_MARGIN), worst


def occ_frac(g: torch.Tensor) -> float:
    """The grid's share of cells above min(10, its mean)."""
    thresh = torch.clamp(g.mean(), max=10.0)
    return float((g > thresh).float().mean())


def main(argv=None) -> dict:
    """Run the profile; returns the JSON it prints."""
    opt = build_parser().parse_args(argv)
    device = tool_device(opt.platform)

    params_gt, fcfg = load_params_with_config(opt.weights_path, device)
    grid = torch.as_tensor(np.load(opt.grid_path), dtype=torch.float32, device=device)
    tparams, tcfg, embeddings = load_toy_guidance(opt.toy_weights, device)
    guidance = SDSGuidance(make_toy_modules(tparams, tcfg, embeddings))

    cfg = StylizeConfig(
        tgt_text=opt.style,
        coarse_epochs=0,  # straight to the fine phase: stride 1, the full 256^2
        fine_epochs=10_000,
        batch_size=opt.batch,
        sampler="fast",
        grid_update_every=opt.grid_update_every,
        prune_floaters=not opt.no_prune,
    )
    if opt.budget_per_ray < 0:
        budget, worst = derive_budget(cfg.H, cfg.W, opt.batch, grid)
        print(f"[fine] derived budget {budget}/patch (worst {worst})", file=sys.stderr, flush=True)
    else:
        budget = opt.batch * opt.budget_per_ray
    fast_cfg = FastRenderConfig(n_probes=192, k_samples=32, bound=NSR_BOUND, sample_budget=budget,
                                normal_mode=opt.normal_mode)
    trainer = StylizeTrainer(cfg, fcfg, guidance, params_style=map_leaves(params_gt, torch.clone),
                             params_gt=params_gt, grid=grid, fast_cfg=fast_cfg)

    occ0 = occ_frac(trainer.grid)
    times = []
    t_prev = None

    def on_step(step, trainer):
        nonlocal t_prev
        if device != "cpu":
            torch.cuda.synchronize()
        now = time.perf_counter()
        if t_prev is not None:
            times.append(now - t_prev)
        t_prev = now
        if (step + 1) % 10 == 0:
            tail = times[-9:]
            print(f"[fine] step {step + 1}: {len(tail) / sum(tail):.3f} steps/s "
                  f"(occ {occ_frac(trainer.grid) * 100:.2f}%, "
                  f"compaction={'on' if trainer.fast_cfg.sample_budget else 'OFF'})", file=sys.stderr, flush=True)

    trainer.train(max_steps=opt.steps, on_step=on_step)

    steady = times[STEADY_AFTER:]
    result = {
        "config": {"batch": opt.batch, "prune_floaters": not opt.no_prune, "budget": budget, "steps": opt.steps,
                   "grid_update_every": opt.grid_update_every, "normal_mode": opt.normal_mode},
        "steps_per_sec": round(len(steady) / sum(steady), 3) if steady else None,
        "first_step_s": round(times[0], 1) if times else None,
        "occ_frac_start": round(occ0, 5),
        "occ_frac_end": round(occ_frac(trainer.grid), 5),
        "compaction_still_on": bool(trainer.fast_cfg.sample_budget),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
