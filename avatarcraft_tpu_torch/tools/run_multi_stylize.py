"""Multi-prompt avatar creation with the trained toy guidance: several
styled avatars in one run (``workloads/multi_stylize.MultiPromptTrainer``).
Port of the JAX package's tools/run_multi_stylize.py, with its flags,
defaults, file names, resume and final JSON line; ``--use_cuda false``
runs on the CPU (the JAX tool's ``--platform cpu``).

    python -m avatarcraft_tpu_torch.tools.run_multi_stylize --steps 600 \\
        [--prompts lava,emerald,porcelain] [--out style/toy/multi] [--use_cuda false]

Writes multi_<prompt>_<step:04d>.pth.tar every ``--i_save`` steps and
multi_<prompt>_final.pth.tar at the end (each with its field-config
sidecar), and each prompt's density grid to multi_<prompt>_grid.npy.

Two behaviours of the JAX tool are kept (and held by the CPU tests):
``coarse_epochs`` is ``--steps`` rounded up to whole epochs, so where an
epoch holds more views than ``--steps`` reaches, the first "fine" steps run
at the coarse stride; and a resume starts a fresh Adam (the checkpoints
hold no optimizer state).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from avatarcraft_tpu_torch.cli.options import str2bool
from avatarcraft_tpu_torch.constants import NSR_BOUND
from avatarcraft_tpu_torch.models.diffusion import SDSGuidance
from avatarcraft_tpu_torch.models.instant_nsr import FastRenderConfig
from avatarcraft_tpu_torch.models.toy_guidance import load_toy_guidance, make_toy_modules
from avatarcraft_tpu_torch.utils.checkpoint import load_params_with_config, save_params_with_config
from avatarcraft_tpu_torch.workloads.multi_stylize import MultiPromptTrainer, stack_params
from avatarcraft_tpu_torch.workloads.stylize import StylizeConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights_path", default="artifacts/canonical/bare_smpl_tpu.pth.tar")
    ap.add_argument("--toy_weights", default="artifacts/toy_guidance")
    ap.add_argument("--prompts", default="lava,emerald,porcelain")
    ap.add_argument("--steps", default=600, type=int, help="coarse-stage SDS steps (stride subsample_scale)")
    ap.add_argument("--fine_steps", default=0, type=int,
                    help="fine-stage SDS steps (stride 1, full-res frames: the reference schedule's second stage)")
    ap.add_argument("--batch_size", default=4096, type=int)
    ap.add_argument("--out", default="style/toy/multi")
    ap.add_argument("--i_save", default=0, type=int, help="0 = final only")
    ap.add_argument("--hw", default=256, type=int, help="train render size")
    ap.add_argument("--n_cap", default=100, type=int)
    ap.add_argument("--use_cuda", default=True, type=str2bool, help="run on the CUDA card; false = CPU")
    ap.add_argument("--resume_step", default=0, type=int,
                    help="resume from the i_save checkpoints at this step (multi_<prompt>_<step:04d>.pth.tar + "
                         "grids in --out); the remaining schedule and save numbering continue from there")
    ap.add_argument("--sample_budget", default=-1, type=int,
                    help="-1 = derive the compaction budget from the schedule's pose distribution against the "
                         "live grids (zero-clip, guarded at every grid refresh); 0 = off (every ray pays k_samples)")
    ap.add_argument("--normal_mode", default="fd4", choices=["fd7", "fd4", "analytic"],
                    help="fast-sampler normal estimator")
    ap.add_argument("--log_every", default=25, type=int,
                    help="per-step log cadence (the first 5 steps are always logged)")
    return ap


def main(argv=None) -> MultiPromptTrainer:
    """Run the tool; returns the trainer after its last step."""
    opt = build_parser().parse_args(argv)
    if opt.use_cuda and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --use_cuda false to run on the CPU")
    device = "cuda" if opt.use_cuda else "cpu"

    prompts = [p.strip() for p in opt.prompts.split(",") if p.strip()]
    params_gt, fcfg = load_params_with_config(opt.weights_path, device)
    tparams, tcfg, embs = load_toy_guidance(opt.toy_weights, device)
    guidance = SDSGuidance(make_toy_modules(tparams, tcfg, embs))
    print(f"[multi] {len(prompts)} prompts {prompts}; field encoder={fcfg.encoder} device={device}",
          file=sys.stderr)

    done0 = opt.resume_step
    rem_coarse = max(0, opt.steps - done0)
    rem_fine = opt.fine_steps - max(0, done0 - opt.steps)
    cfg = StylizeConfig(
        H=opt.hw,
        W=opt.hw,
        batch_size=opt.batch_size,
        n_cap=opt.n_cap,
        sampler="fast",
        # epoch granularity: the coarse->fine stride switch happens at an
        # epoch boundary, so point --steps at a multiple of an epoch's views
        coarse_epochs=-(-rem_coarse // opt.n_cap),
        fine_epochs=-(-rem_fine // opt.n_cap),
    )
    grids = None
    if done0:
        srcs = [os.path.join(opt.out, f"multi_{p}_{done0:04d}.pth.tar") for p in prompts]
        stacked = stack_params([load_params_with_config(s, device)[0] for s in srcs])
        # the saved (pruned) per-prompt grids: a fresh refresh would lack the
        # temporal-coherence pruning seed
        grids = torch.stack([torch.as_tensor(np.load(os.path.join(opt.out, f"multi_{p}_grid.npy")), device=device)
                             for p in prompts])
        print(f"[multi] resuming from step {done0} checkpoints in {opt.out}", file=sys.stderr, flush=True)
    else:
        stacked = stack_params([params_gt] * len(prompts))
    print("[multi] building trainer (grid refreshes + text embeds)...", file=sys.stderr, flush=True)
    t_init = time.perf_counter()
    trainer = MultiPromptTrainer(
        cfg, fcfg, guidance, prompts, stacked, params_gt, grids=grids,
        fast_cfg=FastRenderConfig(n_probes=192, k_samples=32, bound=NSR_BOUND, normal_mode=opt.normal_mode),
    )
    del stacked
    print(f"[multi] trainer ready in {time.perf_counter() - t_init:.0f}s", file=sys.stderr, flush=True)

    if opt.sample_budget < 0:
        b = trainer.derive_budget()
        print(f"[multi] auto-derived compaction budget {b}/chunk ({b / opt.batch_size:.1f} samples/ray; "
              f"clip-guarded at every grid refresh)", file=sys.stderr, flush=True)
    elif opt.sample_budget > 0:
        trainer.set_budget(opt.sample_budget)

    os.makedirs(opt.out, exist_ok=True)
    total = rem_coarse + rem_fine
    grand_total = opt.steps + opt.fine_steps

    def _save(done, tag=None):
        for prompt, p, grid in zip(prompts, trainer.params_list(), trainer.grids):
            name = tag or f"{done:04d}"
            path = os.path.join(opt.out, f"multi_{prompt}_{name}.pth.tar")
            save_params_with_config(p, path, fcfg)
            np.save(os.path.join(opt.out, f"multi_{prompt}_grid.npy"), grid.cpu().numpy())
            print(f"[multi] saved {path}", file=sys.stderr, flush=True)

    # logging and periodic saves through on_step (one train() call keeps the
    # coarse->fine epoch schedule intact)
    clock = {"t": time.perf_counter(), "t0": time.perf_counter()}

    def _on_step(step, trainer):
        g = done0 + step
        if step <= 5 or (opt.log_every and g % opt.log_every == 0):
            if trainer.device.type == "cuda":
                torch.cuda.synchronize(trainer.device)  # the rate of finished steps
            now = time.perf_counter()
            rate = step / (now - clock["t0"])
            phase = "coarse" if g <= opt.steps else "fine"
            print(f"[multi] step {g}/{grand_total} [{phase}] (+{now - clock['t']:.1f}s, "
                  f"avg {rate:.3f} steps/s x {len(prompts)} prompts)", file=sys.stderr, flush=True)
            clock["t"] = now
        if opt.i_save and g % opt.i_save == 0 and g < grand_total:
            _save(g)

    done = trainer.train(max_steps=total, on_step=_on_step)
    _save(done0 + done, tag="final")
    print(json.dumps({
        "prompts": prompts, "steps": done0 + done, "coarse": opt.steps,
        "fine": opt.fine_steps, "resumed_from": done0, "out": opt.out,
    }))
    return trainer


if __name__ == "__main__":
    main()
