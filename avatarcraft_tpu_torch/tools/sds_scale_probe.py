"""SDS memory and step time at the reference's real sizes: port of the JAX
package's tools/sds_scale_probe.py, with its JSON.

Builds Stable Diffusion 1.5 at its full width from seeded random weights
(no checkpoint: the shapes and the work are those of converted weights)
and a fresh field (the pyramid encoder, bf16 MLPs), then times
``trainer.train(max_steps=1)`` at the reference's fine-stage load
(reference: stylize.py:98-199), one step at a time:

* phase A: the full 256x256 frame through the fast sampler, against a
  129^3 grid full of 100 and a budget of 12 samples a ray;
* the SDS image gradient: the frame resized to 512x512, the VAE encoder
  (with its gradient), the UNet's CFG pair, the clamped latent gradient
  pulled back through the encoder;
* phase B: 16 patches of 4096 rays with the gradient injected, plus the
  opacity and eikonal terms.

K10: one gather when the trainer is built (its frozen copy), then one
gather and one reduce-scatter a step.

The memory numbers keep the JAX tool's key names, each read from the
torch counter of the same meaning on the card, in GiB:

* ``bytes_in_use``      <- ``torch.cuda.memory_allocated``
* ``peak_bytes_in_use`` <- ``torch.cuda.max_memory_allocated``
* ``bytes_reserved``    <- ``torch.cuda.memory_reserved``
* ``bytes_limit``       <- the total of ``torch.cuda.mem_get_info``

On the CPU the dict is empty, as JAX's CPU device gives none.
``step0_s_with_compile`` keeps its name: on the card it holds the first
step's kernel builds and allocator growth. The text ids come from the
salted ``hash()`` as in the JAX tool, so they differ from run to run.

Where the port differs from the JAX tool, on purpose: ``--platform``
(default ``default``, the CUDA card; the JAX tool has no flag). The
weights are drawn from a ``torch.Generator`` seeded 0, where the JAX tool
splits ``PRNGKey(0)``.

    python -m avatarcraft_tpu_torch.tools.sds_scale_probe [steps] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from avatarcraft_tpu_torch.constants import NSR_BOUND
from avatarcraft_tpu_torch.models import sd
from avatarcraft_tpu_torch.models.diffusion import GuidanceModules, SDSGuidance
from avatarcraft_tpu_torch.models.instant_nsr import FastRenderConfig, FieldConfig, init_field_params
from avatarcraft_tpu_torch.utils.checkpoint import leaves, map_leaves
from avatarcraft_tpu_torch.utils.device import tool_device
from avatarcraft_tpu_torch.workloads.stylize import StylizeConfig, StylizeTrainer

SEED = 0
SD_IMAGE_SIZE = 512  # the frame is resized to this before the VAE
SD_LATENT_SCALE = 8


def mem_stats(device) -> dict:
    """The device's memory counters in GiB under JAX's key names; {} on the
    CPU."""
    if torch.device(device).type != "cuda":
        return {}
    _, total = torch.cuda.mem_get_info(device)
    stats = {
        "bytes_in_use": torch.cuda.memory_allocated(device),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_reserved": torch.cuda.memory_reserved(device),
        "bytes_limit": total,
    }
    return {k: round(v / 2**30, 3) for k, v in stats.items()}


def count_params(tree) -> int:
    return sum(t.numel() for t in leaves(tree))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", nargs="?", default=2, type=int, help="SDS steps, each timed on its own")
    ap.add_argument("--platform", default="default", choices=["cpu", "default"],
                    help="default: the CUDA card; cpu: the CPU")
    return ap


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, H: int = 256, W: int = 256) -> dict:
    """Run the probe on an H x W frame; returns the JSON it prints."""
    opt = build_parser().parse_args(argv)
    device = tool_device(opt.platform)
    report = {"H": H, "W": W}

    t0 = time.perf_counter()
    ucfg, vcfg, tcfg = sd.stable_diffusion_configs("1.5")
    gen = torch.Generator(device).manual_seed(SEED)
    unet_params = sd.init_unet_params(gen, ucfg)
    vae_params = sd.init_vae_encoder_params(gen, vcfg)
    clip_params = sd.init_clip_text_params(gen, tcfg)
    _sync(device)
    report["unet_params_M"] = round(float(count_params(unet_params)) / 1e6, 1)
    report["init_s"] = round(time.perf_counter() - t0, 1)
    print(f"[probe] SD init: {report['unet_params_M']}M UNet params, {report['init_s']}s", file=sys.stderr)

    def text_encode(prompts):
        # random but valid token ids (the tokenizer's assets are the user's)
        ids = torch.tensor([[abs(hash(p + str(i))) % (tcfg.vocab_size - 2) for i in range(tcfg.max_len)]
                            for p in prompts], dtype=torch.int64, device=device)
        return sd.clip_text_apply(clip_params, tcfg, ids)

    guidance = SDSGuidance(GuidanceModules(
        unet=lambda l, t, c: sd.unet_apply(unet_params, ucfg, l, t, c),
        vae_encode=lambda im: sd.vae_encode_apply(vae_params, vcfg, im),
        text_encode=text_encode,
        latent_scale=SD_LATENT_SCALE,
        image_size=SD_IMAGE_SIZE,
    ))

    fcfg = FieldConfig(encoder="tpu_pyramid", mlp_dtype="bfloat16")
    params = init_field_params(gen, fcfg)
    params_gt = map_leaves(params, torch.clone)
    cfg = StylizeConfig(tgt_text="probe", coarse_epochs=0, fine_epochs=1, n_cap=8, H=H, W=W, subsample_scale=4,
                        batch_size=4096, sampler="fast", grid_update_every=0)
    fast_cfg = FastRenderConfig(n_probes=192, k_samples=32, bound=NSR_BOUND, sample_budget=H * W * 12)
    trainer = StylizeTrainer(cfg, fcfg, guidance, params, params_gt,
                             grid=torch.full((129,) * 3, 100.0, device=device), fast_cfg=fast_cfg)
    report["mem_after_init_GiB"] = mem_stats(device)

    times = []
    for s in range(opt.steps):
        _sync(device)
        t0 = time.perf_counter()
        trainer.train(max_steps=1)
        _sync(device)
        times.append(time.perf_counter() - t0)
        print(f"[probe] SDS step {s}: {times[-1]:.1f}s (incl. kernel builds on step 0)", file=sys.stderr)
    report["step0_s_with_compile"] = round(times[0], 1)
    if len(times) > 1:
        report["steady_step_s"] = round(min(times[1:]), 2)
        report["sds_iters_per_sec"] = round(1.0 / min(times[1:]), 3)
    report["mem_after_steps_GiB"] = mem_stats(device)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
