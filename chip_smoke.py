#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (avatarcraft_tpu_torch).

    python3 chip_smoke.py            # on a machine with one CUDA card

Phases, each printed with its start, end and wall seconds:

1. device  -- fails unless torch sees a CUDA card; prints its name, the
              card count and nvidia-smi's name and power limit;
2. build   -- nvcc builds every kernel of csrc/ and g++ the native mesh
              extractor (csrc/mesh_extract.cpp), all started together,
              into avatarcraft_tpu_torch/_build;
3. kernel  -- all_gather_rows against its plain version (torch.cat) for
              1/2/4/8 shards of the 128^3 x 4 grid table in f32 and fp16,
              the 128-shard cap, 5 shards (spans across shard boundaries)
              and ragged and misaligned cases (through the wrapper, and
              launched over an output of all-ones bytes), and reduce_scatter_rows
              against its plain version for m = 1/2/4 replicas x n =
              1/2/4/8 shards of that table in f32, ragged cases (shards of
              1, 2 and 3 floats mod 4 at n = 2, 3, 5), cotangents 4, 8 and
              12 bytes past a 16-byte boundary, m + n = 128, m = 1/2/3/8
              at the hash table and a captured CUDA graph replayed on
              inputs changed in place: bitwise equal; neither wrapper
              puts a host-to-device copy on the card (torch.profiler;
              both pass their pointers by value); times each kernel, its
              wrapper, plain version and library call with CUDA events
              (``kernel_ms``: the kernel alone, printed again as ``ms`` in
              the kernels line; ``wrapper_ms``: with the wrapper's
              allocation and pointer handling), in a warm loop and again
              with the L2 cache flushed before every call
              (``kernel_cold_ms``, ``library_cold_ms``; the
              reduce-scatter's ``wrapper_cold_ms`` too, also at the hash
              table's shape and for a cotangent 4 bytes past a 16-byte
              boundary, its one-call yardstick Tensor.clone at m = 1
              and torch.stack(...).sum(0) as ``stack_sum_*`` at m = 4, each
              kernel time beside its ``share_of_bound*``), as the main paths
              find the table, and the profiler's device time of what each
              call launches in that cold loop (``kernel_cold_device_ms``,
              ``library_cold_device_ms``);
4. main    -- the port's bench (avatarcraft_tpu_torch.bench.run): the baked
              artifact rendered at 256x256 from the 16 bench cameras with a
              derived, zero-clip sample budget; every frame finite; the
              gather kernel launched; then one frame with the table split 4
              ways, bitwise equal to the 1-shard frame;
5. train   -- the fast trainer (workloads.reconstruct.train_fast) for 40
              steps from init_field_params at the artifact's full width on 8
              bench views at 128x128 rendered from the artifact: warmup, the
              refresh from zeros at step 20 and one EMA refresh at step 40;
              every loss finite, the loss of steps 15-19 below that of steps
              0-4 (the warmup), the refreshed 129^3 grid finite and below
              the saturated 100; both table kernels launched;
6. tablemp -- the encoder's deterministic scatter-add (scatter_rows) on
              the card against the CPU and against itself, bitwise; the
              table-parallel step (parallel.table_mp) from the artifact's
              parameters, 64+64 samples with fd7 normals, 1024 rays of bench
              camera 0 against the fast renderer's frame, SGD: 1 shard three
              times and 4 shards once; the losses and the table gradients
              bitwise equal; both table kernels launched;
7. warp    -- the port's warp bench (avatarcraft_tpu_torch.bench.run_warp):
              the artifact animated on the demo body by 4 demo poses at
              256x256, 8192-ray chunks, 128 probes, K = 32, the derived
              budget; every frame finite, zero-clip, the gather kernel
              launched once per frame, TF32 off before and after; then the
              lava style delta applied through utils.style_delta and demo
              frame 10 rendered at 32x32 on the card and on the CPU: within
              2e-3, red-dominant, and its difference from
              tests/golden_styled_warp_32.npy printed;
8. cpu     -- one 32x32 frame on the card and on the CPU (plain path),
              equal within 2e-3; the grid refresh (make_grid_update_fn) of
              the artifact's field with f32 tables, from zeros and as an EMA
              of the artifact's grid, on the card and on the CPU: within
              512^2/4 x 1e-6, each with an occupied share in [1e-3, 0.5];
              one fast train step from the artifact on 32x32 rays on the
              card and on the CPU: losses within 1e-4 relative, every MLP
              and variance gradient within 1e-2 x its max|g|;
9. stylize -- the stylize CLI (cli.stylize_cli.main) on the committed
              artifact with the toy guidance, --sampler fast --guidance_type
              toy --tgt_text lava at its defaults (256x256, 4096-ray
              patches, the derived budget) for 6 coarse SDS steps, the last
              with a validation render and a 512^3 mesh export (--i_mesh 6:
              the SDF lattice on the card, the native extractor on the
              host, both timed; the .ply's counts checked against its
              size); the final checkpoint written, loaded
              through load_params_with_config equal to the trainer's
              parameters and rendered through the canonical fast renderer;
              the style moved, everything finite; then a trainer with no
              coarse epoch for 4 fine steps (256x256, 16 patches, the
              antialiased 256 -> 64 resize), the grid refreshed, pruned and
              clip-guarded once at step 4. The table kernels: one gather and
              one reduce-scatter per SDS step, plus one gather each for the
              ground truth at setup, the validation render, the mesh
              export, the final save and the refresh. Prints SDS steps/s at
              coarse and fine, device ms per stylize.* range and peak memory;
10. stylize_card_vs_cpu -- the toy UNet's eps on one input, card against
              CPU, within 1e-5; one SDS step of the artifact's coarse frame
              (64x64, one patch) with f32 tables from the same state on
              both, t and the noise injected: phase A within 2e-3, the SDS gradient of one
              image within 4.02e-3 (2 x 201 x the eps bound), phase B and
              Adam on that one gradient: the loss within 1e-4 relative, the
              MLP and variance gradients within 1e-2 x max|g|, the updated
              MLP parameters within 1e-6 where |g| > 1e-2 max|g| and 2 lr
              elsewhere (Adam's first step is lr x sign(g)); the same step
              with the artifact's bf16 tables is printed, not held;
11. analytic_card_vs_cpu -- a 32x32 frame with analytic normals, card
              against CPU, within 2e-3;
12. multi_stylize -- the multi-prompt tool (tools.run_multi_stylize) at its
              defaults on the committed artifact with the toy guidance:
              lava, emerald and porcelain, 256x256, 4096-ray patches, 192
              probes, K = 32, fd4, the derived budget, cut to --n_cap 4
              --steps 4 --fine_steps 2 (4 coarse and 2 fine SDS steps);
              every loss finite, the three fields pairwise different, each
              final checkpoint loading as its field; the table kernels: P
              gathers and P reduce-scatters per step, plus one gather for
              the ground truth, P for the setup's grid refreshes and P for
              the final save, counted exactly. Then 4 coarse and 2 fine
              steps timed and one of each profiled on the tool's trainer:
              SDS steps/s (x P prompts), device ms per multi.* range, idle
              share, peak memory;
13. multi_card_vs_cpu -- one multi-prompt step at P = 2 (the artifact's
              coarse 64x64 frame, one patch, f32 tables), t and the noise
              injected, stage by stage on the card and the CPU at
              stylize_card_vs_cpu's bounds;
14. sd_stylize -- Stable Diffusion 1.5 at its full width (UNet 320/640/
              1280/1280, 8 heads, context 768; VAE 128/256/512/512; CLIP-L
              49,408 x 768, 12 layers) from seeded random weights on the
              card behind the toy tokenizer, 512x512 into the VAE, driving
              the stylize CLI's trainer on the committed artifact
              (profile_train.stylize_trainer): SD_COARSE_STEPS coarse steps
              (64x64 frame) and SD_FINE_STEPS fine ones (256x256, 16
              patches), in each stage the first a warm-up, the last
              profiled, the others timed; every loss, SDS image gradient
              and parameter gradient finite, the SDS gradient nonzero; one
              gather and one reduce-scatter per step, counted exactly.
              Prints SDS steps/s, device ms per stylize.* range (gather,
              phaseA, vae, sds, phaseB), the idle share and peak memory
              per stage; then the guidance batched over P = 2 images
              (sds_image_grad_batch: one UNet call of 4 latents) against
              two single calls with the same t and noise, within 201 x
              1e-5 x max|g|, both timed;
15. txt2img -- prompt_to_img at 512x512 with those SD 1.5 modules, 4 PNDM
              steps and 4 DDIM steps: uint8 [1, 512, 512, 3]; prints ms
              per UNet call and per decode;
16. sd_depth -- one coarse SDS step with SD 2.0-depth at its full width
              (in_channels 5, context 1024, heads 5/10/20/20, CLIP 1024
              wide, 23 layers) and the frame's depth: the depth reaches the
              guidance, the gradient is finite and nonzero; one gather and
              one reduce-scatter;
17. toy_ddpm -- 20 Adam steps of the toy guidance's DDPM trainer at the
              committed width, batch 32 of 64x64 palette targets: every
              loss finite; prints steps/s;
18. sd_card_vs_cpu -- Stable Diffusion at a reduced width (UNet 64/128/
              256/256, VAE 32/64/128/128, CLIP 2 layers; 256x256 into the
              VAE), one set of random weights on the card and the CPU, t,
              the noise and the latents injected: CLIP's embeddings and the
              UNet's eps within 1e-5 x max|ref|, the SDS image gradient at
              1.5 and at 2.0-depth within 201 x that, 2 PNDM steps within
              (2 x 7.5 + 1) x that; one toy DDPM step's loss within 1e-5
              relative, its gradients within 1e-3 x each leaf's max|g| plus
              1e-5 x the largest. Every error is printed before any is
              held.
19. reconstruct -- a dataset in smpl_da_512's layout written to a temporary
              directory: 100 views at 512x512 at the training distance,
              rendered from the artifact on a black background; the
              reconstruct CLI (cli.reconstruct_cli.main) at its defaults with
              --white_bkg false (the set's black background): --sampler parity
              (the hash grid, 64+64, fd7, batch 1600) for 40 steps, the
              validation PNG, checkpoint and 128^3 mesh at step 40, no table
              kernel launched, the loss falling, the checkpoint loading back
              equal; --sampler fast (the pyramid, fd4, 128 probes) for 40 steps
              with the grid warmup, refreshes and state saves every 20: one
              gather and one reduce-scatter per step, plus a gather per
              refresh, state save, parameter read of the CLI and the final
              tree, counted exactly; a resume from its state for 4 more
              steps; a hash-grid 64+64 step card against CPU on 32x32 rays
              (the loss 1e-4 relative, every gradient leaf, the table's
              included, 1e-2 x its max|g|); the parity step's device ms per
              train.* range (profile_train.parity_main); steps/s, rays/s and
              peak memory; the mesh export at the CLI's default 512^3 timed
              once on the artifact's field (SDF lattice, native marching
              cubes), and at 128^3 the native extractor held against the
              numpy plain version (the same triangle count, the sorted
              vertices within 1e-4), both timed. Its dataset and the parity
              run's hash-grid checkpoint stay for the parity phases, the
              fast run's state, final checkpoint and grid for tools;
19b. reconstruct_scan -- the fast reconstruct CLI on that set with
              --scan_steps 5 --max_steps 43 (8 calls and a tail of 3) and
              with --scan_steps 0, refreshes and state saves every 20 (5
              divides 20: the same steps in both): one gather and one
              reduce-scatter a step, the graph's replays counted, plus a
              gather a refresh, state save and the final tree, exactly;
              the per-call losses within 1e-4 of the per-step run's; the
              first refresh after step 20 in both; steps/s of both. Then
              make_train_scan_fast graphed against graph=False (the same
              capturable step taken eagerly) from two equal fresh
              trainers over calls of 5, 5 and 3 steps: losses,
              parameters and Adam's moments bitwise equal, the launches
              counted exactly, ms per step of each; the graphed first
              step runs under sync debug mode "error";
19c. tools -- the offline tools' twins (avatarcraft_tpu_torch/tools/) on
              the card, on the reconstruct set: eval_psnr (views 13, 62,
              95 at 128x128, raw images on black) of the committed
              artifact, which rendered the set, every view above 35 dB,
              with --band_stats; of the fast run's train state at step 40,
              finite and its mean above an all-black image's; of its
              final checkpoint and grid, the same numbers; bake_artifact
              of that state (fp16 tables) and eval_psnr of the bake, every
              view within 0.1 dB of the state; prune_grid of the artifact
              on the card and the CPU, the occupied and kept counts within
              0.1 %; style_delta unpack of the lava delta and pack of the
              result against the artifact: sparse rows and values bitwise
              the committed delta's but the rows whose fp16 values are all
              zero, dense leaves within one f32 ulp, the grid bitwise;
              eval_style of the unpacked lava field with its grid and the
              toy guidance at 128x128 over 4 views, mean_style_dist below
              mean_bare_dist, printed beside docs/eval/multi_lava.json.
              One gather per rendered view, counted exactly; each tool's
              wall seconds. The fast run's files stay for finetune;
19d. finetune -- the fine-tune and asset tools' twins on the card, on the
              reconstruct set: finetune_color --ckpt of the artifact with
              analytic normals for FINETUNE_COLOR_STEPS steps (every leaf
              but the color MLP's bitwise the artifact's), bake_artifact of
              it and eval_psnr of the bake under analytic normals beside
              the artifact's own under analytic (printed, not held);
              finetune_ss --state of the fast run at ss 2 for two
              graphed calls of FINETUNE_SS_SCAN steps, one refresh and one
              <out>_latest save (their steps and Adam counts checked);
              train_toy_guidance at 64x64 over 16 orbit and 4 head views
              for 10 steps, its output loaded and given one eps call;
              make_demo_body with both rigs at 128^3, each loaded by
              load_smpl and rendered as one 32x32 warp frame of the
              artifact. K10: one gather a color step, a view, a toy group
              of 8 views, a warp frame, a refresh and a saved tree, one
              gather and one reduce-scatter a supersampled step (the
              graph's replays counted), counted exactly; each tool's wall
              seconds. The fast run's files are removed after it;
19e. probes -- the last root tools' twins on the card: preflight_sd on an
              SD 1.5 diffusers snapshot this phase writes (f16
              .safetensors by the port's writer, seeded random weights
              under the published key layout, no tokenizer), GO and exit
              0 with every smoke flag true; synth_gt_band_check of the
              artifact on view 13 of the reconstruct set at 512, ss 4 and
              2 (4,194,304 and 1,048,576 rays after one gather), every
              number finite; sds_scale_probe for 2 steps (SD 1.5 from
              random weights, a fresh field, 256x256), finite, with the
              memory counters; profile_stylize_fine at batch 32,768 on
              the artifact with the toy guidance, lava, PROBES_FINE_STEPS
              steps with a refresh every PROBES_FINE_REFRESH (cut from 40
              and 10), its derived budget and steps/s; the
              postprocess_multi.sh twin for lava at RES 64 and TRAJ 2 on a
              run directory unpacked from the committed lava delta, in a
              scratch tree (every output file present), its processes'
              K10 launches read through a sitecustomize hook. K10 counted
              exactly per tool; each tool's wall seconds;
20. parity_render -- the canonical CLI (cli.render_canonical_cli.main) at
              its defaults, --sampler parity (64+64, no jitter, the
              artifact's fd4, 4096-ray chunks), with --log_extra true,
              PARITY_ORBIT frames of each orbit at 256x256: every PNG
              shows the body, every depth PNG is written (a body
              frame's not all black),
              each orbit's GIF parses (GIF89a, loop 0, as many frames as
              PNGs, 6 hundredths each) and its camera pickles exist; one
              gather per frame, counted exactly; ms per frame. Then a 32x32 frame with
              f32 tables on the card and the CPU: all but 5% of the values
              within 1e-4, every value within 1e-2;
21. parity_warp -- the warp CLI (cli.render_warp_cli.main) at its defaults,
              --sampler parity (geometry-guided bounds, 32+32 samples all
              warped, fd7), the artifact on the demo body in 2 demo poses
              at 128x128 from view 58 of the reconstruct dataset: every PNG
              a body on white, one gather per frame; ms per frame and peak
              memory. Then demo frame 10 at 16x16 from the warp bench's
              camera on the card and the CPU: all but 5% of the values
              within 2e-3, every value within 1e-2;
22. parity_stylize -- the stylize CLI at its defaults (--sampler parity:
              64+64 with jitter, fd7; the toy guidance, lava) on the
              artifact for 3 coarse SDS steps, the last with the validation
              PNG and a 512^3 mesh, then a fine trainer (256x256, 16
              patches) for 2 steps, the first step of each stage a warm-up
              and one more of each profiled; every loss and gradient
              finite; one gather and one reduce-scatter per step, plus a
              gather each for the ground truth, the validation render, the
              mesh and the final save, counted exactly; the PNG, the .ply
              and the final checkpoint, which loads as the trainer's
              parameters. Prints SDS steps/s, device ms per stylize.* range
              and peak memory per stage. Then the reference chain: the
              reconstruct phase's hash-grid checkpoint through one parity
              step of the stylize CLI and one parity frame of the warp CLI
              (4 gathers and 1 reduce-scatter);
23. parity_multi -- MultiPromptTrainer with the parity sampler on the
              artifact at P = 2 (lava, emerald), 2 coarse steps: P gathers
              and P reduce-scatters a step, plus the ground truth's gather;
24. parity_card_vs_cpu -- a reduced-width pyramid field (grids 16/32,
              planes 64/128, f32 tables) on a 128x128 view (a 32x32 coarse
              frame, one 1024-ray patch, with jitter drawn once on the CPU
              for both): one parity SDS step and one multi-prompt step at
              P = 2, t and the noise injected, stage by stage at
              stylize_card_vs_cpu's bounds, the variance's gradient at
              1e-1 x max|g| (it moves by 3.5e-2 when the parameters move
              by one ulp);
25. multirank -- several ranks (processes, gloo) on the one card, time-
              slicing it: K10's cross-rank kernels (csrc/ring_peer.cu,
              peer_all_gather and peer_reduce_scatter) and the port's
              all-reduce (peer_all_reduce, the same file) at 2 and 4
              ranks, at the 128^3 x 4 grid table and the hash table
              (padded to a multiple of the ranks; the all-reduce on the
              unpadded hash table's floats, so its blocks are padded),
              over MULTIRANK_CALLS back-to-back calls whose inputs change
              every call, bitwise against their plain versions; then
              MULTIRANK_GRAPH_CALLS calls of each captured into one CUDA
              graph and replayed MULTIRANK_REPLAYS times with new inputs,
              bitwise after every replay; their times warm and with the L2
              flushed, beside the plain versions and gloo's
              all_gather_into_tensor and all_reduce on the same tensors
              (contexts taking turns). In 2 ranks the dryrun twin's paths
              (parallel/dryrun.py; path 4 holds the graphed sharded scan
              bitwise against the same steps taken eagerly), train_fast at
              batch 1600 (800 a rank) for 3 steps against one process,
              train_fast with --scan_steps 5 for 10 steps graphed, bitwise
              against the same scan taken eagerly and its losses within
              dryrun.GRAD_REL of one process's graphed run, steps/s beside
              3 eager steps with the sums through gloo (a measurement
              only: the port never takes gloo there), and in 2 and 4 ranks
              the table-parallel step on the artifact with the grid rows
              sharded across the ranks against one process; the canonical
              CLI at --mesh_devices 2 under both samplers against one
              process. Each rank's launches, per path, equal on every rank,
              summed here. Then the three cross-rank kernels timed as n
              ranks on n streams of this process (one context: the ranks'
              kernels co-resident), from an event before the first launch
              to the last rank's end, bitwise their plain versions, beside
              bound_ms, design_bound_ms and a one-process library
              yardstick of the same bytes.
26. legacy -- the legacy models at the reference's widths from their
              inits (no weights): render_canonical_cli --implicit_model
              neus (NeuS 8 x 256, skip at 4, multires 6 and 4, d_feature
              256; 64+64, fd7) and --implicit_model nerf (NeRF 8 x 256,
              multires 10, "rotate", the view branch, 128 samples),
              LEGACY_ORBIT frames of each orbit at LEGACY_RES^2: every
              frame finite and written, ms per frame; the NeuS init's SDF
              negative inside the radius-0.5 sphere, positive and growing
              outside it; a LEGACY_CPU_RES^2 crop of each on the card and
              the CPU from one set of parameters (NeuS: all but 1% within
              1e-4, every value within 1e-2; NeRF: every value within
              1e-4). The hybrid render (workloads/hybrid.py): the artifact
              warped onto the demo body in pose HYBRID_POSES[0] over a
              NeRF background, and HYBRID_POSES as two avatars, at
              HYBRID_RES^2 from the warp bench's camera: finite, the avatar
              on part of the frame, ms per frame; a HYBRID_CPU_RES^2 crop
              card vs CPU at parity_warp's bounds. The orbax reader on this
              machine (no orbax): the toy guidance's params/ every leaf
              bitwise params_torch.npz, its seconds and the zstd route;
              no kernel of the port launched (the avatar's parameters are
              taken whole).

Before the last line it prints one JSON object {"kernels": [...]} and the
card's name and power limit; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero without it.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

import avatarcraft_tpu_torch
from avatarcraft_tpu_torch import bench, profile_train
from avatarcraft_tpu_torch.cameras import dataset_rays, default_360_path, pose2rays, pose_spherical
from avatarcraft_tpu_torch.cli import reconstruct_cli, render_canonical_cli, render_warp_cli, stylize_cli
from avatarcraft_tpu_torch.constants import CANONICAL_CAMERA_DIST_TRAIN, CANONICAL_ZOOM_FACTOR, NSR_BOUND
from avatarcraft_tpu_torch.data import SMPLMultiviewDataset
from avatarcraft_tpu_torch.models import sd
from avatarcraft_tpu_torch.models.clip_tokenizer import make_toy_tokenizer
from avatarcraft_tpu_torch.models.diffusion import SDSGuidance
from avatarcraft_tpu_torch.models import instant_nsr
from avatarcraft_tpu_torch.models.instant_nsr import (
    FastRenderConfig,
    RenderConfig,
    count_fast_samples,
    extract_sdf_grid,
    render_rays,
    render_rays_chunked,
)
from avatarcraft_tpu_torch.models.nerf import NeRFConfig, init_nerf_params, render_nerf_rays
from avatarcraft_tpu_torch.models.neus import NeuSConfig, build_neus, init_neus_params, neus_sdf
from avatarcraft_tpu_torch.models.sd import unet_apply
from avatarcraft_tpu_torch.ops.grid_encoder import scatter_rows
from avatarcraft_tpu_torch.ops.hash_encoder import HashGridSpec
from avatarcraft_tpu_torch.models.toy_guidance import (
    load_toy_guidance,
    make_ddpm_loss,
    make_toy_modules,
    make_toy_train_step,
    style_map,
)
from avatarcraft_tpu_torch.parallel import dryrun, ring
from avatarcraft_tpu_torch.parallel import mesh as mesh_lib
from avatarcraft_tpu_torch.parallel.table_mp import TableMPTrainStep, trainable_shards
from avatarcraft_tpu_torch.utils.checkpoint import (
    artifact_normal_mode,
    leaves,
    load_checkpoint,
    load_params_with_config,
    load_train_state,
    map_leaves,
    sorted_leaf_paths,
    sorted_leaves,
)
from avatarcraft_tpu_torch.data.amass import load_pose_sequence
from avatarcraft_tpu_torch.models.smpl import load_smpl
from avatarcraft_tpu_torch.tools import (
    bake_artifact,
    eval_psnr,
    eval_style,
    finetune_color,
    finetune_ss,
    make_demo_body,
    preflight_sd,
    profile_stylize_fine,
    prune_grid,
    run_multi_stylize,
    sds_scale_probe,
    style_delta,
    synth_gt_band_check,
    train_toy_guidance,
)
from avatarcraft_tpu_torch.utils import cuda_build, gif, marching_cubes as mc, native, orbax
from avatarcraft_tpu_torch.utils.safetensors import save_file as save_safetensors
from avatarcraft_tpu_torch.utils.style_delta import apply_delta
from avatarcraft_tpu_torch.utils.metrics import integerify_img
from avatarcraft_tpu_torch.utils.png import read_png, write_png
from avatarcraft_tpu_torch.utils.device import card_line
from avatarcraft_tpu_torch.utils.timing import cold_device_ms, cuda_ms, cuda_ms_cold, device_names
from avatarcraft_tpu_torch.warp import WarpData
from avatarcraft_tpu_torch.workloads import hybrid, reconstruct
from avatarcraft_tpu_torch.workloads import stylize as stylize_workload
from avatarcraft_tpu_torch.workloads import warp_render
from avatarcraft_tpu_torch.workloads.canonical_render import make_fast_frame_renderer, make_parity_frame_renderer
from avatarcraft_tpu_torch.workloads.multi_stylize import MultiPromptTrainer, stack_params
from avatarcraft_tpu_torch.workloads.stylize import StylizeConfig, StylizeTrainer
from avatarcraft_tpu_torch.workloads.warp_render import (
    WarpRenderSettings,
    calc_local_trans,
    derive_warp_budget,
    make_warp_frame_renderer_fast,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
CARD_VS_CPU_ATOL = 2e-3  # the pin tests/test_styled_warp.py:112 holds JAX to
# a train step, card against CPU: the losses (f32 sums in other orders) and
# the MLP and variance gradients, per leaf against its max|g|: the packed
# tables are bf16, and where the card's f32 corner sums round a feature to
# the other bf16 neighbour (2^-8 relative) the gradients see it
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL = 1e-2
# the grid refresh, card against CPU, f32 tables: the density 512
# sigmoid(-512 sdf) turns an SDF difference of 1e-6 (f32 sums in another
# order) into up to 512^2/4 x 1e-6 at the surface, the bound
# tests/test_torch_train.py holds the port's refresh to JAX's
REFRESH_ATOL = 512.0**2 / 4 * 1e-6
# a refreshed grid of a field with a surface: neither empty nor saturated
MIN_OCCUPIED_SHARE, MAX_OCCUPIED_SHARE = 1e-3, 0.5
GRID_ROWS, GRID_COLS = 128**3, 4  # the artifact's finest grid as a table
# the hash grid's table at the CLIs' defaults (16 levels x 2^19 rows at
# most, 2 f32 a row): what the parity stylize and reconstruct paths gather
# and reduce-scatter for a hash-grid field
HASH_ROWS, HASH_COLS = HashGridSpec().total_params, HashGridSpec().level_dim
HERE = os.path.dirname(os.path.abspath(__file__))
LAVA_DELTA = os.path.join(HERE, "artifacts", "styled", "multi_lava_delta.npz")
LAVA_EVAL_RECORD = os.path.join(HERE, "docs", "eval", "multi_lava.json")
STYLED_GOLDEN = os.path.join(HERE, "tests", "golden_styled_warp_32.npy")
STYLED_RES, STYLED_FRAME = 32, 10  # tests/test_styled_warp.py:56-84
TOY_DIR = os.path.join(HERE, "artifacts", "toy_guidance")
# stylize: the CLI's coarse steps and the fine trainer's steps (its grid
# refresh, pruning and clip guard at the last one)
STYLIZE_COARSE_STEPS, STYLIZE_FINE_STEPS = 6, 4
STYLIZE_TIMED = 8  # further coarse steps timed on the CLI's trainer
# card against CPU, the toy guidance: eps of one input (full f32 on the
# card; the CPU tests hold JAX to the port at this bound), and the SDS
# gradient of one image: classifier-free guidance at 100 turns an eps error
# e into up to 201 e, and the toy encoder's pullback doubles it
EPS_ATOL = 1e-5
SDS_ATOL = 2 * 201 * EPS_ATOL
SDS_T = 500  # the injected timestep of the card-vs-CPU SDS step
# multi_stylize: run_multi_stylize at its defaults cut to 4 coarse and 2 fine
# SDS steps (n_cap 4: 4 body views an epoch, coarse_epochs = 1, the fine
# epoch cut at 2), then steps timed on its trainer (coarse, fine)
MULTI_COARSE_STEPS, MULTI_FINE_STEPS = 4, 2
MULTI_ARGV = ["--n_cap", "4", "--steps", str(MULTI_COARSE_STEPS), "--fine_steps", str(MULTI_FINE_STEPS)]
MULTI_TIMED = (4, 2)
MULTI_T = [SDS_T, 233]  # the injected timesteps of the card-vs-CPU multi step
# Stable Diffusion at full width: the trainer's coarse and fine steps, in
# each stage a warm-up, timed ones and a profiled one
SD_COARSE_STEPS, SD_FINE_STEPS = 4, 3
SD_TXT2IMG_STEPS = 4
TOY_DDPM_STEPS, TOY_DDPM_BATCH = 20, 32
# card against CPU at a reduced Stable Diffusion width
SD_SMALL = {
    "1.5": (sd.UNetConfig(block_out_channels=(64, 128, 256, 256)), sd.VAEConfig(block_out_channels=(32, 64, 128, 128)),
            sd.CLIPTextConfig(num_layers=2)),
    "2.0": (sd.UNetConfig(block_out_channels=(64, 128, 256, 256), in_channels=5, cross_attention_dim=1024,
                          attention_head_dim=(2, 4, 8, 8)),
            sd.VAEConfig(block_out_channels=(32, 64, 128, 128)),
            sd.CLIPTextConfig(hidden_size=1024, num_layers=2, num_heads=16)),
}
SD_SMALL_IMAGE = 256
# the UNet's eps (and CLIP's embeddings) card against CPU, relative to
# max|ref|: f32 sums in other orders (cuDNN against the CPU's convolutions)
SD_EPS_REL = 1e-5
# classifier-free guidance at 100 turns an eps error e into up to 201 e
# before the clamp; at 7.5 into up to 16 e, which PNDM's coefficients (at
# most about 1 here) carry into the latents
SD_SDS_REL = 201 * SD_EPS_REL
# the guidance batched over 2 prompts against 2 single calls, relative to
# max|g|: the UNet's and the VAE's f32 sums in other orders where cuDNN picks
# other algorithms for the larger batch, the same 201 x eps bound
SD_BATCH_REL = SD_SDS_REL
SD_PNDM_REL = (2 * 7.5 + 1) * SD_EPS_REL
# a toy DDPM step, card against CPU: the loss, and each gradient leaf
# against its own max|g| plus a floor for leaves whose gradient is zero but
# for rounding (the CPU tests hold the port to JAX at 1e-4 and 1e-6)
DDPM_LOSS_RTOL, DDPM_GRAD_REL, DDPM_GRAD_FLOOR = 1e-5, 1e-3, 1e-5
# reconstruct: a dataset in smpl_da_512's layout written from the artifact
# (100 views at 512x512 on a black background, the training distance), the
# CLI's steps for each sampler and for the resume, the mesh resolution
RECON_VIEWS, RECON_RES, RECON_RENDER_CHUNK = 100, 512, 65536
RECON_STEPS, RECON_RESUME_STEPS, RECON_MESH_RES = 40, 4, 128
RECON_MESH_EXPORT_RES = 512  # the CLI's default --mesh_resolution, timed once
RECON_FAST_REFRESH = 20  # the fast run's grid warmup, refresh period and state period
# reconstruct_scan: the fast CLI with --scan_steps 5 for 43 steps (8 calls and
# a tail of 3), against --scan_steps 0; the graphed scan against the eager
# one over calls of 5, 5 and 3 steps
RECON_SCAN_STEPS, RECON_SCAN_MAX, RECON_SCAN_TAIL = 5, 43, 3
# tools: eval_psnr's default views at level 4 (128x128) against the raw
# images; the artifact rendered the set (8-bit PNGs of its renders), so its
# PSNR there is high; the fp16-table bake of a state within a margin of it
# (the renderer packs tables to bf16 either way); prune_grid's cell counts
# on the card and the CPU; eval_style at the committed record's 128x128
TOOLS_VIEWS, TOOLS_LEVEL = "13,62,95", 4
TOOLS_ARTIFACT_PSNR_FLOOR = 35.0  # dB
TOOLS_BAKE_PSNR_MARGIN = 0.1  # dB
TOOLS_PRUNE_SHARE = 1e-3
TOOLS_STYLE_RES, TOOLS_STYLE_VIEWS = 128, 4
# finetune: finetune_color from the artifact with analytic normals for a few
# steps; finetune_ss from the fast run's state at ss 2 for two calls, the
# grid refreshed after the second and the state saved after the first;
# train_toy_guidance at 64x64 over a few views and steps; make_demo_body
# with both rigs at its default 128^3, each rendered as one warp frame
FINETUNE_COLOR_STEPS = 8
FINETUNE_SS, FINETUNE_SS_SCAN = 2, 5
TOY_TRAIN_VIEWS, TOY_TRAIN_RES, TOY_TRAIN_STEPS, TOY_TRAIN_SCAN = 16, 64, 10, 5
DEMO_BODY_LATTICE, DEMO_BODY_RES = 128, 32  # make_demo_body's default lattice; each made body's warp frame
# probes: synth_gt_band_check's view of the reconstruct set; sds_scale_probe's
# steps; profile_stylize_fine cut from 40 steps with a refresh every 10; the
# postprocess script for one prompt at a small frame and trajectory
PROBES_BAND_VIEW, PROBES_SDS_STEPS = 13, 2
PROBES_FINE_STEPS, PROBES_FINE_REFRESH = 12, 5
PROBES_POST_RES, PROBES_POST_TRAJ, PROBES_POST_PROMPT = 64, 2, "lava"
# appended to each of the postprocess script's Python processes: the K10
# launches it made, one JSON line a process, into $K10_LAUNCHES_OUT (the
# installation's own sitecustomize, if any, still runs)
LAUNCH_HOOK = '''import atexit, json, os, sys

def _record():
    ring = sys.modules.get("avatarcraft_tpu_torch.parallel.ring")
    with open(os.environ["K10_LAUNCHES_OUT"], "a") as fp:
        fp.write(json.dumps({"argv": [os.path.basename(sys.argv[0])] + sys.argv[1:3],
                             "launches": dict(ring.launches) if ring else {}}) + "\\n")

atexit.register(_record)
_here = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _here]
del sys.modules["sitecustomize"]
try:
    import sitecustomize  # noqa: F401
except ImportError:
    pass
'''
# one parity step of the hash grid, card against CPU, on a 32x32 block of
# view 0: the loss as the fast step's (TRAIN_LOSS_RTOL); every gradient
# leaf, the hash table's included, within 1e-2 x its max|g|. Both devices
# add the table's cotangents row by row in one order (a stable sort, an f32
# segment sum), so what differs is the cotangents themselves: f32 MLP sums
# in other orders, and the up-sampled depths those move (the CDF inversion
# divides an SDF difference by a bin's CDF step), which move a sample's
# trilinear weights by up to 640 x its shift on the finest level
HASH_GRAD_REL = 1e-2
# the parity pipeline: the canonical CLI's frames (a body and a head orbit of
# PARITY_ORBIT frames each at 256x256), card against CPU on a 32x32 frame
# with f32 tables; the warp CLI's frames at 128x128 of the demo body, card
# against CPU on a 16x16 frame. A parity frame is held per value at 1e-2,
# and all but 1% of its values at 1e-4 (canonical, f32 tables) or all but
# 3% at 2e-3 (warp, the fast warp frame's bound,
# tests/test_torch_warp_render.py). Each share lies above two readings: the
# card against the CPU on an H100 (0.2%, 6 of 3,072 values; 1.2%, 9 of
# 768) and the share a one-ulp change of the inputs moves past the bound
# (0.29%, the port's frame; 2.3%, the JAX package's warp frame):
# the up-sampler's CDF inversion moves a sample by up to 10^4 x an SDF
# difference where the CDF is flat, and the warp resolves near-ties inside
# the body to other faces, so a pixel at a silhouette moves by up to 7.2e-3
# when the artifact's parameters move by one ulp (the port's own 32x32
# frame, f32 tables; the JAX package's warp frame by up to 1.1e-2;
# tests/parity_sensitivity.py)
PARITY_ORBIT, PARITY_RES, PARITY_CPU_RES, PARITY_CPU_ATOL = 2, 256, 32, 1e-4
PARITY_WARP_RES, PARITY_WARP_FRAMES, PARITY_WARP_VIEW = 128, 2, 58
PARITY_WARP_CPU_RES, PARITY_FRAME_ATOL, PARITY_FRAME_MAX = 16, 2e-3, 1e-2
PARITY_CPU_OUTLIER_SHARE, PARITY_WARP_OUTLIER_SHARE = 0.01, 0.03
# a parity SDS step card against CPU: the gradients per leaf at
# stylize_card_vs_cpu's 1e-2 x max|g|, but the variance's at 1e-1: its
# gradient, one sum over every sample, moves by up to 3.5e-2 x max|g| when
# the field's parameters move by one ulp (the reduced-width field below,
# on the CPU; tests/parity_sensitivity.py)
PARITY_VARIANCE_GRAD_REL = 1e-1
# the parity stylize CLI's coarse steps (the first a warm-up) and the fine
# trainer's (the first a warm-up); one more of each is profiled
PARITY_COARSE_STEPS, PARITY_FINE_STEPS = 3, 2
# card against CPU: a reduced-width pyramid field with f32 tables and a
# surface (the init's SDF shifted by -1), a 128x128 view whose coarse frame
# is 32x32, one 1024-ray patch
PARITY_SMALL_FCFG = instant_nsr.FieldConfig(
    encoder="tpu_pyramid", packed_dtype="float32",
    pyramid=instant_nsr.PyramidSpec(grid_resolutions=(16, 32), grid_dim=4, plane_resolutions=(64, 128), plane_dim=4))
PARITY_SMALL_VIEW = dict(H=128, W=128, batch_size=1024)
KERNELS = {
    ring.KERNEL: {
        "route": "cuda",
        "source": "avatarcraft_tpu_torch/csrc/all_gather_rows.cu",
        "replaces": "avatarcraft_tpu/parallel/ring.py:27",
    },
    ring.RS_KERNEL: {
        "route": "cuda",
        "source": "avatarcraft_tpu_torch/csrc/reduce_scatter_rows.cu",
        "replaces": "avatarcraft_tpu/parallel/ring.py:27 (its VJP, ring.py:168-169)",
    },
    ring.PEER_GATHER: {
        "route": "cuda",
        "source": "avatarcraft_tpu_torch/csrc/ring_peer.cu",
        "replaces": "avatarcraft_tpu/parallel/ring.py:27 (across devices, ring_all_gather at ring.py:133)",
    },
    ring.PEER_RS: {
        "route": "cuda",
        "source": "avatarcraft_tpu_torch/csrc/ring_peer.cu",
        "replaces": "avatarcraft_tpu/parallel/ring.py:27 (its VJP across devices, ring.py:168-169)",
    },
    ring.PEER_AR: {
        "route": "cuda",
        "source": "avatarcraft_tpu_torch/csrc/ring_peer.cu",
        "replaces": "none: the port's own all-reduce, where XLA inserts the gradient psum "
                    "(avatarcraft_tpu/workloads/reconstruct.py:12-13)",
    },
}


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"[phase {self.name}] start", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__}: {exc})"
        print(f"[phase {self.name}] end {status} {dt:.2f} s", flush=True)
        return False


def check_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this check needs a CUDA card")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"device: {name} x{count}", flush=True)
    print(f"nvidia-smi: {card_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    return {"platform": "gpu", "kind": name, "count": count}


def build_kernels() -> None:
    """nvcc builds the kernels and g++ the native mesh extractor, all
    started together."""
    sources = {os.path.splitext(os.path.basename(meta["source"]))[0] for meta in KERNELS.values()}
    seconds = cuda_build.build(sorted(sources) + [native.LIB])
    for name, s in seconds.items():
        print(f"built {name} in {s:.2f} s -> {cuda_build.library_path(name)}", flush=True)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    int_of = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(int_of), b.view(int_of))


def _gather_over_sentinel(shards) -> torch.Tensor:
    """The gather kernel's output written over all-ones bytes (NaN in f32
    and fp16), so that a range the kernel skips cannot pass on bytes an
    earlier case left in a reused block."""
    first = shards[0]
    shard_bytes = first.numel() * first.element_size()
    out = torch.full((len(shards) * shard_bytes,), 0xFF, dtype=torch.uint8, device="cuda")
    out = out.view(first.dtype).view(len(shards) * first.shape[0], first.shape[1])
    ring.launch(ring.shard_pointers(shards), out, shard_bytes)
    return out


def check_gather_kernel() -> dict:
    """all_gather_rows vs torch.cat, bitwise, through the wrapper and
    through a launch over a sentinel; no host-to-device copy in the
    wrapper; timings at the main path's shape (one shard per card: the
    whole table in one shard) and at 4 shards."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        (n, dtype, GRID_ROWS // n, GRID_COLS)
        for n in (1, 2, 4, 8)
        for dtype in (torch.float32, torch.float16)
    ]
    cases += [
        (3, torch.float16, 1001, 3),  # 6-byte rows: plain loads and stores
        (ring.MAX_SHARDS, torch.float32, 37, 4),  # the cap, small shards, spans over many shards
        (ring.MAX_SHARDS, torch.float16, 37, 3),  # the cap, shards at every even offset mod 16
        (3, torch.float16, 699_051, 3),  # shards 1 and 2 off by 2 and 4 bytes mod 16, over many blocks
        (5, torch.float32, 419_430, 4),  # 5 shards: spans that cross shard boundaries
        (1, torch.float32, HASH_ROWS, HASH_COLS),  # the hash table: 8-byte rows, 8 bytes past a 16-byte multiple
        (4, torch.float32, HASH_ROWS // 4, HASH_COLS),
    ]
    max_err = 0.0
    for n, dtype, rows, cols in cases:
        shards = [torch.randn(rows, cols, generator=gen, device="cuda").to(dtype) for _ in range(n)]
        want = ring.all_gather_rows_plain(shards)
        for got in (ring.all_gather_rows(shards), _gather_over_sentinel(shards)):
            torch.cuda.synchronize()
            if not _same_bits(got, want):
                raise AssertionError(f"all_gather_rows != torch.cat for n={n} {dtype} [{rows},{cols}]")
            max_err = max(max_err, float((got.float() - want.float()).abs().max()))
    # shards that start 6 bytes past a 16-byte boundary
    base = torch.randn(4, 1002, 3, generator=gen, device="cuda").half()
    shards = [b[1:] for b in base]
    want = ring.all_gather_rows_plain(shards)
    for got in (ring.all_gather_rows(shards), _gather_over_sentinel(shards)):
        if not _same_bits(got, want):
            raise AssertionError("all_gather_rows != torch.cat for misaligned shards")
    print(f"all_gather_rows bitwise equal to torch.cat in {len(cases) + 1} cases", flush=True)

    # the wrappers copy nothing to the card: over ten calls the profiler
    # sees each kernel and no host-to-device copy (and does see the copy of
    # a control that makes one)
    shards = [torch.randn(GRID_ROWS // 4, GRID_COLS, generator=gen, device="cuda") for _ in range(4)]
    control = device_names(lambda: torch.ones(4, pin_memory=True).to("cuda", non_blocking=True))
    names = device_names(lambda: ring.all_gather_rows(shards))
    rs_names = device_names(lambda: ring.reduce_scatter_rows([shards[0]], 4))
    print(f"all_gather_rows puts on the card: {sorted(set(names))} ({len(names)} events in ten calls); "
          f"reduce_scatter_rows: {sorted(set(rs_names))}; a pinned copy: {sorted(set(control))}", flush=True)
    if any("Memcpy HtoD" in name for name in names) or not any("gather_rows_kernel" in name for name in names):
        raise AssertionError(f"all_gather_rows wrapper: device events {names}")
    if any("Memcpy HtoD" in name for name in rs_names) or not any("reduce_scatter_rows_kernel" in name
                                                                  for name in rs_names):
        raise AssertionError(f"reduce_scatter_rows wrapper: device events {rs_names}")
    if not any("Memcpy HtoD" in name for name in control):
        raise AssertionError(f"the profiler did not show the control's host-to-device copy: {control}")

    timings = {}
    for n in (1, 4):
        shards = [
            torch.randn(GRID_ROWS // n, GRID_COLS, generator=gen, device="cuda") for _ in range(n)
        ]
        nbytes = 2 * GRID_ROWS * GRID_COLS * 4  # read every shard once, write the table once
        ptrs = ring.shard_pointers(shards)
        out = torch.empty(GRID_ROWS, GRID_COLS, device="cuda")
        kernel = lambda: ring.launch(ptrs, out, GRID_ROWS // n * GRID_COLS * 4)  # noqa: E731
        library = lambda: torch.cat(shards, dim=0)  # noqa: E731
        kernel_dev, _ = cold_device_ms(kernel)
        library_dev, library_names = cold_device_ms(library)
        t = {
            "kernel_ms": cuda_ms(kernel),
            "wrapper_ms": cuda_ms(lambda: ring.all_gather_rows(shards)),
            "plain_ms": cuda_ms(lambda: ring.all_gather_rows_plain(shards)),
            "library_ms": cuda_ms(library),
            "kernel_cold_ms": cuda_ms_cold(kernel),
            "library_cold_ms": cuda_ms_cold(library),
            "kernel_cold_device_ms": kernel_dev,
            "library_cold_device_ms": library_dev,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
        print(f"all_gather_rows n={n} [{GRID_ROWS},{GRID_COLS}] f32: " + json.dumps(t), flush=True)
        print(f"torch.cat of {n} shard(s) launches: {library_names}", flush=True)
        timings[n] = t
    shards = [torch.randn(HASH_ROWS, HASH_COLS, generator=gen, device="cuda")]
    ptrs, out = ring.shard_pointers(shards), torch.empty(HASH_ROWS, HASH_COLS, device="cuda")
    t = {
        "kernel_ms": cuda_ms(lambda: ring.launch(ptrs, out, HASH_ROWS * HASH_COLS * 4)),
        "wrapper_ms": cuda_ms(lambda: ring.all_gather_rows(shards)),
        "plain_ms": cuda_ms(lambda: ring.all_gather_rows_plain(shards)),
        "library_ms": cuda_ms(lambda: torch.cat(shards, dim=0)),
        "bound_ms": 2 * HASH_ROWS * HASH_COLS * 4 / HBM_BYTES_PER_S * 1e3,
    }
    print(f"all_gather_rows n=1 [{HASH_ROWS},{HASH_COLS}] f32 (the hash table): " + json.dumps(t), flush=True)
    return {"max_abs_err": max_err, **timings[1]}


def _misaligned(gen, rows: int, cols: int, floats: int) -> torch.Tensor:
    """A [rows, cols] f32 view that starts ``floats`` x 4 bytes past a
    16-byte boundary of a larger buffer."""
    base = torch.randn(rows * cols + 4, generator=gen, device="cuda")
    return base[floats:floats + rows * cols].view(rows, cols)


def _share_of_bound(t: dict) -> dict:
    """The bound over each of the kernel's times."""
    return {f"share_of_bound{k[len('kernel'):-len('_ms')]}": t["bound_ms"] / t[k]
            for k in ("kernel_ms", "kernel_cold_ms", "kernel_cold_device_ms")}


def check_reduce_scatter_kernel() -> dict:
    """reduce_scatter_rows vs its plain version, bitwise, for m replicas x
    n shards of the 128^3 x 4 table, ragged, misaligned and capped cases,
    the hash table and a captured and replayed CUDA graph; timings at the
    training path's shape (one replica, one shard per card), at 4 shards,
    4 replicas, the hash table and a cotangent 4 bytes past a boundary."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err, n_cases = 0.0, 0

    def check(cts, n, what, got=None):
        nonlocal max_err, n_cases
        got = ring.reduce_scatter_rows(cts, n) if got is None else got
        want = ring.reduce_scatter_rows_plain(cts, n)
        torch.cuda.synchronize()
        if len(got) != n or not all(_same_bits(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"reduce_scatter_rows != its plain version for {what}")
        max_err = max(max_err, max(float((g - w).abs().max()) for g, w in zip(got, want)))
        n_cases += 1

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    for m in (1, 2, 4):
        cts = [randn(GRID_ROWS, GRID_COLS) for _ in range(m)]
        for n in (1, 2, 4, 8):
            check(cts, n, f"m={m} n={n} [{GRID_ROWS},{GRID_COLS}]")
    # 3-float rows, shards of 3003 floats: no 16-byte middle in shards 1 and 2
    check([randn(3 * 1001, 3) for _ in range(2)], 3, "m=2 n=3 [3003,3]")
    # a table that starts 4 bytes past a 16-byte boundary
    base = randn(2, 4 * 64 * 4 + 1)
    check([b[1:].view(4 * 64, 4) for b in base], 4, "m=2 n=4, misaligned")
    # the hash table: one replica as the SDS and train steps give it, and more
    for m in (1, 2, 3, 8):
        check([randn(HASH_ROWS, HASH_COLS) for _ in range(m)], 1,
              f"m={m} n=1 [{HASH_ROWS},{HASH_COLS}], the hash table")
    # shards of 1, 2 and 3 floats mod 4: shard boundaries inside 16-byte words
    for n, rows, cols in ((2, 100_003, 1), (3, 100_003, 2), (5, 100_001, 3)):
        for m in (1, 2):
            check([randn(n * rows, cols) for _ in range(m)], n, f"m={m} n={n} [{n * rows},{cols}]")
    # cotangents 4, 8 and 12 bytes past a 16-byte boundary, alone, and three
    # replicas each at another offset
    for floats in (1, 2, 3):
        ct = _misaligned(gen, GRID_ROWS // 8, GRID_COLS, floats)
        for n in (1, 4):
            check([ct], n, f"m=1 n={n}, {4 * floats} bytes past a boundary")
        cts = [_misaligned(gen, GRID_ROWS // 8, GRID_COLS, (floats + r) % 4) for r in range(3)]
        check(cts, 4, f"m=3 n=4, {4 * floats} bytes past a boundary and on")
    # m + n at the 128-pointer cap, small shards
    for m in (1, 64, 127):
        n = ring.MAX_TABLES - m
        check([randn(n * 37, 3) for _ in range(m)], n, f"m={m} n={n} [{n * 37},3], the cap")
    # a captured launch replayed on inputs changed in place: the graph holds
    # the pointers, and each replay reads what the inputs hold then
    for m, n, rows, cols in ((1, 4, GRID_ROWS, GRID_COLS), (3, 1, HASH_ROWS, HASH_COLS)):
        cts = [randn(rows, cols) for _ in range(m)]
        ring.reduce_scatter_rows(cts, n)  # warm-up, outside the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = ring.reduce_scatter_rows(cts, n)
        for _ in range(2):
            for c in cts:
                c.copy_(randn(rows, cols))
            graph.replay()
            check(cts, n, f"m={m} n={n} [{rows},{cols}], a replayed graph", got=outs)
        del graph
    print(f"reduce_scatter_rows bitwise equal to its plain version in {n_cases} cases", flush=True)

    timings = {}
    # (m, n, table, floats the cotangent starts past a 16-byte boundary)
    for m, n, rows, cols, floats in ((1, 1, GRID_ROWS, GRID_COLS, 0), (1, 4, GRID_ROWS, GRID_COLS, 0),
                                     (4, 1, GRID_ROWS, GRID_COLS, 0), (1, 1, HASH_ROWS, HASH_COLS, 0),
                                     (1, 1, GRID_ROWS, GRID_COLS, 1)):
        cts = [_misaligned(gen, rows, cols, floats) if floats else randn(rows, cols) for _ in range(m)]
        outs = [torch.empty(rows // n, cols, device="cuda") for _ in range(n)]
        ptrs = ring.shard_pointers(cts + outs)
        nbytes = (m + 1) * rows * cols * 4  # read m tables, write one table's worth
        kernel = lambda: ring.launch_reduce_scatter(ptrs, outs[0].device, rows // n, cols, m, n)  # noqa: E731
        wrapper = lambda: ring.reduce_scatter_rows(cts, n)  # noqa: E731
        # m = 1: Tensor.clone, the one call that computes the function (the
        # split is views); m > 1: the replicas stacked and summed
        if m == 1:
            yard, library = "library", lambda: cts[0].clone()  # noqa: E731
        else:
            yard = "stack_sum"
            library = lambda: [c.contiguous() for c in torch.stack(cts).sum(0).chunk(n)]  # noqa: E731
        kernel_dev, _ = cold_device_ms(kernel)
        library_dev, _ = cold_device_ms(library)
        t = {
            "kernel_ms": cuda_ms(kernel),
            "wrapper_ms": cuda_ms(wrapper),
            "plain_ms": cuda_ms(lambda: ring.reduce_scatter_rows_plain(cts, n)),
            f"{yard}_ms": cuda_ms(library),
            "kernel_cold_ms": cuda_ms_cold(kernel),
            "wrapper_cold_ms": cuda_ms_cold(wrapper),
            f"{yard}_cold_ms": cuda_ms_cold(library),
            "kernel_cold_device_ms": kernel_dev,
            f"{yard}_cold_device_ms": library_dev,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
        t.update(_share_of_bound(t))
        what = " (the hash table)" if rows == HASH_ROWS else f", {4 * floats} bytes past a boundary" if floats else ""
        print(f"reduce_scatter_rows m={m} n={n} [{rows},{cols}] f32{what}: " + json.dumps(t), flush=True)
        timings[(m, n, rows, floats)] = t
    return {"max_abs_err": max_err, **timings[(1, 1, GRID_ROWS, 0)]}


def _reset_launches() -> None:
    for name in ring.launches:
        ring.launches[name] = 0


def _read_launches(path: str, names) -> dict:
    counts = dict(ring.launches)
    print(f"{path}: kernel launches {json.dumps(counts)}", flush=True)
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"the {path} path never launched {name}")
    return counts


def check_main_path() -> dict:
    _reset_launches()
    result = bench.run("cuda")
    launches = _read_launches("render", [ring.KERNEL])
    frames = result.pop("frames")
    for i, f in enumerate(frames):
        if f.shape != (bench.RES, bench.RES, 3) or not torch.isfinite(f).all():
            raise AssertionError(f"frame {i}: shape {tuple(f.shape)} or non-finite values")
    if not (frames[0] < 0.99).any():
        raise AssertionError("frame 0 is empty: the body was not rendered")
    print("bench: " + json.dumps(result), flush=True)
    print(f"main path: {result['value']:.1f} rays/s", flush=True)

    params, fcfg, grid, cfg = bench.load_artifact("cuda")
    cfg = dataclasses.replace(cfg, sample_budget=result["sample_budget"])
    render4 = make_fast_frame_renderer(params, fcfg, cfg, grid, chunk=bench.RES * bench.RES, n_shards=4)
    ro, rd = pose2rays(bench.RES, bench.RES, bench.bench_poses()[0], device="cuda")
    frame4 = render4(ro, rd)["rgb"].reshape(bench.RES, bench.RES, 3).cpu()
    if not torch.equal(frame4, frames[0]):
        diff = float((frame4 - frames[0]).abs().max())
        raise AssertionError(f"4-shard frame differs from the 1-shard frame (max {diff})")
    print("4-shard frame bitwise equal to the 1-shard frame", flush=True)
    return launches


def check_train_fast() -> dict:
    ds, fcfg, normal_mode = profile_train.artifact_image_set("cuda")
    fast_cfg = FastRenderConfig(normal_mode=normal_mode)
    _reset_launches()
    _, grid, stats = reconstruct.train_fast(
        ds, fcfg, fast_cfg, reconstruct.ReconstructConfig(), max_steps=40,
        grid_update_every=20, grid_warmup_steps=20, log_every=1, device="cuda",
    )
    torch.cuda.synchronize()
    launches = _read_launches("train_fast", [ring.KERNEL, ring.RS_KERNEL])
    losses = [l for _, l in stats["losses"]]
    print("train_fast: " + json.dumps({k: v for k, v in stats.items() if k != "losses"}), flush=True)
    print("train_fast losses: " + json.dumps([round(l, 6) for l in losses]), flush=True)
    if len(losses) != 40 or not np.isfinite(losses).all():
        raise AssertionError(f"train_fast: {len(losses)} losses, finite: {np.isfinite(losses).all()}")
    # the loss falls over the warmup on the saturated grid (steps 0-4 ->
    # 15-19). init_field_params' SDF is positive everywhere (zero biases, a
    # positive last layer over softplus), and at step 20 the young field has
    # no surface yet: the refresh from zeros leaves a near-empty grid and the
    # loss rises after it, in the JAX package's trainer as in the port
    # (tests/test_torch_train.py::test_train_fast_refresh_schedule_matches_jax).
    # So steps 20-39 are read, not compared with steps 0-4; the refresh itself
    # is held to the CPU on the artifact's field in the cpu phase.
    first, warm, last = (float(np.mean(losses[i : i + 5])) for i in (0, 15, 35))
    if not warm < first:
        raise AssertionError(f"train_fast: the loss did not fall over the warmup ({first} -> {warm})")
    if tuple(grid.shape) != (129, 129, 129) or not torch.isfinite(grid).all() or float(grid.max()) >= 100.0:
        raise AssertionError(f"train_fast: grid of shape {tuple(grid.shape)}, finite "
                             f"{bool(torch.isfinite(grid).all())}, max {float(grid.max())} (not refreshed)")
    print(f"train_fast: mean loss of steps 0-4 {first:.6f}, 15-19 {warm:.6f}, 35-39 {last:.6f}; "
          f"refreshed grid max {float(grid.max()):.4g}, occupied share "
          f"{float((grid > min(10.0, float(grid.mean()))).float().mean()):.4f}", flush=True)
    return {**launches, "stats": stats}


def _table_grad(step) -> torch.Tensor:
    return torch.cat([s.grad for s in step.shards])


def check_table_mp() -> dict:
    """1 shard three times, 4 shards once: the losses and the table
    gradients all bitwise equal. The encoder's backward adds each row's
    cotangents in one order (ops/grid_encoder.py::scatter_rows), and at m =
    1 the reduce-scatter only splits; both table kernels are bitwise equal
    to their plain versions. Also scatter_rows itself on the card against
    the CPU on heavily repeated rows: bitwise equal."""
    gen = torch.Generator().manual_seed(3)
    idx = torch.randint(0, 1000, (200_000,), generator=gen)
    grad = torch.randn(200_000, 16, generator=gen).to(torch.bfloat16)
    card = scatter_rows(idx.cuda(), grad.cuda(), 1000).cpu()
    if not (_same_bits(card, scatter_rows(idx, grad, 1000)) and _same_bits(card, scatter_rows(idx.cuda(), grad.cuda(), 1000).cpu())):
        raise AssertionError("scatter_rows: the card's sums differ from run to run or from the CPU's")
    print("scatter_rows: 200,000 bf16 rows into 1,000, card bitwise equal to the CPU and to itself", flush=True)

    params, fcfg, grid, fast_cfg = bench.load_artifact("cuda")
    ro, rd = pose2rays(32, 32, bench.bench_poses()[0], device="cuda")
    render = make_fast_frame_renderer(params, fcfg, fast_cfg, grid, chunk=32 * 32)
    gt = render(ro, rd)["rgb"]
    rcfg = RenderConfig(perturb=False)
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.5)  # noqa: E731

    def run(n):
        step = TableMPTrainStep(params, n, fcfg, rcfg, sgd)
        loss = step(ro, rd, gt)
        torch.cuda.synchronize()
        return loss, _table_grad(step)

    _reset_launches()
    ones = [run(1) for _ in range(3)]
    loss4, g4 = run(4)
    launches = _read_launches("table_mp", [ring.KERNEL, ring.RS_KERNEL])
    (loss1, g1), gs = ones[0], [g for _, g in ones]
    spread = max(float((a - b).abs().max()) for i, a in enumerate(gs) for b in gs[i + 1 :])
    diff = float((g4 - g1).abs().max())
    print(f"table_mp: loss 1 shard {[float(l) for l, _ in ones]}, 4 shards {float(loss4):.9g}; "
          f"table gradient max|g| {float(g1.abs().max()):.4g}, spread of three 1-shard runs {spread:.4g}, "
          f"4-shard vs 1-shard {diff:.4g}", flush=True)
    if not (torch.isfinite(loss4) and all(_same_bits(l, loss4) for l, _ in ones)):
        raise AssertionError(f"table_mp: 1-shard losses {[float(l) for l, _ in ones]} != 4-shard loss {float(loss4)}")
    if not all(_same_bits(g, g1) for g in gs[1:] + [g4]):
        raise AssertionError(f"table_mp: table gradients not bitwise equal: spread of the 1-shard runs {spread}, "
                             f"4-shard vs 1-shard {diff}")
    return launches


def _require_full_f32(when: str) -> None:
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError(f"TF32 matrix products are on {when}: the warp's kNN needs full f32")


def check_warp_path() -> dict:
    """The warp bench: 4 demo frames at 256x256, each finite, zero-clip
    (bench.run_warp raises otherwise) and not empty; the gather kernel
    launched once per frame."""
    _require_full_f32("before the warp path")
    _reset_launches()
    result = bench.run_warp("cuda")
    launches = _read_launches("warp", [ring.KERNEL])
    _require_full_f32("after the warp path")
    frames = result.pop("frames")
    if launches[ring.KERNEL] != len(frames):
        raise AssertionError(f"warp: {launches[ring.KERNEL]} gather launches for {len(frames)} frames")
    for i, f in enumerate(frames):
        if f.shape != (bench.RES, bench.RES, 3) or not torch.isfinite(f).all():
            raise AssertionError(f"warp frame {i}: shape {tuple(f.shape)} or non-finite values")
        if not (f < 0.99).any():
            raise AssertionError(f"warp frame {i} is empty: the body was not rendered")
    print("bench warp: " + json.dumps(result), flush=True)
    print(f"warp path: {result['value']:.1f} rays/s, peak memory {result['peak_memory_gib']:.2f} GiB", flush=True)
    return launches


def check_styled_warp() -> None:
    """The lava delta applied through the port's style_delta; demo frame 10
    at 32x32 from the warp view on the card and on the CPU, with the budget
    derived on the CPU: within CARD_VS_CPU_ATOL, the foreground
    red-dominant (tests/test_styled_warp.py:97-102)."""
    model, world_verts, Ts = bench.demo_frames(1, first=STYLED_FRAME)
    settings = WarpRenderSettings(chunk=STYLED_RES * STYLED_RES)
    imgs, budget = {}, None
    for device in ("cpu", "cuda"):
        base, _, _, _ = bench.load_artifact(device)
        styled, fcfg, _ = apply_delta(base, LAVA_DELTA)
        ro, rd = pose2rays(STYLED_RES, STYLED_RES, bench.warp_view(), device=device)
        if budget is None:
            budget = derive_warp_budget(world_verts, ro, rd, settings)
        render = make_warp_frame_renderer_fast(styled, fcfg, settings, budget)
        rgb = render(ro, rd, WarpData.create(world_verts[0], model.faces, Ts[0], device))
        imgs[device] = rgb.reshape(STYLED_RES, STYLED_RES, 3).cpu().numpy()
    card, cpu = imgs["cuda"], imgs["cpu"]
    err = float(np.abs(card - cpu).max())
    golden = float(np.abs(card - np.load(STYLED_GOLDEN)).max())
    fg = card[np.abs(card - 1.0).sum(-1) > 0.15]
    red, blue = (float(fg[:, c].mean()) if len(fg) else 0.0 for c in (0, 2))
    print(f"styled warp frame {STYLED_FRAME} at {STYLED_RES}x{STYLED_RES}, budget {budget}: card vs CPU max abs "
          f"diff {err:.3g} (atol {CARD_VS_CPU_ATOL}); card vs tests/golden_styled_warp_32.npy {golden:.3g}; "
          f"{len(fg)} foreground pixels, mean red {red:.3f}, blue {blue:.3f}", flush=True)
    if not (np.isfinite(card).all() and err <= CARD_VS_CPU_ATOL):
        raise AssertionError(f"styled warp frame: card and CPU differ by {err}")
    if not (len(fg) > 30 and red > blue + 0.1):
        raise AssertionError("styled warp frame: the lava foreground is not red-dominant")


def check_card_vs_cpu() -> None:
    pose = bench.bench_poses()[0]
    frames = {}
    budget = None
    for device in ("cpu", "cuda"):
        params, fcfg, grid, cfg = bench.load_artifact(device)
        ro, rd = pose2rays(32, 32, pose, device=device)
        if budget is None:
            budget = int(int(count_fast_samples(ro, rd, cfg, grid)) * 1.02)
        cfg = dataclasses.replace(cfg, sample_budget=budget)
        render = make_fast_frame_renderer(params, fcfg, cfg, grid, chunk=32 * 32)
        frames[device] = render(ro, rd)["rgb"].cpu()
    err = float((frames["cuda"] - frames["cpu"]).abs().max())
    print(f"32x32 frame, card vs CPU: max abs diff {err:.3g} (atol {CARD_VS_CPU_ATOL})", flush=True)
    if not (torch.isfinite(frames["cuda"]).all() and err <= CARD_VS_CPU_ATOL):
        raise AssertionError(f"card and CPU frames differ by {err}")


def _occupied_share(grid: torch.Tensor, occ_threshold: float) -> float:
    """The share of cells the fast render counts as occupied: above
    min(mean, occ_threshold), as its probes read them."""
    return float((grid > torch.clamp(grid.mean(), max=occ_threshold)).float().mean())


def check_refresh_card_vs_cpu() -> None:
    """make_grid_update_fn on the artifact's parameters, card against CPU:
    a refresh from zeros and an EMA refresh of the artifact's own grid.
    With f32 packed tables both devices evaluate one f32 SDF up to the order
    of its sums, so the grids agree within REFRESH_ATOL; each refreshed
    grid must mark a real share of the lattice occupied (the artifact has a
    surface, unlike the young field of the train phase)."""
    grids = {}
    for device in ("cpu", "cuda"):
        params, fcfg, shipped, cfg = bench.load_artifact(device)
        refresh = reconstruct.make_grid_update_fn(dataclasses.replace(fcfg, packed_dtype="float32"), cfg.bound)
        grids[device] = {
            "from zeros": refresh(params, torch.zeros_like(shipped)).cpu(),
            "EMA of the artifact's grid": refresh(params, shipped).cpu(),
        }
    shipped = shipped.cpu()
    print(f"artifact grid: occupied share {_occupied_share(shipped, cfg.occ_threshold):.4f}", flush=True)
    for what, want in grids["cpu"].items():
        got = grids["cuda"][what]
        err = float((got - want).abs().max())
        share = _occupied_share(got, cfg.occ_threshold)
        print(f"grid refresh {what}, card vs CPU: max abs diff {err:.4g} (atol {REFRESH_ATOL:.4g}) on densities "
              f"up to {float(want.max()):.4g}; occupied share {share:.4f} (CPU {_occupied_share(want, cfg.occ_threshold):.4f})",
              flush=True)
        if not (torch.isfinite(got).all() and err <= REFRESH_ATOL):
            raise AssertionError(f"grid refresh {what}: card and CPU differ by {err}")
        if not MIN_OCCUPIED_SHARE <= share <= MAX_OCCUPIED_SHARE:
            raise AssertionError(f"grid refresh {what}: occupied share {share} outside "
                                 f"[{MIN_OCCUPIED_SHARE}, {MAX_OCCUPIED_SHARE}]")


def _train_step_once(device: str, gt: np.ndarray):
    """One fast train step from the artifact on the 32x32 rays of bench
    camera 0: (loss, {leaf name: gradient} of the MLPs and the variance)."""
    params, fcfg, grid, cfg = bench.load_artifact(device)
    K, poses = profile_train.bench_cameras(1, 32)
    rest, shards, splice = trainable_shards(params)
    opt, sched = reconstruct.make_optimizer(reconstruct.ReconstructConfig(), 1000, leaves(rest) + shards)
    step = reconstruct.make_train_step_fast(fcfg, cfg, opt, reconstruct.make_batch_ray_fn(K, 32, 32), 0.1,
                                            splice, sched)
    pix = torch.arange(32 * 32, device=device)
    loss, _ = step(rest, shards, torch.as_tensor(poses, device=device), torch.zeros_like(pix), pix,
                   torch.as_tensor(gt, device=device), grid, 1.0)
    grads = {f"sdf.{i}.{k}": t.grad.cpu() for i, layer in enumerate(rest["sdf"]) for k, t in layer.items()}
    grads.update({f"color.{i}.{k}": t.grad.cpu() for i, layer in enumerate(rest["color"]) for k, t in layer.items()})
    grads["variance"] = rest["variance"].grad.cpu()
    return float(loss), grads


def check_train_card_vs_cpu() -> None:
    gt = np.random.default_rng(0).random((32 * 32, 3)).astype(np.float32)
    loss_cpu, g_cpu = _train_step_once("cpu", gt)
    loss_card, g_card = _train_step_once("cuda", gt)
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    worst = max(float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max()) for k in g_cpu)
    print(f"train step, card vs CPU: loss {loss_card:.9g} / {loss_cpu:.9g} (rel {rel:.3g}, rtol "
          f"{TRAIN_LOSS_RTOL}); worst MLP/variance gradient diff {worst:.3g} x max|g| "
          f"(tolerance {TRAIN_GRAD_REL})", flush=True)
    if not (np.isfinite(loss_card) and rel <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"train step losses differ: card {loss_card}, cpu {loss_cpu}")
    if not worst <= TRAIN_GRAD_REL:
        raise AssertionError(f"train step gradients differ by {worst} x max|g|")


def _expect_launches(path: str, launches: dict, want: dict) -> None:
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"{path}: kernel launches {launches}, expected {want}")


def _mlp_leaves(tree) -> dict:
    """{name: tensor} of the MLP and variance leaves of a parameter tree."""
    out = {f"sdf.{i}.{k}": t for i, layer in enumerate(tree["sdf"]) for k, t in layer.items()}
    out.update({f"color.{i}.{k}": t for i, layer in enumerate(tree["color"]) for k, t in layer.items()})
    out["variance"] = tree["variance"]
    return out


@contextlib.contextmanager
def _timed_export(record: dict):
    """Adds to ``record`` the host seconds of each SDF lattice (on the card,
    ending in its copy to the host) and each marching-cubes call that
    ``extract_geometry`` makes while the context is open."""
    lattice, extract = instant_nsr.extract_sdf_grid, mc.marching_cubes

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            record.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return call

    instant_nsr.extract_sdf_grid, mc.marching_cubes = timed("lattice_s", lattice), timed("extractor_s", extract)
    try:
        yield record
    finally:
        instant_nsr.extract_sdf_grid, mc.marching_cubes = lattice, extract


def _ply_counts(path: str) -> tuple[int, int]:
    """(vertices, faces) of a binary PLY written by save_ply, its size
    checked against them."""
    with open(path, "rb") as fp:
        data = fp.read()
    head = data[: data.index(b"end_header\n") + len(b"end_header\n")]
    text = head.decode("ascii")
    nv = int(text.split("element vertex ")[1].split()[0])
    nf = int(text.split("element face ")[1].split()[0])
    if len(data) != len(head) + 12 * nv + 13 * nf:
        raise AssertionError(f"{path}: {len(data)} bytes for {nv} vertices and {nf} faces")
    return nv, nf


def check_stylize() -> dict:
    """The stylize CLI for STYLIZE_COARSE_STEPS coarse steps (the last
    exports a MESH_RESOLUTION^3 mesh), then a fine trainer for
    STYLIZE_FINE_STEPS steps; returns the table kernels' launches of the
    two runs (each counted from zero)."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_stylize_")
    try:
        n = STYLIZE_COARSE_STEPS
        _reset_launches()
        with _timed_export({}) as export:
            trainer = stylize_cli.main(profile_train.STYLIZE_ARGV + [
                "--max_steps", str(n), "--i_val", str(n), "--i_save", "1000000", "--i_mesh", str(n),
                "--out_dir", out_dir, "--exp_name", "lava",
            ])
        torch.cuda.synchronize()
        cli = _read_launches("stylize (CLI)", [ring.KERNEL, ring.RS_KERNEL])
        # a gather and a reduce-scatter per step; a gather each for the
        # ground truth, the validation render, the mesh export and the final save
        _expect_launches("stylize (CLI)", cli, {ring.KERNEL: n + 4, ring.RS_KERNEL: n})
        exp_dir = os.path.join(out_dir, "lava")
        files = sorted(os.listdir(exp_dir))
        print(f"stylize CLI wrote {files}; budget {trainer.fast_cfg.sample_budget}, normal mode "
              f"{trainer.fast_cfg.normal_mode}", flush=True)
        if (f"lava_{n:04d}_body.png" not in files or "lava_final.pth.tar" not in files
                or f"lava_{n:04d}.ply" not in files):
            raise AssertionError(f"stylize CLI outputs: {files}")
        nv, nf = _ply_counts(os.path.join(exp_dir, f"lava_{n:04d}.ply"))
        if not (len(export.get("lattice_s", [])) == len(export.get("extractor_s", [])) == 1 and nf > 0):
            raise AssertionError(f"stylize mesh export: {export}, {nv} vertices, {nf} faces")
        print(f"stylize mesh export at {stylize_cli.MESH_RESOLUTION}^3 (step {n}): SDF lattice "
              f"{export['lattice_s'][0]:.3f} s, native extractor {export['extractor_s'][0]:.3f} s, {nv} vertices, "
              f"{nf} faces ({card_line()})", flush=True)

        base, fcfg, _, fast = bench.load_artifact("cuda")
        params = trainer.params()
        if not all(torch.isfinite(t).all() for t in leaves(params)):
            raise AssertionError("stylize: non-finite parameters after the CLI run")
        moved = max(float((a - b).abs().max()) for a, b in zip(leaves(_mlp_leaves(params)),
                                                                 leaves(_mlp_leaves(base))))
        loaded, lcfg = load_params_with_config(os.path.join(exp_dir, "lava_final.pth.tar"), "cuda")
        if not (lcfg == fcfg and all(torch.equal(a, b) for a, b in zip(leaves(loaded), leaves(params)))):
            raise AssertionError("stylize: the final checkpoint does not load as the trainer's parameters")
        render = make_fast_frame_renderer(loaded, lcfg, trainer.fast_cfg, trainer.grid, chunk=64 * 64)
        ro, rd = pose2rays(64, 64, bench.bench_poses()[0], device="cuda")
        frame = render(ro, rd)["rgb"]
        print(f"stylize: the MLPs moved by up to {moved:.4g}; the final checkpoint renders a 64x64 frame with "
              f"{int(((frame - 1).abs().sum(-1) > 0.1).sum())} foreground pixels", flush=True)
        if not (moved > 0 and torch.isfinite(frame).all() and (frame < 0.99).any()):
            raise AssertionError("stylize: the style did not move or the checkpoint's frame is empty")

        coarse_s = profile_train.time_stylize_steps(trainer, 0, STYLIZE_TIMED)
        coarse_prof = profile_train.profile_stylize_steps(trainer, 0, 2)
        grid0 = trainer.grid
        fine_cfg = dataclasses.replace(trainer.cfg, coarse_epochs=0, fine_epochs=1,
                                       grid_update_every=STYLIZE_FINE_STEPS)
        fine = StylizeTrainer(fine_cfg, fcfg, trainer.guidance, base, base, grid=grid0, fast_cfg=trainer.fast_cfg)
        del trainer, params, loaded, render
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        fine_s = profile_train.time_stylize_steps(fine, 0, STYLIZE_FINE_STEPS)
        torch.cuda.synchronize()
        fine_launches = _read_launches("stylize (fine)", [ring.KERNEL, ring.RS_KERNEL])
        peak = torch.cuda.max_memory_allocated() / 2**30
        # a gather and a reduce-scatter per step, a gather for the refresh
        m = STYLIZE_FINE_STEPS
        _expect_launches("stylize (fine)", fine_launches, {ring.KERNEL: m + 1, ring.RS_KERNEL: m})
        ro, _, th, tw = fine.view_rays(bench.bench_poses()[0], 0)
        if (th, tw) != (256, 256) or fine.stats["refreshes"] != 1:
            raise AssertionError(f"stylize fine: a {th}x{tw} frame, {fine.stats['refreshes']} refreshes")
        share = _occupied_share(fine.grid, fine.fast_cfg.occ_threshold)
        if not (torch.isfinite(fine.grid).all() and MIN_OCCUPIED_SHARE <= share <= MAX_OCCUPIED_SHARE):
            raise AssertionError(f"stylize fine: refreshed grid finite {bool(torch.isfinite(fine.grid).all())}, "
                                 f"occupied share {share}")
        fine_prof = profile_train.profile_stylize_steps(fine, 0, 1)
        summary = {
            "card": card_line(),
            "sample_budget": fine.fast_cfg.sample_budget,
            "clip_guard_trips": fine.stats["clip_guard_trips"],
            "refreshed_occupied_share": share,
            "coarse_steps_per_sec": len(coarse_s) / sum(coarse_s),
            "coarse_step_ms": [1e3 * x for x in coarse_s],
            # steps 2 and 3: after the first step's warm-up, before the refresh
            "fine_steps_per_sec": 2 / sum(fine_s[1:3]),
            "fine_step_ms": [1e3 * x for x in fine_s],
            "fine_peak_mem_gib": peak,
            "coarse_profile": coarse_prof,
            "fine_profile": fine_prof,
        }
        print("stylize: " + json.dumps(summary), flush=True)
        print(f"stylize: {summary['coarse_steps_per_sec']:.2f} SDS steps/s coarse (64x64), "
              f"{summary['fine_steps_per_sec']:.3f} fine (256x256); peak {peak:.2f} GiB", flush=True)
        return {k: cli[k] + fine_launches[k] for k in cli}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _sds_step_record(device: str, noise: torch.Tensor, packed_dtype: str, cpu: dict | None = None) -> dict:
    """One coarse SDS step of the artifact (64x64 frame, one patch, white
    background) on ``device`` with its tables packed in ``packed_dtype``,
    t = SDS_T and ``noise`` injected. With ``cpu`` (the CPU's record) the
    card's SDS gradient is also computed on the CPU's image, and phase B
    runs on the CPU's gradient."""
    params, fcfg, grid, fast = bench.load_artifact(device)
    fcfg = dataclasses.replace(fcfg, packed_dtype=packed_dtype)
    toy, tcfg, embs = load_toy_guidance(TOY_DIR, device)
    guide = SDSGuidance(make_toy_modules(toy, tcfg, embs))
    cfg = StylizeConfig(tgt_text="lava", augment_bkg=False, coarse_epochs=1, fine_epochs=0, grid_update_every=0,
                        sampler="fast")
    trainer = StylizeTrainer(cfg, fcfg, guide, params, params, grid=grid, fast_cfg=fast)
    rec = {}
    sds = guide.sds_image_grad

    def injected(emb, img, gs, pred_depth=None, **kw):
        rec["img"] = img.cpu()
        g = sds(emb, img, gs, t_override=SDS_T, noise_override=noise.to(device))
        rec["g"] = g.cpu()
        if cpu is None:
            return g
        rec["g_same_img"] = sds(emb, cpu["img"].to(device), gs, t_override=SDS_T,
                                noise_override=noise.to(device)).cpu()
        return cpu["g"].to(device)

    guide.sds_image_grad = injected
    poses, descs = trainer.epoch_poses(0)
    i = int(trainer.rng.permutation(len(poses))[0])
    rec["loss"] = float(trainer.train_view(poses[i], descs[i], 0))
    mlp = _mlp_leaves(trainer.rest)
    rec["grad"] = {k: trainer.opt.state[t]["exp_avg"].cpu() / 0.1 for k, t in mlp.items()}
    rec["params"] = {k: t.detach().cpu() for k, t in mlp.items()}
    return rec


def check_stylize_card_vs_cpu() -> None:
    """The toy UNet, then one SDS step stage by stage, each stage from the
    same inputs on both devices. The step runs with f32 tables: with the
    artifact's bf16 tables a corner sum that the card and the CPU add in
    other orders can round to the other bf16 neighbour (2^-8 relative),
    which the fd4 normals multiply by 1/(4 eps) = 50 (the grid refresh
    check compares f32 tables for the same reason); the bf16 step's
    differences are printed, not held."""
    gen = torch.Generator().manual_seed(0)
    # the toy UNet alone on one input
    lat = torch.randn((2, 3, 64, 64), generator=gen)
    t = torch.tensor([SDS_T, 37], dtype=torch.int32)
    eps = {}
    for device in ("cpu", "cuda"):
        toy, tcfg, embs = load_toy_guidance(TOY_DIR, device)
        with torch.no_grad():
            eps[device] = unet_apply(toy, tcfg.unet, lat.to(device), t.to(device), embs[[0, 3]]).cpu()
    eps_err = float((eps["cuda"] - eps["cpu"]).abs().max())
    noise = torch.randn((1, 3, 64, 64), generator=gen)
    cpu = _sds_step_record("cpu", noise, "bfloat16")
    card = _sds_step_record("cuda", noise, "bfloat16", cpu)
    print(f"stylize card vs CPU, bf16 tables (not held): phase A 64x64 "
          f"{float((card['img'] - cpu['img']).abs().max()):.3g}, SDS gradient of each device's own image "
          f"{float((card['g'] - cpu['g']).abs().max()):.3g}, of one image "
          f"{float((card['g_same_img'] - cpu['g']).abs().max()):.3g}; loss {card['loss']:.9g} / "
          f"{cpu['loss']:.9g}", flush=True)
    cpu = _sds_step_record("cpu", noise, "float32")
    card = _sds_step_record("cuda", noise, "float32", cpu)
    img_err = float((card["img"] - cpu["img"]).abs().max())
    sds_err = float((card["g_same_img"] - cpu["g"]).abs().max())
    own_err = float((card["g"] - cpu["g"]).abs().max())
    loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    grad_rel = max(float((card["grad"][k] - g).abs().max() / g.abs().max()) for k, g in cpu["grad"].items())
    lr = StylizeConfig().lr
    big_err, any_err = 0.0, 0.0
    for k, g in cpu["grad"].items():
        d = (card["params"][k] - cpu["params"][k]).abs()
        big = g.abs() > 1e-2 * g.abs().max()
        big_err = max(big_err, float(d[big].max()) if big.any() else 0.0)
        any_err = max(any_err, float(d.max()))
    print(f"stylize card vs CPU, f32 tables: toy eps {eps_err:.3g} (atol {EPS_ATOL}) on |eps| up to "
          f"{float(eps['cpu'].abs().max()):.3g}; phase A 64x64 {img_err:.3g} (atol {CARD_VS_CPU_ATOL}); SDS "
          f"gradient of one image {sds_err:.3g} (atol {SDS_ATOL:.3g}), of each device's own image {own_err:.3g} "
          f"(not held), max |g| {float(cpu['g'].abs().max()):.3g}; loss {card['loss']:.9g} / {cpu['loss']:.9g} "
          f"(rel {loss_rel:.3g}, rtol {TRAIN_LOSS_RTOL}); MLP gradients {grad_rel:.3g} x max|g| (tolerance "
          f"{TRAIN_GRAD_REL}); updated MLP parameters {big_err:.3g} where |g| > 1e-2 max|g| (atol 1e-6), "
          f"{any_err:.3g} elsewhere (atol {2 * lr})", flush=True)
    if not (eps_err <= EPS_ATOL and img_err <= CARD_VS_CPU_ATOL and sds_err <= SDS_ATOL):
        raise AssertionError("stylize card vs CPU: the guidance or phase A differ")
    if not (np.isfinite(card["loss"]) and loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_REL):
        raise AssertionError("stylize card vs CPU: phase B differs")
    if not (big_err <= 1e-6 and any_err <= 2 * lr):
        raise AssertionError("stylize card vs CPU: the Adam step differs")


def check_analytic_card_vs_cpu() -> None:
    """A 32x32 frame of the artifact with analytic normals, card and CPU,
    the budget derived on the CPU."""
    pose = bench.bench_poses()[0]
    frames, budget = {}, None
    for device in ("cpu", "cuda"):
        params, fcfg, grid, cfg = bench.load_artifact(device)
        ro, rd = pose2rays(32, 32, pose, device=device)
        if budget is None:
            budget = int(int(count_fast_samples(ro, rd, cfg, grid)) * 1.02)
        cfg = dataclasses.replace(cfg, sample_budget=budget, normal_mode="analytic")
        frames[device] = make_fast_frame_renderer(params, fcfg, cfg, grid, chunk=32 * 32)(ro, rd)["rgb"].cpu()
    err = float((frames["cuda"] - frames["cpu"]).abs().max())
    print(f"32x32 analytic frame, card vs CPU: max abs diff {err:.3g} (atol {CARD_VS_CPU_ATOL})", flush=True)
    if not (torch.isfinite(frames["cuda"]).all() and err <= CARD_VS_CPU_ATOL and (frames["cuda"] < 0.99).any()):
        raise AssertionError(f"analytic frames: card and CPU differ by {err}, or the frame is empty")


def _record_steps(record: list):
    """Wrap MultiPromptTrainer.train_view to append, for each step, its
    epoch, host seconds (ending in a synchronize) and the P losses; returns
    the original to restore."""
    real = MultiPromptTrainer.train_view

    def recorded(self, pose, desc, epoch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = real(self, pose, desc, epoch)
        torch.cuda.synchronize()
        record.append((epoch, time.perf_counter() - t0, losses.cpu()))
        return losses

    MultiPromptTrainer.train_view = recorded
    return real


def check_multi_stylize() -> dict:
    """The port's run_multi_stylize at its defaults (lava, emerald,
    porcelain; 256x256, 4096-ray patches, 192 probes, K = 32, fd4, the
    derived budget) with the toy guidance on the committed artifact, cut to
    MULTI_ARGV: 4 coarse and 2 fine SDS steps. Every loss finite, the three
    fields pairwise different, each final checkpoint loading as the
    trainer's field; the table kernels: P gathers and P reduce-scatters per
    step, plus the ground truth's gather, P for the setup's grid refreshes
    and P for the final save. Then steps timed and one coarse and one fine
    step profiled on the same trainer. Returns the launches of the tool's
    run."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_multi_")
    record = []
    real = _record_steps(record)
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        trainer = run_multi_stylize.main(["--weights_path", bench.ARTIFACT_CKPT, "--toy_weights", TOY_DIR,
                                          "--out", out_dir] + MULTI_ARGV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tool = list(record)
        launches = _read_launches("multi_stylize", [ring.KERNEL, ring.RS_KERNEL])
        P, steps = trainer.P, MULTI_COARSE_STEPS + MULTI_FINE_STEPS
        _expect_launches("multi_stylize", launches, {ring.KERNEL: P * steps + 1 + 2 * P, ring.RS_KERNEL: P * steps})
        epochs = [e for e, _, _ in tool]
        if epochs != [0] * MULTI_COARSE_STEPS + [1] * MULTI_FINE_STEPS:
            raise AssertionError(f"multi_stylize: the steps ran in epochs {epochs}")
        losses = torch.stack([l for _, _, l in tool])
        if losses.shape != (steps, P) or not torch.isfinite(losses).all():
            raise AssertionError(f"multi_stylize: losses {losses}")
        fields = trainer.params_list()
        for i in range(P):
            loaded, _ = load_params_with_config(os.path.join(out_dir, f"multi_{trainer.prompts[i]}_final.pth.tar"),
                                                "cuda")
            if not all(torch.equal(a, b) for a, b in zip(leaves(loaded), leaves(fields[i]))):
                raise AssertionError(f"multi_stylize: the {trainer.prompts[i]} checkpoint does not load as its field")
            if not all(torch.isfinite(t).all() for t in leaves(fields[i])):
                raise AssertionError(f"multi_stylize: non-finite {trainer.prompts[i]} field")
            for j in range(i):
                d = max(float((a - b).abs().max()) for a, b in zip(leaves(_mlp_leaves(fields[i])),
                                                                     leaves(_mlp_leaves(fields[j]))))
                if not d > 0:
                    raise AssertionError(f"multi_stylize: {trainer.prompts[i]} and {trainer.prompts[j]} did not diverge")
        del fields, loaded
        run_peak = torch.cuda.max_memory_allocated() / 2**30
        coarse_s = profile_train.time_stylize_steps(trainer, 0, MULTI_TIMED[0])
        fine_s = profile_train.time_stylize_steps(trainer, trainer.cfg.coarse_epochs, MULTI_TIMED[1])
        coarse_prof = profile_train.profile_stylize_steps(trainer, 0, 1, prefix="multi")
        fine_prof = profile_train.profile_stylize_steps(trainer, trainer.cfg.coarse_epochs, 1, prefix="multi")
        # the tool's own steps after each stage's first (a warm-up) and the timed ones
        coarse = [t for _, t, _ in tool[1:MULTI_COARSE_STEPS]] + coarse_s
        fine = [t for _, t, _ in tool[MULTI_COARSE_STEPS + 1:]] + fine_s
        summary = {
            "card": card_line(),
            "prompts": trainer.prompts,
            "sample_budget": trainer.fast_cfg.sample_budget,
            "tool_wall_s": wall,
            "tool_step_ms": [1e3 * t for _, t, _ in tool],
            "coarse_steps_per_sec": len(coarse) / sum(coarse),
            "coarse_step_ms": [1e3 * t for t in coarse],
            "fine_steps_per_sec": len(fine) / sum(fine),
            "fine_step_ms": [1e3 * t for t in fine],
            "tool_peak_mem_gib": run_peak,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "coarse_profile": coarse_prof,
            "fine_profile": fine_prof,
        }
        print("multi_stylize: " + json.dumps(summary), flush=True)
        for stage, prof in (("coarse", coarse_prof), ("fine", fine_prof)):
            ranges = ", ".join(f"{k} {v:.2f}" for k, v in prof["range_device_ms_per_step"].items())
            print(f"multi_stylize {stage}: {summary[stage + '_steps_per_sec']:.3f} SDS steps/s x {P} prompts; "
                  f"device ms per step: {ranges}; idle share {prof['device_idle_share']:.3f}", flush=True)
        print(f"multi_stylize: peak {summary['peak_mem_gib']:.2f} GiB ({card_line()})", flush=True)
        return launches
    finally:
        MultiPromptTrainer.train_view = real
        shutil.rmtree(out_dir, ignore_errors=True)


def _multi_step_record(device: str, noise: torch.Tensor, cpu: dict | None = None) -> dict:
    """One coarse multi-prompt step of the artifact at P = 2 (64x64 frame,
    one patch, white background, f32 tables) on ``device``, t = MULTI_T and
    ``noise`` injected; with ``cpu`` (the CPU's record) the card's SDS
    gradients are also computed on the CPU's images, and phase B runs on
    the CPU's gradients."""
    params, fcfg, grid, fast = bench.load_artifact(device)
    fcfg = dataclasses.replace(fcfg, packed_dtype="float32")
    toy, tcfg, embs = load_toy_guidance(TOY_DIR, device)
    guide = SDSGuidance(make_toy_modules(toy, tcfg, embs))
    cfg = StylizeConfig(augment_bkg=False, coarse_epochs=1, fine_epochs=0, grid_update_every=0, sampler="fast")
    trainer = MultiPromptTrainer(cfg, fcfg, guide, ["lava", "emerald"], stack_params([params, params]), params,
                                 grids=torch.stack([grid, grid]), fast_cfg=fast)
    rec = {}
    sds = guide.sds_image_grad_batch

    def injected(embs, imgs, gs, pred_depth=None, **kw):
        rec["img"] = imgs.cpu()
        g = sds(embs, imgs, gs, t_override=MULTI_T, noise_override=noise.to(device))
        rec["g"] = g.cpu()
        if cpu is None:
            return g
        rec["g_same_img"] = sds(embs, cpu["img"].to(device), gs, t_override=MULTI_T,
                                noise_override=noise.to(device)).cpu()
        return cpu["g"].to(device)

    guide.sds_image_grad_batch = injected
    poses, descs = trainer.epoch_poses(0)
    i = int(trainer.rng.permutation(len(poses))[0])
    rec["loss"] = trainer.train_view(poses[i], descs[i], 0).cpu()
    rec["grad"], rec["params"] = {}, {}
    for p, (rest, _, _) in enumerate(trainer.fields):
        for k, t in _mlp_leaves(rest).items():
            rec["grad"][(p, k)] = trainer.opt.state[t]["exp_avg"].cpu() / 0.1
            rec["params"][(p, k)] = t.detach().cpu()
    return rec


def check_multi_card_vs_cpu() -> None:
    """One multi-prompt step at P = 2 stage by stage, each stage from the
    same inputs on the card and the CPU, at stylize_card_vs_cpu's bounds:
    phase A within 2e-3, the SDS gradients of one set of images within
    4.02e-3, the losses within 1e-4 relative, the MLP and variance
    gradients within 1e-2 x max|g|, the updated MLP parameters within 1e-6
    where |g| > 1e-2 max|g| and 2 lr elsewhere."""
    noise = torch.randn((2, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    cpu = _multi_step_record("cpu", noise)
    card = _multi_step_record("cuda", noise, cpu)
    img_err = float((card["img"] - cpu["img"]).abs().max())
    sds_err = float((card["g_same_img"] - cpu["g"]).abs().max())
    loss_rel = float(((card["loss"] - cpu["loss"]).abs() / cpu["loss"].abs()).max())
    grad_rel = max(float((card["grad"][k] - g).abs().max() / g.abs().max()) for k, g in cpu["grad"].items())
    lr = StylizeConfig().lr
    big_err, any_err = 0.0, 0.0
    for k, g in cpu["grad"].items():
        d = (card["params"][k] - cpu["params"][k]).abs()
        big = g.abs() > 1e-2 * g.abs().max()
        big_err = max(big_err, float(d[big].max()) if big.any() else 0.0)
        any_err = max(any_err, float(d.max()))
    print(f"multi card vs CPU, P = 2, f32 tables: phase A 64x64 {img_err:.3g} (atol {CARD_VS_CPU_ATOL}); SDS "
          f"gradients of one set of images {sds_err:.3g} (atol {SDS_ATOL:.3g}), max |g| "
          f"{float(cpu['g'].abs().max()):.3g}; losses {card['loss'].tolist()} / {cpu['loss'].tolist()} (rel "
          f"{loss_rel:.3g}, rtol {TRAIN_LOSS_RTOL}); MLP gradients {grad_rel:.3g} x max|g| (tolerance "
          f"{TRAIN_GRAD_REL}); updated MLP parameters {big_err:.3g} where |g| > 1e-2 max|g| (atol 1e-6), "
          f"{any_err:.3g} elsewhere (atol {2 * lr})", flush=True)
    if not (img_err <= CARD_VS_CPU_ATOL and sds_err <= SDS_ATOL):
        raise AssertionError("multi card vs CPU: the guidance or phase A differ")
    if not (torch.isfinite(card["loss"]).all() and loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_REL):
        raise AssertionError("multi card vs CPU: phase B differs")
    if not (big_err <= 1e-6 and any_err <= 2 * lr):
        raise AssertionError("multi card vs CPU: the Adam step differs")


def check_sd_batched_guidance(guidance: SDSGuidance) -> None:
    """SD 1.5's SDS gradients of P = 2 images (the coarse 64x64 frame's
    size, resized to 512) in one batched call against two single calls,
    the same t and noise injected: within SD_BATCH_REL x max|g| (TF32 off;
    cuDNN may pick other algorithms for a batch of 4 than for 2); the
    batched call's ms beside the two single calls' (CUDA events)."""
    gen = torch.Generator("cuda").manual_seed(2)
    imgs = torch.rand((2, 3, 64, 64), generator=gen, device="cuda")
    S = guidance.m.image_size // guidance.m.latent_scale
    noise = torch.randn((2, guidance.m.latent_channels, S, S), generator=gen, device="cuda")
    embs = torch.stack([guidance.get_text_embeds([p]) for p in ("lava", "emerald")])
    t = [SDS_T, 37]

    def batched():
        return guidance.sds_image_grad_batch(embs, imgs, 100.0, t_override=t, noise_override=noise)

    def singles():
        return torch.cat([guidance.sds_image_grad(embs[p], imgs[p : p + 1], 100.0, t_override=t[p],
                                                  noise_override=noise[p : p + 1]) for p in range(2)])

    got, want = batched(), singles()
    rel = float((got - want).abs().max() / want.abs().max())
    batched_ms, singles_ms = cuda_ms(batched, iters=3, warmup=1), cuda_ms(singles, iters=3, warmup=1)
    print(f"sd batched guidance, P = 2: {rel:.3g} x max|g| from two single calls (bound {SD_BATCH_REL:.3g}); "
          f"max |g| {float(want.abs().max()):.3g}; batched call {batched_ms:.2f} ms, two single calls "
          f"{singles_ms:.2f} ms ({card_line()})", flush=True)
    if not (torch.isfinite(got).all() and rel <= SD_BATCH_REL):
        raise AssertionError(f"sd batched guidance differs from single calls by {rel} x max|g|")


def _record_sds(guidance: SDSGuidance, seen: list) -> None:
    """Wrap ``guidance.sds_image_grad`` to keep, for each call, whether its
    gradient is finite, its max |g| and the depth it was given (devices
    read after the step's own synchronize)."""
    sds = guidance.sds_image_grad

    def recorded(emb, img, gs, pred_depth=None, **kw):
        g = sds(emb, img, gs, pred_depth=pred_depth, **kw)
        seen.append((torch.isfinite(g).all(), g.abs().max(), None if pred_depth is None else tuple(pred_depth.shape)))
        return g

    guidance.sds_image_grad = recorded


def _check_sds_seen(path: str, seen: list, n: int, depth=None) -> None:
    if len(seen) != n:
        raise AssertionError(f"{path}: {len(seen)} SDS calls for {n} steps")
    for finite, top, d in seen:
        if not (bool(finite) and float(top) > 0.0 and d == depth):
            raise AssertionError(f"{path}: SDS gradient finite {bool(finite)}, max |g| {float(top)}, depth {d}")


def _sd_steps(trainer, epoch: int, n: int) -> list[float]:
    """Host seconds of n SDS steps of the epoch's schedule, each ending in a
    synchronize; each step's loss and parameter gradients must be finite."""
    secs = []
    for pose, desc in profile_train.stylize_views(trainer, epoch, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_view(pose, desc, epoch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        grads = [t.grad for t in leaves(trainer.rest) + trainer.shards if t.grad is not None]
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        if not (grads and bool(torch.isfinite(loss)) and bool(finite)):
            raise AssertionError(f"SDS step: loss {float(loss)}, {len(grads)} gradients, all finite {bool(finite)}")
    return secs


def check_sd_stylize():
    """SD 1.5 at full width driving the stylize trainer: coarse and fine
    steps; returns (the table kernels' launches, the guidance)."""
    torch.cuda.reset_peak_memory_stats()
    guidance = profile_train.sd_guidance("1.5")
    seen = []
    _record_sds(guidance, seen)
    trainer, _ = profile_train.stylize_trainer(grid_update_every=0, guidance=guidance)
    ucfg = guidance.m.configs["unet"]
    print(f"sd_stylize: SD 1.5 UNet {ucfg.block_out_channels}, {ucfg.attention_head_dim} heads, context "
          f"{ucfg.cross_attention_dim}; image {guidance.m.image_size}; modules on the card, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB with the trainer", flush=True)
    torch.cuda.synchronize()
    _reset_launches()
    summary = {"card": card_line(), "sample_budget": trainer.fast_cfg.sample_budget}
    for stage, epoch, n in (("coarse", 0, SD_COARSE_STEPS), ("fine", trainer.cfg.coarse_epochs, SD_FINE_STEPS)):
        torch.cuda.reset_peak_memory_stats()
        secs = _sd_steps(trainer, epoch, n - 1)
        timed = secs[1:]  # the first step is a warm-up
        prof = profile_train.profile_stylize_steps(trainer, epoch, 1)
        summary[stage] = {
            "steps_per_sec": len(timed) / sum(timed),
            "step_ms": [1e3 * x for x in secs],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            **prof,
        }
    torch.cuda.synchronize()
    launches = _read_launches("sd_stylize", [ring.KERNEL, ring.RS_KERNEL])
    steps = SD_COARSE_STEPS + SD_FINE_STEPS
    _expect_launches("sd_stylize", launches, {ring.KERNEL: steps, ring.RS_KERNEL: steps})
    _check_sds_seen("sd_stylize", seen, steps)
    print("sd_stylize: " + json.dumps(summary), flush=True)
    for stage in ("coarse", "fine"):
        r = summary[stage]
        ranges = ", ".join(f"{k} {v:.2f}" for k, v in r["range_device_ms_per_step"].items())
        print(f"sd_stylize {stage}: {r['steps_per_sec']:.3f} SDS steps/s; device ms per step: {ranges}; idle share "
              f"{r['device_idle_share']:.3f}; peak {r['peak_mem_gib']:.2f} GiB", flush=True)
    return launches, guidance


def check_txt2img(guidance: SDSGuidance) -> None:
    """prompt_to_img at 512x512, PNDM and DDIM, SD_TXT2IMG_STEPS each; the
    UNet calls and the decodes timed one by one (synchronized)."""
    m = guidance.m
    unet_ms, decode_ms = [], []

    def timed(fn, out):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*args)
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
            return r
        return call

    g = SDSGuidance(dataclasses.replace(m, unet=timed(m.unet, unet_ms), vae_decode=timed(m.vae_decode, decode_ms)))
    for scheduler in ("pndm", "ddim"):
        img = g.prompt_to_img("a photo of the hulk", 512, 512, SD_TXT2IMG_STEPS, scheduler=scheduler,
                              generator=torch.Generator("cuda").manual_seed(0))
        if not (isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.shape == (1, 512, 512, 3)):
            raise AssertionError(f"txt2img {scheduler}: {type(img)} {getattr(img, 'dtype', None)} "
                                 f"{getattr(img, 'shape', None)}")
        print(f"txt2img {scheduler}: uint8 {img.shape}, mean {float(img.mean()):.2f}", flush=True)
    side = 512 // m.latent_scale
    print(f"txt2img: {len(unet_ms)} UNet calls (batch 2, {side}x{side} latents), ms each {[round(x, 2) for x in unet_ms]}; "
          f"{len(decode_ms)} decodes to 512x512, ms each {[round(x, 2) for x in decode_ms]}", flush=True)


def check_sd_depth() -> dict:
    """One coarse SDS step of the stylize trainer with SD 2.0-depth at full
    width; the frame's depth [1, 1, 64, 64] reaches the guidance."""
    guidance = profile_train.sd_guidance("2.0")
    seen = []
    _record_sds(guidance, seen)
    trainer, _ = profile_train.stylize_trainer(grid_update_every=0, guidance=guidance)
    torch.cuda.synchronize()
    _reset_launches()
    secs = _sd_steps(trainer, 0, 1)
    launches = _read_launches("sd_depth", [ring.KERNEL, ring.RS_KERNEL])
    _expect_launches("sd_depth", launches, {ring.KERNEL: 1, ring.RS_KERNEL: 1})
    _check_sds_seen("sd_depth", seen, 1, depth=(1, 1, 64, 64))
    print(f"sd_depth: one coarse SDS step conditioned on the frame's depth in {1e3 * secs[0]:.1f} ms, max |g| "
          f"{float(seen[0][1]):.4g}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches


def _palette_targets(gen, n: int, size: int, device) -> tuple:
    """(images [n, size, size, 3], style ids [n]): smooth random colors
    mapped through each row's style palette (the toy guidance's targets)."""
    ids = torch.arange(n, device=device) % 3
    rgb = torch.nn.functional.interpolate(torch.rand((n, 3, size // 8, size // 8), generator=gen, device=device),
                                          size=(size, size), mode="bilinear", align_corners=False)
    rgb = rgb.permute(0, 2, 3, 1)
    return torch.stack([style_map(rgb[i], int(ids[i])) for i in range(n)]), ids


def check_toy_ddpm() -> None:
    params, cfg, embs = load_toy_guidance(TOY_DIR, "cuda")
    params = map_leaves(params, lambda t: t.requires_grad_())
    step = make_toy_train_step(cfg, embs, torch.optim.Adam(leaves(params), lr=1e-4))
    gen = torch.Generator("cuda").manual_seed(0)
    imgs, ids = _palette_targets(gen, TOY_DDPM_BATCH, cfg.image_size, "cuda")
    losses = [step(params, imgs, ids, gen)]  # the first step builds what the rest reuse
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(params, imgs, ids, gen) for _ in range(TOY_DDPM_STEPS - 1)]
    torch.cuda.synchronize()
    rate = (TOY_DDPM_STEPS - 1) / (time.perf_counter() - t0)
    values = [float(l) for l in losses]
    print(f"toy_ddpm: {TOY_DDPM_STEPS} steps at the committed width {cfg.block_out_channels}, batch "
          f"{TOY_DDPM_BATCH} of {cfg.image_size}x{cfg.image_size}: {rate:.2f} steps/s; losses "
          f"{[round(v, 5) for v in values]}", flush=True)
    if not np.isfinite(values).all():
        raise AssertionError(f"toy_ddpm: losses {values}")


def _small_sd(version: str, device: str):
    """(GuidanceModules, trees) of SD_SMALL[version] from a CPU generator
    seeded 1, on ``device``."""
    ucfg, vcfg, tcfg = SD_SMALL[version]
    gen = torch.Generator().manual_seed(1)
    trees = (sd.init_unet_params(gen, ucfg), sd.init_vae_encoder_params(gen, vcfg),
             sd.init_vae_decoder_params(gen, vcfg), sd.init_clip_text_params(gen, tcfg))
    trees = [map_leaves(t, lambda x: x.to(device)) for t in trees]
    return sd.assemble_stable_diffusion_modules(*trees, make_toy_tokenizer(), SD_SMALL[version], SD_SMALL_IMAGE,
                                                use_depth=version == "2.0")


def _rel(card: torch.Tensor, cpu: torch.Tensor) -> float:
    return float((card.cpu() - cpu).abs().max() / cpu.abs().max())


def check_sd_card_vs_cpu() -> None:
    rng = np.random.default_rng(0)
    rows = []  # (what, error, tolerance)
    img = torch.from_numpy(rng.random((1, 3, 64, 64)).astype(np.float32))
    depth = torch.from_numpy((rng.random((1, 1, 64, 64)) * 2 + 1).astype(np.float32))
    lat_side = SD_SMALL_IMAGE // 8
    for version in ("1.5", "2.0"):
        mods = {d: _small_sd(version, d) for d in ("cpu", "cuda")}
        ucfg = SD_SMALL[version][0]
        emb = {d: SDSGuidance(m).get_text_embeds(["a photo of the hulk"]) for d, m in mods.items()}
        rows.append((f"{version} CLIP embeddings", _rel(emb["cuda"], emb["cpu"]), SD_EPS_REL))
        lat = torch.from_numpy(rng.normal(size=(2, ucfg.in_channels, lat_side, lat_side)).astype(np.float32))
        t = torch.tensor([731, 731], dtype=torch.int32)
        with torch.no_grad():
            eps = {d: m.unet(lat.to(d), t.to(d), emb["cpu"].to(d)) for d, m in mods.items()}
        rows.append((f"{version} UNet eps", _rel(eps["cuda"], eps["cpu"]), SD_EPS_REL))
        noise = torch.from_numpy(rng.normal(size=(1, 4, lat_side, lat_side)).astype(np.float32))
        g = {d: SDSGuidance(m).sds_image_grad(emb["cpu"].to(d), img.to(d), 100.0,
                                              pred_depth=depth.to(d) if version == "2.0" else None, t_override=400,
                                              noise_override=noise.to(d)) for d, m in mods.items()}
        rows.append((f"{version} SDS image gradient", _rel(g["cuda"], g["cpu"]), SD_SDS_REL))
        if version == "1.5":
            x0 = torch.from_numpy(rng.normal(size=(1, 4, lat_side, lat_side)).astype(np.float32))
            pndm = {d: SDSGuidance(m).produce_latents(emb["cpu"].to(d), SD_SMALL_IMAGE, SD_SMALL_IMAGE, 2,
                                                      latents=x0.to(d)) for d, m in mods.items()}
            rows.append(("1.5 PNDM latents after 2 steps", _rel(pndm["cuda"], pndm["cpu"]), SD_PNDM_REL))
        del mods

    # one toy DDPM step from the committed weights, the draws injected
    gen = torch.Generator().manual_seed(2)
    imgs, ids = _palette_targets(gen, 8, 64, "cpu")
    draws = {"t": torch.randint(0, 1000, (8,), generator=gen), "noise": torch.randn((8, 3, 64, 64), generator=gen),
             "drop": torch.rand((8,), generator=gen) < 0.5}
    out = {}
    for d in ("cpu", "cuda"):
        params, cfg, embs = load_toy_guidance(TOY_DIR, d)
        params = map_leaves(params, lambda t: t.requires_grad_())
        loss = make_ddpm_loss(cfg, embs, uncond_dropout=0.5)(params, imgs.to(d), ids.to(d),
                                                             **{k: v.to(d) for k, v in draws.items()})
        loss.backward()
        out[d] = (float(loss.detach()), [t.grad.cpu() for t in leaves(params)])
    (loss_card, g_card), (loss_cpu, g_cpu) = out["cuda"], out["cpu"]
    floor = DDPM_GRAD_FLOOR * max(float(g.abs().max()) for g in g_cpu)
    # each leaf's largest difference over its bound DDPM_GRAD_REL max|g_leaf| + floor
    grad_ratio = max(float((a - b).abs().max() / (DDPM_GRAD_REL * b.abs().max() + floor)) for a, b in zip(g_card, g_cpu))
    grad_rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_card, g_cpu) if b.abs().max() > 0)
    rows.append(("toy DDPM loss (relative)", abs(loss_card - loss_cpu) / abs(loss_cpu), DDPM_LOSS_RTOL))
    rows.append(("toy DDPM gradients, the worst leaf's difference over its bound", grad_ratio, 1.0))
    for what, err, tol in rows:
        print(f"sd card vs CPU: {what} {err:.3g} (tolerance {tol:.3g})", flush=True)
    print(f"sd card vs CPU: toy DDPM loss {loss_card:.9g} / {loss_cpu:.9g}; worst gradient leaf "
          f"{grad_rel:.3g} x its max|g|", flush=True)
    bad = [what for what, err, tol in rows if not err <= tol]
    if bad:
        raise AssertionError(f"sd card vs CPU: outside tolerance: {bad}")


# -- reconstruct ---------------------------------------------------------------

_CAPTURE_TO_GL = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def write_recon_dataset(root: str) -> None:
    """transforms_train.json and train/r_{i}.png in smpl_da_512's layout:
    RECON_VIEWS views at RECON_RES^2 around the body at the canonical
    training distance (an orbit, elevations between -20 and 35 degrees),
    rendered from the committed artifact by the port's fast renderer on a
    black background (so the loader's mask, any channel != 0, is the
    body), at a zero-clip budget. Stored flipped left to right: the loader
    flips every image back (the reference's flip)."""
    params, fcfg, grid, cfg = bench.load_artifact("cuda")
    f = CANONICAL_ZOOM_FACTOR * RECON_RES
    K = np.array([[f, 0, RECON_RES / 2], [0, f, RECON_RES / 2], [0, 0, 1]], np.float32)
    poses = [
        (pose_spherical(360.0 * i / RECON_VIEWS, 27.5 * np.sin(0.7 * i) + 7.5, CANONICAL_CAMERA_DIST_TRAIN)
         @ _CAPTURE_TO_GL).astype(np.float32)
        for i in range(RECON_VIEWS)
    ]
    rays = [dataset_rays(p, K, RECON_RES, RECON_RES, device="cuda") for p in poses]
    chunks = [(ro[i : i + RECON_RENDER_CHUNK], rd[i : i + RECON_RENDER_CHUNK])
              for ro, rd in rays for i in range(0, len(ro), RECON_RENDER_CHUNK)]
    worst, budget = bench.derive_budget(chunks, cfg, grid)
    render = make_fast_frame_renderer(params, fcfg, dataclasses.replace(cfg, sample_budget=budget), grid,
                                      chunk=RECON_RENDER_CHUNK, bg_color=0.0)
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    frames, covered = [], []
    for i, (ro, rd) in enumerate(rays):
        img = integerify_img(render(ro, rd)["rgb"].reshape(RECON_RES, RECON_RES, 3).cpu().numpy())
        covered.append(float((img != 0).any(-1).mean()))
        write_png(os.path.join(root, "train", f"r_{i}.png"), img[:, ::-1])
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": poses[i].tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as fp:
        json.dump({"camera_angle_x": float(2 * np.arctan(0.5 * RECON_RES / f)), "frames": frames}, fp)
    print(f"reconstruct dataset: {RECON_VIEWS} views at {RECON_RES}x{RECON_RES} in {root}, budget {budget} "
          f"(worst {worst}); body covers {min(covered):.3f} to {max(covered):.3f} of a view", flush=True)
    if min(covered) < 0.01:
        raise AssertionError("reconstruct dataset: a view shows no body")


@contextlib.contextmanager
def _recorded_trainers(fast_kw: dict):
    """The CLI's trainers, wrapped: every loss logged, ``fast_kw`` passed to
    train_fast, and after each step's callback a synchronize and a record
    of (step, host time, the grid's max and finiteness)."""
    record = []
    real = {"train": reconstruct.train, "train_fast": reconstruct.train_fast}

    def wrap(fn, extra):
        def wrapped(*args, callbacks=None, **kw):
            inner = callbacks["on_step"]

            def on_step(step, params, loss, *grid):
                inner(step, params, loss, *grid)
                torch.cuda.synchronize()
                g = grid[0] if grid else None
                record.append((step, time.perf_counter(), None if g is None else
                               (float(g.max()), bool(torch.isfinite(g).all()))))

            return fn(*args, callbacks={"on_step": on_step}, **{**kw, "log_every": 1, **extra})

        return wrapped

    reconstruct.train = wrap(real["train"], {})
    reconstruct.train_fast = wrap(real["train_fast"], fast_kw)
    try:
        yield record
    finally:
        reconstruct.train, reconstruct.train_fast = real["train"], real["train_fast"]


def _rate(record, batch: int) -> dict:
    """Steps/s and rays/s from the median host time between two steps'
    callbacks (the steps that save, render or refresh are the slow tail)."""
    dts = np.diff([t for _, t, _ in record])
    ms = float(np.median(dts)) * 1e3
    return {"ms_per_step_median": ms, "steps_per_sec": 1e3 / ms, "rays_per_sec": batch * 1e3 / ms,
            "ms_per_step_max": float(dts.max()) * 1e3}


def _run_recon_cli(argv: list, fast_kw: dict, name: str):
    with _recorded_trainers(fast_kw) as record:
        _reset_launches()
        params, stats = reconstruct_cli.main(argv)
        torch.cuda.synchronize()
    launches = dict(ring.launches)
    losses = [l for _, l in stats["losses"]]
    rate = _rate(record, int(argv[argv.index("--batch_size") + 1]))
    print(f"reconstruct {name}: " + json.dumps({**{k: v for k, v in stats.items() if k != "losses"}, **rate,
                                                "launches": launches}), flush=True)
    print(f"reconstruct {name} losses: " + json.dumps([round(l, 6) for l in losses]), flush=True)
    if not np.isfinite(losses).all():
        raise AssertionError(f"reconstruct {name}: a loss is not finite")
    return params, stats, record, launches, losses


def _expect_files(exp_dir: str, names) -> None:
    missing = [n for n in names if not os.path.isfile(os.path.join(exp_dir, n))]
    if missing:
        raise AssertionError(f"reconstruct: not written: {missing} (in {sorted(os.listdir(exp_dir))})")


def _expect_checkpoint(path: str, params: dict) -> None:
    loaded, _ = load_params_with_config(path, "cuda")
    if not all(torch.equal(a, b) for a, b in zip(leaves(loaded), leaves(params))):
        raise AssertionError(f"reconstruct: {path} does not load back equal to the trainer's parameters")


def _parity_step_grads(device: str, ckpt: str, ds, pix: np.ndarray):
    """One 64+64 step of the checkpoint's hash-grid field (no perturbation)
    on the rays of ``pix`` in view 0: (loss, {leaf: gradient})."""
    params, fcfg = load_params_with_config(ckpt, device)
    params = map_leaves(params, lambda t: t.requires_grad_())
    ray_fn = reconstruct.make_batch_ray_fn(ds.K, ds.H, ds.W)
    pi = torch.as_tensor(pix, device=device)
    ro, rd = ray_fn(torch.as_tensor(ds.poses, device=device), torch.zeros_like(pi), pi)
    gt = torch.as_tensor(ds.gather_rgb(np.zeros_like(pix), pix), device=device)
    rcfg = RenderConfig(num_steps=64, upsample_steps=64, bound=NSR_BOUND, perturb=False)
    out = render_rays(params, ro, rd, fcfg, rcfg, 1.0)
    loss = reconstruct.smooth_l1(out["rgb"], gt) + 0.1 * out["gradient_error"]
    loss.backward()
    loss = loss.detach()
    grads = {"table": params["table"].grad.cpu(), "variance": params["variance"].grad.cpu()}
    grads.update({f"{name}.{i}.{k}": t.grad.cpu() for name in ("sdf", "color")
                  for i, layer in enumerate(params[name]) for k, t in layer.items()})
    return float(loss), grads


def check_hash_card_vs_cpu(ckpt: str, ds) -> None:
    y, x = np.mgrid[240:272, 240:272]
    pix = (y * ds.W + x).reshape(-1).astype(np.int64)
    loss_cpu, g_cpu = _parity_step_grads("cpu", ckpt, ds, pix)
    loss_card, g_card = _parity_step_grads("cuda", ckpt, ds, pix)
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    errs = {k: float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max()) for k in g_cpu
            if float(g_cpu[k].abs().max()) > 0}
    print(f"hash-grid parity step, card vs CPU (32x32 rays): loss {loss_card:.9g} / {loss_cpu:.9g} (rel {rel:.3g}, "
          f"rtol {TRAIN_LOSS_RTOL}); table gradient diff {errs['table']:.3g} x max|g| "
          f"{float(g_cpu['table'].abs().max()):.4g}, worst MLP/variance {max(v for k, v in errs.items() if k != 'table'):.3g} "
          f"x max|g| (tolerance {HASH_GRAD_REL})", flush=True)
    if not (np.isfinite(loss_card) and rel <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"hash-grid parity step: losses differ, card {loss_card}, cpu {loss_cpu}")
    if "table" not in errs or not max(errs.values()) <= HASH_GRAD_REL:
        raise AssertionError(f"hash-grid parity step: gradients differ: {errs}")


def _sorted_vertices(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v[np.lexsort(v.T[::-1])]


def time_mesh_export() -> None:
    """The CLI's mesh export at its default 512^3 (``extract_geometry``),
    timed once on the artifact's field, which has a surface: the SDF
    lattice on the card, then the native extractor on the host. At 128^3
    the native extractor is held against the numpy plain version on the
    artifact's lattice: the same triangle count, the same vertices after
    sorting within 1e-4 (the two emit them in other orders); both timed."""
    params, fcfg, _, _ = bench.load_artifact("cuda")
    t0 = time.perf_counter()
    sdf = extract_sdf_grid(params, fcfg, NSR_BOUND, RECON_MESH_EXPORT_RES)
    t1 = time.perf_counter()
    verts, faces = mc.marching_cubes(-sdf, 0.0)
    t2 = time.perf_counter()
    print(f"mesh export at {RECON_MESH_EXPORT_RES}^3 of the artifact's field: SDF lattice {t1 - t0:.2f} s, "
          f"native marching cubes {t2 - t1:.3f} s ({os.cpu_count()} host cores), {len(verts)} vertices, "
          f"{len(faces)} faces ({card_line()})", flush=True)
    if not len(faces):
        raise AssertionError("mesh export: no surface in the artifact's field")
    u = -extract_sdf_grid(params, fcfg, NSR_BOUND, RECON_MESH_RES)
    t0 = time.perf_counter()
    nv, nt = mc.marching_cubes(u, 0.0)
    t1 = time.perf_counter()
    pv, pt = mc.marching_cubes(u, 0.0, prefer_native=False)
    t2 = time.perf_counter()
    err = (float(np.abs(_sorted_vertices(nv) - _sorted_vertices(pv)).max())
           if len(nv) == len(pv) and len(nv) else float("inf"))
    print(f"marching cubes at {RECON_MESH_RES}^3, native against numpy: {len(nt)} / {len(pt)} triangles, "
          f"{len(nv)} / {len(pv)} vertices, sorted vertices within {err:.3g} (atol 1e-4); native "
          f"{t1 - t0:.4f} s, numpy {t2 - t1:.3f} s", flush=True)
    if not (len(nt) == len(pt) > 0 and err <= 1e-4):
        raise AssertionError("marching cubes: the native extractor and the numpy version differ")


def check_reconstruct(root: str) -> dict:
    """reconstruct_cli at its defaults on a dataset written from the
    artifact into ``root``: the parity sampler (the hash grid, 64+64, fd7,
    batch 1600) and the fast sampler (the pyramid, fd4, 128 probes) for
    RECON_STEPS steps each, the fast one resumed from its state; the
    hash-grid step card against CPU; the parity step's device ms per
    train.* range. The dataset and the parity run's checkpoint
    (``recon_parity_checkpoint``) stay in ``root`` for the parity phases."""
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    write_recon_dataset(root)
    out = os.path.join(root, "out")
    # --white_bkg false: the set is black-backed, as smpl_da_512 is, and the
    # raw images against renders on white are the inconsistent supervision
    # the JAX package's ReconstructConfig names
    base = ["--data_path", root, "--out_dir", out, "--batch_size", "1600", "--mesh_resolution", str(RECON_MESH_RES),
            "--white_bkg", "false"]
    each = str(RECON_STEPS)

    # the parity sampler: no table kernel
    params, stats, _, launches, losses = _run_recon_cli(
        base + ["--exp_name", "parity", "--max_steps", each, "--i_val", each, "--i_save", each, "--i_mesh", each],
        {}, "parity")
    if any(launches.values()):
        raise AssertionError(f"reconstruct parity: table kernels launched: {launches}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if len(losses) != RECON_STEPS or not last < first:
        raise AssertionError(f"reconstruct parity: {len(losses)} losses, mean of the first 5 {first}, last 5 {last}")
    exp = os.path.join(out, "parity")
    _expect_files(exp, [f"parity_{RECON_STEPS:04d}.png", f"parity_{RECON_STEPS:04d}.pth.tar",
                        f"parity_{RECON_STEPS:04d}.ply", "parity_final.pth.tar"])
    for name in (f"parity_{RECON_STEPS:04d}.pth.tar", "parity_final.pth.tar"):
        _expect_checkpoint(os.path.join(exp, name), params)
    print(f"reconstruct parity: mean loss of the first 5 steps {first:.6f}, last 5 {last:.6f}", flush=True)

    # the fast sampler: one gather and one reduce-scatter per step, and a
    # gather for each refresh, state save, read of the parameters by the
    # CLI's callbacks (validation render, save, mesh) and the final tree
    fast_argv = base + ["--sampler", "fast", "--grid_warmup_steps", str(RECON_FAST_REFRESH),
                        "--save_state_every", str(RECON_FAST_REFRESH)]
    params, stats, record, launches, losses = _run_recon_cli(
        fast_argv + ["--exp_name", "fast", "--max_steps", each, "--i_val", each, "--i_save", each, "--i_mesh", each],
        {"grid_update_every": RECON_FAST_REFRESH}, "fast")
    refreshes = saves = RECON_STEPS // RECON_FAST_REFRESH
    _expect_launches("reconstruct fast", launches, {ring.KERNEL: RECON_STEPS + refreshes + saves + 3 + 1,
                                                    ring.RS_KERNEL: RECON_STEPS})
    grid_max, grid_finite = record[RECON_FAST_REFRESH - 1][2]
    if not (grid_finite and grid_max < 100.0):
        raise AssertionError(f"reconstruct fast: the grid after the refresh at step {RECON_FAST_REFRESH}: "
                             f"max {grid_max}, finite {grid_finite}")
    exp = os.path.join(out, "fast")
    _expect_files(exp, [f"fast_{RECON_STEPS:04d}.png", f"fast_{RECON_STEPS:04d}.pth.tar", f"fast_{RECON_STEPS:04d}.ply",
                        "fast_final.pth.tar", "fast_grid.npy", "state_latest.pt", "state_final.pt"])
    _expect_checkpoint(os.path.join(exp, "fast_final.pth.tar"), params)
    print(f"reconstruct fast: grid after the refresh at step {RECON_FAST_REFRESH}: max {grid_max:.4g}; "
          f"mean loss of the first 5 steps {np.mean(losses[:5]):.6f}, steps 15-19 {np.mean(losses[15:20]):.6f}",
          flush=True)
    counts = dict(launches)

    # a resume from the fast run's state at step RECON_STEPS
    end = str(RECON_STEPS + RECON_RESUME_STEPS)
    params, stats, _, launches, losses = _run_recon_cli(
        fast_argv + ["--exp_name", "fast_resume", "--max_steps", end, "--i_val", "100000", "--i_save", "100000",
                     "--i_mesh", "100000", "--resume_from", os.path.join(exp, "state_latest.pt")],
        {"grid_update_every": RECON_FAST_REFRESH}, "fast resumed")
    _expect_launches("reconstruct fast resumed", launches, {ring.KERNEL: RECON_RESUME_STEPS + 1,
                                                            ring.RS_KERNEL: RECON_RESUME_STEPS})
    if stats["steps"] != RECON_STEPS + RECON_RESUME_STEPS or len(losses) != RECON_RESUME_STEPS:
        raise AssertionError(f"reconstruct fast resumed: {stats['steps']} steps, {len(losses)} losses")
    for k in counts:
        counts[k] += launches[k]

    ds = SMPLMultiviewDataset(root)
    check_hash_card_vs_cpu(os.path.join(out, "parity", "parity_final.pth.tar"), ds)
    prof = profile_train.parity_main(warmup=2, timed=6, profiled=2, print_json=False)
    print("reconstruct parity step (profile_train --path parity): " + json.dumps(
        {k: v for k, v in prof.items() if k != "top_kernels"}), flush=True)
    print("reconstruct parity step top kernels: " + json.dumps(prof["top_kernels"]), flush=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"reconstruct: peak memory {peak / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB held when the phase began", flush=True)
    time_mesh_export()
    # the resume's train-state files (about 0.9 GB each); the fast run's stay for the tools phase
    shutil.rmtree(os.path.join(out, "fast_resume"), ignore_errors=True)
    return counts


def _scan_state(ds, device: str = "cuda"):
    """A fresh fast trainer at the CLI's defaults on ``ds``: (rest, shards,
    splice, Adam, schedule, field config, fast config)."""
    fcfg = instant_nsr.FieldConfig(encoder="tpu_pyramid")
    fast_cfg = FastRenderConfig(normal_mode="fd4")
    cfg = reconstruct.ReconstructConfig(white_bkg=False)
    params = instant_nsr.init_field_params(torch.Generator(device).manual_seed(cfg.seed), fcfg)
    rest, shards, splice = trainable_shards(params)
    opt, sched = reconstruct.make_optimizer(cfg, ds.n_images * ds.H * ds.W // cfg.batch_size, leaves(rest) + shards)
    return rest, shards, splice, opt, sched, fcfg, fast_cfg, cfg


def check_scan_graph_vs_eager(ds) -> dict:
    """make_train_scan_fast on the card, graphed and eager (``graph=False``,
    the same capturable step taken step by step), from two equal fresh
    trainers, over calls of RECON_SCAN_STEPS, RECON_SCAN_STEPS and a tail:
    the losses, every parameter and Adam's moments bitwise equal; each
    launches one gather and one reduce-scatter a step (the graph's replays
    counted). The graphed run's first step ran under sync debug mode
    "error" (``reconstruct.capture_step``). Returns the ms per step of each."""
    rng = np.random.default_rng(0)
    sizes = [RECON_SCAN_STEPS, RECON_SCAN_STEPS, RECON_SCAN_TAIL]
    n_steps = sum(sizes)
    batches = list(reconstruct.pixel_batches(ds.n_images, ds.H * ds.W, 1600, rng))[:n_steps]
    images = torch.as_tensor(np.asarray(ds.images, np.float32).reshape(ds.n_images, -1, 3), device="cuda")
    poses = torch.as_tensor(np.asarray(ds.poses, np.float32), device="cuda")
    runs = {}
    for graph in (True, False):
        rest, shards, splice, opt, sched, fcfg, fast_cfg, cfg = _scan_state(ds)
        scan = reconstruct.make_train_scan_fast(fcfg, fast_cfg, opt, reconstruct.make_batch_ray_fn(ds.K, ds.H, ds.W),
                                                cfg.eikonal_weight, cfg.bkg_mode, cfg.white_bkg, splice, graph=graph)
        grid, masks = torch.full((129,) * 3, 100.0, device="cuda"), torch.zeros((1, 1), device="cuda")
        _reset_launches()
        losses, secs, start = [], [], 0
        for n in sizes:
            chunk = batches[start : start + n]
            start += n
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = scan(rest, shards, poses, images, masks, np.stack([v for v, _ in chunk]),
                       np.stack([p for _, p in chunk]), sched.advance(n), grid)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(out)
        _expect_launches(f"scan {'graphed' if graph else 'eager'}", dict(ring.launches),
                         {ring.KERNEL: n_steps, ring.RS_KERNEL: n_steps})
        tensors = leaves(rest) + shards
        runs[graph] = {"losses": torch.cat(losses), "tensors": tensors,
                       "moments": [opt.state[t][k] for t in tensors for k in ("exp_avg", "exp_avg_sq")],
                       # the calls after the first (which holds the capture): ms per step
                       "ms_per_step": 1e3 * sum(secs[1:]) / sum(sizes[1:])}
    graphed, eager = runs[True], runs[False]
    same = (torch.equal(graphed["losses"], eager["losses"])
            and all(torch.equal(a, b) for a, b in zip(graphed["tensors"], eager["tensors"]))
            and all(torch.equal(a, b) for a, b in zip(graphed["moments"], eager["moments"])))
    print(f"scan graphed vs eager ({'+'.join(map(str, sizes))} steps, the CLI's defaults, batch 1600): losses, "
          f"parameters and Adam's moments bitwise equal: {same}; ms per step graphed "
          f"{graphed['ms_per_step']:.3f}, eager {eager['ms_per_step']:.3f} ({card_line()}); the graphed first step "
          f"ran under sync debug mode 'error'", flush=True)
    if not same:
        worst = max(float((a - b).abs().max()) for a, b in zip(graphed["tensors"], eager["tensors"]))
        raise AssertionError(f"scan: the graphed steps differ from the eager ones (worst parameter {worst})")
    return {"graphed_ms_per_step": graphed["ms_per_step"], "eager_ms_per_step": eager["ms_per_step"]}


def check_reconstruct_scan(root: str) -> dict:
    """reconstruct_cli --sampler fast --scan_steps RECON_SCAN_STEPS for
    RECON_SCAN_MAX steps on the reconstruct phase's set (calls of 5 and a
    tail of 3; refreshes and state saves every RECON_FAST_REFRESH, which 5
    divides, so they fall on the steps of a per-step run): one gather and
    one reduce-scatter a step, the graph's replays counted, plus a gather a
    refresh, state save and the final tree, exactly; the per-call losses
    within TRAIN_LOSS_RTOL of the same run with --scan_steps 0; steps/s of
    both; then the graphed scan against the eager one, bitwise."""
    out = os.path.join(root, "out")
    every = str(RECON_FAST_REFRESH)
    argv = ["--data_path", root, "--out_dir", out, "--batch_size", "1600", "--white_bkg", "false", "--sampler",
            "fast", "--grid_warmup_steps", every, "--save_state_every", every, "--max_steps", str(RECON_SCAN_MAX),
            "--i_val", "100000", "--i_save", "100000", "--i_mesh", "100000"]
    runs = {}
    for name, scan_steps in (("fast_scan", RECON_SCAN_STEPS), ("fast_steps", 0)):
        with _recorded_trainers({"grid_update_every": RECON_FAST_REFRESH}) as record:
            _reset_launches()
            t0 = time.perf_counter()
            _, stats = reconstruct_cli.main(argv + ["--exp_name", name, "--scan_steps", str(scan_steps)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs[name] = {"stats": stats, "launches": dict(ring.launches), "record": record, "wall": wall}
        per_call = np.median(np.diff([t for _, t, _ in record])) / max(scan_steps, 1)
        print(f"reconstruct {name}: " + json.dumps({
            "steps": stats["steps"], "steps_per_sec": stats.get("steps_per_sec"),
            "ms_per_step_median": 1e3 * float(per_call), "cli_wall_s": wall, "launches": runs[name]["launches"],
            "grid_max_by_callback": [(s, g[0]) for s, _, g in record]}) + f" ({card_line()})", flush=True)
        shutil.rmtree(os.path.join(out, name), ignore_errors=True)  # its train-state files (about 0.9 GB each)
    scan, steps = runs["fast_scan"], runs["fast_steps"]
    refreshes = saves = RECON_SCAN_MAX // RECON_FAST_REFRESH
    for name in runs:
        _expect_launches(f"reconstruct {name}", runs[name]["launches"],
                         {ring.KERNEL: RECON_SCAN_MAX + refreshes + saves + 1, ring.RS_KERNEL: RECON_SCAN_MAX})
    ends = [s for s, _ in scan["stats"]["losses"]]
    want_ends = list(range(RECON_SCAN_STEPS, RECON_SCAN_MAX, RECON_SCAN_STEPS)) + [RECON_SCAN_MAX]
    if ends != want_ends:
        raise AssertionError(f"reconstruct fast_scan: losses logged at {ends}, expected {want_ends}")
    per_step = dict(steps["stats"]["losses"])
    pairs = [(l, per_step[s - 1]) for s, l in scan["stats"]["losses"]]
    rel = max(abs(a - b) / abs(b) for a, b in pairs)
    print(f"reconstruct scan vs per-step losses at the call ends: worst relative difference {rel:.3g} (rtol "
          f"{TRAIN_LOSS_RTOL}), bitwise {all(a == b for a, b in pairs)}: {json.dumps(pairs)}", flush=True)
    if not (np.isfinite([a for a, _ in pairs]).all() and rel <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"reconstruct fast_scan: the losses differ from the per-step run's: {pairs}")
    # the refreshes at the same steps: the grid below the saturated 100 from step RECON_FAST_REFRESH on
    for name, record in (("fast_scan", scan["record"]), ("fast_steps", steps["record"])):
        after = [s for s, _, g in record if g[0] < 100.0]
        first = after[0] + (0 if name == "fast_scan" else 1)
        if first != RECON_FAST_REFRESH:
            raise AssertionError(f"reconstruct {name}: the first refresh after step {first}")
    timing = check_scan_graph_vs_eager(SMPLMultiviewDataset(root))
    print("reconstruct_scan: " + json.dumps({
        "scan_steps_per_sec": scan["stats"].get("steps_per_sec"), "per_step_steps_per_sec":
        steps["stats"].get("steps_per_sec"), **timing}) + f" ({card_line()})", flush=True)
    return scan["launches"]


def _timed_tool(secs: dict, name: str, main, argv: list):
    """A tool's main on ``argv``, its wall seconds printed and kept."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = main(argv)
    torch.cuda.synchronize()
    secs[name] = time.perf_counter() - t0
    print(f"tools {name}: {secs[name]:.2f} s", flush=True)
    return result


def _black_psnr(ds, views, level: int) -> dict:
    """{view: PSNR of an all-black image} against eval_psnr's raw ground
    truth at ``level`` (its pixel rows and columns)."""
    side = ds.H // level
    ys = np.round(np.linspace(0, ds.H - 1, side)).astype(int)
    xs = np.round(np.linspace(0, ds.W - 1, side)).astype(int)
    return {v: -10.0 * np.log10(max(float(np.mean(ds.images[v][np.ix_(ys, xs)] ** 2)), 1e-12)) for v in views}


def _hold_repacked_delta(repacked: str, committed: str, base: dict) -> str:
    """The lava delta unpacked and packed again against the committed one.
    A sparse leaf keeps the committed rows but those whose fp16 differences
    are all zero (the styled field equals the base there, so pack cannot
    see them), with its values bitwise; a dense leaf within one f32 ulp of
    the larger of |base + delta| and |delta| (the rounded sum, then the
    difference); the grid bitwise; meta_json equal but for the dropped
    rows' counts. Returns a line of what it found."""
    new, old = np.load(repacked), np.load(committed)
    if sorted(new.files) != sorted(old.files):
        raise AssertionError(f"repacked delta: arrays {sorted(new.files)} against {sorted(old.files)}")
    base_leaves = [t.detach().cpu().numpy() for t in sorted_leaves(base)]
    meta_new, meta_old = (json.loads(bytes(z["meta_json"]).decode()) for z in (new, old))
    dropped, dense_ulps = {}, 0.0
    for key in old.files:
        kind, _, leaf = key.partition(":")
        if kind == "idx":
            i = int(leaf)
            keep = np.isin(old[key], new[key])
            if not (np.isin(new[key], old[key]).all() and np.array_equal(old[key][keep], new[key])
                    and np.array_equal(old[f"val:{i}"][keep], new[f"val:{i}"])
                    and not old[f"val:{i}"][~keep].any()):
                raise AssertionError(f"repacked delta: leaf {i}'s rows or values differ beyond the all-zero rows")
            dropped[i] = int((~keep).sum())
        elif kind == "dense":
            b, d = base_leaves[int(leaf)], old[key]
            ulps = np.abs(new[key] - d) / np.spacing(np.maximum(np.abs(b + d), np.abs(d)))
            dense_ulps = max(dense_ulps, float(ulps.max()))
        elif kind == "grid" and not np.array_equal(new[key], old[key]):
            raise AssertionError("repacked delta: the grid differs")
    if dense_ulps > 1.0:
        raise AssertionError(f"repacked delta: a dense leaf {dense_ulps} f32 ulps from the committed delta")
    for t in meta_old["tensors"]:
        if t["mode"] == "sparse_rows":
            t["rows_changed"] -= dropped[t["leaf"]]
    if meta_new != meta_old:
        raise AssertionError("repacked delta: meta_json differs beyond the dropped rows' counts")
    return (f"sparse rows and values bitwise but {sum(dropped.values())} committed rows whose fp16 values are all "
            f"zero; dense leaves within {dense_ulps:.3g} f32 ulp; grid bitwise; meta_json equal but those counts")


def check_tools(root: str) -> dict:
    """The offline tools' twins on the card, on the reconstruct phase's set
    and files (``root``): eval_psnr of the committed artifact (which
    rendered the set) at TOOLS_LEVEL on TOOLS_VIEWS against the raw images,
    every view above TOOLS_ARTIFACT_PSNR_FLOOR, with band statistics; of
    the fast run's train state (step 40): finite, its mean above an
    all-black image's, and the same numbers from its final checkpoint and
    grid (the same field); bake_artifact of that state, whose fp16 artifact comes within
    TOOLS_BAKE_PSNR_MARGIN dB of the state; prune_grid of the artifact on
    the card against the CPU, the counts within TOOLS_PRUNE_SHARE; the lava
    delta unpacked and packed again (``_hold_repacked_delta``); eval_style
    of the unpacked lava field with its grid and the toy guidance at
    128x128 over 4 views: the styled field nearer its target than the bare
    one, beside the committed record. One gather a rendered view, counted
    exactly. The fast run's files stay for the finetune phase."""
    fast = os.path.join(root, "out", "fast")
    work = tempfile.mkdtemp(prefix="tools_", dir=root)
    secs = {}
    _reset_launches()
    views = [int(v) for v in TOOLS_VIEWS.split(",")]
    psnr_argv = ["--data_path", root, "--views", TOOLS_VIEWS, "--level", str(TOOLS_LEVEL), "--gt_mode", "raw"]
    art = _timed_tool(secs, "eval_psnr artifact", eval_psnr.main,
                      ["--ckpt", bench.ARTIFACT_CKPT, "--grid_path", bench.ARTIFACT_GRID, "--band_stats"] + psnr_argv)
    if not min(art["psnr"].values()) >= TOOLS_ARTIFACT_PSNR_FLOOR:
        raise AssertionError(f"tools: the artifact's PSNR on its own renders {art['psnr']} below "
                             f"{TOOLS_ARTIFACT_PSNR_FLOOR} dB")
    state_path = os.path.join(fast, "state_latest.pt")
    state = _timed_tool(secs, "eval_psnr state", eval_psnr.main, ["--state", state_path] + psnr_argv)
    black = _black_psnr(SMPLMultiviewDataset(root), views, TOOLS_LEVEL)
    print(f"tools: PSNR of an all-black image {json.dumps(black)}", flush=True)
    black_mean = float(np.mean(list(black.values())))
    if state["step"] != RECON_STEPS or not (np.isfinite(list(state["psnr"].values())).all()
                                            and state["mean_psnr"] > black_mean):
        raise AssertionError(f"tools: the fast run's state at step {state['step']}: PSNR {state['psnr']}, "
                             f"an all-black image {black}")
    final = _timed_tool(secs, "eval_psnr final checkpoint", eval_psnr.main,
                        ["--ckpt", os.path.join(fast, "fast_final.pth.tar"), "--grid_path",
                         os.path.join(fast, "fast_grid.npy")] + psnr_argv)
    if final["psnr"] != state["psnr"]:
        raise AssertionError(f"tools: the final checkpoint's PSNR {final['psnr']} is not its state's {state['psnr']}")
    psnr_json = os.path.join(work, "psnr.json")
    with open(psnr_json, "w") as fp:
        json.dump(state, fp)
    baked = os.path.join(work, "baked")
    bake = _timed_tool(secs, "bake_artifact", bake_artifact.main,
                       ["--state", state_path, "--out", baked, "--normal_mode", "fd4", "--psnr_json", psnr_json])
    baked_psnr = _timed_tool(secs, "eval_psnr baked", eval_psnr.main,
                             ["--ckpt", os.path.join(baked, "bare_smpl_tpu.pth.tar"), "--grid_path",
                              os.path.join(baked, "grid.npy")] + psnr_argv)
    gap = max(abs(baked_psnr["psnr"][v] - state["psnr"][v]) for v in views)
    print(f"tools eval_psnr ({card_line()}): the artifact on its own renders {json.dumps(art)}; the fast run's "
          f"state (step {state['step']}) {json.dumps(state['psnr'])}, its final checkpoint the same; baked with "
          f"fp16 tables ({json.dumps(bake['bytes'])}) {json.dumps(baked_psnr['psnr'])}, at most {gap:.3g} dB "
          f"from the state (margin {TOOLS_BAKE_PSNR_MARGIN})", flush=True)
    if not gap <= TOOLS_BAKE_PSNR_MARGIN:
        raise AssertionError(f"tools: the baked artifact {gap} dB from its state")

    pruned = {}
    for device in ("cuda", "cpu"):
        pruned[device] = _timed_tool(secs, f"prune_grid {device}", prune_grid.main,
                                     ["--ckpt", bench.ARTIFACT_CKPT, "--out", os.path.join(work, f"pruned_{device}.npy")]
                                     + (["--platform", "cpu"] if device == "cpu" else []))
    for key in ("occupied", "kept"):
        card, cpu = pruned["cuda"][key], pruned["cpu"][key]
        if not (cpu > 0 and abs(card - cpu) <= TOOLS_PRUNE_SHARE * cpu):
            raise AssertionError(f"tools prune_grid: {key} cells {card} on the card, {cpu} on the CPU")
    print(f"tools prune_grid: card {json.dumps(pruned['cuda'])}, CPU {json.dumps(pruned['cpu'])} "
          f"(share {TOOLS_PRUNE_SHARE})", flush=True)

    lava, lava_grid = os.path.join(work, "lava.pth.tar"), os.path.join(work, "lava_grid.npy")
    _timed_tool(secs, "style_delta unpack", style_delta.main,
                ["unpack", "--base", bench.ARTIFACT_CKPT, "--delta", LAVA_DELTA, "--out", lava, "--grid_out", lava_grid])
    repacked = os.path.join(work, "lava_repacked.npz")
    _timed_tool(secs, "style_delta pack", style_delta.main,
                ["pack", "--base", bench.ARTIFACT_CKPT, "--styled", lava, "--out", repacked, "--grid", lava_grid])
    found = _hold_repacked_delta(repacked, LAVA_DELTA, load_params_with_config(bench.ARTIFACT_CKPT, "cpu")[0])
    print(f"tools style_delta: the lava delta unpacked and packed again: {found}", flush=True)

    style = _timed_tool(secs, "eval_style", eval_style.main,
                        ["--ckpt", lava, "--grid_path", lava_grid, "--style", "lava", "--guidance", TOY_DIR,
                         "--res", str(TOOLS_STYLE_RES), "--views", str(TOOLS_STYLE_VIEWS)])
    with open(LAVA_EVAL_RECORD) as fp:
        record = json.load(fp)
    keys = ("mean_style_dist", "mean_bare_dist", "improvement_factor", "mean_palette_dist",
            "mean_bare_palette_dist", "fg_sat_eval", "fg_sat_bare", "txt2img_hue_emd_eval",
            "txt2img_chroma_angle_eval_deg")
    print(f"tools eval_style ({card_line()}): " + json.dumps({k: {"card": style[k], "record": record[k]} for k in keys})
          + f" (the record: {os.path.relpath(LAVA_EVAL_RECORD, HERE)}, the full styled checkpoint before packing)",
          flush=True)
    if not style["mean_style_dist"] < style["mean_bare_dist"]:
        raise AssertionError(f"tools eval_style: the lava field's distance {style['mean_style_dist']} is not below "
                             f"the bare field's {style['mean_bare_dist']}")
    shutil.rmtree(work, ignore_errors=True)
    launches = dict(ring.launches)
    _expect_launches("tools", launches, {ring.KERNEL: 4 * len(views) + 2 * TOOLS_STYLE_VIEWS, ring.RS_KERNEL: 0})
    print("tools: " + json.dumps({"seconds": secs, "launches": launches}), flush=True)
    return launches


def _frozen_leaves_bitwise(trained: dict, start: dict) -> tuple[int, int]:
    """(frozen leaves, color leaves) of ``trained`` against ``start``:
    every leaf outside the color MLP bitwise its start, every color leaf
    moved; raises otherwise."""
    paths, a, b = sorted_leaf_paths(start), sorted_leaves(trained), sorted_leaves(start)
    if sorted_leaf_paths(trained) != paths:
        raise AssertionError("finetune_color: the trained tree differs from its start's")
    frozen = moved = 0
    for path, x, y in zip(paths, a, b):
        same = x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        if path.startswith("['color']"):
            moved += not same
            if same:
                raise AssertionError(f"finetune_color: the color leaf {path} did not move")
        elif not same:
            raise AssertionError(f"finetune_color: the frozen leaf {path} moved")
        else:
            frozen += 1
    return frozen, moved


def _body_frame(path: str, params: dict, fcfg) -> dict:
    """One DEMO_BODY_RES^2 warp frame of the artifact on the body at
    ``path`` (load_smpl): the root rig morphed to the first interp_shape
    frame, the articulated rig in demo pose STYLED_FRAME, from the warp
    bench's camera at a zero-clip budget. Returns its numbers."""
    model = load_smpl(path)
    if model.n_joints == 7:
        world_verts, Ts, _ = calc_local_trans(model, "animate", poses=load_pose_sequence(bench.POSES)[STYLED_FRAME:],
                                              max_frames=1, rest_pose="zero")
    else:
        world_verts, Ts, _ = calc_local_trans(model, "interp_shape", max_frames=1, rest_pose="zero")
    settings = WarpRenderSettings(chunk=DEMO_BODY_RES * DEMO_BODY_RES)
    ro, rd = pose2rays(DEMO_BODY_RES, DEMO_BODY_RES, bench.warp_view(), device="cuda")
    budget = derive_warp_budget(world_verts, ro, rd, settings)
    render = make_warp_frame_renderer_fast(params, fcfg, settings, budget)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb = render(ro, rd, WarpData.create(world_verts[0], model.faces, Ts[0], "cuda")).reshape(
        DEMO_BODY_RES, DEMO_BODY_RES, 3).cpu().numpy()
    ms = 1e3 * (time.perf_counter() - t0)
    fg = float((np.abs(rgb - 1.0).sum(-1) > 0.15).mean())
    if not (np.isfinite(rgb).all() and fg > 0.01):
        raise AssertionError(f"finetune: the warp frame on {path} is not finite or shows no body ({fg})")
    return {"joints": model.n_joints, "vertices": len(model.v_template), "faces": len(model.faces),
            "budget": budget, "body_share": fg, "frame_ms": ms}


def check_finetune(root: str) -> dict:
    """The fine-tune and asset tools' twins on the card, on the reconstruct
    phase's set (``root``) and its fast run's state, which this phase
    removes at its end:

    * finetune_color --ckpt of the artifact, analytic normals, for
      FINETUNE_COLOR_STEPS steps: every leaf but the color MLP's bitwise
      the artifact's on the card, the losses finite; bake_artifact of the
      result and eval_psnr of the bake under analytic normals (views 13,
      62, 95 at 128x128, raw), beside the artifact's own under analytic
      (its fd4 numbers are the tools phase's), printed and not held;
    * finetune_ss --state of the fast run at ss FINETUNE_SS for two calls
      of FINETUNE_SS_SCAN steps (a CUDA graph of the supersampled step),
      one refresh after the second call and one ``_latest`` save after the
      first: the steps and counts saved, the grid finite;
    * train_toy_guidance at TOY_TRAIN_RES^2 over TOY_TRAIN_VIEWS orbit views
      (and the head views) for TOY_TRAIN_STEPS steps: its output loaded by
      load_toy_guidance and given one eps call;
    * make_demo_body with both rigs at DEMO_BODY_LATTICE^3 from the artifact, each loaded
      by load_smpl and rendered as one warp frame (``_body_frame``).

    K10's launches counted exactly: finetune_color one gather a step and
    one for the final tree, no reduce-scatter (only the color MLP takes a
    gradient); eval_psnr one gather a view; finetune_ss one gather and one
    reduce-scatter a step (the graph's replays counted), one gather for
    the refresh and one for each save; the toy dataset one gather a group
    of 8 views; make_demo_body none (it reads the field whole); a warp
    frame one gather. Prints each tool's wall seconds."""
    fast = os.path.join(root, "out", "fast")
    work = tempfile.mkdtemp(prefix="finetune_", dir=root)
    secs, views = {}, [int(v) for v in TOOLS_VIEWS.split(",")]
    _reset_launches()
    want = {ring.KERNEL: 0, ring.RS_KERNEL: 0}

    def expect(what: str, gathers: int, reduce_scatters: int = 0) -> None:
        want[ring.KERNEL] += gathers
        want[ring.RS_KERNEL] += reduce_scatters
        _expect_launches(f"finetune {what}", dict(ring.launches), want)

    # finetune_color: the artifact re-fitted under analytic normals
    color_out = os.path.join(work, "color.pt")
    color = _timed_tool(secs, "finetune_color", finetune_color.main, [
        "--ckpt", bench.ARTIFACT_CKPT, "--grid_path", bench.ARTIFACT_GRID, "--out", color_out, "--data_path", root,
        "--normal_mode", "analytic", "--steps", str(FINETUNE_COLOR_STEPS)])
    expect("finetune_color", FINETUNE_COLOR_STEPS + 1)
    if not (len(color["losses"]) == FINETUNE_COLOR_STEPS and np.isfinite(color["losses"]).all()):
        raise AssertionError(f"finetune_color: losses {color['losses']}")
    state = load_train_state(color_out, "cuda")
    frozen, moved = _frozen_leaves_bitwise(state["params"], load_params_with_config(bench.ARTIFACT_CKPT, "cuda")[0])
    if (state["step"], state["count"]) != (FINETUNE_COLOR_STEPS, 0):
        raise AssertionError(f"finetune_color: saved step {state['step']}, count {state['count']}")
    del state
    baked = os.path.join(work, "color_baked")
    _timed_tool(secs, "bake_artifact", bake_artifact.main, ["--state", color_out, "--out", baked, "--normal_mode",
                                                            "analytic"])
    psnr_argv = ["--data_path", root, "--views", TOOLS_VIEWS, "--level", str(TOOLS_LEVEL), "--gt_mode", "raw"]
    psnr = {
        "tuned_analytic": _timed_tool(secs, "eval_psnr tuned", eval_psnr.main, [
            "--ckpt", os.path.join(baked, "bare_smpl_tpu.pth.tar"), "--grid_path", os.path.join(baked, "grid.npy"),
            "--normal_mode", "analytic"] + psnr_argv),
        "artifact_analytic": _timed_tool(secs, "eval_psnr artifact analytic", eval_psnr.main, [
            "--ckpt", bench.ARTIFACT_CKPT, "--grid_path", bench.ARTIFACT_GRID, "--normal_mode", "analytic"] + psnr_argv),
    }
    expect("eval_psnr", 2 * len(views))
    print(f"finetune_color ({card_line()}): {FINETUNE_COLOR_STEPS} steps from the artifact under analytic normals, "
          f"losses {json.dumps([round(l, 6) for l in color['losses']])}; {frozen} frozen leaves bitwise the "
          f"artifact's, {moved} color leaves moved; PSNR (raw, {TOOLS_LEVEL}x down) " + json.dumps(
              {k: {"mean": v["mean_psnr"], "normal_mode": v["normal_mode"]} for k, v in psnr.items()})
          + " (the artifact's under its own fd4: the tools phase)", flush=True)
    shutil.rmtree(baked, ignore_errors=True)
    os.remove(color_out)

    # finetune_ss: two graphed calls of the supersampled step from the fast run's state
    ss_out, steps = os.path.join(work, "ss.pt"), 2 * FINETUNE_SS_SCAN
    ss = _timed_tool(secs, "finetune_ss", finetune_ss.main, [
        "--state", os.path.join(fast, "state_latest.pt"), "--out", ss_out, "--data_path", root, "--ss",
        str(FINETUNE_SS), "--steps", str(steps), "--scan", str(FINETUNE_SS_SCAN), "--grid_refresh", str(steps),
        "--save_every", str(FINETUNE_SS_SCAN)])
    expect("finetune_ss", steps + 3, steps)
    latest, final = (load_train_state(p, "cpu") for p in (ss_out + "_latest", ss_out))
    saved = (latest["step"], latest["count"], final["step"], final["count"])
    want_saved = (RECON_STEPS + FINETUNE_SS_SCAN, FINETUNE_SS_SCAN, RECON_STEPS + steps, steps)
    if saved != want_saved or not (np.isfinite(ss["final_loss"]) and torch.isfinite(final["grid"]).all()):
        raise AssertionError(f"finetune_ss: saved (step, count) x 2 {saved}, expected {want_saved}; {ss}")
    print(f"finetune_ss ({card_line()}): {json.dumps(ss)}; saved (step, count) {saved[:2]} and {saved[2:]}; the "
          f"refreshed grid's max {float(final['grid'].max()):.4g}", flush=True)
    del latest, final
    shutil.rmtree(fast, ignore_errors=True)  # the fast run's train states (about 0.9 GB each)
    for p in (ss_out, ss_out + "_latest"):
        os.remove(p)

    # train_toy_guidance: the dataset rendered from the artifact, a few DDPM steps
    toy_out = os.path.join(work, "toy")
    meta = _timed_tool(secs, "train_toy_guidance", train_toy_guidance.main, [
        "--artifact", bench.ARTIFACT_DIR, "--out", toy_out, "--views", str(TOY_TRAIN_VIEWS), "--res", str(TOY_TRAIN_RES), "--steps",
        str(TOY_TRAIN_STEPS), "--scan", str(TOY_TRAIN_SCAN)])
    expect("train_toy_guidance", -(-meta["views"] // train_toy_guidance.RENDER_GROUP))
    params, cfg, embs = load_toy_guidance(toy_out, "cuda")
    lat = torch.randn((1, 3, TOY_TRAIN_RES, TOY_TRAIN_RES), generator=torch.Generator("cuda").manual_seed(0),
                      device="cuda")
    modules = make_toy_modules(params, cfg, embs)
    with torch.no_grad():
        eps = modules.unet(lat, torch.tensor([SDS_T], device="cuda"), modules.text_encode(["lava"]))
    if not (np.isfinite(meta["final_loss"]) and eps.shape == lat.shape and torch.isfinite(eps).all()):
        raise AssertionError(f"train_toy_guidance: {meta}, eps finite {bool(torch.isfinite(eps).all())}")
    print(f"train_toy_guidance ({card_line()}): {json.dumps(meta)}; loaded, eps of one input finite, "
          f"|eps| {float(eps.abs().mean()):.4f}", flush=True)

    # make_demo_body: both rigs, each animated for one warp frame
    art_params, art_fcfg = load_params_with_config(bench.ARTIFACT_CKPT, "cuda")
    bodies = {}
    for rig in ("root", "articulated"):
        out = os.path.join(work, f"body_{rig}.npz")
        made = _timed_tool(secs, f"make_demo_body {rig}", make_demo_body.main, [
            "--ckpt", bench.ARTIFACT_CKPT, "--out", out, "--rig", rig, "--resolution", str(DEMO_BODY_LATTICE)])
        expect(f"make_demo_body {rig}", 0)
        bodies[rig] = {"made": made, "frame": _body_frame(out, art_params, art_fcfg)}
        expect(f"warp frame on the {rig} body", 1)
    committed = {name: len(np.load(os.path.join(bench.ARTIFACT_DIR, name))["v_template"])
                 for name in ("demo_body.npz", "demo_body_rig.npz")}
    print(f"make_demo_body ({card_line()}): " + json.dumps(bodies) + f"; the committed bodies' vertices "
          f"{json.dumps(committed)}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    launches = dict(ring.launches)
    print("finetune: " + json.dumps({"seconds": secs, "launches": launches}), flush=True)
    return launches


# -- the last root tools' twins ------------------------------------------------


def _sd15_state_dicts(gen: torch.Generator) -> dict:
    """{module: state dict} of SD 1.5 under the diffusers / transformers key
    names the converters read (the layout of tests/test_sd_converters.py's
    build_unet_sd and build_vae_sd, the VAE's >= 0.17 attention names, and
    tests/test_torch_sd.py's build_clip_sd), float16 on the CPU: weights
    normal / sqrt(fan-in) drawn on ``gen``'s device, biases 0, norms 1 and 0."""
    out = {}

    def draw(sd_, pre, shape, fan_in, bias=True):
        sd_[f"{pre}.weight"] = (torch.randn(shape, generator=gen, device=gen.device) / fan_in**0.5).half().cpu()
        if bias:
            sd_[f"{pre}.bias"] = torch.zeros(shape[0], dtype=torch.float16)

    def conv(sd_, pre, cin, cout, k=3):
        draw(sd_, pre, (cout, cin, k, k), cin * k * k)

    def lin(sd_, pre, cin, cout, bias=True):
        draw(sd_, pre, (cout, cin), cin, bias)

    def norm(sd_, pre, c):
        sd_[f"{pre}.weight"], sd_[f"{pre}.bias"] = torch.ones(c, dtype=torch.float16), torch.zeros(c, dtype=torch.float16)

    def resnet(sd_, pre, cin, cout, temb=None):
        norm(sd_, f"{pre}.norm1", cin)
        conv(sd_, f"{pre}.conv1", cin, cout)
        if temb:
            lin(sd_, f"{pre}.time_emb_proj", temb, cout)
        norm(sd_, f"{pre}.norm2", cout)
        conv(sd_, f"{pre}.conv2", cout, cout)
        if cin != cout:
            conv(sd_, f"{pre}.conv_shortcut", cin, cout, k=1)

    def transformer(sd_, pre, c, ctx):
        norm(sd_, f"{pre}.norm", c)
        conv(sd_, f"{pre}.proj_in", c, c, k=1)
        blk = f"{pre}.transformer_blocks.0"
        for i, kv in ((1, c), (2, ctx)):
            norm(sd_, f"{blk}.norm{i}", c)
            lin(sd_, f"{blk}.attn{i}.to_q", c, c, bias=False)
            lin(sd_, f"{blk}.attn{i}.to_k", kv, c, bias=False)
            lin(sd_, f"{blk}.attn{i}.to_v", kv, c, bias=False)
            lin(sd_, f"{blk}.attn{i}.to_out.0", c, c)
        norm(sd_, f"{blk}.norm3", c)
        lin(sd_, f"{blk}.ff.net.0.proj", c, 8 * c)
        lin(sd_, f"{blk}.ff.net.2", 4 * c, c)
        conv(sd_, f"{pre}.proj_out", c, c, k=1)

    ucfg, vcfg, tcfg = sd.stable_diffusion_configs("1.5")
    u, ch, temb = {}, ucfg.block_out_channels, ucfg.time_embed_dim
    conv(u, "conv_in", ucfg.in_channels, ch[0])
    lin(u, "time_embedding.linear_1", ch[0], temb)
    lin(u, "time_embedding.linear_2", temb, temb)
    cin = ch[0]
    for i, cout in enumerate(ch):
        for j in range(ucfg.layers_per_block):
            resnet(u, f"down_blocks.{i}.resnets.{j}", cin, cout, temb)
            if ucfg.attn_blocks[i]:
                transformer(u, f"down_blocks.{i}.attentions.{j}", cout, ucfg.cross_attention_dim)
            cin = cout
        if i < len(ch) - 1:
            conv(u, f"down_blocks.{i}.downsamplers.0.conv", cout, cout)
    resnet(u, "mid_block.resnets.0", ch[-1], ch[-1], temb)
    transformer(u, "mid_block.attentions.0", ch[-1], ucfg.cross_attention_dim)
    resnet(u, "mid_block.resnets.1", ch[-1], ch[-1], temb)
    rev = list(reversed(ch))
    for i, cout in enumerate(rev):
        for j in range(ucfg.layers_per_block + 1):
            skip = rev[min(i + 1, len(ch) - 1)] if j == ucfg.layers_per_block else cout
            resnet(u, f"up_blocks.{i}.resnets.{j}", cin + skip, cout, temb)
            if list(reversed(ucfg.attn_blocks))[i]:
                transformer(u, f"up_blocks.{i}.attentions.{j}", cout, ucfg.cross_attention_dim)
            cin = cout
        if i < len(ch) - 1:
            conv(u, f"up_blocks.{i}.upsamplers.0.conv", cout, cout)
    norm(u, "conv_norm_out", ch[0])
    conv(u, "conv_out", ch[0], ucfg.out_channels)
    out["unet"] = u

    v, ch = {}, vcfg.block_out_channels
    conv(v, "encoder.conv_in", vcfg.in_channels, ch[0])
    cin = ch[0]
    for i, cout in enumerate(ch):
        for j in range(vcfg.layers_per_block):
            resnet(v, f"encoder.down_blocks.{i}.resnets.{j}", cin, cout)
            cin = cout
        if i < len(ch) - 1:
            conv(v, f"encoder.down_blocks.{i}.downsamplers.0.conv", cout, cout)
    rev = tuple(reversed(ch))
    for half, c in (("encoder", ch[-1]), ("decoder", rev[0])):
        resnet(v, f"{half}.mid_block.resnets.0", c, c)
        norm(v, f"{half}.mid_block.attentions.0.group_norm", c)
        for n in ("to_q", "to_k", "to_v", "to_out.0"):
            lin(v, f"{half}.mid_block.attentions.0.{n}", c, c)
        resnet(v, f"{half}.mid_block.resnets.1", c, c)
    norm(v, "encoder.conv_norm_out", ch[-1])
    conv(v, "encoder.conv_out", ch[-1], 2 * vcfg.latent_channels)
    conv(v, "quant_conv", 2 * vcfg.latent_channels, 2 * vcfg.latent_channels, k=1)
    conv(v, "post_quant_conv", vcfg.latent_channels, vcfg.latent_channels, k=1)
    conv(v, "decoder.conv_in", vcfg.latent_channels, rev[0])
    cin = rev[0]
    for i, cout in enumerate(rev):
        for j in range(vcfg.layers_per_block + 1):
            resnet(v, f"decoder.up_blocks.{i}.resnets.{j}", cin, cout)
            cin = cout
        if i < len(rev) - 1:
            conv(v, f"decoder.up_blocks.{i}.upsamplers.0.conv", cout, cout)
    norm(v, "decoder.conv_norm_out", rev[-1])
    conv(v, "decoder.conv_out", rev[-1], vcfg.in_channels)
    out["vae"] = v

    c, d = {}, tcfg.hidden_size
    draw(c, "text_model.embeddings.token_embedding", (tcfg.vocab_size, d), d, bias=False)
    draw(c, "text_model.embeddings.position_embedding", (tcfg.max_len, d), d, bias=False)
    c["text_model.embeddings.position_ids"] = torch.arange(tcfg.max_len)[None]
    for i in range(tcfg.num_layers):
        pre = f"text_model.encoder.layers.{i}"
        norm(c, f"{pre}.layer_norm1", d)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(c, f"{pre}.self_attn.{n}", d, d)
        norm(c, f"{pre}.layer_norm2", d)
        lin(c, f"{pre}.mlp.fc1", d, 4 * d)
        lin(c, f"{pre}.mlp.fc2", 4 * d, d)
    norm(c, "text_model.final_layer_norm", d)
    out["text_encoder"] = c
    return out


def write_sd15_snapshot(root: str) -> dict:
    """SD 1.5 as a diffusers snapshot of float16 .safetensors under
    ``root`` (``_sd15_state_dicts`` seeded 0 on the card); {file: bytes}."""
    files = {"unet": "unet/diffusion_pytorch_model.safetensors", "vae": "vae/diffusion_pytorch_model.safetensors",
             "text_encoder": "text_encoder/model.safetensors"}
    written = {}
    for mod, state in _sd15_state_dicts(torch.Generator("cuda").manual_seed(0)).items():
        path = os.path.join(root, files[mod])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        save_safetensors(state, path, {"format": "pt"})
        written[files[mod]] = os.path.getsize(path)
    return written


def _run_postprocess(work: str, secs: dict) -> dict:
    """The postprocess_multi.sh twin for PROBES_POST_PROMPT at
    PROBES_POST_RES and PROBES_POST_TRAJ in a scratch tree under ``work``
    (the script at its place, the artifact and toy guidance linked, the run
    directory unpacked from the committed lava delta): every output file
    checked; returns the K10 launches of its processes, summed by tool."""
    tree = os.path.join(work, "tree")
    script = os.path.join(tree, "avatarcraft_tpu_torch", "tools", "postprocess_multi.sh")
    os.makedirs(os.path.dirname(script))
    shutil.copy(os.path.join(HERE, "avatarcraft_tpu_torch", "tools", "postprocess_multi.sh"), script)
    os.makedirs(os.path.join(tree, "artifacts"))
    os.makedirs(os.path.join(tree, "docs", "eval"))
    for name in ("canonical", "toy_guidance"):
        os.symlink(os.path.join(HERE, "artifacts", name), os.path.join(tree, "artifacts", name))
    run = os.path.join(tree, "style", "toy", "multi")
    p = PROBES_POST_PROMPT
    _timed_tool(secs, "style_delta unpack", style_delta.main, [
        "unpack", "--base", bench.ARTIFACT_CKPT, "--delta", LAVA_DELTA, "--out",
        os.path.join(run, f"multi_{p}_final.pth.tar"), "--grid_out", os.path.join(run, f"multi_{p}_grid.npy")])
    hook = os.path.join(work, "hook")
    os.makedirs(hook)
    with open(os.path.join(hook, "sitecustomize.py"), "w") as fp:
        fp.write(LAUNCH_HOOK)
    counts_file = os.path.join(work, "k10.jsonl")
    env = {**os.environ, "RES": str(PROBES_POST_RES), "TRAJ": str(PROBES_POST_TRAJ), "PYTHONPATH": os.pathsep.join(
        [hook, HERE] + [q for q in os.environ.get("PYTHONPATH", "").split(os.pathsep) if q]),
        "K10_LAUNCHES_OUT": counts_file}
    t0 = time.perf_counter()
    res = subprocess.run(["bash", script, "final", p], env=env, capture_output=True, text=True, timeout=600)
    secs["postprocess_multi"] = time.perf_counter() - t0
    print(f"tools postprocess_multi: {secs['postprocess_multi']:.2f} s", flush=True)
    if res.returncode != 0:
        raise AssertionError(f"postprocess_multi exited {res.returncode}:\n{res.stdout[-3000:]}\n{res.stderr[-5000:]}")
    bare = f"multi_bare_{PROBES_POST_RES}"
    frames = [f"demo/canonical_360/{exp}/{exp}_{pose}_can_{i:04d}.png" for exp in (bare, f"multi_{p}")
              for pose in ("body", "head") for i in range(PROBES_POST_TRAJ)]
    gifs = [f"docs/media/multi_{p}_sbs.gif", f"docs/media/multi_{p}_head_sbs.gif"]
    for rel in frames + gifs + [f"docs/eval/multi_{p}.json", f"artifacts/styled/multi_{p}_delta.npz"]:
        if not os.path.isfile(os.path.join(tree, rel)):
            raise AssertionError(f"postprocess_multi: {rel} is missing")
    for rel in gifs:
        info = gif.gif_info(os.path.join(tree, rel))
        if len(info["delays"]) != PROBES_POST_TRAJ:
            raise AssertionError(f"postprocess_multi: {rel} holds {len(info['delays'])} frames")
    with open(os.path.join(tree, "docs", "eval", f"multi_{p}.json")) as fp:
        style = json.load(fp)
    by_tool = {}
    with open(counts_file) as fp:
        for line in fp:
            rec = json.loads(line)
            name = rec["argv"][0].removesuffix(".py")
            tally = by_tool.setdefault(name, {ring.KERNEL: 0, ring.RS_KERNEL: 0})
            for k in tally:
                tally[k] += rec["launches"].get(k, 0)
    print(f"tools postprocess_multi ({card_line()}): {len(frames)} frames, 2 GIFs, eval_style "
          + json.dumps({k: style[k] for k in ("mean_style_dist", "mean_bare_dist", "improvement_factor")})
          + f", the delta; K10 by tool {json.dumps(by_tool)}", flush=True)
    return by_tool


def check_probes(root: str) -> dict:
    """The last root tools' twins on the card (see the module docstring,
    phase 19e), on the reconstruct phase's set (``root``). K10 counted
    exactly per tool: preflight_sd none (it renders no field);
    synth_gt_band_check one gather for both renders; sds_scale_probe one
    gather when its trainer is built and one gather and one reduce-scatter
    a step; profile_stylize_fine the same, plus one gather a refresh; the
    postprocess script one gather a rendered frame (the render CLI's 2 x
    2 x PROBES_POST_TRAJ, eval_style's 2 x its 4 views), none in
    make_sbs_gif or style_delta."""
    work = tempfile.mkdtemp(prefix="probes_", dir=root)
    secs, want = {}, {ring.KERNEL: 0, ring.RS_KERNEL: 0}
    _reset_launches()

    def expect(what: str, gathers: int, reduce_scatters: int = 0) -> None:
        want[ring.KERNEL] += gathers
        want[ring.RS_KERNEL] += reduce_scatters
        _expect_launches(f"probes {what}", dict(ring.launches), want)

    snap = os.path.join(work, "sd15")
    t0 = time.perf_counter()
    written = write_sd15_snapshot(snap)
    secs["write SD 1.5 snapshot"] = time.perf_counter() - t0
    printed = io.StringIO()

    def preflight_main(argv):
        with contextlib.redirect_stdout(printed):
            return preflight_sd.main(argv)

    rc = _timed_tool(secs, "preflight_sd", preflight_main, ["--weights", snap])
    report = json.loads(printed.getvalue().strip().splitlines()[-1])
    expect("preflight_sd", 0)
    smoke = report.get("smoke") or {}
    print(f"tools preflight_sd ({card_line()}): exit {rc}, {json.dumps(report)}; the snapshot's bytes "
          f"{json.dumps(written)} written in {secs['write SD 1.5 snapshot']:.2f} s", flush=True)
    if not (rc == 0 and report["go"] and all(smoke.get(k) for k in (
            "text_embeds_finite", "sds_grad_finite", "sds_grad_nonzero", "txt2img_decoded_finite"))):
        raise AssertionError("preflight_sd: not GO on the SD 1.5 snapshot")
    shutil.rmtree(snap)
    torch.cuda.empty_cache()

    band = _timed_tool(secs, "synth_gt_band_check", synth_gt_band_check.main, [
        "--ckpt", bench.ARTIFACT_CKPT, "--grid_path", bench.ARTIFACT_GRID, "--data_path", root, "--view",
        str(PROBES_BAND_VIEW), "--out", os.path.join(work, "band.json")])
    expect("synth_gt_band_check", 1)
    numbers = [band[k] for k in ("psnr_vs_synthetic_gt", "band_frac_of_pixels", "band_mse_share", "interior_psnr")]
    print(f"tools synth_gt_band_check ({card_line()}): {json.dumps(band)}", flush=True)
    if not (np.isfinite(numbers).all() and 0 < band["band_frac_of_pixels"] < 1):
        raise AssertionError(f"synth_gt_band_check: {band}")

    torch.cuda.reset_peak_memory_stats()
    probe = _timed_tool(secs, "sds_scale_probe", sds_scale_probe.main, [str(PROBES_SDS_STEPS)])
    expect("sds_scale_probe", 1 + PROBES_SDS_STEPS, PROBES_SDS_STEPS)
    print(f"tools sds_scale_probe ({card_line()}): {json.dumps(probe)}", flush=True)
    mem = probe["mem_after_steps_GiB"]
    if not (np.isfinite([probe["step0_s_with_compile"], probe["steady_step_s"], probe["sds_iters_per_sec"]]).all()
            and probe["unet_params_M"] == 859.6 and mem["peak_bytes_in_use"] > 0):
        raise AssertionError(f"sds_scale_probe: {probe}")
    torch.cuda.empty_cache()

    fine = _timed_tool(secs, "profile_stylize_fine", profile_stylize_fine.main, [
        "--weights_path", bench.ARTIFACT_CKPT, "--grid_path", bench.ARTIFACT_GRID, "--toy_weights", TOY_DIR,
        "--steps", str(PROBES_FINE_STEPS), "--grid_update_every", str(PROBES_FINE_REFRESH)])
    refreshes = PROBES_FINE_STEPS // PROBES_FINE_REFRESH
    expect("profile_stylize_fine", 1 + PROBES_FINE_STEPS + refreshes, PROBES_FINE_STEPS)
    print(f"tools profile_stylize_fine ({card_line()}): {json.dumps(fine)}", flush=True)
    if not (np.isfinite(fine["steps_per_sec"]) and fine["config"]["budget"] > 0
            and np.isfinite([fine["occ_frac_start"], fine["occ_frac_end"]]).all()):
        raise AssertionError(f"profile_stylize_fine: {fine}")

    by_tool = _run_postprocess(work, secs)
    frames = 2 * 2 * PROBES_POST_TRAJ  # the bare and the styled orbit, body and head
    want_by_tool = {"render_canonical_cli": {ring.KERNEL: frames, ring.RS_KERNEL: 0},
                    "make_sbs_gif": {ring.KERNEL: 0, ring.RS_KERNEL: 0},
                    "eval_style": {ring.KERNEL: 2 * TOOLS_STYLE_VIEWS, ring.RS_KERNEL: 0},
                    "style_delta": {ring.KERNEL: 0, ring.RS_KERNEL: 0}}
    if by_tool != want_by_tool:
        raise AssertionError(f"postprocess_multi: K10 launches {by_tool}, expected {want_by_tool}")
    launches = dict(ring.launches)
    for tally in by_tool.values():
        for k, n in tally.items():
            launches[k] += n
    shutil.rmtree(work, ignore_errors=True)
    print("probes: " + json.dumps({"seconds": secs, "launches": launches}), flush=True)
    return launches


def recon_parity_checkpoint(root: str) -> str:
    """The hash-grid checkpoint that check_reconstruct's parity CLI run wrote."""
    return os.path.join(root, "out", "parity", "parity_final.pth.tar")


# -- the parity pipeline ------------------------------------------------------


@contextlib.contextmanager
def _timed_renderer(module, name: str, record: list, finite: list | None = None):
    """Replaces ``module.<name>`` (a renderer factory) so that every call
    of the renderers it makes appends its host seconds, ending in a
    synchronize, to ``record`` (and to ``finite`` whether every tensor it
    returned is finite)."""
    real = getattr(module, name)

    def factory(*args, **kw):
        render = real(*args, **kw)

        def call(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render(*a)
            torch.cuda.synchronize()
            record.append(time.perf_counter() - t0)
            if finite is not None:
                finite.append(all(bool(torch.isfinite(t).all()) for t in out.values()))
            return out

        return call

    setattr(module, name, factory)
    try:
        yield record
    finally:
        setattr(module, name, real)


def _body_png(path: str, res: int, body: bool = True) -> float:
    """The share of foreground pixels in the PNG at ``path``, which must be
    res x res and, with ``body``, a body over the white background."""
    img = read_png(path)
    fg = float((img.astype(int).sum(-1) < 3 * 250).mean())
    if img.shape != (res, res, 3) or (body and not 0.01 <= fg <= 0.99):
        raise AssertionError(f"{path}: shape {img.shape}, foreground share {fg}")
    return fg


def check_parity_render() -> dict:
    """render_canonical_cli at its defaults (parity: 64+64, no jitter, the
    artifact's fd4, 4096-ray chunks) on the artifact, PARITY_ORBIT frames of
    each orbit at PARITY_RES^2: every PNG a body on white, one gather per
    frame; ms per frame. Then a PARITY_CPU_RES^2 frame with f32 tables on the
    card and the CPU within PARITY_CPU_ATOL."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_parity_render_")
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        with _timed_renderer(render_canonical_cli, "make_parity_frame_renderer", []) as frame_s:
            render_canonical_cli.main(["--weights_path", bench.ARTIFACT_CKPT, "--render_h", str(PARITY_RES),
                                       "--render_w", str(PARITY_RES), "--trajectory_resolution", str(PARITY_ORBIT),
                                       "--out_dir", out_dir, "--exp_name", "parity", "--log_extra", "true"])
        torch.cuda.synchronize()
        launches = _read_launches("parity_render", [ring.KERNEL])
        n = 2 * PARITY_ORBIT
        _expect_launches("parity_render", launches, {ring.KERNEL: n, ring.RS_KERNEL: 0})
        exp = os.path.join(out_dir, "canonical_360", "parity")
        for pose in ("body", "head"):
            frames = [f"parity_{pose}_can_{i:04d}.png" for i in range(PARITY_ORBIT)]
            for name in frames:
                # a head close-up may fill its frame
                _body_png(os.path.join(exp, name), PARITY_RES, body=pose == "body")
                if _body_png(os.path.join(exp, name), PARITY_RES, body=False) < 0.01:
                    raise AssertionError(f"parity_render: {name} shows nothing")
                # JAX's recipe blacks out normalised depths under 0.4: all of a head close-up
                depth = read_png(os.path.join(exp, name.replace(".png", "_depth.png")))
                if depth.shape != (PARITY_RES, PARITY_RES, 3) or (pose == "body" and not depth.any()):
                    raise AssertionError(f"parity_render: the depth PNG of {name}: {depth.shape}, empty")
            info = gif.gif_info(os.path.join(exp, f"parity_{pose}_can.gif"))
            print(f"parity_render: parity_{pose}_can.gif: {json.dumps(info)}", flush=True)
            if (info["version"], info["loop"], info["frames"], info["width"], info["height"], info["delays"]) != (
                    "GIF89a", 0, len(frames), PARITY_RES, PARITY_RES, [gif.gif_delay_cs(15)] * len(frames)):
                raise AssertionError(f"parity_render: parity_{pose}_can.gif: {info}, {len(frames)} PNG frames")
            for kind in ("intrinsic", "extrinsic"):
                if not os.path.isfile(os.path.join(exp, f"parity_{pose}_{kind}.pkl")):
                    raise AssertionError(f"parity_render: parity_{pose}_{kind}.pkl not written")
        if len(frame_s) != n:
            raise AssertionError(f"parity_render: {len(frame_s)} frames timed, {n} expected")
        print(f"parity_render: {n} frames at {PARITY_RES}x{PARITY_RES} (64+64, "
              f"{artifact_normal_mode(bench.ARTIFACT_CKPT) or 'fd7'}, 4096-ray chunks): "
              f"{json.dumps([round(1e3 * t, 2) for t in frame_s])} ms (the first a warm-up); "
              f"{1e3 * float(np.mean(frame_s[1:])):.2f} ms per frame; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card_line()})", flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    pose = bench.bench_poses()[0]
    frames = {}
    for device in ("cpu", "cuda"):
        params, fcfg = load_params_with_config(bench.ARTIFACT_CKPT, device)
        fcfg = dataclasses.replace(fcfg, packed_dtype="float32")
        rcfg = RenderConfig(num_steps=64, upsample_steps=64, bound=NSR_BOUND, perturb=False,
                            normal_mode=artifact_normal_mode(bench.ARTIFACT_CKPT) or "fd7")
        ro, rd = pose2rays(PARITY_CPU_RES, PARITY_CPU_RES, pose, device=device)
        frames[device] = make_parity_frame_renderer(params, fcfg, rcfg, chunk=PARITY_CPU_RES**2)(ro, rd)["rgb"].cpu()
    check_parity_frame_close(frames["cuda"], frames["cpu"], PARITY_CPU_ATOL, PARITY_CPU_OUTLIER_SHARE,
                             f"parity {PARITY_CPU_RES}x{PARITY_CPU_RES} frame, f32 tables")
    return launches


def _warp_argv(weights: str, root: str, out_dir: str, name: str, frames: int) -> list:
    """render_warp_cli at its defaults on the demo body, a view of the
    dataset in ``root``, PARITY_WARP_RES^2."""
    return ["--weights_path", weights, "--smpl_path", bench.RIG, "--poseseq_path", bench.POSES, "--data_path", root,
            "--resolution", str(PARITY_WARP_RES), "--render_view", str(PARITY_WARP_VIEW), "--max_frames", str(frames),
            "--out_dir", out_dir, "--exp_name", name]


def check_parity_frame_close(card: torch.Tensor, cpu: torch.Tensor, atol: float, max_share: float,
                             what: str) -> None:
    """Every value within PARITY_FRAME_MAX, all but ``max_share`` of them
    within ``atol``; the card's frame finite and not empty."""
    d = (card - cpu).abs()
    err, share = float(d.max()), float((d > atol).float().mean())
    print(f"{what}, card vs CPU: max abs diff {err:.3g} (atol {PARITY_FRAME_MAX}), share above {atol}: "
          f"{share:.4f} (at most {max_share}), mean abs diff {float(d.mean()):.3g}", flush=True)
    if not (torch.isfinite(card).all() and err <= PARITY_FRAME_MAX and share <= max_share
            and (card < 0.99).any()):
        raise AssertionError(f"{what}: card and CPU differ (max {err}, share {share}), or the frame is empty")


def check_parity_warp(root: str) -> dict:
    """render_warp_cli at its defaults (parity: geometry-guided bounds, 32+32
    warped samples, fd7) on the artifact animated on the demo body, view
    PARITY_WARP_VIEW of the dataset in ``root`` at PARITY_WARP_RES^2,
    PARITY_WARP_FRAMES frames: one gather per frame, every PNG a body on
    white; ms per frame, peak memory. Then check_parity_warp_card_vs_cpu."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_parity_warp_")
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        with _timed_renderer(render_warp_cli, "make_warp_frame_renderer", []) as frame_s:
            render_warp_cli.main(_warp_argv(bench.ARTIFACT_CKPT, root, out_dir, "parity", PARITY_WARP_FRAMES))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = _read_launches("parity_warp", [ring.KERNEL])
        _expect_launches("parity_warp", launches, {ring.KERNEL: PARITY_WARP_FRAMES, ring.RS_KERNEL: 0})
        exp = os.path.join(out_dir, "test_views", "parity")
        for i in range(PARITY_WARP_FRAMES):
            _body_png(os.path.join(exp, f"parity_{i:04d}.png"), PARITY_WARP_RES)
        print(f"parity_warp: {PARITY_WARP_FRAMES} frames at {PARITY_WARP_RES}x{PARITY_WARP_RES} (32+32 warped, fd7, "
              f"8192-ray chunks): {json.dumps([round(1e3 * t, 2) for t in frame_s])} ms (the first a warm-up); "
              f"peak {peak:.2f} GiB ({card_line()})", flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    check_parity_warp_card_vs_cpu()
    return launches


def check_parity_warp_card_vs_cpu() -> None:
    """Demo frame 10 through the parity warp frame renderer at
    PARITY_WARP_CPU_RES^2 from the warp bench's camera on the card and the
    CPU."""
    model, world_verts, Ts = bench.demo_frames(1, first=STYLED_FRAME)
    frames = {}
    for device in ("cpu", "cuda"):
        params, fcfg = load_params_with_config(bench.ARTIFACT_CKPT, device)
        ro, rd = pose2rays(PARITY_WARP_CPU_RES, PARITY_WARP_CPU_RES, bench.warp_view(), device=device)
        render = warp_render.make_warp_frame_renderer(params, fcfg, warp_render.WarpRenderSettings())
        frames[device] = render(ro, rd, WarpData.create(world_verts[0], model.faces, Ts[0], device)).cpu()
    check_parity_frame_close(frames["cuda"], frames["cpu"], PARITY_FRAME_ATOL, PARITY_WARP_OUTLIER_SHARE,
                             f"parity warp frame {PARITY_WARP_CPU_RES}x{PARITY_WARP_CPU_RES}")


@contextlib.contextmanager
def _recorded_stylize_steps(record: list):
    """StylizeTrainer.train_view wrapped: each step appends (epoch, host
    seconds ending in a synchronize, loss, whether the loss and every
    parameter gradient are finite)."""
    real = StylizeTrainer.train_view

    def recorded(self, pose, desc, epoch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = real(self, pose, desc, epoch)
        torch.cuda.synchronize()
        grads = [t.grad for t in leaves(self.rest) + self.shards]
        finite = bool(torch.isfinite(loss)) and all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
        record.append((epoch, time.perf_counter() - t0, float(loss), finite))
        return loss

    StylizeTrainer.train_view = recorded
    try:
        yield record
    finally:
        StylizeTrainer.train_view = real


def _ranges(prof: dict) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in prof["range_device_ms_per_step"].items())


def check_parity_stylize() -> dict:
    """The stylize CLI at its defaults (parity: 64+64 with jitter, fd7, the
    toy guidance, lava) on the artifact for PARITY_COARSE_STEPS coarse steps,
    the last with the validation render and a 512^3 mesh; then a fine
    trainer for PARITY_FINE_STEPS steps; one more step of each profiled.
    Every loss and gradient finite; one gather and one reduce-scatter per
    step (the CLI also gathers for the ground truth, the validation render,
    the mesh and the final save); the PNG, the .ply and the final
    checkpoint. Returns the launches of the CLI run and the fine steps."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_parity_stylize_")
    try:
        with _recorded_stylize_steps([]) as record:
            n = PARITY_COARSE_STEPS
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            with _timed_export({}) as export:
                trainer = stylize_cli.main(profile_train.PARITY_STYLIZE_ARGV + [
                    "--max_steps", str(n), "--i_val", str(n), "--i_save", "1000000", "--i_mesh", str(n),
                    "--out_dir", out_dir, "--exp_name", "lava"])
            torch.cuda.synchronize()
            coarse_peak = torch.cuda.max_memory_allocated() / 2**30
            cli = _read_launches("parity_stylize (CLI)", [ring.KERNEL, ring.RS_KERNEL])
            _expect_launches("parity_stylize (CLI)", cli, {ring.KERNEL: n + 4, ring.RS_KERNEL: n})
            if not (trainer.cfg.sampler == "parity" and trainer.grid is None and trainer.rcfg == RenderConfig(
                    num_steps=64, upsample_steps=64, bound=NSR_BOUND, perturb=True, normal_mode="fd7")):
                raise AssertionError(f"parity_stylize: the CLI's trainer is not the parity one: {trainer.rcfg}")
            exp = os.path.join(out_dir, "lava")
            _body_png(os.path.join(exp, f"lava_{n:04d}_body.png"), trainer.cfg.H)
            nv, nf = _ply_counts(os.path.join(exp, f"lava_{n:04d}.ply"))
            params = trainer.params()
            loaded, _ = load_params_with_config(os.path.join(exp, "lava_final.pth.tar"), "cuda")
            if not (nf > 0 and all(torch.equal(a, b) for a, b in zip(leaves(loaded), leaves(params)))):
                raise AssertionError("parity_stylize: no mesh, or the final checkpoint does not load as the trainer's")
            coarse_s = [t for _, t, _, _ in record[1:]]
            coarse_prof = profile_train.profile_stylize_steps(trainer, 0, 1)

            base, fcfg = load_params_with_config(bench.ARTIFACT_CKPT, "cuda")
            fine_cfg = dataclasses.replace(trainer.cfg, coarse_epochs=0, fine_epochs=1)
            fine = StylizeTrainer(fine_cfg, fcfg, trainer.guidance, base, base)
            del trainer, params, loaded
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            first = len(record)
            profile_train.time_stylize_steps(fine, 0, PARITY_FINE_STEPS)
            torch.cuda.synchronize()
            fine_launches = _read_launches("parity_stylize (fine)", [ring.KERNEL, ring.RS_KERNEL])
            m = PARITY_FINE_STEPS
            _expect_launches("parity_stylize (fine)", fine_launches, {ring.KERNEL: m, ring.RS_KERNEL: m})
            fine_peak = torch.cuda.max_memory_allocated() / 2**30
            fine_s = [t for _, t, _, _ in record[first + 1:]]
            _, _, th, tw = fine.view_rays(bench.bench_poses()[0], 0)
            fine_prof = profile_train.profile_stylize_steps(fine, 0, 1)
        if (th, tw) != (PARITY_RES, PARITY_RES) or not all(ok for _, _, _, ok in record):
            raise AssertionError(f"parity_stylize: a {th}x{tw} fine frame, or a loss or gradient not finite: {record}")
        summary = {
            "card": card_line(),
            "losses": [l for _, _, l, _ in record],
            "coarse_steps_per_sec": len(coarse_s) / sum(coarse_s),
            "coarse_step_ms": [1e3 * t for t in coarse_s],
            "coarse_peak_mem_gib": coarse_peak,
            "fine_steps_per_sec": len(fine_s) / sum(fine_s),
            "fine_step_ms": [1e3 * t for t in fine_s],
            "fine_peak_mem_gib": fine_peak,
            "mesh_export_s": {k: v[0] for k, v in export.items()},
            "coarse_profile": coarse_prof,
            "fine_profile": fine_prof,
        }
        print("parity_stylize: " + json.dumps(summary), flush=True)
        for stage, prof in (("coarse", coarse_prof), ("fine", fine_prof)):
            print(f"parity_stylize {stage}: {summary[stage + '_steps_per_sec']:.3f} SDS steps/s; device ms per step: "
                  f"{_ranges(prof)}; idle share {prof['device_idle_share']:.3f}; peak "
                  f"{summary[stage + '_peak_mem_gib']:.2f} GiB", flush=True)
        return {k: cli[k] + fine_launches[k] for k in cli}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def check_reference_chain(root: str) -> dict:
    """The reference pipeline at its defaults: the hash-grid checkpoint of
    the reconstruct phase's parity CLI run, one parity SDS step of the
    stylize CLI on it (toy guidance, lava), then one parity frame of the
    styled field animated on the demo body (render_warp_cli). Returns the
    table kernels' launches of the two CLIs."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_chain_")
    try:
        _reset_launches()
        trainer = stylize_cli.main(["--weights_path", recon_parity_checkpoint(root), "--guidance_type", "toy",
                                    "--tgt_text", "lava", "--toy_weights", TOY_DIR, "--max_steps", "1",
                                    "--i_val", "1000000", "--i_save", "1000000", "--i_mesh", "1000000",
                                    "--out_dir", out_dir, "--exp_name", "chain"])
        styled = os.path.join(out_dir, "chain", "chain_final.pth.tar")
        if trainer.fcfg.encoder != "hashgrid" or not trainer.cfg.sampler == "parity":
            raise AssertionError(f"chain: stylized a {trainer.fcfg.encoder} field with {trainer.cfg.sampler}")
        del trainer
        render_warp_cli.main(_warp_argv(styled, root, out_dir, "chain", 1))
        torch.cuda.synchronize()
        launches = _read_launches("parity_chain", [ring.KERNEL, ring.RS_KERNEL])
        # stylize: the ground truth, the step, the final save; the warp frame
        _expect_launches("parity_chain", launches, {ring.KERNEL: 4, ring.RS_KERNEL: 1})
        # a field reconstructed for RECON_STEPS steps only: its frame is written, not judged
        fg = _body_png(os.path.join(out_dir, "test_views", "chain", "chain_0000.png"), PARITY_WARP_RES, body=False)
        print(f"reference chain (reconstruct parity -> stylize parity -> render_warp parity): the styled hash-grid "
              f"field animated on the demo body, foreground share {fg:.3f} of {PARITY_WARP_RES}^2", flush=True)
        return launches
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def check_parity_multi() -> dict:
    """MultiPromptTrainer with the parity sampler on the artifact at P = 2
    (lava, emerald; the toy guidance; the CLI's defaults otherwise): two
    coarse steps, the first a warm-up; P gathers and P reduce-scatters a
    step, plus the ground truth's gather, counted exactly."""
    params, fcfg = load_params_with_config(bench.ARTIFACT_CKPT, "cuda")
    toy, tcfg, embs = load_toy_guidance(TOY_DIR, "cuda")
    guide = SDSGuidance(make_toy_modules(toy, tcfg, embs))
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    trainer = MultiPromptTrainer(StylizeConfig(), fcfg, guide, ["lava", "emerald"], stack_params([params, params]),
                                 params)
    steps, losses = [], []
    for pose, desc in profile_train.stylize_views(trainer, 0, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_view(pose, desc, 0))
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    launches = _read_launches("parity_multi", [ring.KERNEL, ring.RS_KERNEL])
    P = trainer.P
    _expect_launches("parity_multi", launches, {ring.KERNEL: 1 + 2 * P, ring.RS_KERNEL: 2 * P})
    losses = torch.stack(losses)
    if trainer.grids is not None or not torch.isfinite(losses).all():
        raise AssertionError(f"parity_multi: grids {trainer.grids}, losses {losses}")
    print(f"parity_multi: P = {P} coarse steps {json.dumps([round(1e3 * t, 2) for t in steps])} ms (the first a "
          f"warm-up), losses {losses.tolist()}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({card_line()})", flush=True)
    return launches


def _small_parity_field(device: str) -> dict:
    params = instant_nsr.init_field_params(torch.Generator().manual_seed(3), PARITY_SMALL_FCFG)
    params["sdf"][-1]["b"][0] -= 1.0
    return map_leaves(params, lambda t: t.to(device))


@contextlib.contextmanager
def _cpu_jitter():
    """stylize's draw_jitter drawing from one CPU generator (seeded 7) and
    moved to the device, so that the card and the CPU render with the same
    jitter."""
    real = stylize_workload.draw_jitter
    gen = torch.Generator().manual_seed(7)

    def draw(n, rcfg, generator, device):
        return None if not rcfg.perturb else torch.rand((n, rcfg.num_steps), generator=gen).to(device)

    stylize_workload.draw_jitter = draw
    try:
        yield
    finally:
        stylize_workload.draw_jitter = real


def _parity_step_record(device: str, field, noise: torch.Tensor, prompts: list | None,
                        cpu: dict | None = None) -> dict:
    """One coarse parity SDS step of the field that ``field(device)``
    returns as (params, fcfg) (a 32x32 frame, one 1024-ray patch, white,
    with jitter) on ``device``: single-prompt (``prompts`` None) or
    multi-prompt; t = MULTI_T[:P] and ``noise`` injected; with ``cpu`` (the
    CPU's record) the card's SDS gradient is also computed on the CPU's
    images, and phase B runs on the CPU's gradient. Records the gradient and
    the updated value of every MLP and variance leaf and of the table
    (gathered and reduce-scattered by the table kernels)."""
    params, fcfg = field(device)
    toy, tcfg, embs = load_toy_guidance(TOY_DIR, device)
    guide = SDSGuidance(make_toy_modules(toy, tcfg, embs))
    cfg = StylizeConfig(tgt_text="lava", augment_bkg=False, coarse_epochs=1, fine_epochs=0, **PARITY_SMALL_VIEW)
    rec = {}
    if prompts is None:
        trainer = StylizeTrainer(cfg, fcfg, guide, params, params)
        name, t = "sds_image_grad", SDS_T
    else:
        trainer = MultiPromptTrainer(cfg, fcfg, guide, prompts, stack_params([params] * len(prompts)), params)
        name, t = "sds_image_grad_batch", MULTI_T[: len(prompts)]
    sds = getattr(guide, name)

    def injected(emb, img, gs, pred_depth=None, **kw):
        rec["img"] = img.cpu()
        g = sds(emb, img, gs, t_override=t, noise_override=noise.to(device))
        rec["g"] = g.cpu()
        if cpu is None:
            return g
        rec["g_same_img"] = sds(emb, cpu["img"].to(device), gs, t_override=t, noise_override=noise.to(device)).cpu()
        return cpu["g"].to(device)

    setattr(guide, name, injected)
    poses, descs = trainer.epoch_poses(0)
    i = int(trainer.rng.permutation(len(poses))[0])
    with _cpu_jitter():
        rec["loss"] = trainer.train_view(poses[i], descs[i], 0).reshape(-1).cpu()
    fields = [(trainer.rest, trainer.shards)] if prompts is None else [(r, s) for r, s, _ in trainer.fields]
    rec["grad"], rec["params"] = {}, {}
    for p, (rest, shards) in enumerate(fields):
        for k, leaf in _mlp_leaves(rest).items():
            rec["grad"][(p, k)] = trainer.opt.state[leaf]["exp_avg"].cpu() / 0.1
            rec["params"][(p, k)] = leaf.detach().cpu()
        rec["grad"][(p, "table")] = torch.cat([trainer.opt.state[s]["exp_avg"] for s in shards]).cpu() / 0.1
        rec["params"][(p, "table")] = torch.cat([s.detach() for s in shards]).cpu()
    return rec


def _hold_step_card_vs_cpu(what: str, card: dict, cpu: dict) -> None:
    """stylize_card_vs_cpu's bounds on one step's records (every MLP leaf
    and the table at TRAIN_GRAD_REL), the variance's gradient at
    PARITY_VARIANCE_GRAD_REL."""
    img_err = float((card["img"] - cpu["img"]).abs().max())
    sds_err = float((card["g_same_img"] - cpu["g"]).abs().max())
    loss_rel = float(((card["loss"] - cpu["loss"]).abs() / cpu["loss"].abs()).max())
    per_leaf = {f"{p}.{k}": float((card["grad"][(p, k)] - g).abs().max() / g.abs().max()) if g.any()
                else float(card["grad"][(p, k)].abs().max()) for (p, k), g in cpu["grad"].items()}
    grad_rel = max(v for k, v in per_leaf.items() if not k.endswith(".variance"))
    var_rel = max(v for k, v in per_leaf.items() if k.endswith(".variance"))
    table_rel = max(v for k, v in per_leaf.items() if k.endswith(".table"))
    per_leaf = {k: round(v, 6) for k, v in per_leaf.items() if v > 1e-3}
    lr = StylizeConfig().lr
    big_err, any_err = 0.0, 0.0
    for k, g in cpu["grad"].items():
        d = (card["params"][k] - cpu["params"][k]).abs()
        big = g.abs() > 1e-2 * g.abs().max()
        big_err = max(big_err, float(d[big].max()) if big.any() else 0.0)
        any_err = max(any_err, float(d.max()))
    print(f"{what}, card vs CPU: phase A {img_err:.3g} (atol {CARD_VS_CPU_ATOL}); SDS gradient of one image "
          f"{sds_err:.3g} (atol {SDS_ATOL:.3g}), max |g| {float(cpu['g'].abs().max()):.3g}; losses "
          f"{card['loss'].tolist()} / {cpu['loss'].tolist()} (rel {loss_rel:.3g}, rtol {TRAIN_LOSS_RTOL}); MLP and "
          f"table gradients {grad_rel:.3g} x max|g| (tolerance {TRAIN_GRAD_REL}; the table's {table_rel:.3g}), the "
          f"variance's {var_rel:.3g} (tolerance {PARITY_VARIANCE_GRAD_REL}), leaves above 1e-3 "
          f"{json.dumps(per_leaf)}; updated parameters {big_err:.3g} where |g| > 1e-2 max|g| (atol 1e-6), "
          f"{any_err:.3g} elsewhere (atol {2 * lr})",
          flush=True)
    if not (img_err <= CARD_VS_CPU_ATOL and sds_err <= SDS_ATOL):
        raise AssertionError(f"{what}: the guidance or phase A differ")
    if not (torch.isfinite(card["loss"]).all() and loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_REL
            and var_rel <= PARITY_VARIANCE_GRAD_REL):
        raise AssertionError(f"{what}: phase B differs")
    if not (big_err <= 1e-6 and any_err <= 2 * lr):
        raise AssertionError(f"{what}: the Adam step differs")


def check_parity_card_vs_cpu(root: str) -> None:
    """One parity SDS step (single prompt) and one multi-prompt step at
    P = 2 of the reduced-width field, then one parity SDS step of the
    reconstruct phase's hash-grid field (its table at the CLIs' default
    size, f32 tables), stage by stage from the same inputs and the same
    jitter on the card and the CPU, at stylize_card_vs_cpu's and
    multi_card_vs_cpu's bounds."""

    def small(device):
        return _small_parity_field(device), PARITY_SMALL_FCFG

    def hash_grid(device):
        params, fcfg = load_params_with_config(recon_parity_checkpoint(root), device)
        if fcfg.encoder != "hashgrid" or params["table"].shape != (HASH_ROWS, HASH_COLS):
            raise AssertionError(f"the reconstruct phase's field: {fcfg.encoder} {tuple(params['table'].shape)}")
        return params, dataclasses.replace(fcfg, packed_dtype="float32")

    gen = torch.Generator().manual_seed(4)
    for what, field, prompts in (("parity SDS step", small, None),
                                 ("parity multi step, P = 2", small, ["lava", "emerald"]),
                                 ("hash-grid parity SDS step", hash_grid, None)):
        noise = torch.randn((1 if prompts is None else len(prompts), 3, 64, 64), generator=gen)
        cpu = _parity_step_record("cpu", field, noise, prompts)
        card = _parity_step_record("cuda", field, noise, prompts, cpu)
        _hold_step_card_vs_cpu(what, card, cpu)


# -- multirank: K10 across ranks, the dryrun twin, full-width runs over a mesh --

# the table shapes of the cross-rank kernels: the 128^3 x 4 grid table and the
# hash table padded to a multiple of the rank count (6,119,857 rows is odd);
# the all-reduce's vector at each: the table's floats, the hash table's
# unpadded (no n of 2 or 4 divides 12,239,714, so its blocks carry padding)
MULTIRANK_SIZES = (2, 4)
MULTIRANK_CALLS = 200  # back-to-back calls whose shards change every call
MULTIRANK_GRAPH_CALLS, MULTIRANK_REPLAYS = 3, 4  # calls of each kernel in one CUDA graph, its replays
MULTIRANK_TRAIN_BATCH, MULTIRANK_TRAIN_STEPS = 1600, 3
MULTIRANK_SCAN_STEPS, MULTIRANK_SCAN_TOTAL = 5, 10  # train_fast --scan_steps over 2 ranks: 2 calls
MULTIRANK_TABLE_MP_RES = 32  # 1024 rays of bench camera 0, as check_table_mp
# a fast train step, 2 ranks against 1 process, 3 steps at full width: the
# losses; a table-MP step, n ranks against 1: the loss and the table
# gradient per max|g|, its rows' cotangents summed per rank, then over the
# ranks in rank order, where one process sums them in one pass (measured
# on an H100: the losses bitwise, the table gradient within 1.67e-4 and
# 2.09e-4 x max|g| at 2 and 4 ranks)
MULTIRANK_LOSS_RTOL = 1e-4
MULTIRANK_GRAD_REL = 1e-3
# the canonical CLI over 2 ranks against 1: the PNGs' 8-bit levels
MULTIRANK_CLI_LEVELS = 1
MULTIRANK_CLI_RES, MULTIRANK_CLI_ORBIT = 256, 1
PEER_KERNELS = (ring.PEER_GATHER, ring.PEER_RS, ring.PEER_AR)
MULTIRANK_STREAM_ITERS = 20


def _table_shapes(n: int):
    hash_rows = -(-HASH_ROWS // n) * n
    return ((GRID_ROWS, GRID_COLS), (hash_rows, HASH_COLS))


def _vector_sizes():
    return (GRID_ROWS * GRID_COLS, HASH_ROWS * HASH_COLS)


def _seeded(shape, seed: int) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator("cuda").manual_seed(seed), device="cuda")


def _peer_bytes(n: int, rows: int, cols: int, numel: int) -> tuple:
    """(bound, design) bytes of each cross-rank kernel over all n ranks
    through one HBM. The bound: each input read once, each output written
    once: the gather reads the n shards and writes n tables ((n + n^2) S F
    4), the reduce-scatter reads the n cotangents and writes n blocks
    ((n^2 + n) S F 4), the all-reduce reads n vectors and writes n (2 n N
    4). The design also stages each input of the gather and the
    reduce-scatter in its buffer (a read and a write) and reads what the
    body reads: each rank all n shards (gather), block r of each cotangent
    (reduce-scatter); the all-reduce reads the n input blocks, writes its
    sum block and reads the n sum blocks."""
    S = rows // n
    block = ring.all_reduce_bytes(numel, n) // (4 * (n + 1))
    need = {ring.PEER_GATHER: (n + n * n) * S * cols * 4, ring.PEER_RS: (n * n + n) * S * cols * 4,
            ring.PEER_AR: 2 * n * numel * 4}
    design = {ring.PEER_GATHER: n * (2 * S + 2 * n * S) * cols * 4,
              ring.PEER_RS: n * (2 * n * S + n * S + S) * cols * 4,
              ring.PEER_AR: n * (2 * n * block + block + numel) * 4}
    return need, design


class _Held:
    """Each kernel's differing elements and largest |kernel - plain|, kept
    on the card over many calls and read once."""

    def __init__(self):
        self.differ = {k: torch.zeros((), dtype=torch.int64, device="cuda") for k in PEER_KERNELS}
        self.err = {k: torch.zeros((), device="cuda") for k in PEER_KERNELS}

    def hold(self, name, got, want) -> None:
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}, plain {want.dtype} {tuple(want.shape)}")
        self.differ[name] += (got.view(torch.int32) != want.view(torch.int32)).sum()
        torch.maximum(self.err[name], (got - want).abs().max(), out=self.err[name])

    def check(self, what: str) -> None:
        torch.cuda.synchronize()
        ring.check_peer_error()
        for name in self.differ:
            if int(self.differ[name]):
                raise AssertionError(f"{name} != its plain version: {what}, {int(self.differ[name])} elements "
                                     f"differ, max |diff| {float(self.err[name])}")


def _rank_order_sum(parts) -> torch.Tensor:
    """The tensors summed in rank order, in f32 (the plain versions' order)."""
    total = parts[0].clone()
    for part in parts[1:]:
        total += part
    return total


def _all_reduce_owned(x: torch.Tensor, mesh) -> torch.Tensor:
    """The gradients' route: the input written into the all-reduce's own
    buffer, then the call, which stages nothing."""
    inp = ring.all_reduce_input(x.numel(), mesh)
    inp.copy_(x)
    return ring.ring_all_reduce(inp, mesh)


def _peer_inputs(mesh, rows: int, cols: int, numel: int, seed: int) -> tuple:
    """Rank r's seeded inputs of one call of each cross-rank kernel: its
    [S, F] shard, its [n S, F] cotangent, its [numel] vector."""
    n, r = mesh.size, mesh.rank
    return (_seeded((rows // n, cols), seed + r), _seeded((rows, cols), seed + 32 + r),
            _seeded((numel,), seed + 48 + r))


def _hold_peer(mesh, held: _Held, outs, rows: int, cols: int, numel: int, seed: int) -> None:
    """The outputs of one call of each cross-rank kernel on ``_peer_inputs``
    of ``seed``, held against the plain versions computed here from every
    rank's seeds (a rank can draw its peers' inputs: no collective in the
    check)."""
    n, r = mesh.size, mesh.rank
    held.hold(ring.PEER_GATHER, outs[0], torch.cat([_seeded((rows // n, cols), seed + p) for p in range(n)]))
    held.hold(ring.PEER_RS, outs[1], _rank_order_sum([_seeded((rows, cols), seed + 32 + p).chunk(n)[r]
                                                      for p in range(n)]))
    held.hold(ring.PEER_AR, outs[2], _rank_order_sum([_seeded((numel,), seed + 48 + p) for p in range(n)]))


def _peer_graph_checks(mesh, rows: int, cols: int, numel: int) -> dict:
    """MULTIRANK_GRAPH_CALLS calls of each cross-rank kernel captured into
    one CUDA graph (their buffers made by the eager calls before), replayed
    MULTIRANK_REPLAYS times, the static inputs new before every replay and
    the outputs held bitwise after it. Returns the launches one replay
    makes."""
    n, K = mesh.size, MULTIRANK_GRAPH_CALLS
    S = rows // n
    ins = [(torch.empty((S, cols), device="cuda"), torch.empty((rows, cols), device="cuda"),
            torch.empty(numel, device="cuda")) for _ in range(K)]
    before = dict(ring.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [(ring.ring_all_gather(a, mesh), ring.ring_reduce_scatter(b, mesh), _all_reduce_owned(c, mesh))
                for a, b, c in ins]
    per_replay = {name: ring.launches[name] - before[name] for name in before}
    ring.launches.update(before)  # a capture records its launches and runs none
    want = {name: (K if name in PEER_KERNELS else 0) for name in before}
    if per_replay != want:
        raise AssertionError(f"the graph of {K} calls of each cross-rank kernel records {per_replay}, not {want}")
    held = _Held()
    for rep in range(MULTIRANK_REPLAYS):
        seeds = [((rows * 7 + 100_000 + rep * K + k) * 64) for k in range(K)]
        for seed, static in zip(seeds, ins):
            for dst, src in zip(static, _peer_inputs(mesh, rows, cols, numel, seed)):
                dst.copy_(src)
        graph.replay()
        for seed, out in zip(seeds, outs):
            _hold_peer(mesh, held, out, rows, cols, numel, seed)
    held.check(f"n={mesh.size} [{rows},{cols}], {MULTIRANK_REPLAYS} replays of a graph of {K} calls each")
    return per_replay


def _peer_kernel_checks(mesh) -> dict:
    """The three cross-rank kernels over MULTIRANK_CALLS back-to-back calls
    at both shapes, each call's inputs new, bitwise against their plain
    versions (``_hold_peer``): the differing elements and the largest
    |kernel - plain| are summed and kept on the card over the calls and
    read once a shape; at the grid table also a CUDA graph of calls
    replayed (``_peer_graph_checks``). Then the times, the ranks' contexts
    taking turns on the one card."""
    import torch.distributed as dist

    n, r = mesh.size, mesh.rank
    out = {}
    for (rows, cols), numel in zip(_table_shapes(n), _vector_sizes()):
        S = rows // n
        t0 = time.perf_counter()
        held = _Held()
        for k in range(MULTIRANK_CALLS):  # the all-reduce's input in its buffer on even calls, its own on odd
            seed = (rows * 7 + k) * 64
            shard, ct, x = _peer_inputs(mesh, rows, cols, numel, seed)
            outs = (ring.ring_all_gather(shard, mesh), ring.ring_reduce_scatter(ct, mesh),
                    _all_reduce_owned(x, mesh) if k % 2 == 0 else ring.ring_all_reduce(x, mesh))
            _hold_peer(mesh, held, outs, rows, cols, numel, seed)
        held.check(f"n={n} [{rows},{cols}], {MULTIRANK_CALLS} calls")
        if rows == GRID_ROWS:
            _peer_graph_checks(mesh, rows, cols, numel)
        checked_s = time.perf_counter() - t0
        shard, ct, x = _seeded((S, cols), 11 + r), _seeded((rows, cols), 13 + r), _seeded((numel,), 17 + r)
        gathered = torch.empty((rows, cols), device="cuda")
        reduced, summed = ct.clone(), x.clone()
        inp = ring.all_reduce_input(numel, mesh)
        inp.copy_(x)  # the first call's input; later calls sum what the calls left (timing only)
        fns = {
            ring.PEER_GATHER: (lambda: ring.ring_all_gather(shard, mesh), lambda: ring.ring_all_gather_plain(shard, mesh),
                               lambda: dist.all_gather_into_tensor(gathered, shard, group=mesh.group)),
            ring.PEER_RS: (lambda: ring.ring_reduce_scatter(ct, mesh), lambda: ring.ring_reduce_scatter_plain(ct, mesh),
                           lambda: dist.all_reduce(reduced, group=mesh.group)),
            ring.PEER_AR: (lambda: ring.ring_all_reduce(inp, mesh), lambda: ring.ring_all_reduce_plain(x, mesh),
                           lambda: dist.all_reduce(summed, group=mesh.group)),
        }
        need, design = _peer_bytes(n, rows, cols, numel)
        t = {}
        for name, (fn, plain, library) in fns.items():
            t[name] = {
                "max_abs_err": float(held.err[name]),
                "kernel_ms": cuda_ms(fn, iters=10, warmup=2),
                "kernel_cold_ms": cuda_ms_cold(fn, iters=5, warmup=1),
                "plain_ms": cuda_ms(plain, iters=3, warmup=1),
                "library_ms": cuda_ms(library, iters=3, warmup=1),
                "bound_ms": need[name] / HBM_BYTES_PER_S * 1e3,
                "design_bound_ms": design[name] / HBM_BYTES_PER_S * 1e3,
            }
        ring.check_peer_error()
        out[f"{rows}x{cols}"] = t
        if r == 0:
            print(f"multirank n={n} [{rows},{cols}] (all-reduce of {numel} floats): the three kernels bitwise over "
                  f"{MULTIRANK_CALLS} calls" + (f" and {MULTIRANK_REPLAYS} replays of a graph of "
                                                f"{MULTIRANK_GRAPH_CALLS} calls each" if rows == GRID_ROWS else "")
                  + f" ({checked_s:.1f} s), timed in {time.perf_counter() - t0 - checked_s:.1f} s", flush=True)
    return out


def _train_losses(ds, fcfg, fast_cfg, mesh=None) -> tuple:
    """The fast trainer's losses and its steps/s (timed from the end of the
    first step)."""
    cfg = reconstruct.ReconstructConfig(batch_size=MULTIRANK_TRAIN_BATCH)
    _, _, stats = reconstruct.train_fast(ds, fcfg, fast_cfg, cfg, max_steps=MULTIRANK_TRAIN_STEPS, log_every=1,
                                         grid_update_every=0, device="cuda", mesh=mesh)
    return [loss for _, loss in stats["losses"]], stats["steps_per_sec"]


def _scan_run(ds, fcfg, fast_cfg, mesh=None, graph: bool = True) -> tuple:
    """train_fast with --scan_steps MULTIRANK_SCAN_STEPS for
    MULTIRANK_SCAN_TOTAL steps at batch 1600: (the calls' logged losses,
    the final tree, steps/s timed from the end of the first call). With
    ``graph`` False the same capturable step is taken eagerly
    (``reconstruct.graphed`` answers False for the run)."""
    cfg = reconstruct.ReconstructConfig(batch_size=MULTIRANK_TRAIN_BATCH)
    graphed = reconstruct.graphed
    if not graph:
        reconstruct.graphed = lambda device: False
    try:
        params, _, stats = reconstruct.train_fast(
            ds, fcfg, fast_cfg, cfg, max_steps=MULTIRANK_SCAN_TOTAL, scan_steps=MULTIRANK_SCAN_STEPS, log_every=1,
            grid_update_every=0, device="cuda", mesh=mesh)
    finally:
        reconstruct.graphed = graphed
    return [loss for _, loss in stats["losses"]], params, stats["steps_per_sec"]


def _gloo_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """gloo's host-staged all-reduce, the mesh's sums before the port's
    kernel: a yardstick of the eager step, never the port's path."""
    import torch.distributed as dist

    out = x.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def _scan_over_ranks(mesh, ds, fcfg, fast_cfg, counts: dict, seconds: dict) -> dict:
    """The graphed scan over the mesh and its eager twin (bitwise), each
    counted as a path, then 3 eager steps with the sums through gloo (not
    counted): losses and steps/s."""
    t0 = time.perf_counter()
    _reset_launches()
    losses, params, rate = _scan_run(ds, fcfg, fast_cfg, mesh)
    counts["train_fast_scan"] = dict(ring.launches)
    _reset_launches()
    e_losses, e_params, e_rate = _scan_run(ds, fcfg, fast_cfg, mesh, graph=False)
    counts["train_fast_scan_eager"] = dict(ring.launches)
    same = losses == e_losses and all(torch.equal(a, b) for a, b in zip(leaves(params), leaves(e_params)))
    if not same:
        raise AssertionError(f"the graphed scan over {mesh.size} ranks differs from the same steps taken eagerly: "
                             f"losses {losses} against {e_losses}")
    del params, e_params
    seconds["train_fast_scan"], t0 = time.perf_counter() - t0, time.perf_counter()
    kernel_sum = ring.ring_all_reduce
    ring.ring_all_reduce = _gloo_all_reduce
    try:
        gloo_losses, gloo_rate = _train_losses(ds, fcfg, fast_cfg, mesh)
    finally:
        ring.ring_all_reduce = kernel_sum
    seconds["train_fast_gloo"] = time.perf_counter() - t0
    return {"losses": losses, "rate": rate, "eager_rate": e_rate, "gloo_losses": gloo_losses, "gloo_rate": gloo_rate}


def _table_mp_run(mesh):
    """One table-parallel SGD step on the artifact, the table row-sharded
    over ``mesh`` (one shard in one process): the loss and the table's
    gradient."""
    params, fcfg, grid, fast_cfg = bench.load_artifact("cuda")
    res = MULTIRANK_TABLE_MP_RES
    ro, rd = pose2rays(res, res, bench.bench_poses()[0], device="cuda")
    gt = make_fast_frame_renderer(params, fcfg, fast_cfg, grid, chunk=res * res)(ro, rd)["rgb"]
    sgd = lambda ps: torch.optim.SGD(ps, lr=0.5)  # noqa: E731
    step = TableMPTrainStep(params, mesh, fcfg, RenderConfig(perturb=False), sgd)
    rows = mesh_lib.data_sharding(mesh, res * res)
    loss = step(ro[rows], rd[rows], gt[rows])
    return float(loss), mesh_lib.all_gather_rows_of(step.shards[0].grad, mesh).cpu()


def _multirank_rank(mesh, ds, fcfg, fast_cfg, with_dryrun: bool) -> dict:
    """One rank of a multirank launch: the kernel checks and times (their
    launches not counted), then the paths, each counted from 0; the wall
    seconds of each part."""
    seconds, t0 = {"entered": time.time()}, time.perf_counter()
    out = {"kernels": _peer_kernel_checks(mesh)}
    seconds["kernels"] = time.perf_counter() - t0
    counts = {}
    if with_dryrun:
        t0 = time.perf_counter()
        dry = dryrun.run_paths(mesh, dryrun.default_inputs(mesh.size))
        if not dry["results"]["scan"]["graphed"]:
            raise AssertionError("the dryrun's scan path did not run its CUDA graph on the card")
        counts.update({f"dryrun.{p}": c for p, c in dry["launches"].items()})
        seconds["dryrun"], t0 = time.perf_counter() - t0, time.perf_counter()
        _reset_launches()
        out["train_losses"] = _train_losses(ds, fcfg, fast_cfg, mesh)
        counts["train_fast"] = dict(ring.launches)
        seconds["train_fast"] = time.perf_counter() - t0
        out["scan"] = _scan_over_ranks(mesh, ds, fcfg, fast_cfg, counts, seconds)
    t0 = time.perf_counter()
    _reset_launches()
    out["table_mp"] = _table_mp_run(mesh)
    counts["table_mp"] = dict(ring.launches)
    seconds["table_mp"] = time.perf_counter() - t0
    ring.check_peer_error()
    seconds["left"] = time.time()
    out["launches"], out["seconds"] = counts, seconds
    return out


def _cli_frames(sampler: str, n: int, out_dir: str) -> dict:
    argv = ["--weights_path", bench.ARTIFACT_CKPT, "--sampler", sampler, "--render_h", str(MULTIRANK_CLI_RES),
            "--render_w", str(MULTIRANK_CLI_RES), "--trajectory_resolution", str(MULTIRANK_CLI_ORBIT),
            "--out_dir", out_dir, "--exp_name", f"{sampler}{n}", "--mesh_devices", str(n)]
    if sampler == "fast":
        argv += ["--grid_path", bench.ARTIFACT_GRID]
    t0 = time.perf_counter()
    render_canonical_cli.main(argv)
    seconds = time.perf_counter() - t0
    exp = os.path.join(out_dir, "canonical_360", f"{sampler}{n}")
    pngs = sorted(f for f in os.listdir(exp) if f.endswith(".png"))
    if len(pngs) != 2 * MULTIRANK_CLI_ORBIT or len([f for f in os.listdir(exp) if f.endswith(".gif")]) != 2:
        raise AssertionError(f"the canonical CLI at --mesh_devices {n} wrote {sorted(os.listdir(exp))}")
    return {"seconds": seconds, "frames": [read_png(os.path.join(exp, f)) for f in pngs]}


def _streams_call(name: str, bufs, outs, ins, count: int, streams) -> None:
    """One call of ``name`` by the n ranks of a local group, rank r's on
    ``streams[r]``, all after the current stream's work and joined back
    into it."""
    start = torch.cuda.current_stream()
    for buf, out, inp, stream in zip(bufs, outs, ins, streams):
        stream.wait_stream(start)
        with torch.cuda.stream(stream):
            ring._launch_peer(name, buf, out, count, inp)
    for stream in streams:
        start.wait_stream(stream)


def _streams_times() -> dict:
    """Each cross-rank kernel with n ranks as n streams of this process
    (one context: the ranks' blocks co-resident; ``ring.local_peer_group``)
    at both shapes: one call held bitwise against its plain version, then
    CUDA events around MULTIRANK_STREAM_ITERS calls, each from the event
    before the first rank's launch to the last rank's end, beside bound_ms,
    design_bound_ms and a one-process library yardstick of the same bytes:
    torch.cat of the n shards n times (every rank's table), torch.stack of
    the n cotangents summed (every rank's block), torch.stack of the n
    vectors summed. {n: {shape: {kernel: record}}}."""
    out = {}
    for n in MULTIRANK_SIZES:
        streams = [torch.cuda.Stream() for _ in range(n)]
        out[n] = {}
        for (rows, cols), numel in zip(_table_shapes(n), _vector_sizes()):
            S = rows // n
            need, design = _peer_bytes(n, rows, cols, numel)
            shards = [_seeded((S, cols), 300 + p) for p in range(n)]
            cts = [_seeded((rows, cols), 400 + p) for p in range(n)]
            xs = [_seeded((numel,), 500 + p) for p in range(n)]
            cases = {
                ring.PEER_GATHER: (ring.staged_bytes(S * cols * 4), shards, (rows, cols), S * cols * 4,
                                   [torch.cat(shards)] * n, lambda: [torch.cat(shards) for _ in range(n)]),
                ring.PEER_RS: (ring.staged_bytes(rows * cols * 4), cts, (S, cols), S * cols,
                               [_rank_order_sum([ct.chunk(n)[r] for ct in cts]) for r in range(n)],
                               lambda: torch.stack(cts).sum(0)),
                ring.PEER_AR: (ring.all_reduce_bytes(numel, n), [None] * n, (numel,), numel,
                               [_rank_order_sum(xs)] * n, lambda: torch.stack(xs).sum(0)),
            }
            rec = {}
            for name, (nbytes, ins, out_shape, count, plain, library) in cases.items():
                bufs = ring.local_peer_group(n, nbytes)
                outs = [torch.empty(out_shape, device="cuda") for _ in range(n)]
                if name == ring.PEER_AR:
                    for buf, x in zip(bufs, xs):
                        buf.view(numel).copy_(x)
                call = lambda: _streams_call(name, bufs, outs, ins, count, streams)  # noqa: E731
                call()
                torch.cuda.synchronize()
                ring.check_peer_error()
                for r, (got, want) in enumerate(zip(outs, plain)):
                    if not _same_bits(got, want):
                        raise AssertionError(f"{name} as {n} streams, rank {r}: not bitwise its plain version, max "
                                             f"|diff| {float((got - want).abs().max())}")
                rec[name] = {"kernel_ms": cuda_ms(call, iters=MULTIRANK_STREAM_ITERS, warmup=2),
                             "bound_ms": need[name] / HBM_BYTES_PER_S * 1e3,
                             "design_bound_ms": design[name] / HBM_BYTES_PER_S * 1e3,
                             "library_ms": cuda_ms(library, iters=MULTIRANK_STREAM_ITERS, warmup=2)}
                rec[name]["share_of_bound"] = rec[name]["bound_ms"] / rec[name]["kernel_ms"]
                ring.free_local_group(bufs)
            out[n][f"{rows}x{cols}"] = rec
            del shards, cts, xs
    return out


def check_multirank() -> tuple:
    """K10 across ranks and the port's all-reduce on the one card (2 and 4
    ranks, time-sliced; then as streams of this process), the dryrun
    twin's 8 paths over 2 ranks, the canonical CLI at --mesh_devices 2
    under both samplers, the fast trainer at batch 1600 over 2 ranks per
    step and as a graphed scan, and the table-parallel step row-sharded 2
    and 4 ways, each against one process. Returns (the kernels' records,
    the path's launches)."""
    ds, fcfg, normal_mode = profile_train.artifact_image_set("cuda")
    fast_cfg = FastRenderConfig(normal_mode=normal_mode)
    runs = {}
    for n in MULTIRANK_SIZES:
        t0 = time.time()
        runs[n] = mesh_lib.launch(_multirank_rank, n, ds, fcfg, fast_cfg, n == 2, device="cuda", timeout_s=600)
        t1, sec = time.time(), dict(runs[n][0]["seconds"])
        entered, left = sec.pop("entered"), sec.pop("left")
        parts = ", ".join(f"{k} {v:.1f} s" for k, v in sec.items())
        print(f"multirank: the {n}-rank launch took {t1 - t0:.1f} s: rank 0 entered its function after "
              f"{entered - t0:.1f} s ({parts}); {t1 - left:.1f} s from its return to the launch's end", flush=True)
    # the kernels: bitwise in every call and replay (raised inside otherwise); times of rank 0
    for n, ranks in runs.items():
        for shape, t in ranks[0]["kernels"].items():
            print(f"multirank n={n} [{shape}] f32 ({card_line()}, {n} processes: contexts taking turns on one "
                  "card): " + json.dumps(t), flush=True)
    print(f"multirank: the three cross-rank kernels bitwise equal to their plain versions over {MULTIRANK_CALLS} "
          f"changing calls at n = {list(MULTIRANK_SIZES)}, both shapes, and over {MULTIRANK_REPLAYS} replays of a "
          "CUDA graph", flush=True)

    # the dryrun's paths ran inside (each check raises; path 4 graphed)
    two = runs[2]
    # every rank made the same calls; the sums are the path's launches
    total = {name: 0 for name in ring.launches}
    for n, ranks in runs.items():
        for r, rank in enumerate(ranks):
            if rank["launches"] != ranks[0]["launches"]:
                raise AssertionError(f"n={n}: rank {r}'s launches {rank['launches']} differ from rank 0's")
            print(f"multirank n={n} rank {r} launches: {json.dumps(rank['launches'])}", flush=True)
            for counts in rank["launches"].values():
                for name, c in counts.items():
                    total[name] += c
    for n, ranks in runs.items():
        per_rank = ranks[0]["launches"]["table_mp"]
        if (per_rank[ring.PEER_GATHER], per_rank[ring.PEER_RS], per_rank[ring.PEER_AR]) != (1, 1, 4):
            raise AssertionError(f"table_mp n={n}: a step makes 1 gather, 1 reduce-scatter and 4 all-reduces (3 "
                                 f"loss sums, the gradients) a rank, counted {per_rank}")
    # train_fast replicates its parameters over the mesh: the one-card table
    # kernels, and 4 all-reduces a step (3 loss sums, the gradients)
    for path, steps in (("train_fast", MULTIRANK_TRAIN_STEPS), ("train_fast_scan", MULTIRANK_SCAN_TOTAL),
                        ("train_fast_scan_eager", MULTIRANK_SCAN_TOTAL)):
        want = {ring.KERNEL: steps + 1, ring.RS_KERNEL: steps, ring.PEER_GATHER: 0, ring.PEER_RS: 0,
                ring.PEER_AR: 4 * steps}
        if two[0]["launches"][path] != want:
            raise AssertionError(f"{path} over 2 ranks: {steps} steps and the final tree make {want} a rank, "
                                 f"counted {two[0]['launches'][path]}")

    # the fast trainer at full width: 2 ranks against one process
    t0 = time.perf_counter()
    losses1, rate1 = _train_losses(ds, fcfg, fast_cfg)
    losses2, rate2 = two[0]["train_losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses2, losses1))
    print(f"train_fast batch {MULTIRANK_TRAIN_BATCH}: 2 ranks {losses2}, one process {losses1}, max relative "
          f"{rel:.3g} (bound {MULTIRANK_LOSS_RTOL}); {rate2:.3f} steps/s over 2 ranks sharing the card, "
          f"{rate1:.3f} in one process", flush=True)
    if len(losses2) != MULTIRANK_TRAIN_STEPS or not rel <= MULTIRANK_LOSS_RTOL:
        raise AssertionError("train_fast over 2 ranks differs from one process")
    # the graphed scan: 2 ranks (bitwise their eager twin, held inside) against one process
    scan = two[0]["scan"]
    s_losses1, _, s_rate1 = _scan_run(ds, fcfg, fast_cfg)
    s_rel = max(abs(a - b) / abs(b) for a, b in zip(scan["losses"], s_losses1))
    print(f"train_fast --scan_steps {MULTIRANK_SCAN_STEPS}, {MULTIRANK_SCAN_TOTAL} steps at batch "
          f"{MULTIRANK_TRAIN_BATCH} ({card_line()}): 2 ranks graphed {scan['losses']} == the eager scan's bitwise, "
          f"one process {s_losses1}, max relative {s_rel:.3g} (bound {dryrun.GRAD_REL}); steps/s over 2 ranks "
          f"sharing the card: graphed {scan['rate']:.3f}, the scan eager {scan['eager_rate']:.3f}, per step with "
          f"the kernels {rate2:.3f}, per step with gloo's sums {scan['gloo_rate']:.3f} (losses "
          f"{scan['gloo_losses']}); one process graphed {s_rate1:.3f}", flush=True)
    if len(scan["losses"]) != len(s_losses1) or not s_rel <= dryrun.GRAD_REL:
        raise AssertionError("the graphed scan over 2 ranks differs from one process")

    # table-MP at full width: n ranks against one process
    loss1, grad1 = _table_mp_run(mesh_lib.one_rank("cuda"))
    scale = float(grad1.abs().max())
    for n, ranks in runs.items():
        loss, grad = ranks[0]["table_mp"]
        lrel, grel = abs(loss - loss1) / abs(loss1), float(np.max(np.abs(grad - grad1.numpy()))) / scale
        print(f"table_mp over {n} ranks: loss {loss:.9g} against {loss1:.9g} (relative {lrel:.3g}), table "
              f"gradient within {grel:.3g} x max|g| (bounds {MULTIRANK_LOSS_RTOL}, {MULTIRANK_GRAD_REL})", flush=True)
        if not (lrel <= MULTIRANK_LOSS_RTOL and grel <= MULTIRANK_GRAD_REL):
            raise AssertionError(f"table_mp over {n} ranks differs from one process")

    print(f"multirank: the one-process train_fast, scan and table-MP runs took {time.perf_counter() - t0:.1f} s",
          flush=True)

    # the canonical CLI over 2 ranks against one process, both samplers; the
    # two 2-rank runs at once, so that their ranks start together (4
    # processes sharing the card: their seconds are not one run's)
    t0 = time.perf_counter()
    samplers = ("parity", "fast")
    with tempfile.TemporaryDirectory(prefix="multirank_cli_") as out_dir:
        one = {sampler: _cli_frames(sampler, 1, out_dir) for sampler in samplers}
        with concurrent.futures.ThreadPoolExecutor(len(samplers)) as pool:
            pending = {sampler: pool.submit(_cli_frames, sampler, 2, out_dir) for sampler in samplers}
            two_cli = {sampler: f.result() for sampler, f in pending.items()}
    for sampler in samplers:
        pairs = list(zip(one[sampler]["frames"], two_cli[sampler]["frames"]))
        diffs = [int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) for a, b in pairs]
        same = sum(np.array_equal(a, b) for a, b in pairs)
        print(f"canonical CLI --sampler {sampler} at {MULTIRANK_CLI_RES}^2: --mesh_devices 2 "
              f"{two_cli[sampler]['seconds']:.2f} s (both samplers' runs at once), one process "
              f"{one[sampler]['seconds']:.2f} s; {same} of {len(diffs)} PNGs bitwise equal, max level difference "
              f"{max(diffs)} (bound {MULTIRANK_CLI_LEVELS})", flush=True)
        if max(diffs) > MULTIRANK_CLI_LEVELS:
            raise AssertionError(f"the {sampler} frames over 2 ranks differ from one process's")
    print(f"multirank: the CLI runs took {time.perf_counter() - t0:.1f} s", flush=True)

    # the three kernels as n ranks on n streams of this process
    t0 = time.perf_counter()
    streams = _streams_times()
    for n, shapes in streams.items():
        for shape, rec in shapes.items():
            print(f"multirank as streams n={n} [{shape}] f32 ({card_line()}, {n} ranks on {n} streams of one "
                  "process, bitwise their plain versions): " + json.dumps(rec), flush=True)
    print(f"multirank: the streams timings took {time.perf_counter() - t0:.1f} s", flush=True)

    # the kernels line: the ranks-as-streams times at n = 2 on the grid table
    # (ms, its bound and library yardstick), the turns of n = 2 processes
    # (plain_ms, the multi-process record), the largest |kernel - plain| over
    # every call, shape, rank and rank count
    grid = f"{GRID_ROWS}x{GRID_COLS}"
    kernels = {}
    for key in PEER_KERNELS:
        turns = two[0]["kernels"][grid][key]
        kernels[key] = {
            **streams[2][grid][key],
            "plain_ms": turns["plain_ms"],
            "max_abs_err": max(rank["kernels"][shape][key]["max_abs_err"]
                               for ranks in runs.values() for rank in ranks for shape in rank["kernels"]),
            "streams": {f"n={n} [{shape}]": rec[key] for n, shapes in streams.items() for shape, rec in shapes.items()},
            "turns": {f"n={n} [{shape}]": t[key] for n, ranks in runs.items() for shape, t in ranks[0]["kernels"].items()},
        }
    return kernels, total


# -- the legacy models, the hybrid render and the orbax reader ---------------

LEGACY_RES, LEGACY_ORBIT, LEGACY_CPU_RES = 128, 2, 8
LEGACY_NERF_ATOL = 1e-4  # NeRF frame, card vs CPU: f32 MLP sums in other orders, no CDF inversion
HYBRID_RES, HYBRID_POSES = 64, (10, 25)  # demo_poses.npy frames: the first alone, both as two avatars
HYBRID_CPU_RES = 12


def _legacy_cli_frames(model: str, out_dir: str) -> list:
    """render_canonical_cli --implicit_model ``model`` at its defaults (the
    model's init, no weights) for LEGACY_ORBIT frames of each orbit at
    LEGACY_RES^2: the frames' host seconds; every frame finite and written."""
    frame_s, finite = [], []
    with _timed_renderer(render_canonical_cli, "make_legacy_frame_renderer", frame_s, finite):
        render_canonical_cli.main(["--implicit_model", model, "--render_h", str(LEGACY_RES), "--render_w",
                                   str(LEGACY_RES), "--trajectory_resolution", str(LEGACY_ORBIT), "--out_dir",
                                   out_dir, "--exp_name", model])
    n = 2 * LEGACY_ORBIT
    if len(frame_s) != n or not all(finite):
        raise AssertionError(f"legacy {model}: {len(frame_s)} frames of {n}, finite {finite}")
    exp = os.path.join(out_dir, "canonical_360", model)
    for pose in ("body", "head"):
        for i in range(LEGACY_ORBIT):
            img = read_png(os.path.join(exp, f"{model}_{pose}_can_{i:04d}.png"))
            if img.shape != (LEGACY_RES, LEGACY_RES, 3) or img.std() == 0:
                raise AssertionError(f"legacy {model}: frame {pose} {i}: {img.shape}, flat")
    return frame_s


def _center_rows(res: int, crop: int, device) -> torch.Tensor:
    """The ray indices of the center crop^2 of a res^2 frame, row-major."""
    lo = (res - crop) // 2
    idx = torch.arange(lo, lo + crop, device=device)
    return (idx[:, None] * res + idx[None, :]).reshape(-1)


def _legacy_card_vs_cpu(render, params_cpu: dict, what: str, atol: float, max_share: float) -> None:
    """``render(params, rays_o, rays_d)`` of one LEGACY_CPU_RES^2 crop of
    the body orbit's first view on the card and the CPU, the same
    parameters on both."""
    pose = default_360_path(np.zeros(3), np.array([0.0, 1.0, 0.0]), render_canonical_cli.CANONICAL_CAMERA_DIST_VAL,
                            LEGACY_ORBIT)[0][0]
    full = LEGACY_CPU_RES * 4
    frames = {}
    for device in ("cpu", "cuda"):
        ro, rd = pose2rays(full, full, pose, device=device)
        rows = _center_rows(full, LEGACY_CPU_RES, device)
        params = map_leaves(params_cpu, lambda t: t.to(device))
        with torch.no_grad():
            frames[device] = render(params, ro[rows], rd[rows]).cpu()
    check_parity_frame_close(frames["cuda"], frames["cpu"], atol, max_share, what)


def _hybrid_avatar(params: dict, fcfg, pose_index: int, device: str) -> dict:
    model, world_verts, Ts = bench.demo_frames(1, first=pose_index)
    rcfg = RenderConfig(num_steps=32, upsample_steps=32, bound=NSR_BOUND, perturb=False,
                        normal_mode=artifact_normal_mode(bench.ARTIFACT_CKPT) or "fd7")
    return {"params": params, "fcfg": fcfg, "rcfg": rcfg,
            "warp_data": WarpData.create(world_verts[0], model.faces, Ts[0], device)}


def _hybrid_frames(res: int, device: str, crop: int | None = None) -> dict:
    """The baked artifact on the demo body in pose HYBRID_POSES[0] over the
    NeRF background (its init from a CPU generator seeded 0, the same
    numbers on every device) through render_hybrid_avatar, and HYBRID_POSES
    as two avatars through render_hybrid_multi_persons, res^2 from the warp
    bench's camera (the center crop^2 of it with ``crop``): {"one": rgb,
    "two": rgb, "one_s": seconds, "two_s": seconds}."""
    params, fcfg = load_params_with_config(bench.ARTIFACT_CKPT, device)
    bcfg = NeRFConfig(mapping="rotate")
    bkg = map_leaves(init_nerf_params(torch.Generator().manual_seed(0), bcfg), lambda t: t.to(device))
    ro, rd = pose2rays(res, res, bench.warp_view(), device=device)
    if crop is not None:
        rows = _center_rows(res, crop, device)
        ro, rd = ro[rows], rd[rows]
    avatars = [_hybrid_avatar(params, fcfg, i, device) for i in HYBRID_POSES]
    out = {}
    with torch.no_grad():
        for name, fn in (("one", lambda: hybrid.render_hybrid_avatar(
                params, fcfg, avatars[0]["rcfg"], bkg, bcfg, ro, rd, warp_data=avatars[0]["warp_data"])),
                         ("two", lambda: hybrid.render_hybrid_multi_persons(avatars, bkg, bcfg, ro, rd, seed=0))):
            _sync(device)
            t0 = time.perf_counter()
            res_out = fn()
            _sync(device)
            out[f"{name}_s"] = time.perf_counter() - t0
            out[name] = res_out["rgb"].cpu()
            if not torch.isfinite(out[name]).all():  # the depths are +inf where nothing is hit
                raise AssertionError(f"hybrid {name}: a non-finite frame")
            if name == "one":
                out["avatar_share"] = float(res_out["avatar_mask"].float().mean())
    return out


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check_orbax_reader() -> None:
    """The committed toy guidance's orbax directory read on this machine,
    which has no orbax: every leaf bitwise params_torch.npz; then the toy
    guidance through its loader."""
    t0 = time.perf_counter()
    tree = load_checkpoint(os.path.join(TOY_DIR, "params"))["params"]
    read_s = time.perf_counter() - t0
    flat = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{key}/{i}")
        elif node is not None:
            flat[key] = node

    walk(tree, "params")
    with np.load(os.path.join(TOY_DIR, "params_torch.npz")) as z:
        names = sorted(k for k in z.files if k.startswith("params/"))
        if sorted(flat) != names:
            raise AssertionError(f"orbax reader: {len(flat)} leaves, the npz {len(names)}")
        for k in names:
            if flat[k].dtype != z[k].dtype or flat[k].shape != z[k].shape or flat[k].tobytes() != z[k].tobytes():
                raise AssertionError(f"orbax reader: {k} differs from the npz")
    t0 = time.perf_counter()
    toy, _, _ = load_toy_guidance(TOY_DIR, "cuda")
    load_s = time.perf_counter() - t0
    print(f"legacy: the toy guidance's orbax directory read in {read_s:.3f} s ({len(names)} leaves, bitwise "
          f"params_torch.npz; zstd: {orbax.zstd_route()}); load_toy_guidance onto the card {load_s:.3f} s "
          f"({len(leaves(toy))} tensors) ({card_line()})", flush=True)


def check_legacy() -> dict:
    """NeuS and NeRF at the reference's widths through render_canonical_cli
    --implicit_model neus|nerf (their inits), the init's SDF, a crop card vs
    CPU for each; the hybrid render of the artifact on the demo body over a
    NeRF background, one avatar and two, card vs CPU on a crop; the orbax
    reader. No kernel of the port runs on these paths (the avatar's
    parameters are taken whole): both counts must stay 0."""
    t_phase = time.perf_counter()
    _reset_launches()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_legacy_")
    try:
        frame_s = {m: _legacy_cli_frames(m, out_dir) for m in ("neus", "nerf")}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    ncfg = NeuSConfig()
    init = init_neus_params(torch.Generator("cuda").manual_seed(0), ncfg)  # the CLI's init
    xs = torch.tensor([[0.0, 0.0, 0.0], [0.2, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.5]], device="cuda")
    with torch.no_grad():
        sdf = neus_sdf(init, xs, ncfg)[:, 0].cpu()
    print(f"legacy: NeuS init SDF at r = 0, 0.2, 1, 1.5: {json.dumps([round(float(v), 5) for v in sdf])}", flush=True)
    if not (sdf[0] < 0 and sdf[1] < 0 and 0 < sdf[2] < sdf[3]):
        raise AssertionError(f"legacy: the NeuS init is not the r = 0.5 sphere: {sdf.tolist()}")
    for m, secs in frame_s.items():
        print(f"legacy: {m} {len(secs)} frames at {LEGACY_RES}x{LEGACY_RES}: "
              f"{json.dumps([round(1e3 * t, 2) for t in secs])} ms (the first a warm-up); "
              f"{1e3 * float(np.mean(secs[1:])):.2f} ms per frame ({card_line()})", flush=True)

    neus_cpu = init_neus_params(torch.Generator().manual_seed(0), ncfg)
    rcfg = RenderConfig(num_steps=64, upsample_steps=64, bound=NSR_BOUND, perturb=False, normal_mode="fd7")
    _legacy_card_vs_cpu(lambda p, ro, rd: render_rays_chunked({}, ro, rd, instant_nsr.FieldConfig(), rcfg, 1.0,
                                                              chunk=ro.shape[0], field=build_neus(p, ncfg))["rgb"],
                        neus_cpu, f"NeuS {LEGACY_CPU_RES}x{LEGACY_CPU_RES} crop", PARITY_CPU_ATOL,
                        PARITY_CPU_OUTLIER_SHARE)
    bcfg = NeRFConfig(mapping="rotate")
    nerf_cpu = init_nerf_params(torch.Generator().manual_seed(0), bcfg)
    _legacy_card_vs_cpu(lambda p, ro, rd: render_nerf_rays(p, ro, rd, bcfg)["rgb"], nerf_cpu,
                        f"NeRF {LEGACY_CPU_RES}x{LEGACY_CPU_RES} crop", LEGACY_NERF_ATOL, 0.0)

    hybrid_out = _hybrid_frames(HYBRID_RES, "cuda")  # the first call: warm-up
    hybrid_out = _hybrid_frames(HYBRID_RES, "cuda")
    print(f"legacy: hybrid at {HYBRID_RES}x{HYBRID_RES}: one avatar {1e3 * hybrid_out['one_s']:.2f} ms per frame "
          f"(the avatar on {hybrid_out['avatar_share']:.3f} of the pixels), two avatars "
          f"{1e3 * hybrid_out['two_s']:.2f} ms per frame ({card_line()})", flush=True)
    if not 0.01 < hybrid_out["avatar_share"] < 0.99:
        raise AssertionError(f"hybrid: the avatar covers {hybrid_out['avatar_share']} of the frame")
    crop = {d: _hybrid_frames(HYBRID_RES, d, HYBRID_CPU_RES) for d in ("cpu", "cuda")}
    for name in ("one", "two"):
        check_parity_frame_close(crop["cuda"][name], crop["cpu"][name], PARITY_FRAME_ATOL,
                                 PARITY_WARP_OUTLIER_SHARE, f"hybrid {name} {HYBRID_CPU_RES}x{HYBRID_CPU_RES} crop")
    check_orbax_reader()
    launches = dict(ring.launches)
    _expect_launches("legacy", launches, {ring.KERNEL: 0, ring.RS_KERNEL: 0})
    print(f"legacy: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def main() -> int:
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"chip_smoke: {avatarcraft_tpu_torch.__name__} {avatarcraft_tpu_torch.__version__}", flush=True)
    # the reconstruct phase's dataset and parity checkpoint, kept for the parity phases
    recon_root = tempfile.mkdtemp(prefix="recon_")
    try:
        with Phase("device"):
            device = check_device()
        with Phase("build"):
            build_kernels()
        with Phase("kernel"):
            measured = {ring.KERNEL: check_gather_kernel(), ring.RS_KERNEL: check_reduce_scatter_kernel()}
        paths = {}
        with Phase("main"):
            paths["render"] = check_main_path()
        with Phase("train"):
            paths["train_fast"] = check_train_fast()
        with Phase("tablemp"):
            paths["table_mp"] = check_table_mp()
        with Phase("warp"):
            paths["warp"] = check_warp_path()
            check_styled_warp()
        with Phase("cpu"):
            check_card_vs_cpu()
            check_refresh_card_vs_cpu()
            check_train_card_vs_cpu()
        with Phase("stylize"):
            paths["stylize"] = check_stylize()
        with Phase("stylize_card_vs_cpu"):
            check_stylize_card_vs_cpu()
        with Phase("analytic_card_vs_cpu"):
            check_analytic_card_vs_cpu()
        with Phase("multi_stylize"):
            paths["multi_stylize"] = check_multi_stylize()
        with Phase("multi_card_vs_cpu"):
            check_multi_card_vs_cpu()
        with Phase("sd_stylize"):
            paths["sd_stylize"], sd15 = check_sd_stylize()
            check_sd_batched_guidance(sd15)
        with Phase("txt2img"):
            check_txt2img(sd15)
        del sd15
        with Phase("sd_depth"):
            paths["sd_depth"] = check_sd_depth()
        with Phase("toy_ddpm"):
            check_toy_ddpm()
        with Phase("sd_card_vs_cpu"):
            check_sd_card_vs_cpu()
        with Phase("reconstruct"):
            paths["reconstruct_fast"] = check_reconstruct(recon_root)
        with Phase("reconstruct_scan"):
            paths["reconstruct_scan"] = check_reconstruct_scan(recon_root)
        with Phase("tools"):
            paths["tools"] = check_tools(recon_root)
        with Phase("finetune"):
            paths["finetune"] = check_finetune(recon_root)
        with Phase("probes"):
            paths["probes"] = check_probes(recon_root)
        with Phase("parity_render"):
            paths["parity_render"] = check_parity_render()
        with Phase("parity_warp"):
            paths["parity_warp"] = check_parity_warp(recon_root)
        with Phase("parity_stylize"):
            paths["parity_stylize"] = check_parity_stylize()
            paths["parity_chain"] = check_reference_chain(recon_root)
        with Phase("parity_multi"):
            paths["parity_multi"] = check_parity_multi()
        with Phase("parity_card_vs_cpu"):
            check_parity_card_vs_cpu(recon_root)
        with Phase("multirank"):
            peer, paths["multirank"] = check_multirank()
            measured.update(peer)
        with Phase("legacy"):
            paths["legacy"] = check_legacy()
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        print("chip_smoke: FAILED", flush=True)
        return 1
    finally:
        shutil.rmtree(recon_root, ignore_errors=True)
    kernels = []
    for name, meta in KERNELS.items():
        m = measured[name]
        by_path = {path: counts[name] for path, counts in paths.items()}
        kernels.append({
            "name": name,
            **meta,
            "launches": sum(by_path.values()),  # each path's run, counts reset before it
            "launches_by_path": by_path,
            "max_abs_err": m["max_abs_err"],
            "ms": m["kernel_ms"],  # the same number as kernel_ms
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": "bytes",
            "library_ms": m["library_ms"],
            # kernel_ms, wrapper_ms; kernel_cold_ms, library_cold_ms (L2 flushed before
            # each call); the profiler's device time of one call in that cold loop
            **{k: v for k, v in m.items() if k not in ("max_abs_err", "plain_ms", "bound_ms", "library_ms")},
        })
    print(f"chip_smoke: all phases ok in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
