"""256x256 render throughput of the baked artifact on one card: the port
of the root bench.py's fast branch (bench.py:203-275) and its warp branch
(bench.py:127-201).

    python -m avatarcraft_tpu_torch.bench               # canonical render
    python -m avatarcraft_tpu_torch.bench --path warp   # animated render

canonical: renders ``artifacts/canonical`` (fd4 normals, per its
PROVENANCE.json) through the port's render entry at the same 16 cameras as
the root bench (4 groups of 4), with the sample budget derived from those
frames (worst probe count x 1.02) and a hard zero-clip check. Group 0 warms
up, group 1 settles, groups 2 and 3 are timed (host clock around work that
ends in a synchronize); the faster of the two, per frame, gives rays/s.

warp: the same field animated on the committed demo body
(``demo_body_rig.npz``, rest pose 'zero') by the first 4 frames of
``demo_poses.npy``, seen from pose_spherical(30, -5), in 8192-ray chunks
with 128 probes and K = 32, the budget derived over the 4 frames. Frame 0
warms up, frame 1 settles, frames 2 and 3 are timed one each; the faster
gives rays/s. The zero-clip check runs after the timing.

Prints one JSON line that names the card. Needs a CUDA card: it never falls
back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from avatarcraft_tpu_torch.cameras import pose2rays, pose_spherical
from avatarcraft_tpu_torch.constants import CANONICAL_CAMERA_DIST_VAL, NSR_BOUND
from avatarcraft_tpu_torch.data.amass import load_pose_sequence
from avatarcraft_tpu_torch.models.instant_nsr import FastRenderConfig, count_fast_samples
from avatarcraft_tpu_torch.models.smpl import load_smpl
from avatarcraft_tpu_torch.utils.checkpoint import artifact_normal_mode, load_params_with_config
from avatarcraft_tpu_torch.utils.device import card_line
from avatarcraft_tpu_torch.warp import WarpData
from avatarcraft_tpu_torch.workloads.canonical_render import make_fast_frame_renderer
from avatarcraft_tpu_torch.workloads.warp_render import (
    BUDGET_SAFETY,
    WarpRenderSettings,
    calc_local_trans,
    make_warp_frame_renderer_fast,
    warp_worst_count,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT_DIR = os.path.join(REPO_ROOT, "artifacts", "canonical")
ARTIFACT_CKPT = os.path.join(ARTIFACT_DIR, "bare_smpl_tpu.pth.tar")
ARTIFACT_GRID = os.path.join(ARTIFACT_DIR, "grid.npy")
RES = 256  # frames are RES x RES, as in the root bench
N_FRAMES, N_GROUPS = 4, 4
METRIC = "canonical_render_256_rays_per_sec_per_chip"
RIG = os.path.join(ARTIFACT_DIR, "demo_body_rig.npz")
POSES = os.path.join(ARTIFACT_DIR, "demo_poses.npy")
WARP_FRAMES = 4  # frames 0-1 warm up, 2-3 are timed
WARP_METRIC = "warp_render_256_rays_per_sec_per_chip"


def bench_poses() -> list[np.ndarray]:
    """The root bench's 16 cameras, group by group (bench.py:91-104)."""
    return [
        pose_spherical(7.0 + 91.0 * i + 23.0 * g, -3.0 * g, CANONICAL_CAMERA_DIST_VAL)
        for g in range(N_GROUPS)
        for i in range(N_FRAMES)
    ]


def load_artifact(device="cuda"):
    """(params, FieldConfig, density grid, FastRenderConfig without budget)
    of the baked canonical artifact, on ``device``."""
    params, fcfg = load_params_with_config(ARTIFACT_CKPT, device)
    grid = torch.as_tensor(np.load(ARTIFACT_GRID), dtype=torch.float32).to(device)
    cfg = FastRenderConfig(
        n_probes=192, k_samples=32, bound=NSR_BOUND,
        normal_mode=artifact_normal_mode(ARTIFACT_CKPT) or "fd4",
    )
    return params, fcfg, grid, cfg


def warp_view():
    """The warp bench's camera: pose_spherical(30, -5) at the validation
    distance (bench.py:164-166)."""
    return pose_spherical(30.0, -5.0, CANONICAL_CAMERA_DIST_VAL)


def demo_frames(n_frames: int, first: int = 0):
    """(SMPLParams, world_verts, Ts) of ``n_frames`` frames of the demo pose
    sequence from frame ``first``, on the committed demo body (rest pose
    'zero': its template is the avatar's surface)."""
    model = load_smpl(RIG)
    poses = load_pose_sequence(POSES)[first:]
    world_verts, Ts, _ = calc_local_trans(model, render_type="animate", poses=poses, max_frames=n_frames,
                                          rest_pose="zero")
    return model, world_verts, Ts


def _require_card(device) -> None:
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the bench measures a CUDA card; device {device!r} is not one")


def derive_budget(rays, cfg: FastRenderConfig, grid: torch.Tensor) -> tuple[int, int]:
    """(worst probe-selected count over the ray batches, budget = worst x 1.02)."""
    worst = max(int(count_fast_samples(ro, rd, cfg, grid)) for ro, rd in rays)
    return worst, int(worst * 1.02)


def run(device="cuda") -> dict:
    """Time the 16 frames, one table shard per card; returns the JSON fields
    plus "frames" (the 16 rgb images as CPU tensors [RES, RES, 3])."""
    _require_card(device)
    params, fcfg, grid, cfg = load_artifact(device)
    rays = [pose2rays(RES, RES, p, device=device) for p in bench_poses()]
    worst, budget = derive_budget(rays, cfg, grid)
    cfg = dataclasses.replace(cfg, sample_budget=budget)
    render = make_fast_frame_renderer(params, fcfg, cfg, grid, chunk=RES * RES)
    frames, group_s = [], []
    for g in range(N_GROUPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for ro, rd in rays[g * N_FRAMES : (g + 1) * N_FRAMES]:
            frames.append(render(ro, rd)["rgb"])
        torch.cuda.synchronize()
        group_s.append(time.perf_counter() - t0)
    dt = min(group_s[2:]) / N_FRAMES
    # zero-clip: no frame may select more samples than the budget, or the
    # compaction would have dropped samples of its last rays
    worst_rendered, _ = derive_budget(rays, cfg, grid)
    if worst_rendered > budget:
        raise RuntimeError(f"CLIPPED: a frame selected {worst_rendered} samples > budget {budget}")
    return {
        "metric": METRIC,
        "value": RES * RES / dt,
        "unit": "rays/sec",
        "device": torch.cuda.get_device_name(0),
        "card": card_line(),
        "ms_per_frame": dt * 1e3,
        "group_seconds": group_s,
        "sample_budget": budget,
        "worst_probe_count": worst,
        "normal_mode": cfg.normal_mode,
        "n_shards": 1,
        "frames": [f.reshape(RES, RES, 3).cpu() for f in frames],
    }


def run_warp(device="cuda") -> dict:
    """Time the warp render of 4 demo frames; returns the JSON fields plus
    "frames" (the 4 rgb images as CPU tensors [RES, RES, 3], in order)."""
    _require_card(device)
    params, fcfg, _, _ = load_artifact(device)
    model, world_verts, Ts = demo_frames(WARP_FRAMES)
    frames = [WarpData.create(v, model.faces, T, device) for v, T in zip(world_verts, Ts)]
    ro, rd = pose2rays(RES, RES, warp_view(), device=device)
    settings = WarpRenderSettings()
    worst = warp_worst_count(world_verts, ro, rd, settings)
    budget = int(worst * BUDGET_SAFETY)
    render = make_warp_frame_renderer_fast(params, fcfg, settings, budget)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    images, frame_s = [], []
    for wd in frames:
        t0 = time.perf_counter()
        images.append(render(ro, rd, wd))
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    dt = min(frame_s[2:])
    # zero-clip: no chunk of a rendered frame may select more samples than
    # the budget, or the compaction would have dropped samples of its last rays
    worst_rendered = warp_worst_count(world_verts, ro, rd, settings)
    if worst_rendered > budget:
        raise RuntimeError(f"CLIPPED: a warp chunk selected {worst_rendered} samples > budget {budget}")
    return {
        "metric": WARP_METRIC,
        "value": RES * RES / dt,
        "unit": "rays/sec",
        "device": torch.cuda.get_device_name(0),
        "card": card_line(),
        "ms_per_frame": dt * 1e3,
        "frame_seconds": frame_s,
        "sample_budget": budget,
        "worst_probe_count": worst,
        "chunk": settings.chunk,
        "peak_memory_gib": peak / 2**30,
        "frames": [f.reshape(RES, RES, 3).cpu() for f in images],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="256x256 render throughput of the baked artifact on one card")
    ap.add_argument("--path", default="canonical", choices=["canonical", "warp"])
    result = (run_warp if ap.parse_args(argv).path == "warp" else run)()
    result.pop("frames")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
