"""Canonical 256x256 render throughput of the baked artifact on one card:
the port of the root bench.py's fast branch (bench.py:203-275).

    python -m avatarcraft_tpu_torch.bench

Renders ``artifacts/canonical`` (fd4 normals, per its PROVENANCE.json)
through the port's render entry at the same 16 cameras as the root bench
(4 groups of 4), with the sample budget derived from those frames (worst
probe count x 1.02) and a hard zero-clip check. Group 0 warms up, group 1
settles, groups 2 and 3 are timed (host clock around work that ends in a
synchronize); the faster of the two, per frame, gives rays/s. Prints one
JSON line that names the card. Needs a CUDA card: it never falls back to
the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from avatarcraft_tpu_torch.cameras import pose2rays, pose_spherical
from avatarcraft_tpu_torch.constants import CANONICAL_CAMERA_DIST_VAL, NSR_BOUND
from avatarcraft_tpu_torch.models.instant_nsr import FastRenderConfig, count_fast_samples
from avatarcraft_tpu_torch.parallel.table_mp import default_shard_count
from avatarcraft_tpu_torch.utils.checkpoint import artifact_normal_mode, load_params_with_config
from avatarcraft_tpu_torch.utils.device import card_line
from avatarcraft_tpu_torch.workloads.canonical_render import make_fast_frame_renderer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT_DIR = os.path.join(REPO_ROOT, "artifacts", "canonical")
ARTIFACT_CKPT = os.path.join(ARTIFACT_DIR, "bare_smpl_tpu.pth.tar")
ARTIFACT_GRID = os.path.join(ARTIFACT_DIR, "grid.npy")
RES = 256  # frames are RES x RES, as in the root bench
N_FRAMES, N_GROUPS = 4, 4
METRIC = "canonical_render_256_rays_per_sec_per_chip"


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


def derive_budget(rays, cfg: FastRenderConfig, grid: torch.Tensor) -> tuple[int, int]:
    """(worst probe-selected count over the ray batches, budget = worst x 1.02)."""
    worst = max(int(count_fast_samples(ro, rd, cfg, grid)) for ro, rd in rays)
    return worst, int(worst * 1.02)


def run(device="cuda") -> dict:
    """Time the 16 frames, one table shard per card; returns the JSON fields
    plus "frames" (the 16 rgb images as CPU tensors [RES, RES, 3])."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the bench measures a CUDA card; device {device!r} is not one")
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
        "n_shards": default_shard_count(device),
        "frames": [f.reshape(RES, RES, 3).cpu() for f in frames],
    }


def main() -> None:
    result = run()
    result.pop("frames")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
