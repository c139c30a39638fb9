"""Where a frame's time goes: the bench's render of the baked artifact
(256x256, derived budget, one shard per card) under torch.profiler.

    python -m avatarcraft_tpu_torch.profile_render               # canonical
    python -m avatarcraft_tpu_torch.profile_render --path warp   # animated

canonical: the bench's cameras. warp: the bench's warp view of the demo
body in frames 0-5 of the demo poses (the budget derived over them), whose
frames add the ``render.voxelize`` and ``render.warp`` ranges.

After two warm-up frames it profiles ``N_FRAMES`` frames and prints one
JSON line: wall ms per frame, device busy ms per frame (the sum of the CUDA
kernels' and copies' durations) and the idle share, the device ms per frame
of each ``render.*`` profiler range (the stage a future kernel takes over),
and the kernels that take most device time. Needs a CUDA card.

The gather kernel is launched through ctypes, and the profiler ties it to
the ops around it once, twice or not at all: the ranges leave it out, and
its own device events (named ``gather_rows_kernel``) are added to
``render.gather``, each once (``device_us_without``, ``kernel_device_us``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.cameras import pose2rays
from avatarcraft_tpu_torch.utils.device import card_line
from avatarcraft_tpu_torch.utils.timing import device_us_without, kernel_device_us
from avatarcraft_tpu_torch.warp import WarpData
from avatarcraft_tpu_torch.workloads.canonical_render import make_fast_frame_renderer
from avatarcraft_tpu_torch.workloads.warp_render import (
    WarpRenderSettings,
    derive_warp_budget,
    make_warp_frame_renderer_fast,
)

N_FRAMES = 4  # profiled frames, after two warm-up frames
GATHER_KERNEL = "gather_rows_kernel"


def canonical_frames():
    """(2 warm-up frames, N_FRAMES profiled frames, budget): each frame a
    call that renders it."""
    params, fcfg, grid, cfg = bench.load_artifact("cuda")
    rays = [pose2rays(bench.RES, bench.RES, p, device="cuda") for p in bench.bench_poses()]
    _, budget = bench.derive_budget(rays, cfg, grid)
    cfg = dataclasses.replace(cfg, sample_budget=budget)
    render = make_fast_frame_renderer(params, fcfg, cfg, grid, chunk=bench.RES * bench.RES)
    calls = [functools.partial(render, ro, rd) for ro, rd in rays]
    return calls[:2], calls[2 : 2 + N_FRAMES], budget


def warp_frames():
    """The same for the warp render of demo frames 0-5."""
    params, fcfg, _, _ = bench.load_artifact("cuda")
    model, world_verts, Ts = bench.demo_frames(2 + N_FRAMES)
    ro, rd = pose2rays(bench.RES, bench.RES, bench.warp_view(), device="cuda")
    settings = WarpRenderSettings()
    budget = derive_warp_budget(world_verts, ro, rd, settings)
    render = make_warp_frame_renderer_fast(params, fcfg, settings, budget)
    calls = [functools.partial(render, ro, rd, WarpData.create(v, model.faces, T, "cuda"))
             for v, T in zip(world_verts, Ts)]
    return calls[:2], calls[2:], budget


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="where a 256x256 frame's device time goes")
    ap.add_argument("--path", default="canonical", choices=["canonical", "warp"])
    path = ap.parse_args(argv).path
    if not torch.cuda.is_available():
        raise SystemExit("profile_render measures a CUDA card; none is available")
    warmup, frames, budget = (warp_frames if path == "warp" else canonical_frames)()
    for frame in warmup:
        frame()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for frame in frames:
            frame()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(frames)

    # kernels and copies on the card; the ranges' own GPU-side annotations
    # carry the range names and would count twice
    device_events = [
        e for e in prof.events() if e.device_type == DeviceType.CUDA and not e.name.startswith("render.")
    ]
    busy_us = sum(e.time_range.elapsed_us() for e in device_events)
    stages = {}
    for e in prof.events():
        if e.name.startswith("render.") and e.device_type == DeviceType.CPU:
            stages[e.name] = stages.get(e.name, 0.0) + device_us_without(e, (GATHER_KERNEL,)) / 1e3 / n
    gather_us = kernel_device_us(prof.events(), GATHER_KERNEL)
    stages["render.gather"] = stages.get("render.gather", 0.0) + gather_us / 1e3 / n
    kernels = sorted(
        (
            (e.key, e.device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("render.")
        ),
        key=lambda kv: -kv[1],
    )[:15]
    result = {
        "path": path,
        "device": torch.cuda.get_device_name(0),
        "card": card_line(),
        "frames": n,
        "sample_budget": budget,
        "wall_ms_per_frame": wall * 1e3 / n,
        "device_busy_ms_per_frame": busy_us / 1e3 / n,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "stage_device_ms_per_frame": stages,
        "top_kernels": [{"name": k[:80], "ms_per_frame": ms, "calls_per_frame": c} for k, ms, c in kernels],
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
