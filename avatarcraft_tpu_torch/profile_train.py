"""Where a reconstruction train step's time goes: the fast trainer's step
(``workloads.reconstruct.make_train_step_fast``) at the artifact's width,
batch 1600, on one card.

    python -m avatarcraft_tpu_torch.profile_train

The image set is rendered here from the baked artifact (``artifact_image_set``:
8 bench cameras at 128x128); the field starts from ``init_field_params`` at
the artifact's widths with a fully occupied grid, as ``train_fast`` starts.
After ``WARMUP`` steps it times ``TIMED`` steps on the host clock (ms per
step, rays/s), then profiles ``PROFILED`` more steps under torch.profiler:
device ms per step of each of the step's own ``train.*`` ranges (gather,
materialize, forward, backward, optimizer; ``_phase_device_ms``), of each
``render.*`` range (the forward stages), of the two table kernels
(``gather_rows_kernel``, the all-gather; ``reduce_scatter_rows_kernel``,
its backward; launched through ctypes, so counted by kernel name), and the
kernels that take most device time. Prints one JSON line that names the card. Needs a CUDA card.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.constants import CANONICAL_ZOOM_FACTOR
from avatarcraft_tpu_torch.models.instant_nsr import FastRenderConfig, init_field_params
from avatarcraft_tpu_torch.parallel.table_mp import trainable_shards
from avatarcraft_tpu_torch.utils.checkpoint import leaves
from avatarcraft_tpu_torch.utils.device import card_line
from avatarcraft_tpu_torch.utils.timing import device_us_without, kernel_device_us
from avatarcraft_tpu_torch.workloads.canonical_render import make_fast_frame_renderer
from avatarcraft_tpu_torch.workloads.reconstruct import (
    ImageSet,
    ReconstructConfig,
    make_batch_ray_fn,
    make_optimizer,
    make_train_step_fast,
    pixel_batches,
)

N_VIEWS, RES = 8, 128
WARMUP, TIMED, PROFILED = 3, 20, 5
KERNEL_EVENTS = ("gather_rows_kernel", "reduce_scatter_rows_kernel")
PHASES = ("gather", "materialize", "forward", "backward", "optimizer")
# the capture convention's camera (+z forward, y down) as the image set's
# OpenGL camera (-z forward, y up)
_CAPTURE_TO_GL = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def bench_cameras(n_views: int, res: int):
    """(K [3,3], poses [n_views,4,4]): the canonical camera at res x res and
    the first ``n_views`` bench poses, in the image set's OpenGL
    convention."""
    f = CANONICAL_ZOOM_FACTOR * res
    K = np.array([[f, 0.0, res / 2.0], [0.0, f, res / 2.0], [0.0, 0.0, 1.0]], np.float32)
    poses = np.stack([p.astype(np.float32) @ _CAPTURE_TO_GL for p in bench.bench_poses()[:n_views]])
    return K, poses


def artifact_image_set(device="cuda"):
    """(image set, the artifact's FieldConfig, its normal mode): the first
    N_VIEWS bench cameras at RES x RES, rendered from the baked artifact
    by the port's fast renderer through the rays ``make_batch_ray_fn``
    gives the trainer; masks all 1."""
    params, fcfg, grid, cfg = bench.load_artifact(device)
    K, poses = bench_cameras(N_VIEWS, RES)
    ray_fn = make_batch_ray_fn(K, RES, RES)
    render = make_fast_frame_renderer(params, fcfg, cfg, grid, chunk=RES * RES)
    poses_d = torch.as_tensor(poses, device=device)
    pix = torch.arange(RES * RES, device=device)
    images = []
    for v in range(N_VIEWS):
        ro, rd = ray_fn(poses_d, torch.full_like(pix, v), pix)
        images.append(render(ro, rd)["rgb"].reshape(RES, RES, 3).cpu().numpy())
    images = np.stack(images).astype(np.float32)
    ds = ImageSet(K=K, poses=poses, images=images, masks=np.ones(images.shape[:3], np.float32))
    return ds, fcfg, cfg.normal_mode


def _batches(ds: ImageSet, cfg: ReconstructConfig, device):
    rng = np.random.default_rng(cfg.seed)
    while True:
        for vi, pi in pixel_batches(ds.n_images, ds.H * ds.W, cfg.batch_size, rng):
            yield (torch.as_tensor(vi, dtype=torch.int64, device=device),
                   torch.as_tensor(pi, dtype=torch.int64, device=device),
                   torch.as_tensor(ds.gather_rgb(vi, pi), device=device))


def _phase_device_ms(prof) -> dict:
    """Device ms of each ``train.*`` phase over the profiled steps, from the
    real step's ranges: the kernels launched inside each range on the
    calling thread, plus, for ``train.backward``, every kernel that the
    autograd engine's own threads launched; the two table kernels are
    launched through ctypes, and the profiler ties them to the ops around
    them once, twice or not at all, so the ranges leave them out and their
    own device events are added, each once (the gather to
    ``train.gather``, the reduce-scatter to ``train.backward``)."""
    events = prof.events()
    ranges = [e for e in events if e.name.startswith("train.") and e.device_type == DeviceType.CPU]
    main_thread = ranges[0].thread
    ms = dict.fromkeys(PHASES, 0.0)
    for e in ranges:
        ms[e.name[len("train."):]] += device_us_without(e, KERNEL_EVENTS) / 1e3
    ms["backward"] += sum(
        device_us_without(e, KERNEL_EVENTS) for e in events
        if e.device_type == DeviceType.CPU and e.thread != main_thread and e.cpu_parent is None
    ) / 1e3
    for name, phase in zip(KERNEL_EVENTS, ("gather", "backward")):
        ms[phase] += kernel_device_us(events, name) / 1e3
    return ms


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures a CUDA card; none is available")
    device = "cuda"
    ds, fcfg, normal_mode = artifact_image_set(device)
    fast_cfg = FastRenderConfig(normal_mode=normal_mode)
    cfg = ReconstructConfig()
    params = init_field_params(torch.Generator(device).manual_seed(cfg.seed), fcfg)
    rest, shards, splice = trainable_shards(params)
    del params
    opt, sched = make_optimizer(cfg, ds.n_images * ds.H * ds.W // cfg.batch_size, leaves(rest) + shards)
    ray_fn = make_batch_ray_fn(ds.K, ds.H, ds.W)
    step = make_train_step_fast(fcfg, fast_cfg, opt, ray_fn, cfg.eikonal_weight, splice, sched)
    grid = torch.full((129,) * 3, 100.0, device=device)
    poses = torch.as_tensor(ds.poses, device=device)
    batches = _batches(ds, cfg, device)
    bg = 1.0

    for _ in range(WARMUP):
        step(rest, shards, poses, *next(batches), grid, bg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        step(rest, shards, poses, *next(batches), grid, bg)
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) * 1e3 / TIMED

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(PROFILED):
            step(rest, shards, poses, *next(batches), grid, bg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    # the device's copies of host ranges (train.*, render.*, the optimizer's
    # Optimizer.step#Adam.step) carry a host event's name; kernels never do
    host_names = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.name not in host_names]
    busy_us = sum(e.time_range.elapsed_us() for e in device_events)
    phases = {k: v / PROFILED for k, v in _phase_device_ms(prof).items()}
    stages = {
        e.key: e.device_time_total / 1e3 / PROFILED
        for e in prof.key_averages()
        if e.key.startswith("render.") and e.device_type == DeviceType.CPU
    }
    kernel_ms = {
        k: sum(e.time_range.elapsed_us() for e in device_events if k in e.name) / 1e3 / PROFILED
        for k in KERNEL_EVENTS
    }
    kernels = sorted(
        (
            (e.key, e.device_time_total / 1e3 / PROFILED, e.count // PROFILED)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in host_names
        ),
        key=lambda kv: -kv[1],
    )[:15]
    result = {
        "device": torch.cuda.get_device_name(0),
        "card": card_line(),
        "batch": cfg.batch_size,
        "normal_mode": fast_cfg.normal_mode,
        "ms_per_step": ms_per_step,
        "rays_per_sec": cfg.batch_size / ms_per_step * 1e3,
        "profiled_wall_ms_per_step": wall * 1e3 / PROFILED,
        "device_busy_ms_per_step": busy_us / 1e3 / PROFILED,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "phase_device_ms_per_step": phases,
        "unphased_device_ms_per_step": busy_us / 1e3 / PROFILED - sum(phases.values()),
        "stage_device_ms_per_step": stages,
        "table_kernel_ms_per_step": kernel_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "top_kernels": [{"name": k[:80], "ms_per_step": ms, "calls_per_step": c} for k, ms, c in kernels],
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
