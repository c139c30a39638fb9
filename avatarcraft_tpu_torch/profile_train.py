"""Where a reconstruction train step's or an SDS step's time goes, on one
card.

    python -m avatarcraft_tpu_torch.profile_train                 # reconstruct (fast)
    python -m avatarcraft_tpu_torch.profile_train --scan_steps 8  # reconstruct (fast), a CUDA graph of the step
    python -m avatarcraft_tpu_torch.profile_train --path parity   # reconstruct (64+64, hash grid)
    python -m avatarcraft_tpu_torch.profile_train --path stylize [--guidance sd]

parity: the 64+64 trainer's step (``workloads.reconstruct.setup``) at the
reconstruct CLI's defaults: the hash grid (16 levels x 2, 2^19 rows,
finest 2048), MLPs 64 wide, 64+64 samples with fd7 normals and perturbed
depths, batch 1600, Adam 5e-4 on the cosine, on the same image set; ms per
step, rays/s, device ms per ``train.forward`` / ``.backward`` /
``.optimizer``, peak memory and the top kernels. It launches no table
kernel.

stylize: the stylize CLI's trainer at its defaults (``stylize_cli.setup``:
the committed artifact, lava, 256x256, 4096-ray patches, the derived
budget; refreshes off while timing) with the toy guidance, or with
``--guidance sd`` Stable Diffusion 1.5 at its full width from seeded random
weights behind the toy tokenizer (``models/sd.py::
random_stable_diffusion_modules``, 512x512 into the VAE; no weight files).
For the coarse stage (a 64x64 frame, one patch) and the fine stage
(256x256, 16 patches): after STYLIZE_WARMUP steps, STYLIZE_TIMED steps on
the host clock (ms per step, steps/s, peak memory), then STYLIZE_PROFILED
steps under torch.profiler: device ms per step of each ``stylize.*`` range
(gather, phaseA, sds: the UNet's pair, vae: the resize, the encode and its
pullback, phaseB with the autograd engine's kernels, refresh), of the ``render.*``
stages and Adam's step inside them, device busy, idle share, launches per
step and the top kernels; then the grid refresh and the floater pruning
timed alone (CUDA events). A range's device ms sums its kernels' durations;
device busy is the union of all kernels' intervals, which is less where
kernels run side by side (some of cuDNN's f32 convolutions do).

reconstruct: the fast trainer's step
(``workloads.reconstruct.make_train_step_fast``) at the artifact's width,
batch 1600. With ``--scan_steps S`` the same step through
``make_train_scan_fast`` (the dataset on the card, S replays of one
captured CUDA graph a call; ``scan_main``): ms per step over whole calls,
device busy and idle share, the table kernels' ms and K10's launches per
step (the graph's replays counted), the top kernels; a replay runs no
host range, so there is no split by ``train.*`` range.

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

import argparse
import json
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.cli import stylize_cli
from avatarcraft_tpu_torch.constants import CANONICAL_ZOOM_FACTOR
from avatarcraft_tpu_torch.models.diffusion import SDSGuidance
from avatarcraft_tpu_torch.models.instant_nsr import FastRenderConfig, FieldConfig, RenderConfig, init_field_params
from avatarcraft_tpu_torch.models.sd import random_stable_diffusion_modules
from avatarcraft_tpu_torch.parallel import ring
from avatarcraft_tpu_torch.parallel.table_mp import trainable_shards
from avatarcraft_tpu_torch.utils.checkpoint import leaves
from avatarcraft_tpu_torch.utils.device import card_line
from avatarcraft_tpu_torch.utils.timing import busy_us, cuda_ms, device_us_without, kernel_device_us
from avatarcraft_tpu_torch.workloads.canonical_render import make_fast_frame_renderer
from avatarcraft_tpu_torch.workloads.reconstruct import (
    ImageSet,
    ReconstructConfig,
    make_batch_ray_fn,
    make_optimizer,
    make_train_scan_fast,
    make_train_step_fast,
    pixel_batches,
    setup,
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


def _phase_device_ms(prof, prefix: str = "train", phases=PHASES, backward: str = "backward") -> dict:
    """Device ms of each ``<prefix>.*`` phase over the profiled steps, from
    the real step's ranges: the kernels launched inside each range on the
    calling thread; every kernel that the autograd engine's own threads
    launched goes to the range open on the calling thread when its op
    began (a backward runs there while its caller waits: the VAE's
    pullback in ``stylize.vae``), else to the ``backward`` phase. The two table
    kernels are launched through ctypes, and the profiler ties them to the
    ops around them once, twice or not at all, so the ranges leave them out
    and their own device events are added, each once (the gather to
    ``gather``, the reduce-scatter to ``backward``)."""
    events = prof.events()
    ranges = [e for e in events if e.name.startswith(prefix + ".") and e.device_type == DeviceType.CPU]
    main_thread = ranges[0].thread
    ms = dict.fromkeys(phases, 0.0)
    for e in ranges:
        ms[e.name[len(prefix) + 1:]] += device_us_without(e, KERNEL_EVENTS) / 1e3
    for e in events:
        if e.device_type == DeviceType.CPU and e.thread != main_thread and e.cpu_parent is None:
            start = e.time_range.start
            phase = next((r.name[len(prefix) + 1:] for r in ranges
                          if r.time_range.start <= start <= r.time_range.end), backward)
            ms[phase] += device_us_without(e, KERNEL_EVENTS) / 1e3
    for name, phase in zip(KERNEL_EVENTS, ("gather", backward)):
        ms[phase] = ms.get(phase, 0.0) + kernel_device_us(events, name) / 1e3
    return ms


def _device_events(prof) -> list:
    """The profile's kernels and copies: the device's copies of host ranges
    (train.*, render.*, the optimizer's Optimizer.step#Adam.step) carry a
    host event's name; kernels never do."""
    host_names = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA and e.name not in host_names]


def _summed_by_key(events, keep) -> dict:
    """{key: (device_time_total summed in us, count)} of the events that
    ``keep`` takes, in first-seen order: what ``prof.key_averages()`` gives
    for them, without averaging the whole profile (whose device and CPU
    totals it works out for every event, which takes seconds a call at a
    fine SDS step's 10^5 kernels)."""
    totals: dict = {}
    for e in events:
        if keep(e):
            us, count = totals.get(e.key, (0.0, 0))
            totals[e.key] = (us + e.device_time_total, count + 1)
    return totals


def _top_kernels(prof, n_steps: int, k: int = 15) -> list:
    host_names = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    totals = _summed_by_key(prof.events(), lambda e: e.device_type == DeviceType.CUDA and e.key not in host_names)
    kernels = sorted(((key, us / 1e3 / n_steps, count // n_steps) for key, (us, count) in totals.items()),
                     key=lambda kv: -kv[1])[:k]
    return [{"name": name[:80], "ms_per_step": ms, "calls_per_step": c} for name, ms, c in kernels]


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
    device_events = _device_events(prof)
    busy = busy_us(device_events)
    phases = {k: v / PROFILED for k, v in _phase_device_ms(prof).items()}
    stages = {
        key: us / 1e3 / PROFILED
        for key, (us, _) in _summed_by_key(prof.events(), lambda e: e.key.startswith("render.")
                                           and e.device_type == DeviceType.CPU).items()
    }
    kernel_ms = {
        k: sum(e.time_range.elapsed_us() for e in device_events if k in e.name) / 1e3 / PROFILED
        for k in KERNEL_EVENTS
    }
    result = {
        "device": torch.cuda.get_device_name(0),
        "card": card_line(),
        "batch": cfg.batch_size,
        "normal_mode": fast_cfg.normal_mode,
        "ms_per_step": ms_per_step,
        "rays_per_sec": cfg.batch_size / ms_per_step * 1e3,
        "profiled_wall_ms_per_step": wall * 1e3 / PROFILED,
        "device_busy_ms_per_step": busy / 1e3 / PROFILED,
        "device_idle_share": 1.0 - busy / 1e6 / wall,
        "phase_device_ms_per_step": phases,
        # the kernels' summed time outside the phases
        "unphased_device_ms_per_step": sum(e.time_range.elapsed_us() for e in device_events) / 1e3 / PROFILED
        - sum(phases.values()),
        "stage_device_ms_per_step": stages,
        "table_kernel_ms_per_step": kernel_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "top_kernels": _top_kernels(prof, PROFILED),
    }
    print(json.dumps(result))
    return result


def scan_main(scan_steps: int, calls: int = 4, profiled_calls: int = 2) -> dict:
    """The fast step as a CUDA graph, ``scan_steps`` replays a call: ms per
    step over ``calls`` calls after two warm-up calls (the first captures),
    then ``profiled_calls`` calls under torch.profiler."""
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
    scan = make_train_scan_fast(fcfg, fast_cfg, opt, make_batch_ray_fn(ds.K, ds.H, ds.W), cfg.eikonal_weight,
                                cfg.bkg_mode, cfg.white_bkg, splice)
    images = torch.as_tensor(ds.images.reshape(ds.n_images, -1, 3), device=device)
    masks = torch.zeros((1, 1), device=device)
    grid = torch.full((129,) * 3, 100.0, device=device)
    poses = torch.as_tensor(ds.poses, device=device)
    rng = np.random.default_rng(cfg.seed)

    def blocks():
        while True:
            batches = list(pixel_batches(ds.n_images, ds.H * ds.W, cfg.batch_size, rng))
            for i in range(0, len(batches) - scan_steps + 1, scan_steps):
                chunk = batches[i : i + scan_steps]
                yield np.stack([v for v, _ in chunk]), np.stack([p for _, p in chunk])

    chunks = blocks()

    def call():
        vis, pis = next(chunks)
        return scan(rest, shards, poses, images, masks, vis, pis, sched.advance(scan_steps), grid)

    torch.cuda.reset_peak_memory_stats()  # the peak holds the graph's pool
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    before = dict(ring.launches)
    t0 = time.perf_counter()
    for _ in range(calls):
        losses = call()
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) * 1e3 / (calls * scan_steps)
    launches = {k: (ring.launches[k] - before[k]) / (calls * scan_steps) for k in before}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(profiled_calls):
            call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    n = profiled_calls * scan_steps
    device_events = _device_events(prof)
    busy = busy_us(device_events)
    result = {
        "device": torch.cuda.get_device_name(0),
        "card": card_line(),
        "batch": cfg.batch_size,
        "scan_steps": scan_steps,
        "normal_mode": fast_cfg.normal_mode,
        "ms_per_step": ms_per_step,
        "rays_per_sec": cfg.batch_size / ms_per_step * 1e3,
        "profiled_wall_ms_per_step": wall * 1e3 / n,
        "device_busy_ms_per_step": busy / 1e3 / n,
        "device_idle_share": 1.0 - busy / 1e6 / wall,
        "device_launches_per_step": len(device_events) / n,
        "table_kernel_ms_per_step": {k: kernel_device_us(prof.events(), k) / 1e3 / n for k in KERNEL_EVENTS},
        "table_kernel_launches_per_step": launches,
        "last_loss": float(losses[-1]),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "top_kernels": _top_kernels(prof, n),
    }
    print(json.dumps(result))
    return result


# -- the 64+64 (parity) path -------------------------------------------------

PARITY_PHASES = ("forward", "backward", "optimizer")


def parity_main(warmup: int = WARMUP, timed: int = 10, profiled: int = 3, print_json: bool = True) -> dict:
    """The 64+64 hash-grid step at the reconstruct CLI's parity defaults:
    ms per step on the host clock after ``warmup`` steps, then ``profiled``
    steps under torch.profiler (device ms per ``train.*`` range, busy, idle
    share, top kernels); peak memory over the timed and profiled steps."""
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures a CUDA card; none is available")
    device = "cuda"
    ds, _, _ = artifact_image_set(device)
    fcfg = FieldConfig(encoder="hashgrid")
    rcfg = RenderConfig(num_steps=64, upsample_steps=64, bound=1.6, perturb=True, normal_mode="fd7")
    cfg = ReconstructConfig()
    state, step, poses, _ = setup(ds, fcfg, rcfg, cfg, device)
    gen = torch.Generator(device).manual_seed(cfg.seed)
    batches = _batches(ds, cfg, device)
    for _ in range(warmup):
        step(state.params, poses, *next(batches), gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed):
        step(state.params, poses, *next(batches), gen)
    torch.cuda.synchronize()
    ms_per_step = (time.perf_counter() - t0) * 1e3 / timed
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(profiled):
            step(state.params, poses, *next(batches), gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    device_events = _device_events(prof)
    busy = busy_us(device_events)
    phases = _phase_device_ms(prof, "train", PARITY_PHASES)
    result = {
        "device": torch.cuda.get_device_name(0),
        "card": card_line(),
        "encoder": fcfg.encoder,
        "batch": cfg.batch_size,
        "samples": rcfg.total_steps,
        "normal_mode": rcfg.normal_mode,
        "ms_per_step": ms_per_step,
        "steps_per_sec": 1e3 / ms_per_step,
        "rays_per_sec": cfg.batch_size / ms_per_step * 1e3,
        "profiled_wall_ms_per_step": wall * 1e3 / profiled,
        "device_busy_ms_per_step": busy / 1e3 / profiled,
        "device_idle_share": 1.0 - busy / 1e6 / wall,
        "phase_device_ms_per_step": {k: v / profiled for k, v in phases.items()},
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "top_kernels": _top_kernels(prof, profiled, 10),
    }
    if print_json:
        print(json.dumps(result))
    return result


# -- the stylize path --------------------------------------------------------

STYLIZE_PHASES = ("gather", "phaseA", "sds", "vae", "phaseB", "refresh")
# the stylize CLI at its defaults on the committed artifact and toy guidance,
# the fast sampler (PARITY_STYLIZE_ARGV: the CLI's default sampler)
PARITY_STYLIZE_ARGV = [
    "--weights_path", bench.ARTIFACT_CKPT, "--guidance_type", "toy", "--tgt_text", "lava",
    "--toy_weights", os.path.join(bench.REPO_ROOT, "artifacts", "toy_guidance"), "--i_mesh", "1000000",
]
STYLIZE_ARGV = PARITY_STYLIZE_ARGV + ["--sampler", "fast"]
STYLIZE_WARMUP, STYLIZE_TIMED, STYLIZE_PROFILED = 2, 6, 2


SD_SEED = 0


def sd_guidance(version: str = "1.5", device="cuda") -> SDSGuidance:
    """Stable Diffusion ``version`` at its full width, its parameters drawn
    from a generator seeded SD_SEED on ``device``, behind the toy tokenizer."""
    gen = torch.Generator(device).manual_seed(SD_SEED)
    return SDSGuidance(random_stable_diffusion_modules(gen, version))


def stylize_trainer(grid_update_every: int | None = None, guidance: SDSGuidance | None = None):
    """The stylize CLI's trainer (``stylize_cli.setup``) at the CLI's
    defaults, ``--guidance_type toy --tgt_text lava --sampler fast``, on
    the card, with ``guidance`` in place of the toy guidance where given
    (the trainer's budget and grid do not depend on it)."""
    opt = stylize_cli.build_parser().parse_args(STYLIZE_ARGV)
    trainer, fcfg = stylize_cli.setup(opt, grid_update_every)
    if guidance is not None:
        trainer.guidance = guidance
    return trainer, fcfg


def stylize_views(trainer, epoch: int, n: int) -> list:
    """n (pose, desc) of the epoch's schedule, drawn from the trainer's rng
    as its own loop draws them (repeated when n exceeds an epoch)."""
    poses, descs = trainer.epoch_poses(epoch)
    order = trainer.rng.permutation(len(poses))
    return [(poses[order[i % len(order)]], descs[order[i % len(order)]]) for i in range(n)]


def time_stylize_steps(trainer, epoch: int, n: int) -> list[float]:
    """Host seconds of each of n SDS steps (each ends in a synchronize)."""
    out = []
    for pose, desc in stylize_views(trainer, epoch, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_view(pose, desc, epoch)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def profile_stylize_steps(trainer, epoch: int, n: int, prefix: str = "stylize") -> dict:
    """torch.profiler over n SDS steps: device ms per step of each
    ``<prefix>.*`` range (the autograd engine's kernels go to the range open
    when their op began, the reduce-scatter to phaseB, the all-gather to
    gather), device busy, idle share, top kernels. ``prefix``: 'stylize'
    for the single-prompt trainer, 'multi' for the multi-prompt one."""
    views = stylize_views(trainer, epoch, n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for pose, desc in views:
            trainer.train_view(pose, desc, epoch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    device_events = _device_events(prof)
    busy = busy_us(device_events)
    phases = _phase_device_ms(prof, prefix, STYLIZE_PHASES, "phaseB")
    # inside the ranges: the render stages' forward and Adam's step
    inner = {
        key: us / 1e3 / n
        for key, (us, _) in _summed_by_key(prof.events(), lambda e: e.device_type == DeviceType.CPU and (
            e.key.startswith("render.") or e.key.startswith("Optimizer.step"))).items()
    }
    return {
        "profiled_wall_ms_per_step": wall * 1e3 / n,
        "device_busy_ms_per_step": busy / 1e3 / n,
        "device_idle_share": 1.0 - busy / 1e6 / wall,
        "device_launches_per_step": len(device_events) / n,
        "range_device_ms_per_step": {k: v / n for k, v in phases.items()},
        # the kernels' summed time outside the ranges
        "unranged_device_ms_per_step": (sum(e.time_range.elapsed_us() for e in device_events) / 1e3
                                        - sum(phases.values())) / n,
        "inner_device_ms_per_step": inner,
        "top_kernels": _top_kernels(prof, n, 10),
    }


def time_refresh(trainer, reps: int = 3) -> dict:
    """CUDA-event ms of the grid refresh (the field's SDF on the 129^3
    lattice, with its gather) and of the floater pruning of the refreshed
    grid against the live one, each the mean of ``reps`` calls."""
    from avatarcraft_tpu_torch.ops.occupancy import prune_grid_floaters

    new = trainer._refresh_grid(trainer.params(), trainer.grid)
    prune = lambda: prune_grid_floaters(new, trainer.grid)  # noqa: E731
    refresh = lambda: trainer._refresh_grid(trainer.params(), trainer.grid)  # noqa: E731
    return {"refresh_ms": cuda_ms(refresh, iters=reps, warmup=1), "prune_ms": cuda_ms(prune, iters=reps, warmup=1)}


def stylize_main(guidance: str = "toy") -> dict:
    """SDS steps at coarse (64x64 frame, one 4096-ray patch) and fine
    (256x256, 16 patches) with the toy guidance or SD 1.5 (``guidance``
    'sd'): ms per step on the host clock, steps/s, and the profiled split
    by range. Refreshes are off in the timed steps."""
    if not torch.cuda.is_available():
        raise SystemExit("profile_train measures a CUDA card; none is available")
    trainer, _ = stylize_trainer(grid_update_every=0, guidance=sd_guidance() if guidance == "sd" else None)
    result = {"device": torch.cuda.get_device_name(0), "card": card_line(), "guidance": guidance,
              "normal_mode": trainer.fast_cfg.normal_mode, "sample_budget": trainer.fast_cfg.sample_budget}
    fine_epoch = trainer.cfg.coarse_epochs
    for stage, epoch in (("coarse", 0), ("fine", fine_epoch)):
        time_stylize_steps(trainer, epoch, STYLIZE_WARMUP)
        torch.cuda.reset_peak_memory_stats()
        secs = time_stylize_steps(trainer, epoch, STYLIZE_TIMED)
        result[stage] = {
            "ms_per_step": 1e3 * sum(secs) / len(secs),
            "steps_per_sec": len(secs) / sum(secs),
            "step_ms": [1e3 * x for x in secs],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            **profile_stylize_steps(trainer, epoch, STYLIZE_PROFILED),
        }
    result["refresh"] = time_refresh(trainer)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="where a train step's or an SDS step's time goes on the card")
    ap.add_argument("--path", default="reconstruct", choices=["reconstruct", "parity", "stylize"])
    ap.add_argument("--guidance", default="toy", choices=["toy", "sd"],
                    help="stylize: the toy guidance, or SD 1.5 at full width from random weights")
    ap.add_argument("--scan_steps", default=0, type=int,
                    help="reconstruct: S > 0 replays a CUDA graph of the step S times a call")
    args = ap.parse_args()
    if args.path == "stylize":
        stylize_main(args.guidance)
    elif args.path == "parity":
        parity_main()
    elif args.scan_steps > 0:
        scan_main(args.scan_steps)
    else:
        main()
