#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (avatarcraft_tpu_torch).

    python3 chip_smoke.py            # on a machine with one CUDA card

Phases, each printed with its start, end and wall seconds:

1. device  -- fails unless torch sees a CUDA card; prints its name, the
              card count and nvidia-smi's name and power limit;
2. build   -- nvcc builds every kernel of csrc/ into avatarcraft_tpu_torch/_build;
3. kernel  -- all_gather_rows against its plain version (torch.cat) for
              1/2/4/8 shards of the 128^3 x 4 grid table in f32 and fp16,
              the 128-shard cap, 5 shards (spans across shard boundaries)
              and ragged and misaligned cases (through the wrapper, and
              launched over an output of all-ones bytes), and reduce_scatter_rows
              against its plain version for m = 1/2/4 replicas x n =
              1/2/4/8 shards of that table in f32 and two ragged cases:
              bitwise equal; the gather's wrapper puts no host-to-device
              copy on the card (torch.profiler); times each kernel, its
              wrapper, plain version and library call with CUDA events
              (``kernel_ms``: the kernel alone, printed again as ``ms`` in
              the kernels line; ``wrapper_ms``: with the wrapper's
              allocation and pointer handling), in a warm loop and again
              with the L2 cache flushed before every call
              (``kernel_cold_ms``, ``library_cold_ms``), as the main paths
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
6. tablemp -- the table-parallel step (parallel.table_mp) from the
              artifact's parameters, 64+64 samples with fd7 normals, 1024 rays
              of bench camera 0 against the fast renderer's frame, SGD: 1
              shard three times and 4 shards once; the 1- and 4-shard losses
              bitwise equal, the 4-shard table gradient within twice the
              largest difference between two 1-shard runs (the encoder's
              backward adds with atomics); both table kernels launched;
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
              and variance gradient within 1e-2 x its max|g|.

Before the last line it prints one JSON object {"kernels": [...]} and the
card's name and power limit; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero without it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

import avatarcraft_tpu_torch
from avatarcraft_tpu_torch import bench, profile_train
from avatarcraft_tpu_torch.cameras import pose2rays
from avatarcraft_tpu_torch.models.instant_nsr import FastRenderConfig, RenderConfig, count_fast_samples
from avatarcraft_tpu_torch.parallel import ring
from avatarcraft_tpu_torch.parallel.table_mp import TableMPTrainStep, trainable_shards
from avatarcraft_tpu_torch.utils.checkpoint import leaves
from avatarcraft_tpu_torch.utils import cuda_build, style_delta
from avatarcraft_tpu_torch.utils.device import card_line
from avatarcraft_tpu_torch.utils.timing import cold_device_ms, cuda_ms, cuda_ms_cold, device_names
from avatarcraft_tpu_torch.warp import WarpData
from avatarcraft_tpu_torch.workloads import reconstruct
from avatarcraft_tpu_torch.workloads.canonical_render import make_fast_frame_renderer
from avatarcraft_tpu_torch.workloads.warp_render import (
    WarpRenderSettings,
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
HERE = os.path.dirname(os.path.abspath(__file__))
LAVA_DELTA = os.path.join(HERE, "artifacts", "styled", "multi_lava_delta.npz")
STYLED_GOLDEN = os.path.join(HERE, "tests", "golden_styled_warp_32.npy")
STYLED_RES, STYLED_FRAME = 32, 10  # tests/test_styled_warp.py:56-84
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
    seconds = cuda_build.build(list(KERNELS))
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

    # the wrapper copies nothing to the card: over ten calls the profiler
    # sees the kernel and no host-to-device copy (and does see the copies
    # pointer_array makes)
    shards = [torch.randn(GRID_ROWS // 4, GRID_COLS, generator=gen, device="cuda") for _ in range(4)]
    control = device_names(lambda: ring.pointer_array(shards))
    names = device_names(lambda: ring.all_gather_rows(shards))
    print(f"all_gather_rows puts on the card: {sorted(set(names))} ({len(names)} events in ten calls); "
          f"pointer_array: {sorted(set(control))}", flush=True)
    if any("Memcpy HtoD" in name for name in names) or not any("gather_rows_kernel" in name for name in names):
        raise AssertionError(f"all_gather_rows wrapper: device events {names}")
    if not any("Memcpy HtoD" in name for name in control):
        raise AssertionError(f"the profiler did not show pointer_array's host-to-device copy: {control}")

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
    return {"max_abs_err": max_err, **timings[1]}


def check_reduce_scatter_kernel() -> dict:
    """reduce_scatter_rows vs its plain version, bitwise, for m replicas x
    n shards of the 128^3 x 4 table and two ragged cases; timings at the
    training path's shape (one replica, one shard per card)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err, n_cases = 0.0, 0

    def check(cts, n, what):
        nonlocal max_err, n_cases
        got = ring.reduce_scatter_rows(cts, n)
        want = ring.reduce_scatter_rows_plain(cts, n)
        torch.cuda.synchronize()
        if len(got) != n or not all(_same_bits(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"reduce_scatter_rows != its plain version for {what}")
        max_err = max(max_err, max(float((g - w).abs().max()) for g, w in zip(got, want)))
        n_cases += 1

    for m in (1, 2, 4):
        cts = [torch.randn(GRID_ROWS, GRID_COLS, generator=gen, device="cuda") for _ in range(m)]
        for n in (1, 2, 4, 8):
            check(cts, n, f"m={m} n={n} [{GRID_ROWS},{GRID_COLS}]")
    # 3-float rows, shards of 3003 floats: the scalar path
    check([torch.randn(3 * 1001, 3, generator=gen, device="cuda") for _ in range(2)], 3, "m=2 n=3 [3003,3]")
    # a table that starts 4 bytes past a 16-byte boundary
    base = torch.randn(2, 4 * 64 * 4 + 1, generator=gen, device="cuda")
    check([b[1:].view(4 * 64, 4) for b in base], 4, "m=2 n=4, misaligned")
    print(f"reduce_scatter_rows bitwise equal to its plain version in {n_cases} cases", flush=True)

    timings = {}
    for m, n in ((1, 1), (1, 4), (4, 1)):
        cts = [torch.randn(GRID_ROWS, GRID_COLS, generator=gen, device="cuda") for _ in range(m)]
        outs = [torch.empty(GRID_ROWS // n, GRID_COLS, device="cuda") for _ in range(n)]
        ptrs = ring.pointer_array(cts + outs)
        nbytes = (m + 1) * GRID_ROWS * GRID_COLS * 4  # read m tables, write one table's worth
        kernel = lambda: ring.launch_reduce_scatter(ptrs, GRID_ROWS // n, GRID_COLS, m, n)  # noqa: E731
        library = lambda: [c.contiguous() for c in torch.stack(cts).sum(0).chunk(n)]  # noqa: E731
        kernel_dev, _ = cold_device_ms(kernel)
        library_dev, _ = cold_device_ms(library)
        t = {
            "kernel_ms": cuda_ms(kernel),
            "wrapper_ms": cuda_ms(lambda: ring.reduce_scatter_rows(cts, n)),
            "plain_ms": cuda_ms(lambda: ring.reduce_scatter_rows_plain(cts, n)),
            "library_ms": cuda_ms(library),
            "kernel_cold_ms": cuda_ms_cold(kernel),
            "library_cold_ms": cuda_ms_cold(library),
            "kernel_cold_device_ms": kernel_dev,
            "library_cold_device_ms": library_dev,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
        print(f"reduce_scatter_rows m={m} n={n} [{GRID_ROWS},{GRID_COLS}] f32: " + json.dumps(t), flush=True)
        timings[(m, n)] = t
    return {"max_abs_err": max_err, **timings[(1, 1)]}


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
    """1 shard three times, 4 shards once: the losses bitwise equal; the
    4-shard table gradient within twice the largest difference between two
    of the 1-shard runs (the encoder's backward adds with atomics, so no
    two runs add in one order)."""
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
    if diff > 2 * spread:
        raise AssertionError(f"table_mp: 4-shard table gradient off by {diff} > 2 x spread {spread}")
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
        styled, fcfg, _ = style_delta.apply_delta(base, LAVA_DELTA)
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


def main() -> int:
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"chip_smoke: {avatarcraft_tpu_torch.__name__} {avatarcraft_tpu_torch.__version__}", flush=True)
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
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        print("chip_smoke: FAILED", flush=True)
        return 1
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
            "kernel_ms": m["kernel_ms"],
            "wrapper_ms": m["wrapper_ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": "bytes",
            "library_ms": m["library_ms"],
            "kernel_cold_ms": m["kernel_cold_ms"],  # L2 flushed before each call
            "library_cold_ms": m["library_cold_ms"],
            # the profiler's device time of what one call launches, in the same cold loop
            "kernel_cold_device_ms": m["kernel_cold_device_ms"],
            "library_cold_device_ms": m["library_cold_device_ms"],
        })
    print(f"chip_smoke: all phases ok in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
