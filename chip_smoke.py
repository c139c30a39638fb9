#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (avatarcraft_tpu_torch).

    python3 chip_smoke.py            # on a machine with one CUDA card

Phases, each printed with its start, end and wall seconds:

1. device  -- fails unless torch sees a CUDA card; prints its name, the
              card count and nvidia-smi's name and power limit;
2. build   -- nvcc builds every kernel of csrc/ into avatarcraft_tpu_torch/_build;
3. kernel  -- all_gather_rows against its plain version (torch.cat) for
              1/2/4/8 shards of the 128^3 x 4 grid table in f32 and fp16 and
              two ragged cases: bitwise equal; times kernel, plain version
              and library call with CUDA events (``kernel_ms``: the kernel
              alone, printed again as ``ms`` in the kernels line;
              ``wrapper_ms``: with the wrapper's allocation and pointer copy);
4. main    -- the port's bench (avatarcraft_tpu_torch.bench.run): the baked
              artifact rendered at 256x256 from the 16 bench cameras with a
              derived, zero-clip sample budget; every frame finite; the
              gather kernel launched; then one frame with the table split 4
              ways, bitwise equal to the 1-shard frame;
5. cpu     -- one 32x32 frame on the card and on the CPU (plain path),
              equal within 2e-3.

Before the last line it prints one JSON object {"kernels": [...]} and the
card's name and power limit; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero without it.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
import traceback

import numpy as np
import torch

import avatarcraft_tpu_torch
from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.cameras import pose2rays
from avatarcraft_tpu_torch.models.instant_nsr import count_fast_samples
from avatarcraft_tpu_torch.parallel import ring
from avatarcraft_tpu_torch.utils import cuda_build
from avatarcraft_tpu_torch.utils.device import card_line
from avatarcraft_tpu_torch.workloads.canonical_render import make_fast_frame_renderer

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
CARD_VS_CPU_ATOL = 2e-3  # the pin tests/test_styled_warp.py:112 holds JAX to
GRID_ROWS, GRID_COLS = 128**3, 4  # the artifact's finest grid as a table
KERNELS = [
    {
        "name": "all_gather_rows",
        "route": "cuda",
        "source": "avatarcraft_tpu_torch/csrc/all_gather_rows.cu",
        "replaces": "avatarcraft_tpu/parallel/ring.py:27",
    }
]


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


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this check needs a CUDA card")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"device: {name} x{count}", flush=True)
    print(f"nvidia-smi: {card_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    return {"platform": "gpu", "kind": name, "count": count}


def build_kernels() -> None:
    seconds = cuda_build.build([ring.KERNEL])
    for name, s in seconds.items():
        print(f"built {name} in {s:.2f} s -> {cuda_build.library_path(name)}", flush=True)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    int_of = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(int_of), b.view(int_of))


def check_kernel() -> dict:
    """all_gather_rows vs torch.cat, bitwise; timings at the main path's
    shape (one shard per card: the whole table in one shard)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        (n, dtype, GRID_ROWS // n, GRID_COLS)
        for n in (1, 2, 4, 8)
        for dtype in (torch.float32, torch.float16)
    ]
    cases.append((3, torch.float16, 1001, 3))  # 6-byte rows: byte path
    max_err = 0.0
    for n, dtype, rows, cols in cases:
        shards = [torch.randn(rows, cols, generator=gen, device="cuda").to(dtype) for _ in range(n)]
        got = ring.all_gather_rows(shards)
        want = ring.all_gather_rows_plain(shards)
        torch.cuda.synchronize()
        if not _same_bits(got, want):
            raise AssertionError(f"all_gather_rows != torch.cat for n={n} {dtype} [{rows},{cols}]")
        max_err = max(max_err, float((got.float() - want.float()).abs().max()))
    # shards that start 6 bytes past a 16-byte boundary
    base = torch.randn(4, 1002, 3, generator=gen, device="cuda").half()
    shards = [b[1:] for b in base]
    if not _same_bits(ring.all_gather_rows(shards), ring.all_gather_rows_plain(shards)):
        raise AssertionError("all_gather_rows != torch.cat for misaligned shards")
    print(f"all_gather_rows bitwise equal to torch.cat in {len(cases) + 1} cases", flush=True)

    timings = {}
    for n in (1, 4):
        shards = [
            torch.randn(GRID_ROWS // n, GRID_COLS, generator=gen, device="cuda") for _ in range(n)
        ]
        nbytes = 2 * GRID_ROWS * GRID_COLS * 4  # read every shard once, write the table once
        ptrs = ring.shard_pointer_array(shards)
        out = torch.empty(GRID_ROWS, GRID_COLS, device="cuda")
        t = {
            "kernel_ms": cuda_ms(lambda: ring.launch(ptrs, out, GRID_ROWS // n, GRID_COLS * 4, n)),
            "wrapper_ms": cuda_ms(lambda: ring.all_gather_rows(shards)),
            "plain_ms": cuda_ms(lambda: ring.all_gather_rows_plain(shards)),
            "library_ms": cuda_ms(lambda: torch.cat(shards, dim=0)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
        print(f"all_gather_rows n={n} [{GRID_ROWS},{GRID_COLS}] f32: " + json.dumps(t), flush=True)
        timings[n] = t
    return {"max_abs_err": max_err, **timings[1]}


def check_main_path() -> dict:
    ring.launches = 0
    result = bench.run("cuda")
    launches = ring.launches
    frames = result.pop("frames")
    for i, f in enumerate(frames):
        if f.shape != (bench.RES, bench.RES, 3) or not torch.isfinite(f).all():
            raise AssertionError(f"frame {i}: shape {tuple(f.shape)} or non-finite values")
    if not (frames[0] < 0.99).any():
        raise AssertionError("frame 0 is empty: the body was not rendered")
    print("bench: " + json.dumps(result), flush=True)
    print(f"main path: {result['value']:.1f} rays/s, all_gather_rows launches {launches}", flush=True)
    if launches <= 0:
        raise AssertionError("the main path never launched all_gather_rows")

    params, fcfg, grid, cfg = bench.load_artifact("cuda")
    cfg = dataclasses.replace(cfg, sample_budget=result["sample_budget"])
    render4 = make_fast_frame_renderer(params, fcfg, cfg, grid, chunk=bench.RES * bench.RES, n_shards=4)
    ro, rd = pose2rays(bench.RES, bench.RES, bench.bench_poses()[0], device="cuda")
    frame4 = render4(ro, rd)["rgb"].reshape(bench.RES, bench.RES, 3).cpu()
    if not torch.equal(frame4, frames[0]):
        diff = float((frame4 - frames[0]).abs().max())
        raise AssertionError(f"4-shard frame differs from the 1-shard frame (max {diff})")
    print("4-shard frame bitwise equal to the 1-shard frame", flush=True)
    return {"launches": launches}


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
            gather = check_kernel()
        with Phase("main"):
            main_path = check_main_path()
        with Phase("cpu"):
            check_card_vs_cpu()
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        print("chip_smoke: FAILED", flush=True)
        return 1
    kernels = [{
        **KERNELS[0],
        "launches": main_path["launches"],
        "max_abs_err": gather["max_abs_err"],
        "ms": gather["kernel_ms"],  # the same number as kernel_ms
        "kernel_ms": gather["kernel_ms"],
        "wrapper_ms": gather["wrapper_ms"],
        "plain_ms": gather["plain_ms"],
        "bound_ms": gather["bound_ms"],
        "bound_by": "bytes",
        "library_ms": gather["library_ms"],
    }]
    print(f"chip_smoke: all phases ok in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
