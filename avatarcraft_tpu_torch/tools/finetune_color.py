"""Color-net-only fine-tune to adapt a trained field to another normal
estimator (e.g. fd4 -> analytic): port of the JAX package's
tools/finetune_color.py, with its flags, defaults and batches.

The color MLP conditions on the normal (reference: models/instant_nsr.py
:644-663 feeds [x, normal, geo_feat]), so a field trained with fd4 normals
loses about 1 dB when rendered with analytic normals. Re-fitting only the
color net, with the SDF MLP, the encoder tables and the variance frozen and
the eikonal weight 0, closes the gap without touching the geometry.

The optimizer is ``torch.optim.Adam(lr, eps=1e-15)`` over the color leaves
alone (the JAX tool's ``optax.multi_transform`` of adam on ``color`` and
``set_to_zero`` elsewhere), and every other leaf has ``requires_grad``
off: its output is bitwise its input, and the backward never reaches the
tables, so a step launches K10's gather (``parallel/ring.py::
all_gather_rows``) once and its reduce-scatter never. The step is
``workloads/reconstruct.py::make_train_step_fast`` on black with 128
probes and K = 32; the batches come from ``np.random.default_rng(0)``
draw for draw as the JAX tool's, over the views minus ``--holdout_views``.

The field is a train state (``--state``: an orbax directory such as
either package's ``state_final``, or a port ``.pt`` file) or a baked
artifact (``--ckpt`` with ``--grid_path``, starting from a fresh Adam
state). ``--out`` is the JAX tool's orbax train-state directory, or a port
train-state file where it ends in ``.pt`` (``utils/checkpoint.py::
save_train_state``), holding the trained parameters, the input state's
Adam moments and count (the JAX tool keeps the "original moments"), the
grid and ``step + --steps``; ``bake_artifact`` and ``eval_psnr`` of
either package read the directory. Runs on the CUDA card unless
``--platform cpu``.

    python -m avatarcraft_tpu_torch.tools.finetune_color --state recon/state_final \\
        --out recon/state_color_ana [--normal_mode analytic] [--steps 800] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from avatarcraft_tpu_torch.constants import NSR_BOUND
from avatarcraft_tpu_torch.data import SMPLMultiviewDataset
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.parallel.table_mp import gathered_params, trainable_shards
from avatarcraft_tpu_torch.utils.checkpoint import (
    leaves,
    load_params_with_config,
    load_train_state,
    map_leaves,
    save_train_state,
)
from avatarcraft_tpu_torch.utils.device import tool_device
from avatarcraft_tpu_torch.workloads.reconstruct import make_batch_ray_fn, make_train_step_fast


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", default=None, help="train state: an orbax directory or a port .pt file")
    ap.add_argument("--ckpt", default=None,
                    help="alternative source: a baked reference-format .pth.tar (e.g. the committed artifact) + "
                         "--grid_path")
    ap.add_argument("--grid_path", default="artifacts/canonical/grid.npy")
    ap.add_argument("--out", required=True, help="output orbax state dir (a path ending in .pt: a port file)")
    ap.add_argument("--data_path", default="data/smpl_da_512", help="a Blender-format set (reconstruct_cli's default)")
    ap.add_argument("--holdout_views", default="13,62,95")
    ap.add_argument("--normal_mode", default="analytic")
    ap.add_argument("--steps", default=800, type=int)
    ap.add_argument("--batch", default=4096, type=int)
    ap.add_argument("--lr", default=5e-4, type=float)
    ap.add_argument("--encoder", default="tpu_pyramid")
    ap.add_argument("--platform", default="default", choices=["cpu", "default"],
                    help="default: the CUDA card; cpu: the CPU")
    return ap


def load_start(opt, ap: argparse.ArgumentParser, device) -> dict:
    """The field a fine-tune starts from: {"params", "fcfg", "grid", "mu",
    "nu", "count", "step"}. ``--ckpt`` with ``--grid_path``: the baked
    artifact, with a fresh Adam state (zero moments, count 0) at step 0;
    else ``--state``, the train state (its FieldConfig ``--encoder``'s)."""
    if opt.ckpt:
        if not opt.grid_path:
            ap.error("--ckpt requires --grid_path")
        params, fcfg = load_params_with_config(opt.ckpt, device)
        start = {"params": params, "fcfg": fcfg, "mu": map_leaves(params, torch.zeros_like),
                 "nu": map_leaves(params, torch.zeros_like),
                 "count": 0, "step": 0,
                 "grid": torch.as_tensor(np.load(opt.grid_path), dtype=torch.float32, device=device)}
        print(f"loaded baked artifact {opt.ckpt} (encoder={fcfg.encoder})", file=sys.stderr)
        return start
    if not opt.state:
        ap.error("one of --state / --ckpt is required")
    state = load_train_state(opt.state, device)
    if state["grid"] is None:
        raise SystemExit(f"{opt.state} holds no density grid (not a fast trainer's state)")
    print(f"loaded step {state['step']} from {opt.state}", file=sys.stderr)
    return {**state, "fcfg": nsr.FieldConfig(encoder=opt.encoder), "grid": state["grid"].contiguous()}


def train_views(n_images: int, holdout_views: str) -> np.ndarray:
    """The views a fine-tune draws from: all but ``--holdout_views``."""
    holdout = {int(v) for v in holdout_views.split(",") if v.strip()}
    return np.asarray([v for v in range(n_images) if v not in holdout], np.int32)


def color_only(rest: dict, shards) -> list[torch.Tensor]:
    """The color MLP's leaves of ``rest``, the only ones left trainable:
    every other leaf of ``rest`` and the table ``shards`` stop requiring
    grad (so the backward runs through neither)."""
    for t in leaves({k: v for k, v in rest.items() if k != "color"}) + list(shards):
        t.requires_grad_(False)
    return leaves(rest["color"])


def main(argv=None) -> dict:
    """Run the tool; returns the JSON result it prints."""
    ap = build_parser()
    opt = ap.parse_args(argv)
    device = tool_device(opt.platform)

    ds = SMPLMultiviewDataset(opt.data_path)
    start = load_start(opt, ap, device)
    fcfg, grid = start["fcfg"], start["grid"]
    rest, shards, splice = trainable_shards(start["params"])
    optimizer = torch.optim.Adam(color_only(rest, shards), lr=opt.lr, eps=1e-15)

    fast_cfg = nsr.FastRenderConfig(n_probes=128, k_samples=32, bound=NSR_BOUND, normal_mode=opt.normal_mode)
    ray_fn = make_batch_ray_fn(ds.K, ds.H, ds.W)
    step_fn = make_train_step_fast(fcfg, fast_cfg, optimizer, ray_fn, 0.0, splice)

    views = train_views(ds.n_images, opt.holdout_views)
    poses = torch.as_tensor(np.asarray(ds.poses, np.float32), device=device)
    rng = np.random.default_rng(0)
    losses, t0 = [], None
    for step in range(opt.steps):
        vi = views[rng.integers(0, len(views), opt.batch)]
        pi = rng.integers(0, ds.H * ds.W, opt.batch).astype(np.int32)
        gt = torch.as_tensor(ds.gather_rgb(vi, pi), device=device)  # raw ground truth, black background
        loss, _ = step_fn(rest, shards, poses, torch.as_tensor(vi.astype(np.int64), device=device),
                          torch.as_tensor(pi.astype(np.int64), device=device), gt, grid, 0.0)
        losses.append(loss)
        if step == 0:
            float(loss)  # timed from the end of the first step
            t0 = time.perf_counter()
        if step % 100 == 0:
            print(f"step {step}: loss {float(loss):.5f}", file=sys.stderr)
    losses = [float(l) for l in losses]
    dt = time.perf_counter() - t0 if t0 else 0.0
    print(f"{opt.steps} steps in {dt:.1f}s ({(opt.steps - 1) / max(dt, 1e-9):.2f} steps/s)", file=sys.stderr)

    params = gathered_params(rest, shards, splice)
    step = int(start["step"]) + opt.steps
    # the input state's Adam moments and count, as the JAX tool saves them
    save_train_state(opt.out, params, start["mu"], start["nu"], start["count"], step, grid)
    print(f"saved {opt.out}", file=sys.stderr)
    result = {"out": opt.out, "step": step, "steps": opt.steps, "normal_mode": opt.normal_mode, "losses": losses}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
