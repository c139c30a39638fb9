"""Supersampled-coverage fine-tune against the raw dataset on black: port of
the JAX package's tools/finetune_ss.py, with its flags, defaults, draws and
JSON line.

The dataset's ground-truth edges are antialiased (partial coverage) where a
one-ray-per-pixel render is a point sample, so most of the native-resolution
error lies in the silhouette band. This fine-tune renders ss^2 box sub-rays
per training pixel (``workloads/reconstruct.py::make_batch_ray_fn_ss``) and
box-filters them before the photometric loss, against the raw images on
their own black background (``make_train_scan_fast(..., "raw", False,
ss=...)``): one consistent protocol, so the field learns partial edge
coverage. (The reconstruct CLI's defaults render on white against the same
black-backed images: the JAX package's ReconstructConfig calls that
inconsistent; this tool avoids it.)

Each call runs ``--scan`` steps (on the card one step captured into a CUDA
graph per tool run and replayed, K10's gather and reduce-scatter inside it),
so the steps run round up to a multiple of ``--scan``, as in the JAX tool.
Adam starts fresh on the cosine of ``make_optimizer(ReconstructConfig(lr,
epochs=1), --steps)`` even from a train state, whose step is carried on.
The grid refreshes (``make_grid_update_fn``, in place: the graph holds it)
after the calls that cross a multiple of ``--grid_refresh``. ``--edge_frac``
of each batch comes from the silhouette band (``silhouette_band``, numpy,
the JAX tool's pixel lists and draws bit for bit); the rest and the views
are uniform draws of ``np.random.default_rng(0)`` in the JAX tool's order.

``--out`` (and ``<out>_latest`` every ``--save_every`` steps) is the JAX
tool's orbax train-state directory with the trainer's Adam state
(``utils/checkpoint.py::save_train_state``); a path ending in ``.pt`` is a
port train-state file instead (so ``--out x.pt`` gives the file ``x.pt``
and the directory ``x.pt_latest``). Runs on the CUDA card unless
``--platform cpu``.

    python -m avatarcraft_tpu_torch.tools.finetune_ss --state recon/state_final --out recon/state_ss \\
        [--ss 2] [--steps 3000] [--platform cpu]
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
from avatarcraft_tpu_torch.tools.finetune_color import load_start, train_views
from avatarcraft_tpu_torch.utils.checkpoint import leaves, save_train_state
from avatarcraft_tpu_torch.utils.device import tool_device
from avatarcraft_tpu_torch.workloads.reconstruct import (
    ReconstructConfig,
    adam_moments,
    make_batch_ray_fn_ss,
    make_grid_update_fn,
    make_optimizer,
    make_train_scan_fast,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--state", default=None, help="train state to start from: an orbax directory or a port .pt file")
    ap.add_argument("--ckpt", default=None,
                    help="alternative start: baked .pth.tar artifact (params via the fieldcfg sidecar; fresh opt "
                         "state)")
    ap.add_argument("--grid_path", default=None,
                    help="density grid .npy for --ckpt (e.g. artifacts/canonical/grid.npy)")
    ap.add_argument("--out", required=True, help="output orbax state dir (a path ending in .pt: a port file)")
    ap.add_argument("--data_path", default="data/smpl_da_512", help="a Blender-format set (reconstruct_cli's default)")
    ap.add_argument("--holdout_views", default="13,62,95")
    ap.add_argument("--normal_mode", default="fd4")
    ap.add_argument("--ss", default=2, type=int)
    ap.add_argument("--steps", default=3000, type=int)
    ap.add_argument("--scan", default=25, type=int)
    ap.add_argument("--batch", default=2048, type=int, help="PIXELS per step")
    ap.add_argument("--lr", default=1e-4, type=float)
    ap.add_argument("--eikonal", default=0.1, type=float)
    ap.add_argument("--grid_refresh", default=1000, type=int)
    ap.add_argument("--encoder", default="tpu_pyramid")
    ap.add_argument("--edge_frac", default=0.0, type=float,
                    help="fraction of each batch importance-sampled from the silhouette band (mask-boundary "
                         "dilation); rest uniform")
    ap.add_argument("--edge_band", default=3, type=int, help="half-width in pixels of the silhouette band")
    ap.add_argument("--save_every", default=0, type=int, help="also save to <out>_latest every N steps")
    ap.add_argument("--platform", default="default", choices=["cpu", "default"],
                    help="default: the CUDA card; cpu: the CPU")
    return ap


def silhouette_band(masks: np.ndarray, b: int) -> tuple[np.ndarray, np.ndarray]:
    """Per view, the pixels within ``b`` of the mask boundary (its dilation
    minus its erosion over a (2b+1)^2 shift window, np.roll's wrap
    included): (edge_mat [V, max_len] int32, zero-padded flat pixel
    indices; edge_len [V] int64), the JAX tool's lists."""
    m = masks.astype(bool)  # [V, H, W]
    lo, hi = m.copy(), m.copy()
    for dy in range(-b, b + 1):
        for dx in range(-b, b + 1):
            if dy == 0 and dx == 0:
                continue
            sh = np.roll(np.roll(m, dy, axis=1), dx, axis=2)
            lo &= sh
            hi |= sh
    band = hi & ~lo
    per_view = [np.flatnonzero(band[v].reshape(-1)).astype(np.int32) for v in range(len(m))]
    edge_len = np.asarray([len(e) for e in per_view], np.int64)
    edge_mat = np.zeros((len(m), int(edge_len.max())), np.int32)
    for v, e in enumerate(per_view):
        edge_mat[v, : len(e)] = e
    return edge_mat, edge_len


def draw_call(rng: np.random.Generator, views: np.ndarray, S: int, B: int, n_pix: int, B_edge: int = 0,
              edge_lists=None) -> tuple[np.ndarray, np.ndarray]:
    """The [S, B] (view, pixel) index blocks of one call, the JAX tool's
    draws in its order: views, then pixels, then the first ``B_edge``
    columns' pixels again from their views' silhouette bands."""
    vis = views[rng.integers(0, len(views), (S, B))].astype(np.int32)
    pis = rng.integers(0, n_pix, (S, B)).astype(np.int32)
    if B_edge:
        edge_mat, edge_len = edge_lists
        vi = vis[:, :B_edge].astype(np.int64)
        r = rng.integers(0, 1 << 62, (S, B_edge)) % edge_len[vi]
        pis[:, :B_edge] = edge_mat[vi, r]
    return vis, pis


def main(argv=None) -> dict:
    """Run the tool; returns the JSON result it prints."""
    ap = build_parser()
    opt = ap.parse_args(argv)
    device = tool_device(opt.platform)

    ds = SMPLMultiviewDataset(opt.data_path)
    start = load_start(opt, ap, device)  # its Adam state is not read: Adam starts fresh
    fcfg, grid, start_step = start["fcfg"], start["grid"], int(start["step"])
    rest, shards, splice = trainable_shards(start["params"])
    del start
    optimizer, schedule = make_optimizer(ReconstructConfig(lr=opt.lr, epochs=1), opt.steps, leaves(rest) + shards)

    ss2 = opt.ss * opt.ss
    fast_cfg = nsr.FastRenderConfig(n_probes=128, k_samples=32, bound=NSR_BOUND, normal_mode=opt.normal_mode,
                                    sample_budget=opt.batch * ss2 * 8)
    ray_fn = make_batch_ray_fn_ss(ds.K, ds.H, ds.W, opt.ss)
    # raw protocol: render on the dataset's own black background
    scan = make_train_scan_fast(fcfg, fast_cfg, optimizer, ray_fn, opt.eikonal, "raw", False, splice, ss=opt.ss)
    refresh = make_grid_update_fn(fcfg, NSR_BOUND)

    views = train_views(ds.n_images, opt.holdout_views)
    poses = torch.as_tensor(np.asarray(ds.poses, np.float32), device=device)
    images_flat = torch.as_tensor(np.asarray(ds.images, np.float32).reshape(ds.n_images, -1, 3), device=device)
    masks_flat = torch.zeros((1, 1), device=device)  # the raw protocol reads no mask

    edge_lists = None
    if opt.edge_frac > 0:
        edge_lists = silhouette_band(ds.masks, opt.edge_band)
        edge_len = edge_lists[1]
        print(f"silhouette band: mean {edge_len.mean():.0f} px/view ({100 * edge_len.mean() / (ds.H * ds.W):.1f}%)",
              file=sys.stderr)

    def save(path: str, step: int) -> None:
        mu, nu, count = adam_moments(optimizer, rest, shards, splice)
        save_train_state(path, gathered_params(rest, shards, splice), mu, nu, count, step, grid)

    rng = np.random.default_rng(0)
    B, S = opt.batch, opt.scan
    B_edge = int(round(B * opt.edge_frac))
    n_calls = (opt.steps + S - 1) // S
    t0, done = None, 0
    for c in range(n_calls):
        vis, pis = draw_call(rng, views, S, B, ds.H * ds.W, B_edge, edge_lists)
        losses = scan(rest, shards, poses, images_flat, masks_flat, vis, pis, schedule.advance(S), grid)
        done += S
        if c == 0:
            losses = losses.cpu()  # timed from the end of the first call (it holds the capture)
            t0 = time.perf_counter()
        if c % 5 == 0 or c == n_calls - 1:
            rate = (done - S) / max(time.perf_counter() - t0, 1e-9)
            print(f"step {done}: loss {losses.cpu().numpy()[-5:].mean():.5f} ({rate:.1f} steps/s)", file=sys.stderr)
        if opt.grid_refresh and done % opt.grid_refresh < S:
            grid.copy_(refresh(gathered_params(rest, shards, splice), grid))
        if opt.save_every and done % opt.save_every < S and done < opt.steps:
            save(opt.out + "_latest", start_step + done)
            print(f"saved {opt.out}_latest at step {done}", file=sys.stderr)

    save(opt.out, start_step + opt.steps)
    result = {"out": opt.out, "steps": opt.steps, "ss": opt.ss,
              "final_loss": float(losses.cpu().numpy()[-5:].mean())}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
