"""Occupancy-grid floater prune: keep the avatar, drop disconnected blobs.
Port of the JAX package's tools/prune_grid.py, with its flags and line.

SDS stylization grows isolated floater cells in the density grid, and they
saturate the same density cap as the body, so no threshold separates them;
topology does: the avatar is one large 26-connected component, floaters
are small disconnected blobs. The tool refreshes a 129^3 grid from zeros
through the checkpoint's SDF (``workloads/reconstruct.py::
make_grid_update_fn``), thresholds it at the sampler's min(10, mean),
labels the components (``scipy.ndimage.label``), keeps those with
``--min_cells`` or more (default: only the largest), zeroes the rest and
saves the ``.npy`` for the render CLIs' ``--grid_path``. The field itself
is untouched. The refresh runs on the CUDA card unless ``--platform cpu``
(the JAX tool's default is ``cpu``).

    python -m avatarcraft_tpu_torch.tools.prune_grid --ckpt lava.pth.tar --out grid_pruned.npy [--platform cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from scipy import ndimage

from avatarcraft_tpu_torch.constants import NSR_BOUND
from avatarcraft_tpu_torch.utils.checkpoint import load_params_with_config
from avatarcraft_tpu_torch.utils.device import tool_device
from avatarcraft_tpu_torch.workloads.reconstruct import make_grid_update_fn


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="field checkpoint (.pth.tar)")
    ap.add_argument("--out", required=True, help="output grid .npy")
    ap.add_argument("--min_cells", default=0, type=int,
                    help="keep components with >= this many occupied cells; 0 = keep only the largest component")
    ap.add_argument("--platform", default="default", choices=["cpu", "default"],
                    help="default: the CUDA card; cpu: the CPU")
    return ap


def main(argv=None) -> dict:
    """Run the tool; returns the counts it prints."""
    opt = build_parser().parse_args(argv)
    device = tool_device(opt.platform)

    params, fcfg = load_params_with_config(opt.ckpt, device)
    grid = make_grid_update_fn(fcfg, NSR_BOUND)(
        params, torch.zeros((129,) * 3, dtype=torch.float32, device=device)
    ).cpu().numpy()
    # occupancy at the sampler's threshold: min(occ_threshold = 10, mean(grid))
    thresh = min(10.0, float(grid.mean()))
    occ = grid > thresh
    labels, n = ndimage.label(occ, structure=np.ones((3, 3, 3), np.int8))
    sizes = np.bincount(labels.ravel())
    sizes[0] = 0  # background
    keep_min = opt.min_cells if opt.min_cells > 0 else int(sizes.max())
    keep = np.isin(labels, np.nonzero(sizes >= keep_min)[0])
    pruned = np.where(keep, grid, 0.0).astype(grid.dtype)
    np.save(opt.out, pruned)
    kept_components = int((sizes >= keep_min).sum())
    print(f"components: {n}, occupied {occ.sum()} -> kept {keep.sum()} cells "
          f"({kept_components} component(s)); saved {opt.out}")
    return {"components": int(n), "occupied": int(occ.sum()), "kept": int(keep.sum()),
            "kept_components": kept_components, "out": opt.out}


if __name__ == "__main__":
    main()
