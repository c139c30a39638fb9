"""Apply a styled field's sparse delta to its base artifact: the unpack side
of tools/style_delta.py.

A delta (``artifacts/styled/*_delta.npz``) stores, per leaf of the base
tree, either a dense f32 difference (``dense:{i}``: MLP tensors, the
variance) or the changed last-dim rows of a large table (``idx:{i}`` row
indices, ``val:{i}`` fp16 row differences), plus ``meta_json`` with the
field's config and, optionally, the styled density grid (``grid``, fp16).
The leaf index ``i`` counts leaves in the JAX package's flattening order
(dict keys sorted), which ``checkpoint.sorted_leaves`` rebuilds.

    python -m avatarcraft_tpu_torch.utils.style_delta \\
        --base artifacts/canonical/bare_smpl_tpu.pth.tar \\
        --delta artifacts/styled/multi_lava_delta.npz --out lava.pth.tar
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from avatarcraft_tpu_torch.models.instant_nsr import FieldConfig
from avatarcraft_tpu_torch.utils.checkpoint import (
    field_config_from_dict,
    load_params_with_config,
    replace_sorted_leaves,
    save_params_with_config,
    sorted_leaves,
)


def apply_delta(base: dict, delta_path: str):
    """(styled params, FieldConfig, styled density grid as f32 numpy or
    None): the delta at ``delta_path`` added to the parameter tree ``base``,
    on the device of ``base``'s leaves. The sums are taken in f32 on the
    host, as the JAX package takes them."""
    with np.load(delta_path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        old = sorted_leaves(base)
        new = list(old)
        for info in meta["tensors"]:
            i = info["leaf"]
            b = old[i].detach().to("cpu", torch.float32).numpy()
            if list(b.shape) != list(info["shape"]):
                raise ValueError(f"delta leaf {i} ({info.get('path')}): shape {info['shape']} "
                                 f"does not fit the base's {list(b.shape)}")
            if info["mode"] == "sparse_rows":
                rows = b.reshape(-1, b.shape[-1]).copy()
                rows[z[f"idx:{i}"]] += z[f"val:{i}"].astype(np.float32)
                out = rows.reshape(info["shape"])
            else:
                out = b + z[f"dense:{i}"]
            new[i] = torch.from_numpy(np.ascontiguousarray(out, np.float32)).to(old[i].device)
        grid = z["grid"].astype(np.float32) if meta.get("grid") else None
    return replace_sorted_leaves(base, new), field_config_from_dict(meta["fieldcfg"]), grid


def unpack(base_path: str, delta_path: str, out_path: str, grid_out: str | None = None) -> FieldConfig:
    """Write the styled field as ``out_path`` (.pth.tar) with its sidecar,
    and its density grid as ``grid_out`` (.npy) when both the delta holds
    one and a path is given."""
    base, _ = load_params_with_config(base_path, "cpu")
    params, fcfg, grid = apply_delta(base, delta_path)
    save_params_with_config(params, out_path, fcfg)
    if grid is not None and grid_out:
        np.save(grid_out, grid)
    return fcfg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True)
    ap.add_argument("--delta", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--grid_out", default=None)
    opt = ap.parse_args(argv)
    unpack(opt.base, opt.delta, opt.out, opt.grid_out)
    print(json.dumps({"out": opt.out, "grid": opt.grid_out}))


if __name__ == "__main__":
    main()
