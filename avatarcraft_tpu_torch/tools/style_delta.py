"""Pack or unpack a styled field as a sparse delta against its base
artifact: port of the JAX package's tools/style_delta.py, with its
subcommands, flags, file layout and JSON lines.

A stylized field shares its base checkpoint's tree, and SDS only gathers
encoder rows near the surface: a row never gathered gets a zero gradient
on every step, so Adam leaves it exactly as it was, and ``styled - base``
is sparse in table rows. ``pack`` stores, per leaf in the JAX package's
flattening order (``checkpoint.sorted_leaves``), the changed last-dim rows
of each leaf of ``SPARSE_MIN_ELEMS`` elements or more (int64 row indices
``idx:{i}``, fp16 row differences ``val:{i}``) and every smaller leaf as a
dense f32 difference (``dense:{i}``), the optional styled grid in fp16
(``grid``) and ``meta_json`` (uint8 JSON: the base's file name, one entry
per leaf with its ``jax.tree_util.keystr`` path, the field's config), into
one ``np.savez_compressed`` file. ``unpack`` adds a delta to its base
(``utils/style_delta.py::apply_delta``) and writes the styled checkpoint.
The differences are taken in numpy f32 on the host, as the JAX tool takes
them; the checkpoints are read onto the CUDA card unless ``--platform
cpu`` (the JAX tool has no such flag and reads on the CPU).

    python -m avatarcraft_tpu_torch.tools.style_delta pack --base artifacts/canonical/bare_smpl_tpu.pth.tar \\
        --styled lava.pth.tar --out lava_delta.npz [--grid lava_grid.npy] [--platform cpu]
    python -m avatarcraft_tpu_torch.tools.style_delta unpack --base artifacts/canonical/bare_smpl_tpu.pth.tar \\
        --delta artifacts/styled/multi_lava_delta.npz --out lava.pth.tar [--grid_out lava_grid.npy]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from avatarcraft_tpu_torch.utils.checkpoint import (
    field_config_to_dict,
    load_params_with_config,
    save_params_with_config,
    sorted_leaf_paths,
    sorted_leaves,
)
from avatarcraft_tpu_torch.utils.device import tool_device
from avatarcraft_tpu_torch.utils.style_delta import apply_delta

# leaves of at least this many elements are stored by changed last-dim rows;
# smaller ones (MLP weights, the variance) dense in f32
SPARSE_MIN_ELEMS = 1 << 16


def pack(base_path: str, styled_path: str, out_path: str, grid_path: str | None, device="cuda") -> dict:
    """Write the delta of ``styled_path`` against ``base_path`` to
    ``out_path``; returns the JSON line it prints."""
    base, fcfg_b = load_params_with_config(base_path, device)
    styled, fcfg_s = load_params_with_config(styled_path, device)
    if field_config_to_dict(fcfg_b) != field_config_to_dict(fcfg_s):
        raise SystemExit("base and styled FieldConfigs differ; delta needs a shared base")
    paths, paths_s = sorted_leaf_paths(base), sorted_leaf_paths(styled)
    if paths != paths_s:
        raise SystemExit(f"tree mismatch:\n{paths}\n{paths_s}")

    payload: dict = {}
    meta = {"base": os.path.basename(base_path), "tensors": [], "fieldcfg": field_config_to_dict(fcfg_b)}
    total_changed = total_rows = 0
    for i, (b, s) in enumerate(zip(sorted_leaves(base), sorted_leaves(styled))):
        b, s = b.detach().cpu().numpy(), s.detach().cpu().numpy()
        if b.shape != s.shape:
            raise SystemExit(f"leaf {i} ({paths[i]}): shape {b.shape} != {s.shape}")
        d = s.astype(np.float32) - b.astype(np.float32)
        if d.size >= SPARSE_MIN_ELEMS and d.ndim >= 1:
            rows = d.reshape(-1, d.shape[-1])
            idx = np.nonzero(np.any(rows != 0.0, axis=1))[0]
            payload[f"idx:{i}"] = idx.astype(np.int64)
            payload[f"val:{i}"] = rows[idx].astype(np.float16)
            meta["tensors"].append({"leaf": i, "path": paths[i], "mode": "sparse_rows", "shape": list(d.shape),
                                    "rows_changed": int(idx.size), "rows_total": int(rows.shape[0])})
            total_changed += int(idx.size)
            total_rows += int(rows.shape[0])
        else:
            payload[f"dense:{i}"] = d.astype(np.float32)
            meta["tensors"].append({"leaf": i, "path": paths[i], "mode": "dense", "shape": list(d.shape)})
    if grid_path and os.path.exists(grid_path):
        payload["grid"] = np.load(grid_path).astype(np.float16)
        meta["grid"] = True
    payload["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **payload)
    result = {"out": out_path, "bytes": os.path.getsize(out_path), "sparse_rows_changed": total_changed,
              "sparse_rows_total": total_rows}
    print(json.dumps(result))
    return result


def unpack(base_path: str, delta_path: str, out_path: str, grid_out: str | None, device="cuda") -> dict:
    """Write the styled field of ``delta_path`` over ``base_path`` as
    ``out_path`` (.pth.tar with its sidecar) and its grid as ``grid_out``
    where the delta holds one; returns the JSON line it prints."""
    base, _ = load_params_with_config(base_path, device)
    params, fcfg, grid = apply_delta(base, delta_path)
    save_params_with_config(params, out_path, fcfg)
    if grid is not None and grid_out:
        np.save(grid_out, grid)
    with np.load(delta_path) as z:
        n_tensors = len(json.loads(bytes(z["meta_json"]).decode())["tensors"])
    result = {"out": out_path, "tensors": n_tensors, "grid": bool(grid is not None and grid_out)}
    print(json.dumps(result))
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("pack")
    p.add_argument("--base", required=True)
    p.add_argument("--styled", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--grid", default=None, help="styled density grid .npy to embed")
    u = sub.add_parser("unpack")
    u.add_argument("--base", required=True)
    u.add_argument("--delta", required=True)
    u.add_argument("--out", required=True)
    u.add_argument("--grid_out", default=None)
    for s in (p, u):
        s.add_argument("--platform", default="default", choices=["cpu", "default"],
                       help="where the checkpoints are read: default, the CUDA card; cpu, the CPU")
    return ap


def main(argv=None) -> dict:
    """Run the tool; returns the JSON line it prints."""
    opt = build_parser().parse_args(argv)
    device = tool_device(opt.platform)
    if opt.cmd == "pack":
        return pack(opt.base, opt.styled, opt.out, opt.grid, device)
    return unpack(opt.base, opt.delta, opt.out, opt.grid_out, device)


if __name__ == "__main__":
    main()
