"""Apply a styled field's sparse delta to its base artifact: the unpack side
of the JAX package's tools/style_delta.py (the port's command line, with
``pack``, is ``tools/style_delta.py``).

A delta (``artifacts/styled/*_delta.npz``) stores, per leaf of the base
tree, either a dense f32 difference (``dense:{i}``: MLP tensors, the
variance) or the changed last-dim rows of a large table (``idx:{i}`` row
indices, ``val:{i}`` fp16 row differences), plus ``meta_json`` with the
field's config and, optionally, the styled density grid (``grid``, fp16).
The leaf index ``i`` counts leaves in the JAX package's flattening order
(dict keys sorted), which ``checkpoint.sorted_leaves`` rebuilds.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from avatarcraft_tpu_torch.utils.checkpoint import field_config_from_dict, replace_sorted_leaves, sorted_leaves


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
