"""Load baked ``.pth.tar`` checkpoints and their ``.fieldcfg.json``
sidecars into the port's parameter tree; port of the ``.pth.tar`` side of
the JAX package's utils/checkpoint.py (no orbax).

The parameter tree has the JAX package's layout, with float32 tensors for
leaves:

    {"sdf": [{"v", "g", "b"}, ...], "color": [{"v", "g"}, ...],
     "variance": scalar, "grids": [[R,R,R,C], ...], "planes": [[3,R,R,C], ...]}

Reference state-dict keys (torch.save(net.state_dict()), reference:
stylize.py:255-260): ``sdf_net.{l}.weight_v|weight_g|bias``,
``color_net.{l}.weight_v|weight_g``, ``deviation_net.variance``; the pyramid
encoder adds ``pyramid.grids.{i}`` / ``pyramid.planes.{i}`` (fp16 in the
baked artifact, upcast to f32 here as the JAX package does).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from avatarcraft_tpu_torch.models.instant_nsr import FieldConfig, HashGridSpec
from avatarcraft_tpu_torch.ops.grid_encoder import PyramidSpec


def map_leaves(tree, fn):
    """The same tree with ``fn`` applied to every leaf (None stays None)."""
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(v, fn) for v in tree]
    return None if tree is None else fn(tree)


def leaves(tree) -> list:
    """The leaves of a tree in its order (dict keys as written), None
    skipped."""
    out = []
    map_leaves(tree, out.append)
    return out


def params_from_torch_state_dict(state: dict, device="cuda") -> dict:
    """Convert a reference NeRFNetwork state_dict to the parameter tree."""

    def arr(key):
        return state[key].detach().to(device=device, dtype=torch.float32)

    sdf_layers = []
    l = 0
    while f"sdf_net.{l}.weight_v" in state or f"sdf_net.{l}.weight" in state:
        if f"sdf_net.{l}.weight_v" in state:
            layer = {
                "v": arr(f"sdf_net.{l}.weight_v"),
                "g": arr(f"sdf_net.{l}.weight_g").reshape(-1),
                "b": arr(f"sdf_net.{l}.bias"),
            }
        else:  # no weight norm: v = w with g = ||w||_row
            w = arr(f"sdf_net.{l}.weight")
            layer = {"v": w, "g": torch.linalg.norm(w, dim=1), "b": arr(f"sdf_net.{l}.bias")}
        sdf_layers.append(layer)
        l += 1

    color_layers = []
    l = 0
    while f"color_net.{l}.weight_v" in state or f"color_net.{l}.weight" in state:
        if f"color_net.{l}.weight_v" in state:
            layer = {
                "v": arr(f"color_net.{l}.weight_v"),
                "g": arr(f"color_net.{l}.weight_g").reshape(-1),
            }
        else:
            w = arr(f"color_net.{l}.weight")
            layer = {"v": w, "g": torch.linalg.norm(w, dim=1)}
        color_layers.append(layer)
        l += 1

    out = {
        "sdf": sdf_layers,
        "color": color_layers,
        "variance": arr("deviation_net.variance").reshape(()),
    }
    if "encoder.embeddings" in state:
        out["table"] = arr("encoder.embeddings")
    else:
        grids, planes = [], []
        i = 0
        while f"pyramid.grids.{i}" in state:
            grids.append(arr(f"pyramid.grids.{i}"))
            i += 1
        i = 0
        while f"pyramid.planes.{i}" in state:
            planes.append(arr(f"pyramid.planes.{i}"))
            i += 1
        out["grids"], out["planes"] = grids, planes
    return out


def params_from_jax(tree, device="cuda") -> dict:
    """Carry a JAX package parameter tree, with its leaves already converted
    to numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``), across
    to the port: the same tree with float32 tensors on ``device``."""
    return map_leaves(
        tree, lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    )


def adam_state_from_optax(optimizer: torch.optim.Optimizer, params, mu, nu, count: int, scheduler=None) -> None:
    """Carry an optax Adam state across into ``optimizer`` (a
    ``torch.optim.Adam`` over the tensors of ``params``): ``mu`` and ``nu``
    are optax's first and second moments as trees of numpy arrays with the
    layout of ``params`` (``jax.tree_util.tree_map(np.asarray, state.mu)``),
    ``count`` its step count. A ``LambdaLR`` ``scheduler`` of the optimizer
    is moved to the same step, so the next update uses lr(count) as optax's
    schedule does."""
    tensors, mus, nus = leaves(params), leaves(mu), leaves(nu)
    if not len(tensors) == len(mus) == len(nus):
        raise ValueError(f"trees differ: {len(tensors)} tensors, {len(mus)} mu, {len(nus)} nu leaves")
    for p, m, v in zip(tensors, mus, nus):
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.as_tensor(np.array(m, np.float32), device=p.device).reshape(p.shape),
            "exp_avg_sq": torch.as_tensor(np.array(v, np.float32), device=p.device).reshape(p.shape),
        }
    if scheduler is not None:
        scheduler.last_epoch = count
        for group, base, fn in zip(optimizer.param_groups, scheduler.base_lrs, scheduler.lr_lambdas):
            group["lr"] = base * fn(count)


def load_torch_checkpoint(path: str, device="cuda") -> dict:
    """Load a reference ``.pth.tar`` checkpoint into the parameter tree."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return params_from_torch_state_dict(state, device)


def field_config_from_dict(d: dict) -> FieldConfig:
    d = dict(d)
    if "grid" in d:
        d["grid"] = HashGridSpec(**{
            k: tuple(v) if isinstance(v, list) else v for k, v in d["grid"].items()
        })
    if "pyramid" in d:
        d["pyramid"] = PyramidSpec(**{
            k: tuple(v) if isinstance(v, list) else v for k, v in d["pyramid"].items()
        })
    return FieldConfig(**d)


def infer_field_config(params: dict) -> FieldConfig:
    """Recover a FieldConfig from the parameter shapes alone (checkpoints
    without a sidecar): encoder type and pyramid geometry from the tables,
    MLP widths and depths from the layers, ``include_input`` /
    ``use_viewdirs`` from the input widths."""
    kw = {}
    if "table" in params:
        kw["encoder"] = "hashgrid"
        enc_dim = FieldConfig().grid.output_dim
    else:
        grids = params.get("grids", [])
        planes = params.get("planes", [])
        spec = PyramidSpec(
            grid_resolutions=tuple(int(g.shape[0]) for g in grids),
            grid_dim=int(grids[0].shape[-1]) if grids else 0,
            plane_resolutions=tuple(int(p.shape[1]) for p in planes),
            plane_dim=int(planes[0].shape[-1]) if planes else 0,
        )
        kw["encoder"] = "tpu_pyramid"
        kw["pyramid"] = spec
        enc_dim = spec.output_dim

    sdf = params["sdf"]
    kw["num_layers"] = len(sdf)
    kw["hidden_dim"] = int(sdf[0]["v"].shape[0]) if len(sdf) > 1 else 64
    kw["geo_feat_dim"] = int(sdf[-1]["v"].shape[0]) - 1
    kw["include_input"] = int(sdf[0]["v"].shape[1]) == enc_dim + 3

    color = params["color"]
    kw["num_layers_color"] = len(color)
    kw["hidden_dim_color"] = int(color[0]["v"].shape[0]) if len(color) > 1 else 64
    extra = int(color[0]["v"].shape[1]) - (6 + kw["geo_feat_dim"])  # [x, n, feat]
    if extra > 0:
        kw["use_viewdirs"] = True
        kw["sh_degree"] = int(round(np.sqrt(extra)))
    else:
        kw["use_viewdirs"] = False
    return FieldConfig(**kw)


def load_params_with_config(path: str, device="cuda"):
    """(params, FieldConfig) of a ``.pth.tar``. The config comes from the
    ``<path>.fieldcfg.json`` sidecar when present, else from the shapes."""
    params = load_torch_checkpoint(path, device)
    sidecar = path + ".fieldcfg.json"
    if os.path.isfile(sidecar):
        with open(sidecar) as fp:
            return params, field_config_from_dict(json.load(fp))
    return params, infer_field_config(params)


def artifact_normal_mode(ckpt_path: str) -> str | None:
    """The normal estimator recorded in the PROVENANCE.json beside a baked
    artifact: its color net was trained against that estimator, so
    renderers default to it."""
    prov = os.path.join(os.path.dirname(os.path.abspath(ckpt_path)), "PROVENANCE.json")
    if os.path.isfile(prov):
        try:
            with open(prov) as fp:
                return json.load(fp).get("normal_mode")
        except (OSError, ValueError):
            return None
    return None
