"""Save and load ``.pth.tar`` checkpoints and their ``.fieldcfg.json``
sidecars, read and write the JAX package's orbax checkpoint directories
(``load_checkpoint``, ``save_checkpoint``, through ``utils/orbax.py``;
port of the JAX package's utils/checkpoint.py), and the trainers' train
state: an orbax directory in the JAX package's layout, or the port's own
``torch.save`` file where the path ends in ``.pt``.

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

import dataclasses
import json
import os

import numpy as np
import torch

from avatarcraft_tpu_torch.models.instant_nsr import FieldConfig, HashGridSpec
from avatarcraft_tpu_torch.ops.grid_encoder import PyramidSpec
from avatarcraft_tpu_torch.utils import orbax


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


def sorted_leaves(tree) -> list:
    """The leaves in the JAX package's flattening order
    (``jax.tree_util.tree_flatten``): dict keys sorted, lists in order,
    None skipped. Leaf indices written by the JAX package (the style
    deltas' ``meta["tensors"][i]["leaf"]``) count in this order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in sorted_leaves(v)]
    return [] if tree is None else [tree]


def sorted_leaf_paths(tree, prefix: str = "") -> list:
    """The path of each leaf of ``sorted_leaves``, written as
    ``jax.tree_util.keystr`` writes it (``"['sdf'][0]['v']"``)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in sorted_leaf_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in sorted_leaf_paths(v, f"{prefix}[{i}]")]
    return [] if tree is None else [prefix]


def replace_sorted_leaves(tree, new_leaves: list):
    """The same tree with its leaves, in ``sorted_leaves`` order, replaced
    by ``new_leaves``."""
    it = iter(new_leaves)

    def rebuild(t):
        if isinstance(t, dict):
            out = {k: rebuild(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # the tree's own key order
        if isinstance(t, (list, tuple)):
            return [rebuild(v) for v in t]
        return None if t is None else next(it)

    out = rebuild(tree)
    if next(it, None) is not None:
        raise ValueError("more new leaves than the tree has")
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


def _f32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a bfloat16 leaf of an orbax checkpoint
        return a.detach().to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def params_from_jax(tree, device="cuda") -> dict:
    """Carry a JAX package parameter tree, with its leaves already converted
    to numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) or as
    ``load_checkpoint`` returns them, across to the port: the same tree with
    float32 tensors on ``device``."""
    return map_leaves(tree, lambda a: _f32(a, device))


def _legacy_from_jax(tree, device, what: str, need: set, allowed: set) -> dict:
    keys = set(tree) if isinstance(tree, dict) else set()
    if not need <= keys <= need | allowed:
        raise ValueError(f"not a {what} parameter tree: keys {sorted(keys)}")
    return params_from_jax(tree, device)


def neus_params_from_jax(tree, device="cuda") -> dict:
    """A JAX package NeuS tree (models/neus.py: "sdf" and "color" layers of
    "w" and "b", "variance"), numpy leaves or ``load_checkpoint``'s, as f32
    tensors on ``device``."""
    return _legacy_from_jax(tree, device, "NeuS", {"sdf", "color", "variance"}, set())


def nerf_params_from_jax(tree, device="cuda") -> dict:
    """A JAX package NeRF tree (models/nerf.py: "trunk", "sigma", "rgb"
    and, with view directions, "feature" and "view"), numpy leaves or
    ``load_checkpoint``'s, as f32 tensors on ``device``."""
    return _legacy_from_jax(tree, device, "NeRF", {"trunk", "sigma", "rgb"}, {"feature", "view"})


def save_checkpoint(path: str, state) -> dict:
    """Save a tree (params / opt_state / step) as the JAX package's
    ``save_checkpoint`` does (``StandardCheckpointer().save(path, state,
    force=True)``), without orbax (``utils/orbax.py::save``): tensors on
    any device, numpy arrays, Python scalars, None and empty containers.
    Returns the bytes of the arrays and of the store written."""
    return orbax.save(os.path.abspath(path), state)


def load_checkpoint(path: str, like=None):
    """The tree of the JAX package's orbax checkpoint directory ``path``,
    as its ``load_checkpoint`` returns it (``StandardCheckpointer.restore``),
    read without orbax (``utils/orbax.py``): without ``like`` the saved tree
    (dicts, lists, None and the empty containers; array leaves as numpy
    arrays, bfloat16 ones as CPU torch tensors; scalars such as a train
    state's ``step`` as Python numbers); with ``like`` its structure, the
    leaves looked up by key path."""
    tree = orbax.restore(os.path.abspath(path))
    return tree if like is None else orbax.restore_like(tree, like)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every param group's learning rate to ``lr``: a tensor learning rate
    (a capturable Adam's on the card) is filled in place, so that what
    holds it (a CUDA graph) reads the new value."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def adam_state_from_optax(optimizer: torch.optim.Optimizer, params, mu, nu, count: int, scheduler=None) -> None:
    """Carry an optax Adam state across into ``optimizer`` (a
    ``torch.optim.Adam`` over the tensors of ``params``): ``mu`` and ``nu``
    are optax's first and second moments as trees of numpy arrays with the
    layout of ``params`` (``jax.tree_util.tree_map(np.asarray, state.mu)``),
    ``count`` its step count (on the parameters' device for a capturable
    Adam, as it keeps it). A ``scheduler`` of the optimizer
    (``reconstruct.CosineSchedule``) is moved to the same step, so the next
    update uses lr(count) as optax's schedule does."""
    tensors, mus, nus = leaves(params), leaves(mu), leaves(nu)
    if not len(tensors) == len(mus) == len(nus):
        raise ValueError(f"trees differ: {len(tensors)} tensors, {len(mus)} mu, {len(nus)} nu leaves")

    def moment(a, p):
        if isinstance(a, torch.Tensor):
            return a.detach().to(device=p.device, dtype=torch.float32).clone().reshape(p.shape)
        return torch.as_tensor(np.array(a, np.float32), device=p.device).reshape(p.shape)

    capturable = optimizer.defaults.get("capturable", False)
    for p, m, v in zip(tensors, mus, nus):
        step = torch.tensor(float(count), dtype=torch.float32, device=p.device if capturable else "cpu")
        optimizer.state[p] = {"step": step, "exp_avg": moment(m, p), "exp_avg_sq": moment(v, p)}
    if scheduler is not None:
        scheduler.last_epoch = count
        set_lr(optimizer, scheduler.lr_at(count))


def save_jax_train_state(path: str, params: dict, mu, nu, count: int, step: int, grid=None) -> dict:
    """A trainer's state as the JAX package's orbax train state
    (workloads/reconstruct.py:445-456, 586-596): {"params", "opt_state",
    "grid", "step"}, the optimizer state as ``make_optimizer(...).init``
    builds it (optax's ScaleByAdamState, then ScaleByScheduleState, each
    ``count`` a 0-d int32: the one count the port keeps, as JAX's trainers
    step both together), the grid left out where it is None (the 64+64
    trainer's). ``load_jax_train_state`` reads it back."""
    count = np.asarray(count, np.int32)
    state = {"params": params, "opt_state": [{"count": count, "mu": mu, "nu": nu}, {"count": count}],
             "step": int(step)}
    if grid is not None:
        state["grid"] = grid
    return save_checkpoint(path, state)


def save_train_state(path: str, params: dict, mu, nu, count: int, step: int, grid=None) -> dict | None:
    """A trainer's resumable state: the parameter tree, Adam's first and
    second moments (``mu``, ``nu``: trees of the parameters' layout) and
    step count, the step, and the density grid of the fast trainer (None
    for the 64+64 one). A ``path`` ending in ``.pt`` is one ``torch.save``
    file of the port's; any other is the JAX package's orbax directory
    (``save_jax_train_state``), which returns its byte counts. The
    reference saves the parameters only (SURVEY.md section 5)."""
    if not path.endswith(".pt"):
        return save_jax_train_state(path, params, mu, nu, count, step, grid)
    cpu = lambda t: t.detach().to("cpu", torch.float32).clone()  # noqa: E731
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({
        "params": map_leaves(params, cpu), "mu": map_leaves(mu, cpu), "nu": map_leaves(nu, cpu),
        "count": int(count), "step": int(step), "grid": None if grid is None else cpu(grid),
    }, path)
    return None


def _optax_adam(opt_state) -> dict:
    """The ScaleByAdamState of an optax state restored without a target (a
    dict with "count", "mu" and "nu", in a list for a chain)."""
    if isinstance(opt_state, dict) and {"mu", "nu", "count"} <= set(opt_state):
        return opt_state
    for part in opt_state if isinstance(opt_state, list) else ():
        if isinstance(part, dict) and {"mu", "nu", "count"} <= set(part):
            return part
    raise ValueError("the optimizer state holds no Adam moments")


def load_jax_train_state(path: str, device="cuda") -> dict:
    """The JAX package's orbax train state directory ``path``
    ({"params", "opt_state", "step"} and, from train_fast, "grid";
    workloads/reconstruct.py:430-456, 583-594) as ``load_train_state``
    returns a port file: the parameters, optax Adam's moments and count,
    the step and the grid, their tensors on ``device``."""
    state = load_checkpoint(path)
    adam = _optax_adam(state["opt_state"])
    to = lambda tree: params_from_jax(tree, device)  # noqa: E731
    return {"params": to(state["params"]), "mu": to(adam["mu"]), "nu": to(adam["nu"]),
            "count": int(adam["count"]), "step": int(state["step"]),
            "grid": None if state.get("grid") is None else _f32(state["grid"], device)}


def load_train_state(path: str, device="cuda") -> dict:
    """What ``save_train_state`` wrote, its tensors on ``device``: a file,
    or a directory, the JAX package's orbax train state
    (``load_jax_train_state``)."""
    if os.path.isdir(path):
        return load_jax_train_state(path, device)
    state = torch.load(path, map_location="cpu", weights_only=True)
    to = lambda t: t.to(device)  # noqa: E731
    return {**state, "params": map_leaves(state["params"], to), "mu": map_leaves(state["mu"], to),
            "nu": map_leaves(state["nu"], to), "grid": None if state["grid"] is None else to(state["grid"])}


def train_state_from_optax(path: str, params, mu, nu, count: int, step: int, grid=None) -> None:
    """Write the JAX package's train state as a port train-state file:
    ``params``, ``mu`` and ``nu`` are its parameter tree and optax Adam
    moments as trees of numpy arrays (``jax.tree_util.tree_map(np.asarray,
    ...)``), ``count`` optax's step count, ``step`` the trainer's step and
    ``grid`` its density grid. The loaded file restores through
    ``adam_state_from_optax``, so both packages can start from one state."""
    as_t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    save_train_state(path, map_leaves(params, as_t), map_leaves(mu, as_t), map_leaves(nu, as_t), count, step,
                     None if grid is None else as_t(grid))


def load_torch_checkpoint(path: str, device="cuda") -> dict:
    """Load a reference ``.pth.tar`` checkpoint into the parameter tree."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return params_from_torch_state_dict(state, device)


def params_to_torch_state_dict(params: dict, table_dtype=None) -> dict:
    """The parameter tree as a reference-compatible state dict of CPU
    tensors (reference: stylize.py:255-260). MLP weights stay f32;
    ``table_dtype`` (e.g. torch.float16) is the storage dtype of the encoder
    tables only (they are read as bf16 packed tables at render time); it
    halves a baked artifact. The pyramid tables have keys of their own
    (``pyramid.grids.{i}``, ``pyramid.planes.{i}``): the reference has no
    such encoder."""

    def t(x):
        return x.detach().to(device="cpu", dtype=torch.float32).clone()

    def tt(x):
        out = t(x)
        return out.to(table_dtype) if table_dtype is not None else out

    state = {}
    if "table" in params:
        state["encoder.embeddings"] = tt(params["table"])
    else:
        for i, g in enumerate(params.get("grids", [])):
            state[f"pyramid.grids.{i}"] = tt(g)
        for i, p in enumerate(params.get("planes", [])):
            state[f"pyramid.planes.{i}"] = tt(p)
    for l, layer in enumerate(params["sdf"]):
        state[f"sdf_net.{l}.weight_v"] = t(layer["v"])
        state[f"sdf_net.{l}.weight_g"] = t(layer["g"]).reshape(-1, 1)
        state[f"sdf_net.{l}.bias"] = t(layer["b"])
    for l, layer in enumerate(params["color"]):
        state[f"color_net.{l}.weight_v"] = t(layer["v"])
        state[f"color_net.{l}.weight_g"] = t(layer["g"]).reshape(-1, 1)
    state["deviation_net.variance"] = t(params["variance"]).reshape(())
    return state


def save_torch_checkpoint(params: dict, path: str, table_dtype=None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(params_to_torch_state_dict(params, table_dtype), path)


def safe_load_params(path: str, device="cuda") -> dict:
    """The parameter tree of a ``.pth.tar`` file or of an orbax checkpoint
    directory of the JAX package, f32 tensors on ``device`` (reference:
    utils/utils.py:284-315 safe_load_weights)."""
    if os.path.isdir(path):
        return params_from_jax(load_checkpoint(path), device)
    return load_torch_checkpoint(path, device)


def field_config_to_dict(fcfg: FieldConfig) -> dict:
    return dataclasses.asdict(fcfg)


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


def _sidecar_path(path: str) -> str:
    return path + ".fieldcfg.json"


def save_params_with_config(params: dict, path: str, fcfg: FieldConfig | None = None, table_dtype=None) -> None:
    """save_torch_checkpoint plus a sidecar JSON with the FieldConfig (the
    state dict itself stays reference-compatible)."""
    save_torch_checkpoint(params, path, table_dtype)
    if fcfg is not None:
        with open(_sidecar_path(path), "w") as fp:
            json.dump(field_config_to_dict(fcfg), fp, indent=1)


def load_params_with_config(path: str, device="cuda"):
    """(params, FieldConfig) of a ``.pth.tar`` or an orbax directory. The
    config comes from the ``<path>.fieldcfg.json`` sidecar when present,
    else from the shapes."""
    params = safe_load_params(path, device)
    sidecar = _sidecar_path(path)
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
