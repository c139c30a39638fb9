"""Checkpoints of the PyTorch port against the JAX package, on the CPU:
loading, saving (the port writes, the JAX package reads), sidecars, and the
JAX package's leaf order. Tolerance: none for stored values; both sides
upcast the same stored values to f32 (and round tables to fp16 the same
way), so every such leaf is equal exactly."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from avatarcraft_tpu.models.instant_nsr import FieldConfig as JaxFieldConfig
from avatarcraft_tpu.models.instant_nsr import init_field_params as jax_init_field_params
from avatarcraft_tpu.ops.grid_encoder import PyramidSpec as JaxPyramidSpec
from avatarcraft_tpu.utils import checkpoint as jckpt
from avatarcraft_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "artifacts", "canonical", "bare_smpl_tpu.pth.tar")

needs_artifact = pytest.mark.skipif(not os.path.exists(ARTIFACT), reason="artifact not present")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_same_tree(port, ref, rtol=0.0):
    got, want = dict(_leaves(port)), dict(_leaves(ref))
    assert got.keys() == want.keys()
    for k in want:
        assert isinstance(got[k], torch.Tensor) and got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=0, err_msg=k)


def _same_config(port, ref):
    # same field names and values; nested specs compared field by field
    return dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.fixture(scope="module")
def artifact_pair():
    return ckpt.load_params_with_config(ARTIFACT, device="cpu"), jckpt.load_params_with_config(ARTIFACT)


@needs_artifact
def test_load_artifact_exact(artifact_pair):
    (params, fcfg), (jparams, jfcfg) = artifact_pair
    _assert_same_tree(params, jparams)
    assert _same_config(fcfg, jfcfg)
    # the tables are fp16 in the file and f32 after loading
    state = torch.load(ARTIFACT, map_location="cpu", weights_only=True)
    assert state["pyramid.planes.2"].dtype == torch.float16
    assert params["planes"][2].shape == (3, 2048, 2048, 4)
    assert params["grids"][2].shape == (128, 128, 128, 4)


@needs_artifact
def test_infer_field_config_matches(artifact_pair):
    (params, _), (jparams, _) = artifact_pair
    assert _same_config(ckpt.infer_field_config(params), jckpt.infer_field_config(jparams))


@needs_artifact
def test_artifact_normal_mode():
    assert ckpt.artifact_normal_mode(ARTIFACT) == jckpt.artifact_normal_mode(ARTIFACT) == "fd4"
    assert ckpt.artifact_normal_mode("/nonexistent/dir/x.pth.tar") is None


def test_field_config_from_dict_matches():
    d = jckpt.field_config_to_dict(
        JaxFieldConfig(encoder="tpu_pyramid", pyramid=JaxPyramidSpec(grid_resolutions=(4, 8)), mlp_dtype="bfloat16")
    )
    d = jax.tree_util.tree_map(lambda x: list(x) if isinstance(x, tuple) else x, d)  # as JSON gives it
    assert _same_config(ckpt.field_config_from_dict(d), jckpt.field_config_from_dict(d))


def _small_jax_params():
    fcfg = JaxFieldConfig(
        encoder="tpu_pyramid",
        pyramid=JaxPyramidSpec(grid_resolutions=(4, 8), grid_dim=2, plane_resolutions=(9,), plane_dim=2),
    )
    return jax_init_field_params(jax.random.PRNGKey(0), fcfg), fcfg


def test_params_from_jax_exact():
    jparams, _ = _small_jax_params()
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    _assert_same_tree(ckpt.params_from_jax(tree, device="cpu"), jparams)


def test_state_dict_round_trip_exact(tmp_path):
    """A state dict written by the JAX package loads identically in both,
    fp16 tables and a layer without weight norm included."""
    jparams, jfcfg = _small_jax_params()
    path = str(tmp_path / "small.pth.tar")
    jckpt.save_params_with_config(jparams, path, jfcfg, table_dtype=torch.float16)
    params, fcfg = ckpt.load_params_with_config(path, device="cpu")
    jp, jf = jckpt.load_params_with_config(path)
    _assert_same_tree(params, jp)
    assert _same_config(fcfg, jf)
    os.remove(path + ".fieldcfg.json")  # no sidecar: inferred from shapes
    assert _same_config(ckpt.load_params_with_config(path, device="cpu")[1], jckpt.load_params_with_config(path)[1])

    # a layer stored without weight norm: both sides set v = w and compute
    # g = ||w||_row, an f32 sum whose order may differ: 2 ulps (2**-22)
    state = torch.load(path, map_location="cpu", weights_only=True)
    del state["sdf_net.0.weight_g"]
    state["sdf_net.0.weight"] = state.pop("sdf_net.0.weight_v")
    _assert_same_tree(
        ckpt.params_from_torch_state_dict(state, device="cpu"), jckpt.params_from_torch_state_dict(state),
        rtol=2**-22,
    )


def _small_port_params(seed=0):
    from avatarcraft_tpu_torch.models import instant_nsr as nsr

    fcfg = nsr.FieldConfig(encoder="tpu_pyramid", pyramid=nsr.PyramidSpec(
        grid_resolutions=(4, 8), grid_dim=2, plane_resolutions=(9,), plane_dim=2))
    return nsr.init_field_params(torch.Generator().manual_seed(seed), fcfg), fcfg


@pytest.mark.parametrize("table_dtype", [None, torch.float16])
def test_port_writes_what_jax_reads(tmp_path, table_dtype):
    """The port's save_params_with_config, read by the JAX package's
    load_params_with_config: every leaf equal (f32 MLPs; the tables f32, or
    rounded to fp16 once on writing), the sidecar's FieldConfig equal, and
    the state dict equal to the one the JAX package writes of the same
    tree."""
    params, fcfg = _small_port_params()
    path = str(tmp_path / "port.pth.tar")
    ckpt.save_params_with_config(params, path, fcfg, table_dtype=table_dtype)
    jparams, jfcfg = jckpt.load_params_with_config(path)
    tables = {"grids", "planes"}
    rounded = {
        k: ([t.to(table_dtype).float() for t in v] if k in tables and table_dtype is not None else v)
        for k, v in params.items()
    }
    _assert_same_tree(jax.tree_util.tree_map(lambda x: torch.as_tensor(np.array(x)), jparams), rounded)
    assert jckpt.field_config_to_dict(jfcfg) == ckpt.field_config_to_dict(fcfg)
    state = torch.load(path, map_location="cpu", weights_only=True)
    jstate = jckpt.params_to_torch_state_dict(jax.tree_util.tree_map(lambda t: t.numpy(), params), table_dtype)
    assert state.keys() == jstate.keys()
    for k in jstate:
        assert state[k].dtype == jstate[k].dtype and state[k].shape == jstate[k].shape, k
        assert torch.equal(state[k], jstate[k]), k
    assert state["pyramid.planes.0"].dtype == (table_dtype or torch.float32)
    assert state["sdf_net.0.weight_v"].dtype == torch.float32


def test_sidecar_round_trip(tmp_path):
    """The port's sidecar reads back as the same config in both packages;
    without a config no sidecar is written and the config is inferred."""
    params, fcfg = _small_port_params(1)
    fcfg = dataclasses.replace(fcfg, packed_dtype="float32", mlp_dtype="bfloat16")
    path = str(tmp_path / "with.pth.tar")
    ckpt.save_params_with_config(params, path, fcfg)
    with open(path + ".fieldcfg.json") as fp:
        side = json.load(fp)
    assert side == json.loads(json.dumps(jckpt.field_config_to_dict(jckpt.field_config_from_dict(side))))
    got, got_cfg = ckpt.load_params_with_config(path, device="cpu")
    assert got_cfg == fcfg and _same_config(jckpt.load_params_with_config(path)[1], got_cfg)
    _assert_same_tree(got, params)
    bare = str(tmp_path / "bare.pth.tar")
    ckpt.save_params_with_config(params, bare)
    assert not os.path.exists(bare + ".fieldcfg.json")
    assert ckpt.load_params_with_config(bare, device="cpu")[1] == ckpt.infer_field_config(params)


def test_safe_load_params_refuses_orbax_dir(tmp_path):
    """safe_load_params reads a .pth.tar file and, since the orbax reader
    (utils/orbax.py), no longer refuses an orbax directory: the JAX
    package's checkpoint of the same tree loads as the JAX package's
    safe_load_params returns it (its leaves f32 tensors, exactly), and so
    does load_params_with_config, its config inferred from the shapes."""
    params, _ = _small_port_params()
    path = str(tmp_path / "p.pth.tar")
    ckpt.save_torch_checkpoint(params, path)
    _assert_same_tree(ckpt.safe_load_params(path, device="cpu"), params)
    orbax_dir = str(tmp_path / "orbax")
    jckpt.save_checkpoint(orbax_dir, jax.tree_util.tree_map(lambda t: t.numpy(), params))
    want = jckpt.safe_load_params(orbax_dir)
    _assert_same_tree(ckpt.safe_load_params(orbax_dir, device="cpu"), want)
    loaded, fcfg = ckpt.load_params_with_config(orbax_dir, device="cpu")
    _assert_same_tree(loaded, want)
    assert _same_config(fcfg, jckpt.infer_field_config(want))


def test_sorted_leaves_follow_jax_flatten_order():
    """sorted_leaves lists a tree's leaves in jax.tree_util.tree_flatten's
    order (dict keys sorted, None skipped); replace_sorted_leaves puts new
    leaves back in that order and keeps the tree's own key order."""
    params, _ = _small_port_params()
    tree = {"z": params["variance"], **params, "a": [None, {"y": torch.ones(2), "b": torch.zeros(3)}]}
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), tree))
    got = ckpt.sorted_leaves(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    new = [torch.full_like(t, float(i)) for i, t in enumerate(got)]
    rebuilt = ckpt.replace_sorted_leaves(tree, new)
    assert list(rebuilt) == list(tree) and rebuilt["a"][0] is None
    assert all(torch.equal(a, b) for a, b in zip(ckpt.sorted_leaves(rebuilt), new))
    with pytest.raises(ValueError):
        ckpt.replace_sorted_leaves(tree, new + [torch.zeros(1)])
