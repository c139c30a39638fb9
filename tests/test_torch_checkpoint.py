"""Checkpoint loading of the PyTorch port against the JAX package, on the
CPU. Tolerance: none for stored values; both sides upcast the same stored
values to f32, so every such leaf is equal exactly."""

import dataclasses
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
