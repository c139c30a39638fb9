"""The field and the fast render of the PyTorch port against the JAX
package, on the CPU (the JAX side under ``jax.jit``, as it runs).

Tolerances:
* field outputs of a small random field, f32 tables: 1e-5 absolute (f32
  MLPs whose matmul summation order differs between XLA and PyTorch);
* rendered colors: 2e-3 absolute, the pin tests/test_styled_warp.py:112
  holds the JAX package's own renders to (fd4 normals difference bf16
  features at eps=0.005, which amplifies last-bit differences);
* sample counts: exact (integer logic, see test_torch_occupancy.py);
* analytic normals (forward-mode through the field, f32 tables): the SDF
  and features FIELD_ATOL, the gradient FIELD_ATOL x max|grad| (the
  tangents run through the same f32 matmuls); an analytic 32x32 frame of
  the committed artifact (bf16 tables): the 2e-3 render pin.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatarcraft_tpu.cameras import pose2rays as jax_pose2rays
from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.ops.grid_encoder import PyramidSpec as JaxPyramidSpec
from avatarcraft_tpu.ops.hash_encoder import HashGridSpec as JaxHashGridSpec
from avatarcraft_tpu.utils.checkpoint import load_params_with_config as jax_load_params_with_config
from avatarcraft_tpu_torch import bench
from avatarcraft_tpu_torch.cameras import pose2rays
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.utils.checkpoint import params_from_jax
from avatarcraft_tpu_torch.workloads.canonical_render import make_fast_frame_renderer

needs_artifact = pytest.mark.skipif(
    not (os.path.exists(bench.ARTIFACT_CKPT) and os.path.exists(bench.ARTIFACT_GRID)),
    reason="artifact not present",
)
RENDER_ATOL = 2e-3
FIELD_ATOL = 1e-5

SMALL_JAX_FCFG = jnsr.FieldConfig(
    encoder="tpu_pyramid",
    pyramid=JaxPyramidSpec(grid_resolutions=(4, 8), grid_dim=2, plane_resolutions=(17,), plane_dim=2),
    packed_dtype="float32",
)


def _small_field(seed=0, table_scale=0.3):
    """JAX-initialised small field with tables large enough to matter."""
    jparams = jnsr.init_field_params(jax.random.PRNGKey(seed), SMALL_JAX_FCFG)
    rng = np.random.default_rng(seed)
    for key in ("grids", "planes"):
        jparams[key] = [
            jnp.asarray(rng.normal(size=t.shape).astype(np.float32) * table_scale) for t in jparams[key]
        ]
    fcfg = nsr.FieldConfig(**{
        **dataclasses.asdict(SMALL_JAX_FCFG),
        "grid": nsr.HashGridSpec(**dataclasses.asdict(SMALL_JAX_FCFG.grid)),
        "pyramid": nsr.PyramidSpec(**dataclasses.asdict(SMALL_JAX_FCFG.pyramid)),
    })
    return jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"), fcfg


def _t(a):
    return torch.from_numpy(np.array(a))


def test_linspace_matches_jnp():
    for m in (2, 7, 128, 192):
        want = np.asarray(jax.jit(lambda: jnp.linspace(0.0, 1.0, m, dtype=jnp.float32))())
        np.testing.assert_array_equal(nsr._linspace01(m, "cpu").numpy(), want)


def test_field_outputs_match(rng):
    jparams, params, fcfg = _small_field()
    x = rng.uniform(-1.6, 1.6, size=(300, 3)).astype(np.float32)
    jfield = jnsr.network_field_fns(jparams, SMALL_JAX_FCFG, 1.6)

    got = nsr.forward_sdf(params, _t(x), fcfg, 1.6)
    want = jax.jit(jfield.sdf)(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FIELD_ATOL, rtol=0)

    sdf, feat, grad = nsr.field_sdf_grad(params, _t(x), fcfg, 1.6, 0.005, "fd4")
    jsdf, jfeat, jgrad = jax.jit(lambda xx: jnsr.field_sdf_grad(jfield, xx, 1.6, 0.005, "fd4"))(jnp.asarray(x))
    np.testing.assert_allclose(sdf.numpy(), np.asarray(jsdf), atol=FIELD_ATOL, rtol=0)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), atol=FIELD_ATOL, rtol=0)
    # the gradient divides tap differences by 4 eps = 0.02
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=FIELD_ATOL / 0.02, rtol=0)

    n = rng.normal(size=(300, 3)).astype(np.float32)
    for mlp_dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(SMALL_JAX_FCFG, mlp_dtype=mlp_dtype)
        pcfg = dataclasses.replace(fcfg, mlp_dtype=mlp_dtype)
        got = nsr.forward_color(params, _t(x), None, _t(n), feat, pcfg)
        want = jax.jit(lambda a, b, c: jnsr.forward_color(jparams, a, None, b, c, jcfg))(
            jnp.asarray(x), jnp.asarray(n), jnp.asarray(feat.numpy())
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FIELD_ATOL, rtol=0)
    np.testing.assert_array_equal(nsr.forward_variance(params).numpy(), np.asarray(jnsr.forward_variance(jparams)))


def test_unported_modes_raise():
    """An unknown encoder and an unknown normal mode raise; the analytic
    normal mode (tests/test_torch_stylize.py holds it against JAX), the
    hash grid and the view-direction SH encoder (use_viewdirs, held
    against JAX in tests/test_torch_legacy.py), ported since, no longer
    raise: the hash grid's tables are the JAX package's cell-packed dense
    levels, bit for bit, and use_viewdirs builds the same tables."""
    _, params, fcfg = _small_field()
    x = torch.zeros(4, 3)
    sdf, feat, grad = nsr.field_sdf_grad(params, x, fcfg, 1.6, 0.005, "analytic")
    assert sdf.shape == (4, 1) and grad.shape == (4, 3) and torch.isfinite(grad).all()
    with pytest.raises(ValueError, match="unknown normal_mode"):
        nsr.field_sdf_grad(params, x, fcfg, 1.6, 0.005, "fd5")
    with_dirs = nsr.materialize_field_tables(params, dataclasses.replace(fcfg, use_viewdirs=True))
    without = nsr.materialize_field_tables(params, fcfg)
    assert sorted(with_dirs) == sorted(without)
    assert all(torch.equal(a, b) for k in without for a, b in zip(with_dirs[k], without[k]))
    with pytest.raises(ValueError, match="unknown encoder"):
        nsr.materialize_field_tables(params, dataclasses.replace(fcfg, encoder="freq"))

    hash_kw = dict(num_levels=3, log2_hashmap_size=10, base_resolution=4, desired_resolution=16)
    jcfg = jnsr.FieldConfig(encoder="hashgrid", grid=JaxHashGridSpec(**hash_kw))
    jparams = jax.tree_util.tree_map(np.asarray, jnsr.init_field_params(jax.random.PRNGKey(0), jcfg))
    want = jnsr.materialize_field_tables(jparams, jcfg)["dense_cells"]
    hcfg = nsr.FieldConfig(encoder="hashgrid", grid=nsr.HashGridSpec(**hash_kw))
    got = nsr.materialize_field_tables(params_from_jax(jparams, device="cpu"), hcfg)["dense_cells"]
    assert sorted(got) == sorted(want) and len(got) >= 2
    for lvl in want:
        np.testing.assert_array_equal(got[lvl].numpy(), np.asarray(want[lvl]))


def _small_scene(rng, n_rays):
    grid = np.where(rng.random((33, 33, 33)) < 0.3, 50.0, 0.5).astype(np.float32)
    o = np.tile(np.asarray([[0.1, -0.2, -2.6]], np.float32), (n_rays, 1))
    d = rng.normal(size=(n_rays, 3)).astype(np.float32) * 0.25 + np.asarray([0, 0, 1], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return grid, o, d


@pytest.mark.parametrize("budget", [0, 150, 100000])
def test_render_rays_fast_small_field(rng, budget):
    """Without a budget, with one that clips (samples dropped in flat
    order) and with one above every count."""
    jparams, params, fcfg = _small_field()
    grid, o, d = _small_scene(rng, 64)
    cfg = nsr.FastRenderConfig(n_probes=48, k_samples=8, sample_budget=budget)
    jcfg = jnsr.FastRenderConfig(n_probes=48, k_samples=8, sample_budget=budget)
    n_selected = int(nsr.count_fast_samples(_t(o), _t(d), cfg, _t(grid)))
    assert (budget == 150) == (0 < budget < n_selected)
    got = nsr.render_rays_fast(params, _t(o), _t(d), fcfg, cfg, _t(grid), 1.0)
    want = jax.jit(lambda p, oo, dd, g: jnsr.render_rays_fast(p, oo, dd, SMALL_JAX_FCFG, jcfg, g, 1.0))(
        jparams, jnp.asarray(o), jnp.asarray(d), jnp.asarray(grid)
    )
    assert got["weights"].shape == (64, 8)
    for k in ("rgb", "depth", "weight_sum", "normal", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=RENDER_ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(float(got["gradient_error"]), float(want["gradient_error"]), rtol=1e-3)


def test_frame_renderer_chunks_and_shards(rng):
    """Padding the last chunk and splitting the table change nothing."""
    _, params, fcfg = _small_field()
    grid, o, d = _small_scene(rng, 100)
    cfg = nsr.FastRenderConfig(n_probes=48, k_samples=8)
    whole = make_fast_frame_renderer(params, fcfg, cfg, _t(grid), chunk=100)(_t(o), _t(d))
    chunked = make_fast_frame_renderer(params, fcfg, cfg, _t(grid), chunk=32, n_shards=4)(_t(o), _t(d))
    assert chunked["rgb"].shape == (100, 3) and chunked["depth"].shape == (100,)
    assert chunked["weight_sum"].shape == (100, 1)
    for k in ("rgb", "depth", "weight_sum"):
        np.testing.assert_allclose(chunked[k].numpy(), whole[k].numpy(), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def artifact():
    params, fcfg, grid, cfg = bench.load_artifact("cpu")
    jparams, jfcfg = jax_load_params_with_config(bench.ARTIFACT_CKPT)
    jgrid = jnp.asarray(np.load(bench.ARTIFACT_GRID))
    return params, fcfg, grid, cfg, jparams, jfcfg, jgrid


def _jax_fast_cfg(cfg):
    return jnsr.FastRenderConfig(**dataclasses.asdict(cfg))


@needs_artifact
def test_count_fast_samples_bench_cameras(artifact):
    params, fcfg, grid, cfg, jparams, jfcfg, jgrid = artifact
    jcount = jax.jit(lambda oo, dd, g: jnsr.count_fast_samples(oo, dd, _jax_fast_cfg(cfg), g))
    counts, jcounts = [], []
    for pose in bench.bench_poses():
        ro, rd = pose2rays(64, 64, pose, device="cpu")
        jro, jrd = jax_pose2rays(64, 64, pose)
        counts.append(int(nsr.count_fast_samples(ro, rd, cfg, grid)))
        jcounts.append(int(jcount(jro, jrd, jgrid)))
    assert counts == jcounts
    assert min(counts) > 0
    worst, budget = bench.derive_budget(
        [pose2rays(64, 64, p, device="cpu") for p in bench.bench_poses()], cfg, grid
    )
    assert worst == max(jcounts) and budget == int(max(jcounts) * 1.02)


@needs_artifact
@pytest.mark.parametrize("n_shards", [1, 8])
def test_artifact_frame_matches_jax(artifact, n_shards):
    """32x32 frame of the committed artifact, fd4, zero-clip budget."""
    params, fcfg, grid, cfg, jparams, jfcfg, jgrid = artifact
    pose = bench.bench_poses()[1]
    ro, rd = pose2rays(32, 32, pose, device="cpu")
    jro, jrd = jax_pose2rays(32, 32, pose)
    worst, budget = bench.derive_budget([(ro, rd)], cfg, grid)
    assert 0 < worst <= budget < 32 * 32 * cfg.k_samples
    cfg = dataclasses.replace(cfg, sample_budget=budget)
    jcfg = _jax_fast_cfg(cfg)
    want = np.asarray(
        jax.jit(lambda p, oo, dd, g: jnsr.render_rays_fast(p, oo, dd, jfcfg, jcfg, g, 1.0)["rgb"])(
            jparams, jro, jrd, jgrid
        )
    )
    got = make_fast_frame_renderer(params, fcfg, cfg, grid, chunk=32 * 32, n_shards=n_shards)(ro, rd)["rgb"]
    assert np.isfinite(got.numpy()).all()
    assert (np.abs(want - 1.0).sum(-1) > 0.1).sum() > 20  # the body is in view
    np.testing.assert_allclose(got.numpy(), want, atol=RENDER_ATOL, rtol=0)


def _field_with_tables(seed=0):
    """_small_field with a random first layer over the encoding, so that
    the SDF and its gradient depend on the tables, and a surface (bias
    -1)."""
    jparams, _, fcfg = _small_field(seed)
    rng = np.random.default_rng(seed + 100)
    v = rng.normal(size=jparams["sdf"][0]["v"].shape).astype(np.float32) * 0.3
    jparams["sdf"][0] = {**jparams["sdf"][0], "v": jnp.asarray(v), "g": jnp.linalg.norm(v, axis=1)}
    jparams["sdf"][-1]["b"] = jparams["sdf"][-1]["b"].at[0].add(-1.0)
    return jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"), fcfg


def test_analytic_normals_match_jax(rng):
    jparams, params, fcfg = _field_with_tables()
    x = rng.uniform(-1.5, 1.5, size=(400, 3)).astype(np.float32)
    jfield = jnsr.network_field_fns(jparams, SMALL_JAX_FCFG, 1.6)
    want = jax.jit(lambda xx: jnsr.field_sdf_grad(jfield, xx, 1.6, 0.005, "analytic"))(jnp.asarray(x))
    got = nsr.field_sdf_grad(params, _t(x), fcfg, 1.6, 0.005, "analytic")
    for g, w, atol in zip(got, want, (FIELD_ATOL, FIELD_ATOL, FIELD_ATOL * float(np.abs(want[2]).max()))):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=atol, rtol=0)
    # the exact gradient of the piecewise-trilinear field, close to fd7's
    fd7 = nsr.field_sdf_grad(params, _t(x), fcfg, 1.6, 1e-3, "fd7")[2]
    assert float((fd7 - got[2]).abs().median()) < 0.05 * float(got[2].abs().median())


@needs_artifact
def test_analytic_artifact_frame_matches_jax(artifact):
    """A 32x32 frame of the committed artifact with analytic normals and
    no budget, through the port's frame renderer and JAX's render."""
    params, fcfg, grid, cfg, jparams, jfcfg, jgrid = artifact
    pose = bench.bench_poses()[1]
    ro, rd = pose2rays(32, 32, pose, device="cpu")
    jro, jrd = jax_pose2rays(32, 32, pose)
    cfg = dataclasses.replace(cfg, normal_mode="analytic", sample_budget=0)
    jcfg = _jax_fast_cfg(cfg)
    want = np.asarray(jax.jit(lambda p, oo, dd, g: jnsr.render_rays_fast(p, oo, dd, jfcfg, jcfg, g, 1.0)["rgb"])(
        jparams, jro, jrd, jgrid))
    got = make_fast_frame_renderer(params, fcfg, cfg, grid, chunk=32 * 32)(ro, rd)["rgb"]
    assert (np.abs(want - 1.0).sum(-1) > 0.1).sum() > 20  # the body is in view
    np.testing.assert_allclose(got.numpy(), want, atol=RENDER_ATOL, rtol=0)
