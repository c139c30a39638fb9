"""The importance-sampled render of the PyTorch port (fd7 normals,
SDF-guided up-sampling, render_rays) against the JAX package, on the CPU,
at the small field of tests/test_table_mp.py (f32 tables, the JAX side
under ``jax.jit``).

Tolerances:
* fd7 SDF and features: 1e-5 absolute (f32 MLPs whose matmul summation
  order differs between XLA and PyTorch); the fd7 gradient divides tap
  differences by 2 eps = 0.01, so 1e-5 / 0.01;
* up-sampled z values: 5e-5 absolute. The up-sampler's alpha divides by
  prev_cdf + 1e-5, and prev_cdf is near 0 ahead of the surface, so f32
  last-bit differences of the coarse SDF (XLA and PyTorch sum the MLP's
  products in other orders) grow there, and the CDF inversion divides
  them by a bin's CDF step (tests/test_torch_sampling.py);
* render_rays rgb and depth: 1e-5 absolute; weights: 5e-5 absolute, since
  a weight moves with its up-sampled sample (above); gradient_error: 1e-4
  relative.
* the hash grid (render_rays and render_rays_chunked): rgb, depth,
  weight_sum and normal 3e-5 absolute, weights and z values 5e-5. Where
  the pyramid's features equal JAX's bit for bit, the hash grid's differ
  in their last bits (its 8 corner products summed in another order; the
  JAX package's own two layouts differ by 6.6e-6 on a N(0, 1) table,
  tests/test_torch_hash_encoder.py), and the MLP and fd7's 1/(2 eps)
  carry that (measured 1.1e-5 on rgb).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from avatarcraft_tpu.models import instant_nsr as jnsr
from avatarcraft_tpu.ops.hash_encoder import HashGridSpec as JaxHashGridSpec
from avatarcraft_tpu_torch.models import instant_nsr as nsr
from avatarcraft_tpu_torch.utils.checkpoint import params_from_jax
from test_torch_render import SMALL_JAX_FCFG, _small_field

FIELD_ATOL = 1e-5
BOUND = 1.6
HASH_KW = dict(num_levels=4, log2_hashmap_size=8, base_resolution=4, desired_resolution=32)
HASH_JAX_FCFG = jnsr.FieldConfig(encoder="hashgrid", grid=JaxHashGridSpec(**HASH_KW))
HASH_FCFG = nsr.FieldConfig(encoder="hashgrid", grid=nsr.HashGridSpec(**HASH_KW))
HASH_ATOL = 3e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _rays(n, seed=0):
    """Rays from (0.1, -0.2, -2.6) spread around +z, most of them crossing
    the surface of ``_surface_field``."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.25 + np.asarray([0, 0, 1], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(np.asarray([[0.1, -0.2, -2.6]], np.float32), (n, 1))
    return o, d.astype(np.float32)


def test_fd7_sdf_and_gradient_matches_jax(rng):
    jparams, params, fcfg = _small_field()
    x = rng.uniform(-1.6, 1.6, size=(200, 3)).astype(np.float32)
    x[:5] = 1.6  # taps clipped at the bound
    want = jax.jit(lambda xx: jnsr.sdf_and_gradient(jparams, xx, SMALL_JAX_FCFG, BOUND, 0.005))(x)
    got = nsr.field_sdf_grad(params, _t(x), fcfg, BOUND, 0.005, "fd7")
    for g, w, atol in zip(got, want, (FIELD_ATOL, FIELD_ATOL, FIELD_ATOL / 0.01)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)


def _surface_field():
    """tests/test_table_mp.py's field (the JAX init of its FCFG, which is
    SMALL_JAX_FCFG) with its SDF shifted by -1: the init's SDF is positive
    everywhere, the shifted one has a closed surface of radius ~0.9."""
    _, _, fcfg = _small_field()
    jparams = jnsr.init_field_params(jax.random.PRNGKey(0), SMALL_JAX_FCFG)
    jparams["sdf"][-1]["b"] = jparams["sdf"][-1]["b"].at[0].add(-1.0)
    return jparams, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"), fcfg


def _coarse(jparams, fcfg_j, n_rays, num_steps):
    ro, rd = _rays(n_rays)
    near, far = jax.jit(lambda a, b: jnsr.near_far_from_bound(a, b, BOUND))(ro, rd)
    z = jax.jit(lambda a, b: jnsr.stratified_z_vals(a, b, num_steps))(near, far)
    pts = np.clip(ro[:, None] + rd[:, None] * np.asarray(z)[..., None], -BOUND, BOUND)
    sdf = jax.jit(lambda p: jnsr.forward_sdf(jparams, p, fcfg_j, BOUND)[:, 0])(pts.reshape(-1, 3))
    return ro, rd, np.asarray(z), np.asarray(sdf).reshape(n_rays, num_steps)


@pytest.mark.parametrize("inv_s", [64.0, 512.0])
def test_up_sample_matches_jax(inv_s):
    jparams, _, _ = _surface_field()
    ro, rd, z, sdf = _coarse(jparams, SMALL_JAX_FCFG, 48, 16)
    want = jax.jit(lambda *a: jnsr.up_sample(*a, 8, inv_s))(ro, rd, z, sdf)
    got = nsr.up_sample(_t(ro), _t(rd), _t(z), _t(sdf), 8, inv_s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)


@pytest.mark.parametrize("last", [False, True])
def test_cat_z_vals_matches_jax(last):
    jparams, params, fcfg = _surface_field()
    ro, rd, z, sdf = _coarse(jparams, SMALL_JAX_FCFG, 48, 16)
    new_z = np.sort(np.random.default_rng(1).uniform(z.min(), z.max(), size=(48, 8)).astype(np.float32), -1)
    jsdf_fn = lambda p: jnsr.forward_sdf(jparams, p, SMALL_JAX_FCFG, BOUND)  # noqa: E731
    wz, ws = jax.jit(lambda *a: jnsr.cat_z_vals(jsdf_fn, *a, BOUND, last))(ro, rd, z, new_z, sdf)
    sdf_fn = lambda p: nsr.forward_sdf(params, p, fcfg, BOUND)  # noqa: E731
    gz, gs = nsr.cat_z_vals(sdf_fn, _t(ro), _t(rd), _t(z), _t(new_z), _t(sdf), BOUND, last)
    np.testing.assert_array_equal(gz.numpy(), np.asarray(wz))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=FIELD_ATOL, rtol=0)


@pytest.mark.parametrize("upsample_round,normal_mode", [(6, "fd7"), (3, "fd7"), (3, "fd4")])
def test_render_rays_matches_jax(upsample_round, normal_mode):
    jparams, params, fcfg = _surface_field()
    jrcfg = jnsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=upsample_round,
                              perturb=False, normal_mode=normal_mode)
    rcfg = nsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=upsample_round,
                            perturb=False, normal_mode=normal_mode)
    ro, rd = _rays(32)
    want = jax.jit(lambda a, b: jnsr.render_rays(jparams, a, b, jax.random.PRNGKey(7), SMALL_JAX_FCFG, jrcfg, 1.0))(ro, rd)
    got = nsr.render_rays(params, _t(ro), _t(rd), fcfg, rcfg, 1.0)
    for k, atol in (("rgb", 1e-5), ("depth", 1e-5), ("weights", 5e-5), ("z_vals", 5e-5)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0, err_msg=k)
    np.testing.assert_allclose(float(got["gradient_error"]), float(want["gradient_error"]), rtol=1e-4)
    assert float(got["weight_sum"].mean()) > 0.5  # the rays cross the surface


def test_render_rays_perturb_and_unported_options():
    """The jitter draws from the generator, or is injected: the same draw
    gives the same render. (The warp, the near/far override and the
    curvature term, refused here before they were ported, are held against
    JAX in tests/test_torch_parity_render.py.)"""
    _, params, fcfg = _small_field()
    ro, rd = _rays(8)
    rcfg = nsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=3, perturb=True)
    a = nsr.render_rays(params, _t(ro), _t(rd), fcfg, rcfg, generator=torch.Generator().manual_seed(0))
    b = nsr.render_rays(params, _t(ro), _t(rd), fcfg, rcfg, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a["rgb"], b["rgb"]) and torch.isfinite(a["rgb"]).all()
    u = torch.rand((8, 6), generator=torch.Generator().manual_seed(0))
    c = nsr.render_rays(params, _t(ro), _t(rd), fcfg, rcfg, jitter=u)
    assert torch.equal(a["rgb"], c["rgb"]) and torch.equal(a["z_vals"], c["z_vals"])
    flat = nsr.render_rays(params, _t(ro), _t(rd), fcfg, dataclasses.replace(rcfg, perturb=False))
    assert not torch.equal(a["z_vals"], flat["z_vals"])


def hash_field(seed=0):
    """A small hash-grid field with a surface: the JAX init of
    HASH_JAX_FCFG, a N(0, 0.03) table, random first-layer weights over the
    encoding and the SDF shifted by -1."""
    jparams = jnsr.init_field_params(jax.random.PRNGKey(seed), HASH_JAX_FCFG)
    rng = np.random.default_rng(seed)
    jparams["table"] = rng.normal(size=jparams["table"].shape).astype(np.float32) * 0.03
    v = rng.normal(size=jparams["sdf"][0]["v"].shape).astype(np.float32) * 0.3
    jparams["sdf"][0] = {**jparams["sdf"][0], "v": v, "g": np.linalg.norm(v, axis=1)}
    jparams["sdf"][-1]["b"] = np.asarray(jparams["sdf"][-1]["b"]).copy()
    jparams["sdf"][-1]["b"][0] -= 1.0
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, params_from_jax(jparams, device="cpu")


@pytest.mark.parametrize("normal_mode", ["fd7", "fd4"])
def test_render_rays_hashgrid_matches_jax(normal_mode):
    jparams, params = hash_field()
    jrcfg = jnsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=3, perturb=False, normal_mode=normal_mode)
    rcfg = nsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=3, perturb=False, normal_mode=normal_mode)
    ro, rd = _rays(32)
    want = jax.jit(lambda a, b: jnsr.render_rays(jparams, a, b, jax.random.PRNGKey(7), HASH_JAX_FCFG, jrcfg, 1.0))(ro, rd)
    got = nsr.render_rays(params, _t(ro), _t(rd), HASH_FCFG, rcfg, 1.0)
    for k, atol in (("rgb", HASH_ATOL), ("depth", HASH_ATOL), ("weights", 5e-5), ("z_vals", 5e-5)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0, err_msg=k)
    np.testing.assert_allclose(float(got["gradient_error"]), float(want["gradient_error"]), rtol=1e-4)
    assert float(got["weight_sum"].mean()) > 0.2  # a share of the rays cross the surface


@pytest.mark.parametrize("bg", ["scalar", "array"])
def test_render_rays_chunked_matches_jax(bg):
    """20 rays in chunks of 8: the last chunk padded, gradient_error the
    mean over the chunks, padding included, as in the JAX package."""
    jparams, params = hash_field()
    jrcfg = jnsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=3, perturb=False)
    rcfg = nsr.RenderConfig(num_steps=6, upsample_steps=6, upsample_round=3, perturb=False)
    ro, rd = _rays(20)
    bg_np = np.random.default_rng(3).random((20, 3)).astype(np.float32) if bg == "array" else 0.0
    want = jax.jit(lambda a, b: jnsr.render_rays_chunked(
        jparams, a, b, jax.random.PRNGKey(7), HASH_JAX_FCFG, jrcfg, bg_np, chunk=8))(ro, rd)
    got = nsr.render_rays_chunked(params, _t(ro), _t(rd), HASH_FCFG, rcfg, _t(bg_np) if bg == "array" else 0.0, chunk=8)
    for k in ("rgb", "depth", "weight_sum", "normal"):
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=HASH_ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(float(got["gradient_error"]), float(want["gradient_error"]), rtol=1e-4)
